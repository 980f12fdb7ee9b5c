"""Training CLI (port of tools/train.py).

The reference released no trainer; this drives the reconstructed training
stack: config -> SceneGraspDataset -> FileBackedSceneLoader -> Trainer.fit
with checkpoint / resume, on one device, or data-parallel over the ranks
of a launched world (one process per GPU; every rank loads the global
batch and trains on its rows; rank 0 alone writes checkpoints and logs).

Usage:
    python -m s4g_tpu_torch.tools.train --data-dir data/merged_data \
        --output output/curvature [--cfg PATH] [--device cpu]
    torchrun --nproc_per_node=N -m s4g_tpu_torch.tools.train \
        --data-dir data/merged_data --output output/curvature
"""

from __future__ import annotations

import argparse
import os

from .common import DEFAULT_CFG, add_device_arg


def main(argv=None):
    """Returns the final TrainState."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg", default=DEFAULT_CFG)
    parser.add_argument("--data-dir", default=None,
                        help="overrides DATA.TRAIN.ROOT_DIR")
    parser.add_argument("--val-dir", default=None)
    parser.add_argument("--output", default="output")
    parser.add_argument("--max-epochs", type=int, default=None)
    parser.add_argument("--num-frame-points", type=int, default=512)
    parser.add_argument("--async-workers", type=int, default=None,
                        help="defaults to DATA.NUM_WORKERS")
    add_device_arg(parser)
    args = parser.parse_args(argv)

    from ..configs.config import load_cfg_from_file
    from ..parallel.mesh import launched_mesh
    from ..runtime.device import resolve_device
    from ..runtime.loader import FileBackedSceneLoader
    from ..train.dataset import SceneGraspDataset
    from ..train.trainer import Trainer

    dev = resolve_device(args.device, "train")
    mesh = launched_mesh(dev)
    cfg = load_cfg_from_file(args.cfg)
    train_dir = args.data_dir or cfg.DATA.TRAIN.ROOT_DIR
    t_classification = cfg.MODEL.TYPE == "PN2_CLS"

    ds = SceneGraspDataset(
        train_dir,
        num_points=cfg.MODEL.PN2.NUM_INPUT,
        score_classes=cfg.DATA.SCORE_CLASSES,
        batch_size=cfg.TRAIN.BATCH_SIZE,
        num_frame_points=args.num_frame_points,
        t_classification=t_classification,
        seed=cfg.RNG_SEED,
        num_removal_directions=cfg.DATA.NUM_REMOVAL_DIRECTIONS)
    workers = args.async_workers or cfg.DATA.NUM_WORKERS
    loader = FileBackedSceneLoader(ds, num_workers=workers)

    val_loader = None
    val_dir = args.val_dir or cfg.DATA.VAL.ROOT_DIR
    if val_dir and os.path.isdir(val_dir) and val_dir != train_dir:
        val_ds = SceneGraspDataset(
            val_dir, num_points=cfg.MODEL.PN2.NUM_INPUT,
            score_classes=cfg.DATA.SCORE_CLASSES,
            batch_size=cfg.TRAIN.BATCH_SIZE,
            num_frame_points=args.num_frame_points,
            t_classification=t_classification, seed=0)
        val_loader = FileBackedSceneLoader(val_ds, num_workers=workers)

    trainer = Trainer(cfg, output_dir=args.output, steps_per_epoch=len(ds),
                      device=dev, mesh=mesh)
    return trainer.fit(loader, val_data=val_loader,
                       max_epochs=args.max_epochs)


if __name__ == "__main__":
    main()
