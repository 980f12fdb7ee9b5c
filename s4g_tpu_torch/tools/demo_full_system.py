"""Full-system demo: synthetic data factory -> training -> detection (port
of tools/demo_full_system.py).

1. generate scenes with the MuJoCo sim + renderer + label factory (320 x
   240 views, label capacity 8,192);
2. train PN2_CLS on the merged pickles (10,240 points, centroids
   2048/512/128, b = 2);
3. detect on a held-out scene with the trained weights (the at-scale QA's
   `qa_scene` and `detect_view`, at 320 x 240, capacity 32,768 and 256
   candidates) and report how many valid grasps survive post-processing +
   collision checks.

Usage: python -m s4g_tpu_torch.tools.demo_full_system --out OUT --scenes 6
           [--epochs 12] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

from .common import add_device_arg
from .train_at_scale import box_mesh, detect_view, qa_scene


def main(argv=None) -> dict:
    """Returns {"views", "steps", "num_valid", "top_score",
    "frac_in_table_band"}."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                      "s4g_demo"))
    parser.add_argument("--scenes", type=int, default=6)
    parser.add_argument("--epochs", type=int, default=12)
    parser.add_argument("--num-points", type=int, default=10240)
    add_device_arg(parser)
    args = parser.parse_args(argv)

    from ..configs.config import load_cfg_from_dict
    from ..datagen.generate import generate_end_to_end
    from ..datagen.scene_sim import ObjectSpec
    from ..models import build_model
    from ..runtime.device import resolve_device
    from ..train.dataset import SceneGraspDataset
    from ..train.trainer import Trainer

    dev = resolve_device(args.device, "demo_full_system")
    device = str(dev)
    os.makedirs(args.out, exist_ok=True)
    sizes = [(0.030, 0.030, 0.030), (0.025, 0.025, 0.045),
             (0.020, 0.035, 0.028)]
    meshes = {f"obj{i}": box_mesh(*s) for i, s in enumerate(sizes)}
    specs = [ObjectSpec(name=f"obj{i}", geom_type="box",
                        size=f"{s[0]} {s[1]} {s[2]}")
             for i, s in enumerate(sizes)]

    # ---- 1. data factory -----------------------------------------------
    tic = time.time()
    all_merged = []
    for scene_id in range(args.scenes):
        merged = generate_end_to_end(
            meshes, specs, args.out, scene_id=scene_id, num_views=2,
            percentage=1.1, seed=scene_id, label_capacity=8192,
            render_wh=(320, 240), device=device)
        all_merged.extend(merged)
        print(f"[datagen] scene {scene_id}: {len(merged)} views "
              f"({time.time() - tic:.0f}s elapsed)", flush=True)
    print(f"[datagen] total {len(all_merged)} training views", flush=True)

    # ---- 2. training ----------------------------------------------------
    cfg = load_cfg_from_dict({
        "MODEL": {"TYPE": "PN2_CLS", "PN2": {
            "NUM_INPUT": args.num_points,
            "NUM_CENTROIDS": (2048, 512, 128),
            "RADIUS": (0.02, 0.08, 0.32),
            "NUM_NEIGHBOURS": (64, 64, 64),
            "SA_CHANNELS": ((128, 128, 256), (256, 256, 512),
                            (512, 512, 1024)),
            "FP_CHANNELS": ((1024, 1024), (512, 512), (256, 256, 256)),
            "NUM_FP_NEIGHBOURS": (3, 3, 3),
            "SEG_CHANNELS": (512, 256, 256, 128),
            "NEG_WEIGHT": 0.5,
        }},
        "DATA": {"SCORE_CLASSES": 3},
        "SOLVER": {"BASE_LR": 0.001},
        "SCHEDULER": {"MAX_EPOCH": args.epochs, "TYPE": "StepLR",
                      "StepLR": {"step_size": 8, "gamma": 0.5}},
        "TRAIN": {"BATCH_SIZE": 2, "LOG_PERIOD": 2, "CHECKPOINT_PERIOD": 4,
                  "AUGMENTATION": ("PointCloudRotate",)},
    })
    data_dir = os.path.join(args.out, "merged_data")
    ds = SceneGraspDataset(data_dir, num_points=args.num_points,
                           score_classes=3, batch_size=2,
                           num_frame_points=256, seed=0)
    trainer = Trainer(cfg, output_dir=os.path.join(args.out, "train_out"),
                      steps_per_epoch=len(ds), device=device)
    state = trainer.fit(ds)
    print("[train] finished", flush=True)

    # ---- 3. detection with the trained weights --------------------------
    _, (_, noisy, cam) = qa_scene(meshes, specs, wh=(320, 240))
    net = build_model(cfg)
    net.load_state_dict(state.model)
    net = net.to(dev).eval()
    post, valid, poses = detect_view(net, noisy, cam, args.num_points,
                                     32768, 256, dev)
    top = float(post.scores[0])
    print(f"[detect] {valid.sum()} valid grasps (top score {top:.3f})",
          flush=True)
    band = None
    if valid.sum():
        heights = poses[:, 2, 3]
        band = float(((heights > 0.74) & (heights < 0.92)).mean())
        print(f"[detect] grasp heights sane: {band:.0%} in table band",
              flush=True)
    print("DEMO COMPLETE", flush=True)
    return {"views": len(all_merged), "steps": state.step,
            "num_valid": int(valid.sum()), "top_score": top,
            "frac_in_table_band": band}


if __name__ == "__main__":
    main()
