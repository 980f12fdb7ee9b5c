"""Whether a train step repeats, and what it takes.

Usage: python -m s4g_tpu_torch.tools.train_repeat --data-dir D
           [--cfg PATH] [--batch 2 4] [--steps 5] [--num-frame-points 512]
           [--device cpu]

For each batch size, a Trainer of the config (the port's
curvature_model.yaml by default: PN2_CLS at full width, bf16, dropout 0.5,
seeded weights) takes one batch of D's scene pickles (`SceneGraspDataset`)
and runs its train step twice from one state: the model, the optimizer's
moments and the generator restored in between.  It
reports whether the two runs' scalars, gradients and state after the
update (parameters after Adam, BatchNorm running statistics) are equal bit
for bit, and how far apart they are: the largest |a - b| of a tensor over
its largest, and the least cosine of the gradients.  Then `--steps` more
steps on that batch, each timed with the host clock between
synchronizations: the median after the first.

Prints one JSON line (the card's name and power limit under "device") and
returns the dict.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import statistics
import time

import torch

from .common import DEFAULT_CFG, add_device_arg, device_label


def _spread(a: dict, b: dict) -> dict:
    """Bit-equal or not, the largest |a - b| of a tensor over its largest,
    where, and (float tensors) the least cosine."""
    worst, where, cos_min, equal = 0.0, None, 1.0, True
    for name, x in a.items():
        y = b[name]
        if torch.equal(x, y):
            continue
        equal = False
        x, y = x.double(), y.double()
        err = float((x - y).abs().max()) / max(float(y.abs().max()), 1e-300)
        if err > worst:
            worst, where = err, name
        denom = float(x.norm() * y.norm())
        if denom > 0:
            cos_min = min(cos_min, float((x * y).sum()) / denom)
    return {"bit_equal": equal, "max_err": worst, "at": where,
            "min_cos": cos_min}


def _snapshot(tr, scalars) -> dict:
    return {"scalars": {k: v.detach().clone() for k, v in scalars.items()},
            "grads": {n: p.grad.detach().clone()
                      for n, p in tr.net.named_parameters()
                      if p.grad is not None},
            "state": {k: v.detach().clone()
                      for k, v in tr.net.state_dict().items()}}


def rerun(tr, batch) -> dict:
    """`tr`'s train step on `batch` twice from one state: the spread of the
    scalars, gradients and state after the update between the runs."""
    start = copy.deepcopy(tr.state())
    runs = []
    for _ in range(2):
        tr.load_state(copy.deepcopy(start))
        runs.append(_snapshot(tr, tr.train_step(batch)))
    return {key: _spread(runs[0][key], runs[1][key])
            for key in ("scalars", "grads", "state")}


def _synchronize(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_batch(cfg, root: str, b: int, steps: int, dev, out_dir: str,
              frame_points: int = 512) -> dict:
    """The rerun spread and the step times of `cfg` at batch `b`."""
    import dataclasses
    import logging
    from .. import _build
    from ..train.dataset import SceneGraspDataset
    from ..train.trainer import Trainer

    cfg = dataclasses.replace(cfg, TRAIN=dataclasses.replace(
        cfg.TRAIN, BATCH_SIZE=b))
    ds = SceneGraspDataset(
        root, num_points=cfg.MODEL.PN2.NUM_INPUT,
        score_classes=cfg.DATA.SCORE_CLASSES, batch_size=b,
        num_frame_points=frame_points, t_classification=True,
        seed=cfg.RNG_SEED,
        num_removal_directions=cfg.DATA.NUM_REMOVAL_DIRECTIONS)
    batch = next(iter(ds))
    tr = Trainer(cfg, output_dir=out_dir, device=str(dev),
                 logger=logging.getLogger("train_repeat"))
    tr.init_state()
    tr.train_step(batch)                       # warm-up: build, caches
    _synchronize(dev)
    spread = rerun(tr, batch)
    times, launches = [], []
    for _ in range(steps):
        before = dict(_build.LAUNCHES)
        _synchronize(dev)
        t0 = time.perf_counter()
        tr.train_step(batch)
        _synchronize(dev)
        times.append(1e3 * (time.perf_counter() - t0))
        launches.append({k: _build.LAUNCHES[k] - before[k] for k in before
                         if _build.LAUNCHES[k] > before[k]})
    return {"batch": b, "spread": spread,
            "step_ms": statistics.median(times[1:]) if steps > 1 else None,
            "steps_ms": times, "launches_per_step": launches[-1]
            if launches else {}}


def main(argv=None) -> dict:
    from ..configs.config import load_cfg_from_file

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--data-dir", required=True,
                        help="a directory of scene pickles (*_view_*.p)")
    parser.add_argument("--cfg", default=DEFAULT_CFG)
    parser.add_argument("--batch", type=int, nargs="+", default=[2, 4])
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--num-frame-points", type=int, default=512)
    parser.add_argument("--output", default=os.path.join(
        "output", "train_repeat"))
    add_device_arg(parser)
    args = parser.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train_repeat: no CUDA device (use --device cpu)")
    cfg = load_cfg_from_file(args.cfg)
    runs = [run_batch(cfg, args.data_dir, b, args.steps, dev, args.output,
                      args.num_frame_points) for b in args.batch]
    out = {"device": device_label(dev), "torch": torch.__version__,
           "cfg": os.path.basename(args.cfg), "runs": runs}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
