"""The comparison that decides `correct` for the training cells.

Set-up drove the program's trainer through its first steps with the
window's own call and feed; the reference (`reference/train.py`) follows
those steps from the same weights, on the same batches, with the dropout
draws replayed from the seed the benchmark gave the trainer's generator:

- `loader_mismatch`: batches the program trained on that are not, exactly,
  one of the first epoch's batches as the reference collates the same
  pickles with the same seed (`reference/dataset.py`; the loader's workers
  may hand over neighbouring batches out of order);
- `loss_gap`: each step's total loss against the reference's, |gap| over
  the reference's, the worst step;
- `grad_gap`: the norm of each parameter's first gradient, as the
  optimizer holds it after the first step (Adam's first moment over
  1 - beta1), against the reference's: |gap of the norms| over the
  reference's norm of that leaf or of the median leaf, whichever is
  larger, the worst leaf;
- `grad_gap_median`: the same, the median leaf (steady from seed to seed:
  a bf16 product rounded one ulp apart breaks a tie of the max over a
  ball's neighbours the other way and sends that gradient to another
  point, so single SA leaves swing; the median is what half a batch left
  out moves);
- `change_gap`: the same measure of each parameter's change over the
  steps, the worst leaf, leaving out leaves whose reference gradient is
  under a thousandth of the median leaf's (they move by round-off alone).

With `detail` the first step's loss gap, the median leaf's change gap and
the number of leaves left out come beside them.
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

from .reference import dataset, train
from .reference.precision import control, stated

LOOKAHEAD = 4   # reference batches past the checked steps a batch may be
NUMBERS = ("loader_mismatch", "loss_gap", "grad_gap", "grad_gap_median",
           "change_gap")


def _same(batch: dict, ref: dict) -> bool:
    return all(np.array_equal(np.asarray(batch[k]), ref[k]) for k in ref)


def leaf_gaps(prog: dict, ref: dict, keys) -> list:
    """Per leaf |norm(prog) - norm(ref)| / max(norm(ref), median leaf's)."""
    ref_n = {k: float(ref[k].double().norm()) for k in keys}
    med = statistics.median(ref_n.values())
    return [abs(float(prog[k].double().norm()) - ref_n[k])
            / max(ref_n[k], med, 1e-30) for k in keys]


def reference_batches(root: str, data_seed: int, cfg: dict, traffic: dict,
                      batch: int, count: int) -> list:
    return dataset.batches(
        root, data_seed, batch, count, num_points=cfg["NUM_INPUT"],
        classes=cfg["SCORE_CLASSES"],
        directions=cfg["NUM_REMOVAL_DIRECTIONS"],
        frame_points=traffic["num_frame_points"])


def compare(kept: dict, sd: dict, cfg: dict, tc: dict, gen_seed: int,
            ref_batches: list, device, detail: bool = False) -> dict:
    """The numbers for what a trainer gave (`kept`: its "batches", each
    step's total "losses", the first "moment" and the "params" after)."""
    mismatch = sum(not any(_same(b, r) for r in ref_batches)
                   for b in kept["batches"])
    batches = [{k: torch.as_tensor(np.asarray(v)) for k, v in b.items()}
               for b in kept["batches"]]
    ref = train.run_steps(sd, cfg, tc, batches, gen_seed, device)
    losses = [abs(p - r) / abs(r)
              for p, r in zip(kept["losses"], ref["losses"])]
    beta1 = tc["BETAS"][0]
    grad = {k: v / (1.0 - beta1) for k, v in kept["moment"].items()}
    keys = list(ref["grad"])
    grads = leaf_gaps(grad, ref["grad"], keys)
    gnorm = {k: float(ref["grad"][k].norm()) for k in keys}
    floor = 1e-3 * statistics.median(gnorm.values())
    moved = [k for k in keys if gnorm[k] >= floor]
    changes = leaf_gaps({k: kept["params"][k] - sd[k] for k in moved},
                        {k: ref["params"][k] - sd[k] for k in moved}, moved)
    out = {"loader_mismatch": float(mismatch), "loss_gap": max(losses),
           "grad_gap": max(grads), "grad_gap_median": statistics.median(grads),
           "change_gap": max(changes)}
    if detail:
        out.update(loss_gap_first=losses[0],
                   change_gap_median=statistics.median(changes),
                   leaves_left_out=len(keys) - len(moved))
    return out


def judge(drv, kept: dict, detail: bool = False) -> dict:
    ref_batches = reference_batches(
        drv.root, drv.data_seed, drv.model_cfg, drv.traffic, drv.batch,
        len(kept["batches"]) + LOOKAHEAD)
    return compare(kept, drv.sd, drv.model_cfg, drv.config["train"],
                   drv.gen_seed, ref_batches, drv.device, detail)


def stand_in(drv, kind: str) -> dict:
    """What the reference gives in the program's place: "control" one
    precision step below the configuration's (scene points rounded to
    bf16, fp8 matmul operands, bf16 values), "half_batch" the stated
    precision on the first half of every batch's rows (the mean over
    them).  `drv` has written its pickles and holds `sd`."""
    tr, cfg, tc = drv.traffic, drv.model_cfg, drv.config["train"]
    batches = reference_batches(drv.root, drv.data_seed, cfg, tr, drv.batch,
                                tr["checked_steps"])
    if kind == "control":
        for b in batches:
            b["scene_points"] = torch.as_tensor(b["scene_points"]).to(
                torch.bfloat16).float().numpy()
        prec, rows = control(cfg), None
    else:
        prec, rows = stated(cfg), slice(0, drv.batch // 2)
    tensors = [{k: torch.as_tensor(v) for k, v in b.items()}
               for b in batches]
    out = train.run_steps(drv.sd, cfg, tc, tensors, drv.gen_seed,
                          drv.device, prec, rows)
    beta1 = tc["BETAS"][0]
    return {"batches": batches, "losses": out["losses"],
            "moment": {k: (1.0 - beta1) * g for k, g in out["grad"].items()},
            "params": out["params"]}
