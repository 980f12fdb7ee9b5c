"""The comparison that decides `correct` for the detect cells.

Each sampled scene of the window is judged stage by stage against the
plain reference (`reference/`), which is given what the benchmark made
(the camera cloud, the weights, the replayed draws) and, where a stage
follows another, the program's output of the stage before it (with random
weights the scores of many points lie within rounding of each other, so
the top candidates of two computations of one scene are not the same set):

- `prep_mismatch`: the model input the program drew against the
  reference's preprocessing of the same cloud with the same draws: the
  share of points of either that the other lacks (no point within 1e-5 m);
- `model_error`: the program's predictions against the reference model on
  the program's model input: per head (score, rotation, translation,
  movability; PN2's translation less the points) the RMS of the gap over
  the RMS of the reference, the worst head;
- `valid_gap`: the program's count of valid candidates (above the
  thresholds and clear of collision) against the reference's among the
  same top K, as a share of K;
- `count_gap`: the number of grasps the program returned against the
  number due, min(num_selected, the reference's valid count);
- `grasp_gap`: each grasp the program returned against the nearest
  valid candidate of the reference's post-processing and collision check
  of the program's predictions (the largest gap of a pose entry or of the
  score), the worst grasp.

A scene whose answer never came counts in `missing`.  A number is
compared with the cell's limit; every number of every scene is held to
it (the worst scene).
"""

from __future__ import annotations

import torch

from .reference import model, post, preprocess
from .reference.precision import Precision, stated

MATCH_TOL = 1e-5        # m: a point matches one of the other set within this
EXTRA_CANDIDATES = 32   # reference candidates past K a returned grasp may hit
NUMBERS = ("prep_mismatch", "model_error", "valid_gap", "count_gap",
           "grasp_gap", "missing")


def _unmatched(a: torch.Tensor, b: torch.Tensor, chunk: int = 512) -> int:
    """Rows of a (N, 3) with no row of b within MATCH_TOL."""
    a, b = a.double(), b.double()
    bb = (b * b).sum(1)
    far = 0
    for q0 in range(0, len(a), chunk):
        q = a[q0:q0 + chunk]
        d = (q * q).sum(1)[:, None] + bb[None, :] - 2.0 * q @ b.t()
        far += int((d.amin(dim=1) > MATCH_TOL ** 2).sum())
    return far


def prep_mismatch(points: torch.Tensor, ref: torch.Tensor) -> float:
    return (_unmatched(points, ref) + _unmatched(ref, points)) \
        / (len(points) + len(ref))


def head_errors(preds: dict, ref: dict, points: torch.Tensor) -> dict:
    """Per head, the RMS of the gap over the RMS of the reference."""
    out = {}
    for key, want in ref.items():
        got = preds[key].float()
        if key == "frame_t" and got.shape[0] == 3:   # PN2: the residual
            got, want = got - points.t(), want - points.t()
        gap = torch.sqrt(torch.mean((got - want) ** 2))
        scale = torch.sqrt(torch.mean(want ** 2)).clamp(min=1e-12)
        out[key] = float(gap / scale)
    return out


def grasp_gap(poses: torch.Tensor, scores: torch.Tensor, cand: dict) -> float:
    """Worst returned grasp's gap to its nearest valid reference candidate
    (0 when none was returned, which `count_gap` judges; 1e30 when the
    reference has no valid one)."""
    if len(poses) == 0:
        return 0.0
    ok = cand["valid"]
    if not bool(ok.any()):
        return 1e30
    ref_p, ref_s = cand["poses"][ok], cand["scores"][ok]
    pose_gap = (poses[:, None] - ref_p[None]).abs().flatten(2).amax(2)
    score_gap = (scores[:, None] - ref_s[None]).abs()
    return float(torch.maximum(pose_gap, score_gap).amin(dim=1).amax())


def judge_scene(scene: dict, sd: dict, cfg: dict, traffic: dict,
                prec: Precision | None = None, detail: bool = False) -> dict:
    """One scene's numbers (and with `detail` each head's error and the
    valid candidates' counts).  `scene`: the camera "cloud" (n, 3), its
    replayed "draws" (uniforms, positions) and "uniforms" (S,), and what
    the program gave: "points" (N, 3) model input, "preds" channels-first,
    "poses" / "scores" returned, "num_valid"."""
    dev = scene["points"].device
    prec = prec or stated(cfg)
    k = traffic["num_candidates"]
    ref_points = preprocess.model_input(
        scene["cloud"], traffic["capacity"], cfg["NUM_INPUT"],
        *scene["draws"], dev, prec)
    ref_preds = model.forward(sd, cfg, scene["points"], prec)
    cloud = torch.as_tensor(scene["cloud"], device=dev)
    cand = post.candidates(scene["points"], scene["preds"], cloud,
                           cfg["TYPE"], k + EXTRA_CANDIDATES,
                           traffic["score_threshold"],
                           traffic["verticalness_threshold"], prec)
    heads = head_errors(scene["preds"], ref_preds, scene["points"])
    ref_valid = int(cand["valid"][:k].sum())
    due = min(traffic["num_selected"], ref_valid)
    out = {"prep_mismatch": prep_mismatch(scene["points"], ref_points),
           "model_error": max(heads.values()),
           "valid_gap": abs(int(scene["num_valid"]) - ref_valid) / k,
           "count_gap": float(abs(len(scene["poses"]) - due)),
           "grasp_gap": grasp_gap(
               torch.as_tensor(scene["poses"], device=dev).float(),
               torch.as_tensor(scene["scores"], device=dev).float(), cand)}
    if detail:
        out.update({f"head_{h}": v for h, v in heads.items()})
        out["ref_valid"] = float(ref_valid)
    return out


def judge(scenes: list, sd: dict, cfg: dict, traffic: dict,
          detail: bool = False) -> dict:
    """The worst of each number over the sampled scenes; a scene given as
    None (its answer never came) counts in `missing`."""
    worst = {name: 0.0 for name in NUMBERS}
    fewest = None
    for scene in scenes:
        if scene is None:
            worst["missing"] += 1
            continue
        for name, v in judge_scene(scene, sd, cfg, traffic,
                                   detail=detail).items():
            if name == "ref_valid":
                fewest = v if fewest is None else min(fewest, v)
            else:
                worst[name] = max(worst.get(name, 0.0), v)
    if fewest is not None:
        worst["ref_valid_fewest"] = fewest
    return worst


def control_scene(scene: dict, sd: dict, cfg: dict, traffic: dict,
                  prec: Precision) -> dict:
    """The reference put in the program's place at precision `prec`: what
    it gives for `scene` (its cloud, draws and uniforms), in the form
    `judge_scene` takes."""
    dev = scene["uniforms"].device
    points = preprocess.model_input(
        scene["cloud"], traffic["capacity"], cfg["NUM_INPUT"],
        *scene["draws"], dev, prec)
    preds = model.forward(sd, cfg, points, prec)
    cloud = torch.as_tensor(scene["cloud"], device=dev)
    cand = post.candidates(points, preds, cloud, cfg["TYPE"],
                           traffic["num_candidates"],
                           traffic["score_threshold"],
                           traffic["verticalness_threshold"], prec)
    poses, scores = post.grasps(cand, scene["uniforms"],
                                traffic["num_selected"])
    return {**scene, "points": points, "preds": preds, "poses": poses,
            "scores": scores, "num_valid": int(cand["valid"].sum())}
