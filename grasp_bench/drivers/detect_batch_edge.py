"""`detect_batch` of the edge-convolution model (EDGEPN2DU, or EDGEPN2D):
the `detect_batch` driver's traffic, with this model's weights
(`reference.edge.make_weights`), its program-configuration check (the
model's own section, `MODEL.<TYPE>`, and the detector's `MODEL.PN2.
NUM_INPUT`) and its check: each sampled scene judged by `check.py`'s
numbers and helpers against `reference/edge.py`.  `control()` gives the
numbers of that reference put in the program's place one precision step
below the configuration's (`calibrate_edge.py`)."""

from __future__ import annotations

import os
import time

import torch

from .. import scenes
from ..check import (EXTRA_CANDIDATES, NUMBERS, grasp_gap, head_errors,
                     prep_mismatch)
from ..reference import edge, post, preprocess
from ..reference.precision import Precision, control, stated
from ..serving import _plain
from .detect_batch import Driver as _Batch

# The model section's keys the benchmark's file states.
_SECTION_KEYS = ("NUM_CENTROIDS", "RADIUS", "NUM_NEIGHBOURS", "SA_CHANNELS",
                 "FP_CHANNELS", "NUM_FP_NEIGHBOURS", "SEG_CHANNELS",
                 "SORT_POINTS", "FPS_SHARDS")


def program_config(cfg) -> dict:
    """The detector's configuration in the benchmark's terms: its model
    type's section, and the model input size the detector reads."""
    sec = getattr(cfg.MODEL, cfg.MODEL.TYPE)
    out = {k: _plain(getattr(sec, k)) for k in _SECTION_KEYS}
    out.update(NUM_INPUT=cfg.MODEL.PN2.NUM_INPUT, TYPE=cfg.MODEL.TYPE,
               COMPUTE_DTYPE=cfg.MODEL.COMPUTE_DTYPE,
               SCORE_CLASSES=cfg.DATA.SCORE_CLASSES,
               NUM_REMOVAL_DIRECTIONS=cfg.DATA.NUM_REMOVAL_DIRECTIONS)
    return out


def judge_scene(scene: dict, sd: dict, cfg: dict, traffic: dict,
                prec: Precision | None = None, detail: bool = False) -> dict:
    """`check.judge_scene` with the edge model's reference."""
    dev = scene["points"].device
    prec = prec or stated(cfg)
    k = traffic["num_candidates"]
    ref_points = preprocess.model_input(
        scene["cloud"], traffic["capacity"], cfg["NUM_INPUT"],
        *scene["draws"], dev, prec)
    ref_preds = edge.forward(sd, cfg, scene["points"], prec)
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


def judge(judged: list, sd: dict, cfg: dict, traffic: dict,
          detail: bool = False) -> dict:
    """`check.judge` with the edge model's reference: the worst of each
    number over the sampled scenes, a missing scene counted."""
    worst = {name: 0.0 for name in NUMBERS}
    fewest = None
    for scene in judged:
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
    """`check.control_scene` with the edge model's reference."""
    dev = scene["uniforms"].device
    points = preprocess.model_input(
        scene["cloud"], traffic["capacity"], cfg["NUM_INPUT"],
        *scene["draws"], dev, prec)
    preds = edge.forward(sd, cfg, points, prec)
    cloud = torch.as_tensor(scene["cloud"], device=dev)
    cand = post.candidates(points, preds, cloud, cfg["TYPE"],
                           traffic["num_candidates"],
                           traffic["score_threshold"],
                           traffic["verticalness_threshold"], prec)
    poses, scores = post.grasps(cand, scene["uniforms"],
                                traffic["num_selected"])
    return {**scene, "points": points, "preds": preds, "poses": poses,
            "scores": scores, "num_valid": int(cand["valid"].sum())}


class Driver(_Batch):

    def __init__(self, *args):
        super().__init__(*args)
        self.flops_per_item = edge.forward_flops(self.model_cfg)

    def setup(self) -> dict:
        """`serving.Detector.setup` with the edge model's weights and
        configuration check; the detector is made before the kernels are
        built, so a program that does not serve the model stops at once."""
        parts, t = {}, time.perf_counter()

        def lap(name):
            nonlocal t
            now = time.perf_counter()
            parts[name] = now - t
            t = now

        from s4g_tpu_torch import _build
        from s4g_tpu_torch.pipeline.detector import GraspDetector
        lap("import_program")
        self.sd = edge.make_weights(self.model_cfg, self.seed, self.device)
        tr = self.traffic
        self.det = GraspDetector(
            model=self.config["port_model"], device=self.device,
            output_dir=os.path.join(self.workdir, "detector"),
            cloud_capacity=tr["capacity"],
            num_candidates=tr["num_candidates"],
            seed=self.window_seed + 1, state_dict=self.sd)
        got = program_config(self.det.cfg)
        want = {k: self.model_cfg[k] for k in got}
        if got != want:
            raise ValueError(f"the program's configuration {got} is not the "
                             f"benchmark's {want}")
        lap("model")
        if self.device == "cuda":
            _build.load_library()
        lap("kernels")
        self.pool = scenes.scene_pool(self.seed, tr)
        lap("data")
        hook = self.det.net.register_forward_hook(self._shapes)
        for i in range(tr["warmup_calls"]):
            self._call(i)
        hook.remove()
        self._sync()
        self.buffers = [self._buffers() for _ in self.sample]
        lap("warm_up")
        self.det.net.register_forward_hook(self._hook)
        return parts

    def check(self, detail: bool = False) -> dict:
        return judge(self.scenes(), self.sd, self.model_cfg, self.traffic,
                     detail)

    def control(self) -> dict:
        """The worst numbers of the reference put in the program's place
        one precision step below the configuration's (fp8 matmul operands
        for bf16 ones, bf16 values), on what a run of this seed would
        check."""
        self.pool = scenes.scene_pool(self.seed, self.traffic)
        self.sd = edge.make_weights(self.model_cfg, self.seed, self.device)
        prec = control(self.model_cfg)
        ctrl = [control_scene(scene, self.sd, self.model_cfg, self.traffic,
                              prec) for _, _, scene in self.inputs()]
        return judge(ctrl, self.sd, self.model_cfg, self.traffic, True)
