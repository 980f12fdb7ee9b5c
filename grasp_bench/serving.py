"""The detect drivers' common part: one `GraspDetector` of the cell's
configuration holding the benchmark's weights, a pool of seeded scenes,
warm-up calls of the cell's own shapes, and a window of the cell's
traffic.  A forward hook on the detector's network copies, for each call
sampled from the seed, its model input and predictions into pinned host
buffers made at set-up (copies queued on the stream, nothing waited for,
no device memory held); the sampled calls' grasps and valid counts are
kept beside them for the check.

A driver subclasses `Detector` and writes `_loop`, its traffic's window.
"""

from __future__ import annotations

import os
import time
import warnings

import numpy as np

from . import scenes, weights
from .flops import forward_flops

# The detector's model configuration keys the benchmark's file states.
_PN2_KEYS = ("NUM_INPUT", "NUM_CENTROIDS", "RADIUS", "NUM_NEIGHBOURS",
             "SA_CHANNELS", "FP_CHANNELS", "NUM_FP_NEIGHBOURS",
             "SEG_CHANNELS", "SORT_POINTS", "FPS_SHARDS")


def _plain(v):
    return [_plain(x) for x in v] if isinstance(v, (list, tuple)) else v


def program_config(cfg) -> dict:
    """The detector's configuration in the benchmark's terms."""
    pn2 = cfg.MODEL.PN2
    out = {k: _plain(getattr(pn2, k)) for k in _PN2_KEYS}
    out.update(TYPE=cfg.MODEL.TYPE, COMPUTE_DTYPE=cfg.MODEL.COMPUTE_DTYPE,
               SCORE_CLASSES=cfg.DATA.SCORE_CLASSES,
               NUM_REMOVAL_DIRECTIONS=cfg.DATA.NUM_REMOVAL_DIRECTIONS)
    return out


class Detector:
    """Interface of a driver: `setup()`, `window(seconds, run)`,
    `stretch()` (the profiled calls), `release()`, `check()` (the numbers
    of the comparison with the reference)."""

    def __init__(self, cell, config, traffic, seed, device, trace, workdir):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.model_cfg = config["model"]
        self.seed, self.device, self.trace = seed, device, trace
        self.workdir = workdir
        self.batch = traffic.get("batch", 1)
        self.flops_per_item = forward_flops(self.model_cfg)
        draw = scenes.rng(seed, 3)
        self.sample = sorted(int(i) for i in draw.choice(
            traffic["sample_from"], traffic["sample_calls"], replace=False))
        # The detector takes a 32-bit seed.
        self.window_seed = int(scenes.rng(seed, 4).randint(1, 2 ** 31 - 1))
        self.calls = 0          # calls (frames) of the window
        self.forwards = 0       # forwards of the window
        self.captured, self.answers = {}, {}
        self.capturing = False

    # -- set-up -----------------------------------------------------------

    def setup(self) -> dict:
        """Build everything the window needs; returns the seconds of each
        part."""
        parts, t = {}, time.perf_counter()

        def lap(name):
            nonlocal t
            now = time.perf_counter()
            parts[name] = now - t
            t = now

        from s4g_tpu_torch import _build
        from s4g_tpu_torch.pipeline.detector import GraspDetector
        lap("import_program")
        if self.device == "cuda":
            _build.load_library()
        lap("kernels")
        self.sd = weights.make(self.model_cfg, self.seed, self.device)
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

    def _shapes(self, module, inputs, output):
        self.shapes = {k: (v.shape, v.dtype) for k, v in
                       {"points": inputs[0]["scene_points"], **output}.items()}

    def _buffers(self) -> dict:
        import torch
        pin = self.device == "cuda"
        return {k: torch.empty(s, dtype=d, pin_memory=pin)
                for k, (s, d) in self.shapes.items()}

    def _sync(self):
        if self.device == "cuda":
            import torch
            torch.cuda.synchronize()

    @property
    def kwargs(self) -> dict:
        tr = self.traffic
        return {"num_selected": tr["num_selected"],
                "score_threshold": tr["score_threshold"],
                "verticalness_threshold": tr["verticalness_threshold"]}

    def clouds(self, call: int) -> list:
        """The pool scenes of a call (the pool cycled scene by scene)."""
        return [self.pool[(call * self.batch + j) % len(self.pool)]
                for j in range(self.batch)]

    def _hook(self, module, inputs, output):
        i = self.forwards
        self.forwards += 1
        if self.capturing and i in self.sample:
            bufs = self.buffers[self.sample.index(i)]
            for k, v in {"points": inputs[0]["scene_points"],
                         **output}.items():
                bufs[k].copy_(v, non_blocking=True)
            self.captured[i] = bufs

    def _keep(self, call: int, results, num_valid):
        if self.capturing and call in self.sample:
            nv = num_valid if isinstance(num_valid, list) else [num_valid]
            self.answers[call] = (results, nv)

    # -- the window ---------------------------------------------------------

    def window(self, seconds: float, run) -> None:
        """The cell's traffic for `seconds`: records each completed call
        ({"t0", "t1", "items"}, and "timings" in a traced run) into
        `run.records`, the window's start and last completion into
        `run.window`.  The detector's generators (torch's, and numpy's for
        fitting a larger cloud to the capacity) are seeded anew first, so
        the sampled calls' draws can be replayed."""
        self.det.generator.manual_seed(self.window_seed)
        self.det._np_rng = np.random.RandomState(self.window_seed)
        self.calls = self.forwards = 0
        self.capturing = True
        try:
            self._loop(seconds, run)
        finally:
            self.capturing = False
            self._sync()

    def _loop(self, seconds, run):
        raise NotImplementedError

    def stretch(self) -> None:
        """The profiled stretch: `profile_calls` more calls of the cell's
        traffic, nothing captured."""
        for _ in range(self.traffic["profile_calls"]):
            self._call(self.calls)
            self.calls += 1

    def release(self) -> None:
        """Free the program's state (the captured outputs stay)."""
        del self.det
        if self.device == "cuda":
            import torch
            torch.cuda.empty_cache()

    # -- the check ----------------------------------------------------------

    def check(self, detail: bool = False) -> dict:
        """The numbers `correct` is decided by (`check.judge`)."""
        from . import check
        return check.judge(self.scenes(), self.sd, self.model_cfg,
                           self.traffic, detail)

    def inputs(self) -> list:
        """(call, scene in the call, {"cloud" as fitted to the capacity, its
        replayed "draws" and grasp "uniforms"}) of every sampled scene."""
        from .reference import draws
        tr = self.traffic
        replay = draws.replay(
            self.window_seed, self.device,
            [[len(c) for c in self.clouds(i)]
             for i in range(max(self.sample) + 1)],
            tr["capacity"], self.model_cfg["NUM_INPUT"], tr["num_selected"],
            set(self.sample))
        out = []
        for call in self.sample:
            for j, cloud in enumerate(self.clouds(call)):
                subset, uniforms, positions = replay[call][0][j]
                out.append((call, j, {
                    "cloud": cloud if subset is None else cloud[subset],
                    "draws": (uniforms, positions),
                    "uniforms": replay[call][1][j]}))
        return out

    def scenes(self) -> list:
        """Each sampled scene as `check.judge_scene` takes it, or None where
        its answer never came."""
        out = []
        for call, j, scene in self.inputs():
            got, ans = self.captured.get(call), self.answers.get(call)
            if got is None or ans is None or j >= len(ans[0]):
                out.append(None)
                continue
            poses, scores = ans[0][j]
            out.append({**scene,
                        "points": got["points"][j].t().float().to(
                            self.device),
                        "preds": {k: v[j].to(self.device)
                                  for k, v in got.items() if k != "points"},
                        "poses": np.asarray(poses),
                        "scores": np.asarray(scores),
                        "num_valid": ans[1][j]})
        return out


def count_syncs(fn):
    """`fn` wrapped so that each call's host waits on the device
    (`torch.cuda.set_sync_debug_mode("warn")` warnings) are appended to
    the wrapper's `counts`."""
    import torch

    def wrapped(*args, **kwargs):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(0)
                wrapped.counts.append(sum(
                    "synchroniz" in str(w.message) for w in caught))

    wrapped.counts = []
    return wrapped
