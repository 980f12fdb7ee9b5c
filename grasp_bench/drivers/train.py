"""`train`: `Trainer.train_step` fed by `AsyncSceneLoader(
SceneGraspDataset(...))` over seeded scene pickles cycled by epoch, at the
configuration's batch.

Set-up writes the pickles into the run's temporary directory, builds one
trainer holding the benchmark's weights, and drives it through its first
`checked_steps` steps with the window's own call and feed (the warm-up);
the window then continues with that same trainer.  What the check needs
is kept from those steps: their batches and losses, the optimizer's
first moments after the first step (the first gradient times 1 - beta1)
and the parameters after the last.  In a traced run the harness times
`next()` on the loader and, around the trainer instance's `forward_loss`,
`backward` and `update`, synchronized spans."""

from __future__ import annotations

import itertools
import logging
import os
import pickle
import time

from .. import scenes, weights
from ..flops import forward_flops


class Driver:

    def __init__(self, cell, config, traffic, seed, device, trace, workdir):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.model_cfg = config["model"]
        self.seed, self.device, self.trace = seed, device, trace
        self.workdir = workdir
        self.batch = config["train"]["BATCH_SIZE"]
        self.flops_per_item = 3.0 * forward_flops(self.model_cfg)
        draw = scenes.rng(seed, 5)
        self.data_seed = int(draw.randint(1, 2 ** 31 - 1))
        self.gen_seed = int(draw.randint(1, 2 ** 31 - 1))

    # -- set-up -----------------------------------------------------------

    def _write_scenes(self) -> str:
        root = os.path.join(self.workdir, "scenes")
        os.makedirs(root)
        tr = self.traffic
        for i in range(tr["pool"]):
            data = scenes.train_scene(scenes.rng(self.seed, 6, i),
                                      **tr["scene"])
            with open(os.path.join(root, f"{i:03d}_view_0.p"), "wb") as f:
                pickle.dump(data, f)
        return root

    def _feed(self):
        for _ in itertools.count():
            yield from self.loader

    def setup(self) -> dict:
        parts, t = {}, time.perf_counter()

        def lap(name):
            nonlocal t
            now = time.perf_counter()
            parts[name] = now - t
            t = now

        import torch
        from s4g_tpu_torch import _build
        from s4g_tpu_torch.configs.config import load_cfg_from_file
        from s4g_tpu_torch.pipeline.detector import _CONFIG_DIR
        from s4g_tpu_torch.runtime.loader import AsyncSceneLoader
        from s4g_tpu_torch.train.dataset import SceneGraspDataset
        from s4g_tpu_torch.train.trainer import Trainer
        lap("import_program")
        if self.device == "cuda":
            _build.load_library()
        lap("kernels")
        self.root = self._write_scenes()
        tr, tc, mc = self.traffic, self.config["train"], self.model_cfg
        self.dataset = SceneGraspDataset(
            self.root, num_points=mc["NUM_INPUT"],
            score_classes=mc["SCORE_CLASSES"], batch_size=self.batch,
            num_frame_points=tr["num_frame_points"], t_classification=True,
            seed=self.data_seed,
            num_removal_directions=mc["NUM_REMOVAL_DIRECTIONS"])
        self.loader = AsyncSceneLoader(self.dataset,
                                       num_workers=tr["workers"])
        lap("data")
        port = self.config["port_model"]
        path = port if os.path.exists(port) else os.path.join(
            _CONFIG_DIR, f"{port}.yaml")
        cfg = load_cfg_from_file(path)
        self._check_config(cfg)
        quiet = logging.getLogger("grasp_bench.train")
        quiet.setLevel(logging.WARNING)
        self.trainer = Trainer(cfg, output_dir=os.path.join(self.workdir,
                                                            "trainer"),
                               steps_per_epoch=len(self.loader),
                               device=self.device, logger=quiet)
        self.trainer.init_state()
        self.sd = weights.make(mc, self.seed, self.device)
        self.trainer.net.load_state_dict(self.sd)
        self.trainer.generator.manual_seed(self.gen_seed)
        lap("model")
        self.feed = self._feed()
        params = dict(self.trainer.net.named_parameters())
        self.kept = {"batches": [], "losses": []}
        for s in range(tr["checked_steps"]):
            batch = next(self.feed)
            scalars = self.trainer.train_step(batch)
            self.kept["batches"].append(batch)
            self.kept["losses"].append(float(scalars["total_loss"]))
            if s == 0:
                state = self.trainer.optimizer.state
                # No moment where the step made none (a fault): zeros.
                self.kept["moment"] = {
                    k: state[p]["exp_avg"].clone() if "exp_avg" in state[p]
                    else torch.zeros_like(p) for k, p in params.items()}
        self.kept["params"] = {k: p.detach().clone()
                               for k, p in params.items()}
        if self.device == "cuda":
            torch.cuda.synchronize()
        lap("warm_up")
        return parts

    def _check_config(self, cfg) -> None:
        tc, mc = self.config["train"], self.model_cfg
        pn2 = cfg.MODEL.PN2
        got = {"TYPE": cfg.MODEL.TYPE, "BATCH_SIZE": cfg.TRAIN.BATCH_SIZE,
               "SOLVER": cfg.SOLVER.TYPE, "BASE_LR": cfg.SOLVER.BASE_LR,
               "BETAS": list(cfg.SOLVER.Adam.betas),
               "WEIGHT_DECAY": cfg.SOLVER.WEIGHT_DECAY,
               "AUGMENTATION": list(cfg.TRAIN.AUGMENTATION),
               "DROPOUT_PROB": pn2.DROPOUT_PROB,
               "NEG_WEIGHT": pn2.NEG_WEIGHT,
               "LABEL_SMOOTHING": pn2.LABEL_SMOOTHING,
               "NUM_INPUT": pn2.NUM_INPUT, "SORT_POINTS": pn2.SORT_POINTS,
               "FPS_SHARDS": pn2.FPS_SHARDS}
        want = {**{k: tc[k] for k in ("BATCH_SIZE", "SOLVER", "BASE_LR",
                                      "BETAS", "WEIGHT_DECAY",
                                      "AUGMENTATION")},
                **{k: mc[k] for k in ("TYPE", "DROPOUT_PROB", "NEG_WEIGHT",
                                      "LABEL_SMOOTHING", "NUM_INPUT",
                                      "SORT_POINTS", "FPS_SHARDS")}}
        if got != want:
            raise ValueError(f"the program's training configuration {got} "
                             f"is not the benchmark's {want}")

    # -- the window ---------------------------------------------------------

    def _sync(self):
        if self.device == "cuda":
            import torch
            torch.cuda.synchronize()

    def _spans(self, run):
        """Synchronized spans around the trainer instance's parts."""
        tr = self.trainer
        originals = {n: getattr(tr, n) for n in ("forward_loss", "backward",
                                                  "update")}
        names = {"forward_loss": "forward", "backward": "backward",
                 "update": "optimizer"}

        def timed(name, fn):
            def part(*args):
                self._sync()
                t0 = time.perf_counter()
                out = fn(*args)
                self._sync()
                run.spans.setdefault(names[name], []).append(
                    1e3 * (time.perf_counter() - t0))
                return out
            return part

        for n, fn in originals.items():
            setattr(tr, n, timed(n, fn))
        return originals

    def window(self, seconds: float, run) -> None:
        """Train steps for `seconds`; the window closes with a
        synchronize after the last step started in it."""
        originals = self._spans(run) if self.trace else {}
        start = time.perf_counter()
        end = start + seconds
        try:
            while True:
                t0 = time.perf_counter()
                batch = next(self.feed)
                if self.trace:
                    run.spans.setdefault("data_wait", []).append(
                        1e3 * (time.perf_counter() - t0))
                self.trainer.train_step(batch)
                run.records.append({"t0": t0, "items": self.batch})
                if time.perf_counter() >= end:
                    break
            self._sync()
            run.window = (start, time.perf_counter())
        finally:
            for n, fn in originals.items():
                setattr(self.trainer, n, fn)

    def stretch(self) -> None:
        for _ in range(self.traffic["profile_calls"]):
            self.trainer.train_step(next(self.feed))

    def release(self) -> None:
        self.feed.close()
        del self.trainer
        if self.device == "cuda":
            import torch
            torch.cuda.empty_cache()

    # -- the check ----------------------------------------------------------

    def check(self, detail: bool = False) -> dict:
        from .. import train_check
        return train_check.judge(self, self.kept, detail)
