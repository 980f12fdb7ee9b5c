"""GraspDetector — the end-to-end grasp-proposal API on the GPU (port of
s4g_tpu/pipeline/detector.py: `detect`, `detect_batch`, `detect_stream`
and `eval`, with its weight loading).

One call: camera frame -> train frame, preprocessing (voxel / outlier /
fixed-size sample), the model's forward (PN2_CLS, the curvature model, or
a model with the contact model's outputs: PN2, EDGEPN2D or EDGEPN2DU),
post-processing, the collision check against the
camera-frame cloud and importance sampling.  The raw
cloud is padded to `cloud_capacity`; candidates are a fixed top-K with a
validity mask.  The stage functions `prep_one` / `post_one` (one scene) and
`prep_batch` / `post_batch` (B scenes) take their random draws as inputs;
`detect` and `detect_batch` draw them from the detector's seeded
`torch.Generator` on the device.  `detect_batch` runs the model once on
(B, 3, N), so at B >= 2 its SA1 stage is the fused kernel (K3) and its
numbers differ from `detect`'s at bf16 level, as in the JAX package.

A YAML path in place of the model name selects another configuration of
the same model, e.g. the reference-parity one (`curvature_model.yaml` with
SORT_POINTS false and FPS_SHARDS 1: exact FPS, K6, and full-scan ball
queries, K2f).  On the card the eval forward runs every bf16 SharedMLP
chain through K7 (`models.nn_layers.fused_route`, the default since the
H100 measured K7 faster than the layer-by-layer route at every chain shape
of the three configurations); `models.nn_layers.MLP_IMPL = "unfused"` turns
that off, and "fused" runs every eligible chain through K7 (its twin on
the CPU), f32 ones too.

Weights come, in the JAX package's order, from an explicit `state_dict`,
else the config's TEST.WEIGHT (a reference `.pth` / `.pt`, or a
checkpoint of `utils.checkpoint.Checkpointer`), else
`output_dir/last_checkpoint`, else a random init from `seed`.

Mesh serving (`mesh=`, a `parallel.make_mesh` mesh, one process per
device): `detect_batch` shards the scenes over the ranks, as the JAX
program's `shard_map`; each rank runs the whole single-device program on
its B/W scenes with no collective, drawing the global batch's random
numbers in the unsharded order and keeping its scenes' draws, and the
results come back to every rank through the host.  `detect`,
`detect_stream` and `eval` run on the rank alone.
"""

from __future__ import annotations

import logging
import os
import time
from collections import deque
from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..configs import processing_config as proc_cfg
from ..configs.config import Config, load_cfg_from_file
from ..models import build_model
from ..parallel.mesh import mesh_device, shard_rows
from ..runtime.device import resolve_device
from ..utils.checkpoint import (Checkpointer, load_torch_checkpoint,
                                model_state_dict)
from ..utils.math_utils import batch_transformation_inv
from ..utils.profiling import span
from .collision import batch_view_non_collision
from .postprocessing import (REAL2TRAIN, importance_sample,
                             post_process_predictions,
                             post_process_predictions_regression)
from .preprocessing import (preprocess_cloud, random_sample_fixed,
                            sample_draws)
from .subset_draws import SubsetDraws

_SUPPORTED_MODELS = ("curvature_model", "contact_model", "edgepn2du_model")
_CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")

logger = logging.getLogger(__name__)


def check_full_f32() -> None:
    """The pipeline's f32 matmuls (camera rotation, matmul-form distances,
    radius outlier test) need full f32, as JAX's HIGHEST precision: TF32
    would move points by ~1e-3 relative."""
    if torch.backends.cuda.matmul.allow_tf32 \
            or torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "GraspDetector needs full-f32 matmuls: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')")


def prep_one(cloud: torch.Tensor, cloud_valid: torch.Tensor, num_input: int,
             sample_idx: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None,
             enable_voxel: bool = True,
             enable_outlier: bool = True) -> torch.Tensor:
    """(capacity, 3) padded camera-frame points -> (num_input, 3)
    train-frame model input.  The sample indices are `sample_idx` when
    given, else drawn from `generator`."""
    with span("detect.prep"):
        real2train = torch.tensor(REAL2TRAIN[:3, :3], device=cloud.device)
        train_cloud = torch.matmul(cloud, real2train.t())
        if enable_voxel:
            pre = preprocess_cloud(
                train_cloud, num_points=num_input,
                voxel_size=proc_cfg.VOXEL_SIZE,
                outlier_radius=proc_cfg.RADIUS_THRESHOLD,
                outlier_min_neighbors=(proc_cfg.NUM_POINTS_THRESHOLD
                                       if enable_outlier else 1),
                capacity=cloud.shape[0], sample_idx=sample_idx,
                generator=generator)
            return pre.points
        if sample_idx is None:
            sample_idx = random_sample_fixed(cloud_valid, num_input,
                                             generator)
        return train_cloud[sample_idx.long()]


def post_one(points: torch.Tensor, preds: dict, cloud: torch.Tensor,
             cloud_valid: torch.Tensor, uniforms: torch.Tensor,
             score_threshold: float, vertical_threshold: float,
             num_candidates: int, collision_check: bool = True) -> dict:
    """Post-processing + collision + importance sampling for one scene.

    Args: points (N, 3) model input; preds: per-scene (unbatched)
        predictions, PN2_CLS's (with "score": the 4-bin translation) or
        PN2's (the regression translation); cloud/cloud_valid: the padded
        camera-frame cloud; uniforms (num_selected,) draws in [0, 1).
    """
    with span("post.candidates"):
        if "score" in preds:
            post = post_process_predictions(
                points.t(), preds["score"], preds["frame_R"],
                preds["frame_t"], score_threshold, vertical_threshold,
                num_candidates=num_candidates)
        else:
            post = post_process_predictions_regression(
                points.t(), preds["scene_score_logits"], preds["frame_R"],
                preds["frame_t"], score_threshold, vertical_threshold,
                num_candidates=num_candidates)
    valid = post.valid
    if collision_check:
        # Collision vs the ORIGINAL camera-frame cloud.
        with span("post.collision"):
            g2l = batch_transformation_inv(post.poses)
            valid = valid & batch_view_non_collision(g2l, cloud,
                                                     cloud_valid)
    sel = importance_sample(post.scores, valid, uniforms)
    return {"poses": post.poses, "scores": post.scores, "valid": valid,
            "selected": sel, "num_valid": valid.sum()}


def prep_batch(clouds: torch.Tensor, cloud_valids: torch.Tensor,
               num_input: int, sample_idx: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               enable_voxel: bool = True,
               enable_outlier: bool = True) -> torch.Tensor:
    """(B, capacity, 3) padded clouds -> (B, num_input, 3) model inputs:
    `prep_one` per scene (the JAX program vmaps the same function).
    `sample_idx`: (B, num_input) injected draws, else drawn from
    `generator` scene by scene."""
    return torch.stack([
        prep_one(clouds[i], cloud_valids[i], num_input,
                 sample_idx=None if sample_idx is None else sample_idx[i],
                 generator=generator, enable_voxel=enable_voxel,
                 enable_outlier=enable_outlier)
        for i in range(clouds.shape[0])])


def post_batch(points: torch.Tensor, preds: dict, clouds: torch.Tensor,
               cloud_valids: torch.Tensor, uniforms: torch.Tensor,
               score_threshold: float, vertical_threshold: float,
               num_candidates: int, collision_check: bool = True) -> dict:
    """`post_one` per scene, outputs stacked on a leading batch axis.

    Args: points (B, N, 3); preds: batched predictions; clouds /
        cloud_valids (B, capacity, ...); uniforms (B, num_selected)."""
    outs = [post_one(points[i], {k: v[i] for k, v in preds.items()},
                     clouds[i], cloud_valids[i], uniforms[i],
                     score_threshold, vertical_threshold, num_candidates,
                     collision_check)
            for i in range(points.shape[0])]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def _uniforms(generator: torch.Generator, shape, device) -> torch.Tensor:
    """The importance sampling's uniforms, (B, num_selected): one draw for
    the whole batch, after every scene's sample draws."""
    return torch.rand(shape, generator=generator, device=device)


def _grasps(out: dict, num_selected: int) -> Tuple[np.ndarray, np.ndarray]:
    """One scene's host outputs -> (poses, scores): the importance draws,
    duplicates kept (reference grasp_detector.py:240-250), or every valid
    candidate when there are no more than `num_selected`.  Both are copies:
    nothing returned shares the host buffers."""
    num_valid = int(out["num_valid"])
    if num_valid == 0:
        return np.zeros((0, 4, 4), np.float32), np.zeros((0,), np.float32)
    idx = (out["selected"] if num_valid > num_selected
           else np.nonzero(out["valid"])[0])
    return out["poses"][idx], out["scores"][idx]


def _as_cloud(cloud, cloud_mask: Optional[np.ndarray] = None) -> np.ndarray:
    """A camera-frame cloud, (n, 3) or (3, n), as an (n, 3) f32 array."""
    cloud = np.asarray(cloud, np.float32)
    if cloud.ndim != 2:
        raise ValueError("input must be (n, 3) or (3, n)")
    if cloud.shape[0] == 3 and cloud.shape[1] != 3:
        cloud = cloud.T
    if isinstance(cloud_mask, np.ndarray):
        cloud = cloud[cloud_mask]
    return cloud


class GraspDetector:
    """Detect grasp poses in the camera frame from a raw point cloud."""

    def __init__(self, model: str = "curvature_model",
                 device: Optional[str] = None, output_dir: str = "output",
                 cloud_capacity: int = 65536, num_candidates: int = 1024,
                 seed: int = 0, state_dict: Optional[dict] = None,
                 enable_voxel_downsample: bool = True,
                 enable_outlier_removal: bool = True, mesh=None):
        """`model`: "curvature_model", "contact_model", "edgepn2du_model"
        (EDGEPN2DU, the edge-convolution model) or a YAML path.
        `device`: "cuda" (the default) or "cpu" (the tests); without a GPU a
        detector is only made when the CPU is asked for.  `output_dir`
        (created here) holds checkpoints (`last_checkpoint`) and `detect`'s
        debug dumps.  `state_dict`: weights under the reference torch names
        (see utils/weights.py); without it they are resolved as the module
        docstring says.  `mesh`: a `parallel.make_mesh` mesh over which
        `detect_batch` shards its scenes (the detector then runs on its
        rank's device; every rank builds it with the same arguments);
        `detect_batch` batches must split over it."""
        self.mesh = mesh
        self.device = (resolve_device(device, "GraspDetector")
                       if mesh is None else mesh_device(mesh))
        self.lead = mesh is None or mesh.get_local_rank() == 0
        if model in _SUPPORTED_MODELS:
            cfg_path = os.path.join(_CONFIG_DIR, f"{model}.yaml")
        elif os.path.exists(model):
            cfg_path = model
        else:
            raise ValueError(f"Model {model!r} is not supported; options: "
                             f"{_SUPPORTED_MODELS} or a YAML path")
        self.cfg: Config = load_cfg_from_file(cfg_path)
        check_full_f32()
        self.output_dir = os.path.abspath(output_dir)
        os.makedirs(self.output_dir, exist_ok=True)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)   # seeded random init of the parameters
            self.net = build_model(self.cfg)
        if state_dict is None:
            state_dict = self._load_weights()
        if state_dict is not None:
            self.net.load_state_dict(state_dict)
        self.net.to(self.device)
        self.cloud_capacity = cloud_capacity
        self.num_candidates = num_candidates
        self.num_input = self.cfg.MODEL.PN2.NUM_INPUT
        self._enable_voxel = enable_voxel_downsample
        self._enable_outlier = enable_outlier_removal
        self._np_rng = np.random.RandomState(seed)
        self._subsets = SubsetDraws(cloud_capacity)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.timings: dict = {}
        self.last_num_valid = 0

    # -- weights --------------------------------------------------------------

    def _load_weights(self) -> Optional[dict]:
        """The weights to load, in the JAX package's order
        (`detector.py:105-124`): cfg.TEST.WEIGHT (`${PROJECT_HOME}` is the
        package directory), else `output_dir/last_checkpoint`; None (keep
        the random init) when there is neither."""
        ckpt = Checkpointer(self.output_dir, logger, self.device)
        weight = self.cfg.TEST.WEIGHT
        if weight:
            weight = weight.replace("${PROJECT_HOME}",
                                    os.path.join(_CONFIG_DIR, ".."))
            if os.path.exists(weight):
                if weight.endswith((".pth", ".pt")):
                    logger.info("Loading torch weights from %s", weight)
                    return load_torch_checkpoint(weight, self.device)
                logger.info("Loading checkpoint %s", weight)
                return model_state_dict(ckpt.load(weight, resume=False))
            logger.warning("Weight file %s not found", weight)
        if ckpt.has_checkpoint():
            return model_state_dict(ckpt.load(None, resume=True))
        logger.info("No weights found; random initialization")
        return None

    # -- host side ------------------------------------------------------------

    def _fit(self, arrays: List[np.ndarray],
             rows: slice = slice(None)) -> List[np.ndarray]:
        """(n_i, 3) clouds -> the clouds `rows`, each cut to at most
        `cloud_capacity` points: a cloud of more keeps a seeded random
        subset, `_np_rng`'s draw for it.  Every cloud of `arrays` draws, in
        order, through `SubsetDraws`, which makes the next call's draws
        ahead for clouds of this call's sizes: clouds whose sizes change
        from call to call draw inline, as before, and waste the worker's
        draw."""
        subsets = self._subsets.draws(self._np_rng, [len(a) for a in arrays])
        return [a if s is None else np.take(a, s, axis=0)
                for a, s in zip(arrays[rows], subsets[rows])]

    def _pad(self, cloud_array: np.ndarray):
        """(n, 3), n <= capacity -> padded (capacity, 3) + valid mask, on
        the device."""
        n = cloud_array.shape[0]
        out = np.zeros((self.cloud_capacity, 3), np.float32)
        out[:n] = cloud_array
        # Park padding far outside the workspace so neighbour ops ignore it.
        out[n:] = 1e6
        valid = np.zeros(self.cloud_capacity, bool)
        valid[:n] = True
        return (torch.from_numpy(out).to(self.device),
                torch.from_numpy(valid).to(self.device))

    def _pad_cloud(self, cloud_array: np.ndarray):
        """(n, 3) -> fitted to the capacity (`_fit`), then `_pad`ded."""
        return self._pad(self._fit([cloud_array])[0])

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _submit(self, arrays: List[np.ndarray], num_selected: int,
                score_threshold: float, verticalness_threshold: float,
                collision_check: bool, host: Optional[dict] = None,
                timed: bool = False, rows: Optional[slice] = None) -> dict:
        """The first half of `detect_batch`: pad the scenes, then launch
        prep, the forward and post-processing, drawing the frame's random
        numbers from `self.generator` (the sample indices, then the
        importance uniforms), and start the copies of the outputs into the
        host buffers `host` (pinned on CUDA; reused by the caller once the
        returned event has fired).  Nothing here waits for the device
        except where an op reads a device value on the host (the span
        `detect.submit` counts those waits).  `timed` synchronizes after
        each stage for `timings`.

        `rows`: run only these scenes of `arrays` (a rank's), with the
        draws the whole batch would give them: every scene draws its
        subset (`_fit`; only the rows' are gathered), and the other scenes'
        sample draws are drawn and dropped, in the unsharded order."""
        clock = [time.perf_counter()]

        def lap():
            if timed:
                self._sync()
                clock.append(time.perf_counter())

        with span("detect.submit", waits=self.device) as submit:
            with span("detect.fit"):
                rows = slice(0, len(arrays)) if rows is None else rows
                padded, valids = zip(*map(self._pad, self._fit(arrays, rows)))
                padded, valids = torch.stack(padded), torch.stack(valids)
            lap()
            with torch.no_grad():
                self._skip_draws(rows.start)
                points = prep_batch(padded, valids, self.num_input,
                                    generator=self.generator,
                                    enable_voxel=self._enable_voxel,
                                    enable_outlier=self._enable_outlier)
                self._skip_draws(len(arrays) - rows.stop)
                lap()
                with span("detect.model"):
                    preds = self.net({"scene_points":
                                      points.transpose(1, 2).contiguous()})
                lap()
                with span("detect.post"):
                    uniforms = _uniforms(self.generator,
                                         (len(arrays), num_selected),
                                         self.device)[rows]
                    out = post_batch(points, preds, padded, valids,
                                     uniforms, float(score_threshold),
                                     float(verticalness_threshold),
                                     self.num_candidates, collision_check)
            host = {} if host is None else host
            event = None
            if self.device.type == "cuda":
                for k, v in out.items():
                    if k not in host or host[k].shape != v.shape \
                            or host[k].dtype != v.dtype:
                        host[k] = torch.empty(v.shape, dtype=v.dtype,
                                              pin_memory=True)
                    host[k].copy_(v, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
            else:
                host.update(out)
        return {"host": host, "event": event, "clock": clock,
                "scenes": rows.stop - rows.start,
                "num_selected": num_selected,
                "call": None if submit is None else submit.call}

    def _skip_draws(self, scenes: int) -> None:
        """Advance the generator past `scenes` scenes' sample draws."""
        for _ in range(scenes):
            sample_draws(self.cloud_capacity, self.num_input, self.generator,
                         self.device)

    def _materialize(self, job: dict) -> List[Tuple[np.ndarray, np.ndarray]]:
        """The second half of `detect_batch`: wait for the job's copies,
        then build each scene's (poses, scores) as `_grasps` does."""
        with span("detect.wait", call=job["call"]):
            if job["event"] is not None:
                job["event"].synchronize()
        out = {k: v.numpy() for k, v in job["host"].items()}
        self.last_num_valid = [int(v) for v in out["num_valid"]]
        return [_grasps({k: v[i] for k, v in out.items()},
                        job["num_selected"])
                for i in range(job["scenes"])]

    # -- public API -----------------------------------------------------------

    def detect(self, cloud_array: np.ndarray,
               cloud_mask: Optional[np.ndarray] = None, num_selected: int = 5,
               score_threshold: float = 0.7,
               verticalness_threshold: float = 0.2,
               collision_check: bool = True,
               debug: bool = False) -> Tuple[np.ndarray, np.ndarray]:
        """Full pipeline for one camera-frame cloud, (n, 3) or (3, n):
        returns (poses (k, 4, 4) camera frame, scores (k,)).  It is
        `detect_batch` of one scene, so SA1 takes the unfused route (unless
        `nn_layers.SA1_FUSE` is "1").  Per-stage wall times (ms,
        synchronized) land in `self.timings`, the number of valid
        candidates in `self.last_num_valid`.  `debug` writes the returned
        scores and poses to `output_dir/debug` when there are any."""
        (result,) = self._detect_batch([_as_cloud(cloud_array, cloud_mask)],
                                       num_selected, score_threshold,
                                       verticalness_threshold,
                                       collision_check)
        self.last_num_valid = self.last_num_valid[0]
        poses, scores = result
        if debug and len(poses) and self.lead:
            dbg = os.path.join(self.output_dir, "debug")
            os.makedirs(dbg, exist_ok=True)
            np.savetxt(os.path.join(dbg, "top_scores.txt"), scores,
                       fmt="%.4f")
            np.savetxt(os.path.join(dbg, "processed_mat44.txt"),
                       poses.reshape(-1, 16), fmt="%.4f")
        return result

    def detect_batch(self, clouds, num_selected: int = 5,
                     score_threshold: float = 0.7,
                     verticalness_threshold: float = 0.2,
                     collision_check: bool = True
                     ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Batched multi-scene inference: the scenes are padded and
        preprocessed one by one, the model runs once on (B, 3, N), then
        post-processing runs per scene.

        Under a mesh every rank is handed the whole batch, whose size the
        world's must divide (else it raises before any work), runs its
        B/W scenes (`_submit`'s `rows`) and returns all B results, gathered
        through the host; `last_num_valid` is the whole batch's, `timings`
        the rank's with the gather's "gather_ms".

        Args: clouds: a (B, n, 3) array or a sequence of B (n_i, 3)
            camera-frame clouds.
        Returns: per scene (poses (k_i, 4, 4), scores (k_i,)).  Per-stage
        wall times (ms, synchronized) land in `self.timings`, each scene's
        number of valid candidates in `self.last_num_valid` (a list)."""
        arrays = [np.asarray(c, np.float32) for c in clouds]
        if self.mesh is None:
            return self._detect_batch(arrays, num_selected, score_threshold,
                                      verticalness_threshold,
                                      collision_check)
        rows = shard_rows(self.mesh, len(arrays))
        results = self._detect_batch(arrays, num_selected, score_threshold,
                                     verticalness_threshold, collision_check,
                                     rows)
        t0 = time.perf_counter()
        parts = [None] * self.mesh.size()
        dist.all_gather_object(parts, (results, self.last_num_valid),
                               group=self.mesh.get_group())
        self.timings["gather_ms"] = 1e3 * (time.perf_counter() - t0)
        self.last_num_valid = [v for _, part in parts for v in part]
        return [r for part, _ in parts for r in part]

    def _detect_batch(self, arrays: List[np.ndarray], num_selected: int,
                      score_threshold: float, verticalness_threshold: float,
                      collision_check: bool, rows: Optional[slice] = None
                      ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """`detect_batch` on this process: the scenes `rows` of `arrays`
        (all of them when None)."""
        if not arrays or any(a.ndim != 2 or a.shape[1] != 3 for a in arrays):
            raise ValueError("clouds must be B >= 1 arrays of shape (n, 3)")
        job = self._submit(arrays, num_selected, score_threshold,
                           verticalness_threshold, collision_check,
                           timed=True, rows=rows)
        results = self._materialize(job)
        t0, t1, t2, t3 = job["clock"]
        t4 = time.perf_counter()
        self.timings = {"pad_ms": 1e3 * (t1 - t0), "prep_ms": 1e3 * (t2 - t1),
                        "model_ms": 1e3 * (t3 - t2),
                        "post_ms": 1e3 * (t4 - t3),
                        "total_ms": 1e3 * (t4 - t0)}
        if self.lead:
            logger.info("detect (B=%d): %s", job["scenes"], self.timings)
        return results

    def detect_stream(self, clouds: Iterable, depth: int = 2,
                      num_selected: int = 5, score_threshold: float = 0.7,
                      verticalness_threshold: float = 0.2,
                      collision_check: bool = True
                      ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Pipelined single-scene serving (port of `detect_stream`,
        `detector.py:356-402`): iterate camera frames, each (n, 3) or
        (3, n), keep at most `depth` frames in flight and yield each
        frame's (poses, scores) in input order, equal to what `detect`
        gives for it on a detector in the same state.

        Each frame is submitted as `detect` runs it (the same random draws,
        in the same order) without waiting for its results: its outputs are
        copied into pinned host buffers (one set per in-flight slot, reused
        only after the frame in it was read) with a CUDA event behind them,
        and the frame is read once `depth` newer ones have been submitted
        (or the input ends).  The host still waits wherever an op reads a
        device value, so submits overlap the device only between such
        reads.  On CPU tensors the same code runs synchronously.

        `self.timings["frame_ms"]` gets each frame's wall time from its
        submit to its result, `self.last_num_valid` the last frame's count
        of valid candidates."""
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        slots = [{} for _ in range(depth)]
        frame_ms: List[float] = []
        self.timings = {"frame_ms": frame_ms}
        inflight: deque = deque()

        def read():
            job = inflight.popleft()
            (result,) = self._materialize(job)
            self.last_num_valid = self.last_num_valid[0]
            frame_ms.append(1e3 * (time.perf_counter() - job["clock"][0]))
            return result

        for i, cloud in enumerate(clouds):
            inflight.append(self._submit(
                [_as_cloud(cloud)], num_selected, score_threshold,
                verticalness_threshold, collision_check,
                host=slots[i % depth]))
            if len(inflight) >= depth:
                yield read()
        while inflight:
            yield read()

    def eval(self, cloud: np.ndarray,
             sample_idx: Optional[torch.Tensor] = None) -> dict:
        """Raw model predictions for one camera-frame cloud, (n, 3) or
        (3, n) (reference grasp_detector.py:107-121): pad, rotate to the
        train frame, voxel + outlier preprocessing and the fixed-size sample
        (always, as in the JAX package), then one forward.  The sample
        indices are `sample_idx` when given (injected draws), else drawn
        from the detector's generator.

        Returns: the model's predictions for a batch of one, channels-first
        f32 tensors on the detector's device: PN2_CLS's "score" (1, C, N),
        "frame_R" (1, 9, N), "frame_t" (1, 4, N), "movable_logits", or
        PN2's "scene_score_logits", "frame_R" (1, 9, N), "frame_t" (1, 3, N,
        grasp origins), "movable_logits"."""
        padded, valid = self._pad_cloud(_as_cloud(cloud))
        with torch.no_grad():
            points = prep_one(padded, valid, self.num_input,
                              sample_idx=sample_idx, generator=self.generator)
            return self.net({"scene_points": points.t()[None].contiguous()})
