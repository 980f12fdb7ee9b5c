"""GraspDetector — the end-to-end grasp-proposal API on the GPU (port of
s4g_tpu/pipeline/detector.py, `detect` at batch 1).

One call: camera frame -> train frame, preprocessing (voxel / outlier /
fixed-size sample), the PN2_CLS forward, post-processing, the collision
check against the camera-frame cloud and importance sampling.  The raw
cloud is padded to `cloud_capacity`; candidates are a fixed top-K with a
validity mask.  The stage functions `prep_one` and `post_one` take their
random draws as inputs; `detect` draws them from the detector's seeded
`torch.Generator` on the device.

Not in this slice: `detect_batch` (needs the fused SA1 kernel), streaming,
`eval`, mesh serving, training and checkpoint loading (ROADMAP.md).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..configs import processing_config as proc_cfg
from ..configs.config import Config, load_cfg_from_file
from ..models import build_model
from ..utils.math_utils import batch_transformation_inv
from .collision import batch_view_non_collision
from .postprocessing import (REAL2TRAIN, importance_sample,
                             post_process_predictions)
from .preprocessing import preprocess_cloud, random_sample_fixed

_SUPPORTED_MODELS = ("curvature_model",)
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
        sample_idx = random_sample_fixed(cloud_valid, num_input, generator)
    return train_cloud[sample_idx.long()]


def post_one(points: torch.Tensor, preds: dict, cloud: torch.Tensor,
             cloud_valid: torch.Tensor, uniforms: torch.Tensor,
             score_threshold: float, vertical_threshold: float,
             num_candidates: int, collision_check: bool = True) -> dict:
    """Post-processing + collision + importance sampling for one scene.

    Args: points (N, 3) model input; preds: per-scene (unbatched) PN2_CLS
        predictions; cloud/cloud_valid: the padded camera-frame cloud;
        uniforms (num_selected,) draws in [0, 1).
    """
    post = post_process_predictions(
        points.t(), preds["score"], preds["frame_R"], preds["frame_t"],
        score_threshold, vertical_threshold, num_candidates=num_candidates)
    valid = post.valid
    if collision_check:
        # Collision vs the ORIGINAL camera-frame cloud.
        g2l = batch_transformation_inv(post.poses)
        valid = valid & batch_view_non_collision(g2l, cloud, cloud_valid)
    sel = importance_sample(post.scores, valid, uniforms)
    return {"poses": post.poses, "scores": post.scores, "valid": valid,
            "selected": sel, "num_valid": valid.sum()}


class GraspDetector:
    """Detect grasp poses in the camera frame from a raw point cloud."""

    def __init__(self, model: str = "curvature_model",
                 device: Optional[str] = None, cloud_capacity: int = 65536,
                 num_candidates: int = 1024, seed: int = 0,
                 state_dict: Optional[dict] = None,
                 enable_voxel_downsample: bool = True,
                 enable_outlier_removal: bool = True):
        """`device`: "cuda" (the default) or "cpu" (the tests); without a
        GPU a detector is only made when the CPU is asked for.
        `state_dict`: PN2_CLS weights under the reference torch names (see
        utils/weights.py); without it the weights are random from `seed`."""
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "GraspDetector runs on CUDA and no GPU is available; "
                    "pass device='cpu' to run on the CPU")
            device = "cuda"
        self.device = torch.device(device)
        if model in _SUPPORTED_MODELS:
            cfg_path = os.path.join(_CONFIG_DIR, f"{model}.yaml")
        elif os.path.exists(model):
            cfg_path = model
        else:
            raise ValueError(f"Model {model!r} is not supported; options: "
                             f"{_SUPPORTED_MODELS} or a YAML path")
        self.cfg: Config = load_cfg_from_file(cfg_path)
        check_full_f32()
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)   # seeded random init of the parameters
            self.net = build_model(self.cfg)
        if state_dict is not None:
            self.net.load_state_dict(state_dict)
        self.net.to(self.device)
        self.cloud_capacity = cloud_capacity
        self.num_candidates = num_candidates
        self.num_input = self.cfg.MODEL.PN2.NUM_INPUT
        self._enable_voxel = enable_voxel_downsample
        self._enable_outlier = enable_outlier_removal
        self._np_rng = np.random.RandomState(seed)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.timings: dict = {}
        self.last_num_valid = 0

    def _pad_cloud(self, cloud_array: np.ndarray):
        """(n, 3) -> padded (capacity, 3) + valid mask, on the device."""
        n = cloud_array.shape[0]
        if n > self.cloud_capacity:
            sel = self._np_rng.choice(n, self.cloud_capacity, replace=False)
            cloud_array = cloud_array[sel]
            n = self.cloud_capacity
        out = np.zeros((self.cloud_capacity, 3), np.float32)
        out[:n] = cloud_array
        # Park padding far outside the workspace so neighbour ops ignore it.
        out[n:] = 1e6
        valid = np.zeros(self.cloud_capacity, bool)
        valid[:n] = True
        return (torch.from_numpy(out).to(self.device),
                torch.from_numpy(valid).to(self.device))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def detect(self, cloud_array: np.ndarray,
               cloud_mask: Optional[np.ndarray] = None, num_selected: int = 5,
               score_threshold: float = 0.7,
               verticalness_threshold: float = 0.2,
               collision_check: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        """Full pipeline: returns (poses (n, 4, 4) camera frame, scores (n,)).
        Per-stage wall times (ms, synchronized) land in `self.timings`, the
        number of valid candidates in `self.last_num_valid`."""
        t0 = time.perf_counter()
        cloud_array = np.asarray(cloud_array, np.float32)
        if cloud_array.ndim != 2:
            raise ValueError("input must be (n, 3) or (3, n)")
        if cloud_array.shape[0] == 3 and cloud_array.shape[1] != 3:
            cloud_array = cloud_array.T
        if isinstance(cloud_mask, np.ndarray):
            cloud_array = cloud_array[cloud_mask]
        cloud, valid = self._pad_cloud(cloud_array)
        self._sync()
        t1 = time.perf_counter()
        with torch.no_grad():
            points = prep_one(cloud, valid, self.num_input,
                              generator=self.generator,
                              enable_voxel=self._enable_voxel,
                              enable_outlier=self._enable_outlier)
            self._sync()
            t2 = time.perf_counter()
            preds = self.net({"scene_points": points.t()[None].contiguous()})
            self._sync()
            t3 = time.perf_counter()
            uniforms = torch.rand(num_selected, generator=self.generator,
                                  device=self.device)
            out = post_one(points, {k: v[0] for k, v in preds.items()}, cloud,
                           valid, uniforms, float(score_threshold),
                           float(verticalness_threshold), self.num_candidates,
                           collision_check)
            out = {k: v.cpu().numpy() for k, v in out.items()}
        t4 = time.perf_counter()
        self.timings = {"pad_ms": 1e3 * (t1 - t0), "prep_ms": 1e3 * (t2 - t1),
                        "model_ms": 1e3 * (t3 - t2),
                        "post_ms": 1e3 * (t4 - t3),
                        "total_ms": 1e3 * (t4 - t0)}
        logger.info("detect: %s", self.timings)
        num_valid = self.last_num_valid = int(out["num_valid"])
        if num_valid == 0:
            return (np.zeros((0, 4, 4), np.float32),
                    np.zeros((0,), np.float32))
        # Duplicate draws kept (reference grasp_detector.py:240-250).
        idx = (out["selected"] if num_valid > num_selected
               else np.nonzero(out["valid"])[0])
        return out["poses"][idx], out["scores"][idx]
