"""The JAX package's public names in the port: each subpackage's `__init__`
re-exports what the JAX package's does (`pipeline`, `train`, `runtime`,
`utils`, `ops`), importing neither jax nor anything of `s4g_tpu`, building
nothing and leaving CUDA uninitialised; and the SE(3) helpers of
`utils/math_utils.py` against the JAX package's on seeded inputs."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from s4g_tpu.utils import math_utils as jmath

from s4g_tpu_torch.utils import math_utils as tmath

REPO = Path(__file__).resolve().parents[1]
SUBPACKAGES = ("pipeline", "train", "runtime", "utils", "ops")

NAMES = {
    "pipeline": ("preprocess_cloud", "radius_outlier_mask",
                 "random_sample_fixed", "voxel_downsample",
                 "workspace_crop_mask", "batch_view_non_collision",
                 "post_process_predictions", "GraspDetector"),
    "train": ("build_optimizer", "build_lr_schedule", "TrainState",
              "Trainer", "SceneGraspDataset", "collate_scene"),
    "runtime": ("native_available", "voxel_downsample_trace",
                "radius_outlier_mask", "nearest_neighbor_match",
                "AsyncSceneLoader"),
    "utils": ("setup_logger", "shutdown_logger", "AverageMeter",
              "MetricLogger", "math_utils"),
    "ops": ("gather_points", "group_points", "gather_knn", "ball_query",
            "ball_query_grouped", "three_nn", "pairwise_sqdist",
            "farthest_point_sample", "feature_interpolate"),
}


def _jax_exports(sub: str) -> set:
    """The names the JAX subpackage's `__init__` imports (read, not run)."""
    tree = ast.parse((REPO / "s4g_tpu" / sub / "__init__.py").read_text())
    return {alias.asname or alias.name for node in ast.walk(tree)
            if isinstance(node, ast.ImportFrom) for alias in node.names}


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_port_exports_cover_the_jax_names(sub):
    import importlib
    module = importlib.import_module(f"s4g_tpu_torch.{sub}")
    assert set(NAMES[sub]) <= _jax_exports(sub) | {"math_utils"}
    missing = [n for n in sorted(_jax_exports(sub) | set(NAMES[sub]))
               if not hasattr(module, n)]
    assert not missing, missing


def test_gather_knn_is_group_points():
    from s4g_tpu_torch import ops
    rng = np.random.RandomState(0)
    pts = torch.from_numpy(rng.randn(2, 5, 40).astype(np.float32))
    idx = torch.from_numpy(rng.randint(0, 40, (2, 8, 4)).astype(np.int32))
    assert torch.equal(ops.gather_knn(pts, idx), ops.group_points(pts, idx))


def test_subpackages_import_no_jax_build_nothing_and_leave_cuda_alone(
        tmp_path):
    """In a fresh process: the five subpackages load no jax module and
    nothing of the JAX package, start no compiler (the kernel and host-op
    libraries are built at first use) and do not initialise CUDA."""
    code = (
        "import subprocess, sys\n"
        "calls = []\n"
        "real = subprocess.Popen.__init__\n"
        "def spy(self, *a, **k):\n"
        "    calls.append(a[0] if a else k.get('args'))\n"
        "    return real(self, *a, **k)\n"
        "subprocess.Popen.__init__ = spy\n"
        "import torch\n"
        f"for sub in {SUBPACKAGES!r}:\n"
        "    __import__('s4g_tpu_torch.' + sub)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 's4g_tpu' or m.startswith('s4g_tpu.')]\n"
        "assert not bad, bad\n"
        "assert not calls, calls\n"
        "assert not torch.cuda.is_initialized()\n"
        "from s4g_tpu_torch import _build\n"
        "from s4g_tpu_torch.runtime import host_ops\n"
        "assert _build._lib is None and host_ops._lib is None\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _se3(rng, count):
    q, r = np.linalg.qr(rng.randn(count, 3, 3))
    q = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    q[np.linalg.det(q) < 0, :, 2] *= -1
    t = np.tile(np.eye(4), (count, 1, 1))
    t[:, :3, :3] = q
    t[:, :3, 3] = rng.uniform(-1, 1, (count, 3))
    return t


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_numpy_se3_helpers_equal_jax(dtype):
    rng = np.random.RandomState(1)
    for tr in _se3(rng, 5).astype(dtype):
        np.testing.assert_array_equal(tmath.transformation_inv(tr),
                                      jmath.transformation_inv(tr))
        cloud = rng.randn(3, 200).astype(dtype)
        np.testing.assert_array_equal(
            tmath.transform_numpy_points(cloud, tr),
            jmath.transform_numpy_points(cloud, tr))
    with pytest.raises(AssertionError):
        tmath.transformation_inv(np.eye(3))
    with pytest.raises(AssertionError):
        tmath.transform_numpy_points(np.zeros((4, 5)), np.eye(4))


@pytest.mark.parametrize("batch", [(), (4,), (2, 3)])
def test_transform_points_matches_jax(batch):
    """R . points + t on (..., 3, N) f32 points against JAX's HIGHEST-
    precision matmul: within 1e-6 of the output's largest (the two sum the
    three products in their own order)."""
    rng = np.random.RandomState(len(batch))
    count = int(np.prod(batch, dtype=int))
    tr = _se3(rng, count).astype(np.float32).reshape(*batch, 4, 4)
    pts = rng.uniform(-2, 2, (*batch, 3, 300)).astype(np.float32)
    want = np.asarray(jmath.transform_points(jnp.asarray(pts),
                                             jnp.asarray(tr)))
    got = tmath.transform_points(torch.from_numpy(pts), torch.from_numpy(tr))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
