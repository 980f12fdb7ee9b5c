"""The port's PN2_CLS (s4g_tpu_torch.models) against the JAX model on the
same weights and the same seeded cloud.

The config is narrow but takes every deployment route: SORT_POINTS with
128-shard FPS (K1's twin), SA1 with N = 8,192 > the 6,144 slab capacity
(K2's twin) and FP 8192 <- 1024 at N1 * N2 >= 2^22 (K4's twin).  The JAX
side routes 3-NN as it does on the TPU — the Pallas kernel (interpret mode)
for big stages, matmul-form XLA for small ones — because its default CPU
route selects the big stage with matmul-form distances too, which can
differ from the kernel at near-ties.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import s4g_tpu.ops as jops
import s4g_tpu.ops.pallas.neighbor_kernels as jnk
from s4g_tpu.configs.config import load_cfg_from_dict as j_cfg
from s4g_tpu.models import build_model as j_build
from s4g_tpu.utils.checkpoint import import_pn2_torch_state_dict

from s4g_tpu_torch.configs.config import load_cfg_from_dict as t_cfg
from s4g_tpu_torch.models import build_model as t_build
from s4g_tpu_torch.models.nn_layers import SharedMLP
from s4g_tpu_torch.utils.weights import state_dict_from_flax

NARROW = {
    "NUM_INPUT": 8192,
    "NUM_CENTROIDS": (1024, 256, 128),
    "RADIUS": (0.02, 0.08, 0.32),
    "NUM_NEIGHBOURS": (32, 32, 32),
    "SA_CHANNELS": ((16, 16, 32), (32, 32, 32), (32, 32, 32)),
    "FP_CHANNELS": ((32, 32), (32, 32), (32, 32, 16)),
    "NUM_FP_NEIGHBOURS": (3, 3, 3),
    "SEG_CHANNELS": (32, 16),
    "SORT_POINTS": True,
    "FPS_SHARDS": 128,
}


def _cfg_dict(dtype):
    return {"MODEL": {"TYPE": "PN2_CLS", "COMPUTE_DTYPE": dtype,
                      "PN2": dict(NARROW)},
            "DATA": {"SCORE_CLASSES": 3}}


@pytest.fixture
def kernel_routed_three_nn(monkeypatch):
    """JAX 3-NN routed like the TPU deployment (see module docstring)."""
    orig_pallas = jnk.three_nn_pallas
    monkeypatch.setattr(jnk, "three_nn_pallas",
                        lambda q, k, interpret=False: orig_pallas(q, k, True))
    orig = jops.three_nn

    def routed(q, k, num_neighbors=3, chunk=2048, impl="auto"):
        big = q.shape[2] * k.shape[2] >= (1 << 22)
        return orig(q, k, num_neighbors, chunk,
                    impl="pallas" if big else "xla")

    monkeypatch.setattr(jops, "three_nn", routed)


def _perturb(tree, rng):
    """Non-trivial BatchNorm statistics / affines (init gives identities)."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = _perturb(val, rng)
        elif key in ("mean", "bias"):
            out[key] = (np.asarray(val) + 0.1 * rng.randn(*val.shape)
                        ).astype(np.float32)
        elif key in ("var", "scale"):
            out[key] = (np.asarray(val) * (0.5 + rng.rand(*val.shape))
                        ).astype(np.float32)
        else:
            out[key] = np.asarray(val, np.float32)
    return out


def _pair(dtype):
    """(jax net, numpy variables, port net, numpy cloud (1, 3, N))."""
    jnet, _, _ = j_build(j_cfg(_cfg_dict(dtype)))
    rng = np.random.RandomState(0)
    cloud = (rng.rand(1, 3, NARROW["NUM_INPUT"]) * [[[0.6], [0.4], [0.3]]]
             ).astype(np.float32)
    variables = jnet.init(jax.random.key(0),
                          {"scene_points": jnp.asarray(cloud)}, train=False)
    variables = _perturb(jax.tree.map(np.asarray, dict(variables)), rng)
    tnet = t_build(t_cfg(_cfg_dict(dtype)))
    tnet.load_state_dict(state_dict_from_flax(variables))
    return jnet, variables, tnet, cloud


def _run_both(dtype):
    jnet, variables, tnet, cloud = _pair(dtype)
    want = jnet.apply(variables, {"scene_points": jnp.asarray(cloud)},
                      train=False)
    got = tnet({"scene_points": torch.from_numpy(cloud)})
    return ({k: np.asarray(v) for k, v in want.items()},
            {k: v.numpy() for k, v in got.items()})


def test_pn2_cls_f32_matches_jax(kernel_routed_three_nn):
    want, got = _run_both("float32")
    for key in ("score", "frame_R", "frame_t", "movable_logits"):
        assert got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key], want[key], atol=1e-4,
                                   err_msg=key)


def test_pn2_cls_bf16_matches_jax(kernel_routed_three_nn):
    # bf16 tolerances of the JAX package's own bf16 comparison
    # (tests/test_sa_fused.py).
    want, got = _run_both("bfloat16")
    for key in ("score", "frame_R", "frame_t", "movable_logits"):
        np.testing.assert_allclose(got[key], want[key], atol=5e-2,
                                   err_msg=key)
        assert float(np.abs(got[key] - want[key]).mean()) < 5e-3, key


def test_state_dict_round_trips_through_jax_importer():
    _, variables, tnet, _ = _pair("float32")
    back = import_pn2_torch_state_dict(
        {k: v.numpy() for k, v in tnet.state_dict().items()})
    flat_want = jax.tree_util.tree_flatten_with_path(variables)[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_want) == len(flat_back)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(flat_back[path], leaf)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shared_mlp_matches_jax(dtype):
    from s4g_tpu.models.nn_layers import SharedMLP as JSharedMLP

    rng = np.random.RandomState(3)
    x = rng.randn(2, 50, 8, 5).astype(np.float32)
    jmlp = JSharedMLP((16, 12), dtype=jnp.dtype(dtype))
    variables = jmlp.init(jax.random.key(1), jnp.asarray(x))
    variables = _perturb(jax.tree.map(np.asarray, dict(variables)), rng)
    want = jmlp.apply(variables, jnp.asarray(x), max_pool_k=8)
    tmlp = SharedMLP(5, (16, 12), ndim=2, dtype=getattr(torch, dtype))
    sd = {}
    for j in range(2):
        p = variables["params"][f"layer{j}"]
        s = variables["batch_stats"][f"layer{j}"]["bn"]
        sd[f"{j}.conv.weight"] = torch.from_numpy(
            p["conv"]["kernel"].T.copy())[..., None, None]
        sd[f"{j}.bn.weight"] = torch.from_numpy(p["bn"]["scale"])
        sd[f"{j}.bn.bias"] = torch.from_numpy(p["bn"]["bias"])
        sd[f"{j}.bn.running_mean"] = torch.from_numpy(s["mean"])
        sd[f"{j}.bn.running_var"] = torch.from_numpy(s["var"])
        sd[f"{j}.bn.num_batches_tracked"] = torch.tensor(0)
    tmlp.load_state_dict(sd)
    got = tmlp(torch.from_numpy(x), max_pool_k=8)
    atol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol)
