"""The port's fused SA stage 1 (s4g_tpu_torch/ops/sa_fused.py, K3's plain
twin, and the batch >= 2 route of the model) against the JAX package on the
CPU: the TPU kernel in interpret mode, its window setup, the BatchNorm
folding, the overflow branch, and PN2_CLS at batch 2 on the fused route.

The JAX side is pinned to the fused route with
`nn_layers.ENV_SA1_FUSE = "interpret"`, as tests/test_sa_fused.py does.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

import s4g_tpu.ops as jops
import s4g_tpu.ops.pallas.neighbor_kernels as jnk
from s4g_tpu.configs.config import load_cfg_from_dict as j_cfg
from s4g_tpu.models import build_model as j_build
from s4g_tpu.models import nn_layers as jnn
from s4g_tpu.ops.pallas.sa_fused_kernels import (sa1_fused_slab_pallas,
                                                 sa1_slab_setup as j_setup)

from s4g_tpu_torch.configs.config import load_cfg_from_dict as t_cfg
from s4g_tpu_torch.models import build_model as t_build
from s4g_tpu_torch.models.nn_layers import SharedMLP
from s4g_tpu_torch.ops import neighbors as nb
from s4g_tpu_torch.ops import sa_fused as sf
from s4g_tpu_torch.utils.weights import state_dict_from_flax

WIDTHS = (128, 128, 256)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _scene(seed, n, m, spread=0.5):
    """(1, 3, N) points sorted along x and (1, 3, M) centroids among them
    (the scene of tests/test_sa_fused.py)."""
    rng = np.random.RandomState(seed)
    pts = np.sort(rng.rand(1, n).astype(np.float32))[:, None, :] * spread
    pts = np.concatenate(
        [pts, rng.rand(1, 2, n).astype(np.float32) * spread], axis=1)
    cent = pts[:, :, np.sort(rng.choice(n, m, replace=False))]
    return pts, np.ascontiguousarray(cent)


def _affines(seed, c1=128, c2=128, c3=256):
    """Folded f32 affines w1, b1, w2, b2, w3, b3 (tests/test_sa_fused.py)."""
    rng = np.random.RandomState(seed)
    return [(rng.randn(*shape) * scale).astype(np.float32)
            for shape, scale in (((3, c1), 0.5), ((c1,), 0.1),
                                 ((c1, c2), 0.1), ((c2,), 0.1),
                                 ((c2, c3), 0.1), ((c3,), 0.1))]


def _perturb(tree, rng):
    """Non-trivial BatchNorm statistics and affines (init gives identities)."""
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


def _mlp_pair(seed, dtype):
    """A JAX SharedMLP's perturbed variables and the port's twin module."""
    jmlp = jnn.SharedMLP(WIDTHS, dtype=jnp.dtype(dtype))
    variables = jmlp.init(jax.random.key(seed), jnp.zeros((1, 4, 3)))
    variables = _perturb(jax.tree.map(np.asarray, dict(variables)),
                         np.random.RandomState(seed))
    tmlp = SharedMLP(3, WIDTHS, ndim=2, dtype=getattr(torch, dtype))
    sd = {}
    for j in range(len(WIDTHS)):
        p = variables["params"][f"layer{j}"]
        s = variables["batch_stats"][f"layer{j}"]["bn"]
        sd[f"{j}.conv.weight"] = _t(p["conv"]["kernel"].T)[..., None, None]
        sd[f"{j}.bn.weight"] = _t(p["bn"]["scale"])
        sd[f"{j}.bn.bias"] = _t(p["bn"]["bias"])
        sd[f"{j}.bn.running_mean"] = _t(s["mean"])
        sd[f"{j}.bn.running_var"] = _t(s["var"])
        sd[f"{j}.bn.num_batches_tracked"] = torch.tensor(0)
    tmlp.load_state_dict(sd)
    return jmlp, variables, tmlp.eval()


# -- the kernel's plain twin vs the TPU kernel (interpret mode) ---------------

@pytest.mark.parametrize("radius,k,shift", [
    (0.05, 16, 0.0),     # underfull balls: first-K ranks
    (0.22, 16, 0.0),     # overfull balls: stratified ranks
    (0.05, 16, 10.0),    # centroids far off the cloud: every ball empty
])
def test_sa1_fused_plain_matches_jax_kernel(radius, k, shift):
    pts, cent = _scene(0, 4096, 512)
    cent = cent + np.float32(shift)
    w1, b1, w2, b2, w3, b3 = _affines(1)
    lo_j, overflow_j = j_setup(jnp.asarray(pts[:, 0]),
                               jnp.asarray(cent[:, 0]), radius, 4096)
    want = np.asarray(sa1_fused_slab_pallas(
        jnp.asarray(pts), jnp.asarray(cent), lo_j, radius, k,
        jnp.asarray(w1), jnp.asarray(b1), (jnp.asarray(w2), jnp.asarray(w3)),
        (jnp.asarray(b2), jnp.asarray(b3)), interpret=True, stratified=True))
    lo_t, overflow_t = sf.sa1_slab_setup(_t(pts[:, 0]), _t(cent[:, 0]),
                                         radius, 4096)
    np.testing.assert_array_equal(lo_t.numpy(), np.asarray(lo_j))
    assert bool(overflow_t) == bool(overflow_j) is False
    got = sf.sa1_fused_slab(_t(pts), _t(cent), lo_t, radius, k, _t(w1),
                            _t(b1), (_t(w2), _t(w3)), (_t(b2), _t(b3)))
    assert got.shape == want.shape == (1, 512, 256)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=0)
    if shift:
        assert not np.any(want) and not torch.any(got)   # exact zeros
    else:
        assert float(np.abs(want).max()) > 0.1


def _boundary_scene(radius):
    """Sorted keys whose key 2047 is exactly the first centroid's key minus
    f32(radius): the slab ball query widens by sqrt(f32(r*r)), which is
    below f32(r) for this radius, and so starts the first window one key
    tile later than the fused stage does.  Keys near 0 keep the one-ulp
    difference of the two radii visible after the subtraction."""
    n = 12288
    r = np.float32(radius)
    rng = np.random.RandomState(5)
    keys = np.sort(rng.rand(n)) * 0.6
    keys = (keys - keys[2047] + 3e-4).astype(np.float32)
    first = np.float32(keys[2047] + r)
    keys[2047] = first - r                       # exact (Sterbenz)
    cidx = int(np.searchsorted(keys, first))
    keys[cidx] = first                           # the first centroid
    pts = np.stack([keys, rng.rand(n).astype(np.float32),
                    rng.rand(n).astype(np.float32)])[None]
    others = rng.choice(np.arange(cidx + 1, cidx + 3001), 1023, False)
    cent = pts[:, :, np.sort(np.concatenate([[cidx], others]))]
    return pts, np.ascontiguousarray(cent)


def _sqrt_radius_below(start):
    """The first radius (a Python float, as in a config) from `start` up in
    steps of 1e-7 where sqrt(f32(r*r)) < f32(r)."""
    for i in range(10000):
        r = start + i * 1e-7
        if np.sqrt(np.float32(r * r)) < np.float32(r):
            return r
    raise AssertionError("no such radius")


@pytest.mark.parametrize("case", ["random", "boundary", "overflow"])
def test_sa1_slab_setup_matches_jax(case):
    if case == "boundary":
        radius = _sqrt_radius_below(0.02)
        pts, cent = _boundary_scene(radius)
    else:
        radius = 0.02 if case == "random" else 0.2
        pts, cent = _scene(3, 12288, 1536, spread=0.3)
    n = pts.shape[2]
    lo_j, overflow_j = j_setup(jnp.asarray(pts[:, 0]),
                               jnp.asarray(cent[:, 0]), radius, n)
    lo_t, overflow_t = sf.sa1_slab_setup(_t(pts[:, 0]), _t(cent[:, 0]),
                                         radius, n)
    assert lo_t.dtype == torch.int32
    np.testing.assert_array_equal(lo_t.numpy(), np.asarray(lo_j))
    assert bool(overflow_t) == bool(overflow_j) == (case == "overflow")
    if case == "boundary":
        # The trap: K2's windows (radius sqrt(f32(r^2))) start elsewhere.
        lo_k2, _ = nb.slab_windows(_t(pts[:, 0]), _t(cent[:, 0]),
                                   radius * radius, n)
        assert int(lo_t[0, 0]) == 0 and int(lo_k2[0, 0]) == 1


# -- BatchNorm folding, the overflow branch ----------------------------------

class _Folded(jnn.SharedMLP):
    """The JAX SharedMLP's `_folded_params`, callable through apply."""

    @fnn.compact
    def __call__(self):
        layers = [jnn.PointConv(f, dtype=self.dtype, name=f"layer{i}")
                  for i, f in enumerate(self.mlp_channels)]
        return self._folded_params(layers, 3)


def test_folded_params_match_jax():
    _, variables, tmlp = _mlp_pair(4, "bfloat16")
    want = _Folded(WIDTHS, dtype=jnp.bfloat16).apply(variables)
    got = tmlp.folded_params()
    assert len(got) == len(want) == 3
    # XLA's and torch's rsqrt are each within 1 ulp of the exact value but
    # not the same function (up to 2 ulp apart); the products with the
    # scale and the weight round twice more.  The bias, bias - mean * inv,
    # cancels: hold it to the ulps of its operands.
    for j, ((gw, gb), (ww, wb)) in enumerate(zip(got, want)):
        assert gw.dtype == gb.dtype == torch.float32 and gw.is_contiguous()
        np.testing.assert_array_max_ulp(gw.detach().numpy(), np.asarray(ww),
                                        maxulp=4)
        bn = tmlp[j].bn
        mean_inv = (bn.running_mean * bn.weight
                    / torch.sqrt(bn.running_var + 1e-5)).detach().numpy()
        ulps = np.spacing(np.abs(bn.bias.detach().numpy()) + np.abs(mean_inv))
        np.testing.assert_array_less(
            np.abs(gb.detach().numpy() - np.asarray(wb)), 4 * ulps)


def test_overflow_branch_matches_jax_full_scan(monkeypatch):
    """A cloud whose dense middle overflows the key windows: both sides
    take the full-scan branch with the folded weights and bf16 rounding."""
    rng = np.random.RandomState(6)
    n, m, radius, k = 12288, 512, 0.05, 16
    x = np.concatenate([rng.rand(2288) * 0.5,
                        0.25 + 0.01 * rng.rand(10000)]).astype(np.float32)
    pts = np.stack([np.sort(x), rng.rand(n) * 0.05, rng.rand(n) * 0.05]
                   ).astype(np.float32)[None]
    cent = np.ascontiguousarray(pts[:, :, np.sort(rng.choice(n, m, False))])
    jmlp, variables, tmlp = _mlp_pair(7, "bfloat16")
    want = jmlp.apply(variables, None, sa_fuse=dict(
        points=jnp.asarray(pts), centroids=jnp.asarray(cent),
        pkeys=jnp.asarray(pts[:, 0]), ckeys=jnp.asarray(cent[:, 0]),
        radius=radius, k=k, stratified=True, interpret=True))
    axis = torch.zeros(1, dtype=torch.long)
    operands = tmlp.packed_operands(sf.pack_sa1_weights)
    before = sf.SA1_FALLBACKS["overflow"]
    grouped = sf.ball_query_grouped     # the full scan without the promise
    monkeypatch.setattr(sf, "ball_query_grouped",
                        lambda *a, sorted_axis=None, **kw: grouped(*a, **kw))
    with torch.no_grad():
        got = sf.sa1_stage(_t(pts), _t(cent), axis, radius, k, operands,
                           torch.bfloat16)
    monkeypatch.undo()
    assert sf.SA1_FALLBACKS["overflow"] == before + 1
    # Handed the sort axis, the fallback's full scan gives the same bits
    # (it stays off the slab route).
    slab_before = nb.SLAB_FALLBACKS["overflow"]
    with torch.no_grad():
        promised = sf.sa1_stage(_t(pts), _t(cent), axis, radius, k,
                                operands, torch.bfloat16)
    assert sf.SA1_FALLBACKS["overflow"] == before + 2
    assert nb.SLAB_FALLBACKS["overflow"] == slab_before
    assert torch.equal(promised, got)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    # bf16 outputs; f32 sums in another order may flip an odd bf16
    # rounding of a hidden activation.
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)
    assert float(np.abs(got - want).mean()) < 2e-3
    assert float(np.abs(want).max()) > 0.1


# -- PN2_CLS at batch 2 on the fused route -----------------------------------

PN2_BATCH = {
    "NUM_INPUT": 4096,
    "NUM_CENTROIDS": (512, 256, 128),
    "RADIUS": (0.02, 0.08, 0.32),
    "NUM_NEIGHBOURS": (32, 32, 32),
    "SA_CHANNELS": (WIDTHS, (32, 32, 32), (32, 32, 32)),
    "FP_CHANNELS": ((32, 32), (32, 32), (32, 32, 16)),
    "NUM_FP_NEIGHBOURS": (3, 3, 3),
    "SEG_CHANNELS": (32, 16),
    "SORT_POINTS": True,
    "FPS_SHARDS": 128,
}


@pytest.fixture
def jax_fused_route(monkeypatch):
    """The JAX model on its TPU routes: SA1 fused (interpret mode) and 3-NN
    as in tests/test_torch_port_model.py (the Pallas kernel for big stages,
    matmul-form XLA for small ones)."""
    monkeypatch.setattr(jnn, "ENV_SA1_FUSE", "interpret")
    orig_pallas = jnk.three_nn_pallas
    monkeypatch.setattr(jnk, "three_nn_pallas",
                        lambda q, k, interpret=False: orig_pallas(q, k, True))
    orig = jops.three_nn

    def routed(q, k, num_neighbors=3, chunk=2048, impl="auto"):
        big = q.shape[2] * k.shape[2] >= (1 << 22)
        return orig(q, k, num_neighbors, chunk,
                    impl="pallas" if big else "xla")

    monkeypatch.setattr(jops, "three_nn", routed)


def test_pn2_cls_batch2_fused_matches_jax(jax_fused_route, monkeypatch):
    cfg = {"MODEL": {"TYPE": "PN2_CLS", "COMPUTE_DTYPE": "bfloat16",
                     "PN2": dict(PN2_BATCH)}, "DATA": {"SCORE_CLASSES": 3}}
    jnet, _, _ = j_build(j_cfg(cfg))
    rng = np.random.RandomState(0)
    # Two scenes, each widest along another axis (per-scene sort axes).
    cloud = (rng.rand(2, 3, PN2_BATCH["NUM_INPUT"])
             * np.array([[[0.6], [0.4], [0.3]], [[0.3], [0.5], [0.4]]])
             ).astype(np.float32)
    variables = jnet.init(jax.random.key(0),
                          {"scene_points": jnp.asarray(cloud)}, train=False)
    variables = _perturb(jax.tree.map(np.asarray, dict(variables)), rng)
    want = jnet.apply(variables, {"scene_points": jnp.asarray(cloud)},
                      train=False)

    tnet = t_build(t_cfg(cfg))
    tnet.load_state_dict(state_dict_from_flax(variables))
    calls = []
    fused = sf.sa1_fused_slab
    monkeypatch.setattr(sf, "sa1_fused_slab",
                        lambda *a, **kw: calls.append(1) or fused(*a, **kw))
    before = sf.SA1_FALLBACKS["overflow"]
    got = tnet({"scene_points": _t(cloud)})
    assert len(calls) == 1 and sf.SA1_FALLBACKS["overflow"] == before
    # bf16 tolerances of test_pn2_cls_bf16_matches_jax.
    for key in ("score", "frame_R", "frame_t", "movable_logits"):
        g, w = got[key].numpy(), np.asarray(want[key])
        assert g.shape == w.shape and g.shape[0] == 2
        np.testing.assert_allclose(g, w, atol=5e-2, err_msg=key)
        assert float(np.abs(g - w).mean()) < 5e-3, key


def test_batch1_keeps_the_unfused_route(monkeypatch):
    mlp_cfg = {"MODEL": {"TYPE": "PN2_CLS", "COMPUTE_DTYPE": "float32",
                         "PN2": dict(PN2_BATCH, NUM_INPUT=1024)},
               "DATA": {"SCORE_CLASSES": 3}}
    tnet = t_build(t_cfg(mlp_cfg))
    monkeypatch.setattr(sf, "sa1_fused_slab",
                        lambda *a, **kw: pytest.fail("fused at batch 1"))
    cloud = torch.rand(1, 3, 1024)
    out = tnet({"scene_points": cloud})
    assert out["score"].shape == (1, 3, 1024)
    sa1 = tnet.sa_modules[0]
    assert sa1._fuses(2, torch.zeros(2)) and not sa1._fuses(1, torch.zeros(1))
    assert not sa1._fuses(2, None)
    assert not tnet.sa_modules[1]._fuses(2, torch.zeros(2))   # widths 32


# -- K3's packed operands and slot padding ------------------------------------

def _unpack(flat, k, n):
    """Inverse of `sa_fused.pack_b_operand`: (K, N) values as f32."""
    return flat[sf._b_operand_positions(k, n, flat.device)].float()


@pytest.mark.parametrize("c3", [128, 256])
def test_packed_weights_unpack_to_bf16(c3):
    """The wrapper's packed buffers hold exactly the bf16-rounded weights:
    W2 and W3 in the kernel's B-operand layout, W1 and the biases in f32."""
    w1, b1, w2, b2, w3, b3 = (_t(a) for a in _affines(8, c3=c3))
    wpack, fpack = sf.pack_sa1_weights([(w1, b1), (w2, b2), (w3, b3)])
    assert wpack.dtype == torch.bfloat16 and wpack.numel() == 128 * (128 + c3)
    assert torch.equal(_unpack(wpack[:128 * 128], 128, 128),
                       sf._bf16(w2))
    assert torch.equal(_unpack(wpack[128 * 128:], 128, c3),
                       sf._bf16(w3))
    assert fpack.dtype == torch.float32 and fpack.numel() == 3 * 128 + 256 + c3
    assert torch.equal(fpack[:384].reshape(3, 128), sf._bf16(w1))
    assert torch.equal(fpack[384:], torch.cat([b1, b2, b3]))
    # The layout: element (k, n) of W2 sits in row n of K atom k // 64, its
    # 16-byte chunk swizzled by n % 8.
    k, n = 90, 13                      # atom 1, column 26 of it: chunk 3
    pos = 128 * 64 + n * 64 + (3 ^ (n % 8)) * 8 + 26 % 8
    assert wpack[pos] == w2[k, n].to(torch.bfloat16)
    # Every position is written exactly once.
    pos_all = sf._b_operand_positions(128, c3, torch.device("cpu"))
    assert torch.equal(torch.sort(pos_all.reshape(-1))[0],
                       torch.arange(128 * c3))


@pytest.mark.parametrize("radius,k", [(0.05, 16), (0.22, 24), (0.05, 40)])
def test_slot_padding_leaves_plain_twin_unchanged(radius, k):
    """Padding each centroid's K slots to a power of two >= 16 by repeating
    slot 0, as K3 does, gives the plain twin's output bit for bit."""
    pts, cent = _scene(2, 4096, 512)
    lo, _ = sf.sa1_slab_setup(_t(pts[:, 0]), _t(cent[:, 0]), radius, 4096)
    w1, b1, w2, b2, w3, b3 = (_t(a) for a in _affines(9))
    args = (_t(pts), _t(cent), lo, radius, k, w1, b1, (w2, w3), (b2, b3))
    kpad = max(16, 1 << (k - 1).bit_length())
    want = sf._sa1_fused_plain(*args)
    got = sf._sa1_fused_plain(*args, kpad=kpad)
    assert (kpad > k) == (k != 16)
    assert torch.equal(got, want)
    assert float(want.abs().max()) > 0.1
