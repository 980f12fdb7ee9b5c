"""The port's gathers with a fixed-order backward (s4g_tpu_torch.ops.gather.
gather_rows, K8's plain twin on the CPU) against the JAX package's gathers,
whose backward is XLA's scatter-add: the same seeded numpy inputs, with
heavy index collisions (a lone point repeated K times in a group, 3-NN onto
a few keys), through `jax.vjp` and through torch's autograd.

The forward is torch.gather's, bit for bit, and so are the gradients:
both sides add one destination's terms in ascending source position, and
the 3-NN interpolation differentiates one gather per neighbour on both
sides, whose three sums autograd and JAX's transpose add alike.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s4g_tpu.ops import gather as jg
from s4g_tpu.ops import interpolate as ji

from s4g_tpu_torch import _build
from s4g_tpu_torch.models.pn2_modules import (gather_cl, group_cl,
                                              interpolate_cl)
from s4g_tpu_torch.ops import gather as tg
from s4g_tpu_torch.ops import interpolate as ti

B, N, C = 2, 50, 7


def _heavy_index(rng, m, n=N):
    """(B, m) indices, 70 % of them on three rows."""
    idx = rng.randint(0, n, (B, m))
    return np.where(rng.rand(B, m) < 0.7, rng.randint(0, 3, (B, m)),
                    idx).astype(np.int32)


def _lone_groups(rng, m, k, n=N):
    """(B, m, k) neighbour indices; every other group a lone point
    repeated k times (ball-query padding)."""
    idx = rng.randint(0, n, (B, m, k))
    idx[:, ::2, :] = idx[:, ::2, :1]
    return idx.astype(np.int32)


def _three_nn_onto_few(rng, n1, n2):
    """(B, n1, 3) distinct neighbours among n2 keys, normalized weights."""
    idx = np.stack([rng.permutation(n2)[:3] for _ in range(B * n1)])
    w = rng.rand(B, n1, 3).astype(np.float32) + 0.1
    return (idx.reshape(B, n1, 3).astype(np.int32),
            (w / w.sum(-1, keepdims=True)).astype(np.float32))


def _port_grad(fn, x, *args, g):
    xt = torch.from_numpy(x).requires_grad_()
    fn(xt, *map(torch.from_numpy, args)).backward(torch.from_numpy(g))
    return xt.grad.numpy()


def _jax_grad(fn, x, g):
    _, vjp = jax.vjp(fn, jnp.asarray(x))
    return np.asarray(vjp(jnp.asarray(g))[0])


def test_gather_rows_grad_equals_jax_take_along_axis():
    rng = np.random.RandomState(0)
    x = rng.randn(B, N, C).astype(np.float32)
    idx = _heavy_index(rng, 400)
    g = rng.randn(B, 400, C).astype(np.float32)
    want = _jax_grad(lambda p: jnp.take_along_axis(
        p, jnp.asarray(idx)[..., None], axis=1), x, g)
    np.testing.assert_array_equal(_port_grad(gather_cl, x, idx, g=g), want)


def test_gather_points_grad_equals_jax():
    """Channels-first: `ops.gather.gather_points` against the JAX op."""
    rng = np.random.RandomState(1)
    x = rng.randn(B, C, N).astype(np.float32)
    idx = _heavy_index(rng, 300)
    g = rng.randn(B, C, 300).astype(np.float32)
    want = _jax_grad(lambda p: jg.gather_points(p, jnp.asarray(idx)), x, g)
    np.testing.assert_array_equal(
        _port_grad(tg.gather_points, x, idx, g=g), want)


@pytest.mark.parametrize("k", [1, 16])
def test_group_grad_equals_jax_group_points(k):
    """group_cl (channels-last) and ops.group_points / gather_knn
    (channels-first) against JAX's group_points, a lone point repeated K
    times in every other group."""
    rng = np.random.RandomState(k)
    m = 30
    x = rng.randn(B, N, C).astype(np.float32)
    idx = _lone_groups(rng, m, k)
    g = rng.randn(B, m, k, C).astype(np.float32)
    xc = np.ascontiguousarray(x.transpose(0, 2, 1))
    gc = np.ascontiguousarray(g.transpose(0, 3, 1, 2))
    want = _jax_grad(lambda p: jg.group_points(p, jnp.asarray(idx)), xc, gc)
    np.testing.assert_array_equal(
        _port_grad(group_cl, x, idx, g=g).transpose(0, 2, 1), want)
    np.testing.assert_array_equal(
        _port_grad(tg.group_points, xc, idx, g=gc), want)
    np.testing.assert_array_equal(
        _port_grad(tg.gather_knn, xc, idx, g=gc), want)


def test_interpolate_grad_matches_jax_feature_interpolate():
    """interpolate_cl and ops.feature_interpolate against JAX's
    feature_interpolate, 3-NN of 300 queries onto 5 keys: the forward and
    the gradient bit for bit."""
    rng = np.random.RandomState(3)
    n1, n2 = 300, 5
    f = rng.randn(B, n2, C).astype(np.float32)
    idx, w = _three_nn_onto_few(rng, n1, n2)
    g = rng.randn(B, n1, C).astype(np.float32)
    fc = np.ascontiguousarray(f.transpose(0, 2, 1))
    gc = np.ascontiguousarray(g.transpose(0, 2, 1))

    def jfn(p):
        return ji.feature_interpolate(p, jnp.asarray(idx), jnp.asarray(w))

    want_out = np.asarray(jfn(jnp.asarray(fc)))
    want = _jax_grad(jfn, fc, gc)
    with torch.no_grad():
        out = interpolate_cl(torch.from_numpy(f), torch.from_numpy(idx),
                             torch.from_numpy(w))
    np.testing.assert_array_equal(out.numpy().transpose(0, 2, 1), want_out)
    got = _port_grad(interpolate_cl, f, idx, w, g=g).transpose(0, 2, 1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        _port_grad(ti.feature_interpolate, fc, idx, w, g=gc), want)


@pytest.mark.parametrize("dim", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("grad", [False, True])
def test_forward_is_torch_gather_bit_for_bit(dim, dtype, grad):
    """gather_rows' forward is torch.gather's, with a gradient or without
    (then no autograd node of its own)."""
    rng = np.random.RandomState(4)
    shape = (B, N, C) if dim == 1 else (B, C, N)
    x = torch.from_numpy(rng.randn(*shape)).to(dtype).requires_grad_(grad)
    idx = torch.from_numpy(_heavy_index(rng, 200))
    full = (idx.long()[..., None].expand(-1, -1, C) if dim == 1
            else idx.long()[:, None, :].expand(-1, C, -1))
    got = tg.gather_rows(x, idx, dim=dim)
    assert torch.equal(got, torch.gather(x, dim, full))
    assert (got.grad_fn is not None) == grad
    if grad:
        assert "GatherRows" in type(got.grad_fn).__name__


def test_group_and_interpolate_forward_unchanged():
    """group_cl and interpolate_cl give the bits of the per-gather torch
    formulation they replace (a gather per neighbour for the 3-NN,
    ((t0 + t1) + t2))."""
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(B, N, C).astype(np.float32))
    gidx = torch.from_numpy(_lone_groups(rng, 20, 8))
    want = torch.gather(x, 1, gidx.reshape(B, 160).long()[..., None]
                        .expand(-1, -1, C)).reshape(B, 20, 8, C)
    assert torch.equal(group_cl(x, gidx), want)
    idx, w = map(torch.from_numpy, _three_nn_onto_few(rng, 64, N))
    terms = [torch.gather(x, 1, idx[:, :, j].long()[..., None]
                          .expand(-1, -1, C)) * w[:, :, j:j + 1]
             for j in range(3)]
    assert torch.equal(interpolate_cl(x, idx, w),
                       (terms[0] + terms[1]) + terms[2])


@pytest.mark.parametrize("fn,make", [
    (lambda x, i: tg.gather_rows(x, i), lambda r: _heavy_index(r, 60, 9)),
    (lambda x, i: tg.gather_rows(x.transpose(1, 2), i, dim=2),
     lambda r: _heavy_index(r, 60, 9)),
    (group_cl, lambda r: _lone_groups(r, 6, 5, 9)),
])
def test_gradcheck_float64(fn, make):
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(B, 9, 4)).requires_grad_()
    idx = torch.from_numpy(make(rng))
    assert torch.autograd.gradcheck(lambda t: fn(t, idx), (x,))


def test_gradcheck_interpolate_float64():
    rng = np.random.RandomState(7)
    f = torch.from_numpy(rng.randn(B, 6, 4)).requires_grad_()
    idx, w = _three_nn_onto_few(rng, 40, 6)
    w = torch.from_numpy(w.astype(np.float64))
    assert torch.autograd.gradcheck(
        lambda t: interpolate_cl(t, torch.from_numpy(idx), w), (f,))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_twin_sums_in_ascending_order_and_rounds_once(dtype):
    """K8's twin against a loop over the sources one at a time: each row
    adds its terms in ascending source position, in f32 (f64 for f64), and
    rounds once to the dtype; a row without a source is 0."""
    rng = np.random.RandomState(8)
    n, m, c = 40, 500, 5
    idx = _heavy_index(rng, m, n)
    idx[idx == 7] = 3                            # row 7 has no source
    grad = torch.from_numpy(rng.randn(B, m, c)).to(dtype)
    acc_np = np.float64 if dtype == torch.float64 else np.float32
    src = grad.to(torch.float64 if dtype == torch.float64
                  else torch.float32).numpy()
    want = np.zeros((B, n, c), acc_np)
    for b in range(B):
        for p in range(m):
            want[b, idx[b, p]] = (want[b, idx[b, p]] + src[b, p]).astype(
                acc_np)
    got = tg.gather_backward(grad, torch.from_numpy(idx), n)
    assert got.dtype == dtype
    assert torch.equal(got, torch.from_numpy(want).to(dtype))
    assert not got[:, 7].any()


def test_row_lists_are_stable_and_exact():
    idx = torch.tensor([[2, 0, 2, 2], [1, 1, 0, 3]], dtype=torch.int32)
    order, offsets = tg.row_lists(idx, 4)
    assert order.tolist() == [1, 0, 2, 3, 6, 4, 5, 7]
    assert offsets.tolist() == [0, 1, 1, 4, 4, 5, 7, 7, 8]


def test_cpu_tensors_never_launch(monkeypatch):
    """On CPU tensors the wrapper takes the twin and launches nothing."""
    def refuse(*args):
        raise AssertionError("launched on the CPU")
    monkeypatch.setattr(_build, "launch", refuse)
    rng = np.random.RandomState(9)
    x = torch.from_numpy(rng.randn(B, N, C).astype(np.float32))
    x.requires_grad_()
    group_cl(x, torch.from_numpy(_lone_groups(rng, 10, 4))).sum().backward()
    assert x.grad is not None
    with pytest.raises(TypeError):
        tg.gather_backward(torch.zeros(1, 2, 3, dtype=torch.int32),
                           torch.zeros(1, 2, dtype=torch.int32), 4)


def test_train_repeat_tool_on_the_cpu(tmp_path, capsys):
    """tools/train_repeat at a tiny config on the CPU: the two runs of a
    step from one state equal bit for bit, the result printed."""
    import json
    import yaml
    from s4g_tpu_torch.tools import train_repeat
    from test_torch_port_tools import TINY
    from test_torch_port_train import write_scenes
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(yaml.safe_dump(TINY))
    write_scenes(str(tmp_path / "data"), 2, n=3000, num_frames=100)
    out = train_repeat.main([
        "--data-dir", str(tmp_path / "data"), "--cfg", str(cfg),
        "--batch", "2", "--steps", "2", "--num-frame-points", "64",
        "--output", str(tmp_path / "out"), "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == json.loads(json.dumps(out))
    assert [r["batch"] for r in out["runs"]] == [2]
    for run in out["runs"]:
        assert all(v["bit_equal"] for v in run["spread"].values())
        assert len(run["steps_ms"]) == 2
