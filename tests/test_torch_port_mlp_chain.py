"""The port's fused-chain configuration (K7's plain twin in
s4g_tpu_torch/ops/mlp_chain.py, `SharedMLP.fused_eval` and the route rule
`fuses_chain`) against the JAX package on the CPU: `mlp_chain_pallas` in
interpret mode, the JAX SharedMLP with `ENV_MLP_IMPL = "pallas_interpret"`,
a narrow PN2_CLS forward at b = 1 and b = 2 and a narrow detector `eval`,
each with the route forced on both sides.

Inputs and weights are made with numpy from a seed.  Tolerances: f32
compute within 1e-5 of the output's scale (f32 sums in another order);
bf16 compute at the fused-SA1 tests' tolerances (an f32 sum in another
order flips an odd bf16 rounding of a hidden activation).
"""

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from s4g_tpu.models import nn_layers as jnn
from s4g_tpu.ops.pallas.mlp_kernels import mlp_chain_pallas
from s4g_tpu.pipeline.detector import GraspDetector as JaxDetector
from s4g_tpu.pipeline import postprocessing as jpost
from s4g_tpu.pipeline import preprocessing as jpre

from s4g_tpu_torch.models import nn_layers as tnn
from s4g_tpu_torch.ops import mlp_chain as mc
from s4g_tpu_torch.ops import sa_fused as sf
from s4g_tpu_torch.pipeline import detector as tdet
from s4g_tpu_torch.utils.weights import _shared_mlp, state_dict_from_flax

from test_torch_port_detector import TINY, clutter_cloud
from test_torch_port_model import (NARROW, _perturb,  # noqa: F401
                                   kernel_routed_three_nn)
from test_torch_port_parity import _assert_close, _model_pair, _spy
from test_torch_port_sa_fused import (PN2_BATCH,  # noqa: F401
                                      jax_fused_route)

DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float32": (torch.float32, jnp.float32)}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _assert_chain_close(got, want, dtype):
    """f32 compute: within 1e-5 of the output's scale.  bf16 compute: the
    fused-SA1 twin's tolerance (tests/test_torch_port_sa_fused.py), 2e-4 of
    the output's scale."""
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    atol = (1e-5 if dtype == "float32" else 2e-4) * scale
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


# -- K7's plain twin vs the TPU kernel (interpret mode) -----------------------

# The cases of tests/test_pallas_kernels.py::test_mlp_chain_pallas_interpret
# (the last layer's ReLU off), and a 4-layer chain.
CHAINS = [(1024, (3, 16, 32), 64), (700, (5, 8), None), (512, (515, 64), 8),
          (640, (20, 48, 40, 32, 24), 16)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("p,widths,pool", CHAINS)
def test_mlp_chain_plain_matches_pallas_interpret(p, widths, pool, dtype):
    rng = np.random.RandomState(p)
    x = rng.randn(p, widths[0]).astype(np.float32)
    params = [((rng.randn(widths[i], widths[i + 1]) * 0.1).astype(np.float32),
               (rng.randn(widths[i + 1]) * 0.1).astype(np.float32))
              for i in range(len(widths) - 1)]
    relu = tuple([True] * (len(params) - 1) + [False])
    tdt, jdt = DTYPES[dtype]
    want = mlp_chain_pallas(
        jnp.asarray(x), tuple((jnp.asarray(w), jnp.asarray(b))
                              for w, b in params),
        relu, pool, jdt, True)
    got = mc.mlp_chain(_t(x), [(_t(w), _t(b)) for w, b in params], relu,
                       pool, tdt)
    assert got.dtype == torch.float32
    assert got.shape == (p // (pool or 1), widths[-1])
    _assert_chain_close(got.numpy(), want, dtype)
    assert float(np.abs(np.asarray(want)).max()) > 0.1


def test_mlp_chain_checks_its_operands():
    w = [(torch.zeros(4, 8), torch.zeros(8))]
    with pytest.raises(ValueError, match="relu"):
        mc.mlp_chain(torch.zeros(16, 4), w, (True, True))
    with pytest.raises(ValueError, match="groups of 5"):
        mc.mlp_chain(torch.zeros(16, 4), w, (True,), pool_k=5)
    with pytest.raises(ValueError, match="chain"):
        mc.mlp_chain(torch.zeros(16, 3), w, (True,))
    with pytest.raises(TypeError, match="compute dtype"):
        mc.mlp_chain(torch.zeros(16, 4), w, (True,),
                     compute_dtype=torch.float16)


def _same_operands(got, want):
    """The same nesting of tuples and lists, equal tensors and values."""
    if isinstance(got, torch.Tensor):
        assert torch.equal(got, want)
    elif isinstance(got, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _same_operands(g, w)
    else:
        assert got == want


@pytest.mark.parametrize("kernel,dtype", [("K7", "bfloat16"),
                                          ("K7", "float32"),
                                          ("K3", "bfloat16")])
def test_packed_operands_are_kept_until_the_weights_change(kernel, dtype):
    """`SharedMLP.packed_operands` folds and packs once per weights and
    kernel (K7's `_pack`, K3's `pack_sa1_weights`): an unchanged module is
    a hit, also after the other kernel's lookup; a BatchNorm running_var
    changed in place, a conv weight changed in place and a
    `load_state_dict` each re-fold, and the result equals a fresh
    `folded_params()` and pack; training mode keeps nothing."""
    cd = DTYPES[dtype][0]
    c_in, widths = (20, (48, 40)) if kernel == "K7" else (3, (128, 128, 256))
    pack, args = ((mc._pack, (c_in, cd)) if kernel == "K7"
                  else (sf.pack_sa1_weights, ()))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        mlp = tnn.SharedMLP(c_in, widths, ndim=2, dtype=cd).eval()
        other = tnn.SharedMLP(c_in, widths, ndim=2, dtype=cd)
    with torch.no_grad():
        for layer in other:
            layer.bn.running_var.uniform_(0.5, 2.0)
            layer.bn.running_mean.normal_()

    def fresh():
        params = mlp.folded_params()
        return params, pack(params, *args)

    def lookup():
        before = dict(tnn.PACK_CACHE)
        got = mlp.packed_operands(pack, *args)
        return got, {k: tnn.PACK_CACHE[k] - before[k] for k in before}

    first, counts = lookup()
    assert counts == {"hits": 0, "packs": 1}
    _same_operands(first, fresh())
    if kernel == "K3":                 # K7's entry beside K3's
        mlp.packed_operands(mc._pack, c_in, cd)
    again, counts = lookup()
    assert counts == {"hits": 1, "packs": 0}
    assert again[1] is first[1]
    for change in (lambda: mlp[1].bn.running_var.mul_(3.0),
                   lambda: mlp[0].conv.weight.add_(0.25),
                   lambda: mlp.load_state_dict(other.state_dict())):
        with torch.no_grad():
            change()
        got, counts = lookup()
        assert counts == {"hits": 0, "packs": 1}
        _same_operands(got, fresh())
        assert any(not torch.equal(a, b) for g, f in zip(got[0], first[0])
                   for a, b in zip(g, f))
        first = got
    mlp.train()
    for _ in range(2):
        _, counts = lookup()
        assert counts == {"hits": 0, "packs": 1}


# -- SharedMLP.fused_eval vs the JAX SharedMLP on its fused route -------------

def _mlp_pair(seed, c_in, widths, dtype, ndim):
    """A JAX SharedMLP's perturbed variables and the port's twin module,
    weights carried across by utils/weights.py."""
    jmlp = jnn.SharedMLP(widths, dtype=DTYPES[dtype][1])
    shape = (1, 4, c_in) if ndim == 1 else (1, 2, 4, c_in)
    variables = jmlp.init(jax.random.key(seed), jnp.zeros(shape))
    variables = _perturb(jax.tree.map(np.asarray, dict(variables)),
                         np.random.RandomState(seed))
    sd = {}
    _shared_mlp(variables["params"], variables["batch_stats"], "m", ndim, sd)
    tmlp = tnn.SharedMLP(c_in, widths, ndim=ndim, dtype=DTYPES[dtype][0])
    tmlp.load_state_dict({k[2:]: v for k, v in sd.items()})
    return jmlp, variables, tmlp.eval()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("pooled", [True, False])
def test_shared_mlp_fused_eval_matches_jax(monkeypatch, pooled, dtype):
    monkeypatch.setattr(jnn, "ENV_MLP_IMPL", "pallas_interpret")
    monkeypatch.setattr(tnn, "MLP_IMPL", "fused")
    rng = np.random.RandomState(9)
    if pooled:     # (B, M, K, C): an SA stage's grouped input, pooled over K
        x, widths, k = rng.randn(2, 48, 16, 19).astype(np.float32), \
            (32, 32, 64), 16
    else:          # (B, N, C): an FP stage's input
        x, widths, k = rng.randn(2, 300, 40).astype(np.float32), (48, 24), \
            None
    jmlp, variables, tmlp = _mlp_pair(3, x.shape[-1], widths, dtype,
                                      2 if pooled else 1)
    want = jmlp.apply(variables, jnp.asarray(x), max_pool_k=k)
    direct = tmlp.fused_eval(_t(x), k)
    calls = _spy(monkeypatch, tmlp, "fused_eval")
    routed = tmlp(_t(x), max_pool_k=k)
    assert len(calls) == 1 and torch.equal(routed, direct)
    assert direct.dtype == DTYPES[dtype][0] and want.dtype == DTYPES[dtype][1]
    lead = x.shape[:-2] if pooled else x.shape[:-1]
    assert direct.shape == (*lead, widths[-1])
    if dtype == "float32":
        _assert_chain_close(direct.detach().numpy(), want, dtype)
    else:
        # bf16 outputs: one bf16 ulp where a sum in another order rounds
        # the other way.
        got, want = direct.float().detach().numpy(), np.asarray(want,
                                                                np.float32)
        np.testing.assert_allclose(got, want, atol=2e-2, rtol=1e-2)
        assert float(np.abs(got - want).mean()) < 2e-3


# -- the route rule, transcribed from JAX's nn_layers.py:201-224 -------------

# (impl, min_rows, scope, shape, max_pool_k, on_cuda) -> fused?
ROUTE_CASES = [
    ("auto", 1 << 60, "all", (2, 8, 16, 3), 16, True, False),   # default: off
    ("auto", 1, "all", (2, 8, 16, 3), 16, True, True),
    ("auto", 1, "all", (2, 8, 16, 3), 16, False, False),   # never on the CPU
    ("auto", 1, "all", (2, 100, 32), None, True, True),
    ("auto", 1, "pooled", (2, 100, 32), None, True, False),
    ("auto", 1, "pooled", (2, 8, 16, 3), 16, True, True),
    ("auto", 257, "all", (2, 8, 16, 3), 16, True, False),  # 256 rows
    ("auto", 256, "all", (2, 8, 16, 3), 16, True, True),
    ("fused", 1 << 60, "pooled", (2, 100, 32), None, False, True),
    ("fused", 1 << 60, "all", (2, 8, 16, 3), 16, False, True),
    ("fused", 1, "all", (2, 8, 24, 3), 24, True, False),   # 24 ∤ 2048
    ("fused", 1, "all", (2, 8, 16, 3), 8, True, False),    # axis != pool
    ("unfused", 1, "all", (2, 8, 16, 3), 16, True, False),
]


@pytest.mark.parametrize("impl,min_rows,scope,shape,pool,on_cuda,fused",
                         ROUTE_CASES)
def test_fuses_chain_follows_the_jax_rule(impl, min_rows, scope, shape, pool,
                                          on_cuda, fused):
    assert tnn.fuses_chain(impl, min_rows, scope, shape, pool,
                           on_cuda) is fused


def test_fuses_chain_rejects_unknown_settings():
    with pytest.raises(ValueError, match="MLP_IMPL"):
        tnn.fuses_chain("pallas", 1, "all", (4, 3), None, True)
    with pytest.raises(ValueError, match="MLP_FUSE_SCOPE"):
        tnn.fuses_chain("fused", 1, "sa", (4, 3), None, True)


# The default route (`fused_route` under the module settings' defaults,
# `MLP_IMPL` as given): (impl, shape, max_pool_k, dtype, training, on_cuda)
# -> fused?
DEFAULT_ROUTE_CASES = [
    ("auto", (1, 5120, 64, 3), 64, torch.bfloat16, False, True, True),
    ("auto", (4, 25600, 256), None, torch.bfloat16, False, True, True),
    ("auto", (1, 8, 16, 3), 16, torch.bfloat16, False, True, True),  # 128 rows
    ("auto", (1, 5120, 64, 3), 64, torch.bfloat16, False, False, False),
    ("auto", (1, 5120, 64, 3), 64, torch.bfloat16, True, True, False),
    ("auto", (1, 5120, 64, 3), 64, torch.float32, False, True, False),
    ("auto", (1, 8, 24, 3), 24, torch.bfloat16, False, True,
     False),                                        # 24 ∤ 2048
    ("unfused", (1, 5120, 64, 3), 64, torch.bfloat16, False, True, False),
    ("unfused", (4, 25600, 256), None, torch.float32, False, False, False),
    ("fused", (1, 5120, 64, 3), 64, torch.float32, False, False, True),
    ("fused", (4, 25600, 256), None, torch.bfloat16, False, False, True),
    ("fused", (1, 5120, 64, 3), 64, torch.float32, True, True, False),
]


@pytest.mark.parametrize("impl,shape,pool,dtype,training,on_cuda,fused",
                         DEFAULT_ROUTE_CASES)
def test_default_route_fuses_bf16_eval_chains_on_cuda(
        monkeypatch, impl, shape, pool, dtype, training, on_cuda, fused):
    """With the default row floor and scope, "auto" fuses an eligible chain
    only on a CUDA tensor, in eval mode, at bf16; "unfused" never fuses,
    "fused" fuses every eligible eval-mode chain, f32 too and on any
    device; training mode never fuses (K7 has no backward)."""
    monkeypatch.setattr(tnn, "MLP_IMPL", impl)
    assert tnn.fused_route(shape, pool, dtype, training, on_cuda) is fused


@pytest.mark.parametrize("impl,training,counts", [
    ("auto", False, {"mlp.unfused": 1}),     # a CPU tensor: layer by layer
    ("fused", False, {"mlp.fused": 1}),
    ("fused", True, {}),                      # training mode: neither
])
def test_eval_chains_count_their_route(monkeypatch, tmp_path, impl,
                                       training, counts):
    """Each eval-mode chain adds one to `mlp.fused` or `mlp.unfused` on the
    innermost open span, while a profiler records."""
    from s4g_tpu_torch.utils import profiling
    monkeypatch.setattr(tnn, "MLP_IMPL", impl)
    mlp = tnn.SharedMLP(3, (16, 16), ndim=2).train(training)
    with profiling.trace(str(tmp_path)):
        with profiling.span("detect.model"):
            mlp(torch.rand(1, 4, 8, 3), max_pool_k=8)
    (span,) = profiling.spans()
    assert span.counts == counts


def test_default_route_stays_unfused_on_the_cpu(monkeypatch):
    """"auto" never fuses a CPU tensor, whatever the threshold; nor does a
    module in training mode."""
    monkeypatch.setattr(tnn, "MLP_FUSE_MIN_ROWS", 1)
    mlp = tnn.SharedMLP(3, (16, 16), ndim=2).eval()
    chains = _chain_spy(monkeypatch)
    x = torch.rand(1, 4, 8, 3)
    assert mlp(x, max_pool_k=8).shape == (1, 4, 16) and not chains
    monkeypatch.setattr(tnn, "MLP_IMPL", "fused")
    assert mlp(x, max_pool_k=8).shape == (1, 4, 16) and len(chains) == 1
    mlp.train()
    assert mlp(x, max_pool_k=8).shape == (1, 4, 16) and len(chains) == 1


# -- PN2_CLS and the detector on the fused-chain route ------------------------

def _chain_spy(monkeypatch):
    return _spy(monkeypatch, tnn, "mlp_chain")


def test_pn2_cls_fused_chain_matches_jax(kernel_routed_three_nn,
                                         monkeypatch):
    """b = 1, bf16, deployment routes: every chain (3 SA, 3 FP, 4 heads) is
    K7's twin; JAX runs its kernel in interpret mode."""
    monkeypatch.setattr(jnn, "ENV_MLP_IMPL", "pallas_interpret")
    monkeypatch.setattr(tnn, "MLP_IMPL", "fused")
    cloud = (np.random.RandomState(2).rand(1, 3, NARROW["NUM_INPUT"])
             * [[[0.6], [0.4], [0.3]]]).astype(np.float32)
    jnet, variables, tnet = _model_pair(dict(NARROW), "bfloat16", cloud)
    want = jnet.apply(variables, {"scene_points": jnp.asarray(cloud)},
                      train=False)
    chains = _chain_spy(monkeypatch)
    got = tnet({"scene_points": _t(cloud)})
    assert len(chains) == 10
    _assert_close(got, want, "bfloat16")


def test_pn2_cls_batch2_fused_chain_matches_jax(jax_fused_route,
                                                monkeypatch):
    """b = 2: SA1 is the fused stage (K3's twin; JAX's kernel in interpret
    mode), the other nine chains K7's twin."""
    monkeypatch.setattr(jnn, "ENV_MLP_IMPL", "pallas_interpret")
    monkeypatch.setattr(tnn, "MLP_IMPL", "fused")
    cloud = (np.random.RandomState(3).rand(2, 3, PN2_BATCH["NUM_INPUT"])
             * np.array([[[0.6], [0.4], [0.3]], [[0.3], [0.5], [0.4]]])
             ).astype(np.float32)
    jnet, variables, tnet = _model_pair(dict(PN2_BATCH), "bfloat16", cloud)
    want = jnet.apply(variables, {"scene_points": jnp.asarray(cloud)},
                      train=False)
    chains = _chain_spy(monkeypatch)
    fused = _spy(monkeypatch, sf, "sa1_fused_slab")
    got = tnet({"scene_points": _t(cloud)})
    assert len(chains) == 9 and len(fused) == 1
    _assert_close(got, want, "bfloat16")


def test_eval_fused_chain_matches_jax_eval(tmp_path, monkeypatch):
    """eval on the tiny f32 model with the route forced on both sides and
    the JAX detector's draws injected: 8 chains (2 SA, 2 FP, 4 heads)."""
    monkeypatch.setattr(jnn, "ENV_MLP_IMPL", "pallas_interpret")
    monkeypatch.setattr(tnn, "MLP_IMPL", "fused")
    cfg_file = tmp_path / "tiny.yaml"
    cfg_file.write_text(yaml.safe_dump(TINY))
    cap = 8192
    jdet = JaxDetector(model=str(cfg_file), output_dir=str(tmp_path),
                       cloud_capacity=cap, num_candidates=64)
    cloud = clutter_cloud(np.random.RandomState(6))
    key = jdet._key
    want = jdet.eval(cloud)
    _, sub = jax.random.split(key)
    padded, _ = jdet._pad_cloud(cloud)
    train = jnp.matmul(padded, jnp.asarray(jpost.REAL2TRAIN[:3, :3]).T)
    pre = jpre.preprocess_cloud(train, sub, num_points=512, capacity=cap)
    sample_idx = jpre.random_sample_fixed(sub, pre.raw_valid, 512)
    tdetector = tdet.GraspDetector(
        model=str(cfg_file), device="cpu", output_dir=str(tmp_path),
        cloud_capacity=cap, num_candidates=64,
        state_dict=state_dict_from_flax(jax.tree.map(np.asarray,
                                                     jdet.variables)))
    chains = _chain_spy(monkeypatch)
    got = tdetector.eval(cloud, sample_idx=_t(np.asarray(sample_idx)))
    assert len(chains) == 8
    for k in ("score", "frame_R", "frame_t", "movable_logits"):
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape, k
        np.testing.assert_allclose(
            g, w, atol=1e-5 * max(1.0, float(np.abs(w).max())), rtol=0,
            err_msg=k)
