"""K4's plain twin (s4g_tpu_torch/ops/neighbors.py::_three_nn_plain), which
follows the kernel's steps (the keys cut in chunks, each chunk's top-3, then
a merge by (distance, index)), against the JAX package's TPU kernel
`three_nn_pallas` in interpret mode on the CPU, in one pass, at chunk sizes
that cut the keys anywhere, including between duplicate keys, and at the
kernel's own split on an H100's 132 SMs; and the key split that the
kernel's wrapper picks for a card's SM count.

Indices and distances must match exactly.  XLA's CPU backend contracts the
reference's products and sums into FMAs where the CPU has them, which moves
the last bit of some distances; capped at SSE4.2 (no FMA) it rounds after
every operation, as the kernel does.  So the JAX side runs once, in a child
process with that cap, for all the inputs of this module.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from s4g_tpu_torch.ops import neighbors as nb

REPO = Path(__file__).resolve().parents[1]

CASES = [
    ("random", 300, 200, None),      # one pass (the default)
    ("random", 300, 200, "h100"),    # the kernel's split on 132 SMs
    ("random", 300, 200, 3),         # three keys a chunk
    ("random", 300, 200, 7),         # a short last chunk (200 = 28*7 + 4)
    ("random", 300, 200, 200),       # one chunk
    ("grid", 257, 1000, 64),         # duplicate keys in and across chunks
    ("grid", 257, 1000, 999),        # a one-key last chunk
    ("straddle", 130, 700, 64),      # equal keys on both sides of each cut
    ("straddle", 130, 700, 32),
    ("straddle", 130, 700, None),
    ("straddle", 130, 700, "h100"),
]

H100_SMS = 132

_JAX_CHILD = """
import sys
import numpy as np
import jax.numpy as jnp
from s4g_tpu.ops.pallas.neighbor_kernels import three_nn_pallas
data = np.load(sys.argv[1])
out = {}
for tag in sorted({name[1:] for name in data.files}):
    i, d = three_nn_pallas(jnp.asarray(data["q" + tag]),
                           jnp.asarray(data["k" + tag]), interpret=True)
    out["i" + tag], out["d" + tag] = np.asarray(i), np.asarray(d)
np.savez(sys.argv[2], **out)
"""


def _cloud(seed, b, n1, n2, case):
    """Queries and keys, (B, 3, N1) and (B, 3, N2) f32.  "grid" puts the
    keys on a lattice (duplicate keys: exact ties); "straddle" copies
    queries 0..9 into keys 63 and 64, 127 and 128, ..., 639 and 640 (pairs
    of equal keys on both sides of every 64-key boundary)."""
    rng = np.random.RandomState(seed)
    q = rng.rand(b, 3, n1).astype(np.float32)
    k = rng.rand(b, 3, n2).astype(np.float32)
    if case == "grid":
        k = (np.round(k / 0.1) * 0.1).astype(np.float32)
    elif case == "straddle":
        for j, edge in enumerate(range(64, n2, 64)):
            k[:, :, edge - 1] = k[:, :, edge] = q[:, :, j % 10]
    return q, k


def _tag(case, n1, n2):
    return f"{case}_{n1}_{n2}"


@pytest.fixture(scope="module")
def jax_three_nn(tmp_path_factory):
    """`three_nn_pallas(..., interpret=True)` of every input of CASES, from
    a child process whose XLA may not use FMA: {tag: (index, dist)}."""
    work = tmp_path_factory.mktemp("three_nn")
    inputs = {}
    for case, n1, n2, _ in CASES:
        q, k = _cloud(n1 + n2, 2, n1, n2, case)
        inputs["q" + _tag(case, n1, n2)] = q
        inputs["k" + _tag(case, n1, n2)] = k
    np.savez(work / "in.npz", **inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO), os.environ.get("PYTHONPATH", "")]),
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_cpu_max_isa=SSE4_2").strip())
    run = subprocess.run([sys.executable, "-c", _JAX_CHILD,
                          str(work / "in.npz"), str(work / "out.npz")],
                         capture_output=True, text=True, timeout=300,
                         cwd=REPO, env=env)
    assert run.returncode == 0, run.stderr
    out = np.load(work / "out.npz")
    return {name[1:]: (out["i" + name[1:]], out["d" + name[1:]])
            for name in out.files if name.startswith("i")}


def _exact_dist(q, k, idx):
    """Difference-form squared distances of the selected keys in numpy f32
    (numpy rounds after every operation)."""
    sel = np.take_along_axis(k.transpose(0, 2, 1)[:, None],
                             idx[..., None].astype(np.int64), axis=2)
    d = sel - q.transpose(0, 2, 1)[:, :, None, :]
    return ((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
            + d[..., 2] * d[..., 2])


@pytest.mark.parametrize("case,n1,n2,chunk", CASES)
def test_three_nn_twin_matches_pallas_interpret(jax_three_nn, case, n1, n2,
                                                chunk):
    q, k = _cloud(n1 + n2, 2, n1, n2, case)
    want_i, want_d = jax_three_nn[_tag(case, n1, n2)]
    if chunk == "h100":
        chunk = nb.three_nn_key_chunk(2, n1, n2, H100_SMS)
    got_i, got_d = nb._three_nn_plain(torch.from_numpy(q),
                                      torch.from_numpy(k), chunk)
    got_i, got_d = got_i.numpy(), got_d.numpy()
    assert got_i.dtype == np.int32 and got_i.shape == (2, n1, 3)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_d, want_d)
    np.testing.assert_array_equal(got_d, _exact_dist(q, k, got_i))
    if case == "straddle":   # query j's two copies, lowest index first
        np.testing.assert_array_equal(got_d[:, :10, :2], 0.0)
        np.testing.assert_array_equal(got_i[:, 0, :2], [[63, 64]] * 2)


@pytest.mark.parametrize("b,n1,n2", [
    (1, 25600, 5120), (1, 5120, 1024),   # the two FP stages of the main path
    (2, 25600, 5120), (4, 25600, 5120), (1, 200, 30000), (8, 70000, 5),
])
def test_three_nn_key_split_fills_the_card(b, n1, n2):
    _check_split(b, n1, n2, H100_SMS)
    if (b, n1, n2) == (1, 25600, 5120):
        chunk = nb.three_nn_key_chunk(b, n1, n2, H100_SMS)
        assert (chunk, -(-n2 // chunk)) == (448, 12)


@pytest.mark.parametrize("sms", [1, 78, 114, 144])
def test_three_nn_key_split_follows_the_sm_count(sms):
    # The main path's larger FP stage on cards with other SM counts: more
    # SMs never get longer chunks.
    chunks = [_check_split(1, 25600, 5120, s) for s in (sms, 2 * sms)]
    assert chunks[1] <= chunks[0]


def _check_split(b, n1, n2, sms):
    """The split's invariants on a card with `sms` SMs; returns the chunk."""
    chunk = nb.three_nn_key_chunk(b, n1, n2, sms)
    blocks = b * -(-n1 // nb.NN_TILE_Q) * -(-n2 // chunk)
    assert 3 <= chunk <= n2
    assert chunk == n2 or chunk % nb.NN_CHUNK_ALIGN == 0
    # Four blocks per SM, unless the chunks are already as short as allowed.
    assert (blocks >= nb.NN_BLOCKS_PER_SM * sms
            or chunk in (n2, nb.NN_CHUNK_ALIGN))
    return chunk
