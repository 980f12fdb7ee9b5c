"""Build and load the port's hand-written CUDA kernels.

Every `csrc/*.cu` file holds one kernel behind a plain C interface.  At
first use, one nvcc per source compiles it for Hopper (`sm_90a`), all of
them started together, and one more nvcc links the objects into
`_build/libs4g_kernels.so`, which is loaded with ctypes.  (PyTorch's
`cpp_extension.load` would compile PyTorch's headers too: minutes per build
instead of seconds.)  The library is rebuilt whenever a source or a flag
changes (a content stamp sits beside it).

Each C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `launch` raises on a non-zero code and counts the
launch, so a run can show that it went through the kernels.  A process
launches on one GPU only (`claim_device`).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import torch

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libs4g_kernels.so")

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# C entry point -> argtypes (pointers, ints, floats, then the stream).
_SIGNATURES = {
    # pts (B,3,N), b, n, nested (0: one stage, per-stage kernel; S: S
    # stages, nested kernel), m0..m2, out0..out2 (B,M_s) or NULL
    "s4g_fps_lane": (_P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P),
    # pts (B,3,N), b, n, shards, m_g, spill (f32 scratch past each
    # block's registers, or NULL), out (B, shards*m_g)
    "s4g_fps_exact": (_P, _I, _I, _I, _I, _P, _P, _P),
    # pts (B,3,N), cents (B,3,M), axes ((B,) int32 promised sort axes, or
    # NULL), b, n, m, r2, k, stratified, idx (B,M,K), cnt (B,M)
    "s4g_ball_query_full": (_P, _P, _P, _I, _I, _I, _F, _I, _I, _P, _P, _P),
    # pts (B,3,N), cents (B,3,M), lo_tile (B,T), b, n, m, ntile, r2, k,
    # stratified, idx (B,M,K), cnt (B,M)
    "s4g_ball_query_slab": (_P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P, _P,
                            _P),
    # query (B,3,N1), key (B,3,N2), b, n1, n2, chunk, partial idx and dist
    # (B,nsplit,3,N1) or NULL, idx (B,N1,3), dist (B,N1,3)
    "s4g_three_nn": (_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P),
    # mats (G,16), cloud_valid (N,4), g, n, 6 box bounds, acc (2G+1,) int32
    # zeroed, back (G,), fing (G,)
    "s4g_collision_counts": (_P, _P, _I, _I, _F, _F, _F, _F, _F, _F, _P, _P,
                             _P, _P),
    # pts (B,3,N), cents (B,3,M), lo_tile (B,T), wpack (bf16 W2 and W3 in
    # the kernel's shared-memory layout), fpack (f32 W1, b1, b2, b3), b, n,
    # m, ntile, r2, k, c3, stratified, out (B,M,C3)
    "s4g_sa1_fused": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _P,
                      _P),
    # x (P,C_in), 4 x (w, b), p, c_in, c_out, layers, kpad0, n0..n3,
    # relu_mask, pool_k, bf16, out (P or P/pool_k, C_out)
    "s4g_mlp_chain": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                      _I, _I, _I, _I, _I, _I, _I, _P, _P),
    # grad_out (P,C), order (P,) int32, offsets (rows+1,) int32, rows, c,
    # dtype (0 f32, 1 bf16, 2 f64), grad_x (rows,C)
    "s4g_gather_backward": (_P, _P, _P, _I, _I, _I, _P, _P),
}

# C entry points that launch nothing (argtypes, no stream): a launcher's
# plan for given sizes.
_QUERIES = {
    # ns, plan (2 int32: blocks per chain, scratch floats per block)
    "s4g_fps_exact_plan": (_I, _P),
}

# Launch counts per kernel (plain integers; chip_smoke.py zeroes them before
# it drives the main path and reads them after).
LAUNCHES = {name[len("s4g_"):]: 0 for name in _SIGNATURES}

_lock = threading.Lock()
_lib = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "host with the CUDA toolkit")
    return found


def _stamp() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return h.hexdigest()


def _run_all(cmds: list[list[str]], verbose: bool) -> None:
    """Run the commands side by side, wait for every one, and raise with
    the output of those that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n-> exit {proc.returncode}:\n"
                          f"{out}\n{err}")
        elif verbose and err:
            print(err)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def build(verbose: bool = False) -> str:
    """Compile every kernel source (one nvcc each, in parallel) and link
    them into LIB_PATH, unless an up-to-date build is already there.
    `verbose` prints ptxas' register and shared-memory report.  Returns
    the library path."""
    stamp = _stamp()
    stamp_path = LIB_PATH + ".stamp"
    if os.path.exists(LIB_PATH) and os.path.exists(stamp_path):
        with open(stamp_path) as f:
            if f.read() == stamp:
                return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(dir=BUILD_DIR)   # per process: builds may race
    try:
        nvcc = _nvcc()
        ptxas = ["-Xptxas", "-v"] if verbose else []
        objs = [os.path.join(work, os.path.basename(s) + ".o")
                for s in _sources()]
        _run_all([[nvcc, *NVCC_FLAGS, *ptxas, "-c", src, "-o", obj]
                  for src, obj in zip(_sources(), objs)], verbose)
        tmp = os.path.join(work, os.path.basename(LIB_PATH))
        _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs]], verbose)
        os.replace(tmp, LIB_PATH)
        with open(stamp_path, "w") as f:
            f.write(stamp)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return LIB_PATH


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in {**_SIGNATURES, **_QUERIES}.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


# The one CUDA device this process launches on: the first launch records
# it.  The kernels cache per-device facts once per process (the SM count,
# `csrc/common.cuh:40-53`; the shared-memory and cluster opt-ins set with
# cudaFuncSetAttribute, `common.cuh:28-37` and `fps_exact.cu:350-370`; the
# occupancy, `mlp_chain.cu:935-960`), which hold for that device only.
_launch_device: list = []


def claim_device(kernel: str, device: torch.device) -> None:
    """Record `device` as this process's launch device at its first launch;
    raise for a launch on any other."""
    with _lock:
        if not _launch_device:
            _launch_device.append(device)
    if device != _launch_device[0]:
        raise RuntimeError(
            f"kernel {kernel} launched on {device}, and this process "
            f"launched on {_launch_device[0]} first: the kernels cache "
            "per-device facts once per process (SM count, shared-memory "
            "and cluster opt-ins, occupancy; csrc/common.cuh, "
            "csrc/fps_exact.cu, csrc/mlp_chain.cu), so one process runs "
            "one GPU: launch one process per device "
            "(s4g_tpu_torch.parallel.make_mesh)")


def launch(kernel: str, *args) -> None:
    """Call `s4g_<kernel>` on the stream of its tensors' device, raise if
    the launch failed, and count it.  Tensor arguments are passed by data
    pointer; the caller keeps them alive (they are its inputs and
    outputs).

    One device per process: a launch on another device than the first
    launch's raises (`claim_device`; run one process per GPU,
    `parallel.make_mesh`)."""
    devices = {a.device for a in args if isinstance(a, torch.Tensor)}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"kernel {kernel}: its tensors must lie on one "
                         f"CUDA device, got {sorted(map(str, devices))}")
    device = devices.pop()
    claim_device(kernel, device)
    lib = load_library()
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args]
    with torch.cuda.device(device):     # the C side launches on it
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, "s4g_" + kernel)(*c_args, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: "
                           f"cudaError {err}")
    LAUNCHES[kernel] += 1


def query(name: str, *args) -> None:
    """Call the C entry point `s4g_<name>`, which launches nothing (not
    counted), and raise if it returns an error."""
    err = getattr(load_library(), "s4g_" + name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} failed: cudaError {err}")


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True if every tensor is on a CUDA device, False if every one is on
    the CPU; raises on a mix (a wrapper never copies between devices)."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"tensors on mixed devices: {sorted(kinds)}")


def check(t: torch.Tensor, name: str, dtype: torch.dtype,
          shape: tuple | None = None) -> None:
    """Validate a kernel operand: dtype, contiguity and (where given) shape
    (None entries are free)."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and (len(shape) != t.dim() or any(
            s is not None and s != d for s, d in zip(shape, t.shape))):
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
