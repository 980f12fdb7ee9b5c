"""s4g_tpu_torch — the PyTorch + CUDA port of s4g_tpu for NVIDIA Hopper.

The JAX package `s4g_tpu` is the reference; this package imports nothing
of it (and never imports jax).  Layout and public names mirror `s4g_tpu`
module for module.  Every Pallas kernel on the ported path has a
hand-written CUDA counterpart under `csrc/`, built with nvcc at first use
(`_build.py`); each kernel's wrapper takes its plain PyTorch twin only for
CPU tensors.
"""

__version__ = "0.1.0"
