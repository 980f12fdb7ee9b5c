"""Arithmetic precision of the reference: how matmul operands and values
are rounded."""

from __future__ import annotations

from dataclasses import dataclass

import torch

FP8_MAX = 448.0    # largest finite float8_e4m3fn


@dataclass(frozen=True)
class Precision:
    """`matmul`: "bf16" (operands rounded to bf16, f32 products and sums,
    as the configuration's COMPUTE_DTYPE states), "fp8" (operands scaled
    per tensor to e4m3's range and rounded to it) or "f32".  `values`:
    the dtype every other value is held in (f32 as stated; bf16 for the
    control).  Indices (sampling, FPS, neighbour selection) are chosen on
    f32 coordinates in both."""
    matmul: str = "bf16"
    values: torch.dtype = torch.float32

    def round(self, x: torch.Tensor) -> torch.Tensor:
        """`x` rounded to the value dtype, returned as f32."""
        return x.to(self.values).float()


    @property
    def compute(self) -> torch.dtype:
        """The dtype a matmul's product comes out in."""
        return torch.float32 if self.matmul == "f32" else torch.bfloat16


F32_VALUES = Precision("f32")
_MATMUL = {"bfloat16": "bf16", "float32": "f32"}
_BELOW = {"bf16": "fp8", "f32": "bf16"}


def stated(cfg: dict) -> Precision:
    """The configuration's precision: its COMPUTE_DTYPE for the matmuls,
    f32 for the rest."""
    return Precision(_MATMUL[cfg["COMPUTE_DTYPE"]])


def control(cfg: dict) -> Precision:
    """One step below the configuration's: fp8 operands for bf16 ones (bf16
    for f32 ones), bf16 values for f32 ones."""
    return Precision(_BELOW[stated(cfg).matmul], torch.bfloat16)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def operands(x: torch.Tensor, w: torch.Tensor, prec: Precision) -> tuple:
    """(x, w) rounded as matmul operands in `prec`, f32."""
    if prec.matmul == "bf16":
        return x.to(torch.bfloat16).float(), w.to(torch.bfloat16).float()
    if prec.matmul == "fp8":
        return _fp8(x), _fp8(w)
    if prec.matmul == "f32":
        return x.float(), w.float()
    raise ValueError(f"unknown matmul precision {prec.matmul!r}")


def matmul(x: torch.Tensor, w: torch.Tensor, prec: Precision) -> torch.Tensor:
    """x (..., C_in) @ w (C_out, C_in)^T with rounded operands and f32
    accumulation (bf16 x bf16 and e4m3 x e4m3 products are exact in f32);
    the product comes out in bf16 (the compute dtype's Dense) unless the
    operands are f32."""
    xr, wr = operands(x, w, prec)
    return torch.matmul(xr, wr.t()).to(prec.compute).float()
