"""Weights across packages: the JAX package's PN2_CLS or PN2 variables ->
this port's state_dict.

The input is the flax variable tree `{"params", "batch_stats"}` with numpy
leaves.  The output uses the reference torch names that the port's modules
keep (`sa_modules.{i}.mlp.{j}.{conv,bn}.*`, `fp_modules.{i}.mlp.{j}.*`,
`mlp_{seg,R,t,movable}.{j}.*`, `{seg,R,t}_logit.*`, `movable_logit.0.*`),
so this is the inverse of s4g_tpu/utils/checkpoint.py::
import_pn2_torch_state_dict and a test can round-trip through both.  Head
widths are read from the variables (PN2_CLS's rotation and translation
logits are 9 and 4 wide, PN2's 6 and 3).
"""

from __future__ import annotations

import numpy as np
import torch

_HEADS = {"head_seg": ("mlp_seg", "seg_logit"),
          "head_R": ("mlp_R", "R_logit"),
          "head_t": ("mlp_t", "t_logit"),
          "head_movable": ("mlp_movable", "movable_logit.0")}


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _shared_mlp(params: dict, stats: dict, prefix: str, ndim: int,
                out: dict) -> None:
    j = 0
    while f"layer{j}" in params:
        p, s = params[f"layer{j}"], stats[f"layer{j}"]["bn"]
        kernel = _t(p["conv"]["kernel"])                    # (C_in, C_out)
        out[f"{prefix}.{j}.conv.weight"] = kernel.t().reshape(
            kernel.shape[1], kernel.shape[0], *([1] * ndim)).contiguous()
        out[f"{prefix}.{j}.bn.weight"] = _t(p["bn"]["scale"])
        out[f"{prefix}.{j}.bn.bias"] = _t(p["bn"]["bias"])
        out[f"{prefix}.{j}.bn.running_mean"] = _t(s["mean"])
        out[f"{prefix}.{j}.bn.running_var"] = _t(s["var"])
        out[f"{prefix}.{j}.bn.num_batches_tracked"] = torch.tensor(0)
        j += 1


def state_dict_from_flax(variables: dict) -> dict:
    """Flax PN2_CLS or PN2 variables (numpy leaves) -> port state_dict."""
    params, stats = variables["params"], variables["batch_stats"]
    out: dict = {}
    for kind, name, ndim in (("sa", "sa_modules", 2), ("fp", "fp_modules", 1)):
        i = 0
        while f"{kind}{i}" in params["backbone"]:
            _shared_mlp(params["backbone"][f"{kind}{i}"]["mlp"],
                        stats["backbone"][f"{kind}{i}"]["mlp"],
                        f"{name}.{i}.mlp", ndim, out)
            i += 1
    for head, (mlp_name, logit_name) in _HEADS.items():
        _shared_mlp(params[head]["mlp"], stats[head]["mlp"], mlp_name, 1, out)
        kernel = _t(params[head]["logit"]["kernel"])        # (C_in, C_out)
        out[f"{logit_name}.weight"] = kernel.t().contiguous()[..., None]
        out[f"{logit_name}.bias"] = _t(params[head]["logit"]["bias"])
    return out
