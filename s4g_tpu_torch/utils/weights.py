"""Weights across packages: the JAX package's variables of any of its seven
model types -> this port's state_dict.

The input is the flax variable tree `{"params", "batch_stats"}` with numpy
leaves (or the `params` tree alone, `params_from_flax`, which also maps a
gradient tree onto the port's parameter names).  The model type is read
from the tree.

* PN2_CLS, PN2, EDGEPN2D, EDGEPN2DU: the reference torch names that the
  port's modules keep (`sa_modules.{i}.mlp.{j}.{conv,bn}.*`,
  `fp_modules.{i}.mlp.{j}.*`, `mlp_{seg,R,t,movable}.{j}.*`,
  `{seg,R,t}_logit.*`, `movable_logit.0.*`), so this is the inverse of
  s4g_tpu/utils/checkpoint.py::import_pn2_torch_state_dict and a test can
  round-trip through both.  Head widths are read from the variables
  (PN2_CLS's rotation and translation logits are 9 and 4 wide, PN2's 6 and
  3).  The edge models differ only in widths.
* PN2_LOCAL (its variables hold `mlp_grasp_eval`): `mlp_{R,t,movable}`,
  `{R,t,movable}_logit.*` (the movability logit without a sigmoid),
  `mlp_grasp_eval.{j}.*` and `grasp_eval_logit.*`.
* GPD (`conv1`, `conv2`, `fc1`, `fc2`) and PointNetGPD (`stn.conv1.fc.*`,
  `stn.conv1.bn.*`, ..., `conv3.*`, `bn3.*`, `fc3.*`) keep the JAX module
  names in torch layouts: flax Conv kernels (kh, kw, in, out) become
  (out, in, kh, kw), Dense kernels (in, out) become (out, in); GPD's fc1
  takes its inputs in the port's NCHW flatten order.

Past PN2_CLS and PN2 these names follow the JAX modules: the reference's
own torch names for these models cannot be checked here.
"""

from __future__ import annotations

import numpy as np
import torch

_HEADS = {"head_seg": ("mlp_seg", "seg_logit"),
          "head_R": ("mlp_R", "R_logit"),
          "head_t": ("mlp_t", "t_logit"),
          "head_movable": ("mlp_movable", "movable_logit.0")}
_LOCAL_HEADS = {"head_R": ("mlp_R", "R_logit"),
                "head_t": ("mlp_t", "t_logit"),
                "head_movable": ("mlp_movable", "movable_logit")}


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _shared_mlp(params: dict, stats, prefix: str, ndim: int,
                out: dict) -> None:
    """One SharedMLP's layers: the parameters, and with `stats` (its
    batch_stats) the BatchNorm buffers."""
    j = 0
    while f"layer{j}" in params:
        p = params[f"layer{j}"]
        kernel = _t(p["conv"]["kernel"])                    # (C_in, C_out)
        out[f"{prefix}.{j}.conv.weight"] = kernel.t().reshape(
            kernel.shape[1], kernel.shape[0], *([1] * ndim)).contiguous()
        _bn(p["bn"], None if stats is None else stats[f"layer{j}"]["bn"],
            f"{prefix}.{j}.bn", out)
        j += 1


def _bn(params: dict, stats, prefix: str, out: dict) -> None:
    out[f"{prefix}.weight"] = _t(params["scale"])
    out[f"{prefix}.bias"] = _t(params["bias"])
    if stats is not None:
        out[f"{prefix}.running_mean"] = _t(stats["mean"])
        out[f"{prefix}.running_var"] = _t(stats["var"])
        out[f"{prefix}.num_batches_tracked"] = torch.tensor(0)


def _dense(params: dict, prefix: str, out: dict, ndim: int = 0) -> None:
    """A Dense layer as a Linear (`ndim` 0) or a 1x1 Conv1d / Conv2d."""
    kernel = _t(params["kernel"]).t().contiguous()          # (C_out, C_in)
    out[f"{prefix}.weight"] = kernel.reshape(*kernel.shape, *[1] * ndim)
    out[f"{prefix}.bias"] = _t(params["bias"])


def _sub(stats, key):
    return None if stats is None else stats[key]


def _pn2(params: dict, stats) -> dict:
    out: dict = {}
    for kind, name, ndim in (("sa", "sa_modules", 2),
                             ("fp", "fp_modules", 1)):
        i = 0
        while f"{kind}{i}" in params["backbone"]:
            _shared_mlp(params["backbone"][f"{kind}{i}"]["mlp"],
                        None if stats is None
                        else stats["backbone"][f"{kind}{i}"]["mlp"],
                        f"{name}.{i}.mlp", ndim, out)
            i += 1
    local = "mlp_grasp_eval" in params
    for head, (mlp_name, logit_name) in (_LOCAL_HEADS if local
                                         else _HEADS).items():
        _shared_mlp(params[head]["mlp"], _sub(_sub(stats, head), "mlp"),
                    mlp_name, 1, out)
        _dense(params[head]["logit"], logit_name, out, ndim=1)
    if local:
        _shared_mlp(params["mlp_grasp_eval"], _sub(stats, "mlp_grasp_eval"),
                    "mlp_grasp_eval", 2, out)
        _dense(params["grasp_eval_logit"], "grasp_eval_logit", out, ndim=2)
    return out


def _gpd(params: dict) -> dict:
    out: dict = {}
    for name in ("conv1", "conv2"):
        out[f"{name}.weight"] = _t(params[name]["kernel"]).permute(
            3, 2, 0, 1).contiguous()
        out[f"{name}.bias"] = _t(params[name]["bias"])
    # fc1's inputs: JAX flattens (row, column, channel), the port
    # (channel, row, column).
    kernel = _t(params["fc1"]["kernel"])                    # (h*w*c, 500)
    channels = params["conv2"]["kernel"].shape[-1]
    side = int(round((kernel.shape[0] // channels) ** 0.5))
    out["fc1.weight"] = kernel.reshape(side, side, channels, -1).permute(
        3, 2, 0, 1).reshape(kernel.shape[1], -1).contiguous()
    out["fc1.bias"] = _t(params["fc1"]["bias"])
    _dense(params["fc2"], "fc2", out)
    return out


def _pointnet_gpd(params: dict, stats) -> dict:
    out: dict = {}

    def dense_bn(p, s, prefix):
        _dense(p["fc"], f"{prefix}.fc", out)
        _bn(p["bn"], _sub(s, "bn"), f"{prefix}.bn", out)

    for name in ("conv1", "conv2", "conv3", "fc1", "fc2"):
        dense_bn(params["stn"][name], _sub(_sub(stats, "stn"), name),
                 f"stn.{name}")
    _dense(params["stn"]["fc3"], "stn.fc3", out)
    for name in ("conv1", "conv2", "fc1", "fc2"):
        dense_bn(params[name], _sub(stats, name), name)
    _dense(params["conv3"], "conv3", out)
    _bn(params["bn3"], _sub(stats, "bn3"), "bn3", out)
    _dense(params["fc3"], "fc3", out)
    return out


def _convert(params: dict, stats) -> dict:
    if "backbone" in params:
        return _pn2(params, stats)
    if "stn" in params:
        return _pointnet_gpd(params, stats)
    return _gpd(params)


def params_from_flax(params: dict) -> dict:
    """A flax `params` tree of any model type (numpy leaves; parameters,
    or their gradients) -> the same tensors under the port's parameter
    names (no BatchNorm buffers): what `named_parameters()` holds."""
    return _convert(params, None)


def state_dict_from_flax(variables: dict) -> dict:
    """Flax variables of any model type (numpy leaves) -> port state_dict
    (GPD's have no "batch_stats")."""
    return _convert(variables["params"], variables.get("batch_stats"))
