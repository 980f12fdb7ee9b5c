"""S4G's edge-convolution PointNet++ in eval mode, one scene at a time:
EDGEPN2DU (yzqin/s4g-release `models/EdgePointNet2DownUp.py:8-91`, its
layers `EdgeSAModule` and `EdgeFPModule`, `pointnet2_utils/modules.py:
407-547`) and EDGEPN2D (the same set abstraction, plain feature
propagation).  For a stage of centroids c_i, neighbours j (the first K
points within the radius in scan order) and features f:

- edge SA (a stage with features): h_i = max_j MLP([p_j - p_i || f_j ||
  f_j - f_i]), 3 + 2C inputs; the first stage, which has no features,
  groups [p_j - p_i] alone;
- global SA (0 centroids): h = max_j MLP([p_j || f_j]) over every point,
  one centroid at the origin;
- broadcast FP (0 neighbours): MLP([h || f_d]) at every dense point d;
- edge FP (3 neighbours, EDGEPN2DU): with s_k the 3 nearest sparse points,
  w their normalized inverse squared distances and f^ = sum_k w_k f_{s_k},
  out_d = mean_k MLP([f^ || f_{s_k} - f^ || f_d]);
- plain FP (3 neighbours, EDGEPN2D): MLP([f^ || f_d]).

Sampling, 3-NN, the MLPs (bf16 products at the stated
precision), the logits and the heads are `reference.model`'s; nothing of
the program is imported.  TF32 is set off on import, as f32 products must
be full f32.

Departures, each as the configuration states it:

- the heads are PN2's (score logits, a 6-D rotation turned into a 3x3 one,
  a translation residual added to each point, 5 movabilities): the
  released EdgePointNet2DownUp's forward uses heads its __init__ never
  builds, so it cannot run, and the port completes it as the JAX package
  does;
- COMPUTE_DTYPE bfloat16: the matmuls take bf16 operands with f32
  accumulation; BatchNorm, the interpolation and the means stay f32;
- the unsorted cloud with exact FPS only (SORT_POINTS false, FPS_SHARDS 1,
  as published); no all-points (-1) stage.

`param_shapes`, `forward_flops` and `make_weights` are this model's
counterparts of `reference.model.param_shapes`, `flops.forward_flops` and
`weights.make`."""

from __future__ import annotations

import torch

from . import geometry as geo
from .model import HEADS, _logit, _mlp, _sqdist, sample, three_nn
from .model import param_shapes as _pn2_shapes
from .precision import Precision, stated

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_EDGE_FP = {"EDGEPN2D": False, "EDGEPN2DU": True}


def _edge_fp(cfg: dict, i: int) -> bool:
    """Whether FP stage i is an edge stage (EDGEPN2DU, 3 neighbours)."""
    return _EDGE_FP[cfg["TYPE"]] and cfg["NUM_FP_NEIGHBOURS"][i] == 3


def _mlp_shapes(shapes: dict, prefix: str, cin: int, widths, ndim: int):
    for j, c in enumerate(widths):
        shapes[f"{prefix}.{j}.conv.weight"] = (c, cin) + (1,) * ndim
        for t in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{prefix}.{j}.bn.{t}"] = (c,)
        shapes[f"{prefix}.{j}.bn.num_batches_tracked"] = ()
        cin = c


def param_shapes(cfg: dict) -> dict:
    """Published parameter name -> shape: edge SA stages take 3 + 2C
    inputs (the first and the global stage 3 + C), edge FP stages 2 C_sparse
    + C_dense; the heads are PN2's."""
    shapes = {}
    sa = cfg["SA_CHANNELS"]
    widths = [0] + [c[-1] for c in sa]
    for i, (ch, m) in enumerate(zip(sa, cfg["NUM_CENTROIDS"])):
        twice = 2 if m != 0 else 1
        _mlp_shapes(shapes, f"sa_modules.{i}.mlp", 3 + twice * widths[i],
                    ch, 2)
    sparse = widths[-1]
    for i, ch in enumerate(cfg["FP_CHANNELS"]):
        cin = sparse * (2 if _edge_fp(cfg, i) else 1) + widths[-2 - i]
        _mlp_shapes(shapes, f"fp_modules.{i}.mlp", cin, ch, 1)
        sparse = ch[-1]
    shapes.update((k, v) for k, v in _pn2_shapes(cfg).items()
                  if not k.startswith(("sa_modules.", "fp_modules.")))
    return shapes


def forward_flops(cfg: dict) -> float:
    """FLOPs of one forward of one scene, 2 a multiply-add of every dense
    layer: an SA stage over its K neighbour slots of every centroid (the
    global stage over every point of the level below), an FP stage over
    every dense point (3 rows a point in an edge stage), the four heads and
    their logits over every input point."""
    # Points of each level: the input, then each stage's centroids (one
    # for the global stage).
    levels = [cfg["NUM_INPUT"], *(max(m, 1) for m in cfg["NUM_CENTROIDS"])]
    rows = {}
    for i, (m, k) in enumerate(zip(cfg["NUM_CENTROIDS"],
                                   cfg["NUM_NEIGHBOURS"])):
        rows[f"sa_modules.{i}."] = m * k if m > 0 else levels[i]
    for i in range(len(cfg["FP_CHANNELS"])):
        rows[f"fp_modules.{i}."] = (levels[-2 - i]
                                    * (3 if _edge_fp(cfg, i) else 1))
    total = 0.0
    for name, shape in param_shapes(cfg).items():
        if not name.endswith("weight") or ".bn." in name:
            continue
        r = next((v for p, v in rows.items() if name.startswith(p)),
                 cfg["NUM_INPUT"])
        total += 2.0 * r * shape[0] * shape[1]
    return total


def make_weights(cfg: dict, seed: int, device) -> dict:
    """`weights.make`'s seeded draw (its recipe and its order) over this
    model's shapes."""
    from .. import weights
    pn2_shapes = weights.param_shapes
    weights.param_shapes = param_shapes
    try:
        return weights.make(cfg, seed, device)
    finally:
        weights.param_shapes = pn2_shapes


def ball_query(pts: torch.Tensor, cents: torch.Tensor, radius: float,
               k: int, chunk: int = 256):
    """Per centroid the first k in-range points in scan order, empty slots
    repeating slot 0: (M, k) indices and (M,) counts min(total, k).  The
    unstratified case of `reference.model.ball_query`, whose slot targets
    that function does not broadcast over a chunk's centroids (it serves
    sorted clouds, always stratified)."""
    r2 = geo.f32(radius * radius)
    slot = torch.arange(k, device=pts.device)[None, :]
    idx_out, cnt_out = [], []
    for c0 in range(0, len(cents), chunk):
        mask = _sqdist(cents[c0:c0 + chunk], pts) < r2
        cum = torch.cumsum(mask, dim=1, dtype=torch.int32)
        target = (slot + 1).expand(len(mask), k).to(torch.int32)
        idx = torch.searchsorted(cum, target.contiguous())
        idx = idx.clamp(max=len(pts) - 1)
        count = cum[:, -1:].long().clamp(max=k)
        idx = torch.where(slot < count, idx, idx[:, :1])
        idx_out.append(torch.where(count > 0, idx, 0))
        cnt_out.append(count[:, 0])
    return torch.cat(idx_out), torch.cat(cnt_out)


def _sa_stage(sd, prefix, cur, feat, m, r, k, prec):
    """One SA stage: (its centroids, their features)."""
    if m == 0:
        x = torch.cat([cur, feat], dim=-1)
        h = _mlp(sd, prefix, x, prec).amax(dim=0, keepdim=True)
        return cur.new_zeros((1, 3)), h
    if m < 0:
        raise NotImplementedError("all-points SA stages")
    cidx = sample(cur, m, None, 1)
    cents = cur[cidx]
    nidx, cnt = ball_query(cur, cents, r, k)
    rel = cur[nidx] - cents[:, None, :]
    if feat is None:
        grouped = torch.where(cnt[:, None, None] > 0, rel, 0.0)
    else:
        fj = feat[nidx]
        grouped = torch.cat([rel, fj, fj - feat[cidx][:, None, :]], dim=-1)
    return cents, _mlp(sd, prefix, grouped, prec).amax(dim=1)


def _fp_stage(sd, prefix, dense_xyz, dense, sparse_xyz, sparse, neighbours,
              edge, prec):
    """One FP stage: features at the dense points."""
    if neighbours == 0:
        x = torch.cat([sparse.expand(len(dense_xyz), -1), dense], dim=-1)
        return _mlp(sd, prefix, x, prec)
    nidx, d = three_nn(dense_xyz, sparse_xyz)
    inv = 1.0 / torch.clamp(d, min=1e-10)
    w = prec.round(inv / (inv[:, 0:1] + inv[:, 1:2] + inv[:, 2:3]))
    g = sparse[nidx]                                      # (N1, 3, C)
    interp = prec.round(g[:, 0] * w[:, 0:1] + g[:, 1] * w[:, 1:2]
                        + g[:, 2] * w[:, 2:3])
    if not edge:
        x = interp if dense is None else torch.cat([interp, dense], dim=-1)
        return _mlp(sd, prefix, x, prec)
    parts = [interp[:, None].expand_as(g), prec.round(g - interp[:, None])]
    if dense is not None:
        parts.append(dense[:, None].expand(-1, 3, -1))
    return prec.round(_mlp(sd, prefix, torch.cat(parts, dim=-1),
                           prec).mean(dim=1))


def backbone(sd: dict, cfg: dict, xyz: torch.Tensor, prec: Precision):
    """(N, 3) input points -> (N, C) per-point features."""
    if cfg["SORT_POINTS"] or cfg["FPS_SHARDS"] != 1:
        raise NotImplementedError("the sorted cloud and sharded FPS")
    levels, feats = [xyz], [None]
    cur, feat = xyz, None
    for i, (m, r, k) in enumerate(zip(cfg["NUM_CENTROIDS"], cfg["RADIUS"],
                                      cfg["NUM_NEIGHBOURS"])):
        cur, feat = _sa_stage(sd, f"sa_modules.{i}.mlp", cur, feat, m, r, k,
                              prec)
        levels.append(cur)
        feats.append(feat)
    sparse_xyz, sparse = cur, feat
    for i, neighbours in enumerate(cfg["NUM_FP_NEIGHBOURS"]):
        dense_xyz, dense = levels[-2 - i], feats[-2 - i]
        sparse = _fp_stage(sd, f"fp_modules.{i}.mlp", dense_xyz, dense,
                           sparse_xyz, sparse, neighbours, _edge_fp(cfg, i),
                           prec)
        sparse_xyz = dense_xyz
    return sparse


def forward(sd: dict, cfg: dict, points: torch.Tensor,
            prec: Precision | None = None) -> dict:
    """One scene's (N, 3) train-frame points -> PN2's predictions,
    channels-first f32: "scene_score_logits" (C, N), "frame_R" (9, N),
    "frame_t" (3, N, the grasp origins), "movable_logits" (5, N)."""
    prec = prec or stated(cfg)
    with torch.no_grad():
        feat = backbone(sd, cfg, points.float(), prec)
        out = {}
        for h in HEADS:
            x = _mlp(sd, f"mlp_{h}", feat, prec)
            name = "movable_logit.0" if h == "movable" else f"{h}_logit"
            out[h] = _logit(sd, name, x, prec)
        mov = torch.sigmoid(out["movable"].to(prec.compute)).float().t()
        return {"scene_score_logits": out["seg"].t(),
                "frame_R": geo.rot6d_to_mat9(out["R"].t()),
                "frame_t": points.float().t() + out["t"].t(),
                "movable_logits": mov}
