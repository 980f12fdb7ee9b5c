"""The S4G grasp models in eval mode, one scene at a time: PointNet++ (set
abstraction with farthest point sampling and ball-query grouping, feature
propagation by 3-NN inverse-distance interpolation) under PN2_CLS's heads
(score, raw 9-D rotation, 4 translation bins, 5 movabilities) or PN2's
(score, 6-D rotation, translation residual, movabilities).

Departures the configuration states, as the S4G port deploys them:
SORT_POINTS (the cloud sorted along its widest axis, stable; per-point
outputs in the input's order), FPS_SHARDS G (exact FPS inside each of G
contiguous slices of the sorted cloud, each slice's picks in ascending
order), rank-stratified neighbours of an overfull ball when sorted (the
points of rank floor(s * total / K) + 1 in scan order), and a bf16
compute dtype for the matmuls.

Parameters are read by the published torch names (`sa_modules.{i}.mlp.
{j}.conv.weight`, `...bn.*`, `fp_modules.*`, `mlp_{seg,R,t,movable}.*`,
`{seg,R,t}_logit.*`, `movable_logit.0.*`).  FPS, ball queries and 3-NN
use difference-form f32 squared distances ((dx*dx + dy*dy) + dz*dz),
strict < radius^2, ties to the lower index; BatchNorm uses the running
statistics, (y - mean) * (weight * rsqrt(var + 1e-5)) + bias."""

from __future__ import annotations

import torch

from . import geometry as geo
from .precision import Precision, matmul, stated

BN_EPS = 1e-5
HEADS = ("seg", "R", "t", "movable")


def param_shapes(cfg: dict) -> dict:
    """Published parameter name -> shape of the configuration's model."""
    shapes = {}

    def mlp(prefix, cin, widths, ndim):
        for j, c in enumerate(widths):
            shapes[f"{prefix}.{j}.conv.weight"] = (c, cin) + (1,) * ndim
            for t in ("weight", "bias", "running_mean", "running_var"):
                shapes[f"{prefix}.{j}.bn.{t}"] = (c,)
            shapes[f"{prefix}.{j}.bn.num_batches_tracked"] = ()
            cin = c

    sa = cfg["SA_CHANNELS"]
    widths = [0] + [c[-1] for c in sa]
    for i, ch in enumerate(sa):
        mlp(f"sa_modules.{i}.mlp", 3 + widths[i], ch, 2)
    sparse = widths[-1]
    for i, ch in enumerate(cfg["FP_CHANNELS"]):
        mlp(f"fp_modules.{i}.mlp", sparse + widths[-2 - i], ch, 1)
        sparse = ch[-1]
    seg = cfg["SEG_CHANNELS"]
    for h in HEADS:
        mlp(f"mlp_{h}", sparse, seg, 1)
    outs = {"seg": cfg["SCORE_CLASSES"],
            "R": 9 if cfg["TYPE"] == "PN2_CLS" else 6,
            "t": 4 if cfg["TYPE"] == "PN2_CLS" else 3,
            "movable": cfg["NUM_REMOVAL_DIRECTIONS"]}
    for h, c in outs.items():
        name = "movable_logit.0" if h == "movable" else f"{h}_logit"
        shapes[f"{name}.weight"] = (c, seg[-1], 1)
        shapes[f"{name}.bias"] = (c,)
    return shapes


def _mlp(sd: dict, prefix: str, x: torch.Tensor, prec: Precision):
    """Dense (bf16 product) + BatchNorm + ReLU per layer over the last axis."""
    j = 0
    while f"{prefix}.{j}.conv.weight" in sd:
        w = sd[f"{prefix}.{j}.conv.weight"]
        y = matmul(x, w.reshape(w.shape[0], -1), prec)
        bn = {t: sd[f"{prefix}.{j}.bn.{t}"].float()
              for t in ("weight", "bias", "running_mean", "running_var")}
        mul = torch.rsqrt(bn["running_var"] + BN_EPS) * bn["weight"]
        x = prec.round(torch.relu((y - bn["running_mean"]) * mul
                                  + bn["bias"]))
        j += 1
    return x


def _sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, 3) x (N, 3) -> (M, N) difference-form squared distances."""
    dx = a[:, 0, None] - b[None, :, 0]
    dy = a[:, 1, None] - b[None, :, 1]
    dz = a[:, 2, None] - b[None, :, 2]
    return dx * dx + dy * dy + dz * dz


def _fps(pts: torch.Tensor, m: int) -> torch.Tensor:
    """Exact FPS of each row of (G, S, 3) from its point 0: (G, m) local
    indices in pick order (each step the point farthest from the picked
    set, ties to the lower index)."""
    g, s, _ = pts.shape
    min_d = torch.full((g, s), float("inf"), device=pts.device)
    out = torch.zeros((g, m), dtype=torch.long, device=pts.device)
    last = torch.zeros((g, 1), dtype=torch.long, device=pts.device)
    for i in range(1, m):
        c = torch.gather(pts, 1, last[:, :, None].expand(g, 1, 3))
        d = pts - c
        min_d = torch.minimum(min_d, d[..., 0] * d[..., 0]
                              + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2])
        last = torch.argmax(min_d, dim=1, keepdim=True)
        out[:, i] = last[:, 0]
    return out


def _sharding(n: int, m: int, g: int) -> bool:
    return g > 1 and n % g == 0 and m % g == 0 and m >= g and n // g >= m // g


def sample(xyz: torch.Tensor, m: int, sort_axis, shards: int):
    """FPS centroid indices (m,) into xyz (N, 3)."""
    n = len(xyz)
    if sort_axis is not None and _sharding(n, m, shards):
        ns = n // shards
        loc = _fps(xyz.reshape(shards, ns, 3), m // shards)
        idx = loc + torch.arange(shards, device=xyz.device)[:, None] * ns
        return torch.sort(idx, dim=1).values.reshape(m)
    idx = _fps(xyz[None], m)[0]
    if sort_axis is not None:
        idx = idx[torch.argsort(xyz[idx, sort_axis], stable=True)]
    return idx


def ball_query(pts: torch.Tensor, cents: torch.Tensor, radius: float, k: int,
               stratified: bool, chunk: int = 256):
    """Per centroid the in-range points in scan order: the first k, or
    rank-stratified when `stratified` and the ball holds more; empty slots
    repeat slot 0.  Returns (M, k) indices and (M,) counts min(total, k)."""
    r2 = geo.f32(radius * radius)
    slot = torch.arange(k, device=pts.device)[None, :]
    idx_out, cnt_out = [], []
    for c0 in range(0, len(cents), chunk):
        mask = _sqdist(cents[c0:c0 + chunk], pts) < r2
        cum = torch.cumsum(mask, dim=1, dtype=torch.int32)
        total = cum[:, -1:].long()
        target = slot + 1
        if stratified:
            target = torch.where(total > k, slot * total // k + 1, target)
        idx = torch.searchsorted(cum, target.to(torch.int32).contiguous())
        idx = idx.clamp(max=len(pts) - 1)
        count = total.clamp(max=k)
        idx = torch.where(slot < count, idx, idx[:, :1])
        idx = torch.where(count > 0, idx, 0)
        idx_out.append(idx)
        cnt_out.append(count[:, 0])
    return torch.cat(idx_out), torch.cat(cnt_out)


def three_nn(query: torch.Tensor, keys: torch.Tensor, chunk: int = 1024):
    """The 3 nearest keys of each query by (distance, index): (N1, 3)
    indices and their squared distances, ascending."""
    ids = torch.arange(len(keys), device=keys.device)[None, :]
    idx_out, d_out = [], []
    for q0 in range(0, len(query), chunk):
        d = _sqdist(query[q0:q0 + chunk], keys)
        picks, dists = [], []
        for _ in range(3):
            mn = d.amin(dim=1, keepdim=True)
            i = torch.where(d == mn, ids, len(keys)).amin(dim=1, keepdim=True)
            picks.append(i[:, 0])
            dists.append(mn[:, 0])
            d = torch.where(ids == i, float("inf"), d)
        idx_out.append(torch.stack(picks, 1))
        d_out.append(torch.stack(dists, 1))
    return torch.cat(idx_out), torch.cat(d_out)


def backbone(sd: dict, cfg: dict, xyz: torch.Tensor, prec: Precision):
    """(N, 3) input points -> (N, C) per-point features, input order."""
    order = axis = None
    if cfg["SORT_POINTS"]:
        axis = int(torch.argmax(xyz.amax(0) - xyz.amin(0)))
        order = torch.argsort(xyz[:, axis], stable=True)
        xyz = xyz[order]
    shards = cfg["FPS_SHARDS"]
    stratified = axis is not None
    levels, feats = [xyz], [None]
    cur, feat = xyz, None
    for i, (m, r, k) in enumerate(zip(cfg["NUM_CENTROIDS"], cfg["RADIUS"],
                                      cfg["NUM_NEIGHBOURS"])):
        if m <= 0:
            raise NotImplementedError("global and all-points SA stages")
        cidx = sample(cur, m, axis, shards)
        cents = cur[cidx]
        nidx, cnt = ball_query(cur, cents, r, k, stratified)
        rel = cur[nidx] - cents[:, None, :]
        if feat is None:
            grouped = torch.where(cnt[:, None, None] > 0, rel, 0.0)
        else:
            grouped = torch.cat([rel, feat[nidx]], dim=-1)
        feat = _mlp(sd, f"sa_modules.{i}.mlp", grouped, prec).amax(dim=1)
        cur = cents
        levels.append(cur)
        feats.append(feat)
    sparse_xyz, sparse = cur, feat
    for i in range(len(cfg["FP_CHANNELS"])):
        dense_xyz, dense = levels[-2 - i], feats[-2 - i]
        nidx, d = three_nn(dense_xyz, sparse_xyz)
        inv = 1.0 / torch.clamp(d, min=1e-10)
        w = prec.round(inv / (inv[:, 0:1] + inv[:, 1:2] + inv[:, 2:3]))
        interp = prec.round(sparse[nidx[:, 0]] * w[:, 0:1]
                            + sparse[nidx[:, 1]] * w[:, 1:2]
                            + sparse[nidx[:, 2]] * w[:, 2:3])
        x = interp if dense is None else torch.cat([interp, dense], dim=-1)
        sparse = _mlp(sd, f"fp_modules.{i}.mlp", x, prec)
        sparse_xyz = dense_xyz
    if order is not None:
        out = torch.empty_like(sparse)
        out[order] = sparse
        sparse = out
    return sparse


def _logit(sd: dict, name: str, x: torch.Tensor, prec: Precision):
    """The logit layer: product and bias added in the compute dtype."""
    w, b = sd[f"{name}.weight"], sd[f"{name}.bias"]
    y = matmul(x, w.reshape(w.shape[0], -1), prec)
    return (y.to(prec.compute) + b.to(prec.compute)).float()


def forward(sd: dict, cfg: dict, points: torch.Tensor,
            prec: Precision | None = None) -> dict:
    """One scene's (N, 3) train-frame points -> its predictions,
    channels-first f32: PN2_CLS "score" (C, N), "frame_R" (9, N),
    "frame_t" (4, N), "movable_logits" (5, N); PN2 "scene_score_logits",
    "frame_R" (9, N), "frame_t" (3, N, the grasp origins),
    "movable_logits"."""
    prec = prec or stated(cfg)
    with torch.no_grad():
        feat = backbone(sd, cfg, points.float(), prec)
        out = {}
        for h in HEADS:
            x = _mlp(sd, f"mlp_{h}", feat, prec)
            name = "movable_logit.0" if h == "movable" else f"{h}_logit"
            out[h] = _logit(sd, name, x, prec)
        mov = torch.sigmoid(out["movable"].to(prec.compute)).float().t()
        if cfg["TYPE"] == "PN2_CLS":
            return {"score": out["seg"].t(), "frame_R": out["R"].t(),
                    "frame_t": out["t"].t(), "movable_logits": mov}
        return {"scene_score_logits": out["seg"].t(),
                "frame_R": geo.rot6d_to_mat9(out["R"].t()),
                "frame_t": points.float().t() + out["t"].t(),
                "movable_logits": mov}
