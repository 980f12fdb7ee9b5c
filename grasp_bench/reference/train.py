"""A PN2_CLS training step of the S4G curvature model, as published:
the model in training mode over a batch (BatchNorm with the batch's
statistics over every axis but the channels, var = max(E[y^2] - E[y]^2,
0); dropout of probability p after every layer of the score and
movability heads, each element kept when a uniform draw lies below 1 - p
and scaled by 1 / (1 - p)), the losses (score classes: cross entropy
with the "no grasp" class weighted NEG_WEIGHT, normalized by the summed
weights; movability: mean absolute error; rotation: the score-weighted
mean squared error to the nearer of the frame and its 180-degree turn
about x, x5, over the first num_frame_points points; translation: cross
entropy over the 4 depth bins, x0.2), their sum, the gradients
(autograd over these plain operations) and Adam (bias-corrected, eps
1e-8 outside the square root).

Neighbour indices (FPS, ball query, 3-NN) are chosen per scene on the
points, which carry no gradient; the dropout draws are replayed from the
seed the benchmark gave the program's generator, in the program's order
(per step: the score head's layers, then the movability head's)."""

from __future__ import annotations

import torch

from . import model as m
from .precision import Precision, matmul, stated

BN_EPS = 1e-5


class Net:
    """The reference's parameters (f32 leaves that take gradients) by their
    published names."""

    def __init__(self, sd: dict):
        self.p = {k: v.detach().float().clone().requires_grad_(True)
                  for k, v in sd.items() if not k.endswith(
                      ("running_mean", "running_var", "num_batches_tracked"))}


def _mlp(p: dict, prefix: str, x: torch.Tensor, prec: Precision,
         drop: float = 0.0, gen=None) -> torch.Tensor:
    j = 0
    while f"{prefix}.{j}.conv.weight" in p:
        w = p[f"{prefix}.{j}.conv.weight"]
        y = matmul(x, w.reshape(w.shape[0], -1), prec)
        axes = tuple(range(y.dim() - 1))
        mean = torch.mean(y, dim=axes)
        var = torch.clamp(torch.mean(y * y, dim=axes) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + BN_EPS) * p[f"{prefix}.{j}.bn.weight"]
        x = prec.round(torch.relu((y - mean) * mul
                                  + p[f"{prefix}.{j}.bn.bias"]))
        if drop > 0:
            keep = torch.rand(x.shape, generator=gen, device=x.device) \
                < 1.0 - drop
            x = torch.where(keep, x / (1.0 - drop), 0.0)
        j += 1
    return x


def _stack(rows):
    return torch.stack(rows)


def backbone(p: dict, cfg: dict, xyz: torch.Tensor, prec: Precision):
    """(B, N, 3) points -> (B, N, C) features in training mode."""
    b = xyz.shape[0]
    orders = [None] * b
    axes = [None] * b
    if cfg["SORT_POINTS"]:
        for i in range(b):
            axes[i] = int(torch.argmax(xyz[i].amax(0) - xyz[i].amin(0)))
            orders[i] = torch.argsort(xyz[i, :, axes[i]], stable=True)
        xyz = _stack([xyz[i][orders[i]] for i in range(b)])
    levels, feats = [xyz], [None]
    cur, feat = xyz, None
    for s, (mc, r, k) in enumerate(zip(cfg["NUM_CENTROIDS"], cfg["RADIUS"],
                                       cfg["NUM_NEIGHBOURS"])):
        cents, groups = [], []
        for i in range(b):
            cidx = m.sample(cur[i], mc, axes[i], cfg["FPS_SHARDS"])
            c = cur[i][cidx]
            nidx, cnt = m.ball_query(cur[i], c, r, k, axes[i] is not None)
            rel = cur[i][nidx] - c[:, None, :]
            if feat is None:
                groups.append(torch.where(cnt[:, None, None] > 0, rel, 0.0))
            else:
                groups.append(torch.cat([rel, feat[i][nidx]], dim=-1))
            cents.append(c)
        cur = _stack(cents)
        feat = _mlp(p, f"sa_modules.{s}.mlp", _stack(groups), prec) \
            .amax(dim=2)
        levels.append(cur)
        feats.append(feat)
    sparse_xyz, sparse = cur, feat
    for s in range(len(cfg["FP_CHANNELS"])):
        dense_xyz, dense = levels[-2 - s], feats[-2 - s]
        rows = []
        for i in range(b):
            nidx, d = m.three_nn(dense_xyz[i], sparse_xyz[i])
            inv = 1.0 / torch.clamp(d, min=1e-10)
            w = inv / (inv[:, 0:1] + inv[:, 1:2] + inv[:, 2:3])
            rows.append(sparse[i][nidx[:, 0]] * w[:, 0:1]
                        + sparse[i][nidx[:, 1]] * w[:, 1:2]
                        + sparse[i][nidx[:, 2]] * w[:, 2:3])
        x = _stack(rows)
        if dense is not None:
            x = torch.cat([x, dense], dim=-1)
        sparse = _mlp(p, f"fp_modules.{s}.mlp", x, prec)
        sparse_xyz = dense_xyz
    if orders[0] is not None:
        out = []
        for i in range(b):
            inv = torch.empty_like(orders[i])
            inv[orders[i]] = torch.arange(len(inv), device=inv.device)
            out.append(sparse[i][inv])
        sparse = _stack(out)
    return sparse


def _logit(p: dict, name: str, x: torch.Tensor, prec: Precision):
    w, bias = p[f"{name}.weight"], p[f"{name}.bias"]
    y = matmul(x, w.reshape(w.shape[0], -1), prec)
    return (y.to(prec.compute) + bias.to(prec.compute)).float()


def forward(p: dict, cfg: dict, points: torch.Tensor, gen,
            prec: Precision) -> dict:
    """(B, 3, N) -> PN2_CLS's predictions, channels-first f32."""
    feat = backbone(p, cfg, points.transpose(1, 2).float(), prec)
    drop = cfg["DROPOUT_PROB"]
    out = {}
    for h in m.HEADS:
        dh = drop if h in ("seg", "movable") else 0.0
        x = _mlp(p, f"mlp_{h}", feat, prec, dh, gen)
        name = "movable_logit.0" if h == "movable" else f"{h}_logit"
        out[h] = _logit(p, name, x, prec)
    mov = torch.sigmoid(out["movable"].to(prec.compute)).float()
    return {"score": out["seg"].transpose(1, 2),
            "frame_R": out["R"].transpose(1, 2),
            "frame_t": out["t"].transpose(1, 2),
            "movable_logits": mov.transpose(1, 2)}


def _nll(logits, target):
    logp = torch.log_softmax(logits, dim=1)
    return -torch.gather(logp, 1, target.long()[:, None])[:, 0]


def losses(preds: dict, batch: dict, cfg: dict) -> dict:
    c = preds["score"].shape[1]
    weight = torch.ones(c, device=preds["score"].device)
    weight[0] = cfg["NEG_WEIGHT"]
    labels = batch["scene_score_labels"]
    w = weight[labels.long()]
    cls = torch.sum(w * _nll(preds["score"], labels)) / torch.sum(w)
    mov = torch.mean(torch.abs(preds["movable_logits"]
                               - batch["scene_movable_labels"]))
    gt_r = batch["best_frame_R"]
    nf = gt_r.shape[2]
    gt_score = batch["scene_score"][:, :nf]
    pred_r = preds["frame_R"][:, :, :nf]
    r = gt_r.reshape(gt_r.shape[0], 3, 3, nf)
    flip = torch.cat([r[:, :, :1], -r[:, :, 1:]], dim=2).reshape(gt_r.shape)
    l1 = torch.mean((pred_r - gt_r) ** 2, dim=1)
    l2 = torch.mean((pred_r - flip) ** 2, dim=1)
    r_loss = torch.mean(torch.minimum(l1, l2) * gt_score) * 5.0
    t_loss = torch.mean(_nll(preds["frame_t"][:, :, :nf],
                             batch["best_frame_t"])) * 0.2
    return {"cls_loss": cls, "R_loss": r_loss, "t_loss": t_loss,
            "mov_loss": mov}


class Adam:
    def __init__(self, params: dict, lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, betas[0], betas[1], eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = self.v[k].sqrt() / c2 ** 0.5 + self.eps
            p.sub_(self.lr / c1 * self.m[k] / denom)


def run_steps(sd: dict, cfg: dict, train: dict, batches: list, gen_seed: int,
              device, prec: Precision | None = None, rows=None) -> dict:
    """The first len(batches) steps from the weights `sd`: each step's total
    loss, the first step's gradients, the parameters after the last.
    `rows`: keep only these rows of every batch (the half-batch fault)."""
    prec = prec or stated(cfg)
    net = Net(sd)
    opt = Adam(net.p, train["BASE_LR"], tuple(train["BETAS"]))
    gen = torch.Generator(device=device)
    gen.manual_seed(gen_seed)
    out = {"losses": []}
    for s, batch in enumerate(batches):
        batch = {k: v.to(device) for k, v in batch.items()}
        if rows is not None:
            batch = {k: v[rows] for k, v in batch.items()}
        preds = forward(net.p, cfg, batch["scene_points"], gen, prec)
        ld = losses(preds, batch, cfg)
        total = sum(ld[k] for k in sorted(ld))
        grads = torch.autograd.grad(total, list(net.p.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(net.p.items(), grads)}
        out["losses"].append(float(total.detach()))
        if s == 0:
            out["grad"] = {k: g.detach().clone() for k, g in grads.items()}
        opt.step(net.p, grads)
    out["params"] = {k: v.detach() for k, v in net.p.items()}
    return out
