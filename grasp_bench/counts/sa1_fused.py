"""K3, the fused SA1 stage (slab ball query, grouping, a 3-layer chain,
max over the neighbours): each centroid's min(in range, K) distinct rows
through the chain (a repeated row never changes the max), layers 2 and 3
as bf16 products (2 operations a multiply-add), layer 1 (3 inputs) and
the selection in f32 (9 per distance test, 6 per layer-1 unit); points,
centroids, windows and weights read once, the pooled features written
once."""

from ._slab import in_range, tests

NAMES = ("sa1_fused_kernel",)


def work(args, cfg):
    pts, cents, lo = args[0], args[1], args[2]
    b, n, m, r2, k, c3 = (args[5], args[6], args[7], args[9], args[10],
                          args[11])
    c1, c2, _ = cfg["SA_CHANNELS"][0]
    rows = in_range(pts, cents, r2, k)
    return {"bf16": 2.0 * rows * (c1 * c2 + c2 * c3),
            "f32": 9.0 * tests(pts, cents, r2) + 6.0 * rows * c1,
            "bytes": 12.0 * b * (n + m) + 4.0 * lo.numel()
            + 4.0 * (5 * c1 + c2 + c3) + 2.0 * (c1 * c2 + c2 * c3)
            + 4.0 * b * m * c3}
