"""K2, the sorted-slab ball query: 9 f32 operations (3 sub, 3 mul, 2 add,
compare) per (centroid, key) the data needs tested; points, centroids and
windows read once, indices and counts written once."""

from ._slab import tests

NAMES = ("ball_query_slab_kernel",)


def work(args, cfg):
    pts, cents, lo = args[0], args[1], args[2]
    b, n, m, r2, k = args[3], args[4], args[5], args[7], args[8]
    return {"f32": 9.0 * tests(pts, cents, r2),
            "bytes": b * (12.0 * (n + m) + 4.0 * m * (k + 1))
            + 4.0 * lo.numel()}
