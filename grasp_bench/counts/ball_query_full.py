"""K2f, the full-scan ball query: 9 f32 operations per (centroid, key)
the data needs tested (only each ball's slab where the points ascend
along a coordinate); points and centroids read once, indices and counts
written once."""

from ._slab import tests

NAMES = ("::warp_kernel", "::tile_kernel")


def work(args, cfg):
    pts, cents = args[0], args[1]
    b, n, m, r2, k = args[3], args[4], args[5], args[6], args[7]
    return {"f32": 9.0 * tests(pts, cents, r2),
            "bytes": b * (12.0 * (n + m) + 4.0 * m * (k + 1))}
