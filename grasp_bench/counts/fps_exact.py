"""K6, exact farthest point sampling of B * G chains (whole scenes, or G
contiguous slices of each): ~10 f32 operations (3 sub, 3 mul, 2 add, min,
compare) per point of a chain per FPS step after the first; each point
read once, each index written once."""

NAMES = ("fps_cluster_kernel",)


def work(args, cfg):
    b, n, shards, m_g = args[1], args[2], args[3], args[4]
    return {"f32": 10.0 * b * n * (m_g - 1),
            "bytes": 12.0 * b * n + 4.0 * b * shards * m_g}
