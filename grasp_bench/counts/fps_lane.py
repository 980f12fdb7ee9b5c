"""K1, 128-shard farthest point sampling (one stage, or up to three
nested): ~10 f32 operations (3 sub, 3 mul, 2 add, min, compare) per point
of a shard per FPS step after the first; each point read once, each index
written once."""

NAMES = ("fps_nested_kernel", "fps_lane_kernel")
SHARDS = 128


def work(args, cfg):
    pts, b, n, nested = args[0], args[1], args[2], args[3]
    ms = [m for m in args[4:7] if m] if nested else [args[4]]
    sizes = [n, *ms]
    ops = sum(10.0 * b * sizes[i] * (sizes[i + 1] // SHARDS - 1)
              for i in range(len(ms)))
    return {"f32": ops, "bytes": 12.0 * b * n + sum(4.0 * b * m for m in ms)}
