"""K4, 3-NN selection: 9 f32 operations (3 sub, 3 mul, 2 add, compare)
per (query, key); queries and keys read once, indices and distances
written once.  A launch that splits the keys into chunks runs a second
kernel that merges the chunks' partial top-3s: its time is the launch's
too."""

NAMES = ("three_nn_kernel", "three_nn_merge_kernel")


def work(args, cfg):
    b, n1, n2 = args[2], args[3], args[4]
    return {"f32": 9.0 * b * n1 * n2,
            "bytes": b * (12.0 * (n1 + n2) + 24.0 * n1)}
