"""K5, gripper-box point counts: a copy of `chip_smoke.py`'s `_k5_work`.
Every (pose, valid point) pair pays its z row (3 mul + 3 add) and the
z-slab test (~8 operations); only the pairs inside the slab pay the x and
y rows and the box tests (~22 more).  Poses and points read once, counts
written once."""

NAMES = ("collision_counts_kernel",)


def work(args, cfg):
    g2l, cv, g = args[0], args[1], args[2]
    hht = args[6]
    live = cv[:, 3] > 0.5
    pairs = float(g * int(live.sum()))
    pts = cv[live, :3]
    m = g2l.reshape(g, 16)
    in_z = 0
    for g0 in range(0, g, 128):
        mm = m[g0:g0 + 128, :, None]
        z = (pts[:, 0] * mm[:, 8] + pts[:, 1] * mm[:, 9]
             + pts[:, 2] * mm[:, 10] + mm[:, 11])
        in_z += int((z.abs() < hht).sum())
    return {"f32": 8.0 * pairs + 22.0 * in_z,
            "bytes": 64.0 * g + 16.0 * cv.shape[0] + 8.0 * g}
