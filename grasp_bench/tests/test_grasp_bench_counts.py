"""Each kernel's counts file against a hand count at a small shape."""

import pytest
import torch

from grasp_bench.counts import (ball_query_full, ball_query_slab,
                                collision_counts, fps_lane,
                                gather_backward, sa1_fused, three_nn)

CFG = {"SA_CHANNELS": [[128, 128, 256]]}


def _line(n, step=0.01):
    """(1, 3, n) points ascending along x, `step` apart."""
    p = torch.zeros(1, 3, n)
    p[0, 0] = torch.arange(n) * step
    return p


def test_fps_lane():
    pts = torch.zeros(1, 3, 1024)
    one = fps_lane.work((pts, 1, 1024, 0, 256, 0, 0), CFG)
    assert one == {"f32": 10.0 * 1024 * 1, "bytes": 12.0 * 1024 + 4 * 256}
    nested = fps_lane.work((pts, 1, 1024, 2, 512, 256, 0), CFG)
    assert nested["f32"] == 10.0 * (1024 * 3 + 512 * 1)
    assert nested["bytes"] == 12.0 * 1024 + 4 * (512 + 256)


def test_three_nn():
    assert three_nn.work((None, None, 2, 4, 5), CFG) == {
        "f32": 9.0 * 2 * 20, "bytes": 2 * (12.0 * 9 + 24 * 4)}


def test_ball_query_tests_only_the_slab_of_ascending_points():
    pts = _line(10)
    cents = pts[:, :, [0, 5, 9]].contiguous()
    r2 = 0.015 ** 2        # neighbours 0.01 apart: the ball's slab holds 3
    args = (pts, cents, None, 1, 10, 3, r2, 4)
    work = ball_query_full.work(args, CFG)
    assert work["f32"] == 9.0 * (2 + 3 + 2)
    assert work["bytes"] == 12.0 * 13 + 4.0 * 3 * 5
    shuffled = pts[:, :, torch.tensor([3, 1, 0, 2, 4, 5, 6, 7, 9, 8])]
    work = ball_query_full.work((shuffled, cents) + args[2:], CFG)
    assert work["f32"] == 9.0 * 30
    lo = torch.zeros(1, 1, dtype=torch.int32)
    slab = ball_query_slab.work((pts, cents, lo, 1, 10, 3, 1, r2, 4), CFG)
    assert slab == {"f32": 9.0 * 7, "bytes": 12.0 * 13 + 4.0 * 15 + 4.0}


def test_sa1_fused_counts_the_rows_the_balls_hold():
    pts = _line(10)
    cents = pts[:, :, [0, 5]].contiguous()
    r2 = 0.015 ** 2
    lo = torch.zeros(1, 1, dtype=torch.int32)
    args = (pts, cents, lo, None, None, 1, 10, 2, 1, r2, 2, 256)
    work = sa1_fused.work(args, CFG)
    rows = 2 + 2          # 2 and 3 in range, k = 2
    assert work["bf16"] == 2.0 * rows * (128 * 128 + 128 * 256)
    assert work["f32"] == 9.0 * (2 + 3) + 6.0 * rows * 128


def test_collision_counts():
    g2l = torch.eye(4).repeat(3, 1, 1)
    cv = torch.tensor([[0.0, 0.0, 0.0, 1.0], [0.0, 0.0, 0.5, 1.0],
                       [0.0, 0.0, 0.0, 0.0]])
    hht = 0.012
    work = collision_counts.work((g2l, cv, 3, 3, 0.09, 0.16, hht), CFG)
    assert work["f32"] == 8.0 * 3 * 2 + 22.0 * 3 * 1
    assert work["bytes"] == 64.0 * 3 + 16.0 * 3 + 8.0 * 3


@pytest.mark.parametrize("dtype, size", [(0, 4), (1, 2), (2, 8)])
def test_gather_backward(dtype, size):
    grad = torch.zeros(6, 5)
    work = gather_backward.work((grad, None, None, 4, 5, dtype), CFG)
    assert work == {"f32": 30.0,
                    "bytes": (6 + 4) * 5 * size + 4.0 * (6 + 4 + 1)}
