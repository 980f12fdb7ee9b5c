#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (s4g_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

It prints the card's name and power limit as nvidia-smi gives them, then
runs these phases; a failing phase is reported and the later ones still
run, but the run then exits non-zero without printing a result:

1. build: every kernel of the main paths compiled from
   `s4g_tpu_torch/csrc` with nvcc (one process per source, in parallel,
   then one link), loaded with ctypes; ptxas' report of every kernel
   (registers, shared memory, spills, performance advisories);
2. kernels: each of K1 (FPS), K2 (slab ball query), K4 (3-NN) and K5
   (collision counts) run at the main path's shapes on inputs taken from a
   seeded synthetic scene, held against its plain PyTorch twin on the card
   (bit for bit: indices, counts and distances), and timed with CUDA
   events (CUDA-graph replays of back-to-back launches, so host launch cost
   is excluded), beside its plain twin's time and its bound — K1 nested
   (the three SA stages in one launch, against the per-stage twin chained,
   with its chain floor, a model estimate, beside the bound) and per
   stage (the same stages, and 320-point shards that do not nest), K2 on the sorted scene (each
   ball scans its slab) and on the same keys shuffled inside each key
   tile (no coordinate ascends: whole windows); then K3 (the
   fused SA1 stage of detect_batch) at b = 2 on a tabletop and a clutter
   scene, held against its twin (zero rows exact, the rest within 1e-2 of
   the output's max: f32 sums in another order flip an odd bf16 rounding
   of a hidden activation), timed beside its twin, its bound and the
   unfused SA1 route at the same b = 2, and again on two tabletops (the
   windows fit: the input detect_batch hands K3), and on that pair's SA1
   inputs the launch shapes of the SA1_FUSE setting (K3 at b = 1 on its
   first scene, K2 at b = 2 bit for bit, `_setting_kernel_phase`); then K6
   (exact FPS) and K2f
   (full-scan ball query) at the reference-parity configuration's shapes
   (`curvature_model.yaml` with SORT_POINTS false and FPS_SHARDS 1) at
   b = 1 and 2, bit for bit (K6 also with 8 shards), timed beside their
   twins (K6 with the cluster size its launcher picks per stage and its
   chain floor, a model estimate),
   and K2f again at the deployed path's SA2 and SA3 (sorted
   scenes, the sort promise handed on; kept and broken), bit for bit,
   timed per scene against a bound of the distance tests the data needs,
   and at detect_batch's SA1 full-scan fallback (b = 2, tabletop and
   clutter) with and without the promise; K5's bound counts the operations
   its counts need on this data (every pair's z row and z-slab test, the
   rest only for pairs inside the z slab), beside its FMA-less floors
   (every pair in full, and that pruned count); then the inputs past the
   kernels' old ranges
   (`_fault_phase`: the fused SA1 stage at 256/256/512 through K2 + K7, a
   6-layer K7 chain, K2f at 50,000 and 100,000 keys, K6 at 40,000 and
   400,000 points per chain), each printed with its max |kernel - twin|
   against its
   tolerance; then K7 (the SharedMLP chain) at each of the ten chains of a
   b = 1 fused-chain forward, their inputs captured from a seeded tabletop,
   held against its twin (bf16 within 1e-2 of the output's max, as K3;
   f32 within 1e-5) plus one f32 case at SA2's shape, timed per forward
   beside its twin, its bound, the fused route as the model calls it (the
   packed-operand cache, casts and kernel launches) and the unfused route,
   with each chain's launches (FP1 and FP2 run one layer a launch);
3. reference: the detect stages at a narrow width that still takes every
   kernel route, on the GPU and on the CPU (plain twins), each stage fed
   the same inputs on both devices (see `_reference_phase`); then the
   detect_batch stages at b = 2 the same way, at a narrow width whose SA1
   the fused stage takes (`_batch_reference_phase`); then the detect
   stages at the narrow width of the parity configuration (K6 and K2f,
   `_parity_reference_phase`); then the first two again on the fused-chain
   route (K7 on the GPU, `_fused_reference_phase`); then the contact
   model's detect stages (`_contact_reference_phase`) and, on a bf16
   backbone, the detect stages with `CAST_ACTIVATIONS` on
   (`_cast_reference_phase`);
4. main paths: `GraspDetector(model="curvature_model").detect` at full width
   with seeded random weights on a synthetic camera-frame tabletop (a plane
   plus boxes), a few times, then a clutter scene; per-stage and total ms,
   the number of valid grasps, the rotations' orthonormality and whether
   the SA1 slab window overflowed; then `detect_batch` at b = 1, 2 and 4 on
   tabletops (timed; SA1 is K3 at b >= 2) and at b = 2 and 4 on tabletops
   mixed with clutter scenes, whose SA1 windows overflow (the full-scan
   fallback); then the parity configuration at full width
   (`_parity_phase`): detect x3, detect_batch at b = 2 and one eval; then
   one detect_batch at b = 2 on the sort-only ablation (SORT_POINTS,
   FPS_SHARDS 1: K6 feeding K3); then the fused-chain configuration
   (`_fused_phase`, the deployed detector with `nn_layers.MLP_IMPL`
   "fused"): detect x3, detect_batch at b = 2 x3, and one detect with the
   route on "auto" over the pooled SA chains only, then the route off and
   on in turns at b = 1 and 2 (uncounted, timed); then the contact model
   (`GraspDetector(model="contact_model")`, `_contact_phase`): detect x3
   on a tabletop and once on clutter, detect_batch at b = 2, one eval
   (a fresh model's grasp origins are its points, exactly), one
   fused-chain detect, and a checkpoint round trip through
   `last_checkpoint`; then the two model settings (`_settings_phase`):
   `SA1_FUSE` "1" (detect x3: K3 at b = 1), "0" (detect_batch b = 2: K2
   at b = 2) and `CAST_ACTIVATIONS` (one detect); then `detect_stream`
   (`_stream_phase`): 8 tabletop frames at depth 1, 2 and 3, each equal
   bit for bit to sequential `detect` on a detector with the same seed,
   frames/s of both and the host synchronizations of one frame's submit.
   Each run's launch counters are zeroed before it and read after it, and
   every kernel must
   launch exactly its count per forward (`_deployed_launches`,
   `_parity_launches`, `FUSED_K7_LAUNCHES`), given the SA1 overflows the
   run reported (the stream: per frame); over the counted fused-chain runs the packed-operand
   cache must hit on every chain and pack none;
5. profile: one detect, one detect_batch at b = 2, one parity detect and
   one fused-chain detect under torch.profiler — device time by kernel and
   the device's idle share.

Then one JSON line with every kernel's numbers and, last, the contract line
`{"ok": true, "device": {...}}`.  Without a CUDA device, or without the
package beside this script, it exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet, dense): f32 outside the
# tensor cores and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

NUM_DETECT = 3
NUM_BATCH = 3

# K7 launches per fused-chain forward at full width: every SharedMLP chain
# once, but FP1 and FP2 one layer a launch (their two layers' bf16 tiles do
# not fit one block's shared memory together): 10 chains in 12 launches at
# b = 1; 9 in 11 at b >= 2, where K3 takes SA1; the pooled scope fuses the
# three SA chains only.
FUSED_K7_LAUNCHES = {"detect": 12, "batch": 11, "pooled": 3}

# The ball query's slab capacity (`ops.neighbors.ball_query`): a sorted SA
# input above it takes K2, every other one K2f.
SLAB_CAPACITY = 6144


def _bound_ms(ops: float, nbytes: float):
    """Least time for `ops` f32 operations and `nbytes` of traffic."""
    t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def _event_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Median wall time of fn() on the card over `reps` CUDA-event-timed
    runs (host work included: for plain versions, whose host loop is part
    of their cost)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _graph_ms(fn, reps: int = 20, per_graph: int = 10) -> float:
    """Median device time of one fn() launch: `per_graph` launches captured
    in a CUDA graph, the replay timed with CUDA events, `reps` times."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_graph)
    return statistics.median(times)


def tabletop_cloud(rng, n_plane: int = 57000, n_box: int = 8000,
                   half_size=(0.55, 0.45)):
    """Seeded camera-frame tabletop, ~0.75 m from the camera: a plane (1.1 x
    0.9 m by default) plus five boxes (their tops and two sides), (n, 3)
    float32.  The default 65,000 points fit the 65,536-point capacity and
    keep ~26,600 voxels after the outlier filter, above the 25,600-point
    model input."""
    import numpy as np
    hx, hy = half_size
    xy = rng.uniform([-hx, -hy], [hx, hy], (n_plane, 2))
    parts = [np.column_stack([xy, 0.75 + 0.05 * xy[:, 1]])]
    per = n_box // 5
    for i in range(5):
        cx, cy = -0.3 + 0.15 * i, 0.1 * ((-1) ** i)
        sx, sy, h = 0.04 + 0.01 * i, 0.05, 0.05 + 0.03 * (i % 3)
        top = rng.uniform([-sx, -sy], [sx, sy], (per // 2, 2))
        parts.append(np.column_stack([cx + top[:, 0], cy + top[:, 1],
                                      np.full(per // 2, 0.75 - h)]))
        side = rng.uniform([-sx, 0.0], [sx, h], (per - per // 2, 2))
        ys = cy + np.where(rng.rand(len(side)) < 0.5, -sy, sy)
        parts.append(np.column_stack([cx + side[:, 0], ys,
                                      0.75 - side[:, 1]]))
    cloud = np.concatenate(parts)
    return (cloud + rng.normal(0.0, 0.001, cloud.shape)).astype(np.float32)


def clutter_cloud(rng, num_objects: int = 10, n_per_object: int = 450):
    """Seeded camera-frame clutter without a table (items on a wire shelf):
    4 cm objects ~0.7 m away, 15 cm apart, so that a good share of
    random-weight grasps clear the collision check."""
    import numpy as np
    grid = [(x, y) for y in (-0.1, 0.05) for x in np.linspace(-0.3, 0.3, 5)]
    parts = [np.array([x, y, rng.uniform(0.65, 0.75)])
             + rng.uniform(-0.02, 0.02, (n_per_object, 3))
             for x, y in grid[:num_objects]]
    return np.concatenate(parts).astype(np.float32)


def _check_grasps(label, results) -> float:
    """One call's grasps, [(poses, scores)] per scene: finite, (k, 4, 4)
    poses beside k scores, orthonormal rotations.  Returns the largest
    orthonormality error."""
    import numpy as np
    ortho = 0.0
    for poses, scores in results:
        if not (np.isfinite(poses).all() and np.isfinite(scores).all()
                and poses.shape[1:] == (4, 4) and len(poses) == len(scores)):
            raise AssertionError(f"{label}: malformed grasps")
        rot = poses[:, :3, :3].astype(np.float64)
        if len(rot):
            ortho = max(ortho, float(np.abs(np.einsum(
                "nij,nkj->nik", rot, rot) - np.eye(3)).max()))
    if ortho > 1e-4:
        raise AssertionError(f"{label}: rotations not orthonormal: {ortho}")
    return ortho


def _max_sm_clock_mhz() -> int:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True)
    return int(out.stdout.strip().splitlines()[0])


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _path_inputs(det, torch, np):
    """The main path's kernel inputs at full size, from one seeded scene:
    model input, widest-axis sort, the three FPS stages, SA1 windows, the
    3-NN pairs and the collision poses of a real forward pass."""
    from s4g_tpu_torch.models.pn2_modules import gather_cl
    from s4g_tpu_torch.ops.neighbors import _axis_keys, slab_windows
    from s4g_tpu_torch.ops.sampling import farthest_point_sample
    from s4g_tpu_torch.pipeline.detector import prep_one
    from s4g_tpu_torch.pipeline.postprocessing import post_process_predictions
    from s4g_tpu_torch.utils.math_utils import batch_transformation_inv

    cfg = det.cfg.MODEL.PN2
    cloud, valid = det._pad_cloud(tabletop_cloud(np.random.RandomState(7)))
    gen = torch.Generator(device=det.device).manual_seed(7)
    with torch.no_grad():
        points = prep_one(cloud, valid, det.num_input, generator=gen)
        xyz = points[None]
        spread = torch.amax(xyz, dim=1) - torch.amin(xyz, dim=1)
        axis = torch.argmax(spread, dim=1)
        keys = torch.gather(xyz, 2, axis[:, None, None]
                            .expand(-1, xyz.shape[1], 1))[..., 0]
        xyz = gather_cl(xyz, torch.argsort(keys, dim=1, stable=True))
        stages = [xyz.transpose(1, 2).contiguous()]
        for m in cfg.NUM_CENTROIDS:
            idx = farthest_point_sample(stages[-1], m, num_shards=128,
                                        sort_local=True)
            stages.append(gather_cl(stages[-1].transpose(1, 2), idx)
                          .transpose(1, 2).contiguous())
        r2 = cfg.RADIUS[0] ** 2
        lo_tile, overflow = slab_windows(_axis_keys(stages[0], axis),
                                         _axis_keys(stages[1], axis), r2,
                                         stages[0].shape[2])
        preds = det.net({"scene_points": points.t()[None].contiguous()})
        post = post_process_predictions(
            points.t(), preds["score"][0], preds["frame_R"][0],
            preds["frame_t"][0], 0.0, -1e9,
            num_candidates=det.num_candidates)
        g2l = batch_transformation_inv(post.poses).contiguous()
        cloud_valid = torch.cat([cloud, valid.float()[:, None]], dim=1)
    return {"stages": stages, "lo_tile": lo_tile, "overflow": bool(overflow),
            "radius": cfg.RADIUS[0], "k": cfg.NUM_NEIGHBOURS[0],
            "radii": cfg.RADIUS, "ks": cfg.NUM_NEIGHBOURS, "axis": axis,
            "g2l": g2l, "cloud_valid": cloud_valid.contiguous()}


def _slab_keys(pts, cents, lo_tile, r2: float) -> float:
    """Distance tests a sorted-slab selection needs on this data, summed over
    the centroids: where a coordinate ascends over the centroid tile's key
    window, only the window's keys within the ball's slab along it (the
    half-width 1.05 r + 1e-5 |c| of `sa1_fused.cu`'s `margin`: every key
    outside has d2 > r2), else the whole window."""
    import torch
    from s4g_tpu_torch.ops import neighbors as nb
    b, _, n = pts.shape
    m = cents.shape[2]
    r2 = torch.tensor(r2, dtype=torch.float32)
    total = 0
    for bi in range(b):
        for t, c0 in enumerate(range(0, m, nb.BQ_C_TILE)):
            keys = int(lo_tile[bi, t]) * nb.BQ_K_TILE + torch.arange(
                nb.BQ_WINDOW, device=pts.device)
            win = torch.where(keys < n, pts[bi][:, keys.clamp(max=n - 1)],
                              1e9)   # keys past N are padding
            c = cents[bi, :, c0:c0 + nb.BQ_C_TILE]
            axis = next((a for a in range(3)
                         if bool(torch.all(win[a, 1:] >= win[a, :-1]))), None)
            if axis is None:
                total += c.shape[1] * nb.BQ_WINDOW
                continue
            ca = c[axis]
            half = 1.05 * torch.sqrt(r2) + 1e-5 * ca.abs()
            lo = torch.searchsorted(win[axis], ca - half)
            hi = torch.searchsorted(win[axis], ca + half, right=True)
            total += int((hi - lo).sum())
    return float(total)


def _scene_slab_keys(pts, cents, axis, r2: float) -> float:
    """`_slab_keys` over whole scenes, as K2f scans them with the sort
    promise: where the scene's key coordinate along `axis` ascends, the
    keys within each ball's slab (the same half-width), else all N."""
    import torch
    b, _, n = pts.shape
    r2 = torch.tensor(r2, dtype=torch.float32, device=pts.device)
    total = 0
    for bi in range(b):
        ka = pts[bi, int(axis[bi])].contiguous()
        ca = cents[bi, int(axis[bi])]
        if not bool(torch.all(ka[1:] >= ka[:-1])):
            total += ca.numel() * n
            continue
        half = 1.05 * torch.sqrt(r2) + 1e-5 * ca.abs()
        lo = torch.searchsorted(ka, ca - half)
        hi = torch.searchsorted(ka, ca + half, right=True)
        total += int((hi - lo).sum())
    return float(total)


def _compare(name, got, want, exact):
    """Kernel outputs against the plain twin's: equal where `exact`, else
    within 1e-6.  Returns the max absolute difference."""
    import torch
    for g, w in zip(got, want):
        if exact and not torch.equal(g, w):
            bad = int((g != w).sum())
            raise AssertionError(f"{name}: {bad} entries differ from "
                                 "the plain version")
    err = max(float((g.double() - w.double()).abs().max())
              for g, w in zip(got, want))
    if err > 1e-6:
        raise AssertionError(f"{name}: max |kernel - plain| = {err}")
    return err


def _kernel_phase(inp, torch, extras):
    """Each kernel against its plain twin on the card, then timed; extra
    numbers per kernel go into `extras`."""
    from s4g_tpu_torch.ops import neighbors as nb
    from s4g_tpu_torch.ops import sampling as sp
    from s4g_tpu_torch.pipeline import collision as col

    st = inp["stages"]
    n_pts = [s.shape[2] for s in st]
    report = []

    # K1: the three FPS stages of the path in one nested launch, against
    # the per-stage twin chained (sort_local, then the picks' coordinates
    # as the next stage's cloud); then the per-stage kernel, at the same
    # three stages and at a shape that does not nest (320-point shards).
    ms_c = n_pts[1:]
    got = sp.fps_lane_nested(st[0], ms_c)
    err = _compare("fps_lane nested", got, sp._fps_nested_plain(st[0], ms_c),
                   True)
    ms = _graph_ms(lambda: sp.fps_lane_nested(st[0], ms_c))
    plain = _event_ms(lambda: sp._fps_nested_plain(st[0], ms_c), reps=5)
    fps_calls = [(st[i], n_pts[i + 1]) for i in range(3)]
    stage_err = max(_compare("fps_lane", [sp.fps_lane_sharded(p, m)],
                             [sp._fps_sharded_plain(p, m)], True)
                    for p, m in fps_calls)
    stage_ms = sum(_graph_ms(lambda p=p, m=m: sp.fps_lane_sharded(p, m))
                   for p, m in fps_calls)
    wide = torch.rand(1, 3, 128 * 320, generator=torch.Generator(
        device=st[0].device).manual_seed(3), device=st[0].device)
    wide = wide[:, :, torch.argsort(wide[0, 0])].contiguous()
    wide_m = 128 * 64
    if sp.fps_nesting_applies(wide.shape[2], [wide_m], 128):
        raise AssertionError("the per-stage shape must not nest")
    stage_err = max(stage_err, _compare(
        "fps_lane per stage, 320-point shards",
        [sp.fps_lane_sharded(wide, wide_m)],
        [sp._fps_sharded_plain(wide, wide_m)], True))
    wide_ms = _graph_ms(lambda: sp.fps_lane_sharded(wide, wide_m))
    # ~10 f32 operations (3 sub, 3 mul, 2 add, min, compare) per point per
    # FPS step; each point read once, each index written once.
    ops = sum(10.0 * n * (m // 128 - 1) for n, m in
              ((n_pts[i], n_pts[i + 1]) for i in range(3)))
    nbytes = 12 * n_pts[0] + sum(4 * m for m in ms_c)
    bound, by = _bound_ms(ops, nbytes)
    # The chain floor: a shard's argmax steps run one after another.  A step
    # issues ~15 instructions per register slot (3 sub, 3 mul, 2 add, min,
    # compare, 5 selects) on one warp, at most one a clock, then waits on
    # two warp reductions and the winner's coordinate shuffle (~30 clocks
    # each, dependent): 15 x slots + 90 clocks, at the card's top SM clock.
    # A model estimate from assumed latencies: printed, not in the kernels
    # line.
    clock_mhz = _max_sm_clock_mhz()
    cycles = sum((m // 128 - 1) * (15 * -(-(n // 128) // 32) + 90)
                 for n, m in zip(n_pts, ms_c))
    steps = sum(m // 128 - 1 for m in ms_c)
    floor = 1e3 * cycles / (clock_mhz * 1e6)
    extras["fps_lane"] = {
        "argmax_steps": steps, "sm_clock_max_mhz": clock_mhz,
        "per_stage_ms": stage_ms, "per_stage_max_abs_err": stage_err,
        "per_stage_320_point_shards_ms": wide_ms}
    print(f"kernel fps_lane: nested, {len(ms_c)} stages {n_pts} in one launch"
          f" {ms:.4f} ms, bound {bound:.6f} ms ({by}), chain floor (model "
          f"estimate, not measured) {floor:.5f} ms ({steps} argmax steps, "
          f"{cycles} clocks at {clock_mhz} MHz); "
          f"per-stage kernel at the same stages {stage_ms:.4f} ms (3 "
          f"launches), at {wide.shape[2]} -> {wide_m} (320-point shards, "
          f"not nested) {wide_ms:.4f} ms", flush=True)
    report.append(("fps_lane", "s4g_tpu_torch/csrc/fps_lane.cu",
                   "s4g_tpu/ops/sampling.py:287", max(err, stage_err), ms,
                   plain, bound, by))

    # K2: the SA1 slab ball query, on the sorted scene (the windows ascend
    # along the sort axis: each ball scans its slab) and on the same keys
    # shuffled inside each 2,048-key tile (every window holds the same keys,
    # out of order: no coordinate ascends, so the whole window is scanned).
    pts, cents, lo = st[0], st[1], inp["lo_tile"]
    r, k = inp["radius"], inp["k"]
    n1, m1 = pts.shape[2], cents.shape[2]
    perm = torch.cat([t0 + torch.randperm(
        min(nb.BQ_K_TILE, n1 - t0), generator=torch.Generator().manual_seed(t0))
        for t0 in range(0, n1, nb.BQ_K_TILE)]).to(pts.device)
    shuffled = pts[:, :, perm].contiguous()
    nbytes = 12 * (n1 + m1) + 4 * lo.numel() + 4 * m1 * (k + 1)
    k2 = {}
    for name, p in (("restricted", pts), ("unrestricted", shuffled)):
        err = _compare(f"ball_query_slab {name}",
                       nb.ball_query_fused_slab(p, cents, lo, r, k, True),
                       nb._ball_query_slab_plain(p, cents, lo, r * r, k,
                                                 True), True)
        ms = _graph_ms(lambda p=p: nb.ball_query_fused_slab(p, cents, lo, r,
                                                            k, True))
        # 9 f32 operations (3 sub, 3 mul, 2 add, compare) per (centroid,
        # key) that this data needs tested (`_slab_keys`).
        tested = _slab_keys(p, cents, lo, r * r)
        k2[name] = (err, ms, tested, *_bound_ms(9.0 * tested, nbytes))
        print(f"kernel ball_query_slab {name}: distance tests needed "
              f"{int(tested)} of {m1 * nb.BQ_WINDOW} in the windows; kernel "
              f"{ms:.4f} ms, bound {k2[name][3]:.6f} ms ({k2[name][4]})",
              flush=True)
    plain = _event_ms(lambda: nb._ball_query_slab_plain(pts, cents, lo,
                                                        r * r, k, True),
                      reps=5)
    err, ms, _, bound, by = k2["restricted"]
    u_err, u_ms, u_tested, u_bound, u_by = k2["unrestricted"]
    extras["ball_query_slab"] = {
        "unrestricted_ms": u_ms, "unrestricted_bound_ms": u_bound,
        "unrestricted_bound_by": u_by,
        "distance_tests_needed": k2["restricted"][2],
        "unrestricted_distance_tests": u_tested}
    report.append(("ball_query_slab", "s4g_tpu_torch/csrc/ball_query_slab.cu",
                   "s4g_tpu/ops/pallas/neighbor_kernels.py:145",
                   max(err, u_err), ms, plain, bound, by))

    # K4: the two FP stages above the 2^22-pair threshold.
    nn_calls = [(st[1], st[2]), (st[0], st[1])]
    sms = nb.sm_count(st[0].device)
    chunks = [nb.three_nn_key_chunk(1, q.shape[2], kk.shape[2], sms)
              for q, kk in nn_calls]
    # Indices and distances bit for bit, against the twin in the kernel's
    # key chunks and in one pass.
    err = max(_compare("three_nn", nb.three_nn_fused(q, kk),
                       nb._three_nn_plain(q, kk, c), True)
              for (q, kk), c in zip(nn_calls, chunks))
    err = max(err, *(_compare("three_nn one pass", nb.three_nn_fused(q, kk),
                              nb._three_nn_plain(q, kk), True)
                     for q, kk in nn_calls))
    ms = sum(_graph_ms(lambda q=q, kk=kk: nb.three_nn_fused(q, kk))
             for q, kk in nn_calls)
    plain = sum(_event_ms(lambda q=q, kk=kk: nb._three_nn_plain(q, kk),
                          reps=5) for q, kk in nn_calls)
    # 9 f32 operations (3 sub, 3 mul, 2 add, compare) per (query, key).
    ops = sum(9.0 * q.shape[2] * kk.shape[2] for q, kk in nn_calls)
    nbytes = sum(12 * (q.shape[2] + kk.shape[2]) + 24 * q.shape[2]
                 for q, kk in nn_calls)
    print(f"kernel three_nn: {sms} SMs, keys per block " + ", ".join(
        f"{q.shape[2]}<-{kk.shape[2]}: {c}"
        for (q, kk), c in zip(nn_calls, chunks)), flush=True)
    report.append(("three_nn", "s4g_tpu_torch/csrc/three_nn.cu",
                   "s4g_tpu/ops/pallas/neighbor_kernels.py:58", err, ms,
                   plain, *_bound_ms(ops, nbytes)))

    # K5: collision counts of the candidate poses against the padded cloud.
    g2l, cv = inp["g2l"], inp["cloud_valid"]
    want = col._collision_counts_plain(g2l, cv)
    err = _compare("collision_counts", col.collision_counts(g2l, cv), want,
                   True)
    ms = _graph_ms(lambda: col.collision_counts(g2l, cv))
    # The same rows in a depth camera's raster order (the synthetic scene's
    # rows are in random order): image row, then column, of a 600-pixel
    # focal length projection; padding last.  Counts do not depend on the
    # order, so they must equal the twin's on the unordered rows.
    proj = torch.round(600.0 * cv[:, :2] / cv[:, 2:3])
    key = torch.where(cv[:, 3] > 0.5, proj[:, 1] * 4096.0 + proj[:, 0],
                      float("inf"))
    cv_raster = cv[torch.argsort(key)].contiguous()
    err = max(err, _compare("collision_counts raster order",
                            col.collision_counts(g2l, cv_raster), want, True))
    ms_raster = _graph_ms(lambda: col.collision_counts(g2l, cv_raster))
    plain = _event_ms(lambda: col._collision_counts_plain(g2l, cv), reps=5)
    # The operations the counts need on this data: every (pose, valid
    # point) pair pays its z row (3 mul + 3 add) and the z-slab test (~8);
    # only the pairs inside the z slab pay the x and y rows and the box
    # tests (~22 more).  Pairs outside the slab count 0 whatever x and y
    # are, so no more is needed (as `_slab_keys` counts K2's and K3's
    # needed distance tests).
    g = g2l.shape[0]
    live = cv[:, 3] > 0.5
    pairs = float(g * int(live.sum()))
    nbytes = 64 * g + 16 * cv.shape[0] + 8 * g
    # FMA-less floors, in FP32 instructions at one per lane per clock (half
    # the FMA-counted peak): ~28 a pair when every pair is tested in full
    # (6 mul + 6 add + 3 rounded row sums' adds, 10 compares, selects), and
    # the pruned count above.
    pts = cv[live, :3]
    m = g2l.reshape(g, 16)
    in_z = 0
    for g0 in range(0, g, 128):
        mm = m[g0:g0 + 128, :, None]
        z = (pts[:, 0] * mm[:, 8] + pts[:, 1] * mm[:, 9]
             + pts[:, 2] * mm[:, 10] + mm[:, 11])
        in_z += int((z.abs() < col._BOX[2]).sum())
    ops = 8.0 * pairs + 22.0 * in_z
    bound, by = _bound_ms(ops, nbytes)
    rate = PEAK_F32_FLOPS / 2
    extras["collision_counts"] = {
        "floor_ms": 1e3 * 28.0 * pairs / rate,
        "pruned_floor_ms": 1e3 * ops / rate,
        "pairs": pairs, "pairs_in_z_slab": float(in_z),
        "raster_order_ms": ms_raster}
    print(f"kernel collision_counts: {g} poses x {int(live.sum())} valid of "
          f"{cv.shape[0]} rows, {pairs:.4g} pairs, {in_z} ({in_z / pairs:.4f})"
          f" inside the z slab; bound {bound:.5f} ms ({by}); FMA-less floor "
          f"{extras['collision_counts']['floor_ms']:.5f} ms, pruned "
          f"{extras['collision_counts']['pruned_floor_ms']:.5f} ms; kernel "
          f"{ms:.4f} ms on the scene's rows, {ms_raster:.4f} ms on the same "
          f"rows in raster order", flush=True)
    report.append(("collision_counts", "s4g_tpu_torch/csrc/collision_counts.cu",
                   "s4g_tpu/ops/pallas/collision_kernels.py:33", err, ms,
                   plain, bound, by))
    return report


def _batch_sa1_inputs(det, torch, np, clutter: bool = True):
    """K3's inputs on the detect_batch path at b = 2, from a seeded tabletop
    and a seeded clutter scene (or, without `clutter`, a second tabletop:
    a pair whose windows fit, as detect_batch hands K3): model input, each
    scene's widest-axis sort, the SA1 FPS, then the fused stage's windows
    (and the slab ball query's, for the unfused route)."""
    from s4g_tpu_torch.models.pn2_modules import gather_cl
    from s4g_tpu_torch.ops.neighbors import _axis_keys, slab_windows
    from s4g_tpu_torch.ops.sa_fused import sa1_slab_setup
    from s4g_tpu_torch.ops.sampling import farthest_point_sample
    from s4g_tpu_torch.pipeline.detector import prep_batch

    cfg = det.cfg.MODEL.PN2
    second = (clutter_cloud(np.random.RandomState(8)) if clutter
              else tabletop_cloud(np.random.RandomState(9)))
    padded, valid = zip(*(det._pad_cloud(c) for c in (
        tabletop_cloud(np.random.RandomState(7)), second)))
    gen = torch.Generator(device=det.device).manual_seed(7)
    r, n = cfg.RADIUS[0], det.num_input
    with torch.no_grad():
        xyz = prep_batch(torch.stack(padded), torch.stack(valid), n,
                         generator=gen)
        axis = torch.argmax(torch.amax(xyz, dim=1) - torch.amin(xyz, dim=1),
                            dim=1)
        keys = torch.gather(xyz, 2, axis[:, None, None].expand(-1, n, 1))
        xyz = gather_cl(xyz, torch.argsort(keys[..., 0], dim=1, stable=True))
        pts = xyz.transpose(1, 2).contiguous()
        idx = farthest_point_sample(pts, cfg.NUM_CENTROIDS[0], num_shards=128,
                                    sort_local=True)
        cents = gather_cl(xyz, idx).transpose(1, 2).contiguous()
        pkeys, ckeys = _axis_keys(pts, axis), _axis_keys(cents, axis)
        lo_tile, overflow = sa1_slab_setup(pkeys, ckeys, r, n)
        lo_k2, _ = slab_windows(pkeys, ckeys, r * r, n)
    return {"pts": pts, "cents": cents, "lo_tile": lo_tile, "axis": axis,
            "overflow": bool(overflow), "lo_k2": lo_k2, "radius": r,
            "k": cfg.NUM_NEIGHBOURS[0], "mlp": det.net.sa_modules[0].mlp}


def _k3_phase(inp, torch):
    """K3 against its plain twin on the card, then timed beside the twin, its
    bound and (for information) the unfused SA1 route at the same b: K2 +
    gather + the three PointConv layers + max."""
    from s4g_tpu_torch.ops import neighbors as nb
    from s4g_tpu_torch.ops import sa_fused as sf

    pts, cents, lo, r, k = (inp["pts"], inp["cents"], inp["lo_tile"],
                            inp["radius"], inp["k"])
    b, _, n = pts.shape
    m = cents.shape[2]
    mlp = inp["mlp"]
    with torch.no_grad():
        (w1, b1), (w2, b2), (w3, b3) = mlp.folded_params()
        args = (pts, cents, lo, r, k, w1, b1, (w2, w3), (b2, b3))
        got = sf.sa1_fused_slab(*args)
        torch.cuda.synchronize()
        want = sf._sa1_fused_plain(*args)
        cnt = nb._ball_query_slab_plain(pts, cents, lo, r * r, k, True)[1]
    empty = cnt == 0
    if torch.any(got[empty] != 0) or torch.any(want[empty] != 0):
        raise AssertionError("sa1_fused: a centroid with no key in range "
                             "has a non-zero row")
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if not err <= 1e-2 * scale:
        raise AssertionError(f"sa1_fused: max |kernel - plain| = {err} > "
                             f"1e-2 x max |plain| = {1e-2 * scale}")
    differ = float((got != want).double().mean())

    def unfused():
        idx, cnt2 = nb.ball_query_fused_slab(pts, cents, inp["lo_k2"], r, k,
                                             True)
        keys = nb.flat_gather_rows(pts.transpose(1, 2),
                                   idx.reshape(b, m * k)).reshape(b, m, k, 3)
        rel = keys - cents.transpose(1, 2)[:, :, None, :]
        rel = torch.where(cnt2[..., None, None] > 0, rel, 0.0)
        return mlp(rel, max_pool_k=k)

    with torch.no_grad():
        ms = _graph_ms(lambda: sf.sa1_fused_slab(*args))
        plain = _event_ms(lambda: sf._sa1_fused_plain(*args), reps=5)
        unfused_ms = _graph_ms(unfused)
    # Work this run's data needs: each centroid's `count` distinct slots
    # through the chain (a repeated slot never changes the max); 9 f32
    # operations per (centroid, key) that the selection must test
    # (`_slab_keys`) and 6 per layer-1 unit.
    c1, c2, c3 = w1.shape[1], w2.shape[1], w3.shape[1]
    rows = float(cnt.sum())
    tested = _slab_keys(pts, cents, lo, r * r)
    t_ops = (2.0 * rows * (c1 * c2 + c2 * c3) / PEAK_BF16_FLOPS
             + (9.0 * tested + 6.0 * rows * c1) / PEAK_F32_FLOPS)
    nbytes = (12 * b * (n + m) + 4 * lo.numel()
              + 4 * (3 * c1 + c1 + c1 * c2 + c2 + c2 * c3 + c3)
              + 4 * b * m * c3)
    t_bytes = nbytes / PEAK_BYTES
    bound = 1e3 * max(t_ops, t_bytes)
    by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"kernel sa1_fused inputs: b={b}, N={n}, M={m}, K={k}, widths "
          f"{c1}/{c2}/{c3}, windows overflow={inp['overflow']}, selected "
          f"rows {int(rows)} of {b * m * k}, empty centroids "
          f"{int(empty.sum())}, distance tests needed {int(tested)} of "
          f"{b * m * nb.BQ_WINDOW} in the windows", flush=True)
    print(f"kernel sa1_fused: max|kernel-plain|={err:.3g} (max|plain| "
          f"{scale:.3g}), entries that differ {differ:.3e}; unfused SA1 "
          f"route (K2 + gather + 3 PointConv + max) at b={b}: "
          f"{unfused_ms:.4f} ms", flush=True)
    return ("sa1_fused", "s4g_tpu_torch/csrc/sa1_fused.cu",
            "s4g_tpu/ops/pallas/sa_fused_kernels.py:84", err, ms, plain, bound,
            by)


def _setting_kernel_phase(binp, torch, extras):
    """The two launch shapes the SA1_FUSE setting adds, on SA1's inputs of
    a detect_batch on two tabletops (`_batch_sa1_inputs(..., clutter=
    False)`): K3 at b = 1 on the first scene (SA1_FUSE "1"), held as
    `_k3_phase` holds it, and K2 at b = 2 on both (SA1_FUSE "0"), bit for
    bit against its twin; each timed beside its twin and its bound, into
    `extras`."""
    from s4g_tpu_torch.ops import neighbors as nb

    one = {**binp, **{key: binp[key][:1].contiguous()
                      for key in ("pts", "cents", "lo_tile", "lo_k2")}}
    _, _, _, err, ms, plain, bound, by = _k3_phase(one, torch)
    extras.setdefault("sa1_fused", {}).update(
        b1_ms=ms, b1_max_abs_err=err, b1_plain_ms=plain, b1_bound_ms=bound,
        b1_bound_by=by)
    pts, cents, lo = binp["pts"], binp["cents"], binp["lo_k2"]
    r, k = binp["radius"], binp["k"]
    b, _, n = pts.shape
    m = cents.shape[2]
    err = _compare("ball_query_slab b=2",
                   nb.ball_query_fused_slab(pts, cents, lo, r, k, True),
                   nb._ball_query_slab_plain(pts, cents, lo, r * r, k, True),
                   True)
    ms = _graph_ms(lambda: nb.ball_query_fused_slab(pts, cents, lo, r, k,
                                                    True))
    plain = _event_ms(lambda: nb._ball_query_slab_plain(pts, cents, lo,
                                                        r * r, k, True),
                      reps=5)
    # As at b = 1: 9 f32 operations per distance test this data needs.
    tested = _slab_keys(pts, cents, lo, r * r)
    bound, by = _bound_ms(9.0 * tested, b * (12 * (n + m) + 4 * m * (k + 1))
                          + 4 * lo.numel())
    extras.setdefault("ball_query_slab", {}).update(
        b2_ms=ms, b2_max_abs_err=err, b2_plain_ms=plain, b2_bound_ms=bound,
        b2_bound_by=by)
    print(f"kernel ball_query_slab b=2 (SA1_FUSE 0): distance tests needed "
          f"{int(tested)} of {b * m * nb.BQ_WINDOW} in the windows; kernel "
          f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bound:.6f} ms ({by})",
          flush=True)


NARROW = {
    "MODEL": {"TYPE": "PN2_CLS", "COMPUTE_DTYPE": "float32", "PN2": {
        "NUM_INPUT": 8192, "NUM_CENTROIDS": (1024, 256, 128),
        "RADIUS": (0.02, 0.08, 0.32), "NUM_NEIGHBOURS": (32, 32, 32),
        "SA_CHANNELS": ((32, 32, 64), (64, 64, 64), (64, 64, 128)),
        "FP_CHANNELS": ((64, 64), (64, 64), (64, 64, 32)),
        "NUM_FP_NEIGHBOURS": (3, 3, 3), "SEG_CHANNELS": (64, 32),
        "SORT_POINTS": True, "FPS_SHARDS": 128}},
    "DATA": {"SCORE_CLASSES": 3},
}


def _reference_phase(torch, np, devices=("cpu", "cuda"), config=NARROW,
                     prepare=None, tol=(1e-4, None)):
    """Detect stages at a narrow width that still takes every kernel route
    (by default: slab SA1 at N = 8192, 3-NN 8192 <- 1024, collision 8192 x
    16384), on a clutter scene, on the GPU (kernels) and on the CPU (plain
    twins), each stage fed the same inputs on both devices:

    * preprocessing: the voxel means must match exactly; the radius outlier
      mask (matmul-form distances, summed differently by cuBLAS and the CPU
      BLAS) within 0.1 % of the points;
    * model, on the same sampled points: predictions within `tol` (max,
      and mean where given; 1e-4 by default, an f32 config);
    * post-processing, collision check and importance sampling, both fed
      the GPU's predictions, with every sampled point a candidate: the
      score-sorted scores within 1e-6 relative, and 99 % of the candidates
      with a twin pose within 1e-5 (the candidate of the nearest
      translation) that agrees on validity.

    Random weights score the points within a few ulps of each other, so
    the two devices' exp order the candidates differently: a top-K smaller
    than the point count would hold other points on each device, and the
    importance draws land on other candidates.  And with random weights
    the raw rotation columns can be short, so normalising them turns the
    model's ~1e-6 device differences into large pose differences: hence
    post-processing gets the same predictions on both devices.
    `prepare(net)` adjusts the seeded weights before the runs."""
    from s4g_tpu_torch.configs import processing_config as proc
    from s4g_tpu_torch.configs.config import load_cfg_from_dict
    from s4g_tpu_torch.models import build_model
    from s4g_tpu_torch.pipeline.detector import post_one, prep_one
    from s4g_tpu_torch.pipeline.postprocessing import REAL2TRAIN
    from s4g_tpu_torch.pipeline.preprocessing import (radius_outlier_mask,
                                                      voxel_downsample)

    rng = np.random.RandomState(3)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        net = build_model(load_cfg_from_dict(config))
    if prepare is not None:
        prepare(net)
    cap, n_in = 16384, 8192
    n_cand = n_in
    cloud = clutter_cloud(rng)
    padded = np.full((cap, 3), 1e6, np.float32)
    padded[:len(cloud)] = cloud
    valid = np.arange(cap) < len(cloud)
    uniforms = torch.from_numpy(rng.rand(5).astype(np.float32))
    out, sample_idx = {}, None
    for dev in devices:
        net = net.to(dev)
        c, v = (torch.from_numpy(padded).to(dev),
                torch.from_numpy(valid).to(dev))
        with torch.no_grad():
            train = c @ torch.tensor(REAL2TRAIN[:3, :3], device=dev).t()
            vox = voxel_downsample(train, torch.ones_like(v), proc.VOXEL_SIZE,
                                   cap)
            keep = radius_outlier_mask(vox.points, vox.valid,
                                       proc.RADIUS_THRESHOLD,
                                       proc.NUM_POINTS_THRESHOLD)
            if sample_idx is None:   # draw once, from the CPU's keep mask
                kept = np.nonzero(keep.numpy())[0]
                sample_idx = torch.from_numpy(rng.choice(
                    kept, n_in, replace=len(kept) < n_in))
            points = prep_one(c, v, n_in, sample_idx=sample_idx.to(dev))
            preds = net({"scene_points": points.t()[None].contiguous()})
        out[dev] = {"vox": vox.points.cpu(), "keep": keep.cpu(),
                    "points": points.cpu(),
                    "preds": {k: p[0].cpu() for k, p in preds.items()}}
    cpu, gpu = out[devices[0]], out[devices[1]]
    if not torch.equal(cpu["vox"], gpu["vox"]):
        raise AssertionError("voxel means differ between GPU and CPU")
    keep_diff = int((cpu["keep"] != gpu["keep"]).sum())
    if keep_diff > 1e-3 * cap:
        raise AssertionError(f"outlier masks differ at {keep_diff} points")
    diffs = [(cpu["preds"][k] - gpu["preds"][k]).abs() for k in gpu["preds"]]
    pred_err = max(float(d.max()) for d in diffs)
    pred_mean = max(float(d.mean()) for d in diffs)
    if not (pred_err <= tol[0] and (tol[1] is None or pred_mean <= tol[1])):
        raise AssertionError(f"predictions differ by {pred_err} (max), "
                             f"{pred_mean} (mean); tolerance {tol}")

    res = {}
    for dev in devices:
        with torch.no_grad():
            r = post_one(gpu["points"].to(dev),
                         {k: p.to(dev) for k, p in gpu["preds"].items()},
                         torch.from_numpy(padded).to(dev),
                         torch.from_numpy(valid).to(dev), uniforms.to(dev),
                         0.0, -1e9, n_cand)
        res[dev] = {k: p.cpu().numpy() for k, p in r.items()}
    stats = _compare_grasps(res[devices[0]], res[devices[1]], n_cand, torch,
                            np)
    return {"keep_mismatch": keep_diff, "max_pred_err": pred_err,
            "max_mean_pred_err": pred_mean, **stats}


def _compare_grasps(cpu, gpu, n_cand, torch, np):
    """Post-processing outputs of one scene on the two devices, fed the same
    predictions: the score-sorted scores within 1e-6 relative, and 99 % of
    the candidates with a twin pose within 1e-5 (the candidate of the
    nearest translation) that agrees on validity."""
    if int(gpu["num_valid"]) == 0:
        raise AssertionError("no valid grasp to compare")
    score_err = float(np.abs(gpu["scores"] - cpu["scores"]).max()
                      / np.abs(cpu["scores"]).max())
    if not score_err <= 1e-6:
        raise AssertionError(f"candidate scores differ by {score_err} (rel)")
    near = torch.cdist(torch.from_numpy(gpu["poses"][:, :3, 3]).double(),
                       torch.from_numpy(cpu["poses"][:, :3, 3]).double()
                       ).argmin(dim=1).numpy()
    pose_err = np.abs(gpu["poses"] - cpu["poses"][near]).max(axis=(1, 2))
    twins = pose_err <= 1e-5
    agree = twins & (gpu["valid"] == cpu["valid"][near])
    if agree.mean() < 0.99:
        raise AssertionError(
            f"grasps differ: {int(twins.sum())}/{n_cand} have a twin, "
            f"{int(agree.sum())} agree on validity; valid "
            f"{int(gpu['num_valid'])} (GPU) vs {int(cpu['num_valid'])} (CPU)")
    return {"max_score_rel_err": score_err,
            "grasps_with_twin": int(twins.sum()),
            "grasps_agreeing": int(agree.sum()), "candidates": n_cand,
            "num_valid_gpu": int(gpu["num_valid"]),
            "num_valid_cpu": int(cpu["num_valid"]),
            "same_selection": bool(np.array_equal(gpu["selected"],
                                                  cpu["selected"]))}


# NARROW with an SA1 that the fused stage (K3) takes at batch >= 2.
NARROW_K3 = {**NARROW, "MODEL": {**NARROW["MODEL"], "PN2": {
    **NARROW["MODEL"]["PN2"],
    "SA_CHANNELS": ((128, 128, 256), (64, 64, 64), (64, 64, 128))}}}


def _batch_reference_phase(torch, np, devices=("cpu", "cuda")):
    """detect_batch's stages at b = 2 (two clutter scenes) at a narrow width
    whose SA1 is K3, on the GPU and on the CPU (plain
    twins), each stage fed the same inputs on both devices:

    * prep on the same draws: the model inputs must match exactly;
    * model at b = 2: predictions within the bf16 tolerances of the JAX
      package's own tests (max 5e-2, mean 5e-3), because K3 rounds hidden
      activations to bf16 after f32 sums taken in another order than its
      twin's;
    * post-processing per scene, fed the GPU's predictions on both devices,
      as `_reference_phase` holds it."""
    from s4g_tpu_torch import _build
    from s4g_tpu_torch.configs import processing_config as proc
    from s4g_tpu_torch.configs.config import load_cfg_from_dict
    from s4g_tpu_torch.models import build_model
    from s4g_tpu_torch.pipeline.detector import post_batch, prep_batch
    from s4g_tpu_torch.pipeline.postprocessing import REAL2TRAIN
    from s4g_tpu_torch.pipeline.preprocessing import preprocess_cloud

    rng = np.random.RandomState(4)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(4)
        net = build_model(load_cfg_from_dict(NARROW_K3))
    cap, n_in = 16384, 8192
    clouds = [clutter_cloud(rng), clutter_cloud(rng, num_objects=8)]
    padded = np.full((2, cap, 3), 1e6, np.float32)
    for i, c in enumerate(clouds):
        padded[i, :len(c)] = c
    valid = np.arange(cap)[None] < np.array([[len(c)] for c in clouds])
    uniforms = torch.from_numpy(rng.rand(2, 5).astype(np.float32))
    sample_idx = []
    rot = torch.tensor(REAL2TRAIN[:3, :3]).t()
    for i in range(2):   # draw from the CPU's keep mask
        keep = preprocess_cloud(
            torch.from_numpy(padded[i]) @ rot, num_points=n_in, capacity=cap,
            voxel_size=proc.VOXEL_SIZE, outlier_radius=proc.RADIUS_THRESHOLD,
            outlier_min_neighbors=proc.NUM_POINTS_THRESHOLD,
            sample_idx=torch.zeros(n_in, dtype=torch.long)).raw_valid
        kept = np.nonzero(keep.numpy())[0]
        sample_idx.append(rng.choice(kept, n_in, replace=len(kept) < n_in))
    sample_idx = torch.from_numpy(np.stack(sample_idx))
    out = {}
    for dev in devices:
        net = net.to(dev)
        c = torch.from_numpy(padded).to(dev)
        v = torch.from_numpy(valid).to(dev)
        before = _build.LAUNCHES["sa1_fused"]
        with torch.no_grad():
            points = prep_batch(c, v, n_in, sample_idx=sample_idx.to(dev))
            preds = net({"scene_points": points.transpose(1, 2).contiguous()})
        if dev != "cpu" and _build.LAUNCHES["sa1_fused"] != before + 1:
            raise AssertionError("the b = 2 forward did not launch K3")
        out[dev] = {"points": points.cpu(),
                    "preds": {k: p.cpu() for k, p in preds.items()}}
    cpu, gpu = out[devices[0]], out[devices[1]]
    if not torch.equal(cpu["points"], gpu["points"]):
        raise AssertionError("model inputs differ between GPU and CPU")
    diffs = [(cpu["preds"][k] - gpu["preds"][k]).abs() for k in gpu["preds"]]
    pred_err = max(float(d.max()) for d in diffs)
    pred_mean = max(float(d.mean()) for d in diffs)
    if not (pred_err <= 5e-2 and pred_mean <= 5e-3):
        raise AssertionError(f"predictions differ by {pred_err} (max), "
                             f"{pred_mean} (mean)")
    res = {}
    for dev in devices:
        with torch.no_grad():
            r = post_batch(gpu["points"].to(dev),
                           {k: p.to(dev) for k, p in gpu["preds"].items()},
                           torch.from_numpy(padded).to(dev),
                           torch.from_numpy(valid).to(dev), uniforms.to(dev),
                           0.0, -1e9, n_in)
        res[dev] = {k: p.cpu().numpy() for k, p in r.items()}
    scenes = [_compare_grasps({k: v[i] for k, v in res[devices[0]].items()},
                              {k: v[i] for k, v in res[devices[1]].items()},
                              n_in, torch, np) for i in range(2)]
    return {"max_pred_err": pred_err, "max_mean_pred_err": pred_mean,
            "scenes": scenes}


# NARROW as the reference-parity configuration: exact FPS (K6), full-scan
# ball queries.
NARROW_PARITY = {**NARROW, "MODEL": {**NARROW["MODEL"], "PN2": {
    **NARROW["MODEL"]["PN2"], "SORT_POINTS": False, "FPS_SHARDS": 1}}}


def _parity_reference_phase(torch, np, devices=("cpu", "cuda")):
    """`_reference_phase` at NARROW_PARITY: on the GPU every FPS is K6 and
    every ball query K2f (each must launch), on the CPU their plain twins;
    checked as `_reference_phase` checks."""
    from s4g_tpu_torch import _build

    before = dict(_build.LAUNCHES)
    out = _reference_phase(torch, np, devices, config=NARROW_PARITY)
    idle = [k for k in ("fps_exact", "ball_query_full")
            if _build.LAUNCHES[k] == before[k]]
    if devices[1] != "cpu" and idle:
        raise AssertionError(f"the parity forward did not launch {idle}")
    return out


# NARROW as the contact model (PN2: regression translation, 6-D rotation).
NARROW_CONTACT = {**NARROW, "MODEL": {**NARROW["MODEL"], "TYPE": "PN2"}}
# NARROW with a bf16 backbone, where CAST_ACTIVATIONS changes the numbers.
NARROW_BF16 = {**NARROW, "MODEL": {**NARROW["MODEL"],
                                   "COMPUTE_DTYPE": "bfloat16"}}


def _small_t_logit(net):
    """Seeded translation residuals of a few millimetres for a contact
    model (a fresh one's are zero), so that grasp origins leave their
    points but stay on the cloud."""
    import torch
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        net.t_logit.weight.normal_(0.0, 0.01, generator=gen)
        net.t_logit.bias.normal_(0.0, 0.002, generator=gen)


def _contact_reference_phase(torch, np, devices=("cpu", "cuda")):
    """`_reference_phase` at NARROW_CONTACT: the contact model's detect
    stages (its regression post-processing included) on the GPU and on the
    CPU, with small translation residuals (`_small_t_logit`)."""
    return _reference_phase(torch, np, devices, config=NARROW_CONTACT,
                            prepare=_small_t_logit)


def _cast_reference_phase(torch, np, devices=("cpu", "cuda")):
    """`_reference_phase` at NARROW_BF16 with `CAST_ACTIVATIONS` on (every
    PointConv hands on bf16): predictions within the bf16 tolerances of
    the JAX package's own tests (max 5e-2, mean 5e-3)."""
    with _layer_settings(CAST_ACTIVATIONS=True):
        return _reference_phase(torch, np, devices, config=NARROW_BF16,
                                tol=(5e-2, 5e-3))


def _output_dir(name: str) -> str:
    """An empty detector output directory (checkpoints, debug dumps) inside
    the (gitignored) build directory."""
    import shutil
    from s4g_tpu_torch import _build
    path = os.path.join(_build.BUILD_DIR, "output", name)
    shutil.rmtree(path, ignore_errors=True)
    return path


def _config_file(name: str, model=None, **pn2) -> str:
    """A variant of the port's curvature_model.yaml: MODEL keys `model` and
    PN2 keys `pn2` replaced, written as `name`.yaml into the (gitignored)
    build directory.  Returns its path."""
    import yaml
    from s4g_tpu_torch import _build
    from s4g_tpu_torch.pipeline.detector import _CONFIG_DIR
    with open(os.path.join(_CONFIG_DIR, "curvature_model.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["MODEL"].update(model or {})
    cfg["MODEL"]["PN2"].update(pn2)
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    path = os.path.join(_build.BUILD_DIR, f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def _parity_inputs(det, torch, np):
    """The parity path's FPS and ball-query operands at full size, from two
    seeded tabletops (b = 1 takes the first): the model inputs and the
    three exact-FPS stages of a parity forward."""
    from s4g_tpu_torch.models.pn2_modules import gather_cl
    from s4g_tpu_torch.ops.sampling import fps_exact
    from s4g_tpu_torch.pipeline.detector import prep_batch

    cfg = det.cfg.MODEL.PN2
    padded, valid = zip(*(det._pad_cloud(tabletop_cloud(
        np.random.RandomState(s))) for s in (7, 9)))
    gen = torch.Generator(device=det.device).manual_seed(7)
    with torch.no_grad():
        xyz = prep_batch(torch.stack(padded), torch.stack(valid),
                         det.num_input, generator=gen)
        stages = [xyz.transpose(1, 2).contiguous()]
        for m in cfg.NUM_CENTROIDS:
            idx = fps_exact(stages[-1], m)
            stages.append(gather_cl(stages[-1].transpose(1, 2), idx)
                          .transpose(1, 2).contiguous())
    return {"stages": stages, "radius": cfg.RADIUS,
            "k": cfg.NUM_NEIGHBOURS}


# K6's critical path per argmax step, in clocks: a model estimate from
# assumed latencies, measured by nothing in this script, so it is printed
# but kept out of the kernels line (PERF.md, section 6).  The relax, ~15
# issue clocks a register slot (3 sub, 3 mul, 2 add, min, compare,
# selects), then a fixed chain: the warp argmax (2 redux, ~60),
# the warp winners' meeting in shared memory with a block barrier and 2
# more redux (~150), the winner's coordinates (~60), the st.async push to
# the peers' mbarriers (~200), the wait's wake-up (~40) and the argmax of
# the C messages (~130).
K6_SLOT_CLOCKS = 15
K6_STEP_CLOCKS = 640


def _k6_slots(ns: int, blocks: int) -> int:
    """Register slots a K6 thread relaxes per step (the launcher's PPT)."""
    per_block, slots = -(-ns // blocks), 1
    while slots < 16 and per_block > slots * 512:
        slots *= 2
    return slots


def _k6_phase(inp, torch, extras):
    """K6 against its plain twin, bit for bit: the parity path's three FPS
    stages at b = 1 and b = 2, and the 8-shard case at SA1's shape; then
    timed (CUDA-graph replays) beside the plain loop, timed once per stage:
    it is thousands of steps of a few launches each.  Prints the cluster
    size chosen per stage, the times per stage at b = 1 and 2, the chain
    floor (a model estimate, `K6_STEP_CLOCKS`) beside the bound."""
    from s4g_tpu_torch.ops import sampling as sp

    st = inp["stages"]
    calls = {b: [(st[i][:b].contiguous(), st[i + 1].shape[2])
                 for i in range(3)] for b in (1, 2)}
    err = 0.0
    for b, cs in calls.items():
        for p, m in cs:
            err = max(err, _compare(f"fps_exact b={b} N={p.shape[2]}",
                                    [sp.fps_exact(p, m)],
                                    [sp._fps_plain(p, m)], True))
    p8, m8 = calls[1][0]
    err = max(err, _compare("fps_exact 8 shards",
                            [sp.fps_sharded(p8, m8, 8)],
                            [sp._fps_sharded_plain(p8, m8, 8)], True))
    ns = [p.shape[2] for p, _ in calls[1]] + [calls[1][-1][1]]
    blocks = [sp.fps_exact_plan(n)[0] for n in ns[:3]]
    stage_ms = {b: [_graph_ms(lambda p=p, m=m: sp.fps_exact(p, m), reps=5,
                              per_graph=3) for p, m in cs]
                for b, cs in calls.items()}
    ms, ms_b2 = sum(stage_ms[1]), sum(stage_ms[2])
    ms_g8 = _graph_ms(lambda: sp.fps_sharded(p8, m8, 8), reps=5)
    plain = sum(_event_ms(lambda p=p, m=m: sp._fps_plain(p, m), reps=1,
                          warmup=0) for p, m in calls[1])
    # 9 f32 operations (3 sub, 3 mul, 2 add, min) per point per step; each
    # point read once, each index written once.
    ops = sum(9.0 * ns[i] * (ns[i + 1] - 1) for i in range(3))
    nbytes = sum(12 * ns[i] + 4 * ns[i + 1] for i in range(3))
    clock_mhz = _max_sm_clock_mhz()
    cycles = sum((ns[i + 1] - 1) * (K6_SLOT_CLOCKS * _k6_slots(ns[i],
                                                                blocks[i])
                                    + K6_STEP_CLOCKS) for i in range(3))
    steps = sum(ns[i + 1] - 1 for i in range(3))
    floor = 1e3 * cycles / (clock_mhz * 1e6)
    extras["fps_exact"] = {
        "cluster_blocks_per_stage": blocks, "per_stage_ms_b1": stage_ms[1],
        "per_stage_ms_b2": stage_ms[2], "per_forward_ms_b2": ms_b2,
        "eight_shards_ms": ms_g8,
        "argmax_steps": steps, "sm_clock_max_mhz": clock_mhz}
    print(f"kernel fps_exact: cluster blocks per stage {blocks} for "
          f"{ns[:3]}-point chains; per stage at b=1 "
          f"{', '.join(f'{t:.4f}' for t in stage_ms[1])} ms, at b=2 "
          f"{', '.join(f'{t:.4f}' for t in stage_ms[2])} ms; per forward "
          f"b=1 {ms:.4f} ms, b=2 {ms_b2:.4f} ms; chain floor (model "
          f"estimate, not measured) {floor:.4f} ms ({steps} argmax steps, "
          f"{cycles} clocks at {clock_mhz} MHz); 8 shards at SA1 "
          f"{ms_g8:.4f} ms", flush=True)
    return ("fps_exact", "s4g_tpu_torch/csrc/fps_exact.cu",
            "s4g_tpu/ops/sampling.py:81", err, ms, plain,
            *_bound_ms(ops, nbytes))


def _k2f_phase(inp, torch, path, fallback, extras):
    """K2f against the plain full scan (`_ball_query_full`), indices and
    counts exact, stratified off and on, at the parity path's SA1, SA2 and
    SA3 shapes at b = 1 and b = 2; then timed per forward at b = 1 beside
    the plain full scan, the "auto" route.  Then the deployed path's SA2
    and SA3 (`path`: sorted scenes, the sort promise handed on,
    stratified), bit for bit, also with a broken promise, timed per scene
    beside the same calls without the promise, against a bound that counts
    only the distance tests the data needs (`_scene_slab_keys`); and the
    SA1 full-scan fallback of detect_batch at b = 2 on a tabletop and a
    clutter scene (`fallback`, whose K3 windows overflow), bit for bit,
    timed with the promise (detect_batch's route) and without it (the
    route before detect_batch handed it on: the tile kernel)."""
    from s4g_tpu_torch.ops import neighbors as nb

    st_d, axis = path["stages"], path["axis"]
    dcalls = [(st_d[i], st_d[i + 1], path["radii"][i], path["ks"][i])
              for i in (1, 2)]
    for p, c, r, k in dcalls:
        want = nb._ball_query_full(p, c, r * r, k, stratified=True)
        broken = p.clone()
        broken[0, int(axis[0]), [3, -3]] = broken[0, int(axis[0]), [-3, 3]]
        _compare(f"ball_query_full deployed N={p.shape[2]}",
                 nb.ball_query_full_scan(p, c, r, k, True, sorted_axis=axis),
                 want, True)
        _compare(f"ball_query_full deployed N={p.shape[2]} broken promise",
                 nb.ball_query_full_scan(broken, c, r, k, True,
                                         sorted_axis=axis),
                 nb._ball_query_full(broken, c, r * r, k, stratified=True),
                 True)
    d_ms = [_graph_ms(lambda a=a: nb.ball_query_full_scan(
        *a, True, sorted_axis=axis)) for a in dcalls]
    u_ms = [_graph_ms(lambda a=a: nb.ball_query_full_scan(*a, True))
            for a in dcalls]
    tested = sum(_scene_slab_keys(p, c, axis, r * r) for p, c, r, _ in dcalls)
    pairs = sum(float(p.shape[2] * c.shape[2]) for p, c, _, _ in dcalls)
    d_bound, d_by = _bound_ms(9.0 * tested, sum(
        12 * (p.shape[2] + c.shape[2]) + 4 * c.shape[2] * (k + 1)
        for p, c, _, k in dcalls))
    print(f"kernel ball_query_full deployed SA2 + SA3 per scene: "
          f"{sum(d_ms):.4f} ms (SA2 {d_ms[0]:.4f}, SA3 {d_ms[1]:.4f}); "
          f"without the sort promise {sum(u_ms):.4f} ms (SA2 {u_ms[0]:.4f}, "
          f"SA3 {u_ms[1]:.4f}); distance tests needed {int(tested)} of "
          f"{int(pairs)}; bound {d_bound:.5f} ms ({d_by})", flush=True)

    p, c, r, k, fa = (fallback["pts"], fallback["cents"], fallback["radius"],
                      fallback["k"], fallback["axis"])
    _compare("ball_query_full SA1 fallback b=2",
             nb.ball_query_full_scan(p, c, r, k, True, sorted_axis=fa),
             nb._ball_query_full(p, c, r * r, k, stratified=True), True)
    f_ms = _graph_ms(lambda: nb.ball_query_full_scan(p, c, r, k, True,
                                                     sorted_axis=fa))
    fu_ms = _graph_ms(lambda: nb.ball_query_full_scan(p, c, r, k, True))
    f_tested = _scene_slab_keys(p, c, fa, r * r)
    f_bound, f_by = _bound_ms(9.0 * f_tested, p.shape[0] * (
        12 * (p.shape[2] + c.shape[2]) + 4 * c.shape[2] * (k + 1)))
    print(f"kernel ball_query_full SA1 fallback at b=2 (tabletop + "
          f"clutter, K3 windows overflow={fallback['overflow']}): "
          f"{f_ms:.4f} ms with the sort promise, {fu_ms:.4f} ms "
          f"without; distance tests needed {int(f_tested)} of "
          f"{p.shape[0] * p.shape[2] * c.shape[2]}; bound {f_bound:.5f} ms "
          f"({f_by})", flush=True)
    extras["ball_query_full"] = {
        "deployed_sa2_sa3_ms": sum(d_ms), "deployed_no_promise_ms": sum(u_ms),
        "deployed_sa2_ms": d_ms[0], "deployed_sa3_ms": d_ms[1],
        "deployed_bound_ms": d_bound, "deployed_tests_needed": tested,
        "deployed_pairs": pairs, "sa1_fallback_b2_ms": f_ms,
        "sa1_fallback_b2_no_promise_ms": fu_ms,
        "sa1_fallback_b2_bound_ms": f_bound}

    st, radii, ks = inp["stages"], inp["radius"], inp["k"]
    err = 0.0
    for b in (1, 2):
        for i in range(3):
            p, c = st[i][:b].contiguous(), st[i + 1][:b].contiguous()
            for strat in (False, True):
                err = max(err, _compare(
                    f"ball_query_full b={b} SA{i + 1} stratified={strat}",
                    nb.ball_query_full_scan(p, c, radii[i], ks[i], strat),
                    nb._ball_query_full(p, c, radii[i] ** 2, ks[i],
                                        stratified=strat), True))
    calls = [(st[i][:1].contiguous(), st[i + 1][:1].contiguous(), radii[i],
              ks[i]) for i in range(3)]
    stage_ms = [_graph_ms(lambda a=a: nb.ball_query_full_scan(*a))
                for a in calls]
    ms = sum(stage_ms)
    plain = sum(_event_ms(lambda p=p, c=c, r=r, k=k: nb._ball_query_full(
        p, c, r * r, k), reps=5) for p, c, r, k in calls)
    # 9 f32 operations (3 sub, 3 mul, 2 add, compare) per (centroid, key).
    ops = sum(9.0 * c.shape[2] * p.shape[2] for p, c, _, _ in calls)
    nbytes = sum(12 * (p.shape[2] + c.shape[2]) + 4 * c.shape[2] * (k + 1)
                 for p, c, _, k in calls)
    print(f"kernel ball_query_full: per stage at b=1 "
          f"{', '.join(f'{t:.4f}' for t in stage_ms)} ms", flush=True)
    return ("ball_query_full", "s4g_tpu_torch/csrc/ball_query_full.cu",
            "s4g_tpu/ops/pallas/neighbor_kernels.py:343", err, ms, plain,
            *_bound_ms(ops, nbytes))


def _fault_phase(binp, torch, np, extras):
    """The inputs past each kernel's old range, on the card against the
    twins: the fused SA1 stage at widths 256/256/512 (K2 + K7, on
    detect_batch's b = 2 tabletop inputs; zero rows exact, the rest within
    1e-2 of the output's max), a 6-layer pooled K7 chain (two launches;
    bf16 within 1e-2, f32 within 1e-5), one K7 layer wider than any row
    tile (7,300 bf16 / 3,700 f32 input channels, pooled and not; same
    tolerances), K2f at 50,000 and 100,000 keys
    with and without the sort promise and K6 at 40,000 points per chain
    (both bit for bit).  Prints each case's max |kernel - twin| against its
    tolerance; raises if one fails."""
    from s4g_tpu_torch.ops import mlp_chain as mc
    from s4g_tpu_torch.ops import neighbors as nb
    from s4g_tpu_torch.ops import sa_fused as sf
    from s4g_tpu_torch.ops import sampling as sp

    rng = np.random.RandomState(11)
    dev = binp["pts"].device
    cases, failed = {}, []

    def record(kernel, name, err, tol, **more):
        ok = err <= tol
        cases.setdefault(kernel, {})[name] = {
            "max_abs_err": err, "tolerance": tol, "pass": ok, **more}
        print(f"fault case {kernel} {name}: max|kernel-twin|={err:.3g}, "
              f"tolerance {tol:.3g}: {'pass' if ok else 'FAIL'}"
              + "".join(f", {k} {v}" for k, v in more.items()), flush=True)
        if not ok:
            failed.append(f"{kernel} {name}")

    def rand(*shape, scale=0.1):
        return torch.from_numpy((rng.randn(*shape) * scale)
                                .astype(np.float32)).to(dev)

    # K3 outside its range: 256/256/512 at K = 64.
    pts, cents, lo, r, k = (binp["pts"], binp["cents"], binp["lo_tile"],
                            binp["radius"], binp["k"])
    w = (rand(3, 256, scale=0.5), rand(256), (rand(256, 256), rand(256, 512)),
         (rand(256), rand(512)))
    with torch.no_grad():
        got = sf.sa1_fused_slab(pts, cents, lo, r, k, *w)
        torch.cuda.synchronize()
        want = sf._sa1_fused_plain(pts, cents, lo, r, k, *w)
        cnt = nb._ball_query_slab_plain(pts, cents, lo, r * r, k, True)[1]
        ms = _graph_ms(lambda: sf.sa1_fused_slab(pts, cents, lo, r, k, *w))
    empty = cnt == 0
    if torch.any(got[empty] != 0):
        failed.append("sa1_fused wide: non-zero empty rows")
    scale = float(want.abs().max())
    record("sa1_fused", "wide_256_256_512", float((got - want).abs().max()),
           1e-2 * scale, ms=round(ms, 5), empty_rows=int(empty.sum()))

    # K7: a 6-layer pooled chain, split 4 + 2.
    widths = (3, 64, 64, 128, 128, 256, 256)
    x = rand(4096 * 64, 3, scale=0.05)
    params = [(rand(a, b, scale=1 / np.sqrt(a)), rand(b))
              for a, b in zip(widths, widths[1:])]
    relu = (True,) * 6
    for cd, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-5)):
        with torch.no_grad():
            got = mc.mlp_chain(x, params, relu, 64, cd)
            torch.cuda.synchronize()
            want = mc._mlp_chain_plain(x, params, relu, 64, cd)
        record("mlp_chain", f"six_layers_{str(cd)[6:]}",
               float((got - want).abs().max()),
               tol * float(want.abs().max()),
               pieces=mc.chain_pieces(widths, 64, cd))

    # K7: one layer wider than any row tile (its input channels split in
    # the kernel), pooled and not.
    for width, cd, tol in ((7300, torch.bfloat16, 1e-2),
                           (3700, torch.float32, 1e-5)):
        x = rand(4096, width, scale=1.0)
        params = [(rand(width, 256, scale=1 / np.sqrt(width)), rand(256))]
        for pool in (None, 32):
            with torch.no_grad():
                got = mc.mlp_chain(x, params, (True,), pool, cd)
                torch.cuda.synchronize()
                want = mc._mlp_chain_plain(x, params, (True,), pool, cd)
                ms = _graph_ms(lambda: mc.mlp_chain(x, params, (True,), pool,
                                                    cd))
            record("mlp_chain", f"wide_{width}_{str(cd)[6:]}_pool{pool or 0}",
                   float((got - want).abs().max()),
                   tol * float(want.abs().max()), ms=round(ms, 5),
                   pieces=mc.chain_pieces((width, 256), pool, cd))

    # K2f past 41,568 keys, sorted (the promise kept and broken) and not.
    for n, m, rad, kk in ((50000, 1024, 0.05, 64), (100000, 512, 0.3, 64)):
        p = torch.from_numpy((rng.rand(1, 3, n) * [[[1.1], [0.9], [0.3]]])
                             .astype(np.float32)).to(dev)
        p = p[:, :, torch.argsort(p[0, 0])].contiguous()
        c = p[:, :, torch.from_numpy(np.sort(rng.choice(n, m, False))
                                     ).to(dev)].contiguous()
        axis = torch.zeros(1, dtype=torch.long, device=dev)
        want = nb._ball_query_full(p, c, rad * rad, kk, stratified=True)
        err = 0.0
        for promise in (None, axis):
            err = max(err, _compare(f"ball_query_full N={n}",
                                    nb.ball_query_full_scan(
                                        p, c, rad, kk, True,
                                        sorted_axis=promise), want, True))
        record("ball_query_full", f"n{n}", err, 0.0)

    # K6 past 32,768 points per chain, and past what its cluster's shared
    # memory holds (the rest of the coordinates from L2, min-distances in
    # the scratch buffer).
    for n, m in ((40000, 256), (400000, 24)):
        p = torch.from_numpy(rng.rand(1, 3, n).astype(np.float32)).to(dev)
        err = _compare(f"fps_exact N={n}", [sp.fps_exact(p, m)],
                       [sp._fps_plain(p, m)], True)
        record("fps_exact", f"n{n}", err, 0.0,
               plan=sp.fps_exact_plan(n))

    for kernel, named in cases.items():
        extras.setdefault(kernel, {})["fault_cases"] = named
    if failed:
        raise AssertionError(f"fault cases failed: {failed}")


def _chain_inputs(det, torch, np):
    """Each SharedMLP chain of a b = 1 fused-chain forward of `det` at full
    width, as `SharedMLP.fused_eval` receives it, from a seeded tabletop:
    [(module name, module, x, max_pool_k)], in call order."""
    from s4g_tpu_torch.models import nn_layers
    from s4g_tpu_torch.pipeline.detector import prep_one

    captured = []
    orig = nn_layers.SharedMLP.fused_eval

    def capture(self, x, max_pool_k=None):
        captured.append((self, x.clone(), max_pool_k))
        return orig(self, x, max_pool_k)

    cloud, valid = det._pad_cloud(tabletop_cloud(np.random.RandomState(7)))
    gen = torch.Generator(device=det.device).manual_seed(7)
    nn_layers.SharedMLP.fused_eval = capture
    try:
        with _layer_settings(MLP_IMPL="fused"), torch.no_grad():
            points = prep_one(cloud, valid, det.num_input, generator=gen)
            det.net({"scene_points": points.t()[None].contiguous()})
    finally:
        nn_layers.SharedMLP.fused_eval = orig
    names = {id(m): n for n, m in det.net.named_modules()}
    return [(names[id(m)], m, x, k) for m, x, k in captured]


def _k7_case(name, mlp, x, k, cd, torch):
    """K7 on one chain against its twin on the card, then timed: the kernel
    alone (packed weights, one launch a piece), the twin and, at the
    module's own compute dtype, the fused route as the model runs it
    (`fused_eval`: the packed-operand cache, casts, kernel) and the unfused
    route (`SharedMLP.forward` with the route off).  Returns the
    numbers."""
    from s4g_tpu_torch.ops import mlp_chain as mc

    with torch.no_grad():
        params = mlp.folded_params()
        flat = x.reshape(-1, x.shape[-1])
        relu = (True,) * len(params)
        got = mc.mlp_chain(flat, params, relu, k, cd)
        torch.cuda.synchronize()
        want = mc._mlp_chain_plain(flat, params, relu, k, cd)
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    # f32: sums in another order; bf16: an f32 sum in another order flips an
    # odd bf16 rounding of a hidden activation (as for K3).
    tol = 1e-5 if cd == torch.float32 else 1e-2
    if not (scale > 0 and err <= tol * scale):
        raise AssertionError(f"mlp_chain {name} ({cd}): max |kernel - plain| "
                             f"= {err} > {tol} x max |plain| = {scale}")
    equal = float((got == want).double().mean())
    packed = mc._pack(params, flat.shape[1], cd)
    widths = [flat.shape[1]] + [w.shape[1] for w, _ in params]
    pieces = mc.chain_pieces(widths, k, cd)
    # The kernel alone: one launch a piece, each on its input as the route
    # hands it over (made here, outside the timing).
    runs, h = [], flat
    with torch.no_grad():
        for a, b in pieces:
            pool = k if b == len(params) else None
            inp = mc._kernel_input(h, packed[a:b], pool)
            runs.append((inp, packed[a:b], relu[a:b], pool))
            h = mc._launch(*runs[-1])
    launches = len(runs)
    with torch.no_grad():
        ms = _graph_ms(lambda: [mc._launch(*r) for r in runs])
        plain = _event_ms(lambda: mc._mlp_chain_plain(flat, params, relu, k,
                                                      cd), reps=5)
        route = unfused = float("nan")
        if cd == mlp[0].dtype:
            route = _graph_ms(lambda: mlp.fused_eval(x, k))
            with _layer_settings(MLP_IMPL="unfused"):
                unfused = _graph_ms(lambda: mlp(x, max_pool_k=k))
    flop = 2.0 * flat.shape[0] * sum(a * b for a, b in zip(widths, widths[1:]))
    xc = runs[0][0]
    nbytes = (flat.shape[0] * flat.shape[1] * xc.element_size()
              + 4 * got.numel()
              + sum(w.numel() * xc.element_size() + 4 * b.numel()
                    for w, b in params))
    print(f"kernel mlp_chain {name} ({str(cd)[6:]}): rows {flat.shape[0]}, "
          f"widths {widths}, pool {k}, {launches} launches; max|kernel-"
          f"plain|={err:.3g} (max|plain| {scale:.3g}), bit-equal share "
          f"{equal:.4f}; kernel {ms:.4f} ms, fused route {route:.4f}, "
          f"unfused route {unfused:.4f}, plain {plain:.4f}", flush=True)
    return {"err": err, "ms": ms, "plain": plain, "route": route,
            "unfused": unfused, "flop": flop, "bytes": nbytes,
            "launches": launches}


def _k7_phase(chains, torch):
    """K7 at each chain of a b = 1 fused-chain forward (bf16 at full width),
    then one f32 case at SA2's chain; per-forward sums of the bf16 cases
    against the bf16 bound."""
    cases = [_k7_case(name, mlp, x, k, mlp[0].dtype, torch)
             for name, mlp, x, k in chains]
    name, mlp, x, k = next(c for c in chains if c[0] == "sa_modules.1.mlp")
    f32 = _k7_case(name, mlp, x, k, torch.float32, torch)
    tot = {key: sum(c[key] for c in cases) for key in cases[0]}
    per_chain = {n: {key: c[key] for key in ("ms", "route", "unfused",
                                             "launches")}
                 for (n, _, _, _), c in zip(chains, cases)}
    t_ops = tot["flop"] / PEAK_BF16_FLOPS
    t_bytes = tot["bytes"] / PEAK_BYTES
    print(f"kernel mlp_chain: {len(cases)} chains per b=1 forward in "
          f"{tot['launches']} launches, "
          f"{tot['flop']:.3e} FLOP, {tot['bytes'] / 1e6:.1f} MB; kernel "
          f"{tot['ms']:.4f} ms, fused route {tot['route']:.4f} ms, unfused "
          f"route {tot['unfused']:.4f} ms, plain {tot['plain']:.4f} ms; f32 "
          f"at SA2 {f32['ms']:.4f} ms (err {f32['err']:.3g})", flush=True)
    report = ("mlp_chain", "s4g_tpu_torch/csrc/mlp_chain.cu",
              "s4g_tpu/ops/pallas/mlp_kernels.py:31",
              max(max(c["err"] for c in cases), f32["err"]),
              tot["ms"], tot["plain"], 1e3 * max(t_ops, t_bytes),
              "operations" if t_ops >= t_bytes else "bytes")
    return report, {"unfused_ms": tot["unfused"],
                    "fused_route_ms": tot["route"],
                    "launches_per_b1_forward": tot["launches"],
                    "f32_sa2_ms": f32["ms"], "per_chain": per_chain}


def _fused_reference_phase(torch, np, devices=("cpu", "cuda")):
    """`_reference_phase` and `_batch_reference_phase` on the fused-chain
    route: on the GPU every chain is K7 (10 at b = 1; 9 at b = 2, where K3
    takes SA1), on the CPU its twin; checked as those phases check."""
    from s4g_tpu_torch import _build

    with _layer_settings(MLP_IMPL="fused"), _k7_plans() as plans:
        before = _build.LAUNCHES["mlp_chain"]
        one = _reference_phase(torch, np, devices)
        mid = _build.LAUNCHES["mlp_chain"]
        n_one = len(plans)
        two = _batch_reference_phase(torch, np, devices)
    counts = (mid - before, _build.LAUNCHES["mlp_chain"] - mid)
    chains = tuple(sum(cuda for cuda, _ in part)
                   for part in (plans[:n_one], plans[n_one:]))
    planned = tuple(sum(n for cuda, n in part if cuda)
                    for part in (plans[:n_one], plans[n_one:]))
    if devices[1] != "cpu" and (chains != (10, 9) or counts != planned):
        raise AssertionError(f"fused-chain forwards ran {chains} chains on "
                             f"the card, expected (10, 9), in {counts} K7 "
                             f"launches, planned {planned}")
    return {"b1": one, "b2": two, "k7_launches": counts}


@contextlib.contextmanager
def _k7_plans():
    """Record every fused chain run inside as (on the card, the launches
    `mlp_chain.chain_pieces` plans for it there: one a piece)."""
    from s4g_tpu_torch.models import nn_layers
    from s4g_tpu_torch.ops import mlp_chain as mc

    plans = []
    orig = nn_layers.SharedMLP.fused_eval

    def spy(self, x, max_pool_k=None):
        widths = [x.shape[-1]] + [layer.conv.out_channels for layer in self]
        plans.append((x.is_cuda, len(mc.chain_pieces(
            widths, max_pool_k, self[0].dtype))))
        return orig(self, x, max_pool_k)

    nn_layers.SharedMLP.fused_eval = spy
    try:
        yield plans
    finally:
        nn_layers.SharedMLP.fused_eval = orig


def _fused_phase(det, torch, np):
    """The fused-chain configuration at full width (the deployed detector
    with `MLP_IMPL` "fused"): detect x3 on a tabletop (K7 12 times per
    forward: `FUSED_K7_LAUNCHES`), detect_batch at b = 2 x3 (11: K3 takes
    SA1), then one detect with the route on "auto", MLP_FUSE_MIN_ROWS 1
    and MLP_FUSE_SCOPE "pooled" (the three SA chains).  Each run is warmed
    up, then counted on its own, every kernel exactly
    (`_deployed_launches`); the packed-operand cache must hit on every
    chain of the counted detects and pack none.  Then the route off and on
    in turns at b = 1 and 2, for the end-to-end comparison.  Returns each
    run's launches, stage medians and the cache's counts."""
    from s4g_tpu_torch import _build
    from s4g_tpu_torch.models import nn_layers

    scenes = _scenes(np)
    kw = {"score_threshold": 0.0, "verticalness_threshold": -1e9}
    pair = [scenes["tabletop0"], scenes["tabletop2"]]
    paths, medians = {}, {}
    runs = [("fused_detect", "fused-chain detect", 1, NUM_DETECT,
             FUSED_K7_LAUNCHES["detect"], {"MLP_IMPL": "fused"}),
            ("fused_batch", "fused-chain detect_batch b=2", 2, NUM_BATCH,
             FUSED_K7_LAUNCHES["batch"], {"MLP_IMPL": "fused"}),
            ("fused_pooled_detect", "pooled-scope detect", 1, 1,
             FUSED_K7_LAUNCHES["pooled"],
             {"MLP_IMPL": "auto", "MLP_FUSE_MIN_ROWS": 1,
              "MLP_FUSE_SCOPE": "pooled"})]
    cache = {}
    for path, label, b, reps, chains, settings in runs:
        def call():
            if b == 1:
                return [det.detect(scenes["tabletop0"], **kw)]
            return det.detect_batch(pair, **kw)
        with _layer_settings(**settings):
            call()
            _build.reset_launches()
            timings, expected = [], {}
            before = dict(nn_layers.PACK_CACHE)
            for _ in range(reps):
                results, want = _counted(det, call, b, chains)
                expected = _add(expected, want)
                _check_grasps(label, results)
                timings.append(dict(det.timings))
            cache[path] = {k: nn_layers.PACK_CACHE[k] - before[k]
                           for k in before}
        paths[path] = dict(_build.LAUNCHES)
        print(f"{label}: packed-operand cache over {reps} counted forwards "
              f"{cache[path]}", flush=True)
        if cache[path]["packs"] or not cache[path]["hits"]:
            raise AssertionError(f"{label}: the packed-operand cache "
                                 f"re-packed: {cache[path]}")
        _expect(label, paths[path], 1, expected)
        medians[label] = _stage_medians(label, timings)
        print(f"{label}: num_valid {det.last_num_valid}", flush=True)

    # The route off ("auto", the deployed default) and on ("fused") in turns,
    # off-on-on-off twice per batch size, so that the host clock's drift
    # falls on both sides of the end-to-end comparison.
    for b, call in ((1, lambda: det.detect(scenes["tabletop0"], **kw)),
                    (2, lambda: det.detect_batch(pair, **kw))):
        turns = {"auto": [], "fused": []}
        for impl in ("auto", "fused", "fused", "auto") * 2:
            with _layer_settings(MLP_IMPL=impl):
                call()
            turns[impl].append(dict(det.timings))
        name = "detect" if b == 1 else f"detect_batch b={b}"
        for impl, runs in turns.items():
            medians[f"{name} in turns, {impl}"] = _stage_medians(
                f"{name} in turns, MLP_IMPL {impl}", runs)
    return paths, medians, cache


def _contact_phase(det, torch, np, model: str = "contact_model"):
    """The contact model (`GraspDetector(model="contact_model")`, PN2) at
    full width with seeded random weights: detect x3 on a tabletop and
    once on clutter, detect_batch at b = 2 on tabletops, then one eval
    and one detect on the fused-chain route (K7 as for PN2_CLS: the same
    ten chains).  Each run warmed up, counted on its own, every kernel
    exactly (`_deployed_launches`: the backbone is the deployed one).  A
    fresh model's translation head is zero, so eval's grasp origins are
    its input points exactly; its rotations must be orthonormal.  Then a
    checkpoint round trip at full width: the weights saved with
    `Checkpointer` into the detector's output directory make a second
    detector of `model` there (its `last_checkpoint`) give the same
    predictions.
    Returns each run's launches and stage medians."""
    from s4g_tpu_torch import _build
    from s4g_tpu_torch.pipeline.detector import GraspDetector, prep_one
    from s4g_tpu_torch.utils.checkpoint import Checkpointer

    scenes = _scenes(np)
    kw = {"score_threshold": 0.0, "verticalness_threshold": -1e9}
    pair = [scenes["tabletop0"], scenes["tabletop2"]]
    paths, medians = {}, {}
    det.detect(scenes["tabletop0"], **kw)
    det.detect_batch(pair, **kw)

    _build.reset_launches()
    expected, runs, found = {}, [], {}
    for name in ["tabletop0"] * NUM_DETECT + ["clutter1"]:
        (poses, scores), want = _counted(det, lambda: det.detect(
            scenes[name], **kw), 1)
        expected = _add(expected, want)
        if name == "tabletop0":
            runs.append(dict(det.timings))
        found[name] = (poses, scores, det.last_num_valid)
    paths["contact_detect"] = dict(_build.LAUNCHES)
    _expect("contact detect", paths["contact_detect"], 1, expected)
    medians["detect"] = _stage_medians("contact detect tabletop", runs)
    for name, (poses, scores, num_valid) in found.items():
        ortho = _check_grasps(f"contact {name}", [(poses, scores)])
        print(f"contact detect {name}: num_valid {num_valid}, {len(poses)} "
              f"grasps returned, max orthonormality error {ortho:.2e}",
              flush=True)

    _build.reset_launches()
    results, want = _counted(det, lambda: det.detect_batch(pair, **kw), 2)
    _check_grasps("contact detect_batch", results)
    paths["contact_batch"] = dict(_build.LAUNCHES)
    _expect("contact detect_batch b=2", paths["contact_batch"], 1, want)
    medians["detect_batch b=2"] = _stage_medians("contact detect_batch b=2",
                                                 [det.timings])

    # Without the collision check every candidate is valid: the returned
    # poses show the regression decoding end to end.
    poses, scores = det.detect(scenes["clutter1"], collision_check=False,
                               **kw)
    ortho = _check_grasps("contact detect without collision",
                          [(poses, scores)])
    if not len(poses):
        raise AssertionError("contact detect without collision: no grasp")

    cloud = scenes["tabletop0"][:det.cloud_capacity]   # padded, not drawn
    # Sample indices among the first voxels (a tabletop keeps ~26,600 of
    # the 65,536 capacity rows).
    idx = torch.randint(0, det.cloud_capacity // 4, (det.num_input,),
                        generator=torch.Generator().manual_seed(11),
                        dtype=torch.int32).to(det.device)
    _build.reset_launches()
    preds, want = _counted(det, lambda: det.eval(cloud, sample_idx=idx), 1)
    paths["contact_eval"] = dict(_build.LAUNCHES)
    _expect("contact eval", paths["contact_eval"], 1,
            {**want, "collision_counts": 0})
    padded, valid = det._pad_cloud(cloud)
    points = prep_one(padded, valid, det.num_input, sample_idx=idx)
    if not torch.equal(preds["frame_t"][0], points.t()):
        raise AssertionError("a fresh contact model's grasp origins are not "
                             "its points")
    rot = preds["frame_R"][0].t().reshape(-1, 3, 3).double()
    r_err = float((rot @ rot.transpose(1, 2)
                   - torch.eye(3, dtype=rot.dtype, device=rot.device)
                   ).abs().max())
    if not r_err <= 1e-5:
        raise AssertionError(f"contact frame_R not orthonormal: {r_err}")
    print(f"contact eval: frame_t - points exactly 0, frame_R max "
          f"orthonormality error {r_err:.2e}; detect without collision "
          f"{len(poses)} grasps, orthonormality error {ortho:.2e}",
          flush=True)

    with _layer_settings(MLP_IMPL="fused"):
        det.detect(cloud, **kw)
        _build.reset_launches()
        result, want = _counted(det, lambda: det.detect(cloud, **kw), 1,
                                mlp_chain=FUSED_K7_LAUNCHES["detect"])
        _check_grasps("contact fused-chain detect", [result])
        paths["contact_fused_detect"] = dict(_build.LAUNCHES)
        _expect("contact fused-chain detect", paths["contact_fused_detect"],
                1, want)
        medians["fused-chain detect"] = _stage_medians(
            "contact fused-chain detect", [det.timings])

    Checkpointer(det.output_dir).save(
        "model_000", {"model": det.net.state_dict(), "extra": {"seed": 0}})
    again = GraspDetector(model=model, seed=1, output_dir=det.output_dir,
                          device=det.device.type,
                          cloud_capacity=det.cloud_capacity,
                          num_candidates=det.num_candidates)
    first = det.eval(cloud, sample_idx=idx)
    second = again.eval(cloud, sample_idx=idx)
    if not all(torch.equal(first[k], second[k]) for k in first):
        raise AssertionError("a detector loading the saved checkpoint "
                             "predicts otherwise")
    print("contact checkpoint: saved with Checkpointer, loaded through "
          "last_checkpoint by a seed-1 detector: predictions equal",
          flush=True)
    return paths, medians


def _settings_phase(det, torch, np):
    """The two model settings at full width on the deployed detector:
    `SA1_FUSE` "1" (detect x3 on a tabletop: K3 at b = 1, no K2), "0"
    (detect_batch at b = 2 on tabletops: K2 at b = 2, no K3), then
    `CAST_ACTIVATIONS` (one detect).  Each run warmed up, counted on its
    own, every kernel exactly.  Returns each run's launches and stage
    medians."""
    from s4g_tpu_torch import _build

    scenes = _scenes(np)
    kw = {"score_threshold": 0.0, "verticalness_threshold": -1e9}
    pair = [scenes["tabletop0"], scenes["tabletop2"]]
    runs = [("sa1_fuse_1_detect", "SA1_FUSE=1 detect", {"SA1_FUSE": "1"},
             [scenes["tabletop0"]], NUM_DETECT, True),
            ("sa1_fuse_0_batch", "SA1_FUSE=0 detect_batch b=2",
             {"SA1_FUSE": "0"}, pair, 1, False),
            ("cast_detect", "CAST_ACTIVATIONS detect",
             {"CAST_ACTIVATIONS": True}, [scenes["tabletop0"]], 1, None)]
    paths, medians = {}, {}
    for key, label, settings, clouds, reps, fused in runs:
        with _layer_settings(**settings):
            det.detect_batch(clouds, **kw)
            _build.reset_launches()
            expected, timings = {}, []
            for _ in range(reps):
                results, want = _counted(
                    det, lambda: det.detect_batch(clouds, **kw), len(clouds),
                    fused=fused)
                _check_grasps(label, results)
                expected = _add(expected, want)
                timings.append(dict(det.timings))
            paths[key] = dict(_build.LAUNCHES)
            _expect(label, paths[key], 1, expected)
            medians[label] = _stage_medians(label, timings)
    return paths, medians


STREAM_FRAMES = 8


def _reseed(det, seed: int = 0) -> None:
    """Put a detector's random state back to what `seed` gave it."""
    import numpy as np
    det.generator.manual_seed(seed)
    det._np_rng = np.random.RandomState(seed)


def _host_syncs(det, cloud, torch):
    """The host's waits on the device while one frame is submitted (what
    holds a stream's next submit back): `torch.cuda.set_sync_debug_mode
    ("warn")` around `GraspDetector._submit`, each warning counted by the
    line that made it."""
    import collections
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            job = det._submit([cloud], 5, 0.0, -1e9, True)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    det._materialize(job)
    where = collections.Counter(
        f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))
    return sum(where.values()), dict(where.most_common())


def _stream_phase(det, sdet, torch, np):
    """`detect_stream` on the deployed configuration: STREAM_FRAMES seeded
    tabletops through `sdet.detect_stream` at depth 1, 2 and 3, each
    yield equal, bit for bit, to `det.detect` on the same frame (both
    detectors seed 0, their random state reset before each pass); the
    depth-2 pass counted (every kernel exactly, per frame).  Prints
    frames/s of each pass and of the sequential detects, and the host
    synchronizations of one frame's submit.  Returns the counted pass's
    launches and the rates."""
    from s4g_tpu_torch import _build
    from s4g_tpu_torch.ops import neighbors as nb

    frames = [tabletop_cloud(np.random.RandomState(100 + i))
              for i in range(STREAM_FRAMES)]
    kw = {"score_threshold": 0.0, "verticalness_threshold": -1e9}
    det.detect(frames[0], **kw)
    list(sdet.detect_stream(frames[:2], depth=2, **kw))
    _reseed(det)
    t0 = time.perf_counter()
    want = [det.detect(f, **kw) for f in frames]
    seq_fps = STREAM_FRAMES / (time.perf_counter() - t0)
    rates, launches = {"sequential_detect_fps": seq_fps}, None
    for depth in (1, 2, 3):
        _reseed(sdet)
        if depth == 2:
            _build.reset_launches()
            over = nb.SLAB_FALLBACKS["overflow"]
        t0 = time.perf_counter()
        got = list(sdet.detect_stream(frames, depth=depth, **kw))
        rates[f"stream_depth{depth}_fps"] = (STREAM_FRAMES
                                             / (time.perf_counter() - t0))
        if depth == 2:
            launches = dict(_build.LAUNCHES)
            n_over = nb.SLAB_FALLBACKS["overflow"] - over
            expected = {k: STREAM_FRAMES * v for k, v in
                        _deployed_launches(sdet, 1).items()}
            expected["ball_query_slab"] -= n_over
            expected["ball_query_full"] += n_over
            _expect(f"detect_stream depth 2, {STREAM_FRAMES} frames",
                    launches, 1, expected)
        bad = [i for i, ((gp, gs), (wp, ws)) in enumerate(zip(got, want))
               if not (np.array_equal(gp, wp) and np.array_equal(gs, ws))]
        if len(got) != STREAM_FRAMES or bad:
            raise AssertionError(f"detect_stream depth {depth}: {len(got)} "
                                 f"frames, frames {bad} differ from detect")
        print(f"detect_stream depth {depth}: {STREAM_FRAMES} frames equal "
              f"detect bit for bit; frame ms "
              + ", ".join(f"{t:.1f}" for t in sdet.timings["frame_ms"]),
              flush=True)
    syncs, where = _host_syncs(sdet, frames[0], torch)
    rates["host_syncs_per_submit"] = syncs
    print(f"detect_stream ({_nvidia_smi()}): "
          + ", ".join(f"{k} {v:.3f}" for k, v in rates.items()
                      if k.endswith("fps"))
          + f"; host synchronizations in one frame's submit: {syncs} "
          f"{where}", flush=True)
    return launches, rates


def _expect(label, launches, forwards, per_forward):
    """Fail unless every kernel launched `per_forward[kernel]` times per
    forward (each kernel must be named)."""
    bad = {k: launches[k] for k in launches
           if launches[k] != per_forward[k] * forwards}
    print(f"{label}: {forwards} forwards, launches {launches}", flush=True)
    if bad:
        raise AssertionError(f"{label}: launches {bad}; expected per forward "
                             f"{per_forward}")


def _stage_medians(label, runs):
    med = {st: statistics.median(r[st] for r in runs) for st in runs[0]}
    print(f"{label} (median of {len(runs)}): "
          + ", ".join(f"{st} {v:.2f}" for st, v in med.items()), flush=True)
    return med


def _fp_kernel_stages(det) -> int:
    """FP stages of `det` at or above K4's pair threshold (two at full
    width)."""
    from s4g_tpu_torch.ops.neighbors import KERNEL_MIN_PAIRS
    sizes = (det.num_input, *det.cfg.MODEL.PN2.NUM_CENTROIDS)
    return sum(a * b >= KERNEL_MIN_PAIRS for a, b in zip(sizes, sizes[1:]))


def _parity_launches(det, **changes):
    """Launches per parity detect of `det`, with `changes`: K6 and K2f for
    each SA stage, K4 for each FP stage at or above its pair threshold, K5
    once per scene post-processed; never K1, K2, K3 or K7."""
    from s4g_tpu_torch import _build
    stages = len(det.cfg.MODEL.PN2.NUM_CENTROIDS)
    return {**{k: 0 for k in _build.LAUNCHES}, "fps_exact": stages,
            "ball_query_full": stages, "three_nn": _fp_kernel_stages(det),
            "collision_counts": 1, **changes}


def _deployed_launches(det, b: int, overflow: bool = False,
                       mlp_chain: int = 0, fused=None):
    """Launches per deployed forward of `det` (SORT_POINTS, FPS_SHARDS 128)
    at batch `b`: K1 once for all SA stages where they nest
    (`fps_nesting_applies`), else once per stage; SA1 through K3 where it
    is `fused` (by default at b >= 2, `nn_layers.SA1_FUSE` "auto"), else
    K2, or, when its key windows `overflow`, through the full-scan
    fallback (K2f); K2f for every other SA stage (inputs below the slab
    capacity); K4 for each FP stage at or above its pair threshold; K5
    once per scene post-processed; `mlp_chain` K7 chains."""
    from s4g_tpu_torch import _build
    from s4g_tpu_torch.ops.sampling import fps_nesting_applies
    pn2 = det.cfg.MODEL.PN2
    sizes = (det.num_input, *pn2.NUM_CENTROIDS)
    nested = fps_nesting_applies(det.num_input, pn2.NUM_CENTROIDS,
                                 pn2.FPS_SHARDS)
    out = {k: 0 for k in _build.LAUNCHES}
    out.update(fps_lane=1 if nested else len(sizes) - 1,
               three_nn=_fp_kernel_stages(det),
               collision_counts=b, mlp_chain=mlp_chain,
               ball_query_full=sum(n <= SLAB_CAPACITY for n in sizes[:-1]))
    if overflow:
        out["ball_query_full"] += 1
    else:
        out["sa1_fused" if (b >= 2 if fused is None else fused)
            else "ball_query_slab"] = 1
    return out


def _add(total: dict, more: dict) -> dict:
    return {k: total.get(k, 0) + v for k, v in more.items()}


def _counted(det, call, b: int, mlp_chain: int = 0, fused=None):
    """Run `call()` once; return its result and the launches it should have
    made, `_deployed_launches` with the SA1 overflow that the run reported
    (the slab route's fallback, the fused stage's)."""
    from s4g_tpu_torch.ops import neighbors as nb
    from s4g_tpu_torch.ops import sa_fused as sf

    before = nb.SLAB_FALLBACKS["overflow"] + sf.SA1_FALLBACKS["overflow"]
    out = call()
    overflow = (nb.SLAB_FALLBACKS["overflow"] + sf.SA1_FALLBACKS["overflow"]
                > before)
    return out, _deployed_launches(det, b, overflow, mlp_chain, fused)


@contextlib.contextmanager
def _layer_settings(**settings):
    """Set module settings of `s4g_tpu_torch.models.nn_layers` (the
    fused-chain route's `MLP_IMPL`, `MLP_FUSE_MIN_ROWS`, `MLP_FUSE_SCOPE`;
    `SA1_FUSE`, `CAST_ACTIVATIONS`) and restore them after."""
    from s4g_tpu_torch.models import nn_layers
    old = {k: getattr(nn_layers, k) for k in settings}
    for k, v in settings.items():
        setattr(nn_layers, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(nn_layers, k, v)


def _parity_phase(det, torch, np):
    """The reference-parity configuration at full width, through the API:
    detect x3 on a tabletop, then detect_batch at b = 2, then one eval
    (every ball query K2f).  Each run is warmed up, then driven with the
    launch counts zeroed before it and read after it, and each kernel's
    count must be exactly its per-forward count.  Returns each run's
    launches and stage medians."""
    from s4g_tpu_torch import _build

    scenes = _scenes(np)
    kw = {"score_threshold": 0.0, "verticalness_threshold": -1e9}
    pair = [scenes["tabletop0"], scenes["tabletop2"]]
    det.detect(scenes["tabletop0"], **kw)
    det.detect_batch(pair, **kw)
    paths, medians = {}, {}

    _build.reset_launches()
    runs = []
    for _ in range(NUM_DETECT):
        _check_grasps("parity detect", [det.detect(scenes["tabletop0"],
                                                   **kw)])
        runs.append(dict(det.timings))
    paths["parity_detect"] = dict(_build.LAUNCHES)
    _expect("parity detect x3", paths["parity_detect"], NUM_DETECT,
            _parity_launches(det))
    medians["detect"] = _stage_medians("parity detect tabletop", runs)

    _build.reset_launches()
    _check_grasps("parity detect_batch", det.detect_batch(pair, **kw))
    paths["parity_batch"] = dict(_build.LAUNCHES)
    _expect("parity detect_batch b=2", paths["parity_batch"], 1,
            _parity_launches(det, collision_counts=2))
    medians["detect_batch b=2"] = _stage_medians("parity detect_batch b=2",
                                                 [det.timings])

    _build.reset_launches()
    preds = det.eval(scenes["tabletop0"])
    paths["parity_eval"] = dict(_build.LAUNCHES)
    _expect("parity eval", paths["parity_eval"], 1,
            _parity_launches(det, collision_counts=0))
    n = det.num_input
    for key, c in (("score", 3), ("frame_R", 9), ("frame_t", 4),
                   ("movable_logits", 5)):
        if preds[key].shape != (1, c, n) or not bool(
                torch.isfinite(preds[key]).all()):
            raise AssertionError(f"eval {key}: shape "
                                 f"{tuple(preds[key].shape)} or non-finite")
    return paths, medians


def _sort_only_phase(det, torch, np):
    """The sort-only ablation (SORT_POINTS with FPS_SHARDS 1): one
    detect_batch at b = 2 on tabletops, where K6 feeds K3 through the
    re-sort of the exact picks, and K2f takes SA2 and SA3."""
    from s4g_tpu_torch import _build

    scenes = _scenes(np)
    kw = {"score_threshold": 0.0, "verticalness_threshold": -1e9}
    pair = [scenes["tabletop0"], scenes["tabletop2"]]
    det.detect_batch(pair, **kw)
    _build.reset_launches()
    _check_grasps("sort-only detect_batch", det.detect_batch(pair, **kw))
    launches = dict(_build.LAUNCHES)
    _expect("sort-only detect_batch b=2", launches, 1,
            _parity_launches(det, sa1_fused=1, collision_counts=2,
                             ball_query_full=len(
                                 det.cfg.MODEL.PN2.NUM_CENTROIDS) - 1))
    return launches, _stage_medians("sort-only detect_batch b=2",
                                    [det.timings])


def _detect_phase(det, torch, np):
    """The main path: one warm-up, then the counted runs — the tabletop
    NUM_DETECT times (timed), then a clutter scene whose random-weight
    grasps partly clear the collision check (on the tabletop nearly every
    random grasp hits the table), so importance sampling draws from real
    mass.  Every kernel must launch exactly its count for each run
    (`_deployed_launches`).  Returns each kernel's launches in the counted
    runs."""
    from s4g_tpu_torch import _build
    from s4g_tpu_torch.ops import neighbors as nb

    scenes = {"tabletop": tabletop_cloud(np.random.RandomState(0)),
              "clutter": clutter_cloud(np.random.RandomState(1))}
    det.detect(scenes["tabletop"], score_threshold=0.0,
               verticalness_threshold=-1e9)
    _build.reset_launches()
    nb.SLAB_FALLBACKS["overflow"] = 0
    runs, found, fallbacks, expected = [], {}, {}, {}
    for name in ["tabletop"] * NUM_DETECT + ["clutter"]:
        before = nb.SLAB_FALLBACKS["overflow"]
        (poses, scores), want = _counted(det, lambda: det.detect(
            scenes[name], score_threshold=0.0, verticalness_threshold=-1e9),
            1)
        expected = _add(expected, want)
        if name == "tabletop":
            runs.append(dict(det.timings))
        found[name] = (poses, scores, det.last_num_valid)
        fallbacks[name] = (fallbacks.get(name, 0)
                           + nb.SLAB_FALLBACKS["overflow"] - before)
    launches = dict(_build.LAUNCHES)
    for stage in runs[0]:
        print(f"detect tabletop {stage}: "
              + ", ".join(f"{r[stage]:.2f}" for r in runs), flush=True)
    for name, (poses, scores, num_valid) in found.items():
        ortho = _check_grasps(name, [(poses, scores)])
        print(f"detect {name}: num_valid {num_valid}, {len(poses)} grasps "
              f"returned, max orthonormality error {ortho:.2e}", flush=True)
    if not len(found["clutter"][0]):
        raise AssertionError("no valid grasp on the clutter scene")
    print(f"detect: SA1 slab-window overflow fallbacks by scene {fallbacks} "
          f"(tabletop x{NUM_DETECT}, clutter x1)", flush=True)
    _expect("detect", launches, 1, expected)
    return launches


# detect_batch's runs: tabletop batches (timed, K3 at b >= 2) and batches
# that mix in clutter scenes, whose dense columns overflow the SA1 windows.
BATCHES = {1: ("tabletop0",), 2: ("tabletop0", "tabletop2"),
           4: ("tabletop0", "tabletop2", "tabletop4", "tabletop6")}
MIXED = {2: ("tabletop0", "clutter1"),
         4: ("tabletop0", "clutter1", "tabletop2", "clutter3")}


def _scenes(np):
    return {**{f"tabletop{s}": tabletop_cloud(np.random.RandomState(s))
               for s in (0, 2, 4, 6)},
            **{f"clutter{s}": clutter_cloud(np.random.RandomState(s))
               for s in (1, 3)}}


def _detect_batch_phase(det, torch, np):
    """The batched main path: a warm-up per batch size, then the counted
    runs — the tabletop batches in turns (b = 1, 2, 4, 1, 2, 4, ...),
    NUM_BATCH times each (timed), then each mixed batch once.  Returns each
    kernel's launches in the counted runs and the median stage times per
    batch size."""
    from s4g_tpu_torch import _build
    from s4g_tpu_torch.ops import neighbors as nb
    from s4g_tpu_torch.ops import sa_fused as sf

    scenes = _scenes(np)

    def run(names):
        return det.detect_batch([scenes[x] for x in names],
                                score_threshold=0.0,
                                verticalness_threshold=-1e9)

    for names in BATCHES.values():
        run(names)
    _build.reset_launches()
    sf.SA1_FALLBACKS["overflow"] = 0
    nb.SLAB_FALLBACKS["overflow"] = 0
    timings, found, expected = {}, {}, {}
    plan = ([(names, True) for _ in range(NUM_BATCH)
             for names in BATCHES.values()]
            + [(names, False) for names in MIXED.values()])
    for names, timed in plan:
        k3, fb = _build.LAUNCHES["sa1_fused"], sf.SA1_FALLBACKS["overflow"]
        results, want = _counted(det, lambda: run(names), len(names))
        expected = _add(expected, want)
        label = "+".join(names)
        if timed:
            timings.setdefault(len(names), []).append(dict(det.timings))
        found[label] = (results, list(det.last_num_valid),
                        _build.LAUNCHES["sa1_fused"] - k3,
                        sf.SA1_FALLBACKS["overflow"] - fb, dict(det.timings))
    launches = dict(_build.LAUNCHES)
    medians = {}
    for b, runs in timings.items():
        print(f"detect_batch b={b} runs: " + "; ".join(
            ", ".join(f"{st} {v:.2f}" for st, v in r.items()) for r in runs),
            flush=True)
        medians[b] = {st: statistics.median(r[st] for r in runs)
                      for st in runs[0]}
        total = medians[b]["total_ms"]
        print(f"detect_batch b={b} (tabletops, median of {len(runs)}): "
              + ", ".join(f"{st} {v:.2f}" for st, v in medians[b].items())
              + f"; {total / b:.2f} ms per scene, {1e3 * b / total:.2f} "
              f"scenes/s", flush=True)
    for label, (results, num_valid, k3, fb, last) in found.items():
        ortho = _check_grasps(label, results)
        print(f"detect_batch {label}: num_valid {num_valid}, grasps "
              f"returned {[len(p) for p, _ in results]}, max orthonormality "
              f"error {ortho:.2e}, sa1_fused launches {k3}, SA1 overflow "
              f"fallbacks {fb}; last run model_ms {last['model_ms']:.2f}, "
              f"total_ms {last['total_ms']:.2f}", flush=True)
        if len(num_valid) >= 2 and "clutter" not in label and k3 == 0:
            raise AssertionError(f"{label}: SA1 did not take K3")
    for label in ("+".join(n) for n in MIXED.values()):
        results = found[label][0]
        if not all(len(p) for (p, _), name in zip(results, label.split("+"))
                   if name.startswith("clutter")):
            raise AssertionError(f"{label}: no valid grasp on a clutter "
                                 "scene")
    print(f"detect_batch: SA1 overflow fallbacks {sf.SA1_FALLBACKS}",
          flush=True)
    _expect("detect_batch", launches, 1, expected)
    return launches, medians


def _profile_phase(det, torch, np, top: int = 12, batch=None, name=None):
    """One tabletop detect (or, with `batch` scene names, one detect_batch)
    under torch.profiler: device time by kernel name (the `top` largest),
    the device's busy time against the call's wall time, and so its idle
    share (the profiler's own overhead is in the wall time, so the idle
    share is an upper bound)."""
    from torch.profiler import ProfilerActivity, profile

    scenes = _scenes(np)
    kw = {"score_threshold": 0.0, "verticalness_threshold": -1e9}
    label = name or ("detect" if batch is None
                     else f"detect_batch b={len(batch)}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if batch is None:
            det.detect(scenes["tabletop0"], **kw)
        else:
            det.detect_batch([scenes[x] for x in batch], **kw)
    wall_ms = det.timings["total_ms"]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # Device-side events only (the kernels and copies themselves): the
    # host-side aten:: events carry their kernels' time too.
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and dev_us(e) > 0), key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in rows) / 1e3
    if not rows:
        print(f"profile {label}: the profiler recorded no device time "
              "(device busy and idle share not measured)", flush=True)
        return
    print(f"profile {label}: wall {wall_ms:.2f} ms under the profiler, "
          f"device busy {busy_ms:.2f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.3f}", flush=True)
    for e in rows[:top]:
        print(f"profile:   {dev_us(e) / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:90]}", flush=True)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from s4g_tpu_torch import _build
    from s4g_tpu_torch.pipeline.detector import GraspDetector

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    print(_nvidia_smi(), flush=True)

    t0 = time.perf_counter()
    lib = _build.build(verbose=True)
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.1f} s, {lib}", flush=True)

    det = GraspDetector(model="curvature_model", seed=0,
                        output_dir=_output_dir("deployed"))
    pdet = GraspDetector(model=_config_file(
        "parity_model", SORT_POINTS=False, FPS_SHARDS=1), seed=0,
        output_dir=_output_dir("parity"))
    sdet = GraspDetector(model=_config_file(
        "sort_only_model", model={"COMPUTE_DTYPE": "float32"},
        SORT_POINTS=True, FPS_SHARDS=1), seed=0,
        output_dir=_output_dir("sort_only"))
    cdet = GraspDetector(model="contact_model", seed=0,
                         output_dir=_output_dir("contact"))
    qdet = GraspDetector(model="curvature_model", seed=0,
                         output_dir=_output_dir("stream"))
    failed = []
    extras = {}

    def phase(name, fn):
        """Run one phase; a failure is printed and fails the run at the end
        (the later phases still run, so one call shows every fault)."""
        try:
            return fn()
        except Exception:   # noqa: BLE001 - reported, and the run fails
            traceback.print_exc()
            failed.append(name)
            return None

    def kernels():
        inp = _path_inputs(det, torch, np)
        print(f"path inputs: N={inp['stages'][0].shape[2]}, SA1 overflow="
              f"{inp['overflow']}, poses={inp['g2l'].shape[0]}, cloud rows="
              f"{inp['cloud_valid'].shape[0]}", flush=True)
        rep = _kernel_phase(inp, torch, extras)
        cinp = _batch_sa1_inputs(det, torch, np)
        rep.append(_k3_phase(cinp, torch))
        # K3 again on two tabletops, whose windows fit: what detect_batch
        # hands K3 (a batch whose windows overflow takes the full scan).
        binp = _batch_sa1_inputs(det, torch, np, clutter=False)
        pair = _k3_phase(binp, torch)
        extras["sa1_fused"] = {"tabletop_pair_ms": pair[4],
                               "tabletop_pair_max_abs_err": pair[3]}
        _setting_kernel_phase(binp, torch, extras)
        pinp = _parity_inputs(pdet, torch, np)
        rep.append(_k6_phase(pinp, torch, extras))
        rep.append(_k2f_phase(pinp, torch, inp, cinp, extras))
        _fault_phase(binp, torch, np, extras)
        k7, k7_extras = _k7_phase(_chain_inputs(det, torch, np), torch)
        extras.setdefault("mlp_chain", {}).update(k7_extras)
        rep.append(k7)
        for name, _, _, err, ms, plain, bound, by in rep:
            print(f"kernel {name}: max|kernel-plain|={err:.3g} kernel "
                  f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bound:.5f} ms "
                  f"({by})", flush=True)
        return rep

    report = phase("kernels", kernels)
    ref = phase("reference", lambda: _reference_phase(torch, np))
    print(f"reference: {ref}", flush=True)
    ref_b = phase("batch reference",
                  lambda: _batch_reference_phase(torch, np))
    print(f"batch reference: {ref_b}", flush=True)
    ref_p = phase("parity reference",
                  lambda: _parity_reference_phase(torch, np))
    print(f"parity reference: {ref_p}", flush=True)
    ref_f = phase("fused-chain reference",
                  lambda: _fused_reference_phase(torch, np))
    print(f"fused-chain reference: {ref_f}", flush=True)
    ref_c = phase("contact reference",
                  lambda: _contact_reference_phase(torch, np))
    print(f"contact reference: {ref_c}", flush=True)
    ref_cast = phase("CAST_ACTIVATIONS reference",
                     lambda: _cast_reference_phase(torch, np))
    print(f"CAST_ACTIVATIONS reference: {ref_cast}", flush=True)
    launches = phase("detect", lambda: _detect_phase(det, torch, np))
    batch = phase("detect_batch", lambda: _detect_batch_phase(det, torch, np))
    parity = phase("parity", lambda: _parity_phase(pdet, torch, np))
    sort_only = phase("sort-only", lambda: _sort_only_phase(sdet, torch, np))
    fused = phase("fused-chain", lambda: _fused_phase(det, torch, np))
    contact = phase("contact", lambda: _contact_phase(cdet, torch, np))
    settings = phase("settings", lambda: _settings_phase(det, torch, np))
    stream = phase("stream", lambda: _stream_phase(det, qdet, torch, np))
    phase("profile", lambda: _profile_phase(det, torch, np))
    phase("profile batch", lambda: _profile_phase(det, torch, np,
                                                  batch=BATCHES[2]))
    phase("profile parity", lambda: _profile_phase(pdet, torch, np))

    def profile_fused():
        with _layer_settings(MLP_IMPL="fused"):
            _profile_phase(det, torch, np, name="fused-chain detect")
    phase("profile fused-chain", profile_fused)
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s, build included",
          flush=True)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1

    # launches: over every main path's counted runs, and by path.
    paths = {"detect": launches, "detect_batch": batch[0], **parity[0],
             "sort_only_batch": sort_only[0], **fused[0], **contact[0],
             **settings[0], "stream": stream[0]}
    extras.setdefault("mlp_chain", {})["pack_cache"] = fused[2]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": sum(p[name] for p in paths.values()),
         "launches_by_path": {k: p[name] for k, p in paths.items()},
         "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bound,
         "bound_by": by, "library_ms": None, **extras.get(name, {}),
         "status": "ok"}
        for name, src, tpu, err, ms, plain, bound, by in report]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
