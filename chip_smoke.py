#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (s4g_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

It prints the card's name and power limit as nvidia-smi gives them, then
runs these phases; a failing phase is reported and the later ones still
run, but the run then exits non-zero without printing a result:

1. build: every kernel of the main path compiled from `s4g_tpu_torch/csrc`
   with nvcc (one process per source, in parallel, then one link), loaded
   with ctypes;
2. kernels: each of K1 (FPS), K2 (slab ball query), K4 (3-NN) and K5
   (collision counts) run at the main path's shapes on inputs taken from a
   seeded synthetic scene, held against its plain PyTorch twin on the card
   (indices and counts exact, distances within 1e-6), and timed with CUDA
   events (CUDA-graph replays of back-to-back launches, so host launch cost
   is excluded), beside its plain twin's time and its bound;
3. reference: the detect stages at a narrow width that still takes every
   kernel route, on the GPU and on the CPU (plain twins), each stage fed
   the same inputs on both devices (see `_reference_phase`);
4. main path: `GraspDetector(model="curvature_model").detect` at full width
   with seeded random weights on a synthetic camera-frame tabletop (a plane
   plus boxes), a few times, then a clutter scene; per-stage and total ms,
   the number of valid grasps, the rotations' orthonormality, whether the
   SA1 slab window overflowed, and every kernel's launch count (each must
   be > 0);
5. profile: one detect under torch.profiler — device time by kernel and
   the device's idle share.

Then one JSON line with every kernel's numbers and, last, the contract line
`{"ok": true, "device": {...}}`.  Without a CUDA device, or without the
package beside this script, it exits non-zero before printing any result.
"""

from __future__ import annotations

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
PEAK_BYTES = 3.35e12

NUM_DETECT = 3


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
            "g2l": g2l, "cloud_valid": cloud_valid.contiguous()}


def _kernel_phase(inp, torch):
    """Each kernel against its plain twin on the card, then timed."""
    from s4g_tpu_torch.ops import neighbors as nb
    from s4g_tpu_torch.ops import sampling as sp
    from s4g_tpu_torch.pipeline import collision as col

    st = inp["stages"]
    n_pts = [s.shape[2] for s in st]

    def compare(name, got, want, exact):
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

    report = []

    # K1: the three FPS stages of the path.
    fps_calls = [(st[i], n_pts[i + 1]) for i in range(3)]
    err = max(compare("fps_lane", [sp.fps_lane_sharded(p, m)],
                      [sp._fps_sharded_plain(p, m)], True)
              for p, m in fps_calls)
    ms = sum(_graph_ms(lambda p=p, m=m: sp.fps_lane_sharded(p, m))
             for p, m in fps_calls)
    plain = sum(_event_ms(lambda p=p, m=m: sp._fps_sharded_plain(p, m),
                          reps=5) for p, m in fps_calls)
    # ~10 f32 operations (3 sub, 3 mul, 2 add, min, compare) per point per
    # FPS step; each point read once, each index written once.
    ops = sum(10.0 * n * (m // 128 - 1) for n, m in
              ((n_pts[i], n_pts[i + 1]) for i in range(3)))
    nbytes = sum(12 * n_pts[i] + 4 * n_pts[i + 1] for i in range(3))
    report.append(("fps_lane", "s4g_tpu_torch/csrc/fps_lane.cu",
                   "s4g_tpu/ops/sampling.py:287", err, ms, plain,
                   *_bound_ms(ops, nbytes)))

    # K2: the SA1 slab ball query.
    pts, cents, lo = st[0], st[1], inp["lo_tile"]
    r, k = inp["radius"], inp["k"]
    err = compare("ball_query_slab",
                  nb.ball_query_fused_slab(pts, cents, lo, r, k, True),
                  nb._ball_query_slab_plain(pts, cents, lo, r * r, k, True),
                  True)
    ms = _graph_ms(lambda: nb.ball_query_fused_slab(pts, cents, lo, r, k,
                                                    True))
    plain = _event_ms(lambda: nb._ball_query_slab_plain(pts, cents, lo,
                                                        r * r, k, True),
                      reps=5)
    # 9 f32 operations (3 sub, 3 mul, 2 add, compare) per (centroid, key)
    # of each tile's 8,192-key window.
    m1 = cents.shape[2]
    ops = 9.0 * m1 * nb.BQ_WINDOW
    nbytes = 12 * (pts.shape[2] + m1) + 4 * lo.numel() + 4 * m1 * (k + 1)
    report.append(("ball_query_slab", "s4g_tpu_torch/csrc/ball_query_slab.cu",
                   "s4g_tpu/ops/pallas/neighbor_kernels.py:145", err, ms,
                   plain, *_bound_ms(ops, nbytes)))

    # K4: the two FP stages above the 2^22-pair threshold.
    nn_calls = [(st[1], st[2]), (st[0], st[1])]
    err = max(compare("three_nn", nb.three_nn_fused(q, kk),
                      nb._three_nn_plain(q, kk), False)
              for q, kk in nn_calls)
    for q, kk in nn_calls:   # indices exact
        compare("three_nn", nb.three_nn_fused(q, kk)[:1],
                nb._three_nn_plain(q, kk)[:1], True)
    ms = sum(_graph_ms(lambda q=q, kk=kk: nb.three_nn_fused(q, kk))
             for q, kk in nn_calls)
    plain = sum(_event_ms(lambda q=q, kk=kk: nb._three_nn_plain(q, kk),
                          reps=5) for q, kk in nn_calls)
    # 9 f32 operations (3 sub, 3 mul, 2 add, compare) per (query, key).
    ops = sum(9.0 * q.shape[2] * kk.shape[2] for q, kk in nn_calls)
    nbytes = sum(12 * (q.shape[2] + kk.shape[2]) + 24 * q.shape[2]
                 for q, kk in nn_calls)
    report.append(("three_nn", "s4g_tpu_torch/csrc/three_nn.cu",
                   "s4g_tpu/ops/pallas/neighbor_kernels.py:58", err, ms,
                   plain, *_bound_ms(ops, nbytes)))

    # K5: collision counts of the candidate poses against the padded cloud.
    g2l, cv = inp["g2l"], inp["cloud_valid"]
    err = compare("collision_counts", col.collision_counts(g2l, cv),
                  col._collision_counts_plain(g2l, cv), True)
    ms = _graph_ms(lambda: col.collision_counts(g2l, cv))
    plain = _event_ms(lambda: col._collision_counts_plain(g2l, cv), reps=5)
    # Per (pose, point): 9 mul + 9 add for the transform, ~12 compares.
    ops = 30.0 * g2l.shape[0] * cv.shape[0]
    nbytes = 64 * g2l.shape[0] + 16 * cv.shape[0] + 8 * g2l.shape[0]
    report.append(("collision_counts", "s4g_tpu_torch/csrc/collision_counts.cu",
                   "s4g_tpu/ops/pallas/collision_kernels.py:33", err, ms,
                   plain, *_bound_ms(ops, nbytes)))
    return report


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


def _reference_phase(torch, np, devices=("cpu", "cuda")):
    """Detect stages at a narrow width that still takes every kernel route
    (slab SA1 at N = 8192, 3-NN 8192 <- 1024, collision 8192 x 16384), on a
    clutter scene, on the GPU (kernels) and on the CPU (plain twins), each
    stage fed the same inputs on both devices:

    * preprocessing: the voxel means must match exactly; the radius outlier
      mask (matmul-form distances, summed differently by cuBLAS and the CPU
      BLAS) within 0.1 % of the points;
    * model, on the same sampled points: predictions within 1e-4;
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
    post-processing gets the same predictions on both devices."""
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
        net = build_model(load_cfg_from_dict(NARROW))
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
    pred_err = max(float((cpu["preds"][k] - gpu["preds"][k]).abs().max())
                   for k in gpu["preds"])
    if not pred_err <= 1e-4:
        raise AssertionError(f"predictions differ by {pred_err}")

    res = {}
    for dev in devices:
        with torch.no_grad():
            r = post_one(gpu["points"].to(dev),
                         {k: p.to(dev) for k, p in gpu["preds"].items()},
                         torch.from_numpy(padded).to(dev),
                         torch.from_numpy(valid).to(dev), uniforms.to(dev),
                         0.0, -1e9, n_cand)
        res[dev] = {k: p.cpu().numpy() for k, p in r.items()}
    cpu, gpu = res[devices[0]], res[devices[1]]
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
    return {"keep_mismatch": keep_diff, "max_pred_err": pred_err,
            "max_score_rel_err": score_err,
            "grasps_with_twin": int(twins.sum()),
            "grasps_agreeing": int(agree.sum()), "candidates": n_cand,
            "num_valid_gpu": int(gpu["num_valid"]),
            "num_valid_cpu": int(cpu["num_valid"]),
            "same_selection": bool(np.array_equal(gpu["selected"],
                                                  cpu["selected"]))}


def _detect_phase(det, torch, np):
    """The main path: one warm-up, then the counted runs — the tabletop
    NUM_DETECT times (timed), then a clutter scene whose random-weight
    grasps partly clear the collision check (on the tabletop nearly every
    random grasp hits the table), so importance sampling draws from real
    mass.  Returns each kernel's launches in the counted runs."""
    from s4g_tpu_torch import _build
    from s4g_tpu_torch.ops import neighbors as nb

    scenes = {"tabletop": tabletop_cloud(np.random.RandomState(0)),
              "clutter": clutter_cloud(np.random.RandomState(1))}
    det.detect(scenes["tabletop"], score_threshold=0.0,
               verticalness_threshold=-1e9)
    _build.reset_launches()
    nb.SLAB_FALLBACKS["overflow"] = 0
    runs, found, fallbacks = [], {}, {}
    for name in ["tabletop"] * NUM_DETECT + ["clutter"]:
        before = nb.SLAB_FALLBACKS["overflow"]
        poses, scores = det.detect(scenes[name], score_threshold=0.0,
                                   verticalness_threshold=-1e9)
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
        if not (np.isfinite(poses).all() and np.isfinite(scores).all()
                and poses.shape[1:] == (4, 4) and len(poses) == len(scores)):
            raise AssertionError(f"{name}: malformed grasps")
        rot = poses[:, :3, :3].astype(np.float64)
        ortho = float(np.abs(np.einsum("nij,nkj->nik", rot, rot)
                             - np.eye(3)).max()) if len(rot) else 0.0
        if ortho > 1e-4:
            raise AssertionError(f"{name}: rotations not orthonormal: {ortho}")
        print(f"detect {name}: num_valid {num_valid}, {len(poses)} grasps "
              f"returned, max orthonormality error {ortho:.2e}", flush=True)
    if not len(found["clutter"][0]):
        raise AssertionError("no valid grasp on the clutter scene")
    print(f"detect: SA1 slab-window overflow fallbacks by scene {fallbacks} "
          f"(tabletop x{NUM_DETECT}, clutter x1), launches {launches}",
          flush=True)
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"main path never launched: {missing}")
    return launches


def _profile_phase(det, torch, np, top: int = 12):
    """One tabletop detect under torch.profiler: device time by kernel
    name (the `top` largest), the device's busy time against the detect's
    wall time, and so its idle share (the profiler's own overhead is in
    the wall time, so the idle share is an upper bound)."""
    from torch.profiler import ProfilerActivity, profile

    cloud = tabletop_cloud(np.random.RandomState(0))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        det.detect(cloud, score_threshold=0.0, verticalness_threshold=-1e9)
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
        print("profile: the profiler recorded no device time (device "
              "busy and idle share not measured)", flush=True)
        return
    print(f"profile: detect wall {wall_ms:.2f} ms under the profiler, device "
          f"busy {busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.3f}",
          flush=True)
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

    det = GraspDetector(model="curvature_model", seed=0)
    failed = []

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
        rep = _kernel_phase(inp, torch)
        for name, _, _, err, ms, plain, bound, by in rep:
            print(f"kernel {name}: max|kernel-plain|={err:.3g} kernel "
                  f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bound:.5f} ms "
                  f"({by})", flush=True)
        return rep

    report = phase("kernels", kernels)
    ref = phase("reference", lambda: _reference_phase(torch, np))
    print(f"reference: {ref}", flush=True)
    launches = phase("detect", lambda: _detect_phase(det, torch, np))
    phase("profile", lambda: _profile_phase(det, torch, np))
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[name], "max_abs_err": err, "ms": ms,
         "plain_ms": plain, "bound_ms": bound, "bound_by": by,
         "library_ms": None, "status": "ok"}
        for name, src, tpu, err, ms, plain, bound, by in report]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
