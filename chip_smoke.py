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
   with each chain's launches (FP1 and FP2 run one layer a launch); then
   K8 (the gathers' fixed-order backward, `_k8_phase`) at each of its
   eleven calls in a deployed train step at b = 4, bit for bit against
   its twin, timed beside its bound, the library's atomic `index_add_`
   and torch's scatter-add under `use_deterministic_algorithms`;
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
   (`_cast_reference_phase`); then one narrow f32 train step on both
   devices from the same weights and batch: losses, metrics, every
   gradient and the BatchNorm statistics after it
   (`_train_reference_phase`), with the spread of the GPU's gradients
   between two of its own runs (bit for bit) and under
   `use_deterministic_algorithms` printed beside it; then the detect
   stages of EDGEPN2D and EDGEPN2DU
   at a narrow four-stage pyramid (`_edge_reference_phase`: K6, K2f, K4,
   K5) and one narrow PN2_LOCAL candidate-mode train step
   (`_local_reference_phase`), GPU vs CPU; then `eval_frames` at the
   label factory's size, 2,000 poses against 100,000 labeled points
   (`_eval_reference_phase`: collision and multi_objects equal, scores
   within 1e-5, timed, its peak memory); then the label factory at a
   reduced size (`_factory_reference_phase`: an ellipsoid and a box
   graded, one 320 x 240 view, capacity 4,096): each stage on the GPU fed
   the CPU's inputs equal to the CPU's (integers, masks and frames
   exactly, floats within 1e-6), and end to end normals and frames within
   1e-5 up to the gripper's turn where the eigenvalue gap allows, with
   the labels that differ counted;
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
   frames/s of both and the host synchronizations of one frame's submit;
   then training (`_train_phase`): `Trainer.fit` at full width on six
   synthetic scene pickles (one epoch of 3 steps with validation, then a
   new Trainer resumed from `last_checkpoint` for epoch 2), one step with
   its host synchronizations counted, one profiled step and one step with
   every augmentation; the median step ms split into forward, backward
   and optimizer, and the peak device memory; the deployed step at b = 4
   twice from one state, bit for bit (`_rerun_phase`); then the other
   model types
   at full width: EDGEPN2D and EDGEPN2DU served through
   `GraspDetector(<yaml>)` at the reference's four-stage pyramid
   (`_edge_phase`: detect x3, clutter, detect_batch b = 2; K6, K2f, K4
   and K5 only, `_edge_launches`), PN2_LOCAL (`_local_phase`: eval at
   b = 1, the net at b = 2, candidate-mode Trainer steps with their
   launches, ms split and peak memory) and GPD / PointNetGPD over one
   scene's 300 candidates (`_baseline_phase`: forward and train step in
   bf16 and f32, GPU vs CPU at f32, no kernel launched); then the label
   factory at full size (`_factory_phase`: the eight mesh_tools
   primitives graded at their defaults, four 640 x 480 views at capacity
   16,384, the online variant, the contact flavour with refinement and
   smoothing, an eval view of 2,000 grasp points with 300 baseline
   payloads, a 300-grasp baseline view; per-stage ms, peak memory and
   sizes; K2f and K5 only, counted exactly; `generate_end_to_end` whole
   where `mujoco` imports); then the entry
   points (`s4g_tpu_torch/tools`) at full width on a pickle of the seeded
   tabletop, each `main` in its own directory: grasp_proposal_test (its
   artifacts, then `log_to_file` GPU vs CPU on one forward's predictions:
   the top-50 set, the collision masks, the top frames), measure_batch at
   b = 1, 2 and 4, measure_stream at depths 1 and 2, the train CLI for
   one epoch with a validation step (its checkpoint read back),
   profile_stages and trace_forward
   --detect (its Chrome trace must name every launched kernel); then the
   label factory's tools, each in its own directory, every launch held to
   its cause (`_tool_launches`: each forward its route's kernels,
   `_net_launches`; each graded object K2f 2; each collision check K5
   where it reaches the kernel's threshold; nothing else) and every kernel
   it launches but K3 held against its plain twin, bit for bit, at each
   shape the run gives it (`_held_kernels`: the first call at each
   signature, copied and compared after the run): train_at_scale
   at full width (`SCALE_ARGV`: the factory on 2 + 2 scenes of the
   procedural catalog, 6 steps at b = 4 on 25,600 points, validation, the
   QA on the fitted weights, the steady-state loop; step ms, peak
   memory), detect_qa on its checkpoint (the same QA dict),
   demo_full_system, datagen_mesh_qa --procedural, parity_at_speed's six
   modes (quality on the at-scale run), measure_fps_sharded at G = 128 and
   1 (each in a process of its own), trace_forward --json at b = 1 and 2
   with trace_diff over the tables, r3_summarize over the tools' logs, and
   host_ops (native equal to numpy on 4,096 points, host ms on the whole
   tabletop) with guard's probes; then data parallelism on the one card
   (`_multi_device_phase`): two gloo ranks sharing cuda:0, spawned, each
   serving its half of a B = 4 detect_batch (each rank's scenes bit for
   bit a single process's call on the same draws) and training the
   deployed configuration at global b = 4 (the ranks bit-equal after each
   step, the losses within bf16's tolerance of one process's, launches
   per step the single step's), a float64 step of a narrow configuration
   against one process within 1e-9, and an NCCL world of one bit for bit
   the same calls without a mesh (each rank's launches on a line of their
   own).  Where `mujoco` does not import (the
   card's machine), TableEnv and DirectionGenerator are replaced by seeded
   stand-ins for these phases (`_mujoco_standins`), and the run says so.
   Each run's launch counters are zeroed before it and read after it (a
   train or val step's around each step; a tool's around its `main`:
   its forwards are known from its arguments, `_forward_launches`, except
   profile_stages', whose graph captures make the count arbitrary: there
   each kernel of the path must launch and no other, and the path is left
   out of the kernels line's launches), and every kernel must
   launch exactly its count per forward (`_deployed_launches`,
   `_parity_launches`, `FUSED_K7_LAUNCHES`), given the SA1 overflows the
   run reported (the stream: per frame); over the counted fused-chain runs the packed-operand
   cache must hit on every chain and pack none;
5. profile: one detect, one detect_batch at b = 2, one parity detect and
   one fused-chain detect under torch.profiler (and a train step, in
   `_train_phase`) — device time by kernel and the device's idle share.

Then one JSON line with every kernel's numbers and, last, the contract line
`{"ok": true, "device": {...}}`.  Without a CUDA device, or without the
package beside this script, it exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import json
import os
import pickle
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
    from s4g_tpu_torch.utils.profiling import event_ms
    return event_ms(fn, reps, warmup)


def _graph_ms(fn, reps: int = 20, per_graph: int = 10) -> float:
    """Median device time of one fn() launch: `per_graph` launches captured
    in a CUDA graph, the replay timed with CUDA events, `reps` times."""
    from s4g_tpu_torch.utils.profiling import graph_ms
    return graph_ms(fn, reps, per_graph)


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


def _k5_work(g2l, cv):
    """K5's needed work on this data: (operations, bytes, (pose, valid
    point) pairs, pairs inside the z slab).  Every pair pays its z row (3
    mul + 3 add) and the z-slab test (~8 operations); only the pairs
    inside the slab pay the x and y rows and the box tests (~22 more)."""
    from s4g_tpu_torch.pipeline import collision as col
    g = g2l.shape[0]
    live = cv[:, 3] > 0.5
    pairs = float(g * int(live.sum()))
    pts = cv[live, :3]
    m = g2l.reshape(g, 16)
    in_z = 0
    for g0 in range(0, g, 128):
        mm = m[g0:g0 + 128, :, None]
        z = (pts[:, 0] * mm[:, 8] + pts[:, 1] * mm[:, 9]
             + pts[:, 2] * mm[:, 10] + mm[:, 11])
        in_z += int((z.abs() < col._BOX[2]).sum())
    return (8.0 * pairs + 22.0 * in_z, 64 * g + 16 * cv.shape[0] + 8 * g,
            pairs, in_z)


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
    # FMA-less floors, in FP32 instructions at one per lane per clock (half
    # the FMA-counted peak): ~28 a pair when every pair is tested in full
    # (6 mul + 6 add + 3 rounded row sums' adds, 10 compares, selects), and
    # the pruned count above.
    ops, nbytes, pairs, in_z = _k5_work(g2l, cv)
    bound, by = _bound_ms(ops, nbytes)
    rate = PEAK_F32_FLOPS / 2
    extras["collision_counts"] = {
        "floor_ms": 1e3 * 28.0 * pairs / rate,
        "pruned_floor_ms": 1e3 * ops / rate,
        "pairs": pairs, "pairs_in_z_slab": float(in_z),
        "raster_order_ms": ms_raster}
    print(f"kernel collision_counts: {g2l.shape[0]} poses x "
          f"{int((cv[:, 3] > 0.5).sum())} valid of "
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


# -- training --------------------------------------------------------------------

TRAIN_SCENES = 6
TRAIN_FRAMES = 600
TRAIN_FRAME_POINTS = 512      # tools/train.py's --num-frame-points default
NARROW_TRAIN = {**NARROW, "MODEL": {**NARROW["MODEL"], "PN2": {
    **NARROW["MODEL"]["PN2"], "DROPOUT_PROB": 0.0}},
    "TRAIN": {"BATCH_SIZE": 2}}


def train_scene(rng, num_frames: int = TRAIN_FRAMES, num_objects: int = 5):
    """A seeded scene in the training dump format: a camera-frame tabletop
    as `point_cloud` (3, N); `num_frames` of its points with grasp frames
    (random rotations, origins at the 0.02-0.08 m depth bins along the
    frame's x axis), search and antipodal scores, object labels and an
    (objects + 1, 5) pushed-distance `direction` table."""
    import numpy as np
    cloud = tabletop_cloud(rng)
    valid = rng.choice(len(cloud), num_frames, replace=False)
    q, r = np.linalg.qr(rng.randn(num_frames, 3, 3))
    q = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    q[np.linalg.det(q) < 0, :, 2] *= -1
    depth = rng.choice([0.02, 0.04, 0.06, 0.08], num_frames)
    frames = np.tile(np.eye(4), (num_frames, 1, 1))
    frames[:, :3, :3] = q
    frames[:, :3, 3] = cloud[valid] - depth[:, None] * q[:, :, 0]
    return {"point_cloud": cloud.T.copy(), "valid_index": valid,
            "valid_frame": frames.astype(np.float32),
            "search_score": rng.uniform(0, 30, num_frames).astype(np.float32),
            "antipodal_score": rng.uniform(0, 1, num_frames)
            .astype(np.float32),
            "objects_label": rng.randint(0, num_objects + 1, num_frames),
            "direction": rng.uniform(-0.05, 0.15, (num_objects + 1, 5))
            .astype(np.float32)}


def _train_data(np) -> str:
    """TRAIN_SCENES seeded scene pickles written into the (gitignored)
    build directory's train_data/, emptied first.  Returns the directory."""
    import pickle
    import shutil
    from s4g_tpu_torch import _build
    root = os.path.join(_build.BUILD_DIR, "train_data")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    for i in range(TRAIN_SCENES):
        with open(os.path.join(root, f"{i}_view_0.p"), "wb") as f:
            pickle.dump(train_scene(np.random.RandomState(200 + i)), f)
    return root


def _train_logger():
    """The trainers' logger: stdout only, set up once."""
    import logging
    from s4g_tpu_torch.utils.logger import setup_logger
    logger = logging.getLogger("chip_smoke.train")
    return logger if logger.handlers else setup_logger("chip_smoke.train", "")


def _train_config(**train):
    """The port's curvature_model.yaml as it stands (full width, bf16,
    DROPOUT_PROB 0.5 by default), TRAIN keys `train` replaced."""
    import yaml
    from s4g_tpu_torch.configs.config import load_cfg_from_dict
    from s4g_tpu_torch.pipeline.detector import _CONFIG_DIR
    with open(os.path.join(_CONFIG_DIR, "curvature_model.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["TRAIN"].update(train)
    return load_cfg_from_dict(cfg)


def _grad_spread(got: dict, want: dict) -> tuple:
    """Largest max |got - want| of a gradient over its tensor's largest
    (`want`'s), the tensor it is in, and the least cosine, over the
    tensors whose largest is above 1e-6 of the model's largest (below it a
    gradient is zero but for rounding: a BatchNorm after it takes out what
    it would move)."""
    top = max(float(w.abs().max()) for w in want.values())
    worst, where, cos_min = 0.0, None, 1.0
    for name, w in want.items():
        g, w = got[name].double(), w.double()
        scale = float(w.abs().max())
        if scale <= 1e-6 * top:
            continue
        err = float((g - w).abs().max()) / scale
        if err > worst:
            worst, where = err, name
        cos_min = min(cos_min, float((g * w).sum() / (g.norm() * w.norm())))
    return worst, where, cos_min


def _f64_net(net):
    """`net` in float64 throughout, the oracle of an f32 step's rounding:
    its BatchNorm inputs too (on this instance, each PointConv's rounding
    to f32 before its BatchNorm is left out).  The cloud stays f32, so
    every neighbour index is the f32 run's."""
    import types
    import torch
    from s4g_tpu_torch.models import nn_layers

    def forward(self, x):
        w = self.conv.weight.reshape(self.conv.out_channels, -1)
        return torch.relu(nn_layers.batch_norm(
            torch.matmul(x.to(self.dtype), w.t().to(self.dtype)), self.bn))

    net.double()
    for m in net.modules():
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = torch.float64
        if isinstance(m, nn_layers.PointConv):
            m.forward = types.MethodType(forward, m)
    return net


def _step_on(cfg, batch, state, dev, name, f64=False):
    """One train step of a fresh Trainer of `cfg` on `dev` from the
    state_dict `state` (made by the first call when None), in float64
    with `f64` (`_f64_net`; the batch's f32 arrays but the cloud in
    float64 too): (state, its scalars, gradients and BatchNorm running
    statistics on the host)."""
    import numpy as np
    from s4g_tpu_torch.train.trainer import Trainer
    tr = Trainer(cfg, output_dir=_output_dir(f"{name}_{dev}"), device=dev,
                 logger=_train_logger())
    tr.init_state()
    if state is None:
        state = {k: v.detach().cpu().clone()
                 for k, v in tr.net.state_dict().items()}
    tr.net.load_state_dict(state)
    if f64:
        _f64_net(tr.net)
        batch = {k: v.astype(np.float64)
                 if v.dtype == np.float32 and k != "scene_points" else v
                 for k, v in batch.items()}
    scalars = tr.train_step(batch)
    return state, {
        "scalars": {k: float(v) for k, v in scalars.items()},
        "grads": {n: p.grad.detach().cpu() for n, p in
                  tr.net.named_parameters()},
        "stats": {k: v.detach().cpu() for k, v in tr.net.state_dict().items()
                  if "running" in k}}


def _compare_steps(label, cpu, gpu, grad_tol=2e-2, cos_tol=0.9999):
    """A train step on the two devices: the losses within 1e-5 relative,
    the accuracies within 2e-3 (a point or two of a near tie), R_err within
    1e-4; each gradient within `grad_tol` of its tensor's largest and at
    cosine >= `cos_tol`; each BatchNorm running statistic after the step
    within 1e-5 of its tensor's largest.  Returns (the worst of each,
    the failures)."""
    res = {"max_loss_rel": 0.0, "max_acc_err": 0.0, "max_grad_err": 0.0,
           "min_grad_cos": 1.0, "max_stat_err": 0.0}
    bad = []
    for k, want in cpu["scalars"].items():
        got = gpu["scalars"][k]
        if k.endswith("_acc"):
            res["max_acc_err"] = max(res["max_acc_err"], abs(got - want))
            ok = abs(got - want) <= 2e-3
        else:
            rel = abs(got - want) / max(abs(want), 1e-30)
            ok = rel <= (1e-4 if k == "R_err" else 1e-5)
            if k != "R_err":
                res["max_loss_rel"] = max(res["max_loss_rel"], rel)
        if not ok:
            bad.append(f"{label} {k}: GPU {got}, CPU {want}")
    for name, want in cpu["grads"].items():
        got = gpu["grads"][name].double()
        want = want.double()
        scale = float(want.abs().max())
        err = float((got - want).abs().max()) / max(scale, 1e-30)
        cos = float((got * want).sum() / (got.norm() * want.norm()))
        res["max_grad_err"] = max(res["max_grad_err"], err)
        if scale > 1e-6:
            res["min_grad_cos"] = min(res["min_grad_cos"], cos)
        if err * scale > grad_tol * scale + 1e-7 or (scale > 1e-6
                                                     and cos < cos_tol):
            bad.append(f"{label} gradient {name}: max |GPU - CPU| "
                       f"{err:.3g} of its max, cosine {cos}")
    for k, want in cpu["stats"].items():
        err = float((gpu["stats"][k] - want).abs().max()) / max(
            float(want.abs().max()), 1e-30)
        res["max_stat_err"] = max(res["max_stat_err"], err)
        if err > 1e-5:
            bad.append(f"{label} {k} after the step: {err:.3g} of its max")
    return res, bad


def _train_reference_phase(torch, np, devices=("cpu", "cuda")):
    """One train step at a narrow width that takes every kernel route of
    the deployed train step (NARROW: SA1 through K2, SA2 and SA3 through
    K2f, FP 8192 <- 1024 through K4, FPS nested through K1), f32, dropout
    0, no augmentation, b = 2, on the GPU and on the CPU (plain twins) from
    the same state_dict and batch (`_compare_steps`; the two devices' sums
    run in other orders, so GPU vs CPU is not bit for bit; each gradient
    within 2e-2 of its tensor's largest, as train-mode BatchNorm amplifies
    f32 rounding).  Every comparison is made before the first failure is
    raised, so the result names the worst of each.

    Where the GPU's gradients part from the CPU's: the GPU step runs twice
    more, once as before, which must give the same gradients bit for bit
    (the gathers' backward is K8, in a fixed order), and once under
    `torch.use_deterministic_algorithms(True, warn_only=True)` (the ops
    without a deterministic CUDA version warn and run as before; they are
    counted), and the same step runs in float64 on both devices
    (`_f64_net`); printed beside the GPU-vs-CPU spread (`_grad_spread`:
    the largest error over its tensor's largest, and the least cosine):
    the GPU's spread between its own runs, the float64 steps' spread
    between the devices (which must be within 1e-6: the two devices
    compute the same function) and each f32 step's distance from the
    float64 one.  The 2e-2 gate stays on GPU vs CPU."""
    import warnings
    from s4g_tpu_torch.configs.config import load_cfg_from_dict
    from s4g_tpu_torch.train.dataset import SceneGraspDataset

    cfg = load_cfg_from_dict(NARROW_TRAIN)
    batch = next(iter(SceneGraspDataset(
        _train_data(np), num_points=cfg.MODEL.PN2.NUM_INPUT,
        batch_size=2, num_frame_points=128, seed=0)))
    state, cpu = _step_on(cfg, batch, None, devices[0], "train_ref")
    _, gpu = _step_on(cfg, batch, state, devices[1], "train_ref")
    res, bad = _compare_steps("train step", cpu, gpu)
    print(f"train reference: {res}", flush=True)
    _, again = _step_on(cfg, batch, state, devices[1], "train_ref")
    if devices[1] != "cpu":
        torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            _, det = _step_on(cfg, batch, state, devices[1], "train_ref")
    finally:
        torch.use_deterministic_algorithms(False)
    nondet = sorted({str(w.message).split(" does not have a deterministic")
                     [0] for w in caught
                     if "deterministic" in str(w.message)})
    _, cpu64 = _step_on(cfg, batch, state, devices[0], "train_ref", True)
    _, gpu64 = _step_on(cfg, batch, state, devices[1], "train_ref", True)
    spread = {}
    for key, (a, b) in {"gpu_vs_cpu": (gpu, cpu),
                        "gpu_vs_gpu": (again, gpu),
                        "deterministic_vs_gpu": (det, gpu),
                        "deterministic_vs_cpu": (det, cpu),
                        "f64_gpu_vs_f64_cpu": (gpu64, cpu64),
                        "gpu_vs_f64": (gpu, cpu64),
                        "cpu_vs_f64": (cpu, cpu64)}.items():
        err, where, cos = _grad_spread(a["grads"], b["grads"])
        spread[key] = {"max_grad_err": err, "at": where, "min_cos": cos}
    if not all(torch.equal(again["grads"][n], g)
               for n, g in gpu["grads"].items()):
        bad.append(f"the GPU's step rerun: gradients differ by "
                   f"{spread['gpu_vs_gpu']}")
    if spread["f64_gpu_vs_f64_cpu"]["max_grad_err"] > 1e-6:
        bad.append(f"float64 steps: gradients differ by "
                   f"{spread['f64_gpu_vs_f64_cpu']}")
    res["spread"] = spread
    res["nondeterministic_ops"] = nondet
    print("train reference spread: "
          + "; ".join(f"{k} {v['max_grad_err']:.3g} of its max at {v['at']}"
                      f" (min cosine {v['min_cos']:.7f})"
                      for k, v in spread.items())
          + f"; ops without a deterministic CUDA version: {nondet}",
          flush=True)
    if bad:
        raise AssertionError("; ".join(bad))
    return res


def _k8_per_step(net) -> int:
    """K8 launches of one train step's backward of `net` (a PointNet2
    backbone): one for each gather whose source carries a gradient: the
    grouping of every SA stage that has features (but the global one, which
    gathers nothing), an edge stage's centroid features where it samples,
    and an FP stage's 3-NN gathers (one per neighbour; an edge FP stage
    groups the three in one).  The widest-axis sort and restore are
    permutations and keep torch.gather."""
    from s4g_tpu_torch.models.pn2_modules import EdgeFPModule
    count, features = 0, False
    for sa in net.sa_modules:
        if features and sa.num_centroids != 0:
            count += 1 + int(sa.edge and sa.num_centroids > 0)
        features = True
    return count + sum((1 if isinstance(fp, EdgeFPModule) else 3)
                       for fp in net.fp_modules if fp.num_neighbors == 3)


K8_BATCH = 4             # the deployed step's batch in the K8 phase


def _k8_cases(torch, np, device: str = "cuda"):
    """The inputs of every K8 call in one deployed train step at b =
    K8_BATCH (`_train_config`: full width, bf16, dropout 0.5; the train
    phase's scene pickles): `ops.gather.gather_backward` wrapped to keep
    each call's (gradient, index, N), in the backward's order (FP3's
    three neighbours, FP2's, FP1's, SA3, SA2)."""
    from s4g_tpu_torch.ops import gather as gt
    from s4g_tpu_torch.train.dataset import SceneGraspDataset
    from s4g_tpu_torch.train.trainer import Trainer

    cfg = _train_config(BATCH_SIZE=K8_BATCH)
    batch = next(iter(SceneGraspDataset(
        _train_data(np), num_points=cfg.MODEL.PN2.NUM_INPUT,
        score_classes=cfg.DATA.SCORE_CLASSES, batch_size=K8_BATCH,
        num_frame_points=TRAIN_FRAME_POINTS, t_classification=True,
        seed=cfg.RNG_SEED,
        num_removal_directions=cfg.DATA.NUM_REMOVAL_DIRECTIONS)))
    tr = Trainer(cfg, output_dir=_output_dir("k8"), device=device,
                 logger=_train_logger())
    tr.init_state()
    cases, real = [], gt.gather_backward

    def keep(grad, index, n):
        cases.append((grad.detach().clone(), index.clone(), n))
        return real(grad, index, n)

    gt.gather_backward = keep
    try:
        tr.train_step(batch)
    finally:
        gt.gather_backward = real
    if len(cases) != _k8_per_step(tr.net):
        raise AssertionError(f"K8: {len(cases)} calls in a step, expected "
                             f"{_k8_per_step(tr.net)}")
    return cases


def _k8_phase(torch, np, extras, device: str = "cuda"):
    """K8 (the fixed-order gather backward) at each of its calls in a
    deployed train step at b = K8_BATCH (`_k8_cases`): the kernel on the
    call's row lists held bit for bit against its twin on the card (the
    same f32 adds in the same order); timed per call (CUDA-graph replays):
    the kernel alone, the whole backward with its stable sort and offsets
    (`gather_backward`), the library's atomic `index_add_` into zeros (the
    route torch.gather's backward takes, in no fixed order), and torch's
    scatter-add under `use_deterministic_algorithms` (event-timed: it may
    wait on the device); the twin event-timed.  The bound: every source
    gradient read once, every destination written once, the order and
    offset lists (4 B an entry), over the HBM rate.  Returns the kernels
    line's tuple, per step (the calls' sums)."""
    from s4g_tpu_torch import _build
    from s4g_tpu_torch.ops import gather as gt

    calls, err = [], 0.0
    for grad, index, n in _k8_cases(torch, np, device):
        b, m, c = grad.shape
        g2 = grad.reshape(b * m, c)
        order, offsets = gt.row_lists(index, n)
        code = gt._DTYPES[grad.dtype]
        out = torch.empty(b * n, c, dtype=grad.dtype, device=grad.device)

        def kernel():
            _build.launch("gather_backward", g2, order, offsets, b * n, c,
                          code, out)

        kernel()
        want = gt._fixed_order_sum(g2, order, offsets)
        err = max(err, _compare(f"gather_backward {b}x{m}x{c} -> {n}",
                                [out], [want], True))
        dest = (index.long() + n * torch.arange(
            b, device=index.device)[:, None]).reshape(-1)
        scatter_idx = index.long()[..., None].expand(-1, -1, c)
        k_ms = _graph_ms(kernel)
        full_ms = _graph_ms(lambda: gt.gather_backward(grad, index, n))
        lib_ms = _graph_ms(lambda: torch.zeros(
            b * n, c, dtype=grad.dtype, device=grad.device).index_add_(
                0, dest, g2))
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            def scatter():
                return torch.zeros(b, n, c, dtype=grad.dtype,
                                   device=grad.device).scatter_add_(
                    1, scatter_idx, grad)
            det_ms = _event_ms(scatter, reps=5, warmup=1)
            det_same = torch.equal(scatter().reshape(b * n, c), want)
        finally:
            torch.use_deterministic_algorithms(False)
        p_ms = _event_ms(lambda: gt._fixed_order_sum(g2, order, offsets),
                         reps=3, warmup=1)
        es = grad.element_size()
        nbytes = (b * m + b * n) * c * es + 4 * (b * m + b * n + 1)
        b_ms = 1e3 * nbytes / PEAK_BYTES
        sources = (offsets[1:] - offsets[:-1]).long()
        row = {"shape": f"{b}x{m}x{c} -> {b}x{n}x{c}",
               "dtype": str(grad.dtype), "ms": k_ms, "backward_ms": full_ms,
               "bound_ms": b_ms, "plain_ms": p_ms, "library_ms": lib_ms,
               "deterministic_ms": det_ms,
               "deterministic_equals_k8": det_same,
               "most_sources_a_row": int(sources.max()),
               "rows_without_source": int((sources == 0).sum())}
        calls.append(row)
        print(f"kernel gather_backward {row['shape']} ({row['dtype']}): "
              f"kernel {k_ms:.4f} ms, with its sort {full_ms:.4f}, bound "
              f"{b_ms:.4f} (bytes), atomic index_add_ {lib_ms:.4f}, "
              f"deterministic scatter_add_ {det_ms:.4f} (equal to K8: "
              f"{det_same}), plain {p_ms:.3f}; most sources a row "
              f"{row['most_sources_a_row']}, rows without one "
              f"{row['rows_without_source']}", flush=True)
    step = {k: sum(r[k] for r in calls) for k in (
        "ms", "backward_ms", "bound_ms", "plain_ms", "library_ms",
        "deterministic_ms")}
    extras["gather_backward"] = {
        "library_ms": step["library_ms"],
        "backward_ms_per_step": step["backward_ms"],
        "deterministic_ms_per_step": step["deterministic_ms"],
        "calls_per_step": calls, "card": _nvidia_smi()}
    return ("gather_backward", "s4g_tpu_torch/csrc/gather_backward.cu",
            "none: the backward of s4g_tpu/ops/gather.py:5-7 (XLA "
            "scatter-add; no Pallas kernel)", err, step["ms"],
            step["plain_ms"], step["bound_ms"], "bytes")


def _cuda_event(torch):
    return torch.cuda.Event(enable_timing=True)


def _instrument(trainer, kind_launches, shim, records, torch):
    """Wrap `trainer`'s steps (instance attributes, which `fit` calls): each
    train and val step's launches are counted on their own and must be
    exactly `_deployed_launches` at the batch, given the SA1 overflow the
    step reported (train: K2, or K2f on overflow, and K8 once per gather
    with a gradient, `_k8_per_step`; val, eval at b = 2: K3, or K2f on
    overflow; no K5); a train step's scalars are kept, and CUDA
    events time the whole step and its forward (with the loss), backward
    and optimizer update."""
    from s4g_tpu_torch import _build
    from s4g_tpu_torch.ops import neighbors as nb
    from s4g_tpu_torch.ops import sa_fused as sf

    b = trainer.cfg.TRAIN.BATCH_SIZE

    def counted(kind, fn, fused):
        def step(batch):
            before = dict(_build.LAUNCHES)
            over = nb.SLAB_FALLBACKS["overflow"] + sf.SA1_FALLBACKS["overflow"]
            start = _cuda_event(torch)
            start.record()
            result = fn(batch)
            end = _cuda_event(torch)
            end.record()
            launches = {k: _build.LAUNCHES[k] - before[k] for k in before}
            overflow = (nb.SLAB_FALLBACKS["overflow"]
                        + sf.SA1_FALLBACKS["overflow"]) > over
            want = {**_deployed_launches(shim, b, overflow, fused=fused),
                    "collision_counts": 0,
                    "gather_backward": (0 if kind == "val"
                                        else _k8_per_step(trainer.net))}
            if launches != want:
                raise AssertionError(f"{kind} step: launches {launches}, "
                                     f"expected {want}")
            kind_launches[kind] = _add(kind_launches[kind], launches)
            records[kind].append({"overflow": overflow, "events": [
                ("step", start, end)]})
            if kind == "train":
                records[kind][-1]["scalars"] = result
                records[kind][-1]["events"] += records.pop("parts", [])
            return result
        return step

    def timed(name, fn):
        def part(*args):
            start = _cuda_event(torch)
            start.record()
            result = fn(*args)
            end = _cuda_event(torch)
            end.record()
            records.setdefault("parts", []).append((name, start, end))
            return result
        return part

    for name, label in (("forward_loss", "forward"), ("backward", "backward"),
                        ("update", "optimizer")):
        setattr(trainer, name, timed(label, getattr(trainer, name)))
    trainer.train_step = counted("train", trainer.train_step, False)
    trainer.val_step = counted("val", trainer.val_step, True)


def _train_syncs(trainer, batch, torch):
    """The host's waits on the device in one train step, counted with
    `torch.cuda.set_sync_debug_mode("warn")` by the line that made each."""
    import collections
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            trainer.train_step(batch)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    where = collections.Counter(
        f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))
    return sum(where.values()), dict(where.most_common())


def _train_phase(torch, np, device: str = "cuda"):
    """Training at full width (`_train_config`: the port's
    curvature_model.yaml, PN2_CLS, bf16, 25,600 points, b = 2, Adam 1e-3,
    StepLR 20 / 0.5, dropout 0.5) on TRAIN_SCENES synthetic scene pickles:
    SceneGraspDataset (512 frame points) -> FileBackedSceneLoader ->
    Trainer.fit for one epoch of 3 steps, validating on the same data;
    then a new Trainer resumes from `last_checkpoint` (step 3, the first
    trainer's weights) and fits epoch 2 (steps 3 -> 6); then one more step
    with the host's synchronizations counted, one profiled step, and one
    step of a third trainer, resumed, with every augmentation on.  Every
    train and val step's launches are held exactly (`_instrument`); the
    scalars must be finite, and every parameter and BatchNorm running
    statistic must have moved.  Then the deployed step at b = K8_BATCH
    twice from one state, bit for bit (`_rerun_phase`).  Prints the median
    step ms after the first, split into forward, backward and optimizer,
    the peak device memory and the synchronizations per step.  Returns the
    launches of the train and val steps and of the rerun, and those
    numbers."""
    from types import SimpleNamespace
    from s4g_tpu_torch.runtime.loader import FileBackedSceneLoader
    from s4g_tpu_torch.train.dataset import SceneGraspDataset
    from s4g_tpu_torch.train.trainer import Trainer

    root = _train_data(np)
    cfg = _train_config()
    pn2 = cfg.MODEL.PN2

    def loader():
        ds = SceneGraspDataset(
            root, num_points=pn2.NUM_INPUT,
            score_classes=cfg.DATA.SCORE_CLASSES,
            batch_size=cfg.TRAIN.BATCH_SIZE,
            num_frame_points=TRAIN_FRAME_POINTS, t_classification=True,
            seed=cfg.RNG_SEED,
            num_removal_directions=cfg.DATA.NUM_REMOVAL_DIRECTIONS)
        return FileBackedSceneLoader(ds, num_workers=cfg.DATA.NUM_WORKERS)

    train_data, val_data = loader(), loader()
    steps_per_epoch = len(train_data)
    out = _output_dir("train")
    logger = _train_logger()
    shim = SimpleNamespace(cfg=cfg, num_input=pn2.NUM_INPUT)
    launches = {"train": {}, "val": {}}
    records = {"train": [], "val": []}

    def trainer(config=cfg):
        tr = Trainer(config, output_dir=out, steps_per_epoch=steps_per_epoch,
                     device=device, logger=logger)
        start = tr.resume_or_init()
        _instrument(tr, launches, shim, records, torch)
        return tr, start

    torch.cuda.reset_peak_memory_stats()
    first, start = trainer()
    if start.step != 0:
        raise AssertionError(f"a fresh output directory resumed at step "
                             f"{start.step}")
    before = {k: v.detach().clone() for k, v in start.model.items()
              if "num_batches" not in k}
    done = first.fit(train_data, val_data=val_data, max_epochs=1)
    moved = [k for k, v in before.items() if not torch.equal(v,
                                                              done.model[k])]
    if done.step != steps_per_epoch or len(moved) != len(before):
        raise AssertionError(f"epoch 1: step {done.step}; "
                             f"{len(before) - len(moved)} tensors unchanged")
    second, resumed = trainer()
    if resumed.step != steps_per_epoch or not all(
            torch.equal(resumed.model[k], v) for k, v in done.model.items()):
        raise AssertionError(f"resumed at step {resumed.step}, or not at "
                             "the first trainer's weights")
    final = second.fit(train_data, val_data=val_data, max_epochs=2)
    if final.step != 2 * steps_per_epoch:
        raise AssertionError(f"epoch 2 ended at step {final.step}")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    batch = list(train_data)[0]     # a whole pass: the workers finish
    syncs, where = _train_syncs(second, batch, torch)
    profile = _train_profile(second, batch, torch)
    aug_cfg = _train_config(AUGMENTATION=(
        "PointCloudRotate", ("PointCloudRotatePerturbation", 0.06, 0.18),
        ("PointCloudTranslate", 0.02), ("PointCloudJitter", 0.002, 0.01)))
    third, start = trainer(aug_cfg)
    if start.step != 2 * steps_per_epoch:
        raise AssertionError(f"augmented trainer resumed at {start.step}")
    third.train_step(batch)
    rerun = _rerun_phase(torch, np, device)

    for rec in records["train"]:
        bad = [k for k, v in rec["scalars"].items()
               if not bool(torch.isfinite(v))]
        if bad:
            raise AssertionError(f"non-finite train scalars {bad}")
    torch.cuda.synchronize()
    timed = [{name: s.elapsed_time(e) for name, s, e in rec["events"]}
             for rec in records["train"][1:2 * steps_per_epoch]]
    med = {k: statistics.median(t[k] for t in timed) for k in timed[0]}
    numbers = {"step_ms": med["step"], "forward_ms": med["forward"],
               "backward_ms": med["backward"],
               "optimizer_ms": med["optimizer"], "peak_gib": peak_gib,
               "host_syncs_per_step": syncs,
               "train_steps": len(records["train"]),
               "val_steps": len(records["val"]),
               "train_sa1_overflows": sum(r["overflow"]
                                          for r in records["train"]),
               "val_sa1_overflows": sum(r["overflow"]
                                        for r in records["val"])}
    print(f"train ({_nvidia_smi()}): median of {len(timed)} steps after the "
          f"first: step {med['step']:.2f} ms = forward + loss "
          f"{med['forward']:.2f}, backward {med['backward']:.2f}, optimizer "
          f"{med['optimizer']:.2f}; peak memory {peak_gib:.2f} GiB; host "
          f"synchronizations in one step: {syncs} {where}", flush=True)
    print(f"train: {numbers['train_steps']} train steps (resumed at step "
          f"{steps_per_epoch}, one with every augmentation), "
          f"{numbers['val_steps']} val steps; SA1 overflows train "
          f"{numbers['train_sa1_overflows']}, val "
          f"{numbers['val_sa1_overflows']}; launches {launches}; last "
          f"scalars " + ", ".join(
              f"{k} {float(v):.4f}"
              for k, v in records["train"][-1]["scalars"].items()),
          flush=True)
    numbers["profile"] = profile
    numbers["rerun"] = rerun[1]
    return ({"train_step": launches["train"], "val_step": launches["val"],
             "train_step_rerun": rerun[0]}, numbers)


def _rerun_phase(torch, np, device: str = "cuda"):
    """The deployed train step (`_train_config`: full width, bf16, dropout
    0.5) at b = K8_BATCH run twice from one state, the model, the
    optimizer's moments and the generator restored in between
    (`tools/train_repeat.rerun`), each step's launches exact
    (`_instrument`, K8 `_k8_per_step` times): the scalars, every gradient
    and the state after the update (parameters after Adam, BatchNorm
    statistics) must be equal bit for bit.  Returns the launches of the
    two steps and the spread."""
    from types import SimpleNamespace
    from s4g_tpu_torch.tools.train_repeat import rerun
    from s4g_tpu_torch.train.dataset import SceneGraspDataset
    from s4g_tpu_torch.train.trainer import Trainer

    cfg = _train_config(BATCH_SIZE=K8_BATCH)
    batch = next(iter(SceneGraspDataset(
        _train_data(np), num_points=cfg.MODEL.PN2.NUM_INPUT,
        score_classes=cfg.DATA.SCORE_CLASSES, batch_size=K8_BATCH,
        num_frame_points=TRAIN_FRAME_POINTS, t_classification=True,
        seed=cfg.RNG_SEED,
        num_removal_directions=cfg.DATA.NUM_REMOVAL_DIRECTIONS)))
    tr = Trainer(cfg, output_dir=_output_dir("train_rerun"), device=device,
                 logger=_train_logger())
    tr.init_state()
    launches, records = {"train": {}, "val": {}}, {"train": [], "val": []}
    _instrument(tr, launches, SimpleNamespace(
        cfg=cfg, num_input=cfg.MODEL.PN2.NUM_INPUT), records, torch)
    spread = rerun(tr, batch)
    print(f"train rerun ({_nvidia_smi()}): the deployed step at b = "
          f"{K8_BATCH} twice from one state: {json.dumps(spread)}; "
          f"launches of the two {launches['train']}", flush=True)
    if not all(v["bit_equal"] for v in spread.values()):
        raise AssertionError(f"the deployed train step does not repeat: "
                             f"{spread}")
    return launches["train"], spread


# -- the other model types ---------------------------------------------------

EDGE_MODELS = ("EDGEPN2D", "EDGEPN2DU")
# A narrow four-stage pyramid of the reference's shape for the edge models'
# GPU-vs-CPU runs: unsorted, so every FPS is K6 and every ball query K2f;
# FP 8192 <- 2048 takes K4 (the two smaller 3-NN stages are below its pair
# threshold); the last stage is global and its FP a broadcast.
NARROW_EDGE_SECTION = {
    "NUM_CENTROIDS": (2048, 512, 128, 0), "RADIUS": (0.02, 0.08, 0.32, -1.0),
    "NUM_NEIGHBOURS": (32, 32, 32, -1),
    "SA_CHANNELS": ((32, 32, 64), (64, 64, 64), (64, 64, 128), (128, 128)),
    "FP_CHANNELS": ((64, 64), (64, 64), (64, 64), (64, 32)),
    "NUM_FP_NEIGHBOURS": (0, 3, 3, 3), "SEG_CHANNELS": (64, 32)}


def _narrow_edge(model_type: str) -> dict:
    """An f32 config of `model_type` whose own section is
    NARROW_EDGE_SECTION (NUM_INPUT stays in MODEL.PN2, as the detector
    reads it)."""
    return {"MODEL": {"TYPE": model_type, "COMPUTE_DTYPE": "float32",
                      "PN2": {"NUM_INPUT": 8192},
                      model_type: dict(NARROW_EDGE_SECTION)},
            "DATA": {"SCORE_CLASSES": 3}}


def _edge_reference_phase(torch, np, devices=("cpu", "cuda")):
    """`_reference_phase` for EDGEPN2D and EDGEPN2DU at `_narrow_edge`,
    with small translation residuals (`_small_t_logit`): on the GPU the
    forward and post-processing must launch K6, K2f, K4 and K5, and no K1,
    K2 or K3."""
    from s4g_tpu_torch import _build

    out = {}
    for model_type in EDGE_MODELS:
        before = dict(_build.LAUNCHES)
        out[model_type] = _reference_phase(
            torch, np, devices, config=_narrow_edge(model_type),
            prepare=_small_t_logit)
        ran = {k: _build.LAUNCHES[k] - before[k] for k in before}
        idle = [k for k in ("fps_exact", "ball_query_full", "three_nn",
                            "collision_counts") if not ran[k]]
        stray = [k for k in ("fps_lane", "ball_query_slab", "sa1_fused")
                 if ran[k]]
        if devices[1] != "cpu" and (idle or stray):
            raise AssertionError(f"{model_type} reference: launches {ran}")
    return out


def _edge_launches(det, b: int) -> dict:
    """Launches per forward of an edge detector at batch `b` (its section
    unsorted, the PN2Config default): K6 for each SA stage with centroids
    > 0, K2f for each but the global stage, K4 for each 3-NN FP stage at or
    above its pair threshold, K5 once per scene; never K1, K2, K3 or K7."""
    from s4g_tpu_torch import _build
    from s4g_tpu_torch.ops.neighbors import KERNEL_MIN_PAIRS
    sec = getattr(det.cfg.MODEL, det.cfg.MODEL.TYPE)
    if sec.SORT_POINTS:
        raise ValueError("_edge_launches counts unsorted sections only")
    levels = [det.num_input]
    for m in sec.NUM_CENTROIDS:
        levels.append(levels[-1] if m == -1 else max(m, 1))
    fp = sum(k == 3 and levels[-2 - i] * levels[-1 - i] >= KERNEL_MIN_PAIRS
             for i, k in enumerate(sec.NUM_FP_NEIGHBOURS))
    return {**{k: 0 for k in _build.LAUNCHES},
            "fps_exact": sum(m > 0 for m in sec.NUM_CENTROIDS),
            "ball_query_full": sum(m != 0 for m in sec.NUM_CENTROIDS),
            "three_nn": fp, "collision_counts": b}


def _edge_kernel_phase(det, torch, np, extras):
    """K6 and K2f at the edge forward's shapes (the reference pyramid,
    unsorted: 25,600 -> 10,240 / 1,024 / 128 centroids, radii 0.2 / 0.3 /
    0.4, K = 64) on a prepared tabletop at b = 1: each stage's exact FPS
    against `_fps_plain` and ball query against `_ball_query_full`, bit for
    bit; each timed (CUDA-graph replays) beside the plain versions (K6's
    plain loop once), with its bound: 9 f32 operations a point and step for
    K6; for K2f 9 a pair up to each ball's K-th hit in index order, the
    tests the first-K scan needs on this data.  Adds `edge_*` numbers to
    `extras` under both kernels' rows."""
    from s4g_tpu_torch.models.pn2_modules import gather_cl
    from s4g_tpu_torch.ops import neighbors as nb
    from s4g_tpu_torch.ops import sampling as sp
    from s4g_tpu_torch.pipeline.detector import prep_batch

    sec = getattr(det.cfg.MODEL, det.cfg.MODEL.TYPE)
    padded, valid = det._pad_cloud(tabletop_cloud(np.random.RandomState(0)))
    gen = torch.Generator(device=det.device).manual_seed(8)
    calls = []
    with torch.no_grad():
        xyz = prep_batch(padded[None], valid[None], det.num_input,
                         generator=gen).transpose(1, 2).contiguous()
        for m, r, k in zip(sec.NUM_CENTROIDS, sec.RADIUS,
                           sec.NUM_NEIGHBOURS):
            if m <= 0:
                break
            idx = sp.fps_exact(xyz, m)
            cents = gather_cl(xyz.transpose(1, 2), idx).transpose(
                1, 2).contiguous()
            calls.append((xyz, m, cents, r, k))
            xyz = cents
    err, k6_ms, k2f_ms, k6_plain, k2f_plain = 0.0, [], [], 0.0, 0.0
    k6_ops = k6_bytes = k2f_ops = k2f_bytes = 0.0
    for p, m, c, r, k in calls:
        n = p.shape[2]
        err = max(err, _compare(f"edge fps_exact N={n} M={m}",
                                [sp.fps_exact(p, m)], [sp._fps_plain(p, m)],
                                True))
        want = nb._ball_query_full(p, c, r * r, k)
        err = max(err, _compare(f"edge ball_query_full N={n} M={m} r={r}",
                                nb.ball_query_full_scan(p, c, r, k), want,
                                True))
        k6_ms.append(_graph_ms(lambda p=p, m=m: sp.fps_exact(p, m), reps=5,
                               per_graph=3))
        k2f_ms.append(_graph_ms(lambda p=p, c=c, r=r, k=k:
                                nb.ball_query_full_scan(p, c, r, k)))
        k6_plain += _event_ms(lambda p=p, m=m: sp._fps_plain(p, m), reps=1,
                              warmup=0)
        k2f_plain += _event_ms(lambda p=p, c=c, r=r, k=k:
                               nb._ball_query_full(p, c, r * r, k), reps=3,
                               warmup=1)
        k6_ops += 9.0 * n * (m - 1)
        k6_bytes += 12 * n + 4 * m
        # The first-K scan of a ball stops at its K-th hit in index order
        # (every key when it has fewer): count those tests.
        last = torch.where(want[1] >= k, want[0][..., -1].long() + 1,
                           torch.full_like(want[1], n, dtype=torch.long))
        k2f_ops += 9.0 * float(last.sum())
        k2f_bytes += 12 * (n + m) + 4 * m * (k + 1)
    b6, by6 = _bound_ms(k6_ops, k6_bytes)
    b2f, by2f = _bound_ms(k2f_ops, k2f_bytes)
    extras.setdefault("fps_exact", {}).update(
        edge_per_forward_ms=sum(k6_ms), edge_per_stage_ms=k6_ms,
        edge_plain_ms=k6_plain, edge_bound_ms=b6, edge_bound_by=by6,
        edge_max_abs_err=err)
    extras.setdefault("ball_query_full", {}).update(
        edge_per_forward_ms=sum(k2f_ms), edge_per_stage_ms=k2f_ms,
        edge_plain_ms=k2f_plain, edge_bound_ms=b2f, edge_bound_by=by2f)
    blocks = [sp.fps_exact_plan(c[0].shape[2])[0] for c in calls]
    print(f"kernel fps_exact edge forward (b=1, stages "
          f"{[(c[0].shape[2], c[1]) for c in calls]}): "
          f"{', '.join(f'{t:.4f}' for t in k6_ms)} ms, {sum(k6_ms):.4f} ms "
          f"a forward; plain {k6_plain:.2f} ms; bound {b6:.5f} ms ({by6}); "
          f"cluster blocks {blocks}", flush=True)
    print(f"kernel ball_query_full edge forward (b=1, radii "
          f"{[c[3] for c in calls]}): "
          f"{', '.join(f'{t:.4f}' for t in k2f_ms)} ms, {sum(k2f_ms):.4f} ms "
          f"a forward; plain {k2f_plain:.2f} ms; first-K tests needed "
          f"{int(k2f_ops / 9)}; bound {b2f:.5f} ms ({by2f}); max "
          f"|kernel - plain| {err}", flush=True)


def _edge_phase(torch, np, extras, device: str = "cuda"):
    """EDGEPN2D and EDGEPN2DU served at full width through
    `GraspDetector(<yaml>)`: the port's curvature_model.yaml with MODEL.TYPE
    replaced (`_config_file`), so the net comes from the PN2Config
    defaults of its own section (the reference's four-stage pyramid
    25,600 -> 10,240 / 1,024 / 128 / global, radii 0.2 / 0.3 / 0.4, K 64,
    FP neighbours 0 / 3 / 3 / 3; unsorted; bf16) and NUM_INPUT from
    MODEL.PN2, with seeded random weights.  Each model: detect x3 on a
    tabletop (timed), once on a clutter scene, then detect_batch at b = 2
    on two tabletops, each warmed up and counted on its own, every kernel
    exactly (`_edge_launches`); then one EDGEPN2D detect under the
    profiler, and K6 and K2f at its shapes (`_edge_kernel_phase`).
    Returns each run's launches and stage medians."""
    from s4g_tpu_torch import _build
    from s4g_tpu_torch.models.pn2_modules import EdgeFPModule
    from s4g_tpu_torch.pipeline.detector import GraspDetector

    scenes = _scenes(np)
    kw = {"score_threshold": 0.0, "verticalness_threshold": -1e9}
    pair = [scenes["tabletop0"], scenes["tabletop2"]]
    paths, medians = {}, {}
    for model_type in EDGE_MODELS:
        name = model_type.lower()
        det = GraspDetector(model=_config_file(
            f"{name}_model", model={"TYPE": model_type}), seed=0,
            output_dir=_output_dir(name), device=device)
        net = det.net
        edge_fp = all(isinstance(fp, EdgeFPModule) for fp in net.fp_modules)
        if not (all(sa.edge for sa in net.sa_modules)
                and net.sa_modules[-1].num_centroids == 0
                and edge_fp == (model_type == "EDGEPN2DU")):
            raise AssertionError(f"{model_type}: not an edge backbone")
        print(f"{name}: SA centroids "
              f"{[sa.num_centroids for sa in net.sa_modules]}, MLP inputs "
              f"{[sa.mlp[0].conv.in_channels for sa in net.sa_modules]}; FP "
              f"inputs {[fp.mlp[0].conv.in_channels for fp in net.fp_modules]}"
              f", edge FP {edge_fp}; "
              f"{sum(p.numel() for p in net.parameters())} parameters",
              flush=True)
        det.detect(scenes["tabletop0"], **kw)
        det.detect_batch(pair, **kw)

        _build.reset_launches()
        runs, found = [], {}
        for scene in ["tabletop0"] * NUM_DETECT + ["clutter1"]:
            found[scene] = det.detect(scenes[scene], **kw) + (
                det.last_num_valid,)
            if scene == "tabletop0":
                runs.append(dict(det.timings))
        paths[f"{name}_detect"] = dict(_build.LAUNCHES)
        _expect(f"{name} detect", paths[f"{name}_detect"], NUM_DETECT + 1,
                _edge_launches(det, 1))
        medians[f"{name} detect"] = _stage_medians(
            f"{name} detect tabletop", runs)
        for scene, (poses, scores, num_valid) in found.items():
            ortho = _check_grasps(f"{name} {scene}", [(poses, scores)])
            print(f"{name} detect {scene}: num_valid {num_valid}, "
                  f"{len(poses)} grasps returned, max orthonormality error "
                  f"{ortho:.2e}", flush=True)

        _build.reset_launches()
        results = det.detect_batch(pair, **kw)
        _check_grasps(f"{name} detect_batch", results)
        paths[f"{name}_batch"] = dict(_build.LAUNCHES)
        _expect(f"{name} detect_batch b=2", paths[f"{name}_batch"], 1,
                _edge_launches(det, 2))
        medians[f"{name} detect_batch b=2"] = _stage_medians(
            f"{name} detect_batch b=2", [det.timings])
        if model_type == "EDGEPN2D":
            _profile_phase(det, torch, np, name=f"{name} detect")
            _edge_kernel_phase(det, torch, np, extras)
    return paths, medians


# PN2_LOCAL's candidate mode at full width: V frame points (chip_smoke's
# training scenes' frame count) with S candidate frames each, drawn here
# from a seed (the label factory's `_factory_phase` makes real frames).
LOCAL_CANDIDATES = 8


def _local_batch(points, rng, v: int, s: int, np) -> dict:
    """A PN2_LOCAL candidate-mode batch on `points` (B, 3, N), train-frame
    model inputs: for each of the first `v` points, `s` seeded candidate
    frames (random rotations, origins within 2 cm of the point) with score
    labels; 2-way movability labels per point; a best frame per frame
    point."""
    b, _, n = points.shape

    def rotations(count):
        q, r = np.linalg.qr(rng.randn(count, 3, 3))
        q = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
        q[np.linalg.det(q) < 0, :, 2] *= -1
        return q.reshape(count, 9)

    lsf = np.empty((b, 12, v, s), np.float32)
    lsf[:, :9] = rotations(b * v * s).reshape(b, v, s, 9).transpose(
        0, 3, 1, 2)
    lsf[:, 9:] = points[:, :, :v, None] + rng.uniform(-0.02, 0.02,
                                                      (b, 3, v, s))
    return {"scene_points": np.ascontiguousarray(points, np.float32),
            "local_search_frame": lsf,
            "scored_grasp_labels": rng.randint(0, 3, (b, v, s)),
            "scene_movable_labels": rng.randint(0, 2, (b, n)),
            "best_frame_R": rotations(b * v).reshape(b, v, 9).transpose(
                0, 2, 1).astype(np.float32),
            "best_frame_t": (points[:, :, :v] + rng.uniform(
                -0.02, 0.02, (b, 3, v))).astype(np.float32)}


def _local_reference_phase(torch, np, devices=("cpu", "cuda")):
    """One PN2_LOCAL candidate-mode train step at NARROW's width (the
    kernel routes of `_train_reference_phase`), f32, dropout 0, b = 2,
    V = 128 frame points with 4 candidates each, on the GPU and on the CPU
    from the same state_dict and batch, held as `_compare_steps` holds
    the PN2_CLS step."""
    from s4g_tpu_torch.configs.config import load_cfg_from_dict
    from s4g_tpu_torch.train.dataset import SceneGraspDataset

    cfg = load_cfg_from_dict({**NARROW_TRAIN, "MODEL": {
        **NARROW_TRAIN["MODEL"], "TYPE": "PN2_LOCAL"}})
    points = next(iter(SceneGraspDataset(
        _train_data(np), num_points=cfg.MODEL.PN2.NUM_INPUT, batch_size=2,
        num_frame_points=128, seed=0)))["scene_points"]
    batch = _local_batch(points, np.random.RandomState(12), 128, 4, np)
    state, cpu = _step_on(cfg, batch, None, devices[0], "local_ref")
    _, gpu = _step_on(cfg, batch, state, devices[1], "local_ref")
    res, bad = _compare_steps("PN2_LOCAL step", cpu, gpu)
    print(f"PN2_LOCAL reference: {res}", flush=True)
    if bad:
        raise AssertionError("; ".join(bad))
    return res


def _local_phase(torch, np, device: str = "cuda"):
    """PN2_LOCAL at full width: the port's curvature_model.yaml with
    MODEL.TYPE PN2_LOCAL (its PN2 section: sorted, 128-shard FPS, bf16,
    dropout 0.5), seeded random weights.

    * deployment mode through the API: `GraspDetector(<yaml>).eval` on a
      tabletop (b = 1: K1, K2 or K2f on overflow, K2f, K4), then the net
      on two prepared tabletops (b = 2: K3 or K2f on overflow), each
      warmed up and counted on its own (`_deployed_launches` without K5),
      then timed with CUDA events (median of 10);
    * candidate mode: `Trainer.train_step` on b = 2 prepared tabletops
      with `_local_batch` candidates (V = TRAIN_FRAME_POINTS, S =
      LOCAL_CANDIDATES), a warm-up and 4 counted steps (`_instrument`:
      every step's launches exact), the median step split into forward +
      loss, backward and optimizer, the peak device memory; the scalars
      finite and every parameter moved.
    Returns each run's launches and those numbers."""
    from types import SimpleNamespace
    from s4g_tpu_torch import _build
    from s4g_tpu_torch.pipeline.detector import GraspDetector, prep_batch
    from s4g_tpu_torch.train.trainer import Trainer

    ldet = GraspDetector(model=_config_file(
        "local_model", model={"TYPE": "PN2_LOCAL"}), seed=0,
        output_dir=_output_dir("local"), device=device)
    scenes = _scenes(np)
    n = ldet.num_input
    ldet.eval(scenes["tabletop0"])
    _build.reset_launches()
    preds, want = _counted(ldet, lambda: ldet.eval(scenes["tabletop0"]), 1)
    paths = {"local_forward_b1": dict(_build.LAUNCHES)}
    _expect("PN2_LOCAL eval b=1", paths["local_forward_b1"], 1,
            {**want, "collision_counts": 0})
    shapes = {"local_search_logits": (1, 3, n, 1), "frame_R": (1, 9, n),
              "frame_t": (1, 3, n), "movable_logits": (1, 2, n)}
    for key, shape in shapes.items():
        if tuple(preds[key].shape) != shape or not bool(
                torch.isfinite(preds[key]).all()):
            raise AssertionError(f"PN2_LOCAL {key}: shape "
                                 f"{tuple(preds[key].shape)} or non-finite")

    padded, valids = zip(*(ldet._pad_cloud(scenes[x])
                           for x in ("tabletop0", "tabletop2")))
    with torch.no_grad():
        points = prep_batch(torch.stack(padded), torch.stack(valids), n,
                            generator=ldet.generator)
    inputs = {b: {"scene_points": points[:b].transpose(1, 2).contiguous()}
              for b in (1, 2)}
    ldet.net(inputs[2])
    _build.reset_launches()
    _, want = _counted(ldet, lambda: ldet.net(inputs[2]), 2)
    paths["local_forward_b2"] = dict(_build.LAUNCHES)
    _expect("PN2_LOCAL forward b=2", paths["local_forward_b2"], 1,
            {**want, "collision_counts": 0})
    numbers = {f"forward_b{b}_ms": _event_ms(lambda: ldet.net(inputs[b]),
                                             reps=10)
               for b in (1, 2)}

    cfg = ldet.cfg
    batch = _local_batch(points.transpose(1, 2).cpu().numpy(),
                         np.random.RandomState(13), TRAIN_FRAME_POINTS,
                         LOCAL_CANDIDATES, np)
    tr = Trainer(cfg, output_dir=_output_dir("local_train"),
                 device=device, logger=_train_logger())
    tr.init_state()
    before = {k: v.detach().clone() for k, v in tr.net.named_parameters()}
    launches, records = {"train": {}, "val": {}}, {"train": [], "val": []}
    _instrument(tr, launches, SimpleNamespace(cfg=cfg, num_input=n),
                records, torch)
    torch.cuda.reset_peak_memory_stats()
    for _ in range(5):
        tr.train_step(batch)
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    paths["local_train_step"] = launches["train"]
    for rec in records["train"]:
        bad = [k for k, v in rec["scalars"].items()
               if not bool(torch.isfinite(v))]
        if bad:
            raise AssertionError(f"PN2_LOCAL non-finite scalars {bad}")
    still = [k for k, v in tr.net.named_parameters()
             if torch.equal(v, before[k])]
    if still:
        raise AssertionError(f"PN2_LOCAL parameters unchanged: {still}")
    timed = [{name: st.elapsed_time(e) for name, st, e in rec["events"]}
             for rec in records["train"][1:]]
    med = {k: statistics.median(t[k] for t in timed) for k in timed[0]}
    numbers.update(step_ms=med["step"], forward_loss_ms=med["forward"],
                   backward_ms=med["backward"],
                   optimizer_ms=med["optimizer"], peak_gib=peak_gib,
                   train_sa1_overflows=sum(r["overflow"]
                                           for r in records["train"]))
    print(f"PN2_LOCAL ({_nvidia_smi()}): forward b=1 "
          f"{numbers['forward_b1_ms']:.2f} ms, b=2 "
          f"{numbers['forward_b2_ms']:.2f} ms (median of 10); candidate-mode"
          f" train step b=2, V={TRAIN_FRAME_POINTS}, S={LOCAL_CANDIDATES} "
          f"(median of {len(timed)} after the first): {med['step']:.2f} ms"
          f" = forward + loss {med['forward']:.2f}, backward "
          f"{med['backward']:.2f}, optimizer {med['optimizer']:.2f}; peak "
          f"memory {peak_gib:.2f} GiB; SA1 overflows "
          f"{numbers['train_sa1_overflows']}; last scalars " + ", ".join(
              f"{k} {float(v):.4f}"
              for k, v in records["train"][-1]["scalars"].items()),
          flush=True)
    return paths, numbers


# GPD / PointNetGPD: one scene's DATA.TRAIN.NUM_GRASP candidates; the CPU
# comparison of PointNetGPD takes fewer (its CPU step is the slow side).
BASELINE_CANDIDATES = 300
BASELINE_CPU_CANDIDATES = {"GPD": 300, "PointNetGPD": 64}


def _baseline_batch(model_type: str, g: int, rng, cfg, np) -> dict:
    """One scene's `g` candidates for a baseline, seeded and synthetic (the
    JAX package's map and close-region generators are not ported): GPD's
    12 x 60 x 60 maps uniform in [0, 1), PointNetGPD's
    DATA.NUM_CLOSE_REGION_POINTS points uniform in the shifted gripper box,
    and a score class per candidate."""
    from s4g_tpu_torch.configs import gripper_config as G
    if model_type == "GPD":
        x = {"close_region_projection_maps": rng.rand(
            1, g, cfg.DATA.GPD_IN_CHANNELS, 60, 60).astype(np.float32)}
    else:
        box = np.array([[G.FINGER_LENGTH], [2 * G.HALF_BOTTOM_SPACE],
                        [2 * G.HALF_HAND_THICKNESS]])
        x = {"close_region_points": (rng.rand(
            1, g, 3, cfg.DATA.NUM_CLOSE_REGION_POINTS) * box
        ).astype(np.float32)}
    x["grasp_score_labels"] = rng.randint(0, cfg.DATA.SCORE_CLASSES, (g,))
    return x


def _baseline_cfg(model_type: str, dtype: str):
    from s4g_tpu_torch.configs.config import load_cfg_from_dict
    return load_cfg_from_dict({
        "MODEL": {"TYPE": model_type, "COMPUTE_DTYPE": dtype},
        "DATA": {"SCORE_CLASSES": 3, "GPD_IN_CHANNELS": 12},
        "TRAIN": {"BATCH_SIZE": 1}})


def _global_spread(got: dict, want: dict) -> tuple:
    """All gradients as one vector: |got - want| / |want| and the cosine."""
    import torch
    g = torch.cat([got[k].double().ravel() for k in want])
    w = torch.cat([v.double().ravel() for v in want.values()])
    return (float((g - w).norm() / w.norm()),
            float(g @ w / (g.norm() * w.norm())))


def _baseline_compare(model_type, steps, logits, devices):
    """A baseline's forward and train step on the two devices, in f32 and
    in float64 (`steps[(device, bits)]`).  The float64 runs must agree
    (the devices compute the same function): the loss within 1e-6
    relative (the logits reach it rounded to f32), each gradient within
    1e-6 of its tensor's largest (a gradient below 1e-9 of the model's
    largest, zero but for rounding, within 1e-9 of that), each BatchNorm
    running statistic within 1e-9 of its largest.  The f32 runs, each
    device's, are held to the CPU's float64 one: the eval logits within
    1e-4 of their largest (GPU vs CPU); the GPU's f32 loss within 1e-2
    relative and all its gradients together within 5e-2 (relative L2), or
    within twice the CPU's f32 step's distance where that is larger; their
    worst tensor is printed.
    PointNetGPD's f32 step is ill-conditioned: flax's BatchNorm variance
    E[x^2] - E[x]^2, which both packages compute, cancels where a channel's
    mean dwarfs its spread (bias-dominated features of close-region points
    a few centimetres wide), and its BatchNorms after the max pool see a
    few dozen vectors (tests/test_torch_port_baselines.py: JAX's own f32
    step is up to 17 % of a tensor's largest from its float64 one).
    Returns (the numbers, the failures)."""
    bad, res = [], {}
    cpu_dev, gpu_dev = devices
    scale = float(logits[cpu_dev].abs().max())
    res["logit_err"] = float((logits[gpu_dev] - logits[cpu_dev]).abs()
                             .max()) / scale
    if res["logit_err"] > 1e-4:
        bad.append(f"{model_type} logits: {res['logit_err']:.3g}")
    oracle = steps[(cpu_dev, 64)]
    top = max(float(g.abs().max()) for g in oracle["grads"].values())
    for key, got in (("f64_gpu_vs_f64_cpu", steps[(gpu_dev, 64)]),
                     ("cpu_vs_f64", steps[(cpu_dev, 32)]),
                     ("gpu_vs_f64", steps[(gpu_dev, 32)])):
        loss_rel = abs(got["scalars"]["cls_loss"]
                       - oracle["scalars"]["cls_loss"]) / abs(
                           oracle["scalars"]["cls_loss"])
        err, where, cos = _grad_spread(got["grads"], oracle["grads"])
        l2, gcos = _global_spread(got["grads"], oracle["grads"])
        stat = max([float((got["stats"][k].double() - w.double()).abs()
                          .max()) / float(w.abs().max())
                    for k, w in oracle["stats"].items()], default=0.0)
        res[key] = {"loss_rel": loss_rel, "grad_l2_rel": l2,
                    "grad_cos": gcos, "worst_tensor_err": err, "at": where,
                    "max_stat_err": stat}
        if key.startswith("f64"):
            off = [k for k, w in oracle["grads"].items()
                   if float((got["grads"][k] - w).abs().max()) > max(
                       1e-6 * float(w.abs().max()), 1e-9 * top)]
            ok = loss_rel <= 1e-6 and not off and stat <= 1e-9
        elif key == "gpu_vs_f64":
            cpu = res["cpu_vs_f64"]
            ok = (loss_rel <= max(1e-2, 2 * cpu["loss_rel"])
                  and l2 <= max(5e-2, 2 * cpu["grad_l2_rel"]))
        else:
            continue
        if not ok:
            bad.append(f"{model_type} {key}: {res[key]}")
    return res, bad


def _baseline_phase(torch, np, devices=("cpu", "cuda")):
    """GPD and PointNetGPD on the card: one scene's BASELINE_CANDIDATES
    candidates (`_baseline_batch`) at the default compute dtype (bf16) and
    at f32, each a `build_model` net's eval forward (median of 10, CUDA
    events) and `Trainer.train_step` (Adam; a warm-up, then the median of
    5), with the peak device memory; no kernel of the port may launch.
    Then the same weights and batch on the CPU and the GPU, in f32 and in
    float64 (`_baseline_compare`).  Returns each run's (zero) launches and the
    numbers."""
    from s4g_tpu_torch import _build
    from s4g_tpu_torch.models import build_model
    from s4g_tpu_torch.train.dataset import batch_to_device
    from s4g_tpu_torch.train.trainer import Trainer

    paths, numbers = {}, {}
    for model_type in ("GPD", "PointNetGPD"):
        for dtype in ("bfloat16", "float32"):
            cfg = _baseline_cfg(model_type, dtype)
            batch = batch_to_device(_baseline_batch(
                model_type, BASELINE_CANDIDATES, np.random.RandomState(14),
                cfg, np), devices[1])
            tr = Trainer(cfg, output_dir=_output_dir(
                f"{model_type}_{dtype}"), device=devices[1],
                logger=_train_logger())
            tr.init_state()
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launches()
            tr.net.eval()
            with torch.no_grad():
                logits = tr.net(batch)["grasp_logits"]
            if tuple(logits.shape) != (BASELINE_CANDIDATES, 3) or not bool(
                    torch.isfinite(logits).all()):
                raise AssertionError(f"{model_type} logits "
                                     f"{tuple(logits.shape)} or non-finite")
            fwd = _event_ms(lambda: tr.net(batch), reps=10)
            step = _event_ms(lambda: tr.train_step(batch), reps=5, warmup=1)
            label = f"{model_type.lower()}_{dtype}"
            paths[label] = dict(_build.LAUNCHES)
            if any(paths[label].values()):
                raise AssertionError(f"{label}: launches {paths[label]}")
            numbers[label] = {"forward_ms": fwd, "train_step_ms": step,
                              "peak_gib": torch.cuda.max_memory_allocated()
                              / 2 ** 30}
            print(f"{label} ({_nvidia_smi()}): {BASELINE_CANDIDATES} "
                  f"candidates, forward {fwd:.3f} ms, train step "
                  f"{step:.3f} ms, peak memory "
                  f"{numbers[label]['peak_gib']:.3f} GiB", flush=True)

        cfg = _baseline_cfg(model_type, "float32")
        batch = _baseline_batch(model_type,
                                BASELINE_CPU_CANDIDATES[model_type],
                                np.random.RandomState(15), cfg, np)
        state, steps = None, {}
        for dev in devices:
            for bits in (32, 64):
                state, steps[(dev, bits)] = _step_on(
                    cfg, batch, state, dev, model_type, bits == 64)
        logits = {}
        for dev in devices:
            net = build_model(cfg)
            net.load_state_dict(state)
            with torch.no_grad():
                logits[dev] = net.to(dev)(batch_to_device(batch, dev))[
                    "grasp_logits"].cpu()
        res, bad = _baseline_compare(model_type, steps, logits, devices)
        numbers[f"{model_type.lower()}_reference"] = res
        print(f"{model_type} reference ({BASELINE_CPU_CANDIDATES[model_type]}"
              f" candidates, f32): {res}", flush=True)
        if bad:
            raise AssertionError("; ".join(bad))
    return paths, numbers


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
    _print_profile(label, prof, det.timings["total_ms"], top)


def _print_profile(label, prof, wall_ms, top: int = 12):
    """Device time by kernel name (the `top` largest) of a torch.profiler
    run (`utils.profiling.device_kernel_times`), the device's busy time
    against the run's wall time, and so its idle share (the profiler's own
    overhead is in the wall time, so the idle share is an upper bound).
    Returns (busy ms, [(ms, count, name)]) or None when the profiler
    recorded no device time."""
    from s4g_tpu_torch.utils.profiling import device_kernel_times

    rows = device_kernel_times(prof)
    busy_ms = sum(ms for ms, _, _ in rows)
    if not rows:
        print(f"profile {label}: the profiler recorded no device time "
              "(device busy and idle share not measured)", flush=True)
        return None
    print(f"profile {label}: wall {wall_ms:.2f} ms under the profiler, "
          f"device busy {busy_ms:.2f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.3f}", flush=True)
    for ms, count, name in rows[:top]:
        print(f"profile:   {ms:9.3f} ms  x{count:<5d} {name[:90]}",
              flush=True)
    return busy_ms, rows[:top]


def _train_profile(trainer, batch, torch, top: int = 12):
    """One train step under torch.profiler (`_print_profile`), its wall time
    from a synchronized host clock."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    got = _print_profile("train step", prof, wall_ms, top)
    return None if got is None else {"wall_ms": wall_ms, "busy_ms": got[0],
                                     "top": got[1]}


# -- eval and the entry points ----------------------------------------------------

EVAL_POSES = 2000
EVAL_BOXES = 8
EVAL_TABLE_POINTS = 60000
EVAL_BOX_POINTS = 5000


def eval_scene(rng):
    """A seeded labeled scene at the label factory's size (`datagen/
    eval_data.py`'s 2,000 poses against a labeled cloud of ~10^5 points):
    a 0.8 x 0.6 m table (label 0) with EVAL_BOXES boxes on it (labels 1 to
    8, 4-6 cm wide, 5-12 cm tall; their tops and four sides), every point
    with its outward normal.  Returns cloud (N, 3), normals (N, 3) float32
    and int32 labels, and the boxes' top centres."""
    import numpy as np
    xy = rng.uniform([-0.4, -0.3], [0.4, 0.3], (EVAL_TABLE_POINTS, 2))
    pts = [np.column_stack([xy, np.zeros(len(xy))])]
    nrm = [np.tile([0.0, 0.0, 1.0], (len(xy), 1))]
    labels = [np.zeros(len(xy), np.int32)]
    tops = []
    for i in range(EVAL_BOXES):
        c = np.array([-0.3 + 0.085 * i, 0.12 * ((-1) ** i), 0.0])
        half = np.array([rng.uniform(0.02, 0.03), rng.uniform(0.02, 0.03),
                         rng.uniform(0.025, 0.06)])
        c[2] = half[2]
        faces = [(2, 1.0), (0, 1.0), (0, -1.0), (1, 1.0), (1, -1.0)]
        per = EVAL_BOX_POINTS // len(faces)
        for axis, sign in faces:
            p = rng.uniform(-half, half, (per, 3))
            p[:, axis] = sign * half[axis]
            n = np.zeros((per, 3))
            n[:, axis] = sign
            pts.append(c + p)
            nrm.append(n)
            labels.append(np.full(per, i + 1, np.int32))
        tops.append(c + [0.0, 0.0, half[2]])
    return (np.concatenate(pts).astype(np.float32),
            np.concatenate(nrm).astype(np.float32), np.concatenate(labels),
            np.array(tops))


def eval_poses(rng, cloud, tops, count: int = EVAL_POSES):
    """(count, 4, 4) float32 world->gripper matrices with frames at scene
    points: half top-down grasps over the boxes' tops (random yaw, centre
    within 1 cm, 0-4 cm above), half random rotations at random scene
    points, backed off 0-4 cm along their approach axis."""
    import numpy as np
    half = count // 2
    poses = np.tile(np.eye(4), (count, 1, 1))
    yaw = rng.uniform(0, np.pi, half)
    poses[:half, :3, 0] = [0.0, 0.0, -1.0]
    poses[:half, :3, 1] = np.column_stack([np.cos(yaw), np.sin(yaw),
                                           np.zeros(half)])
    poses[:half, :3, 2] = np.cross(poses[:half, :3, 0], poses[:half, :3, 1])
    poses[:half, :3, 3] = (tops[rng.randint(0, len(tops), half)]
                           + rng.uniform([-0.01, -0.01, 0.0],
                                         [0.01, 0.01, 0.04], (half, 3)))
    q, r = np.linalg.qr(rng.randn(count - half, 3, 3))
    q = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    q[np.linalg.det(q) < 0, :, 2] *= -1
    poses[half:, :3, :3] = q
    poses[half:, :3, 3] = (cloud[rng.choice(len(cloud), count - half)]
                           - rng.uniform(0.0, 0.04, (count - half, 1))
                           * q[:, :, 0])
    return np.linalg.inv(poses).astype(np.float32)


def _near_faces(g2l, cloud, torch, ulps: int = 4, chunk: int = 100) -> int:
    """Pose-point pairs whose gripper-frame coordinate, in float64, lies
    within `ulps` f32 ulps (at 0.2 m) of a box face that the masks test:
    where the two devices' f32 transforms could part."""
    from s4g_tpu_torch.configs import gripper_config as G
    from s4g_tpu_torch.configs import processing_config as P
    faces = {0: (G.FINGER_LENGTH, -G.BOTTOM_LENGTH, -P.BACK_COLLISION_MARGIN),
             1: (G.HALF_BOTTOM_WIDTH, -G.HALF_BOTTOM_WIDTH,
                 G.HALF_BOTTOM_SPACE, -G.HALF_BOTTOM_SPACE),
             2: (G.HALF_HAND_THICKNESS, -G.HALF_HAND_THICKNESS)}
    tol = ulps * 2.0 ** -23 * 0.2
    mats, pts = g2l.double(), cloud.double().t()
    count = 0
    for g0 in range(0, mats.shape[0], chunk):
        m = mats[g0:g0 + chunk]
        local = torch.matmul(m[:, :3, :3], pts) + m[:, :3, 3:]
        near = torch.zeros_like(local[:, 0], dtype=torch.bool)
        for axis, values in faces.items():
            for v in values:
                near |= (local[:, axis] - v).abs() <= tol
        count += int(near.sum())
    return count


def _eval_reference_phase(torch, np, devices=("cpu", "cuda")):
    """`eval_frames` (`pipeline/eval_cloud.py`) at the label factory's
    size: EVAL_POSES poses against `eval_scene`'s ~10^5 labeled points, on
    both devices from the same inputs.  collision and multi_objects must be
    equal, the antipodal score within 1e-5; prints the pairs within 4 ulp
    of a box face.  On the card: the time (CUDA events, median of 5), the
    chunk and the peak memory; no kernel of the port may launch.  Returns
    the launches and the numbers."""
    from s4g_tpu_torch import _build
    from s4g_tpu_torch.pipeline import eval_cloud

    rng = np.random.RandomState(31)
    cloud, normals, labels, tops = eval_scene(rng)
    g2l = eval_poses(rng, cloud, tops)
    host = [torch.from_numpy(x) for x in (g2l, cloud, normals, labels)]
    want = eval_cloud.eval_frames(*(x.to(devices[0]) for x in host))
    args = [x.to(devices[1]) for x in host]
    _build.reset_launches()
    got = eval_cloud.eval_frames(*args)
    launches = dict(_build.LAUNCHES)
    if any(launches.values()):
        raise AssertionError(f"eval_frames launched kernels: {launches}")
    near = _near_faces(args[0], args[1], torch)
    for name, g, w in zip(("collision", "multi_objects"), got[:2], want[:2]):
        if not torch.equal(g.cpu(), w.cpu()):
            raise AssertionError(
                f"eval_frames {name}: {int((g.cpu() != w.cpu()).sum())} "
                f"poses differ ({near} pose-point pairs within 4 ulp of a "
                "box face)")
    err = float((got[2].cpu() - want[2].cpu()).abs().max())
    if err > 1e-5:
        raise AssertionError(f"eval_frames antipodal_score: {err:.3g}")
    n = cloud.shape[0]
    chunk = max(1, eval_cloud.CHUNK_PAIRS // n)
    numbers = {"poses": len(g2l), "points": n, "chunk": chunk,
               "near_face_pairs": near, "max_abs_err": err,
               "collision": int(got[0].sum()),
               "multi_objects": int(got[1].sum()),
               "scored": int((got[2] > 0).sum())}
    if devices[1] == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        numbers["ms"] = _event_ms(lambda: eval_cloud.eval_frames(*args),
                                  reps=5, warmup=1)
        numbers["peak_gib"] = (torch.cuda.max_memory_allocated()
                               - base) / 2 ** 30
        print(f"eval_frames ({_nvidia_smi()}): {len(g2l)} poses x {n} "
              f"points in chunks of {chunk} poses: {numbers['ms']:.3f} ms "
              f"(CUDA events, median of 5), peak memory above the inputs "
              f"{numbers['peak_gib']:.3f} GiB", flush=True)
    print(f"eval reference: GPU vs CPU collision and multi_objects equal, "
          f"antipodal_score max|diff| {err:.3g}; {near} pose-point pairs "
          f"within 4 ulp of a box face; collide {numbers['collision']}, "
          f"multi_objects {numbers['multi_objects']}, scored "
          f"{numbers['scored']} of {len(g2l)}", flush=True)
    return launches, numbers


# -- the label factory ----------------------------------------------------------

# The reduced GPU-vs-CPU factory (`_factory_reference_phase`).
FACTORY_REDUCED = {"capacity": 4096, "wh": (320, 240), "max_pairs": 512}
# Darboux frames are compared where the relative eigenvalue gap of the
# projected normal covariance exceeds this (the CPU tests' GAP_MIN).
FACTORY_GAP_MIN = 1e-2
# The full-size factory (`_factory_phase`): `generate_end_to_end`'s
# defaults and the eval / baseline / contact flavours' sizes.
FACTORY_VIEWS = 4
FACTORY_WH = (640, 480)
FACTORY_CAPACITY = 16384
FACTORY_EVAL_POINTS = 2000
FACTORY_BASELINE_GRASPS = 300
FACTORY_CONTACT_PAIRS = 4096
FACTORY_CONTACT_OBJECTS = ("ellipsoid", "cylinder")


def _factory_meshes(names=None):
    """The eight `mesh_tools` primitives at their default sizes."""
    from s4g_tpu_torch.datagen import mesh_tools as mt
    meshes = {"box": mt.make_box(), "cylinder": mt.make_cylinder(),
              "ellipsoid": mt.make_ellipsoid(), "torus": mt.make_torus(),
              "cone": mt.make_cone(), "capsule": mt.make_capsule(),
              "cup": mt.make_cup(), "lshape": mt.make_lshape()}
    return {n: meshes[n] for n in (names or meshes)}


def _resting_poses(meshes, rng, np):
    """{name: [x, y, z, qw, qx, qy, qz]}: each mesh resting on the table
    (its lowest vertex at TABLE_HEIGHT), x in +-0.15 m, y in +-0.12 m, a
    random yaw (no drop simulation)."""
    from s4g_tpu_torch.datagen.label_transfer import TABLE_HEIGHT
    poses = {}
    for name, (verts, _) in meshes.items():
        yaw = rng.uniform(0.0, 2 * np.pi)
        poses[name] = np.array([rng.uniform(-0.15, 0.15),
                                rng.uniform(-0.12, 0.12),
                                TABLE_HEIGHT - verts[:, 2].min(),
                                np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)])
    return poses


def _same(label, got, want, float_keys=(), tol=1e-6):
    """The arrays of `got` equal those of `want` under the same keys:
    exactly, or within `tol` for `float_keys`.  Returns the largest float
    difference."""
    import numpy as np
    err = 0.0
    for key in got:
        g, w = np.asarray(got[key]), np.asarray(want[key])
        if g.shape != w.shape:
            raise AssertionError(f"{label} {key}: shape {g.shape} on the "
                                 f"GPU, {w.shape} on the CPU")
        if key in float_keys:
            e = float(np.abs(g - w).max()) if g.size else 0.0
            err = max(err, e)
            if not e <= tol:
                raise AssertionError(f"{label} {key}: max|GPU - CPU| {e:.3g}"
                                     f" > {tol}")
        elif not np.array_equal(g, w):
            raise AssertionError(f"{label} {key}: {int((g != w).sum())} of "
                                 f"{g.size} entries differ")
    return err


def _frames_apart(label, points, normals, got_frames, want_frames, torch,
                  np):
    """Frames of two devices within 1e-5 up to the 180-degree turn about x
    on points whose eigenvalue gap (`grading.darboux_gaps`, on the CPU
    inputs) exceeds FACTORY_GAP_MIN.  Returns (points below the gap,
    frames that differ)."""
    from s4g_tpu_torch.datagen import grading
    gap = grading.darboux_gaps(torch.from_numpy(points),
                               torch.from_numpy(normals)).numpy()
    turn = np.array([1.0, -1.0, -1.0], np.float32)
    d = np.minimum(np.abs(got_frames - want_frames).max(axis=(1, 2)),
                   np.abs(got_frames * turn - want_frames).max(axis=(1, 2)))
    keep = gap > FACTORY_GAP_MIN
    if (d[keep] > 1e-5).any():
        raise AssertionError(f"{label}: {int((d[keep] > 1e-5).sum())} frames "
                             "above the gap threshold differ by more than "
                             "1e-5")
    return int((~keep).sum()), int((d > 1e-5).sum())


def _labels_apart(got, want, np) -> int:
    """Labels that differ between two view records: grasp points in one
    and not the other, plus (point, L, T) labels that differ at shared
    points."""
    g_idx, w_idx = list(got["valid_index"]), list(want["valid_index"])
    shared = sorted(set(g_idx) & set(w_idx))
    apart = len(set(g_idx) ^ set(w_idx))
    if shared:
        gi = [g_idx.index(i) for i in shared]
        wi = [w_idx.index(i) for i in shared]
        apart += int((got["objects_label"][gi]
                      != want["objects_label"][wi]).sum())
    return apart


def _workspace_view(noisy, np):
    """The view cloud the eval and baseline flavours take: a rendered
    view's noisy cloud as the camera gives it, cropped to the workspace."""
    from s4g_tpu_torch.datagen.label_transfer import DATAGEN_WORKSPACE
    lo = np.array(DATAGEN_WORKSPACE[0::2])
    hi = np.array(DATAGEN_WORKSPACE[1::2])
    return noisy[((noisy > lo) & (noisy < hi)).all(axis=1)]


def _factory_reference_phase(torch, np, devices=("cpu", "cuda")):
    """The label factory at a reduced size on both devices: an ellipsoid
    and a box graded by `grade_object`, composed on the table from a seeded
    pose dict, one 320 x 240 view, then `generate_view_labels` and the
    online variant at capacity 4,096, the contact flavour (512 pairs on the
    ellipsoid) and its refinement, `generate_eval_view(with_baseline=True)`
    and `generate_baseline_view` on the view's cloud (`_workspace_view`).

    Each stage runs twice on the GPU: on the CPU's inputs (outputs of the
    CPU's stage before), where integers, masks and frames must equal the
    CPU's and floats agree within 1e-6; and end to end on its own inputs,
    where normals and frames must agree within 1e-5 up to the gripper's
    turn on points above the gap threshold, and the labels that differ are
    counted.  Returns the numbers."""
    from s4g_tpu_torch import _build
    from s4g_tpu_torch.datagen import (baseline_generator, contact,
                                       eval_data, generate, grading,
                                       label_transfer as lt, refine_contact,
                                       render, scene_compose)
    from s4g_tpu_torch.utils.math_utils import batch_transformation_inv
    cpu, gpu = devices
    size = FACTORY_REDUCED
    meshes = _factory_meshes(("ellipsoid", "box"))
    poses = _resting_poses(meshes, np.random.RandomState(40), np)
    index = {n: i for i, n in enumerate(meshes)}
    out = {}
    antip = ("antipodal_score", "inv_antipodal_score")

    def t(x, dev):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    # grade_object: each device end to end, then each sub-stage on the GPU
    # fed the CPU's inputs.
    objects = {d: {n: generate.grade_object(*m, rng=np.random.RandomState(
        41 + i), device=d) for i, (n, m) in enumerate(meshes.items())}
        for d in devices}
    for n in meshes:
        want, got = objects[cpu][n], objects[gpu][n]
        np.testing.assert_array_equal(got["cloud"], want["cloud"])
        cloud = t(want["cloud"], gpu)
        normals = -grading.estimate_normals(cloud,
                                            t(want["cloud"].mean(0), gpu))
        _same(f"estimate_normals {n}", {"normal": normals.cpu().numpy()},
              want)
        frames, inv = grading.darboux_frames(cloud, t(want["normal"], gpu))
        _same(f"darboux_frames {n}", {"frame": frames.cpu().numpy(),
                                      "inv_frame": inv.cpu().numpy()}, want)
        homo = torch.cat([cloud.t(), torch.ones_like(cloud[:, :1]).t()])
        for kind in ("", "inv_"):
            s, a = grading.grade_frames(cloud, t(want["normal"].T, gpu),
                                        t(want[kind + "frame"], gpu), homo)
            out[f"grade_frames {n} {kind}max_abs_err"] = _same(
                f"grade_frames {n} {kind}",
                {kind + "search_score": s.cpu().numpy(),
                 kind + "antipodal_score": a.cpu().numpy()}, want, antip)
        below, apart = _frames_apart(f"grade_object {n}", want["cloud"],
                                     want["normal"], got["frame"],
                                     want["frame"], torch, np)
        _same(f"grade_object {n} end to end", got, want, antip, tol=1e-6)
        out[f"{n}: points, below the gap, frames apart"] = (
            len(want["cloud"]), below, apart)

    scenes = {d: scene_compose.compose_scene(poses, objects[d],
                                             name_to_index=index)
              for d in devices}
    (clean, noisy, cam), = render.render_scene_views(
        meshes, poses, table_mesh=render.table_mesh(),
        rng=np.random.RandomState(42), camera_poses=render.CAMERA_POSE[:1],
        width=size["wh"][0], height=size["wh"][1])
    cam_loc = cam[:3, 3].astype(np.float32)
    float_keys = ("antipodal_score", "valid_frame")

    def stage(label, fn, keys=float_keys, inputs_gpu=None):
        """fn(device, inputs) on the CPU, on the GPU with the CPU's inputs
        and on the GPU with its own; the same-input pair must agree."""
        want = fn(cpu, None)
        same = fn(gpu, None)
        err = _same(f"{label} (same inputs)", same, want, keys)
        e2e = fn(gpu, inputs_gpu) if inputs_gpu is not None else same
        out[f"{label} max_abs_err"] = err
        return want, same, e2e

    labels = stage("generate_view_labels", lambda d, sc: lt.generate_view_labels(
        noisy, clean, cam, scenes[cpu] if sc is None else sc,
        capacity=size["capacity"], device=d), inputs_gpu=scenes[gpu])
    online = stage("generate_view_labels_online",
                   lambda d, sc: lt.generate_view_labels_online(
                       noisy, cam, scenes[cpu] if sc is None else sc,
                       capacity=size["capacity"], device=d),
                   inputs_gpu=scenes[gpu])
    for name, (want, _, e2e) in (("labels", labels), ("online", online)):
        out[f"{name}: valid points, labels apart end to end"] = (
            len(want["valid_index"]), _labels_apart(e2e, want, np))
    if not len(labels[0]["valid_index"]):
        raise AssertionError("factory reference: the view yields no label")

    ell = {d: objects[d]["ellipsoid"] for d in devices}

    def contact_on(d, data):
        data = ell[cpu] if data is None else data
        return contact.generate_contact_object_data(
            data["cloud"], data["normal"], max_pairs=size["max_pairs"],
            rng=np.random.RandomState(43), device=d)
    pairs = stage("contact", contact_on, keys=(), inputs_gpu=ell[gpu])
    refined = stage("refine_contact_object",
                    lambda d, data: refine_contact.refine_contact_object(
                        pairs[0] if data is None else data, device=d),
                    keys=(), inputs_gpu=pairs[2])
    out["contact: frames, refined"] = (len(pairs[0]["search_score"]),
                                       len(refined[0]["search_score"]))

    view = _workspace_view(noisy, np)
    launched = []

    def eval_on(d, v):
        _build.reset_launches()
        rec = eval_data.generate_eval_view(
            view if v is None else v, cam_loc, scenes[cpu],
            FACTORY_EVAL_POINTS, rng=np.random.RandomState(44),
            with_baseline=True, device=d)
        launched.append(dict(_build.LAUNCHES))
        return rec
    keys = ("antipodal_score", "close_region_points",
            "close_region_projection_maps")
    ev = stage("generate_eval_view", eval_on, keys=keys)
    from s4g_tpu_torch.ops.neighbors import KERNEL_MIN_PAIRS
    k5 = int(len(ev[0]["frames"]) * len(view) >= KERNEL_MIN_PAIRS)
    if launched[1]["collision_counts"] != k5:
        raise AssertionError(f"generate_eval_view launched {launched[1]} "
                             f"on the GPU: K5 {k5} expected")
    framed = np.abs(ev[0]["frames"][:, :3, :3]).sum(axis=(1, 2)) > 0
    g2l = batch_transformation_inv(t(ev[0]["frames"][framed], gpu))
    near = _near_faces(g2l, t(view, gpu), torch)
    flipped = sum(int((ev[1][k] != ev[0][k]).sum()) for k in (
        "non_collision_bool", "scene_collision_bool", "single_label_bool"))
    out["eval: poses x view points, pairs within 4 ulp of a face, "
        "mask entries GPU != CPU"] = (len(ev[0]["frames"]), len(view), near,
                                      flipped)
    base = stage("generate_baseline_view", lambda d, _: (
        baseline_generator.generate_baseline_view(
            view, cam_loc, scenes[cpu], grasp_num=FACTORY_BASELINE_GRASPS,
            rng=np.random.RandomState(45), device=d)), keys=keys)
    out["baseline grasps"] = len(base[0]["grasp_score_labels"])

    # the view cloud's own normals and frames, each device on its own
    n_cpu = grading.estimate_normals(t(view, cpu), t(cam_loc, cpu))
    n_gpu = grading.estimate_normals(t(view, gpu), t(cam_loc, gpu)).cpu()
    f_cpu = grading.darboux_frames(t(view, cpu), n_cpu)[0].numpy()
    f_gpu = grading.darboux_frames(t(view, gpu), n_gpu.to(gpu))[0].cpu()
    below, apart = _frames_apart("view frames", view, n_cpu.numpy(),
                                 f_gpu.numpy(), f_cpu, torch, np)
    out["view normals max|GPU - CPU|"] = float((n_gpu - n_cpu).abs().max())
    out["view: points, below the gap, frames apart"] = (len(view), below,
                                                        apart)
    print(f"factory reference: GPU vs CPU on the same inputs equal at every "
          f"stage; {out}", flush=True)
    return out


def _synced(torch):
    """A timer for factory stages: host clock around work that ends in a
    device synchronization, and the peak device memory above what was
    allocated before it."""
    @contextlib.contextmanager
    def timer(record: dict):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        record["ms"] = record.get("ms", 0.0) + 1e3 * (time.perf_counter()
                                                      - t0)
        record["peak_gib"] = max(record.get("peak_gib", 0.0), (
            torch.cuda.max_memory_allocated() - base) / 2 ** 30)
    return timer


@contextlib.contextmanager
def _label_stage_probes(timer, views: list):
    """Wrap label_transfer's device stages to time them and record the
    sizes of each `generate_view_labels` call into views[-1]: voxels kept,
    candidates after the magic formula."""
    from s4g_tpu_torch.datagen import label_transfer as lt
    real = {name: getattr(lt, name) for name in
            ("processing_and_trace", "match_to_scene",
             "grade_against_scene")}

    def probe(name):
        def call(*args, **kw):
            rec = views[-1].setdefault(name, {})
            with timer(rec):
                res = real[name](*args, **kw)
            if name == "processing_and_trace":
                rec["voxels"] = int(res.valid.sum())
            if name == "grade_against_scene":
                rec["candidates"] = int(args[0].shape[0])
            return res
        return call
    try:
        for name in real:
            setattr(lt, name, probe(name))
        yield
    finally:
        for name, fn in real.items():
            setattr(lt, name, fn)


def _factory_end_to_end(meshes, out_dir, device):
    """`generate_end_to_end` whole (MuJoCo drop, render, grade, label,
    movability, merge) on the eight primitives as mesh assets."""
    from s4g_tpu_torch.datagen import generate, mesh_tools
    from s4g_tpu_torch.datagen.scene_sim import ObjectSpec
    specs = []
    for name, (verts, tris) in meshes.items():
        stl = os.path.join(out_dir, f"{name}.stl")
        mesh_tools.save_stl(stl, verts, tris)
        specs.append(ObjectSpec(name=name, geom_type="mesh",
                                mesh_files=[stl]))
    return generate.generate_end_to_end(
        meshes, specs, out_dir, scene_id=0, num_views=FACTORY_VIEWS,
        percentage=1.0, seed=51, label_capacity=FACTORY_CAPACITY,
        render_wh=FACTORY_WH, device=device)


def _factory_kernel_phase(view, cloud, frames, torch, extras):
    """K2f and K5 at the factory's shapes, held against their plain twins
    on the card (bit for bit) and timed beside them: the self ball queries
    of `estimate_normals` (K 30) and `darboux_frames` (K 64) on the eval
    view (`view`, N, 3) and on a graded object's cloud, and the eval
    view's collision counts of `frames` (G, 4, 4) local -> world poses.
    Bounds count the distance tests this data needs (a first-K scan stops
    at its K-th hit in index order) and K5's work on this data
    (`_k5_work`)."""
    from s4g_tpu_torch.ops import neighbors as nb
    from s4g_tpu_torch.pipeline import collision as col
    from s4g_tpu_torch.utils.math_utils import batch_transformation_inv
    out = {}
    for label, pts in (("view", view), ("object", cloud)):
        p = torch.from_numpy(pts).cuda().t()[None].contiguous()
        n = p.shape[2]
        for k in (30, 64):
            want = nb._ball_query_full(p, p, 0.01 * 0.01, k)
            _compare(f"ball_query_full factory {label} N={n} K={k}",
                     nb.ball_query_full_scan(p, p, 0.01, k), want, True)
            ms = _graph_ms(lambda k=k: nb.ball_query_full_scan(p, p, 0.01, k))
            plain = _event_ms(lambda k=k: nb._ball_query_full(
                p, p, 0.01 * 0.01, k), reps=3, warmup=1)
            # The first-K scan of a ball stops at its K-th hit in index
            # order (every key when it has fewer): count those tests.
            last = torch.where(want[1] >= k, want[0][..., -1].long() + 1,
                               torch.full_like(want[1], n, dtype=torch.long))
            tested = float(last.sum())
            bound, by = _bound_ms(9.0 * tested, 24 * n + 4 * n * (k + 1))
            out[f"{label}_k{k}"] = {"n": n, "ms": ms, "plain_ms": plain,
                                    "tested": tested, "all_pairs": n * n,
                                    "bound_ms": bound, "bound_by": by}
    extras.setdefault("ball_query_full", {})["factory"] = out

    g2l = batch_transformation_inv(
        torch.from_numpy(frames).cuda()).contiguous()
    pts = torch.from_numpy(view).cuda()
    cv = torch.cat([pts, torch.ones_like(pts[:, :1])], dim=1).contiguous()
    _compare(f"collision_counts factory {g2l.shape[0]} x {cv.shape[0]}",
             col.collision_counts(g2l, cv),
             col._collision_counts_plain(g2l, cv), True)
    ms = _graph_ms(lambda: col.collision_counts(g2l, cv))
    plain = _event_ms(lambda: col._collision_counts_plain(g2l, cv), reps=3,
                      warmup=1)
    ops, nbytes, pairs, in_z = _k5_work(g2l, cv)
    bound, by = _bound_ms(ops, nbytes)
    k5 = {"poses": g2l.shape[0], "points": cv.shape[0], "ms": ms,
          "plain_ms": plain, "bound_ms": bound, "bound_by": by,
          "pairs_in_z_slab": float(in_z)}
    extras.setdefault("collision_counts", {})["factory"] = k5
    print(f"factory kernels: K2f {json.dumps(out)}; K5 {json.dumps(k5)}",
          flush=True)


def _factory_phase(torch, np, device: str = "cuda", extras=None):
    """The label factory at full size on the card: the eight primitives
    graded by `grade_object` at its defaults (2,000 points, 2.5 mm voxels,
    every frame), composed on the table from a seeded pose dict (no drop
    simulation unless `mujoco` imports, which runs `generate_end_to_end`
    whole instead), four 640 x 480 views, `generate_view_labels` at
    capacity 16,384 on each and the online variant on one, a seeded
    direction table merged in, the contact flavour on two objects (4,096
    pairs) with refinement and smoothing, `generate_eval_view` (2,000
    grasp points, 300 baseline payloads) and `generate_baseline_view` (300
    grasps).  Per stage: CUDA-synchronized ms, peak memory, sizes; host-only
    stages apart.  The launch counters are zeroed before and read after:
    K2f twice per normals + frames pair, K5 once for the eval view, no
    other kernel.  Then, with `extras`, K2f and K5 at these shapes against
    their twins (`_factory_kernel_phase`).  Returns the launches and the
    numbers."""
    import importlib.util
    import shutil
    from s4g_tpu_torch import _build
    from s4g_tpu_torch.datagen import (baseline_generator, contact,
                                       eval_data, generate, label_transfer,
                                       merge, refine_contact, render,
                                       scene_compose)
    from s4g_tpu_torch.ops.neighbors import KERNEL_MIN_PAIRS

    timer = _synced(torch)
    smi = _nvidia_smi()
    meshes = _factory_meshes()
    index = {n: i for i, n in enumerate(meshes)}
    stages, host, views = {}, {}, []
    out_dir = os.path.join(_build.BUILD_DIR, "factory")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    mujoco = importlib.util.find_spec("mujoco") is not None

    _build.reset_launches()
    objects = {}
    if mujoco:
        with timer(stages.setdefault("generate_end_to_end", {})), \
                _label_stage_probes(timer, views):
            views.append({})
            merged = _factory_end_to_end(meshes, out_dir, device)
        obj_dir = os.path.join(out_dir, "single_object_data")
        for name in meshes:
            with open(os.path.join(obj_dir, f"{name}.p"), "rb") as f:
                objects[name] = pickle.load(f)
        poses = np.load(os.path.join(out_dir, "0.npy"),
                        allow_pickle=True)[()]
        records = []
        for path in merged:
            with open(path, "rb") as f:
                records.append(pickle.load(f))
        graded_k2f = 2 * len(meshes)
    else:
        for i, (name, mesh) in enumerate(meshes.items()):
            with timer(stages.setdefault("grade_object", {})):
                objects[name] = generate.grade_object(
                    *mesh, rng=np.random.RandomState(60 + i), device=device)
        poses = _resting_poses(meshes, np.random.RandomState(50), np)
        graded_k2f = 2 * len(meshes)
    scene = scene_compose.compose_scene(poses, objects, name_to_index=index)
    t0 = time.perf_counter()
    rendered = render.render_scene_views(
        {n: meshes[n] for n in poses}, poses, table_mesh=render.table_mesh(),
        rng=np.random.RandomState(52),
        camera_poses=render.CAMERA_POSE[:FACTORY_VIEWS],
        width=FACTORY_WH[0], height=FACTORY_WH[1])
    host[f"render {len(rendered)} views"] = 1e3 * (time.perf_counter() - t0)
    if not mujoco:
        direction = {"obj_list": list(meshes),
                     "move_distance": np.random.RandomState(53).rand(
                         len(meshes), 5)}
        table = merge.build_direction_table(direction, index, len(meshes))
        records = []
        with _label_stage_probes(timer, views):
            for v, (clean, noisy, cam) in enumerate(rendered):
                views.append({"points": len(noisy)})
                with timer(views[-1].setdefault("generate_view_labels", {})):
                    rec = label_transfer.generate_view_labels(
                        noisy, clean, cam, scene, capacity=FACTORY_CAPACITY,
                        device=device)
                records.append(merge.merge_scene(rec, table, v))
    clean, noisy, cam = rendered[0]
    with timer(stages.setdefault("generate_view_labels_online", {})):
        online = label_transfer.generate_view_labels_online(
            noisy, cam, scene, capacity=FACTORY_CAPACITY, device=device)

    contact_out = {}
    for i, name in enumerate(FACTORY_CONTACT_OBJECTS):
        data = objects[name]
        with timer(stages.setdefault("generate_contact_object_data", {})):
            pairs = contact.generate_contact_object_data(
                data["cloud"], data["normal"],
                max_pairs=FACTORY_CONTACT_PAIRS,
                rng=np.random.RandomState(70 + i), device=device)
        with timer(stages.setdefault("refine_contact_object", {})):
            refined = refine_contact.refine_contact_object(pairs,
                                                           device=device)
        t0 = time.perf_counter()
        smooth = refine_contact.smooth_contact_object(refined)
        host["smooth_contact_object"] = host.get(
            "smooth_contact_object", 0.0) + 1e3 * (time.perf_counter() - t0)
        contact_out[name] = (len(pairs["search_score"]),
                             len(refined["search_score"]),
                             len(smooth["search_score"]))

    cam_loc = cam[:3, 3].astype(np.float32)
    view = _workspace_view(noisy, np)
    with timer(stages.setdefault("generate_eval_view", {})):
        ev = eval_data.generate_eval_view(
            view, cam_loc, scene, FACTORY_EVAL_POINTS,
            rng=np.random.RandomState(80), with_baseline=True, device=device)
    with timer(stages.setdefault("generate_baseline_view", {})):
        base = baseline_generator.generate_baseline_view(
            view, cam_loc, scene, grasp_num=FACTORY_BASELINE_GRASPS,
            rng=np.random.RandomState(81), device=device)
    launches = dict(_build.LAUNCHES)
    if extras is not None:
        _factory_kernel_phase(view, objects["torus"]["cloud"], ev["frames"],
                              torch, extras)

    eval_k5 = int(len(ev["frames"]) * len(view) >= KERNEL_MIN_PAIRS)
    expected = {k: 0 for k in launches}
    expected.update(ball_query_full=graded_k2f + 2 + 2 + 2,
                    collision_counts=eval_k5)
    if launches != expected:
        raise AssertionError(f"factory launches {launches}, expected "
                             f"{expected}")
    if not eval_k5:
        raise AssertionError(f"eval view {len(ev['frames'])} poses x "
                             f"{len(view)} points is below K5's threshold")

    valid = [len(r["valid_index"]) for r in records]
    if not sum(valid):
        raise AssertionError("factory: no view yields a valid label")
    for r in records + [online]:
        if len(r["valid_index"]) and not (
                (r["search_score"] >= 0).all()
                and (r["antipodal_score"] >= 0).all()
                and (r["antipodal_score"] <= 1).all()):
            raise AssertionError("factory: a score lies out of its range")
    for name, arr in (("eval", ev["antipodal_score"]),
                      ("baseline", base["antipodal_score"])):
        if not ((arr >= 0).all() and (arr <= 1).all()):
            raise AssertionError(f"factory: a {name} score is out of [0, 1]")
    scored = {n: int((o["search_score"] > 0).any(axis=(1, 2)).sum())
              for n, o in objects.items()}
    numbers = {
        "device": smi, "mujoco": mujoco,
        "objects: points": {n: len(o["cloud"]) for n, o in objects.items()},
        "objects: points with a scored pose": scored,
        "scene points": len(scene["cloud"]),
        "views": [{k: (v if not isinstance(v, dict) else
                       {a: (round(b, 3) if isinstance(b, float) else b)
                        for a, b in v.items()})
                   for k, v in view_rec.items()} for view_rec in views],
        "valid labels per view": valid,
        "valid labels, online view": len(online["valid_index"]),
        "contact: frames, refined, smoothed": contact_out,
        "eval: poses, view points, non-colliding, scored": (
            len(ev["frames"]), len(view), int(ev["non_collision_bool"].sum()),
            int((ev["antipodal_score"] > 0).sum())),
        "eval: baseline payloads": len(ev["baseline_index"]),
        "baseline grasps": len(base["grasp_score_labels"]),
        "stages (ms, peak GiB above inputs)": {
            k: (round(v["ms"], 3), round(v["peak_gib"], 4))
            for k, v in stages.items()},
        "host stages (ms)": {k: round(v, 3) for k, v in host.items()},
        "launches": {k: v for k, v in launches.items() if v}}
    print(f"factory ({smi}): {json.dumps(numbers)}", flush=True)
    return launches, numbers


def _tool_scene(np) -> str:
    """The seeded tabletop (`tabletop_cloud(RandomState(0))`, 65,000
    points) as a scene pickle ({"point_cloud": (3, n)}) in the build
    directory: the entry points' input.  Returns its path."""
    import pickle
    from s4g_tpu_torch import _build
    path = os.path.join(_build.BUILD_DIR, "tools_tabletop_view_0.p")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump({"point_cloud": tabletop_cloud(
            np.random.RandomState(0)).T.copy()}, f)
    return path


def _overflows() -> int:
    """SA1 window overflows so far (K2's fallback and K3's)."""
    from s4g_tpu_torch.ops import neighbors as nb
    from s4g_tpu_torch.ops import sa_fused as sf
    return nb.SLAB_FALLBACKS["overflow"] + sf.SA1_FALLBACKS["overflow"]


def _deployed_shim():
    """What `_deployed_launches` reads of a detector, for the port's
    curvature_model.yaml as the tools load it."""
    from types import SimpleNamespace
    from s4g_tpu_torch.configs.config import load_cfg_from_file
    from s4g_tpu_torch.tools.common import DEFAULT_CFG
    cfg = load_cfg_from_file(DEFAULT_CFG)
    return SimpleNamespace(cfg=cfg, num_input=cfg.MODEL.PN2.NUM_INPUT)


def _forward_launches(b: int, forwards: int, overflows: int,
                      collision: int = 0, fused=None) -> dict:
    """Launches of `forwards` deployed forwards at batch `b`, `overflows`
    of which overflowed SA1's key windows (their SA1 through K2f), and
    `collision` K5 launches."""
    base = _deployed_launches(_deployed_shim(), b, fused=fused)
    out = {k: v * forwards for k, v in base.items()}
    sa1 = "ball_query_slab" if base["ball_query_slab"] else "sa1_fused"
    out[sa1] -= overflows
    out["ball_query_full"] += overflows
    out["collision_counts"] = collision
    return out


def _counted_tool(label, call, expected):
    """Run `call()` with the launch counters zeroed; `expected(overflows)`
    gives the launches it must make.  Returns (result, launches)."""
    from s4g_tpu_torch import _build
    over = _overflows()
    _build.reset_launches()
    out = call()
    launches = dict(_build.LAUNCHES)
    want = expected(_overflows() - over)
    print(f"{label}: launches {launches}", flush=True)
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, expected "
                             f"{want}")
    return out, launches


def _match_rows(label, got, want, atol: float = 1e-5):
    """Every row of `got` within `atol` of a distinct row of `want` (a set
    comparison)."""
    import numpy as np
    if got.shape != want.shape:
        raise AssertionError(f"{label}: shapes {got.shape} {want.shape}")
    flat_w = want.reshape(len(want), -1)
    free = list(range(len(flat_w)))
    worst = 0.0
    for row in got.reshape(len(got), -1):
        dist = np.abs(flat_w[free] - row).max(axis=1)
        k = int(np.argmin(dist))
        worst = max(worst, float(dist[k]))
        free.pop(k)
    if worst > atol:
        raise AssertionError(f"{label}: a row is {worst:.3g} from any other")
    return worst


def _proposal_phase(det, torch, np, scene, device: str = "cuda"):
    """`tools/grasp_proposal_test` on the tabletop pickle at full width, in
    its own directory (its timing files land in the working directory):
    a warm-up and a timed forward (exact launches), its artifacts present.
    Then `log_to_file(with_label=False)` on one forward's predictions, on
    the card and on the CPU: the top-K set equal, the collision masks of
    the same poses equal, the top frames (top_frames.npy) within 1e-5 as a
    set.  Returns the launches and the numbers."""
    import contextlib as cl
    from s4g_tpu_torch.pipeline.collision import batch_view_non_collision
    from s4g_tpu_torch.pipeline.file_logger import log_to_file
    from s4g_tpu_torch.pipeline.postprocessing import expected_score
    from s4g_tpu_torch.tools import grasp_proposal_test
    from s4g_tpu_torch.utils.math_utils import (batch_transformation_inv,
                                                gram_schmidt_frames)

    out = _output_dir("tool_proposal")
    os.makedirs(out)
    with cl.chdir(out):
        got, launches = _counted_tool(
            "grasp_proposal_test", lambda: grasp_proposal_test.main(
                ["--scene", scene, "--output", out, "--device", device]),
            lambda over: _forward_launches(1, 2, over))
    step = os.path.join(out, "test_step00000")
    names = ["scene_points.xyz", "scene_score_logits.txt", "pred_frame_R.txt",
             "pred_frame_t.txt", "pred_scene_score.txt", "pred_pts.ply"]
    if got["num_poses"]:
        names += ["cloud.ply", "top_hands.ply", "../top_frames.npy"]
    missing = [x for x in names + ["../inference_time_ours.txt",
                                   "../postprocess_time_ours.txt"]
               if not os.path.getsize(os.path.join(step, x))]
    if missing:
        raise AssertionError(f"grasp_proposal_test: empty {missing}")

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    batch = grasp_proposal_test.load_static_data_batch(scene, det.num_input,
                                                       gen)
    with torch.no_grad():
        preds = det.net(batch)
    sides = {}
    for side, dev in (("card", device), ("cpu", "cpu")):
        d = os.path.join(out, f"log_{side}")
        with cl.chdir(out):
            res = log_to_file({k: v.to(dev) for k, v in batch.items()},
                              {k: v.to(dev) for k, v in preds.items()}, 0, d,
                              with_label=False)
        score = expected_score(preds["score"][0].to(dev), upper_bins=False)
        sides[side] = (res, np.argsort(-score.cpu().numpy())[:50], d)
    (g_res, g_top, g_dir), (c_res, c_top, c_dir) = sides["card"], sides["cpu"]
    if set(g_top) != set(c_top):
        raise AssertionError(f"log_to_file top-50 sets differ: "
                             f"{sorted(set(g_top) ^ set(c_top))}")
    top = np.sort(c_top)
    rot = gram_schmidt_frames(preds["frame_R"][0].t().reshape(-1, 3, 3)[
        torch.from_numpy(top)])
    pts = batch["scene_points"][0].t()
    poses = torch.eye(4, device=device).repeat(len(top), 1, 1)
    poses[:, :3, :3] = rot
    poses[:, :3, 3] = pts[torch.from_numpy(top)]
    g2l = batch_transformation_inv(poses).cpu()
    masks = [batch_view_non_collision(g2l.to(dev), pts.to(dev)).cpu()
             for dev in (device, "cpu")]
    if not torch.equal(*masks):
        raise AssertionError("log_to_file collision masks differ")
    err = _match_rows("log_to_file top poses",
                      np.concatenate([g_res[0].reshape(-1, 16),
                                      g_res[1][:, None]], 1),
                      np.concatenate([c_res[0].reshape(-1, 16),
                                      c_res[1][:, None]], 1))
    if len(g_res[0]):
        err = max(err, _match_rows(
            "top_frames.npy", np.load(os.path.join(g_dir, "top_frames.npy")),
            np.load(os.path.join(c_dir, "top_frames.npy"))))
    numbers = {"forward_ms": got["forward_ms"], "data_ms": got["data_ms"],
               "num_poses": got["num_poses"], "top_max_abs_err": err,
               "viable_top50": len(g_res[0])}
    print(f"grasp_proposal_test ({got['device']}): forward "
          f"{got['forward_ms']:.2f} ms, data {got['data_ms']:.2f} ms, "
          f"{got['num_poses']} viable of the top 50, artifacts present; "
          f"log_to_file GPU vs CPU: top-50 sets equal, collision masks equal "
          f"({int(masks[0].sum())} of 50 clear), top frames within "
          f"{err:.3g}", flush=True)
    return launches, numbers


def _measure_batch_phase(torch, np, scene, device: str = "cuda"):
    """`tools/measure_batch` at b = 1, 2 and 4 on the tabletop pickle (its
    JSON line printed): 2 + REPS forwards, then 2 + REPS forwards with
    post-processing (K5 per scene), every launch counted.  Returns the
    launches by batch and the JSON lines."""
    from s4g_tpu_torch.tools import measure_batch

    paths, lines = {}, {}
    calls = 2 + measure_batch.REPS
    for b in (1, 2, 4):
        lines[b], paths[f"measure_batch_b{b}"] = _counted_tool(
            f"measure_batch b={b}", lambda: measure_batch.main(
                [str(b), "--scene", scene, "--device", device]),
            lambda over: _forward_launches(b, 2 * calls, over,
                                           collision=calls * b))
    return paths, lines


def _measure_stream_phase(torch, np, scene, frames: int = STREAM_FRAMES,
                          device: str = "cuda"):
    """`tools/measure_stream` over `frames` frames of the tabletop pickle at
    depths 1 and 2 (its JSON lines printed): each run 1 + 2 + 2 x `frames`
    detects, every launch counted (K5 once a detect).  Returns the launches
    of both runs and the JSON lines."""
    from s4g_tpu_torch.tools import measure_stream

    out = _output_dir("tool_stream")
    detects = 3 + 2 * frames
    total, lines = {}, {}
    for depth in (1, 2):
        lines[depth], launches = _counted_tool(
            f"measure_stream depth {depth}", lambda: measure_stream.main(
                [str(frames), str(depth), "--scene", scene, "--output", out,
                 "--device", device]),
            lambda over: _forward_launches(1, detects, over,
                                           collision=detects))
        total = _add(total, launches)
    return total, lines


def _train_cli_phase(torch, np, device: str = "cuda"):
    """`tools/train` at full width (the port's curvature_model.yaml, b = 2)
    for one epoch of `_train_data`'s six pickles in its own directory,
    validating on two of them copied into another (`--val-dir`): 3 steps,
    each step's launches exact (K8 `_k8_per_step` times) and timed with
    CUDA events (the class's `train_step` wrapped for the call), then one
    validation step at b = 2,
    its launches exact (SA1 through K3 in eval mode), then the checkpoint
    it wrote (`model_001`, through `last_checkpoint`) read back equal to
    the final weights.  Returns the launches and the numbers."""
    import contextlib as cl
    import shutil
    from s4g_tpu_torch import _build
    from s4g_tpu_torch.tools import train as train_cli
    from s4g_tpu_torch.train.trainer import Trainer
    from s4g_tpu_torch.utils.checkpoint import Checkpointer

    root = _train_data(np)
    val = os.path.join(_build.BUILD_DIR, "train_val")
    shutil.rmtree(val, ignore_errors=True)
    os.makedirs(val)
    for i in range(2):
        shutil.copy(os.path.join(root, f"{i}_view_0.p"), val)
    out = _output_dir("tool_train")
    os.makedirs(out)
    steps, real = [], Trainer.train_step
    val_steps, real_val = [], Trainer.val_step

    def train_step(self, batch):
        over, before = _overflows(), dict(_build.LAUNCHES)
        start, end = _cuda_event(torch), _cuda_event(torch)
        start.record()
        result = real(self, batch)
        end.record()
        launches = {k: _build.LAUNCHES[k] - before[k] for k in before}
        want = {**_forward_launches(2, 1, _overflows() - over, fused=False),
                "gather_backward": _k8_per_step(self.net)}
        if launches != want:
            raise AssertionError(f"train CLI step: launches {launches}, "
                                 f"expected {want}")
        steps.append((start, end))
        return result

    def val_step(self, batch):
        over, before = _overflows(), dict(_build.LAUNCHES)
        result = real_val(self, batch)
        launches = {k: _build.LAUNCHES[k] - before[k] for k in before}
        want = _forward_launches(2, 1, _overflows() - over)
        if launches != want:
            raise AssertionError(f"train CLI validation: launches "
                                 f"{launches}, expected {want}")
        val_steps.append(launches)
        return result

    _build.reset_launches()
    Trainer.train_step, Trainer.val_step = train_step, val_step
    try:
        with cl.chdir(out):
            state = train_cli.main(["--data-dir", root, "--val-dir", val,
                                    "--output", out, "--max-epochs", "1",
                                    "--device", device])
    finally:
        Trainer.train_step, Trainer.val_step = real, real_val
    launches = dict(_build.LAUNCHES)
    ckpt = Checkpointer(out)
    saved = ckpt.load(None, resume=True)
    if (state.step != TRAIN_SCENES // 2 or len(steps) != state.step
            or len(val_steps) != 1
            or not ckpt.last_checkpoint_path().endswith("model_001.ckpt")
            or saved["extra"]["step"] != state.step):
        raise AssertionError(f"train CLI: step {state.step}, {len(steps)} "
                             f"steps, {ckpt.last_checkpoint_path()}")
    bad = [k for k, v in state.model.items()
           if not torch.equal(saved["model"][k].cpu(), v.cpu())]
    if bad:
        raise AssertionError(f"train CLI checkpoint differs: {bad[:5]}")
    if device == "cuda":
        torch.cuda.synchronize()
    ms = [s.elapsed_time(e) for s, e in steps]
    numbers = {"steps": len(steps), "step_ms": ms,
               "median_after_first_ms": statistics.median(ms[1:])}
    print(f"train CLI ({_nvidia_smi()}): {len(steps)} steps, step ms "
          + ", ".join(f"{t:.2f}" for t in ms) + f" (median after the first "
          f"{numbers['median_after_first_ms']:.2f}); validation step "
          f"launches {val_steps[0]}; checkpoint model_001 read back equal; "
          f"launches {launches}", flush=True)
    return launches, numbers


def _profile_stages_phase(torch, np, scene, device: str = "cuda"):
    """`tools/profile_stages` once (b = 1, the tabletop pickle): each
    recorded op timed alone.  Its launches depend on how many replays each
    op takes (the counters see a CUDA graph's capture, not its replays),
    so every kernel of the b = 1 forward must launch (K2 unless SA1's
    windows overflowed) and no other, and the path stays out of
    `launches_by_path`.  Returns the tool's report."""
    from s4g_tpu_torch import _build
    from s4g_tpu_torch.tools import profile_stages

    over = _overflows()
    _build.reset_launches()
    got = profile_stages.main(["--scene", scene, "--device", device])
    launches = dict(_build.LAUNCHES)
    need = {"fps_lane", "ball_query_full", "three_nn"}
    if _overflows() == over:
        need.add("ball_query_slab")
    if any(not launches[k] for k in need) or any(
            launches[k] for k in launches if k not in need | {
                "ball_query_slab"}):
        raise AssertionError(f"profile_stages launches {launches}")
    print(f"profile_stages: kernels launched "
          f"{sorted(k for k, n in launches.items() if n)}", flush=True)
    return got


KERNEL_NAMES = {"fps_lane": ("fps_nested_kernel", "fps_lane_kernel"),
                "fps_exact": ("fps_cluster_kernel",),
                "ball_query_slab": ("ball_query_slab_kernel",),
                "ball_query_full": ("::warp_kernel", "::tile_kernel"),
                "sa1_fused": ("sa1_fused_kernel",),
                "three_nn": ("three_nn_kernel",),
                "collision_counts": ("collision_counts_kernel",),
                "mlp_chain": ("mlp_chain_kernel", "mlp_wg_kernel",
                              "mlp_wide_kernel"),
                "gather_backward": ("gather_backward_kernel",)}


def _trace_phase(torch, np, scene, device: str = "cuda"):
    """`tools/trace_forward --detect`: its REPS traced detects (forward,
    post-processing, collision check) after a warm-up, launches exact, and
    its Chrome trace file names the kernel of every port kernel that
    launched.  Returns the launches and the numbers."""
    from s4g_tpu_torch.tools import trace_forward

    trace_dir = _output_dir("tool_trace")
    calls = 1 + trace_forward.REPS
    got, launches = _counted_tool(
        "trace_forward --detect", lambda: trace_forward.main(
            ["--detect", "--scene", scene, "--trace-dir", trace_dir, "--top",
             "15", "--device", device]),
        lambda over: _forward_launches(1, calls, over, collision=calls))
    with open(got["trace_file"]) as f:
        text = f.read()
    absent = [k for k, n in launches.items()
              if n and not any(name in text for name in KERNEL_NAMES[k])]
    if absent or not got["kernels"]:
        raise AssertionError(f"trace {got['trace_file']}: no device time, "
                             f"or no kernel of {absent}")
    print(f"trace_forward: {os.path.getsize(got['trace_file'])} bytes of "
          f"Chrome trace naming every launched port kernel; device "
          f"{got['device_ms_per_exec']:.3f} ms a detect", flush=True)
    return launches, {"device_ms_per_exec": got["device_ms_per_exec"]}


# -- the label factory's tools, the measurement tools, host_ops and guard ---------

# train_at_scale at full width (25,600 points, centroids 5120/1024/256, the
# deployed widths, b = 4), depth cut to 6 steps.  Two held-out scenes: one
# scene's two views are fewer than a batch of 4, and the dataset drops the
# remainder (as the JAX package's does), so the validation pass would see
# no batch.
SCALE_ARGV = ["--object-set", "procedural", "--scenes", "2", "--val-scenes",
              "2", "--views", "2", "--steps", "6", "--batch", "4",
              "--num-points", "25600"]
DEMO_ARGV = ["--scenes", "2", "--epochs", "1"]
MESH_QA_ARGV = ["--procedural", "--views", "2"]
FPS_SHARDED_RUNS = (("25600", "5120", "128"), ("25600", "5120", "1"))


def _spec_mesh(spec):
    """(vertices, triangles) of a scene_sim ObjectSpec: its mesh file, or
    the box of its half sizes."""
    from s4g_tpu_torch.datagen import mesh_tools
    from s4g_tpu_torch.tools.train_at_scale import box_mesh
    if spec.geom_type == "mesh":
        return mesh_tools.load_mesh(spec.mesh_files[0])
    if spec.geom_type != "box":
        raise ValueError(f"no stand-in mesh for a {spec.geom_type} geom")
    return box_mesh(*map(float, spec.size.split()))


class _RestingTableEnv:
    """Stand-in for `datagen.scene_sim.TableEnv` where `mujoco` does not
    import: every object rests on the table at a pose drawn from the seed
    (`_resting_poses`), no drop simulation."""

    def __init__(self, objects, percentage=0.5, random_seed=None,
                 meshdir=None):
        import numpy as np
        self.all_objects = list(objects)
        self.rng = np.random.RandomState(random_seed)
        self.xml = ""

    def run(self, *args, **kwargs):
        import numpy as np
        return _resting_poses({s.name: _spec_mesh(s)
                               for s in self.all_objects}, self.rng, np)


class _SeededDirections:
    """Stand-in for `datagen.movability.DirectionGenerator` where `mujoco`
    does not import: a seeded move-distance table, as `_factory_phase`
    makes one by hand."""

    def __init__(self, xml, pose_dict, timestep=0.002):
        import numpy as np
        self.obj = sorted(pose_dict)
        self.rng = np.random.RandomState(53)

    def run(self, save_path=None):
        import numpy as np
        return {"move_distance": self.rng.rand(len(self.obj), 5),
                "obj_list": self.obj,
                "mesh_center": np.zeros((len(self.obj), 3))}


@contextlib.contextmanager
def _mujoco_standins(force=None):
    """Where `mujoco` does not import (`force` overrides the test), put
    `_RestingTableEnv` and `_SeededDirections` in the place of TableEnv and
    DirectionGenerator in the factory's modules for the block, and print
    so.  No tool has a switch for this: the substitution lives in this
    script only."""
    import importlib.util
    from s4g_tpu_torch.datagen import generate, movability, scene_sim
    need = (importlib.util.find_spec("mujoco") is None if force is None
            else force)
    if not need:
        yield
        return
    patches = [(scene_sim, "TableEnv", _RestingTableEnv),
               (generate, "TableEnv", _RestingTableEnv),
               (movability, "DirectionGenerator", _SeededDirections),
               (generate, "DirectionGenerator", _SeededDirections)]
    old = [(m, n, getattr(m, n)) for m, n, _ in patches]
    for m, n, v in patches:
        setattr(m, n, v)
    print(json.dumps({"mujoco": False, "stand-ins": [
        "TableEnv: _RestingTableEnv (seeded resting poses)",
        "DirectionGenerator: _SeededDirections (seeded distances)"]}),
        flush=True)
    try:
        yield
    finally:
        for m, n, v in old:
            setattr(m, n, v)


def _net_launches(net, n: int, b: int, overflow: bool) -> dict:
    """Launches of one forward of `net` (PN2_CLS) on B x 3 x N points, from
    its route: FPS once for all SA stages through K1 where the stages nest
    (SORT_POINTS, FPS_SHARDS 128), else K6 once a stage; SA1 through K3
    where it fuses (sorted, eval, `SA1_FUSE`'s batch rule), else K2 where
    the sorted input is above the slab capacity, else (and on a window
    overflow) K2f; K2f for every other stage; K4 for each FP stage at or
    above its pair threshold.  No K5 (post-processing's) and no K7."""
    from s4g_tpu_torch import _build
    from s4g_tpu_torch.ops.neighbors import KERNEL_MIN_PAIRS
    from s4g_tpu_torch.ops.sampling import fps_nesting_applies
    cents = [m.num_centroids for m in net.sa_modules]
    sizes = (n, *cents)
    out = {k: 0 for k in _build.LAUNCHES}
    out["three_nn"] = sum(a * c >= KERNEL_MIN_PAIRS
                          for a, c in zip(sizes, sizes[1:]))
    if net.sort_points and net.fps_shards > 1:
        if not fps_nesting_applies(n, cents, net.fps_shards):
            raise ValueError(f"no launch rule for FPS_SHARDS "
                             f"{net.fps_shards} on {sizes}")
        out["fps_lane"] = 1
    else:
        out["fps_exact"] = len(cents)
    out["ball_query_full"] = len(cents) - 1
    if not (net.sort_points and n > SLAB_CAPACITY) or overflow:
        out["ball_query_full"] += 1
    elif net.sa_modules[0]._fuses(b, 0):
        out["sa1_fused"] = 1
    else:
        out["ball_query_slab"] = 1
    return out


# The tools' kernel calls held against the plain twins, by kernel: one
# entry a held (tool, argument signature), filled by `_held_kernels`; the
# kernels line counts them.
TOOL_SHAPES_HELD = {}


def _kernel_twins():
    """(launch name, module, wrapper name, plain twin taking the wrapper's
    arguments) for every kernel a tool's run can launch but K3 and K7: no
    tool run here reaches K7, and K3 only trace_forward at b = 2 on the
    tabletop, the shape the kernels phase holds (`_k3_phase`)."""
    from s4g_tpu_torch.models import pointnet2
    from s4g_tpu_torch.ops import gather as gt
    from s4g_tpu_torch.ops import neighbors as nb
    from s4g_tpu_torch.ops import sampling as sp
    from s4g_tpu_torch.pipeline import collision as col

    def bq_full(points, centroids, radius, num_neighbours, stratified=False,
                sorted_axis=None):
        return nb._ball_query_full(points, centroids, radius * radius,
                                   num_neighbours, stratified=stratified)

    def bq_slab(points, centroids, lo_tile, radius, num_neighbours,
                stratified=False):
        return nb._ball_query_slab_plain(points, centroids, lo_tile,
                                         radius * radius, num_neighbours,
                                         stratified)

    return [("gather_backward", gt, "gather_backward",
             gt._gather_backward_plain),
            ("fps_exact", sp, "fps_exact", sp._fps_plain),
            ("fps_exact", sp, "fps_sharded", sp._fps_sharded_plain),
            ("fps_lane", sp, "fps_lane_sharded", sp._fps_sharded_plain),
            ("fps_lane", pointnet2, "fps_lane_nested", sp._fps_nested_plain),
            ("ball_query_full", nb, "ball_query_full_scan", bq_full),
            ("ball_query_slab", nb, "ball_query_fused_slab", bq_slab),
            ("three_nn", nb, "three_nn_fused", nb._three_nn_plain),
            ("collision_counts", col, "collision_counts",
             col._collision_counts_plain)]


def _signature(x):
    """Shapes, dtypes and scalars of a call's arguments (tensors by shape
    and dtype), hashable."""
    import torch
    if torch.is_tensor(x):
        return (tuple(x.shape), str(x.dtype))
    if isinstance(x, (list, tuple)):
        return tuple(_signature(y) for y in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _signature(v)) for k, v in x.items()))
    return x


def _described(args) -> str:
    """A call's positional arguments for a reader: tensors by shape
    (4x3x25600), the rest as they are."""
    import torch
    return ", ".join("x".join(map(str, a.shape)) if torch.is_tensor(a)
                     else repr(a) for a in args)


def _copied(x):
    """`x` with every tensor in it detached and cloned."""
    import torch
    if torch.is_tensor(x):
        return x.detach().clone()
    if isinstance(x, (list, tuple)):
        return type(x)(_copied(y) for y in x)
    if isinstance(x, dict):
        return {k: _copied(v) for k, v in x.items()}
    return x


@contextlib.contextmanager
def _held_kernels(label):
    """Hold the kernels a tool's run launches against their plain twins at
    the shapes the run gives them: the first call of each kernel wrapper
    (`_kernel_twins`) at each argument signature keeps copies of its
    arguments and outputs; after the block the twin runs on the copies and
    must give the same bits, and every kernel the block launched (but K3)
    must have had a call held.  Copies, compared after the block, so the
    tool's own times and memory are not the check's.  Yields the record
    {kernel: [held signatures]}."""
    import torch
    from s4g_tpu_torch import _build
    twins = _kernel_twins()
    kept, held = {}, {}
    before = dict(_build.LAUNCHES)

    def wrap(kernel, name, real, twin):
        def call(*args, **kwargs):
            out = real(*args, **kwargs)
            sig = (kernel, name, _signature(args), _signature(kwargs))
            if sig not in kept:
                kept[sig] = (twin, _copied(args), _copied(kwargs),
                             _copied(out))
            return out
        return call

    reals = [(module, name, getattr(module, name))
             for _, module, name, _ in twins]
    for (kernel, module, name, twin), (_, _, real) in zip(twins, reals):
        setattr(module, name, wrap(kernel, name, real, twin))
    try:
        yield held
    finally:
        for module, name, real in reals:
            setattr(module, name, real)
    for (kernel, name, sig, _), (twin, args, kwargs, out) in kept.items():
        with torch.no_grad():
            want = twin(*args, **kwargs)
        got = list(out) if isinstance(out, (list, tuple)) else [out]
        want = list(want) if isinstance(want, (list, tuple)) else [want]
        call = f"{name}({_described(args)})"
        _compare(f"{label}: {call}", got, want, True)
        held.setdefault(kernel, []).append(call)
        TOOL_SHAPES_HELD.setdefault(kernel, []).append(f"{label}: {call}")
    kept.clear()
    launched = {k for k in before if _build.LAUNCHES[k] > before[k]}
    unheld = launched - set(held) - {"sa1_fused", "mlp_chain"}
    if unheld:
        raise AssertionError(f"{label}: {sorted(unheld)} launched with no "
                             "call held against the plain twin")
    print(f"{label}: kernels equal to their plain twins, bit for bit, at "
          f"the run's shapes: {json.dumps(held)}", flush=True)


@contextlib.contextmanager
def _tool_launches(label):
    """Zero the launch counters and hold every launch of a tool's run in
    the block to its cause: each PN2_CLS forward launches exactly its
    route's kernels (`_net_launches`, with the SA1 overflow it reported),
    each train step's backward K8 once per gather with a gradient
    (`_k8_per_step`), each `grade_object` K2f twice (normals and frames),
    each collision check K5 once where its pose-point pairs reach the
    kernel's threshold
    (else nothing), and nothing launches outside them: the totals must
    equal the sum.  Yields the record (counts of forwards, their batch
    sizes, backwards, grades, collision checks, K5s); after the block
    record["launches"] holds the totals, and record["held"] the calls held
    against the plain twins (`_held_kernels`): the tool's own kernel
    shapes, compared after its run, so a phase reads the tool's times and
    peak memory inside the block."""
    from s4g_tpu_torch import _build
    from s4g_tpu_torch.datagen import generate
    from s4g_tpu_torch.models.pointnet2 import PointNet2CLS
    from s4g_tpu_torch.ops.neighbors import KERNEL_MIN_PAIRS
    from s4g_tpu_torch.pipeline import collision
    from s4g_tpu_torch.train.trainer import Trainer

    zero = {k: 0 for k in _build.LAUNCHES}
    rec = {"forwards": 0, "batches": [], "grades": 0, "collisions": 0,
           "k5": 0, "backwards": 0, "expected": dict(zero)}
    real = (PointNet2CLS.forward, generate.grade_object,
            collision.batch_view_non_collision, Trainer.backward)

    def held(what, before, want):
        got = {k: _build.LAUNCHES[k] - before[k] for k in before}
        if got != want:
            raise AssertionError(f"{label}: {what}: launches {got}, "
                                 f"expected {want}")
        rec["expected"] = _add(rec["expected"], want)

    def forward(self, data_batch, *args, **kwargs):
        b, _, n = data_batch["scene_points"].shape
        before, over = dict(_build.LAUNCHES), _overflows()
        out = real[0](self, data_batch, *args, **kwargs)
        held("a forward", before,
             _net_launches(self, n, b, _overflows() > over))
        rec["forwards"] += 1
        rec["batches"].append(b)
        return out

    def grade_object(*args, **kwargs):
        before = dict(_build.LAUNCHES)
        out = real[1](*args, **kwargs)
        held("grade_object", before, {**zero, "ball_query_full": 2})
        rec["grades"] += 1
        return out

    def batch_view_non_collision(g2l, cloud, *args, **kwargs):
        before = dict(_build.LAUNCHES)
        out = real[2](g2l, cloud, *args, **kwargs)
        k5 = int(g2l.shape[0] * cloud.shape[0] >= KERNEL_MIN_PAIRS)
        held("a collision check", before, {**zero, "collision_counts": k5})
        rec["collisions"] += 1
        rec["k5"] += k5
        return out

    def backward(self, total):
        before = dict(_build.LAUNCHES)
        real[3](self, total)
        held("a train step's backward", before,
             {**zero, "gather_backward": _k8_per_step(self.net)})
        rec["backwards"] += 1

    _build.reset_launches()
    PointNet2CLS.forward = forward
    generate.grade_object = grade_object
    collision.batch_view_non_collision = batch_view_non_collision
    Trainer.backward = backward
    try:
        with _held_kernels(label) as twins_held:
            yield rec
    finally:
        (PointNet2CLS.forward, generate.grade_object,
         collision.batch_view_non_collision, Trainer.backward) = real
    rec["held"] = twins_held
    rec["launches"] = dict(_build.LAUNCHES)
    if rec["launches"] != rec["expected"]:
        raise AssertionError(f"{label}: launches {rec['launches']}, "
                             f"expected {rec['expected']}")
    print(f"{label}: {rec['forwards']} forwards (batches "
          f"{sorted(set(rec['batches']))}), {rec['backwards']} backwards, "
          f"{rec['grades']} objects graded, "
          f"{rec['collisions']} collision checks ({rec['k5']} on K5); "
          f"launches {rec['launches']}", flush=True)


class _Tee:
    """A text stream writing to several streams."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for stream in self.streams:
            stream.write(text)
        return len(text)

    def flush(self):
        for stream in self.streams:
            stream.flush()


def _tool_log_dir() -> str:
    from s4g_tpu_torch import _build
    return os.path.join(_build.BUILD_DIR, "tool_logs")


@contextlib.contextmanager
def _logged(name: str):
    """Standard output of the block shown and also written to `name`.log
    in the tool log directory (what `r3_summarize` reads).  Yields the
    log's path."""
    path = os.path.join(_tool_log_dir(), f"{name}.log")
    with open(path, "w") as f, contextlib.redirect_stdout(
            _Tee(sys.stdout, f)):
        yield path


def _state_sha(state: dict) -> str:
    """sha256 over a state dict's names and tensor bytes."""
    import hashlib
    h = hashlib.sha256()
    for k in sorted(state):
        h.update(k.encode())
        h.update(state[k].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _scale_phase(torch, np, device: str = "cuda"):
    """`tools/train_at_scale` at full width (`SCALE_ARGV`): the label
    factory makes 2 training and 2 held-out scenes of two 640 x 480 views
    from the procedural catalog (33 objects graded into each root), then
    `Trainer.fit` for 6 steps at b = 4, the validation pass, the detection
    QA on the fitted weights and the steady-state loop.  Every launch held
    to its cause (`_tool_launches`): per forward K6 3, K2f 3, K4 2; per
    graded object K2f 2; the QA's collision check K5 1; each held against
    its plain twin at the run's shapes (b = 4 in training and validation,
    b = 1 in the QA, each object's self queries).  Each train step
    timed with CUDA events; the QA's weights must hash to the checkpoint
    fit saved.  Returns (launches, numbers, output directory, QA dict)."""
    from s4g_tpu_torch.tools import train_at_scale
    from s4g_tpu_torch.train.trainer import Trainer
    from s4g_tpu_torch.utils.checkpoint import Checkpointer, model_state_dict

    out = _output_dir("tool_train_at_scale")
    steps, vals, qa_hash = [], [], []
    real_step, real_val = Trainer.train_step, Trainer.val_step
    real_qa = train_at_scale.run_detect_qa

    def train_step(self, batch):
        start = _cuda_event(torch) if device == "cuda" else None
        end = _cuda_event(torch) if device == "cuda" else None
        if start is not None:
            start.record()
        result = real_step(self, batch)
        if end is not None:
            end.record()
        steps.append((start, end))
        return result

    def val_step(self, batch):
        vals.append(1)
        return real_val(self, batch)

    def run_detect_qa(weights, *args, **kwargs):
        qa_hash.append(_state_sha(weights))
        return real_qa(weights, *args, **kwargs)

    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    Trainer.train_step, Trainer.val_step = train_step, val_step
    train_at_scale.run_detect_qa = run_detect_qa
    try:
        with _mujoco_standins(), _tool_launches("train_at_scale") as rec:
            summary = train_at_scale.main(["--out", out, *SCALE_ARGV,
                                           "--device", device])
            wall = time.perf_counter() - t0
            peak = (torch.cuda.max_memory_allocated() / 2 ** 30
                    if device == "cuda" else None)
    finally:
        Trainer.train_step, Trainer.val_step = real_step, real_val
        train_at_scale.run_detect_qa = real_qa
    saved = model_state_dict(Checkpointer(os.path.join(
        out, "train_out")).load(None))
    if qa_hash != [_state_sha(saved)]:
        raise AssertionError("train_at_scale: the QA's weights are not the "
                             "checkpoint fit saved")
    want_forwards = (summary["steps"] + len(vals) + 1 + 1
                     + train_at_scale.STEADY_REPS)
    if (rec["forwards"] != want_forwards or not vals or rec["k5"] != 1
            or rec["grades"] != 2 * 33 or summary["batch"] != 4):
        raise AssertionError(f"train_at_scale: {rec['forwards']} forwards "
                             f"(expected {want_forwards}), {len(vals)} "
                             f"validation steps, {rec['grades']} grades, "
                             f"{rec['k5']} K5")
    ms = ([s.elapsed_time(e) for s, e in steps] if device == "cuda"
          else [])
    numbers = {"device": _nvidia_smi() if device == "cuda" else "cpu",
               "wall_s": wall, "train_step_ms": ms,
               "median_step_ms_after_first": statistics.median(ms[1:])
               if len(ms) > 1 else None,
               "peak_gib": peak, "summary": summary}
    print(f"train_at_scale ({numbers['device']}): {json.dumps(numbers)}",
          flush=True)
    return rec["launches"], numbers, out, summary


def _detect_qa_phase(torch, np, scale_out, scale_summary,
                     device: str = "cuda"):
    """`tools/detect_qa` on `_scale_phase`'s checkpoint: one forward and
    one K5 check; the QA dict must equal the at-scale run's, whose QA ran on
    the same weights and draws.  Returns (launches, QA dict)."""
    from s4g_tpu_torch.tools import detect_qa
    scale_qa = scale_summary["detect_qa"]
    with _mujoco_standins(), _tool_launches("detect_qa") as rec:
        qa = detect_qa.main(["--out", scale_out, "--num-points",
                             str(scale_summary["num_points"]), "--device",
                             device])
    step = qa.pop("checkpoint_step")
    if qa != scale_qa or rec["forwards"] != 1 or rec["k5"] != 1:
        raise AssertionError(f"detect_qa (step {step}): {qa} against the "
                             f"at-scale run's {scale_qa}; {rec['forwards']} "
                             f"forwards")
    print(f"detect_qa: checkpoint step {step}, QA equal to the at-scale "
          f"run's: {json.dumps(qa)}", flush=True)
    return rec["launches"], qa


def _demo_phase(torch, np, device: str = "cuda"):
    """`tools/demo_full_system` (`DEMO_ARGV`): the factory on three boxes
    (graded once: K2f 6), one epoch at b = 2 on 10,240 points (centroids
    2048/512/128: K6 3, K2f 3, K4 1 a forward), the detect with K5; it must
    print DEMO COMPLETE.  Returns (launches, its result)."""
    from s4g_tpu_torch.tools import demo_full_system
    out = _output_dir("tool_demo")
    t0 = time.perf_counter()
    with _logged("demo_full_system") as log, _mujoco_standins(), \
            _tool_launches("demo_full_system") as rec:
        got = demo_full_system.main(["--out", out, *DEMO_ARGV, "--device",
                                     device])
        took = time.perf_counter() - t0
    with open(log) as f:
        done = "DEMO COMPLETE" in f.read()
    if not done or rec["grades"] != 3 or rec["forwards"] != got["steps"] + 1:
        raise AssertionError(f"demo_full_system: {got}, {rec['grades']} "
                             f"grades, {rec['forwards']} forwards")
    print(f"demo_full_system: {json.dumps(got)} in {took:.2f} s", flush=True)
    return rec["launches"], got


def _mesh_qa_phase(torch, np, device: str = "cuda"):
    """`tools/datagen_mesh_qa --procedural` (`MESH_QA_ARGV`): three
    generated meshes graded once each (K2f 6), the factory on four
    instances, two 640 x 480 views; it must print MESH DATAGEN QA COMPLETE.
    Returns (launches, per-view stats)."""
    from s4g_tpu_torch.tools import datagen_mesh_qa
    out = _output_dir("tool_mesh_qa")
    t0 = time.perf_counter()
    with _logged("datagen_mesh_qa") as log, _mujoco_standins(), \
            _tool_launches("datagen_mesh_qa") as rec:
        stats = datagen_mesh_qa.main(["--out", out, *MESH_QA_ARGV,
                                      "--device", device])
        took = time.perf_counter() - t0
    with open(log) as f:
        done = "MESH DATAGEN QA COMPLETE" in f.read()
    if not done or rec["grades"] != 3 or rec["forwards"]:
        raise AssertionError(f"datagen_mesh_qa: {rec['grades']} grades")
    short = [{k: v for k, v in st.items() if k != "keys"} for st in stats]
    print(f"datagen_mesh_qa: {json.dumps(short)} in {took:.2f} s",
          flush=True)
    return rec["launches"], short


def _parity_tool_phase(torch, np, scene, scale_out, device: str = "cuda"):
    """`tools/parity_at_speed`, all six modes: compare, selfnoise,
    sortnoise, ablate and time-parity on the tabletop pickle with the fixed
    random init, quality on qa:<the at-scale run> with its checkpoint (the
    QA scene's objects graded there).  Each mode's forwards are known: 2,
    2, 2, 4, 2 + REPS (each with K5), 2.  Returns (launches, the JSON
    records by mode)."""
    from s4g_tpu_torch.tools import parity_at_speed as pas
    runs = [("compare", ["--scene", scene], 2),
            ("selfnoise", ["--scene", scene], 2),
            ("sortnoise", ["--scene", scene], 2),
            ("ablate", ["--scene", scene], 1 + len(pas.ABLATIONS)),
            ("time-parity", ["--scene", scene], 2 + pas.REPS),
            ("quality", [os.path.join(scale_out, "train_out"), "--scene",
                         f"qa:{scale_out}"], 2)]
    total, records = {}, {}
    for mode, argv, forwards in runs:
        with _logged(f"parity_{mode}"), _mujoco_standins(), \
                _tool_launches(f"parity_at_speed {mode}") as rec:
            records[mode] = pas.main([mode, *argv, "--device", device])
        k5 = forwards if mode == "time-parity" else 0
        if rec["forwards"] != forwards or rec["k5"] != k5:
            raise AssertionError(f"parity_at_speed {mode}: "
                                 f"{rec['forwards']} forwards, {rec['k5']} "
                                 f"K5")
        total = _add(total, rec["launches"])
    return total, records


_FPS_CHILD = """
import json, sys
sys.path.insert(0, {root!r})
from s4g_tpu_torch import _build
from s4g_tpu_torch.tools import measure_fps_sharded
_build.reset_launches()
got = measure_fps_sharded.main(sys.argv[1:])
print("LAUNCHES " + json.dumps(_build.LAUNCHES))
print("RESULT " + json.dumps({{k: got[k] for k in ("device",
      "device_ms_per_exec")}}))
"""


def _fps_sharded_phase(device: str = "cuda"):
    """`tools/measure_fps_sharded` for each of FPS_SHARDED_RUNS in a process
    of its own (as the JAX tool is run): its warm-up and REPS traced calls
    launch K1 (G = 128) or K6 (G = 1) once each and nothing else.  Returns
    (launches by run, numbers by run)."""
    from s4g_tpu_torch.tools import measure_fps_sharded
    paths, numbers = {}, {}
    calls = 1 + measure_fps_sharded.REPS
    for n, m, g in FPS_SHARDED_RUNS:
        trace_dir = _output_dir(f"tool_fps_{g}")
        with _logged(f"measure_fps_sharded_g{g}") as log:
            out = subprocess.run(
                [sys.executable, "-c", _FPS_CHILD.format(root=ROOT), n, m, g,
                 "--trace-dir", trace_dir, "--device", device],
                capture_output=True, text=True, timeout=600, cwd=ROOT)
            print(out.stdout, end="", flush=True)
        if out.returncode:
            raise AssertionError(f"measure_fps_sharded {n} {m} {g}: rc "
                                 f"{out.returncode}: {out.stderr[-2000:]}")
        lines = {ln.split(" ", 1)[0]: json.loads(ln.split(" ", 1)[1])
                 for ln in out.stdout.splitlines()
                 if ln.startswith(("LAUNCHES ", "RESULT "))}
        launches = lines["LAUNCHES"]
        kernel = "fps_lane" if g == "128" else "fps_exact"
        want = {k: (calls if k == kernel else 0) for k in launches}
        if launches != want or not lines["RESULT"]["device_ms_per_exec"]:
            raise AssertionError(f"measure_fps_sharded G={g}: launches "
                                 f"{launches}, expected {want}; "
                                 f"{lines['RESULT']}")
        paths[f"measure_fps_sharded_g{g}"] = launches
        numbers[g] = {**lines["RESULT"], "log": log}
        print(f"measure_fps_sharded N={n} M={m} G={g}: "
              f"{lines['RESULT']['device_ms_per_exec']:.4f} ms/exec, "
              f"launches {launches}", flush=True)
    return paths, numbers


def _trace_diff_phase(torch, np, scene, device: str = "cuda"):
    """`tools/trace_forward --json` at b = 1 and b = 2 (each 1 + REPS
    deployed forwards, launches held), then `tools/trace_diff` over the two
    tables.  Returns (launches, trace_diff's lines)."""
    from s4g_tpu_torch.tools import trace_diff, trace_forward
    tables, total = [], {}
    for b in (1, 2):
        table = os.path.join(_tool_log_dir(), f"trace_b{b}.json")
        with _logged(f"trace_b{b}"), \
                _tool_launches(f"trace_forward b={b}") as rec:
            trace_forward.main(["--batch", str(b), "--scene", scene,
                                "--json", table, "--trace-dir",
                                _output_dir(f"tool_trace_b{b}"), "--top",
                                "10", "--device", device])
        if rec["forwards"] != 1 + trace_forward.REPS or set(
                rec["batches"]) != {b}:
            raise AssertionError(f"trace_forward b={b}: {rec['forwards']} "
                                 f"forwards")
        tables.append(table)
        total = _add(total, rec["launches"])
    lines = trace_diff.main(tables)
    if len(lines) < 3 or not lines[0].startswith("leaf ms/scene"):
        raise AssertionError(f"trace_diff: {lines}")
    return total, lines


def _r3_phase():
    """`tools/r3_summarize` over the tool log directory: every parity mode
    and both traces give a row."""
    from s4g_tpu_torch.tools import r3_summarize
    rows = r3_summarize.main([_tool_log_dir()])
    need = [f"parity_{m}" for m in ("compare", "selfnoise", "sortnoise",
                                    "ablate", "time-parity", "quality")]
    need += ["trace_b1", "trace_b2"]
    missing = [k for k in need if not rows.get(k)]
    if missing:
        raise AssertionError(f"r3_summarize: no row for {missing}")
    return rows


def _host_ops_phase(np):
    """The native host library (`runtime/host_ops`, built with g++ at first
    use) on this machine: native equal to its numpy paths on a 4,096-point
    subsample of the tabletop (voxel traces as sets with their means within
    f32 rounding, outlier masks and 1-NN exactly: the numpy outlier and
    1-NN paths are n x n, ~50 GB at 65,000 points), then native alone on
    the whole 65,000-point tabletop, host ms (median of 5); then
    `runtime/guard`'s probes: `backend_reachable()` and `kernels_build()`
    (K1 and K6 once each, in a child) must be true.  Returns the numbers."""
    from s4g_tpu_torch.runtime import guard
    from s4g_tpu_torch.runtime import host_ops as ho

    t0 = time.perf_counter()
    if not ho.native_available():
        raise AssertionError("host_ops: the native library did not build")
    build_ms = 1e3 * (time.perf_counter() - t0)
    cloud = tabletop_cloud(np.random.RandomState(0))
    rng = np.random.RandomState(1)
    sub = cloud[rng.choice(len(cloud), 4096, replace=False)]
    query = cloud[rng.choice(len(cloud), 4096, replace=False)]
    keep = ho.radius_outlier_mask(sub, 0.05, 8)
    nn = ho.nearest_neighbor_match(query, sub, 0.02)
    p, t = ho.voxel_downsample_trace(sub, 0.02)
    wp, wt = ho.numpy_voxel_downsample_trace(sub, 0.02, sub.min(0))
    o, wo = np.argsort(t), np.argsort(wt)
    mean_err = float(np.abs(p[o] - wp[wo]).max())
    same = {
        "outlier": bool(np.array_equal(
            keep, ho.numpy_radius_outlier_mask(sub, 0.05, 8))),
        "nn": all(bool(np.array_equal(a, b)) for a, b in zip(
            nn, ho.numpy_nearest_neighbor_match(query, sub, 0.02))),
        "voxel trace": bool(np.array_equal(t[o], wt[wo])),
        "voxel means": bool(mean_err <= 4 * np.finfo(np.float32).eps
                            * float(np.abs(wp).max()))}
    if not all(same.values()):
        raise AssertionError(f"host_ops native vs numpy: {same}")

    def host_ms(fn):
        times = []
        for _ in range(5):
            t1 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t1))
        return statistics.median(times)

    vox = ho.voxel_downsample_trace(cloud, 0.005)
    whole = {"voxel_downsample_trace (5 mm) host ms": host_ms(
                 lambda: ho.voxel_downsample_trace(cloud, 0.005)),
             "radius_outlier_mask (2 cm, 32) host ms": host_ms(
                 lambda: ho.radius_outlier_mask(cloud, 0.02, 32)),
             "nearest_neighbor_match (to the voxels, 5 mm) host ms": host_ms(
                 lambda: ho.nearest_neighbor_match(cloud, vox[0], 0.005)),
             "voxels": len(vox[0]),
             "kept": int(ho.radius_outlier_mask(cloud, 0.02, 32).sum())}
    t1 = time.perf_counter()
    reachable, line = guard.backend_reachable()
    probe_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    built = guard.kernels_build()
    build_probe_s = time.perf_counter() - t1
    if not (reachable and built):
        raise AssertionError(f"guard: backend_reachable {reachable} "
                             f"({line}), kernels_build {built}")
    numbers = {"native_available": True, "library build ms (host)": build_ms,
               "native == numpy on 4,096 points": same,
               "voxel mean max |native - numpy|": mean_err,
               "whole tabletop, 65,000 points": whole,
               "backend_reachable": line, "backend_reachable s": probe_s,
               "kernels_build": built, "kernels_build s": build_probe_s}
    print(f"host_ops and guard: {json.dumps(numbers)}", flush=True)
    return numbers


# -- multi-device ------------------------------------------------------------------

MULTI_RANKS = 2
MULTI_BATCH = 4          # serving's and training's global batch (2 a rank)
MULTI_SERVING = {"tabletops": BATCHES[4], "mixed": MIXED[4]}
MULTI_STEPS = 2
MULTI_REPS = 3           # timed detect_batch calls per rank
# The deployed (bf16) step's losses against one process's: bf16's
# tolerance (tests/test_torch_port_train_step.py's bf16 step against JAX).
# Its gradients are compared and printed, not gated: train-mode
# BatchNorm's E[x^2] - E[x]^2 turns the rounding of sums taken in another
# order into gradients 2-3e-2 of a tensor's largest apart in f32 (ROADMAP
# F1), bf16 roundings further; the float64 step holds the function.
MULTI_LOSS_RTOL = 2e-2


def _multi_setup(torch):
    """A child process of the multi-device phase: full-f32 matmuls and the
    kernel library the parent built."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from s4g_tpu_torch import _build
    _build.load_library()


@contextlib.contextmanager
def _draws(record=None, replay=None):
    """Within: the detector's sample indices and importance uniforms are
    appended to `record` ({"samples": [], "uniforms": []}) as it draws
    them, or handed to it from `replay` (the samples in order, the
    uniforms as they are) instead of drawn."""
    from s4g_tpu_torch.pipeline import detector as tdet
    from s4g_tpu_torch.pipeline import preprocessing as tpre
    sample, uniforms = tpre.random_sample_fixed, tdet._uniforms
    if record is not None:
        def new_sample(*a, **k):
            record["samples"].append(sample(*a, **k))
            return record["samples"][-1]

        def new_uniforms(*a, **k):
            record["uniforms"].append(uniforms(*a, **k))
            return record["uniforms"][-1]
    else:
        queue = list(replay["samples"])

        def new_sample(*a, **k):
            return queue.pop(0)

        def new_uniforms(*a, **k):
            return replay["uniforms"]
    tpre.random_sample_fixed, tdet._uniforms = new_sample, new_uniforms
    try:
        yield
    finally:
        tpre.random_sample_fixed, tdet._uniforms = sample, uniforms


def _same_results(a, b) -> bool:
    return len(a) == len(b) and all(
        _np_equal(pa, pb) and _np_equal(sa, sb)
        for (pa, sa), (pb, sb) in zip(a, b))


def _np_equal(x, y) -> bool:
    import numpy as np
    return x.shape == y.shape and bool(np.array_equal(x, y))


def _multi_serving(mesh, rank, torch, np):
    """A rank's serving: the deployed detector with the mesh, a warm-up,
    then `MULTI_SERVING`'s batches (global B = 4: this rank's two scenes,
    K3 on two tabletops, the full-scan fallback where a clutter scene
    overflows SA1's windows), each counted exactly (`_counted` at the
    local b = 2) with its draws recorded, and each rank's scenes bit for
    bit a single process's detect_batch over them on those draws; then
    MULTI_REPS timed calls of the tabletop batch."""
    from s4g_tpu_torch import _build
    from s4g_tpu_torch.parallel import shard_rows
    from s4g_tpu_torch.pipeline.detector import GraspDetector

    scenes = _scenes(np)
    det = GraspDetector(model="curvature_model", seed=0, mesh=mesh,
                        output_dir=_output_dir(f"multi_rank{rank}"))
    alone = GraspDetector(model="curvature_model", seed=0,
                          output_dir=_output_dir(f"multi_alone{rank}"))

    def run(d, names):
        return d.detect_batch([scenes[x] for x in names],
                              score_threshold=0.0,
                              verticalness_threshold=-1e9)

    run(det, MULTI_SERVING["tabletops"])
    out = {}
    for key, names in MULTI_SERVING.items():
        rows = shard_rows(mesh, len(names))
        record = {"samples": [], "uniforms": []}
        _build.reset_launches()
        with _draws(record=record):
            results, want = _counted(det, lambda: run(det, names),
                                     rows.stop - rows.start)
        launches = dict(_build.LAUNCHES)
        if launches != want:
            raise AssertionError(f"rank {rank} {key}: launches {launches}, "
                                 f"expected {want}")
        with _draws(replay={"samples": record["samples"],
                            "uniforms": record["uniforms"][0][rows]}):
            single = run(alone, names[rows])
        if not _same_results(results[rows], single):
            raise AssertionError(
                f"rank {rank} {key}: its scenes differ from a single "
                "process's detect_batch over them on the same draws")
        _check_grasps(f"rank {rank} {key}", results)
        out[key] = {"results": results, "num_valid": det.last_num_valid,
                    "launches": launches, "timings": dict(det.timings)}
    times = []
    for _ in range(MULTI_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(det, MULTI_SERVING["tabletops"])
        times.append(time.perf_counter() - t0)
    out["scenes_per_s"] = (MULTI_BATCH // mesh.size()) / statistics.median(
        times)
    return out


# The float64 check's model: NARROW_TRAIN (every kernel route of the
# deployed train step) with the heads' dropout on.
NARROW_F64 = {**NARROW_TRAIN, "MODEL": {**NARROW_TRAIN["MODEL"], "PN2": {
    **NARROW_TRAIN["MODEL"]["PN2"], "DROPOUT_PROB": 0.5}}}


def _multi_batches(np):
    """MULTI_STEPS global batches of MULTI_BATCH at full width from the
    train phase's scene pickles (a new pass for each: the dataset
    reshuffles), and one at NARROW_F64's width, its float leaves but the
    cloud in float64."""
    from s4g_tpu_torch.configs.config import load_cfg_from_dict
    from s4g_tpu_torch.train.dataset import SceneGraspDataset

    def dataset(cfg):
        return SceneGraspDataset(
            root, num_points=cfg.MODEL.PN2.NUM_INPUT,
            score_classes=cfg.DATA.SCORE_CLASSES, batch_size=MULTI_BATCH,
            num_frame_points=TRAIN_FRAME_POINTS, t_classification=True,
            seed=cfg.RNG_SEED,
            num_removal_directions=cfg.DATA.NUM_REMOVAL_DIRECTIONS)

    root = _train_data(np)
    ds = dataset(_train_config(BATCH_SIZE=MULTI_BATCH))
    narrow = next(iter(dataset(load_cfg_from_dict(NARROW_F64))))
    narrow = {k: v.astype(np.float64)
              if v.dtype == np.float32 and k != "scene_points" else v
              for k, v in narrow.items()}
    return [next(iter(ds)) for _ in range(MULTI_STEPS)], narrow


def _f64_step(mesh, batch, name, torch):
    """One float64 step of NARROW_F64 (`_f64_net`; forward, losses and
    backward: the gradients summed over the ranks where there is a mesh):
    the losses (summed over the ranks), the gradients and the BatchNorm
    running statistics, on the host."""
    import torch.distributed as dist
    from s4g_tpu_torch.configs.config import load_cfg_from_dict
    from s4g_tpu_torch.train.trainer import Trainer
    tr = Trainer(load_cfg_from_dict(NARROW_F64), output_dir=_output_dir(name),
                 mesh=mesh, logger=_train_logger())
    tr.init_state()
    _f64_net(tr.net)
    total, losses, _, _ = tr.forward_loss(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    tr.backward(total)
    losses = {k: v.detach().clone() for k, v in losses.items()}
    if mesh is not None:
        for v in losses.values():
            dist.all_reduce(v, group=mesh.get_group())
    return {"losses": {k: float(v) for k, v in losses.items()},
            "grads": {n: p.grad.detach().cpu()
                      for n, p in tr.net.named_parameters()},
            "stats": {k: v.detach().cpu() for k, v in
                      tr.net.state_dict().items() if "running" in k}}


def _multi_steps(tr, batches, torch, keep_grads: bool):
    """`tr`'s train steps on the global batches, each timed (host clock
    between synchronizations) with its launches, scalars, a sha of the
    state_dict and the generator's state; the gradients and BatchNorm
    running statistics with `keep_grads`.  The gradient all-reduce is
    timed on its own where there is a mesh."""
    from s4g_tpu_torch import _build
    reduce_ms = []
    if tr.mesh is not None:
        inner = tr.all_reduce_grads

        def timed():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            inner()
            torch.cuda.synchronize()
            reduce_ms.append(1e3 * (time.perf_counter() - t0))
        tr.all_reduce_grads = timed
    steps = []
    for batch in batches:
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scalars = tr.train_step(batch)
        torch.cuda.synchronize()
        step = {"ms": 1e3 * (time.perf_counter() - t0),
                "launches": dict(_build.LAUNCHES),
                "scalars": {k: float(v) for k, v in scalars.items()},
                "sha": _state_sha(tr.net.state_dict()),
                "generator": tr.generator.get_state().cpu()}
        if keep_grads:
            step["grads"] = {n: p.grad.detach().cpu()
                             for n, p in tr.net.named_parameters()}
            step["state"] = {k: v.detach().cpu() for k, v in
                             tr.net.state_dict().items()}
            step["stats"] = {k: v for k, v in step["state"].items()
                             if "running" in k}
        steps.append(step)
    return steps, reduce_ms


def _multi_rank(rank, world, init, workdir):
    """One of the gloo ranks that share cuda:0: serving, then training at
    the train phase's configuration; its results into workdir."""
    import numpy as np
    import torch
    import torch.distributed as dist
    _multi_setup(torch)
    from s4g_tpu_torch.parallel import make_mesh
    from s4g_tpu_torch.train.trainer import Trainer
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh(["cuda:0"] * world)
        torch.cuda.reset_peak_memory_stats()
        out = {"backend": dist.get_backend(),
               "serving": _multi_serving(mesh, rank, torch, np)}
        tr = Trainer(_train_config(BATCH_SIZE=MULTI_BATCH),
                     output_dir=_output_dir(f"multi_train{rank}"), mesh=mesh,
                     logger=_train_logger())
        tr.init_state()
        batches, narrow = torch.load(os.path.join(workdir, "batches.pt"),
                                     weights_only=False)
        out["steps"], out["reduce_ms"] = _multi_steps(tr, batches, torch,
                                                      rank == 0)
        torch.cuda.synchronize()
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        del tr
        out["f64"] = _f64_step(mesh, narrow, f"multi_f64_{rank}", torch)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _nccl_world_of_one(workdir, port):
    """A launched world of one (torchrun's variables set here) whose mesh
    takes NCCL: two train steps and a detect_batch at b = 2 with the mesh
    and without, in the default mode (the gathers' backward is K8, in a
    fixed order); results into workdir."""
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    import numpy as np
    import torch
    import torch.distributed as dist
    _multi_setup(torch)
    from s4g_tpu_torch.parallel import make_mesh
    from s4g_tpu_torch.pipeline.detector import GraspDetector
    from s4g_tpu_torch.train.trainer import Trainer
    mesh = make_mesh()
    try:
        batches, _ = torch.load(os.path.join(workdir, "batches.pt"),
                                weights_only=False)
        scenes = _scenes(np)
        out = {"backend": dist.get_backend(), "world": dist.get_world_size()}
        for name, m in (("mesh", mesh), ("plain", None)):
            tr = Trainer(_train_config(BATCH_SIZE=MULTI_BATCH),
                         output_dir=_output_dir(f"nccl_{name}"), mesh=m,
                         logger=_train_logger())
            tr.init_state()
            steps, _ = _multi_steps(tr, batches, torch, True)
            det = GraspDetector(model="curvature_model", seed=0, mesh=m,
                                output_dir=_output_dir(f"nccl_det_{name}"))
            out[name] = {"steps": steps, "serving": det.detect_batch(
                [scenes[x] for x in BATCHES[2]], score_threshold=0.0,
                verticalness_threshold=-1e9)}
        torch.save(out, os.path.join(workdir, "nccl.pt"))
    finally:
        dist.destroy_process_group()


def _multi_diff(got, want):
    """(scenes whose grasps differ, max |score diff|, max |pose diff|) over
    the scenes whose grasp counts agree."""
    import numpy as np
    differ, ds, dp = 0, 0.0, 0.0
    for (pg, sg), (pw, sw) in zip(got, want):
        if not _np_equal(pg, pw) or not _np_equal(sg, sw):
            differ += 1
        if pg.shape == pw.shape and len(pg):
            ds = max(ds, float(np.abs(sg - sw).max()))
            dp = max(dp, float(np.abs(pg - pw).max()))
    return differ, ds, dp


def _multi_device_phase(torch, np):
    """Data parallelism on one card (`s4g_tpu_torch.parallel`).

    (a) Two gloo ranks share cuda:0 (NCCL refuses two ranks on one GPU),
    spawned, each launching the real kernels (`_multi_rank`): serving
    (`_multi_serving`: the deployed detector at full width, global B = 4,
    each rank's scenes bit for bit a single process's call over them on
    the same draws, launches exact at the local b = 2), then training at
    the train phase's configuration (PN2_CLS, bf16, full width, dropout
    0.5) for MULTI_STEPS steps at global b = 4 (`_multi_steps`).  Here,
    against one process: the gathered results against the unsharded
    B = 4 call (the differing scenes and the largest differences printed;
    the draws are the same, the forward runs at b = 2 against b = 4); each
    step's losses within MULTI_LOSS_RTOL of one process's (from rank 0's
    state after the step before), its gradients and BatchNorm statistics
    against one process's printed
    (`_compare_steps`' numbers, rank 0's gradients being summed over the
    ranks) beside one process's first step against itself (bit for bit:
    the gathers' backward is K8, in a fixed order); both ranks'
    states and generators equal after each step; each rank's launches per
    step equal to the single step's.  Then one float64 step of NARROW_F64
    (`_f64_step`: every kernel route of the deployed step, dropout on) on
    the ranks against one process: gradients within 1e-9 of each tensor's
    largest (plus 1e-10 of the model's), losses within 1e-6 (the heads
    return f32), BatchNorm statistics within 1e-9: the same function.

    (b) An NCCL world of one in a child (`_nccl_world_of_one`): a Trainer
    and a detect_batch with the mesh bit for bit the same calls without.

    The numbers printed (step ms, all-reduce ms, scenes/s, peak memory)
    come from two ranks sharing one card: they are no scaling result."""
    import shutil
    import socket
    import torch.multiprocessing as mp
    from s4g_tpu_torch import _build
    from s4g_tpu_torch.pipeline.detector import GraspDetector
    from s4g_tpu_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    torch.cuda.empty_cache()        # the ranks share the card with us
    workdir = os.path.join(_build.BUILD_DIR, "multi_device")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    batches, narrow = _multi_batches(np)
    torch.save((batches, narrow), os.path.join(workdir, "batches.pt"))

    mp.start_processes(_multi_rank, args=(MULTI_RANKS, os.path.join(
        workdir, "rendezvous"), workdir), nprocs=MULTI_RANKS,
        start_method="spawn")
    ranks = [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                        weights_only=False) for r in range(MULTI_RANKS)]
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    child = mp.get_context("spawn").Process(target=_nccl_world_of_one,
                                            args=(workdir, port))
    child.start()
    child.join(600)
    if child.is_alive():
        child.kill()
        child.join()
        raise AssertionError("the NCCL world of one did not end in 600 s")
    if child.exitcode != 0:
        raise AssertionError(f"the NCCL world of one exited "
                             f"{child.exitcode}")
    nccl = torch.load(os.path.join(workdir, "nccl.pt"), weights_only=False)

    bad = []
    # Serving: both ranks return the whole batch; against one process.
    unsharded = GraspDetector(model="curvature_model", seed=0,
                              output_dir=_output_dir("multi_unsharded"))
    scenes = _scenes(np)

    def run(names):
        return unsharded.detect_batch([scenes[x] for x in names],
                                      score_threshold=0.0,
                                      verticalness_threshold=-1e9)

    run(MULTI_SERVING["tabletops"])
    serving = {}
    for key, names in MULTI_SERVING.items():
        want = run(names)
        got = ranks[0]["serving"][key]
        if not _same_results(ranks[1]["serving"][key]["results"],
                             got["results"]):
            bad.append(f"serving {key}: the ranks returned other results")
        if got["num_valid"] != ranks[1]["serving"][key]["num_valid"]:
            bad.append(f"serving {key}: the ranks' num_valid differ")
        serving[key] = dict(zip(("differing_scenes", "max_score_diff",
                                 "max_pose_diff"),
                                _multi_diff(got["results"], want)))
        serving[key]["launches"] = [r["serving"][key]["launches"]
                                    for r in ranks]
        serving[key]["gather_ms"] = [r["serving"][key]["timings"]
                                     ["gather_ms"] for r in ranks]

    # Training: rank 0 against one process on the same batches, and one
    # process against itself (its first step again, from the same state),
    # which must be bit for bit: the gathers' backward is K8, in a fixed
    # order.
    def single_steps(steps):
        """One process's steps, each after the first from rank 0's
        parameters and buffers after the step before (one Adam step turns
        the sign of a near-zero gradient into a full +/- lr, so the two
        runs' parameters part; the generators do not)."""
        single = Trainer(_train_config(BATCH_SIZE=MULTI_BATCH),
                         output_dir=_output_dir("multi_single"),
                         logger=_train_logger())
        single.init_state()
        out = []
        for i, batch in enumerate(steps):
            if i:
                single.net.load_state_dict(ranks[0]["steps"][i - 1]["state"])
            out += _multi_steps(single, [batch], torch, True)[0]
        return out, _k8_per_step(single.net)

    want_steps, k8 = single_steps(batches)
    again = single_steps(batches[:1])[0][0]
    if not all(torch.equal(again["grads"][n], g) for n, g in
               want_steps[0]["grads"].items()) or again["sha"] != \
            want_steps[0]["sha"]:
        bad.append("one process's step 0 run twice from one state: the "
                   "gradients or the state after it differ")
    train = []
    for i, want in enumerate(want_steps):
        got = ranks[0]["steps"][i]
        res, _ = _compare_steps(f"step {i}", want, got)
        if i == 0:
            err, _, cos = _grad_spread(again["grads"], want["grads"])
            res["single_vs_single"] = {"max_grad_err": err, "min_cos": cos}
        loss_rel = max(abs(got["scalars"][k] - v) / max(abs(v), 1e-30)
                       for k, v in want["scalars"].items()
                       if k.endswith("loss"))
        if not loss_rel <= MULTI_LOSS_RTOL:
            bad.append(f"step {i}: a loss {loss_rel:.3g} from one "
                       "process's (relative)")
        for r, rank in enumerate(ranks[1:], 1):
            other = rank["steps"][i]
            if other["sha"] != got["sha"] or not torch.equal(
                    other["generator"], got["generator"]):
                bad.append(f"step {i}: rank {r}'s state or generator is not "
                           "rank 0's")
        if want["launches"]["gather_backward"] != k8:
            bad.append(f"step {i}: K8 launched "
                       f"{want['launches']['gather_backward']} times, "
                       f"expected {k8}")
        for r, rank in enumerate(ranks):
            if rank["steps"][i]["launches"] != want["launches"]:
                bad.append(f"step {i}: rank {r} launched "
                           f"{rank['steps'][i]['launches']}, one process "
                           f"{want['launches']}")
        train.append(res)

    # The float64 step: the same function, to rounding.
    want64 = _f64_step(None, narrow, "multi_f64_single", torch)
    got64 = ranks[0]["f64"]
    top = max(float(g.abs().max()) for g in want64["grads"].values())
    f64 = {"max_loss_rel": max(abs(got64["losses"][k] - v) / abs(v)
                               for k, v in want64["losses"].items()),
           "max_grad_err": max(float((got64["grads"][n] - g).abs().max())
                               / max(float(g.abs().max()), 1e-300)
                               for n, g in want64["grads"].items()),
           "max_stat_err": max(float((got64["stats"][k] - v).abs().max())
                               / float(v.abs().max())
                               for k, v in want64["stats"].items())}
    worse = [n for n, g in want64["grads"].items()
             if float((got64["grads"][n] - g).abs().max())
             > 1e-9 * float(g.abs().max()) + 1e-10 * top]
    if worse or f64["max_loss_rel"] > 1e-6 or f64["max_stat_err"] > 1e-9:
        bad.append(f"float64 step: {f64}, gradients past 1e-9 of their "
                   f"max: {worse}")

    # The NCCL world of one, bit for bit.
    plain, meshed = nccl["plain"], nccl["mesh"]
    nccl_same = {
        "serving": _same_results(meshed["serving"], plain["serving"]),
        "steps": all(
            a["sha"] == b["sha"] and a["scalars"] == b["scalars"]
            and torch.equal(a["generator"], b["generator"])
            and all(torch.equal(a["grads"][n], b["grads"][n])
                    for n in b["grads"])
            for a, b in zip(meshed["steps"], plain["steps"]))}
    if nccl["backend"] != "nccl" or not all(nccl_same.values()):
        bad.append(f"NCCL world of one: backend {nccl['backend']}, bit for "
                   f"bit with no mesh {nccl_same}")

    wall = time.perf_counter() - t0
    numbers = {
        "card": _nvidia_smi(), "ranks": MULTI_RANKS,
        "backend": [r["backend"] for r in ranks],
        "step_ms": [[s["ms"] for s in r["steps"]] for r in ranks],
        "single_step_ms": [s["ms"] for s in want_steps],
        "all_reduce_ms": [r["reduce_ms"] for r in ranks],
        "detect_batch_scenes_per_s": [r["serving"]["scenes_per_s"]
                                      for r in ranks],
        "peak_gib": [r["peak_gib"] for r in ranks],
        "serving_vs_unsharded": serving, "train_vs_single": train,
        "f64_train_vs_single": f64,
        "nccl_world_of_one": {"backend": nccl["backend"],
                              "world": nccl["world"], **nccl_same},
        "phase_s": wall}
    print(f"multi-device ({numbers['card']}; two ranks sharing one card "
          f"over gloo: correctness, not scaling): {json.dumps(numbers)}",
          flush=True)
    if bad:
        raise AssertionError("; ".join(bad))
    launches = {f"rank{r}": {"serving": {k: rank["serving"][k]["launches"]
                                         for k in MULTI_SERVING},
                             "train_steps": [s["launches"]
                                             for s in rank["steps"]]}
                for r, rank in enumerate(ranks)}
    return launches, numbers


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
        rep.append(_k8_phase(torch, np, extras))
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
    phase("train reference", lambda: _train_reference_phase(torch, np))
    ref_e = phase("edge reference", lambda: _edge_reference_phase(torch, np))
    print(f"edge reference: {ref_e}", flush=True)
    phase("PN2_LOCAL reference", lambda: _local_reference_phase(torch, np))
    ref_eval = phase("eval reference",
                     lambda: _eval_reference_phase(torch, np))
    phase("factory reference", lambda: _factory_reference_phase(torch, np))
    launches = phase("detect", lambda: _detect_phase(det, torch, np))
    batch = phase("detect_batch", lambda: _detect_batch_phase(det, torch, np))
    parity = phase("parity", lambda: _parity_phase(pdet, torch, np))
    sort_only = phase("sort-only", lambda: _sort_only_phase(sdet, torch, np))
    fused = phase("fused-chain", lambda: _fused_phase(det, torch, np))
    contact = phase("contact", lambda: _contact_phase(cdet, torch, np))
    settings = phase("settings", lambda: _settings_phase(det, torch, np))
    stream = phase("stream", lambda: _stream_phase(det, qdet, torch, np))
    train = phase("train", lambda: _train_phase(torch, np))
    edge = phase("edge", lambda: _edge_phase(torch, np, extras))
    local = phase("PN2_LOCAL", lambda: _local_phase(torch, np))
    baselines = phase("baselines", lambda: _baseline_phase(torch, np))
    factory = phase("factory", lambda: _factory_phase(torch, np,
                                                      extras=extras))
    scene = phase("tool scene", lambda: _tool_scene(np))
    proposal = phase("grasp_proposal_test",
                     lambda: _proposal_phase(det, torch, np, scene))
    mbatch = phase("measure_batch",
                   lambda: _measure_batch_phase(torch, np, scene))
    mstream = phase("measure_stream",
                    lambda: _measure_stream_phase(torch, np, scene))
    train_cli = phase("train CLI", lambda: _train_cli_phase(torch, np))
    phase("profile_stages", lambda: _profile_stages_phase(torch, np, scene))
    tfwd = phase("trace_forward", lambda: _trace_phase(torch, np, scene))
    import shutil
    shutil.rmtree(_tool_log_dir(), ignore_errors=True)
    os.makedirs(_tool_log_dir())
    scale = phase("train_at_scale", lambda: _scale_phase(torch, np))
    dqa = phase("detect_qa", lambda: _detect_qa_phase(
        torch, np, scale[2], scale[3]))
    demo = phase("demo_full_system", lambda: _demo_phase(torch, np))
    mesh_qa = phase("datagen_mesh_qa", lambda: _mesh_qa_phase(torch, np))
    parity_tool = phase("parity_at_speed", lambda: _parity_tool_phase(
        torch, np, scene, scale[2]))
    fps_sharded = phase("measure_fps_sharded", _fps_sharded_phase)
    tdiff = phase("trace_diff", lambda: _trace_diff_phase(torch, np, scene))
    phase("r3_summarize", _r3_phase)
    phase("host_ops and guard", lambda: _host_ops_phase(np))
    multi = phase("multi-device", lambda: _multi_device_phase(torch, np))
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
             **settings[0], "stream": stream[0], **train[0], **edge[0],
             **local[0], **baselines[0], "eval_frames": ref_eval[0],
             "factory": factory[0],
             "proposal_test": proposal[0], **mbatch[0],
             "measure_stream": mstream[0], "train_cli": train_cli[0],
             "trace_forward": tfwd[0], "train_at_scale": scale[0],
             "detect_qa": dqa[0], "demo_full_system": demo[0],
             "datagen_mesh_qa": mesh_qa[0], "parity_at_speed": parity_tool[0],
             **fps_sharded[0], "trace_diff": tdiff[0]}
    extras.setdefault("mlp_chain", {})["pack_cache"] = fused[2]
    print(json.dumps({"multi_device_launches": multi[0]}))
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": sum(p[name] for p in paths.values()),
         "launches_by_path": {k: p[name] for k, p in paths.items()},
         "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bound,
         "bound_by": by, "library_ms": None, **extras.get(name, {}),
         "tool_calls_held": len(TOOL_SHAPES_HELD.get(name, [])),
         "status": "ok"}
        for name, src, tpu, err, ms, plain, bound, by in report]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
