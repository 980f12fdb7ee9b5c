"""Deployment-scale training run (port of tools/train_at_scale.py).

Trains PN2_CLS at the released curvature_model geometry (25,600 input
points, SA centroids 5120/1024/256, full channel widths, batch >= 4) on
synthetic scenes from the port's label factory (MuJoCo sim -> z-buffer
render -> Darboux grading -> label transfer -> merge), then runs a
validation pass, a detection QA on a held-out scene with the fitted weights,
and a steady-state step timing.  Records the summary as scale_run.json.

The config sets neither SORT_POINTS nor FPS_SHARDS, so the route is the
unsorted, exact-FPS one (K6 and K2f per SA stage, K4 per FP stage, K5 in
the QA), as in the JAX tool.

Under `torchrun --nproc_per_node=N` it trains data-parallel (one process
per GPU, `--batch` the global batch): rank 0 alone generates the data,
runs the QA and writes the outputs and the JSON; the validation pass and
the timed steps are sharded over the ranks, as the JAX tool's
`shard_batch`.

Usage:
    python -m s4g_tpu_torch.tools.train_at_scale --out OUT --scenes 8 \
        --steps 300 --batch 4 [--object-set mixed --real-mesh MESH.obj] \
        [--device cpu]
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import pickle
import statistics
import tempfile
import time

import numpy as np
import torch

from .common import add_device_arg, call_times, device_label

# The QA's preprocessing capacity and render size (module constants: the
# CPU tests lower them).  At 131,072 rows the matmul-form outlier test costs
# ~4x its cost at detect's 65,536.
QA_CAPACITY = 131072
QA_WH = (640, 480)
# Timed steps of the steady-state loop, after one warm-up step.
STEADY_REPS = 10


def box_mesh(hx, hy, hz):
    corners = np.array([[x, y, z] for x in (-hx, hx)
                        for y in (-hy, hy) for z in (-hz, hz)])
    tris = np.array([
        [0, 1, 2], [1, 3, 2], [4, 6, 5], [5, 6, 7],
        [0, 4, 1], [1, 4, 5], [2, 3, 6], [3, 7, 6],
        [0, 2, 4], [2, 6, 4], [1, 5, 3], [3, 5, 7]])
    return corners.astype(np.float64), tris


def build_procedural_catalog(out_dir):
    """The 11-class procedural inventory x 3 scale variants as mesh-geom
    ObjectSpecs (STLs written under out_dir/assets, loaded by MuJoCo; the
    name#k scale convention matches the reference's scale_objects.py).
    MuJoCo collides mesh geoms by convex hull, while render and grading use
    the true mesh."""
    from ..datagen.mesh_tools import (PROCEDURAL_CLASSES, save_stl,
                                      scale_variants)
    from ..datagen.scene_sim import ObjectSpec

    asset_dir = os.path.join(out_dir, "assets")
    os.makedirs(asset_dir, exist_ok=True)
    meshes, specs = {}, {}
    for cls, maker in sorted(PROCEDURAL_CLASSES.items()):
        verts, tris = maker()
        for k, v_scaled in scale_variants(verts).items():
            name = f"{cls}#{k}"
            path = os.path.join(asset_dir, f"{cls}_{k}.stl")
            if not os.path.exists(path):
                save_stl(path, v_scaled, tris)
            meshes[name] = (v_scaled, tris)
            specs[name] = ObjectSpec(name=name, geom_type="mesh",
                                     mesh_files=[path])
    return meshes, specs


def build_real_mesh_catalog(out_dir, mesh_path, frame_stride=8,
                            extra_cache_dirs=(), device=None):
    """A real mesh (an OBJ file, e.g. the reference's
    `objects/mesh/camera.obj`) at the same 3 scale variants as the
    procedural classes.

    Pre-grades each variant with a strided frame budget (every 8th surface
    point's frame, cloud density unchanged — see generate.grade_object) and
    seeds the factory's per-object cache under out_dir and each of
    `extra_cache_dirs`, so generate_scenes skips its full regrade.  MuJoCo
    collides the mesh by convex hull."""
    from ..datagen.generate import grade_object
    from ..datagen.mesh_tools import load_obj, save_stl, scale_variants
    from ..datagen.scene_sim import ObjectSpec

    asset_dir = os.path.join(out_dir, "assets")
    os.makedirs(asset_dir, exist_ok=True)
    verts, tris = load_obj(mesh_path)
    stem = os.path.splitext(os.path.basename(mesh_path))[0]
    meshes, specs = {}, {}
    for k, v_scaled in scale_variants(verts).items():
        name = f"{stem}#{k}"
        path = os.path.join(asset_dir, f"{stem}_{k}.stl")
        if not os.path.exists(path):
            save_stl(path, v_scaled, tris)
        meshes[name] = (v_scaled.astype(np.float64), tris)
        specs[name] = ObjectSpec(name=name, geom_type="mesh",
                                 mesh_files=[path])
        data = None                      # grade at most once per variant
        for cache_root in (out_dir, *extra_cache_dirs):
            obj_dir = os.path.join(cache_root, "single_object_data")
            os.makedirs(obj_dir, exist_ok=True)
            cache = os.path.join(obj_dir, f"{name}.p")
            if os.path.exists(cache):
                continue
            if data is None:
                tic = time.time()
                data = grade_object(meshes[name][0], tris,
                                    frame_stride=frame_stride,
                                    rng=np.random.RandomState(k),
                                    device=device)
                n_graded = int((np.asarray(
                    data["search_score"]).reshape(
                        len(data["cloud"]), -1) > 0).any(1).sum())
                print(f"[real-mesh] graded {name}: "
                      f"{len(data['cloud'])} cloud points, "
                      f"~{n_graded} frame-graded, in "
                      f"{time.time() - tic:.0f}s "
                      f"(frame_stride {frame_stride})", flush=True)
            tmp = f"{cache}.tmp.{os.getpid()}"
            with open(tmp, "wb") as f:
                pickle.dump(data, f)
            os.replace(tmp, cache)
    return meshes, specs


def draw_specs(base_specs, scene_id):
    """A scene's objects: 4-6 distinct catalog names drawn by
    RandomState(10_000 + scene_id) (the reference's per-scene object
    sampling, generate_simulation.py); the held-out QA scene is id 777."""
    names = sorted(base_specs)
    r = np.random.RandomState(10_000 + scene_id)
    k = int(r.randint(4, 7))
    picked = r.choice(len(names), size=k, replace=False)
    return [base_specs[names[i]] for i in picked]


def qa_scene(meshes, qa_specs, qa_seed=777, wh=None):
    """Simulate and render the held-out QA scene: (pose_dict, (clean,
    noisy, cam) of the first view, at `wh` (default QA_WH))."""
    from ..datagen.render import render_scene_views, table_mesh
    from ..datagen.scene_sim import TableEnv

    width, height = wh or QA_WH
    env = TableEnv(qa_specs, percentage=1.1, random_seed=qa_seed)
    pose_dict = env.run()
    views = render_scene_views({n: meshes[n] for n in pose_dict}, pose_dict,
                               table_mesh=table_mesh(),
                               rng=np.random.RandomState(0),
                               width=width, height=height)
    return pose_dict, views[0]


def camera_frame(noisy, cam):
    """A world-frame view cloud (n, 3) in the camera frame, f32: the frame
    of the training pickles (label transfer dumps camera-frame clouds)."""
    world2cam = np.linalg.inv(cam)
    return np.ascontiguousarray((world2cam[:3, :3] @ noisy.T
                                 + world2cam[:3, 3:4]).T, np.float32)


def detect_view(net, noisy, cam, num_points, capacity, num_candidates,
                dev):
    """One rendered view through the detector, as the QA and the demo run
    it: the world-frame cloud `noisy` moved to the camera frame of `cam`,
    preprocessed at `capacity` (sample indices from a generator seeded 0 on
    the device), one forward of `net`, post-processing (score threshold
    0.4, the verticality filter off) and the collision check.  Returns
    (post, valid (n,) bool where a grasp passes both, the valid grasps'
    world-frame poses (v, 4, 4))."""
    from ..pipeline.collision import batch_view_non_collision
    from ..pipeline.postprocessing import post_process_predictions
    from ..pipeline.preprocessing import preprocess_cloud
    from ..utils.math_utils import batch_transformation_inv

    # The training pickles hold CAMERA-frame clouds (label transfer dumps
    # to camera frame), so the input goes world -> camera, or BatchNorm
    # sees an out-of-distribution cloud and the scores collapse.
    noisy_cam = torch.from_numpy(camera_frame(noisy, cam)).to(dev)
    generator = torch.Generator(device=dev)
    generator.manual_seed(0)
    pre = preprocess_cloud(noisy_cam, num_points=num_points,
                           capacity=capacity, generator=generator)
    pts = pre.points.t().contiguous()
    with torch.no_grad():
        preds = net({"scene_points": pts[None]})
    # vertical_threshold=-1e9 truly disables the verticality filter: the
    # degree is computed on the RAW un-orthogonalized rotation column
    # (reference parity, grasp_detector.py:153-156), whose magnitude is
    # unbounded for lightly-trained models, so -1.0 can still reject.
    post = post_process_predictions(
        pts, preds["score"][0], preds["frame_R"][0], preds["frame_t"][0],
        score_threshold=0.4, vertical_threshold=-1e9,
        num_candidates=num_candidates, train2real=torch.eye(4, device=dev))
    g2l = batch_transformation_inv(post.poses)
    no_collision = batch_view_non_collision(g2l, noisy_cam)
    valid = (post.valid & no_collision).cpu().numpy()
    poses_w = np.einsum("ij,njk->nik", cam.astype(np.float32),
                        post.poses.cpu().numpy()[valid])
    return post, valid, poses_w


def run_detect_qa(weights, cfg, meshes, qa_specs, num_points, qa_seed=777,
                  device=None):
    """Held-out scene -> render -> preprocess -> detect -> sanity stats.

    `weights` is the model's state dict.  Mirrors the reference's eval loop
    semantics (grasp_detector.py:137-185 thresholding +
    view_collision_checker filtering) on one never-trained scene
    (`detect_view` at QA_CAPACITY, 512 candidates); returns the summary
    dict logged as [detect-qa]."""
    from ..models import build_model
    from ..runtime.device import resolve_device

    dev = resolve_device(device, "run_detect_qa")
    _, (_, noisy, cam) = qa_scene(meshes, qa_specs, qa_seed)
    net = build_model(cfg)
    net.load_state_dict(weights)
    net = net.to(dev).eval()
    post, valid, poses_w = detect_view(net, noisy, cam, num_points,
                                       QA_CAPACITY, 512, dev)
    score_valid = post.valid.cpu().numpy()
    heights = poses_w[:, 2, 3] if valid.sum() else np.zeros(0)
    return {
        "num_valid_grasps": int(valid.sum()),
        "num_score_valid": int(score_valid.sum()),
        "top_score": round(float(post.scores[0]), 4),
        "frac_heights_in_table_band": round(
            float(((heights > 0.74) & (heights < 0.92)).mean()), 4)
        if valid.sum() else None,
        # distribution, to tell an uncalibrated score head (spread
        # everywhere) from a frame bug (systematic offset) when the band
        # fraction is low
        "heights_min_med_max": [round(float(v), 3) for v in (
            heights.min(), np.median(heights), heights.max())]
        if valid.sum() else None,
        "num_points": num_points,
    }


def deploy_config(num_points, **sections):
    """The released curvature_model architecture at `num_points` input
    points, centroids N/5, N/25, N/100 (25,600 -> 5120/1024/256 exactly),
    plus `sections` (SOLVER, SCHEDULER, TRAIN)."""
    from ..configs.config import load_cfg_from_dict
    return load_cfg_from_dict({
        "MODEL": {"TYPE": "PN2_CLS", "PN2": {
            "NUM_INPUT": num_points,
            "NUM_CENTROIDS": (num_points // 5, num_points // 25,
                              num_points // 100),
            "RADIUS": (0.02, 0.08, 0.32),
            "NUM_NEIGHBOURS": (64, 64, 64),
            "SA_CHANNELS": ((128, 128, 256), (256, 256, 512),
                            (512, 512, 1024)),
            "FP_CHANNELS": ((1024, 1024), (512, 512), (256, 256, 256)),
            "NUM_FP_NEIGHBOURS": (3, 3, 3),
            "SEG_CHANNELS": (512, 256, 256, 128),
            "NEG_WEIGHT": 0.5,
        }},
        "DATA": {"SCORE_CLASSES": 3},
        **sections,
    })


def main(argv=None) -> dict:
    """Returns the summary (None with --datagen-only)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=os.path.join(
        tempfile.gettempdir(), "s4g_scale"))
    parser.add_argument("--scenes", type=int, default=8)
    parser.add_argument("--val-scenes", type=int, default=2,
                        help="extra held-out scenes for the val pass")
    parser.add_argument("--views", type=int, default=2)
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--num-points", type=int, default=25600)
    parser.add_argument("--skip-datagen", action="store_true")
    parser.add_argument("--datagen-only", action="store_true",
                        help="generate the scenes and exit")
    parser.add_argument("--workers", type=int, default=1,
                        help="parallel scene-generation processes (spawn "
                             "pool, each on the same device; workers > 1 "
                             "pre-grades shared objects, which re-rolls "
                             "scene 0's render-noise draws vs a cold "
                             "sequential run)")
    parser.add_argument("--object-set",
                        choices=("box", "procedural", "mixed"),
                        default="box",
                        help="'box': 4 box sizes. 'procedural': the 11-class "
                             "watertight inventory x 3 scale variants (33 "
                             "objects, mesh geoms) with 4-6 objects sampled "
                             "per scene. 'mixed': procedural + the real mesh "
                             "of --real-mesh at the same 3 scale variants, "
                             "one real variant forced into every other scene")
    parser.add_argument("--real-mesh", default=None,
                        help="OBJ file of the real mesh ('mixed' needs it)")
    add_device_arg(parser)
    args = parser.parse_args(argv)
    if args.object_set == "mixed" and not args.real_mesh:
        parser.error("--object-set mixed needs --real-mesh PATH")

    import torch.distributed as dist

    from ..datagen.generate import generate_scenes
    from ..datagen.scene_sim import ObjectSpec
    from ..parallel.mesh import launched_mesh
    from ..runtime.device import resolve_device
    from ..train.dataset import SceneGraspDataset
    from ..train.trainer import Trainer
    from ..utils.logger import MetricLogger

    dev = resolve_device(args.device, "train_at_scale")
    mesh = launched_mesh(dev)
    lead = mesh is None or mesh.get_local_rank() == 0

    def barrier():
        if mesh is not None:
            dist.barrier(group=mesh.get_group())

    device = str(dev)
    os.makedirs(args.out, exist_ok=True)
    if not lead:
        barrier()       # rank 0 writes the catalog's files and the data first
    if args.object_set == "box":
        sizes = [(0.030, 0.030, 0.030), (0.025, 0.025, 0.045),
                 (0.020, 0.035, 0.028), (0.033, 0.022, 0.040)]
        meshes = {f"obj{i}": box_mesh(*s) for i, s in enumerate(sizes)}
        base_specs = {f"obj{i}": ObjectSpec(name=f"obj{i}", geom_type="box",
                                            size=f"{s[0]} {s[1]} {s[2]}")
                      for i, s in enumerate(sizes)}
        specs_of = lambda sid: list(base_specs.values())  # noqa: E731
    else:
        meshes, base_specs = build_procedural_catalog(args.out)
        real_names = []
        if args.object_set == "mixed":
            real_meshes, real_specs = build_real_mesh_catalog(
                args.out, args.real_mesh,
                extra_cache_dirs=[os.path.join(args.out, "val")],
                device=device)
            meshes.update(real_meshes)
            base_specs.update(real_specs)
            real_names = sorted(real_meshes)

        def specs_of(sid):
            chosen = draw_specs(base_specs, sid)
            if real_names and sid % 2 == 0 and not any(
                    s.name in real_names for s in chosen):
                # guarantee real-mesh coverage: force one real variant
                # into every even scene, in place of the last draw
                chosen[-1] = base_specs[real_names[sid % len(real_names)]]
            return chosen

    data_dir = os.path.join(args.out, "merged_data")
    val_root = os.path.join(args.out, "val")
    val_dir = os.path.join(val_root, "merged_data")
    if not args.skip_datagen and lead:
        tic = time.time()
        common = dict(num_views=args.views, percentage=1.1,
                      label_capacity=16384, render_wh=(640, 480),
                      workers=args.workers, device=device)
        # Per-scene seeds: train seed = scene id; val seed = 9000 + id.
        train_lists = generate_scenes(
            meshes, [specs_of(s) for s in range(args.scenes)],
            args.out, base_seed=0, **common)
        for scene_id, merged in enumerate(train_lists):
            print(f"[datagen] scene {scene_id}: {len(merged)} views "
                  f"({time.time() - tic:.0f}s elapsed)", flush=True)
        val_lists = generate_scenes(
            meshes, [specs_of(5000 + s) for s in range(args.val_scenes)],
            val_root, base_seed=9000, **common)
        for scene_id, merged in enumerate(val_lists):
            print(f"[datagen] val scene {scene_id}: {len(merged)} views",
                  flush=True)
        total = sum(len(m) for m in train_lists + val_lists)
        print(f"[datagen] {total} views in {time.time() - tic:.0f}s",
              flush=True)
        from ..datagen.stats import dataset_statistics
        stats = dataset_statistics(data_dir)
        if args.object_set != "box":
            # which objects each scene drew
            stats["scene_objects"] = {
                str(s): [sp.name for sp in specs_of(s)]
                for s in range(args.scenes)}
        stats_path = os.path.join(args.out, "dataset_stats.json")
        with open(stats_path, "w") as f:
            json.dump(stats, f, indent=1)
        print(f"[datagen] stats -> {stats_path}: "
              + json.dumps(stats["summary"]), flush=True)
    if lead:
        barrier()
    if args.datagen_only:
        print("[datagen] done (--datagen-only), exiting before training",
              flush=True)
        return None

    ds = SceneGraspDataset(data_dir, num_points=args.num_points,
                           score_classes=3, batch_size=args.batch,
                           num_frame_points=512, seed=0, cache=True)
    steps_per_epoch = max(1, len(ds))
    epochs = max(1, (args.steps + steps_per_epoch - 1) // steps_per_epoch)
    # Centroid counts follow the input size, so a CPU rehearsal with a
    # smaller --num-points keeps the same N:M pyramid.
    cfg = deploy_config(
        args.num_points,
        SOLVER={"TYPE": "Adam", "BASE_LR": 0.001},
        SCHEDULER={"MAX_EPOCH": epochs, "TYPE": "StepLR",
                   "StepLR": {"step_size": 4000, "gamma": 0.5}},
        TRAIN={"BATCH_SIZE": args.batch, "LOG_PERIOD": 10,
               "CHECKPOINT_PERIOD": 10000, "VAL_PERIOD": 25,
               "AUGMENTATION": ("PointCloudRotate",)})
    print(f"[train] {len(ds)} batches/epoch x {epochs} epochs "
          f"(batch {args.batch}, {args.num_points} pts)", flush=True)

    val_ds = None
    if os.path.isdir(val_dir) and args.val_scenes > 0:
        val_ds = SceneGraspDataset(val_dir, num_points=args.num_points,
                                   score_classes=3, batch_size=args.batch,
                                   num_frame_points=512, seed=1, cache=True)

    trainer = Trainer(cfg, output_dir=os.path.join(args.out, "train_out"),
                      steps_per_epoch=steps_per_epoch, device=device,
                      mesh=mesh)
    t0 = time.time()
    state = trainer.fit(ds, val_data=val_ds)
    wall = time.time() - t0
    steps = int(state.step)
    print(f"[train] {steps} steps in {wall:.0f}s "
          f"({wall / max(1, steps):.3f} s/step incl. first launches + host)",
          flush=True)

    # Final val pass over the held-out scenes.
    val_metrics = None
    if val_ds is not None:
        vm = MetricLogger(delimiter="  ")
        for vb in val_ds:
            vm.update(**{k: float(v) for k, v in
                         trainer.val_step(vb).items()})
        val_metrics = {k: round(m.global_avg, 4)
                       for k, m in vm.meters.items()}
        print("[val] " + json.dumps(val_metrics), flush=True)

    # Detection QA with the fitted weights at full resolution, on a copy
    # taken BEFORE the steady-state loop below, which trains the model in
    # place.
    detect_qa = None
    if lead:
        fitted = copy.deepcopy(trainer.net.state_dict())
        detect_qa = run_detect_qa(fitted, cfg, meshes, specs_of(777),
                                  args.num_points, device=device)
        print("[detect-qa] " + json.dumps(detect_qa), flush=True)
    barrier()

    # Steady-state step time, measured apart from the fit's wall clock
    # (CUDA events on the card, the host clock on the CPU).  Runs LAST: it
    # trains the model.
    batch = next(iter(ds))
    last = {}

    def step():
        last["scalars"] = trainer.train_step(batch)

    step_ms = call_times(step, dev, STEADY_REPS, warmup=1)
    scalars = last["scalars"]

    summary = {
        "steps": steps,
        "steady_state_s_per_step": round(statistics.fmean(step_ms) / 1e3, 3),
        "final_scalars": {k: round(float(v), 4) for k, v in scalars.items()},
        "val_metrics": val_metrics,
        "detect_qa": detect_qa,
        "wall_s": round(wall, 1),
        "batch": args.batch,
        "num_points": args.num_points,
        "device": device_label(dev),
    }
    if lead:
        print("[summary] " + json.dumps(summary), flush=True)
        with open(os.path.join(args.out, "scale_run.json"), "w") as f:
            json.dump(summary, f, indent=1)
    return summary


if __name__ == "__main__":
    main()
