"""Quantify the deployment-config divergence at pose level ("parity at
speed"; port of tools/parity_at_speed.py).

The deployment configuration (curvature_model.yaml: bf16 backbone,
SORT_POINTS, FPS_SHARDS=128) diverges from the reference-parity numerics
(f32, unsorted, exact FPS) at neighbour-selection level.  This tool runs
BOTH configurations with the SAME weights on the SAME 25,600-point sample
of a scene and reports:

* per-point score field agreement (max |delta|, fraction > 0.05);
* top-50 grasp-point set overlap (the reference's selection pool,
  file_logger_cls.py:197-218);
* pose deltas over the matched top candidates (translation mm, rotation
  geodesic deg).

Usage:
    python -m s4g_tpu_torch.tools.parity_at_speed MODE [CKPT_DIR]
        --scene SCENE [--device cpu]

MODE is compare (parity vs deploy), selfnoise / sortnoise (the noise
floors, see `compare`), ablate (one deployment feature at a time), quality
(ground-truth grading of both configs' top 50; SCENE must be qa:DIR) or
time-parity (ms per scene of the parity detect).  SCENE is a scene pickle
holding a (3, n) "point_cloud", or qa:DIR, the held-out QA scene of the
train_at_scale run in DIR (its object cache graded there).  CKPT_DIR is a
directory of the port's checkpoints (`last_checkpoint`, e.g.
DIR/train_out); without it the weights are a fixed random init
(`tools.common.seeded_model`, seed 0).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from .common import (DEFAULT_CFG, add_device_arg, call_times, device_label,
                     seeded_model)


def _load_scene(path, rng, n=25600):
    """A scene pickle's cloud (3, n) sampled to n points by `rng`."""
    scene = np.load(path, allow_pickle=True)
    cloud = np.asarray(scene["point_cloud"]).astype(np.float32)  # (3, n)
    sel = rng.choice(cloud.shape[1], n, replace=cloud.shape[1] < n)
    return cloud[:, sel]


def _qa_scene_assets(out_dir, qa_seed=777):
    """Simulate + render the at-scale run's held-out QA composition
    (train_at_scale's specs_of(777)).  Returns (pose_dict, (clean, noisy,
    cam) first view)."""
    from .train_at_scale import (build_procedural_catalog, qa_scene,
                                 draw_specs)

    meshes, base_specs = build_procedural_catalog(out_dir)
    return qa_scene(meshes, draw_specs(base_specs, qa_seed), qa_seed)


def _load_qa_scene(out_dir, rng, n=25600, qa_seed=777):
    """In-distribution scene: the at-scale run's held-out QA composition,
    rendered and camera-framed, (3, n).

    A scene from outside the training distribution gives a checkpoint
    trained on the procedural catalog a noisy score field, so the top-50
    set is chaotic under ANY perturbation and the selfnoise floor
    saturates toward 0; on a scene from the training distribution the
    field is sharp and the floor meaningful."""
    from .train_at_scale import camera_frame
    _, (_, noisy, cam) = _qa_scene_assets(out_dir, qa_seed)
    cloud = camera_frame(noisy, cam).T                  # (3, n_view)
    sel = rng.choice(cloud.shape[1], n, replace=cloud.shape[1] < n)
    return cloud[:, sel]


def _device(device):
    """`device` resolved (None is CUDA; without a GPU that raises)."""
    from ..runtime.device import resolve_device
    return resolve_device(device, "parity_at_speed")


def _points(scene, rng, dev):
    """(1, 3, 25600) on `dev` from a scene pickle or qa:DIR."""
    cloud = (_load_qa_scene(scene[3:], rng) if scene.startswith("qa:")
             else _load_scene(scene, rng))
    return torch.from_numpy(np.ascontiguousarray(cloud[None])).to(dev)


# The released config every mode starts from (a module constant: the CPU
# tests point it at a tiny one).
CFG_FILE = DEFAULT_CFG


def _build(cfg_overrides):
    """(cfg, net): CFG_FILE with `cfg_overrides` ({"MODEL": ..., "PN2":
    ...}) and its model, untrained."""
    from ..configs.config import load_cfg_from_file
    from ..models import build_model
    cfg = load_cfg_from_file(CFG_FILE)
    pn2 = dataclasses.replace(cfg.MODEL.PN2, **cfg_overrides.get("PN2", {}))
    model = dataclasses.replace(cfg.MODEL, PN2=pn2,
                                **cfg_overrides.get("MODEL", {}))
    cfg = dataclasses.replace(cfg, MODEL=model)
    return cfg, build_model(cfg)


PARITY = {"MODEL": {"COMPUTE_DTYPE": "float32"},
          "PN2": {"SORT_POINTS": False, "FPS_SHARDS": 1}}
DEPLOY = {}   # the released YAML as-is

# Single-feature ablations: which deployment feature moves the functional
# overlap off the self-noise floor?  FPS_SHARDS only acts under
# SORT_POINTS (the sharded FPS consumes the sorted cloud), so the lane-FPS
# effect is isolated as `sort_shards` minus `sort`.
ABLATIONS = {
    "bf16": {"MODEL": {"COMPUTE_DTYPE": "bfloat16"},
             "PN2": {"SORT_POINTS": False, "FPS_SHARDS": 1}},
    "sort": {"MODEL": {"COMPUTE_DTYPE": "float32"},
             "PN2": {"SORT_POINTS": True, "FPS_SHARDS": 1}},
    "sort_shards": {"MODEL": {"COMPUTE_DTYPE": "float32"},
                    "PN2": {"SORT_POINTS": True, "FPS_SHARDS": 128}},
}


def _variables(cfg, dev, ckpt_dir=None):
    """The weights every config runs with: the model state dict of the
    last checkpoint in `ckpt_dir`, else `seeded_model(cfg)`'s (seed 0)."""
    if ckpt_dir:
        from ..utils.checkpoint import Checkpointer, model_state_dict
        state = Checkpointer(ckpt_dir, map_location="cpu").load(
            None, resume=True)
        if state is None:
            raise SystemExit(f"no checkpoint under {ckpt_dir}")
        return model_state_dict(state)
    return seeded_model(cfg, dev).state_dict()


def _run_config(net, variables, pts):
    """One forward of `net` with `variables` on pts (1, 3, N), then the
    post-processing at threshold 0.3, verticality -1, 1,024 candidates."""
    from ..pipeline.postprocessing import post_process_predictions
    net.load_state_dict(variables)
    net = net.to(pts.device).eval()
    with torch.no_grad():
        preds = net({"scene_points": pts})
    post = post_process_predictions(
        pts[0], preds["score"][0], preds["frame_R"][0],
        preds["frame_t"][0], 0.3, -1.0, num_candidates=1024)
    return {
        "score": preds["score"][0].float().cpu().numpy(),     # (C, N)
        "poses": post.poses.cpu().numpy(),                    # (K, 4, 4)
        "scores": post.scores.cpu().numpy(),
        "valid": post.valid.cpu().numpy(),
        "cand_point": post.poses[:, :3, 3].cpu().numpy(),
    }


def compare(ckpt_dir=None, selfnoise=False, sortnoise=False, scene=None,
            device=None):
    """selfnoise: instead of parity-vs-deploy, run the PARITY config twice —
    once on the cloud as loaded, once with its points PERMUTED (outputs
    un-permuted for comparison).  Input point order is arbitrary in this
    pipeline (the detector random-samples the cloud), and the reference is
    NOT order-invariant (FPS starts at index 0, scan-order tie-breaks), so
    this measures the NOISE FLOOR of every overlap/delta metric below under
    the pipeline's own arbitrariness — exactly the arbitrariness
    SORT_POINTS re-rolls.  A deploy-config divergence at or below this
    floor is indistinguishable from reference-intrinsic behavior.

    sortnoise: like selfnoise but the permutation SORTS the points along
    their widest axis — the exact reordering SORT_POINTS applies — while
    keeping the PARITY numerics (no slab kernels, no sharded FPS): whether
    parity on a sorted input reproduces the deployed divergence."""
    dev = _device(device)
    pts = _points(scene, np.random.RandomState(0), dev)    # (1, 3, 25600)

    cfg_p, net_p = _build(PARITY)
    _, net_d = _build(DEPLOY)
    variables = _variables(cfg_p, dev, ckpt_dir)

    out = {}
    if selfnoise or sortnoise:
        if sortnoise:
            p_np = pts[0].cpu().numpy()                      # (3, N)
            axis = int(np.argmax(p_np.max(1) - p_np.min(1)))
            perm = np.argsort(p_np[axis])
        else:
            perm = np.random.RandomState(1).permutation(pts.shape[2])
        out["parity"] = _run_config(net_p, variables, pts)
        res = _run_config(net_p, variables,
                          pts[:, :, torch.from_numpy(perm).to(dev)])
        res["score"] = res["score"][:, np.argsort(perm)]  # back to cloud order
        out["deploy"] = res          # "deploy" slot holds the permuted run
    else:
        for name, net in (("parity", net_p), ("deploy", net_d)):
            out[name] = _run_config(net, variables, pts)

    rec = _divergence_metrics(out["parity"], out["deploy"])
    rec["mode"] = ("sortnoise (parity vs parity on axis-sorted points)"
                   if sortnoise else
                   "selfnoise (parity vs parity on permuted points)"
                   if selfnoise else "parity vs deploy")
    rec["weights"] = "checkpoint" if ckpt_dir else "fixed random init"
    rec["scene"] = scene
    rec["device"] = device_label(dev)
    print(json.dumps(rec), flush=True)
    return [rec]


def _divergence_metrics(a, b):
    """Score-field + top-50 grasp-set agreement between two _run_config
    outputs over the SAME points (a = reference side, b = variant)."""
    # Score field agreement (expectation over bins, the selection signal).
    def expect(score):
        p = np.exp(score - score.max(0)) / np.exp(score - score.max(0)).sum(0)
        return (p * np.arange(score.shape[0])[:, None]).sum(0)

    d_score = np.abs(expect(a["score"]) - expect(b["score"]))

    # Top-50 candidate POINT overlap: candidates are point-anchored; match
    # by translation proximity (points are identical in both runs).
    def top_positions(o, k=50):
        ordr = np.argsort(-np.where(o["valid"], o["scores"], -np.inf))[:k]
        return o["cand_point"][ordr], o["poses"][ordr]

    pp, pose_p = top_positions(a)
    pd, pose_d = top_positions(b)
    d2 = np.linalg.norm(pp[:, None] - pd[None], axis=-1)   # (50, 50) metres
    match = d2.min(1) < 1e-4                     # same anchor point selected
    overlap = float(match.mean())

    # Functional grasp-set overlap: a parity grasp counts as covered when
    # SOME deploy top-50 grasp is within 1 cm translation and 10 deg
    # rotation — operationally the same grasp, whatever its anchor index.
    t_all = np.linalg.norm(pose_p[:, None, :3, 3] - pose_d[None, :, :3, 3],
                           axis=-1)                          # (50, 50) m
    tr = np.einsum("nij,mij->nm", pose_p[:, :3, :3], pose_d[:, :3, :3])
    ang_all = np.degrees(np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0)))
    covered = ((t_all < 0.01) & (ang_all < 10.0)).any(1)
    overlap_fn = float(covered.mean())

    # Pose deltas over matched anchors.
    j = d2.argmin(1)
    t_err = np.linalg.norm(pose_p[match][:, :3, 3]
                           - pose_d[j[match]][:, :3, 3], axis=-1)
    rp, rd = pose_p[match][:, :3, :3], pose_d[j[match]][:, :3, :3]
    cosang = (np.einsum("nij,nij->n", rp, rd) - 1.0) / 2.0
    ang = np.degrees(np.arccos(np.clip(cosang, -1.0, 1.0)))

    return {
        "score_expectation_max_abs_delta": round(float(d_score.max()), 4),
        "score_expectation_frac_gt_0p05": round(float((d_score > 0.05).mean()), 4),
        "top50_anchor_overlap": overlap,
        "top50_grasp_overlap_1cm_10deg": overlap_fn,
        "matched_pose_t_delta_mm_max": round(float(t_err.max() * 1000), 3)
        if match.any() else None,
        "matched_pose_R_delta_deg_max": round(float(ang.max()), 3)
        if match.any() else None,
        "n_valid_parity": int(a["valid"].sum()),
        "n_valid_deploy": int(b["valid"].sum()),
    }


def quality(ckpt_dir=None, scene=None, top=50, device=None):
    """Ground-truth quality of each config's top-K grasps.

    Per-point score fields diverge by the permutation noise floor, but the
    winner-take-all top-50 race amplifies near-ties, so SET overlap
    under-states behavioral parity.  The operative question for a grasp
    system is whether the deployment config's winners are equally GOOD
    grasps — so grade both configs' top-K against the composed labeled
    scene (datagen ground truth, pipeline/eval_cloud.py::eval_frames:
    antipodal score, gripper collision, multi-object straddle; reference
    eval_point_cloud.py:64-113 semantics)."""
    import pickle

    from ..datagen.scene_compose import compose_scene
    from ..pipeline.eval_cloud import eval_frames
    from ..pipeline.postprocessing import REAL2TRAIN
    from ..utils.math_utils import batch_transformation_inv
    from .train_at_scale import camera_frame

    if not (scene or "").startswith("qa:"):
        raise SystemExit("quality mode needs the labeled QA scene "
                         "(--scene qa:DIR)")
    dev = _device(device)
    out_dir = scene[3:]
    pose_dict, (_, noisy, cam) = _qa_scene_assets(out_dir)

    # ground truth: composed labeled scene in WORLD frame
    object_data = {}
    for name in pose_dict:
        with open(os.path.join(out_dir, "single_object_data",
                               f"{name}.p"), "rb") as f:
            object_data[name] = pickle.load(f)
    sc = compose_scene(pose_dict, object_data)
    cloud_w = torch.from_numpy(np.asarray(sc["cloud"], np.float32)).to(dev)
    normals_w = torch.from_numpy(np.asarray(sc["normal"],
                                            np.float32)).to(dev)
    labels_w = torch.from_numpy(np.asarray(sc["label"], np.int32)).to(dev)

    # identical camera-frame input for both configs
    cl = camera_frame(noisy, cam).T
    sel = np.random.RandomState(0).choice(cl.shape[1], 25600,
                                          replace=cl.shape[1] < 25600)
    pts = torch.from_numpy(np.ascontiguousarray(cl[:, sel][None])).to(dev)

    rec = {"mode": f"top{top} ground-truth quality, parity vs deploy",
           "weights": "checkpoint" if ckpt_dir else "fixed random init",
           "scene": scene, "device": device_label(dev)}
    for tag, overrides in (("parity", PARITY), ("deploy", DEPLOY)):
        cfg, net = _build(overrides)
        res = _run_config(net, _variables(cfg, dev, ckpt_dir), pts)
        order = np.argsort(
            -np.where(res["valid"], res["scores"], -np.inf))[:top]
        # post_process_predictions returns TRAIN2REAL @ pose (poses in the
        # robot-camera convention).  Here the model input IS the render
        # camera = train frame, so undo that factor before lifting to world
        # — without this every grasp misses the cloud and grades as an
        # empty-close-region "multi object".
        poses_cam = np.einsum("ij,njk->nik",
                              REAL2TRAIN.astype(np.float32),
                              res["poses"][order])          # (top, 4, 4)
        poses_w = np.einsum("ij,njk->nik", cam.astype(np.float32),
                            poses_cam)
        g2l = batch_transformation_inv(torch.from_numpy(poses_w).to(dev))
        ev = eval_frames(g2l, cloud_w, normals_w, labels_w)
        anti = ev.antipodal_score.cpu().numpy()
        rec[tag] = {
            "num_scored": int(res["valid"].sum()),
            "collision_rate": round(float(
                ev.collision.float().mean()), 4),
            "multi_object_rate": round(float(
                ev.multi_objects.float().mean()), 4),
            "frac_good": round(float((anti > 0).mean()), 4),
            "antipodal_mean": round(float(anti.mean()), 4),
            "antipodal_mean_good": round(float(anti[anti > 0].mean()), 4)
            if (anti > 0).any() else None,
            "antipodal_max": round(float(anti.max()), 4),
        }
    print(json.dumps(rec), flush=True)
    return [rec]


def ablate(ckpt_dir=None, scene=None, device=None):
    """Single-feature attribution of the deploy-vs-parity divergence: run
    the parity config once, then each ABLATIONS variant against it with the
    same weights, one JSON line each."""
    dev = _device(device)
    pts = _points(scene, np.random.RandomState(0), dev)

    cfg_p, net_p = _build(PARITY)
    variables = _variables(cfg_p, dev, ckpt_dir)
    base = _run_config(net_p, variables, pts)

    records = []
    for name, overrides in ABLATIONS.items():
        _, net_v = _build(overrides)
        res = _run_config(net_v, variables, pts)
        rec = _divergence_metrics(base, res)
        rec["mode"] = f"parity vs ablation:{name}"
        rec["weights"] = "checkpoint" if ckpt_dir else "fixed random init"
        rec["scene"] = scene
        rec["device"] = device_label(dev)
        print(json.dumps(rec), flush=True)
        records.append(rec)
    return records


REPS = 10        # timed parity detects, after two warm-ups


def time_parity(scene=None, device=None):
    """ms per scene of the parity detect (forward, post-processing and the
    collision check) on a 25,600-point sample of the scene, with the fixed
    random init: CUDA events on the card (`tools.common.call_times`), the
    median of REPS."""
    from ..pipeline.collision import batch_view_non_collision
    from ..pipeline.postprocessing import post_process_predictions
    from ..utils.math_utils import batch_transformation_inv

    dev = _device(device)
    pts = _points(scene, np.random.RandomState(0), dev)[0]   # (3, N)
    cfg, _ = _build(PARITY)
    net = seeded_model(cfg, dev)
    cloud = pts.t().contiguous()

    def detect():
        with torch.no_grad():
            preds = net({"scene_points": pts[None]})
            post = post_process_predictions(
                pts, preds["score"][0], preds["frame_R"][0],
                preds["frame_t"][0], 0.3, -1.0, num_candidates=1024)
            ok = batch_view_non_collision(
                batch_transformation_inv(post.poses), cloud)
            return (post.poses.sum() + post.scores.sum()
                    + (post.valid & ok).sum())

    ms = float(np.median(call_times(detect, dev, REPS)))
    rec = {"config": "parity (f32, unsorted, exact FPS)",
           "e2e_ms_per_scene": round(ms, 2),
           "scenes_per_sec": round(1e3 / ms, 2),
           "device": device_label(dev)}
    print(json.dumps(rec), flush=True)
    return [rec]


MODES = ("compare", "selfnoise", "sortnoise", "ablate", "quality",
         "time-parity")


def main(argv=None) -> list:
    """Returns the records the mode printed (one JSON line each)."""
    p = argparse.ArgumentParser()
    p.add_argument("mode", choices=MODES)
    p.add_argument("ckpt_dir", nargs="?", default=None,
                   help="directory of the port's checkpoints "
                        "(last_checkpoint); default: a fixed random init")
    p.add_argument("--scene", required=True,
                   help="scene pickle with a (3, n) point_cloud, or qa:DIR "
                        "(the held-out QA scene of a train_at_scale run)")
    add_device_arg(p)
    args = p.parse_args(argv)

    device = args.device
    if args.mode in ("compare", "selfnoise", "sortnoise"):
        return compare(args.ckpt_dir, selfnoise=args.mode == "selfnoise",
                       sortnoise=args.mode == "sortnoise", scene=args.scene,
                       device=device)
    if args.mode == "ablate":
        return ablate(args.ckpt_dir, scene=args.scene, device=device)
    if args.mode == "quality":
        return quality(args.ckpt_dir, scene=args.scene, device=device)
    return time_parity(scene=args.scene, device=device)


if __name__ == "__main__":
    main()
