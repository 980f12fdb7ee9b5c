"""Mesh-asset datagen validation (port of tools/datagen_mesh_qa.py).

Runs the whole data factory (MuJoCo drop sim -> z-buffer render -> Darboux
grading -> label transfer -> movability -> merge) on mesh assets instead
of the primitive geoms the test suite uses, and prints label statistics so
the run is auditable: two instances of a real mesh (`--mesh PATH`, e.g. the
reference's `objects/mesh/camera.obj`), or with `--procedural` a
4-instance scene over three generated meshes (icosphere / box / cylinder).

The grading and the label transfer run on the card unless `--device cpu`
(the JAX tool forces its CPU backend).

Usage: python -m s4g_tpu_torch.tools.datagen_mesh_qa --procedural
           [--out OUT] [--views 2] [--device cpu]
       python -m s4g_tpu_torch.tools.datagen_mesh_qa --mesh camera.obj
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import tempfile
import time

import numpy as np

from .common import add_device_arg


def _scene_assets(args, out_dir):
    """Build (meshes, specs, shared-grade groups) for the requested mode.

    Default: two instances of the mesh at `--mesh`.  --procedural: a
    4-instance scene over THREE distinct generated watertight meshes
    (icosphere / box / cylinder): multi-mesh asset emission, per-mesh
    grading, and mixed-curvature Darboux labels."""
    from ..datagen.mesh_tools import load_obj, load_stl, save_stl
    from ..datagen.scene_sim import ObjectSpec

    if not args.procedural:
        verts, tris = load_obj(args.mesh)
        extent = verts.max(0) - verts.min(0)
        print(f"[mesh] {os.path.basename(args.mesh)}: {len(verts)} verts, "
              f"{len(tris)} tris, extent {np.round(extent, 3).tolist()} m",
              flush=True)
        # Two instances of the real mesh dropped on the table.  MuJoCo 3.x
        # loads OBJ assets directly; collision uses the convex hull.
        specs = [ObjectSpec(name=f"cam{i}", geom_type="mesh",
                            mesh_files=[args.mesh]) for i in range(2)]
        meshes = {f"cam{i}": (verts.astype(np.float64), tris)
                  for i in range(2)}
        return meshes, specs, {"cam0": ["cam0", "cam1"]}

    from ..datagen.mesh_tools import make_box, make_cylinder, make_icosphere
    gen = {"ico": make_icosphere(), "boxm": make_box(),
           "cyl": make_cylinder()}
    mesh_dir = os.path.join(out_dir, "meshes")
    os.makedirs(mesh_dir, exist_ok=True)
    paths = {}
    for name, (v, t) in gen.items():
        p = os.path.join(mesh_dir, f"{name}.stl")
        save_stl(p, v, t)
        _, rt = load_stl(p)          # round-trip through the real loader
        if len(rt) != len(t):
            raise RuntimeError(f"{name}: STL round-trip lost triangles")
        paths[name] = p
        print(f"[mesh] {name}: {len(v)} verts, {len(t)} tris", flush=True)
    names = ["ico", "boxm", "cyl", "boxm2"]   # two box instances
    base = {"boxm2": "boxm"}
    specs = [ObjectSpec(name=n, geom_type="mesh",
                        mesh_files=[paths[base.get(n, n)]]) for n in names]
    meshes = {n: (gen[base.get(n, n)][0].astype(np.float64),
                  gen[base.get(n, n)][1]) for n in names}
    return meshes, specs, {"ico": ["ico"], "boxm": ["boxm", "boxm2"],
                           "cyl": ["cyl"]}


def main(argv=None) -> list:
    """Returns the per-view stats."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                      "s4g_mesh_qa"))
    parser.add_argument("--views", type=int, default=2)
    mode = parser.add_mutually_exclusive_group(required=True)
    mode.add_argument("--procedural", action="store_true",
                      help="three generated meshes")
    mode.add_argument("--mesh", default=None,
                      help="OBJ mesh file: two instances")
    add_device_arg(parser)
    args = parser.parse_args(argv)

    from ..datagen.generate import generate_end_to_end, grade_object
    from ..datagen.stats import per_view_stats
    from ..runtime.device import resolve_device

    device = str(resolve_device(args.device, "datagen_mesh_qa"))
    meshes, specs, grade_groups = _scene_assets(args, args.out)

    # Instances sharing one mesh grade ONCE and seed the per-name cache
    # (generate_end_to_end skips existing pickles).
    obj_dir = os.path.join(args.out, "single_object_data")
    os.makedirs(obj_dir, exist_ok=True)
    for src, instances in grade_groups.items():
        if all(os.path.exists(os.path.join(obj_dir, f"{n}.p"))
               for n in instances):
            continue
        tic = time.time()
        v, t = meshes[src]
        data = grade_object(v, t, rng=np.random.RandomState(0),
                            device=device)
        print(f"[grade] {src}: {len(data['cloud'])} pts, "
              f"{time.time() - tic:.0f}s", flush=True)
        for n in instances:
            with open(os.path.join(obj_dir, f"{n}.p"), "wb") as f:
                pickle.dump(data, f)

    merged = generate_end_to_end(meshes, specs, args.out, scene_id=0,
                                 num_views=args.views, percentage=1.1,
                                 seed=0, label_capacity=16384,
                                 render_wh=(640, 480), device=device)
    if not merged:
        raise RuntimeError("no views produced")

    stats = []
    for path in merged:
        with open(path, "rb") as f:
            d = pickle.load(f)
        cloud = np.asarray(d["point_cloud"])
        if cloud.shape[0] == 3 and cloud.shape[-1] != 3:
            cloud = cloud.T
        stats.append({
            "view": os.path.basename(path),
            "num_points": int(cloud.shape[0]),
            **per_view_stats(d),
            "keys": sorted(d.keys()),
        })
    print("[merged] " + json.dumps(stats, indent=1), flush=True)
    if not any(s["num_labeled_grasp_points"] > 0 for s in stats):
        raise RuntimeError("no labeled grasp points on the mesh scene")
    print("MESH DATAGEN QA COMPLETE", flush=True)
    return stats


if __name__ == "__main__":
    main()
