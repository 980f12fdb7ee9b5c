"""Random cluttered-scene generation with MuJoCo (modern bindings).

Re-design of TableEnv / TableArena (reference: mujoco/table_env.py:12-118,
mujoco/table_arena.py:13-115): a table with four temporary containment
walls, free-joint objects dropped from random stacked heights, stepped until
settled, walls removed, then a velocity-tolerance settle loop.  Instead of
the reference's mjcf-XML merge machinery, the arena is assembled as one XML
string for mujoco.MjModel.from_xml_string.

Objects may be mesh assets (STL files, like the reference's convex-decomposed
YCB meshes) or primitive geoms (used by the test-suite; no mesh assets ship
with either repo).

A numpy copy of s4g_tpu/datagen/scene_sim.py: the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

TABLE_FULL_SIZE = (0.76, 0.69, 0.55)
TABLE_THICKNESS = 0.4
TABLE_FRICTION = (5, 0.005, 0.0001)
WALL_HEIGHT = 5.0
SETTLE_TOLERANCE = 2e-3


@dataclass
class ObjectSpec:
    """One free body: either primitive (geom_type + size) or mesh files."""
    name: str
    geom_type: str = "box"                 # box | sphere | cylinder | mesh
    size: str = "0.03 0.03 0.03"
    mesh_files: List[str] = field(default_factory=list)
    density: float = 1000.0
    rgba: str = "0.5 0.5 0.8 1"


def _object_xml(spec: ObjectSpec, pos, quat) -> (str, str):
    """Returns (asset_xml, body_xml)."""
    assets, geoms = [], []
    # High-friction, stiff but non-penetrating contacts.  The reference's
    # raw solref/solimp values (table_arena.py:96-97) date from mujoco_py and
    # let geoms sink ~1.5 cm under mujoco 3.x, so the defaults are kept and
    # only the friction intent is preserved.
    contact = 'friction="10 0.01 0.0001"'
    if spec.geom_type == "mesh":
        for i, path in enumerate(spec.mesh_files):
            mesh_name = f"{spec.name}_mesh{i}"
            assets.append(f'<mesh file="{path}" name="{mesh_name}"/>')
            geoms.append(
                f'<geom type="mesh" mesh="{mesh_name}" density="{spec.density}"'
                f' rgba="{spec.rgba}" {contact}/>')
    else:
        geoms.append(
            f'<geom type="{spec.geom_type}" size="{spec.size}"'
            f' density="{spec.density}" rgba="{spec.rgba}" {contact}/>')
    body = (
        f'<body name="{spec.name}" pos="{pos[0]} {pos[1]} {pos[2]}" '
        f'quat="{quat[0]} {quat[1]} {quat[2]} {quat[3]}">'
        f'{"".join(geoms)}'
        f'<joint type="free" damping="0.001" name="{spec.name}_joint"/>'
        f'</body>')
    return "".join(assets), body


def build_arena_xml(objects: List[ObjectSpec], poses: List, quats: List,
                    walls: bool = True, timestep: float = 0.002,
                    meshdir: Optional[str] = None) -> str:
    """Table + walls + free objects as one MJCF string."""
    half = np.asarray(TABLE_FULL_SIZE) / 2
    table_top = TABLE_FULL_SIZE[2] + TABLE_THICKNESS / 2
    fric = " ".join(str(f) for f in TABLE_FRICTION)

    wall_xml = []
    if walls:
        # wall z in the TABLE body frame: table top sits at +thickness/2
        wall_z = TABLE_THICKNESS / 2 + WALL_HEIGHT / 2 - 0.5
        for num, (ix, iy) in enumerate([(1, 0), (0, 1), (-1, 0), (0, -1)]):
            pos = (ix * half[0], iy * half[1], wall_z)
            size = ((0.05, half[1], WALL_HEIGHT / 2) if ix != 0
                    else (half[0], 0.05, WALL_HEIGHT / 2))
            wall_xml.append(
                f'<geom name="wall_{num}" type="box" '
                f'pos="{pos[0]} {pos[1]} {pos[2]}" '
                f'size="{size[0]} {size[1]} {size[2]}" '
                f'rgba="0.9 0 0 0.2" contype="1" conaffinity="20"/>')

    assets, bodies = [], []
    for spec, pos, quat in zip(objects, poses, quats):
        a, b = _object_xml(spec, pos, quat)
        if a:
            assets.append(a)
        bodies.append(b)

    meshdir_attr = f' meshdir="{meshdir}"' if meshdir else ""
    # cone="elliptic": the reference's high-friction contacts (mu = 10,
    # table_arena.py:80) are unstable with mujoco 3.x's default pyramidal
    # cone at drop-impact speeds; elliptic keeps them well-posed.
    asset_xml = f"<asset>{''.join(assets)}</asset>" if assets else ""
    return f"""
<mujoco model="s4g_table_arena">
  <compiler angle="radian"{meshdir_attr}/>
  <option gravity="0 0 -9.8" timestep="{timestep}" cone="elliptic"/>
  {asset_xml}
  <worldbody>
    <geom name="floor" type="plane" size="3 3 0.1" pos="0 0 0"/>
    <body name="table" pos="0 0 {TABLE_FULL_SIZE[2]}">
      <geom name="table_geom" type="box"
            size="{half[0]} {half[1]} {TABLE_THICKNESS / 2}"
            pos="0 0 0" friction="{fric}"/>
      {"".join(wall_xml)}
    </body>
    {"".join(bodies)}
  </worldbody>
</mujoco>
"""


class TableEnv:
    """Drop a random subset of objects onto the table and settle."""

    def __init__(self, objects: List[ObjectSpec], percentage: float = 0.5,
                 random_seed: Optional[int] = None,
                 meshdir: Optional[str] = None):
        self.all_objects = objects
        self.percentage = percentage
        self.tolerance = SETTLE_TOLERANCE
        self.meshdir = meshdir
        self.rng = np.random.RandomState(random_seed)
        self.table_top_height = TABLE_FULL_SIZE[2] + TABLE_THICKNESS / 2
        self.table_half_size = np.asarray(TABLE_FULL_SIZE) / 2
        self.obj: List[ObjectSpec] = []
        self.xml: str = ""

    def _random_pose(self, height_percentage: float):
        area = self.table_half_size[:2] - 0.15
        xy = self.rng.uniform(-1, 1, 2) * area
        z = self.table_top_height + height_percentage * (WALL_HEIGHT - 0.5)
        quat = self.rng.uniform(-1, 1, 4)
        quat /= np.linalg.norm(quat)
        return np.append(xy, z), quat

    def run(self, settle_steps: int = 1000, post_wall_steps: int = 500
            ) -> Optional[Dict[str, np.ndarray]]:
        import mujoco

        chosen = [o for o in self.all_objects
                  if self.rng.rand() <= self.percentage]
        self.rng.shuffle(chosen)
        if not chosen:
            return {}
        self.obj = chosen
        poses, quats = [], []
        for i in range(len(chosen)):
            pos, quat = self._random_pose((i + 1) / len(chosen))
            poses.append(pos)
            quats.append(quat)

        self.xml = build_arena_xml(chosen, poses, quats, walls=True,
                                   meshdir=self.meshdir)
        try:
            model = mujoco.MjModel.from_xml_string(self.xml)
            data = mujoco.MjData(model)
            mujoco.mj_forward(model, data)
            for _ in range(settle_steps):
                mujoco.mj_step(model, data)

            # drop the containment walls (reference table_env.py:70-72)
            for num in range(4):
                gid = mujoco.mj_name2id(model, mujoco.mjtObj.mjOBJ_GEOM,
                                        f"wall_{num}")
                model.geom_pos[gid][2] = -10
            for _ in range(post_wall_steps):
                mujoco.mj_step(model, data)

            on_table = np.arange(len(chosen))
            mean_vel = 100.0
            for _ in range(400):  # bounded settle loop
                on_table, mean_vel = self._update_velocity(model, data,
                                                           on_table)
                if mean_vel <= self.tolerance or len(on_table) == 0:
                    break
                for _ in range(50):
                    mujoco.mj_step(model, data)
        except Exception:
            return None

        final_pos: Dict[str, np.ndarray] = {}
        for spec in chosen:
            bid = mujoco.mj_name2id(model, mujoco.mjtObj.mjOBJ_BODY,
                                    spec.name)
            pos = data.xpos[bid].astype(np.float32)
            if (pos[2] < self.table_top_height - 0.4
                    or abs(pos[0]) > self.table_half_size[0] + 0.4):
                continue
            quat = data.xquat[bid].astype(np.float32)
            final_pos[spec.name] = np.append(pos, quat)
        return final_pos

    def _update_velocity(self, model, data, on_table):
        if len(on_table) == 0:
            return on_table, 0.0
        qpos_z = data.qpos[on_table * 7 + 2]
        qpos_x = np.abs(data.qpos[on_table * 7])
        valid = ((qpos_z > self.table_top_height - 0.4)
                 & (qpos_x < self.table_half_size[0] + 0.4))
        new_on_table = on_table[valid]
        if len(new_on_table) == 0:
            return new_on_table, 0.0
        lin_idx = np.concatenate([new_on_table * 6, new_on_table * 6 + 1,
                                  new_on_table * 6 + 2])
        return new_on_table, float(np.max(np.abs(data.qvel[lin_idx])))


class SingleObjectTableEnv(TableEnv):
    """N copies of one object dropped onto the table
    (reference: table_env.py:121-180)."""

    def __init__(self, base_spec: ObjectSpec, num: int,
                 random_seed: Optional[int] = None,
                 meshdir: Optional[str] = None):
        import dataclasses
        objects = [dataclasses.replace(base_spec, name=f"{base_spec.name}_{i}")
                   for i in range(num)]
        super().__init__(objects, percentage=1.1, random_seed=random_seed,
                         meshdir=meshdir)


def generate_scenes(objects: List[ObjectSpec], out_dir: str, start: int,
                    end: int, percentage: float = 0.5,
                    meshdir: Optional[str] = None) -> List[int]:
    """Scene-range driver with resumable idempotence
    (reference: generate_simulation.py:14-53).  Saves npy pose dicts + the
    arena XML per scene; skips existing artifacts."""
    npy_dir = os.path.join(out_dir, "npy")
    xml_dir = os.path.join(out_dir, "xml")
    os.makedirs(npy_dir, exist_ok=True)
    os.makedirs(xml_dir, exist_ok=True)
    done = []
    for i in range(start, end):
        npy_path = os.path.join(npy_dir, f"{i}.npy")
        if os.path.exists(npy_path):
            done.append(i)
            continue
        env = TableEnv(objects, percentage=percentage, random_seed=i,
                       meshdir=meshdir)
        pose = env.run()
        if pose is None:
            continue
        np.save(npy_path, pose)  # dict payload, matches reference format
        with open(os.path.join(xml_dir, f"{i}.xml"), "w") as f:
            f.write(env.xml)
        done.append(i)
    return done
