"""The port's label factory (`s4g_tpu_torch.datagen`: grading, generate,
label transfer, render, scene composition, merge) against the JAX package
on the same numpy inputs, the port on the CPU.

Tolerances: integer outputs and masks exact, except cells with a point
within 4 f32 ulps of a box face (`near_cells`: the port writes its
transforms out in one fixed order, the JAX package's einsum fuses them);
antipodal scores within 1e-6; normals and frames within 1e-5, frames up to
the gripper's 180-degree turn about x and on points whose relative in-plane
eigenvalue gap exceeds GAP_MIN (the two packages' eigensolvers may give an
eigenvector either sign, and a flat patch has no minor axis).  Stages that
follow the normals and frames are fed the JAX package's own."""

import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from s4g_tpu.datagen import generate as jgen
from s4g_tpu.datagen import grading as jgrad
from s4g_tpu.datagen import label_transfer as jlt
from s4g_tpu.datagen import merge as jmerge
from s4g_tpu.datagen import mesh_tools as jmesh
from s4g_tpu.datagen import render as jrender
from s4g_tpu.datagen import scene_compose as jcomp

from s4g_tpu_torch.configs import gripper_config as G
from s4g_tpu_torch.datagen import generate as tgen
from s4g_tpu_torch.datagen import grading as tgrad
from s4g_tpu_torch.datagen import label_transfer as tlt
from s4g_tpu_torch.datagen import merge as tmerge
from s4g_tpu_torch.datagen import mesh_tools as tmesh
from s4g_tpu_torch.datagen import render as trender
from s4g_tpu_torch.datagen import scene_compose as tcomp

from test_datagen_grading import make_box_cloud

# Darboux frames are compared where the relative eigenvalue gap of the
# projected normal covariance (`grading.darboux_gaps`) exceeds this.
GAP_MIN = 1e-2
# Max |port - JAX| of normals and frames.
FRAME_TOL = 1e-5
ANTIPODAL_TOL = 1e-6
# Max |port - JAX| of search poses (local_search -> global).
POSE_TOL = 1e-6
TURN = np.array([1.0, -1.0, -1.0], np.float32)   # 180 degrees about x


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def j(x):
    return jnp.asarray(np.ascontiguousarray(x))


def frames_differ(got, want):
    """Per frame, max |got - want| with got or got turned 180 degrees about
    x, whichever is closer."""
    direct = np.abs(got - want).max(axis=(1, 2))
    turned = np.abs(got * TURN - want).max(axis=(1, 2))
    return np.minimum(direct, turned)


def near_cells(g2l, cloud, faces, ulps=4, scale=1.0):
    """(B,) bool: transforms g2l (B, 4, 4) that put some point of cloud
    (N, 3), in float64, within `ulps` f32 ulps (at |coordinate| `scale`)
    of a face {axis: values} that the masks test."""
    g2l = np.asarray(g2l, np.float64)
    homo = np.concatenate([np.asarray(cloud, np.float64).T,
                           np.ones((1, len(cloud)))])
    tol = ulps * np.finfo(np.float32).eps * scale
    near = np.zeros(len(g2l), bool)
    for b0 in range(0, len(g2l), 256):
        local = np.einsum("bij,jn->bin", g2l[b0:b0 + 256, :3], homo)
        hit = np.zeros(local.shape[::2], bool)
        for axis, values in faces.items():
            for v in values:
                hit |= np.abs(local[:, axis] - v) <= tol
        near[b0:b0 + 256] = hit.any(axis=1)
    return near


def grading_faces(bottom_length=jgrad.DATAGEN_BOTTOM_LENGTH):
    return {0: (G.FINGER_LENGTH, -bottom_length, 0.0),
            1: (G.HALF_BOTTOM_WIDTH, -G.HALF_BOTTOM_WIDTH,
                G.HALF_BOTTOM_SPACE, -G.HALF_BOTTOM_SPACE),
            2: tuple(s * G.HALF_HAND_THICKNESS + dz for s in (1, -1)
                     for dz in jgrad.DZ_SEARCH)}


def search_cell_transforms(points, frames):
    """(P * L*T, 4, 4) float64 world -> search-frame transforms of every
    grid cell of every (point, frame)."""
    grid = tgrad.search_grid_transforms().astype(np.float64)
    l2g = np.tile(np.eye(4), (len(points), 1, 1))
    zero = np.abs(frames).sum(axis=(1, 2)) == 0      # graded 0: any frame
    l2g[:, :3, :3] = np.where(zero[:, None, None], np.eye(3), frames)
    l2g[:, :3, 3] = points
    g2l = np.linalg.inv(l2g)
    return np.einsum("gij,pjk->pgik", grid, g2l).reshape(-1, 4, 4)


def assert_cells_equal(got, want, near, what):
    """got == want except in cells flagged near a face; says how many."""
    got, want = np.asarray(got), np.asarray(want)
    flat = got.reshape(len(near), -1) != want.reshape(len(near), -1)
    bad = flat.any(axis=1)
    assert not (bad & ~near).any(), (
        f"{what}: {int((bad & ~near).sum())} cells differ away from the "
        f"box faces ({int(near.sum())} cells lie within 4 ulp of one)")
    return int(bad.sum())


def ellipsoid_cloud(rng, n=1500, axes=(0.03, 0.045, 0.06)):
    """Points on an ellipsoid (distinct principal curvatures everywhere)
    and their outward normals."""
    u = rng.uniform(0, 2 * np.pi, n)
    v = np.arccos(rng.uniform(-1, 1, n))
    axes = np.asarray(axes)
    cloud = np.stack([axes[0] * np.sin(v) * np.cos(u),
                      axes[1] * np.sin(v) * np.sin(u),
                      axes[2] * np.cos(v)], axis=1)
    grad = cloud / axes ** 2
    normals = grad / np.linalg.norm(grad, axis=1, keepdims=True)
    return cloud.astype(np.float32), normals.astype(np.float32)


@pytest.fixture(scope="module")
def ellipsoid():
    return ellipsoid_cloud(np.random.RandomState(7))


# -- search grid, eigensolver ------------------------------------------------

def test_search_grid_transforms_are_exact():
    np.testing.assert_array_equal(tgrad.search_grid_transforms(),
                                  jgrad.search_grid_transforms())
    assert tgrad.THETA_SEARCH == jgrad.THETA_SEARCH
    assert tgrad.DZ_SEARCH == jgrad.DZ_SEARCH


def test_eigh3_matches_float64_eigh():
    """Eigenvalues ascending within 1e-6 of their scale, eigenvectors
    orthonormal and equal to numpy's float64 ones up to sign where the
    eigenvalues are apart."""
    rng = np.random.RandomState(0)
    a = rng.randn(2000, 3, 3)
    cov = np.einsum("nij,nkj->nik", a, a).astype(np.float32)
    cov[:100] = np.diag([1.0, 1.0, 2.0]).astype(np.float32)   # a tie
    vals, vecs = [x.numpy() for x in tgrad._eigh3(t(cov))]
    want_vals, want_vecs = np.linalg.eigh(cov.astype(np.float64))
    scale = np.abs(want_vals).max(axis=1, keepdims=True)
    assert (np.abs(vals - want_vals) <= 1e-6 * scale).all()
    assert (np.diff(vals, axis=1) >= 0).all()
    eye = np.einsum("nji,njk->nik", vecs, vecs)
    assert np.abs(eye - np.eye(3)).max() < 1e-5
    gaps = np.diff(want_vals, axis=1) / scale
    for col in range(3):
        apart = np.ones(len(cov), bool)
        if col > 0:
            apart &= gaps[:, col - 1] > 1e-3
        if col < 2:
            apart &= gaps[:, col] > 1e-3
        dot = np.abs(np.sum(vecs[:, :, col] * want_vecs[:, :, col], axis=1))
        assert (np.abs(dot[apart] - 1) < 1e-5).all()
    # the tie keeps the lower index: the doubled eigenvalue's vectors span
    # the x-y plane
    assert np.abs(vecs[:100, 2, :2]).max() < 1e-6


@pytest.mark.parametrize("skew", [None, "up", "down"])
def test_square_roots_are_correctly_rounded(monkeypatch, skew):
    """sqrt_rn is the correctly rounded f32 root (numpy's float64 root
    rounded to f32 is: 53 >= 2 * 24 + 2 bits), also next to f32 squares,
    and also when torch.sqrt returns the neighbour above or below (as a
    device's root may); _sqrt64 within an ulp of numpy's float64 root."""
    if skew:
        inf = float("inf") if skew == "up" else 0.0

        def off_by_one(v):
            right = np.sqrt(v.double().numpy()).astype(np.float32)
            return torch.nextafter(t(right), torch.full_like(v, inf))
        monkeypatch.setattr(torch, "sqrt", off_by_one)
    rng = np.random.RandomState(0)
    r = rng.uniform(1e-4, 2.0, 20000).astype(np.float32)
    sq = (r.astype(np.float64) ** 2).astype(np.float32)
    x = np.concatenate([rng.uniform(0, 4, 100000), rng.uniform(0, 1e-6, 1000),
                        sq, np.nextafter(sq, 0), np.nextafter(sq, 9), [0.0]]
                       ).astype(np.float32)
    want = np.sqrt(x.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(tgrad.sqrt_rn(t(x)).numpy(), want)
    x64 = rng.uniform(1.0, 1e20, 5000)
    got = tgrad._sqrt64(t(x64)).numpy()
    assert (np.abs(got - np.sqrt(x64)) <= np.spacing(np.sqrt(x64))).all()


# -- normals and Darboux frames ----------------------------------------------

def test_estimate_normals_match_jax(ellipsoid):
    cloud, _ = ellipsoid
    cam = np.array([0.3, 0.2, 1.0], np.float32)
    want = np.asarray(jgrad.estimate_normals(j(cloud), j(cam)))
    got = tgrad.estimate_normals(t(cloud), t(cam)).numpy()
    assert got.dtype == np.float32 and got.shape == cloud.shape
    to_cam = cam - cloud
    facing = np.abs(np.sum(got * to_cam, axis=1)) > 1e-3
    assert int((~facing).sum()) == 3          # near the silhouette
    np.testing.assert_array_equal(
        np.sum(got[facing] * to_cam[facing], axis=1) > 0,
        np.sum(want[facing] * to_cam[facing], axis=1) > 0)
    assert np.abs(got[facing] - want[facing]).max() <= FRAME_TOL


@pytest.mark.parametrize("shape", ["ellipsoid", "torus", "cylinder"])
def test_darboux_frames_match_jax_up_to_the_turn(shape, ellipsoid):
    """Frames within 1e-5 of JAX's up to the 180-degree turn about x on
    points whose eigenvalue gap exceeds GAP_MIN; the points excluded are
    counted."""
    if shape == "ellipsoid":
        cloud, normals = ellipsoid
    else:
        mesh = (tmesh.make_torus() if shape == "torus"
                else tmesh.make_cylinder())
        cloud = tgen.sample_mesh_surface(*mesh, 1500,
                                         np.random.RandomState(3))
        normals = np.asarray(jgrad.estimate_normals(
            j(cloud), j(cloud.mean(0))))
        normals = -normals
    want_f, want_i = [np.asarray(x) for x in jgrad.darboux_frames(
        j(cloud), j(normals))]
    got_f, got_i = [x.numpy() for x in tgrad.darboux_frames(t(cloud),
                                                            t(normals))]
    gap = tgrad.darboux_gaps(t(cloud), t(normals)).numpy()
    keep = gap > GAP_MIN
    # of 1,500: the cylinder's sides and the torus's outer rim curve one
    # way only (their minor eigenvalue meets the normal's zero)
    excluded = {"ellipsoid": 0, "torus": 104, "cylinder": 509}[shape]
    assert int((~keep).sum()) == excluded
    d_frames = frames_differ(got_f, want_f)
    d_inv = frames_differ(got_i, want_i)
    # the frames that equal JAX's only turned (the minor axis' sign)
    turned = np.abs(got_f - want_f).max(axis=(1, 2)) > FRAME_TOL
    turns = {"ellipsoid": 416, "torus": 515, "cylinder": 283}[shape]
    assert int((turned & keep).sum()) == turns
    assert d_frames[keep].max() <= FRAME_TOL, np.sort(d_frames[keep])[-5:]
    assert d_inv[keep].max() <= FRAME_TOL
    # zero frames (< 5 neighbours) agree everywhere
    np.testing.assert_array_equal(np.abs(got_f).sum((1, 2)) == 0,
                                  np.abs(want_f).sum((1, 2)) == 0)


def test_darboux_frames_on_a_box_count_flat_points():
    """A box's faces are flat and its edges creases: their frames are
    arbitrary in both packages (8 of its 720 differ from JAX's).  Points
    with a gap over GAP_MIN (its corners) still agree; the rest are
    counted."""
    cloud, normals = make_box_cloud(np.random.RandomState(11))
    want, _ = [np.asarray(x) for x in jgrad.darboux_frames(j(cloud),
                                                           j(normals))]
    got, _ = [x.numpy() for x in tgrad.darboux_frames(t(cloud), t(normals))]
    keep = tgrad.darboux_gaps(t(cloud), t(normals)).numpy() > GAP_MIN
    assert int((~keep).sum()) == 659             # of 720
    apart = frames_differ(got, want) > FRAME_TOL
    assert not apart[keep].any() and int(apart.sum()) == 8
    turned = np.abs(got - want).max(axis=(1, 2)) > FRAME_TOL
    assert int((turned & keep).sum()) == 21


def test_port_frames_are_the_same_bits_every_call(ellipsoid):
    cloud, normals = ellipsoid
    a = tgrad.darboux_frames(t(cloud), t(normals))[0]
    b = tgrad.darboux_frames(t(cloud.copy()), t(normals.copy()))[0]
    assert torch.equal(a, b)


# -- grade_frames ------------------------------------------------------------

@pytest.fixture(scope="module")
def graded_ellipsoid(ellipsoid):
    """JAX's normals and frames of the ellipsoid, and 64 graded points."""
    cloud, _ = ellipsoid
    normals = -np.asarray(jgrad.estimate_normals(j(cloud), j(cloud.mean(0))))
    frames, inv = [np.asarray(x) for x in jgrad.darboux_frames(
        j(cloud), j(normals))]
    sel = np.random.RandomState(5).choice(len(cloud), 64, replace=False)
    frames = frames.copy()
    frames[sel[-1]] = 0.0                       # a zero frame grades to 0
    homo = np.concatenate([cloud.T, np.ones((1, len(cloud)))]).astype(
        np.float32)
    return cloud, normals, frames, sel, homo


@pytest.mark.parametrize("chunk", [None, 5])
def test_grade_frames_matches_jax(graded_ellipsoid, chunk):
    cloud, normals, frames, sel, homo = graded_ellipsoid
    want_s, want_a = [np.asarray(x) for x in jgrad.grade_frames(
        j(cloud[sel]), j(normals.T), j(frames[sel]), j(homo), chunk=16)]
    got_s, got_a = [x.numpy() for x in tgrad.grade_frames(
        t(cloud[sel]), t(normals.T), t(frames[sel]), t(homo), chunk=chunk)]
    assert got_s.shape == (len(sel), 4, 12) and got_s.dtype == np.float32
    near = near_cells(search_cell_transforms(cloud[sel], frames[sel]),
                      cloud, grading_faces(), scale=0.2)
    assert_cells_equal(got_s, want_s, near, "search_score")
    ok = ~near.reshape(len(sel), -1)
    assert np.abs(got_a - want_a).reshape(len(sel), -1)[ok].max() \
        <= ANTIPODAL_TOL
    assert (got_s > 50).any() and (got_a > 0.3).any()
    assert (got_s[-1] == 0).all() and (got_a[-1] == 0).all()


def test_grade_frames_is_the_same_for_every_chunk(graded_ellipsoid):
    cloud, normals, frames, sel, homo = graded_ellipsoid
    args = (t(cloud[sel]), t(normals.T), t(frames[sel]), t(homo))
    whole = tgrad.grade_frames(*args)
    for chunk in (1, 7, 1000):
        for g, w in zip(tgrad.grade_frames(*args, chunk=chunk), whole):
            assert torch.equal(g, w)


# -- label transfer ----------------------------------------------------------

@pytest.fixture(scope="module")
def graded_box():
    """The JAX package's graded box (`test_label_transfer.py`'s fixture)."""
    rng = np.random.RandomState(2)
    cloud, normals = make_box_cloud(rng, n_per_face=200, half=0.03)
    frames, inv = jgrad.darboux_frames(j(cloud), j(normals))
    homo = np.concatenate([cloud.T, np.ones((1, len(cloud)))]).astype(
        np.float32)
    out = {"cloud": cloud, "normal": normals, "frame": np.asarray(frames),
           "inv_frame": np.asarray(inv)}
    for key, fr in (("", frames), ("inv_", inv)):
        s, a = jgrad.grade_frames(j(cloud), j(normals.T), fr, j(homo),
                                  chunk=64)
        out[key + "search_score"] = np.asarray(s)
        out[key + "antipodal_score"] = np.asarray(a)
    return out


@pytest.fixture(scope="module")
def box_scene(graded_box):
    pose = np.array([0.05, -0.02, jlt.TABLE_HEIGHT + 0.03, 1.0, 0, 0, 0])
    return jcomp.compose_scene({"box": pose}, {"box": graded_box},
                               name_to_index={"box": 0})


def noisy_view(scene, seed, scale=0.001):
    rng = np.random.RandomState(seed)
    clean = scene["cloud"].astype(np.float32)
    noise = clean * (1.0 + rng.randn(*clean.shape).astype(np.float32)
                     * scale)
    return clean, noise


def _trace_pair(points, capacity):
    want = [np.asarray(x) for x in jlt.processing_and_trace(
        j(points), capacity=capacity)]
    got = [x.numpy() for x in tlt.processing_and_trace(t(points),
                                                       capacity=capacity)]
    return got, want


@pytest.mark.parametrize("capacity", [4096, 256])
def test_processing_and_trace_matches_jax(box_scene, capacity):
    """Exact, also past capacity: 256 voxels of a cloud that has more (the
    JAX scatter drops the rest; the port sinks them)."""
    _, noise = noisy_view(box_scene, 1)
    got, want = _trace_pair(noise, capacity)
    for name, g, w in zip(("points", "index_in_ref", "valid"), got, want):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got[2].sum() > (100 if capacity > 256 else 50)


def test_processing_and_trace_bins_like_xla():
    """Points on voxel boundaries: XLA multiplies by the f32 reciprocal of
    the constant voxel size, and the port does too (a true division bins
    some of them in the neighbouring voxel)."""
    rng = np.random.RandomState(0)
    k = rng.randint(0, 60, (20000, 3)).astype(np.float64)
    base = np.array([-0.15, -0.15, jlt.TABLE_HEIGHT + 0.01])
    pts = (base + k * jlt.VOXEL_SIZE).astype(np.float32)
    pts = np.concatenate([pts, pts + rng.uniform(0, 1e-3, pts.shape)
                          .astype(np.float32)])
    got, want = _trace_pair(pts, 32768)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    tp = t(pts)
    origin = tp.amin(0)
    divided = torch.floor((tp - origin) / jlt.VOXEL_SIZE)
    inv = 1.0 / torch.tensor(jlt.VOXEL_SIZE, dtype=torch.float32)
    assert not torch.equal(divided, torch.floor((tp - origin) * inv))


def _match(scene, ref, cam, lib, to):
    keys = ("cloud", "normal", "frame", "inv_frame", "search_score",
            "inv_search_score", "antipodal_score", "inv_antipodal_score")
    return lib.match_to_scene(to(ref), to(cam),
                              *[to(np.asarray(scene[k], np.float32))
                                for k in keys])


def test_match_to_scene_matches_jax(box_scene):
    clean, noise = noisy_view(box_scene, 1)
    trace = jlt.processing_and_trace(j(noise), capacity=4096)
    keep = np.asarray(trace.valid)
    ref = clean[np.asarray(trace.index_in_ref)[keep]]
    ref = np.concatenate([ref, ref + 0.004, ref + 0.03])   # some unmatched
    cam = np.array([0.0, 0.0, 2.0], np.float32)
    want = [np.asarray(x) for x in _match(box_scene, ref, cam, jlt, j)]
    got = _match(box_scene, ref, cam, tlt, t)
    d = ((ref[:, None, :].astype(np.float64)
          - box_scene["cloud"][None]) ** 2).sum(-1)
    assert (got.index.numpy() == np.argmin(d, axis=1)).mean() > 0.99
    np.testing.assert_array_equal(got.matched.numpy(), want[4])
    assert 0 < want[4].mean() < 1
    for name, g, w in zip(("frames", "normals", "search", "antipodal"),
                          got[:4], want[:4]):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def test_match_blocks_do_not_change_the_result(box_scene, monkeypatch):
    clean, _ = noisy_view(box_scene, 1)
    cam = np.array([0.0, 0.0, 2.0], np.float32)
    whole = _match(box_scene, clean, cam, tlt, t)
    monkeypatch.setattr(tlt, "DIST_BLOCK", 7 * len(clean))
    for g, w in zip(_match(box_scene, clean, cam, tlt, t), whole):
        assert torch.equal(g, w)


def scene_faces():
    return {0: (G.FINGER_LENGTH, -jgrad.DATAGEN_BOTTOM_LENGTH, 0.0),
            1: (G.HALF_BOTTOM_WIDTH, -G.HALF_BOTTOM_WIDTH,
                G.HALF_BOTTOM_SPACE, -G.HALF_BOTTOM_SPACE),
            2: (G.HALF_HAND_THICKNESS, -G.HALF_HAND_THICKNESS)}


def _grade_scene(lib, to, view_points, frames, search, antipodal, scene,
                 **kw):
    homo = np.concatenate([scene["cloud"].T,
                           np.ones((1, len(scene["cloud"])))]).astype(
        np.float32)
    return lib.grade_against_scene(
        to(view_points), to(frames), to(search), to(antipodal), to(homo),
        to(np.asarray(scene["label"], np.int32)), **kw)


@pytest.mark.parametrize("chunk", [None, 3])
def test_grade_against_scene_matches_jax(box_scene, chunk):
    """Fed JAX's matches: validity, labels, close counts exact (bar cells
    near a box face), frames and scores equal."""
    clean, noise = noisy_view(box_scene, 4)
    trace = jlt.processing_and_trace(j(noise), capacity=4096)
    keep = np.asarray(trace.valid)
    view = np.asarray(trace.points)[keep]
    ref = clean[np.asarray(trace.index_in_ref)[keep]]
    m = _match(box_scene, ref, np.array([0, 0, 2.0], np.float32), jlt, j)
    cand = np.nonzero(np.asarray(jlt.magic_formula(
        m.search_score, m.antipodal_score, m.matched, j(view[:, 2]))))[0]
    cand = np.concatenate([cand[:40], [0]])
    frames = np.asarray(m.frames)[cand]
    args = (view[cand], frames, np.asarray(m.search_score)[cand],
            np.asarray(m.antipodal_score)[cand], box_scene)
    want = _grade_scene(jlt, j, *args, chunk=8)
    got = _grade_scene(tlt, t, *args, chunk=chunk)
    near = near_cells(search_cell_transforms(view[cand], frames),
                      box_scene["cloud"], scene_faces(), scale=1.0)
    # the table test: a gripper corner within 4 ulp of the table plane
    corner_z = np.einsum("clti,in->cltn",
                         np.asarray(want.frames, np.float64)[..., 2, :],
                         tlt._gripper_bound().astype(np.float64))
    plane = np.float32(tlt.TABLE_HEIGHT + tlt.TABLE_COLLISION_OFFSET)
    near |= (np.abs(corner_z - plane) <= 4 * np.finfo(np.float32).eps
             ).any(axis=-1).reshape(-1)
    for name in ("objects_label", "close_counts", "search_score"):
        assert_cells_equal(getattr(got, name).numpy(),
                           np.asarray(getattr(want, name)), near, name)
    assert near.sum() < len(near) // 4
    np.testing.assert_allclose(got.frames.numpy(), np.asarray(want.frames),
                               rtol=0, atol=POSE_TOL)
    assert np.abs(got.antipodal_score.numpy()
                  - np.asarray(want.antipodal_score)).max() <= ANTIPODAL_TOL
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.valid.any() and got.objects_label.dtype == torch.int32


def test_generate_view_labels_matches_jax(box_scene):
    """The whole precomputed per-view transfer (as test_label_transfer.py):
    valid_index and labels exact."""
    clean, noise = noisy_view(box_scene, 4)
    cam_pose = np.eye(4)
    cam_pose[:3, 3] = [0.0, 0.0, 2.0]
    want = jlt.generate_view_labels(noise, clean, cam_pose, box_scene,
                                    capacity=4096, chunk=8)
    got = tlt.generate_view_labels(noise, clean, cam_pose, box_scene,
                                   capacity=4096, device="cpu")
    assert set(got) == set(want)
    assert len(got["valid_index"]) > 0
    for key in ("valid_index", "objects_label", "search_score",
                "point_cloud", "view_normals"):
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_allclose(got["valid_frame"], want["valid_frame"],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["antipodal_score"],
                               want["antipodal_score"], rtol=0,
                               atol=ANTIPODAL_TOL)


def _inject_jax_frames(monkeypatch, module):
    """Make `module`'s estimate_normals / darboux_frames the JAX package's
    (their eigenvector signs are the solver's)."""
    def normals(points, cam, *a):
        return t(np.asarray(jgrad.estimate_normals(
            j(points.cpu().numpy()), j(cam.cpu().numpy()), *a))).to(
            points.device)

    def frames(points, nrm, *a):
        return tuple(t(np.asarray(x)).to(points.device)
                     for x in jgrad.darboux_frames(
                         j(points.cpu().numpy()), j(nrm.cpu().numpy()), *a))

    monkeypatch.setattr(module, "estimate_normals", normals)
    monkeypatch.setattr(module, "darboux_frames", frames)


def test_generate_view_labels_online_matches_jax(box_scene, monkeypatch):
    """The online variant on JAX's view-cloud frames: exact."""
    _, noise = noisy_view(box_scene, 6)
    cam_pose = np.eye(4)
    cam_pose[:3, 3] = [0.0, 0.0, 2.0]
    want = jlt.generate_view_labels_online(noise, cam_pose, box_scene,
                                           capacity=4096, chunk=8)
    _inject_jax_frames(monkeypatch, tlt)
    got = tlt.generate_view_labels_online(noise, cam_pose, box_scene,
                                          capacity=4096, device="cpu")
    assert len(got["valid_index"]) > 0
    for key in ("valid_index", "objects_label", "search_score"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_allclose(got["antipodal_score"],
                               want["antipodal_score"], rtol=0, atol=1e-5)


def test_online_labels_are_positive_counts(box_scene):
    """The port's own frames (no injection): close-region populations."""
    _, noise = noisy_view(box_scene, 6)
    cam_pose = np.eye(4)
    cam_pose[:3, 3] = [0.0, 0.0, 2.0]
    got = tlt.generate_view_labels_online(noise, cam_pose, box_scene,
                                          capacity=4096, device="cpu")
    g = len(got["valid_index"])
    assert g > 0 and got["valid_frame"].shape == (g, 4, 12, 4, 4)
    nz = got["search_score"][got["search_score"] > 0]
    assert nz.min() >= 10 and (nz == np.round(nz)).all()


# -- the whole slice ---------------------------------------------------------

def test_the_slice_grade_compose_render_label_merge(monkeypatch):
    """grade_object -> compose_scene -> render_scene_views ->
    generate_view_labels -> merge_scene on a fixed pose dict, both packages
    from the same seeds.  grade_object (the port fed JAX's normals and
    frames): clouds, normals and frames equal, scores equal bar cells near
    a box face.  The later stages take the JAX package's graded objects on
    both sides: every merged record equal (integers exact, floats within
    1e-6)."""
    meshes = {"ell": jmesh.make_ellipsoid(), "box": jmesh.make_box()}
    poses = {"ell": np.array([0.02, 0.05, jlt.TABLE_HEIGHT + 0.022,
                              1.0, 0, 0, 0]),
             "box": np.array([-0.05, -0.04, jlt.TABLE_HEIGHT + 0.04,
                              0.9239, 0, 0, 0.3827])}
    index = {"ell": 0, "box": 1}
    direction = {"obj_list": ["ell", "box"],
                 "move_distance": np.arange(10.0).reshape(2, 5) / 10}
    _inject_jax_frames(monkeypatch, tgen)
    stride = 4
    graded = {}
    for name, gen, kw in (("jax", jgen, {}), ("port", tgen,
                                              {"device": "cpu"})):
        rng = np.random.RandomState(0)
        graded[name] = {n: gen.grade_object(*meshes[n], rng=rng,
                                            frame_stride=stride, **kw)
                        for n in meshes}
    for n in meshes:
        want, got = graded["jax"][n], graded["port"][n]
        for key in ("cloud", "normal", "frame", "inv_frame"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        idx = np.arange(0, len(want["cloud"]), stride)
        for kind in ("", "inv_"):
            near = near_cells(search_cell_transforms(
                want["cloud"][idx], want[kind + "frame"][idx]),
                want["cloud"], grading_faces(), scale=0.2)
            assert_cells_equal(got[kind + "search_score"][idx],
                               want[kind + "search_score"][idx], near,
                               f"{n} {kind}search_score")
            far = ~near.reshape(len(idx), -1)
            diff = np.abs(got[kind + "antipodal_score"][idx]
                          - want[kind + "antipodal_score"][idx])
            assert diff.reshape(len(idx), -1)[far].max() <= ANTIPODAL_TOL
            rest = np.ones(len(want["cloud"]), bool)
            rest[idx] = False
            assert not got[kind + "search_score"][rest].any()

    out = {}
    for name, lt, comp, rend, mrg, kw in (
            ("jax", jlt, jcomp, jrender, jmerge, {}),
            ("port", tlt, tcomp, trender, tmerge, {"device": "cpu"})):
        rng = np.random.RandomState(1)
        scene = comp.compose_scene(poses, graded["jax"], name_to_index=index)
        views = rend.render_scene_views(
            meshes, poses, table_mesh=rend.table_mesh(), rng=rng,
            camera_poses=rend.CAMERA_POSE[:1], width=160, height=120)
        table = mrg.build_direction_table(direction, index, 2)
        out[name] = [mrg.merge_scene(lt.generate_view_labels(
            noisy, clean, cam, scene, capacity=2048, **kw), table, v)
            for v, (clean, noisy, cam) in enumerate(views)]
    for got, want in zip(out["port"], out["jax"]):
        assert set(got) == set(want)
        assert len(got["valid_index"]) > 0
        for key in want:
            if key in ("valid_frame", "antipodal_score"):
                np.testing.assert_allclose(got[key], want[key], rtol=0,
                                           atol=1e-6, err_msg=key)
            else:
                np.testing.assert_array_equal(got[key], want[key],
                                              err_msg=key)


# -- numpy copies ------------------------------------------------------------

def test_numpy_copies_agree(tmp_path):
    """render, scene_compose, mesh_tools, merge and dataset_config: the same
    functions of the same inputs."""
    from s4g_tpu.datagen import dataset_config as jcfg
    from s4g_tpu_torch.datagen import dataset_config as tcfg
    assert tcfg.NAME_LIST == jcfg.NAME_LIST
    labels = np.arange(0, len(tcfg.NAME_LIST), 7)
    np.testing.assert_array_equal(tcfg.label_to_color(labels),
                                  jcfg.label_to_color(labels))
    np.testing.assert_array_equal(
        tcfg.color_array_to_label(tcfg.label_to_color(labels)), labels)
    for name in ("make_box", "make_cylinder", "make_torus", "make_cone",
                 "make_capsule", "make_cup", "make_lshape", "make_ellipsoid",
                 "make_icosphere", "make_wedge", "make_pyramid"):
        for g, w in zip(getattr(tmesh, name)(), getattr(jmesh, name)()):
            np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_array_equal(
        tcomp.quat_to_mat(np.array([0.9, 0.1, -0.3, 0.2])),
        jcomp.quat_to_mat(np.array([0.9, 0.1, -0.3, 0.2])))
    meshes = {"cup": tmesh.make_cup()}
    pose = {"cup": np.array([0.0, 0.0, 0.78, 1.0, 0, 0, 0])}
    got = trender.render_scene_views(meshes, pose, trender.table_mesh(),
                                     rng=np.random.RandomState(0),
                                     width=80, height=60)
    want = jrender.render_scene_views(meshes, pose, jrender.table_mesh(),
                                      rng=np.random.RandomState(0),
                                      width=80, height=60)
    for gv, wv in zip(got, want):
        for g, w in zip(gv, wv):
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(tmerge.DIRECTION_CHANGE_LIST,
                                  jmerge.DIRECTION_CHANGE_LIST)
    g_ply = tmesh.scene_ply(meshes, pose, str(tmp_path / "p.ply"),
                            samples_per_object=300)
    w_ply = jmesh.scene_ply(meshes, pose, str(tmp_path / "j.ply"),
                            samples_per_object=300)
    np.testing.assert_array_equal(g_ply, w_ply)
    assert (tmp_path / "p.ply").read_bytes() == (tmp_path / "j.ply") \
        .read_bytes()


def test_merge_directory_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    for root in ("data", "direction"):
        (tmp_path / root).mkdir()
    for v in range(2):
        with open(tmp_path / "data" / f"3_view_{v}.p", "wb") as f:
            pickle.dump({"valid_index": rng.randint(0, 9, 5)}, f)
    with open(tmp_path / "direction" / "3.p", "wb") as f:
        pickle.dump({"obj_list": ["a", "b"],
                     "move_distance": rng.rand(2, 5)}, f)
    out = {}
    for name, lib in (("jax", jmerge), ("port", tmerge)):
        paths = lib.merge_directory(str(tmp_path / "data"),
                                    str(tmp_path / "direction"),
                                    str(tmp_path / name), {"a": 0, "b": 1},
                                    2, num_views=2)
        out[name] = [pickle.load(open(p, "rb")) for p in paths]
    assert len(out["port"]) == 2
    for g, w in zip(out["port"], out["jax"]):
        for key in w:
            np.testing.assert_array_equal(g[key], w[key])
