"""The port's BVH (`ops/bvh.py`: `build_tri_bvh`, `bvh_tri_hit`) against the
JAX package's and against the port's brute-force triangle sweep
(`intersect.tri_ts` over every triangle), on seeded rays:

- the triangles scene with the stand-in meshes (`scenes.write_stand_in_meshes`:
  11,264 triangles, built by both packages), on 512 rays of
  tests/test_bvh.py's distribution and 512 rays aimed into the meshes' box,
  a quarter of them inside a medium (the backface rule);
- the Cornell box's box as baked triangles, leaf size 2 (tests/test_bvh.py:56);
- no active triangle: no BVH.

The build equals JAX's NumPy build array for array, and JAX's native build
(where it is built) node for node with the same set of triangles in each
leaf. The walk: the
hit sets EQUAL, t within rtol 1e-5 and atol 1e-3 (tests/test_bvh.py's
bound: JAX runs the walk under jit, whose XLA:CPU may contract the
Moller-Trumbore products), the winning triangle equal where both hit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miniraytracer_tpu.models import scenes as jscenes
from miniraytracer_tpu.ops import bvh as jbvh
from miniraytracer_tpu.ops import intersect as jix
from miniraytracer_tpu.ops.vecmath import V3 as JV3
from miniraytracer_tpu.utils import runtime as jrt
from miniraytracer_tpu_torch.models import scenes as tscenes
from miniraytracer_tpu_torch.ops import bvh as tbvh
from miniraytracer_tpu_torch.ops import intersect as tix
from miniraytracer_tpu_torch.ops.vecmath import V3

torch.set_num_threads(1)

N_RAYS = 512


@pytest.fixture(scope="module")
def mesh_scenes(tmp_path_factory):
    """(JAX scene, port scene) of `triangles` with the stand-in meshes."""
    assets = str(tscenes.write_stand_in_meshes(tmp_path_factory.mktemp("assets")))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MRT_ASSETS", assets)
        mp.setattr(jscenes, "ASSET_DIR", assets)
        js, ts = jscenes.triangles(1.0), tscenes.triangles(1.0)
    assert ts.n_tris == js.n_tris == 11264
    return js, ts


def _rays(ro, rd, inside):
    """The same rays for both packages from numpy arrays."""
    n = ro.shape[0]
    rd = rd / np.linalg.norm(rd, axis=1, keepdims=True)
    jr = jix.Rays(ro=JV3(*(jnp.asarray(c) for c in ro.T)),
                  rd=JV3(*(jnp.asarray(c) for c in rd.T)),
                  time=jnp.zeros(n), inside=jnp.asarray(inside))
    tr = tix.Rays(ro=V3(*(torch.from_numpy(np.ascontiguousarray(c)) for c in ro.T)),
                  rd=V3(*(torch.from_numpy(np.ascontiguousarray(c)) for c in rd.T)),
                  time=torch.zeros(n), inside=torch.from_numpy(inside))
    return jr, tr


def _test_bvh_rays(rng):
    """tests/test_bvh.py's distribution: from in front of the scene, forward."""
    ro = np.stack([rng.uniform(50, 500, N_RAYS), rng.uniform(50, 500, N_RAYS),
                   rng.uniform(-700, -50, N_RAYS)], 1).astype(np.float32)
    rd = np.stack([rng.standard_normal(N_RAYS), rng.standard_normal(N_RAYS),
                   np.abs(rng.standard_normal(N_RAYS)) + 0.1], 1).astype(np.float32)
    return ro, rd


def _aimed_rays(rng, scene):
    """From in front of the scene towards points in the active triangles' box."""
    m = scene.tri_m.numpy()[scene.tri_active.numpy()]
    lo, hi = m.min(0), m.max(0)
    target = rng.uniform(lo, hi, (N_RAYS, 3))
    ro = np.stack([rng.uniform(50, 500, N_RAYS), rng.uniform(50, 500, N_RAYS),
                   rng.uniform(-700, -50, N_RAYS)], 1)
    return ro.astype(np.float32), (target - ro).astype(np.float32)


def _brute_force(scene, rays):
    n = rays.time.shape[0]
    return tix._chunked_min(
        lambda s, c: tix.tri_ts(scene, rays, s, c, tix.TMIN, torch.full((n,), tix.INF)),
        scene.n_tris, n, "cpu")


def _check(t, i, t_ref, i_ref, min_hits):
    t, i, t_ref, i_ref = (np.asarray(x) for x in (t, i, t_ref, i_ref))
    hit, hit_ref = t < 1e38, t_ref < 1e38
    np.testing.assert_array_equal(hit, hit_ref)
    assert hit.sum() >= min_hits
    np.testing.assert_allclose(t[hit], t_ref[hit], rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(i[hit], i_ref[hit])


def test_build_equals_jax(mesh_scenes, monkeypatch):
    js, ts = mesh_scenes
    ours = tbvh.build_tri_bvh(ts)
    if jrt.native_available():
        # JAX's native build partitions unstably: the same nodes, the same
        # set of triangles in each leaf
        native = jbvh.build_tri_bvh(js)
        for name in ("bmin", "bmax", "left", "first", "count", "order"):
            np.testing.assert_array_equal(getattr(ours, name).numpy(),
                                          np.asarray(getattr(native, name)), err_msg=name)
        po, po_native = ours.prim_order.numpy(), np.asarray(native.prim_order)
        for first, count in zip(ours.first.numpy(), ours.count.numpy()):
            assert set(po[first:first + count]) == set(po_native[first:first + count])
    monkeypatch.setattr(jrt, "bvh_build", lambda bmin, bmax, leaf_size:
                        jrt._bvh_build_numpy(bmin, bmax, leaf_size))
    theirs = jbvh.build_tri_bvh(js)
    assert ours.leaf_size == theirs.leaf_size == 4
    for name in ("bmin", "bmax", "left", "first", "count", "order", "prim_order"):
        a, b = getattr(ours, name).numpy(), np.asarray(getattr(theirs, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("which", ["test_bvh_rays", "aimed"])
def test_walk_matches_jax_and_brute_force_on_meshes(mesh_scenes, which):
    js, ts = mesh_scenes
    rng = np.random.default_rng(7)
    ro, rd = _test_bvh_rays(rng) if which == "test_bvh_rays" else _aimed_rays(rng, ts)
    inside = (rng.uniform(size=N_RAYS) < 0.25).astype(np.int32)
    jr, tr = _rays(ro, rd, inside)
    stats = {}
    t, i = tbvh.bvh_tri_hit(tbvh.build_tri_bvh(ts), ts, tr, stats=stats)
    assert t.dtype == torch.float32 and i.dtype == torch.int32 and stats["steps"] > 0
    min_hits = 10 if which == "test_bvh_rays" else N_RAYS // 4
    _check(t, i, *_brute_force(ts, tr), min_hits)
    _check(t, i, *jbvh.bvh_tri_hit(jbvh.build_tri_bvh(js), js, jr), min_hits)


def test_walk_exact_on_baked_box():
    """tests/test_bvh.py:56: the Cornell box's box as 12 triangles, leaf size 2."""
    scenes = []
    for mod in (jscenes, tscenes):
        b = mod.SceneBuilder()
        b.name = "cornell_tris"
        mod._cornell_camera(b, 1.0)
        white = b.lambertian(b.tex_const([0.73, 0.73, 0.73]))
        b.box_tris([0, 0, 0], [165, 330, 165], white, rot_y_deg=15.0, offset=[265, 0, 295])
        scenes.append(b.build())
    js, ts = scenes
    rng = np.random.default_rng(8)
    n = 256
    ro = np.stack([rng.uniform(0, 555, n), rng.uniform(0, 555, n), np.full(n, -400.0)],
                  1).astype(np.float32)
    rd = np.stack([rng.standard_normal(n), rng.standard_normal(n), np.ones(n)],
                  1).astype(np.float32)
    jr, tr = _rays(ro, rd, np.zeros(n, np.int32))
    t, i = tbvh.bvh_tri_hit(tbvh.build_tri_bvh(ts, leaf_size=2), ts, tr)
    _check(t, i, *_brute_force(ts, tr), 5)
    _check(t, i, *jbvh.bvh_tri_hit(jbvh.build_tri_bvh(js, leaf_size=2), js, jr), 5)


def test_no_bvh_without_active_triangles():
    s = tscenes.cornell_box(1.0)
    assert tbvh.build_tri_bvh(dataclasses.replace(
        s, tri_active=torch.zeros_like(s.tri_active))) is None
