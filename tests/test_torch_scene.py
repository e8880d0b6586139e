"""The port's scene tables against the JAX package's, field by field.

The scene tables are the renderer's "weights": the port must build exactly
what miniraytracer_tpu builds (same values, dtypes and static metadata),
pack them into the same flat kernel tables, and accept a JAX scene's leaves
through `from_numpy`.
"""

import dataclasses
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miniraytracer_tpu.models import camera as jcam
from miniraytracer_tpu.models import integrator as jinteg
from miniraytracer_tpu.models import scenes as jscenes
from miniraytracer_tpu.ops import bounce as jbounce
from miniraytracer_tpu.ops import rng as jrng
from miniraytracer_tpu_torch.models import camera as tcam
from miniraytracer_tpu_torch.models import integrator as tinteg
from miniraytracer_tpu_torch.models import scenes as tscenes
from miniraytracer_tpu_torch.ops import bounce as tbounce
from miniraytracer_tpu_torch.ops import rng as trng
from miniraytracer_tpu_torch.scene import types as ttypes

torch.set_num_threads(1)

FUSED = ["two_spheres", "perlin_spheres", "cornell_box", "cornell_smoke"]
# the scenes the port builds: all nine (triangles without its mesh files,
# which the repository does not hold, in both packages alike)
PORTED = list(jscenes.SCENE_NAMES)
PORT = pathlib.Path(__file__).resolve().parent.parent / "miniraytracer_tpu_torch"


def _leaves(scene) -> dict:
    """A dataclass scene as a dict: arrays as numpy, camera as a dict."""
    out = {}
    for f in dataclasses.fields(scene):
        v = getattr(scene, f.name)
        if f.name == "camera":
            out[f.name] = {c.name: np.asarray(getattr(v, c.name))
                           for c in dataclasses.fields(v)}
        elif f.metadata.get("static"):
            out[f.name] = v
        else:
            out[f.name] = np.asarray(v)
    return out


def _assert_same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _assert_same(a[k], b[k])
        elif isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("name", PORTED)
def test_scene_fields_equal_jax(name):
    _assert_same(_leaves(getattr(jscenes, name)(1.0)),
                 _leaves(getattr(tscenes, name)(1.0)))


def test_hybrid_probe_equals_its_build_by_the_jax_package():
    """The procedural scene of the hybrid renderer's tests, put together by
    either package's SceneBuilder."""
    from miniraytracer_tpu.scene.builder import SceneBuilder as JSceneBuilder

    for n_sph, n_tri in ((80, 0), (80, 200)):
        a = tscenes.hybrid_probe(1.0, n_sph, n_tri, builder_cls=JSceneBuilder)
        b = tscenes.hybrid_probe(1.0, n_sph, n_tri)
        _assert_same(_leaves(a), _leaves(b))
        assert b.n_spheres == n_sph + 1 and b.n_tris == max(n_tri, 1)


@pytest.mark.parametrize("name", FUSED)
def test_pack_scene_equals_jax(name):
    jmeta, jtabs = jbounce.pack_scene(getattr(jscenes, name)(1.0))
    tmeta, ttabs = tbounce.pack_scene(getattr(tscenes, name)(1.0))
    assert jmeta == tmeta
    for i in range(8):  # sph rect tri box vol mat tex cam
        np.testing.assert_array_equal(np.asarray(jtabs[i]), ttabs[i].numpy())
        assert ttabs[i].dtype == torch.float32
    # Perlin: JAX keeps each 256-entry table as two lane-replicated halves
    jp = np.asarray(jtabs[8])
    j256 = np.stack([np.concatenate([jp[16 * k], jp[16 * k + 8]])
                     for k in range(6)])
    np.testing.assert_array_equal(j256, ttabs[8].numpy())


@pytest.mark.parametrize("name", PORTED)
def test_from_numpy_equals_port_build(name):
    js = getattr(jscenes, name)(1.0)
    carried = ttypes.from_numpy(_leaves(js))
    _assert_same(_leaves(carried), _leaves(getattr(tscenes, name)(1.0)))
    assert tbounce.can_fuse(carried) == (name in FUSED + ["triangles"])
    assert carried.images.dtype == torch.uint32  # the image atlas too


def test_scene_to_device_keeps_everything():
    sc = tscenes.cornell_box(1.0)
    moved = sc.to("cpu")
    _assert_same(_leaves(moved), _leaves(sc))
    assert moved.device == torch.device("cpu")


def test_unported_scenes_raise():
    """No scene is left unported: `select_scene` builds each of the nine by
    its id, as the JAX package's does; an id beyond them raises."""
    assert tscenes.SCENE_NAMES == jscenes.SCENE_NAMES
    for sid, name in enumerate(tscenes.SCENE_NAMES):
        assert tscenes.select_scene(sid, 1.0).name == name
    with pytest.raises(IndexError):
        tscenes.select_scene(len(tscenes.SCENE_NAMES), 1.0)


# a quad and a triangle, both face forms: `f a b c` and `f a//an b//bn c//cn`
_OBJ = """# synthetic mesh
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0.5 0.5 1
vn 0 0 1
vn 0 0.6 0.8
vn 0.6 0 0.8

f 1 2 3
f 1//1 3//2 4//3
f 2//2 5//3 3//1
f x 1 2
"""


@pytest.mark.parametrize("kw", [
    {}, dict(flip=True), dict(scale=2000.0, translate=(195, -20, 280), flip=True),
    dict(scale=250.0, rot_y_deg=30.0, translate=(393, 50, 108))])
def test_read_obj_equals_jax(tmp_path, kw):
    from miniraytracer_tpu.scene import obj_loader as jobj
    from miniraytracer_tpu_torch.scene import obj_loader as tobj

    path = tmp_path / "mesh.obj"
    path.write_text(_OBJ)
    a, b = jobj.read_obj(str(path), **kw), tobj.read_obj(str(path), **kw)
    assert len(b) == 6 and b[0].shape == (3, 3)  # the face that does not parse is skipped
    for x, y in zip(a, b):
        assert y.dtype == np.float32
        np.testing.assert_array_equal(y, x)
    empty = tmp_path / "empty.obj"
    empty.write_text("v 0 0 0\n")
    assert all(x.shape == (0, 3) for x in tobj.read_obj(str(empty)))


def _mesh_dir(tmp_path, n_quads):
    """An asset directory with the triangles scene's two mesh files: a strip
    of `n_quads` quads each (vertex normals in one, none in the other)."""
    lines = [f"v {i * 0.01} {y} 0" for i in range(n_quads + 1) for y in (0.0, 0.05)]
    faces = [f"f {2 * i + 1} {2 * i + 2} {2 * i + 3}\nf {2 * i + 2} {2 * i + 4} {2 * i + 3}"
             for i in range(n_quads)]
    (tmp_path / "obj").mkdir()
    (tmp_path / "obj" / "Teapot3_no_vt.obj").write_text("\n".join(lines + faces))
    with_n = [ln.replace(" ", "//1 ").replace("f//1 ", "f ") + "//1" for ln in faces]
    (tmp_path / "obj" / "bunny.obj").write_text("\n".join(lines + ["vn 0 0 1"] + with_n))
    return tmp_path


@pytest.mark.parametrize("n_quads", [4, 300])
def test_triangles_with_meshes_equals_jax(tmp_path, monkeypatch, n_quads):
    """With mesh files the triangles scene carries them: 16 triangles stay in
    the fused class; 1200 reach the clustered triangle sweep (the Morton
    clusters of `flash.tri_cull_build`, kernel B10 on the card), and `render`
    draws the scene through the hybrid loop (the work queue from 2000
    primitives on)."""
    import miniraytracer_tpu_torch as mrt
    from miniraytracer_tpu_torch.ops import hybrid as thybrid
    from miniraytracer_tpu_torch.ops import intersect as tix

    assets = _mesh_dir(tmp_path, n_quads)
    monkeypatch.setenv("MRT_ASSETS", str(assets))
    monkeypatch.setattr(jscenes, "ASSET_DIR", str(assets))
    js, ts = jscenes.triangles(1.0), tscenes.triangles(1.0)
    _assert_same(_leaves(js), _leaves(ts))
    assert ts.n_tris == 4 * n_quads
    if n_quads == 4:
        assert tbounce.can_fuse(ts) and mrt.pick_renderer(ts) == "fused"
        return
    assert set(tix.make_accel(ts)) == set(thybrid.hybrid_accel(ts)) == {"tri_cull"}
    frame, stats = mrt.render(ts, 4, 4, 1, max_bounces=3, device="cpu")
    assert stats["renderer"] == "hybrid" and torch.isfinite(frame).all()
    assert stats["rays"] >= 16


@pytest.mark.parametrize("kw", [{}, dict(bunny_subdiv=2, torus_segments=(8, 6))])
def test_stand_in_meshes_load_alike_in_both_packages(tmp_path, monkeypatch, kw):
    """`write_stand_in_meshes` writes the triangles scene's two mesh files:
    both packages' `read_obj` load them to the same triangles, and the
    scene's transforms put both inside the Cornell box. At the defaults they
    hold 11,264 triangles, the size of the reference's 11,288, and the rule
    sends the scene to the work queue with its shade step."""
    import miniraytracer_tpu_torch as mrt
    from miniraytracer_tpu.scene import obj_loader as jobj
    from miniraytracer_tpu_torch.ops import hybrid as thybrid
    from miniraytracer_tpu_torch.scene import obj_loader as tobj

    assets = tscenes.write_stand_in_meshes(str(tmp_path), **kw)
    for name, tr in (("bunny.obj", dict(flip=True, scale=2000.0, translate=(195, -20, 280))),
                     ("Teapot3_no_vt.obj", dict(scale=250.0, rot_y_deg=30.0,
                                                translate=(393, 50, 108)))):
        a, b = jobj.read_obj(str(tmp_path / "obj" / name), **tr), tobj.read_obj(
            str(tmp_path / "obj" / name), **tr)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y, x)
        tri = np.stack(b[:3])
        assert tri.min() > 0 and tri.max() < 555
        # wound outward once loaded, as the vertex normals say
        gn = np.cross(b[1] - b[0], b[2] - b[0])
        assert ((gn * (b[3] + b[4] + b[5])).sum(1) > 0).all()
    monkeypatch.setenv("MRT_ASSETS", assets)
    ts = tscenes.triangles(1.0)
    if not kw:
        assert ts.n_tris == 5120 + 6144
        assert mrt.pick_renderer(ts) == "workqueue" and thybrid.prefer_hybrid(ts)
    else:
        monkeypatch.setattr(jscenes, "ASSET_DIR", assets)
        _assert_same(_leaves(jscenes.triangles(1.0)), _leaves(ts))
        assert ts.n_tris == 320 + 96


def test_bulk_builders_equal_jax_and_per_call():
    """`spheres_bulk`, `triangles_bulk` (appended after the per-call rows at
    `build`) and `box_tris` build what the JAX package's builder builds, and
    bulk rows equal per-call ones (tests/test_scaling_scenes.py)."""
    from miniraytracer_tpu.scene.builder import SceneBuilder as JSceneBuilder

    rs = np.random.default_rng(1)
    c = rs.uniform(-5, 5, (40, 3)).astype(np.float32)
    r = rs.uniform(0.1, 1.0, 40).astype(np.float32)
    a = rs.uniform(-5, 5, (30, 3)).astype(np.float32)
    b_, c_ = (a + rs.uniform(0.1, 1, (30, 3)).astype(np.float32) for _ in range(2))
    nrm = rs.normal(size=(30, 3)).astype(np.float32)

    def build(cls, bulk):
        b = cls()
        b.set_camera((0, 0, -5), (0, 0, 0), (0, 1, 0), 40, 1.0, 0, 1, 0, 0)
        m = b.lambertian(b.tex_const([0.5, 0.5, 0.5]))
        b.sphere((0, 0, 0), 1.0, m)
        b.triangle(a[0], b_[0], c_[0], m)
        b.box_tris([-1, 0, -1], [1, 1.5, 1], m, rot_y_deg=18.0, offset=(0.5, 0, 0.5))
        if bulk:
            b.spheres_bulk(c, r, m)
            b.spheres_bulk(c[:2], 0.2, m, centers1=c[:2] + [0, 0.5, 0], t0=0.0, t1=1.0)
            b.triangles_bulk(a, b_, c_, m)
            b.triangles_bulk(a[:3], b_[:3], c_[:3], m, an=nrm[:3], bn=nrm[:3], cn=nrm[:3])
        else:
            for k in range(40):
                b.sphere(c[k], float(r[k]), m)
            for k in range(2):
                b.sphere(c[k], 0.2, m, center1=c[k] + [0, 0.5, 0], t0=0.0, t1=1.0)
            for k in range(30):
                b.triangle(a[k], b_[k], c_[k], m)
            for k in range(3):
                b.triangle(a[k], b_[k], c_[k], m, an=nrm[k], bn=nrm[k], cn=nrm[k])
        return b.build()

    bulk = build(tscenes.SceneBuilder, True)
    _assert_same(_leaves(build(JSceneBuilder, True)), _leaves(bulk))
    # per call: the same rows, the flat normals to an ulp (a norm over one
    # row against one over the block)
    per_call, bulk_leaves = _leaves(build(tscenes.SceneBuilder, False)), _leaves(bulk)
    for k in ("tri_mn", "tri_un", "tri_vn"):
        np.testing.assert_allclose(per_call.pop(k), bulk_leaves.pop(k), rtol=0, atol=1e-6)
    _assert_same(per_call, bulk_leaves)
    assert bulk.n_spheres == 43 and bulk.n_tris == 1 + 30 + 3 + 12
    assert bool(bulk.sph_moving[-2:].all()) and not bool(bulk.sph_moving[:-2].any())


def test_sample_offsets_equal_jax():
    for spp in (1, 4, 9, 10, 64):
        jo, jn = jinteg.sample_offsets(spp)
        to, tn = tinteg.sample_offsets(spp)
        assert jn == tn
        np.testing.assert_array_equal(np.asarray(jo), to.numpy())


def test_camera_rays_match_jax_and_packed_formula():
    rs = np.random.default_rng(11)
    n = 4096
    s = rs.random(n, dtype=np.float32)
    t = rs.random(n, dtype=np.float32)
    keys = rs.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    # a thin-lens camera with a shutter interval (two_spheres' book-1 camera)
    jr = jcam.get_rays(jscenes.two_spheres(1.0).camera, jnp.asarray(s),
                       jnp.asarray(t), jnp.asarray(keys))
    sc = tscenes.two_spheres(1.0)
    tk = torch.as_tensor(keys.astype(np.int64))
    tr = tcam.get_rays(sc.camera, torch.as_tensor(s), torch.as_tensor(t), tk)
    for a, b in ((jr.ro, tr.ro), (jr.rd, tr.rd)):
        np.testing.assert_allclose(np.asarray(a.arr), b.arr.numpy(),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(jr.time), tr.time.numpy(), rtol=1e-6)
    # the kernel's regeneration formula over the packed camera table gives
    # the same rays bit for bit
    _, tabs = tbounce.pack_scene(sc)
    ro, rd, time = tbounce.camera_ray(tabs[7], torch.as_tensor(s),
                                      torch.as_tensor(t), tk)
    for a, b in ((ro, tr.ro), (rd, tr.rd)):
        np.testing.assert_array_equal(a.arr.numpy(), b.arr.numpy())
    np.testing.assert_array_equal(time.numpy(), tr.time.numpy())


def test_film_coords_follow_jax_key_and_offset_rules():
    w, h, sq = 7, 5, 3
    pix = torch.arange(w * h, dtype=torch.int64).repeat(sq * sq)
    samp = torch.arange(sq * sq).repeat_interleave(w * h)
    ss, tt = tbounce.film_coords(pix, samp, w, h, sq)
    offs, _ = jinteg.sample_offsets(sq * sq)
    offs = np.asarray(offs)[samp.numpy()]
    np.testing.assert_array_equal(
        ss.numpy(), ((pix.numpy() % w).astype(np.float32) + offs[:, 0]) / w)
    np.testing.assert_array_equal(
        tt.numpy(), ((pix.numpy() // w).astype(np.float32) + offs[:, 1]) / h)
    np.testing.assert_array_equal(
        np.asarray(jrng.ray_key(pix.numpy().astype(np.uint32),
                                samp.numpy().astype(np.uint32))).astype(np.int64),
        trng.ray_key(pix, samp).numpy())


def test_port_never_imports_jax():
    """A source check (the test process itself has jax loaded)."""
    pat = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+miniraytracer_tpu\b(?!_torch)"
                     r"|from\s+miniraytracer_tpu\b(?!_torch))", re.M)
    files = sorted(PORT.rglob("*.py")) + [PORT.parent / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(p) for p in files if pat.search(p.read_text())]
    assert not offenders, offenders


def test_book2_final_is_the_scene_of_the_reference():
    """400 boxes, 1006 spheres of which one moves, two volumes, an image, a
    Perlin texture and one rect light, on the scene generator's fixed stream
    (the cloud's draws land z, y, x)."""
    sc = tscenes.book2_final(1.0)
    assert (sc.n_boxes, sc.n_spheres, sc.n_volumes, sc.n_rects) == (400, 1006, 2, 1)
    assert int((sc.sph_moving > 0).sum()) == 1 and sc.has_image and sc.has_perlin
    assert len(sc.lights) == 1 and not sc.use_sky
    js = jscenes.book2_final(1.0)
    np.testing.assert_array_equal(sc.sph_c0.numpy()[6:], np.asarray(js.sph_c0)[6:])
    cloud = sc.sph_c0.numpy()[6:1006]
    assert cloud.shape == (1000, 3) and (sc.sph_radius.numpy()[6:1006] == 10).all()
    # inside the rotated, moved cube of side 165
    assert cloud[:, 1].min() >= 270 and cloud[:, 1].max() <= 270 + 165
    assert tscenes.select_scene(tscenes.SCENE_BOOK2_FINAL, 1.0).name == "book2_final"
