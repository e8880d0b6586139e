"""The port's bounce in tensor operations (`ops/intersect.scene_hit`,
`models/materials.shade`, `models/pdfs`, `models/integrator._shade_and_advance`)
against the JAX package's, called eagerly, lane by lane.

The same rays go through both: 512 camera rays of each scene from seeded film
coordinates and keys, then the rays of two more bounces (the port's own, with
lanes inside glass and volumes). Eager JAX rounds every operation on its own,
as the port does; the tolerances follow from what differs:

- `scene_hit` (without kernels: the sweeps in tensor operations on both
  sides): hit, material and t EQUAL, but for t on a volume's free path (a
  log, which XLA and torch may round an ulp apart: 1e-6 relative there);
  point, normal and uv within 1e-6 of the row's scale;
- `shade` on the same record: the new medium counter and the scatter and
  emission flags EQUAL; directions, weights and emission within 1e-6 of the
  row's scale (sin, cos and the cube root are the libraries' own);
- `_shade_and_advance`: `cont` EQUAL, throughput and radiance within 1e-6;
- the light pdfs on seeded points and directions towards every light kind.

With `make_accel`'s kernels (their plain versions here) the sphere sweep sums
the quadratic as the kernel B8 does, in another order than `sphere_ts`:
winners equal, t within twice the per-ray bound of tests/test_torch_flash.py
(each form rounds the cancelling c on its own).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miniraytracer_tpu.models import integrator as jinteg
from miniraytracer_tpu.models import materials as jmat
from miniraytracer_tpu.models import pdfs as jpdfs
from miniraytracer_tpu.models import scenes as jscenes
from miniraytracer_tpu.ops import flash as jflash
from miniraytracer_tpu.ops import intersect as jix
from miniraytracer_tpu.ops import rng as jrng
from miniraytracer_tpu.ops.vecmath import V3 as JV3
from miniraytracer_tpu.scene.builder import SceneBuilder as JBuilder
from miniraytracer_tpu_torch.models import camera as tcam
from miniraytracer_tpu_torch.models import integrator as tinteg
from miniraytracer_tpu_torch.models import materials as tmat
from miniraytracer_tpu_torch.models import pdfs as tpdfs
from miniraytracer_tpu_torch.models import scenes as tscenes
from miniraytracer_tpu_torch.ops import intersect as tix
from miniraytracer_tpu_torch.ops import rng as trng
from miniraytracer_tpu_torch.ops.vecmath import V3, vnormalize, vwhere
from miniraytracer_tpu_torch.scene import types as T
from miniraytracer_tpu_torch.scene.builder import SceneBuilder as TBuilder
from tests.test_torch_bounce import _synthetic
from tests.test_torch_flash import _sphere_t_slack

torch.set_num_threads(1)

N = 512
SCENES = list(tscenes.SCENE_NAMES) + ["sphere_light", "synthetic", "exact_cosine"]


def _pair(name):
    if name == "sphere_light":
        return tscenes.ad_probe(builder_cls=JBuilder), tscenes.ad_probe()
    if name == "synthetic":  # moving spheres, a volume sphere, two light kinds
        return _synthetic(JBuilder), _synthetic(TBuilder)
    if name == "exact_cosine":
        return (dataclasses.replace(jscenes.cornell_box(1.0), exact_cosine=True),
                dataclasses.replace(tscenes.cornell_box(1.0), exact_cosine=True))
    return getattr(jscenes, name)(1.0), getattr(tscenes, name)(1.0)


def _j(t):
    if isinstance(t, V3):
        return JV3(*(jnp.asarray(c.numpy()) for c in t))
    if t.dtype == torch.int64:  # u32 keys
        return jnp.asarray(t.numpy().astype(np.uint32))
    return jnp.asarray(t.numpy())


def _jrays(r):
    return jix.Rays(_j(r.ro), _j(r.rd), _j(r.time), _j(r.inside))


def _close(port, ref, tol=1e-6, mask=None, what=""):
    """Within tol of the row's scale (at least 1), where `mask`."""
    port, ref = np.asarray(port), np.asarray(ref)
    if mask is not None:
        port, ref = port[mask], ref[mask]
    if ref.size:
        scale = max(float(np.abs(ref).max()), 1.0)
        assert float(np.abs(port - ref).max()) <= tol * scale, what


def _close3(port: V3, ref, tol=1e-6, mask=None, what=""):
    for a, b in zip(port, ref):
        _close(a.numpy(), b, tol, mask, what)


def _camera_rays(scene, seed):
    rs = np.random.default_rng(seed)
    s, t = (torch.as_tensor(rs.random(N, dtype=np.float32)) for _ in range(2))
    keys = torch.as_tensor(rs.integers(0, 2 ** 32, N, dtype=np.int64))
    return tcam.get_rays(scene.camera, s, t, keys), keys


def _u_vol(keys_b, n_volumes):
    t = torch.stack([trng.uniform(keys_b, tmat.SLOT_VOL + v) for v in range(n_volumes)], -1)
    j = jnp.stack([jrng.uniform(_j(keys_b), jmat.SLOT_VOL + v) for v in range(n_volumes)], -1)
    return t, j


@pytest.mark.parametrize("name", SCENES)
def test_bounce_matches_eager_jax(name):
    js, ts = _pair(name)
    rays, keys = _camera_rays(ts, 0)
    one, zero = torch.ones(N), torch.zeros(N)
    alive = torch.ones(N, dtype=torch.bool)
    beta, radiance = V3(one, one, one), V3(zero, zero, zero)
    vol_mats = set(ts.vol_mat[ts.vol_active].tolist())
    seen = dict(mtypes=set(), inside=0, cont=0, hits=0)
    for depth in range(3):
        keys_b = trng.fold(keys, torch.full((N,), depth))
        depth_ok = torch.full((N,), depth < 2)
        u_t, u_j = _u_vol(keys_b, ts.n_volumes)
        jr = _jrays(rays)

        # scene_hit, the sweeps in tensor operations on both sides
        rec = tix.scene_hit(ts, rays, u_t)
        jrec = jix.scene_hit(js, jr, u_j)
        hit = rec.hit.numpy()
        np.testing.assert_array_equal(hit, np.asarray(jrec.hit))
        np.testing.assert_array_equal(rec.mat.numpy(), np.asarray(jrec.mat))
        t_t, t_j = rec.t.numpy(), np.asarray(jrec.t)
        on_vol = np.isin(rec.mat.numpy(), list(vol_mats)) & hit
        np.testing.assert_array_equal(t_t[~on_vol], t_j[~on_vol])
        np.testing.assert_allclose(t_t[on_vol], t_j[on_vol], rtol=1e-6)
        _close3(rec.p, jrec.p, what="p")
        _close3(rec.n, jrec.n, what="n")
        _close(rec.u.numpy(), jrec.u, what="u")
        _close(rec.v.numpy(), jrec.v, what="v")
        assert (rec.n.x.numpy()[~hit] == 1).all() and (rec.u.numpy()[~hit] == 0).all()

        # shade, on the port's record in both
        jrec_t = jix.HitRecord(_j(rec.t), _j(rec.p), _j(rec.n), _j(rec.u), _j(rec.v),
                               _j(rec.mat), _j(rec.hit))
        sc = tmat.shade(ts, rays, rec, keys_b, depth_ok)
        jsc = jmat.shade(js, jr, jrec_t, _j(keys_b), _j(depth_ok))
        for f in ("new_inside", "scattered", "add_emitted"):
            np.testing.assert_array_equal(getattr(sc, f).numpy(), np.asarray(getattr(jsc, f)), f)
        for f in ("new_rd", "weight", "emitted"):
            _close3(getattr(sc, f), getattr(jsc, f), mask=hit, what=f)

        # the bounce with its advance
        out = tinteg._shade_and_advance(ts, rays, keys_b, depth_ok, alive, beta, radiance)
        jout = jinteg._shade_and_advance(js, jr, _j(keys_b), _j(depth_ok), _j(alive), _j(beta),
                                         _j(radiance))
        _, sc, cont, beta, radiance = out
        np.testing.assert_array_equal(cont.numpy(), np.asarray(jout[2]))
        _close3(beta, jout[3], what="beta")
        _close3(radiance, jout[4], what="radiance")

        seen["mtypes"] |= set(ts.mat_type[rec.mat.long()][rec.hit].tolist())
        seen["inside"] += int((rays.inside > 0).sum())
        seen["cont"] += int(cont.sum())
        seen["hits"] += int(hit.sum())
        # the next rays: on from the hit where the path goes on, the same ray
        # again elsewhere (every lane stays alive, so each depth has N lanes)
        rays = tix.Rays(vwhere(cont, rec.p, rays.ro), vwhere(cont, sc.new_rd, rays.rd),
                        rays.time, torch.where(cont, sc.new_inside, rays.inside))
        alive = torch.ones(N, dtype=torch.bool)
    assert seen["hits"] > N and seen["cont"] > N // 2
    want = {"cornell_box": {T.MAT_LAMBERTIAN, T.MAT_DIFFUSE_LIGHT, T.MAT_DIELECTRIC},
            "random_spheres_2": {T.MAT_LAMBERTIAN, T.MAT_METAL, T.MAT_DIELECTRIC},
            "synthetic": {T.MAT_METAL, T.MAT_DIELECTRIC},
            "book2_final": {T.MAT_ISOTROPIC, T.MAT_DIELECTRIC}}.get(name, set())
    assert want <= seen["mtypes"], seen["mtypes"]
    if name == "cornell_smoke":  # box volumes never scatter (the one-sided quirk)
        assert T.MAT_ISOTROPIC not in seen["mtypes"]
    if name in ("random_spheres_2", "book2_final", "synthetic"):
        assert seen["inside"] > 0


@pytest.mark.parametrize("name", ["cornell_box", "sphere_light", "synthetic"])
def test_light_pdfs_match_eager_jax(name):
    """Points around the lights and directions both towards them (the light
    sample) and anywhere (a cosine sample): values and generated directions."""
    js, ts = _pair(name)
    rs = np.random.default_rng(4)
    lo, hi = (0.0, 555.0) if name == "cornell_box" else (-3.0, 3.0)
    origin = V3(*(torch.as_tensor(rs.uniform(lo, hi, N).astype(np.float32)) for _ in range(3)))
    time = torch.as_tensor(rs.random(N, dtype=np.float32))
    u = [torch.as_tensor(rs.random(N, dtype=np.float32)) for _ in range(3)]
    gen = tpdfs.light_pdf_generate(ts, origin, time, *u)
    jgen = jpdfs.light_pdf_generate(js, _j(origin), _j(time), *map(_j, u))
    _close3(gen, jgen, what="generate")
    d_any = V3(*(torch.as_tensor(rs.normal(size=N).astype(np.float32)) for _ in range(3)))
    for d in (vnormalize(gen), vnormalize(d_any)):
        val = tpdfs.light_pdf_value(ts, origin, d, time).numpy()
        jval = np.asarray(jpdfs.light_pdf_value(js, _j(origin), _j(d), _j(time)))
        np.testing.assert_array_equal(val > 0, jval > 0)
        np.testing.assert_allclose(val, jval, rtol=1e-5, atol=1e-7)
        n = vnormalize(V3(d.y, d.z + 0.3, d.x))
        np.testing.assert_array_equal(tpdfs.cosine_pdf_value(n, d).numpy(),
                                      np.asarray(jpdfs.cosine_pdf_value(_j(n), _j(d))))
        np.testing.assert_array_equal(tpdfs.isotropic_pdf_value(d).numpy(),
                                      np.asarray(jpdfs.isotropic_pdf_value(_j(d))))
    assert (val > 0).any()  # the light-directed samples hit their lights


@pytest.mark.parametrize("name", ["random_spheres_2", "book2_final"])
def test_scene_hit_through_make_accel(name):
    """The sweeps that `make_accel` hands to kernels (their plain versions on
    these CPU tensors) against JAX's `scene_hit` in tensor operations: the
    same winners, t within the per-ray bound of the sum's order. The gated
    sweep of book2_final may drop a hit that grazes a cluster's box (none
    here, as in tests/test_torch_flash.py)."""
    js, ts = _pair(name)
    accel = tix.make_accel(ts)
    rays, keys = _camera_rays(ts, 1)
    u_t, u_j = _u_vol(trng.fold(keys, torch.zeros(N, dtype=torch.int64)), ts.n_volumes)
    rec = tix.scene_hit(ts, rays, u_t, accel=accel)
    jrec = jix.scene_hit(js, _jrays(rays), u_j)
    np.testing.assert_array_equal(rec.hit.numpy(), np.asarray(jrec.hit))
    np.testing.assert_array_equal(rec.mat.numpy(), np.asarray(jrec.mat))
    sph_rows = [int(i) for i in np.asarray(jix._chunked_min(
        lambda s, c: jix.sphere_ts(js, _jrays(rays), s, c, tix.TMIN, jnp.full((N,), 3e38)),
        js.n_spheres, N)[1])]
    ro, rd = (np.stack([c.numpy() for c in v], 1) for v in (rays.ro, rays.rd))
    slack = _sphere_t_slack(jflash.sphere_coefficients(js), ro, rd, rays.time.numpy(), sph_rows)
    t_t, t_j = rec.t.numpy(), np.asarray(jrec.t)
    hit = rec.hit.numpy()
    # each form rounds c (terms ~|oc|^2, 1e6 on the radius-1000 ground) on
    # its own: twice the one form's bound
    assert (np.abs(t_t - t_j)[hit] <= 2 * slack[hit] + 1e-6 * t_j[hit]).all()
    assert (t_t != t_j).any() or name == "book2_final"  # the two sums do differ
    # plain=True on a CPU scene takes the same plain versions
    rec2 = tix.scene_hit(ts, rays, u_t, accel=accel, plain=True)
    assert torch.equal(rec2.t, rec.t) and torch.equal(rec2.mat, rec.mat)


def test_volume_quirks_match_jax():
    """One-sided boundaries: a box volume never scatters a ray from outside,
    nor one starting inside; a sphere volume scatters only a ray inside a
    medium; the later volume is clamped by the earlier's scatter."""
    b = {k: cls() for k, cls in (("j", JBuilder), ("t", TBuilder))}
    for bb in b.values():
        bb.set_camera([0, 0, 5], [0, 0, 0], [0, 1, 0], 40.0, 1.0, 0.0, 5.0, 0.0, 1.0)
        white = bb.tex_const([0.9, 0.9, 0.9])
        bb.volume_box([-1, -1, -1], [1, 1, 1], 50.0, white, rot_y_deg=15.0, offset=[0, 0, -3])
        bb.volume_sphere([0, 0, 3], 1.0, 50.0, white)
        bb.volume_sphere([0, 0, 3], 1.5, 80.0, white)
    js, ts = b["j"].build(), b["t"].build()
    rs = np.random.default_rng(8)
    ro = rs.uniform(-6, 6, (N, 3)).astype(np.float32)
    ro[:100] = rs.uniform(-0.5, 0.5, (100, 3)) + [0, 0, -3]  # inside the box
    ro[100:200] = rs.uniform(-0.5, 0.5, (100, 3)) + [0, 0, 3]  # inside the spheres
    target = rs.uniform(-1.5, 1.5, (N, 3)).astype(np.float32) + np.where(
        rs.random((N, 1)) < 0.5, [0, 0, 3], [0, 0, -3]).astype(np.float32)
    rd = target - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    inside = (rs.random(N) < 0.5).astype(np.int32)
    rays = tix.Rays(V3(*(torch.as_tensor(ro[:, k].copy()) for k in range(3))),
                    V3(*(torch.as_tensor(rd[:, k].copy()) for k in range(3))),
                    torch.zeros(N), torch.as_tensor(inside))
    u = torch.as_tensor(rs.random((N, ts.n_volumes), dtype=np.float32))
    inf = torch.full((N,), 3e38)
    t, i = tix.volume_ts(ts, rays, tix.TMIN, inf, u)
    jt, ji = jix.volume_ts(js, _jrays(rays), tix.TMIN, jnp.full((N,), 3e38), _j(u))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=1e-6)
    scat = t.numpy() < 3e38
    assert scat.any() and not (scat & (i.numpy() == 0)).any()  # the box: never
    assert not (scat & (inside == 0)).any()  # spheres: only rays inside a medium
    assert (i.numpy()[scat] == 2).any() and (i.numpy()[scat] == 1).any()
    for vi in range(3):
        a, b2, ok = tix._volume_entry_exit(ts, rays, vi)
        ja, jb, jok = jix._volume_entry_exit(js, _jrays(rays), vi)
        np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(b2.numpy(), np.asarray(jb))
