"""The port's differentiable sweeps (`ops/flash.py`: `flash_tri_hit_d`,
`flash_sphere_hit_d`, `flash_tri_hit_culled_d`, `flash_sphere_hit_culled_d`,
`box_hit_d`) against the JAX package's custom VJPs under `jax.vjp`.

Both sides get the same coefficient tables, rays and cotangent of t (made
from numpy seeds); the JAX sweeps run in interpret mode, as the JAX
package's own tests run them on the CPU. Compared: the hit distances and
winners, and the cotangents of the coefficient tables, of the rays and of
the ray time, within rtol 2e-3 and atol 2e-4 of each cotangent's largest
entry (the JAX tolerances of tests/test_bounce_ad.py); t within 2e-4
relative and absolute, the same winner on 99% of the rays or more (the
cotangent of t is zero on the others). Dead lanes are NaN rays, as the candidate from outside sends them.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miniraytracer_tpu.ops import flash as jflash
from miniraytracer_tpu.ops.vecmath import V3 as JV3
from miniraytracer_tpu.scene.builder import SceneBuilder as JSceneBuilder
from miniraytracer_tpu_torch.models import scenes as tscenes
from miniraytracer_tpu_torch.ops import flash as tflash
from miniraytracer_tpu_torch.ops.vecmath import V3
from tests.test_bounce_ad import _ext_box_scene
from tests.test_torch_scene import _leaves
from tests.test_torch_tri_cull import _builds, _rays, mesh_scenes  # noqa: F401

torch.set_num_threads(1)

TMIN = 0.001


@pytest.fixture()
def interpret_flash(monkeypatch):
    for name in ("flash_tri_hit", "flash_tri_hit_resident", "flash_tri_hit_streamed",
                 "flash_sphere_hit", "flash_sphere_hit_gated", "flash_sphere_hit_streamed"):
        monkeypatch.setattr(jflash, name, partial(getattr(jflash, name), interpret=True))


def _close(name, a, b):
    b = np.asarray(b)
    a = np.zeros_like(b) if a is None else a.detach().numpy()
    assert np.isfinite(a).all(), f"{name}: not finite"
    scale = float(np.abs(b).max()) if b.size else 0.0
    np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-4 * scale + 1e-30, err_msg=name)


def _pair_v3(a):
    """(JAX V3, port V3 requiring grad) of an (N, 3) array."""
    return (JV3(*(jnp.asarray(np.ascontiguousarray(a[:, k])) for k in range(3))),
            V3(*(torch.tensor(np.ascontiguousarray(a[:, k]), requires_grad=True)
                 for k in range(3))))


def _sphere_rays(seed, n, centres):
    """Rays from a box around the spheres, half aimed at a centre, the last
    eight NaN (dead lanes); their times uniform in [0, 1)."""
    rs = np.random.default_rng(seed)
    lo, hi = centres.min(0) - 2.0, centres.max(0) + 2.0
    ro = rs.uniform(lo, hi, (n, 3)).astype(np.float32)
    rd = rs.standard_normal((n, 3)).astype(np.float32)
    rd[: n // 2] = centres[rs.integers(0, centres.shape[0], n // 2)] - ro[: n // 2]
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    ro[-8:] = rd[-8:] = np.nan
    return ro, rd, rs.uniform(0, 1, n).astype(np.float32), (rs.uniform(size=n) < 0.2).astype(np.int32)


def _compare_sweep(j_fn, t_fn, j_tabs, t_tabs, ro, rd, time, seed):
    """Run both sweeps, pull a seeded cotangent of t back through each and
    compare (t, idx, d_tables, d_ro, d_rd[, d_time])."""
    (jro, tro), (jrd, trd) = _pair_v3(ro), _pair_v3(rd)
    jtime = ttime = None
    if time is not None:
        jtime, ttime = jnp.asarray(time), torch.tensor(time, requires_grad=True)
    t_tabs = tuple(t.clone().requires_grad_(True) for t in t_tabs)
    args_j = (j_tabs, jro, jrd) + (() if time is None else (jtime,))
    (tj, ij), pull = jax.vjp(lambda *a: j_fn(*a), *args_j)
    tt, it = t_fn(t_tabs, tro, trd, *(() if time is None else (ttime,)))
    hit_j, hit_t = np.asarray(tj) < 1e38, tt.detach().numpy() < 1e38
    # the clustered sweeps gate per ray, the JAX kernels per block of rays: a
    # hit at a cluster box's float edge can differ (ops/flash.py)
    same = (hit_j == hit_t) & (~hit_j | (it.numpy() == np.asarray(ij)))
    assert same.mean() >= 0.99, same.mean()
    hit = hit_j & same
    # the kernels sum the features term by term, the JAX kernels by a matrix
    # product: the sphere quadratic's cancellation leaves ~1e-4 of t
    np.testing.assert_allclose(tt.detach().numpy()[hit], np.asarray(tj)[hit], rtol=2e-4,
                               atol=2e-4)
    assert hit.sum() > 0.2 * hit.size, hit.mean()
    gt = np.random.default_rng(seed).standard_normal(hit.size).astype(np.float32)
    gt = np.where(hit, gt, 0.0).astype(np.float32)  # the caller masks misses
    g_j = pull((jnp.asarray(gt), np.zeros(hit.size, jax.dtypes.float0)))
    leaves = list(t_tabs) + list(tro) + list(trd) + ([] if time is None else [ttime])
    g_t = torch.autograd.grad(tt, leaves, grad_outputs=torch.as_tensor(gt), allow_unused=True)
    for k, (a, b) in enumerate(zip(g_t[:len(t_tabs)], g_j[0])):
        _close(f"d_table {k}", a, b)
    o = len(t_tabs)
    for k, name in enumerate("xyz"):
        _close(f"d_ro.{name}", g_t[o + k], g_j[1][k])
        _close(f"d_rd.{name}", g_t[o + 3 + k], g_j[2][k])
    if time is not None:
        _close("d_time", g_t[-1], g_j[3])
    return g_t


def _probe_spheres(n_sph):
    js = tscenes.hybrid_probe(1.0, n_sph, 0, builder_cls=JSceneBuilder)
    ts = tscenes.hybrid_probe(1.0, n_sph, 0)
    # one moving sphere, so that the time's cotangent is not structurally zero
    c1 = np.asarray(js.sph_c0).copy()
    c1[5] += [0.3, 0.1, 0.0]
    mov = np.asarray(js.sph_moving).copy()
    mov[5] = 1.0
    js = dataclasses.replace(js, sph_c1=jnp.asarray(c1), sph_moving=jnp.asarray(mov),
                             sph_t1=jnp.ones_like(js.sph_t1))
    ts = dataclasses.replace(ts, sph_c1=torch.as_tensor(c1), sph_moving=torch.as_tensor(mov),
                             sph_t1=torch.ones_like(ts.sph_t1))
    return js, ts


def test_sphere_vjp_matches_jax(interpret_flash):
    js, ts = _probe_spheres(120)
    jc = jflash.sphere_coefficients(js)
    tc = tflash.coefficients_from_numpy(jc)
    ro, rd, time, inside = _sphere_rays(3, 512, np.asarray(js.sph_c0)[1:])
    j_in, t_in = jnp.asarray(inside), torch.as_tensor(inside)
    _compare_sweep(
        lambda c, o, d, tm: jflash.flash_sphere_hit_d(c, o, d, tm, j_in, TMIN),
        lambda c, o, d, tm: tflash.flash_sphere_hit_d(c, o, d, tm, t_in, TMIN),
        jc, tc, ro, rd, time, 4)


def test_sphere_culled_vjp_matches_jax(interpret_flash):
    """600 spheres: the gated clustered sweep (B13's route) under the dense
    sweep's backward, its cotangent in scene order."""
    js, ts = _probe_spheres(600)
    jc = jflash.sphere_coefficients(js)
    jcull = jflash.sph_cull_build(js, jc)
    tc = tflash.coefficients_from_numpy(jc)
    tcull = tflash.sph_cull_build(ts, tc)
    ro, rd, time, inside = _sphere_rays(5, 512, np.asarray(js.sph_c0)[1:])
    j_in, t_in = jnp.asarray(inside), torch.as_tensor(inside)
    _compare_sweep(
        lambda c, o, d, tm: jflash.flash_sphere_hit_culled_d(jcull, c, o, d, tm, j_in, TMIN),
        lambda c, o, d, tm: tflash.flash_sphere_hit_culled_d(tcull, c, o, d, tm, t_in, TMIN),
        jc, tc, ro, rd, time, 6)


def _tri_rays(scene, seed, n):
    ro, rd, inside = (np.asarray(a) for a in _rays(scene, seed, n=n, n_nan=8)[:3])
    return ro, rd, inside


def test_tri_vjp_matches_jax(interpret_flash):
    js = tscenes.hybrid_probe(1.0, 4, 300, builder_cls=JSceneBuilder)
    _, jc, _, tc = _builds(js)
    ro, rd, inside = _tri_rays(js, 7, 512)
    j_in, t_in = jnp.asarray(inside), torch.as_tensor(inside)
    g = _compare_sweep(
        lambda c, o, d: jflash.flash_tri_hit_d(c, o, d, j_in, TMIN),
        lambda c, o, d: tflash.flash_tri_hit_d(c, o, d, t_in, TMIN),
        jc, tc, ro, rd, None, 8)
    assert float(g[0].abs().max()) > 0 and float(g[3].abs().max()) > 0


def test_tri_culled_vjp_matches_jax(interpret_flash, mesh_scenes):
    """The stand-in meshes (1,664 triangles): JAX's streamed kernel (its
    differentiable route) against the port's `tri_hit_culled_auto` (B10's
    route), the same winners and cotangents."""
    js, _ = mesh_scenes
    jcull, jc, tcull, tc = _builds(js)
    ro, rd, inside = _tri_rays(js, 9, 512)
    j_in, t_in = jnp.asarray(inside), torch.as_tensor(inside)
    _compare_sweep(
        lambda c, o, d: jflash.flash_tri_hit_culled_d(jcull, c, o, d, j_in, TMIN),
        lambda c, o, d: tflash.flash_tri_hit_culled_d(tcull, c, o, d, t_in, TMIN),
        jc, tc, ro, rd, None, 10)


def test_box_vjp_matches_jax():
    js = _ext_box_scene()
    leaves = _leaves(js)
    names = ("box_lo", "box_hi", "box_cs", "box_off")
    cent = np.asarray(js.box_off) + 0.2
    ro, rd, _, _ = _sphere_rays(11, 512, cent)
    jact = jnp.asarray(leaves["box_active"])
    tact = torch.as_tensor(leaves["box_active"])
    _compare_sweep(
        lambda tabs, o, d: jflash.box_hit_d(*tabs, jact, o, d, TMIN),
        lambda tabs, o, d: tflash.box_hit_d(*tabs, tact, o, d, TMIN),
        tuple(jnp.asarray(leaves[k]) for k in names),
        tuple(torch.as_tensor(leaves[k]) for k in names), ro, rd, None, 12)


def test_nan_lanes_stay_out_of_gradients(mesh_scenes):
    """Dead lanes (NaN rays) and misses carry the placeholder winner 0: their
    zero-weight products must not put NaN into row 0's cotangent. The JAX
    package's own test of this loads the reference's meshes, which are not in
    the repository; here the stand-in meshes (1,664 triangles, through the
    clustered sweep and through the dense one) and random_spheres."""
    _, ts = mesh_scenes
    rs = np.random.default_rng(11)
    n = 256
    dead = torch.as_tensor(np.arange(n) >= n // 2)
    ro, rd, inside = _tri_rays(ts, 13, n)
    ro_t = V3(*(torch.where(dead, float("nan"), torch.as_tensor(ro[:, k])) for k in range(3)))
    rd_t = V3(*(torch.where(dead, float("nan"), torch.as_tensor(rd[:, k])) for k in range(3)))
    ins = torch.as_tensor(inside)

    tri_m = ts.tri_m.clone().requires_grad_(True)
    sc = dataclasses.replace(ts, tri_m=tri_m)
    for route in ("tri", "tri_cull"):
        coeffs = tflash.scene_tri_coefficients(sc)
        tables = coeffs if route == "tri" else tflash.scene_tri_cull(ts)
        t, _ = tflash.tri_hit_d(route, tables, coeffs, ro_t, rd_t, ins, TMIN)
        g, = torch.autograd.grad(torch.where(t < 1e38, t, 0.0).sum(), tri_m)
        assert torch.isfinite(g).all() and float(g.abs().max()) > 0, route

    sph = tscenes.random_spheres(1.0)
    c0 = sph.sph_c0.clone().requires_grad_(True)
    rad = sph.sph_radius.clone().requires_grad_(True)
    time = torch.as_tensor(rs.uniform(0, 1, n).astype(np.float32)).requires_grad_(True)
    cs = tflash.sphere_coefficients(dataclasses.replace(sph, sph_c0=c0, sph_radius=rad))
    ro_s, rd_s, _, _ = _sphere_rays(14, n, sph.sph_c0.numpy()[1:])
    ro_s = V3(*(torch.where(dead, float("nan"), torch.as_tensor(ro_s[:, k])) for k in range(3)))
    rd_s = V3(*(torch.where(dead, float("nan"), torch.as_tensor(rd_s[:, k])) for k in range(3)))
    t, _ = tflash.flash_sphere_hit_d(cs, ro_s, rd_s, time, torch.zeros(n, dtype=torch.int32),
                                     TMIN)
    grads = torch.autograd.grad(torch.where(t < 1e38, t, 0.0).sum(), (c0, rad, time))
    assert all(torch.isfinite(g).all() for g in grads)
    assert float(grads[0].abs().max()) > 0
