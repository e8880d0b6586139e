"""The port's dense nearest-hit sweeps (`ops/flash.py`) against the JAX package's.

Same inputs, made from a numpy seed, go through both packages:

- the coefficient tables and the ray features must agree to 1e-6 of each
  row's scale (they are a few multiplications and additions; XLA and torch
  may round a product of sums differently in the last place);
- `flash_*_hit_plain` against JAX `flash_*_hit(interpret=True)` on the SAME
  coefficient tables (JAX's, carried over as numpy): the same hit set and the
  same winner except on near-ties (at most 0.5% of rays), and t to 1e-5
  relative on at least 90% of the common hits. On the rest t may differ by
  what the sums' rounding allows: XLA:CPU's dot sums in an order of its own
  (and with fused multiply-adds), the port term by term, and
  c = |ro|^2 - 2 ro.P + |P|^2 - r^2 cancels, so c carries an error of a few
  ulps of its largest term (the triangle's det, uu, vv, tn likewise). For a
  sphere that moves t by dc/(2 sqrt(disc)) + db (1 + |b|/sqrt(disc)), large at
  a grazing hit; `_sphere_t_slack` computes that bound per ray in float64.
  For a triangle t = tn/det moves by (dtn + t ddet)/det;
- the plain versions against a componentwise sweep written here
  (Moller-Trumbore, the sphere quadratic on oc = ro - centre), which shares
  no arithmetic with the coefficient form.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miniraytracer_tpu.models import scenes as jscenes
from miniraytracer_tpu.ops import flash as jflash
from miniraytracer_tpu.ops.vecmath import V3 as JV3
from miniraytracer_tpu.scene.builder import SceneBuilder as JSceneBuilder
from miniraytracer_tpu_torch.models import scenes as tscenes
from miniraytracer_tpu_torch.ops import flash as tflash
from miniraytracer_tpu_torch.ops.vecmath import V3

torch.set_num_threads(1)

INF = 3.0e38
TMIN = 0.001


def _jv3(a):
    return JV3(jnp.asarray(a[:, 0]), jnp.asarray(a[:, 1]), jnp.asarray(a[:, 2]))


def _tv3(a):
    return V3(*(torch.as_tensor(np.ascontiguousarray(a[:, k])) for k in range(3)))


def _rays(rs, n, origin_scale=6.0, n_nan=7):
    """n rays from random origins towards the scene's middle; some inside a
    medium, the last `n_nan` NaN (dead lanes)."""
    ro = rs.uniform(-origin_scale, origin_scale, (n, 3)).astype(np.float32)
    ro[:, 1] = np.abs(ro[:, 1]) + 0.3
    target = rs.uniform(-3, 3, (n, 3)).astype(np.float32)
    rd = target - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    rd = rd.astype(np.float32)
    time = rs.random(n, dtype=np.float32)
    inside = (rs.random(n) < 0.3).astype(np.int32) * rs.integers(1, 3, n).astype(np.int32)
    if n_nan:
        ro[-n_nan:] = np.nan
        rd[-n_nan:] = np.nan
    return ro, rd, time, inside


def _sphere_scene(builder_cls, n_sph, seed=3):
    """n_sph spheres (not a multiple of 128): a radius-1000 ground, moving
    spheres, a hollow shell (negative radius), small and large radii."""
    rs = np.random.RandomState(seed)
    b = builder_cls()
    b.set_camera([0, 3, 12], [0, 1, 0], [0, 1, 0], 40.0, 1.0, aperture=0.0,
                 focus_dist=10.0, t0=0.0, t1=1.0)
    m = b.lambertian(b.tex_const([0.5, 0.5, 0.5]))
    b.sphere([0, -1000, 0], 1000, m)
    b.sphere([1, 1, 0], 1.0, m)
    b.sphere([1, 1, 0], -0.9, m)
    for i in range(n_sph - 3):
        p = rs.uniform(-5, 5, 3)
        p[1] = rs.uniform(0.2, 3)
        r = rs.uniform(0.1, 0.5)
        if i % 3 == 0:
            b.sphere(p.tolist(), r, m, center1=(p + [0, rs.uniform(0.1, 0.6), 0]).tolist(),
                     t0=0.0, t1=1.0)
        else:
            b.sphere(p.tolist(), r, m)
    return b.build()


EPS32 = float(np.finfo(np.float32).eps)


def _sphere_t_slack(coeffs, ro, rd, time, idx):
    """Per ray, how far t of sphere `idx` may move when b and c each carry
    8 ulps of the largest term of their sum (see the module docstring)."""
    cb, cc = (np.asarray(c, np.float64)[idx] for c in coeffs)
    f = np.asarray(jflash.sphere_ray_features(_jv3(ro), _jv3(rd), jnp.asarray(time)),
                   np.float64).T
    b, c = (cb * f).sum(1), (cc * f).sum(1)
    db = 8 * EPS32 * np.abs(cb * f).max(1)
    dc = 8 * EPS32 * np.abs(cc * f).max(1)
    sq = np.sqrt(np.maximum(b * b - c, 1e-12))
    return dc / (2 * sq) + db * (1 + np.abs(b) / sq)


def _tri_t_slack(coeffs, ro, rd, idx, t):
    c_det, _, _, c_tn = (np.asarray(c, np.float64)[idx] for c in coeffs)
    f = np.asarray(jflash.ray_features(_jv3(ro), _jv3(rd)), np.float64).T
    det = (c_det * f).sum(1)
    ddet = 8 * EPS32 * np.abs(c_det * f).max(1)
    dtn = 8 * EPS32 * np.abs(c_tn * f).max(1)
    return (dtn + np.abs(t) * ddet) / np.maximum(np.abs(det), 1e-12)


def _agree(t_a, i_a, t_b, i_b, slack, max_differ=0.005):
    """Hit sets, winners and t of two sweeps: equal except near-ties; t
    within 1e-5 relative on 90% of the common hits and within the rounding
    bound `slack(idx, t)` on all."""
    hit_a, hit_b = t_a < INF, t_b < INF
    both = hit_a & hit_b
    same = both & (i_a == i_b)
    err = np.abs(t_a[same] - t_b[same])
    tight = 1e-5 * np.abs(t_b[same]) + 1e-6
    assert (err <= tight).mean() >= 0.9
    lanes = np.nonzero(same)[0]
    assert (err <= tight + slack(lanes, i_b[same], t_b[same])).all()
    differ = (hit_a != hit_b) | (both & (i_a != i_b))
    assert differ.mean() <= max_differ, differ.mean()
    # where the winners differ, both surfaces lie at nearly the same t
    swap = both & (i_a != i_b)
    np.testing.assert_allclose(t_a[swap], t_b[swap], rtol=1e-3, atol=1e-3)
    assert same.sum() > 0.2 * len(t_a)


# --------------------------- (a) tables and features ----------------------


def _assert_rows_close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype == np.float32
    scale = np.maximum(np.abs(a).max(axis=-1, keepdims=True), 1e-30)
    assert (np.abs(a - b) <= 1e-6 * scale).all()


def test_tri_coefficients_and_features_equal_jax():
    rs = np.random.default_rng(0)
    T = 203
    m, u, v = (rs.normal(size=(T, 3)).astype(np.float32) * s for s in (4, 1, 1))
    active = rs.random(T) < 0.9
    jc = jflash.tri_coefficients(_jv3(m), _jv3(u), _jv3(v), jnp.asarray(active))
    tc = tflash.tri_coefficients(_tv3(m), _tv3(u), _tv3(v), torch.as_tensor(active))
    for a, b in zip(jc, tc):
        _assert_rows_close(a, b.numpy())
        assert (b.numpy()[~active] == 0).all()
    ro, rd, _, _ = _rays(rs, 301, n_nan=0)
    _assert_rows_close(np.asarray(jflash.ray_features(_jv3(ro), _jv3(rd))).T,
                       tflash.ray_features(_tv3(ro), _tv3(rd)).numpy().T)


def test_sphere_coefficients_and_features_equal_jax():
    js = _sphere_scene(JSceneBuilder, 150)
    ts = _sphere_scene(tscenes.SceneBuilder, 150)
    for a, b in zip(jflash.sphere_coefficients(js), tflash.sphere_coefficients(ts)):
        assert b.shape == (150, tflash.SPH_FEATURES)
        _assert_rows_close(a, b.numpy())
        assert (b.numpy()[:, tflash.SPH_USED:] == 0).all()
    rs = np.random.default_rng(1)
    ro, rd, time, _ = _rays(rs, 301, n_nan=0)
    _assert_rows_close(
        np.asarray(jflash.sphere_ray_features(_jv3(ro), _jv3(rd), jnp.asarray(time))).T,
        tflash.sphere_ray_features(_tv3(ro), _tv3(rd), torch.as_tensor(time)).numpy().T)


def test_random_spheres_coefficients_equal_jax():
    """The scene of the main path: 486 spheres, 242 of them moving."""
    jc = jflash.sphere_coefficients(jscenes.random_spheres(1.0))
    tc = tflash.sphere_coefficients(tscenes.random_spheres(1.0))
    for a, b in zip(jc, tc):
        _assert_rows_close(a, b.numpy())


# --------------------------- (b) the sweeps ---------------------------------


@pytest.mark.parametrize("n_sph", [70, 150, 300])
def test_sphere_sweep_matches_jax_interpret(n_sph):
    js = _sphere_scene(JSceneBuilder, n_sph)
    jc = jflash.sphere_coefficients(js)
    # one inactive row, as padding leaves it
    cc = np.array(jc[1])
    cc[5, 0] += INF * 0.5
    jc = (jc[0], jnp.asarray(cc))
    rs = np.random.default_rng(n_sph)
    ro, rd, time, inside = _rays(rs, 517)
    t_j, i_j = jflash.flash_sphere_hit(jc, _jv3(ro), _jv3(rd), jnp.asarray(time),
                                       jnp.asarray(inside), TMIN, interpret=True)
    tc = tflash.coefficients_from_numpy(jc)
    t_t, i_t = tflash.flash_sphere_hit(tc, _tv3(ro), _tv3(rd), torch.as_tensor(time),
                                       torch.as_tensor(inside), TMIN)
    assert t_t.dtype == torch.float32 and i_t.dtype == torch.int32
    t_j, i_j, t_t, i_t = np.asarray(t_j), np.asarray(i_j), t_t.numpy(), i_t.numpy()
    _agree(t_t, i_t, t_j, i_j, lambda lanes, idx, t: _sphere_t_slack(
        jc, ro[lanes], rd[lanes], time[lanes], idx))
    assert (t_t[-7:] == np.float32(INF)).all() and (i_t[-7:] == 0).all()
    assert not (i_t[t_t < INF] == 5).any()  # the inactive row never wins
    assert (inside[t_t < INF] > 0).any()


@pytest.mark.parametrize("n_tri", [65, 203, 700])
def test_tri_sweep_matches_jax_interpret(n_tri):
    js = tscenes.hybrid_probe(1.0, 4, n_tri, builder_cls=JSceneBuilder)
    cols = lambda t: _jv3(np.asarray(t))
    active = np.asarray(js.tri_active).copy()
    active[3] = False
    jc = jflash.tri_coefficients(cols(js.tri_m), cols(js.tri_u), cols(js.tri_v),
                                 jnp.asarray(active))
    rs = np.random.default_rng(n_tri)
    ro, rd, _, inside = _rays(rs, 517)
    # aim most rays at a triangle's centroid, so that they hit something
    pick = rs.integers(0, n_tri, 400)
    aim = (np.asarray(js.tri_m) + (np.asarray(js.tri_u) + np.asarray(js.tri_v)) / 3)[pick]
    rd[:400] = aim - ro[:400]
    rd[:400] /= np.linalg.norm(rd[:400], axis=1, keepdims=True)
    t_j, i_j = jflash.flash_tri_hit(jc, _jv3(ro), _jv3(rd), jnp.asarray(inside), TMIN,
                                    interpret=True)
    tc = tflash.coefficients_from_numpy(jc)
    t_t, i_t = tflash.flash_tri_hit(tc, _tv3(ro), _tv3(rd), torch.as_tensor(inside), TMIN)
    t_j, i_j, t_t, i_t = np.asarray(t_j), np.asarray(i_j), t_t.numpy(), i_t.numpy()
    hit = t_t < INF
    _agree(t_t, i_t, t_j, i_j, lambda lanes, idx, t: _tri_t_slack(
        jc, ro[lanes], rd[lanes], idx, t))
    assert (inside[hit] > 0).any()
    assert (t_t[-7:] == np.float32(INF)).all() and (i_t[-7:] == 0).all()
    assert not (i_t[hit] == 3).any()


def _componentwise_spheres(scene, ro, rd, time, inside):
    """Nearest sphere by the quadratic on oc = ro - centre, in float64."""
    c0, c1 = scene.sph_c0.numpy().astype(np.float64), scene.sph_c1.numpy().astype(np.float64)
    t0, t1 = scene.sph_t0.numpy(), scene.sph_t1.numpy()
    mov, rad = scene.sph_moving.numpy() > 0, scene.sph_radius.numpy().astype(np.float64)
    f = np.where(mov[:, None], (time[None, :] - t0[:, None]) / np.where(mov, t1 - t0, 1)[:, None], 0)
    cen = c0[:, None, :] + f[:, :, None] * (c1 - c0)[:, None, :]
    oc = ro[None].astype(np.float64) - cen
    b = (oc * rd[None]).sum(-1)
    c = (oc * oc).sum(-1) - (rad * rad)[:, None]
    disc = b * b - c
    sq = np.sqrt(np.maximum(disc, 0))
    front, back = -b - sq, -b + sq
    ok = disc > 0
    cand = np.where(ok & (front > TMIN), front,
                    np.where(ok & (inside[None] > 0) & (back > TMIN), back, np.inf))
    cand = np.where(np.isnan(cand), np.inf, cand)
    return cand.min(0), cand.argmin(0)


def test_sphere_sweep_matches_componentwise():
    scene = _sphere_scene(tscenes.SceneBuilder, 150)
    rs = np.random.default_rng(5)
    ro, rd, time, inside = _rays(rs, 700)
    t_t, i_t = tflash.flash_sphere_hit_plain(
        tflash.sphere_coefficients(scene), _tv3(ro), _tv3(rd), torch.as_tensor(time),
        torch.as_tensor(inside), TMIN)
    t_c, i_c = _componentwise_spheres(scene, ro, rd, time, inside)
    t_c = np.where(np.isfinite(t_c), t_c, INF)
    hit_t, hit_c = t_t.numpy() < INF, t_c < INF
    # the coefficient form loses digits on the radius-1000 ground (its c is a
    # difference of numbers near 1e6): t to 1e-3 absolute there
    assert (hit_t != hit_c).mean() <= 0.01
    same = hit_t & hit_c & (i_t.numpy() == i_c)
    assert same.sum() >= 0.98 * (hit_t & hit_c).sum()
    np.testing.assert_allclose(t_t.numpy()[same], t_c[same], rtol=2e-4, atol=2e-3)


def test_tri_sweep_matches_componentwise():
    scene = tscenes.hybrid_probe(1.0, 4, 300)
    rs = np.random.default_rng(6)
    ro, rd, _, inside = _rays(rs, 700)
    t_t, i_t = tflash.flash_tri_hit_plain(
        tflash.scene_tri_coefficients(scene), _tv3(ro), _tv3(rd), torch.as_tensor(inside), TMIN)
    m, u, v = (a.numpy().astype(np.float64)[:, None, :] for a in
               (scene.tri_m, scene.tri_u, scene.tri_v))
    o, d = ro[None].astype(np.float64), rd[None].astype(np.float64)
    pvec = np.cross(d, v)
    det = (u * pvec).sum(-1)
    sign = np.where((inside[None] > 0) & (det < 0), -1.0, 1.0)
    tvec = o - m
    uu = (tvec * pvec).sum(-1) * sign
    qvec = np.cross(tvec, u)
    vv = (d * qvec).sum(-1) * sign
    with np.errstate(all="ignore"):
        t = (v * qvec).sum(-1) / det
    sdet = det * sign
    valid = (sdet >= 1e-5) & (uu >= 0) & (vv >= 0) & (uu + vv <= sdet) & (t >= TMIN)
    cand = np.where(valid, t, np.inf)
    t_c, i_c = cand.min(0), cand.argmin(0)
    hit_t, hit_c = t_t.numpy() < INF, np.isfinite(t_c)
    assert (hit_t != hit_c).mean() <= 0.005
    same = hit_t & hit_c & (i_t.numpy() == i_c)
    assert same.sum() >= 0.99 * (hit_t & hit_c).sum() and same.sum() > 20
    np.testing.assert_allclose(t_t.numpy()[same], t_c[same], rtol=1e-4, atol=1e-4)


def test_lowest_index_wins_a_tie_and_chunks_do_not_matter(monkeypatch):
    """Two identical spheres: the lower index wins. The plain sweep's result
    does not depend on how it slices the rays."""
    b = tscenes.SceneBuilder()
    b.set_camera([0, 0, 5], [0, 0, 0], [0, 1, 0], 40.0, 1.0, aperture=0.0,
                 focus_dist=5.0, t0=0.0, t1=0.0)
    m = b.lambertian(b.tex_const([0.5, 0.5, 0.5]))
    b.sphere([9, 9, 9], 0.1, m)
    for _ in range(3):
        b.sphere([0, 0, 0], 1.0, m)
    scene = b.build()
    coeffs = tflash.sphere_coefficients(scene)
    rs = np.random.default_rng(2)
    n = 300
    ro = np.tile(np.array([[0, 0, 5]], np.float32), (n, 1))
    rd = np.concatenate([rs.uniform(-0.1, 0.1, (n, 2)), -np.ones((n, 1))], 1).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    args = (_tv3(ro), _tv3(rd), torch.zeros(n), torch.zeros(n, dtype=torch.int32), TMIN)
    t1, i1 = tflash.flash_sphere_hit_plain(coeffs, *args)
    assert (t1 < INF).all() and (i1 == 1).all()
    monkeypatch.setattr(tflash, "PLAIN_RAY_CHUNK", 64)
    t2, i2 = tflash.flash_sphere_hit_plain(coeffs, *args)
    assert torch.equal(t1, t2) and torch.equal(i1, i2)


def test_wrappers_check_their_arguments():
    coeffs = tflash.sphere_coefficients(_sphere_scene(tscenes.SceneBuilder, 70))
    z = torch.zeros(5)
    with pytest.raises(ValueError, match="shape"):
        tflash.flash_sphere_hit(coeffs, V3(z, z, z), V3(z, z, z[:4]), z,
                                torch.zeros(5, dtype=torch.int32), TMIN)
    with pytest.raises(ValueError, match="device"):
        tflash.flash_sphere_hit(coeffs, V3(z, z, z), V3(z, z, z), z,
                                torch.zeros(5, dtype=torch.int32, device="meta"), TMIN)
