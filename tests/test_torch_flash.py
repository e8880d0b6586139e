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
  no arithmetic with the coefficient form;
- the clustered sphere sweeps: `sph_cull_build`'s tables, boxes and
  permutation EQUAL to JAX's (they are selections, a stable sort and a few
  IEEE operations); `flash_sphere_hit_gated` and `_streamed` (plain
  versions) equal to the port's dense sweep to the bit, and against JAX's
  `interpret=True` kernels as the dense sweep is held above. The port gates
  a cluster per RAY, JAX per block of 512 rays, so a grazing ray whose slab
  test fails can miss here what it hits there: such rays are counted and
  must lie within `_sphere_t_slack` of the cluster box (none occurs in these
  cases).
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


def _agree(t_a, i_a, t_b, i_b, slack, max_differ=0.005, tight_share=0.9):
    """Hit sets, winners and t of two sweeps: equal except near-ties; t
    within 1e-5 relative on `tight_share` (90%) of the common hits and within
    the rounding bound `slack(idx, t)` on all."""
    hit_a, hit_b = t_a < INF, t_b < INF
    both = hit_a & hit_b
    same = both & (i_a == i_b)
    err = np.abs(t_a[same] - t_b[same])
    tight = 1e-5 * np.abs(t_b[same]) + 1e-6
    assert (err <= tight).mean() >= tight_share
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


# --------------------------- (c) the clustered sphere sweeps ----------------


def _cull_pair(name, n_sph=700):
    if name == "probe":
        return _sphere_scene(JSceneBuilder, n_sph), _sphere_scene(tscenes.SceneBuilder, n_sph)
    return getattr(jscenes, name)(1.0), getattr(tscenes, name)(1.0)


@pytest.mark.parametrize("name", ["probe", "random_spheres", "book2_final"])
def test_sph_cull_build_equals_jax(name):
    js, ts = _cull_pair(name)
    jc = jflash.sphere_coefficients(js)
    (jcb, jcc), jbounds, jorig, _ = jflash.sph_cull_build(js, jc)
    (tcb, tcc), tbounds, torig = tflash.sph_cull_build(ts, tflash.coefficients_from_numpy(jc))
    assert torig.dtype == torch.int32 and tbounds.dtype == torch.float32
    np.testing.assert_array_equal(torig.numpy(), np.asarray(jorig))
    np.testing.assert_array_equal(tbounds.numpy(), np.asarray(jbounds))
    np.testing.assert_array_equal(tcb.numpy(), np.asarray(jcb))
    np.testing.assert_array_equal(tcc.numpy(), np.asarray(jcc))
    nc = tbounds.shape[1]
    assert tcb.shape == (nc * tflash.SPH_CULL_BLOCK, tflash.SPH_FEATURES)
    assert nc == -(-ts.n_spheres // tflash.SPH_CULL_BLOCK)
    # a permutation, then zero padding
    assert sorted(torig[:ts.n_spheres].tolist()) == list(range(ts.n_spheres))
    assert (torig[ts.n_spheres:] == 0).all() and (tcb[ts.n_spheres:] == 0).all()


def test_sph_cull_build_puts_inactive_spheres_last_and_doubles_blocks():
    import dataclasses

    ts = _sphere_scene(tscenes.SceneBuilder, 300)
    js = _sphere_scene(JSceneBuilder, 300)
    active = np.ones(300, bool)
    active[[4, 17, 130]] = False
    ts = dataclasses.replace(ts, sph_active=torch.as_tensor(active))
    js = dataclasses.replace(js, sph_active=jnp.asarray(active))
    jc = jflash.sphere_coefficients(js)
    tc = tflash.sphere_coefficients(ts)
    for block in (None, 32):
        (_, jcc), jbounds, jorig, _ = jflash.sph_cull_build(js, jc, block)
        (_, tcc), tbounds, torig = tflash.sph_cull_build(ts, tc, block)
        np.testing.assert_array_equal(torig.numpy(), np.asarray(jorig))
        np.testing.assert_array_equal(tbounds.numpy(), np.asarray(jbounds))
        assert sorted(torig[297:300].tolist()) == [4, 17, 130]
    # more than 512 clusters of 128: the block doubles, as in the JAX package
    many = dataclasses.replace(ts, **{
        k: getattr(ts, k).repeat(*([220] + [1] * (getattr(ts, k).dim() - 1)))
        for k in ("sph_c0", "sph_c1", "sph_t0", "sph_t1", "sph_radius", "sph_moving",
                  "sph_mat", "sph_active")})
    (cbp, _), bounds, _ = tflash.sph_cull_build(many, tflash.sphere_coefficients(many))
    assert 300 * 220 > 512 * 128 and cbp.shape[0] // bounds.shape[1] == 256
    assert bounds.shape[1] <= 512


@pytest.mark.parametrize("name,kind", [("probe", "gated"), ("probe", "streamed"),
                                       ("book2_final", "gated"), ("book2_final", "streamed"),
                                       ("random_spheres", "gated"),
                                       ("probe", "seeded"), ("book2_final", "seeded")])
def test_clustered_sweeps_match_dense_and_jax_interpret(name, kind):
    js, ts = _cull_pair(name)
    jc = jflash.sphere_coefficients(js)
    jcull = jflash.sph_cull_build(js, jc)
    tc = tflash.coefficients_from_numpy(jc)
    tcull = tflash.sph_cull_build(ts, tc)
    rs = np.random.default_rng(len(name))
    n = 1024
    ro, rd, time, inside = _rays(rs, n, n_nan=0)
    if name == "book2_final":  # towards the cloud and the large spheres
        ro = rs.uniform(-300, 600, (n, 3)).astype(np.float32)
        aim = np.asarray(js.sph_c0)[rs.integers(0, js.n_spheres, n)]
        rd = aim + rs.normal(0, 8, (n, 3)) - ro
        rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    rd[:6] = np.eye(3, dtype=np.float32)[[0, 1, 2, 0, 1, 2]] * [[1], [1], [1], [-1], [-1], [-1]]
    ro[-7:], rd[-7:] = np.nan, np.nan
    jargs = (_jv3(ro), _jv3(rd), jnp.asarray(time), jnp.asarray(inside), TMIN)
    targs = (_tv3(ro), _tv3(rd), torch.as_tensor(time), torch.as_tensor(inside), TMIN)
    t_d, i_d = tflash.flash_sphere_hit_plain(tc, *targs)
    if kind == "gated":
        t_j, i_j = jflash.flash_sphere_hit_gated(jcull, *jargs, interpret=True)
        t_t, i_t = tflash.flash_sphere_hit_gated(tcull, *targs)
    elif kind == "streamed":
        t_j, i_j = jflash.flash_sphere_hit_streamed(jcull, *jargs, interpret=True)
        t_t, i_t = tflash.flash_sphere_hit_streamed(tcull, *targs)
    else:
        # the streamed sweep from the same seed in both packages: in front of
        # the nearest sphere on a third of the lanes (the seed comes back),
        # behind it on a third (the sphere wins, the seed prunes clusters),
        # none on the rest; every tenth lane that hits nothing has one too
        lane = np.arange(n)
        hit_d = (t_d < INF).numpy()
        t_hit = np.where(hit_d, t_d.numpy(), 1.0)
        front, behind = hit_d & (lane % 3 == 0), hit_d & (lane % 3 == 1)
        lone = ~hit_d & (lane % 10 == 0) & (lane < n - 7)
        seed = np.where(front, 0.8 * t_hit, np.where(behind, 1.2 * t_hit, INF))
        seed = np.where(lone, 50.0, seed).astype(np.float32)
        t_j, i_j = jflash.flash_sphere_hit_streamed(jcull, *jargs, jnp.asarray(seed),
                                                    interpret=True)
        t_t, i_t = tflash.flash_sphere_hit_streamed(tcull, *targs, torch.as_tensor(seed))
        # where the seed comes back it does so in both packages, with index 0
        # in the port (the JAX package leaves that index arbitrary); those
        # lanes then count as misses on both sides and in the dense sweep
        kept_t, kept_j = (t_t.numpy() == seed) & (seed < INF), np.asarray(t_j) == seed
        assert (kept_t != (kept_j & (seed < INF))).mean() <= 0.002
        assert front.sum() > 100 and kept_t[front].all() and kept_t[lone].all()
        assert (i_t.numpy()[kept_t] == 0).all()
        assert behind.sum() > 100 and kept_t[behind].mean() <= 0.002
        gone = torch.as_tensor(kept_t | kept_j)
        t_j, i_j = np.where(gone, INF, t_j).astype(np.float32), np.where(gone, 0, i_j)
        t_t, i_t = torch.where(gone, INF, t_t), torch.where(gone, 0, i_t)
        t_d, i_d = torch.where(gone, INF, t_d), torch.where(gone, 0, i_d)
    assert t_t.dtype == torch.float32 and i_t.dtype == torch.int32
    # the port's dense sweep on the same tables: equal, but for grazing rays
    # that the per-ray gate drops (counted; held to the rounding bound)
    dropped = (t_t != t_d).numpy()
    assert dropped.mean() <= 0.002
    if dropped.any():
        lanes = np.nonzero(dropped)[0]
        assert (t_t.numpy()[lanes] > t_d.numpy()[lanes]).all()
    hit = (t_t < INF).numpy() & ~dropped
    np.testing.assert_array_equal(i_t.numpy()[hit], i_d.numpy()[hit])
    t_j, i_j, t_t, i_t = np.asarray(t_j), np.asarray(i_j), t_t.numpy(), i_t.numpy()
    # book2's spheres of radius 10 lie some 500 from the origin: c cancels to
    # 1e-5 of its terms there, and fewer hits meet the tight bound
    _agree(t_t, i_t, t_j, i_j, lambda lanes, idx, t: _sphere_t_slack(
        jc, ro[lanes], rd[lanes], time[lanes], idx),
        tight_share=0.8 if name == "book2_final" else 0.9)
    assert (t_t[-7:] == np.float32(INF)).all() and (i_t[-7:] == 0).all()
    assert (t_t < INF).sum() > (200 if kind == "seeded" else 300)
    assert (inside[t_t < INF] > 0).any()
    assert (i_t[t_t >= INF] == 0).all()  # a miss reports index 0


def test_streamed_sweep_starts_from_its_seed():
    ts = _sphere_scene(tscenes.SceneBuilder, 700)
    tc = tflash.sphere_coefficients(ts)
    cull = tflash.sph_cull_build(ts, tc)
    rs = np.random.default_rng(9)
    ro, rd, time, inside = _rays(rs, 600)
    args = (_tv3(ro), _tv3(rd), torch.as_tensor(time), torch.as_tensor(inside), TMIN)
    t0, i0 = tflash.flash_sphere_hit_streamed(cull, *args)
    seed = torch.as_tensor(rs.uniform(0.3, 5, 600).astype(np.float32))
    seed[::3] = INF
    t1, i1 = tflash.flash_sphere_hit_streamed(cull, *args, seed)
    nearer = t0 < seed
    assert nearer.sum() > 50 and (~nearer & (t0 < INF)).sum() > 50
    assert torch.equal(t1[nearer], t0[nearer]) and torch.equal(i1[nearer], i0[nearer])
    assert torch.equal(t1[~nearer], seed[~nearer]) and (i1[~nearer] == 0).all()
    with pytest.raises(ValueError, match="t_seed"):
        tflash.flash_sphere_hit_streamed(cull, *args, seed[:5])


def test_clustered_tie_goes_to_the_first_in_morton_order():
    """Three identical spheres: the dense sweep reports the lowest scene
    index; so does the clustered sweep, because equal Morton keys keep their
    scene order (a stable sort). Two table rows with equal coefficients but
    the higher scene index first: the clustered sweep reports the first row."""
    b = tscenes.SceneBuilder()
    b.set_camera([0, 0, 5], [0, 0, 0], [0, 1, 0], 40.0, 1.0, aperture=0.0,
                 focus_dist=5.0, t0=0.0, t1=0.0)
    m = b.lambertian(b.tex_const([0.5, 0.5, 0.5]))
    b.sphere([9, 9, 9], 0.1, m)
    for _ in range(3):
        b.sphere([0, 0, 0], 1.0, m)
    b.sphere([-9, -9, -9], 0.1, m)
    scene = b.build()
    coeffs = tflash.sphere_coefficients(scene)
    (cbp, ccp), bounds, orig_of = tflash.sph_cull_build(scene, coeffs)
    n = 200
    rs = np.random.default_rng(2)
    ro = np.tile(np.array([[0, 0, 5]], np.float32), (n, 1))
    rd = np.concatenate([rs.uniform(-0.1, 0.1, (n, 2)), -np.ones((n, 1))], 1).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    args = (_tv3(ro), _tv3(rd), torch.zeros(n), torch.zeros(n, dtype=torch.int32), TMIN)
    for sweep in (tflash.flash_sphere_hit_gated, tflash.flash_sphere_hit_streamed):
        t, i = sweep(((cbp, ccp), bounds, orig_of), *args)
        assert (t < INF).all() and (i == 1).all()
        rows = [int(r) for r in torch.nonzero((orig_of >= 1) & (orig_of <= 3))[:, 0]][:3]
        swapped = orig_of.clone()
        swapped[rows[0]], swapped[rows[2]] = orig_of[rows[2]], orig_of[rows[0]]
        t2, i2 = sweep(((cbp, ccp), bounds, swapped), *args)
        assert torch.equal(t2, t) and (i2 == 3).all()
