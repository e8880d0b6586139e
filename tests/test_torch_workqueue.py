"""The port's work-queue renderer (`models/integrator.py`, the shade step of
`ops/hybrid.py`, the box sweep of `ops/intersect.py`) against the JAX package's.

Four scenes reach the shade step's modes: earth (an image texture, no outside
set), book2_final (1006 outside spheres through the gated clustered sweep,
400 outside boxes, an image, Perlin, two volumes), `hybrid_probe` (outside
spheres and triangles, 5 candidate rows) and random_spheres (11 rows). The
same inputs go through both packages:

- `box_ts`, `box_record` and `_chunked_min` on seeded rays: the same hit set,
  winner and face, floats to 1e-6 relative (both are a few IEEE operations);
- `_external_candidate`'s rows on book2_final against JAX's with
  `interpret=True`, on rays of the port's own queue;
- one shade step: `shade_step` (plain version, CPU) on lanes captured from the
  port's queue against the JAX shade kernel's body run EAGERLY on the same
  rows, and against the jitted `hybrid._shade_call(interpret=True)`, each
  followed by the texel multiply that JAX's caller does. Eager JAX rounds
  every operation on its own, as the port does: `cont` and `new_inside` must
  be equal on every lane and floats within 1e-6 of the row's scale. The jitted
  kernel contracts a*b+c into fused multiply-adds, so against it at least
  99% of lanes must agree in `cont` and `new_inside`, and on those 97% of the
  floats within 1e-5 and all within 1e-3 of the row's scale (the tolerances
  of tests/test_torch_hybrid.py, where they are derived);
- the queue: `render_workqueue_pixels` against JAX's with `fused_shade=True,
  interpret=True` at 18x18, 4 spp (ray counts within 2e-3, channel means
  within 5e-3, as tests/test_hybrid.py compares JAX's own two shaders), with
  as many lanes as pixels, fewer lanes, and in sample blocks (`chunk`);
- the slice as a whole: `render` of earth and book2_final on the CPU against
  JAX's jitted work queue, statistically.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import miniraytracer_tpu_torch as mrt
from miniraytracer_tpu.models import integrator as jinteg
from miniraytracer_tpu.models import scenes as jscenes
from miniraytracer_tpu.ops import bounce as jbounce
from miniraytracer_tpu.ops import hybrid as jhybrid
from miniraytracer_tpu.ops import intersect as jix
from miniraytracer_tpu.ops.vecmath import V3 as JV3
from miniraytracer_tpu.scene.builder import SceneBuilder as JSceneBuilder
from miniraytracer_tpu_torch.models import integrator as tinteg
from miniraytracer_tpu_torch.models import scenes as tscenes
from miniraytracer_tpu_torch.ops import bounce as tbounce
from miniraytracer_tpu_torch.ops import flash as tflash
from miniraytracer_tpu_torch.ops import hybrid as thybrid
from miniraytracer_tpu_torch.ops import intersect as tix
from miniraytracer_tpu_torch.ops.vecmath import V3

torch.set_num_threads(1)

INF = 3.0e38
MODES = ["earth", "book2_final", "hybrid_probe", "random_spheres"]
W = H = 32  # 1024 lanes: one (8, 128) block of the JAX shade kernel
SQ, BOUNCES = 2, 8


def _pair(name):
    if name == "hybrid_probe":
        return (tscenes.hybrid_probe(1.0, 80, 100, builder_cls=JSceneBuilder),
                tscenes.hybrid_probe(1.0, 80, 100))
    return getattr(jscenes, name)(1.0), getattr(tscenes, name)(1.0)


def _jv3(a):
    return JV3(*(jnp.asarray(np.ascontiguousarray(a[:, k])) for k in range(3)))


def _tv3(a):
    return V3(*(torch.as_tensor(np.ascontiguousarray(a[:, k])) for k in range(3)))


# --------------------------- the box sweep ----------------------------------


def _box_scene(builder_cls):
    """70 boxes, every third rotated about y and moved, one inactive row
    left by padding; over a ground sphere."""
    rs = np.random.RandomState(2)
    b = builder_cls()
    b.set_camera([0, 3, 12], [0, 1, 0], [0, 1, 0], 40.0, 1.0, aperture=0.0,
                 focus_dist=10.0, t0=0.0, t1=0.0)
    m = b.lambertian(b.tex_const([0.5, 0.5, 0.5]))
    b.sphere([0, -1000, 0], 1000, m)
    for i in range(70):
        p = rs.uniform(-5, 5, 3)
        size = rs.uniform(0.3, 1.5, 3)
        if i % 3 == 0:
            b.box([0, 0, 0], size.tolist(), m, rot_y_deg=float(rs.uniform(-40, 40)),
                  offset=p.tolist())
        else:
            b.box(p.tolist(), (p + size).tolist(), m)
    return b.build()


def _box_rays(rs, n, book2):
    """Rays from around (book2: above) the boxes towards them."""
    if book2:  # 400 boxes of 100 x 100 on the floor, up to 101 high
        ro = rs.uniform(-900, 900, (n, 3)).astype(np.float32)
        ro[:, 1] = rs.uniform(120, 400, n)
        target = rs.uniform(-1100, 1100, (n, 3)).astype(np.float32)
        target[:, 1] = rs.uniform(-50, 80, n)
    else:
        ro = rs.uniform(-8, 8, (n, 3)).astype(np.float32)
        target = rs.uniform(-4, 4, (n, 3)).astype(np.float32)
    rd = target - ro
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    rd[:5] = [0, -1, 0]  # axis-parallel: the slab's guarded reciprocal
    rd[5:10] = [1, 0, 0]
    return ro, rd


@pytest.mark.parametrize("name", ["boxes", "book2_final"])
def test_box_sweep_and_record_match_jax(monkeypatch, name):
    if name == "boxes":
        js, ts = _box_scene(JSceneBuilder), _box_scene(tscenes.SceneBuilder)
    else:
        js, ts = _pair(name)
    scale = 1000.0 if name == "book2_final" else 1.0
    rs = np.random.default_rng(12)
    n = 600
    ro, rd = _box_rays(rs, n, name == "book2_final")
    zeros = np.zeros(n, np.float32)
    jrays = jix.Rays(_jv3(ro), _jv3(rd), jnp.asarray(zeros), jnp.zeros(n, jnp.int32))
    trays = tix.Rays(_tv3(ro), _tv3(rd), torch.zeros(n), torch.zeros(n, dtype=torch.int32))
    # a sweep in slices of 32 boxes: the first of equal minima across slices
    monkeypatch.setattr(jix, "CHUNK", 32)
    monkeypatch.setattr(tix, "CHUNK", 32)
    tmax = np.full(n, INF, np.float32)
    tj, ij = jix._chunked_min(
        lambda s, c: jix.box_ts(js, jrays, s, c, 0.001, jnp.asarray(tmax)), js.n_boxes, n)
    tt, it = tix._chunked_min(
        lambda s, c: tix.box_ts(ts, trays, s, c, 0.001, torch.as_tensor(tmax)),
        ts.n_boxes, n, torch.device("cpu"))
    tj, ij = np.asarray(tj), np.asarray(ij)
    assert tt.dtype == torch.float32 and it.dtype == torch.int32
    hit = tj < INF
    assert hit.sum() > 100 and (~hit).sum() > 20
    np.testing.assert_array_equal(tt.numpy() < INF, hit)
    np.testing.assert_array_equal(it.numpy(), ij)
    np.testing.assert_allclose(tt.numpy(), tj, rtol=1e-6)

    # one slice, whole
    whole_j = np.asarray(jix.box_ts(js, jrays, 3, 40, 0.001, jnp.asarray(tmax)))
    whole_t = tix.box_ts(ts, trays, 3, 40, 0.001, torch.as_tensor(tmax)).numpy()
    np.testing.assert_array_equal(whole_t < INF, whole_j < INF)
    np.testing.assert_allclose(whole_t, whole_j, rtol=1e-6)

    safe = np.where(hit, tj, 1.0).astype(np.float32)
    idx = np.where(hit, ij, 0).astype(np.int32)
    rec_j = jix.box_record(js, jrays, jnp.asarray(safe), jnp.asarray(idx))
    rec_t = tix.box_record(ts, trays, torch.as_tensor(safe), torch.as_tensor(idx))
    for a, b in zip(rec_j[:2], rec_t[:2]):  # p, n
        for ca, cb in zip(a, b):
            np.testing.assert_allclose(cb.numpy()[hit], np.asarray(ca)[hit], rtol=1e-6,
                                       atol=1e-6 * scale)
    for a, b in zip(rec_j[2:4], rec_t[2:4]):  # u, v
        np.testing.assert_allclose(b.numpy()[hit], np.asarray(a)[hit], atol=1e-4)
    np.testing.assert_array_equal(rec_t[4].numpy(), np.asarray(rec_j[4]))
    # unit normals along an axis of the box's own frame: six faces seen
    nrm = np.stack([c.numpy()[hit] for c in rec_t[1]], 1)
    np.testing.assert_allclose(np.linalg.norm(nrm, axis=1), 1.0, atol=1e-6)
    assert len({tuple(np.round(v, 3)) for v in nrm}) >= (3 if scale > 1 else 6)


def test_chunked_min_keeps_the_first_of_equal_minima(monkeypatch):
    cand = torch.full((7, 5), INF)
    cand[2, 0] = cand[5, 0] = 1.0  # a tie across slices of 3
    cand[4, 1] = cand[3, 1] = 2.0  # a tie inside a slice
    cand[6, 2] = 0.5
    for chunk in (3, 512):
        monkeypatch.setattr(tix, "CHUNK", chunk)
        t, i = tix._chunked_min(lambda s, c: cand[s:s + c], 7, 5, torch.device("cpu"))
        assert t.tolist()[:3] == [1.0, 2.0, 0.5] and (t[3:] == INF).all()
        assert i.tolist() == [2, 3, 6, 0, 0]


# --------------------------- lanes of the port's queue ----------------------


@pytest.fixture(scope="module")
def captured():
    """{scene name: (jax scene, port scene, ShadeConfig, [(fstate, inside,
    keys_b, ext) at four steps])}: the shade step's inputs in the port's own
    queue at its first, third, middle and third-last step (1024 lanes, 4
    samples a pixel: later steps hold regenerated lanes at depth 0 beside deep
    ones, lanes inside glass, and at the end dead lanes)."""
    out = {}
    plain = thybrid.shade_step_plain
    for name in MODES:
        js, ts = _pair(name)
        calls = []

        def record(cfg, fstate, inside, keys_b, ext):
            calls.append((cfg, fstate, inside, keys_b, ext))
            return plain(cfg, fstate, inside, keys_b, ext)

        thybrid.shade_step_plain = record
        try:
            tinteg.render_workqueue_pixels(ts, W * H, W * H, SQ * SQ, 1000.0, width=W,
                                           height=H, max_bounces=BOUNCES, spp_sq=SQ,
                                           plain=True)
        finally:
            thybrid.shade_step_plain = plain
        assert len(calls) > BOUNCES
        steps = (0, 2, len(calls) // 2, len(calls) - 3)
        out[name] = (js, ts, calls[0][0], [calls[t][1:] for t in steps])
    return out


def _jax_rows(fstate, inside, keys_b, ext):
    return (jnp.asarray(fstate.numpy()), jnp.asarray(inside.numpy()),
            jnp.asarray(keys_b.numpy()).view(jnp.uint32), jnp.asarray(ext.numpy()))


def _with_texels(js, f_out, img_out):
    """The JAX caller's part of the step: beta *= texel where one is pending
    (`make_workqueue_shader`)."""
    f_out = np.array(f_out)
    if img_out is not None:
        pend, comps = jhybrid._texel_rgb(js, jnp.asarray(img_out))
        for r, comp in zip(range(jhybrid.SO_BETA, jhybrid.SO_BETA + 3), comps):
            f_out[r] = np.where(np.asarray(pend), f_out[r] * np.asarray(comp), f_out[r])
    return f_out


def _tile(a):
    return a.reshape(*a.shape[:-1], -1, 128)


def _flat(a):
    a = np.asarray(a)
    return a.reshape(*a.shape[:-2], -1)


class _Out:
    """Stands for an output ref of the JAX kernel body run eagerly."""

    def __setitem__(self, idx, value):
        self.value = value


def _compare_shade(port, f_j, i_j, float_tol, min_agree, typical_tol=None):
    f_t, i_t = port[0].numpy(), port[1].numpy()
    cont_t, cont_j = f_t[thybrid.SO_CONT] > 0, f_j[jhybrid.SO_CONT] > 0
    # p, new_rd and new_inside are defined where the lane goes on
    agree = (cont_t == cont_j) & (~cont_t | (i_t == i_j))
    assert agree.mean() >= min_agree, agree.mean()
    lanes = {r: agree & cont_t for r in range(thybrid.SO_P, thybrid.SO_BETA)}
    for row in range(1, thybrid.SO_NF):
        sel = lanes.get(row, agree)
        scale = max(float(np.abs(f_j[row][sel]).max()), 1.0)
        err = np.abs(f_t[row] - f_j[row])[sel]
        assert err.max() <= float_tol * scale, (row, err.max(), scale)
        if typical_tol is not None:
            assert (err <= typical_tol * scale).mean() >= 0.97, row
    assert (f_t[thybrid.SO_P:thybrid.SO_BETA][:, ~cont_t] == 0).all()
    assert (i_t[~cont_t] == 0).all()
    return cont_t


@pytest.mark.parametrize("name", MODES)
def test_pack_and_accel_equal_jax(captured, name):
    js, ts, cfg, _ = captured[name]
    jmeta, jtabs = jhybrid.pack_scene_hybrid(js)
    assert jmeta == cfg.meta
    assert jhybrid._ext_types(js) == thybrid._ext_types(ts)
    for k in range(8):
        np.testing.assert_array_equal(np.asarray(jtabs[k]), cfg.tables[k].numpy())
    jaccel = jhybrid.hybrid_accel(js, interpret=True)
    accel = thybrid.hybrid_accel(ts)
    assert set(jaccel) == set(accel) == {
        "earth": set(), "book2_final": {"sph_gate"}, "hybrid_probe": {"sph", "tri"},
        "random_spheres": {"sph"}}[name]
    expect = {"earth": (False, True), "book2_final": (False, True),
              "hybrid_probe": (False, False), "random_spheres": (True, False)}
    assert (bool(cfg.meta.get("ext_mat")), cfg.meta["image"]) == expect[name]
    assert tinteg.wq_auto_lanes(ts, 10 ** 6) == jinteg.wq_auto_lanes(js, 10 ** 6)
    assert tinteg.wq_auto_lanes(ts, 300) == 300


@pytest.mark.parametrize("name", MODES)
def test_shade_step_matches_eager_jax_kernel_body(captured, name):
    js, ts, cfg, snaps = captured[name]
    jmeta, jtabs = jhybrid.pack_scene_hybrid(js)
    image = jmeta["image"]
    body = jhybrid._make_shade_kernel(jmeta, image)
    seen = dict(dead=0, inside=0, ext=0, texels=0, cont=0)
    for fstate, inside, keys_b, ext in snaps:
        port = thybrid.shade_step(cfg, fstate, inside, keys_b, ext)
        fo, io, imgo = _Out(), _Out(), _Out()
        # in the kernel's (rows, 128) tiles: its Perlin tables are laid out for them
        body(*jtabs[:7], jtabs[7], jtabs[8],
             *(_tile(a) for a in _jax_rows(fstate, inside, keys_b, ext)),
             fo, io, *([imgo] if image else []))
        img = _flat(imgo.value)[0] if image else None
        f_j = _with_texels(js, _flat(fo.value), img)
        cont = _compare_shade(port, f_j, _flat(io.value), 1e-6, 1.0)
        seen["dead"] += int((fstate[thybrid.SH_ALIVE] == 0).sum())
        seen["inside"] += int((inside > 0).sum())
        seen["ext"] += int((ext[0] < INF).sum())
        seen["cont"] += int(cont.sum())
        if image:
            seen["texels"] += int((img >= 0).sum())
    assert seen["dead"] > 0 and seen["cont"] > 1000
    if name != "earth":
        assert seen["ext"] > 100
    if name in ("book2_final", "hybrid_probe"):
        assert seen["inside"] > 0
    if name in ("earth", "book2_final"):
        assert seen["texels"] > (100 if name == "earth" else 0)


@pytest.mark.parametrize("name", ["hybrid_probe", "random_spheres"])
def test_shade_step_matches_jax_shade_kernel(captured, name):
    """Against the jitted kernel in interpret mode. (earth's and book2's
    interpreted kernels unroll Perlin and the image uv and take minutes to
    compile; the eager body above covers them.)"""
    js, ts, cfg, snaps = captured[name]
    jmeta, jtabs = jhybrid.pack_scene_hybrid(js)
    meta_t = tuple(sorted(jmeta.items()))
    for fstate, inside, keys_b, ext in snaps[:3]:
        port = thybrid.shade_step(cfg, fstate, inside, keys_b, ext)
        f, i, k, e = (_tile(a) for a in _jax_rows(fstate, inside, keys_b, ext))
        f_j, i_j, img = jhybrid._shade_call(meta_t, tuple(jtabs), f, i, k, e,
                                            image=jmeta["image"], interpret=True)
        assert img is None
        _compare_shade(port, _flat(f_j), _flat(i_j), 1e-3, 0.99, typical_tol=1e-5)


def test_external_candidate_on_book2_matches_jax(captured):
    """Gated clustered sphere sweep, box sweep and the three-way tie order,
    on rays of the port's queue (dead lanes NaN inside)."""
    js, ts, cfg, snaps = captured["book2_final"]
    jaccel = jhybrid.hybrid_accel(js, interpret=True)
    accel = thybrid.hybrid_accel(ts)
    kinds, n_same, n_close = set(), 0, 0
    for fstate, inside, _, ext in snaps:
        f = fstate.numpy()
        row = lambda r: jnp.asarray(f[r])
        jrays = jix.Rays(JV3(row(0), row(1), row(2)), JV3(row(3), row(4), row(5)),
                         row(thybrid.SH_TIME), jnp.asarray(inside.numpy()))
        alive = f[thybrid.SH_ALIVE] > 0
        jrows = np.stack([np.asarray(r, np.float32) for r in jhybrid._external_candidate(
            js, jaccel, jrays, jnp.asarray(alive), jbounce.TMIN, True)])
        trows = ext.numpy()
        assert trows.shape == jrows.shape == (thybrid.NE, W * H)
        hit_t, hit_j = trows[0] < INF, jrows[0] < INF
        np.testing.assert_array_equal(hit_t, hit_j)
        assert not hit_t[~alive].any()
        same = hit_t & (trows[4] == jrows[4])
        assert same.sum() >= 0.995 * hit_t.sum()
        n_same += int(same.sum())
        # t as far as the two dots' summation orders allow (tests/test_torch_flash.py:
        # c cancels, here on spheres of radius 10 some 500 away; the boxes' t is
        # a few IEEE operations); normals to 2e-3 where t agrees to 1e-5
        np.testing.assert_allclose(trows[0][same], jrows[0][same], rtol=5e-3, atol=5e-3)
        close = same & (np.abs(trows[0] - jrows[0]) <= 1e-5 * jrows[0])
        n_close += int(close.sum())
        for r in (1, 2, 3):
            np.testing.assert_allclose(trows[r][close], jrows[r][close], atol=2e-3)
        np.testing.assert_array_equal(trows[:, ~hit_t], jrows[:, ~hit_t])
        kinds |= set(trows[4][hit_t].astype(int).tolist())
    assert n_same > 500 and n_close >= 0.8 * n_same
    # winners among the boxes (green) and among the spheres (white cloud, glass)
    box_mat, sph_mats = int(ts.box_mat[0]), set(ts.sph_mat.tolist())
    assert box_mat in kinds and len(kinds & sph_mats) >= 2


# --------------------------- the queue --------------------------------------


def _jax_queue(js, n_pix, lanes, ns, w, h, bounces, **kw):
    offs, _ = jinteg.sample_offsets(ns)
    a, c, r = jinteg.render_workqueue_pixels(
        js, n_pix, lanes, offs, ns, jnp.float32(1e9), width=w, height=h,
        max_bounces=bounces, **kw)
    frame = np.asarray((a * (1.0 / jnp.maximum(c, 1.0))).arr)
    return frame, np.asarray(c), float(r)


def _statistical(frame_t, rays_t, frame_j, rays_j, mean_tol=5e-3, ray_tol=2e-3):
    assert np.isfinite(frame_t).all()
    assert abs(rays_t - rays_j) / max(rays_j, 1.0) < ray_tol, (rays_t, rays_j)
    mt, mj = frame_t.reshape(-1, 3).mean(0), np.asarray(frame_j).reshape(-1, 3).mean(0)
    rel = np.abs(mt - mj) / np.maximum(np.abs(mj), 1e-6)
    assert rel.max() < mean_tol, (mt, mj)


def test_workqueue_matches_jax_fused_shade_interpret():
    """tests/test_hybrid.py's own case: 324 lanes, more than one row of the
    JAX kernel's tiles, with lanes inside glass. Then fewer lanes than
    pixels, and sample blocks: every claim is made, the estimator is the
    same, only the order of accumulation differs."""
    js, ts = _pair("hybrid_probe")
    w = h = 18
    n_pix, ns = w * h, 4
    fj, cj, rj = _jax_queue(js, n_pix, n_pix, ns, w, h, 8, fused_shade=True, interpret=True)
    kw = dict(width=w, height=h, max_bounces=8, spp_sq=2)
    stats = {}
    a, c, r = tinteg.render_workqueue_pixels(ts, n_pix, n_pix, ns, 1e9, stats=stats, **kw)
    assert r.dtype == torch.int64 and stats["steps"] > 8
    np.testing.assert_array_equal(c.numpy(), cj)
    assert int(c.sum()) == n_pix * ns
    ft = (a / c.clamp_min(1)[:, None]).numpy()
    _statistical(ft, int(r), fj, rj)

    # 100 lanes: the same samples, taken by other lanes in another order
    stats_few = {}
    a2, c2, r2 = tinteg.render_workqueue_pixels(ts, n_pix, 100, ns, 1e9, stats=stats_few, **kw)
    assert int(r2) == int(r) and torch.equal(c2, c)
    assert stats_few["steps"] > stats["steps"]
    # every finished lane claims once: the first 100 items and one a sample
    assert stats_few["claimed"] == 100 + n_pix * ns
    np.testing.assert_allclose((a2 / c2.clamp_min(1)[:, None]).numpy(), ft, rtol=1e-5,
                               atol=1e-6)

    # sample blocks of 1 through the public entry point
    f1, s1 = mrt.render_workqueue(ts, w, h, ns, max_bounces=8, max_lum=1e9, n_lanes=n_pix,
                                  device="cpu")
    f3, s3 = mrt.render_workqueue(ts, w, h, ns, max_bounces=8, max_lum=1e9, n_lanes=n_pix,
                                  chunk=1, device="cpu")
    assert s1["rays"] == s3["rays"] == int(r) and s3["steps"] > s1["steps"]
    assert s1["renderer"] == "workqueue" and s1["lanes"] == n_pix
    np.testing.assert_allclose(f1.numpy().reshape(-1, 3), ft, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(f3.numpy(), f1.numpy(), rtol=1e-5, atol=1e-6)


def test_workqueue_clamps_each_sample_and_drops_nothing_finite():
    ts = tscenes.hybrid_probe(1.0, 80, 0)
    kw = dict(width=12, height=12, max_bounces=6, spp_sq=2)
    a, c, _ = tinteg.render_workqueue_pixels(ts, 144, 144, 4, 1e9, **kw)
    b, c2, _ = tinteg.render_workqueue_pixels(ts, 144, 144, 4, 0.05, **kw)
    assert torch.equal(c, c2) and int(c.sum()) == 144 * 4
    lum = lambda x: 0.212655 * x[:, 0] + 0.715158 * x[:, 1] + 0.072187 * x[:, 2]
    assert float(lum(b).max()) <= 4 * 0.05 * (1 + 1e-5) and float(lum(a).max()) > 4 * 0.05
    # the shading in tensor operations (`_shade_and_advance` over `make_accel`)
    # runs the same physics in the same order as the shade step's plain
    # version: the same steps, claims, rays and frame
    stats, stats_e = {}, {}
    a2, c2, r2 = tinteg.render_workqueue_pixels(ts, 144, 144, 4, 1e9, stats=stats, **kw)
    e, ce, re_ = tinteg.render_workqueue_pixels(ts, 144, 144, 4, 1e9, fused_shade=False,
                                                stats=stats_e, **kw)
    assert stats == stats_e and int(re_) == int(r2) and torch.equal(ce, c2)
    assert torch.equal(e, a2)


@pytest.mark.parametrize("name,size,spp,bounces", [("earth", 14, 4, 8),
                                                   ("book2_final", 14, 4, 8)])
def test_render_routes_to_the_workqueue_and_matches_jax(name, size, spp, bounces):
    """The slice as a whole, on the CPU: `render` picks the work queue, the
    plain versions run (no launch is counted), and the frame agrees with the
    JAX package's jitted work queue (its shading in XLA) statistically: ray
    counts within 2%, channel means within 2% (196 pixels of 4 samples; a
    pixel in a hundred takes another path under the oracle's fused
    multiply-adds)."""
    js, ts = _pair(name)
    assert mrt.pick_renderer(ts) == "workqueue"
    launches = (thybrid.shade_launches, tflash.gated_launches, tflash.streamed_launches)
    frame, stats = mrt.render(ts, size, size, spp, max_bounces=bounces, device="cpu")
    assert launches == (thybrid.shade_launches, tflash.gated_launches,
                        tflash.streamed_launches)
    assert stats["renderer"] == "workqueue" and frame.shape == (size, size, 3)
    assert stats["lanes"] == size * size and stats["claimed"] == size * size * (spp + 1)
    fj, sj = jinteg.render_workqueue(js, size, size, spp, max_bounces=bounces,
                                     fused_shade=False)
    _statistical(frame.numpy(), stats["rays"], np.asarray(fj), sj["rays"], mean_tol=0.02,
                 ray_tol=0.02)


def test_streamed_tier_renders_through_the_queue():
    """4200 spheres: the rule picks the work queue and `hybrid_accel` the
    streamed clustered sweep."""
    scene = tscenes.hybrid_probe(1.0, 4200, 0)
    assert mrt.pick_renderer(scene) == "workqueue"
    assert set(thybrid.hybrid_accel(scene)) == {"sph_cull"}
    frame, stats = mrt.render(scene, 10, 10, 1, max_bounces=4, device="cpu")
    assert stats["renderer"] == "workqueue" and torch.isfinite(frame).all()
    assert stats["rays"] >= 100
