"""The port's clustered triangle sweeps (`ops/flash.py`: `tri_cull_build`,
`flash_tri_hit_culled` / `_resident` / `_streamed`) and the triangles scene
through them, against the JAX package's.

The mesh is the triangles scene with small stand-in meshes
(`scenes.write_stand_in_meshes`: an icosphere of 1,280 and a torus of 384
triangles, 1,664 in all, 26 clusters of 64), or `hybrid_probe` with 1,100
scattered triangles. Inputs come from numpy seeds and go through both
packages:

- `tri_cull_build`: tables, boxes, `orig_of` and `cl_ord` EQUAL to JAX's
  (selections, stable sorts and a few IEEE operations), inactive rows
  included; `_ray_sort_key` equal to JAX's, with and without `dir_key`;
- the plain versions of B10 and B11 against the port's dense sweep on the
  same tables: the same hit set, t EQUAL to the bit where both hit (the pairs
  are the same sums in the same order), equal winners where t is unique
  (of two triangles at one t the clustered sweep keeps the first it visits);
  seeded lanes that nothing beats return the seed exactly, with index 0;
- against JAX `flash_tri_hit_resident` / `_streamed(interpret=True)`: the same
  hit set, winners equal where t is unique, and the seed kept on the same
  lanes. t only within the rounding bound of tests/test_torch_flash.py's
  `_tri_t_slack`: XLA's dot sums the 16 terms in an order of its own, and
  fewer than half of the t are equal to the bit (the JAX package's own dense
  sweep differs from the port's as much);
- B9's plain version against JAX `flash_tri_hit_culled(interpret=True)`, both
  ways of `sort_rays`, at JAX's own bound (test_flash.py:318-326: 99.5% of
  hits and winners agree);
- a flat, axis-aligned cluster: a grid of quads on y = 0 is gated out for
  every ray by JAX's resident and culled sweeps and by the port's, while both
  dense sweeps find its hits (ROADMAP.md, queue C);
- whole renders of the triangles scene at 16x16, 4 spp, 5 bounces: the work
  queue with its shading in tensor operations and `render_wavefront` against
  JAX's run eagerly (`jax.disable_jit()`) with its "tri_cull" entry (its
  resident sweep in interpret mode); the work queue with the shade step
  against JAX's jitted queue with `fused_shade=True, interpret=True`. Steps,
  claims, sample counts and rays EQUAL, frames within 1e-5 (the sweeps' t
  differ by rounding, see above, and no path turns on it at this size).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import miniraytracer_tpu_torch as mrt
from miniraytracer_tpu.models import integrator as jinteg
from miniraytracer_tpu.models import scenes as jscenes
from miniraytracer_tpu.ops import flash as jflash
from miniraytracer_tpu.ops import intersect as jix
from miniraytracer_tpu.ops.vecmath import V3 as JV3
from miniraytracer_tpu.scene.builder import SceneBuilder as JSceneBuilder
from miniraytracer_tpu_torch.models import integrator as tinteg
from miniraytracer_tpu_torch.models import scenes as tscenes
from miniraytracer_tpu_torch.ops import flash as tflash
from miniraytracer_tpu_torch.ops import hybrid as thybrid
from miniraytracer_tpu_torch.ops import intersect as tix
from miniraytracer_tpu_torch.ops.vecmath import V3
from tests.test_torch_flash import _tri_t_slack

torch.set_num_threads(1)

INF = 3.0e38
TMIN = 0.001
W = H = 16
SPP, BOUNCES = 4, 5


@pytest.fixture(scope="module")
def mesh_scenes(tmp_path_factory):
    """(JAX scene, port scene) of `triangles` with the small stand-in meshes."""
    assets = str(tscenes.write_stand_in_meshes(tmp_path_factory.mktemp("assets"),
                                               bunny_subdiv=3, torus_segments=(16, 12)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MRT_ASSETS", assets)
        mp.setattr(jscenes, "ASSET_DIR", assets)
        js, ts = jscenes.triangles(1.0), tscenes.triangles(1.0)
    assert ts.n_tris == js.n_tris == 1280 + 384
    return js, ts


def _pair(name, mesh_scenes):
    if name == "hybrid_probe":
        return (tscenes.hybrid_probe(1.0, 4, 1100, builder_cls=JSceneBuilder),
                tscenes.hybrid_probe(1.0, 4, 1100))
    return mesh_scenes


def _cols(scene, active=None):
    a = np.asarray(scene.tri_active) if active is None else active
    cols = lambda t: np.asarray(t)
    return cols(scene.tri_m), cols(scene.tri_u), cols(scene.tri_v), a


def _jv3(a):
    return JV3(*(jnp.asarray(np.ascontiguousarray(a[:, k])) for k in range(3)))


def _tv3(a):
    return V3(*(torch.as_tensor(np.ascontiguousarray(a[:, k])) for k in range(3)))


def _builds(scene, active=None):
    """(JAX cull, JAX coefficient tables, port cull, port tables): the port's
    cull built from JAX's tables carried over, so that both sweep the same
    rows."""
    m, u, v, act = _cols(scene, active)
    jc = jflash.tri_coefficients(_jv3(m), _jv3(u), _jv3(v), jnp.asarray(act))
    jcull = jflash.tri_cull_build(_jv3(m), _jv3(u), _jv3(v), jnp.asarray(act), jc)
    tc = tflash.coefficients_from_numpy(jc)
    tcull = tflash.tri_cull_build(_tv3(m), _tv3(u), _tv3(v), torch.as_tensor(act), tc)
    return jcull, jc, tcull, tc


def _rays(scene, seed, n=2048, n_nan=7):
    """The ray set of test_flash.py:329-425 (origins over the Cornell box and
    in front of it, uniform directions, a fifth inside a medium), half of it
    aimed at the triangles' centroids, the last `n_nan` NaN (dead lanes)."""
    rs = np.random.default_rng(seed)
    ro = np.stack([rs.uniform(50, 500, n), rs.uniform(-50, 500, n),
                   rs.uniform(-600, 500, n)], 1).astype(np.float32)
    rd = rs.standard_normal((n, 3)).astype(np.float32)
    m, u, v, _ = _cols(scene)
    aim = (m + (u + v) / 3)[rs.integers(0, m.shape[0], n // 2)]
    rd[: n // 2] = aim - ro[: n // 2]
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    inside = (rs.uniform(size=n) < 0.2).astype(np.int32)
    if n_nan:
        ro[-n_nan:], rd[-n_nan:] = np.nan, np.nan
    return ro, rd, inside


def _unique_t(coeffs, ro, rd, inside, t):
    """Per ray: whether exactly one triangle has the nearest hit t."""
    f = tflash.ray_features(_tv3(ro), _tv3(rd))
    cand = tflash._tri_candidates(coeffs, f, torch.as_tensor(inside), TMIN)
    return ((cand == torch.as_tensor(t)[None, :]).sum(0) == 1).numpy()


# --------------------------- the cluster build ------------------------------


@pytest.mark.parametrize("name", ["stand_in", "hybrid_probe"])
def test_tri_cull_build_equals_jax(mesh_scenes, name):
    _, ts = _pair(name, mesh_scenes)
    act = np.asarray(ts.tri_active).copy()
    act[[3, 400, ts.n_tris - 1]] = False  # inactive rows: last, inverted boxes
    jcull, _, tcull, _ = _builds(ts, act)
    (cds, bounds, orig_of, cl_ord), (jcds, jbounds, jorig, jord) = tcull, jcull[:4]
    for a, b in zip(jcds, cds):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(bounds.numpy(), np.asarray(jbounds))
    np.testing.assert_array_equal(orig_of.numpy(), np.asarray(jorig))
    np.testing.assert_array_equal(cl_ord.numpy(), np.asarray(jord))
    assert orig_of.dtype == cl_ord.dtype == torch.int32 and bounds.shape == (8, cl_ord.shape[1])
    nc = bounds.shape[1]
    assert cds[0].shape == (nc * tflash.TRI_CULL_BLOCK, 16) and nc == -(-ts.n_tris // 64)
    live = ts.n_tris - 3
    assert sorted(orig_of[:live].tolist()) == sorted(set(range(ts.n_tris)) - {3, 400, ts.n_tris - 1})
    assert (cds[0][ts.n_tris:] == 0).all()
    for o in range(8):  # each octant's order is a permutation of the clusters
        assert sorted(cl_ord[o].tolist()) == list(range(nc))


def test_tri_cull_build_doubles_its_block_past_512_clusters():
    rs = np.random.default_rng(3)
    n = 512 * 64 + 5
    m = rs.uniform(-10, 10, (n, 3)).astype(np.float32)
    u, v = (rs.uniform(-0.1, 0.1, (n, 3)).astype(np.float32) for _ in range(2))
    cds, bounds, orig_of, cl_ord = tflash.tri_cull_build(
        _tv3(m), _tv3(u), _tv3(v), torch.ones(n, dtype=torch.bool),
        tflash.tri_coefficients(_tv3(m), _tv3(u), _tv3(v), torch.ones(n, dtype=torch.bool)))
    assert cds[0].shape[0] // bounds.shape[1] == 128 and bounds.shape[1] <= 512
    assert cl_ord.shape == (8, bounds.shape[1])


@pytest.mark.parametrize("dir_key", [False, True])
def test_ray_sort_key_equals_jax(mesh_scenes, dir_key):
    _, ts = mesh_scenes
    jcull, _, tcull, _ = _builds(ts)
    ro, rd, _ = _rays(ts, 5, n_nan=0)
    jk = jflash._ray_sort_key(_jv3(ro), _jv3(rd), jcull[1], dir_key=dir_key)
    tk = tflash._ray_sort_key(_tv3(ro), _tv3(rd), tcull[1], dir_key=dir_key)
    assert tk.dtype == torch.int64
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk).astype(np.int64))
    # a NaN ray sorts after every real one, on any device
    ro[:3], rd[3:6, 1] = np.nan, np.nan
    tk = tflash._ray_sort_key(_tv3(ro), _tv3(rd), tcull[1], dir_key=dir_key)
    assert (tk[:6] == tflash.DEAD_RAY_KEY).all() and (tk[6:] < tflash.DEAD_RAY_KEY).all()


# --------------------------- the sweeps -------------------------------------


@pytest.mark.parametrize("kind", ["resident", "streamed"])
@pytest.mark.parametrize("name", ["stand_in", "hybrid_probe"])
def test_seeded_sweeps_match_dense_and_jax_interpret(mesh_scenes, name, kind):
    _, ts = _pair(name, mesh_scenes)
    jcull, jc, tcull, tc = _builds(ts)
    ro, rd, inside = _rays(ts, 11 if kind == "resident" else 13)
    n = ro.shape[0]
    jargs = (_jv3(ro), _jv3(rd), jnp.asarray(inside), TMIN)
    targs = (_tv3(ro), _tv3(rd), torch.as_tensor(inside), TMIN)
    jsweep = getattr(jflash, f"flash_tri_hit_{kind}")
    tsweep = getattr(tflash, f"flash_tri_hit_{kind}")
    td, idd = (x.numpy() for x in tflash.flash_tri_hit_plain(tc, *targs))
    hit = td < INF
    assert 400 < hit.sum() < n - 300 and (inside[hit] > 0).any()
    unique = _unique_t(tc, ro, rd, inside, td)

    # unseeded: the port's dense sweep to the bit, JAX's to rounding
    work = {}
    launches = tflash.resident_launches + tflash.tri_streamed_launches
    t, i = getattr(tflash, f"flash_tri_hit_{kind}_plain")(tcull, *targs, count=work)
    assert tflash.resident_launches + tflash.tri_streamed_launches == launches
    t2, i2 = tsweep(tcull, *targs)  # CPU tensors: the plain version
    assert torch.equal(t, t2) and torch.equal(i, i2)
    assert t.dtype == torch.float32 and i.dtype == torch.int32
    t, i = t.numpy(), i.numpy()
    np.testing.assert_array_equal(t, td)
    assert (i[hit & unique] == idd[hit & unique]).all() and (hit & ~unique).sum() < 0.01 * n
    assert (i[~hit] == 0).all() and (t[-7:] == np.float32(INF)).all()
    nc = tcull[1].shape[1]
    assert 0 < work["clusters"] < 0.5 * nc * (n - 7)  # the gate prunes
    tj, ij = (np.asarray(x) for x in jsweep(jcull, *jargs, interpret=True))
    assert ((tj < INF) == hit).all()
    lanes = np.nonzero(hit & unique)[0]
    assert (ij[lanes] == i[lanes]).all()
    slack = _tri_t_slack(jc, ro[lanes], rd[lanes], i[lanes], t[lanes])
    assert (np.abs(tj[lanes] - t[lanes]) <= 1e-5 * np.abs(t[lanes]) + slack).all()

    # seeded: in front of the nearest triangle on a third of the lanes (the
    # seed comes back, index 0), behind it on a third, none on the rest; every
    # tenth missing lane gets one too
    lane = np.arange(n)
    t_hit = np.where(hit, td, 1.0)
    front, behind = hit & (lane % 3 == 0), hit & (lane % 3 == 1)
    lone = ~hit & (lane % 10 == 0) & (lane < n - 7)
    seed = np.where(front, 0.8 * t_hit, np.where(behind, 1.2 * t_hit, INF))
    seed = np.where(lone, 50.0, seed).astype(np.float32)
    ts_, is_ = (x.numpy() for x in tsweep(tcull, *targs, torch.as_tensor(seed)))
    better = td < seed
    np.testing.assert_array_equal(ts_[better], td[better])
    assert (is_[better & unique] == idd[better & unique]).all()
    np.testing.assert_array_equal(ts_[~better], seed[~better])
    assert (is_[~better] == 0).all() and front.sum() > 100 and behind.sum() > 100
    tsj, _ = jsweep(jcull, *jargs, jnp.asarray(seed), interpret=True)
    np.testing.assert_array_equal(np.asarray(tsj)[~better], seed[~better])


@pytest.mark.parametrize("sort_rays", [True, False])
def test_culled_sweep_matches_jax_interpret(mesh_scenes, sort_rays):
    _, ts = mesh_scenes
    jcull, _, tcull, tc = _builds(ts)
    ro, rd, inside = _rays(ts, 7, n_nan=0)
    t, i = tflash.flash_tri_hit_culled_plain(tcull, _tv3(ro), _tv3(rd), torch.as_tensor(inside),
                                             TMIN, sort_rays=sort_rays)
    tk, ik = tflash.flash_tri_hit_culled(tcull, _tv3(ro), _tv3(rd), torch.as_tensor(inside),
                                         TMIN, sort_rays=sort_rays)
    assert torch.equal(t, tk) and torch.equal(i, ik)
    tj, ij = jflash.flash_tri_hit_culled(jcull, _jv3(ro), _jv3(rd), jnp.asarray(inside), TMIN,
                                         sort_rays=sort_rays, interpret=True)
    t, i, tj, ij = t.numpy(), i.numpy(), np.asarray(tj), np.asarray(ij)
    hit, hit_j = t < INF, tj < INF
    assert (hit == hit_j).mean() > 0.995 and hit.sum() > 400
    both = hit & hit_j
    np.testing.assert_allclose(t[both], tj[both], rtol=5e-4, atol=2e-2)
    assert (i[both] == ij[both]).mean() > 0.995
    # the visiting order changes ties only: t equals the resident sweep's
    tr, _ = tflash.flash_tri_hit_resident_plain(tcull, _tv3(ro), _tv3(rd),
                                                torch.as_tensor(inside), TMIN)
    np.testing.assert_array_equal(t, tr.numpy())


def test_flat_axis_aligned_cluster_is_gated_out_as_in_jax():
    """A 24x24 grid of quads on the plane y = 0 (1,152 triangles, 18
    clusters of zero thickness in y) under 256 rays going straight down. The
    dense sweeps of both packages hit the grid; every clustered sweep of both
    misses it: on the y slab tnear == tfar, and the gate asks tfar > tnear.
    The port follows the JAX package here (ROADMAP.md, queue C)."""
    k = np.arange(25, dtype=np.float32) * 10.0
    gx, gz = np.meshgrid(k, k, indexing="ij")
    p = np.stack([gx, np.zeros_like(gx), gz], -1)
    a, b, c, d = p[:-1, :-1], p[1:, :-1], p[1:, 1:], p[:-1, 1:]
    m = np.concatenate([a, a]).reshape(-1, 3)  # wound to face up: (a, c, b), (a, d, c)
    u = np.concatenate([c - a, d - a]).reshape(-1, 3)
    v = np.concatenate([b - a, c - a]).reshape(-1, 3)
    act = np.ones(m.shape[0], bool)
    rs = np.random.default_rng(4)
    n = 256
    ro = np.stack([rs.uniform(1, 239, n), np.full(n, 100.0), rs.uniform(1, 239, n)],
                  1).astype(np.float32)
    rd = np.tile(np.array([[0.0, -1.0, 0.0]], np.float32), (n, 1))
    inside = np.zeros(n, np.int32)
    jc = jflash.tri_coefficients(_jv3(m), _jv3(u), _jv3(v), jnp.asarray(act))
    jcull = jflash.tri_cull_build(_jv3(m), _jv3(u), _jv3(v), jnp.asarray(act), jc)
    tc = tflash.coefficients_from_numpy(jc)
    tcull = tflash.tri_cull_build(_tv3(m), _tv3(u), _tv3(v), torch.as_tensor(act), tc)
    assert (tcull[1][1] == tcull[1][4]).all()  # every box is flat in y
    jargs = (_jv3(ro), _jv3(rd), jnp.asarray(inside), TMIN)
    targs = (_tv3(ro), _tv3(rd), torch.as_tensor(inside), TMIN)
    td, _ = tflash.flash_tri_hit_plain(tc, *targs)
    tdj, _ = jflash.flash_tri_hit(jc, *jargs, interpret=True)
    np.testing.assert_allclose(td.numpy(), 100.0, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(tdj), 100.0, rtol=1e-6)
    tj, _ = jflash.flash_tri_hit_resident(jcull, *jargs, interpret=True)
    tcj, _ = jflash.flash_tri_hit_culled(jcull, *jargs, interpret=True)
    assert (np.asarray(tj) == np.float32(INF)).all() and (np.asarray(tcj) == np.float32(INF)).all()
    for sweep in ("culled", "resident", "streamed"):
        t, i = getattr(tflash, f"flash_tri_hit_{sweep}_plain")(tcull, *targs)
        assert (t == INF).all() and (i == 0).all(), sweep
    # tilted by a hair, the boxes gain a thickness and the hits come back
    v[:, 1] = 1e-3
    tc2 = tflash.tri_coefficients(_tv3(m), _tv3(u), _tv3(v), torch.as_tensor(act))
    t2, _ = tflash.flash_tri_hit_resident_plain(
        tflash.tri_cull_build(_tv3(m), _tv3(u), _tv3(v), torch.as_tensor(act), tc2), *targs)
    np.testing.assert_array_equal(t2.numpy(), tflash.flash_tri_hit_plain(tc2, *targs)[0].numpy())


def test_tie_goes_to_the_first_visited_row():
    """Two triangles with equal coefficient rows in one cluster: the first in
    the table wins, also where it has the higher scene index; the seed of a
    lane is returned where it equals the hit (a tie goes to the seed's own
    primitive in the caller)."""
    ts = tscenes.hybrid_probe(1.0, 4, 1100)
    cds, bounds, orig_of, cl_ord = tflash.scene_tri_cull(ts)
    ro, rd, inside = _rays(ts, 21, n=512)
    args = (_tv3(ro), _tv3(rd), torch.as_tensor(inside), TMIN)
    t, i = tflash.flash_tri_hit_resident_plain((cds, bounds, orig_of, cl_ord), *args)
    hit = t < INF
    block = cds[0].shape[0] // bounds.shape[1]
    pos_of = torch.empty_like(orig_of)
    pos_of[orig_of.long()[:ts.n_tris]] = torch.arange(ts.n_tris, dtype=torch.int32)
    # a winning row with a later row of a lower scene index in its cluster
    first, second = next(
        (f, q) for f in torch.unique(pos_of[i[hit].long()]).tolist()
        for q in range(f + 1, min((f // block + 1) * block, ts.n_tris))
        if orig_of[q] < orig_of[f])
    twin = tuple(c.clone() for c in cds)
    for c in twin:
        c[second] = c[first]
    t2, i2 = tflash.flash_tri_hit_resident_plain((twin, bounds, orig_of, cl_ord), *args)
    on_it = i == orig_of[first]
    assert on_it.any() and torch.equal(t2[on_it], t[on_it])
    assert (i2[on_it] == orig_of[first]).all() and not (i2 == orig_of[second]).any()
    t3, i3 = tflash.flash_tri_hit_resident_plain((cds, bounds, orig_of, cl_ord), *args,
                                                 torch.where(hit, t, INF))
    assert torch.equal(t3, torch.where(hit, t, INF)) and (i3 == 0).all()


def test_wrappers_check_their_arguments(mesh_scenes):
    _, ts = mesh_scenes
    cull = tflash.scene_tri_cull(ts)
    z = torch.zeros(5)
    args = (V3(z, z, z), V3(z, z, z), torch.zeros(5, dtype=torch.int32), TMIN)
    with pytest.raises(ValueError, match="t_seed"):
        tflash.flash_tri_hit_resident(cull, *args, z[:4])
    with pytest.raises(ValueError, match="device"):
        tflash.flash_tri_hit_streamed(cull, V3(z, z, z), V3(z, z, z),
                                      torch.zeros(5, dtype=torch.int32, device="meta"), TMIN)
    assert tflash.resident_ok(cull)
    big = (tuple(torch.zeros((40 * 1024 + 64, 16)) for _ in range(4)),) + cull[1:]
    assert not tflash.resident_ok(big)


# --------------------------- routing and whole renders ----------------------


def test_accel_entries_route_to_the_clustered_sweep(mesh_scenes, monkeypatch):
    js, ts = mesh_scenes
    assert mrt.pick_renderer(ts) == "hybrid" and thybrid.prefer_hybrid(ts)
    assert set(thybrid.hybrid_accel(ts)) == set(tix.make_accel(ts)) == {"tri_cull"}
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    jacc = jix.make_accel(js)
    assert set(jacc) == {"tri_cull"}
    (jcds, jbounds, jorig, jord, _), (cds, bounds, orig, cl_ord) = jacc["tri_cull"], \
        tix.make_accel(ts)["tri_cull"]
    np.testing.assert_array_equal(orig.numpy(), np.asarray(jorig))
    np.testing.assert_array_equal(bounds.numpy(), np.asarray(jbounds))
    np.testing.assert_array_equal(cl_ord.numpy(), np.asarray(jord))
    # the scans' entry: the same clusters, with the coefficients for the VJP
    dacc, jdacc = tix.make_accel(ts, differentiable=True), jix.make_accel(js, differentiable=True)
    assert set(dacc) == set(jdacc) == {"tri_cull_d"}
    (_, dbounds, dorig, _), dcoeffs = dacc["tri_cull_d"]
    assert torch.equal(dorig, orig) and torch.equal(dbounds, bounds)
    np.testing.assert_array_equal(dorig.numpy(), np.asarray(jdacc["tri_cull_d"][0][2]))
    assert len(dcoeffs) == 4 and dcoeffs[0].shape == (ts.n_tris, 16)


def _jax_eager(fn, *args, **kw):
    """fn run op by op, with JAX's make_accel as on its accelerator (the
    resident sweep interpreted), and the number of bounces it shaded."""
    calls = []
    real = jinteg._shade_and_advance

    def count(*a, **k):
        calls.append(1)
        return real(*a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "default_backend", lambda: "tpu")
        mp.setattr(jflash, "flash_tri_hit_resident",
                   functools.partial(jflash.flash_tri_hit_resident, interpret=True))
        mp.setattr(jinteg, "_shade_and_advance", count)
        with jax.disable_jit():
            out = fn(*args, **kw)
    return out, len(calls)


def test_eager_queue_and_wavefront_equal_eager_jax(mesh_scenes):
    js, ts = mesh_scenes
    offs, _ = jinteg.sample_offsets(SPP)
    kw = dict(width=W, height=H, max_bounces=BOUNCES)
    (a, c, r), steps_j = _jax_eager(jinteg.render_workqueue_pixels, js, W * H, W * H, offs, SPP,
                                    jnp.float32(1000.0), **kw)
    fj = np.asarray((a * (1.0 / jnp.maximum(c, 1.0))).arr)
    stats = {}
    launches = tflash.resident_launches
    at, ct, rt = tinteg.render_workqueue_pixels(ts, W * H, W * H, SPP, 1000.0, spp_sq=2,
                                                fused_shade=False, stats=stats, **kw)
    assert tflash.resident_launches == launches  # CPU tensors: the plain version
    assert stats["steps"] == steps_j > BOUNCES and stats["claimed"] == W * H * (SPP + 1)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(c))
    assert int(rt) == int(r)
    np.testing.assert_allclose((at / ct.clamp_min(1)[:, None]).numpy(), fj, atol=1e-5)

    (a, c, r), steps_j = _jax_eager(jinteg.render_wavefront_pixels, js,
                                    jnp.arange(W * H, dtype=jnp.uint32), offs, jnp.int32(0),
                                    jnp.int32(SPP), jnp.float32(1000.0), **kw)
    frame, st = tinteg.render_wavefront(ts, W, H, SPP, max_bounces=BOUNCES,
                                        device="cpu")
    assert st["steps"] == steps_j and st["rays"] == int(r)
    fj = np.asarray((a * (1.0 / jnp.maximum(c.astype(jnp.float32), 1.0))).arr)
    np.testing.assert_allclose(frame.numpy().reshape(-1, 3), fj, atol=1e-5)


def test_queue_with_shade_step_matches_jax_interpret(mesh_scenes):
    """The main path's renderer at 16x16: the work queue with the shade step,
    its outside candidate from the seeded clustered sweep, against JAX's
    jitted queue with its resident sweep and shade kernel interpreted. Then
    `render` on the CPU routes the full-size rule's way (the hybrid loop at
    this triangle count, the queue at the reference's)."""
    js, ts = mesh_scenes
    offs, _ = jinteg.sample_offsets(SPP)
    a, c, r = jinteg.render_workqueue_pixels(js, W * H, W * H, offs, SPP, jnp.float32(1000.0),
                                             width=W, height=H, max_bounces=BOUNCES,
                                             fused_shade=True, interpret=True)
    fj = np.asarray((a * (1.0 / jnp.maximum(c, 1.0))).arr)
    stats = {}
    at, ct, rt = tinteg.render_workqueue_pixels(ts, W * H, W * H, SPP, 1000.0, width=W, height=H,
                                                max_bounces=BOUNCES, spp_sq=2, stats=stats)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(c))
    assert int(rt) == int(r) and stats["claimed"] == W * H * (SPP + 1)
    np.testing.assert_allclose((at / ct.clamp_min(1)[:, None]).numpy(), fj, atol=1e-5)
    frame, st = mrt.render(ts, 8, 8, 1, max_bounces=3, device="cpu")
    assert st["renderer"] == "hybrid" and torch.isfinite(frame).all() and st["rays"] >= 64
