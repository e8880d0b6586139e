"""The port's fused AD step (plain PyTorch versions) against the JAX package.

Oracles, from the tightest to the loosest:

- the JAX step function `bounce_ad._pixel_step_math`, called eagerly (op by
  op) on (8, 128) lane tiles for a whole scan: every integer row, every key,
  `nvalid` and the ray count must be equal at every step, float rows within
  1e-6 of max(1, the row's largest |reference|) (Cornell coordinates reach
  555, where one float32 ulp is 6e-5);
- `jax.vjp` of that eager step w.r.t. the differentiable table entries and
  the float state, against `ad_step_bwd_plain`;
- the jitted entry point `bounce_ad.sample_pixel_sums_fused(interpret=True)`.
  Jitted XLA:CPU contracts a*b+c into fused multiply-adds, which moves floats
  by an ulp and flips a rare discrete decision (tests/test_torch_bounce.py),
  so that comparison is by share of lanes.

Everything runs at 12x12 pixels or less, 2 samples, 4 to 6 bounces, with
`scan_steps = spp * (bounces + 1) + 2` so that every sample completes.
"""

import ctypes
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miniraytracer_tpu.models import camera as jcam
from miniraytracer_tpu.models import scenes as jscenes
from miniraytracer_tpu.ops import bounce as jbounce
from miniraytracer_tpu.ops import bounce_ad as jad
from miniraytracer_tpu.ops import rng as jrng
from miniraytracer_tpu.scene.builder import SceneBuilder as JBuilder
from miniraytracer_tpu_torch.models import scenes as tscenes
from miniraytracer_tpu_torch.ops import bounce as tbounce
from miniraytracer_tpu_torch.ops import bounce_ad as tad
from miniraytracer_tpu_torch.parallel import train as ttrain
from miniraytracer_tpu_torch.scene.builder import SceneBuilder as TBuilder

torch.set_num_threads(1)

W = H = 12
N = W * H
SPP, BOUNCES = 2, 6
STEPS = SPP * (BOUNCES + 1) + 2
SQ_OFF = 8
SCENES = ["cornell_box", "cornell_smoke", "two_spheres", "perlin_spheres",
          "sphere_light"]


def scene_pair(name):
    """(JAX scene, port scene) of one name."""
    if name == "sphere_light":
        # tests/test_bounce_ad.py::_sphere_light_scene, built for each package
        return (tscenes.ad_probe(builder_cls=JBuilder),
                tscenes.ad_probe(builder_cls=TBuilder))
    return getattr(jscenes, name)(1.0), getattr(tscenes, name)(1.0)


# ---------------------------------------------------------------------------
# The JAX side, stepped eagerly
# ---------------------------------------------------------------------------


def flat(a, n=N):
    return np.asarray(a).reshape(-1)[:n]


def jax_initial_state(scene, n, spp, w, h, samp_base=0):
    """The first lane state as `sample_pixel_sums_fused` builds it, on
    (rows, 128) tiles. Returns (f, i, keys, pix, sampbase)."""
    n_pad = -(-n // 1024) * 1024
    shape = (n_pad // 128, 128)
    pix = np.zeros(n_pad, np.uint32)
    pix[:n] = np.arange(n)
    sb = np.full(n_pad, samp_base, np.int32)
    pj, sj = jnp.asarray(pix.reshape(shape)), jnp.asarray(sb.reshape(shape))
    keys0 = jrng.ray_key(pj, sj.astype(jnp.uint32))
    ci = sb % (SQ_OFF * SQ_OFF)
    off_x = ((ci // SQ_OFF).astype(np.float32) + np.float32(0.5)) / np.float32(SQ_OFF)
    off_y = ((ci % SQ_OFF).astype(np.float32) + np.float32(0.5)) / np.float32(SQ_OFF)
    x, y = (pix % w).astype(np.float32), (pix // w).astype(np.float32)
    tile = lambda a: jnp.asarray(a.astype(np.float32).reshape(shape))
    r0 = jcam.get_rays(scene.camera, tile((x + off_x) / np.float32(w)),
                       tile((y + off_y) / np.float32(h)), keys0)
    one, zero = jnp.ones(shape), jnp.zeros(shape)
    alive = tile((np.arange(n_pad) < n) & (spp > 0))
    f = (zero, zero, zero, *r0.ro, *r0.rd, r0.time, one, one, one,
         zero, zero, zero, alive, zero, zero)
    iz = jnp.zeros(shape, jnp.int32)
    return f, (iz, r0.inside, iz), keys0, pj, sj


def jax_step(scene, steps, bounces, spp, w, h):
    """step(t, f, i, keys, tabs=None) -> (f', i', keys'): one eager call of
    the JAX step function, on the scene's packed tables unless others are
    given."""
    meta, tabs0 = jbounce.pack_scene(scene)
    claim = steps - (bounces + 1)

    def step(t, f, i, k, pj, sj, tabs=None):
        tabs = tabs0 if tabs is None else tabs
        return jad._pixel_step_math(
            meta, w, h, SQ_OFF, bounces, spp, claim, tabs[:7], tabs[7],
            tabs[8], pj, sj, t, f, i, k)[:3]

    return step, tabs0


def jax_eager_scan(scene, n=N, spp=SPP, w=W, h=H, bounces=BOUNCES, steps=STEPS):
    """The state before every step and after the last, and the lane ids."""
    step, _ = jax_step(scene, steps, bounces, spp, w, h)
    f, i, k, pj, sj = jax_initial_state(scene, n, spp, w, h)
    states = [(f, i, k)]
    for t in range(steps):
        f, i, k = step(t, f, i, k, pj, sj)
        states.append((f, i, k))
    return states, pj, sj


def state_numpy(state, n=N):
    f, i, k = state
    return (np.stack([flat(a, n) for a in f]), np.stack([flat(a, n) for a in i]),
            flat(k, n).astype(np.int64))


_SCANS = {}


@pytest.fixture(scope="module")
def eager_scan():
    """name -> (JAX scene, port scene, states, pix tile, sampbase tile); each
    scene's eager scan runs once per module."""
    def get(name):
        if name not in _SCANS:
            js, ts = scene_pair(name)
            _SCANS[name] = (js, ts, *jax_eager_scan(js))
        return _SCANS[name]

    yield get
    _SCANS.clear()


def port_setup(ts, n=N, spp=SPP, w=W, h=H, bounces=BOUNCES, steps=STEPS, k_sub=1):
    meta, tables = tbounce.pack_scene(ts)
    _, claim, k_sub, outer = tad.scan_plan(spp, bounces, steps, k_sub)
    cfg = tad.StepConfig(w, h, SQ_OFF, bounces, spp, claim, k_sub)
    pix = torch.arange(n, dtype=torch.int32)
    return meta, tables, cfg, outer, pix, torch.zeros_like(pix)


# ---------------------------------------------------------------------------
# 1. The step, forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", SCENES)
def test_step_forward_matches_jax_eager_step(eager_scan, name):
    _, ts, states, _, _ = eager_scan(name)
    meta, tables, cfg, outer, pix, sb = port_setup(ts)
    assert outer == STEPS
    f, i, k = tad.initial_state(ts, pix, sb, SPP, width=W, height=H, sq_off=SQ_OFF)
    for t in range(STEPS + 1):
        jf, ji, jk = state_numpy(states[t])
        np.testing.assert_array_equal(i.numpy(), ji, err_msg=f"int rows, step {t}")
        np.testing.assert_array_equal(k.numpy().astype(np.int64) & 0xFFFFFFFF, jk,
                                      err_msg=f"keys, step {t}")
        for row in (tad.A_ALIVE, tad.A_NV, tad.A_RAYS):
            np.testing.assert_array_equal(f[row].numpy(), jf[row],
                                          err_msg=f"row {row}, step {t}")
        scale = np.maximum(1.0, np.abs(jf).max(axis=1, keepdims=True))
        err = np.abs(f.numpy() - jf) / scale
        assert err.max() <= 1e-6, (t, err.max(), int(err.argmax()) // N)
        if t < STEPS:
            f, i, k = tad.ad_step_fwd(meta, cfg, tables, t, f, i, k, pix, sb)
    assert f[tad.A_NV].sum() == N * SPP  # every sample completed
    assert f[tad.A_RAYS].sum() > N * SPP


# ---------------------------------------------------------------------------
# 2. The step, backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", SCENES)
def test_step_backward_matches_jax_vjp(eager_scan, name):
    """`ad_step_bwd_plain` against `jax.vjp` of the eager JAX step w.r.t. the
    differentiable table entries and the float state, from the same entry
    state and a seeded cotangent, at three steps of the scan: rtol 2e-3,
    atol 2e-4 of the reference's largest entry."""
    js, ts, states, pj, sj = eager_scan(name)
    meta, tables, cfg, _, pix, sb = port_setup(ts)
    step, tabs = jax_step(js, STEPS, BOUNCES, SPP, W, H)
    didx = tad.diff_indices(meta)
    rs = np.random.default_rng(len(name))
    seen = 0
    for t in (1, STEPS // 3, 2 * STEPS // 3):
        f, i, k = states[t]
        cot = rs.normal(size=(tad.NF, 1024)).astype(np.float32)
        cot[:, N:] = 0.0

        def fn(sph, tri, mat, tex, f):
            tb = (sph, tabs[1], tri, tabs[3], tabs[4], mat, tex, tabs[7], tabs[8])
            return step(t, f, i, k, pj, sj, tb)[0]

        _, pull = jax.vjp(fn, tabs[0], tabs[2], tabs[5], tabs[6], f)
        g = pull(tuple(jnp.asarray(c.reshape(8, 128)) for c in cot))
        d_tab_j = np.concatenate([np.asarray(g[j])[didx[key]] for j, key in
                                  enumerate(("sph", "tri", "mat", "tex"))])
        d_f_j = np.stack([flat(a) for a in g[4]])

        nf, ni, nk = state_numpy(states[t])
        d_f, d_tab = tad.ad_step_bwd(
            meta, cfg, tables, t,
            torch.as_tensor(nf[tad.RES_LO:tad.RES_HI].copy()),
            torch.as_tensor(ni), tad._keys_i32(torch.as_tensor(nk)), pix, sb,
            torch.as_tensor(cot[:, :N].copy()))
        assert np.isfinite(d_f_j).all() and torch.isfinite(d_f).all()
        np.testing.assert_allclose(d_f.numpy(), d_f_j, rtol=2e-3,
                                   atol=2e-4 * np.abs(d_f_j).max(),
                                   err_msg=f"d_f, step {t}")
        np.testing.assert_allclose(d_tab.numpy(), d_tab_j, rtol=2e-3,
                                   atol=2e-4 * np.abs(d_tab_j).max() + 1e-30,
                                   err_msg=f"d_tab, step {t}")
        seen += int(np.abs(d_tab_j).max() > 0)
    assert seen > 0, "degenerate: the reference table cotangents are all zero"


# ---------------------------------------------------------------------------
# 3. The entry point
# ---------------------------------------------------------------------------


def port_sums(ts, spp=SPP, bounces=BOUNCES, steps=STEPS, sub_steps=1, n=N,
              w=W, h=H, samp_base=0):
    pix = torch.arange(n, dtype=torch.int32)
    s, nv, rays = tad.sample_pixel_sums_fused(
        ts, pix, samp_base, spp, width=w, height=h, max_bounces=bounces,
        scan_steps=steps, sub_steps=sub_steps)
    return s, nv, int(rays)


@pytest.mark.parametrize("name", SCENES)
def test_entry_point_matches_jax_eager_scan(eager_scan, name):
    _, ts, states, _, _ = eager_scan(name)
    jf, _, _ = state_numpy(states[-1])
    s, nv, rays = port_sums(ts, sub_steps=4)
    np.testing.assert_array_equal(nv.numpy(), jf[tad.A_NV])
    assert rays == int(jf[tad.A_RAYS].sum())
    np.testing.assert_allclose(s.numpy(), jf[:3].T, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["cornell_box", "sphere_light"])
def test_entry_point_matches_jax_jitted_entry_point(name):
    """Against the jitted JAX entry point in interpret mode. Its fused
    multiply-adds may flip a rare decision: `nvalid` is equal (every sample
    completes either way) and the rays differ by at most 0.5%; measured on
    these two scenes at 12x12x2x6: all 144 lanes within 1e-5, asserted at
    99%."""
    js, ts = scene_pair(name)
    sj, nvj, raysj = jad.sample_pixel_sums_fused(
        js, jnp.arange(N, dtype=jnp.uint32), 0, SPP, width=W, height=H,
        max_bounces=BOUNCES, scan_steps=STEPS, interpret=True)
    s, nv, rays = port_sums(ts)
    np.testing.assert_array_equal(nv.numpy(), np.asarray(nvj))
    assert abs(rays - float(raysj)) <= 0.005 * float(raysj)
    err = np.abs(s.numpy() - np.stack([sj.x, sj.y, sj.z], -1)).max(axis=1)
    assert (err < 1e-5).mean() >= 0.99, ((err < 1e-5).mean(), err.max())


def _loss_and_grads(ts, sub_steps, steps=STEPS):
    leaves = ttrain.TrainParams(*(p.clone().requires_grad_(True)
                                  for p in ttrain.extract_params(ts)))
    s, nv, rays = port_sums(ttrain.apply_params(ts, leaves), steps=steps,
                            sub_steps=sub_steps)
    err = torch.where(nv[:, None] > 0, s / nv.clamp_min(1)[:, None] - 0.25, 0.0)
    loss = (err * err).sum()
    grads = torch.autograd.grad(loss, list(leaves), allow_unused=True)
    return s.detach(), nv, rays, loss.detach(), grads


@pytest.mark.parametrize("name", ["cornell_box", "cornell_smoke", "sphere_light"])
def test_sub_steps_agree_in_values_and_gradients(name):
    """1, 2 and 4 sub-steps a launch: bit-equal sums, nvalid and rays, and
    gradients equal up to the order in which the launches' table cotangents
    are added (rtol 1e-5)."""
    _, ts = scene_pair(name)
    s1, nv1, r1, l1, g1 = _loss_and_grads(ts, 1)
    assert any(g is not None and float(g.abs().max()) > 0 for g in g1)
    for k in (2, 4):
        sk, nvk, rk, lk, gk = _loss_and_grads(ts, k)
        assert torch.equal(sk, s1) and torch.equal(nvk, nv1) and rk == r1
        assert float(lk) == float(l1)
        for leaf, a, b in zip(ttrain.TrainParams._fields, gk, g1):
            assert (a is None) == (b is None), leaf
            if a is not None:
                torch.testing.assert_close(
                    a, b, rtol=1e-5, atol=1e-6 * float(b.abs().max()), msg=leaf)


# ---------------------------------------------------------------------------
# 5. A trimmed claim window
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sub_steps", [1, 4])
def test_trimmed_window_counts_and_sums_only_completed_samples(sub_steps):
    """A scan too short for every sample: a lane claims its next sample only
    before `claim_limit`, every claimed sample finishes, `nvalid` is the
    census of claimed samples and the sum is the sum of exactly those.

    The census is made from each sample's own path length (one-sample scans
    that run to the end): sample s of a lane starts when sample s-1 ends,
    and is claimed if that step lies inside the window."""
    _, ts = scene_pair("cornell_box")
    n, w, h, spp, bounces = 64, 8, 8, 4, 4
    steps = (bounces + 1) + 6
    claim_limit = steps - (bounces + 1)
    meta, tables, cfg, outer, pix, sb = port_setup(
        ts, n=n, spp=1, w=w, h=h, bounces=bounces, steps=bounces + 2)
    length, single = [], []
    for smp in range(spp):
        sbs = torch.full_like(sb, smp)
        f0, i0, k0 = tad.initial_state(ts, pix, sbs, 1, width=w, height=h,
                                       sq_off=SQ_OFF)
        (f, _, _), _ = tad.scan_forward(meta, cfg, outer, tables, f0, i0, k0,
                                        pix, sbs, keep=False)
        assert (f[tad.A_NV] == 1).all()
        length.append(f[tad.A_RAYS].to(torch.int64))
        single.append(f[:3].t())
    start = torch.zeros(n, dtype=torch.int64)
    census = torch.zeros(n)
    expect = torch.zeros(n, 3)
    claimed = torch.ones(n, dtype=torch.bool)
    for smp in range(spp):
        if smp:
            claimed = claimed & (start - 1 < claim_limit)
        census += claimed
        expect = expect + torch.where(claimed[:, None], single[smp], 0.0)
        start = start + length[smp]
    assert 0 < census.sum() < n * spp and census.min() >= 1  # really trimmed

    s, nv, rays = port_sums(ts, spp=spp, bounces=bounces, steps=steps,
                            sub_steps=sub_steps, n=n, w=w, h=h)
    assert torch.equal(nv, census)
    assert torch.equal(s, expect)
    full, nv_full, _ = port_sums(ts, spp=spp, bounces=bounces,
                                 steps=spp * (bounces + 1) + 2, n=n, w=w, h=h)
    assert (nv_full == spp).all()
    done = census == spp
    assert torch.equal(s[done], full[done])


def test_trimmed_window_matches_jax_entry_point():
    """The same short scan through the jitted JAX entry point (interpret
    mode): equal `nvalid` on at least 99% of lanes (measured: all 64), sums
    within 1e-5 on those."""
    js, ts = scene_pair("cornell_box")
    n, w, h, spp, bounces = 64, 8, 8, 4, 4
    steps = (bounces + 1) + 6
    sj, nvj, _ = jad.sample_pixel_sums_fused(
        js, jnp.arange(n, dtype=jnp.uint32), 0, spp, width=w, height=h,
        max_bounces=bounces, scan_steps=steps, interpret=True)
    s, nv, _ = port_sums(ts, spp=spp, bounces=bounces, steps=steps, n=n, w=w, h=h)
    same = nv.numpy() == np.asarray(nvj)
    assert same.mean() >= 0.99, same.mean()
    assert float(nv.sum()) < n * spp
    err = np.abs(s.numpy() - np.stack([sj.x, sj.y, sj.z], -1)).max(axis=1)
    assert (err[same] < 1e-5).mean() >= 0.99, err.max()


# ---------------------------------------------------------------------------
# 7. Plumbing
# ---------------------------------------------------------------------------


def test_ad_kernel_params_match_the_cuda_source():
    src = (Path(tad.__file__).parents[1] / "csrc" / "bounce_ad.cu").read_text()
    enum = re.search(r"enum AdParamIdx \{(.*?)\};", src, re.S).group(1)
    names = [e.split("=")[0].strip() for e in enum.replace("\n", " ").split(",")]
    names = [e for e in names if e]
    assert names == ["Q_N", "Q_WIDTH", "Q_HEIGHT", "Q_SQ_OFF", "Q_MAX_BOUNCES",
                     "Q_SPP", "Q_CLAIM_LIMIT", "Q_KSUB", "Q_TSTEP", "Q_S", "Q_R",
                     "Q_TC", "Q_BX", "Q_V", "Q_M", "Q_X", "Q_NLIGHTS", "Q_LTYPE",
                     "Q_LIDX", "Q_USE_SKY", "Q_EXACT_COS", "Q_PERLIN", "Q_COUNT"]
    assert f"Q_COUNT == {tad._N_IPARAMS}" in src
    assert f"MAX_KSUB = {tad.MAX_SUB_STEPS};" in src
    assert f"MAX_LIGHTS = {tbounce.MAX_LIGHTS};" in (
        Path(tad.__file__).parents[1] / "csrc" / "physics.cuh").read_text()
    for row in ("A_SUM", "A_RO", "A_RD", "A_TIME", "A_BETA", "A_RAD", "A_ALIVE",
                "A_NV", "A_RAYS"):
        assert re.search(rf"\b{row} = {getattr(tad, row)}\b", src), row

    _, ts = scene_pair("sphere_light")
    meta, _, _, _, _, _ = port_setup(ts)
    cfg = tad.StepConfig(31, 17, 8, 5, 3, 11, 4)
    ip = tad.kernel_params(meta, cfg, 527, 9)
    ml = tbounce.MAX_LIGHTS
    assert ip[:9] == [527, 31, 17, 8, 5, 3, 11, 4, 9]
    assert ip[9:17] == [meta["S"], meta["R"], meta["Tc"], meta["Bx"], meta["V"],
                        meta["M"], meta["X"], 1]
    assert ip[17:17 + ml] == [meta["lights"][0][0]] + [0] * (ml - 1)
    assert ip[17 + ml:17 + 2 * ml] == [meta["lights"][0][1]] + [0] * (ml - 1)
    assert ip[17 + 2 * ml:] == [1, int(meta["exact_cosine"]), 0]
    assert len((ctypes.c_int * tad._N_IPARAMS)(*ip)) == tad._N_IPARAMS
    assert tad.n_diff(meta) == 4 * meta["S"] + 3 * meta["Tc"] + meta["M"] + 6 * meta["X"]
    with pytest.raises(ValueError, match="sub_steps"):
        tad.kernel_params(meta, cfg._replace(k_sub=tad.MAX_SUB_STEPS + 1), 527, 9)
    with pytest.raises(ValueError, match="too many lanes"):
        tad.kernel_params(meta, cfg, 2 ** 31 // tad.NF, 9)


def test_ad_step_wrappers_refuse_what_the_kernels_do_not_take():
    _, ts = scene_pair("cornell_box")
    meta, tables, cfg, _, pix, sb = port_setup(ts)
    f, i, k = tad.initial_state(ts, pix, sb, SPP, width=W, height=H, sq_off=SQ_OFF)
    with pytest.raises(ValueError, match="no fused AD step for device"):
        tad.ad_step_fwd(meta, cfg, tables, 0, f.to("meta"), i, k, pix, sb)
    with pytest.raises(ValueError, match="int32"):
        tad.sample_pixel_sums_fused(ts, pix.long(), 0, SPP, width=W, height=H,
                                    max_bounces=BOUNCES)
    with pytest.raises(ValueError, match="shorter than one path"):
        tad.scan_plan(2, 6, scan_steps=5)
    with pytest.raises(ValueError, match="no image textures"):
        tad._check_meta(dict(meta, image=True))
    # the checks the CUDA launch makes, on CPU tensors
    with pytest.raises(ValueError, match="fstate must be a contiguous"):
        tad._check_lanes(f.device, N, fstate=(f[:, ::2], torch.float32, tad.NF))
    with pytest.raises(ValueError, match="table sph"):
        tad._check_tables(f.device, meta, [tables[0][:-1]] + tables[1:])


def test_cuda_tensors_without_a_card_raise():
    """No quiet CPU path: a CUDA scene goes to the kernels or raises."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    _, ts = scene_pair("cornell_box")
    with pytest.raises((RuntimeError, AssertionError)):
        ts.to("cuda")
