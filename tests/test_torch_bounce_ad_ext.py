"""The port's hybrid-ext AD step (plain PyTorch versions, and the CUDA
kernels compiled for the host) against the JAX package.

Scenes: the five hybrid-ext scenes of tests/test_bounce_ad.py (NE=5
triangles, an image-textured sphere, ext-material spheres, external boxes,
ext-material spheres with image textures), built by the JAX package and
carried into the port (`scene.types.from_numpy`), and the port's four train
scenes (random_spheres, the triangles scene with stand-in meshes, earth,
book2_final). Oracles:

- the JAX step function `bounce_ad._pixel_step_math(ext=...)`, called
  eagerly on the same lane state and candidate rows (the texel multiplied in
  after it, as the JAX scan does): integer rows and keys equal, floats within
  1e-6 of each row's scale; and `jax.vjp` of it w.r.t. the differentiable
  table entries, the float state and the candidate rows, against
  `ad_step_bwd_plain`: rtol 2e-3, atol 2e-4 of the reference's largest entry;
- the jitted JAX entry point `sample_pixel_sums_fused(use_ext=True,
  interpret=True)`, on two of the scenes and on random_spheres: the loss
  and every TrainParams gradient, at JAX's own
  tolerances (tests/test_bounce_ad.py: loss rtol 1e-5, gradients rtol 2e-3,
  atol 2e-4 of the largest entry; ext-material mode loss rtol 1e-3,
  gradients rtol 1e-2, atol 2e-3);
- the emulated kernels (csrc/bounce_ad.cu built with g++, as
  tests/test_torch_kernel_emulation.py does) against the plain step, lane by
  lane, in the four ext modes.

Everything runs at 8x8 pixels or less, 2 samples, 4 bounces (random_spheres'
whole scan: 8).
"""

import contextlib
import ctypes
import shutil
import subprocess
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import miniraytracer_tpu_torch as mrt
from miniraytracer_tpu.models import scenes as jscenes
from miniraytracer_tpu.ops import bounce_ad as jad
from miniraytracer_tpu.ops import flash as jflash
from miniraytracer_tpu.ops import hybrid as jhybrid
from miniraytracer_tpu.parallel.train import apply_params, extract_params
from miniraytracer_tpu_torch.models import scenes as tscenes
from miniraytracer_tpu_torch.ops import bounce_ad as tad
from miniraytracer_tpu_torch.ops import hybrid as thybrid
from miniraytracer_tpu_torch.ops.vecmath import V3
from miniraytracer_tpu_torch.parallel import train as ttrain
from miniraytracer_tpu_torch.scene import types as ttypes
from miniraytracer_tpu_torch.utils import device, kernels
from tests import test_bounce_ad as jtests
from tests.test_torch_scene import _leaves

torch.set_num_threads(1)

W = H = 6
N = W * H
SPP, BOUNCES = 2, 4
STEPS = SPP * (BOUNCES + 1) + 2
SQ_OFF = 8
JAX_SCENES = {"ext_tri": jtests._ext_tri_scene, "ext_img": jtests._ext_img_scene,
              "ext_mat": jtests._ext_mat_ad_scene, "ext_box": jtests._ext_box_scene,
              "ext_mat_img": jtests._ext_mat_img_ad_scene}
_PAIRS = {}


def scene_pair(name):
    """(JAX scene, port scene carried over from it) of a hybrid-ext scene."""
    if name not in _PAIRS:
        js = JAX_SCENES[name]()
        _PAIRS[name] = (js, ttypes.from_numpy(_leaves(js)))
    return _PAIRS[name]


@pytest.fixture(scope="module")
def stand_in_assets(tmp_path_factory):
    return str(tscenes.write_stand_in_meshes(tmp_path_factory.mktemp("assets"),
                                             bunny_subdiv=3, torus_segments=(16, 12)))


def train_scene(name, assets, monkeypatch):
    if name == "triangles":
        monkeypatch.setenv("MRT_ASSETS", assets)
    return getattr(tscenes, name)(1.0)


def port_setup(ts, w=W, spp=SPP, bounces=BOUNCES, steps=STEPS):
    plan = thybrid.smem_plan(ts) if thybrid.ext_mat_mode(ts) else None
    meta, tables = thybrid.pack_scene_hybrid(ts, plan)
    _, claim, k_sub, outer = tad.scan_plan(spp, bounces, steps, 1)
    cfg = tad.StepConfig(w, w, SQ_OFF, bounces, spp, claim, k_sub)
    pix = torch.arange(w * w, dtype=torch.int32)
    images = ts.images if meta["image"] else None
    return meta, [t.detach() for t in tables], cfg, outer, pix, torch.zeros_like(pix), images


def port_states(ts, at, **kw):
    """The plain scan's (fstate, istate, keys, ext rows) at the steps `at`."""
    meta, tables, cfg, outer, pix, sb, images = port_setup(ts, **kw)
    f, i, k = tad.initial_state(ts, pix, sb, cfg.spp, width=cfg.width, height=cfg.height,
                                sq_off=SQ_OFF)
    cand = tad.ExtCandidate(ts)
    out = {}
    for t in range(max(at) + 1):
        ext = cand.rows(f, i)
        if t in at:
            out[t] = (f, i, k, ext)
        f, i, k = tad.ad_step_fwd_plain(meta, cfg, tables, t, f, i, k, pix, sb, ext, images)
    return out


# ---------------------------------------------------------------------------
# 1. The step against the eager JAX step and its vjp
# ---------------------------------------------------------------------------


def jax_step(js, meta_t, claim):
    """step(t, tabs, f, i, keys, ext) -> f' of the JAX step function on the
    JAX package's own packing of the scene, the texel multiplied in."""
    plan = jhybrid.smem_plan(js) if jhybrid.ext_mat_mode(js) else None
    meta, tabs = jhybrid.pack_scene_hybrid(js, plan)
    assert meta["image"] == meta_t["image"] and bool(meta.get("ext_mat")) == bool(
        meta_t.get("ext_mat"))
    pix = jnp.arange(N, dtype=jnp.uint32)
    sb = jnp.zeros((N,), jnp.int32)

    def step(t, tb, f, i, k, ext):
        f_out, _, k_out, img = jad._pixel_step_math(
            meta, W, H, SQ_OFF, BOUNCES, SPP, claim, tb[:7], tb[7], tb[8], pix, sb, t, f,
            i, k, ext=ext)
        if img is not None:
            pend, comps = jhybrid._texel_rgb(js, img[0])
            f_out = list(f_out)
            for r, comp in zip(range(jad.A_BETA, jad.A_BETA + 3), comps):
                f_out[r] = jnp.where(pend, f_out[r] * comp, f_out[r])
            f_out = tuple(f_out)
        return f_out, k_out

    return step, tabs


@pytest.mark.parametrize("name", list(JAX_SCENES))
def test_ext_step_matches_jax_eager_step_and_vjp(name):
    js, ts = scene_pair(name)
    meta, tables, cfg, _, pix, sb, images = port_setup(ts)
    step, tabs = jax_step(js, meta, cfg.claim_limit)
    didx = tad.diff_indices(meta)
    rs = np.random.default_rng(len(name))
    seen_ext = 0
    for t, (f, i, k, ext) in port_states(ts, (1, 4)).items():
        jf = tuple(jnp.asarray(r.numpy()) for r in f)
        ji = tuple(jnp.asarray(r.numpy()) for r in i)
        jk = jnp.asarray(k.numpy().view(np.uint32))
        je = tuple(jnp.asarray(r.numpy()) for r in ext)
        jf_out, jk_out = step(t, tabs, jf, ji, jk, je)
        f_out, _, k_out = tad.ad_step_fwd_plain(meta, cfg, tables, t, f, i, k, pix, sb, ext,
                                                images)
        ref = np.stack([np.asarray(r) for r in jf_out])
        np.testing.assert_array_equal(k_out.numpy().view(np.uint32), np.asarray(jk_out))
        scale = np.maximum(1.0, np.abs(ref).max(axis=1, keepdims=True))
        assert (np.abs(f_out.numpy() - ref) / scale).max() <= 1e-6, t

        cot = rs.normal(size=(tad.NF, N)).astype(np.float32)

        def fn(sph, tri, mat, tex, f_, e_):
            tb = (sph, tabs[1], tri, tabs[3], tabs[4], mat, tex, tabs[7], tabs[8])
            return step(t, tb, f_, ji, jk, e_)[0]

        _, pull = jax.vjp(fn, tabs[0], tabs[2], tabs[5], tabs[6], jf, je)
        g = pull(tuple(jnp.asarray(c) for c in cot))
        d_tab_j = np.concatenate([np.asarray(g[j])[didx[key]] for j, key in
                                  enumerate(("sph", "tri", "mat", "tex"))])
        d_f_j, d_e_j = np.stack(g[4]), np.stack(g[5])
        d_f, d_tab, d_e = tad.ad_step_bwd_plain(
            meta, cfg, tables, t, f[tad.RES_LO:tad.RES_HI].contiguous(), i, k, pix, sb,
            torch.as_tensor(cot), ext, images)
        for what, a, b in (("d_f", d_f, d_f_j), ("d_tab", d_tab, d_tab_j),
                           ("d_ext", d_e, d_e_j)):
            assert np.isfinite(b).all() and torch.isfinite(a).all(), what
            np.testing.assert_allclose(a.numpy(), b, rtol=2e-3,
                                       atol=2e-4 * (np.abs(b).max() if b.size else 0) + 1e-30,
                                       err_msg=f"{name} {what}, step {t}")
        seen_ext += int(np.abs(d_e_j[:4]).max() > 0)
    assert seen_ext > 0, "degenerate: no candidate won a lane"


# ---------------------------------------------------------------------------
# 2. The whole scan against the JAX entry point
# ---------------------------------------------------------------------------


@pytest.fixture()
def interpret_flash(monkeypatch):
    for name in ("flash_tri_hit", "flash_tri_hit_resident", "flash_tri_hit_streamed",
                 "flash_sphere_hit", "flash_sphere_hit_gated", "flash_sphere_hit_streamed"):
        monkeypatch.setattr(jflash, name, partial(getattr(jflash, name), interpret=True))


def port_loss_and_grads(ts, params, w=W, bounces=BOUNCES, steps=STEPS):
    leaves = ttrain.TrainParams(*(p.clone().requires_grad_(True) for p in params))
    s, nv, rays = tad.sample_pixel_sums_fused(
        ttrain.apply_params(ts, leaves), torch.arange(w * w, dtype=torch.int32), 0, SPP,
        width=w, height=w, max_bounces=bounces, scan_steps=steps, use_ext=True)
    err = torch.where(nv[:, None] > 0, s / nv.clamp_min(1)[:, None] - 0.25, 0.0)
    loss = (err * err).sum()
    return loss.detach(), torch.autograd.grad(loss, list(leaves), allow_unused=True), int(rays)


def jax_loss_and_grads(js, w=W, bounces=BOUNCES, steps=STEPS):
    """`jax.value_and_grad` of the JAX entry point's SSE loss against a flat
    grey target (flash interpreted) under `jax.jit`, as the JAX package's
    train step runs it."""
    plan = jhybrid.smem_plan(js) if jhybrid.ext_mat_mode(js) else None
    n = w * w
    target = jnp.full((n, 3), 0.25, jnp.float32)

    def loss_j(params):
        summ, nv, _ = jad.sample_pixel_sums_fused(
            apply_params(js, params), jnp.arange(n, dtype=jnp.uint32), 0, SPP, width=w,
            height=w, max_bounces=bounces, scan_steps=steps, interpret=True, use_ext=True,
            pack_plan=plan)
        mean = jnp.stack([summ.x, summ.y, summ.z], -1) / jnp.maximum(nv, 1.0)[:, None]
        err = jnp.where(nv[:, None] > 0, mean - target, 0.0)
        return jnp.sum(err * err)

    return jax.jit(jax.value_and_grad(loss_j))(extract_params(js))


def assert_grads_close(name, gt, gj, rtol, atol):
    """Every TrainParams gradient of the port within rtol, atol of the
    leaf's largest entry of JAX's; returns the leaves JAX reaches."""
    nonzero = []
    for leaf, a, b in zip(ttrain.TrainParams._fields, gt, gj):
        b = np.asarray(b)
        a = np.zeros_like(b) if a is None else a.numpy()
        assert np.isfinite(a).all(), leaf
        scale = float(np.abs(b).max()) if b.size else 0.0
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol * scale + 1e-30,
                                   err_msg=f"{name}: TrainParams.{leaf}")
        if scale > 0:
            nonzero.append(leaf)
    assert nonzero, "degenerate: every reference gradient is zero"
    return nonzero


@pytest.mark.parametrize("name", ["ext_tri", "ext_mat_img"])
def test_ext_scan_loss_and_grads_match_jax_entry_point(interpret_flash, name):
    """The loss and the TrainParams gradients of the whole scan (candidate,
    step, backward and the candidate's pullback) against `jax.value_and_grad`
    of the JAX entry point under `jax.jit`, on the NE=5 scene (triangles) and
    the one with every ext-material and image row (~30 s each, JAX compiling
    its interpreted scan). The box scene's sweep is held by
    tests/test_torch_flash_vjp.py and its step above."""
    js, ts = scene_pair(name)
    emat = jhybrid.ext_mat_mode(js)
    lj, gj = jax_loss_and_grads(js)
    lt, gt, _ = port_loss_and_grads(ts, ttrain.extract_params(ts))
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-3 if emat else 1e-5)
    nonzero = assert_grads_close(name, gt, gj, *((1e-2, 2e-3) if emat else (2e-3, 2e-4)))
    if name == "ext_mat_img":
        assert {"tex_c0", "sph_c0"} <= set(nonzero), nonzero


def test_random_spheres_scan_matches_jitted_jax_entry_point(interpret_flash):
    """random_spheres itself (486 spheres, ext-material mode; the scene whose
    training chip_smoke.py's phase 30 reads) at 8x8 x 2 spp x 8 bounces: the
    loss and every TrainParams gradient against the JAX entry point under
    `jax.jit`, at JAX's ext-material tolerances. Its index-of-refraction,
    fuzz and sphere gradients are ill-conditioned at this depth: a pixel
    whose paths pass through the hollow glass sphere carries most of them,
    and JAX's eager gradient of mat_param, sph_c0 and sph_radius falls
    outside these tolerances of its jitted one (XLA:CPU contracts a*b+c into
    an FMA under jit), so the oracle is the jitted entry point, as the JAX
    package's train step runs it."""
    js = jscenes.random_spheres(1.0)
    ts = ttypes.from_numpy(_leaves(js))
    bounces = 8
    steps = SPP * (bounces + 1) + 2
    lj, gj = jax_loss_and_grads(js, w=8, bounces=bounces, steps=steps)
    lt, gt, _ = port_loss_and_grads(ts, ttrain.extract_params(ts), w=8, bounces=bounces,
                                    steps=steps)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    nonzero = assert_grads_close("random_spheres", gt, gj, 1e-2, 2e-3)
    assert {"tex_c0", "tex_c1", "mat_param", "sph_c0", "sph_radius"} <= set(nonzero), nonzero


# ---------------------------------------------------------------------------
# 3. The replay of the candidate, and the port's own train scenes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["random_spheres", "triangles", "book2_final"])
def test_replayed_candidate_equals_forward_bit_for_bit(name, stand_in_assets, monkeypatch):
    """The backward replays each step's candidate from its saved entry state
    with inputs that require grad; the kernel's adjoint was taken against the
    forward's rows, so the replay must give the same rows to the bit (the
    clustered triangle sweep sorts the rays with `argsort`: its ties too)."""
    ts = train_scene(name, stand_in_assets, monkeypatch)
    states = port_states(ts, (0, 3), w=8)
    cand = tad.ExtCandidate(ts)
    cand.start_pullback()
    scene, coeffs, _ = cand._req
    for t, (f, i, _, ext) in states.items():
        rays = [f[r].clone().requires_grad_(True) for r in range(tad.A_RO, tad.A_TIME + 1)]
        with torch.enable_grad():
            rows = cand._rows(scene, coeffs, V3(*rays[:3]), V3(*rays[3:6]), rays[6],
                              i[tad.J_INSIDE], f[tad.A_ALIVE] > 0.0)
        assert any(r.requires_grad for r in rows)
        for j, r in enumerate(rows):
            assert torch.equal(r.detach(), ext[j]), (name, t, j)
        assert (ext[0] < 1e38).any(), "degenerate: no lane has a candidate"


@pytest.mark.parametrize("name", ["random_spheres", "triangles", "earth", "book2_final"])
def test_train_scenes_take_the_ext_step(name, stand_in_assets, monkeypatch):
    """The four train scenes of the hybrid-ext step: in its class, finite
    gradients, the geometry leaves reached (sph_c0 through the sphere sweeps,
    tri_m through the clustered triangle sweep) and one train step on the
    CPU, whose SGD update is p - lr * g."""
    ts = train_scene(name, stand_in_assets, monkeypatch)
    assert tad.can_fuse_ad_ext(ts)
    loss, grads, rays = port_loss_and_grads(ts, ttrain.extract_params(ts), w=4)
    assert torch.isfinite(loss) and rays > 0
    g = {leaf: a for leaf, a in zip(ttrain.TrainParams._fields, grads) if a is not None}
    assert all(torch.isfinite(a).all() for a in g.values())
    key = {"random_spheres": "sph_c0", "triangles": "tri_m", "book2_final": "sph_c0",
           "earth": "sph_c0"}[name]
    assert float(g[key].abs().max()) > 0, key
    step = mrt.make_train_step(width=4, height=4, max_bounces=BOUNCES, spp_step=SPP,
                               scan_steps=STEPS, device="cpu", fused_ad="ext", scene=ts)
    params = mrt.extract_params(ts)
    new, loss2, grads2 = step(params, ts, torch.full((16, 3), 0.25), 0, 0.1)
    assert torch.isfinite(loss2)
    for p, q, gr in zip(params, new, grads2):
        torch.testing.assert_close(q, p - 0.1 * gr)


def test_params_from_numpy_carries_an_ext_scene():
    """The JAX package's TrainParams of an ext-material scene, carried over,
    are the port's own, and give the port's ext step the same loss."""
    js, ts = scene_pair("ext_mat")
    carried = mrt.params_from_numpy({k: np.asarray(v) for k, v in
                                     extract_params(js)._asdict().items()})
    for a, b in zip(carried, ttrain.extract_params(ts)):
        assert torch.equal(a, b)
    step = mrt.make_train_step(width=4, height=4, max_bounces=BOUNCES, spp_step=SPP,
                               scan_steps=STEPS, device="cpu", fused_ad="ext", scene=ts)
    target = torch.full((16, 3), 0.25)
    _, l1, _ = step(carried, ts, target, 0, 0.0)
    _, l2, _ = step(ttrain.extract_params(ts), ts, target, 0, 0.0)
    assert float(l1) == float(l2) and float(l1) > 0


def test_ext_paths_refuse_what_they_do_not_take():
    _, ts = scene_pair("ext_tri")
    meta, tables, cfg, _, pix, sb, _ = port_setup(ts)
    with pytest.raises(ValueError, match="one sub-step"):
        tad.sample_pixel_sums_fused(ts, pix, 0, SPP, width=W, height=H, max_bounces=BOUNCES,
                                    use_ext=True, sub_steps=2)
    with pytest.raises(ValueError, match="one sub-step a launch"):
        tad.kernel_params(meta, cfg._replace(k_sub=2), N, 0, ext=True)
    with pytest.raises(ValueError, match="candidate rows"):
        tad._ext_args(dict(meta, ext_mat=True), pix.device, N, None, None)
    with pytest.raises(ValueError, match="ext_mat"):
        tad._check_lanes(pix.device, N, ext_mat=(torch.zeros(5, N), torch.float32, 11))
    with pytest.raises(ValueError, match="images"):
        tad._ext_args(dict(meta, image=True), pix.device, N, torch.zeros(5, N), None)
    cornell = mrt.scenes.cornell_box(1.0)
    with pytest.raises(ValueError, match="hybrid-ext class"):
        mrt.make_train_step(width=4, height=4, max_bounces=4, device="cpu", fused_ad="ext",
                            scene=cornell)
    assert tad.ext_params(dict(meta, image=True), True, torch.zeros(2, 3, 4)) == [
        1, 0, 1, 2, 3, 4]


# ---------------------------------------------------------------------------
# 4. The kernels compiled for the host
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def host_bounce_ad(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the host emulation of the kernels")
    path = tmp_path_factory.mktemp("host_kernels") / "libbounce_ad_host.so"
    subprocess.run([gxx, "-O1", "-std=c++17", "-ffp-contract=off", "-x", "c++",
                    "-DMRT_HOST_EMULATION", "-DMRT_AD_THREADS=1", "-shared", "-fPIC",
                    "-o", str(path), str(kernels.CSRC / "bounce_ad.cu")],
                   check=True, capture_output=True, text=True, timeout=300)
    lib = ctypes.CDLL(str(path))
    lib.mrt_error_string.argtypes = [ctypes.c_int]
    lib.mrt_error_string.restype = ctypes.c_char_p
    return lib


@pytest.mark.parametrize("name", ["random_spheres", "triangles", "earth", "book2_final",
                                  "ext_mat_img"])
def test_emulated_ext_kernels_match_plain(host_bounce_ad, stand_in_assets, monkeypatch, name):
    """B2 and B3 in their ext modes (ext-material, ext, image, ext with image,
    ext-material with image) launch by launch over a scan from the plain
    scan's states: integers and keys equal, floats within 1e-6 of 1+|plain|,
    every entry of `d_f` and `d_ext` within 2e-3*|plain| + 2e-4 of the lane's
    largest, `d_tab` within 1e-4 of its largest entry."""
    ts = (scene_pair(name)[1] if name in JAX_SCENES
          else train_scene(name, stand_in_assets, monkeypatch))

    class Stream:
        cuda_stream = 0

    meta, tables, cfg, outer, pix, sb, images = port_setup(ts, w=8)
    f, i, k = tad.initial_state(ts, pix, sb, SPP, width=8, height=8, sq_off=SQ_OFF)
    cand = tad.ExtCandidate(ts)
    rs = np.random.default_rng(0)
    fwd0, bwd0 = tad.fwd_launches, tad.bwd_launches
    won = 0
    for t in range(outer):
        ext = cand.rows(f, i)
        args = (meta, cfg, tables, t)
        fp, ip, kp = tad.ad_step_fwd_plain(*args, f, i, k, pix, sb, ext, images)
        cot = torch.as_tensor(rs.normal(size=(tad.NF, 64)).astype(np.float32))
        res = f[tad.RES_LO:tad.RES_HI].contiguous()
        dp, tp, ep = tad.ad_step_bwd_plain(*args, res, i, k, pix, sb, cot, ext, images)
        with pytest.MonkeyPatch.context() as mp:  # the wrappers' CUDA branch, on the host
            mp.setattr(kernels, "load", lambda _name: host_bounce_ad)
            mp.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
            mp.setattr(torch.cuda, "current_stream", lambda dev=None: Stream())
            mp.setattr(device, "kind", lambda t_, what: "cuda")
            fk, ik, kk = tad.ad_step_fwd(*args, f, i, k, pix, sb, ext, images)
            dk, tk, ek = tad.ad_step_bwd(*args, res, i, k, pix, sb, cot, None, ext, images)
        assert torch.equal(ik, ip) and torch.equal(kk, kp), t
        assert ((fk - fp).abs() <= 1e-6 * (1 + fp.abs())).all(), t
        top = torch.maximum(dp.abs().amax(0), ep.abs().amax(0))
        assert ((dk - dp).abs() <= 2e-3 * dp.abs() + 2e-4 * top).all(), t
        assert ((ek - ep).abs() <= 2e-3 * ep.abs() + 2e-4 * top).all(), t
        if tp.numel():
            assert float((tk - tp).abs().max()) <= 1e-4 * float(tp.abs().max()) + 1e-30, t
        won += int((ep[:4] != 0).any())
        f, i, k = fp, ip, kp
    assert tad.fwd_launches == fwd0 + outer and tad.bwd_launches == bwd0 + outer
    assert float(f[tad.A_NV].sum()) == 64 * SPP
    if name != "earth":  # earth has no external type: constant candidate rows
        assert won > 0
