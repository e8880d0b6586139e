"""The CUDA sources, compiled for the host, against the plain PyTorch versions.

There is no GPU and no nvcc where these tests run, but `csrc/*.cu` compile
with g++ once `csrc/host_emulation.h` stands in for the little CUDA they use
(`-DMRT_HOST_EMULATION`): a launch becomes a loop over blocks and threads on
host pointers. That checks the kernels' logic and arithmetic, the hand-derived
adjoint above all, and the wrappers' argument marshalling; it does not check
the GPU build (`chip_smoke.py` and the `cuda`-marked tests do, on the card).

g++ is given `-ffp-contract=off`, as nvcc is given `--fmad=false`: the
kernels then take the discrete decisions the plain version takes, and floats
differ only where libm's sin, cos, log and exp round differently from
PyTorch's (about 1e-7 of the state's scale).

Blocks run one thread here and warps one lane (`MRT_WARP 1`): a vote is the
lane's own, a shuffle returns what it was given. So the cluster loop of
`flash.cu` runs here with one lane a ray (four on the card) and teams of one
lane; its warp-level logic (the four lanes' slab tests, the teams that share a
cluster's rows out, their reduction) has `chip_smoke.py` (phases 13 and 23:
every ray of real queue steps against the plain versions) as its only check
at 32 lanes.
"""

import contextlib
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from miniraytracer_tpu_torch.models import integrator as tinteg
from miniraytracer_tpu_torch.models import scenes as tscenes
from miniraytracer_tpu_torch.ops import bounce as tbounce
from miniraytracer_tpu_torch.ops import bounce_ad as tad
from miniraytracer_tpu_torch.ops import flash as tflash
from miniraytracer_tpu_torch.ops import hybrid as thybrid
from miniraytracer_tpu_torch.ops import intersect as tix
from miniraytracer_tpu_torch.ops import noise as tnoise
from miniraytracer_tpu_torch.ops.vecmath import V3
from miniraytracer_tpu_torch.parallel import train as ttrain
from miniraytracer_tpu_torch.scene.builder import SceneBuilder
from miniraytracer_tpu_torch.utils import device, kernels
from tests.test_torch_bounce import _synthetic

torch.set_num_threads(1)

SCENES = ["cornell_box", "cornell_smoke", "two_spheres", "perlin_spheres",
          "sphere_light", "synthetic"]


def _scene(name):
    if name == "sphere_light":
        return tscenes.ad_probe()
    if name == "synthetic":  # moving spheres, a triangle, a volume, two lights
        return _synthetic(SceneBuilder)
    return getattr(tscenes, name)(1.0)


@pytest.fixture(scope="module")
def host_libraries(tmp_path_factory):
    """{name: CDLL} of every csrc/*.cu built for the host (blocks of one
    thread, for which the emulation's __syncthreads() is right)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the host emulation of the kernels")
    out = tmp_path_factory.mktemp("host_kernels")
    libs = {}
    for name in ("bounce", "bounce_ad", "flash", "hybrid", "noise"):
        path = out / f"lib{name}_host.so"
        subprocess.run(
            [gxx, "-O1", "-std=c++17", "-ffp-contract=off", "-x", "c++",
             "-DMRT_HOST_EMULATION", "-DMRT_AD_THREADS=1", "-DMRT_FLASH_THREADS=1",
             "-DMRT_NOISE_THREADS=1", "-DMRT_BOUNCE_THREADS=1", "-DMRT_SHADE_THREADS=1",
             "-shared", "-fPIC",
             "-o", str(path), str(kernels.CSRC / f"{name}.cu")],
            check=True, capture_output=True, text=True, timeout=300)
        lib = ctypes.CDLL(str(path))
        lib.mrt_error_string.argtypes = [ctypes.c_int]
        lib.mrt_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


@pytest.fixture
def emulated(host_libraries, monkeypatch):
    """The wrappers' CUDA branch on CPU tensors, into the host libraries."""
    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(kernels, "load", lambda name: host_libraries[name])
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: Stream())
    monkeypatch.setattr(device, "kind", lambda t, what: "cuda")


@pytest.mark.parametrize("name", SCENES)
def test_emulated_ad_step_kernels_match_plain(emulated, name):
    """B2 and B3 launch by launch over a whole scan (2 sub-steps a launch)
    from the plain scan's states: integers and keys equal, floats within
    1e-6 of the state's scale and of 1+|plain| entry by entry, every entry of
    `d_f` within 2e-3*|plain| + 2e-4 of its lane's largest, and `d_tab`
    within 1e-4 of its largest entry, for a seeded cotangent."""
    scene = _scene(name)
    w = h = 12
    spp, bounces = 2, 6
    meta, tables = tbounce.pack_scene(scene)
    _, claim, k_sub, outer = tad.scan_plan(spp, bounces, spp * (bounces + 1) + 2, 2)
    cfg = tad.StepConfig(w, h, 8, bounces, spp, claim, k_sub)
    pix = torch.arange(w * h, dtype=torch.int32)
    sb = torch.zeros_like(pix)
    f, i, k = tad.initial_state(scene, pix, sb, spp, width=w, height=h, sq_off=8)
    rs = np.random.default_rng(0)
    fwd0, bwd0 = tad.fwd_launches, tad.bwd_launches
    touched = 0
    for t in range(outer):
        args = (meta, cfg, tables, t)
        fp, ip, kp = tad.ad_step_fwd_plain(*args, f, i, k, pix, sb)
        fk, ik, kk = tad.ad_step_fwd(*args, f, i, k, pix, sb)
        assert torch.equal(ik, ip) and torch.equal(kk, kp), t
        scale = float(fp.abs().max().clamp_min(1.0))
        assert float((fk - fp).abs().max()) <= 1e-6 * scale, t
        other = [r for r in range(tad.NF) if not tad.A_RO <= r < tad.A_RD]
        assert ((fk - fp).abs() <= 1e-6 * (1 + fp.abs()))[other].all(), t

        cot = torch.as_tensor(rs.normal(size=(tad.NF, w * h)).astype(np.float32))
        res = f[tad.RES_LO:tad.RES_HI].contiguous()
        dp, tp = tad.ad_step_bwd_plain(*args, res, i, k, pix, sb, cot)
        dk, tk = tad.ad_step_bwd(*args, res, i, k, pix, sb, cot)
        lane_top = dp.abs().amax(0)
        assert ((dk - dp).abs() <= 2e-3 * dp.abs() + 2e-4 * lane_top).all(), t
        assert float((tk - tp).abs().max()) <= 1e-4 * float(tp.abs().max()) + 1e-30, t
        touched += int((tp != 0).sum())
        f, i, k = fp, ip, kp
    assert touched > 0
    assert tad.fwd_launches == fwd0 + outer and tad.bwd_launches == bwd0 + outer
    assert float(f[tad.A_NV].sum()) == w * h * spp


def _bwd_scan_case(lib, scene, k_sub, w, at=None):
    """B3 launch by launch over a scan of w x w lanes, 2 spp, 6 bounces,
    `k_sub` sub-steps a launch (at the launches `at`, or at every one), from
    the plain scan's states and a seeded cotangent: every entry of `d_f` (and
    `d_ext`) within 2e-3*|plain| + 2e-4 of its lane's largest, `d_tab` within
    1e-4 of its largest entry. Its grid (`mrt_ad_step_bwd_grid`) is
    persistent: the blocks an SM holds times the SMs, no more than the tiles
    of lanes, with no dynamic shared memory; its blocks walk every lane alive
    at the launch's entry, which `bwd_lanes_walked` counts. Blocks have
    one thread here, so a block's sums of the table cotangents hold one lane;
    the card's blocks of 128 lanes are held by chip_smoke.py (phases 6, 7,
    28: `d_tab` against the plain version's and the parent build's).
    Returns the count of table entries touched."""
    h = w
    n = w * h
    spp, bounces = 2, 6
    ext_mode = not tbounce.can_fuse(scene)
    images = None
    if ext_mode:
        plan = thybrid.smem_plan(scene) if thybrid.ext_mat_mode(scene) else None
        meta, tables = thybrid.pack_scene_hybrid(scene, plan)
        cand = tad.ExtCandidate(scene)
        images = scene.images if meta["image"] else None
    else:
        meta, tables = tbounce.pack_scene(scene)
    _, claim, k, outer = tad.scan_plan(spp, bounces, spp * (bounces + 1) + 2, k_sub)
    assert k == k_sub
    at = range(outer) if at is None else at
    cfg = tad.StepConfig(w, h, 8, bounces, spp, claim, k)
    per_sm, sms, blocks, threads, smem = _grid(lib, "mrt_ad_step_bwd_grid",
                                               tad.kernel_params(meta, cfg, n, 0, ext_mode))
    assert blocks == min(per_sm * sms, -(-n // threads)) and smem == 0, (blocks, threads)
    pix = torch.arange(n, dtype=torch.int32)
    sb = torch.zeros_like(pix)
    f, i, kk = tad.initial_state(scene, pix, sb, spp, width=w, height=h, sq_off=8)
    rs = np.random.default_rng(k_sub)
    bwd0, touched = tad.bwd_launches, 0
    walked0, live = tad.bwd_lanes_walked(), 0
    for t in range(max(at) + 1):
        args = (meta, cfg, tables, t)
        xa = (cand.rows(f, i), images) if ext_mode else ()
        if t in at:
            live += int((f[tad.A_ALIVE] > 0).sum())
            cot = torch.as_tensor(rs.normal(size=(tad.NF, n)).astype(np.float32))
            res = f[tad.RES_LO:tad.RES_HI].contiguous()
            out_p = tad.ad_step_bwd_plain(*args, res, i, kk, pix, sb, cot, *xa)
            out_k = tad.ad_step_bwd(*args, res, i, kk, pix, sb, cot, None, *xa)
            (dp, tp), (dk, tk) = out_p[:2], out_k[:2]
            if ext_mode:
                dp, dk = torch.cat([dp, out_p[2]]), torch.cat([dk, out_k[2]])
            top = dp.abs().amax(0)
            assert ((dk - dp).abs() <= 2e-3 * dp.abs() + 2e-4 * top).all(), t
            if tp.numel():
                assert float((tk - tp).abs().max()) <= 1e-4 * float(tp.abs().max()) + 1e-30, t
                touched += int((tp != 0).sum())
        f, i, kk = tad.ad_step_fwd_plain(*args, f, i, kk, pix, sb, *xa)
    assert tad.bwd_launches == bwd0 + len(at)
    assert tad.bwd_lanes_walked() == walked0 + live
    if len(at) == outer:
        assert float(f[tad.A_NV].sum()) == n * spp
    return touched


@pytest.mark.parametrize("name,k_sub", [
    ("cornell_box", 1), ("cornell_box", 4), ("cornell_box", 8), ("synthetic", 1),
    ("synthetic", 4), ("synthetic", 8), ("perlin_spheres", 1), ("perlin_spheres", 4),
    ("perlin_spheres", 8), ("hybrid_probe", 1), ("random_spheres", 1), ("earth", 1),
    ("random_spheres_2", 1)])
def test_emulated_ad_step_bwd_at_sub_steps(emulated, host_libraries, name, k_sub):
    """B3's instances (`_bwd_scan_case`, 8x8 lanes): the fused class at 4
    sub-steps a launch (the train step's instance, records of 4 sub-steps)
    and at 1 and 8 (the general instance, records of up to 8), and the ext
    (hybrid_probe), ext-material (random_spheres), image (earth) and
    ext-material-with-image (random_spheres_2) modes at their one
    sub-step."""
    if name == "hybrid_probe":
        scene = tscenes.hybrid_probe(1.0, 80, 200)
    elif name in ("random_spheres", "earth", "random_spheres_2"):
        scene = getattr(tscenes, name)(1.0)
    else:
        scene = _scene(name)
    touched = _bwd_scan_case(host_libraries["bounce_ad"], scene, k_sub, 8)
    assert touched > 0 or name in ("random_spheres", "random_spheres_2")


@pytest.mark.parametrize("name", ["cornell_box", "sphere_light", "synthetic"])
def test_emulated_scan_gradients_match_plain_autograd(emulated, monkeypatch, name):
    """The whole scan through `FusedADScan` with the emulated kernels against
    the plain versions: equal sums and counts, every TrainParams gradient
    within rtol 1e-3, atol 1e-4 of the leaf's largest entry."""
    scene = _scene(name)
    w = h = 10
    pix = torch.arange(w * h, dtype=torch.int32)
    out = {}
    for plain in (False, True):
        if plain:  # CPU tensors take the plain versions again
            monkeypatch.setattr(device, "kind", lambda t, what: "cpu")
        leaves = ttrain.TrainParams(*(p.clone().requires_grad_(True)
                                      for p in ttrain.extract_params(scene)))
        launches = tad.fwd_launches
        s, nv, rays = tad.sample_pixel_sums_fused(
            ttrain.apply_params(scene, leaves), pix, 0, 2, width=w, height=h,
            max_bounces=6)
        err = torch.where(nv[:, None] > 0, s / nv.clamp_min(1)[:, None] - 0.25, 0.0)
        grads = torch.autograd.grad((err * err).sum(), list(leaves), allow_unused=True)
        assert (tad.fwd_launches == launches) == plain
        out[plain] = (s.detach(), nv, int(rays), grads)
    (sk, nvk, rk, gk), (sp, nvp, rp, gp) = out[False], out[True]
    assert torch.equal(nvk, nvp) and rk == rp
    torch.testing.assert_close(sk, sp, rtol=0, atol=1e-5)
    seen = 0
    for leaf, a, b in zip(ttrain.TrainParams._fields, gk, gp):
        assert (a is None) == (b is None), leaf
        if b is not None and float(b.abs().max()) > 0:
            torch.testing.assert_close(a, b, rtol=1e-3,
                                       atol=1e-4 * float(b.abs().max()), msg=leaf)
            seen += 1
    assert seen >= 2


@pytest.mark.parametrize("name,keep", [
    ("cornell_box", True), ("cornell_box", False), ("cornell_smoke", True),
    ("cornell_smoke", False), ("random_spheres", True), ("earth", True)])
def test_emulated_planned_scan_forward_equals_per_call(emulated, name, keep):
    """The forward scan through its launch plan (`FwdPlan`: one call of
    `mrt_ad_step_fwd_planned` a launch, B2 storing the residual itself)
    against a call of `ad_step_fwd` a launch after the copies of its entry
    state (`chip_smoke.per_call_scan_forward`), on 12x12 lanes at 2 spp and 6
    bounces: the last state and every part of the residual equal bit for bit
    (without `keep`, the last state; no residual), and `fwd_launches` and
    `fwd_plan_launches` each up by the scan's launches. The fused class at 2
    sub-steps a launch; random_spheres (ext-material mode) and earth (image
    mode) at one, with their candidate rows from outside."""
    import chip_smoke

    scene = _scene(name) if name in SCENES else getattr(tscenes, name)(1.0)
    w = h = 12
    spp, bounces = 2, 6
    cand = images = None
    if tbounce.can_fuse(scene):
        meta, tables = tbounce.pack_scene(scene)
        k_sub = 2
    else:
        meta, tables = thybrid.pack_scene_hybrid(
            scene, thybrid.smem_plan(scene) if thybrid.ext_mat_mode(scene) else None)
        cand = tad.ExtCandidate(scene)
        images = scene.images if meta["image"] else None
        k_sub = 1
    _, claim, k_sub, outer = tad.scan_plan(spp, bounces, spp * (bounces + 1) + 2, k_sub)
    cfg = tad.StepConfig(w, h, 8, bounces, spp, claim, k_sub)
    pix = torch.arange(w * h, dtype=torch.int32)
    sb = torch.full_like(pix, 3)
    state = tad.initial_state(scene, pix, sb, spp, width=w, height=h, sq_off=8)
    fwd0, plan0 = tad.fwd_launches, tad.fwd_plan_launches
    last, residual = tad.scan_forward(meta, cfg, outer, tables, *state, pix, sb, keep=keep,
                                      candidate=cand, images=images)
    assert tad.fwd_launches == fwd0 + outer and tad.fwd_plan_launches == plan0 + outer
    ref_last, ref_residual = chip_smoke.per_call_scan_forward(
        tad, meta, cfg, outer, tables, *state, pix, sb, keep, cand, images)
    assert tad.fwd_launches == fwd0 + 2 * outer and tad.fwd_plan_launches == plan0 + outer
    assert chip_smoke.equal_outputs(last, ref_last)
    if keep:
        assert len(residual) == (3 if cand is None else 4)
        assert chip_smoke.equal_outputs(residual, ref_residual)
    else:
        assert residual is None and ref_residual is None
    assert float(last[0][tad.A_NV].sum()) == w * h * spp


@pytest.mark.parametrize("name", SCENES)
def test_emulated_fused_render_matches_plain(host_libraries, monkeypatch, name):
    """B1 (`bounce.cu`, which shares `physics.cuh` with the AD kernels):
    equal ray and sample counts, frames within 1e-5."""
    monkeypatch.setattr(kernels, "load", lambda lib: host_libraries[lib])
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("Stream", (), {"cuda_stream": 0})())
    scene = _scene(name)
    w = h = 12
    pix = torch.arange(w * h, dtype=torch.int32)
    kw = dict(width=w, height=h, max_bounces=6, spp_sq=2)
    meta, tables = tbounce.pack_scene(scene)
    launches = tbounce.launches
    ak, ck, rk = tbounce._launch_kernel(meta, tables, pix, 0, 4, 1000.0, **kw)
    assert tbounce.launches == launches + 1
    ap, cp, rp = tbounce.render_wavefront_fused_pixels_plain(
        scene, pix, 0, 4, 1000.0, **kw)
    assert torch.equal(ck, cp) and torch.equal(rk, rp)
    frame = lambda a, c: a / c.clamp_min(1)[:, None].float()
    torch.testing.assert_close(frame(ak, ck), frame(ap, cp), rtol=0, atol=1e-5)


def _grid(lib, fn, ip):
    """(blocks an SM holds, SMs, blocks, threads a block, dynamic shared bytes)
    of a launch of B1 (`mrt_fused_render_grid`) or B2 (`mrt_ad_step_fwd_grid`)."""
    out = (ctypes.c_int * 5)()
    getattr(lib, fn)((ctypes.c_int * len(ip))(*ip), out)
    return tuple(out)


def _b1_case(scene, pix, w, h):
    """B1 on the pixels `pix` through the wrapper, against the plain version:
    equal ray and sample counts, frames within 1e-5."""
    kw = dict(width=w, height=h, max_bounces=6, spp_sq=2)
    meta, tables = tbounce.pack_scene(scene)
    launches = tbounce.launches
    ak, ck, rk = tbounce._launch_kernel(meta, tables, pix, 0, 4, 1000.0, **kw)
    assert tbounce.launches == launches + 1
    ap, cp, rp = tbounce.render_wavefront_fused_pixels_plain(scene, pix, 0, 4, 1000.0, **kw)
    assert torch.equal(ck, cp) and torch.equal(rk, rp)
    frame = lambda a, c: a / c.clamp_min(1)[:, None].float()
    torch.testing.assert_close(frame(ak, ck), frame(ap, cp), rtol=0, atol=1e-5)


def _b2_case(scene, w, h, launches_at):
    """B2 launch by launch from the plain scan's states, at the launches in
    `launches_at`: integers and keys equal, floats within 1e-6 of the state's
    scale and of 1+|plain|."""
    meta, tables = tbounce.pack_scene(scene)
    spp, bounces = 2, 6
    _, claim, k_sub, outer = tad.scan_plan(spp, bounces, spp * (bounces + 1) + 2, 2)
    cfg = tad.StepConfig(w, h, 8, bounces, spp, claim, k_sub)
    pix = torch.arange(w * h, dtype=torch.int32)
    sb = torch.zeros_like(pix)
    f, i, k = tad.initial_state(scene, pix, sb, spp, width=w, height=h, sq_off=8)
    for t in range(max(launches_at) + 1):
        args = (meta, cfg, tables, t)
        fp, ip, kp = tad.ad_step_fwd_plain(*args, f, i, k, pix, sb)
        if t in launches_at:
            fk, ik, kk = tad.ad_step_fwd(*args, f, i, k, pix, sb)
            assert torch.equal(ik, ip) and torch.equal(kk, kp), t
            scale = float(fp.abs().max().clamp_min(1.0))
            assert float((fk - fp).abs().max()) <= 1e-6 * scale, t
            other = [r for r in range(tad.NF) if not tad.A_RO <= r < tad.A_RD]
            assert ((fk - fp).abs() <= 1e-6 * (1 + fp.abs()))[other].all(), t
        f, i, k = fp, ip, kp
    return meta, cfg


@pytest.mark.parametrize("name", SCENES)
def test_emulated_persistent_grids_take_several_units(emulated, host_libraries, name):
    """B1 and B2 on a persistent grid of fewer threads than pixels or lanes
    (the emulated card holds 3 one-thread blocks), so that a thread takes
    unit after unit from the work counter: B1 on the pixels in a shuffled
    order (a unit is not its pixel), B2 at the first three launches of a
    scan, each against its plain version; the tables are staged."""
    scene = _scene(name)
    w = h = 12
    n = w * h
    pix = torch.as_tensor(np.random.default_rng(5).permutation(n).astype(np.int32))
    meta, _ = tbounce.pack_scene(scene)
    ip = tbounce.kernel_params(meta, n, 0, 4, width=w, height=h, max_bounces=6, spp_sq=2)
    per_sm, sms, blocks, threads, smem = _grid(host_libraries["bounce"],
                                               "mrt_fused_render_grid", ip)
    assert blocks * threads < n and smem > 0, (blocks, threads, smem)
    _b1_case(scene, pix, w, h)
    meta, cfg = _b2_case(scene, w, h, (0, 1, 2))
    per_sm, sms, blocks, threads, smem = _grid(host_libraries["bounce_ad"],
                                               "mrt_ad_step_fwd_grid",
                                               tad.kernel_params(meta, cfg, n, 0))
    assert blocks * threads < n and smem > 0, (blocks, threads, smem)


def _many_boxes(n_boxes):
    """A fused-class scene of `n_boxes` small boxes on a floor under a rect
    light: tables past the kernels' shared-memory budget (`can_fuse` caps
    no box count)."""
    b = SceneBuilder()
    b.name = "many_boxes"
    b.set_camera([0, 3, 6], [0, 0, 0], [0, 1, 0], 50.0, 1.0, aperture=0.0, focus_dist=6.0,
                 t0=0.0, t1=1.0)
    gray = b.lambertian(b.tex_const([0.6, 0.6, 0.6]))
    red = b.lambertian(b.tex_const([0.8, 0.3, 0.2]))
    lm = b.diffuse_light(b.tex_const([6, 6, 6]))
    b.sphere([0, -1000, 0], 1000, gray)
    side = int(np.ceil(np.sqrt(n_boxes)))
    for j in range(n_boxes):
        x, z = -3 + 6 * (j % side) / side, -3 + 6 * (j // side) / side
        b.box([x, 0, z], [x + 0.1, 0.1 + 0.02 * (j % 7), z + 0.1], red if j % 3 else gray,
              rot_y_deg=float(j % 45))
    b.add_light(b.xz_rect(-1, 1, -1, 1, 3.0, lm))
    return b.build()


def test_emulated_tables_beyond_the_stage_budget(emulated, host_libraries):
    """A fused-class scene whose tables exceed the shared-memory budget of B1
    and B2 (600 boxes, 31 KB) runs their unstaged instances, which read the
    tables from global memory, and still equals the plain versions; the
    Cornell box's tables are staged."""
    scene = _many_boxes(600)
    assert tbounce.can_fuse(scene)
    w = h = 8
    meta, _ = tbounce.pack_scene(scene)
    ip = tbounce.kernel_params(meta, w * h, 0, 4, width=w, height=h, max_bounces=6, spp_sq=2)
    assert _grid(host_libraries["bounce"], "mrt_fused_render_grid", ip)[4] == 0
    cornell, _ = tbounce.pack_scene(_scene("cornell_box"))
    ip_c = tbounce.kernel_params(cornell, w * h, 0, 4, width=w, height=h, max_bounces=6,
                                 spp_sq=2)
    assert 0 < _grid(host_libraries["bounce"], "mrt_fused_render_grid", ip_c)[4] < 1024
    _b1_case(scene, torch.arange(w * h, dtype=torch.int32), w, h)
    meta, cfg = _b2_case(scene, w, h, (0, 2))
    assert _grid(host_libraries["bounce_ad"], "mrt_ad_step_fwd_grid",
                 tad.kernel_params(meta, cfg, w * h, 0))[4] == 0


@pytest.mark.parametrize("k_sub", [4, 2])
def test_emulated_ad_step_bwd_beyond_the_stage_budget(emulated, host_libraries, k_sub):
    """B3's fused-class instances (the train step's, at 4 sub-steps, and the
    general one) on a scene whose tables exceed the shared-memory budget of
    B1 and B2 (600 boxes; B3 reads its tables from global memory in every
    scene), against the plain version as `_bwd_scan_case` holds it, at the
    first launch of a scan of 4x4 lanes (the plain adjoint of 600 boxes is
    slow)."""
    _bwd_scan_case(host_libraries["bounce_ad"], _many_boxes(600), k_sub, 4, (0,))


def _sweep_rays(n, seed):
    """Rays towards the scene's middle, a third of them inside a medium, the
    last 9 NaN (dead lanes)."""
    rs = np.random.default_rng(seed)
    ro = rs.uniform(-6, 6, (n, 3)).astype(np.float32)
    ro[:, 1] = np.abs(ro[:, 1]) + 0.3
    rd = rs.uniform(-3, 3, (n, 3)).astype(np.float32) - ro
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    ro[-9:], rd[-9:] = np.nan, np.nan
    v3 = lambda a: V3(*(torch.as_tensor(np.ascontiguousarray(a[:, k])) for k in range(3)))
    inside = torch.as_tensor((rs.random(n) < 0.3).astype(np.int32))
    return v3(ro), v3(rd), torch.as_tensor(rs.random(n, dtype=np.float32)), inside


@pytest.mark.parametrize("kind,count", [("sphere", 67), ("sphere", 486), ("tri", 65),
                                        ("tri", 300)])
def test_emulated_flash_kernels_match_plain(emulated, kind, count):
    """B7 and B8 (`flash.cu`) against their plain versions: the same sums in
    the same order, so t and the index are EQUAL, NaN lanes and ties
    included (a primitive count that is no multiple of the kernel's tile)."""
    n = 333
    ro, rd, time, inside = _sweep_rays(n, count)
    if kind == "sphere":
        scene = (tscenes.random_spheres(1.0) if count == 486
                 else tscenes.hybrid_probe(1.0, count - 1, 0))
        assert scene.n_spheres == count
        # a twin of a sphere that is hit, further down the table: the lower
        # index must win
        cb, cc = tflash.sphere_coefficients(scene)
        args = (ro, rd, time, inside, tbounce.TMIN)
        t0, i0 = tflash.flash_sphere_hit_plain((cb, cc), *args)
        twin = int(torch.mode(i0[(t0 < 3e38) & (i0 > 0) & (i0 < count - 2)]).values)
        cb[count - 2], cc[count - 2] = cb[twin], cc[twin]
        coeffs = (cb, cc)
        kernel, plain = tflash.flash_sphere_hit, tflash.flash_sphere_hit_plain
        counter = "sphere_launches"
    else:
        scene = tscenes.hybrid_probe(1.0, 4, count)
        coeffs = [c.clone() for c in tflash.scene_tri_coefficients(scene)]
        for c in coeffs:
            c[count - 2] = c[3]
            c[5] = 0.0  # an inactive row: 0/0 inside the sweep
        # aim half of the rays at triangles
        cen = (scene.tri_m + (scene.tri_u + scene.tri_v) / 3)[torch.arange(160) % count]
        d = cen - torch.stack(list(ro), 1)[:160]
        d = d / d.norm(dim=1, keepdim=True)
        rd = V3(*(torch.cat([d[:, k], c[160:]]) for k, c in enumerate(rd)))
        args = (ro, rd, inside, tbounce.TMIN)
        kernel, plain = tflash.flash_tri_hit, tflash.flash_tri_hit_plain
        counter = "tri_launches"
    before = getattr(tflash, counter)
    tk, ik = kernel(coeffs, *args)
    assert getattr(tflash, counter) == before + 1
    tp, ip = plain(coeffs, *args)
    assert torch.equal(ik, ip) and torch.equal(tk, tp)
    hit = tp < 3e38
    assert hit.sum() > 20 and not hit[-9:].any() and (ik[-9:] == 0).all()
    assert not (ik[hit] == count - 2).any()
    if kind == "sphere":
        assert (ik[hit] == twin).any() and (inside[hit] > 0).any()


def _hybrid_scene(name):
    if name == "hybrid_probe":
        return tscenes.hybrid_probe(1.0, 80, 100)
    return getattr(tscenes, name)(1.0)


@pytest.mark.parametrize("name", ["hybrid_probe", "random_spheres", "earth"])
def test_emulated_hybrid_render_matches_plain(emulated, name):
    """B4 (`hybrid.cu`) in its three modes (5 candidate rows, 11 rows, image
    texels), fed by the emulated B7/B8: every step of a whole render against
    the plain step on the same state (integers, keys, ray counts and the alive
    row equal; floats within 1e-6 of the row's scale), then the whole render
    through the kernels against the plain one."""
    scene = _hybrid_scene(name)
    w = h = 12
    sq, bounces = 2, 6
    pix = torch.arange(w * h, dtype=torch.int32)
    meta, tables = thybrid.pack_scene_hybrid(scene)
    cfg = thybrid.StepConfig(meta=meta, tables=tuple(tables), images=scene.images,
                             width=w, height=h, sq=sq, max_bounces=bounces,
                             max_lum=1000.0, sample_lo=0, n_samples=sq * sq)
    accel = thybrid.hybrid_accel(scene)
    state = thybrid.initial_state(scene, pix, 0, sq * sq, width=w, height=h, spp_sq=sq)
    launches, steps = thybrid.step_launches, 0
    while bool((state[0][thybrid.R_ALIVE] > 0).any()):
        f, i = state[0], state[1]
        ext = torch.stack(thybrid._external_candidate(
            scene, accel, thybrid.state_rays(f, i), f[thybrid.R_ALIVE] > 0,
            tbounce.TMIN, plain=True))
        fk, ik, kk, rk = thybrid.hybrid_step(cfg, *state, pix, ext)
        fp, ip, kp, rp = thybrid.hybrid_step_plain(cfg, *state, pix, ext)
        assert torch.equal(ik, ip) and torch.equal(kk, kp) and torch.equal(rk, rp), steps
        assert torch.equal(fk[thybrid.R_ALIVE], fp[thybrid.R_ALIVE]), steps
        scale = fp.abs().amax(dim=1, keepdim=True).clamp_min(1.0)
        assert ((fk - fp).abs() <= 1e-6 * scale).all(), steps
        state = (fp, ip, kp, rp)
        steps += 1
    assert thybrid.step_launches == launches + steps and steps > bounces
    assert int(state[1][thybrid.I_COUNT].sum()) == w * h * sq * sq

    kw = dict(width=w, height=h, max_bounces=bounces, spp_sq=sq)
    ak, ck, rk = thybrid.render_wavefront_hybrid_pixels(scene, pix, 0, sq * sq, 1000.0, **kw)
    ap, cp, rp = thybrid.render_wavefront_hybrid_pixels(scene, pix, 0, sq * sq, 1000.0,
                                                        plain=True, **kw)
    assert torch.equal(ck, cp) and torch.equal(rk, rp)
    frame = lambda a, c: a / c.clamp_min(1)[:, None].float()
    torch.testing.assert_close(frame(ak, ck), frame(ap, cp), rtol=0, atol=1e-5)


def _clustered_case(name):
    """(scene, rays) for the clustered sphere sweeps: book2_final's 1006
    spheres (a moving one, glass, a cloud of 1000) or a probe of 701; rays
    from around the scene towards its spheres, a third inside a medium, the
    last 9 NaN."""
    n = 400
    ro, rd, time, inside = _sweep_rays(n, 21)
    if name == "book2_final":
        scene = tscenes.book2_final(1.0)
        rs = np.random.default_rng(4)
        o = rs.uniform(-300, 600, (n, 3)).astype(np.float32)
        aim = scene.sph_c0.numpy()[rs.integers(0, scene.n_spheres, n)]
        d = aim + rs.normal(0, 6, (n, 3)).astype(np.float32) - o
        d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
        o[-9:], d[-9:] = np.nan, np.nan
        v3 = lambda a: V3(*(torch.as_tensor(np.ascontiguousarray(a[:, k])) for k in range(3)))
        ro, rd = v3(o), v3(d)
    else:
        scene = tscenes.hybrid_probe(1.0, 700, 0)
    return scene, (ro, rd, time, inside)


@pytest.mark.parametrize("kind", ["gated", "streamed"])
@pytest.mark.parametrize("name", ["book2_final", "hybrid_probe"])
def test_emulated_clustered_sphere_kernels_match_plain(emulated, kind, name):
    """B13 and B12 (`flash.cu`) against their plain versions and against the
    dense sweep: t and the index EQUAL on every ray, NaN lanes included (they
    come back (INF, 0), or their seed). The tie rule: of two table rows with
    the same coefficients the FIRST IN MORTON ORDER wins, also where the
    other has the lower scene index. B12 with a finite seed on half of the
    rays returns the seed, with index 0, where no sphere is nearer."""
    scene, (ro, rd, time, inside) = _clustered_case(name)
    coeffs = tflash.sphere_coefficients(scene)
    (cbp, ccp), bounds, orig_of = tflash.sph_cull_build(scene, coeffs)
    rays = (ro, rd, time, inside, tbounce.TMIN)
    t_d, i_d = tflash.flash_sphere_hit_plain(coeffs, *rays)
    if kind == "gated":
        kernel, plain, counter = (tflash.flash_sphere_hit_gated,
                                  tflash.flash_sphere_hit_gated_plain, "gated_launches")
    else:
        kernel, plain, counter = (tflash.flash_sphere_hit_streamed,
                                  tflash.flash_sphere_hit_streamed_plain, "streamed_launches")
    cull = ((cbp, ccp), bounds, orig_of)
    before = getattr(tflash, counter)
    tk, ik = kernel(cull, *rays)
    assert getattr(tflash, counter) == before + 1
    tp, ip = plain(cull, *rays)
    assert torch.equal(tk, tp) and torch.equal(ik, ip)
    assert ik.dtype == torch.int32 and tk.dtype == torch.float32
    hit = tp < 3e38
    assert hit.sum() > 100 and not hit[-9:].any() and (ik[-9:] == 0).all()
    assert (inside[hit] > 0).any()
    # the per-ray gate against the dense sweep: equal (no grazing ray here)
    assert torch.equal(tp, t_d) and torch.equal(ip[hit], i_d[hit])

    # a twin: a row later in the same cluster, of a LOWER scene index
    block = cbp.shape[0] // bounds.shape[1]
    pos_of = torch.empty_like(orig_of)
    pos_of[orig_of.long()[:scene.n_spheres]] = torch.arange(scene.n_spheres, dtype=torch.int32)
    pair = None
    for first in torch.unique(pos_of[ip[hit].long()]).tolist():
        end = min((first // block + 1) * block, scene.n_spheres)
        later = [q for q in range(first + 1, end) if orig_of[q] < orig_of[first]]
        if later:
            pair = (first, later[0])
            break
    assert pair is not None
    first, second = pair
    cb2, cc2 = cbp.clone(), ccp.clone()
    cb2[second], cc2[second] = cbp[first], ccp[first]
    tk2, ik2 = kernel(((cb2, cc2), bounds, orig_of), *rays)
    tp2, ip2 = plain(((cb2, cc2), bounds, orig_of), *rays)
    assert torch.equal(tk2, tp2) and torch.equal(ik2, ip2)
    on_it = ip == orig_of[first]
    assert on_it.any() and (ik2[on_it] == orig_of[first]).all()
    assert not (ik2 == orig_of[second]).any()

    if kind == "streamed":
        rs = np.random.default_rng(8)
        seed = torch.where(torch.as_tensor(rs.random(tp.shape[0]) < 0.5),
                           torch.as_tensor(rs.uniform(0.3, 1.2, tp.shape[0]).astype(np.float32))
                           * tp.clamp_max(1e4), torch.full_like(tp, 3.0e38))
        tks, iks = kernel(cull, *rays, seed)
        tps, ips = plain(cull, *rays, seed)
        assert torch.equal(tks, tps) and torch.equal(iks, ips)
        nearer = tp < seed
        assert nearer.any() and (~nearer & hit).any()
        assert torch.equal(tks[nearer], tp[nearer]) and torch.equal(iks[nearer], ip[nearer])
        assert torch.equal(tks[~nearer], seed[~nearer]) and (iks[~nearer] == 0).all()


def _queue_scene(name, tmp_path=None, monkeypatch=None):
    if name == "hybrid_probe":
        return tscenes.hybrid_probe(1.0, 80, 100)
    if name == "triangles":  # 1,376 stand-in mesh triangles: the clustered sweep
        monkeypatch.setenv("MRT_ASSETS", tscenes.write_stand_in_meshes(
            str(tmp_path), bunny_subdiv=3, torus_segments=(8, 6)))
        scene = tscenes.triangles(1.0)
        assert scene.n_tris == 1280 + 96
        return scene
    return getattr(tscenes, name)(1.0)


@pytest.mark.parametrize("name", ["earth", "book2_final", "hybrid_probe", "random_spheres",
                                  "triangles"])
def test_emulated_workqueue_render_matches_plain(emulated, monkeypatch, tmp_path, name):
    """B5 (`hybrid.cu`) in its modes (image texels and no outside set;
    outside spheres through B13 and boxes, an image, volumes; 5 candidate
    rows; 11 rows; an outside triangle set through B10), fed by the emulated
    sweeps: every step of a whole
    work-queue render against the plain shade step on the same lanes (`cont`
    and `new_inside` equal, floats within 1e-6 of the row's scale), then the
    whole render through the kernels against the plain one: equal claims and
    ray counts, frames within 3e-5 on 99% of the pixels (libm's sin, cos, log
    and exp against PyTorch's, carried through up to 6 bounces) and within
    2e-3 on all (book2's thin fog turns the rounding of one log into 1e-3 of a
    hit point). 324 lanes, with lanes inside glass beyond the first 128."""
    scene = _queue_scene(name, tmp_path, monkeypatch)
    w = h = 18
    sq, bounces = 2, 6
    kernel_step = thybrid.shade_step
    resident = tflash.resident_launches
    seen = {"steps": 0, "inside": 0}

    def both(cfg, fstate, inside, keys_b, ext):
        fk, ik = kernel_step(cfg, fstate, inside, keys_b, ext)
        fp, ip = thybrid.shade_step_plain(cfg, fstate, inside, keys_b, ext)
        assert torch.equal(ik, ip) and torch.equal(fk[thybrid.SO_CONT], fp[thybrid.SO_CONT])
        scale = fp.abs().amax(dim=1, keepdim=True).clamp_min(1.0)
        assert ((fk - fp).abs() <= 1e-6 * scale).all(), seen["steps"]
        seen["steps"] += 1
        seen["inside"] += int((ip[128:] > 0).sum())
        return fp, ip

    kw = dict(width=w, height=h, max_bounces=bounces, spp_sq=sq)
    launches = thybrid.shade_launches
    monkeypatch.setattr(thybrid, "shade_step", both)
    stats_c = {}
    tinteg.render_workqueue_pixels(scene, w * h, w * h, sq * sq, 1000.0, stats=stats_c, **kw)
    assert thybrid.shade_launches == launches + seen["steps"] == launches + stats_c["steps"]
    assert stats_c["steps"] > bounces
    if name != "earth":
        assert seen["inside"] > 0
    # the triangle sweep launched once a step, the others never
    assert tflash.resident_launches == resident + (stats_c["steps"] if name == "triangles" else 0)

    monkeypatch.setattr(thybrid, "shade_step", kernel_step)
    stats_k, stats_p = {}, {}
    ak, ck, rk = tinteg.render_workqueue_pixels(scene, w * h, 200, sq * sq, 1000.0,
                                                stats=stats_k, **kw)
    ap, cp, rp = tinteg.render_workqueue_pixels(scene, w * h, 200, sq * sq, 1000.0,
                                                stats=stats_p, plain=True, **kw)
    assert stats_k == stats_p and int(rk) == int(rp)
    assert torch.equal(ck, cp) and int(ck.sum()) == w * h * sq * sq
    frame = lambda a, c: a / c.clamp_min(1)[:, None]
    err = (frame(ak, ck) - frame(ap, cp)).abs().amax(dim=1)
    assert float((err <= 3e-5).float().mean()) >= 0.99 and float(err.max()) <= 2e-3


@pytest.mark.parametrize("n,span", [(777, 300.0), (4097, 9.0)])
def test_emulated_turbulence_matches_plain(emulated, n, span):
    """B6 (`noise.cu`, `physics.cuh::turbulence` over tables staged in shared
    memory) against `flash_turbulence_plain`: EQUAL, on points whose lattice
    cells run negative (the `& 255` wrap) and an N that is no multiple of the
    block, from components that are views of one strided tensor."""
    ptab = tnoise.noise_tables(tscenes.perlin_spheres(1.0))
    rs = np.random.default_rng(n)
    pts = torch.as_tensor(rs.uniform(-span, span, (n, 3)).astype(np.float32))
    pts[:7] = torch.tensor([-0.5, -256.25, -1e-3])  # negative cells next to 0 and 256
    p = V3(pts[:, 0], pts[:, 1], pts[:, 2])
    launches = tnoise.launches
    got = tnoise.flash_turbulence(ptab, p)
    assert tnoise.launches == launches + 1
    assert torch.equal(got, tnoise.flash_turbulence_plain(ptab, p))
    assert (pts < 0).any() and got.shape == (n,)


@pytest.mark.parametrize("n", [1001, 65, 7])
def test_emulated_turbulence_on_a_persistent_grid(emulated, host_libraries, n):
    """B6 on a persistent grid of fewer threads than points (the emulated
    card holds 3 one-thread blocks), so that a thread strides over point
    after point from the tables its block staged: EQUAL to
    `flash_turbulence_plain` on an odd count of points whose lattice cells
    run negative."""
    grid = (ctypes.c_int * 5)()
    host_libraries["noise"].mrt_turbulence_grid(n, grid)
    per_sm, sms, blocks, threads, smem = tuple(grid)
    assert blocks * threads < n and blocks == per_sm * sms, tuple(grid)
    ptab = tnoise.noise_tables(tscenes.random_spheres_2(1.0))
    rs = np.random.default_rng(n)
    pts = torch.as_tensor(rs.uniform(-40.0, 40.0, (3, n)).astype(np.float32))
    pts[:, 0] = -3.5
    p = V3(pts[0], pts[1], pts[2])
    launches = tnoise.launches
    got = tnoise.flash_turbulence(ptab, p)
    assert tnoise.launches == launches + 1
    assert torch.equal(got, tnoise.flash_turbulence_plain(ptab, p))
    assert (pts < 0).any() and (got > 0).all()


def _shade_grid(lib, cfg, n):
    """(blocks an SM holds, SMs, blocks, threads, dynamic shared bytes) of a
    launch of B5 on `n` lanes of the scene `cfg` packs."""
    ip = tbounce.kernel_params(cfg.meta, n, 0, 0, width=1, height=1, max_bounces=0, spp_sq=1)
    ip += [int(bool(cfg.meta.get("ext_mat"))), int(cfg.meta["image"]), *cfg.images.shape]
    return _grid(lib, "mrt_shade_step_grid", ip)


@pytest.mark.parametrize("name", ["hybrid_probe", "random_spheres", "earth", "book2_final"])
def test_emulated_shade_step_on_a_persistent_grid(emulated, host_libraries, monkeypatch, name):
    """B5 in its four modes (5 candidate rows; 11 rows; image texels with no
    outside set; image texels with outside spheres and boxes) on a
    persistent grid of fewer threads than lanes, so that a thread strides
    over lane after lane: on the lanes of queue steps 0, 1, 2 and a late one
    of a whole render, against the plain shade step as the work-queue test
    holds it (`cont` and `new_inside` equal, floats within 1e-6 of the row's
    scale: libm against PyTorch)."""
    scene = _queue_scene(name)
    w = h = 12
    calls = []
    real = thybrid.shade_step

    def record(*args):
        calls.append(args)
        return thybrid.shade_step_plain(*args)

    monkeypatch.setattr(thybrid, "shade_step", record)
    tinteg.render_workqueue_pixels(scene, w * h, w * h, 4, 1000.0, width=w, height=h,
                                   max_bounces=6, spp_sq=2)
    monkeypatch.setattr(thybrid, "shade_step", real)
    cfg = calls[0][0]
    mode = ("ext_mat" if cfg.meta.get("ext_mat") else "image" if cfg.meta["image"] else "ext")
    assert mode == {"hybrid_probe": "ext", "random_spheres": "ext_mat"}.get(name, "image")
    n = w * h
    per_sm, sms, blocks, threads, smem = _shade_grid(host_libraries["hybrid"], cfg, n)
    assert blocks * threads < n and blocks == per_sm * sms and smem == 0
    for t in (0, 1, 2, len(calls) - 2):
        args = calls[t]
        launches = thybrid.shade_launches
        fk, ik = thybrid.shade_step(*args)
        assert thybrid.shade_launches == launches + 1
        fp, ip = thybrid.shade_step_plain(*args)
        assert torch.equal(ik, ip) and torch.equal(fk[thybrid.SO_CONT], fp[thybrid.SO_CONT]), t
        assert bool((fk[thybrid.SO_CONT] > 0).any()) or t > 2, t
        scale = fp.abs().amax(dim=1, keepdim=True).clamp_min(1.0)
        assert ((fk - fp).abs() <= 1e-6 * scale).all(), t


@pytest.mark.parametrize("plain", [False, True])
def test_emulated_external_candidate_samples_perlin_through_b6(emulated, plain):
    """`hybrid._external_candidate` on random_spheres_2 (ext-material mode, a
    Perlin texture among the outside spheres' materials): the winner's
    Perlin albedo goes through kernel B6 (one launch a call) unless `plain`,
    and through its plain version for the differentiable candidate
    (`coeffs`); the rows are equal to the plain ones bit for bit either
    way."""
    scene = tscenes.random_spheres_2(1.0)
    assert thybrid.ext_mat_mode(scene) and scene.has_perlin
    w = h = 10
    pix = torch.arange(w * h, dtype=torch.int32)
    f, i, _, _ = thybrid.initial_state(scene, pix, 0, 1, width=w, height=h, spp_sq=1)
    rays, alive = thybrid.state_rays(f, i), f[thybrid.R_ALIVE] > 0
    accel = thybrid.hybrid_accel(scene)
    ptab = tnoise.noise_tables(scene)
    ref = thybrid._external_candidate(scene, accel, rays, alive, tbounce.TMIN, ptab, plain=True)
    launches = tnoise.launches
    rows = thybrid._external_candidate(scene, accel, rays, alive, tbounce.TMIN, ptab,
                                       plain=plain)
    assert tnoise.launches == launches + (0 if plain else 1)
    assert all(torch.equal(a, b) for a, b in zip(rows, ref))
    coeffs = thybrid.ext_coefficients(scene, accel)
    rows = thybrid._external_candidate(scene, accel, rays, alive, tbounce.TMIN, ptab,
                                       plain=plain, coeffs=coeffs)
    assert tnoise.launches == launches + (0 if plain else 1)
    assert all(torch.equal(a, b) for a, b in zip(rows, ref))
    albedo = torch.stack(ref[7:10])
    assert float(albedo.std()) > 0  # the winners' albedos vary: the rows carry a texture


@pytest.mark.parametrize("name,accel,counters", [
    ("random_spheres_2", {"sph", "perlin"}, ("sphere_launches", "noise")),
    ("triangles", {"tri_cull"}, ("resident_launches",))])
def test_emulated_eager_queue_matches_plain(emulated, monkeypatch, tmp_path, name, accel,
                                            counters):
    """The work queue with its shading in tensor operations: random_spheres_2
    through the sweep B8 and the turbulence B6, the triangles scene (stand-in
    meshes) through the seeded clustered sweep B10, emulated, against their
    plain versions. The kernels equal their plain versions to the bit, so the
    two renders are equal: steps, claims, rays and frames."""
    scene = _queue_scene(name, tmp_path, monkeypatch)
    assert set(tix.make_accel(scene)) == accel
    count = lambda: [tnoise.launches if c == "noise" else getattr(tflash, c) for c in counters]
    kw = dict(width=10, height=10, max_bounces=5, spp_sq=2, fused_shade=False)
    launches = count()
    stats_k, stats_p = {}, {}
    ak, ck, rk = tinteg.render_workqueue_pixels(scene, 100, 100, 4, 1000.0, stats=stats_k, **kw)
    assert count() == [n + stats_k["steps"] for n in launches]
    ap, cp, rp = tinteg.render_workqueue_pixels(scene, 100, 100, 4, 1000.0, stats=stats_p,
                                                plain=True, **kw)
    assert count() == [n + stats_k["steps"] for n in launches]
    assert stats_k == stats_p and int(rk) == int(rp)
    assert torch.equal(ck, cp) and torch.equal(ak, ap)
    assert int(rk) > 400


def _tri_cluster_case(name):
    """(cull, dense tables, rays) for the clustered triangle sweeps: 1,100
    scattered triangles (`hybrid_probe`) with rays towards them, a fifth
    inside a medium, the last 9 NaN; or a flat 16x16 grid of quads on y = 0
    (every cluster's box of zero thickness in y) under rays going down."""
    n = 600
    rs = np.random.default_rng(31)
    v3 = lambda a: V3(*(torch.as_tensor(np.ascontiguousarray(a[:, k])) for k in range(3)))
    if name == "flat":
        k = np.arange(17, dtype=np.float32)
        gx, gz = np.meshgrid(k, k, indexing="ij")
        p = np.stack([gx, np.zeros_like(gx), gz], -1)
        a, b, c, d = p[:-1, :-1], p[1:, :-1], p[1:, 1:], p[:-1, 1:]
        m = v3(np.concatenate([a, a]).reshape(-1, 3))
        u = v3(np.concatenate([c - a, d - a]).reshape(-1, 3))
        v = v3(np.concatenate([b - a, c - a]).reshape(-1, 3))
        act = torch.ones(512, dtype=torch.bool)
        coeffs = tflash.tri_coefficients(m, u, v, act)
        cull = tflash.tri_cull_build(m, u, v, act, coeffs)
        ro = np.stack([rs.uniform(0.5, 15.5, n), np.full(n, 5.0), rs.uniform(0.5, 15.5, n)], 1)
        rd = np.tile(np.array([[0.0, -1.0, 0.0]]), (n, 1))
    else:
        scene = tscenes.hybrid_probe(1.0, 4, 1100)
        coeffs = tflash.scene_tri_coefficients(scene)
        cull = tflash.scene_tri_cull(scene)
        ro = rs.uniform(-8, 8, (n, 3))
        ro[:, 1] = np.abs(ro[:, 1]) + 0.3
        aim = (scene.tri_m + (scene.tri_u + scene.tri_v) / 3).numpy()[rs.integers(0, 1100, n)]
        rd = aim + rs.normal(0, 0.03, (n, 3)) - ro
        rd /= np.linalg.norm(rd, axis=1, keepdims=True)
        ro[-9:], rd[-9:] = np.nan, np.nan
    inside = torch.as_tensor((rs.random(n) < 0.2).astype(np.int32))
    return cull, coeffs, (v3(ro.astype(np.float32)), v3(rd.astype(np.float32)), inside,
                          tbounce.TMIN)


@pytest.mark.parametrize("route", ["culled", "culled_unsorted", "resident", "streamed"])
@pytest.mark.parametrize("name", ["probe", "flat"])
def test_emulated_clustered_tri_kernels_match_plain(emulated, name, route):
    """B9, B10 and B11 (`flash.cu`: the cluster loop of the sphere sweeps,
    generic over the primitive, with the dense sweep's triangle pair test)
    against their plain versions: t and the index EQUAL on every ray, NaN
    lanes included, rays in 5 groups of the visiting order; against the dense
    sweep equal in t (a flat axis-aligned cluster: no hit at all, as in the
    JAX package). Each launch counts on its own counter. With a finite seed on
    half of the rays, the seed comes back, with index 0, where no triangle is
    nearer. Of two equal rows in a cluster the first in the table wins."""
    cull, coeffs, rays = _tri_cluster_case(name)
    kernel = getattr(tflash, "flash_tri_hit_" + route.replace("_unsorted", ""))
    plain = getattr(tflash, "flash_tri_hit_" + route.replace("_unsorted", "") + "_plain")
    kw = {"sort_rays": False} if route == "culled_unsorted" else {}
    counter = {"culled": "culled_launches", "resident": "resident_launches",
               "streamed": "tri_streamed_launches"}[route.replace("_unsorted", "")]
    before = getattr(tflash, counter)
    tk, ik = kernel(cull, *rays, **kw)
    assert getattr(tflash, counter) == before + 1
    tp, ip = plain(cull, *rays, **kw)
    assert torch.equal(tk, tp) and torch.equal(ik, ip)
    assert tk.dtype == torch.float32 and ik.dtype == torch.int32
    td, idd = tflash.flash_tri_hit_plain(coeffs, *rays)
    hit = td < 3e38
    if name == "flat":
        assert hit.all() and (tp == 3e38).all() and (ip == 0).all()
        return
    assert torch.equal(tp, td) and hit.sum() > 300 and not hit[-9:].any()
    assert (ik[-9:] == 0).all() and (rays[2][hit] > 0).any()
    assert float((ip[hit] == idd[hit]).float().mean()) > 0.99

    rs = np.random.default_rng(8)
    seed = torch.where(torch.as_tensor(rs.random(td.shape[0]) < 0.5),
                       torch.as_tensor(rs.uniform(0.3, 1.2, td.shape[0]).astype(np.float32))
                       * td.clamp_max(1e4), torch.full_like(td, 3.0e38))
    tks, iks = kernel(cull, *rays, seed, **kw)
    tps, ips = plain(cull, *rays, seed, **kw)
    assert torch.equal(tks, tps) and torch.equal(iks, ips)
    nearer = td < seed
    assert nearer.any() and (~nearer & hit).any()
    assert torch.equal(tks[nearer], td[nearer]) and torch.equal(iks[nearer], ip[nearer])
    assert torch.equal(tks[~nearer], seed[~nearer]) and (iks[~nearer] == 0).all()

    # a twin: a row later in the winner's cluster gets the winner's coefficients
    cds, bounds, orig_of, cl_ord = cull
    block = cds[0].shape[0] // bounds.shape[1]
    pos_of = torch.empty_like(orig_of)
    pos_of[orig_of.long()[:1100]] = torch.arange(1100, dtype=torch.int32)
    first = next(f for f in torch.unique(pos_of[ip[hit].long()]).tolist()
                 if (f + 1) % block and f + 1 < 1100)
    twin = tuple(c.clone() for c in cds)
    for c in twin:
        c[first + 1] = c[first]
    tk2, ik2 = kernel((twin, bounds, orig_of, cl_ord), *rays, **kw)
    tp2, ip2 = plain((twin, bounds, orig_of, cl_ord), *rays, **kw)
    assert torch.equal(tk2, tp2) and torch.equal(ik2, ip2)
    on_it = ip == orig_of[first]
    assert on_it.any() and (ik2[on_it] == orig_of[first]).all()


def _shared_edge_case():
    """Two planar meshes on one tilted plane (y = x), the second offset by
    half a cell along it: each a 16 x 16 grid of quads with integer (or
    half-integer) vertices, two triangles a quad, 1024 in 16 clusters of 64
    whose boxes overlap. Rays with dyadic origins and directions go down the
    boxes' diagonal (x and y falling) to points of the plane: every inner
    product is exact, so the triangles of both meshes under a point give the
    same t to the bit, often from two clusters that the ray enters before the
    hit. Returns (cull, coeffs, rays, triangles)."""
    rs = np.random.default_rng(5)
    k = np.arange(17, dtype=np.float32)
    gx, gz = np.meshgrid(k, k, indexing="ij")
    ms, us, vs = [], [], []
    for off in (0.0, 0.5):
        p = np.stack([gx + off, gx + off, gz + off], -1)
        a, b, c, d = p[:-1, :-1], p[1:, :-1], p[1:, 1:], p[:-1, 1:]
        ms.append(np.concatenate([a, a]).reshape(-1, 3))
        us.append(np.concatenate([b - a, c - a]).reshape(-1, 3))
        vs.append(np.concatenate([c - a, d - a]).reshape(-1, 3))
    v3 = lambda x: V3(*(torch.as_tensor(np.ascontiguousarray(x[:, q])) for q in range(3)))
    m, u, v = (v3(np.concatenate(x)) for x in (ms, us, vs))
    act = torch.ones(1024, dtype=torch.bool)
    coeffs = tflash.tri_coefficients(m, u, v, act)
    cull = tflash.tri_cull_build(m, u, v, act, coeffs)
    n = 700
    gi = rs.integers(2, 63, (n, 2)).astype(np.float32) / 4
    target = np.stack([gi[:, 0], gi[:, 0], gi[:, 1]], 1)
    rd = np.stack([rs.integers(-2, 3, n) / 16 - 1.0, rs.integers(-2, 3, n) / 16 - 0.5,
                   rs.integers(-4, 5, n) / 8], 1).astype(np.float32)
    ro = (target - 4.0 * rd).astype(np.float32)
    inside = torch.as_tensor((rs.random(n) < 0.3).astype(np.int32))
    return cull, coeffs, (v3(ro), v3(rd), inside, tbounce.TMIN), 1024


@pytest.mark.parametrize("route", ["culled", "resident", "streamed"])
def test_emulated_cluster_loop_ties_across_clusters(emulated, route):
    """The cluster loop where two triangles of DIFFERENT clusters give a ray
    the same t and the ray enters both clusters' boxes before that t
    (`_shared_edge_case`): the first cluster visited keeps the hit (a strict
    `<` in visiting order), as the plain version has it: t and index EQUAL to
    plain on every ray, t equal to the dense sweep's; such rays do occur
    here, and on many rays the visiting order picks another of the tied
    triangles than the dense sweep's lowest index."""
    cull, coeffs, rays, n_tri = _shared_edge_case()
    kernel = getattr(tflash, f"flash_tri_hit_{route}")
    plain = getattr(tflash, f"flash_tri_hit_{route}_plain")
    tk, ik = kernel(cull, *rays)
    tp, ip = plain(cull, *rays)
    assert torch.equal(tk, tp) and torch.equal(ik, ip)
    td, idd = tflash.flash_tri_hit_plain(coeffs, *rays)
    assert torch.equal(tp, td) and bool((tp < 3e38).all())
    # the rays whose nearest t lies in two clusters or more that the gate
    # lets the ray into even once that t is its best
    ro, rd, inside, tmin = rays
    cand = tflash._tri_candidates(coeffs, tflash.ray_features(ro, rd), inside, tmin)
    cds, bounds, orig_of, _ = cull
    nc = bounds.shape[1]
    cluster_of = torch.empty(n_tri, dtype=torch.int64)
    cluster_of[orig_of.long()[:n_tri]] = torch.arange(n_tri) // (cds[0].shape[0] // nc)
    tnear, tfar = tflash._slab_distances(bounds[0:3, None, :], bounds[3:6, None, :], ro,
                                         [1.0 / c for c in rd])
    gated = tflash._crosses(tnear, tfar, tmin) & (tnear < td[:, None])
    at_min = cand == td[None, :]
    tied = torch.stack([(at_min & (cluster_of[:, None] == c)).any(0) for c in range(nc)], 1)
    assert int(((tied & gated).sum(1) >= 2).sum()) > 50
    assert int((ip != idd).sum()) > 100
