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
"""

import contextlib
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from miniraytracer_tpu_torch.models import scenes as tscenes
from miniraytracer_tpu_torch.ops import bounce as tbounce
from miniraytracer_tpu_torch.ops import bounce_ad as tad
from miniraytracer_tpu_torch.parallel import train as ttrain
from miniraytracer_tpu_torch.scene.builder import SceneBuilder
from miniraytracer_tpu_torch.utils import kernels
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
    """{name: CDLL} of bounce.cu and bounce_ad.cu built for the host."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the host emulation of the kernels")
    out = tmp_path_factory.mktemp("host_kernels")
    libs = {}
    for name in ("bounce", "bounce_ad"):
        path = out / f"lib{name}_host.so"
        subprocess.run(
            [gxx, "-O1", "-std=c++17", "-ffp-contract=off", "-x", "c++",
             "-DMRT_HOST_EMULATION", "-DMRT_AD_THREADS=1", "-shared", "-fPIC",
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
    monkeypatch.setattr(tad, "_device_kind", lambda t: "cuda")


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
            monkeypatch.setattr(tad, "_device_kind", lambda t: "cpu")
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
