"""What B3's walk over the live lanes rests on, and the walk itself on the host.

B3 (`csrc/bounce_ad.cu`, `ad_step_bwd_kernel`) walks only the lanes alive at
its launch's entry and carries the scan's cotangent in one buffer, in place
(`bounce_ad.scan_backward`). That is exact because

- a lane dead at a launch's entry passes its cotangent through, with the
  alive row zeroed, and adds nothing to the table cotangents;
- a dead lane stays dead: the residual's alive rows never rise from one
  launch to the next;
- the alive row of the cotangent is zero from the loss on, so a dead lane's
  rows, left where they are, are what the parent walk wrote there.

The first three tests hold the plain step (`ad_step_bwd_plain`) to that on
the Cornell box and the smoke box at 8x8 pixels, 4 and 8 samples, 6 bounces:
scans whose last launches hold no live lane. The others run the kernel
compiled for the host (as tests/test_torch_kernel_emulation.py does) over
such a scan: it writes no row of a dead lane, the in-place walk equals the
per-call B3 launch by launch bit for bit and counts the live lanes it walks,
and in an ext mode it leaves `d_ext` zero on dead lanes.
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
from miniraytracer_tpu_torch.ops import hybrid as thybrid
from miniraytracer_tpu_torch.utils import device, kernels

torch.set_num_threads(1)

SCENES = ["cornell_box", "cornell_smoke"]
W = 8
BOUNCES = 6


def _scan(name, spp, w=W, bounces=BOUNCES):
    """(meta, cfg, outer, tables, pix, sb, last state, residual) of the plain
    scan of `name` at w x w, `spp` samples, the default scan length."""
    scene = getattr(tscenes, name)(1.0)
    meta, tables = tbounce.pack_scene(scene)
    _, claim, k_sub, outer = tad.scan_plan(spp, bounces)
    cfg = tad.StepConfig(w, w, 8, bounces, spp, claim, k_sub)
    pix = torch.arange(w * w, dtype=torch.int32)
    sb = torch.zeros_like(pix)
    state = tad.initial_state(scene, pix, sb, spp, width=w, height=w, sq_off=8)
    last, residual = tad.scan_forward(meta, cfg, outer, tables, *state, pix, sb)
    return meta, cfg, outer, tables, pix, sb, last, residual


def _alive(residual):
    """(launches, N) bool: the lanes alive at each launch's entry."""
    return residual[0][:, tad.A_ALIVE - tad.RES_LO] > 0


@pytest.mark.parametrize("spp", [4, 8])
@pytest.mark.parametrize("name", SCENES)
def test_dead_lane_cotangent_passes_through_the_plain_step(name, spp):
    """(i) At every launch, a lane dead at its entry gets back its cotangent
    with the alive row zeroed, whatever the cotangent of the live lanes; a
    cotangent on the dead lanes alone adds exactly 0 to `d_tab`. The scan
    leaves launches with no live lane."""
    meta, cfg, outer, tables, pix, sb, _, residual = _scan(name, spp)
    res_f, res_i, res_k = residual
    alive = _alive(residual)
    assert not alive[-1].any() and alive[0].all()
    rs = np.random.default_rng(spp)
    dead_seen = 0
    for t in range(outer):
        dead = ~alive[t]
        cot = torch.as_tensor(rs.normal(size=(tad.NF, W * W)).astype(np.float32))
        args = (meta, cfg, tables, t, res_f[t], res_i[t], res_k[t], pix, sb)
        d_f, _ = tad.ad_step_bwd_plain(*args, cot)
        want = cot.clone()
        want[tad.A_ALIVE] = 0.0
        assert torch.equal(d_f[:, dead], want[:, dead]), t
        d_dead, tab_dead = tad.ad_step_bwd_plain(*args, cot * dead)
        assert torch.equal(tab_dead, torch.zeros_like(tab_dead)), t
        assert torch.equal(d_dead[:, dead], want[:, dead]), t
        dead_seen += int(dead.sum())
    assert dead_seen > 0


@pytest.mark.parametrize("spp", [4, 8])
@pytest.mark.parametrize("name", SCENES)
def test_residual_alive_rows_never_rise(name, spp):
    """(ii) Alive is monotone over the scan: a lane's alive row never goes
    from 0 to 1 from one launch's entry to the next, nor to the last
    state."""
    *_, last, residual = _scan(name, spp)
    alive = _alive(residual)
    after = torch.cat([alive[1:], (last[0][tad.A_ALIVE] > 0)[None]])
    assert not (after & ~alive).any()
    assert alive[0].all() and not after[-1].any()


@pytest.mark.parametrize("spp", [4, 8])
@pytest.mark.parametrize("name", SCENES)
def test_alive_cotangent_stays_zero_over_the_backward(name, spp):
    """(iii) The SSE loss's cotangent of the scan's last state has a zero
    alive row, and every launch of the plain backward, carried from it,
    hands on a zero alive row."""
    meta, cfg, outer, tables, pix, sb, last, residual = _scan(name, spp)
    res_f, res_i, res_k = residual
    f = last[0].clone().requires_grad_(True)
    nv = f[tad.A_NV][:, None]
    err = torch.where(nv > 0, f[tad.A_SUM:tad.A_SUM + 3].T / nv.clamp_min(1) - 0.25, 0.0)
    (cot,) = torch.autograd.grad((err * err).sum(), [f])
    assert torch.equal(cot[tad.A_ALIVE], torch.zeros(W * W))
    assert float(cot[tad.A_SUM:tad.A_SUM + 3].abs().max()) > 0
    for t in reversed(range(outer)):
        cot, _ = tad.ad_step_bwd_plain(meta, cfg, tables, t, res_f[t], res_i[t], res_k[t], pix,
                                       sb, cot)
        assert torch.equal(cot[tad.A_ALIVE], torch.zeros(W * W)), t


@pytest.fixture(scope="module")
def host_bounce_ad(tmp_path_factory):
    """csrc/bounce_ad.cu built for the host (blocks of one thread)."""
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


@contextlib.contextmanager
def _emulated(lib):
    """The wrappers' CUDA branch on CPU tensors, into the host library."""
    class Stream:
        cuda_stream = 0

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kernels, "load", lambda _name: lib)
        mp.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
        mp.setattr(torch.cuda, "current_stream", lambda dev=None: Stream())
        mp.setattr(device, "kind", lambda t, what: "cuda")
        yield


def _walk_in_place(meta, cfg, outer, tables, pix, sb, residual, cot0, ext_rows=None,
                   images=None):
    """The scan's backward as `scan_backward` carries it on the card, one
    launch at a time: the cotangent in one buffer, `d_ext` zeroed once.
    Checks after each launch that the rows of lanes dead at its entry are
    untouched and that the alive row of the walked lanes is zero; returns the
    carried cotangent after each launch, the last `d_tab` and the `d_ext` of
    each launch."""
    res_f, res_i, res_k = residual[:3]
    n = cot0.shape[1]
    cot = cot0.clone()
    d_tab = torch.zeros((tad.n_diff(meta),))
    d_ext = None if ext_rows is None else torch.zeros((ext_rows, n))
    alive = _alive(residual)
    outs, exts = {}, {}
    for t in reversed(range(outer)):
        ext = None if ext_rows is None else residual[3][t]
        before = cot.clone()
        tad._launch_bwd(meta, cfg, tables, t, res_f[t], res_i[t], res_k[t], pix, sb, cot, cot,
                        d_tab, ext, d_ext, images)
        dead = ~alive[t]
        assert torch.equal(cot[:, dead], before[:, dead]), t
        assert torch.equal(cot[tad.A_ALIVE, ~dead], torch.zeros(int((~dead).sum()))), t
        if d_ext is not None:
            assert torch.equal(d_ext[:, dead], torch.zeros_like(d_ext[:, dead])), t
            exts[t] = d_ext.clone()
        outs[t] = cot.clone()
    return outs, d_tab, exts


@pytest.mark.parametrize("name", SCENES)
def test_emulated_in_place_walk_equals_per_call_b3(host_bounce_ad, name):
    """The kernel compiled for the host over a whole 8x8, 8-spp scan: carried
    in place, each launch leaves the rows of lanes dead at its entry as they
    were and equals the per-call `ad_step_bwd` (d_f a fresh copy) bit for
    bit; `bwd_lanes_walked` grows by the live entries of the residual's
    alive rows and `bwd_lanes_offered` by N a launch."""
    meta, cfg, outer, tables, pix, sb, _, residual = _scan(name, 8)
    res_f, res_i, res_k = residual
    rs = np.random.default_rng(3)
    cot0 = torch.as_tensor(rs.normal(size=(tad.NF, W * W)).astype(np.float32))
    cot0[tad.A_ALIVE] = 0.0
    with _emulated(host_bounce_ad):
        walked0, offered0 = tad.bwd_lanes_walked(), tad.bwd_lanes_offered
        outs, tab, _ = _walk_in_place(meta, cfg, outer, tables, pix, sb, residual, cot0)
        assert tad.bwd_lanes_walked() - walked0 == int(_alive(residual).sum())
        assert tad.bwd_lanes_offered - offered0 == outer * W * W
        cot, tab_ref = cot0, torch.zeros_like(tab)
        for t in reversed(range(outer)):
            cot, _ = tad.ad_step_bwd(meta, cfg, tables, t, res_f[t], res_i[t], res_k[t], pix,
                                     sb, cot, tab_ref)
            assert torch.equal(outs[t], cot), t
    torch.testing.assert_close(tab, tab_ref, rtol=0, atol=1e-6 * float(tab_ref.abs().max()))
    assert float(tab_ref.abs().max()) > 0


@pytest.mark.parametrize("name", SCENES)
def test_emulated_b3_writes_only_the_rows_of_live_lanes(host_bounce_ad, name):
    """One launch of the kernel compiled for the host into a `d_f` that holds
    a marker instead of the cotangent, at every launch of an 8x8, 4-spp scan:
    the lanes dead at entry keep the marker in every row, the live lanes in
    their pass-through rows (sum, nvalid, rays), and the live lanes' other
    rows are written (their alive row to zero)."""
    meta, cfg, outer, tables, pix, sb, _, residual = _scan(name, 4)
    res_f, res_i, res_k = residual
    alive = _alive(residual)
    rs = np.random.default_rng(11)
    through = [tad.A_SUM, tad.A_SUM + 1, tad.A_SUM + 2, tad.A_NV, tad.A_RAYS]
    with _emulated(host_bounce_ad):
        for t in range(outer):
            cot = torch.as_tensor(rs.normal(size=(tad.NF, W * W)).astype(np.float32))
            d_f = torch.full_like(cot, 7.0)
            tad._launch_bwd(meta, cfg, tables, t, res_f[t], res_i[t], res_k[t], pix, sb, cot,
                            d_f, torch.zeros((tad.n_diff(meta),)), None, None, None)
            live = alive[t]
            assert (d_f[:, ~live] == 7.0).all(), t
            assert (d_f[through][:, live] == 7.0).all(), t
            assert (d_f[tad.A_ALIVE, live] == 0.0).all(), t
            if live.any():
                assert (d_f[tad.A_RO:tad.A_ALIVE][:, live] != 7.0).all(), t


@pytest.mark.parametrize("name", ["random_spheres", "hybrid_probe"])
def test_emulated_ext_walk_leaves_dead_lanes_d_ext_zero(host_bounce_ad, name):
    """An ext scan (ext-material mode on random_spheres, ext mode on the
    probe) at 8x8, 2 samples, 6 bounces, one sub-step a launch, walked in
    place by the kernel compiled for the host: dead lanes' rows untouched and
    their `d_ext` zero at every launch, and each launch's `d_f` and `d_ext`
    equal to the per-call B3's bit for bit."""
    scene = (tscenes.hybrid_probe(1.0, 80, 200) if name == "hybrid_probe"
             else tscenes.random_spheres(1.0))
    spp = 2
    plan = thybrid.smem_plan(scene) if thybrid.ext_mat_mode(scene) else None
    meta, tables = thybrid.pack_scene_hybrid(scene, plan)
    _, claim, k_sub, outer = tad.scan_plan(spp, BOUNCES, 0, 1)
    cfg = tad.StepConfig(W, W, 8, BOUNCES, spp, claim, k_sub)
    pix = torch.arange(W * W, dtype=torch.int32)
    sb = torch.zeros_like(pix)
    state = tad.initial_state(scene, pix, sb, spp, width=W, height=W, sq_off=8)
    cand = tad.ExtCandidate(scene)
    _, residual = tad.scan_forward(meta, cfg, outer, tables, *state, pix, sb, candidate=cand)
    res_f, res_i, res_k, res_e = residual
    assert not _alive(residual)[-1].any()
    rs = np.random.default_rng(5)
    cot0 = torch.as_tensor(rs.normal(size=(tad.NF, W * W)).astype(np.float32))
    cot0[tad.A_ALIVE] = 0.0
    with _emulated(host_bounce_ad):
        outs, _, exts = _walk_in_place(meta, cfg, outer, tables, pix, sb, residual, cot0,
                                       res_e.shape[1])
        cot, d_tab = cot0, torch.zeros((tad.n_diff(meta),))
        for t in reversed(range(outer)):
            cot, _, d_ext = tad.ad_step_bwd(meta, cfg, tables, t, res_f[t], res_i[t], res_k[t],
                                            pix, sb, cot, d_tab, res_e[t])
            assert torch.equal(outs[t], cot) and torch.equal(exts[t], d_ext), t
    assert any(float(e.abs().max()) > 0 for e in exts.values())
