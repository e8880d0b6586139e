"""The port's forward slice end to end: public entry points, routing,
kernel build and launch plumbing. Tests marked `cuda` need an NVIDIA GPU
and skip elsewhere."""

import re

import numpy as np
import pytest
import torch

import miniraytracer_tpu_torch as mrt
from miniraytracer_tpu_torch.ops import bounce, flash, hybrid
from miniraytracer_tpu_torch.utils import kernels

torch.set_num_threads(1)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m cuda)")


def test_render_cornell_on_cpu():
    launches = bounce.launches
    frame, stats = mrt.render(mrt.scenes.cornell_box(1.0), 16, 16, 4,
                              max_bounces=8, device="cpu")
    assert stats["renderer"] == "fused"
    assert frame.shape == (16, 16, 3) and frame.dtype == torch.float32
    assert torch.isfinite(frame).all()
    assert isinstance(stats["rays"], int) and stats["rays"] > 16 * 16 * 4
    assert stats["spp"] == 4
    assert bounce.launches == launches  # a CPU scene never launches the kernel


def test_pick_renderer_raises_outside_fused_class():
    b = mrt.SceneBuilder()
    b.set_camera([0, 0, 5], [0, 0, 0], [0, 1, 0], 40.0, 1.0, 0.0, 5.0, 0.0, 1.0)
    m = b.lambertian(b.tex_const([0.5, 0.5, 0.5]))
    for i in range(65):
        b.sphere([i * 0.1, 0, 0], 0.05, m)
    # a sphere light among more than 64 spheres: outside the hybrid class too
    # (its light pdf reads the in-table sphere set)
    b.add_light(b.sphere([0, 3, 0], 0.5, b.diffuse_light(b.tex_const([4, 4, 4]))))
    scene = b.build()
    assert not bounce.can_fuse(scene) and not hybrid.can_hybrid(scene)
    # the rule's answer is the work queue, with its shading in tensor
    # operations (the sphere light's pdf reads the full sphere table)
    assert mrt.pick_renderer(scene) == "workqueue"
    frame, stats = mrt.render(scene, 8, 8, 1, max_bounces=3, device="cpu")
    assert stats["renderer"] == "workqueue" and torch.isfinite(frame).all()
    with pytest.raises(ValueError, match="hybrid class"):
        mrt.render_workqueue(scene, 8, 8, 1, fused_shade=True, device="cpu")
    pix = torch.arange(64, dtype=torch.int32)
    with pytest.raises(ValueError, match="fused class"):
        bounce.render_wavefront_fused_pixels(
            scene, pix, 0, 1, 1000.0, width=8, height=8, max_bounces=4,
            spp_sq=1)
    with pytest.raises(ValueError, match="hybrid class"):
        hybrid.render_wavefront_hybrid_pixels(
            scene, pix, 0, 1, 1000.0, width=8, height=8, max_bounces=4,
            spp_sq=1)


def test_pick_renderer_routes_the_fused_scenes():
    for name in ("cornell_box", "cornell_smoke", "two_spheres", "perlin_spheres"):
        assert mrt.pick_renderer(getattr(mrt.scenes, name)(1.0)) == "fused"


def test_render_subset_of_pixels_equals_full_frame():
    scene = mrt.scenes.cornell_smoke(1.0)
    kw = dict(width=8, height=8, max_bounces=6, spp_sq=2)
    full = bounce.render_wavefront_fused_pixels(
        scene, torch.arange(64, dtype=torch.int32), 0, 4, 1000.0, **kw)
    pick = torch.tensor([3, 17, 40, 63], dtype=torch.int32)
    part = bounce.render_wavefront_fused_pixels(scene, pick, 0, 4, 1000.0, **kw)
    for a, b in zip(part, full):
        np.testing.assert_array_equal(a.numpy(), b[pick.long()].numpy())


def test_kernel_params_match_the_cuda_source():
    src = (kernels.CSRC / "physics.cuh").read_text()
    n = int(re.search(r"static_assert\(P_COUNT == (\d+)", src).group(1))
    assert n == bounce._N_IPARAMS
    # the hybrid step appends its switches and the atlas's shape
    extra = re.search(r"enum HybridParamIdx \{ H_EXT_MAT = P_COUNT,([^}]*)H_COUNT \}",
                      (kernels.CSRC / "hybrid.cu").read_text()).group(1)
    assert hybrid._N_IPARAMS == n + 1 + extra.count(",")
    meta, _ = bounce.pack_scene(mrt.scenes.cornell_box(1.0))
    ip = bounce.kernel_params(meta, 250000, 0, 64, width=500, height=500,
                              max_bounces=32, spp_sq=8)
    assert len(ip) == n
    assert ip[:7] == [250000, 500, 500, 8, 32, 0, 64]
    assert ip[14] == 1 and ip[15] == 1 and ip[19] == 2  # one rect light, #2


def test_failed_build_raises(tmp_path, monkeypatch):
    (tmp_path / "broken.cu").write_text("this is not CUDA\n")
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.build("broken")


@pytest.mark.cuda
def test_render_on_cuda_launches_kernel_and_matches_plain():
    _need_cuda()
    scene = mrt.scenes.cornell_box(1.0).to("cuda")
    before = bounce.launches
    frame, stats = mrt.render(scene, 32, 32, 4, max_bounces=8)
    assert bounce.launches == before + 1
    assert frame.is_cuda and torch.isfinite(frame).all()
    pix = torch.arange(32 * 32, dtype=torch.int32, device="cuda")
    a, c, r = bounce.render_wavefront_fused_pixels_plain(
        scene, pix, 0, 4, 1000.0, width=32, height=32, max_bounces=8,
        spp_sq=2)
    plain = (a / c.clamp_min(1)[:, None].float()).reshape(32, 32, 3)
    assert abs(int(r.sum()) - stats["rays"]) <= 1e-3 * stats["rays"]
    assert ((frame - plain).abs().amax(-1) < 1e-4).float().mean() >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["random_spheres", "earth", "hybrid_probe"])
def test_hybrid_render_on_cuda_launches_kernels_and_matches_plain(name):
    """The hybrid renderer on the card: the sweeps and the step launch their
    kernels, and the frame agrees with the plain versions' at
    `chip_smoke.compare`'s tolerances."""
    _need_cuda()
    import chip_smoke

    scene = (mrt.scenes.hybrid_probe(1.0, 80, 200) if name == "hybrid_probe"
             else getattr(mrt.scenes, name)(1.0)).to("cuda")
    pix = torch.arange(32 * 32, dtype=torch.int32, device="cuda")
    kw = dict(width=32, height=32, max_bounces=8, spp_sq=2)
    before = hybrid.step_launches, flash.sphere_launches, flash.tri_launches
    stats = {}
    k = hybrid.render_wavefront_hybrid_pixels(scene, pix, 0, 4, 1000.0, stats=stats, **kw)
    steps = stats["steps"]
    assert hybrid.step_launches == before[0] + steps
    assert flash.sphere_launches == before[1] + (0 if name == "earth" else steps)
    assert flash.tri_launches == before[2] + (steps if name == "hybrid_probe" else 0)
    p = hybrid.render_wavefront_hybrid_pixels(scene, pix, 0, 4, 1000.0, plain=True, **kw)
    assert hybrid.step_launches == before[0] + steps  # the plain run launched nothing
    chip_smoke.compare(name, k, p)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["earth", "book2_final", "hybrid_probe", "random_spheres",
                                  "probe_4200"])
def test_workqueue_render_on_cuda_launches_kernels_and_matches_plain(name):
    """The work queue on the card: the shade step launches once a queue step,
    book2_final's sphere set goes through the gated clustered sweep and a
    probe's 4200 spheres through the streamed one, and the frame agrees with the plain versions' at `chip_smoke.compare_queue`'s
    tolerances (equal claims, steps and ray counts)."""
    _need_cuda()
    import chip_smoke
    from miniraytracer_tpu_torch.models import integrator

    scene = (mrt.scenes.hybrid_probe(1.0, 80, 200) if name == "hybrid_probe"
             else mrt.scenes.hybrid_probe(1.0, 4200, 0) if name == "probe_4200"
             else getattr(mrt.scenes, name)(1.0)).to("cuda")
    before = hybrid.shade_launches, flash.gated_launches, flash.streamed_launches
    steps = chip_smoke.compare_queue(name, integrator, scene, 32, 32, 2, 8, 300)
    assert hybrid.shade_launches == before[0] + steps
    assert flash.gated_launches == before[1] + (steps if name == "book2_final" else 0)
    assert flash.streamed_launches == before[2] + (steps if name == "probe_4200" else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["random_spheres_2", "book2_final"])
def test_eager_queue_on_cuda_launches_kernels_and_matches_plain(name):
    """The work queue with its shading in tensor operations on the card: the
    sphere sweep and the turbulence kernel B6 launch once a queue step, and
    steps, claims, rays and frame equal the plain run's
    (`chip_smoke.compare_eager_queue`)."""
    _need_cuda()
    import chip_smoke
    from miniraytracer_tpu_torch.models import integrator
    from miniraytracer_tpu_torch.ops import noise

    scene = getattr(mrt.scenes, name)(1.0).to("cuda")
    chip_smoke.compare_eager_queue(name, integrator, scene, 32, 2, 8, 300,
                                   chip_smoke.sphere_counters(flash, noise))


@pytest.mark.cuda
def test_external_candidate_on_cuda_samples_perlin_through_b6():
    """`hybrid._external_candidate` on random_spheres_2 on the card (ext-
    material mode: the outside winner's material is evaluated there) sends
    its Perlin albedo to kernel B6, one launch a call, and its rows equal
    the plain candidate's bit for bit (B6 equals its plain version)."""
    _need_cuda()
    from miniraytracer_tpu_torch.ops import noise

    scene = mrt.scenes.random_spheres_2(1.0).to("cuda")
    w = h = 32
    pix = torch.arange(w * h, dtype=torch.int32, device="cuda")
    f, i, _, _ = hybrid.initial_state(scene, pix, 0, 1, width=w, height=h, spp_sq=1)
    rays, alive = hybrid.state_rays(f, i), f[hybrid.R_ALIVE] > 0
    accel = hybrid.hybrid_accel(scene)
    ptab = noise.noise_tables(scene)
    launches = noise.launches
    rows = hybrid._external_candidate(scene, accel, rays, alive, bounce.TMIN, ptab)
    assert noise.launches == launches + 1
    ref = hybrid._external_candidate(scene, accel, rays, alive, bounce.TMIN, ptab, plain=True)
    assert noise.launches == launches + 1
    assert all(torch.equal(a, b) for a, b in zip(rows, ref))


def _cuda_triangles(tmp_path, monkeypatch, **mesh):
    monkeypatch.setenv("MRT_ASSETS", mrt.scenes.write_stand_in_meshes(str(tmp_path), **mesh))
    return mrt.scenes.triangles(1.0).to("cuda")


@pytest.mark.cuda
def test_clustered_tri_kernels_on_cuda_match_plain(tmp_path, monkeypatch):
    """B10, B11 and B9 on the card against their plain versions on rays of
    real queue steps of the triangles scene (stand-in meshes, 2,816
    triangles): equal t and index on every ray, seeded and not, and against
    the dense kernel B7 (`chip_smoke.compare_tri_clustered`)."""
    _need_cuda()
    import chip_smoke
    from miniraytracer_tpu_torch.models import integrator

    scene = _cuda_triangles(tmp_path, monkeypatch, bunny_subdiv=3, torus_segments=(32, 24))
    cull, coeffs = flash.scene_tri_cull(scene), flash.scene_tri_coefficients(scene)
    calls = chip_smoke.queue_snapshots(integrator, hybrid, scene, 48, 48, 2, 8, 1000)
    for t in (2, len(calls) - 3):
        _, fstate, inside, _, _ = calls[t]
        ro, rd, _, inside, alive = chip_smoke.snapshot_rays(hybrid, fstate, inside)
        seed = torch.where(alive & (torch.arange(alive.numel(), device="cuda") % 2 == 0),
                           torch.full_like(fstate[0], 400.0), 3.0e38)
        launches = (flash.resident_launches, flash.tri_streamed_launches, flash.culled_launches)
        assert chip_smoke.compare_tri_clustered(f"step {t}", flash, cull, coeffs, ro, rd, inside,
                                                alive, seed, bounce.TMIN) == 0.0
        assert (flash.resident_launches, flash.tri_streamed_launches,
                flash.culled_launches) == tuple(n + k for n, k in zip(launches, (2, 2, 3)))


@pytest.mark.cuda
@pytest.mark.parametrize("fused_shade", [True, False])
def test_triangles_queue_on_cuda_launches_b10_and_matches_plain(tmp_path, monkeypatch,
                                                                 fused_shade):
    """The triangles scene (stand-in meshes) through the work queue on the
    card, with its shade step and with its shading in tensor operations: B10
    launches once a queue step and the frame agrees with the plain run
    (`chip_smoke.compare_queue`, `compare_eager_queue`)."""
    _need_cuda()
    import chip_smoke
    from miniraytracer_tpu_torch.models import integrator

    scene = _cuda_triangles(tmp_path, monkeypatch, bunny_subdiv=3, torus_segments=(16, 12))
    before = flash.resident_launches
    if fused_shade:
        steps = chip_smoke.compare_queue("triangles", integrator, scene, 32, 32, 2, 8, 300)
        assert flash.resident_launches == before + steps
    else:
        chip_smoke.compare_eager_queue("triangles", integrator, scene, 32, 2, 8, 300,
                                       {"B10": lambda: flash.resident_launches})


# ---------------------------------------------------------------------------
# The train-step slice: entry points, device default, kernels on the card
# ---------------------------------------------------------------------------


def test_entry_points_default_to_the_gpu_and_raise_without_one():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    scene = mrt.scenes.cornell_box(1.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mrt.render(scene, 8, 8, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mrt.make_train_step(width=8, height=8, max_bounces=4)


def test_wavefront_and_workqueue_default_to_the_gpu():
    """`render_wavefront` and `render_workqueue` once ran quietly on the CPU
    for a CPU scene (every scene generator builds one): they run on the GPU
    unless asked for the CPU, like `render`."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    scene = mrt.scenes.two_spheres(1.0)
    for render in (mrt.render_wavefront, mrt.render_workqueue):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            render(scene, 8, 8, 1, max_bounces=2)
        frame, stats = render(scene, 8, 8, 1, max_bounces=2, device="cpu")
        assert frame.shape == (8, 8, 3) and frame.device.type == "cpu"
        assert torch.isfinite(frame).all() and stats["rays"] >= 64


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cornell_box", "cornell_smoke",
                                  "perlin_spheres", "ad_probe"])
def test_ad_step_kernels_match_plain_on_cuda(name):
    """Both AD kernels against their plain versions, launch by launch over a
    whole scan from the plain scan's states, at the per-lane tolerances of
    `chip_smoke.compare_launch`."""
    _need_cuda()
    import chip_smoke
    from miniraytracer_tpu_torch.ops import bounce_ad

    scene = getattr(mrt.scenes, name)(1.0).to("cuda")
    meta, cfg, outer, tables, pix, sb, _, (res_f, res_i, res_k) = chip_smoke.launch_states(
        mrt, bounce, bounce_ad, scene, 32, 32, 2, 6, True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    fwd0, bwd0 = bounce_ad.fwd_launches, bounce_ad.bwd_launches
    for t in range(outer):
        chip_smoke.compare_launch(bounce_ad, (meta, cfg, tables, t),
                                  (res_f[t], res_i[t], res_k[t], pix, sb), gen,
                                  f"{name} launch {t}")
    assert bounce_ad.fwd_launches == fwd0 + outer
    assert bounce_ad.bwd_launches == bwd0 + outer


@pytest.mark.cuda
def test_train_step_on_cuda_goes_through_the_kernels():
    _need_cuda()
    import chip_smoke
    from miniraytracer_tpu_torch.ops import bounce_ad

    scene = mrt.scenes.cornell_box(1.0)
    w = h = 24
    step = mrt.make_train_step(width=w, height=h, max_bounces=6, spp_step=2)
    target = torch.full((w * h, 3), 0.25)
    fwd0, bwd0 = bounce_ad.fwd_launches, bounce_ad.bwd_launches
    plan0 = bounce_ad.fwd_plan_launches
    params, loss, grads = step(mrt.extract_params(scene), scene, target, 0, 0.01)
    outer = bounce_ad.scan_plan(2, 6)[3]
    assert bounce_ad.fwd_launches == fwd0 + outer
    assert bounce_ad.fwd_plan_launches == plan0 + outer  # every B2 launch through the plan
    assert bounce_ad.bwd_launches == bwd0 + outer
    assert loss.is_cuda and torch.isfinite(loss)
    assert all(g.is_cuda and torch.isfinite(g).all() for g in grads)
    assert float(grads.tex_c0.abs().max()) > 0
    # the same scan through the plain versions (the same grey target)
    chip_smoke.compare_scans(mrt, bounce, bounce_ad, scene.to("cuda"), w, h, 2, 6,
                             "cornell_box 24x24")


@pytest.mark.cuda
def test_planned_scan_forward_equals_per_call_on_cuda(monkeypatch):
    """The forward scan through its launch plan (`bounce_ad.FwdPlan`) against
    a call of `ad_step_fwd` a launch after the copies of its entry state
    (`chip_smoke.per_call_scan_forward`), on the Cornell box at 64x64, 16
    spp, 8 bounces: the last state and every launch's residual equal bit for
    bit. Then the SSE loss's gradient for every TrainParams leaf through
    `FusedADScan` (planned) and through the same scan with the per-call
    forward: B3's inputs are the same, so the two differ only by `d_tab`'s
    float atomics, within 2e-4 of the leaf's largest entry (chip_smoke's
    bound for B3's `d_tab` against another build)."""
    _need_cuda()
    import chip_smoke
    from miniraytracer_tpu_torch.ops import bounce_ad

    scene = mrt.scenes.cornell_box(1.0).to("cuda")
    w = h = 64
    spp, bounces = 16, 8
    meta, tables = bounce.pack_scene(scene)
    _, claim, k_sub, outer = bounce_ad.scan_plan(spp, bounces)
    cfg = bounce_ad.StepConfig(w, h, 8, bounces, spp, claim, k_sub)
    pix = torch.arange(w * h, dtype=torch.int32, device="cuda")
    sb = torch.zeros_like(pix)
    state = bounce_ad.initial_state(scene, pix, sb, spp, width=w, height=h, sq_off=8)
    plan0 = bounce_ad.fwd_plan_launches
    planned = bounce_ad.scan_forward(meta, cfg, outer, tables, *state, pix, sb)
    assert bounce_ad.fwd_plan_launches == plan0 + outer
    per_call = chip_smoke.per_call_scan_forward(bounce_ad, meta, cfg, outer, tables, *state,
                                                pix, sb)
    assert chip_smoke.equal_outputs(planned, per_call)

    def grads():
        leaves = mrt.TrainParams(*(p.detach().clone().requires_grad_(True)
                                   for p in mrt.extract_params(scene)))
        s, nv, _ = bounce_ad.sample_pixel_sums_fused(
            mrt.apply_params(scene, leaves), pix, 0, spp, width=w, height=h,
            max_bounces=bounces)
        err = torch.where(nv[:, None] > 0, s / nv.clamp_min(1)[:, None] - 0.25, 0.0)
        return torch.autograd.grad((err * err).sum(), list(leaves), allow_unused=True)

    with_plan = grads()
    monkeypatch.setattr(
        bounce_ad, "scan_forward",
        lambda meta, cfg, outer_steps, tables, f0, i0, k0, pix, sb, *, plain=False, keep=True,
        candidate=None, images=None: chip_smoke.per_call_scan_forward(
            bounce_ad, meta, cfg, outer_steps, tables, f0, i0, k0, pix, sb, keep, candidate,
            images))
    plan0 = bounce_ad.fwd_plan_launches
    one_call_a_launch = grads()
    assert bounce_ad.fwd_plan_launches == plan0
    seen = 0
    for leaf, a, b in zip(mrt.TrainParams._fields, with_plan, one_call_a_launch):
        assert (a is None) == (b is None), leaf
        if b is not None and float(b.abs().max()) > 0:
            torch.testing.assert_close(a, b, rtol=0, atol=2e-4 * float(b.abs().max()), msg=leaf)
            seen += 1
    assert seen >= 2


def _walk_b3_in_place(bounce_ad, meta, cfg, outer, tables, pix, sb, residual, ext_rows=None):
    """B3 over a whole scan on the card, launch by launch as `scan_backward`
    carries it (the cotangent in one buffer; `d_ext` zeroed once, with
    `ext_rows`), from a seeded cotangent with a zero alive row. At each
    launch: a launch into a `d_f` that holds a marker leaves the marker on
    every row of the lanes dead at entry; the in-place launch leaves their
    rows as they were and equals the per-call `ad_step_bwd` bit for bit
    (`d_ext` too, zero on dead lanes). Returns the live entries of the
    residual's alive rows and the B3 launches made a scan launch (three)."""
    import chip_smoke

    res_f, res_i, res_k = residual[:3]
    n = res_f.shape[2]
    alive = res_f[:, bounce_ad.A_ALIVE - bounce_ad.RES_LO] > 0
    assert alive[0].all() and not alive[-1].any()
    gen = torch.Generator(device="cuda").manual_seed(0)
    cot = torch.randn((bounce_ad.NF, n), device="cuda", generator=gen)
    cot[bounce_ad.A_ALIVE] = 0.0
    d_tab = torch.zeros((bounce_ad.n_diff(meta),), device="cuda")
    d_ext = None if ext_rows is None else torch.zeros((ext_rows, n), device="cuda")
    for t in reversed(range(outer)):
        args = (meta, cfg, tables, t, res_f[t], res_i[t], res_k[t], pix, sb)
        ext = None if ext_rows is None else residual[3][t]
        ref = bounce_ad.ad_step_bwd(*args, cot, None, ext)
        dead = ~alive[t]
        marked = torch.full_like(cot, 7.0)
        bounce_ad._launch_bwd(*args, cot, marked, torch.zeros_like(d_tab), ext,
                              None if ext is None else torch.zeros_like(ext), None)
        assert bool((marked[:, dead] == 7.0).all()), t
        before = cot.clone()
        bounce_ad._launch_bwd(*args, cot, cot, d_tab, ext, d_ext, None)
        assert torch.equal(cot[:, dead], before[:, dead]), t
        assert chip_smoke.equal_outputs(cot, ref[0]), t
        if ext is not None:
            assert not bool(d_ext[:, dead].any()), t
            assert chip_smoke.equal_outputs(d_ext, ref[2]), t
    return int(alive.sum()), 3


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cornell_box", "cornell_smoke"])
def test_b3_walks_only_live_lanes_on_cuda(name):
    """B3 walks only the lanes alive at its launch's entry, on a 64x64 scan
    at 4 spp and 8 bounces whose last launches hold no live lane: the loss
    and gradients through `FusedADScan` (the cotangent carried in place)
    equal `plain=True`'s at `chip_smoke.compare_scans`' tolerances;
    `_walk_b3_in_place` holds each launch's rows; `bwd_lanes_walked` grows by
    the live entries of the residual's alive rows at each launch made."""
    _need_cuda()
    import chip_smoke
    from miniraytracer_tpu_torch.ops import bounce_ad

    scene = getattr(mrt.scenes, name)(1.0).to("cuda")
    w, spp, bounces = 64, 4, 8
    chip_smoke.compare_scans(mrt, bounce, bounce_ad, scene, w, w, spp, bounces, name)
    meta, cfg, outer, tables, pix, sb, _, residual = chip_smoke.launch_states(
        mrt, bounce, bounce_ad, scene, w, w, spp, bounces, False)
    walked0, offered0 = bounce_ad.bwd_lanes_walked(), bounce_ad.bwd_lanes_offered
    live, launches = _walk_b3_in_place(bounce_ad, meta, cfg, outer, tables, pix, sb, residual)
    assert bounce_ad.bwd_lanes_walked() - walked0 == launches * live
    assert bounce_ad.bwd_lanes_offered - offered0 == launches * outer * w * w
    assert live < outer * w * w


@pytest.mark.cuda
def test_b3_ext_walk_leaves_dead_lanes_d_ext_zero_on_cuda():
    """The hybrid-ext scan of random_spheres (ext-material mode, one sub-step
    a launch) at 64x64, 2 spp, 8 bounces: walked in place by
    `_walk_b3_in_place`, `d_ext` reads zero on the lanes dead at each
    launch's entry and equals the per-call B3's."""
    _need_cuda()
    from miniraytracer_tpu_torch.ops import bounce_ad

    scene = mrt.scenes.random_spheres(1.0).to("cuda")
    w, spp, bounces = 64, 2, 8
    plan = hybrid.smem_plan(scene) if hybrid.ext_mat_mode(scene) else None
    meta, tables = hybrid.pack_scene_hybrid(scene, plan)
    tables = [t.detach() for t in tables]
    _, claim, k_sub, outer = bounce_ad.scan_plan(spp, bounces, 0, 1)
    cfg = bounce_ad.StepConfig(w, w, 8, bounces, spp, claim, k_sub)
    pix = torch.arange(w * w, dtype=torch.int32, device="cuda")
    sb = torch.zeros_like(pix)
    state = bounce_ad.initial_state(scene, pix, sb, spp, width=w, height=w, sq_off=8)
    cand = bounce_ad.ExtCandidate(scene)
    _, residual = bounce_ad.scan_forward(meta, cfg, outer, tables, *state, pix, sb,
                                         candidate=cand)
    _walk_b3_in_place(bounce_ad, meta, cfg, outer, tables, pix, sb, residual,
                      residual[3].shape[1])


@pytest.mark.cuda
@pytest.mark.parametrize("w", [24, 64])
@pytest.mark.parametrize("name", ["random_spheres", "triangles", "earth", "book2_final"])
def test_ext_train_step_on_cuda_goes_through_the_kernels(tmp_path, monkeypatch, name, w):
    """The hybrid-ext train step on the card: B2/B3 in the scene's ext mode
    launch once a scan step each way, the gradients are finite, and the
    whole scan equals its plain version in loss and gradients
    (`chip_smoke.compare_scans(use_ext=True)`), at 24x24 and at chip_smoke's
    phase-29 size, 64x64, 2 spp x 8 bounces."""
    _need_cuda()
    import chip_smoke
    from miniraytracer_tpu_torch.ops import bounce_ad

    if name == "triangles":
        monkeypatch.setenv("MRT_ASSETS", mrt.scenes.write_stand_in_meshes(
            str(tmp_path), bunny_subdiv=3, torus_segments=(16, 12)))
    scene = getattr(mrt.scenes, name)(1.0)
    bounces = 8
    step = mrt.make_train_step(width=w, height=w, max_bounces=bounces, spp_step=2,
                               fused_ad="ext", scene=scene)
    fwd0, bwd0 = bounce_ad.fwd_launches, bounce_ad.bwd_launches
    _, loss, grads = step(mrt.extract_params(scene), scene, torch.full((w * w, 3), 0.25), 0,
                          0.0)
    outer = bounce_ad.scan_plan(2, bounces, 0, 1)[3]
    assert bounce_ad.fwd_launches == fwd0 + outer
    assert bounce_ad.bwd_launches == bwd0 + outer
    assert loss.is_cuda and torch.isfinite(loss)
    assert all(g.is_cuda and torch.isfinite(g).all() for g in grads)
    chip_smoke.compare_scans(mrt, bounce, bounce_ad, scene.to("cuda"), w, w, 2, bounces, name,
                             use_ext=True)


# ---------------------------------------------------------------------------
# The scans (fused_ad=False) and the progressive renderer on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("pack,spp_step", [(1, 1), (8, 2)])
def test_scan_train_step_on_cuda_goes_through_the_sweeps(pack, spp_step):
    """`make_train_step(fused_ad=False)` on the card: the dense sphere sweep
    B8 launches once a scan step and once more in that step's recompute,
    the gradients are finite, and the loss and every gradient equal those
    of the same scan through the plain sweeps (`chip_smoke.scan_loss_grads`,
    phase 31's tolerances)."""
    _need_cuda()
    import chip_smoke
    from miniraytracer_tpu_torch.parallel import train

    scene = mrt.scenes.random_spheres_2(1.0)
    w, bounces = 16, 4
    step = mrt.make_train_step(width=w, height=w, max_bounces=bounces, fused_ad=False,
                               pack=pack, spp_step=spp_step)
    n0 = flash.sphere_launches
    _, loss, grads = step(mrt.extract_params(scene), scene, torch.full((w * w, 3), 0.25), 0,
                          0.0)
    steps = bounces + 1 if pack == 1 else pack * 6 + bounces + 1
    assert flash.sphere_launches == n0 + 2 * steps
    assert loss.is_cuda and torch.isfinite(loss)
    assert all(g.is_cuda and torch.isfinite(g).all() for g in grads)
    sc = scene.to("cuda")
    lk, gk, _ = chip_smoke.scan_loss_grads(mrt, train, sc, w, bounces, pack, spp_step, False)
    lp, gp, _ = chip_smoke.scan_loss_grads(mrt, train, sc, w, bounces, pack, spp_step, True)
    assert abs(float(lk) - float(lp)) <= 1e-4 * abs(float(lp))
    for a, b in zip(gk, gp):
        scale = max(float(b.abs().max()) if b.numel() else 0.0, 1e-3)
        assert ((a - b).abs() <= 5e-3 * b.abs() + 5e-4 * scale).all()


@pytest.mark.cuda
@pytest.mark.parametrize("loop", ["while", "scan"])
def test_render_progressive_on_cuda_matches_plain(loop):
    """`render_progressive` on the card launches B8 on random_spheres_2 and
    gives the frame of its plain sweeps."""
    _need_cuda()
    scene = mrt.scenes.random_spheres_2(1.0)
    n0 = flash.sphere_launches
    frame, st = mrt.render_progressive(scene, 16, 16, 4, max_bounces=4, loop=loop)
    assert frame.is_cuda and flash.sphere_launches > n0 and torch.isfinite(frame).all()
    plain, sp = mrt.render_progressive(scene, 16, 16, 4, max_bounces=4, loop=loop,
                                       plain=True)
    assert st["rays"] == sp["rays"]
    close = ((frame - plain).abs() <= 1e-5 * (1 + plain.abs())).all(-1)
    assert float(close.float().mean()) >= 0.99
