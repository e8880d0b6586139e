"""The port's forward slice end to end: public entry points, routing,
kernel build and launch plumbing. Tests marked `cuda` need an NVIDIA GPU
and skip elsewhere."""

import re

import numpy as np
import pytest
import torch

import miniraytracer_tpu_torch as mrt
from miniraytracer_tpu_torch.ops import bounce
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
    scene = b.build()
    assert not bounce.can_fuse(scene)
    with pytest.raises(NotImplementedError, match="render_workqueue"):
        mrt.pick_renderer(scene)
    with pytest.raises(NotImplementedError):
        mrt.render(scene, 8, 8, 1, device="cpu")
    pix = torch.arange(64, dtype=torch.int32)
    with pytest.raises(ValueError, match="fused class"):
        bounce.render_wavefront_fused_pixels(
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
    src = (kernels.CSRC / "bounce.cu").read_text()
    n = int(re.search(r"static_assert\(P_COUNT == (\d+)", src).group(1))
    assert n == bounce._N_IPARAMS
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
    params, loss, grads = step(mrt.extract_params(scene), scene, target, 0, 0.01)
    outer = bounce_ad.scan_plan(2, 6)[3]
    assert bounce_ad.fwd_launches == fwd0 + outer
    assert bounce_ad.bwd_launches == bwd0 + outer
    assert loss.is_cuda and torch.isfinite(loss)
    assert all(g.is_cuda and torch.isfinite(g).all() for g in grads)
    assert float(grads.tex_c0.abs().max()) > 0
    # the same scan through the plain versions (the same grey target)
    chip_smoke.compare_scans(mrt, bounce, bounce_ad, scene.to("cuda"), w, h, 2, 6,
                             "cornell_box 24x24")
