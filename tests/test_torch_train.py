"""The port's train step and its gradients against the JAX package.

- SSE loss and every `TrainParams` gradient of the fused AD scan against
  `jax.value_and_grad` through the JAX fused entry point (interpret mode), at
  the JAX test's own tolerance (tests/test_bounce_ad.py: rtol 2e-3, atol 2e-4
  of the leaf's largest gradient);
- the gradients against central finite differences of the plain step
  evaluated in float64;
- `make_train_step(device="cpu")` against the JAX `make_train_step` on a 1x1
  mesh with `fused_ad=True`.

The JAX references are computed once per module. On the CPU the port runs the
plain PyTorch versions of its kernels.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import miniraytracer_tpu_torch as mrt
from miniraytracer_tpu.models import integrator as jinteg
from miniraytracer_tpu.ops import bounce_ad as jad
from miniraytracer_tpu.parallel import make_mesh
from miniraytracer_tpu.parallel import train as jtrain
from miniraytracer_tpu_torch.ops import bounce as tbounce
from miniraytracer_tpu_torch.ops import bounce_ad as tad
from miniraytracer_tpu_torch.parallel import train as ttrain
from tests.test_torch_bounce_ad import scene_pair

torch.set_num_threads(1)

SPP, BOUNCES = 2, 6
STEPS = SPP * (BOUNCES + 1) + 2
LEAVES = ttrain.TrainParams._fields


def _numpy_params(jparams):
    return {k: np.asarray(v) for k, v in jparams._asdict().items()}


# ---------------------------------------------------------------------------
# Loss and gradients of the scan
# ---------------------------------------------------------------------------

_REF = {}


@pytest.fixture(scope="module")
def jax_loss_and_grads():
    """name -> (loss, TrainParams grads as numpy) of the JAX fused AD path
    at 10x10, SSE against a flat 0.25 target; once per scene."""
    w = h = 10
    pix = jnp.arange(w * h, dtype=jnp.uint32)
    target = jnp.full((w * h, 3), 0.25, jnp.float32)

    def get(name):
        if name not in _REF:
            js, _ = scene_pair(name)

            def loss(params):
                sc = jtrain.apply_params(js, params)
                summ, nv, _ = jad.sample_pixel_sums_fused(
                    sc, pix, 0, SPP, width=w, height=h, max_bounces=BOUNCES,
                    scan_steps=STEPS, interpret=True)
                mean = (jnp.stack([summ.x, summ.y, summ.z], -1)
                        / jnp.maximum(nv, 1.0)[:, None])
                err = jnp.where(nv[:, None] > 0, mean - target, 0.0)
                return jnp.sum(err * err)

            lj, gj = jax.value_and_grad(loss)(jtrain.extract_params(js))
            _REF[name] = float(lj), _numpy_params(gj)
        return _REF[name]

    yield get
    _REF.clear()


_PORT = {}


def _port_loss_and_grads(name):
    if name not in _PORT:
        _, ts = scene_pair(name)
        w = h = 10
        leaves = mrt.TrainParams(*(p.clone().requires_grad_(True)
                                   for p in mrt.extract_params(ts)))
        pix = torch.arange(w * h, dtype=torch.int32)
        summ, nv, _ = tad.sample_pixel_sums_fused(
            mrt.apply_params(ts, leaves), pix, 0, SPP, width=w, height=h,
            max_bounces=BOUNCES, scan_steps=STEPS)
        err = torch.where(nv[:, None] > 0,
                          summ / nv.clamp_min(1)[:, None] - 0.25, 0.0)
        loss = (err * err).sum()
        grads = torch.autograd.grad(loss, list(leaves), allow_unused=True)
        _PORT[name] = float(loss.detach()), {
            k: (torch.zeros_like(p) if g is None else g).numpy()
            for k, p, g in zip(LEAVES, leaves, grads)}
    return _PORT[name]


@pytest.mark.parametrize("name", ["cornell_box", "sphere_light"])
def test_sse_loss_matches_jax_fused_ad(jax_loss_and_grads, name):
    lj, gj = jax_loss_and_grads(name)
    lt, gt = _port_loss_and_grads(name)
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    assert any(np.abs(g).max() > 0 for g in gj.values()), "degenerate reference"
    assert all(np.isfinite(g).all() for g in gt.values())


@pytest.mark.parametrize("leaf", LEAVES)
@pytest.mark.parametrize("name", ["cornell_box", "sphere_light"])
def test_train_params_gradient_matches_jax_fused_ad(jax_loss_and_grads, name, leaf):
    _, gj = jax_loss_and_grads(name)
    _, gt = _port_loss_and_grads(name)
    a, b = gt[leaf], gj[leaf]
    assert a.shape == b.shape and np.isfinite(a).all()
    scale = max(np.abs(b).max(), 1e-3)
    np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-4 * scale,
                               err_msg=f"TrainParams.{leaf}")


# ---------------------------------------------------------------------------
# Finite differences in float64
# ---------------------------------------------------------------------------


def _fd_scene():
    """tests/test_parallel.py's smooth scene: the camera looks at a big
    lambertian sphere in front of a big triangle under a big soft sphere
    light and the sky, so that no visibility decision flips within the
    finite-difference step."""
    b = mrt.SceneBuilder()
    b.name = "fd_scene"
    b.set_camera([0, 0.9, 4.2], [0, 0.9, 0], [0, 1, 0], 40.0, 1.0,
                 aperture=0.0, focus_dist=4.2, t0=0.0, t1=0.0)
    b.sphere([0.0, 0.9, 0.0], 1.1, b.lambertian(b.tex_const([0.7, 0.3, 0.2])))
    b.triangle([-4, -1.2, -2.5], [4, -1.2, -2.5], [0, 5.5, -2.8],
               b.lambertian(b.tex_const([0.3, 0.5, 0.7])))
    lm = b.diffuse_light(b.tex_const([1.0, 0.9, 0.8]), 9.0)
    b.add_light(b.sphere([2.5, 4.5, 2.5], 1.4, lm))
    b.use_sky = True
    return b.build()


FD_W = FD_H = 6
FD_SPP, FD_BOUNCES = 2, 3
FD_STEPS = FD_SPP * (FD_BOUNCES + 1) + 2


def _sum_float64(scene):
    """Sum of every lane's radiance sum, with the plain step run in float64
    from the scene's (float32) tables."""
    meta, tables = tbounce.pack_scene(scene)
    tables = [t.double() for t in tables]
    _, claim, _, outer = tad.scan_plan(FD_SPP, FD_BOUNCES, FD_STEPS, 1)
    cfg = tad.StepConfig(FD_W, FD_H, 8, FD_BOUNCES, FD_SPP, claim, 1)
    pix = torch.arange(FD_W * FD_H, dtype=torch.int32)
    sb = torch.zeros_like(pix)
    f0, i0, k0 = tad.initial_state(scene, pix, sb, FD_SPP, width=FD_W,
                                   height=FD_H, sq_off=8)
    f, i, k = tuple(f0.double()), tuple(i0), tad._keys_u32(k0)
    with torch.no_grad():
        for t in range(outer):
            f, i, k = tad._plain_substeps(meta, cfg, tables, t, f, i, k,
                                          pix.long(), sb.long())
    assert f[0].dtype == torch.float64
    assert float(f[tad.A_NV].sum()) == FD_W * FD_H * FD_SPP
    return float(f[0].sum() + f[1].sum() + f[2].sum())


_FD_GRADS = {}


def _fd_grads():
    if not _FD_GRADS:
        scene = _fd_scene()
        leaves = mrt.TrainParams(*(p.clone().requires_grad_(True)
                                   for p in mrt.extract_params(scene)))
        pix = torch.arange(FD_W * FD_H, dtype=torch.int32)
        summ, nv, _ = tad.sample_pixel_sums_fused(
            mrt.apply_params(scene, leaves), pix, 0, FD_SPP, width=FD_W,
            height=FD_H, max_bounces=FD_BOUNCES, scan_steps=FD_STEPS)
        grads = torch.autograd.grad(summ.sum(), list(leaves))
        _FD_GRADS.update(zip(LEAVES, grads))
    return _FD_GRADS


# (leaf, index, eps): textures 0 = the sphere's albedo, 2 = the light's
# colour; material 2 = the light (emission scale)
@pytest.mark.parametrize("leaf,idx,eps", [
    ("mat_param", (2,), 1e-2),    # the light's emission scale
    ("tex_c0", (0, 0), 1e-2),     # an albedo channel
    ("tex_c0", (2, 1), 1e-2),     # an emission colour channel
    ("sph_radius", (0,), 3e-4),   # a sphere's radius
    ("sph_c0", (0, 2), 3e-4),     # a sphere's centre
    ("tri_m", (0, 2), 3e-4),      # a triangle vertex coordinate
])
def test_gradient_matches_float64_central_differences(leaf, idx, eps):
    """The scan's backward (float32) against central differences of the
    plain step in float64. The counter-based RNG makes the differences
    deterministic; 2% as tests/test_parallel.py asserts for the JAX path.
    Float64 allows a geometry step of 3e-4: at the 3e-3 a float32 difference
    needs, one lane's shadow ray crosses the triangle's edge."""
    ad = float(_fd_grads()[leaf][idx])
    scene = _fd_scene()
    vals = []
    for sign in (1.0, -1.0):
        arr = getattr(scene, leaf).clone()
        arr[idx] += sign * eps
        vals.append((float(arr[idx]), _sum_float64(
            dataclasses.replace(scene, **{leaf: arr}))))
    (hi, f_hi), (lo, f_lo) = vals
    fd = (f_hi - f_lo) / (hi - lo)  # the float32 leaf's actual difference
    assert np.isfinite(ad) and np.isfinite(fd)
    assert abs(fd) > 1e-4, f"no finite-difference signal for {leaf}{idx}"
    np.testing.assert_allclose(ad, fd, rtol=2e-2, atol=2e-4)


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

TW = TH = 12


@pytest.fixture(scope="module")
def jax_train_step():
    """One step of the JAX train step (1x1 mesh, fused AD, interpret mode) on
    the Cornell box at 12x12 against a seeded target."""
    js, _ = scene_pair("cornell_box")
    target = np.random.default_rng(7).random((TW * TH, 3), dtype=np.float32)
    step = jtrain.make_train_step(
        make_mesh(1, 1), width=TW, height=TH, max_bounces=BOUNCES,
        scan_steps=STEPS, spp_step=SPP, fused_ad=True, interpret=True)
    offs, _ = jinteg.sample_offsets(64)
    params = jtrain.extract_params(js)
    new, loss, grads = step(params, js, jnp.asarray(target), jnp.int32(1), offs,
                            jnp.float32(0.05))
    return (target, _numpy_params(params), _numpy_params(new), float(loss),
            _numpy_params(grads))


def test_train_step_matches_jax_train_step(jax_train_step):
    target, p0, new_j, loss_j, grads_j = jax_train_step
    _, ts = scene_pair("cornell_box")
    step = mrt.make_train_step(width=TW, height=TH, max_bounces=BOUNCES,
                               scan_steps=STEPS, spp_step=SPP, device="cpu")
    params = mrt.params_from_numpy(p0)
    new, loss, grads = step(params, ts, target, 1, 0.05)
    np.testing.assert_allclose(float(loss), loss_j, rtol=1e-5)
    for leaf in LEAVES:
        g, gj = getattr(grads, leaf).numpy(), grads_j[leaf]
        scale = max(np.abs(gj).max(), 1e-3)
        np.testing.assert_allclose(g, gj, rtol=2e-3, atol=2e-4 * scale,
                                   err_msg=f"grads.{leaf}")
        np.testing.assert_allclose(
            getattr(new, leaf).numpy(), new_j[leaf], rtol=1e-5,
            atol=0.05 * 2e-4 * scale + 1e-7, err_msg=f"params.{leaf}")
        assert not getattr(new, leaf).requires_grad
    assert float(grads.tex_c0.abs().max()) > 0


def test_params_from_numpy_round_trip(jax_train_step):
    _, p0, _, _, _ = jax_train_step
    _, ts = scene_pair("cornell_box")
    params = mrt.params_from_numpy(p0)
    assert isinstance(params, mrt.TrainParams)
    for leaf, mine in zip(LEAVES, mrt.extract_params(ts)):
        got = getattr(params, leaf)
        assert got.dtype == torch.float32 and got.shape == mine.shape
        np.testing.assert_array_equal(got.numpy(), p0[leaf])
        np.testing.assert_allclose(got.numpy(), mine.numpy(), rtol=1e-6, atol=1e-7)
    scene2 = mrt.apply_params(ts, params)
    assert scene2.tex_c0 is params.tex_c0 and scene2.n_rects == ts.n_rects


def test_two_steps_lower_the_loss_toward_a_perturbed_albedo():
    """A target rendered by the same estimator with other wall albedos: SGD
    steps on the same samples (lr 0.5; at 1.0 the light's emission scale
    overshoots) move the loss down and the albedos toward the target's."""
    _, ts = scene_pair("cornell_box")
    w = h = 12
    c0 = ts.tex_c0.clone()
    c0[0] = torch.tensor([0.35, 0.25, 0.15])
    c0[1] = torch.tensor([0.50, 0.50, 0.50])
    pix = torch.arange(w * h, dtype=torch.int32)
    with torch.no_grad():
        summ, nv, _ = tad.sample_pixel_sums_fused(
            dataclasses.replace(ts, tex_c0=c0), pix, 0, 4, width=w, height=h,
            max_bounces=BOUNCES)
    target = summ / nv.clamp_min(1)[:, None]
    step = mrt.make_train_step(width=w, height=h, max_bounces=BOUNCES,
                               spp_step=4, device="cpu")
    params = mrt.extract_params(ts)
    losses = []
    for _ in range(3):
        params, loss, grads = step(params, ts, target, 0, 0.5)
        losses.append(float(loss))
        assert all(torch.isfinite(g).all() for g in grads)
    assert losses[0] > 0 and losses[2] < losses[1] < losses[0], losses
    before = (ts.tex_c0[:2] - c0[:2]).abs().sum()
    assert (params.tex_c0[:2] - c0[:2]).abs().sum() < before


def test_unported_train_paths_raise():
    """Every fused_ad of the JAX package is taken (False is the scans');
    what none takes raises."""
    for kw in (dict(fused_ad="xla"), dict(fused_ad=False, pack=0)):
        with pytest.raises(ValueError):
            mrt.make_train_step(width=8, height=8, max_bounces=4, device="cpu", **kw)
    scan = mrt.make_train_step(width=4, height=4, max_bounces=2, device="cpu", fused_ad=False)
    _, cornell = scene_pair("cornell_box")
    _, loss, grads = scan(mrt.extract_params(cornell), cornell, torch.zeros((16, 3)), 0, 0.1)
    assert float(loss) > 0 and all(torch.isfinite(g).all() for g in grads)
    # the hybrid-ext step needs the concrete scene, as in the JAX package
    with pytest.raises(ValueError, match="scene"):
        mrt.make_train_step(width=8, height=8, max_bounces=4, device="cpu", fused_ad="ext")
    step = mrt.make_train_step(width=8, height=8, max_bounces=4, device="cpu")
    _, ts = scene_pair("cornell_box")
    with pytest.raises(ValueError, match="target must have shape"):
        step(mrt.extract_params(ts), ts, torch.zeros((8, 8, 3)), 0, 0.1)
