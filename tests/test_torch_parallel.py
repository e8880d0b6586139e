"""The port's device-parallel layer (`miniraytracer_tpu_torch/parallel/`)
against the JAX package's `parallel/` and against the port's single-device
renderers and train step, on the CPU.

Multi-rank cases run gloo groups of CPU processes: this file run as a script
(`python tests/test_torch_parallel.py --worker RANK WORLD PORT N_DP N_SP OUT`)
is one rank, as `tests/_distributed_worker.py` is for the JAX package. Each
rank joins through `init_distributed`, renders and trains on its mesh and
writes its results; every child has one torch thread and a join timeout, and
every collective a timeout, so a hung rank fails the test. The JAX side runs
in this process over conftest's eight virtual CPU devices, on the same mesh
shapes.

- meshes (2, 1), (1, 2) and (2, 2): the sharded wavefront (Cornell, 23x23,
  padded over dp), the progressive render (two_spheres, 9 spp: the last step
  of sp 2 merges one pass) and the work queue (Cornell, 25x25):
  - against the port's single-device renderer: equal bit for bit at sp = 1,
    within JAX's own tolerances at sp = 2 (tests/test_parallel.py: 5e-6 the
    wavefront and the progressive render, 1e-5 the queue); rays exact, the
    padding lanes' rays (a repeat of the last pixel, counted as the JAX
    package counts them) computed apart;
  - against JAX's function on the same mesh shape: JAX's is jitted, and
    XLA:CPU's contracted multiply-adds flip rare decisions, so the rule of
    tests/test_torch_bounce.py::test_torch_render_matches_xla_wavefront
    holds (rays within 0.5%, 97% of pixels within 1e-4, channel means within
    1%); the port's wavefront of tensor operations is the route JAX's takes
    on a CPU;
- the train step, unpacked and packed, on Cornell at 16x16: loss (rtol 1e-5)
  and every TrainParams gradient (rtol 2e-3, atol 2e-4 of the leaf's largest,
  tests/test_torch_train.py) equal to JAX's on (2, 1); on (2, 2) equal to
  JAX's divided by 2 (the JAX package's mesh step sums each dp row's loss
  over the sp axis too: ROADMAP.md, queue C) and, packed, to JAX's (2, 1) at
  `spp_step` doubled; `fused_ad=True` on every mesh against the port's
  single-device step at `spp_step` times n_sp;
- the trivial (1, 1) mesh equal to `mesh=None` and to the single-device
  renderers bit for bit; `auto_mesh_shape` equal to JAX's;
- the command line: `-devices 2` without a launcher exits naming torchrun,
  and the wavefront PNG of a 2-rank group (joined through the environment, as
  torchrun starts it) equals the 1-rank PNG byte for byte.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path.insert(0, ROOT)

import miniraytracer_tpu_torch as mrt  # noqa: E402
from miniraytracer_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from miniraytracer_tpu_torch.parallel import render as trender  # noqa: E402

torch.set_num_threads(1)

MESHES = [(2, 1), (1, 2), (2, 2)]
WF = (23, 4, 3)  # Cornell: size, spp, bounces
PROG = (24, 9, 4)  # two_spheres
QUEUE = (25, 4, 4)  # Cornell, max_lum 1e9 as tests/test_parallel.py
TW, TB = 16, 3  # the train steps: size, bounces
PW = 15  # a train step whose pixels do not split evenly over dp 2
LEAVES = mrt.TrainParams._fields
JOIN_S = 300  # a rank's wall-time limit
COLLECTIVE_S = 120  # a collective's


def _target():
    return np.random.default_rng(13).random((TW * TW, 3), dtype=np.float32) * 0.5


def _train_cases(n_sp):
    """label -> make_train_step kwargs of the rank's train cases; packed
    and fused take samples {0, 1} a pixel (2 on every mesh but (2, 1))."""
    spp = 2 if n_sp == 1 else 1
    return {"unpacked": dict(fused_ad=False),
            "packed": dict(fused_ad=False, pack=4, spp_step=spp),
            "fused": dict(fused_ad=True, spp_step=2)}


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------


def _rank_main(rank, world, port, n_dp, n_sp, out):
    mesh = tmesh.init_distributed(f"localhost:{port}", world, rank, device="cpu",
                                  timeout=COLLECTIVE_S)
    assert mesh.shape == dict(zip(("dp", "sp"), tmesh.auto_mesh_shape(world)))
    if (mesh.n_dp, mesh.n_sp) != (n_dp, n_sp):
        mesh = tmesh.make_mesh(n_dp, n_sp, device="cpu")
    assert (mesh.dp_index, mesh.sp_index) == divmod(rank, n_sp)
    res = {}
    cornell, spheres = mrt.scenes.cornell_box(1.0), mrt.scenes.two_spheres(1.0)
    size, spp, bounces = WF
    for fused in (None, False):
        f, s = trender.render_wavefront_distributed(cornell, size, size, spp, mesh,
                                                    max_bounces=bounces, fused=fused)
        key = "wf_fused" if fused is None else "wf_eager"
        res[key], res[key + "_rays"] = f.numpy(), s["rays"]
        assert s["renderer"] == ("wavefront-fused" if fused is None else "wavefront")
    size, spp, bounces = PROG
    f, s = trender.render_distributed(spheres, size, size, spp, mesh, max_bounces=bounces)
    res["prog"], res["prog_rays"] = f.numpy(), s["rays"]
    size, spp, bounces = QUEUE
    f, s = trender.render_workqueue_distributed(cornell, size, size, spp, mesh,
                                                max_bounces=bounces, max_lum=1e9)
    res["queue"], res["queue_rays"] = f.numpy(), s["rays"]
    params = mrt.extract_params(cornell)
    for label, kw in _train_cases(n_sp).items():
        step = mrt.make_train_step(width=TW, height=TW, max_bounces=TB, mesh=mesh, **kw)
        stats = {}
        new, loss, grads = step(params, cornell, _target(), 0, 0.5, stats=stats)
        res[f"{label}_loss"] = float(loss)
        res[f"{label}_rays"] = int(stats["rays"])
        for leaf, g, p in zip(LEAVES, grads, new):
            res[f"{label}_grad_{leaf}"], res[f"{label}_new_{leaf}"] = g.numpy(), p.numpy()
    # the padded layout: 15x15 over dp 2 is 226 rows, the last a repeat
    # masked out of the loss; the whole, the padded and this rank's target
    # rows give the same loss
    step = mrt.make_train_step(width=PW, height=PW, max_bounces=TB, fused_ad=False, mesh=mesh)
    full = _target()[:PW * PW]
    n_pad = trender._padded_size(PW * PW, n_dp)
    padded = np.concatenate([full, np.ones((n_pad - PW * PW, 3), np.float32)])
    local = n_pad // n_dp
    for layout, target in (("full", full), ("padded", padded),
                           ("rows", padded[mesh.dp_index * local:(mesh.dp_index + 1) * local])):
        res[f"pad_loss_{layout}"] = float(step(params, cornell, target, 0, 0.0)[1])
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)


def _cli_rank_main(argv):
    from miniraytracer_tpu_torch import cli

    sys.exit(cli.main(argv, device="cpu"))


# ---------------------------------------------------------------------------
# Starting them
# ---------------------------------------------------------------------------


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _child_env(**extra):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""), **extra)
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        if k not in extra:
            env.pop(k, None)
    return env


class World:
    """The ranks of one group, started at once; `wait()` waits for them
    (each within JOIN_S), fails on a rank's nonzero exit and returns their
    logs."""

    def __init__(self, argvs, envs, logs):
        self.logs = logs
        self.procs = []
        for argv, env, log in zip(argvs, envs, logs):
            with open(log, "w") as f:
                self.procs.append(subprocess.Popen(argv, cwd=ROOT, env=env, stdout=f,
                                                   stderr=subprocess.STDOUT))

    def wait(self):
        try:
            for p in self.procs:
                p.wait(timeout=JOIN_S)
        finally:
            self.kill()
        for p, log in zip(self.procs, self.logs):
            with open(log) as f:
                text = f.read()
            assert p.returncode == 0, f"rank exited {p.returncode}:\n{text[-3000:]}"
        return [open(log).read() for log in self.logs]

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _mesh_world(tmp, shape):
    n_dp, n_sp = shape
    world, port = n_dp * n_sp, _free_port()
    out = tmp / f"mesh{n_dp}x{n_sp}"
    out.mkdir()
    argvs = [[sys.executable, __file__, "--worker", str(r), str(world), str(port), str(n_dp),
              str(n_sp), str(out)] for r in range(world)]
    return World(argvs, [_child_env()] * world, [out / f"log{r}" for r in range(world)]), out


CLI_ARGS = ["-renderer", "wavefront", "-scene", "5", "-width", "16", "-height", "16",
            "-samples", "4", "-depth", "3"]


def _cli_world(tmp):
    port, out = _free_port(), tmp / "cli2"
    out.mkdir()
    argvs = [[sys.executable, __file__, "--cli", *CLI_ARGS, "-out", str(out / "two.png")]] * 2
    envs = [_child_env(MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE="2",
                       RANK=str(r), LOCAL_RANK=str(r)) for r in range(2)]
    return World(argvs, envs, [out / f"log{r}" for r in range(2)]), out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every group of the module started at once; {key: World, out}."""
    tmp = tmp_path_factory.mktemp("parallel")
    started = {shape: _mesh_world(tmp, shape) for shape in MESHES}
    started["cli"] = _cli_world(tmp)
    yield started
    for w, _ in started.values():
        w.kill()


_RESULTS = {}


def _ranks(worlds, shape):
    """The results of every rank of `shape`'s group, checked equal across
    ranks; returns rank 0's."""
    if shape not in _RESULTS:
        w, out = worlds[shape]
        w.wait()
        ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(len(w.procs))]
        for r in ranks[1:]:
            for k, v in ranks[0].items():
                np.testing.assert_array_equal(r[k], v, err_msg=f"{shape} {k} differs across ranks")
        _RESULTS[shape] = ranks[0]
    return _RESULTS[shape]


# ---------------------------------------------------------------------------
# References
# ---------------------------------------------------------------------------


def _pad_extra(n_pix, n_dp):
    """Padding lanes of a dp split: each repeats pixel n_pix - 1."""
    return trender._padded_size(n_pix, n_dp) - n_pix


@pytest.fixture(scope="module")
def single():
    """The port's single-device renders on the CPU, and the rays of the
    last pixel alone (what each padding lane adds)."""
    from miniraytracer_tpu_torch.models import integrator as tinteg
    from miniraytracer_tpu_torch.ops import bounce as tbounce

    cornell = mrt.scenes.cornell_box(1.0)
    size, spp, bounces = WF
    kw = dict(width=size, height=size, max_bounces=bounces, spp_sq=2)
    last = torch.tensor([size * size - 1], dtype=torch.int32)
    out = {"wf_fused": tbounce.render_wavefront_fused(cornell, size, size, spp,
                                                      max_bounces=bounces),
           "wf_eager": mrt.render_wavefront(cornell, size, size, spp, max_bounces=bounces,
                                            device="cpu"),
           "wf_fused_last": int(tbounce.render_wavefront_fused_pixels(
               cornell, last, 0, spp, 1000.0, **kw)[2].sum()),
           "wf_eager_last": int(tinteg.render_wavefront_pixels(
               cornell, last, 0, spp, 1000.0, **kw)[2].sum())}
    size, spp, bounces = PROG
    out["prog"] = mrt.render_progressive(mrt.scenes.two_spheres(1.0), size, size, spp,
                                         max_bounces=bounces, device="cpu")
    size, spp, bounces = QUEUE
    out["queue"] = mrt.render_workqueue(cornell, size, size, spp, max_bounces=bounces,
                                        max_lum=1e9, fused_shade=False, device="cpu")
    out["queue_last"] = int(tinteg.render_workqueue_pixels(
        cornell, 1, 1, spp, 1e9, width=size, height=size, max_bounces=bounces, spp_sq=2,
        fused_shade=False, pix_base=size * size - 1)[2])
    return out


_JAX = {}


def _jax_render(shape, what):
    """JAX's sharded render `what` on the (dp, sp) mesh `shape` of virtual
    CPU devices: (frame (H, W, 3), rays)."""
    key = (shape, what)
    if key not in _JAX:
        from miniraytracer_tpu.models import scenes as jscenes
        from miniraytracer_tpu.parallel import make_mesh
        from miniraytracer_tpu.parallel import render as jrender

        mesh = make_mesh(*shape)
        if what == "wf":
            size, spp, bounces = WF
            f, s = jrender.render_wavefront_distributed(
                jscenes.cornell_box(1.0), size, size, spp, mesh, max_bounces=bounces)
        elif what == "prog":
            size, spp, bounces = PROG
            f, s = jrender.render_distributed(jscenes.two_spheres(1.0), size, size, spp, mesh,
                                              max_bounces=bounces)
        else:
            size, spp, bounces = QUEUE
            f, s = jrender.render_workqueue_distributed(
                jscenes.cornell_box(1.0), size, size, spp, mesh, max_bounces=bounces,
                max_lum=1e9)
        _JAX[key] = np.asarray(f), int(s["rays"])
    return _JAX[key]


def _jax_train(shape, pack, spp_step):
    """JAX's mesh train step on Cornell at 16x16 from the scene's params
    (lr 0): (loss, {leaf: gradient})."""
    key = (shape, pack, spp_step)
    if key not in _JAX:
        import jax.numpy as jnp

        from miniraytracer_tpu.models import integrator as jinteg
        from miniraytracer_tpu.models import scenes as jscenes
        from miniraytracer_tpu.parallel import make_mesh
        from miniraytracer_tpu.parallel import render as jrender
        from miniraytracer_tpu.parallel import train as jtrain

        mesh = make_mesh(*shape)
        js = jscenes.cornell_box(1.0)
        n_pad = jrender._padded_size(TW * TW, shape[0])
        target = np.zeros((n_pad, 3), np.float32)
        target[:TW * TW] = _target()
        step = jtrain.make_train_step(mesh, width=TW, height=TW, max_bounces=TB, pack=pack,
                                      spp_step=spp_step)
        offs, _ = jinteg.sample_offsets(64)
        _, loss, grads = step(jtrain.extract_params(js), js, jnp.asarray(target),
                              jnp.int32(0), offs, jnp.float32(0.0))
        _JAX[key] = float(loss), {k: np.asarray(v) for k, v in grads._asdict().items()}
    return _JAX[key]


def _assert_grads(got, ref, what):
    for leaf in LEAVES:
        a, b = got[leaf], ref[leaf]
        assert a.shape == b.shape and np.isfinite(a).all(), (what, leaf)
        scale = max(np.abs(b).max(), 1e-3) if b.size else 1.0
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-4 * scale,
                                   err_msg=f"{what}: TrainParams.{leaf}")


def _grads(res, label):
    return {leaf: res[f"{label}_grad_{leaf}"] for leaf in LEAVES}


def _assert_jitted_rule(ours, rays, theirs, rays_j):
    """tests/test_torch_bounce.py's rule against jitted XLA:CPU renders."""
    assert abs(rays - rays_j) <= 0.005 * rays_j, (rays, rays_j)
    err = np.abs(ours - theirs).max(axis=-1)
    assert (err < 1e-4).mean() >= 0.97, (err < 1e-4).mean()
    np.testing.assert_allclose(ours.mean((0, 1)), theirs.mean((0, 1)), rtol=0.01)


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------


def test_auto_mesh_shape_matches_jax():
    from miniraytracer_tpu.parallel.mesh import auto_mesh_shape

    for n in range(1, 17):
        assert tmesh.auto_mesh_shape(n) == auto_mesh_shape(n), n


def test_make_mesh_without_a_group_is_trivial_or_raises():
    m = tmesh.make_mesh(device="cpu")
    assert (m.n_dp, m.n_sp, m.dp_index, m.sp_index, m.distributed) == (1, 1, 0, 0, False)
    t = torch.arange(3.0)
    assert m.all_reduce(t, "world") is t and torch.equal(t, torch.arange(3.0))
    with pytest.raises(ValueError, match="process group"):
        tmesh.make_mesh(2, 1, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.init_distributed("localhost:1", 1, 0)


# ---------------------------------------------------------------------------
# Sharded renders
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", ["wf_fused", "wf_eager"])
@pytest.mark.parametrize("shape", MESHES)
def test_mesh_wavefront_matches_single_device(worlds, single, shape, route):
    res = _ranks(worlds, shape)
    frame, stats = single[route]
    size = WF[0]
    extra = _pad_extra(size * size, shape[0]) * single[route + "_last"]
    assert res[route + "_rays"] == stats["rays"] + extra
    if shape[1] == 1:
        np.testing.assert_array_equal(res[route], frame.numpy())
    else:
        np.testing.assert_allclose(res[route], frame.numpy(), rtol=0, atol=5e-6)


@pytest.mark.parametrize("shape", MESHES)
def test_mesh_wavefront_matches_jax_on_the_same_mesh(worlds, shape):
    fj, rays_j = _jax_render(shape, "wf")  # while the ranks run
    res = _ranks(worlds, shape)
    _assert_jitted_rule(res["wf_eager"], res["wf_eager_rays"], fj, rays_j)


@pytest.mark.parametrize("shape", MESHES)
def test_mesh_progressive_matches_single_device(worlds, single, shape):
    res = _ranks(worlds, shape)
    frame, stats = single["prog"]
    assert res["prog_rays"] == stats["rays"]  # 24x24: no padding
    if shape[1] == 1:
        np.testing.assert_array_equal(res["prog"], frame.numpy())
    else:
        np.testing.assert_allclose(res["prog"], frame.numpy(), rtol=0, atol=5e-6)


@pytest.mark.parametrize("shape", MESHES)
def test_mesh_progressive_matches_jax_on_the_same_mesh(worlds, shape):
    fj, rays_j = _jax_render(shape, "prog")
    res = _ranks(worlds, shape)
    _assert_jitted_rule(res["prog"], res["prog_rays"], fj, rays_j)


@pytest.mark.parametrize("shape", MESHES)
def test_mesh_workqueue_matches_single_device(worlds, single, shape):
    res = _ranks(worlds, shape)
    frame, stats = single["queue"]
    size = QUEUE[0]
    assert res["queue_rays"] == stats["rays"] + _pad_extra(size * size, shape[0]) * single[
        "queue_last"]
    np.testing.assert_allclose(res["queue"], frame.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", MESHES)
def test_mesh_workqueue_matches_jax_on_the_same_mesh(worlds, shape):
    fj, rays_j = _jax_render(shape, "queue")
    res = _ranks(worlds, shape)
    _assert_jitted_rule(res["queue"], res["queue_rays"], fj, rays_j)


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("label,pack,spp_step", [("unpacked", 1, 1), ("packed", 4, 2)])
def test_mesh_train_step_matches_jax_on_dp(worlds, label, pack, spp_step):
    lj, gj = _jax_train((2, 1), pack, spp_step)
    res = _ranks(worlds, (2, 1))
    np.testing.assert_allclose(res[f"{label}_loss"], lj, rtol=1e-5)
    _assert_grads(_grads(res, label), gj, f"{label} (2, 1)")


@pytest.mark.parametrize("label,pack", [("unpacked", 1), ("packed", 4)])
def test_mesh_train_step_on_sp_is_jax_over_n_sp(worlds, label, pack):
    """JAX's (2, 2) step sums each dp row's SSE over the sp axis as well, so
    its loss and gradients are twice the stated loss's; the port's are
    JAX's halved, and (packed) equal to JAX's (2, 1) step at spp_step 2,
    which renders the same samples {0, 1} of every pixel."""
    lj, gj = _jax_train((2, 2), pack, 1)
    res = _ranks(worlds, (2, 2))
    np.testing.assert_allclose(res[f"{label}_loss"], lj / 2, rtol=1e-5)
    _assert_grads(_grads(res, label), {k: v / 2 for k, v in gj.items()}, f"{label} (2, 2)")
    if pack > 1:
        l1, g1 = _jax_train((2, 1), pack, 2)
        np.testing.assert_allclose(res[f"{label}_loss"], l1, rtol=1e-5)
        _assert_grads(_grads(res, label), g1, f"{label} (2, 2) vs (2, 1) at spp_step 2")


@pytest.fixture(scope="module")
def single_steps():
    """The port's single-device step on the CPU: {(label, spp_step): (loss,
    grads, new params, rays)} from the scene's params at lr 0.5."""
    cache = {}

    def get(label, spp_step):
        if (label, spp_step) not in cache:
            kw = dict(_train_cases(1)[label], spp_step=spp_step)
            step = mrt.make_train_step(width=TW, height=TW, max_bounces=TB, device="cpu", **kw)
            cornell = mrt.scenes.cornell_box(1.0)
            stats = {}
            new, loss, grads = step(mrt.extract_params(cornell), cornell, _target(), 0, 0.5,
                                    stats=stats)
            cache[label, spp_step] = (float(loss), dict(zip(LEAVES, (g.numpy() for g in grads))),
                                      dict(zip(LEAVES, (p.numpy() for p in new))),
                                      int(stats["rays"]))
        return cache[label, spp_step]

    return get


@pytest.mark.parametrize("label", ["unpacked", "packed", "fused"])
@pytest.mark.parametrize("shape", MESHES)
def test_mesh_train_step_matches_single_device_at_n_sp_times_spp_step(worlds, single_steps,
                                                                      shape, label):
    """A (dp, n_sp) mesh at spp_step k renders the samples [0, k*n_sp) of
    every pixel, as one device at spp_step k*n_sp (unpacked: k is 1, and
    samples 0 and 1 at offsets 0 and 1 are the packed single-device step's
    at spp_step 2); its update is p - lr*g on every rank. Rays equal but for
    the padding (16x16: none)."""
    res = _ranks(worlds, shape)
    k = _train_cases(shape[1])[label].get("spp_step", 1)
    ref = "packed" if label == "unpacked" and shape[1] > 1 else label
    loss, grads, new, rays = single_steps(ref, k * shape[1])
    np.testing.assert_allclose(res[f"{label}_loss"], loss, rtol=1e-5)
    _assert_grads(_grads(res, label), grads, f"{label} {shape}")
    assert res[f"{label}_rays"] == rays
    for leaf in LEAVES:
        p = mrt.extract_params(mrt.scenes.cornell_box(1.0))._asdict()[leaf].numpy()
        np.testing.assert_allclose(res[f"{label}_new_{leaf}"],
                                   p - 0.5 * res[f"{label}_grad_{leaf}"], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kw", [dict(fused_ad=True, spp_step=2),
                                dict(fused_ad=False, pack=4, spp_step=2),
                                dict(fused_ad=False)], ids=["fused", "packed", "unpacked"])
def test_trivial_mesh_train_step_equals_one_device_bit_for_bit(kw):
    cornell = mrt.scenes.cornell_box(1.0)
    steps = [mrt.make_train_step(width=TW, height=TW, max_bounces=TB, device="cpu", **kw),
             mrt.make_train_step(width=TW, height=TW, max_bounces=TB,
                                 mesh=tmesh.make_mesh(device="cpu"), **kw)]
    (n0, l0, g0), (n1, l1, g1) = (s(mrt.extract_params(cornell), cornell, _target(), 1, 0.5)
                                  for s in steps)
    assert torch.equal(l0, l1)
    for a, b in zip(list(g0) + list(n0), list(g1) + list(n1)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape", MESHES)
def test_mesh_train_step_masks_the_padding(worlds, shape):
    """At 15x15 the dp split pads one row (a repeat of the last pixel, its
    target row 1.0 in the padded layout): it is masked out of the loss,
    which equals the single-device step's for every layout of the target
    (on sp 2, samples 0 and 1: the packed step's at spp_step 2)."""
    res = _ranks(worlds, shape)
    cornell = mrt.scenes.cornell_box(1.0)
    kw = {} if shape[1] == 1 else dict(pack=4, spp_step=2)
    step = mrt.make_train_step(width=PW, height=PW, max_bounces=TB, fused_ad=False,
                               device="cpu", **kw)
    loss = float(step(mrt.extract_params(cornell), cornell, _target()[:PW * PW], 0, 0.0)[1])
    for layout in ("full", "padded", "rows"):
        np.testing.assert_allclose(res[f"pad_loss_{layout}"], loss, rtol=1e-5, err_msg=layout)
    with pytest.raises(ValueError, match="target must have shape"):
        step(mrt.extract_params(cornell), cornell, torch.zeros((PW * PW + 1, 3)), 0, 0.0)


# ---------------------------------------------------------------------------
# The trivial mesh's renders
# ---------------------------------------------------------------------------


def test_trivial_mesh_renders_equal_single_device_bit_for_bit(single):
    m = tmesh.make_mesh(device="cpu")
    cornell, spheres = mrt.scenes.cornell_box(1.0), mrt.scenes.two_spheres(1.0)
    size, spp, bounces = WF
    for fused, key in ((None, "wf_fused"), (False, "wf_eager")):
        f, s = trender.render_wavefront_distributed(cornell, size, size, spp, m,
                                                    max_bounces=bounces, fused=fused)
        assert torch.equal(f, single[key][0]) and s["rays"] == single[key][1]["rays"]
    size, spp, bounces = PROG
    frames = []
    f, s = trender.render_distributed(spheres, size, size, spp, m, max_bounces=bounces,
                                      progress=lambda i, ns, rows: frames.append(i))
    assert torch.equal(f, single["prog"][0]) and s["rays"] == single["prog"][1]["rays"]
    assert frames == list(range(1, spp + 1))
    size, spp, bounces = QUEUE
    f, s = trender.render_workqueue_distributed(cornell, size, size, spp, m,
                                                max_bounces=bounces, max_lum=1e9)
    f1, s1 = mrt.render_workqueue(cornell, size, size, spp, max_bounces=bounces, max_lum=1e9,
                                  n_lanes=size * size, fused_shade=False, device="cpu")
    assert torch.equal(f, f1) and s["rays"] == s1["rays"] == single["queue"][1]["rays"]


def test_workqueue_pix_base_shifts_pixels_not_rows():
    """`pix_base` moves the items' pixels and keeps their rows: a queue over
    pixels [100, 140) equals rows 100-139 of the whole frame's queue, in
    counts and rays to the item, the sums to rounding."""
    from miniraytracer_tpu_torch.models import integrator as tinteg

    cornell = mrt.scenes.cornell_box(1.0)
    kw = dict(width=16, height=16, max_bounces=3, spp_sq=2, fused_shade=False)
    a, c, _ = tinteg.render_workqueue_pixels(cornell, 256, 256, 4, 1e9, **kw)
    a2, c2, r2 = tinteg.render_workqueue_pixels(cornell, 40, 40, 4, 1e9, pix_base=100, **kw)
    assert torch.equal(c2, c[100:140])
    torch.testing.assert_close(a2, a[100:140], rtol=1e-6, atol=1e-6)
    # past the image the pixel is clamped to the last one
    a3, c3, _ = tinteg.render_workqueue_pixels(cornell, 4, 4, 4, 1e9, pix_base=254, **kw)
    assert torch.equal(c3, c[[254, 255, 255, 255]])
    torch.testing.assert_close(a3[1:], a3[1:2].expand(3, 3), rtol=1e-6, atol=1e-6)
    assert int(r2) > 0


# ---------------------------------------------------------------------------
# The command line
# ---------------------------------------------------------------------------


def test_cli_devices_above_one_without_a_launcher_exits(tmp_path, monkeypatch):
    from miniraytracer_tpu_torch import cli

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node 2"):
        cli.main(CLI_ARGS + ["-devices", "2", "-out", str(tmp_path / "x.png")], device="cpu")
    assert not (tmp_path / "x.png").exists()


def test_cli_wavefront_png_of_two_ranks_equals_one_rank(worlds, tmp_path, capsys, monkeypatch):
    from miniraytracer_tpu_torch import cli

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    cli.main(CLI_ARGS + ["-devices", "1", "-out", str(tmp_path / "one.png")], device="cpu")
    assert "1 device(s) mesh 1x1" in capsys.readouterr().out
    w, out = worlds["cli"]
    logs = w.wait()
    assert "2 device(s) mesh 2x1" in logs[0] and "wrote" in logs[0]
    assert "Mrays/s" not in logs[1] and "wrote" not in logs[1]  # rank 1 prints no result
    assert (out / "two.png").read_bytes() == (tmp_path / "one.png").read_bytes()


if __name__ == "__main__":
    if sys.argv[1] == "--worker":
        _rank_main(*map(int, sys.argv[2:7]), sys.argv[7])
    elif sys.argv[1] == "--cli":
        _cli_rank_main(sys.argv[2:])
    else:
        sys.exit(f"usage: {json.dumps(sys.argv)}: --worker RANK WORLD PORT N_DP N_SP OUT "
                 "or --cli ARGS")
