"""miniraytracer_tpu_torch — the PyTorch/CUDA port of miniraytracer_tpu.

Eight paths are ported. For the fused scene class (cornell_box,
cornell_smoke, two_spheres, perlin_spheres): the forward path tracer
(`render`, kernel `csrc/bounce.cu`) and the differentiable train step
(`make_train_step`, kernels `csrc/bounce_ad.cu`: the scan step and its
hand-derived backward). For scenes beyond it, `render` picks by the JAX
package's rule between the hybrid forward renderer (random_spheres with its
~490 spheres and materials: dense nearest-hit kernels of `csrc/flash.cu`
feeding one step kernel of `csrc/hybrid.cu`) and the work-queue renderer
(`render_workqueue`: earth with its image texture, book2_final with 1006
spheres and 400 boxes: the clustered sphere sweeps of `csrc/flash.cu` and the
shade kernel of `csrc/hybrid.cu`, lanes claiming (pixel, sample) items from a
global queue). Where that shade kernel does not fit the scene (random_spheres_2:
its own materials, an image and Perlin noise), the queue, like the plain
wavefront `render_wavefront`, runs the bounce in tensor operations, with the
sweeps of `csrc/flash.cu` and the turbulence kernel of `csrc/noise.cu`. A
triangle set of 1024 or more (the triangles scene's meshes, about 11,300) is
swept over Morton clusters by the clustered triangle sweeps of
`csrc/flash.cu`, in every renderer. The kernels are hand-written CUDA, built
with nvcc on first use.

The JAX package's default train step is ported too: `make_train_step(...,
fused_ad=False)` trains every scene through the scans of
`models/integrator.py` (`sample_radiance(loop="scan")`, one sample a pixel,
or `sample_radiance_packed` with `pack` items a lane and `spp_step` samples
a pixel): the bounce in tensor operations under autograd, each scan step
rematerialised in the backward (`torch.utils.checkpoint`), the sphere and
triangle sets swept by the kernels of `csrc/flash.cu` under their custom
VJPs (`intersect.make_accel(differentiable=True)`). `render_progressive` is
the JAX package's progressive renderer (one sample of every pixel a pass,
the draw2 average), with the while or the scan loop.

The JAX package's command line is ported with its flags and defaults:
`python -m miniraytracer_tpu_torch -scene 5 -renderer auto -out o.png`
(`cli.py`; tone maps, PNG/PPM, checkpoints, the Hilbert tile order of the
preview and the live view in `utils/`), and so are its triangle BVH
(`ops/bvh.py`, a component no renderer calls) and its 4x4 helpers
(`ops/mat4.py`).

The JAX package's device-parallel layer is ported over `torch.distributed`,
one process a device (`parallel/`): `init_distributed` and `make_mesh` make
the (dp, sp) mesh, `render_wavefront_distributed`, `render_distributed` and
`render_workqueue_distributed` split pixels over dp and samples over sp, and
`make_train_step(..., mesh=mesh)` sums the loss and the gradients over the
ranks; the command line renders its wavefront over the mesh of a launcher
(`torchrun --nproc-per-node N -m miniraytracer_tpu_torch ...`).

The entry points run on the NVIDIA GPU: `device=None` means "cuda", the scene
is moved there, and with no card the call raises. `device="cpu"` runs the
plain PyTorch versions of the kernels instead (what the tests do). Functions
that take tensors follow their tensors' device.

Quick start:

    import miniraytracer_tpu_torch as mrt
    scene = mrt.scenes.cornell_box(aspect=1.0)
    frame, stats = mrt.render(scene, 500, 500, spp=64)      # on the GPU
    frame, stats = mrt.render(mrt.scenes.random_spheres(1.0), 500, 500, 64)
    frame, stats = mrt.render(mrt.scenes.book2_final(1.0), 500, 500, 64)
    frame, stats = mrt.render(mrt.scenes.random_spheres_2(1.0), 500, 500, 64)
    # with $MRT_ASSETS/obj/ holding the meshes (or the stand-ins that
    # mrt.scenes.write_stand_in_meshes writes):
    frame, stats = mrt.render(mrt.scenes.triangles(1.0), 500, 500, 64)

    step = mrt.make_train_step(width=500, height=500, max_bounces=32,
                               spp_step=128)
    params = mrt.extract_params(scene)
    params, loss, grads = step(params, scene, target, sample0=0, lr=0.5)
    # any scene, the JAX package's default step (the packed scan):
    rs2 = mrt.scenes.random_spheres_2(1.0)
    step = mrt.make_train_step(width=500, height=500, max_bounces=32,
                               fused_ad=False, pack=16, spp_step=8)
    params, loss, grads = step(mrt.extract_params(rs2), rs2, target, 0, 0.5)
    frame, stats = mrt.render_progressive(scene, 500, 500, 16)

CPU tests of the scans and the progressive renderer against the JAX
package: `python -m pytest tests/test_torch_scan.py
tests/test_torch_scan_train.py tests/test_torch_scan_packed.py`;
`python3 chip_smoke.py` runs them on the card (phases 31-33).
"""

__version__ = "0.1.0"

from miniraytracer_tpu_torch.scene.types import SceneData, Camera  # noqa: F401
from miniraytracer_tpu_torch.scene.builder import SceneBuilder  # noqa: F401
from miniraytracer_tpu_torch.models import scenes  # noqa: F401
from miniraytracer_tpu_torch.models.integrator import (  # noqa: F401
    render as render_progressive,
    render_auto as render,
    render_wavefront,
    render_workqueue,
    pick_renderer,
    sample_radiance,
    sample_radiance_packed,
)
from miniraytracer_tpu_torch.parallel.train import (  # noqa: F401
    TrainParams,
    apply_params,
    extract_params,
    make_train_step,
    params_from_numpy,
)
