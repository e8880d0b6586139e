"""miniraytracer_tpu_torch — the PyTorch/CUDA port of miniraytracer_tpu.

Two paths are ported, both for the fused scene class (cornell_box,
cornell_smoke, two_spheres, perlin_spheres): the forward path tracer
(`render`, kernel `csrc/bounce.cu`) and the differentiable train step
(`make_train_step`, kernels `csrc/bounce_ad.cu`: the scan step and its
hand-derived backward). The kernels are hand-written CUDA, built with nvcc on
first use.

The entry points run on the NVIDIA GPU: `device=None` means "cuda", the scene
is moved there, and with no card the call raises. `device="cpu"` runs the
plain PyTorch versions of the kernels instead (what the tests do). Functions
that take tensors follow their tensors' device.

Quick start:

    import miniraytracer_tpu_torch as mrt
    scene = mrt.scenes.cornell_box(aspect=1.0)
    frame, stats = mrt.render(scene, 500, 500, spp=64)      # on the GPU

    step = mrt.make_train_step(width=500, height=500, max_bounces=32,
                               spp_step=128)
    params = mrt.extract_params(scene)
    params, loss, grads = step(params, scene, target, sample0=0, lr=0.5)
"""

__version__ = "0.1.0"

from miniraytracer_tpu_torch.scene.types import SceneData, Camera  # noqa: F401
from miniraytracer_tpu_torch.scene.builder import SceneBuilder  # noqa: F401
from miniraytracer_tpu_torch.models import scenes  # noqa: F401
from miniraytracer_tpu_torch.models.integrator import (  # noqa: F401
    render_auto as render,
    pick_renderer,
)
from miniraytracer_tpu_torch.parallel.train import (  # noqa: F401
    TrainParams,
    apply_params,
    extract_params,
    make_train_step,
    params_from_numpy,
)
