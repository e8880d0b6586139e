"""miniraytracer_tpu_torch — the PyTorch/CUDA port of miniraytracer_tpu.

The forward path tracer for the fused scene class (cornell_box,
cornell_smoke, two_spheres, perlin_spheres) runs where the scene's tensors
live: through the hand-written CUDA kernel `csrc/bounce.cu` on an NVIDIA GPU
(built with nvcc on first use), through the plain PyTorch version on the CPU.

Quick start:

    import miniraytracer_tpu_torch as mrt
    scene = mrt.scenes.cornell_box(aspect=1.0).to("cuda")
    frame, stats = mrt.render(scene, 500, 500, spp=64)
"""

__version__ = "0.1.0"

from miniraytracer_tpu_torch.scene.types import SceneData, Camera  # noqa: F401
from miniraytracer_tpu_torch.scene.builder import SceneBuilder  # noqa: F401
from miniraytracer_tpu_torch.models import scenes  # noqa: F401
from miniraytracer_tpu_torch.models.integrator import (  # noqa: F401
    render_auto as render,
    pick_renderer,
)
