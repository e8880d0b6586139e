"""Device-parallel layer: the (dp, sp) mesh over `torch.distributed`, sharded
rendering and the train step on a mesh.

Port of `miniraytracer_tpu/parallel/`: one process a device in place of
`shard_map` over a `jax.sharding.Mesh`. Pixels are split over the `dp` axis
and samples over the `sp` axis; the scene is replicated on every rank, and
the ranks sum colours, counts, rays, the loss and the gradients with
`all_reduce`.
"""

from miniraytracer_tpu_torch.parallel.mesh import (  # noqa: F401
    auto_mesh_shape, init_distributed, make_mesh,
)
from miniraytracer_tpu_torch.parallel.render import (  # noqa: F401
    make_frame,
    render_distributed,
    render_pass_sharded,
    render_wavefront_distributed,
    render_workqueue_distributed,
)
from miniraytracer_tpu_torch.parallel.train import (  # noqa: F401
    TrainParams,
    apply_params,
    extract_params,
    make_train_step,
)
