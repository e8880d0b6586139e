"""The (dp, sp) device mesh over `torch.distributed`.

Port of `miniraytracer_tpu/parallel/mesh.py`. The renderer's two parallel
axes are the JAX package's:
- `dp`: pixels split over the ranks (the reference's tile scheduler axis,
  work_queue.cpp:133-149);
- `sp`: samples split over the ranks (the reference's per-sample passes,
  work_queue.cpp:158-175).

One process drives one device. Rank r is cell (r // n_sp, r % n_sp) of the
grid, as JAX's row-major device grid. The scene is replicated on every rank;
the only traffic is `all_reduce` sums over the sp group (the ranks of one dp
index), the dp group (the ranks of one sp index) or the world. No other
collective is used: gloo documents `all_reduce` and `barrier` on CUDA
tensors, which is how several ranks share one card (NCCL refuses two ranks
on one GPU).

With no process group initialized, `make_mesh()` is the trivial (1, 1) mesh,
whose sums are identities.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

from miniraytracer_tpu_torch.utils.device import resolve


def auto_mesh_shape(n_devices: int) -> tuple[int, int]:
    """Factor n_devices into (dp, sp) with sp in {1, 2}: pixels dominate."""
    if n_devices % 2 == 0 and n_devices > 2:
        return n_devices // 2, 2
    return n_devices, 1


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's cell of the (n_dp, n_sp) grid and its process groups.
    `distributed` False is the trivial mesh of one process with no group."""

    n_dp: int
    n_sp: int
    dp_index: int
    sp_index: int
    device: torch.device
    distributed: bool = False
    sp_group: object = None  # the ranks of this dp index
    dp_group: object = None  # the ranks of this sp index

    @property
    def shape(self) -> dict:
        return {"dp": self.n_dp, "sp": self.n_sp}

    @property
    def size(self) -> int:
        return self.n_dp * self.n_sp

    def all_reduce(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum `t` in place over `axis` ("sp", "dp" or "world") and return it.
        A failed collective raises."""
        if axis not in ("sp", "dp", "world"):
            raise ValueError(f"axis must be 'sp', 'dp' or 'world', got {axis!r}")
        if self.distributed:
            group = {"sp": self.sp_group, "dp": self.dp_group, "world": None}[axis]
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        return t


class _SpSum(torch.autograd.Function):
    """Sum over the sp group whose backward passes each rank's gradient
    through unchanged: every rank of a dp row computes the same loss of the
    summed value, and the gradient all-reduce after the backward adds the
    ranks' shares once. (An `all_reduce` backward would count the row's loss
    n_sp times.)"""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce(x.contiguous().clone(), "sp")

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def sp_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """`x` summed over the mesh's sp group, differentiable (see `_SpSum`)."""
    return _SpSum.apply(x, mesh)


def _mesh_device(device) -> torch.device:
    """`device` resolved; None means `cuda:LOCAL_RANK` (0 without a launcher),
    and a CUDA device without an index gets the current one."""
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    dev = resolve(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_dp: int | None = None, n_sp: int = 1, *, device=None) -> Mesh:
    """The (n_dp, n_sp) mesh over the initialized process group, whose world
    it must span (n_dp None: world // n_sp). Every rank must call it: it
    makes every sp and dp group. With no group initialized, the trivial
    (1, 1) mesh. `device` as in `init_distributed`."""
    dev = _mesh_device(device)
    if not (dist.is_available() and dist.is_initialized()):
        if (n_dp or 1) * n_sp != 1:
            raise ValueError(f"a ({n_dp}, {n_sp}) mesh needs an initialized process group "
                             "(init_distributed, or a launcher such as torchrun)")
        return Mesh(1, 1, 0, 0, dev)
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_dp is None:
        n_dp = world // n_sp
    if n_dp * n_sp != world or min(n_dp, n_sp) < 1:
        raise ValueError(f"a ({n_dp}, {n_sp}) mesh does not span the world of {world} ranks")
    sp_groups = [dist.new_group([d * n_sp + s for s in range(n_sp)]) for d in range(n_dp)]
    dp_groups = [dist.new_group([d * n_sp + s for d in range(n_dp)]) for s in range(n_sp)]
    dp, sp = divmod(rank, n_sp)
    return Mesh(n_dp, n_sp, dp, sp, dev, True, sp_groups[dp], dp_groups[sp])


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, *, backend: str | None = None,
                     device=None, timeout: float | None = None) -> Mesh:
    """Join the process group and return the (dp, sp) mesh of
    `auto_mesh_shape(world)`.

    With `coordinator` ("host:port") the group meets at tcp://coordinator,
    and `num_processes` and `process_id` are required; without it, at
    env:// (MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK, as torchrun sets
    them). `device` None means cuda:LOCAL_RANK, and raises without a card.
    `backend` None means NCCL for a CUDA device and gloo for the CPU; gloo
    on a CUDA device is allowed (several ranks on one card). `timeout`,
    in seconds, bounds every collective. A failed init raises."""
    dev = _mesh_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and process_id")
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id, **kw)
    else:
        dist.init_process_group(backend, init_method="env://", **kw)
    return make_mesh(*auto_mesh_shape(dist.get_world_size()), device=dev)
