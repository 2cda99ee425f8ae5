"""Process groups and the (env x model) device mesh of the port.

Port of ``gobblet_rl_tpu/parallel/mesh.py``.  JAX runs one program over a
mesh and hands device ``r`` block ``r`` of each sharded array; here every
rank is its own OS process over ``torch.distributed`` (NCCL on the card,
gloo on the CPU) and holds only its own block:

* ``ENV_AXIS``: data parallelism.  Each rank owns a contiguous block of
  the env batch (the trailing axis of every lane-major ``PlanesState``
  leaf) and of the replay ring, and averages gradients over the env group
  with :class:`GradSync`, the counterpart of ``jax.lax.pmean``.
* ``MODEL_AXIS``: tensor parallelism (``parallel/tensor_parallel.py``).

Multi-process entry: every rank calls :func:`init_distributed` once before
it builds a mesh (``parallel/multihost.py`` runs whole training processes).
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from gobblet_rl_torch.device import resolve_device

ENV_AXIS = "env"
MODEL_AXIS = "model"
# rank r's generator is seeded with seed + r * RANK_SEED_STRIDE; odd, so the
# low 32 bits (all the CPU generator reads) differ between ranks
RANK_SEED_STRIDE = 1_000_003


def init_distributed(coordinator_address=None, num_processes=None, process_id=None, *,
                     backend=None, device=None) -> torch.device | None:
    """Join the process group (a no-op without a coordinator).

    ``coordinator_address`` is ``host:port`` (a TCP store on the rank-0
    process) or a ``file://`` path; ``num_processes`` is the world size
    (one rank per device) and ``process_id`` this rank.  ``device=None``
    means the CUDA card; ``backend=None`` means NCCL for a CUDA device and
    gloo for the CPU.  A CUDA rank binds to card ``LOCAL_RANK`` modulo the
    card count.  Returns the rank's device."""
    if coordinator_address is None:
        return None
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id)
    return dev


def make_mesh(num_devices: int | None = None, model_parallel: int = 1, *, device=None):
    """The (env x model) ``DeviceMesh`` over every rank of the process group,
    of shape ``(n // model_parallel, model_parallel)``; ranks are laid out
    row-major, so the ranks of one model group are adjacent.
    ``num_devices``, if given, must be the world size (one rank per
    device).  ``device=None`` means the CUDA card."""
    from torch.distributed.device_mesh import DeviceMesh

    n = dist.get_world_size()
    if num_devices is not None and num_devices != n:
        raise ValueError(f"a mesh spans the whole process group: {num_devices} devices "
                         f"asked of a world of {n}")
    assert n % model_parallel == 0, (n, model_parallel)
    grid = torch.arange(n).reshape(n // model_parallel, model_parallel)
    return DeviceMesh(resolve_device(device).type, grid, mesh_dim_names=(ENV_AXIS, MODEL_AXIS))


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis`` (``jax.lax.axis_index``)."""
    return mesh.get_local_rank(axis)


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where an array lives on a mesh, as a ``NamedSharding``: ``spec[i]``
    names the mesh axis that dim ``i`` is split over (``None``: whole);
    missing trailing entries are whole, and an empty spec is replicated."""

    mesh: object
    spec: tuple


def env_sharding(mesh) -> Placement:
    """Lane-major env arrays shard their trailing batch axis over ENV_AXIS
    (the placement of a [B] leaf)."""
    return Placement(mesh, (ENV_AXIS,))


def replicated(mesh) -> Placement:
    return Placement(mesh, ())


def planes_spec(x: torch.Tensor) -> tuple:
    """A lane-major leaf's spec: its trailing (batch) axis over ENV_AXIS."""
    return (None,) * (x.dim() - 1) + (ENV_AXIS,)


def local_block(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of ``x`` under ``spec``: along each dim named for
    a mesh axis, contiguous block ``axis_index`` of ``axis_size``, as JAX
    device ``r`` holds it; a copy, so the whole array can be freed."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n, r = axis_size(mesh, axis), axis_index(mesh, axis)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide by {n}")
        k = x.shape[dim] // n
        x = x.narrow(dim, r * k, k)
    return x.clone(memory_format=torch.contiguous_format)


def shard_env_state(state, mesh):
    """This rank's block of a lane-major ``PlanesState``: the batch (last)
    axis of every leaf split over the env axis of the mesh."""
    return type(state)(*(local_block(x, planes_spec(x), mesh) for x in state))


def rank_generator(seed: int, rank: int, device) -> torch.Generator:
    """Rank ``rank``'s own generator on ``device``, seeded with ``seed + rank
    * 1,000,003`` (JAX folds the replicated key with ``axis_index``): rank 0
    draws what an unsharded run seeded with ``seed`` draws, and distinct
    ranks get distinct seeds, also modulo 2**32."""
    generator = torch.Generator(device=device)
    generator.manual_seed(seed + rank * RANK_SEED_STRIDE)
    return generator


class GradSync:
    """What ``jax.lax.pmean(grads, ENV_AXIS)`` does, in place: the gradients
    of ``params`` (and any extra scalars) flattened into one bucket, one
    ``all_reduce(SUM)`` over ``group``, divided by its size and copied back.
    SUM then divide, because gloo has no ``ReduceOp.AVG``.  One collective
    a call, sized like the parameters; ``group=None`` is the whole world."""

    def __init__(self, group=None):
        self.group = group
        self.size = dist.get_world_size(group)

    def __call__(self, params, *scalars: torch.Tensor) -> tuple:
        params = list(params)
        for p in params:
            if p.grad is None:   # an unused parameter still joins the bucket
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        dtype = grads[0].dtype
        bucket = torch.cat([g.reshape(-1) for g in grads]
                           + [s.detach().reshape(1).to(dtype) for s in scalars])
        dist.all_reduce(bucket, op=dist.ReduceOp.SUM, group=self.group)
        bucket /= self.size
        offset = 0
        for g in grads:
            g.copy_(bucket[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
        return tuple(bucket[offset:].unbind())

    def sum(self, *values: torch.Tensor) -> tuple:
        """The sum over the group of each float32 scalar, in one collective."""
        bucket = torch.stack([v.detach().to(torch.float32).reshape(()) for v in values])
        dist.all_reduce(bucket, op=dist.ReduceOp.SUM, group=self.group)
        return tuple(bucket.unbind())
