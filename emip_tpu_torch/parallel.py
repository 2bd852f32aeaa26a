"""Data parallelism over processes, one process per card.

Counterpart of the ``data`` axis of :mod:`emip_tpu.parallel.mesh` and of
the reference's DDP over NCCL (its ``train.py``): each process trains on
its own shard of the epoch (:func:`emip_tpu_torch.data.shard_order`, the
``DistributedSampler`` rule) at the config's ``batch_size``, so the
global batch is ``world x batch_size``, as in the JAX package's
multi-process runs (``shard_batch(process_local=True)``). The trainable
model is wrapped in ``DistributedDataParallel``, whose all-reduce averages
the grads before the clamp and AdamW, as JAX clamps the global grads.

Where JAX computes over the global batch inside ``jit``, the port reduces
across ranks with gradient (:func:`all_reduce_mean`): the BatchNorm
statistics (:class:`emip_tpu_torch.dtypes.BatchNorm2d`), the photometric
loss's occlusion normaliser (:mod:`emip_tpu_torch.losses.flow`) and the
drop-path draw (:func:`emip_tpu_torch.models.pvt_v2.drop_path`), so that a
step on W ranks is the one-process step on the concatenated batch. With
one process nothing of this runs and every result keeps its bits.

Launch with ``torchrun --nproc_per_node N -m emip_tpu_torch.train
--multi_host ...``; each rank takes ``cuda:LOCAL_RANK``.
"""

from __future__ import annotations

import dataclasses
import logging
import os

import torch
import torch.distributed as dist

__all__ = ["distributed_env", "Rendezvous", "rendezvous", "init_distributed",
           "shutdown_distributed", "world", "is_primary", "default_shard",
           "barrier", "all_reduce_mean", "all_reduce_min", "data_parallel"]

log = logging.getLogger("emip_tpu_torch")


def distributed_env(environ=None) -> bool:
    """True when the environment says the launch is multi-process: a
    coordinator address, ``SLURM_NTASKS`` > 1 or ``WORLD_SIZE`` > 1 (the
    rules of the JAX package's ``mesh._distributed_env``)."""
    env = os.environ if environ is None else environ
    if env.get("JAX_COORDINATOR_ADDRESS") or env.get("COORDINATOR_ADDRESS"):
        return True
    if int(env.get("SLURM_NTASKS") or 1) > 1:
        return True
    return int(env.get("WORLD_SIZE") or 1) > 1


@dataclasses.dataclass(frozen=True)
class Rendezvous:
    init_method: str  # tcp://host:port
    world_size: int
    rank: int
    local_rank: int


def rendezvous(environ=None) -> Rendezvous:
    """The process group's rendezvous from the environment: torchrun's
    ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK`` /
    ``LOCAL_RANK``, or SLURM's ``SLURM_NTASKS`` / ``SLURM_PROCID`` /
    ``SLURM_LOCALID`` with ``COORDINATOR_ADDRESS`` (or
    ``JAX_COORDINATOR_ADDRESS``, ``host:port``) or ``MASTER_ADDR`` /
    ``MASTER_PORT`` for the address. Raises ``RuntimeError`` when any part
    is missing."""
    env = os.environ if environ is None else environ

    def first(*names):
        return next((env[n] for n in names if env.get(n)), None)

    address = first("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS")
    if address is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    world_size = first("WORLD_SIZE", "SLURM_NTASKS")
    rank = first("RANK", "SLURM_PROCID")
    local_rank = first("LOCAL_RANK", "SLURM_LOCALID") or "0"
    missing = [name for name, v in (("address", address),
                                    ("world size", world_size),
                                    ("rank", rank)) if v is None]
    if missing:
        raise RuntimeError(
            f"no rendezvous for a multi-process run: the environment lacks "
            f"the {', '.join(missing)} (launch with torchrun, or set "
            f"MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK)")
    return Rendezvous(f"tcp://{address}", int(world_size), int(rank),
                      int(local_rank))


def init_distributed(device: torch.device | str = "cuda",
                     backend: str | None = None,
                     multi_host: bool = False) -> torch.device:
    """Join the process group the environment describes; returns this
    rank's device (``cuda:LOCAL_RANK`` for a CUDA ``device``).

    A no-op in a plain single-process run (it returns ``device``, resolved
    by :func:`emip_tpu_torch.device.resolve_device`). When the environment
    says multi-process (:func:`distributed_env`), or ``multi_host`` asks
    for the group whatever the world size, the rendezvous must be complete
    and the group must form: anything else raises, never N independent
    runs. ``backend`` defaults to NCCL for a CUDA device and gloo for the
    CPU."""
    from emip_tpu_torch.device import resolve_device

    if dist.is_initialized():
        raise RuntimeError("init_distributed: the process group is already "
                           "initialised")
    if not (multi_host or distributed_env()):
        return resolve_device(device)
    rv = rendezvous()
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", rv.local_rank)
        resolve_device(device)
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=rv.init_method,
                            world_size=rv.world_size, rank=rv.rank)
    log.info("joined the process group: rank %d of %d over %s on %s",
             rv.rank, rv.world_size, backend, device)
    return device


def shutdown_distributed() -> None:
    """Leave the process group, where one was joined."""
    if dist.is_initialized():
        dist.destroy_process_group()


def world() -> tuple[int, int]:
    """(rank, world size) of the active process group; (0, 1) without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_primary() -> bool:
    """True on the rank that writes logs, scalars and checkpoints."""
    return world()[0] == 0


def default_shard() -> tuple[int, int] | None:
    """(rank, world size) in a multi-process run, else None: the loaders'
    ``shard``."""
    rank, size = world()
    return (rank, size) if size > 1 else None


def barrier() -> None:
    """Wait for every rank (a no-op with one process)."""
    if world()[1] > 1:
        dist.barrier()


def all_reduce_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the ranks, with gradient: the backward hands
    each rank the mean of the ranks' grads, so that with DDP's averaging
    each parameter gets the grad of the mean of the ranks' losses. A
    collective: every rank must make the call. ``x`` itself with one
    process."""
    size = world()[1]
    if size == 1:
        return x
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(x) / size


def all_reduce_min(value: int) -> int:
    """The smallest ``value`` over the ranks (host integers)."""
    if world()[1] == 1:
        return value
    t = torch.tensor([value], dtype=torch.int64)
    if dist.get_backend() == "nccl":
        t = t.cuda()
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return int(t.item())


def data_parallel(model: torch.nn.Module) -> torch.nn.Module:
    """``model`` in ``DistributedDataParallel`` when the world has more
    than one rank, else ``model`` itself.

    ``static_graph``: every step runs the same graph, and the parameters
    that take no grad (the dead-but-checkpointed modules, ``dr2_new``, ...)
    are the same ones at every step; DDP learns that set in the first step
    instead of walking the autograd graph at every step, as
    ``find_unused_parameters`` would. ``broadcast_buffers`` is off: the
    BatchNorm statistics come from the whole batch on every rank, so the
    buffers stay equal without it. Frozen parameters (GMFlow, the long
    model's short-term net) must be frozen before the call."""
    if world()[1] == 1:
        return model
    from torch.nn.parallel import DistributedDataParallel

    return DistributedDataParallel(model, broadcast_buffers=False,
                                   static_graph=True)
