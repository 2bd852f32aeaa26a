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

FSDP (``parallel.fsdp`` of the YAML, the short trainer only, as in the
JAX package's ``sharding.py``): :func:`fully_sharded` shards every
parameter, and with it its grad and AdamW moments, over the ranks
(``fully_shard``, ZeRO-3); each unit is all-gathered for its forward and
backward, and the grads are reduce-scattered. The arithmetic of each
kernel is unchanged: every rank still computes on whole weights and on
its rows. Checkpoints hold the full state (:func:`full_state`), as one
process writes it.

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
           "add_multi_host_flag", "shutdown_distributed", "world",
           "is_primary", "default_shard", "barrier", "all_reduce_mean",
           "all_reduce_min", "broadcast_object", "data_parallel",
           "fsdp_units", "fully_sharded", "is_sharded", "gather_whole",
           "full_state", "load_sharded_optimizer"]

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


def add_multi_host_flag(parser) -> None:
    """The ``--multi_host`` flag of the entry points that join a
    torchrun / SLURM launch's process group (:func:`init_distributed`)."""
    parser.add_argument("--multi_host", action="store_true",
                        help="join the process group of a torchrun / SLURM "
                             "launch (one process per card); raises "
                             "without a rendezvous")


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


def broadcast_object(obj, src: int = 0):
    """The first rank's (``src``'s) picklable ``obj`` on every rank;
    ``obj`` itself with one process."""
    if world()[1] == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


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


def fsdp_units(model: torch.nn.Module) -> list[torch.nn.Module]:
    """The modules :func:`fully_sharded` shards as units of their own,
    before the root: each PVT block, each GMFlow transformer block (the
    frozen GMFlow is sharded as the JAX package shards it), the decoder
    and the injectors."""
    from emip_tpu_torch.models.common import NeighborConnectionDecoder
    from emip_tpu_torch.models.gmflow.transformer import TransformerBlock
    from emip_tpu_torch.models.prompt import Injector
    from emip_tpu_torch.models.pvt_v2 import PVTBlock

    kinds = (PVTBlock, TransformerBlock, NeighborConnectionDecoder, Injector)
    return [m for m in model.modules() if isinstance(m, kinds)]


def fully_sharded(model: torch.nn.Module) -> torch.nn.Module:
    """``model`` sharded over the ranks of the process group with
    ``fully_shard`` (FSDP2): unit by unit (:func:`fsdp_units`), then the
    root, which takes the remaining parameters. ``model`` itself with one
    rank.

    Parameters stay fp32 (no ``MixedPrecisionPolicy``): the bf16 band
    casts at use (:func:`emip_tpu_torch.dtypes.cast`) as in one process.
    Frozen parameters must be frozen before the call; the optimizer is
    built after it, on the sharded parameters. A parameter that takes no
    grad in a step (the dead modules) keeps ``grad`` None, as in one
    process. The returned module is ``model``, changed in place; every
    rank must run each of its forwards (each unit is all-gathered)."""
    size = world()[1]
    if size == 1:
        return model
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.fsdp import fully_shard

    device = next(model.parameters()).device
    mesh = init_device_mesh(device.type, (size,))
    for unit in fsdp_units(model):
        fully_shard(unit, mesh=mesh)
    fully_shard(model, mesh=mesh)
    return model


def is_sharded(model: torch.nn.Module) -> bool:
    """True for a model that :func:`fully_sharded` sharded."""
    from torch.distributed.fsdp import FSDPModule

    return isinstance(model, FSDPModule)


def gather_whole(t):
    """A tensor that :func:`fully_sharded` holds in shards (a DTensor on
    dim 0) gathered whole on every rank, else ``t`` itself. A collective:
    every rank makes the call. It pads each shard to one length and runs
    ``all_gather_into_tensor``, which gloo carries on CUDA tensors
    (``DTensor.full_tensor``'s functional collective crashes there)."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(t, DTensor):
        return t
    if tuple(t.placements) != (Shard(0),):
        raise ValueError(f"gather_whole: placements {t.placements}, not the "
                         f"dim-0 shards fully_sharded makes")
    group, count = t.device_mesh.get_group(), t.device_mesh.size()
    local = t.to_local().detach()
    rows = -(-t.shape[0] // count)
    padded = local.new_zeros((rows,) + tuple(t.shape[1:]))
    padded[:local.shape[0]] = local
    out = local.new_empty((rows * count,) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(out, padded, group=group)
    return out[:t.shape[0]]


def _whole_on_cpu(value):
    value = gather_whole(value)
    return value.cpu() if isinstance(value, torch.Tensor) else value


def full_state(model: torch.nn.Module, opt: torch.optim.Optimizer
               ) -> tuple[dict, dict]:
    """(model state dict, optimizer state dict) of a sharded ``model`` and
    its optimizer as one process holds them: each sharded tensor
    all-gathered whole (a collective: every rank makes the call, in the
    same order) and moved to the CPU. The optimizer's dict keeps its
    integer keys, which follow the parameters' order in ``opt`` as in
    one process, so a checkpoint of either loads into the other."""
    sd = {k: _whole_on_cpu(v) for k, v in model.state_dict().items()}
    osd = opt.state_dict()
    osd["state"] = {i: {k: _whole_on_cpu(v) for k, v in st.items()}
                    for i, st in osd["state"].items()}
    return sd, osd


def _shard_like(p, whole: torch.Tensor):
    """This rank's dim-0 chunk of ``whole`` (a tensor of ``p``'s shape,
    present on every rank) as a DTensor placed like the sharded ``p``; no
    communication."""
    from torch.distributed.tensor import DTensor

    chunks = torch.chunk(whole.to(p.device), p.device_mesh.size(), dim=0)
    rank = p.device_mesh.get_local_rank()
    local = (chunks[rank] if rank < len(chunks)
             else whole.new_empty((0,) + tuple(whole.shape[1:])))
    if local.shape != p.to_local().shape:
        raise RuntimeError(f"shard of {tuple(whole.shape)}: "
                           f"{tuple(local.shape)} where the parameter holds "
                           f"{tuple(p.to_local().shape)}")
    return DTensor.from_local(local.contiguous(), p.device_mesh, p.placements,
                              run_check=False, shape=p.shape,
                              stride=p.stride())


def load_sharded_optimizer(opt: torch.optim.Optimizer, osd: dict) -> None:
    """Load a one-process optimizer state dict (``osd``, whole tensors on
    every rank) into ``opt`` over sharded parameters: each moment is cut
    to its parameter's shard."""
    from torch.distributed.tensor import DTensor

    params = [p for g in opt.param_groups for p in g["params"]]
    state = {}
    for i, st in osd["state"].items():
        p = params[int(i)]
        state[i] = {k: (_shard_like(p, v) if isinstance(p, DTensor)
                        and isinstance(v, torch.Tensor)
                        and v.shape == p.shape else v)
                    for k, v in st.items()}
    opt.load_state_dict(dict(osd, state=state))
