"""Process groups for data-parallel training: one process a device.

Counterpart of ``segtpu/core/mesh.py``. segtpu builds one mesh over every
visible chip and shards the batch over its ``data`` axis; XLA then inserts
the all-reduces of the gradient and of BatchNorm's statistics. Here each
device is a process of a ``torch.distributed`` group (NCCL on the card,
gloo on the CPU), and the collectives are written out:

* the gradient's, by ``DistributedDataParallel`` (``core/state.py``);
* BatchNorm's, by ``GlobalBatchNorm2d`` (``nn/layers.py``);
* the losses' sums and denominators (``losses.py``) and the seg stats
  (``metrics.py``), through :func:`global_sums`.

A host-side gloo group (:func:`control_group`) carries the trainer's own
agreements (the SIGTERM flag, the run directory, the generators' states),
so that they never wait on the card.

Outside a process group every helper is the identity and
:func:`world_size` is 1: a one-device run creates no group and takes
exactly the path it took before the port had any of this.

Ranks follow torchrun's environment: ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``. A node is a segtpu host: the local
ranks of a node split its batch (:func:`local_rows`), and nodes shard each
epoch as segtpu's hosts do (``data/base.py``). :func:`launch` starts one
process a device and joins them; :func:`init_from_env` joins a group that
torchrun started.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

_control = None  # the host-side gloo group of an NCCL run


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """Ranks of the default group; 1 outside a group."""
    return dist.get_world_size() if initialized() else 1


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def is_main() -> bool:
    """Rank 0, the one that writes the run's files."""
    return rank() == 0


def local_world_size() -> int:
    """Ranks on this node: ``LOCAL_WORLD_SIZE``, else every rank."""
    if not initialized():
        return 1
    return int(os.environ.get("LOCAL_WORLD_SIZE", world_size()))


def local_rank() -> int:
    if not initialized():
        return 0
    return int(os.environ.get("LOCAL_RANK", rank()))


def init(backend: str, rank_: int, world: int, init_method: str,
         timeout: Optional[float] = None) -> None:
    """Join the default group, and, where it is NCCL's, a gloo group for
    the host-side agreements. ``timeout`` in seconds (torch's default when
    None)."""
    global _control
    kwargs = {}
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend, init_method=init_method, rank=rank_,
                            world_size=world, **kwargs)
    _control = dist.new_group(backend="gloo", **kwargs) if backend != "gloo" else None


def shutdown() -> None:
    global _control
    if initialized():
        dist.destroy_process_group()
    _control = None


def control_group():
    """The group of the host-side collectives: the default group where it is
    gloo, else the gloo group made beside it."""
    global _control
    if _control is None and dist.get_backend() != "gloo":
        _control = dist.new_group(backend="gloo")  # collective: every rank
    return _control


def default_backend(device_type: str) -> str:
    """NCCL on the card, gloo on the CPU. A card without NCCL raises: the
    port never falls back to gloo on its own."""
    if device_type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("segtpu_torch: data-parallel training on cuda needs "
                               "NCCL, which this torch lacks")
        return "nccl"
    return "gloo"


def init_from_env(device_type: str, timeout: Optional[float] = None) -> None:
    """Join the group torchrun started (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``)."""
    init(default_backend(device_type), int(os.environ["RANK"]),
         int(os.environ["WORLD_SIZE"]), "env://", timeout)


def local_rows(batch_size: int) -> Tuple[int, int]:
    """Rows ``[lo, hi)`` of each node batch that this local rank takes.
    Raises when the node's ranks cannot split the batch evenly, as
    segtpu's sharded ``device_put`` fails there."""
    n = local_world_size()
    if batch_size % n:
        raise ValueError(f"batch_size {batch_size} does not split over the node's "
                         f"{n} devices: make it a multiple of {n}")
    per = batch_size // n
    return local_rank() * per, (local_rank() + 1) * per


# -- collectives ------------------------------------------------------------------

class _GlobalSum(torch.autograd.Function):
    """Forward: the sum over the ranks. Backward: the identity. Every rank
    computes the same function of the sum, so the gradient of its local
    term is the gradient of the sum; summed over the ranks (the data
    parallel wrap's mean, times the world size) it is the gradient of the
    global function."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks, with the local term's gradient (see
    :class:`_GlobalSum`); ``x`` itself outside a group."""
    if not initialized():
        return x
    return _GlobalSum.apply(x)


def global_sums(*terms: torch.Tensor):
    """Each of ``terms`` summed over the ranks, in one collective, as
    :func:`global_sum`; the terms themselves outside a group."""
    if not initialized():
        return terms
    flat = global_sum(torch.cat([t.reshape(-1) for t in terms]))
    return tuple(part.view(t.shape) for part, t in zip(
        flat.split([t.numel() for t in terms]), terms))


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` stacked on a new first axis, in rank order, with
    the gradient of this rank's slot. Built on an all-reduce of a buffer
    that is zero outside this rank's slot, so it goes through
    :func:`global_sum`; every rank's ``x`` must have one shape."""
    if not initialized():
        return x.unsqueeze(0)
    r, n = rank(), world_size()
    zeros = x.new_zeros((1,) + tuple(x.shape))
    slots = [zeros.expand(r, *x.shape), x.unsqueeze(0),
             zeros.expand(n - r - 1, *x.shape)]
    return global_sum(torch.cat(slots))


def agree_any(flag: bool) -> bool:
    """True on every rank when it is true on any (a max over the host-side
    group); ``flag`` itself outside a group."""
    if not initialized():
        return flag
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=control_group())
    return bool(t.item())


def broadcast_object(obj):
    """Rank 0's ``obj`` on every rank (picklable)."""
    if not initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=control_group())
    return box[0]


def gather_objects(obj) -> List:
    """Every rank's ``obj``, in rank order, on every rank."""
    if not initialized():
        return [obj]
    out = [None] * world_size()
    dist.all_gather_object(out, obj, group=control_group())
    return out


def barrier() -> None:
    if initialized():
        dist.barrier(group=control_group())


# -- processes --------------------------------------------------------------------

def free_port() -> int:
    """A free TCP port on localhost for the group's rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(index: int, fn: Callable, args: tuple, devices: Sequence[str],
            backend: str, port: int, timeout: Optional[float]) -> None:
    os.environ.update(RANK=str(index), WORLD_SIZE=str(len(devices)),
                      LOCAL_RANK=str(index), LOCAL_WORLD_SIZE=str(len(devices)),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    init(backend, index, len(devices), f"tcp://127.0.0.1:{port}", timeout)
    try:
        fn(devices[index], *args)
    finally:
        shutdown()


def launch(fn: Callable, args: tuple, devices: Sequence[str],
           backend: Optional[str] = None, timeout: Optional[float] = None) -> None:
    """Run ``fn(device, *args)`` in one spawned process for each entry of
    ``devices`` ("cpu" or "cuda:<index>"), all joined in one group on this
    node, rank i on ``devices[i]``; returns when every process has ended,
    and raises the first failure. ``backend`` is NCCL on the card and gloo
    on the CPU unless the caller names another: gloo on the card is taken
    only when named (two ranks on one card, which NCCL refuses)."""
    types = {torch.device(d).type for d in devices}
    if len(types) != 1:
        raise ValueError(f"devices of one kind, got {list(devices)}")
    backend = backend or default_backend(types.pop())
    import torch.multiprocessing as mp

    mp.start_processes(_worker, args=(fn, args, list(devices), backend, free_port(),
                                      timeout),
                       nprocs=len(devices), join=True, start_method="spawn")
