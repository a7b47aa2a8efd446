"""Process groups for data-parallel and model-parallel training: one
process a device.

Counterpart of ``segtpu/core/mesh.py``. segtpu builds one mesh over every
visible chip, of shape ``(data, model)``, and shards the batch over its
``data`` axis; XLA then inserts the all-reduces of the gradient and of
BatchNorm's statistics. Here each device is a process of a
``torch.distributed`` group (NCCL on the card, gloo on the CPU), and the
collectives are written out:

* the gradient's, by ``DistributedDataParallel`` (``core/state.py``), or,
  with a model axis, by ``TrainState.sync_gradients``;
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
data ranks of a node split its batch (:func:`local_rows`), and nodes shard
each epoch as segtpu's hosts do (``data/base.py``). :func:`launch` starts
one process a device and joins them; :func:`init_from_env` joins a group
that torchrun started.

The model axis (:func:`set_model_axis`, segtpu's ``trainer.model_parallel``
and ``trainer.spatial``): rank r sits at data index ``r // model_parallel``
and model index ``r % model_parallel``, the order of segtpu's
``np.array(devices).reshape(n // mp, mp)``. The model group of a rank is
the ranks of its data index, its data group the ranks of its model index.
Tensor parallelism (``core/tensor_parallel.py``) shards conv weights over
the model group, whose ranks hold the same rows of the batch; spatial
sharding (``core/spatial.py``) splits each image's H over the model group.
Each collective runs over the axis below; getting one wrong is silent:

=========================  ==========================  ===========================
collective                 TP (model ranks hold the    spatial (model ranks hold
                           same rows)                  different rows of the same
                                                       images)
=========================  ==========================  ===========================
gradient sum               data group for sharded      data group for sharded
(``sync_gradients``)       parameters; the world's     parameters (after the
                           mean over the model axis    weight gather's sum over
                           for replicated ones (equal  the model group), world
                           terms: their value)         for replicated ones
``GlobalBatchNorm2d``      data group                  world; data group for a BN
                                                       on replicated maps (the
                                                       PSP bins)
loss sums, seg stats       data group                  world
(:func:`pixel_group`)
per-image losses           data group                  each image's pixels
(:func:`image_group`)                                  gathered over its model
                                                       group first, then the
                                                       data group
dropout seed               one a data index: model     one a data index, each
                           ranks draw the same mask    rank's mask over its rows
loader shards              model ranks of a data       the same, then each keeps
                           index load the same rows    its H rows
=========================  ==========================  ===========================

Without a model axis every group is the world (``None``), and the data
parallel path is the one it was.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

_control = None  # the host-side gloo group of an NCCL run
_axes = None  # the model axis: an _Axes, or None without one


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
    global _control, _axes
    if initialized():
        dist.destroy_process_group()
    _control = _axes = None


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
    """Rows ``[lo, hi)`` of each node batch that this local rank takes: the
    node's batch splits over its data ranks, and the model ranks of one data
    index take the same rows. Raises when the node's data ranks cannot split
    the batch evenly, as segtpu's sharded ``device_put`` fails there."""
    mp = model_size()
    if local_world_size() % mp:
        raise ValueError(f"the node's {local_world_size()} devices do not hold whole "
                         f"model groups of {mp}")
    n, index = local_world_size() // mp, local_rank() // mp
    if batch_size % n:
        raise ValueError(f"batch_size {batch_size} does not split over the node's "
                         f"{n} devices: make it a multiple of {n}")
    per = batch_size // n
    return index * per, (index + 1) * per


# -- the model axis ---------------------------------------------------------------

class _Axes(NamedTuple):
    model_parallel: int
    spatial: bool
    data_group: object   # the ranks of this rank's model index
    model_group: object  # the ranks of this rank's data index


def set_model_axis(model_parallel: int = 1, spatial: bool = False) -> None:
    """Lay the ranks out as segtpu's ``(data, model)`` mesh with a model axis
    of ``model_parallel`` (1: none), and create every data group and every
    model group, on every rank in one order (a collective). ``spatial``
    splits images over the model axis instead of holding them whole.
    Raises ``ValueError`` where segtpu does: a world size that
    ``model_parallel`` does not divide, or ``spatial`` on a model axis of
    1."""
    global _axes
    n = world_size()
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"trainer.model_parallel={model_parallel} does not divide "
                         f"the {n} device(s) of the mesh")
    if spatial and model_parallel == 1:
        raise ValueError(f"trainer.model_parallel={model_parallel}/spatial={spatial} "
                         f"need a mesh with a >1 'model' axis; got data {n}, model 1")
    if model_parallel == 1:
        _axes = None
    elif _axes is not None and _axes.model_parallel == model_parallel:
        _axes = _axes._replace(spatial=spatial)
    else:
        mp, r = model_parallel, rank()
        data_groups = [dist.new_group([d * mp + m for d in range(n // mp)])
                       for m in range(mp)]
        model_groups = [dist.new_group(list(range(d * mp, (d + 1) * mp)))
                        for d in range(n // mp)]
        _axes = _Axes(mp, spatial, data_groups[r % mp], model_groups[r // mp])


def model_size() -> int:
    """Ranks of the model axis; 1 without one."""
    return 1 if _axes is None else _axes.model_parallel


def data_size() -> int:
    """Ranks of the data axis: the world over the model axis."""
    return world_size() // model_size()


def model_index() -> int:
    return rank() % model_size()


def data_index() -> int:
    return rank() // model_size()


def spatial() -> bool:
    """Whether the model axis splits each image's H."""
    return _axes is not None and _axes.spatial


def data_group():
    """This rank's group along the data axis (the world without a model
    axis: ``None``)."""
    return None if _axes is None else _axes.data_group


def model_group():
    """This rank's group along the model axis (None without one)."""
    return None if _axes is None else _axes.model_group


def pixel_group():
    """The ranks whose pixels differ: the world, or under tensor
    parallelism alone the data group (its model ranks hold the same rows).
    Loss sums, seg stats and BatchNorm's statistics run over it."""
    return data_group() if not spatial() else None


def image_group():
    """The ranks whose images differ: the data group."""
    return data_group()


def group_size(group=None) -> int:
    return dist.get_world_size(group) if initialized() else 1


def group_rank(group=None) -> int:
    return dist.get_rank(group) if initialized() else 0


# -- collectives ------------------------------------------------------------------

class _GlobalSum(torch.autograd.Function):
    """Forward: the sum over the ranks of ``group``. Backward: the identity.
    Every rank computes the same function of the sum, so the gradient of its
    local term is the gradient of the sum; summed over the ranks (the data
    parallel wrap's mean, times the world size) it is the gradient of the
    global function."""

    @staticmethod
    def forward(ctx, x, group):
        out = _dense(x)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SumBothWays(torch.autograd.Function):
    """Forward and backward: the sum over the ranks of ``group``. For a
    replicated result whose ranks each hold a part of its gradient (the
    parts of the rows each rank owns): the gradient of every rank's term is
    the whole gradient of the sum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = _dense(x)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = _dense(grad)
        dist.all_reduce(out, group=ctx.group)
        return out, None


def _dense(x: torch.Tensor) -> torch.Tensor:
    """A row-major copy of ``x`` for an all-reduce: the collective sums the
    ranks' storage element by element, so a term whose strides differ
    between ranks (an einsum's output, a channels-last map) would be summed
    out of place."""
    return x.clone(memory_format=torch.contiguous_format)


def global_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` (the world by default),
    with the local term's gradient (see :class:`_GlobalSum`); ``x`` itself
    outside a group or over a group of one rank."""
    if not initialized() or (group is not None and group_size(group) == 1):
        return x
    return _GlobalSum.apply(x, group)


def sum_both_ways(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over ``group``, whose gradient is summed over
    ``group`` too (:class:`_SumBothWays`); ``x`` outside a group or over a
    group of one rank."""
    if not initialized() or (group is not None and group_size(group) == 1):
        return x
    return _SumBothWays.apply(x, group)


def global_sums(*terms: torch.Tensor, group=None):
    """Each of ``terms`` summed over the ranks of ``group``, in one
    collective, as :func:`global_sum`; the terms themselves outside a
    group."""
    if not initialized():
        return terms
    flat = global_sum(torch.cat([t.reshape(-1) for t in terms]), group)
    return tuple(part.view(t.shape) for part, t in zip(
        flat.split([t.numel() for t in terms]), terms))


def gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` stacked on a new first axis, in the order of the
    ranks of ``group`` (the world by default), with the gradient of this
    rank's slot. Built on an all-reduce of a buffer that is zero outside
    this rank's slot, so it goes through :func:`global_sum`; every rank's
    ``x`` must have one shape."""
    if not initialized():
        return x.unsqueeze(0)
    r, n = group_rank(group), group_size(group)
    zeros = x.new_zeros((1,) + tuple(x.shape))
    slots = [zeros.expand(r, *x.shape), x.unsqueeze(0),
             zeros.expand(n - r - 1, *x.shape)]
    return global_sum(torch.cat(slots), group)


def gather_cat(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in the order of the
    ranks of ``group``, the ranks' sizes along ``dim`` free (one all-reduce
    of the sizes first), with the gradient of this rank's part. Built on
    all-reduces of zero-padded buffers, as :func:`gather_rows`."""
    if not initialized():
        return x
    r, n = group_rank(group), group_size(group)
    sizes = torch.zeros(n, dtype=torch.int64, device=x.device)
    sizes[r] = x.shape[dim]
    dist.all_reduce(sizes, group=group)
    sizes = sizes.tolist()
    before, after = sum(sizes[:r]), sum(sizes[r + 1:])
    pad = [0, 0] * (x.dim() - 1 - dim % x.dim()) + [before, after]
    return global_sum(torch.nn.functional.pad(x, pad), group)


def broadcast_tensors(tensors: Sequence[torch.Tensor]) -> None:
    """Rank 0's values of ``tensors`` on every rank, in place: one
    all-reduce a dtype of a buffer that is zero on the other ranks."""
    if not initialized() or world_size() == 1:
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        if rank():
            flat.zero_()
        dist.all_reduce(flat)
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.data.copy_(part.view_as(t))


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
