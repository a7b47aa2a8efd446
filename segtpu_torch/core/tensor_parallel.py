"""Tensor parallelism: conv weights sharded over the model axis.

Counterpart of segtpu's ``tp_sharding_tree`` and ``shard_state``
(``segtpu/core/mesh.py``): every conv kernel with at least
``min_channels`` (256) output channels, a number the model axis divides,
is sharded over the model group on its output channels; everything else
is replicated. segtpu leaves the rest to GSPMD; here :func:`shard_model`
swaps each such ``nn.Conv2d`` / ``nn.ConvTranspose2d`` for a
column-parallel class in place, after the model is built and any
pretrained file loaded, holding this rank's slice of O (weight and bias)
under the same names:

* under tensor parallelism alone (the model ranks hold the same rows), the
  input enters through an identity whose backward sums dx over the model
  group, the conv runs on the slice, and the output leaves through an
  all-gather along channels whose backward keeps this rank's slice. A
  depthwise conv (``groups == in == out``, Xception's ``SeparableConv``)
  slices its input channels too;
* under spatial sharding too (the model ranks hold different rows), the
  weight slices are gathered just before the conv and the full weight's
  gradient is summed over the model group and cut back to the slice, so
  parameters and optimizer state stay sharded while each rank convolves
  its own rows (``core/spatial.py`` adds the halo).

The optimizer is built after the swap, so its state is shard-sized, as
segtpu's is. :func:`gather_state` and :func:`scatter_state` move a
model's and an optimizer's state between the sharded and the one-device
layout for checkpoints, bit for bit.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from segtpu_torch.core import mesh, spatial

#: segtpu's default: convs with fewer output channels stay replicated
MIN_CHANNELS = 256


def _gather_dim(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's slice of ``dim`` put at its place in the whole, every
    model rank's slice summed in: the whole, the owners' bits."""
    m, i = mesh.model_size(), mesh.model_index()
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * m
    cl = x.dim() == 4 and not x.is_contiguous() and x.is_contiguous(
        memory_format=torch.channels_last)
    buf = x.new_zeros(shape)
    if cl:
        buf = buf.contiguous(memory_format=torch.channels_last)
    buf.narrow(dim, i * n, n).copy_(x)
    dist.all_reduce(buf, group=mesh.model_group())
    return buf


def _slice_dim(x: torch.Tensor, dim: int) -> torch.Tensor:
    n = x.shape[dim] // mesh.model_size()
    return x.narrow(dim, mesh.model_index() * n, n)


class _CopyToModel(torch.autograd.Function):
    """Forward: the identity. Backward: dx summed over the model group (each
    rank's conv slice gives a part of it)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=mesh.model_group())
        return g


class _GatherChannels(torch.autograd.Function):
    """Forward: every rank's channels slice gathered in order. Backward:
    this rank's slice of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, y):
        return _gather_dim(y, 1)

    @staticmethod
    def backward(ctx, g):
        return _slice_dim(g, 1)


class _GatherWeight(torch.autograd.Function):
    """Forward: the whole weight from the slices along ``dim``. Backward:
    the whole weight's gradient summed over the model group (each rank's
    rows give a part of it), cut to this rank's slice."""

    @staticmethod
    def forward(ctx, w, dim):
        ctx.dim = dim
        return _gather_dim(w, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=mesh.model_group())
        return _slice_dim(g, ctx.dim).contiguous(), None


def _whole(p, dim):
    return None if p is None else _GatherWeight.apply(p, dim)


class ColumnConv2d(nn.Conv2d):
    """An ``nn.Conv2d`` whose ``weight`` and ``bias`` hold this rank's slice
    of the output channels (``out_channels`` and ``groups`` stay the whole
    conv's)."""

    tp_dims = {"weight": 0, "bias": 0}

    def forward(self, x):
        if mesh.spatial():
            return self._conv_forward(x, _whole(self.weight, 0), _whole(self.bias, 0))
        x = _CopyToModel.apply(x)
        groups = self.groups
        if self.tp_depthwise:
            x = _slice_dim(x, 1)
            groups = self.groups // mesh.model_size()
        y = F.conv2d(x, self.weight, self.bias, self.stride, self.padding, self.dilation,
                     groups)
        return _GatherChannels.apply(y)


class ColumnConvTranspose2d(nn.ConvTranspose2d):
    """An ``nn.ConvTranspose2d`` whose (in, out, k, k) ``weight`` and
    ``bias`` hold this rank's slice of the output channels."""

    tp_dims = {"weight": 1, "bias": 0}

    def forward(self, x, output_size=None):
        if output_size is not None:
            raise NotImplementedError("a sharded transposed conv takes no output_size")
        if mesh.spatial():
            return self._transposed(x, _whole(self.weight, 1), _whole(self.bias, 0))
        y = self._transposed(_CopyToModel.apply(x), self.weight, self.bias)
        return _GatherChannels.apply(y)

    def _transposed(self, x, weight, bias):
        return F.conv_transpose2d(x, weight, bias, self.stride, self.padding,
                                  self.output_padding, self.groups, self.dilation)


class HaloColumnConv2d(ColumnConv2d, spatial.HaloConv2d):
    """:class:`ColumnConv2d` under spatial sharding, with the halo of
    :class:`~segtpu_torch.core.spatial.HaloConv2d`."""


class HaloColumnConvTranspose2d(ColumnConvTranspose2d):
    """:class:`ColumnConvTranspose2d` over a sharded map."""

    def _transposed(self, x, weight, bias):
        if not spatial.active():
            return super()._transposed(x, weight, bias)
        return spatial.conv_transpose2d(x, weight, bias, self.stride, self.padding,
                                        self.output_padding, self.groups, self.dilation)


def _shardable(m: nn.Module, min_channels: int, tp: int) -> bool:
    if type(m) not in (nn.Conv2d, nn.ConvTranspose2d):
        return False
    o = m.out_channels
    if o < min_channels or o % tp:
        return False
    if type(m) is nn.Conv2d:
        # a grouped conv shards only when it is depthwise
        return m.groups == 1 or m.groups == m.in_channels == o
    return m.groups == 1


@torch.no_grad()
def shard_model(model: nn.Module, min_channels: int = MIN_CHANNELS) -> List[str]:
    """Swap every conv of ``model`` with at least ``min_channels`` output
    channels that the model axis divides for its column-parallel class, in
    place, keeping this rank's slice; returns their names. The stem kernel's
    conv (``StemConv2d``, 64 channels) is never sharded. Under spatial
    sharding, the convs with a window over H take their halo classes too."""
    tp = mesh.model_size()
    names = []
    for name, m in model.named_modules():
        if tp < 2 or not _shardable(m, min_channels, tp):
            continue
        transposed = type(m) is nn.ConvTranspose2d
        for pname, dim in (ColumnConvTranspose2d if transposed else ColumnConv2d
                           ).tp_dims.items():
            p = getattr(m, pname)
            if p is not None:
                setattr(m, pname, nn.Parameter(_slice_dim(p.data, dim).clone(),
                                               requires_grad=p.requires_grad))
        m.tp_depthwise = (not transposed and m.groups > 1)
        windowed = m.kernel_size[0] > 1 or m.stride[0] > 1
        if transposed:
            m.__class__ = (HaloColumnConvTranspose2d if mesh.spatial()
                           else ColumnConvTranspose2d)
        else:
            m.__class__ = (HaloColumnConv2d if mesh.spatial() and windowed
                           else ColumnConv2d)
        names.append(name)
    if mesh.spatial():
        spatial.shard_windows(model)
    return names


def sharded_dims(model: nn.Module) -> Dict[str, int]:
    """``{parameter name: the dim sharded over the model axis}``."""
    out = {}
    for name, m in model.named_modules():
        for pname, dim in getattr(m, "tp_dims", {}).items():
            if getattr(m, pname, None) is not None:
                out[f"{name}.{pname}" if name else pname] = dim
    return out


def _param_index(model: nn.Module, optimizer) -> Dict[int, str]:
    """The optimizer state dict's parameter index -> parameter name."""
    names = {id(p): n for n, p in model.named_parameters()}
    flat = [p for g in optimizer.param_groups for p in g["params"]]
    return {i: names[id(p)] for i, p in enumerate(flat)}


def gather_state(model: nn.Module, optimizer, model_sd: Dict, opt_sd: Dict):
    """The one-device layout of ``model_sd`` and ``opt_sd`` (a collective
    of every rank): each sharded parameter, and each of its optimizer state
    tensors of its shape, gathered whole along its sharded dim."""
    dims = sharded_dims(model)
    model_sd = dict(model_sd)
    for name, dim in dims.items():
        model_sd[name] = _gather_dim(model_sd[name], dim)
    shapes = {n: p.shape for n, p in model.named_parameters()}
    state = {}
    for i, buffers in opt_sd["state"].items():
        name = _param_index(model, optimizer)[i]
        if name in dims:
            buffers = {k: _gather_dim(v, dims[name])
                       if torch.is_tensor(v) and v.shape == shapes[name] else v
                       for k, v in buffers.items()}
        state[i] = buffers
    return model_sd, {**opt_sd, "state": state}


def scatter_state(model: nn.Module, optimizer, model_sd: Dict, opt_sd: Dict):
    """This rank's slices of one-device ``model_sd`` and ``opt_sd`` (no
    collective)."""
    dims = sharded_dims(model)
    model_sd = dict(model_sd)
    full = {}
    for name, dim in dims.items():
        full[name] = model_sd[name].shape
        model_sd[name] = _slice_dim(model_sd[name], dim).clone()
    state = {}
    index = _param_index(model, optimizer)
    for i, buffers in opt_sd["state"].items():
        name = index[int(i)]
        if name in dims:
            buffers = {k: _slice_dim(v, dims[name]).clone()
                       if torch.is_tensor(v) and v.shape == full[name] else v
                       for k, v in buffers.items()}
        state[i] = buffers
    return model_sd, {**opt_sd, "state": state}
