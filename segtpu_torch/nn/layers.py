"""Conv / BatchNorm construction and the torch-parity initializers.

Counterpart of ``segtpu/nn/layers.py``. Convolutions are ``nn.Conv2d`` and
``nn.ConvTranspose2d``, and normalization is ``nn.BatchNorm2d`` (momentum
0.1, eps 1e-5: biased variance to normalize, unbiased for the running
buffer, as segtpu's BatchNorm). Under a process group of more than one
rank, :func:`convert_global_bn` makes it :class:`GlobalBatchNorm2d`, whose
statistics are the global batch's, as segtpu's under its mesh (over the
ranks whose pixels differ: ``core/mesh.py``'s ``pixel_group``).

Initializers take an explicit ``torch.Generator``. A conv built with
:func:`conv2d` remembers its initializers, and :func:`init_parameters`
re-draws every such conv of a model from one generator, so a model is a
function of its seed.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

Init = Callable[[torch.Tensor, Optional[torch.Generator]], None]


def _fan_in(weight: torch.Tensor) -> int:
    return weight.shape[1] * weight.shape[2] * weight.shape[3]


def torch_conv_kernel_init(weight, generator=None):
    """torch ``nn.Conv2d`` default: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(_fan_in(weight))
    nn.init.uniform_(weight, -bound, bound, generator=generator)


def torch_conv_bias_init(bias, fan_in, generator=None):
    """torch conv default bias: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in)
    nn.init.uniform_(bias, -bound, bound, generator=generator)


def kaiming_normal_init(weight, generator=None):
    """torch ``kaiming_normal_(w, nonlinearity='relu')``: N(0, 2/fan_in)."""
    nn.init.normal_(weight, 0.0, math.sqrt(2.0 / _fan_in(weight)),
                    generator=generator)


def zeros_init(bias, fan_in, generator=None):
    nn.init.zeros_(bias)


def conv2d(in_ch: int, out_ch: int, kernel_size: int, stride: int = 1,
           padding: int = 0, dilation: int = 1, bias: bool = False,
           weight_init: Init = torch_conv_kernel_init,
           bias_init=torch_conv_bias_init, groups: int = 1) -> nn.Conv2d:
    """``nn.Conv2d`` that carries its initializers for
    :func:`init_parameters`. ``groups=in_ch`` makes a depthwise conv; the
    initializers' fan-in is then ``k*k*in_ch/groups``, as segtpu's."""
    conv = nn.Conv2d(in_ch, out_ch, kernel_size, stride, padding, dilation,
                     groups=groups, bias=bias)
    conv.weight_init = weight_init
    conv.bias_init = bias_init
    return conv


def _transposed(init: Init) -> Init:
    """``init`` with segtpu's fan-in for a transposed conv, ``k*k*in``: it
    reads the (in, out, k, k) weight as (out, in, k, k). torch's own default
    for ``nn.ConvTranspose2d`` reads ``weight.size(1)*k*k``, ``k*k*out``."""
    return lambda weight, generator=None: init(weight.transpose(0, 1), generator)


def conv_transpose2d(in_ch: int, out_ch: int, kernel_size: int, stride: int = 1,
                     padding: int = 0, bias: bool = True,
                     weight_init: Init = torch_conv_kernel_init,
                     bias_init=torch_conv_bias_init,
                     output_padding: int = 0) -> nn.ConvTranspose2d:
    """``nn.ConvTranspose2d`` with segtpu's ``ConvTranspose`` initializers
    for :func:`init_parameters`: the weight's fan-in is ``k*k*in``, the
    bias's ``k*k*out``, as segtpu draws them. The weight is torch's (in,
    out, k, k); segtpu's converter maps it to HWIO without a flip, and
    segtpu flips it when it runs the conv."""
    conv = nn.ConvTranspose2d(in_ch, out_ch, kernel_size, stride, padding,
                              output_padding, bias=bias)
    conv.weight_init = _transposed(weight_init)
    conv.bias_init = bias_init
    return conv


def batch_norm(features: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(features, eps=1e-5, momentum=0.1)


class _GlobalBN(torch.autograd.Function):
    """Train-mode batch norm over the batch of every rank.

    Forward: the per-channel count and sum are summed over the ranks, then
    the sum of squared deviations from that global mean (two passes, so the
    variance keeps the digits torch's own BN keeps; segtpu's E[x^2] - mean^2
    does not). Backward: the per-channel sums of dy and dy * x_hat are
    summed over the ranks; the weight's and the bias's gradients stay
    local, for the data-parallel wrap to sum. Statistics in at least fp32;
    y and dx in the input's dtype."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum, eps, group):
        from segtpu_torch.core import mesh

        c = x.shape[1]
        dims = (0, 2, 3)
        xf = x if x.dtype == torch.float64 else x.float()
        local = torch.cat([xf.sum(dims), xf.new_full((1,), x.numel() // c)])
        total = mesh.global_sum(local, group)
        count = total[c]
        mean = total[:c] / count
        xc = xf - mean.view(1, c, 1, 1)
        var = mesh.global_sum((xc * xc).sum(dims), group) / count
        invstd = torch.rsqrt(var + eps)
        with torch.no_grad():
            running_mean.mul_(1 - momentum).add_(mean.to(running_mean.dtype), alpha=momentum)
            unbiased = var * count / (count - 1)
            running_var.mul_(1 - momentum).add_(unbiased.to(running_var.dtype),
                                                alpha=momentum)
        ctx.save_for_backward(x, weight, mean, invstd, count)
        ctx.group = group
        y = xc * (invstd * weight.to(xf.dtype)).view(1, c, 1, 1) + bias.to(xf.dtype).view(
            1, c, 1, 1)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        from segtpu_torch.core import mesh

        x, weight, mean, invstd, count = ctx.saved_tensors
        c = x.shape[1]
        dims = (0, 2, 3)
        xf = x if x.dtype == torch.float64 else x.float()
        dyf = dy.to(xf.dtype)
        xhat = (xf - mean.view(1, c, 1, 1)) * invstd.view(1, c, 1, 1)
        sum_dy, sum_dy_xhat = dyf.sum(dims), (dyf * xhat).sum(dims)
        total = mesh.global_sum(torch.cat([sum_dy, sum_dy_xhat]), ctx.group)
        mean_dy, mean_dy_xhat = (total[:c] / count).view(1, c, 1, 1), (
            total[c:] / count).view(1, c, 1, 1)
        scale = (weight.to(xf.dtype) * invstd).view(1, c, 1, 1)
        dx = scale * (dyf - mean_dy - xhat * mean_dy_xhat)
        return (dx.to(x.dtype), sum_dy_xhat.to(weight.dtype), sum_dy.to(weight.dtype),
                None, None, None, None, None)


class GlobalBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d whose train-mode statistics are those of the global
    batch, over every rank of the process group: segtpu's BatchNorm under
    its mesh. Through :class:`_GlobalBN` inside a process group; outside
    one, and in eval mode (``freeze_bn`` included), it is ``nn.BatchNorm2d``
    itself. The running variance is unbiased with the global count. Same
    parameters, buffers and state-dict keys as ``nn.BatchNorm2d``.

    The statistics run over the ranks whose pixels differ (the world, or
    the data group under tensor parallelism alone). A BN whose maps are
    replicated on the model ranks even under spatial sharding (the PSP
    bins; ``replicated_maps`` set by its model) takes the data group, so
    its count is the batch's, not the model axis's multiple of it."""

    #: set on a BN that normalizes maps every model rank holds whole
    replicated_maps = False

    def forward(self, x):
        from segtpu_torch.core import mesh

        if not (self.training and mesh.initialized()):
            return super().forward(x)
        group = mesh.image_group() if self.replicated_maps else mesh.pixel_group()
        if x.numel() // x.shape[1] * mesh.group_size(group) <= 1:
            raise ValueError(f"Expected more than 1 value per channel when training, "
                             f"got input size {tuple(x.shape)} on "
                             f"{mesh.group_size(group)} rank(s)")
        self.num_batches_tracked.add_(1)
        return _GlobalBN.apply(x, self.weight, self.bias, self.running_mean,
                               self.running_var, self.momentum, self.eps, group)


def convert_global_bn(model: nn.Module, force: bool = False) -> int:
    """Make every ``nn.BatchNorm2d`` of ``model`` a :class:`GlobalBatchNorm2d`
    in place (its class changes; its parameters, buffers and keys stay), when
    the process group has more than one rank or ``force`` is set; returns how
    many were converted. At one rank nothing changes."""
    from segtpu_torch.core import mesh

    if mesh.world_size() == 1 and not force:
        return 0
    n = 0
    for m in model.modules():
        if type(m) is nn.BatchNorm2d:
            m.__class__ = GlobalBatchNorm2d
            n += 1
    return n


@contextlib.contextmanager
def replay_norms(norms):
    """A checkpoint's recompute: the BNs normalize with the batch's
    statistics as in the forward, but update copies of their running
    statistics and ``num_batches_tracked``, which are dropped after; the
    forward's update stays the only one."""
    buffers = ("running_mean", "running_var", "num_batches_tracked")
    kept = [[getattr(bn, b) for b in buffers] for bn in norms]
    for bn, values in zip(norms, kept):
        for b, v in zip(buffers, values):
            setattr(bn, b, v.clone())
    try:
        yield
    finally:
        for bn, values in zip(norms, kept):
            for b, v in zip(buffers, values):
                setattr(bn, b, v)


def remat(fn, module: nn.Module, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant, the
    generators' state preserved, so dropout draws the same masks again),
    the recompute replaying ``module``'s BatchNorms with
    :func:`replay_norms`; ``fn(*args)`` itself where no gradient is
    recorded."""
    if not torch.is_grad_enabled():
        return fn(*args)
    norms = [m for m in module.modules() if isinstance(m, nn.BatchNorm2d)]
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(), replay_norms(norms)))


class FreezableBN(nn.Module):
    """Base of the models that take ``freeze_bn``: with ``self.freeze_bn``
    set, every BatchNorm stays in eval mode through ``train()`` (the train
    step calls it every step), so it normalizes with its running statistics
    and leaves them untouched; its scale and bias still train, and dropout
    stays on, as in the original's ``freeze_bn()``."""

    freeze_bn = False

    def train(self, mode: bool = True):
        super().train(mode)
        if mode and self.freeze_bn:
            for m in self.modules():
                if isinstance(m, nn.BatchNorm2d):
                    m.eval()
        return self


@torch.no_grad()
def init_parameters(module: nn.Module,
                    generator: Optional[torch.Generator] = None) -> None:
    """Re-draw every conv built by :func:`conv2d` or
    :func:`conv_transpose2d` (or carrying a ``weight_init``), in
    ``modules()`` order. A bias's fan-in is ``weight.shape[1:]``'s product:
    ``k*k*in`` for a conv, ``k*k*out`` for a transposed one, as segtpu's."""
    for m in module.modules():
        init = getattr(m, "weight_init", None)
        if init is not None:
            init(m.weight, generator)
            if getattr(m, "bias", None) is not None:
                m.bias_init(m.bias, _fan_in(m.weight), generator)


class ConvBNAct(nn.Sequential):
    """conv -> BN -> activation, the zoo's workhorse block."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 bias: bool = False, act: bool = True,
                 weight_init: Init = torch_conv_kernel_init):
        layers = [conv2d(in_ch, out_ch, kernel_size, stride, padding,
                         dilation, bias, weight_init),
                  batch_norm(out_ch)]
        if act:
            layers.append(nn.ReLU(inplace=True))
        super().__init__(*layers)


def bilinear_kernel(channels: int, k: int) -> torch.Tensor:
    """The original's ``get_upsampling_weight``: a k x k bilinear filter on
    the diagonal of a (channels, channels, k, k) transposed-conv weight."""
    factor = (k + 1) // 2
    center = factor - 1 if k % 2 == 1 else factor - 0.5
    og = np.ogrid[:k, :k]
    filt = (1 - abs(og[0] - center) / factor) * (1 - abs(og[1] - center) / factor)
    w = np.zeros((channels, channels, k, k), dtype=np.float32)
    w[range(channels), range(channels)] = filt
    return torch.from_numpy(w)
