"""DenseNet feature extractor with PSPDenseNet's dilation surgery (NCHW).

Counterpart of ``segtpu/backbones/densenet.py``: torchvision's DenseNet
blocks and transitions, transition2 and transition3 without their pools
(output stride 8), denseblock3's 3x3 convs dilated 2 and denseblock4's
dilated 4. Two stems, as segtpu's ``pretrained_stem`` selects them: the
from-scratch stem of the original PSPDenseNet (3x3 convs at stride 2, 1 and
1, all with padding 0, each with BN and ReLU, then a 3x3/2/1 max pool), or
torchvision's 7x7/2 conv (no bias), BN, ReLU and 3x3/2/1 max pool, which a
pretrained DenseNet's ``features.conv0`` and ``norm0`` load into.

``remat_layers`` is segtpu's per-dense-layer ``nn.remat``: each dense layer
runs under ``torch.utils.checkpoint`` (non-reentrant) and takes the
previous features unpacked, so that what the backward keeps is the block
input and the layers' growth tensors, not each layer's concatenated input,
and the backward replays concat, BN, ReLU and convs layer by layer. The
replay normalizes with the batch's statistics again but leaves the
running statistics (and ``num_batches_tracked``) as the forward left them,
as segtpu's functional remat does.

Module names follow torchvision (``denselayerN.{norm1,conv1,norm2,conv2}``,
``transition1.{norm,conv}``) and the original PSPDenseNet
(``transition{2,3}.{0,2}``; the from-scratch stem's convs at
``block0.{0,3,6}``, the 7x7 stem's conv and BN at ``block0.{0,1}``).
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from segtpu_torch.nn.layers import batch_norm, conv2d, kaiming_normal_init

#: arch -> (growth, layers per block, stem width)
DENSENET_CONFIG = {
    "densenet121": (32, (6, 12, 24, 16), 64),
    "densenet169": (32, (6, 12, 32, 32), 64),
    "densenet201": (32, (6, 12, 48, 32), 64),
    "densenet161": (48, (6, 12, 36, 24), 96),
}


@contextlib.contextmanager
def _replay(norms):
    """The checkpoint's recompute: the BNs normalize with the batch's
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


class DenseLayer(nn.Module):
    """BN-ReLU-1x1 to ``4 * growth``, then BN-ReLU-3x3 to ``growth``; takes
    the previous features unpacked and concatenates them itself."""

    def __init__(self, in_ch: int, growth: int, dilation: int = 1):
        super().__init__()
        mid = 4 * growth
        self.norm1, self.relu1 = batch_norm(in_ch), nn.ReLU(inplace=True)
        self.conv1 = conv2d(in_ch, mid, 1)
        self.norm2, self.relu2 = batch_norm(mid), nn.ReLU(inplace=True)
        self.conv2 = conv2d(mid, growth, 3, padding=dilation, dilation=dilation)

    def forward(self, *parts):
        x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        y = self.conv1(self.relu1(self.norm1(x)))
        return self.conv2(self.relu2(self.norm2(y)))


class DenseBlock(nn.Module):
    def __init__(self, num_layers: int, in_ch: int, growth: int, dilation: int = 1,
                 remat_layers: bool = False):
        super().__init__()
        self.remat_layers = remat_layers
        for i in range(num_layers):
            self.add_module(f"denselayer{i + 1}",
                            DenseLayer(in_ch + i * growth, growth, dilation=dilation))
        self.out_channels = in_ch + num_layers * growth

    def _run(self, layer, parts):
        if not (self.remat_layers and torch.is_grad_enabled()):
            return layer(*parts)
        norms = (layer.norm1, layer.norm2)
        return checkpoint(layer, *parts, use_reentrant=False,
                          context_fn=lambda: (contextlib.nullcontext(), _replay(norms)))

    def forward(self, x):
        parts = [x]
        for layer in self.children():
            parts.append(self._run(layer, parts))
        return torch.cat(parts, dim=1)


class Transition(nn.Sequential):
    """BN, ReLU, 1x1 conv, then a 2x2 average pool (torchvision's
    ``_Transition``: ``norm``, ``relu``, ``conv``, ``pool``)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.norm, self.relu = batch_norm(in_ch), nn.ReLU(inplace=True)
        self.conv = conv2d(in_ch, out_ch, 1)
        self.pool = nn.AvgPool2d(2, 2)


def transition_without_pool(in_ch: int, out_ch: int) -> nn.Sequential:
    """The original PSPDenseNet's transition2/3: BN, ReLU, 1x1 conv at 0, 1,
    2."""
    return nn.Sequential(batch_norm(in_ch), nn.ReLU(inplace=True), conv2d(in_ch, out_ch, 1))


def scratch_stem(in_ch: int, width: int = 64) -> nn.Sequential:
    """3x3 convs (stride 2, 1, 1; padding 0; kaiming normal), each with BN
    and ReLU, then a 3x3/2/1 max pool: convs at 0, 3, 6, BNs at 1, 4, 7."""
    layers = []
    for stride in (2, 1, 1):
        layers += [conv2d(in_ch, width, 3, stride, 0, weight_init=kaiming_normal_init),
                   batch_norm(width), nn.ReLU(inplace=True)]
        in_ch = width
    return nn.Sequential(*layers, nn.MaxPool2d(3, 2, 1))


def torchvision_stem(in_ch: int, width: int) -> nn.Sequential:
    """torchvision's DenseNet stem: a 7x7/2 conv with padding 3 and no bias,
    BN, ReLU, then a 3x3/2/1 max pool (the conv at 0, the BN at 1)."""
    return nn.Sequential(conv2d(in_ch, width, 7, 2, 3), batch_norm(width),
                         nn.ReLU(inplace=True), nn.MaxPool2d(3, 2, 1))


class DenseNetFeatures(nn.Module):
    """``block0`` (the stem: the 7x7 one with ``pretrained_stem``, else the
    from-scratch one), ``block1``-``block4`` and ``transition1``-
    ``transition3``; ``forward`` returns (block4's output, transition3's
    output), PSPDenseNet's master and aux taps."""

    def __init__(self, arch: str = "densenet201", in_channels: int = 3,
                 remat_layers: bool = False, pretrained_stem: bool = False):
        super().__init__()
        growth, blocks, stem = DENSENET_CONFIG[arch]
        ch = stem if pretrained_stem else 64
        self.block0 = (torchvision_stem(in_channels, ch) if pretrained_stem
                       else scratch_stem(in_channels, ch))
        for bi, dilation in enumerate((1, 1, 2, 4)):
            block = DenseBlock(blocks[bi], ch, growth, dilation, remat_layers)
            setattr(self, f"block{bi + 1}", block)
            ch = block.out_channels
            if bi < 3:
                setattr(self, f"transition{bi + 1}",
                        Transition(ch, ch // 2) if bi == 0
                        else transition_without_pool(ch, ch // 2))
                ch //= 2
                if bi == 2:
                    #: transition3's width, the aux head's input
                    self.aux_channels = ch
        self.out_channels = ch

    #: the modules, in the original PSPDenseNet's names
    module_names = ("block0", "block1", "block2", "block3", "block4",
                    "transition1", "transition2", "transition3")

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        return run_features(self, x)


def run_features(net: nn.Module, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stem, then each block and its transition, on ``net``'s
    ``block0``-``block4`` and ``transition1``-``transition3``; returns
    (block4's output, transition3's output)."""
    y = net.block0(x)
    for bi in (1, 2, 3):
        y = getattr(net, f"transition{bi}")(getattr(net, f"block{bi}")(y))
    return net.block4(y), y
