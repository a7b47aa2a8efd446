"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both segtpu (NHWC, JAX
on the CPU) and segtpu_torch (NCHW, torch on the CPU); weights go from
segtpu's variables to the port through ``pspnet_state_dict_from_segtpu`` and
``upernet_state_dict_from_segtpu``.
"""

from __future__ import annotations

import contextlib

import flax
import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segtpu import losses as seg_losses
from segtpu.models.pspnet import PSPNet as SegtpuPSPNet
from segtpu.models.upernet import UperNet as SegtpuUperNet
from segtpu.nn import blocks as seg_blocks
from segtpu.ops import pooling as seg_pooling
from segtpu.ops import resize as seg_resize
from segtpu_torch.models.pspnet import PSPNet
from segtpu_torch.models.upernet import UperNet
from segtpu_torch.utils import weight_convert
from segtpu_torch.utils.weight_convert import (pspnet_state_dict_from_segtpu,
                                               upernet_state_dict_from_segtpu)


def nchw(a: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> NCHW torch (a copy)."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def rel_max(got, want) -> float:
    """max |got - want| relative to max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _perturb_bn(params, stats, rng):
    """Move every BN off its init (scale 1, bias 0, mean 0, var 1) so that
    the comparisons exercise the affine terms and the running stats."""
    flat_p = flax.traverse_util.flatten_dict(params)
    flat_s = flax.traverse_util.flatten_dict(stats)
    for key in list(flat_p):
        if key[-1] == "scale":
            flat_p[key] = rng.uniform(0.5, 1.5, flat_p[key].shape).astype(np.float32)
            bias = key[:-1] + ("bias",)
            flat_p[bias] = rng.normal(0, 0.1, flat_p[bias].shape).astype(np.float32)
    for key in list(flat_s):
        if key[-1] == "mean":
            flat_s[key] = rng.normal(0, 0.1, flat_s[key].shape).astype(np.float32)
        else:
            flat_s[key] = rng.uniform(0.5, 1.5, flat_s[key].shape).astype(np.float32)
    return (flax.traverse_util.unflatten_dict(flat_p),
            flax.traverse_util.unflatten_dict(flat_s))


def _init_segtpu(model, hw: int, seed: int):
    """(model, params, batch_stats) as numpy trees, with BN moved off its
    init; a model without BN (FCN8) has empty batch_stats."""
    key = jax.random.PRNGKey(seed)
    variables = jax.jit(lambda k, x: model.init(
        {"params": k, "dropout": k}, x, train=False))(
            key, jnp.zeros((1, hw, hw, 3), jnp.float32))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    params, stats = _perturb_bn(variables["params"], variables.get("batch_stats", {}),
                                np.random.default_rng(seed))
    return model, params, stats


def segtpu_pspnet(backbone: str, num_classes: int, hw: int, seed: int = 0,
                  pallas_stem_wgrad: bool = False):
    """(segtpu PSPNet, params, batch_stats), see :func:`_init_segtpu`."""
    return _init_segtpu(SegtpuPSPNet(num_classes=num_classes, backbone=backbone,
                                     pallas_stem_wgrad=pallas_stem_wgrad), hw, seed)


def segtpu_upernet(backbone: str, num_classes: int, hw: int, fpn_out: int,
                   seed: int = 0):
    """(segtpu UperNet, params, batch_stats), see :func:`_init_segtpu`."""
    return _init_segtpu(SegtpuUperNet(num_classes=num_classes, backbone=backbone,
                                      fpn_out=fpn_out), hw, seed)


def port_upernet(params, stats, backbone: str, num_classes: int, fpn_out: int) -> UperNet:
    model = UperNet(num_classes, backbone=backbone, fpn_out=fpn_out)
    model.load_state_dict(upernet_state_dict_from_segtpu(params, stats), strict=True)
    return model


def port_pspnet(params, stats, backbone: str, num_classes: int, **kwargs) -> PSPNet:
    model = PSPNet(num_classes, backbone=backbone, **kwargs)
    model.load_state_dict(pspnet_state_dict_from_segtpu(params, stats), strict=True)
    return model


def no_dropout(model: torch.nn.Module) -> torch.nn.Module:
    """Dropout's random bits cannot match between the frameworks: the
    train-mode parity tests set p=0 here (elementwise and channel dropout
    alike) and make flax's Dropout the identity on the segtpu side."""
    for m in model.modules():
        if isinstance(m, (torch.nn.Dropout, torch.nn.Dropout2d)):
            m.p = 0.0
    return model


class IdentityDropout:
    """Stand-in for ``flax.linen.Dropout`` (see :func:`no_dropout`)."""

    def __init__(self, *a, **k):
        pass

    def __call__(self, x, *a, **k):
        return x


class _Float64:
    """A module (``jax.numpy`` or ``numpy``) with ``float32`` meaning
    ``float64``."""

    def __init__(self, module):
        self._module = module
        self.float32 = module.float64

    def __getattr__(self, name):
        return getattr(self._module, name)


@contextlib.contextmanager
def segtpu_float64():
    """segtpu in float64: x64 on, and the float32 casts on the models' paths
    made float64 (the losses' logits, ASPP's image-pool mean, the resize
    matrices, the average pool's sums and the adaptive pool's matrices);
    dropout is the identity. Nothing in segtpu changes."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(seg_losses, "jnp", _Float64(jnp))
        mp.setattr(seg_blocks, "jnp", _Float64(jnp))
        mp.setattr(seg_resize, "np", _Float64(np))
        mp.setattr(seg_resize, "_linear_matrix_np", seg_resize._linear_matrix_np.__wrapped__)
        mp.setattr(seg_pooling, "jnp", _Float64(jnp))
        mp.setattr(seg_pooling, "np", _Float64(np))
        mp.setattr(seg_pooling, "_adaptive_matrix_np",
                   seg_pooling._adaptive_matrix_np.__wrapped__)
        mp.setattr(flax.linen, "Dropout", IdentityDropout)
        try:
            yield
        finally:
            jax.config.update("jax_enable_x64", prev)


def state_dict64(convert, params, stats):
    """``convert(params, stats)``, a ``*_state_dict_from_segtpu``, without
    its float32 cast, for the float64 runs."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(weight_convert, "_t",
                   lambda a: torch.from_numpy(np.array(a, dtype=np.float64)))
        return convert(params, stats)
