"""Pretrained encoders from local ``.pth`` files: ``arch.args.pretrained``
honored at train time.

Counterpart of ``segtpu/pretrained.py``. A model constructor only records
``pretrained`` (a bool or a path); the Trainer calls
:func:`maybe_load_pretrained` once, after the model and the optimizer exist
and before a resume, so a resume overwrites what it loaded, and the
inference and export CLIs rebuild a model without any weight file.

The port reads the original ``.pth`` state dict itself, the file that
``scripts/convert_weights.py`` takes as ``--input``, and remaps its keys
into the model's own names; segtpu's ``convert_*`` functions
(``segtpu/utils/weight_convert.py``) specify which file key feeds which
parameter. segtpu's converted orbax directory is not accepted: orbax is a
JAX package, and the port imports no JAX.

Resolution (fails loudly; nothing falls back to training from scratch):

* ``pretrained: "<path>"`` -- that ``.pth`` file;
* ``pretrained: true`` -- ``<root>/<checkpoint_id(model)>.pth``, where root
  is the config key ``pretrained_dir`` or ``$SEGTPU_PRETRAINED_DIR``.

=================  ===============  ==========================================
model              id               the file's layout
=================  ===============  ==========================================
PSPNet             ``<backbone>s``  encoding ResNet: deep-base ``conv1.{0,1,3,
                                    4,6}`` and ``bn1`` for bottleneck archs,
                                    torchvision's ``conv1``/``bn1`` for 18/34
UNetResnet         ``<backbone>s``  as PSPNet
UperNet, GCN,      ``<backbone>``   torchvision ResNet (``conv1``, ``bn1``,
DeepLab_DUC_HDC                     ``layerN``); GCN with ``use_resnet_gcn``
                                    loads the stem and layer1-2 only
DeepLab (ResNet)   ``<backbone>``   torchvision ResNet
DeepLab (Xception) ``xception``     DeepLab's aligned Xception (separable
                                    convs with their BN, three a block); a
                                    missing block12-19 is read from block11,
                                    block20 from block12, bn4 from bn3, conv5
                                    from conv4, bn5 from bn4
SegResNet          ``resnet50``     torchvision ResNet-50
PSPDenseNet        ``<backbone>``   torchvision DenseNet (``features.*``);
                                    the model takes the 7x7 stem
SegNet             ``vgg16_bn``     torchvision VGG-16-BN ``features``
FCN8               ``vgg16``        torchvision VGG-16, ``classifier.0`` and
                                    ``classifier.3`` included (FC6 and FC7
                                    become conv6 and conv7 by reshape)
=================  ===============  ==========================================

Each encoder model's ``pretrained_layout()`` gives its row as a
:class:`Layout`; UNet and ENet have none, and no pretrained encoder.

Merge rules, segtpu's: every key of the file lands on a key of the model,
else ``KeyError``, unless the load is partial (GCN's ResnetGCN backbone);
the keys segtpu's converters never read are skipped (``fc.*``,
``classifier.*`` but FCN8's FC6 and FC7, DenseNet's ``features.norm5.*``,
every ``num_batches_tracked``); a model key the file lacks keeps its init;
every shape must match (``ValueError`` naming the key). The copy is in
place, so the optimizer keeps owning the parameters and a channels_last
model stays channels_last.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

logger = logging.getLogger("segtpu_torch.pretrained")


class Layout(NamedTuple):
    """How a model reads its original file, as its ``pretrained_layout()``
    gives it: ``file_id`` names ``<file_id>.pth``; ``rules`` are (model
    prefix, file prefix) pairs, the first whose file prefix starts a key
    renames it; ``fallbacks`` are (model prefix, file prefixes) read, in
    order, for a model key that no file key renamed to; ``skip`` are the
    file prefixes never read; a file without one of the ``required`` keys is
    refused, for the reason ``required_why``."""

    file_id: str
    rules: List[Tuple[str, str]]
    skip: Tuple[str, ...] = ("fc.",)
    fallbacks: Tuple[Tuple[str, Tuple[str, ...]], ...] = ()
    partial: bool = False
    reshape: bool = False  # a 2-D (linear) weight read as a conv's
    required: Tuple[str, ...] = ()
    required_why: str = ""


def resnet_rules(stem: str, prefix: str = "", layers=(1, 2, 3, 4)) -> List[Tuple[str, str]]:
    """``conv1`` (torchvision's conv or the deep base's Sequential) and
    ``bn1`` to ``<stem>.0``/``<stem>.1``; ``layerN`` to ``<prefix>layerN``."""
    return [(f"{stem}.0.", "conv1."), (f"{stem}.1.", "bn1.")] + [
        (f"{prefix}layer{i}.", f"layer{i}.") for i in layers]


def layout(model) -> Layout:
    """``model``'s :class:`Layout`; ``ValueError`` for a model without a
    pretrained encoder (UNet, ENet)."""
    if not hasattr(model, "pretrained_layout"):
        raise ValueError(f"{type(model).__name__} has no pretrained encoder (segtpu "
                         f"trains it from scratch); set arch.args.pretrained to false")
    return model.pretrained_layout()


def checkpoint_id(model) -> Optional[str]:
    """The ``.pth`` file's name, without the extension, that ``model``
    reads (None: the model has no pretrained encoder)."""
    return model.pretrained_layout().file_id if hasattr(model, "pretrained_layout") else None


def file_layout(model) -> Dict[str, Tuple[str, Tuple[int, ...]]]:
    """file key -> (model key, shape in the file) of every tensor that
    ``model`` reads from an original file (a key with fallbacks under its
    own name); FCN8's FC6 and FC7 are 2-D, as torchvision stores them."""
    plan = layout(model)
    out = {}
    for target, value in model.state_dict().items():
        rule = next(((mp, fp) for mp, fp in plan.rules if target.startswith(mp)), None)
        if rule is None or target.endswith("num_batches_tracked"):
            continue
        key, shape = rule[1] + target[len(rule[0]):], tuple(value.shape)
        if plan.reshape and key.startswith("classifier.") and value.dim() == 4:
            shape = (shape[0], value[0].numel())
        out[key] = (target, shape)
    return out


def read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of a ``.pth`` file, on the CPU; a ``"state_dict"`` entry
    is unwrapped, as ``scripts/convert_weights.py`` does."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return sd


def remap(model, sd: Dict[str, torch.Tensor]) -> Dict[str, Tuple[str, torch.Tensor]]:
    """model key -> (file key, tensor) for every tensor of ``sd`` that
    ``model`` reads, by the merge rules of the module docstring."""
    plan = layout(model)
    own = model.state_dict(keep_vars=True)
    out: Dict[str, Tuple[str, torch.Tensor]] = {}
    for key, value in sd.items():
        if key.endswith("num_batches_tracked") or key.startswith(plan.skip):
            continue
        rule = next(((mp, fp) for mp, fp in plan.rules if key.startswith(fp)), None)
        target = None if rule is None else rule[0] + key[len(rule[1]):]
        if target not in own:
            if plan.partial:
                continue
            raise KeyError(f"pretrained key {key!r} has no place in {type(model).__name__} "
                           f"(read as {target!r}; the model's keys start "
                           f"{sorted(own)[:4]}...)")
        out[target] = (key, value)
    for prefix, sources in plan.fallbacks:
        for target in own:
            if (target.startswith(prefix) and target not in out
                    and not target.endswith("num_batches_tracked")):
                src = next((s + target[len(prefix):] for s in sources
                            if s + target[len(prefix):] in sd), None)
                if src is not None:
                    out[target] = (src, sd[src])
    return out


def apply_pretrained(model, path: str):
    """Copies the encoder weights of the ``.pth`` file at ``path`` into
    ``model`` in place (every shape checked before anything is copied);
    returns ``model``."""
    sd = read_state_dict(path)
    plan = layout(model)
    missing = [k for k in plan.required if k not in sd]
    if missing:
        raise ValueError(f"{type(model).__name__}'s pretrained file {path!r} lacks "
                         f"{missing}: {plan.required_why}")
    own = model.state_dict(keep_vars=True)
    fitted = {}
    for target, (key, value) in remap(model, sd).items():
        dest = own[target]
        if (plan.reshape and value.dim() == 2 and dest.dim() == 4
                and value.shape[0] == dest.shape[0] and value.numel() == dest.numel()):
            value = value.reshape(dest.shape)
        if value.shape != dest.shape:
            raise ValueError(f"pretrained shape mismatch at {target!r} (file key "
                             f"{key!r}): model {tuple(dest.shape)} vs checkpoint "
                             f"{tuple(value.shape)}")
        fitted[target] = value
    with torch.no_grad():
        for target, value in fitted.items():
            own[target].copy_(value)
    params = dict(model.named_parameters())
    n = sum(v.numel() for t, v in fitted.items() if t in params)
    logger.info(f"loaded pretrained backbone from {path} ({n:,} params)")
    return model


def resolve_path(model, config: Dict) -> Optional[str]:
    """The ``.pth`` file that ``model`` and ``config`` ask for; None when
    ``pretrained`` is falsy. Raises when the asked-for weights are not
    there."""
    pre = getattr(model, "pretrained", False)
    if not pre:
        return None
    if isinstance(pre, str):
        if not os.path.isfile(pre):
            raise FileNotFoundError(
                f"arch.args.pretrained points at {pre!r}, which is not a file (a "
                f"torchvision or original .pth state dict; segtpu's converted "
                f"orbax directories are not read)")
        return pre
    cid = layout(model).file_id
    root = config.get("pretrained_dir") or os.environ.get("SEGTPU_PRETRAINED_DIR")
    if not root:
        raise RuntimeError(
            f"arch.args.pretrained is true but no weights location is configured. "
            f"Set the config key 'pretrained_dir' (or $SEGTPU_PRETRAINED_DIR) to a "
            f"directory holding '{cid}.pth', pass the file's path in "
            f"arch.args.pretrained, or set pretrained: false.")
    path = os.path.join(root, f"{cid}.pth")
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"pretrained file {path!r} not found: put the original {cid} state dict "
            f"there (see segtpu_torch/pretrained.py for the ids and layouts)")
    return path


def maybe_load_pretrained(model, config: Dict) -> Optional[str]:
    """The Trainer's hook: loads the file that ``model`` asks for; returns
    its path, or None when ``pretrained`` is falsy (a no-op)."""
    path = resolve_path(model, config)
    if path is not None:
        apply_pretrained(model, path)
    return path
