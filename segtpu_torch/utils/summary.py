"""Model summaries: parameter counts per module and in total.

Counterpart of ``segtpu/utils/summary.py``, over ``named_parameters()`` and
the BatchNorm running statistics (``running_mean``, ``running_var``; segtpu
has no ``num_batches_tracked``, and FCN8's fixed upsampling kernels are no
statistic). The rows are the port's own module names; the totals are
segtpu's for the same model.
"""

from __future__ import annotations

from typing import Dict

from torch import nn

_STATS = ("running_mean", "running_var")


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def count_bn_stats(model: nn.Module) -> int:
    return sum(b.numel() for name, b in model.named_buffers()
               if name.rsplit(".", 1)[-1] in _STATS)


def summary(model: nn.Module, max_depth: int = 1) -> str:
    """A table of the parameter counts of the modules ``max_depth`` names
    deep, the total, and the BN running statistics where there are any."""
    groups: Dict[str, int] = {}
    for name, p in model.named_parameters():
        key = "/".join(name.split(".")[:max_depth])
        groups[key] = groups.get(key, 0) + p.numel()
    lines = ["-" * 52, f"{'Module':<36}{'Params':>16}", "-" * 52]
    for key in sorted(groups):
        lines.append(f"{key:<36}{groups[key]:>16,}")
    lines += ["-" * 52, f"{'Trainable params':<36}{sum(groups.values()):>16,}"]
    n_stats = count_bn_stats(model)
    if n_stats:
        lines.append(f"{'BatchNorm running stats':<36}{n_stats:>16,}")
    lines.append("-" * 52)
    return "\n".join(lines)


def describe(model: nn.Module) -> str:
    return (f"{type(model).__name__}\nNbr of trainable parameters: "
            f"{count_params(model):,}")
