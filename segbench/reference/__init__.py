"""The benchmark's plain reference: the models of its configurations, their
loss and optimizer, and sliding-window prediction, in plain PyTorch,
float32, with no kernel of the program.

A configuration names its model's module here (``"reference"``), which
has ``build(config, precision)``. Nothing here imports the program.
"""

from __future__ import annotations

import importlib

from segbench.reference.layers import set_mask_source
from segbench.reference.precision import PRECISIONS


def build(config: dict, precision: str = "fp32", masks=None):
    """The reference model of ``config`` on the current default device,
    computing in ``precision`` (``"fp32"`` or ``"fp8"``), its dropouts
    drawing their keep masks from ``masks``."""
    module = importlib.import_module(f"segbench.reference.{config['reference']}")
    model = module.build(config, PRECISIONS[precision])
    set_mask_source(model, masks)
    return model
