"""What the benchmark takes from the program: its models, built from a
configuration, holding the benchmark's weights.

Every other use of ``segtpu_torch`` (the train step, the optimizer, the
predictor, the counters) is in the traffic module that exercises it.
"""

from __future__ import annotations

from typing import Dict

import torch

from segbench import reference
from segbench.weights import make_state


def template(config: dict) -> Dict[str, torch.Tensor]:
    """The reference model's state dict on the meta device: the keys and
    shapes that the program's model of ``config`` has too."""
    with torch.device("meta"):
        return reference.build(config).state_dict()


def weights(config: dict, seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """The model state of ``config`` drawn from ``seed`` on ``device``."""
    return make_state(template(config), seed, device, config.get("bn_scale"))


def build_model(config: dict, state: Dict[str, torch.Tensor],
                device: torch.device) -> torch.nn.Module:
    """``segtpu_torch``'s model of ``config`` on ``device`` holding ``state``,
    channels_last on a card (as the port's trainer and ``get_model`` place
    it). It is built on the host, where its own initial draw takes about a
    second (a first build on the meta device took eight on an H100's
    host), and moved to the device empty: ``state`` sets every parameter
    and buffer."""
    from segtpu_torch.models import MODELS

    arch = config["arch"]
    model = MODELS[arch["type"]](config["num_classes"], **arch["args"])
    model = model.to_empty(device=device)
    model.load_state_dict(state)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model
