"""The reference's training step: cross-entropy with an aux term, and SGD
as ``torch.optim.SGD`` defines it, written out.

The loss is ``F.cross_entropy`` (mean over the pixels whose label is not
``ignore_index``) of the output, plus ``aux_weight`` times that of the aux
output where the model gives one: the original repo's
``CrossEntropyLoss2d`` and its trainer's aux term.

SGD over two groups, the decoder at the schedule's rate and the backbone
(``model.backbone_modules``) at a tenth of it, Poly decay
``lr * (1 - (t + 1) / total) ** 0.9`` at update t (counting from 0), weight
decay and momentum as torch's SGD: ``d = g + wd * p``; the first update's
buffer is ``d``, later ones ``momentum * buf + d``; ``p -= rate * buf``.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F


def loss_of(outputs: dict, labels: torch.Tensor, aux_weight: float,
            ignore_index: int = 255) -> torch.Tensor:
    target = labels.long()
    loss = F.cross_entropy(outputs["out"], target, ignore_index=ignore_index)
    if "aux" in outputs:
        loss = loss + aux_weight * F.cross_entropy(outputs["aux"], target,
                                                   ignore_index=ignore_index)
    return loss


def poly_rate(lr: float, total: int, step: int, power: float = 0.9) -> float:
    return lr * max(1.0 - (step + 1.0) / total, 0.0) ** power


class SGD:
    def __init__(self, model: torch.nn.Module, lr: float, momentum: float,
                 weight_decay: float, total_updates: int):
        self.params = dict(model.named_parameters())
        backbone = tuple(f"{m}." for m in model.backbone_modules)
        self.scale = {n: 0.1 if n.startswith(backbone) else 1.0 for n in self.params}
        self.lr, self.momentum, self.wd = lr, momentum, weight_decay
        self.total = total_updates
        self.buffers: Dict[str, torch.Tensor] = {}
        self.step_count = 0

    @torch.no_grad()
    def step(self) -> None:
        rate = poly_rate(self.lr, self.total, self.step_count)
        for name, p in self.params.items():
            d = p.grad + self.wd * p
            buf = self.buffers.get(name)
            buf = d.clone() if buf is None else buf.mul_(self.momentum).add_(d)
            self.buffers[name] = buf
            p.sub_(rate * self.scale[name] * buf)
        self.step_count += 1


def train_step(model, opt: SGD, x: torch.Tensor, labels: torch.Tensor,
               aux_weight: float) -> float:
    """One forward, backward and update; the loss."""
    model.train()
    for p in model.parameters():
        p.grad = None
    loss = loss_of(model(x), labels, aux_weight)
    loss.backward()
    opt.step()
    return loss.item()
