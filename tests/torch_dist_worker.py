"""The ranks' side of tests/test_torch_distributed.py: every multi-rank case,
run by ``segtpu_torch.core.mesh.launch`` on 2 gloo ranks on the CPU, each
writing its results to ``<out>/<case>-rank<r>.pt``. Imports torch, numpy
and segtpu_torch only (the ranks never load JAX); the test process holds
the results against segtpu and against the single-process port.

Inputs are made with numpy from seeds that the test process repeats; every
global batch is split in rank order, rank r taking rows ``[r*b/2,
(r+1)*b/2)``.
"""

from __future__ import annotations

import os
import signal

import numpy as np
import torch

from segtpu_torch import losses
from segtpu_torch.core import mesh
from segtpu_torch.core.state import TrainState, make_optimizer
from segtpu_torch.core.steps import make_train_step
from segtpu_torch.data.base import BaseDataset, DataLoader
from segtpu_torch.nn.layers import GlobalBatchNorm2d, convert_global_bn

CLASSES = 5
# PSPNet-R18's 1 and 3 steps against segtpu: tests/torch_zoo.py's data
STEP_HW, STEP_BATCH, STEP_STEPS = 33, 8, 3
SGD = dict(optimizer_type="SGD", lr=0.01, momentum=0.9, weight_decay=1e-4,
           scheduler_type="Poly", num_epochs=1, iters_per_epoch=10, differential_lr=True)
BN_SHAPE = (8, 6, 5, 7)
LOSS_SHAPE = (4, CLASSES, 9, 11)
# every name of the port's LOSSES, the exact Lovász per image, and the two
# binary losses
LOSS_CASES = [(name, {}) for name in losses.LOSSES] + [
    ("LovaszSoftmax", {"per_image": True}), ("binary_xloss", {}),
    ("lovasz_hinge", {"per_image": True}), ("lovasz_hinge", {"per_image": False})]
BINARY = {"binary_xloss": losses.binary_xloss, "lovasz_hinge": losses.lovasz_hinge}
# the 12 zoo names at the smallest size each model's tests use: (args, hw)
ZOO = {
    "PSPNet": ({"backbone": "resnet18"}, 33),
    "PSPDenseNet": ({"backbone": "densenet121"}, 33),
    "UperNet": ({"backbone": "resnet18", "fpn_out": 32}, 49),
    "DeepLab": ({"backbone": "resnet18", "output_stride": 16}, 33),
    "DeepLab_DUC_HDC": ({"backbone": "resnet18"}, 65),
    "UNet": ({}, 33),
    "UNetResnet": ({"backbone": "resnet18"}, 65),
    "SegNet": ({}, 33),
    "SegResNet": ({}, 65),
    "ENet": ({}, 33),
    "GCN": ({"backbone": "resnet18"}, 33),
    "FCN8": ({}, 33),
}
ZOO_BATCH = 2  # one image a rank: BN statistics exist only over the ranks
# FCN8's VGG stages as tests/test_torch_fcn.py narrows them
FCN_NARROW = ((8, 8), (8, 8), (16, 16, 16), (16, 16, 16), (16, 16, 16))
LOADER_SIZES = {"train": 23, "val": 11}
LOADER_BATCH = 4


def rows(a, r=None, n=2):
    """Rank r's rows of a global batch (this rank's by default)."""
    r = mesh.rank() if r is None else r
    per = len(a) // n
    return a[r * per:(r + 1) * per]


def no_dropout(model):
    for m in model.modules():
        if isinstance(m, (torch.nn.Dropout, torch.nn.Dropout2d)):
            m.p = 0.0
    return model


def save(out, case, obj):
    torch.save(obj, os.path.join(out, f"{case}-rank{mesh.rank()}.pt"))


# -- inputs, shared with the test process --------------------------------------------

def bn_inputs(dtype):
    rng = np.random.default_rng(3)
    x = rng.normal(1.5, 2.0, size=BN_SHAPE)
    g = rng.normal(size=BN_SHAPE)
    c = BN_SHAPE[1]
    params = (rng.uniform(0.5, 1.5, c), rng.normal(0, 0.1, c),
              rng.normal(0, 0.1, c), rng.uniform(0.5, 1.5, c))
    return [torch.tensor(a, dtype=dtype) for a in (x, g, *params)]


def make_bn(c, params, cls=torch.nn.BatchNorm2d):
    weight, bias, mean, var = params
    bn = cls(c, eps=1e-5, momentum=0.1).to(weight.dtype)
    with torch.no_grad():
        bn.weight.copy_(weight)
        bn.bias.copy_(bias)
        bn.running_mean.copy_(mean)
        bn.running_var.copy_(var)
    return bn


def loss_inputs(binary: bool):
    """Logits and labels whose two halves hold unequal counts of valid
    pixels (rank 1's half is mostly ignored)."""
    rng = np.random.default_rng(5)
    b, c, h, w = LOSS_SHAPE
    logits = rng.normal(size=(b, h, w) if binary else LOSS_SHAPE) * 2
    labels = rng.integers(0, 2 if binary else c, size=(b, h, w))
    labels[:, :2, :3] = 255
    labels[b // 2:, 3:, :] = 255
    labels[b // 2:, :, 8:] = -1 if not binary else 255
    return torch.tensor(logits, dtype=torch.float64), torch.tensor(labels)


def loss_fn(name):
    return BINARY.get(name) or losses.LOSSES[name]


def step_batches():
    """tests/torch_zoo.py's ``batches`` at PSPNet-R18's step size."""
    rng = np.random.default_rng(7)
    out = []
    for _ in range(STEP_STEPS):
        imgs = rng.normal(size=(STEP_BATCH, STEP_HW, STEP_HW, 3))
        labels = rng.integers(0, CLASSES, size=(STEP_BATCH, STEP_HW, STEP_HW)).astype(np.int32)
        labels[:, :5, :5] = 255
        out.append((imgs, labels))
    return out


def zoo_batch(hw):
    rng = np.random.default_rng(11)
    imgs = rng.normal(size=(ZOO_BATCH, hw, hw, 3))
    labels = rng.integers(0, CLASSES, size=(ZOO_BATCH, hw, hw)).astype(np.int32)
    labels[:, :4, :4] = 255
    return imgs, labels


def zoo_model(name):
    from segtpu_torch.backbones import vgg
    from segtpu_torch.models import get_model

    args, _ = ZOO[name]
    prev = vgg.VGG16_STAGES
    if name == "FCN8":
        vgg.VGG16_STAGES = FCN_NARROW
    try:
        model = get_model(name, device="cpu", seed=1, num_classes=CLASSES, **args)
    finally:
        vgg.VGG16_STAGES = prev
    return no_dropout(model).double()


def local_cross_entropy(logits, target, ignore_index=255):
    """The port's CE on this process's batch alone, with no collective:
    torch's mean over the valid pixels."""
    return torch.nn.functional.cross_entropy(logits, target.long(),
                                             ignore_index=ignore_index)


def one_step(model, imgs, labels, data_parallel):
    """One SGD step of ``model``: with ``data_parallel``, on the group
    (global BN, the wrap, the global CE); without, as one process (local
    BN and CE, no wrap). Returns (state, loss, every parameter's
    gradient)."""
    opt, scheds = make_optimizer(model, **SGD)
    state = TrainState(model, opt, scheds)
    if data_parallel:
        convert_global_bn(model)
        state.data_parallel()
    step = make_train_step(losses.cross_entropy if data_parallel else local_cross_entropy,
                           compute_dtype=torch.float64)
    loss, _ = step(state, torch.from_numpy(imgs), torch.from_numpy(labels))
    return state, float(loss), {n: p.grad.clone() for n, p in model.named_parameters()
                                if p.grad is not None}


class IndexDataset(BaseDataset):
    """Sample i is an image and a label filled with i."""

    num_classes = 3
    palette = []

    def __init__(self, size, val, crop_size=4):
        self._size = size
        super().__init__(root="", split="val" if val else "train", mean=[0.5] * 3,
                         std=[0.25] * 3, val=val, crop_size=crop_size,
                         device_normalize=True)

    def _set_files(self):
        self.files = list(range(self._size))

    def get(self, index, rng=None):
        crop = self.crop_size
        return (np.full((crop, crop, 3), index % 256, np.uint8),
                np.full((crop, crop), index, np.int32))


def index_loader(kind, batch=LOADER_BATCH, crop_size=4):
    return DataLoader(IndexDataset(LOADER_SIZES[kind], kind == "val", crop_size), batch,
                      shuffle=kind == "train", num_workers=1, seed=4)


# -- the cases -------------------------------------------------------------------------

def case_bn(out):
    res = {}
    for dtype in (torch.float64, torch.float32):
        x, g, *params = bn_inputs(dtype)
        bn = make_bn(x.shape[1], params, GlobalBatchNorm2d).train()
        xr = rows(x).clone().requires_grad_()
        y = bn(xr)
        (y * rows(g)).sum().backward()
        res[str(dtype)] = {"y": y.detach(), "dx": xr.grad, "dweight": bn.weight.grad,
                           "dbias": bn.bias.grad, "running_mean": bn.running_mean.clone(),
                           "running_var": bn.running_var.clone()}
    save(out, "bn", res)


def case_losses(out):
    res = {}
    for name, kw in LOSS_CASES:
        binary = name in BINARY
        logits, labels = loss_inputs(binary)
        mine = rows(logits).clone().requires_grad_()
        loss = loss_fn(name)(mine, rows(labels), ignore_index=255, **kw)
        loss.backward()
        res[(name, tuple(sorted(kw.items())))] = (loss.detach(), mine.grad)
    save(out, "losses", res)


def case_loader(out):
    """Auto-wired from the group: one node of 2 ranks (a split batch),
    then 2 nodes of 1 (segtpu's host shards)."""
    res = {}
    for local in (2, 1):
        os.environ["LOCAL_WORLD_SIZE"], os.environ["LOCAL_RANK"] = (
            str(local), str(mesh.rank() % local))
        for kind in ("train", "val"):
            loader = index_loader(kind)
            got = []
            for epoch in range(2):
                labels = [lab[:, 0, 0].copy() for _, lab in loader]
                got.append((loader.batch_indices(epoch), labels))
            res[(local, kind)] = (loader.shards(), got)
    os.environ["LOCAL_WORLD_SIZE"], os.environ["LOCAL_RANK"] = "2", str(mesh.rank())
    res["errors"] = []  # a batch the node's 2 ranks cannot split; no static crop
    for kw in ({"batch": 3}, {"crop_size": None}):
        try:
            len(index_loader("val", **kw))
        except ValueError as e:
            res["errors"].append(str(e))
    save(out, "loader", res)


def case_step(out):
    """PSPNet-R18, float64, 3 SGD steps on the global batch of 8."""
    from segtpu_torch.models import get_model

    model = no_dropout(get_model("PSPNet", device="cpu", seed=1, num_classes=CLASSES,
                                 backbone="resnet18")).double()
    convert_global_bn(model)
    opt, scheds = make_optimizer(model, **SGD)
    state = TrainState(model, opt, scheds)
    state.data_parallel()
    step = make_train_step(losses.cross_entropy, compute_dtype=torch.float64)
    snaps, diffs = {}, []
    for i, (imgs, labels) in enumerate(step_batches()):
        loss, _ = step(state, torch.from_numpy(rows(imgs)), torch.from_numpy(rows(labels)))
        sd = {k: v.clone() for k, v in model.state_dict().items()}
        if mesh.is_main() and i + 1 in (1, STEP_STEPS):
            snaps[i + 1] = (loss.numpy(), sd)
        diffs.append(_rank_spread(sd))
    save(out, "step", {"snaps": snaps, "rank_spread": diffs})


def _rank_spread(sd):
    """The largest |this rank - rank 0| over every tensor of ``sd``."""
    worst = 0.0
    for v in sd.values():
        ref = v.clone()
        torch.distributed.broadcast(ref, 0)
        worst = max(worst, float((v.double() - ref.double()).abs().max()))
    return worst


def case_zoo(out):
    """Each model's 2-rank step; and, on the ranks in turn, the same step
    as one process on the whole batch (this process uses no collective for
    it). Records the losses, the model's largest gradient and, for every
    parameter, the largest gradient difference and the largest
    single-process gradient."""
    res = {}
    for i, (name, (_, hw)) in enumerate(ZOO.items()):
        imgs, labels = zoo_batch(hw)
        state, loss, grads = one_step(zoo_model(name), rows(imgs), rows(labels), True)
        # the wrap raises in the next forward where a parameter had no
        # gradient in the last backward
        state.train_module(torch.from_numpy(rows(imgs)).permute(0, 3, 1, 2))
        res[name] = {"loss": loss, "n_grads": len(grads),
                     "model_scale": max(float(g.abs().max()) for g in grads.values()),
                     "n_params": sum(1 for p in state.model.parameters() if p.requires_grad)}
        if i % 2 == mesh.rank():
            _, ref_loss, ref = one_step(zoo_model(name), imgs, labels, False)
            res[name].update(ref_loss=ref_loss, ref_n_grads=len(ref), errors={
                n: (float((grads[n] - g).abs().max()), float(g.abs().max()))
                for n, g in ref.items()})
    save(out, "zoo", res)


def trainer_config(root, epochs=2, train_size=8, **trainer):
    synthetic = {"batch_size": 4, "num_classes": 3, "crop_size": 33,
                 "num_workers": 1, "device_normalize": True}
    return {
        "name": "TinyDP", "seed": 0,
        "arch": {"type": "PSPNet", "args": {"backbone": "resnet18"}},
        "train_loader": {"type": "Synthetic", "args": {
            **synthetic, "size": train_size, "image_hw": 40, "flip": True}},
        "val_loader": {"type": "Synthetic", "args": {
            **synthetic, "size": 5, "image_hw": 33, "val": True,
            "augment": False, "shuffle": False}},
        "optimizer": {"type": "SGD", "differential_lr": True,
                      "args": {"lr": 0.01, "weight_decay": 1e-4, "momentum": 0.9}},
        "loss": "CrossEntropyLoss2d", "ignore_index": 255,
        "lr_scheduler": {"type": "Poly", "args": {}},
        "trainer": {"epochs": epochs, "log_per_iter": 1, "val": True, "save_period": 1,
                    "monitor": "max Mean_IoU", "compute_dtype": "float32",
                    "save_dir": os.path.join(root, "saved"),
                    "log_dir": os.path.join(root, "runs"), **trainer},
    }


def port_trainer(cfg, resume=None):
    from segtpu_torch.data import DATASETS
    from segtpu_torch.models import get_model
    from segtpu_torch.trainer import Trainer
    from segtpu_torch.utils.logger import Logger

    model = no_dropout(get_model("PSPNet", device="cpu", num_classes=3, backbone="resnet18"))
    loaders = [DATASETS["Synthetic"](**cfg[k]["args"]) for k in ("train_loader", "val_loader")]
    return Trainer(model, cfg["loss"], cfg, *loaders, device="cpu", resume=resume,
                   train_logger=Logger())


def state_of(trainer):
    return {"model": {k: v.clone() for k, v in trainer.model.state_dict().items()},
            "optimizer": trainer.state.optimizer.state_dict(), "step": trainer.state.step}


def case_trainer(out):
    """Two epochs with ``devices: 2``, then a resume from the last
    checkpoint on the 2 ranks."""
    cfg = trainer_config(os.path.join(out, "trainer"), devices=2)
    trainer = port_trainer(cfg)
    step, step_losses = trainer.train_step, []

    def recorded(*args):
        loss, stats = step(*args)
        step_losses.append(float(loss))
        return loss, stats

    trainer.train_step = recorded
    history = trainer.train()
    ckpt = os.path.join(trainer.checkpoint_dir, "checkpoint-epoch2")
    res = {"history": history, "step_losses": step_losses, "checkpoint_dir": trainer.checkpoint_dir,
           "writer": trainer.writer is not None, "logger": trainer.train_logger is not None,
           "bn": sum(isinstance(m, GlobalBatchNorm2d) for m in trainer.model.modules()),
           "final": state_of(trainer), "final_spread": _rank_spread(trainer.model.state_dict())}
    cfg["trainer"]["tensorboard"] = False
    resumed = port_trainer(cfg, resume=ckpt)
    res["resumed"] = state_of(resumed)
    res["resumed_spread"] = _rank_spread(resumed.model.state_dict())
    res["resumed_epoch"] = resumed.start_epoch
    save(out, "trainer", res)


def case_sigterm(out):
    """Rank 1 alone has a SIGTERM during its second step."""
    cfg = trainer_config(os.path.join(out, "sigterm"), train_size=16, devices=2,
                         tensorboard=False)
    trainer = port_trainer(cfg)
    step, calls = trainer.train_step, [0]

    def signalled_step(*args):
        calls[0] += 1
        if mesh.rank() == 1 and calls[0] == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return step(*args)

    trainer.train_step = signalled_step
    trainer.train()
    save(out, "sigterm", {"preempted": str(trainer.preempted), "steps": calls[0],
                          "step": trainer.state.step,
                          "checkpoint_dir": trainer.checkpoint_dir})


CASES = {"bn": case_bn, "losses": case_losses, "loader": case_loader,
         "step": case_step, "zoo": case_zoo, "trainer": case_trainer,
         "sigterm": case_sigterm}


def run_cases(device, out, names):
    """Every case of ``names`` on this rank, in order."""
    torch.set_num_threads(1)
    for name in names:
        CASES[name](out)
        mesh.barrier()


def build_once(root):
    """``segtpu_torch.ops.build.build_all`` of ``<root>/csrc/k.cu`` into
    ``<root>/build`` with the nvcc ``<root>/nvcc``."""
    from pathlib import Path

    from segtpu_torch.ops import build

    build.CSRC = Path(root) / "csrc"
    build.BUILD_DIR = Path(root) / "build"
    build._nvcc = lambda: os.path.join(root, "nvcc")
    build.build_all(["k"])
