"""The frozen reference against the port, float32 on the CPU, at a small
crop: logits, loss, every gradient and the SGD update of PSPNet-R50 and
UperNet-R101, and the sliding-window class map of a small frame."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from segbench import program, reference
from segbench.cells import Cell
from segbench.reference import sliding
from segbench.reference import train as ref_train

CPU = torch.device("cpu")
TRAIN_CELLS = ["pspnet_r50.train_b8_769", "upernet_r101.train_b8_769"]
# float32 on both sides, the same kernels but for the summation order of the
# gradients; the stem's weight gradient in the port sums bf16-rounded x and
# dy by design (segtpu's kernel), so it is held at bf16's rounding
GRAD_RTOL, STEM_RTOL = 1e-3, 2e-2


@pytest.fixture(autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def _state(config, seed=3):
    return program.weights(config, seed, CPU)


@pytest.mark.parametrize("name", ["pspnet_r50.train_b8_769", "upernet_r101.train_b8_769"])
def test_eval_logits_match(name):
    config = Cell(name).config
    state = _state(config)
    port = program.build_model(config, state, CPU).eval()
    ref = reference.build(config).eval()
    ref.load_state_dict(state)
    x = torch.randn(2, 3, 65, 97, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got, want = port(x)["out"], ref(x)["out"]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_train_step_matches(name):
    from segtpu_torch import losses
    from segtpu_torch.core import state as state_lib
    from segtpu_torch.core import steps

    cell = Cell(name)
    config, t = cell.config, cell.traffic
    state = _state(config)
    port = program.build_model(config, state, CPU)
    opt, schedules = state_lib.make_optimizer(
        port, "SGD", differential_lr=True, scheduler_type="Poly",
        num_epochs=t["lr_scheduler"]["epochs"],
        iters_per_epoch=t["lr_scheduler"]["iters_per_epoch"], **t["optimizer"]["args"])
    train_state = state_lib.TrainState(port, opt, schedules)
    step = steps.make_train_step(losses.get_loss(t["loss"]), aux_weight=t["aux_weight"],
                                 compute_dtype=torch.float32,
                                 norm_stats=(config["norm_stats"]["mean"],
                                             config["norm_stats"]["std"]))
    kind = cell.kind_module()
    small = {**t, "batch": 2, "crop": 65, "label_block": 8, "ring": 1}
    images, labels = kind.make_batches(small, config, 5, CPU)[0]
    tape = kind._MaskTape(5, t["dropout_p"], recorded=True)
    hooks = [m.register_forward_hook(tape.hook(n)) for n, m in port.named_modules()
             if isinstance(m, torch.nn.Dropout)]
    loss, _ = step(train_state, images, labels)
    for h in hooks:
        h.remove()

    ref = reference.build(config, masks=tape.source)
    ref.load_state_dict(state)
    sgd = ref_train.SGD(ref, **{k: t["optimizer"]["args"][k] for k in ("lr", "momentum")},
                        weight_decay=t["optimizer"]["args"]["weight_decay"],
                        total_updates=kind.total_updates(t))
    ref.train()
    ref_loss = ref_train.loss_of(ref(kind.normalize(images, config)), labels, t["aux_weight"])
    ref_loss.backward()
    grads = {n: p.grad.clone() for n, p in ref.named_parameters()}
    sgd.step()
    torch.testing.assert_close(loss, ref_loss.detach(), rtol=1e-5, atol=0)
    stem = next(iter(grads))
    for n, p in port.named_parameters():
        g = opt.state[p]["momentum_buffer"] - t["optimizer"]["args"]["weight_decay"] * state[n]
        rtol = STEM_RTOL if n == stem else GRAD_RTOL
        torch.testing.assert_close(g, grads[n], rtol=rtol,
                                   atol=rtol * grads[n].abs().max().item(), msg=n)
    for (n, p), (_, q) in zip(port.named_parameters(), ref.named_parameters()):
        rtol = STEM_RTOL if n == stem else GRAD_RTOL
        want = q.detach() - state[n]
        # the change is read from p - p0, so at p's float32 resolution
        ulp = torch.finfo(torch.float32).eps * state[n].abs().max().item()
        torch.testing.assert_close(p.detach() - state[n], want, rtol=rtol,
                                   atol=rtol * want.abs().max().item() + 4 * ulp, msg=n)


def test_sliding_class_map_matches():
    from segtpu_torch import inference_lib

    config = Cell("pspnet_r50.eval_sliding_1024x2048").config
    state = _state(config)
    port = program.build_model(config, state, CPU)
    predict = inference_lib.make_predictor(port, compute_dtype=torch.float32, device="cpu")
    ref = reference.build(config).eval()
    ref.load_state_dict(state)
    frame = np.random.default_rng(0).normal(size=(64, 160, 3)).astype(np.float32)
    got = inference_lib.sliding_predict(predict, frame, 19, flip=True, max_tile_batch=4,
                                         class_map=True)
    canvas = sliding.canvas(ref, torch.from_numpy(frame).permute(2, 0, 1), 19)
    assert len(sliding.tile_boxes(64, 160)[2]) == len(inference_lib._tile_boxes(
        64, 160, 2.5, 1 / 3)[2])
    assert sliding.tile_boxes(1024, 2048)[:2] == (409, 819)
    assert len(sliding.tile_boxes(1024, 2048)[2]) == 24
    kind = Cell("pspnet_r50.eval_sliding_1024x2048").kind_module()
    assert kind.classmap_gap(canvas, got) < 1e-4
    wrong = got.copy()
    wrong[:8, :8] = (wrong[:8, :8] + 1) % 19
    assert kind.classmap_gap(canvas, wrong) > 1e-3
