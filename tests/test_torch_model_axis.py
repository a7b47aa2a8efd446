"""segtpu's model axis in the port: tensor parallelism and spatial sharding
on 4 gloo ranks on the CPU (segtpu's 2 x 2 mesh: data 2 x model 2), against
segtpu on 4 of the virtual CPU devices and against the port as one process
on the whole batch.

One module fixture starts the 4 ranks once (``segtpu_torch.core.mesh.
launch``) to run every case of ``tests/torch_axis_worker.py``; while they
run, this process computes segtpu's side. The checks:

* Layout: rank r's (data, model) place is that of device r in segtpu's
  ``make_mesh`` grid at model_parallel 2 and 4; the groups, the node's rows
  (split over the data ranks only) and the errors segtpu raises.
* Halo ops on a 13-row map split 6 / 7: convs (k 1 to 7, dilation 1 to 4,
  stride 1 and 2), the stem kernel's conv and the space-to-depth stem (k 3
  and 7), max pools (stride 1 and 2, padded, ceil mode), bilinear
  resizes (both ``align_corners`` modes, up and down, odd and even sizes,
  from a sharded and from a replicated source) and the PSP bins equal the
  unsharded op, output, input gradient and weight gradient, within 1e-12
  relative (float64); so do this slice's ops (``w.BAND_OPS``): depthwise
  convs, DenseNet's module average and max pools, ASPP's image pool, the
  pixel shuffle, global-row crops, SegNet's and SegResNet's argmax pool
  and unpool pairs (SegResNet's with indices that cross the boundary and
  repeat there, and tied windows), two narrow Xception blocks and the
  top-left pad-or-crop a row each way across the boundary; and transposed
  convs whose windows overlap in H (k 3/s 2/p 1/output padding 1, k 4/s
  2/p 1, k 4/s 2/p 0, k 16/s 8/p 0; uneven, even and one-row bands), one
  of them column-parallel. Column-parallel convs (a depthwise one, a
  transposed one) under TP alone likewise.
* Collective axes: ``GlobalBatchNorm2d`` under TP takes the data batch's
  count (its unbiased running variance is the whole batch's), under
  spatial sharding the world's, and on replicated maps the data group's;
  every loss under spatial sharding, the exact Lovász per image included,
  is the whole batch's, value and logits gradient.
* TP step: PSPNet-R18, float64, 1 and 3 SGD steps with its convs of 256 or
  more channels sharded, against segtpu's ``make_train_step`` with
  ``tp_sharding_tree`` on the 2 x 2 mesh from the same weights, with
  ``tests/torch_zoo.py``'s tolerances; the sharded convs are segtpu's; the
  ranks' weights and running statistics equal bit for bit after every step.
* TP zoo: each of the 12 names takes a TP step (convs of 16 or more
  channels sharded) whose gradients are one process's on the whole batch
  within 1e-8 relative (float64), as in tests/test_torch_distributed.py.
* Spatial steps: every zoo name (PSPNet-R18, UNet, UperNet-R18,
  PSPDenseNet-121, DeepLab-R18, DeepLab_DUC_HDC-R18, SegNet, SegResNet,
  UNetResnet-R18, ENet, GCN-R18 with ``use_deconv``, FCN8 on narrowed VGG
  stages and FC layers; ``w.SPATIAL_CASES``) at H that split unevenly and
  evenly, float64, 1 and 3 SGD steps and an eval step (its loss, and its
  seg stats exactly) against one process (1e-8), and against segtpu's
  ``make_train_step(spatial=True)`` on the 2 x 2 mesh at a size where
  segtpu's spatial step agrees with its unsharded one (SEG_SPATIAL; ENet,
  GCN and FCN8, whose port cases are at odd H, one step at another size,
  FCN8's FC6 and FC7 4096 wide as segtpu's); each rank's activations have
  its band's height; PSPDenseNet's ``remat_backbone`` recomputes on the
  bands; ``check_model`` gives each of the twelve its stride and raises
  for a model without one.
* Trainer: segtpu's ``test_trainer_parallelism_from_config`` config
  (UNet, devices 4, model_parallel 2, spatial, remat) against segtpu's
  Trainer: each step's loss within 1e-4 relative, the val metrics within
  one unit of their rounding; the checkpoint resumes on 1 rank and on 4 to
  the same state bit for bit; the val grid shows whole images.
"""

import glob
import os
import shutil
import sys
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_axis_worker as w
import torch_dist_worker as dw
from segtpu import losses as seg_losses
from segtpu.backbones import vgg as seg_vgg
from segtpu.core import state as seg_state
from segtpu.core.mesh import MODEL_AXIS, make_mesh, shard_state, tp_sharding_tree
from segtpu.core.steps import make_eval_step as seg_make_eval_step
from segtpu.core.steps import make_train_step as seg_make_train_step
from segtpu.data.synthetic import Synthetic as SegtpuSynthetic
from segtpu.models import get_model as seg_get_model
from segtpu.models.unet import UNet as SegtpuUNet
from segtpu.trainer import Trainer as SegtpuTrainer
from segtpu.utils.weight_convert import MODEL_CONVERTERS
from segtpu_torch.core import mesh, spatial
from segtpu_torch.models import get_model
from segtpu_torch.ops.pooling import adaptive_avg_pool_multi
from segtpu_torch.utils import weight_convert as wc
from torch_parity import segtpu_float64, state_dict64
from torch_zoo import TOL, TOL64, assert_step_matches

torch.set_num_threads(1)
OP_TOL = 1e-12
BN_TOL = 1e-12
LOSS_TOL = 1e-12
STEM_WGRAD_TOL = 1e-5
GRAD_FLOOR = 1e-4  # as tests/test_torch_distributed.py's
BAND_GRAD_FLOOR = 1e-2
CONVERT = {"PSPNet": wc.pspnet_state_dict_from_segtpu, "UNet": wc.unet_state_dict_from_segtpu,
           "UperNet": wc.upernet_state_dict_from_segtpu,
           "PSPDenseNet": wc.pspdensenet_state_dict_from_segtpu,
           "DeepLab": wc.deeplab_state_dict_from_segtpu,
           "DeepLab_DUC_HDC": wc.duc_hdc_state_dict_from_segtpu,
           "SegNet": wc.segnet_state_dict_from_segtpu,
           "SegResNet": wc.segresnet_state_dict_from_segtpu,
           "UNetResnet": wc.unet_resnet_state_dict_from_segtpu,
           "ENet": wc.enet_state_dict_from_segtpu, "GCN": wc.gcn_state_dict_from_segtpu,
           "FCN8": wc.fcn8_state_dict_from_segtpu}
# segtpu's spatial step takes an H that its model axis divides. Where the
# smallest map has 2 rows, one a device (UNet, UperNet and DeepLab at 32,
# SegResNet at 64), its spatial step on the 2 x 2 mesh is not its unsharded
# one (BN biases move by 100% of their value or more; the port's spatial
# step is the unsharded one there too): each model is held at a size where
# segtpu's two agree after a step (to 3e-7 of a tensor, and 3e-9 of its
# change, or closer; SegResNet at 80 and 128); PSPNet and UNet 3 steps and
# the eval step, the others one step. segtpu's GCN (k 11: 5-row halos)
# misupdates too wherever its stride-32 map holds no more rows a device
# than the halo (R18 with use_deconv at 64, 96, 128, 256 and 320; with k 5
# at 128): it is held at 384 (6 rows a device), where segtpu's two agree
# to 2.6e-14
SEG_SPATIAL = w.SEG_CASES
SEG_EVAL = SEG_SPATIAL[:2]


def rel(got, want):
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _seg_model(name):
    """segtpu's model at tests/torch_dist_worker.py's small configuration
    (with the spatial cases' args)."""
    return seg_get_model(name, num_classes=w.CLASSES, **dw.ZOO[name][0],
                         **w.SPATIAL_ARGS.get(name, {}))


def _seg_variables(name, port):
    args = dw.ZOO[name][0]
    backbone = args.get("backbone", "")
    key = "DeepLab-resnet" if name == "DeepLab" and "resnet" in backbone else name
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    params, stats = MODEL_CONVERTERS[key](sd, **({"arch": backbone} if backbone else {}))
    if "FPN.lateral_p0.weight" in sd:  # outside the original layout: not converted
        params["fpn"]["lateral_p0"] = {
            "kernel": sd["FPN.lateral_p0.weight"].transpose(2, 3, 1, 0),
            "bias": sd["FPN.lateral_p0.bias"]}
    return params, stats


# -- segtpu's side, computed while the ranks run ------------------------------------

def _seg_steps(name, batches, jmesh, spatial_=False, tp=False, eval_batch=None):
    """segtpu's model after each float64 SGD step on ``jmesh``, from the
    port's seeded weights (``w.seg_case_model``), in the port's layout; then
    an eval step. FCN8's VGG stages are narrowed as the port's."""
    params, stats = _seg_variables(name, w.seg_case_model(name))
    convert = CONVERT[name]
    out = {}
    with segtpu_float64(), pytest.MonkeyPatch.context() as mp:
        if name == "FCN8":
            mp.setattr(seg_vgg, "VGG16_STAGES", dw.FCN_NARROW)
        params, stats = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                               (params, stats))
        tx, _ = seg_state.make_optimizer_with_schedules(**w.SGD)
        jstate = seg_state.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                      batch_stats=stats, opt_state=tx.init(params), tx=tx)
        tree = None
        if tp:
            tree = tp_sharding_tree(jmesh, jstate)
            jstate = shard_state(jmesh, jstate, tree)
            out["sharded"] = jax.tree_util.tree_map(
                lambda s: MODEL_AXIS in tuple(s.spec), tree.params)
        jstep = seg_make_train_step(_seg_model(name), seg_losses.cross_entropy, w.CLASSES,
                                    compute_dtype=jnp.float64, mesh=jmesh, spatial=spatial_,
                                    state_sharding=tree)
        snaps = [(None, state_dict64(convert, *jax.tree_util.tree_map(
            np.asarray, (params, stats))))]
        for imgs, labels in batches:
            jstate, loss, _ = jstep(jstate, jnp.asarray(imgs), jnp.asarray(labels),
                                    jax.random.PRNGKey(0))
            p, s = jax.tree_util.tree_map(np.asarray, (jstate.params, jstate.batch_stats))
            snaps.append((np.asarray(loss), state_dict64(convert, p, s)))
        out["snaps"] = snaps
        if eval_batch is not None:
            estep = seg_make_eval_step(_seg_model(name), seg_losses.cross_entropy,
                                       w.CLASSES, compute_dtype=jnp.float64, mesh=jmesh,
                                       spatial=spatial_)
            loss, stats_ = estep(jstate, *(jnp.asarray(a) for a in eval_batch))
            out["eval"] = (float(loss), [np.asarray(t) for t in stats_])
    return out


class _Entries:
    def __init__(self):
        self.entries = []

    def add_entry(self, entry):
        self.entries.append(entry)


def segtpu_trainer_run(root):
    """segtpu's Trainer with the model axis keys, from the port's seeded
    UNet: (every step's loss, its epoch logs)."""
    cfg = w.trainer_config(root, progress_bar=False, **w.AXIS_KEYS)
    port = get_model("UNet", device="cpu", num_classes=6)
    params, stats = MODEL_CONVERTERS["UNet"]({k: v.numpy() for k, v in
                                              port.state_dict().items()})
    logs = _Entries()
    seg = SegtpuTrainer(SegtpuUNet(num_classes=6), "CrossEntropyLoss2d", cfg,
                        *(SegtpuSynthetic(**cfg[k]["args"])
                          for k in ("train_loader", "val_loader")),
                        train_logger=logs, compute_dtype=jnp.float32)
    seg.state = seg.state.replace(
        params=jax.device_put(jax.tree_util.tree_map(jnp.asarray, params),
                              seg.state_sharding.params),
        batch_stats=jax.device_put(jax.tree_util.tree_map(jnp.asarray, stats),
                                   seg.state_sharding.batch_stats))
    step, losses_ = seg.train_step, []

    def recorded(*args):
        out = step(*args)
        losses_.append(float(out[1]))
        return out

    seg.train_step = recorded
    seg.train()
    return losses_, logs.entries


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case's results, by case and rank, and segtpu's side."""
    out = str(tmp_path_factory.mktemp("axis"))
    failed = []

    def launch():
        try:
            mesh.launch(w.run_cases, (out, list(w.CASES)), ["cpu"] * w.WORLD, timeout=600)
        except BaseException as e:  # raised in the test below
            failed.append(e)

    thread = threading.Thread(target=launch)
    thread.start()
    jmesh = make_mesh(jax.devices()[:4], model_parallel=2)
    seg = {"tp_step": _seg_steps("PSPNet", dw.step_batches(), jmesh, tp=True),
           "trainer": segtpu_trainer_run(os.path.join(out, "segtpu"))}
    for name, hw in SEG_SPATIAL:
        data = w.spatial_batches(hw)
        if (name, hw) in SEG_EVAL:
            seg[(name, hw)] = _seg_steps(name, data[:-1], jmesh, spatial_=True,
                                         eval_batch=data[-1])
        else:
            seg[(name, hw)] = _seg_steps(name, data[:1], jmesh, spatial_=True)
    thread.join(timeout=1200)
    assert not thread.is_alive() and not failed, failed
    got = {case: [torch.load(os.path.join(out, f"{case}-rank{r}.pt"), weights_only=False)
                  for r in range(w.WORLD)] for case in [*w.CASES, "seconds"]}
    yield got, seg, out
    # the ranks' results and checkpoints take gigabytes (float64 UNet
    # states); pytest keeps its last temp trees
    shutil.rmtree(out, ignore_errors=True)


def _model_groups(results):
    """The ranks' results by model group: [[rank 0, rank 1], [rank 2, rank 3]]."""
    return [results[d * w.MP:(d + 1) * w.MP] for d in range(w.WORLD // w.MP)]


# -- layout ----------------------------------------------------------------------------

@pytest.mark.parametrize("mp", [2, 4])
def test_layout_is_segtpus_mesh(ranks, mp):
    grid = np.vectorize(lambda d: d.id)(make_mesh(jax.devices()[:4], model_parallel=mp)
                                        .devices)
    for r, res in enumerate(ranks[0]["layout"]):
        got = res[mp]
        (d,), (m,) = np.nonzero(grid == r)
        assert (got["data_index"], got["model_index"]) == (d, m)
        assert got["model_ranks"] == list(grid[d]) and got["data_ranks"] == list(grid[:, m])
        per = 8 // (4 // mp)  # the node's batch over its data ranks
        assert got["local_rows"] == (d * per, (d + 1) * per)


def test_layout_raises_where_segtpu_does(ranks):
    for res in ranks[0]["layout"]:
        div, sp = res["errors"]
        assert "does not divide the 4 device(s)" in div
        assert "need a mesh with a >1 'model' axis" in sp
        assert res["none"] == (1, None, None)


# -- halo ops --------------------------------------------------------------------------

def _full_op(x_np, fn, g_fn, params=()):
    x = torch.from_numpy(x_np).clone().requires_grad_()
    y = fn(x)
    (y * torch.from_numpy(g_fn(tuple(y.shape)))).sum().backward()
    return y.detach(), x.grad, [p.grad for p in params]


def _assert_sharded(got_group, want, replicated=False, tol=OP_TOL, grad_tol=OP_TOL,
                    grad_floor=0.0):
    """A model group's (y, dx, param grads) against the whole op's; each
    gradient relative to the larger of its largest value and
    ``grad_floor`` times the op's largest gradient."""
    y, dx, grads = want
    if replicated:
        for g in got_group:
            assert rel(g[0], y) < tol
    else:
        assert rel(torch.cat([g[0] for g in got_group], 2), y) < tol
    assert rel(torch.cat([g[1] for g in got_group], 2), dx) < tol
    floor = grad_floor * max((float(g.abs().max()) for g in grads), default=0.0)
    for i, want_g in enumerate(grads):
        got_g = sum(g[2][i] for g in got_group)
        scale = max(float(want_g.abs().max()), floor, 1e-30)
        assert float((got_g - want_g).abs().max()) / scale < grad_tol, i


@pytest.mark.parametrize("case", list(enumerate(w.CONV_CASES)),
                         ids=[f"k{k}-d{d}-s{s}" for k, d, s in w.CONV_CASES])
def test_halo_conv_is_the_whole_conv(ranks, case):
    i, (k, d, s) = case
    x, wt, b, rng = w.op_inputs("conv", i)
    conv = w.conv_module(k, d, s, wt, b)
    want = _full_op(x, conv, lambda shape: rng.normal(size=shape), [conv.weight, conv.bias])
    for group in _model_groups(ranks[0]["ops"]):
        _assert_sharded([g[("conv", k, d, s)] for g in group], want)


@pytest.mark.parametrize("case", list(enumerate(w.STEM_CASES)),
                         ids=[f"{n}-k{k}" for n, k in w.STEM_CASES])
def test_stem_conv_on_a_band_is_the_whole_conv(ranks, case):
    """The stem kernel's conv (its plain version on the CPU: dx is zero, as
    the kernel's) and the space-to-depth stem on each band."""
    i, (name, k) = case
    x, wt, _, rng = w.op_inputs("stem", i)
    stem = w.stem_module(name, k, wt)
    want = _full_op(x, stem, lambda shape: rng.normal(size=shape), [stem.weight])
    # the kernel's dW sums bf16-rounded products in fp32: the bands' sums
    # take another order
    grad_tol = STEM_WGRAD_TOL if name == "StemConv2d" else OP_TOL
    for group in _model_groups(ranks[0]["ops"]):
        _assert_sharded([g[("stem", name, k)] for g in group], want, grad_tol=grad_tol)


@pytest.mark.parametrize("case", list(enumerate(w.POOL_CASES)),
                         ids=[f"k{k}-s{s}-p{p}-{'ceil' if c else 'floor'}"
                              for k, s, p, c in w.POOL_CASES])
def test_halo_max_pool_is_the_whole_pool(ranks, case):
    i, (k, s, p, ceil) = case
    x, _, _, rng = w.op_inputs("pool", i)
    want = _full_op(x, lambda t: F.max_pool2d(t, k, s, p, ceil_mode=ceil),
                    lambda shape: rng.normal(size=shape))
    for group in _model_groups(ranks[0]["ops"]):
        _assert_sharded([g[("pool", k, s, p, ceil)] for g in group], want)


@pytest.mark.parametrize("case", list(enumerate(w.RESIZE_CASES)),
                         ids=[f"{h}x{wd}-{'ac' if ac else 'half'}-{'rep' if r else 'sharded'}"
                              for h, wd, ac, r in w.RESIZE_CASES])
def test_resize_is_the_whole_resize(ranks, case):
    i, (h, wd, ac, rep) = case
    x, _, _, rng = w.op_inputs("resize", i)
    key = ("resize", h, wd, ac, rep)
    if rep is None:
        want = _full_op(x, lambda t: F.interpolate(t, size=(h, wd), mode="bilinear",
                                                   align_corners=ac),
                        lambda shape: rng.normal(size=shape))
        for group in _model_groups(ranks[0]["ops"]):
            _assert_sharded([g[key] for g in group], want)
        return
    src = torch.from_numpy(x[:, :, :rep, :rep]).clone().requires_grad_()
    y = F.interpolate(src, size=(h, wd), mode="bilinear", align_corners=ac)
    (y * torch.from_numpy(rng.normal(size=(2, 3, h, wd)))).sum().backward()
    for group in _model_groups(ranks[0]["ops"]):
        got = [g[key] for g in group]
        assert rel(torch.cat([g[0] for g in got], 2), y.detach()) < OP_TOL
        # each rank's rows carry a part of the replicated source's gradient
        assert rel(got[0][1] + got[1][1], src.grad) < OP_TOL


def test_psp_bins_are_the_whole_images(ranks):
    x, _, _, rng = w.op_inputs("pool_bins", 0)
    g = rng.normal(size=(2, 3, sum(s * s for s in w.BINS), 1))

    def bins(t):
        return torch.cat([p.flatten(2) for p in adaptive_avg_pool_multi(t, w.BINS)],
                         2).unsqueeze(-1)

    want = _full_op(x, bins, lambda shape: g)
    for group in _model_groups(ranks[0]["ops"]):
        _assert_sharded([r["bins"] for r in group], want, replicated=True)


def test_psp_bins_of_a_short_band_are_the_whole_images(ranks):
    """UperNet's bins on a 3-row map split 2 / 1 (its stride-16 map at
    H=48): the ranks' partial sums, which the einsum lays out in other
    strides, are summed element by element."""
    x, _, _, rng = w.op_inputs("pool_bins", 1)
    x = x[:, :, :3, :3].copy()
    g = rng.normal(size=(2, 3, sum(s * s for s in w.BINS_SHORT), 1))

    def bins(t):
        return torch.cat([p.flatten(2) for p in adaptive_avg_pool_multi(t, w.BINS_SHORT)],
                         2).unsqueeze(-1)

    want = _full_op(x, bins, lambda shape: g)
    for group in _model_groups(ranks[0]["ops"]):
        _assert_sharded([r["bins_short"] for r in group], want, replicated=True)


@pytest.mark.parametrize("name", w.BAND_OPS)
def test_band_op_is_the_whole_op(ranks, name):
    """This slice's ops over the bands: output, input gradient and weight
    gradient of the unsharded op (SegResNet's unpool with writes that cross
    the boundary and indices that repeat there, and windows that tie)."""
    x, extra, rng = w.band_op_inputs(name)
    module = w.band_op_module(name)
    params = list(module.parameters()) if module is not None else []
    replicated = name == "image_pool"
    g_img = rng.normal(size=(2, 3, 1, 1)) if replicated else None
    want = _full_op(x, lambda t: w.band_op_apply(name, t, module, False, extra),
                    (lambda shape: g_img) if replicated else
                    (lambda shape: rng.normal(size=shape)), params)
    # the Xception blocks' inner BN biases have no gradient in exact
    # arithmetic (a pointwise conv and a BN follow them; float64 noise of
    # 3e-14 beside gradients of up to 170): each gradient is held relative
    # to at least BAND_GRAD_FLOOR of the op's largest
    for group in _model_groups(ranks[0]["ops"]):
        _assert_sharded([g[name] for g in group], want, replicated=replicated,
                        grad_floor=BAND_GRAD_FLOOR)


def test_segresnet_pool_indices_cross_the_boundary():
    """The argmax_pool_flat case does what its test claims: rank 1's first
    pooled row picks rank 0's row 5, the two ranks' indices repeat there,
    and those writes land in rank 0's canvas rows."""
    x, _, _ = w.band_op_inputs("argmax_pool_flat")
    _, idx = F.max_pool2d(torch.from_numpy(x), 3, 2, 1, return_indices=True)
    rows = (idx // w.OP_W).numpy()  # input rows
    assert (rows[:, :, 3] == 5).all() and (rows[:, :, 2] == 5).all()
    canvas_rows = (idx[:, :, 3] // (2 * idx.shape[-1])).numpy()
    assert (canvas_rows < 2 * 3).all()  # rank 0's canvas rows are [0, 6)


@pytest.mark.parametrize("case", [(c, split) for c in w.TCONV_CASES for split in w.TCONV_SPLITS],
                         ids=[f"k{k}-s{s}-p{p}-op{op}-{split}" for k, s, p, op in w.TCONV_CASES
                              for split in w.TCONV_SPLITS])
def test_transposed_conv_over_h_is_the_whole_conv(ranks, case):
    """A transposed conv whose windows overlap in H (each band's output rows
    summed onto their owners, the bias added once): output, input gradient
    and weight and bias gradients of the unsharded conv."""
    x, m, rng = w.tconv_inputs(*case)
    want = _full_op(x, m, lambda shape: rng.normal(size=shape), [m.weight, m.bias])
    for group in _model_groups(ranks[0]["ops"]):
        _assert_sharded([g[("tconv", *case[0], case[1])] for g in group], want)


def test_column_parallel_transposed_conv_over_h_is_the_whole_conv(ranks):
    """Tensor parallel with spatial sharding: the column-parallel transposed
    conv (ENet's 3x3/2) on the bands, each rank's gathered weight and bias
    gradients the whole conv's."""
    x, m, rng = w.tp_tconv_inputs()
    xr = torch.from_numpy(x).clone().requires_grad_()
    y = m(xr)
    (y * torch.from_numpy(rng.normal(size=tuple(y.shape)))).sum().backward()
    for group in _model_groups(ranks[0]["ops"]):
        got = [g["tconv_tp"] for g in group]
        assert rel(torch.cat([g[0] for g in got], 2), y.detach()) < OP_TOL
        assert rel(torch.cat([g[1] for g in got], 2), xr.grad) < OP_TOL
        for g in got:
            assert rel(g[2]["0.weight"], m.weight.grad) < OP_TOL
            assert rel(g[2]["0.bias"], m.bias.grad) < OP_TOL


@pytest.mark.parametrize("name", w.TP_CONVS)
def test_column_parallel_conv_is_the_whole_conv(ranks, name):
    x, g, m = w.tp_conv_inputs(name)
    x.requires_grad_()
    y = m(x)
    (y * g).sum().backward()
    for r in ranks[0]["tp_ops"]:
        got_y, got_dx, grads = r[name]
        assert rel(got_y, y.detach()) < OP_TOL and rel(got_dx, x.grad) < OP_TOL
        assert rel(grads["0.weight"], m.weight.grad) < OP_TOL
        assert rel(grads["0.bias"], m.bias.grad) < OP_TOL


# -- collective axes -------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["tp", "spatial", "replicated"])
def test_global_bn_counts_the_right_axis(ranks, mode):
    x, g, *params = dw.bn_inputs(torch.float64)
    ref = dw.make_bn(x.shape[1], params).train()
    xr = x.clone().requires_grad_()
    y = ref(xr)
    (y * g).sum().backward()
    got = [r[mode] for r in ranks[0]["bn"]]
    for r in got:  # the unbiased running variance takes the global count
        assert rel(r["running_mean"], ref.running_mean) < BN_TOL
        assert rel(r["running_var"], ref.running_var) < BN_TOL
    groups = _model_groups(got)
    if mode == "spatial":  # rows: model index; images: data index
        y_got = torch.cat([torch.cat([r["y"] for r in grp], 2) for grp in groups])
        dx_got = torch.cat([torch.cat([r["dx"] for r in grp], 2) for grp in groups])
        dweight = sum(r["dweight"] for r in got)
    elif mode == "tp":  # the model ranks hold the same images, the whole gradient
        y_got = torch.cat([grp[0]["y"] for grp in groups])
        dx_got = torch.cat([grp[0]["dx"] for grp in groups])
        for grp in groups:
            assert torch.equal(grp[0]["dx"], grp[1]["dx"])
        dweight = sum(grp[0]["dweight"] for grp in groups)
    else:  # replicated maps: the model ranks carry parts of the gradient
        y_got = torch.cat([grp[0]["y"] for grp in groups])
        dx_got = torch.cat([grp[0]["dx"] + grp[1]["dx"] for grp in groups])
        dweight = sum(r["dweight"] for r in got)
    assert rel(y_got, y.detach()) < BN_TOL and rel(dx_got, xr.grad) < BN_TOL
    assert rel(dweight, ref.weight.grad) < BN_TOL


@pytest.mark.parametrize("case", dw.LOSS_CASES, ids=lambda c: c[0] + "".join(
    f"-{k}={v}" for k, v in c[1].items()))
def test_loss_under_spatial_sharding_is_the_whole_batchs(ranks, case):
    name, kw = case
    binary = name in dw.BINARY
    logits, labels = w.loss_inputs(binary)
    x = logits.clone().requires_grad_()
    want = dw.loss_fn(name)(x, labels, ignore_index=255, **kw)
    want.backward()
    got = [r[(name, tuple(sorted(kw.items())))] for r in ranks[0]["losses"]]
    for loss, _ in got:
        assert rel(loss, want.detach()) < LOSS_TOL
    dim = 1 if binary else 2
    grad = torch.cat([torch.cat([g for _, g in grp], dim) for grp in _model_groups(got)])
    assert rel(grad, x.grad) < LOSS_TOL


# -- the TP step -----------------------------------------------------------------------

@pytest.mark.parametrize("n_steps", [1, w.STEP_STEPS])
def test_tp_step_is_segtpus_on_a_2x2_mesh(ranks, n_steps):
    got, seg, _ = ranks
    start = dw.zoo_model("PSPNet").state_dict()
    port = {0: (None, {k: v.double() for k, v in start.items()}),
            **got["tp_step"][0]["snaps"]}
    assert_step_matches(seg["tp_step"]["snaps"], port, n_steps)


def test_tp_shards_segtpus_convs_and_keeps_the_ranks_equal(ranks):
    got, seg, _ = ranks
    marks = jax.tree_util.tree_map(lambda s, p: np.full(p.shape, float(s)),
                                   seg["tp_step"]["sharded"],
                                   _seg_variables("PSPNet", dw.zoo_model("PSPNet"))[0])
    stats = _seg_variables("PSPNet", dw.zoo_model("PSPNet"))[1]
    sd = wc.pspnet_state_dict_from_segtpu(marks, stats)
    want = {k[:-len(".weight")] for k, v in sd.items()
            if k.endswith(".weight") and v.dim() == 4 and bool((v == 1).all())}
    r0 = got["tp_step"][0]
    assert set(r0["sharded"]) == want and len(want) > 0
    for r in got["tp_step"]:
        assert r["spread"] == [0.0] * w.STEP_STEPS
    # the sharded weights are half a rank's parameters' bytes
    full = sum(v.numel() * 8 for v in dw.zoo_model("PSPNet").parameters())
    assert r0["param_bytes"] < 0.75 * full


@pytest.mark.parametrize("name", list(dw.ZOO))
def test_zoo_model_steps_under_tp_as_on_one_process(ranks, name):
    got = [r[name] for r in ranks[0]["zoo"]]
    ref = got[list(dw.ZOO).index(name) % w.WORLD]
    assert all(g["loss"] == got[0]["loss"] for g in got)
    assert all(g["n_sharded"] > 0 for g in got)
    assert abs(got[0]["loss"] - ref["ref_loss"]) <= TOL64 * abs(ref["ref_loss"])
    assert ref["n_grads"] == ref["ref_n_grads"]
    floor = GRAD_FLOOR * ref["model_scale"]
    for param, (err, scale) in ref["errors"].items():
        assert err < TOL64 * max(scale, floor), (param, err, scale)


# -- spatial steps ---------------------------------------------------------------------

def _spatial(ranks, name, hw):
    return [r[(name, hw)] for r in ranks[0]["spatial"]]


# SegResNet's float64 training amplifies rounding about a thousandfold a
# step (one process, a channels-last layout alone moves its tensors by
# 1.5e-14 after one step and 8e-9 after three): after 3 steps its tensors are
# held to this of their largest value (the spatial steps' 2e-8 to 8.4e-8),
# and the whole update, like every model's, to TOL64
STEP3_TENSOR_TOL = {"SegResNet": 1e-6}


def _judged(ranks, case):
    """The rank that ran ``case`` as one process too: its comparison."""
    return _spatial(ranks, *case)[w.SPATIAL_CASES.index(case) % w.WORLD]["one_process"]


@pytest.mark.parametrize("case", w.SPATIAL_CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_spatial_steps_are_one_process(ranks, case):
    """After 1 and 3 steps: the loss, every floating tensor (relative to the
    larger of its largest value and ``w.VALUE_FLOOR``; SegResNet's after 3
    steps to STEP3_TENSOR_TOL) and the whole update (relative L2) within
    1e-8 of one process's, the integer tensors equal (compared on the rank
    that ran both, ``w.compare_states``); the eval step's loss likewise,
    its seg stats exactly."""
    got = _spatial(ranks, *case)
    judged = _judged(ranks, case)
    assert sorted(judged["steps"]) == [1, w.SPATIAL_STEPS]
    for n, (loss_err, worst, key, ints, update) in judged["steps"].items():
        tensor_tol = STEP3_TENSOR_TOL.get(case[0], TOL64) if n > 1 else TOL64
        assert loss_err < TOL64 and worst < tensor_tol and ints and update < TOL64, (
            n, loss_err, worst, key, update)
    eval_loss, eval_stats = judged["eval"]
    for r in got:
        assert r["spread"] == [0.0] * w.SPATIAL_STEPS
        loss, stats = r["eval"]
        assert abs(loss - eval_loss) <= TOL64 * abs(eval_loss)
        for g, wv in zip(stats, eval_stats):
            assert torch.equal(g, wv)


@pytest.mark.parametrize("case", w.SPATIAL_CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_spatial_ranks_hold_their_bands(ranks, case):
    name, hw = case
    got = _spatial(ranks, name, hw)
    rows = got[0]["rows"]
    stride = w.spatial_model(name).spatial_stride
    assert rows == spatial.split(hw, stride, 2)
    assert rows.bounds[0][1] % stride == 0 and rows.bounds[1][1] == hw
    # the probed map's rows: rank 0's end at its boundary over the map's
    # stride, rank 1 the rest of the one-process map's
    probe_stride, whole = w.PROBES[name][1], _judged(ranks, case)["probe_rows"]
    first = rows.bounds[0][1] // probe_stride
    deep = (first, whole - first)
    for r, res in enumerate(got):
        lo, hi = rows.bounds[r % 2]
        assert res["heights"] == (deep[r % 2], hi - lo) and deep[r % 2] > 0


def test_pspdensenet_remat_backbone_recomputes_on_the_bands(ranks):
    """remat_backbone's per-dense-layer recompute runs the halo exchanges
    again under the same layouts: the spatial step is the one-process step
    without remat."""
    got = [r["remat"] for r in ranks[0]["spatial"]]
    for r in got:
        assert r["spread"] == [0.0]
    (loss_err, worst, key, ints, update), = got[0]["one_process"].values()
    assert loss_err < TOL64 and worst < TOL64 and ints and update < TOL64, (
        loss_err, worst, key, update)


@pytest.mark.parametrize("case", [(c, n) for c in SEG_SPATIAL for n in (
    [1, w.SPATIAL_STEPS] if c in SEG_EVAL else [1])], ids=lambda c: f"{c[0][0]}-{c[0][1]}-{c[1]}")
def test_spatial_step_is_segtpus_on_a_2x2_mesh(ranks, case):
    (name, hw), n_steps = case
    got, seg, out = ranks
    if (name, hw) in w.SEG_ONLY:
        for r in got["spatial"]:
            assert r[("seg", name, hw)]["spread"] == [0.0]
    snaps = torch.load(os.path.join(out, f"spatial-snaps-{name}-{hw}.pt"), weights_only=False)
    start = w.seg_case_model(name).state_dict()
    port = {0: (None, {k: v.double() for k, v in start.items()}), **snaps}
    assert_step_matches(seg[(name, hw)]["snaps"], port, n_steps)


@pytest.mark.parametrize("case", SEG_EVAL, ids=lambda c: f"{c[0]}-{c[1]}")
def test_spatial_eval_is_segtpus(ranks, case):
    got, seg, _ = ranks
    want_loss, want_stats = seg[case]["eval"]
    for r in _spatial(ranks, *case):
        loss, stats = r["eval"]
        assert abs(loss - want_loss) <= TOL * abs(want_loss)
        for g, wv in zip(stats, want_stats):
            np.testing.assert_array_equal(g.numpy(), wv)


# -- the Trainer -----------------------------------------------------------------------

def test_trainer_with_the_model_axis_is_segtpus(ranks):
    got, seg, _ = ranks
    seg_losses_, seg_logs = seg["trainer"]
    for r, res in enumerate(got["trainer"]):
        assert res["sharded"] > 0 and res["rows"] == spatial.split(64, 16, 2)
        steps = res["step_losses"]
        assert len(steps) == len(seg_losses_) == 3
        for g, wv in zip(steps, seg_losses_):
            assert abs(g - wv) <= TOL * abs(wv)
        (h,), (wl,) = res["history"], seg_logs
        for k in ("val_loss", "Pixel_Accuracy", "Mean_IoU"):
            assert abs(h[k] - wl[k]) <= 1e-3 + 1e-7, k
        assert res["history"] == got["trainer"][0]["history"]
        assert res["final_spread"] == 0.0
    # the big convs' weights are sharded: half their output channels a rank
    shapes = got["trainer"][0]["param_shapes"]
    assert shapes["middle_conv.3.weight"] == (512, 512, 3, 3)


def test_model_axis_checkpoint_resumes_on_one_and_on_four(ranks):
    got, _, out = ranks
    r0 = got["trainer"][0]
    ckpt = os.path.join(r0["checkpoint_dir"], "checkpoint-epoch1")
    cfg = w.trainer_config(os.path.join(out, "one-rank"))
    one = w.state_of(w.port_trainer(cfg, resume=ckpt))
    final = r0["final"]
    for state in (one, *(r["resumed"] for r in got["trainer"])):
        assert state["step"] == final["step"] == 3
        for k, v in final["model"].items():
            assert torch.equal(state["model"][k], v), k
        assert state["optimizer"]["param_groups"] == final["optimizer"]["param_groups"]
        for i, buffers in final["optimizer"]["state"].items():
            for k, v in buffers.items():
                assert torch.equal(state["optimizer"]["state"][i][k], v), (i, k)
    assert r0["resumed_epoch"] == 2
    # the checkpoint holds the one-device layout
    saved = torch.load(os.path.join(ckpt, "state.pt"), weights_only=True)
    assert tuple(saved["model"]["middle_conv.3.weight"].shape) == (1024, 512, 3, 3)


def test_val_grid_shows_whole_images(ranks):
    _, _, out = ranks
    (path,) = glob.glob(os.path.join(out, "trainer", "runs", "*", "*", "events.out.*"))
    # tensorboard's own reader, on its stand-in for TensorFlow (the "notf"
    # marker), which checks both CRCs of every record
    sys.modules.setdefault("tensorboard.compat.notf",
                           types.ModuleType("tensorboard.compat.notf"))
    from tensorboard.backend.event_processing.event_file_loader import LegacyEventFileLoader

    images = [v.image for e in LegacyEventFileLoader(path).Load() for v in e.summary.value
              if v.tag == "val/inputs_targets_predictions"]
    assert len(images) == 1
    assert (images[0].height, images[0].width) == (64, 3 * 64)


# UNetResnet's encoding-style encoder is dilated past stride 8
ZOO_STRIDES = {"PSPNet": 8, "PSPDenseNet": 8, "UperNet": 16, "DeepLab": 16,
               "DeepLab_DUC_HDC": 8, "UNet": 16, "SegNet": 32, "SegResNet": 32,
               "UNetResnet": 8, "ENet": 8, "GCN": 32, "FCN8": 32}


@pytest.mark.parametrize("name", list(dw.ZOO))
def test_spatial_shards_all_twelve(name):
    model = get_model(name, device="cpu", num_classes=3, **dw.ZOO[name][0])
    assert spatial.check_model(model) == ZOO_STRIDES[name]
    assert set(spatial.SHARDED_MODELS) == set(ZOO_STRIDES) == set(dw.ZOO)


def test_spatial_raises_for_the_other_models():
    """A model without a ``spatial_stride`` raises, naming the twelve; a
    crop too short for the ranks raises."""
    with pytest.raises(ValueError, match=", ".join(spatial.SHARDED_MODELS)):
        spatial.check_model(torch.nn.Conv2d(3, 3, 3))
    with pytest.raises(ValueError, match="some rank would hold none"):
        spatial.split(15, 16, 2)
