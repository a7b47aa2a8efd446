"""Data-parallel training of the port on 2 gloo ranks on the CPU, against
segtpu on 2 of the virtual CPU devices (``make_mesh(jax.devices()[:2])``)
and against the port as one process on the whole batch.

One module fixture starts the 2 ranks once (``segtpu_torch.core.mesh.launch``,
the launcher the training CLI uses) to run every multi-rank case of
``tests/torch_dist_worker.py``; while they run, this process computes
segtpu's side. The checks, each the place where plain
``DistributedDataParallel`` would differ from segtpu:

* BN: ``GlobalBatchNorm2d`` on 2 ranks is ``nn.BatchNorm2d`` on the whole
  batch (output, dx, dweight, dbias, running statistics with the unbiased
  global count): 1e-12 relative in float64, 1e-5 in float32 (sums in other
  orders); outside a group it is ``nn.BatchNorm2d`` bit for bit.
* Losses: every name of ``LOSSES`` (and the exact Lovász per image, the
  binary hinge and cross-entropy) on 2 ranks whose valid-pixel counts
  differ is the loss of the whole batch, value and logits gradient, 1e-12
  relative in float64.
* Loader: each rank's batches are segtpu's ``DataLoader(num_shards,
  shard_index)``'s, for train (lockstep drop) and padded val, with 2 nodes
  of one rank and with one node of 2 (the batch split), index for index.
* Step: PSPNet-R18 at 33 px, global batch 8, 1 and 3 float64 SGD steps on
  2 ranks against segtpu's ``make_train_step`` on the 2-device mesh from the
  same weights (``MODEL_CONVERTERS``), with ``tests/torch_zoo.py``'s
  tolerances; the ranks' weights and running statistics equal bit for bit
  (the wrap broadcasts no buffer).
* Trainer: 2 epochs on Synthetic with ``trainer.devices: 2`` against
  segtpu's Trainer with ``devices: 2``: every step's loss within 1e-4
  relative (the step tolerance), the val metrics, which both round to 3
  places, within one unit of that rounding; rank 0 alone wrote the run's
  files; its checkpoint resumes on 1 rank and on 2 to the same state, bit
  for bit.
* SIGTERM to one rank stops both at the same iteration, with one
  ``checkpoint-latest``.
* Zoo: each of the 12 names takes a 2-rank step, one image a rank (so its
  BN has statistics only over the ranks), without the wrap's
  unused-parameter error, and its gradients are the one-process step's on
  the whole batch within 1e-8 relative (float64) to the larger of a
  tensor's largest gradient and GRAD_FLOOR of the model's largest.
* The kernel build: two processes building one source at once run one nvcc.
"""

import glob
import json
import multiprocessing
import os
import threading

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as w
from segtpu import losses as seg_losses
from segtpu.core import state as seg_state
from segtpu.core.mesh import make_mesh
from segtpu.core.steps import make_train_step as seg_make_train_step
from segtpu.data.base import BaseDataset as SegBaseDataset
from segtpu.data.base import DataLoader as SegDataLoader
from segtpu.data.synthetic import Synthetic as SegtpuSynthetic
from segtpu.models.pspnet import PSPNet as SegtpuPSPNet
from segtpu.trainer import Trainer as SegtpuTrainer
from segtpu.utils.weight_convert import MODEL_CONVERTERS
from segtpu_torch.core import mesh
from segtpu_torch.data.base import DataLoader
from segtpu_torch.models import get_model
from segtpu_torch.nn.layers import GlobalBatchNorm2d, convert_global_bn
from segtpu_torch.utils.weight_convert import pspnet_state_dict_from_segtpu
from torch_parity import IdentityDropout, segtpu_float64, state_dict64
from torch_zoo import TOL, TOL64, assert_step_matches

torch.set_num_threads(1)
BN_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
LOSS_TOL = 1e-12
# a conv bias that a train-mode BN follows has a gradient of 0 in exact
# arithmetic and of float64 rounding noise in fact (up to 6e-16 here, where
# the models' largest gradients are 1e-2 to 1): its error is held relative
# to this fraction of the model's largest gradient
GRAD_FLOOR = 1e-4


def rel(got, want):
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


# -- segtpu's side, computed while the ranks run ------------------------------------

class SegIndexDataset(SegBaseDataset):
    """segtpu's counterpart of ``torch_dist_worker.IndexDataset``."""

    num_classes = 3
    palette = []

    def __init__(self, size, val, crop_size=4):
        self._size = size
        super().__init__(root="", split="val", mean=[0.5] * 3, std=[0.25] * 3, val=val,
                         crop_size=crop_size, device_normalize=True)

    def _set_files(self):
        self.files = list(range(self._size))

    def get(self, index, rng=None):
        crop = self.crop_size
        return (np.full((crop, crop, 3), index % 256, np.uint8),
                np.full((crop, crop), index, np.int32))


def segtpu_loader_labels(kind, num_shards, shard_index):
    loader = SegDataLoader(SegIndexDataset(w.LOADER_SIZES[kind], kind == "val"),
                           w.LOADER_BATCH, shuffle=kind == "train", num_workers=1, seed=4,
                           num_shards=num_shards, shard_index=shard_index)
    return [[lab[:, 0, 0].copy() for _, lab in loader] for _ in range(2)]


def segtpu_step_snaps():
    """segtpu's PSPNet-R18 after each float64 SGD step on the 2-device mesh,
    from the port's seeded weights, in the port's layout."""
    port = get_model("PSPNet", device="cpu", seed=1, num_classes=w.CLASSES,
                     backbone="resnet18")
    params, stats = MODEL_CONVERTERS["PSPNet"](
        {k: v.numpy() for k, v in port.state_dict().items()}, arch="resnet18")
    model = SegtpuPSPNet(num_classes=w.CLASSES, backbone="resnet18")
    with segtpu_float64():
        params, stats = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                               (params, stats))
        tx, _ = seg_state.make_optimizer_with_schedules(**w.SGD)
        jstate = seg_state.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                      batch_stats=stats, opt_state=tx.init(params), tx=tx)
        jstep = seg_make_train_step(model, seg_losses.cross_entropy, w.CLASSES,
                                    compute_dtype=jnp.float64,
                                    mesh=make_mesh(jax.devices()[:2]))
        snaps = [(None, state_dict64(pspnet_state_dict_from_segtpu, *jax.tree_util.tree_map(
            np.asarray, (params, stats))))]
        for imgs, labels in w.step_batches():
            jstate, loss, _ = jstep(jstate, jnp.asarray(imgs), jnp.asarray(labels),
                                    jax.random.PRNGKey(0))
            p, s = jax.tree_util.tree_map(np.asarray, (jstate.params, jstate.batch_stats))
            snaps.append((np.asarray(loss), state_dict64(pspnet_state_dict_from_segtpu, p, s)))
    return snaps


class _Entries:
    def __init__(self):
        self.entries = []

    def add_entry(self, entry):
        self.entries.append(entry)


def segtpu_trainer_run(root):
    """segtpu's Trainer with ``devices: 2`` from the port's seeded weights:
    (every step's loss, its epoch logs)."""
    cfg = w.trainer_config(root, devices=2, progress_bar=False, tensorboard=False)
    port = get_model("PSPNet", device="cpu", num_classes=3, backbone="resnet18")
    params, stats = MODEL_CONVERTERS["PSPNet"](
        {k: v.numpy() for k, v in port.state_dict().items()}, arch="resnet18")
    logs = _Entries()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "Dropout", IdentityDropout)
        seg = SegtpuTrainer(SegtpuPSPNet(num_classes=3, backbone="resnet18"),
                            "CrossEntropyLoss2d", cfg,
                            *(SegtpuSynthetic(**cfg[k]["args"])
                              for k in ("train_loader", "val_loader")),
                            train_logger=logs)
        seg.state = seg.state.replace(params=jax.tree_util.tree_map(jnp.asarray, params),
                                      batch_stats=jax.tree_util.tree_map(jnp.asarray, stats))
        step, losses = seg.train_step, []

        def recorded(*args):
            out = step(*args)
            losses.append(float(out[1]))
            return out

        seg.train_step = recorded
        seg.train()
    return losses, logs.entries


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case's results, by case and rank, and segtpu's side."""
    out = str(tmp_path_factory.mktemp("ranks"))
    failed = []

    def launch():
        try:
            mesh.launch(w.run_cases, (out, list(w.CASES)), ["cpu", "cpu"], timeout=300)
        except BaseException as e:  # raised in the test below
            failed.append(e)

    thread = threading.Thread(target=launch)
    thread.start()
    seg = {"step": segtpu_step_snaps(),
           "trainer": segtpu_trainer_run(os.path.join(out, "segtpu")),
           "loader": {(n, i, kind): segtpu_loader_labels(kind, n, i)
                      for n, i in ((1, 0), (2, 0), (2, 1)) for kind in ("train", "val")}}
    thread.join(timeout=900)
    assert not thread.is_alive() and not failed, failed
    got = {case: [torch.load(os.path.join(out, f"{case}-rank{r}.pt"), weights_only=False)
                  for r in range(2)] for case in w.CASES}
    return got, seg, out


# -- BN --------------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_global_bn_is_batchnorm_on_the_whole_batch(ranks, dtype):
    x, g, *params = w.bn_inputs(dtype)
    ref = w.make_bn(x.shape[1], params).train()
    xr = x.clone().requires_grad_()
    y = ref(xr)
    (y * g).sum().backward()
    got = [r[str(dtype)] for r in ranks[0]["bn"]]
    tol = BN_TOL[dtype]
    assert rel(torch.cat([r["y"] for r in got]), y) < tol
    assert rel(torch.cat([r["dx"] for r in got]), xr.grad) < tol
    assert rel(got[0]["dweight"] + got[1]["dweight"], ref.weight.grad) < tol
    assert rel(got[0]["dbias"] + got[1]["dbias"], ref.bias.grad) < tol
    for r in got:  # the unbiased running variance takes the global count
        assert rel(r["running_mean"], ref.running_mean) < tol
        assert rel(r["running_var"], ref.running_var) < tol


def test_global_bn_outside_a_group_is_batchnorm_bit_for_bit():
    x, g, *params = w.bn_inputs(torch.float32)
    outs = []
    for cls in (torch.nn.BatchNorm2d, GlobalBatchNorm2d):
        bn = w.make_bn(x.shape[1], params, cls).train()
        xr = x.clone().requires_grad_()
        y = bn(xr)
        (y * g).sum().backward()
        outs.append((y, xr.grad, bn.weight.grad, bn.running_var))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    model = get_model("ENet", device="cpu", num_classes=3)
    assert convert_global_bn(model) == 0
    assert not any(isinstance(m, GlobalBatchNorm2d) for m in model.modules())
    keys = list(model.state_dict())
    assert convert_global_bn(model, force=True) > 0
    assert list(model.state_dict()) == keys
    assert not any(type(m) is torch.nn.BatchNorm2d for m in model.modules())


# -- losses ----------------------------------------------------------------------------

@pytest.mark.parametrize("case", w.LOSS_CASES, ids=lambda c: c[0] + "".join(
    f"-{k}={v}" for k, v in c[1].items()))
def test_loss_on_two_ranks_is_the_whole_batchs(ranks, case):
    name, kw = case
    logits, labels = w.loss_inputs(name in w.BINARY)
    valid = [int((w.rows(labels, r) != 255).sum()) for r in range(2)]
    assert valid[0] > 2 * valid[1]  # the ranks' counts differ
    x = logits.clone().requires_grad_()
    want = w.loss_fn(name)(x, labels, ignore_index=255, **kw)
    want.backward()
    got = [r[(name, tuple(sorted(kw.items())))] for r in ranks[0]["losses"]]
    for loss, _ in got:
        assert rel(loss, want.detach()) < LOSS_TOL
    assert rel(torch.cat([grad for _, grad in got]), x.grad) < LOSS_TOL


# -- loader ----------------------------------------------------------------------------

@pytest.mark.parametrize("local", [2, 1], ids=["one-node-of-2", "two-nodes-of-1"])
@pytest.mark.parametrize("kind", ["train", "val"])
def test_loader_shards_are_segtpus(ranks, local, kind):
    got, seg, _ = ranks
    for r in range(2):
        shards, epochs = got["loader"][r][(local, kind)]
        if local == 2:  # one segtpu host; rank r takes rows [2r, 2r + 2)
            assert shards == (1, 0, (2 * r, 2 * r + 2))
            want = [[b[2 * r:2 * r + 2] for b in ep] for ep in seg["loader"][(1, 0, kind)]]
        else:  # two segtpu hosts
            assert shards == (2, r, (0, w.LOADER_BATCH))
            want = seg["loader"][(2, r, kind)]
        for (indices, labels), want_labels in zip(epochs, want):
            assert len(labels) == len(want_labels) > 0
            for i, lab, wl in zip(indices, labels, want_labels):
                np.testing.assert_array_equal(lab, wl)
                np.testing.assert_array_equal(np.where(i < 0, -100, i), wl)
    if kind == "val":  # every sample exactly once over the ranks
        seen = np.concatenate([i for r in range(2)
                               for i in got["loader"][r][(local, kind)][1][0][0]])
        assert sorted(seen[seen >= 0]) == list(range(w.LOADER_SIZES["val"]))


def test_loader_raises_where_it_cannot_shard(ranks):
    for r in range(2):
        split, crop = ranks[0]["loader"][r]["errors"]
        assert split.startswith("batch_size 3 does not split over the node's 2 devices")
        assert "static crop_size" in crop
    with pytest.raises(ValueError, match="static crop_size"):
        len(DataLoader(w.IndexDataset(8, True, crop_size=None), 2, False, num_shards=2,
                       shard_index=0))
    with pytest.raises(ValueError, match="shard_index requires num_shards"):
        DataLoader(w.IndexDataset(8, True), 2, False, shard_index=0)
    assert len(DataLoader(w.IndexDataset(8, True, crop_size=None), 1, False)) == 8


# -- the step --------------------------------------------------------------------------

@pytest.mark.parametrize("n_steps", [1, w.STEP_STEPS])
def test_step_on_two_ranks_is_segtpus_on_a_two_device_mesh(ranks, n_steps):
    got, seg, _ = ranks
    start = get_model("PSPNet", device="cpu", seed=1, num_classes=w.CLASSES,
                      backbone="resnet18").state_dict()
    port = {0: (None, {k: v.double() for k, v in start.items()}),
            **got["step"][0]["snaps"]}
    assert_step_matches(seg["step"], port, n_steps)


def test_ranks_hold_the_same_weights_and_running_statistics(ranks):
    got = ranks[0]
    assert got["step"][1]["rank_spread"] == [0.0] * w.STEP_STEPS
    assert got["trainer"][1]["final_spread"] == 0.0


# -- the Trainer -----------------------------------------------------------------------

def test_trainer_on_two_ranks_is_segtpus_on_two_devices(ranks):
    got, seg, _ = ranks
    seg_losses_, seg_logs = seg["trainer"]
    for r in range(2):
        res = got["trainer"][r]
        assert res["bn"] > 0
        steps = res["step_losses"]
        assert len(steps) == len(seg_losses_) == 4
        for g, wv in zip(steps, seg_losses_):
            assert abs(g - wv) <= TOL * abs(wv)
        history = res["history"]
        assert [h["epoch"] for h in history] == [1, 2]
        for h, wl in zip(history, seg_logs):
            for k in ("val_loss", "Pixel_Accuracy", "Mean_IoU"):
                assert abs(h[k] - wl[k]) <= 1e-3 + 1e-7, k
        assert history == got["trainer"][0]["history"]


def test_only_rank_0_writes_the_runs_files(ranks):
    got, _, out = ranks
    r0, r1 = got["trainer"]
    assert r0["checkpoint_dir"] == r1["checkpoint_dir"]
    assert (r0["writer"], r0["logger"], r1["writer"], r1["logger"]) == (True, True,
                                                                        False, False)
    assert sorted(os.listdir(r0["checkpoint_dir"])) == [
        "best_model", "checkpoint-epoch1", "checkpoint-epoch2", "config.json"]
    events = glob.glob(os.path.join(out, "trainer", "runs", "*", "*", "events.out.*"))
    assert len(events) == 1
    with open(os.path.join(r0["checkpoint_dir"], "config.json")) as f:
        assert json.load(f)["trainer"]["devices"] == 2


def test_checkpoint_of_two_ranks_resumes_on_one_and_on_two(ranks):
    from torch_dist_worker import port_trainer, state_of, trainer_config

    got, _, out = ranks
    r0 = got["trainer"][0]
    ckpt = os.path.join(r0["checkpoint_dir"], "checkpoint-epoch2")
    cfg = trainer_config(os.path.join(out, "one-rank"), tensorboard=False)
    one = state_of(port_trainer(cfg, resume=ckpt))
    final = r0["final"]
    for state in (one, r0["resumed"]):
        assert state["step"] == final["step"] == 4
        for k, v in final["model"].items():
            assert torch.equal(state["model"][k], v), k
        assert state["optimizer"]["param_groups"] == final["optimizer"]["param_groups"]
        for i, buffers in final["optimizer"]["state"].items():
            for k, v in buffers.items():
                assert torch.equal(state["optimizer"]["state"][i][k], v), (i, k)
    assert got["trainer"][1]["resumed_spread"] == 0.0
    assert r0["resumed_epoch"] == 3


def test_sigterm_to_one_rank_stops_both_at_one_iteration(ranks):
    got = ranks[0]["sigterm"]
    assert got[0] == got[1]
    assert got[0]["steps"] == got[0]["step"] == 2
    assert got[0]["preempted"] == "epoch 1 iter 2/4"
    latest = os.path.join(got[0]["checkpoint_dir"], "checkpoint-latest")
    assert sorted(os.listdir(got[0]["checkpoint_dir"])) == ["checkpoint-latest",
                                                            "config.json"]
    with open(os.path.join(latest, "meta.json")) as f:
        meta = json.load(f)
    assert (meta["resume_epoch"], meta["resume_iter"]) == (1, 2)


# -- the zoo ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(w.ZOO))
def test_zoo_model_steps_on_two_ranks_as_on_one(ranks, name):
    got = [r[name] for r in ranks[0]["zoo"]]
    ref = got[list(w.ZOO).index(name) % 2]
    assert got[0]["loss"] == got[1]["loss"]
    assert abs(got[0]["loss"] - ref["ref_loss"]) <= TOL64 * abs(ref["ref_loss"])
    assert ref["n_grads"] == ref["ref_n_grads"] == ref["n_params"]
    floor = GRAD_FLOOR * ref["model_scale"]
    for param, (err, scale) in ref["errors"].items():
        assert err < TOL64 * max(scale, floor), (param, err, scale)


# -- the kernel build ------------------------------------------------------------------

FAKE_NVCC = """#!{python}
import sys, time
out = sys.argv[sys.argv.index("-o") + 1]
with open({log!r}, "a") as f:
    f.write("built\\n")
time.sleep(1.0)
open(out, "w").write("library")
"""


def test_two_processes_build_one_source_once(tmp_path):
    os.makedirs(tmp_path / "csrc")
    (tmp_path / "csrc" / "k.cu").write_text("// a kernel")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=os.path.realpath(
        __import__("sys").executable), log=str(tmp_path / "log")))
    nvcc.chmod(0o755)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=w.build_once, args=(str(tmp_path),)) for _ in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=60)
    assert [p.exitcode for p in procs] == [0, 0]
    assert (tmp_path / "log").read_text() == "built\n"
    built = glob.glob(str(tmp_path / "build" / "k-*.so"))
    assert len(built) == 1 and open(built[0]).read() == "library"
    assert not glob.glob(str(tmp_path / "build" / "*.tmp"))

