"""segtpu's float16 compute dtype and its prediction argmax, in the port,
against segtpu on the CPU.

* ``packed_argmax``, ``onehot_first_max`` and ``seg_stats_from_logits_onehot``
  equal segtpu's bit for bit on float16, bfloat16 and float32 logits: a
  float16 pair that bfloat16 rounds to one value, signed zeros, rows of one
  value, and random (4, 19, 9, 11) logits.
* The prediction argmax's dispatch (``SEGTPU_ARGMAX`` unset, ``packed``,
  ``fast``, ``jnp``) gives segtpu's seg stats on float16 logits where the
  packed and the plain argmax differ; an unknown value and an axis past
  65536 raise, where segtpu's fall back and return wrong indices.
* The steps take the seg stats on logits cast to a 16-bit compute dtype,
  as segtpu's logits stay in it (CUDA's autocast returns float32 logits).
* One PSPNet-R18 train step at 33 px, batch 4, 3 classes, ``compute_dtype``
  float16 on both sides (dropout the identity), from the same weights and
  batch; one eval step after it; the sliding predict and the serve module
  in float16; ``train.main`` on a float16 config.

Tolerances, each measured on the CPU before it was set. Both sides
round every activation to float16 (11 bits), in other orders:

* the train step's loss 1e-4 relative (measured 1.0e-5); every parameter
  and running statistic after the update 5e-3 of the tensor's largest
  value (1.7e-3 and 5.8e-4);
* the update itself (parameters after, less before) is a sum that cancels
  at random init, so any 16-bit rounding moves it by percents: segtpu's own
  float16 update lies 6.3e-2 (relative L2) from its float32 one, the port's
  6.8e-2 from segtpu's, the port's bfloat16 update 0.20; held to 0.15;
* seg stats on the pixels whose top two logits lie within float16's noise:
  at most 8 counts an entry apart (measured 1);
* the eval step's logits 1e-2 of their largest value (measured 3.5e-3), its
  loss 5e-4 relative (4.8e-5);
* the sliding canvas 4e-3 of its largest value and the serve module's
  confidences 4e-3 (1.3e-3 and 1.7e-3; the port in bfloat16 against
  segtpu's float16, 8.7e-3 and 1.4e-2); class maps equal where the top two
  are further apart.
"""

import re
from pathlib import Path

import flax
import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segtpu import inference_lib as seg_inf
from segtpu import losses as seg_losses
from segtpu import metrics as seg_metrics
from segtpu.core import state as seg_state
from segtpu.core.steps import make_eval_step as seg_make_eval_step
from segtpu.core.steps import make_train_step as seg_make_train_step
from segtpu.ops import reductions as seg_red
from segtpu.serving import build_serve_fn
from segtpu.utils.weight_convert import convert_pspnet
from segtpu_torch import inference_lib, losses, metrics
from segtpu_torch import train as train_cli
from segtpu_torch.core.state import TrainState, make_optimizer
from segtpu_torch.core.steps import make_eval_step, make_train_step
from segtpu_torch.ops import reductions
from segtpu_torch.serving import ServeModule
from segtpu_torch.trainer import compute_dtype
from torch_parity import IdentityDropout, no_dropout, port_pspnet, rel_max, segtpu_pspnet

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent

CLASSES, HW, BATCH = 3, 33, 4
NORM = ([0.5, 0.5, 0.5], [0.25, 0.25, 0.25])
OPT = dict(lr=0.01, num_epochs=1, iters_per_epoch=10)
LOSS_TOL = 1e-4
EVAL_LOSS_TOL = 5e-4
PARAM_TOL = 5e-3
UPDATE_L2_TOL = 0.15
STATS_ATOL = 8
LOGIT_TOL = 1e-2
INFER_TOL = 4e-3

DTYPES = {"float16": (torch.float16, jnp.float16),
          "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float32": (torch.float32, jnp.float32)}


def _torch(a: np.ndarray, dtype) -> torch.Tensor:
    """float32 numpy -> a torch tensor of ``dtype`` (rounded by torch)."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dtype)


def _jax(t: torch.Tensor, dtype) -> jnp.ndarray:
    """The same bits on segtpu's side: float32 values of ``t`` (exact for
    every 16-bit value), cast to ``dtype``, which rounds none of them."""
    return jnp.asarray(t.float().numpy()).astype(dtype)


# -- packed_argmax, onehot_first_max, seg_stats_from_logits_onehot ---------------

def _cases():
    """(name, float32 (..., C) rows), classes on the last axis."""
    rng = np.random.default_rng(3)
    zeros = np.array([[-0.0, 0.0, -1.0], [0.0, -0.0, -1.0], [-0.0, -0.0, -0.0],
                      [-1.0, -0.0, 0.0], [-2.0, -0.0, -0.0]], np.float32)
    return [
        ("fp16 pair bf16 ties", np.array([[1.0, 1.0009765625], [1.0009765625, 1.0],
                                          [-1.0009765625, -1.0]], np.float32)),
        ("signed zeros", zeros),
        ("one value", np.array([[3.5] * 7, [-3.5] * 7, [0.0] * 7], np.float32)),
        ("random (4, 19, 9, 11)", rng.normal(size=(4, 9, 11, 19)).astype(np.float32)),
    ]


CASES = _cases()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", range(len(CASES)), ids=[c[0] for c in CASES])
def test_packed_argmax_and_onehot_equal_segtpus(case, dtype):
    """Classes last on segtpu's side (NHWC), on the port's dim 1 (NCHW) or
    the last axis of a row."""
    tdt, jdt = DTYPES[dtype]
    rows = _torch(CASES[case][1], tdt)
    x = rows.movedim(-1, 1) if rows.dim() == 4 else rows
    dim = 1 if rows.dim() == 4 else -1
    want = np.asarray(seg_red.packed_argmax(_jax(rows, jdt), axis=-1))
    got = reductions.packed_argmax(x, dim=dim)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    want_1h = np.asarray(seg_red.onehot_first_max(_jax(rows, jdt)))
    got_1h = reductions.onehot_first_max(x, dim=dim)
    got_1h = got_1h.movedim(1, -1) if rows.dim() == 4 else got_1h
    assert got_1h.dtype == torch.float32
    np.testing.assert_array_equal(got_1h.numpy(), want_1h)
    np.testing.assert_array_equal(got_1h.numpy().argmax(-1),
                                  torch.argmax(rows, dim=-1).numpy())


def test_packed_argmax_rounds_float16_to_bfloat16():
    """segtpu's float16 pair: the packed form compares their bfloat16
    roundings, which tie, so the first wins; the plain argmax takes the
    second."""
    x = torch.tensor([1.0, 1.0009765625], dtype=torch.float16)
    assert int(reductions.packed_argmax(x)) == 0
    assert int(torch.argmax(x)) == 1
    assert int(seg_red.packed_argmax(jnp.asarray(x.float().numpy(), jnp.float16))) == 0


def test_packed_argmax_raises_past_65536():
    """segtpu's returns 65536 for an all-ones axis of 70000; the port raises,
    through the dispatch too."""
    ones = torch.ones(70000)
    assert int(seg_red.packed_argmax(jnp.ones(70000, jnp.bfloat16))) == 65536
    with pytest.raises(ValueError, match="16-bit index field"):
        reductions.packed_argmax(ones)
    with pytest.raises(ValueError, match="16-bit index field"):
        metrics.seg_stats_from_logits(ones.half().view(1, -1, 1, 1),
                                      torch.zeros(1, 1, 1, dtype=torch.int64))
    assert int(reductions.packed_argmax(torch.ones(65536))) == 0


def _logits_and_labels(seed, shape=(2, 19, 12, 10)):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=shape).astype(np.float32)
    labels = rng.integers(0, shape[1], size=(shape[0],) + shape[2:]).astype(np.int64)
    labels[:, :3, :3] = 255
    labels[:, -1, -2:] = -1
    return logits, labels


def _assert_stats_equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("dtype", DTYPES)
def test_seg_stats_from_logits_onehot_equals_segtpus(dtype):
    tdt, jdt = DTYPES[dtype]
    logits, labels = _logits_and_labels(5)
    x = _torch(logits, tdt)
    want = seg_metrics.seg_stats_from_logits_onehot(
        _jax(x.permute(0, 2, 3, 1), jdt), jnp.asarray(labels))
    got = metrics.seg_stats_from_logits_onehot(x, torch.from_numpy(labels))
    _assert_stats_equal(got, want)
    # segtpu's claim: the index-free form is the fast argmax's stats
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SEGTPU_ARGMAX", "fast")
        _assert_stats_equal(metrics.seg_stats_from_logits(x, torch.from_numpy(labels)), got)


# -- the prediction argmax's dispatch ---------------------------------------------

def _near_ties(seed=11):
    """float16 logits (2, 5, 16, 16) and labels. On half of the pixels two
    classes i < j hold v and v + 2**-10, which bfloat16 rounds to one value:
    the packed argmax takes i there, the plain one j."""
    logits, labels = _logits_and_labels(seed, (2, 5, 16, 16))
    rng = np.random.default_rng(seed)
    x = np.abs(logits) / 8  # below 1: under every pair
    for b, h, w in zip(*np.nonzero(rng.random((2, 16, 16)) < 0.5)):
        i, j = sorted(rng.choice(5, 2, replace=False))
        v = rng.choice([1.25, 1.5, 1.75])
        x[b, i, h, w], x[b, j, h, w] = v, v + 2.0 ** -10
    return _torch(x, torch.float16), labels


@pytest.mark.parametrize("variant", ["", "packed", "fast", "jnp"])
def test_argmax_dispatch_equals_segtpus(variant, monkeypatch):
    x, labels = _near_ties()
    packed = reductions.packed_argmax(x, dim=1)
    assert (packed != torch.argmax(x, dim=1)).float().mean() > 0.4
    monkeypatch.setenv("SEGTPU_ARGMAX", variant)
    for dtype in ("float16", "bfloat16", "float32"):
        tdt, jdt = DTYPES[dtype]
        xt = x.to(tdt)
        want = seg_metrics.seg_stats_from_logits(_jax(xt.permute(0, 2, 3, 1), jdt),
                                                 jnp.asarray(labels))
        got = metrics.seg_stats_from_logits(xt, torch.from_numpy(labels))
        _assert_stats_equal(got, want)
        want_eval = seg_metrics.eval_metrics(_jax(xt.permute(0, 2, 3, 1), jdt),
                                             jnp.asarray(labels), 5)
        _assert_stats_equal(metrics.eval_metrics(xt, torch.from_numpy(labels), 5),
                            want_eval)
    # the variable is read at each call: on float16, unset and packed agree
    # with each other and differ from fast and jnp
    pred = metrics._argmax(x)
    want_pred = packed if variant in ("", "packed") else torch.argmax(x, dim=1)
    assert torch.equal(pred, want_pred)


def test_argmax_dispatch_rejects_an_unknown_variant(monkeypatch):
    """segtpu falls back to fast on a value it does not know; the port
    raises, naming the three."""
    x, labels = _near_ties()
    monkeypatch.setenv("SEGTPU_ARGMAX", "onehot")
    with pytest.raises(ValueError, match=r"SEGTPU_ARGMAX='onehot'.*packed, fast, jnp"):
        metrics.seg_stats_from_logits(x, torch.from_numpy(labels))
    fallback = seg_metrics.seg_stats_from_logits(_jax(x.permute(0, 2, 3, 1), jnp.float16),
                                                 jnp.asarray(labels))
    monkeypatch.setenv("SEGTPU_ARGMAX", "fast")
    _assert_stats_equal(metrics.seg_stats_from_logits(x, torch.from_numpy(labels)),
                        fallback)


class _FixedLogits(torch.nn.Module):
    """Returns float32 logits whatever its input, as a model's come out of
    CUDA's autocast (its bilinear resize runs in float32)."""

    def __init__(self, logits):
        super().__init__()
        self.register_buffer("logits", logits)
        self.w = torch.nn.Parameter(torch.zeros(()))

    def forward(self, x):
        return {"out": self.logits.float() + 0 * self.w}


@pytest.mark.parametrize("train", [False, True])
def test_steps_take_the_stats_on_logits_in_the_compute_dtype(train):
    """Logits wider than a 16-bit compute dtype are cast to it before the
    seg stats (and the eval step returns them so), as segtpu's stay in it:
    the stats are segtpu's on float16 logits, not the float32 argmax's."""
    x, labels = _near_ties()
    model = _FixedLogits(x.float())
    images = torch.zeros((2, 16, 16, 3), dtype=torch.uint8)
    labels_t = torch.from_numpy(labels)
    want = seg_metrics.seg_stats_from_logits(_jax(x.permute(0, 2, 3, 1), jnp.float16),
                                             jnp.asarray(labels))
    wide = metrics.seg_stats_from_logits(x.float(), labels_t)
    assert float(wide.correct) != float(want.correct)
    if train:
        opt, scheds = make_optimizer(model, lr=0.01, num_epochs=1, iters_per_epoch=1)
        step = make_train_step(losses.cross_entropy, compute_dtype=torch.float16)
        _, got = step(TrainState(model, opt, scheds), images, labels_t)
    else:
        step = make_eval_step(losses.cross_entropy, compute_dtype=torch.float16)
        _, got, logits = step(model, images, labels_t)
        assert logits.dtype == torch.float16 and torch.equal(logits, x)
    _assert_stats_equal(got, want)


# -- the train and eval steps -------------------------------------------------------

def _batch(seed):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, size=(BATCH, HW, HW, 3)).astype(np.uint8)
    labels = rng.integers(0, CLASSES, size=(BATCH, HW, HW)).astype(np.int32)
    labels[:, :5, :5] = 255
    return images, labels


def _port_step(params, stats, images, labels, dtype):
    port = no_dropout(port_pspnet(params, stats, "resnet18", CLASSES))
    opt, scheds = make_optimizer(port, **OPT)
    state = TrainState(port, opt, scheds)
    step = make_train_step(losses.cross_entropy, compute_dtype=dtype, norm_stats=NORM)
    # torch's float16 conv backward on the CPU takes a slow path (20 s a
    # step on one thread): four threads cut it to 8
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        loss, st = step(state, torch.from_numpy(images), torch.from_numpy(labels))
    finally:
        torch.set_num_threads(threads)
    return port, loss, st


@pytest.fixture(scope="module")
def weights():
    """segtpu's PSPNet-R18 (model, params, batch_stats), BN moved off its
    init, and the port's model on the same weights."""
    model, params, stats = segtpu_pspnet("resnet18", CLASSES, HW, seed=1)
    return model, params, stats, port_pspnet(params, stats, "resnet18", CLASSES)


@pytest.fixture(scope="module")
def steps(weights):
    """segtpu's and the port's float16 step from the same weights and batch,
    then both eval steps on a second batch (segtpu's with its float16
    logits)."""
    model, params, stats, _ = weights
    images, labels = _batch(7)
    val_images, val_labels = _batch(8)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "Dropout", IdentityDropout)
        tx = seg_state.make_optimizer(**OPT)
        jstate = seg_state.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                      batch_stats=stats, opt_state=tx.init(params), tx=tx)
        jstep = seg_make_train_step(model, seg_losses.cross_entropy, CLASSES,
                                    compute_dtype=jnp.float16, norm_stats=NORM)
        jstate, loss, st = jstep(jstate, jnp.asarray(images), jnp.asarray(labels),
                                 jax.random.PRNGKey(0))
        jeval = seg_make_eval_step(model, seg_losses.cross_entropy, CLASSES,
                                   compute_dtype=jnp.float16, norm_stats=NORM,
                                   return_logits=True)
        seg_eval = jax.tree_util.tree_map(np.asarray, jeval(
            jstate, jnp.asarray(val_images), jnp.asarray(val_labels)))
    seg = jax.tree_util.tree_map(np.asarray, (loss, tuple(st), jstate.params,
                                              jstate.batch_stats))
    port, p_loss, p_st = _port_step(params, stats, images, labels, torch.float16)
    p_params, p_stats = convert_pspnet({k: v.numpy().copy()
                                        for k, v in port.state_dict().items()},
                                       arch="resnet18")
    ev = make_eval_step(losses.cross_entropy, compute_dtype=torch.float16, norm_stats=NORM)
    e_loss, e_st, e_logits = ev(port, torch.from_numpy(val_images),
                                torch.from_numpy(val_labels))
    return {"params": params, "val_labels": val_labels, "segtpu": seg,
            "port": (p_loss.numpy(), tuple(t.numpy() for t in p_st), p_params, p_stats),
            "segtpu_eval": seg_eval, "port_eval": (e_loss, e_st, e_logits)}


def _flat(tree):
    return flax.traverse_util.flatten_dict(tree)


def _update(after, before):
    a, b = _flat(after), _flat(before)
    return np.concatenate([(np.asarray(a[k], np.float64) - b[k]).ravel() for k in sorted(b)])


def _l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_train_step_matches_segtpu(steps):
    w_loss, _, w_params, w_bstats = steps["segtpu"]
    g_loss, _, g_params, g_bstats = steps["port"]
    assert g_loss.dtype == np.float32
    assert rel_max(g_loss, w_loss) < LOSS_TOL
    for want, got in ((w_params, g_params), (w_bstats, g_bstats)):
        fw, fg = _flat(want), _flat(got)
        assert set(fw) == set(fg)
        for k in fw:
            assert fg[k].dtype == np.float32, k
            assert rel_max(fg[k], fw[k]) < PARAM_TOL, k
    start = steps["params"]
    assert _l2(_update(g_params, start), _update(w_params, start)) < UPDATE_L2_TOL


def test_stats_on_segtpus_float16_logits_are_segtpus(steps):
    """segtpu's float16 logits of its eval step: the port's stats on them
    (through the packed argmax) equal the stats segtpu's jitted step took,
    count for count; the plain argmax's would not on the pixels whose top
    two bfloat16 ties."""
    _, want, logits = steps["segtpu_eval"]
    assert logits.dtype == jnp.float16
    port_logits = torch.from_numpy(np.asarray(logits, np.float32)).half().permute(0, 3, 1, 2)
    labels = torch.from_numpy(steps["val_labels"])
    _assert_stats_equal(metrics.seg_stats_from_logits(port_logits, labels), want)
    _assert_stats_equal(metrics.eval_metrics(port_logits, labels, CLASSES), want)


def test_step_stats_match_segtpu_within_float16_noise(steps):
    _, w_stats, _, _ = steps["segtpu"]
    _, g_stats, _, _ = steps["port"]
    assert g_stats[1] == w_stats[1]  # labeled pixels
    for g, w in zip(g_stats, w_stats):
        np.testing.assert_allclose(g, w, atol=STATS_ATOL)


def test_eval_step_matches_segtpu(steps):
    w_loss, w_stats, w_logits = steps["segtpu_eval"]
    g_loss, g_stats, g_logits = steps["port_eval"]
    assert g_logits.dtype == torch.float16 and w_logits.dtype == jnp.float16
    got = g_logits.float().permute(0, 2, 3, 1).numpy()
    want = np.asarray(w_logits, np.float32)
    assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()
    assert rel_max(g_loss.numpy(), w_loss) < EVAL_LOSS_TOL
    np.testing.assert_allclose(np.asarray([t.numpy() for t in g_stats[:2]]),
                               np.asarray(w_stats[:2]), atol=STATS_ATOL)


# -- inference and serving ----------------------------------------------------------

def _assert_close_with_clear_argmax(got, want, got_map=None):
    """``got`` within INFER_TOL of ``want``'s largest value; classes (last
    axis) equal where ``want``'s top two are further apart than that."""
    scale = np.abs(want).max()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= INFER_TOL * scale
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > INFER_TOL * scale
    assert clear.mean() > 0.5
    got_map = got.argmax(-1) if got_map is None else got_map
    assert (got_map == want.argmax(-1))[clear].all()


def test_sliding_predict_in_float16_matches_segtpu(weights):
    model, params, stats, port = weights
    image = np.random.default_rng(1).normal(size=(40, 56, 3)).astype(np.float32)
    seg_predict = seg_inf.make_predictor(model, params, stats, compute_dtype=jnp.float16)
    port_predict = inference_lib.make_predictor(port, compute_dtype=torch.float16,
                                                device="cpu")
    assert port_predict(torch.zeros(1, 3, 16, 22)).dtype == torch.float32
    want = seg_inf.sliding_predict(seg_predict, image, CLASSES)
    got = inference_lib.sliding_predict(port_predict, image, CLASSES)
    got_map = inference_lib.sliding_predict(port_predict, image, CLASSES, class_map=True)
    _assert_close_with_clear_argmax(got, want, got_map)


def test_serve_module_in_float16_matches_segtpu(weights):
    model, params, stats, port = weights
    mean, std = NORM
    images = np.random.default_rng(0).integers(0, 256, (2, HW, HW, 3), np.uint8)
    serve = ServeModule(port, mean, std, torch.float16).eval()
    assert all(p.dtype == (torch.float32 if isinstance(
        m, torch.nn.modules.batchnorm._BatchNorm) else torch.float16)
        for m in serve.model.modules() for p in m.parameters(recurse=False))
    assert all(p.dtype == torch.float32 for p in port.parameters())  # a copy
    with torch.no_grad():
        preds, conf = serve(torch.from_numpy(images))
        probs = torch.softmax(serve.logits(torch.from_numpy(images)), dim=1)
    assert preds.dtype == torch.int32 and conf.dtype == torch.float32
    assert torch.equal(conf, probs.amax(dim=1))
    assert torch.equal(preds.long(), torch.argmax(probs, dim=1))
    seg_preds, seg_conf = (np.asarray(a) for a in jax.jit(build_serve_fn(
        model, params, stats, mean, std, compute_dtype=jnp.float16))(jnp.asarray(images)))
    # confidences within INFER_TOL; predictions equal where the port's top
    # two probabilities are further apart than that
    assert np.abs(conf.numpy() - seg_conf).max() <= INFER_TOL
    top2 = torch.topk(probs, 2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1] > INFER_TOL).numpy()
    assert clear.mean() > 0.5
    assert (preds.numpy() == seg_preds)[clear].all()


# -- the trainer --------------------------------------------------------------------

def test_compute_dtype_takes_the_names_jnp_dtype_maps_to_the_three():
    names = ["bfloat16", "float16", "half", "f2", "e", "<f2", "=f2", "float32", "single",
             "f4", "f", "<f4", "=f4", "float64", "double", "float", "bf16", ">f2", "int8",
             "Float16"]
    torch_of = {jnp.dtype(jnp.float16): torch.float16,
                jnp.dtype(jnp.bfloat16): torch.bfloat16,
                jnp.dtype(jnp.float32): torch.float32}
    for name in names:
        try:
            want = torch_of.get(jnp.dtype(name))
        except TypeError:
            want = None
        if want is None:
            with pytest.raises(ValueError, match="unsupported trainer.compute_dtype"):
                compute_dtype(name)
        else:
            assert compute_dtype(name) == want, name


def _cli_config(root, dtype):
    """One step of batch 2 at 17 px (torch's float16 conv backward is slow on
    the CPU) and a validation of one batch."""
    data = {"num_classes": CLASSES, "batch_size": 2, "crop_size": 17, "image_hw": 20,
            "shuffle": False, "augment": False, "device_normalize": True}
    return {
        "name": "Float16", "seed": 0,
        "arch": {"type": "PSPNet", "args": {"backbone": "resnet18",
                                            "pallas_stem_wgrad": True}},
        "train_loader": {"type": "Synthetic", "args": {**data, "size": 2}},
        "val_loader": {"type": "Synthetic", "args": {**data, "size": 2, "val": True}},
        "optimizer": {"type": "SGD", "differential_lr": True,
                      "args": {"lr": 0.01, "weight_decay": 1e-4, "momentum": 0.9}},
        "loss": "CrossEntropyLoss2d", "ignore_index": 255,
        "lr_scheduler": {"type": "Poly", "args": {}},
        "trainer": {"epochs": 1, "save_dir": str(root / "saved"), "save_period": 1,
                    "monitor": "max Mean_IoU", "early_stop": 10, "tensorboard": True,
                    "log_dir": str(root / "runs"), "log_per_iter": 1, "val": True,
                    "val_per_epochs": 1, "progress_bar": False, "compute_dtype": dtype},
    }


def test_train_main_trains_and_validates_in_float16(tmp_path):
    trainer = train_cli.main(_cli_config(tmp_path, "float16"), "cpu")
    assert trainer.compute_dtype == torch.float16
    log, = trainer.history
    assert np.isfinite(log["loss"]) and np.isfinite(log["val_loss"])
    assert 0.0 <= log["Mean_IoU"] <= 1.0
    assert trainer.state.step == 1
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())
    names = sorted(p.name for p in next((tmp_path / "saved" / "Float16").iterdir()).iterdir())
    assert {"best_model", "checkpoint-epoch1", "config.json"} <= set(names)
    assert len(list((tmp_path / "runs").glob("*/*/events.out.tfevents.*"))) == 1
    with pytest.raises(ValueError, match="unsupported trainer.compute_dtype 'float8'"):
        train_cli.main(_cli_config(tmp_path, "float8"), "cpu")


def test_no_loss_scaler_anywhere_in_the_port():
    """segtpu has no loss scaler, so float16 runs without one."""
    for path in sorted((REPO / "segtpu_torch").rglob("*.py")):
        assert not re.search(r"GradScaler|loss_scale", path.read_text()), path
