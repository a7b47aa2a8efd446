"""One and three train steps of PSPNet-ResNet18 with the stem weight
gradient through the port's kernel module, against segtpu's
``make_train_step`` on the same weights and batches, in fp32 on the CPU.

On segtpu's side the stem weight gradient runs segtpu's Pallas kernel in
interpret mode (monkeypatched, as tests/test_conv_wgrad.py does), and
flax's Dropout is the identity; on the port's side dropout has p=0.
"""

import flax
import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segtpu import losses as seg_losses
from segtpu.core import state as seg_state
from segtpu.core.steps import make_eval_step as seg_make_eval_step
from segtpu.core.steps import make_train_step as seg_make_train_step
from segtpu.ops import conv_wgrad as seg_cw
from segtpu.utils.weight_convert import convert_pspnet
from segtpu_torch import losses
from segtpu_torch.core.state import TrainState, make_optimizer
from segtpu_torch.core.steps import make_eval_step, make_train_step
from segtpu_torch.ops import conv_wgrad as cw
from torch_parity import IdentityDropout, no_dropout, port_pspnet, rel_max, segtpu_pspnet

torch.set_num_threads(1)

# batch 8: the PSP bin-1 BN normalizes over the batch alone, where segtpu's
# E[x^2] - mean^2 loses digits when there are few samples
CLASSES, HW, BATCH, STEPS = 4, 33, 8, 3
NORM = ([0.5, 0.5, 0.5], [0.25, 0.25, 0.25])
OPT = dict(lr=0.01, num_epochs=1, iters_per_epoch=10)
# fp32 on both sides; BN variance formulas differ at ~1e-6 and depth and
# three updates amplify that: every parameter, running stat and the loss
# hold 1e-4 relative (max |diff| over max |segtpu|)
TOL = 1e-4


def _batches():
    rng = np.random.default_rng(7)
    for _ in range(STEPS + 1):
        images = rng.integers(0, 256, size=(BATCH, HW, HW, 3)).astype(np.uint8)
        labels = rng.integers(0, CLASSES, size=(BATCH, HW, HW)).astype(np.int32)
        labels[:, :5, :5] = 255
        yield images, labels


@pytest.fixture(scope="module")
def trajectories():
    """Snapshots after updates 1 and 3, from segtpu and from the port, plus
    the eval step on a fresh batch after update 3."""
    batches = list(_batches())
    model, params, stats = segtpu_pspnet("resnet18", CLASSES, HW, seed=1,
                                         pallas_stem_wgrad=True)
    port = no_dropout(port_pspnet(params, stats, "resnet18", CLASSES,
                                  pallas_stem_wgrad=True))
    orig_wgrad = seg_cw.stem_conv_wgrad
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "Dropout", IdentityDropout)
        mp.setattr(seg_cw, "stem_conv_wgrad",
                   lambda x, g, kernel=7, interpret=False: orig_wgrad(
                       x, g, kernel=kernel, interpret=True))
        tx = seg_state.make_optimizer(**OPT)
        jstate = seg_state.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                      batch_stats=stats, opt_state=tx.init(params),
                                      tx=tx)
        jstep = seg_make_train_step(model, seg_losses.cross_entropy, CLASSES,
                                    compute_dtype=jnp.float32, norm_stats=NORM)
        jeval = seg_make_eval_step(model, seg_losses.cross_entropy, CLASSES,
                                   compute_dtype=jnp.float32, norm_stats=NORM)
        seg_snaps = {}
        for i, (images, labels) in enumerate(batches[:STEPS]):
            jstate, loss, st = jstep(jstate, jnp.asarray(images), jnp.asarray(labels),
                                     jax.random.PRNGKey(0))
            seg_snaps[i + 1] = jax.tree_util.tree_map(np.asarray, (
                loss, tuple(st), jstate.params, jstate.batch_stats))
        images, labels = batches[STEPS]
        seg_eval = jax.tree_util.tree_map(np.asarray, jeval(
            jstate, jnp.asarray(images), jnp.asarray(labels)))

    opt, scheds = make_optimizer(port, **OPT)
    state = TrainState(port, opt, scheds)
    step = make_train_step(losses.cross_entropy, compute_dtype=torch.float32,
                           norm_stats=NORM)
    launches = cw.stem_conv_wgrad.launches
    port_snaps = {}
    for i, (images, labels) in enumerate(batches[:STEPS]):
        loss, st = step(state, torch.from_numpy(images), torch.from_numpy(labels))
        sd = {k: v.numpy().copy() for k, v in port.state_dict().items()}
        p, s = convert_pspnet(sd, arch="resnet18")
        port_snaps[i + 1] = (loss.numpy(), tuple(t.numpy() for t in st), p, s)
    assert cw.stem_conv_wgrad.launches == launches  # the CPU ran the plain version
    images, labels = batches[STEPS]
    ev = make_eval_step(losses.cross_entropy, compute_dtype=torch.float32,
                        norm_stats=NORM)
    loss, st, _ = ev(port, torch.from_numpy(images), torch.from_numpy(labels))
    port_eval = (loss.numpy(), tuple(t.numpy() for t in st))
    return seg_snaps, port_snaps, seg_eval, port_eval


def _check_stats(got, want):
    """Seg stats are integer counts. A pixel whose two top logits are closer
    than the fp32 noise may flip its argmax: allow 2 such pixels."""
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=2)


@pytest.mark.parametrize("n_steps", [1, STEPS])
def test_train_steps_match_segtpu(trajectories, n_steps):
    seg_snaps, port_snaps, _, _ = trajectories
    w_loss, w_stats, w_params, w_bstats = seg_snaps[n_steps]
    g_loss, g_stats, g_params, g_bstats = port_snaps[n_steps]
    assert rel_max(g_loss, w_loss) < TOL
    _check_stats(g_stats, w_stats)
    for want, got in ((w_params, g_params), (w_bstats, g_bstats)):
        flat_w = flax.traverse_util.flatten_dict(want)
        flat_g = flax.traverse_util.flatten_dict(got)
        assert set(flat_w) == set(flat_g)
        for k in flat_w:
            assert rel_max(flat_g[k], flat_w[k]) < TOL, k


def test_eval_step_after_training_matches_segtpu(trajectories):
    _, _, (w_loss, w_stats), (g_loss, g_stats) = trajectories
    assert rel_max(g_loss, w_loss) < TOL
    _check_stats(g_stats, w_stats)
