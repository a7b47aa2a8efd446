"""The port's serving export on the CPU.

A checkpoint exported by ``torch.export`` reloads in a fresh interpreter that
imports no model code of the port, and its program gives the eager serve
module's outputs; at fp32 compute both give segtpu's ``build_serve_fn``
outputs on the same weights: confidences within 1e-4, predictions equal
wherever the top two probabilities are further apart than that.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segtpu.serving import build_serve_fn
from segtpu_torch import export_model
from segtpu_torch.checkpoint import save_checkpoint
from segtpu_torch.core.state import TrainState, make_optimizer
from segtpu_torch.data.synthetic import MEAN, STD
from segtpu_torch.serving import ServeModule, export_checkpoint, load_serving_artifact
from torch_parity import port_pspnet, segtpu_pspnet

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
CLASSES, HW, BATCH = 3, 33, 2
# fp32 on both sides (as tests/test_torch_model.py); probabilities lie in [0, 1]
TOL = 1e-4

RELOAD = """
import sys
import numpy as np
from segtpu_torch.serving import load_serving_artifact
call, meta = load_serving_artifact(sys.argv[1])
preds, conf = call(np.load(sys.argv[2]))
assert "segtpu_torch.models" not in sys.modules, sorted(sys.modules)
np.save(sys.argv[3], preds.numpy())
np.save(sys.argv[4], conf.numpy())
"""


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A port checkpoint of segtpu's PSPNet-R18 weights, segtpu's model and
    variables, and a seeded uint8 batch."""
    model, params, stats = segtpu_pspnet("resnet18", CLASSES, HW)
    port = port_pspnet(params, stats, "resnet18", CLASSES)
    opt, schedules = make_optimizer(port)
    config = {"arch": {"type": "PSPNet", "args": {"backbone": "resnet18"}},
              "train_loader": {"type": "Synthetic", "args": {"num_classes": CLASSES}}}
    root = tmp_path_factory.mktemp("serving")
    path = save_checkpoint(str(root), "best_model", TrainState(port, opt, schedules),
                           1, 0.5, config, "PSPNet")
    images = np.random.default_rng(0).integers(0, 256, (BATCH, HW, HW, 3), np.uint8)
    yield {"ckpt": path, "segtpu": (model, params, stats), "port": port,
           "images": images}
    shutil.rmtree(root, ignore_errors=True)


def _reload_in_fresh_interpreter(artifact, images, tmp_path):
    np.save(tmp_path / "images.npy", images)
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1",
           "HOME": str(tmp_path), "TMPDIR": str(tmp_path)}
    res = subprocess.run(
        [sys.executable, "-c", RELOAD, str(artifact), str(tmp_path / "images.npy"),
         str(tmp_path / "preds.npy"), str(tmp_path / "conf.npy")],
        env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return np.load(tmp_path / "preds.npy"), np.load(tmp_path / "conf.npy")


def _assert_serving_outputs_agree(preds, conf, want_preds, want_conf, probs):
    """Confidences within TOL; predictions equal where the top two of
    ``probs`` (N, H, W, C) are more than TOL apart."""
    assert preds.dtype == np.int32 and conf.dtype == np.float32
    assert preds.shape == conf.shape == want_preds.shape
    assert np.abs(conf - want_conf).max() <= TOL
    top2 = np.sort(probs, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > TOL
    assert (preds == want_preds)[clear].all()


def test_fp32_export_reloads_without_model_code_and_matches_segtpu(weights, tmp_path):
    out = export_checkpoint(weights["ckpt"], str(tmp_path / "art"), batch=BATCH,
                            hw=(HW, HW), device="cpu", compute_dtype=torch.float32)
    meta = json.load(open(os.path.join(out, "serving.json")))
    assert meta["input"] == {"shape": [BATCH, HW, HW, 3], "dtype": "uint8",
                             "layout": "NHWC"}
    assert meta["platforms"] == ["cpu"] and meta["num_classes"] == CLASSES
    assert (meta["mean"], meta["std"]) == (MEAN, STD)
    preds, conf = _reload_in_fresh_interpreter(out, weights["images"], tmp_path)

    serve = ServeModule(weights["port"], MEAN, STD, torch.float32).eval()
    with torch.no_grad():
        eager_preds, eager_conf = (t.numpy() for t in serve(torch.from_numpy(
            weights["images"])))
    model, params, stats = weights["segtpu"]
    seg_preds, seg_conf = (np.asarray(a) for a in build_serve_fn(
        model, params, stats, MEAN, STD, compute_dtype=jnp.float32)(
            jnp.asarray(weights["images"])))
    logits = model.apply({"params": params, "batch_stats": stats},
                         (jnp.asarray(weights["images"], jnp.float32) / 255.0
                          - jnp.asarray(MEAN)) / jnp.asarray(STD), train=False)["out"]
    probs = np.asarray(jax.nn.softmax(logits, axis=-1))
    _assert_serving_outputs_agree(preds, conf, eager_preds, eager_conf, probs)
    _assert_serving_outputs_agree(preds, conf, seg_preds, seg_conf, probs)


def test_export_cli_writes_a_bf16_program_that_matches_the_eager_module(weights, tmp_path):
    """The CLI's default is bf16; the reloaded program and the eager module
    run the same ops on the same weights."""
    out = export_model.main(["--model", weights["ckpt"], "--output",
                             str(tmp_path / "art"), "--batch", str(BATCH),
                             "--hw", f"{HW},{HW}", "--device", "cpu"])
    call, meta = load_serving_artifact(out)
    preds, conf = (t.numpy() for t in call(weights["images"]))
    serve = ServeModule(weights["port"], MEAN, STD).eval()
    with torch.no_grad():
        x = torch.from_numpy(weights["images"])
        eager_preds, eager_conf = (t.numpy() for t in serve(x))
        probs = torch.softmax(serve.logits(x), 1).permute(0, 2, 3, 1).numpy()
    assert serve.model is not weights["port"]
    assert serve.model.initial[0].weight.dtype == torch.bfloat16
    assert serve.model.initial[1].weight.dtype == torch.float32  # BN stays fp32
    _assert_serving_outputs_agree(preds, conf, eager_preds, eager_conf, probs)


def test_export_without_device_raises_without_cuda(weights, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is usable here")
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        export_model.main(["--model", weights["ckpt"], "--output", str(tmp_path)])
