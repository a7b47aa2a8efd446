"""Pretrained encoders from local ``.pth`` files (``segtpu_torch/pretrained.py``)
against segtpu's ``pretrained.py``, on the CPU.

Every file is written from seeded numpy arrays in the original key layout:
torchvision's ResNet-50, VGG-16(-BN) and DenseNet-121 from
``tests/torchvision_fixture.py`` (built on the meta device, for the keys and
shapes only); ResNet-18 (torchvision), the encoding deep base and DeepLab's
aligned Xception from the port's own backbones, renamed to the original
keys. segtpu's side takes the same file through ``scripts/convert_weights.py``
(in this process), an orbax save and ``segtpu.pretrained.
maybe_load_pretrained``; the port's side through its own loader. Both start
from the port's init (segtpu's through ``MODEL_CONVERTERS``), so the
merged variables must be equal bit for bit: they are copies. GCN's
ResnetGCN backbone, which segtpu's converter does not read, goes the other
way: segtpu's init into the port through ``gcn_state_dict_from_segtpu``.
FCN8 (a full VGG-16 file with its classifier is about 530 MB) holds its
conv6/conv7 against ``convert_vgg16_classifier`` on the same arrays and its
VGG against ``convert_vgg16``, merged by segtpu's own ``_merge_subtree``,
without orbax; that model is built once.

The 7x7 DenseNet stem: PSPDenseNet-121 with ``pretrained`` set (its growth,
stem and widths, two layers a block: DENSE_NARROW), at 65 px, fp32 eval
logits within 1e-4 of the largest of segtpu's and one float64 SGD step at
the tolerances of ``torch_zoo.py``. The Trainer: the load before the first
step, the optimizer still owning the loaded parameters, a resume over it,
and the inference CLI on a checkpoint whose config asks for a file that is
gone.
"""

import dataclasses
import functools
import importlib.util
import os
import pathlib
import shutil
import sys

import flax.traverse_util as tu
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from segtpu import pretrained as seg_pretrained
from segtpu.backbones import densenet as seg_densenet
from segtpu.models import get_model as seg_get_model
from segtpu.models.gcn import GCN as SegtpuGCN
from segtpu.models.pspnet import PSPDenseNet as SegtpuPSPDenseNet
from segtpu.utils import weight_convert as wc
from segtpu_torch import inference as inference_cli
from segtpu_torch import pretrained
from segtpu_torch.backbones import densenet as port_densenet
from segtpu_torch.backbones.resnet import ResNetFeatures
from segtpu_torch.backbones.xception import XceptionFeatures
from segtpu_torch.data import Synthetic
from segtpu_torch.models import MODELS, get_model
from segtpu_torch.trainer import Trainer
from segtpu_torch.utils.weight_convert import (gcn_state_dict_from_segtpu,
                                               pspdensenet_state_dict_from_segtpu)
from torch_parity import _init_segtpu
import torch_zoo as zoo
import torchvision_fixture as tv

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
CLASSES = 3
# DenseNet-121's growth and stem with two layers a block, set at run time in
# both packages' DENSENET_CONFIG (nothing in segtpu changes): the stem, the
# transitions and the head keep their widths, the file the torchvision
# layout, and JAX compiles the float64 step in seconds
DENSE_NARROW = (32, (2, 2, 2, 2), 64)


# -- file layouts and seeded files ------------------------------------------

def _shapes(module) -> dict:
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


def _meta(build):
    with torch.device("meta"):
        return _shapes(build())


def _resnet_layout(arch: str, style: str = "torchvision") -> dict:
    """The original ResNet keys (``conv1``: torchvision's conv, or the deep
    base's Sequential; ``bn1``; ``layerN``; ``fc``) of the port's own
    backbone."""
    with torch.device("meta"):
        feats = ResNetFeatures(arch=arch, style=style)
    out = {}
    for k, shape in _shapes(feats).items():
        for mine, theirs in (("initial.0.", "conv1."), ("initial.1.", "bn1.")):
            if k.startswith(mine):
                k = theirs + k[len(mine):]
        out[k] = shape
    out["fc.weight"], out["fc.bias"] = (10, feats.out_channels), (10,)
    return out


def _xception_layout() -> dict:
    """DeepLab's aligned Xception, the layout segtpu's ``convert_xception``
    reads: the port's backbone keys with the pointwise weights 2-D, without
    blocks 13-19 (read from block11) and bn4 (read from bn3), with an
    ``fc``."""
    with torch.device("meta"):
        shapes = _shapes(XceptionFeatures(16, 3))
    out = {}
    for k, shape in shapes.items():
        if k.split(".")[0] in {f"block{i}" for i in range(13, 20)} | {"bn4"}:
            continue
        out[k] = shape[:2] if "pointwise" in k else shape
    out["fc.weight"], out["fc.bias"] = (10, 2048), (10,)
    return out


def _seeded(layout: dict, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    for k in sorted(layout):
        shape = layout[k]
        if k.endswith("num_batches_tracked"):
            out[k] = np.array(7, np.int64)
        elif k.endswith("running_var"):
            out[k] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        else:
            out[k] = (rng.random(shape, dtype=np.float32) - np.float32(0.5)) * np.float32(0.1)
    return out


def _write(path, arrays: dict) -> str:
    torch.save({k: torch.from_numpy(v) for k, v in arrays.items()}, str(path))
    return str(path)


# -- segtpu's side ----------------------------------------------------------

@functools.cache
def _convert_weights_main():
    spec = importlib.util.spec_from_file_location(
        "convert_weights", REPO / "scripts" / "convert_weights.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.main


@dataclasses.dataclass
class _State:
    params: dict
    batch_stats: dict

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def _segtpu_load(monkeypatch, flags, pth, root, cid, seg_model, params, stats):
    """``pth`` through convert_weights.py into ``<root>/<cid>``, merged into
    (params, stats) by segtpu's ``maybe_load_pretrained``."""
    monkeypatch.setattr(sys, "argv", ["convert_weights.py", *flags, "--input", pth,
                                      "--output", os.path.join(root, cid)])
    _convert_weights_main()()
    new = seg_pretrained.maybe_load_pretrained(_State(params, stats), seg_model,
                                               {"pretrained_dir": root})
    return new.params, new.batch_stats


def _assert_trees_equal(got, want):
    fg, fw = tu.flatten_dict(got), tu.flatten_dict(want)
    assert set(fg) == set(fw)
    for k in fw:
        g, w = np.asarray(fg[k]), np.asarray(fw[k])
        assert g.shape == w.shape and np.array_equal(g, w), k


def _numpy_sd(model):
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def _assert_only_backbone_moved(model, before):
    """The head is its init; the backbone took the file."""
    moved = {k for k, v in model.state_dict().items()
             if not np.array_equal(v.numpy(), before[k])}
    backbone = {k for k in before if k.split(".")[0] in model.backbone_modules}
    assert moved and moved <= backbone, sorted(moved - backbone)[:5]
    return moved


# -- one case per file family -----------------------------------------------

R18 = functools.partial(_resnet_layout, "resnet18")
CASES = {
    # name: (model, args, converter, converter args, convert_weights flags,
    #        layout, file id)
    "torchvision-UperNet-R18": ("UperNet", {"backbone": "resnet18", "fpn_out": 16},
                                "UperNet", {"arch": "resnet18"},
                                ["--family", "resnet", "--arch", "resnet18"], R18, "resnet18"),
    "torchvision-DeepLab-R18": ("DeepLab", {"backbone": "resnet18"}, "DeepLab-resnet",
                                {"arch": "resnet18"},
                                ["--family", "resnet", "--arch", "resnet18"], R18, "resnet18"),
    "torchvision-DUC_HDC-R18": ("DeepLab_DUC_HDC", {"backbone": "resnet18"},
                                "DeepLab_DUC_HDC", {"arch": "resnet18"},
                                ["--family", "resnet", "--arch", "resnet18"], R18, "resnet18"),
    "torchvision-GCN-R18": ("GCN", {"backbone": "resnet18"}, "GCN", {"arch": "resnet18"},
                            ["--family", "resnet", "--arch", "resnet18"], R18, "resnet18"),
    "torchvision-SegResNet": ("SegResNet", {}, "SegResNet", {},
                              ["--family", "resnet", "--arch", "resnet50"],
                              lambda: _meta(tv.resnet50), "resnet50"),
    "encoding-PSPNet-R50": ("PSPNet", {"backbone": "resnet50"}, "PSPNet", {"arch": "resnet50"},
                            ["--family", "resnet", "--arch", "resnet50", "--style", "encoding"],
                            lambda: _resnet_layout("resnet50", "encoding"), "resnet50s"),
    "encoding-PSPNet-R18": ("PSPNet", {"backbone": "resnet18"}, "PSPNet", {"arch": "resnet18"},
                            ["--family", "resnet", "--arch", "resnet18", "--style", "encoding"],
                            R18, "resnet18s"),
    "encoding-UNetResnet-R18": ("UNetResnet", {"backbone": "resnet18"}, "UNetResnet",
                                {"arch": "resnet18"},
                                ["--family", "resnet", "--arch", "resnet18", "--style",
                                 "encoding"], R18, "resnet18s"),
    "vgg16bn-SegNet": ("SegNet", {}, "SegNet", {}, ["--family", "vgg16", "--bn"],
                       lambda: {k: v for k, v in _meta(tv.vgg16_bn).items()
                                if not k.startswith("classifier.0.")}, "vgg16_bn"),
    "densenet-PSPDenseNet-121": ("PSPDenseNet", {"backbone": "densenet121"}, "PSPDenseNet",
                                 {"arch": "densenet121", "pretrained_stem": True},
                                 ["--family", "densenet", "--arch", "densenet121"],
                                 lambda: _meta(lambda: tv.DenseNet(*DENSE_NARROW)),
                                 "densenet121"),
    "xception-DeepLab": ("DeepLab", {"backbone": "xception"}, "DeepLab", {},
                         ["--family", "xception"], _xception_layout, "xception"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pretrained_load_equals_segtpus_merge(case, tmp_path, monkeypatch):
    """The port's load of a seeded file, read by segtpu's MODEL_CONVERTERS,
    equals segtpu's convert-and-merge of the same file bit for bit; the
    head keeps its init."""
    name, args, conv, conv_kw, flags, layout, cid = CASES[case]
    if name == "PSPDenseNet":  # two layers a block (see DENSE_NARROW)
        for config in (seg_densenet.DENSENET_CONFIG, port_densenet.DENSENET_CONFIG):
            monkeypatch.setitem(config, "densenet121", DENSE_NARROW)
    model = get_model(name, device="cpu", num_classes=CLASSES, pretrained=True, **args)
    before = _numpy_sd(model)
    params, stats = wc.MODEL_CONVERTERS[conv](before, **conv_kw)
    pth = _write(tmp_path / f"{cid}.pth", _seeded(layout(), 1))
    assert pretrained.checkpoint_id(model) == cid
    read = {k for k, _ in pretrained.remap(model, pretrained.read_state_dict(pth)).values()}
    assert read <= set(pretrained.file_layout(model))
    assert pretrained.maybe_load_pretrained(model, {"pretrained_dir": str(tmp_path)}) == pth
    want_p, want_s = _segtpu_load(monkeypatch, flags, pth, str(tmp_path), cid,
                                  seg_get_model(name, num_classes=CLASSES, pretrained=True,
                                                **args), params, stats)
    got_p, got_s = wc.MODEL_CONVERTERS[conv](_numpy_sd(model), **conv_kw)
    _assert_trees_equal(got_p, want_p)
    _assert_trees_equal(got_s, want_s)
    _assert_only_backbone_moved(model, before)


def _seeded_tree(seg_model, seed):
    """segtpu's variables for ``seg_model`` (their shapes by tracing its
    init, no compile), seeded; running variances positive."""
    shapes = jax.eval_shape(lambda k, x: seg_model.init({"params": k, "dropout": k}, x,
                                                        train=False),
                            jax.random.PRNGKey(0), jnp.zeros((1, 33, 33, 3)))
    rng = np.random.default_rng(seed)
    out = {}
    for group in ("params", "batch_stats"):
        flat = tu.flatten_dict(shapes[group])
        out[group] = tu.unflatten_dict({
            k: (rng.uniform(0.5, 1.5, v.shape) if k[-1] == "var"
                else rng.normal(0.0, 0.05, v.shape)).astype(np.float32)
            for k, v in sorted(flat.items())})
    return out["params"], out["batch_stats"]


def test_gcn_resnet_gcn_loads_the_stem_and_layer1_2_only(tmp_path, monkeypatch):
    """ResnetGCN: a partial load of a torchvision ResNet-18 file, its
    layer3/4 blocks skipped, not loaded into the GCN bottlenecks that share
    their names."""
    seg_model = SegtpuGCN(num_classes=CLASSES, backbone="resnet18", use_resnet_gcn=True,
                          pretrained=True)
    params, stats = _seeded_tree(seg_model, 0)
    model = get_model("GCN", device="cpu", num_classes=CLASSES, backbone="resnet18",
                      use_resnet_gcn=True, pretrained=True)
    model.load_state_dict(gcn_state_dict_from_segtpu(params, stats), strict=True)
    before = _numpy_sd(model)
    arrays = _seeded(R18(), 2)
    pth = _write(tmp_path / "resnet18.pth", arrays)
    pretrained.maybe_load_pretrained(model, {"pretrained_dir": str(tmp_path)})
    want_p, want_s = _segtpu_load(monkeypatch, ["--family", "resnet", "--arch", "resnet18"],
                                  pth, str(tmp_path), "resnet18", seg_model, params, stats)
    want = gcn_state_dict_from_segtpu(want_p, want_s)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], v), k
    moved = _assert_only_backbone_moved(model, before)
    assert {k.split(".")[1] for k in moved} == {"initial", "layer1", "layer2"}
    np.testing.assert_array_equal(got["backbone.layer2.1.bn2.running_var"].numpy(),
                                  arrays["layer2.1.bn2.running_var"])


@pytest.fixture(scope="module")
def fcn8():
    """FCN8 at VGG-16's widths, and a seeded full torchvision VGG-16 file
    (classifier included), written once."""
    root = pathlib.Path(os.environ.get("TMPDIR", "/tmp")) / f"fcn8_pth_{os.getpid()}"
    root.mkdir(exist_ok=True)
    arrays = _seeded(_meta(tv.vgg16), 3)
    pth = _write(root / "vgg16.pth", arrays)
    yield get_model("FCN8", device="cpu", num_classes=CLASSES, pretrained=True), arrays, pth
    shutil.rmtree(root, ignore_errors=True)


def test_fcn8_loads_vgg_and_its_classifier_as_conv6_conv7(fcn8):
    """Read by ``convert_fcn8``, the loaded VGG is ``convert_vgg16``'s and
    conv6/conv7 are ``convert_vgg16_classifier``'s of the same arrays, bit
    for bit; the score conv and the decoder keep their init."""
    model, arrays, pth = fcn8
    loaded = ("pool3.", "pool4.", "pool5.", "output.0.", "output.3.")
    head = {k: v.clone() for k, v in model.state_dict().items() if not k.startswith(loaded)}
    pretrained.apply_pretrained(model, pth)
    got, _ = wc.convert_fcn8({k: v.numpy() for k, v in model.state_dict().items()})
    _assert_trees_equal(got["backbone"], wc.convert_vgg16(arrays, batch_norm=False)[0])
    for name, want in wc.convert_vgg16_classifier(arrays).items():
        _assert_trees_equal(got[name], want)
    for k, v in head.items():
        assert torch.equal(model.state_dict()[k], v), k


def test_fcn8_without_the_classifier_raises(fcn8, tmp_path):
    model, arrays, _ = fcn8
    pth = _write(tmp_path / "vgg16.pth",
                 {k: v for k, v in arrays.items() if k.startswith("features.")})
    with pytest.raises(ValueError, match="classifier"):
        pretrained.apply_pretrained(model, pth)


# -- the 7x7 DenseNet stem ----------------------------------------------------

DENSE_HW, DENSE_CLASSES = 65, 5


@pytest.fixture(scope="module")
def dense():
    """(segtpu's PSPDenseNet with ``pretrained``, its variables, the port's
    model on them), under the narrowed config."""
    with pytest.MonkeyPatch.context() as mp:
        for config in (seg_densenet.DENSENET_CONFIG, port_densenet.DENSENET_CONFIG):
            mp.setitem(config, "densenet121", DENSE_NARROW)
        seg_model, params, stats = _init_segtpu(SegtpuPSPDenseNet(
            num_classes=DENSE_CLASSES, backbone="densenet121", pretrained=True), DENSE_HW, 0)

        def port():
            model = get_model("PSPDenseNet", device="cpu", num_classes=DENSE_CLASSES,
                              backbone="densenet121", pretrained=True)
            model.load_state_dict(pspdensenet_state_dict_from_segtpu(params, stats),
                                  strict=True)
            return model

        yield seg_model, params, stats, port


def test_pspdensenet_pretrained_stem_is_segtpus_7x7(dense):
    seg_model, params, stats, port = dense
    model = port()
    assert model.block0[0].weight.shape == (64, 3, 7, 7) and len(model.block0) == 4
    assert get_model("PSPDenseNet", device="cpu", num_classes=DENSE_CLASSES,
                     backbone="densenet121").block0[0].weight.shape == (64, 3, 3, 3)
    zoo.assert_round_trip(params, stats, model, wc.convert_pspdensenet, arch="densenet121",
                          pretrained_stem=True)
    zoo.assert_eval_matches(seg_model, params, stats, model, zoo.images(0, DENSE_HW, 2))


def test_pspdensenet_pretrained_stem_step_matches_segtpu(dense):
    seg_model, params, stats, port = dense
    seg, got = zoo.trajectories(seg_model, params, stats, port(),
                                pspdensenet_state_dict_from_segtpu, DENSE_CLASSES,
                                zoo.batches(1, DENSE_HW, 2, DENSE_CLASSES))
    zoo.assert_step_matches(seg, got, 1)


# -- failures -------------------------------------------------------------------

def _fake(name, value=True):
    """A stand-in for model ``name`` that both packages resolve: its class
    name and fields, and the port's ``pretrained_layout`` where the port's
    model has one."""
    attrs = {"pretrained": value, "backbone_name": "resnet18", "backbone": "resnet18"}
    layout = getattr(MODELS[name], "pretrained_layout", None)
    if layout is not None:
        attrs["pretrained_layout"] = layout
    return type(name, (), attrs)()


@pytest.mark.parametrize("case", ["no-root", "missing-file", "missing-path", "UNet", "ENet"])
def test_resolution_errors_have_segtpus_types(case, tmp_path, monkeypatch):
    monkeypatch.delenv("SEGTPU_PRETRAINED_DIR", raising=False)
    config = {} if case == "no-root" else {"pretrained_dir": str(tmp_path)}
    name = case if case in ("UNet", "ENet") else "PSPNet"
    value = str(tmp_path / "nope") if case == "missing-path" else True
    errors = []
    for module in (pretrained, seg_pretrained):
        with pytest.raises(Exception) as info:
            module.resolve_path(_fake(name, value), config)
        errors.append(type(info.value))
    want = {"no-root": RuntimeError, "UNet": ValueError, "ENet": ValueError}.get(
        case, FileNotFoundError)
    assert errors == [want, want]


@pytest.mark.parametrize("name", ["UNet", "ENet"])
def test_models_without_an_encoder_take_no_pretrained(name):
    with pytest.raises(TypeError):
        get_model(name, device="cpu", num_classes=CLASSES, pretrained=True)
    with pytest.raises(TypeError):
        seg_get_model(name, num_classes=CLASSES, pretrained=True)


@pytest.mark.parametrize("case", ["shape", "deep-base-on-r18", "unknown-key"])
def test_bad_files_raise_and_leave_the_model_untouched(case, tmp_path):
    """A wrong shape (ValueError naming the key), a deep-base stem for a
    ResNet-18 whose stem is torchvision's, and a key with no place in the
    model (KeyError, as segtpu's converter and merge raise)."""
    model = get_model("PSPNet", device="cpu", num_classes=CLASSES, backbone="resnet18",
                      pretrained=True)
    before = _numpy_sd(model)
    arrays = _seeded(R18(), 4)
    if case == "shape":
        arrays["layer2.0.conv1.weight"] = arrays["layer2.0.conv1.weight"][:, :, :2]
        err, match = ValueError, r"shape mismatch at 'layer2\.0\.conv1\.weight'"
    elif case == "deep-base-on-r18":
        arrays["conv1.0.weight"] = arrays.pop("conv1.weight")
        err, match = KeyError, "conv1.0.weight"
    else:
        arrays["layer5.0.conv1.weight"] = arrays["layer4.0.conv1.weight"]
        err, match = KeyError, "layer5.0.conv1.weight"
    with pytest.raises(err, match=match):
        pretrained.apply_pretrained(model, _write(tmp_path / "r.pth", arrays))
    after = _numpy_sd(model)
    assert all(np.array_equal(after[k], v) for k, v in before.items())


# -- the Trainer ------------------------------------------------------------------

def _config(root, **trainer):
    synthetic = {"batch_size": 2, "num_classes": CLASSES, "crop_size": 33,
                 "num_workers": 1, "device_normalize": True}
    return {
        "name": "TinyPretrained", "seed": 0, "pretrained_dir": str(root),
        "arch": {"type": "PSPNet", "args": {"backbone": "resnet18", "pretrained": True}},
        "train_loader": {"type": "Synthetic", "args": {
            **synthetic, "size": 4, "image_hw": 40, "flip": True}},
        "val_loader": {"type": "Synthetic", "args": {
            **synthetic, "size": 2, "image_hw": 33, "val": True,
            "augment": False, "shuffle": False}},
        "optimizer": {"type": "SGD", "differential_lr": True,
                      "args": {"lr": 0.01, "weight_decay": 1e-4, "momentum": 0.9}},
        "loss": "CrossEntropyLoss2d", "ignore_index": 255,
        "lr_scheduler": {"type": "Poly", "args": {}},
        "trainer": {"epochs": 1, "save_dir": str(root / "saved"), "save_period": 1,
                    "log_dir": str(root / "runs"), "tensorboard": False,
                    "monitor": "max Mean_IoU", "compute_dtype": "float32", **trainer},
    }


def _trainer(config, resume=None):
    args = config["arch"]["args"]
    model = get_model("PSPNet", device="cpu", num_classes=CLASSES, **args)
    return Trainer(model, "CrossEntropyLoss2d", config,
                   Synthetic(**config["train_loader"]["args"]),
                   Synthetic(**config["val_loader"]["args"]), device="cpu", resume=resume)


def _file_keys(model):
    """(model key, file key) of the ResNet-18 file's backbone tensors."""
    return [(t, k) for t, (k, _) in pretrained.remap(
        model, {k: torch.zeros(()) for k in R18()}).items()]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A Trainer that loaded a seeded resnet18s.pth, its weights before its
    two steps (the second at Poly's last rate, 0), and the run's
    checkpoint."""
    root = tmp_path_factory.mktemp("pretrained_trainer")
    arrays = _seeded(R18(), 5)
    _write(root / "resnet18s.pth", arrays)
    trainer = _trainer(_config(root))
    loaded = _numpy_sd(trainer.model)
    owned = {id(p) for g in trainer.state.optimizer.param_groups for p in g["params"]}
    trainer.train()
    return {"root": root, "arrays": arrays, "trainer": trainer, "loaded": loaded,
            "owned": owned,
            "checkpoint": os.path.join(trainer.checkpoint_dir, "checkpoint-epoch1")}


def test_trainer_loads_before_the_first_step_and_the_step_moves_it(trained):
    """Before the first step the backbone is the file's; the optimizer owns
    the loaded parameters, and the first step moves them."""
    model, arrays = trained["trainer"].model, trained["arrays"]
    pairs = _file_keys(model)
    assert len(pairs) == len([k for k in R18() if not k.startswith("fc.")
                              and not k.endswith("num_batches_tracked")])
    for target, key in pairs:
        np.testing.assert_array_equal(trained["loaded"][target], arrays[key], err_msg=target)
    assert trained["owned"] == {id(p) for p in model.parameters()}
    after = _numpy_sd(model)
    assert not np.array_equal(after["initial.0.weight"], arrays["conv1.weight"])
    assert not np.array_equal(after["layer4.1.conv2.weight"], arrays["layer4.1.conv2.weight"])
    assert trained["trainer"].state.step == 2


def test_a_resume_overwrites_the_pretrained_weights(trained):
    trainer = _trainer(_config(trained["root"]), resume=trained["checkpoint"])
    got, want = _numpy_sd(trainer.model), _numpy_sd(trained["trainer"].model)
    assert all(np.array_equal(got[k], v) for k, v in want.items())
    assert not np.array_equal(got["initial.0.weight"], trained["arrays"]["conv1.weight"])


def test_inference_cli_runs_without_the_pretrained_file(trained, tmp_path):
    """The checkpoint's config says pretrained: true, and its pretrained_dir
    holds no file: the CLI rebuilds the model and loads the checkpoint."""
    shutil.copytree(trained["checkpoint"], tmp_path / "ck")
    os.remove(trained["root"] / "resnet18s.pth")
    images = tmp_path / "images"
    images.mkdir()
    Image.fromarray(np.random.default_rng(0).integers(0, 256, (40, 48, 3), np.uint8)).save(
        images / "a.png")
    result = inference_cli.main(["--model", str(tmp_path / "ck"), "--images", str(images),
                                 "--output", str(tmp_path / "out"), "--extension", "png",
                                 "--mode", "sliding", "--device", "cpu"])
    assert [os.path.basename(p) for p in result["written"]] == ["a.png"]
