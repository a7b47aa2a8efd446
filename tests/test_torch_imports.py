"""The port stands alone: segtpu_torch, chip_smoke.py and scripts/torch_*.py
import no JAX, no flax, optax or orbax, nothing of segtpu, no cv2, no
tensorboardX (the GPU machine lacks it; the port writes events through
tensorboard's own writer, ``torch.utils.tensorboard``), and PIL nowhere at
module scope."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
SOURCES = (sorted((REPO / "segtpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
           + sorted((REPO / "scripts").glob("torch_*.py")))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "segtpu", "cv2", "tensorboardX")
NOT_AT_MODULE_SCOPE = ("PIL",)


def _imports(tree):
    """(module name, at module scope) for every import in the tree."""
    top = {id(n) for n in tree.body}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, id(node) in top
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module, id(node) in top


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_imports(path):
    for name, module_scope in _imports(ast.parse(path.read_text())):
        root = name.split(".")[0]
        assert root not in FORBIDDEN, f"{path.name} imports {name}"
        assert not (module_scope and root in NOT_AT_MODULE_SCOPE), (
            f"{path.name} imports {name} at module scope")


def test_importing_the_port_loads_no_jax():
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "segtpu_torch").rglob("*.py"))
    code = ("import sys\n" + "".join(f"import {m}\n" for m in modules)
            + "import chip_smoke\n"
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
            + f"{FORBIDDEN + NOT_AT_MODULE_SCOPE!r}]\n"
            + "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]


#: the losses, optimizer and DeepLab slice's modules and the last zoo
#: slice's, and what each must define, imported alone
SLICE_MODULES = {
    "segtpu_torch.losses": ("LOSSES", "lovasz_softmax", "lovasz_softmax_binned",
                            "lovasz_hinge", "binary_xloss", "get_weights"),
    "segtpu_torch.ops.lovasz_hist": ("histograms_compare", "histograms_onehot"),
    "segtpu_torch.backbones.xception": ("XceptionBlock", "XceptionFeatures"),
    "segtpu_torch.models.deeplabv3_plus": ("DeepLab", "DeepLabDecoder"),
    "segtpu_torch.utils.weight_convert": ("deeplab_state_dict_from_segtpu",
                                          "enet_state_dict_from_segtpu",
                                          "gcn_state_dict_from_segtpu",
                                          "fcn8_state_dict_from_segtpu",
                                          "pspdensenet_state_dict_from_segtpu"),
    # the last zoo slice's modules
    "segtpu_torch.models.enet": ("ENet", "Bottleneck", "InitialBlock"),
    "segtpu_torch.models.gcn": ("GCN", "GCNBlock", "BRBlock", "BottleneckGCN", "ResnetGCN"),
    "segtpu_torch.models.fcn": ("FCN8", "FixedUpsample"),
    "segtpu_torch.backbones.densenet": ("DENSENET_CONFIG", "DenseLayer", "DenseBlock",
                                        "DenseNetFeatures"),
    "segtpu_torch.ops.shape": ("pad_or_crop_tl",),
    # the pretrained encoders and the trainer's runtime
    "segtpu_torch.pretrained": ("checkpoint_id", "resolve_path", "apply_pretrained",
                                "maybe_load_pretrained", "remap", "file_layout"),
    "segtpu_torch.utils.logger": ("Logger", "setup_logging"),
    "segtpu_torch.utils.summary": ("count_params", "count_bn_stats", "summary", "describe"),
    "segtpu_torch.utils.transforms": ("Compose", "DeNormalize", "RandomCrop", "CenterCrop",
                                      "RandomHorizontallyFlip", "Scale", "RandomSizedCrop",
                                      "RandomRotate", "SlidingCrop"),
    # segtpu's prediction argmax and its index-free stats
    "segtpu_torch.ops.reductions": ("fast_argmax", "packed_argmax", "onehot_first_max"),
    "segtpu_torch.metrics": ("ARGMAX_VARIANTS", "seg_stats_from_logits",
                             "seg_stats_from_logits_onehot", "eval_metrics"),
}


@pytest.mark.parametrize("module", sorted(SLICE_MODULES))
def test_slice_module_alone_loads_no_jax(module):
    path = REPO.joinpath(*module.split(".")).with_suffix(".py")
    assert path in SOURCES  # so test_no_forbidden_imports reads every line of it
    names = SLICE_MODULES[module]
    code = (f"import sys, {module} as m\n"
            f"missing = [n for n in {names!r} if not hasattr(m, n)]\n"
            "assert not missing, missing\n"
            "bad = [k for k in sys.modules if k.split('.')[0] in "
            f"{FORBIDDEN + NOT_AT_MODULE_SCOPE!r}]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
