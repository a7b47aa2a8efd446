"""Dataset registry with segtpu's loader names and config surface: VOC, COCO,
ADE20K, CityScapes and DeepScene read from disk, Synthetic is in memory.
Counterpart of ``segtpu/data/__init__.py``."""

from segtpu_torch.data.ade20k import ADE20K
from segtpu_torch.data.base import BaseDataset, DataLoader, DevicePrefetcher  # noqa: F401
from segtpu_torch.data.cityscapes import CityScapes
from segtpu_torch.data.coco import COCO
from segtpu_torch.data.deepscene import DeepScene
from segtpu_torch.data.synthetic import Synthetic
from segtpu_torch.data.voc import VOC

DATASETS = {
    "VOC": VOC,
    "COCO": COCO,
    "ADE20K": ADE20K,
    "CityScapes": CityScapes,
    "DeepScene": DeepScene,
    "Synthetic": Synthetic,
}


def get_loader(name: str, **kwargs):
    if name not in DATASETS:
        raise KeyError(f"unknown dataset {name!r}; available: {sorted(DATASETS)}")
    return DATASETS[name](**kwargs)


def dataset_meta(config):
    """(mean, std, palette, num_classes) of a training config's dataset,
    without the dataset on disk: the manifest datasets answer from their
    manifest, in-memory datasets are built."""
    loader_cfg = config["train_loader"]
    name = loader_cfg["type"]
    if name not in DATASETS:
        raise KeyError(f"unknown dataset {name!r}; available: {sorted(DATASETS)}")
    cls = DATASETS[name]
    cfg_args = loader_cfg.get("args", {})
    if hasattr(cls, "manifest"):
        extra = {k: cfg_args[k] for k in ("mode", "partition", "warp_image")
                 if k in cfg_args}
        m = cls.manifest(split=cfg_args.get("split", "train"), **extra)
        return m.mean, m.std, list(m.palette), m.num_classes
    loader = cls(**cfg_args)
    return (loader.MEAN, loader.STD, loader.dataset.palette,
            loader.dataset.num_classes)
