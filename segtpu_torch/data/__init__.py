"""Data loaders. Counterpart of ``segtpu/data``; the in-memory Synthetic
dataset is the one ported so far (the on-disk datasets need image decoding
and cv2's augmentations, which wait for the data slice in ROADMAP)."""

from segtpu_torch.data.synthetic import Synthetic

DATASETS = {"Synthetic": Synthetic}
#: segtpu's manifest-backed datasets, which the data slice ports
ON_DISK = ("VOC", "COCO", "ADE20K", "CityScapes", "DeepScene")


def dataset_meta(config):
    """(mean, std, palette, num_classes) of a training config's dataset,
    without the dataset on disk. Counterpart of
    ``segtpu/data/__init__.py::dataset_meta``: in-memory datasets are built."""
    loader_cfg = config["train_loader"]
    name = loader_cfg["type"]
    if name in ON_DISK:
        raise NotImplementedError(
            f"dataset {name!r} is not ported yet: the on-disk datasets come "
            f"with the data slice (ROADMAP)")
    if name not in DATASETS:
        raise KeyError(f"unknown dataset {name!r}; available: {sorted(DATASETS)}")
    loader = DATASETS[name](**loader_cfg.get("args", {}))
    return (loader.MEAN, loader.STD, loader.dataset.palette,
            loader.dataset.num_classes)
