"""Vision datasets (port of ``paddle_tpu/vision/datasets.py``; reference
python/paddle/vision/datasets/): ``FakeImageNet`` and the synthetic
``MNIST`` / ``Cifar10`` (no downloads: the same seeded numpy draws as the
JAX package's, so both packages yield the same samples), and
``DatasetFolder`` / ``ImageFolder`` over local ``.npy`` files.  Samples are
numpy arrays; the ``DataLoader`` collates them into CPU tensors."""
from __future__ import annotations

import os

import numpy as np

from ..io import Dataset

__all__ = ["FakeImageNet", "DatasetFolder", "ImageFolder", "MNIST", "Cifar10"]


class FakeImageNet(Dataset):
    """Deterministic synthetic ImageNet-shaped data: sample ``idx`` is an
    N(0, 1) f32 image [channels, size, size] and a label in
    [0, num_classes), both from ``default_rng(seed + idx)``."""

    def __init__(self, n=1280, image_size=224, num_classes=1000,
                 transform=None, channels=3, seed=0):
        self.n = n
        self.shape = (channels, image_size, image_size)
        self.num_classes = num_classes
        self.transform = transform
        self.seed = seed

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        rng = np.random.default_rng(self.seed + idx)
        img = rng.standard_normal(self.shape, dtype=np.float32)
        label = np.int64(rng.integers(0, self.num_classes))
        if self.transform:
            img = self.transform(img)
        return img, label


class DatasetFolder(Dataset):
    """``root/<class>/<file>`` samples, classes in sorted order, files with
    one of ``extensions`` read by ``loader`` (``np.load`` by default)."""

    def __init__(self, root, loader=None, extensions=(".npy",),
                 transform=None):
        self.samples = []
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        for c in classes:
            for fn in sorted(os.listdir(os.path.join(root, c))):
                if fn.endswith(extensions):
                    self.samples.append((os.path.join(root, c, fn),
                                         self.class_to_idx[c]))
        self.transform = transform
        self.loader = loader or np.load

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        path, label = self.samples[idx]
        img = self.loader(path)
        if self.transform:
            img = self.transform(img)
        return img, label


ImageFolder = DatasetFolder


class MNIST(Dataset):
    """Synthetic MNIST-shaped data: N(0, 1) [1, 28, 28] images, label
    ``idx % 10``."""

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=False, backend=None):
        self.n = 60000 if mode == "train" else 10000
        self.transform = transform

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        rng = np.random.default_rng(idx)
        img = rng.standard_normal((1, 28, 28), dtype=np.float32)
        if self.transform:
            img = self.transform(img)
        return img, np.int64(idx % 10)


class Cifar10(Dataset):
    """Synthetic CIFAR-10-shaped data: N(0, 1) [3, 32, 32] images, label
    ``idx % 10``."""

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=False, backend=None):
        self.n = 50000 if mode == "train" else 10000
        self.transform = transform

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        rng = np.random.default_rng(idx)
        img = rng.standard_normal((3, 32, 32), dtype=np.float32)
        if self.transform:
            img = self.transform(img)
        return img, np.int64(idx % 10)
