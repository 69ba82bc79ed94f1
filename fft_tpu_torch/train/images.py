"""Image-folder data pipeline for ViT training (mirror of
``fft_tpu/train/images.py``).

Directory contract (the torchvision-ImageFolder convention):

    root/<class_name>/<anything>.{png,jpg,jpeg,bmp,gif,webp}

Classes are the sorted subdirectory names.  Decode is PIL, imported only
inside ``_load_rgb``, so this module imports without it (the card's
machine may have none); preprocessing is the standard ViT recipe: resize
the shorter side to ``1.15 * image_size``, center crop (eval) or random
crop and horizontal flip (train), scale to [0, 1], normalize by the
ImageNet mean and std.  Batches come out channels-last (B, H, W, 3)
float32, ``models/vit.py``'s input layout.

numpy only, copied rather than imported (importing ``fft_tpu`` pulls in
JAX), so one seed gives the same batches, byte for byte, in both
packages.  Decoded images are cached (bounded) as uint8 arrays; the
iterator reshuffles every epoch and is deterministic under a seed.
"""

from __future__ import annotations

import pathlib
from typing import Iterator, List, Optional, Tuple

import numpy as np

_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".gif", ".webp"}
_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def _load_rgb(path: pathlib.Path, resize_to: int) -> np.ndarray:
    """Decode -> RGB -> shorter-side resize.  Returns uint8 (H, W, 3)."""
    try:
        from PIL import Image
    except ImportError as e:                       # pragma: no cover
        raise RuntimeError(
            "ImageFolderDataset needs Pillow for decode; install PIL or "
            "use the synthetic ViT pipeline (train-vit without --data)"
        ) from e
    with Image.open(path) as im:
        im = im.convert("RGB")
        w, h = im.size
        scale = resize_to / min(w, h)
        im = im.resize((max(resize_to, round(w * scale)),
                        max(resize_to, round(h * scale))),
                       Image.BILINEAR)
        return np.asarray(im, np.uint8)


class ImageFolderDataset:
    """Labelled images from ``root/<class>/*``; infinite shuffled batches."""

    def __init__(self, root: str, image_size: int = 224,
                 cache_images: int = 4096):
        self.root = pathlib.Path(root)
        self.image_size = int(image_size)
        self.classes: List[str] = sorted(
            p.name for p in self.root.iterdir() if p.is_dir())
        if not self.classes:
            raise ValueError(f"no class subdirectories under {root}")
        self.samples: List[Tuple[pathlib.Path, int]] = []
        for label, cls in enumerate(self.classes):
            for f in sorted((self.root / cls).rglob("*")):
                if f.suffix.lower() in _EXTS and f.is_file():
                    self.samples.append((f, label))
        if not self.samples:
            raise ValueError(f"no images under {root} (extensions {_EXTS})")
        self._resize_to = max(self.image_size,
                              round(1.15 * self.image_size))
        self._cache: dict = {}
        self._cache_cap = int(cache_images)

    @property
    def num_classes(self) -> int:
        return len(self.classes)

    def __len__(self) -> int:
        return len(self.samples)

    def _raw(self, idx: int) -> np.ndarray:
        img = self._cache.get(idx)
        if img is None:
            img = _load_rgb(self.samples[idx][0], self._resize_to)
            if len(self._cache) < self._cache_cap:
                self._cache[idx] = img
        return img

    def _crop(self, img: np.ndarray, rng: Optional[np.random.Generator]):
        s = self.image_size
        h, w = img.shape[:2]
        if rng is None:                            # eval: center crop
            y, x = (h - s) // 2, (w - s) // 2
        else:                                      # train: random crop+flip
            y = int(rng.integers(0, h - s + 1))
            x = int(rng.integers(0, w - s + 1))
        img = img[y:y + s, x:x + s]
        if rng is not None and rng.random() < 0.5:
            img = img[:, ::-1]
        return img

    def example(self, idx: int,
                rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """One normalized float32 (S, S, 3) example."""
        img = self._crop(self._raw(idx), rng).astype(np.float32) / 255.0
        return (img - _MEAN) / _STD

    def batches(self, batch: int, seed: int = 0, augment: bool = True,
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Infinite (images (B, S, S, 3) f32, labels (B,) i32) stream;
        epoch-reshuffled, deterministic under ``seed``."""
        rng = np.random.default_rng(seed)
        aug = rng if augment else None
        order: List[int] = []
        while True:
            while len(order) < batch:   # datasets smaller than one batch
                perm = rng.permutation(len(self.samples))
                order.extend(int(i) for i in perm)
            idxs, order = order[:batch], order[batch:]
            imgs = np.stack([self.example(i, aug) for i in idxs])
            labels = np.asarray([self.samples[i][1] for i in idxs], np.int32)
            yield imgs, labels


def synthetic_image_batches(batch: int, image_size: int, num_classes: int,
                            seed: int = 0,
                            ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """The no-dataset fallback: class-conditional Gaussian blobs (labels are
    learnable, unlike pure noise) with the same batch contract."""
    rng = np.random.default_rng(seed)
    protos = rng.standard_normal((num_classes, 4, 4, 3)).astype(np.float32)
    while True:
        labels = rng.integers(0, num_classes, batch).astype(np.int32)
        base = protos[labels]
        up = base.repeat(image_size // 4, 1).repeat(image_size // 4, 2)
        noise = rng.standard_normal(
            (batch, image_size, image_size, 3)).astype(np.float32)
        yield up + 0.5 * noise, labels
