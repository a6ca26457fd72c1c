"""Toy image datasets, MNIST and CIFAR-10, without torchvision (port of
``ccedit_tpu/data/toy.py``; the port keeps its own copy).

Each item is ``{"jpg": (H, W, C) float32 in [-1, 1], "cls": int}``, the
reference's ``sgm/data/mnist.py`` and ``cifar10.py`` items in HWC.  The
standard files are read when they exist (MNIST's IDX files, plain or
gzipped, under ``root`` or torchvision's ``root/MNIST/raw/``; CIFAR-10's
python pickle batches under ``root/cifar-10-batches-py/``); otherwise a
deterministic class-correlated synthetic set stands in (seven-segment digit
glyphs; class-keyed colour and stripe fields), the same arrays as the JAX
package's from the same seed.  Its per-item draws are seeded, as the JAX
package's are, with Python's ``hash`` of a (str, int) tuple, which depends
on ``PYTHONHASHSEED``: the synthetic images repeat within a process, not
across processes with hash randomisation on.
"""

from __future__ import annotations

import gzip
import pickle
import struct
from pathlib import Path
from typing import Dict, Optional

import numpy as np

# seven-segment truth table: A top, B top-right, C bottom-right, D bottom,
# E bottom-left, F top-left, G middle
_SEGMENTS = {
    0: "ABCDEF", 1: "BC", 2: "ABGED", 3: "ABGCD", 4: "FGBC",
    5: "AFGCD", 6: "AFGECD", 7: "ABC", 8: "ABCDEFG", 9: "ABCFGD",
}


def _open_maybe_gz(path: Path):
    if path.suffix == ".gz":
        return gzip.open(path, "rb")
    return open(path, "rb")


def _find(root: Path, names) -> Optional[Path]:
    for name in names:
        for cand in (root / name, root / f"{name}.gz",
                     root / "MNIST" / "raw" / name,
                     root / "MNIST" / "raw" / f"{name}.gz"):
            if cand.exists():
                return cand
    return None


def read_idx(path: Path) -> np.ndarray:
    """Read an IDX-format array (the MNIST container: magic, dims, uint8)."""
    with _open_maybe_gz(path) as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(shape)


def _draw_seven_segment(digit: int, rng: np.random.Generator) -> np.ndarray:
    """28x28 digit glyph with per-sample jitter (position, thickness,
    intensity) — a deterministic stand-in for handwriting variation."""
    img = np.zeros((28, 28), dtype=np.float32)
    th = int(rng.integers(2, 4))            # stroke thickness
    ox = int(rng.integers(6, 12))           # glyph left edge
    oy = int(rng.integers(3, 7))            # glyph top edge
    wd = int(rng.integers(8, 11))           # glyph width
    ht = int(rng.integers(14, 19))          # glyph height
    mid = oy + ht // 2
    val = float(rng.uniform(0.7, 1.0))
    segs = _SEGMENTS[digit % 10]

    def hline(y, x0, x1):
        img[max(y, 0): y + th, max(x0, 0): x1] = val

    def vline(x, y0, y1):
        img[max(y0, 0): y1, max(x, 0): x + th] = val

    if "A" in segs:
        hline(oy, ox, ox + wd)
    if "G" in segs:
        hline(mid, ox, ox + wd)
    if "D" in segs:
        hline(oy + ht, ox, ox + wd + th)
    if "F" in segs:
        vline(ox, oy, mid)
    if "B" in segs:
        vline(ox + wd, oy, mid)
    if "E" in segs:
        vline(ox, mid, oy + ht)
    if "C" in segs:
        vline(ox + wd, mid, oy + ht + th)
    img += rng.normal(0.0, 0.02, img.shape).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


class MNISTDataset:
    """MNIST as ``{"jpg": (28, 28, 1) in [-1, 1], "cls": int}``.

    Reads the IDX files when present under ``root`` (plain or torchvision's
    ``MNIST/raw`` layout, gzipped or not); otherwise generates the
    deterministic seven-segment substitute (``n_synthetic`` samples)."""

    def __init__(self, root: str = ".data", train: bool = True,
                 n_synthetic: int = 4096, seed: int = 0):
        root_p = Path(root)
        prefix = "train" if train else "t10k"
        img_p = _find(root_p, [f"{prefix}-images-idx3-ubyte",
                               f"{prefix}-images.idx3-ubyte"])
        lbl_p = _find(root_p, [f"{prefix}-labels-idx1-ubyte",
                               f"{prefix}-labels.idx1-ubyte"])
        if img_p is not None and lbl_p is not None:
            self.images = read_idx(img_p)
            self.labels = read_idx(lbl_p).astype(np.int32)
            self.synthetic = False
        else:
            rng = np.random.default_rng(seed + (0 if train else 1))
            self.labels = rng.integers(0, 10, size=n_synthetic).astype(np.int32)
            self.images = None  # rendered lazily per index
            self._n = n_synthetic
            self.synthetic = True

    def __len__(self) -> int:
        return self._n if self.synthetic else len(self.labels)

    def __getitem__(self, idx: int) -> Dict:
        label = int(self.labels[idx])
        if self.synthetic:
            rng = np.random.default_rng(hash(("mnist", idx)) & 0x7FFFFFFF)
            img = _draw_seven_segment(label, rng)
        else:
            img = self.images[idx].astype(np.float32) / 255.0
        return {"jpg": (img * 2.0 - 1.0)[..., None], "cls": label}


class CIFAR10Dataset:
    """CIFAR-10 as ``{"jpg": (32, 32, 3) in [-1, 1], "cls": int}``.

    Reads the python pickle batches when present under
    ``root/cifar-10-batches-py``; otherwise generates class-keyed synthetic
    images (class-specific hue + oriented texture) so class conditioning
    remains learnable."""

    def __init__(self, root: str = ".data", train: bool = True,
                 n_synthetic: int = 4096, seed: int = 0):
        batch_dir = Path(root) / "cifar-10-batches-py"
        names = ([f"data_batch_{i}" for i in range(1, 6)] if train
                 else ["test_batch"])
        paths = [batch_dir / n for n in names]
        if all(p.exists() for p in paths):
            imgs, labels = [], []
            for p in paths:
                with open(p, "rb") as f:
                    d = pickle.load(f, encoding="bytes")
                imgs.append(np.asarray(d[b"data"], dtype=np.uint8))
                labels.extend(d[b"labels"])
            data = np.concatenate(imgs).reshape(-1, 3, 32, 32)
            self.images = np.transpose(data, (0, 2, 3, 1))  # HWC
            self.labels = np.asarray(labels, dtype=np.int32)
            self.synthetic = False
        else:
            rng = np.random.default_rng(seed + (0 if train else 1))
            self.labels = rng.integers(0, 10, size=n_synthetic).astype(np.int32)
            self.images = None
            self._n = n_synthetic
            self.synthetic = True

    def __len__(self) -> int:
        return self._n if self.synthetic else len(self.labels)

    def _synth(self, idx: int, label: int) -> np.ndarray:
        rng = np.random.default_rng(hash(("cifar", idx)) & 0x7FFFFFFF)
        yy, xx = np.mgrid[0:32, 0:32].astype(np.float32) / 32.0
        angle = label * np.pi / 10.0
        freq = 2.0 + label * 0.7
        wave = 0.5 + 0.5 * np.sin(
            2 * np.pi * freq * (np.cos(angle) * xx + np.sin(angle) * yy)
            + float(rng.uniform(0, 2 * np.pi)))
        base = np.array([
            0.5 + 0.5 * np.cos(2 * np.pi * label / 10.0),
            0.5 + 0.5 * np.sin(2 * np.pi * label / 10.0),
            (label % 5) / 4.0,
        ], dtype=np.float32)
        img = wave[..., None] * base[None, None]
        img += rng.normal(0.0, 0.05, img.shape)
        return np.clip(img, 0.0, 1.0).astype(np.float32)

    def __getitem__(self, idx: int) -> Dict:
        label = int(self.labels[idx])
        if self.synthetic:
            img = self._synth(idx, label)
        else:
            img = self.images[idx].astype(np.float32) / 255.0
        return {"jpg": img * 2.0 - 1.0, "cls": label}


def build_toy_dataset(target: str, params: Optional[Dict] = None,
                      train: bool = True, seed: int = 0):
    """Map a reference data target (``sgm.data.mnist.MNISTLoader`` /
    ``sgm.data.cifar10.CIFAR10Loader``) to the offline dataset."""
    params = params or {}
    root = params.get("root", ".data")
    t = target.lower()
    if "mnist" in t:
        return MNISTDataset(root=root, train=train, seed=seed)
    if "cifar" in t:
        return CIFAR10Dataset(root=root, train=train, seed=seed)
    raise ValueError(f"not a toy data target: {target}")
