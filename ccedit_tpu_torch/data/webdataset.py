"""Tar-shard streaming dataset, webdataset style (port of
``ccedit_tpu/data/webdataset.py``, the reference's
``StableDataModuleFromConfig``, which delegates to the external
``sdata``/webdataset stack).

Samples are the groups of tar members sharing a basename (``key.ext``),
decoded by extension (images to uint8 RGB arrays: PNG by the port's own
reader, other formats through PIL; ``txt``/``caption`` to str, ``json``,
``npy``, ``cls``/``id`` to int, anything else raw bytes), yielded in
shard order with optional shard shuffling; ``tarfile`` only.
"""

from __future__ import annotations

import io
import json
import random
import tarfile
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np


def _decode_member(name: str, data: bytes) -> Any:
    ext = name.rsplit(".", 1)[-1].lower()
    if ext == "png":
        from .video import _rgb, read_png

        return _rgb(read_png(data))
    if ext in ("jpg", "jpeg", "webp", "bmp"):
        from PIL import Image

        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    if ext in ("txt", "caption"):
        return data.decode("utf-8")
    if ext == "json":
        return json.loads(data.decode("utf-8"))
    if ext in ("npy",):
        return np.load(io.BytesIO(data), allow_pickle=False)
    if ext in ("cls", "id"):
        return int(data.decode("utf-8").strip())
    return data  # raw bytes (mp4 etc.; decode downstream)


def iterate_shard(path: str) -> Iterator[Dict[str, Any]]:
    """Yield {ext: decoded} sample dicts from one tar shard; members sharing
    a basename (webdataset convention: key.ext) form one sample."""
    with tarfile.open(path, "r|*") as tf:
        current_key: Optional[str] = None
        sample: Dict[str, Any] = {}
        for member in tf:
            if not member.isfile():
                continue
            name = Path(member.name).name
            if "." not in name:
                continue
            key, ext = name.split(".", 1)
            if current_key is not None and key != current_key and sample:
                yield {"__key__": current_key, **sample}
                sample = {}
            current_key = key
            data = tf.extractfile(member).read()
            sample[ext.lower()] = _decode_member(name, data)
        if sample:
            yield {"__key__": current_key, **sample}


class TarShardDataset:
    """Iterable over a list of tar shards with optional shuffle + transform.

    StableDataModuleFromConfig analog: ``train``/``validation``/``test``
    sections each name ``shards`` (glob or list) and get a loader via the
    standard prefetch machinery."""

    def __init__(self, shards: Sequence[str] | str,
                 transform: Optional[Callable[[Dict], Dict]] = None,
                 shuffle_shards: bool = False, seed: int = 0,
                 repeat: bool = False):
        if isinstance(shards, str):
            base = Path(shards)
            if base.is_dir():
                found = sorted(str(p) for p in base.glob("*.tar"))
            else:
                import glob

                found = sorted(glob.glob(shards))
            self.shards: List[str] = found
        else:
            self.shards = list(shards)
        if not self.shards:
            raise FileNotFoundError(f"no tar shards match {shards!r}")
        self.transform = transform
        self.shuffle_shards = shuffle_shards
        self.seed = seed
        self.repeat = repeat

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        epoch = 0
        while True:
            order = list(self.shards)
            if self.shuffle_shards:
                random.Random(self.seed + epoch).shuffle(order)
            for shard in order:
                for sample in iterate_shard(shard):
                    yield self.transform(sample) if self.transform else sample
            epoch += 1
            if not self.repeat:
                return


class StableDataModuleFromConfig:
    """Config-compatible wrapper (sgm/data/dataset.py:20-81): sections
    train/validation/test with ``shards`` + optional ``batch_size``.
    ``train_dataloader()`` etc. return batched iterators."""

    def __init__(self, train: Optional[Dict] = None,
                 validation: Optional[Dict] = None,
                 test: Optional[Dict] = None, **_ignored):
        self._sections = {"train": train, "validation": validation,
                          "test": test}

    def _loader(self, section: str):
        cfg = self._sections.get(section)
        if cfg is None:
            raise ValueError(f"no {section!r} section configured")
        ds = TarShardDataset(
            cfg["shards"], shuffle_shards=bool(cfg.get("shuffle", False)),
            repeat=section == "train")
        bs = int(cfg.get("batch_size", 1))

        def batches():
            buf = []
            for sample in ds:
                buf.append(sample)
                if len(buf) == bs:
                    yield buf
                    buf = []

        return batches()

    def train_dataloader(self):
        return self._loader("train")

    def val_dataloader(self):
        return self._loader("validation")

    def test_dataloader(self):
        return self._loader("test")
