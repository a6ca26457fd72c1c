"""Training datasets and the batch loader (port of
``ccedit_tpu/data/dataset.py``).

* ``TextVideoDataset`` over (video path, caption) items: resize the short
  side and centre-crop, 'proportional' frame sampling (stride
  round(fps / prop_factor) from a random start), resampling a missing or
  corrupt file; items are {jpg, txt, control_hint, cond_img,
  interpolate_first_last} with clips in [-1, 1], (T, H, W, 3) float32.
* ``WebVidDataset``: the WebVid CSV metadata (videoid/name columns).
* ``SyntheticVideoDataset``: deterministic moving-square clips, the offline
  dataset for smoke training.
* ``collate`` and ``DataLoader``: numpy batches from a background prefetch
  thread; under data parallelism each rank's contiguous block of every
  global batch.

Pure numpy; the video decoder (the native threaded decode of
``data/native_decode.py`` when its library loads, else cv2 through
``data/video.py``) and the resize (cv2) are imported only when a file is
read.  Both decoders give the same frames: the native one decodes the
selected frames at the file's own size, and the same ``resize_center_crop``
follows.
"""

from __future__ import annotations

import csv
import os
import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .video import VIDEO_EXTS


def resize_center_crop(frame: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """Resize the short side to cover ``hw`` (bicubic), then centre-crop."""
    import cv2

    h, w = frame.shape[:2]
    th, tw = hw
    scale = max(th / h, tw / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    arr = cv2.resize(frame, (nw, nh), interpolation=cv2.INTER_CUBIC)
    y0, x0 = (nh - th) // 2, (nw - tw) // 2
    return arr[y0:y0 + th, x0:x0 + tw]


def proportional_frame_indices(n_frames: int, fps: float, num_frames: int,
                               prop_factor: float = 6.0,
                               rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Stride round(fps / prop_factor) from a random start; linspace over the
    clip when the window overruns it."""
    stride = max(int(round(fps / prop_factor)), 1)
    span = stride * (num_frames - 1) + 1
    if span <= n_frames:
        start = int(rng.integers(0, n_frames - span + 1)) if rng is not None else 0
        return np.arange(start, start + span, stride)
    return np.linspace(0, n_frames - 1, num_frames).astype(int)


def _item(clip: np.ndarray, caption: str) -> Dict:
    t = clip.shape[0]
    return {"jpg": clip, "txt": caption, "control_hint": clip.copy(),
            "cond_img": clip[t // 2].copy(),
            "interpolate_first_last": np.stack([clip[0], clip[-1]])}


class TextVideoDataset:
    def __init__(self, items: Sequence[Tuple[str, str]], num_frames: int = 9,
                 size_hw: Tuple[int, int] = (256, 384), prop_factor: float = 6.0,
                 seed: int = 0, lax: bool = True):
        self.items = list(items)
        self.num_frames = num_frames
        self.size_hw = tuple(size_hw)
        self.prop_factor = prop_factor
        self.rng = np.random.default_rng(seed)
        self.lax = lax
        from . import native_decode

        self.decoder = "native" if native_decode.available() else "cv2"

    def __len__(self) -> int:
        return len(self.items)

    def _frames(self, path: str) -> List[np.ndarray]:
        """The clip's sampled frames at the file's own size."""
        if self.decoder == "native" and path.lower().endswith(VIDEO_EXTS):
            from . import native_decode
            from .video import probe_video

            n, fps, h, w = probe_video(path)
            if n > 0:  # a container that reports no frame count takes the cv2 path
                sel = proportional_frame_indices(n, fps or 30.0, self.num_frames,
                                                 self.prop_factor, self.rng)
                try:
                    return list(native_decode.decode_clip_u8(path, sel, h, w))
                except IOError:
                    pass  # the container over-reported its frame count: decode them all
        from .video import _read_frames

        frames, fps = _read_frames(path)
        sel = proportional_frame_indices(len(frames), fps or 30.0, self.num_frames,
                                         self.prop_factor, self.rng)
        return [frames[i] for i in sel]

    def __getitem__(self, idx: int) -> Dict:
        for attempt in range(8):
            path, caption = self.items[idx]
            try:
                frames = self._frames(path)
                break
            except Exception:
                if not self.lax or attempt == 7:
                    raise
                idx = int(self.rng.integers(0, len(self.items)))  # resample another item
        clip = np.stack([resize_center_crop(f, self.size_hw) for f in frames])
        return _item(clip.astype(np.float32) / 127.5 - 1.0, caption)


class WebVidDataset(TextVideoDataset):
    """WebVid CSV metadata: ``{data_root}/{video_subdir}/{videoid}.mp4`` with
    the caption in ``name``."""

    def __init__(self, data_root: str, csv_path: str, video_subdir: str = "videos",
                 caption_col: str = "name", id_col: str = "videoid", **kwargs):
        with open(csv_path) as f:
            items = [(os.path.join(data_root, video_subdir, f"{row[id_col]}.mp4"),
                      row[caption_col]) for row in csv.DictReader(f)]
        super().__init__(items, **kwargs)


class SyntheticVideoDataset(TextVideoDataset):
    """Deterministic moving-square clips: item i is a square of a random
    colour moving 2 px a frame on a black background, seeded by i."""

    def __init__(self, n_items: int = 64, num_frames: int = 8,
                 size_hw: Tuple[int, int] = (64, 64), seed: int = 0):
        super().__init__([("", f"moving square {i}") for i in range(n_items)],
                         num_frames=num_frames, size_hw=size_hw, seed=seed)
        self.decoder = None  # made, not decoded

    def __getitem__(self, idx: int) -> Dict:
        h, w = self.size_hw
        t = self.num_frames
        rng = np.random.default_rng(idx)
        size = int(rng.integers(h // 8, h // 4))
        x0 = int(rng.integers(0, w - size - t * 2))
        y0 = int(rng.integers(0, h - size))
        color = rng.uniform(-1, 1, size=3).astype(np.float32)
        clip = -np.ones((t, h, w, 3), dtype=np.float32)
        for i in range(t):
            clip[i, y0:y0 + size, x0 + 2 * i:x0 + 2 * i + size] = color
        return _item(clip, self.items[idx][1])


def collate(samples: List[Dict]) -> Dict:
    """Stack arrays; strings stay lists."""
    out: Dict = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        out[k] = vals if isinstance(vals[0], str) else np.stack(vals)
    return out


class DataLoader:
    """Shuffled batches (a new order every epoch) from a background
    prefetch thread.  ``batch_size`` is the global batch; with ``world`` >
    1 every rank shuffles with the same seed and loads only its contiguous
    block (``parallel.mesh.batch_slice``) of each global batch.  Prints
    once which decoder its dataset uses."""

    def __init__(self, dataset, batch_size: int, seed: int = 0, shuffle: bool = True,
                 prefetch: int = 2, drop_last: bool = True, rank: int = 0, world: int = 1):
        from ..parallel.mesh import batch_slice

        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.block = batch_slice(batch_size, rank, world)
        if getattr(dataset, "decoder", None):
            print(f"[data] {type(dataset).__name__} decodes with "
                  + ("the native threaded decode" if dataset.decoder == "native" else "cv2"),
                  flush=True)

    def _epoch_indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        return idx

    def __iter__(self) -> Iterator[Dict]:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()
        idx = self._epoch_indices()
        end = (len(idx) // self.batch_size) * self.batch_size if self.drop_last else len(idx)

        def producer():
            for s in range(0, end, self.batch_size):
                block = idx[s:s + self.batch_size][self.block]
                q.put(collate([self.dataset[int(i)] for i in block]))
            q.put(stop)

        threading.Thread(target=producer, daemon=True).start()
        while (item := q.get()) is not stop:
            yield item
