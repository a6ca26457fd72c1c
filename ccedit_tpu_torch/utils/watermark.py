"""Invisible watermark for generated samples (port of
``ccedit_tpu/utils/watermark.py``).

``WatermarkEmbedder`` embeds the SDV2 bit pattern (the reference demo's
``WatermarkEmbedder``) in every frame: with imwatermark's dwtDct method on
uint8 BGR frames where that package imports, else, with one warning, in the
least significant bit of the blue channel's first pixels, which
``decode_lsb`` reads back (not dwtDct-compatible).  numpy only otherwise.
"""

from __future__ import annotations

import warnings

import numpy as np

# the SDV2 watermark message of the reference demo
WATERMARK_MESSAGE = 0b101100111110110010010000011110111011000110011110
WATERMARK_BITS = [int(bit) for bit in bin(WATERMARK_MESSAGE)[2:]]


class WatermarkEmbedder:
    def __init__(self, watermark=None):
        self.watermark = watermark or WATERMARK_BITS
        self.num_bits = len(self.watermark)
        self._encoder = None
        try:
            from imwatermark import WatermarkEncoder

            self._encoder = WatermarkEncoder()
            self._encoder.set_watermark("bits", self.watermark)
        except Exception:
            warnings.warn("imwatermark unavailable: embedding watermark bits via blue-channel "
                          "LSB fallback (not dwtDct-compatible)")

    def __call__(self, images: np.ndarray) -> np.ndarray:
        """images: (..., H, W, 3) float RGB in [0, 1] -> the same shape and
        dtype with the watermark in every frame."""
        shape = images.shape
        flat = np.round(np.clip(images, 0, 1).reshape((-1,) + shape[-3:])
                        * 255.0).astype(np.uint8)
        out = []
        for frame in flat:
            bgr = frame[:, :, ::-1].copy()
            bgr = self._encoder.encode(bgr, "dwtDct") if self._encoder is not None \
                else self._embed_lsb(bgr)
            out.append(bgr[:, :, ::-1])
        return (np.stack(out).astype(np.float32) / 255.0).reshape(shape)

    def _embed_lsb(self, bgr: np.ndarray) -> np.ndarray:
        h, w = bgr.shape[:2]
        n = min(self.num_bits, h * w)
        blue = bgr[:, :, 0].reshape(-1)
        blue[:n] = (blue[:n] & 0xFE) | np.asarray(self.watermark[:n], np.uint8)
        bgr[:, :, 0] = blue.reshape(h, w)
        return bgr


def decode_lsb(images: np.ndarray, num_bits: int = len(WATERMARK_BITS)):
    """The LSB fallback's bits from the first RGB float frame of
    ``images``."""
    frame = np.round(np.clip(images.reshape((-1,) + images.shape[-3:])[0], 0, 1)
                     * 255.0).astype(np.uint8)
    blue = frame[:, :, 2].reshape(-1)
    return list((blue[:num_bits] & 1).astype(int))


def embed_watermark(images: np.ndarray) -> np.ndarray:
    return WatermarkEmbedder()(images)
