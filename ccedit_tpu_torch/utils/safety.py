"""NSFW and watermark filtering (port of ``ccedit_tpu/utils/safety.py``,
the reference's ``DeepFloydDataFiltering``).

CLIP ViT-L/14 image features (``modules/openclip.py``'s vision tower with
quick-GELU: OpenAI CLIP) feed two logistic heads, p (nsfw) and w
(watermark); a frame either head flags above 0.5 is replaced by a heavy
gaussian blur (99 taps, sigma 100, separable, zero padded).  The
preprocessing is the JAX package's: centre crop to the short side, resize
to 224 as ``jax.image.resize`` does (Keys bicubic, antialiased), CLIP
normalisation.  The heads come from the reference's ``p_head_v1.npz`` /
``w_head_v1.npz`` (``weights``, ``biases``), the CLIP weights from an
OpenAI ``clip`` visual state dict (``io/checkpoint.py``'s loader; its keys
are open_clip's).  The features are rounded to fp16 and the heads run in
numpy, as in the JAX package.

Without the CLIP weights or any head the filter passes images through
unchanged, with one warning.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..conditioning.embedders import antialiased_resize_matrix

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def predict_proba(feats: np.ndarray, weights: np.ndarray, biases: np.ndarray) -> np.ndarray:
    """A numerically stable sigmoid head."""
    logits = feats @ weights.T + biases
    return np.where(logits >= 0, 1.0 / (1.0 + np.exp(-logits)),
                    np.exp(logits) / (1.0 + np.exp(logits))).T


def clip_process_images(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) in [0, 1] -> (B, 3, 224, 224): the short side's centre
    crop, resized to 224 (``jax.image.resize``'s antialiased bicubic) and
    CLIP-normalised."""
    _, h, w, _ = images.shape
    side = min(h, w)
    top, left = (h - side) // 2, (w - side) // 2
    x = images[:, top:top + side, left:left + side, :].float()
    m = torch.from_numpy(antialiased_resize_matrix(side, 224)).to(x.device)
    x = torch.einsum("ah,bhwc,dw->badc", m, x, m)
    mean = torch.tensor(CLIP_MEAN, device=x.device)
    std = torch.tensor(CLIP_STD, device=x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2)


def blur_kernel(ksize: int = 99, sigma: float = 100.0) -> np.ndarray:
    r = ksize // 2
    xs = np.arange(-r, r + 1, dtype=np.float32)
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    return k / k.sum()


def gaussian_blur(images: torch.Tensor, ksize: int = 99, sigma: float = 100.0) -> torch.Tensor:
    """(B, H, W, 3) -> the separable gaussian blur of each channel, zero
    padded to the same size (torchvision's ``GaussianBlur(99, sigma=100)``
    on the interior)."""
    b, h, w, c = images.shape
    k = torch.from_numpy(blur_kernel(ksize, sigma)).to(images.device, torch.float32)
    x = images.float().permute(0, 3, 1, 2).reshape(b * c, 1, h, w)
    x = F.conv2d(x, k.reshape(1, 1, ksize, 1), padding=(ksize // 2, 0))
    x = F.conv2d(x, k.reshape(1, 1, 1, ksize), padding=(0, ksize // 2))
    return x.reshape(b, c, h, w).permute(0, 2, 3, 1).to(images.dtype)


def clip_vit_l14():
    """OpenAI CLIP ViT-L/14's vision tower: width 1024, 24 layers, 16 heads,
    output 768, quick-GELU."""
    from ..modules.openclip import OpenCLIPVisionModel

    return OpenCLIPVisionModel(patch_size=14, width=1024, heads=16, layers=24,
                               output_dim=768, act="quick_gelu")


class DeepFloydDataFiltering:
    """Blur every frame whose nsfw (p) or watermark (w) head fires above
    0.5.  ``model`` is the CLIP vision tower, on the device the images
    come on; ``p_head`` and ``w_head`` are (weights, biases) arrays."""

    def __init__(self, model: Optional[torch.nn.Module] = None, p_head: Optional[tuple] = None,
                 w_head: Optional[tuple] = None, verbose: bool = False):
        self.model, self.p_head, self.w_head, self.verbose = model, p_head, w_head, verbose
        self._warned = False

    @classmethod
    def from_files(cls, clip_ckpt: Optional[str] = None, p_head_path: Optional[str] = None,
                   w_head_path: Optional[str] = None, verbose: bool = False,
                   device: Optional[torch.device] = None):
        model = None
        if clip_ckpt:
            from ..io.checkpoint import load_torch_state_dict
            from ..modules.openclip import load_openclip_vision

            with torch.device(device or "cpu"):
                model = clip_vit_l14()
            load_openclip_vision(model, load_torch_state_dict(clip_ckpt))
            model.eval()

        def heads(path):
            if not path:
                return None
            z = np.load(path)
            return z["weights"], z["biases"]

        return cls(model, heads(p_head_path), heads(w_head_path), verbose)

    def flags(self, images: torch.Tensor) -> np.ndarray:
        """Which of the (B, H, W, 3) images in [0, 1] either head flags."""
        x = clip_process_images(images)
        weight = self.model.conv1.weight
        with torch.no_grad():
            feats = self.model(x.to(device=weight.device, dtype=weight.dtype))
        feats = feats.float().cpu().numpy().astype(np.float16)
        flags = np.zeros(images.shape[0], bool)
        for head in (self.p_head, self.w_head):
            if head is not None:
                pred = predict_proba(feats, head[0], head[1]).reshape(-1)
                if self.verbose and (pred > 0.5).any():
                    print(f"safety filter hit: {pred}")
                flags |= pred > 0.5
        return flags

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        """images: (B, H, W, 3) in [0, 1]; the flagged ones blurred."""
        if self.model is None or (self.p_head is None and self.w_head is None):
            if not self._warned:
                warnings.warn("DeepFloydDataFiltering running as passthrough: supply clip_ckpt "
                              "+ p/w head .npz files to enable filtering")
                self._warned = True
            return images
        flags = self.flags(images)
        if not flags.any():
            return images
        mask = torch.from_numpy(flags).to(images.device)[:, None, None, None]
        return torch.where(mask, gaussian_blur(images), images)
