"""Structure-hint annotators (port of ``ccedit_tpu/conditioning/annotators/
base.py``: ``gradient_pseudo_depth``, ``midas_postprocess``, the
``depth_midas`` kind of ``AnnotatorEmbedder`` and ``build_annotator``, with
the chunking of ``chunked.py``).

``depth_midas`` runs the DPT-Hybrid backbone (``dpt_midas.py``) per frame in
chunks of 5, then one clip-global MiDaS post-process, or, opted into with
``allow_fake`` (the CLI's ``--fake_annotator``), the
``gradient_pseudo_depth`` luminance stand-in.  Input/output:
(B, T, H, W, 3) in [-1, 1].
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ...io.checkpoint import load_torch_state_dict
from ..embedders import Embedder, as_float_frames
from .dpt_midas import DPTHybrid, detect_depth_midas, load_dpt_checkpoint

CHUNK = 5  # frames per DPT-Hybrid call (the JAX package's chunked.py)


def _luma(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) in [-1, 1] -> (N, H, W) luminance in [0, 1]."""
    w = torch.tensor([0.299, 0.587, 0.114], dtype=x.dtype, device=x.device)
    return ((x + 1.0) * 0.5 * w).sum(-1)


def gradient_pseudo_depth(x: torch.Tensor) -> torch.Tensor:
    """Deterministic stand-in backbone: 1 - 5x5 box-smoothed luminance
    (zero padding), (N, H, W); NOT MiDaS."""
    y = _luma(x)[:, None]
    k = torch.full((1, 1, 5, 5), 1.0 / 25.0, dtype=x.dtype, device=x.device)
    return 1.0 - F.conv2d(y, k, padding=2)[:, 0]


def midas_postprocess(depth: torch.Tensor) -> torch.Tensor:
    """Clip-global min-max -> clamp -> [-1, 1] -> negate -> 3 channels."""
    depth = depth - depth.min()
    depth = depth / torch.clamp(depth.max(), min=1e-8)
    depth = -(depth.clamp(0.0, 1.0) * 2.0 - 1.0)
    return depth[..., None].repeat_interleave(3, dim=-1)


class AnnotatorEmbedder(Embedder):
    """Fold video -> per-frame backbone, ``CHUNK`` frames at a time ->
    clip-global postprocess.  ``backbone`` is a ``DPTHybrid``; without one,
    ``allow_fake`` selects the stand-in and anything else raises.
    ``backbone_loaded`` says whether its weights came from a checkpoint."""

    def __init__(self, kind: str, backbone: Optional[DPTHybrid] = None,
                 allow_fake: bool = False):
        super().__init__()
        if kind != "depth_midas":
            raise NotImplementedError(f"annotator {kind!r} is not ported yet")
        self.kind = kind
        self.backbone = backbone
        self.backbone_loaded = False
        self.allow_fake = allow_fake

    def _depth(self, frames: torch.Tensor) -> torch.Tensor:
        if self.backbone is None:
            if not self.allow_fake:
                raise RuntimeError(
                    "depth_midas has no DPT-Hybrid backbone; set ckpt_path in the "
                    "embedder params (dpt_hybrid-midas-501f0c75.pt) or opt into the "
                    "luminance pseudo-depth stand-in with --fake_annotator "
                    "(NOT MiDaS; debug only)")
            return gradient_pseudo_depth(frames)
        return torch.cat([detect_depth_midas(self.backbone, frames[i:i + CHUNK]).float()
                          for i in range(0, frames.shape[0], CHUNK)])

    def forward(self, prepared: torch.Tensor) -> torch.Tensor:
        x = as_float_frames(prepared)
        b, t = x.shape[:2]
        out = midas_postprocess(self._depth(x.reshape((b * t,) + x.shape[2:])))
        return out.reshape((b, t) + out.shape[1:])


_KIND_MAP = {"DepthMidasEncoder": "depth_midas"}


def build_annotator(target_name: str, params: dict) -> AnnotatorEmbedder:
    """The annotator of a reference embedder target.  ``fake_annotator``
    selects the stand-in; otherwise the DPT-Hybrid is built, and loaded
    from ``ckpt_path`` when given (left to the caller's weights when not)."""
    if target_name not in _KIND_MAP:
        raise KeyError(f"annotator target {target_name!r} is not ported yet")
    if params.get("fake_annotator"):
        return AnnotatorEmbedder(_KIND_MAP[target_name], allow_fake=True)
    emb = AnnotatorEmbedder(_KIND_MAP[target_name], backbone=DPTHybrid())
    if params.get("ckpt_path"):
        load_dpt_checkpoint(emb.backbone, load_torch_state_dict(params["ckpt_path"]))
        emb.backbone_loaded = True
    return emb
