"""Structure-hint annotators (port of ``ccedit_tpu/conditioning/annotators/
base.py``: ``gradient_pseudo_depth``, ``midas_postprocess``,
``zoe_postprocess``, the ``depth_midas`` and ``depth_zoe`` kinds of
``AnnotatorEmbedder`` and ``build_annotator``, with the chunking of
``chunked.py``).

``depth_midas`` runs the DPT-Hybrid backbone (``dpt_midas.py``) on frames in
[-1, 1], then one clip-global MiDaS post-process; ``depth_zoe`` runs
ZoeDepth (``zoedepth.py``) on frames mapped to [0, 1], then the 2 %/85 %
k-th-value normalisation over each sample's whole clip.  Either backbone
runs per frame in chunks of 5.  Opted into with ``allow_fake`` (the CLI's
``--fake_annotator``), the ``gradient_pseudo_depth`` luminance stand-in
replaces the backbone.  Input/output: (B, T, H, W, 3) in [-1, 1].
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...io.checkpoint import load_torch_state_dict
from ..embedders import Embedder, as_float_frames
from .dpt_midas import DPTHybrid, detect_depth_midas, load_dpt_checkpoint
from .zoedepth import ZoeDepthN, detect_depth_zoe, zoedepth_from_state_dict

CHUNK = 5  # frames per backbone call (the JAX package's chunked.py)
CHECKPOINTS = {"depth_midas": "dpt_hybrid-midas-501f0c75.pt",
               "depth_zoe": "an HF ZoeDepthForDepthEstimation state dict (ZoeD_M12_N)"}


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


def zoe_postprocess(depth_bt: torch.Tensor, batch: int) -> torch.Tensor:
    """(B*T, H, W) depth -> (B*T, H, W, 3) in [-1, 1]: per sample, over its
    whole clip of n values, the k_lo-th and k_hi-th smallest (k_lo =
    max(int(0.02 n), 1), k_hi = max(int(0.85 n), 1)) map to -1 and +1, the
    rest clamped.  No epsilon guards the division, as in the reference."""
    bt, h, w = depth_bt.shape
    d = depth_bt.float().reshape(batch, bt // batch, h, w)
    flat = d.reshape(batch, -1)
    n = flat.shape[1]
    vmin = flat.kthvalue(max(int(0.02 * n), 1), dim=1).values[:, None, None, None]
    vmax = flat.kthvalue(max(int(0.85 * n), 1), dim=1).values[:, None, None, None]
    d = ((d - vmin) / (vmax - vmin)).clamp(0.0, 1.0) * 2.0 - 1.0
    return d.reshape(bt, h, w)[..., None].repeat_interleave(3, dim=-1)


class AnnotatorEmbedder(Embedder):
    """Fold video -> per-frame backbone, ``CHUNK`` frames at a time ->
    clip-global postprocess.  ``backbone`` is a ``DPTHybrid``
    (``depth_midas``) or a ``ZoeDepthN`` (``depth_zoe``); without one,
    ``allow_fake`` selects the stand-in and anything else raises.
    ``backbone_loaded`` says whether its weights came from a checkpoint."""

    def __init__(self, kind: str, backbone: Optional[nn.Module] = None,
                 allow_fake: bool = False):
        super().__init__()
        if kind not in CHECKPOINTS:
            raise NotImplementedError(f"annotator {kind!r} is not ported yet")
        self.kind = kind
        self.backbone = backbone
        self.backbone_loaded = False
        self.allow_fake = allow_fake

    def depth(self, frames: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) frames in the backbone's input range ([-1, 1] for
        DPT, [0, 1] for Zoe) -> (N, H, W) fp32 depth."""
        if self.backbone is None:
            if not self.allow_fake:
                raise RuntimeError(
                    f"{self.kind} has no backbone; set ckpt_path in the embedder params "
                    f"({CHECKPOINTS[self.kind]}) or opt into the luminance pseudo-depth "
                    "stand-in with --fake_annotator (NOT a depth model; debug only)")
            return gradient_pseudo_depth(frames)
        detect = detect_depth_midas if self.kind == "depth_midas" else detect_depth_zoe
        return torch.cat([detect(self.backbone, frames[i:i + CHUNK]).float()
                          for i in range(0, frames.shape[0], CHUNK)])

    def forward(self, prepared: torch.Tensor) -> torch.Tensor:
        x = as_float_frames(prepared)
        b, t = x.shape[:2]
        frames = x.reshape((b * t,) + x.shape[2:])
        if self.kind == "depth_midas":
            out = midas_postprocess(self.depth(frames))
        else:
            out = zoe_postprocess(self.depth((frames + 1.0) * 0.5), b)
        return out.reshape((b, t) + out.shape[1:])


_KIND_MAP = {"DepthMidasEncoder": "depth_midas", "DepthZoeEncoder": "depth_zoe"}


def build_annotator(target_name: str, params: dict) -> AnnotatorEmbedder:
    """The annotator of a reference embedder target.  ``fake_annotator``
    selects the stand-in; otherwise the backbone is built, from
    ``ckpt_path`` when given (ZoeDepth sized to the file) and else at the
    production size, its weights left to the caller."""
    if target_name not in _KIND_MAP:
        raise KeyError(f"annotator target {target_name!r} is not ported yet")
    kind = _KIND_MAP[target_name]
    if params.get("fake_annotator"):
        return AnnotatorEmbedder(kind, allow_fake=True)
    ckpt = params.get("ckpt_path")
    if kind == "depth_zoe":
        backbone = zoedepth_from_state_dict(load_torch_state_dict(ckpt)) if ckpt else ZoeDepthN()
    else:
        backbone = DPTHybrid()
        if ckpt:
            load_dpt_checkpoint(backbone, load_torch_state_dict(ckpt))
    emb = AnnotatorEmbedder(kind, backbone=backbone)
    emb.backbone_loaded = bool(ckpt)
    return emb
