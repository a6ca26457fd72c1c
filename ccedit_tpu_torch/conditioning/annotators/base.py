"""Structure-hint annotators (port of ``ccedit_tpu/conditioning/annotators/
base.py``: the stand-in and post-processes, one ``AnnotatorEmbedder`` for
every reference target and ``build_annotator``, with the chunking of
``chunked.py``).

``depth_midas`` runs the DPT-Hybrid backbone (``dpt_midas.py``) on frames in
[-1, 1], then one clip-global MiDaS post-process; ``depth_zoe`` runs
ZoeDepth (``zoedepth.py``) on frames mapped to [0, 1], then the 2 %/85 %
k-th-value normalisation over each sample's whole clip.  Opted into with
``allow_fake`` (the CLI's ``--fake_annotator``), the
``gradient_pseudo_depth`` luminance stand-in replaces a depth backbone; no
other kind has a stand-in.  The other kinds: ``lineart_standard``
(weight-free), ``lineart_model`` (``sk_model.pth``), ``softedge_hed`` /
``scribble_hed`` (ControlNet-1.1's HED), ``softedge_pidinet`` /
``scribble_pidinet`` (``table5_pidinet.pth``, BGR input in [0, 1];
softedge optionally ``safe_step``-quantised BEFORE the clamp), ``normal_bae``
(``scannet.pt``) and ``openpose`` (``body_pose_model.pth``); the scribble
kinds end in the host scribble post-process (the reference's
``ScribbleHEDEncoder`` raises mid-forward; the JAX package completes it
this way).  Every backbone runs per frame in chunks of ``CHUNK``.
Input/output: (B, T, H, W, 3) in [-1, 1].
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ...io.checkpoint import load_torch_state_dict
from ...parallel import mesh
from ..embedders import Embedder, as_float_frames
from .dpt_midas import DPTHybrid, detect_depth_midas, load_dpt_checkpoint
from .hed import detect_hed, hed_from_state_dict
from .lineart import lineart_standard
from .lineart_model import detect_lineart, lineart_from_state_dict
from .normalbae import detect_normalbae, normalbae_from_state_dict
from .openpose import bodypose_from_state_dict, detect_openpose
from .pidinet import detect_pidinet, pidinet_from_state_dict, safe_step
from .scribble import scribble_postprocess
from .zoedepth import ZoeDepthN, detect_depth_zoe, zoedepth_from_state_dict

CHUNK = 5  # frames per backbone call (the JAX package's chunked.py)
# the weights each kind needs (none for lineart_standard)
CHECKPOINTS = {"depth_midas": "dpt_hybrid-midas-501f0c75.pt",
               "depth_zoe": "an HF ZoeDepthForDepthEstimation state dict (ZoeD_M12_N)",
               "lineart_model": "sk_model.pth",
               "softedge_hed": "ControlNetHED.pth", "scribble_hed": "ControlNetHED.pth",
               "softedge_pidinet": "table5_pidinet.pth",
               "scribble_pidinet": "table5_pidinet.pth",
               "normal_bae": "scannet.pt", "openpose": "body_pose_model.pth"}
KINDS = tuple(CHECKPOINTS) + ("lineart_standard",)
_LOADERS = {"lineart_model": lineart_from_state_dict, "softedge_hed": hed_from_state_dict,
            "scribble_hed": hed_from_state_dict, "softedge_pidinet": pidinet_from_state_dict,
            "scribble_pidinet": pidinet_from_state_dict,
            "normal_bae": normalbae_from_state_dict, "openpose": bodypose_from_state_dict}


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
    """Clip-global min-max -> clamp -> [-1, 1] -> negate -> 3 channels.  In a
    data-parallel training step (``parallel.mesh.data_parallel``) the
    min and max are the global batch's (MIN and MAX all-reduces over the
    ranks), as the JAX package's one SPMD step takes them."""
    lo = mesh.reduce_over_data(depth.min(), dist.ReduceOp.MIN)
    hi = mesh.reduce_over_data(depth.max(), dist.ReduceOp.MAX)
    depth = depth - lo
    depth = depth / torch.clamp(hi - lo, min=1e-8)
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


def _scribble(edge: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 1) edge in [0, 1] -> the host scribble post-process."""
    scrib = scribble_postprocess(edge[..., 0].cpu().numpy())
    return torch.from_numpy(scrib).to(edge.device)[..., None]


class AnnotatorEmbedder(Embedder):
    """Fold video -> per-frame backbone, ``CHUNK`` frames at a time ->
    postprocess.  ``backbone`` is the kind's network (none for
    ``lineart_standard``); a depth kind without one takes the stand-in when
    ``allow_fake``, and any other kind without one raises, naming the file
    it needs.  ``backbone_loaded`` says whether its weights came from a
    checkpoint.  ``safe`` quantises the PiDiNet soft edge (``safe_step``)."""

    def __init__(self, kind: str, backbone: Optional[nn.Module] = None,
                 allow_fake: bool = False, safe: bool = False):
        super().__init__()
        if kind not in KINDS:
            raise NotImplementedError(f"annotator {kind!r} is not a structure hint")
        self.kind = kind
        self.backbone = backbone
        self.backbone_loaded = False
        self.allow_fake = allow_fake
        self.safe = safe

    def _needs_backbone(self) -> None:
        if self.backbone is None:
            raise RuntimeError(
                f"{self.kind} has no backbone; set ckpt_path in the embedder params "
                f"({CHECKPOINTS[self.kind]})"
                + (" or opt into the luminance pseudo-depth stand-in with --fake_annotator "
                   "(NOT a depth model; debug only)" if self.kind.startswith("depth") else ""))

    def chunked(self, fn, frames: torch.Tensor) -> torch.Tensor:
        """``fn`` over ``frames`` ``CHUNK`` at a time, concatenated in fp32."""
        return torch.cat([fn(frames[i:i + CHUNK]).float()
                          for i in range(0, frames.shape[0], CHUNK)])

    def depth(self, frames: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) frames in the backbone's input range ([-1, 1] for
        DPT, [0, 1] for Zoe) -> (N, H, W) fp32 depth."""
        if self.backbone is None and self.allow_fake:
            return gradient_pseudo_depth(frames)
        self._needs_backbone()
        detect = detect_depth_midas if self.kind == "depth_midas" else detect_depth_zoe
        return self.chunked(lambda f: detect(self.backbone, f), frames)

    def hint(self, frames: torch.Tensor, b: int) -> torch.Tensor:
        """(N, H, W, 3) frames in [-1, 1] of ``b`` clips -> (N, H, W, 3)."""
        kind = self.kind
        if kind == "depth_midas":
            return midas_postprocess(self.depth(frames))
        if kind == "depth_zoe":
            return zoe_postprocess(self.depth((frames + 1.0) * 0.5), b)
        if kind == "lineart_standard":
            return self.chunked(lineart_standard, frames)
        self._needs_backbone()
        net = self.backbone
        if kind == "lineart_model":  # LineartEncoder negates
            return -self.chunked(lambda f: detect_lineart(net, f), frames).repeat_interleave(3, -1)
        if kind == "normal_bae":
            return self.chunked(lambda f: detect_normalbae(net, (f + 1.0) * 0.5), frames)
        if kind == "openpose":
            return self.chunked(lambda f: detect_openpose(net, f), frames)
        if kind.endswith("_hed"):
            edge = self.chunked(lambda f: detect_hed(net, f), frames)
        else:  # PiDiNet: BGR in [0, 1]
            edge = self.chunked(lambda f: detect_pidinet(net, ((f + 1.0) * 0.5).flip(-1)),
                                frames)
        if kind.startswith("scribble"):
            edge = _scribble(edge)
        elif kind == "softedge_pidinet":  # safe_step first (it may exceed 1), clamp after
            edge = (safe_step(edge) if self.safe else edge).clamp(0.0, 1.0)
        return ((1.0 - edge) * 2.0 - 1.0).repeat_interleave(3, dim=-1)

    def forward(self, prepared: torch.Tensor) -> torch.Tensor:
        x = as_float_frames(prepared)
        b, t = x.shape[:2]
        out = self.hint(x.reshape((b * t,) + x.shape[2:]), b)
        return out.reshape((b, t) + out.shape[1:])


# the reference's annotator targets and their kinds
TARGETS = {"DepthMidasEncoder": "depth_midas", "DepthZoeEncoder": "depth_zoe",
           "LineartEncoder": "lineart_standard", "SoftEdgeEncoder": "softedge_pidinet",
           "NormalBaeEncoder": "normal_bae", "ScribbleHEDEncoder": "scribble_hed",
           "ScribblePidiNetEncoder": "scribble_pidinet", "OpenposeEncoder": "openpose"}


def build_annotator(target_name: str, params: dict) -> AnnotatorEmbedder:
    """The annotator of a reference embedder target.  Depth:
    ``fake_annotator`` selects the stand-in; otherwise the backbone is
    built, from ``ckpt_path`` when given (ZoeDepth sized to the file) and
    else at the production size, its weights left to the caller.  Every
    other kind with weights is built from ``ckpt_path`` (sized to the file)
    and without one has no backbone, raising when it runs, as the JAX
    package's does; ``fake_annotator`` does not touch it.
    ``LineartEncoder`` with ``lineart_standard: false`` is the learned
    lineart model."""
    if target_name not in TARGETS:
        raise KeyError(f"annotator target {target_name!r} is not a structure hint")
    kind = TARGETS[target_name]
    if kind == "lineart_standard" and not params.get("lineart_standard", True):
        kind = "lineart_model"
    ckpt = params.get("ckpt_path")
    safe = bool(params.get("safe", False))
    if kind.startswith("depth"):
        if params.get("fake_annotator"):
            return AnnotatorEmbedder(kind, allow_fake=True)
        if kind == "depth_zoe":
            backbone = (zoedepth_from_state_dict(load_torch_state_dict(ckpt)) if ckpt
                        else ZoeDepthN())
        else:
            backbone = DPTHybrid()
            if ckpt:
                load_dpt_checkpoint(backbone, load_torch_state_dict(ckpt))
    elif kind == "lineart_standard" or not ckpt:
        return AnnotatorEmbedder(kind, safe=safe)
    else:
        backbone = _LOADERS[kind](load_torch_state_dict(ckpt))
    emb = AnnotatorEmbedder(kind, backbone=backbone, safe=safe)
    emb.backbone_loaded = bool(ckpt)
    return emb
