"""The ControlNet branches and the composed CCEdit network (port of
``ccedit_tpu/modules/controlnet.py``: ``HintPyramid``, ``ZeroConv2D``,
``ControlNet2D`` with ``no_add_x`` / ``input_hint_identity``, and
``CCEditNetwork`` with the structure branch and the TVI2V appearance branch;
the interpolation, RAIG and ControlNet3D variants are not ported).

State-dict layout: the ControlNet's keys are the sgm ``ControlNet`` keys
(``input_hint_block.{0..14}`` unless the hint block is the identity,
``zero_convs.{i}.0``, ``middle_block_out.0`` plus its encoder-only UNet
trunk).  ``CCEditNetwork`` holds ``unet``, ``controlnet`` and
``controlnet_img``; the reference checkpoint's ``model.diffusion_model.``,
``model.diffusion_model.controlnet.`` and
``model.diffusion_model.controlnet_img.`` sub-dicts load into them as they are.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from ..ops.video import fold_time, unfold_time
from .layers import conv2d
from .unet import UNetModel

# channel ladder and strides of the ControlNet hint pyramid
_HINT_CHANNELS = (16, 16, 32, 32, 96, 96, 256)
_HINT_STRIDES = (1, 1, 2, 1, 2, 1, 2)
# transformer outputs banked for the CFCA reference mode: 6 encoder + middle
NUM_REF_CFCA = 7


class HintPyramid(nn.Sequential):
    """8-conv stride-2 pyramid RGB -> model_channels, zero-ended; sgm keys
    ``input_hint_block.{0,2,...,12}`` and ``.14``."""

    def __init__(self, hint_channels: int, model_channels: int):
        layers = []
        cin = hint_channels
        for ch, s in zip(_HINT_CHANNELS, _HINT_STRIDES):
            layers += [conv2d(cin, ch, stride=s), nn.SiLU()]
            cin = ch
        layers.append(conv2d(cin, model_channels, zero=True))
        super().__init__(*layers)


class ZeroConv2D(nn.Sequential):
    """Zero-initialised 1x1 convolution (sgm key ``.0``)."""

    def __init__(self, channels: int):
        super().__init__(conv2d(channels, channels, k=1, zero=True))


class ControlNet2D(UNetModel):
    """Encoder-half UNet emitting 13 zero-conv'd residual taps.  Takes
    (B, T, H, W, C) video, run per frame with emb and context repeated, or
    (N, H, W, C) images (the appearance branch's centre frame).

    ``input_hint_identity``: no hint pyramid; the (latent) hint goes through
    the stem conv ``input_blocks.0.0``.  ``no_add_x``: that hint feature
    replaces h at block 0 instead of being added to the stem's output."""

    def __init__(self, hint_channels: int = 3, control_scales: float = 1.0,
                 no_add_x: bool = False, input_hint_identity: bool = False,
                 **unet_kwargs):
        unet_kwargs.pop("out_channels", None)
        super().__init__(unet_type="2d", encoder_only=True, **unet_kwargs)
        ch = self.model_channels
        self.control_scales = control_scales
        self.no_add_x = no_add_x
        self.input_hint_identity = input_hint_identity
        if not input_hint_identity:
            self.input_hint_block = HintPyramid(hint_channels, ch)
        self.zero_convs = nn.ModuleList(ZeroConv2D(c) for c in self.input_channels)
        self.middle_block_out = ZeroConv2D(self.input_channels[-1])

    def encode_hint(self, hint: torch.Tensor) -> torch.Tensor:
        """The hint pyramid (or, for an identity hint block, the stem conv)
        alone: (B, T, H, W, C) or (N, H, W, C) hint -> latent-resolution
        features with model_channels channels."""
        stem = self.input_blocks[0][0] if self.input_hint_identity else self.input_hint_block
        if hint.dim() == 4:
            return stem(hint)
        return unfold_time(stem(fold_time(hint)), hint.shape[0])

    def forward(self, x, hint_features, timesteps, context=None,
                bank: Optional[List[torch.Tensor]] = None):
        """x: (B, T, h, w, C) or (N, h, w, C) latents; hint_features from
        ``encode_hint``.  Returns the 13 control residuals, each shaped as x
        at its resolution.  ``bank``, when given, collects the first
        NUM_REF_CFCA transformer outputs (the CFCA reference bank)."""
        video = x.dim() == 5
        if video:
            b, t = x.shape[0], x.shape[1]
            x = fold_time(x)
            hint_features = fold_time(hint_features)
            timesteps = torch.repeat_interleave(timesteps, t, dim=0)
            if context is not None:
                context = torch.repeat_interleave(context, t, dim=0)
        emb = self.embed(timesteps)
        outs = []
        h = x
        for i, blk in enumerate(self.input_blocks):
            if i == 0:
                h = hint_features if self.no_add_x else (
                    self.apply_block(blk, h, emb, context) + hint_features)
            else:
                h = self.apply_block(blk, h, emb, context, bank=bank)
            outs.append(self.zero_convs[i](h))
        h = self.apply_block(self.middle_block, h, emb, context, bank=bank)
        outs.append(self.middle_block_out(h))
        if bank is not None:
            del bank[NUM_REF_CFCA:]
        outs = [o * self.control_scales for o in outs]
        return tuple(unfold_time(o, b) for o in outs) if video else tuple(outs)


class CCEditNetwork(nn.Module):
    """pseudo-3D UNet + structure ControlNet (+ the TVI2V appearance
    ControlNet on the centre frame): ``(x, t, cond) -> eps``.

    cond keys: ``crossattn`` (B, L, D) text tokens; either ``control_hint``
    (B, T, H, W, 3) in [-1, 1] or the precomputed ``control_hint_features``
    from ``encode_control_hint``; and, for the appearance branch,
    ``cond_feat`` (B, h, w, 4), the scaled VAE latent of the edited
    reference frame.  ``crossframe_type="reference"`` also feeds the
    appearance branch's transformer outputs to the UNet's CFCA as k/v."""

    def __init__(self, unet: UNetModel, controlnet: Optional[ControlNet2D] = None,
                 controlnet_img: Optional[ControlNet2D] = None,
                 crossframe_type: Optional[str] = None):
        super().__init__()
        if crossframe_type not in (None, "reference"):
            raise ValueError(f"crossframe_type {crossframe_type!r}")
        self.unet = unet
        self.controlnet = controlnet
        self.controlnet_img = controlnet_img
        self.crossframe_type = crossframe_type

    def encode_control_hint(self, control_hint: torch.Tensor) -> torch.Tensor:
        """ControlNet-1.1 inversion + hint pyramid, once per clip."""
        return self.controlnet.encode_hint(1.0 - (control_hint + 1.0) / 2.0)

    def forward(self, x, timesteps, cond: Dict[str, torch.Tensor]):
        context = cond.get("crossattn")
        control = None
        if self.controlnet is not None:
            feats = cond.get("control_hint_features")
            if feats is None and "control_hint" in cond:
                feats = self.encode_control_hint(cond["control_hint"])
            if feats is not None:
                control = self.controlnet(x, feats, timesteps, context=context)
        img_control = ref_contexts = None
        if self.controlnet_img is not None and "cond_feat" in cond:
            bank = [] if self.crossframe_type == "reference" else None
            img_control = self.controlnet_img(
                x[:, x.shape[1] // 2], self.controlnet_img.encode_hint(cond["cond_feat"]),
                timesteps, context=context, bank=bank)
            if bank is not None:  # (B, h, w, C) activations -> (B, h*w, C) tokens
                ref_contexts = [a.reshape(a.shape[0], -1, a.shape[-1]) for a in bank]
        return self.unet(x, timesteps, context=context, control=control,
                         img_control=img_control, ref_contexts=ref_contexts)
