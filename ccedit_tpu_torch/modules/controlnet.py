"""The ControlNet branches and the composed CCEdit network (port of
``ccedit_tpu/modules/controlnet.py``: ``HintPyramid`` (with
``latent=True`` the JAX ``HintPyramidLatent``), ``ZeroConv2D``,
``ControlNet2D`` with ``no_add_x`` / ``input_hint_identity``,
``ControlNet3D``, ``raig_ref_mapping`` and ``CCEditNetwork`` with the
structure branch, the TVI2V appearance branch, the frame-interpolation
branch and RAIG).

State-dict layout: the ControlNet's keys are the sgm ``ControlNet`` keys
(``input_hint_block.{0..14}`` unless the hint block is the identity,
``zero_convs.{i}.0``, ``middle_block_out.0`` plus its encoder-only UNet
trunk; ControlNet3D adds ``zero_convs_temporal.{i}.0`` and
``middle_block_out_temporal.0``).  ``CCEditNetwork`` holds ``unet``,
``controlnet`` and ``controlnet_img``; the reference checkpoint's
``model.diffusion_model.``, ``model.diffusion_model.controlnet.`` and
``model.diffusion_model.controlnet_img.`` sub-dicts load into them as they
are.

Under a clip shard (``parallel/shard.py``) the appearance branch runs on the
clip's centre frame (the interpolation branch on its first and last, RAIG's
on the image): under a height or width shard on this rank's rows of it,
with the same rows of the replicated ``cond_feat`` (and of
``interpolate_first_last``); under a frame shard on the whole frames,
broadcast by the ranks that hold them, on every rank.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.video import fold_time, unfold_time
from ..parallel.shard import active, unsharded
from ..utils import trace
from .blocks import spatial_temporal
from .layers import conv2d, temporal_conv
from .unet import UNetModel, per_level

# channel ladder and strides of the ControlNet hint pyramid
_HINT_CHANNELS = (16, 16, 32, 32, 96, 96, 256)
_HINT_STRIDES = (1, 1, 2, 1, 2, 1, 2)
# transformer outputs banked for the CFCA reference mode: 6 encoder + middle
NUM_REF_CFCA = 7


class HintPyramid(nn.Sequential):
    """8-conv stride-2 pyramid RGB -> model_channels, zero-ended; sgm keys
    ``input_hint_block.{0,2,...,12}`` and ``.14``.  ``latent``: every conv
    at stride 1 (ControlNet3D's ``HintPyramidLatent``, for a hint already at
    latent resolution)."""

    def __init__(self, hint_channels: int, model_channels: int, latent: bool = False):
        layers = []
        cin = hint_channels
        for ch, s in zip(_HINT_CHANNELS, _HINT_STRIDES):
            layers += [conv2d(cin, ch, stride=1 if latent else s, quant=True), nn.SiLU()]
            cin = ch
        layers.append(conv2d(cin, model_channels, zero=True, quant=True))
        super().__init__(*layers)


class ZeroConv2D(nn.Sequential):
    """Zero-initialised 1x1 convolution (sgm key ``.0``)."""

    def __init__(self, channels: int):
        super().__init__(conv2d(channels, channels, k=1, zero=True, quant=True))


class ControlNet2D(UNetModel):
    """Encoder-half UNet emitting 13 zero-conv'd residual taps.  Takes
    (B, T, H, W, C) video, run per frame with emb, context and y repeated,
    or (N, H, W, C) images (the appearance branch's centre frame).

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

    def forward(self, x, hint_features, timesteps, context=None, y=None,
                bank: Optional[List[torch.Tensor]] = None):
        """x: (B, T, h, w, C) or (N, h, w, C) latents; hint_features from
        ``encode_hint``.  Returns the 13 control residuals, each shaped as x
        at its resolution.  ``bank``, when given, collects the first
        NUM_REF_CFCA transformer outputs (the CFCA / RAIG reference bank)."""
        video = x.dim() == 5
        if video:
            b, t = x.shape[0], x.shape[1]
            x = fold_time(x)
            hint_features = fold_time(hint_features)
            timesteps = torch.repeat_interleave(timesteps, t, dim=0)
            if context is not None:
                context = torch.repeat_interleave(context, t, dim=0)
            if y is not None:
                y = torch.repeat_interleave(y, t, dim=0)
        emb = self.embed(timesteps, y)
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


class ControlNet3D(UNetModel):
    """The temporal-aware control branch (sgm's ControlNet3D): a pseudo-3D
    encoder trunk whose 13 taps are pseudo-3D zero convs (a 1x1 zero conv
    and a k=1 zero temporal conv), with a stride-1 hint pyramid for a
    latent-resolution hint.  Takes (B, T, h, w, C) latents and a (B, T, h,
    w, hint_channels) hint (or (B, h, w, hint_channels)).

    ``disable_temporal``: only the centre frame runs (T = 1, where every
    temporal twin adds nothing, as the reference's module stripping for
    2D-initialised checkpoints), and the taps are (B, h', w', C) maps."""

    def __init__(self, hint_channels: int = 4, control_scales: float = 1.0,
                 disable_temporal: bool = False, **unet_kwargs):
        unet_kwargs.pop("out_channels", None)
        super().__init__(unet_type="pseudo-3d", encoder_only=True, **unet_kwargs)
        self.control_scales = control_scales
        self.disable_temporal = disable_temporal
        self.input_hint_block = HintPyramid(hint_channels, self.model_channels, latent=True)
        self.zero_convs = nn.ModuleList(ZeroConv2D(c) for c in self.input_channels)
        self.zero_convs_temporal = nn.ModuleList(
            nn.Sequential(temporal_conv(c, c, 1, quant=True)) for c in self.input_channels)
        self.middle_block_out = ZeroConv2D(self.input_channels[-1])
        self.middle_block_out_temporal = nn.Sequential(
            temporal_conv(self.input_channels[-1], self.input_channels[-1], 1, quant=True))

    def forward(self, x, hint, timesteps, context=None, y=None):
        if self.disable_temporal:
            shard = active()
            if shard is not None and shard.frame:  # every rank runs the whole centre frame
                x = shard.centre_frame(x)
                hint = shard.centre_frame(hint) if hint.dim() == 5 else hint
                with unsharded():
                    return self.forward(x[:, None], hint[:, None], timesteps, context, y)
            t_mid = x.shape[1] // 2
            x = x[:, t_mid:t_mid + 1]
            hint = hint[:, t_mid:t_mid + 1] if hint.dim() == 5 else hint[:, None]
        b = x.shape[0]
        emb = self.embed(timesteps, y)
        guided = unfold_time(self.input_hint_block(fold_time(hint)), b)
        outs = []
        h = x
        for i, blk in enumerate(self.input_blocks):
            if i == 0:
                h = spatial_temporal(h, blk[0], self.input_blocks_temporal) + guided
            else:
                h = self.apply_block(blk, h, emb, context)
            outs.append(spatial_temporal(h, self.zero_convs[i], self.zero_convs_temporal[i]))
        h = self.apply_block(self.middle_block, h, emb, context)
        outs.append(spatial_temporal(h, self.middle_block_out, self.middle_block_out_temporal))
        if self.disable_temporal:  # centre-frame maps (B, h', w', C)
            return tuple(o[:, 0] * self.control_scales for o in outs)
        return tuple(o * self.control_scales for o in outs)


def raig_ref_mapping(channel_mult: Sequence[int], num_res_blocks,
                     attention_resolutions: Sequence[int]) -> Tuple[int, ...]:
    """The bank index of every UNet transformer in application order:
    encoder and middle transformers take their own banked activation; each
    decoder level takes its encoder level's banks in reverse, front-padded
    with the level's last bank (the SD-1.5 layout gives the reference's
    table, {0..6, 5,5,4,3,3,2,1,1,0})."""
    enc_banks, mapping = {}, []
    ds, k = 1, 0
    for level in range(len(channel_mult)):
        banks = []
        if ds in attention_resolutions:
            for _ in range(per_level(num_res_blocks, level)):
                banks.append(k)
                mapping.append(k)
                k += 1
        enc_banks[level] = banks
        if level != len(channel_mult) - 1:
            ds *= 2
    mapping.append(k)  # middle
    for level in reversed(range(len(channel_mult))):
        if ds in attention_resolutions:
            banks = list(reversed(enc_banks[level]))
            n_slots = per_level(num_res_blocks, level) + 1
            mapping.extend([banks[0]] * (n_slots - len(banks)) + banks)
        if level:
            ds //= 2
    return tuple(mapping)


def _tokens(a: torch.Tensor) -> torch.Tensor:
    """(B, h, w, C) activations -> (B, h*w, C) tokens."""
    return a.reshape(a.shape[0], -1, a.shape[-1])


class CCEditNetwork(nn.Module):
    """pseudo-3D UNet + structure ControlNet (+ the appearance ControlNet):
    ``(x, t, cond) -> eps``.

    cond keys: ``crossattn`` (B, L, D) text tokens; ``vector`` (B, adm),
    for a vector-conditional UNet; ``concat``, latents concatenated onto x's
    channels; either ``control_hint`` (B, T, H, W, 3) in [-1, 1] or the
    precomputed ``control_hint_features`` from ``encode_control_hint``; for
    the TVI2V appearance branch ``cond_feat`` (B, h, w, 4), the scaled VAE
    latent of the edited reference frame; for ``interpolate``
    ``interpolate_first_last`` (B, 2, h, w, 4), the latents of the first
    and last frames.

    * ``crossframe_type="reference"`` also feeds the appearance branch's
      transformer outputs to the UNet's CFCA as k/v.
    * ``interpolate`` (ControlledUNetModel3DTV2VInterpolate): the appearance
      branch runs on x's first and last frames, stacked on the batch axis
      (first frames, then last) with the hint, t, context and y doubled in
      that order; its taps are added onto the UNet's first and last frames.
    * ``raig`` (ControlledUNetModel2DRAIG, a 2-D UNet with
      ``enable_ref_attn``): the appearance branch runs on x only to bank its
      first NUM_REF_CFCA transformer outputs, and every UNet transformer
      attends to the bank entry ``raig_ref_mapping`` gives it."""

    def __init__(self, unet: UNetModel, controlnet: Optional[ControlNet2D] = None,
                 controlnet_img: Optional[ControlNet2D] = None,
                 crossframe_type: Optional[str] = None, interpolate: bool = False,
                 raig: bool = False):
        super().__init__()
        if crossframe_type not in (None, "reference"):
            raise ValueError(f"crossframe_type {crossframe_type!r}")
        self.unet = unet
        self.controlnet = controlnet
        self.controlnet_img = controlnet_img
        self.crossframe_type = crossframe_type
        self.interpolate = interpolate
        self.raig = raig

    def encode_control_hint(self, control_hint: torch.Tensor) -> torch.Tensor:
        """ControlNet-1.1 inversion + hint pyramid, once per clip."""
        return self.controlnet.encode_hint(1.0 - (control_hint + 1.0) / 2.0)

    def forward(self, x, timesteps, cond: Dict[str, torch.Tensor]):
        context, y = cond.get("crossattn"), cond.get("vector")
        if cond.get("concat") is not None:
            x = torch.cat([x, cond["concat"]], dim=-1)
        cn_img = self.controlnet_img
        shard = active()
        spatial = shard is not None and shard.spatial
        if self.raig:
            bank = []
            feat = cond["cond_feat"]  # (B, h, w, C): this rank's rows of it
            feat = shard.block(feat, shard.axis - 1) if spatial else feat
            with trace.span(trace.APPEARANCE):
                cn_img(x, cn_img.encode_hint(feat), timesteps, context=context, y=y, bank=bank)
            mapping = raig_ref_mapping(self.unet.channel_mult, self.unet.num_res_blocks,
                                       self.unet.attention_resolutions)
            refs = [_tokens(bank[m]) for m in mapping]
            return self.unet(x, timesteps, context=context, y=y, ref_contexts=refs)
        control = None
        if self.controlnet is not None:
            feats = cond.get("control_hint_features")
            if feats is None and "control_hint" in cond:
                feats = self.encode_control_hint(cond["control_hint"])
            if feats is not None:
                with trace.span(trace.CONTROLNET):
                    control = self.controlnet(x, feats, timesteps, context=context, y=y)
        img_control = ref_contexts = interpolate_control = None
        if self.interpolate:
            ifl = cond["interpolate_first_last"]  # (B, 2, h, w, C): split like the latents
            ifl = shard.block(ifl, shard.axis) if spatial else ifl
            double = lambda a: None if a is None else torch.cat([a, a], dim=0)
            frame = shard is not None and shard.frame
            ends = ((shard.frame_at(x, 0), shard.frame_at(x, shard.frames - 1)) if frame
                    else (x[:, 0], x[:, -1]))
            with (unsharded() if frame else contextlib.nullcontext(),  # whole frames on every rank
                  trace.span(trace.APPEARANCE)):
                taps = cn_img(torch.cat(ends, dim=0),
                              cn_img.encode_hint(torch.cat([ifl[:, 0], ifl[:, 1]], dim=0)),
                              double(timesteps), context=double(context), y=double(y))
            interpolate_control = tuple(zip(*(c.chunk(2, dim=0) for c in taps)))
        elif cn_img is not None and "cond_feat" in cond:
            bank = [] if self.crossframe_type == "reference" else None
            centre = (shard.centre_frame(x) if shard is not None and shard.frame
                      else x[:, x.shape[1] // 2])
            feat = cond["cond_feat"]  # (B, h, w, C): this rank's rows of it
            feat = shard.block(feat, shard.axis - 1) if spatial else feat
            with trace.span(trace.APPEARANCE):
                img_control = cn_img(centre, cn_img.encode_hint(feat), timesteps,
                                     context=context, y=y, bank=bank)
            if bank is not None:
                ref_contexts = [_tokens(a) for a in bank]
        return self.unet(x, timesteps, context=context, y=y, control=control,
                         img_control=img_control, ref_contexts=ref_contexts,
                         interpolate_control=interpolate_control)
