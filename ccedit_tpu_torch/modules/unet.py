"""The SD-1.5 UNet, 2D and pseudo-3D, with the ControlNet injection points
(port of ``ccedit_tpu/modules/unet.py``).

Submodules follow the sgm ``UNetModel`` state-dict layout: ``time_embed``,
``input_blocks.{i}.{j}``, ``middle_block.{j}``, ``output_blocks.{i}.{j}``,
``out``, and for the pseudo-3D UNet ``input_blocks_temporal`` and
``out_temporal``.  Ported options: ``unet_type`` "2d" | "pseudo-3d" with
``disable_temporal_text_ca=True``, ``encoder_only`` (the ControlNet trunk),
``disable_text_ca`` (2D: the TVI2V appearance ControlNet),
``enable_attention3d_crossframe`` with ``st3dca_ca_type`` (pseudo-3D: CFCA
in every transformer), and the appearance branch's inputs to ``forward``:
``img_control`` (added onto the centre frame in the encoder) and
``ref_contexts`` (the CFCA reference bank).  ``use_checkpoint`` (the
reference's activation checkpointing, the JAX package's ``use_remat``)
recomputes every residual block and transformer in the backward pass
instead of keeping its activations, while autograd is recording.  RAIG,
learnable alphas, scale-shift norm and vector conditioning are not ported.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .blocks import Downsample, Downsample3D, ResBlock, ResBlock3D, Upsample, Upsample3D, spatial_temporal
from .layers import TimeEmbed, conv2d, group_norm, temporal_conv, timestep_embedding
from .transformer import SpatialTransformer, SpatialTransformer3D, SpatialTransformer3DCA

_TRANSFORMERS = (SpatialTransformer, SpatialTransformer3D)


def _add_to_centre_frame(h: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """h[:, T // 2] += c, in place: every block returns a fresh tensor that
    nothing else holds."""
    h[:, h.shape[1] // 2] += c
    return h


class UNetModel(nn.Module):
    def __init__(
        self,
        in_channels: int = 4,
        model_channels: int = 320,
        out_channels: int = 4,
        num_res_blocks: int = 2,
        attention_resolutions: Sequence[int] = (4, 2, 1),
        channel_mult: Sequence[int] = (1, 2, 4, 4),
        num_heads: int = 8,
        num_head_channels: int = -1,
        transformer_depth: int = 1,
        context_dim: Optional[int] = 768,
        unet_type: str = "2d",
        disable_temporal_text_ca: bool = True,
        encoder_only: bool = False,
        disable_text_ca: bool = False,
        enable_attention3d_crossframe: bool = False,
        st3dca_ca_type: str = "center",
        use_checkpoint: bool = False,
    ):
        super().__init__()
        self.use_checkpoint = use_checkpoint
        if unet_type not in ("2d", "pseudo-3d"):
            raise ValueError(f"unet_type {unet_type!r}")
        if unet_type == "pseudo-3d" and not disable_temporal_text_ca:
            raise NotImplementedError("temporal text cross-attention is not ported")
        self.is_video = unet_type == "pseudo-3d"
        self.model_channels = model_channels
        self.num_res_blocks, self.channel_mult = num_res_blocks, tuple(channel_mult)
        ch = model_channels
        res_cls = ResBlock3D if self.is_video else ResBlock

        def heads(c):
            if num_head_channels == -1:
                return num_heads, c // num_heads
            return c // num_head_channels, num_head_channels

        def transformer(c):
            n_heads, d_head = heads(c)
            if self.is_video and enable_attention3d_crossframe:
                return SpatialTransformer3DCA(c, n_heads, d_head, transformer_depth,
                                              context_dim, ca_type=st3dca_ca_type)
            if self.is_video:
                return SpatialTransformer3D(c, n_heads, d_head, transformer_depth, context_dim)
            return SpatialTransformer(c, n_heads, d_head, transformer_depth, context_dim,
                                      disable_text_ca=disable_text_ca)

        self.time_embed = TimeEmbed(ch, 4 * ch)
        blocks = [nn.ModuleList([conv2d(in_channels, ch)])]
        enc_chans, cur, ds = [ch], ch, 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                blk = [res_cls(cur, 4 * ch, mult * ch)]
                cur = mult * ch
                if ds in attention_resolutions:
                    blk.append(transformer(cur))
                blocks.append(nn.ModuleList(blk))
                enc_chans.append(cur)
            if level != len(channel_mult) - 1:
                blocks.append(nn.ModuleList([(Downsample3D if self.is_video else Downsample)(cur)]))
                enc_chans.append(cur)
                ds *= 2
        self.input_blocks = nn.ModuleList(blocks)
        if self.is_video:
            self.input_blocks_temporal = nn.Sequential(temporal_conv(ch, ch))
        self.middle_block = nn.ModuleList(
            [res_cls(cur, 4 * ch, cur), transformer(cur), res_cls(cur, 4 * ch, cur)])
        self.input_channels = tuple(enc_chans)  # output channels of each input block
        if encoder_only:
            return

        blocks = []
        for level, mult in reversed(list(enumerate(channel_mult))):
            for i in range(num_res_blocks + 1):
                blk = [res_cls(cur + enc_chans.pop(), 4 * ch, mult * ch)]
                cur = mult * ch
                if ds in attention_resolutions:
                    blk.append(transformer(cur))
                if level and i == num_res_blocks:
                    blk.append((Upsample3D if self.is_video else Upsample)(cur))
                    ds //= 2
                blocks.append(nn.ModuleList(blk))
        self.output_blocks = nn.ModuleList(blocks)
        self.out = nn.Sequential(group_norm(ch), nn.SiLU(), conv2d(ch, out_channels, zero=True))
        if self.is_video:
            self.out_temporal = nn.Sequential(nn.SiLU(), temporal_conv(out_channels, out_channels))

    def embed(self, timesteps: torch.Tensor) -> torch.Tensor:
        return self.time_embed(timestep_embedding(timesteps, self.model_channels).to(
            self.time_embed[0].weight.dtype))

    def _run(self, mod: nn.Module, *args, **kwargs):
        """mod(*args, **kwargs), checkpointed under ``use_checkpoint`` while
        autograd records (non-reentrant: parameter grads survive blocks none
        of whose inputs need a grad)."""
        if self.use_checkpoint and torch.is_grad_enabled():
            return checkpoint(mod, *args, use_reentrant=False, **kwargs)
        return mod(*args, **kwargs)

    def apply_block(self, blk: nn.ModuleList, h, emb, context, refs=None, bank=None):
        """One input/middle/output block.  ``refs``: an iterator over the
        CFCA reference bank, one entry taken by every CFCA transformer in
        order (entries past its end are None); ``bank``: a list that collects
        2D transformer outputs (the appearance branch's bank)."""
        for mod in blk:
            if isinstance(mod, (ResBlock, ResBlock3D)):
                h = self._run(mod, h, emb)
            elif isinstance(mod, SpatialTransformer3DCA):
                ref = next(refs, None) if refs is not None else None
                h = self._run(mod, h, context=context, ref_context=ref)
            elif isinstance(mod, _TRANSFORMERS):
                h = self._run(mod, h, context=context)
                if bank is not None:
                    bank.append(h)
            else:
                h = mod(h)
        return h

    def forward(self, x, timesteps, context=None, control: Optional[Sequence] = None,
                img_control: Optional[Sequence] = None,
                ref_contexts: Optional[Sequence] = None):
        """x: (B, T, H, W, C) video latents (or (N, H, W, C) for "2d").
        ``control``: the ControlNet's 13 encoder+middle residuals, added in
        the decoder.  ``img_control``: the appearance ControlNet's 13
        (B, h, w, C) maps, added onto frame T // 2 after every input block
        and after the middle block.  ``ref_contexts``: (B, h*w, C) token
        banks for the first transformers' CFCA, in application order."""
        emb = self.embed(timesteps)
        control = list(control) if control is not None else None
        img_control = list(img_control) if img_control is not None else None
        refs = iter(ref_contexts) if ref_contexts is not None else None
        hs = []
        h = x
        for i, blk in enumerate(self.input_blocks):
            if i == 0 and self.is_video:
                h = spatial_temporal(h, blk[0], self.input_blocks_temporal)
            else:
                h = self.apply_block(blk, h, emb, context, refs)
            if img_control is not None:
                h = _add_to_centre_frame(h, img_control.pop(0))
            hs.append(h)
        h = self.apply_block(self.middle_block, h, emb, context, refs)
        if img_control is not None:
            h = _add_to_centre_frame(h, img_control.pop(0))
        if control is not None:
            h = h + control.pop()
        for blk in self.output_blocks:
            skip = hs.pop()
            if control is not None:
                skip = skip + control.pop()
            h = self.apply_block(blk, torch.cat([h, skip], dim=-1), emb, context, refs)
        if self.is_video:
            return spatial_temporal(h, self.out, self.out_temporal)
        return self.out(h)
