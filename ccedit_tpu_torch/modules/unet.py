"""The SD-1.5 UNet, 2D and pseudo-3D, with the ControlNet injection points
(port of ``ccedit_tpu/modules/unet.py``).

Submodules follow the sgm ``UNetModel`` state-dict layout: ``time_embed``,
``label_emb``, ``input_blocks.{i}.{j}``, ``middle_block.{j}``,
``output_blocks.{i}.{j}``, ``out``, and for the pseudo-3D UNet
``input_blocks_temporal`` and ``out_temporal``.  Every option of the JAX
``UNetModel`` is ported: ``unet_type`` "2d" | "pseudo-3d",
``num_res_blocks`` and ``transformer_depth`` as an int or a per-level
list, ``legacy`` heads, ``use_linear_in_transformer``, ``conv_resample``,
``use_scale_shift_norm``, ``use_learnable_alpha``,
``disable_temporal_text_ca``, ``encoder_only`` (the ControlNet trunk),
``disable_text_ca`` (2D: the TVI2V appearance ControlNet),
``enable_attention3d_crossframe`` with ``st3dca_ca_type`` (pseudo-3D: CFCA
in every transformer), ``enable_ref_attn`` (2D: RAIG's reference
attention in every transformer) and ``adm_in_channels`` (vector
conditioning ``y`` through ``label_emb``); ``resblock_updown`` is accepted
and unused, as in the JAX UNet.  ``forward`` takes the appearance
branch's inputs: ``img_control`` (added onto the centre frame in the
encoder), ``ref_contexts`` (the CFCA / RAIG reference bank) and
``interpolate_control`` (added onto the first and last frames), and
``only_mid_control``.  ``use_checkpoint`` (the reference's activation
checkpointing, the JAX package's ``use_remat``) recomputes every residual
block and transformer in the backward pass instead of keeping its
activations, while autograd is recording.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..parallel.shard import active
from .blocks import Downsample, Downsample3D, ResBlock, ResBlock3D, Upsample, Upsample3D, spatial_temporal
from .layers import TimeEmbed, conv2d, group_norm, temporal_conv, timestep_embedding
from .transformer import (SpatialTransformer, SpatialTransformer3D, SpatialTransformer3DCA,
                          SpatialTransformerCA)

_TRANSFORMERS = (SpatialTransformer, SpatialTransformer3D)
_TAKES_REF = (SpatialTransformerCA, SpatialTransformer3DCA)
PerLevel = Union[int, Sequence[int]]


def _add_to_frame(h: torch.Tensor, frame: int, c: torch.Tensor) -> torch.Tensor:
    """h[:, frame] += c, in place: every block returns a fresh tensor that
    nothing else holds."""
    h[:, frame] += c
    return h


def frame_index(t: int, index: int) -> Optional[int]:
    """The local index of the clip's frame ``index`` (negative: from the
    end) in a (B, t, ...) tensor: under a frame shard on the rank that holds
    it, None on the others."""
    shard = active()
    if shard is None or not shard.frame:
        return index % t
    return shard.local_frame(index % shard.frames)


def centre_index(t: int) -> Optional[int]:
    """The index of the clip's centre frame in a (B, t, ...) tensor: t // 2,
    or under a frame shard the local index on the rank that holds it and
    None on the others."""
    shard = active()
    return shard.local_frame(shard.frames // 2) if shard is not None and shard.frame else t // 2


def heads_dims(ch: int, num_heads: int, num_head_channels: int,
               legacy: bool = False) -> Tuple[int, int]:
    """(n_heads, d_head) of a transformer at ``ch`` channels, as the JAX
    ``UNetModel._heads_dims`` (whose UNets always use spatial transformers)."""
    if num_head_channels == -1:
        n_heads, d_head = num_heads, ch // num_heads
    else:
        n_heads, d_head = ch // num_head_channels, num_head_channels
    if legacy:
        d_head = ch // num_heads
    return n_heads, d_head


def per_level(value: PerLevel, level: int) -> int:
    return value[level] if isinstance(value, (list, tuple)) else value


class UNetModel(nn.Module):
    def __init__(
        self,
        in_channels: int = 4,
        model_channels: int = 320,
        out_channels: int = 4,
        num_res_blocks: PerLevel = 2,
        attention_resolutions: Sequence[int] = (4, 2, 1),
        channel_mult: Sequence[int] = (1, 2, 4, 4),
        num_heads: int = 8,
        num_head_channels: int = -1,
        transformer_depth: PerLevel = 1,
        context_dim: Optional[int] = 768,
        use_linear_in_transformer: bool = False,
        legacy: bool = False,
        unet_type: str = "2d",
        conv_resample: bool = True,
        resblock_updown: bool = False,
        use_scale_shift_norm: bool = False,
        disable_text_ca: bool = False,
        enable_ref_attn: bool = False,
        disable_temporal_text_ca: bool = True,
        enable_attention3d_crossframe: bool = False,
        st3dca_ca_type: str = "center",
        use_learnable_alpha: bool = False,
        adm_in_channels: Optional[int] = None,
        encoder_only: bool = False,
        use_checkpoint: bool = False,
    ):
        super().__init__()
        self.use_checkpoint = use_checkpoint
        if unet_type not in ("2d", "pseudo-3d"):
            raise ValueError(f"unet_type {unet_type!r}")
        self.is_video = unet_type == "pseudo-3d"
        self.in_channels = in_channels
        self.model_channels = model_channels
        self.num_res_blocks = (tuple(num_res_blocks) if isinstance(num_res_blocks, (list, tuple))
                               else num_res_blocks)
        self.channel_mult = tuple(channel_mult)
        self.attention_resolutions = tuple(attention_resolutions)
        self.adm_in_channels = adm_in_channels
        ch = model_channels
        n_levels = len(channel_mult)

        def res(cin, cout):
            kw = dict(use_scale_shift_norm=use_scale_shift_norm)
            if self.is_video:
                return ResBlock3D(cin, 4 * ch, cout, use_learnable_alpha=use_learnable_alpha, **kw)
            return ResBlock(cin, 4 * ch, cout, **kw)

        def transformer(c, level):
            n_heads, d_head = heads_dims(c, num_heads, num_head_channels, legacy)
            depth = per_level(transformer_depth, level)
            if self.is_video:
                kw = dict(use_linear=use_linear_in_transformer,
                          disable_temporal_text_ca=disable_temporal_text_ca,
                          use_learnable_alpha=use_learnable_alpha)
                if enable_attention3d_crossframe:
                    return SpatialTransformer3DCA(c, n_heads, d_head, depth, context_dim,
                                                  ca_type=st3dca_ca_type, **kw)
                return SpatialTransformer3D(c, n_heads, d_head, depth, context_dim, **kw)
            cls = SpatialTransformerCA if enable_ref_attn else SpatialTransformer
            return cls(c, n_heads, d_head, depth, context_dim, disable_text_ca=disable_text_ca,
                       use_linear=use_linear_in_transformer)

        self.time_embed = TimeEmbed(ch, 4 * ch)
        if adm_in_channels is not None:  # sgm's "sequential" label_emb: label_emb.0.{0,2}
            self.label_emb = nn.Sequential(TimeEmbed(adm_in_channels, 4 * ch))
        blocks = [nn.ModuleList([conv2d(in_channels, ch, quant=True)])]
        enc_chans, cur, ds = [ch], ch, 1
        for level, mult in enumerate(channel_mult):
            for _ in range(per_level(num_res_blocks, level)):
                blk = [res(cur, mult * ch)]
                cur = mult * ch
                if ds in attention_resolutions:
                    blk.append(transformer(cur, level))
                blocks.append(nn.ModuleList(blk))
                enc_chans.append(cur)
            if level != n_levels - 1:
                down = Downsample3D if self.is_video else Downsample
                blocks.append(nn.ModuleList([down(cur, use_conv=conv_resample)]))
                enc_chans.append(cur)
                ds *= 2
        self.input_blocks = nn.ModuleList(blocks)
        if self.is_video:
            self.input_blocks_temporal = nn.Sequential(temporal_conv(ch, ch, quant=True))
        self.middle_block = nn.ModuleList(
            [res(cur, cur), transformer(cur, n_levels - 1), res(cur, cur)])
        self.input_channels = tuple(enc_chans)  # output channels of each input block
        if encoder_only:
            return

        blocks = []
        for level, mult in reversed(list(enumerate(channel_mult))):
            nrb = per_level(num_res_blocks, level)
            for i in range(nrb + 1):
                blk = [res(cur + enc_chans.pop(), mult * ch)]
                cur = mult * ch
                if ds in attention_resolutions:
                    blk.append(transformer(cur, level))
                if level and i == nrb:
                    up = Upsample3D if self.is_video else Upsample
                    blk.append(up(cur, use_conv=conv_resample))
                    ds //= 2
                blocks.append(nn.ModuleList(blk))
        self.output_blocks = nn.ModuleList(blocks)
        self.out = nn.Sequential(group_norm(ch), nn.SiLU(),
                                 conv2d(ch, out_channels, zero=True, quant=True))
        if self.is_video:
            self.out_temporal = nn.Sequential(
                nn.SiLU(), temporal_conv(out_channels, out_channels, quant=True))

    def embed(self, timesteps: torch.Tensor, y: Optional[torch.Tensor] = None) -> torch.Tensor:
        dtype = self.time_embed[0].weight.dtype
        emb = self.time_embed(timestep_embedding(timesteps, self.model_channels).to(dtype))
        if self.adm_in_channels is not None:
            if y is None:
                raise ValueError("the UNet is vector-conditional (adm_in_channels) but y is None")
            emb = emb + self.label_emb(y.to(dtype))
        return emb

    def _run(self, mod: nn.Module, *args, **kwargs):
        """mod(*args, **kwargs), checkpointed under ``use_checkpoint`` while
        autograd records (non-reentrant: parameter grads survive blocks none
        of whose inputs need a grad)."""
        if self.use_checkpoint and torch.is_grad_enabled():
            return checkpoint(mod, *args, use_reentrant=False, **kwargs)
        return mod(*args, **kwargs)

    def apply_block(self, blk: nn.ModuleList, h, emb, context, refs=None, bank=None):
        """One input/middle/output block.  ``refs``: an iterator over the
        reference bank; every transformer takes the next entry (None past
        its end), which only the CFCA and RAIG transformers read; ``bank``: a
        list that collects transformer outputs (the appearance branch's
        bank)."""
        for mod in blk:
            if isinstance(mod, (ResBlock, ResBlock3D)):
                h = self._run(mod, h, emb)
            elif isinstance(mod, _TRANSFORMERS):
                ref = next(refs, None) if refs is not None else None
                if isinstance(mod, _TAKES_REF):
                    h = self._run(mod, h, context=context, ref_context=ref)
                else:
                    h = self._run(mod, h, context=context)
                if bank is not None:
                    bank.append(h)
            else:
                h = mod(h)
        return h

    def forward(self, x, timesteps, context=None, y=None, control: Optional[Sequence] = None,
                img_control: Optional[Sequence] = None,
                ref_contexts: Optional[Sequence] = None,
                interpolate_control: Optional[Tuple[Sequence, Sequence]] = None,
                only_mid_control: bool = False):
        """x: (B, T, H, W, C) video latents (or (N, H, W, C) for "2d"); ``y``
        the vector conditioning of an ``adm_in_channels`` UNet.
        ``control``: the ControlNet's 13 encoder+middle residuals, added in
        the decoder.  ``img_control``: the appearance ControlNet's 13
        (B, h, w, C) maps, added onto frame T // 2 after every input block
        and after the middle block.  ``ref_contexts``: (B, h*w, C) token
        banks, one for each transformer in application order (the CFCA's,
        or RAIG's reference attention).  ``interpolate_control``: (13 maps
        for the first frame, 13 for the last), added after every input block
        and after the middle block.  ``only_mid_control`` (as in the JAX
        UNet): no ``img_control`` adds in the encoder (the middle block's
        add takes the list's first entry) and no ``control`` adds in the
        decoder."""
        emb = self.embed(timesteps, y)
        control = list(control) if control is not None else None
        img_control = list(img_control) if img_control is not None else None
        ic_first = ic_last = None
        if interpolate_control is not None:
            ic_first, ic_last = (list(c) for c in interpolate_control)
        refs = iter(ref_contexts) if ref_contexts is not None else None

        def inject(h, centre: bool):
            if img_control is not None and centre:
                c = img_control.pop(0)
                frame = centre_index(h.shape[1])
                if frame is not None:
                    h = _add_to_frame(h, frame, c)
            if ic_first is not None:  # at T = 1 both land on the one frame
                for taps, index in ((ic_first, 0), (ic_last, -1)):
                    c, frame = taps.pop(0), frame_index(h.shape[1], index)
                    if frame is not None:
                        h = _add_to_frame(h, frame, c)
            return h

        hs = []
        h = x
        for i, blk in enumerate(self.input_blocks):
            if i == 0 and self.is_video:
                h = spatial_temporal(h, blk[0], self.input_blocks_temporal)
            else:
                h = self.apply_block(blk, h, emb, context, refs)
            hs.append(inject(h, not only_mid_control))
        h = inject(self.apply_block(self.middle_block, h, emb, context, refs), True)
        if control is not None:
            h = h + control.pop()
        for blk in self.output_blocks:
            skip = hs.pop()
            if control is not None and not only_mid_control:
                skip = skip + control.pop()
            h = self.apply_block(blk, torch.cat([h, skip], dim=-1), emb, context, refs)
        if self.is_video:
            return spatial_temporal(h, self.out, self.out_temporal)
        return self.out(h)
