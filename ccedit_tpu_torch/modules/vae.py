"""KL-VAE first stage (port of ``ccedit_tpu/modules/vae.py``:
``VAEResnetBlock``, ``VAEAttnBlock``, ``VAEDownsample``, ``VAEUpsample``,
``Encoder``, ``Decoder``, ``DiagonalGaussian`` and ``AutoencoderKL``).

Submodules follow the LDM ``AutoencoderKL`` keys (``encoder.down.{level}.
block.{i}``, ``encoder.down.{level}.attn.{i}`` at ``attn_resolutions``,
``decoder.mid.block_1``, ``quant_conv``, ``post_quant_conv``, ...), so a
reference ``first_stage_model.`` sub-dict loads with a strict
``load_state_dict``.  GroupNorm epsilon 1e-6, as in LDM.  Both halves' mid
blocks hold the single-head d = 512 attention that kernel 3 computes (and,
in VAE training, kernel 4 differentiates).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention
from .blocks import nearest_upsample_2x
from .layers import Conv2d, conv2d, group_norm


class VAEResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm1 = group_norm(in_channels, eps=1e-6)
        self.conv1 = conv2d(in_channels, out_channels)
        self.norm2 = group_norm(out_channels, eps=1e-6)
        self.conv2 = conv2d(out_channels, out_channels)
        self.act = nn.SiLU()
        if out_channels != in_channels:
            self.nin_shortcut = conv2d(in_channels, out_channels, k=1)

    def forward(self, x):
        h = self.conv1(self.act(self.norm1(x)))
        h = self.conv2(self.act(self.norm2(h)))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class VAEAttnBlock(nn.Module):
    """Single-head self-attention over H*W tokens (head_dim = channels)."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = group_norm(channels, eps=1e-6)
        self.q = conv2d(channels, channels, k=1)
        self.k = conv2d(channels, channels, k=1)
        self.v = conv2d(channels, channels, k=1)
        self.proj_out = conv2d(channels, channels, k=1)

    def forward(self, x):
        n, h, w, c = x.shape
        hid = self.norm(x)
        # (N, 1, H*W, C) with a unit channel stride, as the kernel takes it
        q, k, v = (m(hid).reshape(n, 1, h * w, c).contiguous() for m in (self.q, self.k, self.v))
        out = dot_product_attention(q, k, v).reshape(n, h, w, c)
        return x + self.proj_out(out)


class VAEDownsample(nn.Module):
    """conv3x3 stride 2 with LDM's asymmetric (0, 1) padding."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 0, 0, 1, 0, 1)))


class VAEUpsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = conv2d(channels, channels)

    def forward(self, x):
        return self.conv(nearest_upsample_2x(x))


class _Mid(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.block_1 = VAEResnetBlock(channels, channels)
        self.attn_1 = VAEAttnBlock(channels)
        self.block_2 = VAEResnetBlock(channels, channels)

    def forward(self, x):
        return self.block_2(self.attn_1(self.block_1(x)))


class _Level(nn.Module):
    """One resolution of the encoder or decoder: res blocks, each followed
    by an attention block where the level's resolution is in
    ``attn_resolutions`` (``attn`` is empty otherwise, as in LDM), then the
    ``downsample`` or ``upsample`` between levels."""

    def __init__(self, blocks, attns, **resample):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        self.attn = nn.ModuleList(attns)
        for name, module in resample.items():
            if module is not None:
                setattr(self, name, module)

    def forward(self, h):
        for i, blk in enumerate(self.block):
            h = blk(h)
            if len(self.attn):
                h = self.attn[i](h)
        return h


class Encoder(nn.Module):
    """(N, H, W, 3) pixels -> (N, H/f, W/f, 2 * z_channels) moments.
    ``resolution`` is the input's, against which ``attn_resolutions`` are
    matched."""

    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, in_channels: int = 3, z_channels: int = 4,
                 attn_resolutions: Sequence[int] = (), resolution: int = 256):
        super().__init__()
        self.conv_in = conv2d(in_channels, ch)
        levels, cur, cur_res = [], ch, resolution
        for level, mult in enumerate(ch_mult):
            blocks = []
            for _ in range(num_res_blocks):
                blocks.append(VAEResnetBlock(cur, ch * mult))
                cur = ch * mult
            attns = [VAEAttnBlock(cur) for _ in blocks] if cur_res in attn_resolutions else []
            last = level == len(ch_mult) - 1
            levels.append(_Level(blocks, attns, downsample=None if last else VAEDownsample(cur)))
            cur_res //= 2
        self.down = nn.ModuleList(levels)
        self.mid = _Mid(cur)
        self.norm_out = group_norm(cur, eps=1e-6)
        self.conv_out = conv2d(cur, 2 * z_channels)

    def forward(self, x):
        h = self.conv_in(x)
        for level in self.down:
            h = level(h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, out_ch: int = 3, z_channels: int = 4,
                 attn_resolutions: Sequence[int] = (), resolution: int = 256):
        super().__init__()
        cur = ch * ch_mult[-1]
        cur_res = resolution // 2 ** (len(ch_mult) - 1)
        self.conv_in = conv2d(z_channels, cur)
        self.mid = _Mid(cur)
        levels = [None] * len(ch_mult)
        for level in reversed(range(len(ch_mult))):
            blocks = []
            for _ in range(num_res_blocks + 1):
                blocks.append(VAEResnetBlock(cur, ch * ch_mult[level]))
                cur = ch * ch_mult[level]
            attns = [VAEAttnBlock(cur) for _ in blocks] if cur_res in attn_resolutions else []
            levels[level] = _Level(blocks, attns, upsample=VAEUpsample(cur) if level else None)
            cur_res *= 2
        self.up = nn.ModuleList(levels)
        self.norm_out = group_norm(cur, eps=1e-6)
        self.conv_out = conv2d(cur, out_ch)

    def forward(self, z):
        h = self.mid(self.conv_in(z))
        for level in reversed(range(len(self.up))):
            h = self.up[level](h)
            if level:
                h = self.up[level].upsample(h)
        return self.conv_out(torch.nn.functional.silu(self.norm_out(h)))


class DiagonalGaussian:
    """The posterior over latents: mean and log-variance split on the
    channel axis, log-variance clamped to [-30, 20]."""

    def __init__(self, moments: torch.Tensor):
        self.mean, logvar = moments.chunk(2, dim=-1)
        self.logvar = logvar.clamp(-30.0, 20.0)
        self.std = torch.exp(0.5 * self.logvar)
        self.var = torch.exp(self.logvar)

    def _sum_per_item(self, x: torch.Tensor) -> torch.Tensor:
        return x.sum(dim=tuple(range(1, self.mean.dim())))

    def kl(self) -> torch.Tensor:
        """KL(posterior || N(0, 1)) per item (summed over all but the first
        axis)."""
        return 0.5 * self._sum_per_item(self.mean ** 2 + self.var - 1.0 - self.logvar)

    def nll(self, sample: torch.Tensor) -> torch.Tensor:
        """-log p(sample) per item."""
        return 0.5 * self._sum_per_item(math.log(2.0 * math.pi) + self.logvar
                                        + (sample - self.mean) ** 2 / self.var)

    def mode(self) -> torch.Tensor:
        return self.mean

    def sample(self, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mean + std * noise; ``noise`` (the shape of the mean) or a draw
        from ``generator``."""
        if noise is None:
            noise = torch.randn(self.mean.shape, generator=generator,
                                device=self.mean.device, dtype=self.mean.dtype)
        return self.mean + self.std * noise


class AutoencoderKL(nn.Module):
    """The f=8 KL autoencoder.  ``encode_moments`` takes (B, T, H, W, 3) (or
    (N, H, W, 3)) pixels in [-1, 1] and returns the posterior moments;
    ``decode`` takes (B, T, h, w, 4) (or (N, h, w, 4)) latents and returns
    pixels in about [-1, 1].  Channels-last; video is folded per frame."""

    def __init__(self, embed_dim: int = 4, ch: int = 128,
                 ch_mult: Sequence[int] = (1, 2, 4, 4), num_res_blocks: int = 2,
                 out_ch: int = 3, z_channels: int = 4, in_channels: int = 3,
                 attn_resolutions: Sequence[int] = (), resolution: int = 256):
        super().__init__()
        self.ch_mult = tuple(ch_mult)
        self.encoder = Encoder(ch, ch_mult, num_res_blocks, in_channels, z_channels,
                               attn_resolutions, resolution)
        self.decoder = Decoder(ch, ch_mult, num_res_blocks, out_ch, z_channels,
                               attn_resolutions, resolution)
        self.quant_conv = conv2d(2 * z_channels, 2 * embed_dim, k=1)
        self.post_quant_conv = conv2d(embed_dim, z_channels, k=1)

    @staticmethod
    def _per_frame(fn, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 5:
            b, t = x.shape[:2]
            out = fn(x.reshape((b * t,) + x.shape[2:]))
            return out.reshape((b, t) + out.shape[1:])
        return fn(x)

    def encode_moments(self, x: torch.Tensor) -> torch.Tensor:
        return self._per_frame(lambda f: self.quant_conv(self.encoder(f)), x)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self._per_frame(lambda f: self.decoder(self.post_quant_conv(f)), z)

    def forward(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, sample_posterior: bool = True):
        """(reconstruction, posterior): the latent is the posterior's sample
        (``noise`` injected, or drawn from ``generator``) or its mode."""
        posterior = DiagonalGaussian(self.encode_moments(x))
        z = posterior.sample(generator, noise) if sample_posterior else posterior.mode()
        return self.decode(z), posterior

    def load_reference_state_dict(self, sd: Dict[str, torch.Tensor]):
        """Strict load of an LDM AutoencoderKL state dict."""
        return self.load_state_dict(sd, strict=True)
