"""UNet residual / resampling blocks, 2D and pseudo-3D (port of
``ccedit_tpu/modules/blocks.py``).

Layouts: 2D blocks take (N, H, W, C); 3D blocks take (B, T, H, W, C).
Submodule names follow the sgm state-dict keys (``in_layers.2``,
``emb_layers.1``, ``out_layers.3``, ``skip_connection``, ``*_temporal``,
``alpha_temporal1/2``).  Every temporal twin is zero-initialised, so a fresh
pseudo-3D block computes its 2D function per frame.

Every GroupNorm -> SiLU -> conv chain is a ``NormActConv`` (under W8A8
kernel 8's fused norm form, the embedding add folded in) but where a
resample or a scale-shift modulation sits inside it.

Options, as in the JAX blocks: ``use_scale_shift_norm`` (the embedding gives
a per-channel scale and shift applied after the out norm), ``up`` / ``down``
(the residual branch resamples between its norm and its conv, the identity
on its own), ``use_conv_skip`` (a 3x3 skip projection), ``skip_t_emb`` (no
timestep embedding), and for ``ResBlock3D`` ``use_learnable_alpha``
(``alpha * skip + (1 - alpha) * temporal`` in both pseudo-3D convs) and the
``ssn`` mode with ``return_inject``.  The resampling blocks take
``use_conv=False``: a 2x2 average pool, or no conv after the upsampling.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.video import fold_time, temporal_apply
from ..parallel.shard import active
from .layers import NormActConv, QLinear, conv2d, group_norm, temporal_conv


def _spatial_shard():
    shard = active()
    return shard if shard is not None and shard.spatial else None


def nearest_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, 2H, 2W, C), nearest.  Under a spatial shard, in
    the blocks of the upper level (``ClipShard.upsampled_blocks``)."""
    y = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    shard = _spatial_shard()
    if shard is not None:
        dim = shard.split_dim(x)
        y = shard.upsampled_blocks(y, dim, 2 * shard.level_rows(x, dim))
    return y


def avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, H/2, W/2, C), 2x2 mean.  Under a spatial shard,
    from blocks that halve into the lower level's
    (``ClipShard.stride2_blocks``)."""
    shard = _spatial_shard()
    if shard is not None:
        x = shard.stride2_blocks(x, shard.split_dim(x))
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def resample_frames(x: torch.Tensor, up: bool) -> torch.Tensor:
    """Per-frame ``nearest_upsample_2x`` (up) or ``avg_pool_2x`` of (B, T,
    H, W, C)."""
    b, t = x.shape[:2]
    y = (nearest_upsample_2x if up else avg_pool_2x)(fold_time(x))
    return y.reshape((b, t) + y.shape[1:])


def spatial_temporal(x: torch.Tensor, spatial_fn: Callable,
                     temporal_fn: Optional[Callable], alpha=None) -> torch.Tensor:
    """The pseudo-3D primitive in BTHWC layout: spatial_fn on (B*T, H, W, C),
    then temporal_fn on (H*B*W, T, C) added to its input (or blended with a
    learnable alpha: alpha*skip + (1-alpha)*temporal)."""
    b, t = x.shape[0], x.shape[1]
    xs = spatial_fn(fold_time(x))
    _, h, w, _ = xs.shape

    def temporal(xt):
        if temporal_fn is None:
            return xt
        y = temporal_fn(xt)
        return alpha * xt + (1 - alpha) * y if alpha is not None else xt + y

    xs = temporal_apply(xs, b, temporal)
    return xs.reshape(b, t, h, w, xs.shape[-1])


class Upsample(nn.Module):
    """nearest 2x + conv3x3 (2D); no conv with ``use_conv=False``."""

    def __init__(self, channels: int, out_channels: Optional[int] = None,
                 use_conv: bool = True):
        super().__init__()
        self.conv = conv2d(channels, out_channels or channels, quant=True) if use_conv else None

    def forward(self, x):
        x = nearest_upsample_2x(x)
        return x if self.conv is None else self.conv(x)


class Downsample(nn.Module):
    """conv3x3 stride 2, padding 1 (2D), or a 2x2 average pool with
    ``use_conv=False``."""

    def __init__(self, channels: int, out_channels: Optional[int] = None,
                 use_conv: bool = True):
        super().__init__()
        self.op = (conv2d(channels, out_channels or channels, stride=2, quant=True) if use_conv
                   else None)

    def forward(self, x):
        return avg_pool_2x(x) if self.op is None else self.op(x)


class Upsample3D(nn.Module):
    """Per-frame nearest 2x + pseudo-3D conv (none with ``use_conv=False``)."""

    def __init__(self, channels: int, out_channels: Optional[int] = None,
                 use_conv: bool = True):
        super().__init__()
        out = out_channels or channels
        self.use_conv = use_conv
        if use_conv:
            self.conv = conv2d(channels, out, quant=True)
            self.conv_temporal = temporal_conv(out, out, quant=True)

    def forward(self, x):
        x = resample_frames(x, up=True)
        return spatial_temporal(x, self.conv, self.conv_temporal) if self.use_conv else x


class Downsample3D(nn.Module):
    """Pseudo-3D strided downsample, or a per-frame 2x2 average pool with
    ``use_conv=False``."""

    def __init__(self, channels: int, out_channels: Optional[int] = None,
                 use_conv: bool = True):
        super().__init__()
        out = out_channels or channels
        self.use_conv = use_conv
        if use_conv:
            self.op = conv2d(channels, out, stride=2, quant=True)
            self.conv_temporal = temporal_conv(out, out, quant=True)

    def forward(self, x):
        if not self.use_conv:
            return resample_frames(x, up=False)
        return spatial_temporal(x, self.op, self.conv_temporal)


def _emb_layers(emb_channels: int, out: int, use_scale_shift_norm: bool,
                skip_t_emb: bool) -> Optional[nn.Sequential]:
    if skip_t_emb:
        return None
    return nn.Sequential(nn.SiLU(), QLinear(emb_channels, 2 * out if use_scale_shift_norm
                                            else out))


def _skip_conv(channels: int, out: int, use_conv_skip: bool):
    return conv2d(channels, out, k=3 if use_conv_skip else 1, quant=True)


class ResBlock(nn.Module):
    """2D residual block with timestep conditioning: in_layers GN-SiLU-conv,
    emb_layers SiLU-Linear, out_layers GN-SiLU-(dropout)-zero conv."""

    def __init__(self, channels: int, emb_channels: int,
                 out_channels: Optional[int] = None, use_scale_shift_norm: bool = False,
                 use_conv_skip: bool = False, up: bool = False, down: bool = False,
                 skip_t_emb: bool = False):
        super().__init__()
        out = out_channels or channels
        self.out_channels = out
        self.use_scale_shift_norm = use_scale_shift_norm
        self.resample = up or down
        self.up = up
        self.in_layers = NormActConv(group_norm(channels), nn.SiLU(),
                                     conv2d(channels, out, quant=True))
        self.emb_layers = _emb_layers(emb_channels, out, use_scale_shift_norm, skip_t_emb)
        self.out_layers = NormActConv(group_norm(out), nn.SiLU(), nn.Identity(),
                                      conv2d(out, out, zero=True, quant=True))
        self.skip_connection = (nn.Identity() if out == channels
                                else _skip_conv(channels, out, use_conv_skip))

    def forward(self, x, emb):
        if self.resample:
            resample = nearest_upsample_2x if self.up else avg_pool_2x
            h = self.in_layers[2](resample(self.in_layers[:2](x)))
            x = resample(x)
        else:
            h = self.in_layers(x)
        if self.emb_layers is None:
            emb_out = h.new_zeros((x.shape[0], self.out_channels))
        else:
            emb_out = self.emb_layers(emb)
        if self.use_scale_shift_norm:
            scale, shift = emb_out[:, None, None, :].chunk(2, dim=-1)
            h = self.out_layers[1:](self.out_layers[0](h) * (1 + scale) + shift)
        else:
            h = self.out_layers(h, add=emb_out)
        return self.skip_connection(x) + h


class ResBlock3D(nn.Module):
    """Pseudo-3D residual block: every 2D conv (the skip projection too) gets
    a zero-initialised temporal twin with its own GN+SiLU prelude.
    Input/output: (B, T, H, W, C).

    ``ssn`` (sgm's ResBlock3DSSN): ``forward``'s ``img_emb`` (B, 2C), an
    appearance embedding's per-channel (scale, shift), modulates the out
    norm's activation, ``inject * (1 + scale2) + shift2`` (composed with the
    timestep's scale and shift under ``use_scale_shift_norm``);
    ``return_inject`` also returns that normalised activation before its
    modulation (None when neither mode norms it apart)."""

    def __init__(self, channels: int, emb_channels: int,
                 out_channels: Optional[int] = None, temporal_kernel_size: int = 3,
                 use_scale_shift_norm: bool = False, use_conv_skip: bool = False,
                 up: bool = False, down: bool = False, skip_t_emb: bool = False,
                 use_learnable_alpha: bool = False, ssn: bool = False):
        super().__init__()
        out = out_channels or channels
        k = temporal_kernel_size
        self.out_channels = out
        self.use_scale_shift_norm, self.ssn = use_scale_shift_norm, ssn
        self.resample = up or down
        self.up = up
        if use_learnable_alpha:
            self.alpha_temporal1 = nn.Parameter(torch.ones(()))
            self.alpha_temporal2 = nn.Parameter(torch.ones(()))
        else:
            self.alpha_temporal1 = self.alpha_temporal2 = None
        self.in_layers = NormActConv(group_norm(channels), nn.SiLU(),
                                     conv2d(channels, out, quant=True))
        self.in_layers_temporal = NormActConv(group_norm(out, temporal=True), nn.SiLU(),
                                              temporal_conv(out, out, k, quant=True))
        self.emb_layers = _emb_layers(emb_channels, out, use_scale_shift_norm, skip_t_emb)
        self.out_layers = NormActConv(group_norm(out), nn.SiLU(), nn.Identity(),
                                      conv2d(out, out, zero=True, quant=True))
        self.out_layers_temporal = NormActConv(group_norm(out, temporal=True), nn.SiLU(),
                                               nn.Identity(),
                                               temporal_conv(out, out, k, quant=True))
        if out == channels:
            self.skip_connection = None
        else:
            self.skip_connection = _skip_conv(channels, out, use_conv_skip)
            self.skip_connection_temporal = temporal_conv(out, out, k if use_conv_skip else 1,
                                                          quant=True)

    def forward(self, x, emb, img_emb=None, return_inject: bool = False):
        identity = x
        if self.resample:
            h = spatial_temporal(resample_frames(self.in_layers[:2](x), self.up),
                                 self.in_layers[2], self.in_layers_temporal, self.alpha_temporal1)
            identity = resample_frames(x, self.up)
        else:
            h = spatial_temporal(x, self.in_layers, self.in_layers_temporal, self.alpha_temporal1)
        if self.emb_layers is None:
            emb_out = h.new_zeros((x.shape[0], self.out_channels))
        else:
            emb_out = self.emb_layers(emb)
        emb_rows = emb_out  # (B, C)
        emb_out = emb_out[:, None, None, None, :]
        scale2 = shift2 = None
        if self.ssn and img_emb is not None:
            scale2, shift2 = img_emb[:, None, None, None, :].chunk(2, dim=-1)
        inject = None
        if self.use_scale_shift_norm or self.ssn:
            # the out norm pulled out of the spatial fn, so that the
            # modulation (and the inject point) sits between it and the SiLU
            if self.use_scale_shift_norm:
                scale, shift = emb_out.chunk(2, dim=-1)
                inject = self.out_layers[0](h)
                if scale2 is not None:
                    h = inject * (1 + scale) * (1 + scale2) + shift + shift2
                else:
                    h = inject * (1 + scale) + shift
            else:
                inject = self.out_layers[0](h + emb_out)
                h = inject * (1 + scale2) + shift2 if scale2 is not None else inject
            h = spatial_temporal(h, self.out_layers[1:], self.out_layers_temporal,
                                 self.alpha_temporal2)
        else:  # the embedding added inside the out chain, one row a frame
            add = emb_rows.repeat_interleave(h.shape[1], dim=0)
            h = spatial_temporal(h, lambda v: self.out_layers(v, add=add),
                                 self.out_layers_temporal, self.alpha_temporal2)
        if self.skip_connection is None:
            out = identity + h
        else:
            out = spatial_temporal(identity, self.skip_connection,
                                   self.skip_connection_temporal) + h
        return (out, inject) if return_inject else out
