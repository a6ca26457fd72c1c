"""The weight-free ``lineart_standard`` hint (port of
``ccedit_tpu/conditioning/annotators/lineart.py``).

Per frame, in 0..255: a 37-tap separable Gaussian (sigma 6, the ksize cv2
picks for uint8) with edge replication, the channel minimum of
``blur - image`` clipped to [0, 255], divided by max(16, the median of its
values above 8) and scaled by 127, clipped, mapped to [-1, 1] and negated,
three channels.  The median is the LOWER middle of the masked values,
``(cnt - 1) // 2`` of the sorted ones, as the JAX package takes it (numpy's
median would average the two middles of an even count).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .imgproc import gaussian_kernel


def lineart_standard(frames: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) in [-1, 1] -> (N, H, W, 3) lineart hint in [-1, 1], fp32."""
    x255 = (frames.float() + 1.0) * 0.5 * 255.0
    n, h, w, c = x255.shape
    k = torch.from_numpy(gaussian_kernel(37, 6.0).astype(np.float32)).to(x255.device)
    pad = (k.numel() - 1) // 2
    xch = F.pad(x255.permute(0, 3, 1, 2).reshape(n * c, 1, h, w), (pad,) * 4, mode="replicate")
    g = F.conv2d(F.conv2d(xch, k.view(1, 1, -1, 1)), k.view(1, 1, 1, -1))
    g = g.view(n, c, h, w).permute(0, 2, 3, 1)
    intensity = (g - x255).amin(dim=-1).clamp(0.0, 255.0)
    flat = intensity.reshape(n, -1)
    above = flat > 8.0
    cnt = above.sum(dim=1)
    svals = torch.where(above, flat, torch.full_like(flat, float("inf"))).sort(dim=1).values
    mid = ((cnt - 1) // 2).clamp(min=0)
    med = torch.where(cnt > 0, svals.gather(1, mid[:, None])[:, 0],
                      torch.zeros_like(flat[:, 0]))
    denom = med.clamp(min=16.0)
    result = (intensity / denom[:, None, None] * 127.0).clamp(0.0, 255.0)
    out = -(result / 255.0 * 2.0 - 1.0)
    return out[..., None].repeat_interleave(3, dim=-1)
