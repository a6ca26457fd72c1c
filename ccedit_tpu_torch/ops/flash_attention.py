"""Kernel 3: flash-attention forward at head_dim 512 (the VAE decoder's
mid-block attention) — wrapper, plain version and launch count.

Port of the stock Pallas TPU flash attention forward that
``ccedit_tpu/ops/attention.py::_flash_diff`` calls.  The CUDA source, with its
design note, is ``csrc/flash_attention.cu``.  Its d = 512 backward is not
ported (ROADMAP queue 2, item 4: VAE training), so a CUDA tensor that needs
a gradient raises; on the CPU the plain version differentiates.
"""

from __future__ import annotations

import math

import torch

from . import build

HEAD_DIMS = (512,)
_LOG2E = 1.0 / math.log(2.0)


def plain_flash_attention(q, k, v, scale: float) -> torch.Tensor:
    """Matmul + fp32 softmax, probabilities cast to q's dtype (the XLA
    attention of ``ccedit_tpu/ops/attention.py::_xla_attention``)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.matmul(p, v)


def flash_attention(q, k, v, scale: float) -> torch.Tensor:
    """Non-causal attention over (B, H, N, D), D = 512.  A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel or raises."""
    if not q.is_cuda:
        return plain_flash_attention(q, k, v, scale)
    if build.needs_grad(q, k, v):
        raise NotImplementedError(
            "kernel 3 (d = 512, the VAE's attention) has no backward kernel yet "
            "(ROADMAP queue 2, item 4: the d = 512 backward with VAE training); "
            "run the VAE under torch.no_grad()")
    out = torch.empty_like(q)
    strides = build.attention_operand_strides(q, k, v, out, HEAD_DIMS)
    b, h, n_q, d = q.shape
    build.launch("ccedit_flash_attention", q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), out.data_ptr(), b, h, n_q, k.shape[2], d,
                 strides, float(scale) * _LOG2E, build.stream_of(q))
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
