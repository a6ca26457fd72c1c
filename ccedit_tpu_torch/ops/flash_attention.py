"""Kernel 3: flash-attention forward at head_dim 512 (the VAE's mid-block
attention), and its backward, kernel 4 at d = 512 — wrappers, plain versions
and launch counts.

Port of the stock Pallas TPU flash attention forward that
``ccedit_tpu/ops/attention.py::_flash_diff`` calls, and of the stock flash
backward that ``_xla_attention_bwd`` runs at its shapes.  The CUDA sources,
with their design notes, are ``csrc/flash_attention.cu`` (TMA, wgmma,
register accumulators for Hopper) and ``csrc/flash_attention_bwd.cu``.
When autograd needs the attention's gradient (VAE training),
``flash_attention`` goes through ``FlashAttention``:
its forward launches kernel 3 with the row log-sum-exp saved, its backward
launches kernel 4 at d = 512; on the CPU both are the plain versions.  The
first port's simple template, at head_dim 40 and swept tiles, is kernel 7
(``csrc/flash_tiles.cu``), which only ``scripts/profile_blocks.py``
launches.
"""

from __future__ import annotations

import collections
import math

import torch

from . import build
from .spatial_attention import attention_function, grad_operand, plain_spatial_attention_bwd

HEAD_DIMS = (512,)
_LOG2E = 1.0 / math.log(2.0)


def plain_flash_attention(q, k, v, scale: float) -> torch.Tensor:
    """Matmul + fp32 softmax, probabilities cast to q's dtype (the XLA
    attention of ``ccedit_tpu/ops/attention.py::_xla_attention``)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.matmul(p, v)


def _forward(q, k, v, scale: float, lse=None) -> torch.Tensor:
    """Launch kernel 3; with ``lse``, a (B*H, n_q) fp32 tensor, it also
    writes each row's log2-domain log-sum-exp there."""
    out = torch.empty_like(q)
    strides = build.attention_operand_strides(q, k, v, out, HEAD_DIMS)
    b, h, n_q, d = q.shape
    build.launch("ccedit_flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), None if lse is None else lse.data_ptr(), b, h, n_q,
                 k.shape[2], d, strides, float(scale) * _LOG2E, build.stream_of(q))
    flash_attention.launches += 1
    if lse is not None:
        flash_attention.variant_launches["lse"] += 1
    return out


def flash_attention_bwd(q, k, v, out, do, lse, scale: float):
    """Kernel 4 at d = 512: dq, dk, dv of kernel 3's attention from its
    inputs, its output, the output's gradient ``do`` and kernel 3's ``lse``.
    A CPU tensor takes kernel 4's plain version at every head dim,
    ``plain_spatial_attention_bwd`` (which recomputes from q, k, v); a CUDA
    tensor launches the kernel or raises."""
    if not q.is_cuda:
        return plain_spatial_attention_bwd(q, k, v, do, scale)
    do = grad_operand(do, q, lse)
    b, h, n_q, d = q.shape
    # delta = rowsum(dO * O) in fp32, a torch reduction outside the kernels
    # (as the stock Pallas backward computes its `di`)
    delta = (do.float() * out.float()).sum(-1).reshape(b * h, n_q)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    strides = build.attention_operand_strides(q, k, v, do, HEAD_DIMS, dq=dq, dk=dk, dv=dv)
    build.launch("ccedit_flash_attention_bwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), b, h, n_q, k.shape[2], d, strides, float(scale) * _LOG2E,
                 float(scale), build.stream_of(q))
    flash_attention_bwd.launches += 1
    return dq, dk, dv


# kernel 3 forward with its lse, kernel 4 (d = 512) backward; plain versions
# on the CPU
FlashAttention = attention_function("FlashAttention", _forward, plain_flash_attention,
                                    flash_attention_bwd)


def flash_attention(q, k, v, scale: float) -> torch.Tensor:
    """Non-causal attention over (B, H, N, D), D = 512.  A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel or raises.  When
    autograd needs the gradient, it goes through ``FlashAttention``."""
    if build.needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, scale)
    if not q.is_cuda:
        return plain_flash_attention(q, k, v, scale)
    return _forward(q, k, v, scale)


flash_attention.launches = 0
flash_attention.variant_launches = collections.Counter()
flash_attention_bwd.launches = 0
