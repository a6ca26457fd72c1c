"""Kernel 2: short-sequence (temporal) self-attention — wrapper, plain version
and launch count.

Port of ``ccedit_tpu/ops/temporal_attention.py::small_seq_attention``.  The
CUDA source, with its design note, is ``csrc/temporal_attention.cu``.  When
autograd needs the gradient, the wrapper goes through ``TemporalAttention``:
kernel 2 forward, and a backward that recomputes the plain attention and
takes its vector-Jacobian product, as ``ccedit_tpu/ops/attention.py::
_small_seq_diff`` does (the JAX package has no Pallas backward for it).
"""

from __future__ import annotations

import torch

from . import build

MAX_T = 32
MAX_HEAD_DIM = 256
HEAD_DIMS = tuple(range(8, MAX_HEAD_DIM + 1, 8))  # the kernel takes d % 8 == 0


def plain_temporal_attention(q, k, v, scale: float) -> torch.Tensor:
    """Matmul + fp32 softmax, all in fp32 (as the TPU kernel computes)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


def _forward(q, k, v, scale: float) -> torch.Tensor:
    if not q.is_cuda:
        return plain_temporal_attention(q, k, v, scale)
    b, h, t, d = q.shape
    if k.shape[2] != t or t > MAX_T or d not in HEAD_DIMS:
        raise ValueError(f"temporal kernel takes n_q == n_k <= {MAX_T}, "
                         f"head_dim % 8 == 0 and <= {MAX_HEAD_DIM}; got "
                         f"q {tuple(q.shape)}, k {tuple(k.shape)}")
    out = torch.empty_like(q)
    strides = build.attention_operand_strides(q, k, v, out, (d,))
    build.launch("ccedit_temporal_attention", q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), out.data_ptr(), b, h, t, d, strides,
                 float(scale), build.stream_of(q))
    small_seq_attention.launches += 1
    return out


class TemporalAttention(torch.autograd.Function):
    """Kernel 2 forward (plain on the CPU); plain recompute + vjp backward."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return _forward(q, k, v, scale)

    @staticmethod
    def backward(ctx, do):
        with torch.enable_grad():
            q, k, v = (t.detach().requires_grad_(True) for t in ctx.saved_tensors)
            out = plain_temporal_attention(q, k, v, ctx.scale)
        return (*torch.autograd.grad(out, (q, k, v), do), None)


def small_seq_attention(q, k, v, scale: float) -> torch.Tensor:
    """Self-attention over (B, H, T, D) with T <= 32 and a large B*H.  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel or
    raises.  Differentiable through ``TemporalAttention``."""
    if build.needs_grad(q, k, v):
        return TemporalAttention.apply(q, k, v, scale)
    return _forward(q, k, v, scale)


small_seq_attention.launches = 0
