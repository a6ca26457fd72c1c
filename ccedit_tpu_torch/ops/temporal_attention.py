"""Kernel 2: short-sequence (temporal) self-attention — wrapper, plain version
and launch count.

Port of ``ccedit_tpu/ops/temporal_attention.py::small_seq_attention``.  The
CUDA source, with its design note, is ``csrc/temporal_attention.cu``.
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


def small_seq_attention(q, k, v, scale: float) -> torch.Tensor:
    """Self-attention over (B, H, T, D) with T <= 32 and a large B*H.  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel or
    raises."""
    build.check_grad_free(q, k, v)
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


small_seq_attention.launches = 0
