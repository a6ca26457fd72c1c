"""Kernel 1: spatial attention (head_dim 40 / 80 / 160, any n_k) — wrapper,
plain version and launch counts.

Port of ``ccedit_tpu/ops/spatial_attention.py::kv_resident_attention``, both
its one-chunk branch (self-attention, n_k = n_q) and its multi-chunk branch
(the CFCA cross-frame attention, n_k = 2 * n_q).  The CUDA source, with its
design note, is ``csrc/spatial_attention.cu``.  ``launches`` counts every
launch; ``variant_launches`` splits them by ``variant(q, k)``.
"""

from __future__ import annotations

import collections
import math

import torch

from . import build

HEAD_DIMS = (40, 80, 160)
_LOG2E = 1.0 / math.log(2.0)  # exp(x) == exp2(x * log2(e))


def plain_spatial_attention(q, k, v, scale: float) -> torch.Tensor:
    """Matmul + fp32 softmax; probabilities cast to v's dtype for P.V, as the
    TPU kernel does."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p, v).to(q.dtype)


def variant(q, k) -> str:
    """The launch's variant: head dim and whether n_k == n_q."""
    return f"d{q.shape[-1]} " + ("n_k=n_q" if k.shape[-2] == q.shape[-2] else "n_k!=n_q")


def kv_resident_attention(q, k, v, scale: float) -> torch.Tensor:
    """Exact attention over (B, H, N, D).  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises."""
    build.check_grad_free(q, k, v)
    if not q.is_cuda:
        return plain_spatial_attention(q, k, v, scale)
    out = torch.empty_like(q)
    strides = build.attention_operand_strides(q, k, v, out, HEAD_DIMS)
    b, h, n_q, d = q.shape
    build.launch("ccedit_spatial_attention", q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), out.data_ptr(), b, h, n_q, k.shape[2], d,
                 strides, float(scale) * _LOG2E, build.stream_of(q))
    kv_resident_attention.launches += 1
    kv_resident_attention.variant_launches[variant(q, k)] += 1
    return out


kv_resident_attention.launches = 0
kv_resident_attention.variant_launches = collections.Counter()
