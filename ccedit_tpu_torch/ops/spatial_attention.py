"""Kernel 1: spatial attention (head_dim 40 / 80 / 160, any n_k), and its
backward, kernel 4 — wrappers, plain versions and launch counts.

Port of ``ccedit_tpu/ops/spatial_attention.py::kv_resident_attention``, both
its one-chunk branch (self-attention, n_k = n_q) and its multi-chunk branch
(the CFCA cross-frame attention, n_k = 2 * n_q), and of the stock Pallas
flash-attention backward that ``ccedit_tpu/ops/attention.py::
_xla_attention_bwd`` runs at kernel 1's shapes.  The CUDA sources, with
their design notes, are ``csrc/spatial_attention.cu`` and
``csrc/spatial_attention_bwd.cu``.  When autograd needs the attention's
gradient, ``kv_resident_attention`` goes through ``SpatialAttention``: its
forward launches kernel 1 with the row log-sum-exp saved, its backward
launches kernel 4; on the CPU both are the plain versions.  ``launches``
counts every launch of a wrapper; ``variant_launches`` splits them by
``variant(q, k)``.
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


def plain_spatial_attention_bwd(q, k, v, do, scale: float):
    """dq, dk, dv of softmax(scale * q k^T) v in closed form, in fp32 (cast
    to the inputs' dtypes): P = softmax(S), dV = P^T dO, dP = dO V^T,
    dS = P * (dP - rowsum(dP * P)), dQ = scale dS K, dK = scale dS^T Q."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    p = torch.softmax(torch.matmul(qf, kf.transpose(-1, -2)) * scale, dim=-1)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def variant(q, k) -> str:
    """The launch's variant: head dim and whether n_k == n_q."""
    return f"d{q.shape[-1]} " + ("n_k=n_q" if k.shape[-2] == q.shape[-2] else "n_k!=n_q")


def _forward(q, k, v, scale: float, lse=None) -> torch.Tensor:
    """Launch kernel 1; with ``lse``, a (B*H, n_q) fp32 tensor, it also
    writes each row's log2-domain log-sum-exp there."""
    out = torch.empty_like(q)
    strides = build.attention_operand_strides(q, k, v, out, HEAD_DIMS)
    b, h, n_q, d = q.shape
    build.launch("ccedit_spatial_attention", q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), out.data_ptr(), None if lse is None else lse.data_ptr(),
                 b, h, n_q, k.shape[2], d, strides, float(scale) * _LOG2E,
                 build.stream_of(q))
    kv_resident_attention.launches += 1
    kv_resident_attention.variant_launches[variant(q, k)] += 1
    return out


def spatial_attention_bwd(q, k, v, out, do, lse, scale: float):
    """Kernel 4: dq, dk, dv of kernel 1's attention from its inputs, its
    output, the output's gradient ``do`` and kernel 1's ``lse``.  A CPU
    tensor takes the plain version (which recomputes from q, k, v); a CUDA
    tensor launches the kernel or raises."""
    if not q.is_cuda:
        return plain_spatial_attention_bwd(q, k, v, do, scale)
    do = do.to(q.dtype)
    if do.stride(-1) != 1 or any(s % 8 for s in do.stride()[:3]) or do.data_ptr() % 16:
        do = do.contiguous()
    b, h, n_q, d = q.shape
    if lse.shape != (b * h, n_q) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous fp32 {(b * h, n_q)}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    # delta = rowsum(dO * O) in fp32, outside the kernels (as the stock
    # Pallas backward computes its `di`)
    delta = (do.float() * out.float()).sum(-1).reshape(b * h, n_q)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    strides = build.attention_operand_strides(q, k, v, do, HEAD_DIMS, dq=dq, dk=dk, dv=dv)
    build.launch("ccedit_spatial_attention_bwd", q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, n_q, k.shape[2], d,
                 strides, float(scale) * _LOG2E, float(scale), build.stream_of(q))
    spatial_attention_bwd.launches += 1
    spatial_attention_bwd.variant_launches[variant(q, k)] += 1
    return dq, dk, dv


class SpatialAttention(torch.autograd.Function):
    """Kernel 1 forward, kernel 4 backward (plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        if q.is_cuda:
            b, h, n_q, _ = q.shape
            lse = torch.empty((b * h, n_q), device=q.device, dtype=torch.float32)
            out = _forward(q, k, v, scale, lse)
        else:
            lse, out = None, plain_spatial_attention(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        return (*spatial_attention_bwd(q, k, v, out, do, lse, ctx.scale), None)


def kv_resident_attention(q, k, v, scale: float) -> torch.Tensor:
    """Exact attention over (B, H, N, D).  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises.  Differentiable:
    when autograd needs the gradient, it goes through ``SpatialAttention``."""
    if build.needs_grad(q, k, v):
        return SpatialAttention.apply(q, k, v, scale)
    if not q.is_cuda:
        return plain_spatial_attention(q, k, v, scale)
    return _forward(q, k, v, scale)


kv_resident_attention.launches = 0
kv_resident_attention.variant_launches = collections.Counter()
spatial_attention_bwd.launches = 0
spatial_attention_bwd.variant_launches = collections.Counter()
