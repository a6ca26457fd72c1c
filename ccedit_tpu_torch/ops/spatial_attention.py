"""Kernel 1: spatial attention (head_dim 40 / 80 / 160, any n_k), its int8
QK^T variant, kernel 1c (head_dim 40 / 80), and its backward, kernel 4 —
wrappers, plain versions and launch counts.

Port of ``ccedit_tpu/ops/spatial_attention.py::kv_resident_attention``, both
its one-chunk branch (self-attention, n_k = n_q) and its multi-chunk branch
(the CFCA cross-frame attention, n_k = 2 * n_q), and of the stock Pallas
flash-attention backward that ``ccedit_tpu/ops/attention.py::
_xla_attention_bwd`` runs at kernel 1's shapes.  The CUDA sources, with
their design notes, are ``csrc/spatial_attention.cu`` (kernel 1: TMA,
wgmma, warp-specialised for Hopper), ``csrc/spatial_attention_int8.cu``
(kernel 1c) and ``csrc/spatial_attention_bwd.cu``.  When autograd needs
the attention's gradient, ``kv_resident_attention`` goes through
``SpatialAttention``: its
forward launches kernel 1 with the row log-sum-exp saved, its backward
launches kernel 4; on the CPU both are the plain versions.  ``launches``
counts every launch of a wrapper; ``variant_launches`` splits them by
``variant(q, k)`` (``int8 `` before it for kernel 1c).

``quantized_qk=True`` is the JAX function's int8 path: ``quantize_qk``, the
JAX pre-pass bit for bit (plain torch, as JAX leaves it to XLA), quantizes q
and k per (batch, head); kernel 1c computes int32 QK^T and the fp32 softmax
with the dequant factor folded into each (batch, head)'s logits scale, which
stays on the device.  ``supported`` is the port's copy of the JAX gate that
decides where the JAX package runs its Pallas kernel, and so where it
quantizes (``ops/attention.py::quantizes``).  The int8 path has no gradient.
"""

from __future__ import annotations

import collections
import math

import torch

from . import build

HEAD_DIMS = (40, 80, 160)
INT8_HEAD_DIMS = (40, 80)  # the JAX gate quantizes only d <= 128
_LOG2E = 1.0 / math.log(2.0)  # exp(x) == exp2(x * log2(e))

# the JAX kernel's VMEM budget (ccedit_tpu/ops/spatial_attention.py:50-56,
# 139-166): a single score chunk up to 6144 keys, else chunks of 3072
_MAX_CHUNK = 6144
_MULTI_CHUNK = 3072


def _n_chunks(n_k: int) -> int:
    return 1 if n_k <= _MAX_CHUNK else -(-n_k // _MULTI_CHUNK)


def _pick_qb(n_q: int, n_k: int) -> int:
    n_chunks = _n_chunks(n_k)
    chunk = max(1, n_k // n_chunks)
    budget = (12.6e6 if n_chunks == 1 else 6.3e6) / 4 / chunk
    for qb in (512, 256, 128):
        if n_q % qb == 0 and qb <= budget:
            return qb
    return 0


def supported(n_q: int, n_k: int, d: int, *, itemsize: int) -> bool:
    """The JAX package's gate for its Pallas kernel (``supported`` there),
    with ``itemsize`` k's element size in bytes: where it holds, the JAX
    dispatch runs the kernel, and with the int8 switch on, quantizes.
    ``itemsize`` has no default (the JAX gate's bf16 default would size an
    fp32 k's VMEM at half its bytes)."""
    n_chunks = _n_chunks(n_k)
    return (n_q >= 512 and d % 8 == 0 and d <= 128 and n_k % n_chunks == 0
            and (n_k // n_chunks) % 128 == 0 and n_k * d * 2 * itemsize <= 4.0e6
            and _pick_qb(n_q, n_k) > 0)


def int8_width(d: int) -> int:
    """Kernel 1c's int8 row width: head_dim rounded up to whole 16-byte rows."""
    return -(-d // 16) * 16


def quantize_qk(q, k, scale: float):
    """The JAX int8 pre-pass (``kv_resident_attention`` :190-201) in the
    same order of fp32 operations: per-(batch, head) amax over (N, D),
    floored at 1e-6; x8 = clip(round(x * (127 / amax)), -127, 127) with
    round-half-even; the folded logits scale scale * (aq * ak) / 127^2.
    Returns q8, k8 (int8, q's and k's shapes) and the scales, fp32
    (B * H,)."""
    (q8, aq), (k8, ak) = _quantize(q), _quantize(k)
    folded = scale * (aq * ak)
    scales = folded / torch.full_like(folded, 127.0 * 127.0)
    return q8, k8, scales.reshape(-1)


def _quantize(x):
    """One operand of ``quantize_qk``: (x8, amax).  The amax is exact in x's
    own dtype; x's product with the fp32 factor is computed in fp32.  The
    divisions are true ones, tensor by tensor: ``127.0 / amax`` is torch's
    reciprocal times 127, and a CUDA tensor over a scalar its product with
    the scalar's reciprocal, a last bit away from JAX's quotients (ties
    would round apart).  ``full_like`` fills on the device: a tensor made
    from a host scalar is a copy that synchronises the stream."""
    amax = x.abs().amax(dim=(2, 3)).float().clamp_min(1e-6)
    x8 = torch.mul(x, (torch.full_like(amax, 127.0) / amax)[..., None, None])
    return x8.round_().clamp_(-127, 127).to(torch.int8), amax


def plain_spatial_attention(q, k, v, scale: float) -> torch.Tensor:
    """Matmul + fp32 softmax; probabilities cast to v's dtype for P.V, as the
    TPU kernel does."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p, v).to(q.dtype)


def plain_spatial_attention_int8(q, k, v, scale: float) -> torch.Tensor:
    """Kernel 1c's plain version: ``quantize_qk``, the integer scores in fp32
    (exact: |S| <= 127^2 * 80 < 2^24) times each (batch, head)'s folded
    scale, fp32 softmax, probabilities in v's dtype for P.V; q's dtype out."""
    q8, k8, scales = quantize_qk(q, k, scale)
    s = torch.matmul(q8.float(), k8.float().transpose(-1, -2))
    s = s * scales.reshape(q.shape[0], q.shape[1], 1, 1)
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


def _forward_int8(q, k, v, scale: float) -> torch.Tensor:
    """Quantize q and k (``quantize_qk``, zero-padded to ``int8_width``
    columns where head_dim is not a whole 16 bytes) and launch kernel 1c."""
    b, h, n_q, d = q.shape
    q8, k8, scales = quantize_qk(q, k, scale)
    pad = int8_width(d) - d
    if pad:
        q8, k8 = (torch.nn.functional.pad(x, (0, pad)) for x in (q8, k8))
    out = torch.empty_like(q)
    strides = build.int8_attention_operand_strides(q8, k8, v, out, INT8_HEAD_DIMS)
    build.launch("ccedit_spatial_attention_int8", q8.data_ptr(), k8.data_ptr(),
                 v.data_ptr(), out.data_ptr(), scales.data_ptr(), b, h, n_q, k.shape[2], d,
                 strides, build.stream_of(q))
    kv_resident_attention.launches += 1
    kv_resident_attention.variant_launches["int8 " + variant(q, k)] += 1
    return out


def spatial_attention_bwd(q, k, v, out, do, lse, scale: float):
    """Kernel 4: dq, dk, dv of kernel 1's attention from its inputs, its
    output, the output's gradient ``do`` and kernel 1's ``lse``.  A CPU
    tensor takes the plain version (which recomputes from q, k, v); a CUDA
    tensor launches the kernel or raises."""
    if not q.is_cuda:
        return plain_spatial_attention_bwd(q, k, v, do, scale)
    grads = launch_backward("ccedit_spatial_attention_bwd", HEAD_DIMS, q, k, v, out, do,
                            lse, scale)
    spatial_attention_bwd.launches += 1
    spatial_attention_bwd.variant_launches[variant(q, k)] += 1
    return grads


def launch_backward(entry: str, head_dims, q, k, v, out, do, lse, scale: float):
    """Launch a flash backward C entry (kernel 4: ``entry`` is
    ``ccedit_spatial_attention_bwd`` or, at d = 512,
    ``ccedit_flash_attention_bwd``) on CUDA tensors; returns dq, dk, dv."""
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
    strides = build.attention_operand_strides(q, k, v, do, head_dims, dq=dq, dk=dk, dv=dv)
    build.launch(entry, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), b, h, n_q, k.shape[2], d, strides, float(scale) * _LOG2E,
                 float(scale), build.stream_of(q))
    return dq, dk, dv


def attention_function(name: str, forward, plain, backward) -> type:
    """An autograd Function over (q, k, v, scale) named ``name``.  On a CUDA
    tensor its forward is ``forward(q, k, v, scale, lse)``, a kernel that
    also writes each row's log-sum-exp, and its backward is the kernel-4
    wrapper ``backward(q, k, v, out, do, lse, scale)``; on the CPU they are
    ``plain`` and the wrapper's plain version.  ``SpatialAttention`` (kernel
    1) and ``flash_attention.FlashAttention`` (kernel 3) are built here."""

    class Function(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, scale):
            if q.is_cuda:
                b, h, n_q, _ = q.shape
                lse = torch.empty((b * h, n_q), device=q.device, dtype=torch.float32)
                out = forward(q, k, v, scale, lse)
            else:
                lse, out = None, plain(q, k, v, scale)
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.scale = scale
            return out

        @staticmethod
        def backward(ctx, do):
            q, k, v, out, lse = ctx.saved_tensors
            return (*backward(q, k, v, out, do, lse, ctx.scale), None)

    Function.__name__ = Function.__qualname__ = name
    return Function


# kernel 1 forward, kernel 4 backward (plain versions on the CPU)
SpatialAttention = attention_function("SpatialAttention", _forward, plain_spatial_attention,
                                      spatial_attention_bwd)


def kv_resident_attention(q, k, v, scale: float, quantized_qk: bool = False) -> torch.Tensor:
    """Exact attention over (B, H, N, D), or with ``quantized_qk`` the int8
    QK^T attention (kernel 1c).  A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel or raises.  The exact path is
    differentiable: when autograd needs the gradient, it goes through
    ``SpatialAttention``.  The int8 path raises there instead: kernel 4
    needs the exact log-sum-exp, and the JAX package's trainer refuses the
    mode too."""
    if quantized_qk:
        if build.needs_grad(q, k, v):
            raise RuntimeError("the int8 QK^T attention has no gradient: turn it off "
                               "(set_quantized_qk(False), unset CCEDIT_QUANT_QK/CCEDIT_INT8) "
                               "to train")
        if not q.is_cuda:
            return plain_spatial_attention_int8(q, k, v, scale)
        return _forward_int8(q, k, v, scale)
    if build.needs_grad(q, k, v):
        return SpatialAttention.apply(q, k, v, scale)
    if not q.is_cuda:
        return plain_spatial_attention(q, k, v, scale)
    return _forward(q, k, v, scale)


kv_resident_attention.launches = 0
kv_resident_attention.variant_launches = collections.Counter()
spatial_attention_bwd.launches = 0
spatial_attention_bwd.variant_launches = collections.Counter()
