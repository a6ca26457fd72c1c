"""Scaled-dot-product attention with one dispatch point.

Port of ``ccedit_tpu/ops/attention.py::dot_product_attention``.  The route is
chosen by shape alone, before any launch, the same way on every device, and a
kernel gets only the head dims its module lists in ``HEAD_DIMS``:

* temporal kernel (2): n_q == n_k <= 32, B*H >= 2048, d % 8 == 0, d <= 256 —
  the pseudo-3D temporal attention at UNet levels 0-2;
* spatial kernel (1): n_q, n_k >= 512 and d in (40, 80, 160) — spatial
  self-attention at UNet/ControlNet levels 0 and 1 (and level 2 from 512
  tokens on), and the CFCA cross-frame attention (n_k = 2 * n_q);
* flash kernel (3): n_q, n_k >= 512 and d = 512 — the VAE encoder's and
  decoder's mid-block attention;
* plain math everywhere else, as the JAX package sends to XLA what its
  kernels refuse: the 77-token text cross-attention, spatial attention under
  512 tokens, the middle temporal attention (B*H < 2048) and head dims no
  kernel is instantiated for.

Each kernel wrapper then takes its plain version for a CPU tensor and
launches its kernel (or raises) for a CUDA tensor.  Every route is
differentiable: kernels 1 and 3 through autograd Functions whose backward is
kernel 4 (d 40/80/160 and d = 512), kernel 2 through the plain recompute, as
in the JAX package.

The int8 QK^T opt-in (``set_quantized_qk``, or ``CCEDIT_QUANT_QK=1``, or
the umbrella ``CCEDIT_INT8=1``, read once, lazily, as in the JAX package)
sends a spatial-route shape to kernel 1c exactly where the JAX dispatch
would quantize: where the JAX kernel's gate ``supported`` holds for k's
element size (``quantizes``).  Every other shape stays exact, among them
the port's own additions to kernel 1's route, head_dim 160 and n_q that is
not a multiple of 128.  The port has no W8A8 path (``ops/quant.py`` is not
ported), so ``CCEDIT_INT8`` turns on only the QK^T half, with a warning.
"""

from __future__ import annotations

import os
import warnings
from typing import Dict, Optional

import torch

from . import flash_attention as fa
from . import spatial_attention as sa
from . import temporal_attention as ta


def plain_attention(q, k, v, scale: float) -> torch.Tensor:
    """fp32 scores and softmax, probabilities in q's dtype
    (``_xla_attention``)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.matmul(p, v)


def attention_route(q, k) -> str:
    """'temporal' | 'spatial' | 'flash' | 'plain' for (B, H, N, D) q and k."""
    n_q, n_k, d = q.shape[-2], k.shape[-2], q.shape[-1]
    if (n_q == n_k and n_q <= ta.MAX_T and q.shape[0] * q.shape[1] >= 2048
            and d in ta.HEAD_DIMS):
        return "temporal"
    if n_q >= 512 and n_k >= 512:
        if d in sa.HEAD_DIMS:
            return "spatial"
        if d in fa.HEAD_DIMS:
            return "flash"
    return "plain"


_QUANT = {"qk": None}


def set_quantized_qk(enabled: bool) -> None:
    _QUANT["qk"] = bool(enabled)


def quantized_qk_enabled() -> bool:
    if _QUANT["qk"] is None:
        qk = os.environ.get("CCEDIT_QUANT_QK", "") not in ("", "0")
        umbrella = os.environ.get("CCEDIT_INT8", "") not in ("", "0")
        if umbrella:
            warnings.warn("CCEDIT_INT8: the port has no W8A8 convolution/matmul path "
                          "(ops/quant.py is not ported); only the int8 QK^T attention "
                          "is turned on", stacklevel=2)
        _QUANT["qk"] = qk or umbrella
    return _QUANT["qk"]


def quantizes(q, k) -> bool:
    """Whether the switch sends this attention to kernel 1c: the spatial
    route, and the JAX kernel's gate at k's element size."""
    return (quantized_qk_enabled() and attention_route(q, k) == "spatial"
            and sa.supported(q.shape[-2], k.shape[-2], q.shape[-1], k.element_size()))


def _spatial(q, k, v, scale: float) -> torch.Tensor:
    return sa.kv_resident_attention(q, k, v, scale, quantized_qk=quantizes(q, k))


_ROUTES = {
    "temporal": ta.small_seq_attention,
    "spatial": _spatial,
    "flash": fa.flash_attention,
    "plain": plain_attention,
}


def dot_product_attention(q, k, v, scale: Optional[float] = None) -> torch.Tensor:
    """Multi-head SDPA over (B, H, N, D) tensors; scale defaults to D**-0.5."""
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    return _ROUTES[attention_route(q, k)](q, k, v, scale)


_COUNTED = {"spatial_attention": sa.kv_resident_attention,
            "spatial_attention_bwd": sa.spatial_attention_bwd,
            "temporal_attention": ta.small_seq_attention,
            "flash_attention": fa.flash_attention,
            "flash_attention_bwd": fa.flash_attention_bwd}


def reset_launch_counts() -> None:
    for wrapper in _COUNTED.values():
        wrapper.launches = 0
        if hasattr(wrapper, "variant_launches"):
            wrapper.variant_launches.clear()


def launch_counts() -> Dict[str, int]:
    """Every kernel's launch count, and kernels 1, 3 and 4 by variant
    (``spatial_attention[d40 n_k!=n_q]``, ``spatial_attention[int8 d40 n_k=n_q]``
    for kernel 1c, ``spatial_attention_bwd[d80 n_k=n_q]``, ``flash_attention[lse]``
    for kernel 3 with its log-sum-exp, ...)."""
    out = {name: wrapper.launches for name, wrapper in _COUNTED.items()}
    for name, wrapper in _COUNTED.items():
        for var, n in sorted(getattr(wrapper, "variant_launches", {}).items()):
            out[f"{name}[{var}]"] = n
    return out
