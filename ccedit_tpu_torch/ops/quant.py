"""The opt-in W8A8 path (port of ``ccedit_tpu/ops/quant.py``): dynamic
symmetric int8 x int8 -> int32 products behind every ``QConv``/``QDense``
site of the UNet, ControlNet and VAE.  Inference only.

Turned on by ``set_quantized_matmul(True)``, ``CCEDIT_QUANT_MATMUL=1`` or the
umbrella ``CCEDIT_INT8=1`` (which also turns on the int8 QK^T attention,
``ops/attention.py``), read once, lazily, as in the JAX package.  A layer
takes this path only where its construction site says ``quant=True``
(``modules/layers.py``): the JAX package's ``QConv``/``QDense`` sites; the
plain ``nn.Conv``/``nn.Dense`` of the annotators, the text towers, LPIPS,
the discriminator, InceptionV3, ``unet_extras`` and ``TimeEmbed`` stay exact.

Numerics, the JAX package's step for step:

* the weight is cast to the activation's dtype first, then quantized;
* ``symmetric_q``: fp32, amax = max|x| over the axes, scale = amax / 127
  where amax > 0 (else 1), q = clip(round(x / scale), -127, 127), round half
  to even, true divisions;
* dense (``qlinear``): one scale per token (row), one per output column of
  the weight; conv (``qconv``, 1x1 included, 1-D as (k, 1) 2-D): one scale
  for the whole activation tensor, one per output channel of the weight;
* out = dtype(f32(acc) * sx * sw), then + bias in the activation's dtype.

Three kernels, each beside its plain version; a CPU tensor takes the plain
version (the only reason it does), a CUDA tensor launches the kernel or
raises:

* (8) ``quantize_int8`` (``csrc/quantize_int8.cu``): per-row or per-tensor
  amax and quantization into rows zero-padded to 16-byte multiples (the
  per-tensor amax stays on the device: no host sync); its fused norm form
  ``norm_silu_quantize``, the per-tensor int8 rows of silu(group_norm(x +
  add)) in front of each ResBlock conv, from the bf16 activation in two
  reads and no bf16 GroupNorm or SiLU output (``modules/layers.py``
  ``norm_silu_conv``, ``NormActConv``); the weights quantized once a
  version (``quantize_weight`` keeps them beside the parameter: they do not
  change during an edit);
* (9) ``gemm_dequant`` (``csrc/int8_gemm.cu``): the int8 product with its
  dequant + bias epilogue (a persistent TMA + wgmma GEMM, tiles from
  ``gemm_tiles``); ``gemm_dequant_bf16a``, its form on the bf16 activation,
  quantizes each token in shared memory with kernel 8's arithmetic, so
  ``qlinear`` launches kernel 8 only for the weight where ``gemm_route``
  says ``"fused"``;
* (10) ``conv_dequant`` (``csrc/int8_conv.cu``): an implicit-GEMM int8
  convolution on channels-last data (TMA im2col loads, s8 wgmma, tiles
  from ``conv_tiles``), the same epilogue.

Kernel 8's norm form (``group_norm``) is the port's GroupNorm on the card,
W8A8 or not: the fused form's statistics stage, then u written out in bf16
(channels-last), the statistics in fp32 as flax keeps them.

Under a clip shard of more than one rank (``parallel/shard.py``) every
per-tensor quantization takes the whole clip's amax: the local amax, then
``ClipShard.all_reduce_amax`` (a MAX over the ranks), then the quantize
pass, as GSPMD reduces the JAX package's ``_symmetric_q`` over the sharded
tensor; the fused norm form takes an image GroupNorm's statistics summed
over the ranks (its external-statistics form).  Per-token and per-row
scales need no collective.

The plain versions compute the int8 products exactly (float64 sums of
int8 products are integers below 2^53).  ``qlinear``, ``qconv`` and the
layers look the wrappers (``quantize_weight``, ``norm_silu_quantize`` and
``gemm_route`` too) up at each call, so a caller can swap in the plain
versions, a planted fault or the other route.  None of the kernels
replaces a Pallas kernel: the JAX package leaves these products to XLA.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import math
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from ..parallel.shard import active
from . import build

_STATE = {"matmul": None}


def set_quantized_matmul(enabled: bool) -> None:
    _STATE["matmul"] = bool(enabled)


def quantized_matmul_enabled() -> bool:
    if _STATE["matmul"] is None:
        _STATE["matmul"] = (os.environ.get("CCEDIT_QUANT_MATMUL", "") not in ("", "0")
                            or os.environ.get("CCEDIT_INT8", "") not in ("", "0"))
    return _STATE["matmul"]


def padded(n: int) -> int:
    """n rounded up to a whole number of 16-byte int8 vectors."""
    return -(-n // 16) * 16


def symmetric_q(x: torch.Tensor, dims: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q, scale) with x ~= q * scale, scale keeping the reduced dims as
    size 1 (``_symmetric_q``).  Every quotient is tensor by tensor: torch
    divides a CUDA tensor by a Python number as a product with its
    reciprocal, a last bit away from the true quotient."""
    xf = x.float()
    return _quantize_with(xf, xf.abs().amax(dim=tuple(dims), keepdim=True))


def _quantize_with(xf: torch.Tensor, amax: torch.Tensor):
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0), torch.ones_like(amax))
    q = (xf / scale).round_().clamp_(-127, 127).to(torch.int8)
    return q, scale


def _sharded():
    """The active clip shard where it has more than one rank, else None."""
    shard = active()
    return shard if shard is not None and shard.world > 1 else None


def clip_amax(amax: torch.Tensor) -> torch.Tensor:
    """A per-tensor fp32 amax made the whole clip's under a clip shard of
    more than one rank (``ClipShard.all_reduce_amax`` of its bits, in place);
    as it is otherwise."""
    shard = _sharded()
    if shard is not None:
        shard.all_reduce_amax(amax.view(torch.int32))
    return amax


def _exact_mm(a8: torch.Tensor, b8_t: torch.Tensor) -> torch.Tensor:
    """int8 (..., K) @ int8 (K, N) -> int32, exactly (float64 sums)."""
    return torch.matmul(a8.double(), b8_t.double()).to(torch.int32)


def int8_matmul(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The JAX ``int8_matmul`` with a torch (F, C) weight: x (..., C) @
    weight^T, per-token and per-column scales, fp32 out."""
    xq, sx = symmetric_q(x, (-1,))
    wq, sw = symmetric_q(weight, (1,))
    return _exact_mm(xq, wq.t()).float() * sx * sw[:, 0]


@dataclasses.dataclass(frozen=True)
class ConvGeometry:
    """A 2-D window: kernel (kh, kw), stride (sh, sw) and zero padding
    (top, bottom, left, right).  A 1-D conv over (N, L, C) is (k, 1)."""

    kh: int
    kw: int
    sh: int = 1
    sw: int = 1
    pt: int = 0
    pb: int = 0
    pl: int = 0
    pr: int = 0

    def out_hw(self, h: int, w: int) -> Tuple[int, int]:
        return ((h + self.pt + self.pb - self.kh) // self.sh + 1,
                (w + self.pl + self.pr - self.kw) // self.sw + 1)


def geometry(kernel: Sequence[int], stride: Sequence[int],
             padding: Sequence[Tuple[int, int]]) -> ConvGeometry:
    """The window of a 2-D ((kh, kw), (sh, sw), ((top, bottom), (left,
    right))) or 1-D ((k,), (s,), ((lo, hi),)) convolution."""
    if len(kernel) == 1:
        kernel, stride, padding = (kernel[0], 1), (stride[0], 1), (padding[0], (0, 0))
    (pt, pb), (pl, pr) = padding
    return ConvGeometry(kernel[0], kernel[1], stride[0], stride[1], pt, pb, pl, pr)


def plain_conv_acc(x8: torch.Tensor, w8: torch.Tensor, geom: ConvGeometry,
                   budget: int = 2 ** 31) -> torch.Tensor:
    """int8 (N, H, W, Cp) x int8 (O, kh * kw * Cp) (taps outer, channels
    inner) -> the int32 (N, Ho, Wo, O) accumulators: a float64 product a
    tap, summed exactly, over as many images at a time as ``budget`` bytes
    of float64 operands allow."""
    n, h, w, cp = x8.shape
    ho, wo = geom.out_hw(h, w)
    o = w8.shape[0]
    wt = w8.reshape(o, geom.kh, geom.kw, cp).double()
    xp = F.pad(x8, (0, 0, geom.pl, geom.pr, geom.pt, geom.pb))
    out = torch.empty((n, ho, wo, o), dtype=torch.int32, device=x8.device)
    step = max(1, budget // (8 * ho * wo * max(cp, o)))
    for b0 in range(0, n, step):
        xs = xp[b0:b0 + step]
        acc = torch.zeros((xs.shape[0], ho, wo, o), dtype=torch.float64, device=x8.device)
        for i in range(geom.kh):
            for j in range(geom.kw):
                patch = xs[:, i:i + geom.sh * (ho - 1) + 1:geom.sh,
                           j:j + geom.sw * (wo - 1) + 1:geom.sw]
                acc += torch.matmul(patch.double(), wt[:, i, j].t())
        out[b0:b0 + step] = acc.to(torch.int32)
    return out


def _to_2d(x: torch.Tensor, weight: torch.Tensor, stride, padding):
    """A channels-last (N, L, C) input and (O, I, k) weight as (N, L, 1, C)
    and (O, I, k, 1); 2-D ones as they are."""
    geom = geometry(weight.shape[2:], stride, padding)
    if x.dim() == 3:
        return x[:, :, None], weight[..., None], geom
    return x, weight, geom


def int8_conv(x: torch.Tensor, weight: torch.Tensor, stride: Sequence[int],
              padding: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """The JAX ``int8_conv`` with a torch (O, I, *k) weight on a
    channels-last x (N, *spatial, C): one scale for the whole activation,
    one per output channel, fp32 out (N, *spatial', O)."""
    xq, sx = symmetric_q(x, tuple(range(x.dim())))
    wq, sw = symmetric_q(weight, tuple(range(1, weight.dim())))
    x4, w4, geom = _to_2d(xq, wq, stride, padding)
    w_rows = w4.permute(0, 2, 3, 1).reshape(w4.shape[0], -1)
    acc = plain_conv_acc(x4, w_rows, geom)
    out = acc.float() * sx.reshape(()) * sw.reshape(-1)
    return out[:, :, 0] if x.dim() == 3 else out


# ---- kernel (8): the quantizer ----

def plain_quantize_int8(x: torch.Tensor, per_row: bool, groups: int = 1):
    """(q, scales) of a 2-D (R, G * L) tensor: ``symmetric_q`` over each row
    (``per_row``) or the whole tensor, q laid out (R, G * Lp), each group of
    L values zero-padded to Lp = ``padded(L)``; scales (R,) or (1,)."""
    rows, n = x.shape
    length = n // groups
    if per_row:
        q, scale = symmetric_q(x, (1,))
    else:  # the whole clip's amax under a clip shard
        xf = x.float()
        q, scale = _quantize_with(xf, clip_amax(xf.abs().amax().reshape(1, 1)))
    q = F.pad(q.reshape(rows, groups, length), (0, padded(length) - length))
    return q.reshape(rows, -1), scale.reshape(-1)


def quantize_int8(x: torch.Tensor, per_row: bool, groups: int = 1):
    """Kernel 8: ``plain_quantize_int8``'s function for a bf16 or fp32 2-D
    tensor.  A CPU tensor takes the plain version; a CUDA tensor launches
    ``csrc/quantize_int8.cu`` (per row: one warp a row, amax then quantize;
    per tensor: a grid-wide amax into a device word, then the quantize pass
    reading it; under a clip shard of more than one rank the word is
    all-reduced between the two) or raises."""
    if not x.is_cuda:
        return plain_quantize_int8(x, per_row, groups)
    if x.dtype not in (torch.bfloat16, torch.float32) or x.dim() != 2:
        raise ValueError(f"quantize_int8 takes a 2-D bf16 or fp32 tensor, got {x.dtype} "
                         f"{tuple(x.shape)}")
    rows, n = x.shape
    if rows <= 0 or n <= 0 or n % groups or (groups != 1 and not per_row):
        raise ValueError(f"quantize_int8: {rows}x{n} in {groups} groups (per_row={per_row})")
    x = x.contiguous()
    length = n // groups
    q = torch.empty((rows, groups * padded(length)), device=x.device, dtype=torch.int8)
    scales = torch.empty((rows if per_row else 1,), device=x.device, dtype=torch.float32)
    amax = torch.empty((1,), device=x.device, dtype=torch.int32)
    fp32, shard = int(x.dtype == torch.float32), None if per_row else _sharded()
    for stages in ((3,) if shard is None else (1, 2)):
        build.launch("ccedit_quantize_int8", fp32, int(per_row), stages, x.data_ptr(),
                     q.data_ptr(), scales.data_ptr(), amax.data_ptr(), rows, groups, length,
                     padded(length), build.stream_of(x))
        if stages == 1:  # the local amax, made the clip's
            shard.all_reduce_amax(amax)
    quantize_int8.launches += 1
    quantize_int8.variant_launches["rows" if per_row else "tensor" if shard is None
                                   else "tensor sharded"] += 1
    return q, scales


quantize_int8.launches = 0
quantize_int8.variant_launches = collections.Counter()


@dataclasses.dataclass(frozen=True)
class QuantizedActivation:
    """A conv input quantized per tensor: int8 rows ``q`` (N * spatial,
    Cp), the fp32 ``scale`` (1,), the input's channels-last ``shape`` (N,
    *spatial, C) and ``dtype``.  A ``QConv`` layer (``modules/layers.py``)
    takes it in place of the activation and skips its own quantization."""

    q: torch.Tensor
    scale: torch.Tensor
    shape: Tuple[int, ...]
    dtype: torch.dtype


def quantize_activation(x: torch.Tensor) -> QuantizedActivation:
    """A channels-last conv input (N, *spatial, C) quantized per tensor
    (kernel 8; the whole clip's scale under a clip shard)."""
    q, scale = quantize_int8(x.reshape(-1, x.shape[-1]), per_row=False)
    return QuantizedActivation(q, scale, tuple(x.shape), x.dtype)


def with_halo(qa: QuantizedActivation, shard, dim: int, before: int,
              after: int) -> QuantizedActivation:
    """``qa``, an (N, H, W, C) image's int8 rows, with ``before`` rows of the
    previous rank's block and ``after`` of the next rank's along ``dim`` (1
    or 2 of (N, H, W, C); zeros past the clip's edges: ``ClipShard.halo`` on
    the (N, H, W, Cp) int8 view).  The clip's one scale makes the
    neighbours' codes this rank's."""
    n, h, w = qa.shape[:3]
    q = shard.halo(qa.q.view(n, h, w, -1), dim, before, after)
    shape = list(qa.shape)
    shape[dim] = q.shape[dim]
    return QuantizedActivation(q.reshape(-1, q.shape[-1]), qa.scale, tuple(shape), qa.dtype)


def sample_addend(x: torch.Tensor, add: torch.Tensor) -> torch.Tensor:
    """(S, C) ``add`` as a broadcast over x's (S, ..., C)."""
    return add.reshape((add.shape[0],) + (1,) * (x.dim() - 2) + (add.shape[-1],))


def plain_norm_silu_quantize(x: torch.Tensor, norm, add: Optional[torch.Tensor] = None
                             ) -> QuantizedActivation:
    """The unfused chain: ``norm`` (a ``GroupNorm`` module) of x + add
    (``add`` (S, C), one value a sample and channel, or None), SiLU, then
    ``plain_quantize_int8`` over the whole tensor."""
    if add is not None:
        x = x + sample_addend(x, add)
    y = F.silu(norm(x))
    q, scale = plain_quantize_int8(y.reshape(-1, y.shape[-1]), per_row=False)
    return QuantizedActivation(q, scale, tuple(y.shape), y.dtype)


def _third_pass_counter(device) -> torch.Tensor:
    counter = _THIRD_PASSES.get(device)
    if counter is None:
        counter = _THIRD_PASSES[device] = torch.zeros((1,), dtype=torch.int32, device=device)
    return counter


_THIRD_PASSES = {}


def third_passes(device) -> int:
    """How many fused-form launches on ``device`` took their third pass (the
    amax over the tensor where the channels' extremes could not decide it);
    reading it waits for the device."""
    return int(_third_pass_counter(torch.device(device))[0])


def _norm_operands(name: str, x: torch.Tensor, norm, c_multiple: int):
    """x contiguous and 16-byte aligned, and the GroupNorm's (weight, bias,
    fp32 flag), checked for kernel 8's fused and norm forms."""
    s, c, g = x.shape[0], x.shape[-1], norm.num_groups
    if (x.dtype != torch.bfloat16 or x.dim() < 2 or x.numel() == 0 or c % c_multiple or c % g
            or c // g < 4 or c > 4096):
        raise ValueError(f"{name} takes a bf16 (S, ..., C) x with C <= 4096 a multiple of "
                         f"{c_multiple} and of the {g} groups, 4 channels a group or more; got "
                         f"{x.dtype} {tuple(x.shape)}")
    affine = [t for t in (norm.weight, norm.bias) if t is not None]
    if any(t.dtype != affine[0].dtype or t.dtype not in (torch.bfloat16, torch.float32)
           or t.device != x.device for t in affine):
        raise ValueError("the GroupNorm's weight and bias must be bf16 or fp32 on the input's "
                         "device")
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    weight, bias = (None if t is None else t.detach().contiguous() for t in (norm.weight,
                                                                            norm.bias))
    return x, weight, bias, int(bool(affine) and affine[0].dtype == torch.float32)


@functools.lru_cache(maxsize=256)
def _plan(s: int, p: int, c: int, g: int) -> Tuple[int, int]:
    plan = (ctypes.c_longlong * 2)()
    build.launch("ccedit_norm_quantize_plan", s, p, c, g, ctypes.addressof(plan))
    return plan[0], plan[1]


def _workspace(x: torch.Tensor, s: int, p: int, c: int, g: int):
    """Kernel 8's plan for (S, P, C) in G groups: (statistics block, the
    workspace tensor)."""
    threads, size = _plan(s, p, c, g)
    return threads, torch.empty((size,), device=x.device, dtype=torch.uint8)


def norm_silu_quantize(x: torch.Tensor, norm, add: Optional[torch.Tensor] = None,
                       faults: int = 0) -> QuantizedActivation:
    """Kernel 8's fused norm form: ``plain_norm_silu_quantize``'s function
    for a channels-last bf16 x (S, ..., C) whose samples are x's first axis
    (an image's frames, or a temporal GroupNorm's (h, b, w) rows), ``norm``
    a ``GroupNorm`` module.  A CPU tensor takes the plain version; a CUDA
    tensor launches ``csrc/quantize_int8.cu``'s fused form (the group
    statistics in torch's own order and the channels' extremes, then the
    quantize pass; a third pass only where the extremes cannot decide the
    amax) or raises: bit for bit the plain version on the card.

    Under a clip shard of more than one rank the kernel stops after the
    local amax, which ``ClipShard.all_reduce_amax`` makes the clip's, and
    then quantizes; where the norm's statistics span the ranks (an image
    GroupNorm under a spatial split) it takes them from outside: the scale
    and shift ``norm.sharded_affine`` makes of x + add from sums all-reduced
    over the ranks (the external-statistics form, variant ``external``).
    Its other launch variants say torch's block for the statistics: ``warp``
    (32 threads a (sample, group) of fewer than 512 values) or ``block``
    (512), ``sharded`` beside them when the amax was all-reduced.
    ``faults`` plants the checks' faults (1: each sample quantized with its
    own amax; 2: the statistics over the first half of each sample's
    positions).  The launch count stays on this function whatever replaces
    the module's name."""
    if not x.is_cuda:
        return plain_norm_silu_quantize(x, norm, add)
    s, c, g = x.shape[0], x.shape[-1], norm.num_groups
    x, weight, bias, affine_fp32 = _norm_operands("norm_silu_quantize", x, norm, 16)
    if add is not None and (add.dtype != x.dtype or tuple(add.shape) != (s, c)
                            or add.device != x.device):
        raise ValueError(f"the addend must be bf16 ({s}, {c}) on {x.device}, got {add.dtype} "
                         f"{tuple(add.shape)} on {add.device}")
    shard = _sharded()
    ext = None
    if shard is not None and norm.spans_shard(x, shard):
        if add is not None:  # the statistics are x + add's, rounded as the chain rounds it
            x, add = (x + sample_addend(x, add)).contiguous(), None
        ext = tuple(t.contiguous() for t in norm.sharded_affine(x, shard)[:2])
    if add is not None:
        add = add.contiguous()
        if add.data_ptr() % 16:
            add = add.clone()
    p = x.numel() // max(1, s * c)
    threads, workspace = _workspace(x, s, p, c, g)
    q = torch.empty((s * p, c), device=x.device, dtype=torch.int8)
    scale = torch.empty((1,), device=x.device, dtype=torch.float32)
    for stage in ((0,) if shard is None else (1, 2)):
        build.launch("ccedit_norm_silu_quantize", x.data_ptr(),
                     0 if add is None else add.data_ptr(),
                     0 if weight is None else weight.data_ptr(),
                     0 if bias is None else bias.data_ptr(), affine_fp32,
                     0 if ext is None else ext[0].data_ptr(),
                     0 if ext is None else ext[1].data_ptr(), s, p, c, g, float(norm.eps),
                     q.data_ptr(), scale.data_ptr(), workspace.data_ptr(),
                     _third_pass_counter(x.device).data_ptr(), faults, stage,
                     build.stream_of(x))
        if stage == 1:  # the local amax, words[3] of the workspace, made the clip's
            shard.all_reduce_amax(workspace[12:16].view(torch.int32))
    _NORM_SILU_QUANTIZE.launches += 1
    variant = "external" if ext is not None else "block" if threads == 512 else "warp"
    _NORM_SILU_QUANTIZE.variant_launches[variant + (" sharded" if shard else "")] += 1
    return QuantizedActivation(q, scale, tuple(x.shape), x.dtype)


_NORM_SILU_QUANTIZE = norm_silu_quantize  # keeps the count whatever replaces the name
norm_silu_quantize.launches = 0
norm_silu_quantize.variant_launches = collections.Counter()


def plain_group_norm(x: torch.Tensor, norm) -> torch.Tensor:
    """A ``GroupNorm`` module's function on a channels-last x (S, ..., C):
    torch's GroupNorm with the statistics and the affine map in fp32 (fp64
    for an fp64 x), the output rounded once to x's dtype, as flax's
    ``nn.GroupNorm(dtype=x.dtype)`` keeps them."""
    dtype = torch.promote_types(x.dtype, torch.float32)
    weight, bias = (None if t is None else t.to(dtype) for t in (norm.weight, norm.bias))
    y = F.group_norm(x.movedim(-1, 1).to(dtype), norm.num_groups, weight, bias, norm.eps)
    return y.movedim(1, -1).to(x.dtype)


def group_norm(x: torch.Tensor, norm) -> torch.Tensor:
    """Kernel 8's norm form: ``plain_group_norm``'s function for a
    channels-last bf16 x (S, ..., C), C <= 4096 a multiple of 8 and of the
    groups with 4 channels a group or more (the port's networks' every
    GroupNorm), ``norm`` a ``GroupNorm`` module.  A CPU tensor takes the
    plain version; a CUDA tensor launches ``csrc/quantize_int8.cu``'s norm
    form (the fused form's statistics stage in torch's fp32 order, then one
    pass writing bf16(k * x + b) channels-last: no channels-first copies) or
    raises."""
    if not x.is_cuda:
        return plain_group_norm(x, norm)
    shape, s, c, g = tuple(x.shape), x.shape[0], x.shape[-1], norm.num_groups
    x, weight, bias, affine_fp32 = _norm_operands("group_norm", x, norm, 8)
    p = x.numel() // (s * c)
    threads, workspace = _workspace(x, s, p, c, g)
    out = torch.empty(shape, device=x.device, dtype=x.dtype)
    build.launch("ccedit_group_norm", x.data_ptr(), 0 if weight is None else weight.data_ptr(),
                 0 if bias is None else bias.data_ptr(), affine_fp32, s, p, c, g,
                 float(norm.eps), out.data_ptr(), workspace.data_ptr(), build.stream_of(x))
    group_norm.launches += 1
    group_norm.variant_launches["block" if threads == 512 else "warp"] += 1
    return out


group_norm.launches = 0
group_norm.variant_launches = collections.Counter()


def _weight_rows(weight: torch.Tensor, dtype: torch.dtype):
    """A weight as the products read it: (O, taps * I), taps outer, input
    channels inner, cast to ``dtype``; and its taps."""
    o, i = weight.shape[:2]
    taps = math.prod(weight.shape[2:])
    rows = weight.detach().to(dtype).permute(0, *range(2, weight.dim()), 1).reshape(o, taps * i)
    return rows, taps


def plain_quantize_weight(weight: torch.Tensor, dtype: Optional[torch.dtype] = None):
    """``quantize_weight``'s function through ``plain_quantize_int8``, with no
    cache."""
    rows, taps = _weight_rows(weight, dtype or weight.dtype)
    return plain_quantize_int8(rows, True, taps)


_WEIGHTS = WeakIdKeyDictionary()  # weight -> (version key, (w8, sw))
WEIGHT_CACHE = collections.Counter()  # quantize_weight's "hits" and "misses"


def quantize_weight(weight: torch.Tensor, dtype: Optional[torch.dtype] = None):
    """A (O, I) Linear or (O, I, *k) conv weight cast to ``dtype`` (its own
    by default), then quantized per output channel in the products' K order:
    (O, taps * Ip), taps outer, input channels inner, each tap's channels
    zero-padded to Ip (``quantize_int8`` per row).

    Quantized once a version: the result stays beside the tensor, keyed on
    its ``_version`` (every in-place write bumps it: ``copy_``,
    ``load_state_dict``, a LoRA merge), storage pointer, dtype, device and
    shape, and is made again when any of them changes (``.to()`` of a
    module gives its parameters new storage).  ``WEIGHT_CACHE["hits"]`` and
    ``["misses"]`` count both outcomes.  An inference tensor has no version
    counter, so it is refused rather than cached."""
    dtype = dtype or weight.dtype
    if weight.is_inference():
        raise RuntimeError("quantize_weight cannot tell when an inference tensor (made under "
                           "torch.inference_mode()) changes: load the weights outside it")
    key = (weight._version, weight.data_ptr(), dtype, weight.device, tuple(weight.shape))
    entry = _WEIGHTS.get(weight)
    if entry is not None and entry[0] == key:
        WEIGHT_CACHE["hits"] += 1
        return entry[1]
    rows, taps = _weight_rows(weight, dtype)
    out = quantize_int8(rows, per_row=True, groups=taps)
    WEIGHT_CACHE["misses"] += 1
    _WEIGHTS[weight] = (key, out)
    return out


def plain_epilogue(acc: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor,
                   bias: Optional[torch.Tensor], dtype: Optional[torch.dtype]) -> torch.Tensor:
    """dtype(f32(acc) * sx * sw) + bias, sx broadcast against acc (a column
    of row scales or a scalar); ``dtype`` None returns the int32 acc."""
    if dtype is None:
        return acc
    y = (acc.float() * sx * sw).to(dtype)
    return y if bias is None else y + bias.to(dtype)


# ---- kernel (9): the dense product with its epilogue ----

_DENSE_BUDGET = 223 * 1024 - 1024  # the kernel's dynamic shared memory less its alignment slack
_BOX = 128 * 128  # a 128-row box of 128 bytes


def gemm_tiles(k: int, n: int) -> Tuple[int, int, int, int, int]:
    """Kernel 9's tile for activation rows of K values and N outputs: (BM,
    BN, resident, stages, fused), the choice of ``csrc/int8_gemm.cu``'s
    ``dense_tiles`` (which ``ccedit_int8_gemm_tiles`` reports).  BN is 256
    where N is a multiple of 256, 160 where it is a multiple of 160 (320,
    640), else 128; BM 128.  ``resident``: the block's BN x Kp weight slice
    stays in shared memory beside the bf16 staging and two A boxes (the
    grid then keeps each block on one n tile); ``stages``: the int8 form's
    ring of 128-row x 128-byte A boxes (with B's beside them unless
    resident), at most 8; ``fused``: ``gemm_dequant_bf16a`` takes (K, N),
    its whole bf16 tile (ceil(K / 64) boxes) fitting beside the resident
    slice and the staging."""
    bn = 256 if n % 256 == 0 else 160 if n % 160 == 0 else 128
    kc, xc = -(-k // 128), -(-k // 64)
    w_bytes, out_bytes = kc * bn * 128, 128 * bn * 2
    resident = w_bytes + out_bytes + 2 * _BOX <= _DENSE_BUDGET
    stage = _BOX + (0 if resident else bn * 128)
    stages = min(8, (_DENSE_BUDGET - out_bytes - (w_bytes if resident else 0)) // stage)
    fused = xc * _BOX + w_bytes + out_bytes <= _DENSE_BUDGET
    return 128, bn, int(resident), stages, int(fused)


def kernel_gemm_tiles(k: int, n: int) -> Tuple[int, int, int, int, int]:
    """The tile the built kernel takes for (K, N), as ``csrc/int8_gemm.cu``
    reports it (needs the CUDA build); equal to ``gemm_tiles(k, n)``."""
    tiles = (ctypes.c_int * 5)()
    build.launch("ccedit_int8_gemm_tiles", k, n, ctypes.addressof(tiles))
    return tuple(tiles)


def gemm_route(k: int, n: int, dtype: torch.dtype) -> str:
    """How ``qlinear`` computes a dense product of K inputs and N outputs:
    ``"fused"``, one launch of ``gemm_dequant_bf16a`` on the bf16 activation
    where its tile fits (``gemm_tiles(k, n)[4]``: K <= 384 on the 160-wide
    tiles, so at the level-0 widths, 320 -> 320, where it beats the two
    launches: ``PERF.md`` §6), else ``"two_launches"``, kernel 8 per token
    then ``gemm_dequant``.  Decided by the shape and dtype alone, the same
    on the CPU (where both routes compute the same plain function) and on
    the card."""
    if dtype == torch.bfloat16 and k % 8 == 0 and gemm_tiles(k, n)[4]:
        return "fused"
    return "two_launches"


_OUT_KINDS = {None: 0, torch.bfloat16: 1, torch.float32: 2}


def _out(shape, dtype, device):
    return torch.empty(shape, device=device, dtype=torch.int32 if dtype is None else dtype)


def plain_gemm_dequant(x8, sx, w8, sw, bias=None, dtype=torch.bfloat16):
    """x8 (M, Kp) @ w8 (N, Kp)^T exactly, then ``plain_epilogue`` with sx
    one scale a row of x8."""
    return plain_epilogue(_exact_mm(x8, w8.t()), sx[:, None], sw, bias, dtype)


def _check_int8(name: str, x: torch.Tensor, dim: int, device) -> None:
    if x.dtype != torch.int8 or x.dim() != dim or not x.is_contiguous() or x.device != device:
        raise ValueError(f"{name} must be a contiguous {dim}-D int8 tensor on {device}, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if x.shape[-1] % 16 or x.data_ptr() % 16:
        raise ValueError(f"{name}'s rows must be whole 16-byte vectors, 16-byte aligned; got "
                         f"{tuple(x.shape)}")


def _check_epilogue(sx, sw, bias, dtype, rows_sx: int, n: int, device) -> None:
    if dtype not in _OUT_KINDS:
        raise ValueError(f"the epilogue writes bf16, fp32 or the int32 accumulators, not {dtype}")
    for name, t, want in (("sx", sx, rows_sx), ("sw", sw, n)):
        if t is None and name == "sx":  # the fused form computes its own
            continue
        if t.dtype != torch.float32 or t.numel() != want or not t.is_contiguous() \
                or t.device != device:
            raise ValueError(f"{name} must be {want} contiguous fp32 values on {device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if dtype is not None and bias is not None and (
            bias.dtype != dtype or bias.numel() != n or not bias.is_contiguous()
            or bias.device != device):
        raise ValueError(f"bias must be {n} contiguous {dtype} values on {device}, got "
                         f"{bias.dtype} {tuple(bias.shape)}")


def gemm_dequant(x8, sx, w8, sw, bias=None, dtype=torch.bfloat16):
    """Kernel 9: ``plain_gemm_dequant``'s function.  A CPU tensor takes the
    plain version; a CUDA tensor launches ``csrc/int8_gemm.cu``'s
    dequantizing GEMM (a persistent TMA + s8 wgmma kernel on the tile
    ``gemm_tiles(Kp, N)``, torch's (N, K) weight being the K-major B^T it
    reads) or raises.  ``dtype`` None writes the raw int32 accumulators (a
    debug entry)."""
    if not x8.is_cuda:
        return plain_gemm_dequant(x8, sx, w8, sw, bias, dtype)
    _check_int8("x8", x8, 2, x8.device)
    _check_int8("w8", w8, 2, x8.device)
    (m, k), n = x8.shape, w8.shape[0]
    if w8.shape[1] != k or m <= 0 or n <= 0:
        raise ValueError(f"mismatched x8 {tuple(x8.shape)} and w8 {tuple(w8.shape)}")
    _check_epilogue(sx, sw, bias, dtype, m, n, x8.device)
    out = _out((m, n), dtype, x8.device)
    build.launch("ccedit_int8_gemm", _OUT_KINDS[dtype], x8.data_ptr(), w8.data_ptr(),
                 out.data_ptr(), sx.data_ptr(), sw.data_ptr(),
                 0 if bias is None or dtype is None else bias.data_ptr(), m, n, k,
                 build.stream_of(x8))
    gemm_dequant.launches += 1
    gemm_dequant.variant_launches[{None: "int32", torch.bfloat16: "bf16",
                                   torch.float32: "fp32"}[dtype]] += 1
    return out


gemm_dequant.launches = 0
gemm_dequant.variant_launches = collections.Counter()


def plain_gemm_dequant_bf16a(x, w8, sw, bias=None, dtype=torch.bfloat16, quantized=False):
    """``plain_quantize_int8`` per row, then ``plain_gemm_dequant``: x (M,
    K) @ w8 (N, Kp)^T in W8A8.  ``quantized`` also returns the int8 rows
    (M, Kp) and their scales (M,)."""
    x8, sx = plain_quantize_int8(x, True)
    out = plain_gemm_dequant(x8, sx, w8, sw, bias, dtype)
    return (out, x8, sx) if quantized else out


def gemm_dequant_bf16a(x, w8, sw, bias=None, dtype=torch.bfloat16, quantized=False,
                       faults=0):
    """Kernel 9 on the bf16 activation, kernel 8's per-token quantization
    folded into its load path: ``plain_gemm_dequant_bf16a``'s function.  A
    CPU tensor takes the plain version; a CUDA tensor launches
    ``csrc/int8_gemm.cu``'s fused form (the tile's bf16 rows by TMA,
    quantized in shared memory bit for bit as kernel 8 does, no int8 copy
    in device memory) where ``gemm_tiles(K, N)`` says it fits, or raises.
    ``quantized`` also returns the kernel's int8 rows and scales (written by
    it, for the checks); ``faults`` plants the checks' faults (1: one amax
    for 64 rows, 2: every row dequantized with its tile's first scale)."""
    if not x.is_cuda:
        return plain_gemm_dequant_bf16a(x, w8, sw, bias, dtype, quantized)
    if x.dtype != torch.bfloat16 or x.dim() != 2:
        raise ValueError(f"gemm_dequant_bf16a takes a 2-D bf16 x, got {x.dtype} "
                         f"{tuple(x.shape)}")
    _check_int8("w8", w8, 2, x.device)
    (m, k), n = x.shape, w8.shape[0]
    if k % 8 or w8.shape[1] != padded(k) or m <= 0 or n <= 0 or not gemm_tiles(k, n)[4]:
        raise ValueError(f"gemm_dequant_bf16a does not take x {tuple(x.shape)} with w8 "
                         f"{tuple(w8.shape)} (gemm_tiles: {gemm_tiles(k, n)})")
    _check_epilogue(None, sw, bias, dtype, m, n, x.device)
    if not x.is_contiguous() or x.data_ptr() % 16:  # TMA reads 16-byte aligned rows
        x = x.clone(memory_format=torch.contiguous_format)
    out = _out((m, n), dtype, x.device)
    q8 = torch.empty((m, padded(k)), device=x.device, dtype=torch.int8) if quantized else None
    sx = torch.empty((m,), device=x.device, dtype=torch.float32) if quantized else None
    build.launch("ccedit_int8_gemm_bf16a", _OUT_KINDS[dtype], x.data_ptr(), w8.data_ptr(),
                 out.data_ptr(), sw.data_ptr(),
                 0 if bias is None or dtype is None else bias.data_ptr(),
                 0 if q8 is None else q8.data_ptr(), 0 if sx is None else sx.data_ptr(),
                 faults, m, n, k, build.stream_of(x))
    gemm_dequant_bf16a.launches += 1
    gemm_dequant_bf16a.variant_launches[{None: "int32", torch.bfloat16: "bf16",
                                         torch.float32: "fp32"}[dtype]] += 1
    return (out, q8, sx) if quantized else out


gemm_dequant_bf16a.launches = 0
gemm_dequant_bf16a.variant_launches = collections.Counter()


# ---- kernel (10): the implicit-GEMM convolution ----

def plain_conv_dequant(x8, sx, w8, sw, bias, geom: ConvGeometry, dtype=torch.bfloat16):
    """int8 x8 (N, H, W, Cp) convolved with w8 (O, kh * kw * Cp) exactly
    (``plain_conv_acc``), then the epilogue with the one activation scale."""
    return plain_epilogue(plain_conv_acc(x8, w8, geom), sx.reshape(()), sw, bias, dtype)


def conv_tiles(cp: int, o: int) -> Tuple[int, int, int]:
    """Kernel 10's tile for Cp input bytes a pixel and O output channels:
    (BM output pixels, BN output channels, k-chunk bytes), the choice of
    ``csrc/int8_conv.cu``'s ``conv_tiles`` (which ``ccedit_int8_conv_tiles``
    reports).  The chunk is 128 bytes for Cp > 64 (a tail past Cp arrives as
    zeros), else 64 or 32; BN is the narrow 8, 16 or 32 for O <= 32 (256
    pixels), 160 where O is a multiple of 160 but not of 128 (320, 960:
    where 128-wide tiles would leave a part-empty last N tile; 192
    pixels), else 128 (256 pixels)."""
    chunk = 128 if cp > 64 else 64 if cp > 32 else 32
    if o <= 32:
        return 256, 8 if o <= 8 else 16 if o <= 16 else 32, chunk
    if o % 160 == 0 and o % 128:
        return 192, 160, chunk
    return 256, 128, chunk


def kernel_conv_tiles(cp: int, o: int) -> Tuple[int, int, int]:
    """The tile the built kernel takes for (Cp, O), as ``csrc/int8_conv.cu``
    reports it (needs the CUDA build); equal to ``conv_tiles(cp, o)``."""
    tiles = (ctypes.c_int * 3)()
    build.launch("ccedit_int8_conv_tiles", cp, o, ctypes.addressof(tiles))
    return tuple(tiles)


def conv_dequant(x8, sx, w8, sw, bias, geom: ConvGeometry, dtype=torch.bfloat16):
    """Kernel 10: ``plain_conv_dequant``'s function.  A CPU tensor takes the
    plain version; a CUDA tensor launches ``csrc/int8_conv.cu`` (a
    warp-specialised TMA + s8 wgmma implicit GEMM: the im2col rows by TMA
    in im2col mode, zero-filled at the padding, on the tile
    ``conv_tiles(Cp, O)``) or raises.  ``dtype`` None writes the raw int32
    accumulators."""
    if not x8.is_cuda:
        return plain_conv_dequant(x8, sx, w8, sw, bias, geom, dtype)
    _check_int8("x8", x8, 4, x8.device)
    _check_int8("w8", w8, 2, x8.device)
    n, h, w, cp = x8.shape
    o = w8.shape[0]
    ho, wo = geom.out_hw(h, w)
    if w8.shape[1] != geom.kh * geom.kw * cp or ho <= 0 or wo <= 0 or n <= 0:
        raise ValueError(f"conv_dequant: x8 {tuple(x8.shape)}, w8 {tuple(w8.shape)}, {geom}")
    _check_epilogue(sx, sw, bias, dtype, 1, o, x8.device)
    out = _out((n, ho, wo, o), dtype, x8.device)
    build.launch("ccedit_int8_conv", _OUT_KINDS[dtype], x8.data_ptr(), w8.data_ptr(),
                 out.data_ptr(), sx.data_ptr(), sw.data_ptr(),
                 0 if bias is None or dtype is None else bias.data_ptr(), n, h, w, cp, o,
                 geom.kh, geom.kw, geom.sh, geom.sw, geom.pt, geom.pl, ho, wo,
                 build.stream_of(x8))
    conv_dequant.launches += 1
    conv_dequant.variant_launches[f"{geom.kh}x{geom.kw} s{geom.sh}"] += 1
    return out


conv_dequant.launches = 0
conv_dequant.variant_launches = collections.Counter()


# ---- the layers' entry points ----

def qlinear(x: torch.Tensor, weight: torch.Tensor,
            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A ``QDense``: x (..., C) @ weight (F, C)^T + bias in W8A8, x's dtype
    out."""
    lead, c = x.shape[:-1], x.shape[-1]
    w8, sw = quantize_weight(weight, x.dtype)
    b = None if bias is None else bias.to(x.dtype)
    if gemm_route(c, w8.shape[0], x.dtype) == "fused":
        y = gemm_dequant_bf16a(x.reshape(-1, c), w8, sw, b, x.dtype)
    else:
        x8, sx = quantize_int8(x.reshape(-1, c), per_row=True)
        y = gemm_dequant(x8, sx, w8, sw, b, x.dtype)
    return y.reshape(*lead, y.shape[-1])


def qconv(x, weight: torch.Tensor, bias: Optional[torch.Tensor],
          stride: Sequence[int], padding: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """A ``QConv`` on channels-last x, (N, H, W, C) with a (O, I, kh, kw)
    weight or (N, L, C) with (O, I, k): W8A8 with one activation scale for
    the whole tensor, x's dtype out.  ``padding``: (lo, hi) a spatial dim.
    x may be a ``QuantizedActivation`` (kernel 8's fused norm form made
    it), whose int8 rows the conv reads as they are."""
    geom = geometry(weight.shape[2:], stride, padding)
    if isinstance(x, QuantizedActivation):
        x8, sx, shape, dtype = x.q, x.scale, x.shape, x.dtype
    else:
        shape, dtype = tuple(x.shape), x.dtype
        x8, sx = quantize_int8(x.reshape(-1, shape[-1]), per_row=False)
    one_d = weight.dim() == 3
    n, h, w = (shape[0], shape[1], 1) if one_d else shape[:3]
    w8, sw = quantize_weight(weight, dtype)
    y = conv_dequant(x8.view(n, h, w, -1), sx, w8, sw,
                     None if bias is None else bias.to(dtype), geom, dtype)
    return y[:, :, 0] if one_d else y


COUNTED = {"quantize_int8": quantize_int8, "norm_silu_quantize": norm_silu_quantize,
           "group_norm": group_norm, "int8_gemm_dequant": gemm_dequant,
           "int8_gemm_bf16a": gemm_dequant_bf16a, "int8_conv": conv_dequant}
