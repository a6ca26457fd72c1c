"""Kernel 8's fused norm form beside the chain it replaces, part by part, on
one GPU.

    python -m ccedit_tpu_torch.scripts.norm_quant_breakdown [--iters N] [--no_row]

(1) At each shape of ``SHAPES`` (GroupNorm -> SiLU -> ``QConv`` inputs of
the full-width TV2V network and the VAE decoder, bf16, random data and
affine parameters from a seed) it times with CUDA events, after a warm-up,
the parts of the chain the W8A8 path ran before the fused form: the
embedding add where the chain has one; the ``GroupNorm`` module
(``F.group_norm`` on a channels-first view of channels-last memory);
``F.group_norm`` alone on channels-first memory and the copy into it (the
module's layout copies are the difference); the SiLU; the reshape of the
SiLU's output into rows (a copy where it is not channels-last); kernel 8's
per-tensor launch; the whole chain; and the fused form
(``quant.norm_silu_quantize``) and its plain version.  One profiled run of
the chain and of the fused form lists their kernels with their device
times (kernel 8's amax and quantize kernels apart).  Beside them: the bound
(``roofline.norm_quantize_bound``) and how far the fused form's int8 rows
are from the chain's (scale, codes differing, largest code difference),
and the share of the GroupNorm module's bf16 outputs that differ from a
GroupNorm with fp32 statistics (torch's CUDA kernel keeps a bf16 input's
mean and rstd in bf16; the JAX package's GroupNorm keeps them in fp32).

(2) One CFG-doubled W8A8 network row of the full-width TV2V engine (2 x 17
x 64 x 96 latents, a 512x768 hint): how many weight quantizations a row
makes without the weight cache, their summed device time (a profiled
run: the weights' permute copies and kernel 8's per-row launches), the
CUDA-event time of the loop and the host time of its launches; then the row's device time (CUDA events) and host time
(its enqueue) four ways in turns (A B C D D C B A): the route without the
fused form and the cache (the unfused chain, weights quantized at every
call), the fused form alone, the cache alone, both; the fused route's
launch counts; and a profiled row of the final route (device seconds by
group).

One JSON line with the card's name and power limit.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from ..ops import quant
from . import roofline

# (label, x shape (S, ..., C), with the ResBlock's embedding add, GroupNorm eps)
SHAPES = (
    ("level-0 image (out_layers, + embedding)", (34, 64, 96, 320), True, 1e-5),
    ("level-0 image 640 (decoder in_layers)", (34, 64, 96, 640), False, 1e-5),
    ("level-0 temporal", (12288, 17, 320), False, 1e-5),
    ("level-1 image", (34, 32, 48, 640), False, 1e-5),
    ("VAE decoder full resolution", (17, 512, 768, 128), False, 1e-6),
)
OUT = Path("build/norm_quant_breakdown")


def operands(shape, add: bool, eps: float, gen, device):
    """bf16 x ~ N(0, 1), a GroupNorm(32) with weight 1 + 0.1 N(0, 1) and bias
    0.1 N(0, 1) in bf16, and an (S, C) addend ~ 0.5 N(0, 1) or None."""
    from ..modules.layers import GroupNorm

    c = shape[-1]
    norm = GroupNorm(32, c, eps=eps, temporal=len(shape) == 3).to(device, torch.bfloat16)
    with torch.no_grad():
        norm.weight.copy_(1 + 0.1 * torch.randn((c,), generator=gen, device=device))
        norm.bias.copy_(0.1 * torch.randn((c,), generator=gen, device=device))
    x = torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
    a = (0.5 * torch.randn((shape[0], c), generator=gen, device=device)).to(torch.bfloat16) \
        if add else None
    return x, norm, a


def unfused(x, norm, add=None):
    """The chain before the fused form: the add, the GroupNorm module, the
    SiLU, rows, kernel 8 per tensor."""
    if add is not None:
        x = x + quant.sample_addend(x, add)
    y = F.silu(norm(x))
    return quant.quantize_int8(y.reshape(-1, y.shape[-1]), per_row=False)


def compare(q, scale, ref_q, ref_scale) -> dict:
    """The fused form's int8 rows against the chain's: the scale's relative
    difference, the share of codes differing, the largest code difference."""
    diff = (q.to(torch.int16) - ref_q.to(torch.int16)).abs()
    return dict(scale_rel=abs(scale.item() - ref_scale.item()) / ref_scale.item(),
                codes_differing=diff.count_nonzero().item() / diff.numel(),
                max_code_diff=int(diff.max().item()))


def kernel_ms(fn, out: Path, iters: int = 3) -> dict:
    """Device ms of each kernel (memcpy, memset) a call of ``fn`` runs, from a
    profiled run of ``iters`` calls."""
    from ..cli.profile_tv2v import _profile

    prof = _profile(lambda: [fn() for _ in range(iters)], out)
    return {k: 1e3 * v / iters for k, v in prof["top_kernels_seconds"].items()}


def chain_parts(label, shape, add: bool, eps: float, iters: int, gen, device) -> dict:
    x, norm, a = operands(shape, add, eps, gen, device)
    c = shape[-1]
    t = roofline.cuda_time_ms
    xa = x + quant.sample_addend(x, a) if add else x
    y = norm(xa)
    z = F.silu(y)
    xcf = xa.movedim(-1, 1).contiguous()
    parts = {
        "add": t(lambda: x + quant.sample_addend(x, a), iters) if add else 0.0,
        "group_norm_module": t(lambda: norm(xa), iters),
        "group_norm_alone": t(lambda: F.group_norm(xcf, 32, norm.weight, norm.bias, eps), iters),
        "copy_to_channels_first": t(lambda: xa.movedim(-1, 1).contiguous(), iters),
        "silu": t(lambda: F.silu(y), iters),
        "rows": t(lambda: z.reshape(-1, c), iters),
        "rows_is_copy": not z.is_contiguous(),
        "kernel8_per_tensor": t(lambda: quant.quantize_int8(z.reshape(-1, c), per_row=False),
                                iters),
    }
    del y, z, xcf, xa
    chain_ms = t(lambda: unfused(x, norm, a), iters)
    fused_ms = t(lambda: quant.norm_silu_quantize(x, norm, a), iters)
    plain_ms = t(lambda: quant.plain_norm_silu_quantize(x, norm, a), 1)
    # torch's CUDA GroupNorm keeps a bf16 input's mean and rstd in bf16; the
    # share of its outputs one rounding away from fp32 statistics' (the JAX
    # package's GroupNorm)
    xa = x if a is None else x + quant.sample_addend(x, a)
    y32 = F.group_norm(xa.movedim(-1, 1).float(), 32, norm.weight.float(), norm.bias.float(), eps)
    fp32_stats_differing = (y32.to(torch.bfloat16).movedim(1, -1) != norm(xa)).float().mean().item()
    del xa, y32
    ref_q, ref_scale = unfused(x, norm, a)
    fused = quant.norm_silu_quantize(x, norm, a)
    agreement = compare(fused.q, fused.scale, ref_q, ref_scale)
    del ref_q, ref_scale, fused
    slug = "".join(ch if ch.isalnum() else "_" for ch in label)[:40]
    chain_kernels = kernel_ms(lambda: unfused(x, norm, a), OUT / f"chain_{slug}")
    fused_kernels = kernel_ms(lambda: quant.norm_silu_quantize(x, norm, a), OUT / f"fused_{slug}")
    bound = roofline.norm_quantize_bound(shape, add)
    res = dict(label=label, shape=list(shape), add=add, parts_ms=parts, chain_ms=chain_ms,
               fused_ms=fused_ms, plain_ms=plain_ms, fused_share_of_bound=bound["bound_ms"]
               / fused_ms, chain_kernels_ms=chain_kernels, fused_kernels_ms=fused_kernels,
               agreement_with_chain=agreement,
               fp32_stats_outputs_differing=fp32_stats_differing, **bound)
    print(f"[norm_quant] {label} {shape}: chain {chain_ms:.4f} ms ({parts}), fused "
          f"{fused_ms:.4f} ms (bound {bound['bound_ms']:.4f} ms, "
          f"{100 * bound['bound_ms'] / fused_ms:.1f} %), plain {plain_ms:.4f} ms; {agreement}",
          flush=True)
    del x, norm, a
    torch.cuda.empty_cache()
    return res


def uncached_weight(weight, dtype=None):
    """``quant.quantize_weight`` without its cache: the route before it."""
    rows, taps = quant._weight_rows(weight, dtype or weight.dtype)
    return quant.quantize_int8(rows, per_row=True, groups=taps)


@contextlib.contextmanager
def route(fused: bool, cached: bool):
    """The W8A8 layers with or without the fused norm form and the weight
    cache (``quant`` looks both names up at each call)."""
    saved = quant.norm_silu_quantize, quant.quantize_weight
    if not fused:  # the conv then quantizes the bf16 SiLU output itself (kernel 8 per tensor)
        quant.norm_silu_quantize = lambda x, norm, add=None: F.silu(norm(
            x if add is None else x + quant.sample_addend(x, add)))
    if not cached:
        quant.quantize_weight = uncached_weight
    try:
        yield
    finally:
        quant.norm_silu_quantize, quant.quantize_weight = saved


def network_row(iters: int, seed: int, device) -> dict:
    from ..cli.profile_tv2v import EDIT_GEOMETRY, _profile, build_edit, int8_environment
    from ..ops.attention import launch_counts, reset_launch_counts

    t, h, w = EDIT_GEOMETRY
    engine, _, _ = build_edit("tv2v", device, seed, 2)
    net, dtype = engine.network, engine.network_dtype
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((2, t, h // 8, w // 8, 4), generator=gen, device=device).to(dtype)
    ts = torch.tensor([500.0, 500.0], device=device)
    cond = {"crossattn": torch.randn((2, 77, 768), generator=gen, device=device).to(dtype),
            "control_hint": (torch.rand((2, t, h, w, 3), generator=gen, device=device) * 2
                             - 1).to(dtype)}

    def row():
        with torch.no_grad():
            return net(x, ts, cond)

    out = {}
    with int8_environment(CCEDIT_QUANT_MATMUL="1"):
        row()  # warm-up: algorithm selection, the build, the weight cache
        calls = []
        sound = quant.quantize_weight

        def recording(weight, dtype=None):
            calls.append((weight, dtype))
            return sound(weight, dtype)

        quant.quantize_weight = recording
        try:
            row()
        finally:
            quant.quantize_weight = sound

        def requantize():
            for wt, dt in calls:
                uncached_weight(wt, dt)

        requantize()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        requantize()
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        kernels = kernel_ms(requantize, OUT / "weights", iters=1)
        out["weight_quantizations"] = dict(
            count=len(calls), distinct=len({id(wt) for wt, _ in calls}),
            device_ms=sum(kernels.values()), kernels_ms=kernels,
            elapsed_ms=roofline.cuda_time_ms(requantize, iters), host_ms=1e3 * host,
            int8_bytes=sum(wt.numel() for wt, _ in {id(wt): (wt, d) for wt, d in calls}.values()))
        del calls
        ways = {"unfused, uncached": (False, False), "fused, uncached": (True, False),
                "unfused, cached": (False, True), "fused, cached": (True, True)}
        order = list(ways) + list(reversed(ways))
        times = {k: [] for k in ways}
        for name in order:
            with route(*ways[name]):
                row()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                start.record()
                row()
                end.record()
                enqueue = time.perf_counter() - t0
                torch.cuda.synchronize()
                times[name].append((start.elapsed_time(end), 1e3 * enqueue))
        out["row_ms"] = {k: dict(device_ms=sum(d for d, _ in v) / len(v),
                                 host_enqueue_ms=sum(e for _, e in v) / len(v), runs=v)
                         for k, v in times.items()}
        reset_launch_counts()
        row()
        out["launches"] = {k: n for k, n in launch_counts().items() if n}
        prof = _profile(row, OUT / "row")
        out["profiled_row"] = {k: prof[k] for k in ("groups_seconds", "top_kernels_seconds",
                                                     "device_busy_share")}
    print(f"[norm_quant] W8A8 row: {json.dumps({k: out[k] for k in ('weight_quantizations', 'launches')})}",
          flush=True)
    print(f"[norm_quant] W8A8 row ms: " + ", ".join(
        f"{k} {v['device_ms']:.2f} (host {v['host_enqueue_ms']:.2f})"
        for k, v in out["row_ms"].items()), flush=True)
    del engine, net
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no_row", action="store_true", help="the shapes only, no network row")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("norm_quant_breakdown needs a CUDA device")
    device = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    gen = torch.Generator(device=device).manual_seed(a.seed)
    shapes = [chain_parts(*spec, iters=a.iters, gen=gen, device=device) for spec in SHAPES]
    row = None if a.no_row else network_row(3, a.seed, device)
    print(json.dumps({"gpu": smi, "device": torch.cuda.get_device_name(0), "shapes": shapes,
                      "third_passes": quant.third_passes(device), "row": row}), flush=True)


if __name__ == "__main__":
    main()
