"""The port's GroupNorm on one GPU: kernel 8's norm form beside the plain
fp32 form and beside torch's GroupNorm of a bf16 input.

    python -m ccedit_tpu_torch.scripts.group_norm_route [--steps N] [--no_edit]

flax's ``nn.GroupNorm(dtype=bfloat16)`` keeps its statistics and affine map
in fp32 and rounds only the output; torch's CUDA GroupNorm of a bf16 input
keeps the mean and rstd in bf16.  The port's ``GroupNorm`` module computes
as flax does, through one of two routes: ``quant.plain_group_norm`` (torch's
GroupNorm of an fp32 copy, rounded back: two more copies and twice the
bytes) or kernel 8's norm form ``quant.group_norm`` (its statistics stage in
torch's fp32 order, then one channels-last pass writing bf16).

(1) At each shape of ``SHAPES`` (the full-width TV2V network's and the
VAE decoder's GroupNorm inputs, bf16, random data and affine parameters
from a seed): each route's time and torch's bf16 GroupNorm's on the
module's channels-last layout (CUDA events, after a warm-up), the host
microseconds a call of each and of the module takes to issue its work
(``host_us``: the cost on a host-bound path, as a split clip's), and each
one's share of bf16 outputs differing from a GroupNorm with fp64 statistics
rounded to bf16; the norm form against the plain fp32 form: bit for bit or
its largest difference (torch's fp32 kernel walks each group in the order
kernel 8 mirrors, or not).

(2) Unless ``--no_edit``: the exact TV2V edit (``profile_tv2v.build_edit``,
17x512x768, ``--steps`` steps, after a warm-up) timed with the module on
each route in turns (norm form, plain, plain, norm form), and the final
latents' cosine between the routes.

(3) With ``--rows``: how far one CFG-doubled TV2V network row (``chip_smoke.py``
phase 11's, 17 frames) moves, exact and under W8A8
(``CCEDIT_QUANT_MATMUL=1``), with every ``qconv`` site's scale
(``chip_smoke.qconv_scales``), when (a) the GroupNorm module takes its other
route (under W8A8 only the GroupNorms outside the fused chains take one),
and (b) every image GroupNorm sums its statistics as a split clip's does
(``OrderOnlyShard``: ``GroupNorm.sharded_affine``'s fp32 moments combined
in fp64, the fused sites on kernel 8's external-statistics form), on the
whole clip on one card, nothing else changed: no halo crosses a rank (the
clip's edges are zeros, as the padding), k/v stay whole, each amax is the
whole tensor's.  Beside them the W8A8 row against the exact one (the
quantization's own distance).  (b) is the one difference a split
introduces in its GroupNorms: a network that moves that far under it cannot
hold a split W8A8 row nearer the one-card W8A8 row.

One JSON line with the card's name and power limit.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess
import time

import torch
import torch.nn.functional as F

from ..ops import quant
from ..parallel.shard import ClipShard

# (label, x shape (S, ..., C), GroupNorm eps)
SHAPES = (
    ("level-0 image", (34, 64, 96, 320), 1e-5),
    ("level-0 temporal", (12288, 17, 320), 1e-5),
    ("level-0 temporal, height split over 4", (3072, 17, 320), 1e-5),
    ("level-1 image", (34, 32, 48, 640), 1e-5),
    ("level-2 image", (34, 16, 24, 1280), 1e-5),
    ("VAE decoder 128", (17, 512, 768, 128), 1e-6),
    ("VAE decoder 512", (17, 256, 384, 512), 1e-6),
)


def operands(shape, eps, gen, device):
    """bf16 x ~ N(0, 1) * 3 + 1.5 and a GroupNorm(32) module with bf16
    weight 1 + 0.1 N(0, 1) and bias 0.1 N(0, 1)."""
    from ..modules.layers import GroupNorm

    c = shape[-1]
    norm = GroupNorm(32, c, eps=eps, temporal=len(shape) == 3).to(device, torch.bfloat16)
    with torch.no_grad():
        norm.weight.copy_(1 + 0.1 * torch.randn((c,), generator=gen, device=device))
        norm.bias.copy_(0.1 * torch.randn((c,), generator=gen, device=device))
    x = (torch.randn(shape, generator=gen, device=device) * 3 + 1.5).to(torch.bfloat16)
    return x, norm


def torch_bf16(x, norm):
    """torch's GroupNorm of the bf16 input (its statistics in bf16), as the
    module computed it before it kept fp32 statistics."""
    return F.group_norm(x.movedim(-1, 1), norm.num_groups, norm.weight, norm.bias,
                        norm.eps).movedim(1, -1)


def fp64_reference(x, norm):
    weight, bias = norm.weight.double(), norm.bias.double()
    y = F.group_norm(x.movedim(-1, 1).double(), norm.num_groups, weight, bias, norm.eps)
    return y.movedim(1, -1).to(torch.bfloat16)


def differing(y, ref) -> float:
    return (y != ref).count_nonzero().item() / y.numel()


def cuda_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, calls: int = 100) -> float:
    """Host microseconds a call of ``fn`` takes to issue its work: ``calls``
    calls in a row, fewer launches than the device's queue holds, so no call
    waits for the device."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def check_shape(label, shape, eps, gen, device, iters: int) -> dict:
    x, norm = operands(shape, eps, gen, device)
    with torch.no_grad():
        ref = fp64_reference(x, norm)
        outs = {"norm_form": quant.group_norm(x, norm),
                "plain_fp32": quant.plain_group_norm(x, norm), "torch_bf16": torch_bf16(x, norm)}
        diff = (outs["norm_form"].float() - outs["plain_fp32"].float()).abs()
        res = dict(label=label, shape=list(shape),
                   norm_form_bit_for_bit_plain_fp32=bool(torch.equal(outs["norm_form"],
                                                                     outs["plain_fp32"])),
                   norm_form_max_abs_diff_plain_fp32=diff.max().item(),
                   norm_form_outputs_differing_plain_fp32=diff.count_nonzero().item()
                   / diff.numel(),
                   outputs_differing_fp64_stats={k: differing(v, ref) for k, v in outs.items()},
                   ms={"norm_form": cuda_ms(lambda: quant.group_norm(x, norm), iters),
                       "plain_fp32": cuda_ms(lambda: quant.plain_group_norm(x, norm), iters),
                       "torch_bf16": cuda_ms(lambda: torch_bf16(x, norm), iters)},
                   host_us={"module": host_us(lambda: norm(x)),
                            "norm_form": host_us(lambda: quant.group_norm(x, norm)),
                            "torch_bf16": host_us(lambda: torch_bf16(x, norm))})
    bytes_moved = 2 * 2 * math.prod(shape)  # x read once, the output written once
    res["bound_ms"] = bytes_moved / 3.35e12 * 1e3
    print(f"[group_norm] {label} {shape}: " + json.dumps(res), flush=True)
    return res


@contextlib.contextmanager
def plain_route():
    """The ``GroupNorm`` module through the plain fp32 form."""
    norm_form = quant.group_norm
    quant.group_norm = quant.plain_group_norm
    try:
        yield
    finally:
        quant.group_norm = norm_form


def time_edits(steps: int, seed: int, device) -> dict:
    from ..cli.profile_tv2v import build_edit
    from ..ops.attention import launch_counts, reset_launch_counts

    _, edit, _ = build_edit("tv2v", device, seed, steps)
    routes = {"norm_form": contextlib.nullcontext, "plain_fp32": plain_route}
    for ctx in routes.values():  # warm-up of each route
        with ctx():
            edit(1, torch.Generator(device=device).manual_seed(seed))
    seconds, latents, launches = {k: [] for k in routes}, {}, {}
    for name in ("norm_form", "plain_fp32", "plain_fp32", "norm_form"):
        with routes[name]():
            reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, lat = edit(steps, torch.Generator(device=device).manual_seed(seed),
                          return_latents=True)
            torch.cuda.synchronize()
            seconds[name].append(time.perf_counter() - t0)
            launches[name] = launch_counts()["group_norm"]
            latents[name] = lat.double().flatten()
    a, b = latents["norm_form"], latents["plain_fp32"]
    return dict(steps=steps, edit_seconds=seconds, group_norm_launches=launches,
                latent_cosine=(a @ b / (a.norm() * b.norm())).item())


class OrderOnlyShard(ClipShard):
    """A clip shard of one rank's work that reports a split: the image
    GroupNorms take ``GroupNorm.sharded_affine``'s statistics (this rank's
    sums standing for every rank's, scaled by the world) and the fused
    sites kernel 8's external-statistics form; halos are the clip's zero
    edges, k/v and the amax stay this rank's.  The block is the whole clip,
    so the function is the one-card row's with the statistics summed in the
    split's order."""

    def __init__(self, block):  # rank 0 of a height split in two of a latent
        super().__init__(2, 1, size=(2 * block[0], block[1]))  # of 2 x ``block``'s (H, W)
        self.rank, self.world = 0, 2

    def all_reduce_stats(self, stats):
        return stats.mul_(self.world)

    def all_reduce_amax(self, word):
        return word

    def halo(self, x, dim, before, after):
        zeros = lambda n: torch.zeros_like(x.narrow(dim, 0, n))
        return torch.cat([zeros(before), x, zeros(after)], dim=dim)

    def gather_tokens(self, x, segments=1):
        return x

    def block(self, x, dim):
        return x


def row_sensitivity(seed: int, device) -> dict:
    import chip_smoke

    from ..cli.profile_tv2v import build_edit, int8_environment

    engine, _, _ = build_edit("tv2v", device, seed, 1)
    t, h, w, dtype = 17, 512, 768, engine.network_dtype
    gen = torch.Generator(device=device).manual_seed(seed + t)  # chip_smoke.clip_inputs' row
    x = torch.randn((2, t, h // 8, w // 8, 4), generator=gen, device=device).to(dtype)
    ts = torch.tensor([500.0, 500.0], device=device)
    cond = {"crossattn": torch.randn((2, 77, 768), generator=gen, device=device).to(dtype),
            "control_hint": (torch.rand((2, t, h, w, 3), generator=gen, device=device) * 2
                             - 1).to(dtype)}
    from ..parallel.shard import mesh_context

    rows, scales = {}, {}
    variants = (("norm_form", contextlib.nullcontext), ("plain_fp32", plain_route),
                ("split_order", lambda: mesh_context(OrderOnlyShard(x.shape[2:4]))))
    for mode, env in (("exact", {}), ("w8a8", {"CCEDIT_QUANT_MATMUL": "1"})):
        with int8_environment(**env):
            for route, ctx in variants:
                with ctx(), torch.no_grad(), chip_smoke.qconv_scales() as census:
                    rows[mode, route] = engine.network(x, ts, cond).float()
                census = census["scales"]
                scales[mode, route] = torch.cat(census).cpu() if census else None

    def held(a, b):
        rel = ((a - b).abs().max() / b.abs().max()).item()
        cos = (a.double().flatten() @ b.double().flatten()
               / (a.double().norm() * b.double().norm())).item()
        return dict(rel=rel, cosine=cos)

    out = {f"{mode}_{v}": held(rows[mode, v], rows[mode, "norm_form"])
           for mode in ("exact", "w8a8") for v in ("plain_fp32", "split_order")}
    out["w8a8_vs_exact"] = held(rows["w8a8", "norm_form"], rows["exact", "norm_form"])
    out["w8a8_split_order_vs_exact"] = held(rows["w8a8", "split_order"],
                                            rows["exact", "norm_form"])
    for v in ("plain_fp32", "split_order"):
        a, b = scales["w8a8", v], scales["w8a8", "norm_form"]
        diff = ((a - b).abs() / b).tolist()
        out[f"w8a8_scales_{v}"] = dict(
            sites=len(diff), max_rel=max(diff),
            first_site_above_1e_3=next((i for i, d in enumerate(diff) if d > 1e-3), None),
            rel_by_site=diff)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no_edit", action="store_true")
    ap.add_argument("--rows", action="store_true")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("group_norm_route needs a CUDA device")
    device = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    gen = torch.Generator(device=device).manual_seed(a.seed)
    shapes = [check_shape(*spec, gen=gen, device=device, iters=a.iters) for spec in SHAPES]
    torch.cuda.empty_cache()
    out = {"gpu": smi.splitlines()[0], "torch": torch.__version__, "shapes": shapes}
    if not a.no_edit:
        out["tv2v_edit"] = time_edits(a.steps, a.seed, device)
    if a.rows:
        out["row_sensitivity"] = row_sensitivity(a.seed, device)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
