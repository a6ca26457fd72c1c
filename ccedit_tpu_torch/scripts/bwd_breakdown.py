"""Kernel 4's time split by leaving parts of its work out, on one GPU.

    python -m ccedit_tpu_torch.scripts.bwd_breakdown [d40] [d64] [d512]

``d40`` (the default) builds variants of ``csrc/spatial_attention_bwd.cu`` (a patched copy each,
compiled with nvcc into ``build/bwd_breakdown/``) and times each, in turns,
beside the kernel as it is, at the TV2V training shapes and the CFCA's
n_k = 2 * n_q:

* ``no_dq_atomics``: the dQ product without its atomic additions;
* ``no_dq``: neither the dQ product nor its additions;
* ``no_exp2``: P = the scaled scores, without the exponentials;
* ``dq_bulk_reduce``: the dQ tile staged in shared memory and added by one
  TMA bulk reduce-add (``cp.reduce.async.bulk .add.f32``) in place of the
  atomics, at d <= 128 (d 80 with two stages instead of three, to fit).

The variants that leave work out give wrong gradients and time only what
remains; the reduce-add keeps the work, and each line reports every
variant's largest dq/dk/dv difference from the kernel's, relative to the
kernel's largest value, so that one shows it is right.

``d64`` times the same four variants beside the kernel at head_dim 64
(SD-2.x's heads): SD-2.1-768's levels 1 and 0, (2, 10, 2304, 64) and
(2, 5, 9216, 64), and a ragged (2, 8, 600, 64), with the whole wrapper
(``wrapper_ms``: prep, main and convert kernels), SDPA's backward alone
(``library_ms``) and the bound beside them.

``d512`` builds variants of ``csrc/flash_attention_bwd.cu`` that launch one
of its three passes alone (``dk_only``, ``dq_only``, ``dv_only``, each after
the delta kernel) or the passes without the delta kernel (``no_delta``) and
times each, in turns, beside the kernel as it is, at the VAE training
shapes, with the whole wrapper (``wrapper_ms``) and SDPA's backward alone
(``library_ms``) beside them.

One JSON line a shape, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess

import torch

from ..ops import build
from ..ops import flash_attention as fa
from ..ops import spatial_attention as sa
from . import roofline

SHAPES = (((48, 8, 3072, 40), 3072), ((48, 8, 768, 80), 768), ((4, 8, 3072, 40), 6144))
SHAPES_64 = (((2, 10, 2304, 64), 2304), ((2, 5, 9216, 64), 9216), ((2, 8, 600, 64), 600))
OUT = build.BUILD_DIR.parent / "bwd_breakdown"

_ATOMICS = """      atomicAdd(reinterpret_cast<float2*>(row0 + 8 * j), make_float2(acc[4 * j], acc[4 * j + 1]));
      atomicAdd(reinterpret_cast<float2*>(row0 + 8 * ld + 8 * j),
                make_float2(acc[4 * j + 2], acc[4 * j + 3]));
"""
_ATOMICS_V4 = """      atomicAdd(reinterpret_cast<float4*>(row + 8 * j), v);
"""
_DQ_TURN = "if (dq_turn) {  // dQ"
_EXP2 = "ex2(fmaf(sc[4 * j + e], scale_log2, -((e & 1) ? l.y : l.x)))"
# the dQ tile through a per-warpgroup fp32 staging buffer and one bulk
# reduce-add; the issuing thread waits for its previous reduce to have read
# the buffer before the warpgroup writes it again, and for all of them
# before the block exits
_BULK_DQ = """{
        float acc[D / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk)
          WgmmaSS<D, 1, 1>::run(acc, desc(ds + kk * 2048, kBN * 128, 1024, 1),
                                desc(s_k + kk * 2048, kBN * 128, 1024, 1), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        float* stg = s_dqs + w * kBM * D;
        if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\\n" ::: "memory");
        named_sync(3 + w, 128);
        const int r = 16 * warp + g;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          *reinterpret_cast<float2*>(stg + r * D + 8 * j + 2 * t) = make_float2(acc[4 * j], acc[4 * j + 1]);
          *reinterpret_cast<float2*>(stg + (r + 8) * D + 8 * j + 2 * t) =
              make_float2(acc[4 * j + 2], acc[4 * j + 3]);
        }
        fence_proxy_async();
        named_sync(3 + w, 128);
        if (tid == 0) {
          asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\\n"
                       ::"l"(reinterpret_cast<uint64_t>(dq_acc + (static_cast<long long>(bh) * n_q_pad + row_q0) * D)),
                       "r"(smem_addr(stg)), "r"(kBM * D * 4) : "memory");
          asm volatile("cp.async.bulk.commit_group;\\n" ::: "memory");
        }
      }"""
VARIANTS = {
    "no_dq_atomics": ((_ATOMICS, ""), (_ATOMICS_V4, "")),
    "no_dq": ((_DQ_TURN, "if (false) {  // dQ"),),
    "no_exp2": ((_EXP2, _EXP2[4:-1]),),
    "dq_bulk_reduce": (
        ("static constexpr int kStages = D < 64 ? 4 : (D == 64 ? 2 : (D <= 128 ? 3 : 2));",
         "static constexpr int kStages = D < 64 ? 4 : 2;"),
        ("2 * kDsBytes + kStages * kStatBytes + (kD64 ? 16 : 0);",
         "2 * kDsBytes + kStages * kStatBytes + 16 + (D <= 128 ? 2 * kBM * D * 4 : 0);"),
        ("  __shared__ uint64_t kv_full, full[S], empty[S];",
         "  float* s_dqs = s_stats + S * 2 * kBM + 4;\n  __shared__ uint64_t kv_full, full[S], empty[S];"),
        ("dq_piece<D>(ds, s_k, row0, D);", _BULK_DQ),
        ("dq_piece<D, true>(ds, s_k, row0, D);", _BULK_DQ),
        ("\n  const int row0 = key, row1 = key + 8;",
         "\n  if (tid == 0) asm volatile(\"cp.async.bulk.wait_group 0;\\n\" ::: \"memory\");"
         "\n  const int row0 = key, row1 = key + 8;"),
    ),
}


SHAPES_512 = (((12, 1, 1024, 512), 1024), ((4, 1, 4096, 512), 4096), ((2, 1, 600, 512), 600))
SOURCE_512 = "flash_attention_bwd.cu"
_PASSES = "__constant__ const int kPassOrder[] = {kDK, kDQ, kDV};\nconstexpr int kPasses = 3;"
VARIANTS_512 = {
    **{f"{p}_only": ((_PASSES, f"__constant__ const int kPassOrder[] = {{k{p.upper()}}};\n"
                               "constexpr int kPasses = 1;"),)
       for p in ("dk", "dq", "dv")},
    "no_delta": (("  delta_kernel<<<", "  if (false) delta_kernel<<<"),),
}


def patched(name: str, variants: dict = VARIANTS,
            source: str = "spatial_attention_bwd.cu") -> str:
    """``csrc/<source>`` with variant ``name``'s substitutions; each must
    apply."""
    src = (build.CSRC / source).read_text()
    for old, new in variants[name]:
        if old not in src:
            raise ValueError(f"variant {name}: {old[:60]!r} is not in {source}")
        src = src.replace(old, new)
    return src


def build_variants(variants: dict = VARIANTS, source: str = "spatial_attention_bwd.cu",
                   entry: str = "ccedit_spatial_attention_bwd", out=OUT) -> dict:
    """Compile a patched copy of ``csrc/<source>`` for every variant, in
    parallel, each into its own library under ``out``; their C entries
    ``entry`` by name."""
    jobs = {}
    for name in variants:
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        for header in build.CSRC.glob("*.cuh"):
            shutil.copy(header, d)
        (d / "kernel.cu").write_text(patched(name, variants, source))
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / "kernel.cu")]
        jobs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True))
    fns = {}
    for name, (d, proc) in jobs.items():
        out_, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{out_}")
        fn = getattr(ctypes.CDLL(str(d / "lib.so")), entry)
        fn.argtypes = build._SIGNATURES[entry]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def run(device, iters: int = 10, shapes=SHAPES, fns=None) -> list:
    """Time the kernel and every variant at each of ``shapes``, twice in
    turns; one record a shape.  At head_dim 64 the record adds the whole
    wrapper's time, SDPA's backward alone and the bound."""
    fns = fns or {"kernel": build.library().ccedit_spatial_attention_bwd, **build_variants()}
    gen = torch.Generator(device=device).manual_seed(0)
    records = []
    for shape, n_k in shapes:
        b, h, n_q, d = shape
        q, k, v, do = (torch.randn((b, n, h, d), generator=gen, device=device)
                       .to(torch.bfloat16).permute(0, 2, 1, 3) for n in (n_q, n_k, n_k, n_q))
        scale = d ** -0.5
        lse = torch.empty((b * h, n_q), device=device)
        out = sa._forward(q, k, v, scale, lse)
        n_q_pad = -(-n_q // sa._BWD_ROWS) * sa._BWD_ROWS
        stats = torch.empty((b * h, 2 * n_q_pad), device=device)
        dq_acc = torch.empty((b * h, n_q_pad, d), device=device)
        grads = tuple(torch.empty_like(x) for x in (q, k, v))
        strides = build.attention_operand_strides(q, k, v, out, sa.HEAD_DIMS, do=do, dq=grads[0],
                                                  dk=grads[1], dv=grads[2])

        def call(fn):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
                     lse.data_ptr(), stats.data_ptr(), dq_acc.data_ptr(),
                     *(x.data_ptr() for x in grads), b, h, n_q, n_k, d, strides,
                     scale * sa._LOG2E, scale, build.stream_of(q))
            if err != 0:
                raise RuntimeError(f"launch failed with error {err}")

        ms = {name: [] for name in fns}
        diff = {}
        call(fns["kernel"])
        want = tuple(x.float().clone() for x in grads)
        for _ in range(2):
            for name, fn in fns.items():
                ms[name].append(roofline.cuda_time_ms(lambda: call(fn), iters))
                diff[name] = [((x.float() - w).abs().max() / w.abs().max()).item()
                              for x, w in zip(grads, want)]
        extra = {}
        if d == 64:
            extra = dict(
                wrapper_ms=roofline.cuda_time_ms(
                    lambda: sa.spatial_attention_bwd(q, k, v, out, do, lse, scale), iters),
                library_ms=roofline.sdpa_ms(q, k, v, scale, iters, grad_out=do,
                                            backward_only=True)[0],
                **roofline.attention_bound(b, h, n_q, n_k, d, backward=True))
        records.append(dict(shape=list(shape), n_k=n_k, ms=ms,
                            max_rel_diff_dq_dk_dv=diff, **extra))
    return records


def run_512(device, iters: int = 10) -> list:
    """Time kernel 4 at d = 512 and its variants at each of ``SHAPES_512``,
    twice in turns, beside the whole wrapper and SDPA's backward alone; one
    record a shape."""
    fns = {"kernel": build.library().ccedit_flash_attention_bwd,
           **build_variants(VARIANTS_512, SOURCE_512, "ccedit_flash_attention_bwd",
                            OUT / "d512")}
    gen = torch.Generator(device=device).manual_seed(0)
    records = []
    for shape, n_k in SHAPES_512:
        b, h, n_q, d = shape
        q, k, v, do = (torch.randn((b, h, n, d), generator=gen, device=device)
                       .to(torch.bfloat16) for n in (n_q, n_k, n_k, n_q))
        scale = d ** -0.5
        lse = torch.empty((b * h, n_q), device=device)
        out = fa._forward(q, k, v, scale, lse)
        delta = torch.empty((b * h, n_q), device=device)
        grads = tuple(torch.empty_like(x) for x in (q, k, v))
        strides = build.attention_operand_strides(q, k, v, out, fa.HEAD_DIMS, do=do,
                                                  dq=grads[0], dk=grads[1], dv=grads[2])

        def call(fn):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
                     lse.data_ptr(), delta.data_ptr(), *(x.data_ptr() for x in grads), b, h,
                     n_q, n_k, d, strides, scale * fa._LOG2E, scale, build.stream_of(q))
            if err != 0:
                raise RuntimeError(f"launch failed with error {err}")

        ms = {name: [] for name in fns}
        for _ in range(2):
            for name, fn in fns.items():
                ms[name].append(roofline.cuda_time_ms(lambda: call(fn), iters))
        wrapper_ms = roofline.cuda_time_ms(
            lambda: fa.flash_attention_bwd(q, k, v, out, do, lse, scale), iters)
        library_ms, backend = roofline.sdpa_ms(q, k, v, scale, iters, grad_out=do,
                                               backward_only=True)
        records.append(dict(shape=list(shape), n_k=n_k, ms=ms, wrapper_ms=wrapper_ms, library_ms=library_ms,
                            library=f"scaled_dot_product_attention backward [{backend}]",
                            **roofline.attention_bound(b, h, n_q, n_k, d, backward=True)))
    return records


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parts", nargs="*", choices=("d40", "d64", "d512"))
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bwd_breakdown needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    parts = set(a.parts) or {"d40"}
    device = torch.device("cuda:0")
    fns = None
    for part, shapes in (("d40", SHAPES), ("d64", SHAPES_64)):
        if part in parts:
            fns = fns or {"kernel": build.library().ccedit_spatial_attention_bwd,
                          **build_variants()}
            for record in run(device, shapes=shapes, fns=fns):
                print(json.dumps(dict(gpu=smi, part=part, **record)), flush=True)
    if "d512" in parts:
        for record in run_512(device):
            print(json.dumps(dict(gpu=smi, part="d512", **record)), flush=True)


if __name__ == "__main__":
    main()
