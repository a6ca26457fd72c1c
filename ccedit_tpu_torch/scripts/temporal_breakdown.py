"""Kernel 2's time split into loads and compute, and its tiling, on one GPU.

    python -m ccedit_tpu_torch.scripts.temporal_breakdown

Builds variants of ``csrc/temporal_attention.cu`` (a patched copy each,
compiled with nvcc into ``build/temporal_breakdown/``; the machinery of
``bwd_breakdown``) and times each, in turns, beside the kernel as it is, at
the six shapes of ``chip_smoke.py`` (the UNet's three levels at T 17 and
12, in the model's layout):

* ``no_compute``: the loads and the stores, without the scores' and P.V's
  products (the softmax of zero scores remains);
* ``no_loads``: everything but the cp.async copies (the products run on
  whatever shared memory holds);
* ``items_160``: items of at most 160 columns (G * d), half the heads a
  block and about twice the blocks an SM;
* ``chunks_3``: at most 3 column vectors (24 columns) a lane, twice the
  lanes a (head, query) at d = 40 and 80.

The first two give wrong outputs and time only what remains; the tiling
variants keep the work, and each line reports every variant's largest
difference from the kernel's output, relative to its largest value.  One
JSON line a shape, with the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess

import torch

from ..ops import build
from ..ops import temporal_attention as ta
from . import bwd_breakdown as bb
from . import roofline

SHAPES = ((12288, 8, 17, 40), (3072, 8, 17, 80), (768, 8, 17, 160),
          (12288, 8, 12, 40), (3072, 8, 12, 80), (768, 8, 12, 160))
OUT = build.BUILD_DIR.parent / "temporal_breakdown"
SOURCE = "temporal_attention.cu"
ENTRY = "ccedit_temporal_attention"

VARIANTS = {
    "no_compute": (
        ("for (int c = c0; c < c1; ++c) {\n      float qf[8];",
         "for (int c = c0; c < c0; ++c) {\n      float qf[8];"),
        ("for (int j = 0; j < TP; ++j) {\n        float vf[8];",
         "for (int j = 0; j < 0; ++j) {\n        float vf[8];"),
    ),
    "no_loads": (
        ("cp_async16(dst + x * tensor_vecs + t * it.pitch + u, base + t * st[x].n);",
         "(void)base;"),
    ),
    "items_160": (("kMaxItemColumns = 320;", "kMaxItemColumns = 160;"),),
    "chunks_3": (("kMaxChunks = 5;", "kMaxChunks = 3;"),),
}


def run(device, iters: int = 20) -> list:
    """Time the kernel and every variant at each of ``SHAPES``, twice in
    turns; one record a shape."""
    fns = {"kernel": getattr(build.library(), ENTRY),
           **bb.build_variants(VARIANTS, SOURCE, ENTRY, OUT)}
    gen = torch.Generator(device=device).manual_seed(0)
    records = []
    for shape in SHAPES:
        b, h, t, d = shape
        q, k, v = (torch.randn((b, t, h, d), generator=gen, device=device)
                   .to(torch.bfloat16).permute(0, 2, 1, 3) for _ in range(3))
        out = torch.empty_like(q)
        strides = build.attention_operand_strides(q, k, v, out, ta.HEAD_DIMS)
        scale = d ** -0.5

        def call(fn):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, t, d,
                     strides, scale, build.stream_of(q))
            if err != 0:
                raise RuntimeError(f"launch failed with error {err}")

        call(fns["kernel"])
        want = out.float().clone()
        ms, diff = {name: [] for name in fns}, {}
        for _ in range(2):
            for name, fn in fns.items():
                ms[name].append(roofline.cuda_time_ms(lambda: call(fn), iters))
                diff[name] = ((out.float() - want).abs().max() / want.abs().max()).item()
        bound = roofline.attention_bound(b, h, t, t, d)
        records.append(dict(shape=list(shape), ms=ms, max_rel_diff=diff,
                            bound_ms=bound["bound_ms"], bound_what=bound["bound_what"]))
    return records


def main(argv=None) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("temporal_breakdown needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    for record in run(torch.device("cuda:0")):
        print(json.dumps(dict(gpu=smi, **record)), flush=True)


if __name__ == "__main__":
    main()
