"""Whether kernels compile to the same machine code as another tree's.

    python -m ccedit_tpu_torch.scripts.sass_diff OTHER_CSRC [SOURCE ...]

Compiles each ``SOURCE`` (default: every ``*.cu`` of ``csrc/``) from this
checkout's ``csrc/`` and from ``OTHER_CSRC`` (for instance the parent
commit's, unpacked with ``git archive``) to cubins with the build's nvcc
flags, disassembles both with ``cuobjdump -sass`` and compares every
kernel of the other tree with this tree's, instruction for instruction
(addresses and encodings dropped; kernel names may differ, since a
template can gain parameters with defaults).  One JSON line a source:
each other-tree kernel's instruction count and whether an identical
kernel exists here, and this tree's kernels that have no identical
counterpart there (``new``: a redesigned kernel's instantiations, such as
``int8_gemm.cu``'s ``dequant_gemm_kernel<BN, FUSED>`` beside kernel 6's
unchanged ``gemm_kernel``).  Needs the CUDA toolkit (nvcc, cuobjdump); no
GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from ..ops import build

_INSTRUCTION = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")


def _tool(name: str) -> str:
    found = shutil.which(name) or str(Path(build._nvcc()).parent / name)
    if not Path(found).exists():
        raise RuntimeError(f"{name} not found")
    return found


def kernels(csrc: Path, source: str, cubin: Path) -> dict:
    """{kernel name: its SASS instructions} of ``csrc/source``, compiled
    to ``cubin``."""
    flags = [f for f in build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([build._nvcc(), *flags, "-cubin", "-o", str(cubin), str(csrc / source)],
                   check=True, capture_output=True, text=True)
    sass = subprocess.run([_tool("cuobjdump"), "-sass", str(cubin)], check=True,
                          capture_output=True, text=True).stdout
    found, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            found[name] = []
        elif name is not None:
            m = _INSTRUCTION.search(line)
            if m:
                found[name].append(m.group(1))
    return found


def compare(other: Path, source: str, out: Path) -> dict:
    mine = kernels(build.CSRC, source, out / f"mine_{source}.cubin")
    theirs = kernels(other, source, out / f"other_{source}.cubin")
    bodies, their_bodies = {tuple(v) for v in mine.values()}, {tuple(v) for v in theirs.values()}
    per_kernel = {k: dict(instructions=len(v), identical=tuple(v) in bodies)
                  for k, v in theirs.items()}
    return dict(source=source, kernels=per_kernel,
                identical=bool(per_kernel) and all(r["identical"] for r in per_kernel.values()),
                new={k: len(v) for k, v in mine.items() if tuple(v) not in their_bodies})


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, help="the other tree's csrc directory")
    ap.add_argument("sources", nargs="*",
                    default=[p.name for p in sorted(build.CSRC.glob("*.cu"))])
    a = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(os.cpu_count()) as pool:
        # the compilers run in parallel, one source a thread
        for line in pool.map(lambda src: compare(a.other.resolve(), src, Path(tmp)), a.sources):
            print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
