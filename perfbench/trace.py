"""The traced run's profiled windows and their reduction.

Two ``torch.profiler`` windows cover part of the run's window: the first
clip's ``trace_rows`` rows after its first ``trace_after`` (which run
unprofiled, as the profiler slows every launch after its first profiled
window: the rows and the share of the peak are read before it), then the
first clip's VAE decode, where the window holds it, through the next
clip's text, hint and encode stages to its first row.  The benchmark marks
each network row and each call of the port's attention entry point
(``ops/attention.py::dot_product_attention``, as the UNet's transformers
and the VAE bind it) with a ``record_function`` span from its own files; a
device kernel belongs to a span when the host call that launched it
(matched by the trace's correlation id) falls inside the span.

``summarise`` is a frozen copy of the program's
``cli/profile_tv2v.py::_GROUPS`` / ``_union_seconds`` grouping and busy
share, taken so that later changes to the program's tools cannot move
the yardstick.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import shutil
import tempfile
import time
from typing import Dict, List, Tuple

import torch

from .cell import sync

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
GROUPS = (  # matched against "launching op + kernel name"; first match wins
    ("W8A8 quantizer per row (ours)", ("::rows_kernel<",)),
    ("W8A8 quantizer per tensor (ours)", ("::tensor_amax_kernel<", "::tensor_quantize_kernel<")),
    ("fused norm (ours)", ("::norm_moments_kernel<", "::norm_apply_kernel<")),
    ("W8A8 products (ours)", ("::conv_kernel<", "::dequant_gemm_kernel<")),
    ("attention kernels (ours)", ("ccedit::",)),
    ("collectives (NCCL)", ("nccl",)),
    ("convolution", ("convolution", "fprop", "nchwtonhwc", "nhwctonchw")),
    ("gemm", ("::mm", "addmm", "bmm", "gemm", "nvjet", "cublas")),
    ("normalisation", ("norm", "welford", "rowwisemoments")),
    ("copies", ("copy", "memcpy", "memset", "::cat")),
    ("softmax", ("softmax",)),
    ("optimizer (Adam, AdamW)", ("adam", "foreach")),
)
ROW_SPAN, ATTN_SPAN = "perfbench.row", "perfbench.attention"


def group(name: str) -> str:
    low = name.lower()
    for g, keys in GROUPS:
        if any(k in low for k in keys):
            return g
    return "other (elementwise)"


def union_seconds(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if a > end:
            busy += b - a
        elif b > end:
            busy += b - end
        end = max(end, b)
    return busy / 1e6


class Spans:
    """Sorted, non-overlapping host intervals of one span name."""

    def __init__(self, intervals):
        self.iv = sorted(intervals)
        self.starts = [a for a, _ in self.iv]

    def covers(self, ts: float) -> bool:
        i = bisect.bisect_right(self.starts, ts) - 1
        return i >= 0 and ts <= self.iv[i][1]


def summarise(trace_path: str) -> Dict:
    """A profiled window's device kernels, each with its group and whether a row
    or attention span launched it, and its host-op events."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    ops = {e["args"]["External id"]: e for e in events
           if e.get("cat") == "cpu_op" and "External id" in e.get("args", {})}
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    spans = collections.defaultdict(list)
    host = []
    for e in events:
        if e.get("ph") != "X":
            continue
        if e.get("cat") == "user_annotation" and e["name"] in (ROW_SPAN, ATTN_SPAN):
            spans[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
        elif e.get("cat") in ("cpu_op", "user_annotation", "cuda_runtime"):
            host.append((e["ts"], e["ts"] + e["dur"], e["name"]))
    rows, attn = Spans(spans[ROW_SPAN]), Spans(spans[ATTN_SPAN])
    kernels = []
    for e in device:
        op = ops.get(e.get("args", {}).get("External id"), {"name": ""})
        at = launch.get(e.get("args", {}).get("correlation"))
        kernels.append(dict(name=e["name"], group=group(f"{op['name']} {e['name']}"),
                            ts=e["ts"], dur=e["dur"],
                            row=at is not None and rows.covers(at),
                            attention=at is not None and attn.covers(at)))
    return {"kernels": kernels, "host": host, "rows": len(spans[ROW_SPAN])}


def idle_gaps(kernels: List[Dict], host, window: Tuple[float, float], top: int = 10):
    """The longest gaps with no device work in ``window`` (trace us), each
    named by the shortest host event running at its middle."""
    iv = sorted((k["ts"], k["ts"] + k["dur"]) for k in kernels)
    gaps, end = [], window[0]
    for a, b in iv + [(window[1], window[1])]:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for a, b in gaps[:top]:
        mid = 0.5 * (a + b)
        names = [(e - s, n) for s, e, n in host if s <= mid <= e]
        out.append([min(names)[1][:120] if names else "host between calls", (b - a) / 1e6])
    return out


class Tracer:
    """The traced run's profiled windows, the spans and the attention calls'
    shapes."""

    def __init__(self, trace_after: int, trace_rows: int, device):
        self.trace_after, self.trace_rows = trace_after, trace_rows
        self.device = torch.device(device)
        self.prof = None
        self.t0 = 0.0
        self.profiles: List[Dict] = []
        self.calls: List[Tuple[int, int, int, int, int]] = []
        self.row_span = None
        self.dir = tempfile.mkdtemp(prefix="perfbench-trace-")
        self._patched = []

    def install_attention_span(self) -> None:
        from ccedit_tpu_torch.modules import transformer, vae

        for mod in (transformer, vae):
            orig = mod.dot_product_attention

            def wrapped(q, k, v, scale=None, _orig=orig):
                if self.prof is None:
                    return _orig(q, k, v, scale)
                self.calls.append((q.shape[0], q.shape[1], q.shape[2], k.shape[2], q.shape[3]))
                with torch.autograd.profiler.record_function(ATTN_SPAN):
                    return _orig(q, k, v, scale)

            mod.dot_product_attention = wrapped
            self._patched.append((mod, orig))

    def start(self) -> None:
        sync(self.device)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        sync(self.device)
        wall = time.perf_counter() - self.t0
        self.prof.stop()
        path = os.path.join(self.dir, f"profile{len(self.profiles)}.json")
        self.prof.export_chrome_trace(path)
        self.prof = None
        self.profiles.append(dict(summarise(path), wall=wall))
        os.remove(path)

    def row_start(self, rows_before: int) -> None:
        """A row begins after ``rows_before`` rows: the rows' profile starts
        at row ``trace_after``, a decode's profile ends here."""
        if self.prof is not None and len(self.profiles) == 1:
            self.stop()
        if rows_before == self.trace_after and not self.profiles:
            self.start()
        if self.prof is not None:
            self.row_span = torch.autograd.profiler.record_function(ROW_SPAN)
            self.row_span.__enter__()

    def row_end(self, rows_so_far: int) -> None:
        if self.row_span is not None:
            self.row_span.__exit__(None, None, None)
            self.row_span = None
        if self.prof is not None and rows_so_far == self.trace_after + self.trace_rows:
            self.stop()

    def decoding(self) -> None:
        """The first decode after the rows' profile starts the second."""
        if self.prof is None and len(self.profiles) == 1:
            self.start()

    def close(self) -> None:
        if self.prof is not None:
            self.stop()
        for mod, orig in self._patched:
            mod.dot_product_attention = orig
        shutil.rmtree(self.dir, ignore_errors=True)

    # -- readings ------------------------------------------------------------

    def kernels(self) -> List[Dict]:
        return [k for s in self.profiles for k in s["kernels"]]

    def busy_and_window(self) -> Tuple[float, float]:
        busy = sum(union_seconds((k["ts"], k["ts"] + k["dur"]) for k in s["kernels"])
                   for s in self.profiles)
        return busy, sum(s["wall"] for s in self.profiles)

    def breakdown(self) -> Dict:
        by = collections.Counter()
        for k in self.kernels():
            by[k["name"][:120]] += k["dur"] / 1e6
        gaps = []
        for s in self.profiles:
            ks = s["kernels"]
            if ks:
                lo = min(k["ts"] for k in ks)
                hi = max(k["ts"] + k["dur"] for k in ks)
                gaps += idle_gaps(ks, s["host"], (lo, hi))
        gaps.sort(key=lambda g: -g[1])
        return {"device_ops": [[n, s] for n, s in by.most_common(10)], "idle_gaps": gaps[:10]}

    def rows_traced(self) -> int:
        return sum(s["rows"] for s in self.profiles)
