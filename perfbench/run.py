"""Run one cell of the benchmark and print its result line.

    python3 perfbench/run.py --workload tv2v.edit --seed 7 --seconds 40 --trace 0

Reads ``BENCHMARK.json`` at the checkout's root: the cell's configuration
(``perfbench/configs/<config>.json``), traffic mix
(``perfbench/traffic/<traffic>.json``), its limits of the comparison
(``perfbench/limits/<workload>.json``) and its metrics, each read by
``perfbench/metrics/<name>.py``.  Builds the cell, warms up, edits clips
back to back for ``--seconds``, then checks what the window produced
against the plain reference and prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted`` and ``failed`` (network
rows), ``metrics`` (``--trace 0``: the end-to-end metrics; ``--trace 1``:
the per-layer ones, read from a profiled part of the window), ``device``,
with ``--trace 1`` a ``breakdown``, and last ``checks``: each compared
number beside its limit.  Exits non-zero, printing no result, without
enough CUDA devices, or when JAX or the JAX package is loaded once the
window has closed.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from perfbench import check  # noqa: E402
from perfbench.cell import Cell, weight_seed, work_done  # noqa: E402

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ccedit_tpu")


def forbidden_modules():
    """Top-level names in ``sys.modules`` that are JAX's or the JAX
    package's, compared whole (``ccedit_tpu_torch`` is not ``ccedit_tpu``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def load_reader(name: str):
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}",
                                                  HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(workload: str, root: Path = ROOT):
    """(benchmark, cell entry, configuration, traffic, limits) of a cell."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    config = json.loads((HERE / "configs" / f"{cell['config']}.json").read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())
    return bench, cell, config, traffic, limits


def cell_metrics(bench, workload: str, trace: bool):
    """The metrics the cell reports: ``end_to_end`` with ``--trace 0``,
    ``per_layer`` with ``--trace 1``, each where it lists the cell or lists
    none."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def require_chips(n: int) -> None:
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        sys.stderr.write(f"perfbench: this cell needs {n} CUDA device(s); "
                         f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}\n")
        raise SystemExit(3)


class Context:
    """What the metric readers read."""

    def __init__(self, cell: Cell, start, seconds: float, setup_s: float, stages, tracer,
                 config, traffic):
        self.cell, self.seconds, self.setup_s, self.stages = cell, seconds, setup_s, stages
        self.config, self.traffic = config, traffic
        self.rows_per_clip = cell.rows_per_clip
        self.work_rows, self.row_end_s = work_done(start, [r.end for r in cell.rows], seconds)
        self.kernels = tracer.kernels() if tracer else []
        self.rows_traced = tracer.rows_traced() if tracer else 0
        self.attention_calls = tracer.calls if tracer else []
        self.busy_s, self.window_s = tracer.busy_and_window() if tracer else (0.0, 0.0)
        self._flops = None

    def clip_row_ends(self, index: int):
        """The seconds from the window's start at which each row of a clip
        ended."""
        return [s for r, s in zip(self.cell.rows, self.row_end_s) if r.clip == index]

    def flops(self):
        if self._flops is None:
            from perfbench.flops import edit_flops

            self._flops = edit_flops(self.config, self.traffic)
        return self._flops


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run(a, device=None, spec=None) -> dict:
    """One run of ``a.workload``; ``spec`` replaces ``cell_spec``'s files and
    ``device`` the look for a chip (both for the tests)."""
    bench, entry, config, traffic, limits = spec or cell_spec(a.workload)
    if device is None:
        require_chips(entry["chips"])
        device = torch.device("cuda:0")
    phases = {"imports": time.time() - T_START}
    cell = Cell(config, traffic, a.seed, device)
    phases["engine_and_weights"] = time.time() - T_START - sum(phases.values())
    tracer = None
    if a.trace:
        from perfbench.trace import Tracer

        tracer = Tracer(traffic["trace_after"], traffic["trace_rows"], device)
        tracer.install_attention_span()
        cell.tracer = tracer
    cell.warm_up()
    setup_s = time.time() - T_START
    phases["warm_up"] = setup_s - sum(phases.values())
    sys.stderr.write("perfbench: set-up " + json.dumps(phases) + "\n")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    stages = [] if a.trace else None
    try:
        start = cell.run_window(a.seconds, stages)
    finally:
        if tracer is not None:
            tracer.close()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    ctx = Context(cell, start, a.seconds, setup_s, stages, tracer, config, traffic)
    cell.free()
    ref = check.Reference(config, device)
    ref.load(weight_seed(a.seed))
    numbers = check.reference_numbers(ref, traffic, cell, a.seed)
    correct = check.verdict(numbers, limits)
    metrics = {}
    for m in cell_metrics(bench, a.workload, a.trace):
        value = load_reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": entry["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": cell.attempted,
              "failed": 0, "metrics": metrics, "device": dev}
    if tracer is not None:
        dev.update(busy_s=ctx.busy_s, window_s=ctx.window_s)
        result["breakdown"] = tracer.breakdown()
    result["checks"] = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    result = run(a)
    found = forbidden_modules()
    if found:
        sys.stderr.write(f"perfbench: JAX or the JAX package was loaded: {', '.join(found)}\n")
        raise SystemExit(4)
    sys.stderr.write(f"perfbench: {a.workload} seed {a.seed} on {card()}\n")
    for k, c in result["checks"].items():
        sys.stderr.write(f"check {k} {c['value']:.6g} limit {c['limit']}\n")
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()


if __name__ == "__main__":
    main()
