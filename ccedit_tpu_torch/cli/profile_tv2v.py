"""Time and profile the full-width TV2V or TVI2V clip edit, a TV2V
training step or a VAE GAN training step, on one GPU.

    python -m ccedit_tpu_torch.cli.profile_tv2v --steps 30 --profile_steps 2 --out DIR
    python -m ccedit_tpu_torch.cli.profile_tv2v --workload tvi2v   # 50 steps, CFG 7
    python -m ccedit_tpu_torch.cli.profile_tv2v --workload tvi2v_zoe   # TVI2V as shipped
    python -m ccedit_tpu_torch.cli.profile_tv2v --workload train   # 5 timed steps, 2 profiled
    python -m ccedit_tpu_torch.cli.profile_tv2v --workload tvi2v_train   # likewise, TVI2V
    python -m ccedit_tpu_torch.cli.profile_tv2v --workload interp_train   # likewise, interpolation
    python -m ccedit_tpu_torch.cli.profile_tv2v --workload vae_train   # likewise, VAETrainer

Builds the SD-1.5 engine of the workload (seeded random weights, bf16; TV2V
with the luminance depth stand-in at CFG 7.5, TVI2V with a random full-size
DPT-Hybrid, an edited reference frame, ``--prior_type ref`` and
prior_coefficient_x 0.03 at CFG 7; ``tvi2v_zoe`` the same with a random
full-size ZoeD_M12_N hint, TVI2V as shipped), edits a 17x512x768 synthetic clip once
to warm up, then (1) times ``edit_clip`` at ``--steps`` (default 30 for
TV2V, 50 for TVI2V, the README's settings) with its stage seconds and (2)
profiles an edit at ``--profile_steps`` with torch.profiler.  The profile is read from its chrome
trace: device time by kernel (the trace's kernel, memcpy and memset events),
grouped into our attention kernels / convolution / GEMM / normalisation /
other, the device's busy share of the profiled wall time (the union of the
device events' intervals over the host's window), and the device time of the
heaviest (launching op, input shapes) pairs.  The ``train`` workload (the
counterpart of ``bench.py::bench_train``) builds the engine of
``TV2V_TRAIN_CONFIG`` (seeded random fp32 masters, a random full-size
DPT-Hybrid, ``use_checkpoint``, ``spatial_tv2v``), takes one warm-up step
at batch 4 of 12-frame 384x512 synthetic clips under bf16 autocast, times
``--steps`` (default 5) ``train_step`` calls and profiles
``--profile_steps`` more.  The ``tvi2v_train`` workload does the same with
``TVI2V_TRAIN_CONFIG`` (CFCA, the appearance ControlNet training) at its
recipe's batch 1 of 17-frame 384x512 clips, and ``interp_train`` with
``INTERP_TRAIN_CONFIG`` (the frame-interpolation network, its appearance
ControlNet on the first and last frames) at the same batch and geometry.
The ``vae_train`` workload builds the SD KL-f8
autoencoder of ``VAE_TRAIN_CONFIG`` with a full VGG16 LPIPS and the
PatchGAN (seeded random weights, fp32 masters, bf16 autocast, the GAN term
live from step 0) and times ``VAETrainer.train_step`` the same way on 12
synthetic 256x256 images a step (the sd-vae-ft-mse fine-tune's per-GPU
batch).  The int8 QK^T attention (kernel 1c) is turned
on by the environment, ``CCEDIT_QUANT_QK=1`` (or ``CCEDIT_INT8=1``), as in
the JAX package; the JSON line records it as ``quantized_qk``.  Prints one
JSON line; the trace goes to
``--out``.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from ..config import TV2V_CONFIG, TVI2V_CONFIG, TVI2V_ZOE_CONFIG
from ..data.video import moving_gradient_clip
from ..ops.attention import quantized_qk_enabled
from .pipeline import base_parser, edit_clip, load_engine

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_GROUPS = (  # matched against "launching op + kernel name"; first match wins
    ("attention kernels (ours)", ("ccedit::",)),
    ("convolution", ("convolution", "fprop", "nchwtonhwc", "nhwctonchw")),
    ("gemm", ("::mm", "addmm", "bmm", "gemm", "nvjet", "cublas")),
    ("normalisation", ("norm", "welford", "rowwisemoments")),
    ("copies", ("copy", "memcpy", "memset", "::cat")),
    ("softmax", ("softmax",)),
    ("optimizer (Adam, AdamW)", ("adam", "foreach")),
)


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in _GROUPS:
        if any(k in low for k in keys):
            return group
    return "other (elementwise)"


def _union_seconds(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if a > end:
            busy += b - a
        elif b > end:
            busy += b - end
        end = max(end, b)
    return busy / 1e6


def summarise_trace(trace_path: Path, wall_seconds: float, top: int = 25) -> dict:
    """Device time by kernel, by group and by (launching op, input dims),
    and the busy share, from a torch.profiler chrome trace."""
    events = json.loads(trace_path.read_text())["traceEvents"]
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS]
    ops = {e["args"]["External id"]: e for e in events
           if e.get("cat") == "cpu_op" and "External id" in e.get("args", {})}
    by_kernel, by_group, by_op = (collections.Counter() for _ in range(3))
    for e in device:
        s = e["dur"] / 1e6
        op = ops.get(e.get("args", {}).get("External id"), {"name": "", "args": {}})
        by_kernel[e["name"]] += s
        by_group[_group(f"{op['name']} {e['name']}")] += s
        if op["name"]:
            by_op[f"{op['name']} {op['args'].get('Input Dims', '')}"] += s
    busy = _union_seconds((e["ts"], e["ts"] + e["dur"]) for e in device)
    return {"wall_seconds": wall_seconds, "device_busy_seconds": busy,
            "device_busy_share": busy / wall_seconds,
            "groups_seconds": dict(by_group.most_common()),
            "top_kernels_seconds": dict((k[:120], v) for k, v in by_kernel.most_common(top)),
            "top_ops_seconds": dict((k[:160], v) for k, v in by_op.most_common(top))}


def _profile(fn, out: Path) -> dict:
    """Run ``fn`` under torch.profiler; the trace goes to ``out``."""
    out.mkdir(parents=True, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    prof.export_chrome_trace(str(out / "trace.json"))
    return summarise_trace(out / "trace.json", wall)


def _time_train_steps(a, device, step, read) -> dict:
    """One warm-up ``step()`` (cuDNN/cuBLAS algorithm selection, kernel
    library load), ``a.steps`` (default 5) timed ones, each result turned
    into host values by ``read`` (which waits for the step), then
    ``a.profile_steps`` profiled: the timing fields of a training
    workload's JSON line (peak memory over the timed steps, resident
    memory between steps: weights and optimizer state)."""
    from ..ops.attention import launch_counts, reset_launch_counts

    steps = a.steps or 5
    read(step())
    torch.cuda.reset_peak_memory_stats(device)
    resident = torch.cuda.memory_allocated(device) / 1e9  # weights and optimizer state
    reset_launch_counts()
    times, results = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        results.append(read(step()))
        times.append(time.perf_counter() - t0)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated(device) / 1e9
    profile = _profile(lambda: [step() for _ in range(a.profile_steps)], Path(a.out))
    return {"steps": steps, "step_seconds": times, "mean_step_seconds": sum(times) / steps,
            "results": results, "peak_memory_gb": peak, "resident_memory_gb": resident,
            "launches_per_step": {k: v / steps for k, v in counts.items()},
            "profile": dict(profile, steps=a.profile_steps)}


def train_geometry(cfg) -> tuple:
    """(batch, frames, height, width) of a training config's data."""
    data = cfg["data"]["params"]
    train = data["train"]["params"]
    return (data["batch_size"], train["video_length"]) + tuple(train["resolution"])


def profile_train(a, device, smi: str) -> dict:
    """Time and profile the TV2V (``train``), TVI2V (``tvi2v_train``) or
    interpolation (``interp_train``) recipe's training step at the recipe's
    batch and geometry."""
    from .. import config
    from ..data.dataset import DataLoader, SyntheticVideoDataset
    from .train import build_train_engine

    cfg = {"train": config.TV2V_TRAIN_CONFIG, "tvi2v_train": config.TVI2V_TRAIN_CONFIG,
           "interp_train": config.INTERP_TRAIN_CONFIG}[a.workload]
    bs, t, h, w = train_geometry(cfg)
    engine = build_train_engine(cfg, device, a.seed)
    optimizer = engine.make_optimizer(1e-4)
    loader = DataLoader(SyntheticVideoDataset(n_items=bs * ((a.steps or 5) + a.profile_steps + 1),
                                              num_frames=t, size_hw=(h, w), seed=a.seed),
                        batch_size=bs, seed=a.seed)
    batches = iter(loader)
    gen = torch.Generator(device=device).manual_seed(a.seed)

    def step():
        return engine.train_step(next(batches), optimizer, gen, autocast_dtype=torch.bfloat16)

    timed = _time_train_steps(a, device, step, float)
    n_train = sum(p.numel() for p in engine.trainable_parameters().values())
    n_total = sum(p.numel() for m in (engine.network, engine.vae, engine.conditioner)
                  for p in m.parameters())
    return {"gpu": smi, "workload": a.workload, "quantized_qk": quantized_qk_enabled(),
            "batch": bs, "frames": t, "height": h, "width": w,
            "freeze_policy": engine.freeze_policy, "params_trainable": n_train,
            "params_total": n_total, "losses": timed.pop("results"),
            "frames_per_second": bs * t / timed["mean_step_seconds"], **timed}


VAE_BATCH, VAE_SIZE = 12, 256  # images a step, their height and width


def profile_vae_train(a, device, smi: str) -> dict:
    """Time and profile the VAE GAN training step (``VAETrainer``)."""
    from ..config import VAE_TRAIN_CONFIG
    from ..models.autoencoder_engine import build_vae_trainer

    engine, trainer = build_vae_trainer(VAE_TRAIN_CONFIG, device, a.seed, disc_start=0)
    gen = torch.Generator(device=device).manual_seed(a.seed)

    def step():
        x = torch.rand((VAE_BATCH, VAE_SIZE, VAE_SIZE, 3), generator=gen, device=device) * 2 - 1
        return trainer.train_step(x, gen)

    timed = _time_train_steps(a, device, step, lambda logs: {k: float(v) for k, v in logs.items()})
    n_params = {name: sum(p.numel() for p in getattr(engine, name).parameters())
                for name in ("ae", "disc", "lpips")}
    return {"gpu": smi, "workload": "vae_train", "batch": VAE_BATCH, "height": VAE_SIZE,
            "width": VAE_SIZE, "params": n_params, "logs": timed.pop("results"),
            "images_per_second": VAE_BATCH / timed["mean_step_seconds"], **timed}


EDIT_GEOMETRY = (17, 512, 768)  # frames, height, width


EDIT_CONFIGS = {"tv2v": TV2V_CONFIG, "tvi2v": TVI2V_CONFIG, "tvi2v_zoe": TVI2V_ZOE_CONFIG}
TRAIN_WORKLOADS = ("train", "tvi2v_train", "interp_train", "vae_train")


def build_edit(workload: str, device, seed: int, steps: int, config=None):
    """The full-width engine of the ``tv2v``, ``tvi2v`` or ``tvi2v_zoe``
    edit (seeded random weights, bf16) and ``edit(n_steps, generator,
    **edit_clip keywords)``, which edits the synthetic 17x512x768 clip as
    the README's settings do: TV2V with the luminance depth stand-in at CFG
    7.5; TVI2V with a random DPT-Hybrid (``tvi2v_zoe``: ZoeD_M12_N), the
    centre frame with its colours shifted as the edited reference,
    ``prior_type="ref"`` and prior_coefficient_x 0.03 at CFG 7.  ``config``
    replaces the workload's engine config (another structure hint, say; an
    annotator read from its ``ckpt_path`` keeps its weights).  Returns
    (engine, edit, cfg_scale)."""
    tvi2v = workload != "tv2v"
    cfg_scale = 7.0 if tvi2v else 7.5
    t, h, w = EDIT_GEOMETRY
    args = base_parser().parse_args(
        ["--bf16", "--device", str(device), "--seed", str(seed), "--H", str(h),
         "--W", str(w), "--num_keyframes", str(t), "--sample_steps", str(steps),
         "--cfg_scale", str(cfg_scale)] + ([] if tvi2v else ["--fake_annotator"]))
    engine, _ = load_engine(args, steps, config or EDIT_CONFIGS[workload])
    frames = moving_gradient_clip(t, h, w)
    extra = {}
    if tvi2v:  # the edited reference: the centre frame with its colours shifted
        extra = dict(reference=np.ascontiguousarray(np.roll(frames[t // 2], 1, axis=-1)),
                     prior_type="ref", prior_coefficient_x=0.03)

    def edit(n_steps, generator, **kw):
        return edit_clip(engine, frames, "a robot bear walking through the snow",
                         "ugly, low quality", cfg_scale, n_steps, generator, **extra, **kw)

    return engine, edit, cfg_scale


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", choices=tuple(EDIT_CONFIGS) + TRAIN_WORKLOADS,
                    default="tv2v")
    ap.add_argument("--steps", type=int, default=None,
                    help="sampling steps (default: 30 for tv2v, 50 for tvi2v and tvi2v_zoe); "
                         "timed training steps for the training workloads (default 5)")
    # one profiled training step reads a busy share of 58-75 % where two
    # read 97 %: the profiler's start falls inside a single step's window
    ap.add_argument("--profile_steps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=str, default="build/profile_tv2v")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_tv2v needs a CUDA device")
    device = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    if a.workload in TRAIN_WORKLOADS:
        profile = profile_vae_train if a.workload == "vae_train" else profile_train
        print(json.dumps(profile(a, device, smi)))
        return
    steps = a.steps or (30 if a.workload == "tv2v" else 50)
    _, edit, cfg_scale = build_edit(a.workload, device, a.seed, steps)
    gen = torch.Generator(device=device).manual_seed(a.seed)
    t, h, w = EDIT_GEOMETRY

    edit(1, gen)  # warm-up: cuDNN/cuBLAS algorithm selection, kernel library load
    stages = {}
    torch.cuda.reset_peak_memory_stats(device)
    resident = torch.cuda.memory_allocated(device) / 1e9  # the engine's weights
    t0 = time.perf_counter()
    edit(steps, gen, stage_seconds=stages)
    total = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) / 1e9

    profile = _profile(lambda: edit(a.profile_steps, gen), Path(a.out))
    rows = 2 * steps - 1
    print(json.dumps({
        "gpu": smi, "workload": a.workload, "quantized_qk": quantized_qk_enabled(),
        "cfg_scale": cfg_scale,
        "frames": t, "height": h, "width": w, "steps": steps, "rows": rows,
        "edit_seconds": total, "stage_seconds": stages,
        "sample_seconds_per_row": stages["sample"] / rows, "peak_memory_gb": peak,
        "resident_memory_gb": resident,
        "profile": dict(profile, steps=a.profile_steps, rows=2 * a.profile_steps - 1),
    }))


if __name__ == "__main__":
    main()
