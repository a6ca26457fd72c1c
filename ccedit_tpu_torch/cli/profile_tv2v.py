"""Time and profile the full-width TV2V or TVI2V clip edit, a TV2V
training step or a VAE GAN training step, on one GPU.

    python -m ccedit_tpu_torch.cli.profile_tv2v --steps 30 --profile_steps 2 --out DIR
    python -m ccedit_tpu_torch.cli.profile_tv2v --workload tvi2v   # 50 steps, CFG 7
    python -m ccedit_tpu_torch.cli.profile_tv2v --workload tvi2v_zoe   # TVI2V as shipped
    python -m ccedit_tpu_torch.cli.profile_tv2v --workload train   # 5 timed steps, 2 profiled
    python -m ccedit_tpu_torch.cli.profile_tv2v --workload tvi2v_train   # likewise, TVI2V
    python -m ccedit_tpu_torch.cli.profile_tv2v --workload interp_train   # likewise, interpolation
    python -m ccedit_tpu_torch.cli.profile_tv2v --workload vae_train   # likewise, VAETrainer
    python -m ccedit_tpu_torch.cli.profile_tv2v --workload txt2img   # SD-2.1-768, 50 Euler steps
    torchrun --nproc_per_node 4 -m ccedit_tpu_torch.cli.profile_tv2v --clip_shard   # one clip, 4 GPUs

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
batch).  The ``txt2img`` workload builds SD-2.1-768-v (``SD21_768_CONFIG``:
seeded random weights, bf16, OpenCLIP ViT-H/14 text, the hash tokenizer),
draws one warm-up image at 2 steps, then times one 768x768 image through
``sampling_image.sample_images`` at ``--steps`` (default 50) Euler steps,
CFG 7.5, with its stage seconds, network rows (the UNet's calls, each on
the CFG-doubled batch) and kernel launches, and profiles an image at
``--profile_steps``.  The int8 paths are turned on by the environment, as
in the JAX package: ``CCEDIT_QUANT_QK=1`` the int8 QK^T attention (kernel
1c), ``CCEDIT_QUANT_MATMUL=1`` the W8A8 convolutions and dense layers
(``ops/quant.py``, kernels 8-10), ``CCEDIT_INT8=1`` both; the JSON line
records them as ``quantized_qk`` and ``quantized_matmul``.  With
``--int8_modes`` (the ``tv2v``/``tvi2v`` edits) one engine times and
profiles the edit three ways in turn, exact, ``CCEDIT_QUANT_MATMUL=1`` and
``CCEDIT_INT8=1`` (each warmed up, its launches counted), and the line
gives each mode's seconds, seconds a row, peak memory, launches, weight
quantizations (0 after the warm-up: the weight cache), the fused norm
form's third passes, profile and final latents' cosine to the exact
edit's.  Prints one JSON line; the
trace goes to ``--out``.

``--clip_shard`` (the ``tv2v``/``tvi2v`` edits, under ``torchrun``, one
process a GPU, NCCL): every rank builds the same seeded engine and
conditions the whole clip, the sample runs ONE clip split over the ranks
(``parallel/sampling.py``: the frame axis when ``--frames`` divides the
world, else the height axis; ``--height``/``--width`` give the clip another
size, 576x1024 say, whose deepest UNet level is padded), and rank 0
decodes the gathered latents.
Rank 0 prints the JSON line with the world, the axis, the edit and stage
seconds, the seconds per row, every rank's peak memory, the busy share of
rank 0's profile, the device seconds of its NCCL kernels by kind (SendRecv
is the halos under a height or width split and the all-to-alls under a
frame split, and the reblocks at a padded level's transitions; AllReduce
the GroupNorm statistics, and under W8A8 the
per-tensor amax words; AllGather the k/v
gathers, and once an edit the latents; Broadcast the centre frame), and
the collectives a row issues by kind with the bytes rank 0 receives
(``parallel/shard.py::census``).  NCCL kernel time includes the time a
rank waits for the others.  With ``--int8_modes`` too it runs the exact,
W8A8 and umbrella edits in turns on one engine, each as above, and keeps
each mode's final latents under ``--out``; a launch beyond one card
reports each mode's latents' cosine to a one-card launch's of the same
mode (run ``--nproc_per_node 1`` first with the same ``--out``):

    for n in 1 2 4; do torchrun --nproc_per_node $n -m ccedit_tpu_torch.cli.profile_tv2v \
        --clip_shard --int8_modes; done
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import subprocess
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..config import TV2V_CONFIG, TVI2V_CONFIG, TVI2V_ZOE_CONFIG
from ..data.video import moving_gradient_clip
from ..ops import attention as att
from ..ops import quant
from ..ops.attention import quantized_qk_enabled
from ..utils import trace
from .pipeline import base_parser, edit_clip, load_engine

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_GROUPS = (  # matched against "launching op + kernel name"; first match wins
    ("W8A8 quantizer per row (ours)", ("::rows_kernel<",)),
    ("W8A8 quantizer per tensor (ours)", ("::tensor_amax_kernel<", "::tensor_quantize_kernel<")),
    ("W8A8 fused norm quantizer (ours)", ("::norm_moments_kernel<", "::norm_apply_kernel<")),
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
            "nccl_kernels_seconds": {k[:120]: v for k, v in by_kernel.items()
                                     if "nccl" in k.lower()},
            "top_ops_seconds": dict((k[:160], v) for k, v in by_op.most_common(top))}


def _profile(fn, out: Path) -> dict:
    """Run ``fn`` under torch.profiler with the port's spans on
    (``utils/trace.py``); the trace goes to ``out``."""
    out.mkdir(parents=True, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    was = trace.enabled()
    trace.enable(True)
    try:
        with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
    finally:
        trace.enable(was)
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
    n_total = sum(p.numel() for m in engine.modules for p in m.parameters())
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
NCCL_KINDS = (("allgather", "kv_all_gather"), ("allreduce", "norm_all_reduce"),
              ("broadcast", "broadcast"), ("sendrecv", "halo"))


EDIT_CONFIGS = {"tv2v": TV2V_CONFIG, "tvi2v": TVI2V_CONFIG, "tvi2v_zoe": TVI2V_ZOE_CONFIG}
IMAGE_SIZE = 768  # SD-2.1-768's images: 768x768
IMAGE_PROMPT = "a professional photograph of an astronaut riding a horse"


def build_txt2img(device, seed: int, steps: int, size: int = IMAGE_SIZE,
                  extra=()):
    """The full-width SD-2.1-768 image session (``SD21_768_CONFIG``,
    seeded random weights, bf16) and its request arguments: ``size`` x
    ``size``, Euler at ``steps`` steps, CFG 7.5; ``extra`` are more
    ``sampling_image`` flags.  Returns (session, args)."""
    from .sampling_image import add_image_args, build_image_session

    args = add_image_args(argparse.ArgumentParser()).parse_args(
        ["--config_path", "sd21_768", "--bf16", "--device", str(device), "--seed", str(seed),
         "--H", str(size), "--W", str(size), "--sample_steps", str(steps),
         "--sampler_name", "EulerEDMSampler", "--cfg_scale", "7.5",
         "--prompt", IMAGE_PROMPT, "--negative_prompt", "ugly, low quality"] + list(extra))
    return build_image_session(args), args


def count_rows(network):
    """A forward hook counting ``network``'s calls: ``rows()`` reads it."""
    calls = [0]
    handle = network.register_forward_hook(lambda *_: calls.__setitem__(0, calls[0] + 1))
    return (lambda: calls[0]), handle


def profile_txt2img(a, device, smi: str) -> dict:
    """Time and profile one SD-2.1-768 txt2img image."""
    from ..ops.attention import launch_counts, reset_launch_counts
    from .sampling_image import sample_images

    steps = a.steps or 50
    session, args = build_txt2img(device, a.seed, steps)
    warm = argparse.Namespace(**vars(args))
    warm.sample_steps = 2
    sample_images(session, warm)  # warm-up: cuDNN/cuBLAS algorithm selection
    rows, hook = count_rows(session.engine.network)
    stages, launches = {}, {}
    torch.cuda.reset_peak_memory_stats(device)
    resident = torch.cuda.memory_allocated(device) / 1e9
    reset_launch_counts()
    t0 = time.perf_counter()
    image = sample_images(session, args, stage_seconds=stages, stage_launches=launches)[0]
    total = time.perf_counter() - t0
    n_rows = rows()
    hook.remove()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated(device) / 1e9
    prof_args = argparse.Namespace(**vars(args))
    prof_args.sample_steps = a.profile_steps
    profile = _profile(lambda: sample_images(session, prof_args), Path(a.out))
    return {"gpu": smi, "workload": "txt2img", "quantized_qk": quantized_qk_enabled(),
            "cfg_scale": args.cfg_scale, "height": args.H, "width": args.W, "steps": steps,
            "rows": n_rows, "image_seconds": total, "stage_seconds": stages,
            "sample_seconds_per_row": stages["sample"] / n_rows, "peak_memory_gb": peak,
            "resident_memory_gb": resident, "launches": counts,
            "image_mean": float(image.mean()), "image_std": float(image.std()),
            "profile": dict(profile, steps=a.profile_steps)}
TRAIN_WORKLOADS = ("train", "tvi2v_train", "interp_train", "vae_train")
INT8_SWITCHES = ("CCEDIT_INT8", "CCEDIT_QUANT_MATMUL", "CCEDIT_QUANT_QK")
# the --int8_modes edits: exact, W8A8 alone, the umbrella (W8A8 + int8 QK^T)
INT8_MODES = {"exact": {}, "w8a8": {"CCEDIT_QUANT_MATMUL": "1"}, "int8": {"CCEDIT_INT8": "1"}}


@contextlib.contextmanager
def int8_environment(**env):
    """The int8 switches as a user sets them: every ``INT8_SWITCHES``
    variable unset but ``env``, the cached switches cleared so that they are
    read again; all restored on exit."""
    saved = ({k: os.environ.get(k) for k in INT8_SWITCHES}, quant._STATE["matmul"],
             att._QUANT["qk"])
    try:
        for k in INT8_SWITCHES:
            os.environ.pop(k, None)
        os.environ.update(env)
        quant._STATE["matmul"] = att._QUANT["qk"] = None
        yield
    finally:
        for k, v in saved[0].items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
        quant._STATE["matmul"], att._QUANT["qk"] = saved[1], saved[2]


def build_edit(workload: str, device, seed: int, steps: int, config=None,
               frames: Optional[int] = None, clip_shard: bool = False,
               height: Optional[int] = None, width: Optional[int] = None):
    """The full-width engine of the ``tv2v``, ``tvi2v`` or ``tvi2v_zoe``
    edit (seeded random weights, bf16; TVI2V's depth network a random
    DPT-Hybrid, ``tvi2v_zoe``'s ZoeD_M12_N) and its ``edit`` (``make_edit``,
    to which ``frames``, ``clip_shard``, ``height`` and ``width`` go).
    ``config`` replaces the workload's engine config (another structure
    hint, say; an annotator read from its ``ckpt_path`` keeps its weights).
    Returns (engine, edit, cfg_scale)."""
    tvi2v = workload != "tv2v"
    args = base_parser().parse_args(
        ["--bf16", "--device", str(device), "--seed", str(seed), "--sample_steps", str(steps),
         "--cfg_scale", str(7.0 if tvi2v else 7.5)] + ([] if tvi2v else ["--fake_annotator"]))
    engine, _ = load_engine(args, steps, config or EDIT_CONFIGS[workload])
    edit, cfg_scale = make_edit(engine, workload, frames, clip_shard, height, width)
    return engine, edit, cfg_scale


def make_edit(engine, workload: str, frames: Optional[int] = None, clip_shard: bool = False,
              height: Optional[int] = None, width: Optional[int] = None):
    """``edit(n_steps, generator, **edit_clip keywords)``, which edits the
    synthetic clip with ``engine`` (``build_edit``'s for ``workload``; its
    networks take any geometry) as the README's settings do: TV2V with the
    luminance depth stand-in at CFG 7.5; TVI2V with the centre frame with
    its colours shifted as the edited reference, ``prior_type="ref"`` and
    prior_coefficient_x 0.03 at CFG 7.  The clip is ``EDIT_GEOMETRY``'s 17
    keyframes at 512x768, ``frames``, ``height`` and ``width`` (multiples of
    64) in place of its own; ``clip_shard`` samples it split over the ranks
    of a ``torchrun`` launch (``edit_clips``).  Returns (edit, cfg_scale)."""
    tvi2v = workload != "tv2v"
    cfg_scale = 7.0 if tvi2v else 7.5
    t, h, w = EDIT_GEOMETRY
    t, h, w = frames or t, height or h, width or w
    clip = moving_gradient_clip(t, h, w)
    extra = {}
    if tvi2v:  # the edited reference: the centre frame with its colours shifted
        extra = dict(reference=np.ascontiguousarray(np.roll(clip[t // 2], 1, axis=-1)),
                     prior_type="ref", prior_coefficient_x=0.03)

    def edit(n_steps, generator, **kw):
        kw.setdefault("clip_shard", clip_shard)
        return edit_clip(engine, clip, "a robot bear walking through the snow",
                         "ugly, low quality", cfg_scale, n_steps, generator, **extra, **kw)

    return edit, cfg_scale


def nccl_seconds(kernels: dict, axis: int) -> dict:
    """Device seconds of a trace's NCCL kernels by the collective kind each
    NCCL operation carries here (``axis`` 1: SendRecv is the all-to-all)."""
    out = collections.Counter()
    for name, sec in kernels.items():
        low = name.lower()
        kind = next((k for key, k in NCCL_KINDS if key in low), "other")
        if kind == "halo" and axis == 1:
            kind = "all_to_all"
        out[kind] += sec
    return dict(out)


def _clip_shard_edit(a, edit, device, steps: int, axis: int, out: Path,
                     latents_name: Optional[str] = None,
                     exact: Optional[torch.Tensor] = None) -> Optional[dict]:
    """One split edit, timed after a warm-up, its collectives counted
    (``census``), then profiled; rank 0 returns its numbers, the others
    None.  ``latents_name``: rank 0 keeps the final latents beside ``out``
    by that name and, beyond one card, reports their cosine to the one-card
    latents of that name (``..._w1.pt``) where a one-card run left them;
    ``exact``: the same launch's exact latents, whose cosine it reports."""
    import torch.distributed as dist

    from ..ops.attention import launch_counts, reset_launch_counts
    from ..parallel.shard import census

    rank = dist.get_rank() if dist.is_initialized() else 0
    world = dist.get_world_size() if dist.is_initialized() else 1
    edit(1, torch.Generator(device=device).manual_seed(a.seed))  # warm-up
    stages = {}
    torch.cuda.reset_peak_memory_stats(device)
    resident = torch.cuda.memory_allocated(device) / 1e9
    reset_launch_counts()
    with census() as records:
        t0 = time.perf_counter()
        _, latents = edit(steps, torch.Generator(device=device).manual_seed(a.seed),
                          stage_seconds=stages, return_latents=True)
        total = time.perf_counter() - t0
    launches = {k: n for k, n in launch_counts().items() if n}
    peak = torch.cuda.max_memory_allocated(device) / 1e9
    rows = 2 * steps - 1
    per_row = collections.defaultdict(lambda: [0, 0])
    for r in records:
        per_row[r["kind"]][0] += 1
        per_row[r["kind"]][1] += r["bytes"]
    profile = _profile(lambda: edit(a.profile_steps, torch.Generator(device=device)
                                    .manual_seed(a.seed)), out / f"rank{rank}")
    peaks = [(peak, resident, total)]
    if dist.is_initialized():
        peaks = [None] * world
        dist.all_gather_object(peaks, (peak, resident, total))
    if rank != 0:
        return None
    cosine = to_exact = None
    flat = latents.double().flatten().cpu()
    if exact is not None:
        to_exact = (flat @ exact / (flat.norm() * exact.norm())).item()
    if latents_name is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
        torch.save(flat, out.parent / f"{latents_name}_w{world}.pt")
        one = out.parent / f"{latents_name}_w1.pt"
        if world > 1 and one.exists():
            ref = torch.load(one)
            cosine = (flat @ ref / (flat.norm() * ref.norm())).item()
    p_rows = 2 * a.profile_steps - 1
    nccl = nccl_seconds(profile["nccl_kernels_seconds"], axis)
    return {
        "quantized_qk": quantized_qk_enabled(),
        "quantized_matmul": quant.quantized_matmul_enabled(),
        "edit_seconds": total, "stage_seconds": stages,
        "sample_seconds_per_row": stages["sample"] / rows,
        "peak_memory_gb_by_rank": [p[0] for p in peaks],
        "resident_memory_gb_by_rank": [p[1] for p in peaks],
        "edit_seconds_by_rank": [p[2] for p in peaks],
        "collectives_per_row": {k: {"count": n / rows, "mb_received": b / rows / 1e6}
                                for k, (n, b) in sorted(per_row.items())},
        "launches": launches,
        "latent_cosine_to_one_card": cosine,
        "latent_cosine_to_exact": to_exact,
        "latents": flat,
        "nccl_seconds_per_row": {k: v / p_rows for k, v in nccl.items()},
        "profile": dict(profile, steps=a.profile_steps, rows=p_rows),
    }


def profile_clip_shard(a, smi: str) -> Optional[dict]:
    """Time and profile the edit with its sample split over the ranks of a
    ``torchrun`` launch (with ``--int8_modes`` the exact, W8A8 and umbrella
    edits in turns, each mode's final latents beside one card's); rank 0
    returns the JSON line, the others None."""
    import torch.distributed as dist

    from ..parallel.mesh import init_distributed
    from ..parallel.sampling import pick_clip_axis
    from ..parallel.shard import AXES

    device = init_distributed("cuda")
    rank = dist.get_rank() if dist.is_initialized() else 0
    world = dist.get_world_size() if dist.is_initialized() else 1
    steps = a.steps or (30 if a.workload == "tv2v" else 50)
    t, h, w = geometry(a)
    _, edit, cfg_scale = build_edit(a.workload, device, a.seed, steps, frames=t, clip_shard=True,
                                    height=h, width=w)
    axis = pick_clip_axis(world, (1, t, h // 8, w // 8, 4))
    head = {"gpu": smi, "workload": a.workload, "clip_shard": True, "world": world,
            "axis": AXES[axis], "cfg_scale": cfg_scale, "frames": t, "height": h, "width": w,
            "steps": steps, "rows": 2 * steps - 1}
    if a.int8_modes:
        modes, exact = {}, None
        for mode, env in INT8_MODES.items():
            with int8_environment(**env):
                modes[mode] = _clip_shard_edit(a, edit, device, steps, axis, Path(a.out) / mode,
                                               f"latents_{a.workload}_t{t}_{mode}", exact)
            if modes[mode] is not None:
                modes[mode]["env"] = env
                latents = modes[mode].pop("latents")
                exact = latents if exact is None else exact
        result = dict(head, modes=modes)
    else:
        result = dict(head, **(_clip_shard_edit(a, edit, device, steps, axis, Path(a.out))
                               or {}))
        result.pop("latents", None)
    if dist.is_initialized():
        dist.destroy_process_group()
    return result if rank == 0 else None


def geometry(a):
    """(frames, height, width) of the edit: ``EDIT_GEOMETRY`` with
    ``--frames``, ``--height`` and ``--width`` in place of its own."""
    t, h, w = EDIT_GEOMETRY
    return a.frames or t, a.height or h, a.width or w


def profile_int8_modes(a, device, smi: str, edit, cfg_scale: float, steps: int) -> dict:
    """The edit exact, with W8A8 alone and with the umbrella, in turns on
    one engine: each mode warmed up, timed at ``steps`` with its launches
    counted, and profiled at ``a.profile_steps``."""
    from ..ops.attention import launch_counts, reset_launch_counts

    rows, modes, exact = 2 * steps - 1, {}, None
    for mode, env in INT8_MODES.items():
        with int8_environment(**env):
            edit(1, torch.Generator(device=device).manual_seed(a.seed))  # warm-up
            stages = {}
            torch.cuda.reset_peak_memory_stats(device)
            reset_launch_counts()
            misses, third = quant.WEIGHT_CACHE["misses"], quant.third_passes(device)
            t0 = time.perf_counter()
            _, latents = edit(steps, torch.Generator(device=device).manual_seed(a.seed),
                              stage_seconds=stages, return_latents=True)
            total = time.perf_counter() - t0
            counts = {k: n for k, n in launch_counts().items() if n}
            misses = quant.WEIGHT_CACHE["misses"] - misses
            third = quant.third_passes(device) - third
            peak = torch.cuda.max_memory_allocated(device) / 1e9
            profile = _profile(lambda: edit(a.profile_steps, torch.Generator(device=device)
                                            .manual_seed(a.seed)), Path(a.out) / mode)
            latents = latents.double().flatten()
            exact = latents if exact is None else exact
            modes[mode] = {
                "env": env, "quantized_qk": quantized_qk_enabled(),
                "quantized_matmul": quant.quantized_matmul_enabled(), "edit_seconds": total,
                "stage_seconds": stages, "sample_seconds_per_row": stages["sample"] / rows,
                "peak_memory_gb": peak, "launches": counts, "weight_quantizations": misses,
                "fused_norm_third_passes": third,
                "latent_cosine_to_exact":
                    (latents @ exact / (latents.norm() * exact.norm())).item(),
                "profile": dict(profile, steps=a.profile_steps, rows=2 * a.profile_steps - 1)}
    t, h, w = geometry(a)
    return {"gpu": smi, "workload": a.workload, "cfg_scale": cfg_scale, "frames": t, "height": h,
            "width": w, "steps": steps, "rows": rows, "modes": modes}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", choices=tuple(EDIT_CONFIGS) + TRAIN_WORKLOADS + ("txt2img",),
                    default="tv2v")
    ap.add_argument("--steps", type=int, default=None,
                    help="sampling steps (default: 30 for tv2v, 50 for tvi2v, tvi2v_zoe and "
                         "txt2img); "
                         "timed training steps for the training workloads (default 5)")
    # one profiled training step reads a busy share of 58-75 % where two
    # read 97 %: the profiler's start falls inside a single step's window
    ap.add_argument("--profile_steps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=str, default="build/profile_tv2v")
    ap.add_argument("--clip_shard", action="store_true",
                    help="tv2v/tvi2v under torchrun: one clip split over the ranks' GPUs")
    ap.add_argument("--frames", type=int, default=None,
                    help="keyframes of the edit (default 17); 16 splits on the frame axis")
    ap.add_argument("--height", type=int, default=None,
                    help="the tv2v/tvi2v clip's height in pixels (default 512; a multiple of 64)")
    ap.add_argument("--width", type=int, default=None,
                    help="the tv2v/tvi2v clip's width in pixels (default 768; a multiple of 64)")
    ap.add_argument("--int8_modes", action="store_true",
                    help="tv2v/tvi2v: time and profile the edit exact, with W8A8 alone "
                         "(CCEDIT_QUANT_MATMUL=1) and with CCEDIT_INT8=1 on one engine")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_tv2v needs a CUDA device")
    device = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    if a.clip_shard:
        if a.workload not in ("tv2v", "tvi2v"):
            raise SystemExit("--clip_shard profiles the tv2v and tvi2v edits")
        result = profile_clip_shard(a, smi)
        if result is not None:
            print(json.dumps(result))
        return
    if a.workload in TRAIN_WORKLOADS:
        profile = profile_vae_train if a.workload == "vae_train" else profile_train
        print(json.dumps(profile(a, device, smi)))
        return
    if a.workload == "txt2img":
        print(json.dumps(profile_txt2img(a, device, smi)))
        return
    steps = a.steps or (30 if a.workload == "tv2v" else 50)
    t, h, w = geometry(a)
    _, edit, cfg_scale = build_edit(a.workload, device, a.seed, steps, frames=a.frames,
                                    height=h, width=w)
    if a.int8_modes:
        if a.workload not in ("tv2v", "tvi2v"):
            raise SystemExit("--int8_modes profiles the tv2v and tvi2v edits")
        print(json.dumps(profile_int8_modes(a, device, smi, edit, cfg_scale, steps)))
        return
    gen = torch.Generator(device=device).manual_seed(a.seed)

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
        "quantized_matmul": quant.quantized_matmul_enabled(), "cfg_scale": cfg_scale,
        "frames": t, "height": h, "width": w, "steps": steps, "rows": rows,
        "edit_seconds": total, "stage_seconds": stages,
        "sample_seconds_per_row": stages["sample"] / rows, "peak_memory_gb": peak,
        "resident_memory_gb": resident,
        "profile": dict(profile, steps=a.profile_steps, rows=2 * a.profile_steps - 1),
    }))


if __name__ == "__main__":
    main()
