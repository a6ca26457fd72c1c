"""One cell's system under test and its closed-loop window.

``Cell`` builds the program's engine from a configuration file (the
port's ``build_engine`` on its reference-format tree, on the ``meta``
device and then allocated on the card in the configuration's ``dtype``,
with the port's int8 switches set from its ``int8`` list, the seeded
weights loaded through the port's checkpoint loaders), makes each edit's
inputs from the seed on the device (a synthetic clip, the initial and
loop noise, a prompt of the traffic's set, the TVI2V reference frame),
warms up with one 1-step edit at the cell's shapes and then runs whole
edits through ``edit_clip`` back to back until the window closes.

A forward pre-hook and hook on ``engine.network`` count the network
rows: each finished row records a CUDA event (no synchronisation) and
keeps a copy of its input latents, timestep and output for the check.
The first row that starts after the deadline still runs, so that some
row finishes after it; the row after it stops the edit in flight.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import weights as W
from .reference.diffusion import rows_per_clip

LATENT_FACTOR = 8
DTYPES = {"bfloat16": torch.bfloat16}  # the served types that the port runs
# the port's int8 switches: ``ops/quant.py`` (W8A8 convolutions and dense
# layers) and ``ops/attention.py`` (kernel 1c's int8 Q.K^T), and the
# environment variables that also turn each on
INT8_SWITCHES = {"matmul": ("CCEDIT_QUANT_MATMUL", "CCEDIT_INT8"),
                 "qk": ("CCEDIT_QUANT_QK", "CCEDIT_INT8")}
# every key of a configuration file: what the harness reads, and what
# documents the configuration for a reader
CONFIG_READ = {"dtype", "int8", "annotator", "model"}
CONFIG_KEYS = CONFIG_READ | {"name", "source", "source_config", "deployment", "reduced",
                             "assumed"}
# every key of a traffic file, each read by the harness, and the values
# that the plain reference can replay where it replays only some
TRAFFIC_KEYS = {"sampler", "steps", "cfg_scale", "frames", "height", "width", "prompts",
                "negative_prompt", "reference", "trace_after", "trace_rows", "check_rows"}
REFERENCE_KEYS = {"colour_roll", "prior_type", "prior_coefficient_x"}
SAMPLERS = ("DPMPP2SAncestralSampler",)
PRIOR_TYPES = ("ref",)


def validate(config: Dict, traffic: Dict) -> None:
    """Refuse a configuration or traffic file with a key that nothing reads
    or a value that the program or the reference cannot run as written."""
    ref = traffic.get("reference") or {}
    problems = [
        ("configuration keys that nothing reads", sorted(set(config) - CONFIG_KEYS)),
        ("missing configuration keys", sorted(CONFIG_READ - set(config))),
        ("a dtype that is not served", [] if config.get("dtype") in DTYPES
         else [config.get("dtype")]),
        ("unknown int8 switches", sorted(set(config.get("int8", ())) - set(INT8_SWITCHES))),
        ("traffic keys that nothing reads", sorted(set(traffic) - TRAFFIC_KEYS)),
        ("missing traffic keys", sorted(TRAFFIC_KEYS - set(traffic))),
        ("a sampler the reference does not replay", [] if traffic.get("sampler") in SAMPLERS
         else [traffic.get("sampler")]),
        ("reference keys that nothing reads or that are missing",
         sorted(set(ref) ^ REFERENCE_KEYS) if ref else []),
        ("a prior the reference does not replay", [] if not ref or ref.get("prior_type")
         in PRIOR_TYPES else [ref.get("prior_type")]),
    ]
    found = [f"{what}: {items}" for what, items in problems if items]
    if found:
        raise ValueError("perfbench: " + "; ".join(found))


def set_int8(config: Dict) -> None:
    """Set the port's int8 switches as the configuration's ``int8`` list
    says; refuse where the environment turns one on that the list does not,
    or the reverse."""
    from ccedit_tpu_torch.ops.attention import set_quantized_qk
    from ccedit_tpu_torch.ops.quant import set_quantized_matmul

    on = set(config["int8"])
    env = {k for k, names in INT8_SWITCHES.items()
           if any(os.environ.get(n, "") not in ("", "0") for n in names)}
    said = any(n in os.environ for names in INT8_SWITCHES.values() for n in names)
    if said and env != on:
        raise ValueError(f"perfbench: the environment's int8 switches {sorted(env)} differ from "
                         f"the configuration's {sorted(on)}")
    set_quantized_matmul("matmul" in on)
    set_quantized_qk("qk" in on)


class HostEvent:
    """A ``torch.cuda.Event`` stand-in for a CPU device (the tests): the
    host clock when recorded."""

    def __init__(self, enable_timing: bool = True):
        self.t = None

    def record(self) -> None:
        self.t = time.perf_counter()

    def elapsed_time(self, end: "HostEvent") -> float:
        return (end.t - self.t) * 1e3


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class WindowClosed(Exception):
    """Raised by the row pre-hook to stop the edit in flight."""


@dataclasses.dataclass
class Row:
    clip: int
    x: torch.Tensor  # the row's input latents, (2, T, h, w, 4) as the network got them
    t: torch.Tensor  # its timesteps
    out: torch.Tensor  # its output
    end: object  # a CUDA event recorded after it


@dataclasses.dataclass
class Edit:
    """One clip's inputs and what the program made of it."""
    index: int
    prompt: str
    frames: np.ndarray  # (T, H, W, 3) uint8
    init_noise: torch.Tensor
    loop_noise: torch.Tensor
    reference: Optional[np.ndarray] = None
    context: Optional[torch.Tensor] = None  # the rows' text conditioning [uc; c]
    cond_feat: Optional[torch.Tensor] = None  # the rows' appearance latent [uc; c]
    hint: Optional[torch.Tensor] = None  # the annotator's output
    raw: list = dataclasses.field(default_factory=list)  # its network's outputs, a chunk each
    latents: Optional[torch.Tensor] = None  # the finished edit's latents
    output: Optional[np.ndarray] = None  # its frames


def edit_seed(seed: int, index: int) -> int:
    return (seed * 1_000_003 + 7919 * (index + 1)) % (2 ** 63 - 1)


def make_clip(gen: torch.Generator, t: int, h: int, w: int, device) -> np.ndarray:
    """A (T, H, W, 3) uint8 clip: a smooth random colour field seen through a
    window that slides 8 pixels a frame, plus mild per-frame grain."""
    field = torch.rand((1, 3, (h + 8 * t) // 32 + 2, w // 32 + 2), generator=gen, device=device)
    field = F.interpolate(field, scale_factor=32, mode="bicubic", align_corners=False)
    frames = torch.stack([field[0, :, 8 * i:8 * i + h, :w] for i in range(t)])
    frames = frames + 0.03 * torch.randn(frames.shape, generator=gen, device=device)
    u8 = (frames.clamp(0, 1) * 255).round().to(torch.uint8).permute(0, 2, 3, 1)
    return u8.cpu().numpy()


class Cell:
    """The program's engine for one configuration and traffic mix."""

    def __init__(self, config: Dict, traffic: Dict, seed: int, device):
        from ccedit_tpu_torch.config import SAMPLER_NAMES, build_engine
        from ccedit_tpu_torch.diffusion import make_discretization, make_sampler

        validate(config, traffic)
        set_int8(config)
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.dtype = DTYPES[config["dtype"]]
        self.steps, self.cfg = traffic["steps"], traffic["cfg_scale"]
        self.rows_per_clip = rows_per_clip(self.steps)
        with torch.device("meta"):  # no initialisation: every parameter is loaded
            engine = build_engine({"model": config["model"]}, guider_scale=self.cfg,
                                  num_steps=self.steps)
        for m in engine.modules:
            m.to_empty(device=device).to(dtype=self.dtype).eval()
        engine.sampler = make_sampler(SAMPLER_NAMES[traffic["sampler"]], num_steps=self.steps,
                                      discretization=make_discretization("legacy_ddpm"))
        self.engine = engine
        self.annotator = self._annotator(engine)
        self.spec = W.config_spec(config)
        self.reload(seed)
        self._hooks = []
        self.tracer = None
        self.Event = torch.cuda.Event if torch.device(device).type == "cuda" else HostEvent

    def reload(self, seed: int) -> None:
        """Load the weights of ``seed`` (through the port's checkpoint
        loaders) and forget the last window."""
        from ccedit_tpu_torch.io.checkpoint import load_reference_checkpoint

        self.seed = seed
        made = W.make(self.spec, weight_seed(seed), self.device, self.dtype)
        load_reference_checkpoint(self.engine, {k: v for name in ("network", "vae", "clip")
                                                for k, v in made[name].items()})
        self._load_annotator(made["annotator"])
        self.edits: List[Edit] = []
        self.rows: List[Row] = []
        self.attempted = 0

    @staticmethod
    def _annotator(engine):
        from ccedit_tpu_torch.conditioning.annotators.base import AnnotatorEmbedder

        return next(e for e in engine.conditioner.embedders if isinstance(e, AnnotatorEmbedder))

    def _load_annotator(self, sd: Dict[str, torch.Tensor]) -> None:
        from ccedit_tpu_torch.conditioning.annotators.dpt_midas import load_dpt_checkpoint

        if self.annotator.kind == "depth_midas":
            load_dpt_checkpoint(self.annotator.backbone, sd)
        else:
            self.annotator.backbone.load_state_dict(sd, strict=True)
        self.annotator.backbone_loaded = True

    # -- inputs ------------------------------------------------------------

    def make_edit(self, index: int, steps: Optional[int] = None) -> Edit:
        tr = self.traffic
        t, h, w = tr["frames"], tr["height"], tr["width"]
        gen = torch.Generator(device=self.device).manual_seed(edit_seed(self.seed, index))
        frames = make_clip(gen, t, h, w, self.device)
        shape = (1, t, h // LATENT_FACTOR, w // LATENT_FACTOR, 4)
        init = torch.randn(shape, generator=gen, device=self.device)
        loop = torch.randn((steps or self.steps,) + shape, generator=gen, device=self.device)
        prompts = tr["prompts"]
        prompt = prompts[int(torch.randint(len(prompts), (1,), generator=gen,
                                           device=self.device))]
        ref = None
        if tr.get("reference"):
            r = tr["reference"]
            # the edited reference: the centre frame, its colour channels rolled
            ref = np.ascontiguousarray(np.roll(frames[t // 2], r["colour_roll"], axis=-1))
        return Edit(index, prompt, frames, init, loop, ref)

    def edit(self, e: Edit, steps: int, stage_seconds=None):
        from ccedit_tpu_torch.cli.pipeline import edit_clip

        tr = self.traffic
        extra = {}
        if e.reference is not None:
            r = tr["reference"]
            extra = dict(reference=e.reference, prior_type=r["prior_type"],
                         prior_coefficient_x=r["prior_coefficient_x"])
        gen = torch.Generator(device=self.device).manual_seed(edit_seed(self.seed, e.index))
        return edit_clip(self.engine, e.frames, e.prompt, tr["negative_prompt"], self.cfg, steps,
                         gen, return_latents=True, init_noise=e.init_noise,
                         loop_noise=e.loop_noise, stage_seconds=stage_seconds, **extra)

    def warm_up(self) -> None:
        """One 1-step edit at the cell's shapes: text, hint, encode, one row,
        decode, and cuDNN's algorithm choices."""
        self.edit(self.make_edit(-1, steps=1), 1)
        sync(self.device)

    # -- the window ----------------------------------------------------------

    def _install(self, deadline: float) -> None:
        state = {"closing": False}
        net = self.engine.network

        def pre(_module, _args):
            if state["closing"]:
                raise WindowClosed
            if time.perf_counter() > deadline:
                state["closing"] = True
            self.attempted += 1
            if self.tracer is not None:
                self.tracer.row_start(len(self.rows))

        def post(_module, args, out):
            x, t, cond = args
            e = self.edits[-1]
            if e.context is None:
                e.context = cond["crossattn"].detach().clone()
                if "cond_feat" in cond:
                    e.cond_feat = cond["cond_feat"].detach().clone()
            end = self.Event(enable_timing=True)
            end.record()
            self.rows.append(Row(e.index, x.detach().clone(), t.detach().clone(),
                                 out.detach().clone(), end))
            if self.tracer is not None:
                self.tracer.row_end(len(self.rows))

        def hint(_module, _args, out):
            self.edits[-1].hint = out.detach().clone()

        def raw(_module, _args, out):
            self.edits[-1].raw.append((out[0] if isinstance(out, tuple) else out).detach().clone())

        def decoding(_module, _args):
            if self.tracer is not None:
                self.tracer.decoding()

        dec = self.engine.vae.decoder
        self._hooks = [net.register_forward_pre_hook(pre), net.register_forward_hook(post),
                       self.annotator.register_forward_hook(hint),
                       self.annotator.backbone.register_forward_hook(raw),
                       dec.register_forward_pre_hook(decoding)]

    def run_window(self, seconds: float, stage_seconds: Optional[list] = None):
        """Edit clips back to back until ``seconds`` have passed; returns the
        window's start event.  ``stage_seconds``: a list that gets each
        edit's stage seconds (the stopwatch synchronises at each stage)."""
        sync(self.device)
        start = self.Event(enable_timing=True)
        start.record()
        self._install(time.perf_counter() + seconds)
        try:
            index = 0
            while True:
                e = self.make_edit(index)
                self.edits.append(e)
                stages = {} if stage_seconds is not None else None
                if stages is not None:
                    stage_seconds.append(stages)
                frames, latents = self.edit(e, self.steps, stages)
                e.output, e.latents = frames, latents
                index += 1
        except WindowClosed:
            pass
        finally:
            for h in self._hooks:
                h.remove()
        sync(self.device)
        return start

    def free(self) -> None:
        """Drop the program's engine and state (the rows' copies stay)."""
        self.engine = self.annotator = None
        import gc

        gc.collect()
        torch.cuda.empty_cache()


def weight_seed(seed: int) -> int:
    return (seed * 2_654_435_761 + 12345) % (2 ** 63 - 1)


def work_done(start, ends: List, seconds: float):
    """(rows finished by the deadline, interpolated through the row in flight
    at it; each row's end in seconds from the start)."""
    times = [start.elapsed_time(e) / 1e3 for e in ends]
    done = sum(1 for s in times if s <= seconds)
    if done == len(times):
        return float(done), times
    last = times[done - 1] if done else 0.0
    return done + (seconds - last) / (times[done] - last), times
