"""TV2V and TVI2V inference pipeline (port of ``ccedit_tpu/cli/pipeline.py``).

``edit_clip`` is the per-job body: conditioning, sampling and the uint8
decode of one clip, with an optional edited reference frame (TVI2V), the
x-prior mix, sdedit (the clip's latents noised onto the img2img-pruned
schedule) and inpainting (the clip's white areas regenerated).
``run_pipeline`` wraps it with the same flag surface (``base_parser``), the
base-model sweep with its per-base-model output directories, the LoRA and
VAE swaps, job gathering, ``log_info.json`` resume ledger and saving;
``reference_mode=True`` is the TVI2V CLI (``sampling_tv2v_ref``).  Clip
height and width must be multiples of 64 (an odd latent geometry cannot
round-trip the UNet's down/up skips); the shape bucket grid and the TPU
compile workarounds are not ported, so ``--exact_shapes`` changes nothing.
With ``clip_shard=True`` under ``torchrun`` (one process a GPU) every rank
conditions the whole clip, the sample runs split over the ranks
(``parallel/sampling.py``) and rank 0 decodes the gathered latents.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..conditioning.annotators.base import CHECKPOINTS, AnnotatorEmbedder
from ..conditioning.annotators.zoedepth import randomize_zoedepth_
from ..config import SAMPLER_NAMES, TV2V_CONFIG, TVI2V_CONFIG, build_engine, load_config
from ..data.video import load_image, load_video_keyframes, save_video_frames
from ..diffusion import make_discretization, make_sampler
from ..io.checkpoint import (load_partial, load_reference_checkpoint, load_torch_state_dict,
                             randomize_weights_, reference_parts, sub_state_dict)
from ..io.lora import merge_kohya_lora
from ..ops.attention import launch_counts
from ..parallel.mesh import rank as process_rank
from ..parallel.sampling import gather_clip, make_frame_sharded_sample
from ..utils import trace

PRIOR_TYPES = ("video", "ref", "video_ref")


def base_parser() -> argparse.ArgumentParser:
    """The JAX CLI's flag surface (sampling_tv2v.py), plus ``--device``."""
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--config_path", type=str, default="",
                   help="reference-format YAML; default: the built-in SD-1.5 TV2V config")
    p.add_argument("--ckpt_path", type=str, default="",
                   help="reference checkpoint; default: seeded random weights")
    p.add_argument("--basemodel_path", type=str, default="")
    p.add_argument("--basemodel_listpath", type=str, default="")
    p.add_argument("--lora_path", type=str, default="")
    p.add_argument("--lora_strength", type=float, default=0.8)
    p.add_argument("--vae_path", type=str, default="")
    p.add_argument("--video_path", type=str, default="")
    p.add_argument("--prompt_listpath", type=str, default="")
    p.add_argument("--video_listpath", type=str, default="")
    p.add_argument("--videos_directory", type=str, default="")
    p.add_argument("--json_path", type=str, default="")
    p.add_argument("--videos_root", type=str, default="")
    p.add_argument("--save_path", type=str, default="outputs/demo/tv2v")
    p.add_argument("--H", type=int, default=256)
    p.add_argument("--W", type=int, default=384)
    p.add_argument("--original_fps", type=int, default=20)
    p.add_argument("--target_fps", type=int, default=3)
    p.add_argument("--num_keyframes", type=int, default=9)
    p.add_argument("--prompt", type=str, default="")
    p.add_argument("--negative_prompt", type=str, default="ugly, low quality")
    p.add_argument("--add_prompt", type=str, default="masterpiece, high quality")
    p.add_argument("--sample_steps", type=int, default=50)
    p.add_argument("--sampler_name", type=str, default="DPMPP2SAncestralSampler",
                   choices=sorted(SAMPLER_NAMES))
    p.add_argument("--cfg_scale", type=float, default=7.5)
    p.add_argument("--prior_coefficient_x", type=float, default=0.0)
    p.add_argument("--prior_coefficient_noise", type=float, default=1.0)
    p.add_argument("--sdedit_denoise_strength", type=float, default=0.0)
    p.add_argument("--num_samples", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=4,
                   help="samples drawn per sampler call; --num_samples runs in chunks of it")
    p.add_argument("--disable_check_repeat", action="store_true")
    p.add_argument("--save_type", type=str, default="mp4", choices=["gif", "mp4"])
    p.add_argument("--inpainting_mode", action="store_true")
    p.add_argument("--tokenizer_assets", type=str, default="",
                   help="dir with CLIP vocab.json+merges.txt")
    p.add_argument("--bf16", action="store_true", help="bfloat16 network, VAE and CLIP")
    p.add_argument("--fake_annotator", action="store_true",
                   help="use the luminance pseudo-depth stand-in (NOT MiDaS; debug)")
    p.add_argument("--exact_shapes", action="store_true",
                   help="accepted for the JAX CLI's sake: the port always runs at the "
                        "requested geometry (it has no shape buckets)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; the CUDA kernels need 'cuda'")
    return p


def gather_jobs(args) -> List[Dict]:
    """(video, prompt) work items from the list inputs."""
    if args.json_path:
        data = json.loads(Path(args.json_path).read_text())
        items = data if isinstance(data, list) else data.get("videos", [])
        return [{"video": str(Path(args.videos_root) / it["video_path"]) if args.videos_root
                 else it["video_path"],
                 "prompt": it.get("edit_prompt") or it.get("caption", "")} for it in items]
    if args.video_listpath and args.prompt_listpath:
        vids = Path(args.video_listpath).read_text().splitlines()
        prompts = Path(args.prompt_listpath).read_text().splitlines()
        return [{"video": v, "prompt": p} for v, p in zip(vids, prompts) if v.strip()]
    if args.videos_directory:
        return [{"video": str(f), "prompt": args.prompt}
                for f in sorted(Path(args.videos_directory).iterdir())]
    return [{"video": args.video_path, "prompt": args.prompt}]


def check_args(args) -> None:
    """The geometry and the flag combinations the JAX pipeline asserts."""
    if args.H % 64 or args.W % 64:
        raise ValueError(f"--H/--W must be multiples of 64, got {args.H}x{args.W}")
    if not 0.0 <= args.sdedit_denoise_strength <= 1.0:
        raise ValueError(f"--sdedit_denoise_strength {args.sdedit_denoise_strength} is not in "
                         "[0, 1]")
    if args.sdedit_denoise_strength > 0 and args.prior_coefficient_x != 0:
        raise ValueError("--prior_coefficient_x should be 0 when using --sdedit_denoise_strength")
    if args.basemodel_path and args.basemodel_listpath:
        raise ValueError("only one of --basemodel_path and --basemodel_listpath can be given")


def _randomize(engine, generator: torch.Generator) -> None:
    """Seeded random weights for the network, the VAE and every embedder
    but an annotator loaded from its own checkpoint; ZoeDepth with its
    live-block init (``randomize_zoedepth_``)."""
    randomize_weights_(engine.network, generator)
    if engine.vae is not None:
        randomize_weights_(engine.vae, generator)
    for emb in engine.conditioner.embedders:
        if isinstance(emb, AnnotatorEmbedder) and emb.backbone is not None:
            if emb.backbone_loaded:
                continue
            if emb.kind == "depth_zoe":
                randomize_zoedepth_(emb.backbone, generator)
                continue
        randomize_weights_(emb, generator)


def load_engine(args, num_steps: int, default_config=TV2V_CONFIG):
    """The engine on ``args.device`` with checkpoint or seeded random weights
    (``default_config`` when no ``--config_path``) and the sampler of
    ``--sampler_name`` on the LegacyDDPM schedule, pruned to
    ``--sdedit_denoise_strength`` when it is set (the JAX ``load_engine``;
    the image CLIs have no such flag).
    With a checkpoint, a depth annotator needs its own weights
    (``ckpt_path`` in its embedder params) or ``--fake_annotator``."""
    cfg = load_config(args.config_path) if args.config_path else default_config
    device = torch.device(args.device)
    with device:
        engine = build_engine(cfg, asset_dir=args.tokenizer_assets or None,
                              guider_scale=args.cfg_scale, num_steps=num_steps,
                              fake_annotator=args.fake_annotator)
    strength = getattr(args, "sdedit_denoise_strength", 0.0)
    engine.sampler = make_sampler(
        SAMPLER_NAMES[args.sampler_name], num_steps=num_steps,
        discretization=make_discretization(
            "legacy_ddpm", **({"img2img_strength": strength} if strength > 0 else {})))
    if args.ckpt_path:
        load_reference_checkpoint(engine, load_torch_state_dict(args.ckpt_path))
        for emb in engine.conditioner.embedders:
            if isinstance(emb, AnnotatorEmbedder) and emb.backbone is not None \
                    and not emb.backbone_loaded:
                raise RuntimeError(f"the {emb.kind} annotator has no weights: set ckpt_path in "
                                   f"its embedder params ({CHECKPOINTS[emb.kind]}) or pass "
                                   "--fake_annotator")
    else:
        _randomize(engine, torch.Generator(device=device).manual_seed(args.seed))
    for m in engine.modules:
        m.to(dtype=torch.bfloat16 if args.bf16 else torch.float32).eval()
    return engine, cfg


def _text_encoder(engine):
    return next((e.transformer for e in engine.conditioner.embedders
                 if hasattr(e, "transformer")), None)


def _swapped_modules(engine) -> Dict[str, torch.nn.Module]:
    """The modules a base-model swap loads: the UNet, the VAE and CLIP."""
    mods = {"unet": engine.network.unet, "vae": engine.vae, "clip": _text_encoder(engine)}
    return {k: m for k, m in mods.items() if m is not None}


def apply_basemodel(engine, path: str) -> Dict[str, Dict]:
    """Load a swapped SD base model's spatial UNet, VAE and CLIP text
    encoder, non-strict; the temporal layers, the ControlNets and the
    annotators keep their weights.  Returns each module's report
    (``load_partial``)."""
    print(f"--> load a new base model from {path}")
    sd = load_torch_state_dict(path)
    parts, modules = reference_parts(sd), _swapped_modules(engine)
    unread = len(sd) - sum(len(parts[k]) for k in modules)
    print(f"[basemodel] {unread} of the file's {len(sd)} keys are not the spatial UNet's, the "
          "VAE's or the text encoder's and are not read")
    return {k: load_partial(m, parts[k], f"basemodel {k}") for k, m in modules.items()}


def apply_lora(engine, path: str, strength: float) -> Dict[str, list]:
    """Merge a kohya LoRA into the UNet and the text encoder."""
    print(f"--> load a new LoRA model from {path}")
    return merge_kohya_lora(engine.network.unet, _text_encoder(engine),
                            load_torch_state_dict(path), strength)


def apply_vae(engine, path: str) -> Dict[str, List]:
    """Swap the first-stage VAE (a bare VAE state dict or a full checkpoint's
    ``first_stage_model.``), non-strict."""
    print(f"--> load a new VAE model from {path}")
    sd = load_torch_state_dict(path)
    if any(k.startswith("first_stage_model.") for k in sd):
        sd = sub_state_dict(sd, "first_stage_model.")
    return load_partial(engine.vae, sd, "vae")


def gather_basemodels(args) -> List[str]:
    """The base-model sweep: the list file's paths, the one path, or
    ``["default"]`` (the engine's own weights)."""
    if args.basemodel_listpath:
        return [p.strip() for p in Path(args.basemodel_listpath).read_text().splitlines()
                if p.strip()]
    return [args.basemodel_path] if args.basemodel_path else ["default"]


def make_inpaint_mask(frames: np.ndarray, factor: int = 8) -> np.ndarray:
    """Latent-resolution inpainting mask of the clip: 1 (generate) where it
    is pure white, 0 (keep) elsewhere, from the green channel, area-pooled
    over factor x factor pixels and rounded.  frames (T, H, W, 3) uint8 (or
    in [-1, 1]) -> (1, T, H/f, W/f, 1) float32."""
    white = 255 if frames.dtype == np.uint8 else 1.0 - 1e-6
    px = (frames[..., 1] >= white).astype(np.float32)
    t, h, w = px.shape
    pooled = px.reshape(t, h // factor, factor, w // factor, factor).mean(axis=(2, 4))
    return np.clip(np.round(pooled), 0.0, 1.0)[None, ..., None]


class _Stopwatch:
    """Stage timer; synchronises the device so each stage's work is done.
    With ``launches`` it also records each stage's kernel launches.  Each
    ``stage`` is also a span (``utils/trace.py``: ``ccedit.edit.<name>``)."""

    def __init__(self, device: torch.device, out: Optional[Dict[str, float]],
                 launches: Optional[Dict[str, Dict[str, int]]] = None):
        self.device, self.out, self.launches = device, out, launches
        self.counts = launch_counts()
        self.t = self._now()

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def lap(self, name: str) -> None:
        """Close stage ``name``; a stage that runs again adds to its total."""
        if self.out is not None:
            now = self._now()
            self.out[name] = self.out.get(name, 0.0) + now - self.t
            self.t = now
        if self.launches is not None:
            counts = launch_counts()
            prev = self.launches.get(name, {})
            self.launches[name] = {k: prev.get(k, 0) + n - self.counts.get(k, 0)
                                   for k, n in counts.items()}
            self.counts = counts

    @contextlib.contextmanager
    def stage(self, name: str):
        """Run stage ``name`` inside its span, then ``lap(name)``."""
        with trace.span(trace.EDIT_STAGES[name]):
            yield
        self.lap(name)


def edit_clip(engine, frames_u8: np.ndarray, prompt: str, negative_prompt: str,
              cfg_scale: float, num_steps: int, generator: torch.Generator,
              return_latents: bool = False, **kw):
    """Edit one clip: (T, H, W, 3) uint8 -> (T, H, W, 3) uint8 (and, with
    ``return_latents``, the sampled latents (1, T, h, w, 4) before decoding).
    One draw of ``edit_clips``, whose keywords it takes (``clip_shard``: the
    frames are None on the ranks other than 0)."""
    out, latents = edit_clips(engine, frames_u8, prompt, negative_prompt, cfg_scale,
                              num_steps, generator, **kw)
    frames = None if out is None else out[0]
    return (frames, latents) if return_latents else frames


def _repeat_batch(tree: Dict, n: int) -> Dict:
    """Every tensor of a conditioning dict with a batch axis of 1 repeated
    to ``n`` along it (the JAX pipeline's ``rep``)."""
    return {k: v.repeat_interleave(n, dim=0) if torch.is_tensor(v) and v.dim() > 0
            and v.shape[0] == 1 else v for k, v in tree.items()}


@torch.no_grad()
def edit_clips(engine, frames_u8: np.ndarray, prompt: str, negative_prompt: str,
               cfg_scale: float, num_steps: int, generator: torch.Generator,
               stage_seconds: Optional[Dict[str, float]] = None,
               reference: Optional[np.ndarray] = None, prior_type: str = "ref",
               prior_coefficient_x: float = 0.0, prior_coefficient_noise: float = 1.0,
               stage_launches: Optional[Dict[str, Dict[str, int]]] = None,
               batch_size: int = 1, init_noise: Optional[torch.Tensor] = None,
               loop_noise=None, sdedit: bool = False, inpainting: bool = False,
               clip_shard: bool = False):
    """Edit one clip ``batch_size`` times in one sampler call: (T, H, W, 3)
    uint8 -> (batch_size, T, H, W, 3) uint8 and the sampled latents
    (batch_size, T, h, w, 4) before decoding.  The conditioning is computed
    once and repeated along the batch axis, as the JAX pipeline does;
    ``init_noise`` and ``loop_noise`` replace the sampler's draws
    (``CCEditEngine.sample``).

    ``reference`` (H, W, 3), uint8 or in [-1, 1], is the edited reference
    frame of a TVI2V edit: its VAE latent conditions the appearance branch
    (``cond_img``).  The x-prior, used by a nonzero ``prior_coefficient_x``,
    ``sdedit`` or ``inpainting``, is the clip's latents, or with a reference
    (and no sdedit) the reference latent repeated over T (``prior_type``
    "ref") or the mean of both ("video_ref").  A nonzero
    ``prior_coefficient_x`` starts the chain at ``prior_coefficient_noise *
    noise + prior_coefficient_x * x_prior``; ``sdedit`` (whose schedule the
    engine's sampler prunes, ``load_engine``) starts it at the x-prior
    noised to the first sigma; ``inpainting`` regenerates the clip's white
    areas (``make_inpaint_mask``) and keeps the x-prior elsewhere.

    Stages (timed into ``stage_seconds``, their kernel launches counted into
    ``stage_launches``, when given): ``text`` (CLIP of the prompt and the
    negative prompt), ``hint`` (the structure annotator), ``encode`` (VAE
    encoder: the reference and the x-prior; only when either is used),
    ``sample`` (the ControlNet hint pyramid, once, then the sampler loop) and
    ``decode`` (VAE decode and uint8 quantisation).  The modules carry their
    weights, so unlike the JAX function there is no params argument.

    ``clip_shard`` (under ``torchrun``, every rank calling with the same
    arguments and generator seed): the sample stage runs ONE clip split over
    the ranks (``make_frame_sharded_sample``: the frame axis when T divides
    the world, else the height axis), every rank gets the whole latents, and
    only rank 0 decodes them; the others return None for the frames."""
    if prior_type not in PRIOR_TYPES:
        raise ValueError(f"prior_type {prior_type!r} (one of {PRIOR_TYPES})")
    if sdedit and prior_coefficient_x != 0:
        raise ValueError("prior_coefficient_x should be 0 with sdedit")
    cond = engine.conditioner
    device = next(engine.network.parameters()).device
    watch = _Stopwatch(device, stage_seconds, stage_launches)
    with watch.stage("text"):
        c, uc = cond.get_unconditional_conditioning({"txt": [prompt]},
                                                    {"txt": [negative_prompt]})
    with watch.stage("hint"):
        video = torch.from_numpy(np.ascontiguousarray(frames_u8))[None]
        hint = cond.embed(cond.prepare({"control_hint": video}))
        c.update(hint)
        uc.update(hint)  # the same clip conditions both halves of CFG
    t, h, w = frames_u8.shape[:3]
    x_prior = None
    use_prior = prior_coefficient_x != 0 or sdedit or inpainting
    if reference is not None or use_prior:
        with watch.stage("encode"):
            if reference is not None:
                ref = torch.from_numpy(np.ascontiguousarray(reference))[None]
                feat = cond.embed(cond.prepare({"cond_img": ref}))
                c.update(feat)
                uc.update(feat)
            if use_prior:
                use_ref = reference is not None and not sdedit and prior_type != "video"
                if not use_ref or prior_type == "video_ref":
                    x_prior = engine.encode_first_stage(video.to(device))
                if use_ref:  # the reference latent, repeated over T
                    z_ref = c["cond_feat"].float()[:, None].repeat(1, t, 1, 1, 1)
                    x_prior = z_ref if x_prior is None else 0.5 * (x_prior + z_ref)
    f = engine.latent_factor
    mask = (torch.from_numpy(make_inpaint_mask(frames_u8, f)).to(device) if inpainting
            else None)
    if batch_size > 1:
        c, uc = _repeat_batch(c, batch_size), _repeat_batch(uc, batch_size)
        if x_prior is not None:
            x_prior = x_prior.repeat_interleave(batch_size, dim=0)
        if mask is not None:
            mask = mask.repeat_interleave(batch_size, dim=0)
    shape = (batch_size, t, h // f, w // f, 4)
    kw = dict(generator=generator, init_noise=init_noise, loop_noise=loop_noise,
              guider_scale=cfg_scale, x_prior=x_prior, prior_coefficient=prior_coefficient_x,
              prior_noise_coefficient=prior_coefficient_noise,
              mode="sdedit" if sdedit else "full",
              inpaint_x0=x_prior if inpainting else None, inpaint_mask=mask)
    with watch.stage("sample"):
        if clip_shard:
            call = make_frame_sharded_sample(engine, shape, num_steps)
            latents = gather_clip(call(c, uc, **kw), call.axis)
        else:
            latents = engine.sample(c, uc, shape, num_steps=num_steps, **kw)
    with watch.stage("decode"):
        out = None
        if not clip_shard or process_rank() == 0:
            decoded = engine.decode_first_stage(latents).float()
            if not bool(torch.isfinite(decoded).all()):
                raise FloatingPointError("the decoded clip has non-finite values")
            out = ((decoded + 1.0) * 127.5).clamp(0, 255).to(torch.uint8).cpu().numpy()
    return out, latents


def _ledger(save_dir: Path) -> Dict:
    path = save_dir / "log_info.json"
    return json.loads(path.read_text()) if path.exists() else {}


def _snapshot(engine) -> Dict[str, Dict[str, torch.Tensor]]:
    """Host copies of the weights the swaps change."""
    return {k: {n: v.detach().to("cpu", copy=True) for n, v in m.state_dict().items()}
            for k, m in _swapped_modules(engine).items()}


def _restore(engine, snap: Dict[str, Dict[str, torch.Tensor]]) -> None:
    for k, m in _swapped_modules(engine).items():
        m.load_state_dict(snap[k], strict=True)


def run_pipeline(args, reference_mode: bool = False) -> None:
    """The TV2V CLI loop (the JAX ``run_pipeline``): for each base model of
    the sweep (its outputs and ledger in a subdirectory named after it),
    the swaps (base model, ``--lora_path``, ``--vae_path``) applied before
    its first job, then jobs -> ``edit_clips`` -> mp4/gif + ledger.  With
    ``reference_mode`` (TVI2V) every job also takes the edited reference
    frame ``args.reference_path`` and ``args.prior_type``, and the default
    config is ``TVI2V_CONFIG``."""
    check_args(args)
    engine, _ = load_engine(args, args.sample_steps,
                            TVI2V_CONFIG if reference_mode else TV2V_CONFIG)
    root_dir = Path(args.save_path)
    root_dir.mkdir(parents=True, exist_ok=True)
    gen = torch.Generator(device=torch.device(args.device)).manual_seed(args.seed)
    basemodels = gather_basemodels(args)
    swaps = basemodels != ["default"] or args.lora_path or args.vae_path
    snap = _snapshot(engine) if swaps and len(basemodels) > 1 else None
    for bm_idx, bm_path in enumerate(basemodels):
        print(f"-> base model {bm_idx}: {bm_path}")
        save_dir = root_dir if bm_path == "default" else root_dir / Path(bm_path).stem
        save_dir.mkdir(parents=True, exist_ok=True)
        swapped = False
        for job in gather_jobs(args):
            vid_name = Path(job["video"]).stem
            job_key = f"{vid_name}::{job['prompt']}"
            if not args.disable_check_repeat and job_key in _ledger(save_dir):
                print(f"[skip] {job_key} already done")
                continue
            try:
                frames = load_video_keyframes(job["video"], args.original_fps, args.target_fps,
                                              args.num_keyframes, (args.H, args.W))
            except (IOError, ValueError) as e:  # a bad input skips its job
                print(f"[error] {job_key}: failed to load video: {e}")
                continue
            if not swapped:
                if snap is not None and bm_idx > 0:
                    _restore(engine, snap)
                if bm_path != "default":
                    apply_basemodel(engine, bm_path)
                if args.lora_path:
                    apply_lora(engine, args.lora_path, args.lora_strength)
                if args.vae_path:
                    apply_vae(engine, args.vae_path)
                swapped = True
            prompt = ", ".join(x for x in (args.add_prompt, job["prompt"]) if x)
            extra = dict(prior_coefficient_x=args.prior_coefficient_x,
                         prior_coefficient_noise=args.prior_coefficient_noise,
                         sdedit=args.sdedit_denoise_strength > 0,
                         inpainting=args.inpainting_mode)
            if reference_mode:
                extra.update(reference=load_image(args.reference_path, (args.H, args.W)),
                             prior_type=args.prior_type)
            t0 = time.time()
            # num_samples drawn in chunks of batch_size (the JAX pipeline's loop)
            bs = max(1, min(args.batch_size, args.num_samples))
            outputs, remaining = [], args.num_samples
            while remaining > 0:
                out, _ = edit_clips(engine, frames, prompt, args.negative_prompt, args.cfg_scale,
                                    args.sample_steps, gen, batch_size=bs, **extra)
                outputs.extend(out[:min(bs, remaining)])
                remaining -= bs
            dt = time.time() - t0
            ext = "." + args.save_type
            for i, out in enumerate(outputs):
                save_video_frames(out, str(save_dir / f"{vid_name}_{i:02d}{ext}"),
                                  fps=args.target_fps)
            save_video_frames(frames, str(save_dir / f"{vid_name}_original{ext}"),
                              fps=args.target_fps)
            done = _ledger(save_dir)
            done[job_key] = {"prompt": job["prompt"], "seconds": dt,
                             "num_samples": args.num_samples}
            (save_dir / "log_info.json").write_text(json.dumps(done, indent=1))
            print(f"[done] {job_key}: {args.num_samples} sample(s) in {dt:.1f}s")
