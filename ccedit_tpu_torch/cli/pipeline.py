"""TV2V and TVI2V inference pipeline (port of ``ccedit_tpu/cli/pipeline.py``).

``edit_clip`` is the per-job body: conditioning, sampling and the uint8
decode of one clip, with an optional edited reference frame (TVI2V) and the
x-prior mix.  ``run_pipeline`` wraps it with the same flag surface
(``base_parser``), job gathering, ``log_info.json`` resume ledger and saving;
``reference_mode=True`` is the TVI2V CLI (``sampling_tv2v_ref``).  Of the
JAX pipeline's options the base-model sweep, LoRA, VAE swap, sdedit and
inpainting raise ``NotImplementedError``.  Clip height and width must be
multiples of 64 (an odd latent geometry cannot round-trip the UNet's
down/up skips); the shape bucket grid and the TPU compile workarounds are
not ported.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..conditioning.annotators.base import AnnotatorEmbedder
from ..config import TV2V_CONFIG, TVI2V_CONFIG, build_engine, load_config
from ..data.video import load_image, load_video_keyframes, save_video_frames
from ..io.checkpoint import load_reference_checkpoint, load_torch_state_dict, randomize_weights_
from ..ops.attention import launch_counts

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
                   choices=["DPMPP2SAncestralSampler"])
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


def _reject_unported(args) -> None:
    unported = {
        "--basemodel_path/--basemodel_listpath": args.basemodel_path or args.basemodel_listpath,
        "--lora_path": args.lora_path,
        "--vae_path": args.vae_path,
        "--sdedit_denoise_strength": args.sdedit_denoise_strength > 0,
        "--inpainting_mode": args.inpainting_mode,
    }
    used = [k for k, v in unported.items() if v]
    if used:
        raise NotImplementedError(f"{', '.join(used)}: not ported yet")
    if args.H % 64 or args.W % 64:
        raise ValueError(f"--H/--W must be multiples of 64, got {args.H}x{args.W}")


def load_engine(args, num_steps: int, default_config=TV2V_CONFIG):
    """The engine on ``args.device`` with checkpoint or seeded random weights
    (``default_config`` when no ``--config_path``).  With a checkpoint, a
    depth annotator needs its own weights (``ckpt_path`` in its embedder
    params) or ``--fake_annotator``."""
    cfg = load_config(args.config_path) if args.config_path else default_config
    device = torch.device(args.device)
    with device:
        engine = build_engine(cfg, asset_dir=args.tokenizer_assets or None,
                              guider_scale=args.cfg_scale, num_steps=num_steps,
                              fake_annotator=args.fake_annotator)
    modules = (engine.network, engine.vae, engine.conditioner)
    if args.ckpt_path:
        load_reference_checkpoint(engine, load_torch_state_dict(args.ckpt_path))
        for emb in engine.conditioner.embedders:
            if isinstance(emb, AnnotatorEmbedder) and emb.backbone is not None \
                    and not emb.backbone_loaded:
                raise RuntimeError("the DPT-Hybrid depth annotator has no weights: set "
                                   "ckpt_path in its embedder params "
                                   "(dpt_hybrid-midas-501f0c75.pt) or pass --fake_annotator")
    else:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        for m in modules:
            randomize_weights_(m, gen)
    for m in modules:
        m.to(dtype=torch.bfloat16 if args.bf16 else torch.float32).eval()
    return engine, cfg


class _Stopwatch:
    """Stage timer; synchronises the device so each stage's work is done.
    With ``launches`` it also records each stage's kernel launches."""

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
        if self.out is not None:
            now = self._now()
            self.out[name] = now - self.t
            self.t = now
        if self.launches is not None:
            counts = launch_counts()
            self.launches[name] = {k: n - self.counts.get(k, 0) for k, n in counts.items()}
            self.counts = counts


def edit_clip(engine, frames_u8: np.ndarray, prompt: str, negative_prompt: str,
              cfg_scale: float, num_steps: int, generator: torch.Generator,
              stage_seconds: Optional[Dict[str, float]] = None,
              reference: Optional[np.ndarray] = None, prior_type: str = "ref",
              prior_coefficient_x: float = 0.0, prior_coefficient_noise: float = 1.0,
              stage_launches: Optional[Dict[str, Dict[str, int]]] = None,
              return_latents: bool = False):
    """Edit one clip: (T, H, W, 3) uint8 -> (T, H, W, 3) uint8 (and, with
    ``return_latents``, the sampled latents (1, T, h, w, 4) before decoding).
    One draw of ``edit_clips``; the arguments are its."""
    out, latents = edit_clips(engine, frames_u8, prompt, negative_prompt, cfg_scale,
                              num_steps, generator, stage_seconds=stage_seconds,
                              reference=reference, prior_type=prior_type,
                              prior_coefficient_x=prior_coefficient_x,
                              prior_coefficient_noise=prior_coefficient_noise,
                              stage_launches=stage_launches)
    return (out[0], latents) if return_latents else out[0]


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
               loop_noise: Optional[torch.Tensor] = None):
    """Edit one clip ``batch_size`` times in one sampler call: (T, H, W, 3)
    uint8 -> (batch_size, T, H, W, 3) uint8 and the sampled latents
    (batch_size, T, h, w, 4) before decoding.  The conditioning is computed
    once and repeated along the batch axis, as the JAX pipeline does;
    ``init_noise`` and ``loop_noise`` replace the sampler's draws
    (``CCEditEngine.sample``).

    ``reference`` (H, W, 3), uint8 or in [-1, 1], is the edited reference
    frame of a TVI2V edit: its VAE latent conditions the appearance branch
    (``cond_img``).  A nonzero ``prior_coefficient_x`` starts the chain at
    ``prior_coefficient_noise * noise + prior_coefficient_x * x_prior``,
    with x_prior the clip's latents (``prior_type`` "video"), the reference
    latent repeated over T ("ref") or their mean ("video_ref"); without a
    reference it is the clip's latents.

    Stages (timed into ``stage_seconds``, their kernel launches counted into
    ``stage_launches``, when given): ``text`` (CLIP of the prompt and the
    negative prompt), ``hint`` (the structure annotator), ``encode`` (VAE
    encoder: the reference and the x-prior; only when either is used),
    ``sample`` (the ControlNet hint pyramid, once, then the sampler loop) and
    ``decode`` (VAE decode and uint8 quantisation).  The modules carry their
    weights, so unlike the JAX function there is no params argument."""
    if prior_type not in PRIOR_TYPES:
        raise ValueError(f"prior_type {prior_type!r} (one of {PRIOR_TYPES})")
    cond = engine.conditioner
    device = next(engine.network.parameters()).device
    watch = _Stopwatch(device, stage_seconds, stage_launches)
    c, uc = cond.get_unconditional_conditioning({"txt": [prompt]}, {"txt": [negative_prompt]})
    watch.lap("text")
    video = torch.from_numpy(np.ascontiguousarray(frames_u8))[None]
    hint = cond.embed(cond.prepare({"control_hint": video}))
    c.update(hint)
    uc.update(hint)  # the same clip conditions both halves of CFG
    watch.lap("hint")
    t, h, w = frames_u8.shape[:3]
    x_prior = None
    if reference is not None or prior_coefficient_x != 0:
        if reference is not None:
            ref = torch.from_numpy(np.ascontiguousarray(reference))[None]
            feat = cond.embed(cond.prepare({"cond_img": ref}))
            c.update(feat)
            uc.update(feat)
        if prior_coefficient_x != 0:
            use_ref = reference is not None and prior_type != "video"
            if not use_ref or prior_type == "video_ref":
                x_prior = engine.encode_first_stage(video.to(device))
            if use_ref:  # the reference latent, repeated over T
                z_ref = c["cond_feat"].float()[:, None].repeat(1, t, 1, 1, 1)
                x_prior = z_ref if x_prior is None else 0.5 * (x_prior + z_ref)
        watch.lap("encode")
    f = engine.latent_factor
    if batch_size > 1:
        c, uc = _repeat_batch(c, batch_size), _repeat_batch(uc, batch_size)
        if x_prior is not None:
            x_prior = x_prior.repeat_interleave(batch_size, dim=0)
    latents = engine.sample(c, uc, (batch_size, t, h // f, w // f, 4), num_steps=num_steps,
                            generator=generator, init_noise=init_noise, loop_noise=loop_noise,
                            guider_scale=cfg_scale, x_prior=x_prior,
                            prior_coefficient=prior_coefficient_x,
                            prior_noise_coefficient=prior_coefficient_noise)
    watch.lap("sample")
    decoded = engine.decode_first_stage(latents).float()
    if not bool(torch.isfinite(decoded).all()):
        raise FloatingPointError("the decoded clip has non-finite values")
    out = ((decoded + 1.0) * 127.5).clamp(0, 255).to(torch.uint8).cpu().numpy()
    watch.lap("decode")
    return out, latents


def _ledger(save_dir: Path) -> Dict:
    path = save_dir / "log_info.json"
    return json.loads(path.read_text()) if path.exists() else {}


def run_pipeline(args, reference_mode: bool = False) -> None:
    """The TV2V CLI loop: jobs -> ``edit_clip`` -> mp4/gif + ledger.  With
    ``reference_mode`` (TVI2V) every job also takes the edited reference
    frame ``args.reference_path`` and ``args.prior_type``, and the default
    config is ``TVI2V_CONFIG``."""
    _reject_unported(args)
    engine, _ = load_engine(args, args.sample_steps,
                            TVI2V_CONFIG if reference_mode else TV2V_CONFIG)
    save_dir = Path(args.save_path)
    save_dir.mkdir(parents=True, exist_ok=True)
    gen = torch.Generator(device=torch.device(args.device)).manual_seed(args.seed)
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
        prompt = ", ".join(x for x in (args.add_prompt, job["prompt"]) if x)
        extra = dict(prior_coefficient_x=args.prior_coefficient_x,
                     prior_coefficient_noise=args.prior_coefficient_noise)
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
            save_video_frames(out, str(save_dir / f"{vid_name}_{i:02d}{ext}"), fps=args.target_fps)
        save_video_frames(frames, str(save_dir / f"{vid_name}_original{ext}"), fps=args.target_fps)
        done = _ledger(save_dir)
        done[job_key] = {"prompt": job["prompt"], "seconds": dt, "num_samples": args.num_samples}
        (save_dir / "log_info.json").write_text(json.dumps(done, indent=1))
        print(f"[done] {job_key}: {args.num_samples} sample(s) in {dt:.1f}s")
