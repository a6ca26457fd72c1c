"""2-D txt2img / img2img CLI (port of ``ccedit_tpu/cli/sampling_image.py``).

    python -m ccedit_tpu_torch.cli.sampling_image --config_path sd21_768 \\
        --H 768 --W 768 --prompt "a red fox in snow" --bf16 [--init_image frame.png]

``--config_path`` is a reference-format YAML or the name of a built-in
config (``config.BUILTIN_CONFIGS``: ``sd21_768`` is SD-2.1-768-v).  Without
``--ckpt_path`` the weights are seeded random ones.  The session
(``build_image_session``) is built once and kept warm by the web demo
(``cli/demo.py``), which drives the same ``sample_images``.  txt2img draws
from noise; ``--init_image`` (a PNG, ``data/video.py::load_image``)
runs img2img: its VAE latent noised onto the strength-pruned schedule
(``mode="sdedit"``).  A pseudo-3D (video) config samples a one-frame clip,
which ``cli/auto_pipeline.py`` uses to edit a clip's centre frame with the
TVI2V config.  Outputs may pass the DeepFloyd safety filter
(``--safety_clip_ckpt``/``--safety_heads_dir``) and the invisible
watermark (``--watermark``); images are written as PNG by the port's own
writer.

The JAX CLI caches one jitted program per request structure without bound;
the port compiles nothing per request, and the one per-request object it
keeps, the sampler of a (sampler, steps, discretization, strength) key, is
held in an ``LRU`` of ``SAMPLER_CACHE`` entries.
"""

from __future__ import annotations

import argparse
import collections
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..config import SAMPLER_NAMES, SD21_768_CONFIG
from ..data.video import load_image, to_uint8, write_png
from ..diffusion import make_discretization, make_sampler
from ..diffusion.guidance import IdentityGuider, VanillaCFG
from .pipeline import _Stopwatch, apply_lora, apply_vae, load_engine

DISCRETIZATION_NAMES = ("legacy_ddpm", "edm")
GUIDER_NAMES = ("VanillaCFG", "IdentityGuider")
SAMPLER_CACHE = 8  # samplers a session keeps


class LRU(collections.OrderedDict):
    """A mapping that keeps its ``maxsize`` most recently used entries."""

    def __init__(self, maxsize: int):
        super().__init__()
        self.maxsize = maxsize

    def get_or_make(self, key, make):
        if key in self:
            self.move_to_end(key)
            return self[key]
        value = self[key] = make()
        while len(self) > self.maxsize:
            self.popitem(last=False)
        return value


def add_image_args(p: argparse.ArgumentParser,
                   config_required: bool = True) -> argparse.ArgumentParser:
    """The JAX CLI's flag surface, plus ``--device``."""
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--config_path", type=str, required=config_required, default="",
                   help="reference-format YAML or a built-in config name (sd21_768, tvi2v, ...)")
    p.add_argument("--ckpt_path", type=str, default="")
    p.add_argument("--lora_path", type=str, default="")
    p.add_argument("--lora_strength", type=float, default=0.8)
    p.add_argument("--vae_path", type=str, default="")
    p.add_argument("--prompt", type=str, default="a professional photograph")
    p.add_argument("--negative_prompt", type=str, default="")
    p.add_argument("--init_image", type=str, default="", help="img2img source (PNG)")
    p.add_argument("--img2img_strength", type=float, default=0.75)
    p.add_argument("--H", type=int, default=512)
    p.add_argument("--W", type=int, default=512)
    p.add_argument("--sample_steps", type=int, default=40)
    p.add_argument("--sampler_name", type=str, default="EulerEDMSampler",
                   choices=sorted(SAMPLER_NAMES))
    p.add_argument("--discretization", type=str, default="legacy_ddpm",
                   choices=DISCRETIZATION_NAMES)
    p.add_argument("--guider", type=str, default="VanillaCFG", choices=GUIDER_NAMES)
    p.add_argument("--cfg_scale", type=float, default=7.5)
    p.add_argument("--num_samples", type=int, default=1)
    p.add_argument("--save_path", type=str, default="outputs/demo/txt2img")
    p.add_argument("--tokenizer_assets", type=str, default="")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--fake_annotator", action="store_true",
                   help="allow pseudo-depth stand-ins for weightless annotators")
    p.add_argument("--watermark", action="store_true",
                   help="embed the SDV2 invisible watermark in outputs")
    p.add_argument("--safety_clip_ckpt", type=str, default="",
                   help="CLIP ViT-L visual ckpt for the DeepFloyd filter")
    p.add_argument("--safety_heads_dir", type=str, default="",
                   help="directory with p_head_v1.npz / w_head_v1.npz")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; the CUDA kernels need 'cuda'")
    return p


@dataclass
class ImageSession:
    """A loaded model the demo keeps warm across requests."""

    engine: Any
    video_mode: bool
    samplers: LRU = field(default_factory=lambda: LRU(SAMPLER_CACHE))

    @property
    def latent_factor(self) -> int:
        return self.engine.latent_factor

    @property
    def device(self) -> torch.device:
        return next(self.engine.network.parameters()).device


def build_image_session(args) -> ImageSession:
    """The engine of ``args.config_path`` (SD-2.1-768 when empty) on
    ``args.device`` with checkpoint or seeded random weights
    (``pipeline.load_engine``), then the ``--lora_path`` and
    ``--vae_path`` swaps."""
    engine, _ = load_engine(args, args.sample_steps, SD21_768_CONFIG)
    if args.lora_path:
        apply_lora(engine, args.lora_path, args.lora_strength)
    if args.vae_path:
        apply_vae(engine, args.vae_path)
    return ImageSession(engine=engine, video_mode=engine.network.unet.is_video)


def _make_batches(engine, args):
    """The conditioner's inputs: the prompts, and for a video config's
    extra inputs (``control_hint``, ``cond_img``) the init image, or black
    frames, so any shipped config runs in 2-D mode."""
    batch: Dict[str, Any] = {"txt": [args.prompt]}
    batch_uc: Dict[str, Any] = {"txt": [args.negative_prompt]}
    src = load_image(args.init_image, (args.H, args.W)) if args.init_image else None
    img = src if src is not None else np.zeros((args.H, args.W, 3), np.float32) - 1.0
    for spec in engine.conditioner.specs:
        if spec.input_key == "control_hint":
            batch["control_hint"] = batch_uc["control_hint"] = img[None, None]
        elif spec.input_key == "cond_img":
            batch["cond_img"] = batch_uc["cond_img"] = img[None]
    return batch, batch_uc


def configure_sampler(engine, args, cache: Optional[LRU] = None) -> None:
    """Install the request's sampler (its discretization pruned to
    ``--img2img_strength`` for an init image) and guider; with ``cache``,
    one sampler per (sampler, steps, discretization, strength)."""
    strength = args.img2img_strength if args.init_image else None
    key = (args.sampler_name, args.sample_steps, args.discretization, strength)

    def make():
        return make_sampler(
            SAMPLER_NAMES[args.sampler_name], num_steps=args.sample_steps,
            discretization=make_discretization(
                args.discretization, **({"img2img_strength": strength} if strength else {})))

    engine.sampler = cache.get_or_make(key, make) if cache is not None else make()
    engine.guider = (IdentityGuider() if args.guider == "IdentityGuider"
                     else VanillaCFG(scale=args.cfg_scale))


def _filters(args, device: torch.device):
    sample_filter = watermarker = None
    if args.safety_clip_ckpt or args.safety_heads_dir:
        from ..utils.safety import DeepFloydDataFiltering

        heads = Path(args.safety_heads_dir) if args.safety_heads_dir else None
        sample_filter = DeepFloydDataFiltering.from_files(
            clip_ckpt=args.safety_clip_ckpt or None,
            p_head_path=str(heads / "p_head_v1.npz") if heads else None,
            w_head_path=str(heads / "w_head_v1.npz") if heads else None, device=device)
    if args.watermark:
        from ..utils.watermark import WatermarkEmbedder

        watermarker = WatermarkEmbedder()
    return sample_filter, watermarker


@torch.no_grad()
def sample_images(session: ImageSession, args, save_dir: Optional[Path] = None,
                  noise: Optional[List[Dict[str, torch.Tensor]]] = None,
                  stage_seconds: Optional[Dict[str, float]] = None,
                  stage_launches: Optional[Dict[str, Dict[str, int]]] = None) -> List[np.ndarray]:
    """txt2img (img2img when ``args.init_image`` is set): ``args.num_samples``
    uint8 (H, W, 3) images, each also saved as ``sample_NNN.png`` under
    ``save_dir`` when it is given.  Each sample draws its start and step
    noise from a generator seeded with ``args.seed``, or takes sample i's
    from ``noise[i]`` (``{"init": ..., "loop": ...}``, as
    ``CCEditEngine.sample``'s ``init_noise`` and ``loop_noise``).  Stages
    (timed into ``stage_seconds``, their kernel launches counted into
    ``stage_launches``, when given, summed over the samples): ``text``,
    ``encode`` (img2img's VAE encoder), ``sample``, ``decode`` (the VAE
    decoder, filters and the host copy)."""
    engine = session.engine
    watch = _Stopwatch(session.device, stage_seconds, stage_launches)
    configure_sampler(engine, args, session.samplers)
    with watch.stage("text"):
        batch, batch_uc = _make_batches(engine, args)
        c, uc = engine.conditioner.get_unconditional_conditioning(batch, batch_uc)
    if save_dir is not None:
        save_dir.mkdir(parents=True, exist_ok=True)
    sample_filter, watermarker = _filters(args, session.device)
    f = session.latent_factor
    channels = engine.network.unet.in_channels
    z_shape = ((1, 1) if session.video_mode else (1,)) + (args.H // f, args.W // f, channels)
    x_prior = None
    if args.init_image:
        with watch.stage("encode"):
            img = torch.from_numpy(load_image(args.init_image, (args.H, args.W))[None])
            x_prior = engine.encode_first_stage(
                (img[None] if session.video_mode else img).to(session.device))
    gen = torch.Generator(device=session.device).manual_seed(args.seed)
    outputs: List[np.ndarray] = []
    for i in range(args.num_samples):
        t0 = time.time()
        drawn = noise[i] if noise is not None else {}
        with watch.stage("sample"):
            lat = engine.sample(c, uc, z_shape, generator=gen, init_noise=drawn.get("init"),
                                loop_noise=drawn.get("loop"), guider_scale=args.cfg_scale,
                                x_prior=x_prior, mode="sdedit" if x_prior is not None else "full")
        with watch.stage("decode"):
            img = engine.decode_first_stage(lat).float()
            if session.video_mode:
                img = img[:, 0]
            img01 = (img.clamp(-1.0, 1.0) + 1.0) / 2.0
            if sample_filter is not None:
                img01 = sample_filter(img01)
            img01 = img01.cpu().numpy()
            if watermarker is not None:
                img01 = watermarker(img01)
            out = to_uint8(img01[0] * 2.0 - 1.0)
        outputs.append(out)
        if save_dir is not None:
            write_png(str(save_dir / f"sample_{i:03d}.png"), out)
            print(f"[done] sample {i}: {time.time() - t0:.1f}s -> "
                  f"{save_dir}/sample_{i:03d}.png")
    return outputs


def main(argv=None):
    args = add_image_args(argparse.ArgumentParser()).parse_args(argv)
    session = build_image_session(args)
    return sample_images(session, args, save_dir=Path(args.save_path))


if __name__ == "__main__":
    main()
