"""Engine weights: seeded random initialisation and reference checkpoints.

``randomize_weights_`` draws every parameter from an explicit
``torch.Generator`` (weights N(0, 1/fan_in), norm scales 1, biases 0), the
zero-initialised temporal and ControlNet projections included, so that no
branch is trivially zero.  ``load_reference_checkpoint`` loads an SD-1.5 /
CCEdit checkpoint (sgm key layout) into the engine's modules with strict
``load_state_dict`` calls; no converter is involved.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn


@torch.no_grad()
def randomize_weights_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    norm_scales = {id(m.weight) for m in module.modules()
                   if isinstance(m, (nn.GroupNorm, nn.LayerNorm))}
    for p in module.parameters():
        if p.dim() >= 2:
            p.normal_(0.0, p[0].numel() ** -0.5, generator=generator)
        elif id(p) in norm_scales:
            p.fill_(1.0)
        else:
            p.zero_()
    return module


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A .ckpt/.pt/.pth/.safetensors file as a flat {name: tensor}, with
    Lightning ('state_dict') nesting and 'module.' prefixes removed."""
    if str(path).endswith(".safetensors"):
        from safetensors.torch import load_file

        sd = load_file(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if "state_dict" in sd:
            sd = sd["state_dict"]
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}


def _sub(sd: Dict, prefix: str, exclude: Tuple[str, ...] = ()) -> Dict:
    return {k[len(prefix):]: v for k, v in sd.items()
            if k.startswith(prefix) and not k.startswith(exclude)}


def load_reference_checkpoint(engine, sd: Dict[str, torch.Tensor]) -> None:
    """Strict-load the UNet, ControlNet, appearance ControlNet, VAE and CLIP
    sub-dicts of a reference checkpoint (``model.diffusion_model.``,
    ``model.diffusion_model.controlnet.``,
    ``model.diffusion_model.controlnet_img.``, ``first_stage_model.``,
    ``cond_stage_model.transformer.`` or ``conditioner.embedders.0.transformer.``)."""
    net = engine.network
    branches = {"controlnet": "model.diffusion_model.controlnet.",
                "controlnet_img": "model.diffusion_model.controlnet_img."}
    net.unet.load_state_dict(_sub(sd, "model.diffusion_model.",
                                  exclude=tuple(branches.values())), strict=True)
    for name, prefix in branches.items():
        if getattr(net, name) is not None:
            getattr(net, name).load_state_dict(_sub(sd, prefix), strict=True)
    engine.vae.load_reference_state_dict(_sub(sd, "first_stage_model."))
    clip_sd = (_sub(sd, "cond_stage_model.transformer.")
               or _sub(sd, "conditioner.embedders.0.transformer."))
    clip_sd.pop("text_model.embeddings.position_ids", None)
    for embedder in engine.conditioner.embedders:
        if hasattr(embedder, "transformer"):
            embedder.transformer.load_state_dict(clip_sd, strict=True)
