"""Engine weights: seeded random initialisation and reference checkpoints.

``randomize_weights_`` draws every parameter from an explicit
``torch.Generator`` (weights N(0, 1/fan_in), norm scales 1, biases 0, the
learnable ``alpha_temporal*`` blends U(0.25, 0.75)), the zero-initialised
temporal and ControlNet projections included, so that no branch is
trivially zero.  ``load_reference_checkpoint`` loads an SD-1.5 /
CCEdit checkpoint (sgm key layout) into the engine's modules with strict
``load_state_dict`` calls; no converter is involved.  ``load_partial``
loads what fits of a state dict into a module (the base-model and VAE
swaps) and reports every key it loads, skips or finds mis-shaped.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn


@torch.no_grad()
def randomize_weights_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    norm_scales = {id(m.weight) for m in module.modules()
                   if isinstance(m, (nn.GroupNorm, nn.LayerNorm))}
    for name, p in module.named_parameters():
        if "alpha_temporal" in name:  # learnable blends: both branches live
            p.uniform_(0.25, 0.75, generator=generator)
        elif p.dim() >= 2:
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


def sub_state_dict(sd: Dict, prefix: str, exclude: Tuple[str, ...] = ()) -> Dict:
    return {k[len(prefix):]: v for k, v in sd.items()
            if k.startswith(prefix) and not k.startswith(exclude)}


def reference_parts(sd: Dict[str, torch.Tensor]) -> Dict[str, Dict[str, torch.Tensor]]:
    """A reference checkpoint's sub-dicts by module: ``unet``
    (``model.diffusion_model.`` without the ControlNets), ``controlnet``
    (``model.diffusion_model.controlnet.``), ``controlnet_img``
    (``model.diffusion_model.controlnet_img.``), ``vae``
    (``first_stage_model.``) and ``clip`` (``cond_stage_model.transformer.``
    or ``conditioner.embedders.0.transformer.``, without HF's
    ``position_ids``)."""
    branches = {"controlnet": "model.diffusion_model.controlnet.",
                "controlnet_img": "model.diffusion_model.controlnet_img."}
    parts = {"unet": sub_state_dict(sd, "model.diffusion_model.",
                                    exclude=tuple(branches.values()))}
    parts.update({name: sub_state_dict(sd, prefix) for name, prefix in branches.items()})
    parts["vae"] = sub_state_dict(sd, "first_stage_model.")
    parts["clip"] = (sub_state_dict(sd, "cond_stage_model.transformer.")
                     or sub_state_dict(sd, "conditioner.embedders.0.transformer."))
    parts["clip"].pop("text_model.embeddings.position_ids", None)
    return parts


def load_reference_checkpoint(engine, sd: Dict[str, torch.Tensor]) -> None:
    """Strict-load the UNet, ControlNet, appearance ControlNet, VAE and CLIP
    sub-dicts of a reference checkpoint (``reference_parts``)."""
    net, parts = engine.network, reference_parts(sd)
    net.unet.load_state_dict(parts["unet"], strict=True)
    for name in ("controlnet", "controlnet_img"):
        if getattr(net, name) is not None:
            getattr(net, name).load_state_dict(parts[name], strict=True)
    if engine.vae is not None:
        engine.vae.load_reference_state_dict(parts["vae"])
    for i, embedder in enumerate(engine.conditioner.embedders):
        if hasattr(embedder, "transformer"):
            embedder.transformer.load_state_dict(parts["clip"], strict=True)
        elif type(embedder).__name__ == "OpenCLIPTextEmbedder":  # SD 2.x's text tower
            from ..modules.openclip import load_openclip_text

            text = (sub_state_dict(sd, "cond_stage_model.model.")
                    or sub_state_dict(sd, f"conditioner.embedders.{i}.model."))
            if text:
                load_openclip_text(embedder.model, text)


@torch.no_grad()
def load_partial(module: nn.Module, sd: Dict[str, torch.Tensor], label: str
                 ) -> Dict[str, List]:
    """Non-strict load: each key of ``sd`` that ``module`` has at the same
    shape is copied in (cast to the module's dtype); the rest are skipped
    (unknown to the module) or mis-shaped, and the module's keys ``sd``
    lacks keep their values.  Prints the counts and every skipped and
    mis-shaped key; returns the four lists."""
    own = module.state_dict()
    loaded, skipped, mismatched = [], [], []
    for k, v in sd.items():
        if k not in own:
            skipped.append(k)
        elif own[k].shape != v.shape:
            mismatched.append((k, tuple(v.shape), tuple(own[k].shape)))
        else:
            own[k].copy_(v)
            loaded.append(k)
    kept = [k for k in own if k not in sd]
    print(f"[{label}] loaded {len(loaded)}/{len(own)} tensors; {len(kept)} kept their values; "
          f"{len(skipped)} skipped; {len(mismatched)} shape-mismatched")
    for k in skipped:
        print(f"  skipped: {k}")
    for k, theirs, ours in mismatched:
        print(f"  shape mismatch: {k} {theirs} (module {ours})")
    return {"loaded": loaded, "kept": kept, "skipped": skipped, "mismatched": mismatched}
