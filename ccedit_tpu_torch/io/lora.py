"""Kohya-format LoRA merging (port of ``ccedit_tpu/io/lora.py``).

Kohya names (``lora_unet_down_blocks_0_attentions_1_transformer_blocks_0_
attn1_to_q.lora_down.weight``, ``lora_te_text_model_encoder_layers_3_
self_attn_q_proj...``) are translated to the sgm / HF module names of the
port's UNet and CLIP text model, and merged as ``W += strength * alpha /
rank * up @ down`` (1x1 conv LoRAs squeezed), computed in fp32 and rounded
once to the weight's dtype.  The kohya down/up-block indices are SD-1.5's
(two res blocks a level, attention on levels 0-2), decoded to (level,
block) pairs and then to the UNet's block indices.  Every pair is counted
as merged or skipped, and every skipped name is printed.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

# kohya down_blocks (block, attention) -> (level, res block) and up_blocks
# (block, attention) -> (level, decoder block): kohya counts up_blocks from
# the decoder's top, so up_blocks 1..3 are levels 2..0 of SD-1.5
_DOWN = {(0, 0): (0, 0), (0, 1): (0, 1), (1, 0): (1, 0), (1, 1): (1, 1),
         (2, 0): (2, 0), (2, 1): (2, 1)}
_UP = {(1, 0): (2, 0), (1, 1): (2, 1), (1, 2): (2, 2),
       (2, 0): (1, 0), (2, 1): (1, 1), (2, 2): (1, 2),
       (3, 0): (0, 0), (3, 1): (0, 1), (3, 2): (0, 2)}


def unet_target(key: str, num_res_blocks: int, levels: int) -> str:
    """A kohya UNet key (no ``lora_unet_`` prefix, no suffix) -> the sgm
    module name in a UNet with ``levels`` levels of ``num_res_blocks``
    res blocks.  Raises KeyError on a name it does not know."""
    if key.startswith("mid_block_attentions_0_"):
        base, rest = "middle_block.1", key[len("mid_block_attentions_0_"):]
    else:
        m = re.match(r"(down|up)_blocks_(\d+)_attentions_(\d+)_(.*)", key)
        if not m:
            raise KeyError(key)
        block, rest = (int(m[2]), int(m[3])), m[4]
        if m[1] == "down":
            level, nr = _DOWN[block]
            base = f"input_blocks.{1 + level * (num_res_blocks + 1) + nr}.1"
        else:
            level, i = _UP[block]
            base = f"output_blocks.{(levels - 1 - level) * (num_res_blocks + 1) + i}.1"
    if rest in ("proj_in", "proj_out"):
        return f"{base}.{rest}"
    m = re.fullmatch(r"transformer_blocks_(\d+)_(attn\d)_to_(q|k|v|out_0)", rest)
    if m:
        dst = "to_out.0" if m[3] == "out_0" else f"to_{m[3]}"
        return f"{base}.transformer_blocks.{m[1]}.{m[2]}.{dst}"
    m = re.fullmatch(r"transformer_blocks_(\d+)_ff_net_(0_proj|2)", rest)
    if m:
        return f"{base}.transformer_blocks.{m[1]}.ff.net.{m[2].replace('_', '.')}"
    raise KeyError(key)


def text_target(key: str) -> str:
    """A kohya text-encoder key (no ``lora_te_`` prefix) -> the HF CLIP
    module name."""
    m = re.fullmatch(r"text_model_encoder_layers_(\d+)_(self_attn_(q|k|v|out)_proj|mlp_fc(\d))",
                     key)
    if not m:
        raise KeyError(key)
    if m[3]:
        return f"text_model.encoder.layers.{m[1]}.self_attn.{m[3]}_proj"
    return f"text_model.encoder.layers.{m[1]}.mlp.fc{m[4]}"


def lora_pairs(lora_sd: Dict[str, torch.Tensor]) -> List[Tuple[str, torch.Tensor, float]]:
    """(kohya name, delta = up @ down in fp32, alpha / rank) of every pair."""
    out = []
    for key in lora_sd:
        if not key.endswith(".lora_down.weight"):
            continue
        name = key.split(".")[0]
        down = lora_sd[key].float()
        up = lora_sd[f"{name}.lora_up.weight"].float()
        if down.dim() == 4:  # a 1x1 conv LoRA
            down, up = down.flatten(1), up.flatten(1)
        rank = down.shape[0]
        alpha = float(lora_sd.get(f"{name}.alpha", rank))
        out.append((name, up @ down, alpha / rank))
    return out


@torch.no_grad()
def merge_kohya_lora(unet: nn.Module, text_encoder: Optional[nn.Module],
                     lora_sd: Dict[str, torch.Tensor], strength: float = 0.8
                     ) -> Dict[str, List[str]]:
    """Merge a kohya LoRA into ``unet`` (an sgm-layout UNet with
    ``num_res_blocks`` and ``channel_mult``) and ``text_encoder`` (the
    HF-layout CLIP text model) in place.  Returns the merged and skipped
    kohya names."""
    params = {"lora_unet_": dict(unet.named_parameters()),
              "lora_te_": dict(text_encoder.named_parameters()) if text_encoder else {}}
    merged, skipped = [], []
    for name, delta, alpha_over_rank in lora_pairs(lora_sd):
        prefix = next((p for p in params if name.startswith(p)), None)
        try:
            key = name[len(prefix):] if prefix else ""
            target = (unet_target(key, unet.num_res_blocks, len(unet.channel_mult))
                      if prefix == "lora_unet_" else text_target(key))
        except KeyError:
            skipped.append(name)
            continue
        w = params[prefix].get(f"{target}.weight")
        if w is None or w.shape[:2] != delta.shape or w[0, 0].numel() != 1:
            skipped.append(name)
            continue
        w.copy_((w.float() + (strength * alpha_over_rank) * delta.to(w.device).reshape(w.shape))
                .to(w.dtype))
        merged.append(name)
    print(f"[lora] merged {len(merged)} pairs, skipped {len(skipped)}")
    for name in skipped:
        print(f"  skipped: {name}")
    return {"merged": merged, "skipped": skipped}
