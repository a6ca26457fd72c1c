"""JAX-package parameters -> the port's state dicts.

``from_jax(kind, params)`` is the inverse of
``ccedit_tpu/io/torch_convert.py``'s ``convert_unet`` / ``convert_controlnet``
/ ``convert_vae`` / ``convert_clip``, of ``convert_dpt_midas``, of
``ccedit_tpu/modules/lpips.py::convert_lpips`` (taming's ``vgg.pth`` layout)
and of the NLayerDiscriminator layout (taming's ``main.{i}``): it takes a
flax parameter tree (nested dicts of numpy arrays) and returns a state dict
in the reference sgm/LDM/HF/MiDaS key layout, which the port's modules load
as it is.  Layouts:

  Conv2d kernel (kh, kw, I, O) -> weight (O, I, kh, kw)
  Conv1d kernel (k, I, O)      -> weight (O, I, k)
  Dense kernel  (I, O)         -> weight (O, I)
  Norm scale                   -> weight
  Embed embedding              -> weight

The UNet's ModuleList indices are recovered from the flax module names
(``in_{level}_{n}_res``, ``in_{level}_down``, ``out_{level}_{i}_res``, ...),
so no configuration is needed.  Pure numpy and torch.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

_RES = {
    "in_norm": "in_layers.0", "in_conv": "in_layers.2", "emb_dense": "emb_layers.1",
    "out_norm": "out_layers.0", "out_conv": "out_layers.3", "skip_conv": "skip_connection",
    "in_norm_temporal": "in_layers_temporal.0",
    "in_conv_temporal/conv": "in_layers_temporal.2",
    "out_norm_temporal": "out_layers_temporal.0",
    "out_conv_temporal/conv": "out_layers_temporal.3",
    "skip_conv_temporal/conv": "skip_connection_temporal",
}
_BLOCK = [  # inside a BasicTransformer(SingleLayer)Block
    (r"^(attn[12])/to_out(/|$)", r"\1.to_out.0\2"),
    (r"^ff/net_0/proj(/|$)", r"ff.net.0.proj\1"),
    (r"^ff/net_2(/|$)", r"ff.net.2\1"),
]
_TRANSFORMER = [  # inside a SpatialTransformer(3D)
    (r"^blocks_temporal_ca_0/", "transformer_blocks_temporal_ca.0/"),
    (r"^blocks_temporal_(\d+)/", r"transformer_blocks_temporal.\1/"),
    (r"^blocks_ca_0/", "transformer_blocks_ca.0/"),
    (r"^blocks_(\d+)/", r"transformer_blocks.\1/"),
]
_CONTROLNET_EXTRA = [
    (r"^input_hint_block/conv_out(/|$)", r"input_hint_block.14\1"),
    (r"^zero_convs_temporal_(\d+)/conv(/|$)", r"zero_convs_temporal.\1.0\2"),
    (r"^zero_convs_(\d+)/conv(/|$)", r"zero_convs.\1.0\2"),
    (r"^middle_block_out_temporal/conv(/|$)", r"middle_block_out_temporal.0\1"),
    (r"^middle_block_out/conv(/|$)", r"middle_block_out.0\1"),
]
_VAE = [
    (r"(encoder|decoder)/down_(\d+)_block_(\d+)/", r"\1/down.\2.block.\3/"),
    (r"(encoder|decoder)/down_(\d+)_attn_(\d+)/", r"\1/down.\2.attn.\3/"),
    (r"(encoder|decoder)/down_(\d+)_downsample/", r"\1/down.\2.downsample/"),
    (r"(encoder|decoder)/up_(\d+)_block_(\d+)/", r"\1/up.\2.block.\3/"),
    (r"(encoder|decoder)/up_(\d+)_attn_(\d+)/", r"\1/up.\2.attn.\3/"),
    (r"(encoder|decoder)/up_(\d+)_upsample/", r"\1/up.\2.upsample/"),
    (r"(encoder|decoder)/mid_(block_\d|attn_\d)/", r"\1/mid.\2/"),
]
_CLIP = [
    (r"^token_embedding/embedding$", "embeddings.token_embedding/weight"),
    (r"^position_embedding$", "embeddings.position_embedding/weight"),
    (r"^layers_(\d+)/fc([12])/", r"encoder.layers.\1.mlp.fc\2/"),
    (r"^layers_(\d+)/", r"encoder.layers.\1/"),
]
_DPT = [
    (r"^bit_stem_(conv|norm)(/gn)?/", r"pretrained.model.patch_embed.backbone.stem.\1/"),
    (r"^stage(\d+)_block(\d+)/", r"pretrained.model.patch_embed.backbone.stages.\1.blocks.\2/"),
    (r"/down_(conv|norm)(/gn)?/", r"/downsample.\1/"),
    (r"/(norm\d)/gn/", r"/\1/"),
    (r"^(cls_token|pos_embed)$", r"pretrained.model.\1"),
    (r"^vit_proj/", "pretrained.model.patch_embed.proj/"),
    (r"^block(\d+)/(qkv|proj)/", r"pretrained.model.blocks.\1.attn.\2/"),
    (r"^block(\d+)/(fc\d)/", r"pretrained.model.blocks.\1.mlp.\2/"),
    (r"^block(\d+)/", r"pretrained.model.blocks.\1."),
    (r"^readout(\d)/", r"pretrained.act_postprocess\1.0.project.0/"),
    (r"^neck_proj(\d)/", r"pretrained.act_postprocess\1.3/"),
    (r"^neck_down4/", "pretrained.act_postprocess4.4/"),
    (r"^rn(\d)/", r"scratch.layer\1_rn/"),
    (r"^fusion(\d)/ru(\d)/", r"scratch.refinenet\1.resConfUnit\2."),
    (r"^fusion(\d)/out/", r"scratch.refinenet\1.out_conv/"),
    (r"^head_conv(\d)/", lambda m: f"scratch.output_conv.{2 * int(m[1]) - 2}/"),
]


# VGG16: the JAX conv index -> taming's (slice, torchvision features index)
_VGG_SLICE = (1, 1, 2, 2, 3, 3, 3, 4, 4, 4, 5, 5, 5)
_VGG_INDEX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
_LPIPS = [
    (r"^net/conv_(\d+)/", lambda m: f"net.slice{_VGG_SLICE[int(m[1])]}.{_VGG_INDEX[int(m[1])]}/"),
    (r"^lin_(\d)/", r"lin\1.model.1/"),
]


def _disc_rules(n_layers: int):
    """NLayerDiscriminator: conv_0 -> main.0, conv_n / bn_n -> main.{3n - 1}
    / main.{3n}, head -> main.{3 n_layers + 2}."""
    return [(r"^conv_0/", "main.0/"),
            (r"^conv_(\d+)/", lambda m: f"main.{3 * int(m[1]) - 1}/"),
            (r"^bn_(\d+)/", lambda m: f"main.{3 * int(m[1])}/"),
            (r"^head/", f"main.{3 * n_layers + 2}/")]


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, path + "/"))
        else:
            out[path] = np.asarray(v)
    return out


def _leaf(path: str, value: np.ndarray) -> Tuple[str, np.ndarray]:
    """Map a flax leaf ('.../kernel' etc.) to its torch name and layout."""
    module, _, leaf = path.rpartition("/")
    if leaf == "kernel":
        axes = {4: (3, 2, 0, 1), 3: (2, 1, 0), 2: (1, 0)}[value.ndim]
        value, leaf = np.transpose(value, axes), "weight"
    elif leaf in ("scale", "embedding"):
        leaf = "weight"
    return f"{module}.{leaf}" if module else leaf, value


def _sub(rules, path: str) -> str:
    for pat, rep in rules:
        path = re.sub(pat, rep, path)
    return path


def _unet_index(names) -> Dict[str, str]:
    """flax top-level UNet module name -> sgm module path."""
    out = {"time_embed/dense1": "time_embed.0", "time_embed/dense2": "time_embed.2",
           "label_emb/dense1": "label_emb.0.0", "label_emb/dense2": "label_emb.0.2",
           "conv_in": "input_blocks.0.0", "mid_res1": "middle_block.0",
           "mid_attn": "middle_block.1", "mid_res2": "middle_block.2",
           "input_blocks_temporal/conv": "input_blocks_temporal.0",
           "out_norm": "out.0", "out_conv": "out.2", "out_temporal/conv": "out_temporal.1"}
    enc = sorted({(int(m[1]), int(m[2])) for n in names
                  if (m := re.match(r"in_(\d+)_(\d+)_res$", n))})
    downs = {int(m[1]) for n in names if (m := re.match(r"in_(\d+)_down$", n))}
    idx = 1
    for level in sorted({lv for lv, _ in enc} | downs):
        for lv, nr in enc:
            if lv == level:
                out[f"in_{level}_{nr}_res"] = f"input_blocks.{idx}.0"
                out[f"in_{level}_{nr}_attn"] = f"input_blocks.{idx}.1"
                idx += 1
        if level in downs:
            out[f"in_{level}_down"] = f"input_blocks.{idx}.0"
            idx += 1
    dec = sorted({(int(m[1]), int(m[2])) for n in names
                  if (m := re.match(r"out_(\d+)_(\d+)_res$", n))},
                 key=lambda li: (-li[0], li[1]))
    for j, (level, i) in enumerate(dec):
        out[f"out_{level}_{i}_res"] = f"output_blocks.{j}.0"
        has_attn = f"out_{level}_{i}_attn" in names
        out[f"out_{level}_{i}_attn"] = f"output_blocks.{j}.1"
        if i == max(ii for lv, ii in dec if lv == level):
            out[f"out_{level}_up"] = f"output_blocks.{j}.{2 if has_attn else 1}"
    return out


def _unet_path(path: str, index: Dict[str, str]) -> str:
    parts = path.split("/")
    two = "/".join(parts[:2])  # time_embed/dense1, out_temporal/conv, ...
    head, rest = (two, parts[2:]) if two in index else (parts[0], parts[1:])
    if head not in index:
        raise KeyError(f"unrecognised UNet module {head!r}")
    rest = "/".join(rest)
    if re.match(r"(in_\d+_\d+|out_\d+_\d+|mid)_res\d?$", head) and "/" in rest:
        mod, leaf = rest.rsplit("/", 1)
        rest = f"{_RES.get(mod, mod)}/{leaf}"
    elif re.match(r"(in_\d+_\d+_|out_\d+_\d+_|mid_)attn$", head):
        blk, _, inner = _sub(_TRANSFORMER, rest).partition("/")
        rest = f"{blk}/{_sub(_BLOCK, inner)}" if inner else blk
    elif head.endswith(("_down", "_up")):
        rest = rest.replace("conv_temporal/conv", "conv_temporal")
    return f"{index[head]}/{rest}" if rest else index[head]


def from_jax(kind: str, params: Mapping) -> Dict[str, torch.Tensor]:
    """kind: 'unet' | 'controlnet' | 'vae' | 'clip' | 'dpt' | 'lpips' | 'disc'.
    ``params`` is the flax tree of that module (``{"params": ...}`` is
    unwrapped).  Returns the reference-layout state dict, fp32 torch
    tensors."""
    if "params" in params and len(params) == 1:
        params = params["params"]
    flat = _flatten(params)
    out: Dict[str, torch.Tensor] = {}
    if kind in ("unet", "controlnet"):
        names = {p.split("/")[0] for p in flat}
        index = _unet_index(names)
        for path, value in flat.items():
            if kind == "controlnet" and re.match(
                    r"(input_hint_block|zero_convs|middle_block_out)", path):
                mod = _sub(_CONTROLNET_EXTRA, path)
                mod = re.sub(r"^input_hint_block/conv_(\d)(/|$)",
                             lambda m: f"input_hint_block.{2 * int(m[1])}{m[2]}", mod)
            else:
                mod = _unet_path(path, index)
            name, val = _leaf(mod, value)
            out[name.replace("/", ".")] = torch.from_numpy(np.ascontiguousarray(val))
        return out
    if kind == "disc":
        rules, prefix = _disc_rules(sum(p.startswith("bn_") for p in params)), ""
    else:
        rules, prefix = {"vae": (_VAE, ""), "clip": (_CLIP, "text_model."), "dpt": (_DPT, ""),
                         "lpips": (_LPIPS, "")}[kind]
    for path, value in flat.items():
        name, val = _leaf(_sub(rules, path), value)
        out[prefix + name.replace("/", ".")] = torch.from_numpy(np.ascontiguousarray(val))
    return out
