"""Seeded weights in the public checkpoints' layout, made on the device.

The shapes come from the plain reference's modules, built on the ``meta``
device.  One ``normal_`` call fills one flat buffer of every value in the
served dtype; each tensor is a view of it, scaled where it lies:
matrices and kernels N(0, 1/fan_in), GroupNorm and LayerNorm scales
1 + N(0, 0.02^2), biases N(0, 0.02^2), BEiT's layer scales 0.1 and its
relative-position bias tables N(0, 1) (zero layer scales would make each
block the identity).  The last GroupNorm of each BiT bottleneck (the
residual branch's, ``norm3``) gets scales 0.1 (1 + N(0, 0.02^2)), as a
trained ResNet's are small: at unit scales sixteen random bottlenecks
amplify any rounding about 1.2 times each, and the depth hint would read a
bf16 run as a third off.  The DPT head's last conv (``scratch.output_conv.4``,
32 ReLU channels to 1) takes the absolute values of its draws, so that the
depth is positive everywhere, as a trained MiDaS's is: with signed weights
the final ReLU kept 0.1-93 % of the pixels, by seed, and the depth's
rounding read 1.6-8 %.  The same seed
gives the same tensors bit for bit.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn

from .reference import PREFIX, build

Spec = List[Tuple[str, Tuple[int, ...], str]]


def spec(modules: Dict[str, nn.Module]) -> Dict[str, Spec]:
    """(key, shape, kind) of every parameter of each module, in order."""
    out = {}
    for name, mod in modules.items():
        norms = {id(m.weight) for m in mod.modules()
                 if isinstance(m, (nn.GroupNorm, nn.LayerNorm))}
        rows = []
        for key, p in mod.named_parameters():
            if key.endswith(("lambda_1", "lambda_2")):
                kind = "layer_scale"
            elif key.endswith("relative_position_bias_table"):
                kind = "table"
            elif key == "scratch.output_conv.4.weight":
                kind = "positive_matrix"
            elif p.dim() >= 2:
                kind = "matrix"
            elif id(p) in norms:
                kind = "branch_norm" if "backbone.stages." in key and ".norm3." in key else "norm"
            else:
                kind = "bias"
            rows.append((PREFIX[name] + key, tuple(p.shape), kind))
        out[name] = rows
    return out


def config_spec(config: Dict) -> Dict[str, Spec]:
    with torch.device("meta"):
        return spec(build(config))


@torch.no_grad()
def make(specs: Dict[str, Spec], seed: int, device, dtype=torch.bfloat16
         ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{module: {key: tensor}} from ``seed``."""
    rows = [r for name in specs for r in specs[name]]
    total = sum(torch.Size(shape).numel() for _, shape, _ in rows)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(total, dtype=dtype, device=device).normal_(generator=gen)
    out, offset = {}, 0
    for name, entries in specs.items():
        part = out[name] = {}
        for key, shape, kind in entries:
            n = torch.Size(shape).numel()
            v = flat[offset:offset + n].view(shape)
            offset += n
            if kind == "matrix":
                v.mul_(torch.Size(shape[1:]).numel() ** -0.5)
            elif kind == "norm":
                v.mul_(0.02).add_(1.0)
            elif kind == "branch_norm":
                v.mul_(0.002).add_(0.1)
            elif kind == "bias":
                v.mul_(0.02)
            elif kind == "positive_matrix":
                v.abs_().mul_(torch.Size(shape[1:]).numel() ** -0.5)
            elif kind == "layer_scale":
                v.fill_(0.1)
            part[key] = v
    return out
