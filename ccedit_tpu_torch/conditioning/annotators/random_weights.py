"""Seeded random checkpoints of the structure annotators, in each reference
file's own key layout (``sk_model.pth``, ``ControlNetHED.pth``,
``table5_pidinet.pth``, ``scannet.pt``, ``body_pose_model.pth``), for smoke
runs and card tests that have no real weights: ``build_annotator`` reads
them back through the port's loaders as it reads the real files.

Matrices are N(0, gain^2 / fan_in) and vectors N(0, 0.1^2), drawn from an
explicit generator; the per-kind gains keep the activations of a random
network live (HED's input shift is ImageNet-like, its first conv scaled to
inputs in 0..255; NormalBAE's BatchNorm variances positive; the pose
network's heatmap head biased low, so that few peaks pass the detector's
threshold and the host assembly stays small).
"""

from __future__ import annotations

from typing import Dict

import torch

from .hed import ControlNetHED
from .lineart_model import LineartGenerator
from .normalbae import NNET
from .openpose import BodyPoseModel
from .pidinet import PiDiNet

GAINS = {"lineart_model": 1.0, "hed": 1.4, "pidinet": 1.2, "normal_bae": 1.0, "openpose": 1.4}


def _draw(shapes: Dict[str, torch.Size], generator: torch.Generator, gain: float,
          bias: float = 0.1) -> Dict[str, torch.Tensor]:
    out = {}
    for k, shape in shapes.items():
        x = torch.randn(shape, generator=generator, device=generator.device)
        fan_in = max(1, shape[1:].numel()) if len(shape) >= 2 else 1
        out[k] = x * (gain / fan_in ** 0.5) if len(shape) >= 2 else x * bias
    return out


def _shapes(module) -> Dict[str, torch.Size]:
    return {k: v.shape for k, v in module.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def random_checkpoint(family: str, generator: torch.Generator, **sizes) -> Dict:
    """A reference-layout state dict for ``family``: 'lineart_model',
    'hed', 'pidinet', 'normal_bae' (``sizes``: NNET's stem, head, stages,
    up_dims) or 'openpose'.  Tensors on the generator's device."""
    gain = GAINS[family]
    with torch.device("meta"):
        module = {"lineart_model": LineartGenerator, "hed": ControlNetHED, "pidinet": PiDiNet,
                  "normal_bae": NNET, "openpose": BodyPoseModel}[family](**sizes)
    shapes = _shapes(module)
    if family == "pidinet":  # the checkpoint's PDC weights are 3x3, radial ones too
        shapes = {k: (v[:2] + torch.Size((3, 3)) if len(v) == 4 and v[-1] == 5 else v)
                  for k, v in shapes.items()}
    if family == "openpose":
        shapes = {k[len("convs."):]: v for k, v in shapes.items()}
    sd = _draw(shapes, generator, gain, bias=0.02 if family == "openpose" else 0.1)
    if family == "hed":
        sd["norm"] = torch.tensor([120.0, 110.0, 100.0], device=generator.device).view(1, 3, 1, 1)
        sd["block1.convs.0.weight"] = sd["block1.convs.0.weight"] / 60.0
        return {"netNetwork." + k: v for k, v in sd.items()}
    if family == "pidinet":
        return {"state_dict": {"module." + k: v for k, v in sd.items()}}
    if family == "normal_bae":
        for k in sd:
            if k.endswith("running_var"):
                sd[k] = sd[k].abs() + 0.5
            elif sd[k].dim() == 1 and k.endswith(".weight"):
                sd[k] = sd[k] + 1.0
        return {"model": sd}
    if family == "openpose":
        sd["conv1_1.weight"] = sd["conv1_1.weight"] * 4.0
        sd["Mconv7_stage6_L2.bias"] = torch.full_like(sd["Mconv7_stage6_L2.bias"], -0.05)
    return sd
