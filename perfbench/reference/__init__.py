"""The plain reference of a CCEdit edit: ``build(config)`` gives its
modules from a configuration file's reference-format model tree.  Nothing
here imports the program under test or JAX."""

from __future__ import annotations

from typing import Dict

from torch import nn

from .depth import DPTHybrid, ZoeDepth
from .nets import CLIPText, Network, VAE

# each module's prefix in the public checkpoint; the annotator has a file
# of its own (MiDaS's or HF's layout), so no prefix
PREFIX = {"network": "model.diffusion_model.", "vae": "first_stage_model.",
          "clip": "cond_stage_model.transformer.", "annotator": ""}
ANNOTATORS = {"depth_midas": DPTHybrid, "depth_zoe": ZoeDepth}


def build(config: Dict) -> Dict[str, nn.Module]:
    """The network, VAE, CLIP text encoder and depth annotator of a
    configuration file (``model``: the reference-format tree; ``annotator``:
    its hint, with ``annotator_params`` to size it)."""
    p = config["model"]["params"]
    first = p["first_stage_config"]["params"]
    return {"network": Network(p["network_config"]["params"]),
            "vae": VAE(first["ddconfig"], first.get("embed_dim", 4)),
            "clip": CLIPText(**config.get("clip_params", {})),
            "annotator": ANNOTATORS[config["annotator"]](**config.get("annotator_params", {}))}
