"""TV2V and TVI2V engines from a reference-format config (port of the
TV2V/TVI2V subset of ``ccedit_tpu/config.py``).

The reference wires everything through ``{target: python.path, params:
{...}}`` trees.  This module resolves the targets the port implements and
raises ``KeyError`` naming any other.  ``TV2V_CONFIG`` is the SD-1.5 TV2V
depth-MiDaS configuration (the shape of the reference's
``keyframe_no2ndca_depthmidas`` inference YAML), used when no config file is
given; ``TVI2V_CONFIG`` the reference-guided one of
``keyframe_ref_cp_no2ndca_add_cfca`` as ``bench.py`` builds it: CFCA
centre+self in the UNet, the structure ControlNet, and the appearance
ControlNet fed the VAE latent of the edited centre frame.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional

import torch

from .conditioning.annotators.base import build_annotator
from .conditioning.conditioner import Conditioner, EmbedderSpec
from .conditioning.embedders import CLIPTextEmbedder, IdentityEncoder, VAEEmbedder
from .diffusion import (
    DiscreteDenoiser,
    DPMPP2SAncestralSampler,
    EpsScaling,
    IdentityGuider,
    LegacyDDPMDiscretization,
    VanillaCFG,
)
from .models.engine import CCEditEngine
from .modules.clip import CLIPTextModel
from .modules.controlnet import CCEditNetwork, ControlNet2D
from .modules.unet import UNetModel
from .modules.vae import AutoencoderKL

_SD15_UNET = dict(in_channels=4, out_channels=4, model_channels=320,
                  attention_resolutions=[4, 2, 1], num_res_blocks=2,
                  channel_mult=[1, 2, 4, 4], num_heads=8, transformer_depth=1,
                  context_dim=768, use_linear_in_transformer=False, legacy=False)

TV2V_CONFIG: Dict = {"model": {
    "target": "sgm.models.diffusion.VideoDiffusionEngineTV2V",
    "params": {
        "scale_factor": 0.18215,
        "network_config": {
            "target": "sgm.modules.diffusionmodules.controlmodel.ControlledUNetModel3DTV2V",
            "params": dict(_SD15_UNET, disable_temporal_text_ca=True, controlnet_config={
                "target": "sgm.modules.diffusionmodules.controlmodel.ControlNet2D",
                "params": dict(_SD15_UNET, hint_channels=3)}),
        },
        "denoiser_config": {
            "target": "sgm.modules.diffusionmodules.denoiser.DiscreteDenoiser",
            "params": {"num_idx": 1000,
                       "scaling_config": {"target": "sgm.modules.diffusionmodules.denoiser_scaling.EpsScaling"},
                       "discretization_config": {"target": "sgm.modules.diffusionmodules.discretizer.LegacyDDPMDiscretization"}},
        },
        "conditioner_config": {
            "target": "sgm.modules.GeneralConditioner",
            "params": {"emb_models": [
                {"input_key": "txt", "target": "sgm.modules.encoders.modules.FrozenCLIPEmbedder",
                 "params": {"layer": "last"}},
                {"input_key": "control_hint", "target": "sgm.modules.encoders.modules.DepthMidasEncoder",
                 "params": {}},
            ]},
        },
        "first_stage_config": {
            "target": "sgm.models.autoencoder.AutoencoderKLInferenceWrapper",
            "params": {"embed_dim": 4, "ddconfig": {
                "double_z": True, "z_channels": 4, "resolution": 256, "in_channels": 3,
                "out_ch": 3, "ch": 128, "ch_mult": [1, 2, 4, 4], "num_res_blocks": 2,
                "attn_resolutions": [], "dropout": 0.0}},
        },
    },
}}



def _tvi2v_config() -> Dict:
    cfg = copy.deepcopy(TV2V_CONFIG)
    p = cfg["model"]["params"]
    p["network_config"]["params"].update(
        enable_attention3d_crossframe=True, ST3DCA_ca_type="center_self",
        controlnet_img_config={
            "target": "sgm.modules.diffusionmodules.controlmodel.ControlNet2D",
            "params": dict(_SD15_UNET, hint_channels=4, set_input_hint_block_as_identity=True,
                           no_add_x=True, disable_text_ca=True)})
    p["conditioner_config"]["params"]["emb_models"].append(
        {"input_key": "cond_img", "target": "sgm.modules.encoders.modules.VAEEmbedder",
         "params": {}})
    return cfg


TVI2V_CONFIG: Dict = _tvi2v_config()


def load_config(path: str) -> Dict:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f) or {}


def _tname(cfg: Optional[Dict]) -> str:
    return str((cfg or {}).get("target", "")).rsplit(".", 1)[-1]


def _params(cfg: Optional[Dict]) -> Dict:
    return dict((cfg or {}).get("params") or {})


def _expect(cfg: Optional[Dict], *names: str) -> str:
    name = _tname(cfg)
    if name not in names:
        raise KeyError(f"target {(cfg or {}).get('target')!r} is not implemented by the "
                       f"TV2V port (supported here: {', '.join(names)})")
    return name


def _unet_kwargs(p: Dict, video: bool) -> Dict:
    unported = ["use_linear_in_transformer", "legacy", "use_scale_shift_norm",
                "use_learnable_alpha", "enable_ref_attn"]
    unported += ["disable_text_ca"] if video else ["enable_attention3d_crossframe"]
    for flag in unported:
        if p.get(flag):
            raise KeyError(f"network option {flag}=True is not implemented by the port "
                           f"for a {'pseudo-3D UNet' if video else '2-D ControlNet'}")
    kw = {k: p[k] for k in ("in_channels", "model_channels", "out_channels",
                            "num_res_blocks", "num_heads", "num_head_channels",
                            "transformer_depth", "context_dim", "disable_text_ca",
                            "enable_attention3d_crossframe") if k in p}
    if "ST3DCA_ca_type" in p:
        kw["st3dca_ca_type"] = p["ST3DCA_ca_type"]
    for k in ("attention_resolutions", "channel_mult"):
        if k in p:
            kw[k] = tuple(p[k])
    return kw


def build_controlnet(cfg: Dict) -> ControlNet2D:
    _expect(cfg, "ControlNet2D")
    p = _params(cfg)
    return ControlNet2D(hint_channels=p.get("hint_channels", 3),
                        control_scales=float(p.get("control_scales", 1.0)),
                        no_add_x=bool(p.get("no_add_x", False)),
                        input_hint_identity=bool(p.get("set_input_hint_block_as_identity", False)),
                        **_unet_kwargs(p, video=False))


def build_network(cfg: Dict) -> CCEditNetwork:
    _expect(cfg, "ControlledUNetModel3DTV2V")
    p = _params(cfg)
    unet = UNetModel(unet_type="pseudo-3d",
                     disable_temporal_text_ca=p.get("disable_temporal_text_ca", True),
                     **_unet_kwargs(p, video=True))
    controlnet = build_controlnet(p["controlnet_config"]) if p.get("controlnet_config") else None
    controlnet_img = (build_controlnet(p["controlnet_img_config"])
                      if p.get("controlnet_img_config") else None)
    return CCEditNetwork(unet, controlnet, controlnet_img,
                         crossframe_type=p.get("crossframe_type"))


def build_vae(cfg: Dict) -> AutoencoderKL:
    _expect(cfg, "AutoencoderKL", "AutoencoderKLInferenceWrapper")
    p = _params(cfg)
    dd = p.get("ddconfig", {})
    if dd.get("attn_resolutions"):
        raise KeyError("VAE attn_resolutions is not implemented by the TV2V port")
    return AutoencoderKL(embed_dim=p.get("embed_dim", 4), ch=dd.get("ch", 128),
                         ch_mult=tuple(dd.get("ch_mult", (1, 2, 4, 4))),
                         num_res_blocks=dd.get("num_res_blocks", 2),
                         out_ch=dd.get("out_ch", 3), z_channels=dd.get("z_channels", 4))


def build_conditioner(cfg: Dict, asset_dir: Optional[str] = None,
                      fake_annotator: bool = False) -> Conditioner:
    specs = []
    for emb in _params(cfg).get("emb_models", []):
        name = _expect(emb, "FrozenCLIPEmbedder", "IdentityEncoder", "VAEEmbedder",
                       "DepthMidasEncoder")
        p = _params(emb)
        if name == "FrozenCLIPEmbedder":
            embedder = CLIPTextEmbedder(CLIPTextModel(), asset_dir=asset_dir,
                                        output_layer=p.get("layer", "last"),
                                        layer_idx=p.get("layer_idx"))
        elif name == "IdentityEncoder":
            embedder = IdentityEncoder()
        elif name == "VAEEmbedder":
            embedder = VAEEmbedder()
        else:
            embedder = build_annotator(name, dict(p, fake_annotator=fake_annotator
                                                  or p.get("fake_annotator", False)))
        specs.append(EmbedderSpec(embedder, emb.get("input_key", "txt")))
    return Conditioner(specs)


def build_engine(cfg: Optional[Dict] = None, asset_dir: Optional[str] = None,
                 guider_scale: float = 7.5, num_steps: Optional[int] = None,
                 fake_annotator: bool = False) -> CCEditEngine:
    """CCEditEngine from a reference-format config (``TV2V_CONFIG`` when
    None; ``TVI2V_CONFIG`` for the reference-guided edit).  Modules are
    built on the current default device with PyTorch's default
    initialisation; load or randomise weights afterwards."""
    cfg = copy.deepcopy(cfg if cfg is not None else TV2V_CONFIG)
    model_cfg = cfg.get("model", cfg)
    _expect(model_cfg, "VideoDiffusionEngineTV2V")
    p = _params(model_cfg)
    dcfg = _params(p["denoiser_config"])
    _expect(p["denoiser_config"], "DiscreteDenoiser")
    _expect(dcfg.get("scaling_config"), "EpsScaling")
    _expect(dcfg.get("discretization_config", {"target": "LegacyDDPMDiscretization"}),
            "LegacyDDPMDiscretization")
    denoiser = DiscreteDenoiser(EpsScaling(), num_idx=dcfg.get("num_idx", 1000),
                                discretization=LegacyDDPMDiscretization(
                                    **_params(dcfg.get("discretization_config"))))
    guider = VanillaCFG(scale=guider_scale)
    if "sampler_config" in p:
        scfg = p["sampler_config"]
        _expect(scfg, "DPMPP2SAncestralSampler")
        sp = _params(scfg)
        num_steps = num_steps or sp.get("num_steps")
        gcfg = sp.get("guider_config")
        if gcfg is not None:
            name = _expect(gcfg, "VanillaCFG", "VanillaCFGTV2V", "IdentityGuider")
            guider = (IdentityGuider() if name == "IdentityGuider"
                      else VanillaCFG(scale=_params(gcfg).get("scale", guider_scale)))
    sampler = DPMPP2SAncestralSampler(LegacyDDPMDiscretization(), num_steps=num_steps or 30)
    return CCEditEngine(
        network=build_network(p["network_config"]),
        denoiser=denoiser,
        sampler=sampler,
        conditioner=build_conditioner(p.get("conditioner_config", {}), asset_dir,
                                      fake_annotator),
        vae=build_vae(p["first_stage_config"]),
        guider=guider,
        scale_factor=p.get("scale_factor", 0.18215),
    )
