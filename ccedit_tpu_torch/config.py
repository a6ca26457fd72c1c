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
``TV2V_TRAIN_CONFIG`` is the TV2V training recipe (the shape of the
reference's ``sd_1_5_controlldm-test-tv2v-depthmidas.yaml``): the TV2V
network with ``use_checkpoint``, the depth-MiDaS conditioner with text
dropout, ``StandardDiffusionLoss`` with ``DiscreteSampling`` and eps
weighting, ``freeze_model: spatial``, base LR 1e-4 with a
``LambdaLinearScheduler`` warm-up, and its data: batch 4 of 12-frame clips
at 384x512.  ``VAE_TRAIN_CONFIG`` is the SD KL-f8 autoencoder's GAN
fine-tune in the layout of the reference's autoencoder training YAMLs
(``model.params.encoder_config`` / ``loss_config``), which
``build_autoencoder_engine`` reads.
"""

from __future__ import annotations

import copy
import json
from typing import Dict, Optional, Sequence

import torch

from .conditioning.annotators.base import build_annotator
from .conditioning.conditioner import Conditioner, EmbedderSpec
from .conditioning.embedders import CLIPTextEmbedder, IdentityEncoder, VAEEmbedder
from .diffusion import (
    DiscreteDenoiser,
    DiscreteSampling,
    DPMPP2SAncestralSampler,
    EDMSampling,
    EpsScaling,
    IdentityGuider,
    LegacyDDPMDiscretization,
    StandardDiffusionLoss,
    VanillaCFG,
)
from .diffusion.weighting import EDMWeighting, EpsWeighting, UnitWeighting, VWeighting
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


def _tv2v_train_config() -> Dict:
    cfg = copy.deepcopy(TV2V_CONFIG)
    p = cfg["model"]["params"]
    net = p["network_config"]["params"]
    net["use_checkpoint"] = True
    net["controlnet_config"]["params"]["use_checkpoint"] = True
    p["denoiser_config"]["params"]["weighting_config"] = {
        "target": "sgm.modules.diffusionmodules.denoiser_weighting.EpsWeighting"}
    p["conditioner_config"]["params"]["emb_models"][0]["ucg_rate"] = 0.1
    p.update(
        freeze_model="spatial",
        base_learning_rate=1e-4,
        loss_fn_config={
            "target": "sgm.modules.diffusionmodules.loss.StandardDiffusionLoss",
            "params": {"sigma_sampler_config": {
                "target": "sgm.modules.diffusionmodules.sigma_sampling.DiscreteSampling",
                "params": {"num_idx": 1000, "discretization_config": {
                    "target": "sgm.modules.diffusionmodules.discretizer.LegacyDDPMDiscretization"}}}},
        },
        scheduler_config={
            "target": "sgm.lr_scheduler.LambdaLinearScheduler",
            "params": {"warm_up_steps": [100], "cycle_lengths": [10000000000000],
                       "f_start": [1e-6], "f_max": [1.0], "f_min": [1.0]},
        },
    )
    cfg["data"] = {"params": {"batch_size": 4, "train": {"params": {
        "video_length": 12, "resolution": [384, 512]}}}}
    return cfg


TV2V_TRAIN_CONFIG: Dict = _tv2v_train_config()

# The SD KL-f8 autoencoder (the edits' VAE: ch 128, ch_mult 1,2,4,4, 2 res
# blocks, 4 latent channels, no attention but the mid blocks') with a full
# VGG16 LPIPS and the n_layers = 3, ndf = 64 PatchGAN, in the reference's
# autoencoder-YAML layout.  The loss is LDM's ``autoencoder_kl_32x32x4``
# recipe (LPIPSWithDiscriminator: KL weight 1e-6, disc_weight 0.5, the GAN
# from step 50001, LR 4.5e-6); the data is the public sd-vae-ft-mse
# fine-tune's, by its model card: 256x256 images, 12 per GPU.
VAE_TRAIN_CONFIG: Dict = {
    "model": {
        "target": "sgm.models.autoencoder.AutoencodingEngine",
        "base_learning_rate": 4.5e-6,
        "params": {
            "input_key": "jpg",
            "encoder_config": {
                "target": "sgm.modules.diffusionmodules.model.Encoder",
                "params": {"double_z": True, "z_channels": 4, "resolution": 256,
                           "in_channels": 3, "out_ch": 3, "ch": 128, "ch_mult": [1, 2, 4, 4],
                           "num_res_blocks": 2, "attn_resolutions": [], "dropout": 0.0}},
            "regularizer_config": {
                "target": "sgm.modules.autoencoding.regularizers.DiagonalGaussianRegularizer"},
            "loss_config": {
                "target": "sgm.modules.autoencoding.losses.GeneralLPIPSWithDiscriminator",
                "params": {"disc_start": 50001, "disc_weight": 0.5, "disc_num_layers": 3,
                           "disc_in_channels": 3, "disc_factor": 1.0, "perceptual_weight": 1.0,
                           "disc_loss": "hinge", "regularization_weights": {"kl_loss": 1e-6}}},
        },
    },
    "data": {"params": {"batch_size": 12, "train": {"params": {"resolution": [256, 256]}}}},
}


def load_config(path: str) -> Dict:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f) or {}


def deep_merge(base: Dict, over: Dict) -> Dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = deep_merge(out[k], v) if isinstance(out.get(k), dict) and isinstance(v, dict) else v
    return out


def _parse_value(text: str):
    """A dotlist value: YAML when PyYAML is installed, else JSON, else the
    string itself."""
    try:
        import yaml

        return yaml.safe_load(text)
    except ImportError:
        pass
    except Exception:
        return text
    try:
        return json.loads(text)
    except ValueError:
        return text


def apply_dotlist(cfg: Dict, overrides: Sequence[str]) -> Dict:
    """OmegaConf-style ``a.b.c=value`` overrides; integer segments index
    lists (``...emb_models.1.params.fake_annotator=true``)."""
    cfg = copy.deepcopy(cfg)
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override {item!r} is not key=value")
        key, val = item.split("=", 1)
        node, parts = cfg, key.split(".")
        for part in parts[:-1]:
            node = node[int(part)] if isinstance(node, list) else node.setdefault(part, {})
        if isinstance(node, list):
            node[int(parts[-1])] = _parse_value(val)
        else:
            node[parts[-1]] = _parse_value(val)
    return cfg


def load_configs(paths: Sequence[str], overrides: Sequence[str] = (),
                 base: Optional[Dict] = None) -> Dict:
    """``base`` (or an empty config), then the YAML files merged left to
    right, then the dotlist overrides."""
    cfg = copy.deepcopy(base or {})
    for path in paths:
        cfg = deep_merge(cfg, load_config(path))
    return apply_dotlist(cfg, overrides)


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
                            "enable_attention3d_crossframe", "use_checkpoint") if k in p}
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
    return _autoencoder_kl(p.get("ddconfig", {}), p.get("embed_dim", 4))


def _autoencoder_kl(dd: Dict, embed_dim: int = 4) -> AutoencoderKL:
    """``AutoencoderKL`` from an LDM ``ddconfig`` (or ``encoder_config``
    params) dict."""
    return AutoencoderKL(embed_dim=embed_dim, ch=dd.get("ch", 128),
                         ch_mult=tuple(dd.get("ch_mult", (1, 2, 4, 4))),
                         num_res_blocks=dd.get("num_res_blocks", 2),
                         out_ch=dd.get("out_ch", 3), z_channels=dd.get("z_channels", 4),
                         in_channels=dd.get("in_channels", 3),
                         attn_resolutions=tuple(dd.get("attn_resolutions", ())),
                         resolution=dd.get("resolution", 256))


def build_autoencoder_engine(cfg: Dict):
    """``AutoencodingEngine`` from a reference autoencoder training config
    (``VAE_TRAIN_CONFIG``'s layout, as ``ccedit_tpu/config.py::
    build_autoencoder_engine`` reads it): the encoder's geometry (the
    decoder's always agrees in the shipped files) and the
    ``GeneralLPIPSWithDiscriminator`` loss knobs.  Modules are built on the
    current default device with PyTorch's default initialisation."""
    from .models.autoencoder_engine import AutoencodingEngine, LPIPSWithDiscriminatorConfig

    p = _params(cfg.get("model", cfg))
    lp = _params(p.get("loss_config"))
    loss_cfg = LPIPSWithDiscriminatorConfig(
        disc_start=int(lp.get("disc_start", 0)),
        logvar_init=float(lp.get("logvar_init", 0.0)),
        pixelloss_weight=float(lp.get("pixelloss_weight", 1.0)),
        disc_num_layers=int(lp.get("disc_num_layers", 3)),
        disc_in_channels=int(lp.get("disc_in_channels", 3)),
        disc_factor=float(lp.get("disc_factor", 1.0)),
        disc_weight=float(lp.get("disc_weight", 1.0)),
        perceptual_weight=float(lp.get("perceptual_weight", 1.0)),
        disc_loss=lp.get("disc_loss", "hinge"),
        learn_logvar=bool(lp.get("learn_logvar", False)),
        regularization_weights=lp.get("regularization_weights"))
    return AutoencodingEngine(_autoencoder_kl(_params(p.get("encoder_config"))), loss_cfg)


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
        specs.append(EmbedderSpec(embedder, emb.get("input_key", "txt"),
                                  ucg_rate=float(emb.get("ucg_rate", 0.0)),
                                  legacy_ucg_value=emb.get("legacy_ucg_value")))
    return Conditioner(specs)


_WEIGHTINGS = {"EpsWeighting": EpsWeighting, "EDMWeighting": EDMWeighting,
               "VWeighting": VWeighting, "UnitWeighting": UnitWeighting}


def build_weighting(cfg: Optional[Dict]):
    """A denoiser's ``weighting_config`` (eps when absent, as in the JAX
    package)."""
    if not cfg:
        return EpsWeighting()
    return _WEIGHTINGS[_expect(cfg, *_WEIGHTINGS)](**_params(cfg))


def build_loss(cfg: Optional[Dict]) -> Optional[StandardDiffusionLoss]:
    """``StandardDiffusionLoss`` from a ``loss_fn_config`` (None without one)."""
    if not cfg:
        return None
    _expect(cfg, "StandardDiffusionLoss")
    p = _params(cfg)
    ss_cfg = p.get("sigma_sampler_config", {"target": "DiscreteSampling"})
    ss_params = _params(ss_cfg)
    if _expect(ss_cfg, "DiscreteSampling", "EDMSampling") == "EDMSampling":
        sigma_sampler = EDMSampling(**ss_params)
    else:
        disc_cfg = ss_params.pop("discretization_config", None)
        if disc_cfg is not None:
            _expect(disc_cfg, "LegacyDDPMDiscretization")
            ss_params["discretization"] = LegacyDDPMDiscretization(**_params(disc_cfg))
        sigma_sampler = DiscreteSampling(**ss_params)
    return StandardDiffusionLoss(sigma_sampler, loss_type=p.get("type", "l2"),
                                 offset_noise_level=p.get("offset_noise_level", 0.0),
                                 offset_noise_varying_dim=p.get("offset_noise_varying_dim", 1))


def build_lr_scheduler(cfg: Optional[Dict]):
    """An LR multiplier schedule from a ``scheduler_config`` (None without
    one)."""
    if not cfg:
        return None
    from .train.lr_schedule import SCHEDULERS

    return SCHEDULERS[_expect(cfg, *SCHEDULERS)](**_params(cfg))


_FREEZE_MAP = {"none": "none", "spatial": "spatial", "spatial_openlora": "spatial_openlora"}
# the TV2V engine re-freezes the structure ControlNet and opens controlnet_img
_TV2V_FREEZE = {"spatial": "spatial_tv2v", "spatial_openlora": "spatial_tv2v_openlora"}


def freeze_policy(model_params: Dict) -> str:
    """The freeze policy of a VideoDiffusionEngineTV2V's ``freeze_model``."""
    freeze = _FREEZE_MAP.get(model_params.get("freeze_model", "none"), "none")
    return _TV2V_FREEZE.get(freeze, freeze)


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
                                    **_params(dcfg.get("discretization_config"))),
                                weighting=build_weighting(dcfg.get("weighting_config")))
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
        loss_fn=build_loss(p.get("loss_fn_config")),
        input_key=p.get("input_key", "jpg"),
        freeze_policy=freeze_policy(p),
        use_ema=bool(p.get("use_ema", False)),
    )
