"""Engines from a reference-format config (port of
``ccedit_tpu/config.py``'s network, TV2V, TVI2V and interpolation builders).

The reference wires everything through ``{target: python.path, params:
{...}}`` trees.  This module resolves the targets the port implements and
raises ``KeyError`` naming any other.  ``TV2V_CONFIG`` is the SD-1.5 TV2V
depth-MiDaS configuration (the shape of the reference's
``keyframe_no2ndca_depthmidas`` inference YAML), used when no config file is
given; ``TVI2V_CONFIG`` the reference-guided one of
``keyframe_ref_cp_no2ndca_add_cfca`` as ``bench.py`` builds it: CFCA
centre+self in the UNet, the structure ControlNet, and the appearance
ControlNet fed the VAE latent of the edited centre frame.
``TVI2V_ZOE_CONFIG`` is TVI2V as shipped
(``keyframe_ref_cp_no2ndca_add_cfca_depthzoe``): the same with the
``DepthZoeEncoder`` (ZoeDepth) structure hint in place of MiDaS.
``TV2V_TRAIN_CONFIG`` is the TV2V training recipe (the shape of the
reference's ``sd_1_5_controlldm-test-tv2v-depthmidas.yaml``): the TV2V
network with ``use_checkpoint``, the depth-MiDaS conditioner with text
dropout, ``StandardDiffusionLoss`` with ``DiscreteSampling`` and eps
weighting, ``freeze_model: spatial``, base LR 1e-4 with a
``LambdaLinearScheduler`` warm-up, and its data: batch 4 of 12-frame clips
at 384x512.  ``TVI2V_TRAIN_CONFIG`` is TVI2V training: ``TVI2V_CONFIG`` with
those settings, batch 1 of 17-frame clips at 384x512 and base LR 5e-5.
``INTERP_TRAIN_CONFIG`` trains the frame-interpolation network
(``ControlledUNetModel3DTV2VInterpolate`` under
``VideoDiffusionEngineTV2VInterpolate``): the TV2V recipe with TVI2V's
appearance ControlNet on the first and last frames, at TVI2V's batch,
geometry and LR.  Every network target of the JAX ``build_network`` builds
(the pseudo-3D UNets, the interpolation network, RAIG's 2-D UNet with its
reference attention, any other as a 2-D UNet), with every UNet option but
``remat_policy``.
``VAE_TRAIN_CONFIG`` is the SD KL-f8 autoencoder's GAN
fine-tune in the layout of the reference's autoencoder training YAMLs
(``model.params.encoder_config`` / ``loss_config``), which
``build_autoencoder_engine`` reads.
"""

from __future__ import annotations

import copy
import json
from typing import Dict, Optional, Sequence

import torch

from .conditioning.annotators.base import TARGETS as ANNOTATOR_TARGETS
from .conditioning.annotators.base import build_annotator
from .conditioning.conditioner import Conditioner, EmbedderSpec
from .conditioning import embedders as E
from .diffusion import (
    Denoiser,
    DiscreteDenoiser,
    DiscreteSampling,
    EDMSampling,
    IdentityGuider,
    LegacyDDPMDiscretization,
    StandardDiffusionLoss,
    VanillaCFG,
    make_discretization,
    make_sampler,
)
from .diffusion.samplers import BaseSampler
from .diffusion.scaling import SCALINGS
from .diffusion.weighting import EDMWeighting, EpsWeighting, UnitWeighting, VWeighting
from .models.engine import CCEditEngine
from .modules.clip import CLIPTextModel
from .modules.controlnet import CCEditNetwork, ControlNet2D, ControlNet3D
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


def _tvi2v_zoe_config() -> Dict:
    cfg = copy.deepcopy(TVI2V_CONFIG)
    for emb in cfg["model"]["params"]["conditioner_config"]["params"]["emb_models"]:
        if emb["target"].endswith("DepthMidasEncoder"):
            emb["target"] = "sgm.modules.encoders.modules.DepthZoeEncoder"
    return cfg


TVI2V_ZOE_CONFIG: Dict = _tvi2v_zoe_config()


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


def _tvi2v_train_config() -> Dict:
    """TVI2V training: ``TVI2V_CONFIG``'s network and conditioning with
    ``TV2V_TRAIN_CONFIG``'s training settings.  The reference's TVI2V
    training YAML is not in the repository; SURVEY.md's recipe table
    (``…tvi2v…yaml:9-27``) gives batch 1 of 17 frames at 384x512 and base LR
    5e-5, and its parallelism table (:222) fp16 under DDP, which the port
    runs as fp32 masters under bf16 autocast.  Everything else is
    ``TV2V_TRAIN_CONFIG``'s: ``use_checkpoint``, eps weighting, ucg 0.1 on
    ``txt``, ``DiscreteSampling``, ``freeze_model: spatial`` (under the TV2V
    engine ``spatial_tv2v``: the temporal layers, the CFCA's ``*_temporal_ca``
    and ``controlnet_img`` train) and the ``LambdaLinearScheduler`` warm-up.
    The ZoeDepth variant is one dotlist override away:
    ``model.params.conditioner_config.params.emb_models.1.target=
    sgm.modules.encoders.modules.DepthZoeEncoder``, as ``TVI2V_ZOE_CONFIG``."""
    cfg = copy.deepcopy(TVI2V_CONFIG)
    train = TV2V_TRAIN_CONFIG["model"]["params"]
    p = cfg["model"]["params"]
    net = p["network_config"]["params"]
    for params in (net, net["controlnet_config"]["params"], net["controlnet_img_config"]["params"]):
        params["use_checkpoint"] = True
    p["denoiser_config"]["params"]["weighting_config"] = copy.deepcopy(
        train["denoiser_config"]["params"]["weighting_config"])
    p["conditioner_config"]["params"]["emb_models"][0]["ucg_rate"] = 0.1
    p.update({k: copy.deepcopy(train[k])
              for k in ("freeze_model", "loss_fn_config", "scheduler_config")})
    p["base_learning_rate"] = 5e-5
    cfg["data"] = {"params": {"batch_size": 1, "train": {"params": {
        "video_length": 17, "resolution": [384, 512]}}}}
    return cfg


TVI2V_TRAIN_CONFIG: Dict = _tvi2v_train_config()


def _interp_train_config() -> Dict:
    """Training the frame-interpolation network, which fills the frames
    between two generated keyframes (SURVEY.md's interpolation model).  The
    reference's YAML is not in the repository, so the config is composed
    from what is: ``TV2V_TRAIN_CONFIG``'s recipe (``use_checkpoint`` on all
    three networks, eps weighting, ucg 0.1 on ``txt``, ``DiscreteSampling``,
    the ``LambdaLinearScheduler`` warm-up, ``freeze_model: spatial``, which
    this engine maps to ``spatial_tv2v`` as the JAX ``build_engine`` does);
    the JAX builder's ``ControlledUNetModel3DTV2VInterpolate`` network with
    no CFCA and ``VideoDiffusionEngineTV2VInterpolate`` engine; TVI2V's
    appearance ``ControlNet2D`` as ``controlnet_img`` (latent hint,
    identity hint block, ``no_add_x``, ``disable_text_ca``), as
    ``tests/test_variants.py`` composes the interpolation network, fed by a
    ``VAEEmbedder`` on the first and last frames (``interpolate_first_last``,
    which ``data/dataset.py`` yields) in place of ``cond_img``; and TVI2V's
    data and LR (batch 1 of 17-frame 384x512 clips, 5e-5; SURVEY.md's
    recipe table), since the same appearance branch trains."""
    cfg = copy.deepcopy(TV2V_TRAIN_CONFIG)
    cfg["model"]["target"] = "sgm.models.diffusion.VideoDiffusionEngineTV2VInterpolate"
    p = cfg["model"]["params"]
    net = p["network_config"]
    net["target"] = ("sgm.modules.diffusionmodules.controlmodel."
                     "ControlledUNetModel3DTV2VInterpolate")
    appearance = copy.deepcopy(
        TVI2V_CONFIG["model"]["params"]["network_config"]["params"]["controlnet_img_config"])
    appearance["params"]["use_checkpoint"] = True
    net["params"]["controlnet_img_config"] = appearance
    p["conditioner_config"]["params"]["emb_models"].append(
        {"input_key": "interpolate_first_last",
         "target": "sgm.modules.encoders.modules.VAEEmbedder", "params": {}})
    p["base_learning_rate"] = TVI2V_TRAIN_CONFIG["model"]["params"]["base_learning_rate"]
    cfg["data"] = copy.deepcopy(TVI2V_TRAIN_CONFIG["data"])
    return cfg


INTERP_TRAIN_CONFIG: Dict = _interp_train_config()

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


# the reference's UNet params -> the port's UNetModel keywords: every key of
# the JAX ``_UNET_KEY_MAP`` but ``remat_policy``, a jax.checkpoint_policies
# name with no torch meaning (``use_checkpoint`` recomputes everything)
_UNET_KEY_MAP = {k: k for k in (
    "in_channels", "model_channels", "out_channels", "num_res_blocks",
    "attention_resolutions", "channel_mult", "num_heads", "num_head_channels",
    "transformer_depth", "context_dim", "use_linear_in_transformer", "legacy",
    "use_scale_shift_norm", "resblock_updown", "disable_temporal_text_ca",
    "disable_text_ca", "enable_attention3d_crossframe", "enable_ref_attn",
    "use_learnable_alpha", "adm_in_channels", "use_checkpoint")}
_UNET_KEY_MAP["ST3DCA_ca_type"] = "st3dca_ca_type"


def _unet_kwargs(p: Dict) -> Dict:
    """The UNet keywords of a network's params (lists as tuples);
    ``remat_policy`` raises ``KeyError`` naming it."""
    if "remat_policy" in p:
        raise KeyError(f"network option remat_policy={p['remat_policy']!r} is a "
                       "jax.checkpoint_policies name: the port has no such policy "
                       "(use_checkpoint recomputes every block)")
    return {dst: tuple(p[src]) if isinstance(p[src], list) else p[src]
            for src, dst in _UNET_KEY_MAP.items() if src in p}


def build_controlnet(cfg: Dict):
    """A ``ControlNet2D`` or, for that target, a ``ControlNet3D`` (the
    pseudo-3D branch no shipped config composes; the JAX converter's
    ``convert_controlnet(video=True)`` loads its weights)."""
    name = _expect(cfg, "ControlNet2D", "ControlNet3D")
    p = _params(cfg)
    kw = _unet_kwargs(p)
    scales = float(p.get("control_scales", 1.0))
    if name == "ControlNet3D":
        return ControlNet3D(hint_channels=p.get("hint_channels", 4), control_scales=scales,
                            disable_temporal=bool(p.get("disable_temporal", False)), **kw)
    return ControlNet2D(hint_channels=p.get("hint_channels", 3), control_scales=scales,
                        no_add_x=bool(p.get("no_add_x", False)),
                        input_hint_identity=bool(p.get("set_input_hint_block_as_identity", False)),
                        **kw)


# network targets whose UNet is pseudo-3D, as the JAX ``build_network``;
# every other target builds a 2-D UNet (RAIG's with its reference attention)
_VIDEO_NETWORKS = ("UNetModel3D", "ControlledUNetModel3DTV2V",
                   "ControlledUNetModel3DTV2VInterpolate", "ControlNet3D")


def build_network(cfg: Dict) -> CCEditNetwork:
    """The composed network of a ``network_config``, for every target the
    JAX ``build_network`` takes: a pseudo-3D UNet for ``_VIDEO_NETWORKS``, a
    2-D one otherwise; ``ControlledUNetModel3DTV2VInterpolate`` sets
    ``interpolate``, ``ControlledUNetModel2DRAIG`` ``raig`` and
    ``enable_ref_attn``.  The branches are ``ControlNet2D`` (the composed
    network calls no ControlNet3D)."""
    name = _tname(cfg)
    p = _params(cfg)
    kw = _unet_kwargs(p)
    raig = name == "ControlledUNetModel2DRAIG"
    if raig:
        kw["enable_ref_attn"] = True
    unet = UNetModel(unet_type="pseudo-3d" if name in _VIDEO_NETWORKS else "2d", **kw)
    branches = []
    for key in ("controlnet_config", "controlnet_img_config"):
        if p.get(key):
            _expect(p[key], "ControlNet2D")
            branches.append(build_controlnet(p[key]))
        else:
            branches.append(None)
    return CCEditNetwork(unet, *branches, crossframe_type=p.get("crossframe_type"),
                         interpolate=name == "ControlledUNetModel3DTV2VInterpolate", raig=raig)


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


def build_embedder(emb: Dict, asset_dir: Optional[str] = None,
                   fake_annotator: bool = False):
    """One embedder of a reference ``emb_models`` entry: every target of the
    JAX ``_build_embedder``, with its defaults.  Any other target raises
    ``KeyError`` naming it.  ``fake_annotator`` (the CLI's flag) opts a depth
    annotator into the luminance stand-in."""
    name, p = _tname(emb), _params(emb)
    if name == "FrozenCLIPEmbedder":
        return E.CLIPTextEmbedder(CLIPTextModel(), asset_dir=asset_dir,
                                  output_layer=p.get("layer", "last"),
                                  layer_idx=p.get("layer_idx"))
    if name == "VAEEmbedder":
        return E.VAEEmbedder()
    if name == "IdentityEncoder":
        return E.IdentityEncoder()
    if name == "CustomIdentityEncoder":
        return E.CustomIdentityEncoder(p.get("down_blur_factor"), p.get("down_blur_probs"),
                                       p.get("downsample_factor", 1))
    if name == "CustomIdentityDownCondEncoder":
        return E.CustomIdentityDownCondEncoder(p.get("outdim", 256), p.get("down_blur_factor"),
                                               p.get("down_blur_probs"))
    if name == "ConcatTimestepEmbedderND":
        return E.ConcatTimestepEmbedderND(p.get("outdim", 256))
    if name == "ClassEmbedder":
        return E.ClassEmbedder(p.get("embed_dim", 512), p.get("n_classes", 1000),
                               add_sequence_dim=p.get("add_sequence_dim", False))
    if name == "LowScaleEncoder":
        return E.LowScaleEncoder(
            max_noise_level=p.get("max_noise_level", 250), out_size=p.get("output_size"),
            scale_factor=p.get("scale_factor", 1.0), num_timesteps=p.get("timesteps", 1000),
            linear_start=p.get("linear_start", 0.00085), linear_end=p.get("linear_end", 0.0120))
    if name == "SpatialRescaler":
        return E.SpatialRescaler(
            p.get("multiplier", p.get("factor", 0.5)), p.get("method", "bilinear"),
            n_stages=p.get("n_stages", 1), out_channels=p.get("out_channels"),
            kernel_size=p.get("kernel_size", 1), bias=p.get("bias", False),
            in_channels=p.get("in_channels", 3))
    if name == "InpaintingEncoder":
        return E.InpaintingEncoder(p.get("mask_ratio_min", 0.3), p.get("mask_ratio_max", 0.5))
    if name == "OutpaintingEncoder":
        return E.OutpaintingEncoder(p.get("mask_ratio_min", 0.0), p.get("mask_ratio_max", 0.4))
    if name == "GaussianEncoder":
        enc_keys = ("ch", "ch_mult", "num_res_blocks", "attn_resolutions", "in_channels",
                    "z_channels", "double_z", "resolution")
        return E.GaussianEncoder(weight=p.get("weight", 1.0),
                                 flatten_output=p.get("flatten_output", True),
                                 **{k: p[k] for k in enc_keys if k in p})
    if name == "FrozenT5Embedder":
        return E.T5TextEmbedder(version=p.get("version", "google/t5-v1_1-xxl"),
                                max_length=p.get("max_length", 77), spm_path=p.get("spm_path"))
    if name == "FrozenByT5Embedder":
        return E.T5TextEmbedder(version=p.get("version", "google/byt5-base"),
                                max_length=p.get("max_length", 77), variant="byt5")
    if name in ("FrozenOpenCLIPEmbedder", "FrozenOpenCLIPEmbedder2"):
        return E.OpenCLIPTextEmbedder(
            arch=p.get("arch", "ViT-H-14"), layer=p.get("layer", "last"),
            legacy=p.get("legacy", True) or name == "FrozenOpenCLIPEmbedder",
            always_return_pooled=p.get("always_return_pooled", False),
            max_length=p.get("max_length", 77), asset_dir=asset_dir)
    if name == "FrozenOpenCLIPImageEmbedder":
        return E.OpenCLIPImageEmbedder(
            arch=p.get("arch", "ViT-H-14"), unsqueeze_dim=p.get("unsqueeze_dim", False),
            repeat_to_max_len=p.get("repeat_to_max_len", False),
            max_length=p.get("max_length", 77), output_tokens=p.get("output_tokens", False))
    if name == "FrozenCLIPT5Encoder":
        return E.CLIPT5Embedder(asset_dir=asset_dir,
                                clip_max_length=p.get("clip_max_length", 77),
                                t5_max_length=p.get("t5_max_length", 77),
                                t5_version=p.get("t5_version", "google/t5-v1_1-xl"))
    if name in ANNOTATOR_TARGETS:
        return build_annotator(name, dict(p, fake_annotator=fake_annotator
                                          or p.get("fake_annotator", False)))
    raise KeyError(f"unknown embedder target {name!r}")


def build_conditioner(cfg: Dict, asset_dir: Optional[str] = None,
                      fake_annotator: bool = False) -> Conditioner:
    specs = [EmbedderSpec(build_embedder(emb, asset_dir, fake_annotator),
                          emb.get("input_key", "txt"), ucg_rate=float(emb.get("ucg_rate", 0.0)),
                          legacy_ucg_value=emb.get("legacy_ucg_value"))
             for emb in _params(cfg).get("emb_models", [])]
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
    """The freeze policy of a VideoDiffusionEngineTV2V's (or
    VideoDiffusionEngineTV2VInterpolate's) ``freeze_model``."""
    freeze = _FREEZE_MAP.get(model_params.get("freeze_model", "none"), "none")
    return _TV2V_FREEZE.get(freeze, freeze)


_SCALING = {"EpsScaling": "eps", "EDMScaling": "edm", "VScaling": "v"}
_DISCRETIZATION = {"LegacyDDPMDiscretization": "legacy_ddpm", "EDMDiscretization": "edm"}
SAMPLER_NAMES = {
    "EulerEDMSampler": "euler",
    "HeunEDMSampler": "heun",
    "EulerAncestralSampler": "euler_ancestral",
    "DPMPP2SAncestralSampler": "dpmpp_2s_ancestral",
    "DPMPP2MSampler": "dpmpp_2m",
    "LinearMultistepSampler": "lms",
}
_SAMPLER_OPTIONS = ("s_churn", "s_tmin", "s_tmax", "s_noise", "eta", "order")


def build_discretization(cfg: Optional[Dict]):
    """A ``discretization_config`` (LegacyDDPM when absent) with its params;
    ``img2img_strength`` below 1 prunes it (``Img2ImgDiscretizationWrapper``)."""
    cfg = cfg or {"target": "LegacyDDPMDiscretization"}
    return make_discretization(_DISCRETIZATION[_expect(cfg, *_DISCRETIZATION)], **_params(cfg))


def build_denoiser(cfg: Dict) -> Denoiser:
    """A ``denoiser_config``: ``DiscreteDenoiser`` (the shipped one) or the
    continuous ``Denoiser``, with its scaling, weighting and (discrete)
    discretization."""
    name = _expect(cfg, "DiscreteDenoiser", "Denoiser")
    p = _params(cfg)
    scfg = p.get("scaling_config")
    scaling = SCALINGS[_SCALING[_expect(scfg, *_SCALING)]](**_params(scfg))
    weighting = build_weighting(p.get("weighting_config"))
    if name == "Denoiser":
        return Denoiser(scaling, weighting=weighting)
    return DiscreteDenoiser(scaling, num_idx=p.get("num_idx", 1000),
                            discretization=build_discretization(p.get("discretization_config")),
                            weighting=weighting)


def build_sampler(cfg: Optional[Dict], num_steps: Optional[int] = None) -> BaseSampler:
    """The sampler of a ``sampler_config`` (the JAX ``build_sampler``): its
    target, its ``s_churn``/``s_tmin``/``s_tmax``/``s_noise``/``eta``/
    ``order`` and its ``discretization_config`` (img2img strength
    included); DPM++2S-ancestral on LegacyDDPM without one.  ``num_steps``
    when given, else the config's, else 30."""
    sp = _params(cfg)
    name = SAMPLER_NAMES[_expect(cfg, *SAMPLER_NAMES)] if cfg is not None else "dpmpp_2s_ancestral"
    kwargs = {k: sp[k] for k in _SAMPLER_OPTIONS if k in sp}
    return make_sampler(name, discretization=build_discretization(sp.get("discretization_config")),
                        num_steps=num_steps or sp.get("num_steps") or 30, **kwargs)


def build_engine(cfg: Optional[Dict] = None, asset_dir: Optional[str] = None,
                 guider_scale: float = 7.5, num_steps: Optional[int] = None,
                 fake_annotator: bool = False) -> CCEditEngine:
    """CCEditEngine from a reference-format config (``TV2V_CONFIG`` when
    None; ``TVI2V_CONFIG`` for the reference-guided edit).  Modules are
    built on the current default device with PyTorch's default
    initialisation; load or randomise weights afterwards."""
    cfg = copy.deepcopy(cfg if cfg is not None else TV2V_CONFIG)
    model_cfg = cfg.get("model", cfg)
    _expect(model_cfg, "VideoDiffusionEngineTV2V", "VideoDiffusionEngineTV2VInterpolate")
    p = _params(model_cfg)
    denoiser = build_denoiser(p["denoiser_config"])
    guider = VanillaCFG(scale=guider_scale)
    sampler = build_sampler(p.get("sampler_config"), num_steps)
    if "sampler_config" in p:
        gcfg = _params(p["sampler_config"]).get("guider_config")
        if gcfg is not None:
            name = _expect(gcfg, "VanillaCFG", "VanillaCFGTV2V", "IdentityGuider")
            guider = (IdentityGuider() if name == "IdentityGuider"
                      else VanillaCFG(scale=_params(gcfg).get("scale", guider_scale)))
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
