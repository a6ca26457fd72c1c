"""Conditioning embedders (port of ``ccedit_tpu/conditioning/
embedders.py``): ``CLIPTextEmbedder``, ``IdentityEncoder``,
``VAEEmbedder``, ``CustomIdentityEncoder`` and
``CustomIdentityDownCondEncoder`` (the random down-blur), 
``ConcatTimestepEmbedderND``, ``ClassEmbedder``, ``SpatialRescaler``,
``LowScaleEncoder`` (q-sample noise augmentation), ``GaussianEncoder``,
``InpaintingEncoder`` / ``OutpaintingEncoder``, ``T5TextEmbedder``,
``OpenCLIPTextEmbedder``, ``OpenCLIPImageEmbedder`` and ``CLIPT5Embedder``.
Each embedder has ``prepare(value, device)`` (host side: tokenise, draw a
mask, ...) and ``forward(prepared)`` (device side).  Every random draw
comes from a ``torch.Generator``: the one the conditioner passes (an
embedder that ``wants_generator``), else the embedder's own, seeded 0.
Resizes follow torch's ``F.interpolate`` (the reference's), except the
OpenCLIP image preprocessing, which follows the JAX package's
``jax.image.resize`` (Keys cubic, a = -0.5, antialiased)."""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..modules.clip import CLIPTextModel
from ..modules.layers import timestep_embedding
from .tokenizer import load_tokenizer


def as_float_frames(x: torch.Tensor) -> torch.Tensor:
    """uint8 pixels -> [-1, 1] float32; float input passes through."""
    if x.dtype == torch.uint8:
        return x.to(torch.float32) / 127.5 - 1.0
    return x


class Embedder(nn.Module):
    def prepare(self, value, device):
        return torch.as_tensor(value, device=device)


class CLIPTextEmbedder(Embedder):
    """SD-1.5 text conditioning: CLIP ViT-L/14 text transformer, 77 tokens."""

    def __init__(self, model: Optional[CLIPTextModel] = None, asset_dir: Optional[str] = None,
                 output_layer: str = "last", layer_idx: Optional[int] = None,
                 max_len: int = 77):
        super().__init__()
        self.tokenizer = load_tokenizer(asset_dir)
        self.transformer = model if model is not None else CLIPTextModel()
        self.output_layer, self.layer_idx, self.max_len = output_layer, layer_idx, max_len

    def prepare(self, value, device):
        if isinstance(value, str):
            value = [value]
        if isinstance(value, (list, tuple)) and (not value or isinstance(value[0], str)):
            value = self.tokenizer(list(value), self.max_len)
        return torch.as_tensor(np.asarray(value), dtype=torch.long, device=device)

    def forward(self, tokens):
        return self.transformer(tokens, output_layer=self.output_layer, layer_idx=self.layer_idx)


class IdentityEncoder(Embedder):
    def forward(self, prepared):
        return as_float_frames(prepared)


class VAEEmbedder(Embedder):
    """The edited reference frame -> its scaled VAE latent, through the
    engine's shared first stage: ``encode`` is set by the engine to
    ``CCEditEngine.encode_first_stage``: the posterior mode times the scale
    factor at inference, a posterior sample drawn from ``generator`` in
    training (the JAX embedder's ``rng``, as the reference samples it).
    (B, H, W, 3) pixels -> (B, H/8, W/8, 4); the interpolation network's
    (B, 2, H, W, 3) first and last frames -> (B, 2, H/8, W/8, 4), folded
    per frame as the VAE folds a clip."""

    wants_generator = True

    def __init__(self):
        super().__init__()
        self.encode: Optional[Callable] = None

    def forward(self, prepared, generator: Optional[torch.Generator] = None):
        if self.encode is None:
            raise RuntimeError("VAEEmbedder is not wired to an engine's VAE")
        return self.encode(prepared, generator=generator)


# ---------------------------------------------------------------------------
# the down-blur augmentation and the image embedders
# ---------------------------------------------------------------------------

def torch_resize_hw(x: torch.Tensor, out_h: int, out_w: int,
                    method: str = "bilinear") -> torch.Tensor:
    """Resize the trailing (H, W, C) axes with ``F.interpolate``'s semantics
    (no antialias; legacy 'nearest'; 'area' an adaptive average pool;
    bilinear and trilinear at half-pixel centres, T untouched)."""
    h, w = x.shape[-3:-1]
    if (h, w) == (out_h, out_w):
        return x
    lead = x.shape[:-3]
    y = x.reshape((-1,) + tuple(x.shape[-3:])).permute(0, 3, 1, 2)
    mode = "bilinear" if method == "trilinear" else method
    kw = {"align_corners": False} if mode in ("bilinear", "bicubic") else {}
    y = F.interpolate(y, size=(out_h, out_w), mode=mode, **kw)
    return y.permute(0, 2, 3, 1).reshape(lead + (out_h, out_w, x.shape[-1]))


def down_blur(x: torch.Tensor, factor: float) -> torch.Tensor:
    """Down to (int(h / f), int(w / f)) and back, bilinear."""
    if factor <= 1.0:
        return x
    h, w = x.shape[-3:-1]
    return torch_resize_hw(torch_resize_hw(x, int(h / factor), int(w / factor)), h, w)


def _default_generator(module) -> torch.Generator:
    if getattr(module, "_generator", None) is None:
        module._generator = torch.Generator().manual_seed(0)
    return module._generator


def select_down_blur(x: torch.Tensor, factors: Sequence[float], probs: Sequence[float],
                     generator: torch.Generator):
    """A factor drawn from ``factors`` (``probs``, uniform without them)
    with ``generator``, applied.  Returns (blurred, factor)."""
    p = torch.tensor(probs if probs else [1.0] * len(factors), dtype=torch.float32,
                     device=generator.device)
    factor = float(factors[int(torch.multinomial(p, 1, generator=generator))])
    return down_blur(x, factor), factor


class CustomIdentityEncoder(Embedder):
    """Identity with the reference's random down-blur augmentation (a
    factor from ``down_blur_factor``, the image taken down and back up);
    without factors an identity, or the fixed ``downsample_factor``."""

    def __init__(self, down_blur_factor=None, down_blur_probs=None,
                 downsample_factor: int = 1):
        super().__init__()
        self.down_blur_factor = list(down_blur_factor or [])
        self.down_blur_probs = list(down_blur_probs or [])
        self.downsample_factor = downsample_factor
        self.wants_generator = bool(self.down_blur_factor)

    def forward(self, prepared, generator: Optional[torch.Generator] = None):
        x = as_float_frames(prepared)
        if self.down_blur_factor:
            return select_down_blur(x, self.down_blur_factor, self.down_blur_probs,
                                    generator or _default_generator(self))[0]
        if self.downsample_factor and self.downsample_factor > 1:
            x = down_blur(x, float(self.downsample_factor))
        return x


class CustomIdentityDownCondEncoder(Embedder):
    """The down-blur with its factor as conditioning: the blurred clip with
    ``outdim`` channels of the factor's timestep embedding appended,
    broadcast over every position.  Without factors, the input as it is."""

    wants_generator = True

    def __init__(self, outdim: int, down_blur_factor=None, down_blur_probs=None):
        super().__init__()
        self.outdim = outdim
        self.down_blur_factor = list(down_blur_factor or [])
        self.down_blur_probs = list(down_blur_probs or [])

    def forward(self, prepared, generator: Optional[torch.Generator] = None):
        x = prepared
        if not self.down_blur_factor:
            return x
        x, factor = select_down_blur(x, self.down_blur_factor, self.down_blur_probs,
                                     generator or _default_generator(self))
        emb = timestep_embedding(torch.full((x.shape[0],), factor, device=x.device), self.outdim)
        emb = emb.reshape((x.shape[0],) + (1,) * (x.dim() - 2) + (self.outdim,))
        return torch.cat([x, emb.expand(x.shape[:-1] + (self.outdim,)).to(x.dtype)], dim=-1)


class ConcatTimestepEmbedderND(Embedder):
    """N scalars per sample, each Fourier-embedded to ``outdim``, flattened."""

    def __init__(self, outdim: int = 256):
        super().__init__()
        self.outdim = outdim

    def forward(self, prepared):
        x = prepared if prepared.dim() > 1 else prepared[:, None]
        b, n = x.shape
        return timestep_embedding(x.reshape(-1), self.outdim).reshape(b, n * self.outdim)


class ClassEmbedder(Embedder):
    """An ``nn.Embedding`` lookup; class ``n_classes - 1`` is the
    unconditional one."""

    def __init__(self, embed_dim: int, n_classes: int = 1000, add_sequence_dim: bool = False):
        super().__init__()
        self.n_classes, self.add_sequence_dim = n_classes, add_sequence_dim
        self.embedding = nn.Embedding(n_classes, embed_dim)

    def prepare(self, value, device):
        return torch.as_tensor(np.asarray(value), dtype=torch.long, device=device)

    def forward(self, prepared):
        c = self.embedding(prepared.long())
        return c[:, None, :] if self.add_sequence_dim else c

    def get_unconditional_conditioning(self, bs: int) -> np.ndarray:
        return np.full((bs,), self.n_classes - 1, dtype=np.int64)


class SpatialRescaler(Embedder):
    """``n_stages`` resizes by ``factor`` (each output size floored, torch
    semantics), then, with ``out_channels``, a k x k channel-mapper conv
    (padding k // 2) from ``in_channels``.  Video input is resized per
    frame."""

    def __init__(self, factor: float = 0.5, method: str = "bilinear", n_stages: int = 1,
                 out_channels: Optional[int] = None, kernel_size: int = 1, bias: bool = False,
                 in_channels: int = 3):
        super().__init__()
        assert n_stages >= 0
        self.factor, self.method, self.n_stages = factor, method, n_stages
        self.channel_mapper = (nn.Conv2d(in_channels, out_channels, kernel_size, bias=bias,
                                         padding=kernel_size // 2)
                               if out_channels is not None else None)

    def forward(self, prepared):
        x = prepared
        for _ in range(self.n_stages):
            h, w = x.shape[-3:-1]
            x = torch_resize_hw(x, int(h * self.factor), int(w * self.factor), self.method)
        if self.channel_mapper is not None:
            lead = x.shape[:-3]
            y = self.channel_mapper(x.reshape((-1,) + tuple(x.shape[-3:])).permute(0, 3, 1, 2))
            x = y.permute(0, 2, 3, 1).reshape(lead + y.shape[2:] + y.shape[1:2])
        return x


class LowScaleEncoder(Embedder):
    """Noise-augmentation conditioning (the SD upscaler recipe): the latent
    times ``scale_factor``, q-sampled at a random DDPM timestep below
    ``max_noise_level`` on the host (``prepare``), then nearest-resized to
    ``out_size``.  The timestep is kept on ``last_noise_level``.
    ``noise_override`` / ``t_override`` replace the draws."""

    def __init__(self, max_noise_level: int = 250, out_size: Optional[int] = None,
                 scale_factor: float = 1.0, num_timesteps: int = 1000,
                 linear_start: float = 0.00085, linear_end: float = 0.0120):
        super().__init__()
        from ..diffusion.discretization import make_ddpm_alphas_cumprod

        self.max_noise_level, self.out_size, self.scale_factor = (
            max_noise_level, out_size, scale_factor)
        abar = make_ddpm_alphas_cumprod(num_timesteps, linear_start, linear_end)
        self.sqrt_abar = np.sqrt(abar).astype(np.float32)
        self.sqrt_1m_abar = np.sqrt(1.0 - abar).astype(np.float32)
        self.last_noise_level = None

    def prepare(self, value, device, noise_override=None, t_override=None,
                generator: Optional[torch.Generator] = None):
        x = np.asarray(value, dtype=np.float32) * self.scale_factor
        gen = generator or _default_generator(self)
        t = (np.asarray(t_override, dtype=np.int64) if t_override is not None else
             torch.randint(0, self.max_noise_level, (x.shape[0],), generator=gen).numpy())
        noise = (np.asarray(noise_override, dtype=np.float32) if noise_override is not None
                 else torch.randn(x.shape, generator=gen).numpy())
        self.last_noise_level = t.astype(np.int32)
        lead = (...,) + (None,) * (x.ndim - 1)
        noised = self.sqrt_abar[t][lead] * x + self.sqrt_1m_abar[t][lead] * noise
        return torch.as_tensor(noised.astype(np.float32), device=device)

    def forward(self, prepared):
        if self.out_size is None:
            return prepared
        return torch_resize_hw(prepared, int(self.out_size), int(self.out_size), "nearest")


class GaussianEncoder(Embedder):
    """A trainable VAE ``Encoder`` whose posterior SAMPLE is the
    conditioning, flattened to (B, H*W, C) with ``flatten_output``;
    ``embed_with_kl`` also returns the KL.  The posterior's mode without a
    generator; ``noise_override`` injects the reparameterisation noise."""

    wants_generator = True

    def __init__(self, weight: float = 1.0, flatten_output: bool = True, double_z: bool = True,
                 **encoder_kwargs):
        super().__init__()
        from ..modules.vae import Encoder

        if not double_z:
            raise NotImplementedError("GaussianEncoder needs double_z: its moments are the "
                                      "posterior's mean and log-variance")
        self.model = Encoder(**encoder_kwargs)
        self.weight, self.flatten_output = weight, flatten_output

    def embed_with_kl(self, prepared, generator: Optional[torch.Generator] = None,
                      noise_override=None):
        from ..modules.vae import DiagonalGaussian

        post = DiagonalGaussian(self.model(prepared))
        if noise_override is not None:
            z = post.sample(noise=torch.as_tensor(noise_override, device=post.mean.device))
        elif generator is not None:
            z = post.sample(generator=generator)
        else:
            z = post.mode()
        if self.flatten_output:
            b, h, w, c = z.shape
            z = z.reshape(b, h * w, c)
        return z, post.kl()

    def forward(self, prepared, generator: Optional[torch.Generator] = None,
                noise_override=None):
        return self.embed_with_kl(prepared, generator, noise_override)[0]


def _band_bounds(h, w, ratio_min, ratio_max, draws):
    """The reference's centred-band rectangle from 4 uniform draws, one per
    call."""
    r = ratio_max - ratio_min
    return (int((draws[0] * r + ratio_min) * h), int((1.0 - (draws[1] * r + ratio_min)) * h),
            int((draws[2] * r + ratio_min) * w), int((1.0 - (draws[3] * r + ratio_min)) * w))


class _BandEncoder(Embedder):
    def __init__(self, mask_ratio_min: float, mask_ratio_max: float):
        super().__init__()
        assert 0 <= mask_ratio_min < mask_ratio_max <= 0.5
        self.mask_ratio_min, self.mask_ratio_max = mask_ratio_min, mask_ratio_max

    def prepare(self, value, device, rand_override=None,
                generator: Optional[torch.Generator] = None):
        x = np.asarray(value, dtype=np.float32)
        draws = (np.asarray(rand_override, np.float32) if rand_override is not None
                 else torch.rand(4, generator=generator or _default_generator(self)).numpy())
        bounds = _band_bounds(x.shape[-3], x.shape[-2], self.mask_ratio_min,
                              self.mask_ratio_max, draws)
        return torch.as_tensor(self.hint(x, *bounds), device=device)

    def forward(self, prepared):
        return prepared


class InpaintingEncoder(_BandEncoder):
    """x -> (x + 1) / 2 with the band set to -1, all negated: kept pixels in
    [-1, 0] (never rescaled back, as in the reference), the hole at +1."""

    def __init__(self, mask_ratio_min: float = 0.3, mask_ratio_max: float = 0.5):
        super().__init__(mask_ratio_min, mask_ratio_max)

    @staticmethod
    def hint(x, h0, h1, w0, w1):
        out = (x + 1.0) / 2.0
        out[..., h0:h1, w0:w1, :] = -1.0
        return -out


class OutpaintingEncoder(_BandEncoder):
    """The centre band kept as -x, everything outside +1."""

    def __init__(self, mask_ratio_min: float = 0.0, mask_ratio_max: float = 0.4):
        super().__init__(mask_ratio_min, mask_ratio_max)

    @staticmethod
    def hint(x, h0, h1, w0, w1):
        mask = np.zeros(x.shape, np.float32)
        mask[..., h0:h1, w0:w1, :] = 1.0
        return -(((x + 1.0) / 2.0) * mask * 2.0 - 1.0)


# ---------------------------------------------------------------------------
# text and image towers
# ---------------------------------------------------------------------------

def _tokens(value, tokenize, device):
    if isinstance(value, str):
        value = [value]
    if isinstance(value, (list, tuple)) and (not value or isinstance(value[0], str)):
        value = tokenize(list(value))
    return torch.as_tensor(np.asarray(value), dtype=torch.long, device=device)


class T5TextEmbedder(Embedder):
    """FrozenT5Embedder / FrozenByT5Embedder: the T5 encoder's last hidden
    state over ``max_length``-padded tokens.  ByT5 tokenises without
    assets; classic T5 needs a SentencePiece model (``spm_path``), whose
    package is imported only when one is given."""

    SIZES = {  # (d_model, d_kv, d_ff, heads, layers)
        "google/t5-v1_1-small": (512, 64, 1024, 6, 8),
        "google/t5-v1_1-base": (768, 64, 2048, 12, 12),
        "google/t5-v1_1-large": (1024, 64, 2816, 16, 24),
        "google/t5-v1_1-xl": (2048, 64, 5120, 32, 24),
        "google/t5-v1_1-xxl": (4096, 64, 10240, 64, 24),
        "google/byt5-base": (1536, 64, 3968, 12, 18),
    }

    def __init__(self, version: str = "google/t5-v1_1-xxl", max_length: int = 77,
                 variant: str = "t5", spm_path: Optional[str] = None,
                 model: Optional[nn.Module] = None):
        super().__init__()
        from ..modules.t5 import T5Encoder

        d_model, d_kv, d_ff, heads, layers = self.SIZES.get(version,
                                                            self.SIZES["google/t5-v1_1-xxl"])
        self.transformer = model if model is not None else T5Encoder(
            vocab_size=384 if variant == "byt5" else 32128, d_model=d_model, d_kv=d_kv,
            d_ff=d_ff, heads=heads, layers=layers)
        self.max_length, self.variant = max_length, variant
        self._spm = None
        if spm_path:
            import sentencepiece as sp  # optional: only classic T5 tokenisation needs it

            self._spm = sp.SentencePieceProcessor(model_file=spm_path)

    def tokenize(self, texts):
        if self.variant == "byt5":
            from ..modules.t5 import byt5_tokenize

            return byt5_tokenize(texts, self.max_length)
        assert self._spm is not None, \
            "classic T5 tokenization needs spm_path (SentencePiece model)"
        out = np.zeros((len(texts), self.max_length), np.int32)
        for i, t in enumerate(texts):
            ids = self._spm.encode(t)[: self.max_length - 1] + [1]
            out[i, : len(ids)] = ids
        return out

    def prepare(self, value, device):
        return _tokens(value, self.tokenize, device)

    def forward(self, tokens):
        return self.transformer(tokens)


class OpenCLIPTextEmbedder(Embedder):
    """FrozenOpenCLIPEmbedder(2).  Legacy: ``ln_final`` of the chosen
    state ('penultimate' never runs the final block); v2 (``legacy=False``):
    the raw hidden state, with the EOT-pooled projection when
    ``always_return_pooled``.  Tokens: the CLIP BPE, padded with EOS."""

    ARCHS = {"ViT-H-14": (1024, 16, 24), "ViT-bigG-14": (1280, 20, 32),
             "ViT-L-14": (768, 12, 12)}

    def __init__(self, arch: str = "ViT-H-14", layer: str = "last", legacy: bool = True,
                 always_return_pooled: bool = False, max_length: int = 77,
                 asset_dir: Optional[str] = None, model: Optional[nn.Module] = None):
        super().__init__()
        from ..modules.openclip import OpenCLIPTextModel

        width, heads, layers = self.ARCHS[arch]
        self.model = model if model is not None else OpenCLIPTextModel(
            width=width, heads=heads, layers=layers, max_len=max_length)
        self.tokenizer = load_tokenizer(asset_dir)
        self.layer, self.legacy, self.return_pooled = layer, legacy, always_return_pooled
        self.max_length = max_length

    def prepare(self, value, device):
        return _tokens(value, lambda t: self.tokenizer(t, self.max_length), device)

    def forward(self, tokens):
        if self.legacy:
            if self.layer == "penultimate":
                return self.model(tokens, skip_last_layer=True)["penultimate_norm"]
            return self.model(tokens)["last_norm"]
        out = self.model(tokens)
        z = out["last" if self.layer == "last" else "penultimate"]
        return (z, out["pooled"]) if self.return_pooled else z


def antialiased_resize_matrix(n_in: int, n_out: int, method: str = "cubic",
                      antialias: bool = True) -> np.ndarray:
    """The (n_out, n_in) weights of ``jax.image.resize`` on one axis
    (``scale_and_translate``: Keys cubic a = -0.5 or linear, widened by the
    scale when downsampling with antialias, normalised over the taps that
    land inside, rows whose sample falls outside zeroed)."""
    scale = n_out / n_in
    kernel_scale = max(1.0 / scale, 1.0) if antialias else 1.0
    sample = ((np.arange(n_out, dtype=np.float32) + 0.5) / np.float32(scale) - 0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / kernel_scale
    if method == "cubic":
        w = ((1.5 * x - 2.5) * x) * x + 1.0
        w = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, w)
        w = np.where(x >= 2.0, 0.0, w)
    else:
        w = np.maximum(0.0, 1.0 - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).T.astype(np.float32)


class OpenCLIPImageEmbedder(Embedder):
    """FrozenOpenCLIPImageEmbedder: the vision tower on images resized to
    224 (antialiased bicubic) and CLIP-normalised; optional unsqueeze,
    repeat-to-``max_length`` or patch-token output."""

    MEAN = (0.48145466, 0.4578275, 0.40821073)
    STD = (0.26862954, 0.26130258, 0.27577711)
    ARCHS = {"ViT-H-14": (1280, 16, 32, 1024), "ViT-L-14": (1024, 16, 24, 768)}

    def __init__(self, arch: str = "ViT-H-14", unsqueeze_dim: bool = False,
                 repeat_to_max_len: bool = False, max_length: int = 77,
                 output_tokens: bool = False, model: Optional[nn.Module] = None):
        super().__init__()
        from ..modules.openclip import OpenCLIPVisionModel

        width, heads, layers, out_dim = self.ARCHS[arch]
        self.model = model if model is not None else OpenCLIPVisionModel(
            width=width, heads=heads, layers=layers, output_dim=out_dim)
        self.unsqueeze_dim, self.repeat_to_max_len = unsqueeze_dim, repeat_to_max_len
        self.max_length, self.output_tokens = max_length, output_tokens

    def prepare(self, value, device):
        """(B, H, W, 3) in [-1, 1] -> (B, 3, 224, 224) CLIP-normalised."""
        x = torch.as_tensor(np.asarray(value) if not torch.is_tensor(value) else value,
                            dtype=torch.float32, device=device)
        my = torch.from_numpy(antialiased_resize_matrix(x.shape[1], 224)).to(device)
        mx = torch.from_numpy(antialiased_resize_matrix(x.shape[2], 224)).to(device)
        x = (torch.einsum("ah,bhwc,dw->badc", my, x, mx) + 1.0) / 2.0
        mean = torch.tensor(self.MEAN, device=device)
        std = torch.tensor(self.STD, device=device)
        return ((x - mean) / std).permute(0, 3, 1, 2)

    def forward(self, images):
        if self.output_tokens:
            z, tokens = self.model(images, output_tokens=True)
            return tokens, z
        z = self.model(images)
        if self.unsqueeze_dim:
            z = z[:, None, :]
        if self.repeat_to_max_len:
            z_ = z[:, None, :] if z.dim() == 2 else z
            return z_.expand(z_.shape[0], self.max_length, z_.shape[-1]), z
        return z


class CLIPT5Embedder(Embedder):
    """FrozenCLIPT5Encoder: CLIP-L text and T5 embeddings side by side, a
    2-list."""

    def __init__(self, asset_dir: Optional[str] = None, clip_max_length: int = 77,
                 t5_max_length: int = 77, t5_version: str = "google/t5-v1_1-xl",
                 clip: Optional[nn.Module] = None, t5: Optional[nn.Module] = None):
        super().__init__()
        self.clip = CLIPTextEmbedder(clip, asset_dir=asset_dir, max_len=clip_max_length)
        self.t5 = T5TextEmbedder(version=t5_version, max_length=t5_max_length, model=t5)

    def prepare(self, value, device):
        return {"clip": self.clip.prepare(value, device), "t5": self.t5.prepare(value, device)}

    def forward(self, prepared):
        return [self.clip(prepared["clip"]), self.t5(prepared["t5"])]
