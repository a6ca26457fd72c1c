"""ZoeDepth metric depth, the TVI2V structure hint as shipped (port of
``ccedit_tpu/conditioning/annotators/zoedepth.py``: ``ZoeDepthN``,
``zoedepth_grid_for``, ``adapt_zoedepth_grid``, ``detect_depth_zoe`` and the
HF state-dict layout of ``convert_zoedepth``).

ZoeD_M12_N: a BEiT-L/384 MiDaS core and the ZoeDepth metric-bins head.

* BEiT encoder: LayerNorm epsilon 1e-12, exact erf GELU, q and v with a
  bias and k without, layer-scale gammas (``lambda_1``/``lambda_2``), and a
  per-layer decomposed relative-position bias whose three cls entries are
  the table's last rows.  The logits are fp32 with the bias added in fp32,
  and the softmax is fp32.  The attention is a plain matmul, as in the JAX
  module (it carries the bias, so it never reaches the attention dispatch).
* The checkpoint's bias tables belong to the 24x24 pretraining grid.  Each
  input grid gets its tables resampled once, from the checkpoint's (never
  twice), with HF's quirk of reshaping the flat table as (old_w, old_h)
  before the bilinear resize; they are cached per grid.
* DPT reassemble ("project" readout, factors 4/2/1/0.5: the x4/x2 resizes
  are ConvTranspose2d with kernel = stride, the 0.5 a stride-2 conv), the
  fusion pyramid, the relative head, and the metric head: softplus seed
  bins, projectors, attractors (inv_attractor with alpha 300, gamma 2,
  'mean' over the attractors), and the conditional log-binomial over the
  bins (lgamma coefficients, probabilities clipped at 1e-4, a temperature).

Submodules carry the HF ``ZoeDepthForDepthEstimation`` names, so
``zoedepth_from_state_dict`` sizes the module to such a state dict and
loads it with a strict ``load_state_dict``.  The module works channels-first inside; its input is
(N, H, W, 3) normalised frames, ``detect_depth_zoe``'s (N, H, W, 3) in
[0, 1].
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .dpt_midas import _resize


def beit_relative_position_index(h: int, w: int) -> np.ndarray:
    """Relative-position index of an (h, w) window's h*w + 1 tokens (cls
    first); the table's last three rows are cls-to-token, token-to-cls and
    cls-to-cls."""
    num_rel = (2 * h - 1) * (2 * w - 1)
    coords = np.stack(np.meshgrid(np.arange(h), np.arange(w), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += h - 1
    rel[:, :, 1] += w - 1
    rel[:, :, 0] *= 2 * w - 1
    index = np.zeros((h * w + 1, h * w + 1), np.int64)
    index[1:, 1:] = rel.sum(-1)
    index[0, 0:] = num_rel
    index[0:, 0] = num_rel + 1
    index[0, 0] = num_rel + 2
    return index


def table_grid(rows: int) -> Tuple[int, int]:
    """The square window of a bias table with ``rows`` rows (3 cls rows
    included)."""
    s = math.isqrt(rows - 3)
    if s * s != rows - 3:
        raise ValueError(f"cannot infer a square grid from {rows - 3} rows")
    return (s + 1) // 2, (s + 1) // 2


def interpolate_rel_bias_table(table: torch.Tensor, new_grid: Tuple[int, int],
                               old_grid: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """A ((2h-1)(2w-1) + 3, heads) bias table resampled, in fp32, to the
    window ``new_grid``: the flat rows reshaped as (old_w, old_h), as HF
    does, resized bilinearly (align_corners=False), the cls rows kept."""
    old_grid = old_grid or table_grid(table.shape[0])
    old_h, old_w = 2 * old_grid[0] - 1, 2 * old_grid[1] - 1
    new_h, new_w = 2 * new_grid[0] - 1, 2 * new_grid[1] - 1
    table = table.float()
    if (old_h, old_w) == (new_h, new_w):
        return table
    sub = table[:old_h * old_w].reshape(1, old_w, old_h, -1).permute(0, 3, 1, 2)
    sub = F.interpolate(sub, size=(new_h, new_w), mode="bilinear", align_corners=False)
    return torch.cat([sub.permute(0, 2, 3, 1).reshape(new_h * new_w, -1),
                      table[old_h * old_w:]])


class _Dense(nn.Module):
    """HF's ``*.dense`` wrapper."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.dense = nn.Linear(cin, cout)


class _RelativePositionBias(nn.Module):
    def __init__(self, n_rel: int, heads: int):
        super().__init__()
        self.relative_position_bias_table = nn.Parameter(torch.zeros(n_rel, heads))


class _SelfAttention(nn.Module):
    def __init__(self, hidden: int, heads: int, n_rel: int):
        super().__init__()
        self.query = nn.Linear(hidden, hidden)
        self.key = nn.Linear(hidden, hidden, bias=False)
        self.value = nn.Linear(hidden, hidden)
        self.relative_position_bias = _RelativePositionBias(n_rel, heads)


class _Attention(nn.Module):
    def __init__(self, hidden: int, heads: int, n_rel: int):
        super().__init__()
        self.attention = _SelfAttention(hidden, heads, n_rel)
        self.output = _Dense(hidden, hidden)


class BeitLayer(nn.Module):
    def __init__(self, hidden: int, heads: int, n_rel: int):
        super().__init__()
        self.heads = heads
        self.attention = _Attention(hidden, heads, n_rel)
        self.intermediate = _Dense(hidden, 4 * hidden)
        self.output = _Dense(4 * hidden, hidden)
        self.layernorm_before = nn.LayerNorm(hidden, eps=1e-12)
        self.layernorm_after = nn.LayerNorm(hidden, eps=1e-12)
        self.lambda_1 = nn.Parameter(torch.ones(hidden))
        self.lambda_2 = nn.Parameter(torch.ones(hidden))

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
        """x (B, L, hidden); bias (heads, L, L) fp32 or None (no bias)."""
        b, n, c = x.shape
        att = self.attention.attention
        h = self.layernorm_before(x)

        def split(t):
            return t.reshape(b, n, self.heads, c // self.heads).transpose(1, 2)

        q, k, v = split(att.query(h)), split(att.key(h)), split(att.value(h))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (c // self.heads) ** -0.5
        if bias is not None:
            logits = logits + bias
        weights = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.matmul(weights, v).transpose(1, 2).reshape(b, n, c)
        x = x + self.lambda_1 * self.attention.output.dense(out)
        h = self.output.dense(F.gelu(self.intermediate.dense(self.layernorm_after(x))))
        return x + self.lambda_2 * h


class _Embeddings(nn.Module):
    def __init__(self, hidden: int, patch: int):
        super().__init__()
        self.cls_token = nn.Parameter(torch.zeros(1, 1, hidden))
        self.patch_embeddings = nn.Module()
        self.patch_embeddings.projection = nn.Conv2d(3, hidden, patch, stride=patch)


class _Backbone(nn.Module):
    def __init__(self, hidden: int, heads: int, layers: int, patch: int, n_rel: int):
        super().__init__()
        self.embeddings = _Embeddings(hidden, patch)
        self.encoder = nn.Module()
        self.encoder.layer = nn.ModuleList(BeitLayer(hidden, heads, n_rel) for _ in range(layers))


class _ReassembleLayer(nn.Module):
    def __init__(self, hidden: int, ch: int, factor: float):
        super().__init__()
        self.projection = nn.Conv2d(hidden, ch, 1)
        if factor > 1:
            self.resize = nn.ConvTranspose2d(ch, ch, int(factor), stride=int(factor))
        elif factor < 1:
            self.resize = nn.Conv2d(ch, ch, 3, stride=int(1 / factor), padding=1)


class _PreActResidual(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.convolution1 = nn.Conv2d(ch, ch, 3, padding=1)
        self.convolution2 = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return x + self.convolution2(F.relu(self.convolution1(F.relu(x))))


class FusionLayer(nn.Module):
    """x + residual unit of the lateral (resized to x), residual unit, 2x
    bilinear upsample (align_corners=True), 1x1 projection."""

    def __init__(self, ch: int):
        super().__init__()
        self.projection = nn.Conv2d(ch, ch, 1)
        self.residual_layer1 = _PreActResidual(ch)
        self.residual_layer2 = _PreActResidual(ch)

    def forward(self, x, residual=None):
        if residual is not None:
            x = x + self.residual_layer1(_resize(residual, x.shape[2:], align_corners=False))
        x = self.residual_layer2(x)
        return self.projection(_resize(x, (2 * x.shape[2], 2 * x.shape[3]), align_corners=True))


class _TwoConv(nn.Module):
    """conv1 -> ReLU -> conv2 (1x1): the seed regressor, the projectors and
    the attractors."""

    def __init__(self, cin: int, mid: int, cout: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, mid, 1)
        self.conv2 = nn.Conv2d(mid, cout, 1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


class ZoeDepthN(nn.Module):
    """Single-head ZoeDepth (ZoeD_M12_N).  Sizes default to the production
    model (bias tables at the 24x24 pretraining grid); every one is
    overridable, so tests run a tiny replica."""

    def __init__(self, hidden: int = 1024, heads: int = 16, layers: int = 24, patch: int = 16,
                 out_indices: Sequence[int] = (5, 11, 17, 23),
                 neck_hidden: Sequence[int] = (256, 512, 1024, 1024),
                 factors: Sequence[float] = (4, 2, 1, 0.5), fusion_ch: int = 256,
                 n_bins: int = 64, bin_embedding_dim: int = 128,
                 num_attractors: Sequence[int] = (16, 8, 4, 1), num_relative_features: int = 32,
                 seed_mlp_dim: int = 256, proj_mlp_dim: int = 128, min_temp: float = 0.0212,
                 max_temp: float = 50.0, pretrain_grid: Tuple[int, int] = (24, 24)):
        super().__init__()
        self.hidden, self.patch, self.out_indices = hidden, patch, tuple(out_indices)
        self.n_bins, self.num_attractors = n_bins, tuple(num_attractors)
        self.min_temp, self.max_temp = min_temp, max_temp
        self.pretrain_grid = tuple(pretrain_grid)
        n_rel = (2 * pretrain_grid[0] - 1) * (2 * pretrain_grid[1] - 1) + 3
        self.backbone = _Backbone(hidden, heads, layers, patch, n_rel)
        self.neck = nn.Module()
        self.neck.reassemble_stage = nn.Module()
        self.neck.reassemble_stage.readout_projects = nn.ModuleList(
            nn.Sequential(nn.Linear(2 * hidden, hidden), nn.GELU()) for _ in range(4))
        self.neck.reassemble_stage.layers = nn.ModuleList(
            _ReassembleLayer(hidden, c, f) for c, f in zip(neck_hidden, factors))
        self.neck.convs = nn.ModuleList(nn.Conv2d(c, fusion_ch, 3, padding=1, bias=False)
                                        for c in neck_hidden)
        self.neck.fusion_stage = nn.Module()
        self.neck.fusion_stage.layers = nn.ModuleList(FusionLayer(fusion_ch) for _ in range(4))
        self.relative_head = nn.Module()
        self.relative_head.conv1 = nn.Conv2d(fusion_ch, fusion_ch // 2, 3, padding=1)
        self.relative_head.conv2 = nn.Conv2d(fusion_ch // 2, num_relative_features, 3, padding=1)
        self.relative_head.conv3 = nn.Conv2d(num_relative_features, 1, 1)
        mh = self.metric_head = nn.Module()
        mh.conv2 = nn.Conv2d(fusion_ch, fusion_ch, 1)
        mh.seed_bin_regressor = _TwoConv(fusion_ch, seed_mlp_dim, n_bins)
        mh.seed_projector = _TwoConv(fusion_ch, proj_mlp_dim, bin_embedding_dim)
        mh.projectors = nn.ModuleList(_TwoConv(fusion_ch, proj_mlp_dim, bin_embedding_dim)
                                      for _ in range(4))
        mh.attractors = nn.ModuleList(_TwoConv(bin_embedding_dim, bin_embedding_dim, a)
                                      for a in num_attractors)
        bott = (num_relative_features + 1 + bin_embedding_dim) // 2
        mh.conditional_log_binomial = nn.Module()
        mh.conditional_log_binomial.mlp = nn.Sequential(
            nn.Conv2d(num_relative_features + 1 + bin_embedding_dim, bott, 1), nn.GELU(),
            nn.Conv2d(bott, 4, 1))
        self._grid_cache: Dict = {}

    def rel_bias_tables(self) -> List[torch.Tensor]:
        return [layer.attention.attention.relative_position_bias.relative_position_bias_table
                for layer in self.backbone.encoder.layer]

    def grid_bias(self, grid: Tuple[int, int]):
        """(per-layer tables at ``grid``, the window's index), from the
        checkpoint-grid tables; cached per grid while the tables are
        unchanged."""
        tables = self.rel_bias_tables()
        key = (grid, tuple((t.data_ptr(), t._version, t.dtype) for t in tables))
        hit = self._grid_cache.get(grid)
        if hit is None or hit[0] != key:
            index = torch.from_numpy(beit_relative_position_index(*grid)).to(tables[0].device)
            hit = self._grid_cache[grid] = (key, adapt_zoedepth_grid(self, grid), index)
        return hit[1], hit[2]

    def forward(self, images: torch.Tensor, rel_bias: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """images (B, H, W, 3) normalised, H and W multiples of the patch ->
        (metric depth, relative depth), each (B, H, W).  ``rel_bias=False``
        leaves the relative-position bias out (a planted fault)."""
        b, ih, iw, _ = images.shape
        ph, pw = ih // self.patch, iw // self.patch
        emb = self.backbone.embeddings
        x = emb.patch_embeddings.projection(images.to(emb.cls_token.dtype).permute(0, 3, 1, 2))
        x = torch.cat([emb.cls_token.expand(b, -1, -1), x.flatten(2).transpose(1, 2)], dim=1)
        tables, index = self.grid_bias((ph, pw))
        tokens = []
        for i, layer in enumerate(self.backbone.encoder.layer):
            x = layer(x, tables[i].t()[:, index] if rel_bias else None)
            if i in self.out_indices:
                tokens.append(x)

        rs = self.neck.reassemble_stage
        feats = []
        for i, t in enumerate(tokens):
            cls, patches = t[:, :1], t[:, 1:]
            h = rs.readout_projects[i](torch.cat([patches, cls.expand_as(patches)], dim=-1))
            h = rs.layers[i].projection(h.transpose(1, 2).reshape(b, self.hidden, ph, pw))
            if hasattr(rs.layers[i], "resize"):
                h = rs.layers[i].resize(h)
            feats.append(self.neck.convs[i](h))

        fused, state = [], None
        for layer, f in zip(self.neck.fusion_stage.layers, feats[::-1]):
            state = layer(f) if state is None else layer(state, f)
            fused.append(state)

        rh = self.relative_head
        h = rh.conv1(fused[-1])
        rel_features = F.relu(rh.conv2(_resize(h, (2 * h.shape[2], 2 * h.shape[3]), True)))
        rel_depth = F.relu(rh.conv3(rel_features))

        mh = self.metric_head
        x = mh.conv2(feats[-1])
        prev_bin = F.softplus(mh.seed_bin_regressor(x))
        prev_emb = mh.seed_projector(x)
        bin_centers = prev_bin
        for i, feat in enumerate(fused):
            emb_i = mh.projectors[i](feat)
            hw = emb_i.shape[2:]
            attractors = F.softplus(mh.attractors[i](emb_i + _resize(prev_emb, hw, True)))
            centers = _resize(prev_bin, hw, True)
            dx = attractors[:, :, None] - centers[:, None]  # (B, attractors, bins, h, w)
            delta = (dx / (1.0 + 300.0 * dx * dx)).sum(dim=1) / float(self.num_attractors[i])
            bin_centers = centers + delta
            prev_bin, prev_emb = bin_centers, emb_i

        hw = rel_features.shape[2:]
        last = torch.cat([rel_features, _resize(rel_depth, hw, True)], dim=1)
        mlp = mh.conditional_log_binomial.mlp
        p = mlp(torch.cat([last, _resize(prev_emb, hw, True)], dim=1)).float()
        p = F.softplus(p) + 1e-4
        prob = p[:, 0] / (p[:, 0] + p[:, 1])
        temp = p[:, 2] / (p[:, 2] + p[:, 3])
        temp = (self.max_temp - self.min_temp) * temp + self.min_temp
        k = self.n_bins
        k_idx = torch.arange(k, dtype=torch.float32, device=p.device)
        log_binom = (torch.lgamma(torch.tensor(float(k), device=p.device))
                     - torch.lgamma(k_idx + 1.0) - torch.lgamma(k - k_idx))
        y = (log_binom[None, :, None, None]
             + k_idx[None, :, None, None] * torch.log(prob.clamp(1e-4, 1.0))[:, None]
             + (k - 1 - k_idx)[None, :, None, None]
             * torch.log((1.0 - prob).clamp(1e-4, 1.0))[:, None])
        probs = torch.softmax(y / temp[:, None], dim=1)
        depth = (probs * _resize(bin_centers.float(), probs.shape[2:], True)).sum(dim=1)
        return depth, rel_depth[:, 0]


def zoedepth_grid_for(h: int, w: int, patch: int = 16) -> Tuple[int, int]:
    """The patch grid ``detect_depth_zoe`` runs at for an (h, w) input
    (edge-padded to a multiple of 2 * patch)."""
    mult = patch * 2
    return (h + (mult - h % mult) % mult) // patch, (w + (mult - w % mult) % mult) // patch


@torch.no_grad()
def adapt_zoedepth_grid(model: ZoeDepthN, grid: Tuple[int, int]) -> List[torch.Tensor]:
    """Every BEiT bias table of ``model`` (checkpoint grid) resampled to
    ``grid``, fp32: what ``convert_zoedepth(..., grid=grid)`` gives."""
    return [interpolate_rel_bias_table(t, grid, model.pretrain_grid)
            for t in model.rel_bias_tables()]


def detect_depth_zoe(model: ZoeDepthN, frames01: torch.Tensor, rel_bias: bool = True
                     ) -> torch.Tensor:
    """frames01 (N, H, W, 3) in [0, 1] -> metric depth (N, H, W): normalised
    with mean = std = 0.5, edge-padded to a multiple of 2 * patch, the depth
    resized to the padded size and cropped."""
    x = (frames01 - 0.5) / 0.5
    n, h, w, _ = x.shape
    mult = model.patch * 2
    ph, pw = (mult - h % mult) % mult, (mult - w % mult) % mult
    if ph or pw:
        x = F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph), mode="replicate").permute(0, 2, 3, 1)
    depth, _ = model(x, rel_bias=rel_bias)
    depth = _resize(depth[:, None], (x.shape[1], x.shape[2]), align_corners=False)[:, 0]
    return depth[:, :h, :w]


def _hf_names(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``q_bias``/``v_bias`` as ``query.bias``/``value.bias``; the relative
    position index buffers (recomputed here) dropped."""
    out = {}
    for k, v in sd.items():
        if k.endswith("relative_position_index"):
            continue
        out[k.replace("attention.q_bias", "attention.query.bias")
             .replace("attention.v_bias", "attention.value.bias")] = v
    return out


def zoedepth_from_state_dict(sd: Dict[str, torch.Tensor]) -> ZoeDepthN:
    """A ``ZoeDepthN`` sized to an HF ``ZoeDepthForDepthEstimation`` state
    dict (taps evenly spaced: layers 5/11/17/23 of 24), strictly loaded with
    its weights."""
    sd = _hf_names(sd)
    att = "backbone.encoder.layer.0.attention.attention."
    rs, mh = "neck.reassemble_stage.layers", "metric_head"
    layers = sum(1 for k in sd if k.startswith("backbone.encoder.layer.") and
                 k.endswith(".lambda_1"))
    factors = []
    for i in range(4):
        w = sd.get(f"{rs}.{i}.resize.weight")
        factors.append(1 if w is None else (w.shape[-1] if i < 2 else 0.5))
    table = sd[att + "relative_position_bias.relative_position_bias_table"]
    model = ZoeDepthN(
        hidden=sd["backbone.embeddings.cls_token"].shape[-1], heads=table.shape[1],
        layers=layers, patch=sd["backbone.embeddings.patch_embeddings.projection.weight"].shape[-1],
        out_indices=tuple(layers // 4 * (i + 1) - 1 for i in range(4)),
        neck_hidden=tuple(sd[f"{rs}.{i}.projection.weight"].shape[0] for i in range(4)),
        factors=tuple(factors), fusion_ch=sd["neck.convs.0.weight"].shape[0],
        n_bins=sd[f"{mh}.seed_bin_regressor.conv2.weight"].shape[0],
        bin_embedding_dim=sd[f"{mh}.seed_projector.conv2.weight"].shape[0],
        num_attractors=tuple(sd[f"{mh}.attractors.{i}.conv2.weight"].shape[0] for i in range(4)),
        num_relative_features=sd["relative_head.conv2.weight"].shape[0],
        seed_mlp_dim=sd[f"{mh}.seed_bin_regressor.conv1.weight"].shape[0],
        proj_mlp_dim=sd[f"{mh}.seed_projector.conv1.weight"].shape[0],
        pretrain_grid=table_grid(table.shape[0]))
    model.load_state_dict(sd, strict=True)
    return model


@torch.no_grad()
def randomize_zoedepth_(model: ZoeDepthN, generator: torch.Generator) -> ZoeDepthN:
    """Seeded random weights that keep every BEiT block live: the
    ``randomize_weights_`` init, then the layer-scale gammas at HF's
    ``layer_scale_init_value`` (0.1; zero gammas would make each block the
    identity) and N(0, 1) bias tables."""
    from ...io.checkpoint import randomize_weights_

    randomize_weights_(model, generator)
    for layer in model.backbone.encoder.layer:
        layer.lambda_1.fill_(0.1)
        layer.lambda_2.fill_(0.1)
    for table in model.rel_bias_tables():
        table.normal_(0.0, 1.0, generator=generator)
    return model
