"""The work a cell's configuration needs, counted from its shapes, and the
H100's published peaks.

FLOPs are the matrix products' and convolutions' (2 per multiply-add),
counted by ``torch.utils.flop_counter.FlopCounterMode`` over the plain
reference run on the ``meta`` device at the cell's sizes: no value is
computed, only shapes.  Work the configuration needs once is counted once,
whatever the program does: the ControlNet hint pyramid once a clip on its
T frames, and the appearance ControlNet once a row (both halves of the
guided batch feed it the same latent and timestep).

Peaks (NVIDIA's H100 SXM data sheet, dense, at the 700 W power limit): 989
TFLOP/s bf16, 3.35 TB/s HBM3.  The exp2 rate, 4.18 T/s, is inferred, not
published: 16 MUFU results a clock on each of 132 SMs at the 1.98 GHz
boost clock (the FlashAttention-3 paper's figure, section 3, at its lower
clock, gives 3.9 T/s; the higher clock makes the bound the smaller).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from .reference import build
from .reference.depth import zoe_depth

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
EXP2_PER_S = 16 * 132 * 1.98e9


def attention_bound_s(b: int, h: int, n_q: int, n_k: int, d: int) -> float:
    """The least time of one bf16 softmax attention: the larger of its two
    products at the tensor peak, its n_q * n_k exponentials at the exp2
    rate, and q, k, v read and o written once at the HBM rate."""
    products = 4.0 * b * h * n_q * n_k * d
    exps = float(b * h * n_q * n_k)
    nbytes = 2.0 * b * h * d * (2 * n_q + 2 * n_k)
    return max(products / BF16_FLOPS, exps / EXP2_PER_S, nbytes / HBM_BYTES_PER_S)


def _count(fn) -> float:
    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


@torch.no_grad()
def edit_flops(config: Dict, traffic: Dict, device="meta") -> Dict[str, float]:
    """FLOPs of one row and of each clip stage at the traffic's sizes."""
    t, hh, ww = traffic["frames"], traffic["height"], traffic["width"]
    h, w = hh // 8, ww // 8
    with torch.device(device):
        mods = build(config)
        net, vae, clip, ann = mods["network"], mods["vae"], mods["clip"], mods["annotator"]
        x = torch.zeros(2, t, 4, h, w)
        steps = torch.zeros(2, dtype=torch.long)
        ctx = torch.zeros(2, 77, clip.text_model.embeddings.token_embedding.embedding_dim)
        feats = torch.zeros(2, t, net.ch, h, w)
        feat = torch.zeros(1, 4, h, w) if hasattr(net, "controlnet_img") else None
        both = None if feat is None else feat.expand(2, -1, -1, -1)
        out = {"row": _count(lambda: net(x, steps, ctx, feats, both))}
        if feat is not None:  # the appearance branch once a row, not on both halves
            cn = net.controlnet_img
            out["row"] -= _count(lambda: cn(feat, cn.hint_features(feat), steps[:1], ctx[:1]))
            out["encode"] = _count(lambda: vae.encode_mean(torch.zeros(1, 3, hh, ww)))
        out["pyramid"] = _count(lambda: net.controlnet.hint_features(torch.zeros(t, 3, hh, ww)))
        out["text"] = _count(lambda: clip(torch.zeros(2, 77, dtype=torch.long)))
        frames = torch.zeros(t, 3, hh, ww)
        if config["annotator"] == "depth_zoe":
            out["hint"] = _count(lambda: zoe_depth(ann, frames))
        else:
            out["hint"] = _count(lambda: ann(frames))
        out["decode"] = _count(lambda: vae.decode(torch.zeros(t, 4, h, w)))
    return out
