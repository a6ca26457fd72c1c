"""Whether what the timed path produced is correct: the plain reference
(``perfbench/reference``, float32 with TF32 off) run again on the same
seeded weights and inputs, once the window has closed and the program is
freed.

Each number is a relative L2 gap, ||program - reference|| / ||reference||,
the worst over what it covers:

* ``text_err``: each edit's text conditioning [uncond; cond], against CLIP
  on the hash tokenizer's ids of the same prompts;
* ``depth_err``: each edit's depth, as the annotator's network gave it,
  against the reference annotator's on the same clip;
* ``post_err``: each edit's hint against the reference post-process (the
  clip's min-max for MiDaS; resize, crop and the 2 %/85 % order
  statistics for ZoeDepth) of the program's own depth: the post-process
  alone, since it amplifies the depth's rounding by the depth's mean over
  its range, which the seeded weights set anywhere from 1 to 50;
* ``encode_err`` (with an edited reference frame): the appearance latent
  the rows were given, against the reference VAE encoder's mean times the
  scale factor;
* ``row_err``: a seeded sample of the finished rows (the last one always
  among them): each row's output against the reference network on that
  row's input latents and timestep, with the reference's own text, hint
  features and appearance latent;
* ``step_err``: every row's input latents against the reference sampler's
  (DPM++(2S) ancestral with CFG, from the edit's noise and, with an edited
  reference, the reference's own prior latent), the chain fed the rows'
  outputs; a finished edit's latents too; a timestep that is not the
  chain's counts as 1;
* ``decode_err``: each finished edit's frames against the reference VAE
  decoder on its latents.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from . import weights as W
from .cell import DTYPES
from .reference import build
from .reference.depth import midas_hint, zoe_hint, zoe_pad, zoe_resize_crop
from .reference.diffusion import rel_err, replay
from .reference.nets import hash_tokens

SCALE_FACTOR = 0.18215
CHUNK = 4  # frames the annotator and the decoder take at a time


def _frames(u8: np.ndarray, device) -> torch.Tensor:
    """(T, H, W, 3) uint8 -> (T, 3, H, W) in [-1, 1]."""
    return torch.from_numpy(u8).to(device).permute(0, 3, 1, 2).float() / 127.5 - 1.0


def _chunked(fn, x: torch.Tensor) -> torch.Tensor:
    return torch.cat([fn(x[i:i + CHUNK]) for i in range(0, x.shape[0], CHUNK)])


class Reference:
    """The plain reference's modules of a configuration on ``device``, in
    float32, with the weights of a seed (``load``)."""

    def __init__(self, config: Dict, device):
        self.config, self.device = config, device
        with torch.device("meta"):
            self.mods = build(config)
        for mod in self.mods.values():
            mod.to_empty(device=device).eval()

    @torch.no_grad()
    def load(self, weight_seed: int) -> None:
        made = W.make(W.config_spec(self.config), weight_seed, self.device,
                      DTYPES[self.config["dtype"]])
        for name, mod in self.mods.items():
            prefix = len(W.PREFIX[name])
            mod.load_state_dict({k[prefix:]: v.float() for k, v in made[name].items()},
                                strict=True)


def raw_depth(ref: "Reference", frames: torch.Tensor, annotator=None) -> torch.Tensor:
    """The reference annotator's network output on (T, 3, H, W) frames in
    [-1, 1]: (T, H, W) for MiDaS, ZoeDepth's at its padded input's size."""
    ann = annotator or ref.mods["annotator"]
    if ref.config["annotator"] == "depth_zoe":
        return _chunked(lambda f: ann(zoe_pad(f, ann.patch)), frames)
    return _chunked(ann, frames)


def post(ref: "Reference", raw: torch.Tensor, hw) -> torch.Tensor:
    """The hint (T, H, W, 3) of a clip's depth network output."""
    if ref.config["annotator"] == "depth_zoe":
        m = 2 * ref.mods["annotator"].patch
        padded = tuple(s + (m - s % m) % m for s in hw)
        return zoe_hint(zoe_resize_crop(raw, padded, hw))
    return midas_hint(raw)


@torch.no_grad()
def reference_numbers(ref: Reference, traffic: Dict, cell, sample_seed: int) -> Dict[str, float]:
    """The compared numbers of a finished window of ``cell`` (a
    ``cell.Cell``), against ``ref`` loaded with the same seed's weights."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _numbers(ref, traffic, cell, sample_seed)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _numbers(ref, traffic, cell, sample_seed):
    device, mods = ref.device, ref.mods
    net, vae, clip = mods["network"], mods["vae"], mods["clip"]
    steps, cfg = traffic["steps"], traffic["cfg_scale"]
    ref_cfg = traffic.get("reference")
    edits = {e.index: e for e in cell.edits if any(r.clip == e.index for r in cell.rows)}
    out = {"text_err": 0.0, "depth_err": 0.0, "post_err": 0.0, "step_err": 0.0}
    if ref_cfg:
        out["encode_err"] = 0.0
    derived = {}
    for i, e in edits.items():
        ids = hash_tokens([traffic["negative_prompt"], e.prompt]).to(device)
        context = clip(ids)
        out["text_err"] = max(out["text_err"], rel_err(e.context, context))
        frames = _frames(e.frames, device)
        depth = raw_depth(ref, frames)
        prog = torch.cat([r.float() for r in e.raw])
        out["depth_err"] = max(out["depth_err"], rel_err(prog, depth))
        hw = frames.shape[2:]
        out["post_err"] = max(out["post_err"], rel_err(e.hint[0], post(ref, prog, hw)))
        h = post(ref, depth, hw)
        feat = None
        x0 = e.init_noise.float()
        if ref_cfg:
            feat = vae.encode_mean(_frames(e.reference[None], device)) * SCALE_FACTOR
            out["encode_err"] = max(out["encode_err"],
                                    rel_err(e.cond_feat[1], feat[0].permute(1, 2, 0)))
            prior = feat.permute(0, 2, 3, 1)[:, None].expand_as(x0)
            x0 = x0 + ref_cfg["prior_coefficient_x"] * prior
        rows = [r for r in cell.rows if r.clip == i]
        err, times_ok, final = replay(x0, steps, cfg, e.loop_noise, [r.x for r in rows],
                                      [r.t for r in rows], [r.out for r in rows])
        out["step_err"] = max(out["step_err"], err if times_ok else 1.0)
        if e.latents is not None:
            out["step_err"] = max(out["step_err"], rel_err(e.latents, final)
                                  if final is not None else 1.0)
            dec = _chunked(vae.decode, e.latents[0].permute(0, 3, 1, 2).float() / SCALE_FACTOR)
            dec = ((dec + 1.0) * 127.5).clamp(0, 255).floor() / 127.5 - 1.0  # uint8 truncates
            out["decode_err"] = max(out.get("decode_err", 0.0),
                                    rel_err(_frames(e.output, device), dec))
        derived[i] = (context, net.hint_features(h[None]), feat)
    out["row_err"] = 0.0
    for r in sample_rows(cell.rows, traffic["check_rows"], sample_seed):
        context, features, feat = derived[r.clip]
        x = r.x.float().permute(0, 1, 4, 2, 3)
        eps = net(x, r.t, context, features.expand(2, *features.shape[1:]),
                  None if feat is None else feat.expand(2, *feat.shape[1:]))
        out["row_err"] = max(out["row_err"], rel_err(r.out.float(), eps.permute(0, 1, 3, 4, 2)))
    return out


def sample_rows(rows: List, n: int, seed: int) -> List:
    """``n`` finished rows drawn from ``seed``, the last one among them."""
    if not rows:
        return []
    rng = np.random.default_rng(seed % 2 ** 63)
    pick = set(rng.choice(len(rows) - 1, size=min(n - 1, len(rows) - 1), replace=False).tolist()
               ) if len(rows) > 1 else set()
    return [rows[i] for i in sorted(pick | {len(rows) - 1})]


def verdict(numbers: Dict[str, float], limits: Dict) -> bool:
    """Correct when every number has a limit and is within it, is finite,
    and every limit but the ``optional`` ones (a decode where the window
    may hold none) has its number."""
    lim = {k: v for k, v in limits.items() if k != "optional"}
    required = set(lim) - set(limits.get("optional", []))
    return (required <= set(numbers) and set(numbers) <= set(lim)
            and all(np.isfinite(v) and v <= lim[k] for k, v in numbers.items()))
