"""Plain diffusion arithmetic of a CCEdit edit: the LDM DDPM schedule,
the discrete eps denoiser, classifier-free guidance and the
DPM-Solver++(2S) ancestral sampler (k-diffusion's
``sample_dpmpp_2s_ancestral`` with eta 1), written from sgm and
k-diffusion in float64 for the schedule and float32 for the latents.

``Chain`` replays a sampler run one network row at a time: it says which
latents and timestep each row must be given and takes each row's output,
so a run's rows can be checked against it wherever they came from.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch


def ddpm_sigmas(n_train: int = 1000, start: float = 0.00085, end: float = 0.0120) -> np.ndarray:
    """The 1000 training sigmas, ascending by timestep."""
    betas = np.linspace(start ** 0.5, end ** 0.5, n_train, dtype=np.float64) ** 2
    abar = np.cumprod(1.0 - betas)
    return np.sqrt((1.0 - abar) / abar)


def sample_sigmas(steps: int, n_train: int = 1000) -> np.ndarray:
    """The sampler's descending sigmas of ``steps`` steps, then 0."""
    table = ddpm_sigmas(n_train)
    idx = np.linspace(n_train - 1, 0, steps, endpoint=False).astype(int)[::-1]
    return np.concatenate([table[idx][::-1], [0.0]])


def rows_per_clip(steps: int) -> int:
    """Network rows of a DPM++(2S) edit: two a step, one at the last step."""
    return 2 * steps - 1


class Chain:
    """The DPM++(2S) ancestral chain of one clip.  ``expected()`` gives the
    next row's (scaled latents, timestep); ``feed(eps)`` takes that row's
    network output, (2B, ...) on the [uncond; cond] batch.  ``dtype``
    rounds the latents to it after each update (a lower-precision chain)."""

    def __init__(self, x0: torch.Tensor, steps: int, cfg: float, loop_noise: torch.Tensor,
                 dtype: torch.dtype = torch.float32):
        self.round = lambda t: t.to(dtype).float()
        self.sig = sample_sigmas(steps)
        self.table = torch.from_numpy(ddpm_sigmas().astype(np.float32))
        self.cfg, self.noise = cfg, loop_noise
        self.x = x0.float() * float(np.float32(np.sqrt(1.0 + self.sig[0] ** 2)))
        self.i, self.stage = 0, 0  # step, and 0 (first row) or 1 (midpoint row)
        self.x_mid = None
        self.done = False

    def _step(self) -> dict:
        s, nxt = self.sig[self.i], self.sig[self.i + 1]
        up = min(nxt, (nxt ** 2 * (s ** 2 - nxt ** 2) / s ** 2) ** 0.5)
        down = (nxt ** 2 - up ** 2) ** 0.5
        out = dict(s=s, nxt=nxt, up=up, down=down)
        if down > 0:
            t, t_next = -np.log(s), -np.log(down)
            h = t_next - t
            out.update(mid=np.exp(-(t + 0.5 * h)), h=h)
        return {k: float(np.float32(v)) for k, v in out.items()}

    def _sigma(self) -> float:
        st = self._step()
        return st["s"] if self.stage == 0 else st["mid"]

    def _quantised(self, sigma: float) -> Tuple[float, int]:
        idx = int(torch.argmin((self.table - sigma).abs()))
        return float(self.table[idx]), idx

    def expected(self) -> Tuple[torch.Tensor, int]:
        """The next row's input: [x; x] * c_in and its timestep."""
        x = self.x if self.stage == 0 else self.x_mid
        sq, idx = self._quantised(self._sigma())
        xin = x * float(1.0 / np.sqrt(np.float32(sq) ** 2 + 1.0))
        return torch.cat([xin, xin]), idx

    def denoised(self, x: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        sq, _ = self._quantised(self._sigma())
        d = x - eps.float() * sq  # c_skip = 1, c_out = -sigma for each half
        u, c = d.chunk(2)
        return u + self.cfg * (c - u)

    def feed(self, eps: torch.Tensor) -> None:
        st = self._step()
        if self.stage == 0:
            den = self.denoised(torch.cat([self.x, self.x]), eps)
            if "mid" in st:
                r = st["mid"] / st["s"]
                self.x_mid = self.round(
                    r * self.x - float(np.float32(np.expm1(-0.5 * st["h"]))) * den)
                self.stage = 1
                return
            x = self.x + (st["down"] - st["s"]) * ((self.x - den) / st["s"])
        else:
            den = self.denoised(torch.cat([self.x_mid, self.x_mid]), eps)
            x = (st["down"] / st["s"]) * self.x - float(np.float32(np.expm1(-st["h"]))) * den
        if st["nxt"] > 0:
            x = x + self.noise[self.i].float() * st["up"]
        self.x, self.stage, self.i = self.round(x), 0, self.i + 1
        self.done = self.i == len(self.sig) - 1


def replay(x0: torch.Tensor, steps: int, cfg: float, loop_noise: torch.Tensor,
           rows_in: List[torch.Tensor], rows_t: List[torch.Tensor], rows_out: List[torch.Tensor]
           ) -> Tuple[float, bool, Optional[torch.Tensor]]:
    """Replay a clip's chain over the rows a run gave: (the largest relative
    L2 gap between a row's input and the chain's, rounded to the dtype the
    row was given, whether every timestep was the chain's, the final
    latents when the chain ended)."""
    chain = Chain(x0, steps, cfg, loop_noise)
    worst, times_ok = 0.0, True
    for xin, t, eps in zip(rows_in, rows_t, rows_out):
        want, idx = chain.expected()
        worst = max(worst, rel_err(xin.float(), want.to(xin.dtype).float()))
        times_ok &= bool((t.long() == idx).all())
        chain.feed(eps)
    return worst, times_ok, (chain.x if chain.done else None)


def rel_err(a: torch.Tensor, ref: torch.Tensor) -> float:
    """||a - ref|| / ||ref|| in float64."""
    a, ref = a.double(), ref.double().to(a.device)
    return float((a - ref).norm() / ref.norm().clamp_min(1e-30))
