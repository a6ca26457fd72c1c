"""k-diffusion samplers (port of ``ccedit_tpu/diffusion/samplers.py``):
Euler and Heun EDM (with churn), Euler-ancestral, DPM++2S-ancestral (the
CCEdit default), DPM++2M and linear multistep, each with the base loop's
modes: the full chain, ``sdedit`` (only the last ``denoise_steps`` steps of
the schedule), inpainting and blending.

Each loop is a plain Python loop over the reference's steps.  Every
per-step scalar is computed host-side in float64 and rounded to float32
once, as the JAX package feeds them to its scans; the sampler state stays
float32.  A step whose second network evaluation degenerates at
next_sigma = 0 (Heun's correction, DPM++2S's midpoint) is a plain Euler
step, as in the JAX package.  The JAX half-step ``lax.scan`` and
``segment_size`` were TPU compile and RPC workarounds and have no
counterpart here.

Noise: ``noise_override`` replaces the draws from ``generator``.  An array
(num executed steps, *x.shape) holds the loop noise (the ancestral sigma_up
noise, or the EDM churn); the dict form ``{"loop": rows, "pre": rows}``
also holds the pre-step hook's draws (the noised clean latent of
inpainting and blending), which the reference makes before each step's
own.  A missing entry is drawn from ``generator``.  Loop noise is drawn
only where it is used: where next_sigma > 0 (ancestral) or gamma > 0
(EDM churn).  Under a clip shard each draw is the whole clip's, of which
this rank keeps its block (``parallel/shard.py::clip_randn``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..parallel.shard import active, clip_randn
from .discretization import Discretization, LegacyDDPMDiscretization


def get_ancestral_step(sigma_from: np.ndarray, sigma_to: np.ndarray,
                       eta: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """(sigma_down, sigma_up) split of one ancestral step."""
    if not eta:
        return sigma_to, np.zeros_like(sigma_to)
    sigma_up = np.minimum(
        sigma_to,
        eta * (sigma_to ** 2 * (sigma_from ** 2 - sigma_to ** 2) / sigma_from ** 2) ** 0.5)
    return (sigma_to ** 2 - sigma_up ** 2) ** 0.5, sigma_up


def linear_multistep_coeff(order: int, t: np.ndarray, i: int, j: int) -> float:
    """Adams-Bashforth coefficient: the integral over [t_i, t_{i+1}] of the
    Lagrange basis polynomial prod_{k != j} (tau - t_{i-k}) / (t_{i-j} -
    t_{i-k}), integrated exactly."""
    if order - 1 > i:
        raise ValueError(f"order {order} too high for step {i}")
    poly = np.polynomial.Polynomial([1.0])
    for k in range(order):
        if j != k:
            poly = poly * np.polynomial.Polynomial(
                [-t[i - k] / (t[i - j] - t[i - k]), 1.0 / (t[i - j] - t[i - k])])
    integ = poly.integ()
    return float(integ(t[i + 1]) - integ(t[i]))


def _f32(v) -> float:
    """A host scalar rounded to float32 once, as the JAX scans' constants."""
    return float(np.float32(v))


class _Noise:
    """The sampler's draws: injected rows (``noise_override``), else
    ``generator``."""

    def __init__(self, override, n_steps: int, x: torch.Tensor,
                 generator: Optional[torch.Generator], loop: bool = True):
        rows = override if isinstance(override, dict) else {"loop": override}
        if set(rows) - {"loop", "pre"}:
            raise ValueError(f"noise_override keys {sorted(rows)} (expected 'loop' and 'pre')")
        if not loop and rows.get("loop") is not None:
            raise ValueError("this sampler draws no loop noise: noise_override may only "
                             "hold the pre-step rows ({'pre': rows})")
        want = (n_steps,) + tuple(x.shape)
        for k, v in rows.items():
            if v is not None and tuple(v.shape) != want:
                raise ValueError(f"noise_override[{k!r}] shape {tuple(v.shape)} != {want} "
                                 "(one row per sampler step)")
        self.rows, self.generator = rows, generator

    def draw(self, kind: str, i: int, x: torch.Tensor) -> torch.Tensor:
        rows = self.rows.get(kind)
        if rows is not None:
            return rows[i].to(x)
        return clip_randn(x.shape, self.generator, x.device, x.dtype)


def _pre_step(mode: str, x0: torch.Tensor, mask: Optional[torch.Tensor]) -> Callable:
    """The pre-step hook of inpainting and blending: ``fn(x, sigma, noise)``
    with img_orig = (x0 + noise * sigma) / sqrt(1 + sigma^2).  Inpainting
    keeps x where ``mask`` is 1 and img_orig where it is 0; blending
    re-seeds the first half of the clip (axis 1) from img_orig's second
    half (under a frame shard on the gathered clip, of which this rank
    keeps its block)."""
    def fn(x, sigma: float, noise):
        s = np.float32(sigma)
        img_orig = (x0 + noise * float(s)) / float(np.sqrt(np.float32(1.0) + s * s))
        if mode == "inpaint":
            return x * mask + img_orig * (1.0 - mask)
        shard = active()
        frame = shard is not None and shard.frame
        if frame:  # the frames it moves lie on other ranks: the hook on the whole clip
            x, img_orig = shard.gather(x, 1), shard.gather(img_orig, 1)
        t = x.shape[1]
        out = x.clone()
        out[:, : t // 2] = img_orig[:, t // 2 + 1:]
        return shard.block(out, 1) if frame else out
    return fn


@dataclasses.dataclass
class BaseSampler:
    discretization: Discretization = dataclasses.field(default_factory=LegacyDDPMDiscretization)
    num_steps: Optional[int] = None
    s_noise: float = 1.0

    draws_loop_noise = True

    def get_sigmas(self, num_steps: Optional[int] = None) -> np.ndarray:
        n = num_steps if num_steps is not None else self.num_steps
        if n is None:
            raise ValueError("num_steps not set")
        return np.asarray(self.discretization(n, do_append_zero=True), dtype=np.float64)

    def prepare_x(self, x: torch.Tensor, sigmas: np.ndarray) -> torch.Tensor:
        return x * _f32(np.sqrt(1.0 + sigmas[0] ** 2))

    def _start(self, denoise_fn, x, num_steps, start_step, pre, noise_override, generator):
        sigmas = self.get_sigmas(num_steps)
        n = len(sigmas) - 1 - start_step
        noise = _Noise(noise_override, n, x, generator, self.draws_loop_noise)
        return self._run(denoise_fn, self.prepare_x(x, sigmas), sigmas, start_step, pre, noise)

    def __call__(self, denoise_fn: Callable, x: torch.Tensor, num_steps: Optional[int] = None,
                 noise_override=None, generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        """The full chain from ``x`` (unit-variance noise).
        ``denoise_fn(x, sigma: float) -> denoised``."""
        return self._start(denoise_fn, x, num_steps, 0, None, noise_override, generator)

    def sdedit(self, denoise_steps: int, denoise_fn: Callable, x: torch.Tensor,
               num_steps: Optional[int] = None, noise_override=None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Only the last ``denoise_steps`` steps of the schedule; ``x`` is
        already the noised input.  Injected rows cover the executed steps."""
        start = len(self.get_sigmas(num_steps)) - 1 - denoise_steps
        return self._start(denoise_fn, x, num_steps, start, None, noise_override, generator)

    def sample_inpainting(self, denoise_fn: Callable, x: torch.Tensor, x0: torch.Tensor,
                          mask: torch.Tensor, num_steps: Optional[int] = None,
                          noise_override=None, generator: Optional[torch.Generator] = None
                          ) -> torch.Tensor:
        """Before each step, x keeps its own values where ``mask`` is 1 and
        takes the clean latent ``x0`` noised to the step's sigma where it
        is 0."""
        return self._start(denoise_fn, x, num_steps, 0, _pre_step("inpaint", x0, mask),
                           noise_override, generator)

    def sampling_blending(self, denoise_fn: Callable, x: torch.Tensor, x0: torch.Tensor,
                          num_steps: Optional[int] = None, noise_override=None,
                          generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Before each step, frames [: T//2] are re-seeded from frames
        [T//2 + 1 :] of ``x0`` noised to the step's sigma."""
        return self._start(denoise_fn, x, num_steps, 0, _pre_step("blend", x0, None),
                           noise_override, generator)

    def _run(self, denoise_fn, x, sigmas, start, pre, noise: _Noise) -> torch.Tensor:
        raise NotImplementedError


@dataclasses.dataclass
class EulerEDMSampler(BaseSampler):
    s_churn: float = 0.0
    s_tmin: float = 0.0
    s_tmax: float = float("inf")

    heun = False

    def _gammas(self, sigmas: np.ndarray) -> np.ndarray:
        n = len(sigmas)
        return np.asarray([min(self.s_churn / (n - 1), 2 ** 0.5 - 1)
                           if self.s_tmin <= s <= self.s_tmax else 0.0 for s in sigmas[:-1]])

    def _run(self, denoise_fn, x, sigmas, start, pre, noise):
        idx = np.arange(start, len(sigmas) - 1)
        sig, nxt, gam = sigmas[idx], sigmas[idx + 1], self._gammas(sigmas)[idx]
        sig_hat = sig * (gam + 1.0)
        churn = np.sqrt(np.maximum(sig_hat ** 2 - sig ** 2, 0.0)) * self.s_noise
        for i in range(len(idx)):
            if pre is not None:
                x = pre(x, sig[i], noise.draw("pre", i, x))
            if gam[i] > 0:
                x = x + noise.draw("loop", i, x) * _f32(churn[i])
            s_hat, s_next = np.float32(sig_hat[i]), np.float32(nxt[i])
            d = (x - denoise_fn(x, float(s_hat))) / float(s_hat)
            dt = s_next - s_hat
            x_euler = x + float(dt) * d
            if self.heun and nxt[i] > 1e-14:  # Heun's correction, none at next_sigma = 0
                d2 = (x_euler - denoise_fn(x_euler, float(s_next))) / float(s_next)
                x = x + float(dt * np.float32(0.5)) * (d + d2)
            else:
                x = x_euler
        return x


@dataclasses.dataclass
class HeunEDMSampler(EulerEDMSampler):
    heun = True


@dataclasses.dataclass
class AncestralSampler(BaseSampler):
    eta: float = 1.0

    def step_table(self, sigmas: np.ndarray, start: int = 0) -> list:
        """Per-step float32 constants: sigma, next_sigma, sigma_down,
        sigma_up, the midpoint sigma and the DPM++ mults m1..m4
        (t = -log sigma, h = t_down - t, s = t + h/2; m1 = sigma(s)/sigma,
        m2 = expm1(-h/2), m3 = sigma_down/sigma, m4 = expm1(-h)).  A step
        whose sigma_down is 0 has no midpoint."""
        sig, nxt = sigmas[start:-1], sigmas[start + 1:]
        down, up = get_ancestral_step(sig, nxt, eta=self.eta)
        with np.errstate(divide="ignore", invalid="ignore"):
            t = -np.log(sig)
            h = -np.log(np.where(down > 0, down, 1.0)) - t
            sig_mid = np.exp(-(t + 0.5 * h))
            cols = dict(sigma=sig, next_sigma=nxt, sigma_down=down, sigma_up=up,
                        sigma_mid=sig_mid, m1=sig_mid / sig, m2=np.expm1(-0.5 * h),
                        m3=np.where(down > 0, down, 0.0) / sig, m4=np.expm1(-h))
        f32 = {k: np.nan_to_num(v).astype(np.float32) for k, v in cols.items()}
        return [dict({k: float(v[i]) for k, v in f32.items()}, midpoint=bool(down[i] >= 1e-14))
                for i in range(len(sig))]

    def _ancestral_noise(self, x, st: dict, noise: _Noise, i: int) -> torch.Tensor:
        if st["next_sigma"] > 0.0:
            x = x + noise.draw("loop", i, x) * (self.s_noise * st["sigma_up"])
        return x


@dataclasses.dataclass
class EulerAncestralSampler(AncestralSampler):
    def _run(self, denoise_fn, x, sigmas, start, pre, noise):
        for i, st in enumerate(self.step_table(sigmas, start)):
            if pre is not None:
                x = pre(x, st["sigma"], noise.draw("pre", i, x))
            d = (x - denoise_fn(x, st["sigma"])) / st["sigma"]
            x = x + float(np.float32(st["sigma_down"]) - np.float32(st["sigma"])) * d
            x = self._ancestral_noise(x, st, noise, i)
        return x


@dataclasses.dataclass
class DPMPP2SAncestralSampler(AncestralSampler):
    """DPM-Solver++(2S) with ancestral noise, CCEdit's shipped sampler.  The
    final step (sigma_down = 0) is the plain ancestral Euler step."""

    def _run(self, denoise_fn, x, sigmas, start, pre, noise):
        for i, st in enumerate(self.step_table(sigmas, start)):
            if pre is not None:
                x = pre(x, st["sigma"], noise.draw("pre", i, x))
            denoised = denoise_fn(x, st["sigma"])
            if st["midpoint"]:
                x_mid = st["m1"] * x - st["m2"] * denoised
                x = st["m3"] * x - st["m4"] * denoise_fn(x_mid, st["sigma_mid"])
            else:
                d = (x - denoised) / st["sigma"]
                x = x + float(np.float32(st["sigma_down"]) - np.float32(st["sigma"])) * d
            x = self._ancestral_noise(x, st, noise, i)
        return x


@dataclasses.dataclass
class DPMPP2MSampler(BaseSampler):
    """DPM-Solver++(2M): one network evaluation a step, the second-order
    update from the previous step's denoised from the second step on, no
    loop noise."""

    draws_loop_noise = False

    def _run(self, denoise_fn, x, sigmas, start, pre, noise):
        idx = np.arange(start, len(sigmas) - 1)
        sig, nxt = sigmas[idx], sigmas[idx + 1]
        prev = np.concatenate([[np.nan], sig[:-1]])
        with np.errstate(divide="ignore", invalid="ignore"):
            t = -np.log(sig)
            h = -np.log(np.where(nxt > 0, nxt, 1.0)) - t
            r = (t + np.log(prev)) / h
            m1 = np.nan_to_num(np.where(nxt > 0, nxt, 0.0) / sig)
            m2 = np.where(nxt > 0, np.expm1(-h), -1.0)
            m3 = np.nan_to_num(1.0 + 1.0 / (2.0 * r))
            m4 = np.nan_to_num(1.0 / (2.0 * r))
        old = None
        for i in range(len(idx)):
            if pre is not None:
                x = pre(x, sig[i], noise.draw("pre", i, x))
            denoised = denoise_fn(x, _f32(sig[i]))
            if i > 0 and nxt[i] > 1e-14:
                x = _f32(m1[i]) * x - _f32(m2[i]) * (_f32(m3[i]) * denoised - _f32(m4[i]) * old)
            else:
                x = _f32(m1[i]) * x - _f32(m2[i]) * denoised
            old = denoised
        return x


@dataclasses.dataclass
class LinearMultistepSampler(BaseSampler):
    order: int = 4

    draws_loop_noise = False

    def _run(self, denoise_fn, x, sigmas, start, pre, noise):
        ds = []  # newest first, at most ``order``
        for i_rel, i in enumerate(range(start, len(sigmas) - 1)):
            sigma = _f32(sigmas[i])
            if pre is not None:
                x = pre(x, sigmas[i], noise.draw("pre", i_rel, x))
            ds = [(x - denoise_fn(x, sigma)) / sigma] + ds[:self.order - 1]
            cur_order = min(i_rel + 1, self.order)
            x = x + sum(_f32(linear_multistep_coeff(cur_order, sigmas, i, j)) * ds[j]
                        for j in range(cur_order))
        return x


SAMPLERS = {
    "euler": EulerEDMSampler,
    "heun": HeunEDMSampler,
    "euler_ancestral": EulerAncestralSampler,
    "dpmpp_2s_ancestral": DPMPP2SAncestralSampler,
    "dpmpp_2m": DPMPP2MSampler,
    "lms": LinearMultistepSampler,
}


def make_sampler(name: str, **kwargs) -> BaseSampler:
    return SAMPLERS[name](**kwargs)
