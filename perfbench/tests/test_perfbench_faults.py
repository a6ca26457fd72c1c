"""A run at the test size, its look for a chip skipped: correct as it is,
and not correct with the timed path broken underneath it, once for each
fault a one-GPU edit cell can have (its cells exchange nothing between
chips)."""

import argparse

import pytest
import torch

from perfbench import run as R
from perfbench.tests.tiny import tiny_spec

CELLS = ["tv2v.edit", "tvi2v.edit"]


def tiny_run(workload):
    a = argparse.Namespace(workload=workload, seed=2 ** 31 + 11, seconds=3.0, trace=0)
    return R.run(a, device=torch.device("cpu"), spec=tiny_spec(workload))


def step_unchanged(monkeypatch):
    """The first sampler step returns its state unchanged."""
    from ccedit_tpu_torch.diffusion import samplers

    orig = samplers.DPMPP2SAncestralSampler._run

    def run(self, denoise_fn, x, sigmas, start, pre, noise):
        calls = []

        def fn(xx, sigma):
            calls.append(sigma)
            return xx if len(calls) <= 2 else denoise_fn(xx, sigma)

        return orig(self, fn, x, sigmas, start, pre, noise)

    monkeypatch.setattr(samplers.DPMPP2SAncestralSampler, "_run", run)


def half_batch(monkeypatch):
    """The guided batch's unconditional half left out: the other half's
    output serves both."""
    from ccedit_tpu_torch.modules.controlnet import CCEditNetwork

    orig = CCEditNetwork.forward

    def forward(self, x, timesteps, cond):
        out = orig(self, x, timesteps, cond)
        half = out.shape[0] // 2
        return torch.cat([out[half:], out[half:]])

    monkeypatch.setattr(CCEditNetwork, "forward", forward)


def answer_altered(monkeypatch):
    """The decoded frames altered where they are made."""
    from ccedit_tpu_torch.models.engine import CCEditEngine

    orig = CCEditEngine.decode_first_stage
    monkeypatch.setattr(CCEditEngine, "decode_first_stage",
                        lambda self, z: orig(self, z) + 0.08)


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(workload):
    result = tiny_run(workload)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("fault", [step_unchanged, half_batch, answer_altered],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("workload", CELLS)
def test_a_fault_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    result = tiny_run(workload)
    assert not result["correct"], result["checks"]
