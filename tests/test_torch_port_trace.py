"""The port's spans (``ccedit_tpu_torch/utils/trace.py``) on the CPU.

Off (the default), ``span`` hands back one shared no-op context and never
reaches ``record_function``.  On, a TV2V and a TVI2V edit under
``torch.profiler`` export a chrome trace that holds every span name, nested
as the layers are: the stages in order, the network calls inside the
sample stage, the branches, the temporal halves and the attention calls
inside a network call (the VAE's attention inside the encode or decode
stage), and no name overlapping itself.  The edits run the tiny TV2V
config of ``test_torch_port_cli.py`` widened so that every attention route
is taken: at 256x128 the UNet's level 0 holds 512 tokens of head dim 64
(128 channels in 2 heads: kernel 1's route) and 512 x 2 temporal rows in 2
heads (kernel 2's), and the VAE's bottom level 512 channels (kernel 3's);
level 1 and the text cross-attention go plain.
"""

import copy
import json

import numpy as np
import pytest
import torch

from ccedit_tpu_torch import config
from ccedit_tpu_torch.cli import pipeline
from ccedit_tpu_torch.ops.attention import launch_counts
from ccedit_tpu_torch.utils import trace
from test_torch_port_cli import tiny_config  # noqa: F401  (the fixture)

torch.set_num_threads(1)
T, H, W, STEPS = 3, 256, 128, 2
ROUTED = dict(model_channels=128, num_heads=2)
VAE = dict(ch=32, ch_mult=[1, 1, 1, 16], num_res_blocks=1)
APPEARANCE = dict(hint_channels=4, set_input_hint_block_as_identity=True, no_add_x=True,
                  disable_text_ca=True)
STAGES = {"tv2v": ["text", "hint", "sample", "decode"],
          "tvi2v": ["text", "hint", "encode", "sample", "decode"]}


@pytest.fixture
def tracing():
    trace.enable(True)
    try:
        yield
    finally:
        trace.enable(False)


def _engine(tiny_config, workload: str, routed: bool):
    """The tiny TV2V config (its CLIP narrowed by the fixture), with
    ``routed`` at the widths that take every attention route; for TVI2V with
    CFCA and the appearance ControlNet of the same size."""
    cfg = config.load_config(tiny_config)
    p = cfg["model"]["params"]
    net = p["network_config"]["params"]
    if workload == "tvi2v":
        net.update(enable_attention3d_crossframe=True, ST3DCA_ca_type="center_self",
                   controlnet_img_config={
                       "target": "sgm.modules.diffusionmodules.controlmodel.ControlNet2D",
                       "params": dict(copy.deepcopy(net["controlnet_config"]["params"]),
                                      **APPEARANCE)})
        p["conditioner_config"]["params"]["emb_models"].append(
            {"input_key": "cond_img", "target": "sgm.modules.encoders.modules.VAEEmbedder",
             "params": {}})
    if routed:
        for q in (net, net["controlnet_config"]["params"],
                  net.get("controlnet_img_config", {}).get("params", {})):
            q.update(ROUTED)
        p["first_stage_config"]["params"]["ddconfig"].update(VAE)
    engine = config.build_engine(cfg, fake_annotator=True, num_steps=STEPS)
    for m in engine.modules:
        m.eval()
    return engine


def _edit(engine, workload: str, h: int, w: int, **kw):
    frames = np.random.RandomState(0).randint(0, 256, (T, h, w, 3), dtype=np.uint8)
    if workload == "tvi2v":
        kw.update(reference=frames[T // 2], prior_type="ref", prior_coefficient_x=0.03)
    return pipeline.edit_clip(engine, frames, "a bear", "ugly", 7.5, STEPS,
                              torch.Generator().manual_seed(0), **kw)


def _spans(path) -> dict:
    """The chrome trace's program spans: name -> sorted (start, end) us."""
    out = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("cat") == "user_annotation" and e["name"].startswith("ccedit."):
            out.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
    return {k: sorted(v) for k, v in out.items()}


def _inside(iv, outer) -> bool:
    return any(a <= iv[0] and iv[1] <= b for a, b in outer)


def test_off_is_one_shared_context_and_never_records(tiny_config, monkeypatch):
    assert not trace.enabled()
    assert trace.span(trace.NETWORK) is trace.span(trace.ATTENTION["plain"]) is trace._OFF

    def refuse(*a, **k):
        raise AssertionError("record_function reached with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    engine = _engine(tiny_config, "tv2v", routed=False)
    out = _edit(engine, "tv2v", 64, 64)
    assert out.shape == (T, 64, 64, 3)


@pytest.mark.parametrize("workload", ["tv2v", "tvi2v"])
def test_a_traced_edit_records_every_span_nested(tiny_config, workload, tracing, tmp_path):
    engine = _engine(tiny_config, workload, routed=True)
    seconds, launches = {}, {}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _edit(engine, workload, H, W, stage_seconds=seconds, stage_launches=launches)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    spans = _spans(tmp_path / "trace.json")

    stages = [trace.EDIT_STAGES[s] for s in STAGES[workload]]
    expected = set(trace.NAMES) - ({trace.APPEARANCE, trace.EDIT_STAGES["encode"]}
                                   if workload == "tv2v" else set())
    assert set(spans) == expected
    # the stopwatch keeps its keys
    assert list(seconds) == list(launches) == STAGES[workload]
    assert all(set(v) == set(launch_counts()) for v in launches.values())

    # one interval a stage, in order; no name overlaps itself
    starts = [spans[s][0] for s in stages]
    assert all(len(spans[s]) == 1 for s in stages)
    assert all(a[1] <= b[0] for a, b in zip(starts, starts[1:]))
    for ivs in spans.values():
        assert all(a[1] <= b[0] for a, b in zip(ivs, ivs[1:]))

    network = spans[trace.NETWORK]
    assert len(network) == 3  # DPM++2S at 2 steps: a row, a midpoint, a row
    assert all(_inside(iv, spans[trace.EDIT_STAGES["sample"]]) for iv in network)
    for name in (trace.CONTROLNET, trace.APPEARANCE, trace.TEMPORAL, *trace.ATTENTION.values()):
        if name == trace.ATTENTION["flash"]:  # the VAE's mid-block
            vae = spans[trace.EDIT_STAGES["decode"]] + spans.get(trace.EDIT_STAGES["encode"], [])
            assert all(_inside(iv, vae) for iv in spans[name])
        elif name in spans:
            assert all(_inside(iv, network) for iv in spans[name]), name
    assert len(spans[trace.CONTROLNET]) == 3
    assert len(spans.get(trace.APPEARANCE, [])) == (3 if workload == "tvi2v" else 0)


def test_a_span_cut_by_the_profiler_neither_raises_nor_appears(tracing, tmp_path):
    """One opened before the profiler starts is not recorded; one still open
    when it stops is recorded up to the stop (a profile that starts and stops
    inside a row's network call)."""
    x = torch.randn(64, 64)
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    with trace.span(trace.NETWORK):
        prof.start()
        with trace.span(trace.TEMPORAL):
            x = x @ x
    with trace.span(trace.CONTROLNET):
        x = x @ x
        prof.stop()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    assert set(_spans(tmp_path / "trace.json")) == {trace.TEMPORAL, trace.CONTROLNET}
