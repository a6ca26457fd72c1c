"""Spans at the port's layer boundaries, on the profiler's clock.

Each span is a ``torch.profiler.record_function`` user annotation, so it
lands in the chrome trace that ``torch.profiler`` exports, on the clock of
the CUPTI kernel and launch events: a device kernel lies under a span when
the host call that launched it (the trace's correlation id) falls inside
the span's interval.  Tracing is off by default; ``enable(True)`` turns it
on for the whole process (``cli/profile_tv2v.py``'s profiler does, around
its profiles).  While it is off, ``span`` returns
one shared no-op context: no allocation, no string formatting, no
dispatcher call.

A span that opens before the profiler starts is not recorded; one still
open when it stops is recorded up to the stop.  No name nests inside
itself, so the intervals of one name never overlap.

Names (one clip is in flight at a time, so the stage spans mark each clip's
bounds and no span carries a request id):

* ``ccedit.edit.{text,hint,encode,sample,decode}``: the pipeline's stages
  (``cli/pipeline.py::_Stopwatch.stage``);
* ``ccedit.network``: one network call of a row, its casts included
  (``models/engine.py``);
* ``ccedit.controlnet``: the structure ControlNet; ``ccedit.appearance``: the
  appearance branch (appearance, interpolate, RAIG) (``modules/controlnet.py``);
* ``ccedit.temporal``: the pseudo-3D temporal half, fold, temporal function
  and unfold (``ops/video.py::temporal_apply``);
* ``ccedit.attention.{spatial,temporal,flash,plain}``: one attention call by
  its route (``ops/attention.py::dot_product_attention``).
"""

from __future__ import annotations

import contextlib

import torch

EDIT_STAGES = {stage: f"ccedit.edit.{stage}"
               for stage in ("text", "hint", "encode", "sample", "decode")}
NETWORK = "ccedit.network"
CONTROLNET = "ccedit.controlnet"
APPEARANCE = "ccedit.appearance"
TEMPORAL = "ccedit.temporal"
ATTENTION = {route: f"ccedit.attention.{route}"
             for route in ("spatial", "temporal", "flash", "plain")}
NAMES = (tuple(EDIT_STAGES.values()) + (NETWORK, CONTROLNET, APPEARANCE, TEMPORAL)
         + tuple(ATTENTION.values()))

_OFF = contextlib.nullcontext()
_on = False


def enable(on: bool) -> None:
    """Turn the spans on or off for the whole process."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def span(name: str):
    """A ``record_function`` span named ``name`` while tracing is on, else
    the one shared no-op context."""
    if _on:
        return torch.profiler.record_function(name)
    return _OFF
