"""A cell at a size a CPU test can hold: the configuration's own files
with a 32-channel UNet and ControlNets of two levels, a 32-channel VAE of
four levels (still f = 8), 3 frames of 64x64 and 2 sampling steps.  CLIP
and the depth annotators keep their published sizes (the frames are
small)."""

import copy
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SMALL = dict(model_channels=32, channel_mult=[1, 2], num_res_blocks=1,
             attention_resolutions=[1, 2], num_heads=2)


def tiny_spec(workload: str):
    """(benchmark, cell entry, configuration, traffic, limits) of
    ``workload`` at the test size, with the cell's own limits."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(w for w in bench["workloads"] if w["name"] == workload)
    here = ROOT / "perfbench"
    config = json.loads((here / "configs" / f"{entry['config']}.json").read_text())
    p = config["model"]["params"]
    net = p["network_config"]["params"]
    for params in [net] + [net[k]["params"] for k in ("controlnet_config", "controlnet_img_config")
                           if k in net]:
        params.update(copy.deepcopy(SMALL))
    p["first_stage_config"]["params"]["ddconfig"].update(ch=32, ch_mult=[1, 1, 1, 1],
                                                          num_res_blocks=1)
    traffic = json.loads((here / "traffic" / f"{entry['traffic']}.json").read_text())
    traffic.update(frames=3, height=64, width=64, steps=2, trace_after=1, trace_rows=1,
                   check_rows=2)
    limits = json.loads((here / "limits" / f"{workload}.json").read_text())
    return bench, entry, config, traffic, limits
