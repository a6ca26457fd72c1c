"""The control at the test size: the program with its own int8 path
switched on (``control.py --int8``), and the lower-precision reference in the
program's place where it has none, come out as not correct."""

import json
import subprocess
import sys

import pytest

from perfbench import check
from perfbench.tests.tiny import ROOT, tiny_spec

CODE = """
import json, sys, torch
sys.path.insert(0, {root!r})
from perfbench.control import calibrate, with_int8
from perfbench.tests.tiny import tiny_spec
for line in calibrate(with_int8(tiny_spec({workload!r})), [2 ** 31 + 21], 20.0,
                      torch.device("cpu")):
    pass
print(json.dumps(line))
"""


@pytest.mark.parametrize("workload", ["tv2v.edit", "tvi2v.edit"])
def test_the_control_is_not_correct(workload):
    out = subprocess.run([sys.executable, "-c", CODE.format(root=str(ROOT), workload=workload)],
                         capture_output=True, text=True, timeout=900, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    limits = tiny_spec(workload)[4]
    # the program's int8 rows fail the row comparison
    assert line["numbers"]["row_err"] > limits["row_err"], line
    assert not check.verdict(line["numbers"], limits)
    # where the program has no int8 path, the lower-precision reference fails
    # (the chain's rounding shows from a clip's second row: the window is long
    # enough to hold several clips on a loaded host)
    for name in ("text_err", "depth_err", "post_err", "step_err"):
        assert line["control"][name] > limits[name], (name, line["control"][name])
