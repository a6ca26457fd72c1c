"""Nothing the benchmark runs loads JAX or the JAX package; the plain
reference imports nothing of the program either."""

import ast
import subprocess
import sys
import types

from perfbench import run as R
from perfbench.tests.tiny import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "ccedit_tpu"}


def test_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ccedit_tpu_torch_fake.x", types.ModuleType("x"))
    assert "ccedit_tpu" not in R.forbidden_modules()
    monkeypatch.setitem(sys.modules, "ccedit_tpu.fake", types.ModuleType("fake"))
    assert "ccedit_tpu" in R.forbidden_modules()


def test_the_harness_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from perfbench import run, control, check, cell, flops, trace, weights\n"
            "import ccedit_tpu_torch.cli.pipeline, ccedit_tpu_torch.config\n"
            "for name in ('prep_s', 'mfu_pct', 'attn_roofline'): run.load_reader(name)\n"
            "print(run.forbidden_modules())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_sources_import_no_jax_and_the_reference_nothing_of_the_program():
    for path in (ROOT / "perfbench").rglob("*.py"):
        names = set(imports(path))
        assert not names & FORBIDDEN, (path, names & FORBIDDEN)
        if "reference" in path.parts:
            assert "ccedit_tpu_torch" not in names, path
            assert names <= {"torch", "numpy", "math", "typing", "hashlib", "re",
                             "__future__"}, (path, names)
