"""The model's operation counts, the modules a run loads, and the one test
that needs the card."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

import pytest
import torch

from benchmark.harness import flops
from benchmark.harness.manifest import BENCH, ROOT, load_json

NAVSIM = load_json(BENCH / "configs" / "diffusiondrive_navsim.json")


def test_flop_count_repeats_and_scales_with_batch():
    cfg, specs = NAVSIM["as_run"], NAVSIM["weights"]
    one, again, three = (flops.count(cfg, specs, b, False) for b in (1, 1, 3))
    assert one == again and three == 3 * one


@pytest.mark.parametrize("entry", load_json(ROOT / "BENCHMARK.json")["configs"], ids=lambda e: e["name"])
def test_recorded_flops_are_the_reference_count(entry):
    doc = load_json(ROOT / entry["file"])
    cfg, specs = doc["as_run"], doc["weights"]
    assert doc["flops"]["train_per_sample"] == flops.count(cfg, specs, 2, True) / 2
    assert doc["flops"]["eval_per_scene"] == flops.count(cfg, specs, 2, False) / 2


def _imported_roots(path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_reference_imports_nothing_of_the_program():
    files = sorted((BENCH / "reference").glob("*.py"))
    assert files
    for f in files:
        assert not _imported_roots(f) & {"diffusiondrive_torch", "diffusiondrive_tpu", "jax", "jaxlib", "flax"}, f
    code = ("import sys; sys.path.insert(0, %r); import benchmark.reference, benchmark.reference.loss; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True, timeout=300)
    assert not set(json.loads(out.stdout.strip().replace("'", '"'))) & {"diffusiondrive_torch", "diffusiondrive_tpu"}


def test_a_run_loads_no_jax_module():
    """A whole tiny run in a fresh interpreter: no module whose top-level
    name is `jax`, `jaxlib`, `flax` or `diffusiondrive_tpu` (compared whole:
    the program's own name begins with the JAX package's)."""
    code = f"""
import sys, torch
sys.path.insert(0, {str(ROOT)!r})
from benchmark.harness.env import forbidden_modules
from benchmark.harness import cells
from benchmark.tests.tiny import TinyCell, quick
quick()
for kind, run in (("train", cells.run_train), ("agent", cells.run_agent)):
    run(TinyCell(kind, {{}}), 5, 0.1, False, torch.device("cpu"))
print("FORBIDDEN", forbidden_modules(), "PROGRAM", "diffusiondrive_torch" in sys.modules)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("FORBIDDEN")]
    assert line == ["FORBIDDEN [] PROGRAM True"], out.stdout[-2000:] + out.stderr[-2000:]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(card):
    """A short run of the eval cell: one result line, correct, on the card."""
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "navsim.agent_b256",
                          "--seed", "7", "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
