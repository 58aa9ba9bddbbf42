"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names; the plain reference loads nothing of the port."""

import ast
import json
import subprocess
import sys

from benchmark.harness import common

ROOT = common.ROOT


def _modules_after(code: str) -> set:
    """Top-level names of the modules loaded after `code` runs in a fresh
    interpreter at the checkout's root."""
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=240, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_forbidden_names_compare_whole():
    assert common.forbidden_loaded(
        {"dinov2_od_tpu_torch": 1, "dinov2_od_tpu_torch.ops": 1}) == []
    assert common.forbidden_loaded({"dinov2_od_tpu.models": 1}) == [
        "dinov2_od_tpu"]
    assert common.forbidden_loaded({"jaxlib.xla": 1, "jax": 1}) == [
        "jax", "jaxlib"]


def test_harness_and_dry_setups_load_no_jax():
    code = """
import sys
sys.path.insert(0, '.')
import torch
from benchmark.harness import common, flops, trace, weights, port_config
from benchmark.harness.context import port
from benchmark.traffic import train_batches
from benchmark.tests.tiny import tiny_cell
cell = tiny_cell('vitb224-train-coco100')
train_batches.make_pool(cell.workload['traffic'], 28, 5, torch.device('cpu'))
det = port_config.detector_config(cell.config)
weights.make_params(det, 'bfloat16', 5, torch.device('cpu'))
port()
for n in common.benchmark_spec()['per_layer']:
    common.load_reader(n['name'])
"""
    loaded = _modules_after(code)
    assert "dinov2_od_tpu_torch" in loaded
    assert not loaded & set(common.FORBIDDEN_MODULES), \
        loaded & set(common.FORBIDDEN_MODULES)


def test_reference_imports_nothing_of_the_port():
    for path in sorted((common.BENCH_DIR / "reference").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in (
                    "dinov2_od_tpu_torch", *common.FORBIDDEN_MODULES), \
                    (path.name, n)
    loaded = _modules_after(
        "import sys\nsys.path.insert(0, '.')\n"
        "import benchmark.reference.model, benchmark.reference.train")
    assert "dinov2_od_tpu_torch" not in loaded
    assert not loaded & set(common.FORBIDDEN_MODULES)
