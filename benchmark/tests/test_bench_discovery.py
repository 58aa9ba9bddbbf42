"""The harness finds cells, configurations, traffic kinds and per-layer
metrics by name: a new one is a new file, and no file that is there
changes."""

import json
import shutil

from benchmark.harness import common
from benchmark.harness.context import Readings

BASE = "vitb224-train-coco100"
NEW = "vitb224-train-coco50"


def test_new_workload_and_metric_files_are_picked_up(tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(common.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p.relative_to(bench): p.read_bytes()
              for p in bench.rglob("*") if p.is_file()}
    spec = json.loads(json.dumps(common.benchmark_spec()))

    # A new cell: the training traffic with other GT slots, a data file.
    w = common.read_json(bench / "workloads" / f"{BASE}.json")
    w.update(name=NEW, why="50 GT slots")
    w["traffic"].update(name="coco50", gt_slots=50)
    (bench / "workloads" / f"{NEW}.json").write_text(json.dumps(w))
    # A new per-layer metric: a reader of its own.
    (bench / "metrics" / "elementwise_ms.train.py").write_text(
        "def read(r):\n"
        "    return None if r.kind != 'train' else 7.0\n")
    spec["workloads"].append({"name": NEW, "config": w["config"],
                              "traffic": "coco50", "chips": 1,
                              "why": "50 GT slots"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if BASE in m.get("workloads", []):
            m["workloads"].append(NEW)
    spec["per_layer"].append({
        "name": "elementwise_ms.train", "unit": "ms", "better": "lower",
        "source": "device_trace",
        "layer": "train step (train/step.py, train/state.py)",
        "moves": "train_images_per_s"})

    cell = common.load_cell(NEW, bench_dir=bench, spec=spec)
    assert cell.workload["traffic"]["gt_slots"] == 50
    assert cell.config["name"] == "dinov2-base-224-detr"
    assert "train_images_per_s" in cell.end_to_end
    assert "auction_rounds_per_step.train" in cell.per_layer
    assert "elementwise_ms.train" in cell.per_layer
    # The metric without `workloads` reaches every cell that reports what
    # it moves, the existing ones too.
    for name in (BASE, "vitl560-train-coco100", "vitb224-train-voc25"):
        old = common.load_cell(name, bench_dir=bench, spec=spec)
        assert "elementwise_ms.train" in old.per_layer
    read = common.load_reader("elementwise_ms.train", bench_dir=bench)
    r = Readings(kind="train", window_s=1.0, model_flops=0.0, counters={})
    assert read(r) == 7.0
    assert common.load_kind(cell.kind, bench_dir=bench).__name__.endswith(
        "train_batches")

    after = {p.relative_to(bench): p.read_bytes()
             for p in bench.rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items())
