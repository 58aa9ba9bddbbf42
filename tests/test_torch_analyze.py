"""The port's result-analysis tool (dinov2_od_tpu_torch/tools/analyze.py)
against the JAX package's on the same files: the metrics table, the
prediction statistics and the charts and visualizations they write, and
--run_eval passing through to the port's training CLI on the CPU."""

import json
import os

import numpy as np
import pytest
import torch

from dinov2_od_tpu.tools import analyze as janalyze

from dinov2_od_tpu_torch.data.synthetic import write_coco_dataset
from dinov2_od_tpu_torch.tools import analyze

METRICS = {"AP": 0.42, "AP50": 0.6, "AP75": 0.4, "APs": 0.1, "APm": 0.45,
           "APl": 0.55, "AR1": 0.3, "AR10": 0.5, "AR100": 0.52, "ARs": 0.2,
           "ARm": 0.5, "ARl": 0.6}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("analyze")
    images, ann = write_coco_dataset(str(root), num_images=4, image_size=56,
                                     seed=2, max_objects=3)
    with open(ann) as f:
        gt = json.load(f)
    rng = np.random.default_rng(0)
    preds = [{"image_id": a["image_id"], "category_id": a["category_id"],
              "bbox": a["bbox"], "score": float(rng.uniform(0.3, 1.0))}
             for a in gt["annotations"]]
    return images, ann, preds


def _twice(tmp_path, name, content):
    """The same file under tmp_path/jax and tmp_path/port."""
    paths = []
    for side in ("jax", "port"):
        d = tmp_path / side
        d.mkdir(exist_ok=True)
        (d / name).write_text(json.dumps(content))
        paths.append(str(d / name))
    return paths


@pytest.mark.parametrize("keys", ["all", "no_ar"])
def test_metrics_table_matches_jax(tmp_path, capsys, keys):
    metrics = dict(METRICS) if keys == "all" else {
        k: v for k, v in METRICS.items() if not k.startswith("AR")}
    jpath, ppath = _twice(tmp_path, "metrics_epoch_3.json", metrics)
    assert janalyze.analyze_metrics(jpath) == metrics
    jout = capsys.readouterr().out
    assert analyze.analyze_metrics(ppath) == metrics
    pout = capsys.readouterr().out
    assert pout.replace(ppath, jpath).replace("/port/", "/jax/") == jout
    assert "AP (Average Precision): 0.4200" in pout
    assert os.path.exists(os.path.join(tmp_path, "port",
                                       "metrics_chart.png"))
    assert analyze.analyze_metrics(str(tmp_path / "missing.json")) is None


def test_prediction_statistics_and_visualizations_match_jax(
        tmp_path, capsys, dataset):
    images, ann, preds = dataset
    jpath, ppath = _twice(tmp_path, "preds.json", preds)
    argv = ["--test_images", images, "--annotations", ann,
            "--num_samples", "2", "--score_threshold", "0.5"]
    assert janalyze.main(["--predictions_file", jpath] + argv) == 0
    jout = capsys.readouterr().out
    assert analyze.main(["--predictions_file", ppath] + argv) == 0
    pout = capsys.readouterr().out
    assert pout.replace(ppath, jpath).replace("/port/", "/jax/") == jout
    assert f"Total predictions: {len(preds)}" in pout
    files = {side: sorted(os.listdir(tmp_path / side))
             for side in ("jax", "port")}
    assert files["port"] == files["jax"]
    assert {"confidence_histogram.png", "class_distribution.png"} <= set(
        files["port"])
    assert sum(f.startswith("viz_") for f in files["port"]) == 2
    # Names come from the annotations, not the COCO fallback.
    assert analyze._class_names(ann) == janalyze._class_names(ann)
    assert analyze._class_names(None) == janalyze.COCO_CLASSES


def test_analyze_requires_an_action():
    with pytest.raises(SystemExit):
        analyze.main([])


def test_run_eval_passes_through_to_the_port_cli(tmp_path, dataset):
    """--run_eval runs the port's CLI's --only_evaluate in process on
    --device cpu and writes its metrics, which --metrics_file then
    reads."""
    images, ann, _ = dataset
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = str(tmp_path / "eval")
        assert analyze.main(["--run_eval", "--val_images", images,
                             "--val_annotations", ann, "--lightweight",
                             "--output_dir", out, "--device", "cpu",
                             "--metrics_file",
                             os.path.join(out, "metrics_epoch_0.json")]) == 0
    finally:
        torch.set_num_threads(n)
    with open(os.path.join(out, "metrics_epoch_0.json")) as f:
        assert set(json.load(f)) >= {"AP", "AP50", "AP75"}
    assert os.path.exists(os.path.join(out, "metrics_chart.png"))
