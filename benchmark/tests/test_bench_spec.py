"""BENCHMARK.json against the contract's rules and against the cells' own
files."""

import json
import re

import pytest

from benchmark.harness import common

SPEC = common.benchmark_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
E2E = {m["name"]: m for m in SPEC["end_to_end"]}


def _reports(cell: str) -> list:
    return common.metrics_of(SPEC["end_to_end"], cell)


def test_top_level_keys_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(SPEC)) <= 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51
    assert SPEC["paths"] == ["benchmark"]
    assert len(SPEC["command"]) <= 32
    assert SPEC["command"][1].startswith("benchmark/")


def test_names_and_units():
    names = ([c["name"] for c in SPEC["configs"]]
             + [w["name"] for w in SPEC["workloads"]]
             + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in SPEC["workloads"]]:
        assert NAME.match(n), n
    for c in SPEC["configs"]:
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for text in ([w["why"] for w in SPEC["workloads"]]
                 + [c["why"] for c in SPEC["configs"]]
                 + [m["layer"] for m in SPEC["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_metric_entries_have_their_keys_only():
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert E2E["setup_s"]["bound"] <= 0.25 and "workloads" not in E2E[
        "setup_s"]
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}


def test_each_per_layer_metric_moves_one_reported_metric():
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in E2E and m["moves"] != "setup_s"
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert m["moves"] in _reports(cell), (m["name"], cell)
    for m in SPEC["per_layer"]:
        if m["name"].startswith("mfu."):
            assert m["unit"] == "%"
        if "_roofline" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_enough():
    for w in SPEC["workloads"]:
        e2e = _reports(w["name"])
        assert "setup_s" in e2e and len(e2e) >= 2
        assert common.metrics_of(SPEC["per_layer"], w["name"], e2e)


def test_configs_cells_and_chips():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert all(w["chips"] in (1, 4) for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_files_agree_with_the_spec(w):
    cell = common.load_cell(w["name"])
    assert cell.workload["name"] == w["name"]
    assert cell.workload["config"] == w["config"]
    assert cell.workload["traffic"]["name"] == w["traffic"]
    assert cell.workload["chips"] == w["chips"]
    assert cell.workload["why"] == w["why"]
    assert (common.BENCH_DIR / "traffic"
            / f"{cell.kind}.py").is_file()
    for name in cell.per_layer:
        assert (common.BENCH_DIR / "metrics" / f"{name}.py").is_file()
    limits = cell.workload["checks"]["limits"]
    assert all(v > 0 for v in limits.values())


@pytest.mark.parametrize("c", SPEC["configs"], ids=lambda c: c["name"])
def test_config_files_agree_with_the_spec(c):
    assert c["file"] == f"benchmark/configs/{c['name']}.json"
    f = common.read_json(common.ROOT / c["file"])
    assert f["name"] == c["name"] and f["source"] == c["source"]
    assert f["reduced"] == c["reduced"]
    # No width is ever cut: the input size may change, a width may not.
    width = re.compile(r"(_dim|_rank|_ratio|_heads|hidden_size|"
                       r"intermediate_size|experts_per_tok)$|latent|state")
    for k in c["reduced"]:
        assert not width.search(k), k
