"""A run of the harness with the timed path broken underneath must come
out not correct: the check's own faults (a step that keeps its state,
half a batch, a kernel below bfloat16 in the step, frozen weights held
below the configuration's dtype), planted in the program at a tiny size
on the CPU (the look for a card is skipped), beside the sound program,
which comes out correct. The controls at the cells' own sizes run on
the card (`test_control_fails_on_the_card`)."""

import dataclasses
import json

import pytest
import torch

import benchmark.run as run
from benchmark.harness import common
from benchmark.harness.context import port
from benchmark.tests.tiny import tiny_cell

CPU = torch.device("cpu")


def _run(monkeypatch, capsys, workload, program, dtype="float32"):
    monkeypatch.setattr(common, "load_cell",
                        lambda name, **kw: tiny_cell(name, dtype))
    rc = run.main(["--workload", workload, "--seed", "2147483659",
                   "--seconds", "1", "--trace", "0"],
                  program=program, device=CPU)
    assert rc == 0
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert out.err.strip().splitlines()[-1].startswith("check ")
    return line


def _unchanged_state(cfg):
    from dinov2_od_tpu_torch.train.step import train_loss

    def step(state, batch, generator=None):
        total, _ = train_loss(cfg, state.params, batch, generator)
        return state, {"loss": total.detach()}
    return step


def _half_batch(cfg):
    from dinov2_od_tpu_torch.train.step import make_train_step
    real = make_train_step(cfg)

    def step(state, batch, generator=None):
        half = batch["images"].shape[0] // 2
        return real(state, {k: v[:half] for k, v in batch.items()},
                    generator)
    return step


def _lower_precision(cfg):
    """The sound step, counted as if a kernel below bfloat16 ran in it
    (the port's int8 GEMM, B6, has no launch on the CPU)."""
    from dinov2_od_tpu_torch.train.step import make_train_step
    real = make_train_step(cfg)

    def step(state, batch, generator=None):
        COUNTS["int8_gemm"] += 10
        return real(state, batch, generator)
    return step


def _fp8_storage(cfg):
    """The sound step on a state whose frozen weights the program has
    stored below the configuration's dtype (a cast the step undoes)."""
    from dinov2_od_tpu_torch.train.step import make_train_step
    real = make_train_step(cfg)

    def step(state, batch, generator=None):
        qkv = state.params["backbone"]["blocks"]["q"]
        if qkv["kernel"].dtype != torch.float8_e4m3fn:
            qkv["kernel"] = qkv["kernel"].to(torch.float8_e4m3fn)
        kept = qkv["kernel"]
        qkv["kernel"] = kept.to(torch.bfloat16)
        out = real(state, batch, generator)
        qkv["kernel"] = kept
        return out
    return step


COUNTS = {"int8_gemm": 0, "flash_attn_fwd": 0}
TRAIN_FAULTS = {"unchanged_state": _unchanged_state,
                "half_batch": _half_batch,
                "lower_precision": _lower_precision,
                "fp8_storage": _fp8_storage}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sound_program_is_correct(monkeypatch, capsys, dtype):
    line = _run(monkeypatch, capsys, "vitb224-train-coco100", port(), dtype)
    assert line["correct"], line["checks"]
    assert line["checks"]["lower_precision"]["value"] == 0
    assert line["failed"] == 0 and line["attempted"] > 0


@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
def test_train_fault_is_not_correct(monkeypatch, capsys, fault):
    prog = dataclasses.replace(port(), make_train_step=TRAIN_FAULTS[fault],
                               launch_counts=COUNTS)
    line = _run(monkeypatch, capsys, "vitb224-train-coco100", prog,
                "bfloat16")
    assert not line["correct"], line["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("control", ["int8", "reference"])
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      common.benchmark_spec()["workloads"]])
def test_control_fails_on_the_card(card, workload, control):
    """Each control at the cell's own size, on three seeds: the program
    with its own int8 path on, and the reference one precision below the
    configuration's in the program's place. None comes out correct."""
    from benchmark.harness.context import RunContext

    cell = common.load_cell(workload)
    kind = common.load_kind(cell.kind)
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        out = kind.run(RunContext(cell=cell, seed=seed, seconds=0.0,
                                  trace=False, device=card,
                                  control=control))
        assert not all(c.ok for c in out.checks), (seed, out.checks)
