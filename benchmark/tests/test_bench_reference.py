"""The plain reference against the port's CPU path at a tiny size. With
the backbone in float32 both compute the same mathematics in the same
precision, so they agree to float32 rounding; this is what makes the
reference a yardstick for the card's runs."""

import pytest
import torch

from benchmark.harness import port_config, weights
from benchmark.harness.checks import train_gaps
from benchmark.reference import model as M
from benchmark.reference.train import train_steps
from benchmark.tests.tiny import tiny_cell
from benchmark.traffic import train_batches as tb

CPU = torch.device("cpu")


@pytest.mark.parametrize("slots", [100, 25], ids=["auction", "jv"])
def test_train_steps_match_the_port(slots):
    from dinov2_od_tpu_torch.train.state import create_train_state
    from dinov2_od_tpu_torch.train.step import make_train_step

    cell = tiny_cell("vitb224-train-coco100", backbone_dtype="float32",
                     gt_slots=slots)
    cfg, traffic = cell.config, cell.workload["traffic"]
    tcfg = port_config.train_config(cfg, traffic)
    pool = tb.make_pool(traffic, cfg["image_size"], 7, CPU)
    params = weights.make_params(tcfg.detector, cfg["backbone_dtype"], 7,
                                 CPU)
    state = create_train_state(params, tcfg.optim, tcfg.detector)
    step = make_train_step(tcfg)
    p0 = {p: t.detach().clone() for p, t in weights.leaf_items(state.params)
          if t.requires_grad}
    losses, grad1 = [], {}
    for i in range(3):
        gen = torch.Generator().manual_seed(tb.dropout_seed(7, i))
        state, m = step(state, pool[i], gen)
        losses.append(float(m["loss"]))
        if i == 0:
            mu = dict(weights.leaf_items(
                {k: v for k, v in state.opt_state.mu.items()}))
            grad1 = {p: float(mu[p].norm()) / 0.1 for p in p0}
    cur = dict(weights.leaf_items(state.params))
    change = {p: float((cur[p].detach() - p0[p]).norm()) for p in p0}
    ref = train_steps(weights.make_params(tcfg.detector,
                                          cfg["backbone_dtype"], 7, CPU),
                      cfg,
                      pool[:3], [tb.dropout_seed(7, i) for i in range(3)],
                      M.FP32, cfg["image_mean"], cfg["image_std"])
    assert set(ref["grad1"]) == set(p0)
    gaps = train_gaps({"losses": losses, "grad1": grad1, "change": change},
                      ref)
    assert gaps["loss_gap"] < 1e-5, gaps
    assert gaps["grad1_gap"] < 1e-4, gaps
    assert gaps["change_gap"] < 1e-3, gaps


def test_lower_precision_moves_the_reference():
    """The control's step below float32: the same forward in bf16 and fp8
    products lands measurably off the float32 one."""
    cell = tiny_cell("vitb224-train-coco100")
    cfg = cell.config
    det = port_config.detector_config(cfg)
    params = weights.make_params(det, cfg["backbone_dtype"], 9, CPU)
    x = torch.rand((2, 28, 28, 3), generator=torch.Generator().manual_seed(2))
    out32 = M.detector(params, cfg, x, M.FP32)["pred_logits"]
    out8 = M.detector(params, cfg, x, M.Precision("fp8", "bf16"))[
        "pred_logits"]
    assert (out8 - out32).abs().max() > 1e-3
