"""The traffic generators: seeded, repeatable, and true to their stated
laws."""

import numpy as np
import pytest

from benchmark.traffic import train_batches as tb


@pytest.mark.parametrize("mean,slots", [(7.3, 100), (2.5, 25)])
def test_gt_counts_repeat_and_meet_their_mean(mean, slots):
    a = tb.gt_counts(4096, mean, slots, np.random.default_rng(3))
    b = tb.gt_counts(4096, mean, slots, np.random.default_rng(3))
    c = tb.gt_counts(4096, mean, slots, np.random.default_rng(4))
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)
    # Every seed holds the same multiset of counts, in another order.
    assert np.array_equal(np.sort(a), np.sort(c))
    assert a.min() >= 1 and a.max() <= slots
    assert abs(a.mean() - mean) / mean < 0.02
    # Heavy-tailed: the median sits below the mean.
    assert np.median(a) < mean


@pytest.mark.parametrize("workload", ["vitb224-train-coco100",
                                      "vitb224-train-voc25"])
def test_targets_repeat_and_follow_the_traffic(workload):
    from benchmark.harness import common

    traffic = common.read_json(common.BENCH_DIR / "workloads"
                               / f"{workload}.json")["traffic"]
    t1 = tb.make_targets(traffic, 8, seed=2**31 + 11)
    t2 = tb.make_targets(traffic, 8, seed=2**31 + 11)
    for a, b in zip(t1, t2):
        for k in a:
            assert np.array_equal(a[k], b[k])
    valid = np.concatenate([t["valid"] for t in t1])
    boxes = np.concatenate([t["boxes"] for t in t1])[valid]
    labels = np.concatenate([t["labels"] for t in t1])[valid]
    assert valid.shape[1] == traffic["gt_slots"]
    assert abs(valid.sum(1).mean() - traffic["gt_mean"]) \
        / traffic["gt_mean"] < 0.05
    assert set(labels.tolist()) <= set(tb.LABELS[traffic["labels"]])
    cx, cy, w, h = boxes.T
    assert (w > 0).all() and (h > 0).all()
    assert (cx - w / 2 >= -1e-6).all() and (cx + w / 2 <= 1 + 1e-6).all()
    assert (cy - h / 2 >= -1e-6).all() and (cy + h / 2 <= 1 + 1e-6).all()


def test_box_sizes_meet_their_shares():
    shares = (0.41, 0.34, 0.24)
    boxes = tb.draw_boxes(20000, shares, np.random.default_rng(0))
    area = boxes[:, 2] * boxes[:, 3]
    small = (area < tb.AREA_BANDS[0][1]).mean()
    large = (area >= tb.AREA_BANDS[2][0]).mean()
    assert abs(small - 0.41 / 0.99) < 0.02
    assert abs(large - 0.24 / 0.99) < 0.02
