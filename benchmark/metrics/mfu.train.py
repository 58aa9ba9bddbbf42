"""mfu.train: the model FLOPs of the fine-tuning steps completed in the
window (benchmark/harness/flops.py `train_flops`) over the window's
seconds times the card's dense bf16 peak, in percent."""

from benchmark.harness.flops import PEAK_BF16_FLOPS


def read(r):
    if r.kind != "train" or r.window_s <= 0 or r.model_flops <= 0:
        return None
    return 100.0 * r.model_flops / (r.window_s * PEAK_BF16_FLOPS)
