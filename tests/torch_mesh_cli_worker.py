"""One rank of the mesh CLI tests (tests/test_torch_mesh_cli*.py): the
port's training CLI, `dinov2_od_tpu_torch.train.cli.main`, at a tiny
model; and those tests' shared helpers.

    python tests/torch_mesh_cli_worker.py CONFIG_JSON CLI_ARGS...

CONFIG_JSON holds the detector's `backbone` and `decoder` fields and the
data's `max_boxes`: the CLI builds its model from `--dino_model` or
`--lightweight` only, so this process hands it the tests' tiny fp32
config (and GT slots) in their place. TensorBoard, which the CLI's rank 0
opens when it is installed, is left out: importing it takes longer than
the tests' runs. With MESH_CLI_SIGTERM_AT set, the process sends itself
SIGTERM when the loop first logs that text, as an eviction would arrive.
Everything else is the CLI's own: the ranks join through
`--coordinator_address/--num_processes/--process_id`, and the mesh flags
lay them out. It imports torch, numpy and the port only (no JAX).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import signal
import sys


class SignalOnLog(logging.Handler):
    def __init__(self, needle):
        super().__init__()
        self.needle, self.fired = needle, False

    def emit(self, record):
        if not self.fired and self.needle in record.getMessage():
            self.fired = True
            signal.raise_signal(signal.SIGTERM)


# test_torch_train_loop.py's tiny fp32 config: 3 ViT blocks of width 128
# (2 heads), a 2-layer deformable decoder of width 64 (4 heads), dropout
# 0; 6 GT slots (the exact matcher).
BACKBONE = dict(variant="small", image_size=56, hidden_dim_override=128,
                num_heads_override=2, depth_override=3, lora_r=2,
                lora_last_n_blocks=2, target_dim=64)
DECODER = dict(hidden_dim=64, num_queries=8, num_layers=2, num_heads=4,
               dim_feedforward=96, num_classes=6, dropout=0.0)
SPEC = {"backbone": BACKBONE, "decoder": DECODER, "max_boxes": 6}
WORLD = 4


def cli_args(data, checkpoint, out, *extra, epochs=2):
    """The tests' training flags: batch 2 (global), `epochs` epochs with
    validation and a checkpoint each, from `checkpoint`'s params."""
    images, ann = data
    return ["--train_images", images, "--train_annotations", ann,
            "--val_images", images, "--val_annotations", ann,
            "--checkpoint", checkpoint, "--image_size", "56",
            "--batch_size", "2", "--num_epochs", str(epochs),
            "--val_frequency", "1", "--checkpoint_frequency", "1",
            "--log_frequency", "1", "--learning_rate", "2e-3",
            "--num_workers", "2", "--device", "cpu", "--output_dir", out,
            *extra]


def eval_args(data, checkpoint, out, *extra):
    images, ann = data
    return ["--val_images", images, "--val_annotations", ann,
            "--image_size", "56", "--batch_size", "2", "--only_evaluate",
            "--checkpoint", checkpoint, "--device", "cpu", "--output_dir",
            out, *extra]


def mesh_ranks(tmp, name, spec_file, args, env=None):
    """A world of WORLD ranks of this CLI on `args`, joined through
    --coordinator_address/--num_processes/--process_id; `env(rank)` adds
    to a rank's environment."""
    from torch_ranks import Ranks

    return Ranks(lambda r, port: [
        "tests/torch_mesh_cli_worker.py", spec_file, *args,
        "--coordinator_address", f"127.0.0.1:{port}",
        "--num_processes", str(WORLD), "--process_id", str(r)],
        WORLD, tmp / f"{name}_logs",
        env=(lambda r, port: env(r)) if env else None)


def init_checkpoint(directory: str, spec: dict = SPEC) -> str:
    """The tiny detector drawn from seed 0 (every lora_B nonzero, so the
    backbone's LoRA gradients are), saved as a bare-params checkpoint."""
    import torch

    from dinov2_od_tpu_torch import config as C
    from dinov2_od_tpu_torch.models.detector import init_detector_params
    from dinov2_od_tpu_torch.train.checkpoint import save_final_params

    det = C.DetectorConfig(backbone=C.BackboneConfig(**spec["backbone"]),
                           decoder=C.DecoderConfig(**spec["decoder"]))
    params = init_detector_params(torch.Generator().manual_seed(0), det,
                                  device="cpu")
    gen = torch.Generator().manual_seed(1)
    for lin in params["backbone"]["blocks"].values():
        if isinstance(lin, dict) and "lora_B" in lin:
            lin["lora_B"] = 0.05 * torch.randn(lin["lora_B"].shape,
                                               generator=gen)
    return save_final_params(directory, params, name="init")


def read_json(out, name):
    with open(os.path.join(out, name)) as f:
        return json.load(f)


def epoch_losses(out, epochs=2):
    return [x for e in range(epochs)
            for x in read_json(out, f"train_epoch_{e}.json")["losses"]]


def detections(out, name):
    """A predictions file's detections, sorted: (image, category, score,
    box)."""
    return sorted((d["image_id"], d["category_id"], d["score"], *d["bbox"])
                  for d in read_json(out, name))


def final_params(out):
    import torch

    from dinov2_od_tpu_torch.train.checkpoint import flatten_tree

    return flatten_tree(torch.load(os.path.join(out, "final_model",
                                                "state.pt"),
                                   weights_only=True)["params"])


@contextlib.contextmanager
def tiny_cli(spec: dict):
    """The CLI module with the spec's detector config, GT slots and no
    TensorBoard, put back as it was on exit."""
    from dinov2_od_tpu_torch import config as C
    from dinov2_od_tpu_torch.train import cli
    from dinov2_od_tpu_torch.utils import logging as plogging

    det = C.DetectorConfig(backbone=C.BackboneConfig(**spec["backbone"]),
                           decoder=C.DecoderConfig(**spec["decoder"]))

    @dataclasses.dataclass(frozen=True)
    class DataConfig(C.DataConfig):
        max_boxes: int = spec["max_boxes"]

    saved = (cli.build_detector_config, C.DataConfig,
             plogging.setup_tensorboard)
    cli.build_detector_config = lambda args: det
    C.DataConfig = DataConfig
    plogging.setup_tensorboard = lambda *a, **k: None
    try:
        yield cli
    finally:
        (cli.build_detector_config, C.DataConfig,
         plogging.setup_tensorboard) = saved


def main(argv) -> int:
    with open(argv[0]) as f:
        spec = json.load(f)
    if os.environ.get("MESH_CLI_SIGTERM_AT"):
        logging.getLogger().addHandler(
            SignalOnLog(os.environ["MESH_CLI_SIGTERM_AT"]))
    with tiny_cli(spec) as cli:
        return cli.main(argv[1:])


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
