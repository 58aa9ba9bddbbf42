"""CLI: export a trained checkpoint to a serving bundle (counterpart of
dinov2_od_tpu/tools/export.py).

    python -m dinov2_od_tpu_torch.tools.export \\
        --checkpoint outputs/final_model \\
        --model_name facebook/dinov2-base --num_classes 91 \\
        --output_dir serving/detector-v1 \\
        --batch_sizes 1,8,32 [--quantize int8] [--lightweight] \\
        [--backbone_dtype bfloat16] [--device cuda]

The bundle (folded weights + detector config + manifest, see
dinov2_od_tpu_torch/export.py) serves with the port's model code:

    from dinov2_od_tpu_torch.export import load_serving_bundle
    model = load_serving_bundle("serving/detector-v1")
    detections = model.detect(["img.jpg"])

or over HTTP: `python -m dinov2_od_tpu_torch.serve --bundle DIR`.

The checkpoint is restored onto a template drawn from seed 0 on
`--device`, cast as `Predictor.from_checkpoint` casts it
(`inference.checkpoint_params`): under
`--backbone_dtype bfloat16` (the train CLI's flag of the same name) the
frozen backbone weights are stored in bf16, LoRA folds in that dtype and
the bundle serves a bf16 backbone.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoint", type=str, required=True,
                   help="checkpoint directory of the training loop")
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--model_name", type=str,
                   default="facebook/dinov2-base")
    p.add_argument("--num_classes", type=int, default=91)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--lightweight", action="store_true",
                   help="the CLIs' shared lightweight config table")
    p.add_argument("--batch_sizes", type=str, default="1,8,32",
                   help="comma-separated; the batch sizes the loader runs")
    p.add_argument("--max_detections", type=int, default=100)
    p.add_argument("--quantize", type=str, default=None,
                   choices=[None, "int8"],
                   help="int8: W8A8 backbone serving path")
    p.add_argument("--no_normalize", action="store_true",
                   help="record that inputs are NOT ImageNet-normalized "
                        "(must match how the checkpoint was trained)")
    p.add_argument("--backbone_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="the backbone's compute and storage dtype to serve "
                        "with")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="'cuda' (the default; raises without a card) or "
                        "'cpu'")
    args = p.parse_args(argv)

    from ..config import (
        detector_config_for_model_name,
        lightweight_detector_config,
    )
    from ..export import export_serving_bundle
    from ..inference import checkpoint_params

    if args.lightweight:
        cfg = lightweight_detector_config(
            num_classes=args.num_classes, image_size=args.image_size
        )
    else:
        cfg = detector_config_for_model_name(
            args.model_name,
            num_classes=args.num_classes,
            image_size=args.image_size,
        )
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, dtype=args.backbone_dtype))
    params = checkpoint_params(args.checkpoint, cfg, args.device)

    out = export_serving_bundle(
        params,
        cfg,
        args.output_dir,
        batch_sizes=[int(b) for b in args.batch_sizes.split(",")],
        max_detections=args.max_detections,
        quantize=args.quantize,
        normalize=not args.no_normalize,
    )
    print(f"serving bundle written to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
