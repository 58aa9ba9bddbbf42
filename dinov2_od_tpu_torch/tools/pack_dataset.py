"""Pack a COCO image directory into pre-decoded uint8 memmaps
(counterpart of tools/pack_dataset.py; the format data/packed.py reads,
either package's).

Decode once, replay many: train with `--packed_train_data <out>`, and the
loader reads raw pixels with one gather a batch instead of decoding every
JPEG every epoch.

Usage:
  python -m dinov2_od_tpu_torch.tools.pack_dataset \\
      --images /data/coco/train2017 \\
      --annotations /data/coco/annotations/instances_train2017.json \\
      --out /data/coco_packed_224 --image_size 224 --max_boxes 100
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--images", required=True)
    ap.add_argument("--annotations", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--image_size", type=int, default=224)
    ap.add_argument("--max_boxes", type=int, default=100)
    ap.add_argument("--num_workers", type=int, default=4)
    ap.add_argument("--decode_backend", default="auto",
                    choices=["auto", "cv2", "pil"],
                    help="auto: the native decoder where it builds, else "
                         "cv2, else PIL; pil: the reference's pixels")
    args = ap.parse_args(argv)

    from ..data.coco import CocoDetectionDataset
    from ..data.packed import pack_dataset

    ds = CocoDetectionDataset(
        args.images, args.annotations, args.image_size,
        max_boxes=args.max_boxes, output_dtype="uint8",
        decode_backend=args.decode_backend)
    print(f"packing {len(ds)} images at {args.image_size}px "
          f"-> {args.out} ...")
    t0 = time.perf_counter()
    pack_dataset(ds, args.out, num_workers=args.num_workers)
    dt = time.perf_counter() - t0
    size_mb = sum(os.path.getsize(os.path.join(args.out, f))
                  for f in os.listdir(args.out)) / 1e6
    print(f"packed {len(ds)} images in {dt:.1f}s "
          f"({len(ds) / dt:.1f} img/s), {size_mb:.0f} MB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
