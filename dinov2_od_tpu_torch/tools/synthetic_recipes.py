"""Rerun the JAX package's synthetic-5k accuracy recipes with the port's
training CLI and set their AP curves beside the recorded ones
(BENCH.md "Synthetic convergence headline at 5k images",
runs/synthetic5k_{dense60,aug60,moe60}/).

    python -m dinov2_od_tpu_torch.tools.synthetic_recipes
        [--arms dense,aug] [--epochs 60] [--data build/synthetic5k]
        [--runs build/recipes] [--out chiprun_out/recipes]
        [--deadline_s S] [--device cuda]

- Writes the dataset once with `write_coco_dataset`: 5,000 train images
  (seed 0) and 500 val images (seed 1), 224 px JPEG, 6 classes with the
  non-contiguous ids 10..60.
- Trains each arm with `python -m dinov2_od_tpu_torch.train`, the arms as
  processes side by side on one card: the recipe of the JAX run's
  DetectorConfig (lightweight ViT-S/14, random init, LoRA r=1 on the last
  2 blocks, 7 classes, aux loss, bf16 backbone, fp32 decoder, 25
  queries) with batch 16, a constant lr of 1e-4, the device cache at 16
  steps a dispatch and validation every 10 epochs; the aug arm adds
  hflip 0.5 and scale jitter 0.25; the moe arm (`--arms moe`, not a
  default) swaps the 2 adapted blocks' FFN for the MoE FFN at the CLI's
  defaults: 8 experts (the JAX run's log records moe_num_experts=8),
  top-2, capacity factor 1.25, aux weight 0.01.
- An arm with a checkpoint under --runs resumes from the latest one; with
  --deadline_s the arms get SIGTERM at that many seconds and save a
  preemption checkpoint (exact mid-epoch resume).
- Copies each arm's metrics, per-epoch train records and log to --out
  and prints one JSON line per arm: AP, AP50, AP75 and AR100 at each
  validated epoch beside the JAX records, the loop's images/s, the wall
  time and the card (nvidia-smi's name and power limit).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
RECIPE = ["--lightweight", "--num_classes", "7", "--aux_loss", "true",
          "--backbone_dtype", "bfloat16", "--batch_size", "16",
          "--lr_schedule", "constant", "--learning_rate", "1e-4",
          "--device_cache", "--steps_per_dispatch", "16",
          "--val_frequency", "10", "--checkpoint_frequency", "10",
          "--log_frequency", "16"]
ARMS = {"dense": [], "aug": ["--hflip_prob", "0.5", "--scale_jitter", "0.25"],
        "moe": ["--ffn_type", "moe"]}
REFERENCE = {"dense": "runs/synthetic5k_dense60", "aug": "runs/synthetic5k_aug60",
             "moe": "runs/synthetic5k_moe60"}
KEYS = ("AP", "AP50", "AP75", "AR100")


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def write_data(root: str) -> dict:
    """The train and val splits under `root`, written unless present."""
    from ..data.synthetic import write_coco_dataset

    out = {}
    for split, n, seed in (("train", 5000, 0), ("val", 500, 1)):
        d = os.path.join(root, split)
        ann = os.path.join(d, "annotations.json")
        if not os.path.exists(ann):
            t0 = time.perf_counter()
            write_coco_dataset(d, num_images=n, image_size=224, seed=seed,
                               fmt="jpg")
            print(f"wrote {n} {split} images in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        out[split] = (os.path.join(d, "images"), ann)
    return out


def _metrics(run_dir: str) -> dict:
    got = {}
    for path in glob.glob(os.path.join(run_dir, "metrics_epoch_*.json")):
        epoch = int(path.rsplit("_", 1)[1].split(".")[0])
        with open(path) as f:
            got[epoch] = {k: v for k, v in json.load(f).items() if k in KEYS}
    return dict(sorted(got.items()))


def summarize(arm: str, run_dir: str, wall_s: float) -> dict:
    ours = _metrics(run_dir)
    ref = _metrics(str(REPO / REFERENCE[arm]))
    ips = {}
    for path in glob.glob(os.path.join(run_dir, "train_epoch_*.json")):
        with open(path) as f:
            rec = json.load(f)
        ips[rec["epoch"]] = rec["images_per_sec"]
    steady = [v for e, v in ips.items() if e > 0]
    return {
        "arm": arm,
        "epochs_done": len(ips),
        "metrics": {e: {"port": m, "jax": ref.get(e)}
                    for e, m in ours.items()},
        "images_per_sec_by_epoch": dict(sorted(ips.items())),
        "images_per_sec_mean_after_epoch_0":
            sum(steady) / len(steady) if steady else None,
        "wall_s": wall_s,
        "card": card_line(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arms", default="dense,aug")
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--data", default="build/synthetic5k")
    ap.add_argument("--runs", default="build/recipes")
    ap.add_argument("--out", default="chiprun_out/recipes")
    ap.add_argument("--deadline_s", type=float, default=0.0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from ..train.checkpoint import latest_checkpoint

    data = write_data(args.data)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    procs = {}
    t0 = time.perf_counter()
    for arm in args.arms.split(","):
        run_dir = os.path.join(args.runs, arm)
        os.makedirs(run_dir, exist_ok=True)
        cmd = [sys.executable, "-m", "dinov2_od_tpu_torch.train",
               "--train_images", data["train"][0],
               "--train_annotations", data["train"][1],
               "--val_images", data["val"][0],
               "--val_annotations", data["val"][1],
               "--num_epochs", str(args.epochs), "--device", args.device,
               "--output_dir", run_dir, *RECIPE, *ARMS[arm]]
        last = latest_checkpoint(run_dir)
        if last:
            cmd += ["--checkpoint", last]
        log = open(os.path.join(run_dir, "stdout.log"), "a")
        procs[arm] = (subprocess.Popen(cmd, env=env, stdout=log,
                                       stderr=subprocess.STDOUT), log)
        print(f"{arm}: {' '.join(cmd[2:])}", flush=True)
    walls, rcs = {}, {}
    while len(rcs) < len(procs):
        for arm, (p, _) in procs.items():
            if arm not in rcs and p.poll() is not None:
                rcs[arm], walls[arm] = p.returncode, time.perf_counter() - t0
        if args.deadline_s and time.perf_counter() - t0 > args.deadline_s:
            for arm, (p, _) in procs.items():
                if arm not in rcs:
                    p.send_signal(signal.SIGTERM)
            args.deadline_s = 0.0  # once; they checkpoint and exit
        time.sleep(2)
    ok = True
    for arm, (p, log) in procs.items():
        log.close()
        run_dir = os.path.join(args.runs, arm)
        dest = os.path.join(args.out, arm)
        os.makedirs(dest, exist_ok=True)
        for pattern in ("metrics_epoch_*.json", "train_epoch_*.json",
                        "*_train.log", "stdout.log"):
            for path in glob.glob(os.path.join(run_dir, pattern)):
                shutil.copy(path, dest)
        rec = summarize(arm, run_dir, walls[arm])
        rec["rc"] = rcs[arm]
        ok &= rcs[arm] == 0
        with open(os.path.join(dest, "summary.json"), "w") as f:
            json.dump(rec, f, indent=1)
        print(json.dumps(rec), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
