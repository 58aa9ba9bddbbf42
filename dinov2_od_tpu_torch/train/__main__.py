"""`python -m dinov2_od_tpu_torch.train`: the training CLI (train/cli.py)."""

import sys

from .cli import main

sys.exit(main())
