"""PyTorch/CUDA port of dinov2_od_tpu: DINOv2 + deformable DETR detection.

Its serving path (backbone, decoder, device-side top-k, Predictor and the
HTTP server, in bf16 or int8 W8A8), its train step and its training CLI
(`python -m dinov2_od_tpu_torch.train`: COCO-format or packed data, COCO
AP, checkpoints, resume, a pretrained HF DINOv2 backbone or a reference
checkpoint imported; `python -m dinov2_od_tpu_torch.serve` serves a
checkpoint or a bundle of `tools/export.py`) run on an NVIDIA H100; the backbone's self-attention goes
through hand-written CUDA flash-attention kernels (csrc/flash_attn_fwd.cu,
csrc/flash_attn_bwd.cu) and its int8 fc2 through a fused quantize + int8
GEMM kernel (csrc/int8_gemm.cu), built with nvcc at first use. Imports
torch and numpy, scipy for the matcher's exact solve; Pillow where files
or bytes are decoded. Entry points run on the CUDA card unless the
caller passes device="cpu".
"""

from .config import (
    BackboneConfig,
    DecoderConfig,
    DetectorConfig,
    detector_config_for_model_name,
    lightweight_detector_config,
)
from .inference import Predictor, prepare_images
from .models.detector import (
    cast_frozen_weights,
    count_params,
    detector_apply,
    fold_detector_lora,
    init_detector_params,
)
from .params import params_from_numpy, params_to_numpy

__all__ = [
    "BackboneConfig",
    "DecoderConfig",
    "DetectorConfig",
    "Predictor",
    "cast_frozen_weights",
    "count_params",
    "detector_apply",
    "detector_config_for_model_name",
    "fold_detector_lora",
    "init_detector_params",
    "lightweight_detector_config",
    "params_from_numpy",
    "params_to_numpy",
    "prepare_images",
]
