"""Package metadata (reference: setup.py — package dino_detector v0.1.0).

Core deps (jax, flax, optax, orbax, numpy, Pillow) are assumed present in
the target environment; nothing exotic is required. torch/transformers are
optional (only the pretrained-weight importer uses them)."""

from setuptools import find_packages, setup

setup(
    name="dinov2_od_tpu",
    version="0.1.0",
    description=(
        "TPU-native DINOv2 + DETR object detection framework "
        "(JAX / XLA / Pallas)"
    ),
    packages=find_packages(
        include=["dinov2_od_tpu*", "dinov2_od_tpu_torch*", "dino_detector*"]
    ),
    # The PyTorch port's CUDA kernels are compiled from these sources with
    # nvcc at first use (dinov2_od_tpu_torch/ops/_build.py).
    package_data={"dinov2_od_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "optax",
        "orbax-checkpoint",
        "numpy",
        "Pillow",
        "tqdm",
    ],
    extras_require={
        "import": ["torch", "transformers", "safetensors"],
        # The PyTorch/CUDA port (dinov2_od_tpu_torch); its kernels also
        # need the CUDA toolkit's nvcc on the machine with the card.
        "torch": ["torch", "numpy"],
        "viz": ["matplotlib", "tensorboard"],
    },
    entry_points={
        "console_scripts": [
            "dinov2-od-train=dinov2_od_tpu.train.cli:main",
            "dinov2-od-download=dinov2_od_tpu.tools.download:main",
            "dinov2-od-serve=dinov2_od_tpu.serve:main",
        ]
    },
)
