"""Detector and training configuration for the PyTorch port.

Own copies of the JAX package's dataclasses (dinov2_od_tpu/config.py),
restricted to the fields the serving path, the train step and the
training loop read (the MoE FFN's four knobs included); the remaining
loader fields come back with the slices that read them. The field names
and defaults are the JAX package's, so the keyword arguments of a port
config also build the JAX one.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# name: (hidden_dim, depth, heads, mlp_ratio, ffn_type)
_VIT_VARIANTS = {
    "small": (384, 12, 6, 4.0, "mlp"),
    "base": (768, 12, 12, 4.0, "mlp"),
    "large": (1024, 24, 16, 4.0, "mlp"),
    "giant": (1536, 40, 24, 8 / 3, "swiglu"),
}


def variant_from_model_name(model_name: str) -> str:
    """ViT variant from an HF-style model name: substring match, 'base'
    when nothing matches."""
    for v in ("small", "base", "large", "giant"):
        if v in model_name:
            return v
    return "base"


@dataclasses.dataclass(frozen=True)
class BackboneConfig:
    """DINOv2 ViT backbone + LoRA configuration."""

    variant: str = "base"
    image_size: int = 224
    patch_size: int = 14
    # LoRA scaling is `alpha`, not alpha / r.
    lora_r: int = 2
    lora_alpha: float = 1.0
    lora_last_n_blocks: int = 2
    target_dim: Optional[int] = None
    layerscale_init: float = 1.0
    drop_cls_token: bool = True
    dtype: str = "float32"
    lora_mode: str = "factored"  # 'factored' | 'fold'
    gelu_approximate: bool = True
    prefix_int8: bool = False
    hidden_dim_override: Optional[int] = None
    depth_override: Optional[int] = None
    num_heads_override: Optional[int] = None
    mlp_ratio_override: Optional[float] = None
    # "mlp" | "swiglu" | "moe" (None = the variant's). "moe" swaps the dense
    # FFN of the adapted last `lora_last_n_blocks` blocks for a mixture of
    # experts (ops/moe.py; the sparse-upcycling layout of models/vit.py).
    ffn_type_override: Optional[str] = None
    moe_num_experts: int = 8
    moe_top_k: int = 2
    # Slots an expert a batch row: ceil(top_k * tokens / experts * cf).
    moe_capacity_factor: float = 1.25
    # Weight of the router's load-balance loss in the training objective.
    moe_aux_weight: float = 0.01

    @property
    def hidden_dim(self) -> int:
        return self.hidden_dim_override or _VIT_VARIANTS[self.variant][0]

    @property
    def depth(self) -> int:
        return self.depth_override or _VIT_VARIANTS[self.variant][1]

    @property
    def num_heads(self) -> int:
        return self.num_heads_override or _VIT_VARIANTS[self.variant][2]

    @property
    def mlp_ratio(self) -> float:
        return self.mlp_ratio_override or _VIT_VARIANTS[self.variant][3]

    @property
    def ffn_type(self) -> str:
        return self.ffn_type_override or _VIT_VARIANTS[self.variant][4]

    @property
    def mlp_dim(self) -> int:
        return int(self.hidden_dim * self.mlp_ratio)

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size * self.grid_size

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1  # +1 CLS

    @property
    def out_dim(self) -> int:
        return self.target_dim if self.target_dim is not None else self.hidden_dim


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """DETR decoder configuration."""

    hidden_dim: int = 768
    num_queries: int = 50
    num_layers: int = 3
    num_heads: int = 8
    dim_feedforward: int = 1024
    dropout: float = 0.1
    num_classes: int = 91
    use_deformable: bool = True
    n_points: int = 2
    tie_layer_weights: bool = False
    dtype: str = "float32"
    # Deep supervision: in train mode every intermediate layer's output
    # goes through the shared heads and the set criterion too.
    aux_loss: bool = False


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    """Hungarian matcher costs and solver."""

    cost_class: float = 1.0
    cost_bbox: float = 5.0
    cost_giou: float = 2.0
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    # 'jv' (exact, on the host), 'auction' (on the device), or 'auto'
    # (exact below auction_threshold padded GT slots, auction at or above
    # it).
    assignment: str = "auto"
    auction_threshold: int = 40
    # Match every image with image 0's predictions, as the original
    # PyTorch matcher's slicing bug did (for A/B studies).
    replicate_batch0_bug: bool = False


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Set-criterion loss weights."""

    weight_ce: float = 1.0
    weight_bbox: float = 5.0
    weight_giou: float = 2.0
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Full detector = backbone + decoder."""

    backbone: BackboneConfig = BackboneConfig()
    decoder: DecoderConfig = DecoderConfig()

    def __post_init__(self):
        if self.backbone.out_dim != self.decoder.hidden_dim:
            raise ValueError(
                f"backbone out_dim {self.backbone.out_dim} != decoder "
                f"hidden_dim {self.decoder.hidden_dim}; set "
                f"backbone.target_dim to the decoder dim."
            )


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """The batch the train step is fed."""

    batch_size: int = 8
    max_boxes: int = 100  # padded GT slots per image
    # ImageNet normalisation of uint8 feeds (train/step.py prep_images).
    normalize: bool = True
    # Decode threads of the loader (data/loader.py).
    num_workers: int = 4


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """Adam with L2 weight decay added to the gradient, global-norm
    clipping, an optional learning-rate schedule, EMA and the non-finite
    step guard."""

    learning_rate: float = 1e-4
    weight_decay: float = 1e-4
    gradient_clip_val: float = 1.0
    # > 1: the mean gradient of k mini-steps, one optimizer update every
    # k-th call (optax.MultiSteps' semantics, train/state.py).
    gradient_accumulation_steps: int = 1
    lr_schedule: str = "constant"  # 'constant' | 'cosine' | 'linear'
    warmup_steps: int = 0
    total_steps: int = 0
    min_lr_ratio: float = 0.0
    ema_decay: float = 0.0  # 0: no EMA of the trainable leaves
    # Skip the whole update (params, moments, EMA) when a gradient is not
    # finite, and report nonfinite_skip = 1.
    skip_nonfinite: bool = False


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """Train-time augmentation, on the device inside the train step
    (data/augment.py); every augmentation is off by default."""

    # Per-image horizontal flip probability (boxes mirrored with it).
    hflip_prob: float = 0.0
    # Brightness/contrast/saturation factors ~ U[1-s, 1+s]; 0 = off.
    color_jitter: float = 0.0
    # Aspect-preserving zoom ~ U[1-s, 1+s] with random placement (zoom-out
    # pads black, zoom-in crops); boxes follow and are clipped.
    scale_jitter: float = 0.0
    # Boxes whose clipped width or height (normalised) is not above this
    # after the zoom lose their valid bit.
    min_box_size: float = 1e-3

    @property
    def enabled(self) -> bool:
        return (self.hflip_prob > 0 or self.color_jitter > 0
                or self.scale_jitter > 0)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Process mesh layout (parallel/sharding.py): 'data' is the
    data-parallel axis, 'model' the Megatron tensor-parallel one.

    Context (sequence) parallelism runs the backbone's tokens sharded over
    a ring of ranks (ops/ring_attention.py), in either of the JAX
    package's two modes:
    - `context_parallel_size` > 0: a dedicated 'context' axis on a
      three-axis ('data', 'context', 'model') mesh, which composes with
      tensor parallelism over 'model' (DP x CP x TP);
    - `context_parallel`: the legacy mode, where the ring runs over the
      two-axis mesh's model axis (of `model_parallel_size` ranks) and the
      params stay replicated over it (no tensor parallelism).
    Pipeline parallelism and FSDP are not ported yet (ROADMAP.md): setting
    any of their fields raises."""

    data_axis: str = "data"
    model_axis: str = "model"
    context_axis: str = "context"
    stage_axis: str = "stage"
    model_parallel_size: int = 1
    context_parallel_size: int = 0
    pipeline_parallel_size: int = 0
    context_parallel: bool = False
    pipeline_parallel: bool = False
    pipeline_microbatches: int = 0
    fsdp: bool = False
    pipeline_chunks: int = 1

    def __post_init__(self):
        # The JAX package's exclusivity checks and messages
        # (dinov2_od_tpu/config.py MeshConfig.__post_init__).
        if self.context_parallel and self.pipeline_parallel:
            raise ValueError(
                "context_parallel and pipeline_parallel both claim the "
                "model axis — enable at most one"
            )
        if self.context_parallel_size > 0 and self.context_parallel:
            raise ValueError(
                "use either context_parallel (legacy: ring over the model "
                "axis) or context_parallel_size (dedicated context axis, "
                "composable with TP) — not both"
            )
        if self.context_parallel_size > 0 and self.pipeline_parallel:
            raise ValueError(
                "context_parallel_size and pipeline_parallel cannot be "
                "combined (the pipeline claims the model axis for stages)"
            )
        if self.pipeline_parallel_size > 0 and (
            self.pipeline_parallel
            or self.context_parallel
            or self.context_parallel_size > 0
        ):
            raise ValueError(
                "pipeline_parallel_size (dedicated stage axis) is "
                "exclusive with pipeline_parallel, context_parallel, and "
                "context_parallel_size"
            )
        unported = {
            "pipeline parallelism": (self.pipeline_parallel
                                     or self.pipeline_parallel_size > 0
                                     or self.pipeline_microbatches > 0
                                     or self.pipeline_chunks != 1),
            "FSDP": self.fsdp,
        }
        for what, asked in unported.items():
            if asked:
                raise NotImplementedError(
                    f"{what} is not ported to PyTorch yet (ROADMAP.md)")
        if self.model_parallel_size < 1:
            raise ValueError("model_parallel_size must be >= 1")
        if self.context_parallel_size < 0:
            raise ValueError("context_parallel_size must be >= 0")

    @property
    def tensor_parallel_size(self) -> int:
        """The Megatron degree: the model axis's size, except in legacy
        context parallelism, where that axis carries tokens."""
        return 1 if self.context_parallel else self.model_parallel_size

    @property
    def context_size(self) -> int:
        """The ring's size: 1 without context parallelism."""
        if self.context_parallel:
            return self.model_parallel_size
        return max(self.context_parallel_size, 1)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """What the train step reads."""

    detector: DetectorConfig = DetectorConfig()
    data: DataConfig = DataConfig()
    optim: OptimConfig = OptimConfig()
    matcher: MatcherConfig = MatcherConfig()
    loss: LossConfig = LossConfig()
    augment: AugmentConfig = AugmentConfig()
    mesh: MeshConfig = MeshConfig()
    # Recompute each adapted backbone block in the backward pass instead
    # of keeping its activations (torch.utils.checkpoint).
    use_remat: bool = False
    # Auxiliary layers reuse the final layer's assignment instead of
    # solving their own.
    share_aux_match: bool = False
    # The training loop's (train/loop.py): epochs, the seed of the data
    # order and of dropout, the checkpoint cadence, and SIGTERM ->
    # checkpoint at the next step boundary.
    num_epochs: int = 50
    seed: int = 42
    checkpoint_every_epochs: int = 10
    save_on_preemption: bool = True


def lightweight_detector_config(
    num_classes: int = 91,
    use_deformable: bool = True,
    n_points: int = 2,
    image_size: int = 224,
) -> DetectorConfig:
    """Small config: ViT-S backbone, decoder dim 256, 25 queries, 2
    layers, 4 heads, lora_r 1."""
    return DetectorConfig(
        backbone=BackboneConfig(
            variant="small",
            image_size=image_size,
            lora_r=1,
            lora_alpha=1.0,
            target_dim=256,
        ),
        decoder=DecoderConfig(
            hidden_dim=256,
            num_queries=25,
            num_layers=2,
            num_heads=4,
            dim_feedforward=512,
            num_classes=num_classes,
            use_deformable=use_deformable,
            n_points=n_points,
        ),
    )


def detector_config_for_model_name(
    model_name: str,
    num_classes: int = 91,
    hidden_dim: Optional[int] = 768,
    num_queries: int = 50,
    num_layers: int = 3,
    num_heads: int = 8,
    dim_feedforward: int = 1024,
    dropout: float = 0.1,
    use_deformable: bool = True,
    n_points: int = 2,
    lora_r: int = 2,
    lora_alpha: float = 1.0,
    image_size: int = 224,
) -> DetectorConfig:
    """DetectorConfig from an HF-style model name; the decoder dim
    defaults to 768 and a projection is added when it differs from the
    backbone's width."""
    variant = variant_from_model_name(model_name)
    backbone_dim = _VIT_VARIANTS[variant][0]
    if hidden_dim is None:
        hidden_dim = backbone_dim
    target_dim = hidden_dim if hidden_dim != backbone_dim else None
    return DetectorConfig(
        backbone=BackboneConfig(
            variant=variant,
            image_size=image_size,
            lora_r=lora_r,
            lora_alpha=lora_alpha,
            target_dim=target_dim,
        ),
        decoder=DecoderConfig(
            hidden_dim=hidden_dim,
            num_queries=num_queries,
            num_layers=num_layers,
            num_heads=num_heads,
            dim_feedforward=dim_feedforward,
            dropout=dropout,
            num_classes=num_classes,
            use_deformable=use_deformable,
            n_points=n_points,
        ),
    )
