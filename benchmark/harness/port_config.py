"""The port's configuration objects built from a configuration file, and
the check that the port's model has the file's widths."""

from __future__ import annotations

import dataclasses

from .common import CellError


def detector_config(cfg: dict):
    """The port's DetectorConfig, made as the port makes it for the model
    name, at the file's input size and head; the backbone in the file's
    dtype."""
    from dinov2_od_tpu_torch.config import detector_config_for_model_name

    det = detector_config_for_model_name(
        cfg["model_name"], num_classes=cfg["num_classes"],
        hidden_dim=cfg["decoder_hidden_dim"],
        num_queries=cfg["num_queries"], num_layers=cfg["decoder_layers"],
        num_heads=cfg["decoder_heads"],
        dim_feedforward=cfg["decoder_ffn_dim"], dropout=cfg["dropout"],
        use_deformable=True, n_points=cfg["n_points"], lora_r=cfg["lora_r"],
        lora_alpha=cfg["lora_alpha"], image_size=cfg["image_size"])
    bb = dataclasses.replace(det.backbone, dtype=cfg["backbone_dtype"],
                             lora_last_n_blocks=cfg["lora_last_n_blocks"])
    det = dataclasses.replace(det, backbone=bb)
    check_widths(det, cfg)
    return det


def check_widths(det, cfg: dict) -> None:
    """Raise where the port's config departs from the file's."""
    bb, dc = det.backbone, det.decoder
    pairs = {
        "hidden_size": bb.hidden_dim, "num_hidden_layers": bb.depth,
        "num_attention_heads": bb.num_heads, "mlp_ratio": bb.mlp_ratio,
        "patch_size": bb.patch_size, "image_size": bb.image_size,
        "layerscale_value": bb.layerscale_init,
        "gelu_approximate": bb.gelu_approximate,
        "decoder_hidden_dim": dc.hidden_dim,
        "decoder_ffn_dim": dc.dim_feedforward,
        "num_classes": dc.num_classes, "num_queries": dc.num_queries,
    }
    bad = {k: (cfg[k], v) for k, v in pairs.items() if cfg[k] != v}
    if bb.ffn_type != "mlp" or bb.lora_mode != "factored":
        bad["ffn_type/lora_mode"] = ("mlp/factored",
                                     f"{bb.ffn_type}/{bb.lora_mode}")
    if bad:
        raise CellError(f"the port's config departs from the file: {bad}")


def train_config(cfg: dict, traffic: dict):
    """The port's TrainConfig of a train cell: the file's optimizer,
    matcher and loss, the traffic's batch and GT slots."""
    from dinov2_od_tpu_torch.config import (DataConfig, LossConfig,
                                            MatcherConfig, OptimConfig,
                                            TrainConfig)

    oc, mc, lc = cfg["optimizer"], cfg["matcher"], cfg["loss"]
    return TrainConfig(
        detector=detector_config(cfg),
        data=DataConfig(batch_size=traffic["batch_size"],
                        max_boxes=traffic["gt_slots"]),
        optim=OptimConfig(learning_rate=oc["learning_rate"],
                          weight_decay=oc["weight_decay"],
                          gradient_clip_val=oc["gradient_clip_val"]),
        matcher=MatcherConfig(cost_class=mc["cost_class"],
                              cost_bbox=mc["cost_bbox"],
                              cost_giou=mc["cost_giou"],
                              focal_alpha=mc["focal_alpha"],
                              focal_gamma=mc["focal_gamma"]),
        loss=LossConfig(weight_ce=lc["weight_ce"],
                        weight_bbox=lc["weight_bbox"],
                        weight_giou=lc["weight_giou"],
                        focal_alpha=lc["focal_alpha"],
                        focal_gamma=lc["focal_gamma"]),
        seed=0)
