"""A cell of the benchmark cut to a size the CPU runs in seconds: the
cell's own files with a ViT-S backbone at 28 px and a narrow decoder."""

from __future__ import annotations

import copy

from benchmark.harness import common


def tiny_config(name: str, backbone_dtype: str = "bfloat16") -> dict:
    c = common.read_json(common.BENCH_DIR / "configs" / f"{name}.json")
    c.update({"model_name": "facebook/dinov2-small", "hidden_size": 384,
              "num_hidden_layers": 12, "num_attention_heads": 6,
              "image_size": 28, "backbone_dtype": backbone_dtype,
              "decoder_hidden_dim": 32, "decoder_layers": 2,
              "decoder_heads": 2, "decoder_ffn_dim": 64, "num_queries": 6})
    return c


TRAIN_TRAFFIC = {"batch_size": 2, "pool_batches": 4, "warm_steps": 2,
                 "trace_steps": 2}


def tiny_cell(workload: str, backbone_dtype: str = "bfloat16",
              **traffic) -> common.Cell:
    spec = common.benchmark_spec()
    w = copy.deepcopy(common.read_json(
        common.BENCH_DIR / "workloads" / f"{workload}.json"))
    w["traffic"].update({**TRAIN_TRAFFIC, **traffic})
    e2e = common.metrics_of(spec["end_to_end"], workload)
    return common.Cell(name=workload, workload=w,
                       config=tiny_config(w["config"], backbone_dtype),
                       end_to_end=e2e,
                       per_layer=common.metrics_of(spec["per_layer"],
                                                   workload, e2e))
