"""FSDP (ZeRO-3 over the data axis) through the train step, checkpoints,
evaluation, int8 and the training CLI (dinov2_od_tpu_torch/parallel/,
models/, train/) against the JAX package and the port's one process, on
the CPU.

The port's ranks are processes of a gloo group (tests/torch_fsdp_worker.py,
which imports no JAX), one world of 4 started once for the module, its
jobs in order:

- one train step under FSDP over 4 data ranks and under FSDP 2 x TP 2 at
  tests/test_fsdp.py's `_tiny_cfg` widths (ViT-S at 56 px, lora_r 1, a
  2-layer deformable decoder of width 32, dropout 0; global batch 8), where
  the real threshold cuts the frozen block kernels and the patch
  embedding: against JAX's FSDP step on the same mesh and JAX's single
  device (test_fsdp.py's tolerances) and the port's one process (tighter,
  below);
- the same under FSDP 2 x TP 2 with the threshold lowered to MIN_ELEMS in
  both packages, at a tiny config (4 blocks of width 128, lora_r 2, a
  decoder of width 64), which reaches the three traps of JAX's rule:
  2-D stacked leaves cut on their depth axis, LoRA factors cut on their
  rank dim, and the deformable `offsets_kernel` (a TP `partial_grad`
  leaf) cut on its input dim; with it, a checkpoint written under FSDP,
  restored and cut again;
- the non-finite guard: a NaN written into one rank's gradient shard of
  one leaf skips the step on every rank (FSDP 4, FSDP 2 x TP 2, and TP 2
  without FSDP, where one model rank's shard can hold it too);
- the int8 prefix, fold-mode LoRA and remat in one step under FSDP 2 x
  TP 2 (the lowered threshold) against the port's one process;
- a bf16 step under FSDP 2 x TP 2 against the same step under DP 2 x TP
  2 without FSDP, bit for bit;
- the eval forward of a float and an int8 tree under FSDP 4 (B6's plain
  version on the CPU);
- the training CLI with `--fsdp --model_parallel 2` for two epochs with
  validation and checkpoints, then `--only_evaluate --quantize int8` on
  the same mesh from its final model, against one process's runs.
"""

import dataclasses
import json
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from dinov2_od_tpu import config as jcfg
from dinov2_od_tpu.models.detector import init_detector_params as jax_init
from dinov2_od_tpu.models.detector import trainable_mask as jax_trainable_mask
from dinov2_od_tpu.parallel import create_mesh as jax_create_mesh
from dinov2_od_tpu.parallel import sharding as jsh
from dinov2_od_tpu.train import state as jstate
from dinov2_od_tpu.train.step import make_train_step as jax_make_train_step

from dinov2_od_tpu_torch.data.synthetic import (NUM_SYNTHETIC_CLASSES,
                                                make_batch,
                                                write_coco_dataset)
from dinov2_od_tpu_torch.models.detector import fold_detector_lora
from dinov2_od_tpu_torch.models.quantize import quantize_detector_int8
from dinov2_od_tpu_torch.params import params_from_numpy, params_to_numpy
from dinov2_od_tpu_torch.parallel import sharding as psh
from dinov2_od_tpu_torch.train import state as pstate
from dinov2_od_tpu_torch.train.checkpoint import STATE_FILE, flatten_tree
from dinov2_od_tpu_torch.train.step import (make_eval_step,
                                            make_eval_topk_step,
                                            make_train_step, train_grads)

import torch_cp_worker as cp
import torch_fsdp_worker as worker
from torch_mesh_cli_worker import (cli_args, detections, epoch_losses,
                                   eval_args, final_params, init_checkpoint,
                                   read_json, tiny_cli)

# tests/test_fsdp.py's `_tiny_cfg` widths.
VITS = dict(variant="small", image_size=56, patch_size=14, lora_r=1,
            target_dim=32)
VITS_DECODER = dict(hidden_dim=32, num_queries=8, num_layers=2, num_heads=4,
                    dim_feedforward=64, num_classes=NUM_SYNTHETIC_CLASSES,
                    use_deformable=True, dropout=0.0)
TINY = dict(variant="small", image_size=56, hidden_dim_override=128,
            num_heads_override=2, depth_override=4, lora_r=2,
            lora_last_n_blocks=2, target_dim=64)
DECODER = dict(hidden_dim=64, num_queries=8, num_layers=2, num_heads=4,
               dim_feedforward=96, num_classes=NUM_SYNTHETIC_CLASSES,
               dropout=0.0)
MIN_ELEMS = 256  # the lowered threshold: 2-D [4, 128] leaves are cut
BATCH, LOW_BATCH, MAX_BOXES, LR = 8, 4, 6, 3e-4
WORLD = 4
FSDP4 = dict(fsdp=True)
FSDP2_TP2 = dict(fsdp=True, model_parallel_size=2)
# name: (config, the port's MeshConfig fields, lowered threshold or None)
STEPS = {"fsdp4": ("vits", FSDP4, None),
         "fsdp2_tp2": ("vits", FSDP2_TP2, None),
         "low_fsdp2_tp2": ("tiny", FSDP2_TP2, MIN_ELEMS)}
# The gather points inside the block under FSDP 2 x TP 2 at the lowered
# threshold: the int8 prefix (its blocks quantized once gathered, never a
# shard), fold-mode LoRA (W + alpha A @ B on gathered leaves) and remat
# (the adapted blocks gathered again in the backward), one step against
# the port's one process on the same config.
RECIPES = dict(TINY, prefix_int8=True, lora_mode="fold")
RECIPES_TRAIN = {"use_remat": True}
# The same step in bf16 (the card's backbone dtype) under FSDP 2 x TP 2 and
# under plain DP 2 x TP 2, at the lowered threshold: FSDP's layout, not
# its math.
BF16 = dict(TINY, dtype="bfloat16")
NORM_ULPS = 2.0 ** -22  # two fp32 ulps
AGAINST_DP = {"bf16_fsdp2_tp2": FSDP2_TP2,
              "bf16_dp2_tp2": dict(model_parallel_size=2)}
# name: (MeshConfig fields, lowered threshold or None, the poisoned leaf)
GUARDS = {"fsdp4": (FSDP4, MIN_ELEMS, ("decoder", "class_embed", "kernel")),
          "fsdp2_tp2": (FSDP2_TP2, MIN_ELEMS,
                        ("decoder", "class_embed", "kernel")),
          "tp2": (dict(model_parallel_size=2), None,
                  ("decoder", "layers", "fc1", "kernel"))}
POISON_RANK = 1
# tests/test_fsdp.py's tolerances against JAX (on the same mesh and on one
# device): loss rtol 2e-4, params rtol 1e-3 and atol 3e-5.
JAX_LOSS_RTOL, JAX_PARAM_RTOL, JAX_PARAM_ATOL = 2e-4, 1e-3, 3e-5
# Against the port's one process, relative to max(1, the reference's
# magnitude): the loss terms, the norm, every trainable gradient and the
# eval outputs 1e-5 (the same math, the data-summed gradients
# reduce-scattered instead of all-reduced, the model group's sums split);
# the params after Adam's first step 1e-5 (test_fsdp.py's atol is 3e-5;
# a gradient at rounding noise moves its element by up to 2 lr = 6e-4,
# and none here is); top-k scores 1e-5, boxes TOPK_TOL (pixels).
PORT_TOL = 1e-5
TOPK_TOL = 1e-3
# The CLI against one process: tests/test_torch_mesh_cli.py's for the
# losses and metrics; the final params' updates within CLI_UPDATE_TOL of
# each leaf's largest update (0.2 % read on the CPU, for the decoder's key
# kernel, whose gradient is near the rounding noise).
CLI_TOL = 1e-5
CLI_UPDATE_TOL = 1e-2
SPEC = {"backbone": dict(variant="small", image_size=56,
                         hidden_dim_override=128, num_heads_override=2,
                         depth_override=3, lora_r=2, lora_last_n_blocks=2,
                         target_dim=64),
        "decoder": dict(hidden_dim=64, num_queries=8, num_layers=2,
                        num_heads=4, dim_feedforward=96, num_classes=6,
                        dropout=0.0),
        "max_boxes": 6}
CLI_FLAGS = ["--fsdp", "--model_parallel", "2"]
INT8 = ["--quantize", "int8"]


def _plain(tree):
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    return np.array(tree, copy=True)


def _flat(t, prefix=""):
    out = {}
    for k, v in t.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        elif v is not None:
            out[prefix + k] = v
    return out


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _rel(ref, out):
    ref, out = _np(ref), _np(out)
    return float(np.abs(ref - out).max() / max(1.0, np.abs(ref).max()))


def _jdet(backbone, decoder):
    return jcfg.DetectorConfig(backbone=jcfg.BackboneConfig(**backbone),
                               decoder=jcfg.DecoderConfig(**decoder))


CONFIGS = {"vits": (VITS, VITS_DECODER, BATCH),
           "tiny": (TINY, DECODER, LOW_BATCH),
           "recipes": (RECIPES, DECODER, LOW_BATCH)}


def _tree(name):
    """JAX's init, with lora_B drawn nonzero in the adapted blocks' rows
    (the others zero, as the masked updates keep them)."""
    backbone, decoder, _ = CONFIGS[name]
    t = _plain(jax_init(jax.random.key(0), _jdet(backbone, decoder)))
    rng = np.random.default_rng(0)
    depth = t["backbone"]["blocks"]["q"]["kernel"].shape[0]
    first = depth - jcfg.BackboneConfig(**backbone).lora_last_n_blocks
    for lin in t["backbone"]["blocks"].values():
        if isinstance(lin, dict) and "lora_B" in lin:
            b = rng.normal(0, 0.05, lin["lora_B"].shape).astype(np.float32)
            b[:first] = 0.0
            lin["lora_B"] = b
    return t


def _jtrain(name, mesh=None):
    backbone, decoder, batch = CONFIGS[name]
    return jcfg.TrainConfig(
        detector=_jdet(backbone, decoder),
        data=jcfg.DataConfig(batch_size=batch, max_boxes=MAX_BOXES),
        optim=jcfg.OptimConfig(learning_rate=LR),
        mesh=jcfg.MeshConfig(**(mesh or {})))


def _jax_placed(name, tree, batch, fields, min_elems, monkeypatch):
    """JAX's state and batch on its 4-device mesh of the same shape, the
    params placed by its `shard_params` (with the threshold lowered while
    it runs when `min_elems` is given); None for one device."""
    jc = _jtrain(name, fields)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    mesh = None
    if fields is not None:
        mesh = jax_create_mesh(jc.mesh.model_parallel_size,
                               devices=jax.devices()[:WORLD], cfg=jc.mesh)
        with monkeypatch.context() as m:
            if min_elems is not None:
                m.setattr(jsh, "_FSDP_MIN_ELEMS", min_elems)
            params = jsh.shard_params(params, mesh, cfg=jc.mesh)
        bsh = NamedSharding(mesh, P(jc.mesh.data_axis))
        jb = {k: jax.device_put(v, bsh) for k, v in jb.items()}
    return jc, mesh, params, jb


def _jax_step(jc, mesh, params, jb):
    """JAX's step: (metrics, updated params as flat numpy)."""
    tx = jstate.make_optimizer(jc.optim, jc.detector, params)
    state = jstate.create_train_state(params, jc.optim, jc.detector)
    state, metrics = jax_make_train_step(jc, tx, mesh=mesh)(
        state, jb, jax.random.key(1))
    return (jax.tree_util.tree_map(np.asarray, metrics),
            _flat(jax.tree_util.tree_map(np.asarray, state.params)))


def _port_cfg(name, **optim):
    backbone, decoder, batch = CONFIGS[name]
    cfg = cp.train_config(backbone, decoder, {}, batch, MAX_BOXES, LR)
    train = RECIPES_TRAIN if name == "recipes" else {}
    return dataclasses.replace(
        cfg, optim=dataclasses.replace(cfg.optim, **optim), **train)


def _one_process(name, tree, batch, int8_tree=None):
    """The port's one process: the eval forward and top-k, the loss terms
    and gradients, one step, and with `int8_tree` the int8 forward."""
    cfg = _port_cfg(name)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    params = params_from_numpy(tree, device="cpu")
    out = {"forward": make_eval_step(cfg)(params, tb["images"])}
    sizes = torch.full((tb["images"].shape[0], 2), 56.0)
    out["topk"] = make_eval_topk_step(cfg, max_detections=10)(
        params, tb["images"], sizes)["topk"]
    if int8_tree is not None:
        out["int8"] = make_eval_step(cfg)(
            params_from_numpy(int8_tree, device="cpu"), tb["images"])
    state = pstate.create_train_state(params, cfg.optim, cfg.detector)
    out["losses"], grads = train_grads(cfg, state, tb)
    out["grads"] = _flat(grads)
    _, out["metrics"] = make_train_step(cfg)(state, tb)
    out["params"] = _flat(params_to_numpy(state.params))
    return out


def _one_process_ema_step(name, tree, batch):
    """The port's one process after one step with an EMA (the checkpoint
    job's)."""
    cfg = _port_cfg(name, ema_decay=0.5)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    state = pstate.create_train_state(params_from_numpy(tree, device="cpu"),
                                      cfg.optim, cfg.detector)
    state, _ = make_train_step(cfg)(state, tb)
    return state


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the ranks and the in-process runs share the
    suite's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _int8_tree(tiny):
    cfg = _port_cfg("tiny")
    return params_to_numpy(quantize_detector_int8(fold_detector_lora(
        params_from_numpy(tiny, device="cpu"), cfg.detector)))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_fsdp")
    trees = {name: _tree(name) for name in CONFIGS}
    batches = {name: make_batch(np.random.default_rng(0), b, image_size=56,
                                max_boxes=MAX_BOXES)
               for name, (_, _, b) in CONFIGS.items()}
    int8 = _int8_tree(trees["tiny"])
    data = write_coco_dataset(str(tmp / "data"), num_images=8,
                              image_size=56, seed=7, max_objects=2)
    init = init_checkpoint(str(tmp), SPEC)
    out = {k: str(tmp / k) for k in ("cli", "cli_one", "int8", "int8_one")}
    jobs = []
    for name, (config, fields, low) in STEPS.items():
        backbone, decoder, _ = CONFIGS[config]
        job = dict(kind="step", name=name, mesh=fields, tree=trees[config],
                   batch=batches[config], backbone=backbone, decoder=decoder)
        if low is not None:
            job.update(min_elems=low, ckpt=str(tmp / f"ckpt_{name}"))
        jobs.append(job)
    jobs.append(dict(kind="step", name="recipes", mesh=FSDP2_TP2,
                     tree=trees["tiny"], batch=batches["tiny"],
                     backbone=RECIPES, decoder=DECODER,
                     train=RECIPES_TRAIN, min_elems=MIN_ELEMS))
    for name, fields in AGAINST_DP.items():
        jobs.append(dict(kind="step", name=name, mesh=fields,
                         tree=trees["tiny"], batch=batches["tiny"],
                         backbone=BF16, decoder=DECODER,
                         min_elems=MIN_ELEMS))
    for name, (fields, low, leaf) in GUARDS.items():
        jobs.append(dict(kind="guard", name=f"guard_{name}", mesh=fields,
                         tree=trees["tiny"], batch=batches["tiny"],
                         backbone=TINY, decoder=DECODER, poison=leaf,
                         poison_rank=POISON_RANK,
                         **({} if low is None else {"min_elems": low})))
    jobs.append(dict(kind="int8", name="int8", mesh=FSDP4,
                     min_elems=MIN_ELEMS, float=trees["tiny"], int8=int8,
                     images=batches["tiny"]["images"], backbone=TINY,
                     decoder=DECODER))
    final = os.path.join(out["cli"], "final_model")
    jobs.append(dict(kind="cli", name="cli", mesh={}, spec=SPEC,
                     min_elems=MIN_ELEMS,
                     args=cli_args(data, init, out["cli"], *CLI_FLAGS)))
    jobs.append(dict(kind="cli", name="cli_int8", mesh={}, spec=SPEC,
                     min_elems=MIN_ELEMS,
                     args=eval_args(data, final, out["int8"], *INT8,
                                    *CLI_FLAGS)))
    ranks = worker.start(jobs, WORLD, tmp / "ranks")
    try:
        # JAX's references compiled side by side in threads (XLA's
        # compiles leave the GIL), the port's one process meanwhile. The
        # lowered threshold holds only while JAX places the params.
        mp = pytest.MonkeyPatch()
        placed = {"one": _jax_placed("vits", trees["vits"], batches["vits"],
                                     None, None, mp)}
        for name, (config, fields, low) in STEPS.items():
            placed[name] = _jax_placed(config, trees[config],
                                       batches[config], fields, low, mp)
        with ThreadPoolExecutor(len(placed)) as pool:
            jax_steps = {k: pool.submit(_jax_step, *v)
                         for k, v in placed.items()}
            ref = {"vits": _one_process("vits", trees["vits"],
                                        batches["vits"]),
                   "tiny": _one_process("tiny", trees["tiny"],
                                        batches["tiny"], int8),
                   "ema": _one_process_ema_step("tiny", trees["tiny"],
                                                batches["tiny"]),
                   "recipes": _one_process("recipes", trees["tiny"],
                                           batches["tiny"])}
            with tiny_cli(SPEC) as cli:
                assert cli.main(cli_args(data, init, out["cli_one"])) == 0
                assert cli.main(eval_args(
                    data, os.path.join(out["cli_one"], "final_model"),
                    out["int8_one"], *INT8)) == 0
            ref["jax"] = {k: f.result() for k, f in jax_steps.items()}
        results = worker.results(ranks)
    finally:
        ranks.kill()
    layouts = {name: {p: tuple(a.sharding.spec)
                      for p, a in _flat_paths(v[2]).items()}
               for name, v in placed.items() if name != "one"}
    return {"ref": ref, "results": results, "trees": trees, "out": out,
            "layouts": layouts, "rank_logs": tmp / "ranks", "init": init,
            "jax_counts": {name: _jax_counts(*v[:3]) for name, v in
                           placed.items() if name != "one"}}


def _jax_counts(jc, mesh, params):
    """JAX's param and trainable (Adam-moment) elements a device."""
    mask = _flat_paths(jax_trainable_mask(params, jc.detector))
    counts = {"params": 0, "moments": 0}
    for path, a in _flat_paths(params).items():
        n = int(np.prod(a.sharding.shard_shape(a.shape)))
        counts["params"] += n
        counts["moments"] += n if mask[path] else 0
    del mesh
    return counts


def _flat_paths(tree):
    """{path tuple: leaf} of a JAX tree, paths as the port names them."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {tuple(str(getattr(k, "key", getattr(k, "name", ""))) for k in p):
            v for p, v in leaves}


def _results(run, name):
    return [r[name] for r in run["results"]]


def _data_dim(spec, ndim):
    """The dim (from the right) of a JAX spec's 'data' entry, or None."""
    entries = list(spec) + [None] * (ndim - len(spec))
    return next((d - ndim for d, e in enumerate(entries) if e == "data"),
                None)


@pytest.mark.parametrize("name", list(STEPS))
def test_fsdp_layout_and_rank_counts_are_jaxs(run, name):
    """Every rank cut the leaves JAX's `shard_params` cut on its mesh, on
    the same dims, and holds as many param and Adam-moment elements as
    each of JAX's devices."""
    tree = _flat_paths(run["trees"][STEPS[name][0]])
    want = {}
    for path, spec in run["layouts"][name].items():
        d = _data_dim(spec, tree[path].ndim)
        if d is not None:
            want[path] = (tuple(tree[path].shape), d)
    assert want, "JAX cut no leaf"
    for r in _results(run, name):
        assert r["layout"] == want
        assert r["elements"] == run["jax_counts"][name]


@pytest.mark.parametrize("name", list(STEPS))
def test_fsdp_step_matches_jax_and_one_process(run, name):
    """One step: the loss against JAX's step on the same mesh and on one
    device (rtol 2e-4), the params after it against both (rtol 1e-3, atol
    3e-5), and the loss terms, gradients, norm and params against the
    port's one process (PORT_TOL); frozen shards keep their values."""
    config = STEPS[name][0]
    one = run["ref"][config]
    jmesh_metrics, jmesh_params = run["ref"]["jax"][name]
    jone = run["ref"]["jax"]["one"] if config == "vits" else None
    for r in _results(run, name):
        loss = float(r["losses"]["loss"])
        refs = [jmesh_metrics] + ([jone[0]] if jone else [])
        for m in refs:
            np.testing.assert_allclose(loss, float(m["loss"]),
                                       rtol=JAX_LOSS_RTOL)
        for key in ("loss", "loss_ce", "loss_bbox", "loss_giou"):
            assert _rel(one["losses"][key], r["losses"][key]) <= PORT_TOL
        for key in ("loss", "grad_norm"):
            assert _rel(one["metrics"][key], r["metrics"][key]) <= PORT_TOL
        got = _flat(r["grads"])
        assert set(got) == set(one["grads"])
        for k, g in got.items():
            assert _rel(one["grads"][k], g) <= PORT_TOL, k
        new = _flat(r["stepped"])
        for k, v in new.items():
            for ref in [jmesh_params[k]] + ([jone[1][k]] if jone else []):
                np.testing.assert_allclose(_np(v), ref, rtol=JAX_PARAM_RTOL,
                                           atol=JAX_PARAM_ATOL, err_msg=k)
            assert _rel(one["params"][k], v) <= PORT_TOL, k
        assert r["frozen_kept"]


@pytest.mark.parametrize("name", list(STEPS))
def test_fsdp_forward_and_topk_match_one_process(run, name):
    """The eval forward and the top-k step on each data rank's rows
    against the port's one process on the whole batch."""
    one = run["ref"][STEPS[name][0]]
    for r in _results(run, name):
        rows = r["forward"]["pred_logits"].shape[0]
        mine = slice(r["data_index"] * rows, (r["data_index"] + 1) * rows)
        for key in ("pred_logits", "pred_boxes"):
            assert _rel(one["forward"][key][mine], r["forward"][key]) \
                <= PORT_TOL, key
        topk = one["topk"][mine]
        assert torch.allclose(r["topk"][..., :2], topk[..., :2], rtol=0,
                              atol=PORT_TOL)
        assert torch.allclose(r["topk"], topk, rtol=0, atol=TOPK_TOL)


def test_fsdp_is_plain_dp_bit_for_bit(run):
    """A bf16 step under FSDP 2 x TP 2 (the lowered threshold: block
    kernels, LoRA factors and decoder leaves cut) against the same step
    under DP 2 x TP 2 without FSDP, rank by rank: the outputs, the loss
    terms and the gathered gradients are equal bit for bit (two data
    ranks: a reduce-scatter adds the same two terms an all-reduce does);
    the global norm sums its squares by the groups that shard each leaf,
    in another order, so it may differ in its last bit (NORM_ULPS), and
    the params after the clip, weight decay and Adam within PORT_TOL.
    Where a mesh run differs from one process, FSDP adds nothing to
    it."""
    fsdp, dp = (_results(run, n) for n in AGAINST_DP)
    assert fsdp[0]["layout"] and not dp[0]["layout"]
    for a, b in zip(fsdp, dp):
        for key in ("forward", "losses", "grads", "metrics", "stepped"):
            fa, fb = _flat(a[key]), _flat(b[key])
            assert fa.keys() == fb.keys(), key
            for k in fa:
                if key == "metrics":
                    assert torch.allclose(fa[k], fb[k], rtol=NORM_ULPS,
                                          atol=0), (key, k)
                elif key == "stepped":
                    assert _rel(fb[k], fa[k]) <= PORT_TOL, (key, k)
                else:
                    assert torch.equal(fa[k], fb[k]), (key, k)
        assert torch.equal(a["topk"], b["topk"])


def test_int8_prefix_fold_and_remat_under_fsdp_match_one_process(run):
    """The int8 prefix, fold-mode LoRA and remat under FSDP 2 x TP 2 (the
    lowered threshold: the prefix's kernels cut on K, the factors on
    their rank dim): the loss terms, the norm, every trainable gradient
    and the params after the step within PORT_TOL of one process on the
    same config."""
    one = run["ref"]["recipes"]
    results = _results(run, "recipes")
    assert ("backbone", "blocks", "q", "kernel") in results[0]["layout"]
    for r in results:
        for key in ("loss", "loss_ce", "loss_bbox", "loss_giou"):
            assert _rel(one["losses"][key], r["losses"][key]) <= PORT_TOL
        for key in ("loss", "grad_norm"):
            assert _rel(one["metrics"][key], r["metrics"][key]) <= PORT_TOL
        got = _flat(r["grads"])
        assert set(got) == set(one["grads"])
        for k, g in got.items():
            assert _rel(one["grads"][k], g) <= PORT_TOL, k
        for k, v in _flat(r["stepped"]).items():
            assert _rel(one["params"][k], v) <= PORT_TOL, k
        assert r["frozen_kept"]


def test_lowered_threshold_reaches_the_three_traps(run):
    """At the lowered threshold the layout holds a 2-D stacked leaf cut on
    its depth axis, LoRA factors cut on their rank dim (fc1's lora_B,
    fc2's lora_A), and the deformable offsets kernel, a TP partial-grad
    leaf, cut too; the step above matched through all of them."""
    layout = _results(run, "low_fsdp2_tp2")[0]["layout"]
    depth_cut = [p for p, (shape, d) in layout.items()
                 if p[1] == "blocks" and len(shape) == 2 and d == -2]
    assert ("backbone", "blocks", "fc1", "bias") in depth_cut
    assert layout[("backbone", "blocks", "fc1", "lora_B")][1] == -2
    assert layout[("backbone", "blocks", "fc2", "lora_A")][1] == -1
    offsets = ("decoder", "layers", "deform", "offsets_kernel")
    assert psh.partial_grad(offsets) and offsets in layout


def test_fsdp_checkpoint_restores_and_cuts_again_bit_equal(run):
    """An FSDP 2 x TP 2 state with an EMA after one step, saved (rank 0
    writes the logical tree), restored and cut again on every rank: the
    params, both moments and the EMA shards come back bit for bit, and
    the step and Adam's count with them."""
    for r in _results(run, "low_fsdp2_tp2"):
        ck = r["ckpt"]
        assert ck["same"] == {"params": True, "mu": True, "nu": True,
                              "ema": True}
        assert ck["step"] == 1 and ck["count"] == 1


def test_fsdp_checkpoint_holds_one_process_tree(run):
    """The file holds the logical tree: every leaf of the params, the
    moments and the EMA at its whole shape, within PORT_TOL of one
    process's state after the same step (frozen leaves equal)."""
    path = _results(run, "low_fsdp2_tp2")[0]["ckpt"]["path"]
    saved = torch.load(os.path.join(path, STATE_FILE), weights_only=True)
    one = run["ref"]["ema"]
    for key, mine, ref in (
            ("params", saved["params"], one.params),
            ("mu", saved["opt_state"]["mu"], one.opt_state.mu),
            ("nu", saved["opt_state"]["nu"], one.opt_state.nu),
            ("ema", saved["ema"], one.ema)):
        got, want = flatten_tree(mine), flatten_tree(ref)
        assert set(got) == set(want), key
        for k in want:
            assert got[k].shape == want[k].shape, (key, k)
            assert _rel(want[k], got[k]) <= PORT_TOL, (key, k)
    assert saved["step"] == 1 and saved["opt_state"]["count"] == 1


@pytest.mark.parametrize("name", list(GUARDS))
def test_a_nan_in_one_shard_skips_the_step_on_every_rank(run, name):
    """A NaN in one element of one rank's gradient shard (after the
    gradient sums): every rank reports the skip and keeps its params,
    moments and EMA, so the ranks stay one model. Under TP without FSDP
    the faulty rank alone skipped before the guard's flag was the
    mesh's."""
    fields, low, leaf = GUARDS[name]
    results = _results(run, f"guard_{name}")
    if low is not None:
        assert leaf in results[0]["layout"]
    for r in results:
        assert r["skip"] == 1.0
        assert r["kept"] == {"params": True, "mu": True, "nu": True,
                             "ema": True}


def test_int8_eval_under_fsdp_matches_one_process(run):
    """The eval forward of the float tree and of its int8 tree (quantized
    whole, then cut; kernel_q and w_scale gathered K-major on use) under
    FSDP 4 against the port's one process on each data rank's rows."""
    one = run["ref"]["tiny"]
    results = _results(run, "int8")
    layout = results[0]["layout"]
    assert ("backbone", "blocks", "fc2", "kernel_q") in layout
    assert ("backbone", "blocks", "q", "w_scale") in layout
    for r in results:
        rows = r["float"]["pred_logits"].shape[0]
        mine = slice(r["data_index"] * rows, (r["data_index"] + 1) * rows)
        for tree, ref in (("float", one["forward"]), ("int8", one["int8"])):
            for key in ("pred_logits", "pred_boxes"):
                assert _rel(ref[key][mine], r[tree][key]) <= PORT_TOL, \
                    (tree, key)


def test_cli_fsdp_tp_epochs_match_one_process(run):
    """`--fsdp --model_parallel 2` through the CLI on the 4 ranks (data 2
    x model 2, the threshold lowered): the per-step losses, the
    validation metrics and detections and the final params against one
    process's run of the same flags without the mesh; rank 0 alone wrote
    files; each rank logged its mesh with "fsdp"."""
    out, one = run["out"]["cli"], run["out"]["cli_one"]
    for r in _results(run, "cli"):
        assert r["rc"] == 0
    got, want = epoch_losses(out), epoch_losses(one)
    assert len(got) == len(want) == 8
    assert max(abs(g - w) / abs(w) for g, w in zip(got, want)) <= CLI_TOL
    for e in range(2):
        name = f"metrics_epoch_{e}.json"
        m, w = read_json(out, name), read_json(one, name)
        for key in ("AP", "AP50", "AP75"):
            assert abs(m[key] - w[key]) <= CLI_TOL, (e, key)
    a = detections(out, "predictions_epoch_1.json")
    b = detections(one, "predictions_epoch_1.json")
    assert len(a) == len(b) and all(
        x[:2] == y[:2] and np.allclose(x[2:], y[2:], rtol=0, atol=1e-3)
        for x, y in zip(a, b))
    fa, fb = final_params(out), final_params(one)
    init = flatten_tree(torch.load(os.path.join(run["init"], STATE_FILE),
                                   weights_only=True)["params"])
    assert set(fa) == set(fb) == set(init)
    for k in fb:
        moved = fb[k] - init[k]
        if not moved.any():
            assert torch.equal(fa[k], fb[k]), k  # frozen
        elif not k.endswith("self_attn/k/bias"):
            # Eight Adam steps carry the gradients' rounding on; the
            # decoder's key bias has a zero gradient in exact arithmetic
            # (softmax ignores a shift of every key), so Adam moves it by
            # rounding noise alone and it is not compared.
            err = float((fa[k] - fb[k]).abs().max())
            assert err <= CLI_UPDATE_TOL * float(moved.abs().max()), k
    def files(d):
        return sorted("train.log" if n.endswith("_train.log") else n
                      for n in os.listdir(d))

    assert files(out) == files(one)
    for r in range(WORLD):
        log = (run["rank_logs"] / f"rank{r}.log").read_text()
        if r == 0:
            name = next(n for n in os.listdir(out) if n.endswith("train.log"))
            with open(os.path.join(out, name)) as f:
                log = f.read()
        assert "mesh: data 2 x context 1 x model 2, fsdp" in log, r


def test_cli_only_evaluate_int8_under_fsdp_matches_one_process(run):
    """`--only_evaluate --quantize int8 --fsdp --model_parallel 2` from the
    mesh run's final model (quantized whole, then cut) against one
    process's int8 evaluation of the one-process run's final model."""
    for r in _results(run, "cli_int8"):
        assert r["rc"] == 0
    out, one = run["out"]["int8"], run["out"]["int8_one"]
    names = [n for n in os.listdir(one) if n.startswith("metrics_epoch")]
    assert len(names) == 1
    m, w = read_json(out, names[0]), read_json(one, names[0])
    assert abs(m["AP"] - w["AP"]) <= 0.01
    with open(os.path.join(out, names[0].replace("metrics",
                                                 "predictions"))) as f:
        assert len(json.load(f)) > 0
