"""The MoE backbone FFN under a mesh (expert parallelism over the model
axis, DP, FSDP and the ring) through the train step, evaluation, int8,
checkpoints and the training CLI (dinov2_od_tpu_torch/ops/moe.py,
parallel/, models/, train/) against the JAX package and the port's one
process, on the CPU.

The port's ranks are processes of a gloo group (tests/torch_moe_worker.py,
which imports no JAX), one world of 4 started once for the module, at
tests/test_moe.py's `_moe_backbone_cfg` widths (3 ViT blocks of width 48
with 4 heads, the last 2 MoE with 4 experts, top-2, capacity factor 1.25:
11 slots an expert for 17 tokens, so tokens are dropped; a 1-layer
deformable decoder of width 32) in fp32, dropout 0, global batch 4. Its
jobs, in order:

- one train step under DP 2 x EP 2 (2 experts a rank), at the default
  aux weight and at 1.0, against JAX's step and gradients on its 2 x 2
  mesh and against the port's one process; the same with the aux's path
  counted once a model rank (a control that must fail);
- one step under DP 4, FSDP 4 and FSDP 2 x EP 2 (the threshold lowered
  in both packages to MIN_ELEMS, so the router and the experts are cut;
  the latter against JAX's FSDP step too, and under remat), the legacy
  ring over the model axis (DP 2 x ring 2) and DP 1 x CP 2 x EP 2: a
  ring of 2 pads the 17 tokens to 18, and the pad row claims no slot;
- the non-finite guard with a NaN in one rank's expert shard;
- checkpoints written under EP and FSDP x EP, restored and cut again;
- the eval forward of the int8 tree (its experts in float) under EP;
- the training CLI with `--ffn_type moe --model_parallel 2` for two
  epochs, then `--only_evaluate --quantize int8` on the same mesh, each
  against one process's run.
"""

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from dinov2_od_tpu import config as jcfg
from dinov2_od_tpu.models.detector import detector_apply as jax_apply
from dinov2_od_tpu.models.detector import init_detector_params as jax_init
from dinov2_od_tpu.models.detector import trainable_mask as jax_trainable_mask
from dinov2_od_tpu.ops.losses import set_criterion as jax_criterion
from dinov2_od_tpu.parallel import create_mesh as jax_create_mesh
from dinov2_od_tpu.parallel import sharding as jsh
from dinov2_od_tpu.train import state as jstate
from dinov2_od_tpu.train.step import _cp_kwargs as jax_cp_kwargs
from dinov2_od_tpu.train.step import make_train_step as jax_make_train_step

from dinov2_od_tpu_torch.data.synthetic import (NUM_SYNTHETIC_CLASSES,
                                                make_batch,
                                                write_coco_dataset)
from dinov2_od_tpu_torch.models.detector import fold_detector_lora
from dinov2_od_tpu_torch.models.quantize import quantize_detector_int8
from dinov2_od_tpu_torch.params import params_from_numpy, params_to_numpy
from dinov2_od_tpu_torch.train import state as pstate
from dinov2_od_tpu_torch.train.checkpoint import STATE_FILE, flatten_tree
from dinov2_od_tpu_torch.train.step import (make_eval_step,
                                            make_eval_topk_step,
                                            make_train_step, train_grads)

import torch_cp_worker as cp
import torch_moe_worker as worker
from torch_mesh_cli_worker import (cli_args, detections, epoch_losses,
                                   eval_args, final_params, init_checkpoint,
                                   read_json, tiny_cli)

# tests/test_moe.py's `_moe_backbone_cfg` and its EP tests' decoder.
BACKBONE = dict(variant="small", image_size=56, patch_size=14, lora_r=1,
                target_dim=32, hidden_dim_override=48, depth_override=3,
                num_heads_override=4, mlp_ratio_override=2.0,
                ffn_type_override="moe", moe_num_experts=4, moe_top_k=2,
                lora_last_n_blocks=2)
DECODER = dict(hidden_dim=32, num_queries=8, num_layers=1, num_heads=4,
               dim_feedforward=64, num_classes=NUM_SYNTHETIC_CLASSES,
               dropout=0.0)
AUX1 = dict(BACKBONE, moe_aux_weight=1.0)
BATCH, MAX_BOXES, LR = 4, 6, 3e-4
WORLD = 4
MIN_ELEMS = 64  # the lowered threshold: the router and the experts cut
EP = dict(model_parallel_size=2)
FSDP_EP = dict(fsdp=True, model_parallel_size=2)
# name: (MeshConfig fields, the lowered threshold or None, backbone)
STEPS = {"dp2_ep2": (EP, None, BACKBONE),
         "dp2_ep2_aux1": (EP, None, AUX1),
         "dp4": ({}, None, BACKBONE),
         "fsdp4": (dict(fsdp=True), MIN_ELEMS, BACKBONE),
         "fsdp2_ep2": (FSDP_EP, MIN_ELEMS, BACKBONE),
         "fsdp2_ep2_remat": (FSDP_EP, MIN_ELEMS, BACKBONE),
         "ring_legacy": (dict(context_parallel=True, model_parallel_size=2),
                         None, BACKBONE),
         "cp2_ep2": (dict(context_parallel_size=2, model_parallel_size=2),
                     None, BACKBONE)}
# TrainConfig fields of a step: under remat the MoE blocks' cut leaves
# are gathered inside the checkpointed function, and again in the
# backward.
TRAIN = {"fsdp2_ep2_remat": {"use_remat": True}}
# The steps JAX runs too, on its 4-device mesh of the same shape.
JAX_STEPS = ("dp2_ep2", "dp2_ep2_aux1", "fsdp2_ep2")
# name: (MeshConfig fields, the lowered threshold or None)
GUARDS = {"ep2": (EP, None), "fsdp2_ep2": (FSDP_EP, MIN_ELEMS)}
POISON = ("backbone", "moe_blocks", "moe", "fc1_kernel")
POISON_RANK = 1
CHECKPOINTS = ("dp2_ep2", "fsdp2_ep2")
# Against JAX on the same mesh: tests/test_moe.py's EP limits (logits
# 2e-4, aux 1e-5, absolute), the loss rtol 2e-4 (tests/test_fsdp.py),
# the masked gradients 1e-4 relative to max(1, JAX's magnitude)
# (tests/test_torch_moe.py's GRAD_TOL) and the params after Adam's first
# step 2e-7 absolute where the gradient is clearly above noise (over 1e-2
# of its leaf's largest and over 1e-6; tests/test_torch_moe.py's
# PARAM_TOL: Adam moves an element by about lr whatever its gradient, so
# a gradient at rounding noise may move it either way).
JAX_LOGITS_TOL, JAX_AUX_TOL, JAX_LOSS_RTOL = 2e-4, 1e-5, 2e-4
JAX_GRAD_TOL, PARAM_TOL = 1e-4, 2e-7
# Against the port's one process, relative to max(1, its magnitude): the
# loss terms, the norm, every trainable gradient and the eval outputs
# (the same math, the sums split over the ranks); top-k boxes TOPK_TOL
# (pixels). Params as against JAX.
PORT_TOL = 1e-5
TOPK_TOL = 1e-3
# The CLI against one process (tests/test_torch_mesh_fsdp.py's limits).
CLI_TOL = 1e-5
CLI_UPDATE_TOL = 1e-2
SPEC = {"backbone": dict(BACKBONE, target_dim=64),
        "decoder": dict(hidden_dim=64, num_queries=8, num_layers=2,
                        num_heads=4, dim_feedforward=96, num_classes=6,
                        dropout=0.0),
        "max_boxes": 6}
CLI_FLAGS = ["--ffn_type", "moe", "--model_parallel", "2"]
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


def _jdet(backbone):
    return jcfg.DetectorConfig(backbone=jcfg.BackboneConfig(**backbone),
                               decoder=jcfg.DecoderConfig(**DECODER))


def _tree():
    """JAX's init, every lora_B drawn nonzero in the MoE blocks (the
    adapted ones; the dense prefix's stay zero, as the masked updates
    keep them)."""
    t = _plain(jax_init(jax.random.key(0), _jdet(BACKBONE)))
    rng = np.random.default_rng(0)
    for lin in t["backbone"]["moe_blocks"].values():
        if isinstance(lin, dict) and "lora_B" in lin:
            lin["lora_B"] = rng.normal(0, 0.05, lin["lora_B"].shape).astype(
                np.float32)
    return t


def _jtrain(backbone, mesh=None):
    return jcfg.TrainConfig(
        detector=_jdet(backbone),
        data=jcfg.DataConfig(batch_size=BATCH, max_boxes=MAX_BOXES),
        optim=jcfg.OptimConfig(learning_rate=LR),
        mesh=jcfg.MeshConfig(**(mesh or {})))


def _jax_placed(name, tree, batch, monkeypatch):
    """JAX's config, 4-device mesh, params (placed by its `shard_params`,
    the threshold lowered while it runs where the step asks) and batch
    for a step of STEPS."""
    fields, low, backbone = STEPS[name]
    jc = _jtrain(backbone, fields)
    mesh = jax_create_mesh(jc.mesh.model_parallel_size,
                           devices=jax.devices()[:WORLD], cfg=jc.mesh)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    with monkeypatch.context() as m:
        if low is not None:
            m.setattr(jsh, "_FSDP_MIN_ELEMS", low)
        params = jsh.shard_params(params, mesh, cfg=jc.mesh)
    bsh = NamedSharding(mesh, P(jc.mesh.data_axis))
    jb = {k: jax.device_put(jnp.asarray(v), bsh) for k, v in batch.items()}
    return jc, mesh, params, jb


def _jax_run(jc, mesh, params, jb):
    """JAX on its mesh: the forward, the masked gradients of the step's
    loss (the criterion plus moe_aux_weight times the aux) and one step
    (its metrics and params), as flat numpy."""
    det = jc.detector
    kw = jax_cp_kwargs(jc, mesh)

    def loss(p):
        p = jstate.stop_gradient_frozen(p, det)
        out = jax_apply(p, det, jb["images"], deterministic=True, **kw)
        terms = jax_criterion(
            out["pred_logits"], out["pred_boxes"], jb["labels"], jb["boxes"],
            jb["valid"], matcher_cfg=jc.matcher, loss_cfg=jc.loss,
            num_classes=det.decoder.num_classes)
        total = terms["loss"] + det.backbone.moe_aux_weight * out["moe_aux"]
        return total, out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    grads = jstate.mask_gradients(grads, params, det)
    tx = jstate.make_optimizer(jc.optim, det, params)
    state = jstate.create_train_state(params, jc.optim, det)
    state, metrics = jax_make_train_step(jc, tx, mesh=mesh)(
        state, jb, jax.random.key(1))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return {"forward": {k: np.asarray(out[k])
                        for k in ("pred_logits", "moe_aux")},
            "grads": _flat(to_np(grads)), "metrics": to_np(metrics),
            "params": _flat(to_np(state.params))}


def _port_cfg(backbone, **optim):
    cfg = cp.train_config(backbone, DECODER, {}, BATCH, MAX_BOXES, LR)
    return dataclasses.replace(
        cfg, optim=dataclasses.replace(cfg.optim, **optim))


def _one_process(backbone, tree, batch, int8_tree=None):
    """The port's one process: the eval forward and top-k, the loss terms
    and gradients, one step, and with `int8_tree` the int8 forward."""
    cfg = _port_cfg(backbone)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    params = params_from_numpy(tree, device="cpu")
    out = {"forward": make_eval_step(cfg)(params, tb["images"])}
    sizes = torch.full((BATCH, 2), 56.0)
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


def _one_process_ema_step(tree, batch):
    """The port's one process after one step with an EMA (the checkpoint
    jobs')."""
    cfg = _port_cfg(BACKBONE, ema_decay=0.5)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    state = pstate.create_train_state(params_from_numpy(tree, device="cpu"),
                                      cfg.optim, cfg.detector)
    state, _ = make_train_step(cfg)(state, tb)
    return state


def _int8_tree(tree):
    cfg = _port_cfg(BACKBONE)
    return params_to_numpy(quantize_detector_int8(fold_detector_lora(
        params_from_numpy(tree, device="cpu"), cfg.detector)))


def _flat_paths(tree):
    """{path tuple: leaf} of a JAX tree, paths as the port names them."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {tuple(str(getattr(k, "key", getattr(k, "name", ""))) for k in p):
            v for p, v in leaves}


def _jax_counts(jc, params):
    """JAX's param and trainable (Adam-moment) elements a device."""
    mask = _flat_paths(jax_trainable_mask(params, jc.detector))
    counts = {"params": 0, "moments": 0}
    for path, a in _flat_paths(params).items():
        n = int(np.prod(a.sharding.shard_shape(a.shape)))
        counts["params"] += n
        counts["moments"] += n if mask[path] else 0
    return counts


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the ranks and the in-process runs share the
    suite's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_moe")
    tree = _tree()
    batch = make_batch(np.random.default_rng(0), BATCH, image_size=56,
                       max_boxes=MAX_BOXES)
    int8 = _int8_tree(tree)
    data = write_coco_dataset(str(tmp / "data"), num_images=8,
                              image_size=56, seed=7, max_objects=2)
    init = init_checkpoint(str(tmp), SPEC)
    out = {k: str(tmp / k) for k in ("cli", "cli_one", "int8", "int8_one")}
    common = dict(tree=tree, batch=batch, decoder=DECODER)
    jobs = []
    for name, (fields, low, backbone) in STEPS.items():
        job = dict(kind="step", name=name, mesh=fields, backbone=backbone,
                   train=TRAIN.get(name, {}), **common)
        if low is not None:
            job["min_elems"] = low
        if name in CHECKPOINTS:
            job["ckpt"] = str(tmp / f"ckpt_{name}")
        jobs.append(job)
    jobs.append(dict(kind="control", name="control", mesh=EP, backbone=AUX1,
                     **common))
    for name, (fields, low) in GUARDS.items():
        jobs.append(dict(kind="guard", name=f"guard_{name}", mesh=fields,
                         backbone=BACKBONE, poison=POISON,
                         poison_rank=POISON_RANK, **common,
                         **({} if low is None else {"min_elems": low})))
    jobs.append(dict(kind="int8", name="int8", mesh=EP, float=tree,
                     int8=int8, images=batch["images"], backbone=BACKBONE,
                     decoder=DECODER))
    final = os.path.join(out["cli"], "final_model")
    jobs.append(dict(kind="cli", name="cli", mesh={}, spec=SPEC,
                     args=cli_args(data, init, out["cli"], *CLI_FLAGS)))
    jobs.append(dict(kind="cli", name="cli_int8", mesh={}, spec=SPEC,
                     args=eval_args(data, final, out["int8"], *INT8,
                                    *CLI_FLAGS)))
    ranks = worker.start(jobs, WORLD, tmp / "ranks")
    try:
        # JAX's references compiled side by side in threads (XLA's
        # compiles leave the GIL), the port's one process meanwhile.
        mp = pytest.MonkeyPatch()
        placed = {name: _jax_placed(name, tree, batch, mp)
                  for name in JAX_STEPS}
        with ThreadPoolExecutor(len(placed)) as pool:
            jax_runs = {k: pool.submit(_jax_run, *v)
                        for k, v in placed.items()}
            ref = {"one": _one_process(BACKBONE, tree, batch, int8),
                   "aux1": _one_process(AUX1, tree, batch),
                   "ema": _one_process_ema_step(tree, batch)}
            with tiny_cli(SPEC) as cli:
                one_flags = CLI_FLAGS[:2]
                assert cli.main(cli_args(data, init, out["cli_one"],
                                         *one_flags)) == 0
                assert cli.main(eval_args(
                    data, os.path.join(out["cli_one"], "final_model"),
                    out["int8_one"], *INT8, *one_flags)) == 0
            ref["jax"] = {k: f.result() for k, f in jax_runs.items()}
        results = worker.results(ranks)
    finally:
        ranks.kill()
    return {"ref": ref, "results": results, "tree": tree, "out": out,
            "rank_logs": tmp / "ranks", "init": init,
            "jax_counts": {name: _jax_counts(v[0], v[2])
                           for name, v in placed.items()}}


def _results(run, name):
    return [r[name] for r in run["results"]]


def _one(run, name):
    return run["ref"]["aux1" if STEPS[name][2] is AUX1 else "one"]


def _clear(g):
    """The elements whose gradient is clearly above noise."""
    g = np.abs(_np(g))
    return (g > 1e-2 * g.max()) & (g > 1e-6)


def _rows(r, full, out="forward"):
    """The rows of a whole-batch `full` that rank r's output holds."""
    n = r[out]["pred_logits"].shape[0]
    return full[r["data_index"] * n:(r["data_index"] + 1) * n]


@pytest.mark.parametrize("name", JAX_STEPS)
def test_moe_step_matches_jax_on_the_same_mesh(run, name):
    """Against JAX on its mesh of the same shape: each rank's eval logits
    (its data rows), loss_moe_aux, the loss, the masked gradients of the
    router, the experts and every LoRA factor (all trainable leaves),
    and the params after one step."""
    ref = run["ref"]["jax"][name]
    for r in _results(run, name):
        mine = _rows(r, ref["forward"]["pred_logits"])
        assert np.abs(_np(r["forward"]["pred_logits"]) - mine).max() \
            <= JAX_LOGITS_TOL
        assert abs(float(r["losses"]["loss_moe_aux"])
                   - float(ref["metrics"]["loss_moe_aux"])) <= JAX_AUX_TOL
        assert abs(float(r["losses"]["loss_moe_aux"])
                   - float(ref["forward"]["moe_aux"])) <= JAX_AUX_TOL
        np.testing.assert_allclose(float(r["losses"]["loss"]),
                                   float(ref["metrics"]["loss"]),
                                   rtol=JAX_LOSS_RTOL)
        got = _flat(r["grads"])
        assert {k for k in got if ".moe." in k} == {
            f"backbone.moe_blocks.moe.{n}" for n in (
                "router_kernel", "fc1_kernel", "fc1_bias", "fc2_kernel",
                "fc2_bias")}
        for k, g in got.items():
            assert _rel(ref["grads"][k], g) <= JAX_GRAD_TOL, k
        for k, v in _flat(r["stepped"]).items():
            clear = _clear(ref["grads"][k])
            err = np.abs(_np(v) - ref["params"][k])[clear]
            assert err.max(initial=0.0) <= PARAM_TOL, k


@pytest.mark.parametrize("name", list(STEPS))
def test_moe_step_matches_one_process(run, name):
    """Against the port's one process on the whole batch: the eval
    forward and top-k on each rank's data rows, the loss terms (the
    global batch's, loss_moe_aux among them), the norm, every trainable
    gradient and the params after one step; frozen shards keep their
    values."""
    one = _one(run, name)
    for r in _results(run, name):
        for key in ("pred_logits", "pred_boxes"):
            assert _rel(_rows(r, one["forward"][key]),
                        r["forward"][key]) <= PORT_TOL, key
        topk = _rows(r, one["topk"])
        assert torch.allclose(r["topk"][..., :2], topk[..., :2], rtol=0,
                              atol=PORT_TOL)
        assert torch.allclose(r["topk"], topk, rtol=0, atol=TOPK_TOL)
        for key in ("loss", "loss_ce", "loss_bbox", "loss_giou",
                    "loss_moe_aux"):
            assert _rel(one["losses"][key], r["losses"][key]) <= PORT_TOL
        for key in ("loss", "loss_moe_aux", "grad_norm"):
            assert _rel(one["metrics"][key], r["metrics"][key]) <= PORT_TOL
        got = _flat(r["grads"])
        assert set(got) == set(one["grads"])
        for k, g in got.items():
            assert _rel(one["grads"][k], g) <= PORT_TOL, k
        for k, v in _flat(r["stepped"]).items():
            clear = _clear(one["grads"][k])
            err = np.abs(_np(v) - one["params"][k])[clear]
            assert err.max(initial=0.0) <= PARAM_TOL, k
        assert r["frozen_kept"]


@pytest.mark.parametrize("name", JAX_STEPS)
def test_each_rank_holds_jaxs_share_of_the_params(run, name):
    """Every rank holds as many param and Adam-moment elements as each of
    JAX's devices on the same mesh: E / M experts a rank under EP, and
    under FSDP their data cut too."""
    for r in _results(run, name):
        assert r["elements"] == run["jax_counts"][name]
    layout = _results(run, name)[0]["layout"]
    if STEPS[name][0].get("fsdp"):
        moe = {p[-1] for p in layout if p[:3] == ("backbone", "moe_blocks",
                                                  "moe")}
        assert moe == {"router_kernel", "fc1_kernel", "fc1_bias",
                       "fc2_kernel", "fc2_bias"}


def test_aux_counted_once_a_model_rank_fails(run):
    """At moe_aux_weight 1.0 the router gradient under DP 2 x EP 2 is one
    process's (PORT_TOL); with the aux term's path counted once on every
    model rank (the identity for `aux_once_over_model`), the model
    group's sum counts it twice and the router gradient parts from one
    process's by far more than that limit, while the loss terms stay
    equal (the fault is in the gradient alone)."""
    one = run["ref"]["aux1"]
    key = "backbone.moe_blocks.moe.router_kernel"
    for good, bad in zip(_results(run, "dp2_ep2_aux1"),
                         _results(run, "control")):
        assert _rel(one["grads"][key], _flat(good["grads"])[key]) <= PORT_TOL
        assert _rel(one["grads"][key], _flat(bad["grads"])[key]) \
            > 100 * PORT_TOL
        assert _rel(one["losses"]["loss"], bad["losses"]["loss"]) <= PORT_TOL


@pytest.mark.parametrize("name", list(GUARDS))
def test_a_nan_in_one_expert_shard_skips_the_step_on_every_rank(run, name):
    """A NaN in one element of rank 1's shard of the experts' fc1 gradient
    (its model index's experts): every rank reports the skip and keeps
    its params, moments and EMA."""
    for r in _results(run, f"guard_{name}"):
        assert r["skip"] == 1.0
        assert r["kept"] == {"params": True, "mu": True, "nu": True,
                             "ema": True}


@pytest.mark.parametrize("name", CHECKPOINTS)
def test_moe_checkpoint_restores_and_cuts_again_bit_equal(run, name):
    """A state with an EMA after one step under EP (and FSDP x EP), saved
    (rank 0 writes the logical tree), restored and cut again on every
    rank: the params, both moments and the EMA shards come back bit for
    bit, and the file holds the logical tree: every leaf at its whole
    shape, within PORT_TOL of one process's state after the same step
    (the params and the EMA where the gradient is clearly above noise, as
    the step's params are held)."""
    for r in _results(run, name):
        ck = r["ckpt"]
        assert ck["same"] == {"params": True, "mu": True, "nu": True,
                              "ema": True}
        assert ck["step"] == 1 and ck["count"] == 1
    path = _results(run, name)[0]["ckpt"]["path"]
    saved = torch.load(os.path.join(path, STATE_FILE), weights_only=True)
    one, grads = run["ref"]["ema"], run["ref"]["one"]["grads"]
    for key, mine, ref in (
            ("params", saved["params"], one.params),
            ("mu", saved["opt_state"]["mu"], one.opt_state.mu),
            ("nu", saved["opt_state"]["nu"], one.opt_state.nu),
            ("ema", saved["ema"], one.ema)):
        got, want = flatten_tree(mine), flatten_tree(ref)
        assert set(got) == set(want), key
        for k in want:
            assert got[k].shape == want[k].shape, (key, k)
            g = grads.get(k.replace("/", "."))
            if key in ("params", "ema") and g is not None:
                clear = _clear(g)
                err = np.abs(_np(got[k]) - _np(want[k]))[clear]
                assert err.max(initial=0.0) <= PARAM_TOL, (key, k)
            else:
                assert _rel(want[k], got[k]) <= PORT_TOL, (key, k)


def test_int8_eval_under_ep_matches_one_process(run):
    """The eval forward of the float tree and of its int8 tree (q, k, v
    and proj int8, the experts in float, cut by the same rules) under DP
    2 x EP 2 against the port's one process on each data rank's rows."""
    one = run["ref"]["one"]
    for r in _results(run, "int8"):
        for tree, ref in (("float", one["forward"]), ("int8", one["int8"])):
            for key in ("pred_logits", "pred_boxes"):
                assert _rel(_rows(r, ref[key], tree), r[tree][key]) \
                    <= PORT_TOL, (tree, key)
    assert _rel(one["forward"]["pred_logits"], one["int8"]["pred_logits"]) \
        > PORT_TOL


def test_cli_moe_ep_epochs_match_one_process(run):
    """`--ffn_type moe --model_parallel 2` through the CLI on the 4 ranks
    (data 2 x model 2): the per-step losses and loss_moe_aux, the
    validation metrics and detections and the final params against one
    process's run of the same flags without the mesh; rank 0 alone wrote
    files; each rank logged its mesh."""
    out, one = run["out"]["cli"], run["out"]["cli_one"]
    for r in _results(run, "cli"):
        assert r["rc"] == 0
    got, want = epoch_losses(out), epoch_losses(one)
    assert len(got) == len(want) == 8
    assert max(abs(g - w) / abs(w) for g, w in zip(got, want)) <= CLI_TOL
    for e in range(2):
        a = read_json(out, f"train_epoch_{e}.json")["loss_moe_aux"]
        b = read_json(one, f"train_epoch_{e}.json")["loss_moe_aux"]
        assert len(a) == len(b) == 4
        assert max(abs(x - y) / abs(y) for x, y in zip(a, b)) <= CLI_TOL
        m = read_json(out, f"metrics_epoch_{e}.json")
        w = read_json(one, f"metrics_epoch_{e}.json")
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
            # The decoder's key bias has a zero gradient in exact
            # arithmetic (softmax ignores a shift of every key): Adam
            # moves it by rounding noise alone.
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
        assert "mesh: data 2 x context 1 x model 2" in log, r


def test_cli_only_evaluate_int8_under_ep_matches_one_process(run):
    """`--only_evaluate --quantize int8 --ffn_type moe --model_parallel 2`
    from the mesh run's final model against one process's int8
    evaluation of the one-process run's final model."""
    for r in _results(run, "cli_int8"):
        assert r["rc"] == 0
    out, one = run["out"]["int8"], run["out"]["int8_one"]
    names = [n for n in os.listdir(one) if n.startswith("metrics_epoch")]
    assert len(names) == 1
    m, w = read_json(out, names[0]), read_json(one, names[0])
    assert abs(m["AP"] - w["AP"]) <= 0.01
    a = detections(out, names[0].replace("metrics", "predictions"))
    b = detections(one, names[0].replace("metrics", "predictions"))
    assert len(a) == len(b) > 0
