"""Pipeline parallelism through the detector and the train step
(dinov2_od_tpu_torch/parallel/pipeline.py, models/vit.py, train/step.py)
against the JAX package, on the CPU.

The port's ranks are processes of a gloo group (tests/torch_pp_worker.py,
which imports no JAX), one world of 4 started once for the module:

- the detector's eval forward and top-k under legacy PP 4 (the model
  axis the stages), GPipe and 4 stages x 3 chunks, at ViT-S (depth 12,
  width 384, 6 heads) and 56 px, batch 8 in 4 microbatches, against
  JAX's `detector_apply(..., pipe_axis="model")` on its data 2 x model 4
  CPU mesh and the port's one process;
- one train step under legacy DP 2 x PP 2 (GPipe, 2 microbatches a data
  rank) and under PP 2 x TP 2 on the ('data', 'stage', 'model') mesh
  (2 chunks a stage, 2 microbatches), at a tiny fp32 config (4 ViT
  blocks of width 128 with 2 heads, 1 a rank under TP; LoRA on the last
  2, lora_B nonzero; a 2-layer deformable decoder of width 64, dropout
  0): the loss terms, every trainable gradient and the global norm
  against the port's one process and JAX's single-device step, and the
  updated params against the port's one process and JAX's own step on
  the same mesh (built as tests/test_pp_tp.py builds it).

Under the interleaved layout the adapted block 2 sits on stage 0 (global
chunk 2 = lap 1 of stage 0) and block 3 on stage 1: the LoRA row masks
hold there on every rank. The pipeline's refusals (the int8 prefix, MoE,
FSDP, shapes that do not divide) are JAX's, with its messages.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from dinov2_od_tpu import config as jcfg
from dinov2_od_tpu.models.detector import (
    detector_apply as jax_detector_apply,
    init_detector_params as jax_init,
    trainable_mask as jax_trainable_mask,
)
from dinov2_od_tpu.ops.losses import set_criterion as jax_set_criterion
from dinov2_od_tpu.parallel import create_mesh as jax_create_mesh
from dinov2_od_tpu.parallel import shard_params as jax_shard_params
from dinov2_od_tpu.parallel.sharding import param_shardings
from dinov2_od_tpu.train import state as jstate
from dinov2_od_tpu.train.step import (
    make_train_step as jax_make_train_step,
    prep_images as jax_prep_images,
)

from dinov2_od_tpu_torch import config as pcfg
from dinov2_od_tpu_torch.data.synthetic import NUM_SYNTHETIC_CLASSES, make_batch
from dinov2_od_tpu_torch.models.detector import (
    detector_apply,
    init_detector_params,
)
from dinov2_od_tpu_torch.params import params_from_numpy, params_to_numpy
from dinov2_od_tpu_torch.parallel import sharding as psh
from dinov2_od_tpu_torch.train import state as pstate
from dinov2_od_tpu_torch.train.step import (
    check_pipeline,
    make_eval_step,
    make_eval_topk_step,
    make_train_step,
    train_grads,
)

import torch_cp_worker as cp
import torch_pp_worker as worker

VITS = dict(variant="small", image_size=56, lora_r=2, lora_last_n_blocks=2,
            target_dim=64)
TINY = dict(variant="small", image_size=56, hidden_dim_override=128,
            num_heads_override=2, depth_override=4, lora_r=2,
            lora_last_n_blocks=2, target_dim=64)
DECODER = dict(hidden_dim=64, num_queries=8, num_layers=2, num_heads=4,
               dim_feedforward=96, num_classes=NUM_SYNTHETIC_CLASSES,
               dropout=0.0)
FWD_BATCH, BATCH, MAX_BOXES, LR = 8, 4, 6, 3e-4
WORLD = 4
# name: the port's MeshConfig fields (world 4)
FWD_MESHES = {
    "gpipe4": dict(model_parallel_size=4, pipeline_parallel=True,
                   pipeline_microbatches=4),
    "interleaved4x3": dict(model_parallel_size=4, pipeline_parallel=True,
                           pipeline_microbatches=4, pipeline_chunks=3),
}
TRAIN_MESHES = {
    "dp2pp2": dict(model_parallel_size=2, pipeline_parallel=True,
                   pipeline_microbatches=2),
    "pp2tp2": dict(model_parallel_size=2, pipeline_parallel_size=2,
                   pipeline_chunks=2, pipeline_microbatches=2),
}
# tests/test_torch_context_parallel.py's fp32 tolerances (each relative to
# max(1, the reference's magnitude)): outputs 1e-4 max abs against JAX;
# losses and norms 1e-5; gradients 1e-4 of each leaf's largest; updated
# params 2e-7 where what Adam's first step sees is clearly above noise
# (over 1e-2 of its leaf's largest and over 1e-6). Against the port's one
# process 1e-5: the same math on microbatches, its sums split over the
# stages and the model group.
MODEL_TOL = 1e-4
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
PARAM_TOL = 2e-7
GRAD_FLOOR = 1e-2
GRAD_ABS_FLOOR = 1e-6
WEIGHT_DECAY = 1e-4  # OptimConfig's default
PORT_TOL = 1e-5
TOPK_TOL = 1e-3


def _plain(tree):
    """A JAX tree as nested dicts of numpy arrays, picklable without
    JAX."""
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


def _jax_loss_and_grads(jc, tree, batch):
    """JAX's single-device loss terms and masked gradients."""
    det = jc.detector
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    images = jax_prep_images(jb["images"], jc.data.normalize)

    def loss_fn(params):
        params = jstate.stop_gradient_frozen(params, det)
        out = jax_detector_apply(params, det, images, rng=jax.random.key(1),
                                 deterministic=False)
        losses = jax_set_criterion(
            out["pred_logits"], out["pred_boxes"], jb["labels"],
            jb["boxes"], jb["valid"], matcher_cfg=jc.matcher,
            loss_cfg=jc.loss, num_classes=det.decoder.num_classes)
        return losses["loss"], losses

    (_, losses), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jparams)
    grads = jstate.mask_gradients(grads, jparams, det)
    return (jax.tree_util.tree_map(np.asarray, losses),
            _flat(jax.tree_util.tree_map(np.asarray, grads)))


def _jdet(backbone, decoder=DECODER):
    return jcfg.DetectorConfig(backbone=jcfg.BackboneConfig(**backbone),
                               decoder=jcfg.DecoderConfig(**decoder))


def _jtrain(backbone, mesh=None):
    return jcfg.TrainConfig(
        detector=_jdet(backbone),
        data=jcfg.DataConfig(batch_size=BATCH, max_boxes=MAX_BOXES),
        optim=jcfg.OptimConfig(learning_rate=LR),
        mesh=jcfg.MeshConfig(**(mesh or {})))


def _tree(backbone):
    """JAX's init with lora_B drawn nonzero in the adapted blocks' rows
    (the others stay zero, as the masked updates keep them)."""
    t = _plain(jax_init(jax.random.key(0), _jdet(backbone)))
    rng = np.random.default_rng(0)
    depth = t["backbone"]["blocks"]["q"]["kernel"].shape[0]
    first = depth - backbone["lora_last_n_blocks"]
    for lin in t["backbone"]["blocks"].values():
        if isinstance(lin, dict) and "lora_B" in lin:
            b = rng.normal(0, 0.05, lin["lora_B"].shape).astype(np.float32)
            b[:first] = 0.0
            lin["lora_B"] = b
    return t


def _jax_forward(tree, images, mesh_fields):
    jmesh = jax_create_mesh(model_parallel_size=4)
    out = jax_detector_apply(
        jax.tree_util.tree_map(jnp.asarray, tree), _jdet(VITS),
        jnp.asarray(images), deterministic=True, mesh=jmesh,
        pipe_axis="model",
        pipe_microbatches=mesh_fields["pipeline_microbatches"],
        pipe_chunks=mesh_fields.get("pipeline_chunks", 1))
    return {k: np.asarray(out[k]) for k in ("pred_logits", "pred_boxes")}


def _jax_pp_step(tree, batch, mesh_fields):
    """JAX's train step on its 4-device mesh of the same shape, as
    tests/test_pp_tp.py builds it: (metrics, updated params)."""
    jc = _jtrain(TINY, mesh_fields)
    mesh = jax_create_mesh(mesh_fields["model_parallel_size"],
                           devices=jax.devices()[:WORLD], cfg=jc.mesh)
    params = jax_shard_params(jax.tree_util.tree_map(jnp.asarray, tree),
                              mesh, cfg=jc.mesh)
    tx = jstate.make_optimizer(jc.optim, jc.detector, params)
    state = jstate.create_train_state(params, jc.optim, jc.detector)
    bsh = NamedSharding(mesh, P(jc.mesh.data_axis))
    jb = {k: jax.device_put(jnp.asarray(v), bsh) for k, v in batch.items()}
    state, metrics = jax_make_train_step(jc, tx, mesh=mesh)(
        state, jb, jax.random.key(1))
    return (jax.tree_util.tree_map(np.asarray, metrics),
            _flat(jax.tree_util.tree_map(np.asarray, state.params)))


def _jax_single(tree, batch):
    """JAX's single-device loss terms and masked gradients, and its
    trainable mask."""
    jc = _jtrain(TINY)
    losses, grads = _jax_loss_and_grads(jc, tree, batch)
    mask = _flat(jax.tree_util.tree_map(bool, jax_trainable_mask(
        jax.tree_util.tree_map(jnp.asarray, tree), jc.detector)))
    return {"losses": losses, "grads": grads, "mask": mask}


def _single_forward(tree, images):
    pc = cp.train_config(VITS, DECODER, {})
    params = params_from_numpy(tree, device="cpu")
    x = torch.from_numpy(images)
    fwd = make_eval_step(pc)(params, x)
    topk = make_eval_topk_step(pc, max_detections=10)(
        params, x, torch.full((x.shape[0], 2), 56.0))["topk"]
    return fwd, topk


def _single_step(tree, batch):
    pc = cp.train_config(TINY, DECODER, {}, BATCH, MAX_BOXES, LR)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    state = pstate.create_train_state(params_from_numpy(tree, device="cpu"),
                                      pc.optim, pc.detector)
    losses, grads = train_grads(pc, state, tb)
    _, metrics = make_train_step(pc)(state, tb)
    return {"losses": losses, "grads": _flat(grads), "metrics": metrics,
            "params": _flat(params_to_numpy(state.params))}


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
    vits, tiny = _tree(VITS), _tree(TINY)
    images = make_batch(np.random.default_rng(1), FWD_BATCH, image_size=56,
                        max_boxes=MAX_BOXES)["images"]
    batch = make_batch(np.random.default_rng(0), BATCH, image_size=56,
                       max_boxes=MAX_BOXES)
    jobs = [dict(kind="forward", name=n, mesh=m, tree=vits, images=images,
                 backbone=VITS, decoder=DECODER)
            for n, m in FWD_MESHES.items()]
    jobs += [dict(kind="train", name=n, mesh=m, tree=tiny, batch=batch,
                  backbone=TINY, decoder=DECODER)
             for n, m in TRAIN_MESHES.items()]
    ranks = worker.start(jobs, WORLD, tmp_path_factory.mktemp("mesh_pp"))
    try:
        # JAX's five references traced and compiled side by side (XLA's
        # compiles leave the GIL), the port's one process meanwhile.
        with ThreadPoolExecutor(5) as pool:
            fwd = {n: pool.submit(_jax_forward, vits, images, m)
                   for n, m in FWD_MESHES.items()}
            pp = {n: pool.submit(_jax_pp_step, tiny, batch, m)
                  for n, m in TRAIN_MESHES.items()}
            single = pool.submit(_jax_single, tiny, batch)
            ref = {"fwd_one": _single_forward(vits, images),
                   "one": _single_step(tiny, batch)}
            ref.update(fwd_jax={n: f.result() for n, f in fwd.items()},
                       jax_pp={n: f.result() for n, f in pp.items()},
                       jax=single.result())
        results = worker.results(ranks)
    finally:
        ranks.kill()
    return {"ref": ref, "results": results, "tree": tiny}


def _results(run, name):
    return [r[name] for r in run["results"]]


@pytest.mark.parametrize("name", list(FWD_MESHES))
def test_pp_forward_matches_jax_and_one_process(run, name):
    """The eval forward over 4 stages (the whole batch on every stage)
    against JAX's pipelined forward and the port's one process; the
    top-k step against the one process's."""
    fwd_one, topk_one = run["ref"]["fwd_one"]
    for r in _results(run, name):
        for key in ("pred_logits", "pred_boxes"):
            got, ref = r["forward"][key], run["ref"]["fwd_jax"][name][key]
            assert got.shape == ref.shape
            assert float(np.abs(ref - got.numpy()).max()) <= MODEL_TOL, key
            assert _rel(fwd_one[key], got) <= PORT_TOL, key
        assert torch.allclose(r["topk"][..., :2], topk_one[..., :2], rtol=0,
                              atol=1e-5)
        assert torch.allclose(r["topk"], topk_one, rtol=0, atol=TOPK_TOL)


@pytest.mark.parametrize("name", list(TRAIN_MESHES))
def test_pp_mesh_layout(run, name):
    """Rank r's place, as JAX lays out its devices: legacy (data, stage)
    = (r // P, r % P); three-axis (data, stage, model) = (r // (pp tp),
    (r // tp) % pp, r % tp)."""
    mesh = TRAIN_MESHES[name]
    for r, res in enumerate(_results(run, name)):
        if mesh.get("pipeline_parallel"):
            want = (r // 2, r % 2, 0)
        else:
            want = (0, (r // 2) % 2, r % 2)
        assert (res["data_index"], res["stage_index"],
                res["model_index"]) == want


@pytest.mark.parametrize("name", list(TRAIN_MESHES))
def test_pp_train_step_matches_jax_and_one_process(run, name):
    """One step: the global batch's loss terms, every trainable gradient
    (the blocks' summed over the stages, the decoder's whole on each)
    and the global norm against the port's one process and JAX's single
    device; the loss, the norm and the updated params against the port's
    one process and JAX's step on the same mesh."""
    jx, one = run["ref"]["jax"], run["ref"]["one"]
    jpp_metrics, jpp_params = run["ref"]["jax_pp"][name]
    assert _rel(jx["losses"]["loss"], jpp_metrics["loss"]) <= LOSS_TOL
    for r in _results(run, name):
        for key in ("loss", "loss_ce", "loss_bbox", "loss_giou", "num_boxes"):
            assert _rel(jx["losses"][key], r["losses"][key]) <= LOSS_TOL
            assert _rel(one["losses"][key], r["losses"][key]) <= PORT_TOL
        for key in ("loss", "grad_norm"):
            assert _rel(jpp_metrics[key], r["metrics"][key]) <= LOSS_TOL, key
            assert _rel(one["metrics"][key],
                        r["metrics"][key]) <= PORT_TOL, key
        got = _flat(r["grads"])
        assert set(got) == set(one["grads"]) and len(got) > 40
        for k, g in got.items():
            assert _rel(jx["grads"][k], g) <= GRAD_TOL, k
            assert _rel(one["grads"][k], g) <= PORT_TOL, k
        new, before = _flat(r["stepped"]), _flat(run["tree"])
        clip = min(1.0, 1.0 / float(jpp_metrics["grad_norm"]))
        moved = 0
        for k, v in jpp_params.items():
            if not jx["mask"][k]:
                assert np.array_equal(new[k].numpy(), before[k]), k
                continue
            g = np.abs(jx["grads"][k] * clip + WEIGHT_DECAY * before[k])
            clear = (g > GRAD_FLOOR * g.max()) & (g > GRAD_ABS_FLOOR)
            moved += int(clear.sum())
            for ref in (v, one["params"][k]):
                assert np.abs(new[k].numpy() - ref)[clear].max(
                    initial=0.0) <= PARAM_TOL, k
        assert moved > 5_000


def test_lora_row_masks_hold_under_the_interleaved_layout(run):
    """PP 2 x TP 2 with 2 chunks a stage: stage 0 runs blocks 0 and 2
    (adapted), stage 1 blocks 1 and 3 (adapted). On every rank the
    non-adapted rows 0-1 of each LoRA leaf get no gradient and do not
    move, and both adapted rows move, whichever stage ran them; every
    rank ends with the same params."""
    before = _flat(run["tree"])
    results = _results(run, "pp2tp2")
    first = _flat(results[0]["stepped"])
    for r in results:
        grads, new = _flat(r["grads"]), _flat(r["stepped"])
        loras = [k for k in grads if k.endswith(("lora_A", "lora_B"))]
        assert len(loras) == 12
        for k in loras:
            assert not grads[k][:2].any(), k
            assert np.array_equal(new[k][:2].numpy(), before[k][:2]), k
            for row in (2, 3):
                assert grads[k][row].abs().sum() > 0, (k, row)
                assert not np.array_equal(new[k][row].numpy(),
                                          before[k][row]), (k, row)
        for k, v in new.items():
            assert torch.equal(v, first[k]), k


def _mock_mesh(fields):
    mc = pcfg.MeshConfig(**fields)
    return psh.Mesh(data_size=1, model_size=1, data_index=0, model_index=0,
                    data_group=None, model_group=None, backend="gloo",
                    cfg=mc, stage_size=mc.stage_size,
                    stage_ranks=tuple(range(mc.stage_size)))


@pytest.mark.parametrize("what", ["prefix_int8", "moe"])
def test_pp_refuses_prefix_int8_and_moe_as_jax_does(what):
    """The int8 prefix and the MoE FFN under a pipeline: JAX's ValueError
    text from the port's backbone and from `check_pipeline` (the loop and
    the CLI call it before building a mesh)."""
    bb = dict(TINY, **({"prefix_int8": True} if what == "prefix_int8" else
                       {"ffn_type_override": "moe", "moe_num_experts": 2}))
    images = np.zeros((2, 56, 56, 3), np.float32)
    jmesh = jax_create_mesh(model_parallel_size=2)
    shapes = jax.eval_shape(lambda k: jax_init(k, _jdet(bb)),
                            jax.random.key(0))
    with pytest.raises(ValueError) as want:  # raised while JAX traces
        jax.eval_shape(lambda p, x: jax_detector_apply(
            p, _jdet(bb), x, mesh=jmesh, pipe_axis="model"), shapes,
            jnp.asarray(images))
    det = pcfg.DetectorConfig(backbone=pcfg.BackboneConfig(**bb),
                              decoder=pcfg.DecoderConfig(**DECODER))
    legacy = dict(model_parallel_size=2, pipeline_parallel=True)
    with pytest.raises(ValueError) as got:
        detector_apply(init_detector_params(torch.Generator().manual_seed(0),
                                            det, device="cpu"),
                       det, torch.from_numpy(images), mesh=_mock_mesh(legacy),
                       pipe_axis="model")
    assert str(got.value) == str(want.value)
    cfg = pcfg.TrainConfig(detector=det, mesh=pcfg.MeshConfig(**legacy))
    with pytest.raises(ValueError, match=str(want.value)[:40]):
        check_pipeline(cfg)


def test_fsdp_with_a_pipeline_raises_jaxs_error():
    """FSDP beside a pipeline (either mode): JAX's ValueError, which its
    `param_shardings` raises, from the port's MeshConfig; FSDP alone and
    beside TP builds (ported since)."""
    params = jax.eval_shape(lambda k: jax_init(k, _jdet(TINY)),
                            jax.random.key(0))
    for fields in (dict(model_parallel_size=2, pipeline_parallel=True),
                   dict(pipeline_parallel_size=2)):
        jmc = jcfg.MeshConfig(fsdp=True, **fields)
        jmesh = jax_create_mesh(jmc.model_parallel_size, cfg=jmc)
        with pytest.raises(ValueError) as want:
            param_shardings(params, jmesh, cfg=jmc)
        with pytest.raises(ValueError) as got:
            pcfg.MeshConfig(fsdp=True, **fields)
        assert str(got.value) == str(want.value)
    assert pcfg.MeshConfig(fsdp=True).fsdp
    assert pcfg.MeshConfig(fsdp=True, model_parallel_size=2).fsdp


@pytest.mark.parametrize("fields, message", [
    (dict(model_parallel_size=5, pipeline_parallel=True),
     r"depth 12 not divisible by stages x chunks \(5 x 1\)"),
    (dict(model_parallel_size=4, pipeline_parallel=True,
          pipeline_chunks=3, pipeline_microbatches=6),
     r"interleaved schedule needs microbatches \(6\) divisible by stages "
     r"\(4\)"),
    (dict(pipeline_parallel_size=2, model_parallel_size=2,
          pipeline_chunks=0), "num_chunks must be >= 1, got 0"),
])
def test_pipeline_shapes_that_do_not_divide_raise(fields, message):
    """A stack or a schedule the pipeline cannot take raises JAX's
    message before any mesh exists (`check_pipeline`); a world that
    does not divide into the mesh raises `auto_mesh`'s, naming the stage
    axis."""
    det = pcfg.DetectorConfig(backbone=pcfg.BackboneConfig(**VITS),
                              decoder=pcfg.DecoderConfig(**DECODER))
    with pytest.raises(ValueError, match=message):
        check_pipeline(pcfg.TrainConfig(detector=det,
                                        mesh=pcfg.MeshConfig(**fields)))
    mc = pcfg.MeshConfig(pipeline_parallel_size=2, model_parallel_size=2)
    with pytest.raises(ValueError, match=r"a world of 1 processes does not "
                       r"divide into the mesh data D x stage 2 x model 2"):
        psh.auto_mesh(4, 2, mc)
    assert dataclasses.replace(mc, pipeline_parallel_size=0).stage_size == 1
