"""Context parallelism, and the SwiGLU and int8 layouts of tensor
parallelism, in the port (dinov2_od_tpu_torch/parallel/, models/vit.py,
train/step.py) against the JAX package, on the CPU.

The port's ranks are processes joined in a gloo process group
(tests/torch_cp_worker.py, which imports no JAX): two ranks for the
legacy mode's ring over the model axis (1 x 2), SwiGLU under TP 2 and
int8 under TP 2; four for DP 2 x CP 2 and CP 2 x TP 2 on the three-axis
('data', 'context', 'model') mesh. Each world starts once for the module
and runs while this process computes the references.

The model: ViT blocks of width 384 with 6 heads of 64 (3 a rank under
TP 2), 2 blocks at 56 px (17 tokens: under a ring of 2, padded to 18, 9
a rank, the second rank's shard straddling the pad at kv_len 8), the last
LoRA-adapted (nonzero lora_B); a 2-layer deformable decoder of width 64
with 4 heads; fp32, decoder dropout 0 unless said. The ring's inner loop
is 'auto' (the blockwise plain version on a CPU tensor); the legacy mesh
runs it once more with the flash impl forced (the kernels' plain
versions). SwiGLU: width 256, 4 heads, mlp_dim 512 (fc1 [256, 1024]).

References: the JAX single-device loss terms, gradients, eval forward and
`make_train_step` on the same numpy params and batch; the port's
single-process step; JAX's own int8 forwards (single device and TP 2 on
the 8-device CPU mesh) and its lone int8 linear.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from dinov2_od_tpu import config as jcfg
from dinov2_od_tpu.models.detector import (
    detector_apply as jax_detector_apply,
    fold_detector_lora as jax_fold,
    init_detector_params as jax_init,
    trainable_mask as jax_trainable_mask,
)
from dinov2_od_tpu.models.quantize import (
    int8_linear as jax_int8_linear,
    quantize_detector_int8 as jax_quantize,
    quantize_linear as jax_quantize_linear,
)
from dinov2_od_tpu.ops.losses import set_criterion as jax_set_criterion
from dinov2_od_tpu.parallel import create_mesh as jax_create_mesh
from dinov2_od_tpu.parallel import shard_params as jax_shard_params
from dinov2_od_tpu.parallel.sharding import param_shardings
from dinov2_od_tpu.train import state as jstate
from dinov2_od_tpu.train.step import (
    make_eval_step as jax_make_eval_step,
    make_train_step as jax_make_train_step,
    prep_images as jax_prep_images,
)

from dinov2_od_tpu_torch import config as pcfg
from dinov2_od_tpu_torch.data.synthetic import NUM_SYNTHETIC_CLASSES, make_batch
from dinov2_od_tpu_torch.params import params_from_numpy, params_to_numpy
from dinov2_od_tpu_torch.parallel import sharding as psh
from dinov2_od_tpu_torch.train import state as pstate
from dinov2_od_tpu_torch.train.step import (
    make_eval_step,
    make_eval_topk_step,
    make_train_step,
    train_grads,
)

import torch_cp_worker as worker

BACKBONE = dict(variant="small", image_size=56, depth_override=2, lora_r=2,
                lora_last_n_blocks=1, target_dim=64)
SWIGLU = dict(variant="small", image_size=56, hidden_dim_override=256,
              num_heads_override=4, depth_override=2, lora_r=2,
              lora_last_n_blocks=1, target_dim=64, ffn_type_override="swiglu",
              mlp_ratio_override=2.0)
DECODER = dict(hidden_dim=64, num_queries=8, num_layers=2, num_heads=4,
               dim_feedforward=96, num_classes=NUM_SYNTHETIC_CLASSES,
               dropout=0.0)
BATCH, MAX_BOXES, LR = 4, 6, 3e-4
# name: (world, the port's MeshConfig fields, forced ring impl)
CP_MESHES = {
    "legacy1x2": (2, dict(model_parallel_size=2, context_parallel=True),
                  None),
    "legacy1x2-flash": (2, dict(model_parallel_size=2,
                                context_parallel=True), "flash"),
    "dp2cp2": (4, dict(context_parallel_size=2), None),
    "cp2tp2": (4, dict(model_parallel_size=2, context_parallel_size=2),
               None),
}
TP2 = dict(model_parallel_size=2)
# fp32 tolerances, as tests/test_torch_tensor_parallel.py holds TP to JAX
# (each relative to max(1, the reference's magnitude)): outputs 1e-4 max
# abs; losses and norms 1e-5; gradients 1e-4 of each leaf's largest;
# updated params 2e-7 where what Adam's first step sees is clearly above
# noise (over 1e-2 of its leaf's largest and over 1e-6; such an element
# moves by about lr * sign). Against the port's single process 1e-5: the
# same math but for the ring's merge and the ranks' partial sums.
MODEL_TOL = 1e-4
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
PARAM_TOL = 2e-7
GRAD_FLOOR = 1e-2
GRAD_ABS_FLOOR = 1e-6
WEIGHT_DECAY = 1e-4  # OptimConfig's default
PORT_TOL = 1e-5
# The top-k rows (score, label, x, y, w, h) against one process's: scores
# and labels within 1e-5, boxes within 1e-3 pixels of a 56 px image.
TOPK_TOL = 1e-3
# A lone row-parallel int8 linear against one device's, as JAX's
# test_int8_linear_row_parallel_is_exact holds it (3e-6).
INT8_LINEAR_TOL = 3e-6


def _cfgs(backbone, decoder=DECODER):
    jdet = jcfg.DetectorConfig(backbone=jcfg.BackboneConfig(**backbone),
                               decoder=jcfg.DecoderConfig(**decoder))
    jc = jcfg.TrainConfig(detector=jdet, data=jcfg.DataConfig(
        batch_size=BATCH, max_boxes=MAX_BOXES),
        optim=jcfg.OptimConfig(learning_rate=LR))
    return jc, worker.train_config(backbone, decoder, {}, BATCH, MAX_BOXES,
                                   LR)


def _plain(tree):
    """The JAX tree as nested dicts of numpy arrays, picklable without
    JAX."""
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    return np.array(tree, copy=True)


def _jax_tree(backbone):
    jc, _ = _cfgs(backbone)
    t = _plain(jax_init(jax.random.key(0), jc.detector))
    rng = np.random.default_rng(0)
    for lin in t["backbone"]["blocks"].values():
        if isinstance(lin, dict) and "lora_B" in lin:
            lin["lora_B"] = rng.normal(0, 0.05, lin["lora_B"].shape).astype(
                np.float32)
    return t


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
    fwd = jax_detector_apply(jparams, det, images)
    return (jax.tree_util.tree_map(np.asarray, losses),
            _flat(jax.tree_util.tree_map(np.asarray, grads)),
            jax.tree_util.tree_map(np.asarray, fwd))


def _int8_inputs():
    """The int8 tree (LoRA folded, then quantized by JAX), its forward's
    images, and a lone linear with its input."""
    jc, _ = _cfgs(BACKBONE)
    fp = jax_init(jax.random.key(0), jc.detector)
    tree = _plain(jax_quantize(jax_fold(fp, jc.detector), jc.detector))
    rng = np.random.default_rng(3)
    lin = _plain(jax_quantize_linear({
        "kernel": jnp.asarray(rng.normal(size=(64, 32)).astype(np.float32)),
        "bias": jnp.asarray(rng.normal(size=(32,)).astype(np.float32))}))
    x = rng.normal(size=(8, 64)).astype(np.float32)
    images = make_batch(np.random.default_rng(0), BATCH, image_size=56,
                        max_boxes=MAX_BOXES)["images"]
    return jc, _plain(fp), tree, lin, x, images


def _jax_int8_refs(jc, fp_tree, tree, lin, x, images):
    """JAX's fp and int8 forwards on one device, its int8 forward under TP
    2 (data 4 x model 2 on the CPU mesh), and its lone int8 linear."""
    img = jnp.asarray(images)
    fp = jax.tree_util.tree_map(jnp.asarray, fp_tree)
    q = jax.tree_util.tree_map(jnp.asarray, tree)
    out = {"fp": jax_make_eval_step(jc)(fp, img),
           "int8": jax_make_eval_step(jc)(q, img)}
    mesh = jax_create_mesh(model_parallel_size=2)
    out["int8_tp"] = jax_make_eval_step(jc, mesh=mesh)(
        jax_shard_params(q, mesh),
        jax.device_put(img, NamedSharding(mesh, P("data"))))
    out = {k: {n: np.asarray(v[n]) for n in ("pred_logits", "pred_boxes")}
           for k, v in out.items()}
    out["linear"] = np.asarray(jax_int8_linear(
        jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, lin)))
    return out


def _single(pc, tree, batch):
    """The port's single-process forward, top-k, loss and gradients, step
    and dropout loss."""
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    state = pstate.create_train_state(params_from_numpy(tree, device="cpu"),
                                      pc.optim, pc.detector)
    fwd = make_eval_step(pc)(state.params, tb["images"])
    topk = make_eval_topk_step(pc, max_detections=10)(
        state.params, tb["images"], torch.full((BATCH, 2), 56.0))["topk"]
    losses, grads = train_grads(pc, state, tb)
    _, metrics = make_train_step(pc)(state, tb)
    drop = worker.train_config(BACKBONE, {**DECODER, "dropout": 0.1}, {},
                               BATCH, MAX_BOXES, LR)
    dropped, _ = train_grads(drop, pstate.create_train_state(
        params_from_numpy(tree, device="cpu"), drop.optim, drop.detector),
        tb, torch.Generator().manual_seed(5))
    return {"forward": fwd, "topk": topk, "losses": losses,
            "grads": _flat(grads), "metrics": metrics,
            "params": _flat(params_to_numpy(state.params)),
            "dropout_losses": dropped}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both worlds' rank results beside the references."""
    tree = _jax_tree(BACKBONE)
    swiglu_tree = _jax_tree(SWIGLU)
    batch = make_batch(np.random.default_rng(0), BATCH, image_size=56,
                       max_boxes=MAX_BOXES)
    jc, fp_tree, int8_tree, lin, x, images = _int8_inputs()
    common = dict(kind="train", tree=tree, batch=batch, backbone=BACKBONE,
                  decoder=DECODER, dropout_seed=5)
    jobs = {2: [], 4: []}
    for name, (world, mesh, impl) in CP_MESHES.items():
        jobs[world].append(dict(common, name=name, mesh=mesh,
                                ring_impl=impl, remat=impl == "flash"))
    jobs[2] += [
        dict(name="swiglu", kind="swiglu", mesh=TP2, tree=swiglu_tree,
             batch=batch, backbone=SWIGLU, decoder=DECODER),
        dict(name="int8", kind="int8", mesh=TP2, tree=int8_tree,
             images=images, linear=lin, x=x, backbone=BACKBONE,
             decoder=DECODER)]
    tmps = {w: tmp_path_factory.mktemp(f"world{w}") for w in jobs}
    procs = {w: worker.start_ranks(jobs[w], w, tmps[w]) for w in jobs}
    try:
        jloss, jgrads, jfwd = _jax_loss_and_grads(jc, tree, batch)
        jparams = jax.tree_util.tree_map(jnp.asarray, tree)
        jb = jax.tree_util.tree_map(jnp.asarray, batch)
        tx = jstate.make_optimizer(jc.optim, jc.detector, jparams)
        jstate0 = jstate.create_train_state(
            jax.tree_util.tree_map(jnp.asarray, tree), jc.optim, jc.detector)
        jnew, jmetrics = jax_make_train_step(jc, tx)(jstate0, jb,
                                                     jax.random.key(1))
        sc, _ = _cfgs(SWIGLU)
        sw_loss, sw_grads, sw_fwd = _jax_loss_and_grads(sc, swiglu_tree,
                                                        batch)
        int8 = _jax_int8_refs(jc, fp_tree, int8_tree, lin, x, images)
        _, pc = _cfgs(BACKBONE)
        single = _single(pc, tree, batch)
        ranks = {w: worker.rank_results(procs[w], tmps[w]) for w in procs}
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
    mask = _flat(jax.tree_util.tree_map(
        bool, jax_trainable_mask(jparams, jc.detector)))
    return {
        "tree": tree, "batch": batch, "ranks": ranks, "single": single,
        "jax": {"losses": jloss, "grads": jgrads, "forward": jfwd,
                "metrics": jax.tree_util.tree_map(np.asarray, jmetrics),
                "params": _flat(jax.tree_util.tree_map(np.asarray,
                                                       jnew.params)),
                "mask": mask},
        "swiglu": {"losses": sw_loss, "grads": sw_grads, "forward": sw_fwd},
        "int8": int8,
    }


def _results(run, name):
    world = CP_MESHES[name][0] if name in CP_MESHES else 2
    return [r[name] for r in run["ranks"][world]]


def _global(results, key):
    """A per-rank output replicated over the model and context axes,
    assembled over the data axis after checking the replicas agree."""
    parts = {}
    for r in results:
        t, d = r[key], r["data_index"]
        if d in parts:
            for name in t:
                assert torch.allclose(parts[d][name], t[name], rtol=0,
                                      atol=PORT_TOL), name
        else:
            parts[d] = t
    return {name: torch.cat([parts[d][name] for d in sorted(parts)])
            for name in parts[0]}


@pytest.mark.parametrize("name", list(CP_MESHES))
def test_cp_mesh_layout(run, name):
    """Rank r's place: (data, context, model) = (r // (cp tp),
    (r // tp) % cp, r % tp) on the three-axis mesh; the legacy ring over
    the model axis of (data, model) = (r // n, r % n)."""
    world, mesh, _ = CP_MESHES[name]
    cp = mesh.get("context_parallel_size", 0)
    tp = mesh.get("model_parallel_size", 1)
    for r, res in enumerate(_results(run, name)):
        if mesh.get("context_parallel"):
            want = (r // tp, r % tp, 0)
        else:
            want = (r // (cp * tp), (r // tp) % cp, r % tp)
        assert (res["data_index"], res["context_index"],
                res["model_index"]) == want


@pytest.mark.parametrize("name", list(CP_MESHES))
def test_cp_forward_and_topk_match_jax(run, name):
    """The eval forward under the ring against JAX's and the port's single
    process; the eval top-k step against the single process's."""
    out = _global(_results(run, name), "forward")
    for key in ("pred_logits", "pred_boxes"):
        ref = run["jax"]["forward"][key]
        assert out[key].shape == ref.shape
        assert float(np.abs(ref - out[key].numpy()).max()) <= MODEL_TOL, key
        assert _rel(run["single"]["forward"][key], out[key]) <= PORT_TOL
    topk = _global([{**r, "topk": {"topk": r["topk"]}}
                    for r in _results(run, name)], "topk")["topk"]
    ref = run["single"]["topk"]
    assert torch.allclose(topk[..., :2], ref[..., :2], rtol=0, atol=1e-5)
    assert torch.allclose(topk, ref, rtol=0, atol=TOPK_TOL)


@pytest.mark.parametrize("name", list(CP_MESHES))
def test_cp_train_step_matches_jax(run, name):
    """One step under the ring: the loss terms of the global batch, every
    trainable gradient (the backbone's summed over the ring, the
    decoder's not), the global norm and make_train_step's updated params,
    against JAX's single-device step and the port's single process."""
    jx, single = run["jax"], run["single"]
    for r in _results(run, name):
        for key in ("loss", "loss_ce", "loss_bbox", "loss_giou", "num_boxes"):
            assert _rel(jx["losses"][key], r["losses"][key]) <= LOSS_TOL, key
            assert _rel(single["losses"][key], r["losses"][key]) <= PORT_TOL
        for key in ("loss", "grad_norm"):
            assert _rel(jx["metrics"][key], r["metrics"][key]) <= LOSS_TOL, key
            assert _rel(single["metrics"][key],
                        r["metrics"][key]) <= PORT_TOL, key
        got = _flat(r["grads"])
        assert set(got) == set(single["grads"]) and len(got) > 40
        for k, g in got.items():
            assert _rel(jx["grads"][k], g) <= GRAD_TOL, (k, _rel(
                jx["grads"][k], g))
            assert _rel(single["grads"][k], g) <= PORT_TOL, k
            if k.endswith(("lora_A", "lora_B")):
                assert not g[0].any() and g[1].abs().sum() > 0, k
        new, before = _flat(r["stepped"]), _flat(run["tree"])
        clip = min(1.0, 1.0 / float(jx["metrics"]["grad_norm"]))
        moved = 0
        for k, v in jx["params"].items():
            if not jx["mask"][k]:
                assert np.array_equal(new[k].numpy(), before[k]), k
                continue
            g = np.abs(jx["grads"][k] * clip + WEIGHT_DECAY * before[k])
            clear = (g > GRAD_FLOOR * g.max()) & (g > GRAD_ABS_FLOOR)
            moved += int(clear.sum())
            for ref in (v, single["params"][k]):
                assert np.abs(new[k].numpy() - ref)[clear].max(
                    initial=0.0) <= PARAM_TOL, k
        assert moved > 5_000


def test_flash_ring_runs_the_lse_route_per_ring_step(run):
    """With the flash impl forced, each block's ring calls the flat
    forward's plain version once a ring step (two on a ring of 2; the
    local [2, 9, 6, 64] pairs its heads); in the train step's backward the
    adapted block recomputes both steps and runs the backward of each."""
    depth = BACKBONE["depth_override"]
    zero = dict.fromkeys(worker.PLAIN, 0)
    for r in _results(run, "legacy1x2-flash"):
        assert r["forward_calls"] == {**zero,
                                      "flash_attention_fwd_plain": 2 * depth}
        assert r["grad_calls"] == {**zero,
                                   "flash_attention_fwd_plain": 2 * depth + 2,
                                   "flash_attention_bwd_plain": 2}


def test_remat_repeats_the_ring(run):
    """Under use_remat each adapted block, its flash ring included, runs
    again in the backward: the same gradients as without remat."""
    for r in _results(run, "legacy1x2-flash"):
        got, want = _flat(r["remat_grads"]), _flat(r["grads"])
        assert got.keys() == want.keys()
        for k in want:
            assert _rel(want[k], got[k]) <= PORT_TOL, k


@pytest.mark.parametrize("name", ["legacy1x2", "dp2cp2", "cp2tp2"])
def test_dropout_under_cp_drops_what_one_process_drops(run, name):
    """Decoder dropout 0.1 from generators seeded alike on every rank: the
    ring's ranks draw the same masks, so the loss equals one process's."""
    ref = run["single"]["dropout_losses"]
    assert abs(ref["loss"] - run["single"]["losses"]["loss"]) > 1e-3
    for r in _results(run, name):
        for key in ("loss", "loss_ce", "loss_bbox", "loss_giou"):
            assert _rel(ref[key], r["dropout_losses"][key]) <= PORT_TOL, key


def test_swiglu_tp_matches_jax(run):
    """SwiGLU under TP 2 (each rank's fc1 shard its slice of both halves):
    the forward, the loss terms and the gathered gradients against JAX's
    single device."""
    sw = run["swiglu"]
    for r in _results(run, "swiglu"):
        for key in ("pred_logits", "pred_boxes"):
            err = float(np.abs(sw["forward"][key]
                               - r["forward"][key].numpy()).max())
            assert err <= MODEL_TOL, (key, err)
        for key in ("loss", "loss_ce", "loss_bbox", "loss_giou"):
            assert _rel(sw["losses"][key], r["losses"][key]) <= LOSS_TOL, key
        got = _flat(r["grads"])
        assert {k for k in got if "fc1" in k} >= {
            "backbone.blocks.fc1.lora_A", "backbone.blocks.fc1.lora_B"}
        for k, g in got.items():
            assert _rel(sw["grads"][k], g) <= GRAD_TOL, k


def test_swiglu_contiguous_split_fails(run):
    """The faulty layout, fc1 sharded as one contiguous slice of 2M (each
    rank's gates paired with another rank's values), fails the forward's
    check by far."""
    sw = run["swiglu"]
    for r in _results(run, "swiglu"):
        err = float(np.abs(sw["forward"]["pred_logits"] - r[
            "contiguous_forward"]["pred_logits"].numpy()).max())
        assert err > 100 * MODEL_TOL, err


def test_int8_tp_forward_matches_jax(run):
    """int8 under TP 2 (B6 off; the row-parallel linears quantize against
    the model group's absmax) tracks the fp forward as well as JAX's
    single-device int8 does, and agrees with JAX's TP int8 forward, within
    the quantization noise JAX's test_int8_tp_forward_matches_single_device
    accepts (1.5 x the single device's error, + 1e-6)."""
    ref = run["int8"]
    for key in ("pred_logits", "pred_boxes"):
        out = _global([{**r, "fwd": {key: r["forward"][key]}}
                       for r in _results(run, "int8")], "fwd")[key].numpy()
        err_single = np.abs(ref["fp"][key] - ref["int8"][key]).max()
        assert err_single > 0
        assert np.abs(ref["fp"][key] - out).max() <= 1.5 * err_single + 1e-6
        assert np.abs(ref["int8_tp"][key] - out).max() <= (
            1.5 * err_single + 1e-6)


def test_int8_row_parallel_linear_is_exact(run):
    """A lone row-parallel int8 linear under TP 2 against JAX's on one
    device within 3e-6 (its codes are one device's); quantized against
    each rank's own absmax instead, it misses by far."""
    ref = run["int8"]["linear"]
    for r in _results(run, "int8"):
        got = r["row_parallel"].numpy()
        np.testing.assert_allclose(got, ref, rtol=INT8_LINEAR_TOL,
                                   atol=INT8_LINEAR_TOL)
        bad = r["row_parallel_local_max"].numpy()
        assert np.abs(bad - ref).max() > 100 * INT8_LINEAR_TOL


def test_shard_rules_for_swiglu_and_int8():
    """Without processes: SwiGLU's fc1 leaves shard half by half and the
    tree's FFN is told from its shapes; an int8 tree's leaves shard on the
    dims JAX's param_shardings shards (kernel_q with the kernel, w_scale
    with a column-parallel output and replicated on a row-parallel one),
    and kernel_q stays K-major in its shard."""
    sw = params_from_numpy(_jax_tree(SWIGLU), device="cpu")
    assert psh._swiglu(sw) and not psh._swiglu(
        params_from_numpy(_jax_tree(BACKBONE), device="cpu"))
    meshes = [psh.Mesh(data_size=1, model_size=2, data_index=0,
                       model_index=m, data_group=None, model_group=None,
                       backend="gloo") for m in range(2)]
    fc1 = sw["backbone"]["blocks"]["fc1"]["kernel"]  # [depth, 256, 1024]
    for m, mesh in enumerate(meshes):
        got = psh.shard_params(sw, mesh)["backbone"]["blocks"]["fc1"]
        want = torch.cat([fc1[..., m * 256:(m + 1) * 256],
                          fc1[..., 512 + m * 256:512 + (m + 1) * 256]], -1)
        assert torch.equal(got["kernel"], want)
        assert got["lora_B"].shape[-1] == 512
    jc, _, int8_tree, _, _, _ = _int8_inputs()
    jmesh = jax_create_mesh(model_parallel_size=2)
    specs = _flat(jax.tree_util.tree_map(
        lambda s: tuple(s.spec), param_shardings(
            jax.tree_util.tree_map(jnp.asarray, int8_tree), jmesh),
        is_leaf=lambda s: hasattr(s, "spec")))
    q = params_from_numpy(int8_tree, device="cpu")
    paths = {".".join(p): p for p in psh.leaf_paths(q)}
    for name in ("q.kernel_q", "q.w_scale", "fc1.kernel_q", "fc1.w_scale",
                 "fc2.kernel_q", "fc2.w_scale", "proj.w_scale"):
        key = "backbone.blocks." + name
        spec = specs[key]
        d = psh.shard_dim(paths[key])
        want = [i for i, a in enumerate(spec) if a == "model"]
        got = [] if d is None else [d % q["backbone"]["blocks"][
            name.split(".")[0]][name.split(".")[1]].dim()]
        assert got == want, (name, got, spec)
    shard = psh.shard_params(q, meshes[1])["backbone"]["blocks"]
    for lin in ("q", "fc2"):
        kq = shard[lin]["kernel_q"]
        assert kq.stride()[-2:] == (1, kq.shape[-2]), lin  # K-major


def test_mesh_config_matches_jax():
    """MeshConfig accepts the context-parallel modes and refuses what
    JAX's refuses, with its messages; pipeline parallelism and FSDP still
    raise as unported."""
    for kw, match in ((dict(context_parallel=True, context_parallel_size=2),
                       "not both"),
                      (dict(context_parallel_size=2,
                            pipeline_parallel=True), "pipeline")):
        with pytest.raises(ValueError, match=match):
            jcfg.MeshConfig(**kw)
        with pytest.raises(ValueError, match=match):
            pcfg.MeshConfig(**kw)
    legacy = pcfg.MeshConfig(model_parallel_size=4, context_parallel=True)
    three = pcfg.MeshConfig(model_parallel_size=2, context_parallel_size=2)
    assert (legacy.tensor_parallel_size, legacy.context_size) == (1, 4)
    assert (three.tensor_parallel_size, three.context_size) == (2, 2)
    for kw in (dict(fsdp=True), dict(pipeline_parallel_size=2)):
        with pytest.raises(NotImplementedError):
            pcfg.MeshConfig(**kw)
