"""Megatron tensor parallelism in the port (dinov2_od_tpu_torch/parallel/)
against the JAX package, on the CPU.

The port's ranks run as processes joined in a gloo process group
(tests/torch_tp_worker.py, which imports no JAX), on a ('data', 'model')
mesh of 2 x 2 and of 1 x 4. Each mesh has its own narrow model with an odd
head count per rank, which the flat kernels cannot pair, so attn_impl=
"flash" takes the all-heads pair (B4f/B4b) through their plain versions:
ViT blocks of width 384 with 6 heads of 64 at TP 2 (3 heads a rank) and of
width 256 with 4 heads at TP 4 (1 a rank), 2 blocks at 56 px (17 tokens),
the last LoRA-adapted; a 2-layer deformable decoder of width 64 with 4
heads. fp32, decoder dropout 0 unless said.

References: the JAX single-device loss, gradients and `make_train_step` on
the same numpy params and batch, and the port's single-process step.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dinov2_od_tpu import config as jcfg
from dinov2_od_tpu.models.detector import (
    detector_apply as jax_detector_apply,
    init_detector_params as jax_init,
    trainable_mask as jax_trainable_mask,
)
from dinov2_od_tpu.ops.losses import set_criterion as jax_set_criterion
from dinov2_od_tpu.parallel import create_mesh as jax_create_mesh
from dinov2_od_tpu.parallel.sharding import (
    check_tp_compatible as jax_check_tp,
    param_shardings,
)
from dinov2_od_tpu.train import state as jstate
from dinov2_od_tpu.train.step import (
    make_train_step as jax_make_train_step,
    prep_images as jax_prep_images,
)

from dinov2_od_tpu_torch import config as pcfg
from dinov2_od_tpu_torch.data.synthetic import NUM_SYNTHETIC_CLASSES, make_batch
from dinov2_od_tpu_torch.models.detector import detector_apply
from dinov2_od_tpu_torch.params import params_from_numpy, params_to_numpy
from dinov2_od_tpu_torch.parallel import sharding as psh
from dinov2_od_tpu_torch.train import state as pstate
from dinov2_od_tpu_torch.train.step import (
    make_train_step,
    prep_images,
    train_grads,
)

import torch_tp_worker as worker

REPO = Path(__file__).resolve().parent.parent
DECODER = dict(hidden_dim=64, num_queries=8, num_layers=2, num_heads=4,
               dim_feedforward=96, num_classes=NUM_SYNTHETIC_CLASSES,
               dropout=0.0)
# mesh name: (data size, model size, backbone)
MESHES = {
    "2x2": (2, 2, dict(variant="small", image_size=56, hidden_dim_override=384,
                       num_heads_override=6, depth_override=2, lora_r=2,
                       lora_last_n_blocks=1, target_dim=64)),
    "1x4": (1, 4, dict(variant="small", image_size=56, hidden_dim_override=256,
                       num_heads_override=4, depth_override=2, lora_r=2,
                       lora_last_n_blocks=1, target_dim=64)),
}
BATCH, MAX_BOXES, LR = 4, 6, 3e-4
# fp32, as tests/test_torch_train_step.py holds the single-process port to
# JAX (each relative to max(1, the reference's magnitude)): outputs 1e-4
# max abs; losses and norms 1e-5 (the frameworks' GEMMs and the ranks'
# partial sums add in other orders); gradients 1e-4 of each leaf's largest;
# updated params 2e-7 where what Adam's first step sees (the clipped
# gradient plus the weight decay, wd * p) is clearly above noise: over 1e-2
# of its leaf's largest and over 1e-6. Such an element moves by about
# lr * sign, so only the rounding of p + u differs. (Where the decay
# cancels the clipped gradient, the step is lr * g' / (|g'| + eps) of a
# g' near eps, which the ranks' other summation order moves by 2e-7.)
MODEL_TOL = 1e-4
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
PARAM_TOL = 2e-7
GRAD_FLOOR = 1e-2
GRAD_ABS_FLOOR = 1e-6
WEIGHT_DECAY = 1e-4  # OptimConfig's default
# Against the port's own single-process run: the same ops but for the
# order of the partial sums over ranks, fp32.
PORT_TOL = 1e-5


def _cfgs(backbone, decoder=DECODER):
    jdet = jcfg.DetectorConfig(backbone=jcfg.BackboneConfig(**backbone),
                               decoder=jcfg.DecoderConfig(**decoder))
    data = dict(batch_size=BATCH, max_boxes=MAX_BOXES)
    jc = jcfg.TrainConfig(detector=jdet, data=jcfg.DataConfig(**data),
                          optim=jcfg.OptimConfig(learning_rate=LR))
    pc = worker.train_config(backbone, decoder, BATCH, MAX_BOXES, LR, 1)
    return jc, pc


def _plain(tree):
    """The JAX tree as nested dicts of numpy arrays (NamedTuples as dicts),
    picklable without JAX."""
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


def _jax_loss_fn(jc, batch, rng):
    """The JAX train step's loss (dinov2_od_tpu/train/step.py)."""
    det = jc.detector
    images = jax_prep_images(batch["images"], jc.data.normalize)

    def loss_fn(params):
        params = jstate.stop_gradient_frozen(params, det)
        out = jax_detector_apply(params, det, images, rng=rng,
                                 deterministic=False)
        losses = jax_set_criterion(
            out["pred_logits"], out["pred_boxes"], batch["labels"],
            batch["boxes"], batch["valid"], matcher_cfg=jc.matcher,
            loss_cfg=jc.loss, num_classes=det.decoder.num_classes)
        return losses["loss"], losses

    return loss_fn


def _start_ranks(dp, tp, inputs, tmp):
    """Worker processes of a dp x tp mesh, started on `inputs`; each writes
    its output to tmp/rank{r}.log."""
    inp = tmp / "inputs.pkl"
    with open(inp, "wb") as f:
        pickle.dump(inputs, f)
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    world = dp * tp
    procs = []
    for r in range(world):
        with open(tmp / f"rank{r}.log", "wb") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(REPO / "tests" / "torch_tp_worker.py"),
                 str(r), str(world), str(tp), str(tmp / "store"), str(inp),
                 str(tmp)],
                cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT))
    return procs


def _rank_results(procs, tmp):
    """Each rank's results, once its process has ended."""
    for r, p in enumerate(procs):
        p.wait(timeout=300)
        log = (tmp / f"rank{r}.log").read_text()
        assert p.returncode == 0, f"rank {r}:\n{log[-3000:]}"
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(len(procs))]


@pytest.fixture(scope="module", params=list(MESHES))
def run(request, tmp_path_factory):
    """One mesh's rank results beside the references: JAX's loss terms,
    gradients and make_train_step on the same numpy params and batch, and
    the port's single-process forward and step."""
    dp, tp, backbone = MESHES[request.param]
    jc, pc = _cfgs(backbone)
    tree = _jax_tree(backbone)
    batch = make_batch(np.random.default_rng(0), BATCH, image_size=56,
                       max_boxes=MAX_BOXES)
    inputs = dict(tree=tree, batch=batch, backbone=backbone, decoder=DECODER,
                  batch_size=BATCH, max_boxes=MAX_BOXES, lr=LR,
                  dropout_seed=5)
    # The ranks run while this process computes the references.
    tmp = tmp_path_factory.mktemp(request.param)
    procs = _start_ranks(dp, tp, inputs, tmp)
    request.addfinalizer(lambda: [p.kill() for p in procs
                                  if p.poll() is None])

    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    rng = jax.random.key(1)
    (_, jlosses), jgrads = jax.jit(jax.value_and_grad(
        _jax_loss_fn(jc, jb, rng), has_aux=True))(jparams)
    jgrads = jstate.mask_gradients(jgrads, jparams, jc.detector)
    jout = jax_detector_apply(jparams, jc.detector, jax_prep_images(
        jb["images"], True))
    jmask = _flat(jax.tree_util.tree_map(
        bool, jax_trainable_mask(jparams, jc.detector)))
    tx = jstate.make_optimizer(jc.optim, jc.detector, jparams)
    # The step donates its state: a copy of the params of its own.
    jstate0 = jstate.create_train_state(
        jax.tree_util.tree_map(jnp.asarray, tree), jc.optim, jc.detector)
    jnew, jmetrics = jax_make_train_step(jc, tx)(jstate0, jb, rng)

    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    single = pstate.create_train_state(params_from_numpy(tree, device="cpu"),
                                       pc.optim, pc.detector)
    with torch.no_grad():
        sfwd = detector_apply(single.params, pc.detector,
                              prep_images(tb["images"], True),
                              attn_impl="flash")
    slosses, sgrads = train_grads(pc, single, tb, attn_impl="flash")
    _, smetrics = make_train_step(pc)(single, tb)
    ranks = _rank_results(procs, tmp)
    return {
        "name": request.param, "dp": dp, "tp": tp, "backbone": backbone,
        "tree": tree, "batch": batch, "ranks": ranks,
        "jax": {"losses": jax.tree_util.tree_map(np.asarray, jlosses),
                "grads": _flat(jax.tree_util.tree_map(np.asarray, jgrads)),
                "metrics": jax.tree_util.tree_map(np.asarray, jmetrics),
                "params": _flat(jax.tree_util.tree_map(np.asarray,
                                                       jnew.params)),
                "forward": jax.tree_util.tree_map(np.asarray, jout),
                "mask": jmask},
        "single": {"forward": sfwd, "losses": slosses,
                   "grads": _flat(sgrads), "metrics": smetrics,
                   "params": _flat(params_to_numpy(single.params))},
    }


def _global(run, key):
    """A replicated per-rank output assembled over the data axis from the
    model index 0 ranks, after checking every model rank holds the same."""
    parts = {}
    for r in run["ranks"]:
        t = r[key]
        d = r["data_index"]
        if d in parts:
            for name in t:
                assert torch.equal(parts[d][name], t[name]), name
        else:
            parts[d] = t
    return {name: torch.cat([parts[d][name] for d in sorted(parts)])
            for name in parts[0]}


def _jax_spec_dims(tree, tp):
    """Per flattened leaf name: the dim JAX's param_shardings shards over
    'model' (None when replicated) and the JAX shard at each model index."""
    mesh = jax_create_mesh(model_parallel_size=tp)
    shard = param_shardings(tree, mesh)
    out = {}
    for (path, leaf), (_, sh) in zip(
            jax.tree_util.tree_flatten_with_path(tree)[0],
            jax.tree_util.tree_flatten_with_path(shard)[0]):
        name = ".".join(str(getattr(p, "key", getattr(p, "name", "")))
                        for p in path)
        dims = [i for i, a in enumerate(sh.spec) if a == "model"]
        placed = jax.device_put(leaf, sh)
        by_model = {}
        for s in placed.addressable_shards:
            m = int(np.argwhere(mesh.devices == s.device)[0][1])
            by_model[m] = np.asarray(s.data)
        out[name] = (dims[0] if dims else None, by_model)
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_shard_params_matches_jax_param_shardings(mesh_name):
    """Leaf by leaf, the port shards the dim JAX's `param_shardings` shards
    over 'model' (on the 8-device CPU mesh), and rank r's slice equals the
    JAX shard at model index r."""
    _, tp, backbone = MESHES[mesh_name]
    tree = _jax_tree(backbone)
    want = _jax_spec_dims(tree, tp)
    full = params_from_numpy(tree, device="cpu")
    paths = {".".join(p): p for p in psh.leaf_paths(full)}
    assert set(paths) == set(want)
    n_sharded = 0
    for r in range(tp):
        mesh = psh.Mesh(data_size=1, model_size=tp, data_index=0,
                        model_index=r, data_group=None, model_group=None,
                        backend="gloo")
        shards = _flat(psh.shard_params(full, mesh))
        for name, (dim, by_model) in want.items():
            d = psh.shard_dim(paths[name])
            leaf = shards[name]
            got = None if d is None else d % leaf.dim()
            assert got == dim, (name, got, dim)
            assert np.array_equal(leaf.numpy(), by_model[r]), (name, r)
            n_sharded += d is not None
    assert n_sharded > 20 * tp


def test_gather_params_round_trips(run):
    """Each rank holds its shard of the numpy tree, and gather_params gives
    the whole tree back on every rank."""
    want = _flat(run["tree"])
    for r in run["ranks"]:
        mesh = psh.Mesh(data_size=run["dp"], model_size=run["tp"],
                        data_index=r["data_index"],
                        model_index=r["model_index"], data_group=None,
                        model_group=None, backend="gloo")
        shards = _flat(psh.shard_params(
            params_from_numpy(run["tree"], device="cpu"), mesh))
        for name, t in _flat(r["shards"]).items():
            assert torch.equal(t, shards[name]), name
        got = _flat(r["gathered"])
        assert got.keys() == want.keys()
        for name, v in want.items():
            assert np.array_equal(got[name].numpy(), v), name


def test_tp_forward_matches_jax_and_single_process(run):
    """The eval forward on the mesh against JAX's and the port's single
    process; every block's attention takes B4f's plain version (no flat
    kernel: the rank's heads do not pair)."""
    depth = run["backbone"]["depth_override"]
    for r in run["ranks"]:
        assert r["forward_calls"] == {
            **dict.fromkeys(worker.PLAIN, 0),
            "flash_attention_allheads_fwd_plain": depth}
    out = _global(run, "forward")
    for key in ("pred_logits", "pred_boxes"):
        ref = run["jax"]["forward"][key]
        assert out[key].shape == ref.shape
        err = float(np.abs(ref - out[key].numpy()).max())
        assert err <= MODEL_TOL, (key, err)
        err = (out[key] - run["single"]["forward"][key]).abs().max().item()
        assert err <= PORT_TOL, (key, err)


def test_tp_train_step_matches_jax_and_single_process(run):
    """One step on the mesh: the loss terms (the global batch's; num_boxes
    summed over the data group), every trainable gradient gathered from
    the shards, the global norm of the shards and make_train_step's
    updated params, against JAX's and the port's single process; the
    adapted block's backward takes B4b's plain version once."""
    depth = run["backbone"]["depth_override"]
    jx, single = run["jax"], run["single"]
    for r in run["ranks"]:
        assert r["grad_calls"] == {
            **dict.fromkeys(worker.PLAIN, 0),
            "flash_attention_allheads_fwd_plain": depth,
            "flash_attention_allheads_bwd_plain": 1}
        for key in ("loss", "loss_ce", "loss_bbox", "loss_giou", "num_boxes"):
            assert _rel(jx["losses"][key], r["losses"][key]) <= LOSS_TOL, key
            assert _rel(single["losses"][key], r["losses"][key]) <= PORT_TOL
        assert float(r["losses"]["num_boxes"]) == float(
            run["batch"]["valid"].sum())
        for key in ("loss", "grad_norm", "num_boxes"):
            assert _rel(jx["metrics"][key], r["metrics"][key]) <= LOSS_TOL, key
            assert _rel(single["metrics"][key], r["metrics"][key]) <= PORT_TOL
        assert _rel(jx["metrics"]["grad_norm"], r["grad_norm"]) <= LOSS_TOL
        got = _flat(r["grads"])
        assert set(got) == set(single["grads"]) and len(got) > 40
        for k, g in got.items():
            assert _rel(jx["grads"][k], g) <= GRAD_TOL, (k, _rel(
                jx["grads"][k], g))
            assert _rel(single["grads"][k], g) <= PORT_TOL, k
            if k.endswith(("lora_A", "lora_B")):
                assert not g[0].any() and g[1].abs().sum() > 0, k
        new = _flat(r["stepped"])
        before = _flat(run["tree"])
        clip = min(1.0, 1.0 / float(jx["metrics"]["grad_norm"]))
        moved = 0
        for k, v in jx["params"].items():
            if not jx["mask"][k]:
                assert np.array_equal(new[k].numpy(), before[k]), k
                continue
            # What Adam's first step sees: the clipped gradient plus the
            # weight decay.
            g = np.abs(jx["grads"][k] * clip + WEIGHT_DECAY * before[k])
            clear = (g > GRAD_FLOOR * g.max()) & (g > GRAD_ABS_FLOOR)
            moved += int(clear.sum())
            assert np.abs(new[k].numpy() - v)[clear].max(
                initial=0.0) <= PARAM_TOL, k
            assert np.abs(new[k].numpy() - single["params"][k])[clear].max(
                initial=0.0) <= PARAM_TOL, k
        assert moved > 5_000


def test_dropout_under_tp_drops_what_one_process_drops(run):
    """Decoder dropout 0.1 from generators seeded alike on every rank: the
    masks over split activations are drawn whole and sliced, so the mesh's
    loss equals one process's with the same seed."""
    _, pc = _cfgs(run["backbone"], {**DECODER, "dropout": 0.1})
    state = pstate.create_train_state(
        params_from_numpy(run["tree"], device="cpu"), pc.optim, pc.detector)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in run["batch"].items()}
    ref, _ = train_grads(pc, state, tb, torch.Generator().manual_seed(5))
    no_drop = run["single"]["losses"]["loss"]
    assert abs(ref["loss"] - no_drop) > 1e-3  # the dropout does bite
    for r in run["ranks"]:
        for key in ("loss", "loss_ce", "loss_bbox", "loss_giou"):
            assert _rel(ref[key], r["dropout_losses"][key]) <= PORT_TOL, key


@pytest.mark.parametrize("tp", [2, 3, 4, 8])
def test_check_tp_compatible_matches_jax(tp):
    """The port accepts and refuses what JAX's check does, the SwiGLU FFN
    (ViT-g) and a context axis included; FSDP still raises as unported."""
    for backbone in (MESHES["2x2"][2], MESHES["1x4"][2]):
        jc, pc = _cfgs(backbone)
        try:
            jax_check_tp(jc.detector, tp)
            ok = True
        except ValueError:
            ok = False
        if ok:
            psh.check_tp_compatible(pc.detector, tp)
        else:
            with pytest.raises(ValueError):
                psh.check_tp_compatible(pc.detector, tp)
    giant = dict(variant="giant", target_dim=768)
    jgiant = jcfg.DetectorConfig(backbone=jcfg.BackboneConfig(**giant),
                                 decoder=jcfg.DecoderConfig())
    pgiant = pcfg.DetectorConfig(backbone=pcfg.BackboneConfig(**giant),
                                 decoder=pcfg.DecoderConfig())
    try:
        jax_check_tp(jgiant, tp)
        psh.check_tp_compatible(pgiant, tp)
    except ValueError:
        with pytest.raises(ValueError):
            psh.check_tp_compatible(pgiant, tp)
    assert jcfg.MeshConfig(context_parallel_size=2).context_parallel_size == 2
    assert pcfg.MeshConfig(context_parallel_size=2).context_size == 2
    with pytest.raises(NotImplementedError):
        pcfg.MeshConfig(fsdp=True)
