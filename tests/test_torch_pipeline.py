"""The port's pipeline schedule (dinov2_od_tpu_torch/parallel/pipeline.py)
against the JAX package's `pipeline_blocks` and a sequential loop, on the
CPU.

The blocks are JAX's test's affine tanh blocks (tests/test_pipeline_parallel.py:
x @ w_i + b_i, then tanh, fp32); the loss is sum(out ** 2) over the global
batch. The port's ranks are processes of a gloo group
(tests/torch_pp_worker.py, no JAX) on the legacy stage axis: GPipe over
2 stages (data 2 x stage 2 on a world of 4, so the batch is split too)
and over 4, the interleaved schedule over 4 stages at JAX's (chunks,
microbatches) pairs, and over one stage. JAX runs the same configurations on the suite's
8-device CPU mesh (data x model, the model axis the stages). Every
configuration runs with skipped and with computed bubbles.

A second world runs a pipeline whose first stages train nothing (the
blocks below `frozen_blocks`): those stages post no backward transfer,
and the stages after them must not wait for one. It runs under its own
short timeout, so a transfer posted on one side only fails this test
(its ranks killed) rather than hanging the suite.
"""

import ast
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinov2_od_tpu.parallel import create_mesh as jax_create_mesh
from dinov2_od_tpu.parallel import pipeline as jax_pipeline

from dinov2_od_tpu_torch import config as pcfg
from dinov2_od_tpu_torch.parallel import pipeline as ppipe
from dinov2_od_tpu_torch.parallel import sharding as psh

import torch_pp_worker as worker

# name: (stages, chunks, microbatches, depth, batch, x takes a gradient)
CASES = {
    "gpipe-p2": (2, 1, 2, 8, 8, True),
    "gpipe-p4": (4, 1, 2, 8, 4, True),
    "interleaved-v2-m4": (4, 2, 4, 16, 16, False),
    "interleaved-v2-m8": (4, 2, 8, 16, 16, True),
    "interleaved-v4-m4": (4, 4, 4, 16, 16, False),
    # One stage (data 4 x stage 1): the wrap to stage 0 is to itself.
    "one-stage-v2": (1, 2, 2, 8, 16, True),
}
WORLD = 4
WIDTH = 16
# JAX's test's tolerances against the sequential scan: forward 1e-6,
# gradients 2e-5 (absolute).
FWD_TOL = 1e-6
GRAD_TOL = 2e-5
# The frozen world: 4 stages x 2 chunks of 2 blocks, 4 microbatches, the
# first 10 of 16 blocks frozen: stage 0 holds chunks 0 and 4, all frozen;
# only chunk 5 (stage 1's second) and chunks 6-7 train.
FROZEN = ("frozen", 4, 2, 4, 16, 10)
FROZEN_TIMEOUT = 90


def _inputs(depth, batch, seed):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(depth, WIDTH, WIDTH)) * 0.1).astype(np.float32)
    b = (rng.normal(size=(depth, WIDTH)) * 0.1).astype(np.float32)
    x = rng.normal(size=(batch, WIDTH)).astype(np.float32)
    return w, b, x


def _mesh(stages):
    return dict(model_parallel_size=stages, pipeline_parallel=True)


def _job(name, stages, chunks, micro, depth, batch, x_grad, frozen=0):
    w, b, x = _inputs(depth, batch, seed=depth + stages + chunks + micro)
    return dict(kind="blocks", name=name, mesh=_mesh(stages), w=w, b=b, x=x,
                microbatches=micro, chunks=chunks, x_grad=x_grad,
                frozen=frozen, skip=(True, False))


def _sequential(job):
    """The blocks in order on the whole batch, the first `frozen` blocks'
    params cut from the gradient: (out, grads)."""
    fz = job["frozen"]
    w = torch.from_numpy(job["w"]).requires_grad_()
    b = torch.from_numpy(job["b"]).requires_grad_()
    x = torch.from_numpy(job["x"]).requires_grad_(job["x_grad"])
    h = x
    for i in range(w.shape[0]):
        wi, bi = (w[i], b[i]) if i >= fz else (w[i].detach(), b[i].detach())
        h = torch.tanh(h @ wi + bi)
    (h ** 2).sum().backward()
    grads = {"w": w.grad, "b": b.grad}
    if job["x_grad"]:
        grads["x"] = x.grad
    return h.detach(), grads


def _jax(job, stages):
    """JAX's pipeline_blocks on the 8-device mesh over the model axis:
    (out, grads)."""
    mesh = jax_create_mesh(model_parallel_size=stages)
    params = {"w": jnp.asarray(job["w"]), "b": jnp.asarray(job["b"])}
    x = jnp.asarray(job["x"])

    def block_fn(c, p):
        return jnp.tanh(c @ p["w"] + p["b"]), None

    def loss(params, x):
        out = jax_pipeline.pipeline_blocks(
            x, params, block_fn, mesh, "model", job["microbatches"],
            num_chunks=job["chunks"])
        return jnp.sum(out ** 2), out

    (_, out), (g, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                           has_aux=True)(params, x)
    grads = {k: np.asarray(v) for k, v in g.items()}
    if job["x_grad"]:
        grads["x"] = np.asarray(gx)
    return np.asarray(out), grads


def _assemble(results, skip, key):
    """A per-rank output over the data axis (its stages agreeing
    exactly)."""
    parts = {}
    for r in results:
        t = r[skip][key] if key == "out" else r[skip]["grads"][key]
        d = r["data_index"]
        if d in parts:
            assert torch.equal(parts[d], t), key
        parts[d] = t
    return torch.cat([parts[d] for d in sorted(parts)])


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    jobs = {name: _job(name, *case) for name, case in CASES.items()}
    ranks = worker.start(list(jobs.values()), WORLD,
                         tmp_path_factory.mktemp("pipeline"))
    try:
        refs = {name: {"seq": _sequential(job),
                       "jax": _jax(job, CASES[name][0])}
                for name, job in jobs.items()}
        results = worker.results(ranks)
    finally:
        ranks.kill()
    return {"jobs": jobs, "refs": refs, "results": results}


@pytest.mark.parametrize("name", list(CASES))
def test_pipeline_matches_jax_and_sequential(run, name):
    """Forward and gradients (w, b, and x where it takes one), the data
    ranks' rows put together, against JAX's pipeline and the sequential
    loop."""
    res = [r[name] for r in run["results"]]
    seq_out, seq_grads = run["refs"][name]["seq"]
    jax_out, jax_grads = run["refs"][name]["jax"]
    out = _np(_assemble(res, True, "out"))
    assert out.shape == jax_out.shape
    assert np.abs(out - jax_out).max() <= FWD_TOL
    assert np.abs(out - _np(seq_out)).max() <= FWD_TOL
    keys = ["w", "b"] + (["x"] if CASES[name][5] else [])
    for k in keys:
        got = _np(_assemble(res, True, k) if k == "x"
                  else res[0][True]["grads"][k])
        assert np.abs(got - jax_grads[k]).max() <= GRAD_TOL, k
        assert np.abs(got - _np(seq_grads[k])).max() <= GRAD_TOL, k
        for r in res[1:]:
            if k != "x":
                assert torch.equal(r[True]["grads"][k],
                                   res[0][True]["grads"][k]), k


@pytest.mark.parametrize("name", list(CASES))
def test_skipped_bubbles_equal_computed_ones(run, name):
    """Skipping the bubble ticks (the port's main path) gives the values
    of computing and shipping them (JAX's dataflow), bit for bit, on
    every rank."""
    for r in run["results"]:
        res = r[name]
        assert torch.equal(res[True]["out"], res[False]["out"])
        for k, g in res[True]["grads"].items():
            assert torch.equal(g, res[False]["grads"][k]), k


def test_each_stage_computes_its_own_blocks_gradient(run):
    """Before the stage sum, a rank's gradient of the stacked leaves is
    nonzero at its own blocks only: stage p's chunks {p, P + p, ...}
    under the interleaved schedule."""
    name = "interleaved-v2-m4"
    stages, chunks, _, depth, _, _ = CASES[name]
    for r in run["results"]:
        res = r[name]
        mine = sorted(i for c in ppipe.stage_chunks(depth, stages, chunks,
                                                    res["stage_index"])
                      for i in c)
        cd = depth // (stages * chunks)
        want = [i // cd % stages == res["stage_index"] for i in range(depth)]
        assert [i for i, own in enumerate(want) if own] == mine
        assert res[True]["own_rows"]["w"] == want


def _mock_mesh(stages, data=1):
    return psh.Mesh(data_size=data, model_size=1, data_index=0,
                    model_index=0, data_group=None, model_group=None,
                    backend="gloo", cfg=pcfg.MeshConfig(**_mesh(stages)),
                    stage_size=stages, stage_ranks=tuple(range(stages)))


ERRORS = [  # (stages, depth, batch, microbatches, chunks)
    (4, 8, 8, 4, 0),    # num_chunks < 1
    (4, 6, 8, 4, 1),    # depth not divisible by stages x chunks
    (4, 16, 8, 2, 2),   # interleaved microbatches not divisible by stages
    (2, 8, 8, 4, 1),    # batch not divisible by data shards x microbatches
]


@pytest.mark.parametrize("stages, depth, batch, micro, chunks", ERRORS)
def test_schedule_errors_are_jaxs(stages, depth, batch, micro, chunks):
    """The configurations JAX's pipeline refuses, refused with its
    ValueError text (the batch check names the global batch: JAX's data
    shards are the mesh's 8 / stages, the port's here the same)."""
    data = 8 // stages
    jmesh = jax_create_mesh(model_parallel_size=stages)
    fn = lambda c, p: (c @ p["w"], None)
    with pytest.raises(ValueError) as want:
        jax_pipeline.pipeline_blocks(
            jnp.zeros((batch, 4)), {"w": jnp.zeros((depth, 4, 4))}, fn,
            jmesh, "model", micro, num_chunks=chunks)
    with pytest.raises(ValueError) as got:
        ppipe.pipeline_blocks(
            torch.zeros((batch // data, 4)), {"w": torch.zeros((depth, 4, 4))},
            lambda h, p: h @ p["w"], _mock_mesh(stages, data), micro,
            num_chunks=chunks)
    assert str(got.value) == str(want.value)


def _jax_permutation():
    """The lambda JAX's `pipeline_blocks` maps over the stacked leaves
    under the interleaved schedule (parallel/pipeline.py), taken from its
    source as it stands."""
    tree = ast.parse(inspect.getsource(jax_pipeline.pipeline_blocks))
    lam = next(n for n in ast.walk(tree) if isinstance(n, ast.Lambda)
               and "moveaxis" in ast.dump(n))
    return compile(ast.Expression(lam), "jax_pipeline", "eval")


@pytest.mark.parametrize("stages, chunks", [(2, 2), (4, 2), (4, 3), (2, 6)])
def test_interleave_permutation_is_jaxs(stages, chunks):
    """`interleave_chunks` against JAX's permutation of the stack, leaf
    for leaf, on a tree of leaves of several shapes; and each stage's
    rows of it are the global chunks {p, P + p, ...}."""
    code = _jax_permutation()
    depth = 24
    cd = depth // (stages * chunks)
    rng = np.random.default_rng(stages * 10 + chunks)
    tree = {"a": rng.normal(size=(depth, 3, 2)).astype(np.float32),
            "b": {"c": rng.normal(size=(depth,)).astype(np.float32),
                  "d": rng.normal(size=(depth, 5)).astype(np.float32)}}
    env = {"jnp": jnp, "v": chunks, "n_stages": stages, "cd": cd,
           "depth": depth}
    perm = eval(code, env)
    got = ppipe.interleave_chunks(
        jax.tree_util.tree_map(torch.from_numpy, tree), stages, chunks)
    want = jax.tree_util.tree_map(lambda a: np.asarray(perm(jnp.asarray(a))),
                                  tree)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert np.array_equal(g.numpy(), w)
    for p in range(stages):
        assert ppipe.stage_chunks(depth, stages, chunks, p) == [
            list(range((c * stages + p) * cd, (c * stages + p + 1) * cd))
            for c in range(chunks)]


def test_frozen_stages_post_no_backward_and_nobody_waits(tmp_path):
    """The first 10 of 16 blocks frozen and the input taking no gradient
    (the backbone's frozen prefix): stage 0's chunks all frozen, stage 1's
    first too. The stages after them must not wait for a cotangent they
    never send: the world ends within FROZEN_TIMEOUT (a hang fails here,
    its ranks killed), and the gradients equal the sequential loop's with
    the frozen rows cut, zero at the frozen rows."""
    name, stages, chunks, micro, depth, frozen = FROZEN
    job = _job(name, stages, chunks, micro, depth, 16, False, frozen=frozen)
    ranks = worker.start([job], WORLD, tmp_path, timeout=FROZEN_TIMEOUT)
    try:
        _, seq_grads = _sequential(job)
        results = worker.results(ranks)
    finally:
        ranks.kill()
    for r in results:
        res = r[name]
        for skip in (True, False):
            for k in ("w", "b"):
                g = res[skip]["grads"][k]
                assert np.abs(_np(g) - _np(seq_grads[k])).max() <= GRAD_TOL
                assert not g[:frozen].any()
        if res["stage_index"] == 0:
            assert not any(res[True]["own_rows"]["w"])
