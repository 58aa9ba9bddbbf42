"""Ring attention in the port (dinov2_od_tpu_torch/ops/ring_attention.py)
against the JAX package's `ring_attention`, on the CPU.

The port's ranks are processes joined in a gloo process group
(tests/torch_cp_worker.py, which imports no JAX), four of them, started
once for the module; each holds its shard of global q, k, v [2, 64, 4, 64]
fp32 (its ring's rows, and under CP x TP its model index's heads), runs
the ring and the gradient of the sum of squares of the output's real
rows. The references run while they do: JAX's `ring_attention` on four
devices of the 8-device CPU mesh with the same impl (its flash impl in
Pallas interpret mode), and plain attention over the real tokens
(`_xla_attention`).

Meshes: a ring of 4 on the three-axis mesh (context 4); the legacy mode's
ring over the model axis (model 4); CP 2 x TP 2, the ring over each head
shard. valid_len 40 of 64 puts a straddling shard (kv_len 8) and a fully
masked one on the ring, valid_len 48 a fully masked one with no
straddling shard.

Tolerances are JAX's own (tests/test_ring_attention.py): outputs 2e-5,
gradients 5e-5, fp32.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from dinov2_od_tpu.config import MeshConfig as JaxMeshConfig
from dinov2_od_tpu.ops.attention import _xla_attention
from dinov2_od_tpu.ops.ring_attention import ring_attention as jax_ring
from dinov2_od_tpu.parallel import create_mesh as jax_create_mesh

from dinov2_od_tpu_torch.ops.attention import multi_head_attention
from dinov2_od_tpu_torch.parallel.sharding import Mesh

import torch_cp_worker as worker

OUT_TOL, GRAD_TOL = 2e-5, 5e-5
B, S, H, DH = 2, 64, 4, 64
SCALE = DH ** -0.5
WORLD = 4
# case: (the port's MeshConfig fields, valid_len, impls)
CASES = {
    "cp4": (dict(context_parallel_size=4), None, ("flash", "blockwise")),
    "cp4_valid40": (dict(context_parallel_size=4), 40,
                    ("flash", "blockwise")),
    "cp4_valid48": (dict(context_parallel_size=4), 48,
                    ("flash", "blockwise")),
    "legacy4": (dict(model_parallel_size=4, context_parallel=True), None,
                ("flash",)),
    "cp2tp2": (dict(model_parallel_size=2, context_parallel_size=2), 40,
               ("flash", "blockwise")),
}
RUNS = [(c, impl) for c, (_, _, impls) in CASES.items() for impl in impls]
BLOCK = 5  # the blockwise loop's sub-block: 16-key shards -> 4 x 5, padded


def _qkv(valid_len):
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(B, S, H, DH)).astype(np.float32)
               for _ in range(3))
    if valid_len is not None:
        for x in (q, k, v):
            x[:, valid_len:] = 0.0  # the pad, as the backbone pads
    return q, k, v


def _jax_ring(case, impl):
    """JAX's ring on 4 devices: (out, (dq, dk, dv)) of the real rows'
    sum of squares."""
    mesh_kw, valid, _ = CASES[case]
    devices = jax.devices()[:WORLD]
    if "context_parallel_size" in mesh_kw:
        tp = mesh_kw.get("model_parallel_size", 1)
        mesh = jax_create_mesh(tp, devices=devices, cfg=JaxMeshConfig(
            model_parallel_size=tp,
            context_parallel_size=mesh_kw["context_parallel_size"]))
        spec, axis, heads = P(None, "context", "model", None), "context", \
            "model"
    else:
        mesh = jax_create_mesh(1, devices=devices)
        spec, axis, heads = P(None, "data", None, None), "data", None
    real = S if valid is None else valid

    def loss(q, k, v):
        o = jax_ring(q, k, v, scale=SCALE, mesh=mesh, axis=axis,
                     head_axis=heads, valid_len=valid, impl=impl,
                     interpret=True, block_size=BLOCK)
        return jnp.sum(o[:, :real] ** 2), o

    sh = NamedSharding(mesh, spec)
    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
            *(jax.device_put(jnp.asarray(x), sh) for x in _qkv(valid)))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _plain(valid):
    """Plain attention over the real tokens, padded back to S (zeros)."""
    real = S if valid is None else valid
    q, k, v = (jnp.asarray(x[:, :real]) for x in _qkv(valid))

    def loss(q, k, v):
        o = _xla_attention(q, k, v, SCALE)
        return jnp.sum(o ** 2), o

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(q, k, v)
    pad = ((0, 0), (0, S - real), (0, 0), (0, 0))
    return (np.pad(np.asarray(out), pad),
            [np.pad(np.asarray(g), pad) for g in grads])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The ranks' results of every run, beside JAX's ring and plain
    attention."""
    jobs = []
    for case, impl in RUNS:
        mesh_kw, valid, _ = CASES[case]
        q, k, v = _qkv(valid)
        jobs.append(dict(name=f"{case}-{impl}", kind="ring", mesh=mesh_kw,
                         q=q, k=k, v=v, valid_len=valid, impl=impl,
                         scale=SCALE, block_size=BLOCK))
    jobs.append(dict(name="collectives", kind="collectives",
                     mesh=dict(context_parallel_size=WORLD)))
    tmp = tmp_path_factory.mktemp("ring")
    procs = worker.start_ranks(jobs, WORLD, tmp)
    try:
        refs = {run: _jax_ring(*run) for run in RUNS}
        plain = {case: _plain(CASES[case][1]) for case in CASES}
        ranks = worker.rank_results(procs, tmp)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return {"ranks": ranks, "jax": refs, "plain": plain}


def _assemble(ranks, name, get):
    """A global [B, S, H, DH] array from the ranks' local pieces (rows by
    context index, heads by model index)."""
    out = np.zeros((B, S, H, DH), np.float32)
    for r in ranks:
        res = r[name]
        t = get(res).detach().float().numpy()
        w, hl = t.shape[1], t.shape[2]
        c, m = res["context_index"], res["model_index"]
        out[:, c * w:(c + 1) * w, m * hl:(m + 1) * hl] = t
    return out


@pytest.mark.parametrize("case,impl", RUNS, ids=[f"{c}-{i}" for c, i in RUNS])
def test_ring_matches_jax(run, case, impl):
    """Forward and gradients of the port's ring against JAX's ring with the
    same impl and against plain attention over the real tokens; the pad's
    keys and values get exactly zero gradients."""
    name = f"{case}-{impl}"
    valid = CASES[case][1]
    real = S if valid is None else valid
    j_out, j_grads = run["jax"][(case, impl)]
    p_out, p_grads = run["plain"][case]
    out = _assemble(run["ranks"], name, lambda r: r["out"])
    np.testing.assert_allclose(out[:, :real], j_out[:, :real],
                               rtol=OUT_TOL, atol=OUT_TOL)
    np.testing.assert_allclose(out[:, :real], p_out[:, :real],
                               rtol=OUT_TOL, atol=OUT_TOL)
    for i in range(3):
        g = _assemble(run["ranks"], name, lambda r, i=i: r["grads"][i])
        np.testing.assert_allclose(g, j_grads[i], rtol=GRAD_TOL,
                                   atol=GRAD_TOL)
        np.testing.assert_allclose(g, p_grads[i], rtol=GRAD_TOL,
                                   atol=GRAD_TOL)
        if i and valid is not None:
            assert not g[:, valid:].any()


@pytest.mark.parametrize("case", ["cp4", "cp4_valid40", "cp4_valid48",
                                  "cp2tp2"])
def test_flash_ring_launches_once_a_step_and_skips_masked_shards(run, case):
    """The flash impl makes one forward call a ring step with a valid key
    (the flat family's plain version at these shapes: heads pair into
    128 lanes), and in the backward one recomputed forward and one
    backward a step; a step whose shard lies wholly past valid_len makes
    none (the shard of keys 48-63 at valid_len 40 and 48)."""
    mesh_kw, valid, _ = CASES[case]
    n = mesh_kw["context_parallel_size"]
    w = S // n
    live = sum(1 for src in range(n) if valid is None or src * w < valid)
    zero = dict.fromkeys(worker.PLAIN, 0)
    for r in run["ranks"]:
        res = r[f"{case}-flash"]
        assert res["fwd_calls"] == {**zero,
                                    "flash_attention_fwd_plain": live}
        assert res["bwd_calls"] == {**zero,
                                    "flash_attention_fwd_plain": live,
                                    "flash_attention_bwd_plain": live}


def test_ring_shift_and_token_collectives(run):
    """ring_shift hands each rank its predecessor's tensor (offset -1 its
    successor's, bf16 exactly); shard_tokens keeps the rank's rows and
    gather_tokens concatenates them in ring order; the gather's gradient
    is this rank's rows of the cotangent, not their sum over the ring."""
    for r in run["ranks"]:
        res = r["collectives"]
        i = res["context_index"]
        assert torch.equal(res["next"], torch.full((2, 3), (i - 1) % WORLD))
        assert torch.equal(res["prev"], torch.full((2, 3), (i + 1) % WORLD))
        assert res["bf16"].dtype == torch.bfloat16
        assert torch.equal(res["bf16"].float(), res["next"])
        x = torch.arange(2 * 8 * 3, dtype=torch.float32).reshape(2, 8, 3)
        assert torch.equal(res["part"], x[:, 2 * i:2 * i + 2])
        scale = torch.arange(1.0, WORLD + 1).repeat_interleave(2)
        assert torch.equal(res["whole"], x * scale[None, :, None])
        want = torch.zeros_like(x)
        want[:, 2 * i:2 * i + 2] = (i + 1.0) * torch.arange(
            2.0 * i, 2.0 * i + 2)[None, :, None]
        assert torch.equal(res["x_grad"], want)


def test_ring_entry_checks_match_jax():
    """multi_head_attention(impl='ring') refuses what JAX's refuses, with
    its messages: no mesh or seq_axis, attention dropout, Sq != Sk; and
    ring_attention refuses an axis that is not the mesh's ring and an
    unknown impl."""
    from dinov2_od_tpu_torch.config import MeshConfig
    from dinov2_od_tpu_torch.ops.ring_attention import ring_attention

    q = torch.zeros(1, 8, 2, DH)
    mesh = Mesh(data_size=1, model_size=1, data_index=0, model_index=0,
                data_group=None, model_group=None, backend="gloo",
                cfg=MeshConfig(context_parallel_size=2), context_size=2)
    with pytest.raises(ValueError, match="requires mesh and seq_axis"):
        multi_head_attention(q, q, q, impl="ring")
    with pytest.raises(ValueError, match="requires mesh and seq_axis"):
        multi_head_attention(q, q, q, impl="ring", mesh=mesh)
    with pytest.raises(ValueError, match="dropout"):
        multi_head_attention(q, q, q, impl="ring", mesh=mesh,
                             seq_axis="context", dropout_rate=0.1,
                             generator=torch.Generator())
    with pytest.raises(ValueError, match="self-attention shapes only"):
        multi_head_attention(q, q[:, :4], q[:, :4], impl="ring", mesh=mesh,
                             seq_axis="context")
    assert mesh.seq_axis == "context"
    with pytest.raises(ValueError, match="ring runs over"):
        ring_attention(q, q, q, scale=SCALE, mesh=mesh, axis="model")
    with pytest.raises(ValueError, match="unknown ring attention impl"):
        ring_attention(q, q, q, scale=SCALE, mesh=mesh, impl="xla")
