"""The port's multi-process start-up and the pieces of the loop that a
mesh of processes changes, on the CPU:

- `initialize_multihost` (dinov2_od_tpu_torch/parallel/multihost.py): a
  no-op in one process, a one-rank world from the explicit arguments and
  from the launcher's environment, its errors, and the backend choice;
- `auto_mesh` (parallel/sharding.py): each rank's place at six layouts
  on a world of 4, and its two errors with their messages;
- `DataLoader(process_count, process_id)` against the JAX package's on
  the same dataset, and `host_shard_indices` against JAX's split;
- on 4 gloo ranks (tests/torch_multihost_worker.py, started with the
  environment `torchrun` sets): `sharded_batch_gather` bit-equal to the
  replicated layout's gather for random global indices, uint8 images
  included, at data 2 x model 2 and data 2 x context 2; and a checkpoint
  saved on the 2 x 2 mesh holding the logical trees bit for bit, and
  restoring each rank's shards bit for bit.
"""

import pickle
import types

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from dinov2_od_tpu.data.loader import DataLoader as JaxLoader
from dinov2_od_tpu.parallel import multihost as jmultihost

from dinov2_od_tpu_torch import config as pcfg
from dinov2_od_tpu_torch.data.loader import DataLoader
from dinov2_od_tpu_torch.models.detector import (init_detector_params,
                                                 trainable_mask)
from dinov2_od_tpu_torch.parallel import multihost
from dinov2_od_tpu_torch.parallel.sharding import auto_mesh
from dinov2_od_tpu_torch.train.state import tree_map

from torch_ranks import Ranks, free_port

WORLD = 4
# name: (global batch, model_parallel, context_parallel_size, legacy ring)
LAYOUTS = {"dp4": (4, 1, 0, False), "dp2 x tp2": (4, 2, 0, False),
           "tp4": (4, 4, 0, False), "dp2 x cp2": (4, 1, 2, False),
           "cp2 x tp2": (4, 2, 2, False), "legacy ring 2": (4, 2, 0, True)}
# Each rank's (data, context, model sizes; data, context, model index).
PLACES = {
    "dp4": lambda r: (4, 1, 1, r, 0, 0),
    "dp2 x tp2": lambda r: (2, 1, 2, r // 2, 0, r % 2),
    "tp4": lambda r: (1, 1, 4, 0, 0, r),
    "dp2 x cp2": lambda r: (2, 2, 1, r // 2, r % 2, 0),
    "cp2 x tp2": lambda r: (1, 2, 2, 0, r // 2, r % 2),
    "legacy ring 2": lambda r: (2, 2, 1, r // 2, r % 2, 0),
}
BACKBONE = dict(variant="small", image_size=56, hidden_dim_override=128,
                num_heads_override=2, depth_override=3, lora_r=2,
                lora_last_n_blocks=2, target_dim=64)
DECODER = dict(hidden_dim=64, num_queries=8, num_layers=2, num_heads=4,
               dim_feedforward=96, num_classes=6, dropout=0.0)


@pytest.fixture
def one_process_world():
    """Whatever a test starts, destroyed after it: the suite's worker
    process goes on without a world."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_initialize_multihost_is_a_noop_in_one_process(monkeypatch):
    assert multihost.initialize_multihost(device="cpu") == torch.device(
        "cpu")
    assert not multihost.started()
    assert (multihost.process_count(), multihost.process_index()) == (1, 0)
    multihost.barrier()  # no world: returns at once
    # No fallback to the CPU: --device cuda without a card raises.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        multihost.initialize_multihost(device="cuda")


def test_initialize_multihost_from_explicit_arguments(one_process_world):
    dev = multihost.initialize_multihost(
        coordinator_address=f"127.0.0.1:{free_port()}", num_processes=1,
        process_id=0, device="cpu")
    assert dev == torch.device("cpu") and multihost.started()
    assert dist.get_backend() == "gloo"
    assert (dist.get_world_size(), dist.get_rank()) == (1, 0)
    # A second call returns at once: the world is started.
    assert multihost.initialize_multihost(
        coordinator_address="127.0.0.1:1", num_processes=1, process_id=0,
        device="cpu") == dev


def test_initialize_multihost_from_the_launchers_environment(
        monkeypatch, one_process_world):
    for key, value in dict(RANK=0, WORLD_SIZE=1, MASTER_ADDR="127.0.0.1",
                           MASTER_PORT=free_port(), LOCAL_RANK=0).items():
        monkeypatch.setenv(key, str(value))
    assert multihost.initialize_multihost(auto=True, device="cpu") == (
        torch.device("cpu"))
    assert (multihost.process_count(), multihost.process_index()) == (1, 0)


@pytest.mark.parametrize("kwargs, match", [
    (dict(coordinator_address="127.0.0.1:1", num_processes=2),
     "go together"),
    (dict(num_processes=2, process_id=0), "go together"),
    (dict(auto=True), "torchrun"),
])
def test_initialize_multihost_refuses_half_a_rendezvous(kwargs, match,
                                                        monkeypatch):
    for key in multihost.LAUNCHER_ENV:
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(ValueError, match=match):
        multihost.initialize_multihost(device="cpu", **kwargs)
    assert not multihost.started()


@pytest.mark.parametrize("device, local_world, cards, want", [
    ("cpu", 4, 0, "gloo"), ("cuda", 4, 1, "gloo"), ("cuda", 4, 4, "nccl"),
    ("cuda", 8, 4, "gloo"), ("cuda", 1, 1, "nccl")])
def test_backend_is_nccl_only_with_a_card_a_rank(device, local_world, cards,
                                                 want, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert multihost.choose_backend(torch.device(device),
                                    local_world) == want


@pytest.mark.parametrize("world, batch, mp, cp, match", [
    (4, 8, 3, 0, "a world of 4 processes does not divide into the mesh "
                 r"data D x model 3 \(--model_parallel 3"),
    (4, 3, 2, 0, r"--batch_size 3 is not divisible by the data axis of the "
                 r"mesh data 2 x model 2 \(4 processes\)"),
    (8, 6, 1, 2, r"--batch_size 6 is not divisible by the data axis of the "
                 r"mesh data 4 x context 2 x model 1"),
    (1, 2, 2, 0, "a world of 1 processes does not divide"),
])
def test_auto_mesh_refuses_what_does_not_divide(world, batch, mp, cp, match,
                                                monkeypatch):
    monkeypatch.setattr(multihost, "process_count", lambda: world)
    with pytest.raises(ValueError, match=match):
        auto_mesh(batch, mp, pcfg.MeshConfig(model_parallel_size=mp,
                                             context_parallel_size=cp))


def test_auto_mesh_is_none_in_one_process():
    assert auto_mesh(8, 1, pcfg.MeshConfig()) is None


class _Examples:
    """A dataset whose examples name their index."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def get_example(self, i):
        return {"images": np.full((2, 2, 3), i, np.uint8),
                "image_id": np.int64(1000 + i)}


@pytest.mark.parametrize("n, batch, pc, shuffle, drop_last", [
    (10, 4, 2, True, True), (10, 4, 2, False, False),
    (11, 4, 4, True, False), (9, 6, 3, False, False)])
def test_loader_slices_match_jax(n, batch, pc, shuffle, drop_last):
    """Each process's rows of every batch, and `_local_n` on a ragged
    last batch, as the JAX loader gives them; the union of the processes'
    real rows is one process's batch."""
    ds = _Examples(n)
    for pid in range(pc):
        kw = dict(shuffle=shuffle, seed=3, drop_last=drop_last,
                  num_workers=2, process_count=pc, process_id=pid)
        got = list(DataLoader(ds, batch, **kw))
        want = list(JaxLoader(ds, batch, **kw))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert set(g) == set(w) == {"images", "image_id", "_local_n"}
            for k in g:
                assert np.array_equal(g[k], w[k]), k
    one = list(DataLoader(ds, batch, shuffle=shuffle, seed=3,
                          drop_last=drop_last))
    per = [list(DataLoader(ds, batch, shuffle=shuffle, seed=3,
                           drop_last=drop_last, process_count=pc,
                           process_id=p)) for p in range(pc)]
    for b, whole in enumerate(one):
        ids = np.concatenate([p[b]["image_id"][:int(p[b]["_local_n"])]
                              for p in per])
        assert sorted(ids) == sorted(whole["image_id"])
    with pytest.raises(ValueError, match="divide evenly"):
        DataLoader(ds, 5, process_count=2)


@pytest.mark.parametrize("n, d", [(103, 4), (8, 8), (7, 3), (5, 8)])
def test_host_shard_indices_match_jax(n, d, monkeypatch):
    for i in range(d):
        monkeypatch.setattr(jax, "process_count", lambda: d)
        monkeypatch.setattr(jax, "process_index", lambda i=i: i)
        mesh = types.SimpleNamespace(data_size=d, data_index=i)
        assert np.array_equal(multihost.host_shard_indices(n, mesh),
                              jmultihost.host_shard_indices(n))
    assert np.array_equal(multihost.host_shard_indices(n), np.arange(n))


def _trees():
    """Logical params, Adam moments and EMA of the tiny detector, every
    leaf drawn (the EMA's frozen leaves 0-dim placeholders, as
    train/state.py `init_ema` makes them), and zero templates."""
    det = pcfg.DetectorConfig(backbone=pcfg.BackboneConfig(**BACKBONE),
                              decoder=pcfg.DecoderConfig(**DECODER))
    params = init_detector_params(torch.Generator().manual_seed(0), det,
                                  device="cpu")
    mask = trainable_mask(params, det)
    gen = torch.Generator().manual_seed(1)

    def drawn(p, m):
        return torch.randn(p.shape, generator=gen) if m else None

    trees = {"params": tree_map(lambda p: p + torch.randn(
        p.shape, generator=gen), params),
        "mu": tree_map(drawn, params, mask),
        "nu": tree_map(lambda p, m: (drawn(p, m).abs() if m else None),
                       params, mask),
        "ema": tree_map(lambda p, m: (drawn(p, m) if m
                                      else torch.zeros(())), params, mask)}
    zeros = {k: tree_map(torch.zeros_like, trees[k])
             for k in ("mu", "nu", "ema")}
    return trees, zeros


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multihost")
    rng = np.random.default_rng(0)
    arrays = {"images": rng.integers(0, 256, (10, 8, 8, 3), np.uint8),
              "boxes": rng.random((10, 6, 4), np.float32),
              "labels": rng.integers(0, 91, (10, 6)).astype(np.int64),
              "valid": rng.random((10, 6)) < 0.5}
    indices = [rng.choice(10, 4, replace=False) for _ in range(6)]
    trees, zeros = _trees()
    inputs = tmp / "inputs.pkl"
    with open(inputs, "wb") as f:
        pickle.dump({"layouts": LAYOUTS, "arrays": arrays,
                     "indices": indices, "trees": trees, "zeros": zeros,
                     "ckpt_dir": str(tmp / "ckpt")}, f)
    world = Ranks(
        lambda r, port: ["tests/torch_multihost_worker.py", inputs, tmp],
        WORLD, tmp,
        env=lambda r, port: dict(RANK=str(r), WORLD_SIZE=str(WORLD),
                                 MASTER_ADDR="127.0.0.1",
                                 MASTER_PORT=str(port), LOCAL_RANK=str(r)))
    world.wait()
    return {"ranks": [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                      for r in range(WORLD)],
            "arrays": arrays, "indices": indices, "trees": trees,
            "file": torch.load(tmp / "ckpt" / "checkpoint_epoch_0" /
                               "state.pt", weights_only=True)}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_auto_mesh_places_each_rank(ranks, name):
    for r, res in enumerate(ranks["ranks"]):
        assert res["places"][name] == PLACES[name](r), (name, r)


@pytest.mark.parametrize("name", ["dp2 x tp2", "dp2 x cp2"])
def test_sharded_gather_equals_the_replicated_one(ranks, name):
    """Each rank's slice of each global batch, from the cache's rows it
    holds (5 of 10: its data index's half), is the replicated layout's to
    the bit and the numpy rows of its contiguous share; the tensor- and
    context-parallel peers of a data rank hold and gather the same."""
    arrays = ranks["arrays"]
    for r, res in enumerate(ranks["ranks"]):
        g = res["gathers"][name]
        d = r // 2
        assert g["rows"] == 5
        for idx, sh, rep in zip(ranks["indices"], g["sharded"],
                                g["replicated"]):
            for k, want in arrays.items():
                assert sh[k].dtype == rep[k].dtype
                assert torch.equal(sh[k], rep[k]), (k, r)
                assert np.array_equal(sh[k].numpy(),
                                      want[idx[2 * d:2 * d + 2]]), (k, r)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        elif v is not None:
            out[prefix + k] = v
    return out


def test_checkpoint_on_a_2x2_mesh_holds_the_logical_trees(ranks):
    """The file that rank 0 wrote after the gather holds the logical
    params, moments and EMA bit for bit (what one process saves), and
    every rank's restore, cut into shards again, equals its shards."""
    saved = ranks["file"]
    for key, tree in (("params", saved["params"]),
                      ("mu", saved["opt_state"]["mu"]),
                      ("nu", saved["opt_state"]["nu"]),
                      ("ema", saved["ema"])):
        want = _flat(ranks["trees"][key])
        got = _flat(tree)
        assert got.keys() == want.keys()
        for path in want:
            assert torch.equal(got[path], want[path]), (key, path)
    assert (saved["opt_state"]["count"], saved["step"]) == (3, 7)
    for r, res in enumerate(ranks["ranks"]):
        assert res["place"] == (r // 2, r % 2)
        assert res["restored"]["count"] == 3
        for key in ("params", "mu", "nu", "ema"):
            a, b = _flat(res["shards"][key]), _flat(res["restored"][key])
            assert a.keys() == b.keys()
            for path in a:
                assert torch.equal(a[path], b[path]), (r, key, path)
        # The ranks of a model group hold different halves of a sharded
        # leaf.
        q = _flat(res["shards"]["params"])["backbone/blocks/q/kernel"]
        assert q.shape[-1] == 64
