"""The port's boxes, matching cost, assignment and set criterion
(dinov2_od_tpu_torch/ops/{boxes,matching,hungarian,losses}.py) against
the JAX package on the same seeded numpy inputs, on the CPU, fp32."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dinov2_od_tpu import config as jcfg
from dinov2_od_tpu.ops import boxes as jboxes
from dinov2_od_tpu.ops import losses as jlosses
from dinov2_od_tpu.ops import matching as jmatching

from dinov2_od_tpu_torch import config as pcfg
from dinov2_od_tpu_torch.ops import boxes as pboxes
from dinov2_od_tpu_torch.ops import losses as plosses
from dinov2_od_tpu_torch.ops import matching as pmatching

# Max abs error of values and gradients, fp32, relative to max(1, the
# reference's largest magnitude): the same formulas summed or fused in
# another order.
TOL = 1e-5
B, Q, G, C = 3, 10, 7, 6


def _err(ref, out):
    ref = np.asarray(ref, np.float32)
    out = out.detach().numpy() if torch.is_tensor(out) else np.asarray(out)
    both_nan = np.isnan(ref) & np.isnan(out)
    diff = np.where(both_nan, 0.0, np.abs(ref - out))
    return float(np.nanmax(diff) / max(1.0, np.nanmax(np.abs(ref))))


def _xyxy(rng, *shape):
    lo = rng.uniform(0.0, 0.6, size=shape + (2,))
    wh = rng.uniform(0.05, 0.4, size=shape + (2,))
    return np.concatenate([lo, lo + wh], -1).astype(np.float32)


def _preds(seed=0, b=B, q=Q, c=C):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2.0, size=(b, q, c)).astype(np.float32)
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (b, q, 2)),
                            rng.uniform(0.05, 0.5, (b, q, 2))],
                           -1).astype(np.float32)
    return logits, boxes


def _targets(seed=1, b=B, g=G, c=C, n_valid=(3, 7, 0)):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, c, size=(b, g)).astype(np.int32)
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (b, g, 2)),
                            rng.uniform(0.05, 0.5, (b, g, 2))],
                           -1).astype(np.float32)
    valid = np.zeros((b, g), bool)
    for i, n in enumerate(n_valid):
        valid[i, :n] = True
    boxes[~valid] = 0.0
    return labels, boxes, valid


# ---- boxes -------------------------------------------------------------


@pytest.mark.parametrize("fn", ["iou", "giou", "elementwise_giou"])
def test_boxes_and_their_gradients_match_jax(fn):
    rng = np.random.default_rng(4)
    a = _xyxy(rng, 2, 5)
    b = _xyxy(rng, 2, 5 if fn == "elementwise_giou" else 6)
    jfn, pfn = {
        "iou": (lambda x, y: jboxes.pairwise_box_iou(x, y)[0],
                lambda x, y: pboxes.pairwise_box_iou(x, y)[0]),
        "giou": (jboxes.generalized_box_iou, pboxes.generalized_box_iou),
        "elementwise_giou": (jboxes.elementwise_generalized_box_iou,
                             pboxes.elementwise_generalized_box_iou),
    }[fn]
    ref = jfn(jnp.asarray(a), jnp.asarray(b))
    w = rng.normal(size=ref.shape).astype(np.float32)
    jgrads = jax.grad(lambda x, y: jnp.sum(jfn(x, y) * w), (0, 1))(
        jnp.asarray(a), jnp.asarray(b))
    ta, tb = (torch.from_numpy(x).requires_grad_(True) for x in (a, b))
    out = pfn(ta, tb)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (ta, tb))
    assert _err(ref, out) <= TOL
    for jg, pg in zip(jgrads, grads):
        assert _err(jg, pg) <= TOL
    area = pboxes.box_area(torch.from_numpy(a))
    assert _err(jboxes.box_area(jnp.asarray(a)), area) <= TOL


def test_degenerate_boxes_give_what_jax_gives():
    """No guard on a zero union or enclosing area, as in JAX: the same
    NaN where both boxes have zero size."""
    z = np.zeros((1, 2, 4), np.float32)
    z[0, 1] = [0.1, 0.1, 0.3, 0.4]
    ref = jboxes.generalized_box_iou(jnp.asarray(z), jnp.asarray(z))
    out = pboxes.generalized_box_iou(torch.from_numpy(z), torch.from_numpy(z))
    assert np.array_equal(np.isnan(np.asarray(ref)), torch.isnan(out).numpy())
    assert _err(ref, out) <= TOL


# ---- matching cost -----------------------------------------------------


def _jax_cost(logits, boxes, labels, gt_boxes, valid, cfg):
    fn = jax.vmap(lambda a, b, c, d, e: jmatching.matching_cost_matrix(
        a, b, c, d, e, cfg))
    return np.asarray(fn(*(jnp.asarray(x) for x in
                           (logits, boxes, labels, gt_boxes, valid))))


def _probes(top=80.0):
    """VERIFY probes: logits +-80 (fp32 sigmoid saturates), zero-size
    boxes, NaN predictions, an image with 0 GT and one with more GT than
    queries. `top` is the high logit."""
    logits, boxes = _preds(2, b=4, q=5)
    labels, gt_boxes, valid = _targets(3, b=4, g=8, n_valid=(3, 0, 8, 5))
    logits[0, 0] = top
    logits[0, 1] = -80.0
    boxes[2, 0, 2:] = 0.0            # zero-size prediction
    gt_boxes[2, 1, 2:] = 0.0         # zero-size GT
    boxes[3, 4] = np.nan             # NaN prediction
    logits[3, 3, 1] = np.nan
    return logits, boxes, labels, gt_boxes, valid


@pytest.mark.parametrize("inputs", ["random", "probes"])
def test_cost_matrix_matches_jax(inputs):
    args = (_preds() + _targets()) if inputs == "random" else _probes()
    jc, pc = jcfg.MatcherConfig(), pcfg.MatcherConfig()
    ref = _jax_cost(*args, jc)
    out = pmatching.matching_cost_matrix(
        *(torch.from_numpy(x) for x in args), pc)
    assert out.shape == ref.shape and np.isfinite(out.numpy()).all()
    assert _err(ref, out) <= TOL
    assert (out[~torch.from_numpy(args[4])[:, None, :].expand_as(out)]
            == pmatching.PAD_COST).all()


# ---- assignment --------------------------------------------------------


def _total_cost(cost, query_of_gt, match_valid):
    """Sum of cost[b, q, g] over the matched (q, g) pairs, per image."""
    qg = np.asarray(query_of_gt)
    mv = np.asarray(match_valid)
    return np.array([sum(cost[b, qg[b, g], g] for g in range(qg.shape[1])
                         if mv[b, g]) for b in range(qg.shape[0])])


@pytest.mark.parametrize("inputs", ["random", "probes"])
@pytest.mark.parametrize("bug", [False, True], ids=["fixed", "batch0_bug"])
def test_assignment_total_cost_equals_jax(inputs, bug):
    """Both solvers are exact: the same total cost per image (ties may
    pick other pairs), the same number of matched GT, every matched query
    used once. The probes' high logit is 12, not 80: under jit, XLA turns
    JAX's log((1 - p) + 1e-8) into log1p(-p + 1e-8), which is -inf at a
    saturated p == 1, so jitted JAX gives such a query the cost -PAD_COST
    against every GT (ROADMAP.md, Queue C); the eager cost both sides
    share in `test_cost_matrix_matches_jax` stays finite there."""
    args = ((_preds() + _targets()) if inputs == "random"
            else _probes(top=12.0))
    jc = jcfg.MatcherConfig(replicate_batch0_bug=bug)
    pc = pcfg.MatcherConfig(replicate_batch0_bug=bug)
    ref = jmatching.hungarian_match(*(jnp.asarray(x) for x in args), jc)
    out = pmatching.hungarian_match(*(torch.from_numpy(x) for x in args), pc)
    logits, boxes = args[:2]
    if bug:  # the cost every image was matched with: image 0's predictions
        logits = np.broadcast_to(logits[:1], logits.shape)
        boxes = np.broadcast_to(boxes[:1], boxes.shape)
    cost = _jax_cost(logits, boxes, *args[2:], jc)
    want = _total_cost(cost, ref.query_of_gt, ref.match_valid)
    got = _total_cost(cost, out.query_of_gt, out.match_valid)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    assert np.array_equal(np.asarray(ref.match_valid).sum(1),
                          out.match_valid.numpy().sum(1))
    assert out.query_of_gt.dtype == torch.int64
    assert (out.query_of_gt[~out.match_valid] == -1).all()
    for b in range(out.query_of_gt.shape[0]):
        used = out.query_of_gt[b][out.match_valid[b]]
        assert len(set(used.tolist())) == len(used)


def test_auction_is_not_ported_yet():
    """The auction is ported now (its parity is tests/test_torch_auction.py):
    40 GT slots under 'auto' and any slot count under 'auction' route to it
    and give a valid matching with JAX's matched count, no longer a
    NotImplementedError."""
    args = _preds() + _targets(g=40, n_valid=(3, 7, 0))
    for cfg in (pcfg.MatcherConfig(),
                pcfg.MatcherConfig(assignment="auction")):
        pmatching.reset_solver_stats()
        out = pmatching.hungarian_match(
            *(torch.from_numpy(x) for x in args), cfg)
        assert pmatching.solver_stats["auction"] == 1
        ref = jmatching.hungarian_match(*(jnp.asarray(x) for x in args),
                                        jcfg.MatcherConfig())
        assert np.array_equal(np.asarray(ref.match_valid).sum(1),
                              out.match_valid.numpy().sum(1))
        assert (out.query_of_gt[~out.match_valid] == -1).all()


# ---- set criterion -----------------------------------------------------


def _criterion_inputs():
    return _preds(5) + _targets(6, n_valid=(3, 7, 0))


def test_focal_bce_matches_jax():
    rng = np.random.default_rng(8)
    logits = rng.normal(0, 4, size=(4, 9)).astype(np.float32)
    logits[0, :2] = (80.0, -80.0)
    onehot = (rng.uniform(size=(4, 9)) < 0.3).astype(np.float32)
    ref = jlosses.sigmoid_focal_bce(jnp.asarray(logits), jnp.asarray(onehot),
                                    0.25, 2.0)
    out = plosses.sigmoid_focal_bce(torch.from_numpy(logits),
                                    torch.from_numpy(onehot), 0.25, 2.0)
    assert _err(ref, out) <= TOL


@pytest.mark.parametrize("shared_match", [True, False],
                         ids=["same_match", "end_to_end"])
def test_set_criterion_and_its_gradients_match_jax(shared_match):
    """Every loss term and the gradients of the total with respect to the
    predictions, for the JAX match handed to both and for each side
    matching on its own."""
    logits, boxes, labels, gt_boxes, valid = _criterion_inputs()
    jargs = [jnp.asarray(x) for x in (logits, boxes, labels, gt_boxes, valid)]
    jmatch = jmatching.hungarian_match(*jargs)

    def jloss(lg, bx):
        out = jlosses.set_criterion(lg, bx, *jargs[2:], num_classes=C,
                                    match=jmatch)
        return out["loss"], out

    (_, ref), jgrads = jax.value_and_grad(jloss, (0, 1), has_aux=True)(
        jargs[0], jargs[1])
    tl, tb = (torch.from_numpy(x).requires_grad_(True)
              for x in (logits, boxes))
    match = None
    if shared_match:
        match = pmatching.MatchResult(
            torch.from_numpy(np.array(jmatch.query_of_gt)),
            torch.from_numpy(np.array(jmatch.match_valid)))
    out, pmatch = plosses.set_criterion(
        tl, tb, *(torch.from_numpy(x) for x in (labels, gt_boxes, valid)),
        num_classes=C, match=match, return_match=True)
    grads = torch.autograd.grad(out["loss"], (tl, tb))
    assert set(out) == set(ref)
    for key in ref:
        assert _err(ref[key], out[key]) <= TOL, key
    for jg, pg in zip(jgrads, grads):
        assert _err(jg, pg) <= TOL
    if shared_match:
        assert pmatch is match
    # The image without GT only pushes its logits toward "no object".
    assert float(out["num_boxes"]) == valid.sum()


def test_criterion_reuses_a_given_match_and_matches_without_grad():
    logits, boxes, labels, gt_boxes, valid = (
        torch.from_numpy(x) for x in _criterion_inputs())
    tl = logits.clone().requires_grad_(True)
    match = pmatching.hungarian_match(tl, boxes, labels, gt_boxes, valid)
    assert not match.query_of_gt.requires_grad
    a = plosses.set_criterion(tl, boxes, labels, gt_boxes, valid,
                              num_classes=C)
    b = plosses.set_criterion(tl, boxes, labels, gt_boxes, valid,
                              num_classes=C, match=match)
    assert torch.equal(a["loss"], b["loss"])
    weighted = dataclasses.replace(pcfg.LossConfig(), weight_giou=0.0)
    c = plosses.set_criterion(tl, boxes, labels, gt_boxes, valid,
                              loss_cfg=weighted, num_classes=C, match=match)
    assert float(c["loss_giou"]) == 0.0
    assert torch.allclose(c["loss"], a["loss"] - a["loss_giou"])
