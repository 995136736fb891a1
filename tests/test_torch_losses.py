"""The port's training losses, YOLO targets and correspondence sampling
against the JAX package on the CPU, inputs from numpy seeds. Negatives are
injected on both sides (the two random streams cannot match); ties in the
top-k selections keep `lax.top_k`'s order."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import dcnet_tpu.ops.correspondence as jcorr
from dcnet_tpu import losses as jlosses
from dcnet_tpu.config import DCNetConfig as JaxConfig
from dcnet_tpu.ops.target import build_target as jax_build_target
from dcnet_tpu.train.step import neg_sim_scores as jax_neg_sim_scores
from dcnet_tpu.train.step import pred_box_at_target as jax_pred_box
import dcnet_tpu_torch.ops.correspondence as pcorr
from dcnet_tpu_torch import losses as plosses
from dcnet_tpu_torch.config import DCNetConfig
from dcnet_tpu_torch.ops.decode import flatten_scores
from dcnet_tpu_torch.ops.target import build_target
from dcnet_tpu_torch.train.step import neg_sim_scores, pred_box_at_target


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread in this file's processes: the suite runs files in
    parallel workers, where per-op thread pools oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bboxes(rng, n, size):
    x1 = rng.rand(n) * size * 0.6
    y1 = rng.rand(n) * size * 0.6
    w = 2 + rng.rand(n) * size * 0.4
    h = 2 + rng.rand(n) * size * 0.4
    return np.stack([x1, y1, np.minimum(x1 + w, size - 1),
                     np.minimum(y1 + h, size - 1)], 1).astype(np.float32)


@pytest.mark.parametrize("size,dataset", [(256, "VID"), (64, "VID"),
                                          (416, "referit"), (256, "flickr")])
def test_build_target_matches_jax(size, dataset):
    rng = np.random.RandomState(size)
    box = _bboxes(rng, 16, size)
    box[0] = [0, 0, size - 1, size - 1]     # the whole image
    box[1] = [5, 7, 8, 9]                   # tiny
    want = jax_build_target(jnp.asarray(box), JaxConfig(image_size=size, dataset=dataset))
    got = build_target(torch.from_numpy(box), DCNetConfig(image_size=size, dataset=dataset))
    for f in ("best_n", "best_scale", "anchor", "gi", "gj", "conf_idx", "pos_idx"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    np.testing.assert_allclose(got.txywh.numpy(), np.asarray(want.txywh),
                               rtol=1e-6, atol=1e-6)


def _loss_inputs(seed, b=4, size=64, k=3, n=4, c=16):
    """Per-scale outboxes, score maps and contrastive samples for b images."""
    cfg = JaxConfig(image_size=size)
    rng = np.random.RandomState(seed)
    outbox = [rng.randn(b, 3, 5, g, g).astype(np.float32) for g in cfg.grids]
    corr = [rng.randn(b, g, g, c).astype(np.float32) for g in cfg.grids]
    flang = rng.randn(b, c).astype(np.float32)
    sim = [rng.randn(b, g, g).astype(np.float32) for g in cfg.grids]
    loc = [rng.rand(b, g, g).astype(np.float32) for g in cfg.grids]
    samples = [tuple(rng.randn(*shape).astype(np.float32) for shape in
                     ((b, k, c), (b, k, kp, c), (b, k, n, c)))
               for kp in (1, 2)]
    return cfg, outbox, corr, flang, sim, loc, samples, _bboxes(rng, b, size)


def _jt(x):
    return jnp.asarray(x)


def _pt(x):
    return torch.from_numpy(x)


def test_every_loss_and_the_total_match_jax():
    jcfg, outbox, corr, flang, sim, loc, (inter, cross), box = _loss_inputs(0)
    cfg = DCNetConfig(image_size=64)
    jt = jax_build_target(_jt(box), jcfg)
    pt = build_target(_pt(box), cfg)
    jsim, psim = jnp.concatenate([_jt(s).reshape(4, -1) for s in sim], 1), \
        flatten_scores([_pt(s) for s in sim])
    jloc, ploc = jnp.concatenate([_jt(s).reshape(4, -1) for s in loc], 1), \
        flatten_scores([_pt(s) for s in loc])
    jneg = jax_neg_sim_scores([_jt(x) for x in corr], _jt(flang))
    pneg = neg_sim_scores([_pt(x) for x in corr], _pt(flang))
    np.testing.assert_allclose(pneg.numpy(), np.asarray(jneg), rtol=1e-5, atol=1e-5)
    jib = [_jt(o) for o in outbox]
    pib = [_pt(o) for o in outbox]
    jis = [jcorr.ContrastiveSamples(*(_jt(x) for x in s)) for s in (inter, cross)]
    pis = [pcorr.ContrastiveSamples(*(_pt(x) for x in s)) for s in (inter, cross)]
    pairs = {
        "gather": (jlosses.gather_pred_at_target(jib, jt, jcfg),
                   plosses.gather_pred_at_target(pib, pt, cfg)),
        "pred_box": (jax_pred_box(jib, jt, jcfg), pred_box_at_target(pib, pt, cfg)),
        "yolo": (jlosses.yolo_loss(jib, jt, jcfg), plosses.yolo_loss(pib, pt, cfg)),
        "rank": (jlosses.rank_loss(jsim, jneg, jt.pos_idx),
                 plosses.rank_loss(psim, pneg, pt.pos_idx)),
        "loc": (jlosses.loc_loss(jloc, jt.pos_idx), plosses.loc_loss(ploc, pt.pos_idx)),
        "infonce": (jlosses.infonce_loss(jis[0]), plosses.infonce_loss(pis[0])),
        "infonce_2pos": (jlosses.infonce_loss(jis[1], 0.2),
                         plosses.infonce_loss(pis[1], 0.2)),
    }
    jtot = jlosses.total_loss(jib, jsim, jneg, jloc, jis[0], jis[1], jt, jcfg)
    ptot = plosses.total_loss(pib, psim, pneg, ploc, pis[0], pis[1], pt, cfg)
    for f in jlosses.LossBreakdown._fields:
        pairs[f"total.{f}"] = (getattr(jtot, f), getattr(ptot, f))
    for name, (want, got) in pairs.items():
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_total_loss_gradients_match_jax():
    """Gradients of the total with respect to every prediction input."""
    jcfg, outbox, corr, flang, sim, loc, (inter, cross), box = _loss_inputs(1)
    cfg = DCNetConfig(image_size=64)
    jt = jax_build_target(_jt(box), jcfg)
    pt = build_target(_pt(box), cfg)

    def jfn(ob, s, lc, fl, iq, cq):
        return jlosses.total_loss(
            ob, jnp.concatenate([x.reshape(4, -1) for x in s], 1),
            jax_neg_sim_scores([_jt(x) for x in corr], fl),
            jnp.concatenate([x.reshape(4, -1) for x in lc], 1),
            jcorr.ContrastiveSamples(iq, _jt(inter[1]), _jt(inter[2])),
            jcorr.ContrastiveSamples(cq, _jt(cross[1]), _jt(cross[2])),
            jt, jcfg).total

    args = ([_jt(o) for o in outbox], [_jt(s) for s in sim], [_jt(s) for s in loc],
            _jt(flang), _jt(inter[0]), _jt(cross[0]))
    jgrads = jax.grad(jfn, argnums=tuple(range(6)))(*args)
    ob = [_pt(o).requires_grad_() for o in outbox]
    s = [_pt(x).requires_grad_() for x in sim]
    lc = [_pt(x).requires_grad_() for x in loc]
    fl, iq, cq = (_pt(x).requires_grad_() for x in (flang, inter[0], cross[0]))
    plosses.total_loss(
        ob, flatten_scores(s), neg_sim_scores([_pt(x) for x in corr], fl),
        flatten_scores(lc),
        pcorr.ContrastiveSamples(iq, _pt(inter[1]), _pt(inter[2])),
        pcorr.ContrastiveSamples(cq, _pt(cross[1]), _pt(cross[2])),
        pt, cfg).total.backward()
    got = [[x.grad for x in ob], [x.grad for x in s], [x.grad for x in lc],
           fl.grad, iq.grad, cq.grad]
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(jgrads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


def _jax_negatives(rng, pos_idx, num_items, neg_n):
    return ((pos_idx[..., None] + 1 + jnp.arange(neg_n)) % num_items).astype(jnp.int32)


def _port_negatives(generator, pos_idx, num_items, neg_n):
    return (pos_idx.long()[..., None] + 1 + torch.arange(neg_n)) % num_items


@pytest.fixture
def injected(monkeypatch):
    monkeypatch.setattr(jcorr, "_sample_negatives_excluding", _jax_negatives)
    monkeypatch.setattr(pcorr, "_sample_negatives_excluding", _port_negatives)


def _same_samples(got, want):
    for f in ("q", "k", "neg"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)


@pytest.mark.parametrize("ties", [False, True])
def test_interframe_pairs_match_jax(injected, ties):
    """ties: 0/1 features make the correlation exact small integers, with
    many equal entries, and two identical frames make corr[p, q] ==
    corr[q, p]: the pairs must come out in lax.top_k's order."""
    rng = np.random.RandomState(3)
    if ties:
        f1 = (rng.rand(2, 4, 4, 8) < 0.5).astype(np.float32)
        f1[1] = f1[0, ::-1]
        f2 = f1.copy()
        f2[0] = (rng.rand(4, 4, 8) < 0.5)
    else:
        f1, f2 = (rng.randn(2, 4, 4, 8).astype(np.float32) for _ in range(2))
    want = jcorr.interframe_pairs(_jt(f1), _jt(f2), 30, 5, jax.random.PRNGKey(0))
    got = pcorr.interframe_pairs(_pt(f1), _pt(f2), 30, 5)
    _same_samples(got, want)


@pytest.mark.parametrize("ties", [False, True])
def test_crossmodal_pairs_match_jax(injected, ties):
    """ties: rows of equal word weights, where the first word must win."""
    rng = np.random.RandomState(4)
    wp = rng.rand(2, 20, 16).astype(np.float32)
    if ties:
        wp[:, :, ::2] = 0.05
        wp[:, 3:7, 1] = 0.9
    lang = rng.randn(2, 20, 8).astype(np.float32)
    vit = rng.randn(2, 16, 8).astype(np.float32)
    for top_k in (1, 3):
        want = jcorr.crossmodal_pairs(_jt(wp), _jt(lang), _jt(vit), top_k, 5,
                                      jax.random.PRNGKey(0))
        got = pcorr.crossmodal_pairs(_pt(wp), _pt(lang), _pt(vit), top_k, 5)
        _same_samples(got, want)


def test_negative_sampler_draws_without_replacement_and_skips_the_positive():
    gen = torch.Generator().manual_seed(0)
    pos = torch.randint(0, 64, (16, 30), generator=gen)
    idx = pcorr._sample_negatives_excluding(gen, pos, 64, 10)
    assert idx.shape == (16, 30, 10)
    assert not (idx == pos[..., None]).any()
    srt = torch.sort(idx, dim=-1).values
    assert (srt[..., 1:] != srt[..., :-1]).all()
    one, same, other = (pcorr._sample_negatives_excluding(
        torch.Generator().manual_seed(s), pos, 64, 10) for s in (1, 1, 2))
    assert torch.equal(one, same) and not torch.equal(one, other)
    # every other item is drawn about equally often
    counts = torch.bincount(pcorr._sample_negatives_excluding(
        gen, torch.zeros(4000, dtype=torch.long), 8, 3).flatten(), minlength=8)
    assert counts[0] == 0
    assert (counts[1:].float() / counts[1:].float().mean() - 1).abs().max() < 0.1
