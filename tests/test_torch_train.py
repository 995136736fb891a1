"""One train step of the port against `dcnet_tpu.train.step` on the CPU:
mini defs at 64 px with the SMALL widths, fp32, dropout 0, the same
deterministic negatives on both sides, for k=2 (the pair, K2 + 2 x K3) and
k=3 (ring pairing, K1 + K3). Also the optimizers on given gradients, and
the eval step.

The JAX step is `_train_step_impl` jitted afresh (the function
`train_step` jits), on a state whose optimizer is preceded by a pass-through
that keeps the gradients, so one compiled step gives the losses, the
gradients and the updated batch_stats. Its BatchNorms take flax's exact
two-pass batch variance (`use_fast_variance=False`) instead of the default
E[x^2] - E[x]^2: in this small random model the phrase features hardly
vary across phrases (a `mapping_lang` channel at mean 1.5, std 0.005), where
the default is fp32 cancellation noise (~1% of that variance) and the two
packages would differ by ~1e-3 in the outbox; the port computes the exact
variance. Both packages also take the same step in float64 (JAX under
`jax.enable_x64`, its BatchNorms kept in the input's dtype), which holds
every gradient of the port against JAX's to ~1e-6, free of fp32 rounding.
Updated parameters are compared only through the optimizer test:
one RMSprop step moves each parameter by about lr * 10 * sign(g), which
flips on gradients near zero.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from flax.linen import normalization as flax_norm
from torch import nn

import dcnet_tpu.ops.correspondence as jcorr
from dcnet_tpu.config import DCNetConfig as JaxConfig
from dcnet_tpu.models import DCNet as JaxDCNet
from dcnet_tpu.models.darknet import mini_backbone_defs as jax_mini_defs
from dcnet_tpu.train import step as jstep
from dcnet_tpu.train.state import TrainState as JaxTrainState
from dcnet_tpu.train.state import make_optimizer as jax_make_optimizer
import dcnet_tpu_torch.ops.correspondence as pcorr
from dcnet_tpu_torch.config import DCNetConfig
from dcnet_tpu_torch.train.loop import flatten_clip_batch, train_epoch, validate
from dcnet_tpu_torch.train.state import create_train_state
from dcnet_tpu_torch.train.step import eval_step, train_step
from dcnet_tpu_torch.weights import state_dict_from_jax
from tests.test_torch_slice import SMALL, port_model, randomize_jax_variables

TRAIN = dict(SMALL, jemb_dropout=0.0, input_dropout=0.0)


def _batch(k, seed=5, clips=2):
    """k-frame clips flattened to (clips*k, ...), a phrase per frame, as the
    JAX package's train tests draw them (frames sharing a phrase would give
    the phrase BatchNorm1d only `clips` distinct rows)."""
    rng = np.random.RandomState(seed)
    n = clips * k
    ids = rng.randint(1, 50, (n, 20)).astype(np.int32)
    ids[:k, 11:] = 0  # padded phrases
    x1, y1 = rng.rand(n) * 30, rng.rand(n) * 30
    box = np.stack([x1, y1, x1 + 4 + rng.rand(n) * 28,
                    y1 + 4 + rng.rand(n) * 28], 1).astype(np.float32)
    return {"images": rng.rand(n, 64, 64, 3).astype(np.float32),
            "word_ids": ids, "bbox": box}


def _jax_setup(k):
    cfg = JaxConfig(**TRAIN, n_frames_train=k)
    model = JaxDCNet(cfg=cfg, backbone_defs=jax_mini_defs())
    b = _batch(k, seed=0)
    init = jax.jit(lambda rngs, x, w: model.init(rngs, x, w, train=False))
    variables = init({"params": jax.random.PRNGKey(0),
                      "sampling": jax.random.PRNGKey(1),
                      "dropout": jax.random.PRNGKey(2)},
                     jnp.asarray(b["images"]), jnp.asarray(b["word_ids"]))
    return cfg, model, randomize_jax_variables(jax.device_get(variables), 0)


def _exact_variance(compute_stats, *args, **kwargs):
    return compute_stats(*args, **{**kwargs, "use_fast_variance": False})


def _float64_stats(compute_stats, x, axes, dtype, *args, **kwargs):
    """flax's exact batch statistics in x's own dtype: the modules ask for
    float32, which would round every float64 BatchNorm."""
    return compute_stats(x, axes, None, *args,
                         **{**kwargs, "use_fast_variance": False})


def _float64_normalize(normalize, mdl, x, mean, var, reduction_axes,
                       feature_axes, dtype, *args, **kwargs):
    return normalize(mdl, x, mean, var, reduction_axes, feature_axes, None,
                     *args, **kwargs)


def _to_float64(tree):
    return jax.tree_util.tree_map(
        lambda v: np.asarray(v, np.float64)
        if np.issubdtype(np.asarray(v).dtype, np.floating) else v, tree)


def _jax_step(jmodel, jcfg, variables, jbatch):
    """One jitted `_train_step_impl`: (new state, metrics); the state's
    first optimizer stage keeps the gradients."""
    tx = optax.chain(_keep_grads(),
                     jax_make_optimizer(jcfg, 10, variables["params"]))
    state = JaxTrainState(
        step=jnp.asarray(0, jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]), apply_fn=jmodel.apply, tx=tx)
    step_fn = jax.jit(jstep._train_step_impl, static_argnames=("cfg", "model"))
    with jax.default_matmul_precision("highest"):
        new_state, metrics = step_fn(jmodel, jcfg, state, jbatch,
                                     jax.random.PRNGKey(0))
    return jax.device_get((new_state, metrics))


def _keep_grads():
    """A pass-through optax stage whose state becomes the gradients."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (g, g))


@pytest.fixture(scope="module", params=[2, 3], ids=["k2", "k3"])
def stepped(request):
    """Both packages before and after one train step from the same weights
    and clips, with the pair indices each side's sampler was handed."""
    k = request.param
    jcfg, jmodel, variables = _jax_setup(k)
    cfg, model = port_model(variables, **TRAIN, n_frames_train=k)
    batch = _batch(k)
    tbatch = {n: torch.from_numpy(v) for n, v in batch.items()}
    jbatch = {n: jnp.asarray(v) for n, v in batch.items()}

    with jax.default_matmul_precision("highest"):
        jax_eval = jax.device_get(jstep.eval_step(
            jmodel, jcfg, JaxTrainState(
                step=jnp.asarray(0), params=variables["params"],
                batch_stats=variables["batch_stats"], opt_state=(),
                apply_fn=jmodel.apply, tx=None), jbatch))
    port_eval = eval_step(model, tbatch)

    seen = {"jax": {}, "port": {}}

    def jax_neg(rng, pos_idx, num_items, neg_n):
        jax.debug.callback(
            lambda p: seen["jax"].setdefault(p.shape, np.asarray(p)), pos_idx)
        return ((pos_idx[..., None] + 1 + jnp.arange(neg_n)) % num_items
                ).astype(jnp.int32)

    def port_neg(generator, pos_idx, num_items, neg_n):
        seen["port"].setdefault(tuple(pos_idx.shape), pos_idx.numpy().copy())
        return (pos_idx.long()[..., None] + 1 + torch.arange(neg_n)) % num_items

    mp = pytest.MonkeyPatch()
    mp.setattr(flax_norm, "_compute_stats", functools.partial(
        _exact_variance, flax_norm._compute_stats))
    mp.setattr(jcorr, "_sample_negatives_excluding", jax_neg)
    mp.setattr(pcorr, "_sample_negatives_excluding", port_neg)
    try:
        new_state, jmetrics = _jax_step(jmodel, jcfg, variables, jbatch)
        pstate = create_train_state(model, cfg, steps_per_epoch=10)
        pmetrics = train_step(pstate, tbatch)
        # the exact gradients: both packages' step in float64
        mp.setattr(flax_norm, "_compute_stats", functools.partial(
            _float64_stats, flax_norm._compute_stats))
        mp.setattr(flax_norm, "_normalize", functools.partial(
            _float64_normalize, flax_norm._normalize))
        with jax.enable_x64(True):
            jmodel64 = JaxDCNet(cfg=jcfg, backbone_defs=jax_mini_defs(),
                                dtype=jnp.float64)
            state64, _ = _jax_step(jmodel64, jcfg, _to_float64(variables),
                                   {n: jnp.asarray(_to_float64(v))
                                    for n, v in batch.items()})
        cfg64, m64 = port_model(variables, **TRAIN, n_frames_train=k,
                                compute_dtype="float64")
        train_step(create_train_state(m64.double(), cfg64), tbatch)
    finally:
        mp.undo()
    return dict(k=k, variables=variables, model=model, seen=seen,
                grads64={n: prm.grad for n, prm in m64.named_parameters()},
                jmetrics=jmetrics, pmetrics=pmetrics,
                jgrads=new_state.opt_state[0],
                jgrads64=state64.opt_state[0],
                jstats=new_state.batch_stats,
                jax_eval=jax_eval, port_eval=port_eval)


def test_sampled_pair_indices_are_equal(stepped):
    """First the pairs: the inter-frame keys each sampler was handed (from
    the top-k of each side's own correlation) and the cross-modal patches."""
    jax_seen, port_seen = stepped["seen"]["jax"], stepped["seen"]["port"]
    assert set(jax_seen) == set(port_seen) and len(port_seen) == 2
    for shape, idx in port_seen.items():
        np.testing.assert_array_equal(idx, jax_seen[shape])


@pytest.mark.parametrize("part", ["loss", "loss_yolo", "loss_rank", "loss_loc",
                                  "loss_interframe", "loss_crossmodal",
                                  "acc50", "acc_center", "miou"])
def test_losses_and_metrics_match_jax(stepped, part):
    np.testing.assert_allclose(float(stepped["pmetrics"][part]),
                               float(stepped["jmetrics"][part]),
                               rtol=1e-4, atol=1e-5)


def _jax_float64_grads(stepped):
    grads = state_dict_from_jax(stepped["jgrads64"], {})
    assert all(g.dtype == np.float64 for g in grads.values())
    exact = {n: torch.tensor(np.asarray(g)) for n, g in grads.items()}
    return exact, max(g.norm().item() for g in exact.values())


def test_float64_gradients_match_jax_float64(stepped):
    """Free of fp32 rounding, every gradient of the port is JAX's: relative
    l2 1e-6 (the two differ by ~5e-8, from the float32 anchor constants of
    JAX's loss). A gradient that is zero in exact arithmetic (a bias in
    front of a train-mode BatchNorm or of the word softmax, and feature_map,
    outside the loss's graph) must be below 1e-9 of the largest on both
    sides."""
    exact, gmax = _jax_float64_grads(stepped)
    assert len(exact) == len(stepped["grads64"])
    bad = {}
    for name, g in stepped["grads64"].items():
        e = exact[name]
        if e.norm() <= 1e-9 * gmax:
            err = g.norm() / gmax
            ok = err <= 1e-9
        else:
            err = (g - e).norm() / e.norm()
            ok = err <= 1e-6
        if not ok:
            bad[name] = err.item()
    assert not bad, bad


def test_every_parameter_gradient_matches_jax(stepped):
    """The fp32 step: relative l2 1e-3 per parameter against JAX's fp32
    gradient. Where the two fp32 results differ by more, the gradient is a
    sum that cancels (a head bias summed over every cell, ~1e-5 of the
    largest gradient), and fp32 summation order decides: there the port
    must be at least as close to JAX's float64 gradient as JAX's own fp32
    result is, within twice its distance. Where JAX's float64 gradient is
    zero in exact arithmetic, the port's fp32 one is rounding noise and must
    stay below 1e-4 of the largest gradient."""
    want = state_dict_from_jax(stepped["jgrads"], {})
    exact, gmax = _jax_float64_grads(stepped)
    assert len(exact) == len(want)
    bad = {}
    for name, prm in stepped["model"].named_parameters():
        p, j, e = prm.grad.double(), torch.tensor(want[name]).double(), exact[name]
        if e.norm() <= 1e-9 * gmax:
            ok = p.norm() <= 1e-4 * gmax
        else:
            ok = (p - j).norm() <= 1e-3 * j.norm()
            ok = ok or (p - e).norm() <= 2 * (j - e).norm()
        if not ok:
            bad[name] = ((p - j).norm() / j.norm().clamp_min(1e-30)).item()
    assert not bad, bad


def test_batch_stats_after_the_step_match_jax(stepped):
    """flax's running-statistics rule with the biased batch variance."""
    want = state_dict_from_jax(stepped["variables"]["params"], stepped["jstats"])
    got = stepped["model"].state_dict()
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert keys
    before = state_dict_from_jax(stepped["variables"]["params"],
                                 stepped["variables"]["batch_stats"])
    moved = 0
    for key in keys:
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=1e-4,
                                   atol=1e-5, err_msg=key)
        moved += not np.allclose(want[key], before[key])
    assert moved == len(keys)


@pytest.mark.parametrize("metric", ["acc50", "acc_center", "miou"])
def test_eval_step_matches_jax(stepped, metric):
    np.testing.assert_allclose(float(stepped["port_eval"][metric]),
                               float(stepped["jax_eval"][metric]),
                               rtol=1e-5, atol=1e-6)


class _Tiny(nn.Module):
    """A backbone group and a head group, named as the model's are."""

    def __init__(self, params):
        super().__init__()
        self.visumodel = nn.ParameterDict(
            {k: nn.Parameter(torch.from_numpy(v.copy())) for k, v in params["visumodel"].items()})
        self.head = nn.ParameterDict(
            {k: nn.Parameter(torch.from_numpy(v.copy())) for k, v in params["head"].items()})


@pytest.mark.parametrize("opt", ["rmsprop", "adam", "sgd"])
def test_optimizer_and_schedule_match_optax(opt):
    """make_optimizer of both packages on the same gradients: the two
    parameter groups (backbone at lr * 0.1), weight decay where the recipe
    has it, and the poly schedule across two epoch boundaries (2 steps an
    epoch)."""
    rng = np.random.RandomState(11)
    params = {"visumodel": {"w": rng.randn(3, 4).astype(np.float32)},
              "head": {"w": rng.randn(5).astype(np.float32),
                       "b": rng.randn(2).astype(np.float32)}}
    kw = dict(optimizer=opt, lr=1e-2, nb_epoch=3, poly_power=0.9, weight_decay=5e-4)
    tx = jax_make_optimizer(JaxConfig(**kw), 2, params)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = tx.init(jparams)
    module = _Tiny(params)
    state = create_train_state(module, DCNetConfig(**kw), steps_per_epoch=2)
    for _ in range(5):
        grads = jax.tree_util.tree_map(
            lambda v: rng.randn(*v.shape).astype(np.float32), params)
        updates, jstate = tx.update(jax.tree_util.tree_map(jnp.asarray, grads),
                                    jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for group in ("visumodel", "head"):
            for name, prm in getattr(module, group).items():
                prm.grad = torch.from_numpy(grads[group][name])
        state.optimizer.step()
        state.schedule.step()
        for group in ("visumodel", "head"):
            for name, prm in getattr(module, group).items():
                np.testing.assert_allclose(prm.detach().numpy(),
                                           np.asarray(jparams[group][name]),
                                           rtol=1e-5, atol=1e-7)


def test_train_epoch_and_validate_run_on_clip_batches():
    """The loop flattens (B, k, ...) clip batches, steps, and averages."""
    variables = _jax_setup(2)[2]
    cfg, model = port_model(variables, **TRAIN)
    state = create_train_state(model, cfg, steps_per_epoch=2)
    clips = {n: v.reshape(2, 2, *v.shape[1:]) for n, v in _batch(2).items()}
    assert flatten_clip_batch(clips)["images"].shape == (4, 64, 64, 3)
    averages = train_epoch(state, [clips, clips], epoch=0, print_freq=10,
                           generator=torch.Generator().manual_seed(0))
    assert state.step == 2 and np.isfinite(averages["loss"])
    result = validate(model, [clips])
    assert set(result) == {"acc50", "acc_center", "miou"}
