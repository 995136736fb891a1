"""The 2-D (data, model) mesh of the port (`dcnet_tpu_torch.parallel.mesh`)
on the CPU: tensor-parallel co-attention, the mesh engine and the dry run.

One spawn of two gloo ranks (`file://` store, one torch thread each), the
same inputs made from numpy seeds on every side:

- on a (data 1, model 2) mesh, `ops.coattention.coattention_pair` and
  `coattention_center` (float and int8 logits) with `tp_shard` (each rank a
  window of the query rows, P = 15 split 8 / 7: the windows are ragged),
  outputs and gradients; this process holds them against the JAX functions
  with `tp_shard=True` under a `Mesh((1, 2), ("data", "model"))` of the
  suite's virtual CPU devices, at the limits `tests/test_torch_coattn.py` and
  `tests/test_torch_train_kernels.py` hold the unsharded ops to (rtol
  1e-5, atol 1e-6);
- on the same mesh, one k=2 train step of the mini model with
  `cfg.tp_internals` (dropout 0, each positive's own negatives) against
  the one-process port step (which `tests/test_torch_train.py` holds
  against the JAX step; the JAX package holds its own `tp_internals` step
  to its unsharded step, `tests/test_train.py::
  test_train_step_tensor_parallel`): loss rtol 1e-5, every gradient within
  `tests/test_torch_parallel.py`'s GRAD_REL / GRAD_ABS, running statistics
  within 1e-5 and equal on both ranks; the step once more with the
  gather's backward made a reduce-scatter (the sum over the model group
  before the rank's rows are taken), which must miss those limits; and
  `eval_clip` under the mesh against the one-process `eval_clip`;
- on a (data 2, model 1) mesh, the serving engine with 8 streams, 4 a rank,
  against the one-process engine tick by tick within 1e-4 (JAX's
  `test_streaming_on_mesh` allows 1e-3), with `update_queries` on a mask
  across both shards; a state saved by the pair resumed in one process,
  and a one-process state resumed by the pair.

Beside the spawn: `attend_plain` and `attend_bwd_plain` on row windows,
ragged ones among them, against the rows of JAX's `coattention_one` and
its vjp in interpret mode; a stream count the data axis does not divide
raising; `cli/serve.py --devices 2` serving as the one-process CLI; and
`dryrun.dryrun_multichip(2)` on the CPU.
"""

import contextlib
import io
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import Mesh as JaxMesh

import dcnet_tpu_torch.cli.serve as pserve
import dcnet_tpu_torch.ops.correspondence as pcorr
from dcnet_tpu.ops.coattention import coattention_center as jax_center
from dcnet_tpu.ops.coattention import coattention_pair as jax_pair
from dcnet_tpu.ops.pallas.coattn import coattention_one as jax_one
from dcnet_tpu_torch.config import DCNetConfig
from dcnet_tpu_torch.dryrun import dryrun_multichip
from dcnet_tpu_torch.kernels import coattn
from dcnet_tpu_torch.models.darknet import mini_backbone_defs
from dcnet_tpu_torch.models.dcnet import DCNet
from dcnet_tpu_torch.ops.coattention import coattention_center, coattention_pair
from dcnet_tpu_torch.parallel import mesh
from dcnet_tpu_torch.serving import engine as pengine
from dcnet_tpu_torch.utils.profiling import COUNTERS
from dcnet_tpu_torch.weights import seeded_init_
from tests.test_torch_parallel import (
    CPU, GRAD_ABS, GRAD_REL, TRAIN, _batch, _grads_close, _negatives, _step)
from tests.test_torch_serving import _graphable_on_a_card

RANKS = 2
TOL = dict(rtol=1e-5, atol=1e-6)   # tests/test_torch_coattn.py, test_torch_train_kernels.py
OPS_SHAPE = (2, 3, 5, 8)           # B, H, W, C: P = 15 rows, windows of 8 and 7
LOSS_RTOL, STATS_TOL = 1e-5, dict(rtol=1e-5, atol=1e-6)
ENGINE_TOL = dict(rtol=1e-4, atol=1e-4)
STREAMS, TICKS, SWAP_AT, SAVE_AT = 8, 6, 2, 4
SWAP_MASK = np.array([False, True, False, False, False, False, True, False])


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread in this file's processes: the suite runs files in
    parallel workers, where per-op thread pools oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ops_inputs():
    """f1, f2 (scale 0.3, l2-normalised rows for the int8 logits), upstream
    gradients g1, g2 (scale 0.1): NHWC float32."""
    rng = np.random.RandomState(41)
    xs = [(rng.randn(*OPS_SHAPE) * (0.3 if i < 2 else 0.1)).astype(np.float32)
          for i in range(4)]
    for i in range(2):
        xs[i] /= np.linalg.norm(xs[i], axis=-1, keepdims=True)
    return xs


def _port_ops() -> dict:
    """The sharded ops on this rank (a model group of 2): outputs and input
    gradients, as numpy."""
    f1, f2, g1, g2 = (torch.from_numpy(x) for x in _ops_inputs())
    a, b = f1.clone().requires_grad_(), f2.clone().requires_grad_()
    o1, o2 = coattention_pair(a, b, 10.0, tp_shard=True)
    torch.autograd.backward((o1, o2), (g1, g2))
    out = {"pair": [o1, o2, a.grad, b.grad]}
    a, b = f1.clone().requires_grad_(), f2.clone().requires_grad_()
    c = coattention_center(a, b, 10.0, tp_shard=True)
    c.backward(g1)
    out["center"] = [c, a.grad, b.grad]
    with torch.no_grad():
        out["center_int8"] = [coattention_center(f1, f2, 10.0, tp_shard=True,
                                                 int8_logits=True)]
    return {k: [x.detach().numpy() for x in v] for k, v in out.items()}


def _jax_ops(devices) -> dict:
    """The JAX functions with tp_shard=True on a (1, 2) mesh: one jit each."""
    f1, f2, g1, g2 = (jnp.asarray(x) for x in _ops_inputs())
    jm = JaxMesh(np.asarray(devices[:2]).reshape(1, 2), ("data", "model"))

    @jax.jit
    def pair(x, y, gx, gy):
        outs, vjp = jax.vjp(lambda u, v: jax_pair(u, v, 10.0, tp_shard=True), x, y)
        return (*outs, *vjp((gx, gy)))

    @jax.jit
    def center(x, y, gx):
        out, vjp = jax.vjp(lambda u, v: jax_center(u, v, 10.0, tp_shard=True), x, y)
        return (out, *vjp(gx))

    @jax.jit
    def center_int8(x, y):
        return (jax_center(x, y, 10.0, tp_shard=True, int8_logits=True),)

    with jm:
        out = {"pair": pair(f1, f2, g1, g2), "center": center(f1, f2, g1),
               "center_int8": center_int8(f1, f2)}
    return {k: [np.asarray(x) for x in v] for k, v in out.items()}


def _tp_step(reduce_scatter: bool = False):
    """`_step` of tests/test_torch_parallel.py with cfg.tp_internals on the
    current mesh (DDP over its data group of one); `reduce_scatter` makes
    the gather's backward sum the model group's gradients first."""
    real_cfg = DCNetConfig
    with pytest.MonkeyPatch.context() as m:
        m.setattr("tests.test_torch_parallel.DCNetConfig",
                  lambda **kw: real_cfg(**kw, tp_internals=True))
        if reduce_scatter:
            real = mesh._gather_rows_grad

            def summed(g, group, p):
                g = g.clone()
                torch.distributed.all_reduce(g, group=group)
                return real(g, group, p)

            m.setattr(mesh, "_gather_rows_grad", summed)
        return _step(ddp=True)


def _engine_model():
    cfg = DCNetConfig(**TRAIN)
    return seeded_init_(DCNet(cfg, backbone_defs=mini_backbone_defs(), device="cpu"),
                        seed=1)


def _stream_inputs():
    rng = np.random.RandomState(23)
    return (rng.rand(TICKS, STREAMS, 64, 64, 3).astype(np.float32),
            rng.randint(1, 50, (STREAMS, 20)).astype(np.int64),
            rng.randint(1, 50, (STREAMS, 20)).astype(np.int64))


def _serve(eng, save=None, state=None, start=0, m=None):
    """Ticks start..TICKS-1 of the engine on the seeded streams (the phrase
    swap before SWAP_AT, the state saved before SAVE_AT to `save`): (state,
    [(fused, raw, score)] per tick as numpy)."""
    frames, ids, ids_b = _stream_inputs()
    state = eng.init_state(ids) if state is None else state
    outs = []
    for t in range(start, TICKS):
        if t == SWAP_AT:
            state = eng.update_queries(state, ids_b, mask=SWAP_MASK)
        if t == SAVE_AT and save:
            pengine.save_stream_state(save, state, mesh=m)
        state, fused, raw, score = eng.step(state, frames[t])
        outs.append([x.numpy().copy() for x in (fused, raw, score)])
    return state, outs


def _engines(rank: int, out: str) -> dict:
    """On a (data 2, model 1) mesh: the one-process engine (each rank runs
    it whole; rank 0 saves its state), the mesh engine from the start and
    from the one-process state; rank 0 resumes the pair's state alone."""
    model = _engine_model()
    plain = pengine.GroundingEngine(model, STREAMS, topk=3, fuse_window=3,
                                    donate_state=False)
    _, want = _serve(plain, save=os.path.join(out, "one.npz") if rank == 0 else None)
    m = mesh.make_mesh(2, 1)
    mesh.barrier()
    eng = pengine.GroundingEngine(model, STREAMS, topk=3, fuse_window=3, mesh=m)
    replays = COUNTERS["graph_replays"]
    _, got = _serve(eng, save=os.path.join(out, "pair.npz"), m=m)
    resumed = pengine.load_stream_state(os.path.join(out, "one.npz"), CPU, mesh=m)
    _, from_one = _serve(eng, state=resumed, start=SAVE_AT)
    res = {"want": want, "mesh": got, "pair_from_one": from_one,
           "graphs": {"replays": COUNTERS["graph_replays"] - replays,
                      "kept": eng._graphs is not None,
                      "mesh": _graphable_on_a_card(eng),
                      "no_mesh": _graphable_on_a_card(pengine.GroundingEngine(
                          model, STREAMS, topk=3, fuse_window=3))}}
    if rank == 0:
        state = pengine.load_stream_state(os.path.join(out, "pair.npz"), CPU)
        _, res["one_from_pair"] = _serve(plain, state=state, start=SAVE_AT)
    return res


def _rank(rank: int, init: str, out: str) -> None:
    torch.set_num_threads(1)
    pcorr._sample_negatives_excluding = _negatives
    mesh.init_distributed(CPU, RANKS, rank, init)
    try:
        mesh.make_mesh(1, 2)
        res = {"ops": _port_ops(), "step": _tp_step(),
               "reduce_scatter": _tp_step(reduce_scatter=True)}
        torch.manual_seed(0)
        model = _engine_model()
        model.cfg = model.cfg.replace(tp_internals=True)
        images, ids = _batch()["images"][:5], _batch()["word_ids"][:1]
        res["eval"] = [o.numpy() for o in model.eval_clip(images, ids).outbox]
        mesh.clear_mesh()
        res["engine"] = _engines(rank, out)
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        mesh.shutdown()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, devices):
    """The two ranks' results, and this process's references computed
    while they run: the JAX ops, the one-process step and eval_clip."""
    out = str(tmp_path_factory.mktemp("mesh"))
    init = "file://" + os.path.join(out, "store")
    ctx = mp.start_processes(_rank, args=(init, out), nprocs=RANKS, join=False,
                             start_method="spawn")
    ref = {"ops": _jax_ops(devices)}
    with pytest.MonkeyPatch.context() as m:
        m.setattr(pcorr, "_sample_negatives_excluding", _negatives)
        ref["step"] = _step()
        images, ids = _batch()["images"][:5], _batch()["word_ids"][:1]
        ref["eval"] = [o.numpy() for o in _engine_model().eval_clip(images, ids).outbox]
    while not ctx.join():
        pass
    return ref, [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
                 for r in range(RANKS)]


@pytest.mark.parametrize("op", ["pair", "center", "center_int8"])
def test_sharded_ops_match_jax_tp_shard(ranks, op):
    """Outputs (and for the float ops the gradients of both inputs) of each
    rank against JAX's tp_shard=True functions on a (1, 2) mesh."""
    ref, got = ranks
    for r in got:
        assert len(r["ops"][op]) == len(ref["ops"][op])
        for i, (a, b) in enumerate(zip(r["ops"][op], ref["ops"][op])):
            np.testing.assert_allclose(a, b, **TOL, err_msg=f"{op} output {i}")


def test_tp_step_equals_the_one_process_step(ranks):
    want, grads, stats = ranks[0]["step"]
    for r in ranks[1]:
        metrics, got, got_stats = r["step"]
        np.testing.assert_allclose(metrics["loss"], want["loss"], rtol=LOSS_RTOL)
        assert _grads_close(got, grads) == []
        for n, t in got_stats.items():
            torch.testing.assert_close(t, stats[n], **STATS_TOL, msg=n)
    first = ranks[1][0]["step"][2]
    assert all(torch.equal(t, first[n]) for n, t in ranks[1][1]["step"][2].items())


def test_a_sum_in_the_gather_backward_misses_the_limits(ranks):
    """A reduce-scatter in the gather's backward doubles the gradient that
    the co-attention passes up: the backbone's gradient misses GRAD_REL."""
    (_, grads, _), got = ranks[0]["step"], ranks[1]
    for r in got:
        wrong = _grads_close(r["reduce_scatter"][1], grads)
        assert any(n.startswith("visumodel.") for n in wrong), wrong
        assert _grads_close(r["step"][1], grads) == []
    assert GRAD_REL == 1e-4 and GRAD_ABS == 1e-5


def test_tp_eval_clip_equals_the_one_process_eval_clip(ranks):
    ref, got = ranks
    for r in got:
        for a, b in zip(r["eval"], ref["eval"]):
            np.testing.assert_allclose(a, b, **TOL)


def test_mesh_engine_matches_the_one_process_engine(ranks):
    """Every tick's fused and raw boxes and scores, global on both ranks,
    the query swap across both shards included."""
    _, got = ranks
    for r in got:
        e = r["engine"]
        assert len(e["mesh"]) == TICKS
        for t, (a, b) in enumerate(zip(e["mesh"], e["want"])):
            for x, y in zip(a, b):
                assert x.shape[0] == STREAMS
                np.testing.assert_allclose(x, y, **ENGINE_TOL, err_msg=f"tick {t}")


def test_mesh_engine_keeps_the_eager_tick(ranks):
    """A mesh engine (its all-gathers, its streams' shards) never replays a
    CUDA graph, on a card as here; the same engine without a mesh would."""
    _, got = ranks
    for r in got:
        assert r["engine"]["graphs"] == {"replays": 0, "kept": False, "mesh": False,
                                         "no_mesh": True}


def test_stream_state_moves_between_one_and_two_processes(ranks):
    """The pair's state file resumes in one process, and a one-process
    file in the pair, as the uninterrupted one-process run goes on."""
    _, got = ranks
    want = got[0]["engine"]["want"][SAVE_AT:]
    for name, runs in (("one_from_pair", [got[0]["engine"]["one_from_pair"]]),
                       ("pair_from_one", [r["engine"]["pair_from_one"] for r in got])):
        for run in runs:
            for t, (a, b) in enumerate(zip(run, want)):
                for x, y in zip(a, b):
                    np.testing.assert_allclose(x, y, **ENGINE_TOL,
                                               err_msg=f"{name} tick {SAVE_AT + t}")


def test_streams_not_divided_by_the_data_axis_raise(tmp_path):
    """A data sharding takes whole, equal shards (as JAX's); the serving
    bundle exports one process's engine and refuses a mesh engine's."""
    from dcnet_tpu_torch.serving.export import export_engine
    model = _engine_model()
    two = mesh.Mesh(n_data=2, n_model=1, data_rank=1)
    eng = pengine.GroundingEngine(model, 4, mesh=two)
    assert eng.shard == slice(2, 4)
    with pytest.raises(ValueError, match="3 streams do not shard over the mesh's 2"):
        pengine.GroundingEngine(model, 3, mesh=two)
    with pytest.raises(ValueError, match="without a mesh"):
        export_engine(eng, str(tmp_path))


@pytest.mark.parametrize("windows", [
    ((0, 20), (20, 20)), ((0, 10), (10, 10), (20, 10), (30, 10)),
    ((0, 11), (11, 17), (28, 12))])
def test_plain_windows_match_jax_rows(windows):
    """attend_plain / attend_bwd_plain on windows of P = 40 against the
    rows of JAX's coattention_one (interpret mode) and its vjp: each
    window's rows of the output and of dq; dkv of a window is the vjp of
    the gradient masked to the window, and the windows' dkv sum to the
    whole frame's."""
    rng = np.random.RandomState(len(windows))
    q, kv = (rng.randn(1, 40, 16).astype(np.float32) * 0.3 for _ in range(2))
    g = rng.randn(1, 40, 16).astype(np.float32) * 0.1
    n = len(windows)
    masks = np.zeros((n, 40, 1), np.float32)
    for i, (r0, rows) in enumerate(windows):
        masks[i, r0:r0 + rows] = 1.0
    qs, kvs = np.repeat(q, n, 0), np.repeat(kv, n, 0)
    out, vjp = jax.vjp(lambda x, y: jax_one(x, y, 10.0, True),
                       jnp.asarray(qs), jnp.asarray(kvs))
    dq_want, dkv_want = (np.asarray(x) for x in vjp(jnp.asarray(g * masks)))
    out = np.asarray(out)
    tq, tkv, tg = (torch.from_numpy(x) for x in (q, kv, g))
    total = torch.zeros_like(tkv)
    for i, (r0, rows) in enumerate(windows):
        got = coattn.attend_plain(tq, tkv, 10.0, r0, rows)
        np.testing.assert_allclose(got.numpy(), out[i:i + 1, r0:r0 + rows], **TOL)
        dq, dkv = coattn.attend_bwd_plain(tq, tkv, 10.0, tg[:, r0:r0 + rows], r0)
        assert dq.shape == (1, rows, 16) and dkv.shape == (1, 40, 16)
        np.testing.assert_allclose(dq.numpy(), dq_want[i:i + 1, r0:r0 + rows], **TOL)
        np.testing.assert_allclose(dkv.numpy(), dkv_want[i:i + 1], **TOL)
        total += dkv
    whole = coattn.attend_bwd_plain(tq, tkv, 10.0, tg)[1]
    np.testing.assert_allclose(total.numpy(), whole.numpy(), **TOL)
    with pytest.raises(ValueError, match="does not lie"):
        coattn.attend_plain(tq, tkv, 10.0, 30, 11)


def test_row_windows_cover_the_rows():
    for p, n in ((15, 2), (64, 2), (7, 4), (1024, 3)):
        spans = [mesh.row_window(p, n, r) for r in range(n)]
        assert sum(rows for _, rows in spans) == p
        assert all(spans[i][0] + spans[i][1] == spans[i + 1][0] for i in range(n - 1))
        assert max(s[1] for s in spans) - min(s[1] for s in spans) <= 1


def test_serve_cli_devices_2_serves_as_one_process(tmp_path, monkeypatch, caplog):
    """The JAX serve CLI builds no mesh for --devices; neither does the
    port's: the same state as the plain run, and a log line that says so."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DCNET_PLATFORM", "cpu")
    caplog.set_level(logging.INFO)
    argv = ["--synthetic", "--lstm", "--mini", "--size", "64", "--emb_size", "64",
            "--lstm_hidden", "64", "--n_streams", "2", "--ticks", "3"]
    states = []
    for extra in ([], ["--devices", "2"]):
        with contextlib.redirect_stdout(io.StringIO()):
            states.append(pserve.main(argv + extra))
    for a, b in zip(states[0][1:6], states[1][1:6]):
        assert torch.equal(a, b)
    assert any("no mesh" in rec.getMessage() for rec in caplog.records)


def test_dryrun_multichip_on_two_cpu_ranks(capsys, monkeypatch):
    lines = dryrun_multichip(2, device="cpu")
    assert lines[0].startswith("dryrun_multichip(2): loss=") and lines[0].endswith(" ok")
    assert lines[1:] == ["dryrun_multichip(2): eval_clip sharded B=2 ok",
                         "dryrun_multichip(2): serving step streams=2 ok"]
    assert mesh.world() == (1, 0) and mesh.model_group() is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):   # the card unless asked
        dryrun_multichip(2)
