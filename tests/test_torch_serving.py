"""The port's streaming engine (`dcnet_tpu_torch.serving.engine`) against
the JAX package's `GroundingEngine`, tick by tick, on the same weights,
frames and phrases (mini defs at 64 px, 3 streams, 10 ticks, the serving
configuration's topk 5 and fuse window 5, a query swap on one stream
before tick 5), and the temporal fusion helpers against
`dcnet_tpu/eval/temporal.py`.

The JAX side runs its co-attention through its Pallas kernels in interpret
mode, as its serving path does on a TPU: on the CPU its multiref dispatch
would take an einsum fallback whose int8 logits differ from the kernel's.

Tolerances, fp32: boxes rtol 1e-4 / atol 1e-3 (pixels), scores rtol 1e-4 /
atol 1e-5, float rings and cached features rtol 1e-4 / atol 1e-5 (XLA's
and torch's CPU convolutions sum in other orders); int8 rings equal.
bf16 (both sides with `cast_params_for_serving`): bf16 rounding depends on
operation order, so the port's distance from the JAX package's fp32 run
(relative l2 over all ticks) must be at most twice the JAX package's own
bf16 distance, plus 1e-3.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import dcnet_tpu.ops.pallas.coattn as jax_pallas
from dcnet_tpu.config import DCNetConfig as JaxConfig
from dcnet_tpu.eval import temporal as jax_temporal
from dcnet_tpu.models import DCNet as JaxDCNet
from dcnet_tpu.models.darknet import mini_backbone_defs as jax_mini_defs
from dcnet_tpu.models.dcnet import DCNet as JaxDCNetCls
from dcnet_tpu.serving import engine as jax_engine
from dcnet_tpu_torch.eval import temporal
from dcnet_tpu_torch.ops.decode import decode_best
from dcnet_tpu_torch.serving import engine
from dcnet_tpu_torch.weights import state_dict_from_jax
from tests.test_torch_slice import SMALL, _rel_gap, jax_model, port_model

N, TICKS, SWAP_AT, SAVE_AT, TOPK, WINDOW = 3, 10, 5, 6, 5, 5
SWAP_MASK = np.array([False, True, False])
BOX_TOL = dict(rtol=1e-4, atol=1e-3)
SCORE_TOL = dict(rtol=1e-4, atol=1e-5)
FEAT_TOL = dict(rtol=1e-4, atol=1e-5)
# name -> (config overrides, engine keywords, compute dtype)
MODES = {
    "k1": (dict(), dict(), "float32"),
    "k1_int8": (dict(), dict(int8_rings=True), "float32"),
    "k1_shift": (dict(split_corr_conv=False), dict(rotate_rings=False), "float32"),
    "multiref": (dict(coattn_multiref=True, split_corr_conv=False), dict(), "float32"),
    "multiref_int8": (dict(coattn_multiref=True), dict(int8_rings=True), "float32"),
    "bf16_multiref": (dict(coattn_multiref=True, split_corr_conv=False), dict(),
                      "bfloat16"),
    "bf16_k1_int8": (dict(), dict(int8_rings=True), "bfloat16"),
}
FP32 = [m for m in MODES if MODES[m][2] == "float32"]
FP32_OF = {"bf16_multiref": "multiref", "bf16_k1_int8": "k1_int8"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread in this file's processes: the suite runs files in
    parallel workers, where per-op thread pools oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    _, _, variables = jax_model()
    rng = np.random.RandomState(21)
    frames = rng.rand(TICKS, N, 64, 64, 3).astype(np.float32)
    ids = rng.randint(1, 50, (N, 20)).astype(np.int32)
    ids[2, 8:] = 0  # a padded phrase
    ids_b = rng.randint(1, 50, (N, 20)).astype(np.int32)
    return variables, frames, ids, ids_b


def _jax_kernels_patched(mp):
    """The JAX model's co-attention through its Pallas kernels in interpret
    mode (as on a TPU): K1 per reference, K4 for the multiref ring."""
    mp.setattr(jax_pallas, "coattention_ring_fused",
               functools.partial(jax_pallas.coattention_ring_fused,
                                 interpret=True))
    mp.setattr(JaxDCNetCls, "_coattn_center",
               lambda self, f1, f2: jax_pallas.coattention_center_fused(
                   f1, f2, self.cfg.coattn_temperature, interpret=True))


def jax_engine_for(mode, variables):
    over, kw, dtype = MODES[mode]
    cfg = JaxConfig(**SMALL, **over, compute_dtype=dtype)
    model = JaxDCNet(cfg=cfg, dtype=jnp.dtype(dtype), backbone_defs=jax_mini_defs())
    if dtype == "bfloat16":
        variables = jax_engine.cast_params_for_serving(variables)
    return jax_engine.GroundingEngine(model, variables, cfg, n_streams=N,
                                      n_frame=5, topk=TOPK, fuse_window=WINDOW,
                                      donate_state=False, **kw)


def port_engine_for(mode, variables, **engine_kw):
    over, kw, dtype = MODES[mode]
    _, model = port_model(variables, **over, compute_dtype=dtype)
    if dtype == "bfloat16":
        engine.cast_params_for_serving(model)
    return engine.GroundingEngine(model, n_streams=N, n_frame=5, topk=TOPK,
                                  fuse_window=WINDOW, **{**kw, **engine_kw})


def serve(eng, mod, frames, ids, ids_b, save_path, state=None, start=0):
    """Ticks start..TICKS-1 (the phrase swap before SWAP_AT, the state
    saved before SAVE_AT): (final state, [(fused, raw, score)] as fp32
    numpy per tick)."""
    state = eng.init_state(ids) if state is None else state
    outs = []
    for t in range(start, TICKS):
        if t == SWAP_AT:
            state = eng.update_queries(state, ids_b, mask=SWAP_MASK)
        if t == SAVE_AT and save_path:
            mod.save_stream_state(save_path, state)
        state, fused, raw, score = eng.step(state, frames[t])
        outs.append(tuple(
            (x.float().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32))
            for x in (fused, raw, score)))
    return state, outs


@pytest.fixture(scope="module")
def runs(setup, tmp_path_factory):
    """mode -> the JAX and the port engine's runs over the same ticks, each
    saving its state before SAVE_AT; computed once per mode."""
    variables, frames, ids, ids_b = setup
    tmp = tmp_path_factory.mktemp("states")
    cache = {}

    def get(mode):
        if mode not in cache:
            with pytest.MonkeyPatch.context() as mp:
                _jax_kernels_patched(mp)
                jeng = jax_engine_for(mode, variables)
                jpath = str(tmp / f"{mode}_jax.npz")
                with jax.default_matmul_precision("highest"):
                    jstate, jouts = serve(jeng, jax_engine, frames, ids, ids_b, jpath)
            peng = port_engine_for(mode, variables, donate_state=False)
            ppath = str(tmp / f"{mode}_port.npz")
            pstate, pouts = serve(peng, engine, frames, ids, ids_b, ppath)
            cache[mode] = dict(jeng=jeng, jstate=jstate, jouts=jouts, jpath=jpath,
                               peng=peng, pstate=pstate, pouts=pouts, ppath=ppath)
        return cache[mode]

    return get


def _assert_outs_close(got, want, first_tick=0):
    for t, (g, w) in enumerate(zip(got, want), start=first_tick):
        np.testing.assert_allclose(g[0], w[0], **BOX_TOL, err_msg=f"fused, tick {t}")
        np.testing.assert_allclose(g[1], w[1], **BOX_TOL, err_msg=f"raw, tick {t}")
        np.testing.assert_allclose(g[2], w[2], **SCORE_TOL, err_msg=f"score, tick {t}")


@pytest.mark.parametrize("mode", FP32)
def test_engine_matches_jax_tick_by_tick(runs, mode):
    """Raw and fused boxes and scores at every tick, the query swap
    included."""
    r = runs(mode)
    assert len(r["pouts"]) == TICKS
    _assert_outs_close(r["pouts"], r["jouts"])


@pytest.mark.parametrize("mode", FP32)
def test_engine_state_matches_jax(runs, mode):
    """After the run: the rings (int8 rings equal), the top-k caches, the
    frame counts, phrases, cached language features and the slot."""
    p, j = runs(mode)["pstate"], runs(mode)["jstate"]
    assert p.slot == int(j.slot)
    np.testing.assert_array_equal(p.frames_seen.numpy(), np.asarray(j.frames_seen))
    np.testing.assert_array_equal(p.word_ids.numpy(), np.asarray(j.word_ids))
    for a, b in zip(p.feat_rings, j.feat_rings):
        assert str(a.dtype).replace("torch.", "") == np.asarray(b).dtype.name
        if a.dtype == torch.int8:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **FEAT_TOL)
    for a, b in zip(p.language, j.language):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **FEAT_TOL)
    np.testing.assert_allclose(p.cache_feats.numpy(), np.asarray(j.cache_feats),
                               **FEAT_TOL)
    np.testing.assert_allclose(p.cache_boxes.numpy(), np.asarray(j.cache_boxes),
                               **BOX_TOL)
    np.testing.assert_allclose(p.cache_scores.numpy(), np.asarray(j.cache_scores),
                               **SCORE_TOL)


@pytest.mark.parametrize("mode", sorted(FP32_OF))
def test_bf16_engine_matches_jax_bf16(runs, mode):
    """bf16 engines with cast parameters: the rings stay bf16 (or int8) and
    the cached features bf16, and on the continuous outputs (the raw score
    of every tick, the final top-k cache scores, the rings) the port is no
    further from the JAX fp32 run than twice the JAX bf16 run is. Boxes are
    held in fp32 only: on random weights the conf argmax flips between
    near-tied cells at any rounding (one tick here picks a cell of conf
    0.307 where fp32 picks one of 0.318), on either side."""
    r, ref = runs(mode), runs(FP32_OF[mode])
    p, j, w = r["pstate"], r["jstate"], ref["jstate"]
    assert p.cache_feats.dtype == torch.bfloat16
    assert all(x.dtype in (torch.bfloat16, torch.int8) for x in p.feat_rings)
    assert all(np.isfinite(o[i]).all() for o in r["pouts"] for i in range(3))
    pairs = [("score", np.stack([o[2] for o in r["pouts"]]),
              np.stack([o[2] for o in r["jouts"]]),
              np.stack([o[2] for o in ref["jouts"]])),
             ("cache_scores", p.cache_scores, j.cache_scores, w.cache_scores)]
    pairs += [(f"ring {i}", a.float(), b, c) for i, (a, b, c) in enumerate(
        zip(p.feat_rings, j.feat_rings, w.feat_rings))]
    for name, port, jbf, want in pairs:
        port_gap, jax_gap = _rel_gap(port, want), _rel_gap(jbf, want)
        assert port_gap <= 2 * jax_gap + 1e-3, (name, port_gap, jax_gap)


def test_update_queries_matches_jax(setup, runs):
    """Right after a swap of one stream's phrase: the phrases, the cached
    language features (re-encoded for that stream only), the zeroed caches
    and frame count, as JAX's; an empty mask returns the state itself."""
    _, frames, ids, ids_b = setup
    r = runs("k1")
    with pytest.MonkeyPatch.context() as mp:
        _jax_kernels_patched(mp)
        js = r["jeng"].init_state(ids)
        for t in range(2):
            js, *_ = r["jeng"].step(js, frames[t])
        js = r["jeng"].update_queries(js, ids_b, mask=SWAP_MASK)
    ps = r["peng"].init_state(ids)
    for t in range(2):
        ps, *_ = r["peng"].step(ps, frames[t])
    before = ps
    ps = r["peng"].update_queries(ps, ids_b, mask=SWAP_MASK)
    np.testing.assert_array_equal(ps.word_ids.numpy(), np.asarray(js.word_ids))
    np.testing.assert_array_equal(ps.frames_seen.numpy(), [2, 0, 2])
    np.testing.assert_array_equal(ps.frames_seen.numpy(), np.asarray(js.frames_seen))
    for a, b in zip(ps.language, js.language):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **FEAT_TOL)
    for name in ("cache_boxes", "cache_scores", "cache_feats"):
        got = getattr(ps, name).numpy()
        assert not got[1].any()
        np.testing.assert_allclose(got, np.asarray(getattr(js, name)), **BOX_TOL)
    # the input state is left as it was, and streams 0 and 2 keep theirs
    assert before.frames_seen.tolist() == [2, 2, 2]
    for a, b in zip(before.language, ps.language):
        torch.testing.assert_close(a[[0, 2]], b[[0, 2]], rtol=0, atol=0)
    assert r["peng"].update_queries(ps, ids_b, mask=np.zeros(N, bool)) is ps


def test_streaming_matches_offline_eval_clip(setup, runs):
    """After n_frame ticks the raw prediction is eval_clip's on the same 5
    frames, in both correspondence modes."""
    _, frames, ids, _ = setup
    for mode in ("k1", "multiref"):
        eng = runs(mode)["peng"]
        state = eng.init_state(ids)
        for t in range(5):
            state, _, raw, score = eng.step(state, frames[t])
        clip = torch.from_numpy(frames[:5].transpose(1, 0, 2, 3, 4).reshape(-1, 64, 64, 3))
        dec = decode_best(eng.model.eval_clip(clip, torch.from_numpy(ids)).outbox,
                          eng.cfg)
        torch.testing.assert_close(raw, dec.boxes[:, 0], rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(score, dec.score[:, 0], rtol=1e-4, atol=1e-5)


def test_streams_are_independent(setup, runs):
    """Stream 0's outputs do not depend on stream 1's frames."""
    _, frames, ids, _ = setup
    eng = runs("multiref")["peng"]
    other = frames.copy()
    other[:, 1] = np.random.RandomState(3).rand(TICKS, 64, 64, 3)
    sa, sb = eng.init_state(ids), eng.init_state(ids)
    for t in range(6):
        sa, fa, ra, _ = eng.step(sa, frames[t])
        sb, fb, rb, _ = eng.step(sb, other[t])
        torch.testing.assert_close(ra[0], rb[0], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(fa[0], fb[0], rtol=1e-5, atol=1e-5)
    assert not torch.allclose(sa.feat_rings[0][1], sb.feat_rings[0][1])


@pytest.mark.parametrize("mode", ["k1", "multiref_int8"])
def test_rotate_rings_match_shift_rings(setup, runs, mode):
    """The rotating single-slot write gives the shifted layout's predictions
    at every tick; the ring contents are a rotation of each other."""
    _, frames, ids, _ = setup
    rot = runs(mode)["peng"]
    shf = port_engine_for(mode, setup[0], rotate_rings=False)
    sr, ss = rot.init_state(ids), shf.init_state(ids)
    for t in range(8):
        sr, fr, rr, cr = rot.step(sr, frames[t])
        ss, fs, rs, cs = shf.step(ss, frames[t])
        torch.testing.assert_close(rr, rs, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(fr, fs, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(cr, cs, rtol=1e-5, atol=1e-6)
    assert ss.slot == 4 and sr.slot == 7 % 5
    for a, b in zip(sr.feat_rings, ss.feat_rings):
        torch.testing.assert_close(torch.roll(a, -(sr.slot + 1), dims=1), b,
                                   rtol=0, atol=0)


def test_donated_state_is_written_in_place(setup, runs):
    """donate_state=True writes the new frame into the input state's rings;
    donate_state=False (the runs above) leaves them intact."""
    _, frames, ids, _ = setup
    eng = port_engine_for("k1", setup[0])
    s0 = eng.init_state(ids)
    s1, *_ = eng.step(s0, frames[0])
    assert s1.feat_rings[0].data_ptr() == s0.feat_rings[0].data_ptr()
    assert s0.feat_rings[0][:, 0].abs().sum() > 0
    keep = runs("k1")["peng"]
    t0 = keep.init_state(ids)
    t1, *_ = keep.step(t0, frames[0])
    assert t0.feat_rings[0].abs().sum() == 0 and t1.feat_rings[0].abs().sum() > 0


def _graphable_on_a_card(eng) -> bool:
    """`eng._graphable()` as the engine would answer on a card."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(engine.GroundingEngine, "device", torch.device("cuda"))
        mp.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
        return eng._graphable()


# name -> (engine keywords, whether a tick on a card replays a graph)
GRAPH_CASES = {"default": (dict(), True),
               "donate_state_false": (dict(donate_state=False), False),
               "shift_rings": (dict(rotate_rings=False), False)}


@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_tick_replays_a_graph_only_where_one_is_sound(setup, case):
    """On a card only the engine with rotating rings and donated state
    replays CUDA graphs; on the CPU every engine ticks eagerly: no graph
    kept, no replay counted, each tick bitwise the eager tick's."""
    from dcnet_tpu_torch.utils.profiling import COUNTERS

    _, frames, ids, _ = setup
    kw, on_card = GRAPH_CASES[case]
    eng = port_engine_for("multiref", setup[0], **kw)
    twin = engine.GroundingEngine(eng.model, n_streams=N, n_frame=5, topk=TOPK,
                                  fuse_window=WINDOW, **kw)
    assert _graphable_on_a_card(eng) is on_card
    before = dict(COUNTERS)
    s_eng, s_twin = eng.init_state(ids), twin.init_state(ids)
    for t in range(TICKS):
        s_eng, *got = eng.step(s_eng, frames[t])
        s_twin, *want = twin._tick(s_twin, frames[t])
        assert all(torch.equal(a, b) for a, b in zip(got, want)), f"tick {t}"
        assert s_eng.slot == s_twin.slot
    assert eng._graphs is None
    assert COUNTERS["graph_replays"] == before["graph_replays"]
    assert COUNTERS["graph_captures"] == before["graph_captures"]


@pytest.mark.parametrize("trace", ["compiling", "capturing"])
def test_no_graph_under_a_trace_or_a_capture(setup, trace, monkeypatch):
    """Under a `torch.export` / compile trace, or inside a capture of the
    caller's, even the default engine on a card ticks eagerly."""
    eng = port_engine_for("multiref", setup[0])
    monkeypatch.setattr(engine.GroundingEngine, "device", torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: trace == "capturing")
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: trace == "compiling")
    assert not eng._graphable()


@pytest.mark.parametrize("change", ["qparams", "int8_chain", "trunk_mode", "trunk_scales",
                                    "frames_dtype", "streams"])
def test_a_changed_tick_misses_the_graphs_signature(setup, change, monkeypatch):
    """The graphs are kept for one signature: the same tick on a new state
    and new frames keeps it; a new int8 backbone, int8 chain, trunk mode of
    the (shared) model, int8 trunk scales, frames' dtype or number of
    streams misses it, so the engine captures anew rather than replay the
    old tick."""
    from dcnet_tpu_torch.ops import quant as Q

    _, frames, ids, _ = setup
    eng = port_engine_for("multiref", setup[0])
    if change == "trunk_scales":
        monkeypatch.setattr(eng.model, "cfg", eng.model.cfg.replace(trunk_quant="int8"))
    state, fr = eng.init_state(ids), torch.from_numpy(frames[0])
    sig = engine._signature(eng, state, fr)
    assert engine._signature(eng, eng.init_state(ids), fr.clone()) == sig
    if change == "qparams":
        eng.qparams = {}
    elif change == "int8_chain":
        eng.int8_chain = True
    elif change == "trunk_mode":
        monkeypatch.setattr(eng.model, "cfg", eng.model.cfg.replace(trunk_quant="int8"))
    elif change == "trunk_scales":
        scales = Q.trunk_scales(eng.model)
        Q.set_trunk_scales(eng.model, {k: v + 1 for k, v in scales.items()})
        assert engine._signature(eng, state, fr) != sig
        Q.set_trunk_scales(eng.model, scales)      # the values back: still a new version
    elif change == "frames_dtype":
        fr = fr.double()
    else:
        state = eng.init_state(ids[:-1])
    assert engine._signature(eng, state, fr) != sig


def test_fusion_ties_take_the_first_candidate(runs):
    """Before the center cache entry is filled (ticks 0 and 1) every
    candidate's fused score ties and the first candidate of the empty
    entry, the zero box, wins on both sides; a hand-made tie of equal
    candidates also picks the first."""
    for mode in ("k1", "multiref_int8"):
        r = runs(mode)
        for t in (0, 1):
            assert not r["pouts"][t][0].any() and not r["jouts"][t][0].any()
        assert r["pouts"][2][0].any()
    eng = runs("k1")["peng"]
    boxes = torch.arange(2 * WINDOW * TOPK * 4, dtype=torch.float32).reshape(
        2, WINDOW, TOPK, 4)
    scores = torch.full((2, WINDOW, TOPK), 0.5)
    feats = torch.ones((2, WINDOW, TOPK, 8))
    fused = eng._fuse(boxes, scores, feats, torch.tensor([1, 9], dtype=torch.int32))
    torch.testing.assert_close(fused, boxes[:, WINDOW // 2, 0])


def test_jax_state_resumes_in_the_port(setup, runs):
    """JAX serves 6 ticks and saves; the port loads the file and serves
    the rest: the same outputs as JAX serving all 10."""
    _, frames, ids, ids_b = setup
    for mode in ("k1", "multiref_int8"):
        r = runs(mode)
        state = engine.load_stream_state(r["jpath"], device="cpu")
        assert state.slot == (SAVE_AT - 1) % 5
        _, outs = serve(r["peng"], engine, frames, ids, ids_b, None,
                        state=state, start=SAVE_AT)
        _assert_outs_close(outs, r["jouts"][SAVE_AT:], SAVE_AT)


def test_port_state_resumes_in_jax(setup, runs):
    """The reverse: the port's saved state (fp32, and bf16 with int8 rings)
    loads into JAX with the same dtypes and serves on as the port does."""
    _, frames, ids, ids_b = setup
    for mode in ("multiref", "bf16_k1_int8"):
        r = runs(mode)
        state = jax_engine.load_stream_state(r["ppath"])
        port_state = engine.load_stream_state(r["ppath"], device="cpu")
        assert int(state.slot) == port_state.slot
        for a, b in zip(jax.tree_util.tree_leaves(state._replace(slot=None)),
                        jax.tree_util.tree_leaves(port_state._replace(slot=None))):
            assert np.asarray(a).dtype.name == str(b.dtype).replace("torch.", "")
        if MODES[mode][2] != "float32":
            continue
        with pytest.MonkeyPatch.context() as mp:
            _jax_kernels_patched(mp)
            _, outs = serve(r["jeng"], jax_engine, frames, ids, ids_b, None,
                            state=state, start=SAVE_AT)
        _assert_outs_close(outs, r["pouts"][SAVE_AT:], SAVE_AT)


def test_pre_slot_state_resumes_on_a_rotating_engine(setup, runs, tmp_path):
    """A shift-layout state saved without a slot (older files) loads with
    the newest frame in the last slot; the port's rotating engine then
    serves on as JAX's shift engine does."""
    _, frames, ids, ids_b = setup
    r = runs("k1_shift")
    data = dict(np.load(r["jpath"]))
    data.pop("slot")
    path = str(tmp_path / "pre_slot.npz")
    np.savez(path, **data)
    state = engine.load_stream_state(path, device="cpu")
    assert state.slot == 4
    rot = port_engine_for("k1_shift", setup[0], rotate_rings=True)
    _, outs = serve(rot, engine, frames, ids, ids_b, None, state=state,
                    start=SAVE_AT)
    _assert_outs_close(outs, r["jouts"][SAVE_AT:], SAVE_AT)


def test_cast_params_for_serving_equals_jax(setup):
    """Every float parameter rounded to bf16 as JAX rounds it, the BN
    running statistics untouched: the port's cast of the fp32 weights
    equals the JAX cast brought over through state_dict_from_jax."""
    variables = setup[0]
    jcast = jax_engine.cast_params_for_serving(variables)
    as_np = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), jcast)
    want = state_dict_from_jax(as_np["params"], as_np["batch_stats"])
    _, model = port_model(variables)
    engine.cast_params_for_serving(model)
    got = model.state_dict()
    for k, v in want.items():
        torch.testing.assert_close(got[k], torch.from_numpy(v), rtol=0, atol=0,
                                   msg=k)
    assert any(not torch.equal(got[k], torch.from_numpy(np.asarray(v)))
               for k, v in state_dict_from_jax(variables["params"],
                                               variables["batch_stats"]).items())


def _random_cache(seed, t, k, c, ties=False):
    rng = np.random.RandomState(seed)
    boxes = rng.rand(t, k, 4).astype(np.float32) * 64
    scores = rng.rand(t, k).astype(np.float32)
    feats = rng.randn(t, k, c).astype(np.float32)
    if ties:  # duplicate candidates: equal similarities and scores
        feats[:, 1] = feats[:, 0]
        scores[:, 1] = scores[:, 0]
    return boxes, scores, feats


@pytest.mark.parametrize("ties", [False, True])
def test_temporal_fuse_matches_jax(ties):
    boxes, scores, feats = _random_cache(0, 7, 5, 16, ties)
    got = temporal.temporal_fuse(temporal.FrameCache(
        *(torch.from_numpy(x) for x in (boxes, scores, feats))), 5)
    want = jax_temporal.temporal_fuse(jax_temporal.FrameCache(
        *(jnp.asarray(x) for x in (boxes, scores, feats))), 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fuse_per_video_matches_jax():
    boxes, scores, feats = _random_cache(2, 11, 4, 16)
    vids = np.asarray([0, 1, 0, 0, 1, 0, 2, 0, 1, 0, 1], np.int32)
    got = temporal.fuse_per_video(temporal.FrameCache(
        *(torch.from_numpy(x) for x in (boxes, scores, feats))), vids, 5)
    want = jax_temporal.fuse_per_video(jax_temporal.FrameCache(
        *(jnp.asarray(x) for x in (boxes, scores, feats))), vids, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_build_frame_cache_matches_jax(dtype):
    """Top-k decode + feature gather; the cache features leave in fp32
    whatever the maps' dtype. Scores and features are the maps' own values
    and match exactly. The port decodes boxes in fp32 where the JAX package
    decodes a bf16 outbox in bf16 (sigmoid, exp and the corner arithmetic
    each round to bf16), so bf16 boxes agree to within half a pixel."""
    from dcnet_tpu_torch.config import DCNetConfig
    jcfg, pcfg = JaxConfig(image_size=64), DCNetConfig(image_size=64)
    rng = np.random.RandomState(1)
    outbox = [rng.randn(3, 3, 5, g, g).astype(np.float32) for g in pcfg.grids]
    corr = [rng.randn(3, g, g, 8).astype(np.float32) for g in pcfg.grids]
    jdt = jnp.dtype(dtype)
    want = jax_temporal.build_frame_cache(
        [jnp.asarray(o, jdt) for o in outbox], [jnp.asarray(c, jdt) for c in corr],
        6, jcfg)
    got = temporal.build_frame_cache(
        [torch.from_numpy(o).to(getattr(torch, dtype)) for o in outbox],
        [torch.from_numpy(c).to(getattr(torch, dtype)) for c in corr], 6, pcfg)
    assert got.feats.dtype == torch.float32 and want.feats.dtype == jnp.float32
    box_tol = dict(rtol=1e-6, atol=1e-4) if dtype == "float32" else dict(rtol=0, atol=0.5)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), **box_tol)
    for g, w in ((got.scores, want.scores), (got.feats, want.feats)):
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, np.float32))
