"""The checks `chip_smoke.py` holds the kernels to, on CPU tensors: fp32 K3
against its plain version in float64 (`k3_check`: limits that add the size
of the summands) and K5 against the plain version on float64 copies
(`loc_gram_held`). Each must accept the plain fp32 version, which is what
fp32 arithmetic gives, and reject the wrong answers it is shown against on
the card: zeros, T=1 and a K3 that skips a streamed tile of 16 rows; zeros,
a dropped obj and a dropped bias for K5. Also the cli phase's hold of the
card's temporal cache against the CPU's (`cache_agreement`): ranks may
trade only inside runs of tied scores. And the int8 phases' holds: every
K6 call of a path against its plain version (`HeldK6`, on a mini int8
model here), and the quantized tick's raw outputs, cells and boxes card
against CPU (`serve_cells_held` on the records of `DecodeTaps`).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from dcnet_tpu_torch.kernels import coattn, locgram

T = 10.0


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread in this file's processes: the suite runs files in
    parallel workers, where per-op thread pools oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _k3_inputs(seed, b=2, p=64, c=32):
    gen = torch.Generator().manual_seed(seed)
    return (chip_smoke._rows(gen, b, p, c), chip_smoke._rows(gen, b, p, c),
            torch.randn(b, p, c, generator=gen))


@pytest.mark.parametrize("seed", [0, 1])
def test_k3_check_accepts_the_plain_fp32_version(seed):
    q, kv, g = _k3_inputs(seed)
    res = chip_smoke.k3_check(coattn.attend_bwd_plain(q, kv, T, g), q, kv, T, g)
    assert res["ok"]
    assert res["share_of_limit"] == res["plain_fp32_share_of_limit"]
    assert res["plain_fp32_share_of_limit"] <= chip_smoke.K3_PLAIN_SHARE
    assert res["limits_reject"] == {"zeros": True, "T1": True, "dropped_tile": True}
    for (want, terms) in zip(res["want"], res["terms"]):
        assert want.dtype == terms.dtype == torch.float64
        assert (terms >= want.abs() * (1 - 1e-12)).all()  # |sum| <= sum of |terms|


@pytest.mark.parametrize("wrong", ["zeros", "T1", "dropped_tile"])
def test_k3_check_rejects_wrong_answers(wrong):
    """Each wrong answer fails the check, dq and dkv each on its own."""
    q, kv, g = _k3_inputs(2)
    want, terms = chip_smoke.k3_exact(q, kv, T, g)
    got = {"zeros": lambda: [torch.zeros_like(w).float() for w in want],
           "T1": lambda: coattn.attend_bwd_plain(q, kv, 1.0, g),
           "dropped_tile": lambda: [x.float() for x in chip_smoke.k3_dropped_tile(
               q, kv, T, g)]}[wrong]()
    for a, w, m in zip(got, want, terms):
        assert not chip_smoke.k3_agreement(a, w, m)[0]
    assert not chip_smoke.k3_check(got, q, kv, T, g)["ok"]


def test_k3_dropped_tile_leaves_out_sixteen_rows():
    """The dropped-tile K3 is the plain version without the 16 middle rows
    in each sum: with those rows of kv, q and g zeroed where they are
    summed over, and nothing else changed."""
    q, kv, g = _k3_inputs(3)
    dq, dkv = chip_smoke.k3_dropped_tile(q, kv, T, g)
    want_dq, want_dkv = chip_smoke.k3_exact(q, kv, T, g)[0]
    assert not torch.allclose(dq, want_dq) and not torch.allclose(dkv, want_dkv)
    q64, kv64, g64 = (x.double() for x in (q, kv, g))
    w = torch.softmax(T * q64 @ kv64.transpose(1, 2), dim=-1)
    dw = g64 @ kv64.transpose(1, 2)
    ds = w * (dw - (dw * w).sum(-1, keepdim=True))
    kv_cut, q_cut, g_cut = kv64.clone(), q64.clone(), g64.clone()
    for x in (kv_cut, q_cut, g_cut):
        x[:, 32:48] = 0.0
    torch.testing.assert_close(dq, T * ds @ kv_cut)
    torch.testing.assert_close(dkv, T * ds.transpose(1, 2) @ q_cut
                               + w.transpose(1, 2) @ g_cut)


@pytest.fixture(scope="module")
def k5_inputs():
    """ce, obj and the folded w, b of a random location-branch DenseBNReLU at
    the model's P=1344, as `chip_smoke.py`'s kernel phase makes them."""
    gen = torch.Generator().manual_seed(0)
    mod = chip_smoke._random_dense_bn_relu(gen, 1344, 64, torch.float32, "cpu")
    w, b = locgram.fold_dense_bn(mod)
    return chip_smoke._rows(gen, 2, 1344, 8), chip_smoke._rows(gen, 2, 1344), w, b


def test_k5_hold_accepts_the_plain_fp32_version_and_rejects_wrong_answers(k5_inputs):
    ce, obj, w, b = k5_inputs
    got = locgram.loc_gram_plain(ce, obj, w, b)
    assert chip_smoke.loc_gram_reference(ce, obj, w, b).dtype == torch.float64
    ok, err, rel, rej = chip_smoke.loc_gram_held(got, ce, obj, w, b)
    assert ok and rel <= 1e-5
    assert rej == {"zeros": True, "obj_dropped": True, "bias_dropped": True}
    for wrong in (torch.zeros_like(got), locgram.loc_gram_plain(ce, torch.ones_like(obj), w, b),
                  locgram.loc_gram_plain(ce, obj, w, torch.zeros_like(b))):
        assert not chip_smoke.loc_gram_held(wrong, ce, obj, w, b)[0]


def test_k5_hold_in_bf16_is_one_bf16_step_of_the_plain_version(k5_inputs):
    """bf16 ce is held against the plain version on the same inputs (fp32
    sums, one rounding to bf16), which it accepts; zeros still fail."""
    ce, obj, w, b = k5_inputs
    ce16 = ce.bfloat16()
    got = locgram.loc_gram_plain(ce16, obj, w, b)
    ok, _, _, rej = chip_smoke.loc_gram_held(got, ce16, obj, w, b)
    assert ok and all(rej.values())
    assert chip_smoke.loc_gram_reference(ce16, obj, w, b).dtype == torch.bfloat16


def _cache(seed=0, rows=3, k=5):
    rng = np.random.default_rng(seed)
    scores = -np.sort(-rng.random((rows, k)).astype(np.float32), axis=1)
    return {"scores": scores, "boxes": (rng.random((rows, k, 4)) * 200).astype(np.float32),
            "gt_boxes": rng.random((rows, 4)).astype(np.float32),
            "ratios": np.full(rows, 0.5, np.float32), "dws": np.zeros(rows, np.float32),
            "dhs": np.full(rows, 42.0, np.float32), "video_ids": np.arange(rows, dtype=np.int32)}


def _copy(c):
    return {k: v.copy() for k, v in c.items()}


def test_cache_agreement_accepts_fp32_noise_and_tied_ranks():
    want = _cache()
    got = _copy(want)
    got["scores"] *= 1 + 5e-5
    got["boxes"] += 5e-4
    assert chip_smoke.cache_agreement(got, want)["ok"]
    # ranks 1 and 2 tie within the limits: either order is right
    want["scores"][0, 2] = want["scores"][0, 1] - 1e-5
    got = _copy(want)
    got["boxes"][0, [1, 2]] = want["boxes"][0, [2, 1]]
    res = chip_smoke.cache_agreement(got, want)
    assert res["ok"] and len(res["ranks_traded_in_ties"]) == 2
    # the last rank may hold a candidate the reference ranked below k
    got = _copy(want)
    got["boxes"][1, 4] += 8.0
    assert chip_smoke.cache_agreement(got, want)["ok"]
    # in a tail tie it may stand at any of the run's ranks, the reference's
    # tied boxes moving down one
    want["scores"][1, 3] = want["scores"][1, 4] + 1e-5
    got = _copy(want)
    got["boxes"][1, 3] += 8.0
    got["boxes"][1, 4] = want["boxes"][1, 3]
    res = chip_smoke.cache_agreement(got, want)
    assert res["ok"] and [t["reference_rank"] for t in res["ranks_traded_in_ties"]
                          if t["row"] == 1] == [None, 3]


@pytest.mark.parametrize("wrong", ["untied_swap", "box_px", "score", "geometry",
                                   "tied_five_all_unseen", "tail_two_unseen",
                                   "unseen_inside_top"])
def test_cache_agreement_rejects_wrong_caches(wrong):
    want = _cache(1)
    want["scores"][0] = [0.9, 0.7, 0.5, 0.3, 0.1]
    got = _copy(want)
    if wrong == "tied_five_all_unseen":
        # five scores tied within 4e-5: still only one unseen candidate
        want["scores"][2] = 0.5 - np.arange(5, dtype=np.float32) * 1e-5
        got = _copy(want)
        got["boxes"][2] += 50.0
    elif wrong == "tail_two_unseen":
        want["scores"][2, 3] = want["scores"][2, 4] + 1e-5
        got = _copy(want)
        got["boxes"][2, [3, 4]] += 8.0
    elif wrong == "unseen_inside_top":
        # a tie that does not reach rank k admits no unseen candidate
        want["scores"][0] = [0.9, 0.7, 0.69999, 0.3, 0.1]
        got = _copy(want)
        got["boxes"][0, 2] += 8.0
    elif wrong == "untied_swap":
        got["boxes"][0, [0, 1]] = want["boxes"][0, [1, 0]]
    elif wrong == "box_px":
        got["boxes"][2, 1, 0] += 2e-3
    elif wrong == "score":
        got["scores"][1, 3] += 1e-3
    else:
        got["dws"][0] = 0.5
    assert not chip_smoke.cache_agreement(got, want)["ok"]


# --- K6 held on the path's own calls, and the quantized serving hold --------

def _int8_mini_model(**over):
    """The mini-defs DCNet on the CPU with seeded weights, its backbone
    quantized and its trunk calibrated and switched to int8."""
    from dcnet_tpu_torch.config import DCNetConfig
    from dcnet_tpu_torch.models.darknet import mini_backbone_defs
    from dcnet_tpu_torch.models.dcnet import DCNet
    from dcnet_tpu_torch.ops import quant
    from dcnet_tpu_torch.weights import seeded_init_
    cfg = DCNetConfig(image_size=64, corpus_size=50, emb_size=64, lstm_hidden=64,
                      word_embedding_size=64, **over)
    model = DCNet(cfg, backbone_defs=mini_backbone_defs(), device="cpu")
    seeded_init_(model)
    rng = np.random.RandomState(2)
    images = torch.from_numpy(rng.rand(10, 64, 64, 3).astype(np.float32))
    ids = torch.from_numpy(rng.randint(1, 50, (2, 20)))
    qparams = quant.quantize_model_backbone(model, images)
    quant.calibrate_trunk(model, lambda m: m.eval_clip(images, ids, n_frame=5))
    quant.trunk_quant_variant(model, "int8")
    return model, qparams, images, ids


@pytest.mark.parametrize("batch_refs", [False, True])
def test_held_k6_holds_every_call_of_the_int8_path(batch_refs):
    """HeldK6 wraps the path's K6 calls (backbone and trunk), counts them by
    mode and route (the mini model's thin convs on the halo route),
    restores the callers on exit, and fails on a wrong output or a route
    the path must take and did not."""
    from dcnet_tpu_torch.kernels import conv_s8 as k_conv
    from dcnet_tpu_torch.models import heads
    from dcnet_tpu_torch.ops import quant
    model, qparams, images, ids = _int8_mini_model(coattn_batch_refs=batch_refs)
    held = chip_smoke.HeldK6()
    with held:
        quant.quant_eval_clip(model, qparams, images, ids, 5, int8_chain=True)
    assert heads.conv_s8 is k_conv.conv_s8 and quant.conv_s8 is k_conv.conv_s8
    res = held.summary("mini int8 eval", need=("halo",))   # mini widths: all thin
    assert "halo" in res["routes_held"]
    with pytest.raises(AssertionError, match="must take but no held call took"):
        held.summary("mini int8 eval", need=("gather",))
    modes = res["modes"]
    assert res["calls"] == sum(modes.values()) > 0 and res["bitwise_equal"]
    assert any(m.endswith("-> int8") for m in modes)              # the int8 chain
    assert any(m.startswith("fp32/in_scale") for m in modes)      # the trunk's input
    addend = [m for m in modes if "+addend" in m]
    assert addend and all(("x4" in m) == batch_refs for m in addend)
    real = k_conv.conv_s8

    def off_by_one(*a, **kw):
        out = real(*a, **kw)
        return out + 1 if out.dtype == torch.int32 else out

    wrong = chip_smoke.HeldK6()
    k_conv.conv_s8 = off_by_one
    try:
        with wrong:
            quant.quant_eval_clip(model, qparams, images, ids, 5, int8_chain=True)
    finally:
        k_conv.conv_s8 = real
    with pytest.raises(AssertionError, match="differs from its plain version"):
        wrong.summary("mini int8 eval, a faulty K6")


def _taps(idx, top2, box, score, scale=0, outbox=0.0):
    n = len(idx)
    return {"outbox": torch.full((n, 6), outbox),
            "idx": torch.tensor(idx), "top2": torch.tensor(top2, dtype=torch.float32),
            "scale": torch.full((n,), scale), "box": torch.tensor(box, dtype=torch.float32),
            "score": torch.tensor(score, dtype=torch.float32)}


def test_serve_cells_held_accepts_noise_and_near_ties_and_rejects_the_rest():
    strides, tol, atol = (32, 16, 8), 1e-2, 1e-3
    box = [[10.0, 10.0, 110.0, 60.0], [0.0, 0.0, 40.0, 40.0]]
    cpu = [_taps([5, 7], [[2.0, 1.0], [1.0, 0.995]], box, [2.0, 1.0])]
    # within the limits: scores 4e-3 apart, a near tie (gap 5e-3) moved, box
    # of the shared cell 0.4 px apart (limit 1e-2 (8 + 51) + 1e-3 = 0.591)
    near = [[10.4, 10.0, 110.0, 60.0], [50.0, 50.0, 60.0, 60.0]]
    res = chip_smoke.serve_cells_held([_taps([5, 9], [[2.004, 1.0], [1.0, 0.99]], near,
                                             [2.004, 0.996], outbox=0.009)],
                                      cpu, strides, tol, atol)
    assert res["ok"], res
    assert (res["near_ties"], res["cells_moved"], res["cells_equal"]) == (1, 1, 1)
    assert 0.6 < res["max_box_share_of_limit"] < 0.7
    wrongs = {
        "cell moved without a tie": _taps([6, 7], [[2.0, 1.0], [1.0, 0.995]], box, [2.0, 1.0]),
        "box past its limit": _taps([5, 7], [[2.0, 1.0], [1.0, 0.995]],
                                    [[10.7, 10.0, 110.0, 60.0], box[1]], [2.0, 1.0]),
        "score past the limit": _taps([5, 7], [[2.02, 1.0], [1.0, 0.995]], box, [2.02, 1.0]),
        "raw outputs past the limit": _taps([5, 7], [[2.0, 1.0], [1.0, 0.995]], box,
                                            [2.0, 1.0], outbox=0.011),
    }
    for name, got in wrongs.items():
        assert not chip_smoke.serve_cells_held([got], cpu, strides, tol, atol)["ok"], name
    assert not chip_smoke.serve_cells_held([], [], strides, tol, atol)["ok"]


def test_decode_taps_record_the_engines_decodes():
    """DecodeTaps sees the serving engine's decode of each tick: the cell
    and box it records are those the step returns."""
    from dcnet_tpu_torch.serving import engine
    model, qparams, _, ids = _int8_mini_model(coattn_multiref=True)
    eng = engine.GroundingEngine(model, 2)
    eng.qparams = qparams
    state = eng.init_state(ids)
    frames = torch.from_numpy(np.random.RandomState(3).rand(2, 64, 64, 3).astype(np.float32))
    real = engine.decode_best
    with chip_smoke.DecodeTaps() as tap:
        state, fused, raw, score = eng.step(state, frames)
    assert engine.decode_best is real and len(tap.taps) == 1
    t = tap.taps[0]
    assert torch.equal(t["box"], raw) and torch.equal(t["score"], score)
    assert t["top2"].shape == (2, 2) and torch.all(t["top2"][:, 0] >= t["top2"][:, 1])
    grids = model.cfg.grids
    assert t["outbox"].shape == (2, 3 * 5 * sum(g * g for g in grids))
    conf = torch.cat([c.reshape(2, 3, 5, -1)[:, :, 4].reshape(2, -1) for c in
                      torch.split(t["outbox"], [15 * g * g for g in grids], dim=1)], dim=1)
    assert torch.equal(conf.amax(dim=1), t["top2"][:, 0])


@pytest.mark.parametrize("case", [(2, 16, 16, 3, 32, 3, 1, 1, "float32"),
                                  (2, 9, 12, 64, 32, 1, 1, 0, "bfloat16"),
                                  (1, 12, 12, 32, 64, 3, 2, 1, "int8")])
def test_k6_faults_fit_the_halo_walk(case):
    """On the halo route the kernel phase's K6 check holds a dropped k-tile,
    the walk's last tile dropped and two roundings against the plain
    version, and each is shown to miss."""
    from dcnet_tpu_torch.kernels import conv_s8 as k_conv
    n, h, w, ci, co, k, s, p, dt = case
    gen = torch.Generator().manual_seed(ci + co)
    xq = torch.randint(-127, 128, (n, h, w, ci), generator=gen, dtype=torch.int8)
    wt = torch.randint(-127, 128, (co, k, k, ci), generator=gen, dtype=torch.int8)
    plan = k_conv.conv_plan(n, h, w, ci, co, k, s, p, dt)
    assert plan.route == "halo"
    acc, faults = chip_smoke.k6_sums(xq, wt, s, p, plan)
    assert set(faults) == {"dropped_k_tile", "dropped_tile"}
    epi = dict(scale=torch.rand(co, generator=gen) * 1e-4, bias=torch.randn(co, generator=gen),
               act="leaky", out_dtype=torch.float32)
    want = k_conv.epilogue_plain(acc, **epi)
    wrong = chip_smoke.k6_wrong(acc, faults, epi)
    assert set(wrong) == {"dropped_k_tile", "dropped_tile", "two_roundings"}
    assert all(not torch.equal(v, want) for v in wrong.values())


def test_launches_differ_holds_k6_routes_together():
    """A path's expected launches name K6's convolutions once ("k6_convs"):
    the three routes' counts are summed against it, every other kernel is
    held one by one (0 where the expectation names none)."""
    from dcnet_tpu_torch import kernels
    got = dict.fromkeys(kernels.LAUNCHES, 0)
    got.update(conv_s8=2, conv_s8_halo=3, conv_s8_quant=1, coattn_attend=12)
    assert kernels.conv_s8_launches(got) == 5
    want = {"k6_convs": 5, "conv_s8_quant": 1, "coattn_attend": 12}
    assert not chip_smoke.launches_differ(got, want)
    assert chip_smoke.launches_differ(got, dict(want, k6_convs=4))
    assert chip_smoke.launches_differ(dict(got, conv_s8_gather=1), want)
    assert chip_smoke.launches_differ(dict(got, coattn_ring=1), want)
    assert chip_smoke.launches_differ(got, {"conv_s8_quant": 1, "coattn_attend": 12})
    assert chip_smoke.launches_differ(dict(got, bn_act=1), want)
    assert not chip_smoke.launches_differ(dict(got, bn_act=99), dict(want, bn_act=99))


def test_bn_act_per_call_counts_each_float_epilogue():
    """K7's launches a float call: YOLOv3's 72 BatchNorm convs (its 23
    shortcuts folded into them), mapping_visu 3, corr_conv per reference
    or once stacked, the fcn's 4 (light 1) a scale."""
    from dcnet_tpu_torch.models.darknet import mini_backbone_defs
    full = chip_smoke.full_width_config()
    assert chip_smoke.bn_act_per_call(full) == 72 + 3 + 12 + 12
    assert chip_smoke.bn_act_per_call(full.replace(coattn_multiref=True)) == 72 + 3 + 3 + 12
    assert chip_smoke.bn_act_per_call(chip_smoke.serving_config(coattn_multiref=True)) == 99
    assert chip_smoke.bn_act_per_call(full, references=1) == 90
    assert chip_smoke.bn_act_per_call(full.replace(light=True), defs=mini_backbone_defs()) \
        == 8 + 3 + 12 + 3


def test_k6_profile_counts_hold_kernel_names_against_the_counters():
    """K6's launches found by kernel name in a profile equal the wrappers'
    counts only when no launch is lost or misnamed (`profiling.profile_counts`,
    which holds K1-K5 the same way: tests/test_torch_profiling.py)."""
    from dcnet_tpu_torch import kernels
    from dcnet_tpu_torch.utils import profiling
    rows = [(900.0, "void (anonymous namespace)::halo::conv_halo_kernel<float, 32>("
                    "CUtensorMap, Geo, Epilogue)", 2),
            (500.0, "void (anonymous namespace)::conv_tma_kernel<128>(...)", 3),
            (40.0, "void quant_pass_kernel<__nv_bfloat16>(...)", 3),
            (70.0, "void ampere_sgemm_128x64_nn", 1)]
    counted = dict.fromkeys(kernels.LAUNCHES, 0)
    counted.update(conv_s8=3, conv_s8_halo=2, conv_s8_gather=0, conv_s8_quant=3)
    res = profiling.profile_counts(rows, counted)
    assert res["agree"]
    assert {k: res["by_kernel_name"][k] for k in kernels.CONV_S8_KEYS.values()} == \
        {"conv_s8": 3, "conv_s8_halo": 2, "conv_s8_gather": 0}
    assert res["by_kernel_name"]["conv_s8_quant"] == 3
    assert res["ms_by_kernel_name"]["conv_s8_halo"] == 0.9
    assert not profiling.profile_counts(rows[1:], counted)["agree"]   # lost halo launches
    assert not profiling.profile_counts(rows, dict(counted, conv_s8_gather=1))["agree"]


def test_profile_call_discards_lossy_traces_and_fails_when_all_are(monkeypatch, tmp_path):
    """A trace whose launches by kernel name differ from the wrappers'
    counts is discarded and the call traced again; a call whose every
    trace is lossy raises and is listed for `main` to fail on."""
    from types import SimpleNamespace
    from dcnet_tpu_torch import kernels
    from dcnet_tpu_torch.utils import profiling
    cuda = torch.autograd.DeviceType.CUDA
    counted = dict.fromkeys(kernels.LAUNCHES, 0)
    counted.update(conv_s8=1, conv_s8_halo=2)

    def trace(halo_calls):
        events = [SimpleNamespace(device_type=cuda, self_device_time_total=300.0,
                                  key="conv_tma_kernel<64>", count=1),
                  SimpleNamespace(device_type=cuda, self_device_time_total=200.0,
                                  key="halo::conv_halo_kernel<float, 32>", count=halo_calls)]
        return events, "table", 1.0, counted

    traces = iter([trace(1), trace(2)])
    monkeypatch.setattr(profiling, "trace_call", lambda fn: next(traces))
    monkeypatch.setattr(chip_smoke, "PROFILE_FAILURES", [])
    res = chip_smoke.profile_call(None, str(tmp_path), "ok_on_retry")
    assert res["launches"]["agree"] and len(res["traces_discarded"]) == 1
    assert res["device_ms"] == 0.5 and (tmp_path / "profile_ok_on_retry.txt").exists()
    monkeypatch.setattr(profiling, "trace_call", lambda fn: trace(1))
    with pytest.raises(AssertionError, match="every trace lost kernels"):
        chip_smoke.profile_call(None, str(tmp_path), "lossy")
    assert chip_smoke.PROFILE_FAILURES == ["lossy"]
