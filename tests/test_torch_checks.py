"""The checks `chip_smoke.py` holds the kernels to, on CPU tensors: fp32 K3
against its plain version in float64 (`k3_check`: limits that add the size
of the summands) and K5 against the plain version on float64 copies
(`loc_gram_held`). Each must accept the plain fp32 version, which is what
fp32 arithmetic gives, and reject the wrong answers it is shown against on
the card: zeros, T=1 and a K3 that skips a streamed tile of 16 rows; zeros,
a dropped obj and a dropped bias for K5.
"""

import pytest
import torch

import chip_smoke
from dcnet_tpu_torch.kernels import coattn, locgram

T = 10.0


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
