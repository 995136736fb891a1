"""K1's CUDA kernel on the card, against its plain PyTorch version.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda -q

Without a CUDA card every test here skips: the kernel is CUDA C++ with no
CPU mode (its plain version is held against the JAX package in
`tests/test_torch_coattn.py`).
"""

import pytest
import torch

from dcnet_tpu_torch import kernels
from dcnet_tpu_torch.kernels import coattn

pytestmark = pytest.mark.cuda
# On l2-normalised rows (C=512) an output element is about 0.044/sqrt(P),
# 1.4e-3 at P=1024: the bf16 limit is one bf16 step of the output (2^-7
# relative) plus 2e-4, well under the outputs themselves.
TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5),
       torch.bfloat16: dict(rtol=1e-2, atol=2e-4)}
REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}  # ||got-want||/||want||


def _rel(got, want):
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the K1 kernel is CUDA C++ with no "
                    "CPU mode")
    return torch.device("cuda", 0)


def _rows(gen, *shape):
    """l2-normalised rows, like the mapped features on the main path."""
    return torch.nn.functional.normalize(torch.randn(*shape, generator=gen), dim=-1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_card(card, dtype):
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(0)
    for p in (64, 169, 256, 1024):
        q = _rows(gen, 8, p, 512).to(card, dt)
        kv = _rows(gen, 8, p, 512).to(card, dt)
        got = coattn.coattention_one(q, kv, 10.0)
        want = coattn.attend_plain(q, kv, 10.0)
        torch.cuda.synchronize()
        assert got.dtype == dt and got.shape == q.shape
        torch.testing.assert_close(got.float(), want.float(), **TOL[dt])
        assert _rel(got, want) <= REL_TOL[dt]
        # the limits are tight enough to reject zeros and a dropped T
        assert _rel(coattn.attend_plain(q, kv, 1.0), want) > REL_TOL[dt]
        assert _rel(torch.zeros_like(want), want) > REL_TOL[dt]


def test_kernel_takes_frames_sliced_from_a_clip(card):
    """The main path hands K1 frames of a (B, n, h, w, C) clip: batch-strided
    NHWC views. The NHWC wrapper gives what the plain version gives."""
    gen = torch.Generator().manual_seed(1)
    clip = _rows(gen, 4, 5, 13, 13, 64).to(card)
    got = coattn.coattention_center_fused(clip[:, 2], clip[:, 0], 10.0)
    want = coattn.attend_plain(clip[:, 2].reshape(4, 169, 64),
                               clip[:, 0].reshape(4, 169, 64), 10.0)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.reshape(4, 169, 64), want, **TOL[torch.float32])


def test_each_launch_counts_once(card):
    q = _rows(torch.Generator().manual_seed(2), 2, 64, 32).to(card)
    kernels.reset_launches()
    coattn.coattention_one(q, q, 10.0)
    coattn.coattention_center_fused(q.reshape(2, 8, 8, 32), q.reshape(2, 8, 8, 32))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["coattn_attend"] == 2


def test_kernel_refuses_what_it_cannot_take(card):
    """It raises instead of falling back to the plain version."""
    q = torch.zeros(2, 64, 32, device=card)
    kernels.reset_launches()
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        coattn.coattention_one(q.half(), q.half(), 10.0)
    with pytest.raises(ValueError, match="C % 16"):
        coattn.coattention_one(q[..., :24], q[..., :24], 10.0)
    with pytest.raises(ValueError, match="contiguous"):
        coattn.coattention_one(q.transpose(1, 2), q.transpose(1, 2), 10.0)
    with pytest.raises(ValueError, match="CUDA"):
        coattn.coattention_one(q, q.cpu(), 10.0)
    assert kernels.LAUNCHES["coattn_attend"] == 0
