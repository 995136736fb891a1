"""Dual correspondence sampling: the port of `dcnet_tpu/ops/correspondence.py`.

- inter-frame pairs: the dense patch correlation of two frames on the
  coarsest scale, its global top-k entries as (query, key) pairs, and
  `neg_n` random patches of frame 2 other than the key as negatives;
- cross-modal pairs: the top-k words of each patch in the smoothed
  word-patch map as positives, `neg_n` random other patches of the same
  image as negatives.

Top-k keeps `lax.top_k`'s order among ties (lower index first) through a
stable descending sort: in the correlation of two identical frames
corr[p, q] == corr[q, p], so ties are real. Negatives are drawn without
replacement by a top-k over masked uniforms from an explicit
`torch.Generator` (JAX's PRNG streams cannot be reproduced here). The
sampler is looked up at call time as the module attribute
`_sample_negatives_excluding`, so a caller may replace it (the parity tests
give both packages the same deterministic negatives).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F


class ContrastiveSamples(NamedTuple):
    q: torch.Tensor    # (B, K, C) query features
    k: torch.Tensor    # (B, K, Kpos, C) positive key features
    neg: torch.Tensor  # (B, K, N, C) negative features


def top_k_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries along the last axis, ties in index
    order, as `lax.top_k` returns them."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def _sample_negatives_excluding(generator: Optional[torch.Generator],
                                pos_idx: torch.Tensor, num_items: int,
                                neg_n: int) -> torch.Tensor:
    """`neg_n` indices from [0, num_items) without replacement, never
    pos_idx. pos_idx: (...,) integer. Returns (..., neg_n) int64."""
    u = torch.rand(pos_idx.shape + (num_items,), generator=generator,
                   device=pos_idx.device)
    u = u - 2.0 * F.one_hot(pos_idx.long(), num_items).to(u.dtype)
    return top_k_indices(u, neg_n)


def _gather_rows(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """feats (B, P, C), idx (B, ...) -> (B, ..., C): feats[b, idx[b, ...]]."""
    b, _, c = feats.shape
    flat = idx.reshape(b, -1).long()
    out = torch.gather(feats, 1, flat[..., None].expand(b, flat.shape[1], c))
    return out.reshape(*idx.shape, c)


def interframe_pairs(f1: torch.Tensor, f2: torch.Tensor, top_k: int,
                     neg_n: int, generator: Optional[torch.Generator] = None
                     ) -> ContrastiveSamples:
    """f1, f2: (B, H, W, C) coarsest-scale mapped features of two frames.
    corr[b, p, q] = <f1_p, f2_q>; the global top-k of the flattened (P*P)
    map gives the pairs (p = idx // P, q = idx % P)."""
    b, h, w, c = f1.shape
    p = h * w
    if top_k > p * p or neg_n > p - 1:
        raise ValueError(f"top_k {top_k} / neg_n {neg_n} exceed the {p * p} "
                         f"correlation entries / {p - 1} negatives")
    pf1 = f1.reshape(b, p, c)
    pf2 = f2.reshape(b, p, c)
    with torch.no_grad():
        corr = torch.einsum("bpc,bqc->bpq", pf1, pf2).reshape(b, p * p)
        idx = top_k_indices(corr, top_k)                       # (B, K)
    q_idx, k_idx = idx // p, idx % p
    neg_idx = _sample_negatives_excluding(generator, k_idx, p, neg_n)
    return ContrastiveSamples(q=_gather_rows(pf1, q_idx),
                              k=_gather_rows(pf2, k_idx)[:, :, None, :],
                              neg=_gather_rows(pf2, neg_idx))


def crossmodal_pairs(word_patch_map: torch.Tensor, lang: torch.Tensor,
                     vit: torch.Tensor, top_k: int, neg_n: int,
                     generator: Optional[torch.Generator] = None
                     ) -> ContrastiveSamples:
    """word_patch_map (B, L, P) smoothed and softmaxed; lang (B, L, C) the
    interpolated language context; vit (B, P, C) the patch features. The
    top-`top_k` words per patch are the positives; `neg_n` other patches of
    the same image the negatives."""
    b, _, p = word_patch_map.shape
    with torch.no_grad():
        cols = top_k_indices(word_patch_map.transpose(1, 2), top_k)  # (B, P, K)
    patch_ids = torch.arange(p, device=vit.device).expand(b, p)
    neg_idx = _sample_negatives_excluding(generator, patch_ids, p, neg_n)
    return ContrastiveSamples(q=vit, k=_gather_rows(lang, cols),
                              neg=_gather_rows(vit, neg_idx))
