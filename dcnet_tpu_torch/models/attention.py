"""Phrase attention over the language context.

The port of `dcnet_tpu/models/attention.py`: a 1-unit linear scorer over the
BiLSTM context, softmax over the words, zeroed at pad ids (0), renormalised
(with the JAX package's +1e-12), then used to pool the word embeddings.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


class PhraseAttention(nn.Module):
    def __init__(self, input_dim: int, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.fc = nn.Linear(input_dim, 1, device=device)
        self.dtype = dtype

    def forward(self, context: torch.Tensor, embedded: torch.Tensor,
                word_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """context (B, L, D), embedded (B, L, E), word_ids (B, L) ->
        (attn (B, L), weighted_emb (B, E))."""
        scores = F.linear(context.to(self.dtype), self.fc.weight.to(self.dtype),
                          self.fc.bias.to(self.dtype))[..., 0]
        attn = torch.softmax(scores, dim=-1)
        attn = attn * (word_ids != 0).to(attn.dtype)
        attn = attn / (attn.sum(dim=1, keepdim=True) + 1e-12)
        return attn, torch.einsum("bl,ble->be", attn, embedded.to(attn.dtype))
