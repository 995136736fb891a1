"""BiLSTM language encoder.

The port of `dcnet_tpu/models/lstm.py`: Embedding -> Dropout -> Linear+ReLU
-> one bidirectional LSTM layer with packed-sequence semantics, returning
(last-step output (B, 2H), context (B, L, 2H), embedding (B, L, word_vec)).
Where the JAX package masks a `lax.scan`, this packs the padded batch
in training (`pack_padded_sequence`), which the masked scan reproduces
exactly. Inference runs `unpacked`: the `nn.LSTM` on the padded batch for
the forward direction, and on each sequence moved to the end of its row
(a gather) for the backward one, positions past a sequence's length
zero. It needs no host copy of the
lengths (no sync) and `torch.export` takes it, so the serving bundle's
language program computes what the live engine computes, bit for bit.
The two forms agree within fp32 rounding (1e-7 here); training keeps
packing, whose rounding the train parity tests against the JAX package
hold (the unpacked form's moved the k=3 fp32 gradients past their limit). Children carry the
reference names (`embedding`, `mlp.0`, `rnn`); torch keeps `bias_ih` and
`bias_hh` apart, as the JAX parameters do.

The encoder runs in fp32 whatever the compute dtype (20 tokens a clip; the
outputs are cast to the compute dtype). `train` turns the input dropout on;
gradients flow through the packed sequence.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from dcnet_tpu_torch.models.heads import dropout


class BiLSTMEncoder(nn.Module):
    def __init__(self, vocab_size: int, word_embedding_size: int = 512,
                 word_vec_size: int = 512, hidden_size: int = 512,
                 input_dropout_p: float = 0.2,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.embedding = nn.Embedding(vocab_size, word_embedding_size,
                                      device=device)
        self.input_dropout = nn.Dropout(input_dropout_p)
        self.mlp = nn.Sequential(
            nn.Linear(word_embedding_size, word_vec_size, device=device),
            nn.ReLU())
        self.rnn = nn.LSTM(word_vec_size, hidden_size, 1, batch_first=True,
                           bidirectional=True, device=device)
        self.dtype = dtype

    def forward(self, word_ids: torch.Tensor, train: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """word_ids (B, L) integer -> (sent (B, 2H), context (B, L, 2H),
        embedded (B, L, word_vec_size))."""
        seq_len = word_ids.shape[1]
        # empty phrases are clamped to one token, as in the JAX package
        lengths = torch.clamp((word_ids != 0).sum(dim=1), min=1)
        emb = self.mlp(dropout(self.embedding(word_ids.long()),
                               self.input_dropout.p, train))
        # cuDNN's RNN backward needs the module in training mode; one layer
        # has no inter-layer dropout, so the mode changes no number
        if self.rnn.training != train:
            self.rnn.train(train)
        if not train:
            context = self.unpacked(emb, lengths)
        else:
            packed = pack_padded_sequence(emb, lengths.cpu(), batch_first=True,
                                          enforce_sorted=False)
            out, _ = self.rnn(packed)
            context, _ = pad_packed_sequence(out, batch_first=True,
                                             total_length=seq_len)
        idx = (lengths - 1).to(context.device)
        last = context[torch.arange(context.shape[0], device=context.device), idx]
        return (last.to(self.dtype), context.to(self.dtype),
                emb.to(self.dtype))

    def unpacked(self, emb: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """The packed BiLSTM's context (B, L, 2H) of `emb` (B, L, D) with
        no packing and no host copy of `lengths` (the form `torch.export`
        takes). `rnn` runs twice on the padded batch: as it is, for the
        forward direction (it reads no position past the one it writes);
        and with each sequence moved to the end of its row (padding first,
        a gather), for the backward direction, which there starts at the
        sequence's last token and reaches the padding only after its
        first; that half is moved back."""
        h, n = self.rnn.hidden_size, emb.shape[1]
        t = torch.arange(n, device=emb.device)[None, :]
        shift = (n - lengths)[:, None]                            # (B, 1)
        fwd, _ = self.rnn(emb)
        right = torch.gather(emb, 1, ((t - shift) % n)[..., None].expand_as(emb))
        back, _ = self.rnn(right)
        bwd = torch.gather(back[..., h:], 1, ((t + shift) % n)[..., None].expand(
            *back.shape[:2], h))
        valid = (t < lengths[:, None])[..., None]
        return torch.where(valid, torch.cat([fwd[..., :h], bwd], dim=-1), 0.0)
