"""BiLSTM language encoder.

The port of `dcnet_tpu/models/lstm.py`: Embedding -> Dropout -> Linear+ReLU
-> one bidirectional LSTM layer with packed-sequence semantics, returning
(last-step output (B, 2H), context (B, L, 2H), embedding (B, L, word_vec)).
Where the JAX package masks a `lax.scan`, this packs the padded batch
(`pack_padded_sequence`), which the masked scan reproduces exactly. Children
carry the reference names (`embedding`, `mlp.0`, `rnn`); torch keeps
`bias_ih` and `bias_hh` apart, as the JAX parameters do.

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
        packed = pack_padded_sequence(emb, lengths.cpu(), batch_first=True,
                                      enforce_sorted=False)
        out, _ = self.rnn(packed)
        context, _ = pad_packed_sequence(out, batch_first=True,
                                         total_length=seq_len)
        idx = (lengths - 1).to(context.device)
        last = context[torch.arange(context.shape[0], device=context.device), idx]
        return (last.to(self.dtype), context.to(self.dtype),
                emb.to(self.dtype))
