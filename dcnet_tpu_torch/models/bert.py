"""The frozen BERT language encoder: the port of `dcnet_tpu/models/bert.py`.

`BertModel` returns every encoder layer's hidden states; `BertEncoder`
gives DCNet the (sentence, context, embedded) contract of the BiLSTM:
sentence = the mean of the [CLS] vectors of the last 4 layers, context =
the last layer, embedded = a learned projection `proj` of the context to
emb_size; the mask is `ids != 0`. The body is frozen: its parameters do not
require gradients and it runs under `torch.no_grad()`; `proj` trains.
Dropout (`BertConfig.dropout`) is on in training inside the frozen body, as
in the JAX package.

Children carry the HuggingFace / pytorch_pretrained_bert names
(`embeddings.word_embeddings`, `encoder.layer.{i}.attention.self.query`,
...), so a reference BERT state_dict loads under `textmodel.` as it is
(its LayerNorm `gamma`/`beta` renamed; `train/checkpoint.py`).

Types follow flax's rules with a compute dtype: the Linear layers and the
embedding lookups compute in it, every LayerNorm computes in fp32 and
returns fp32 (flax builds them without a dtype), so the residual stream,
the mask bias (`(1 - mask) * -10000`) and the softmax are fp32; in bf16 the
sentence and context come out fp32 and `embedded` bf16. No Pallas kernel
stands behind BERT: its products are plain matmuls, as the JAX package's
einsums are.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dcnet_tpu_torch.models.heads import dropout


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    dropout: float = 0.1

    @classmethod
    def for_model(cls, bert_model: str) -> "BertConfig":
        if "large" in bert_model:
            return cls(hidden_size=1024, num_layers=24, num_heads=16,
                       intermediate_size=4096)
        if "mini" in bert_model or "tiny" in bert_model:
            # the BERT lock's geometry: same id space, 4 layers of 128
            return cls(hidden_size=128, num_layers=4, num_heads=4,
                       intermediate_size=512)
        return cls()


def _linear(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm in the parameters' type (fp32) with a result of that type,
    whatever x's dtype."""
    x = x.to(torch.promote_types(x.dtype, ln.weight.dtype))
    return F.layer_norm(x, ln.normalized_shape, ln.weight, ln.bias, ln.eps)


class _Dense(nn.Module):
    """A Linear under `dense`, with a LayerNorm under `LayerNorm` when
    given its eps."""

    def __init__(self, d_in: int, d_out: int, ln_eps: Optional[float] = None,
                 device=None):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out, device=device)
        if ln_eps is not None:
            self.LayerNorm = nn.LayerNorm(d_out, eps=ln_eps, device=device)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        h = cfg.hidden_size
        self.query = nn.Linear(h, h, device=device)
        self.key = nn.Linear(h, h, device=device)
        self.value = nn.Linear(h, h, device=device)
        self.cfg = cfg

    def forward(self, x: torch.Tensor, attn_bias: torch.Tensor, dtype: torch.dtype,
                train: bool) -> torch.Tensor:
        c = self.cfg
        b, l, _ = x.shape
        hd = c.hidden_size // c.num_heads

        def split(t):  # (B, L, H) -> (B, heads, L, hd)
            return t.reshape(b, l, c.num_heads, hd).transpose(1, 2)

        q, k, v = (split(_linear(x, m, dtype)) for m in (self.query, self.key, self.value))
        # the divisor rounded to the compute dtype first, as JAX applies a
        # Python float to a bf16 array; the fp32 bias promotes the logits
        logits = q @ k.transpose(-1, -2) / torch.tensor(math.sqrt(hd), dtype=q.dtype)
        probs = dropout(torch.softmax(logits + attn_bias, dim=-1), c.dropout, train)
        ctx = probs @ v.to(probs.dtype)
        return ctx.transpose(1, 2).reshape(b, l, c.hidden_size)


class BertAttention(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.self = BertSelfAttention(cfg, device=device)
        self.output = _Dense(cfg.hidden_size, cfg.hidden_size, cfg.layer_norm_eps,
                             device=device)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.attention = BertAttention(cfg, device=device)
        self.intermediate = _Dense(h, cfg.intermediate_size, device=device)
        self.output = _Dense(cfg.intermediate_size, h, eps, device=device)
        self.cfg = cfg

    def forward(self, x: torch.Tensor, attn_bias: torch.Tensor, dtype: torch.dtype,
                train: bool) -> torch.Tensor:
        p = self.cfg.dropout
        att = self.attention
        a = att.self(x, attn_bias, dtype, train)
        a = dropout(_linear(a, att.output.dense, dtype), p, train)
        x = _layer_norm(x + a, att.output.LayerNorm)
        inter = F.gelu(_linear(x, self.intermediate.dense, dtype))  # exact (erf)
        out = dropout(_linear(inter, self.output.dense, dtype), p, train)
        return _layer_norm(x + out, self.output.LayerNorm)


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        h = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, h, device=device)
        self.position_embeddings = nn.Embedding(cfg.max_position, h, device=device)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, h, device=device)
        self.LayerNorm = nn.LayerNorm(h, eps=cfg.layer_norm_eps, device=device)


class _LayerStack(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg, device=device)
                                   for _ in range(cfg.num_layers))


class BertModel(nn.Module):
    """The BERT body: embeddings + encoder layers (HF names)."""

    def __init__(self, cfg: BertConfig, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.embeddings = BertEmbeddings(cfg, device=device)
        self.encoder = _LayerStack(cfg, device=device)
        self.cfg = cfg
        self.dtype = dtype

    def hidden_states(self, input_ids: torch.Tensor, attention_mask=None,
                      token_type_ids=None, train: bool = False) -> List[torch.Tensor]:
        """Every layer's output, (B, L, H) fp32 each."""
        c, dt, e = self.cfg, self.dtype, self.embeddings
        input_ids = input_ids.long()
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)[None]
        x = (e.word_embeddings.weight[input_ids].to(dt)
             + e.position_embeddings.weight[pos].to(dt)
             + e.token_type_embeddings.weight[token_type_ids].to(dt))
        x = dropout(_layer_norm(x, e.LayerNorm), c.dropout, train)
        attn_bias = (1.0 - attention_mask[:, None, None, :].to(x.dtype)) * -10000.0
        states = []
        for layer in self.encoder.layer:
            x = layer(x, attn_bias, dt, train)
            states.append(x)
        return states

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                train: bool = False) -> List[torch.Tensor]:
        return self.hidden_states(input_ids, attention_mask, token_type_ids, train)


class BertEncoder(BertModel):
    """DCNet's text encoder: the frozen body + the trained `proj`."""

    def __init__(self, bert_model: str = "bert-base-uncased", proj_dim: int = 512,
                 dtype: torch.dtype = torch.float32, device=None,
                 cfg: Optional[BertConfig] = None):
        super().__init__(cfg or BertConfig.for_model(bert_model), dtype, device)
        self.requires_grad_(False)
        self.proj = nn.Linear(self.cfg.hidden_size, proj_dim, device=device)

    def forward(self, word_ids: torch.Tensor, train: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """word_ids (B, L) -> (sentence (B, H), context (B, L, H),
        embedded (B, L, proj_dim))."""
        mask = (word_ids != 0).long()
        with torch.no_grad():
            layers = self.hidden_states(word_ids, attention_mask=mask, train=train)
        sentence = sum(h[:, 0] for h in layers[-4:]) / 4.0
        context = layers[-1]
        return sentence, context, _linear(context, self.proj, self.dtype)
