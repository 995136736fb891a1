"""BERT input encoding for the non-LSTM language path: the port of
`dcnet_tpu/data/bert_tokenize.py`.

[CLS] + tokens + [SEP], zero-padded to `seq_length`, with a 1/0 attention
mask. The tokenizer is the offline `FallbackBertTokenizer` (lowercase word
and punctuation tokens with md5-hashed ids in the BERT id space): the port
reads no WordPiece vocab and imports no `transformers`. The JAX package
takes the same tokenizer wherever no vocab can be fetched.
"""

from __future__ import annotations

import hashlib
import re
from typing import Tuple

import numpy as np


class FallbackBertTokenizer:
    """Lowercase whitespace/punctuation word tokens with stable hashed ids
    in the BERT id space ([CLS] 101, [SEP] 102, words in [1000, 30522)).
    Not WordPiece: real-data parity with a pretrained BERT needs its vocab."""

    CLS_ID, SEP_ID, VOCAB = 101, 102, 30522

    def tokenize(self, text: str):
        out = []
        word = ""
        for ch in text.lower():
            if ch.isalnum():
                word += ch
            else:
                if word:
                    out.append(word)
                    word = ""
                if not ch.isspace():
                    out.append(ch)
        if word:
            out.append(word)
        return out

    def convert_tokens_to_ids(self, tokens):
        ids = []
        for t in tokens:
            if t == "[CLS]":
                ids.append(self.CLS_ID)
            elif t == "[SEP]":
                ids.append(self.SEP_ID)
            else:
                h = int(hashlib.md5(t.encode()).hexdigest()[:8], 16)
                ids.append(1000 + h % (self.VOCAB - 1000))
        return ids


def get_bert_tokenizer(bert_model: str = "bert-base-uncased") -> FallbackBertTokenizer:
    """The tokenizer of every BERT name: the offline fallback."""
    return FallbackBertTokenizer()


def encode_phrase(tokenizer, phrase: str, seq_length: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(input_ids, input_mask), each (seq_length,) int32. A phrase
    `a ||| b` encodes its first part only."""
    m = re.match(r"^(.*) \|\|\| (.*)$", phrase.strip())
    text_a = m.group(1) if m else phrase.strip()
    tokens_a = tokenizer.tokenize(text_a)[: seq_length - 2]
    ids = tokenizer.convert_tokens_to_ids(["[CLS]"] + tokens_a + ["[SEP]"])
    mask = [1] * len(ids)
    pad = seq_length - len(ids)
    return (np.asarray(ids + [0] * pad, np.int32),
            np.asarray(mask + [0] * pad, np.int32))
