"""Word-level vocabulary and tokenizer for the LSTM path: the port's copy
of `dcnet_tpu/data/corpus.py`.

Tokenization: split on the regex `(\\W+)` keeping delimiter tokens,
lowercase, drop empty and space tokens and a trailing '.'; truncate to
max_len, else pad as `words + [<eos>] + [<pad>]*rest`; out-of-vocabulary
words map to `<unk>`. The `<pad>`/`<eos>` ids are nonzero, as in the
reference vocabulary, so `(ids != 0)` masks treat padding as tokens.

Persistence is JSON; `load_reference_corpus` reads the reference's
torch-pickled `corpus.pth`.
"""

from __future__ import annotations

import json
import re
from typing import Iterable, List, Sequence

import numpy as np

UNK_TOKEN = "<unk>"
PAD_TOKEN = "<pad>"
END_TOKEN = "<eos>"
_SPLIT = re.compile(r"(\W+)")


class Corpus:
    def __init__(self) -> None:
        self.word2idx = {}
        self.idx2word: List[str] = []

    def add_word(self, word: str) -> int:
        if word not in self.word2idx:
            self.idx2word.append(word)
            self.word2idx[word] = len(self.idx2word) - 1
        return self.word2idx[word]

    def add_to_corpus(self, line: str) -> None:
        for word in line.split():
            self.add_word(word.lower())

    @classmethod
    def build(cls, phrases: Iterable[str]) -> "Corpus":
        c = cls()
        for p in phrases:
            c.add_to_corpus(p)
        c.add_word(UNK_TOKEN)
        c.add_word(PAD_TOKEN)
        c.add_word(END_TOKEN)
        return c

    @staticmethod
    def split_words(line: str, max_len: int) -> List[str]:
        words = [w.lower() for w in _SPLIT.split(line.strip()) if w and w != " "]
        if words and words[-1] == ".":
            words = words[:-1]
        if max_len > 0:
            if len(words) > max_len:
                words = words[:max_len]
            elif len(words) < max_len:
                words = words + [END_TOKEN] + [PAD_TOKEN] * (max_len - len(words) - 1)
        return words

    def tokenize(self, line: str, max_len: int = 20) -> np.ndarray:
        words = self.split_words(line, max_len)
        unk = self.word2idx[UNK_TOKEN]
        return np.asarray(
            [self.word2idx.get(w, unk) for w in words], dtype=np.int32)

    def tokenize_batch(self, lines: Sequence[str], max_len: int = 20) -> np.ndarray:
        return np.stack([self.tokenize(l, max_len) for l in lines])

    def untokenize(self, ids: Sequence[int]) -> List[str]:
        return [self.idx2word[i] for i in ids]

    def __len__(self) -> int:
        return len(self.idx2word)

    def __contains__(self, word: str) -> bool:
        return word in self.word2idx

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.idx2word, f)

    @classmethod
    def load(cls, path: str) -> "Corpus":
        with open(path) as f:
            idx2word = json.load(f)
        c = cls()
        for w in idx2word:
            c.add_word(w)
        return c


def load_reference_corpus(path: str) -> Corpus:
    """Read a reference `data/<dataset>/corpus.pth` (a torch pickle holding
    a `utils.word_utils.Corpus` whose `dictionary.idx2word` lists the
    vocabulary)."""
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=False)
    c = Corpus()
    for w in obj.dictionary.idx2word:
        c.add_word(w)
    return c
