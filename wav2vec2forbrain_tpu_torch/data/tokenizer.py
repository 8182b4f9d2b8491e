"""Wav2Vec2 CTC character tokenizer (counterpart of
wav2vec2forbrain_tpu/data/tokenizer.py).

A copy rather than an import: `wav2vec2forbrain_tpu.data` imports pydantic
at package level (data/__init__ -> dataset -> args/base_args), which the
GPU machine does not have. Same 32-symbol vocabulary, the same offline
`from_pretrained` resolution and the same HF Wav2Vec2CTCTokenizer encode /
batch call / batch_decode(group_tokens=...) semantics;
tests/test_torch_imports.py holds it to the original.
"""

import json
import os
from itertools import groupby
from typing import Iterable, List, Sequence

import numpy as np

W2V_CTC_VOCAB = {
    "<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3, "|": 4,
    "E": 5, "T": 6, "A": 7, "O": 8, "N": 9, "I": 10, "H": 11, "S": 12,
    "R": 13, "D": 14, "L": 15, "U": 16, "M": 17, "W": 18, "C": 19, "F": 20,
    "G": 21, "Y": 22, "P": 23, "B": 24, "V": 25, "K": 26, "'": 27, "X": 28,
    "J": 29, "Q": 30, "Z": 31,
}

KNOWN_CHECKPOINT_VOCABS = {
    "facebook/wav2vec2-base-960h": W2V_CTC_VOCAB,
    "facebook/wav2vec2-base-100h": W2V_CTC_VOCAB,
    "facebook/wav2vec2-large-960h": W2V_CTC_VOCAB,
    "facebook/wav2vec2-conformer-rope-large-960h-ft": W2V_CTC_VOCAB,
}


class _Batch:
    def __init__(self, input_ids: np.ndarray):
        self.input_ids = input_ids


class Wav2Vec2CTCTokenizer:
    """Character-level CTC tokenizer with HF-compatible decode semantics."""

    def __init__(self, vocab=None, pad_token="<pad>", unk_token="<unk>", bos_token="<s>", eos_token="</s>",
                 word_delimiter_token="|"):
        self.vocab = dict(vocab if vocab is not None else W2V_CTC_VOCAB)
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        self.pad_token = pad_token
        self.unk_token = unk_token
        self.bos_token = bos_token
        self.eos_token = eos_token
        self.word_delimiter_token = word_delimiter_token
        self.pad_token_id = self.vocab[pad_token]
        self.unk_token_id = self.vocab[unk_token]
        self.eos_token_id = self.vocab[eos_token]

    @classmethod
    def from_pretrained(cls, checkpoint: str) -> "Wav2Vec2CTCTokenizer":
        """A checkpoint name or a local dir holding vocab.json; known
        wav2vec2 checkpoints resolve offline to the builtin vocab."""
        if os.path.isdir(checkpoint):
            vocab_path = os.path.join(checkpoint, "vocab.json")
            if os.path.exists(vocab_path):
                with open(vocab_path) as f:
                    return cls(vocab=json.load(f))
        if checkpoint in KNOWN_CHECKPOINT_VOCABS:
            return cls(vocab=KNOWN_CHECKPOINT_VOCABS[checkpoint])
        print(
            f"Warning: tokenizer checkpoint {checkpoint!r} not known offline; "
            "using the standard wav2vec2 English CTC vocab."
        )
        return cls()

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def convert_ids_to_tokens(self, ids: Iterable[int]) -> List[str]:
        return [self.ids_to_tokens.get(int(i), self.unk_token) for i in ids]

    def get_vocab_list(self) -> List[str]:
        return [self.ids_to_tokens[i] for i in range(self.vocab_size)]

    def encode(self, text: str) -> List[int]:
        """Spaces become the word delimiter; every other char is a token."""
        tokens = text.replace(" ", self.word_delimiter_token)
        return [self.vocab.get(tok, self.unk_token_id) for tok in tokens]

    def __call__(self, texts: Sequence[str], padding: str = "longest") -> _Batch:
        """Tokenize and pad a batch to its longest; `.input_ids` is int32."""
        encoded = [self.encode(t) for t in texts]
        max_len = max((len(e) for e in encoded), default=0)
        ids = np.full((len(encoded), max_len), self.pad_token_id, dtype=np.int32)
        for i, e in enumerate(encoded):
            ids[i, : len(e)] = e
        return _Batch(ids)

    def decode(self, ids: Iterable[int], group_tokens: bool = True) -> str:
        tokens = self.convert_ids_to_tokens(ids)
        if group_tokens:
            tokens = [tok for tok, _ in groupby(tokens)]
        out = "".join(" " if tok == self.word_delimiter_token else tok for tok in tokens if tok != self.pad_token)
        return out.strip()

    def batch_decode(self, batch_ids, group_tokens: bool = True) -> List[str]:
        return [self.decode(ids, group_tokens=group_tokens) for ids in batch_ids]
