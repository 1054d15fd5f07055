"""Hashing word tokenizer (nothing pretrained ships offline).

Deterministic: token id = (stable word hash) % (vocab - n_special) + n_special.
Good enough for LM training on synthetic corpora and for prompt length
accounting; reserves ids for special tokens and the yes/no answer tokens so
ModelOracle can read a stable logit position.
"""
from __future__ import annotations

import hashlib
import re
from typing import List

_WORD_RE = re.compile(r"[a-z0-9']+|[^\sa-z0-9']")

PAD, BOS, EOS, YES, NO = 0, 1, 2, 3, 4
N_SPECIAL = 8


def _stable_hash(word: str) -> int:
    return int.from_bytes(hashlib.md5(word.encode()).digest()[:8], "little")


class HashTokenizer:
    def __init__(self, vocab_size: int = 32768):
        assert vocab_size > N_SPECIAL
        self.vocab_size = vocab_size

    def token_id(self, word: str) -> int:
        w = word.lower()
        if w == "yes":
            return YES
        if w == "no":
            return NO
        return _stable_hash(w) % (self.vocab_size - N_SPECIAL) + N_SPECIAL

    def encode(self, text: str, bos: bool = True) -> List[int]:
        ids = [self.token_id(w) for w in _WORD_RE.findall(text.lower())]
        return ([BOS] + ids) if bos else ids

    def words(self, text: str) -> List[str]:
        return _WORD_RE.findall(text.lower())
