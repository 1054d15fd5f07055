"""What the reference needs to rebuild a served prompt and its batch:
the oracle's prompt template, the hashing tokenizer (token id = md5 of
the word, mod the vocabulary less 8 reserved ids; "yes" is 3, "no" 4)
and the length-bucket planner (stable sort by length, ``max_batch``
prompts a batch, padded on the right to a power of two, at least 32).
Frozen copies, so that a change to the program's versions shows as a
disagreement with the reference."""
from __future__ import annotations

import hashlib
import math
import re

import numpy as np

_WORD_RE = re.compile(r"[a-z0-9']+|[^\sa-z0-9']")
BOS, YES, NO, N_SPECIAL = 1, 3, 4, 8
INSTRUCTION = "Answer yes or no: does the text satisfy the condition?"


def token_id(word: str, vocab: int) -> int:
    if word == "yes":
        return YES
    if word == "no":
        return NO
    h = int.from_bytes(hashlib.md5(word.encode()).digest()[:8], "little")
    return h % (vocab - N_SPECIAL) + N_SPECIAL


def prompt_ids(predicate: str, text: str, vocab: int) -> list:
    prompt = (f"{INSTRUCTION}\ncondition: {predicate}\ntext: {text}"
              "\nanswer:")
    return [BOS] + [token_id(w, vocab) for w in _WORD_RE.findall(
        prompt.lower())]


def bucket_len(n: int) -> int:
    return max(32, 1 << math.ceil(math.log2(max(1, n))))


def plan_buckets(lengths, max_batch: int) -> np.ndarray:
    """The padded length each prompt of one engine call is served at."""
    lengths = np.asarray(lengths)
    order = np.argsort(lengths, kind="stable")
    out = np.zeros(len(lengths), np.int64)
    for i in range(0, len(order), max_batch):
        idx = order[i:i + max_batch]
        out[idx] = bucket_len(int(lengths[idx].max()))
    return out
