"""CLIP BPE tokenizer (self-contained) with a deterministic fallback.

A copy of `signerf_tpu/diffusion/tokenizer.py` (which imports no JAX, but
the port imports nothing of the JAX package); both give the same ids.

SDXL conditions on two CLIP text encoders; their tokenizer is the standard
CLIP byte-level BPE (vocab.json + merges.txt). When those files are present
in the weights directory we run real BPE; in the no-egress/no-weights case a
deterministic hash tokenizer keeps the pipeline runnable end-to-end (prompts
still map to stable ids, just not the CLIP vocabulary).
"""

from __future__ import annotations

import json
import re
from functools import lru_cache
from pathlib import Path
from typing import List, Optional

import numpy as np

BOS = 49406
EOS = 49407
VOCAB_SIZE = 49408
MAX_LEN = 77

# CLIP's original pattern uses \p{L}/\p{N} (unicode classes); python `re`
# lacks those, so this is the close ASCII approximation.
_PAT = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+"
)


@lru_cache()
def _bytes_to_unicode():
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


class CLIPTokenizer:
    def __init__(self, vocab_path: Path, merges_path: Path):
        self.encoder = json.loads(Path(vocab_path).read_text())
        merges = Path(merges_path).read_text().split("\n")
        merges = [m for m in merges[1:] if m and not m.startswith("#")]
        self.bpe_ranks = {tuple(m.split()): i for i, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.cache = {}

    def _bpe(self, token: str) -> List[str]:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            bigram = min(
                pairs, key=lambda p: self.bpe_ranks.get(p, float("inf"))
            )
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                if (
                    i < len(word) - 1
                    and word[i] == first
                    and word[i + 1] == second
                ):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        self.cache[token] = list(word)
        return list(word)

    def encode(self, text: str) -> List[int]:
        text = re.sub(r"\s+", " ", text.lower().strip())
        ids: List[int] = []
        for tok in _PAT.findall(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            for piece in self._bpe(tok):
                ids.append(self.encoder.get(piece, 0))
        return ids

    def __call__(self, text: str, max_len: int = MAX_LEN) -> np.ndarray:
        ids = [BOS] + self.encode(text)[: max_len - 2] + [EOS]
        ids = ids + [EOS] * (max_len - len(ids))  # CLIP pads with EOS
        return np.asarray(ids, np.int32)


class HashTokenizer:
    """Deterministic fallback: word -> stable id in the CLIP vocab range."""

    def encode(self, text: str) -> List[int]:
        import hashlib

        words = re.findall(r"[a-zA-Z0-9]+|[^\sa-zA-Z0-9]", text.lower())
        ids = []
        for w in words:
            h = int(hashlib.md5(w.encode()).hexdigest(), 16)
            ids.append(h % (VOCAB_SIZE - 2))  # avoid BOS/EOS ids
        return ids

    def __call__(self, text: str, max_len: int = MAX_LEN) -> np.ndarray:
        ids = [BOS] + self.encode(text)[: max_len - 2] + [EOS]
        ids = ids + [EOS] * (max_len - len(ids))
        return np.asarray(ids, np.int32)


def load_tokenizer(weights_path: Optional[str | Path]):
    """CLIP BPE if vocab files exist under the weights dir, else hash."""
    if weights_path is not None:
        base = Path(weights_path)
        for sub in ["tokenizer", "."]:
            v = base / sub / "vocab.json"
            m = base / sub / "merges.txt"
            if v.exists() and m.exists():
                return CLIPTokenizer(v, m)
    return HashTokenizer()
