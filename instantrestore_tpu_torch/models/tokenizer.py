"""CLIP BPE tokenizer, pure Python (counterpart of
``instantrestore_tpu/models/tokenizer.py``).

The reference calls a tokenizer once, to pad the fixed restoration prompt to
77 tokens. This is the CLIP BPE algorithm on the standard ``vocab.json`` and
``merges.txt`` that ship in every SD checkpoint's ``tokenizer`` folder, with
the standard library's ``re`` (no ``regex``, no ``transformers``). Without
those files, precomputed token ids can be given instead.
"""

from __future__ import annotations

import functools
import json
import re
from typing import Dict, List, Optional, Tuple

SOT = "<|startoftext|>"
EOT = "<|endoftext|>"
MODEL_MAX_LENGTH = 77

# CLIP's pattern uses unicode \p{L}/\p{N} classes (regex module); stdlib `re`
# equivalents via str.isalpha-compatible classes cover the latin prompts used
# here. Word classes map: letters+ ([^\W\d_]), single digit, symbol runs —
# CLIP's symbol class [^\s\p{L}\p{N}]+ INCLUDES underscore, which stdlib \w
# counts as a word char, hence the explicit |_ alternative.
_PAT = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[^\W\d_]+|[0-9]|(?:[^\s\w]|_)+",
    re.IGNORECASE | re.UNICODE,
)


@functools.lru_cache(maxsize=1)
def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2/CLIP reversible byte<->unicode map."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(
        range(ord("®"), ord("ÿ") + 1)
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class CLIPTokenizer:
    """Minimal CLIP BPE: lowercase, whitespace-clean, byte-encode, merge."""

    def __init__(self, vocab: Dict[str, int], merges: List[Tuple[str, str]]):
        self.encoder = vocab
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.cache: Dict[str, str] = {}
        self.sot_id = vocab[SOT]
        self.eot_id = vocab[EOT]

    @classmethod
    def from_files(cls, vocab_path: str, merges_path: str) -> "CLIPTokenizer":
        with open(vocab_path, encoding="utf-8") as f:
            vocab = json.load(f)
        with open(merges_path, encoding="utf-8") as f:
            lines = f.read().split("\n")
        # first line is the version header; CLIP uses 48894 merges
        merges = [tuple(l.split()) for l in lines[1:] if len(l.split()) == 2]
        return cls(vocab, merges)

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        text = re.sub(r"\s+", " ", text.strip()).lower()
        ids: List[int] = []
        for tok in _PAT.findall(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(tok).split(" "))
        return ids

    def __call__(
        self, text: str, max_length: int = MODEL_MAX_LENGTH, padding: str = "max_length"
    ) -> List[int]:
        """SOT + tokens + EOT, truncated and padded (with EOT — CLIP's pad
        token) to ``max_length``, matching the reference's tokenizer call."""
        ids = [self.sot_id] + self.encode(text)[: max_length - 2] + [self.eot_id]
        if padding == "max_length":
            ids = ids + [self.eot_id] * (max_length - len(ids))
        return ids


def load_tokenizer(tokenizer_dir: Optional[str]) -> Optional[CLIPTokenizer]:
    """Load from a diffusers-style tokenizer directory, or None if absent."""
    if tokenizer_dir is None:
        return None
    import os

    vocab = os.path.join(tokenizer_dir, "vocab.json")
    merges = os.path.join(tokenizer_dir, "merges.txt")
    if not (os.path.exists(vocab) and os.path.exists(merges)):
        return None
    return CLIPTokenizer.from_files(vocab, merges)
