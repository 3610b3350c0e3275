"""CLIP BPE tokenizer (same algorithm and ids as ``pixray_tpu.models.clip.tokenizer``).

The merge table (``bpe_simple_vocab_16e6.txt.gz``) is a model asset, looked
for in ``$PIXRAY_TPU_BPE``, ``models/`` and this package's directory.  It is
never fetched.  Without it the tokenizer falls back to the same
deterministic byte-level scheme as the JAX package, with a loud warning.
"""

from __future__ import annotations

import gzip
import html
import os
import re
from functools import lru_cache

import numpy as np

CONTEXT_LENGTH = 77
VOCAB_SIZE = 49408

# the exact OpenAI CLIP token-split pattern needs unicode property classes
# (\p{L}, \p{N}); the stdlib re module can't express them, so use the `regex`
# module when present and an ASCII approximation otherwise
try:
    import regex as _re

    _TOKEN_PATTERN = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        _re.IGNORECASE,
    )
except ImportError:
    _re = re
    _TOKEN_PATTERN = re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
        re.IGNORECASE,
    )

try:  # ftfy fixes mojibake before cleaning (identity on well-formed text)
    import ftfy as _ftfy
except ImportError:
    _ftfy = None


@lru_cache()
def bytes_to_unicode():
    """Reversible byte → printable-unicode map (standard GPT-2/CLIP construction)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(2**8):
        if b not in bs:
            bs.append(b)
            cs.append(2**8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def _basic_clean(text: str) -> str:
    if _ftfy is not None:
        text = _ftfy.fix_text(text)
    text = html.unescape(html.unescape(text))
    return text.strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def find_bpe_vocab():
    candidates = [
        os.environ.get("PIXRAY_TPU_BPE"),
        os.path.join("models", "bpe_simple_vocab_16e6.txt.gz"),
        os.path.join(os.path.dirname(__file__), "bpe_simple_vocab_16e6.txt.gz"),
    ]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    return None


class SimpleTokenizer:
    def __init__(self, bpe_path: str | None = None):
        bpe_path = bpe_path or find_bpe_vocab()
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}

        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        if bpe_path is not None:
            with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
                merges = f.read().split("\n")
            merges = merges[1 : 49152 - 256 - 2 + 1]
            merges = [tuple(m.split()) for m in merges if m.strip()]
            for merge in merges:
                vocab.append("".join(merge))
            vocab.extend(["<|startoftext|>", "<|endoftext|>"])
            self.bpe_ranks = dict(zip(merges, range(len(merges))))
            self.degraded = False
        else:
            print(
                "WARNING: CLIP BPE vocab not found — using byte-level fallback "
                "tokenizer. Provide models/bpe_simple_vocab_16e6.txt.gz (or set "
                "$PIXRAY_TPU_BPE) for checkpoint-compatible tokenization."
            )
            self.bpe_ranks = {}
            self.degraded = True
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.sot_token = self.encoder.get("<|startoftext|>", VOCAB_SIZE - 2)
        self.eot_token = self.encoder.get("<|endoftext|>", VOCAB_SIZE - 1)
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"

        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                    new_word.extend(word[i:j])
                    i = j
                except ValueError:
                    new_word.extend(word[i:])
                    break
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        result = " ".join(word)
        self.cache[token] = result
        return result

    def encode(self, text: str) -> list[int]:
        bpe_tokens: list[int] = []
        text = _whitespace_clean(_basic_clean(text)).lower()
        for token in _re.findall(_TOKEN_PATTERN, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(
                self.encoder[t] for t in self.bpe(token).split(" ") if t in self.encoder
            )
        return bpe_tokens

    def decode(self, tokens) -> str:
        text = "".join(self.decoder.get(int(t), "") for t in tokens)
        return (
            bytearray(self.byte_decoder.get(c, ord(" ")) for c in text)
            .decode("utf-8", errors="replace")
            .replace("</w>", " ")
        )


@lru_cache(maxsize=1)
def get_tokenizer() -> SimpleTokenizer:
    return SimpleTokenizer()


def tokenize(texts, context_length: int = CONTEXT_LENGTH, truncate: bool = True):
    """Tokenize text(s) to a padded (N, context_length) int32 array."""
    if isinstance(texts, str):
        texts = [texts]
    tok = get_tokenizer()
    result = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        tokens = [tok.sot_token] + tok.encode(text) + [tok.eot_token]
        if len(tokens) > context_length:
            if not truncate:
                raise RuntimeError(f"Input {text!r} too long for context {context_length}")
            tokens = tokens[: context_length - 1] + [tok.eot_token]
        result[i, : len(tokens)] = tokens
    return result
