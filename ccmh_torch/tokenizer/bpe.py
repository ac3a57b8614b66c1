"""Byte-level BPE tokenizer with exact OpenAI-CLIP token-id parity.

A copy of ``ccmh/tokenizer/bpe.py`` that needs no ``regex`` package: the
word splitter (``\\p{L}`` / ``\\p{N}`` classes under IGNORECASE, the
reference's model/base/simple_tokenizer.py:82 pattern) is a hand-written
scanner over ``unicodedata.category``.  It yields the same words as the
``regex`` pattern for every code point assigned in the interpreter's
Unicode database (tests/test_torch_tokenizer.py checks all of them).

The native C++ tokenizer of ``ccmh`` is not ported yet; every text takes
this pure-Python path.

The vocab asset ``ccmh_torch/assets/bpe_simple_vocab_16e6.txt.gz`` is the
standard public OpenAI CLIP merge table (49,152-token vocab: 256 byte
symbols, the same 256 with an end-of-word marker, 48,894 merges, and two
specials).
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import re
import unicodedata
from typing import Dict, List, Sequence, Tuple

import numpy as np

try:  # ftfy is optional; captions in the standard datasets are ASCII-clean.
    import ftfy

    def _fix_text(text: str) -> str:
        return ftfy.fix_text(text)
except ImportError:  # pragma: no cover - environment without ftfy
    def _fix_text(text: str) -> str:
        # Cheap stand-in: mojibake repair is a no-op for well-formed input;
        # NFC normalisation covers the common decomposed-accent case.
        return unicodedata.normalize("NFC", text)

VOCAB_SIZE = 49408
CONTEXT_LENGTH = 77
SOT_TOKEN = "<|startoftext|>"
EOT_TOKEN = "<|endoftext|>"

_ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")
DEFAULT_VOCAB_PATH = os.path.join(_ASSET_DIR, "bpe_simple_vocab_16e6.txt.gz")

# ``\s`` of the ``regex`` package: the Unicode White_Space property (unlike
# ``str.isspace`` it excludes the separators U+001C..U+001F).
WHITESPACE = frozenset(
    "\t\n\x0b\x0c\r \x85\xa0\u1680"
    + "".join(chr(c) for c in range(0x2000, 0x200B))
    + "\u2028\u2029\u202f\u205f\u3000")
# U+0345 (a combining mark) case-folds to a Greek letter, so under
# IGNORECASE it matches neither ``[\p{L}]`` nor ``[^\s\p{L}\p{N}]``: the
# reference pattern skips it like whitespace.
_UNMATCHED = frozenset("\u0345")
# IGNORECASE equivalents of the letters in the literal alternatives (the
# specials and the contractions): the long s (U+017F) folds to "s".
_CASE_EQUIV = {"\u017f": "s"}

_SPECIALS = (SOT_TOKEN, EOT_TOKEN)
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")

_WS_RUN = re.compile("[" + re.escape("".join(sorted(WHITESPACE))) + "]+")

_SKIP, _LETTER, _NUMBER, _OTHER = range(4)


@functools.lru_cache(maxsize=65536)
def _char_class(c: str) -> int:
    if c in WHITESPACE or c in _UNMATCHED:
        return _SKIP
    cat = unicodedata.category(c)
    if cat[0] == "L":
        return _LETTER
    if cat in ("Nd", "Nl", "No"):
        return _NUMBER
    return _OTHER


def _fold(c: str) -> str:
    return _CASE_EQUIV.get(c, c.lower() if c.isascii() else c)


def _literal_at(text: str, i: int, literal: str) -> bool:
    if i + len(literal) > len(text):
        return False
    return all(_fold(text[i + j]) == ch for j, ch in enumerate(literal))


def split_words(text: str) -> List[str]:
    """``regex.findall`` of the reference pattern
    ``<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+``
    (IGNORECASE): at each position the first alternative that matches
    wins, greedily; a position no alternative matches is skipped."""
    words: List[str] = []
    i, n = 0, len(text)
    while i < n:
        literal = next((lit for lit in _SPECIALS + _CONTRACTIONS
                        if _literal_at(text, i, lit)), None)
        if literal is not None:
            words.append(text[i:i + len(literal)])
            i += len(literal)
            continue
        kind = _char_class(text[i])
        if kind == _SKIP:
            i += 1
            continue
        if kind == _NUMBER:
            words.append(text[i])
            i += 1
            continue
        j = i + 1
        while j < n and _char_class(text[j]) == kind:
            j += 1
        words.append(text[i:j])
        i = j
    return words


@functools.lru_cache()
def byte_to_unicode_table() -> Dict[int, str]:
    """Invertible map from the 256 byte values to printable unicode chars.

    Printable ASCII/latin bytes map to themselves; the rest are shifted into
    the 0x100+ plane so no vocab entry is whitespace or a control character.
    """
    visible = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    table: Dict[int, str] = {b: chr(b) for b in visible}
    offset = 0
    for b in range(256):
        if b not in table:
            table[b] = chr(0x100 + offset)
            offset += 1
    return table


def _clean(text: str) -> str:
    text = _fix_text(text)
    text = html.unescape(html.unescape(text))
    text = _WS_RUN.sub(" ", text.strip())
    return text.strip().lower()


class ClipBpeTokenizer:
    """Greedy lowest-rank-first byte-pair encoder over the CLIP merge table."""

    def __init__(self, vocab_path: str = DEFAULT_VOCAB_PATH):
        self._byte_enc = byte_to_unicode_table()
        self._byte_dec = {c: b for b, c in self._byte_enc.items()}

        with gzip.open(vocab_path, "rt", encoding="utf-8") as fh:
            lines = fh.read().split("\n")
        # Line 0 is a header; the usable merge table is exactly
        # vocab_size - 2*256 byte symbols - 2 specials entries long.
        n_merges = VOCAB_SIZE - 2 * 256 - 2
        merges: List[Tuple[str, str]] = []
        for line in lines[1 : 1 + n_merges]:
            a, b = line.split()
            merges.append((a, b))
        self._rank: Dict[Tuple[str, str], int] = {m: i for i, m in enumerate(merges)}

        symbols = list(self._byte_enc.values())
        entries = symbols + [s + "</w>" for s in symbols] + ["".join(m) for m in merges]
        entries += [SOT_TOKEN, EOT_TOKEN]
        self.encoder: Dict[str, int] = {tok: i for i, tok in enumerate(entries)}
        self.decoder: Dict[int, str] = {i: tok for tok, i in self.encoder.items()}
        self._bpe_cache: Dict[str, List[str]] = {
            SOT_TOKEN: [SOT_TOKEN],
            EOT_TOKEN: [EOT_TOKEN],
        }

    @property
    def sot_id(self) -> int:
        return self.encoder[SOT_TOKEN]

    @property
    def eot_id(self) -> int:
        return self.encoder[EOT_TOKEN]

    def _merge_word(self, token: str) -> List[str]:
        cached = self._bpe_cache.get(token)
        if cached is not None:
            return cached
        if len(token) == 0:
            return []
        parts: List[str] = list(token[:-1]) + [token[-1] + "</w>"]
        while len(parts) > 1:
            best_rank = None
            best_idx = -1
            for i in range(len(parts) - 1):
                r = self._rank.get((parts[i], parts[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank = r
                    best_idx = i
            if best_rank is None:
                break
            merged = parts[best_idx] + parts[best_idx + 1]
            # Fuse every occurrence of this exact pair left-to-right, same as
            # the canonical BPE merge step.
            out: List[str] = []
            i = 0
            while i < len(parts):
                if (
                    i + 1 < len(parts)
                    and parts[i] == parts[best_idx]
                    and parts[i + 1] == parts[best_idx + 1]
                ):
                    out.append(merged)
                    i += 2
                else:
                    out.append(parts[i])
                    i += 1
            parts = out
        self._bpe_cache[token] = parts
        return parts

    def tokenize(self, text: str) -> List[str]:
        """Text -> list of BPE token strings (reference parity: ``tokenize``)."""
        pieces: List[str] = []
        for word in split_words(_clean(text)):
            mapped = "".join(self._byte_enc[b] for b in word.encode("utf-8"))
            pieces.extend(self._merge_word(mapped))
        return pieces

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        return [self.encoder[t] for t in tokens]

    def encode(self, text: str) -> List[int]:
        return self.convert_tokens_to_ids(self.tokenize(text))

    def decode(self, ids: Sequence[int]) -> str:
        joined = "".join(self.decoder[i] for i in ids)
        raw = bytes(self._byte_dec[c] for c in joined if c in self._byte_dec)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    def encode_padded(self, text: str, max_words: int = 32) -> List[int]:
        """SOT + tokens (truncated) + EOT, zero-padded to ``max_words``.

        Mirrors the caption path of the reference dataset
        (dataset/base.py:64-81): truncate the token list to max_words-1
        *including* the SOT token, then append EOT, then pad with 0.
        """
        tokens = [SOT_TOKEN] + self.tokenize(text)
        tokens = tokens[: max_words - 1] + [EOT_TOKEN]
        ids = self.convert_tokens_to_ids(tokens)
        return ids + [0] * (max_words - len(ids))


@functools.lru_cache()
def default_tokenizer() -> ClipBpeTokenizer:
    return ClipBpeTokenizer()


def tokenize_batch(texts: Sequence[str], max_words: int = 32) -> np.ndarray:
    """List of strings -> int32 [B, max_words] (host-side, pure Python)."""
    texts = list(texts)
    if not texts:  # keep the [B, max_words] contract for empty batches
        return np.zeros((0, max_words), np.int32)
    tok = default_tokenizer()
    return np.asarray([tok.encode_padded(t, max_words) for t in texts], dtype=np.int32)
