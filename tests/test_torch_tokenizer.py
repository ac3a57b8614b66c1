"""ccmh_torch BPE tokenizer: ids equal ccmh's with ``regex`` blocked.

The port's word splitter replaces the ``regex`` package's ``\\p{L}`` /
``\\p{N}`` classes with ``unicodedata.category``; these tests hold it to
the ``regex`` pattern on captions and on every assigned code point.
"""

import importlib
import sys
import unicodedata

import numpy as np
import pytest
import regex

from ccmh.tokenizer.bpe import _WORD_PATTERN, tokenize_batch as jax_tokenize

CAPTIONS = [
    "A dog runs on the grass.",
    "Two people   ride bikes; it's sunny & they're happy!!",
    "<|startoftext|>literal specials<|endoftext|> and 'll 've 'd 'm",
    "numbers 1234 and 3.14, 2nd place",
    "Café au lait, naïve façade — “quoted” text…",
    "東京の夜景と富士山",
    "Ελληνικά και кириллица, עברית, العربية",
    "emoji 🐶🐱 and symbols ©®™ ½ ² Ⅻ",
    "tabs\tand\nnewlines and em spaces",
    "long-s ſtyle: it'ſ old, <|ſtartoftext|>",
    "combining yͅpsilon and é",
    "&amp; html &lt;b&gt; entities &amp;amp;",
    "x" * 200,
]


@pytest.fixture
def port_bpe(monkeypatch):
    """ccmh_torch.tokenizer.bpe imported afresh with ``regex`` unimportable."""
    monkeypatch.setitem(sys.modules, "regex", None)
    for name in ("ccmh_torch.tokenizer.bpe", "ccmh_torch.tokenizer"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    mod = importlib.import_module("ccmh_torch.tokenizer.bpe")
    with pytest.raises(ImportError):
        importlib.import_module("regex")
    return mod


@pytest.mark.parametrize("max_words", [32, 77, 8])
def test_ids_equal_ccmh(port_bpe, max_words):
    got = port_bpe.tokenize_batch(CAPTIONS, max_words=max_words)
    want = jax_tokenize(CAPTIONS, max_words=max_words, use_native=False)
    assert got.dtype == np.int32 and got.shape == (len(CAPTIONS), max_words)
    np.testing.assert_array_equal(got, want)
    # ccmh's native C++ tokenizer (ASCII captions) gives the same ids
    np.testing.assert_array_equal(got, jax_tokenize(CAPTIONS, max_words=max_words))


def test_empty_batch(port_bpe):
    assert port_bpe.tokenize_batch([], max_words=32).shape == (0, 32)


def _assigned_code_points():
    """Every code point the interpreter's Unicode database assigns (the
    regex package may carry a newer Unicode version: category Cn is left
    out)."""
    return [chr(cp) for cp in range(sys.maxunicode + 1)
            if not 0xD800 <= cp <= 0xDFFF and unicodedata.category(chr(cp)) != "Cn"]


def test_character_classes_match_regex_on_every_code_point(port_bpe):
    chars = _assigned_code_points()
    text = "".join(chars)
    want = {
        port_bpe._LETTER: set(regex.findall(r"[\p{L}]", text, regex.IGNORECASE)),
        port_bpe._NUMBER: set(regex.findall(r"[\p{N}]", text, regex.IGNORECASE)),
        port_bpe._OTHER: set(regex.findall(r"[^\s\p{L}\p{N}]", text, regex.IGNORECASE)),
    }
    got = {kind: set() for kind in want}
    for c in chars:
        kind = port_bpe._char_class(c)
        if kind != port_bpe._SKIP:
            got[kind].add(c)
    for kind in want:
        assert got[kind] == want[kind], kind
    # the letters of the literal alternatives fold as IGNORECASE folds them
    for letter in set("startoftextendofxsmlrvd"):
        folds = set(regex.findall(letter, text, regex.IGNORECASE))
        assert {c for c in folds if port_bpe._fold(c) == letter} == folds, letter


def test_splitter_matches_regex_pattern_on_random_text(port_bpe):
    chars = _assigned_code_points()
    rng = np.random.default_rng(0)
    pieces = ["'", "'s", "'ll", "'re", "<|startoftext|>", "<|endoftext|>", " ",
              "\u017f", "\u0345", "a", "7"]
    for _ in range(3000):
        parts = [chars[i] for i in rng.integers(0, len(chars), 12)]
        parts += [pieces[i] for i in rng.integers(0, len(pieces), 6)]
        text = "".join(parts[i] for i in rng.permutation(len(parts)))
        assert port_bpe.split_words(text) == _WORD_PATTERN.findall(text), repr(text)


def test_whitespace_set_is_the_regex_class(port_bpe):
    text = "".join(chr(cp) for cp in range(sys.maxunicode + 1) if not 0xD800 <= cp <= 0xDFFF)
    assert set(port_bpe.WHITESPACE) == set(regex.findall(r"\s", text))
