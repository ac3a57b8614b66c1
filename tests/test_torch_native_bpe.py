"""The port's native C++ BPE tokenizer (``ccmh_torch/tokenizer/native``)
against ``ccmh``'s native tokenizer and ``ccmh``'s Python tokenizer
(mirrors tests/test_native_bpe.py).  Tolerance: none, the ids are equal.
"""

import random
import string

import numpy as np
import pytest

from ccmh.tokenizer import native as jnative
from ccmh.tokenizer.bpe import default_tokenizer as jdefault_tokenizer
from ccmh.tokenizer.bpe import tokenize_batch as jtokenize_batch
from ccmh_torch.tokenizer import native
from ccmh_torch.tokenizer.bpe import tokenize_batch
from ccmh_torch.utils import host_build

CASES = [
    "a photo of a dog on green grass",
    "it's the cat's hat, isn't it?!",
    "we're; you've -- they'll 'd 'm '' ",
    "digits 1 23 456 and mixed a1b2c3",
    "punctuation!!! ...:;##@ /\\[]{}()",
    "",
    "   ",
    "word",
    "supercalifragilisticexpialidocious antidisestablishmentarianism",
    "a " * 100,                       # over-long: truncated at max_words
    "odd\x01control\x02chars",        # non-printable ASCII -> shifted plane
    "tabs\tand\nnewlines collapse",
    "UPPER Case MiXeD",
    "'s 't 're 've 'm 'll 'd standalone",
    "'rex 'veto 'mat",
    "trailing apostrophe' and double''s",
]
MIXED = ["café au lait", "a &amp; b", "plain ascii", "<|endoftext|>!", "", "naïve " * 40]


def _python_ids(texts, max_words):
    tok = jdefault_tokenizer()
    return np.asarray([tok.encode_padded(t, max_words) for t in texts], np.int32)


@pytest.mark.parametrize("max_words", [8, 32])
def test_native_ids_equal_ccmh_native_and_python(max_words):
    got = native.encode_padded_batch(CASES, max_words)
    np.testing.assert_array_equal(got, jnative.encode_padded_batch(CASES, max_words))
    np.testing.assert_array_equal(got, _python_ids(CASES, max_words))


def test_fuzz_ids_equal_ccmh():
    rng = random.Random(0)
    alphabet = string.ascii_letters + string.digits + " .,!?'-:;()[]/"
    texts = ["".join(rng.choice(alphabet) for _ in range(rng.randint(0, 80)))
             for _ in range(300)]
    got = native.encode_padded_batch(texts, 32, n_threads=4)
    np.testing.assert_array_equal(got, _python_ids(texts, 32))


def test_eligibility_follows_ccmh():
    for text in CASES + MIXED:
        assert native.eligible(text) == jnative.eligible(text), text
    with pytest.raises(ValueError, match="not eligible"):
        native.encode_padded_batch(["café"], 8)


@pytest.mark.parametrize("use_native", [True, False])
def test_tokenize_batch_splits_as_ccmh(use_native):
    texts = CASES + MIXED
    got = tokenize_batch(texts, 16, use_native=use_native)
    np.testing.assert_array_equal(got, jtokenize_batch(texts, 16, use_native=use_native))
    np.testing.assert_array_equal(got, _python_ids(texts, 16))
    assert tokenize_batch([], 16).shape == (0, 16)


def test_a_failed_build_raises(tmp_path, monkeypatch):
    src = tmp_path / "bpe.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(host_build, "BUILD_DIR", str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        host_build.build(str(src), "bpe", native.FLAGS)
    monkeypatch.setattr(native, "SRC", str(src))
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tokenize_batch(["plain ascii"], 8)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        host_build.build(str(src), "other", native.FLAGS)
