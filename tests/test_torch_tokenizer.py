"""The port's tokenizer (stdlib scanner in place of the ``regex`` module)
against the JAX package's: token ids must be equal."""

import unicodedata

import numpy as np
from hypothesis import given, settings
from hypothesis import strategies as st

from evossearch_tpu.tokenizer import CLIPTokenizer as RefTokenizer
from evossearch_tpu_torch.tokenizer import CLIPTokenizer

# the strings of tests/test_tokenizer.py, plus contractions, specials and
# whitespace classes the pre-tokenizer treats specially
STRINGS = [
    "hello world", "a photo of a cat", "café ☕ 東京", "x" * 50,
    "Hello, World!", "it's what we've done, they'll say i'd", "ſ'ſ 's 'S",
    "<|startoftext|> a <|endoftext|>", "Aͅb", "tab\tnew\nline\x1cfs",
    "Ã©tÃ© â€œquotedâ€\x9d", "&amp;amp; &lt;b&gt;", "１２３ 4.5 ½ ⅷ", "",
    "   spaced   out   ", "émoji 👍🏽 mixed123abc", "x" * 100,
]
MERGES = [("h", "e"), ("he", "l"), ("l", "o</w>"), ("c", "a"), ("ca", "t</w>")]


def _both(merges=None):
    return CLIPTokenizer(merges), RefTokenizer(merges)


def test_ids_equal_on_fixed_strings():
    for merges in (None, MERGES):
        port, ref = _both(merges)
        for text in STRINGS:
            assert port.encode(text) == ref.encode(text), text
        np.testing.assert_array_equal(
            port.tokenize(STRINGS, truncate=True),
            ref.tokenize(STRINGS, truncate=True),
        )


def test_overflow_raises_like_reference():
    port, _ = _both()
    try:
        port.tokenize(["x" * 100])
    except RuntimeError as e:
        assert "too long" in str(e)
    else:
        raise AssertionError("an overflowing text must raise")


# assigned characters only: the two packages' Unicode tables (Python's
# unicodedata and the regex module's own) differ on unassigned code points
_CATEGORIES = ("Lu", "Ll", "Lt", "Lm", "Lo", "Nd", "Nl", "No", "Mn", "Mc",
               "Pc", "Pd", "Ps", "Pe", "Po", "Sm", "Sc", "Sk", "So", "Zs",
               "Cc")
_TEXT = st.text(
    alphabet=st.characters(categories=_CATEGORIES).filter(
        lambda c: unicodedata.category(c) != "Cn"
    ),
    max_size=40,
)


@settings(max_examples=300, deadline=None)
@given(_TEXT)
def test_ids_equal_on_unicode_text(text):
    port, ref = _both()
    assert port.encode(text) == ref.encode(text)
