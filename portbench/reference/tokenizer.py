"""CLIP's tokenizer with the byte-level fallback vocabulary, written from
the published algorithm (Radford et al. 2021; ``github.com/openai/CLIP``,
``clip/simple_tokenizer.py`` and ``clip.tokenize``), without merges.

With no merge table every word becomes its UTF-8 bytes, each a symbol of
GPT-2's reversible byte-to-unicode map, the last one with ``</w>``. Ids:
the 256 byte symbols in that map's order are 0..255, the same with
``</w>`` 256..511, ``<|startoftext|>`` 49406 and ``<|endoftext|>`` 49407
(the canonical ids). A row is SOT, the ids, EOT, zero-padded to the
context; a longer one is cut and ends in EOT (``truncate=True``).

Scope: the benchmark's query texts are lowercase ASCII words from a
frozen list (``portbench/traffic/words.txt``), so the cleaning and the
pre-tokenizer here cover ASCII text only (whitespace collapsed,
lowercased; CLIP's pattern ``'s|'t|'re|'ve|'m|'ll|'d|letters+|digit|
other+``) and raise on anything else.
"""

from __future__ import annotations

import re

import numpy as np

SOT, EOT = 49406, 49407
_WORDS = re.compile(r"'s|'t|'re|'ve|'m|'ll|'d|[a-z]+|[0-9]|[^\sa-z0-9]+")


def _byte_order() -> list[int]:
    """Bytes in the order of GPT-2's byte-to-unicode map: the printable
    ranges first, then the rest ascending."""
    printable = (list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD))
                 + list(range(0xAE, 0x100)))
    return printable + [b for b in range(256) if b not in printable]


_ID_OF_BYTE = {b: i for i, b in enumerate(_byte_order())}


def encode(text: str) -> list[int]:
    """Token ids of ``text`` (no SOT/EOT)."""
    if not text.isascii():
        raise ValueError("the reference tokenizer covers ASCII text only")
    text = " ".join(text.split()).lower()
    ids: list[int] = []
    for word in _WORDS.findall(text):
        raw = word.encode("utf-8")
        ids.extend(_ID_OF_BYTE[b] for b in raw[:-1])
        ids.append(256 + _ID_OF_BYTE[raw[-1]])
    return ids


def tokenize(texts: list[str], context_length: int = 77) -> np.ndarray:
    """(len(texts), context_length) int64 rows, as ``clip.tokenize(...,
    truncate=True)`` builds them."""
    out = np.zeros((len(texts), context_length), np.int64)
    for r, text in enumerate(texts):
        ids = [SOT] + encode(text) + [EOT]
        if len(ids) > context_length:
            ids = ids[:context_length]
            ids[-1] = EOT
        out[r, : len(ids)] = ids
    return out
