"""CLIP byte-BPE text tokenizer (host-side).

From-scratch implementation of the tokenization algorithm used by the OpenAI
CLIP release (invoked by the reference at oldapp.py:48 via `clip.tokenize`):
lowercased byte-level BPE, vocab 49,408 (= 256 byte symbols + 256 byte+'</w>'
symbols + 48,894 merges + <|startoftext|>(49406) + <|endoftext|>(49407)),
context length 77.

Vocab/merge data is loaded at runtime from either:
  * the OpenAI release file ``bpe_simple_vocab_16e6.txt.gz`` (one merge pair
    per line, first line is a header), or
  * a HuggingFace tokenizer directory (``vocab.json`` + ``merges.txt``).

When no vocab asset is available (this image has no network egress and ships
no CLIP assets), a deterministic *byte-level fallback* vocab is constructed:
the 512 byte symbols occupy ids 0..511 and the special tokens keep their
canonical ids 49406/49407, so downstream embedding tables (sized 49,408) and
the SOT/EOT contract still hold — token ids only match OpenAI's once the real
merge table is supplied via EVOSSEARCH_BPE_VOCAB.

Text cleaning: the upstream tokenizer applies ``ftfy.fix_text`` (mojibake
repair) + double ``html.unescape`` + whitespace collapse + lowercase. ftfy is
not available here; its dominant repair class — UTF-8 bytes misdecoded as
cp1252/latin-1, including ftfy's "sloppy cp1252" handling of the five
undefined bytes — is reimplemented in ``_fix_mojibake``, plus NFC
normalization. Well-formed text is untouched (the strict round-trip gate).
"""

from __future__ import annotations

import functools
import gzip
import html
import json
import re
import unicodedata
from pathlib import Path

from ..core.constants import (
    CLIP_CONTEXT_LENGTH,
    CLIP_EOT_TOKEN,
    CLIP_SOT_TOKEN,
    CLIP_VOCAB_SIZE,
)

# The CLIP pre-tokenizer is the pattern
#   <\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+
# (IGNORECASE) under the third-party ``regex`` module. The stdlib ``re`` has
# no \p{..} classes, so the pattern runs as a scanner: the literal
# alternatives through ``re`` (whose IGNORECASE folds them the same way,
# e.g. U+017F long s matches "s"), and the classes by
# ``unicodedata.category`` (L* = \p{L}, N* = \p{N}).
_LITERALS = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d", re.IGNORECASE
)
# \s of the ``regex`` module is Unicode White_Space; str.isspace and the
# stdlib's \s also count the separators U+001C..U+001F.
_SPACE = re.compile(r"[^\S\x1c-\x1f]")
# U+0345 (a combining mark) case-folds to a letter, so under IGNORECASE it
# falls outside the negated class and matches no alternative at all.
_UNMATCHED = "\u0345"


def _char_class(ch: str) -> str:
    """'L' letter, 'N' number, 'O' other, '' whitespace or unmatched."""
    if ch == _UNMATCHED or _SPACE.match(ch):
        return ""
    cat = unicodedata.category(ch)[0]
    return cat if cat in "LN" else "O"


def _split_words(text: str) -> list[str]:
    """``findall`` of the CLIP pre-tokenizer pattern over ``text``."""
    words: list[str] = []
    i, n = 0, len(text)
    while i < n:
        m = _LITERALS.match(text, i)
        if m:
            words.append(m.group())
            i = m.end()
            continue
        cls = _char_class(text[i])
        if not cls:
            i += 1
            continue
        j = i + 1
        if cls != "N":  # letters and others run on; a number is one char
            while j < n and _char_class(text[j]) == cls:
                j += 1
        words.append(text[i:j])
        i = j
    return words


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> dict[int, str]:
    """Reversible byte -> printable-unicode-char map (GPT-2/CLIP scheme).

    Printable ASCII/latin ranges map to themselves; the remaining bytes map
    to 256+offset codepoints so every byte has a visible, non-whitespace char.
    """
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


# Chars covering every possible UTF-8 lead byte (0xC0-0xF7) as misdecoded
# by cp1252/latin-1. Cheap gate: plain text skips the repair attempt.
_MOJIBAKE_HINT = re.compile("[\u00c0-\u00f7]")


@functools.lru_cache(maxsize=1)
def _sloppy_cp1252() -> dict[str, int]:
    """char -> byte table for ftfy's "sloppy windows-1252": the 5 bytes
    cp1252 leaves undefined (81, 8D, 8F, 90, 9D) map to the matching C1
    control codepoints, because real-world mojibake produced by lenient
    decoders contains exactly those."""
    table: dict[str, int] = {}
    for b in range(256):
        try:
            ch = bytes([b]).decode("cp1252")
        except UnicodeDecodeError:
            ch = chr(b)
        table[ch] = b
    return table


def _fix_mojibake(text: str) -> str:
    """Undo UTF-8-bytes-read-as-cp1252/latin-1 (repairs the likes of
    A-tilde+copyright back to e-acute, and cp1252 smart-quote mojibake).

    This is the dominant repair class of upstream ftfy (applied by CLIP's
    `basic_clean`; ftfy itself is not in this image). The repair only
    rewrites when the ENTIRE string re-encodes losslessly and re-decodes as
    strictly valid UTF-8 — for natural text that round-trip essentially
    only succeeds on genuine mojibake ("São Paulo" re-encodes to latin-1
    fine but E3 6F is invalid UTF-8, so it is left untouched). Applied up
    to 3 times for doubly-encoded input, like ftfy's fixed point.
    """
    table = _sloppy_cp1252()
    for _ in range(3):
        if not _MOJIBAKE_HINT.search(text):
            break
        candidate = None
        try:
            candidate = bytes(table[c] for c in text).decode("utf-8")
        except (KeyError, UnicodeDecodeError):
            try:  # latin-1-flavored mojibake (raw C1 controls in the text)
                candidate = text.encode("latin-1").decode("utf-8")
            except (UnicodeEncodeError, UnicodeDecodeError):
                pass
        if candidate is None or candidate == text:
            break
        text = candidate
    return text


def _clean_text(text: str) -> str:
    text = _fix_mojibake(text)
    text = unicodedata.normalize("NFC", text)
    text = html.unescape(html.unescape(text))
    text = re.sub(r"[^\S\x1c-\x1f]+", " ", text)
    return text.strip().lower()


def _word_pairs(word: tuple[str, ...]) -> set[tuple[str, str]]:
    return set(zip(word[:-1], word[1:]))


class CLIPTokenizer:
    """Byte-BPE tokenizer with the CLIP vocab layout.

    Parameters
    ----------
    merges:
        Ordered list of merge pairs ``(a, b)``; rank = list position.
    """

    def __init__(self, merges: list[tuple[str, str]] | None = None):
        merges = list(merges or [])
        if len(merges) > CLIP_VOCAB_SIZE - 512 - 2:
            raise ValueError(f"merge table too large: {len(merges)} entries")
        byte_chars = list(bytes_to_unicode().values())
        vocab = byte_chars + [c + "</w>" for c in byte_chars]
        for pair in merges:
            vocab.append("".join(pair))
        self.fallback = not merges
        # Id layout: byte symbols 0..511, merge i at 512+i, specials pinned at
        # their canonical ids. With the full 48,894-entry OpenAI table the
        # merge ids end at 49,405, so this layout reproduces the OpenAI vocab
        # ids exactly; with a partial/absent table the intermediate id range
        # is simply unused and the SOT/EOT contract still holds.
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.encoder["<|startoftext|>"] = CLIP_SOT_TOKEN
        self.encoder["<|endoftext|>"] = CLIP_EOT_TOKEN
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {pair: i for i, pair in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {c: b for b, c in self.byte_encoder.items()}
        self._bpe_cache: dict[str, tuple[str, ...]] = {
            "<|startoftext|>": ("<|startoftext|>",),
            "<|endoftext|>": ("<|endoftext|>",),
        }

    # -- core BPE --

    _BPE_CACHE_CAP = 32768

    def _cache_put(self, token: str, word: tuple[str, ...]) -> None:
        """Insert with a size bound: a long-lived server fed diverse or
        adversarial query text would otherwise grow the cache without
        limit. Wholesale reset (keeping the specials) beats per-entry
        LRU bookkeeping on this hot path — natural text re-warms its few
        thousand live words immediately. Unlocked on purpose: dict ops
        are GIL-atomic and a racing reset only costs re-derivation."""
        if len(self._bpe_cache) >= self._BPE_CACHE_CAP:
            self._bpe_cache = {
                "<|startoftext|>": ("<|startoftext|>",),
                "<|endoftext|>": ("<|endoftext|>",),
            }
        self._bpe_cache[token] = word

    def _bpe(self, token: str) -> tuple[str, ...]:
        cached = self._bpe_cache.get(token)
        if cached is not None:
            return cached
        word: tuple[str, ...] = tuple(token[:-1]) + (token[-1] + "</w>",)
        if not self.bpe_ranks:
            self._cache_put(token, word)
            return word
        while len(word) > 1:
            pairs = _word_pairs(word)
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            first, second = best
            merged: list[str] = []
            i = 0
            while i < len(word):
                if (
                    i < len(word) - 1
                    and word[i] == first
                    and word[i + 1] == second
                ):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        self._cache_put(token, word)
        return word

    def encode(self, text: str) -> list[int]:
        """Text -> BPE token ids (no SOT/EOT, no padding)."""
        ids: list[int] = []
        for word in _split_words(_clean_text(text)):
            word_bytes = "".join(self.byte_encoder[b] for b in word.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(word_bytes))
        return ids

    def decode(self, ids: list[int]) -> str:
        text = "".join(self.decoder[i] for i in ids if i in self.decoder)
        raw = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()

    # -- clip.tokenize-compatible entry point --

    def tokenize(
        self,
        texts: str | list[str],
        context_length: int = CLIP_CONTEXT_LENGTH,
        truncate: bool = False,
    ):
        """Batch of padded token-id rows, shape (len(texts), context_length).

        Mirrors `clip.tokenize` semantics: SOT + ids + EOT, zero-padded; a
        text longer than the context raises unless ``truncate`` (in which
        case the last token is forced to EOT).
        """
        import numpy as np

        if isinstance(texts, str):
            texts = [texts]
        result = np.zeros((len(texts), context_length), dtype=np.int32)
        for row, text in enumerate(texts):
            ids = [CLIP_SOT_TOKEN] + self.encode(text) + [CLIP_EOT_TOKEN]
            if len(ids) > context_length:
                if not truncate:
                    raise RuntimeError(
                        f"Input {text!r} is too long for context length {context_length}"
                    )
                ids = ids[:context_length]
                ids[-1] = CLIP_EOT_TOKEN
            result[row, : len(ids)] = ids
        return result


# -- vocab loading --


def load_openai_merges(path: str | Path) -> list[tuple[str, str]]:
    """Parse the OpenAI ``bpe_simple_vocab_16e6.txt.gz`` merge table."""
    path = Path(path)
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rt", encoding="utf-8") as f:  # type: ignore[operator]
        lines = f.read().split("\n")
    # Header line + merges; the release uses entries 1 .. 49152-256-2+1.
    merge_lines = lines[1 : 49152 - 256 - 2 + 1]
    return [tuple(line.split()) for line in merge_lines if line.strip()]  # type: ignore[misc]


def load_hf_merges(directory: str | Path) -> list[tuple[str, str]]:
    """Parse a HuggingFace CLIP tokenizer directory (merges.txt)."""
    directory = Path(directory)
    lines = (directory / "merges.txt").read_text(encoding="utf-8").splitlines()
    merges: list[tuple[str, str]] = []
    for line in lines:
        if line.startswith("#") or not line.strip():
            continue
        a, b = line.split()
        merges.append((a, b))
    return merges


def load_tokenizer(path: str | Path | None = None) -> CLIPTokenizer:
    """Build a tokenizer from a vocab asset, or the byte-level fallback.

    ``path`` may be an OpenAI merge file, an HF tokenizer directory, or None.
    Also honours EVOSSEARCH_BPE_VOCAB and a bundled ``assets/`` directory.
    """
    import os

    candidates: list[Path] = []
    if path:
        candidates.append(Path(path))
    env = os.getenv("EVOSSEARCH_BPE_VOCAB", "")
    if env:
        candidates.append(Path(env))
    candidates.append(Path(__file__).parent / "assets" / "bpe_simple_vocab_16e6.txt.gz")

    for cand in candidates:
        try:
            if cand.is_dir() and (cand / "merges.txt").exists():
                return CLIPTokenizer(load_hf_merges(cand))
            if cand.is_file():
                return CLIPTokenizer(load_openai_merges(cand))
        except (OSError, ValueError):
            continue
    return CLIPTokenizer()  # byte-level fallback
