"""A model directory's tokenizer files, read by the port itself.

The JAX package tokenizes prompts with
``transformers.AutoTokenizer.from_pretrained(dir, local_files_only=True)``
(its ``prompt/encoders.py::_tokenizer`` and ``prompt/debias.py``).  The
card's machine has neither ``transformers`` nor ``tokenizers``, so this
module reads the same files in pure Python (and numpy) and gives the same
ids, for the three formats that the shipped configs' directories hold:

* CLIP's byte-level BPE, ``vocab.json`` + ``merges.txt`` (SD 1.5, SD 2.1,
  CLIP ViT-L/14), as ``CLIPTokenizerFast`` converts them;
* a SentencePiece Unigram model, ``spiece.model`` (T5 v1.1), read by a
  protobuf wire-format reader of its own, as ``T5TokenizerFast`` converts
  it: the pieces with their scores and types, the normalizer spec's
  precompiled charsmap (a darts-clone double-array trie followed by the
  normalized strings), the ``<extra_id_N>`` sentinels;
* BERT's WordPiece, ``vocab.txt`` (the debiasing probe);

and ``tokenizer.json``, the ``tokenizers`` library's serialisation, which
``AutoTokenizer`` prefers where a directory has one: its normalizer,
pre-tokenizer, model (BPE, WordPiece or Unigram), post-processor and added
tokens.  Special tokens come from ``tokenizer_config.json``,
``special_tokens_map.json`` and ``added_tokens.json`` over each class's
defaults.  A file or a field that the reader does not know raises,
naming both; nothing falls back to ``transformers``.

The pipeline is the ``tokenizers`` library's: added tokens are split out
of the text first (those matched on the raw text, then those matched on
the normalized text), every other piece is normalized, pre-tokenized and
segmented by the model, the post-processor's special tokens wrap the
result, truncation keeps them and padding is on the right.  Character
classes (``\\p{L}``, ``\\p{N}``, categories) come from Python's
``unicodedata``; where the ``tokenizers`` library's BERT normalizer and
pre-tokenizer use older Unicode tables, the codepoints whose class differs
are listed below (the ``_BERT_*`` tables).  Code points unassigned in
Python's Unicode version may be classed differently by ``tokenizers``,
whose regular expressions know a later one.
"""

from __future__ import annotations

import base64
import functools
import json
import os
import re
import struct
import unicodedata
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

# White_Space: what ``\s`` matches in the tokenizers library's regular
# expressions and what Rust's ``char::is_whitespace`` holds
_WS = ("\t\n\x0b\x0c\r \x85\xa0\u1680"
       + "".join(chr(c) for c in range(0x2000, 0x200B))
       + "\u2028\u2029\u202f\u205f\u3000")

# Where the classes of tokenizers' BERT normalizer / pre-tokenizer (the
# Unicode 8-era tables of the ``unicode_categories`` crate) differ from
# Python's unicodedata: format characters it keeps, punctuation it does
# not know or knows, nonspacing marks it does not know or knows (hex
# codepoints and ranges)
_BERT_KEEP_CF = "890-891 8e2 110cd 13430-1343f"
_BERT_NOT_P = (
    "61d 9fd a76 c77 c84 1b7d-1b7e 2e43-2e4f 2e52-2e5d 10ead 10f55-10f59 "
    "10f86-10f89 1144b-1144f 1145a-1145b 1145d 11660-1166c 116b9 1183b "
    "11944-11946 119e2 11a3f-11a46 11a9a-11a9c 11a9e-11aa2 11b00-11b09 "
    "11c41-11c45 11c70-11c71 11ef7-11ef8 11f43-11f4f 11fff 12ff1-12ff2 "
    "16e97-16e9a 16fe2 1e95e-1e95f")
_BERT_P = "166d 111c9"
_BERT_NOT_MN = (
    "7fd 898-89f 8ca-8e1 9fe afa-aff b55 c04 c3c d00 d3b-d3c d81 eba ece "
    "180f 1885-1886 1abf-1ace 1df6-1dfb a82c a8c5 a8ff a9bd 10d24-10d27 "
    "10eab-10eac 10efd-10eff 10f46-10f50 10f82-10f85 11070 11073-11074 "
    "110c2 111c9 111cf 1123e 11241 1133b 11438-1143f 11442-11444 11446 "
    "1145e 1182f-11837 11839-1183a 1193b-1193c 1193e 11943 119d4-119d7 "
    "119da-119db 119e0 11a01-11a0a 11a33-11a38 11a3b-11a3e 11a47 "
    "11a51-11a56 11a59-11a5b 11a8a-11a96 11a98-11a99 11c30-11c36 "
    "11c38-11c3d 11c3f 11c92-11ca7 11caa-11cb0 11cb2-11cb3 11cb5-11cb6 "
    "11d31-11d36 11d3a 11d3c-11d3d 11d3f-11d45 11d47 11d90-11d91 11d95 "
    "11d97 11ef3-11ef4 11f00-11f01 11f36-11f3a 11f40 11f42 13440 "
    "13447-13455 16f4f 16fe4 1cf00-1cf2d 1cf30-1cf46 1e000-1e006 "
    "1e008-1e018 1e01b-1e021 1e023-1e024 1e026-1e02a 1e08f 1e130-1e136 "
    "1e2ae 1e2ec-1e2ef 1e4ec-1e4ef 1e944-1e94a")
_BERT_MN = "1734"
# BERT's "Chinese characters": the CJK ideograph blocks that tokenizers'
# BertNormalizer pads with spaces
_CJK = ((0x3400, 0x4DBF), (0x4E00, 0x9FFF), (0xF900, 0xFAFF),
        (0x20000, 0x2A6DF), (0x2A700, 0x2B81F), (0x2B920, 0x2CEAF),
        (0x2F800, 0x2FA1F))
_ASCII_PUNCT = frozenset("!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~")

GPT2_SPLIT = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+"
              r"| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")
CLIP_SPLIT = r"'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"
# the slow CLIPTokenizer keeps merges.txt's lines [1, 49152 - 256 - 2 + 1)
CLIP_MAX_MERGES = 49152 - 256 - 2
SPIECE_UNK_PENALTY = 10.0      # tokenizers' Unigram: unk = min score - 10


class TokenizerFileError(ValueError):
    """A tokenizer file that this reader cannot read (file and field)."""


def _fail(path: str, field: str, what: str):
    raise TokenizerFileError(f"{path}: {field}: {what}")


# ---- character classes ----

def _codepoints(spec: str) -> frozenset:
    out = set()
    for part in spec.split():
        lo, _, hi = part.partition("-")
        out.update(range(int(lo, 16), int(hi or lo, 16) + 1))
    return frozenset(out)


@functools.lru_cache(maxsize=None)
def _bert_tables() -> Tuple[frozenset, frozenset, frozenset, frozenset,
                            frozenset]:
    return (_codepoints(_BERT_KEEP_CF), _codepoints(_BERT_NOT_P),
            _codepoints(_BERT_P), _codepoints(_BERT_NOT_MN),
            _codepoints(_BERT_MN))


@functools.lru_cache(maxsize=None)
def _class_body(name: str) -> str:
    """The body of a ``re`` character class for ``\\s``, ``\\p{L}`` or
    ``\\p{N}``: codepoint ranges, escaped."""
    if name == "s":
        cps = sorted(ord(c) for c in _WS)
    else:
        cps = [c for c in range(0x110000)
               if unicodedata.category(chr(c))[0] == name]
    spans: List[List[int]] = []
    for c in cps:
        if spans and spans[-1][1] == c - 1:
            spans[-1][1] = c
        else:
            spans.append([c, c])
    return "".join(re.escape(chr(a)) if a == b else
                   f"{re.escape(chr(a))}-{re.escape(chr(b))}"
                   for a, b in spans)


_ESCAPE = re.compile(r"\\p\{(L|N)\}|\\(s|S)|\\.|\[\^?|\]")


@functools.lru_cache(maxsize=None)
def _regex(pattern: str) -> "re.Pattern":
    """A tokenizers (Oniguruma) pattern as a Python ``re`` pattern:
    ``\\p{L}``, ``\\p{N}``, ``\\s`` and ``\\S`` spelled out as classes, in
    and outside brackets."""
    out, pos, in_class = [], 0, False
    for m in _ESCAPE.finditer(pattern):
        out.append(pattern[pos:m.start()])
        pos = m.end()
        tok = m.group(0)
        name = m.group(1) or (m.group(2) and "s")
        if name:
            body = _class_body(name)
            if in_class:
                if m.group(2) == "S":
                    raise ValueError(f"\\S inside a class in {pattern!r}")
                out.append(body)
            else:
                out.append(f"[^{body}]" if m.group(2) == "S" else
                           f"[{body}]")
            continue
        if tok.startswith("["):
            in_class = True
        elif tok == "]":
            in_class = False
        out.append(tok)
    out.append(pattern[pos:])
    return re.compile("".join(out))


def _pattern(spec: dict, path: str, field: str):
    """A tokenizer.json pattern, ``{"Regex": ...}`` or ``{"String": ...}``,
    as a compiled ``re`` pattern."""
    if "Regex" in spec:
        return _regex(spec["Regex"])
    if "String" in spec:
        return re.compile(re.escape(spec["String"]))
    _fail(path, field, f"pattern {spec!r}")


# ---- normalizers: str -> str ----

def _lowercase(s: str) -> str:
    # one character at a time, as tokenizers does (no final-sigma rule)
    return "".join(c.lower() for c in s)


def _bert_normalizer(clean_text=True, handle_chinese_chars=True,
                     strip_accents=None, lowercase=True) -> Callable:
    keep_cf, _, _, not_mn, mn = _bert_tables()

    def is_mn(c):
        o = ord(c)
        return o in mn or (unicodedata.category(c) == "Mn"
                           and o not in not_mn)

    def normalize(s: str) -> str:
        if clean_text:
            out = []
            for c in s:
                o = ord(c)
                if o in (0, 0xFFFD):
                    continue
                if c in "\t\n\r":
                    out.append(" ")
                    continue
                if (unicodedata.category(c) in ("Cc", "Cf", "Co")
                        and o not in keep_cf):
                    continue
                out.append(" " if c in _WS else c)
            s = "".join(out)
        if handle_chinese_chars:
            s = "".join(f" {c} " if any(a <= ord(c) <= b for a, b in _CJK)
                        else c for c in s)
        if lowercase if strip_accents is None else strip_accents:
            s = "".join(c for c in unicodedata.normalize("NFD", s)
                        if not is_mn(c))
        if lowercase:
            s = _lowercase(s)
        return s
    return normalize


def bert_is_punctuation(c: str) -> bool:
    """BERT's punctuation: ASCII 33-47, 58-64, 91-96, 123-126 and the
    ``P*`` categories (as tokenizers' tables have them)."""
    _, not_p, p_, _, _ = _bert_tables()
    o = ord(c)
    return (c in _ASCII_PUNCT or o in p_
            or (unicodedata.category(c)[0] == "P" and o not in not_p))


class Precompiled:
    """SentencePiece's precompiled charsmap as the tokenizers library's
    ``Precompiled`` normalizer applies it: a uint32 length, that many bytes
    of a darts-clone double-array trie over UTF-8 keys, then the
    NUL-terminated normalized strings that the trie's values point into.
    Each grapheme cluster shorter than 6 bytes is replaced whole by the
    value of the shortest key that prefixes it; otherwise each of its
    characters is looked up alone."""

    def __init__(self, blob: bytes, path: str = "charsmap"):
        if len(blob) < 4:
            _fail(path, "precompiled_charsmap", f"{len(blob)} bytes")
        (size,) = struct.unpack_from("<I", blob)
        if size % 4 or 4 + size > len(blob):
            _fail(path, "precompiled_charsmap",
                  f"trie of {size} bytes in a blob of {len(blob)}")
        self.units = np.frombuffer(blob, "<u4", size // 4, 4).astype(
            np.int64).tolist()
        self.normalized = blob[4 + size:]

    def _prefix_values(self, key: bytes) -> List[int]:
        units = self.units
        if not units:
            return []
        pos = self._offset(units[0])
        found = []
        for b in key:
            if b == 0:
                break
            pos ^= b
            if pos >= len(units):
                break
            unit = units[pos]
            if unit & ((1 << 31) | 0xFF) != b:
                break
            pos ^= self._offset(unit)
            if (unit >> 8) & 1:
                found.append(units[pos] & ((1 << 31) - 1))
        return found

    @staticmethod
    def _offset(unit: int) -> int:
        return (unit >> 10) << ((unit & (1 << 9)) >> 6)

    def transform(self, chunk: str) -> Optional[str]:
        found = self._prefix_values(chunk.encode())
        if not found:
            return None
        start = found[0]
        end = self.normalized.find(b"\0", start)
        return self.normalized[start:end if end >= 0 else None].decode()

    def __call__(self, s: str) -> str:
        out = []
        for g in graphemes(s):
            if len(g.encode()) < 6:
                norm = self.transform(g)
                if norm is not None:
                    out.append(norm)
                    continue
            for c in g:
                norm = self.transform(c)
                out.append(c if norm is None else norm)
        return "".join(out)


# extended grapheme clusters (UAX #29) as far as they decide anything
# here: a cluster of 6 bytes or more is looked up a character at a time,
# so only clusters of one or two short characters need to be right.
# Extend and SpacingMark come from the mark categories (less the spacing
# marks that UAX #29 leaves out), ZWNJ, ZWJ, emoji modifiers and tags;
# Hangul syllable sequences; CR LF; Prepend; controls break
_EXTEND_EXTRA = frozenset([0x200C, 0x200D, 0xE33, 0xEB3, 0xFF9E, 0xFF9F,
                           *range(0x1F3FB, 0x1F400),
                           *range(0xE0020, 0xE0080)])
_NOT_SPACING_MARK = _codepoints(
    "102b-102c 1038 1062-1064 1067-106d 1083 1087-108c 108f 109a-109c "
    "1a61 1a63-1a64 aa7b aa7d 11720-11721")
_PREPEND = _codepoints(
    "600-605 6dd 70f 890-891 8e2 d4e 110bd 110cd 111c2-111c3 1193f 11941 "
    "11a3a 11a84-11a89 11d46 11f02")


def _hangul(o: int) -> str:
    if 0x1100 <= o <= 0x115F or 0xA960 <= o <= 0xA97C:
        return "L"
    if 0x1160 <= o <= 0x11A7 or 0xD7B0 <= o <= 0xD7C6:
        return "V"
    if 0x11A8 <= o <= 0x11FF or 0xD7CB <= o <= 0xD7FB:
        return "T"
    if 0xAC00 <= o <= 0xD7A3:
        return "LV" if (o - 0xAC00) % 28 == 0 else "LVT"
    return ""


def _gcb(c: str) -> str:
    o, cat = ord(c), unicodedata.category(c)
    if c == "\r":
        return "CR"
    if c == "\n":
        return "LF"
    if o in _PREPEND:
        return "Prepend"
    if o in _EXTEND_EXTRA or cat in ("Mn", "Me") or (
            cat == "Mc" and o not in _NOT_SPACING_MARK):
        return "Extend"
    if cat in ("Cc", "Cf", "Zl", "Zp"):
        return "Control"
    if 0x1F1E6 <= o <= 0x1F1FF:
        return "RI"
    return _hangul(o) or "Other"


def _joins(a: str, b: str, ri_odd: bool) -> bool:
    if a == "CR":
        return b == "LF"
    if a in ("LF", "Control") or b in ("CR", "LF", "Control"):
        return False
    if b == "Extend" or a == "Prepend":
        return True
    if a == "L":
        return b in ("L", "V", "LV", "LVT")
    if a in ("LV", "V"):
        return b in ("V", "T")
    if a in ("LVT", "T"):
        return b == "T"
    return a == b == "RI" and ri_odd


def graphemes(s: str) -> List[str]:
    out: List[str] = []
    prev, ri = "", 0
    for c in s:
        kind = _gcb(c)
        if out and _joins(prev, kind, ri % 2 == 1):
            out[-1] += c
        else:
            out.append(c)
        ri = ri + 1 if kind == "RI" else 0
        prev = kind
    return out


def _normalizer(spec: Optional[dict], path: str,
                field="normalizer") -> List[Callable]:
    """tokenizer.json's normalizer as a list of str -> str functions."""
    if spec is None:
        return []
    kind = spec.get("type")
    if kind == "Sequence":
        return [f for i, n in enumerate(spec["normalizers"])
                for f in _normalizer(n, path, f"{field}.normalizers[{i}]")]
    if kind in ("NFC", "NFD", "NFKC", "NFKD"):
        return [functools.partial(unicodedata.normalize, kind)]
    if kind == "Lowercase":
        return [_lowercase]
    if kind == "Replace":
        pat = _pattern(spec["pattern"], path, field)
        content = spec["content"]
        return [lambda s: pat.sub(lambda _: content, s)]
    if kind == "Strip":
        left, right = spec.get("strip_left"), spec.get("strip_right")
        return [lambda s: (s.lstrip(_WS) if left else s).rstrip(
            _WS if right else "")]
    if kind == "Precompiled":
        blob = base64.b64decode(spec["precompiled_charsmap"] or "")
        return [Precompiled(blob, path)] if blob else []
    if kind == "BertNormalizer":
        return [_bert_normalizer(spec.get("clean_text", True),
                                 spec.get("handle_chinese_chars", True),
                                 spec.get("strip_accents"),
                                 spec.get("lowercase", True))]
    _fail(path, f"{field}.type", f"{kind!r} is not read by this reader")


# ---- pre-tokenizers: (pieces, whether the first piece starts the text)
# -> pieces ----

def _split_pieces(s: str, pat: "re.Pattern", behavior: str,
                  invert: bool) -> List[str]:
    """tokenizers' ``split``: the pattern's matches (or, inverted, what
    lies between them) are the delimiters."""
    spans, pos = [], 0
    for m in pat.finditer(s):
        if m.start() == m.end():
            continue
        if m.start() > pos:
            spans.append((s[pos:m.start()], invert))
        spans.append((m.group(0), not invert))
        pos = m.end()
    if pos < len(s):
        spans.append((s[pos:], invert))
    if behavior == "Removed":
        return [p for p, delim in spans if not delim]
    if behavior == "Isolated":
        return [p for p, _ in spans]
    if behavior == "MergedWithNext":
        out, carry = [], ""
        for p, delim in spans:
            if delim:
                if carry:
                    out.append(carry)
                carry = p
            else:
                out.append(carry + p)
                carry = ""
        if carry:
            out.append(carry)
        return out
    raise ValueError(f"split behavior {behavior!r}")


def _splitter(pat: "re.Pattern", behavior: str, invert: bool) -> Callable:
    return lambda pieces, first: [q for p in pieces for q in _split_pieces(
        p, pat, behavior, invert)]


@functools.lru_cache(maxsize=None)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's byte -> printable character table."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs, n = bs[:], 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _byte_level(add_prefix_space: bool, use_regex: bool) -> Callable:
    table = bytes_to_unicode()

    def pre(pieces, first: bool):
        out = []
        for p in pieces:
            if add_prefix_space and not p.startswith(" "):
                p = " " + p
            parts = (_split_pieces(p, _regex(GPT2_SPLIT), "Isolated", False)
                     if use_regex else [p])
            out += ["".join(table[b] for b in q.encode()) for q in parts]
        return out
    return pre


def _metaspace(replacement: str, prepend_scheme: str,
               split: bool) -> Callable:
    delim = re.compile(re.escape(replacement))

    def pre(pieces, first: bool):
        out = []
        for p in pieces:
            p = p.replace(" ", replacement)
            if p and not p.startswith(replacement) and (
                    prepend_scheme == "always"
                    or (prepend_scheme == "first" and first)):
                p = replacement + p
            out += (_split_pieces(p, delim, "MergedWithNext", False)
                    if split else [p])
        return out
    return pre


def _bert_pre(pieces, first: bool):
    out = []
    for p in pieces:
        for w in _split_pieces(p, _regex(r"\s"), "Removed", False):
            word = ""
            for c in w:
                if bert_is_punctuation(c):
                    if word:
                        out.append(word)
                    out.append(c)
                    word = ""
                else:
                    word += c
            if word:
                out.append(word)
    return out


def _pre_tokenizer(spec: Optional[dict], path: str,
                   field="pre_tokenizer") -> List[Callable]:
    if spec is None:
        return []
    kind = spec.get("type")
    if kind == "Sequence":
        return [f for i, n in enumerate(spec["pretokenizers"])
                for f in _pre_tokenizer(n, path,
                                        f"{field}.pretokenizers[{i}]")]
    if kind == "Split":
        pat = _pattern(spec["pattern"], path, field)
        behavior, invert = spec["behavior"], spec.get("invert", False)
        if behavior not in ("Removed", "Isolated", "MergedWithNext"):
            _fail(path, f"{field}.behavior", f"{behavior!r}")
        return [_splitter(pat, behavior, invert)]
    if kind == "ByteLevel":
        return [_byte_level(spec.get("add_prefix_space", False),
                            spec.get("use_regex", True))]
    if kind == "Metaspace":
        scheme = spec.get("prepend_scheme")
        if scheme is None:       # files of tokenizers < 0.15
            scheme = "always" if spec.get("add_prefix_space", True) \
                else "never"
        return [_metaspace(spec.get("replacement", "▁"), scheme,
                           spec.get("split", True))]
    if kind == "BertPreTokenizer":
        return [_bert_pre]
    if kind == "WhitespaceSplit":
        return [_splitter(_regex(r"\s"), "Removed", False)]
    _fail(path, f"{field}.type", f"{kind!r} is not read by this reader")


# ---- models: one pre-token -> ids ----

class BPE:
    """Byte-pair encoding by merge rank (tokenizers' ``BPE``): the word's
    characters (the last with ``end_of_word_suffix``, the others after the
    first with ``continuing_subword_prefix``), unknown ones as the unk
    token; then, while a pair of neighbours has a merge, the pair of the
    lowest rank (the leftmost among equals) becomes one symbol."""

    def __init__(self, vocab: Dict[str, int], merges: Sequence[Tuple[str,
                 str]], unk_token: Optional[str], prefix: str = "",
                 suffix: str = "", fuse_unk: bool = False,
                 path: str = "merges"):
        self.vocab, self.prefix, self.suffix = vocab, prefix or "", \
            suffix or ""
        self.unk_id = vocab.get(unk_token) if unk_token else None
        self.fuse_unk = fuse_unk
        self.merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, (a, b) in enumerate(merges):
            new = a + b[len(self.prefix):]
            for tok in (a, b, new):
                if tok not in vocab:
                    _fail(path, f"merge {rank} ({a} {b})",
                          f"{tok!r} is not in the vocabulary")
            self.merges[(vocab[a], vocab[b])] = (rank, vocab[new])
        self.cache: Dict[str, List[int]] = {}

    def __call__(self, word: str) -> List[int]:
        hit = self.cache.get(word)
        if hit is not None:
            return hit
        syms: List[int] = []
        unk = 0          # characters in the pending unk run
        for i, c in enumerate(word):
            s = (self.prefix if i else "") + c + (
                self.suffix if i == len(word) - 1 else "")
            if s in self.vocab:
                if unk:
                    syms.append(self.unk_id)
                    unk = 0
                syms.append(self.vocab[s])
            elif self.unk_id is not None:
                if unk and not self.fuse_unk:
                    syms.append(self.unk_id)
                unk = 1
        if unk:
            syms.append(self.unk_id)
        while len(syms) > 1:
            best = None
            for i in range(len(syms) - 1):
                m = self.merges.get((syms[i], syms[i + 1]))
                if m is not None and (best is None or m[0] < best[0]):
                    best = (m[0], i, m[1])
            if best is None:
                break
            _, i, new = best
            syms[i:i + 2] = [new]
        self.cache[word] = syms
        return syms


class WordPiece:
    """Greedy longest-match-first WordPiece (tokenizers' ``WordPiece``):
    a word longer than ``max_chars`` characters, or one that a piece
    cannot continue, is the unk token."""

    def __init__(self, vocab: Dict[str, int], unk_token: str,
                 prefix: str = "##", max_chars: int = 100,
                 path: str = "vocab"):
        if unk_token not in vocab:
            _fail(path, "unk_token", f"{unk_token!r} is not in the "
                  "vocabulary")
        self.vocab, self.prefix, self.max_chars = vocab, prefix, max_chars
        self.unk_id = vocab[unk_token]

    def __call__(self, word: str) -> List[int]:
        if len(word) > self.max_chars:
            return [self.unk_id]
        out, start = [], 0
        while start < len(word):
            end = len(word)
            while start < end:
                sub = (self.prefix if start else "") + word[start:end]
                if sub in self.vocab:
                    out.append(self.vocab[sub])
                    break
                end -= 1
            else:
                return [self.unk_id]
            start = end
        return out


class Unigram:
    """SentencePiece's Unigram segmentation as tokenizers' ``Unigram``
    runs it: Viterbi over the pieces' scores (a character no piece covers
    costs the lowest score less 10, as the unk token), the first of equal
    candidates kept; neighbouring unknown runs fuse into one unk."""

    def __init__(self, pieces: Sequence[Tuple[str, float]],
                 unk_id: Optional[int], path: str = "pieces"):
        self.vocab: Dict[str, int] = {}
        for i, (p, _) in enumerate(pieces):
            self.vocab[p] = i
        self.scores = [float(s) for _, s in pieces]
        if unk_id is not None and not 0 <= unk_id < len(pieces):
            _fail(path, "unk_id", f"{unk_id} outside {len(pieces)} pieces")
        self.unk_id = unk_id
        self.unk_score = min(self.scores, default=0.0) - SPIECE_UNK_PENALTY
        self.max_len = max((len(p) for p, _ in pieces), default=1)

    def __call__(self, text: str) -> List[int]:
        n = len(text)
        score = [0.0] * (n + 1)
        start: List[Optional[int]] = [None] * (n + 1)
        ident = [0] * (n + 1)
        for i in range(n):
            here = score[i]
            single = False
            for j in range(i + 1, min(n, i + self.max_len) + 1):
                pid = self.vocab.get(text[i:j])
                if pid is None:
                    continue
                cand = self.scores[pid] + here
                if start[j] is None or cand > score[j]:
                    score[j], start[j], ident[j] = cand, i, pid
                single |= j == i + 1
            if not single:
                if self.unk_id is None:
                    raise ValueError(f"{text[i]!r} has no piece and the "
                                     "model no unk id")
                cand = self.unk_score + here
                if start[i + 1] is None or cand > score[i + 1]:
                    score[i + 1], start[i + 1], ident[i + 1] = \
                        cand, i, self.unk_id
        pieces: List[str] = []
        unk_run: List[str] = []
        end = n
        while end > 0:
            s = start[end]
            if ident[end] == self.unk_id:
                unk_run.append(text[s:end])
            else:
                if unk_run:
                    pieces.append("".join(reversed(unk_run)))
                    unk_run = []
                pieces.append(text[s:end])
            end = s
        if unk_run:
            pieces.append("".join(reversed(unk_run)))
        return [self.vocab.get(p, self.unk_id) for p in reversed(pieces)]


# ---- the pipeline ----

class AddedToken:
    """A token split out of the text before the model sees it: matched on
    the raw text, or (``normalized``) on the normalized text."""
    __slots__ = ("content", "id", "normalized")

    def __init__(self, content: str, id: int, normalized: bool):
        self.content, self.id, self.normalized = content, id, normalized


def _split_added(text: str, table: Dict[str, int]
                 ) -> List[Tuple[str, Optional[int]]]:
    """Leftmost-longest matches of ``table``'s strings in ``text``:
    [(piece, id or None)], empty pieces dropped."""
    if not table:
        return [(text, None)] if text else []
    by_first: Dict[str, List[str]] = {}
    for k in sorted(table, key=len, reverse=True):
        if k:
            by_first.setdefault(k[0], []).append(k)
    out, pos, i = [], 0, 0
    while i < len(text):
        hit = next((k for k in by_first.get(text[i], ())
                    if text.startswith(k, i)), None)
        if hit is None:
            i += 1
            continue
        if i > pos:
            out.append((text[pos:i], None))
        out.append((hit, table[hit]))
        i = pos = i + len(hit)
    if pos < len(text):
        out.append((text[pos:], None))
    return out


class Tokenizer:
    """A directory's tokenizer: ``tok(texts, max_length) -> (ids int64
    [N, max_length], mask bool [N, max_length])``, padded on the right with
    ``pad_token_id`` and truncated to ``max_length`` with the special
    tokens kept; ``encode(text)`` the unpadded ids; ``token_to_id``."""

    def __init__(self, normalizers: List[Callable],
                 pre_tokenizers: List[Callable], model: Callable,
                 vocab: Dict[str, int], prefix: List[int],
                 suffix: List[int], added: List[AddedToken],
                 special: Dict[str, str], path: str):
        self.normalizers, self.pre_tokenizers = normalizers, pre_tokenizers
        self.model, self.vocab = model, vocab
        self.prefix, self.suffix = list(prefix), list(suffix)
        self.added, self.special, self.path = added, special, path
        self.raw_table = {a.content: a.id for a in added
                          if not a.normalized}
        self.norm_table = {self.normalize(a.content): a.id for a in added
                           if a.normalized}
        self.pad_token_id = self._special_id("pad_token")
        self.mask_token_id = self._special_id("mask_token")
        self.cache: Dict[str, List[int]] = {}

    def _special_id(self, key: str) -> Optional[int]:
        tok = self.special.get(key)
        return None if tok is None else self.token_to_id(tok)

    def token_to_id(self, token: str) -> Optional[int]:
        for a in self.added:
            if a.content == token:
                return a.id
        return self.vocab.get(token)

    def normalize(self, s: str) -> str:
        for f in self.normalizers:
            s = f(s)
        return s

    def _pre(self, s: str, first: bool) -> List[str]:
        pieces = [s]
        for f in self.pre_tokenizers:
            pieces = [p for p in f(pieces, first) if p]
        return pieces

    def tokenize(self, text: str) -> List[int]:
        """The ids of ``text`` without the post-processor's tokens."""
        hit = self.cache.get(text)
        if hit is not None:
            return hit
        ids: List[int] = []
        first = True
        for raw, rid in _split_added(text, self.raw_table):
            if rid is not None:
                ids.append(rid)
                first = False
                continue
            at_start = first
            for piece, nid in _split_added(self.normalize(raw),
                                           self.norm_table):
                if nid is not None:
                    ids.append(nid)
                else:
                    for w in self._pre(piece, at_start):
                        ids += self.model(w)
                at_start = False
            first = False
        self.cache[text] = ids
        return ids

    def encode(self, text: str, max_length: Optional[int] = None
               ) -> List[int]:
        body = self.tokenize(text)
        if max_length is not None:
            body = body[:max(max_length - len(self.prefix)
                             - len(self.suffix), 0)]
        return self.prefix + body + self.suffix

    def __call__(self, texts: Sequence[str], max_length: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
        if self.pad_token_id is None:
            _fail(self.path, "pad_token", "the tokenizer has no pad token")
        texts = list(texts)
        ids = np.full((len(texts), max_length), self.pad_token_id, np.int64)
        mask = np.zeros((len(texts), max_length), bool)
        for i, t in enumerate(texts):
            row = self.encode(t, max_length)[:max_length]
            ids[i, :len(row)] = row
            mask[i, :len(row)] = True
        return ids, mask


# ---- special tokens ----

CLASS_DEFAULTS = {
    "clip": dict(bos_token="<|startoftext|>", eos_token="<|endoftext|>",
                 unk_token="<|endoftext|>", pad_token="<|endoftext|>"),
    "t5": dict(eos_token="</s>", unk_token="<unk>", pad_token="<pad>"),
    "bert": dict(unk_token="[UNK]", sep_token="[SEP]", pad_token="[PAD]",
                 cls_token="[CLS]", mask_token="[MASK]"),
}
SPECIAL_KEYS = ("bos_token", "eos_token", "unk_token", "sep_token",
                "pad_token", "cls_token", "mask_token")


def _read_json(path: str) -> dict:
    if not os.path.exists(path):
        return {}
    try:
        with open(path, encoding="utf-8") as f:
            return json.load(f)
    except json.JSONDecodeError as e:
        raise TokenizerFileError(f"{path}: not JSON ({e})") from e


def _token_spec(v, path: str, key: str) -> Tuple[str, bool]:
    """(content, normalized) of a special-token entry: a string or an
    AddedToken dict."""
    if isinstance(v, str):
        return v, False
    if isinstance(v, dict) and isinstance(v.get("content"), str):
        for flag in ("lstrip", "rstrip", "single_word"):
            if v.get(flag):
                _fail(path, f"{key}.{flag}", "not read by this reader")
        return v["content"], bool(v.get("normalized", False))
    _fail(path, key, f"{v!r} is not a token")


def _class_kind(config: dict, default: str) -> str:
    cls = (config.get("tokenizer_class") or "").lower()
    for kind in ("clip", "t5", "bert"):
        if cls.startswith(kind):
            return kind
    return default


def _specials(tok_dir: str, kind: str, config: dict
              ) -> Tuple[Dict[str, str], List[Tuple[str, bool]]]:
    """The special tokens by key (the class's defaults, then
    tokenizer_config.json, then special_tokens_map.json), and the list of
    (content, normalized) that the tokenizer adds, in transformers'
    order."""
    cfg_path = os.path.join(tok_dir, "tokenizer_config.json")
    map_path = os.path.join(tok_dir, "special_tokens_map.json")
    special = dict(CLASS_DEFAULTS[kind])
    flags: Dict[str, bool] = {}
    extra: List[Tuple[str, bool]] = []
    sources = [(cfg_path, config)]
    if "added_tokens_decoder" not in config:
        sources.append((map_path, _read_json(map_path)))
    for path, src in sources:
        for key in SPECIAL_KEYS:
            if src.get(key) is not None:
                special[key], flags[key] = _token_spec(src[key], path, key)
        for i, v in enumerate(src.get("additional_special_tokens") or []):
            tok = _token_spec(v, path, f"additional_special_tokens[{i}]")
            if tok[0] not in [e[0] for e in extra]:
                extra.append(tok)
    if kind == "t5":
        n = config.get("extra_ids", 100)
        sentinels = [f"<extra_id_{i}>" for i in range(n)]
        have = [e[0] for e in extra]
        if n and not any(s in have for s in sentinels):
            extra = [(s, False) for s in sentinels] + extra
    tokens = [(special[k], flags.get(k, False)) for k in SPECIAL_KEYS
              if k in special] + extra
    return special, tokens


def _added_tokens(tok_dir: str, config: dict, vocab: Dict[str, int],
                  listed: List[AddedToken], tokens: List[Tuple[str, bool]]
                  ) -> List[AddedToken]:
    """``listed`` (tokenizer.json's added tokens, spiece's control
    pieces), then tokenizer_config.json's ``added_tokens_decoder``,
    ``added_tokens.json``, then the special ``tokens`` not added yet; a
    token outside the vocabulary takes the next free id."""
    out = list(listed)
    cfg_path = os.path.join(tok_dir, "tokenizer_config.json")
    for idx, v in sorted(((int(k), v) for k, v in
                          (config.get("added_tokens_decoder") or {}).items()),
                         key=lambda x: x[0]):
        content, normalized = _token_spec(v, cfg_path,
                                          f"added_tokens_decoder.{idx}")
        out.append(AddedToken(content, idx, normalized))
    for content, idx in _read_json(os.path.join(
            tok_dir, "added_tokens.json")).items():
        out.append(AddedToken(content, int(idx), False))
    have = {a.content for a in out}
    for content, normalized in tokens:
        if content in have:
            continue
        idx = vocab.get(content)
        if idx is None:
            top = max([a.id for a in out] + [len(vocab) - 1])
            idx = max(top + 1, len(vocab))
        out.append(AddedToken(content, idx, normalized))
        have.add(content)
    uniq: Dict[str, AddedToken] = {}
    for a in out:
        uniq.setdefault(a.content, a)
    return list(uniq.values())


# ---- CLIP: vocab.json + merges.txt ----

def _clip_pipeline():
    return ([functools.partial(unicodedata.normalize, "NFC"),
             lambda s: _regex(r"\s+").sub(" ", s), _lowercase],
            [_splitter(_regex(CLIP_SPLIT), "Removed", True),
             _byte_level(False, True)])


def read_clip_files(tok_dir: str, config: dict) -> Tokenizer:
    vocab_path = os.path.join(tok_dir, "vocab.json")
    merges_path = os.path.join(tok_dir, "merges.txt")
    vocab = _read_json(vocab_path)
    if not isinstance(vocab, dict) or not vocab:
        _fail(vocab_path, "vocabulary", "not a JSON object of ids")
    with open(merges_path, encoding="utf-8") as f:
        lines = f.read().strip().split("\n")[1:CLIP_MAX_MERGES + 1]
    merges: Dict[Tuple[str, str], None] = {}
    for i, line in enumerate(lines):
        pair = tuple(line.split())
        if len(pair) != 2:
            _fail(merges_path, f"line {i + 2}", f"{line!r} is not a pair")
        merges[pair] = None
    special, tokens = _specials(tok_dir, "clip", config)
    model = BPE(vocab, list(merges), special["unk_token"], "", "</w>",
                path=merges_path)
    norm, pre = _clip_pipeline()
    added = _added_tokens(tok_dir, config, vocab, [], tokens)
    ids = {a.content: a.id for a in added}
    return Tokenizer(norm, pre, model, vocab, [ids[special["bos_token"]]],
                     [ids[special["eos_token"]]], added, special, tok_dir)


# ---- BERT: vocab.txt ----

def read_bert_files(tok_dir: str, config: dict) -> Tokenizer:
    path = os.path.join(tok_dir, "vocab.txt")
    vocab: Dict[str, int] = {}
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            vocab[line.rstrip("\n")] = i
    special, tokens = _specials(tok_dir, "bert", config)
    model = WordPiece(vocab, special["unk_token"], path=path)
    added = _added_tokens(tok_dir, config, vocab, [], tokens)
    ids = {a.content: a.id for a in added}
    return Tokenizer([_bert_config_normalizer(config)], [_bert_pre], model,
                     vocab, [ids[special["cls_token"]]],
                     [ids[special["sep_token"]]], added, special, tok_dir)


def _bert_config_normalizer(config: dict) -> Callable:
    """BertTokenizerFast's normalizer from its init arguments (which it
    applies over a tokenizer.json's own)."""
    return _bert_normalizer(True, config.get("tokenize_chinese_chars", True),
                            config.get("strip_accents"),
                            config.get("do_lower_case", True))


# ---- SentencePiece: spiece.model ----

def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    shift = value = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if b < 0x80:
            return value, pos
        shift += 7


def protobuf_fields(buf: bytes, names: Optional[Dict[int, str]] = None):
    """(field number, wire type, value) of one protobuf message: varints
    as int, 64/32-bit fields as raw bytes, length-delimited as bytes.  A
    malformed field raises ValueError, naming it from ``names``."""
    pos = 0
    while pos < len(buf):
        key, pos = _varint(buf, pos)
        field = key >> 3
        try:
            value, pos = _wire_value(buf, pos, key & 7)
        except ValueError as e:
            name = (names or {}).get(field, f"field {field}")
            raise ValueError(f"{name}: {e}") from e
        yield field, key & 7, value


def _wire_value(buf: bytes, pos: int, wire: int) -> Tuple[object, int]:
    if wire == 0:
        return _varint(buf, pos)
    n = {1: 8, 5: 4}.get(wire)
    if wire == 2:
        n, pos = _varint(buf, pos)
    if n is None:
        raise ValueError(f"wire type {wire}")
    if pos + n > len(buf):
        raise ValueError("runs past the end of the message")
    return buf[pos:pos + n], pos + n


def _int32(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


def read_spiece_model(path: str) -> dict:
    """The parts of a SentencePiece ``ModelProto`` that tokenizing needs:
    ``pieces`` [(piece, score, type)], ``trainer`` (model_type, unk_id,
    eos_id, pad_id, byte_fallback) and ``normalizer`` (name,
    precompiled_charsmap, add_dummy_prefix, remove_extra_whitespaces,
    escape_whitespaces), with the proto's defaults."""
    with open(path, "rb") as f:
        buf = f.read()
    trainer = dict(model_type=1, unk_id=0, eos_id=2, pad_id=-1,
                   byte_fallback=False)
    normalizer = dict(name="", precompiled_charsmap=b"",
                      add_dummy_prefix=True, remove_extra_whitespaces=True,
                      escape_whitespaces=True)
    t_fields = {3: "model_type", 40: "unk_id", 42: "eos_id", 43: "pad_id",
                35: "byte_fallback"}
    n_fields = {1: "name", 2: "precompiled_charsmap", 3: "add_dummy_prefix",
                4: "remove_extra_whitespaces", 5: "escape_whitespaces"}
    pieces = []
    field = "ModelProto"
    try:
        for num, wire, value in protobuf_fields(buf, {
                1: "pieces", 2: "trainer_spec", 3: "normalizer_spec"}):
            if num == 1 and wire == 2:
                field = f"pieces[{len(pieces)}]"
                piece, score, kind = None, 0.0, 1
                for n, w, v in protobuf_fields(value):
                    if n == 1 and w == 2:
                        piece = v.decode("utf-8")
                    elif n == 2 and w == 5:
                        (score,) = struct.unpack("<f", v)
                    elif n == 3 and w == 0:
                        kind = v
                if piece is None:
                    _fail(path, f"{field}.piece", "missing")
                pieces.append((piece, score, kind))
            elif num == 2 and wire == 2:
                field = "trainer_spec"
                for n, w, v in protobuf_fields(value):
                    if n in t_fields and w == 0:
                        trainer[t_fields[n]] = (bool(v) if n == 35
                                                else _int32(v))
            elif num == 3 and wire == 2:
                field = "normalizer_spec"
                for n, w, v in protobuf_fields(value):
                    if n in n_fields:
                        key = n_fields[n]
                        normalizer[key] = (v.decode("utf-8") if n == 1 else
                                           v if n == 2 else bool(v))
            field = "ModelProto"
    except TokenizerFileError:
        raise
    except (ValueError, UnicodeDecodeError, struct.error) as e:
        raise TokenizerFileError(f"{path}: {field}: {e}") from e
    if not pieces:
        _fail(path, "pieces", "no pieces")
    return dict(pieces=pieces, trainer=trainer, normalizer=normalizer)


def read_spiece_files(tok_dir: str, config: dict) -> Tokenizer:
    """T5TokenizerFast from ``spiece.model`` (transformers' T5Converter):
    the Unigram pieces and the ``<extra_id_N>`` sentinels (99 first), the
    charsmap, then a right strip and runs of spaces as one ``▁``;
    Metaspace; ``</s>`` appended."""
    path = os.path.join(tok_dir, "spiece.model")
    proto = read_spiece_model(path)
    tr = proto["trainer"]
    if tr["model_type"] != 1:
        _fail(path, "trainer_spec.model_type",
              f"{tr['model_type']} is not Unigram (1)")
    if tr["byte_fallback"]:
        _fail(path, "trainer_spec.byte_fallback", "not read by this reader")
    n_extra = config.get("extra_ids", 100)
    pieces = [(p, s) for p, s, _ in proto["pieces"]]
    pieces += [(f"<extra_id_{i}>", 0.0) for i in range(n_extra - 1, -1, -1)]
    model = Unigram(pieces, tr["unk_id"], path)
    charsmap = proto["normalizer"]["precompiled_charsmap"]
    norm = ([Precompiled(charsmap, path)] if charsmap else []) + [
        lambda s: s.rstrip(_WS), lambda s: re.sub(" {2,}", "▁", s)]
    legacy = config.get("legacy", True) is not False
    add_prefix = config.get("add_prefix_space", True) is not False
    pre = [_metaspace("▁", ("always" if legacy else "first")
                      if add_prefix else "never", True)]
    listed = [AddedToken(p, i, False) for i, (p, _, kind) in
              enumerate(proto["pieces"]) if kind in (3, 4)]
    config = dict(config, extra_ids=n_extra)
    special, tokens = _specials(tok_dir, "t5", config)
    added = _added_tokens(tok_dir, config, model.vocab, listed, tokens)
    eos = next(a.id for a in added if a.content == "</s>") if any(
        a.content == "</s>" for a in added) else model.vocab.get("</s>")
    if eos is None:
        _fail(path, "pieces", "no </s>")
    return Tokenizer(norm, pre, model, model.vocab, [], [eos], added,
                     special, tok_dir)


# ---- tokenizer.json ----

def _post_processor(spec: Optional[dict], path: str
                    ) -> Tuple[List[int], List[int]]:
    """(prefix ids, suffix ids) of a single sequence."""
    if spec is None:
        return [], []
    kind = spec.get("type")
    if kind in ("RobertaProcessing", "BertProcessing"):
        return [spec["cls"][1]], [spec["sep"][1]]
    if kind == "TemplateProcessing":
        tokens = spec.get("special_tokens", {})
        prefix, suffix, seen = [], [], False
        for i, item in enumerate(spec["single"]):
            if "Sequence" in item:
                seen = True
                continue
            name = item["SpecialToken"]["id"]
            if name not in tokens:
                _fail(path, f"post_processor.single[{i}]",
                      f"{name!r} is not among its special_tokens")
            (suffix if seen else prefix).extend(tokens[name]["ids"])
        return prefix, suffix
    _fail(path, "post_processor.type", f"{kind!r} is not read by this "
          "reader")


def _model(spec: dict, path: str):
    kind = spec.get("type")
    if spec.get("byte_fallback"):
        _fail(path, "model.byte_fallback", "not read by this reader")
    if kind == "BPE":
        if spec.get("dropout") or spec.get("ignore_merges"):
            _fail(path, "model.dropout / ignore_merges", "not read by this "
                  "reader")
        merges = [tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m)
                  for m in spec["merges"]]
        vocab = spec["vocab"]
        return BPE(vocab, merges, spec.get("unk_token"),
                   spec.get("continuing_subword_prefix") or "",
                   spec.get("end_of_word_suffix") or "",
                   spec.get("fuse_unk", False), path), vocab
    if kind == "WordPiece":
        vocab = spec["vocab"]
        return WordPiece(vocab, spec["unk_token"],
                         spec.get("continuing_subword_prefix", "##"),
                         spec.get("max_input_chars_per_word", 100),
                         path), vocab
    if kind == "Unigram":
        model = Unigram([(p, s) for p, s in spec["vocab"]],
                        spec.get("unk_id"), path)
        return model, model.vocab
    _fail(path, "model.type", f"{kind!r} is not read by this reader")


def read_tokenizer_json(tok_dir: str, config: dict) -> Tokenizer:
    path = os.path.join(tok_dir, "tokenizer.json")
    spec = _read_json(path)
    try:
        model, vocab = _model(spec["model"], path)
        kind = _class_kind(config, dict(
            BPE="clip", WordPiece="bert", Unigram="t5")[type(model).__name__])
        norm = _normalizer(spec.get("normalizer"), path)
        if kind == "bert" and (spec.get("normalizer") or {}).get(
                "type") == "BertNormalizer":
            norm = [_bert_config_normalizer(config)]
        pre = _pre_tokenizer(spec.get("pre_tokenizer"), path)
        prefix, suffix = _post_processor(spec.get("post_processor"), path)
        listed = []
        for i, a in enumerate(spec.get("added_tokens") or []):
            for flag in ("lstrip", "rstrip", "single_word"):
                if a.get(flag):
                    _fail(path, f"added_tokens[{i}].{flag}",
                          "not read by this reader")
            listed.append(AddedToken(a["content"], a["id"],
                                     a.get("normalized", False)))
    except KeyError as e:
        raise TokenizerFileError(f"{path}: missing field {e}") from e
    special, tokens = _specials(tok_dir, kind, config)
    added = _added_tokens(tok_dir, config, vocab, listed, tokens)
    return Tokenizer(norm, pre, model, vocab, prefix, suffix, added,
                     special, tok_dir)


# ---- the directory ----

def load_tokenizer(tok_dir: str) -> Tokenizer:
    """The tokenizer of a directory, by the files it holds, in the order
    ``AutoTokenizer`` prefers them: ``tokenizer.json``, else CLIP's
    ``vocab.json`` + ``merges.txt``, T5's ``spiece.model`` or BERT's
    ``vocab.txt``."""
    tok_dir = str(tok_dir)
    config = _read_json(os.path.join(tok_dir, "tokenizer_config.json"))
    has = lambda name: os.path.isfile(os.path.join(tok_dir, name))
    if has("tokenizer.json"):
        return read_tokenizer_json(tok_dir, config)
    if has("vocab.json") and has("merges.txt"):
        return read_clip_files(tok_dir, config)
    if has("spiece.model"):
        return read_spiece_files(tok_dir, config)
    if has("vocab.txt"):
        return read_bert_files(tok_dir, config)
    raise FileNotFoundError(
        f"{tok_dir}: no tokenizer files (tokenizer.json, vocab.json + "
        "merges.txt, spiece.model or vocab.txt)")
