"""gsgen_torch's tokenizer reader (``prompt/tokenizer_files.py``) against
``transformers.AutoTokenizer``, on the CPU.

The test writes the tokenizer files itself: a CLIP byte-level vocabulary
(the 256 byte symbols, their ``</w>`` forms and 300 merges learned by a
pair-count loop over a fixed corpus) with SD 1.5's special tokens (pad
``<|endoftext|>``) and SD 2.1's (pad ``"!"``); T5 as the ``tokenizer.json``
of ``test_torch_text_towers.py`` and as a ``spiece.model`` of the same
pieces (written by the test's own protobuf writer, with a precompiled
charsmap of a few NFKC folds built by the test's own double-array
builder); BERT as a ``vocab.txt`` with ``##`` pieces; and the SD 1.5 and
BERT directories as ``AutoTokenizer.save_pretrained`` writes them again
(``tokenizer.json`` and an ``added_tokens_decoder``).  The reference is
the JAX package's ``prompt/encoders.py::_tokenizer`` (``AutoTokenizer``);
for ``spiece.model``, which ``AutoTokenizer`` reads only with the
``sentencepiece`` package, the reference is ``tokenizer.json`` that
transformers' own ``T5Converter`` makes from the same file.  While the
port reads and tokenizes, ``transformers``, ``tokenizers`` and the other
packages it must not need are blocked in ``sys.modules``.

Prompts: a fixed list (the configs' prompts and their view prompts,
apostrophes, digits, runs of whitespace, accents, CJK, emoji, ``[MASK]``
and ``<|endoftext|>`` written literally, the empty string) and a
``hypothesis`` text strategy over the code points that Python's Unicode
database assigns (``tokenizers``' regular expressions know a later
Unicode version, whose new letters Python files as unassigned), each at
``max_length`` 77 and 8 (truncation).  Ids and masks must be equal.
"""

import ast
import contextlib
import json
import re
import struct
import sys
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from gsgen_tpu.prompt import encoders as enc_j
from gsgen_torch.prompt import tokenizer_files as tf
from gsgen_torch.prompt.processors import direction_templates

ROOT = Path(__file__).resolve().parents[1]
BLOCKED = ("transformers", "tokenizers", "regex", "sentencepiece",
           "google.protobuf", "ftfy", "jax", "gsgen_tpu")
LENGTHS = (77, 8)


@contextlib.contextmanager
def without_tokenizer_packages():
    """``transformers``, ``tokenizers`` and friends unimportable."""
    names = ("transformers", "tokenizers", "regex", "sentencepiece",
             "google.protobuf", "ftfy")
    saved = {n: sys.modules.get(n) for n in names}
    try:
        for n in names:
            sys.modules[n] = None
        yield
    finally:
        for n, m in saved.items():
            if m is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = m


# ---- writers of tokenizer files ----

def darts_trie(keys):
    """A darts-clone double array over ``keys`` ({bytes: value}) as a list
    of uint32 units: a node's children sit at ``base ^ label`` (its unit
    holds ``pos ^ base`` in bits 10-30, its label in bits 0-7, bit 8 when
    a key ends there), the leaf at ``base ^ 0`` holds the value with bit
    31 set; every base is used once and every slot a lookup can reach is
    inside the array."""
    root = {}
    for k, v in keys.items():
        node = root
        for b in k:
            node = node.setdefault(b, {})
        node[None] = v
    units, bases, top = {}, set(), [0]

    def place(node, pos, label):
        kids = sorted(b for b in node if b is not None)
        labels = ([0] if None in node else []) + kids
        base = 1
        while base in bases or any((base ^ lb) in units or base ^ lb == 0
                                   for lb in labels):
            base += 1
        bases.add(base)
        off = pos ^ base
        assert off < 1 << 21
        units[pos] = label | ((None in node) << 8) | (off << 10)
        for lb in labels:
            units[base ^ lb] = 0
        if None in node:
            units[base] = node[None] | (1 << 31)
        top[0] = max(top[0], base | 0xFF)
        for b in kids:
            place(node[b], base ^ b, b)

    place(root, 0, 0)
    return [units.get(i, 0) for i in range(top[0] + 1)]


def charsmap(mapping):
    """A precompiled charsmap: trie size, trie, NUL-ended strings."""
    blob, keys = b"", {}
    for k, v in mapping.items():
        keys[k.encode()] = len(blob)
        blob += v.encode() + b"\0"
    units = darts_trie(keys)
    return (struct.pack("<I", 4 * len(units))
            + struct.pack(f"<{len(units)}I", *units) + blob)


def _varint(n):
    n &= (1 << 64) - 1
    out = bytearray()
    while True:
        b, n = n & 0x7F, n >> 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(num, wire, payload):
    key = _varint(num << 3 | wire)
    if wire == 0:
        return key + _varint(payload)
    if wire == 5:
        return key + struct.pack("<f", payload)
    return key + _varint(len(payload)) + payload


def spiece_model(pieces, cmap=b"", model_type=1, unk_id=2):
    """A SentencePiece ModelProto: pieces [(piece, score, type)], a
    trainer spec (Unigram, unk 2, bos -1, eos 1, pad 0) and an nmt_nfkc
    normalizer spec."""
    out = b"".join(_field(1, 2, _field(1, 2, p.encode()) + _field(2, 5, s)
                          + _field(3, 0, t)) for p, s, t in pieces)
    out += _field(2, 2, _field(3, 0, model_type) + _field(4, 0, len(pieces))
                  + _field(40, 0, unk_id) + _field(41, 0, -1)
                  + _field(42, 0, 1) + _field(43, 0, 0))
    out += _field(3, 2, _field(1, 2, b"nmt_nfkc")
                  + (_field(2, 2, cmap) if cmap else b"")
                  + _field(3, 0, 1) + _field(4, 0, 1) + _field(5, 0, 1))
    return out


CORPUS = ("a red corgi sitting on a wooden chair, side view; a photo of a "
          "DSLR zoomed out view of a squirrel playing guitar; hamburger, "
          "a delicious hamburger with cheese and tomato 123 4k 8k; the "
          "cat's toy isn't there, we'll see; café über naïve résumé; a "
          "high quality photo of a furry corgi, front view, back view, "
          "overhead view; michelangelo style statue of dog reading news")


def learn_merges(n, sym):
    """``n`` BPE merges by pair counts over CORPUS's words (byte symbols,
    ``</w>`` on each word's last), the most frequent pair first, ties by
    the pair itself."""
    words = Counter(re.findall(r"[a-z]+|[0-9]|[^\sa-z0-9]+",
                               CORPUS.lower()))
    seqs = {w: [sym[b] for b in w.encode()] for w in words}
    for s in seqs.values():
        s[-1] += "</w>"
    merges = []
    for _ in range(n):
        pairs = Counter()
        for w, s in seqs.items():
            for p in zip(s, s[1:]):
                pairs[p] += words[w]
        if not pairs:
            break
        (a, b), _ = max(pairs.items(), key=lambda kv: (kv[1], kv[0]))
        merges.append((a, b))
        for w, s in seqs.items():
            out, i = [], 0
            while i < len(s):
                if s[i:i + 2] == [a, b]:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(s[i])
                    i += 1
            seqs[w] = out
    return merges


def _added(content):
    return {"__type": "AddedToken", "content": content, "lstrip": False,
            "normalized": True, "rstrip": False, "single_word": False}


def clip_files(d: Path, pad: str):
    """A CLIP tokenizer directory laid out as SD 1.5's / SD 2.1's."""
    d.mkdir(parents=True, exist_ok=True)
    syms = list(tf.bytes_to_unicode().values())
    vocab = {s: i for i, s in enumerate(syms)}
    vocab.update({s + "</w>": 256 + i for i, s in enumerate(syms)})
    merges = learn_merges(300, tf.bytes_to_unicode())
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text("#version: 0.2\n" + "\n".join(
        f"{a} {b}" for a, b in merges) + "\n")
    special = {"bos_token": _added("<|startoftext|>"),
               "eos_token": _added("<|endoftext|>"),
               "unk_token": _added("<|endoftext|>"), "pad_token": pad}
    (d / "tokenizer_config.json").write_text(json.dumps(dict(
        special, add_prefix_space=False, do_lower_case=True,
        errors="replace", model_max_length=77,
        tokenizer_class="CLIPTokenizer")))
    (d / "special_tokens_map.json").write_text(json.dumps(special))
    return len(merges)


T5_PIECES = ([("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0)]
             + [("▁" + w, -1.0) for w in ("a", "corgi", "red", "side",
                                          "view", "front", "back")]
             + [(c, -5.0) for c in "abcdefghijklmnopqrstuvwxyz,"]
             + [("▁", -3.0)])
NFKC_FOLDS = {"Ａ": "A", "Ｂ": "B", "ａ": "a", "ｒ": "r", "ｃ": "c",
              "ﬁ": "fi", "①": "1", "　": " ", "é": "é"}


def t5_json(d: Path):
    """test_torch_text_towers.py's T5 ``tokenizer.json`` directory."""
    tokenizers = pytest.importorskip("tokenizers")
    from tokenizers import decoders, models, pre_tokenizers, processors
    tok = tokenizers.Tokenizer(models.Unigram(T5_PIECES, unk_id=2))
    tok.pre_tokenizer = pre_tokenizers.Metaspace()
    tok.decoder = decoders.Metaspace()
    tok.post_processor = processors.TemplateProcessing(
        single="$A </s>", special_tokens=[("</s>", 1)])
    d.mkdir(parents=True, exist_ok=True)
    tok.save(str(d / "tokenizer.json"))
    (d / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "T5TokenizerFast", "pad_token": "<pad>",
         "eos_token": "</s>", "unk_token": "<unk>", "extra_ids": 0}))


def t5_spiece(d: Path, reference: Path):
    """``spiece.model`` of T5_PIECES (+ the charsmap), and in
    ``reference`` the tokenizer.json that transformers' T5Converter makes
    of it (what AutoTokenizer builds with sentencepiece installed)."""
    from transformers.convert_slow_tokenizer import T5Converter
    types = {"<pad>": 3, "</s>": 3, "<unk>": 2}
    d.mkdir(parents=True, exist_ok=True)
    (d / "spiece.model").write_bytes(spiece_model(
        [(p, s, types.get(p, 1)) for p, s in T5_PIECES],
        charsmap(NFKC_FOLDS)))
    config = json.dumps({"tokenizer_class": "T5Tokenizer", "extra_ids": 100})
    (d / "tokenizer_config.json").write_text(config)
    slow = SimpleNamespace(vocab_file=str(d / "spiece.model"), _extra_ids=100,
                           legacy=True, add_prefix_space=True,
                           convert_tokens_to_ids=lambda t: 1)
    reference.mkdir(parents=True, exist_ok=True)
    T5Converter(slow).converted().save(str(reference / "tokenizer.json"))
    (reference / "tokenizer_config.json").write_text(config)


BERT_WORDS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "this", "image",
              "is", "depicting", "a", "view", "of", "side", "front", "back",
              "overhead", "corgi", "cat", "red", "dog", "sitting", "##s",
              "##ing", "##i", "##g", "##r", "##o", "c", "d", "e", "s", "t",
              "##a", "##e", "##t", ",", ".", "!", "'", "1", "2", "##1", "中",
              "cafe", "über", "uber", "photo", "high", "quality", "furry"]


def bert_files(d: Path, lower=True):
    d.mkdir(parents=True, exist_ok=True)
    (d / "vocab.txt").write_text("\n".join(BERT_WORDS) + "\n")
    (d / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "BertTokenizer", "do_lower_case": lower}))


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """{kind: (the port's directory, the reference's directory)}."""
    root = tmp_path_factory.mktemp("tok")
    out = {}
    for name, pad in (("sd15", "<|endoftext|>"), ("sd21", "!")):
        clip_files(root / name / "tokenizer", pad)
        out[name] = (root / name,) * 2
    t5_json(root / "t5_json")
    out["t5_json"] = (root / "t5_json",) * 2
    t5_spiece(root / "t5_spiece", root / "t5_spiece_reference")
    out["t5_spiece"] = (root / "t5_spiece", root / "t5_spiece_reference")
    bert_files(root / "bert")
    out["bert"] = (root / "bert",) * 2
    bert_files(root / "bert_cased", lower=False)
    out["bert_cased"] = (root / "bert_cased",) * 2
    # what AutoTokenizer.save_pretrained writes: tokenizer.json (BPE,
    # WordPiece) and an added_tokens_decoder in tokenizer_config.json
    from transformers import AutoTokenizer
    for name in ("sd15", "bert"):
        AutoTokenizer.from_pretrained(
            str(_tok_dir(out[name][0])), local_files_only=True
        ).save_pretrained(str(root / f"{name}_saved"))
        out[f"{name}_saved"] = (root / f"{name}_saved",) * 2
    return out


def _config_prompts():
    found = set()
    for p in sorted((ROOT / "configs").rglob("*.yaml")):
        prompt = (yaml.safe_load(p.read_text()) or {}).get("prompt") or {}
        if isinstance(prompt.get("prompt"), str):
            found.add(prompt["prompt"])
    texts = sorted(found)
    for t in texts[:]:
        texts += direction_templates(t) + direction_templates(t, True)
    return texts


PROMPTS = _config_prompts() + [
    "", "a red corgi", "the cat's toy isn't there, we'll see! it'd've",
    "'s 'T 're", "123 4567 8k 3.14", "  runs   of\twhitespace \n here  ",
    "a\r\nb", "café über naïve RÉSUMÉ", "ΑΣ Σ ΟΔΟΣ İstanbul",
    "中文 字符 测试", "emoji 😀🐶 ok 👍🏽", "a [MASK] view of a corgi",
    "[mask] [MASK]!", "a <|endoftext|> b", "<|ENDOFTEXT|>x<|startoftext|>",
    "hello!!! ?!", "ＡＢ ａｒ ﬁne ① a　b", "é Ａ́",
    "<extra_id_0> a </s> b <pad>", "x" * 120, "a  ", "  a", "\x00�​"]

TEXT = st.text(alphabet=st.characters(blacklist_categories=("Cs", "Cn")),
               max_size=24)


def _reference(ref_dir, texts, n):
    ids, mask = enc_j._tokenizer(str(ref_dir), n)(texts)
    return np.asarray(ids, np.int64), np.asarray(mask, bool)


def _port(tok_dir, texts, n):
    with without_tokenizer_packages():
        tok = tf.load_tokenizer(str(_tok_dir(tok_dir)))
        return tok(texts, n)


def _tok_dir(root: Path) -> Path:
    return root / "tokenizer" if (root / "tokenizer").is_dir() else root


def _same(got, want, texts):
    for i, t in enumerate(texts):
        np.testing.assert_array_equal(got[0][i], want[0][i], err_msg=repr(t))
        np.testing.assert_array_equal(got[1][i], want[1][i], err_msg=repr(t))


KINDS = ["sd15", "sd21", "t5_json", "t5_spiece", "bert", "bert_cased",
         "sd15_saved", "bert_saved"]


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("kind", KINDS)
def test_fixed_prompts_match_autotokenizer(dirs, kind, n):
    mine, ref = dirs[kind]
    got = _port(mine, PROMPTS, n)
    assert got[0].dtype == np.int64 and got[1].dtype == bool
    assert got[0].shape == got[1].shape == (len(PROMPTS), n)
    _same(got, _reference(ref, PROMPTS, n), PROMPTS)


@pytest.mark.parametrize("kind", KINDS)
def test_hypothesis_texts_match_autotokenizer(dirs, kind):
    mine, ref = dirs[kind]
    with without_tokenizer_packages():
        tok = tf.load_tokenizer(str(_tok_dir(mine)))

    @settings(max_examples=40, deadline=None, derandomize=True,
              database=None, suppress_health_check=list(HealthCheck))
    @given(st.lists(TEXT, min_size=1, max_size=3))
    def check(texts):
        for n in LENGTHS:
            with without_tokenizer_packages():
                got = tok(texts, n)
            _same(got, _reference(ref, texts, n), texts)
    check()


def test_spiece_model_and_tokenizer_json_agree(dirs):
    """The same pieces from ``spiece.model`` and from ``tokenizer.json``
    give the same ids on the configs' prompts (single spaces, no folds)."""
    texts = [t.lower() for t in _config_prompts()]
    a = _port(dirs["t5_spiece"][0], texts, 77)
    b = _port(dirs["t5_json"][0], texts, 77)
    _same(a, b, texts)
    assert (a[0] == 2).sum() < a[0].size    # not all <unk>


def test_charsmap_matches_precompiled():
    """The port's darts-clone reader and grapheme rule against the
    tokenizers library's ``Precompiled`` normalizer, on a charsmap that
    the test builds."""
    normalizers = pytest.importorskip("tokenizers.normalizers")
    blob = charsmap(NFKC_FOLDS)
    ref = normalizers.Precompiled(blob)
    with without_tokenizer_packages():
        mine = tf.Precompiled(blob)
        got = [mine(t) for t in PROMPTS]
    assert got == [ref.normalize_str(t) for t in PROMPTS]
    assert mine("ＡＢﬁ①") == "ABfi1" and mine("Ａ́x") == "Ax"

    @settings(max_examples=200, deadline=None, derandomize=True,
              database=None)
    @given(st.text(alphabet=st.sampled_from(
        list("".join(NFKC_FOLDS)) + ["́", "̈", "‍", "a",
                                     " ", "가", "\r", "\n", "😀"])) | TEXT)
    def check(text):
        assert mine(text) == ref.normalize_str(text)
    check()


def test_spiece_reader_matches_protobuf(tmp_path):
    """The wire-format reader against protobuf's own parse of the same
    file: pieces, scores (float32), types, trainer and normalizer specs."""
    pb = pytest.importorskip("transformers.utils.sentencepiece_model_pb2_new")
    types = {"<pad>": 3, "</s>": 3, "<unk>": 2}
    pieces = [(p, s - 0.1 * i, types.get(p, 1))
              for i, (p, s) in enumerate(T5_PIECES)]
    path = tmp_path / "spiece.model"
    path.write_bytes(spiece_model(pieces, charsmap(NFKC_FOLDS)))
    want = pb.ModelProto()
    want.ParseFromString(path.read_bytes())
    with without_tokenizer_packages():
        got = tf.read_spiece_model(str(path))
    assert got["pieces"] == [(p.piece, p.score, p.type) for p in want.pieces]
    for k in ("model_type", "unk_id", "eos_id", "pad_id"):
        assert got["trainer"][k] == getattr(want.trainer_spec, k), k
    for k in ("name", "precompiled_charsmap", "add_dummy_prefix",
              "remove_extra_whitespaces", "escape_whitespaces"):
        assert got["normalizer"][k] == getattr(want.normalizer_spec, k), k


def test_interface(dirs):
    """token_to_id, the pad and mask ids, and encode without padding, as
    AutoTokenizer has them."""
    from transformers import AutoTokenizer
    for kind in KINDS:
        mine, ref = dirs[kind]
        want = AutoTokenizer.from_pretrained(str(_tok_dir(ref)),
                                             local_files_only=True)
        with without_tokenizer_packages():
            tok = tf.load_tokenizer(str(_tok_dir(mine)))
            got = [tok.token_to_id(w) for w in ("side", "▁side", "[MASK]",
                                                "</s>", "!")]
            enc = tok.encode("side front back overhead")
        assert got == [want.convert_tokens_to_ids(w) if w in want.get_vocab()
                       else None for w in ("side", "▁side", "[MASK]", "</s>",
                                           "!")], kind
        assert tok.pad_token_id == want.pad_token_id, kind
        assert tok.mask_token_id == want.mask_token_id, kind
        assert enc == want("side front back overhead").input_ids, kind


def _bad_json(d: Path):
    d.mkdir()
    spec = {"model": {"type": "Unigram", "unk_id": 0, "vocab": [["a", 0.0]]},
            "normalizer": {"type": "Nmt"}}
    (d / "tokenizer.json").write_text(json.dumps(spec))
    return "normalizer.type"


def _bpe_spiece(d: Path):
    d.mkdir()
    (d / "spiece.model").write_bytes(spiece_model(
        [("<unk>", 0.0, 2), ("a", -1.0, 1)], model_type=2, unk_id=0))
    return "trainer_spec.model_type"


def _cut_spiece(d: Path):
    d.mkdir()
    (d / "spiece.model").write_bytes(spiece_model(
        [(p, s, 1) for p, s in T5_PIECES])[:-7])
    return "normalizer_spec"


def _bad_merge(d: Path):
    n = clip_files(d, "<|endoftext|>")
    with open(d / "merges.txt", "a") as f:
        f.write("q zz\n")
    return f"merge {n} (q zz)"


@pytest.mark.parametrize("make", [_bad_json, _bpe_spiece, _cut_spiece,
                                  _bad_merge])
def test_unreadable_file_names_file_and_field(tmp_path, make):
    field = make(tmp_path / "tok")
    with without_tokenizer_packages():
        with pytest.raises(tf.TokenizerFileError) as e:
            tf.load_tokenizer(str(tmp_path / "tok"))
    assert str(tmp_path / "tok") in str(e.value) and field in str(e.value)


def test_port_imports_no_tokenizer_package():
    """No module under gsgen_torch/ imports transformers, tokenizers,
    regex, sentencepiece, google.protobuf, ftfy, jax or the JAX package,
    at its top or inside a function."""
    hits = []
    for path in sorted((ROOT / "gsgen_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                names = [node.module or ""]
            else:
                continue
            hits += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                     for n in names if any(n == b or n.startswith(b + ".")
                                           for b in BLOCKED)]
    assert not hits, hits
