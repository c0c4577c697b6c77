"""gsgen_torch's T5 and BERT towers, the text-encoder pipelines and prompt
debiasing against the JAX package, on the CPU.

Both packages are filled from one random state dict in the transformers
layout (built from the port's modules), handed over as numpy arrays or
written as safetensors into model directories that the test writes with
tokenizer files of tiny vocabularies (CLIP ``vocab.json`` +
``merges.txt``, BERT ``vocab.txt``, T5 a ``tokenizer.json`` made with the
``tokenizers`` package); the JAX package tokenizes them with
``transformers.AutoTokenizer``, the port with its own reader
(``prompt/tokenizer_files.py``, held to AutoTokenizer id for id by
tests/test_torch_tokenize.py).
Covered: T5 (``TINY_T5``, masked, and past ``relative_attention_max_
distance``), its relative position buckets, BERT (``TINY_BERT`` MLM
logits, with and without a tied decoder), the CLIP text vector from token
ids, each ``build_*_encode_fn`` and ``build_encode_fn``'s kind detection,
``get_debiased_prompt`` with an injected probe, through the prompt
processor and on a BERT directory, ``prompt.model_id`` and
``auxiliary.clip_model_id`` through ``build_trainer``, and every pipeline
with ``transformers`` and ``tokenizers`` blocked.

Tolerances: rtol 3e-4 / atol 3e-5 of the largest value (as
tests/test_text_encoders.py holds the JAX towers to transformers); the
buckets, the debiased prompts and the token ids exactly.
"""

import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import save_file

import gsgen_tpu.config as config_j
from gsgen_tpu.prompt import bert as bert_j
from gsgen_tpu.prompt import debias as debias_j
from gsgen_tpu.prompt import encoders as enc_j
from gsgen_tpu.prompt import processors as proc_j
from gsgen_tpu.prompt import t5 as t5_j
from gsgen_torch.config import build_trainer, load_config
from gsgen_torch.prompt import bert, clip, debias, encoders, processors, t5
from test_torch_clip import random_state
from torch_fixtures import t

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["init.num_points=96", "init.capacity=128", "data.reso=[32]",
         "renderer.tile_size=8", "renderer.chunk=128",
         "renderer.dup_cap=4096", "trainer.batch_size=2",
         "prompt.use_cache=false"]
PROMPT = "a red corgi"


def _close(got, want, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=3e-4,
                               atol=3e-5 * max(np.abs(want).max(), 1e-6),
                               err_msg=what)


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


# ---- tiny tokenizer files ----

def _clip_tokenizer(d: Path):
    chars = list("abcdefghijklmnopqrstuvwxyz,")
    vocab = {c: i for i, c in enumerate(chars)}
    vocab.update({c + "</w>": len(chars) + i for i, c in enumerate(chars)})
    merges = ["c o", "co r", "cor g", "corg i</w>", "r e", "re d</w>"]
    for m in merges:
        vocab["".join(m.split())] = len(vocab)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    d.mkdir(parents=True, exist_ok=True)
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text("#version: 0.2\n" + "\n".join(merges)
                                  + "\n")
    (d / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "CLIPTokenizer", "model_max_length": 77,
         "pad_token": "<|endoftext|>"}))


BERT_WORDS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "this", "image",
              "is", "depicting", "a", "view", "of", "side", "front", "back",
              "overhead", "corgi", "cat", "red", "dog", "sitting"]


def _bert_tokenizer(d: Path):
    d.mkdir(parents=True, exist_ok=True)
    (d / "vocab.txt").write_text("\n".join(BERT_WORDS) + "\n")
    (d / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "BertTokenizer", "do_lower_case": True}))


def _t5_tokenizer(d: Path):
    tokenizers = pytest.importorskip("tokenizers")
    from tokenizers import decoders, models, pre_tokenizers, processors
    vocab = ([("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0)]
             + [("▁" + w, -1.0) for w in ("a", "corgi", "red", "side",
                                          "view", "front", "back")]
             + [(c, -5.0) for c in "abcdefghijklmnopqrstuvwxyz,"]
             + [("▁", -3.0)])
    tok = tokenizers.Tokenizer(models.Unigram(vocab, unk_id=2))
    tok.pre_tokenizer = pre_tokenizers.Metaspace()
    tok.decoder = decoders.Metaspace()
    tok.post_processor = processors.TemplateProcessing(
        single="$A </s>", special_tokens=[("</s>", 1)])
    d.mkdir(parents=True, exist_ok=True)
    tok.save(str(d / "tokenizer.json"))
    (d / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "T5TokenizerFast", "pad_token": "<pad>",
         "eos_token": "</s>", "unk_token": "<unk>", "extra_ids": 0}))


def _encoder_dir(root: Path, config: dict, state: dict):
    enc = root / "text_encoder"
    enc.mkdir(parents=True, exist_ok=True)
    (enc / "config.json").write_text(json.dumps(config))
    save_file({k: v.contiguous() for k, v in state.items()},
              str(enc / "model.safetensors"))


def _t5_state(seed):
    sd = random_state(t5.T5EncoderModel(t5.TINY_T5), seed)
    sd["encoder.embed_tokens.weight"] = sd["shared.weight"].clone()
    return sd


def _bert_state(seed):
    sd = random_state(bert.BertForMaskedLM(bert.TINY_BERT), seed)
    # what a transformers checkpoint holds besides: the position ids, the
    # pooler and cls.predictions.bias (tied to the decoder's bias)
    sd["bert.embeddings.position_ids"] = torch.arange(32)[None]
    sd["bert.pooler.dense.weight"] = torch.zeros(32, 32)
    sd["bert.pooler.dense.bias"] = torch.zeros(32)
    sd["cls.predictions.bias"] = sd["cls.predictions.decoder.bias"].clone()
    return sd


TINY_CLIP_HF = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
                    num_hidden_layers=2, num_attention_heads=2,
                    max_position_embeddings=16)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """Tiny model directories: an SD-style CLIP (gelu), a Point-E style
    CLIP text vector (quick_gelu, projection 16), an IF-style T5 and a
    BERT fill-mask model."""
    root = tmp_path_factory.mktemp("towers")
    out = {}
    d = out["clip"] = root / "clip"
    _clip_tokenizer(d / "tokenizer")
    cfg = clip.CLIPTextConfig(**TINY_CLIP_HF)
    _encoder_dir(d, dict(TINY_CLIP_HF, architectures=["CLIPTextModel"],
                         hidden_act="gelu"),
                 random_state(clip.CLIPTextModel(cfg), 1))
    d = out["textvec"] = root / "textvec"
    _clip_tokenizer(d / "tokenizer")
    cfg = clip.CLIPTextConfig(**TINY_CLIP_HF, hidden_act="quick_gelu")
    _encoder_dir(d, dict(TINY_CLIP_HF, hidden_act="quick_gelu",
                         projection_dim=16,
                         architectures=["CLIPTextModelWithProjection"]),
                 random_state(clip.CLIPTextModelWithProjection(cfg, 16), 2))
    d = out["t5"] = root / "t5"
    _t5_tokenizer(d / "tokenizer")
    c = t5.TINY_T5
    _encoder_dir(d, dict(vocab_size=c.vocab_size, d_model=c.d_model,
                         d_kv=c.d_kv, d_ff=c.d_ff, num_layers=c.num_layers,
                         num_heads=c.num_heads,
                         architectures=["T5EncoderModel"]), _t5_state(3))
    d = out["bert"] = root / "bert"
    _bert_tokenizer(d)
    c = bert.TINY_BERT
    (d / "config.json").write_text(json.dumps(dict(
        vocab_size=c.vocab_size, hidden_size=c.hidden_size,
        num_hidden_layers=c.num_hidden_layers,
        num_attention_heads=c.num_attention_heads,
        intermediate_size=c.intermediate_size,
        max_position_embeddings=c.max_position_embeddings)))
    save_file(_bert_state(4), str(d / "model.safetensors"))
    return out


# ---- the towers from token ids ----

def test_relative_position_bucket_matches_jax():
    rel = np.arange(-600, 601, dtype=np.int32)
    for nb, md in ((32, 128), (32, 64), (16, 20)):
        got = t5.relative_position_bucket(torch.from_numpy(rel), nb, md)
        want = t5_j.relative_position_bucket(jnp.asarray(rel), nb, md)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", ["masked", "long_range"])
def test_t5_matches_jax(case):
    """TINY_T5 from one state dict: padded rows masked, and a sequence of
    300 tokens (offsets past relative_attention_max_distance 128)."""
    sd = _t5_state(5)
    m_t = t5.load_t5_encoder(sd, t5.TINY_T5, device="cpu")
    m_j, p_j = t5_j.load_t5_encoder(_np(sd), t5_j.TINY_T5)
    rng = np.random.default_rng(6)
    if case == "masked":
        ids = rng.integers(0, 128, (3, 12))
        mask = np.arange(12)[None] < np.array([[12], [7], [3]])
    else:
        ids = rng.integers(0, 128, (1, 300))
        mask = np.ones((1, 300), bool)
    with torch.no_grad():
        got = m_t(t(ids), attention_mask=t(mask))
    want = m_j.apply(p_j, jnp.asarray(ids), attention_mask=jnp.asarray(mask))
    _close(got.numpy(), want, case)
    assert not any(p.requires_grad for p in m_t.parameters())


@pytest.mark.parametrize("tied", [False, True])
def test_bert_mlm_matches_jax(tied):
    """TINY_BERT MLM logits; ``tied``: a checkpoint without the decoder's
    weight and bias (the word embeddings and zeros stand in, in both)."""
    sd = _bert_state(7)
    if tied:
        del sd["cls.predictions.decoder.weight"]
        del sd["cls.predictions.decoder.bias"]
    m_t = bert.load_bert_mlm(sd, bert.TINY_BERT, device="cpu")
    m_j, p_j = bert_j.load_bert_mlm(_np(sd), bert_j.TINY_BERT)
    rng = np.random.default_rng(8)
    ids = rng.integers(0, 128, (3, 16))
    mask = np.arange(16)[None] < np.array([[16], [9], [4]])
    with torch.no_grad():
        got = m_t(t(ids), t(mask))
    _close(got.numpy(), m_j.apply(p_j, jnp.asarray(ids), jnp.asarray(mask)))


def test_clip_textvec_tower_from_ids(dirs):
    """The tower half of the text-vector pipeline (what runs without a
    tokenizer) from token ids, against the JAX module on the same file."""
    tower = encoders.load_clip_textvec_dir(str(dirs["textvec"]),
                                           device="cpu")
    from gsgen_tpu.guidance.convert import load_safetensors
    from gsgen_tpu.prompt import clip as clip_j
    cfg_j = clip_j.CLIPTextConfig(**TINY_CLIP_HF, hidden_act="quick_gelu")
    m_j, p_j = clip_j.load_clip_textvec(
        load_safetensors(str(dirs["textvec"] / "text_encoder")), cfg_j, 16)
    ids = np.random.default_rng(9).integers(0, 128, (3, 16))
    got = encoders.encode_ids(tower, ids)
    assert got.shape == (3, 16) and got.dtype == np.float32
    _close(got, m_j.apply(p_j, jnp.asarray(ids)))


# ---- the pipelines ----

@pytest.mark.parametrize("kind", ["clip", "t5", "textvec"])
def test_encode_fns_match_jax(dirs, kind):
    texts = [PROMPT, "", "a corgi, side view", "a red corgi, back view"]
    root = str(dirs[kind])
    if kind == "textvec":
        got = encoders.build_clip_textvec_fn(root, device="cpu")(texts)
        want = enc_j.build_clip_textvec_fn(root)(texts)
    else:
        got = encoders.build_encode_fn(root, device="cpu")(texts)
        want = enc_j.build_encode_fn(root)(texts)
        assert encoders.encoder_kind(root) == kind
    assert got.shape == np.asarray(want).shape and got.dtype == np.float32
    _close(got, want, kind)
    if kind == "t5":
        # padded positions are zero (ids through the same tokenizer)
        _, mask = encoders.tokenizer(root, 77)(texts)
        assert not got[~mask].any() and got[mask].any()


def test_tokenizer_without_transformers(dirs, monkeypatch):
    """With transformers and tokenizers blocked, build_clip_encode_fn,
    build_t5_encode_fn, build_clip_textvec_fn and bert_fill_mask on the
    test directories give the JAX functions' outputs (which tokenize
    through AutoTokenizer)."""
    texts = [PROMPT, "", "a corgi, side view", "a red corgi, back view"]
    fns = {"clip": "build_clip_encode_fn", "t5": "build_t5_encode_fn",
           "textvec": "build_clip_textvec_fn"}
    want = {k: getattr(enc_j, f)(str(dirs[k]))(texts)
            for k, f in fns.items()}
    want_bert = _jax_view_probs(str(dirs["bert"]), texts)
    for name in ("transformers", "tokenizers"):
        monkeypatch.setitem(sys.modules, name, None)
    for k, f in fns.items():
        got = getattr(encoders, f)(str(dirs[k]), device="cpu")(texts)
        assert got.shape == np.asarray(want[k]).shape, k
        _close(got, want[k], k)
    _close(debias.bert_fill_mask(str(dirs["bert"]), device="cpu")(texts),
           want_bert)


# ---- debiasing ----

def _probe(texts):
    """A deterministic fill-mask stand-in: [N, 4] from each text's md5."""
    import hashlib
    out = []
    for s in texts:
        h = hashlib.md5(s.encode()).digest()
        p = np.array([1 + h[i] for i in range(4)], np.float32)
        out.append(p / p.sum())
    return np.stack(out)


def test_debias_injected_probe_and_processor():
    prompt = "a photo of a red corgi sitting"
    for mask_ids in (None, [1, 4]):
        got = debias.get_debiased_prompt(prompt, "", mask_ids=mask_ids,
                                         fill_mask=_probe)
        want = debias_j.get_debiased_prompt(prompt, "", mask_ids=mask_ids,
                                            fill_mask=_probe)
        assert got == want
    assert any(p != prompt for p in got)
    cfg = dict(prompt=prompt, use_prompt_debiasing=True, use_cache=False)
    e_t = processors.PromptProcessor(processors.PromptProcessorConfig(**cfg),
                                     device="cpu", fill_mask=_probe)()
    e_j = proc_j.PromptProcessor(proc_j.PromptProcessorConfig(**cfg),
                                 fill_mask=_probe)()
    for f in e_j._fields:
        np.testing.assert_array_equal(getattr(e_t, f).numpy(),
                                      np.asarray(getattr(e_j, f)), f)


def _jax_view_probs(root, texts):
    """The JAX BERT pipeline's view probabilities of ``texts`` in PROBE."""
    tok, apply = debias_j._build_pipeline(root)
    view_ids = tok(" ".join(debias_j.VIEWS),
                   return_tensors="np").input_ids[0][1:5]
    batch = tok([debias.PROBE.format(s) for s in texts],
                padding="max_length", truncation=True, max_length=16,
                return_tensors="np")
    logits = np.asarray(apply(jnp.asarray(batch["input_ids"]),
                              jnp.asarray(batch["attention_mask"] > 0)))
    pos = np.argmax(batch["input_ids"] == tok.mask_token_id, axis=1)
    want = []
    for i, p in enumerate(pos):
        e = np.exp(logits[i, p] - logits[i, p].max())
        q = (e / e.sum())[view_ids]
        want.append(q / q.sum())
    return np.stack(want)


def test_debias_bert_directory_matches_jax(dirs):
    """The BERT probe built from a model directory: its view
    probabilities against the JAX pipeline's, and the same prompts."""
    root = str(dirs["bert"])
    texts = [PROMPT, "a corgi", "red corgi"]
    fill = debias.bert_fill_mask(root, device="cpu")
    got = fill(texts)
    _close(got, _jax_view_probs(root, texts))
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-6)
    assert (debias.get_debiased_prompt(PROMPT, root, device="cpu")
            == debias_j.get_debiased_prompt(PROMPT, root))


# ---- through build_trainer ----

def test_model_ids_through_build_trainer(dirs, tmp_path):
    """prompt.model_id (a CLIP directory) gives the JAX processor's
    embeddings; auxiliary.clip_model_id the JAX text vector as the Point-E
    aux's conditioning; a debiasing model id builds the BERT probe."""
    base = ROOT / "configs" / "base.yaml"
    over = SMALL + ["guidance.type=sds", f"prompt.model_id={dirs['clip']}",
                    f"prompt.prompt={PROMPT}"]
    tr = build_trainer(load_config(base, over), device="cpu")
    e_j = config_j._build_prompt_processor(
        config_j.load_config(base, over)["prompt"])()
    e_t = tr.prompt_processor()
    for f in e_j._fields:
        _close(getattr(e_t, f).numpy(), getattr(e_j, f), f)
    assert e_t.text.shape == (16, 32)

    over = SMALL + ["guidance.type=mock", "auxiliary.base_name=tiny",
                    "auxiliary.num_points=32", "auxiliary.batch_size=2",
                    f"auxiliary.clip_model_id={dirs['textvec']}"]
    tr = build_trainer(load_config(ROOT / "configs" / "corgi.yaml", over),
                       device="cpu")
    prompt = load_config(ROOT / "configs" / "corgi.yaml")["prompt"]["prompt"]
    want = enc_j.build_clip_textvec_fn(str(dirs["textvec"]))([prompt])[0]
    _close(tr.aux_guidance.cond_vec.numpy(), want)
    m = tr.train_step(0)
    assert np.isfinite(float(m["loss_aux"]))

    over = SMALL + ["guidance.type=sds", "prompt.use_prompt_debiasing=true",
                    f"prompt.debiasing_model_id={dirs['bert']}",
                    f"prompt.prompt={PROMPT}"]
    tr = build_trainer(load_config(base, over), device="cpu")
    e_j = config_j._build_prompt_processor(
        config_j.load_config(base, over)["prompt"])()
    e_t = tr.prompt_processor()
    for f in e_j._fields:
        np.testing.assert_array_equal(getattr(e_t, f).numpy(),
                                      np.asarray(getattr(e_j, f)), f)
