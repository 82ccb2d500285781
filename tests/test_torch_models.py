"""The port's embedding models (picovdb_tpu_torch/models/) against
picovdb_tpu's on the CPU, at small sizes.

The tiny BERT of tests/test_models.py (vocab 97, hidden 32, 2 layers, 4
heads, FFN 64, 48 positions) runs in both packages on the same params and
the same numpy-seeded tokens, with padding masks of lengths 48 / 31 / 17
/ 9 / 1. Tolerances: float32 forwards within atol 2e-5 (summation order
only); bf16 forwards at a minimum cosine of 0.999 (bf16 keeps 8 bits of
mantissa, and the two packages round at the same points but multiply in
different orders); the port against `transformers.BertModel` at the JAX
test's rtol 2e-4 / atol 2e-5. Initializations, converters and tokenizers
are equal bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

from picovdb_tpu.models import bert_encoder as jax_bert
from picovdb_tpu.models.hashing import HashingEmbedder as JaxHashing
from picovdb_tpu_torch.models import (
    BertConfig,
    BertMeanPoolEncoder,
    ByteMeanPoolEncoder,
    HashingEmbedder,
    WordVocabTokenizer,
    convert_hf_state_dict,
    init_params,
    params_from_jax,
)
from torch_port_setup import cap_torch_threads

cap_torch_threads()

TINY = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_position=48)
F32_ATOL = 2e-5
BF16_MIN_COS = 0.999
HF_RTOL, HF_ATOL = 2e-4, 2e-5
TEXTS = [
    "the glacier retreated three meters this year",
    "snow depth at the tree line doubled overnight",
    "the espresso machine needs a coarser grind at altitude",
    "shipping manifest: two anemometers and a radiosonde",
    "",
]


def _tokens():
    rng = np.random.default_rng(3)
    B, T = 5, 48
    tokens = rng.integers(0, 97, size=(B, T)).astype(np.int32)
    mask = np.zeros((B, T), dtype=np.int32)
    for i, ln in enumerate([48, 31, 17, 9, 1]):
        mask[i, :ln] = 1
    return tokens, mask


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def test_hashing_embedder_bit_for_bit():
    for dim, ngrams in ((384, 2), (64, 3), (16, 1)):
        got = HashingEmbedder(dim=dim, ngrams=ngrams).embed(TEXTS)
        want = JaxHashing(dim=dim, ngrams=ngrams).embed(TEXTS)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    # the empty text maps to e0 in both
    assert HashingEmbedder(dim=16).embed_one("")[0] == 1.0


@pytest.mark.parametrize("seed", [0, 7])
def test_init_params_bit_for_bit(seed):
    jp = jax_bert.init_params(jax_bert.BertConfig(**TINY), seed)
    tp = init_params(BertConfig(**TINY), seed)
    assert (jax.tree_util.tree_structure(jp)
            == jax.tree_util.tree_structure(tp))
    for a, b in zip(_leaves(jp), _leaves(tp)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_bert_forward_matches_jax(compute_dtype):
    params = init_params(BertConfig(**TINY), seed=5)
    tokens, mask = _tokens()
    jenc = jax_bert.BertMeanPoolEncoder(
        jax_bert.init_params(jax_bert.BertConfig(**TINY), 5),
        jax_bert.BertConfig(**TINY), compute_dtype=compute_dtype)
    tenc = BertMeanPoolEncoder(params, BertConfig(**TINY),
                               compute_dtype=compute_dtype, device="cpu")
    want = np.asarray(jenc.embed_tokens_device(tokens, mask))
    got = tenc.embed_tokens_device(tokens, mask)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    got = got.numpy()
    if compute_dtype is None:
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)
    else:
        cos = (got * want).sum(1) / (np.linalg.norm(got, axis=1)
                                     * np.linalg.norm(want, axis=1))
        assert cos.min() >= BF16_MIN_COS, cos
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_bert_device_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BertMeanPoolEncoder.random_init(BertConfig(**TINY))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ByteMeanPoolEncoder(dim=32, depth=1, heads=4, max_len=16)


def _tiny_hf():
    transformers = pytest.importorskip("transformers")
    cfg = transformers.BertConfig(
        vocab_size=97, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=48, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    return transformers.BertModel(cfg).eval()


def _hf_reference(model, tokens, mask):
    with torch.no_grad():
        hidden = model(input_ids=torch.tensor(tokens, dtype=torch.long),
                       attention_mask=torch.tensor(mask, dtype=torch.long)
                       ).last_hidden_state.numpy()
    m = mask[:, :, None].astype(np.float32)
    ref = (hidden * m).sum(1) / np.maximum(m.sum(1), 1e-9)
    return ref / np.maximum(np.linalg.norm(ref, axis=1, keepdims=True), 1e-12)


def test_bert_matches_transformers_forward():
    model = _tiny_hf()
    tokens, mask = _tokens()
    enc = BertMeanPoolEncoder.from_hf_torch(model, compute_dtype=None,
                                            device="cpu")
    assert enc.config == BertConfig(**TINY)
    got = enc.embed_tokens_device(tokens, mask).numpy()
    np.testing.assert_allclose(got, _hf_reference(model, tokens, mask),
                               rtol=HF_RTOL, atol=HF_ATOL)


def test_convert_hf_state_dict_matches_jax():
    model = _tiny_hf()
    sd = model.state_dict()
    got = convert_hf_state_dict(sd, BertConfig(**TINY))
    want = jax_bert.convert_hf_state_dict(sd, jax_bert.BertConfig(**TINY))
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for a, b in zip(_leaves(got), _leaves(want)):
        np.testing.assert_array_equal(a, b)
    # a "bert."-prefixed checkpoint (sentence-transformers) converts alike
    pre = convert_hf_state_dict({"bert." + k: v for k, v in sd.items()},
                                BertConfig(**TINY))
    for a, b in zip(_leaves(pre), _leaves(got)):
        np.testing.assert_array_equal(a, b)


def test_params_from_jax_round_trips():
    cfg = BertConfig(**TINY)
    jp = jax_bert.init_params(jax_bert.BertConfig(**TINY), 11)
    sd = params_from_jax(jp)  # JAX arrays in, the module's state dict out
    enc = BertMeanPoolEncoder(jp, cfg, device="cpu")
    assert set(sd) == set(enc.state_dict())
    for key, value in enc.state_dict().items():
        assert torch.equal(value, sd[key]), key
    # back through the converter: the same arrays bit for bit
    for a, b in zip(_leaves(convert_hf_state_dict(sd, cfg)), _leaves(jp)):
        np.testing.assert_array_equal(a, b)
    # and the module's state dict is a BertModel's (the pooler aside)
    model = _tiny_hf()
    missing, unexpected = model.load_state_dict(sd, strict=False)
    assert not unexpected and all(k.startswith("pooler.") for k in missing)
    tokens, mask = _tokens()
    np.testing.assert_allclose(
        BertMeanPoolEncoder(jp, cfg, compute_dtype=None, device="cpu")
        .embed_tokens_device(tokens, mask).numpy(),
        _hf_reference(model, tokens, mask), rtol=HF_RTOL, atol=HF_ATOL)


def test_word_vocab_tokenizer_matches_jax():
    corpus = TEXTS[:4] + ["the cat's dinner, at 3 o'clock!", "a b c a b a"]
    for vocab in (64, 12):
        tok = WordVocabTokenizer(vocab_size=vocab).fit(corpus)
        jtok = jax_bert.WordVocabTokenizer(vocab_size=vocab).fit(corpus)
        assert tok.vocab == jtok.vocab
        probe = corpus + ["unseen zebra words", ""]
        for max_length in (8, 48):
            got, want = tok(probe, max_length=max_length), jtok(
                probe, max_length=max_length)
            for key in ("input_ids", "attention_mask"):
                assert got[key].dtype == want[key].dtype
                np.testing.assert_array_equal(got[key], want[key])


def test_random_init_embeds_like_jax():
    corpus = [f"document number {i} about topic {i % 3}" for i in range(12)]
    cfg = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
               intermediate_size=64, max_position=32)
    tenc = BertMeanPoolEncoder.random_init(
        BertConfig(**cfg), seed=7, corpus_texts=corpus, max_len=16,
        compute_dtype=None, device="cpu")
    jenc = jax_bert.BertMeanPoolEncoder.random_init(
        jax_bert.BertConfig(**cfg), seed=7, corpus_texts=corpus, max_len=16,
        compute_dtype=None)
    got = tenc.embed_device(corpus)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), jenc.embed(corpus), rtol=0,
                               atol=F32_ATOL)
    np.testing.assert_array_equal(tenc.encode(corpus), got.numpy())


def test_from_pretrained_reads_save_pretrained(tmp_path):
    transformers = pytest.importorskip("transformers")
    model = _tiny_hf()
    model.save_pretrained(tmp_path)
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [
        w for w in sorted(set(" ".join(TEXTS).replace(":", " ").split()))]
    (tmp_path / "vocab.txt").write_text("\n".join(vocab) + "\n")
    transformers.BertTokenizer(str(tmp_path / "vocab.txt")).save_pretrained(
        tmp_path)
    enc = BertMeanPoolEncoder.from_pretrained(str(tmp_path), max_len=16,
                                              compute_dtype=None,
                                              device="cpu")
    jenc = jax_bert.BertMeanPoolEncoder.from_pretrained(
        str(tmp_path), max_len=16, compute_dtype=None)
    tokens, mask = enc.tokenize(TEXTS)
    np.testing.assert_array_equal((tokens, mask), jenc.tokenize(TEXTS))
    got = enc.embed(TEXTS)
    np.testing.assert_allclose(got, _hf_reference(model, tokens, mask),
                               rtol=HF_RTOL, atol=HF_ATOL)
    np.testing.assert_allclose(got, jenc.embed(TEXTS), rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("dim,depth,heads,max_len", [(32, 2, 4, 48),
                                                     (96, 1, 6, 64)])
def test_byte_encoder_matches_flax(dim, depth, heads, max_len):
    """bf16 forwards: a minimum cosine of BF16_MIN_COS and max |d| 1e-2
    (bf16's 8-bit mantissa over a few layers)."""
    pytest.importorskip("flax")
    from picovdb_tpu.models.flax_encoder import FlaxMeanPoolEncoder

    fenc = FlaxMeanPoolEncoder(dim=dim, depth=depth, heads=heads,
                               max_len=max_len, seed=3)
    params = jax.tree_util.tree_map(np.asarray, fenc.params)
    enc = ByteMeanPoolEncoder.from_flax_params(params, device="cpu")
    assert (enc.dim, len(enc.blocks), enc.heads, enc.max_len) == (
        dim, depth, heads, max_len)
    texts = TEXTS + ["é, ü and a very long line " * 8]
    for a, b in zip(enc.tokenize(texts), fenc.tokenize(texts)):
        np.testing.assert_array_equal(a, b)
    got, want = enc.embed(texts), fenc.embed(texts)
    assert np.abs(got - want).max() <= 1e-2
    assert ((got * want).sum(1)).min() >= BF16_MIN_COS
    # load_params on an encoder of the same shape serves the same model
    other = ByteMeanPoolEncoder(dim=dim, depth=depth, heads=heads,
                                max_len=max_len, seed=9, device="cpu")
    assert not np.array_equal(other.embed(texts), got)
    other.load_params(params)
    np.testing.assert_array_equal(other.embed(texts), got)


def test_byte_encoder_default_init_is_seeded():
    kw = dict(dim=32, depth=2, heads=4, max_len=32, device="cpu")
    a = ByteMeanPoolEncoder(seed=1, **kw).embed(TEXTS)
    np.testing.assert_array_equal(a, ByteMeanPoolEncoder(seed=1, **kw)
                                  .embed(TEXTS))
    assert not np.array_equal(a, ByteMeanPoolEncoder(seed=2, **kw)
                              .embed(TEXTS))
    np.testing.assert_allclose(np.linalg.norm(a, axis=1), 1.0, atol=1e-5)


def test_sentence_transformers_bridge_is_gated(monkeypatch):
    from picovdb_tpu_torch.models import torch_st

    monkeypatch.setattr(torch_st, "HAS_SENTENCE_TRANSFORMERS", False)
    with pytest.raises(ImportError, match="sentence-transformers"):
        torch_st.TorchSentenceEmbedder()
