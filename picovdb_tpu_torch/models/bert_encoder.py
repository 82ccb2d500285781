"""BERT-family sentence encoder on the store's device + HuggingFace weight converter.

Counterpart of picovdb_tpu.models.bert_encoder. The same architecture —
BERT encoder, masked mean pooling, L2 normalization (the all-MiniLM-*
sentence-transformers recipe) — runs as a torch module on the store's
device, so corpus and query embeddings are born on the card and feed
`PicoVectorDB.ingest_device` / `query_columnar` with no host round trip.

The forward mirrors picovdb_tpu's `bert_encode` cast for cast: LayerNorm
in float32, dense layers in `compute_dtype` (bf16 by default), attention
scores accumulated in float32 with the additive -1e9 padding bias, the
softmax's probabilities cast back to `compute_dtype`, exact (erf) GELU,
masked mean pooling and the L2 normalization in float32. The products are
written out (no `scaled_dot_product_attention`), so the cast points stay
where the JAX package has them.

Parameters travel in picovdb_tpu's pytree layout (dense kernels (in, out),
numpy arrays): `init_params` draws them in the JAX package's order from
the same numpy generator, so `random_init(seed=s)` is the same model in
both packages; `convert_hf_state_dict` maps a HuggingFace `BertModel`
state dict onto that layout, and `params_from_jax` maps the layout onto
the module's own state dict, whose keys are `BertModel`'s (minus the
pooler). `transformers` is imported only by `from_pretrained`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..ops.exact import default_device


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 384          # MiniLM-L6
    num_layers: int = 6
    num_heads: int = 12
    intermediate_size: int = 1536
    max_position: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12

    @classmethod
    def from_hf(cls, hf_config) -> "BertConfig":
        return cls(
            vocab_size=hf_config.vocab_size,
            hidden_size=hf_config.hidden_size,
            num_layers=hf_config.num_hidden_layers,
            num_heads=hf_config.num_attention_heads,
            intermediate_size=hf_config.intermediate_size,
            max_position=hf_config.max_position_embeddings,
            type_vocab_size=hf_config.type_vocab_size,
            layer_norm_eps=hf_config.layer_norm_eps,
        )


def _layer_keys(i: int) -> dict:
    """picovdb_tpu's per-layer parameter names -> `BertModel`'s prefixes."""
    p = f"encoder.layer.{i}"
    return {
        "q": f"{p}.attention.self.query",
        "k": f"{p}.attention.self.key",
        "v": f"{p}.attention.self.value",
        "attn_out": f"{p}.attention.output.dense",
        "attn_ln": f"{p}.attention.output.LayerNorm",
        "ffn_in": f"{p}.intermediate.dense",
        "ffn_out": f"{p}.output.dense",
        "ffn_ln": f"{p}.output.LayerNorm",
    }


_EMBED_KEYS = {
    "word": "embeddings.word_embeddings.weight",
    "position": "embeddings.position_embeddings.weight",
    "type": "embeddings.token_type_embeddings.weight",
}


def convert_hf_state_dict(state_dict, config: BertConfig) -> dict:
    """HF `BertModel` torch state_dict -> picovdb_tpu's parameter pytree
    (numpy float32 arrays).

    Torch `nn.Linear` stores (out, in); the pytree keeps (in, out), so all
    dense kernels are transposed. Accepts tensors or numpy arrays; strips
    an optional "bert." prefix (sentence-transformers checkpoints).
    """
    sd = {}
    for key, value in state_dict.items():
        name = key[5:] if key.startswith("bert.") else key
        sd[name] = np.asarray(
            value.detach().cpu().numpy() if hasattr(value, "detach") else value,
            dtype=np.float32,
        )

    def dense(prefix):
        return {"kernel": np.ascontiguousarray(sd[prefix + ".weight"].T),
                "bias": sd[prefix + ".bias"]}

    def ln(prefix):
        return {"scale": sd[prefix + ".weight"], "bias": sd[prefix + ".bias"]}

    layers = []
    for i in range(config.num_layers):
        keys = _layer_keys(i)
        layers.append({name: (ln if name.endswith("_ln") else dense)(prefix)
                       for name, prefix in keys.items()})
    return {
        "embeddings": {
            **{name: sd[key] for name, key in _EMBED_KEYS.items()},
            "ln": ln("embeddings.LayerNorm"),
        },
        "layers": layers,
    }


def params_from_jax(params) -> dict:
    """picovdb_tpu's parameter pytree (from its `init_params` or
    `convert_hf_state_dict`, or a live encoder's `.params`: numpy or JAX
    arrays) -> this module's state dict of float32 tensors, keyed as HF's
    `BertModel`. Dense kernels (in, out) become `nn.Linear` weights (out,
    in); `convert_hf_state_dict` is the inverse."""

    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32))

    emb = params["embeddings"]
    out = {key: t(emb[name]) for name, key in _EMBED_KEYS.items()}
    out["embeddings.LayerNorm.weight"] = t(emb["ln"]["scale"])
    out["embeddings.LayerNorm.bias"] = t(emb["ln"]["bias"])
    for i, lp in enumerate(params["layers"]):
        for name, prefix in _layer_keys(i).items():
            p = lp[name]
            if name.endswith("_ln"):
                out[prefix + ".weight"] = t(p["scale"])
            else:
                out[prefix + ".weight"] = t(p["kernel"]).T.contiguous()
            out[prefix + ".bias"] = t(p["bias"])
    return out


class WordVocabTokenizer:
    """Offline word-level tokenizer with a corpus-built vocabulary.

    Call-compatible with a HuggingFace tokenizer invoked with
    `return_tensors="np"` (returns "input_ids"/"attention_mask"), so it
    plugs into `BertMeanPoolEncoder` unchanged. Exists for environments
    with no downloadable vocab files: `fit` builds the vocabulary from the
    corpus itself (most-frequent words first), with [PAD]/[UNK]/[CLS]/[SEP]
    specials at fixed ids. A copy of picovdb_tpu's: the same corpus gives
    the same vocabulary and ids.
    """

    PAD, UNK, CLS, SEP = 0, 1, 2, 3

    def __init__(self, vocab_size: int = 30522, lowercase: bool = True):
        self.vocab_size = int(vocab_size)
        self.lowercase = lowercase
        self.vocab: dict = {}

    @staticmethod
    def _words(text: str, lowercase: bool) -> List[str]:
        import re

        if lowercase:
            text = text.lower()
        return re.findall(r"[a-z0-9]+|[^\sa-z0-9]", text)

    def fit(self, texts: List[str]) -> "WordVocabTokenizer":
        from collections import Counter

        counts: Counter = Counter()
        for t in texts:
            counts.update(self._words(t, self.lowercase))
        self.vocab = {
            w: i + 4
            for i, (w, _) in enumerate(
                counts.most_common(self.vocab_size - 4)
            )
        }
        return self

    def __call__(
        self,
        texts: List[str],
        padding: str = "max_length",
        truncation: bool = True,
        max_length: int = 256,
        return_tensors: str = "np",
    ) -> dict:
        if not self.vocab:
            raise RuntimeError("call fit(corpus_texts) first")
        ids = np.full((len(texts), max_length), self.PAD, dtype=np.int32)
        mask = np.zeros((len(texts), max_length), dtype=np.int32)
        for r, t in enumerate(texts):
            toks = [self.CLS] + [
                self.vocab.get(w, self.UNK)
                for w in self._words(t, self.lowercase)
            ][: max_length - 2] + [self.SEP]
            ids[r, : len(toks)] = toks
            mask[r, : len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def init_params(config: BertConfig, seed: int = 0) -> dict:
    """Deterministic BERT-style parameter init (N(0, 0.02), LN at identity),
    in picovdb_tpu's pytree layout.

    The draws come from `np.random.default_rng(seed)` in the JAX package's
    order (each layer's q, k, v, attn_out, ffn_in, ffn_out, then the word,
    position and type embeddings), so both packages build the same arrays
    bit for bit. Reproducible across processes — enough for
    self-retrieval benchmarks and pipeline validation, not for semantic
    quality (use convert_hf_state_dict with real weights for that).
    """
    rng = np.random.default_rng(seed)
    std = 0.02

    def dense(n_in, n_out):
        return {
            "kernel": rng.normal(0, std, (n_in, n_out)).astype(np.float32),
            "bias": np.zeros((n_out,), dtype=np.float32),
        }

    def ln(n):
        return {"scale": np.ones((n,), dtype=np.float32),
                "bias": np.zeros((n,), dtype=np.float32)}

    h, ffn = config.hidden_size, config.intermediate_size
    layers = []
    for _ in range(config.num_layers):
        layers.append(
            {
                "q": dense(h, h),
                "k": dense(h, h),
                "v": dense(h, h),
                "attn_out": dense(h, h),
                "attn_ln": ln(h),
                "ffn_in": dense(h, ffn),
                "ffn_out": dense(ffn, h),
                "ffn_ln": ln(h),
            }
        )
    return {
        "embeddings": {
            "word": rng.normal(0, std, (config.vocab_size, h)).astype(
                np.float32),
            "position": rng.normal(0, std, (config.max_position, h)).astype(
                np.float32),
            "type": rng.normal(0, std, (config.type_vocab_size, h)).astype(
                np.float32),
            "ln": ln(h),
        },
        "layers": layers,
    }


def resolve_device(device) -> torch.device:
    """The device an encoder (or the RAG tool's store) lives on: the card
    (cuda:0) when none is named, raising without one as the store does;
    "cuda" names the current card by its index, so that tensors made there
    compare equal to the store's device."""
    if device is None:
        return default_device()
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _node(**children) -> nn.Module:
    """A container module whose children carry `BertModel`'s names."""
    m = nn.Module()
    for name, child in children.items():
        m.add_module(name, child)
    return m


def _layer_norm(x, ln: nn.LayerNorm):
    """LayerNorm in float32 whatever the compute dtype (as the JAX
    package's `_layer_norm`); the caller casts back."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps)


def _dense(x, lin: nn.Linear):
    """x @ kernel + bias in x's dtype: the product, then the bias add (the
    JAX package's `_dense`, two roundings under bf16)."""
    return x @ lin.weight.to(x.dtype).T + lin.bias.to(x.dtype)


class BertMeanPoolEncoder(nn.Module):
    """BERT sentence encoder over picovdb_tpu-layout (or converted HF)
    weights, on one torch device.

    `tokenizer` is any callable mapping a list of strings to a dict with
    "input_ids" and "attention_mask" numpy arrays (a HuggingFace tokenizer
    called with return_tensors="np" qualifies). `device` defaults to the
    card (cuda:0) and raises where there is none, as the store does; pass
    device="cpu" to run on the host.
    """

    def __init__(
        self,
        params: dict,
        config: BertConfig,
        tokenizer=None,
        max_len: int = 256,
        compute_dtype: Optional[str] = "bfloat16",
        device=None,
    ) -> None:
        super().__init__()
        self.config = config
        self.tokenizer = tokenizer
        self.max_len = max_len
        self.dim = config.hidden_size
        self.compute_dtype = (getattr(torch, compute_dtype) if compute_dtype
                              else None)
        self.device = resolve_device(device)
        h, ffn, eps = (config.hidden_size, config.intermediate_size,
                       config.layer_norm_eps)
        self.embeddings = _node(
            word_embeddings=nn.Embedding(config.vocab_size, h),
            position_embeddings=nn.Embedding(config.max_position, h),
            token_type_embeddings=nn.Embedding(config.type_vocab_size, h),
            LayerNorm=nn.LayerNorm(h, eps=eps),
        )
        self.encoder = _node(layer=nn.ModuleList([
            _node(
                attention=_node(
                    self=_node(query=nn.Linear(h, h), key=nn.Linear(h, h),
                               value=nn.Linear(h, h)),
                    output=_node(dense=nn.Linear(h, h),
                                 LayerNorm=nn.LayerNorm(h, eps=eps)),
                ),
                intermediate=_node(dense=nn.Linear(h, ffn)),
                output=_node(dense=nn.Linear(ffn, h),
                             LayerNorm=nn.LayerNorm(h, eps=eps)),
            )
            for _ in range(config.num_layers)
        ]))
        self.load_state_dict(params_from_jax(params))
        self.requires_grad_(False)
        self.to(self.device)

    # -- construction -----------------------------------------------------

    @classmethod
    def from_hf_torch(cls, torch_model, tokenizer=None, **kw):
        """Convert a live `transformers.BertModel` (weights stay local)."""
        config = BertConfig.from_hf(torch_model.config)
        params = convert_hf_state_dict(torch_model.state_dict(), config)
        return cls(params, config, tokenizer, **kw)

    @classmethod
    def random_init(
        cls,
        config: Optional[BertConfig] = None,
        seed: int = 0,
        corpus_texts: Optional[List[str]] = None,
        **kw,
    ):
        """Deterministic random-weight encoder with a corpus-built vocab:
        the same model as picovdb_tpu's `random_init` with these arguments
        (`init_params`), with a `WordVocabTokenizer` fitted to
        `corpus_texts` when given."""
        config = config or BertConfig()
        tok = None
        if corpus_texts is not None:
            tok = WordVocabTokenizer(vocab_size=config.vocab_size).fit(
                corpus_texts
            )
        return cls(init_params(config, seed), config, tokenizer=tok, **kw)

    @classmethod
    def from_pretrained(cls, path: str, **kw):
        """Load a local HF checkpoint directory (no network access): point
        at a downloaded copy of e.g. sentence-transformers/all-MiniLM-L6-v2
        and the converted weights serve its embeddings from the card."""
        from transformers import AutoModel, AutoTokenizer

        model = AutoModel.from_pretrained(path, local_files_only=True)
        tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
        enc = cls.from_hf_torch(model, tokenizer=tok, **kw)
        del model
        return enc

    # -- the forward ---------------------------------------------------------

    def forward(self, tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """(B, T) token ids and attention mask -> (B, hidden) unit-norm
        float32 embeddings (see the module docstring for the casts)."""
        cfg = self.config
        B, T = tokens.shape
        h = cfg.num_heads
        head_dim = cfg.hidden_size // h
        emb = self.embeddings
        x = (emb.word_embeddings.weight[tokens]
             + emb.position_embeddings.weight[None, :T, :]
             + emb.token_type_embeddings.weight[None, None, 0, :])
        x = _layer_norm(x, emb.LayerNorm)
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        # additive attention bias: padded keys get -inf-ish
        bias = (1.0 - mask.float())[:, None, None, :] * -1e9
        scale = 1.0 / np.sqrt(head_dim)
        for lp in self.encoder.layer:
            sa = lp.attention.self
            q = _dense(x, sa.query).view(B, T, h, head_dim)
            k = _dense(x, sa.key).view(B, T, h, head_dim)
            v = _dense(x, sa.value).view(B, T, h, head_dim)
            # the products of two compute-dtype values are exact in
            # float32: upcasting, then a float32 product, accumulates them
            # as preferred_element_type=float32 does
            scores = torch.einsum("bthd,bshd->bhts", q.float(),
                                  k.float()) * scale + bias
            probs = torch.softmax(scores, dim=-1).to(x.dtype)
            ctx = torch.einsum("bhts,bshd->bthd", probs, v).reshape(
                B, T, cfg.hidden_size)
            att = lp.attention.output
            x = _layer_norm(x + _dense(ctx, att.dense),
                            att.LayerNorm).to(x.dtype)
            ff = F.gelu(_dense(x, lp.intermediate.dense))  # exact (erf)
            x = _layer_norm(x + _dense(ff, lp.output.dense),
                            lp.output.LayerNorm).to(x.dtype)
        # sentence-transformers mean pooling + normalization (MiniLM head)
        m = mask.float()[:, :, None]
        pooled = (x.float() * m).sum(1) / m.sum(1).clamp_min(1e-9)
        norm = torch.linalg.vector_norm(pooled, dim=1, keepdim=True)
        return pooled / norm.clamp_min(1e-12)

    # -- encoding ----------------------------------------------------------

    def tokenize(self, texts: List[str]):
        if self.tokenizer is None:
            raise RuntimeError(
                "no tokenizer attached; construct via from_pretrained() or "
                "pass tokenizer= explicitly"
            )
        out = self.tokenizer(
            list(texts),
            padding="max_length",
            truncation=True,
            max_length=self.max_len,
            return_tensors="np",
        )
        return (
            out["input_ids"].astype(np.int32),
            out["attention_mask"].astype(np.int32),
        )

    def embed_tokens_device(self, tokens, mask) -> torch.Tensor:
        """Embeddings of (B, T) token ids and mask (numpy or tensors) as a
        float32 tensor on the encoder's device."""
        tokens = torch.as_tensor(tokens).to(self.device, torch.long)
        mask = torch.as_tensor(mask).to(self.device)
        with torch.no_grad():  # not inference_mode: the store may write
            return self(tokens, mask)  # into a tensor it adopts

    def embed_device(self, texts: List[str]) -> torch.Tensor:
        """Unit-norm embeddings on the encoder's device (feed
        ingest_device / query_columnar)."""
        tokens, mask = self.tokenize(texts)
        return self.embed_tokens_device(tokens, mask)

    def embed(self, texts: List[str]) -> np.ndarray:
        return self.embed_device(texts).cpu().numpy()

    encode = embed
