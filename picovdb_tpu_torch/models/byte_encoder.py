"""Small byte-level transformer encoder producing mean-pooled sentence embeddings.

Counterpart of picovdb_tpu.models.flax_encoder.FlaxMeanPoolEncoder: the
same pre-LN architecture (byte vocab 259 with PAD / BOS / EOS, learned
positions, `depth` blocks of multi-head attention and a GELU MLP, a final
LayerNorm, masked mean pooling, L2 normalization), run as a torch module
on the store's device, so `embed_device(...)` feeds
`PicoVectorDB.query_columnar` with no host round trip. Tokenization is
byte-level, so no tokenizer files are needed.

The forward mirrors flax's modules as the JAX encoder configures them:
everything computes in bf16 from float32 parameters; LayerNorm takes its
statistics in float32 (E[x^2] - E[x]^2, eps 1e-6) and returns bf16; the
attention divides the query by sqrt(head_dim) in bf16, masks with a
boolean mask (bf16's most negative value) and runs its softmax in bf16;
`nn.gelu` is the tanh approximation.

Weights are random by default, drawn from a `torch.Generator(seed)`: a
stand-in with realistic compute shapes, not flax's initialization (jax's
PRNG cannot be reproduced without jax), so the same seed gives another
model than the JAX package's. `from_flax_params` / `load_params` take a
flax parameter tree (numpy arrays) and then serve the flax model's
embeddings.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from .bert_encoder import resolve_device

PAD, BOS, EOS = 256, 257, 258
VOCAB = 259
LN_EPS = 1e-6  # flax.linen.LayerNorm's default


def _ln(x, ln: nn.LayerNorm):
    """flax LayerNorm on a bf16 input: float32 statistics by the fast
    variance (clipped at 0), the affine in float32, the result in bf16."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 * x32).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
    y = (x32 - mu) * (torch.rsqrt(var + ln.eps) * ln.weight)
    return (y + ln.bias).to(torch.bfloat16)


def _dense(x, lin: nn.Linear):
    """flax Dense with dtype bf16: kernel and bias cast, product, bias add."""
    return x @ lin.weight.to(x.dtype).T + lin.bias.to(x.dtype)


class ByteMeanPoolEncoder(nn.Module):
    def __init__(
        self,
        dim: int = 384,
        depth: int = 4,
        heads: int = 6,
        max_len: int = 256,
        seed: int = 0,
        device=None,
    ) -> None:
        super().__init__()
        self.dim = dim
        self.heads = heads
        self.max_len = max_len
        self.device = resolve_device(device)
        hidden = 4 * dim
        self.tok_embed = nn.Embedding(VOCAB, dim)
        self.pos_embed = nn.Embedding(max_len, dim)
        self.blocks = nn.ModuleList()
        for _ in range(depth):
            block = nn.Module()
            for name, mod in (
                ("ln_attn", nn.LayerNorm(dim, eps=LN_EPS)),
                ("query", nn.Linear(dim, dim)), ("key", nn.Linear(dim, dim)),
                ("value", nn.Linear(dim, dim)), ("out", nn.Linear(dim, dim)),
                ("ln_mlp", nn.LayerNorm(dim, eps=LN_EPS)),
                ("fc_in", nn.Linear(dim, hidden)),
                ("fc_out", nn.Linear(hidden, dim)),
            ):
                block.add_module(name, mod)
            self.blocks.append(block)
        self.ln_final = nn.LayerNorm(dim, eps=LN_EPS)
        self._init_weights(seed)
        self.requires_grad_(False)
        self.to(self.device)

    def _init_weights(self, seed: int) -> None:
        """Embeddings N(0, 1/dim), dense kernels a normal truncated at two
        standard deviations of variance 1/fan_in (flax's default
        distributions), zero biases, LayerNorms at identity; drawn on the
        host, so every device gets the same weights."""
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for emb in (self.tok_embed, self.pos_embed):
                emb.weight.normal_(0.0, self.dim ** -0.5, generator=g)
            for mod in self.modules():
                if isinstance(mod, nn.Linear):
                    std = mod.in_features ** -0.5 / 0.87962566103423978
                    nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std,
                                          2 * std, generator=g)
                    mod.bias.zero_()

    # -- flax parameters ---------------------------------------------------

    @classmethod
    def from_flax_params(cls, params, device=None) -> "ByteMeanPoolEncoder":
        """An encoder shaped and loaded from a flax parameter tree (the
        JAX encoder's `.params`, as numpy arrays): dim, depth, heads and
        max_len are read off its shapes."""
        p = params.get("params", params)
        dim = p["Embed_0"]["embedding"].shape[1]
        depth = sum(1 for k in p if k.startswith("MultiHeadDotProductAttention_"))
        heads = p["MultiHeadDotProductAttention_0"]["query"]["kernel"].shape[1]
        enc = cls(dim=dim, depth=depth, heads=heads,
                  max_len=p["Embed_1"]["embedding"].shape[0], device=device)
        enc.load_params(params)
        return enc

    def load_params(self, params) -> None:
        """Load a flax parameter tree (numpy arrays) of this shape, as the
        JAX encoder's `load_params` does: DenseGeneral kernels (dim, heads,
        head_dim) / (heads, head_dim, dim) flatten to (in, out), then
        transpose to `nn.Linear`'s (out, in)."""
        p = params.get("params", params)

        def t(x):
            return torch.from_numpy(np.array(x, dtype=np.float32))

        def norm(ln, tree):
            ln.weight.copy_(t(tree["scale"]))
            ln.bias.copy_(t(tree["bias"]))

        with torch.no_grad():
            self.tok_embed.weight.copy_(t(p["Embed_0"]["embedding"]))
            self.pos_embed.weight.copy_(t(p["Embed_1"]["embedding"]))
            for i, block in enumerate(self.blocks):
                att = p[f"MultiHeadDotProductAttention_{i}"]
                norm(block.ln_attn, p[f"LayerNorm_{2 * i}"])
                for name in ("query", "key", "value", "out"):
                    # query / key / value fold their (heads, head_dim)
                    # outputs, out its inputs: (in, out), then transposed
                    kern = t(att[name]["kernel"]).reshape(self.dim, self.dim)
                    getattr(block, name).weight.copy_(kern.T)
                    getattr(block, name).bias.copy_(
                        t(att[name]["bias"]).reshape(-1))
                norm(block.ln_mlp, p[f"LayerNorm_{2 * i + 1}"])
                for j, name in ((2 * i, "fc_in"), (2 * i + 1, "fc_out")):
                    getattr(block, name).weight.copy_(
                        t(p[f"Dense_{j}"]["kernel"]).T)
                    getattr(block, name).bias.copy_(t(p[f"Dense_{j}"]["bias"]))
            norm(self.ln_final, p[f"LayerNorm_{2 * len(self.blocks)}"])

    # -- the forward ---------------------------------------------------------

    def forward(self, tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """(B, T) byte tokens and mask -> (B, dim) unit-norm float32."""
        B, T = tokens.shape
        bf16 = torch.bfloat16
        head_dim = self.dim // self.heads
        x = (self.tok_embed.weight.to(bf16)[tokens]
             + self.pos_embed.weight.to(bf16)[None, :T, :])
        keep = mask.bool()[:, None, None, :]
        neg = torch.finfo(bf16).min
        qscale = torch.tensor(float(np.sqrt(head_dim)), dtype=bf16,
                              device=x.device)
        for blk in self.blocks:
            h = _ln(x, blk.ln_attn)
            q = _dense(h, blk.query).view(B, T, self.heads, head_dim) / qscale
            k = _dense(h, blk.key).view(B, T, self.heads, head_dim)
            v = _dense(h, blk.value).view(B, T, self.heads, head_dim)
            w = torch.einsum("bqhd,bkhd->bhqk", q, k)
            w = torch.softmax(torch.where(keep, w, neg), dim=-1)
            o = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, T, self.dim)
            x = x + _dense(o, blk.out)
            h = _dense(_ln(x, blk.ln_mlp), blk.fc_in)
            x = x + _dense(F.gelu(h, approximate="tanh"), blk.fc_out)
        x = _ln(x, self.ln_final)
        # masked mean pooling -> float32 unit vectors
        m = mask.float()[:, :, None]
        pooled = (x.float() * m).sum(1) / m.sum(1).clamp_min(1.0)
        norm = torch.linalg.vector_norm(pooled, dim=1, keepdim=True)
        return pooled / norm.clamp_min(1e-9)

    # -- encoding ----------------------------------------------------------

    def tokenize(self, texts: List[str]) -> tuple[np.ndarray, np.ndarray]:
        toks = np.full((len(texts), self.max_len), PAD, dtype=np.int32)
        mask = np.zeros((len(texts), self.max_len), dtype=np.int32)
        for i, t in enumerate(texts):
            raw = t.encode("utf-8")[: self.max_len - 2]
            seq = [BOS] + list(raw) + [EOS]
            toks[i, : len(seq)] = seq
            mask[i, : len(seq)] = 1
        return toks, mask

    def embed_device(self, texts: List[str]) -> torch.Tensor:
        """Embeddings as a float32 tensor on the encoder's device (feed
        query_columnar)."""
        toks, mask = self.tokenize(texts)
        with torch.no_grad():
            return self(torch.from_numpy(toks).to(self.device, torch.long),
                        torch.from_numpy(mask).to(self.device))

    def embed(self, texts: List[str]) -> np.ndarray:
        return self.embed_device(texts).cpu().numpy()

    encode = embed
