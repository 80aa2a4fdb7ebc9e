"""CLIP's text tower: token ids -> 512-d embeddings.

Counterpart of `lossyless_tpu/nn/clip_text.py`. The reference featurizes
COCO's captions once, at dataset-build time, with CLIP's text encoder, as
contrastive positives; this module does the same from converted OpenAI
weights (`convert_openai_clip_text_weights`). It takes already-tokenized,
77-padded id rows (CLIP's contract: <start> tokens <end> padding) and
pools each row at its <end> token, the row's largest id.

The arithmetic is JAX's, rounding point for rounding point: the compute
dtype (bf16 by default) for activations and matmuls; q scaled in that
dtype before the dot; the logits fp32, masked causally with -inf; the
softmax fp32, then cast to the compute dtype; every LayerNorm fp32 (eps
1e-5). JAX computes this attention with einsums, outside any kernel, so
it runs here as torch matmuls (not `scaled_dot_product_attention`, whose
rounding points differ).

Parameters keep flax's names (`token_embedding`, `block{i}.attn.qkv`,
`ln_final`, `text_projection`, ...), so a JAX tree carries over through
`layers.params_from_flax`.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core.device import resolve_device
from .layers import LECUN_NORMAL, numpy_state_dict, params_from_flax
from .mlp import _dtype
from .vit import Dense, LayerNorm, quick_gelu


class CausalMHSA(nn.Module):
    def __init__(self, width: int, heads: int, dtype=torch.bfloat16):
        super().__init__()
        self.width, self.heads, self.dtype = width, heads, dtype
        self.qkv = Dense(width, 3 * width, dtype)
        self.proj = Dense(width, width, dtype)

    def forward(self, x):
        B, N, D = x.shape
        h = self.heads

        def split(t):
            return t.reshape(B, N, h, D // h).transpose(1, 2)

        q, k, v = (split(t) for t in self.qkv(x).split(D, dim=-1))
        q = q * (D // h) ** -0.5                      # in the compute dtype
        logits = q.float() @ k.float().transpose(-1, -2)
        causal = torch.ones(N, N, dtype=torch.bool, device=x.device).tril()
        logits = logits.masked_fill(~causal, float("-inf"))
        attn = torch.softmax(logits, dim=-1).to(self.dtype)
        out = (attn @ v).transpose(1, 2).reshape(B, N, D)
        return self.proj(out)


class TextBlock(nn.Module):
    def __init__(self, width: int, heads: int, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.ln_1 = LayerNorm(width)
        self.attn = CausalMHSA(width, heads, dtype)
        self.ln_2 = LayerNorm(width)
        self.mlp_fc = Dense(width, 4 * width, dtype)
        self.mlp_proj = Dense(4 * width, width, dtype)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x).to(self.dtype))
        y = self.mlp_fc(self.ln_2(x).to(self.dtype))
        return x + self.mlp_proj(quick_gelu(y))


class TextTransformer(nn.Module):
    """CLIP text tower: (B, N <= context_length) int token ids ->
    (B, out_dim) fp32 embeddings."""

    def __init__(self, vocab_size: int = 49408, context_length: int = 77,
                 width: int = 512, layers: int = 12, heads: int = 8,
                 out_dim: int = 512, dtype=torch.bfloat16,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = d = _dtype(dtype)
        self.out_dim = out_dim
        g = generator or torch.Generator().manual_seed(0)
        # flax's initializers: N(0, 0.02), N(0, 0.01), N(0, 0.02)
        self.token_embedding = nn.Parameter(
            torch.randn(vocab_size, width, generator=g) * 0.02)
        self.positional_embedding = nn.Parameter(
            torch.randn(context_length, width, generator=g) * 0.01)
        self.n_layers = layers
        for i in range(layers):
            self.add_module(f"block{i}", TextBlock(width, heads, d))
        self.ln_final = LayerNorm(width)
        self.text_projection = nn.Parameter(
            torch.randn(width, out_dim, generator=g) * 0.02)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("kernel"):   # flax Dense's LeCun normal
                    p.copy_(LECUN_NORMAL(tuple(p.shape), g))

    def forward(self, token_ids):
        d = self.dtype
        x = self.token_embedding[token_ids].to(d)
        x = x + self.positional_embedding.to(d)[None, :x.shape[1]]
        for i in range(self.n_layers):
            x = getattr(self, f"block{i}")(x)
        x = self.ln_final(x)
        # pool at the <end> token: the row's largest id, CLIP's convention
        eot = token_ids.argmax(dim=-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        return (pooled.to(d) @ self.text_projection.to(d)).float()


def convert_openai_clip_text_weights(torch_state_dict) -> dict:
    """OpenAI CLIP's text-side weights -> this module's state dict (what
    the JAX package's converter followed by `params_from_flax` returns)."""
    sd = numpy_state_dict(torch_state_dict)

    def ln(prefix):
        return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}

    def linear(prefix, weight="weight", bias="bias"):
        return {"kernel": sd[f"{prefix}.{weight}"].T,
                "bias": sd[f"{prefix}.{bias}"]}

    params = {
        "token_embedding": sd["token_embedding.weight"],
        "positional_embedding": sd["positional_embedding"],
        "ln_final": ln("ln_final"),
        "text_projection": sd["text_projection"],
    }
    i = 0
    while f"transformer.resblocks.{i}.ln_1.weight" in sd:
        p = f"transformer.resblocks.{i}"
        params[f"block{i}"] = {
            "ln_1": ln(f"{p}.ln_1"),
            "ln_2": ln(f"{p}.ln_2"),
            "attn": {"qkv": linear(f"{p}.attn", "in_proj_weight",
                                   "in_proj_bias"),
                     "proj": linear(f"{p}.attn.out_proj")},
            "mlp_fc": linear(f"{p}.mlp.c_fc"),
            "mlp_proj": linear(f"{p}.mlp.c_proj"),
        }
        i += 1
    return params_from_flax(params)


@torch.no_grad()
def featurize_captions(params: dict, token_ids, batch_size: int = 256,
                       dtype=torch.bfloat16, device=None) -> np.ndarray:
    """Embed tokenized captions in batches (COCO's pre-featurization) with
    CLIP's text tower: `params` is its state dict
    (`convert_openai_clip_text_weights`). Runs on the card unless `device`
    says otherwise. Returns (n, 512) fp32."""
    device = resolve_device(device)
    ids = np.asarray(token_ids)
    if not len(ids):
        return np.empty((0, 512), np.float32)
    model = TextTransformer(dtype=dtype)
    model.load_state_dict(params)
    model.to(device).eval()
    return np.concatenate([
        model(torch.as_tensor(ids[i:i + batch_size], dtype=torch.long,
                              device=device)).cpu().numpy()
        for i in range(0, len(ids), batch_size)])
