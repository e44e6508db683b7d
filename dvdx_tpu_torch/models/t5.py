"""The T5 v1.1 encoder (transformers' ``T5EncoderModel``), CogVideoX's text tower.

Per layer: an RMSNorm (``x * rsqrt(mean(x^2) + eps) * w``, the mean square
in float32), self-attention with no bias and no score scaling plus a
relative-position bias that the first layer computes and every layer
reuses (bidirectional buckets: half for each direction, the first
``num_buckets / 4`` positions exact, the rest logarithmic up to
``max_distance``), a residual; an RMSNorm, the gated-GELU feed-forward
``wo(gelu_tanh(wi_0 h) * wi_1 h)``, a residual. A final RMSNorm. The token
embedding is not scaled. Ids are encoded with no attention mask, as the
CogVideoX pipeline calls the tower (padding included).

Rounding points follow transformers in a low-precision dtype: the
normalised states are cast to the weight's dtype before the scale; scores
and the softmax are float32 here, the probabilities cast to V's dtype,
P.V accumulated in float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.profiling import span
from .layers import Dense


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    num_heads: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    max_length: int = 226   # the CogVideoX pipeline pads every prompt to this
    dtype: str = "bfloat16"

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def hidden_size(self) -> int:
        return self.d_model


def tiny_t5_config() -> T5Config:
    return T5Config(vocab_size=1024, d_model=64, d_kv=16, num_heads=4, d_ff=96, num_layers=2,
                    relative_attention_num_buckets=8, relative_attention_max_distance=16,
                    max_length=7, dtype="float32")


def relative_position_bucket(relative_position: torch.Tensor, num_buckets: int,
                             max_distance: int) -> torch.Tensor:
    """transformers' bidirectional ``_relative_position_bucket`` of
    (key - query) offsets."""
    num_buckets //= 2
    buckets = (relative_position > 0).long() * num_buckets
    n = relative_position.abs()
    max_exact = num_buckets // 2
    large = max_exact + (torch.log(n.float() / max_exact) / math.log(max_distance / max_exact)
                         * (num_buckets - max_exact)).long()
    large = torch.clamp(large, max=num_buckets - 1)
    return buckets + torch.where(n < max_exact, n, large)


class RMSNorm(nn.Module):
    """T5's LayerNorm: no mean, no bias."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var = x.float().pow(2).mean(-1, keepdim=True)
        return self.weight * (x * torch.rsqrt(var + self.eps)).to(self.weight.dtype)


class _T5Layer(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.heads, self.d_kv = cfg.num_heads, cfg.d_kv
        self.ln1 = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)
        self.q = Dense(cfg.d_model, inner, bias=False)
        self.k = Dense(cfg.d_model, inner, bias=False)
        self.v = Dense(cfg.d_model, inner, bias=False)
        self.o = Dense(inner, cfg.d_model, bias=False)
        self.ln2 = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)
        self.wi_0 = Dense(cfg.d_model, cfg.d_ff, bias=False)
        self.wi_1 = Dense(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = Dense(cfg.d_ff, cfg.d_model, bias=False)

    def forward(self, x: torch.Tensor, position_bias: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        h = self.ln1(x)
        q, k, v = (proj(h).view(b, s, self.heads, self.d_kv) for proj in (self.q, self.k, self.v))
        scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) + position_bias
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        o = torch.einsum("bhst,bthd->bshd", probs.float(), v.float()).to(x.dtype)
        x = self.o(o.reshape(b, s, -1), residual=x)
        h = self.ln2(x)
        return self.wo(F.gelu(self.wi_0(h), approximate="tanh") * self.wi_1(h), residual=x)


class T5Encoder(nn.Module):
    """token ids (B, S) -> (hidden states (B, S, d_model), None): T5 has no
    pooled output."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        # layer 0's relative_attention_bias, which every layer reuses
        self.relative_attention_bias = nn.Embedding(cfg.relative_attention_num_buckets,
                                                    cfg.num_heads)
        for i in range(cfg.num_layers):
            self.add_module(f"block{i}", _T5Layer(cfg))
        self.final_ln = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)
        self._buckets: Dict[Tuple[int, str], torch.Tensor] = {}

    def position_bias(self, s: int, device) -> torch.Tensor:
        """(1, heads, s, s) float32: the bias of key j for query i."""
        key = (s, str(device))
        buckets = self._buckets.get(key)
        if buckets is None:
            pos = torch.arange(s, device=device)
            buckets = relative_position_bucket(pos[None, :] - pos[:, None],
                                               self.cfg.relative_attention_num_buckets,
                                               self.cfg.relative_attention_max_distance)
            self._buckets[key] = buckets
        return self.relative_attention_bias(buckets).float().permute(2, 0, 1)[None]

    def forward(self, input_ids: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        with span("t5"):
            x = self.shared(input_ids)
            bias = self.position_bias(input_ids.shape[1], input_ids.device)
            for i in range(self.cfg.num_layers):
                x = getattr(self, f"block{i}")(x, bias)
            return self.final_ln(x), None
