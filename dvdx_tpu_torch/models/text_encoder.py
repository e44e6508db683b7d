"""CLIP-style text encoder and the deterministic hash tokenizer.

Counterpart of ``dvdx_tpu/models/text_encoder.py``: a pre-LN causal
transformer (ViT-H text-tower scale at full size) and the parameter-free
hash tokenizer miner and validator share. The tokenizer is this package's
own copy; its ids must equal the reference's, since they are part of the
Proof-of-Inference determinism chain.
"""

from __future__ import annotations

import dataclasses
import hashlib
import re
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dense, LayerNorm


@dataclasses.dataclass(frozen=True)
class TextEncoderConfig:
    vocab_size: int = 49408
    hidden_size: int = 1024
    num_layers: int = 23
    num_heads: int = 16
    intermediate_size: int = 4096
    max_length: int = 77
    # "gelu" (exact erf: the OpenCLIP towers zeroscope uses) or "quick_gelu"
    # (x * sigmoid(1.702 x): OpenAI-CLIP towers), as transformers names them
    hidden_act: str = "gelu"
    layer_norm_eps: float = 1e-5
    eos_token_id: int = 2
    dtype: str = "bfloat16"

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def tiny_text_config() -> TextEncoderConfig:
    return TextEncoderConfig(vocab_size=1024, hidden_size=64, num_layers=2,
                             num_heads=4, intermediate_size=128, max_length=16,
                             dtype="float32")


BOS_ID = 1
EOS_ID = 2
PAD_ID = 0
_WORD_RE = re.compile(r"[a-z0-9]+|[^\sa-z0-9]")


def activation(name: str):
    """The feed-forward activation of a CLIP tower by its transformers name."""
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return F.gelu
    if name == "gelu_tanh":
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {name!r}")


def tokenize(text: str, vocab_size: int = 49408, max_length: int = 77) -> np.ndarray:
    """Lowercase, split into words and punctuation, map each token to
    3 + (sha256(token) mod (vocab_size - 3)), frame with BOS/EOS, pad or cut
    to max_length. Returns (max_length,) int32."""
    words = _WORD_RE.findall(text.lower())
    ids = [BOS_ID]
    for word in words[: max_length - 2]:
        digest = hashlib.sha256(word.encode("utf-8")).digest()
        ids.append(3 + int.from_bytes(digest[:8], "big") % (vocab_size - 3))
    ids.append(EOS_ID)
    ids = ids[:max_length] + [PAD_ID] * (max_length - len(ids))
    return np.asarray(ids, dtype=np.int32)


def tokenize_batch(texts: List[str], vocab_size: int = 49408,
                   max_length: int = 77) -> np.ndarray:
    return np.stack([tokenize(t, vocab_size, max_length) for t in texts])


class _TextBlock(nn.Module):
    def __init__(self, cfg: TextEncoderConfig):
        super().__init__()
        d, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.heads = cfg.num_heads
        self.ln1 = LayerNorm(d, eps=eps)
        self.q = Dense(d, d)
        self.k = Dense(d, d)
        self.v = Dense(d, d)
        self.proj = Dense(d, d)
        self.ln2 = LayerNorm(d, eps=eps)
        self.fc1 = Dense(d, cfg.intermediate_size)
        self.fc2 = Dense(cfg.intermediate_size, d)
        self.act = activation(cfg.hidden_act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        hd = d // self.heads
        h = self.ln1(x)
        q = self.q(h).view(b, s, self.heads, hd)
        k = self.k(h).view(b, s, self.heads, hd)
        v = self.v(h).view(b, s, self.heads, hd)
        # causal attention: float32 logits masked at -1e9, float32 softmax,
        # probabilities cast to v's dtype
        logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * hd ** -0.5
        causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        logits = logits.masked_fill(~causal, -1e9)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        o = torch.einsum("bhst,bthd->bshd", probs.float(), v.float()).to(x.dtype)
        x = x + self.proj(o.reshape(b, s, d))
        return x + self.fc2(self.act(self.fc1(self.ln2(x))))


class CLIPTextEncoder(nn.Module):
    """token ids (B, S) -> hidden states (B, S, hidden), pooled (B, hidden)
    taken at the first EOS position."""

    def __init__(self, cfg: TextEncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Parameter(
            torch.zeros(cfg.max_length, cfg.hidden_size))
        for i in range(cfg.num_layers):
            self.add_module(f"layer{i}", _TextBlock(cfg))
        self.final_ln = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        s = input_ids.shape[1]
        x = self.token_embedding(input_ids) + self.position_embedding[None, :s]
        for i in range(self.cfg.num_layers):
            x = getattr(self, f"layer{i}")(x)
        x = self.final_ln(x)
        eos = (input_ids == self.cfg.eos_token_id).int().argmax(dim=-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eos]
        return x, pooled
