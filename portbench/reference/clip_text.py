"""Plain float32 CLIP text tower and the hash tokenizer, with transformers'
``CLIPTextModel`` key names.

The tower follows the published CLIP text transformer (pre-LayerNorm
blocks, causal self-attention, a GELU MLP, a final LayerNorm); the hidden
states after the final LayerNorm are what zeroscope's UNet is conditioned
on. The tokenizer is an independent copy of the system's parameter-free
hash tokenizer (lower-case, split into words and punctuation, sha256 of a
word mod (vocab - 3) + 3, BOS 1 / EOS 2 / PAD 0): the BPE vocabulary of the
published tokenizer is not in the repository, and the random weights make
any id map as good as another. It imports neither JAX nor anything of the
program.
"""

import hashlib
import re
from typing import List

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

BOS_ID, EOS_ID, PAD_ID = 1, 2, 0
_WORD_RE = re.compile(r"[a-z0-9]+|[^\sa-z0-9]")


def tokenize(texts: List[str], vocab_size: int, max_length: int) -> np.ndarray:
    """Prompts -> (B, max_length) int64 ids."""
    out = []
    for text in texts:
        ids = [BOS_ID]
        for word in _WORD_RE.findall(text.lower())[: max_length - 2]:
            digest = hashlib.sha256(word.encode("utf-8")).digest()
            ids.append(3 + int.from_bytes(digest[:8], "big") % (vocab_size - 3))
        ids.append(EOS_ID)
        out.append(ids[:max_length] + [PAD_ID] * (max_length - len(ids)))
    return np.asarray(out, dtype=np.int64)


class _SelfAttention(nn.Module):
    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj = nn.Linear(d, d), nn.Linear(d, d)
        self.v_proj, self.out_proj = nn.Linear(d, d), nn.Linear(d, d)
        self.fp8 = False

    def forward(self, x):
        b, s, d = x.shape
        hd = d // self.heads
        q, k, v = (p(x).reshape(b, s, self.heads, hd).transpose(1, 2)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        # the causal mask as a large negative bias before the softmax
        mask = torch.full((s, s), -1e9, device=x.device).triu(1)
        logits = torch.matmul(q, k.transpose(-1, -2)) * hd ** -0.5 + mask
        if self.fp8:
            from .torch_ref import to_fp8

            o = torch.matmul(to_fp8(torch.softmax(logits, -1)), to_fp8(v))
        else:
            o = torch.matmul(torch.softmax(logits, -1), v)
        return self.out_proj(o.transpose(1, 2).reshape(b, s, d))


class _Layer(nn.Module):
    def __init__(self, d: int, heads: int, inner: int, eps: float):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(d, eps=eps)
        self.self_attn = _SelfAttention(d, heads)
        self.layer_norm2 = nn.LayerNorm(d, eps=eps)
        self.mlp = nn.Module()
        self.mlp.fc1, self.mlp.fc2 = nn.Linear(d, inner), nn.Linear(inner, d)

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp.fc2(F.gelu(self.mlp.fc1(self.layer_norm2(x))))


class CLIPTextRef(nn.Module):
    """ids (B, S) -> last hidden states (B, S, hidden), float32."""

    def __init__(self, vocab_size: int, hidden_size: int, num_layers: int, num_heads: int,
                 intermediate_size: int, max_length: int, layer_norm_eps: float = 1e-5):
        super().__init__()
        tm = nn.Module()
        tm.embeddings = nn.Module()
        tm.embeddings.token_embedding = nn.Embedding(vocab_size, hidden_size)
        tm.embeddings.position_embedding = nn.Embedding(max_length, hidden_size)
        tm.encoder = nn.Module()
        tm.encoder.layers = nn.ModuleList(
            [_Layer(hidden_size, num_heads, intermediate_size, layer_norm_eps)
             for _ in range(num_layers)])
        tm.final_layer_norm = nn.LayerNorm(hidden_size, eps=layer_norm_eps)
        self.text_model = tm

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        tm = self.text_model
        pos = torch.arange(ids.shape[1], device=ids.device)
        x = tm.embeddings.token_embedding(ids) + tm.embeddings.position_embedding(pos)[None]
        for layer in tm.encoder.layers:
            x = layer(x)
        return tm.final_layer_norm(x)

