"""Plain float32 reference of the published CogVideoX-5B: the transformer
(diffusers' ``CogVideoXTransformer3DModel``), its T5 v1.1 encoder
(transformers' ``T5EncoderModel``) and its sampler (diffusers'
``CogVideoXDDIMScheduler``), with the published state-dict key names.

Written from the published equations (arXiv:2408.06072 and the diffusers /
transformers sources of those classes), independent of the program: it
imports neither JAX nor anything of the program, no kernel, no cache and
no batching of the port, and its two towers set TF32 off
(``torch.backends.cuda.matmul.allow_tf32`` and ``torch.backends.cudnn.
allow_tf32``) each time they run. Departures from diffusers and transformers:

* attention is written out as softmax(Q K^T * scale [+ bias]) V in float32,
  a block of ``QUERY_BLOCK`` queries at a time, so that the 17,776-token
  joint attention fits on one card; the arithmetic per query is unchanged;
* the rotary tables are built on the CPU and moved to the device;
* the weights of the linear layers are held in ``weight_dtype`` (bfloat16,
  the dtype of the published checkpoint and of the seeded draw) and
  widened to float32 for each product: the same numbers as float32 weights
  (a bfloat16 value is exact in float32), at half the memory, since both
  towers' 10.3 B parameters in float32 do not fit the card beside the draw;
* the modules hold no dropout (inference) and the T5 encoder's tied
  ``encoder.embed_tokens`` is its ``shared`` table, one key;
* ``snr_shift_scale`` is applied as written, though 1.0 (the 5B model's)
  makes it the identity;
* ``fp8 = True`` on an attention module (``torch_ref.lower_precision``, the
  control) rounds q, k, v and the probabilities to float8 first.
"""

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .torch_ref import to_fp8

QUERY_BLOCK = 256


class Linear(nn.Linear):
    """``nn.Linear`` with its weight and bias held in ``dtype`` and the
    product computed in float32."""

    def __init__(self, in_features, out_features, bias=True, dtype=torch.bfloat16):
        super().__init__(in_features, out_features, bias=bias, dtype=dtype)

    def forward(self, x):
        return F.linear(x, self.weight.float(), None if self.bias is None else self.bias.float())


def no_tf32():
    """Full float32 products and convolutions on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def blocked_attention(q, k, v, scale, bias=None, fp8=False):
    """softmax(q k^T * scale + bias) v over (B, H, S, D) tensors in float32,
    ``QUERY_BLOCK`` queries at a time; ``bias`` broadcasts to (B, H, S, T)."""
    if fp8:
        q, k, v = to_fp8(q), to_fp8(k), to_fp8(v)
    out = torch.empty_like(q)
    kt = k.transpose(-1, -2)
    for q0 in range(0, q.shape[2], QUERY_BLOCK):
        q1 = min(q.shape[2], q0 + QUERY_BLOCK)
        s = torch.matmul(q[:, :, q0:q1], kt) * scale
        if bias is not None:
            s = s + bias[..., q0:q1, :]
        p = torch.softmax(s, dim=-1)
        out[:, :, q0:q1] = torch.matmul(to_fp8(p) if fp8 else p, v)
    return out


# -- the transformer --

def timestep_embedding(timesteps, dim, max_period=10000.0):
    """diffusers' ``get_timestep_embedding`` with flip_sin_to_cos=True and
    downscale_freq_shift=0: cos first."""
    half = dim // 2
    exponent = (-math.log(max_period)
                * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half)
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None]
    return torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1)


def resize_crop_region(src, tgt_width, tgt_height):
    """diffusers' ``get_resize_crop_region_for_grid``."""
    h, w = src
    if h / w > tgt_height / tgt_width:
        resize_height, resize_width = tgt_height, int(round(tgt_height / h * w))
    else:
        resize_width, resize_height = tgt_width, int(round(tgt_width / w * h))
    top = int(round((tgt_height - resize_height) / 2.0))
    left = int(round((tgt_width - resize_width) / 2.0))
    return (top, left), (top + resize_height, left + resize_width)


def rotary_1d(dim, pos, theta=10000.0):
    """diffusers' ``get_1d_rotary_pos_embed(use_real=True,
    repeat_interleave_real=True)``: (cos, sin), each (len(pos), dim)."""
    freqs = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                          device=pos.device)[: dim // 2] / dim))
    freqs = torch.outer(pos, freqs)
    return freqs.cos().repeat_interleave(2, dim=1), freqs.sin().repeat_interleave(2, dim=1)


def rotary_3d(head_dim, grid_h, grid_w, frames, base_h, base_w):
    """diffusers' ``get_3d_rotary_pos_embed`` over the crop region of the
    (base_h, base_w) patch grid, as the CogVideoX pipeline's
    ``_prepare_rotary_positional_embeddings`` calls it: (cos, sin), each
    (frames * grid_h * grid_w, head_dim)."""
    (top, left), (bottom, right) = resize_crop_region((grid_h, grid_w), base_w, base_h)
    pos_h = torch.from_numpy(np.linspace(top, bottom, grid_h, endpoint=False, dtype=np.float32))
    pos_w = torch.from_numpy(np.linspace(left, right, grid_w, endpoint=False, dtype=np.float32))
    pos_t = torch.from_numpy(np.linspace(0, frames, frames, endpoint=False, dtype=np.float32))
    dim_t, dim_h, dim_w = head_dim // 4, head_dim // 8 * 3, head_dim // 8 * 3
    ft, fh, fw = rotary_1d(dim_t, pos_t), rotary_1d(dim_h, pos_h), rotary_1d(dim_w, pos_w)

    def combine(t, h, w):
        t = t[:, None, None, :].expand(-1, grid_h, grid_w, -1)
        h = h[None, :, None, :].expand(frames, -1, grid_w, -1)
        w = w[None, None, :, :].expand(frames, grid_h, -1, -1)
        return torch.cat([t, h, w], dim=-1).reshape(frames * grid_h * grid_w, -1)

    return combine(ft[0], fh[0], fw[0]), combine(ft[1], fh[1], fw[1])


def apply_rotary_emb(x, cos, sin):
    """diffusers' ``apply_rotary_emb(use_real=True, use_real_unbind_dim=-1)``
    over (B, H, S, D)."""
    x_real, x_imag = x.reshape(*x.shape[:-1], -1, 2).unbind(-1)
    x_rotated = torch.stack([-x_imag, x_real], dim=-1).flatten(3)
    return x * cos[None, None] + x_rotated * sin[None, None]


class PatchEmbed(nn.Module):
    def __init__(self, patch_size, in_channels, embed_dim, text_embed_dim, wd):
        super().__init__()
        self.proj = nn.Conv2d(in_channels, embed_dim, patch_size, stride=patch_size)
        self.text_proj = Linear(text_embed_dim, embed_dim, dtype=wd)

    def forward(self, text_embeds, image_embeds):
        text_embeds = self.text_proj(text_embeds)
        b, f, c, h, w = image_embeds.shape
        x = self.proj(image_embeds.reshape(-1, c, h, w))
        x = x.view(b, f, *x.shape[1:]).flatten(3).transpose(2, 3).flatten(1, 2)
        return torch.cat([text_embeds, x], dim=1)


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim, out_dim, wd):
        super().__init__()
        self.linear_1 = Linear(in_dim, out_dim, dtype=wd)
        self.linear_2 = Linear(out_dim, out_dim, dtype=wd)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class LayerNormZero(nn.Module):
    """diffusers' ``CogVideoXLayerNormZero``."""

    def __init__(self, conditioning_dim, embedding_dim, eps, wd):
        super().__init__()
        self.linear = Linear(conditioning_dim, 6 * embedding_dim, dtype=wd)
        self.norm = nn.LayerNorm(embedding_dim, eps=eps)

    def forward(self, hidden_states, encoder_hidden_states, temb):
        shift, scale, gate, enc_shift, enc_scale, enc_gate = \
            self.linear(F.silu(temb)).chunk(6, dim=1)
        hidden_states = self.norm(hidden_states) * (1 + scale)[:, None] + shift[:, None]
        encoder_hidden_states = (self.norm(encoder_hidden_states) * (1 + enc_scale)[:, None]
                                 + enc_shift[:, None])
        return hidden_states, encoder_hidden_states, gate[:, None], enc_gate[:, None]


class JointAttention(nn.Module):
    """diffusers' ``Attention(qk_norm="layer_norm", eps=1e-6, bias=True)``
    under ``CogVideoXAttnProcessor2_0``."""

    def __init__(self, dim, heads, head_dim, wd):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.fp8 = heads, False
        self.to_q = Linear(dim, inner, dtype=wd)
        self.to_k = Linear(dim, inner, dtype=wd)
        self.to_v = Linear(dim, inner, dtype=wd)
        self.norm_q = nn.LayerNorm(head_dim, eps=1e-6)
        self.norm_k = nn.LayerNorm(head_dim, eps=1e-6)
        self.to_out = nn.ModuleList([Linear(inner, dim, dtype=wd)])

    def forward(self, hidden_states, encoder_hidden_states, rotary):
        n_text = encoder_hidden_states.shape[1]
        x = torch.cat([encoder_hidden_states, hidden_states], dim=1)
        b, s, _ = x.shape
        q, k, v = (proj(x).view(b, s, self.heads, -1).transpose(1, 2)
                   for proj in (self.to_q, self.to_k, self.to_v))
        q, k = self.norm_q(q), self.norm_k(k)
        cos, sin = rotary
        q = torch.cat([q[:, :, :n_text], apply_rotary_emb(q[:, :, n_text:], cos, sin)], dim=2)
        k = torch.cat([k[:, :, :n_text], apply_rotary_emb(k[:, :, n_text:], cos, sin)], dim=2)
        o = blocked_attention(q, k, v, q.shape[-1] ** -0.5, fp8=self.fp8)
        o = self.to_out[0](o.transpose(1, 2).reshape(b, s, -1))
        return o[:, n_text:], o[:, :n_text]


class GELUProj(nn.Module):
    def __init__(self, dim_in, dim_out, wd):
        super().__init__()
        self.proj = Linear(dim_in, dim_out, dtype=wd)

    def forward(self, x):
        return F.gelu(self.proj(x), approximate="tanh")


class FeedForward(nn.Module):
    def __init__(self, dim, inner, wd):
        super().__init__()
        self.net = nn.ModuleList([GELUProj(dim, inner, wd), nn.Identity(),
                                  Linear(inner, dim, dtype=wd)])

    def forward(self, x):
        for m in self.net:
            x = m(x)
        return x


class CogVideoXBlock(nn.Module):
    def __init__(self, dim, heads, head_dim, time_embed_dim, eps, wd):
        super().__init__()
        self.norm1 = LayerNormZero(time_embed_dim, dim, eps, wd)
        self.attn1 = JointAttention(dim, heads, head_dim, wd)
        self.norm2 = LayerNormZero(time_embed_dim, dim, eps, wd)
        self.ff = FeedForward(dim, 4 * dim, wd)

    def forward(self, hidden_states, encoder_hidden_states, temb, rotary):
        n_text = encoder_hidden_states.shape[1]
        nh, ne, gate, enc_gate = self.norm1(hidden_states, encoder_hidden_states, temb)
        ah, ae = self.attn1(nh, ne, rotary)
        hidden_states = hidden_states + gate * ah
        encoder_hidden_states = encoder_hidden_states + enc_gate * ae
        nh, ne, gate_ff, enc_gate_ff = self.norm2(hidden_states, encoder_hidden_states, temb)
        ff = self.ff(torch.cat([ne, nh], dim=1))
        hidden_states = hidden_states + gate_ff * ff[:, n_text:]
        encoder_hidden_states = encoder_hidden_states + enc_gate_ff * ff[:, :n_text]
        return hidden_states, encoder_hidden_states


class AdaLayerNorm(nn.Module):
    """diffusers' ``AdaLayerNorm(chunk_dim=1)``: shift, then scale."""

    def __init__(self, embedding_dim, output_dim, eps, wd):
        super().__init__()
        self.linear = Linear(embedding_dim, output_dim, dtype=wd)
        self.norm = nn.LayerNorm(output_dim // 2, eps=eps)

    def forward(self, x, temb):
        shift, scale = self.linear(F.silu(temb)).chunk(2, dim=1)
        return self.norm(x) * (1 + scale[:, None]) + shift[:, None]


class CogVideoXTransformer3DRef(nn.Module):
    """hidden_states (B, F, C, H, W), T5 states (B, T, text_embed_dim),
    timesteps (B,) -> the v prediction (B, F, C, H, W)."""

    def __init__(self, num_attention_heads=48, attention_head_dim=64, in_channels=16,
                 out_channels=16, time_embed_dim=512, text_embed_dim=4096, num_layers=42,
                 sample_width=90, sample_height=60, patch_size=2, norm_eps=1e-5,
                 weight_dtype=torch.bfloat16):
        super().__init__()
        dim = num_attention_heads * attention_head_dim
        wd = weight_dtype
        self.head_dim, self.patch_size = attention_head_dim, patch_size
        self.sample_width, self.sample_height = sample_width, sample_height
        self.patch_embed = PatchEmbed(patch_size, in_channels, dim, text_embed_dim, wd)
        self.time_embedding = TimestepEmbedding(dim, time_embed_dim, wd)
        self.transformer_blocks = nn.ModuleList(
            [CogVideoXBlock(dim, num_attention_heads, attention_head_dim, time_embed_dim,
                            norm_eps, wd) for _ in range(num_layers)])
        self.norm_final = nn.LayerNorm(dim, eps=norm_eps)
        self.norm_out = AdaLayerNorm(time_embed_dim, 2 * dim, norm_eps, wd)
        self.proj_out = Linear(dim, patch_size * patch_size * out_channels, dtype=wd)

    def rotary(self, frames, height, width, device):
        p = self.patch_size
        cos, sin = rotary_3d(self.head_dim, height // p, width // p, frames,
                             self.sample_height // p, self.sample_width // p)
        return cos.to(device), sin.to(device)

    def forward(self, hidden_states, encoder_hidden_states, timestep):
        no_tf32()
        b, f, c, h, w = hidden_states.shape
        emb = self.time_embedding(timestep_embedding(timestep, self.norm_final.weight.numel()))
        x = self.patch_embed(encoder_hidden_states, hidden_states)
        n_text = encoder_hidden_states.shape[1]
        enc, x = x[:, :n_text], x[:, n_text:]
        rotary = self.rotary(f, h, w, hidden_states.device)
        for block in self.transformer_blocks:
            x, enc = block(x, enc, emb, rotary)
        x = self.norm_final(torch.cat([enc, x], dim=1))[:, n_text:]
        x = self.proj_out(self.norm_out(x, emb))
        p = self.patch_size
        x = x.reshape(b, f, h // p, w // p, -1, p, p)
        return x.permute(0, 1, 4, 2, 5, 3, 6).flatten(5, 6).flatten(3, 4)


# -- the T5 encoder --

def relative_position_bucket(relative_position, num_buckets=32, max_distance=128):
    """transformers' ``T5Attention._relative_position_bucket``, bidirectional."""
    num_buckets //= 2
    relative_buckets = (relative_position > 0).to(torch.long) * num_buckets
    relative_position = torch.abs(relative_position)
    max_exact = num_buckets // 2
    is_small = relative_position < max_exact
    if_large = max_exact + (torch.log(relative_position.float() / max_exact)
                            / math.log(max_distance / max_exact)
                            * (num_buckets - max_exact)).to(torch.long)
    if_large = torch.min(if_large, torch.full_like(if_large, num_buckets - 1))
    return relative_buckets + torch.where(is_small, relative_position, if_large)


class T5LayerNorm(nn.Module):
    def __init__(self, dim, eps):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x):
        return self.weight * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps))


class T5Attention(nn.Module):
    def __init__(self, d_model, heads, d_kv, has_bias, num_buckets, max_distance, wd):
        super().__init__()
        inner = heads * d_kv
        self.heads, self.num_buckets, self.max_distance, self.fp8 = \
            heads, num_buckets, max_distance, False
        self.q = Linear(d_model, inner, bias=False, dtype=wd)
        self.k = Linear(d_model, inner, bias=False, dtype=wd)
        self.v = Linear(d_model, inner, bias=False, dtype=wd)
        self.o = Linear(inner, d_model, bias=False, dtype=wd)
        if has_bias:
            self.relative_attention_bias = nn.Embedding(num_buckets, heads)

    def compute_bias(self, s, device):
        pos = torch.arange(s, dtype=torch.long, device=device)
        buckets = relative_position_bucket(pos[None, :] - pos[:, None], self.num_buckets,
                                           self.max_distance)
        return self.relative_attention_bias(buckets).permute(2, 0, 1)[None]

    def forward(self, x, position_bias):
        b, s, _ = x.shape
        q, k, v = (proj(x).view(b, s, self.heads, -1).transpose(1, 2)
                   for proj in (self.q, self.k, self.v))
        o = blocked_attention(q, k, v, 1.0, position_bias, fp8=self.fp8)
        return self.o(o.transpose(1, 2).reshape(b, s, -1))


class T5LayerSelfAttention(nn.Module):
    def __init__(self, cfg, has_bias, wd):
        super().__init__()
        self.SelfAttention = T5Attention(cfg["d_model"], cfg["num_heads"], cfg["d_kv"], has_bias,
                                         cfg["relative_attention_num_buckets"],
                                         cfg["relative_attention_max_distance"], wd)
        self.layer_norm = T5LayerNorm(cfg["d_model"], cfg["layer_norm_epsilon"])


class DenseGatedActDense(nn.Module):
    def __init__(self, d_model, d_ff, wd):
        super().__init__()
        self.wi_0 = Linear(d_model, d_ff, bias=False, dtype=wd)
        self.wi_1 = Linear(d_model, d_ff, bias=False, dtype=wd)
        self.wo = Linear(d_ff, d_model, bias=False, dtype=wd)

    def forward(self, x):
        return self.wo(F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x))


class T5LayerFF(nn.Module):
    def __init__(self, cfg, wd):
        super().__init__()
        self.DenseReluDense = DenseGatedActDense(cfg["d_model"], cfg["d_ff"], wd)
        self.layer_norm = T5LayerNorm(cfg["d_model"], cfg["layer_norm_epsilon"])


class T5Block(nn.Module):
    def __init__(self, cfg, has_bias, wd):
        super().__init__()
        self.layer = nn.ModuleList([T5LayerSelfAttention(cfg, has_bias, wd), T5LayerFF(cfg, wd)])

    def forward(self, x, position_bias):
        attn, ff = self.layer
        x = x + attn.SelfAttention(attn.layer_norm(x), position_bias)
        return x + ff.DenseReluDense(ff.layer_norm(x))


class T5EncoderRef(nn.Module):
    """token ids (B, S) -> the last hidden states (B, S, d_model), no mask."""

    def __init__(self, cfg, weight_dtype=torch.bfloat16):
        super().__init__()
        self.shared = nn.Embedding(cfg["vocab_size"], cfg["d_model"])
        self.encoder = nn.Module()
        self.encoder.block = nn.ModuleList([T5Block(cfg, i == 0, weight_dtype)
                                            for i in range(cfg["num_layers"])])
        self.encoder.final_layer_norm = T5LayerNorm(cfg["d_model"], cfg["layer_norm_epsilon"])

    def forward(self, input_ids):
        no_tf32()
        x = self.shared(input_ids)
        blocks = self.encoder.block
        bias = blocks[0].layer[0].SelfAttention.compute_bias(input_ids.shape[1], x.device)
        for blk in blocks:
            x = blk(x, bias)
        return self.encoder.final_layer_norm(x)


# -- the sampler --

def rescale_zero_terminal_snr(alphas_cumprod):
    """The CogVideoX scheduler's ``rescale_zero_terminal_snr`` (on alpha-bar)."""
    alphas_bar_sqrt = alphas_cumprod.sqrt()
    a0 = alphas_bar_sqrt[0].clone()
    a_last = alphas_bar_sqrt[-1].clone()
    alphas_bar_sqrt = (alphas_bar_sqrt - a_last) * (a0 / (a0 - a_last))
    return alphas_bar_sqrt ** 2


class CogVideoXDDIMSchedulerRef:
    """``CogVideoXDDIMScheduler`` as the published ``scheduler_config.json``
    sets it: scaled_linear betas 0.00085-0.012 over 1000 steps, v
    prediction, zero-terminal-SNR rescale, ``set_alpha_to_one``, trailing
    spacing, ``snr_shift_scale`` 1.0; float32 torch, eta 0."""

    def __init__(self, num_train_timesteps=1000, beta_start=0.00085, beta_end=0.012,
                 snr_shift_scale=1.0):
        betas = torch.linspace(beta_start ** 0.5, beta_end ** 0.5, num_train_timesteps,
                               dtype=torch.float32) ** 2
        acp = torch.cumprod(1.0 - betas, dim=0)
        acp = acp / (snr_shift_scale + (1 - snr_shift_scale) * acp)
        self.alphas_cumprod = rescale_zero_terminal_snr(acp)
        self.final_alpha_cumprod = torch.tensor(1.0)
        self.num_train_timesteps = num_train_timesteps

    def set_timesteps(self, n):
        self.num_inference_steps = n
        ratio = self.num_train_timesteps / n
        self.timesteps = torch.from_numpy(
            np.round(np.arange(self.num_train_timesteps, 0, -ratio)).astype(np.int64) - 1)

    def step(self, model_output, timestep, sample):
        prev = timestep - self.num_train_timesteps // self.num_inference_steps
        a_t = self.alphas_cumprod[timestep]
        a_prev = self.alphas_cumprod[prev] if prev >= 0 else self.final_alpha_cumprod
        b_t = 1 - a_t
        x0 = a_t ** 0.5 * sample.float() - b_t ** 0.5 * model_output.float()
        coef_z = ((1 - a_prev) / (1 - a_t)) ** 0.5
        coef_x0 = a_prev ** 0.5 - a_t ** 0.5 * coef_z
        return coef_z * sample.float() + coef_x0 * x0
