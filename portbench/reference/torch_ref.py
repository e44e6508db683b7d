"""Plain float32 reference of zeroscope's UNet3D, its AutoencoderKL decoder
and DDIM, with diffusers' state-dict key names.

Frozen copy of the repository's ``tests/torch_ref.py`` (the UNet3D, VAE and
DDIM parts; LPIPS left out), so that later changes to the program or its
tests cannot move the yardstick. Departures from that file:

* ``get_timestep_embedding`` builds its frequencies on the timesteps'
  device;
* attention is written out as softmax(Q K^T / sqrt(d)) V in float32 and run
  in chunks of (batch x head) rows, so that full-width frames fit on one
  card (24 frames at 1024x576 would need 40 GB of logits in one piece);
  the arithmetic per row is unchanged;
* ``lower_precision(module)`` turns a built module into the control: every
  weight and every input of a linear, convolution or attention product
  rounded to float8 (e4m3, one scale per tensor), the precision below the
  bfloat16 that the configurations state.

It imports neither JAX nor anything of the program.
"""


import math

import torch
import torch.nn as nn
import torch.nn.functional as F

# float32 logits held at once by ``attention``
ATTENTION_CHUNK_BYTES = 1 << 30
FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the tensor (its largest
    magnitude maps to 448), returned in x's dtype."""
    amax = x.detach().abs().amax().float().clamp_min(1e-12)
    scale = FP8_MAX / amax
    return ((x.float() * scale).to(FP8).float() / scale).to(x.dtype)


def attention(q, k, v, fp8: bool = False):
    """softmax(q k^T / sqrt(d)) v over (B, H, S, D) tensors, in float32,
    a chunk of (B x H) rows at a time. ``fp8``: q, k, v and the
    probabilities rounded to float8 first."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if fp8:
        q, k, v = to_fp8(q), to_fp8(k), to_fp8(v)
    q, k, v = (t.reshape(b * h, t.shape[2], d) for t in (q, k, v))
    out = torch.empty_like(q)
    rows = max(1, ATTENTION_CHUNK_BYTES // (sq * sk * 4))
    for r0 in range(0, b * h, rows):
        r1 = min(b * h, r0 + rows)
        p = torch.softmax(torch.bmm(q[r0:r1], k[r0:r1].transpose(1, 2)) * d ** -0.5, -1)
        out[r0:r1] = torch.bmm(to_fp8(p) if fp8 else p, v[r0:r1])
    return out.reshape(b, h, sq, d)


def lower_precision(module: nn.Module) -> nn.Module:
    """The control: every weight of a linear or convolution layer rounded
    to float8 in place, and every input of one rounded on its way in (a
    forward pre-hook); attention products take ``fp8=True``."""
    def quant_input(mod, args):
        return (to_fp8(args[0]),) + tuple(args[1:])

    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d, nn.Conv3d)):
                m.weight.copy_(to_fp8(m.weight))
                m.register_forward_pre_hook(quant_input)
            if hasattr(m, "fp8"):
                m.fp8 = True
    return module


def get_timestep_embedding(timesteps, dim, max_period=10000.0):
    half = dim // 2
    exponent = (-math.log(max_period)
                * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half)
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None]
    # flip_sin_to_cos=True (UNet3DConditionModel): cos first
    return torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1)


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim, time_embed_dim):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, time_embed_dim)
        self.linear_2 = nn.Linear(time_embed_dim, time_embed_dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class ResnetBlock2D(nn.Module):
    def __init__(self, in_ch, out_ch, temb_dim=None, groups=32, eps=1e-5):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, in_ch, eps=eps)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        if temb_dim is not None:
            self.time_emb_proj = nn.Linear(temb_dim, out_ch)
        self.norm2 = nn.GroupNorm(groups, out_ch, eps=eps)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        if in_ch != out_ch:
            self.conv_shortcut = nn.Conv2d(in_ch, out_ch, 1)
        else:
            self.conv_shortcut = None

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        r = x if self.conv_shortcut is None else self.conv_shortcut(x)
        return r + h


class TemporalConvLayer(nn.Module):
    """diffusers TemporalConvLayer generalised to N convs (diffusers has 4);
    input/output (B*F, C, H, W) with num_frames passed to forward."""

    def __init__(self, dim, num_layers=4, groups=32, eps=1e-5):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            seq = ([nn.GroupNorm(groups, dim, eps=eps), nn.SiLU()]
                   + ([nn.Dropout(0.0)] if i > 0 else [])
                   + [nn.Conv3d(dim, dim, (3, 1, 1), padding=(1, 0, 0))])
            setattr(self, f"conv{i + 1}", nn.Sequential(*seq))
        last = getattr(self, f"conv{num_layers}")[-1]
        nn.init.zeros_(last.weight)
        nn.init.zeros_(last.bias)

    def forward(self, x, num_frames=1):
        bf, c, h, w = x.shape
        x5 = x.reshape(bf // num_frames, num_frames, c, h, w).permute(0, 2, 1, 3, 4)
        identity = x5
        hdn = x5
        for i in range(self.num_layers):
            hdn = getattr(self, f"conv{i + 1}")(hdn)
        out = identity + hdn
        return out.permute(0, 2, 1, 3, 4).reshape(bf, c, h, w)


class Attention(nn.Module):
    def __init__(self, query_dim, heads, dim_head, cross_dim=None):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        kv_dim = cross_dim or query_dim
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(kv_dim, inner, bias=False)
        self.to_v = nn.Linear(kv_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim), nn.Dropout(0.0)])
        self.fp8 = False

    def forward(self, x, context=None):
        ctx = x if context is None else context
        b, s, _ = x.shape
        q = self.to_q(x).reshape(b, s, self.heads, self.dim_head).transpose(1, 2)
        k = self.to_k(ctx).reshape(b, ctx.shape[1], self.heads, self.dim_head).transpose(1, 2)
        v = self.to_v(ctx).reshape(b, ctx.shape[1], self.heads, self.dim_head).transpose(1, 2)
        o = attention(q, k, v, self.fp8)
        o = o.transpose(1, 2).reshape(b, s, -1)
        return self.to_out[0](o)


class FeedForward(nn.Module):
    """GEGLU (diffusers FeedForward activation_fn='geglu')."""

    def __init__(self, dim, mult=4):
        super().__init__()

        class GEGLU(nn.Module):
            def __init__(self, din, dout):
                super().__init__()
                self.proj = nn.Linear(din, dout * 2)

            def forward(self, x):
                h, gate = self.proj(x).chunk(2, dim=-1)
                return h * F.gelu(gate)

        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Dropout(0.0),
                                  nn.Linear(dim * mult, dim)])

    def forward(self, x):
        for mod in self.net:
            x = mod(x)
        return x


class BasicTransformerBlock(nn.Module):
    """double_self=True mirrors diffusers double_self_attention (the
    TransformerTemporalModel default): attn2 exists but self-attends."""

    def __init__(self, dim, heads, dim_head, cross_dim=None, double_self=False):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = Attention(dim, heads, dim_head)
        self.has_cross = cross_dim is not None or double_self
        if self.has_cross:
            self.norm2 = nn.LayerNorm(dim)
            self.attn2 = Attention(dim, heads, dim_head,
                                   None if double_self else cross_dim)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context=None):
        x = x + self.attn1(self.norm1(x))
        if self.has_cross:
            x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2DModel(nn.Module):
    """Spatial transformer, use_linear_projection=False (1x1 conv proj)."""

    def __init__(self, in_ch, heads, dim_head, cross_dim, groups=32):
        super().__init__()
        self.norm = nn.GroupNorm(groups, in_ch, eps=1e-6)
        self.proj_in = nn.Conv2d(in_ch, in_ch, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(in_ch, heads, dim_head, cross_dim)])
        self.proj_out = nn.Conv2d(in_ch, in_ch, 1)

    def forward(self, x, context):
        b, c, h, w = x.shape
        residual = x
        hdn = self.proj_in(self.norm(x))
        hdn = hdn.permute(0, 2, 3, 1).reshape(b, h * w, c)
        for blk in self.transformer_blocks:
            hdn = blk(hdn, context)
        hdn = hdn.reshape(b, h, w, c).permute(0, 3, 1, 2)
        return residual + self.proj_out(hdn)


class TransformerTemporalModel(nn.Module):
    def __init__(self, heads, dim_head, in_ch, cross_dim=None, groups=32,
                 double_self=True):
        super().__init__()
        inner = heads * dim_head
        self.norm = nn.GroupNorm(groups, in_ch, eps=1e-6)
        self.proj_in = nn.Linear(in_ch, inner)
        # diffusers TransformerTemporalModel: double_self_attention=True by
        # default — attn2/norm2 always exist (transformer_in included) and
        # SELF-attend; encoder states are never routed to temporal blocks.
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, heads, dim_head, cross_dim,
                                   double_self=double_self)])
        self.proj_out = nn.Linear(inner, in_ch)

    def forward(self, x, num_frames=1):
        bf, c, h, w = x.shape
        b = bf // num_frames
        residual = x
        hdn = x.reshape(b, num_frames, c, h, w).permute(0, 2, 1, 3, 4)
        hdn = self.norm(hdn)                       # stats across (F, H, W)
        hdn = hdn.permute(0, 3, 4, 2, 1).reshape(b * h * w, num_frames, c)
        hdn = self.proj_in(hdn)
        for blk in self.transformer_blocks:
            hdn = blk(hdn, None)
        hdn = self.proj_out(hdn)
        hdn = hdn.reshape(b, h, w, num_frames, c).permute(0, 3, 4, 1, 2)
        hdn = hdn.reshape(bf, c, h, w)
        return residual + hdn


class Downsample2D(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class _Block3D(nn.Module):
    """Shared body of CrossAttnDown/Up/DownBlock3D/UpBlock3D."""

    def __init__(self, layer_in_chs, out_ch, temb_dim, has_attn, heads_dim,
                 cross_dim, groups, n_temp_convs, sampler):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(ic, out_ch, temb_dim, groups) for ic in layer_in_chs])
        self.temp_convs = nn.ModuleList(
            [TemporalConvLayer(out_ch, n_temp_convs, groups) for _ in layer_in_chs])
        self.has_attn = has_attn
        if has_attn:
            heads = out_ch // heads_dim
            self.attentions = nn.ModuleList(
                [Transformer2DModel(out_ch, heads, heads_dim, cross_dim, groups)
                 for _ in layer_in_chs])
            self.temp_attentions = nn.ModuleList(
                [TransformerTemporalModel(heads, heads_dim, out_ch, cross_dim, groups)
                 for _ in layer_in_chs])
        self.downsamplers = self.upsamplers = None
        if sampler == "down":
            self.downsamplers = nn.ModuleList([Downsample2D(out_ch)])
        elif sampler == "up":
            self.upsamplers = nn.ModuleList([Upsample2D(out_ch)])

    def layer(self, i, x, temb, ehs, num_frames):
        x = self.resnets[i](x, temb)
        x = self.temp_convs[i](x, num_frames)
        if self.has_attn:
            x = self.attentions[i](x, ehs)
            x = self.temp_attentions[i](x, num_frames)
        return x


class UNetMidBlock3DCrossAttn(nn.Module):
    def __init__(self, ch, temb_dim, heads_dim, cross_dim, groups, n_temp_convs):
        super().__init__()
        heads = ch // heads_dim
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(ch, ch, temb_dim, groups) for _ in range(2)])
        self.temp_convs = nn.ModuleList(
            [TemporalConvLayer(ch, n_temp_convs, groups) for _ in range(2)])
        self.attentions = nn.ModuleList(
            [Transformer2DModel(ch, heads, heads_dim, cross_dim, groups)])
        self.temp_attentions = nn.ModuleList(
            [TransformerTemporalModel(heads, heads_dim, ch, cross_dim, groups)])

    def forward(self, x, temb, ehs, num_frames):
        x = self.resnets[0](x, temb)
        x = self.temp_convs[0](x, num_frames)
        x = self.attentions[0](x, ehs)
        x = self.temp_attentions[0](x, num_frames)
        x = self.resnets[1](x, temb)
        x = self.temp_convs[1](x, num_frames)
        return x


class UNet3DConditionModelRef(nn.Module):
    """Reference UNet3DConditionModel (inference semantics)."""

    def __init__(self, in_channels=4, out_channels=4,
                 block_out_channels=(32, 64), layers_per_block=1,
                 cross_levels=(True, False), head_dim=16, cross_dim=64,
                 groups=8, n_temp_convs=4):
        super().__init__()
        chs = block_out_channels
        L = len(chs)
        temb_dim = chs[0] * 4
        self.ch0 = chs[0]
        self.conv_in = nn.Conv2d(in_channels, chs[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(chs[0], temb_dim)
        self.transformer_in = TransformerTemporalModel(8, max(1, chs[0] // 8),
                                                       chs[0], None, groups)
        self.down_blocks = nn.ModuleList()
        for lvl in range(L):
            in_ch = chs[lvl - 1] if lvl > 0 else chs[0]
            layer_ins = [in_ch] + [chs[lvl]] * (layers_per_block - 1)
            self.down_blocks.append(_Block3D(
                layer_ins, chs[lvl], temb_dim, cross_levels[lvl], head_dim,
                cross_dim, groups, n_temp_convs,
                "down" if lvl < L - 1 else None))
        self.mid_block = UNetMidBlock3DCrossAttn(chs[-1], temb_dim, head_dim,
                                                 cross_dim, groups, n_temp_convs)
        self.up_blocks = nn.ModuleList()
        for u in range(L):
            lvl = L - 1 - u
            prev_out = chs[-1] if u == 0 else chs[lvl + 1]
            # skip channels per layer (reverse of the down-path pushes)
            skips = []
            for j in range(layers_per_block + 1):
                if j < layers_per_block:
                    skip_ch = chs[lvl]
                else:
                    skip_ch = chs[lvl - 1] if lvl > 0 else chs[0]
                skips.append(skip_ch)
            layer_ins = []
            cur = prev_out
            for j in range(layers_per_block + 1):
                layer_ins.append(cur + skips[j])
                cur = chs[lvl]
            self.up_blocks.append(_Block3D(
                layer_ins, chs[lvl], temb_dim, cross_levels[lvl], head_dim,
                cross_dim, groups, n_temp_convs, "up" if lvl > 0 else None))
        self.conv_norm_out = nn.GroupNorm(groups, chs[0], eps=1e-5)
        self.conv_out = nn.Conv2d(chs[0], out_channels, 3, padding=1)
        self.layers_per_block = layers_per_block

    def forward(self, sample, timestep, encoder_hidden_states):
        # sample: (B, C, F, H, W); timestep: (B,); ehs: (B, T, Dx)
        b, _, f, h, w = sample.shape
        temb = self.time_embedding(get_timestep_embedding(timestep, self.ch0))
        temb = temb.repeat_interleave(f, dim=0)
        ehs = encoder_hidden_states.repeat_interleave(f, dim=0)
        x = sample.permute(0, 2, 1, 3, 4).reshape(b * f, -1, h, w)
        x = self.conv_in(x)
        x = self.transformer_in(x, num_frames=f)
        res = [x]
        for blk in self.down_blocks:
            for i in range(len(blk.resnets)):
                x = blk.layer(i, x, temb, ehs, f)
                res.append(x)
            if blk.downsamplers is not None:
                x = blk.downsamplers[0](x)
                res.append(x)
        x = self.mid_block(x, temb, ehs, f)
        for blk in self.up_blocks:
            for i in range(len(blk.resnets)):
                x = torch.cat([x, res.pop()], dim=1)
                x = blk.layer(i, x, temb, ehs, f)
            if blk.upsamplers is not None:
                x = blk.upsamplers[0](x)
        x = self.conv_out(F.silu(self.conv_norm_out(x)))
        return x.reshape(b, f, -1, h, w).permute(0, 2, 1, 3, 4)


# --- VAE ----------------------------------------------------------------------


class VAEAttention(nn.Module):
    """AutoencoderKL mid-block attention (single head, residual)."""

    def __init__(self, ch, groups):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, ch, eps=1e-6)
        self.to_q = nn.Linear(ch, ch)
        self.to_k = nn.Linear(ch, ch)
        self.to_v = nn.Linear(ch, ch)
        self.to_out = nn.ModuleList([nn.Linear(ch, ch), nn.Dropout(0.0)])
        self.fp8 = False

    def forward(self, x):
        b, c, h, w = x.shape
        residual = x
        y = self.group_norm(x).reshape(b, c, h * w).transpose(1, 2)
        q, k, v = self.to_q(y), self.to_k(y), self.to_v(y)
        o = attention(q[:, None], k[:, None], v[:, None], self.fp8)[:, 0]
        o = self.to_out[0](o)
        return residual + o.transpose(1, 2).reshape(b, c, h, w)


class AutoencoderKLRef(nn.Module):
    """Decoder half (+ encoder) of AutoencoderKL with diffusers key names."""

    def __init__(self, latent_ch=4, block_out_channels=(16, 32),
                 layers_per_block=1, groups=4, mid_attention=False):
        super().__init__()
        chs = block_out_channels
        L = len(chs)
        self.mid_attention = mid_attention

        class Decoder(nn.Module):
            def __init__(self):
                super().__init__()
                self.conv_in = nn.Conv2d(latent_ch, chs[-1], 3, padding=1)
                mid = nn.Module()
                mid.resnets = nn.ModuleList(
                    [ResnetBlock2D(chs[-1], chs[-1], None, groups),
                     ResnetBlock2D(chs[-1], chs[-1], None, groups)])
                if mid_attention:
                    mid.attentions = nn.ModuleList([VAEAttention(chs[-1], groups)])
                self.mid_block = mid
                self.up_blocks = nn.ModuleList()
                prev = chs[-1]
                for u in range(L):
                    lvl = L - 1 - u
                    blk = nn.Module()
                    blk.resnets = nn.ModuleList()
                    for _ in range(layers_per_block + 1):
                        blk.resnets.append(ResnetBlock2D(prev, chs[lvl], None, groups))
                        prev = chs[lvl]
                    if lvl > 0:
                        blk.upsamplers = nn.ModuleList([Upsample2D(chs[lvl])])
                    else:
                        blk.upsamplers = None
                    self.up_blocks.append(blk)
                self.conv_norm_out = nn.GroupNorm(groups, chs[0], eps=1e-6)
                self.conv_out = nn.Conv2d(chs[0], 3, 3, padding=1)

        class Encoder(nn.Module):
            def __init__(self):
                super().__init__()
                self.conv_in = nn.Conv2d(3, chs[0], 3, padding=1)
                self.down_blocks = nn.ModuleList()
                prev = chs[0]
                for i in range(L):
                    blk = nn.Module()
                    blk.resnets = nn.ModuleList()
                    for _ in range(layers_per_block):
                        blk.resnets.append(ResnetBlock2D(prev, chs[i], None, groups))
                        prev = chs[i]
                    if i < L - 1:
                        blk.downsamplers = nn.ModuleList([Downsample2D(chs[i])])
                    else:
                        blk.downsamplers = None
                    self.down_blocks.append(blk)
                mid = nn.Module()
                mid.resnets = nn.ModuleList(
                    [ResnetBlock2D(chs[-1], chs[-1], None, groups),
                     ResnetBlock2D(chs[-1], chs[-1], None, groups)])
                if mid_attention:
                    mid.attentions = nn.ModuleList([VAEAttention(chs[-1], groups)])
                self.mid_block = mid
                self.conv_norm_out = nn.GroupNorm(groups, chs[-1], eps=1e-6)
                self.conv_out = nn.Conv2d(chs[-1], 2 * latent_ch, 3, padding=1)

        self.decoder = Decoder()
        self.encoder = Encoder()
        self.post_quant_conv = nn.Conv2d(latent_ch, latent_ch, 1)
        self.quant_conv = nn.Conv2d(2 * latent_ch, 2 * latent_ch, 1)

    def decode(self, z):
        x = self.post_quant_conv(z)
        d = self.decoder
        x = d.conv_in(x)
        x = d.mid_block.resnets[0](x)
        if self.mid_attention:
            x = d.mid_block.attentions[0](x)
        x = d.mid_block.resnets[1](x)
        for blk in d.up_blocks:
            for rn in blk.resnets:
                x = rn(x)
            if blk.upsamplers is not None:
                x = blk.upsamplers[0](x)
        return d.conv_out(F.silu(d.conv_norm_out(x)))

    def encode_mean(self, x):
        e = self.encoder
        x = e.conv_in(x)
        for blk in e.down_blocks:
            for rn in blk.resnets:
                x = rn(x)
            if blk.downsamplers is not None:
                x = blk.downsamplers[0](x)
        x = e.mid_block.resnets[0](x)
        if self.mid_attention:
            x = e.mid_block.attentions[0](x)
        x = e.mid_block.resnets[1](x)
        moments = self.quant_conv(e.conv_out(F.silu(e.conv_norm_out(x))))
        return moments[:, : moments.shape[1] // 2]


# --- DDIM scheduler (inference semantics, epsilon + v_prediction) -----------


class DDIMSchedulerRef:
    """diffusers.DDIMScheduler inference semantics as the reference system's
    miner configures it: scaled_linear
    betas, 'leading' spacing with steps_offset=1, set_alpha_to_one=False,
    eta=0 deterministic step. Also implements the v_prediction branch
    (CogVideoX-class models). Computed in float64 so the jax f32 tables are
    tested against a higher-precision independent derivation."""

    def __init__(self, num_train_timesteps=1000, beta_start=0.00085,
                 beta_end=0.012, beta_schedule="scaled_linear",
                 steps_offset=1, prediction_type="epsilon"):
        if beta_schedule == "scaled_linear":
            betas = torch.linspace(beta_start ** 0.5, beta_end ** 0.5,
                                   num_train_timesteps,
                                   dtype=torch.float64) ** 2
        elif beta_schedule == "linear":
            betas = torch.linspace(beta_start, beta_end, num_train_timesteps,
                                   dtype=torch.float64)
        else:
            raise ValueError(beta_schedule)
        self.alphas_cumprod = torch.cumprod(1.0 - betas, dim=0)
        # set_alpha_to_one=False (what Zeroscope ships)
        self.final_alpha_cumprod = self.alphas_cumprod[0]
        self.num_train_timesteps = num_train_timesteps
        self.steps_offset = steps_offset
        self.prediction_type = prediction_type
        self.timesteps = None
        self.num_inference_steps = None

    def set_timesteps(self, num_inference_steps):
        self.num_inference_steps = num_inference_steps
        step_ratio = self.num_train_timesteps // num_inference_steps
        ts = (torch.arange(num_inference_steps, dtype=torch.float64)
              * step_ratio).round().flip(0).long() + self.steps_offset
        self.timesteps = torch.clamp(ts, 0, self.num_train_timesteps - 1)

    def step(self, model_output, timestep, sample):
        """One eta=0 DDIM update; returns prev_sample (float32)."""
        t = int(timestep)
        prev_t = t - self.num_train_timesteps // self.num_inference_steps
        a_t = self.alphas_cumprod[t]
        a_prev = (self.alphas_cumprod[prev_t] if prev_t >= 0
                  else self.final_alpha_cumprod)
        b_t = 1.0 - a_t
        mo = model_output.double()
        x = sample.double()
        if self.prediction_type == "epsilon":
            pred_x0 = (x - b_t ** 0.5 * mo) / a_t ** 0.5
            pred_eps = mo
        elif self.prediction_type == "v_prediction":
            pred_x0 = a_t ** 0.5 * x - b_t ** 0.5 * mo
            pred_eps = a_t ** 0.5 * mo + b_t ** 0.5 * x
        else:
            raise ValueError(self.prediction_type)
        prev = a_prev ** 0.5 * pred_x0 + (1.0 - a_prev) ** 0.5 * pred_eps
        return prev.float()
