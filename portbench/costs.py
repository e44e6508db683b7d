"""The yardstick's arithmetic: the H100's peaks, each bf16 model-path
kernel's least time from the shapes handed to it, the launch-bound hooks,
and the model FLOPs of the plain reference's work.

The cost functions, ``bound_ms`` and ``launch_bounds`` are copied from the
repository's ``chip_smoke.py`` (which this benchmark does not import): each
input is read once and each output written once, bf16 activations and
weights. ``count_flops`` counts on the plain reference (each family's
``model_flops`` runs it on the meta device): 2 x the multiply-adds of every
convolution and linear layer, plus Q K^T and P V of every attention, at the
shapes each module is handed.
"""

from __future__ import annotations

import math

import torch

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 bytes per second
# the six bf16 model-path kernels, by their launch counters' names
MODEL_PATH = ("flash_attention", "temporal_attention", "geglu_ff", "group_norm_act",
              "fused_spatial_tail", "fused_temporal_block")


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


# (flops, bytes) of one launch: each input read once, each output written
# once, bf16 activations and weights
def flash_cost(b, s, h, d):
    return 4.0 * b * h * s * s * d, 4.0 * b * s * h * d * 2


def temporal_cost(b, f, n, h, d):
    return 4.0 * b * n * h * f * f * d, 4.0 * b * f * n * h * d * 2


def geglu_cost(t, c, inner):
    return 6.0 * t * c * inner, (2.0 * t * c + 3.0 * c * inner + 2 * inner + c) * 2


def spatial_tail_cost(rows, c, hd1, hd, t, n):
    flops = 2.0 * rows * (3 * hd * c + 2 * t * hd + 12 * c * c)
    weights = 3 * hd * c + 12 * c * c + 13 * c  # matrices, biases, LN vectors
    return flops, (rows * (2 * c + hd1) + weights + 2 * n * t * hd) * 2.0


def temporal_block_cost(rows, f, c):
    # the whole block as one function: x read, out written, weights once
    flops = 2.0 * rows * (8 * c * c + 4 * f * c + 12 * c * c)
    return flops, (2 * rows * c + 20 * c * c + 15 * c) * 2.0


def gn_cost(n, l, c, bias, elem=2):
    # x read, y written and the (N, C) bias, of elem bytes each; gamma and
    # beta (f32)
    return 8.0 * n * l * c, 2.0 * n * l * c * elem + (n * c * elem if bias else 0) + 8 * c


def launch_bounds(module, run):
    """Run ``run()`` with forward hooks on the layers of ``module`` that hand
    work to a kernel, and sum each kernel's launches and bound from the
    shapes handed to it: {kernel: {"launches": n, "bound_ms": t}}. Each
    hook's count must equal its kernel's own launch counter over the run."""
    from dvdx_tpu_torch.models import layers
    from dvdx_tpu_torch.ops.attention import wants_flash
    from dvdx_tpu_torch.ops.kernels import launch_counts

    acc = {k: [0, 0.0] for k in MODEL_PATH}

    def add(name, cost):
        acc[name][0] += 1
        acc[name][1] += bound_ms(*cost)[0]

    def on_gn(mod, args, kwargs, out):
        x, c = args[0], args[0].shape[-1]
        bias = kwargs.get("bias", args[1] if len(args) > 1 else None)
        add("group_norm_act", gn_cost(x.shape[0], x[0].numel() // c, c, bias is not None))

    def on_ff(mod, args, kwargs, out):
        c = args[0].shape[-1]
        add("geglu_ff", geglu_cost(args[0].numel() // c, c, mod.proj_out.in_features))

    def on_frame_attn(mod, args, kwargs, out):
        b, f, n = args[0].shape[:3]
        d = mod.to_q.out_features // mod.heads
        if layers.temporal_attention_wants(f, d):
            add("temporal_attention", temporal_cost(b, f, n, mod.heads, d))

    def on_attn(mod, args, kwargs, out):
        x = args[0]
        ctx = kwargs.get("context", args[1] if len(args) > 1 else None)
        s = x.shape[1]
        if wants_flash(s, s if ctx is None else ctx.shape[1], mod.head_dim):
            add("flash_attention", flash_cost(x.shape[0], s, mod.heads, mod.head_dim))

    def on_block(mod, args, kwargs, out):
        # the fused tail calls attn1.attend, not its forward
        x, ctx = args[0], kwargs.get("context", args[1] if len(args) > 1 else None)
        if not mod.fused(x, ctx):
            return
        n, s, c = x.shape
        a1 = mod.attn1
        if wants_flash(s, s, a1.head_dim):
            add("flash_attention", flash_cost(n, s, a1.heads, a1.head_dim))
        hd = mod.attn2.to_q.out_features
        add("fused_spatial_tail", spatial_tail_cost(n * s, c, a1.heads * a1.head_dim,
                                                    hd, ctx.shape[1], n))

    def on_temporal_block(mod, args, kwargs, out):
        x = args[0]
        if mod.fused(x):
            rows, f, c = x[..., 0].numel(), x.shape[1], x.shape[-1]
            add("fused_temporal_block", temporal_block_cost(rows, f, c))

    hooks = ((layers.GroupNorm, on_gn), (layers.GEGLUFeedForward, on_ff),
             (layers._FrameAxisAttention, on_frame_attn), (layers.Attention, on_attn),
             (layers.BasicTransformerBlock, on_block),
             (layers._TemporalBlock, on_temporal_block))
    handles = [m.register_forward_hook(fn, with_kwargs=True)
               for m in module.modules() for cls, fn in hooks if isinstance(m, cls)]
    before = launch_counts()
    try:
        run()
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    after = launch_counts()
    for k, (n, _) in acc.items():
        if after[k] - before[k] != n:
            raise AssertionError(f"{k}: {after[k] - before[k]} launches, "
                                 f"{n} seen by the bound's hooks")
    return {k: {"launches": n, "bound_ms": ms} for k, (n, ms) in acc.items()}


def count_flops(module: torch.nn.Module, run, attention=()) -> float:
    """Model FLOPs of ``run()`` over a plain reference ``module``: 2 x the
    multiply-adds of every linear and convolution layer, plus, for each
    ``(attention class, fn)`` of ``attention``, ``fn(mod, args, kwargs)``
    (Q K^T and P V) of every such module, from the shapes each is handed."""
    total = [0.0]

    def on_linear(mod, args, out):
        total[0] += 2.0 * mod.in_features * out.numel()

    def on_conv(mod, args, out):
        total[0] += 2.0 * math.prod(mod.kernel_size) * mod.in_channels // mod.groups * out.numel()

    def on_attention(fn):
        def hook(mod, args, kwargs, out):
            total[0] += fn(mod, args, kwargs)
        return hook

    kinds = [(torch.nn.Linear, on_linear, False), (torch.nn.Conv2d, on_conv, False),
             (torch.nn.Conv3d, on_conv, False)]
    kinds += [(cls, on_attention(fn), True) for cls, fn in attention]
    handles = [sub.register_forward_hook(fn, with_kwargs=kw)
               for sub in module.modules() for cls, fn, kw in kinds if isinstance(sub, cls)]
    try:
        run()
    finally:
        for h in handles:
            h.remove()
    return total[0]
