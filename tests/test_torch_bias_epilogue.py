"""The bias (+ residual) epilogue of the port's convolutions and dense layers
(``ops/kernels/bias_epilogue.py``), on the CPU.

The plain version is ATen's two adds, bit for bit; the gate refuses what the
kernel does not take; the UNet and the VAE, which now hand each residual to
the layer before it, compute the same bits as the same modules with the
residual adds written out after the layers; and the number of epilogue
calls a UNet call makes is pinned, at the test model's scale and at the full
zeroscope architecture (on the meta device), where ``chip_smoke.py`` holds
the card's launch counter to it. The kernel itself is held to the plain
version on the card by ``tests/test_torch_cuda_kernels.py``.
"""

import os
import runpy

import pytest
import torch
import torch.nn.functional as F

from dvdx_tpu_torch.models import layers, unet3d
from dvdx_tpu_torch.models import vae as vae_mod
from dvdx_tpu_torch.models.zoo import get_model_spec
from dvdx_tpu_torch.ops.kernels import bias_epilogue as be
from dvdx_tpu_torch.ops.kernels import launch_counters

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = [torch.float32, torch.bfloat16]


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("residual", [False, True])
def test_plain_is_atens_adds(dtype, residual):
    g = torch.Generator().manual_seed(0)
    y = (torch.randn(6, 5, 40, generator=g) * 3).to(dtype)
    b = torch.randn(40, generator=g).to(dtype)
    r = torch.randn(6, 5, 40, generator=g).to(dtype) if residual else None
    want = y + b if r is None else r + (y + b)
    got = be.bias_epilogue(y.clone(), b, r)
    assert _equal(got, want)
    # the plain version writes into the product, as the kernel does
    y0 = y.clone()
    plain = be.bias_epilogue_plain(y0, b, r)
    assert plain.data_ptr() == y0.data_ptr() and _equal(plain, want)


def _gate_case(name):
    g = torch.Generator().manual_seed(1)
    y = torch.randn(4, 6, 32, generator=g).bfloat16()
    b = torch.randn(32, generator=g).bfloat16()
    r = torch.randn(4, 6, 32, generator=g).bfloat16()
    if name == "c_not_multiple_of_8":
        y, b, r = y[..., :28].contiguous(), b[:28].contiguous(), r[..., :28].contiguous()
    elif name == "y_not_contiguous":
        y = y.transpose(0, 1)
        r = r.transpose(0, 1).contiguous()
    elif name == "residual_not_contiguous":
        r = r.transpose(0, 1).contiguous().transpose(0, 1)
    elif name == "residual_other_shape":
        r = r[:2]
    elif name == "residual_other_dtype":
        r = r.float()
    elif name == "bias_other_dtype":
        b = b.float()
    elif name == "bias_other_width":
        b = torch.cat([b, b])
    elif name == "y_misaligned":
        y = torch.randn(4 * 6 * 32 + 4, generator=g).bfloat16()[4:].view(4, 6, 32)
    elif name == "float16":
        y, b, r = y.half(), b.half(), r.half()
    elif name == "records_a_gradient":
        y = y.float().requires_grad_()
        b, r = b.float(), r.float()
    return y, b, r


@pytest.mark.parametrize("name,takes", [
    ("takes", True), ("c_not_multiple_of_8", False), ("y_not_contiguous", False),
    ("residual_not_contiguous", False), ("residual_other_shape", False),
    ("residual_other_dtype", False), ("bias_other_dtype", False),
    ("bias_other_width", False), ("y_misaligned", False), ("float16", False),
    ("records_a_gradient", False)])
def test_gate(name, takes):
    """The gate reads only what the tensors show (``bias_epilogue`` asks
    besides whether y lies on the card, so every CPU tensor takes the plain
    version)."""
    y, b, r = _gate_case(name)
    assert (be._launch_args(y, b, r) is not None) is takes
    if name == "takes":
        assert be._launch_args(y, b, None) is not None
    if name not in ("residual_other_shape", "bias_other_width", "bias_other_dtype"):
        # ATen's adds, whatever the gate said, written into y in y's dtype (a
        # bias or a residual of another shape, or a bias of another dtype,
        # lies outside the wrapper's contract)
        with torch.no_grad():
            want = (r + (y + b)).to(y.dtype)
            assert torch.equal(be.bias_epilogue(y.detach().clone(), b, r), want)


def test_launch_counters_name_the_epilogue():
    counters = launch_counters()
    assert counters["bias_epilogue"] == (be, "LAUNCHES")
    assert counters["bias_epilogue_f32"] == (be, "F32_LAUNCHES")


# --- the layers: residuals handed to the layer before them ------------------

def _old_dense(self, x):
    y = F.linear(x, self.weight.to(x.dtype))
    if self.bias is not None:
        y = y + self.bias.to(x.dtype)
    return y


def _old_conv(self, x, padding=None):
    y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype), None,
                 self.stride, self.padding if padding is None else padding)
    y = y.permute(0, 2, 3, 1)
    if self.bias is not None:
        y = y + self.bias.to(x.dtype)
    return y


def _old_resnet(self, x, temb):
    h = self.conv1(self.norm1(x))
    t = self.time_emb_proj(F.silu(temb))
    h = self.conv2(self.norm2(h, bias=t))
    residual = x if self.conv_shortcut is None else self.conv_shortcut(x)
    return residual + h


def _old_temporal_conv(self, x):
    b, f, hh, ww, c = x.shape
    h = x.reshape(b, f, hh * ww, c)
    for i in range(self.num_layers):
        last = i == self.num_layers - 1
        h = getattr(self, f"norm{i}").over_frames(h)
        h = getattr(self, f"conv{i}_zero" if last else f"conv{i}")(h)
    return x + h.reshape(x.shape)


def _old_attention(self, x, context=None):
    return self.to_out(self.attend(x, context))


def _old_basic_block(self, x, context):
    assert not self.fused(x, context)
    x = x + self.attn1(self.norm1(x))
    x = x + self.attn2(self.norm2(x), context)
    return x + self.ff(self.norm3(x))


def _old_spatial_transformer(self, x, context):
    n, hh, ww, c = x.shape
    h = self.proj_in(self.norm(x).reshape(n, hh * ww, c))
    h = self.proj_out_zero(self.block0(h, context))
    return x + h.reshape(x.shape)


def _old_frame_axis_attention(self, x):
    attend = (layers.temporal_attention
              if layers.temporal_attention_wants(x.shape[1], self.to_q.out_features // self.heads)
              else layers.temporal_attention_plain)
    return self.to_out(attend(self.to_q(x), self.to_k(x), self.to_v(x), heads=self.heads))


def _old_temporal_block(self, x):
    assert not self.fused(x)
    x = x + self.attn1(self.norm1(x))
    x = x + self.attn2(self.norm2(x))
    return x + self.ff(self.norm3(x))


def _old_transformer_temporal(self, x, frame_positions=None):
    b, f, hh, ww, c = x.shape
    h = self.norm.over_frames(x).reshape(b, f, hh * ww, c)
    h = self.proj_out_zero(self.block0(self.proj_in(h)))
    return x + h.reshape(x.shape)


def _old_vae_resnet(self, x):
    h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
    return (x if self.shortcut is None else self.shortcut(x)) + h


def _old_vae_attention(self, x):
    n, hh, ww, c = x.shape
    y = self.norm(x).reshape(n, hh * ww, 1, c)
    o = vae_mod.multi_head_attention(self.q(y), self.k(y), self.v(y))
    return x + self.proj(o).reshape(x.shape)


OLD_FORWARDS = (
    (layers.Dense, _old_dense), (layers.Conv, _old_conv), (layers.ResnetBlock2D, _old_resnet),
    (layers.TemporalConvBlock, _old_temporal_conv), (layers.Attention, _old_attention),
    (layers.BasicTransformerBlock, _old_basic_block),
    (layers.SpatialTransformer, _old_spatial_transformer),
    (layers._FrameAxisAttention, _old_frame_axis_attention),
    (layers._TemporalBlock, _old_temporal_block),
    (layers.TransformerTemporal, _old_transformer_temporal),
    (vae_mod._VAEResnet, _old_vae_resnet), (vae_mod._VAEAttention, _old_vae_attention))


class _Recorder:
    """Stands in for ``layers.bias_epilogue``: counts the calls with and
    without a residual, and those whose layout the kernel's gate takes."""

    def __init__(self, gate=lambda y, bias, residual: be._launch_args(y, bias, residual)
                 is not None):
        self.gate, self.calls = gate, {"bias": 0, "residual": 0, "taken": 0}

    def __call__(self, y, bias, residual=None):
        self.calls["bias" if residual is None else "residual"] += 1
        self.calls["taken"] += bool(self.gate(y, bias, residual))
        return be.bias_epilogue_plain(y, bias, residual)


def _tiny_unet_call(dtype):
    torch.manual_seed(0)
    unet = unet3d.UNet3D(get_model_spec("zeroscope-tiny-hf").unet).to(dtype)
    g = torch.Generator().manual_seed(3)
    z = torch.randn(2, 4, 8, 8, 4, generator=g)
    hidden = torch.randn(2, 77, 64, generator=g)
    with torch.inference_mode():
        return unet(z, torch.tensor([500, 20]), hidden)


def _vae_frame(dtype):
    torch.manual_seed(0)
    cfg = vae_mod.VAEConfig(base_channels=16, channel_mults=(1, 2), layers_per_block=1,
                            norm_groups=4, use_mid_attention=True, dtype="float32")
    dec = vae_mod.VAEDecoder(cfg).to(dtype)
    z = torch.randn(1, 6, 8, 4, generator=torch.Generator().manual_seed(4))
    with torch.inference_mode():
        return dec(z)


# epilogue calls of one zeroscope-tiny-hf UNet call (levels of C = 32 and 64,
# one resnet a block, 4-layer temporal convs; at 8x8 latents no fused block
# or tail takes C = 32): bias alone in the time embedding (2), conv_in,
# transformer_in's proj_in, each of the 8 level blocks' conv1, time_emb_proj
# and first three temporal convs (40), the 5 shortcuts, the 4 attention
# blocks' two proj_in (8), the down and up convs (2) and conv_out_zero; a
# residual in transformer_in (its two to_out and proj_out: 3), each block's
# conv2 and last temporal conv (16), and each attention block's two
# transformers (6 each: 24); conv_out_zero's C = 4 refused
TINY_CALLS = {"bias": 60, "residual": 43, "taken": 102}
# one frame of the test VAE with the mid-block attention: bias alone in
# post_quant_conv, conv_in, the 6 resnets' conv1, q / k / v, the one
# shortcut, the up conv and conv_out; a residual in the 6 resnets' conv2 and
# the attention's proj; post_quant_conv (C = 4) and conv_out (C = 3) refused
VAE_CALLS = {"bias": 14, "residual": 7, "taken": 19}


@pytest.mark.parametrize("dtype", DTYPES)
def test_unet_call_matches_the_residual_adds_written_out(dtype, monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(layers, "bias_epilogue", rec)
    new = _tiny_unet_call(dtype)
    assert rec.calls == TINY_CALLS
    with monkeypatch.context() as m:
        for cls, fn in OLD_FORWARDS:
            m.setattr(cls, "forward", fn)
        old = _tiny_unet_call(dtype)
    assert _equal(new, old)


@pytest.mark.parametrize("dtype", DTYPES)
def test_vae_frame_matches_the_residual_adds_written_out(dtype, monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(layers, "bias_epilogue", rec)
    new = _vae_frame(dtype)
    assert rec.calls == VAE_CALLS
    with monkeypatch.context() as m:
        for cls, fn in OLD_FORWARDS:
            m.setattr(cls, "forward", fn)
        old = _vae_frame(dtype)
    assert _equal(new, old)


@pytest.fixture(scope="module")
def chip_smoke():
    return runpy.run_path(os.path.join(REPO, "chip_smoke.py"), run_name="chip_smoke")


def _shapes_only(x, *args, **kwargs):
    return x


@pytest.mark.parametrize("model,geometry", [
    ("zeroscope-v2-576w", (2, 16, 40, 72)), ("zeroscope-v2-xl", (1, 24, 72, 128))])
def test_epilogue_calls_at_full_architecture(model, geometry, monkeypatch, chip_smoke):
    """One UNet call of the full architecture on the meta device (shapes
    only; every other kernel wrapper passes its input through): 166 calls
    without a residual and 121 with one, all but conv_out_zero's (C = 4) of
    a width the kernel takes. Meta tensors do not carry cuDNN's channels-last
    output layout, so the count reads the gate's width rule; the card's
    launch counter, held to ``chip_smoke.EPILOGUE_PER_UNET_CALL`` in phases
    4 and 7, reads its layouts."""
    rec = _Recorder(gate=lambda y, bias, residual: y.shape[-1] % 8 == 0)
    monkeypatch.setattr(layers, "bias_epilogue", rec)
    for name in ("group_norm_act", "geglu_ff", "fused_spatial_tail", "fused_temporal_block",
                 "temporal_attention", "temporal_attention_plain"):
        monkeypatch.setattr(layers, name, _shapes_only)
    monkeypatch.setattr(layers, "multi_head_attention", _shapes_only)
    b, f, h, w = geometry
    with torch.device("meta"):
        unet = unet3d.UNet3D(get_model_spec(model).unet).to(torch.bfloat16)
    with torch.inference_mode():
        out = unet(torch.empty(b, f, h, w, 4, device="meta"),
                   torch.zeros(b, dtype=torch.long, device="meta"),
                   torch.empty(b, 77, 1024, device="meta"))
    assert out.shape == (b, f, h, w, 4)
    assert rec.calls == {"bias": 167, "residual": 121, "taken": 287}
    assert chip_smoke["EPILOGUE_PER_UNET_CALL"] == rec.calls["taken"]
