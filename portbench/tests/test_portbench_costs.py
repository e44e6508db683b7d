"""The yardstick's arithmetic against hand counts at small shapes."""

import json
import os

import pytest
import torch

from portbench import costs
from portbench.families import unet3d
from portbench.reference import torch_ref
from portbench.tests.conftest import HERE
from portbench.trace import busy_us, group_of, merged


def test_flash_and_groupnorm_costs():
    assert costs.flash_cost(2, 8, 3, 4) == (4.0 * 2 * 3 * 8 * 8 * 4, 4.0 * 2 * 8 * 3 * 4 * 2)
    flops, nbytes = costs.gn_cost(2, 10, 8, bias=True)
    assert flops == 8.0 * 2 * 10 * 8 and nbytes == 2.0 * 2 * 10 * 8 * 2 + 2 * 8 * 2 + 8 * 8


def test_bound_takes_the_slower_of_operations_and_bytes():
    ms, by = costs.bound_ms(989e12, 0.0)
    assert ms == pytest.approx(1e3) and by == "operations"
    ms, by = costs.bound_ms(0.0, 3.35e12)
    assert ms == pytest.approx(1e3) and by == "bytes"


def test_count_flops_attention_by_hand():
    attn = torch_ref.Attention(8, heads=2, dim_head=4, cross_dim=6)
    x, ctx = torch.zeros(1, 5, 8), torch.zeros(1, 3, 6)
    # to_q, to_out over 5 rows of 8 -> 8; to_k, to_v over 3 rows of 6 -> 8;
    # Q K^T and P V: 2 x 2 x (5 x 3 x 2 heads x 4)
    want = 2 * 5 * 8 * 8 * 2 + 2 * 3 * 6 * 8 * 2 + 4 * 5 * 3 * 2 * 4
    assert costs.count_flops(attn, lambda: attn(x, ctx), unet3d.ATTENTION) == want


def test_count_flops_temporal_conv_by_hand():
    layer = torch_ref.TemporalConvLayer(8, num_layers=2, groups=4)
    x = torch.zeros(4, 8, 2, 2)  # 4 frames of 8 channels at 2x2
    # two (3, 1, 1) convolutions over 4 x 2 x 2 outputs of 8 channels
    assert costs.count_flops(layer, lambda: layer(x, num_frames=4),
                             unet3d.ATTENTION) == 2 * (2 * 3 * 8 * 8 * 16)


def test_model_flops_of_the_tiny_text_tower_and_frame_by_hand():
    with open(os.path.join(HERE, "tiny.json")) as f:
        cfg = json.load(f)
    got = unet3d.model_flops(cfg)
    # text: 2 layers, 16 rows: q, k, v, out (64 -> 64), fc1 (64 -> 128),
    # fc2 (128 -> 64), and causal-free counted attention 4 x 16 x 16 x 64
    layer = 2 * 16 * (4 * 64 * 64 + 2 * 64 * 128) + 4 * 16 * 16 * 64
    assert got["text_rows"] == 2 * layer
    # frame: the 16x16 latent decoded to 32x32: post_quant_conv, conv_in, two
    # mid resnets, the level-1 block's two resnets and upsampling conv, the
    # level-0 block's two resnets (the first with its 1x1 shortcut), conv_out
    conv = lambda k, cin, cout, px: 2 * k * k * cin * cout * px  # noqa: E731
    frame = (conv(1, 4, 4, 256) + conv(3, 4, 32, 256) + 4 * conv(3, 32, 32, 256)
             + 4 * conv(3, 32, 32, 256) + conv(3, 32, 32, 1024)
             + conv(3, 32, 16, 1024) + conv(3, 16, 16, 1024) + conv(1, 32, 16, 1024)
             + 2 * conv(3, 16, 16, 1024) + conv(3, 16, 3, 1024))
    assert got["frames"] == frame == 82_747_392
    assert got["unet_rows"] > 0


def test_trace_arithmetic():
    assert busy_us([(0, 2), (1, 3), (5, 6)]) == 4
    assert merged([(5, 6), (0, 2), (1, 3)]) == [(0, 3), (5, 6)]
    assert group_of("void flash_fwd_kernel<...>") == "flash_attention"
    assert group_of("sm90_xmma_fprop_implicit_gemm") == "convolution"
    assert group_of("gn_fused<...>") == "group_norm_act"
    assert group_of("vectorized_elementwise_kernel") == "other"
