"""The step profile's grouping of device kernels by name
(``dvdx_tpu_torch.utils.profile_step.group_of``), on kernel names as the
profiler reports them on the card: each of the port's kernels lands in its
own group, the GEGLU products of the fused kernels in their fused kernel's
group, and library kernels in theirs."""

import pytest

from dvdx_tpu_torch.utils.profile_step import group_of


@pytest.mark.parametrize("name,group", [
    ("void dvdx::geglu_stage<(anonymous namespace)::geglu_ff_site, 128, 2>"
     "(CUtensorMap_st, CUtensorMap_st, dvdx::FfEpilogue, int, int, int, int)", "geglu_ff"),
    ("void dvdx::geglu_stage<(anonymous namespace)::geglu_ff_site, 256, 1>"
     "(CUtensorMap_st, CUtensorMap_st, dvdx::FfEpilogue, int, int, int, int)", "geglu_ff"),
    ("void dvdx::geglu_stage<(anonymous namespace)::spatial_tail_ff, 160, 1>"
     "(CUtensorMap_st, CUtensorMap_st, dvdx::FfEpilogue, int, int, int, int)",
     "fused_spatial_tail"),
    ("(anonymous namespace)::spatial_tail_chain(__nv_bfloat16 const*, __nv_bfloat16 const*)",
     "fused_spatial_tail"),
    ("void dvdx::geglu_stage<(anonymous namespace)::temporal_block_ff, 128, 2>"
     "(CUtensorMap_st, CUtensorMap_st, dvdx::FfEpilogue, int, int, int, int)",
     "fused_temporal_block"),
    ("(anonymous namespace)::temporal_block_chain(__nv_bfloat16 const*, "
     "(anonymous namespace)::AttnWeights)", "fused_temporal_block"),
    ("void (anonymous namespace)::flash_fwd_tma<64>(CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, __nv_bfloat16*, int, int, int, int)", "flash_attention"),
    ("(anonymous namespace)::gn_apply(__nv_bfloat16 const*, __nv_bfloat16 const*)",
     "group_norm_act"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize256x128x64",
     "convolution"),
    ("nvjet_tst_320x128_64x3_1x2_h_bz_coopB_TNT", "matmul"),
    ("void at::native::vectorized_elementwise_kernel<8, at::native::FillFunctor<c10::BFloat16>",
     "other"),
])
def test_kernel_names_land_in_their_groups(name, group):
    assert group_of(name) == group
