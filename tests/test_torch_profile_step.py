"""The step profile's grouping of device kernels by name
(``dvdx_tpu_torch.utils.profile_step.group_of``), on kernel names as the
profiler reports them on the card: each of the port's kernels lands in its
own group, the GEGLU products of the fused kernels in their fused kernel's
group beside its chain, the one GroupNorm kernel in GroupNorm's (and no ATen
kernel whose name merely contains "gn_"), and library kernels in theirs."""

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
    ("(anonymous namespace)::gn_fused((anonymous namespace)::GnArgs)", "group_norm_act"),
    ("void (anonymous namespace)::temporal_block_chain<320>((anonymous namespace)::ChainMaps, "
     "(anonymous namespace)::ChainVecs, __nv_bfloat16 const*, __nv_bfloat16*, __nv_bfloat16*, "
     "(anonymous namespace)::ChainShape)", "fused_temporal_block"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::sign_kernel_cuda"
     "(at::TensorIteratorBase&)::{lambda()#1}>", "other"),
    ("void at::native::unrolled_elementwise_kernel<at::native::copy_assign_functor>", "other"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize256x128x64",
     "convolution"),
    ("nvjet_tst_320x128_64x3_1x2_h_bz_coopB_TNT", "matmul"),
    ("void at::native::vectorized_elementwise_kernel<8, at::native::FillFunctor<c10::BFloat16>",
     "other"),
])
def test_kernel_names_land_in_their_groups(name, group):
    assert group_of(name) == group


def test_kernel_probe_instruments_the_current_sources():
    """``utils.kernel_probe`` adds clock reads to copies of the chain and
    GroupNorm sources by text: every phase boundary it reads is still where
    it expects it (six chain phases, the two grid barriers)."""
    from dvdx_tpu_torch.ops import _build
    from dvdx_tpu_torch.utils import kernel_probe

    chain = kernel_probe._instrument_chain((_build.CSRC / "temporal_block.cu").read_text())
    norm = kernel_probe._instrument_gn((_build.CSRC / "groupnorm.cu").read_text())
    assert sorted({int(chain[i + 6]) for i in range(len(chain))
                   if chain.startswith("PROBE(", i) and chain[i + 6].isdigit()}) == list(range(6))
    assert norm.count("  PROBE;\n") == 6 and "dvdx_probe_read" in chain + norm
