"""The step profile's grouping of device kernels by name
(``dvdx_tpu_torch.utils.profile_step.group_of``), on kernel names as the
profiler reports them on the card: each of the port's kernels lands in its
own group, the GEGLU products of the fused kernels in their fused kernel's
group beside its chain, GroupNorm's kernels (the one-device kernel and the
frame-sharded entries' moments-out and moments-in) in GroupNorm's (and no
ATen kernel whose name merely contains "gn_"), the bias epilogue in its own,
and library kernels in theirs."""

import pytest

from dvdx_tpu_torch.utils.profile_step import group_of

# the bias epilogue's two instances as the profiler names them
EPILOGUE_NAMES = (
    "void dvdx::(anonymous namespace)::bias_epilogue_rows<__nv_bfloat16, true>(__nv_bfloat16*, "
    "__nv_bfloat16 const*, __nv_bfloat16 const*, long long, int, int, int)",
    "void dvdx::(anonymous namespace)::bias_epilogue_rows<float, false>(float*, float const*, "
    "float const*, long long, int, int, int)")


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
    ("void (anonymous namespace)::gn_moments<__nv_bfloat16>(__nv_bfloat16 const*, double*, "
     "double*, int, int, int, int, int, int)", "group_norm_act"),
    ("void (anonymous namespace)::gn_apply<float>(float const*, float const*, float const*, "
     "float const*, float const*, float*, int, int, int, int, int, int, float, int)",
     "group_norm_act"),
    ("void at::native::(anonymous namespace)::RowwiseMomentsCUDAKernel<float, float>"
     "(long, float, float const*, float*, float*)", "other"),
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
    ("dvdx::(anonymous namespace)::qk_norm_rope_rows(dvdx::(anonymous namespace)::QkArgs)",
     "qk_norm_rope"),
    ("void dvdx::(anonymous namespace)::bias_gelu_rows(__nv_bfloat16*, __nv_bfloat16 const*, "
     "long long, int)", "dit_epilogue"),
    ("void dvdx::(anonymous namespace)::gated_residual_rows(__nv_bfloat16*, __nv_bfloat16 "
     "const*, __nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 const*, long long, "
     "long long, int, int, int)", "dit_epilogue"),
] + [(name, "bias_epilogue") for name in EPILOGUE_NAMES])
def test_kernel_names_land_in_their_groups(name, group):
    assert group_of(name) == group


@pytest.mark.parametrize("name", EPILOGUE_NAMES)
def test_benchmark_counts_the_epilogue_as_no_named_kernel(name):
    """The benchmark's own copy of the grouping (``portbench/trace.py``)
    finds none of its fragments in the epilogue's name: not a convolution,
    not a product, not one of the six model-path kernels."""
    from portbench.trace import group_of as bench_group_of

    assert bench_group_of(name) == "other"


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
