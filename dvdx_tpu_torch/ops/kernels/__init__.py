"""Wrappers of the hand-written CUDA kernels, each beside its plain version.

Each wrapper adds one to a module-level counter where it launches its kernel
(and nowhere else); ``launch_counters`` names them all.
"""


def launch_counters() -> dict:
    """{kernel: (module, name of its launch counter)} for every kernel."""
    from .. import groupnorm as gn
    from . import bias_epilogue as be
    from . import dit_epilogue as de
    from . import flash_attention as fa
    from . import geglu_ff as gf
    from . import qk_norm_rope as qk
    from . import spatial_tail as st
    from . import temporal_attention as ta
    from . import temporal_block as tb

    return {"flash_attention": (fa, "LAUNCHES"), "temporal_attention": (ta, "LAUNCHES"),
            "geglu_ff": (gf, "LAUNCHES"), "group_norm_act": (gn, "LAUNCHES"),
            "flash_attention_mh": (fa, "MH_LAUNCHES"),
            "fused_spatial_tail": (st, "LAUNCHES"),
            "fused_temporal_block": (tb, "LAUNCHES"),
            "group_norm_act_f32": (gn, "F32_LAUNCHES"), "geglu_ff_simt": (gf, "SIMT_LAUNCHES"),
            "group_norm_moments_out": (gn, "MOMENTS_OUT_LAUNCHES"),
            "group_norm_moments_in": (gn, "MOMENTS_IN_LAUNCHES"),
            "flash_attention_f32": (fa, "F32_LAUNCHES"),
            "temporal_attention_f32": (ta, "F32_LAUNCHES"),
            "fused_spatial_tail_f32": (st, "F32_LAUNCHES"),
            "fused_temporal_block_f32": (tb, "F32_LAUNCHES"),
            "bias_epilogue": (be, "LAUNCHES"), "bias_epilogue_f32": (be, "F32_LAUNCHES"),
            "qk_norm_rope": (qk, "LAUNCHES"), "bias_gelu": (de, "LAUNCHES"),
            "gated_residual": (de, "GATED_LAUNCHES")}


def launch_counts() -> dict:
    """{kernel: launches since the counters were last reset}."""
    return {k: getattr(m, a) for k, (m, a) in launch_counters().items()}


def reset_launch_counts() -> None:
    for m, a in launch_counters().values():
        setattr(m, a, 0)
