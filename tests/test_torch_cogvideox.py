"""The published CogVideoX-5B on the port (``cogvideox-tiny-hf`` at CPU scale)
against the benchmark's plain float32 reference (``portbench/reference/
cogvideox.py``), both on the same seeded random weights under the published
key names, loaded into the port through its converters; then the family
through ``generate``, ``StepEngine`` and a miner / validator round.

Tolerances: port and reference compute the same float32 functions in other
orders (fused multiply-adds for the modulations and gates, a float32 norm
and rotation of q and k in one pass, the flash path's plain version, a
fused q/k/v product): the transformer's output within 1e-5 of its RMS
(measured below 1e-6), a block's within 1e-5, the T5 encoder's within 1e-5
(measured below 1e-6); the rotary tables are the same float32 operations on
the same positions, so equal bit for bit; the schedule's alpha-bar is a
float64 derivation stored as float32 against the reference's float32
derivation: within 2e-6 absolute (measured 2.4e-7), the last timestep's
exactly 0 in both; the DDIM update within 4e-6 of max |z| (the v step's
fused multiply-adds against the reference's a * z + b * x0). The
tightness test shows that swapping the text and video modulations, or
skipping the QK-norm, moves the output by orders of magnitude more than
these tolerances.
"""

import asyncio
import json
import math

import numpy as np
import pytest
import torch

from dvdx_tpu_torch.models import cogvideox as port_cog
from dvdx_tpu_torch.models.t5 import T5Encoder, relative_position_bucket, tiny_t5_config
from dvdx_tpu_torch.models.zoo import get_model_spec
from dvdx_tpu_torch.network.mock import build_mock_network
from dvdx_tpu_torch.network.validator import ValidatorConfig
from dvdx_tpu_torch.ops.scheduler import ddim_step
from dvdx_tpu_torch.pipelines.text2video import build_pipeline, empty_pipeline, generate
from dvdx_tpu_torch.utils.bridge import load_jax_params
from dvdx_tpu_torch.utils.convert import (convert_cogvideox_transformer, convert_t5_encoder,
                                          spec_from_diffusers_configs)
from dvdx_tpu_torch.verify.spotcheck import StepEngine, verify_revealed_steps
from portbench.reference import cogvideox as ref

torch.set_num_threads(2)

TINY = get_model_spec("cogvideox-tiny-hf")
PROMPT = "a lighthouse in a storm"
REL = 1e-5


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt())


def _seeded(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Every parameter drawn as a checkpoint's would be spread (the
    benchmark's spread: kernels N(0, 1 / fan_in), norm scales near 1, small
    biases, tables N(0, 1))."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            x = torch.randn(p.shape, generator=gen)
            if name.endswith(("shared.weight", "relative_attention_bias.weight")):
                p.copy_(x)
            elif p.dim() >= 2:
                p.copy_(x / math.sqrt(math.prod(p.shape[1:])))
            elif name.endswith("weight"):
                p.copy_(1 + 0.05 * x)
            else:
                p.copy_(0.05 * x)
    return module.eval()


def _ref_transformer(cfg: port_cog.CogVideoXConfig):
    return ref.CogVideoXTransformer3DRef(
        num_attention_heads=cfg.num_heads, attention_head_dim=cfg.head_dim,
        in_channels=cfg.in_channels, out_channels=cfg.out_channels,
        time_embed_dim=cfg.time_embed_dim, text_embed_dim=cfg.text_embed_dim,
        num_layers=cfg.num_layers, sample_width=cfg.sample_width,
        sample_height=cfg.sample_height, patch_size=cfg.patch_size)


def _t5_dict(cfg) -> dict:
    return {k: getattr(cfg, k) for k in (
        "vocab_size", "d_model", "d_kv", "num_heads", "d_ff", "num_layers",
        "relative_attention_num_buckets", "relative_attention_max_distance",
        "layer_norm_epsilon")}


def _published(module) -> dict:
    return {k: v.detach().float().numpy() for k, v in module.state_dict().items()}


@pytest.fixture(scope="module")
def pair():
    """(reference transformer, port transformer) on one seeded draw, the
    port's loaded through ``convert_cogvideox_transformer``."""
    cfg = TINY.dit
    r = _seeded(_ref_transformer(cfg), 3)
    port = port_cog.CogVideoXTransformer(cfg).eval()
    load_jax_params(port, convert_cogvideox_transformer(_published(r), cfg))
    return r, port


def _inputs(seed=0, t=(999,), n_text=7):
    cfg = TINY.dit
    gen = torch.Generator().manual_seed(seed)
    z = torch.randn(len(t), 2, 8, 12, cfg.in_channels, generator=gen)
    ctx = torch.randn(len(t), n_text, cfg.text_embed_dim, generator=gen)
    return z, torch.tensor(t), ctx


@pytest.mark.parametrize("t", [999, 500, 1])
def test_transformer_matches_reference(pair, t):
    r, port = pair
    z, ts, ctx = _inputs(t=(t,))
    with torch.inference_mode():
        got = port(z, ts, ctx)
        want = r(z.permute(0, 1, 4, 2, 3), ctx, ts).permute(0, 1, 3, 4, 2)
    assert got.shape == z.shape
    assert _rel(got, want) < REL


def test_block_matches_reference(pair):
    r, port = pair
    cfg = TINY.dit
    z, ts, ctx = _inputs(seed=5)
    gen = torch.Generator().manual_seed(9)
    x = torch.randn(1, 2 * 4 * 6, cfg.hidden_size, generator=gen)
    enc = torch.randn(1, 7, cfg.hidden_size, generator=gen)
    temb = torch.randn(1, cfg.time_embed_dim, generator=gen)
    with torch.inference_mode():
        rope = port.rope(2, 4, 6, "cpu")
        joint = torch.cat([enc, x], dim=1)
        got = port.block0(joint.clone(), torch.nn.functional.silu(temb), rope, 7)
        wx, we = r.transformer_blocks[0](x, enc, temb, r.rotary(2, 8, 12, "cpu"))
    assert _rel(got[:, 7:], wx) < REL and _rel(got[:, :7], we) < REL


@pytest.mark.parametrize("grid", [(13, 30, 45, 60, 90), (2, 4, 6, 8, 12), (3, 5, 9, 8, 12)])
def test_rope_tables_are_the_reference_tables(grid):
    """The published 16 / 24 / 24 split at the 13 x 30 x 45 grid of 480x720,
    the tiny grid, and a grid that covers only a crop of its base."""
    f, gh, gw, base_h, base_w = grid
    cfg = port_cog.CogVideoXConfig(sample_height=base_h, sample_width=base_w)
    cos, sin = port_cog.rope_tables(cfg, f, gh, gw)
    rc, rs = ref.rotary_3d(64, gh, gw, f, base_h // 2, base_w // 2)
    assert cos.shape == (f * gh * gw, 64)
    assert torch.equal(cos, rc) and torch.equal(sin, rs)
    if grid[0] == 13:
        # row (t, h, w) = (1, 2, 3): lanes 0-15 time, 16-39 height, 40-63 width
        row = cos[1 * 30 * 45 + 2 * 45 + 3]
        assert float(row[0]) == pytest.approx(math.cos(1.0))
        assert float(row[16]) == pytest.approx(math.cos(2.0))
        assert float(row[40]) == pytest.approx(math.cos(3.0))
        assert torch.equal(row[0::2], row[1::2])  # repeat-interleaved pairs


def test_t5_buckets_against_a_hand_computed_row():
    """Bidirectional, 32 buckets, 8 exact, max distance 128: key offsets
    0, +1, +7, +8, +12, +16, +32, +64, +127, +128, +200 and -1, -9, -200."""
    offsets = torch.tensor([0, 1, 7, 8, 12, 16, 32, 64, 127, 128, 200, -1, -9, -200])
    want = [0, 17, 23, 24, 25, 26, 28, 30, 31, 31, 31, 1, 8, 15]
    assert relative_position_bucket(offsets, 32, 128).tolist() == want
    assert ref.relative_position_bucket(offsets, 32, 128).tolist() == want


def test_t5_layer_and_encoder_match_reference():
    cfg = tiny_t5_config()
    r = _seeded(ref.T5EncoderRef(_t5_dict(cfg)), 4)
    port = T5Encoder(cfg).eval()
    load_jax_params(port, convert_t5_encoder(_published(r), cfg))
    ids = torch.tensor([[1, 17, 900, 2, 0, 0, 0], [1, 5, 6, 7, 8, 9, 2]])
    with torch.inference_mode():
        x = port.shared(ids)
        bias = port.position_bias(7, "cpu")
        got = port.block0(x, bias)
        rb = r.encoder.block[0]
        want = rb(x, rb.layer[0].SelfAttention.compute_bias(7, "cpu"))
        assert _rel(got, want) < REL
        hidden, pooled = port(ids)
        assert pooled is None and _rel(hidden, r(ids)) < REL


def test_zero_snr_trailing_schedule():
    sched = TINY.ddim_schedule(50)
    rs = ref.CogVideoXDDIMSchedulerRef()
    rs.set_timesteps(50)
    assert sched.timesteps.tolist() == rs.timesteps.tolist()
    assert sched.timesteps[0] == 999 and sched.timesteps[-1] == 19
    assert sched.alphas_cumprod[0] == 0.0 and float(rs.alphas_cumprod[999]) == 0.0
    assert sched.alphas_cumprod_prev[-1] == 1.0
    want = rs.alphas_cumprod[torch.from_numpy(sched.timesteps.astype(np.int64))]
    assert np.abs(sched.alphas_cumprod - want.numpy()).max() < 2e-6
    gen = torch.Generator().manual_seed(1)
    z = torch.randn(1, 2, 8, 12, 16, generator=gen)
    v = torch.randn(z.shape, generator=gen)
    for i in (0, 1, 25, 49):
        got = ddim_step(sched, i, z, v)
        want = rs.step(v, int(sched.timesteps[i]), z)
        assert float((got - want).abs().max()) <= 4e-6 * float(z.abs().max())
    # the zeroscope schedule is unchanged by the new arguments' defaults
    base = get_model_spec("zeroscope-v2-576w").ddim_schedule(25)
    assert base.timesteps[0] == 961 and base.alphas_cumprod_prev[-1] != 1.0


def test_converter_round_trip_and_strictness(pair):
    """The published key names of both towers load into the port, every
    one used; a missing or an extra key is refused."""
    r, _ = pair
    sd = _published(r)
    assert "transformer_blocks.0.attn1.norm_q.weight" in sd
    assert "transformer_blocks.1.ff.net.2.weight" in sd and "norm_out.linear.bias" in sd
    with pytest.raises(KeyError):
        convert_cogvideox_transformer({k: v for k, v in sd.items()
                                       if k != "transformer_blocks.1.attn1.norm_k.bias"},
                                      TINY.dit)
    with pytest.raises(ValueError):
        convert_cogvideox_transformer(dict(sd, extra=np.zeros(1)), TINY.dit)
    t5 = _published(ref.T5EncoderRef(_t5_dict(TINY.text)))
    assert "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight" in t5
    tree = convert_t5_encoder(dict(t5, **{"encoder.embed_tokens.weight": t5["shared.weight"]}),
                              TINY.text)
    load_jax_params(T5Encoder(TINY.text), tree)


def test_spec_from_published_configs(tmp_path):
    """A CogVideoX checkpoint directory's config.json files give the
    published spec."""
    cfg = json.load(open("portbench/configs/cogvideox-5b-hf.json"))
    for comp, conf in (("transformer", cfg["transformer"]), ("text_encoder", cfg["text"]),
                       ("vae", dict(cfg["vae"], _class_name="AutoencoderKLCogVideoX"))):
        (tmp_path / comp).mkdir()
        (tmp_path / comp / "config.json").write_text(json.dumps(conf))
    spec = spec_from_diffusers_configs(str(tmp_path), name="cogvideox-5b-hf")
    assert spec == get_model_spec("cogvideox-5b-hf")
    with torch.device("meta"):
        model = port_cog.CogVideoXTransformer(spec.dit)
    assert sum(p.numel() for p in model.parameters()) == 5_570_283_072


def test_tightness_modulations_swapped_or_qk_norm_skipped(pair, monkeypatch):
    """The comparison above is tight: computing with the text and video
    modulations swapped, or without the QK-norm, moves the output far
    beyond its tolerance."""
    r, port = pair
    z, ts, ctx = _inputs(seed=2, t=(600,))
    with torch.inference_mode():
        want = r(z.permute(0, 1, 4, 2, 3), ctx, ts).permute(0, 1, 3, 4, 2)

        def swapped(self, x, emb, n_text):
            shift, scale, gate, enc_shift, enc_scale, enc_gate = \
                self.linear(emb)[:, None].chunk(6, dim=-1)
            h = self.norm(x)
            port_cog._modulate_(h[:, n_text:], enc_scale, enc_shift)
            port_cog._modulate_(h[:, :n_text], scale, shift)
            return h, enc_gate, gate

        with monkeypatch.context() as m:
            m.setattr(port_cog._LayerNormZero, "forward", swapped)
            assert _rel(port(z, ts, ctx), want) > 1000 * REL

        def no_qk_norm(q, k, norm_q, norm_k, cos, sin, n_text):
            def rope_only(x):
                y = x.float().clone()
                v = y[:, n_text:]
                rot = torch.stack((-v[..., 1::2], v[..., 0::2]), dim=-1).flatten(-2)
                y[:, n_text:] = v * cos + rot * sin
                return y
            return rope_only(q), rope_only(k)

        with monkeypatch.context() as m:
            m.setattr(port_cog, "qk_norm_rope", no_qk_norm)
            assert _rel(port(z, ts, ctx), want) > 1000 * REL
        assert _rel(port(z, ts, ctx), want) < REL


@pytest.fixture(scope="module")
def tiny_pipe():
    return build_pipeline("cogvideox-tiny-hf", seed=5, device="cpu")


def test_generate_is_deterministic(tiny_pipe):
    video, (zs, epss, ts) = generate(tiny_pipe, PROMPT, seed=11, num_steps=3, record=True)
    assert video.shape == (2, 16, 24, 3) and video.dtype == np.uint8
    assert zs.shape == (3, 1, 2, 8, 12, 16) and ts.tolist() == [999, 666, 332]
    again = generate(tiny_pipe, PROMPT, seed=11, num_steps=3)
    assert np.array_equal(video, again)
    assert float(epss.float().std()) > 0.1


def test_stepengine_reexecutes_bit_for_bit(tiny_pipe):
    """Every revealed step re-executes to its bytes, the base latent
    re-derives from the seed, and an eps leaf scaled by 1 + 2^-4 is refused."""
    eng = StepEngine(tiny_pipe)
    video, zs, epss, ts = eng.generate_recorded(PROMPT, seed=3, num_frames=2, height=16,
                                                width=24, num_steps=3, guidance_scale=6.0)
    leaves = {i: (int(t), zs[i], epss[i]) for i, t in enumerate(ts)}
    results, z_next = verify_revealed_steps(eng, PROMPT, "", leaves, [0, 1, 2], 3, 6.0,
                                            same_platform=True)
    assert all(r.passed and r.bitwise for r in results.values()), results
    assert torch.equal(z_next[0].view(torch.int16), zs[1].view(torch.int16))
    base = eng.base_latent(3, 2, 16, 24)
    assert torch.equal(base.view(torch.int16), zs[0].view(torch.int16))
    t, z, e = leaves[1]
    leaves[1] = (t, z, (e.float() * (1 + 2.0 ** -4)).bfloat16())
    results, _ = verify_revealed_steps(eng, PROMPT, "", leaves, [1], 3, 6.0,
                                       same_platform=True)
    assert not results[1].passed


def test_miner_validator_round(tiny_pipe, tmp_path):
    """A PoI round over the published architecture on the mock network: the
    honest miner verifies bit for bit (base noise and video binding
    included), a lazy miner is caught at re-execution."""
    cfg = ValidatorConfig(sample_size=2, num_checkpoints=2, num_frames=2, width=24, height=16,
                          num_steps=3, guidance_scale=6.0, ping_timeout_s=30,
                          results_dir=str(tmp_path))
    net = build_mock_network(n_miners=2, adversaries=["honest", "lazy"], pipeline=tiny_pipe,
                             validator_config=cfg, device="cpu")
    loop = asyncio.new_event_loop()
    try:
        report = loop.run_until_complete(net.run_request("cog-poi", PROMPT))
    finally:
        loop.close()
    d = report["miners"]["0"]
    assert d["checks"]["reexecution"] is True and d.get("reexec_bitwise") is True
    assert d["checks"].get("base_noise") is True and d["checks"]["video_binding"]
    assert d["score"] > 0 and not d.get("cheat", False)
    lazy = report["miners"]["1"]
    assert lazy["failed_check"] == "reexecution" and lazy["cheat"] is True


def test_empty_pipeline_builds_the_published_modules():
    pipe = empty_pipeline(get_model_spec("cogvideox-5b-hf"), "meta")
    assert type(pipe.unet).__name__ == "CogVideoXTransformer"
    assert type(pipe.text_encoder).__name__ == "T5Encoder"
    assert sum(p.numel() for p in pipe.text_encoder.parameters()) == 4_762_310_656
    assert pipe.unet.patch_embed.weight.dtype == torch.bfloat16


def test_spans_of_the_dit_and_t5(tiny_pipe):
    """One ``dit`` span a transformer call, with ``dit.embed``, a
    ``dit.block`` a block (each with ``dit.attn`` and ``dit.ff``) and
    ``dit.out`` under it; one ``t5`` span a text encode; and the span
    report's split of a call by part."""
    import importlib.util

    from dvdx_tpu_torch.utils import profiling

    z, ts, ctx = _inputs(seed=1)
    ids = torch.from_numpy(tiny_pipe.tokenize(["", PROMPT])).long()
    with torch.inference_mode(), profiling.recording():
        before = {s.id for s in profiling.spans()}
        tiny_pipe.text_encoder(ids)
        tiny_pipe.unet(z, ts, ctx)
        new = [s for s in profiling.spans() if s.id not in before]
    by_id = {s.id: s for s in new}
    names = [s.name for s in new]
    assert names.count("t5") == 1 and names.count("dit") == 1
    assert names.count("dit.block") == 2 and names.count("dit.attn") == 2
    assert names.count("dit.ff") == 2
    for s in new:
        parent = by_id.get(s.parent)
        want = {"dit.embed": "dit", "dit.block": "dit", "dit.out": "dit",
                "dit.attn": "dit.block", "dit.ff": "dit.block"}.get(s.name)
        if want is not None:
            assert parent is not None and parent.name == want, s
    spec = importlib.util.spec_from_file_location("span_report", "scripts/span_report.py")
    report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(report)
    from portbench.spans import Span

    parts = report.dit_parts([Span(s.name, s.start_ns / 1e9, s.end_ns / 1e9, s.id, s.parent)
                              for s in new])
    assert parts["calls"] == 1
    assert {"dit.embed", "dit.attn", "dit.ff", "dit.block (rest)", "dit.out",
            "dit (rest)"} <= set(parts)


def test_kernel_gates_and_plain_epilogues():
    """The plain epilogues are their formulas in float32; the kernels' gates
    take the block's bf16 layouts (gates as views of the modulation's six
    chunks) and refuse what the kernels do not take."""
    from dvdx_tpu_torch.ops.kernels import dit_epilogue as de
    from dvdx_tpu_torch.ops.kernels import qk_norm_rope as qk

    gen = torch.Generator().manual_seed(4)
    x, y = torch.randn(2, 9, 16, generator=gen), torch.randn(2, 9, 16, generator=gen)
    b, emb6 = torch.randn(16, generator=gen), torch.randn(2, 1, 96, generator=gen)
    gate, enc = emb6[..., 32:48], emb6[..., 80:]
    want = x.clone()
    want[:, 3:] += gate * (y[:, 3:] + b)
    want[:, :3] += enc * (y[:, :3] + b)
    assert torch.allclose(de.gated_residual_plain(x.clone(), y, b, gate, enc, 3), want,
                          atol=1e-6)
    assert torch.allclose(de.bias_gelu_plain(y.clone(), b),
                          torch.nn.functional.gelu(y + b, approximate="tanh"))
    xb, yb, bb, eb = (t.bfloat16() for t in (x, y, b, emb6))
    assert de._gated_args(xb, yb, bb, eb[..., 32:48], eb[..., 80:]) == (2, 9, 16, 96)
    assert de._gated_args(xb, yb, bb, eb[..., 32:48], eb[..., 81:97]) is None  # misaligned
    assert de._gated_args(x, y, b, gate, enc) is None                          # float32
    assert de._bias_args(yb, bb) == (18, 16) and de._bias_args(yb[..., :12], bb[:12]) is None
    n = torch.nn.LayerNorm(64).bfloat16().requires_grad_(False)
    qkv = torch.randn(2, 9, 3, 2, 64, generator=gen).bfloat16()
    cos, sin = torch.ones(6, 1, 64), torch.zeros(6, 1, 64)
    assert qk._launch_args(qkv[:, :, 0], qkv[:, :, 1], n, n, cos, sin, 3) == -1  # the CPU
    assert qk._launch_args(qkv[:, :, 0], qkv[:, :, 1], n, n, cos, sin, 4) is None
    out = qk.qk_norm_rope_plain(qkv[:, :, 0], n.weight, n.bias, n.eps, cos, sin, 3)
    assert torch.equal(out, torch.nn.functional.layer_norm(
        qkv[:, :, 0].float(), (64,), n.weight.float(), n.bias.float()).bfloat16())


class _Counted:
    """A kernel wrapper's stand-in on the meta device: counts its calls and
    hands back ``out(*args)`` (shapes only)."""

    def __init__(self, out):
        self.calls, self.out = 0, out

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.out(*args)


def test_kernel_calls_per_dit_call_at_full_architecture(monkeypatch):
    """One batch-2 call of the published transformer (42 blocks) at the
    benchmark configuration's 13 x 60 x 90 latents and 226 text tokens, on
    the meta device (shapes only; each kernel wrapper counted and passed
    through): per block one QK-norm and rotation, one flash attention, one
    bias-GELU and two gated residuals, and the bias epilogue on the 132
    other dense layers, all of a width it takes; the counts
    ``chip_smoke.COG_HF_PER_DIT_CALL`` requires of the card's launch
    counters in phase 14."""
    import os
    import runpy

    from dvdx_tpu_torch.models import layers
    from dvdx_tpu_torch.ops.attention import wants_flash

    def attend(q, k, v):
        assert wants_flash(q.shape[1], k.shape[1], q.shape[-1])
        return q

    counted = {"qk_norm_rope": _Counted(lambda q, k, *rest: (q, k)),
               "bias_gelu": _Counted(lambda y, b: y),
               "gated_residual": _Counted(lambda x, *rest: x),
               "flash_attention": _Counted(attend),
               "bias_epilogue": _Counted(lambda y, b, residual: y)}
    for attr, name in (("qk_norm_rope", "qk_norm_rope"), ("bias_gelu_", "bias_gelu"),
                       ("gated_residual_", "gated_residual"),
                       ("multi_head_attention", "flash_attention")):
        monkeypatch.setattr(port_cog, attr, counted[name])
    monkeypatch.setattr(layers, "bias_epilogue", counted["bias_epilogue"])
    spec = get_model_spec("cogvideox-5b-hf")
    with torch.device("meta"):
        model = port_cog.CogVideoXTransformer(spec.dit).to(torch.bfloat16)
    with torch.inference_mode():
        out = model(torch.empty(2, 13, 60, 90, 16, device="meta"),
                    torch.zeros(2, dtype=torch.long, device="meta"),
                    torch.empty(2, 226, 4096, device="meta"))
    assert out.shape == (2, 13, 60, 90, 16)
    calls = {k: c.calls for k, c in counted.items()}
    assert calls == {"qk_norm_rope": 42, "bias_gelu": 42, "gated_residual": 84,
                     "flash_attention": 42, "bias_epilogue": 132}
    smoke = runpy.run_path(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py"), run_name="chip_smoke")
    assert smoke["COG_HF_PER_DIT_CALL"] == calls
