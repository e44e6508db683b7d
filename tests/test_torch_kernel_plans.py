"""The kernels' planning helpers and the fused temporal block's gate, on the
CPU: the shapes the models hand the wrappers, and what each kernel is told
to do with them.

* GroupNorm (``ops.groupnorm.plan``): at every GroupNorm shape of one
  zeroscope-v2-576w UNet call (16 x 576x320, CFG batch 2) and of one
  frame's VAE decode, collected by running the models on the meta device
  with the kernels stubbed, the planned chunks cover every row of every
  sample exactly once and fit the kernel's shared-memory partials.
* The temporal block (``ops.kernels.temporal_block``): every shape the gate
  ``models.layers.fused_temporal_block_wants`` sends to the kernel passes
  the wrapper's checks and gets a plan whose tiles cover every position
  once, inside a 64-row tile, within the card's shared memory; shapes the
  kernel does not take are not gated to it.
* The spatial tail (``ops.kernels.spatial_tail``): the 64-row chain's tiles
  hold every row once, and each tile's image span is the images of its own
  rows, at S = 2880 (the UNet's level 0: no tile spans two images), 721 and
  70 (tiles that do); every shape the gate ``fused_spatial_tail_wants``
  takes passes the wrapper's checks.
* Frame-axis attention (``ops.kernels.temporal_attention``): the tiles and
  their rows hold every (batch, position, head, frame) once in both
  layouts, up to 128 frames; every shape the gate takes passes the
  wrapper's checks.
* Float32 models: the layers hand GroupNorm, GEGLU and frame-axis attention
  to the kernels' wrappers whatever the dtype (no gate reads it), and GEGLU
  picks its wgmma pair for bf16 at C % 64 == 0 and I % 128 == 0 only.
"""

import itertools

import pytest
import torch

from dvdx_tpu_torch.models import layers, unet3d, vae
from dvdx_tpu_torch.models.zoo import get_model_spec
from dvdx_tpu_torch.ops import groupnorm as tgn
from dvdx_tpu_torch.ops.kernels import geglu_ff as tff
from dvdx_tpu_torch.ops.kernels import spatial_tail as ttail
from dvdx_tpu_torch.ops.kernels import temporal_attention as tattn
from dvdx_tpu_torch.ops.kernels import temporal_block as tblock

GN_THREADS = 256  # csrc/groupnorm.cu THREADS
GN_MAX_PARTIALS = 2560  # its per-channel partial sums in shared memory


@pytest.fixture(scope="module")
def group_norm_shapes():
    """{"unet": [(N, L, C), ...], "vae": [...]}: the shapes one UNet call
    and one frame's decode hand ``group_norm_act``, in call order."""
    seen = []

    def record(x, gamma, beta, *, groups, eps, act="none", bias=None):
        seen.append((x.shape[0], x[0].numel() // x.shape[-1], x.shape[-1]))
        return torch.empty_like(x)

    def same(x, *args, **kwargs):
        return torch.empty_like(x)

    spec = get_model_spec("zeroscope-v2-576w")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name in ("multi_head_attention", "geglu_ff", "fused_spatial_tail",
                     "temporal_attention", "fused_temporal_block"):
            mp.setattr(layers, name, same)
        mp.setattr(vae, "multi_head_attention", same)
        mp.setattr(layers, "group_norm_act", record)
        with torch.device("meta"):
            unet = unet3d.UNet3D(spec.unet).to(torch.bfloat16)
            unet(torch.empty(2, 16, 40, 72, 4, dtype=torch.bfloat16),
                 torch.zeros(2, dtype=torch.long),
                 torch.empty(2, 77, 1024, dtype=torch.bfloat16))
            out["unet"], seen[:] = list(seen), []
            vae.VAEDecoder(spec.vae).to(torch.bfloat16)(torch.empty(1, 40, 72, 4))
            out["vae"] = list(seen)
    return out


@pytest.mark.parametrize("model,calls", [("unet", 166), ("vae", 30)])
def test_group_norm_chunks_cover_every_row_once(group_norm_shapes, model, calls):
    shapes = group_norm_shapes[model]
    assert len(shapes) == calls
    for n, length, c in set(shapes):
        pl = tgn.plan(n, length, c)
        covered = torch.zeros(length, dtype=torch.int32)
        for ch in range(pl.nchunks):
            rows = slice(ch * pl.chunk_rows, min(length, (ch + 1) * pl.chunk_rows))
            assert rows.start < rows.stop, (n, length, c, ch)
            covered[rows] += 1
        assert torch.equal(covered, torch.ones(length, dtype=torch.int32)), (n, length, c)
        assert pl.items == n * pl.nchunks
        assert pl.chunk_rows * c <= max(tgn.CHUNK_ELEMS, tgn.LARGE_CHUNK_ELEMS)
        octets = c // 8
        lanes = max(1, GN_THREADS // octets)
        assert c % 8 == 0 and lanes * c <= GN_MAX_PARTIALS


@pytest.mark.parametrize("frames", [1, 4, 16, 20, 24, 40, 64, 65, 128])
@pytest.mark.parametrize("dim", [32, 64, 128, 320, 384, 448, 640])
def test_gated_temporal_blocks_pass_the_wrapper_checks(dim, frames):
    for positions, heads in itertools.product((64, 101, 2880),
                                              [h for h in range(1, dim + 1) if dim % h == 0]):
        wanted = layers.fused_temporal_block_wants(frames, positions, dim, heads, dim // heads)
        assert wanted == (dim % 64 == 0 and dim <= 384 and frames <= 64
                          and (dim // heads) % 8 == 0)
        assert not layers.fused_temporal_block_wants(frames, positions, dim, heads,
                                                     2 * dim // heads)  # heads x d != C
        if not wanted:
            with pytest.raises(ValueError):
                tblock.check_shape((2, frames, positions, dim), heads, 4 * dim, (dim, dim))
        else:
            pl = tblock.check_shape((2, frames, positions, dim), heads, 4 * dim, (dim, dim))
            fpad = -(-frames // 16) * 16
            assert pl.positions * frames <= 64
            assert (pl.positions - 1) * frames + fpad <= 64
            more = pl.positions + 1  # no larger P fits
            assert more * frames > 64 or (more - 1) * frames + fpad > 64
            per_sample = pl.tiles // 2  # the tiles of one sample cover its positions once
            assert per_sample * pl.positions >= positions > (per_sample - 1) * pl.positions
            assert pl.stages >= 2 and pl.stages % 2 == 0
            assert pl.smem_bytes <= tblock.SMEM_LIMIT


# --- the spatial tail's chain ---------------------------------------------------

@pytest.mark.parametrize("n,s", [(32, 2880), (3, 721), (5, 70), (1, 70)])
def test_spatial_chain_tiles_cover_every_row_once(n, s):
    rows = n * s
    pl = ttail.plan(rows, s, 320, 320, 77, 5)
    covered = torch.zeros(rows, dtype=torch.int32)
    spanning = 0
    for tile in range(pl.tiles):
        r0 = tile * ttail.TILE_ROWS
        held = torch.arange(r0, min(r0 + ttail.TILE_ROWS, rows))
        covered[held] += 1
        lo, hi = ttail.tile_images(tile, rows, s)
        assert (lo, hi) == (int(held[0]) // s, int(held[-1]) // s)
        spanning += hi > lo
    assert torch.equal(covered, torch.ones(rows, dtype=torch.int32))
    # a tile spans images exactly where an image boundary falls inside it
    assert spanning == sum((k * s) % ttail.TILE_ROWS != 0 for k in range(1, n))
    assert (pl.tokens, pl.chunks) == (80, 1)


@pytest.mark.parametrize("c,d,t,tokens,chunks", [
    (320, 64, 77, 80, 1), (384, 64, 77, 80, 1), (384, 128, 300, 128, 3), (64, 16, 16, 16, 1),
    (64, 64, 128, 128, 1), (320, 40, 129, 128, 2), (320, 64, 512, 128, 4)])
def test_spatial_chain_plan_fits_the_card(c, d, t, tokens, chunks):
    pl = ttail.plan(4 * 600, 600, c, c, t, c // d)
    assert (pl.tokens, pl.chunks) == (tokens, chunks)
    assert pl.stage_bytes >= max(c // 2 * 128, ttail.kv_fill_bytes(d, tokens))
    assert pl.stage_bytes % 1024 == 0
    assert 2 <= pl.stages <= ttail.MAX_STAGES and pl.stages % 2 == 0
    assert pl.smem_bytes <= ttail.SMEM_LIMIT
    more = ttail.chain_smem_bytes(c, pl.stages + 2, pl.stage_bytes)
    assert pl.stages == ttail.MAX_STAGES or more > ttail.SMEM_LIMIT


@pytest.mark.parametrize("dim", [32, 64, 128, 320, 384, 448, 640])
@pytest.mark.parametrize("ctx_tokens", [7, 77, 300, 513])
def test_gated_spatial_tails_pass_the_wrapper_checks(dim, ctx_tokens):
    for s, heads in itertools.product((256, 512, 2880, 721),
                                      [h for h in range(1, dim + 1) if dim % h == 0]):
        d = dim // heads
        taken = (dim % 64 == 0 and dim <= 384 and d % 8 == 0 and d <= 128
                 and ctx_tokens <= 512)  # the chain's shapes
        wanted = layers.fused_spatial_tail_wants(s, dim, heads, d, ctx_tokens)
        assert wanted == (s >= 512 and taken)  # S >= 512 is the routing's choice
        assert not layers.fused_spatial_tail_wants(s, dim, heads, 2 * d, ctx_tokens)
        if not taken:
            if dim <= ttail.CHAIN_MAX_DIM:
                with pytest.raises(ValueError):
                    ttail.check_shape(2, s, dim, dim, dim, ctx_tokens, heads, 4 * dim)
            continue
        pl = ttail.check_shape(2, s, dim, dim, dim, ctx_tokens, heads, 4 * dim)
        assert pl is not None and pl.tiles == -(-2 * s // 64)
        assert pl.smem_bytes <= ttail.SMEM_LIMIT


def test_spatial_tail_gate_routes_the_models_widths():
    """zeroscope-v2-576w's level 0 (C = 320, 5 heads of 64) and the tiny
    model's (C = 32, 2 heads of 16) at S >= 512: the first takes the chain,
    the second (C not a multiple of 64) runs unfused; the wide chain takes
    level 1's C = 640 when called directly, never through the gate."""
    assert layers.fused_spatial_tail_wants(2880, 320, 5, 64, 77)
    assert not layers.fused_spatial_tail_wants(4096, 32, 2, 16, 77)
    assert not layers.fused_spatial_tail_wants(720, 640, 10, 64, 77)
    assert ttail.check_shape(32, 720, 640, 640, 640, 77, 10, 2560) is None
    with pytest.raises(ValueError):
        ttail.check_shape(2, 4096, 32, 32, 32, 77, 2, 128)


# --- frame-axis attention --------------------------------------------------------

def _tile_coords(pl, tile, n, heads):
    """csrc/temporal_attention.cu tile_coords: (head, first position, batch)."""
    per_b = -(-n // pl.positions) * heads
    r = tile % per_b
    return r % heads, r // heads * pl.positions, tile // per_b


def _tile_row(pl, f, p, layout):
    """The shared-memory row of frame f of the tile's position p (the TMA
    box follows memory order)."""
    return p * pl.frames + f if layout == "pm" else f * pl.positions + p


@pytest.mark.parametrize("layout", ["fm", "pm"])
@pytest.mark.parametrize("f", [16, 24, 40, 128])
@pytest.mark.parametrize("d", [40, 64, 128])
def test_frame_attention_tiles_cover_every_unit_once(layout, f, d):
    b, n, heads = 2, 45, 3
    pl = tattn.plan(b, f, n, heads, d, layout)
    seen = torch.zeros(b, n, heads, f, dtype=torch.int32)
    rows = sorted(_tile_row(pl, ff, p, layout) for ff in range(pl.frames)
                  for p in range(pl.positions))
    assert rows == list(range(pl.positions * pl.frames))  # one row per (frame, position)
    for tile in range(pl.tiles):
        h, n0, bb = _tile_coords(pl, tile, n, heads)
        for p in range(pl.positions):
            if n0 + p < n:
                seen[bb, n0 + p, h, :] += 1
    assert torch.equal(seen, torch.ones_like(seen))
    assert pl.frames % 16 == 0 and f <= pl.frames < f + 16
    assert pl.head_dim % 16 == 0 and pl.head_dim <= 64 * pl.boxes
    assert pl.positions * pl.frames * pl.boxes <= 128 or pl.positions == 1
    assert 1 <= pl.stages <= tattn.MAX_STAGES and pl.smem_bytes <= tattn.SMEM_LIMIT


@pytest.mark.parametrize("frames", [1, 8, 16, 24, 40, 64, 128, 129, 256])
@pytest.mark.parametrize("head_dim", [4, 8, 16, 40, 64, 72, 128, 136])
def test_gated_frame_attention_passes_the_wrapper_checks(frames, head_dim):
    wanted = layers.temporal_attention_wants(frames, head_dim)
    assert wanted == (frames <= 128 and head_dim % 8 == 0 and head_dim <= 128)
    for layout in ("fm", "pm"):
        if wanted:
            assert tattn.check_shape(2, frames, 720, 10, head_dim, layout).tiles > 0
        else:
            with pytest.raises(ValueError):
                tattn.check_shape(2, frames, 720, 10, head_dim, layout)


@pytest.mark.parametrize("model", ["zeroscope-tiny", "zeroscope-tiny-hf"])
def test_float32_models_call_the_kernel_wrappers(model):
    """One float32 UNet call of each test model on the CPU: every GroupNorm,
    GEGLU and frame-axis attention goes through the layer's kernel wrapper
    (which launches its kernel on a CUDA tensor), none to a plain version
    chosen by dtype."""
    calls = {}

    def recorder(name, fn):
        def run(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            assert args[0].dtype == torch.float32
            return fn(*args, **kwargs)
        return run

    spec = get_model_spec(model)
    with pytest.MonkeyPatch.context() as mp:
        for name in ("group_norm_act", "geglu_ff", "temporal_attention"):
            mp.setattr(layers, name, recorder(name, getattr(layers, name)))
        unet = unet3d.UNet3D(spec.unet).float()
        with torch.inference_mode():
            unet(torch.randn(2, 4, 4, 4, 4), torch.tensor([500, 500]), torch.randn(2, 77, 64))
    assert calls["group_norm_act"] > 0 and calls["geglu_ff"] > 0
    assert ("temporal_attention" in calls) == (model == "zeroscope-tiny-hf")


@pytest.mark.parametrize("dtype,c,inner,wgmma", [
    (torch.bfloat16, 320, 1280, True), (torch.bfloat16, 1280, 5120, True),
    (torch.bfloat16, 32, 128, False), (torch.bfloat16, 64, 192, False),
    (torch.float32, 320, 1280, False), (torch.float32, 32, 128, False)])
def test_geglu_picks_its_kernel_pair(dtype, c, inner, wgmma):
    assert tff.wgmma_takes(dtype, c, inner) is wgmma
