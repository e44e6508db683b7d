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
"""

import itertools

import pytest
import torch

from dvdx_tpu_torch.models import layers, unet3d, vae
from dvdx_tpu_torch.models.zoo import get_model_spec
from dvdx_tpu_torch.ops import groupnorm as tgn
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
