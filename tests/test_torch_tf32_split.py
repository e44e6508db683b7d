"""The float32 kernels' three-pass TF32 split, and the float32 attention's
shape gate, on the CPU.

* The split (``csrc/tf32_mma.cuh``): x = big + small with big = x rounded
  to TF32 (to nearest, ties away from zero) and small = x - big, which the
  tensor core truncates to TF32; a b ~ a_small b_big + a_big b_small +
  a_big b_big accumulated in f32. An emulation in plain torch (TF32 by bit
  masking) holds it within 1e-5 of the largest exact output at the float32
  UNet's product depths and at flash's two products, on the inputs
  ``chip_smoke.py`` phase 2 draws (unit normal activations, weights scaled
  by depth^-0.5); one TF32 pass misses that bound, which is why the
  kernels take three. The exact product is taken in float64.
* The tensor core's sums: an ``mma.sync`` adds its products to its
  accumulator and truncates the sum to f32 (round toward zero), so a chain
  of them into one accumulator drifts toward zero. Emulated so, a chain over
  K = 5120, or over float32 flash's 2880 keys, misses 1e-5 (the card
  measured 2.4e-5 for the latter); the kernels' chains hold it: f32_gemm
  chains the three passes over a 32-deep K slice into an accumulator of its
  own and adds it to the running sum in f32, and the attention chains each
  64-key tile's logits and its P.V, O = alpha O + tile in f32.
* The short-sequence body (``attention_f32_frames``): the frame axis's 16
  frames are one m16 tile of mma.sync; keys in chunks of 16, S = Q K^T one
  chain of 3 D / 8 truncated steps a chunk, P.V chained into O after O =
  alpha O (at most 24 steps at 63 frames), keys past F masked. Emulated so,
  at F in {4, 16, 24} and D in {40, 64, 128}, it is held against the JAX
  package's ``temporal_attention_fm`` (the Pallas interpreter, float32)
  within 1e-5 of max|ref|.
* The gate (``ops.kernels.attention_f32.body``): at every float32
  attention site of one zeroscope-v2-576w UNet call at 16 x 576x320 (CFG
  batch 2), collected on the meta device with the kernels stubbed, flash
  (levels 0-1) and the fused tail's cross-attention take the 64-row
  tensor-core body ("mma"), the frame-axis sites (16 frames: frame-axis
  attention and the fused block's two) the short-sequence body
  ("frames"); strides or offsets that are no multiple of 16 bytes, odd or
  wide head widths and short runs of queries over other keys go to the
  CUDA-core rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvdx_tpu.ops.pallas import temporal_attention as jtemp
from dvdx_tpu_torch.models import layers, unet3d
from dvdx_tpu_torch.models.zoo import get_model_spec
from dvdx_tpu_torch.ops import attention as tops_attention
from dvdx_tpu_torch.ops.kernels import attention_f32 as tatt32
from dvdx_tpu_torch.ops.kernels import flash_attention as tflash
from dvdx_tpu_torch.ops.kernels import spatial_tail as ttail
from dvdx_tpu_torch.ops.kernels import temporal_attention as tattn
from dvdx_tpu_torch.ops.kernels import temporal_block as tblock

TOL = 1e-5  # of max |exact|: phase 2's float32 tolerance


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32 (10 mantissa bits), to nearest, ties away
    from zero: half a TF32 ulp added to the magnitude, the low 13 bits
    cleared (the sign bit is untouched), as the kernels round big."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_truncated(x: torch.Tensor) -> torch.Tensor:
    """x as the tensor core reads a TF32 operand: its top 19 bits."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    big = tf32(x)
    return big, tf32_truncated(x - big)


def product(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a (M, K) b^T, b (N, K), float32 operands: one TF32 pass, or the three
    passes of the split, each product exact and the sums in f32."""
    ab, al = split(a)
    bb, bl = split(b)
    if passes == 1:
        return ab @ bb.t()
    return (al @ bb.t() + ab @ bl.t()) + ab @ bb.t()


def rel_err(got: torch.Tensor, exact: torch.Tensor) -> float:
    return ((got.double() - exact).abs().max() / exact.abs().max()).item()


def normal(shape, seed, scale=1.0):
    x = np.random.default_rng(seed).normal(size=shape) * scale
    return torch.from_numpy(x.astype(np.float32))


def test_tf32_rounds_to_nearest_ties_away():
    one = torch.tensor([1.0], dtype=torch.float32)
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, 1 + ulp / 2 - 2 ** -23, -(1 + ulp / 2), 1 + 3 * ulp / 4,
                      3.0e-3], dtype=torch.float32)
    got = tf32(x)
    assert got[0].item() == 1 + ulp and got[2].item() == -(1 + ulp)  # ties away
    assert got[1].item() == 1.0 and got[3].item() == 1 + ulp
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    assert tf32(one).item() == 1.0
    big, small = split(x)
    assert torch.equal((big + small)[[0, 2, 3]], x[[0, 2, 3]])  # x - big fits in 11 bits
    assert ((big + small - x).abs() <= 2.0 ** -21 * x.abs()).all()


# the float32 UNet's product depths: C and I of levels 0-3 (320 ... 1280,
# 4 C up to 5120), and flash's head width
@pytest.mark.parametrize("k", [64, 320, 640, 1280, 2560, 5120])
def test_three_passes_hold_the_float32_bound_and_one_does_not(k):
    a = normal((192, k), k)                    # activations
    w = normal((160, k), k + 1, k ** -0.5)     # an nn.Linear weight (N, K)
    exact = a.double() @ w.double().t()
    three, one = rel_err(product(a, w, 3), exact), rel_err(product(a, w, 1), exact)
    assert three <= TOL, three
    assert one > 10 * TOL, one


def _attention(q, k, v, passes):
    """softmax(q k^T / sqrt(D)) v per (batch, head) with both products in
    ``passes`` TF32 passes, the softmax in f32."""
    b, s, h, d = q.shape
    out = torch.empty_like(q)
    for i in range(b):
        for j in range(h):
            logits = product(q[i, :, j], k[i, :, j], passes) * d ** -0.5
            p = torch.softmax(logits, dim=-1)
            out[i, :, j] = product(p, v[i, :, j].t().contiguous(), passes)
    return out


@pytest.mark.parametrize("s,d", [(256, 64), (200, 40), (128, 128)])
def test_three_passes_hold_flash_products(s, d):
    q, k, v = (normal((1, s, 2, d), 10 * d + i) for i in range(3))
    logits = torch.einsum("bshd,bthd->bhst", q.double(), k.double()) * d ** -0.5
    exact = torch.einsum("bhst,bthd->bshd", torch.softmax(logits, -1), v.double())
    three = rel_err(_attention(q, k, v, 3), exact)
    one = rel_err(_attention(q, k, v, 1), exact)
    assert three <= TOL, three
    assert one > 10 * TOL, one


# --- the tensor core's truncated sums --------------------------------------

def _mma(c, a, b):
    """One mma.sync as emulated: c + a b summed exactly (float64), then
    truncated to f32. c (M, N) f32, a (M, 8) and b (8, N) TF32 values."""
    exact = c.double() + a.double() @ b.double()
    out = exact.float()
    over = out.double().abs() > exact.abs()
    return torch.where(over, torch.nextafter(out, torch.zeros_like(out)), out)


def _chain(c, a, b):
    """The three passes of each 8-deep k-step of a (M, K) b (K, N), chained
    into c."""
    for k in range(0, a.shape[1], 8):
        (ab, al), (bb, bl) = split(a[:, k:k + 8]), split(b[k:k + 8])
        c = _mma(_mma(_mma(c, al, bb), ab, bl), ab, bb)
    return c


def _gemm(a, b, slice_depth):
    """f32_gemm's sums: a chain over each ``slice_depth`` of K into a zeroed
    accumulator, added to the running sum in f32."""
    c = torch.zeros(a.shape[0], b.shape[1])
    for k in range(0, a.shape[1], slice_depth):
        c = c + _chain(torch.zeros_like(c), a[:, k:k + slice_depth], b[k:k + slice_depth])
    return c


def test_sliced_chains_hold_the_bound_where_one_chain_drifts():
    k = 5120
    a = normal((32, k), 5)
    w = normal((k, 32), 6, k ** -0.5)
    exact = a.double() @ w.double()
    chained, sliced = rel_err(_gemm(a, w, k), exact), rel_err(_gemm(a, w, 32), exact)
    assert sliced <= TOL / 4, sliced
    assert chained > TOL, chained


def _flash_rows(q, k, v, pv_per_tile):
    """attention_f32_mma's arithmetic for q's rows over all keys: 64-key
    tiles, the logits one chain a tile, P.V one chain a tile added as O =
    alpha O + tile in f32, or one chain over every key, the online softmax
    in f32."""
    d = q.shape[1]
    c = d ** -0.5 * 1.4426950408889634
    m = torch.full((q.shape[0],), -float("inf"))
    l = torch.zeros(q.shape[0])
    o = torch.zeros_like(q)
    for j in range(0, k.shape[0], 64):
        kt, vt = k[j:j + 64], v[j:j + 64]
        s = _chain(torch.zeros(q.shape[0], kt.shape[0]), q, kt.t())
        mx = torch.maximum(m, s.max(1).values)
        alpha = torch.exp2((m - mx) * c)
        p = torch.exp2(s * c - (mx * c)[:, None])
        l, m = l * alpha + p.sum(1), mx
        if pv_per_tile:
            o = o * alpha[:, None] + _chain(torch.zeros_like(o), p, vt)
        else:
            o = _chain(o * alpha[:, None], p, vt)
    return o / l[:, None]


def test_flash_chains_p_v_a_tile_at_a_time_over_2880_keys():
    q, k, v = normal((32, 64), 7), normal((2880, 64), 8), normal((2880, 64), 9)
    logits = q.double() @ k.double().t() * 64 ** -0.5
    exact = torch.softmax(logits, -1) @ v.double()
    chained = rel_err(_flash_rows(q, k, v, False), exact)
    per_tile = rel_err(_flash_rows(q, k, v, True), exact)
    assert per_tile <= TOL / 4, per_tile
    assert chained > TOL, chained


# --- the short-sequence body -------------------------------------------------

def _chain_batched(c, a, b):
    """_chain over batched (..., M, K) a and (..., K, N) b."""
    for k in range(0, a.shape[-1], 8):
        (ab, al), (bb, bl) = split(a[..., k:k + 8]), split(b[..., k:k + 8, :])
        c = _mma(_mma(_mma(c, al, bb), ab, bl), ab, bb)
    return c


def _frames_body(q, k, v):
    """attention_f32_frames' arithmetic on (P, F, D) rows of P (b, n, h):
    rows padded to a multiple of 16 and lanes to one of 8 with zeros, one
    16-row m-tile at a time; per 16-key chunk the logits one chain over d
    from zero, keys past F masked, the online softmax in f32, O = alpha O
    and the chunk's P.V chained into it."""
    p_, f, d = q.shape
    fp, dp = -(-f // 16) * 16, -(-d // 8) * 8

    def pad(x):
        return torch.nn.functional.pad(x, (0, dp - d, 0, fp - f))
    q, k, v = pad(q), pad(k), pad(v)
    c = torch.tensor(d ** -0.5 * 1.4426950408889634, dtype=torch.float32)
    out = torch.empty(p_, fp, dp)
    for m0 in range(0, fp, 16):
        qt = q[:, m0:m0 + 16]
        m = torch.full((p_, 16), -float("inf"))
        l = torch.zeros(p_, 16)
        o = torch.zeros(p_, 16, dp)
        for kc in range(0, f, 16):
            s = _chain_batched(torch.zeros(p_, 16, 16), qt, k[:, kc:kc + 16].transpose(1, 2))
            s[..., torch.arange(kc, kc + 16) >= f] = -float("inf")
            mx = torch.maximum(m, s.max(-1).values)
            alpha = torch.exp2((m - mx) * c)
            p = torch.exp2(s * c - (mx * c)[..., None])
            l, m = l * alpha + p.sum(-1), mx
            o = _chain_batched(o * alpha[..., None], p, v[:, kc:kc + 16])
        out[:, m0:m0 + 16] = o / l[..., None]
    return out[:, :f, :d]


@pytest.mark.parametrize("f", [4, 16, 24])
@pytest.mark.parametrize("d", [40, 64, 128])
def test_frames_body_holds_the_pallas_frame_axis_attention(f, d):
    """The short-sequence body's emulated arithmetic on frame-major (B, F,
    N, H*D) against ``temporal_attention_fm`` in the Pallas interpreter, in
    float32, within 1e-5 of max|ref|."""
    b, n, heads = 2, 3, 2
    rng = np.random.default_rng(100 * f + d)
    xs = [rng.normal(size=(b, f, n, heads * d)).astype(np.float32) for _ in range(3)]
    ref = np.asarray(jtemp.temporal_attention_fm(*(jnp.asarray(x) for x in xs), heads=heads,
                                                 interpret=True))

    def rows(x):  # (B, F, N, H*D) -> (B*N*H, F, D), the body's items
        return torch.from_numpy(x).reshape(b, f, n, heads, d).permute(0, 2, 3, 1, 4) \
            .reshape(-1, f, d)
    got = _frames_body(*(rows(x) for x in xs))
    got = got.reshape(b, n, heads, f, d).permute(0, 3, 1, 2, 4).reshape(b, f, n, heads * d)
    err = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
    print(f"frames body F={f} D={d}: {err:.3g} of max|ref|")  # shown by pytest -rP
    assert err <= TOL, err


# --- the shape gate ---------------------------------------------------------

@pytest.fixture(scope="module")
def float32_sites():
    """{site: [the body that runs it, ...]} for one float32 zeroscope-v2-576w
    UNet call at 16 x 576x320, CFG batch 2, on the meta device."""
    seen = {"flash": [], "tail": [], "frame": [], "block": []}

    def flash(q, k, v, scale=None):
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        seen["flash"].append(tatt32.body(
            q.shape[1], k.shape[1], q.shape[3], tflash.f32_strides(q, k, v, out),
            [t.storage_offset() for t in (q, k, v, out)]))
        return out

    def tail(x, o1, ctx_k, ctx_v, params, *, heads, **kw):
        seen["tail"].append(ttail.f32_attention_body(
            x.shape[1], params["q2_w"].shape[0], heads, ctx_k.shape[1]))
        return torch.empty_like(x)

    def frame(q, k, v, *, heads, **kw):
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        d = q.shape[3] // heads
        seen["frame"].append(tatt32.body(
            q.shape[1], k.shape[1], d, tattn.f32_strides(1, d, q, k, v, out),
            [t.storage_offset() for t in (q, k, v, out)]))
        return out

    def block(x, params, *, heads, **kw):
        b, f, n, c = x.shape
        seen["block"].append(tblock.f32_attention_body(f, n, c, heads))
        return torch.empty_like(x)

    def same(x, *args, **kwargs):
        return torch.empty_like(x)

    spec = get_model_spec("zeroscope-v2-576w")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tops_attention, "flash_attention", flash)
        mp.setattr(layers, "fused_spatial_tail", tail)
        mp.setattr(layers, "temporal_attention", frame)
        mp.setattr(layers, "fused_temporal_block", block)
        for name in ("group_norm_act", "geglu_ff"):
            mp.setattr(layers, name, same)
        with torch.device("meta"):
            unet = unet3d.UNet3D(spec.unet).float()
            unet(torch.empty(2, 16, 40, 72, 4), torch.zeros(2, dtype=torch.long),
                 torch.empty(2, 77, 1024))
    return seen


def test_float32_sites_take_the_chosen_bodies(float32_sites):
    """Per UNet call: flash 10 and the fused tail 5 on the 64-row
    tensor-core body; frame-axis attention 22 and the fused block 6 (16
    frames a position) on the short-sequence body."""
    counts = {k: len(v) for k, v in float32_sites.items()}
    assert counts == {"flash": 10, "tail": 5, "frame": 22, "block": 6}
    assert set(float32_sites["flash"]) == set(float32_sites["tail"]) == {"mma"}
    assert set(float32_sites["frame"]) == set(float32_sites["block"]) == {"frames"}


def test_gate_sends_what_16_byte_copies_cannot_take_to_the_rows():
    q = torch.empty(1, 600, 2, 64, device="meta")
    assert tatt32.takes_tensor_cores(600, 64, tflash.f32_strides(q, q, q, q), [0])
    # a 66-lane row (264 bytes), a 2-float storage offset, odd widths, too
    # few query rows for one 64-row tile, a head wider than 128
    padded = torch.empty(1, 600, 2, 66, device="meta")[..., :64]
    assert not tatt32.takes_tensor_cores(600, 64, tflash.f32_strides(padded, q, q, q), [0])
    assert not tatt32.takes_tensor_cores(600, 64, tflash.f32_strides(q, q, q, q), [0, 2])
    assert tatt32.takes_tensor_cores(777, 40, [(777 * 40, 0, 40, 40)], [0])
    assert not tatt32.takes_tensor_cores(777, 42, [(777 * 42, 0, 42, 42)], [0])
    assert not tatt32.takes_tensor_cores(63, 64, [(63 * 64, 0, 64, 64)], [0])
    assert not tatt32.takes_tensor_cores(600, 136, [(600 * 136, 0, 136, 136)], [0])
    # the fused block's frame-axis attention at 64 frames and the tail at 20
    # tokens an image
    assert tblock.f32_attention_body(64, 3, 384, 6) == "mma"
    assert ttail.f32_attention_body(20, 64, 1, 16) == "rows"


def test_gate_sends_short_self_attention_to_the_frames_body():
    """1 <= Sq = Sk < 64 rows with 16-byte rows, bases and D <= 128 take the
    short-sequence body; odd strides, offsets, odd or wide heads and Sq !=
    Sk go to the CUDA-core rows; 64 rows and more to the mma body."""
    def fm(f, n, heads, d, row=None):  # frame-major (B, F, N, H*D) strides
        row = heads * d if row is None else row
        return [(f * n * row, row, n * row, d)]
    assert tatt32.body(16, 16, 64, fm(16, 720, 10, 64), [0]) == "frames"
    assert tatt32.body(1, 1, 64, fm(1, 7, 1, 64), [0]) == "frames"
    assert tatt32.body(63, 63, 128, fm(63, 7, 3, 128), [0]) == "frames"
    assert tatt32.body(24, 24, 40, fm(24, 2304, 8, 40), [0]) == "frames"
    assert tatt32.body(64, 64, 64, fm(64, 7, 2, 64), [0]) == "mma"
    assert tatt32.body(16, 16, 64, fm(16, 720, 10, 64, row=642), [0]) == "rows"  # odd rows
    assert tatt32.body(16, 16, 64, fm(16, 720, 10, 64), [0, 2]) == "rows"        # an offset
    assert tatt32.body(16, 16, 42, fm(16, 720, 10, 42), [0]) == "rows"          # odd D
    assert tatt32.body(16, 16, 136, fm(16, 720, 2, 136), [0]) == "rows"         # D > 128
    assert tatt32.body(16, 77, 64, fm(16, 720, 10, 64), [0]) == "rows"          # Sq != Sk
    # the fused block: 16 and 24 frames, 64 frames, a 384-wide head
    assert tblock.f32_attention_body(16, 2880, 320, 5) == "frames"
    assert tblock.f32_attention_body(24, 9216, 320, 8) == "frames"
    assert tblock.f32_attention_body(64, 3, 384, 6) == "mma"
    assert tblock.f32_attention_body(4, 70, 384, 1) == "rows"
