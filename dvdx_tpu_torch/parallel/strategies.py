"""Execution strategies: one denoiser, eight ways of spreading it over a mesh.

Counterpart of ``dvdx_tpu/parallel/strategies.py``, with the JAX presets'
names and fields:

  single     -- one device's program on every rank
  fsdp       -- parameters sharded over ``model`` (``parallel.sharding``)
  chunk      -- overlapping frame chunks as a batch, spread over ``seq``
  hybrid     -- fsdp + chunk
  hybrid_ctx -- hybrid + the CCI context (frame mean of z0, weight 0.35)
  cp_exact   -- frames sharded over ``seq`` with ring temporal attention
  cp_ulysses -- the same with Ulysses attention where the heads divide
  precond    -- ``pre_steps`` full-latent steps, then chunks

Where JAX's GSPMD places the collectives from shardings, the port issues
them: the videos of a batch split over ``data``, the chunk rows over
``seq`` (one all-gather stitches them before the float32 blend), the frames
of cp_exact / cp_ulysses over ``seq`` inside a ``ring_context`` (ring or
Ulysses attention, GroupNorm moments and conv halos across the group), and
the decode's frames over ``seq``. Each split applies where its axis divides
the work; elsewhere every rank of the axis computes the whole of it. The
value-preserving strategies (fsdp, cp_*) equal ``single`` up to the
accumulation order of the ring and the moments (fsdp bit for bit); the
chunked ones run another program, as in the reference.

``build_runner`` returns a runner whose call is (token ids (2, S), noise
key) -> frames (F, H, W, 3) float32, or (B, F, H, W, 3) for a batch; the
single strategy on one device is ``pipelines.text2video.generate_core`` bit
for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from ..models.vae import decode_frames_tiled
from ..ops import rng as rng_ops
from ..ops.attention import ring_context
from ..ops.scheduler import DDIMSchedule
from ..pipelines.text2video import Pipeline, denoise
from .chunking import ChunkPlan, auto_chunk_count, blend_chunks, gather_chunks, plan_chunks
from .sharding import shard_pipeline


@dataclasses.dataclass(frozen=True)
class Strategy:
    """A named configuration (the reference's --mode flag)."""

    name: str
    shard_params: bool = False
    chunked: bool = False
    num_chunks: int = 0          # 0 = auto
    overlap: int = 2
    context_weight: float = 0.0  # CCI weight (reference default 0.35)
    exact_cp: bool = False
    # exact-CP algorithm: 'ring', 'ulysses' (heads must divide the seq
    # axis), 'auto' (Ulysses where they divide, ring elsewhere)
    cp_algo: str = "ring"
    # full-latent pre-conditioning steps before the chunks ("Strategy C")
    pre_steps: int = 0


PRESETS: Dict[str, Strategy] = {
    "single": Strategy("single"),
    "fsdp": Strategy("fsdp", shard_params=True),
    "chunk": Strategy("chunk", chunked=True),
    "hybrid": Strategy("hybrid", shard_params=True, chunked=True),
    "hybrid_ctx": Strategy("hybrid_ctx", shard_params=True, chunked=True,
                           context_weight=0.35),
    "cp_exact": Strategy("cp_exact", shard_params=True, exact_cp=True),
    "cp_ulysses": Strategy("cp_ulysses", shard_params=True, exact_cp=True,
                           cp_algo="auto"),
    "precond": Strategy("precond", chunked=True, pre_steps=2),
}


def get_strategy(name: str, **overrides) -> Strategy:
    if name not in PRESETS:
        raise KeyError(f"unknown strategy {name!r}; available: {sorted(PRESETS)}")
    return dataclasses.replace(PRESETS[name], **overrides) if overrides else PRESETS[name]


def _gather_cat(x: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """Concatenate the ranks' x along ``dim`` over the subgroup of ``axes``
    (rank order); x itself on a one-rank axis or without a group."""
    group, size = mesh.group(axes), mesh.size(axes)
    if group is None or size == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _my_rows(n: int, mesh, axes):
    """This rank's contiguous block of n rows over ``axes``, or all n rows
    where the axis size does not divide them."""
    size = mesh.size(axes)
    if size == 1 or n % size:
        return 0, n, False
    per = n // size
    i = mesh.index(axes)
    return i * per, (i + 1) * per, True


@dataclasses.dataclass
class StrategyRunner:
    """A built strategy: call it with (token ids, noise key). ``close``
    gives the pipeline its whole parameters back."""

    strategy: Strategy
    mesh: object
    plan: Optional[ChunkPlan]
    fn: Callable
    sched: DDIMSchedule
    num_frames: int
    height: int
    width: int
    shards: List = dataclasses.field(default_factory=list)

    def __call__(self, token_ids: torch.Tensor, noise_key: torch.Tensor) -> torch.Tensor:
        return self.fn(token_ids, noise_key)

    def close(self) -> None:
        for s in self.shards:
            s.remove()
        self.shards = []


def decode_latents(pipe: Pipeline, z: torch.Tensor, mesh) -> torch.Tensor:
    """(N, h, w, C) float32 latents -> (N, H, W, 3) frames: the rows split
    over the mesh's seq axis where it divides them, one frame per decoder
    call (the pipeline's own decode)."""
    lo, hi, split = _my_rows(z.shape[0], mesh, ("seq",))
    frames = decode_frames_tiled(pipe.vae_decoder, z[lo:hi])
    return _gather_cat(frames, mesh, ("seq",)) if split else frames


def build_runner(pipe: Pipeline, strategy: Strategy, mesh, *, num_frames: int,
                 height: int, width: int, num_steps: int, guidance_scale: float = 7.5,
                 latent_dtype: torch.dtype = torch.bfloat16,
                 batch_size: int = 1) -> StrategyRunner:
    """One strategy at a fixed geometry. ``batch_size`` > 1 generates a
    batch of videos, video b from fold_in(key, b), split over the data axis;
    the output then has a leading batch axis."""
    spec = pipe.spec
    ds = spec.vae.downscale
    lh, lw, c = height // ds, width // ds, spec.latent_channels
    sched = spec.ddim_schedule(num_steps)
    seq = mesh.shape["seq"]
    if strategy.exact_cp and seq > 1:
        if spec.kind != "unet3d":
            raise ValueError(f"{strategy.name}: exact context parallelism runs the "
                             f"UNet3D families, not {spec.name}")
        if num_frames % seq:
            raise ValueError(f"{strategy.name}: {num_frames} frames do not split "
                             f"over a seq axis of {seq}")

    plan = None
    if strategy.chunked:
        n = strategy.num_chunks or auto_chunk_count(num_frames, seq)
        plan = plan_chunks(num_frames, n, strategy.overlap)
    cw = strategy.context_weight
    bsz = batch_size
    shards = shard_pipeline(pipe, mesh) if strategy.shard_params else []

    @torch.inference_mode()
    def core(token_ids: torch.Tensor, noise_key: torch.Tensor) -> torch.Tensor:
        dev = pipe.device
        hidden, _ = pipe.text_encoder(token_ids.to(dev))
        uncond, cond = hidden[0:1], hidden[1:2]
        if bsz == 1:
            z0_full = rng_ops.video_noise(noise_key, num_frames, (lh, lw, c), device=dev)[None]
        else:
            z0_full = torch.stack([
                rng_ops.video_noise(rng_ops.fold_in(noise_key, b), num_frames, (lh, lw, c),
                                    device=dev) for b in range(bsz)])
        # this rank's videos over the data axis
        b0, b1, data_split = _my_rows(bsz, mesh, ("data",))
        z0 = z0_full[b0:b1]
        nb = b1 - b0
        cond_b = cond.expand(nb, *cond.shape[1:])
        uncond_b = uncond.expand(nb, *uncond.shape[1:])
        ctx = z0.mean(dim=1, keepdim=True) if cw > 0.0 else None  # (B, 1, h, w, C)

        if strategy.chunked:
            z_start = z0.to(latent_dtype)
            pre = min(strategy.pre_steps, num_steps)
            if pre > 0:
                z_start = denoise(pipe.unet, sched, z_start, cond_b, uncond_b,
                                  guidance_scale, context_latent=ctx, context_weight=cw,
                                  step_range=(0, pre))
            n = plan.num_chunks
            rows = gather_chunks(z_start, plan).reshape(nb * n, plan.chunk_len, lh, lw, c)
            cond_n = cond_b.repeat_interleave(n, dim=0)
            uncond_n = uncond_b.repeat_interleave(n, dim=0)
            ctx_n = ctx.repeat_interleave(n, dim=0) if ctx is not None else None
            r0, r1, split = _my_rows(nb * n, mesh, ("seq",))
            zf = denoise(pipe.unet, sched, rows[r0:r1].to(latent_dtype), cond_n[r0:r1],
                         uncond_n[r0:r1], guidance_scale,
                         context_latent=None if ctx_n is None else ctx_n[r0:r1],
                         context_weight=cw, step_range=(pre, num_steps))
            if split:
                zf = _gather_cat(zf, mesh, ("seq",))  # the stitch
            zf = zf.reshape(nb, n, plan.chunk_len, lh, lw, c)
            z_final = blend_chunks(zf.float(), plan)
        elif strategy.exact_cp and seq > 1:
            fl = num_frames // seq
            off = mesh.index(("seq",)) * fl
            positions = torch.arange(off, off + fl, device=dev)
            with ring_context(mesh, "seq", algo=strategy.cp_algo):
                zf = denoise(pipe.unet, sched, z0[:, off:off + fl].to(latent_dtype), cond_b,
                             uncond_b, guidance_scale, frame_positions=positions)
            z_final = _gather_cat(zf, mesh, ("seq",), dim=1).float()
        else:
            zf = denoise(pipe.unet, sched, z0.to(latent_dtype), cond_b, uncond_b,
                         guidance_scale, context_latent=ctx, context_weight=cw)
            z_final = zf.float()

        frames = decode_latents(pipe, z_final.reshape(nb * num_frames, lh, lw, c), mesh)
        frames = frames.reshape(nb, num_frames, *frames.shape[1:])
        if data_split:
            frames = _gather_cat(frames, mesh, ("data",))
        return frames if bsz > 1 else frames[0]

    return StrategyRunner(strategy=strategy, mesh=mesh, plan=plan, fn=core, sched=sched,
                          num_frames=num_frames, height=height, width=width, shards=shards)
