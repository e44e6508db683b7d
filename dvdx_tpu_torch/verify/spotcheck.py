"""Spot-check re-execution of revealed steps: the validator's half of Proof
of Inference, single device.

Counterpart of ``dvdx_tpu/verify/spotcheck.py`` (its single-device
``StepEngine`` and the module-level checks). Miner and validator run the same
step program -- ``pipelines.text2video.cfg_denoise_step`` on the same
weights, one batch-1 latent per call -- so a revealed (z_i, eps_i, z_{i+1})
triple is checked by re-execution:

  eps_i'   = UNet_cfg(z_i, t_i, text(prompt))   must equal eps_i
  z_{i+1}' = ddim_step(z_i, eps_i')             must equal z_{i+1}

On one platform every kernel of the step has a fixed launch shape and no
atomics (and cuDNN / cuBLAS run their deterministic algorithms), so the
re-execution reproduces the leaves bit for bit. Across platforms (a CUDA
miner, a CPU validator, or the JAX package on either side) the check is a
tolerance: the engine's ``platform_tag`` is what a miner pins, and the
validator picks its regime from it. The tag names the implementation as well
as the device ("torch-cuda", "torch-cpu"), so a JAX validator, whose own
tags are its backend names ("cpu", "tpu"), never takes a torch miner for one
of its own programs; it holds no ":", which the validators read as the start
of a strategy name.

Leaves are bfloat16 in channel-last (F, h, w, C) layout. numpy has no
bfloat16 of its own, so the engine hands them out as bfloat16 CPU tensors
(the ``verify.merkle`` leaf format); the checks take those or numpy arrays,
including the JAX package's ``ml_dtypes`` bfloat16 arrays, read by their
bytes.

Strategies (``parallel.strategies``): an engine built with ``strategy=``
(and optionally ``mesh=``) runs that strategy's step program. A chunked
strategy (chunk, hybrid, hybrid_ctx) changes the program even on one
device: its leaves are the chunk-stacked (n, L, h, w, C) latents of the plan
fixed by (frames, num_chunks, overlap), which a miner commits in its
response, and ``chunk_prep_fn`` is the one function both sides derive the
initial chunk stack and the CCI context with. On a mesh the parameters are
sharded over ``model`` (fsdp and hybrid*; the engine shards the pipeline
it is given, in place, and ``close`` gives the parameters back, so a caller
whose pipeline others share hands it a copy), the chunk rows split over
``seq``, or for cp_exact / cp_ulysses the frames split over ``seq`` with
ring / Ulysses attention. Such an engine's tag is "torch-<device>:<strategy>"
(the validator's per-strategy regime); precond is refused (its full-latent
phase changes the leaf shape mid-trace), and a value-preserving strategy
without a mesh is the plain program. On a mesh of several ranks every rank
must run each generation: rank 0 broadcasts the call (``generate_recorded``)
and the other ranks serve it (``follow``) until ``release_followers``.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import rng as rng_ops
from ..ops.attention import ring_context
from ..ops.scheduler import ddim_step
from ..parallel.chunking import auto_chunk_count, blend_chunks, gather_chunks, plan_chunks
from ..pipelines.text2video import Pipeline, cfg_denoise_step, generate_core, to_uint8
from ..utils.bridge import to_tensor
from ..utils.profiling import span
from .proof import sample_distinct_indices


# one multi-rank generation at a time in a process: the ranks' collectives
# must meet in one order (the mock network serves miners from a thread pool)
_MESH_LOCK = threading.Lock()


class StepEngine:
    """The prover / verifier step program of a ``Pipeline`` on its device,
    optionally of a strategy and on a mesh (see the module docstring)."""

    def __init__(self, pipeline: Pipeline, mesh=None, strategy=None):
        self.mesh = mesh
        if strategy is None and mesh is not None:
            strategy = "fsdp"
        if strategy is not None:
            from ..parallel.strategies import get_strategy

            if isinstance(strategy, str):
                strategy = get_strategy(strategy)
            if strategy.name == "single" or (mesh is None and not strategy.chunked):
                # the plain program: value-preserving strategies without a
                # mesh, and single anywhere
                strategy = None
        if strategy is not None and strategy.pre_steps:
            raise ValueError(
                "PoI does not compose with the precond strategy: its full-latent "
                "pre-phase changes the leaf shape mid-trace (commit a hybrid / "
                "hybrid_ctx plan instead)")
        self.strategy = strategy
        self._shards = []
        if strategy is not None and mesh is not None and strategy.shard_params \
                and mesh.group(("model",)) is not None:
            from ..parallel.sharding import shard_pipeline

            self._shards = shard_pipeline(pipeline, mesh)  # in place
        self.pipe = pipeline
        self._plans: Dict[tuple, object] = {}
        self._following = False

    @property
    def platform_tag(self) -> str:
        """What this engine's miner pins at registration: "torch-cuda" on
        the card, "torch-cpu" on the CPU, with ":<strategy>" where a strategy
        changes the program or its accumulation order. The CUDA kernels are
        built for sm_90a alone, so "torch-cuda" is always a Hopper card."""
        kind = self.pipe.device.type
        if kind not in ("cuda", "cpu"):
            raise ValueError(f"StepEngine: unsupported device {self.pipe.device}")
        tag = f"torch-{kind}"
        return f"{tag}:{self.strategy.name}" if self.strategy is not None else tag

    # -- strategies --

    @property
    def chunked(self) -> bool:
        return self.strategy is not None and self.strategy.chunked

    def chunk_plan(self, num_frames: int):
        """The committed chunk plan at F frames: the strategy's num_chunks,
        or auto-sized from the mesh's seq axis as the strategy runner does;
        None for an unchunked engine."""
        if not self.chunked:
            return None
        n = self.strategy.num_chunks
        if not n:
            n = auto_chunk_count(num_frames, self.mesh.shape["seq"] if self.mesh else 1)
        key = (num_frames, n, self.strategy.overlap)
        if key not in self._plans:
            self._plans[key] = plan_chunks(num_frames, n, self.strategy.overlap)
        return self._plans[key]

    def chunk_prep_fn(self, num_frames: int, lh: int, lw: int, c: int,
                      latent_dtype: torch.dtype = torch.bfloat16):
        """The one function prover and verifier derive a chunked trace's
        start from: seed key -> (the chunk-stacked initial latent (n, L, h,
        w, C) in latent_dtype, the CCI context (1, 1, h, w, C) float32, the
        frame mean of the base noise), on the engine's device."""
        plan = self.chunk_plan(num_frames)
        dev = self.pipe.device

        def prep(key):
            z0 = rng_ops.video_noise(key, num_frames, (lh, lw, c), device=dev)
            ctx = z0.mean(dim=0, keepdim=True)[None]
            return gather_chunks(z0[None].to(latent_dtype), plan)[0], ctx

        return prep

    def context_latent(self, seed: int, num_frames: int, height: int, width: int,
                       latent_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        """The verifier's CCI context, re-derived from the committed seed."""
        spec = self.pipe.spec
        ds = spec.vae.downscale
        with torch.inference_mode():
            return self.chunk_prep_fn(num_frames, height // ds, width // ds,
                                      spec.latent_channels, latent_dtype)(
                rng_ops.base_key(seed))[1]

    def _gather(self, x: torch.Tensor, split: bool, dim: int = 0) -> torch.Tensor:
        from ..parallel.strategies import _gather_cat

        return _gather_cat(x, self.mesh, ("seq",), dim) if split else x

    def _strategy_step(self, z, step_index: int, sched, cond, uncond,
                       guidance_scale: float, cfg_split: bool, ctx=None):
        """One step of the strategy's program on z with its batch axis: the
        chunk stack (n, L, h, w, C), or (1, F, h, w, C)."""
        from ..parallel.strategies import _my_rows

        st, mesh, unet = self.strategy, self.mesh, self.pipe.unet
        if st.chunked:
            n = z.shape[0]
            cw = st.context_weight
            cond_n, uncond_n = cond.repeat_interleave(n, 0), uncond.repeat_interleave(n, 0)
            ctx_n = (ctx.to(z.device).repeat_interleave(n, 0)
                     if ctx is not None and cw > 0.0 else None)
            r0, r1, split = (_my_rows(n, mesh, ("seq",)) if mesh is not None
                             else (0, n, False))
            z_next, eps = cfg_denoise_step(
                unet, sched, z[r0:r1], step_index, cond_n[r0:r1], uncond_n[r0:r1],
                guidance_scale, context_latent=None if ctx_n is None else ctx_n[r0:r1],
                context_weight=cw, cfg_split=cfg_split)
            return self._gather(z_next, split), self._gather(eps, split)
        seq = mesh.shape["seq"]
        if st.exact_cp and seq > 1:
            f = z.shape[1]
            fl = f // seq
            off = mesh.index(("seq",)) * fl
            with ring_context(mesh, "seq", algo=st.cp_algo):
                z_next, eps = cfg_denoise_step(
                    unet, sched, z[:, off:off + fl], step_index, cond, uncond,
                    guidance_scale, frame_positions=torch.arange(off, off + fl,
                                                                 device=z.device),
                    cfg_split=cfg_split)
            return self._gather(z_next, True, 1), self._gather(eps, True, 1)
        return cfg_denoise_step(unet, sched, z, step_index, cond, uncond, guidance_scale,
                                cfg_split=cfg_split)

    def _decode_video(self, z: torch.Tensor, num_frames: int) -> torch.Tensor:
        """Final latent (with its batch axis) -> uint8 video: the chunk stack
        ramp-blended first; frames split over the mesh's seq axis."""
        from ..parallel.strategies import decode_latents

        if self.chunked:
            zf = blend_chunks(z.float()[None], self.chunk_plan(num_frames))[0]
        else:
            zf = z[0].float()
        with span("vae_decode"):
            if self.mesh is None:
                from ..models.vae import decode_frames_tiled

                frames = decode_frames_tiled(self.pipe.vae_decoder, zf)
            else:
                frames = decode_latents(self.pipe, zf, self.mesh)
        return to_uint8(frames)

    @property
    def _multi_rank(self) -> bool:
        return self.mesh is not None and self.mesh.world_size > 1

    def follow(self) -> int:
        """A non-leading rank of a mesh engine: run every generation rank 0
        broadcasts, until it releases the followers; returns the count."""
        import torch.distributed as dist

        served = 0
        self._following = True
        try:
            while True:
                box = [None]
                dist.broadcast_object_list(box, src=0)
                if box[0] is None:
                    return served
                self.generate_recorded(**box[0])
                served += 1
        finally:
            self._following = False

    def release_followers(self) -> None:
        """Rank 0: end the other ranks' ``follow``."""
        import torch.distributed as dist

        if self._multi_rank:
            dist.broadcast_object_list([None], src=0)

    def close(self) -> None:
        """The sharded pipeline's whole parameters back (an engine that
        sharded nothing has nothing to do)."""
        for s in self._shards:
            s.remove()
        self._shards = []

    def _schedule(self, num_steps: int):
        return self.pipe.spec.ddim_schedule(num_steps)

    def _encode(self, prompt: str, negative_prompt: str):
        """(uncond, cond) text states, from the same (2, S) encoder call
        generation makes."""
        ids = torch.from_numpy(self.pipe.tokenize([negative_prompt, prompt])).long()
        with span("wait.ids_upload"):
            ids = ids.to(self.pipe.device)
        with span("text_encode"):
            hidden, _ = self.pipe.text_encoder(ids)
        return hidden[0:1], hidden[1:2]

    # -- prover path --

    @torch.inference_mode()
    def generate_recorded(self, prompt: str, *, negative_prompt: str = "",
                          seed: int = 0, num_frames: int, height: int, width: int,
                          num_steps: int, guidance_scale: float,
                          latent_dtype: torch.dtype = torch.bfloat16,
                          segment_steps: int = 5, cfg_split: bool = False,
                          timings: Optional[dict] = None):
        """PoI-grade generation through the step program the verifier runs,
        driven in segments of ``segment_steps`` steps (``generate_core``: the
        leaves are the same bits whatever the segment length). Returns
        (video (F, H, W, 3) uint8 numpy, zs, epss, timesteps): zs and epss
        are (N, F, h, w, C) CPU tensors in latent_dtype, timesteps (N,)
        int32 numpy. ``timings`` (optional dict) receives host seconds per
        phase: "dispatch_loop" (text, noise, the denoise loop and the decode
        handed to the device), "compute_wall" (until the device is done),
        "leaf_fetch" and "video_fetch" (the copies to the host)."""
        if self.strategy is not None:
            call = dict(prompt=prompt, negative_prompt=negative_prompt, seed=seed,
                        num_frames=num_frames, height=height, width=width,
                        num_steps=num_steps, guidance_scale=guidance_scale,
                        latent_dtype=latent_dtype, cfg_split=cfg_split)
            if not self._multi_rank or self._following:
                return self._generate_strategy(call, timings)
            import torch.distributed as dist

            with _MESH_LOCK:
                dist.broadcast_object_list([call], src=0)
                return self._generate_strategy(call, timings)
        with span("dispatch_loop", timings):
            sched = self._schedule(num_steps)
            ids = torch.from_numpy(self.pipe.tokenize([negative_prompt, prompt])).long()
            with span("wait.ids_upload"):
                ids = ids.to(self.pipe.device)
            frames, zs, epss = generate_core(
                self.pipe, ids, rng_ops.base_key(seed), sched=sched,
                num_frames=num_frames, height=height, width=width,
                guidance_scale=guidance_scale, record=True, latent_dtype=latent_dtype,
                cfg_split=cfg_split, segment_steps=segment_steps)
            video = to_uint8(frames)
        _wait_compute(video, timings)
        zs, epss = zs[:, 0], epss[:, 0]
        with span("wait.leaf_fetch", timings, key="leaf_fetch"):
            zs, epss = zs.cpu(), epss.cpu()
        return _fetch_video(video, timings), zs, epss, sched.timesteps.copy()

    def _generate_strategy(self, call: dict, timings: Optional[dict]):
        """generate_recorded through the strategy's step program; the leaves
        are (N, n, L, h, w, C) for a chunked engine."""
        with span("dispatch_loop", timings):
            spec = self.pipe.spec
            ds = spec.vae.downscale
            f, lh, lw, c = call["num_frames"], call["height"] // ds, call["width"] // ds, \
                spec.latent_channels
            dev = self.pipe.device
            sched = self._schedule(call["num_steps"])
            uncond, cond = self._encode(call["prompt"], call["negative_prompt"])
            key = rng_ops.base_key(call["seed"])
            ctx = None
            with span("base_noise"):
                if self.chunked:
                    z, ctx = self.chunk_prep_fn(f, lh, lw, c, call["latent_dtype"])(key)
                else:
                    z = rng_ops.video_noise(key, f, (lh, lw, c), device=dev)[None].to(
                        call["latent_dtype"])
            zs, epss = [], []
            for i in range(call["num_steps"]):
                z_next, eps = self._strategy_step(z, i, sched, cond, uncond,
                                                  call["guidance_scale"], call["cfg_split"],
                                                  ctx)
                zs.append(z)
                epss.append(eps)
                z = z_next
            video = self._decode_video(z, f)
        _wait_compute(video, timings)
        # the leaves are stacked on the card inside their fetch's timing
        with span("wait.leaf_fetch", timings, key="leaf_fetch"):
            zs, epss = torch.stack(zs), torch.stack(epss)
            if not self.chunked:
                zs, epss = zs[:, 0], epss[:, 0]
            zs, epss = zs.cpu(), epss.cpu()
        return _fetch_video(video, timings), zs, epss, sched.timesteps.copy()

    # -- verifier path --

    def _step(self, z_i, step_index: int, sched, cond, uncond,
              guidance_scale: float, cfg_split: bool, ctx=None):
        z = as_tensor(z_i)
        with span("wait.step_upload"):
            z = z.to(self.pipe.device)
        if self.chunked:  # the chunk stack is the batch
            z_next, eps = self._strategy_step(z, step_index, sched, cond, uncond,
                                              guidance_scale, cfg_split, ctx)
        else:
            if self.strategy is not None:
                z_next, eps = self._strategy_step(z[None], step_index, sched, cond, uncond,
                                                  guidance_scale, cfg_split)
            else:
                z_next, eps = cfg_denoise_step(self.pipe.unet, sched, z[None], step_index,
                                               cond, uncond, guidance_scale,
                                               cfg_split=cfg_split)
            z_next, eps = z_next[0], eps[0]
        with span("wait.step_fetch"):
            return eps.cpu(), z_next.cpu()

    @torch.inference_mode()
    def reexecute_pair(self, prompt: str, negative_prompt: str, z_i,
                       step_index: int, num_steps: int, guidance_scale: float,
                       cfg_split: bool = False, ctx=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (eps_i', z_{i+1}') recomputed from z_i (F, h, w, C), or from
        the chunk stack (n, L, h, w, C) with the seed-derived CCI context
        ``ctx`` (``context_latent``) for a chunked engine."""
        uncond, cond = self._encode(prompt, negative_prompt)
        return self._step(z_i, step_index, self._schedule(num_steps), cond, uncond,
                          guidance_scale, cfg_split, ctx)

    @torch.inference_mode()
    def reexecute_steps(self, prompt: str, negative_prompt: str, z_list: Sequence,
                        step_indices: Sequence[int], num_steps: int,
                        guidance_scale: float, cfg_split: bool = False, ctx=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """All k sampled steps after one text encode, one step call each
        (the call generation makes) -> (eps' (k, ...), z_next' (k, ...))."""
        uncond, cond = self._encode(prompt, negative_prompt)
        sched = self._schedule(num_steps)
        out = [self._step(z, i, sched, cond, uncond, guidance_scale, cfg_split, ctx)
               for z, i in zip(z_list, step_indices)]
        return torch.stack([e for e, _ in out]), torch.stack([z for _, z in out])

    @torch.inference_mode()
    def decode_frame(self, z_frame) -> np.ndarray:
        """Decode one latent frame (h, w, C) -> (H, W, 3) float32 numpy in
        [-1, 1], through the per-frame call generation's decode makes."""
        # through the host: a latent on the card is fetched, then copied back
        with span("wait.frame_upload"):
            z = as_tensor(z_frame).to(self.pipe.device)
        with span("vae_decode"):
            frame = self.pipe.vae_decoder(z.float()[None])[0]
        with span("wait.decode_fetch"):
            return frame.cpu().numpy()

    def verify_video_binding(self, video_frames: np.ndarray,
                             last_leaf: Tuple[int, object, object],
                             last_index: int, num_steps: int,
                             guidance_scale: float, prompt: str,
                             negative_prompt: str = "",
                             frame_indices: Sequence[int] = (0,),
                             max_err: float = 0.12,
                             num_frames: int = 0) -> Tuple[bool, float]:
        """Bind the delivered video to the committed trace: re-derive z_final
        from the revealed last leaf (ddim_step on the engine's device, as
        generation takes it), decode the frames at ``frame_indices`` and
        compare each, 4x average-pooled, against the delivered frame.
        A chunked engine ramp-blends the final chunk stack to ``num_frames``
        frames first. Returns (all_ok, worst mean absolute error)."""
        if last_index != num_steps - 1:
            raise ValueError("video binding requires the final leaf (T-1); "
                             "the final eps must also be re-executed so a "
                             "forged eps_{T-1} cannot bind a substitute video")
        _t, z_last, eps_last = last_leaf
        dev = self.pipe.device
        z_last, eps_last = as_tensor(z_last), as_tensor(eps_last)
        with span("wait.leaf_upload"):
            z_last, eps_last = z_last.to(dev), eps_last.to(dev)
        with span("ddim_update"):
            z_next = ddim_step(self._schedule(num_steps), last_index, z_last[None],
                               eps_last[None])[0]
        if self.chunked:
            if not num_frames:
                raise ValueError("chunked video binding requires num_frames")
            z_next = blend_chunks(z_next.float()[None], self.chunk_plan(num_frames))[0]

        def pool(x, k=4):
            h, w, c = x.shape
            h2, w2 = h - h % k, w - w % k
            return x[:h2, :w2].reshape(h2 // k, k, w2 // k, k, c).mean((1, 3))

        # the delivered video's frame count is miner-controlled: a short
        # video fails the binding
        if len(video_frames) < z_next.shape[0]:
            return False, float("inf")
        worst = 0.0
        for frame_idx in frame_indices:
            decoded = self.decode_frame(z_next[frame_idx])
            with span("compare"):
                got = video_frames[frame_idx].astype(np.float32) / 127.5 - 1.0
                if decoded.shape != got.shape:
                    return False, float("inf")
                err = float(np.mean(np.abs(pool(decoded) - pool(got))))
            worst = max(worst, err)
            if err > max_err:
                return False, worst
        return True, worst

    @torch.inference_mode()
    def base_latent(self, seed: int, num_frames: int, height: int, width: int,
                    latent_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        """The miner's base noise re-derived from the 64-bit seed, on the
        engine's device as generation draws it -> (F, h, w, C) CPU tensor;
        the gathered chunk stack (n, L, h, w, C) for a chunked engine."""
        spec = self.pipe.spec
        ds = spec.vae.downscale
        if self.chunked:
            noise = self.chunk_prep_fn(num_frames, height // ds, width // ds,
                                       spec.latent_channels, latent_dtype)(
                rng_ops.base_key(seed))[0]
        else:
            noise = rng_ops.video_noise(rng_ops.base_key(seed), num_frames,
                                        (height // ds, width // ds, spec.latent_channels),
                                        device=self.pipe.device).to(latent_dtype)
        with span("wait.noise_fetch"):
            return noise.cpu()


def _wait_compute(video: torch.Tensor, timings: Optional[dict]) -> None:
    """Wait for the card to finish the generation it was handed."""
    with span("wait.compute", timings, key="compute_wall"):
        if video.is_cuda:
            torch.cuda.current_stream(video.device).synchronize()


def _fetch_video(video: torch.Tensor, timings: Optional[dict]) -> np.ndarray:
    with span("wait.video_fetch", timings, key="video_fetch"):
        return video.cpu().numpy()


@dataclasses.dataclass
class CheckResult:
    passed: bool
    reason: str = ""
    max_eps_err: float = 0.0
    max_z_err: float = 0.0
    bitwise: bool = False


def as_tensor(x) -> torch.Tensor:
    """A leaf as a CPU tensor: torch tensors as they are, numpy arrays
    (ml_dtypes bfloat16 included, by their bytes) copied."""
    return x.detach().cpu() if isinstance(x, torch.Tensor) else to_tensor(x)


def _bytes(t: torch.Tensor) -> bytes:
    return t.contiguous().view(-1).view(torch.uint8).numpy().tobytes()


def compare_arrays(got, expected, *, bitwise: bool, atol: float,
                   rtol: float = 0.0) -> Tuple[bool, float, bool]:
    """-> (ok, max_abs_err, was_bitwise).

    Identical bytes pass with was_bitwise=True. Otherwise each element is
    judged against atol + rtol * |expected| in float32: with bitwise=True
    (same platform) that is the validator's calibrated same-program bound,
    with bitwise=False the cross-platform tolerance."""
    a, b = as_tensor(got), as_tensor(expected)
    if tuple(a.shape) != tuple(b.shape):
        return False, float("inf"), False
    if _bytes(a) == _bytes(b):
        return True, 0.0, True
    a, b = a.float(), b.float()
    diff = (a - b).abs()
    err = float(diff.max())
    ok = bool((diff <= atol + rtol * b.abs()).all())
    return ok, err, False


def binding_frame_indices(audit_secret: bytes, merkle_root: bytes,
                          num_frames: int, k: int = 2) -> List[int]:
    """Video-binding frame indices from the post-commit audit secret: k
    distinct frames, unpredictable at commit time."""
    return sample_distinct_indices(b"frame", audit_secret + merkle_root, num_frames, k)


def verify_revealed_steps(
    engine: StepEngine, prompt: str, negative_prompt: str,
    leaves: Dict[int, Tuple[int, object, object]], checks: Sequence[int],
    num_steps: int, guidance_scale: float, *, same_platform: bool,
    atol: float = 5e-2, rtol: float = 0.0, cfg_split: bool = False, ctx=None,
) -> Tuple[Dict[int, CheckResult], torch.Tensor]:
    """Re-execute every sampled step after one text encode. A step that
    fails is re-verified with the single-step path before it is declared a
    cheat. Returns ({step_index: CheckResult}, z_next_re (k, ...))."""
    checks = list(checks)
    eps_re, z_next_re = engine.reexecute_steps(
        prompt, negative_prompt, [leaves[i][1] for i in checks], checks,
        num_steps, guidance_scale, cfg_split=cfg_split, ctx=ctx)
    results: Dict[int, CheckResult] = {}
    for row, i in enumerate(checks):
        _t, _z_i, eps_i = leaves[i]
        with span("compare"):
            ok_e, err_e, bit_e = compare_arrays(eps_re[row], eps_i, bitwise=same_platform,
                                                atol=atol, rtol=rtol)
            ok_z, err_z, bit_z = True, 0.0, True
            if i + 1 in leaves:
                ok_z, err_z, bit_z = compare_arrays(z_next_re[row], leaves[i + 1][1],
                                                    bitwise=same_platform, atol=atol,
                                                    rtol=rtol)
        if ok_e and ok_z:
            results[i] = CheckResult(True, "ok", err_e, err_z, bit_e and bit_z)
            continue
        results[i] = verify_revealed_step(
            engine, prompt, negative_prompt, leaves[i], i, num_steps,
            guidance_scale, same_platform=same_platform, atol=atol, rtol=rtol,
            next_leaf=leaves.get(i + 1), cfg_split=cfg_split, ctx=ctx)
    return results, z_next_re


def verify_revealed_step(engine: StepEngine, prompt: str, negative_prompt: str,
                         leaf_i: Tuple[int, object, object], step_index: int,
                         num_steps: int, guidance_scale: float, *,
                         same_platform: bool,
                         next_leaf: Optional[Tuple[int, object, object]] = None,
                         atol: float = 5e-2, rtol: float = 0.0,
                         cfg_split: bool = False, ctx=None) -> CheckResult:
    """Full re-execution check of sampled step i: eps_i always, z_{i+1} too
    when next_leaf (step i + 1) is given."""
    _t_i, z_i, eps_i = leaf_i
    eps_re, z_next_re = engine.reexecute_pair(prompt, negative_prompt, z_i, step_index,
                                              num_steps, guidance_scale,
                                              cfg_split=cfg_split, ctx=ctx)
    ok_e, err_e, bit_e = compare_arrays(eps_re, eps_i, bitwise=same_platform,
                                        atol=atol, rtol=rtol)
    if not ok_e:
        return CheckResult(False, "eps re-execution mismatch", err_e, 0.0, bit_e)
    if next_leaf is None:
        return CheckResult(True, "ok", err_e, 0.0, bit_e)
    ok_z, err_z, bit_z = compare_arrays(z_next_re, next_leaf[1], bitwise=same_platform,
                                        atol=atol, rtol=rtol)
    if not ok_z:
        return CheckResult(False, "z_{t+1} re-derivation mismatch", err_e, err_z, bit_z)
    return CheckResult(True, "ok", err_e, err_z, bit_e and bit_z)
