"""Text -> video latent-diffusion pipeline with Proof-of-Inference recording.

Counterpart of ``dvdx_tpu/pipelines/text2video.py``: encode the
[negative, prompt] pair, draw the base noise from the seed (bit-equal to the
reference's), run the classifier-free-guided DDIM loop, decode frame by
frame. ``generate(..., record=True)`` also returns the per-step (z_t, eps_t)
pairs a miner commits to a Merkle tree (``verify/merkle.py``).

Determinism: given (weights, seed, prompt tokens, schedule, guidance) every
tensor this module produces is a pure function of its inputs on one platform.
On CUDA, ``build_pipeline`` sets the deterministic-algorithm flags
(``dvdx_tpu_torch.enable_determinism``) and every kernel of the path has a
fixed launch shape and no atomics, so a re-executed step reproduces its
leaves bit for bit.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from .. import enable_determinism
from ..models.dit_video import VideoDiT
from ..models.text_encoder import CLIPTextEncoder, tokenize_batch
from ..models.unet3d import UNet3D
from ..models.vae import VAEDecoder, decode_frames_tiled
from ..models.zoo import ModelSpec, get_model_spec
from ..ops import rng as rng_ops
from ..ops.scheduler import DDIMSchedule, ddim_step, make_ddim_schedule
from ..utils.bridge import load_flat_npz, load_tree, save_flat_npz
from ..utils.init import fast_init
from ..utils.profiling import span


Denoiser = Union[UNet3D, VideoDiT]


class Pipeline(nn.Module):
    """The three modules of one model family, on one device, and the
    tokenizer: a checkpoint's CLIP BPE tokenizer (``models/tokenizer.py``),
    or None for the parameter-free hash tokenizer of random-init models.
    ``unet`` is the family's denoiser, a UNet3D or a VideoDiT (one call
    signature), under the reference's name for it."""

    def __init__(self, spec: ModelSpec, unet: Denoiser, text_encoder: CLIPTextEncoder,
                 vae_decoder: VAEDecoder, tokenizer=None):
        super().__init__()
        self.spec = spec
        self.unet = unet
        self.text_encoder = text_encoder
        self.vae_decoder = vae_decoder
        self.tokenizer = tokenizer

    @property
    def device(self) -> torch.device:
        return next(self.unet.parameters()).device

    def flax_trees(self) -> dict:
        """The reference's ``Pipeline.params`` names of the three modules."""
        return {"unet": self.unet, "text": self.text_encoder, "vae_dec": self.vae_decoder}

    def tokenize(self, texts: List[str]) -> np.ndarray:
        """Prompts -> (B, max_length) int32 ids. Part of the PoI chain: miner
        and validator hold the same tokenizer (the checkpoint's, or the hash
        tokenizer)."""
        if self.tokenizer is not None:
            return self.tokenizer(texts, max_length=self.spec.text.max_length)
        return tokenize_batch(texts, self.spec.text.vocab_size,
                              self.spec.text.max_length)


def empty_pipeline(spec: ModelSpec, device="cuda", tokenizer=None) -> Pipeline:
    """The spec's modules on ``device`` with uninitialised parameters in each
    module's compute dtype, for a caller that sets every parameter
    (``utils.init.fast_init``, or a checkpoint through ``utils.bridge``)."""
    device = torch.device(device)
    if device.type == "cuda":
        enable_determinism()
    with torch.device("meta"):
        denoiser = VideoDiT(spec.dit) if spec.kind == "dit" else UNet3D(spec.unet)
        modules = [(denoiser, spec.denoiser_config),
                   (CLIPTextEncoder(spec.text), spec.text),
                   (VAEDecoder(spec.vae), spec.vae)]
    # dtype first, on the meta device: the storage is allocated once, in the
    # compute dtype (cogvideox-5b's 11 B parameters would take 44 GB in
    # float32 before their cast)
    unet, text, vae = (m.to(cfg.compute_dtype).to_empty(device=device) for m, cfg in modules)
    pipe = Pipeline(spec, unet, text, vae, tokenizer).eval()
    if device.type == "cuda":
        pipe.to(memory_format=torch.channels_last)  # conv weights, for cuDNN
    return pipe


def build_pipeline(model: Union[str, ModelSpec] = "zeroscope-v2-576w",
                   seed: int = 0, device="cuda") -> Pipeline:
    """Seeded pipeline for a registered family (or a spec), built on
    ``device`` with parameters in each module's compute dtype. The weights
    are the reference's for the same name and seed, bit for bit:
    ``utils.init.fast_init`` of the denoiser, the text encoder and the VAE
    decoder at seeds seed, seed + 1, seed + 2, each leaf drawn in float32
    and cast once to the denoiser's compute dtype.

    With ``DVDX_PARAM_CACHE=<dir>`` set (the reference's variable), the
    drawn leaves are kept in ``param_cache_path``'s flat npz: a hit loads
    them with no draws, a miss draws and writes the file, and a file that
    does not read or does not match the modules is drawn again, with a note
    on stderr. A fault of the copy to the device raises."""
    spec = model if isinstance(model, ModelSpec) else get_model_spec(model)
    pipe = empty_pipeline(spec, device)
    dtype = spec.denoiser_config.compute_dtype
    path = param_cache_path(spec, seed)
    if path is not None and os.path.exists(path):
        # only a file that does not read, or whose tree does not match the
        # modules, is drawn again: a fault of the copy to the device raises
        try:
            tree = load_flat_npz(path)
        except Exception as e:  # noqa: BLE001 - a corrupt or partial file
            tree, fault = None, e
        if tree is not None:
            try:
                return load_tree(pipe, tree)
            except (KeyError, ValueError, TypeError) as e:
                fault = e
        print(f"DVDX_PARAM_CACHE: {path} not used ({type(fault).__name__}: "
              f"{str(fault)[:200]}); drawing the weights again", file=sys.stderr, flush=True)
    for i, module in enumerate((pipe.unet, pipe.text_encoder, pipe.vae_decoder)):
        fast_init(module, seed + i, dtype=dtype)
    if path is not None:
        try:
            save_flat_npz(path, pipe)
        except OSError:  # a cache that cannot be written leaves the weights as drawn
            pass
    return pipe


def init_scheme_tag(spec: ModelSpec) -> str:
    """The cache key's part that changes with the derivation: a hash of
    ``utils/init.py``'s source (an edit of the draw rules invalidates every
    file; a stale hit would hand miner and validator different weights) and
    of the spec's repr."""
    import hashlib
    import inspect

    from ..utils import init as init_mod

    h = hashlib.sha256(inspect.getsource(init_mod).encode())
    h.update(repr(spec).encode())
    return h.hexdigest()[:12]


def param_cache_path(spec: ModelSpec, seed: int) -> Optional[str]:
    """``$DVDX_PARAM_CACHE/<model>-s<seed>-<dtype>-<tag>.npz``, the
    reference's name for the same weights' cache file, or None where the
    variable is unset."""
    cache_dir = os.environ.get("DVDX_PARAM_CACHE", "")
    if not cache_dir:
        return None
    dtype = str(spec.denoiser_config.compute_dtype).replace("torch.", "")
    return os.path.join(cache_dir, f"{spec.name}-s{seed}-{dtype}-{init_scheme_tag(spec)}.npz")


def resolve_pipeline(name_or_dir: str, seed: int = 0, device="cuda") -> Pipeline:
    """A registry name -> seeded random-init pipeline; a diffusers checkpoint
    directory (holding ``model_index.json`` or ``unet/config.json``) -> its
    pretrained pipeline (``utils.convert.load_diffusers_checkpoint``)."""
    if os.path.isdir(name_or_dir) and (
            os.path.exists(os.path.join(name_or_dir, "model_index.json"))
            or os.path.exists(os.path.join(name_or_dir, "unet", "config.json"))):
        from ..utils.convert import load_diffusers_checkpoint

        return load_diffusers_checkpoint(name_or_dir, device=device)
    return build_pipeline(name_or_dir, seed=seed, device=device)


def encode_prompts(pipe: Pipeline, prompts: List[str]) -> torch.Tensor:
    """Prompts -> encoder hidden states (B, S, hidden)."""
    ids = torch.from_numpy(pipe.tokenize(prompts)).long().to(pipe.device)
    with torch.inference_mode():
        return pipe.text_encoder(ids)[0]


def cfg_denoise_step(unet: Denoiser, sched: DDIMSchedule, z: torch.Tensor,
                     step_index: int, cond: torch.Tensor, uncond: torch.Tensor,
                     guidance_scale: float,
                     frame_positions: Optional[torch.Tensor] = None,
                     context_latent: Optional[torch.Tensor] = None,
                     context_weight: float = 0.0,
                     cfg_split: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """One classifier-free-guided DDIM step -> (z_prev, eps_guided).

    The batched form runs [uncond, cond] as one 2B UNet call; cfg_split runs
    them as two B calls (half the activation memory). The two are different
    step programs, so prover and verifier must agree on the flag. With
    context_weight > 0 the UNet's input is z + context_weight *
    context_latent (the CCI global context), in z's dtype; the DDIM update
    starts from z itself. The guidance combine runs in eps's dtype."""
    with span("denoise_step"):
        t = int(sched.timesteps[step_index])
        ts = torch.full((z.shape[0],), t, dtype=torch.int32, device=z.device)
        x = z
        if context_latent is not None and context_weight > 0.0:
            # a Python scalar made a device tensor: a blocking copy to the card
            with span("wait.scalar_upload"):
                w = torch.tensor(context_weight, dtype=z.dtype, device=z.device)
            x = z + w * context_latent.to(z.dtype)
        if cfg_split:
            with span("unet"):
                eps_u = unet(x, ts, uncond, frame_positions)
            with span("unet"):
                eps_c = unet(x, ts, cond, frame_positions)
        else:
            with span("unet"):
                eps_u, eps_c = unet(torch.cat([x, x]), torch.cat([ts, ts]),
                                    torch.cat([uncond, cond]), frame_positions).chunk(2)
        with span("wait.scalar_upload"):
            g = torch.tensor(guidance_scale, dtype=eps_u.dtype, device=eps_u.device)
        eps = eps_u + g * (eps_c - eps_u)
        with span("ddim_update"):
            return ddim_step(sched, step_index, z, eps), eps


def denoise(unet: Denoiser, sched: DDIMSchedule, z0: torch.Tensor,
            cond: torch.Tensor, uncond: torch.Tensor, guidance_scale: float,
            frame_positions: Optional[torch.Tensor] = None,
            context_latent: Optional[torch.Tensor] = None,
            context_weight: float = 0.0, record: bool = False,
            step_range: Optional[Tuple[int, int]] = None, cfg_split: bool = False):
    """Steps [a, b) of the schedule (all by default) from z0 (B, F, h, w,
    C). With record=True also returns zs and epss (steps, B, F, h, w, C): z
    before each update and the guided eps of that step (the
    Proof-of-Inference leaves)."""
    a, b = step_range if step_range is not None else (0, sched.num_steps)
    z, zs, epss = z0, [], []
    for i in range(a, b):
        z_prev, eps = cfg_denoise_step(unet, sched, z, i, cond, uncond, guidance_scale,
                                       frame_positions, context_latent, context_weight,
                                       cfg_split=cfg_split)
        if record:
            zs.append(z)
            epss.append(eps)
        z = z_prev
    if record:
        return z, torch.stack(zs), torch.stack(epss)
    return z


def generate_core(pipe: Pipeline, token_ids: torch.Tensor, noise_key: torch.Tensor,
                  *, sched: DDIMSchedule, num_frames: int, height: int, width: int,
                  guidance_scale: float, context_weight: float = 0.0,
                  record: bool = False, latent_dtype: torch.dtype = torch.bfloat16,
                  cfg_split: bool = False, segment_steps: int = 0,
                  decode_tile: int = 0):
    """token ids (2, S) [negative, prompt] + noise key -> frames
    (F, H, W, 3) float32 in [-1, 1] [, zs, epss].

    The schedule runs in segments of ``segment_steps`` steps (0: one
    segment), each ``denoise`` over its step range: the same steps in the
    same order, so the frames and leaves are the same bits for any segment
    length. (The reference compiles one segment program to bound the length
    of a single device execution; eager PyTorch launches step by step
    either way.) ``decode_tile`` > 0 decodes each frame in overlapping
    spatial tiles of that many latent pixels
    (``models.vae.decode_frame_spatially_tiled``); 0 decodes full frames."""
    spec = pipe.spec
    if spec.conditioning != "text":
        raise ValueError(f"{spec.name} is image-conditioned: generate its videos with "
                         "pipelines.img2video.generate_from_image")
    ds = spec.vae.downscale
    with span("text_encode"):
        hidden, _ = pipe.text_encoder(token_ids)
    uncond, cond = hidden[0:1], hidden[1:2]
    with span("base_noise"):
        z0 = rng_ops.video_noise(noise_key, num_frames,
                                 (height // ds, width // ds, spec.latent_channels),
                                 device=token_ids.device)
    # CCI: the global context is the time-mean of the base noise, (1, 1, h, w, C)
    ctx = z0.mean(dim=0, keepdim=True)[None] if context_weight > 0.0 else None
    z, zs, epss = z0[None].to(latent_dtype), [], []
    n = sched.num_steps
    length = segment_steps if segment_steps > 0 else n
    for start in range(0, n, length):
        with span("denoise_segment"):
            out = denoise(pipe.unet, sched, z, cond, uncond, guidance_scale,
                          context_latent=ctx, context_weight=context_weight, record=record,
                          step_range=(start, min(start + length, n)), cfg_split=cfg_split)
        z = out[0] if record else out
        if record:
            zs.append(out[1])
            epss.append(out[2])
    with span("vae_decode"):
        frames = decode_frames_tiled(pipe.vae_decoder, z[0].float(), tile=decode_tile)
    return (frames, torch.cat(zs), torch.cat(epss)) if record else frames


def build_segmented_runner(pipe: Pipeline, *, num_frames: int, height: int, width: int,
                           num_steps: int, guidance_scale: float = 7.5,
                           segment_steps: int = 10, cfg_split: bool = False,
                           latent_dtype: torch.dtype = torch.bfloat16,
                           decode_tile: int = 0):
    """-> run(token ids (2, S), noise key) -> frames (F, H, W, 3) float32:
    ``generate_core`` with these arguments bound, the reference's API."""
    sched = make_ddim_schedule(num_steps, prediction_type=pipe.spec.prediction_type)

    @torch.inference_mode()
    def run(token_ids: torch.Tensor, noise_key: torch.Tensor) -> torch.Tensor:
        return generate_core(pipe, token_ids.to(pipe.device), noise_key, sched=sched,
                             num_frames=num_frames, height=height, width=width,
                             guidance_scale=guidance_scale, latent_dtype=latent_dtype,
                             cfg_split=cfg_split, segment_steps=segment_steps,
                             decode_tile=decode_tile)

    return run


def to_uint8(frames: torch.Tensor) -> torch.Tensor:
    """Frames in [-1, 1] -> uint8, as the reference converts them."""
    return ((frames + 1.0) * 127.5).clamp(0, 255).to(torch.uint8)


def generate(pipe: Pipeline, prompt: str, *, negative_prompt: str = "",
             seed: int = 0, num_frames: Optional[int] = None,
             height: Optional[int] = None, width: Optional[int] = None,
             num_steps: Optional[int] = None,
             guidance_scale: Optional[float] = None, context_weight: float = 0.0,
             record: bool = False, cfg_split: bool = False):
    """User-facing generation: uint8 frames (F, H, W, 3) as numpy, plus
    (zs, epss, timesteps) when record=True: zs and epss are bfloat16 CPU
    tensors (steps, 1, F, h, w, C), timesteps int32 numpy."""
    spec = pipe.spec
    num_frames = num_frames or spec.default_frames
    height = height or spec.default_height
    width = width or spec.default_width
    num_steps = num_steps or spec.default_steps
    if guidance_scale is None:
        guidance_scale = spec.default_guidance_scale
    sched = make_ddim_schedule(num_steps, prediction_type=spec.prediction_type)
    ids = torch.from_numpy(pipe.tokenize([negative_prompt, prompt])).long()
    with torch.inference_mode():
        out = generate_core(pipe, ids.to(pipe.device), rng_ops.base_key(seed),
                            sched=sched, num_frames=num_frames, height=height,
                            width=width, guidance_scale=guidance_scale,
                            context_weight=context_weight, record=record,
                            cfg_split=cfg_split)
        frames = out[0] if record else out
        video = to_uint8(frames).cpu().numpy()
        if record:
            return video, (out[1].cpu(), out[2].cpu(), sched.timesteps.copy())
    return video
