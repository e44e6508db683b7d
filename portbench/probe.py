"""The benchmark's hooks on the program under test.

Forward hooks on the pipeline's text encoder, denoiser and VAE decoder, and
a wrapper around the DDIM update that ``pipelines.text2video``'s
``cfg_denoise_step`` calls, count the work done (text encodes, UNet calls,
denoise steps, decoded frames) and, inside a unit chosen for the output
check, keep copies of what the program computed: token ids and text
states, every UNet output, each sampled step's (z_t, guided eps_t,
z_{t+1}), and sampled decoded frames with the latent they came from. After
``deadline`` the wrapper ends the window at the next step boundary by
raising ``WindowClosed`` (a ``BaseException``, so the program's own
``except Exception`` error replies do not swallow it). With ``spans`` the
hooks also record host spans, and the decoder's calls device time between
CUDA events.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Set

import torch


class WindowClosed(BaseException):
    """The measured window ended inside a unit of work."""


class Probe:
    def __init__(self, pipe, spans: bool = False):
        from dvdx_tpu_torch.pipelines import text2video

        self.counts = {"text": 0, "text_rows": 0, "unet": 0, "unet_rows": 0, "steps": 0,
                       "frames": 0}
        self.deadline: Optional[float] = None
        self.closed_at: Optional[float] = None
        self.spans: Optional[List] = [] if spans else None
        self.decode_events: List = []
        self._cap: Optional[dict] = None
        self._want_steps: Optional[Set[int]] = None
        self._want_frames: Optional[Set[int]] = None
        self._frame_in_unit = 0
        self._pending_unet: List[torch.Tensor] = []
        self._t = {}
        self._module = text2video
        self._ddim = text2video.ddim_step
        text2video.ddim_step = self._ddim_step
        self._handles = [
            pipe.text_encoder.register_forward_pre_hook(self._pre("text")),
            pipe.text_encoder.register_forward_hook(self._on_text),
            pipe.unet.register_forward_pre_hook(self._pre("unet")),
            pipe.unet.register_forward_hook(self._on_unet),
            pipe.vae_decoder.register_forward_pre_hook(self._on_vae_pre),
            pipe.vae_decoder.register_forward_hook(self._on_vae),
        ]

    def close(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []
        if self._module.ddim_step == self._ddim_step:
            self._module.ddim_step = self._ddim

    # -- units chosen for the output check --

    def begin_unit(self, capture: bool, steps=None, frames=None) -> None:
        """Start a unit of work; with ``capture``, keep the copies of the
        steps and decoded frames named (all where None)."""
        self._cap = {"text": None, "noise": None, "steps": {}, "frames": []} if capture else None
        self._want_steps = None if steps is None else set(steps)
        self._want_frames = None if frames is None else set(frames)
        self._frame_in_unit = 0
        self._pending_unet = []

    def end_unit(self) -> Optional[dict]:
        cap, self._cap = self._cap, None
        self._pending_unet = []
        return cap

    # -- hooks --

    def _span(self, name: str, t0: float) -> None:
        if self.spans is not None:
            self.spans.append((name, t0, time.perf_counter()))

    def _pre(self, name: str):
        def hook(mod, args):
            self._t[name] = time.perf_counter()
        return hook

    def _on_text(self, mod, args, out):
        self.counts["text"] += 1
        self.counts["text_rows"] += args[0].shape[0]
        self._span("text_encode", self._t["text"])
        if self._cap is not None:
            self._cap["text"] = (args[0].detach().clone(), out[0].detach().clone())

    def _on_unet(self, mod, args, out):
        self.counts["unet"] += 1
        self.counts["unet_rows"] += args[0].shape[0]
        self._span("unet_dispatch", self._t["unet"])
        if self._cap is not None:
            self._pending_unet.append(out.detach().clone())

    def _on_vae_pre(self, mod, args):
        self._t["vae"] = time.perf_counter()
        if self.spans is not None:
            start = torch.cuda.Event(enable_timing=True) if args[0].is_cuda else None
            if start is not None:
                start.record()
            self._t["vae_event"] = start

    def _on_vae(self, mod, args, out):
        self.counts["frames"] += 1
        self._span("vae_decode", self._t["vae"])
        if self.spans is not None and self._t.get("vae_event") is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.decode_events.append((self._t["vae_event"], end))
        if self._cap is not None and (self._want_frames is None
                                      or self._frame_in_unit in self._want_frames):
            self._cap["frames"].append((self._frame_in_unit, args[0].detach().clone(),
                                        out.detach().clone()))
        self._frame_in_unit += 1

    def _ddim_step(self, sched, step_index, latents, eps):
        z_next = self._ddim(sched, step_index, latents, eps)
        self.counts["steps"] += 1
        cap = self._cap
        if cap is not None:
            i = int(step_index)
            if i == 0 and cap["noise"] is None:
                cap["noise"] = latents.detach().clone()
            if self._want_steps is None or i in self._want_steps:
                cap["steps"][i] = {"t": int(sched.timesteps[i]), "num_steps": sched.num_steps,
                                   "z": latents.detach().clone(), "eps": eps.detach().clone(),
                                   "z_next": z_next.detach().clone(),
                                   "unet": self._pending_unet}
            self._pending_unet = []
        if self.deadline is not None and time.perf_counter() > self.deadline:
            if latents.is_cuda:
                torch.cuda.synchronize()
            self.closed_at = time.perf_counter()
            self.deadline = None
            raise WindowClosed()
        return z_next


def span_wrap(obj, attr: str, name: str, spans: List):
    """Replace ``obj.attr`` (a function or method) by one that records a
    host span ``name`` around each call; returns the undo."""
    fn = getattr(obj, attr)
    had = attr in vars(obj)

    def wrapped(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            spans.append((name, t0, time.perf_counter()))

    setattr(obj, attr, wrapped)
    return (lambda: setattr(obj, attr, fn)) if had else (lambda: delattr(obj, attr))


def to_host(x):
    """A capture with every tensor moved to the host in float32 (token ids
    as int64); read once the window has closed."""
    if isinstance(x, torch.Tensor):
        return x.cpu().long() if not x.is_floating_point() else x.float().cpu()
    if isinstance(x, dict):
        return {k: to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_host(v) for v in x)
    return x


def count_snapshot(probe: Probe) -> Dict[str, int]:
    """The probe's counts and the port's kernel launch counters now."""
    from dvdx_tpu_torch.ops.kernels import launch_counts

    return {**probe.counts, **{f"launch.{k}": v for k, v in launch_counts().items()}}
