"""The model families the benchmark runs, one module each, found by the
``family`` key of a configuration's file: ``families/<family>.py``.

A family module holds everything that depends on the model's layout, so
that the harness, the weights' draw, the output check and the metric
readers stay the same for every family. It defines:

* ``COMPONENTS``: the names of its weights' components, in draw order;
* ``reference_modules(cfg)``: ``{component: plain reference module}``,
  uninitialised (built on the meta device for shapes alone);
* ``spread(component, key, shape)``: ``(scale, shift)`` of one tensor's
  slice of the seeded standard normal draw;
* ``empty_pipeline(cfg, device)`` and ``load(pipe, cfg, component, sd)``:
  the port's pipeline, and one component's float32 host state dict handed
  to it through the port's own converter;
* ``text_states(ref, request, cfg, device)``: the token ids and text states
  of ``[negative prompt, prompt]``;
* ``base_latent(request, cfg)``: the seed's base noise in the program's
  latent layout;
* ``denoise(ref, z, t, hidden, device)``: one denoiser output at one
  conditioning row, in the program's latent layout;
* ``update(num_steps, t, z, eps)``: the scheduler's step from z_t to
  z_{t+1};
* ``decode(ref, z_in, cfg, device)``: a decoded frame from the decoder's
  input as the program hands it;
* ``bound_calls(pipe, cfg, device)``: ``{probe counter: (module, call)}``,
  one unit of each counted kind of work at the cell's shapes, for the
  kernels' bounds;
* ``model_flops(cfg)``: ``{probe counter: model FLOPs of one counted
  unit}``.
"""

from __future__ import annotations

import importlib


def family(cfg: dict):
    return importlib.import_module(f"{__name__}.{cfg['family']}")
