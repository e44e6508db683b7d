"""Where the time goes inside the fused kernels' chains and GroupNorm on the
card, and what GroupNorm's chunk size is worth.

    python -m dvdx_tpu_torch.utils.kernel_probe

1. Device time per call from ``torch.profiler`` (kernel time only,
   whatever the host does): the chain and the FF launches of the fused
   temporal block at zeroscope-v2-576w's level 0 (2, 16, 2880, 320), 5
   heads, and of the fused spatial tail at level 0 (32 x 2880 rows, C = 320,
   5 heads, 77 context tokens); GroupNorm at the UNet's and the VAE's
   shapes at five chunk sizes (the plan takes ``ops.groupnorm.CHUNK_ELEMS``,
   or ``LARGE_CHUNK_ELEMS`` for large calls). Each run is also held to its
   plain version (2 bf16 ulps of max |plain|).
2. Phase timings from instrumented copies of the three sources, built beside
   the kernels' own builds: each chain's cycles per 64-row tile in each
   phase, read by one consumer thread of every CTA and summed; GroupNorm's
   timeline of block 0 (phase 1, barrier, phase 2, barrier, phase 3) in
   microseconds. The copies add clock reads at the phase boundaries and
   nothing else.

Needs a CUDA card; writes ``chiprun_out/kernel_probe.json``.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

OUT = os.path.join("chiprun_out", "kernel_probe.json")
CHUNKS = (4096, 8192, 16384, 32768, 65536)
GN_SHAPES = {"resnet_l0": (32, 2880, 320), "temporal_l0": (2, 46080, 320),
             "resnet_l1": (32, 720, 640), "resnet_l3_concat": (32, 45, 2560),
             "vae_up_80x144": (1, 11520, 512), "vae_up_320x576_c256": (1, 184320, 256)}
CHAIN_PHASES = ("LN1 / LN2", "k, v, q products", "attention", "LN3 and stores", "x loads",
                "o product and residual")  # in the order of their probe indices

# clock reads at the chain's phase boundaries (one consumer thread per CTA)
_CHAIN_MARKS = (
    ("using namespace dvdx;\n",
     "using namespace dvdx;\n__device__ unsigned long long g_probe[8];\n"
     "#define PROBE(i) do { if (threadIdx.x == 0) { long long now_ = clock64(); "
     "atomicAdd(&g_probe[i], (unsigned long long)(now_ - last_)); last_ = now_; } } while (0)\n"),
    ("  // x in by 16-byte loads through hs", "  long long last_ = clock64();\n"
     "  // x in by 16-byte loads through hs"),
    ("  float acc[C / 4];\n", "  PROBE(4);\n  float acc[C / 4];\n"),
    ("    consumers_sync();  // the LN output is whole before either warpgroup reads it\n",
     "    consumers_sync();  // the LN output is whole before either warpgroup reads it\n"
     "    PROBE(0);\n"),
    ("    store_acc<C>(t, t.ks, acc);\n", "    store_acc<C>(t, t.ks, acc);\n    PROBE(1);\n"),
    ("    store_acc<C>(t, t.vs, acc);\n", "    store_acc<C>(t, t.vs, acc);\n    PROBE(1);\n"),
    ("    consumers_sync();  // q, k, v are whole\n",
     "    consumers_sync();  // q, k, v are whole\n    PROBE(1);\n"),
    ("    consumers_sync();  // the attention output is whole\n",
     "    consumers_sync();  // the attention output is whole\n    PROBE(2);\n"),
    ("  chain_layernorm<C>(t, xr, vec.ln_s[2]",
     "  chain_layernorm<C>(t, xr, vec.ln_s[2]"),
)


def _instrument_chain(src: str) -> str:
    for old, new in _CHAIN_MARKS:
        if old not in src:
            raise RuntimeError(f"kernel_probe: the chain source changed at {old!r}")
        src = src.replace(old, new, 1)
    i = src.index("  chain_layernorm<C>(t, xr, vec.ln_s[2]")
    j = src.rindex("  }\n", 0, i)  # the end of the two sub-blocks' loop
    src = src[:j] + "    PROBE(5);\n  }\n" + src[j + 4:]
    k = src.rindex("}\n", 0, src.index("template <int C>\nint chain_launch"))
    src = src[:k] + "  PROBE(3);\n}\n" + src[k + 2:]
    return src + _PROBE_READ


TAIL_PHASES = ("x and o1 in", "o1 product and residual", "LN2", "q product", "attention",
               "o2 product and residual", "LN3 and stores",
               "attention's waits for K / V")  # in probe index order; the last is part of attention

# clock reads at the spatial tail chain's phase boundaries (one consumer
# thread per CTA)
_TAIL_MARKS = (
    ("using namespace dvdx;\n",
     "using namespace dvdx;\n__device__ unsigned long long g_probe[8];\n"
     "#define PROBE(i) do { if (threadIdx.x == 0) { long long now_ = clock64(); "
     "atomicAdd(&g_probe[i], (unsigned long long)(now_ - last_)); last_ = now_; } } while (0)\n"),
    ("  uint32_t xr[NJ][2];  // x as bf16 pairs", "  long long last_ = clock64();\n"
     "  uint32_t xr[NJ][2];  // x as bf16 pairs"),
    ("  mbar_wait(o1_bar, 0);\n", "  mbar_wait(o1_bar, 0);\n  PROBE(0);\n"),
    ("  residual<C>(t, xr, acc, vec.o1_b, resid);\n",
     "  residual<C>(t, xr, acc, vec.o1_b, resid);\n  PROBE(1);\n"),
    ("  consumers_sync();  // the LN output is whole before either warpgroup reads it\n",
     "  consumers_sync();  // the LN output is whole before either warpgroup reads it\n"
     "  PROBE(2);\n"),
    ("  consumers_sync();  // q is whole\n", "  consumers_sync();  // q is whole\n  PROBE(3);\n"),
    ("  consumers_sync();  // the attention output is whole\n",
     "  consumers_sync();  // the attention output is whole\n  PROBE(4);\n"),
    ("  residual<C>(t, xr, acc, vec.o2_b, resid);\n",
     "  residual<C>(t, xr, acc, vec.o2_b, resid);\n  PROBE(5);\n"),
    ("      fill_slot(t, g, st, parity);\n      mbar_wait(&t.full[st], parity);\n      if (h < sh.heads",
     "      fill_slot(t, g, st, parity);\n      const long long w0_ = clock64();\n"
     "      mbar_wait(&t.full[st], parity);\n"
     "      if (threadIdx.x == 0) atomicAdd(&g_probe[7], (unsigned long long)(clock64() - w0_));\n"
     "      if (h < sh.heads"),
)


def _instrument_tail(src: str) -> str:
    for old, new in _TAIL_MARKS:
        if old not in src:
            raise RuntimeError(f"kernel_probe: the spatial tail source changed at {old!r}")
        src = src.replace(old, new, 1)
    k = src.rindex("}\n", 0, src.index("// The context's K or V"))
    src = src[:k] + "  PROBE(6);\n}\n" + src[k + 2:]
    return src + _PROBE_READ


_PROBE_READ = ('\nextern "C" int dvdx_probe_read(unsigned long long* out, int reset) {\n'
               '  cudaError_t e = cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));\n'
               '  unsigned long long z[8] = {0};\n'
               '  if (reset && e == cudaSuccess) e = cudaMemcpyToSymbol(g_probe, z, sizeof(z));\n'
               '  return (int)e;\n}\n')


def _instrument_gn(src: str) -> str:
    head = ("using namespace dvdx;\n__device__ unsigned long long g_probe[8];\n"
            "__device__ __forceinline__ unsigned long long probe_now() { unsigned long long t; "
            "asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t)); return t; }\n"
            "#define PROBE do { if (blockIdx.x == 0 && threadIdx.x == 0) "
            "g_probe[k_++] = probe_now(); } while (0)\n")
    start = "  const int items = a.N * a.nchunks;\n"
    if start not in src or src.count("  grid_barrier();\n") != 2:
        raise RuntimeError("kernel_probe: the GroupNorm source changed")
    src = src.replace("using namespace dvdx;\n", head, 1)
    src = src.replace(start, start + "  int k_ = 0;\n  PROBE;\n", 1)
    src = src.replace("  grid_barrier();\n", "  PROBE;\n  grid_barrier();\n  PROBE;\n")
    k = src.rindex("}\n", 0, src.index("}  // namespace"))
    src = src[:k] + "  PROBE;\n}\n" + src[k + 2:]
    return src + ('\nextern "C" int dvdx_probe_read(unsigned long long* out, int reset) {\n'
                  '  return (int)cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));\n}\n')


def build_instrumented() -> dict:
    """{"temporal_block": CDLL, "spatial_tail": CDLL, "groupnorm": CDLL}: the
    instrumented copies, compiled with the kernels' own flags into
    build/torch_kernels/probe/."""
    from ..ops import _build

    out_dir = _build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, patch in (("temporal_block", _instrument_chain), ("spatial_tail", _instrument_tail),
                        ("groupnorm", _instrument_gn)):
        src = out_dir / f"{name}.cu"
        src.write_text(patch((_build.CSRC / f"{name}.cu").read_text()))
        lib = out_dir / f"{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib), str(src)]
        procs.append((name, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, path, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"kernel_probe: instrumented {name} failed to build:\n{out}")
        lib = ctypes.CDLL(str(path))
        lib.dvdx_error_string.argtypes = [ctypes.c_int]
        lib.dvdx_error_string.restype = ctypes.c_char_p
        lib.dvdx_probe_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
        libs[name] = lib
    return libs


def device_ms(fn, names, reps: int = 10) -> dict:
    """{name fragment: device ms per call} over ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        key = next((n for n in names if n in ev.name), None)
        if key is not None:
            total[key] = total.get(key, 0.0) + ev.time_range.elapsed_us() / 1e3 / reps
    return total


def _within(out, ref) -> bool:
    err = (out.float() - ref.float()).abs().max().item()
    return bool(err <= 2 * 2.0 ** -7 * ref.float().abs().max().item())


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA device", file=sys.stderr)
        return 2
    import dvdx_tpu_torch
    from ..ops import _build
    from ..ops import groupnorm as gn
    from ..ops.kernels import spatial_tail as st
    from ..ops.kernels import temporal_block as tb

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dvdx_tpu_torch.enable_determinism()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale + shift).bfloat16()

    result = {"device": smi, "chain": {}, "tail": {}, "group_norm": {}}
    c = 320
    params = {k: randn((c,), 0.1, 1.0 if k.endswith("_s") else 0.0) for k in tb.KEYS}
    params.update({k: randn((c, c), c ** -0.5)
                   for k in ("q1", "k1", "v1", "o1_w", "q2", "k2", "v2", "o2_w")})
    params.update({"ffi_w": randn((8 * c, c), c ** -0.5), "ffi_b": randn((8 * c,), 0.1),
                   "ffo_w": randn((c, 4 * c), (4 * c) ** -0.5)})
    x = randn((2, 16, 2880, c))
    ref = tb.fused_temporal_block_plain(x, params, heads=5)
    tiles = tb.plan(2, 16, 2880, c).tiles

    def block():
        return tb.fused_temporal_block(x, params, heads=5)

    def phases_of(name, run, names, tiles):
        """Cycles per tile in each phase over 5 calls of the instrumented
        copy of csrc/<name>.cu."""
        lib = libs[name]
        own = _build._libs[name]
        _build._libs[name] = lib
        try:
            buf = (ctypes.c_ulonglong * 8)()
            run()
            torch.cuda.synchronize()
            lib.dvdx_probe_read(buf, 1)
            for _ in range(5):
                run()
            torch.cuda.synchronize()
            lib.dvdx_probe_read(buf, 1)
        finally:
            _build._libs[name] = own
        return {names[i]: buf[i] / 5 / tiles for i in range(len(names))}

    libs = build_instrumented()
    ok = _within(block(), ref)
    ms = device_ms(block, ["temporal_block_chain", "geglu_stage"])
    phases = phases_of("temporal_block", block, CHAIN_PHASES, tiles)
    result["chain"] = {"ms": ms, "within_2_ulps": ok, "cycles_per_tile": phases}
    print(f"chain: device ms {json.dumps(ms)}, within 2 ulps {ok}; cycles per tile by phase "
          f"{json.dumps({k: round(v) for k, v in phases.items()})}", flush=True)
    del x, ref, params

    # the spatial tail at level 0: x, o1 (32, 2880, 320), the 77-token
    # context projected to 5 heads of 64
    n, s_, t = 32, 2880, 77
    tparams = {k: randn((c,), 0.1, 1.0 if k.endswith("_s") else 0.0) for k in st.KEYS}
    tparams.update({k: randn((c, c), c ** -0.5) for k in ("o1_w", "q2_w", "o2_w")})
    tparams.update({"ffi_w": randn((8 * c, c), c ** -0.5), "ffi_b": randn((8 * c,), 0.1),
                    "ffo_w": randn((c, 4 * c), (4 * c) ** -0.5)})
    targs = [randn((n, s_, c)), randn((n, s_, c)), randn((n, t, c)), randn((n, t, c))]
    tref = st.fused_spatial_tail_plain(*targs, tparams, heads=5)

    def tail():
        return st.fused_spatial_tail(*targs, tparams, heads=5)

    ok = _within(tail(), tref)
    ms = device_ms(tail, ["spatial_tail_chain", "geglu_stage"])
    phases = phases_of("spatial_tail", tail, TAIL_PHASES, st.plan(n * s_, s_, c, c, t, 5).tiles)
    result["tail"] = {"ms": ms, "within_2_ulps": ok, "cycles_per_tile": phases}
    print(f"tail: device ms {json.dumps(ms)}, within 2 ulps {ok}; cycles per tile by phase "
          f"{json.dumps({k: round(v) for k, v in phases.items()})}", flush=True)
    del targs, tref, tparams

    gn_plan = gn.plan
    for label, (n, length, ch) in GN_SHAPES.items():
        xs = randn((n, length, ch), 2.0, 0.5)
        gamma = torch.rand((ch,), generator=gen, device="cuda") + 0.5
        beta = torch.randn((ch,), generator=gen, device="cuda") * 0.1

        def norm():
            return gn.group_norm_act(xs, gamma, beta, groups=32, eps=1e-5, act="silu")
        ref = gn.group_norm_act_plain(xs, gamma, beta, groups=32, eps=1e-5, act="silu")
        row = {"bound_ms": 2.0 * n * length * ch * 2 / 3.35e12 * 1e3}
        try:
            for size in CHUNKS:
                gn.plan = lambda *a, size=size: gn_plan(*a, chunk_elems=size)
                row[size] = {"ms": device_ms(norm, ["gn_fused"]).get("gn_fused"),
                             "within_2_ulps": _within(norm(), ref)}
        finally:
            gn.plan = gn_plan
        own = _build._libs["groupnorm"]
        _build._libs["groupnorm"] = libs["groupnorm"]
        try:
            norm()
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * 8)()
            libs["groupnorm"].dvdx_probe_read(buf, 0)
        finally:
            _build._libs["groupnorm"] = own
        t = [buf[i] / 1e3 for i in range(6)]
        row["block0_us"] = {"phase1": t[1] - t[0], "barrier1": t[2] - t[1],
                            "phase2": t[3] - t[2], "barrier2": t[4] - t[3],
                            "phase3": t[5] - t[4]}
        result["group_norm"][label] = row
        print(f"group_norm {label} {(n, length, ch)}: bound {row['bound_ms']:.4f} ms; device ms "
              f"by chunk elements " + " ".join(
                  f"{s}={row[s]['ms']:.4f}{'' if row[s]['within_2_ulps'] else '(FAIL)'}"
                  for s in CHUNKS)
              + "; block 0 us " + json.dumps({k: round(v, 1) for k, v in row["block0_us"].items()}),
              flush=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
