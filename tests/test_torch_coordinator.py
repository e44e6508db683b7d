"""The strategy benchmark (``parallel/runner.py``) and the multi-process
chunk coordinator (``parallel/coordinator.py``, ``parallel/worker.py``) of
the port, on the CPU.

* The runner's CSV columns, communication model and WAN delays equal the
  JAX runner's; its measured stitch all-gather at 2 gloo ranks receives the
  JAX formula's bytes; ``python -m dvdx_tpu_torch strategy`` writes one row
  with every column filled, at 1 rank and at 2.
* The coordinator's worker processes re-derive their frames' noise (rows of
  ``video_noise``, exactly); over sockets its measured bytes equal the
  payload model (the JAX twin's, ``tests/test_coordinator_net.py``); the
  file and socket transports give the same video, bit for bit; a failed
  worker is re-run and the video is the one a run without the failure
  gives, bit for bit.
* On the JAX package's zeroscope-tiny weights (``--weights``, a flat npz)
  the coordinator's stitched latent is within 2 bf16 ulps of max|latent|
  of the JAX package's coordinator's on the same seed and plan (its worker
  processes' chunk files, stitched by its ``stitch_chunks``; measured 1
  ulp, 0.03125 at max|latent| 7.47), and its video within 2 levels
  (measured 1). A worker's frame range off by one fails it; the blend
  weights themselves are held against JAX's by
  ``tests/test_torch_parallel.py::test_split_and_stitch_match_jax``.
* Its latent and video are, bit for bit, the port's in-process chunk
  program (``video_noise`` -> ``gather_chunks`` -> ``denoise`` per chunk at
  the workers' batch of 2 -> ``blend_chunks`` -> decode) at the workers'
  thread count (the CPU's float32 products round by thread count).
"""

import csv
import os
import random
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from dvdx_tpu.parallel import coordinator as jcoordinator
from dvdx_tpu.parallel import latent_chunking as jlat
from dvdx_tpu.parallel import runner as jrunner
from dvdx_tpu.pipelines.text2video import _save_flat_npz
from dvdx_tpu_torch.ops import rng
from dvdx_tpu_torch.ops.scheduler import make_ddim_schedule
from dvdx_tpu_torch.parallel import runner
from dvdx_tpu_torch.parallel.chunking import blend_chunks, gather_chunks, plan_chunks
from dvdx_tpu_torch.parallel.coordinator import run_coordinated
from dvdx_tpu_torch.parallel.mesh import Mesh, run_ranks, single_device_mesh
from dvdx_tpu_torch.parallel.strategies import decode_latents, get_strategy
from dvdx_tpu_torch.parallel.worker import chunk_pipeline
from dvdx_tpu_torch.pipelines.text2video import denoise, to_uint8
from tests import torch_dist_workers as workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_csv_columns_equal_jax():
    assert runner.CSV_COLUMNS == jrunner.CSV_COLUMNS
    assert set(runner.EMU_PRESETS) == set(jrunner.EMU_PRESETS)
    for name, preset in runner.EMU_PRESETS.items():
        assert preset == jrunner.EMU_PRESETS[name]


@pytest.mark.parametrize("name", ["single", "fsdp", "chunk", "hybrid", "hybrid_ctx",
                                  "cp_exact", "cp_ulysses", "precond"])
def test_comm_model_equals_jax(name):
    """The same strategy, mesh shape and plan through both models (the JAX
    model reads only mesh.shape, the plan and the strategy's fields)."""
    st = get_strategy(name)
    for shape in ((1, 1, 1), (1, 2, 1), (1, 1, 4), (2, 2, 2)):
        mesh = Mesh(shape, "cpu")
        plan = plan_chunks(16, 4, 2) if st.chunked else None
        args = (st, mesh, plan, 123_456_789, 25, 9 * 40 * 72 * 4 * 2)
        assert runner.estimate_comm_bytes(*args) == jrunner.estimate_comm_bytes(*args)


def test_wan_delay_equals_jax():
    for nbytes in (0, 1, 10 ** 6, 3 * 10 ** 8):
        assert runner.wan_delay_s(nbytes, 500.0, 3.01, 3.53, random.Random(4)) == \
            jrunner.wan_delay_s(nbytes, 500.0, 3.01, 3.53, random.Random(4))


def test_measure_gather_s_two_ranks(tmp_path):
    shape = (8, 4, 32, 32, 4)
    outs = run_ranks(workers.gather_time, 2, args=(shape,), device="cpu", timeout_s=60,
                     workdir=str(tmp_path))
    nbytes = int(np.prod(shape)) * 2
    for dt, recv in outs:
        assert dt > 0.0 and recv == nbytes * 1 // 2  # the JAX formula, (seq-1)/seq
    assert runner.measure_gather_s(Mesh((1, 1, 1), "cpu"), shape, torch.bfloat16) == (0.0, 0)


def _cli(args, cwd, timeout=240):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-m", "dvdx_tpu_torch", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=timeout, env=env)


@pytest.mark.parametrize("world,mode", [(1, "hybrid_ctx"), (2, "cp_ulysses")])
def test_strategy_cli_writes_a_full_row(tmp_path, world, mode):
    out = tmp_path / "row.csv"
    r = _cli(["strategy", "--cpu", "--mode", mode, "--world-size", str(world),
              "--frames", "8", "--steps", "2", "--perturb", "--emu", "wifi", "--csv",
              str(out), "--timeout", "120"], tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    rows = list(csv.DictReader(out.open()))
    assert len(rows) == 1 and list(rows[0]) == runner.CSV_COLUMNS
    row = rows[0]
    assert all(row[c] != "" for c in runner.CSV_COLUMNS), row
    assert row["mode"] == mode and int(row["world_size"]) == world
    assert float(row["latency_s"]) > 0 and float(row["peak_mem_mb"]) > 0
    assert float(row["net_gather_s"]) > 0  # the wifi RTT at least
    if mode == "hybrid_ctx":
        assert int(row["num_chunks"]) == 1 and float(row["context_weight"]) == 0.35
    else:
        assert float(row["ici_gather_s"]) > 0 and int(row["network_bytes"]) > 0


def test_strategy_cli_needs_a_card_unless_told(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run on it")
    r = _cli(["strategy", "--mode", "chunk"], tmp_path, timeout=60)
    assert r.returncode == 2 and "no CUDA device" in r.stderr
    r = _cli(["coordinator"], tmp_path, timeout=60)
    assert r.returncode == 2 and "no CUDA device" in r.stderr


def test_worker_frames_are_video_noise_rows():
    key = rng.base_key(3)
    full = rng.video_noise(key, 8, (4, 4, 4), device="cpu")
    part = rng.frame_range_noise(key, 3, 5, (4, 4, 4), device="cpu")
    assert torch.equal(full[3:8], part)


PROMPT = "a slow river"
COORD = dict(model="zeroscope-tiny", num_chunks=2, overlap=2, num_frames=8, width=32,
             height=32, steps=2, seed=3)
BF16_ULP = 2.0 ** -7  # bf16's spacing relative to the leading power of two


@pytest.fixture(scope="module")
def jax_weights(tiny_pipeline, tmp_path_factory):
    """The JAX coordinator's weights (zeroscope-tiny, seed 0, zero leaves
    perturbed with seed 99) as a flat npz for the port's workers."""
    path = str(tmp_path_factory.mktemp("w") / "tiny.npz")
    _save_flat_npz(path, jax.tree.map(np.asarray, tiny_pipeline.params))
    return path


@pytest.fixture(scope="module")
def socket_run(jax_weights):
    return run_coordinated(PROMPT, transport="socket", device="cpu", weights=jax_weights,
                           **COORD)


def _in_process(weights, num_frames, steps, num_chunks=2, overlap=2, seed=3):
    """The chunk program in this process, one chunk per UNet batch (the
    workers' CFG pair), at the workers' thread count: (latent, video)."""
    pipe = chunk_pipeline("zeroscope-tiny", "cpu", weights)
    plan = plan_chunks(num_frames, num_chunks, overlap)
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // plan.num_chunks))
    try:
        with torch.inference_mode():
            hidden, _ = pipe.text_encoder(torch.from_numpy(pipe.tokenize(["", PROMPT])).long())
            z0 = rng.video_noise(rng.base_key(seed), num_frames, (16, 16, 4), device="cpu")
            rows = gather_chunks(z0[None].to(torch.bfloat16), plan)[0]
            sched = make_ddim_schedule(steps)
            zs = [denoise(pipe.unet, sched, rows[i:i + 1], hidden[1:2], hidden[0:1], 7.5)
                  for i in range(plan.num_chunks)]
            z = blend_chunks(torch.cat(zs)[None].float(), plan)[0]
            video = to_uint8(decode_latents(pipe, z, single_device_mesh("cpu")))
    finally:
        torch.set_num_threads(threads)
    return z.numpy(), video.numpy()


def test_socket_coordinator_produces_video(socket_run):
    res = socket_run
    assert res["video"].shape == (8, 32, 32, 3) and res["video"].dtype == np.uint8
    assert res["transport"] == "socket" and res["device"] == "cpu"
    assert res["latent"].shape == (8, 16, 16, 4)


def test_measured_bytes_match_payload_model(socket_run):
    plan = plan_chunks(8, 2, 2)
    expected_payload = 2 * plan.chunk_len * 16 * 16 * 4 * 4  # float32 chunks
    measured = socket_run["measured_network_bytes"]
    assert expected_payload <= measured <= expected_payload + 2 * 4096, measured
    assert len(socket_run["per_chunk_recv_s"]) == 2
    assert socket_run["net_gather_s"] >= 0.0


def test_coordinator_matches_jax_coordinator(socket_run, tmp_path):
    """The JAX package's coordinator (its worker processes, on the CPU) on
    the same weights, seed and plan; its latent stitched from the workers'
    chunk files."""
    ref = jcoordinator.run_coordinated(PROMPT, cpu=True, perturb=True, transport="file",
                                       workdir=str(tmp_path), **COORD)
    jplan = jlat.plan_chunks(8, 2, 2)
    latent = jlat.stitch_chunks([np.load(tmp_path / f"chunk_{i}.npz")["latent"]
                                 for i in range(jplan.num_chunks)], jplan)
    err = float(np.abs(socket_run["latent"] - latent).max())
    tol = 2 * BF16_ULP * 2.0 ** np.floor(np.log2(np.abs(latent).max()))
    levels = int(np.abs(socket_run["video"].astype(int) - ref["video"].astype(int)).max())
    print(f"coordinator against JAX's: latent {err:.4g} (tol {tol:.4g}), "
          f"video {levels} levels")  # pytest -rP
    assert socket_run["latent"].shape == latent.shape and err <= tol
    assert ref["video"].shape == socket_run["video"].shape and levels <= 2


def test_coordinator_is_the_chunk_program_per_chunk(socket_run, jax_weights):
    latent, video = _in_process(jax_weights, 8, 2)
    np.testing.assert_array_equal(socket_run["latent"], latent)
    np.testing.assert_array_equal(socket_run["video"], video)


def test_file_and_socket_transports_agree(socket_run, jax_weights):
    a = run_coordinated(PROMPT, transport="file", device="cpu", weights=jax_weights, **COORD)
    np.testing.assert_array_equal(a["video"], socket_run["video"])
    np.testing.assert_array_equal(a["latent"], socket_run["latent"])


def test_failed_worker_is_rerun(tmp_path):
    """A worker that dies is launched once more; the video is the one a run
    without the failure gives."""
    launched = []

    def launcher(cmd):
        launched.append(cmd)
        if len(launched) == 1:  # the first chunk's first worker fails
            cmd = [sys.executable, "-c", "raise SystemExit(3)"]
        return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                cwd=REPO)

    geo = dict(COORD, num_frames=6, steps=1)
    res = run_coordinated(PROMPT, transport="file", launcher=launcher, device="cpu",
                          perturb=True, workdir=str(tmp_path / "a"), **geo)
    clean = run_coordinated(PROMPT, transport="file", device="cpu", perturb=True,
                            workdir=str(tmp_path / "b"), **geo)
    assert len(launched) == 3 and res["video"].shape == (6, 32, 32, 3)
    np.testing.assert_array_equal(res["video"], clean["video"])
    np.testing.assert_array_equal(res["latent"], clean["latent"])
