"""The port's native Merkle hasher (``dvdx_tpu_torch/utils/native.py`` over
``dvdx_tpu_torch/csrc/merkle.cpp``) held against hashlib, the port's plain
hashlib loop and the JAX package's native hasher and commitment. Every
comparison is exact (byte equality).

The build tests point ``native.BUILD_DIR`` and ``native.CXX`` at a
temporary directory and compiler by module attribute, so they never touch
the library the other tests load.
"""

import hashlib
import inspect
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from dvdx_tpu.utils import native as jax_native
from dvdx_tpu.verify import merkle as jax_merkle
from dvdx_tpu_torch.utils import native
from dvdx_tpu_torch.verify import merkle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_native_loaded():
    assert jax_native.available(), "the JAX package's native library did not build or load"


def _leaves_inputs(n: int, kind: str, seed: int):
    """(timesteps, zs, epss) for the port, and the same bytes as numpy
    arrays for the JAX package (bf16 as its 16-bit patterns)."""
    rng = np.random.default_rng(seed)
    ts = np.array([981 - 40 * i for i in range(n)], np.int64)
    shape = (n, 1, 3, 5, 6, 4)
    if kind == "bf16":
        zs = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).bfloat16()
        epss = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).bfloat16()
        return ts, zs, epss, zs.view(torch.int16).numpy(), epss.view(torch.int16).numpy()
    zs = rng.normal(size=shape).astype(np.float16)
    epss = rng.normal(size=shape).astype(np.float16)
    return ts, zs, epss, zs, epss


@pytest.mark.parametrize("size", [0, 55, 56, 63, 64, 65, 1 << 20])
def test_sha256_against_hashlib_and_jax(size):
    """One-shot hashes around the padding boundaries (55 / 56 bytes: the
    length still fits / no longer fits the last block; 63-65 around a
    block) and of about 1 MB, from a numpy seed."""
    _jax_native_loaded()
    data = np.random.default_rng(size).bytes(size)
    want = hashlib.sha256(data).digest()
    assert native.sha256(data) == want
    assert native.sha256(bytearray(data)) == want
    assert jax_native.sha256(data) == want


@pytest.mark.parametrize("kind", ["bf16", "numpy"])
@pytest.mark.parametrize("n", [1, 2, 3, 25])
def test_sha256_leaves_against_leaf_hash_and_jax(n, kind):
    _jax_native_loaded()
    ts, zs, epss, z_np, e_np = _leaves_inputs(n, kind, seed=n)
    want = [merkle.leaf_hash(int(t), zs[i], epss[i]) for i, t in enumerate(ts)]
    assert native.sha256_leaves(ts, zs, epss) == want
    assert native.sha256_leaves(ts, zs, epss, n_threads=1) == want
    assert native.sha256_leaves(ts, zs, epss, n_threads=3) == want
    assert jax_native.sha256_leaves(ts.astype(np.uint16), z_np, e_np) == want


def test_sha256_leaves_of_strided_tensors():
    """A non-contiguous stack is hashed in its logical order, as
    ``leaf_bytes`` hashes it."""
    ts, zs, epss, _, _ = _leaves_inputs(4, "bf16", seed=5)
    zt, et = zs.transpose(2, 4), epss.transpose(2, 4)
    assert not zt.is_contiguous()
    want = [merkle.leaf_hash(int(t), zt[i], et[i]) for i, t in enumerate(ts)]
    assert native.sha256_leaves(ts, zt, et) == want


@pytest.mark.parametrize("n", range(1, 10))
def test_merkle_root_against_the_tree_and_jax(n):
    """Odd counts take the duplication path at some level."""
    _jax_native_loaded()
    leaves = [np.random.default_rng(100 + n).bytes(32) for _ in range(n)]
    want = merkle.build_merkle_tree(leaves)[-1][0]
    assert native.merkle_root(leaves) == want
    assert jax_merkle.merkle_root(leaves) == want
    assert jax_native.merkle_root(leaves) == want


@pytest.fixture(scope="module")
def recorded_tiny_hf():
    from dvdx_tpu_torch.pipelines.text2video import build_pipeline, generate
    from dvdx_tpu_torch.utils.testing import perturb_zero_params

    pipe = perturb_zero_params(build_pipeline("zeroscope-tiny-hf", device="cpu"), seed=99)
    _, (zs, epss, ts) = generate(pipe, "a red ball", seed=7, num_frames=4, height=32,
                                 width=32, num_steps=3, record=True)
    return ts, zs, epss


def test_commitment_native_and_hashlib_against_jax(recorded_tiny_hf):
    """A recorded zeroscope-tiny-hf run (bf16 leaves on the CPU): the
    native and the hashlib commitment have the same leaves, levels, proofs
    and openings, and the JAX commitment (native and Python) over the same
    bytes has the same root."""
    _jax_native_loaded()
    ts, zs, epss = recorded_tiny_hf
    assert zs.dtype == torch.bfloat16 and len(ts) == 3
    fast = merkle.MerkleCommitment(ts, zs, epss)
    plain = merkle.MerkleCommitment(ts, zs, epss, use_native=False)
    assert fast.leaves == plain.leaves and fast.levels == plain.levels
    z16, e16 = zs.view(torch.int16).numpy(), epss.view(torch.int16).numpy()
    for use_native in (True, False):
        ref = jax_merkle.MerkleCommitment(np.asarray(ts), z16, e16, use_native=use_native)
        assert ref.leaves == fast.leaves and ref.root == fast.root
    for i in range(len(ts)):
        assert fast.open(i) == plain.open(i)
        assert merkle.verify_merkle_proof(fast.leaves[i], fast.proof(i), fast.root)


def test_every_caller_commits_through_the_native_leaves():
    """``use_native`` is on by default, and no module of the port (the
    miner, the tampering mock miner, the services) turns it off."""
    assert inspect.signature(merkle.MerkleCommitment).parameters["use_native"].default is True
    offenders = []
    for path in pathlib.Path(REPO, "dvdx_tpu_torch").rglob("*.py"):
        if path.name != "merkle.py" and "use_native=False" in path.read_text():
            offenders.append(str(path))
    assert not offenders, offenders


_BUILD_IN = """
import pathlib, sys, time
import numpy as np
import torch
from dvdx_tpu_torch.utils import native
from dvdx_tpu_torch.verify.merkle import MerkleCommitment
native.BUILD_DIR = pathlib.Path(sys.argv[1])
rng = np.random.default_rng(3)
zs = torch.from_numpy(rng.normal(size=(5, 2, 8, 8)).astype(np.float32)).bfloat16()
epss = torch.from_numpy(rng.normal(size=(5, 2, 8, 8)).astype(np.float32)).bfloat16()
time.sleep(max(0.0, float(sys.argv[2]) - time.time()))
print(MerkleCommitment(np.arange(5) * 100 + 1, zs, epss).root.hex(), native.build().name)
"""


def test_three_processes_build_at_once(tmp_path):
    """Three processes start their build into one empty directory at the
    same moment: each loads a whole library (the same name), the roots are
    equal and equal to this process's, and no temporary file is left."""
    build_dir = tmp_path / "native"
    start_at = time.time() + 8.0  # after every process has imported torch
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_IN, str(build_dir), str(start_at)],
                              cwd=REPO, env={**os.environ, "PYTHONPATH": REPO}, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for _ in range(3)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0], [err for _, err in outs]
    roots = {out.split()[0] for out, _ in outs}
    names = {out.split()[1] for out, _ in outs}
    rng = np.random.default_rng(3)
    zs = torch.from_numpy(rng.normal(size=(5, 2, 8, 8)).astype(np.float32)).bfloat16()
    epss = torch.from_numpy(rng.normal(size=(5, 2, 8, 8)).astype(np.float32)).bfloat16()
    want = merkle.MerkleCommitment(np.arange(5) * 100 + 1, zs, epss, use_native=False)
    assert roots == {want.root.hex()}
    assert len(names) == 1 and sorted(p.name for p in build_dir.iterdir()) == sorted(names)


@pytest.mark.parametrize("compiler", ["missing", "failing"])
def test_failed_build_raises_and_is_not_remembered(tmp_path, monkeypatch, compiler):
    """A compiler that is not there, or one that exits nonzero, makes the
    hash raise (with the command's output), the commitment too; nothing
    falls back to hashlib, and once the compiler is back the next call in
    the same process builds."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    bad = str(tmp_path / "no-such-g++") if compiler == "missing" else "false"
    monkeypatch.setattr(native, "CXX", bad)
    with pytest.raises(RuntimeError, match="merkle.cpp"):
        native.sha256(b"dvdx")
    ts, zs, epss, _, _ = _leaves_inputs(2, "bf16", seed=9)
    with pytest.raises(RuntimeError):
        merkle.MerkleCommitment(ts, zs, epss)
    assert not list((tmp_path / "native").glob("*.so"))
    monkeypatch.setattr(native, "CXX", "g++")
    assert native.sha256(b"dvdx") == hashlib.sha256(b"dvdx").digest()
    assert len(list((tmp_path / "native").glob("*.so"))) == 1
