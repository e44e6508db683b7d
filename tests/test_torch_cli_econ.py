"""The port's last commands and utilities against the JAX package's.

* ``keys`` (``verify/cli.py``): the same public key, signature and verdict
  as ``dvdx_tpu.verify.cli`` for the same seed and message (bytes equal);
* ``econ`` (``economics/run.py``): summary.json and both npz files equal to
  the JAX run's at ``--paths 8 --skip-sensitivity`` (arrays bitwise), and
  the sensitivity sweeps equal on a small configuration;
* ``utils.convert.convert_vae_encoder`` against the JAX converter (bitwise)
  and the diffusers-layout reference encoder (atol 5e-4, rtol 1e-3, as
  ``tests/test_convert.py`` holds the JAX one);
* ``graft_entry.dryrun_multichip`` on two gloo ranks, and its command
  refusing NCCL ranks without cards.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dvdx_tpu.economics import params as jparams
from dvdx_tpu.economics import run as jrun
from dvdx_tpu.economics import sensitivity as jsens
from dvdx_tpu.utils.convert import convert_vae_encoder as jconvert_vae_encoder
from dvdx_tpu.verify import cli as jcli
from dvdx_tpu_torch.economics import params as tparams
from dvdx_tpu_torch.economics import run as trun
from dvdx_tpu_torch.economics import sensitivity as tsens
from dvdx_tpu_torch.verify import cli as tcli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _out(capsys, fn, argv):
    rc = fn(argv)
    return rc, capsys.readouterr().out


# --- keys -----------------------------------------------------------------------------


@pytest.mark.parametrize("seed,message", [("my miner", "hello"), ("v-0", "")])
def test_keys_equal_the_jax_command(capsys, tmp_path, seed, message):
    key = str(tmp_path / "key.json")
    rc_t, gen_t = _out(capsys, tcli.main, ["keygen", "--seed", seed, "--out", key])
    rc_j, gen_j = _out(capsys, jcli.main, ["keygen", "--seed", seed])
    assert rc_t == rc_j == 0 and gen_t == gen_j
    assert json.load(open(key)) == {"pubkey": json.loads(gen_t)["pubkey"], "seed": seed}
    _, sig_t = _out(capsys, tcli.main, ["sign", "--key", key, "--message", message])
    _, sig_j = _out(capsys, jcli.main, ["sign", "--seed", seed, "--message", message])
    assert sig_t == sig_j
    s = json.loads(sig_t)
    for fn in (tcli.main, jcli.main):
        assert _out(capsys, fn, ["verify", "--pubkey", s["pubkey"], "--message", message,
                                 "--signature", s["signature"]]) == (0, '{"valid": true}\n')
        assert _out(capsys, fn, ["verify", "--pubkey", s["pubkey"], "--message", message + "!",
                                 "--signature", s["signature"]]) == (1, '{"valid": false}\n')


def test_keys_sign_needs_a_key(capsys):
    assert tcli.main(["sign", "--message", "m"]) == 2
    assert "need --key or --seed" in capsys.readouterr().err


def test_keys_and_econ_through_the_command_line(tmp_path):
    run = lambda *a: subprocess.run([sys.executable, "-m", "dvdx_tpu_torch", *a], cwd=REPO,  # noqa: E731
                                    capture_output=True, text=True, timeout=120,
                                    env={**os.environ, "PYTHONPATH": REPO})
    r = run("keys", "keygen", "--seed", "cli")
    assert r.returncode == 0
    assert json.loads(r.stdout)["pubkey"] == \
        jcli.Keypair.from_seed(b"cli").public_bytes.hex()
    r = run("econ", "--help")
    assert r.returncode == 0 and "--skip-sensitivity" in r.stdout


# --- econ -------------------------------------------------------------------------------


def test_econ_outputs_equal_the_jax_run(tmp_path, capsys):
    argv = ["--paths", "8", "--seed", "3", "--skip-sensitivity"]
    assert trun.main(["--out", str(tmp_path / "t")] + argv) == 0
    jrun.main(["--out", str(tmp_path / "j")] + argv)
    out = capsys.readouterr().out
    assert "secure fraction of grid" in out
    t, j = tmp_path / "t", tmp_path / "j"
    assert json.load(open(t / "summary.json")) == json.load(open(j / "summary.json"))
    for name in ("results_stage1.npz", "results_stage2.npz"):
        with np.load(t / name) as a, np.load(j / name) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name}:{k}")
    assert sorted(p.name for p in t.iterdir()) == sorted(p.name for p in j.iterdir())


@pytest.mark.parametrize("sweep", ["e_subnet_sensitivity", "cost_step_sensitivity"])
def test_sensitivity_equals_jax(sweep):
    small = dict(num_steps=8, epochs=6)
    tp = dataclasses.replace(tparams.DEFAULT, **small)
    jp = dataclasses.replace(jparams.DEFAULT, **small)
    grid = jsens.E_SUBNET_GRID[:2] if sweep.startswith("e_") else jsens.COST_STEP_GRID[:2]
    got = getattr(tsens, sweep)(tp, grid=grid, n_paths=4, seed=2)
    want = getattr(jsens, sweep)(jp, grid=grid, n_paths=4, seed=2)
    assert got == want
    assert (tsens.E_SUBNET_GRID, tsens.COST_STEP_GRID) == (jsens.E_SUBNET_GRID,
                                                           jsens.COST_STEP_GRID)


def test_visualize_imports_matplotlib_lazily():
    code = ("import sys\nsys.modules['matplotlib'] = None\n"
            "import dvdx_tpu_torch.economics.visualize, dvdx_tpu_torch.economics.run\n"
            "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120, env={**os.environ, "PYTHONPATH": REPO})
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


# --- convert_vae_encoder -------------------------------------------------------------------


def test_convert_vae_encoder_equals_jax_and_the_reference():
    from dvdx_tpu_torch.models.vae import VAEConfig, VAEEncoder
    from dvdx_tpu_torch.utils.bridge import load_jax_params
    from dvdx_tpu_torch.utils.convert import convert_vae_encoder
    from tests.test_convert import _randomize, _sd_numpy
    from tests.torch_ref import AutoencoderKLRef

    ref = _randomize(AutoencoderKLRef(latent_ch=4, block_out_channels=(16, 32),
                                      layers_per_block=1, groups=4, mid_attention=True).eval(),
                     seed=5)
    cfg = VAEConfig(latent_channels=4, base_channels=16, channel_mults=(1, 2),
                    layers_per_block=1, norm_groups=4, use_mid_attention=True,
                    final_tanh=False, dtype="float32")
    sd = _sd_numpy(ref)
    tree = convert_vae_encoder(sd, cfg)
    import jax

    want = jconvert_vae_encoder(sd, cfg)
    flat = lambda t: {jax.tree_util.keystr(p): np.asarray(v)  # noqa: E731
                      for p, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    a, b = flat(tree), flat(want)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    enc = load_jax_params(VAEEncoder(cfg).eval(), tree)
    x = np.random.default_rng(2).normal(0, 0.5, (1, 8, 8, 3)).astype(np.float32)
    with torch.no_grad():
        expect = ref.encode_mean(torch.from_numpy(x.transpose(0, 3, 1, 2)))
        got = enc(torch.from_numpy(x)) / cfg.scaling_factor
    np.testing.assert_allclose(got.numpy().transpose(0, 3, 1, 2), expect.numpy(),
                               atol=5e-4, rtol=1e-3)
    sd["encoder.extra.weight"] = np.zeros(1, np.float32)
    with pytest.raises(ValueError, match="unconverted VAE-encoder keys"):
        convert_vae_encoder(sd, cfg)


# --- graft entry ----------------------------------------------------------------------------


def test_dryrun_multichip_on_two_gloo_ranks(capsys):
    from dvdx_tpu_torch import graft_entry

    rows = graft_entry.dryrun_multichip(2, device="cpu", timeout_s=120)
    out = capsys.readouterr().out
    assert set(rows) == {"fsdp", "cp_exact", "cp_ulysses", "hybrid_ctx"}
    for name, (shape, err) in rows.items():
        assert err <= graft_entry.LIMITS[name], (name, err)
        assert f"{name:<11} mesh={shape}" in out
    assert rows["fsdp"][1] == 0.0  # the gathered leaves are the whole ones
    print(out)  # pytest -rP


def test_graft_entry_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: entry() would run on it")
    from dvdx_tpu_torch import graft_entry

    assert graft_entry.main([]) == 2
    # the dry run's ranks are on the card unless the caller asks for gloo
    assert graft_entry.main(["--skip-entry", "--ranks", "2"]) == 2
    assert graft_entry._mesh_factors(8) == (2, 2, 2) and graft_entry._mesh_factors(2) == (1, 1, 2)
