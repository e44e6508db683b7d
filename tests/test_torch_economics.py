"""The port's economics (``dvdx_tpu_torch/economics``, own copies of the JAX
package's numpy / scipy modules) against the JAX package's, and
``ValidatorConfig.from_economics`` in both packages.

Both sides run the same numpy program from the same seed, so every output
must be bitwise equal (``np.testing.assert_array_equal``). The grids and
horizons are small (4 alphas x 4 slash fractions, T = 8, 12 epochs, 16
Monte-Carlo paths) so that the module runs in seconds.
"""

import dataclasses

import numpy as np
import pytest

from dvdx_tpu.economics import cost as jcost
from dvdx_tpu.economics import optimize as jopt
from dvdx_tpu.economics import params as jparams
from dvdx_tpu.economics import security as jsec
from dvdx_tpu.network.validator import ValidatorConfig as JValidatorConfig
from dvdx_tpu_torch.economics import cost as tcost
from dvdx_tpu_torch.economics import optimize as topt
from dvdx_tpu_torch.economics import params as tparams
from dvdx_tpu_torch.economics import security as tsec
from dvdx_tpu_torch.network.validator import ValidatorConfig

SMALL = dict(num_steps=8, epochs=12)
GRID = dict(gamma=np.array([0.5, 0.8]), alpha=np.linspace(0.1, 0.6, 4),
            f=np.linspace(0.0, 0.6, 4))


def _small(mod, **kw):
    return dataclasses.replace(mod.DEFAULT, **SMALL, **kw)


def _assert_same(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], (float, int, bool, type(None))):
            assert a[k] == b[k], k
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_params_are_the_same():
    assert dataclasses.asdict(tparams.DEFAULT) == dataclasses.asdict(jparams.DEFAULT)


@pytest.mark.parametrize("k", [1, 3])
def test_p_detect_and_kappa_clip(k):
    ms = np.arange(1, 9)
    np.testing.assert_array_equal(tsec.p_detect(8, ms, k), jsec.p_detect(8, ms, k))
    w = np.random.default_rng(k).random((3, 12))
    np.testing.assert_array_equal(tsec.kappa_clip(w, 0.1), jsec.kappa_clip(w, 0.1))


@pytest.mark.parametrize("seed", [0, 3])
def test_simulate_ev_bitwise(seed):
    got = tsec.simulate_ev(_small(tparams), **GRID, n_paths=16, seed=seed)
    want = jsec.simulate_ev(_small(jparams), **GRID, n_paths=16, seed=seed)
    _assert_same(got, want)


def test_d_min_grid_bitwise():
    got = tcost.d_min_grid(_small(tparams), n_paths=16, seed=1)
    want = jcost.d_min_grid(_small(jparams), n_paths=16, seed=1)
    _assert_same(got, want)
    assert tcost.summarize(got) == jcost.summarize(want)


@pytest.mark.parametrize("gamma,margin", [(0.8, 0.0), (0.5, 0.0), (0.8, 1e9)])
def test_cheapest_secure_point_equal(gamma, margin):
    got = topt.cheapest_secure_point(_small(tparams), gamma=gamma, margin=margin,
                                     n_paths=16)
    want = jopt.cheapest_secure_point(_small(jparams), gamma=gamma, margin=margin,
                                      n_paths=16)
    assert got == want


@pytest.mark.parametrize("budget", [0.10, 0.5])
def test_min_checkpoints_secure_equal(budget):
    got = topt.min_checkpoints_secure(_small(tparams), gamma=0.8, t_steps=25,
                                      budget_fraction=budget, n_paths=16)
    want = jopt.min_checkpoints_secure(_small(jparams), gamma=0.8, t_steps=25,
                                       budget_fraction=budget, n_paths=16)
    assert got == want


@pytest.mark.parametrize("kw", [dict(num_steps=8),
                                dict(num_steps=25, verify_budget_fraction=0.10)])
def test_validator_config_from_economics_equal(kw):
    kw = dict(kw)
    budget = kw.pop("verify_budget_fraction", 0.0)
    got = ValidatorConfig.from_economics(gamma=0.8, params=_small(tparams),
                                         verify_budget_fraction=budget, **kw)
    want = JValidatorConfig.from_economics(gamma=0.8, params=_small(jparams),
                                           verify_budget_fraction=budget, **kw)
    for name in ("audit_rate", "slash_fraction", "trust_decay", "num_checkpoints",
                 "num_steps"):
        assert getattr(got, name) == getattr(want, name), name
    assert 0 < got.audit_rate <= 1 and got.trust_decay == 0.8


def test_from_economics_refuses_an_insecure_gamma():
    """A margin no EV gap can clear leaves no secure (alpha, f) cell: both
    packages raise."""
    with pytest.raises(ValueError):
        ValidatorConfig.from_economics(gamma=0.8, margin=1e9, params=_small(tparams))
    with pytest.raises(ValueError):
        JValidatorConfig.from_economics(gamma=0.8, margin=1e9, params=_small(jparams))
