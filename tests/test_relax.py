"""FIRE relaxation (models/relax.py) against analytic minima."""

import jax.numpy as jnp
import numpy as np

import pytest

from sclmd_jax.models.eam import EAMDriver, SUTTON_CHEN_PARAMS, fcc_cell
from sclmd_jax.models.relax import fire_relax, lbfgs_relax


@pytest.mark.parametrize("relaxer", [fire_relax, lbfgs_relax],
                         ids=["fire", "lbfgs"])
def test_quadratic_well_exact(relaxer):
    """Both minimizers find an anisotropic quadratic bowl's minimum."""
    k = jnp.asarray(np.array([[1.0, 3.0, 0.5], [2.0, 1.5, 4.0]]))
    x_star = jnp.asarray(np.array([[0.3, -1.2, 2.0], [0.0, 5.0, -2.5]]))

    def e(x):
        return 0.5 * jnp.sum(k * (x - x_star) ** 2)

    x, fmax, it = relaxer(e, np.zeros((2, 3)), tol=1e-8)
    assert fmax <= 1e-8
    np.testing.assert_allclose(x, np.asarray(x_star), atol=1e-6)
    assert 0 < it < 5000


def test_lbfgs_fixed_mask_and_cluster():
    """L-BFGS relaxes the rattled Cu cluster with frozen atoms held."""
    a0 = SUTTON_CHEN_PARAMS["Cu"]["a"]
    pos, _ = fcc_cell(2, 2, 2, a0)
    rng = np.random.default_rng(17)
    x0 = pos + 0.04 * rng.standard_normal(pos.shape)
    axyz = [["Cu"] + list(p) for p in x0]
    drv = EAMDriver(axyz, rcut=1.2 * a0, cutoff_skin=0.6)
    fixed = np.zeros(pos.shape, bool)
    fixed[:4] = True
    x, fmax, it = lbfgs_relax(drv.energy_fn, x0, tol=1e-5,
                              fixed_mask=fixed)
    np.testing.assert_array_equal(x[:4], x0[:4])
    assert fmax <= 1e-5
    assert it < 1000


def test_relax_perturbed_metal_cluster():
    """A rattled finite Cu cluster relaxes to fmax < tol with the
    energy strictly decreasing."""
    a0 = SUTTON_CHEN_PARAMS["Cu"]["a"]
    pos, _ = fcc_cell(2, 2, 2, a0)
    rng = np.random.default_rng(11)
    x0 = pos + 0.05 * rng.standard_normal(pos.shape)
    axyz = [["Cu"] + list(p) for p in x0]
    drv = EAMDriver(axyz, rcut=1.2 * a0, cutoff_skin=0.6)
    e0 = float(drv.energy_fn(jnp.asarray(x0)))
    x, fmax, it = fire_relax(drv.energy_fn, x0, tol=1e-4, maxit=2000)
    assert fmax <= 1e-4, (fmax, it)
    e1 = float(drv.energy_fn(jnp.asarray(x)))
    assert e1 < e0
    # sane structure: no collapse, no evaporation (free cluster may
    # drift rigidly and contract at the surface)
    d = np.linalg.norm(x[None] - x[:, None], axis=-1)
    np.fill_diagonal(d, np.inf)
    assert d.min() > 2.0
    assert d.min(axis=1).max() < 1.2 * a0


def test_fixed_mask_freezes_atoms():
    a0 = SUTTON_CHEN_PARAMS["Cu"]["a"]
    pos, _ = fcc_cell(2, 2, 2, a0)
    rng = np.random.default_rng(3)
    x0 = pos + 0.04 * rng.standard_normal(pos.shape)
    axyz = [["Cu"] + list(p) for p in x0]
    drv = EAMDriver(axyz, rcut=1.2 * a0, cutoff_skin=0.6)
    fixed = np.zeros(pos.shape, bool)
    fixed[:4] = True
    x, fmax, it = fire_relax(drv.energy_fn, x0, tol=5e-4, maxit=2000,
                             fixed_mask=fixed)
    np.testing.assert_array_equal(x[:4], x0[:4])
    assert not np.allclose(x[4:], x0[4:])
    assert fmax <= 5e-4
