"""Stillinger-Weber potential validation (models/sw.py)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sclmd_jax.models.nnp import build_neighbors
from sclmd_jax.models.sw import (SW_PARAMS, SWDriver, diamond_cell,
                                 sw_energy)


@pytest.fixture(scope="module")
def diamond():
    pos, cell = diamond_cell(2, 2, 2)
    p = SW_PARAMS["Si"]
    rcut = p["a"] * p["sigma"]
    nbr, mask = build_neighbors(pos, rcut, 16, cell=cell)
    return pos, cell, sw_energy("Si", nbr, mask, cell=cell)


class TestSWEnergy:
    def test_cohesive_energy(self, diamond):
        """Published SW-silicon cohesive energy: -4.3364 eV/atom at
        a0 = 5.431 (Stillinger & Weber 1985)."""
        pos, cell, efn = diamond
        e = float(efn(jnp.asarray(pos))) / len(pos)
        assert e == pytest.approx(-4.3364, abs=2e-3)

    def test_equilibrium_forces_vanish(self, diamond):
        pos, cell, efn = diamond
        g = jax.grad(lambda x: efn(x))(jnp.asarray(pos))
        assert float(jnp.abs(g).max()) < 1e-10

    def test_lattice_constant_is_minimum(self, diamond):
        pos, cell, efn = diamond
        e0 = float(efn(jnp.asarray(pos)))
        p = SW_PARAMS["Si"]
        rcut = p["a"] * p["sigma"]
        for s in (0.99, 1.01):
            pos2, cell2 = diamond_cell(2, 2, 2, a0=5.431 * s)
            nbr2, mask2 = build_neighbors(pos2, rcut, 16, cell=cell2)
            e2 = float(sw_energy("Si", nbr2, mask2, cell=cell2)(
                jnp.asarray(pos2)))
            assert e2 > e0 + 1e-3

    def test_cutoff_is_hard_zero(self):
        """phi2/phi3 vanish at r >= a*sigma (no discontinuity)."""
        p = SW_PARAMS["Si"]
        rcut = p["a"] * p["sigma"]
        pos = np.array([[0.0, 0.0, 0.0], [rcut + 1e-6, 0.0, 0.0]])
        nbr, mask = build_neighbors(pos, rcut, 4)
        e = float(sw_energy("Si", nbr, mask)(jnp.asarray(pos)))
        assert e == 0.0


class TestSWDriver:
    def _junction(self):
        pos, cell = diamond_cell(1, 1, 2)
        axyz = [["Si"] + list(p) for p in pos]
        return axyz, cell

    def test_driver_protocol(self):
        axyz, cell = self._junction()
        drv = SWDriver(axyz, cell=cell)
        n = 3 * len(axyz)
        np.testing.assert_allclose(drv.f0, 0.0, atol=1e-9)
        q = np.zeros(n); q[0] = 0.01
        f = drv.force(q)
        assert f.shape == (n,)
        # restoring force opposes the displacement
        assert f[0] * q[0] < 0
        d = drv.dynmat()
        np.testing.assert_allclose(d, d.T, atol=1e-7)
        ev = np.linalg.eigvalsh((d + d.T) / 2)
        assert ev.min() > -1e-6          # stable equilibrium

    def test_dynmat_chunked_matches_full(self):
        """Row-block HVP assembly (the large-system path) equals the
        one-shot jax.hessian dynamical matrix."""
        axyz, cell = self._junction()
        drv = SWDriver(axyz, cell=cell)
        d_full = np.asarray(drv.dynmat())
        d_chunk = np.asarray(drv.dynmat(chunk=7))
        np.testing.assert_allclose(d_chunk, d_full, rtol=1e-10,
                                   atol=1e-12)

    def test_nve_energy_conservation(self):
        """Bath-free NVE MD with the SW driver inside the jitted scan
        conserves total energy.

        Units: in mass-weighted natural coordinates q, KE = p.p/2 (eV)
        and PE(q) = driver.energy(q) (eV) directly — dPE/dq_i =
        conv_i dE/dx_i = -f_nat_i, so KE + PE is the conserved energy.
        """
        from sclmd_jax.md import GLESystem, initial_state, run_segment

        axyz, cell = self._junction()
        drv = SWDriver(axyz, cell=cell)
        nph = 3 * len(axyz)
        dt = 0.05
        system = GLESystem(dyn=None, baths=(), mask=jnp.ones(nph),
                           dt=dt, nph=nph, ml=1, nmd=512,
                           force_fn=drv.force_jax)
        st = initial_state(system, dtype=jnp.float64)
        key = jax.random.PRNGKey(0)
        st = st.replace(p=0.02 * jax.random.normal(key, (nph,),
                                                   jnp.float64))

        def etot(s):
            ke = 0.5 * float(jnp.dot(s.p, s.p))
            pe = float(drv.energy(np.asarray(s.q))) - float(drv.energy())
            return ke + pe

        e0 = etot(st)
        fin, _ = run_segment(system, st, 512)
        e1 = etot(fin)
        assert np.isfinite(np.asarray(fin.q)).all()
        assert abs(e1 - e0) < 2e-3 * abs(e0), (e0, e1)


class TestSWNegf:
    def test_bpt_from_driver_object(self):
        """bpt accepts a driver directly (hasattr .dynmat branch): the
        full workflow junction -> dynamical matrix -> transmission on an
        SW-silicon slab."""
        from sclmd_jax.negf import bpt

        pos, cell = diamond_cell(1, 1, 2)
        axyz = [["Si"] + list(p) for p in pos]
        drv = SWDriver(axyz, cell=cell)
        n = 3 * len(axyz)
        bathL = list(range(6))
        bathR = list(range(n - 6, n))
        b = bpt(drv, 0.09, 1.0, [bathL, bathR], num=12)
        # element masses / positions flow through from the driver
        assert b.els is not None and len(b.els) == n
        tm = b.gettm()
        assert tm.shape == (13, 2)
        assert np.isfinite(tm).all() and (tm[:, 1] > -1e-10).all()
        assert tm[:, 1].max() > 0.05     # phonons do transmit
        g = b.thermalconductance(300.0, 0.1)
        assert g > 0
