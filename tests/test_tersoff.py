"""Tests for the Tersoff bond-order potential (models/tersoff.py)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sclmd_jax.models.nnp import build_neighbors
from sclmd_jax.models.tersoff import (TersoffDriver, graphene_ribbon,
                                      tersoff_energy)


def _dimer_energy(r, element="C"):
    x = np.array([[0.0, 0, 0], [r, 0, 0]])
    nbr, mask = build_neighbors(x, 2.2, 4)
    e = tersoff_energy(element, nbr, mask)
    return float(e(jnp.asarray(x)))


class TestDimer:
    def test_dimer_binding_curve(self):
        """C2 dimer: bound (negative) near 1.4-1.5 A, zero beyond cutoff."""
        e_eq = _dimer_energy(1.45)
        assert e_eq < -4.0            # strong covalent bond
        assert _dimer_energy(2.5) == 0.0
        # short range repulsive
        assert _dimer_energy(0.8) > e_eq

    def test_dimer_minimum_location(self):
        rs = np.linspace(1.2, 1.8, 61)
        es = [_dimer_energy(r) for r in rs]
        rmin = rs[int(np.argmin(es))]
        # Tersoff C dimer minimum is near 1.4-1.5 A
        assert 1.3 < rmin < 1.6, rmin


class TestManyBody:
    def test_bond_order_weakens_with_coordination(self):
        """Adding a third neighbor reduces the pair bond energy (bond
        order < 1): E(trimer) > 3 * E(dimer)/... i.e. not pairwise
        additive."""
        r = 1.45
        x3 = np.array([[0.0, 0, 0], [r, 0, 0], [-r / 2, r * 0.866, 0]])
        nbr, mask = build_neighbors(x3, 2.2, 4)
        e3 = float(tersoff_energy("C", nbr, mask)(jnp.asarray(x3)))
        e2 = _dimer_energy(r)
        d12 = np.linalg.norm(x3[1] - x3[0])
        d13 = np.linalg.norm(x3[2] - x3[0])
        d23 = np.linalg.norm(x3[2] - x3[1])
        # pairwise sum of dimer energies at those separations
        pair_sum = sum(_dimer_energy(d) for d in (d12, d13, d23))
        assert abs(e3 - pair_sum) > 0.1   # genuinely many-body

    def test_forces_gradient_consistency(self, rng):
        x = graphene_ribbon(2, 2) + rng.normal(size=(8, 3)) * 0.02
        nbr, mask = build_neighbors(x, 2.2, 8)
        efn = tersoff_energy("C", nbr, mask)
        f = -np.asarray(jax.grad(efn)(jnp.asarray(x)))
        eps = 1e-6
        for (i, c) in [(0, 0), (3, 1), (7, 2)]:
            xp = x.copy(); xp[i, c] += eps
            xm = x.copy(); xm[i, c] -= eps
            fd = -(float(efn(jnp.asarray(xp))) -
                   float(efn(jnp.asarray(xm)))) / (2 * eps)
            np.testing.assert_allclose(f[i, c], fd, rtol=1e-5, atol=1e-7)


    def test_float32_forces_track_float64(self, rng):
        """The angular term 1 + c^2/d^2 - c^2/(d^2 + u) cancels two
        ~8e7 terms for carbon; in its one-quotient form the float32
        force stays within 2e-5 of the float64 one (the textbook form
        is off by ~3e-5 to 7e-5 on this ribbon)."""
        x = graphene_ribbon(4, 2) + rng.normal(size=(16, 3)) * 0.02
        nbr, mask = build_neighbors(x, 2.2, 8)
        grad = jax.jit(jax.grad(tersoff_energy("C", nbr, mask)))
        f64 = np.asarray(grad(jnp.asarray(x, jnp.float64)))
        f32 = np.asarray(grad(jnp.asarray(x, jnp.float32)), np.float64)
        assert np.abs(f32 - f64).max() / np.abs(f64).max() < 2e-5


class TestDriver:
    def _driver(self):
        x = graphene_ribbon(3, 2)
        axyz = [["C", *row] for row in x]
        return TersoffDriver(axyz)

    def test_graphene_cohesion(self):
        drv = self._driver()
        e = drv.energy()
        na = drv.number
        # Tersoff carbon cohesive energy ~ -7.4 eV/atom in bulk; ribbon
        # edges raise it, but it must be solidly bound
        assert e / na < -4.0

    def test_dynmat_stability(self):
        drv = self._driver()
        d = np.asarray(drv.dynmat())
        np.testing.assert_allclose(d, d.T, atol=1e-10)
        ev = np.linalg.eigvalsh(d)
        # translations ~0; no strongly unstable modes for the rigid sheet
        assert ev.min() > -2e-3, ev.min()
        assert ev.max() > 1e-3

    def test_md_runs_with_tersoff(self, key):
        from sclmd_jax import baths as B
        from sclmd_jax.md import GLESystem, initial_state, run_segment
        drv = self._driver()
        nph = 3 * drv.number
        dt, nmd = 0.4, 64
        eb = B.ebath(range(6), 300.0, dt, nmd, wmax=1.0,
                     efric=np.eye(6) * 0.02, dtype=jnp.float64).gnoi(key)
        system = GLESystem(dyn=None, baths=(eb,), mask=jnp.ones(nph),
                           dt=dt, nph=nph, ml=1, nmd=nmd,
                           force_fn=drv.force_jax)
        final, ys = run_segment(system, initial_state(
            system, dtype=jnp.float64), nmd)
        assert np.isfinite(np.asarray(final.p)).all()
        assert np.abs(np.asarray(final.q)).max() < 10.0

    def test_multi_element_unparametrized_rejected(self):
        with pytest.raises(NotImplementedError):
            TersoffDriver([["C", 0, 0, 0], ["H", 1, 0, 0]])


class TestMultiElement:
    def test_sic_mixing_reduces_to_single_for_pure(self, rng):
        """Multi-element kernel == single-element kernel on pure Si."""
        from sclmd_jax.models.nnp import build_neighbors
        from sclmd_jax.models.tersoff import (tersoff_energy,
                                              tersoff_energy_multi)
        x = np.array([[0, 0, 0], [2.35, 0, 0], [1.2, 2.0, 0],
                      [3.5, 2.0, 0.3]]) + rng.normal(size=(4, 3)) * 0.02
        nbr, mask = build_neighbors(x, 3.0, 3)
        e1 = tersoff_energy("Si", nbr, mask)
        em = tersoff_energy_multi(["Si"] * 4, nbr, mask)
        np.testing.assert_allclose(float(em(jnp.asarray(x))),
                                   float(e1(jnp.asarray(x))), rtol=1e-10)

    def test_sic_dimer_bound_and_differentiable(self):
        drv = TersoffDriver([["Si", 0, 0, 0], ["C", 1.85, 0, 0]])
        assert drv.energy() < -2.0        # SiC bond ~ -3..-4 eV region
        f = np.asarray(drv.force(np.zeros(6)))
        assert np.isfinite(f).all()
        d = np.asarray(drv.dynmat())
        assert np.isfinite(d).all()

    def test_chi_weakens_hetero_bond(self):
        """chi_SiC < 1 reduces the attractive branch vs chi = 1."""
        from sclmd_jax.models.nnp import build_neighbors
        from sclmd_jax.models.tersoff import (TERSOFF_CHI,
                                              tersoff_energy_multi)
        x = np.array([[0.0, 0, 0], [1.85, 0, 0]])
        nbr, mask = build_neighbors(x, 3.0, 2)
        e_chi = tersoff_energy_multi(["Si", "C"], nbr, mask)
        old = TERSOFF_CHI[("Si", "C")]
        try:
            TERSOFF_CHI[("Si", "C")] = 1.0
            e_nochi = tersoff_energy_multi(["Si", "C"], nbr, mask)
            v_chi = float(e_chi(jnp.asarray(x)))
            v_nochi = float(e_nochi(jnp.asarray(x)))
        finally:
            TERSOFF_CHI[("Si", "C")] = old
        assert v_chi > v_nochi            # weaker binding with chi < 1
