"""Tests for the JAX force-driver stack (models/)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sclmd_jax import units as U
from sclmd_jax.models import pair as P
from sclmd_jax.models.driver import HostDriver, JaxDriver
from sclmd_jax.models.harmonic import HarmonicDriver, chain_dynmat


def lj_oracle(x, eps, sig, rc, pairs, shift=True):
    """Plain-NumPy LJ energy for verification."""
    e = 0.0
    sr6c = (sig / rc) ** 6
    esh = 4 * eps * (sr6c ** 2 - sr6c) if shift else 0.0
    for i, j in zip(*pairs):
        r = np.linalg.norm(x[j] - x[i])
        if r < rc:
            sr6 = (sig / r) ** 6
            e += 4 * eps * (sr6 ** 2 - sr6) - esh
    return e


class TestPairPotentials:
    def test_neighbor_pairs_simple(self):
        x = np.array([[0, 0, 0], [1, 0, 0], [5, 0, 0]])
        i, j = P.neighbor_pairs(x, cutoff=2.0, skin=0.1)
        assert set(zip(i, j)) == {(0, 1)}

    def test_neighbor_pairs_pbc(self):
        x = np.array([[0.5, 0, 0], [9.5, 0, 0]])
        i, j = P.neighbor_pairs(x, cutoff=2.0, skin=0.1,
                                cell=np.array([10.0, 10.0, 10.0]))
        assert set(zip(i, j)) == {(0, 1)}

    def test_lj_energy_matches_oracle(self, rng):
        x = rng.normal(size=(6, 3)) * 2.0 + np.arange(6)[:, None] * [2, 0, 0]
        pairs = P.neighbor_pairs(x, 5.0)
        efn = P.lennard_jones_energy(0.01, 2.5, 5.0, pairs)
        got = float(efn(jnp.asarray(x)))
        want = lj_oracle(x, 0.01, 2.5, 5.0, pairs)
        np.testing.assert_allclose(got, want, rtol=1e-10)

    def test_pair_driver_protocol(self):
        """PairDriver meets the reference driver contract: restoring
        force at a displacement, PSD dynmat at an fcc LJ lattice."""
        # fcc at the LJ equilibrium spacing r_min = 2^(1/6) sigma
        sig = 2.5
        a0 = 2.0 ** (1.0 / 6.0) * sig * np.sqrt(2.0)
        basis = np.array([[0, 0, 0], [0, .5, .5], [.5, 0, .5],
                          [.5, .5, 0]])
        pos = np.concatenate([basis + off for off in
                              np.indices((2, 2, 2)).reshape(3, -1).T])
        pos *= a0
        cell = np.array([2.0, 2.0, 2.0]) * a0
        axyz = [["Ar"] + list(p) for p in pos]
        # first-shell cutoff: neighbors sit exactly at the LJ minimum,
        # so the lattice is strain-free (and 2 (rc+skin) < L)
        drv = P.PairDriver(axyz, kind="lj",
                           params=dict(epsilon=0.0104, sigma=sig),
                           cutoff=0.8 * a0, cell=cell)
        n = 3 * len(axyz)
        q = np.zeros(n)
        q[0] = 0.01
        f = np.asarray(drv.force(q))
        assert f.shape == (n,) and np.isfinite(f).all()
        assert f[0] < 0.0
        d = np.asarray(drv.dynmat())
        ev = np.linalg.eigvalsh((d + d.T) / 2)
        assert ev.min() > -1e-8

    def test_driver_shell_newx(self):
        """DriverShell forwards the reference's newx (cartesian from
        mass-weighted displacement, lammpsdriver.py:newx)."""
        axyz = [["Cu", 0.0, 0.0, 0.0], ["Cu", 2.0, 0.0, 0.0]]
        drv = P.PairDriver(axyz, kind="morse",
                           params=dict(D=0.4, alpha=1.4, r0=2.0))
        q = 0.01 * np.arange(6)
        np.testing.assert_allclose(drv.newx(q),
                                   drv.xyz + drv.conv * q)

    def test_pair_driver_morse_and_rejects(self):
        axyz = [["Cu", 0.0, 0.0, 0.0], ["Cu", 2.0, 0.0, 0.0]]
        D, alpha, r0 = 0.4, 1.4, 2.0
        drv = P.PairDriver(axyz, kind="morse",
                           params=dict(D=D, alpha=alpha, r0=r0))
        # PairDriver uses the cutoff-shifted convention (continuous
        # at rc): e(r0) = -D - e_raw(rc)
        rc = r0 + 2.5 / alpha
        exc = np.exp(-alpha * (rc - r0))
        eshift = D * (exc ** 2 - 2.0 * exc)
        assert abs(float(drv.energy()) - (-D - eshift)) < 1e-8
        import pytest as _pytest
        with _pytest.raises(ValueError):
            P.PairDriver(axyz, kind="buckingham")

    def test_morse_minimum(self):
        x = np.array([[0.0, 0, 0], [1.5, 0, 0]])
        efn = P.morse_energy(1.0, 2.0, 1.5, 4.0, ([0], [1]))
        e0 = float(efn(jnp.asarray(x)))
        np.testing.assert_allclose(e0, -1.0, rtol=1e-10)
        g = jax.grad(efn)(jnp.asarray(x))
        np.testing.assert_allclose(np.asarray(g), 0.0, atol=1e-10)


class TestJaxDriver:
    def _dimer(self):
        r0 = 1.5
        axyz = [["C", 0.0, 0.0, 0.0], ["C", r0, 0.0, 0.0]]
        efn = P.morse_energy(2.0, 1.8, r0, 5.0, ([0], [1]))
        return JaxDriver(lambda x: efn(x), axyz, dtype=jnp.float64), r0

    def test_f0_zero_at_minimum(self):
        drv, _ = self._dimer()
        np.testing.assert_allclose(np.asarray(drv.f0), 0.0, atol=1e-10)

    def test_force_restoring(self):
        drv, r0 = self._dimer()
        # stretch the bond: displace atom 1 +x in mass-weighted coords
        q = np.zeros(6)
        q[3] = 0.1 / drv.conv[3]     # 0.1 angstrom stretch
        f = np.asarray(drv.force(q))
        assert f[3] < 0               # pulls back
        # Newton's third law (conv-weighted): f/conv sums to zero
        raw = f / drv.conv
        np.testing.assert_allclose(raw[3] + raw[0], 0.0, atol=1e-8)

    def test_dynmat_vs_finite_difference(self):
        drv, _ = self._dimer()
        d = np.asarray(drv.dynmat())
        # finite-difference q-space hessian
        nph = 6
        h = np.zeros((nph, nph))
        eps = 1e-5
        for a in range(nph):
            qp = np.zeros(nph); qp[a] = eps
            qm = np.zeros(nph); qm[a] = -eps
            fp = np.asarray(drv.force(qp))
            fm = np.asarray(drv.force(qm))
            h[:, a] = -(fp - fm) / (2 * eps)
        np.testing.assert_allclose(d, (h + h.T) / 2, atol=1e-6)

    def test_dynmat_frequencies_positive(self):
        drv, _ = self._dimer()
        ev = np.linalg.eigvalsh(np.asarray(drv.dynmat()))
        # 5 zero modes (translations + rotations for a dimer), 1 stretch
        assert (ev > -1e-8).all()
        assert ev[-1] > 1e-6

    def test_md_with_jax_driver(self, key):
        """Full GLE MD with a real anharmonic JAX potential driver."""
        from sclmd_jax import baths as B
        from sclmd_jax.md import GLESystem, initial_state, run_segment
        r0 = 1.53
        na = 6
        axyz = [["C", r0 * i, 0.0, 0.0] for i in range(na)]
        x0 = np.array([a[1:] for a in axyz])
        pairs = ([i for i in range(na - 1)], [i + 1 for i in range(na - 1)])
        efn = P.morse_energy(3.6, 1.9, r0, 4.0, pairs)
        drv = JaxDriver(lambda x: efn(x), axyz, dtype=jnp.float64)
        nph, dt, nmd = 3 * na, 0.4, 256
        eb = B.ebath(range(3), 300.0, dt, nmd, wmax=1.0,
                     efric=np.eye(3) * 0.02, dtype=jnp.float64).gnoi(key)
        system = GLESystem(dyn=None, baths=(eb,), mask=jnp.ones(nph),
                           dt=dt, nph=nph, ml=1, nmd=nmd,
                           force_fn=drv.force_jax)
        final, ys = run_segment(system, initial_state(system,
                                                      dtype=jnp.float64),
                                nmd)
        assert np.isfinite(np.asarray(final.p)).all()
        assert np.isfinite(np.asarray(ys["etot"])).all()
        # bounded motion (no atoms flying away)
        assert np.abs(np.asarray(final.q)).max() < 50.0


class TestHostDriver:
    def test_pure_callback_roundtrip(self, key):
        """Host-side engine driven through pure_callback inside jit."""
        dyn = np.asarray(chain_dynmat(6, 0.1))

        class NumpyEngine:
            conv = np.ones(6)
            f0 = np.zeros(6)

            def force(self, q):
                return -(dyn @ np.asarray(q))

        hd = HostDriver(NumpyEngine(), nph=6, dtype=jnp.float64)
        q = jax.random.normal(key, (6,), dtype=jnp.float64)
        got = jax.jit(hd.force_jax)(q)
        np.testing.assert_allclose(np.asarray(got), -(dyn @ np.asarray(q)),
                                   rtol=1e-12)

    def test_host_driver_in_md(self, key):
        from sclmd_jax import baths as B
        from sclmd_jax.md import GLESystem, initial_state, run_segment
        dyn = np.asarray(chain_dynmat(6, 0.1))

        class NumpyEngine:
            conv = np.ones(6)
            f0 = np.zeros(6)

            def force(self, q):
                return -(dyn @ np.asarray(q))

        hd = HostDriver(NumpyEngine(), nph=6, dtype=jnp.float64)
        nmd = 32
        eb = B.ebath([0, 5], 300.0, 0.4, nmd, wmax=1.0,
                     efric=np.eye(2) * 0.02, dtype=jnp.float64).gnoi(key)
        system = GLESystem(dyn=None, baths=(eb,), mask=jnp.ones(6),
                           dt=0.4, nph=6, ml=1, nmd=nmd,
                           force_fn=hd.force_jax)
        final, _ = run_segment(system, initial_state(system,
                                                     dtype=jnp.float64), 32)
        # equivalent all-JAX run
        system2 = GLESystem(dyn=jnp.asarray(dyn), baths=(eb,),
                            mask=jnp.ones(6), dt=0.4, nph=6, ml=1, nmd=nmd)
        final2, _ = run_segment(system2, initial_state(
            system2, dtype=jnp.float64), 32)
        np.testing.assert_allclose(np.asarray(final.p),
                                   np.asarray(final2.p), rtol=1e-10)
