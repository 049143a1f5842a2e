"""Tests for the NEGF stack: decimation self-energy + bpt transport."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sclmd_jax import units as U
from sclmd_jax.negf import bpt, landauer_current_natural
from sclmd_jax.selfenergy import (lead_selfenergy_from_blocks, sig,
                                  surface_gf)


def chain_blocks(k=0.1, n=1):
    """Principal-layer blocks of a 1D chain with n sites/layer, spring k."""
    K00 = np.zeros((n, n))
    for i in range(n):
        K00[i, i] = 2 * k
        if i + 1 < n:
            K00[i, i + 1] = -k
            K00[i + 1, i] = -k
    K01 = np.zeros((n, n))
    K01[-1, 0] = -k
    return K00, K01


def brute_surface_gf(omega, k, eta, N=4000):
    """Closed-form oracle: semi-infinite 1D chain surface GF.

    Sigma = k^2 g solves Sigma = k^2 / (z^2 - 2k - Sigma)
    => Sigma = [(z^2-2k) -+ sqrt((z^2-2k)^2 - 4k^2)]/2, retarded branch
    (Im Sigma <= 0, decaying outside the band); g_surf = Sigma / k^2.
    """
    z2 = (omega + 1j * eta) ** 2
    s = z2 - 2 * k
    disc = np.sqrt(s ** 2 - 4 * k ** 2 + 0j)
    roots = [(s - disc) / 2, (s + disc) / 2]
    # retarded/decaying branch
    roots.sort(key=lambda r: (round(r.imag, 12), abs(r)))
    sig_r = roots[0] if roots[0].imag < -1e-14 else \
        min(roots, key=lambda r: abs(r))
    return sig_r / k ** 2


class TestSurfaceGF:
    @pytest.mark.parametrize("omega", [0.05, 0.3, 0.55])
    def test_matches_brute_force_chain(self, omega):
        k, eta = 0.1, 1e-4
        K00, K01 = chain_blocks(k)
        g, niter, conv = surface_gf(jnp.asarray(omega), jnp.asarray(K00),
                                    jnp.asarray(K00), jnp.asarray(K01),
                                    eta=eta)
        assert bool(conv)
        want = brute_surface_gf(omega, k, eta)
        np.testing.assert_allclose(complex(g[0, 0]), want, rtol=2e-3)

    def test_outside_band_real(self):
        k = 0.1
        K00, K01 = chain_blocks(k)
        w = 1.0  # above band top 2 sqrt(k) = 0.632
        g, _, conv = surface_gf(jnp.asarray(w), jnp.asarray(K00),
                                jnp.asarray(K00), jnp.asarray(K01),
                                eta=1e-6)
        assert bool(conv)
        assert abs(float(jnp.imag(g[0, 0]))) < 1e-4

    def test_lead_selfenergy_from_blocks(self):
        k = 0.1
        K00, K01 = chain_blocks(k)
        V01 = np.array([[-k]])
        wl = np.array([0.1, 0.3, 0.5])
        se = np.asarray(lead_selfenergy_from_blocks(K00, K01, V01, wl,
                                                    eta=1e-4))
        for i, w in enumerate(wl):
            g = brute_surface_gf(w, k, 1e-4)
            np.testing.assert_allclose(se[i, 0, 0], k * k * g, rtol=3e-3)
        # in-band: Im Sigma < 0 (dissipative)
        assert (se[:, 0, 0].imag < 0).all()


class TestSigClass:
    def _dynmat_chain(self, n=16, k=0.1):
        d = np.zeros((n, n))
        for i in range(n - 1):
            d[i, i] += k
            d[i + 1, i + 1] += k
            d[i, i + 1] -= k
            d[i + 1, i] -= k
        d[0, 0] += k
        d[-1, -1] += k  # grounded ends = bulk-like onsite everywhere
        return d / U.RPC ** 2  # eV^2 -> ps^-2 convention of sig input

    def test_transmission_unity_in_band(self):
        k = 0.1
        # perfect chain: device = 2 sites, leads = same chain
        d = self._dynmat_chain(16, k)
        g0 = list(range(8, 10))
        g1 = list(range(10, 12))
        mode = sig(d, 0.9 * 2 * np.sqrt(k), g0, g1, num=40, eta=1e-3)
        tm = mode.gettm()
        band = (tm[:, 0] * U.RPC > 0.15) & (tm[:, 0] * U.RPC
                                            < 2 * np.sqrt(k) * 0.85)
        assert np.allclose(tm[band, 1], 1.0, atol=0.08), tm[band, 1]

    def test_dos_positive(self):
        k = 0.1
        d = self._dynmat_chain(16, k)
        mode = sig(d, 0.6, range(8, 10), range(10, 12), num=30, eta=1e-3)
        mode.getse("L")
        assert (mode.dos[:, 1] > -1e-8).all()
        assert mode.dos[:, 1].max() > 0


def bpt_oracle_tm(dynmat_ps2, damp, bathL, bathR, omegas):
    """Dense NumPy Caroli oracle of negf.py:206-243 (no fixed atoms)."""
    nd = len(dynmat_ps2)
    out = []
    for w in omegas:
        seL = np.zeros((nd, nd), complex)
        seR = np.zeros((nd, nd), complex)
        for i in bathL:
            seL[i, i] = -1j * w / damp
        for i in bathR:
            seR[i, i] = -1j * w / damp
        g = np.linalg.inv((w + 1e-9j) ** 2 * np.eye(nd) - dynmat_ps2
                          - seL - seR)
        gl = -1j * (seL - seL.conj().T)
        gr2 = -1j * (seR - seR.conj().T)
        out.append(np.real(np.trace(g @ gl @ g.conj().T @ gr2)))
    return np.array(out)


class TestBPT:
    def _chain(self, n=10, k=0.1):
        d = np.zeros((n, n))
        for i in range(n - 1):
            d[i, i] += k
            d[i + 1, i + 1] += k
            d[i, i + 1] -= k
            d[i + 1, i] -= k
        return d

    def test_tm_matches_dense_oracle(self):
        k, damp = 0.1, 20.0
        d = self._chain(10, k) / U.RPC ** 2
        bathL, bathR = [0, 1], [8, 9]
        b = bpt(d, 0.7, damp, [bathL, bathR], num=25)
        tm = b.gettm()
        # skip w=0: the free chain's translational mode makes A singular
        want = bpt_oracle_tm(d, damp, bathL, bathR, tm[1:, 0])
        np.testing.assert_allclose(tm[1:, 1], want, rtol=1e-7, atol=1e-10)

    def test_fixed_dof_deletion(self):
        k, damp = 0.1, 20.0
        n = 12
        d0 = self._chain(n, k) / U.RPC ** 2
        # fix the two end DOFs; bath on next-to-end
        fixed = [[0], [11]]
        b = bpt(d0, 0.7, damp, [[1, 2], [9, 10]], dofatomfixed=fixed,
                num=10)
        assert b.nd == n - 2
        # oracle: delete rows/cols, bath ids shift by one
        d1 = np.delete(np.delete(d0, [0, 11], 0), [0, 11], 1)
        tm = b.gettm()
        want = bpt_oracle_tm(d1, damp, [0, 1], [8, 9], tm[1:, 0])
        np.testing.assert_allclose(tm[1:, 1], want, rtol=1e-7, atol=1e-10)

    def test_thermal_current_units_consistency(self):
        """bpt's eV*ps Landauer integral == natural-units integral * CURCOF."""
        k, damp = 0.1, 20.0
        d = self._chain(10, k) / U.RPC ** 2
        b = bpt(d, 0.7, damp, [[0, 1], [8, 9]], num=200)
        b.gettm()
        T, delta = 300.0, 0.1
        j_ref = b.thermalcurrent(T, delta)
        # natural-units integral on the same grid
        w_ev = b.tmnumber[:, 0] * U.RPC
        j_nat = float(landauer_current_natural(
            w_ev, b.tmnumber[:, 1], T * (1 + delta / 2),
            T * (1 - delta / 2))) * U.CURCOF
        np.testing.assert_allclose(j_nat, j_ref, rtol=1e-3)

    def test_conductance_positive_and_scales(self):
        k, damp = 0.1, 20.0
        d = self._chain(10, k) / U.RPC ** 2
        b = bpt(d, 0.7, damp, [[0, 1], [8, 9]], num=100)
        b.gettm()
        c300 = b.thermalconductance(300.0, 0.1)
        assert c300 > 0
        j1 = b.thermalcurrent(300.0, 0.05)
        j2 = b.thermalcurrent(300.0, 0.1)
        assert abs(j2 / j1 - 2.0) < 0.05   # linear response regime

    def test_equilibrium_power_spectrum(self):
        k, damp = 0.1, 20.0
        d = self._chain(6, k) / U.RPC ** 2
        b = bpt(d, 0.7, damp, [[0], [5]], num=10)
        ps = b.getps(300.0, 0.6, 20)
        assert ps.shape == (21, 2)
        assert (ps[1:, 1] > -1e-10).all()

    def test_bias_power_spectrum_runs(self):
        k, damp = 0.1, 20.0
        d = self._chain(6, k) / U.RPC ** 2
        b = bpt(d, 0.7, damp, [[0], [5]], num=10)
        nb = 2
        b.setbias(0.05, bdamp=np.eye(nb) * 0.02,
                  chiplus=np.eye(nb) * 0.01, chiminus=np.zeros((nb, nb)),
                  dofatomofbias=[2, 3])
        ps = b.getps(300.0, 0.6, 15)
        assert np.isfinite(ps[:, 1]).all()


class TestLesserGreater:
    def test_meir_wingreen_equals_landauer(self):
        """Lead heat current from G lesser/greater == Landauer integral
        (working version of the reference's commented draft,
        negf.py:314-379)."""
        k, damp = 0.1, 20.0
        n = 10
        d = np.zeros((n, n))
        for i in range(n - 1):
            d[i, i] += k; d[i + 1, i + 1] += k
            d[i, i + 1] -= k; d[i + 1, i] -= k
        d = d / U.RPC ** 2
        b = bpt(d, 0.7, damp, [[0, 1], [8, 9]], num=400)
        T, delta = 300.0, 0.2
        TL, TR = T * (1 + delta / 2), T * (1 - delta / 2)
        # Landauer on the same omega grid the MW integral uses
        ws = np.linspace(0, b.maxomega, b.intnum + 1)[1:]
        tm = np.asarray(b._tm_batch(jnp.asarray(ws)))
        occ = np.asarray(b.bosedist(ws, TL)) - np.asarray(
            b.bosedist(ws, TR))
        j_landauer = float(np.trapezoid(
            b.rpc * ws / (2 * np.pi) * tm * occ, ws)) * 1.60217662e2
        j_mw_L = b.leadthermalcurrent(TL, TR, lead="L")
        j_mw_R = b.leadthermalcurrent(TL, TR, lead="R")
        np.testing.assert_allclose(j_mw_L, j_landauer, rtol=1e-8)
        # energy conservation: right lead absorbs what left emits
        np.testing.assert_allclose(j_mw_R, -j_mw_L, rtol=1e-6)

    def test_equilibrium_current_vanishes(self):
        k, damp = 0.1, 20.0
        n = 8
        d = np.zeros((n, n))
        for i in range(n - 1):
            d[i, i] += k; d[i + 1, i + 1] += k
            d[i, i + 1] -= k; d[i + 1, i] -= k
        b = bpt(d / U.RPC ** 2, 0.7, damp, [[0], [7]], num=100)
        j = b.leadthermalcurrent(300.0, 300.0, lead="L")
        assert abs(j) < 1e-10


class TestWriteVSim:
    def test_golden_format(self, tmp_path):
        """write_v_sim golden-format check (ref negf.py:279-298): header,
        box rows, one position row per atom, one #metaData block per
        mode with mass-unweighted displacements."""
        k, damp = 0.1, 20.0
        nat = 3
        n = 3 * nat
        d = np.zeros((n, n))
        for i in range(n - 1):
            d[i, i] += k; d[i + 1, i + 1] += k
            d[i, i + 1] -= k; d[i + 1, i] -= k
        els = np.repeat([12.011] * nat, 3)          # carbon masses per DOF
        xyz = np.arange(n, dtype=float)
        b = bpt(d / U.RPC ** 2, 0.7, damp, [[0], [n - 1]], num=5,
                els=els, xyz=xyz, boxlo=[0.0, 0.0, 0.0],
                boxhi=[10.0, 11.0, 12.0])
        fn = tmp_path / "anime.ascii"
        b.write_v_sim(str(fn))
        lines = fn.read_text().splitlines()
        assert lines[0] == "# Generated file for v_sim 3.7"
        np.testing.assert_allclose(
            [float(x) for x in lines[1].split()], [10.0, 0.0, 11.0])
        np.testing.assert_allclose(
            [float(x) for x in lines[2].split()], [0.0, 0.0, 12.0])
        # one position row per atom, element name resolved from the mass
        assert lines[3].split()[-1] == "C"
        assert len([ln for ln in lines if ln.startswith("#metaData")]) == n
        # each mode block: natoms displacement rows + closing "# ]"
        assert len([ln for ln in lines if ln.startswith("#;")]) == n * nat
        assert lines[-1] == "# ]"
        # displacement rows are eigvec / sqrt(mass) (negf.py:292-295)
        first_disp = [float(x) for x in
                      lines[3 + nat + 1].lstrip("#;").split(";")[:3]]
        want = b.eigvecs[0, :3] / 12.011 ** 0.5
        np.testing.assert_allclose(first_disp, want, atol=5e-7)

    def test_missing_metadata_raises(self):
        d = np.eye(6) * 0.1
        b = bpt(d / U.RPC ** 2, 0.7, 20.0, [[0], [5]], num=5)
        with pytest.raises(ValueError, match="write_v_sim"):
            b.write_v_sim("nowhere.ascii")


class TestReferenceSelfEnergyMethods:
    """The reference-named self-energy surface (negf.py:153-204) must be
    consistent with the batched sweep internals."""

    def _biased(self, n=8):
        k, damp = 0.1, 20.0
        d = np.zeros((n, n))
        for i in range(n - 1):
            d[i, i] += k; d[i + 1, i + 1] += k
            d[i, i + 1] -= k; d[i + 1, i] -= k
        b = bpt(d / U.RPC ** 2, 0.7, damp, [[0], [n - 1]], num=5)
        nb = 2
        b.setbias(0.05, bdamp=np.eye(nb) * 0.02,
                  chiplus=np.eye(nb) * 0.01, chiminus=np.eye(nb) * 0.005,
                  dofatomofbias=[3, 4])
        return b

    def test_retar_and_advan(self):
        b = self._biased()
        w = 0.3 / U.RPC
        se = b.retarselfenergy(w, b.dofatomofbath[0])
        assert se.shape == (b.nd, b.nd)
        np.testing.assert_allclose(se[0, 0], -1j * w / b.damp)
        assert abs(se[1, 1]) == 0
        np.testing.assert_allclose(
            b.advanselfenergy(w, b.dofatomofbath[0]), se.conj().T)

    def test_keldysh_fdt(self):
        b = self._biased()
        w, T = 0.3 / U.RPC, 300.0
        kse = b.kselfenergy(w, T, b.dofatomofbath[0])
        nB = float(b.bosedist(w, T))
        np.testing.assert_allclose(kse[0, 0], 2 * w / b.damp * nB)

    def test_bias_block_matches_internals(self):
        b = self._biased()
        w = 0.3 / U.RPC
        se = b.retarbiasselfenergy(w, b.dofatomofbias)
        blk = np.asarray(b._bias_block(np.asarray([w]))[0])
        sel = np.asarray(b._bathsel(b.dofatomofbias))
        np.testing.assert_allclose(se[np.ix_(sel, sel)], blk, rtol=1e-12)
        tot = b.totalkselfenergy(w, 300.0)
        assert tot.shape == (b.nd, b.nd)
        assert np.isfinite(tot).all()

    def test_unbiased_returns_zero(self):
        k, damp = 0.1, 20.0
        d = np.eye(6) * k
        b = bpt(d / U.RPC ** 2, 0.7, damp, [[0], [5]], num=5)
        assert b.retarbiasselfenergy(0.1, []) == 0
        assert b.kbiasselfenergy(0.1, 300.0, []) == 0

    def test_less_great_fdt_relation(self):
        """Sig^> - Sig^< = 2i Im Sigma^r (the Keldysh identity) and both
        are anti-Hermitian-ish diagonal here."""
        b = self._biased()
        w, T = 0.3 / U.RPC, 300.0
        dof = b.dofatomofbath[0]
        sl = b.lessselfenergy(w, T, dof)
        sg = b.greatselfenergy(w, T, dof)
        np.testing.assert_allclose(sg - sl,
                                   2j * np.imag(b.retarselfenergy(w, dof)),
                                   atol=1e-14)
        slb = b.lessbiasselfenergy(w, T, b.dofatomofbias)
        sgb = b.greatbiasselfenergy(w, T, b.dofatomofbias)
        np.testing.assert_allclose(
            sgb - slb, 2j * np.imag(b.retarbiasselfenergy(
                w, b.dofatomofbias)), atol=1e-14)

    def test_gf_blocks_shapes_and_hermiticity(self):
        """i G^< and -i G^> blocks are Hermitian positive-semidefinite
        when built from a single lead's Sigma."""
        b = self._biased()
        w, T = 0.3 / U.RPC, 300.0
        dof = b.dofatomofbath[0]
        gl = b.lessgf(w, T, dof)
        gg = b.greatgf(w, T, dof)
        assert gl.shape == (len(dof), len(dof))
        np.testing.assert_allclose(1j * gl, (1j * gl).conj().T, atol=1e-12)
        np.testing.assert_allclose(-1j * gg, (-1j * gg).conj().T,
                                   atol=1e-12)
        ev = np.linalg.eigvalsh(1j * gl)
        assert (ev > -1e-12).all()

    def test_biasthermalcurrent(self):
        """Zero without bias; finite with, and scales off at bias->0."""
        k, damp = 0.1, 20.0
        n = 8
        d = np.zeros((n, n))
        for i in range(n - 1):
            d[i, i] += k; d[i + 1, i + 1] += k
            d[i, i + 1] -= k; d[i + 1, i] -= k
        b0 = bpt(d / U.RPC ** 2, 0.7, damp, [[0], [n - 1]], num=40)
        assert b0.biasthermalcurrent(300.0, [3, 4]) == 0.0
        b = self._biased()
        j = b.biasthermalcurrent(300.0, b.dofatomofbias, num=40)
        assert np.isfinite(j)
        # with the bias block zeroed the draft integrand vanishes
        b.bias = 0.0
        b.biasgamma = b.biasgamma * 0.0
        b.chiminus = b.chiminus * 0.0
        j0 = b.biasthermalcurrent(300.0, b.dofatomofbias, num=40)
        assert abs(j0) < 1e-12


class TestShardedEnergyGrid:
    def test_gettm_sharded_matches_serial(self):
        """Energy-grid parallelism: omega sweep sharded over the 8-device
        mesh == the single-device sweep."""
        from sclmd_jax.parallel.ensemble import make_mesh
        k, damp = 0.1, 20.0
        n = 10
        d = np.zeros((n, n))
        for i in range(n - 1):
            d[i, i] += k; d[i + 1, i + 1] += k
            d[i, i + 1] -= k; d[i + 1, i] -= k
        b = bpt(d / U.RPC ** 2, 0.7, damp, [[0, 1], [8, 9]], num=37)
        tm_serial = b.gettm().copy()
        mesh = make_mesh({"ep": 8})
        tm_sharded = b.gettm(mesh=mesh)
        np.testing.assert_allclose(tm_sharded, tm_serial, rtol=1e-12)

    def test_getps_sharded_matches_serial(self):
        from sclmd_jax.parallel.ensemble import make_mesh
        k, damp = 0.1, 20.0
        n = 6
        d = np.zeros((n, n))
        for i in range(n - 1):
            d[i, i] += k; d[i + 1, i + 1] += k
            d[i, i + 1] -= k; d[i + 1, i] -= k
        b = bpt(d / U.RPC ** 2, 0.7, damp, [[0], [5]], num=13)
        ps_serial = b.getps(300.0, 0.6, 13).copy()
        mesh = make_mesh({"ep": 8})
        ps_sharded = b.getps(300.0, 0.6, 13, mesh=mesh)
        np.testing.assert_allclose(ps_sharded, ps_serial, rtol=1e-12)

    def test_getse_sharded_matches_serial(self):
        from sclmd_jax.parallel.ensemble import make_mesh
        k = 0.1
        n = 16
        d = np.zeros((n, n))
        for i in range(n - 1):
            d[i, i] += k; d[i + 1, i + 1] += k
            d[i, i + 1] -= k; d[i + 1, i] -= k
        d[0, 0] += k; d[-1, -1] += k
        mode = sig(d / U.RPC ** 2, 0.6, range(8, 10), range(10, 12),
                   num=21, eta=1e-3)
        se_serial = mode.getse("L").copy()
        mesh = make_mesh({"ep": 8})
        se_sharded = mode.getse("L", mesh=mesh)
        np.testing.assert_allclose(se_sharded, se_serial, rtol=1e-10)
