"""Coverage for public surfaces a symbol-usage audit found untested:
refactorisation setters, the nonequilibrium Lambda branch, analytic
identities, and the small utility shims."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sclmd_jax import baths as B
from sclmd_jax import units as U
from sclmd_jax.models.harmonic import chain_dynmat


class TestLambdaNonequilibrium:
    def _pl(self, rng):
        from tests.test_lambda import small_model
        return small_model(rng)

    def test_vanishes_at_zero_bias(self, rng):
        """df_L = df_R = 0 at muL = muR = mu0 -> the nonequilibrium
        correlation vanishes identically (lambda.py:1084-1283)."""
        pl = self._pl(rng)
        lam, hlam = pl.nonequ_lambda_fft(hwcut=10.0, muL=0.0, muR=0.0,
                                         mu0=0.0)
        np.testing.assert_allclose(np.asarray(lam), 0.0, atol=1e-14)
        np.testing.assert_allclose(np.asarray(hlam), 0.0, atol=1e-14)

    def test_biased_structure(self, rng):
        """At finite bias: finite, with the reference's
        sym-real/antisym-imag mode structure."""
        pl = self._pl(rng)
        lam, hlam = pl.nonequ_lambda_fft(hwcut=10.0, muL=0.15,
                                         muR=-0.15, mu0=0.0)
        lam = np.asarray(lam)
        assert np.isfinite(lam).all() and np.abs(lam).max() > 0
        np.testing.assert_allclose(lam.real,
                                   np.swapaxes(lam.real, 1, 2),
                                   atol=1e-12)
        np.testing.assert_allclose(lam.imag,
                                   -np.swapaxes(lam.imag, 1, 2),
                                   atol=1e-12)

    def test_full_lambda_bundle(self, rng):
        pl = self._pl(rng)
        out = pl.full_lambda(hwcut=10.0, muL=0.1, muR=-0.1)
        for k in ("LamLL", "LamRR", "LamLR", "LamRL", "LamEqu",
                  "LamNon", "LamHNon", "Pir", "Pir2", "TR"):
            assert k in out and np.isfinite(np.asarray(out[k])).all(), k
        # retarded Pi: Im part odd-ish and negative at w>0 on the
        # diagonal average (dissipative)
        Pir = np.asarray(out["Pir"])
        pos = pl.E > 0
        assert np.trace(np.imag(Pir[pos]).mean(axis=0)) < 1e-10


class TestBathRefactorisation:
    def _ph(self, dt=0.4, nmd=64, ml=9):
        gwl = np.linspace(0.0, 0.6, 8)
        gam = np.array([np.eye(2) * 0.02] * 8)
        return B.phbath(300.0, [0, 1], 0.3, 16, dt, nmd, ml=ml,
                        gamma=gam, gwl=gwl, dtype=jnp.float64)

    def test_phbath_setmdsteps(self, key):
        pb = self._ph().SetMDsteps(0.2, 128)
        assert pb.dt == 0.2 and pb.nmd == 128
        xi = pb.gnoi(key).noise
        assert xi.shape == (128, 2) and np.isfinite(np.asarray(xi)).all()

    def test_phbath_setmemlen_regenerates_kernel(self):
        pb = self._ph()
        pb2 = pb.SetMemlen(5)
        assert pb2.kernel.shape == (5, 2, 2)
        # first taps agree with the longer kernel (same gamt integrand)
        np.testing.assert_allclose(np.asarray(pb2.kernel),
                                   np.asarray(pb.kernel[:5]), rtol=1e-10)

    def test_mode_predicates(self):
        """UseG/UsePi/UseK report the build mode (baths.py:356-373)."""
        pb = self._ph()
        assert pb.UseG() and not pb.UsePi() and not pb.UseK()
        gwl = np.linspace(0.0, 0.6, 8)
        sig = -1j * gwl[:, None, None] * np.eye(2) * 0.02
        pb_pi = B.phbath(300.0, [0, 1], 0.3, 16, 0.4, 64, ml=9,
                         sig=sig, gwl=gwl, dtype=jnp.float64)
        assert pb_pi.UsePi() and pb_pi.UseG() and not pb_pi.UseK()
        deb = B.phbath(300.0, [0, 1], 0.3, 16, 0.4, 64,
                       dtype=jnp.float64)
        assert deb.mode == "debye" and not deb.UsePi()

    def test_ggamma_zero_row(self):
        """Gamma = -Im Sigma / w; the w=0 row copies the next point
        (baths.py:375-395)."""
        gwl = np.array([0.0, 0.2, 0.4])
        sig = -1j * np.array([0.5, 0.2, 0.4])[:, None, None] * np.eye(2)
        g = B.ggamma(sig, gwl)
        np.testing.assert_allclose(g[1], np.eye(2) * (0.2 / 0.2))
        np.testing.assert_allclose(g[2], np.eye(2) * (0.4 / 0.4))
        np.testing.assert_allclose(g[0], g[1])   # w=0 row <- next point

    def test_ebath_setmdsteps(self, key):
        eb = B.ebath([0], 300.0, 0.4, 64, wmax=1.0,
                     efric=np.eye(1) / 60.0, dtype=jnp.float64)
        eb2 = eb.SetMDsteps(0.1, 256)
        xi = eb2.gnoi(key).noise
        assert xi.shape == (256, 1)
        # classical-limit variance scales with the refreshed grid
        assert np.isfinite(np.asarray(xi)).all()


class TestAnalyticIdentities:
    def test_surface_gf_np_matches_jax(self):
        from sclmd_jax.selfenergy import surface_gf, surface_gf_np
        k = 0.1
        K00 = np.array([[2 * k]])
        K01 = np.array([[-k]])
        for w in (0.1, 0.3, 0.55):
            g_j, _, conv = surface_gf(jnp.asarray(w), jnp.asarray(K00),
                                      jnp.asarray(K00), jnp.asarray(K01))
            g_n = surface_gf_np(w, K00, K00, K01)
            assert bool(conv)
            np.testing.assert_allclose(np.asarray(g_j), g_n, rtol=1e-8)

    def test_bpt_advangf_is_dagger_of_retargf(self):
        from sclmd_jax.negf import bpt
        d = np.zeros((6, 6))
        k = 0.1
        for i in range(5):
            d[i, i] += k; d[i + 1, i + 1] += k
            d[i, i + 1] -= k; d[i + 1, i] -= k
        b = bpt(d / U.RPC ** 2, 0.7, 20.0, [[0], [5]], num=5)
        w = 0.3 / U.RPC
        gr = np.asarray(b.retargf(w))
        ga = np.asarray(b.advangf(w))
        np.testing.assert_allclose(ga, gr.conj().T, rtol=1e-10)

    def test_thermalconductivity_scaling(self):
        from sclmd_jax.negf import bpt
        d = np.eye(6) * 0.1
        b = bpt(d / U.RPC ** 2, 0.7, 20.0, [[0], [5]], num=20)
        b.gettm()
        g = b.thermalconductance(300.0, 0.1)
        # kappa = G L / A * 10 (negf.py:275-277)
        assert b.thermalconductivity(300.0, 0.1, L=20.0, A=4.0) == \
            pytest.approx(g * 20.0 / 4.0 * 10)

    def test_myfft_roundtrip(self):
        from sclmd_jax.ops.functions import myfft
        f = myfft(0.3, 32)
        a = jnp.asarray(np.random.default_rng(0).normal(size=32))
        back = np.asarray(f.iFourier1D(f.Fourier1D(a)))
        np.testing.assert_allclose(back.real, np.asarray(a), atol=1e-12)
        with pytest.raises(ValueError, match="length error"):
            f.Fourier1D(jnp.zeros(8))


class TestUtilityShims:
    def test_sharded_ensemble_run(self, key):
        from sclmd_jax.parallel.ensemble import (
            ensemble_noise, ensemble_run, ensemble_states, make_mesh,
            sharded_ensemble_run)
        from tests.test_parallel import _small_system
        system = _small_system()
        bsys = ensemble_noise(system, key, 8)
        states = ensemble_states(bsys, 8)
        f_ref, _ = ensemble_run(bsys, states, 8)
        mesh = make_mesh({"dp": 8})
        f_sh, _ = sharded_ensemble_run(mesh, bsys, states, 8)
        np.testing.assert_allclose(np.asarray(f_sh.p),
                                   np.asarray(f_ref.p), rtol=1e-10)

    def test_compiled_cost(self):
        from sclmd_jax.utils.profiling import compiled_cost
        cost = compiled_cost(lambda a, b: a @ b,
                             jnp.ones((8, 8)), jnp.ones((8, 8)))
        assert isinstance(cost, dict)

    def test_read_old_eph_and_reordxyz(self, tmp_path):
        from sclmd_jax.utils import io as MIO
        rng = np.random.default_rng(0)
        nw, n = 4, 3
        z = rng.normal(size=(nw, n, n)).astype(complex)
        MIO.WriteEPHNCfile(str(tmp_path / "e.npz"),
                           np.linspace(0, 1, nw), np.array([0.1, 0.2]),
                           rng.normal(size=(2, n)),
                           rng.normal(size=(n, n)),
                           z, z.copy(), z.copy(), z.copy(), z.copy(),
                           rng.normal(size=(n, n)),
                           rng.normal(size=(n, n)))
        d = MIO.ReadEPHNCFile(str(tmp_path / "e.npz"))
        assert d.wl.shape == (nw,)
        # swap the block [2, 3] -> [3, 2]; element 1 stays in place
        anr, xyz = MIO.reordxyz([1, 2, 3], [[0.0], [1.0], [2.0]], [3, 2])
        assert anr == [1, 3, 2] and xyz == [[0.0], [2.0], [1.0]]

    def test_pair_bond_and_sum(self):
        from sclmd_jax.models.pair import (harmonic_bond_energy,
                                           lennard_jones_energy,
                                           sum_energies)
        pairs = (np.array([0]), np.array([1]))
        eb = harmonic_bond_energy(1.0, 1.0, pairs)
        x = jnp.asarray([[0.0, 0.0, 0.0], [1.3, 0.0, 0.0]])
        assert float(eb(x)) == pytest.approx(0.5 * 0.3 ** 2)
        elj = lennard_jones_energy(0.1, 1.0, 3.0, pairs)
        etot = sum_energies(eb, elj)
        assert float(etot(x)) == pytest.approx(float(eb(x)) +
                                               float(elj(x)))

    def test_deeppot_save_load_dpstart(self, tmp_path):
        from sclmd_jax.models.nnp import DeepPotSE, build_neighbors, \
            deepmddriver
        pos = np.array([[0.0, 0.0, 0.0], [1.2, 0.0, 0.0],
                        [0.0, 1.2, 0.0]])
        nbr, mask = build_neighbors(pos, 2.0, 2)
        model = DeepPotSE([0, 0, 0], 1, 2.0, 1.0, nbr, mask, seed=3)
        axyz = [["C"] + list(p) for p in pos]
        drv = deepmddriver(model, axyz)
        q = np.zeros(9); q[0] = 0.05; q[4] = -0.03   # non-rigid probe
        f_ref = drv.force(q)
        path = str(tmp_path / "m.npz")
        model.save(path)
        # fresh model with different init; dpstart restores parameters
        model2 = DeepPotSE([0, 0, 0], 1, 2.0, 1.0, nbr, mask, seed=99)
        drv2 = deepmddriver(model2, axyz)
        assert np.abs(drv2.force(q) - f_ref).max() > 1e-12
        drv2.dpstart(path)
        np.testing.assert_allclose(drv2.force(q), f_ref, rtol=1e-6,
                                   atol=1e-9)
