"""Tests for sclmd_jax.baths against scalar NumPy oracles of baths.py."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sclmd_jax import baths as B
from tests.test_functions import flinterp_ref


def gamt_ref(tl, wl, gwl, gam, eta_ad=0.0):
    """Scalar oracle of baths.py:19-52."""
    gt = []
    if eta_ad == 0.0:
        for t in tl:
            tm = [np.array(flinterp_ref(w, gwl, gam)) * np.cos(w * t)
                  for w in wl]
            gt.append(2.0 * np.mean(np.array(tm), axis=0) * wl[-1] / np.pi)
    else:
        for t in tl:
            tm = []
            for w in wl:
                g = np.array(flinterp_ref(w, gwl, gam))
                tm.append(g * w / (w - 1j * eta_ad)
                          * np.exp(-1j * w * t - eta_ad * t)
                          + g * w / (w + 1j * eta_ad)
                          * np.exp(1j * w * t - eta_ad * t))
            gt.append(np.mean(np.array(tm), axis=0) * wl[-1] / np.pi)
    return np.real(np.array(gt))


class TestGamt:
    def test_matches_reference_loop(self, rng):
        nw, nc, ml, dt = 12, 2, 5, 0.3
        gwl = np.linspace(0, 2.0, 7)
        gam = rng.normal(size=(7, nc, nc))
        wl = np.array([2.5 * i / nw for i in range(nw)])
        tl = dt * np.arange(ml)
        got = np.asarray(B.gamt(tl, wl, gwl, gam))
        want = gamt_ref(tl, wl, gwl, gam)
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)

    def test_eta_ad_variant(self, rng):
        nw, nc, ml, dt = 9, 2, 4, 0.2
        gwl = np.linspace(0, 1.0, 5)
        gam = rng.normal(size=(5, nc, nc))
        wl = np.array([1.2 * i / nw for i in range(nw)])
        tl = dt * np.arange(ml)
        got = np.asarray(B.gamt(tl, wl, gwl, gam, eta_ad=0.05))
        want = gamt_ref(tl, wl, gwl, gam, eta_ad=0.05)
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


class TestEBath:
    def _mk(self, nc=3, bias=0.0, with_bias_mats=False, rng=None):
        efric = np.eye(nc) * 0.1
        kw = {}
        if with_bias_mats:
            m = rng.normal(size=(nc, nc))
            kw = dict(exim=(m - m.T) / 2, exip=(m + m.T) / 2,
                      zeta1=np.eye(nc) * 0.01, zeta2=(m - m.T) * 0.005)
        return B.ebath(range(nc), 300.0, 0.5, 64, wmax=1.0, nw=50,
                       bias=bias, efric=efric, dtype=jnp.float64, **kw)

    def test_symmetrization(self, rng):
        nc = 3
        m = rng.normal(size=(nc, nc))
        eb = B.ebath(range(nc), 300.0, 0.5, 64, wmax=1.0,
                     efric=m, exim=m, exip=m, zeta1=m, zeta2=m,
                     dtype=jnp.float64)
        np.testing.assert_allclose(np.asarray(eb.efric), (m + m.T) / 2)
        np.testing.assert_allclose(np.asarray(eb.exim), (m - m.T) / 2)
        np.testing.assert_allclose(np.asarray(eb.exip), (m + m.T) / 2)
        np.testing.assert_allclose(np.asarray(eb.zeta1), (m + m.T) / 2)
        np.testing.assert_allclose(np.asarray(eb.zeta2), (m - m.T) / 2)

    def test_friction_only_force(self, rng, key):
        nc, nph = 3, 9
        eb = self._mk(nc).replace(cids=jnp.array([2, 4, 7]))
        eb = eb.gnoi(key)
        phis = jnp.asarray(rng.normal(size=(1, nph)))
        qhis = jnp.asarray(rng.normal(size=(1, nph)))
        t = 5
        f = np.asarray(B.bforce(eb, eb.noise[t % 64], phis, qhis, nph))
        v = np.asarray(phis)[0][[2, 4, 7]]
        want_local = np.asarray(eb.noise)[t % 64] - np.asarray(eb.efric) @ v
        want = np.zeros(nph)
        want[[2, 4, 7]] = want_local
        np.testing.assert_allclose(f, want, rtol=1e-10)

    def test_bias_force_terms(self, rng, key):
        nc = 3
        eb = self._mk(nc, bias=0.7, with_bias_mats=True, rng=rng)
        eb = eb.gnoi(key)
        phis = jnp.asarray(rng.normal(size=(1, nc)))
        qhis = jnp.asarray(rng.normal(size=(1, nc)))
        t = 11
        f = np.asarray(B.bforce(eb, eb.noise[t % 64], phis, qhis, nc))
        v, q = np.asarray(phis)[0], np.asarray(qhis)[0]
        want = (np.asarray(eb.noise)[t % 64]
                - np.asarray(eb.efric) @ v
                + 0.7 * np.asarray(eb.exim) @ q
                - 0.7 * np.asarray(eb.zeta1) @ q
                - 0.7 * np.asarray(eb.zeta2) @ v)
        np.testing.assert_allclose(f, want, rtol=1e-10)

    def test_getsig_wideband(self):
        nc = 2
        eb = self._mk(nc, bias=0.0)
        sig = np.asarray(eb.GetSig())
        wl = eb.wl
        for i, w in enumerate(wl):
            np.testing.assert_allclose(sig[i], -1j * w * np.asarray(eb.efric),
                                       atol=1e-14)


class TestPhBath:
    def test_debye_defaults(self):
        nc, debye = 4, 0.1
        pb = B.phbath(300.0, range(nc), debye, 30, 0.5, 64,
                      dtype=jnp.float64)
        assert pb.local and pb.ml == 1
        np.testing.assert_allclose(np.asarray(pb.gamma[0]),
                                   np.eye(nc) * debye * np.pi / 6.0)
        assert pb.wmax == pytest.approx(2.0 * debye)
        np.testing.assert_allclose(np.asarray(pb.kernel), np.asarray(pb.gamma))

    def test_memory_kernel_force(self, rng, key):
        nc, ml, nmd, dt = 2, 6, 32, 0.4
        gwl = np.linspace(0, 0.5, 9)
        base = rng.normal(size=(nc, nc))
        gam = np.array([(base + base.T) / 2 * np.exp(-w) for w in gwl])
        pb = B.phbath(200.0, range(nc), 0.25, 20, dt, nmd, ml=ml,
                      gamma=gam, gwl=gwl, dtype=jnp.float64)
        pb = pb.gnoi(key)
        phis = jnp.asarray(rng.normal(size=(ml, nc)))
        qhis = jnp.zeros((ml, nc))
        t = 3
        f = np.asarray(B.bforce(pb, pb.noise[t % nmd], phis, qhis, nc))
        kern = np.asarray(pb.kernel)
        want = np.asarray(pb.noise)[t % nmd].copy()
        for m in range(ml):
            want -= kern[m] @ np.asarray(phis)[m] * dt
        np.testing.assert_allclose(f, want, rtol=1e-10)

    def test_ggamma_from_sig(self):
        nc = 2
        gwl = np.array([0.0, 0.1, 0.2])
        # Sigma(w) = -i w gamma0 => Gamma = gamma0
        gamma0 = np.eye(nc) * 0.3
        sig = np.array([-1j * w * gamma0 for w in gwl])
        pb = B.phbath(100.0, range(nc), 0.1, 10, 0.5, 16, ml=2,
                      sig=sig, gwl=gwl, dtype=jnp.float64)
        np.testing.assert_allclose(np.asarray(pb.gamma),
                                   np.broadcast_to(gamma0, (3, nc, nc)),
                                   atol=1e-12)

    def test_vmap_over_noise_ensemble(self, key):
        nc = 2
        pb = B.phbath(300.0, range(nc), 0.2, 16, 0.5, 32, dtype=jnp.float64)
        keys = jax.random.split(key, 4)
        baths = jax.vmap(pb.gnoi)(keys)
        assert baths.noise.shape == (4, 32, nc)
        # different keys -> different noise
        assert not np.allclose(np.asarray(baths.noise[0]),
                               np.asarray(baths.noise[1]))


class TestMutators:
    def test_ebath_setbias_refreshes_spectrum(self):
        nc = 2
        eb = B.ebath(range(nc), 300.0, 0.5, 64, wmax=1.0,
                     efric=np.eye(nc) * 0.1,
                     exim=np.array([[0, .01], [-.01, 0]]),
                     exip=np.eye(nc) * 0.01, dtype=jnp.float64)
        eb2 = eb.setbias(0.5)
        assert float(eb2.bias) == 0.5
        assert not np.allclose(np.asarray(eb.nstd), np.asarray(eb2.nstd))

    def test_phbath_setmemlen_regenerates_kernel(self):
        gwl = np.linspace(0, 0.5, 9)
        gam = np.array([np.eye(2) * 0.1 * np.exp(-w) for w in gwl])
        pb = B.phbath(200.0, range(2), 0.25, 20, 0.4, 32, ml=4,
                      gamma=gam, gwl=gwl, dtype=jnp.float64)
        pb2 = pb.SetMemlen(8)
        assert pb2.ml == 8 and pb2.kernel.shape[0] == 8
        np.testing.assert_allclose(np.asarray(pb2.kernel[:4]),
                                   np.asarray(pb.kernel), rtol=1e-10)

    def test_sett_changes_noise_amplitude(self, key):
        # classical bath: variance scales linearly with T (a quantum one
        # at these frequencies is zero-point dominated)
        pb = B.phbath(100.0, range(2), 0.2, 16, 0.5, 64,
                      classical=True, dtype=jnp.float64)
        hot = pb.SetT(1000.0)
        v_cold = float(jnp.var(pb.gnoi(key).noise))
        v_hot = float(jnp.var(hot.gnoi(key).noise))
        assert v_hot > 5 * v_cold
