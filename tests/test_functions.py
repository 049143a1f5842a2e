"""Unit tests for sclmd_jax.ops.functions against tiny NumPy re-derivations.

Oracles below re-derive the reference conventions independently
(functions.py:17-53 FFT pair, 80-114 Bose/Fermi edges, 117-143 flinterp).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from sclmd_jax import units as U
from sclmd_jax.ops import functions as F


KB = U.KB


# --- scalar oracles -----------------------------------------------------------
def bose_ref(w, T):
    if T == 0.0:
        if w < 0.0:
            return -1.0
        return 0.0  # w=0 value 1/(e^{1/kb}-1) underflows to 0
    if w == 0.0:
        return 0.0
    return 1.0 / (np.exp(w / KB / T) - 1.0)


def equ_ref(w, cut, T, classical=False, zpmotion=True):
    hw = w
    zp = 0.5 if zpmotion else 0.0
    if hw >= cut:
        return 0.0
    if classical:
        return 2.0 * KB * T
    if hw == 0:
        return 2.0 * KB * T
    return 2.0 * hw * (zp + bose_ref(hw, T))


class TestFourier:
    def test_roundtrip(self, rng):
        n, dt = 64, 0.37
        a = rng.normal(size=n) + 1j * rng.normal(size=n)
        aw = F.fourier_t2w(jnp.asarray(a), dt)
        back = F.fourier_w2t(aw, dt)
        np.testing.assert_allclose(np.asarray(back), a, atol=1e-12)

    def test_normalization_matches_reference(self, rng):
        n, dt = 32, 0.5
        a = rng.normal(size=n)
        dw = 2 * np.pi / dt / n
        expect_fw = np.fft.ifft(a) * 2 * np.pi / dw
        expect_wt = np.fft.fft(a) * dw / 2 / np.pi
        np.testing.assert_allclose(np.asarray(F.fourier_t2w(jnp.asarray(a), dt)),
                                   expect_fw, atol=1e-12)
        np.testing.assert_allclose(np.asarray(F.fourier_w2t(jnp.asarray(a), dt)),
                                   expect_wt, atol=1e-12)

    def test_myfft_class(self, rng):
        n, dt = 16, 1.1
        m = F.myfft(dt, n)
        a = rng.normal(size=n)
        np.testing.assert_allclose(np.asarray(m.Fourier1D(a)),
                                   np.fft.ifft(a) * n * dt, atol=1e-12)
        with pytest.raises(ValueError):
            m.Fourier1D(np.zeros(5))


class TestOccupations:
    @pytest.mark.parametrize("T", [0.0, 10.0, 300.0])
    def test_bose_matches_scalar_reference(self, T):
        ws = [-0.2, -1e-3, 0.0, 1e-3, 0.05, 1.0]
        got = np.asarray(F.bose(jnp.asarray(ws), T))
        want = [bose_ref(w, T) for w in ws]
        np.testing.assert_allclose(got, want, rtol=1e-12)

    def test_fermi(self):
        assert float(F.fermi(0.0, 0.5, 0.0)) == 1.0
        assert float(F.fermi(1.0, 0.5, 0.0)) == 0.0
        assert float(F.fermi(0.5, 0.5, 0.0)) == 0.5
        got = float(F.fermi(0.6, 0.5, 300.0))
        want = 1 / (np.exp((0.6 - 0.5) / KB / 300.0) + 1)
        np.testing.assert_allclose(got, want, rtol=1e-12)

    @pytest.mark.parametrize("classical", [False, True])
    @pytest.mark.parametrize("zp", [False, True])
    @pytest.mark.parametrize("T", [0.0, 300.0])
    def test_equ_spectrum(self, T, classical, zp):
        cut = 1.0
        ws = [-0.5, 0.0, 1e-4, 0.3, 0.999, 1.0, 2.0]
        got = np.asarray(F.equ_spectrum(jnp.asarray(ws), cut, T, classical, zp))
        want = [equ_ref(w, cut, T, classical, zp) for w in ws]
        np.testing.assert_allclose(got, want, rtol=1e-10)

    def test_nonequ_spectrum(self):
        T, bias = 300.0, 0.1
        w = 0.05
        got_m = float(F.nonequ_spectrum(w, bias, T, -1))
        want_m = 2.0 * (w - bias) * (bose_ref(w - bias, T) - bose_ref(w, T))
        np.testing.assert_allclose(got_m, want_m, rtol=1e-10)
        got_p = float(F.nonequ_spectrum(w, bias, T, +1))
        want_p = 2.0 * (w + bias) * (bose_ref(w + bias, T) - bose_ref(w, T))
        np.testing.assert_allclose(got_p, want_p, rtol=1e-10)

    def test_xcoth_limit(self):
        assert float(F.xcoth(0.0)) == 1.0
        np.testing.assert_allclose(float(F.xcoth(2.0)),
                                   2.0 / np.tanh(2.0), rtol=1e-12)


def flinterp_ref(x, xs, ys):
    """Scalar re-derivation of functions.py:117-143."""
    xs = np.asarray(xs)
    idx = int(np.argmin(np.abs(xs - x)))
    if idx == len(xs) - 1:
        return ys[-1]
    if idx == 0:
        return ys[0]
    dd = x - xs[idx]
    if dd < 0:
        return ys[idx] + dd / (xs[idx] - xs[idx - 1]) * (ys[idx] - ys[idx - 1])
    return ys[idx] + dd / (xs[idx] - xs[idx + 1]) * (ys[idx] - ys[idx + 1])


class TestInterp:
    def test_flinterp_matches_reference(self, rng):
        xs = np.linspace(0.0, 1.0, 11)
        ys = rng.normal(size=(11,))
        for x in [0.0, 0.03, 0.07, 0.25, 0.5001, 0.96, 0.99, 1.0, 1.5, -0.3]:
            got = float(F.flinterp(x, xs, ys))
            np.testing.assert_allclose(got, flinterp_ref(x, xs, ys),
                                       rtol=1e-12, err_msg=f"x={x}")

    def test_flinterp_matrix_batched(self, rng):
        xs = np.linspace(0.0, 2.0, 7)
        ys = rng.normal(size=(7, 3, 3))
        xq = np.array([0.1, 0.9, 1.7])
        got = np.asarray(F.flinterp(jnp.asarray(xq), xs, ys))
        for k, x in enumerate(xq):
            np.testing.assert_allclose(got[k], flinterp_ref(x, xs, ys),
                                       rtol=1e-12)

    def test_single_point_grid(self):
        # Debye wideband case: one grid point, always returns it
        ys = np.array([[[2.0]]])
        got = float(F.flinterp(0.7, np.array([0.0]), ys)[0, 0])
        assert got == 2.0


class TestMatrixHelpers:
    def test_rpadleft(self, rng):
        h = jnp.asarray(rng.normal(size=(4, 3)))
        v = jnp.asarray(rng.normal(size=(3,)))
        out = np.asarray(F.rpadleft(h, v))
        np.testing.assert_allclose(out[0], np.asarray(v))
        np.testing.assert_allclose(out[1:], np.asarray(h)[:-1])
        out1 = np.asarray(F.rpadleft(h[:1], v))
        np.testing.assert_allclose(out1, np.asarray(v)[None])

    def test_symmetrize_hermitianize(self, rng):
        a = rng.normal(size=(4, 4))
        s = np.asarray(F.symmetrize(a))
        np.testing.assert_allclose(s, (a + a.T) / 2)
        c = rng.normal(size=(2, 4, 4)) + 1j * rng.normal(size=(2, 4, 4))
        h = np.asarray(F.hermitianize(c))
        np.testing.assert_allclose(h, (c + np.conj(np.swapaxes(c, 1, 2))) / 2)

    def test_chkshape(self):
        assert F.chkShape(np.eye(3)) == 3
        with pytest.raises(ValueError):
            F.chkShape(np.zeros((2, 3)))


class TestPowerSpec:
    def test_kinetic_energy_sumrule(self, rng):
        """integral of powerspecp over the full grid / 2pi = sum <v^2>."""
        nmd, dt, nph = 256, 0.4, 5
        ps = rng.normal(size=(nmd, nph))
        spec = np.asarray(F.powerspecp(jnp.asarray(ps), dt, nmd))
        dw = 2 * np.pi / dt / nmd
        integral = spec[:, 1].sum() * dw / (2 * np.pi)
        # Parseval: sum_t |v|^2 dt ... spectrum integral equals sum over time
        expect = (ps**2).sum() / nmd * dt * nmd / (dt * nmd)
        np.testing.assert_allclose(integral, expect, rtol=1e-8)

    def test_powerspecq_weighting(self, rng):
        nmd, dt = 64, 0.3
        qs = rng.normal(size=(nmd, 2))
        sq = np.asarray(F.powerspecq(jnp.asarray(qs), dt, nmd))
        sp = np.asarray(F.powerspecp(jnp.asarray(qs), dt, nmd))
        np.testing.assert_allclose(sq[:, 1], sp[:, 0] ** 2 * sp[:, 1],
                                   rtol=1e-8, atol=1e-12)
