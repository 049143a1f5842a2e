"""ops.anharmonic — SCP renormalized-Hessian estimator.

Pins: (1) the Gaussian-smeared Hessian against closed-form 1-DOF
anharmonic oscillators (quartic Hartree loop, cubic tadpole + center
shift), (2) the full pipeline delta_kappa = kappa(D_eff) - kappa(D)
against the independently-pinned MC response estimator d2/2 on a
quartic chain (tests/test_exact_gle.py::TestPerturbativeFamilies) —
for a pure quartic perturbation the static loop IS the complete
first-order correction, so the two must agree within MC error.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from scipy.special import gamma

from sclmd_jax import units as U
from sclmd_jax.ops.anharmonic import (line_variance_1d, mode_covariance,
                                      smeared_hessian,
                                      soft_mode_confinement)
from sclmd_jax.ops.functions import bose


class TestModeCovariance:
    def test_quantum_and_classical_limits(self):
        w2 = np.diag([0.04, 0.0004])  # 0.2 eV (ZP-dominated at 300K),
        T = 300.0                      # 0.02 eV (nearly classical)
        V, var, w = mode_covariance(w2, T)
        exp = (bose(w, T, xp=np) + 0.5) / w
        assert np.allclose(var, exp)
        # stiff mode: ZP dominated, var ~ 1/(2w)
        assert var[1] == pytest.approx(1.0 / (2 * 0.2), rel=0.01)
        # soft mode: classical limit, var -> kT/w^2
        Vc, varc, _ = mode_covariance(w2, T, classical=True)
        assert varc[0] == pytest.approx(U.KB * T / 0.0004)
        assert var[0] == pytest.approx(varc[0], rel=0.05)

    def test_null_modes_get_zero_variance(self):
        d = np.diag([0.0, 0.01])
        _, var, _ = mode_covariance(d, 300.0)
        assert var[0] == 0.0 and var[1] > 0.0


class TestLineVariance:
    T = 300.0

    def test_harmonic_exact(self):
        w2 = 0.01
        var = line_variance_1d(lambda q: 0.5 * w2 * q[0] ** 2,
                               np.array([1.0]), self.T)
        assert var == pytest.approx(U.KB * self.T / w2, rel=1e-3)

    def test_pure_quartic_closed_form(self):
        c = 1e-4
        var = line_variance_1d(lambda q: 0.25 * c * q[0] ** 4,
                               np.array([1.0]), self.T)
        exact = np.sqrt(4 * U.KB * self.T / c) * gamma(0.75) \
            / gamma(0.25)
        assert var == pytest.approx(exact, rel=1e-3)

    def test_double_well_confines_saddle(self):
        # negative curvature at 0 + quartic walls: the harmonic model
        # calls this unstable; the Boltzmann variance is finite and
        # ~ the well-minimum separation scale
        w2, c = -0.004, 1e-4
        var = line_variance_1d(
            lambda q: 0.5 * w2 * q[0] ** 2 + 0.25 * c * q[0] ** 4,
            np.array([1.0]), self.T)
        smin2 = -w2 / c          # wells at s^2 = |w2|/c = 40
        assert 0.5 * smin2 < var < 4 * smin2

    def test_unconfined_raises(self):
        with pytest.raises(ValueError, match="unconfined"):
            line_variance_1d(lambda q: 0.0 * q[0], np.array([1.0]),
                             self.T, smax_cap=64.0)


class TestSoftModeConfinement:
    T = 300.0

    def test_saddle_mode_confined_stiff_untouched(self):
        # 2-DOF: stiff mode (0.3 eV) + saddle direction (-3.6 meV,
        # the flagship's worst case) with quartic confinement
        w2s, w2u, c = 0.09, -(3.6e-3) ** 2, 1e-6
        dyn = np.diag([w2s, w2u])

        def energy(q):
            return (0.5 * w2s * q[0] ** 2 + 0.5 * w2u * q[1] ** 2
                    + 0.25 * c * q[1] ** 4)

        dD, info = soft_mode_confinement(energy, dyn, self.T)
        assert len(info) == 1            # only the saddle is soft
        assert dD[0, 0] == 0.0 and dD[0, 1] == 0.0
        lam = np.linalg.eigvalsh(dyn + dD)
        assert lam.min() > 0             # confined reference stable
        # harmonic variance of D' along the soft mode == 1-D Boltzmann
        var_h = U.KB * self.T / (dyn + dD)[1, 1]
        assert var_h == pytest.approx(info[0][1], rel=1e-6)
        # and that variance is the true anharmonic one
        ref = line_variance_1d(energy, np.array([0.0, 1.0]), self.T)
        assert info[0][1] == pytest.approx(ref, rel=1e-6)

    def test_free_subspace_embedding(self):
        w2s, c = 0.09, 1e-6
        dyn = np.diag([0.0, w2s, 0.0])   # DOF 0 fixed, DOF 2 soft

        def energy(q):
            return 0.5 * w2s * q[1] ** 2 + 0.25 * c * q[2] ** 4

        dD, info = soft_mode_confinement(energy, dyn, self.T,
                                         free=np.array([1, 2]))
        assert len(info) == 1
        assert np.all(dD[0, :] == 0) and np.all(dD[:, 0] == 0)
        assert dD[2, 2] > 0


class TestSmearedHessian1DOF:
    """V = w2 q^2/2 + g q^3/3 + c q^4/4 has closed-form smeared
    quantities: E[F(qb+z)] = -w2 qb - g(qb^2+s2) - c(qb^3+3 qb s2),
    <H(qb+z)> = w2 + 2 g qb + 3 c (qb^2 + s2)."""

    W2, T = 0.01, 300.0

    def _run(self, g, c, npairs=256, **kw):
        w2 = self.W2

        def force(q):
            return -(w2 * q + g * q ** 2 + c * q ** 3)

        dyn = np.array([[w2]])
        return smeared_hessian(force, 1, dyn, self.T, npairs=npairs,
                               seed=3, **kw)

    def _sigma2(self, classical=False):
        w = np.sqrt(self.W2)
        if classical:
            return U.KB * self.T / self.W2
        return float((bose(w, self.T, xp=np) + 0.5) / w)

    def test_pure_quartic_hartree_loop(self):
        s2 = self._sigma2()
        c = 0.02 * self.W2 / s2      # 2% renormalization
        res = self._run(0.0, c)
        assert abs(res["qbar"][0]) < 1e-12   # parity: no shift
        # per-pair spread is 3c*std(z^2) = 3c s2 sqrt(2)
        sem = 3 * c * s2 * np.sqrt(2) / np.sqrt(res["meta"]["npairs"])
        assert res["dD"][0, 0] == pytest.approx(3 * c * s2, abs=5 * sem)
        # halves straddle the mean
        a, b = res["dD_halves"]
        assert abs(a[0, 0] + b[0, 0] - 2 * res["dD"][0, 0]) < 1e-14

    def test_cubic_tadpole_center_shift(self):
        s2 = self._sigma2()
        g = 0.05 * self.W2 / np.sqrt(s2)
        res = self._run(g, 0.0, center_iters=8)
        # exact smeared stationary point of the cubic
        qb = (-self.W2 + np.sqrt(self.W2 ** 2 - 4 * g ** 2 * s2)) \
            / (2 * g)
        # H(q) = w2 + 2 g q is LINEAR: antithetic pair means are
        # noiseless; only the center estimate carries probe noise
        assert res["qbar"][0] == pytest.approx(qb, rel=0.05)
        assert res["dD"][0, 0] == pytest.approx(2 * g * qb, rel=0.05)
        assert res["dD"][0, 0] < 0.0   # cubic softens

    def test_classical_covariance_switch(self):
        s2c = self._sigma2(classical=True)
        c = 0.02 * self.W2 / s2c
        res = self._run(0.0, c, classical=True)
        sem = 3 * c * s2c * np.sqrt(2) / np.sqrt(256)
        assert res["dD"][0, 0] == pytest.approx(3 * c * s2c,
                                                abs=5 * sem)

    def test_h0_gate_detects_wrong_dyn(self):
        res = smeared_hessian(
            lambda q: -(self.W2 * q), 1,
            np.array([[2 * self.W2]]), self.T, npairs=2, seed=0)
        assert res["h0_gate"] > 0.4

    def test_free_mask_pins_fixed_dofs(self):
        w2 = self.W2

        def force(q):
            return -(w2 * q + 0.3 * w2 * q ** 3)

        dyn = np.eye(2) * w2
        res = smeared_hessian(force, 2, dyn, self.T, npairs=16,
                              seed=1, free=np.array([1]))
        assert res["dD"][0, 0] == 0.0 and res["dD"][0, 1] == 0.0
        assert res["dD"][1, 1] != 0.0
        assert res["qbar"][0] == 0.0
