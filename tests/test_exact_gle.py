"""ops.exact_gle: zero-Monte-Carlo attractor expectation of the GLE
bath currents — validated at three levels: (1) the per-line noise
reconstruction against the real sampler draw-for-draw, (2) the exact
expectation against warm-started MD ensembles at the SAME tier (they
must agree to pure statistics, sharing every discretization effect),
(3) the exact expectation against the continuum Landauer integral at a
fine noise grid (the comb bias must be small)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sclmd_jax import baths as B
from sclmd_jax.md import initial_state, run_segment
from sclmd_jax.models.harmonic import chain_dynmat
from sclmd_jax.ops import noise as NZ
from sclmd_jax.ops.exact_gle import (attractor_expected_currents,
                                     current_forms, linearize_step)
from tests.test_crosscheck import negf_current_natural
from tests.test_md import make_system


class TestPerLineReconstruction:
    """The comb decomposition used by exact_gle must reproduce the real
    sampler series draw-for-draw (pins a_m, the e^{-i th t} sign, and
    the mirror/endpoint conventions)."""

    @pytest.mark.parametrize("m_line", [0, 3, 8])
    def test_single_line(self, m_line):
        nmd, nc = 16, 2
        h = nmd // 2
        dt = 0.37
        rng = np.random.default_rng(4)
        evecs = (rng.normal(size=(h + 1, nc, nc))
                 + 1j * rng.normal(size=(h + 1, nc, nc)))
        std = np.zeros((h + 1, nc))
        std[m_line] = [1.3, 0.7]
        key = jax.random.PRNGKey(9)
        xt = np.asarray(NZ.sample_noise(key, jnp.asarray(evecs),
                                        jnp.asarray(std), dt, nmd))
        # reproduce the Gaussian draws exactly as the sampler makes them
        r = np.asarray(jax.random.normal(key, std.shape,
                                         dtype=jnp.asarray(std).dtype)
                       ) * std
        u = evecs[m_line] @ r[m_line]
        a = (1.0 if m_line in (0, h) else 2.0) / (nmd * dt)
        t = np.arange(nmd)
        manual = a * np.real(np.outer(
            np.exp(-2j * np.pi * m_line * t / nmd), u))
        np.testing.assert_allclose(xt, manual, atol=1e-12)

    def test_full_spectrum(self):
        nmd, nc = 32, 3
        h = nmd // 2
        dt = 0.8
        rng = np.random.default_rng(11)
        evecs = (rng.normal(size=(h + 1, nc, nc))
                 + 1j * rng.normal(size=(h + 1, nc, nc)))
        std = np.abs(rng.normal(size=(h + 1, nc)))
        key = jax.random.PRNGKey(3)
        xt = np.asarray(NZ.sample_noise(key, jnp.asarray(evecs),
                                        jnp.asarray(std), dt, nmd))
        r = np.asarray(jax.random.normal(key, std.shape,
                                         dtype=jnp.asarray(std).dtype)
                       ) * std
        t = np.arange(nmd)
        manual = np.zeros((nmd, nc))
        for m in range(h + 1):
            u = evecs[m] @ r[m]
            a = (1.0 if m in (0, h) else 2.0) / (nmd * dt)
            manual += a * np.real(np.outer(
                np.exp(-2j * np.pi * m * t / nmd), u))
        np.testing.assert_allclose(xt, manual, atol=1e-12)


def _chain(nmd, TL, TR, dt=0.25 / 0.658, nph=8, eta=1.0 / (50 / 0.658)):
    dyn = np.asarray(chain_dynmat(nph, 0.04))
    ebl = B.ebath([0], TL, dt, nmd, wmax=1.0, efric=np.eye(1) * eta,
                  dtype=jnp.float64).prepare_noise()
    ebr = B.ebath([nph - 1], TR, dt, nmd, wmax=1.0,
                  efric=np.eye(1) * eta,
                  dtype=jnp.float64).prepare_noise()
    return make_system(dyn, [ebl, ebr], dt, nmd), dyn, eta


class TestExpectedCurrents:
    def test_quadratic_form_reproduces_cur(self, key):
        """v^T M v equals the integrator's reported current at a random
        (state, noise) point — the form extraction is exact."""
        from sclmd_jax.md import MDState, vv_step

        system, _, _ = _chain(64, 330.0, 270.0)
        system = system.replace(baths=tuple(
            b.gnoi(jax.random.fold_in(key, i)).replace(
                nevecs=None, nstd=None)
            for i, b in enumerate(system.baths)))
        M = current_forms(system)
        n = (2 + system.ml + 1) * system.nph
        rng = np.random.default_rng(2)
        x = rng.normal(size=n)
        xi0 = rng.normal(size=2)
        xi1 = rng.normal(size=2)
        v = np.concatenate([x, xi0, xi1])
        want = np.array([v @ M[b] @ v for b in range(2)])

        nph, ml = system.nph, system.ml
        st = MDState(t=jnp.asarray(0, jnp.int32),
                     p=jnp.asarray(x[:nph]),
                     q=jnp.asarray(x[nph:2 * nph]),
                     phis=jnp.asarray(
                         x[2 * nph:(2 + ml) * nph].reshape(ml, nph)),
                     qhis=jnp.asarray(x[(2 + ml) * nph:].reshape(1, nph)))
        rows = ((jnp.asarray(xi0[:1]), jnp.asarray(xi1[:1])),
                (jnp.asarray(xi0[1:]), jnp.asarray(xi1[1:])))
        _, out = vv_step(system, st, noise_rows=rows)
        np.testing.assert_allclose(np.asarray(out["cur"]), want,
                                   rtol=1e-9, atol=1e-12)

    def test_matches_md_ensemble_same_tier(self, key):
        """Warm-started MD ensemble mean == exact expectation at the
        SAME (coarse) tier, within pure statistics — both share every
        discretization effect, so agreement is tier-independent."""
        from sclmd_jax.md import (gle_step_jacobian, period_power,
                                  periodic_fixed_point, state_ravel,
                                  state_unravel)

        nmd = 2 ** 11
        system, _, _ = _chain(nmd, 345.0, 255.0)
        theory = attractor_expected_currents(system)
        j_th = (theory[0] - theory[1]) / 2

        A = gle_step_jacobian(system)
        AP = period_power(A, nmd)
        nens = 24
        keys = jax.random.split(key, (nens, 2))
        js = []
        for ks in keys:
            sysb = system.replace(baths=tuple(
                b.gnoi(k).replace(nevecs=None, nstd=None)
                for b, k in zip(system.baths, ks)))
            fin1, _ = run_segment(sysb,
                                  initial_state(sysb, dtype=jnp.float64),
                                  nmd)
            x0 = periodic_fixed_point(A, state_ravel(fin1), nmd,
                                      power=AP)
            _, ys = run_segment(
                sysb, state_unravel(x0, sysb, dtype=jnp.float64), nmd)
            cur = np.asarray(ys["cur"])
            js.append((cur[:, 0].mean() - cur[:, 1].mean()) / 2)
        js = np.asarray(js)
        sem = js.std() / np.sqrt(nens)
        assert abs(js.mean() - j_th) < 4 * sem, (js.mean(), j_th, sem)

    def test_schur_rank1_path_matches_dense(self):
        """The flagship-scale evaluation path (complex Schur + factored
        rank-nc current forms) equals the dense quadratic-form path to
        roundoff."""
        system, _, _ = _chain(2 ** 10, 320.0, 280.0)
        dense = attractor_expected_currents(system, method="dense")
        fast = attractor_expected_currents(system, method="schur")
        np.testing.assert_allclose(fast, dense, rtol=1e-7)

class TestShiftedTriangularSolve:
    @pytest.mark.parametrize("m", [2, 40])   # substitution / LAPACK
    def test_matches_direct_solve(self, m):
        from sclmd_jax.ops.exact_gle import \
            _solve_shifted_triangular_batch

        rng = np.random.default_rng(3)
        n, nz = 37, 5
        T = np.triu(rng.normal(size=(n, n))
                    + 1j * rng.normal(size=(n, n)))
        zs = np.exp(1j * rng.uniform(0, 2 * np.pi, nz)) * 2.0
        Cs = rng.normal(size=(nz, n, m)) + 1j * rng.normal(
            size=(nz, n, m))
        Y = _solve_shifted_triangular_batch(T, zs, Cs, block=8)
        for i, z in enumerate(zs):
            want = np.linalg.solve(z * np.eye(n) - T, Cs[i])
            np.testing.assert_allclose(Y[i], want, rtol=1e-9,
                                       atol=1e-9)


class TestAntitheticRunAPI:
    """The packaged warm-start antithetic estimator
    (parallel.ensemble.antithetic_run — the composition behind the
    flagship crosscheck headline, promoted from scripts/ in round 4)
    must land on the exact attractor value within tight statistics."""

    @staticmethod
    def _build(nmd, seed=7, dt=0.25 / 0.658, nph=8,
               eta=1.0 / (50 / 0.658)):
        from sclmd_jax.md import md as MDRunner

        dyn = np.asarray(chain_dynmat(nph, 0.04))

        def build(Ta, Tb):
            import tempfile
            runner = MDRunner(dt, nmd, (Ta + Tb) / 2, dyn=dyn,
                              dtype=jnp.float64, seed=seed,
                              outdir=tempfile.mkdtemp(prefix="anti_"))
            runner.AddBath(B.ebath([0], Ta, dt, nmd, wmax=1.0,
                                   efric=np.eye(1) * eta,
                                   dtype=jnp.float64))
            runner.AddBath(B.ebath([nph - 1], Tb, dt, nmd, wmax=1.0,
                                   efric=np.eye(1) * eta,
                                   dtype=jnp.float64))
            return runner

        return build

    def test_warm_estimator_hits_exact_value(self):
        from sclmd_jax.parallel.ensemble import (_noisy_system,
                                                 antithetic_run)

        nmd = 2 ** 12
        T, delta = 300.0, 0.5
        TL, TR = T * (1 + delta / 2), T * (1 - delta / 2)
        build = self._build(nmd)

        # exact expectation of BOTH directions (the chain is mirror-
        # symmetric but the theory is cheap — no symmetry assumption)
        th_f = attractor_expected_currents(_noisy_system(build(TL, TR)))
        th_r = attractor_expected_currents(_noisy_system(build(TR, TL)))
        j_exact = ((th_f[0] - th_f[1]) / 2 - (th_r[0] - th_r[1]) / 2) / 2

        ntraj = 16
        j = antithetic_run(build, TL, TR, ntraj, warm_start=True,
                           seed=7)
        assert j.shape == (ntraj,)
        sem = j.std() / np.sqrt(ntraj)
        assert abs(j.mean() - j_exact) < 4 * max(sem, 1e-12), (
            j.mean(), j_exact, sem)
        # the composition must also be usably TIGHT. Relative SEM
        # shrinks with system size and run length: this quantum
        # 8-DOF/2^12 tier measures ~14% (the zero-point noise scale
        # dwarfs the DeltaT signal on a tiny chain); the production
        # tightness — 1.6% at 32 pairs x 2^14 on the 2412-DOF
        # flagship — is measured by bench.crosscheck
        assert sem < 0.25 * abs(j_exact), (sem, j_exact)

    def test_chunked_equals_unchunked_bitwise(self):
        from sclmd_jax.parallel.ensemble import antithetic_run

        nmd = 2 ** 9
        TL, TR = 330.0, 270.0
        build = self._build(nmd, seed=3)
        j_full = antithetic_run(build, TL, TR, 6, warm_start=True,
                                seed=3)
        j_chunk = antithetic_run(build, TL, TR, 6, warm_start=True,
                                 seed=3, chunk=2)
        # the noise draws are bitwise identical across chunkings; the
        # periodic-point SVD lstsq solves a different RHS block width,
        # so equality holds to solver roundoff, not bitwise
        np.testing.assert_allclose(j_full, j_chunk, rtol=1e-9,
                                   atol=1e-18)

    def test_cold_path_runs(self, tmp_path):
        from sclmd_jax.parallel.ensemble import antithetic_run

        nmd = 2 ** 9
        build = self._build(nmd, seed=5)
        j = antithetic_run(build, 330.0, 270.0, 4, warm_start=False)
        assert j.shape == (4,)
        assert np.isfinite(j).all()


class TestHarmonicTwinDelta:
    """parallel.ensemble.harmonic_twin_delta — the control-variate
    estimator for the anharmonic correction (same noise keys + warm
    start shared by both twins)."""

    def _builders(self, nmd, kappa3=0.0, seed=9, dt=0.25 / 0.658,
                  nph=8, eta=1.0 / (50 / 0.658), k=0.04):
        import tempfile
        from types import SimpleNamespace

        from sclmd_jax.md import md as MDRunner

        dyn = np.asarray(chain_dynmat(nph, k))
        dyn_j = jnp.asarray(dyn)

        def base(Ta, Tb):
            runner = MDRunner(dt, nmd, (Ta + Tb) / 2, dyn=dyn,
                              dtype=jnp.float64, seed=seed,
                              outdir=tempfile.mkdtemp(prefix="twin_"))
            runner.AddBath(B.ebath([0], Ta, dt, nmd, wmax=1.0,
                                   efric=np.eye(1) * eta,
                                   dtype=jnp.float64))
            runner.AddBath(B.ebath([nph - 1], Tb, dt, nmd, wmax=1.0,
                                   efric=np.eye(1) * eta,
                                   dtype=jnp.float64))
            return runner

        def force(q):
            # harmonic + optional weak cubic on-site anharmonicity
            return -(dyn_j @ q) - kappa3 * q ** 3

        def build_anh(Ta, Tb):
            r = base(Ta, Tb)
            r.AddPotential(SimpleNamespace(force=force))
            return r

        return base, build_anh

    def test_zero_anharmonicity_gives_zero_delta(self):
        """A twin whose 'anharmonic' driver IS the harmonic force must
        produce exactly cancelled trajectories — the sharpest possible
        pin that noise keys, warm start and windows are shared."""
        from sclmd_jax.parallel.ensemble import harmonic_twin_delta

        build_harm, build_anh = self._builders(2 ** 9, kappa3=0.0)
        d = harmonic_twin_delta(build_harm, build_anh, 330.0, 270.0,
                                4, seed=3)
        np.testing.assert_allclose(d, 0.0, atol=1e-14)

    def test_weak_anharmonicity_pairing_reduces_variance(self):
        """With a weak quartic term the twins must stay CORRELATED
        over the window (that correlation is the whole estimator), so
        subtracting the twin reduces the per-pair spread below the raw
        anharmonic antithetic estimator's. The correction itself is
        not asserted here — on an 8-DOF chain it sits below its own
        chaos noise at test scale; the flagship-scale measurement is
        bench.crosscheck's job (anh_* fields)."""
        from sclmd_jax.parallel.ensemble import harmonic_twin_delta

        nmd = 2 ** 10
        TL, TR = 345.0, 255.0
        build_harm, build_anh = self._builders(nmd, kappa3=4e-4)
        ntraj = 16
        d, j_anh, j_harm = harmonic_twin_delta(
            build_harm, build_anh, TL, TR, ntraj, seed=5,
            return_parts=True)
        assert np.isfinite(d).all()
        np.testing.assert_allclose(d, j_anh - j_harm, rtol=1e-12)
        # pairing quality (measured 0.65 / 0.76x at this seed+tier)
        corr = np.corrcoef(j_anh, j_harm)[0, 1]
        assert corr > 0.3, corr
        assert d.std() < 0.9 * j_anh.std(), (d.std(), j_anh.std())


class TestPerturbativeResponse:
    """parallel.ensemble.perturbative_anharmonic_response — jvp
    derivatives of the antithetic conductance current at lambda=0,
    along the stable harmonic attractor."""

    def test_derivatives_match_exact_theory_of_harmonic_family(self):
        """Choose the 'anharmonic' force to be a DIFFERENT harmonic
        matrix: J(lambda) is then the conductance of the harmonic
        system dyn(lambda) = (1-lambda) D + lambda D2, exactly
        computable at every lambda by attractor_expected_currents —
        the measured d1/d2 must match finite differences of the exact
        theory, pinning the jvp, warm-start and window machinery with
        zero modelling slack."""
        import tempfile
        from types import SimpleNamespace

        from sclmd_jax.md import md as MDRunner
        from sclmd_jax.parallel.ensemble import (
            _noisy_system, perturbative_anharmonic_response)

        nph, k, dt, nmd = 8, 0.04, 0.25 / 0.658, 2 ** 12
        eta = 1.0 / (50 / 0.658)
        TL, TR = 330.0, 270.0
        D = np.asarray(chain_dynmat(nph, k))
        # strong scattering perturbation: the middle spring weakened to
        # 0.2 k (a uniform stiffening leaves the ballistic transmission
        # ~1 and the conductance derivative unresolvably small)
        D2 = D.copy()
        i = nph // 2 - 1
        dk = 0.2 * k - k
        D2[i, i] += dk
        D2[i + 1, i + 1] += dk
        D2[i, i + 1] -= dk
        D2[i + 1, i] -= dk
        D2_j = jnp.asarray(D2)

        def mk_build(dyn, anh):
            def build(Ta, Tb):
                r = MDRunner(dt, nmd, (Ta + Tb) / 2, dyn=dyn,
                             dtype=jnp.float64, seed=7,
                             outdir=tempfile.mkdtemp(prefix="pr_"))
                r.AddBath(B.ebath([0], Ta, dt, nmd, wmax=1.0,
                                  efric=np.eye(1) * eta,
                                  dtype=jnp.float64))
                r.AddBath(B.ebath([nph - 1], Tb, dt, nmd, wmax=1.0,
                                  efric=np.eye(1) * eta,
                                  dtype=jnp.float64))
                if anh:
                    r.AddPotential(SimpleNamespace(
                        force=lambda q: -(D2_j @ q)))
                return r
            return build

        ntraj = 64
        j0, d1, d2 = perturbative_anharmonic_response(
            mk_build(D, False), mk_build(D, True), TL, TR, ntraj,
            seed=7)

        def j_exact(lam):
            dl = (1 - lam) * D + lam * D2
            b = mk_build(dl, False)
            th_f = attractor_expected_currents(_noisy_system(b(TL, TR)))
            th_r = attractor_expected_currents(_noisy_system(b(TR, TL)))
            return ((th_f[0] - th_f[1]) / 2
                    - (th_r[0] - th_r[1]) / 2) / 2

        # J(lambda) curves sharply (the h=0.05 FD is 26% off on d1);
        # h -> 0 converges by h=0.004 in f64
        h = 0.004
        jm, j00, jp = j_exact(-h), j_exact(0.0), j_exact(h)
        d1_ex = (jp - jm) / (2 * h)
        d2_ex = (jp - 2 * j00 + jm) / h ** 2

        n = len(j0)
        for name, est, ref in (("j0", j0, j00), ("d1", d1, d1_ex),
                               ("d2", d2, d2_ex)):
            sem = est.std() / np.sqrt(n)
            tol = 4 * sem + 0.02 * abs(ref)
            assert abs(est.mean() - ref) < tol, (
                name, est.mean(), ref, sem)
        # the match must be a RESOLVED statement, not
        # consistent-with-anything: the exact first derivative exceeds
        # the estimator noise (measured 0.6 sigma deviation at 6+ sigma
        # signal on this tier)
        assert abs(d1_ex) > 4 * d1.std() / np.sqrt(n), (
            d1_ex, d1.std() / np.sqrt(n))


class TestAttractorCovariance:
    def test_matches_warm_md_ensemble(self, key):
        """attractor_covariance == the position covariance the
        warm-started MD ensemble actually samples (time-averaged over
        one full period), within correlated-MC statistics. Per-mode
        variances are strongly NON-equipartitioned at coarse tiers
        (mode resonance width << comb spacing), so this also pins the
        comb structure, not just the trace."""
        from sclmd_jax.md import (gle_step_jacobian, period_power,
                                  periodic_fixed_point, state_ravel,
                                  state_unravel)
        from sclmd_jax.ops.exact_gle import attractor_covariance

        nmd = 2 ** 10
        system, _, _ = _chain(nmd, 345.0, 255.0)
        C = attractor_covariance(system)

        sysq = system.replace(saveq=True)
        A = gle_step_jacobian(system)
        AP = period_power(A, nmd)
        nens = 32
        keys = jax.random.split(key, (nens, 2))
        accs = []
        for ks in keys:
            sysb = sysq.replace(baths=tuple(
                b.gnoi(k).replace(nevecs=None, nstd=None)
                for b, k in zip(sysq.baths, ks)))
            fin1, _ = run_segment(
                sysb, initial_state(sysb, dtype=jnp.float64), nmd)
            x0 = periodic_fixed_point(A, state_ravel(fin1), nmd,
                                      power=AP)
            _, ys = run_segment(
                sysb, state_unravel(x0, sysb, dtype=jnp.float64), nmd)
            qs = np.asarray(ys["qs"])
            accs.append(qs.T @ qs / qs.shape[0])
        accs = np.stack(accs)
        Ce, sem = accs.mean(0), accs.std(0) / np.sqrt(nens)
        # per-entry z-scores (weakly damped modes leave ~1 effective
        # sample per realization, so entries fluctuate but must
        # straddle the theory)
        z = np.abs(C - Ce) / np.maximum(sem, 1e-12)
        assert z.max() < 5.0, z.max()
        tr_sem = accs.sum(axis=(1, 2)).std() / np.sqrt(nens)
        assert abs(np.trace(C) - np.trace(Ce)) < 4 * tr_sem, (
            np.trace(C), np.trace(Ce), tr_sem)


class TestSCPRenormalization:
    """The headline anharmonic estimator (ops.anharmonic +
    attractor_covariance + exact evals) against the independently
    pinned MC response estimator: for a PURE quartic perturbation the
    static Hartree loop Sigma = 3 kappa3 diag<q_i^2>_NESS is the
    COMPLETE first-order self-energy, so the theory-side conductance
    derivative dJ/dD : dD_hartree must equal E[d2_taylor]/2 within MC
    error.

    Tier notes (measured while constructing the test): at weak
    friction (50 fs damp) the mode linewidth ~ comb spacing at
    nmd=2^10 and J(D) wiggles on the dD scale — the finite difference
    never converges; 5 fs damping makes the resonances span ~8 comb
    lines and J(D + s dD) is smooth (derivative stable to <1% for
    s in [1e-3, 0.1]). The derivative MUST be one-sided (+s only):
    the Hartree dD (~0.01 eV^2 on the softest sites) exceeds the
    softest chain mode's stiffness (w_min^2 ~ 0.005 eV^2), so D - s dD
    goes unstable and the attractor formulas return garbage there."""

    def test_scp_equals_response_on_quartic_chain(self):
        import tempfile
        from types import SimpleNamespace

        from sclmd_jax.md import md as MDRunner
        from sclmd_jax.ops.anharmonic import smeared_hessian
        from sclmd_jax.ops.exact_gle import attractor_covariance
        from sclmd_jax.parallel.ensemble import (
            _noisy_system, perturbative_anharmonic_response)

        nph, k, dt, nmd = 8, 0.04, 0.25 / 0.658, 2 ** 10
        eta = 1.0 / (5 / 0.658)   # comb-resolved: width >> spacing
        kappa3 = 4e-4
        TL, TR = 345.0, 255.0
        dyn = np.asarray(chain_dynmat(nph, k))
        dyn_j = jnp.asarray(dyn)

        def base(Ta, Tb):
            r = MDRunner(dt, nmd, (Ta + Tb) / 2, dyn=dyn,
                         dtype=jnp.float64, seed=9,
                         outdir=tempfile.mkdtemp(prefix="scp_"))
            r.AddBath(B.ebath([0], Ta, dt, nmd, wmax=1.0,
                              efric=np.eye(1) * eta,
                              dtype=jnp.float64))
            r.AddBath(B.ebath([nph - 1], Tb, dt, nmd, wmax=1.0,
                              efric=np.eye(1) * eta,
                              dtype=jnp.float64))
            return r

        def build_anh(Ta, Tb):
            r = base(Ta, Tb)
            r.AddPotential(SimpleNamespace(
                force=lambda q: -(dyn_j @ q) - kappa3 * q ** 3))
            return r

        def quartic_force(q):
            return -(dyn_j @ q) - kappa3 * q ** 3

        def dj_dir(Ta, Tb, h=0.05):
            sys0 = _noisy_system(base(Ta, Tb))
            C = attractor_covariance(sys0)
            # MC smearing against the analytic Hartree loop
            res = smeared_hessian(quartic_force, nph, dyn,
                                  (Ta + Tb) / 2, npairs=96, seed=4,
                                  cov_ff=C)
            dD = 3 * kappa3 * np.diag(np.diag(C))
            np.testing.assert_allclose(
                np.diag(res["dD"]), np.diag(dD),
                atol=5 * 3 * kappa3 * np.diag(C).max()
                * np.sqrt(2.0 / 96))

            def j(s):
                th = attractor_expected_currents(
                    sys0.replace(dyn=jnp.asarray(dyn + s * dD)))
                return (th[0] - th[1]) / 2

            # one-sided Richardson derivative (see class docstring)
            return (4 * j(h) - 3 * j(0.0) - j(2 * h)) / (2 * h)

        dk_scp = (dj_dir(TL, TR) - dj_dir(TR, TL)) / 2

        ntraj = 96
        _, d1t, d2t = perturbative_anharmonic_response(
            base, build_anh, TL, TR, ntraj, seed=5, family="taylor")
        sem = d2t.std() / 2 / np.sqrt(ntraj)
        # resolved statement: the response must see a nonzero
        # correction, and the static Hartree theory must reproduce it
        # (measured at this tier: dk_scp -1.507e-5 vs d2/2
        # -1.50e-5 +- 0.16e-5 at ntraj=256 — 0.5% agreement)
        assert abs(d2t.mean() / 2) > 4 * sem, (d2t.mean() / 2, sem)
        assert abs(dk_scp - d2t.mean() / 2) < max(
            3 * sem, 0.05 * abs(d2t.mean() / 2)), (
            dk_scp, d2t.mean() / 2, sem)


class TestPerturbativeFamilies:
    """The two interpolation families must agree where both are valid:
    for a PURE quartic perturbation F_anh = -Dq - k3 q^3 the taylor
    family runs J(lam^2 k3) and the force family J(lam k3), so
    d2_taylor / 2 == d1_force; and d1_taylor is a Gaussian-parity null
    (odd moments of the harmonic ensemble vanish)."""

    @pytest.mark.slow
    def test_taylor_family_consistency_on_quartic_chain(self):
        # slow tier (r5, 58 s): redundant consistency between the two
        # interpolation families; the production taylor path stays
        # fast-pinned by test_scp_equals_response_on_quartic_chain and
        # test_fd2_matches_nested_jvp_on_quartic_chain.
        import tempfile
        from types import SimpleNamespace

        from sclmd_jax.md import md as MDRunner
        from sclmd_jax.parallel.ensemble import \
            perturbative_anharmonic_response

        nph, k, dt, nmd = 8, 0.04, 0.25 / 0.658, 2 ** 11
        eta = 1.0 / (50 / 0.658)
        kappa3 = 4e-4
        TL, TR = 345.0, 255.0
        dyn = np.asarray(chain_dynmat(nph, k))
        dyn_j = jnp.asarray(dyn)

        def base(Ta, Tb):
            r = MDRunner(dt, nmd, (Ta + Tb) / 2, dyn=dyn,
                         dtype=jnp.float64, seed=9,
                         outdir=tempfile.mkdtemp(prefix="fam_"))
            r.AddBath(B.ebath([0], Ta, dt, nmd, wmax=1.0,
                              efric=np.eye(1) * eta,
                              dtype=jnp.float64))
            r.AddBath(B.ebath([nph - 1], Tb, dt, nmd, wmax=1.0,
                              efric=np.eye(1) * eta,
                              dtype=jnp.float64))
            return r

        def build_anh(Ta, Tb):
            r = base(Ta, Tb)
            r.AddPotential(SimpleNamespace(
                force=lambda q: -(dyn_j @ q) - kappa3 * q ** 3))
            return r

        ntraj = 16
        j0f, d1f, d2f = perturbative_anharmonic_response(
            base, build_anh, TL, TR, ntraj, seed=5, family="force")
        j0t, d1t, d2t = perturbative_anharmonic_response(
            base, build_anh, TL, TR, ntraj, seed=5, family="taylor")
        # identical lambda=0 primals
        np.testing.assert_allclose(j0t, j0f, rtol=1e-9)
        # d1_taylor: parity null — zero up to estimator noise, tiny
        # vs the physical response scale
        sem1t = d1t.std() / np.sqrt(ntraj)
        assert abs(d1t.mean()) < max(4 * sem1t, 1e-3 * abs(
            d1f.mean())), (d1t.mean(), sem1t)
        # family chain rule: J_t(lam) = J_f(lam^2)
        # -> d2_t / 2 == d1_f, per trajectory (same noise keys)
        np.testing.assert_allclose(d2t / 2, d1f, rtol=5e-3,
                                   atol=1e-12)
        # poly family (straight line in the quartic normal form): for
        # a pure polynomial perturbation the normal form IS the
        # perturbation, so J_p(lam) == J_f(lam) exactly — identical
        # responses through a completely different force path (jets
        # vs direct evaluation)
        j0p, d1p, d2p = perturbative_anharmonic_response(
            base, build_anh, TL, TR, ntraj, seed=5, family="poly")
        np.testing.assert_allclose(j0p, j0f, rtol=1e-9)
        np.testing.assert_allclose(d1p, d1f, rtol=1e-7, atol=1e-14)
        np.testing.assert_allclose(d2p, d2f, rtol=1e-6, atol=1e-12)

    def test_fd2_matches_nested_jvp_on_quartic_chain(self):
        """The fd2 (one-sided FD second order) path — which needs only
        the single-tangent jvp program — reproduces the nested-jvp d2
        with O(fd2) bias and identical (j0, d1)."""
        import tempfile
        from types import SimpleNamespace

        from sclmd_jax.md import md as MDRunner
        from sclmd_jax.parallel.ensemble import \
            perturbative_anharmonic_response

        nph, k, dt, nmd = 8, 0.04, 0.25 / 0.658, 2 ** 11
        eta = 1.0 / (50 / 0.658)
        kappa3 = 4e-4
        TL, TR = 345.0, 255.0
        dyn = np.asarray(chain_dynmat(nph, k))
        dyn_j = jnp.asarray(dyn)

        def base(Ta, Tb):
            r = MDRunner(dt, nmd, (Ta + Tb) / 2, dyn=dyn,
                         dtype=jnp.float64, seed=9,
                         outdir=tempfile.mkdtemp(prefix="fd2_"))
            r.AddBath(B.ebath([0], Ta, dt, nmd, wmax=1.0,
                              efric=np.eye(1) * eta,
                              dtype=jnp.float64))
            r.AddBath(B.ebath([nph - 1], Tb, dt, nmd, wmax=1.0,
                              efric=np.eye(1) * eta,
                              dtype=jnp.float64))
            return r

        def build_anh(Ta, Tb):
            r = base(Ta, Tb)
            r.AddPotential(SimpleNamespace(
                force=lambda q: -(dyn_j @ q) - kappa3 * q ** 3))
            return r

        ntraj = 8
        j0n, d1n, d2n = perturbative_anharmonic_response(
            base, build_anh, TL, TR, ntraj, seed=5, family="taylor")
        scale = np.abs(d2n).max()
        errs = {}
        for s in (0.1, 0.05):
            j0s, d1s, d2s = perturbative_anharmonic_response(
                base, build_anh, TL, TR, ntraj, seed=5,
                family="taylor", fd2=s)
            # first-order pieces are the same jvp program either way
            np.testing.assert_allclose(j0s, j0n, rtol=1e-9)
            np.testing.assert_allclose(d1s, d1n, rtol=1e-7,
                                       atol=1e-12 * scale)
            errs[s] = np.abs(d2s - d2n).max() / scale
        # measured curve (this fixture): 0.129 @ s=0.1, 0.030 @ 0.05,
        # 0.0073 @ 0.025 — O(s^2), because the taylor family's odd
        # lam-derivatives vanish by Gaussian parity, so the one-sided
        # difference is secretly a centered one
        assert errs[0.1] < 0.2, errs
        assert errs[0.05] < 0.05, errs
        assert errs[0.05] < 0.5 * errs[0.1], errs
        # fd2="auto" sizes the FD step from the measured attractor
        # jets (basin guard for the flagship's near-resonant soft-mode
        # response); same jvp first-order pieces, d2 within the
        # fixed-step envelope (auto never picks a LARGER step than
        # the 0.05 cap)
        j0a, d1a, d2a = perturbative_anharmonic_response(
            base, build_anh, TL, TR, ntraj, seed=5,
            family="taylor", fd2="auto")
        np.testing.assert_allclose(j0a, j0n, rtol=1e-9)
        np.testing.assert_allclose(d1a, d1n, rtol=1e-7,
                                   atol=1e-12 * scale)
        assert np.abs(d2a - d2n).max() / scale < 0.05
        # order=1 (gate + d1-null mode, the flagship production
        # setting): identical j0/d1 — they are exactly independent of
        # the skipped x*'' pieces — and d2 = NaN placeholder
        j01, d11, d21 = perturbative_anharmonic_response(
            base, build_anh, TL, TR, ntraj, seed=5,
            family="taylor", order=1)
        np.testing.assert_allclose(j01, j0n, rtol=1e-9)
        np.testing.assert_allclose(d11, d1n, rtol=1e-7,
                                   atol=1e-12 * scale)
        assert np.isnan(d21).all()


class TestExpectedCurrentsSlow:
    @pytest.mark.slow
    def test_matches_landauer_at_fine_grid(self):
        """At a fine noise grid the exact discrete expectation lands on
        the continuum Landauer integral (comb bias < 2%) — closing the
        theory <-> NEGF side deterministically, no Monte Carlo."""
        nmd = 2 ** 15
        T, delta = 300.0, 0.5
        TL, TR = T * (1 + delta / 2), T * (1 - delta / 2)
        system, dyn, eta = _chain(nmd, TL, TR)
        theory = attractor_expected_currents(system)
        j_th = (theory[0] - theory[1]) / 2
        j_negf = negf_current_natural(dyn, eta, [0], [7], TL, TR,
                                      nw=4000)
        dev = (j_th - j_negf) / j_negf
        print(f"\nexact-discrete vs Landauer: {dev * 100:+.3f}%")
        assert abs(dev) < 0.02, (j_th, j_negf, dev)
