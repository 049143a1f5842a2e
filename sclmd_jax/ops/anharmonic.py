"""Self-consistent-phonon (SCP) renormalized harmonic theory.

The production observable of the reference is ANHARMONIC MD vs
harmonic NEGF (ref examples/runmd.py:27 REBO forces vs
examples/runnegf.py:17-28). Direct quasiclassical MC cannot resolve
the quantum anharmonic correction on the flagship junction — measured
here and recorded in PERF.md: common-random-number pairings
(antithetic, harmonic twin) decorrelate by trajectory chaos within
~1k steps, and the jvp response estimator's second derivative carries
quartic zero-point-scale fluctuations with per-trajectory spread
~1e5 x the signal. What IS computable with tight, honest error bars
is the static (renormalization) part of the anharmonic self-energy:

    D_eff = < d^2 V / dq^2 >_{q ~ N(qbar, C0)},   E[F(qbar + z)] = 0

with C0 the QUANTUM (Bose + zero-point) mode covariance of the
harmonic attractor. The Gaussian-smeared Hessian captures, at first
order, the quartic Hartree loop (Phi4 : C0) exactly and — through the
mean-position shift ``qbar`` — the cubic tadpole
(Phi3 : D^-1 : Phi3 : C0); only the frequency-dependent (lifetime /
phonon-phonon scattering) part of the bubble is left out, which the
classical direct measurement bounds (PERF.md, "Physics results kept
from earlier rounds"). The renormalized conductance then comes
from the zero-Monte-Carlo exact attractor theory:

    delta_kappa = kappa_exact(D_eff) - kappa_exact(D)      (ops.exact_gle)

so the only stochastic element is the probe average of a SMOOTH local
quantity (the Hessian), whose SEM is controlled and measurable —
no trajectory chaos, no time-integrated quartic tails.

This estimator has no reference counterpart; it replaces the
reference's unquantified "MD vs NEGF agree" validation
(ref README.md:31-35) with a number carrying quantum error bars.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from sclmd_jax import units as U
from sclmd_jax.ops.functions import bose


def line_variance_1d(energy_fn, direction, T, s0=4.0,
                     smax_cap=4096.0, vmax_kt=14.0, npts=513):
    """Classical 1-D Boltzmann variance <s^2> along a mass-weighted
    direction of the FULL anharmonic potential (all other coordinates
    frozen at the expansion point).

        <s^2> = int s^2 e^{-V(s v)/kT} ds / int e^{-V(s v)/kT} ds

    This is the exact classical thermal variance of the (frozen-bath)
    1-D cut — the confinement measure for modes that the HARMONIC
    model does not confine: near-null and negative-curvature librations
    of a relaxed junction (the flagship structure.data Hessian carries
    ~6 modes with w^2 < 0 down to -(3.6 meV)^2 — saddle directions of
    the relaxed geometry whose true potential is a shallow anharmonic
    well). Classical is the right statistics here by construction:
    these directions satisfy hbar|w| << kT.

    The bracket [−smax, +smax] is grown adaptively (doubling from
    ``s0``) until the potential rises ``vmax_kt`` kT on BOTH sides;
    raises if the direction is unconfined within ``smax_cap`` (a truly
    free direction — e.g. a global translation — has no Boltzmann
    variance and must be excluded upstream).

    ``energy_fn`` must be jax-traceable over the relative-displacement
    vector (CHDriver/JaxDriver ``energy_fn`` contract); the grid is
    evaluated in one vmapped batch.
    """
    v = np.asarray(direction, np.float64)
    kt = U.KB * float(T)
    ef = jax.jit(jax.vmap(lambda s: energy_fn(s * jnp.asarray(v))))

    def rise(smax):
        e = np.asarray(ef(jnp.asarray([-smax, 0.0, smax])))
        return min(e[0] - e[1], e[2] - e[1])

    smax = float(s0)
    while rise(smax) < vmax_kt * kt:
        smax *= 2.0
        if smax > smax_cap:
            raise ValueError(
                f"direction unconfined: potential rises "
                f"{rise(smax / 2) / kt:.2f} kT at |s|={smax / 2:g} "
                f"(cap {smax_cap:g})")
    # shrink back: the doubling can overshoot into wall regions where
    # exp(-V/kT) underflows the quadrature's dynamic range
    while smax > s0 and rise(smax / 2) > vmax_kt * kt:
        smax /= 2.0
    s = np.linspace(-smax, smax, int(npts))
    V = np.asarray(ef(jnp.asarray(s)), np.float64)
    V = V - V.min()
    w = np.exp(-V / kt)
    z = np.trapezoid(w, s)
    if z <= 0 or not np.isfinite(z):
        raise FloatingPointError("Boltzmann quadrature underflow")
    return float(np.trapezoid(s * s * w, s) / z)


def soft_mode_confinement(energy_fn, dyn, T, free=None, wcut=1e-2,
                          progress=False, **line_kw):
    """Rank-nsoft stabilizing stiffness: the SCP-confined reference.

    Every mode of ``dyn`` (restricted to the ``free`` subspace) with
    |w| < ``wcut`` — including NEGATIVE-curvature saddle directions —
    gets the effective stiffness that makes its harmonic classical
    variance equal its TRUE anharmonic 1-D Boltzmann variance:

        w_eff^2 = kB T / <s^2>_1D,
        dD_conf = sum_soft (w_eff^2 - w^2) v v^T        (PSD by
                                                         construction
                                                         when the well
                                                         is tighter
                                                         than harmonic)

    D' = D + dD_conf is the physically-confined harmonic reference:
    its equilibrium covariance is finite and matches the true thermal
    spread along every soft direction, so (a) the SCP Hartree smearing
    measure mode_covariance(D'_ff, T) is well-defined, and (b) the
    warm-started periodic attractor of D' has sane amplitudes — the
    perturbative response families' force jets stay in the physical
    region (the UNconfined flagship attractor puts rms ~1e6 natural
    units on the saddle modes, poisoning any Taylor jet of the real
    potential there). The anharmonic estimators then measure the
    remaining correction RELATIVE to D', and
    kappa_exact(D') - kappa_exact(D) is a deterministic theory number
    (ops.exact_gle), so nothing is approximated away.

    Returns (dD_conf, info) with info per soft mode: (w_signed,
    var_1d, w_eff).
    """
    dyn = np.asarray(dyn, np.float64)
    nph = dyn.shape[0]
    if free is None:
        free = np.arange(nph)
    free = np.asarray(free, int)
    dff = dyn[np.ix_(free, free)]
    w2, V = np.linalg.eigh(0.5 * (dff + dff.T))
    kt = U.KB * float(T)
    soft = np.abs(w2) < wcut ** 2
    dD = np.zeros_like(dyn)
    info = []
    for i in np.where(soft)[0]:
        v = np.zeros(nph)
        v[free] = V[:, i]
        var = line_variance_1d(energy_fn, v, T, **line_kw)
        w_eff2 = kt / var
        dD += (w_eff2 - w2[i]) * np.outer(v, v)
        ws = float(np.sign(w2[i]) * np.sqrt(abs(w2[i])))
        info.append((ws, var, float(np.sqrt(w_eff2))))
        if progress:
            print(f"  confine w={ws:+.3e} -> var={var:.3e} "
                  f"w_eff={np.sqrt(w_eff2):.3e}", flush=True)
    return dD, info


def mode_covariance(dyn_ff, T, classical=False, zpmotion=True,
                    wmin=1e-4):
    """Per-mode displacement variance of the harmonic equilibrium
    attractor, in the reference's mass-weighted natural coordinates.

    quantum:   <q_k^2> = (n_B(w_k, T) + zp/2) / w_k   (md.py initialise
               convention: amplitude^2 = 2(n+1/2)/w with <cos^2> = 1/2)
    classical: <q_k^2> = kB T / w_k^2

    Modes with w < wmin (translations/rotations of an unconstrained
    block, numerically-zero modes) get zero variance — they are not
    thermally populated oscillators and their classical variance would
    diverge.

    Returns (V, var, w): eigenvectors (columns), per-mode variance,
    mode frequencies in eV.
    """
    dyn_ff = np.asarray(dyn_ff, np.float64)
    w2, V = np.linalg.eigh(0.5 * (dyn_ff + dyn_ff.T))
    w = np.sqrt(np.clip(w2, wmin ** 2, None))
    if classical:
        var = U.KB * float(T) / w ** 2
    else:
        var = (bose(w, float(T), xp=np) + (0.5 if zpmotion else 0.0)) / w
    var = np.where(w2 < wmin ** 2, 0.0, var)
    return V, var, w


class _HessianProbe:
    """Chunked forward-mode Hessian H(q) = -dF/dq with a PERSISTENT
    jitted HVP (JaxDriver.dynmat re-traces its hvp block on every
    call, which would dominate a 64-probe campaign)."""

    def __init__(self, force_fn: Callable, nph: int, chunk: int = 128,
                 dtype=np.float64):
        self.nph = nph
        self.chunk = min(chunk, nph)
        self.dtype = dtype

        def hvp_block(q, vs):
            return jax.vmap(
                lambda v: jax.jvp(force_fn, (q,), (v,))[1])(vs)

        self._hvp = jax.jit(hvp_block)
        eye = np.eye(nph, dtype=dtype)
        self._blocks = [eye[i:i + self.chunk]
                        for i in range(0, nph, self.chunk)]

    def __call__(self, q):
        q = np.asarray(q, self.dtype)
        cols = [np.asarray(self._hvp(q, b)) for b in self._blocks]
        h = -np.concatenate(cols, axis=0)
        return 0.5 * (h + h.T)


def smeared_hessian(force_fn: Callable, nph: int, dyn, T,
                    npairs: int = 32, seed: int = 0,
                    free: Optional[np.ndarray] = None,
                    classical: bool = False, zpmotion: bool = True,
                    center_iters: int = 2, chunk: int = 128,
                    scp_iters: int = 1, progress: bool = False,
                    cov_ff=None, shift_wmin: float = 5e-3):
    """Gaussian-smeared Hessian <H(qbar + z)>, z ~ N(0, C0(dyn_ff)).

    Parameters
    ----------
    force_fn : jax-traceable q -> relative force (the MD driver's
        ``force_jax``; its linearization at 0 is -dyn).
    dyn : (nph, nph) harmonic dynamical matrix in eV^2 — defines both
        the probe covariance and the baseline that delta_D refers to.
    free : indices of unconstrained DOF. Probes and the center shift
        live in this subspace; fixed DOF are never displaced, and
        delta_D rows/columns outside it are zeroed (the MD constraint
        mask pins them anyway).
    npairs : number of ANTITHETIC probe pairs (+z, -z). Pairing makes
        the estimator exact through odd orders: each pair mean is
        H + (1/2) Phi4 : z z^T + O(z^4), so the cubic term never
        contributes sampling noise.
    center_iters : Newton iterations for the smeared stationary point
        E[F(qbar + z)] = 0 (captures the cubic tadpole).
    scp_iters : 1 = one-shot (probe covariance from ``dyn``);
        >1 re-derives C0 from the renormalized D_eff and re-probes —
        the self-consistent-phonon fixed point. Ignored when
        ``cov_ff`` is given (the covariance is then held fixed).
    cov_ff : optional explicit probe covariance on the free subspace —
        pass ops.exact_gle.attractor_covariance output to smear with
        the EXACT distribution the warm harmonic MD ensemble samples
        (comb + friction included). Without it the isolated-mode
        continuum formula is used, which diverges as kT/w^2 on
        ultra-soft junction modes (measured 14 Angstrom excursions on
        the flagship's ~5e-4 eV libration modes — use the attractor
        covariance for anything but stiff test systems).
    shift_wmin : the center-shift Newton inverts ``dyn`` only on modes
        with w >= shift_wmin (eV). Along flatter directions a shift
        does not change curvature at leading order, while the inverse
        would amplify probe noise by 1/w^2 (measured |qbar| ~ 1e7 on
        the flagship before regularising).

    Returns a dict:
      dD        full (nph, nph) renormalization <H> - H(0)
      dD_halves (dD_A, dD_B) from even/odd probe pairs — feed both
                through the downstream observable for an honest
                probe-SEM on ANY derived scalar
      qbar      smeared stationary point (full-size vector)
      h0_gate   ||H(0) - dyn||_F / ||dyn||_F — consistency of the
                supplied dyn with the driver's own Hessian
      var_modes, w_modes, meta
    """
    dyn = np.asarray(dyn, np.float64)
    if free is None:
        free = np.arange(nph)
    free = np.asarray(free, int)

    probe = _HessianProbe(force_fn, nph, chunk=chunk)
    h0 = probe(np.zeros(nph))
    h0_gate = float(np.linalg.norm(h0 - dyn) / np.linalg.norm(dyn))

    force_np = jax.jit(force_fn)
    rng = np.random.default_rng(seed)
    base_ff = dyn[np.ix_(free, free)]
    d_ff = base_ff.copy()
    result = None

    # regularised Newton: pseudo-inverse of dyn_ff restricted to modes
    # stiffer than shift_wmin
    wb2, Vb = np.linalg.eigh(0.5 * (base_ff + base_ff.T))
    stiff = wb2 >= shift_wmin ** 2
    pinv_ff = (Vb[:, stiff] / wb2[stiff]) @ Vb[:, stiff].T

    if scp_iters > 1 and cov_ff is not None:
        scp_iters = 1

    for scp_it in range(max(1, scp_iters)):
        if cov_ff is not None:
            lam, V = np.linalg.eigh(
                0.5 * (np.asarray(cov_ff, np.float64)
                       + np.asarray(cov_ff, np.float64).T))
            var = np.clip(lam, 0.0, None)
            w = None
        else:
            V, var, w = mode_covariance(d_ff, T, classical=classical,
                                        zpmotion=zpmotion)
        # probes in the free subspace, embedded with zeros elsewhere
        xi = rng.standard_normal((npairs, len(var)))
        z_ff = xi * np.sqrt(var) @ V.T          # (npairs, nfree)
        z = np.zeros((npairs, nph))
        z[:, free] = z_ff

        # smeared stationary point: Newton with the harmonic Hessian
        qbar = np.zeros(nph)
        for _ in range(center_iters):
            f = np.zeros(nph)
            for zm in z:
                f += np.asarray(force_np(jnp.asarray(qbar + zm)))
                f += np.asarray(force_np(jnp.asarray(qbar - zm)))
            f /= 2 * npairs
            qbar[free] += pinv_ff @ f[free]

        # antithetic pair means of the displaced Hessian
        pair_means = []
        for m, zm in enumerate(z):
            hp = probe(qbar + zm)
            hm = probe(qbar - zm)
            pair_means.append(0.5 * (hp + hm))
            if progress:
                print(f"  scp[{scp_it}] probe pair {m + 1}/{npairs}",
                      flush=True)
        pm = np.stack(pair_means)
        h_mean = pm.mean(axis=0)

        dD = h_mean - h0
        mask = np.zeros(nph, bool)
        mask[free] = True
        dD[~mask, :] = 0.0
        dD[:, ~mask] = 0.0

        def _half(sel):
            d = pm[sel].mean(axis=0) - h0
            d[~mask, :] = 0.0
            d[:, ~mask] = 0.0
            return d

        result = {
            "dD": dD,
            "dD_halves": (_half(slice(0, None, 2)),
                          _half(slice(1, None, 2))),
            "qbar": qbar,
            "h0_gate": h0_gate,
            "var_modes": var,
            "w_modes": w if w is not None else np.array([]),
            "meta": {"npairs": npairs, "seed": seed, "T": float(T),
                     "classical": classical, "zpmotion": zpmotion,
                     "scp_iters": scp_iters, "scp_it": scp_it,
                     "center_iters": center_iters,
                     "cov": "attractor" if cov_ff is not None
                            else "continuum-mode",
                     "shift_wmin": shift_wmin},
        }
        d_ff = base_ff + dD[np.ix_(free, free)]
    return result


def scp_effective_dynmat(force_fn, nph, dyn, T, **kw):
    """dyn + smeared_hessian(...)["dD"] — the renormalized dynamical
    matrix to feed ops.exact_gle / negf for the quantum anharmonic
    conductance."""
    res = smeared_hessian(force_fn, nph, dyn, T, **kw)
    return np.asarray(dyn, np.float64) + res["dD"], res
