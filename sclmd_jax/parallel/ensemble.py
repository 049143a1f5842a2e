"""Ensemble data-parallelism and multi-chip sharding.

The reference runs independent trajectories sequentially
(/root/reference/sclmd/md.py:506 — the nstart..nstop loop). Here the
ensemble axis is a ``vmap`` batch: every trajectory carries its own
colored-noise series (independent PRNG keys), and the whole batch is one
XLA program. On a device mesh, trajectories shard over the ``dp`` axis
and the per-bath matrices (friction / memory-kernel) can shard over a
``tp`` axis — XLA inserts the collectives.

This is the device answer to "no parallelism in the reference"
(SURVEY.md section 2): DP = vmapped trajectories; TP = sharded bath
matmuls; the memory-kernel (sequence-like) axis stays on-chip as the
scan carry.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sclmd_jax.md import GLESystem, MDState, initial_state, run_segment, \
    run_segment_blocked, thermal_init


def _noisy_system(runner):
    """The runner's hot system with every bath carrying PSD factors
    (prepare_noise) so ensemble_noise samples on device."""
    system = runner._build_system()
    return system.replace(baths=tuple(
        b if getattr(b, "nstd", None) is not None else b.prepare_noise()
        for b in runner.baths))


def antithetic_run(build, TL, TR, ntraj: int, nsteps: Optional[int] = None,
                   seed: Optional[int] = None, warm_start: bool = True,
                   equil_frac: float = 0.25, block: Optional[int] = None,
                   pair=(0, 1), chunk: Optional[int] = None,
                   steady_init: bool = False):
    """Antithetic common-random-numbers conductance estimator — the
    composition that produces the flagship crosscheck headline,
    promoted from scripts/exp_crosscheck_flagship.py into the package.

    Replaces the reference's entire Run -> kappa -> calTC validation
    workflow (ref md.py:493-682 sequential ensemble + tools.py:166-215
    kappa aggregation) with a variance-cancelled two-sided estimator:

    * ``build(Ta, Tb) -> md`` constructs a fresh runner whose baths sit
      at lead temperatures (Ta, Tb) — everything else identical.
    * The forward (TL, TR) and reversed (TR, TL) ensembles draw their
      colored noise from the SAME per-trajectory keys: the Gaussian
      draws are identical and only the PSD temperature scaling differs,
      so zero-point-scale fluctuations cancel in (J_fwd - J_rev)/2 down
      to the DeltaT signal (pinned at tests/test_crosscheck.py).
    * ``warm_start=True`` (harmonic systems): each trajectory runs ONE
      zero-init noise period, the exact periodic point x* of its own
      noise realisation is solved on host from the one-step Jacobian
      (md.gle_step_jacobian — temperature-independent, so one Jacobian
      + one binary period-power serves both directions), and the
      measured period starts AT x*. Zero initial-condition transient
      (the cold start's DeltaT-odd state-noise-correlation bias,
      measured +7.9% at nmd=2^13 on the flagship), so the FULL period
      is averaged with no equilibration discard; the expectation equals
      ops.exact_gle.attractor_expected_currents exactly.

    ``pair``: bath indices (hot, cold) whose current difference defines
    J = (cur_hot - cur_cold) / 2. ``chunk`` bounds resident
    trajectories (windows of the same key schedule: identical noise
    draws, results equal to the unchunked run to solver roundoff — the
    periodic-point lstsq sees a different RHS block width). ``seed``
    defaults to the built
    runner's own seed stream. Requires ``nsteps`` = the runner's nmd
    when warm-starting (the attractor period IS the noise period).

    Returns the per-trajectory-pair J estimates, shape (ntraj,):
    mean() is the conductance current, std()/sqrt(ntraj) its SEM.
    """
    from sclmd_jax.md import (_cur_reduce, gle_step_jacobian,
                              period_power, periodic_fixed_point,
                              state_ravel, state_unravel)

    runner_f = build(TL, TR)
    nsteps = nsteps or runner_f.nmd
    nb = len(runner_f.baths)
    if max(pair) >= nb:
        raise ValueError(f"pair={pair} out of range for {nb} baths")

    if not warm_start:
        # cold path: the plain RunEnsemble estimator (thermal init +
        # equilibration discard); CRN across directions comes from the
        # runners sharing one seed -> identical key schedules
        def one_direction(runner):
            means = runner.RunEnsemble(ntraj, nsteps=nsteps,
                                       equil_frac=equil_frac,
                                       block=block, chunk=chunk,
                                       steady_init=steady_init)
            return (means[:, pair[0]] - means[:, pair[1]]) / 2

        jf = one_direction(runner_f)
        jr = one_direction(build(TR, TL))
        return np.asarray(jf - jr) / 2

    if nsteps != runner_f.nmd:
        raise ValueError(
            f"warm_start needs nsteps == nmd (the attractor period is "
            f"the noise period); got nsteps={nsteps}, nmd="
            f"{runner_f.nmd}")

    # one-step Jacobian + A^P: temperature-independent (the affine
    # map's homogeneous part has no noise), shared by both directions
    A = gle_step_jacobian(runner_f._build_system())
    AP = period_power(A, nsteps)

    if seed is None:
        key = runner_f._next_key()
    else:
        key = jax.random.fold_in(jax.random.PRNGKey(seed), 99)

    block_eff = block if block is not None else runner_f.block
    if block_eff and nsteps % block_eff:
        block_eff = None
    chunk = int(chunk) if chunk else ntraj

    def run_dir(runner):
        system = runner._build_system()
        sys_f = _noisy_system(runner)
        dsum = np.zeros((ntraj,))
        for c0 in range(0, ntraj, chunk):
            c1 = min(c0 + chunk, ntraj)
            bsys = ensemble_noise(sys_f, key, ntraj, lo=c0, hi=c1)
            st0 = ensemble_states(bsys, ntraj, lo=c0, hi=c1)  # zeros
            fin1, _ = ensemble_run(bsys, st0, nsteps, t0=0,
                                   block=block_eff)
            x0 = periodic_fixed_point(A, state_ravel(fin1), nsteps,
                                      power=AP)
            stw = state_unravel(x0, system, dtype=runner.dtype)
            _, ys = ensemble_run(bsys, stw, nsteps, t0=0,
                                 block=block_eff)
            sums, ok = _cur_reduce(ys["cur"], 0)
            if not bool(np.asarray(ok)):
                raise FloatingPointError(
                    f"antithetic_run: non-finite currents in "
                    f"trajectories [{c0}:{c1}]")
            sums = np.asarray(sums) / nsteps
            dsum[c0:c1] = (sums[:, pair[0]] - sums[:, pair[1]]) / 2
        return dsum

    jf = run_dir(runner_f)
    jr = run_dir(build(TR, TL))
    return (jf - jr) / 2


def harmonic_twin_delta(build_harm, build_anh, TL, TR, ntraj: int,
                        nsteps: Optional[int] = None,
                        seed: Optional[int] = None,
                        equil_frac: float = 0.25,
                        block: Optional[int] = None, pair=(0, 1),
                        chunk: Optional[int] = None,
                        return_parts: bool = False):
    """Anharmonic correction to the conductance current by a
    HARMONIC-TWIN control variate (the VERDICT r3 headline item).

    The plain antithetic estimator decorrelates under anharmonicity —
    chaotic trajectories at swapped temperatures diverge, so the
    zero-point-scale fluctuations stop cancelling (measured SEM 145%
    at 32 flagship pairs, PERF.md). Here each anharmonic
    trajectory is paired with a harmonic twin driven by the IDENTICAL
    noise realisation from the IDENTICAL warm-started state: the
    shared colored-noise variance cancels in

        Delta_i = J_anh,i - J_harm,i            (same keys, same init)

    and the full estimate re-bases on the zero-Monte-Carlo theory,

        J_anh = mean_i (Delta_fwd,i - Delta_rev,i)/2 + J_exact,

    J_exact = ops.exact_gle.attractor_expected_currents of the
    harmonic system (whose window expectation the harmonic twin
    measures EXACTLY: on the periodic attractor the expected current
    is time-independent up to a (-1)^t Nyquist term that cancels over
    any even-length window). Only the anharmonic DELTA's own noise
    survives in the SEM.

    ``build_harm(Ta, Tb)`` / ``build_anh(Ta, Tb)``: runner factories
    that must differ ONLY in the attached potential (same baths, same
    dyn, same seed) — the harmonic one integrates -dyn q, the
    anharmonic one the full driver. Both runs start AT the harmonic
    periodic point of their own noise realisation; the anharmonic
    trajectory's relaxation from it is handled by the shared
    ``equil_frac`` discard (applied to BOTH sides of the pair, keeping
    the CRN pairing window-aligned).

    Returns the per-trajectory-pair deltas (ntraj,) in natural current
    units: mean() + J_exact estimates the anharmonic current; std()/
    sqrt(ntraj) is the SEM of the CORRECTION (and of the total, since
    J_exact is deterministic). ``return_parts=True`` also returns the
    per-pair antithetic currents (j_anh, j_harm) — j_anh.std() is the
    spread the plain (decorrelated) anharmonic estimator would have
    had, the control variate's own benchmark.
    """
    from sclmd_jax.md import (_cur_reduce, gle_step_jacobian,
                              period_power, periodic_fixed_point,
                              state_ravel, state_unravel)

    runner_h = build_harm(TL, TR)
    nsteps = nsteps or runner_h.nmd
    if nsteps != runner_h.nmd:
        raise ValueError("harmonic_twin_delta needs nsteps == nmd "
                         "(the warm start's period is the noise "
                         "period)")
    nb = len(runner_h.baths)
    skip = int(nsteps * equil_frac)
    if skip % 2:
        skip -= 1            # even window: the (-1)^t Nyquist term
    #                          of the attractor expectation cancels

    A = gle_step_jacobian(runner_h._build_system())
    AP = period_power(A, nsteps)
    if seed is None:
        key = runner_h._next_key()
    else:
        key = jax.random.fold_in(jax.random.PRNGKey(seed), 99)

    block_eff = block if block is not None else runner_h.block
    if block_eff and nsteps % block_eff:
        block_eff = None
    chunk = int(chunk) if chunk else ntraj

    def run_dir(Ta, Tb):
        rh = build_harm(Ta, Tb)
        ra = build_anh(Ta, Tb)
        sys_h = rh._build_system()
        sys_a = ra._build_system()
        if sys_a.force_fn is None:
            raise ValueError("build_anh attached no potential driver")
        sysf = _noisy_system(rh)
        j_a = np.zeros((ntraj,))
        j_h = np.zeros((ntraj,))
        for c0 in range(0, ntraj, chunk):
            c1 = min(c0 + chunk, ntraj)
            bsys_h = ensemble_noise(sysf, key, ntraj, lo=c0, hi=c1)
            st0 = ensemble_states(bsys_h, ntraj, lo=c0, hi=c1)
            fin1, _ = ensemble_run(bsys_h, st0, nsteps, t0=0,
                                   block=block_eff)
            x0 = periodic_fixed_point(A, state_ravel(fin1), nsteps,
                                      power=AP)
            stw = state_unravel(x0, sys_h, dtype=rh.dtype)
            # identical noise leaves feed both twins (force_fn is a
            # static field, so the sampled arrays are shared directly)
            bsys_a = sys_a.replace(baths=bsys_h.baths)
            _, ys_h = ensemble_run(bsys_h, stw, nsteps, t0=0,
                                   block=block_eff)
            _, ys_a = ensemble_run(bsys_a, stw, nsteps, t0=0,
                                   block=block_eff)
            sum_h, ok_h = _cur_reduce(ys_h["cur"], skip)
            sum_a, ok_a = _cur_reduce(ys_a["cur"], skip)
            if not (bool(np.asarray(ok_h)) and bool(np.asarray(ok_a))):
                raise FloatingPointError(
                    f"harmonic_twin_delta: non-finite currents in "
                    f"trajectories [{c0}:{c1}]")
            sa = np.asarray(sum_a) / (nsteps - skip)
            sh = np.asarray(sum_h) / (nsteps - skip)
            j_a[c0:c1] = (sa[:, pair[0]] - sa[:, pair[1]]) / 2
            j_h[c0:c1] = (sh[:, pair[0]] - sh[:, pair[1]]) / 2
        return j_a, j_h

    af, hf = run_dir(TL, TR)
    ar, hr = run_dir(TR, TL)
    j_anh = (af - ar) / 2
    j_harm = (hf - hr) / 2
    delta = j_anh - j_harm
    if return_parts:
        return delta, j_anh, j_harm
    return delta


# fd2="auto" basin control: each FD lam-step is capped so the
# warm-start displacement lam|x*'| + lam^2/2 |x*''| stays within
# _BASIN_FRAC of the attractor's own state scale (the polynomial
# family force diverges a few state-scales out — measured on the
# flagship, see perturbative_anharmonic_response docstring).
_BASIN_FRAC = 0.05
_FD2_CAP = 0.05


def perturbative_anharmonic_response(build_harm, build_anh, TL, TR,
                                     ntraj: int,
                                     nsteps: Optional[int] = None,
                                     seed: Optional[int] = None,
                                     equil_frac: float = 0.25,
                                     block: Optional[int] = None,
                                     pair=(0, 1),
                                     chunk: Optional[int] = None,
                                     family: str = "taylor",
                                     fd2: float = 0.0,
                                     order: int = 2,
                                     debug: bool = False):
    """Quantum anharmonic conductance correction by PERTURBATIVE
    RESPONSE along the harmonic attractor — the estimator that survives
    chaos.

    Direct anharmonic MD cannot measure the quantum correction: the
    per-pair antisymmetric-current spread of decorrelated chaotic
    trajectories is ~60x the DeltaT signal on the flagship (measured;
    ~6e5 pairs for a 2% SEM — see PERF.md), because every CRN
    pairing (antithetic, harmonic twin) loses its variance cancellation
    once trajectories diverge. This estimator never integrates the
    chaotic dynamics: with the family

        F(q; lam) = -D q + lam [F_anh(q) + D q],      lam in [0, 1],

    the currents J(lam) are differentiated AT lam = 0, where the primal
    trajectory is the (non-chaotic, warm-started) harmonic attractor
    and the jvp tangents obey driven-STABLE linear dynamics — no
    Lyapunov amplification, and the antithetic CRN cancellation works
    at full strength again. Forward-over-forward jvp through the
    compiled scan gives per-trajectory

        j0 = J(0)      (harmonic — must hit the exact attractor value),
        d1 = dJ/dlam,  d2 = d2J/dlam2   at lam = 0,

    so kappa_anh ~= kappa_exact + d1 + d2/2 with the measured |d2/2|
    vs |d1| controlling the series truncation at lam = 1. Validated
    against exact theory on a harmonic family (where J(lambda) has a
    closed form at every lambda) — tests/test_exact_gle.py.

    The warm start is differentiated along with the dynamics: starting
    every lambda at the lambda=0 periodic point would leak the
    ATTRACTOR's own lambda-motion into the window as a slowly-decaying
    tangent transient (measured: 35% bias on d1, ~100% on d2 at a
    2^11 chain tier). By the implicit function theorem on
    x*(lam) = Phi_lam(x*(lam)),

        x*'  = (I - A^P)^{-1} Phi_lam,
        x*'' = (I - A^P)^{-1} psi''(0),
        psi(lam) = Phi(x*_0 + lam x*', lam),

    where Phi_lam / psi'' are state tangents of one period run —
    measured runs then start at x*_0 + lam x*' + lam^2/2 x*'', the
    attractor tracked to second order, so the window expectation of
    (j0, d1, d2) is start-transient-free at ANY window.

    ``family`` picks the interpolation path lambda -> F(q; lam):

    * ``"taylor"`` (default, the physical estimator): the
      amplitude-scaling family V_lam(q) = V(lam q)/lam^2, whose force
      is F_lam = -D q + lam [L + Phi3](q) + lam^2 Phi4(q) with L the
      (roundoff-scale) Hessian mismatch and Phi3/Phi4 the cubic and
      quartic force terms, extracted per evaluation point by a
      third-order jvp jet of the driver force along q. At lam = 1 this
      is the potential's quartic normal form — textbook anharmonic
      perturbation theory, where corrections enter at O(Phi3^2, Phi4):
      E[d1] = 0 by Gaussian parity (a built-in null gate) and the
      physical correction is d2/2. Polynomial forcing keeps the
      response finite at any amplitude.
    * ``"poly"``: straight line in the quartic normal form,
      F_lam = -D q + lam [L + Phi3 + Phi4](q) — same jets, same
      lam=1 endpoint, but every anharmonic order enters at the SAME
      lam order. With D = D_eff (the SCP Hessian) this is the
      Hartree-NEUTRAL path: the smeared Hessian along it is
      lam-independent by SCP self-consistency, the attractor barely
      moves with lam, and (d1, d2) measure only the beyond-Hartree
      (self-consistency residual + Phi3^2 vertex) physics. Measured
      on the flagship around D_eff: the taylor path's J(lam)
      curvature is ~1e6 x the signal because the destabilizing
      linear mismatch g1 = dD q arrives at order lam while the
      compensating quartic confinement arrives at lam^2 — use
      "poly" there. (The one-sided fd2 difference loses the
      odd-parity cancellation on this family: truncation O(fd2),
      still negligible at auto-sized steps.)
    * ``"force"``: the naive straight-line family
      F_lam = -Dq + lam (F_anh + Dq). DIVERGES on stiff many-body
      potentials (measured: d2 ~ 1e7 x the signal on the flagship —
      harmonic excursions of soft flexural modes extrapolate into the
      Morse/Tersoff exponential walls); kept for small-perturbation
      validation and as the documented failure mode.

    ``fd2 > 0`` replaces every NESTED (second-order) jvp by a one-sided
    finite difference of the first-order jvp at lam = 0 and lam = fd2:
    d2 ~= (d1(fd2) - d1(0)) / fd2, and likewise for the attractor's
    psi''(0). It needs only the single-tangent jvp-through-scan
    program, whose compile and memory cost on the 201-atom flagship at
    nmd=2^14 is far below the nested jvp-of-jvp's; both lam points reuse
    ONE compiled executable (lam enters as the traced ``force_params``
    leaf), so total scan work is unchanged (~11 scan-units/chunk either
    way). One-sided (+fd2) because negative lam flips the cubic force
    (same instability class as the SCP dD derivative). The truncation
    bias is O(fd2^2), not O(fd2) — the taylor family's odd
    lam-derivatives vanish by Gaussian parity — measured 3% of
    max|d2| at fd2=0.05, 0.7% at 0.025 on the quartic chain, pinned
    against the nested-jvp path in tests/test_exact_gle.py.

    ``fd2="auto"`` sizes each FD step from the measured attractor
    jets instead: the finite-lam PRIMAL starts at x0 + lam x*'
    (+ lam^2/2 x*'' for the measurement run) and integrates the
    polynomial family force, whose stability basin is only a few
    multiples of the attractor's own scale. When the attractor
    lam-derivatives are large (flagship around D_eff: |x*'| ~ 70x and
    |x*''| ~ 1e5x the state scale — the soft modes respond
    near-resonantly to the Hartree dD), a fixed fd2=0.01 start
    displacement of ~5x scale diverges (measured: NaN in 1/4
    trajectories while every attractor-tangent stage stays finite).
    "auto" caps lam |x*'| and lam^2/2 |x*''| at 5% of max|x0| per
    chunk (and at 0.05 absolute); the common-noise/common-executable
    FD difference keeps the stochastic part cancelling exactly at any
    step size, so shrinking fd2 costs only roundoff amplification.

    Same build contract as ``harmonic_twin_delta``. Returns (j0, d1,
    d2) arrays of shape (ntraj,), all antithetic-paired over (TL,TR)/
    (TR,TL) with shared keys.

    ``order=1`` skips every second-order piece and returns d2 = NaN:
    j0 and d1 at lam=0 are exactly independent of x*''. Use on
    systems where the order-2 lam-extrapolation does not exist — at a
    finite periodic comb the attractor response is rational in lam
    with a pole wherever a dD-shifted soft mode crosses a comb line;
    on the flagship around D_eff the pole forest has spacing ~1e-3
    in lam (measured: d1(lam) grows 7x over lam = 5e-4, d2/2 ~ 1e7 x
    the signal for both polynomial families), so the quotable
    anharmonic number comes from the static SCP continuum estimator
    and THIS estimator contributes the j0 gate plus the d1
    self-consistency null.
    """
    from sclmd_jax.md import (gle_step_jacobian, period_power,
                              periodic_fixed_point, state_ravel,
                              state_unravel)

    runner_h = build_harm(TL, TR)
    nsteps = nsteps or runner_h.nmd
    if nsteps != runner_h.nmd:
        raise ValueError("perturbative_anharmonic_response needs "
                         "nsteps == nmd")
    skip = int(nsteps * equil_frac)
    if skip % 2:
        skip -= 1

    A = gle_step_jacobian(runner_h._build_system())
    AP = period_power(A, nsteps)
    if seed is None:
        key = runner_h._next_key()
    else:
        key = jax.random.fold_in(jax.random.PRNGKey(seed), 99)

    block_eff = block if block is not None else runner_h.block
    if block_eff and nsteps % block_eff:
        block_eff = None
    chunk = int(chunk) if chunk else ntraj
    fd2_auto = isinstance(fd2, str)
    if fd2_auto and fd2 != "auto":
        raise ValueError(f"fd2 must be a float or 'auto', got {fd2!r}")
    if order not in (1, 2):
        raise ValueError(f"order must be 1 or 2, got {order}")

    def _dbg(name, arr):
        # stage-by-stage finiteness probe (debug=True): NaN anywhere
        # upstream poisons even the lam=0 primal through st_at's
        # 0 * NaN, so the final finite-check cannot localize failures
        if not debug:
            return
        a = np.asarray(arr, np.float64)
        fin = np.isfinite(a)
        mx = float(np.abs(a[fin]).max()) if fin.any() else float("nan")
        print(f"    [resp {name}] finite={bool(fin.all())} "
              f"bad={int((~fin).sum())}/{a.size} maxabs={mx:.3e}",
              flush=True)

    def run_dir(Ta, Tb):
        rh = build_harm(Ta, Tb)
        ra = build_anh(Ta, Tb)
        sys_h = rh._build_system()
        f_anh = ra._build_system().force_fn
        if f_anh is None:
            raise ValueError("build_anh attached no potential driver")
        dyn_j = sys_h.dyn

        if family == "force":
            def fam_force(q, lam):
                base = -(dyn_j @ q)
                return base + lam * (f_anh(q) - base)
        elif family in ("taylor", "poly"):
            def fam_force(q, lam):
                base = -(dyn_j @ q)

                # third-order jvp jet of e -> F_anh(e q) - (-D e q)
                # at e = 0: one nested pass yields g'(0) (Hessian
                # mismatch L q), g''(0)/2 (cubic force Phi3(q)) and
                # g'''(0)/6 (quartic force Phi4(q))
                def Fe(e):
                    return f_anh(e * q) - base * e

                def i1(e):
                    return jax.jvp(Fe, (e,), (1.0,))

                def i2(e):
                    return jax.jvp(i1, (e,), (1.0,))

                P, T = jax.jvp(i2, (0.0,), (1.0,))
                (_, g1), (_, g2) = P        # ((F0, g1), (g1, g2))
                (_, _g2b), (_, g3) = T      # ((g1, g2), (g2, g3))
                if family == "poly":
                    # straight line in the quartic normal form: every
                    # anharmonic order enters at the SAME lam order,
                    # so when dyn = D_eff the smeared (Hartree)
                    # Hessian is lam-INDEPENDENT by SCP
                    # self-consistency — D(lam) = D_eff + lam(<H> -
                    # D_eff) = D_eff — and the attractor barely moves
                    # with lam. The amplitude-scaling path below
                    # instead injects the destabilizing linear
                    # mismatch g1 = dD q at order lam but the
                    # compensating quartic confinement only at lam^2:
                    # measured on the flagship around D_eff, its
                    # J(lam) curvature is ~1e6 x the signal (d2/2 ~
                    # +1e7 % with |x*''| ~ 3.6e5 x the state scale) —
                    # a property of the PATH, not of the physics.
                    return base + lam * (g1 + 0.5 * g2 + g3 / 6.0)
                return (base + lam * (g1 + 0.5 * g2)
                        + (lam * lam / 6.0) * g3)
        else:
            raise ValueError(f"unknown family {family!r}")

        def sravel(st):
            b = st.p.shape[0]
            return jnp.concatenate(
                [st.p, st.q, st.phis.reshape(b, -1),
                 st.qhis.reshape(b, -1)], axis=-1)

        sysf = _noisy_system(rh)
        out = [np.zeros((ntraj,)) for _ in range(3)]
        for c0 in range(0, ntraj, chunk):
            c1 = min(c0 + chunk, ntraj)
            bsys = ensemble_noise(sysf, key, ntraj, lo=c0, hi=c1)
            st0 = ensemble_states(bsys, ntraj, lo=c0, hi=c1)
            fin1, _ = ensemble_run(bsys, st0, nsteps, t0=0,
                                   block=block_eff)
            _dbg("fin1 (zero-init harmonic period)", state_ravel(fin1))
            x0 = periodic_fixed_point(A, state_ravel(fin1), nsteps,
                                      power=AP)
            _dbg("x0 (periodic point)", x0)
            stw = state_unravel(x0, sys_h, dtype=rh.dtype)
            bfam = bsys.replace(force_fn=fam_force)
            dt_r = stw.p.dtype

            def st_at(lam, d1st, d2st):
                # attractor tracked to second order in lam
                def comb(a, b, c):
                    return a + lam * b + (lam * lam / 2) * c
                return stw.replace(
                    p=comb(stw.p, d1st.p, d2st.p),
                    q=comb(stw.q, d1st.q, d2st.q),
                    phis=comb(stw.phis, d1st.phis, d2st.phis),
                    qhis=comb(stw.qhis, d1st.qhis, d2st.qhis))

            zst = jax.tree_util.tree_map(jnp.zeros_like, stw)

            def period_final(lam, d1st, d2st):
                sysl = bfam.replace(
                    force_params=jnp.asarray(lam, dt_r))
                fin, _ = ensemble_run(sysl, st_at(lam, d1st, d2st),
                                      nsteps, t0=0, block=block_eff)
                return sravel(fin)

            # x*' = (I - A^P)^{-1} Phi_lam  (implicit function theorem)
            _, t1 = jax.jvp(lambda l: period_final(l, zst, zst),
                            (0.0,), (1.0,))
            t1 = np.asarray(t1, np.float64)
            _dbg("t1 (Phi_lam tangent)", t1)
            x1p = periodic_fixed_point(A, t1, nsteps, power=AP)
            _dbg("x1p (attractor d1)", x1p)
            dst1 = state_unravel(x1p, sys_h, dtype=dt_r)
            # lam-step for the FD pieces: the finite-lam PRIMAL starts
            # at x0 + lam x1p (+ lam^2/2 x2p below) and runs the
            # polynomial family force, whose stability basin is the
            # attractor's own scale — a start displacement a few times
            # max|x0| diverges (measured on the flagship: fd2=0.01
            # puts lam^2/2 |x2p| ~ 220 on a ~40-scale state -> NaN in
            # 1/4 trajectories while every attractor stage stays
            # finite). "auto" caps each FD step so the warm-start
            # displacement stays <= BASIN_FRAC of the state scale.
            scale = float(np.abs(np.asarray(x0, np.float64)).max())
            m1 = float(np.abs(x1p).max())
            if fd2_auto:
                fd2_psi = min(_FD2_CAP,
                              _BASIN_FRAC * scale / max(m1, 1e-300))
            else:
                fd2_psi = float(fd2)
            # x*'' from psi(lam) = Phi(x*_0 + lam x*', lam)
            if order == 1:
                # j0 and d1 at lam=0 are EXACTLY independent of x*''
                # (its start contribution enters as lam^2/2, tangent
                # as lam): skip the second-order pieces entirely.
                # Flagship use case: at a finite periodic comb the
                # attractor response is a rational function of lam
                # with a pole wherever a dD-shifted soft mode crosses
                # a comb line — with ||dD|| far above the soft-mode
                # stiffness the pole forest has spacing ~1e-3 in lam
                # (measured: d1(lam) grows 7x over lam = 5e-4,
                # |x*''| FD estimates GROW as the step shrinks, d2/2
                # ~ 1e7 x the signal for BOTH polynomial families),
                # so the order-2 extrapolation to lam=1 does not
                # exist at finite nmd. Order 1 still delivers the j0
                # gate (vs the exact attractor value) and the d1
                # SCP-self-consistency null.
                t2 = None
            elif fd2:
                def psi1(lam):
                    _, t = jax.jvp(
                        lambda m: period_final(m, dst1, zst),
                        (lam,), (1.0,))
                    t = np.asarray(t, np.float64)
                    _dbg(f"psi'({lam})", t)
                    return t

                t2 = (psi1(float(fd2_psi)) - psi1(0.0)) / float(fd2_psi)
            else:
                _, (_, t2) = jax.jvp(
                    lambda l: jax.jvp(
                        lambda m: period_final(m, dst1, zst), (l,),
                        (1.0,)),
                    (0.0,), (1.0,))
                t2 = np.asarray(t2, np.float64)
            if t2 is None:
                dst2 = zst
            else:
                x2p = periodic_fixed_point(A, t2, nsteps, power=AP)
                _dbg("x2p (attractor d2)", x2p)
                dst2 = state_unravel(x2p, sys_h, dtype=dt_r)
            if order == 1:
                fd2_run = 0.0
            elif fd2_auto:
                m2 = float(np.abs(np.asarray(x2p, np.float64)).max())
                fd2_run = min(fd2_psi, np.sqrt(
                    2 * _BASIN_FRAC * scale / max(m2, 1e-300)))
                print(f"    [resp fd2 auto] chunk [{c0}:{c1}] "
                      f"scale={scale:.3g} |x1p|={m1:.3g} |x2p|={m2:.3g}"
                      f" -> fd2_psi={fd2_psi:.3g} fd2_run={fd2_run:.3g}",
                      flush=True)
            else:
                fd2_run = float(fd2) if fd2 else 0.0

            def run_lam(lam):
                sysl = bfam.replace(
                    force_params=jnp.asarray(lam, dt_r))
                _, ys = ensemble_run(sysl, st_at(lam, dst1, dst2),
                                     nsteps, t0=0, block=block_eff)
                s = ys["cur"][:, skip:, :].sum(axis=1) \
                    / (nsteps - skip)
                return (s[:, pair[0]] - s[:, pair[1]]) / 2

            if order == 1:
                # single-tangent pass: j0 + the d1 null, d2 not
                # measured (NaN placeholder — see the pole-forest
                # note above)
                j0, d1a = jax.jvp(run_lam, (0.0,), (1.0,))
                _dbg("j0", j0)
                _dbg("d1(0)", d1a)
                d2 = np.full(np.asarray(d1a).shape, np.nan)
            elif fd2:
                # two single-tangent passes; d2 by one-sided FD of the
                # jvp-exact d1 (same noise keys at both lam points, so
                # the stochastic part cancels in the difference)
                j0, d1a = jax.jvp(run_lam, (0.0,), (1.0,))
                _dbg("j0", j0)
                _dbg("d1(0)", d1a)
                _, d1s = jax.jvp(run_lam, (float(fd2_run),), (1.0,))
                _dbg(f"d1({fd2_run})", d1s)
                d2 = (np.asarray(d1s, np.float64)
                      - np.asarray(d1a, np.float64)) / float(fd2_run)
            else:
                # one nested forward-over-forward pass: primal
                # (j0, d1), tangent (d1, d2)
                (j0, d1a), (_, d2) = jax.jvp(
                    lambda l: jax.jvp(run_lam, (l,), (1.0,)), (0.0,),
                    (1.0,))
            for k, (dst, val) in enumerate(zip(out, (j0, d1a, d2))):
                arr = np.asarray(val)
                if k < 3 - (order == 1) and not np.isfinite(arr).all():
                    raise FloatingPointError(
                        "perturbative_anharmonic_response: non-finite "
                        f"response in trajectories [{c0}:{c1}]")
                dst[c0:c1] = arr
        return out

    f = run_dir(TL, TR)
    r = run_dir(TR, TL)
    return tuple((a - b) / 2 for a, b in zip(f, r))


def make_mesh(axis_sizes: dict[str, int],
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a Mesh from {'dp': n, 'tp': m}-style axis sizes."""
    devices = devices if devices is not None else jax.devices()
    names = tuple(axis_sizes.keys())
    sizes = tuple(axis_sizes.values())
    n = int(np.prod(sizes))
    if n > len(devices):
        raise ValueError(f"mesh needs {n} devices, have {len(devices)}")
    dev = np.asarray(devices[:n]).reshape(sizes)
    return Mesh(dev, names)


def ensemble_noise(system: GLESystem, key: jax.Array, n: int,
                   lo: int = 0, hi: Optional[int] = None) -> GLESystem:
    """Attach independent noise series per bath (leading batch axis).

    ``lo``/``hi`` select a trajectory window of an ``n``-trajectory
    ensemble: the key schedule depends only on (key, bath, trajectory
    index), so a chunked ensemble synthesizing successive lo:hi windows
    gets bitwise the SAME noise as the full batch — memory-wall chunking
    (md.RunEnsemble) changes peak device memory, never the physics.

    Baths carrying PSD factors sample through the cached batched jit
    (identical statistics to per-key ``gnoi``, no per-call re-trace);
    factorless baths fall back to the vmapped all-jnp synthesis."""
    from sclmd_jax.ops.noise import sample_noise_dev_batch

    hi = n if hi is None else hi
    new_baths = []
    for i, b in enumerate(system.baths):
        bkeys = jax.random.fold_in(key, i)
        keys = jax.random.split(bkeys, n)[lo:hi]
        if getattr(b, "nstd", None) is not None:
            noise = sample_noise_dev_batch(b, keys)
        else:
            noise = jax.vmap(lambda k: b.gnoi(k).noise)(keys)
        # drop the (complex) PSD factors from the hot-loop pytree
        new_baths.append(b.replace(noise=noise, nevecs=None, nstd=None))
    return system.replace(baths=tuple(new_baths))


def ensemble_states(system: GLESystem, n: int, key=None, hw=None,
                    evecs=None, T=None, dtype=None,
                    lo: int = 0, hi: Optional[int] = None) -> MDState:
    """Batched initial states: zeros, or Bose-weighted thermal draws.

    ``lo``/``hi`` window an ``n``-trajectory ensemble (see
    ensemble_noise) — chunked draws match the full batch bitwise."""
    hi = n if hi is None else hi
    if key is None:
        st = initial_state(system, dtype=dtype)
        return jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(x, (hi - lo,) + x.shape), st)
    keys = jax.random.split(key, n)[lo:hi]
    return jax.vmap(lambda k: thermal_init(k, system, hw, evecs, T))(keys)


def estimate_traj_bytes(system: GLESystem, nsteps: int,
                        block: Optional[int] = None) -> int:
    """Rough per-trajectory peak device-memory estimate for one
    ensemble member.

    Counts the resident batched arrays (noise series, history rings,
    per-step outputs) plus the transient synthesis/stream copies, with a
    2x allocator-slack factor. Used by md.RunEnsemble's auto-chunking —
    the production answer to the reference workload's nmd=2e5 noise
    arrays (SURVEY.md "hard parts": noise must stream from HBM or be
    regenerated in chunks)."""
    item = int(np.dtype(system.mask.dtype).itemsize)
    nb = len(system.baths)
    total = 0
    for b in system.baths:
        nc = int(b.nc)
        # resident noise (nmd, nc) + one rolled stream copy (nsteps, nc)
        # + synthesis transient (complex half-spectrum ~= nmd * nc reals
        # x2 for the iFFT scratch)
        total += (system.nmd + nsteps + 2 * system.nmd) * nc * item
        if getattr(b, "ml", 1) > 1:
            # blocked-path history + FFT cross-correlation scratch
            total += (b.ml + (block or 64) + system.nmd // 8) * nc * item
    # state + plain-path history ring
    total += (system.ml + 4) * system.nph * item
    # per-step outputs (etot + per-bath currents)
    total += nsteps * (nb + 1) * item
    return 2 * total


# Budget on a device whose allocator reports no limit (the CPU backend).
HOST_BUDGET_BYTES = 8 * 2 ** 30
# Chunk cap, tuned on the earlier accelerator and not measured on the
# H100: bigger chunks only added risk there.
MAX_CHUNK = 512


def device_memory_budget(device=None) -> int:
    """Bytes an ensemble may fill on ``device`` (default: the first).

    Half of the allocator's ``bytes_limit`` from ``memory_stats()``:
    the other half is left to compiled-program scratch and to arrays
    that live beside the ensemble. A device that reports no limit gets
    ``HOST_BUDGET_BYTES``."""
    device = device if device is not None else jax.devices()[0]
    stats = device.memory_stats() or {}
    limit = stats.get("bytes_limit")
    return int(limit) // 2 if limit else HOST_BUDGET_BYTES


def auto_chunk(system: GLESystem, ntraj: int, nsteps: int,
               block: Optional[int] = None,
               budget_bytes: Optional[int] = None,
               depth: int = 1) -> int:
    """Largest trajectory-chunk size that fits the device-memory budget.

    Budget: ``device_memory_budget()`` unless ``budget_bytes`` is
    given. Chunks are additionally capped at ``MAX_CHUNK``.

    ``depth``: number of chunk footprints live at once — 2 when
    md.RunEnsemble pipelines (checkpoint=False: the executing chunk
    plus the one being enqueued); the budget is divided by it.
    """
    if budget_bytes is None:
        budget_bytes = device_memory_budget()
    budget_bytes //= max(1, int(depth))
    per = max(estimate_traj_bytes(system, nsteps, block), 1)
    chunk = max(1, min(budget_bytes // per, MAX_CHUNK))
    if chunk >= ntraj:
        return int(ntraj)          # whole ensemble fits: one chunk
    # otherwise align down to a power of two (divisor-friendly, and
    # keeps every chunk the same shape -> one compiled program)
    return 1 << (int(chunk).bit_length() - 1)


def _system_axes(system: GLESystem):
    """vmap in_axes spec: batch only the per-bath noise leaves."""
    axes = jax.tree_util.tree_map(lambda _: None, system)
    return axes.replace(baths=tuple(
        b.replace(noise=0) for b in axes.baths))


@partial(jax.jit, static_argnames=("nsteps", "t0", "block"))
def _ensemble_segment(system: GLESystem, states: MDState, nsteps: int,
                      t0: int, block: Optional[int]):
    if block is None:
        fn = partial(run_segment, nsteps=nsteps, t0=t0)
    else:
        fn = partial(run_segment_blocked, nsteps=nsteps, t0=t0,
                     block=block)
    return jax.vmap(fn, in_axes=(_system_axes(system), 0))(system, states)


def ensemble_run(system: GLESystem, states: MDState, nsteps: int,
                 t0: int = 0, block: Optional[int] = None):
    """Run nsteps of GLE MD for the whole batch (one compiled program).

    ``t0``: static segment offset (mod nmd) — must equal the trajectories'
    current step count, as in md.run_segment.
    ``block``: use the blocked-convolution integrator
    (md.run_segment_blocked) with this block size — the fast path for
    long memory kernels; the kernel FFT is shared across the batch.

    The segment is a module-level jit (static nsteps/t0/block), so
    repeated calls with the same system STRUCTURE hit the trace cache
    instead of re-tracing the vmapped integrator.
    """
    return _ensemble_segment(system, states, nsteps, t0, block)


def bath_factor_triples(baths):
    """Host factor triples (ev_re, ev_im, std) per bath, with the
    zero-stride proportional-spectrum broadcast collapsed to its single
    (nc, nc) matrix (sample_noise_dev's dispatch rule)."""
    facs = []
    for b in baths:
        if getattr(b, "nstd", None) is None:
            raise ValueError("bath carries no PSD factors: call "
                             "prepare_noise() first")
        ev = np.asarray(b.nevecs)
        std = np.asarray(b.nstd)
        if ev.ndim == 3 and ev.strides[0] == 0:
            ev = np.ascontiguousarray(ev[0])
        facs.append((np.ascontiguousarray(ev.real),
                     np.ascontiguousarray(ev.imag), std))
    return tuple(facs)


@partial(jax.jit, static_argnames=("nsteps", "t0", "block", "skiplo"))
def _fused_chunk(hot: GLESystem, facs, nkeys, ikeys, hw, evecs, T_init,
                 nsteps: int, t0: int, block: Optional[int],
                 skiplo: int):
    """Noise synthesis + initial states + segment run + current
    reduction for one trajectory chunk as ONE compiled program.

    The unfused path costs ~8-10 dispatches per chunk (per-bath key
    folds/splits, per-bath batched samplers, the init broadcast, the
    segment, the reduce).

    ``facs``: bath_factor_triples output (device-put once per
    ensemble — the full-spectrum factor batches are tens of MB).
    ``nkeys``: per-bath (chunk, 2) uint32 key windows, exactly
    ensemble_noise's schedule. ``ikeys``: (chunk, 2) thermal-init key
    window (ensemble_states' schedule) or None for zero init.
    Returns (final states, equilibration-skipped per-trajectory current
    sums, finite flag).
    """
    with jax.default_matmul_precision("highest"):   # see md.vv_step
        return _fused_chunk_body(hot, facs, nkeys, ikeys, hw, evecs,
                                 T_init, nsteps, t0, block, skiplo)


def _fused_chunk_body(hot, facs, nkeys, ikeys, hw, evecs, T_init,
                      nsteps, t0, block, skiplo):
    from sclmd_jax.ops.noise import sample_noise_parts, sample_noise_prop

    dt, nmd = hot.dt, hot.nmd
    baths = []
    for i, b in enumerate(hot.baths):
        evr, evi, std = facs[i]
        sampler = sample_noise_prop if evr.ndim == 2 \
            else sample_noise_parts
        nz = jax.vmap(lambda k: sampler(k, evr, evi, std, dt, nmd))(
            nkeys[i])
        baths.append(b.replace(noise=nz))
    sysb = hot.replace(baths=tuple(baths))
    if ikeys is None:
        st0 = initial_state(hot)
        chunk = nkeys[0].shape[0] if hot.baths else ikeys.shape[0]
        states = jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(x, (chunk,) + x.shape), st0)
    else:
        states = jax.vmap(lambda k: thermal_init(k, hot, hw, evecs,
                                                 T_init))(ikeys)
    if block is None:
        fn = partial(run_segment, nsteps=nsteps, t0=t0)
    else:
        fn = partial(run_segment_blocked, nsteps=nsteps, t0=t0,
                     block=block)
    finals, ys = jax.vmap(fn, in_axes=(_system_axes(sysb), 0))(sysb,
                                                               states)
    sums = ys["cur"][:, skiplo:, :].sum(axis=1)
    return finals, sums, jnp.isfinite(ys["cur"]).all()


@partial(jax.jit, static_argnames=("n",))
def _key_schedule(key, i: jax.Array, n: int):
    """ensemble_noise's per-bath key table, as one jit."""
    return jax.random.split(jax.random.fold_in(key, i), n)


@partial(jax.jit, static_argnames=("n",))
def _init_key_schedule(key, n: int):
    return jax.random.split(key, n)


@partial(jax.jit, static_argnames=("nb", "n"))
def _all_key_schedules(noise_key, init_key, nb: int, n: int):
    """All per-bath noise key tables + the thermal-init table in ONE
    program (one dispatch instead of nb + 1). Schedules are bitwise
    ensemble_noise's / ensemble_states'."""
    nk = jnp.stack([jax.random.split(jax.random.fold_in(noise_key, i),
                                     n) for i in range(nb)])
    return nk, jax.random.split(init_key, n)


def shard_ensemble(mesh: Mesh, system: GLESystem, states: MDState,
                   dp: str = "dp", tp: Optional[str] = None):
    """Place the batch on a mesh: trajectories over ``dp``; optionally
    shard each bath's friction/kernel matrices row-wise over ``tp``.
    """
    def put(x, spec):
        return jax.device_put(x, NamedSharding(mesh, spec))

    def put_tp(x, axis):
        # shard ``axis`` over tp where it divides evenly; replicate
        # otherwise (the 603-DOF flagship matrix on tp=2)
        spec = [None] * x.ndim
        if x.shape[axis] % mesh.shape[tp] == 0:
            spec[axis] = tp
        return put(x, P(*spec))

    states = jax.tree_util.tree_map(lambda x: put(x, P(dp)), states)
    new_baths = []
    for b in system.baths:
        b = b.replace(noise=put(b.noise, P(dp)))
        if tp is not None:
            if hasattr(b, "efric"):
                b = b.replace(efric=put_tp(b.efric, 0))
            if getattr(b, "kernel", None) is not None and \
                    not isinstance(getattr(type(b), "kernel", None),
                                   property):
                # row-shard the kernel's output-DOF axis (PhBath field;
                # EBath exposes kernel only as a derived property); the
                # matmul layout (kernel_im property) inherits the sharding
                b = b.replace(kernel=put_tp(b.kernel, 1))
        new_baths.append(b)
    system = system.replace(baths=tuple(new_baths))
    if system.dyn is not None and tp is not None:
        system = system.replace(dyn=put_tp(system.dyn, 0))
    return system, states


def sharded_ensemble_run(mesh: Mesh, system: GLESystem, states: MDState,
                         nsteps: int, t0: int = 0, dp: str = "dp",
                         tp: Optional[str] = None):
    """Shard, then run: the jitted batched scan partitions over the mesh.
    ``t0`` is the trajectories' current step offset (mod nmd) so the
    noise stream stays aligned across successive segments."""
    system, states = shard_ensemble(mesh, system, states, dp=dp, tp=tp)
    with jax.set_mesh(mesh):
        return ensemble_run(system, states, nsteps, t0=t0)


def sharded_synthesis_run(mesh: Mesh, system: GLESystem, states: MDState,
                          key: jax.Array, ntraj: int, nsteps: int,
                          t0: int = 0, block: Optional[int] = None,
                          dp: str = "dp", equil_frac: float = 0.25,
                          noise_window: Optional[int] = None,
                          return_noise_probe: bool = False):
    """DP-sharded ensemble with SHARD-LOCAL noise synthesis (the SP/CP
    row of the parallelism checklist, SURVEY.md:119).

    ``ensemble_noise`` + ``shard_ensemble`` materialise the full
    (ntraj, nmd, nc) noise batch on one device before scattering it —
    the axis that actually outgrows device memory. Here each device receives only its trajectories'
    PRNG keys through ``shard_map`` and synthesizes its own
    (ntraj/ndp, nmd, nc) slice from the (replicated, small) PSD
    factors: an n-device mesh holds n x the single-device ensemble with
    no cross-device noise traffic at all.

    ``noise_window=w`` additionally streams the TIME axis: trajectories
    advance window-by-window (an outer ``lax.scan``), each window
    regenerating rows [t, t+w] of the exact same series from the key
    via ``ops.noise.sample_noise_window`` — resident noise shrinks to
    (ntraj/ndp, w+1, nc), the answer for nmd ~ 2e5 workloads
    (ref rundp.py:43). Requires power-of-two nmd; results match the
    unwindowed run to float roundoff (the draws are identical).

    ``system``: baths must carry their PSD factors (``prepare_noise``),
    ``noise=None``. The key schedule matches ``ensemble_noise(key,
    ntraj)``, so results equal the unsharded path trajectory-for-
    trajectory. Returns (final states P(dp), per-trajectory
    equilibration-skipped current sums (ntraj, nbaths) P(dp)); with
    ``return_noise_probe`` also each bath's synthesized noise row 0
    (dryrun/test hook proving per-shard residency).
    """
    from sclmd_jax.ops.noise import (_batch_parts, _batch_prop,
                                     sample_noise_window)

    ndp = mesh.shape[dp]
    if ntraj % ndp:
        raise ValueError(f"ntraj={ntraj} not divisible by dp={ndp}")
    nb = len(system.baths)
    dt, nmd = float(system.dt), int(system.nmd)
    skip = int(nsteps * equil_frac)
    if noise_window is not None:
        if nsteps % noise_window:
            raise ValueError(f"nsteps={nsteps} not divisible by "
                             f"noise_window={noise_window}")
        if block is not None and noise_window % block:
            raise ValueError("noise_window must be a multiple of block")

    # host-side factor triples (replicated closure constants; the
    # frequency-proportional zero-stride broadcast collapses to one
    # (nc, nc) matrix — sample_noise_dev's dispatch rule)
    facs = []
    for b in system.baths:
        if b.nstd is None:
            raise ValueError("sharded_synthesis_run needs baths with PSD "
                             "factors (call prepare_noise())")
        ev = np.asarray(b.nevecs)
        std = np.asarray(b.nstd)
        if ev.ndim == 3 and ev.strides[0] == 0:
            ev = np.ascontiguousarray(ev[0])
        facs.append((np.ascontiguousarray(ev.real),
                     np.ascontiguousarray(ev.imag), std))
    hot = system.replace(baths=tuple(
        b.replace(nevecs=None, nstd=None) for b in system.baths))

    # ensemble_noise's key schedule (trajectory-index keyed)
    keys = tuple(jax.random.split(jax.random.fold_in(key, i), ntraj)
                 for i in range(nb))

    def synth_full(i, keys_l):
        evr, evi, std = facs[i]
        if evr.ndim == 2:
            return _batch_prop(keys_l, evr, evi, std, dt, nmd)
        return _batch_parts(keys_l, evr, evi, std, dt, nmd)

    def run_batch(sys_l, states_l, n, seg_t0):
        if block is None:
            fn = partial(run_segment, nsteps=n, t0=seg_t0)
        else:
            fn = partial(run_segment_blocked, nsteps=n, t0=seg_t0,
                         block=block)
        return jax.vmap(fn, in_axes=(_system_axes(sys_l), 0))(
            sys_l, states_l)

    def body(states_l, *keys_l):
        if noise_window is None:
            baths_l = tuple(hot.baths[i].replace(noise=synth_full(
                i, keys_l[i])) for i in range(nb))
            sys_l = hot.replace(baths=baths_l)
            finals, ys = run_batch(sys_l, states_l, nsteps, t0)
            csum = ys["cur"][:, skip:, :].sum(axis=1)
            if not return_noise_probe:
                return finals, csum
            return finals, csum, tuple(b.noise[:, t0 % nmd, :]
                                       for b in baths_l)

        win = noise_window
        nwin = nsteps // win
        ltraj = states_l.p.shape[0]

        def wbody(carry, w):
            st, acc = carry
            t0w = (jnp.asarray(t0, jnp.uint32)
                   + w.astype(jnp.uint32) * jnp.uint32(win))
            baths_w = []
            for i in range(nb):
                evr, evi, std = facs[i]
                nz = jax.vmap(lambda k: sample_noise_window(
                    k, evr, evi, std, dt, nmd, t0w, win + 1))(keys_l[i])
                baths_w.append(hot.baths[i].replace(noise=nz))
            # the window IS the noise array: in-window lookups run
            # t0=0 over a (win+1)-row series whose row j is global row
            # t0w + j (rows wrap mod the TRUE nmd inside the sampler)
            sys_w = hot.replace(baths=tuple(baths_w), nmd=win + 1)
            fin, ys = run_batch(sys_w, st, win, 0)
            g = w * win + jnp.arange(win)
            m = (g >= skip).astype(acc.dtype)
            acc = acc + (ys["cur"] * m[None, :, None]).sum(axis=1)
            return (fin, acc), None

        acc0 = jnp.zeros((ltraj, nb), states_l.p.dtype)
        (fin, acc), _ = jax.lax.scan(wbody, (states_l, acc0),
                                     jnp.arange(nwin))
        if not return_noise_probe:
            return fin, acc
        probe = tuple(
            jax.vmap(lambda k, i=i: sample_noise_window(
                k, facs[i][0], facs[i][1], facs[i][2], dt, nmd,
                jnp.uint32(t0), 1)[0])(keys_l[i])
            for i in range(nb))
        return (fin, acc, probe)

    sh = NamedSharding(mesh, P(dp))
    state_specs = jax.tree_util.tree_map(lambda _: P(dp), states)
    in_specs = (state_specs,) + tuple(P(dp) for _ in keys)
    out_specs = (state_specs, P(dp))
    if return_noise_probe:
        out_specs = out_specs + (tuple(P(dp) for _ in keys),)
    states = jax.tree_util.tree_map(lambda x: jax.device_put(x, sh),
                                    states)
    keys_d = tuple(jax.device_put(k, sh) for k in keys)
    f = jax.shard_map(body, mesh=mesh, in_specs=in_specs,
                      out_specs=out_specs, check_vma=False)
    out = jax.jit(f)(states, *keys_d)
    if return_noise_probe:
        return out[0], out[1], out[2]
    return out[0], out[1]
