"""GLE molecular dynamics engine in JAX.

The reference's velocity-Verlet loop (/root/reference/sclmd/md.py:367-411)
becomes a pure step function scanned by ``jax.lax.scan``: the whole
nmd-step trajectory — potential forces, memory-kernel bath friction,
colored-noise lookup, heat currents — is one compiled XLA program with
zero host round-trips. History rings ride in the scan carry; per-step
observables come out as scan outputs.

Layering:

* ``MDState`` / ``GLESystem`` + ``vv_step`` / ``run_segment`` — the
  functional core (jit/vmap/shard_map-able).
* ``md`` — an orchestration class mirroring the reference's user API
  (``AddBath``/``AddPotential``/``AddConstr``/``Run``/``SaveTraj``/...)
  including npz checkpoint/resume with the reference's MD{j} semantics
  (md.py:493-682).

Step structure (exactly the reference's 3-bath-eval / 2-potential-eval
scheme, md.py:367-435):

    push (q, p) onto the history rings
    f0  = V'(q) + sum_b bforce_b(t, phis, qhis)
    p_half = p + f0 dt/2 ;  q' = q + p dt + f0 dt^2/2
    cur_b  = f_b . p                       (heat current, md.py:395-398)
    f1  = V'(q') + sum_b bforce_b(t+1, push(phis,p_half), push(qhis,q'))
    p1  = p_half + f1 dt/2
    f2  = V'(q') + sum_b bforce_b(t+1, push(phis,p1),     push(qhis,q'))
    p'  = p_half + f2 dt/2
    constrain p', q'

V'(q') is evaluated once and shared between f1/f2 — the reference gets
the same effect from its ``sameq`` force cache (md.py:437-474).
"""

from __future__ import annotations

import os
from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from sclmd_jax.utils import pytree as struct

from sclmd_jax import units as U
from sclmd_jax.baths import bforce
from sclmd_jax.ops.functions import bose, powerspecp, rpadleft


# ---------------------------------------------------------------------------
# Functional core
# ---------------------------------------------------------------------------
@struct.dataclass
class MDState:
    t: jax.Array        # int32 global step counter
    p: jax.Array        # (nph,) velocity (mass-weighted natural units)
    q: jax.Array        # (nph,) displacement
    phis: jax.Array     # (ml, nph) newest-first velocity history ring
    qhis: jax.Array     # (1, nph) newest displacement (only row 0 is ever
    #                     read: the ebath bias terms, baths.py:246-248 —
    #                     carrying a full (ml, nph) ring would be pure
    #                     copy traffic)


@struct.dataclass
class GLESystem:
    """Everything the step function needs, as one pytree."""

    dyn: Optional[jax.Array]          # (nph, nph) dynamical matrix or None
    baths: tuple                      # tuple of EBath / PhBath
    mask: jax.Array                   # (nph,) 1.0 = free, 0.0 = constrained
    dt: float = struct.field(pytree_node=False)
    nph: int = struct.field(pytree_node=False)
    ml: int = struct.field(pytree_node=False)
    nmd: int = struct.field(pytree_node=False)
    force_fn: Optional[Callable] = struct.field(pytree_node=False,
                                                default=None)
    # STATIC promise that ``mask`` is identically 1 (no constrained
    # DOFs). Enables the blocked integrator's force carry-forward: the
    # predictor force at q_{t+1} equals the last corrector force at
    # q_tt (they are the same point when no mask is applied), so each
    # step needs ONE fresh potential evaluation instead of two — 2x on
    # force-dominated (many-body potential) workloads. Ignored by the
    # reference-shaped plain path.
    unconstrained: bool = struct.field(pytree_node=False, default=False)
    savep: bool = struct.field(pytree_node=False, default=False)
    saveq: bool = struct.field(pytree_node=False, default=False)
    savef: bool = struct.field(pytree_node=False, default=False)
    cf_fn: Optional[Callable] = struct.field(pytree_node=False, default=None)
    # optional TRACED parameters for force_fn (a pytree LEAF, unlike the
    # static force_fn itself): lets differentiable knobs — e.g. the
    # anharmonicity-strength lambda of the perturbative-response
    # estimator — ride through jit/vmap/jvp without retracing
    force_params: Optional[jax.Array] = None

    def potential_force(self, q: jax.Array) -> jax.Array:
        """Potential force: JAX driver if attached, else harmonic -D q
        (md.py:437-474)."""
        if self.force_fn is not None:
            if self.force_params is not None:
                return self.force_fn(q, self.force_params)
            return self.force_fn(q)
        if self.dyn is not None:
            return -(self.dyn @ q)
        raise ValueError("no driver, no md")


def initial_state(system: GLESystem, dtype=None) -> MDState:
    nph, ml = system.nph, system.ml
    dtype = dtype or (system.dyn.dtype if system.dyn is not None
                      else jnp.float32)
    z = jnp.zeros((nph,), dtype)
    return MDState(t=jnp.asarray(0, jnp.int32), p=z, q=z,
                   phis=jnp.zeros((ml, nph), dtype),
                   qhis=jnp.zeros((1, nph), dtype))


def thermal_init(key: jax.Array, system: GLESystem, hw: jax.Array,
                 evecs: jax.Array, T,
                 freq_cut: float = 0.01) -> MDState:
    """Bose-weighted random initial conditions from the normal modes.

    Mirrors md.initialise (md.py:294-338): each mode with frequency
    hw_i >= freq_cut gets amplitude sqrt(2 (n_B(hw_i,T) + 1/2)/hw_i) and a
    uniform random phase; constrained DOFs are zeroed.

    ``T`` may be a scalar (the reference's uniform-temperature start)
    or a per-mode array (nm,) — see ``steady_mode_temps``.
    """
    nm = hw.shape[0]
    r = jax.random.uniform(key, (nm,), dtype=hw.dtype)
    safe_hw = jnp.where(hw < freq_cut, 1.0, hw)
    am = jnp.where(hw < freq_cut, 0.0,
                   jnp.sqrt((bose(safe_hw, T) + 0.5) * 2.0 / safe_hw))
    with jax.default_matmul_precision("highest"):   # see vv_step
        dis = evecs @ (am * jnp.cos(2 * jnp.pi * r))
        vel = -evecs @ (hw * am * jnp.sin(2 * jnp.pi * r))
    dis = dis * system.mask
    vel = vel * system.mask
    st = initial_state(system, dtype=hw.dtype)
    return st.replace(p=vel, q=dis)


def steady_mode_temps(evecs, baths, T, hw=None):
    """Coupling-weighted steady-state temperature per normal mode.

    A quasi-ballistic mode's stationary occupation is set by the baths
    it touches: T_i = sum_b g_bi T_b / sum_b g_bi, with secular
    (weak-coupling) rate weights g_bi = s_b(hw_i) * sum_{d in b}
    U[d, i]^2 — s_b is the bath's mean diagonal friction strength
    (EBath.efric; PhBath's Gamma(w) diagonal interpolated at the mode
    frequency when ``hw`` is given). Modes with negligible total
    coupling keep the global ``T``: they relax at a negligible rate AND
    exert a negligible bath force, so their start temperature cannot
    bias the measured currents.

    Host-side numpy by design (setup invariant). Used by
    md.RunEnsemble(steady_init=True) to start trajectories on the
    nonequilibrium steady profile instead of the reference's uniform-T
    initialise (ref md.py:294-338): from a uniform start every
    intermediate-damping mode relaxes from T to T_i across the
    averaging window — a transient that is ODD in DeltaT, so the
    antithetic estimator adds rather than cancels it (measured +7.9%
    on the flagship harmonic crosscheck at nmd=2^13, falling ~1/T_run;
    scripts/exp_xcheck_dw.py).
    """
    U_ = np.asarray(evecs, np.float64)
    nm = U_.shape[1]
    temps = [float(b.T) for b in baths]
    if temps and all(t == temps[0] for t in temps):
        # equal bath temperatures: the steady profile IS uniform —
        # return the exact temperature so steady_init reproduces the
        # reference-shaped start BITWISE (the weighted average below
        # would differ by ~1 ulp and amplify through the integration)
        return np.full(nm, temps[0])
    num = np.zeros(nm)
    den = np.zeros(nm)
    for b in baths:
        proj = (U_[np.asarray(b.cids), :] ** 2).sum(axis=0)
        if getattr(b, "efric", None) is not None:
            g = float(np.mean(np.diag(np.asarray(b.efric)))) * proj
        elif getattr(b, "gamma", None) is not None:
            gam = np.asarray(b.gamma, np.float64)
            gwl = np.asarray(b.gwl, np.float64)
            sdiag = np.einsum("wii->w", gam) / gam.shape[1]
            if hw is None:
                g = float(sdiag.mean()) * proj
            else:
                w = np.clip(np.abs(np.asarray(hw, np.float64)),
                            gwl[0], gwl[-1])
                g = np.interp(w, gwl, sdiag) * proj
        else:
            g = proj
        num += g * float(b.T)
        den += g
    tol = 1e-8 * max(float(den.max()), 1e-300)
    safe = np.where(den > tol, den, 1.0)
    return np.where(den > tol, num / safe, float(T))


def state_ravel(st: "MDState") -> np.ndarray:
    """Flatten (p, q, phis, qhis) to one host vector (batch-aware:
    leading axes before the state axes are preserved)."""
    p = np.asarray(st.p)
    lead = p.shape[:-1]
    return np.concatenate(
        [p, np.asarray(st.q)]
        + [np.asarray(st.phis).reshape(lead + (-1,)),
           np.asarray(st.qhis).reshape(lead + (-1,))], axis=-1)


def state_unravel(x, system: GLESystem, dtype=None) -> "MDState":
    """Inverse of state_ravel; ``x`` may carry leading batch axes."""
    nph, ml = system.nph, system.ml
    x = np.asarray(x)
    lead = x.shape[:-1]
    dtype = dtype or (system.dyn.dtype if system.dyn is not None
                      else jnp.float32)
    p = x[..., :nph]
    q = x[..., nph:2 * nph]
    phis = x[..., 2 * nph:2 * nph + ml * nph].reshape(
        lead + (ml, nph))
    qhis = x[..., 2 * nph + ml * nph:].reshape(lead + (1, nph))
    t = jnp.zeros(lead, jnp.int32) if lead else jnp.asarray(0, jnp.int32)
    return MDState(t=t, p=jnp.asarray(p, dtype), q=jnp.asarray(q, dtype),
                   phis=jnp.asarray(phis, dtype),
                   qhis=jnp.asarray(qhis, dtype))


def gle_step_jacobian(system: GLESystem) -> np.ndarray:
    """Host-f64 one-step Jacobian A of the GLE map at zero noise,
    state flattened as [p, q, phis, qhis] (state_ravel order).

    For a harmonic system the velocity-Verlet step (vv_step) is exactly
    affine, x_{t+1} = A x_t + (noise terms), so A fully characterizes
    the homogeneous dynamics — including the mask constraint and the
    Markovian/memory bath friction. Thin wrapper over
    ops.exact_gle.linearize_step (one shared implementation of the
    host-f64 jacfwd machinery). Used by ``periodic_fixed_point``.
    """
    from sclmd_jax.ops.exact_gle import linearize_step

    return linearize_step(system)[0]


def period_power(A, nperiod: int) -> np.ndarray:
    """A^nperiod by binary powering (host f64; log2(nperiod) matmuls).
    Precompute once and pass to periodic_fixed_point(power=...) when
    solving several batches/directions of the same system."""
    A = np.asarray(A, np.float64)
    power = np.eye(A.shape[0])
    base = A
    k = int(nperiod)
    while k:
        if k & 1:
            power = power @ base
        k >>= 1
        if k:
            base = base @ base
    return power


def periodic_fixed_point(A, x1, nperiod: int, tol: float = 1e-8,
                         power=None):
    """Initial state(s) ON the discrete periodic attractor.

    A GLE trajectory driven by noise of period P steps follows
    x((k+1)P) = A^P x(kP) + c, where c equals the end-of-period state
    of a zero-initialized run (the map is affine). The unique periodic
    point is x* = (I - A^P)^{-1} c; directions where I - A^P is
    near-singular (undamped modes whose frequency is near-commensurate
    with the period — modes that also exert no bath force) are dropped
    instead of amplified.

    Starting AT x* removes the initial-condition transient exactly:
    from a cold start every mode must otherwise build its steady
    state-noise correlation over 1/gamma_i, a DeltaT-odd bias on
    antithetic conductance estimates measured at +7.9% (nmd=2^13) on
    the flagship crosscheck and falling only like 1/T_run
    (scripts/exp_xcheck_{dt,dw,steady}.py). On the attractor the
    expected current is time-independent, so ANY averaging window is
    unbiased.

    ``x1``: (n,) or (batch, n) zero-init end-of-period states
    (state_ravel). ``power``: optional precomputed A^P (reuse across
    directions/batches). Returns host-f64 array shaped like ``x1``.

    Numerics: A is DEFECTIVE (the history-ring shift contributes Jordan
    blocks), so the eigenbasis route amplifies roundoff by cond(V) —
    instead A^P is formed by binary powering (log2 P matmuls) and
    (I - A^P) x* = c solved by SVD least squares, whose minimum-norm
    solution drops the near-singular directions at ``tol``.
    """
    A = np.asarray(A, np.float64)
    n = A.shape[0]
    if power is None:
        power = period_power(A, nperiod)
    x1 = np.asarray(x1, np.float64)
    rhs = x1.T if x1.ndim == 2 else x1
    x0, *_ = np.linalg.lstsq(np.eye(n) - power, rhs, rcond=tol)
    return x0.T if x1.ndim == 2 else x0


def vv_step(system: GLESystem, state: MDState, noise_rows=None):
    """One GLE velocity-Verlet step (md.py:367-411). Pure and jittable.

    ``noise_rows``: tuple over baths of (row_t, row_tp1) — this step's and
    the next step's colored-noise vectors, streamed via the scan xs so the
    hot loop contains no dynamic indexing. ``None`` (single-step use)
    falls back to a static gather of rows 0/1 only when t is concrete.
    """
    # At default precision a float32 dot may run in a reduced-precision
    # mode (TF32 on Hopper tensor cores keeps ~3 decimal digits), most
    # of all once vmap turns the force GEMVs into batched GEMMs. ~1e-3
    # relative error on the CONSERVATIVE force parametrically heats
    # the junction (a bf16-pass run of the 201-atom flagship went from
    # etot 1e1 to 8e16 over 4096 steps). Every hot-loop contraction
    # therefore traces under HIGHEST precision.
    with jax.default_matmul_precision("highest"):
        return _vv_step_body(system, state, noise_rows)


def _vv_step_body(system: GLESystem, state: MDState, noise_rows=None):
    dt = system.dt
    t, p, q = state.t, state.p, state.q
    if noise_rows is None:
        noise_rows = tuple(
            (b.noise[0], b.noise[1 % b.nmd]) for b in system.baths)
    etot = 0.5 * jnp.dot(p, p)

    qhis = rpadleft(state.qhis, q)
    phis = rpadleft(state.phis, p)

    # per-bath per-step precomputation: the memory-kernel tails shared
    # by all three force evaluations are ONE matmul over the pre-push
    # history (one kernel read per step instead of three — the
    # convolution is memory-bandwidth-bound by the kernel matrix)
    gathers = []
    for b in system.baths:
        old_c = state.phis[: b.ml, b.cols]
        gathers.append((old_c, b.step_plan(old_c)))

    def scatter(b, f_local):
        return jnp.zeros((system.nph,), f_local.dtype).at[b.cols] \
            .set(f_local)

    pf = system.potential_force(q)
    fbaths = [scatter(b, b.force_pred(noise_rows[i][0], p[b.cols],
                                      q[b.cols], gathers[i][0],
                                      gathers[i][1]))
              for i, b in enumerate(system.baths)]
    f = pf
    for fb in fbaths:
        f = f + fb
    pthalf = p + f * (dt / 2.0)
    qtt = q + p * dt + f * (dt * dt / 2.0)

    cur = jnp.stack([jnp.dot(fb, p) for fb in fbaths]) if fbaths \
        else jnp.zeros((0,), p.dtype)

    # two corrector force evaluations with temporarily shifted history
    # (md.py:400-403, 429-431); potential force at qtt shared (sameq cache)
    pf2 = system.potential_force(qtt)

    def bath_sum(pt):
        out = pf2
        for i, b in enumerate(system.baths):
            out = out + scatter(b, b.force_corr(
                noise_rows[i][1], pt[b.cols], qtt[b.cols], p[b.cols],
                gathers[i][1]))
        return out

    ptt1 = pthalf + (dt / 2.0) * bath_sum(pthalf)
    f_last = bath_sum(ptt1)
    ptt2 = pthalf + (dt / 2.0) * f_last

    ptt2 = ptt2 * system.mask
    qtt = qtt * system.mask

    new_state = MDState(t=t + 1, p=ptt2, q=qtt, phis=phis, qhis=qhis)
    out = {"etot": etot, "cur": cur}
    if system.savep:
        out["ps"] = p
    if system.saveq:
        out["qs"] = q
    if system.savef:
        out["fbaths"] = jnp.stack(fbaths) if fbaths else None
        out["f"] = f_last
    if system.cf_fn is not None:
        out["cf"] = system.cf_fn(q) + system.dyn @ q
    return new_state, out


def _write_text(path: str, text: str):
    """Write a small text file through raw os.open/os.write.

    RunEnsemble writes one kappa file per trajectory and bath; the raw
    syscall path skips the buffered-IO object per file."""
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        os.write(fd, text.encode())
    finally:
        os.close(fd)


@partial(jax.jit, static_argnames=("lo",))
def _cur_reduce(cur, lo: int):
    """Equilibration-skipped per-trajectory current sum + global
    finiteness, reduced on device (RunEnsemble post-processing)."""
    return cur[:, lo:, :].sum(axis=1), jnp.isfinite(cur).all()


@partial(jax.jit, static_argnames=("nsteps", "t0"))
def run_segment(system: GLESystem, state: MDState, nsteps: int,
                t0: int = 0):
    """Scan ``nsteps`` GLE steps; returns (final_state, per-step outputs).

    ``t0``: static step offset of this segment (mod nmd) so the noise-row
    stream lines up with the reference's ``noise[t % nmd]`` lookup
    (baths.py:232,452) — the gather indices are compile-time constants.
    """
    nmd = system.nmd
    t0 = t0 % nmd

    def rows(noise, off):
        # rows (t0+off .. t0+off+nsteps-1) mod nmd as a static roll+slice
        # (an explicit index gather compiles pathologically on some
        # backends); tile first if the segment wraps past nmd.
        if nsteps > nmd:
            reps = -(-(nsteps + 1) // nmd) + 1
            noise = jnp.tile(noise, (reps, 1))
        return jnp.roll(noise, -(t0 + off), axis=0)[:nsteps]

    xs = tuple((rows(b.noise, 0), rows(b.noise, 1)) for b in system.baths)
    return jax.lax.scan(partial(vv_step, system), state, xs, length=nsteps)


def _noise_rows(noise, nmd: int, t0: int, off: int, nsteps: int):
    """Noise rows (t0+off .. t0+off+nsteps-1) mod nmd as a static
    roll+slice (see run_segment)."""
    if nsteps > nmd:
        reps = -(-(nsteps + 1) // nmd) + 1
        noise = jnp.tile(noise, (reps, 1))
    return jnp.roll(noise, -(t0 + off), axis=0)[:nsteps]


def _next_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


@partial(jax.jit, static_argnames=("nsteps", "t0", "block", "unroll"))
def run_segment_blocked(system: GLESystem, state: MDState, nsteps: int,
                        t0: int = 0, block: int = 64, unroll: int = 1):
    """``run_segment`` with a blocked memory-kernel convolution.

    Identical trajectories (up to float summation order), much less
    device-memory traffic for long kernels: per block of ``block``
    steps the friction convolution splits into

    * a pre-block part over taps j > s — ONE FFT cross-correlation of
      the kernel with the pre-block history per block (the (ml*nc, nc)
      kernel matrix is read once per block instead of once per step,
      and never per-trajectory), and
    * an in-block part over taps j <= s — a (block, nc) ring of recent
      velocities against a small kernel slice, with the predictor/
      corrector tails sharing one matmul (same trick as
      PhBath.step_plan).

    The full (ml, nph) history ring is never shifted per step; per-bath
    (ml-1, nc) histories update once per block. This is the device
    answer to the reference's per-step O(ml*nc^2) host convolution
    (baths.py:448-458) at production kernel lengths.
    """
    from sclmd_jax.baths import EBath, PhBath

    if nsteps % block:
        raise ValueError(f"nsteps={nsteps} must be a multiple of "
                         f"block={block}")
    with jax.default_matmul_precision("highest"):   # see vv_step
        return _run_segment_blocked_body(system, state, nsteps, t0,
                                         block, unroll, EBath, PhBath)


def _run_segment_blocked_body(system, state, nsteps, t0, block, unroll,
                              EBath, PhBath):
    nmd = system.nmd
    nblocks = nsteps // block
    t0 = t0 % nmd
    dt = system.dt
    dtype = state.p.dtype
    nph = system.nph

    # static per-bath plans (traced leaves; loop-invariant in the scans)
    plans = []
    hists = []
    for b in system.baths:
        nonlocal_ph = isinstance(b, PhBath) and b.ml > 1
        if nonlocal_ph:
            nfft = _next_pow2(b.ml + block + 2)
            kpad = jnp.pad(b.kernel, ((0, nfft - b.ml), (0, 0), (0, 0)))
            plans.append({
                "khat": jnp.fft.rfft(kpad, axis=0),
                "kin": b.block_tap_kernel(block),
                "nfft": nfft,
            })
            hists.append(state.phis[: b.ml - 1, b.cols])
        else:
            plans.append(None)
            hists.append(None)
    hists = tuple(hists)

    # noise: ONE stream per bath (rows t0+1 .. t0+nsteps); this step's
    # row t rides in the scan carry (next carry = this step's xs row),
    # halving the noise setup copies and xs footprint vs two offset
    # streams
    xs_outer = tuple(
        _noise_rows(b.noise, nmd, t0, 1, nsteps).reshape(
            nblocks, block, -1)
        for b in system.baths)
    nrow0 = tuple(b.noise[t0] for b in system.baths)

    def scatter(b, f_local):
        return jnp.zeros((nph,), f_local.dtype).at[b.cols].set(f_local)

    free = system.unconstrained

    def inner(carry, xs):
        if free:
            p, q, qprev, rings, nrows, pf = carry
        else:
            p, q, qprev, rings, nrows = carry
            pf = system.potential_force(q)
        etot = 0.5 * jnp.dot(p, p)
        fbaths = []
        corr_bases = []
        for i, b in enumerate(system.baths):
            n1, op, oc = xs[i]
            n0 = nrows[i]
            p_c = p[b.cols]
            if plans[i] is not None:
                nc = b.nc
                z1 = jnp.zeros((1, nc), dtype)
                S = jnp.stack([jnp.concatenate([rings[i], z1], 0),
                               jnp.concatenate([z1, rings[i]], 0)],
                              axis=2)
                tails = plans[i]["kin"] @ S.reshape((block + 1) * nc, 2)
                conv = b.kernel[0] @ p_c + tails[:, 0] + op
                fb_local = n0 - conv * dt
                corr_bases.append(b.kernel[1] @ p_c + tails[:, 1] + oc)
            elif isinstance(b, EBath):
                fb_local = b._markov_force(n0, p_c, q[b.cols])
                corr_bases.append(None)
            else:  # local phonon bath (ml == 1)
                fb_local = n0 - b.kernel[0] @ p_c
                corr_bases.append(None)
            fbaths.append(scatter(b, fb_local))
        f = pf
        for fb in fbaths:
            f = f + fb
        pthalf = p + f * (dt / 2.0)
        qtt = q + p * dt + f * (dt * dt / 2.0)
        cur = jnp.stack([jnp.dot(fb, p) for fb in fbaths]) if fbaths \
            else jnp.zeros((0,), dtype)

        pf2 = system.potential_force(qtt)

        def bath_sum(pt):
            out = pf2
            for i, b in enumerate(system.baths):
                n1 = xs[i][0]
                pt_c = pt[b.cols]
                if plans[i] is not None:
                    fl = n1 - (b.kernel[0] @ pt_c + corr_bases[i]) * dt
                elif isinstance(b, EBath):
                    fl = b._markov_force(n1, pt_c, qtt[b.cols])
                else:
                    fl = n1 - b.kernel[0] @ pt_c
                out = out + scatter(b, fl)
            return out

        ptt1 = pthalf + (dt / 2.0) * bath_sum(pthalf)
        f_last = bath_sum(ptt1)
        ptt2 = pthalf + (dt / 2.0) * f_last
        ptt2 = ptt2 * system.mask
        qtt = qtt * system.mask

        new_rings = tuple(
            rpadleft(rings[i], p[b.cols]) if plans[i] is not None else None
            for i, b in enumerate(system.baths))
        out = {"etot": etot, "cur": cur}
        if system.savep:
            out["ps"] = p
        if system.saveq:
            out["qs"] = q
        if system.savef:
            out["fbaths"] = jnp.stack(fbaths) if fbaths else None
            out["f"] = f_last
        if system.cf_fn is not None:
            out["cf"] = system.cf_fn(q) + system.dyn @ q
        new_nrows = tuple(xs[i][0] for i in range(len(system.baths)))
        carry_out = (ptt2, qtt, q, new_rings, new_nrows)
        if free:
            # next step's q IS this qtt (mask == 1), so its predictor
            # force is exactly pf2 — carry it instead of re-evaluating
            carry_out = carry_out + (pf2,)
        return carry_out, out

    def outer(carry, xs_blk):
        if free:
            p, q, qprev, bhists, nrows, pf = carry
        else:
            p, q, qprev, bhists, nrows = carry
        xs_inner = []
        for i, b in enumerate(system.baths):
            n1 = xs_blk[i]
            if plans[i] is not None:
                O = b.block_corr(bhists[i], block, plans[i]["khat"],
                                 plans[i]["nfft"])
                xs_inner.append((n1, O[:block], O[1:block + 1]))
            else:
                xs_inner.append((n1, None, None))
        rings = tuple(
            jnp.zeros((block, b.nc), dtype) if plans[i] is not None
            else None for i, b in enumerate(system.baths))
        carry_in = (p, q, qprev, rings, nrows) + ((pf,) if free else ())
        fin, ys = jax.lax.scan(
            inner, carry_in, tuple(xs_inner),
            length=block, unroll=unroll)
        p, q, qprev, rings, nrows = fin[:5]
        new_hists = tuple(
            jnp.concatenate([rings[i], bhists[i]], 0)[: b.ml - 1]
            if plans[i] is not None else None
            for i, b in enumerate(system.baths))
        carry_out = (p, q, qprev, new_hists, nrows)
        if free:
            carry_out = carry_out + (fin[5],)
        return carry_out, ys

    carry0 = (state.p, state.q, state.qhis[0], hists, nrow0)
    if free:
        carry0 = carry0 + (system.potential_force(state.q),)
    fin, ys = jax.lax.scan(outer, carry0, xs_outer, length=nblocks)
    p, q, qprev, hists_f = fin[0], fin[1], fin[2], fin[3]
    ys = jax.tree_util.tree_map(
        lambda a: a.reshape((nsteps,) + a.shape[2:]), ys)

    # reconstruct a plain-path-compatible state: phis columns outside the
    # bath DOFs are never read by any force rule, so zeros there resume
    # identically under vv_step/run_segment
    phis = jnp.zeros((system.ml, nph), dtype)
    for i, b in enumerate(system.baths):
        if hists_f[i] is not None:
            phis = phis.at[: b.ml - 1, b.cols].set(hists_f[i])
    final = MDState(t=state.t + nsteps, p=p, q=q, phis=phis,
                    qhis=qprev[None])
    return final, ys


# ---------------------------------------------------------------------------
# Dynamical-matrix setup
# ---------------------------------------------------------------------------
def set_dyn(dyn, dtype=jnp.float64):
    """Symmetrise, remove negative modes, return (dyn, hw, U).

    Mirrors md.setDyn (md.py:250-292): eigenvalues < 0 are clamped to 0
    and the matrix rebuilt as U diag(av) U^T.

    Runs in HOST numpy float64 regardless of the MD dtype (the
    project's setup-is-host-side invariant): a device f32 eigh +
    rebuild of a stiff many-DOF matrix leaves O(eps * band) negative
    leakage whose exp(sqrt|lambda|, t) growth is visible over long
    runs.
    Results are cast to ``dtype`` only at the end.
    """
    dyn = np.asarray(dyn, np.float64)
    dyn = (dyn + dyn.T) / 2
    av, au = np.linalg.eigh(dyn)
    av = np.clip(av, 0.0, None)
    hw = np.sqrt(av)
    dyn = (au * av[None, :]) @ au.T
    return (jnp.asarray(dyn, dtype), jnp.asarray(hw, dtype),
            jnp.asarray(au, dtype))


# ---------------------------------------------------------------------------
# Orchestration wrapper (reference-compatible API)
# ---------------------------------------------------------------------------
class md:
    """User-facing MD runner mirroring the reference class ``md``
    (md.py:17-745): same constructor signature and method names, with
    npz checkpoints instead of NetCDF and jitted segments inside Run().
    """

    def __init__(self, dt, nmd, T, syslist=None, axyz=None, dyn=None,
                 nstart=0, nstop=1, npie=1, md2ang=U.MD2ANG,
                 dtype=jnp.float32, seed=1234, outdir=".", block=None):
        self.dt, self.nmd, self.T = float(dt), int(nmd), float(T)
        self.nstart, self.nstop, self.npie = int(nstart), int(nstop), int(npie)
        # blocked-convolution fast path: segments run through
        # run_segment_blocked when the segment length divides evenly
        self.block = None if block is None else int(block)
        self.md2ang = md2ang
        self.dtype = dtype
        self.outdir = outdir
        self.key = jax.random.PRNGKey(seed)

        self.saveall = False
        self.savep = False
        self.saveq = False
        self.rmnc = False
        self.nstep = None
        self.pforce = None
        self.constraint = None
        self.atomlist = None
        self.initranvel = True
        self.cf = False
        self.forcedriver = None

        self.SetXyz(axyz)
        if syslist is not None:
            syslist = np.asarray(syslist, dtype=np.int64)
            if (len(syslist) > self.nta or syslist.min() < 0
                    or syslist.max() > self.nta - 1):
                raise ValueError("syslist out of range")
            self.syslist = syslist
            self.na = len(syslist)
            self.nph = 3 * self.na
        elif axyz is not None:
            self.syslist = np.arange(len(axyz))
            self.na = len(self.syslist)
            self.nph = 3 * self.na
        else:
            self.syslist = None
            self.na = None
            self.nph = None

        self.ml = 1
        self.t = 0
        self.baths = []
        self.power = None
        self.poweratomlist = None

        self.setDyn(dyn)

        if axyz is not None:
            self.mass = [U.AtomicMassTable[el] for el in self.els]
            self.conv = self.md2ang * np.repeat(
                1.0 / np.sqrt(np.array(self.mass)), 3)
        else:
            self.mass = None
            self.conv = None

    # ---- setup methods (reference names) ----
    def SetXyz(self, axyz):
        if axyz is not None:
            self.xyz = np.array([a[1:] for a in axyz], dtype=float).flatten()
            self.els = [a[0] for a in axyz]
            self.nta = len(axyz)
        else:
            self.xyz, self.els, self.nta = None, None, None

    def setDyn(self, dyn=None):
        if dyn is not None:
            n = np.asarray(dyn).shape[0]
            if self.nph is not None and self.nph != n:
                raise ValueError("dynamical matrix dimension mismatch")
            self.nph = n
            d, hw, evecs = set_dyn(dyn, dtype=self.dtype)
            self.dyn = d
            self.hw = np.asarray(hw)
            self.U = evecs
        else:
            self.dyn = None
            self.hw = np.array([1.0])
            self.U = None

    def AddBath(self, bath):
        if self.dt != bath.dt:
            raise ValueError("md.AddBath: time step dt not consistent")
        if self.nmd != bath.nmd:
            raise ValueError("md.AddBath: nmd not consistent")
        self.baths.append(bath)
        self.ml = max(self.ml, bath.ml)

    def AddPotential(self, pint):
        """Attach a force driver (JAX-native: jittable ``force(q)``)."""
        self.pforce = pint

    def AddConstr(self, constr):
        self.constraint = constr

    def AddPowerSection(self, atomlist):
        self.atomlist = atomlist

    def CalPowerSpec(self, cal=True):
        self.savep = cal

    def CalAveStruct(self, cal=True):
        self.saveq = cal

    def SaveAll(self, save=True):
        self.saveall = save

    def Savep(self, save=True):
        self.savep = save

    def Saveq(self, save=True):
        self.saveq = save

    def SaveTraj(self, nstep=100):
        self.nstep = nstep

    def RemoveNC(self, rmnc=True):
        self.rmnc = rmnc

    def SetT(self, T):
        self.T = T

    def SetMD(self, dt, nmd):
        self.dt, self.nmd = dt, nmd

    def noranvel(self, rf=False):
        self.initranvel = rf

    def SetSyslist(self, syslist):
        """Reset the system-atom list (md.py:238-248)."""
        self.syslist = np.asarray(syslist, dtype=np.int64)
        self.na = len(self.syslist)
        self.nph = 3 * self.na
        if self.nta is not None and self.na > self.nta:
            raise ValueError("system atom number larger than total")

    def ResetHis(self):
        """Zeroed history rings as a fresh MDState (md.py:340-349)."""
        return initial_state(self._build_system(), dtype=self.dtype)

    def ResetSavepq(self):
        """No-op parity shim (md.py:153-157): per-step series are scan
        outputs here, not preallocated buffers."""

    def CompareForce(self, forcedriver):
        self.cf = True
        self.forcedriver = forcedriver

    def energy(self, state):
        return 0.5 * float(jnp.dot(state.p, state.p))

    # ---- assembly ----
    def _constraint_mask(self):
        mask = np.ones(self.nph, dtype=np.float64)
        if self.constraint is not None:
            for grp in self.constraint:
                mask[np.asarray(list(grp), dtype=np.int64)] = 0.0
        return jnp.asarray(mask, self.dtype)

    def _build_system(self, savef=False):
        force_fn = None
        if self.pforce is not None:
            force_fn = getattr(self.pforce, "force_jax", None) or \
                (self.pforce.force if callable(
                    getattr(self.pforce, "force", None)) else None)
        cf_fn = None
        if self.cf and self.forcedriver is not None:
            cf_fn = self.forcedriver.force_jax \
                if hasattr(self.forcedriver, "force_jax") \
                else self.forcedriver.force
        # keep the PSD factors out of the hot-loop pytree: the scan only
        # needs the sampled noise
        hot_baths = tuple(b.replace(nevecs=None, nstd=None)
                          for b in self.baths)
        return GLESystem(
            dyn=None if self.dyn is None else jnp.asarray(self.dyn,
                                                          self.dtype),
            baths=hot_baths,
            mask=self._constraint_mask(),
            dt=self.dt, nph=self.nph, ml=self.ml, nmd=self.nmd,
            force_fn=force_fn,
            unconstrained=self.constraint is None or not self.constraint,
            savep=self.savep or self.saveall,
            saveq=self.saveq or self.saveall or (self.nstep is not None),
            savef=savef or self.saveall or (self.nstep is not None),
            cf_fn=cf_fn,
        )

    def _next_key(self):
        self.key, sub = jax.random.split(self.key)
        return sub

    def initialise(self, system):
        if self.dyn is None or not self.initranvel:
            return initial_state(system, dtype=self.dtype)
        return thermal_init(self._next_key(), system,
                            jnp.asarray(self.hw, self.dtype),
                            jnp.asarray(self.U, self.dtype), self.T)

    def get_atommass(self):
        """Per-atom mass list from element names (md.py:132-136)."""
        self.mass = [U.AtomicMassTable[el] for el in self.els]
        return self.mass

    def info(self):
        print("-" * 44)
        print("GLE MD: na=%s dt=%s nmd=%s ml=%s baths=%d" %
              (self.na, self.dt, self.nmd, self.ml, len(self.baths)))

    # ---- checkpoints ----
    def _ckfile(self, j):
        return os.path.join(self.outdir, f"MD{j}.npz")

    def _check_checkpoint(self, ck, fn):
        """Refuse checkpoints from a different setup (stale files in a
        shared working directory resume silently otherwise — the
        reference has the same trap with its MD{j}.nc files)."""
        if ck["p"].shape != (self.nph,):
            raise ValueError(
                f"{fn} holds a different system (nph="
                f"{ck['p'].shape[0]} vs {self.nph}) — stale checkpoint "
                "in the working directory? Remove it or change outdir")
        for i, b in enumerate(self.baths):
            key = f"noise{i}"
            if key in ck and ck[key].shape[1] != b.nc:
                raise ValueError(
                    f"{fn} bath {i} noise width {ck[key].shape[1]} != "
                    f"{b.nc} — stale checkpoint from a different bath "
                    "setup")
        if "nmd" in ck and int(ck["nmd"][0]) != self.nmd:
            raise ValueError(
                f"{fn} was written with nmd={int(ck['nmd'][0])} but this "
                f"run has nmd={self.nmd} — stale checkpoint")
        if "dt" in ck and not np.isclose(float(ck["dt"][0]), self.dt,
                                         rtol=1e-12):
            raise ValueError(
                f"{fn} was written with dt={float(ck['dt'][0])} but this "
                f"run has dt={self.dt} — stale checkpoint")

    def dump(self, state, ipie, j, outputs=None):
        """Write the MD{j} checkpoint (reference md.dump, md.py:684-745)."""
        data = {
            "p": np.asarray(state.p), "q": np.asarray(state.q),
            "t": np.asarray([int(state.t)]),
            "ipie": np.asarray([ipie]),
            "nmd": np.asarray([self.nmd]), "dt": np.asarray([self.dt]),
            "phis": np.asarray(state.phis), "qhis": np.asarray(state.qhis),
        }
        for i, b in enumerate(self.baths):
            if b.noise is not None:
                data[f"noise{i}"] = np.asarray(b.noise)
        if outputs is not None:
            for k, v in outputs.items():
                if v is not None:
                    data[k] = np.asarray(v)
        if self.power is not None:
            data["power"] = np.asarray(self.power)
            if self.poweratomlist is not None:
                data["poweratomlist"] = np.asarray(self.poweratomlist)
        np.savez(self._ckfile(j), **data)

    # ---- main loop ----
    def Run(self):
        system = self._build_system()
        state = self.initialise(system)
        self.info()

        seg = self.nmd // self.npie
        for j in range(self.nstart, self.nstop):
            fn, fnm = self._ckfile(j), self._ckfile(j - 1)
            collected = {}
            ipie0 = -1
            if os.path.isfile(fn):
                ck = np.load(fn)
                self._check_checkpoint(ck, fn)
                ipie = int(ck["ipie"][0])
                if ipie + 1 < self.npie:
                    # resume unfinished run (md.py:514-534)
                    state = MDState(
                        t=jnp.asarray(int(ck["t"][0]), jnp.int32),
                        p=jnp.asarray(ck["p"], self.dtype),
                        q=jnp.asarray(ck["q"], self.dtype),
                        phis=jnp.asarray(ck["phis"], self.dtype),
                        qhis=jnp.asarray(ck["qhis"], self.dtype))
                    for i in range(len(self.baths)):
                        # dump() writes noise{i} only when the bath had
                        # noise attached; a checkpoint written without it
                        # (e.g. by a direct dump() call before gnoi) must
                        # not KeyError — sample fresh noise for that bath
                        # instead (resume is then reproducible only for
                        # the baths whose noise was persisted)
                        if f"noise{i}" in ck:
                            self.baths[i] = self.baths[i].replace(
                                noise=jnp.asarray(ck[f"noise{i}"]))
                        else:
                            self.baths[i] = self.baths[i].gnoi(
                                self._next_key())
                    for k in ("etot", "cur", "ps", "qs", "fbaths", "f"):
                        if k in ck:
                            collected[k] = [np.asarray(ck[k])]
                    ipie0 = ipie
                    system = self._build_system()
                else:
                    # finished run: skip (md.py:536-544)
                    if "power" in ck:
                        self.power = np.asarray(ck["power"])
                    self.t = int(ck["t"][0])
                    continue
            else:
                if os.path.isfile(fnm):
                    # chain from previous run with warm history (md.py:552-562)
                    ck = np.load(fnm)
                    state = state.replace(
                        t=jnp.asarray(int(ck["t"][0]), jnp.int32),
                        p=jnp.asarray(ck["p"], self.dtype),
                        q=jnp.asarray(ck["q"], self.dtype))
                    if ck["phis"].shape == tuple(state.phis.shape):
                        state = state.replace(
                            phis=jnp.asarray(ck["phis"], self.dtype),
                            qhis=jnp.asarray(ck["qhis"], self.dtype))
                elif j != 0 and j != self.nstart:
                    raise FileNotFoundError("no previous checkpoint exists")
                # fresh noise for this run (md.py:569-570)
                for i in range(len(self.baths)):
                    self.baths[i] = self.baths[i].gnoi(self._next_key())
                system = self._build_system()

            trajfile = None
            if self.nstep is not None:
                trajfile = open(os.path.join(
                    self.outdir,
                    f"trajectories.{self.T:g}.run{j}.ani"), "w")

            ck_keys = ("etot", "cur", "ps", "qs") + \
                (("fbaths", "f") if self.saveall else ())
            wrote_segment = ipie0 >= 0
            try:
                for i in range(ipie0 + 1, self.npie):
                    if self.block and seg % self.block == 0:
                        state, ys = run_segment_blocked(
                            system, state, seg,
                            t0=int(state.t) % self.nmd,
                            block=self.block)
                    else:
                        state, ys = run_segment(
                            system, state, seg,
                            t0=int(state.t) % self.nmd)
                    ys = jax.device_get(ys)
                    # failure detection (beyond the reference, which
                    # runs blind): a diverged segment aborts with
                    # context instead of writing NaN checkpoints. The
                    # per-step etot observes the state at step START,
                    # so the post-segment state is checked too.
                    state_bad = not (
                        np.isfinite(np.asarray(state.p)).all()
                        and np.isfinite(np.asarray(state.q)).all())
                    if state_bad or not np.isfinite(ys["etot"]).all():
                        if state_bad:
                            bad = seg - 1
                        else:
                            bad = int(np.argmax(
                                ~np.isfinite(ys["etot"])))
                        if wrote_segment:
                            last_good = self._ckfile(j)
                        elif os.path.isfile(self._ckfile(j - 1)):
                            last_good = self._ckfile(j - 1)
                        else:
                            last_good = "none (run diverged before the "\
                                "first checkpoint)"
                        raise FloatingPointError(
                            f"run {j}: non-finite state at step "
                            f"{int(state.t) - seg + bad}; last good "
                            f"checkpoint: {last_good} — reduce dt or "
                            f"check the force driver")
                    for k, v in ys.items():
                        if v is not None:
                            collected.setdefault(k, []).append(
                                np.asarray(v))
                    if trajfile is not None:
                        self._write_traj(trajfile, ys, seg, i)
                    self.dump(state, i, j, outputs={
                        k: np.concatenate(v, axis=0)
                        for k, v in collected.items() if k in ck_keys})
                    wrote_segment = True

                outputs = {k: np.concatenate(v, axis=0)
                           for k, v in collected.items()}
                self._postrun(j, state, outputs)
            finally:
                if trajfile is not None:
                    trajfile.close()
            if self.rmnc and os.path.exists(self._ckfile(j - 1)):
                os.remove(self._ckfile(j - 1))
        self.state = state

    def _eck_file(self):
        return os.path.join(self.outdir, "MDE.npz")

    def RunEnsemble(self, ntraj: int, nsteps: Optional[int] = None,
                    equil_frac: float = 0.25, block: Optional[int] = None,
                    npie: Optional[int] = None, checkpoint: bool = False,
                    chunk: Optional[int] = None,
                    steady_init: bool = False):
        """Run ``ntraj`` independent trajectories as vmapped programs.

        The reference executes its ensemble sequentially (the
        nstart..nstop loop, md.py:506); here every trajectory gets its
        own colored noise and the batch is a compiled scan. Writes the
        same kappa.T.bathI.runJ.dat files, so calHF/calTC aggregate
        unchanged. Returns the per-trajectory mean bath currents
        (ntraj, nbaths).

        ``chunk`` bounds how many trajectories are resident at once:
        the batch runs as ceil(ntraj/chunk) sequential vmapped chunks,
        each synthesizing only its own (chunk, nmd, nc) noise — the fix
        for the ensemble memory wall (SURVEY.md hard part: "noise
        arrays ... must stream from HBM or be regenerated in chunks").
        Default: auto-sized from a per-trajectory device-memory
        estimate against a budget read from the device's own allocator
        limit (parallel.ensemble.auto_chunk).
        The per-trajectory key schedule depends only on the trajectory
        index, so the noise/init draws are BITWISE independent of the
        chunking; results agree to float roundoff (the fused
        single-dispatch program's XLA fusion pattern varies with the
        chunk shape, reassociating summations at ~1e-15 relative).

        ``npie`` splits each chunk's run into segments (like Run's
        npie); ``checkpoint=True`` dumps an MDE.npz bundle (current
        chunk's batched state + noise + globally accumulated currents)
        after every segment and resumes from it — the
        production-ensemble analog of the MD{j} resume semantics
        (md.py:511-567), with the same noise-persistence
        reproducibility guarantee.

        ``steady_init=True`` starts each trajectory with every normal
        mode at its coupling-weighted steady-state temperature
        (``steady_mode_temps``) instead of the reference's uniform T.
        The steady state is unchanged (init only affects transients);
        what it removes is the DeltaT-odd mode-relaxation transient
        that biases short antithetic conductance runs (measured +7.9%
        at nmd=2^13 on the flagship crosscheck, ~1/T_run). With all
        baths at equal temperature it reduces to the uniform start.
        """
        from sclmd_jax.parallel.ensemble import (auto_chunk,
                                                 ensemble_noise,
                                                 ensemble_run,
                                                 ensemble_states)
        nsteps = nsteps or self.nmd
        npie = npie or 1
        if nsteps % npie:
            raise ValueError(f"nsteps={nsteps} not divisible by "
                             f"npie={npie}")
        seg = nsteps // npie
        system = self._build_system()
        nb = len(self.baths)
        skip = int(nsteps * equil_frac)

        block = block if block is not None else self.block
        if block and seg % block:
            block = None
        if chunk is None:
            # depth=2 on BOTH paths: the pipelined path has two chunk
            # footprints live (executing + enqueued); the checkpoint
            # path keeps the same conservative sizing
            chunk = auto_chunk(system, ntraj, nsteps, block, depth=2)
        chunk = max(1, min(int(chunk), ntraj))

        # one noise key + one init key for the WHOLE ensemble, consumed
        # window-wise per chunk (bitwise chunking invariance); both are
        # persisted in the checkpoint so chunks AFTER a resumed one draw
        # the same noise/initial conditions regardless of the resuming
        # runner's seed (the chunked analog of noise persistence)
        noise_key = self._next_key()
        thermal = self.dyn is not None and self.initranvel
        init_key = self._next_key() if thermal else None
        # sample with the PSD factors present so gnoi takes the device
        # path (sample_noise_dev — vmappable);
        # _build_system strips the factors, and ensemble_noise strips
        # them again from what it returns
        baths_f = tuple(b if b.nstd is not None else b.prepare_noise()
                        for b in self.baths)
        sys_f = system.replace(baths=baths_f)

        ichunk0, ipie0 = 0, -1
        cur_sum = np.zeros((ntraj, nb))
        # counted steps per trajectory — identical for every chunk, so
        # it is a pure function of the segment schedule (NOT accumulated:
        # resume at a later chunk must not re-count)
        cur_cnt = sum(seg - min(max(0, skip - i * seg), seg)
                      for i in range(npie))
        ck_state, ck_bsys = None, None
        fn = self._eck_file()
        if checkpoint and os.path.isfile(fn):
            ck = np.load(fn)
            ck_chunk = (int(ck["chunk"][0]) if "chunk" in ck
                        else ck["p"].shape[0])
            ck_ntraj = (int(ck["ntraj"][0]) if "ntraj" in ck
                        else ck["p"].shape[0])
            if (ck["p"].shape[1:] != (self.nph,)
                    or ck_ntraj != ntraj
                    or ck_chunk != chunk
                    or int(ck["nmd"][0]) != self.nmd
                    or not np.isclose(float(ck["dt"][0]), self.dt)):
                raise ValueError(
                    f"{fn} holds a different ensemble setup — stale "
                    "checkpoint; remove it or change outdir")
            ichunk0 = int(ck["ichunk"][0]) if "ichunk" in ck else 0
            ipie0 = int(ck["ipie"][0])
            cur_sum = np.asarray(ck["cur_sum"])
            if "noise_key" in ck:
                noise_key = jnp.asarray(ck["noise_key"], jnp.uint32)
            if thermal and "init_key" in ck:
                init_key = jnp.asarray(ck["init_key"], jnp.uint32)
            ck_state = MDState(
                t=jnp.asarray(ck["t"], jnp.int32),
                p=jnp.asarray(ck["p"], self.dtype),
                q=jnp.asarray(ck["q"], self.dtype),
                phis=jnp.asarray(ck["phis"], self.dtype),
                qhis=jnp.asarray(ck["qhis"], self.dtype))
            ck_bsys = system.replace(baths=tuple(
                system.baths[i].replace(
                    noise=jnp.asarray(ck[f"noise{i}"]),
                    nevecs=None, nstd=None)
                for i in range(nb)))

        T_init = self.T
        if thermal and steady_init and self.baths:
            T_init = jnp.asarray(
                steady_mode_temps(self.U, self.baths, self.T,
                                  hw=np.asarray(self.hw)), self.dtype)
        first_final = None
        nchunks = -(-ntraj // chunk)
        pending = []

        # FUSED single-dispatch path (the default production shape):
        # noise synthesis + init + run + reduction compile into ONE
        # program per chunk instead of ~8-10 dispatches. Key schedules
        # are bitwise ensemble_noise/ensemble_states', so results match
        # the segmented/checkpoint path exactly.
        if not checkpoint and npie == 1:
            from sclmd_jax.parallel.ensemble import (
                _all_key_schedules, _fused_chunk, bath_factor_triples)
            facs = jax.device_put(bath_factor_triples(sys_f.baths))
            nk, ik = _all_key_schedules(
                noise_key,
                init_key if thermal else noise_key, nb, ntraj)
            nkeys_all = np.asarray(nk)
            if thermal:
                ikeys_all = np.asarray(ik)
                hw_d = jnp.asarray(self.hw, self.dtype)
                ev_d = jnp.asarray(self.U, self.dtype)
            else:
                ikeys_all, hw_d, ev_d = None, None, None

            def _drain_f(item):
                d0, d1, dic, dsum, dok = item
                if not bool(np.asarray(dok)):
                    raise FloatingPointError(
                        "RunEnsemble: non-finite heat currents in "
                        f"chunk {dic} (pipelined path: detection is "
                        "deferred by one chunk) — reduce dt or check "
                        "the force driver")
                cur_sum[d0:d1] += np.asarray(dsum)

            for ic in range(nchunks):
                c0, c1 = ic * chunk, min((ic + 1) * chunk, ntraj)
                nkeys = tuple(nkeys_all[i][c0:c1] for i in range(nb))
                ikeys = ikeys_all[c0:c1] if thermal else None
                finals, seg_sum, ok = _fused_chunk(
                    system, facs, nkeys, ikeys, hw_d, ev_d,
                    T_init if thermal else None,
                    nsteps, 0, block, min(skip, nsteps))
                pending.append((c0, c1, ic, seg_sum, ok))
                while len(pending) > 1:
                    _drain_f(pending.pop(0))
                if first_final is None:
                    first_final = finals
            for item in pending:
                _drain_f(item)
            means = cur_sum / max(cur_cnt, 1)
            self._write_kappa_files(ntraj, nb, means)
            if first_final is not None:
                self.state = jax.tree_util.tree_map(
                    lambda x: x[0], first_final)
            return means

        def _drain(item):
            d0, d1, dic, di, dlo, dseg, dsum, dok = item
            if not bool(np.asarray(dok)):
                raise FloatingPointError(
                    "RunEnsemble: non-finite heat currents in "
                    f"chunk {dic} segment {di} (pipelined path: "
                    "detection is deferred by one segment, so the "
                    "following chunk/segment was already enqueued) — "
                    "reduce dt or check the force driver")
            if dlo < dseg:
                cur_sum[d0:d1] += np.asarray(dsum)

        for ic in range(ichunk0, nchunks):
            c0, c1 = ic * chunk, min((ic + 1) * chunk, ntraj)
            if ic == ichunk0 and ck_state is not None:
                bsys, finals, pie_start = ck_bsys, ck_state, ipie0 + 1
                if pie_start >= npie:       # chunk already complete
                    continue
            else:
                bsys = ensemble_noise(sys_f, noise_key, ntraj,
                                      lo=c0, hi=c1)
                if thermal:
                    finals = ensemble_states(
                        bsys, ntraj, key=init_key,
                        hw=jnp.asarray(self.hw, self.dtype),
                        evecs=jnp.asarray(self.U, self.dtype),
                        T=T_init,
                        lo=c0, hi=c1)
                else:
                    finals = ensemble_states(bsys, ntraj, lo=c0, hi=c1)
                pie_start = 0

            for i in range(pie_start, npie):
                finals, ys = ensemble_run(bsys, finals, seg,
                                          t0=(i * seg) % self.nmd,
                                          block=block)
                lo = max(0, skip - i * seg)
                # reduce on device: only (chunk, nb) + a scalar cross
                # the (slow) host link instead of the full history
                seg_sum, ok = _cur_reduce(ys["cur"], min(lo, seg))
                if not checkpoint:
                    # pipelined path: defer host materialization so the
                    # next chunk's noise synthesis + run enqueue while
                    # this one executes. Draining past ONE pending entry
                    # bounds live device state to ~2 chunk footprints
                    # (the executing chunk + the one being enqueued) —
                    # auto_chunk sizes chunks against HALF the memory
                    # budget to account for this.
                    pending.append((c0, c1, ic, i, lo, seg, seg_sum,
                                    ok))
                    while len(pending) > 1:
                        _drain(pending.pop(0))
                    continue
                if not bool(np.asarray(ok)):
                    raise FloatingPointError(
                        "RunEnsemble: non-finite heat currents in "
                        f"chunk {ic} segment {i} — reduce dt or check "
                        "the force driver")
                if lo < seg:
                    cur_sum[c0:c1] += np.asarray(seg_sum)
                if checkpoint:
                    data = {
                        "p": np.asarray(finals.p),
                        "q": np.asarray(finals.q),
                        "t": np.asarray(finals.t),
                        "phis": np.asarray(finals.phis),
                        "qhis": np.asarray(finals.qhis),
                        "ichunk": np.asarray([ic]),
                        "ipie": np.asarray([i]),
                        "chunk": np.asarray([chunk]),
                        "ntraj": np.asarray([ntraj]),
                        "nmd": np.asarray([self.nmd]),
                        "dt": np.asarray([self.dt]),
                        "cur_sum": cur_sum,
                        "cur_cnt": np.asarray([cur_cnt]),
                        "noise_key": np.asarray(noise_key),
                    }
                    if thermal:
                        data["init_key"] = np.asarray(init_key)
                    for ib, b in enumerate(bsys.baths):
                        data[f"noise{ib}"] = np.asarray(b.noise)
                    np.savez(fn, **data)
            if first_final is None:
                first_final = jax.tree_util.tree_map(
                    lambda x: x[0], finals)

        for item in pending:
            _drain(item)
        means = cur_sum / max(cur_cnt, 1)
        self._write_kappa_files(ntraj, nb, means)
        if first_final is not None:
            self.state = first_final
        return means

    def _write_kappa_files(self, ntraj, nb, means):
        """Per-trajectory kappa files (reference kappa.T.bathI.runJ.dat
        format, aggregated by calHF/calTC) through the raw-syscall
        writer — see _write_text."""
        for jtraj in range(ntraj):
            for ii in range(nb):
                _write_text(
                    os.path.join(
                        self.outdir,
                        f"kappa.{self.T:g}.bath{ii}.run{jtraj}.dat"),
                    "%i %f    %f \n" % (
                        jtraj, self.T, means[jtraj, ii] * U.CURCOF))

    def _write_traj(self, fh, ys, seg, ipie):
        """ani-format trajectory frames every nstep steps (md.py:586-595)."""
        qs = ys.get("qs")
        fs = ys.get("f")
        if qs is None or fs is None:
            return
        base = ipie * seg
        for s in range(seg):
            tstep = base + s
            if tstep == 0 or tstep % self.nstep == 0:
                fh.write(f"{len(self.els)}\n{tstep}\n")
                struct_ = self.xyz + self.conv * np.asarray(qs[s])
                frc = np.asarray(fs[s])
                for ip, el in enumerate(self.els):
                    fh.write("%s    %s   %s   %s   %s   %s   %s\n" % (
                        el, struct_[3 * ip], struct_[3 * ip + 1],
                        struct_[3 * ip + 2], frc[3 * ip],
                        frc[3 * ip + 1], frc[3 * ip + 2]))

    def _postrun(self, j, state, outputs):
        """Per-run power spectrum, kappa files, average structure
        (md.py:604-675)."""
        self.etot = outputs.get("etot")
        self.curs = outputs.get("cur")
        if self.cf and "cf" in outputs:
            np.save(os.path.join(self.outdir, f"deltaforce.run{j}"),
                    outputs["cf"] / np.asarray(self.forcedriver.conv))

        if self.savep and "ps" in outputs:
            power = np.asarray(powerspecp(
                jnp.asarray(outputs["ps"]), self.dt, self.nmd))
            if self.power is None or j == self.nstart:
                self.power = power
            else:
                self.power = (self.power * (j - self.nstart) + power) / \
                    float(j - self.nstart + 1)
            self._write_power(j, self.power, "power")
            if self.atomlist is not None:
                pal = []
                for layers, sel in enumerate(self.atomlist):
                    pw = np.asarray(powerspecp(
                        jnp.asarray(outputs["ps"][:, list(sel)]),
                        self.dt, self.nmd))
                    pal.append(pw)
                pal = np.array(pal)
                if self.poweratomlist is None or j == self.nstart:
                    self.poweratomlist = pal
                else:
                    self.poweratomlist = (
                        self.poweratomlist * (j - self.nstart) + pal) / \
                        float(j - self.nstart + 1)
                for layers in range(len(self.atomlist)):
                    self._write_power(
                        j, self.poweratomlist[layers],
                        f"poweratomlist.{layers}")

        # heat current per bath (md.py:658-664)
        if self.curs is not None:
            for ii in range(len(self.baths)):
                with open(os.path.join(
                        self.outdir,
                        f"kappa.{self.T:g}.bath{ii}.run{j}.dat"), "w") as fk:
                    fk.write("%i %f    %f \n" % (
                        j, self.T,
                        float(np.mean(self.curs[:, ii])) * U.CURCOF))

        if self.saveq and "qs" in outputs and self.xyz is not None:
            ave = self.conv * outputs["qs"].mean(axis=0) + self.xyz
            with open(os.path.join(
                    self.outdir,
                    f"avestructure.{self.T:g}.run{j}.dat"), "w") as f:
                f.write(f"{len(self.els)}\naverage structure\n")
                for ip, el in enumerate(self.els):
                    f.write("%s    %s   %s   %s\n" % (
                        el, ave[3 * ip], ave[3 * ip + 1], ave[3 * ip + 2]))

        keep = ("etot", "cur", "ps", "qs") + \
            (("fbaths", "f") if self.saveall else ())
        self.dump(state, self.npie - 1, j, outputs={
            k: outputs.get(k) for k in keep if k in outputs})

    def _write_power(self, j, power, prefix):
        with open(os.path.join(
                self.outdir, f"{prefix}.{self.T:g}.run{j}.dat"), "w") as f:
            for ni in range(len(power)):
                if self.hw is not None and \
                        power[ni, 0] >= 1.5 * float(np.max(self.hw)):
                    break
                f.write("%f     %f \n" % (power[ni, 0], power[ni, 1]))

    def GetPower(self):
        if self.curs is None:
            raise RuntimeError("run first")
        return self.power


def ApplyConstraint(f, constr=None):
    """Zero the listed DOFs of f (md.py:782-794)."""
    if constr is None:
        return f
    f = np.array(f, dtype=float)
    for grp in constr:
        f[np.asarray(list(grp), dtype=np.int64)] = 0.0
    return f


def sameq(q1, q2, tol=10e-10):
    """True when two displacement vectors coincide (md.py:767-779)."""
    q1, q2 = np.asarray(q1), np.asarray(q2)
    if q1.shape != q2.shape:
        return False
    return bool(np.max(np.abs(q1 - q2)) < tol)
