"""Exact attractor expectation of the discrete GLE bath currents.

For a HARMONIC system the velocity-Verlet map (md.vv_step) is affine,

    x_{t+1} = A x_t + B0 xi_t + B1 xi_{t+1},

and the synthesized colored noise is a finite frequency comb
(ops.noise.sample_noise / mirror_halfspectrum / fourier_w2t):

    xi_t = (1/(N dt)) [Re u_0 + (-1)^t Re u_h
                       + 2 sum_{m=1}^{h-1} Re(u_m e^{-i th_m t})],

    u_m = U_m (s_m * eps_m),  eps_m ~ N(0, I) REAL,  th_m = 2 pi m / N,

with (U_m, s_m) the host PSD factors (noise_factors / prepare_noise).
The periodic particular solution per line is x^(m)_t = Re[X_m z^t],
z = e^{-i th_m}, (z I - A) X_m = (B0 + z B1) u_m, and each per-step
bath current cur_b = f_b . p is a pure quadratic form v^T M_b v in
v = [x; xi_t; xi_{t+1}]. Averaged over ONE full noise period the
oscillatory (pseudo-covariance) terms cancel except at m in {0, h},
leaving the closed form

    E[J_b] = sum_m (a_m^2 / 2) Re( tr[M_b L_m D? ...] )
           = sum_m (a_m^2 / 2) ( Re tr[M_b P_m P_m^H]
                                 + delta_m Re tr[M_b P_m P_m^T] ),

    P_m = [X; I; zI] (U_m diag(s_m)),   a_m = 2/(N dt) (1/(N dt) at
    m = 0, h where also delta_m = 1).

This is the ZERO-Monte-Carlo prediction of what md's warm-started
(periodic-attractor, full-period-averaged) antithetic estimator
measures — including every discretization effect: the vv integrator,
the comb noise grid, and the exact PSD conventions. Comparing it to
the continuum Landauer integral isolates the discretization bias
deterministically; comparing MD ensembles to it isolates pure
statistics. Cost is O(h (n^3 + N_v^2 m)) — instant for chains,
hours for the 2412-dof flagship (documented, not default).

All host-side numpy/complex128 (setup invariant). Validated end-to-end
by tests/test_exact_gle.py: per-line reconstruction against the real
sampler, and E[J] against warm-started MD ensembles and the Landauer
integral.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp


def _f64_system(system):
    """f64 clone with noise/factor leaves stripped (the linear
    map does not depend on them)."""
    sys0 = system.replace(baths=tuple(
        b.replace(noise=None, nevecs=None, nstd=None)
        for b in system.baths))

    def cast(x):
        a = np.asarray(x)
        return (a.astype(np.float64)
                if np.issubdtype(a.dtype, np.floating) else a)

    return jax.tree_util.tree_map(cast, sys0)


def linearize_step(system):
    """(A, B0, B1): the affine one-step operators of vv_step in the
    state_ravel basis; noise input is the concatenation of the baths'
    noise rows. f64 (jax.jacfwd under enable_x64 on the default
    device)."""
    from sclmd_jax.md import MDState, vv_step

    sys0 = _f64_system(system)
    nph, ml = sys0.nph, sys0.ml
    n = (2 + ml + 1) * nph
    ncs = [b.nc for b in sys0.baths]
    m = sum(ncs)
    offs = np.concatenate([[0], np.cumsum(ncs)]).astype(int)

    def stepv(x, xi0, xi1):
        rows = tuple((xi0[offs[i]:offs[i + 1]], xi1[offs[i]:offs[i + 1]])
                     for i in range(len(ncs)))
        st = MDState(t=jnp.asarray(0, jnp.int32),
                     p=x[:nph], q=x[nph:2 * nph],
                     phis=x[2 * nph:(2 + ml) * nph].reshape(ml, nph),
                     qhis=x[(2 + ml) * nph:].reshape(1, nph))
        new, out = vv_step(sys0, st, noise_rows=rows)
        vec = jnp.concatenate([new.p, new.q, new.phis.ravel(),
                               new.qhis.ravel()])
        return vec, out["cur"]

    with jax.enable_x64(True):
        z = (jnp.zeros((n,), jnp.float64), jnp.zeros((m,), jnp.float64),
             jnp.zeros((m,), jnp.float64))
        jac = jax.jit(jax.jacfwd(lambda *a: stepv(*a)[0],
                                 argnums=(0, 1, 2)))
        A, B0, B1 = (np.asarray(J, np.float64) for J in jac(*z))
    return A, B0, B1


def current_forms(system):
    """Stacked (nbaths, Nv, Nv) symmetric quadratic forms M_b with
    cur_b = v^T M_b v, v = [x; xi_t; xi_{t+1}] (host f64)."""
    from sclmd_jax.md import MDState, vv_step

    sys0 = _f64_system(system)
    nph, ml = sys0.nph, sys0.ml
    n = (2 + ml + 1) * nph
    ncs = [b.nc for b in sys0.baths]
    m = sum(ncs)
    offs = np.concatenate([[0], np.cumsum(ncs)]).astype(int)
    Nv = n + 2 * m

    def curv(v):
        x, xi0, xi1 = v[:n], v[n:n + m], v[n + m:]
        rows = tuple((xi0[offs[i]:offs[i + 1]], xi1[offs[i]:offs[i + 1]])
                     for i in range(len(ncs)))
        st = MDState(t=jnp.asarray(0, jnp.int32),
                     p=x[:nph], q=x[nph:2 * nph],
                     phis=x[2 * nph:(2 + ml) * nph].reshape(ml, nph),
                     qhis=x[(2 + ml) * nph:].reshape(1, nph))
        _, out = vv_step(sys0, st, noise_rows=rows)
        return out["cur"]

    with jax.enable_x64(True):
        H = jax.jit(jax.jacfwd(jax.jacrev(curv)))(
            jnp.zeros((Nv,), jnp.float64))
        H = np.asarray(H, np.float64)       # (nbaths, Nv, Nv)
    return 0.5 * (H + np.swapaxes(H, 1, 2)) / 2.0


def current_rank1_forms(system):
    """Per-bath factored current forms: cur_b(v) = (E_b v) . (G_b v).

    The per-step current is f_b . p with f_b supported on the bath's
    nc lead DOFs — a rank-nc bilinear form. E_b (nc, Nv) maps
    v = [x; xi_t; xi_{t+1}] to the lead components of the predictor
    bath force; G_b (nc, Nv) selects the pre-step lead velocities.
    Equivalent to ``current_forms`` (pinned by test) at
    O(nc Nv) per-line cost instead of O(Nv^2) — the difference between
    minutes and hours for the 2412-dof flagship.
    """
    from sclmd_jax.md import MDState, vv_step

    sys0 = _f64_system(system).replace(savef=True)
    nph, ml = sys0.nph, sys0.ml
    n = (2 + ml + 1) * nph
    ncs = [b.nc for b in sys0.baths]
    m = sum(ncs)
    offs = np.concatenate([[0], np.cumsum(ncs)]).astype(int)
    Nv = n + 2 * m
    cids = [np.asarray(b.cids) for b in sys0.baths]

    def leadf(v):
        x, xi0, xi1 = v[:n], v[n:n + m], v[n + m:]
        rows = tuple((xi0[offs[i]:offs[i + 1]], xi1[offs[i]:offs[i + 1]])
                     for i in range(len(ncs)))
        st = MDState(t=jnp.asarray(0, jnp.int32),
                     p=x[:nph], q=x[nph:2 * nph],
                     phis=x[2 * nph:(2 + ml) * nph].reshape(ml, nph),
                     qhis=x[(2 + ml) * nph:].reshape(1, nph))
        _, out = vv_step(sys0, st, noise_rows=rows)
        return jnp.concatenate([out["fbaths"][i][cids[i]]
                                for i in range(len(ncs))])

    with jax.enable_x64(True):
        E = np.asarray(jax.jit(jax.jacfwd(leadf))(
            jnp.zeros((Nv,), jnp.float64)), np.float64)
    Es, Gs = [], []
    for i in range(len(ncs)):
        Es.append(E[offs[i]:offs[i + 1]])
        G = np.zeros((ncs[i], Nv))
        G[np.arange(ncs[i]), cids[i]] = 1.0     # p rows of x
        Gs.append(G)
    return Es, Gs


def prepare_attractor(system):
    """One-time temperature-INDEPENDENT preparation for the Schur-path
    attractor expectation: the affine step operators, the factored
    current forms, and the complex Schur factorisation.

    The linear map and the current forms depend only on the system
    structure (dynamical matrix, friction kernels, dt) — never on the
    bath temperatures, whose only effect is the noise PSD factors. A
    conductance estimate therefore shares ONE prep across the forward
    and reversed (TL,TR)/(TR,TL) directions, and across classical vs
    quantum statistics of the same junction."""
    from scipy.linalg import schur

    A, B0, B1 = linearize_step(system)
    Es, Gs = current_rank1_forms(system)
    n = A.shape[0]
    m = sum(b.nc for b in system.baths)
    T, Q = schur(A.astype(np.complex128), output="complex")
    Qh = Q.conj().T
    return {
        "A": A, "B0": B0, "B1": B1, "Es": Es, "Gs": Gs,
        "T": T, "Q": Q,
        "K0": Qh @ B0, "K1": Qh @ B1,
        "EQ": [E[:, :n] @ Q for E in Es],
        "GQ": [G[:, :n] @ Q for G in Gs],
        "E0": [E[:, n:n + m] for E in Es],
        "E1": [E[:, n + m:] for E in Es],
    }


def _solve_shifted_triangular_batch(T, zs, Cs, block=64,
                                    scratch=None):
    """Solve (z I - T) Y = C for a BATCH of shifts z (T upper
    triangular, shared). ``Cs``: (nz, n, m).

    Two regimes (the crossover is the RHS width m):

    * m small (test-tier conductance problems, m = a few lead DOFs):
      blocked backward substitution — the diagonal blocks run a short
      scalar recurrence, everything above updates through one
      tensordot (BLAS GEMM) per block, the z axis riding along. The
      naive per-line loop spent its time materialising z*I - T
      (O(n^2) per line vs the O(n^2 m) solve).
    * m large (the 300-lead-DOF flagship): LAPACK ztrtrs per line on a
      REUSED matrix whose off-diagonal part is built once (only the
      diagonal is rewritten per line, n writes) — LAPACK's triangular
      kernel beats the python recurrence by ~3x at these shapes, and
      the solve itself dominates the eliminated construction.
    """
    from scipy.linalg import solve_triangular

    n = T.shape[0]
    m = Cs.shape[-1]
    if m >= 32:
        M = scratch if scratch is not None else -T.copy()
        d = np.diagonal(T).copy()
        Y = np.empty_like(Cs)
        step = n + 1
        for i, z in enumerate(zs):
            M.flat[::step] = z - d
            Y[i] = solve_triangular(M, Cs[i], lower=False,
                                    check_finite=False)
        return Y
    return _solve_shifted_subst(T, zs, Cs, block)


def _solve_shifted_subst(T, zs, Cs, block=64):
    n = T.shape[0]
    Y = np.empty_like(Cs)
    W = Cs.copy()
    i1 = n
    zcol = zs[:, None]
    while i1 > 0:
        i0 = max(0, i1 - block)
        for i in range(i1 - 1, i0 - 1, -1):
            if i + 1 < i1:
                acc = np.einsum("j,zjm->zm", T[i, i + 1:i1],
                                Y[:, i + 1:i1, :])
                Y[:, i, :] = (W[:, i, :] + acc) / (zcol - T[i, i])
            else:
                Y[:, i, :] = W[:, i, :] / (zcol - T[i, i])
        if i0 > 0:
            upd = np.tensordot(T[:i0, i0:i1], Y[:, i0:i1, :],
                               axes=([1], [1]))          # (i0, nz, m)
            W[:, :i0, :] += upd.transpose(1, 0, 2)
        i1 = i0
    return Y


def attractor_expected_currents(system, progress=False,
                                method="dense", prep=None,
                                line_chunk=None):
    """(nbaths,) exact expected full-period-average bath currents of
    the periodic attractor (see module docstring).

    ``system`` baths must carry host PSD factors (``prepare_noise``);
    the pytree may be any dtype — the computation runs host-f64.

    ``method``: "dense" — full (Nv, Nv) quadratic forms + one LU per
    line (small systems); "schur" — complex Schur factorisation of A
    once + z-batched blocked triangular solves with the rank-nc
    factored current forms: O(h n^2 m) total in GEMM-shaped batches,
    which makes the 2412-dof flagship tractable (minutes, vs days
    dense). ``prep``: optional ``prepare_attractor(system)`` output —
    temperature-independent, so one prep serves both directions of a
    conductance estimate.
    """
    if method == "schur":
        return _attractor_expected_schur(system, progress, prep=prep,
                                         line_chunk=line_chunk)
    baths = system.baths
    if any(getattr(b, "nstd", None) is None for b in baths):
        raise ValueError("baths must carry PSD factors: call "
                         "bath.prepare_noise() before building the "
                         "system")
    A, B0, B1 = linearize_step(system)
    M = current_forms(system)               # (nb, Nv, Nv)
    n = A.shape[0]
    ncs = [b.nc for b in baths]
    m = sum(ncs)
    nmd, dt = system.nmd, system.dt
    h = nmd // 2

    U = [np.asarray(b.nevecs, np.complex128) for b in baths]
    S = [np.asarray(b.nstd, np.float64) for b in baths]
    nb = len(baths)
    out = np.zeros(nb)
    eye = np.eye(n)
    for k in range(h + 1):
        th = 2.0 * np.pi * k / nmd
        z = np.exp(-1j * th)
        # P = [X; I; zI] @ blockdiag(U_k diag(s_k))
        P_noise = np.zeros((m, m), np.complex128)
        o = 0
        for i in range(nb):
            P_noise[o:o + ncs[i], o:o + ncs[i]] = U[i][k] * S[i][k]
            o += ncs[i]
        Bz = (B0 + z * B1) @ P_noise        # (n, m)
        X = np.linalg.solve(z * eye - A, Bz)
        P = np.concatenate([X, P_noise, z * P_noise], axis=0)  # (Nv, m)
        a = (1.0 if k in (0, h) else 2.0) / (nmd * dt)
        MP = np.einsum("bNV,Vk->bNk", M, P)
        herm = np.einsum("bNk,Nk->b", MP, np.conjugate(P)).real
        contrib = herm
        if k in (0, h):
            contrib = contrib + np.einsum("bNk,Nk->b", MP, P).real
        out += (a * a / 2.0) * contrib
        if progress and k % 1024 == 0:
            print(f"  exact_gle line {k}/{h}", flush=True)
    return out


def attractor_covariance(system, prep=None, line_chunk=None,
                         progress=False, block="q"):
    """Exact single-time covariance of the periodic attractor state.

    Same derivation as attractor_expected_currents (module docstring):
    the per-line periodic solution is X_k = (z_k I - A)^{-1}
    (B0 + z_k B1) P_k per unit standard normal, so

        E[x x^T] = sum_k (a_k^2 / 2) ( Re[X_k X_k^H]
                                       + delta_k Re[X_k X_k^T] ).

    ``block``: "q" (default) returns the (nph, nph) position block —
    the smearing covariance for the SCP renormalized Hessian
    (ops.anharmonic): it is the distribution the warm harmonic MD
    ensemble ACTUALLY samples, with the friction broadening and the
    finite noise comb included. In particular ultra-soft junction
    modes (below or between comb lines) get their true, finite
    attractor variance — not the divergent kT/w^2 of the isolated-mode
    continuum formula. "p" returns the momentum block, "x" the full
    state. Host-f64, Schur path; cost is comparable to one
    expected-currents evaluation at the same tier.
    """
    baths = system.baths
    if any(getattr(b, "nstd", None) is None for b in baths):
        raise ValueError("baths must carry PSD factors: call "
                         "bath.prepare_noise() before building the "
                         "system")
    if prep is None:
        prep = prepare_attractor(system)
    T, Q = prep["T"], prep["Q"]
    K0, K1 = prep["K0"], prep["K1"]
    n = T.shape[0]
    ncs = [b.nc for b in baths]
    m = sum(ncs)
    nph = system.nph
    rows = {"q": slice(nph, 2 * nph), "p": slice(0, nph),
            "x": slice(0, n)}[block]
    Qr = Q[rows, :]
    nr = Qr.shape[0]
    if line_chunk is None:
        line_chunk = int(max(8, min(256, 1.5e9 / (n * m * 16 * 4))))
    nmd, dt = system.nmd, system.dt
    h = nmd // 2

    U = [np.asarray(b.nevecs, np.complex128) for b in baths]
    S = [np.asarray(b.nstd, np.float64) for b in baths]
    offs = np.concatenate([[0], np.cumsum(ncs)]).astype(int)
    C = np.zeros((nr, nr))
    for k0 in range(0, h + 1, line_chunk):
        ks = np.arange(k0, min(k0 + line_chunk, h + 1))
        nz = len(ks)
        zs = np.exp(-2j * np.pi * ks / nmd)
        Pn = np.zeros((nz, m, m), np.complex128)
        for i in range(len(baths)):
            sl = slice(offs[i], offs[i + 1])
            Pn[:, sl, sl] = U[i][ks] * S[i][ks][:, None, :]
        KP0 = np.tensordot(K0, Pn, axes=([1], [1]))      # (n, nz, m)
        KP1 = np.tensordot(K1, Pn, axes=([1], [1]))
        Cs = (KP0 + zs[None, :, None] * KP1).transpose(1, 0, 2)
        Y = _solve_shifted_triangular_batch(T, zs, Cs)   # (nz, n, m)
        X = np.tensordot(Qr, Y, axes=([1], [1]))          # (nr, nz, m)
        a = np.where((ks == 0) | (ks == h), 1.0, 2.0) / (nmd * dt)
        w = a * a / 2.0
        C += np.einsum("z,izm,jzm->ij", w, X, np.conj(X)).real
        pseudo = np.where((ks == 0) | (ks == h), w, 0.0)
        if pseudo.any():
            C += np.einsum("z,izm,jzm->ij", pseudo, X, X).real
        if progress:
            print(f"  exact_gle(cov) line {ks[-1]}/{h}", flush=True)
    return 0.5 * (C + C.T)


def _attractor_expected_schur(system, progress=False, prep=None,
                              line_chunk=None):
    """Schur + rank-factored-form evaluation of the same sum (see
    attractor_expected_currents), z-BATCHED: comb lines are processed
    in chunks of ``line_chunk`` through one blocked triangular solve
    and GEMM-shaped contractions (the naive per-line loop spent its
    time materialising z*I - T per line)."""
    baths = system.baths
    if any(getattr(b, "nstd", None) is None for b in baths):
        raise ValueError("baths must carry PSD factors: call "
                         "bath.prepare_noise() before building the "
                         "system")
    if prep is None:
        prep = prepare_attractor(system)
    T = prep["T"]
    K0, K1 = prep["K0"], prep["K1"]
    EQ, GQ, E0, E1 = prep["EQ"], prep["GQ"], prep["E0"], prep["E1"]
    n = T.shape[0]
    ncs = [b.nc for b in baths]
    m = sum(ncs)
    if line_chunk is None:
        # bound the (nz, n, m) complex transients (~4 live copies) to
        # ~1.5 GB — the flagship (n=2412, m=300) then batches 32 lines
        line_chunk = int(max(8, min(256, 1.5e9 / (n * m * 16 * 4))))
    nb = len(baths)
    nmd, dt = system.nmd, system.dt
    h = nmd // 2

    U = [np.asarray(b.nevecs, np.complex128) for b in baths]
    S = [np.asarray(b.nstd, np.float64) for b in baths]
    offs = np.concatenate([[0], np.cumsum(ncs)]).astype(int)
    out = np.zeros(nb)
    for k0 in range(0, h + 1, line_chunk):
        ks = np.arange(k0, min(k0 + line_chunk, h + 1))
        nz = len(ks)
        zs = np.exp(-2j * np.pi * ks / nmd)
        # per-line block-diagonal noise factor P_k (nz, m, m)
        Pn = np.zeros((nz, m, m), np.complex128)
        for i in range(nb):
            sl = slice(offs[i], offs[i + 1])
            # U may be a zero-stride broadcast view (proportional
            # spectra) — fancy-indexing materialises only the chunk
            Pn[:, sl, sl] = U[i][ks] * S[i][ks][:, None, :]
        # C_k = (K0 + z_k K1) @ P_k
        KP0 = np.tensordot(K0, Pn, axes=([1], [1]))      # (n, nz, m)
        KP1 = np.tensordot(K1, Pn, axes=([1], [1]))
        Cs = (KP0 + zs[None, :, None] * KP1).transpose(1, 0, 2)
        Y = _solve_shifted_triangular_batch(T, zs, Cs)   # (nz, n, m)
        a = np.where((ks == 0) | (ks == h), 1.0, 2.0) / (nmd * dt)
        pseudo = (ks == 0) | (ks == h)
        w = a * a / 2.0
        for b in range(nb):
            EP = np.tensordot(EQ[b], Y, axes=([1], [1]))  # (nc, nz, m)
            EP = EP.transpose(1, 0, 2)
            EP += np.tensordot(E0[b], Pn, axes=([1], [1])).transpose(
                1, 0, 2)
            EP += zs[:, None, None] * np.tensordot(
                E1[b], Pn, axes=([1], [1])).transpose(1, 0, 2)
            GP = np.tensordot(GQ[b], Y, axes=([1], [1])).transpose(
                1, 0, 2)
            c = np.real(np.sum(EP * np.conj(GP), axis=(1, 2)))
            c = c + pseudo * np.real(np.sum(EP * GP, axis=(1, 2)))
            out[b] += float(np.sum(w * c))
        if progress:
            print(f"  exact_gle(schur) line {ks[-1]}/{h}", flush=True)
    return out
