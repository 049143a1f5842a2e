"""Core numerics shared by the noise, bath, MD and NEGF stacks.

Vectorised jnp re-derivations of the reference's scalar helpers
(/root/reference/sclmd/functions.py). Every function here is traceable,
batched, and safe under jit; the Bose / Fourier normalisation conventions
follow the reference exactly:

* Fourier pair (functions.py:17-53):
    F[f](w)  = int f(t) e^{+iwt} dt      -> ``np.fft.ifft(a) * N * dt``
    F^-1(t)  = int f(w) e^{-iwt} dw/2pi  -> ``np.fft.fft(a) / (N * dt)``
* Bose edges (functions.py:80-99): T=0 gives -1 for w<0, 0 for w>=0;
  T>0 gives 0 at w=0.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from sclmd_jax import units as U


# ---------------------------------------------------------------------------
# Fourier transform conventions
# ---------------------------------------------------------------------------
def fourier_t2w(a: jax.Array, dt: float, axis: int = 0) -> jax.Array:
    """f(w) = int f(t) e^{iwt} dt on an N-point grid (functions.py:17-34).

    Equals ``ifft(a) * (2 pi / dw)`` with dw = 2 pi / (N dt), i.e.
    ``ifft(a) * N * dt``.
    """
    n = a.shape[axis]
    return jnp.fft.ifft(a, axis=axis) * (n * dt)


def fourier_w2t(a: jax.Array, dt: float, axis: int = 0) -> jax.Array:
    """f(t) = int f(w) e^{-iwt} dw / 2pi (functions.py:36-53).

    Equals ``fft(a) * dw / 2pi = fft(a) / (N dt)``.
    """
    n = a.shape[axis]
    return jnp.fft.fft(a, axis=axis) / (n * dt)


class myfft:
    """Object-style wrapper mirroring the reference ``myfft`` API."""

    def __init__(self, dt: float, n: int):
        self.dt = dt
        self.N = n
        self.dw = 2.0 * np.pi / dt / n

    def Fourier1D(self, a):
        a = jnp.asarray(a)
        if a.shape[0] != self.N:
            raise ValueError("myfft.Fourier1D: array length error")
        return fourier_t2w(a, self.dt, axis=0)

    def iFourier1D(self, a):
        a = jnp.asarray(a)
        if a.shape[0] != self.N:
            raise ValueError("myfft.iFourier1D: array length error")
        return fourier_w2t(a, self.dt, axis=0)


# ---------------------------------------------------------------------------
# Occupation factors
# ---------------------------------------------------------------------------
def coth(x):
    return jnp.cosh(x) / jnp.sinh(x)


def xcoth(x):
    """x * coth(x) with the x=0 limit equal to 1 (functions.py:70-77)."""
    x = jnp.asarray(x)
    safe = jnp.where(x == 0.0, 1.0, x)
    return jnp.where(x == 0.0, 1.0, safe * jnp.cosh(safe) / jnp.sinh(safe))


def bose(w, T, xp=jnp):
    """Bose-Einstein occupation with the reference's edge conventions.

    functions.py:80-99: at T=0 returns -1 for w<0 and 0 for w>=0; at T>0
    returns 0 at w=0 and 1/(e^{w/kT}-1) otherwise. Fully vectorised in both
    ``w`` and ``T``. ``xp`` selects the array backend (jnp on device,
    numpy for host-side setup).
    """
    w = xp.asarray(w, dtype=xp.result_type(float, w))
    T = xp.asarray(T, dtype=w.dtype)
    t_zero = T == 0.0
    # T == 0 branch: -1 for w < 0, else 0
    b0 = xp.where(w < 0.0, -1.0, 0.0)
    # T > 0 branch, guarded against division by zero
    T_safe = xp.where(t_zero, 1.0, T)
    with np.errstate(over="ignore"):
        x = w / (U.KB * T_safe)
        x_safe = xp.where(w == 0.0, 1.0, x)
        bT = xp.where(w == 0.0, 0.0, 1.0 / xp.expm1(x_safe))
    return xp.where(t_zero, b0, bT)


def fermi(ep, mu, T, xp=jnp):
    """Fermi-Dirac occupation (functions.py:102-114); T=0 step with 0.5 at mu."""
    ep = xp.asarray(ep, dtype=xp.result_type(float, ep))
    T = xp.asarray(T, dtype=ep.dtype)
    t_zero = T == 0.0
    f0 = xp.where(ep < mu, 1.0, xp.where(ep > mu, 0.0, 0.5))
    T_safe = xp.where(t_zero, 1.0, T)
    with np.errstate(over="ignore"):
        x = (ep - mu) / (U.KB * T_safe)
        fT = 1.0 / (xp.exp(x) + 1.0)
    return xp.where(t_zero, f0, fT)


def equ_spectrum(w, cut, T, classical: bool = False, zpmotion: bool = True,
                 xp=jnp):
    """Equilibrium noise weight 2 hw (n_B(hw,T) + zp) with band cutoff.

    Mirrors noise.py:249-270 ``equ()``: returns 2 kT in the classical limit
    or at w=0, and 0 for hw >= cut (strict ``hw < cut`` window). ``w`` may
    be any shape; ``classical``/``zpmotion`` are static Python bools.
    """
    w = xp.asarray(w, dtype=xp.result_type(float, w))
    hw = U.HBAR * w
    inside = hw < cut
    if classical:
        val = xp.full_like(hw, 2.0 * U.KB) * T
    else:
        zp = 0.5 if zpmotion else 0.0
        quantum = 2.0 * hw * (zp + bose(hw, T, xp=xp))
        val = xp.where(hw == 0.0, 2.0 * U.KB * T, quantum)
    return xp.where(inside, val, 0.0)


def nonequ_spectrum(w, bias, T, sign: int, classical: bool = False,
                    xp=jnp):
    """Bias-shifted nonequilibrium weight 2(hw +/- V)(n(hw +/- V) - n(hw)).

    Mirrors noise.py:211-246 ``nonequm``/``nonequp``; ``sign`` is -1 for the
    minus branch and +1 for the plus branch.
    """
    w = xp.asarray(w, dtype=xp.result_type(float, w))
    hw1 = U.HBAR * w + sign * bias
    hw2 = U.HBAR * w
    if classical:
        small = 10e-20
        hw1s = xp.where(hw1 == 0.0, small, hw1)
        hw2s = xp.where(hw2 == 0.0, small, hw2)
        return 2.0 * hw1s * (U.KB * T / hw1s - U.KB * T / hw2s)
    return 2.0 * hw1 * (bose(hw1, T, xp=xp) - bose(hw2, T, xp=xp))


# ---------------------------------------------------------------------------
# Interpolation
# ---------------------------------------------------------------------------
def flinterp(x, xs, ys):
    """Nearest-anchored linear interpolation matching functions.py:117-143.

    Linear between the nearest grid point and its neighbour on the side of
    ``x``; constant (clamped) when the nearest point is the first or last
    grid node. ``ys`` may have trailing matrix dimensions (n, ...); ``x``
    may be a scalar or a vector (batched over the leading axis).
    """
    xs = jnp.asarray(xs)
    ys = jnp.asarray(ys)
    n = xs.shape[0]

    def _one(xv):
        i = jnp.argmin(jnp.abs(xs - xv))
        dd = xv - xs[i]
        j = jnp.where(dd < 0, i - 1, i + 1)
        j = jnp.clip(j, 0, n - 1)
        denom = xs[i] - xs[j]
        denom = jnp.where(denom == 0.0, 1.0, denom)
        slope_term = dd / denom
        val = ys[i] + slope_term * (ys[i] - ys[j])
        edge = (i == 0) | (i == n - 1)
        return jnp.where(edge, ys[i], val)

    xv = jnp.asarray(x)
    if xv.ndim == 0:
        return _one(xv)
    return jax.vmap(_one)(xv)


def nearest(b, bs):
    """Index of the element of ``bs`` closest to ``b`` (functions.py:137-143)."""
    return int(np.argmin(np.abs(np.asarray(bs) - b)))


# ---------------------------------------------------------------------------
# History shift and small matrix helpers
# ---------------------------------------------------------------------------
def rpadleft(hist: jax.Array, newest: jax.Array) -> jax.Array:
    """Push ``newest`` onto the front of a newest-first ring (functions.py:146-153)."""
    if hist.shape[0] == 1:
        return newest[None]
    return jnp.concatenate([newest[None], hist[:-1]], axis=0)


def mdot(*args):
    out = args[0]
    for m in args[1:]:
        out = jnp.dot(out, m)
    return out


# reference alias (functions.py:159-164 has both mdot and mm)
mm = mdot


def chkShape(a) -> int:
    a = np.asarray(a)
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        raise ValueError("matrix must be square, got shape %s" % (a.shape,))
    return a.shape[0]


def symmetrize(a):
    a = jnp.asarray(a)
    return 0.5 * (a + a.T)


def antisymmetrize(a):
    a = jnp.asarray(a)
    return 0.5 * (a - a.T)


def dagger(a):
    return jnp.conjugate(jnp.asarray(a)).T


def hermitianize(a, xp=jnp):
    """0.5 (A + A^dagger); batched over leading axes."""
    a = xp.asarray(a)
    return 0.5 * (a + xp.conjugate(xp.swapaxes(a, -1, -2)))


def flinterp_np(x, xs, ys):
    """NumPy twin of ``flinterp`` for host-side setup paths."""
    xs = np.asarray(xs)
    ys = np.asarray(ys)
    x = np.atleast_1d(np.asarray(x, dtype=float))
    n = xs.shape[0]
    i = np.argmin(np.abs(xs[None, :] - x[:, None]), axis=1)
    dd = x - xs[i]
    j = np.clip(np.where(dd < 0, i - 1, i + 1), 0, n - 1)
    denom = xs[i] - xs[j]
    denom = np.where(denom == 0.0, 1.0, denom)
    extra = (Ellipsis,) + (None,) * (ys.ndim - 1)
    val = ys[i] + (dd / denom)[extra] * (ys[i] - ys[j])
    edge = (i == 0) | (i == n - 1)
    val[edge] = ys[i[edge]]
    return val


# ---------------------------------------------------------------------------
# Power spectra
# ---------------------------------------------------------------------------
def powerspecp(ps, dt: float, nmd: int):
    """Velocity power spectrum (functions.py:221-237).

    ``ps`` has shape (nmd, nph). Returns (nmd, 2) rows of
    [w_i, sum_dof |v(w_i)|^2 / (dt nmd)]; integrating column 1 over
    (0, wmax)/2pi gives the kinetic energy.
    """
    ps = jnp.asarray(ps)
    if ps.shape[0] != nmd:
        raise ValueError("powerspecp: ps shape error")
    dw = 2.0 * np.pi / dt / nmd
    vw = fourier_t2w(ps, dt, axis=0)            # (nmd, nph) complex
    mag = jnp.sum(jnp.real(vw * jnp.conjugate(vw)), axis=1) / (dt * nmd)
    w = dw * jnp.arange(nmd, dtype=ps.dtype)
    return jnp.stack([w, mag], axis=1)


def powerspecq(qs, dt: float, nmd: int):
    """Displacement power spectrum (functions.py:203-218): w^2 |q(w)|^2."""
    qs = jnp.asarray(qs)
    if qs.shape[0] != nmd:
        raise ValueError("powerspecq: qs shape error")
    dw = 2.0 * np.pi / dt / nmd
    qw = fourier_t2w(qs, dt, axis=0)
    mag = jnp.sum(jnp.real(qw * jnp.conjugate(qw)), axis=1) / (dt * nmd)
    w = dw * jnp.arange(nmd, dtype=qs.dtype)
    return jnp.stack([w, w**2 * mag], axis=1)
