"""Quantum colored-noise synthesis, batched on the device.

Reimplements /root/reference/sclmd/noise.py as one fused pipeline:

1. build ALL half-spectrum PSD matrices at once as a (hlen+1, nc, nc)
   Hermitian batch (reference loops per frequency, noise.py:73,171);
2. one batched ``eigh``;
3. sample every frequency's multivariate Gaussian with a single
   ``jax.random.normal`` call (reference: per-frequency ``vargau``,
   noise.py:273-305);
4. Hermitian-mirror to the full spectrum and inverse-FFT all DOF columns
   in one shot (noise.py:88-100).

The PSD conventions (the ``delta = dt*nmd`` Dirac factor, the ``equ``
band cutoff, and the bias-shifted nonequilibrium parts) follow
noise.py:66,149-206 exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from sclmd_jax import units as U
from sclmd_jax.ops.functions import (
    equ_spectrum,
    flinterp,
    flinterp_np,
    fourier_w2t,
    hermitianize,
)


def _check_even(nmd: int):
    if nmd % 2 != 0:
        raise ValueError(
            f"nmd must be even for the Hermitian-mirror noise synthesis "
            f"(got {nmd}); the reference's myfft length check catches "
            "the same case")


def halfspectrum_freqs(dt: float, nmd: int, dtype=jnp.float32) -> jax.Array:
    """Positive-frequency grid w_i = i * dw, i = 0..nmd/2 (noise.py:64-77)."""
    _check_even(nmd)
    hlen = nmd // 2
    dw = 2.0 * np.pi / dt / nmd
    return dw * jnp.arange(hlen + 1, dtype=dtype)


def electron_psd(wl, efric, exim, exip, bias, T, ecut,
                 classical: bool = False, zpmotion: bool = True,
                 delta: float = 1.0, xp=jnp) -> jax.Array:
    """Electron-bath noise PSD matrices on the grid ``wl``.

    S(w) = d * [ a(w) efric
                 + (-a(w) + (a(w-V) + a(w+V))/2) * exip / ... ]   (see below)

    following noise.py:169-186: equilibrium part a(w)*efric, and the two
    bias-shifted parts -0.5 a exip + 0.5 a(w∓V) (exip ± i exim).
    Returns a complex Hermitian batch of shape wl.shape + (nc, nc).
    """
    wl = xp.asarray(wl)
    efric = xp.asarray(efric)
    exip = xp.asarray(exip)
    exim = xp.asarray(exim)
    # equ_spectrum takes a FREQUENCY (it applies HBAR internally), so the
    # bias shift enters as w -+ V/hbar (noise.py:174-185). All three call
    # sites are dimensionally consistent for any HBAR.
    aw = delta * equ_spectrum(wl, ecut, T, classical, zpmotion, xp=xp)
    awm = delta * equ_spectrum(wl - bias / U.HBAR, ecut, T, classical,
                               zpmotion, xp=xp)
    awp = delta * equ_spectrum(wl + bias / U.HBAR, ecut, T, classical,
                               zpmotion, xp=xp)

    aw_ = aw[..., None, None]
    awm_ = awm[..., None, None]
    awp_ = awp[..., None, None]
    cplx = xp.result_type(efric.dtype, xp.complex64)
    amat = (aw_ * efric
            + (-aw_ + 0.5 * (awm_ + awp_)) * exip
            + 0.5j * (awm_ - awp_) * exim.astype(cplx))
    return hermitianize(amat.astype(cplx), xp=xp)


def phonon_psd(wl, gamma, gwl, T, phcut,
               classical: bool = False, zpmotion: bool = True,
               delta: float = 1.0, xp=jnp) -> jax.Array:
    """Phonon-bath noise PSD: d * equ(w) * Gamma(w) (noise.py:73-79).

    ``gamma`` is the friction kernel table (ngw, nc, nc) on grid ``gwl``;
    it is linearly interpolated onto ``wl`` with the reference's
    nearest-anchored scheme.
    """
    wl = xp.asarray(wl)
    gamma = xp.asarray(gamma)
    aw = delta * equ_spectrum(wl, phcut, T, classical, zpmotion, xp=xp)
    interp = flinterp if xp is jnp else flinterp_np
    gw = interp(wl, xp.asarray(gwl), gamma)     # (nw, nc, nc)
    cplx = xp.result_type(gamma.dtype, xp.complex64)
    return hermitianize((aw[..., None, None] * gw).astype(cplx), xp=xp)


def noise_factors(psd, dtype=None):
    """Host-side factorisation of the PSD batch: (evecs, std).

    The eigendecomposition runs ONCE in float64 on the host
    (np.linalg.eigh), independent of trajectory count — per-trajectory
    sampling then needs only a matmul + FFT on device. This keeps
    ``eigh`` out of the sampling graph (a batched complex64 eigh is
    inaccurate) without changing the sampled statistics:
    std = sqrt(clip(eigenvalues, 0)) exactly as ``vargau``
    (noise.py:297-303).

    Fast path: when the batch is frequency-PROPORTIONAL, S(w) =
    c(w) S_ref (every wideband/Debye/scalar-profile bath: the
    equilibrium weight multiplies one constant matrix), the
    eigenvectors are frequency-independent — ONE nc x nc eigh replaces
    nmd/2 of them (the 864-DOF large-junction setup drops from minutes
    to milliseconds). The structure is verified numerically before use
    and only engaged for nc >= 8 (small baths keep the bit-exact
    historical factors).
    """
    psd_np = np.asarray(psd).astype(np.complex128)
    nw, nc = psd_np.shape[0], psd_np.shape[-1]
    if nc >= 8 and nw > 4:
        norms = np.linalg.norm(psd_np.reshape(nw, -1), axis=1)
        r = int(np.argmax(norms))
        if norms[r] > 0:
            ref = psd_np[r]
            ref2 = float(np.vdot(ref, ref).real)
            c = np.real(np.einsum("wij,ij->w", psd_np, np.conjugate(ref))
                        ) / ref2
            resid = psd_np - c[:, None, None] * ref[None]
            tol = 1e-12 * norms[r]
            if (np.abs(resid).reshape(nw, -1).max(axis=1)
                    <= np.maximum(tol, 1e-13 * norms[r])).all() \
                    and (c >= -1e-15).all():
                ev0, evec0 = np.linalg.eigh(ref)
                ev = np.clip(c, 0.0, None)[:, None] * \
                    np.clip(ev0, 0.0, None)[None, :]
                std = np.sqrt(ev)
                if dtype is not None:
                    cplx = np.complex128 if dtype in (jnp.float64,
                                                      np.float64) \
                        else np.complex64
                    evec0 = evec0.astype(cplx)
                    std = std.astype(dtype)
                # zero-stride broadcast view: one (nc, nc) matrix in
                # memory regardless of nw. Consumers that need the
                # frequency axis (host einsum) handle the view; device
                # sampling detects it (sample_noise_dev) and ships only
                # the single matrix.
                return np.broadcast_to(evec0, psd_np.shape), std
    ev, evec = np.linalg.eigh(psd_np)
    std = np.sqrt(np.clip(ev, 0.0, None))
    if dtype is not None:
        cplx = np.complex128 if dtype in (jnp.float64, np.float64) \
            else np.complex64
        return evec.astype(cplx), std.astype(dtype)
    return evec, std


from functools import partial as _partial, wraps as _wraps


def _highest_precision(fn):
    """Trace ``fn`` under HIGHEST matmul precision: at default precision
    a float32 contraction may run in TF32, which would bend the sampled
    spectrum (see md.vv_step)."""
    @_wraps(fn)
    def traced(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)
    return traced


@_partial(jax.jit, static_argnames=("dt", "nmd"))
@_highest_precision
def sample_noise(key: jax.Array, evecs, std, dt: float,
                 nmd: int) -> jax.Array:
    """Real (nmd, nc) noise series from precomputed factors (one jit,
    dt/nmd static)."""
    _check_even(nmd)
    evecs = jnp.asarray(evecs)
    std = jnp.asarray(std)
    r = jax.random.normal(key, std.shape, dtype=std.dtype) * std
    xi_pos = jnp.einsum("...ij,...j->...i", evecs, r.astype(evecs.dtype))
    xi = mirror_halfspectrum(xi_pos, nmd)
    return jnp.real(fourier_w2t(xi, dt, axis=0))


@_partial(jax.jit, static_argnames=("dt", "nmd"))
@_highest_precision
def sample_noise_parts(key: jax.Array, evecs_re, evecs_im, std,
                       dt: float, nmd: int) -> jax.Array:
    """``sample_noise`` with the PSD eigenvectors split into real/imag
    float arrays, reassembled in-graph: the same (re, im) factor
    triples feed this sampler, ``sample_noise_prop`` and the windowed
    ``sample_noise_window`` (vmap over keys for ensembles)."""
    _check_even(nmd)
    evecs_re = jnp.asarray(evecs_re)
    cplx = jnp.result_type(evecs_re.dtype, jnp.complex64)
    evecs = evecs_re.astype(cplx) + 1j * jnp.asarray(evecs_im).astype(cplx)
    std = jnp.asarray(std)
    r = jax.random.normal(key, std.shape, dtype=std.dtype) * std
    xi_pos = jnp.einsum("...ij,...j->...i", evecs, r.astype(evecs.dtype))
    xi = mirror_halfspectrum(xi_pos, nmd)
    return jnp.real(fourier_w2t(xi, dt, axis=0))


@_partial(jax.jit, static_argnames=("dt", "nmd"))
@_highest_precision
def sample_noise_prop(key: jax.Array, evec_re, evec_im, std,
                      dt: float, nmd: int) -> jax.Array:
    """``sample_noise`` for frequency-PROPORTIONAL PSD batches.

    When S(w) = c(w) S_ref (every wideband/Debye/scalar-profile bath —
    see ``noise_factors``), the eigenvector matrix is frequency-
    independent: ONE (nc, nc) real/imag pair replaces the (nw, nc, nc)
    batch. The host keeps the factors as a zero-stride broadcast view;
    shipping that view through a device boundary would materialise
    nw copies (gigabytes for large baths), so this entry point takes
    the single matrix instead. Statistics are identical to
    ``sample_noise`` — only the per-frequency matmul collapses into one
    (nw, nc) @ (nc, nc) product.
    """
    _check_even(nmd)
    evec_re = jnp.asarray(evec_re)
    cplx = jnp.result_type(evec_re.dtype, jnp.complex64)
    evec = evec_re.astype(cplx) + 1j * jnp.asarray(evec_im).astype(cplx)
    std = jnp.asarray(std)
    r = jax.random.normal(key, std.shape, dtype=std.dtype) * std
    xi_pos = r.astype(cplx) @ evec.T
    xi = mirror_halfspectrum(xi_pos, nmd)
    return jnp.real(fourier_w2t(xi, dt, axis=0))


@_partial(jax.jit, static_argnames=("dt", "nmd", "seg", "fchunk"))
@_highest_precision
def sample_noise_window(key: jax.Array, evecs_re, evecs_im, std,
                        dt: float, nmd: int, t0, seg: int,
                        fchunk: int = 2048) -> jax.Array:
    """Rows [t0, t0+seg) of the EXACT series ``sample_noise_parts``
    would produce for the same key — without materialising the full
    (nmd, nc) time series.

    This is the sequence-axis (SP/CP) streaming primitive: for the
    reference workload's nmd = 2e5 noise arrays
    (ref examples/current-induced/rundp.py:43; SURVEY.md hard part
    "noise ... must stream from HBM or be regenerated in chunks"), a
    trajectory's resident noise shrinks from (nmd, nc) to (seg, nc) —
    the Gaussian draws are regenerated from the key each window and the
    inverse FFT is evaluated only on the window's rows as a
    paired-frequency cosine sum:

        x_k = [Re xi_0 + (-1)^k Re xi_h
               + 2 sum_{m=1}^{h-1} (Re xi_m cos(th k m)
                                    + Im xi_m sin(th k m))] / (nmd dt)

    (th = 2pi/nmd, h = nmd/2 — the m and nmd-m terms of the mirrored
    spectrum pair into the real cosine/sine sums). The frequency axis is
    scanned in ``fchunk`` slices so the (seg, hlen) phase table never
    materialises. ``t0`` is TRACED — one compiled program serves every
    window of a segmented run.

    Requires power-of-two ``nmd``: the phase k*m mod nmd is computed in
    wrapping uint32 arithmetic (exact when nmd divides 2^32), keeping
    full precision at k*m ~ 1e10 where float phases would be garbage.

    ``evecs_re/evecs_im``: (hlen+1, nc, nc) factor batch, or a single
    (nc, nc) matrix for frequency-proportional spectra (the
    ``sample_noise_prop`` fast path).
    """
    _check_even(nmd)
    if nmd & (nmd - 1):
        raise ValueError(f"sample_noise_window needs power-of-two nmd "
                         f"(got {nmd}) for exact uint32 phase wrapping")
    hlen = nmd // 2
    std = jnp.asarray(std)
    rdt = std.dtype
    r = jax.random.normal(key, std.shape, dtype=rdt) * std
    evecs_re = jnp.asarray(evecs_re)
    evecs_im = jnp.asarray(evecs_im)
    if evecs_re.ndim == 2:        # frequency-proportional single matrix
        xr = r @ evecs_re.T
        xi = r @ evecs_im.T
    else:
        xr = jnp.einsum("wij,wj->wi", evecs_re, r)
        xi = jnp.einsum("wij,wj->wi", evecs_im, r)

    ks_i = (jnp.asarray(t0, jnp.uint32) +
            jnp.arange(seg, dtype=jnp.uint32))
    theta = rdt.type(2.0 * np.pi / nmd)
    sign = jnp.where((ks_i & 1) == 0, rdt.type(1.0), rdt.type(-1.0))
    acc = xr[0][None, :] + sign[:, None] * xr[hlen][None, :]

    nm = hlen - 1                 # paired frequencies m = 1 .. hlen-1
    nch = max(1, -(-nm // fchunk))
    pad = nch * fchunk - nm
    xr_m = jnp.pad(xr[1:hlen], ((0, pad), (0, 0)))
    xi_m = jnp.pad(xi[1:hlen], ((0, pad), (0, 0)))
    ms = jnp.pad(jnp.arange(1, hlen, dtype=jnp.uint32), (0, pad))
    mask = jnp.asarray(nmd - 1, jnp.uint32)

    def body(carry, inp):
        m_c, xr_c, xi_c = inp
        km = (ks_i[:, None] * m_c[None, :]) & mask     # exact mod nmd
        ph = theta * km.astype(rdt)
        return carry + 2.0 * (jnp.cos(ph) @ xr_c +
                              jnp.sin(ph) @ xi_c), None

    acc, _ = jax.lax.scan(
        body, acc, (ms.reshape(nch, fchunk),
                    xr_m.reshape(nch, fchunk, -1),
                    xi_m.reshape(nch, fchunk, -1)))
    return acc / (nmd * dt)


@_partial(jax.jit, static_argnames=("dt", "nmd"))
def _batch_parts(keys, evr, evi, std, dt, nmd):
    return jax.vmap(lambda k: sample_noise_parts(k, evr, evi, std,
                                                 dt, nmd))(keys)


@_partial(jax.jit, static_argnames=("dt", "nmd"))
def _batch_prop(keys, evr, evi, std, dt, nmd):
    return jax.vmap(lambda k: sample_noise_prop(k, evr, evi, std,
                                                dt, nmd))(keys)


def sample_noise_dev_batch(bath, keys: jax.Array) -> jax.Array:
    """Batched ``sample_noise_dev`` (vmap over keys) through ONE cached
    module-level jit, so ensemble noise regeneration never re-traces
    the vmapped sampler."""
    ev = np.asarray(bath.nevecs)
    std = np.asarray(bath.nstd)
    if ev.ndim == 3 and ev.strides[0] == 0:
        ev0 = np.ascontiguousarray(ev[0])
        return _batch_prop(keys, np.ascontiguousarray(ev0.real),
                           np.ascontiguousarray(ev0.imag), std,
                           float(bath.dt), int(bath.nmd))
    return _batch_parts(keys, np.ascontiguousarray(ev.real),
                        np.ascontiguousarray(ev.imag), std,
                        float(bath.dt), int(bath.nmd))


def sample_noise_dev(bath, key: jax.Array) -> jax.Array:
    """Device-side noise sampling from a bath's host-precomputed factors.

    Dispatcher: the complex eigenvector factor is split into real/imag
    float arrays and reassembled in-graph (``sample_noise_parts``);
    frequency-proportional factor batches
    (zero-stride broadcast views from ``noise_factors``) route through
    ``sample_noise_prop`` with a single (nc, nc) matrix instead of
    materialising the broadcast. Returns the real (nmd, nc) series.
    """
    ev = np.asarray(bath.nevecs)
    std = np.asarray(bath.nstd)
    if ev.ndim == 3 and ev.strides[0] == 0:
        ev0 = np.ascontiguousarray(ev[0])
        return sample_noise_prop(key, np.ascontiguousarray(ev0.real),
                                 np.ascontiguousarray(ev0.imag), std,
                                 bath.dt, bath.nmd)
    return sample_noise_parts(key, np.ascontiguousarray(ev.real),
                              np.ascontiguousarray(ev.imag), std,
                              bath.dt, bath.nmd)


def sample_noise_np(rng: np.random.Generator, evecs, std, dt: float,
                    nmd: int) -> np.ndarray:
    """Host NumPy twin of ``sample_noise`` (float64).

    Same statistics; used for deterministic host-side reproduction
    and as the tests' reference.
    """
    _check_even(nmd)
    evecs = np.asarray(evecs)
    std = np.asarray(std, np.float64)
    r = rng.standard_normal(std.shape) * std
    xi_pos = np.einsum("wij,wj->wi", evecs.astype(np.complex128), r)
    hlen = nmd // 2
    neg = np.conjugate(xi_pos[1:hlen + 1][::-1])
    xi = np.concatenate([xi_pos[:hlen], neg], axis=0)
    return np.real(np.fft.fft(xi, axis=0) / (nmd * dt))


@_highest_precision
def sample_from_psd(key: jax.Array, psd: jax.Array) -> jax.Array:
    """Frequency-domain noise vectors xi(w) = U(w) r(w) from PSD matrices.

    ``psd``: (nw, nc, nc) Hermitian. For each frequency, r is a REAL normal
    vector with variance given by the (clipped-at-zero) eigenvalues — the
    reference's ``vargau`` sampling (noise.py:273-305).
    """
    evals, evecs = jnp.linalg.eigh(psd)
    std = jnp.sqrt(jnp.clip(evals, 0.0))
    r = jax.random.normal(key, std.shape, dtype=std.dtype) * std
    return jnp.einsum("...ij,...j->...i", evecs, r.astype(evecs.dtype))


def mirror_halfspectrum(xi_pos: jax.Array, nmd: int) -> jax.Array:
    """Assemble the full nmd-point spectrum from hlen+1 positive-frequency rows.

    Ordering matches noise.py:87-94: rows [xi_0 .. xi_{h-1},
    conj(xi_h), conj(xi_{h-1}), .., conj(xi_1)].
    """
    hlen = nmd // 2
    neg = jnp.conjugate(xi_pos[1:hlen + 1][::-1])
    return jnp.concatenate([xi_pos[:hlen], neg], axis=0)


def synthesize(key: jax.Array, psd: jax.Array, dt: float, nmd: int) -> jax.Array:
    """Real (nmd, nc) time-domain noise series from half-spectrum PSD batch."""
    xi_pos = sample_from_psd(key, psd)
    xi = mirror_halfspectrum(xi_pos, nmd)
    xt = fourier_w2t(xi, dt, axis=0)   # w -> t, fft * dw/2pi
    return jnp.real(xt)


def enoise(key, efric, exim, exip, bias, T, ecut, dt, nmd,
           classical: bool = False, zpmotion: bool = True) -> jax.Array:
    """Electron colored-noise time series (noise.py:149-206), batched.

    Returns a real (nmd, nc) array. ``key`` is a jax PRNG key — noise is
    reproducible and vmap-able across ensemble members, unlike the
    reference's global numpy RNG.
    """
    wl = halfspectrum_freqs(dt, nmd, dtype=jnp.asarray(efric).dtype)
    delta = dt * nmd  # discrete Dirac factor (noise.py:167)
    psd = electron_psd(wl, efric, exim, exip, bias, T, ecut,
                       classical, zpmotion, delta)
    return synthesize(key, psd, dt, nmd)


def phnoise(key, gamma, gwl, T, phcut, dt, nmd,
            classical: bool = False, zpmotion: bool = True) -> jax.Array:
    """Phonon colored-noise time series (noise.py:50-100), batched."""
    wl = halfspectrum_freqs(dt, nmd, dtype=jnp.asarray(gamma).dtype)
    delta = dt * nmd
    psd = phonon_psd(wl, gamma, gwl, T, phcut, classical, zpmotion, delta)
    return synthesize(key, psd, dt, nmd)


def enoisew(wl, efric, exim, exip, bias, T, ecut,
            classical: bool = False, zpmotion: bool = True) -> jax.Array:
    """PSD matrices on an arbitrary grid, no Dirac factor (noise.py:105-145)."""
    return electron_psd(wl, efric, exim, exip, bias, T, ecut,
                        classical, zpmotion, delta=1.0)


def phnoisew(gamma, wl, T, phcut,
             classical: bool = False, zpmotion: bool = True) -> jax.Array:
    """Scalar-gamma phonon noise spectrum equ(w)*gamma(w) (noise.py:28-46)."""
    wl = jnp.asarray(wl)
    gamma = jnp.asarray(gamma)
    return equ_spectrum(wl, phcut, T, classical, zpmotion) * gamma


def mf(f: jax.Array, cats, lens: int) -> jax.Array:
    """Scatter a bath-local vector into the full-DOF vector (noise.py:15-22)."""
    return jnp.zeros((lens,), dtype=f.dtype).at[jnp.asarray(cats)].set(f)
