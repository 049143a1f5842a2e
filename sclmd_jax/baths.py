"""Electron and phonon baths as JAX pytrees.

Re-derivation of the reference's sclmd/baths.py for the JAX engine:
baths are immutable pytree dataclasses whose force rule
``bforce(bath, it, phis, qhis, nph)`` is a pure, jittable function of the
step index and the velocity/displacement history rings. Noise series are
attached functionally (``gnoi(bath, key) -> bath``) so ensembles can carry
independent per-trajectory noise via ``vmap``.

Physics conventions mirror the reference:

* ebath (baths.py:55-255): Markovian electronic friction ``-efric . v``
  plus bias-driven wind/renormalisation/Berry forces
  ``+ V (exim - zeta1) . q - V zeta2 . v`` (baths.py:243-249). NOTE the
  reference gates the bias terms on ``exim.any() AND zeta1.any() AND
  zeta2.any()`` (baths.py:233), which silently drops the wind force when
  only ``exim`` is supplied (the examples/current-induced/rundp.py case);
  here the closed form is always applied — it reduces to the plain
  friction branch when the matrices are zero.
* phbath (baths.py:258-458): non-Markovian memory kernel
  ``f = noise(t) - dt * sum_m K[m] . v[t-m]`` (local baths drop the dt,
  baths.py:453-457), with the kernel built from Gamma(w) by the discrete
  cosine transform ``gamt`` (baths.py:19-52) including the artificial-
  damping variant, or from a Debye model (baths.py:333-339).
* The ``K00/K01/V01`` lead-block mode aborts in the reference
  (baths.py:316-320); here it is implemented via the decimation surface
  Green's function (see sclmd_jax.selfenergy).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from sclmd_jax.utils import pytree as struct

from sclmd_jax.ops import noise as NZ
from sclmd_jax.ops.functions import (
    antisymmetrize,
    chkShape,
    flinterp,
    symmetrize,
)


def _as_f(x, dtype):
    return jnp.asarray(x, dtype=dtype)


def exlist(a, indices):
    """Gather rows by index (baths.py:12-14)."""
    return jnp.asarray(a)[jnp.asarray(indices)]



def _contig_start(cats_np: np.ndarray):
    """Static start offset if cats is the ascending contiguous range
    [c0, c0+nc), else None."""
    if len(cats_np) == 0:
        return None
    c0 = int(cats_np[0])
    if np.array_equal(cats_np, np.arange(c0, c0 + len(cats_np))):
        return c0
    return None


# ---------------------------------------------------------------------------
# Electron bath
# ---------------------------------------------------------------------------
@struct.dataclass
class EBath:
    """Markovian electron bath with optional current-induced forces."""

    cids: jax.Array                    # (nc,) int32 DOF indices
    efric: jax.Array                   # (nc, nc) symmetric friction
    exim: jax.Array                    # (nc, nc) antisymmetric Im[MALMAR]
    exip: jax.Array                    # (nc, nc) symmetric Re[MALMAR]
    zeta1: jax.Array                   # (nc, nc) symmetric renormalisation
    zeta2: jax.Array                   # (nc, nc) antisymmetric Berry
    T: jax.Array                       # scalar temperature (leaf -> vmappable)
    bias: jax.Array                    # scalar bias mu_L - mu_R
    noise: Optional[jax.Array]         # (nmd, nc) colored noise series
    dt: float = struct.field(pytree_node=False)
    nmd: int = struct.field(pytree_node=False)
    wmax: Optional[float] = struct.field(pytree_node=False, default=None)
    nw: Optional[int] = struct.field(pytree_node=False, default=None)
    classical: bool = struct.field(pytree_node=False, default=False)
    zpmotion: bool = struct.field(pytree_node=False, default=True)
    # static: skip the wind/Berry/renormalisation matvecs when the
    # matrices were never supplied
    bias_terms: bool = struct.field(pytree_node=False, default=False)
    # precomputed noise factors (host-side f64 eigh of the PSD batch);
    # sampling then stays eigh-free on device
    nevecs: Optional[jax.Array] = None
    nstd: Optional[jax.Array] = None
    # STATIC start offset when cids is the contiguous range
    # [cs, cs+nc): hot-loop gathers/scatters then lower to static
    # slices / dynamic-update-slices (large leads: gather+scatter
    # dominates the vmapped step otherwise)
    cs: Optional[int] = struct.field(pytree_node=False, default=None)

    @property
    def cols(self):
        """Column indexer for the full-DOF axis: a slice when the
        bath's DOFs are contiguous, else the index array.

        ``cs`` is set by the factories; a later ``replace(cids=...)``
        cannot update the static field, so when ``cids`` is concrete
        (eager use) the endpoints are re-checked and a stale ``cs`` is
        ignored. Under a jit trace the factory invariant is trusted.
        """
        if self.cs is None:
            return self.cids
        cids = self.cids
        n = cids.shape[0]
        if not isinstance(cids, jax.core.Tracer):
            c = np.asarray(cids)
            if int(c[0]) != self.cs or int(c[-1]) != self.cs + n - 1:
                return cids
        return slice(self.cs, self.cs + n)

    # --- reference-compatible attributes ---
    @property
    def nc(self) -> int:
        return self.efric.shape[-1]

    @property
    def ml(self) -> int:
        return 1  # electronic friction is time-local (baths.py:96-97)

    @property
    def kernel(self):
        return self.efric[None]

    @property
    def wl(self):
        if self.wmax is None or self.nw is None:
            return None
        return np.array([self.wmax * i / self.nw for i in range(self.nw)])

    # --- functional API ---
    def prepare_noise(self) -> "EBath":
        """Factorise the noise PSD once, fully on the host in float64
        (numpy) — an eigh in the device graph is both slow to compile
        and inaccurate in complex64."""
        dtype = self.efric.dtype
        hlen = self.nmd // 2
        dw = 2.0 * np.pi / self.dt / self.nmd
        wl = dw * np.arange(hlen + 1)
        psd = NZ.electron_psd(
            wl, np.asarray(self.efric, np.float64),
            np.asarray(self.exim, np.float64),
            np.asarray(self.exip, np.float64),
            float(self.bias), float(self.T), self.wmax,
            self.classical, self.zpmotion,
            delta=self.dt * self.nmd, xp=np)
        evec, std = NZ.noise_factors(psd, dtype=dtype)
        # host numpy leaves: the samplers ship only the (re, im)
        # parts they need (sample_noise_dev)
        return self.replace(nevecs=evec, nstd=std)

    def gnoi_np(self, seed: int, dtype=None) -> "EBath":
        """Host-side noise synthesis (numpy RNG + FFT) from the
        precomputed factors; returns the bath with a host numpy noise
        array (deterministic from ``seed``, independent of the
        device)."""
        rng = np.random.default_rng(seed)
        xi = NZ.sample_noise_np(rng, self.nevecs, self.nstd,
                                self.dt, self.nmd)
        dt_ = dtype or np.float32
        return self.replace(noise=xi.astype(dt_))

    def gnoi(self, key: jax.Array) -> "EBath":
        """Attach a freshly synthesised noise series (baths.py:176-192).

        Uses the precomputed factors when available (eigh-free on
        device, vmappable over keys); otherwise the all-jnp path.
        """
        if self.nstd is not None:
            xi = NZ.sample_noise_dev(self, key)
        else:
            xi = NZ.enoise(key, self.efric, self.exim, self.exip,
                           self.bias, self.T, self.wmax, self.dt, self.nmd,
                           self.classical, self.zpmotion)
        return self.replace(noise=xi)

    def SetT(self, T) -> "EBath":
        """New bath at temperature T (refactorised; the reference mutates
        and warns to regenerate noise — here the factors ARE regenerated)."""
        return self.replace(T=_as_f(T, self.efric.dtype)).prepare_noise()

    def setbias(self, bias) -> "EBath":
        """New bath at the given bias (baths.py:216-222); noise factors
        are refreshed so gnoi() samples the new spectrum."""
        return self.replace(
            bias=_as_f(bias, self.efric.dtype)).prepare_noise()

    def SetMDsteps(self, dt, nmd) -> "EBath":
        """New bath on a different MD grid (baths.py:211-214)."""
        return self.replace(dt=float(dt), nmd=int(nmd)).prepare_noise()

    def GetSig(self):
        """Effective wideband retarded self-energy Sigma(w) (baths.py:194-209)."""
        wl = jnp.asarray(self.wl, dtype=self.efric.dtype)
        sig = (-1j * wl[:, None, None] * (self.efric + self.bias * self.zeta2)
               + self.bias * self.zeta1 - self.bias * self.exim)
        return sig

    def local_force(self, noise_row, phis_c, qhis_c):
        """Bath force on the bath's own DOFs.

        ``noise_row`` is this step's colored-noise vector (nc,), fed by
        the scan's xs stream (never a dynamic slice inside the scan).
        ``phis_c``/``qhis_c`` are the history rings already gathered onto
        ``cids``: shape (ml, nc). Implements baths.py:224-255.
        """
        f = noise_row
        v = phis_c[0]
        f = f - self.efric @ v
        if self.bias_terms:
            q = qhis_c[0]
            f = f + self.bias * ((self.exim - self.zeta1) @ q) \
                  - self.bias * (self.zeta2 @ v)
        return f

    # --- per-step interface shared with PhBath (vv_step fast path) ---
    def step_plan(self, old_c):
        return None

    def _markov_force(self, noise_row, v_c, q_c):
        f = noise_row - self.efric @ v_c
        if self.bias_terms:
            f = f + self.bias * ((self.exim - self.zeta1) @ q_c) \
                  - self.bias * (self.zeta2 @ v_c)
        return f

    def force_pred(self, noise_row, v_c, q_c, old_c, plan):
        return self._markov_force(noise_row, v_c, q_c)

    def force_corr(self, noise_row, v_c, q_c, p_c, plan):
        return self._markov_force(noise_row, v_c, q_c)


def ebath(cats, T, dt, nmd, wmax=None, nw=None, bias=0.0,
          efric=None, exim=None, exip=None, zeta1=None, zeta2=None,
          classical: bool = False, zpmotion: bool = True,
          dtype=jnp.float32, factorize: bool = True) -> EBath:
    """Build an electron bath, mirroring ``ebath.__init__``/``CheckEmat``
    (baths.py:76-174): efric/exip/zeta1 are symmetrised, exim/zeta2
    antisymmetrised, shapes validated against ``cats``.
    """
    cats_np = np.asarray(cats, dtype=np.int32)
    cids = jnp.asarray(cats_np)
    nc = int(cids.shape[0])
    if efric is None:
        raise ValueError("ebath: efric is required (reference sets ebath=False"
                         " and never uses such a bath)")
    n = chkShape(efric)
    if n != nc:
        raise ValueError(f"ebath: efric shape {n} != len(cats) {nc}")

    # all setup in host numpy float64
    def _sym(m):
        m = np.asarray(m, np.float64)
        return 0.5 * (m + m.T)

    def _asym(m):
        m = np.asarray(m, np.float64)
        return 0.5 * (m - m.T)

    z = np.zeros((nc, nc))
    for name, m in (("exim", exim), ("exip", exip),
                    ("zeta1", zeta1), ("zeta2", zeta2)):
        if m is not None and chkShape(m) != nc:
            raise ValueError(f"ebath: {name} has wrong dimension")
    efric_np = _sym(efric)
    exim_np = _asym(exim) if exim is not None else z
    exip_np = _sym(exip) if exip is not None else z
    zeta1_np = _sym(zeta1) if zeta1 is not None else z
    zeta2_np = _asym(zeta2) if zeta2 is not None else z

    bias_active = (exim is not None or zeta1 is not None
                   or zeta2 is not None or exip is not None) \
        and float(bias) != 0.0
    nevecs = nstd = None
    if factorize:
        hlen = int(nmd) // 2
        dw = 2.0 * np.pi / dt / nmd
        wlh = dw * np.arange(hlen + 1)
        if not bias_active and nc >= 8:
            # unbiased bath: S(w) = a(w) efric exactly — factorise from
            # ONE nc x nc eigh without materialising the (hlen+1, nc,
            # nc) complex batch (3 GB at nc~900); same statistics
            from sclmd_jax.ops.functions import equ_spectrum
            aw = float(dt) * int(nmd) * np.asarray(equ_spectrum(
                wlh, wmax, float(T), classical, zpmotion, xp=np))
            lam0, evec0 = np.linalg.eigh(efric_np)
            std = np.sqrt(np.clip(aw, 0.0, None)[:, None]
                          * np.clip(lam0, 0.0, None)[None, :])
            cplx = np.complex128 if dtype in (jnp.float64, np.float64) \
                else np.complex64
            nevecs = np.ascontiguousarray(np.broadcast_to(
                evec0.astype(cplx), (hlen + 1, nc, nc)))
            nstd = std.astype(np.float64 if dtype in (jnp.float64,
                                                      np.float64)
                              else np.float32)
        else:
            psd = NZ.electron_psd(wlh, efric_np, exim_np, exip_np,
                                  float(bias), float(T), wmax,
                                  classical, zpmotion,
                                  delta=float(dt) * int(nmd), xp=np)
            evec, std = NZ.noise_factors(psd, dtype=dtype)
            nevecs, nstd = evec, std   # host numpy leaves by design

    return EBath(
        cids=cids,
        cs=_contig_start(cats_np),
        efric=_as_f(efric_np, dtype),
        exim=_as_f(exim_np, dtype),
        exip=_as_f(exip_np, dtype),
        zeta1=_as_f(zeta1_np, dtype),
        zeta2=_as_f(zeta2_np, dtype),
        T=_as_f(T, dtype),
        bias=_as_f(bias, dtype),
        noise=None,
        dt=float(dt), nmd=int(nmd),
        wmax=None if wmax is None else float(wmax),
        nw=None if nw is None else int(nw),
        classical=bool(classical), zpmotion=bool(zpmotion),
        bias_terms=(exim is not None or zeta1 is not None
                    or zeta2 is not None),
        nevecs=nevecs, nstd=nstd,
    )


# ---------------------------------------------------------------------------
# Phonon bath
# ---------------------------------------------------------------------------
def gamt(tl, wl, gwl, gam, eta_ad: float = 0.0, xp=jnp) -> jax.Array:
    """Friction kernel K(t) from Gamma(w) by direct cosine sum.

    Mirrors baths.py:19-52: K(t) = (2/pi) * wmax * mean_w[Gamma(w) cos(wt)]
    over the bath's ``wl`` grid, with Gamma interpolated from (gwl, gam);
    the ``eta_ad`` != 0 variant adds artificial damping e^{-eta t} with the
    w/(w -+ i eta) weights. Batched matrix form: the (nt, nw) cosine matrix
    contracts with the (nw, nc*nc) Gamma table in one matmul.
    """
    from sclmd_jax.ops.functions import flinterp_np
    tl = xp.asarray(tl)
    wl = xp.asarray(wl)
    gam = xp.asarray(gam)
    interp = flinterp if xp is jnp else flinterp_np
    gw = interp(wl, xp.asarray(gwl), gam)             # (nw, nc, nc)
    nw, nc = gw.shape[0], gw.shape[-1]
    gflat = gw.reshape(nw, nc * nc)
    if eta_ad == 0.0:
        cosm = xp.cos(wl[None, :] * tl[:, None])       # (nt, nw)
        kt = 2.0 * (cosm @ gflat) / nw * wl[-1] / np.pi
        return xp.real(kt).reshape(tl.shape[0], nc, nc)
    wc = wl.astype(xp.result_type(wl.dtype, xp.complex64))
    phase_m = (wc / (wc - 1j * eta_ad))[None, :] * \
        xp.exp(-1j * wc[None, :] * tl[:, None] - eta_ad * tl[:, None])
    phase_p = (wc / (wc + 1j * eta_ad))[None, :] * \
        xp.exp(+1j * wc[None, :] * tl[:, None] - eta_ad * tl[:, None])
    kt = ((phase_m + phase_p) @ gflat.astype(phase_m.dtype)) / nw * wl[-1] / np.pi
    return xp.real(kt).reshape(tl.shape[0], nc, nc)


def ggamma(sig, gwl) -> np.ndarray:
    """Friction table Gamma(w) = -Im Sigma(w)/w from a lead self-energy
    table (baths.py:375-395); the w=0 row is taken from the next grid
    point, as the reference does. Host numpy (setup path)."""
    sig = np.asarray(sig)
    gwl = np.asarray(gwl, np.float64)
    wsafe = np.where(gwl == 0.0, 1.0, gwl)
    g = -np.imag(sig) / wsafe[:, None, None]
    g_next = np.roll(-np.imag(sig), -1, axis=0) / \
        np.roll(wsafe, -1)[:, None, None]
    return np.where((gwl == 0.0)[:, None, None], g_next, g)


@struct.dataclass
class PhBath:
    """Phonon bath: Debye (local) or memory-kernel (non-Markovian)."""

    cids: jax.Array                   # (nc,) int32
    T: jax.Array                      # scalar leaf
    gamma: jax.Array                  # (ngw, nc, nc) Gamma(w) table
    gwl: jax.Array                    # (ngw,) energy grid of gamma
    kernel: Optional[jax.Array]       # (ml, nc, nc) K(t) time kernel
    noise: Optional[jax.Array]        # (nmd, nc)
    dt: float = struct.field(pytree_node=False)
    nmd: int = struct.field(pytree_node=False)
    ml: int = struct.field(pytree_node=False)
    nw: int = struct.field(pytree_node=False)
    wmax: float = struct.field(pytree_node=False)
    local: bool = struct.field(pytree_node=False)
    eta_ad: float = struct.field(pytree_node=False, default=0.0)
    classical: bool = struct.field(pytree_node=False, default=False)
    zpmotion: bool = struct.field(pytree_node=False, default=True)
    nevecs: Optional[jax.Array] = None
    nstd: Optional[jax.Array] = None
    # which input built the bath: "K" (lead blocks), "Pi" (self-energy
    # table), "G" (Gamma table), "debye" — drives the reference's
    # UseK/UsePi/UseG predicates (baths.py:356-373)
    mode: str = struct.field(pytree_node=False, default="G")
    # STATIC start offset when cids is contiguous (see EBath.cs)
    cs: Optional[int] = struct.field(pytree_node=False, default=None)

    @property
    def nc(self) -> int:
        return self.cids.shape[0]

    @property
    def cols(self):
        """Column indexer for the full-DOF axis: a slice when the
        bath's DOFs are contiguous, else the index array.

        ``cs`` is set by the factories; a later ``replace(cids=...)``
        cannot update the static field, so when ``cids`` is concrete
        (eager use) the endpoints are re-checked and a stale ``cs`` is
        ignored. Under a jit trace the factory invariant is trusted.
        """
        if self.cs is None:
            return self.cids
        cids = self.cids
        n = cids.shape[0]
        if not isinstance(cids, jax.core.Tracer):
            c = np.asarray(cids)
            if int(c[0]) != self.cs or int(c[-1]) != self.cs + n - 1:
                return cids
        return slice(self.cs, self.cs + n)

    # --- reference mode predicates (baths.py:356-373). The reference
    # keeps raw sig/K00 attributes and tests their presence; here the
    # builder consumes those inputs (deriving gamma), so the predicates
    # report the recorded build mode. A "K" bath also passed through
    # the Sigma->Gamma derivation, and every built bath carries a
    # Gamma table, matching the reference's post-__init__ state.
    def UseG(self) -> bool:
        return self.gamma is not None and self.gwl is not None

    def UsePi(self) -> bool:
        return self.mode in ("Pi", "K")

    def UseK(self) -> bool:
        return self.mode == "K"

    @property
    def kernel_im(self):
        """(nc, ml*nc) matmul-layout view of the kernel, derived on
        demand (XLA folds the transpose/reshape into the consuming
        matmul — storing it doubled the bath-matrix memory footprint)."""
        return _kernel_im(self.kernel)

    @property
    def wl(self):
        return np.array([self.wmax * i / self.nw for i in range(self.nw)])

    def SetT(self, T) -> "PhBath":
        """New bath at temperature T (baths.py:352-354) with refreshed
        noise factors."""
        return self.replace(T=_as_f(T, self.gamma.dtype)).prepare_noise()

    def SetMDsteps(self, dt, nmd) -> "PhBath":
        """New bath on a different MD grid (baths.py:342-345)."""
        return self.replace(dt=float(dt), nmd=int(nmd)).prepare_noise()

    def SetMemlen(self, ml) -> "PhBath":
        """New bath with a different memory-kernel length
        (baths.py:347-350); the kernel is regenerated."""
        new = self.replace(ml=int(ml))
        return new.gmem().prepare_noise()

    def gmem(self) -> "PhBath":
        """Generate the time-domain memory kernel (baths.py:412-446)."""
        if self.local:
            return self.replace(kernel=self.gamma[:1])
        tl = self.dt * jnp.arange(self.ml, dtype=self.gamma.dtype)
        kern = gamt(tl, jnp.asarray(self.wl, self.gamma.dtype),
                    self.gwl, self.gamma, self.eta_ad)
        new_gamma = self.gamma
        if self.eta_ad != 0.0:
            # refresh Gamma(w) by cosine-transforming the damped kernel
            # back onto the gwl grid (baths.py:437-445)
            cosm = jnp.cos(self.gwl[:, None] * tl[None, :])   # (ngw, ml)
            nc = kern.shape[-1]
            new_gamma = (self.dt * cosm @ kern.reshape(self.ml, nc * nc)
                         ).reshape(self.gwl.shape[0], nc, nc)
        return self.replace(kernel=kern, gamma=new_gamma)

    def prepare_noise(self) -> "PhBath":
        """Factorise the noise PSD once, fully on the host in float64
        (see EBath.prepare_noise)."""
        dtype = self.gamma.dtype
        hlen = self.nmd // 2
        dw = 2.0 * np.pi / self.dt / self.nmd
        wl = dw * np.arange(hlen + 1)
        psd = NZ.phonon_psd(
            wl, np.asarray(self.gamma, np.float64),
            np.asarray(self.gwl, np.float64), float(self.T), self.wmax,
            self.classical, self.zpmotion,
            delta=self.dt * self.nmd, xp=np)
        evec, std = NZ.noise_factors(psd, dtype=dtype)
        return self.replace(nevecs=evec, nstd=std)

    def gnoi_np(self, seed: int, dtype=None) -> "PhBath":
        """Host-side noise synthesis; see EBath.gnoi_np."""
        rng = np.random.default_rng(seed)
        xi = NZ.sample_noise_np(rng, self.nevecs, self.nstd,
                                self.dt, self.nmd)
        dt_ = dtype or np.float32
        return self.replace(noise=xi.astype(dt_))

    def gnoi(self, key: jax.Array) -> "PhBath":
        """Attach phonon colored noise (baths.py:397-410)."""
        if self.nstd is not None:
            xi = NZ.sample_noise_dev(self, key)
        else:
            xi = NZ.phnoise(key, self.gamma, self.gwl, self.T, self.wmax,
                            self.dt, self.nmd, self.classical,
                            self.zpmotion)
        return self.replace(noise=xi)

    def local_force(self, noise_row, phis_c, qhis_c):
        """Memory-kernel friction force on the bath DOFs (baths.py:448-458)."""
        f = noise_row
        if self.ml == 1:
            return f - self.kernel[0] @ phis_c[0]
        vflat = phis_c.reshape(self.ml * self.nc)
        conv = self.kernel_im @ vflat
        return f - conv * self.dt

    # --- one-kernel-read-per-step fast path ------------------------------
    # The velocity-Verlet step evaluates the bath force three times
    # (md.py:390,401-403) with histories that share all but the newest
    # one or two taps. The ml-tap convolution is HBM-bandwidth-bound by
    # the kernel matrix, so reading it once per step instead of three
    # times is ~3x: both shared tails
    #   tail_pred = sum_{r>=2} K[r] old[r-1]   (+ K[1] old[0] added below)
    #   tail_corr = sum_{r>=2} K[r] old[r-2]
    # come out of ONE (nc, (ml-2) nc) @ ((ml-2) nc, 2) matmul.
    def step_plan(self, old_c):
        """Per-step shared tails from the pre-push history ring
        ``old_c`` = state.phis[:, cids] (ml, nc). None when ml <= 2."""
        if self.ml <= 2:
            return None
        nc = self.nc
        B = jnp.stack([old_c[1:self.ml - 1], old_c[0:self.ml - 2]],
                      axis=2)                         # (ml-2, nc, 2)
        return self.kernel_im[:, 2 * nc:] @ B.reshape(
            (self.ml - 2) * nc, 2)                    # (nc, 2)

    def force_pred(self, noise_row, v_c, q_c, old_c, plan):
        """Predictor bath force: history [v, old[0], old[1], ...]."""
        if self.ml == 1:
            return noise_row - self.kernel[0] @ v_c
        conv = self.kernel[0] @ v_c + self.kernel[1] @ old_c[0]
        if plan is not None:
            conv = conv + plan[:, 0]
        return noise_row - conv * self.dt

    def force_corr(self, noise_row, v_c, q_c, p_c, plan):
        """Corrector bath force: history [v, p, old[0], ...]."""
        if self.ml == 1:
            return noise_row - self.kernel[0] @ v_c
        conv = self.kernel[0] @ v_c + self.kernel[1] @ p_c
        if plan is not None:
            conv = conv + plan[:, 1]
        return noise_row - conv * self.dt

    # --- blocked-convolution fast path (md.run_segment_blocked) -----------
    # Per B-step block the convolution splits into (a) a pre-block part
    # over taps j > s, one FFT cross-correlation of the (static) kernel
    # with the history — the big kernel matrix is read ONCE per block
    # instead of once per step — and (b) an in-block part over taps
    # j <= s against a tiny (B, nc) ring of recent velocities.
    def block_tap_kernel(self, block: int):
        """(nc, (block+1)*nc) kernel slice covering in-block taps
        1..block+1, zero-padded past ml."""
        nc = self.nc
        want = (block + 1) * nc
        avail = self.kernel_im[:, nc:]          # taps 1..ml-1
        if avail.shape[1] >= want:
            return avail[:, :want]
        return jnp.pad(avail, ((0, 0), (0, want - avail.shape[1])))

    def block_corr(self, hist, block: int, khat, nfft: int):
        """Pre-block convolution tails O[s] = sum_{j>=s+1} K[j] v(t0+s-j)
        for s = 0..block, from ``hist`` (ml-1, nc) = pre-block velocities
        newest-first (hist[i] = v(t0-1-i)).

        Computed as a circular cross-correlation via rfft/irfft with the
        kernel spectrum ``khat`` = rfft(zero-padded kernel); nfft >=
        ml+block+1 keeps it linear. Returns (block+1, nc)."""
        hhat = jnp.fft.rfft(hist, n=nfft, axis=0)          # (nf, nc)
        prod = jnp.einsum("fab,fb->fa", khat, jnp.conjugate(hhat))
        corr = jnp.fft.irfft(prod, n=nfft, axis=0)         # (nfft, nc)
        return corr[1:block + 2]


def _kernel_im(kernel: jax.Array) -> jax.Array:
    """(ml, nc, nc) -> (nc, ml*nc) layout so the history convolution is a
    single matvec (matmul once trajectories are vmapped)."""
    ml, nc = kernel.shape[0], kernel.shape[-1]
    return jnp.transpose(kernel, (1, 0, 2)).reshape(nc, ml * nc)


def phbath(T, cats, debye, nw, dt, nmd, ml=None, mcof=2.0,
           sig=None, gamma=None, gwl=None,
           K00=None, K01=None, V01=None, eta_ad=0.0,
           classical: bool = False, zpmotion: bool = True,
           dtype=jnp.float32, nwse: int = 400,
           factorize: bool = True) -> PhBath:
    """Build a phonon bath, mirroring ``phbath.__init__`` (baths.py:294-340).

    Modes (checked in the reference's order):
      * K00/K01/V01 lead blocks: computes Sigma(w) on a ``nwse``-point grid
        via the decimation surface Green's function — implemented here
        (the reference exits, baths.py:316-320);
      * sig + gwl: Gamma(w) = -Im Sigma(w)/w (``ggamma``, baths.py:375-395);
      * gamma + gwl: used directly;
      * otherwise Debye model Gamma = (w_D pi/6) I, local (baths.py:333-339).

    The returned bath already carries its time-domain kernel (``gmem``).
    """
    cats_np = np.asarray(cats, dtype=np.int32)
    cids = jnp.asarray(cats_np)
    nc = int(cids.shape[0])
    wmax = float(mcof * debye)
    local = False

    if K00 is not None and K01 is not None and V01 is not None:
        from sclmd_jax.selfenergy import lead_selfenergy_from_blocks_np
        gwl = np.linspace(0.0, wmax, nwse)
        sig = lead_selfenergy_from_blocks_np(
            np.asarray(K00, np.float64), np.asarray(K01, np.float64),
            np.asarray(V01, np.float64), gwl)

    mode = "K" if (K00 is not None and K01 is not None
                   and V01 is not None) else None
    # all setup on the host in numpy (see ebath)
    if sig is not None and gwl is not None:
        sig = np.asarray(sig)
        if sig.shape[-1] != nc:
            raise ValueError("phbath: inconsistent cids and sig")
        gwl_np = np.asarray(gwl, np.float64)
        gamma_np = ggamma(sig, gwl_np)
        mode = mode or "Pi"
    elif gamma is not None and gwl is not None:
        gamma_np = np.asarray(gamma, np.float64)
        if gamma_np.shape[-1] != nc:
            raise ValueError("phbath: inconsistent cids and gamma")
        gwl_np = np.asarray(gwl, np.float64)
        mode = "G"
    else:
        # Debye model (Adelman & Doll JCP 64, 2375 (1976)): gamma = w_D pi/6
        phfric = debye * np.pi / 6.0
        gamma_np = (phfric * np.eye(nc))[None]
        gwl_np = np.zeros((1,))
        local = True
        ml = 1
        mode = "debye"

    if ml is None:
        raise ValueError("phbath: memory length ml must be set for "
                         "non-local baths")

    # time-domain kernel (gmem, baths.py:412-446) on the host
    if local:
        kern_np = gamma_np[:1]
    else:
        tl = float(dt) * np.arange(int(ml))
        wl_bath = np.array([wmax * i / int(nw) for i in range(int(nw))])
        kern_np = gamt(tl, wl_bath, gwl_np, gamma_np, float(eta_ad), xp=np)
        if eta_ad != 0.0:
            # refresh Gamma(w) from the damped kernel (baths.py:437-445)
            cosm = np.cos(gwl_np[:, None] * tl[None, :])
            gamma_np = (float(dt) * cosm @
                        kern_np.reshape(int(ml), nc * nc)
                        ).reshape(len(gwl_np), nc, nc)

    nevecs = nstd = None
    if factorize:
        hlen = int(nmd) // 2
        dw = 2.0 * np.pi / dt / nmd
        wlh = dw * np.arange(hlen + 1)
        psd = NZ.phonon_psd(wlh, gamma_np, gwl_np, float(T), wmax,
                            classical, zpmotion,
                            delta=float(dt) * int(nmd), xp=np)
        evec, std = NZ.noise_factors(psd, dtype=dtype)
        nevecs, nstd = evec, std   # host numpy leaves by design

    kern = jnp.asarray(kern_np, dtype)
    return PhBath(
        cids=cids, cs=_contig_start(cats_np),
        T=_as_f(T, dtype), gamma=_as_f(gamma_np, dtype),
        gwl=_as_f(gwl_np, dtype),
        kernel=kern,
        noise=None,
        dt=float(dt), nmd=int(nmd), ml=int(ml), nw=int(nw),
        wmax=wmax, local=bool(local), eta_ad=float(eta_ad),
        classical=bool(classical), zpmotion=bool(zpmotion),
        nevecs=nevecs, nstd=nstd, mode=mode,
    )


# ---------------------------------------------------------------------------
# Generic force application (full-DOF scatter)
# ---------------------------------------------------------------------------
def bforce(bath, noise_row, phis, qhis, nph: int) -> jax.Array:
    """Full-DOF bath force: gather history on cids, apply local rule,
    scatter back (the reference's ``mf`` padding, noise.py:15-22).

    ``noise_row`` is the step's noise vector (nc,), streamed from the
    scan xs (see md.run_segment).
    """
    phis_c = phis[:, bath.cols]
    qhis_c = qhis[:, bath.cols]
    if isinstance(bath, PhBath) and bath.ml > 1:
        phis_c = phis_c[: bath.ml]
    f_local = bath.local_force(noise_row,
                               phis_c[:1] if bath.ml == 1 else phis_c,
                               qhis_c[:1])
    return jnp.zeros((nph,), f_local.dtype).at[bath.cols].set(f_local)
