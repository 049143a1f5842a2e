"""JAX force-driver protocol: the replacement for external engines.

The reference drives forces through external native engines — LAMMPS
in-process C++ (lammpsdriver.py), Siesta over a socket (siestadriver.py),
DeepMD-kit TF (deepmddriver.py) — all sharing a duck-typed contract:
``.axyz``, ``.conv``, ``.f0``, ``.force(q)``, ``.initforce()``,
``.dynmat()``, ``.energy()`` (SURVEY.md L1). Here the same contract is
met by any differentiable JAX energy function, so the force (and even
the dynamical matrix, via ``jax.hessian``) stays on-device inside the
jitted MD step — replacing the 33 ms/call host round-trip that dominates
the reference profile (BASELINE.md) and the 146 s LAMMPS
``dynamical_matrix`` call (negf.py:63).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from sclmd_jax import units as U


class JaxDriver:
    """Force driver built from a differentiable energy function.

    Parameters
    ----------
    energy_fn : positions (na, 3) angstrom -> total energy in eV.
        Must be jit/grad-able.
    axyz : list of [element, x, y, z] rows — the relaxed structure.
    md2ang : mass-weighted-coordinate scale (units.MD2ANG).

    The driver works in the reference's mass-weighted displacement
    coordinates: cartesian x = xyz + conv * q with
    conv_i = md2ang / sqrt(m_atom(i)) (lammpsdriver.py:55-56), and
    returns conv-scaled relative forces F(q) = conv*(f(x) - f0)
    (lammpsdriver.py:74-84).
    """

    def __init__(self, energy_fn: Callable, axyz, md2ang=U.MD2ANG,
                 dtype=jnp.float32):
        self.energy_fn = energy_fn
        self.md2ang = md2ang
        self.dtype = dtype
        self.els = [a[0] for a in axyz]
        self.axyz = axyz
        self.number = len(axyz)
        self.xyz = np.array([a[1:] for a in axyz], dtype=float).flatten()
        mass = np.array([U.AtomicMassTable[e] for e in self.els])
        self.conv = self.md2ang * np.repeat(1.0 / np.sqrt(mass), 3)

        xyz_h = np.asarray(self.xyz, np.float64 if dtype == jnp.float64
                           else np.float32)
        conv_h = np.asarray(self.conv, xyz_h.dtype)
        na = self.number

        # HIGHEST matmul precision also outside the MD scan (f0, host
        # calls): at default precision a float32 contraction may run in
        # TF32 (see md.vv_step)
        def _abs_force(q):
            with jax.default_matmul_precision("highest"):
                x = (xyz_h + conv_h * q).reshape(na, 3)
                f = -jax.grad(lambda xx: energy_fn(xx))(x).reshape(-1)
                return conv_h * f

        self._abs_force = jax.jit(_abs_force)

        def _energy_q(q):
            with jax.default_matmul_precision("highest"):
                return energy_fn((xyz_h + conv_h * q).reshape(na, 3))

        self.energy_jax = _energy_q   # traceable q-space energy (eV)
        self._energy = jax.jit(_energy_q)
        self.initforce()

    # --- reference driver protocol ---
    def initforce(self):
        self.f0 = self._abs_force(jnp.zeros(3 * self.number, self.dtype))

    def newx(self, q):
        return self.xyz + self.conv * np.asarray(q)

    def absforce(self, q):
        return self._abs_force(jnp.asarray(q, self.dtype))

    def force(self, q):
        return self._abs_force(jnp.asarray(q, self.dtype)) - self.f0

    # jittable path used inside the MD scan
    def force_jax(self, q):
        return self._abs_force(q) - self.f0

    def energy(self, q=None):
        if q is None:
            q = jnp.zeros(3 * self.number, self.dtype)
        return float(self._energy(jnp.asarray(q, self.dtype)))

    def dynmat(self, q=None, dtype=jnp.float64, chunk=None):
        """Dynamical matrix in eV^2 via jax.hessian in q-space.

        Replaces LAMMPS ``dynamical_matrix all eskm`` + the rpc^2
        conversion (lammpsdriver.py:89-102). D = conv conv^T (*)
        d^2 E / dx^2 evaluated at the (displaced) structure.

        ``chunk``: build the Hessian in row blocks of vmapped
        Hessian-vector products instead of one jax.hessian call —
        required for large systems where the full forward-over-reverse
        trace does not fit memory (10k+ DOF junctions), and much
        cheaper to compile from a few hundred DOF up.
        ``chunk=None`` auto-selects: full hessian below 512 DOF,
        256-row HVP blocks above. Identical result either way (tests
        pin it).

        With ``dtype=float64`` the Hessian is computed under
        ``jax.enable_x64`` on the default device, even for an f32
        driver: f32 second derivatives of a stiff many-body potential
        cancel catastrophically — on the 201-atom C/H junction an f32
        HVP Hessian had its top band at 0.29 eV^2 vs the true 0.81 and
        spurious unstable modes at -2.2e-4 eV^2 that blew up 16k-step
        harmonic runs.
        """
        import contextlib
        ctx64 = (jax.enable_x64(True) if dtype == jnp.float64
                 else contextlib.nullcontext())
        with ctx64:
            return self._dynmat_impl(q, dtype, chunk)

    def _dynmat_impl(self, q, dtype, chunk):
        nph = 3 * self.number
        np_dt = np.float64 if dtype == jnp.float64 else np.float32
        # q travels as a jit argument: one compiled block program
        # serves every displacement
        q_h = (np.zeros(nph, np_dt) if q is None
               else np.asarray(q, np_dt))
        xyz_h = np.asarray(self.xyz, np_dt)
        conv_h = np.asarray(self.conv, np_dt)
        na = self.number

        def e_of_q(qq):
            return self.energy_fn((xyz_h + conv_h * qq).reshape(na, 3))

        if chunk is None and nph > 512:
            chunk = 256
        if chunk:
            grad_fn = jax.grad(e_of_q)

            @jax.jit
            def hvp_block(qq, vs):
                return jax.vmap(
                    lambda v: jax.jvp(grad_fn, (qq,), (v,))[1])(vs)

            rows = []
            for i in range(0, nph, chunk):
                n = min(chunk, nph - i)
                eye_blk = np.zeros((n, nph), np_dt)
                eye_blk[np.arange(n), i + np.arange(n)] = 1.0
                rows.append(np.asarray(hvp_block(q_h, eye_blk)))
            h = jnp.asarray(np.concatenate(rows, axis=0))
        else:
            h = jax.hessian(e_of_q)(jnp.asarray(q_h))
        return 0.5 * (h + h.T)

    def quit(self):
        pass


class DriverShell:
    """Delegation base for JaxDriver specialisations (SW/Tersoff/EAM/
    CH/Pair drivers): subclasses build their energy function and call
    ``_attach``; the reference driver protocol then forwards to the
    wrapped JaxDriver."""

    def _attach(self, energy_fn, axyz, dtype, md2ang=U.MD2ANG):
        self._drv = JaxDriver(energy_fn, axyz, md2ang=md2ang,
                              dtype=dtype)
        self.energy_fn = energy_fn
        for attr in ("axyz", "conv", "xyz", "els", "number", "f0"):
            setattr(self, attr, getattr(self._drv, attr))

    def force(self, q):
        return self._drv.force(q)

    def newx(self, q):
        return self._drv.newx(q)

    def force_jax(self, q):
        return self._drv.force_jax(q)

    def energy_jax(self, q):
        """Jit-traceable total energy (eV) at relative displacement q
        (mass-weighted natural coordinates, like force_jax)."""
        return self._drv.energy_jax(q)

    def absforce(self, q):
        return self._drv.absforce(q)

    def initforce(self):
        self._drv.initforce()
        self.f0 = self._drv.f0

    def energy(self, q=None):
        return self._drv.energy(q)

    def dynmat(self, q=None, **kw):
        return self._drv.dynmat(q, **kw)

    def quit(self):
        pass


class HostDriver:
    """Adapter exposing a host-side force engine (real LAMMPS, Siesta,
    an external process, ...) inside the jitted step via
    ``jax.pure_callback``. Off the benchmark path by design: one host
    round-trip per evaluation, like the reference.

    ``host`` must implement the reference protocol: .force(q) -> (nph,),
    plus .conv / .f0 / .axyz passthrough.
    """

    def __init__(self, host, nph: int, dtype=jnp.float32):
        self.host = host
        self.nph = nph
        self.dtype = dtype
        for attr in ("conv", "f0", "axyz", "els", "xyz"):
            if hasattr(host, attr):
                setattr(self, attr, getattr(host, attr))

    def force_jax(self, q):
        shape = jax.ShapeDtypeStruct((self.nph,), self.dtype)
        return jax.pure_callback(
            lambda qq: np.asarray(self.host.force(np.asarray(qq)),
                                  dtype=self.dtype),
            shape, q, vmap_method="sequential")

    def force(self, q):
        return np.asarray(self.host.force(np.asarray(q)))

    def dynmat(self, q=None):
        return self.host.dynmat(q) if hasattr(self.host, "dynmat") else None

    def energy(self, *a, **kw):
        return self.host.energy(*a, **kw) \
            if hasattr(self.host, "energy") else None

    def quit(self):
        if hasattr(self.host, "quit"):
            self.host.quit()
