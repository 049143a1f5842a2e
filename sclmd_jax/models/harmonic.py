"""Harmonic force driver — the deterministic test oracle.

Equivalent of the reference's dynamical-matrix fallback
(/root/reference/sclmd/md.py:466-467): F(q) = -D q in mass-weighted
natural units. Also the simplest instance of the JAX driver protocol
(same duck-typed surface as the reference drivers: ``.axyz``, ``.conv``,
``.f0``, ``.force(q)``, ``.initforce()``, ``.dynmat()``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from sclmd_jax import units as U
from sclmd_jax.ops.functions import symmetrize


class HarmonicDriver:
    """Pure-harmonic force engine with a jittable ``force``.

    Parameters
    ----------
    dyn : (nph, nph) dynamical matrix in eV^2 (natural units).
    axyz : optional list of [element, x, y, z] rows (angstrom).
    """

    def __init__(self, dyn, axyz=None, md2ang=U.MD2ANG, dtype=jnp.float32):
        self.dyn = symmetrize(jnp.asarray(dyn, dtype))
        self.nph = self.dyn.shape[0]
        self.md2ang = md2ang
        self.axyz = axyz
        if axyz is not None:
            self.els = [a[0] for a in axyz]
            self.xyz = np.array([a[1:] for a in axyz], dtype=float).flatten()
            mass = np.array([U.AtomicMassTable[e] for e in self.els])
            self.conv = md2ang * np.repeat(1.0 / np.sqrt(mass), 3)
        else:
            self.els, self.xyz = None, None
            self.conv = np.ones(self.nph)
        self.initforce()

    def initforce(self):
        self.f0 = jnp.zeros((self.nph,), self.dyn.dtype)

    def absforce(self, q):
        return self.force(q)

    def force(self, q):
        return -(self.dyn @ q)

    # alias used by the md wrapper to pick the jittable path explicitly
    force_jax = force

    def energy(self, q=None):
        if q is None:
            return 0.0
        q = jnp.asarray(q, self.dyn.dtype)
        return 0.5 * q @ self.dyn @ q

    def dynmat(self, q=None):
        return self.dyn

    def quit(self):
        pass


def chain_dynmat(n: int, k: float = 0.1, kend: float | None = None,
                 dtype=jnp.float64):
    """Dynamical matrix of a 1D nearest-neighbour chain (n sites, spring k
    in eV^2). Useful analytic fixture: phonon band w in [0, 2 sqrt(k)].
    """
    kend = k if kend is None else kend
    d = np.zeros((n, n))
    for i in range(n - 1):
        kk = k
        d[i, i] += kk
        d[i + 1, i + 1] += kk
        d[i, i + 1] -= kk
        d[i + 1, i] -= kk
    d[0, 0] += kend
    d[n - 1, n - 1] += kend
    return jnp.asarray(d, dtype)
