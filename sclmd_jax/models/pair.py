"""JAX-native pair potentials with static neighbor lists.

Stand-ins for LAMMPS pair styles on small junction systems: the energy
function is pure jnp over a fixed (na, 3) geometry, so forces come from
``jax.grad`` inside the jitted MD step and the dynamical matrix from
``jax.hessian`` (see models.driver.JaxDriver). Neighbor lists are static
(computed once from the relaxed structure with a skin) — correct for the
junction workloads where atoms vibrate around fixed sites, and exactly
what XLA wants: fixed shapes, gathers, fused elementwise math.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from sclmd_jax.models.driver import DriverShell


def neighbor_pairs(xyz: np.ndarray, cutoff: float, skin: float = 0.3,
                   cell: Optional[np.ndarray] = None):
    """Static (i, j) half pair list within cutoff+skin of the reference
    geometry. ``cell``: optional (3,) orthorhombic box for minimum-image
    displacement (None = open boundaries)."""
    x = np.asarray(xyz).reshape(-1, 3)
    na = len(x)
    d = x[None, :, :] - x[:, None, :]
    if cell is not None:
        cell = np.asarray(cell)
        d -= np.round(d / cell) * cell
    r = np.sqrt((d ** 2).sum(-1))
    ii, jj = np.nonzero((r < cutoff + skin) & (r > 0))
    keep = ii < jj
    return ii[keep], jj[keep]


def _pair_disp(x, i, j, cell=None):
    d = x[j] - x[i]
    if cell is not None:
        d -= jnp.round(d / cell) * cell
    return d


def lennard_jones_energy(epsilon, sigma, cutoff, pairs, cell=None,
                         shift=True):
    """LJ 12-6 energy function factory. ``epsilon``/``sigma`` may be
    scalars or per-pair arrays (precomputed mixing)."""
    i = jnp.asarray(pairs[0])
    j = jnp.asarray(pairs[1])
    eps = jnp.asarray(epsilon)
    sig = jnp.asarray(sigma)
    cell_j = None if cell is None else jnp.asarray(cell)

    sr6c = (sig / cutoff) ** 6
    eshift = 4.0 * eps * (sr6c ** 2 - sr6c) if shift else 0.0

    def energy(x):
        d = _pair_disp(x, i, j, cell_j)
        r2 = (d ** 2).sum(-1)
        sr6 = (sig ** 2 / r2) ** 3
        e = 4.0 * eps * (sr6 ** 2 - sr6) - eshift
        return jnp.sum(jnp.where(r2 < cutoff ** 2, e, 0.0))

    return energy


def morse_energy(D, alpha, r0, cutoff, pairs, cell=None, shift=False):
    """Morse potential energy factory: D (e^{-2a(r-r0)} - 2 e^{-a(r-r0)}).

    ``shift=True`` subtracts e(cutoff) inside the cutoff so the energy
    is continuous at rc (same convention as the LJ factory) — use it
    for MD where pairs may cross the cutoff; the raw form is the
    reference convention for fixed bond lists."""
    i = jnp.asarray(pairs[0])
    j = jnp.asarray(pairs[1])
    cell_j = None if cell is None else jnp.asarray(cell)
    exc = np.exp(-alpha * (cutoff - r0))
    eshift = D * (exc ** 2 - 2.0 * exc) if shift else 0.0

    def energy(x):
        d = _pair_disp(x, i, j, cell_j)
        r = jnp.sqrt((d ** 2).sum(-1))
        ex = jnp.exp(-alpha * (r - r0))
        e = D * (ex ** 2 - 2.0 * ex) - eshift
        return jnp.sum(jnp.where(r < cutoff, e, 0.0))

    return energy


def harmonic_bond_energy(k, r0, pairs, cell=None):
    """Sum of (k/2)(r - r0)^2 over an explicit bond list."""
    i = jnp.asarray(pairs[0])
    j = jnp.asarray(pairs[1])
    cell_j = None if cell is None else jnp.asarray(cell)

    def energy(x):
        d = _pair_disp(x, i, j, cell_j)
        r = jnp.sqrt((d ** 2).sum(-1))
        return jnp.sum(0.5 * k * (r - r0) ** 2)

    return energy


def sum_energies(*fns: Callable) -> Callable:
    def energy(x):
        return sum(f(x) for f in fns)
    return energy


class PairDriver(DriverShell):
    """Force driver for a pair-potential system (JaxDriver
    specialisation; the LAMMPS ``pair_style lj/cut`` / ``morse``
    stand-in, same duck-typed protocol as the reference drivers,
    ref lammpsdriver.py:19-102).

    ``kind``: "lj" (params epsilon, sigma) or "morse" (params D,
    alpha, r0). ``cutoff`` defaults to 2.5 sigma / r0 + 2.5/alpha.
    """

    def __init__(self, axyz, kind: str = "lj", params: Optional[dict] = None,
                 cutoff: Optional[float] = None, cell=None, skin: float = 0.3,
                 dtype=jnp.float64):
        p = dict(params or {})
        x0 = np.array([a[1:] for a in axyz], dtype=float)
        if kind == "lj":
            eps = p.get("epsilon", 1.0)
            sig = p.get("sigma", 1.0)
            rc = cutoff if cutoff is not None else 2.5 * sig
            pairs = neighbor_pairs(x0, rc, skin=skin, cell=cell)
            efn = lennard_jones_energy(eps, sig, rc, pairs, cell=cell,
                                       shift=True)
        elif kind == "morse":
            D, alpha, r0 = p.get("D", 1.0), p.get("alpha", 1.0), \
                p.get("r0", 1.0)
            rc = cutoff if cutoff is not None else r0 + 2.5 / alpha
            pairs = neighbor_pairs(x0, rc, skin=skin, cell=cell)
            efn = morse_energy(D, alpha, r0, rc, pairs, cell=cell,
                               shift=True)
        else:
            raise ValueError(f"unknown pair kind {kind!r}")
        self.pairs = pairs
        self._attach(efn, axyz, dtype)
