"""Stillinger-Weber potential in pure JAX.

Second many-body family beside Tersoff (models/tersoff.py) — the
standard silicon/germanium thermal-transport potential the reference
obtains from LAMMPS ``pair_style sw`` (lammpsdriver.py force path).
Static padded neighbor tables keep all shapes fixed, so the energy sits
inside the jitted MD scan and ``jax.hessian`` provides the dynamical
matrix.

Functional form (Stillinger & Weber, PRB 31, 5262 (1985)):

    E  = sum_{i<j} phi2(r_ij) + sum_i sum_{j<k} phi3(r_ij, r_ik, th_jik)
    phi2 = A eps [B (sig/r)^p - (sig/r)^q] exp(sig / (r - a sig))
    phi3 = lam eps [cos th - cos th0]^2
           exp(gam sig / (r_ij - a sig)) exp(gam sig / (r_ik - a sig))

Both terms vanish smoothly (with all derivatives) at r = a sig.
Parameters are the published 1985 silicon set (and the common Ge fit).
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from sclmd_jax.models.driver import DriverShell

# published parameter sets (public constants); energies eV, lengths Ang
SW_PARAMS = {
    "Si": dict(eps=2.1683, sigma=2.0951, a=1.80, lam=21.0, gam=1.20,
               costheta0=-1.0 / 3.0, A=7.049556277, B=0.6022245584,
               p=4.0, q=0.0),
    "Ge": dict(eps=1.93, sigma=2.181, a=1.80, lam=31.0, gam=1.20,
               costheta0=-1.0 / 3.0, A=7.049556277, B=0.6022245584,
               p=4.0, q=0.0),
}


def _powi(x, e):
    """x**e, unrolled to multiplies when e is a small integer.

    Float ``**`` lowers to exp/log on the VPU; the published SW sets use
    p=4, q=0, so the two-body term needs no transcendentals at all.
    """
    ei = int(e)
    if float(ei) != float(e) or not (0 <= ei <= 16):
        return x ** e
    if ei == 0:
        return jnp.ones_like(x)
    acc = None
    base = x
    while ei:
        if ei & 1:
            acc = base if acc is None else acc * base
        ei >>= 1
        if ei:
            base = base * base
    return acc


def sw_energy(element: str, neighbors, nmask,
              cell: Optional[np.ndarray] = None,
              params: Optional[dict] = None):
    """Energy-function factory: returns ``energy(x)`` (x (na, 3) Ang ->
    eV) for a single-element Stillinger-Weber system over a static
    padded neighbor table (models.nnp.build_neighbors)."""
    p = dict(SW_PARAMS[element]) if params is None else dict(params)
    nbr = jnp.asarray(neighbors)
    mask = jnp.asarray(nmask)
    cell_j = None if cell is None else jnp.asarray(cell)
    eps, sig, a = p["eps"], p["sigma"], p["a"]
    rcut = a * sig

    def _tail(r, pref):
        """exp(pref*sig/(r - a sig)) with a smooth hard zero at rcut."""
        inside = r < rcut - 1e-9
        denom = jnp.where(inside, r - rcut, -1.0)
        return jnp.where(inside, jnp.exp(pref * sig / denom), 0.0)

    def energy(x):
        x = jnp.asarray(x)
        xi = x[:, None, :]
        xj = x[nbr]                              # (na, nn, 3)
        d = xj - xi
        if cell_j is not None:
            d = d - jnp.round(d / cell_j) * cell_j
        r2 = jnp.sum(d * d, axis=-1)
        r = jnp.sqrt(jnp.where(mask, r2, 1.0))   # (na, nn)

        # two-body (counted once per pair via the 1/2)
        sr = sig / r
        phi2 = p["A"] * eps * (p["B"] * _powi(sr, p["p"])
                               - _powi(sr, p["q"])) * _tail(r, 1.0)
        e2 = 0.5 * jnp.sum(jnp.where(mask, phi2, 0.0))

        # three-body: center i, legs j and k (each unordered pair once
        # via the 1/2 and a j != k mask)
        rhat = d / r[..., None]
        cosq = jnp.einsum("ija,ika->ijk", rhat, rhat)   # (na, nn, nn)
        h = _tail(r, p["gam"])                           # (na, nn)
        pairm = (mask[:, :, None] & mask[:, None, :]
                 & ~jnp.eye(nbr.shape[1], dtype=bool)[None])
        phi3 = p["lam"] * eps * (cosq - p["costheta0"]) ** 2 \
            * h[:, :, None] * h[:, None, :]
        e3 = 0.5 * jnp.sum(jnp.where(pairm, phi3, 0.0))
        return e2 + e3

    return energy


def diamond_cell(nx: int, ny: int, nz: int, a0: float = 5.431):
    """Diamond-lattice slab of nx x ny x nz conventional cells.

    Returns (positions (na, 3) Ang, cell (3,) lengths for the periodic
    wrap). a0 = 5.431 is the SW-silicon equilibrium lattice constant.
    """
    basis = np.array([[0, 0, 0], [0, 2, 2], [2, 0, 2], [2, 2, 0],
                      [1, 1, 1], [1, 3, 3], [3, 1, 3], [3, 3, 1]],
                     dtype=float) * (a0 / 4.0)
    pos = []
    for i in range(nx):
        for j in range(ny):
            for k in range(nz):
                off = np.array([i, j, k], dtype=float) * a0
                pos.extend(basis + off)
    cell = np.array([nx, ny, nz], dtype=float) * a0
    return np.array(pos), cell


class SWDriver(DriverShell):
    """Force driver for a Stillinger-Weber system (JaxDriver
    specialisation; same duck-typed protocol as the reference drivers).
    """

    def __init__(self, axyz, cutoff_skin=0.4, max_nnei=None, cell=None,
                 element=None, dtype=jnp.float64, params=None):
        from sclmd_jax.models.nnp import build_neighbors
        els = [a[0] for a in axyz]
        uniq = sorted(set(els))
        if len(uniq) != 1:
            raise NotImplementedError(
                "SWDriver is single-element; supply per-system params "
                "or use TersoffDriver for mixed systems")
        element = element or uniq[0]
        table = params or SW_PARAMS.get(element)
        if table is None:
            raise NotImplementedError(
                f"no SW parameters for element {element!r}; supply "
                "params=")
        x0 = np.array([a[1:] for a in axyz], dtype=float)
        rcut = table["a"] * table["sigma"]
        nbr, mask = build_neighbors(x0, rcut, max_nnei, cell=cell,
                                    skin=cutoff_skin)
        efn = sw_energy(element, nbr, mask, cell=cell, params=table)
        self._attach(efn, axyz, dtype)
