"""Tersoff bond-order potential in pure JAX.

REBO-class many-body carbon potential standing in for the reference's
LAMMPS ``pair_style rebo`` force path (lammpsdriver.py; md.py
potforce): covalent bond order b_ij depends on the local environment
through the angular function g(theta), so bond breaking/formation
physics is captured — unlike pair potentials. All tensors are fixed
shape (padded static neighbor table), so the energy sits happily inside
the jitted MD scan and ``jax.hessian`` gives the dynamical matrix
(replacing the 146 s LAMMPS eskm call, negf.py:63).

Functional form (J. Tersoff, PRB 39, 5566 (1989)):

    E = 1/2 sum_i sum_j fc(r_ij) [ fR(r_ij) + b_ij fA(r_ij) ]
    fR = A exp(-l1 r),  fA = -B exp(-l2 r)
    b_ij = (1 + (beta zeta_ij)^n)^(-1/2n)
    zeta_ij = sum_k fc(r_ik) g(th_ijk) exp[l3^m (r_ij - r_ik)^m]
    g(th) = gamma (1 + c^2/d^2 - c^2/(d^2 + (h - cos th)^2))

Parameters for carbon are Tersoff's published 1989 values.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from sclmd_jax.models.driver import DriverShell

# Tersoff (1989) single-element parameter sets (public constants).
TERSOFF_PARAMS = {
    "C": dict(A=1393.6, B=346.74, lam1=3.4879, lam2=2.2119, lam3=0.0,
              beta=1.5724e-7, n=0.72751, c=38049.0, d=4.3484,
              h=-0.57058, R=1.95, D=0.15, gamma=1.0, m=3.0),
    "Si": dict(A=1830.8, B=471.18, lam1=2.4799, lam2=1.7322, lam3=0.0,
               beta=1.1e-6, n=0.78734, c=100390.0, d=16.217,
               h=-0.59825, R=2.85, D=0.15, gamma=1.0, m=3.0),
    "Ge": dict(A=1769.0, B=419.23, lam1=2.4451, lam2=1.7047, lam3=0.0,
               beta=9.0166e-7, n=0.75627, c=106430.0, d=15.652,
               h=-0.43884, R=2.95, D=0.15, gamma=1.0, m=3.0),
}

# inter-element bond-strength correction chi_ij (Tersoff PRB 39, 5566)
TERSOFF_CHI = {("Si", "C"): 0.9776, ("Si", "Ge"): 1.00061,
               ("C", "Ge"): 1.0}


def _chi(e1, e2):
    if e1 == e2:
        return 1.0
    return TERSOFF_CHI.get((e1, e2), TERSOFF_CHI.get((e2, e1), 1.0))


def tersoff_energy_multi(elements, neighbors, nmask,
                         cell: Optional[np.ndarray] = None,
                         params: Optional[dict] = None):
    """Multi-element Tersoff with the 1989 mixing rules.

    elements: per-atom element symbols. Pair quantities use
    lam_ij = (lam_i + lam_j)/2, A_ij = sqrt(A_i A_j),
    B_ij = chi_ij sqrt(B_i B_j), R_ij = sqrt(R_i R_j),
    D_ij = sqrt(D_i D_j); the bond-order parameters (beta, n, c, d, h)
    are those of the CENTER atom i. Same static-shape padded-tensor
    scheme as the single-element kernel.
    """
    table = params or TERSOFF_PARAMS
    els = list(elements)
    na = len(els)
    nbr = np.asarray(neighbors)
    mask = np.asarray(nmask)
    cell_j = None if cell is None else jnp.asarray(cell)

    def per_atom(key):
        return np.array([table[e][key] for e in els])

    def per_pair(fn):
        out = np.zeros(nbr.shape)
        for i in range(na):
            for jn in range(nbr.shape[1]):
                out[i, jn] = fn(els[i], els[nbr[i, jn]])
        return out

    def mix_avg(key):
        return per_pair(lambda a, b: 0.5 * (table[a][key] + table[b][key]))

    def mix_sqrt(key):
        return per_pair(lambda a, b: np.sqrt(table[a][key] * table[b][key]))

    # Tersoff 1989 applies chi only to the attractive B term, not A
    A_ij = jnp.asarray(per_pair(
        lambda a, b: np.sqrt(table[a]["A"] * table[b]["A"])))
    B_ij = jnp.asarray(per_pair(
        lambda a, b: _chi(a, b) * np.sqrt(table[a]["B"] * table[b]["B"])))
    l1_ij = jnp.asarray(mix_avg("lam1"))
    l2_ij = jnp.asarray(mix_avg("lam2"))
    R_ij = jnp.asarray(mix_sqrt("R"))
    D_ij = jnp.asarray(mix_sqrt("D"))
    # center-atom angular/bond-order params, broadcast over neighbors
    beta_i = jnp.asarray(per_atom("beta"))[:, None]
    n_i = jnp.asarray(per_atom("n"))[:, None]
    c_i = jnp.asarray(per_atom("c"))[:, None, None]
    d_i = jnp.asarray(per_atom("d"))[:, None, None]
    h_i = jnp.asarray(per_atom("h"))[:, None, None]
    gamma_i = jnp.asarray(per_atom("gamma"))[:, None, None]
    lam3_np = per_atom("lam3")
    l3_i = jnp.asarray(lam3_np)[:, None, None]
    m_i = jnp.asarray(per_atom("m"))[:, None, None]
    # cutoff of the i-k leg inside zeta uses R_ik of the (i, k) pair
    nbr_j = jnp.asarray(nbr)
    mask_j = jnp.asarray(mask)

    def fc(r, R, D):
        inner = r < R - D
        outer = r > R + D
        mid = 0.5 - 0.5 * jnp.sin(0.5 * jnp.pi * (r - R) / D)
        return jnp.where(inner, 1.0, jnp.where(outer, 0.0, mid))

    def energy(x):
        x = jnp.asarray(x)
        xi = x[:, None, :]
        xj = x[nbr_j]
        dij = xj - xi
        if cell_j is not None:
            dij = dij - jnp.round(dij / cell_j) * cell_j
        r2 = jnp.sum(dij * dij, axis=-1)
        rij = jnp.sqrt(jnp.where(mask_j, r2, 1.0))
        fcij = jnp.where(mask_j, fc(rij, R_ij, D_ij), 0.0)

        rhat = dij / rij[..., None]
        cos_ijk = jnp.einsum("ija,ika->ijk", rhat, rhat)
        # c^2/d^2 - c^2/(d^2 + u) written as one quotient: the two
        # terms are ~8e7 for carbon and their difference loses ~4
        # digits in float32
        u = (h_i - cos_ijk) ** 2
        g = gamma_i * (1.0 + c_i ** 2 * u / (d_i ** 2 * (d_i ** 2 + u)))
        # lam3/m exponential of the CENTER atom (matches the
        # single-element kernel; built-in C/Si/Ge sets have lam3=0)
        if np.any(lam3_np != 0.0):
            rik = rij[:, None, :]
            expo = jnp.exp((l3_i * (rij[:, :, None] - rik)) ** m_i)
        else:
            expo = 1.0
        fck = fcij[:, None, :]
        notself = ~jnp.eye(nbr_j.shape[1], dtype=bool)[None]
        zeta = jnp.sum(jnp.where(notself, fck * g * expo, 0.0), axis=-1)

        bz = beta_i * zeta
        bz_safe = jnp.where(bz > 0, bz, 1.0)
        bterm = jnp.where(bz > 0, bz_safe ** n_i, 0.0)
        bij = (1.0 + bterm) ** (-1.0 / (2.0 * n_i))

        fR = A_ij * jnp.exp(-l1_ij * rij)
        fA = -B_ij * jnp.exp(-l2_ij * rij)
        e_pair = fcij * (fR + bij * fA)
        return 0.5 * jnp.sum(jnp.where(mask_j, e_pair, 0.0))

    return energy


def tersoff_energy(element: str, neighbors, nmask,
                   cell: Optional[np.ndarray] = None,
                   params: Optional[dict] = None):
    """Energy-function factory for a single-element Tersoff system.

    neighbors / nmask : padded (na, nn) static neighbor table
    (models.nnp.build_neighbors). Returns ``energy(x)`` for x (na, 3)
    in angstrom -> eV.
    """
    p = dict(TERSOFF_PARAMS[element]) if params is None else dict(params)
    nbr = jnp.asarray(neighbors)
    mask = jnp.asarray(nmask)
    cell_j = None if cell is None else jnp.asarray(cell)
    R, D = p["R"], p["D"]

    def fc(r):
        inner = r < R - D
        outer = r > R + D
        mid = 0.5 - 0.5 * jnp.sin(0.5 * jnp.pi * (r - R) / D)
        return jnp.where(inner, 1.0, jnp.where(outer, 0.0, mid))

    def g(costh):
        # cancellation-free form of 1 + c2/d2 - c2/(d2 + u) (see
        # tersoff_energy_multi)
        c2, d2 = p["c"] ** 2, p["d"] ** 2
        u = (p["h"] - costh) ** 2
        return p["gamma"] * (1.0 + c2 * u / (d2 * (d2 + u)))

    def energy(x):
        x = jnp.asarray(x)
        xi = x[:, None, :]
        xj = x[nbr]                       # (na, nn, 3)
        dij = xj - xi
        if cell_j is not None:
            dij = dij - jnp.round(dij / cell_j) * cell_j
        r2 = jnp.sum(dij * dij, axis=-1)
        rij = jnp.sqrt(jnp.where(mask, r2, 1.0))       # (na, nn)
        fcij = jnp.where(mask, fc(rij), 0.0)

        # angular sum over k for every (i, j): cos th_ijk from the same
        # padded table
        rhat = dij / rij[..., None]                    # (na, nn, 3)
        cos_ijk = jnp.einsum("ija,ika->ijk", rhat, rhat)   # (na, nn, nn)
        rik = rij[:, None, :]                          # (na, 1, nn)
        if p["lam3"] == 0.0:
            expo = 1.0
        else:
            expo = jnp.exp((p["lam3"] * (rij[:, :, None] - rik))
                           ** p["m"])
        fck = jnp.where(mask, fc(rij), 0.0)[:, None, :]    # (na, 1, nn)
        notself = ~jnp.eye(nbr.shape[1], dtype=bool)[None]  # k != j
        zeta = jnp.sum(jnp.where(notself, fck * g(cos_ijk) * expo, 0.0),
                       axis=-1)                        # (na, nn)

        # (beta zeta)^n has an unbounded derivative at zeta = 0 (n < 1):
        # use the safe-where pattern so grad/hessian stay finite for
        # isolated bonds and padded entries
        bz = p["beta"] * zeta
        bz_safe = jnp.where(bz > 0, bz, 1.0)
        bterm = jnp.where(bz > 0, bz_safe ** p["n"], 0.0)
        bij = (1.0 + bterm) ** (-1.0 / (2.0 * p["n"]))

        fR = p["A"] * jnp.exp(-p["lam1"] * rij)
        fA = -p["B"] * jnp.exp(-p["lam2"] * rij)
        e_pair = fcij * (fR + bij * fA)
        return 0.5 * jnp.sum(jnp.where(mask, e_pair, 0.0))

    return energy


def graphene_ribbon(nx: int, ny: int, a: float = 1.42):
    """Generate an armchair graphene-ribbon geometry — a programmatic
    stand-in for the reference's structure.data junction. Returns the
    (na, 3) positions array in angstrom (open boundaries)."""
    pos = []
    dx = 1.5 * a
    dy = np.sqrt(3) * a
    for i in range(nx):
        for j in range(ny):
            x0 = i * dx
            y0 = j * dy + (0.5 * dy if i % 2 else 0.0)
            pos.append([x0, y0, 0.0])
            pos.append([x0 + a * 0.5, y0 + dy / 2, 0.0])
    return np.array(pos)


class TersoffDriver(DriverShell):
    """Force driver for a Tersoff system (JaxDriver specialisation)."""

    def __init__(self, axyz, cutoff_skin=0.4, max_nnei=None, cell=None,
                 element=None, dtype=jnp.float64, params=None):
        from sclmd_jax.models.nnp import build_neighbors
        els = [a[0] for a in axyz]
        uniq = sorted(set(els))
        x0 = np.array([a[1:] for a in axyz], dtype=float)
        table = params or TERSOFF_PARAMS
        if len(uniq) == 1:
            element = element or uniq[0]
            if element not in table:
                raise NotImplementedError(
                    f"no Tersoff parameters for element {element!r}; "
                    "supply params=")
            pcut = table[element]
            nbr, mask = build_neighbors(x0, pcut["R"] + pcut["D"],
                                        max_nnei, cell=cell,
                                        skin=cutoff_skin)
            efn = tersoff_energy(element, nbr, mask, cell=cell,
                                 params=None if params is None
                                 else pcut)
        else:
            missing = [e for e in uniq if e not in table]
            if missing:
                raise NotImplementedError(
                    f"no Tersoff parameters for elements {missing}; "
                    "supply params=")
            rcut = max(table[e]["R"] + table[e]["D"] for e in uniq)
            nbr, mask = build_neighbors(x0, rcut, max_nnei, cell=cell,
                                        skin=cutoff_skin)
            efn = tersoff_energy_multi(els, nbr, mask, cell=cell,
                                       params=table)
        self._attach(efn, axyz, dtype)
