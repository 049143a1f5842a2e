"""Hydrogen-terminated carbon junctions: Tersoff backbone + C-H bonds.

The reference's flagship workload (ref examples/runmd.py +
examples/structure.data: a 201-atom C/H graphene junction) runs on
LAMMPS ``pair_style rebo``. This rebuild replaces REBO's carbon
physics with the published Tersoff bond-order set (models/tersoff.py,
the standard substitute for sp2 carbon transport). REBO's
hydrogen-termination splines have no published Tersoff-form
counterpart, so H atoms are modelled explicitly as terminators:

- one Morse bond H - nearest C from textbook spectroscopic constants
  (D = 4.3 eV bond energy, r0 = 1.09 Ang, alpha = 1.885 /Ang fitted to
  the ~3000 cm^-1 aromatic C-H stretch),
- harmonic auxiliary springs H - adjacent C (the carbon neighbors of
  the anchor) at their initial lengths, stiffness ``k_bend`` chosen to
  put the in-plane C-H bending modes in the observed 800-1300 cm^-1
  band,
- an out-of-plane wag term k_oop/2 (u . n)^2 per H (u = C->H vector,
  n = unit normal of the anchor's two adjacent carbons) — in a planar
  edge radial springs alone leave the wag unrestored; this puts it
  near the observed ~800-950 cm^-1 band.

This is a documented approximation: thermal transport in these
junctions is carried by the C backbone; H only terminates edges. The
C-H stretch/bend frequency bands are pinned by tests
(tests/test_hydrocarbon.py) so the terminator physics stays honest.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from sclmd_jax.models.driver import DriverShell

# textbook C-H spectroscopic constants (see module docstring)
CH_MORSE = dict(D=4.3, r0=1.09, alpha=1.885, cutoff=1.9)
CH_BEND_K = 4.0          # eV/Ang^2 auxiliary-spring stiffness
CH_OOP_K = 2.5           # eV/Ang^2 out-of-plane wag stiffness


def ch_energy(axyz, cell: Optional[np.ndarray] = None,
              max_nnei: Optional[int] = None, cutoff_skin: float = 0.4,
              morse: Optional[dict] = None, k_bend: float = CH_BEND_K,
              k_oop: float = CH_OOP_K,
              tersoff_params: Optional[dict] = None):
    """Energy-function factory for a C/H system: returns
    ``energy(x)`` over the FULL (na, 3) cartesian array (eV), plus the
    (h_index, anchor_c) bond list for inspection."""
    from sclmd_jax.models.nnp import build_neighbors
    from sclmd_jax.models.pair import (harmonic_bond_energy,
                                       morse_energy)
    from sclmd_jax.models.tersoff import TERSOFF_PARAMS, tersoff_energy

    m = dict(CH_MORSE) if morse is None else dict(morse)
    els = [a[0] for a in axyz]
    bad = sorted(set(els) - {"C", "H"})
    if bad:
        raise NotImplementedError(
            f"ch_energy handles C/H only, got {bad}")
    x0 = np.array([a[1:] for a in axyz], dtype=float)
    c_ids = np.array([i for i, e in enumerate(els) if e == "C"])
    h_ids = np.array([i for i, e in enumerate(els) if e == "H"],
                     dtype=int)

    # carbon backbone: Tersoff over the C sub-lattice
    tp = (tersoff_params or TERSOFF_PARAMS)["C"]
    rcut_c = tp["R"] + tp["D"]
    nbr_c, mask_c = build_neighbors(x0[c_ids], rcut_c, max_nnei,
                                    cell=cell, skin=cutoff_skin)
    e_c = tersoff_energy("C", nbr_c, mask_c, cell=cell,
                         params=tersoff_params)
    c_sel = jnp.asarray(c_ids)

    def disp(a, b):
        d = x0[b] - x0[a]
        if cell is not None:
            d = d - np.round(d / np.asarray(cell)) * np.asarray(cell)
        return d

    # each H bonds to its nearest C; aux springs to that C's neighbors
    bonds = []       # (h, c_anchor)
    aux = []         # (h, c_adjacent, rest_length)
    oop = []         # (h, c_anchor, c_adj1, c_adj2)
    for h in h_ids:
        d = np.array([np.linalg.norm(disp(h, c)) for c in c_ids])
        anchor = int(c_ids[np.argmin(d)])
        if d.min() > m["cutoff"]:
            raise ValueError(f"H atom {h} has no C within "
                             f"{m['cutoff']} Ang")
        bonds.append((h, anchor))
        loc = np.nonzero(c_ids == anchor)[0][0]
        adj = []
        for jn in np.nonzero(mask_c[loc])[0]:
            cadj = int(c_ids[nbr_c[loc, jn]])
            rl = np.linalg.norm(disp(h, cadj))
            if rl < 2.6:
                aux.append((h, cadj, rl))
                adj.append(cadj)
        if len(adj) >= 2:
            # skip anchors whose adjacents are (near-)collinear: the
            # plane normal is undefined there (sp chains) and the
            # normalised cross product would blow up
            e1 = disp(anchor, adj[0])
            e2 = disp(anchor, adj[1])
            sin2 = np.linalg.norm(np.cross(e1, e2)) / (
                np.linalg.norm(e1) * np.linalg.norm(e2))
            if sin2 > 0.1:
                oop.append((h, anchor, adj[0], adj[1]))
    bonds = np.asarray(bonds, dtype=int).reshape(-1, 2)

    e_ch = morse_energy(m["D"], m["alpha"], m["r0"], m["cutoff"] + 1.0,
                        (bonds[:, 0], bonds[:, 1]), cell=cell) \
        if len(bonds) else None
    if aux:
        aux_np = np.asarray([(a, b) for a, b, _ in aux], dtype=int)
        rl_np = np.asarray([r for _, _, r in aux])
        e_bend = harmonic_bond_energy(k_bend, jnp.asarray(rl_np),
                                      (aux_np[:, 0], aux_np[:, 1]),
                                      cell=cell)
    else:
        e_bend = None

    if oop:
        oop_np = np.asarray(oop, dtype=int)         # (nb, 4)
        oi = [jnp.asarray(oop_np[:, k]) for k in range(4)]
        cell_o = None if cell is None else jnp.asarray(cell)

        def _mic(d):
            return d if cell_o is None else \
                d - jnp.round(d / cell_o) * cell_o

        def e_oop(x):
            u = _mic(x[oi[0]] - x[oi[1]])           # C1 -> H
            e1 = _mic(x[oi[2]] - x[oi[1]])
            e2 = _mic(x[oi[3]] - x[oi[1]])
            nvec = jnp.cross(e1, e2)
            # where-trick: bonds passing through exact collinearity
            # during MD must not divide by 0 — and the GRADIENT of a
            # norm at the zero vector is 0/0, so the guard must sit
            # inside the sqrt argument, not be an additive floor
            n2 = jnp.sum(nvec * nvec, axis=-1, keepdims=True)
            ok = n2 > 1e-12
            nhat = jnp.where(
                ok, nvec / jnp.sqrt(jnp.where(ok, n2, 1.0)), 0.0)
            return 0.5 * k_oop * jnp.sum(
                jnp.sum(u * nhat, axis=-1) ** 2)
    else:
        e_oop = None

    def energy(x):
        x = jnp.asarray(x)
        e = e_c(x[c_sel])
        if e_ch is not None:
            e = e + e_ch(x)
        if e_bend is not None:
            e = e + e_bend(x)
        if e_oop is not None:
            e = e + e_oop(x)
        return e

    return energy, bonds


def terminate_with_h(axyz, cell=None, bond: float = CH_MORSE["r0"],
                     cc_cut: float = 1.8, target_coord: int = 3):
    """Passivate under-coordinated carbon edges with hydrogen.

    For every C with fewer than ``target_coord`` carbon neighbors
    (within ``cc_cut`` Ang), add one H at distance ``bond`` along the
    outward bisector of the existing bonds (in the local sheet plane).
    Returns a new axyz list with the H rows appended — the
    programmatic counterpart of the reference's pre-terminated
    structure.data edges."""
    els = [a[0] for a in axyz]
    x0 = np.array([a[1:] for a in axyz], dtype=float)
    c_ids = [i for i, e in enumerate(els) if e == "C"]
    xc = x0[c_ids]

    def mic(d):
        if cell is None:
            return d
        c = np.asarray(cell)
        return d - np.round(d / c) * c

    out = [list(a) for a in axyz]
    for k, i in enumerate(c_ids):
        d = mic(xc - x0[i])
        r = np.linalg.norm(d, axis=1)
        nbrs = np.nonzero((r > 1e-6) & (r < cc_cut))[0]
        if len(nbrs) >= target_coord or len(nbrs) == 0:
            continue
        u = -(d[nbrs] / r[nbrs, None]).sum(0)
        norm = np.linalg.norm(u)
        if norm < 1e-6:
            continue        # bonds balance (e.g. linear chain middle)
        out.append(["H"] + list(x0[i] + bond * u / norm))
    return out


class CHDriver(DriverShell):
    """Force driver for hydrogen-terminated carbon junctions
    (JaxDriver specialisation; the reference's structure.data + REBO
    workload, ref examples/runmd.py + lammpsdriver.py force path)."""

    def __init__(self, axyz, cell=None, max_nnei=None, cutoff_skin=0.4,
                 dtype=jnp.float64, morse=None, k_bend=CH_BEND_K,
                 k_oop=CH_OOP_K, tersoff_params=None):
        efn, bonds = ch_energy(axyz, cell=cell, max_nnei=max_nnei,
                               cutoff_skin=cutoff_skin, morse=morse,
                               k_bend=k_bend, k_oop=k_oop,
                               tersoff_params=tersoff_params)
        self.ch_bonds = bonds
        self._attach(efn, axyz, dtype)
