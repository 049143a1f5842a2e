"""Junction setup helpers: lead partitioning and model re-relaxation.

The reference hand-codes per-structure DOF index lists (ref
examples/runmd.py:31-38: 20 fixed / 50 lead / 61 device / 50 lead / 20
fixed atoms of the x-ordered structure.data) and assumes structures
arrive minimized for the force engine in use (LAMMPS ``minimize``).
These helpers generalise both steps: geometric partitioning along the
transport axis with the reference's proportions as defaults, and FIRE
re-relaxation of an imported structure for whatever model drives it
here (imported files are minimized for the ORIGINAL engine's
potential — e.g. REBO — not for this framework's substitute)."""

from __future__ import annotations

import numpy as np


def partition_by_axis(axyz, axis: int = 0, frac_fixed: float = 0.0995,
                      frac_lead: float = 0.2488):
    """Split atoms into [fixed | lead L | device | lead R | fixed]
    along a coordinate axis.

    Returns a dict with atom index arrays (``fixed_atoms``, ``leadl``,
    ``leadr``, ``device``) and flat DOF lists (``fixdofs``, ``ecatsl``,
    ``ecatsr``) in the reference's 3*i..3*i+2 convention. Defaults
    reproduce the reference partition exactly on the 201-atom
    structure.data."""
    na = len(axyz)
    coord = np.array([a[1 + axis] for a in axyz], dtype=float)
    order = np.argsort(coord, kind="stable")
    nfix = max(2, round(frac_fixed * na))
    nlead = max(2, round(frac_lead * na))
    if 2 * (nfix + nlead) >= na:
        raise ValueError("partition_by_axis: fractions leave no device")

    def dofs(atoms):
        return sorted(int(d) for i in atoms
                      for d in range(3 * i, 3 * i + 3))

    fixed = np.concatenate([order[:nfix], order[-nfix:]])
    leadl = order[nfix:nfix + nlead]
    leadr = order[-nfix - nlead:-nfix]
    device = order[nfix + nlead:-nfix - nlead]
    return dict(fixed_atoms=fixed, leadl=leadl, leadr=leadr,
                device=device, fixdofs=dofs(order[:nfix]) +
                dofs(order[-nfix:]), ecatsl=dofs(leadl),
                ecatsr=dofs(leadr))


def relax_for_model(axyz, make_driver, fixed_atoms=None, tol: float = 5e-3,
                    maxit: int = 2000, iters: int = 2,
                    method: str = "lbfgs"):
    """Relax a structure for the model built by ``make_driver``
    (a callable axyz -> driver with ``.energy_fn``), holding
    ``fixed_atoms`` frozen. ``method``: "lbfgs" (default) or "fire".

    ``iters`` rebuild/relax rounds: drivers that derive internal rest
    geometry from the input (e.g. CHDriver terminator springs) shift
    their minimum on rebuild, so one extra round re-converges.
    Returns (axyz_relaxed, fmax, steps_of_last_round)."""
    import jax

    from sclmd_jax.models import relax as R

    relaxer = R.lbfgs_relax if method == "lbfgs" else R.fire_relax
    x = np.array([a[1:] for a in axyz], dtype=float)
    mask = np.zeros(x.shape, bool)
    if fixed_atoms is not None:
        mask[np.asarray(fixed_atoms, int)] = True
    # float32 stalls near fmax ~ 0.1 eV/Ang: linesearch energy
    # differences fall below f32 resolution of a ~keV total energy.
    # Relaxation is setup-time work, so it runs in f64 on the default
    # device; the MD hot loop keeps its own dtype.
    out = list(axyz)
    fmax, nit = np.inf, 0
    with jax.enable_x64(True):
        for _ in range(max(1, iters)):
            drv = make_driver(out)
            x, fmax, nit = relaxer(drv.energy_fn, x, tol=tol,
                                   maxit=maxit, fixed_mask=mask)
            out = [[a[0]] + list(p) for a, p in zip(out, x)]
    return out, fmax, nit
