"""GLE MD thermal conductance of a carbon junction (quantum baths).

Counterpart of the reference workload examples/runmd.py: a C
junction driven by a Tersoff
bond-order potential (replacing LAMMPS REBO), two quantum electron-style
wideband baths at T(1 +- delta/2), thermal conductance from the averaged
bath heat currents. Everything inside one jitted scan per run.

Run:  python examples/runmd.py [--quick]
"""

import sys
import time

import numpy as np
import jax.numpy as jnp

from sclmd_jax import baths as B
from sclmd_jax.md import md
from sclmd_jax.models.tersoff import TersoffDriver, graphene_ribbon
from sclmd_jax.utils.tools import calHF, calTC


quick = "--quick" in sys.argv

# --- geometry: armchair graphene ribbon junction, or any LAMMPS data
# file (e.g. the reference's examples/structure.data) via --data PATH --
if "--data" in sys.argv:
    from sclmd_jax.utils.io import read_lammps_data
    datafile = sys.argv[sys.argv.index("--data") + 1]
    loaded = read_lammps_data(datafile)
    axyz = loaded["axyz"]
    print(f"loaded {len(axyz)} atoms from {datafile}")
else:
    x = graphene_ribbon(6 if quick else 10, 3)
    axyz = [["C", *row] for row in x]
na = len(axyz)

# partition along the transport (x) axis with the reference's
# proportions (runmd.py:31-38 — 20 fixed / 50 lead / 61 device / 50
# lead / 20 fixed on the 201-atom structure.data):
from sclmd_jax.utils.junction import partition_by_axis, relax_for_model

part = partition_by_axis(axyz)
fixdofs, ecatsl, ecatsr = part["fixdofs"], part["ecatsl"], part["ecatsr"]


def make_driver(a):
    if any(row[0] == "H" for row in a):
        # hydrogen-terminated input (e.g. the reference's
        # structure.data): Tersoff backbone + spectroscopic C-H
        # terminators
        from sclmd_jax.models.hydrocarbon import CHDriver
        return CHDriver(a, dtype=jnp.float32)
    return TersoffDriver(a, dtype=jnp.float32)


if "--data" in sys.argv:
    # external structures are minimized for the ORIGINAL potential
    # (structure.data: LAMMPS REBO); relax them for this model first,
    # holding the fixed ends (replaces the external LAMMPS minimize)
    axyz, fmax, nit = relax_for_model(axyz, make_driver,
                                      part["fixed_atoms"])
    print(f"relaxed for this potential: fmax={fmax:.2e} eV/Ang "
          f"({nit} relaxation steps)")

drv = make_driver(axyz)
print(f"junction: {na} atoms ({sorted(set(drv.els))})")

# --- MD setup (reference runmd.py:17-58) ---------------------------------
T = 300.0
delta = 0.1
nstart, nstop = 0, 2 if quick else 3
dt = 0.25 / 0.658               # 0.25 fs in natural time units
nmd = 2 ** (10 if quick else 12)

runner = md(dt, nmd, T, axyz=axyz, dyn=np.asarray(drv.dynmat()),
            nstart=nstart, nstop=nstop, dtype=jnp.float32)
runner.AddPotential(drv)

damp = 100 / 0.658211814201041
etal = (1.0 / damp) * np.identity(len(ecatsl))
etar = (1.0 / damp) * np.identity(len(ecatsr))
ebl = B.ebath(ecatsl, T * (1 + delta / 2), runner.dt, runner.nmd,
              wmax=1.0, nw=500, bias=0.0, efric=etal)
runner.AddBath(ebl)
ebr = B.ebath(ecatsr, T * (1 - delta / 2), runner.dt, runner.nmd,
              wmax=1.0, nw=500, bias=0.0, efric=etar)
runner.AddBath(ebr)
runner.AddConstr([fixdofs])

t0 = time.time()
if "--ensemble" in sys.argv:
    # proper statistics: N independent trajectories as ONE vmapped
    # scan (the reference runs its ensemble sequentially, md.py:506)
    ntraj = int(sys.argv[sys.argv.index("--ensemble") + 1])
    runner.RunEnsemble(ntraj)
    nsteps_total = ntraj * nmd
else:
    runner.Run()
    nsteps_total = (nstop - nstart) * nmd
print("MD wall time: %.1f s (%.0f traj-steps/s)"
      % (time.time() - t0, nsteps_total / (time.time() - t0)))

calHF()
calTC(delta=delta, dlist=0)
print(open(f"thermalconductance.{int(T)}.dat").read())
