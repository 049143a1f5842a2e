"""NEGF ballistic phonon transmission + Landauer thermal conductance.

Counterpart of /root/reference/examples/runnegf.py: the same junction's
dynamical matrix (from jax.hessian of the Tersoff potential — replacing
the 146 s LAMMPS eskm call), batched Caroli transmission, thermal
conductance over a temperature sweep. Cross-validates examples/runmd.py.

Run:  python examples/runnegf.py [--data structure.data]
"""

import sys
import time

import numpy as np
import jax.numpy as jnp

from sclmd_jax import units as U
from sclmd_jax.negf import bpt
from sclmd_jax.models.tersoff import TersoffDriver, graphene_ribbon


t0 = time.time()
if "--data" in sys.argv:
    # any LAMMPS data file, e.g. the reference's structure.data
    from sclmd_jax.utils.io import read_lammps_data
    from sclmd_jax.utils.junction import (partition_by_axis,
                                          relax_for_model)

    axyz = read_lammps_data(sys.argv[sys.argv.index("--data") + 1])["axyz"]
    part = partition_by_axis(axyz)

    def make_driver(a):
        if any(row[0] == "H" for row in a):
            from sclmd_jax.models.hydrocarbon import CHDriver
            return CHDriver(a)
        return TersoffDriver(a, dtype=jnp.float64)

    axyz, fmax, _ = relax_for_model(axyz, make_driver,
                                    part["fixed_atoms"])
    print(f"relaxed for this potential: fmax={fmax:.2e} eV/Ang")
    drv = make_driver(axyz)
    atomfixed = [part["fixdofs"][:len(part["fixdofs"]) // 2],
                 part["fixdofs"][len(part["fixdofs"]) // 2:]]
    atomofbath = [part["ecatsl"], part["ecatsr"]]
else:
    x = graphene_ribbon(6, 3)
    axyz = [["C", *row] for row in x]
    drv = TersoffDriver(axyz, dtype=jnp.float64)
    na3 = 3 * len(axyz)
    atomfixed = [list(range(0, 6)), list(range(na3 - 6, na3))]
    nlead = 3 * (len(axyz) // 4)
    atomofbath = [list(range(6, 6 + nlead)),
                  list(range(na3 - 6 - nlead, na3 - 6))]
na = drv.number
dynmat_ev2 = np.asarray(drv.dynmat())       # eV^2 (natural units)
dynmat_ps2 = dynmat_ev2 / U.RPC ** 2        # eskm ps^-2 convention
print("dynamical matrix (%d DOF) in %.1f s" % (3 * na, time.time() - t0))

mybpt = bpt(dynmat_ps2, 0.25, 0.1, atomofbath, atomfixed, num=500,
            write_files=True)
t0 = time.time()
mybpt.gettm()
print("transmission sweep (%d points) in %.2f s"
      % (mybpt.intnum + 1, time.time() - t0))

delta = 0.1
for temp in (100, 300, 500, 700, 1000):
    print("T=%4d K  conductance %.4e nW/K"
          % (temp, mybpt.thermalconductance(temp, delta)))

ps = mybpt.getps(300.0, 0.25, 200)
print("power spectrum: %d points, max %.3e" % (len(ps), ps[:, 1].max()))
