"""GLE MD thermal conductance of a copper nanowire junction (EAM).

Metal-junction workload: an fcc Cu rod driven by the analytic
Sutton-Chen EAM potential (the physics the reference reaches only via
LAMMPS ``pair_style eam/alloy``, ref lammpsdriver.py), two quantum
Debye phonon baths at T(1 +- delta/2), thermal conductance from the
averaged bath heat currents, cross-checked against the NEGF Landauer
answer on the same junction.

Run:  python examples/runeam.py [--quick]
"""

import sys
import time

import numpy as np
import jax.numpy as jnp

from sclmd_jax import baths as B
from sclmd_jax.md import md
from sclmd_jax.models.eam import EAMDriver, SUTTON_CHEN_PARAMS, fcc_cell
from sclmd_jax.utils.tools import calHF, calTC

quick = "--quick" in sys.argv

# --- geometry: finite fcc Cu rod (leads at the +-z ends) -----------------
a0 = SUTTON_CHEN_PARAMS["Cu"]["a"]
nz = 4 if quick else 8
pos, _ = fcc_cell(2, 2, nz, a0)
axyz = [["Cu"] + list(p) for p in pos]

# relax the free rod first (the reference assumes structures minimized
# externally by LAMMPS; here FIRE runs natively on the same energy)
from sclmd_jax.models.relax import fire_relax

pre = EAMDriver(axyz, rcut=0.9 * a0, cutoff_skin=0.6)
pos, fmax, nit = fire_relax(pre.energy_fn, pos, tol=2e-4)
print(f"relaxed: fmax={fmax:.1e} eV/Ang in {nit} FIRE steps")
axyz = [["Cu"] + list(p) for p in pos]
drv = EAMDriver(axyz, rcut=0.9 * a0)   # first-shell cutoff: finite rod
na = drv.number
print(f"junction: {na} atoms, Sutton-Chen Cu")

# --- MD setup (reference runmd.py workflow) ------------------------------
T = 100.0
delta = 0.2
nstart, nstop = 0, 2 if quick else 3
dt = 0.5 / 0.658                 # 0.5 fs in natural time units
nmd = 2 ** (10 if quick else 12)

z = pos[:, 2]
zl, zr = np.quantile(z, 0.25), np.quantile(z, 0.75)
atl = np.nonzero(z < zl)[0]
atr = np.nonzero(z > zr)[0]
catsl = sorted(int(d) for i in atl for d in range(3 * i, 3 * i + 3))
catsr = sorted(int(d) for i in atr for d in range(3 * i, 3 * i + 3))

runner = md(dt, nmd, T, axyz=axyz, dyn=np.asarray(drv.dynmat()),
            nstart=nstart, nstop=nstop, dtype=jnp.float32)
runner.AddPotential(drv)

debye = 0.030                    # Cu Debye energy ~ k_B * 343 K (eV)
ml = 64
pbl = B.phbath(T * (1 + delta / 2), catsl, debye, 200, runner.dt,
               runner.nmd, ml=ml)
runner.AddBath(pbl)
pbr = B.phbath(T * (1 - delta / 2), catsr, debye, 200, runner.dt,
               runner.nmd, ml=ml)
runner.AddBath(pbr)

t0 = time.time()
runner.Run()
print("MD wall time: %.1f s (%.0f steps/s)"
      % (time.time() - t0, (nstop - nstart) * nmd / (time.time() - t0)))

calHF()
calTC(delta=delta, dlist=0)
print(open(f"thermalconductance.{int(T)}.dat").read())

# --- NEGF cross-check on the same junction -------------------------------
# matched lead model: the Markovian Debye friction gamma = w_D pi/6 (eV)
# corresponds to a wideband Sigma^r = -i w gamma, i.e. damping time
# damp = hbar / gamma in ps (bpt's damp parameter).
from sclmd_jax import units as U
from sclmd_jax.negf import bpt

damp = U.RPC / (debye * np.pi / 6.0)
b = bpt(drv, 0.05, damp, [catsl, catsr], num=60 if quick else 200)
b.gettm()
kappa = b.thermalconductance(T, delta)
print(f"NEGF Landauer conductance at T={T}: {kappa:.4e}")
