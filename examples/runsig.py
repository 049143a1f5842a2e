"""Lead self-energy by decimation surface Green's functions.

Counterpart of /root/reference/examples/runsig.py: extract principal-
layer blocks from a lead's dynamical matrix, run the vmapped decimation
sweep, write DOS and transmission.

Run:  python examples/runsig.py
"""

import time

import numpy as np
import jax.numpy as jnp

from sclmd_jax import units as U
from sclmd_jax.selfenergy import sig
from sclmd_jax.models.tersoff import TersoffDriver, graphene_ribbon


t0 = time.time()
# periodic-ish carbon strip as the lead material
x = graphene_ribbon(8, 2)
axyz = [["C", *row] for row in x]
drv = TersoffDriver(axyz, dtype=jnp.float64)
na = drv.number
d_ps2 = np.asarray(drv.dynmat()) / U.RPC ** 2

# two successive principal layers in the middle of the strip
lay = 3 * (na // 4)
g0 = list(range(lay, lay + 3 * 4))
g1 = list(range(lay + 3 * 4, lay + 3 * 8))

mode = sig(d_ps2, 0.12, g0, g1, num=400, eta=0.164e-3, write_files=True)
mode.getse("L")
mode.getse("R")
mode.gettm()
print("self-energy + transmission sweeps in %.1f s" % (time.time() - t0))
print("DOS peak: %.3e at %.4f eV"
      % (mode.dos[:, 1].max(),
         mode.dos[np.argmax(mode.dos[:, 1]), 0] * U.RPC))
