"""Force-consistency harness: anharmonic minus harmonic force statistics.

Counterpart of /root/reference/examples/compareforce.py + tools.avdf:
records driver.force(q) + D q each MD step (the deviation of the real
potential from its harmonic expansion), dumps deltaforce.runJ.npy, and
analyses the running mean/deviation.

Run:  python examples/compareforce.py
"""

import numpy as np
import jax.numpy as jnp

from sclmd_jax import baths as B
from sclmd_jax.md import md
from sclmd_jax.models.tersoff import TersoffDriver, graphene_ribbon
from sclmd_jax.utils.tools import avdf


x = graphene_ribbon(4, 2)
axyz = [["C", *row] for row in x]
drv = TersoffDriver(axyz, dtype=jnp.float32)
na = drv.number

dt, nmd, T = 0.25 / 0.658, 2 ** 10, 300.0
runner = md(dt, nmd, T, axyz=axyz, dyn=np.asarray(drv.dynmat()),
            nstop=2, dtype=jnp.float32)
runner.AddPotential(drv)

nlead = 3 * (na // 3)
eta = np.eye(nlead) * (0.658 / 100)
runner.AddBath(B.ebath(range(nlead), T, dt, nmd, wmax=1.0, efric=eta))
runner.CompareForce(drv)
runner.Run()

avdf(["deltaforce.run0.npy", "deltaforce.run1.npy"])
dev = np.loadtxt("deltaforce-deviation1.dat")
print("anharmonic force deviation: mean %.3e max %.3e" %
      (dev.mean(), dev.max()))
