"""Biased NEGF: phonon heating under current (bias self-energy).

Counterpart of /root/reference/examples/current-induced/runnegf.py:
ballistic transport with an extra bias self-energy block on the center
atoms (chi+- matrices), comparing equilibrium and biased power spectra.

Run:  python examples/current_induced/runnegf.py
"""

import numpy as np

from sclmd_jax import units as U
from sclmd_jax.negf import bpt
from sclmd_jax.models.harmonic import chain_dynmat


n = 30
d_ev2 = np.asarray(chain_dynmat(n, 0.04))
d_ps2 = d_ev2 / U.RPC ** 2

bathL, bathR = list(range(0, 6)), list(range(n - 6, n))
center = list(range(12, 18))

b = bpt(d_ps2, 0.5, 0.1, [bathL, bathR], num=400, write_files=True)
b.gettm()
print("ballistic conductance at 300 K: %.4e nW/K"
      % b.thermalconductance(300.0, 0.1))

ps_eq = b.getps(300.0, 0.5, 200)

nb = len(center)
b.setbias(0.6, bdamp=np.eye(nb) * 0.05,
          chiplus=np.eye(nb) * 0.02, chiminus=np.zeros((nb, nb)),
          dofatomofbias=center)
ps_bias = b.getps(300.0, 0.5, 200, atomlist=center,
                  filename="biascenter")
print("power spectrum integral: equilibrium %.3e, biased-center %.3e"
      % (np.trapezoid(ps_eq[:, 1], ps_eq[:, 0]),
         np.trapezoid(ps_bias[:, 1], ps_bias[:, 0])))
