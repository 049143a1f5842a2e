"""Current-induced-force MD: biased center bath with wind forces.

Counterpart of /root/reference/examples/current-induced/rundp.py: the
biased junction carries three baths — two equilibrium leads plus a
biased electron bath on the center whose eta/xim/xip matrices come from
the Lambda pipeline (the reference reads a precomputed
grapheneLambda nc file; here the full pipeline runs first on a model
electronic structure, writing + reading the same bundle).

Run:  python examples/current_induced/rundp.py [--quick]
"""

import sys

import numpy as np
import jax.numpy as jnp

from sclmd_jax import baths as B
from sclmd_jax.md import md
from sclmd_jax.models.harmonic import chain_dynmat
from sclmd_jax.postprocess.lambda_pipeline import (LambdaPipeline,
                                                   fft_order_grid)
from sclmd_jax.utils.io import ReadwbLambda, WritewbLambda
from sclmd_jax.utils.tools import calHF


quick = "--quick" in sys.argv
rng = np.random.default_rng(42)

# --- stage 1: Lambda pipeline on a model device electronic structure ----
ncenter = 4                       # center atoms coupled to electrons
nm = 3 * ncenter                  # phonon DOFs on the center
n_el = 10                        # electronic orbitals
E = fft_order_grid(4.0, 256)
h = rng.normal(size=(n_el, n_el))
H = 0.4 * (h + h.T) / 2 + 0j
S = np.eye(n_el, dtype=complex)
gl = np.zeros((n_el, n_el)); gl[:2, :2] = np.eye(2) * 0.8
gr = np.zeros((n_el, n_el)); gr[-2:, -2:] = np.eye(2) * 0.8
band = 1.0 / (1.0 + (E / 2.8) ** 6)
SigL = -0.5j * band[:, None, None] * gl[None]
SigR = -0.5j * band[:, None, None] * gr[None]
m = rng.normal(size=(nm, n_el, n_el)) * 0.08
M = np.array([(mi + mi.T) / 2 for mi in m], dtype=complex)
hw = np.sort(rng.random(nm) * 0.15 + 0.02)

pl = LambdaPipeline(H, S, E, SigL, SigR, M, hw)
wb = pl.wideband(hwcut=0.05, mu0=0.0)
WritewbLambda("wbLambda.npz", wb["eta"], wb["xim"], wb["xip"],
              wb["zeta1"], wb["zeta2"])
_, eta_c, xim_c, xip_c, z1_c, z2_c = ReadwbLambda("wbLambda.npz")
print("wideband matrices: |eta|max %.3e |xim|max %.3e"
      % (np.abs(eta_c).max(), np.abs(xim_c).max()))

# --- stage 2: GLE MD with the biased center bath (rundp.py:60-88) -------
na = 24
nph = 3 * na
dyn = np.asarray(chain_dynmat(nph, 0.04))
axyz = [["C", 1.4 * i, 0.0, 0.0] for i in range(na)]
T, bias = 300.0, 0.5
dt, nmd = 0.5 / 0.658, 2 ** (9 if quick else 11)

runner = md(dt, nmd, T, axyz=axyz, dyn=dyn, nstop=1 if quick else 2,
            dtype=jnp.float64)
damp = 100 / 0.658211814201041
nlead = 18
etal = (1.0 / damp) * np.identity(nlead)
runner.AddBath(B.ebath(range(nlead), T, dt, nmd, wmax=2.0, nw=1000,
                       efric=etal, zpmotion=False, dtype=jnp.float64))
runner.AddBath(B.ebath(range(nph - nlead, nph), T, dt, nmd, wmax=2.0,
                       nw=1000, efric=etal, zpmotion=False,
                       dtype=jnp.float64))
# biased center bath with current-induced wind forces
center = list(range(nph // 2 - nm // 2, nph // 2 + nm - nm // 2))
# make eta positive definite and strong enough to damp the bias wind
# forces (current-induced instabilities are physical — runaway modes at
# high bias; the example stays in the stable regime)
eta_pd = eta_c + np.eye(nm) * (abs(np.linalg.eigvalsh(eta_c)).max() + 2e-3)
runner.AddBath(B.ebath(center, T, dt, nmd, wmax=2.0, nw=1000, bias=bias,
                       efric=eta_pd, exim=xim_c, exip=xip_c,
                       zpmotion=False, dtype=jnp.float64))
runner.noranvel()
runner.Run()

calHF(dlist=0 if quick else 1, bathnum=3)
print("heat flux per bath written; bias wind force active on",
      len(center), "center DOFs")
