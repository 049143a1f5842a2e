"""Batched trajectory ensembles on a device mesh.

No reference counterpart — the reference runs trajectories sequentially
(md.py:506). Here an ensemble of independent GLE trajectories (each
with its own colored noise) runs as ONE program, vmapped and sharded
over the available devices (dp axis), with per-bath matrices optionally
sharded over a tp axis.

Run:  python examples/ensemble.py [ntraj]
"""

import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

from sclmd_jax import baths as B, units as U
from sclmd_jax.md import GLESystem, initial_state
from sclmd_jax.models.harmonic import chain_dynmat
from sclmd_jax.parallel.ensemble import (ensemble_noise, ensemble_run,
                                         ensemble_states, make_mesh,
                                         shard_ensemble)

ntraj = int(sys.argv[1]) if len(sys.argv) > 1 else 64
nph, dt, nmd, T, delta = 100, 0.25 / 0.658, 1024, 300.0, 0.1

dyn = jnp.asarray(chain_dynmat(nph, 0.04), jnp.float32)
eta = np.eye(10) * (0.658 / 100)
ebl = B.ebath(range(10), T * (1 + delta / 2), dt, nmd, wmax=1.0, efric=eta)
# right lead: non-Markovian memory kernel -> the blocked-convolution
# fast path (md.run_segment_blocked) engages
ml = 128
gwl = np.linspace(0.0, 0.6, 32)
gam = np.array([np.eye(10) * 0.01 * np.exp(-(w / 0.25) ** 2)
                for w in gwl])
pbr = B.phbath(T * (1 - delta / 2), range(nph - 10, nph), 0.3, 64,
               dt, nmd, ml=ml, gamma=gam, gwl=gwl)
system = GLESystem(dyn=dyn, baths=(ebl, pbr), mask=jnp.ones(nph),
                   dt=dt, nph=nph, ml=ml, nmd=nmd)

bsys = ensemble_noise(system, jax.random.PRNGKey(0), ntraj)
states = ensemble_states(bsys, ntraj)

ndev = len(jax.devices())
if ndev > 1:
    mesh = make_mesh({"dp": ndev})
    bsys, states = shard_ensemble(mesh, bsys, states, dp="dp")
    ctx = mesh
    print(f"sharding {ntraj} trajectories over {ndev} devices")
else:
    import contextlib
    ctx = contextlib.nullcontext()

with ctx:
    t0 = time.time()
    finals, ys = ensemble_run(bsys, states, nmd, block=128)
    jax.block_until_ready(finals.p)
    t1 = time.time()
    finals, ys = ensemble_run(bsys, finals, nmd, block=128)
    jax.block_until_ready(finals.p)
    t2 = time.time()

rate = ntraj * nmd / (t2 - t1)
print("compile %.1f s; %d trajectories x %d steps in %.2f s"
      % (t1 - t0, ntraj, nmd, t2 - t1))
print("aggregate %.2e traj-steps/s  (%.1f 'effective' serial MDs)"
      % (rate, rate / 12.5))
cur = np.asarray(jax.jit(lambda c: jnp.mean(c, axis=(0, 1)))(ys["cur"]))
print("ensemble-averaged bath currents:", cur)
