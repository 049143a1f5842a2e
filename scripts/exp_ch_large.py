"""Large hydrocarbon-junction datapoint: a programmatically built,
H-terminated graphene ribbon (models.hydrocarbon.terminate_with_h)
driven by CHDriver ensembles on the chip.

    JAX_PLATFORMS=cpu python scripts/exp_ch_large.py relax [NX NY]
    python scripts/exp_ch_large.py run [NTRAJ NMD]
"""

import os
import sys
import time

import numpy as np


HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(HERE, "relaxed_ribbon.npz")


def phase_relax(nx=24, ny=6):
    import jax.numpy as jnp

    from sclmd_jax.models.hydrocarbon import CHDriver, terminate_with_h
    from sclmd_jax.models.tersoff import graphene_ribbon
    from sclmd_jax.utils.junction import (partition_by_axis,
                                          relax_for_model)

    x = graphene_ribbon(nx, ny)
    axyz = terminate_with_h([["C", *row] for row in x])
    nh = sum(1 for a in axyz if a[0] == "H")
    print(f"ribbon: {len(axyz)} atoms ({nh} H terminators)")
    part = partition_by_axis(axyz)
    axyz, fmax, nit = relax_for_model(
        axyz, lambda a: CHDriver(a, dtype=jnp.float64),
        part["fixed_atoms"], tol=1e-2, maxit=3000)
    print(f"relaxed: fmax={fmax:.2e} ({nit} steps)")
    np.savez(CACHE, els=np.array([a[0] for a in axyz]),
             pos=np.array([a[1:] for a in axyz]))


def phase_run(ntraj=64, nmd=1024):
    import jax.numpy as jnp

    from sclmd_jax import baths as B
    from sclmd_jax.md import md
    from sclmd_jax.models.hydrocarbon import CHDriver
    from sclmd_jax.utils.junction import partition_by_axis

    ck = np.load(CACHE)
    axyz = [[str(e)] + list(map(float, p))
            for e, p in zip(ck["els"], ck["pos"])]
    # fixed-width leads: the reference's 25% proportions give ~950-DOF
    # baths at this size, and the per-step bath scatter/matmul then
    # dwarfs the physics (ensemble total throughput DROPS below a
    # single trajectory). ~8% per lead keeps the baths physical.
    part = partition_by_axis(axyz, frac_fixed=0.03, frac_lead=0.08)
    drv = CHDriver(axyz, dtype=jnp.float32)
    print(f"driver ready: {drv.number} atoms, lead DOFs "
          f"{len(part['ecatsl'])}", flush=True)

    T, delta, dt = 300.0, 0.1, 0.25 / 0.658
    t0 = time.time()
    runner = md(dt, nmd, T, axyz=axyz, dyn=np.asarray(drv.dynmat()),
                dtype=jnp.float32)
    print("dynmat: %.0f s" % (time.time() - t0), flush=True)
    runner.AddPotential(drv)
    damp = 100 / 0.658211814201041
    for cats, tt in ((part["ecatsl"], T * (1 + delta / 2)),
                     (part["ecatsr"], T * (1 - delta / 2))):
        eta = (1.0 / damp) * np.identity(len(cats))
        runner.AddBath(B.ebath(cats, tt, runner.dt, runner.nmd,
                               wmax=1.0, nw=500, efric=eta))
    runner.AddConstr([part["fixdofs"]])

    t0 = time.time()
    runner.RunEnsemble(ntraj, nsteps=nmd)
    print("cold: %.1f s" % (time.time() - t0), flush=True)
    times = []
    for _ in range(3):
        t0 = time.time()
        runner.RunEnsemble(ntraj, nsteps=nmd)
        times.append(time.time() - t0)
    tmed = sorted(times)[1]
    print("large CH ensemble: %d atoms ntraj=%d nmd=%d median %.2f s "
          "-> %.0f traj-steps/s"
          % (drv.number, ntraj, nmd, tmed, ntraj * nmd / tmed))


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "relax":
        nx = int(sys.argv[2]) if len(sys.argv) > 2 else 24
        ny = int(sys.argv[3]) if len(sys.argv) > 3 else 6
        phase_relax(nx, ny)
    else:
        ntraj = int(sys.argv[2]) if len(sys.argv) > 2 else 64
        nmd = int(sys.argv[3]) if len(sys.argv) > 3 else 1024
        phase_run(ntraj, nmd)