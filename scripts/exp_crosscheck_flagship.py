"""Flagship physics loop: MD thermal conductance vs NEGF Landauer on
the reference's own structure.data junction (VERDICT r2 item 1).

This is the reference's headline validation workflow
(/root/reference/README.md:31-35: examples/runmd.py vs
examples/runnegf.py — same junction, same observable, two independent
methods) executed at full scale: the 201-atom C/H junction, CHDriver
many-body forces, 150-DOF wideband leads.

Phases:

    JAX_PLATFORMS=cpu python scripts/exp_crosscheck_flagship.py relax
    JAX_PLATFORMS=cpu python scripts/exp_crosscheck_flagship.py negf
    python scripts/exp_crosscheck_flagship.py md [--harmonic] \
        [--ntraj N] [--nmd N] [--seed S]

``negf`` (CPU, f64): CHDriver Hessian -> bpt Caroli transmission ->
Landauer current; writes scripts/flagship_negf.npz.

``md`` (accelerator): antithetic common-random-numbers ensemble — two
RunEnsemble calls with the SAME seed and swapped lead temperatures
(TL,TR) vs (TR,TL). Identical seeds give identical Gaussian draws
(ops.noise sample_* use jax.random.normal(key, std.shape): the key
schedule and shapes do not depend on T), so the zero-point-scale
fluctuations cancel in (J_fwd - J_rev)/2 to the DeltaT signal scale —
the estimator proven at tests/test_crosscheck.py:92-155, now at
flagship scale. ``--harmonic`` drops the anharmonic CHDriver force and
runs on the junction's own dynamical matrix: there MD *must* reproduce
the (harmonic) NEGF answer, isolating the integrator+noise+estimator
check from real anharmonicity. Without it, the MD-NEGF gap IS the
anharmonic correction to ballistic transport.
"""

import os
import sys
import time

import numpy as np


HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(HERE, "relaxed_structure.npz")
NEGF_CACHE = os.path.join(HERE, "flagship_negf.npz")
DATA = "/root/reference/examples/structure.data"

T, DELTA = 300.0, 0.1
DT = 0.25 / 0.658
DAMP_NAT = 100 / 0.658211814201041      # 100 fs in natural time
MAXOMEGA_EV = 0.45                      # above the C-H stretch band


def load_axyz():
    # the committed NEGF cache is self-contained (carries the relaxed
    # geometry), so the MD phase / bench crosscheck run cold from a
    # fresh clone; the relax-phase cache is a local intermediate
    ck = np.load(CACHE if os.path.exists(CACHE) else NEGF_CACHE)
    return [[str(e)] + list(map(float, p))
            for e, p in zip(ck["els"], ck["pos"])]


def phase_relax():
    import jax.numpy as jnp

    from sclmd_jax.models.hydrocarbon import CHDriver
    from sclmd_jax.utils.io import read_lammps_data
    from sclmd_jax.utils.junction import (partition_by_axis,
                                          relax_for_model)

    axyz = read_lammps_data(DATA)["axyz"]
    part = partition_by_axis(axyz)
    axyz, fmax, nit = relax_for_model(
        axyz, lambda a: CHDriver(a, dtype=jnp.float64),
        part["fixed_atoms"])
    print(f"relaxed: fmax={fmax:.2e} ({nit} steps)")
    np.savez(CACHE,
             els=np.array([a[0] for a in axyz]),
             pos=np.array([a[1:] for a in axyz]))


def phase_negf(num=4000):
    import jax
    jax.config.update("jax_enable_x64", True)   # dense 603-DOF solves
    import jax.numpy as jnp

    from sclmd_jax import units as U
    from sclmd_jax.models.hydrocarbon import CHDriver
    from sclmd_jax.negf import bpt, landauer_current_natural
    from sclmd_jax.utils.junction import partition_by_axis

    axyz = load_axyz()
    part = partition_by_axis(axyz)
    drv = CHDriver(axyz, dtype=jnp.float64)
    t0 = time.time()
    dyn_ev2 = np.asarray(drv.dynmat())
    print("dynmat %d DOF in %.1f s" % (len(dyn_ev2), time.time() - t0))

    fixdofs = part["fixdofs"]
    atomfixed = [fixdofs[:len(fixdofs) // 2], fixdofs[len(fixdofs) // 2:]]
    mybpt = bpt(dyn_ev2 / U.RPC ** 2, MAXOMEGA_EV, 0.1,
                [part["ecatsl"], part["ecatsr"]], atomfixed, num=num)
    t0 = time.time()
    mybpt.gettm()
    print("transmission sweep (%d pts) in %.1f s"
          % (num + 1, time.time() - t0))
    ws_ev = mybpt.tmnumber[:, 0] * U.RPC
    tm = mybpt.tmnumber[:, 1]
    TL, TR = T * (1 + DELTA / 2), T * (1 - DELTA / 2)
    j_nat = float(landauer_current_natural(ws_ev, tm, TL, TR))
    kappa_nat = j_nat / (T * DELTA) * U.CURCOF      # nW/K
    kappa_bpt = mybpt.thermalconductance(T, DELTA)  # nW/K, bpt's own units
    print(f"NEGF: J={j_nat:.6e} (natural) kappa={kappa_nat:.5f} nW/K "
          f"(bpt units path: {kappa_bpt:.5f} nW/K)")
    np.savez(NEGF_CACHE, ws_ev=ws_ev, tm=tm, j_nat=j_nat,
             kappa_nw_per_k=kappa_nat, kappa_bpt=kappa_bpt,
             T=T, delta=DELTA, dyn_ev2=dyn_ev2,
             els=np.array([a[0] for a in axyz]),
             pos=np.array([a[1:] for a in axyz], dtype=np.float64))


def md_antithetic(axyz, part, ntraj, nmd, seed, harmonic,
                  dt=DT, temp=T, delta=DELTA, outbase=None,
                  dyn=None, equil_frac=0.25, steady_init=False,
                  classical=False):
    """Antithetic CRN ensemble pair; returns per-trajectory J (natural
    units). Reusable by bench.py's crosscheck section."""
    import tempfile

    import jax.numpy as jnp

    from sclmd_jax import baths as B
    from sclmd_jax.md import md as MDRunner
    from sclmd_jax.models.hydrocarbon import CHDriver

    drv = CHDriver(axyz, dtype=jnp.float32)
    # the dynamical matrix must be the f64 one (f32 HVP Hessians of
    # this stiff potential are badly wrong — top band 0.29 vs 0.81 eV^2
    # with spurious unstable modes); reuse the NEGF phase's matrix so
    # both sides of the crosscheck share one Hessian
    if dyn is None:
        if os.path.exists(NEGF_CACHE):
            dyn = np.load(NEGF_CACHE)["dyn_ev2"]
        else:
            dyn = np.asarray(drv.dynmat())   # routed to CPU f64
    TL, TR = temp * (1 + delta / 2), temp * (1 - delta / 2)

    def one_direction(Ta, Tb, tag):
        tmp = outbase or tempfile.mkdtemp(prefix=f"xcheck_{tag}_")
        os.makedirs(tmp, exist_ok=True)
        runner = MDRunner(dt, nmd, temp, axyz=axyz, dyn=dyn,
                          dtype=jnp.float32, seed=seed,
                          outdir=tmp)
        if not harmonic:
            runner.AddPotential(drv)
        for cats, tt in ((part["ecatsl"], Ta), (part["ecatsr"], Tb)):
            eta = (1.0 / DAMP_NAT) * np.identity(len(cats))
            runner.AddBath(B.ebath(cats, tt, runner.dt, runner.nmd,
                                   wmax=1.0, nw=500, efric=eta,
                                   classical=classical))
        runner.AddConstr([part["fixdofs"]])
        means = runner.RunEnsemble(ntraj, nsteps=nmd,
                                   equil_frac=equil_frac,
                                   steady_init=steady_init)
        return (means[:, 0] - means[:, 1]) / 2

    jf = one_direction(TL, TR, "fwd")
    jr = one_direction(TR, TL, "rev")
    return (jf - jr) / 2


def flagship_builder(axyz, part, nmd, seed, dt=DT, temp=T, dyn=None):
    """build(Ta, Tb) callback for parallel.ensemble.antithetic_run on
    the flagship structure.data junction (reusable by bench.py)."""
    import tempfile

    import jax.numpy as jnp

    from sclmd_jax import baths as B
    from sclmd_jax.md import md as MDRunner

    if dyn is None:
        dyn = np.load(NEGF_CACHE)["dyn_ev2"]

    def build(Ta, Tb):
        runner = MDRunner(dt, nmd, temp, axyz=axyz, dyn=dyn,
                          dtype=jnp.float32, seed=seed,
                          outdir=tempfile.mkdtemp(prefix="xw_"))
        for cats, tt in ((part["ecatsl"], Ta), (part["ecatsr"], Tb)):
            eta = (1.0 / DAMP_NAT) * np.identity(len(cats))
            runner.AddBath(B.ebath(cats, tt, runner.dt, runner.nmd,
                                   wmax=1.0, nw=500, efric=eta))
        runner.AddConstr([part["fixdofs"]])
        return runner

    return build


def md_antithetic_warm(axyz, part, ntraj, nmd, seed, dt=DT, temp=T,
                       delta=DELTA, dyn=None):
    """Antithetic CRN ensemble with the PERIODIC-ATTRACTOR warm start —
    now a thin wrapper over the packaged estimator
    (sclmd_jax.parallel.ensemble.antithetic_run; VERDICT r3 item 3)."""
    from sclmd_jax.parallel.ensemble import antithetic_run

    TL, TR = temp * (1 + delta / 2), temp * (1 - delta / 2)
    build = flagship_builder(axyz, part, nmd, seed, dt=dt, temp=temp,
                             dyn=dyn)
    return antithetic_run(build, TL, TR, ntraj, nsteps=nmd, seed=seed,
                          warm_start=True)


def phase_md(ntraj=64, nmd=2 ** 14, seed=11, harmonic=False,
             warm=False):
    from sclmd_jax import units as U
    from sclmd_jax.utils.junction import partition_by_axis

    axyz = load_axyz()
    part = partition_by_axis(axyz)

    t0 = time.time()
    if warm:
        j = np.asarray(md_antithetic_warm(axyz, part, ntraj, nmd, seed))
    else:
        j = np.asarray(md_antithetic(axyz, part, ntraj, nmd, seed,
                                     harmonic))
    wall = time.time() - t0
    j_md = float(j.mean())
    sem = float(j.std() / np.sqrt(len(j)))
    kappa_md = j_md / (T * DELTA) * U.CURCOF
    label = ("harmonic+warm" if warm
             else "harmonic" if harmonic else "anharmonic (CHDriver)")
    print(f"MD [{label}] ntraj={ntraj} nmd={nmd} seed={seed}: "
          f"J={j_md:.6e} SEM {sem / abs(j_md) * 100:.2f}% "
          f"kappa={kappa_md:.5f} nW/K  ({wall:.0f} s, "
          f"{2 * ntraj * nmd / wall:.0f} traj-steps/s incl. both "
          "directions)")
    if os.path.exists(NEGF_CACHE):
        negf = np.load(NEGF_CACHE)
        dev = (j_md - float(negf["j_nat"])) / float(negf["j_nat"])
        print(f"vs NEGF kappa={float(negf['kappa_nw_per_k']):.5f} nW/K: "
              f"deviation {dev * 100:+.2f}%")
    else:
        print("(no NEGF cache — run the negf phase first)")


if __name__ == "__main__":
    phase = sys.argv[1] if len(sys.argv) > 1 else "md"
    if phase == "relax":
        phase_relax()
    elif phase == "negf":
        phase_negf()
    elif phase == "md":
        def arg(name, default, cast=int):
            return cast(sys.argv[sys.argv.index(name) + 1]) \
                if name in sys.argv else default
        phase_md(ntraj=arg("--ntraj", 64), nmd=arg("--nmd", 2 ** 14),
                 seed=arg("--seed", 11),
                 harmonic="--harmonic" in sys.argv,
                 warm="--warm" in sys.argv)
    else:
        raise SystemExit(f"unknown phase {phase}")
