"""Anharmonic QUANTUM flagship conductance (VERDICT r3 item 1 — the
production observable).

The reference's validation configuration is anharmonic MD vs harmonic
NEGF (ref examples/runmd.py:27 REBO forces vs
examples/runnegf.py:17-28). Direct quasiclassical MD cannot measure
the quantum anharmonic correction to useful precision on this
junction: (a) with full zero-point noise the anharmonic trajectories
carry a ZP-leakage circulation ~1000x the DeltaT signal, and (b) with
ANY common-random-numbers pairing (antithetic, harmonic twin) the
chaotic trajectories decorrelate within ~1k steps, leaving a per-pair
spread ~60x the signal (measured here with --direct; ~6e5 pairs for a
2% SEM). What IS measurable with MC-tight error bars is the
perturbative response along the stable harmonic attractor
(parallel.ensemble.perturbative_anharmonic_response):

    kappa_anh ≈ kappa_exact + d1 + d2/2,   d_k = d^k J/d lambda^k |_0

with the measured |d2/2| vs |d1| controlling the series truncation at
lambda=1, j0 (the lambda=0 primal) reproducing the exact attractor
value as a built-in consistency gate, and the whole machinery pinned
against closed-form theory in tests/test_exact_gle.py.

    python scripts/exp_xcheck_anh.py [--ntraj N] [--nmd LOG2N]
        [--seed S] [--direct]
"""

import os
import sys
import time

import numpy as np


HERE = os.path.dirname(os.path.abspath(__file__))
NEGF_CACHE = os.path.join(HERE, "flagship_negf.npz")

T, DELTA = 300.0, 0.1
DT = 0.25 / 0.658
DAMP_NAT = 100 / 0.658211814201041


def builders(axyz, part, dyn, nmd, seed, zpmotion=True,
             classical=False):
    import tempfile

    import jax.numpy as jnp

    from sclmd_jax import baths as B
    from sclmd_jax.md import md as MDRunner
    from sclmd_jax.models.hydrocarbon import CHDriver

    drv = CHDriver(axyz, dtype=jnp.float32)

    def base(Ta, Tb):
        runner = MDRunner(DT, nmd, T, axyz=axyz, dyn=dyn,
                          dtype=jnp.float32, seed=seed,
                          outdir=tempfile.mkdtemp(prefix="anh_"))
        for cats, tt in ((part["ecatsl"], Ta), (part["ecatsr"], Tb)):
            eta = (1.0 / DAMP_NAT) * np.identity(len(cats))
            runner.AddBath(B.ebath(cats, tt, runner.dt, runner.nmd,
                                   wmax=1.0, nw=500, efric=eta,
                                   zpmotion=zpmotion,
                                   classical=classical))
        runner.AddConstr([part["fixdofs"]])
        return runner

    def build_anh(Ta, Tb):
        r = base(Ta, Tb)
        r.AddPotential(drv)
        return r

    return base, build_anh


def exact_j(nmd):
    """Cached zero-MC theory value for this tier, if available."""
    fn = os.path.join(HERE, f"flagship_exact_nmd{nmd}.npz")
    if os.path.exists(fn):
        return float(np.load(fn)["j_nat"]), "exact_gle attractor theory"
    return None, None


def main():
    from sclmd_jax import units as U
    from sclmd_jax.parallel.ensemble import (
        harmonic_twin_delta, perturbative_anharmonic_response)
    from sclmd_jax.utils.junction import partition_by_axis

    def arg(name, default, cast=int):
        return cast(sys.argv[sys.argv.index(name) + 1]) \
            if name in sys.argv else default

    ntraj = arg("--ntraj", 32)
    nmd = 2 ** arg("--nmd", 14)
    seed = arg("--seed", 11)

    negf = np.load(NEGF_CACHE)
    axyz = [[str(e)] + list(map(float, p))
            for e, p in zip(negf["els"], negf["pos"])]
    part = partition_by_axis(axyz)
    dyn = negf["dyn_ev2"]
    TL, TR = T * (1 + DELTA / 2), T * (1 - DELTA / 2)
    j_ref = float(negf["j_nat"])
    build_harm, build_anh = builders(axyz, part, dyn, nmd, seed)

    if "--direct" in sys.argv:
        # the infeasibility measurement (documented in PERF.md): the
        # harmonic-twin delta's per-pair spread vs the signal
        t0 = time.time()
        d, ja, jh = harmonic_twin_delta(build_harm, build_anh, TL, TR,
                                        ntraj, nsteps=nmd, seed=seed,
                                        return_parts=True)
        sem = d.std() / np.sqrt(ntraj)
        print(f"DIRECT twin delta ({time.time() - t0:.0f} s): mean "
              f"{d.mean() / j_ref * 100:+.1f}% SEM "
              f"{sem / j_ref * 100:.1f}% of J_ref; per-pair spread "
              f"{d.std() / j_ref:.1f}x signal -> "
              f"{(d.std() / j_ref / 0.02) ** 2:,.0f} pairs for 2%")
        return

    t0 = time.time()
    j0, d1, d2 = perturbative_anharmonic_response(
        build_harm, build_anh, TL, TR, ntraj, nsteps=nmd, seed=seed)
    wall = time.time() - t0
    rn = np.sqrt(ntraj)

    j_ex, src = exact_j(nmd)
    if j_ex is None:
        j_ex, src = j_ref, "NEGF Landauer (exact cache missing!)"
    corr = d1.mean() + d2.mean() / 2
    sem = float(np.hypot(d1.std(), d2.std() / 2) / rn)
    j_anh = j_ex + corr
    print(f"perturbative response: ntraj={ntraj} nmd={nmd} seed={seed}"
          f" ({wall:.0f} s)")
    print(f"  j0 (harmonic gate) {j0.mean() / j_ref * 100 - 100:+.2f}%"
          f" +- {j0.std() / rn / j_ref * 100:.2f}% vs Landauer; exact "
          f"theory from {src}: {(j_ex / j_ref - 1) * 100:+.2f}%")
    print(f"  d1   = {d1.mean() / j_ref * 100:+.3f}% +- "
          f"{d1.std() / rn / j_ref * 100:.3f}%")
    print(f"  d2/2 = {d2.mean() / 2 / j_ref * 100:+.3f}% +- "
          f"{d2.std() / 2 / rn / j_ref * 100:.3f}%  (truncation "
          f"control: |d2/2| / |d1| = "
          f"{abs(d2.mean() / 2 / max(abs(d1.mean()), 1e-300)):.2f})")
    print(f"  anharmonic correction d1 + d2/2 = "
          f"{corr / j_ref * 100:+.3f}% +- {sem / j_ref * 100:.3f}%")
    print(f"  kappa_anh = {j_anh / (T * DELTA) * U.CURCOF:.5f} nW/K "
          f"vs NEGF {j_ref / (T * DELTA) * U.CURCOF:.5f}: deviation "
          f"{(j_anh - j_ref) / j_ref * 100:+.2f}% (SEM "
          f"{sem / j_ref * 100:.2f}%)")


if __name__ == "__main__":
    main()
