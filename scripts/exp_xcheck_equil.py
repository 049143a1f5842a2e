"""Equilibration-discard probe of the flagship MD-vs-NEGF deviation.

Transient theory: trajectories start from thermal_init at the UNIFORM
mean temperature T, so each lead must relax to its bath temperature
(TL/TR) at the friction rate eta = 1/damp. During that relaxation the
lead heat influxes are antisymmetric in +-DeltaT/2 and ADD in the
antithetic estimator — a positive bias decaying like
exp(-eta * skip) across the averaging window. At the flagship tier
(nmd=2^13, dt=0.38, skip=nmd/4) eta*skip = 5.1, so ~0.6% of a
lead-heat-capacity-scale transient survives — candidate for the +8-10%.
Probe: same tier, growing equil_frac. If the deviation collapses by
exp(-eta * d_skip), the crosscheck fix is a longer discard (free), not
a longer run.

Run:  python scripts/exp_xcheck_equil.py [ntraj] [equil_frac ...]
      default: 64 trajectories, equil_frac = 0.25, 0.5, 0.75
"""

import importlib.util
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
spec = importlib.util.spec_from_file_location(
    "exp_crosscheck_flagship",
    os.path.join(HERE, "exp_crosscheck_flagship.py"))
xc = importlib.util.module_from_spec(spec)
spec.loader.exec_module(xc)

from sclmd_jax.utils.junction import partition_by_axis  # noqa: E402


def main():
    ntraj = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    fracs = [float(t) for t in sys.argv[2:]] or [0.25, 0.5, 0.75]
    nmd = 2 ** 13
    axyz = xc.load_axyz()
    part = partition_by_axis(axyz)
    negf = np.load(xc.NEGF_CACHE)
    j_ref = float(negf["j_nat"])
    eta = 1.0 / xc.DAMP_NAT
    for frac in fracs:
        skip = int(nmd * frac)
        t0 = time.time()
        j = np.asarray(xc.md_antithetic(axyz, part, ntraj, nmd,
                                        seed=11, harmonic=True,
                                        equil_frac=frac))
        wall = time.time() - t0
        j_md = float(j.mean())
        sem = float(j.std() / np.sqrt(len(j)))
        dev = (j_md - j_ref) / j_ref
        print(f"equil_frac={frac}: eta*skip={eta * skip * xc.DT:.2f} "
              f"ntraj={ntraj} J={j_md:.6e} dev={dev * 100:+.2f}% "
              f"SEM={sem / j_ref * 100:.2f}% ({wall:.0f} s)", flush=True)


if __name__ == "__main__":
    main()
