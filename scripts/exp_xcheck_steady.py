"""steady_init probe: does the steady-profile start kill the flagship
MD-vs-NEGF transient bias?

exp_xcheck_dt/dw established: the +8-10% harmonic deviation is
dt-independent and falls like 1/T_run — an initial-condition transient.
Trajectories start with every mode at the uniform mean T (ref
md.py:294-338), so each intermediate-damping mode relaxes toward its
coupling-weighted steady temperature ACROSS the averaging window; that
relaxation is odd in DeltaT and the antithetic estimator adds it.
md.RunEnsemble(steady_init=True) starts modes AT the steady profile
(md.steady_mode_temps). Prediction: deviation at nmd=2^13 drops from
+7.9% to ~1%, and becomes nmd-independent.

Run:  python scripts/exp_xcheck_steady.py [ntraj] [log2nmd ...]
      default: 32 trajectories, nmd = 2^13, 2^14
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
    ntraj = int(sys.argv[1]) if len(sys.argv) > 1 else 32
    l2s = [int(t) for t in sys.argv[2:]] or [13, 14]
    axyz = xc.load_axyz()
    part = partition_by_axis(axyz)
    negf = np.load(xc.NEGF_CACHE)
    j_ref = float(negf["j_nat"])
    for l2 in l2s:
        nmd = 2 ** l2
        t0 = time.time()
        j = np.asarray(xc.md_antithetic(axyz, part, ntraj, nmd,
                                        seed=11, harmonic=True,
                                        steady_init=True))
        wall = time.time() - t0
        j_md = float(j.mean())
        sem = float(j.std() / np.sqrt(len(j)))
        dev = (j_md - j_ref) / j_ref
        print(f"steady_init nmd=2^{l2}: ntraj={ntraj} "
              f"J={j_md:.6e} dev={dev * 100:+.2f}% "
              f"SEM={sem / j_ref * 100:.2f}% ({wall:.0f} s)", flush=True)


if __name__ == "__main__":
    main()
