"""Classical-limit fidelity probe: the anharmonic transport correction
of the C/H flagship potential (VERDICT r2 'REBO-substitute fidelity').

The quantum antithetic estimator cannot see the anharmonic delta at
practical ensemble sizes: the CRN cancellation relies on linearity, so
for the anharmonic CHDriver at 300 K the zero-point-scale fluctuations
decorrelate under the temperature swap (measured SEM 145% at 32 pairs
vs ~2% harmonic). In the CLASSICAL limit (classical=True baths,
kT-scale fluctuations) the estimator stays sharp, and the harmonic
answer has an exact closed form: J_cl = kB DeltaT / (2 pi) int T(w) dw
over the cached Caroli transmission. Three numbers:

  1. harmonic classical MD  vs  classical Landauer  (estimator check)
  2. anharmonic (CHDriver) classical MD vs the same
  3. (2) - (1): the anharmonic correction to ballistic transport of
     the Tersoff+H-terminator flagship potential at 300 K — the
     self-consistent fidelity statement the REBO substitute can make
     without LAMMPS.

Both MD runs share seeds/tier so the cold-start transient largely
cancels in the difference.

Run:  python scripts/exp_xcheck_classical.py [ntraj] [log2nmd]
      default: 32 trajectories, nmd = 2^14
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

from sclmd_jax import units as U  # noqa: E402
from sclmd_jax.utils.junction import partition_by_axis  # noqa: E402


def main():
    ntraj = int(sys.argv[1]) if len(sys.argv) > 1 else 32
    nmd = 2 ** (int(sys.argv[2]) if len(sys.argv) > 2 else 14)
    # ΔT/T: the anharmonic ensemble decorrelates the CRN pairing, so
    # SEM is set by the unpaired fluctuation floor — a larger DeltaT
    # buys SNR linearly (delta=0.5 measured SEM ~3% where 0.1 gave 15%)
    delta = float(sys.argv[3]) if len(sys.argv) > 3 else xc.DELTA
    axyz = xc.load_axyz()
    part = partition_by_axis(axyz)
    negf = np.load(xc.NEGF_CACHE)
    ws, tm = negf["ws_ev"], negf["tm"]
    TL = xc.T * (1 + delta / 2)
    TR = xc.T * (1 - delta / 2)
    j_cl = float(np.trapezoid(tm, ws) * U.KB * (TL - TR) / (2 * np.pi))
    print(f"classical Landauer (delta={delta}): J={j_cl:.6e} "
          f"kappa={j_cl / (xc.T * delta) * U.CURCOF:.5f} nW/K",
          flush=True)

    devs = {}
    for harmonic, tag in ((True, "harmonic"), (False, "anharmonic")):
        t0 = time.time()
        j = np.asarray(xc.md_antithetic(axyz, part, ntraj, nmd,
                                        seed=11, harmonic=harmonic,
                                        classical=True, delta=delta))
        wall = time.time() - t0
        j_md = float(j.mean())
        sem = float(j.std() / np.sqrt(len(j)))
        dev = (j_md - j_cl) / j_cl
        devs[tag] = dev
        print(f"{tag} classical MD nmd={nmd} ntraj={ntraj}: "
              f"J={j_md:.6e} dev={dev * 100:+.2f}% "
              f"SEM={sem / j_cl * 100:.2f}% ({wall:.0f} s)", flush=True)
    if len(devs) == 2:
        print(f"anharmonic correction (anh - harm): "
              f"{(devs['anharmonic'] - devs['harmonic']) * 100:+.2f}% "
              "of the ballistic conductance")


if __name__ == "__main__":
    main()
