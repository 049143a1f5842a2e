"""dw-probe of the flagship harmonic MD-vs-NEGF deviation.

The dt-Richardson probe (exp_xcheck_dt.py) held nmd*dt fixed and found
the +10% deviation dt-INDEPENDENT — which is the signature of the
noise-grid systematic already quantified on the 8-DOF chain
(tests/test_crosscheck.py::test_conductance_within_2pct_of_negf
docstring: bias set by dw = 2 pi/(dt nmd), dt-independent). The
synthesized noise is a frequency comb with spacing dw; each
friction-broadened junction resonance (FWHM ~ eta = 1/damp = 6.6e-3
natural) integrates only the comb lines it straddles. At the flagship's
dw = 2.0e-3 that is ~3 lines per resonance — O(1) per-mode flux errors
that need not average to zero over the band. Probe: same dt, nmd
doubling (dw halving) — if the deviation collapses, the crosscheck tier
just needs a finer noise grid.

Run:  python scripts/exp_xcheck_dw.py [ntraj] [log2nmd ...]
      default: 32 trajectories, nmd = 2^13, 2^14, 2^15
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
    l2s = [int(t) for t in sys.argv[2:]] or [13, 14, 15]
    axyz = xc.load_axyz()
    part = partition_by_axis(axyz)
    negf = np.load(xc.NEGF_CACHE)
    j_ref = float(negf["j_nat"])
    for l2 in l2s:
        nmd = 2 ** l2
        dw = 2 * np.pi / (xc.DT * nmd)
        t0 = time.time()
        j = np.asarray(xc.md_antithetic(axyz, part, ntraj, nmd,
                                        seed=11, harmonic=True))
        wall = time.time() - t0
        j_md = float(j.mean())
        sem = float(j.std() / np.sqrt(len(j)))
        dev = (j_md - j_ref) / j_ref
        print(f"nmd=2^{l2}: dw={dw:.3e} ntraj={ntraj} "
              f"J={j_md:.6e} dev={dev * 100:+.2f}% "
              f"SEM={sem / j_ref * 100:.2f}% ({wall:.0f} s)", flush=True)


if __name__ == "__main__":
    main()
