"""dt-Richardson probe of the flagship harmonic MD-vs-NEGF deviation.

The first full-scale run of the crosscheck (bench.py crosscheck
section) measured kappa_MD +7.9% above Landauer at dt=0.38 natural
(SEM 2.9%) — 2.7 sigma, so likely a systematic. The chain-scale UseK
study (scripts/exp_usek_richardson.py) found the memory-kernel path's
bias is O(dt); the flagship runs wideband ebaths (Markovian friction,
no convolution), so the candidate here is velocity-Verlet + noise
discretization. Probe: same total physical time at dt and dt/2 — if
the deviation halves, it is O(dt) and the bench tier/Richardson pair
is the fix.

Run:  python scripts/exp_xcheck_dt.py [ntraj] [tier ...]
      tiers: 1 -> dt=0.38 nmd=8192; 2 -> dt=0.19 nmd=16384;
             4 -> dt=0.095 nmd=32768
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
    ntraj = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    tiers = [int(t) for t in sys.argv[2:]] or [1, 2]
    axyz = xc.load_axyz()
    part = partition_by_axis(axyz)
    negf = np.load(xc.NEGF_CACHE)
    j_ref = float(negf["j_nat"])
    devs = {}
    for tier in tiers:
        dt = xc.DT / tier
        nmd = 2 ** 13 * tier
        t0 = time.time()
        j = np.asarray(xc.md_antithetic(axyz, part, ntraj, nmd,
                                        seed=11, harmonic=True, dt=dt))
        wall = time.time() - t0
        j_md = float(j.mean())
        sem = float(j.std() / np.sqrt(len(j)))
        dev = (j_md - j_ref) / j_ref
        devs[tier] = dev
        print(f"tier dt/{tier}: dt={dt:.4f} nmd={nmd} ntraj={ntraj} "
              f"J={j_md:.6e} dev={dev * 100:+.2f}% "
              f"SEM={sem / j_ref * 100:.2f}% ({wall:.0f} s)", flush=True)
    if 1 in devs and 2 in devs:
        rich = 2 * devs[2] - devs[1]
        print(f"Richardson (dt->0): dev={rich * 100:+.2f}%")


if __name__ == "__main__":
    main()
