"""Deterministic flagship crosscheck: exact discrete-GLE attractor
expectation (ops.exact_gle, Schur path) on the reference's
structure.data junction — ZERO Monte Carlo on the MD side.

Completes the crosscheck triangle at flagship scale:
  theory vs continuum Landauer  -> the pure discretization (comb) bias
  warm MD vs theory             -> pure statistics (must be ~0 +- SEM)
  warm MD vs Landauer           -> the bench's crosscheck_* field

Pure CPU (no chip needed):
    JAX_PLATFORMS=cpu python scripts/exp_xcheck_exact.py [log2nmd]
~1-2 h at nmd=2^14 on one core (8193 lines x one 2412-dof triangular
solve each).
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
    import tempfile

    import jax
    jax.config.update("jax_platforms", "cpu")   # pure host work
    jax.config.update("jax_enable_x64", True)   # keep dyn at full f64
    import jax.numpy as jnp

    from sclmd_jax import baths as B
    from sclmd_jax.md import md as MDRunner
    from sclmd_jax.ops.exact_gle import attractor_expected_currents

    nmd = 2 ** (int(sys.argv[1]) if len(sys.argv) > 1 else 14)
    axyz = xc.load_axyz()
    part = partition_by_axis(axyz)
    negf = np.load(xc.NEGF_CACHE)
    j_ref = float(negf["j_nat"])
    dyn = negf["dyn_ev2"]
    TL = xc.T * (1 + xc.DELTA / 2)
    TR = xc.T * (1 - xc.DELTA / 2)

    runner = MDRunner(xc.DT, nmd, xc.T, axyz=axyz, dyn=dyn,
                      dtype=jnp.float64,
                      outdir=tempfile.mkdtemp(prefix="xexact_"))
    for cats, tt in ((part["ecatsl"], TL), (part["ecatsr"], TR)):
        eta = (1.0 / xc.DAMP_NAT) * np.identity(len(cats))
        runner.AddBath(B.ebath(cats, tt, runner.dt, runner.nmd,
                               wmax=1.0, nw=500, efric=eta))
    runner.AddConstr([part["fixdofs"]])
    system = runner._build_system()
    system = system.replace(baths=tuple(
        b.prepare_noise() for b in runner.baths))

    t0 = time.time()
    th = attractor_expected_currents(system, progress=True,
                                     method="schur")
    wall = time.time() - t0
    j_th = float((th[0] - th[1]) / 2)
    dev = (j_th - j_ref) / j_ref
    print(f"exact-discrete attractor nmd={nmd}: J={j_th:.6e} "
          f"kappa={j_th / (xc.T * xc.DELTA) * U.CURCOF:.5f} nW/K "
          f"({wall:.0f} s)")
    print(f"vs continuum Landauer {float(negf['kappa_nw_per_k']):.5f} "
          f"nW/K: comb/discretization bias {dev * 100:+.2f}%")
    # cache the deterministic theory value so the bench's anharmonic
    # control-variate estimator (kappa_anh = mean(J_anh - J_harm) +
    # kappa_exact) and PERF.md cite a reproducible artifact
    np.savez(os.path.join(HERE, f"flagship_exact_nmd{nmd}.npz"),
             j_currents=np.asarray(th), j_nat=j_th, nmd=nmd,
             kappa_nw_per_k=j_th / (xc.T * xc.DELTA) * U.CURCOF,
             wall_s=wall)


if __name__ == "__main__":
    main()
