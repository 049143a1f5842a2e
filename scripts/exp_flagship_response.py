"""Flagship perturbative anharmonic response — compute ONCE, cache for
the bench (VERDICT r4 items 1-2).

Runs parallel.ensemble.perturbative_anharmonic_response (order-2 jvp
along the confined-reference attractor D' = D + dD_conf) on the
201-atom structure.data junction and caches the per-trajectory (j0,
d1, d2) arrays in scripts/flagship_response.npz, which
bench.crosscheck_anh reads like the other committed artifacts.

The estimator runs in chunks of trajectories (``--chunk``, default 4
per batch) so that the third-order CHDriver force jets of 32
trajectories x nmd=2^14 never sit in one batch.

    python scripts/exp_flagship_response.py [--chunk 4] [--ntraj 32]
        [--nmd LOG2N=14] [--fd2 auto|S|0] [--cpu]

``--fd2`` defaults to "auto" (basin-guarded FD step — the production
path; see the estimator docstring); an explicit 0 selects the nested
jvp-of-jvp, whose program is far larger than the single-tangent one
and has only been run on the CPU (``--cpu``). ``--fd2 S`` switches
all second-order pieces to a
one-sided finite difference of the first-order jvp (see
perturbative_anharmonic_response docstring); the FD bias is pinned
against the nested path on the quartic chain in
tests/test_exact_gle.py::TestSCPRenormalization.

Round-5 finding #2 (--ref): responding around the CONFINED harmonic
reference D' = D + dD_conf diverges on the flagship. The first-order
force mismatch around D' contains the full Hartree term (||dD||/||D||
= 0.68, scripts/flagship_scp_dD.npz), so the attractor derivative d1
= (I-A^P)^{-1} Phi_lam reaches |x|~1.5e4 along the soft modes
(stage-probed via --debug) and the finite-lam evaluations at
0.05*d1-shifted states hand the Tersoff driver a broken geometry ->
NaN. Around the SCP effective Hessian D_eff = D + dD (--ref eff,
the default) the smeared linear mismatch is ZERO by the SCP
self-consistency condition — the tangent dynamics feel only the
beyond-Hartree residual — and D_eff is stable (lowest kept mode 1.13
meV, no negative directions after constraint projection). The j0
gate then checks against exact_gle(D_eff) and d1 + d2/2 measures the
dynamical correction BEYOND the static SCP estimate, which is
exactly the independent cross-certification VERDICT r4 item 5 asks
for.

Reference analog: anharmonic REBO MD (ref examples/runmd.py:27) vs
harmonic NEGF (ref examples/runnegf.py:17-28) — no error bars there;
this gives the correction with jvp-tight statistics.
"""

import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

NEGF_CACHE = os.path.join(HERE, "flagship_negf.npz")
OUT = os.path.join(HERE, "flagship_response.npz")

T, DELTA = 300.0, 0.1
DT = 0.25 / 0.658
DAMP_NAT = 100 / 0.658211814201041


def arg(name, default, cast=int):
    return cast(sys.argv[sys.argv.index(name) + 1]) \
        if name in sys.argv else default


def run_and_cache(chunk=4, ntraj=32, log2nmd=14, seed=11, out=OUT,
                  fd2="auto", debug=False, ref="eff", family="poly",
                  order=1):
    import jax.numpy as jnp

    from sclmd_jax import baths as B
    from sclmd_jax import units as U
    from sclmd_jax.md import md as MDRunner
    from sclmd_jax.models.hydrocarbon import CHDriver
    from sclmd_jax.parallel.ensemble import (
        perturbative_anharmonic_response)
    from sclmd_jax.utils.junction import partition_by_axis

    import tempfile

    nmd = 2 ** log2nmd
    negf = np.load(NEGF_CACHE)
    axyz = [[str(e)] + list(map(float, p))
            for e, p in zip(negf["els"], negf["pos"])]
    part = partition_by_axis(axyz)
    ref_dd = {"conf": "flagship_confine.npz",
              "eff": "flagship_scp_dD.npz"}[ref]
    dyn_ref = (np.asarray(negf["dyn_ev2"], np.float64)
               + np.load(os.path.join(HERE, ref_dd))["dD"])
    drv = CHDriver(axyz, dtype=jnp.float32)
    TL, TR = T * (1 + DELTA / 2), T * (1 - DELTA / 2)

    def build_c(Ta, Tb):
        runner = MDRunner(DT, nmd, T, axyz=axyz, dyn=dyn_ref,
                          dtype=jnp.float32, seed=seed,
                          outdir=tempfile.mkdtemp(prefix="resp_"))
        for cats, tt in ((part["ecatsl"], Ta), (part["ecatsr"], Tb)):
            eta = (1.0 / DAMP_NAT) * np.identity(len(cats))
            runner.AddBath(B.ebath(cats, tt, runner.dt, runner.nmd,
                                   wmax=1.0, nw=500, efric=eta))
        runner.AddConstr([part["fixdofs"]])
        return runner

    def build_anh(Ta, Tb):
        r = build_c(Ta, Tb)
        r.AddPotential(drv)
        return r

    t0 = time.time()
    j0, d1, d2 = perturbative_anharmonic_response(
        build_c, build_anh, TL, TR, ntraj, nsteps=nmd, seed=seed,
        chunk=chunk, fd2=fd2, debug=debug, family=family, order=order)
    wall = time.time() - t0

    j_ref = float(negf["j_nat"])
    gate = f"flagship_exact_scp_{ref}_nmd{nmd}.npz"
    exact_fn = os.path.join(HERE, gate)
    j_exact = (float(np.load(exact_fn)["j_nat"])
               if os.path.exists(exact_fn) else j_ref)
    rn = np.sqrt(ntraj)
    print(f"response ref={ref} family={family} order={order} "
          f"ntraj={ntraj} nmd=2^{log2nmd} chunk={chunk} fd2={fd2} "
          f"({wall:.0f} s):")
    print(f"  j0 gate dev {(float(j0.mean()) - j_exact) / j_ref * 100:+.3f}% "
          f"(gate SEM {float(j0.std()) / rn / j_ref * 100:.3f}%) "
          f"vs {f'exact({ref})' if j_exact != j_ref else 'Landauer'}")
    print(f"  d1 {float(d1.mean()) / j_ref * 100:+.3f}% "
          f"(SEM {float(d1.std()) / rn / j_ref * 100:.3f}%)"
          + (" — SCP self-consistency null" if order == 1 else
             f", d2/2 {float(d2.mean()) / 2 / j_ref * 100:+.3f}% "
             f"(SEM {float(d2.std()) / 2 / rn / j_ref * 100:.3f}%)"))
    if order >= 2:
        corr = float(d1.mean() + d2.mean() / 2)
        csem = float(np.hypot(d1.std(), d2.std() / 2) / rn)
        print(f"  correction beyond exact({ref}) "
              f"{corr / j_ref * 100:+.3f}% "
              f"(SEM {csem / j_ref * 100:.3f}%), kappa_anh = "
              f"{(j_exact + corr) / (T * DELTA) * U.CURCOF:.5f} nW/K")
    np.savez(out, j0=j0, d1=d1, d2=d2, ntraj=ntraj, nmd=nmd,
             chunk=chunk, seed=seed, wall_s=wall, fd2=fd2,
             ref=ref, gate=gate, family=family, order=order)
    print(f"  -> {out}")
    return j0, d1, d2


if __name__ == "__main__":
    if "--cpu" in sys.argv:
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
    run_and_cache(chunk=arg("--chunk", 4), ntraj=arg("--ntraj", 32),
                  log2nmd=arg("--nmd", 14), seed=arg("--seed", 11),
                  fd2=arg("--fd2", "auto",
                          lambda s: s if s == "auto" else float(s)),
                  ref=arg("--ref", "eff", str),
                  family=arg("--family", "poly", str),
                  order=arg("--order", 1),
                  out=arg("--out", OUT, str),
                  debug="--debug" in sys.argv)
