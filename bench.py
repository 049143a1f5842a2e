"""Benchmark: GLE MD throughput on the north-star workloads.

Primary (BASELINE.md:20-22): 100-atom junction (300 DOF), two
non-Markovian phonon baths with a 1000-tap memory kernel each, quantum
colored noise — blocked-convolution integrator (md.run_segment_blocked),
one compiled program per segment. Baseline: CPU reference sclmd at
~12.5 velocity-Verlet steps/s (flow/sclmd.dot:270; that figure is the
vv loop only, so the headline here is also scan-only; the
noise-regeneration-inclusive figure is reported alongside).

Secondary (BASELINE.md:23, config 5): 1,000 vmapped trajectories on a
500-atom junction (1500 DOF, 150-DOF leads), noise sampled ON DEVICE
from host-precomputed PSD factors.

Flagship: the reference's own 201-atom C/H structure.data junction
(ref examples/runmd.py — 12.5 steps/s on CPU) with full many-body
CHDriver forces inside the scan.

Statistical design: each section runs in its OWN SUBPROCESS, one at a
time (fresh XLA allocator/executable state, one JAX process on the
card); within a section, compared quantities (scan-only vs
with-noise-regen) are timed INTERLEAVED round-robin so drift hits both
alike, and the internal ordering invariant t(regen) >= t(scan-only) is
checked and reported (re-measured once with more reps on violation).
Every timed call ends in ``jax.block_until_ready``.

Needs a GPU: a probe child reads the platform first, and the bench
exits non-zero when JAX's default device is not a GPU. The parent never
imports JAX. Prints ONE JSON line (the merged result).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np


BASELINE_STEPS_PER_SEC = 12.5
REPO = os.path.dirname(os.path.abspath(__file__))


def _timed(fn, reps=5):
    """(median, min) wall time of reps calls."""
    import jax

    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2], min(ts)


def _timed_interleaved(fns: dict, rounds=5):
    """Round-robin timing of several callables: one rep of each per
    round, so drift is paired across the compared quantities instead
    of biasing whichever ran in the quiet block.
    Returns {name: median_seconds}."""
    import jax

    ts = {k: [] for k in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            t0 = time.perf_counter()
            jax.block_until_ready(fn())
            ts[name].append(time.perf_counter() - t0)
    return {k: sorted(v)[len(v) // 2] for k, v in ts.items()}


def primary(jax, jnp):
    from sclmd_jax import baths as B
    from sclmd_jax.md import (GLESystem, initial_state, run_segment_blocked)
    from sclmd_jax.models.harmonic import chain_dynmat

    natoms, ml, nmd = 100, 1000, 2048
    nph = 3 * natoms
    dt, T, delta = 0.25 / 0.658, 300.0, 0.1
    nc = 90

    dyn = np.asarray(chain_dynmat(nph, 0.04, dtype=jnp.float32))
    mask = np.ones(nph, np.float32)
    gwl = np.linspace(0.0, 0.6, 64)
    gam = np.array([np.eye(nc) * 0.01 * np.exp(-(w / 0.25) ** 2)
                    for w in gwl])

    def mkbath(dofs, temp):
        return B.phbath(temp, dofs, 0.3, 128, dt, nmd, ml=ml,
                        gamma=gam, gwl=gwl, dtype=jnp.float32)

    pbl = mkbath(range(nc), T * (1 + delta / 2))
    pbr = mkbath(range(nph - nc, nph), T * (1 - delta / 2))

    def scan_run(block):
        @jax.jit
        def f(dyn_a, mask_a, bl, br):
            system = GLESystem(dyn=dyn_a, baths=(bl, br), mask=mask_a,
                               dt=dt, nph=nph, ml=ml, nmd=nmd,
                               unconstrained=True)
            st = initial_state(system)
            fin, ys = run_segment_blocked(system, st, nmd, 0, block=block)
            cur = ys["cur"][nmd // 4:]
            return (fin.p, jnp.mean(cur[:, 0]), jnp.mean(cur[:, 1]),
                    jnp.isfinite(ys["etot"]).all())
        return f

    # ---- single trajectory: scan-only vs with-noise-regeneration,
    # INTERLEAVED ----
    bl = pbl.gnoi_np(2).replace(nevecs=None, nstd=None)
    br = pbr.gnoi_np(3).replace(nevecs=None, nstd=None)
    # device-put the bath pytrees ONCE: numpy jit args would be copied
    # to the device on every call, taxing scan-only but not regen
    # (whose baths are device-resident sampler outputs)
    bl, br = jax.device_put((bl, br))
    dyn_d, mask_d = jax.device_put((dyn, mask))
    f1 = scan_run(64)
    out = jax.block_until_ready(f1(dyn_d, mask_d, bl, br))    # compile
    _, jl, jr, finite = out[0], out[1], out[2], out[3]

    seed = [0]

    def scan_only():
        return f1(dyn_d, mask_d, bl, br)

    def regen_dev():
        seed[0] += 1
        k = jax.random.PRNGKey(seed[0])
        bl2 = pbl.gnoi(jax.random.fold_in(k, 0)).replace(
            nevecs=None, nstd=None)
        br2 = pbr.gnoi(jax.random.fold_in(k, 1)).replace(
            nevecs=None, nstd=None)
        return f1(dyn_d, mask_d, bl2, br2)

    def regen_host():
        seed[0] += 1
        bl2 = pbl.gnoi_np(10 + seed[0]).replace(nevecs=None, nstd=None)
        br2 = pbr.gnoi_np(20 + seed[0]).replace(nevecs=None, nstd=None)
        return f1(dyn_d, mask_d, bl2, br2)

    jax.block_until_ready(regen_dev())                      # compile sampler

    fns = {"scan": scan_only, "regen": regen_dev, "regen_host": regen_host}
    med = _timed_interleaved(fns, rounds=5)
    # internal ordering invariant: regen runs the SAME program plus
    # noise synthesis, so its time must not be smaller (5% tolerance
    # for run-to-run spread); one re-measure with more rounds on
    # violation
    ordering_ok = (med["regen"] >= 0.95 * med["scan"]
                   and med["regen_host"] >= 0.95 * med["scan"])
    if not ordering_ok:
        med = _timed_interleaved(fns, rounds=9)
        ordering_ok = (med["regen"] >= 0.95 * med["scan"]
                       and med["regen_host"] >= 0.95 * med["scan"])
    single_sps = nmd / med["scan"]
    regen_sps = nmd / med["regen"]
    regen_host_sps = nmd / med["regen_host"]
    _, t_best = _timed(scan_only, reps=2)
    single_best = nmd / min(t_best, med["scan"])

    # ---- ensembles (blocked, block=256); raw vmapped batches with
    # pre-drawn noise ----
    from sclmd_jax.md import run_segment_blocked as rsb

    def ens_run(block, ntraj):
        @jax.jit
        def f(dyn_a, mask_a, bl, br, nzL, nzR):
            def one(nzl, nzr):
                system = GLESystem(
                    dyn=dyn_a, baths=(bl.replace(noise=nzl),
                                      br.replace(noise=nzr)),
                    mask=mask_a, dt=dt, nph=nph, ml=ml, nmd=nmd,
                    unconstrained=True)
                st = initial_state(system)
                fin, ys = rsb(system, st, nmd, 0, block=block)
                return (jnp.mean(ys["cur"], axis=0),
                        jnp.isfinite(ys["etot"]).all())
            curs, fins = jax.vmap(one)(nzL, nzR)
            return jnp.mean(curs, axis=0), fins.all()
        return f

    bl0, br0 = jax.device_put(
        (pbl.replace(nevecs=None, nstd=None, noise=None),
         pbr.replace(nevecs=None, nstd=None, noise=None)))
    ens = {}
    for ntraj in (32, 256):
        nzL = np.stack([np.asarray(pbl.gnoi_np(100 + i).noise)
                        for i in range(ntraj)])
        nzR = np.stack([np.asarray(pbr.gnoi_np(10000 + i).noise)
                        for i in range(ntraj)])
        # device-put ONCE: numpy jit args would be copied to the
        # device on every call, and the metric would time that copy
        nzL, nzR = jax.device_put((nzL, nzR))
        f = ens_run(256, ntraj)
        jax.block_until_ready(f(dyn_d, mask_d, bl0, br0, nzL, nzR))
        t_med, _ = _timed(lambda: f(dyn_d, mask_d, bl0, br0, nzL, nzR),
                          reps=5 if ntraj <= 32 else 3)
        ens[ntraj] = round(ntraj * nmd / t_med, 1)
    return {
        "single_sps": single_sps, "single_best_sps": single_best,
        "regen_sps": regen_sps, "regen_host_sps": regen_host_sps,
        "ordering_ok": bool(ordering_ok),
        "ens": ens, "J_left": float(jl), "J_right": float(jr),
        "finite": bool(finite),
    }


def primary_scaling(jax, jnp):
    """Memory-wall demonstration on the primary workload: end-to-end
    RunEnsemble (noise synthesis + run + reduction) total throughput
    through ntraj=1024. Auto-chunking keeps the resident batch bounded,
    so the 1024-point must hold the 256-point rate (VERDICT r2 item
    2)."""
    import tempfile

    from sclmd_jax import baths as B
    from sclmd_jax.md import md as MDRunner
    from sclmd_jax.models.harmonic import chain_dynmat

    natoms, ml, nmd = 100, 1000, 2048
    nph = 3 * natoms
    dt, T, delta = 0.25 / 0.658, 300.0, 0.1
    nc = 90
    dyn = np.asarray(chain_dynmat(nph, 0.04, dtype=jnp.float32))
    gwl = np.linspace(0.0, 0.6, 64)
    gam = np.array([np.eye(nc) * 0.01 * np.exp(-(w / 0.25) ** 2)
                    for w in gwl])

    def build(outdir):
        r = MDRunner(dt, nmd, T, dyn=dyn,
                     axyz=[["C", 1.4 * i, 0, 0] for i in range(natoms)],
                     dtype=jnp.float32, outdir=outdir, block=256)
        r.AddBath(B.phbath(T * (1 + delta / 2), range(nc), 0.3, 128, dt,
                           nmd, ml=ml, gamma=gam, gwl=gwl,
                           dtype=jnp.float32))
        r.AddBath(B.phbath(T * (1 - delta / 2), range(nph - nc, nph),
                           0.3, 128, dt, nmd, ml=ml, gamma=gam, gwl=gwl,
                           dtype=jnp.float32))
        return r

    from sclmd_jax.parallel.ensemble import auto_chunk

    out = {}
    runners = {}
    fns = {}
    for ntraj in (256, 1024):
        tmp = tempfile.mkdtemp(prefix=f"bench_scale{ntraj}_")
        runner = build(tmp)
        # depth=2 matches what RunEnsemble(checkpoint=False) computes
        # internally — the logged chunk must be the chunk actually used
        chunk = auto_chunk(runner._build_system(), ntraj, nmd, 256,
                           depth=2)
        runner.RunEnsemble(ntraj, nsteps=nmd)            # compile
        runners[ntraj] = runner
        out[str(ntraj)] = {"chunk": int(chunk)}
        fns[ntraj] = (lambda r=runner, n=ntraj:
                      r.RunEnsemble(n, nsteps=nmd))
    # interleaved, same rep count as the other sections: the two sizes
    # see the same drift
    med = _timed_interleaved(fns, rounds=5)
    for ntraj in (256, 1024):
        out[str(ntraj)]["tsps"] = round(ntraj * nmd / med[ntraj], 1)
    ratio = out["1024"]["tsps"] / out["256"]["tsps"]
    out["ratio_1024_vs_256"] = round(ratio, 3)
    out["within_15pct_of_256"] = ratio >= 0.85
    return out


def config5(jax, jnp):
    """BASELINE.md:23 secondary metric: 1k vmapped trajectories,
    500-atom junction. Noise sampled on device from host factors."""
    from sclmd_jax import baths as B
    from sclmd_jax.md import GLESystem, initial_state, run_segment_blocked
    from sclmd_jax.models.harmonic import chain_dynmat

    natoms, ml, nmd, ntraj, block = 500, 512, 1024, 1000, 64
    nph = 3 * natoms
    dt, T, delta = 0.25 / 0.658, 300.0, 0.1
    nc = 150

    dyn = np.asarray(chain_dynmat(nph, 0.04, dtype=jnp.float32))
    mask = np.ones(nph, np.float32)
    gwl = np.linspace(0.0, 0.6, 48)
    gam = np.array([np.eye(nc) * 0.01 * np.exp(-(w / 0.25) ** 2)
                    for w in gwl])

    def mkbath(dofs, temp):
        return B.phbath(temp, dofs, 0.3, 96, dt, nmd, ml=ml,
                        gamma=gam, gwl=gwl, dtype=jnp.float32)

    pbl = mkbath(range(nc), T * (1 + delta / 2))
    pbr = mkbath(range(nph - nc, nph), T * (1 - delta / 2))

    # device-side batched noise synthesis (gnoi routes through
    # sample_noise_dev: real/imag factor split, and the single-matrix
    # fast path for frequency-proportional spectra)
    def draw(bath, seed):
        keys = jax.random.split(jax.random.PRNGKey(seed), ntraj)
        return jax.block_until_ready(
            jax.vmap(lambda k: bath.gnoi(k).noise)(keys))

    nzL = draw(pbl, 1)
    nzR = draw(pbr, 2)
    bl0 = pbl.replace(nevecs=None, nstd=None, noise=None)
    br0 = pbr.replace(nevecs=None, nstd=None, noise=None)

    @jax.jit
    def f(dyn_a, mask_a, bl, br, nzL, nzR):
        def one(nzl, nzr):
            system = GLESystem(
                dyn=dyn_a, baths=(bl.replace(noise=nzl),
                                  br.replace(noise=nzr)),
                mask=mask_a, dt=dt, nph=nph, ml=ml, nmd=nmd)
            st = initial_state(system)
            fin, ys = run_segment_blocked(system, st, nmd, 0,
                                          block=block)
            return (jnp.mean(ys["cur"], axis=0),
                    jnp.isfinite(ys["etot"]).all())
        curs, fins = jax.vmap(one)(nzL, nzR)
        return jnp.mean(curs, axis=0), fins.all()

    o = jax.block_until_ready(f(dyn, mask, bl0, br0, nzL, nzR))
    t_med, _ = _timed(lambda: f(dyn, mask, bl0, br0, nzL, nzR), reps=3)
    return {"tsps": round(ntraj * nmd / t_med, 1),
            "finite": bool(np.asarray(o[1])),
            "ntraj": ntraj, "atoms": natoms}


def flagship(jax, jnp):
    """The reference's own headline workload: its 201-atom C/H
    structure.data junction (ref examples/runmd.py, 12.5 steps/s on
    CPU) as a vmapped ensemble with full many-body CHDriver forces
    inside the scan. The relaxed geometry and its f64 dynamical matrix
    come from the committed scripts/flagship_negf.npz; the timed part
    is RunEnsemble (which includes per-run device-side noise
    synthesis). The 1024-trajectory point runs auto-chunked.
    """
    import tempfile

    from sclmd_jax import baths as B
    from sclmd_jax.md import md as MDRunner
    from sclmd_jax.models.hydrocarbon import CHDriver
    from sclmd_jax.utils.junction import partition_by_axis

    negf = np.load(NEGF_CACHE)
    axyz = [[str(e)] + list(map(float, p))
            for e, p in zip(negf["els"], negf["pos"])]
    part = partition_by_axis(axyz)
    drv = CHDriver(axyz, dtype=jnp.float32)

    nmd = 1024
    T, delta, dt = 300.0, 0.1, 0.25 / 0.658
    tmp = tempfile.mkdtemp(prefix="bench_flagship_")
    runner = MDRunner(dt, nmd, T, axyz=axyz, dyn=negf["dyn_ev2"],
                      dtype=jnp.float32, outdir=tmp)
    runner.AddPotential(drv)
    damp = 100 / 0.658211814201041
    for cats, tt in ((part["ecatsl"], T * (1 + delta / 2)),
                     (part["ecatsr"], T * (1 - delta / 2))):
        eta = (1.0 / damp) * np.identity(len(cats))
        runner.AddBath(B.ebath(cats, tt, runner.dt, runner.nmd,
                               wmax=1.0, nw=500, efric=eta))
    runner.AddConstr([part["fixdofs"]])

    res = {"atoms": len(axyz)}
    ntraj = 128
    runner.RunEnsemble(ntraj, nsteps=nmd)          # compile
    t_med, _ = _timed(lambda: runner.RunEnsemble(ntraj, nsteps=nmd),
                      reps=3)
    res["tsps"] = round(ntraj * nmd / t_med, 1)
    res["ntraj"] = ntraj

    # memory-wall point: 1024 trajectories, auto-chunked (depth=2 —
    # the chunk RunEnsemble's pipelined path actually uses)
    from sclmd_jax.parallel.ensemble import auto_chunk
    chunk = auto_chunk(runner._build_system(), 1024, nmd, None, depth=2)
    runner.RunEnsemble(1024, nsteps=nmd)           # compile chunk batch
    t_med, _ = _timed(lambda: runner.RunEnsemble(1024, nsteps=nmd),
                      reps=3)
    res["tsps_1024"] = round(1024 * nmd / t_med, 1)
    res["chunk_1024"] = int(chunk)
    ratio = res["tsps_1024"] / res["tsps"]
    res["ratio_1024_vs_128"] = round(ratio, 3)
    res["within_15pct_of_128"] = ratio >= 0.85
    return res


XC_T, XC_DELTA = 300.0, 0.1
XC_DT = 0.25 / 0.658
XC_DAMP_NAT = 100 / 0.658211814201041       # 100 fs in natural time
NEGF_CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "scripts", "flagship_negf.npz")


def _flagship_build(axyz, part, dyn, nmd, seed, jnp):
    """build(Ta, Tb) callback for parallel.ensemble.antithetic_run on
    the flagship structure.data junction (same setup as
    scripts/exp_crosscheck_flagship.py)."""
    import tempfile

    from sclmd_jax import baths as B
    from sclmd_jax.md import md as MDRunner

    def build(Ta, Tb):
        runner = MDRunner(XC_DT, nmd, XC_T, axyz=axyz, dyn=dyn,
                          dtype=jnp.float32, seed=seed,
                          outdir=tempfile.mkdtemp(prefix="bench_xc_"))
        for cats, tt in ((part["ecatsl"], Ta), (part["ecatsr"], Tb)):
            eta = (1.0 / XC_DAMP_NAT) * np.identity(len(cats))
            runner.AddBath(B.ebath(cats, tt, runner.dt, runner.nmd,
                                   wmax=1.0, nw=500, efric=eta))
        runner.AddConstr([part["fixdofs"]])
        return runner

    return build


def crosscheck(jax, jnp):
    """Flagship physics loop (VERDICT r2 item 1): MD thermal conductance
    vs the NEGF Landauer answer on the reference's own structure.data
    junction — the reference's headline validation workflow
    (ref README.md:31-35, examples/runmd.py vs examples/runnegf.py) as a
    driver-visible number. Uses the harmonic variant (MD on the junction
    dynamical matrix MUST reproduce harmonic NEGF — an absolute
    correctness gate, not a statistical one) with the packaged
    antithetic common-random-numbers estimator warm-started ON the
    discrete periodic attractor
    (sclmd_jax.parallel.ensemble.antithetic_run — the in-package API,
    VERDICT r3 item 3): a cold start carries a DeltaT-odd
    state-noise-correlation transient measured at +7.9% (nmd=2^13)
    falling only like 1/T_run — the warm start removes it exactly,
    leaving the comb-grid residual (-0.59% measured at this tier,
    inside the 2% north-star bar with SEM ~1.6%). The NEGF side and the
    relaxed geometry are precomputed on CPU
    (scripts/exp_crosscheck_flagship.py relax/negf phases) and cached
    in-repo."""
    if not os.path.exists(NEGF_CACHE):
        # LOUD skip: the headline physics number must not silently
        # vanish from the bench JSON when the committed NEGF cache is
        # missing (deleted/renamed scripts/flagship_negf.npz)
        return {"crosscheck_skipped": True,
                "reason": f"NEGF cache missing: {NEGF_CACHE}"}
    from sclmd_jax import units as U
    from sclmd_jax.parallel.ensemble import antithetic_run
    from sclmd_jax.utils.junction import partition_by_axis

    negf = np.load(NEGF_CACHE)
    axyz = [[str(e)] + list(map(float, p))
            for e, p in zip(negf["els"], negf["pos"])]
    part = partition_by_axis(axyz)
    dyn = negf["dyn_ev2"]
    ntraj, nmd, seed = 32, 2 ** 14, 11
    TL, TR = XC_T * (1 + XC_DELTA / 2), XC_T * (1 - XC_DELTA / 2)
    t0 = time.time()
    build = _flagship_build(axyz, part, dyn, nmd, seed, jnp)
    j = np.asarray(antithetic_run(build, TL, TR, ntraj, nsteps=nmd,
                                  seed=seed, warm_start=True))
    wall = time.time() - t0
    j_md = float(j.mean())
    j_ref = float(negf["j_nat"])
    sem = float(j.std() / np.sqrt(len(j)))
    dev = (j_md - j_ref) / j_ref
    out = {
        "kappa_md_nw_per_k": round(j_md / (XC_T * XC_DELTA) * U.CURCOF, 5),
        "kappa_negf_nw_per_k": round(float(negf["kappa_nw_per_k"]), 5),
        "dev_pct": round(dev * 100, 2),
        "sem_pct": round(sem / abs(j_ref) * 100, 2),
        "ntraj": ntraj, "nmd": nmd, "wall_s": round(wall, 1),
        "estimator": "antithetic CRN + periodic-attractor warm start "
                     "(parallel.ensemble.antithetic_run)",
    }

    return out


def crosscheck_anh(jax, jnp):
    """Anharmonic QUANTUM correction (VERDICT r3 item 1 / r4 items 1-2)
    — REPORTED FROM COMMITTED ARTIFACTS, never computed live here.

    The live perturbative-response jvp (32x2^14, third-order CHDriver
    force jets) is a long campaign computation. The bench's job is to
    CAPTURE the production observable, not to re-derive it, so this
    section only reads:

      scripts/flagship_response.npz   — perturbative-response estimator
          (scripts/exp_flagship_response.py: chunked jvp run, cached
          with its tier/chunk/wall metadata)
      scripts/flagship_scp_summary.npz — independent static SCP Hartree
          estimate (scripts/exp_xcheck_scp.py report, CPU campaign)
      scripts/flagship_exact_scp_{conf,eff}_nmd*.npz /
          flagship_exact_nmd*.npz — exact attractor values of the
          confined / SCP-effective / raw references (the j0 gate file
          is named by the response cache's ``gate`` field)

    A live re-run stays available for experiments via
    SCLMD_BENCH_ANH_LIVE=1 (chunked; SCLMD_BENCH_ANH_CHUNK, default 4)
    but is never on the default path."""
    from sclmd_jax import units as U

    sdir = os.path.dirname(NEGF_CACHE)
    out = {}
    if not os.path.exists(NEGF_CACHE):
        return {"anh_skipped": True,
                "reason": f"NEGF cache missing: {NEGF_CACHE}"}
    negf = np.load(NEGF_CACHE)
    j_ref = float(negf["j_nat"])

    resp_fn = os.path.join(sdir, "flagship_response.npz")
    if os.environ.get("SCLMD_BENCH_ANH_LIVE"):
        # experiment path only — refresh the cache in-process
        sys.path.insert(0, os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "scripts"))
        import exp_flagship_response
        exp_flagship_response.run_and_cache(
            chunk=int(os.environ.get("SCLMD_BENCH_ANH_CHUNK", "4")))

    if os.path.exists(resp_fn):
        r = np.load(resp_fn)
        j0, d1, d2 = (np.asarray(r[k]) for k in ("j0", "d1", "d2"))
        nmd = int(r["nmd"])
        ref = str(r["ref"]) if "ref" in r.files else "conf"
        order = int(r["order"]) if "order" in r.files else 2
        gate = (str(r["gate"]) if "gate" in r.files
                else f"flagship_exact_conf_nmd{nmd}.npz")
        rn = np.sqrt(len(d1))
        exact_fn = os.path.join(sdir, gate)
        j_exact = (float(np.load(exact_fn)["j_nat"])
                   if os.path.exists(exact_fn) else j_ref)
        out.update({
            "anh_estimator": "perturbative response (jvp) on the "
                             f"{ref}-reference attractor, order "
                             f"{order} (cached: ntraj={len(d1)}, "
                             f"nmd={nmd}, chunk={int(r['chunk'])}, "
                             f"wall {float(r['wall_s']):.0f} s)",
            "anh_exact_base": f"exact_gle(D_{ref})"
                              if j_exact != j_ref
                              else f"landauer (exact {ref} cache "
                                   "missing)",
            "anh_nmd": nmd,
            "anh_j0_gate_dev_pct": round(
                (float(j0.mean()) - j_exact) / j_ref * 100, 3),
            "anh_j0_gate_sem_pct": round(
                float(j0.std()) / rn / j_ref * 100, 3),
            "anh_d1_pct": round(float(d1.mean()) / j_ref * 100, 3),
            "anh_d1_sem_pct": round(float(d1.std()) / rn / j_ref * 100,
                                    3),
        })
        if order >= 2 and np.isfinite(d2).all():
            corr = float(d1.mean() + d2.mean() / 2)
            csem = float(np.hypot(d1.std(), d2.std() / 2) / rn)
            j_anh = j_exact + corr
            out.update({
                "anh_d2half_pct": round(
                    float(d2.mean()) / 2 / j_ref * 100, 3),
                "anh_d2half_sem_pct": round(
                    float(d2.std()) / 2 / rn / j_ref * 100, 3),
                "anh_correction_pct": round(corr / j_ref * 100, 3),
                "anh_correction_sem_pct": round(csem / j_ref * 100,
                                                3),
                "anh_kappa_md_nw_per_k": round(
                    j_anh / (XC_T * XC_DELTA) * U.CURCOF, 5),
            })
        else:
            # flagship finding (r5, measured): at a finite periodic
            # comb the attractor response is rational in lam with a
            # pole wherever a dD-shifted soft mode crosses a comb
            # line; around D_eff the pole forest has ~1e-3 spacing
            # (d1 grows 7x over lam = 5e-4; d2/2 ~ 1e7 x the signal
            # for both polynomial families), so no order-2
            # lam-extrapolation exists at finite nmd. The response
            # run contributes the j0 gate vs exact(D_ref) and the
            # d1 SCP-self-consistency null; the quotable anharmonic
            # number is the static SCP continuum delta below.
            out["anh_response_role"] = (
                "certification gate (j0 vs exact attractor + d1 "
                "self-consistency null); order-2 lam-extrapolation "
                "unavailable at finite comb (soft-mode pole forest, "
                "PERF.md)")
    else:
        out["anh_response_missing"] = (
            "scripts/flagship_response.npz not cached — run "
            "scripts/exp_flagship_response.py")

    scp_fn = os.path.join(sdir, "flagship_scp_summary.npz")
    if os.path.exists(scp_fn):
        # independent static (SCP Hartree) theory estimate — CPU
        # campaign artifact (scripts/exp_xcheck_scp.py report). This
        # is the PRODUCTION number for the anharmonic quantum
        # correction: continuum representation, probe-SEM well under
        # the 2% bar, cross-validated by the comb-resolved 2^14
        # exact tiers and the d1 null above.
        scp = np.load(scp_fn)
        out["anh_scp_static_delta_pct"] = round(
            float(scp["delta_quantum_pct"]), 3)
        out["anh_scp_probe_sem_pct"] = round(
            float(scp["probe_sem_pct"]), 3)
        out["anh_scp_representation"] = str(scp["representation"])
        out["anh_scp_kappa_nw_per_k"] = round(
            float(scp["kappa_anh_nw_per_k"]), 5)
        if "anharmonic_quantum_dev_pct" not in out:
            out["anharmonic_quantum_dev_pct"] = round(
                float(scp["delta_quantum_pct"]), 2)
            out["anharmonic_quantum_sem_pct"] = round(
                float(scp["probe_sem_pct"]), 2)
            out["anh_quantum_source"] = (
                "scp_static (continuum Landauer of D_eff)")
    else:
        out["anh_scp_missing"] = (
            "scripts/flagship_scp_summary.npz not cached — run "
            "scripts/run_scp_campaign.sh")
    return out


# per-section wall budgets (seconds), compilation included: a section
# exceeding its budget is killed and recorded as {"error": "timeout"}
# instead of wedging the whole bench. crosscheck_anh is file-reads only.
SECTIONS = {"flagship": 600, "crosscheck": 900, "primary": 600,
            "primary_scaling": 600, "config5": 600,
            "crosscheck_anh": 120}

# The bench must print its JSON line even if EVERY section hits its
# budget: a global deadline caps the remaining budgets so the whole run
# fits — each section gets min(its budget, what's left after reserving
# a minimum slice for every section still queued).
GLOBAL_BUDGET_S = 2400
MIN_SECTION_S = 120


def _gpu_info():
    """Card name and power limit as nvidia-smi reports them (a child
    process that never touches JAX)."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return r.stdout.strip() or r.stderr.strip()


def run_section(name):
    import jax
    import jax.numpy as jnp

    from sclmd_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache(os.path.join(REPO, ".jax_cache"))
    if name == "probe":
        d = jax.devices()
        return {"platform": d[0].platform, "kind": d[0].device_kind,
                "count": len(d), "jax": jax.__version__}
    fn = globals()[name]
    return fn(jax, jnp)


def _run_child(name, budget):
    """Run one section in a child process; its result dict, or an
    ``{"error": ...}`` record on timeout or crash."""
    try:
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--section", name],
            capture_output=True, text=True, timeout=budget)
    except subprocess.TimeoutExpired:
        sys.stderr.write(f"section {name} timed out after {budget}s — "
                         "killed\n")
        return {"error": f"timeout after {budget}s"}
    for line in r.stdout.splitlines():
        if line.startswith("SECTION_JSON:"):
            return json.loads(line[len("SECTION_JSON:"):])
    sys.stderr.write(f"section {name} produced no result "
                     f"(rc={r.returncode}):\n{r.stderr[-2000:]}\n")
    return {"error": f"no result (rc={r.returncode})"}


def main():
    # ---- child mode: one section, own process ----
    if len(sys.argv) > 2 and sys.argv[1] == "--section":
        name = sys.argv[2]
        try:
            out = run_section(name)
        except Exception as e:      # noqa: BLE001 — keep the bench alive
            import traceback
            traceback.print_exc()
            print("SECTION_JSON:" + json.dumps({"error": repr(e)}))
            return
        print("SECTION_JSON:" + json.dumps(out))
        return

    # ---- parent: each section in its own subprocess, one at a time
    # (fresh XLA allocator/executable state, one JAX process on the
    # card). A section that times out or crashes is recorded as an
    # error and the chain continues: the bench must ALWAYS print its
    # JSON line ----
    probe = _run_child("probe", 300)
    if probe.get("platform") != "gpu":
        sys.stderr.write(f"bench.py needs a GPU as JAX's default device; "
                         f"found {probe}\n")
        sys.exit(2)
    results = {}
    t_start = time.time()
    names = list(SECTIONS)
    for i, (name, budget) in enumerate(SECTIONS.items()):
        left = GLOBAL_BUDGET_S - (time.time() - t_start)
        reserve = MIN_SECTION_S * (len(names) - i - 1)
        budget = max(MIN_SECTION_S, min(budget, int(left - reserve)))
        results[name] = _run_child(name, budget)

    p = results.get("primary") or {}
    fs = results.get("flagship")
    c5 = results.get("config5") or {}
    sc = results.get("primary_scaling") or {}
    fs = fs if fs and "error" not in fs else None

    ens = p.get("ens", {})
    best_ens = max(ens.values()) if ens else None
    single_sps = p.get("single_sps", 0.0)
    result = {
        "metric": "GLE steps/sec (100-atom junction, 1000-tap kernel, "
                  "blocked integrator, scan-only)",
        "value": round(single_sps, 1),
        "unit": "steps/s",
        "vs_baseline": round(single_sps / BASELINE_STEPS_PER_SEC, 1),
        "single_best_steps_per_sec": round(p.get("single_best_sps", 0.0),
                                           1),
        "with_noise_regen_steps_per_sec": round(p.get("regen_sps", 0.0),
                                                1),
        "with_host_noise_regen_steps_per_sec":
            round(p.get("regen_host_sps", 0.0), 1),
        "ordering_ok_scan_le_regen": p.get("ordering_ok"),
        "timing": "per-section subprocesses; interleaved reps; medians; "
                  "block_until_ready",
        "ensemble_traj_steps_per_sec": best_ens,
        "ensemble_block": 256,
        "ensemble_scaling": {str(k): v for k, v in ens.items()},
        "ensemble_vs_baseline":
            None if best_ens is None
            else round(best_ens / BASELINE_STEPS_PER_SEC, 1),
        "ensemble_e2e_scaling": sc,
        "config5_traj_steps_per_sec": c5.get("tsps"),
        "config5_ntraj": c5.get("ntraj"),
        "config5_atoms": c5.get("atoms"),
        "config5_finite": c5.get("finite"),
        "flagship_structure_data_traj_steps_per_sec":
            None if fs is None else fs["tsps"],
        "flagship_ntraj": None if fs is None else fs["ntraj"],
        "flagship_traj_steps_per_sec_1024":
            None if fs is None else fs.get("tsps_1024"),
        "flagship_chunk_1024": None if fs is None else fs.get("chunk_1024"),
        "flagship_ratio_1024_vs_128":
            None if fs is None else fs.get("ratio_1024_vs_128"),
        "flagship_within_15pct_of_128":
            None if fs is None else fs.get("within_15pct_of_128"),
        "flagship_vs_reference_12p5":
            None if fs is None
            else round(fs["tsps"] / BASELINE_STEPS_PER_SEC, 1),
        "finite": p.get("finite"),
        "J_left": p.get("J_left"),
        "J_right": p.get("J_right"),
        "device": {"platform": probe["platform"], "kind": probe["kind"],
                   "count": probe["count"], "card": _gpu_info()},
        "jax": probe.get("jax"),
    }
    xc = results.get("crosscheck")
    if xc is None or "error" in xc or xc.get("crosscheck_skipped"):
        # loud: the headline physics number is missing — say why
        result["crosscheck_skipped"] = True
        result["crosscheck_skip_reason"] = (
            "section produced no result" if xc is None
            else xc.get("reason", xc.get("error", "unknown")))
    else:
        result["crosscheck_kappa_md_nw_per_k"] = xc["kappa_md_nw_per_k"]
        result["crosscheck_kappa_negf_nw_per_k"] = \
            xc["kappa_negf_nw_per_k"]
        result["crosscheck_dev_pct"] = xc["dev_pct"]
        result["crosscheck_sem_pct"] = xc["sem_pct"]
    xa = results.get("crosscheck_anh")
    if xa:
        # artifact-reading section: surface every anh_* field it found
        # (incl. the explicit *_missing markers — silence is how the r4
        # production observable went unmeasured unnoticed)
        for k, v in xa.items():
            if k.startswith("anharmonic_quantum") or k == "anh_quantum_source":
                # the production observable — top-level, unprefixed
                result[k] = v
            elif k.startswith(("anh", "error")):
                result["crosscheck_" + k if k.startswith("anh")
                       else "crosscheck_anh_" + k] = v
    print(json.dumps(result))


if __name__ == "__main__":
    main()
