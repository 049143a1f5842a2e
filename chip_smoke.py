"""Smoke run of the GLE MD main path on one GPU, through the package's
normal entry points.

    python chip_smoke.py                # phases 1-4 on one card
    python chip_smoke.py --four-cards   # phase 5 alone, on four cards

Phases, at FULL sizes (tests/test_chip_smoke.py runs each at TINY sizes
on the CPU, and on the card with ``-m gpu``):

1. flagship ensemble: the reference's 201-atom C/H junction
   (scripts/flagship_negf.npz) with CHDriver forces and two electron
   baths, through ``md.Run`` and an auto-chunked ``md.RunEnsemble``;
2. memory-kernel junction: a 100-atom chain with two phonon baths of
   1000 kernel taps, through the md runner's blocked integrator, checked
   against the plain ``run_segment``;
3. precision: flagship steps in float32 on the device against float64
   on the CPU backend, with and without the HIGHEST matmul scope, and
   the device noise sampler's variance against its PSD integral;
4. float64 set-up and NEGF: relaxation, the CHDriver dynamical matrix,
   the exact_gle step Jacobian and the Caroli transmission sweep in
   native float64 on the device, against the committed CPU results;
5. four cards: flagship trajectories sharded over ``{"dp": 4}`` and
   ``{"dp": 2, "tp": 2}`` meshes and through the windowed shard-local
   noise synthesis, trajectory by trajectory against one card.

Exits non-zero and prints no result line when JAX's default device is
not a GPU or when any phase fails. The last line of standard output is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chip_smoke_out")
NEGF_NPZ = os.path.join(REPO, "scripts", "flagship_negf.npz")

T, DELTA = 300.0, 0.1
TL, TR = T * (1 + DELTA / 2), T * (1 - DELTA / 2)
DT = 0.25 / 0.658                       # 0.38 fs in natural time units
DAMP_NAT = 100 / 0.658211814201041      # 100 fs electron-bath damping
MAXOMEGA_EV = 0.45                      # NEGF cutoff above the C-H band
NEGF_NUM = 4000                         # intervals of the committed sweep

# Bounds: float32 under HIGHEST against float64, f64 on the card
# against f64 on the CPU, and the sampler's variance in standard errors.
BLOCKED_TOL = 1e-5       # max|p_blocked - p_plain| / max|p_plain|
PRECISION_TOL = 1e-4     # max|x_f32 - x_f64| / max|x_f64|, x = q, p
NOISE_Z = 4.0            # |sample variance - PSD integral| / SE
F64_TOL = 1e-8           # dynmat, transmission, conductance
SHARD_TOL = 1e-5         # max|J - J_one_card| / max|J_one_card|

FULL = {
    "flagship": {"nmd": 2048, "ntraj": 1024},
    "memkernel": {"natoms": 100, "nc": 90, "ml": 1000, "nmd": 2048,
                  "block": 256, "ntraj": 256, "cmp_steps": 256},
    "precision": {"nmd": 2048, "steps": 64, "noise_ntraj": 1024},
    "negf": {"stride": 1},
    "four_cards": {"per_card": 256, "nmd": 4096, "block": 256,
                   "window": 1024},
}
TINY = {
    "flagship": {"nmd": 64, "ntraj": 6},
    "memkernel": {"natoms": 10, "nc": 9, "ml": 16, "nmd": 64,
                  "block": 16, "ntraj": 4, "cmp_steps": 32},
    "precision": {"nmd": 64, "steps": 16, "noise_ntraj": 256},
    "negf": {"stride": 100},
    "four_cards": {"per_card": 2, "nmd": 64, "block": 16, "window": 32},
}


def gpu_info() -> str:
    """Card name and power limit as nvidia-smi reports them (a child
    process that never touches JAX); identical cards are counted."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    lines = [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]
    if not lines:
        return r.stderr.strip()
    return "; ".join(ln if lines.count(ln) == 1
                     else f"{lines.count(ln)} x {ln}"
                     for ln in sorted(set(lines)))


class Checks:
    """One phase's comparisons: each prints its value beside its bound,
    tagged with the card, and failures are collected."""

    def __init__(self, card: str, phase: str):
        self.tag = f"[{card}] {phase}:"
        self.failed = []

    def say(self, text: str):
        print(f"{self.tag} {text}", flush=True)

    def le(self, name: str, value, bound: float):
        value = float(value)
        ok = bool(np.isfinite(value) and value <= bound)
        self.say(f"{name} = {value:.3e} (bound {bound:g}) "
                 f"{'ok' if ok else 'FAIL'}")
        if not ok:
            self.failed.append(name)
        return value

    def true(self, name: str, cond, detail: str = ""):
        ok = bool(cond)
        self.say(f"{name}: {'ok' if ok else 'FAIL'} {detail}".rstrip())
        if not ok:
            self.failed.append(name)
        return ok


def _fresh(path: str) -> str:
    """An empty output directory (md.Run skips runs whose checkpoint it
    finds, so every run starts from a clean one)."""
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


@contextlib.contextmanager
def _spy(module, name: str):
    """Record the calls that code reaching ``module.name`` at call time
    makes, passing each on unchanged. Yields the list of (args,
    kwargs)."""
    orig = getattr(module, name)
    calls = []

    def recorder(*args, **kwargs):
        calls.append((args, kwargs))
        return orig(*args, **kwargs)

    setattr(module, name, recorder)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _timed(fn):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def _peak_bytes(device=None):
    import jax

    stats = (device or jax.devices()[0]).memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _gib(n) -> str:
    return "not reported" if n is None else f"{n / 2 ** 30:.3f} GiB"


def _flagship():
    """(axyz, partition, f64 dynamical matrix in eV^2) of the committed
    201-atom C/H junction."""
    from sclmd_jax.utils.junction import partition_by_axis

    z = np.load(NEGF_NPZ)
    axyz = [[str(e)] + [float(c) for c in p]
            for e, p in zip(z["els"], z["pos"])]
    return axyz, partition_by_axis(axyz), np.asarray(z["dyn_ev2"])


def _flagship_runner(axyz, part, dyn, drv, nmd, outdir, t_left=TL,
                     t_right=TR, seed=1234, dtype=None):
    """md runner of the flagship: CHDriver potential, two wideband
    electron baths with 100 fs damping, fixed end atoms."""
    import jax.numpy as jnp

    from sclmd_jax import baths as B
    from sclmd_jax.md import md

    dtype = dtype or jnp.float32
    runner = md(DT, nmd, T, axyz=axyz, dyn=dyn, dtype=dtype, seed=seed,
                outdir=_fresh(outdir))
    if drv is not None:
        runner.AddPotential(drv)
    for cats, temp in ((part["ecatsl"], t_left), (part["ecatsr"], t_right)):
        eta = np.identity(len(cats)) / DAMP_NAT
        runner.AddBath(B.ebath(cats, temp, runner.dt, runner.nmd, wmax=1.0,
                               nw=500, efric=eta, dtype=dtype))
    runner.AddConstr([part["fixdofs"]])
    return runner


def phase_flagship(size, chk: Checks):
    import jax
    import jax.numpy as jnp

    from sclmd_jax.models.hydrocarbon import CHDriver
    from sclmd_jax.parallel import ensemble as ens

    out = os.path.join(OUT_DIR, "flagship")
    nmd, ntraj = size["nmd"], size["ntraj"]
    axyz, part, dyn = _flagship()
    drv, t = _timed(lambda: CHDriver(axyz, dtype=jnp.float32))
    chk.say(f"CHDriver float32 build (force compile) {t:.3f} s")

    def runner(name, **kw):
        return _flagship_runner(axyz, part, dyn, drv, nmd,
                                os.path.join(out, name), **kw)

    # one trajectory through md.Run: the first call compiles
    walls = []
    for i in range(2):
        r = runner(f"run{i}", seed=i)
        _, t = _timed(r.Run)
        walls.append(t)
    chk.true("Run() heat currents finite", np.isfinite(r.curs).all())
    chk.say(f"Run() 1 trajectory x {nmd} steps: first call {walls[0]:.3f} s,"
            f" steady {walls[1]:.3f} s -> first-call overhead (trace +"
            f" compile) ~{walls[0] - walls[1]:.3f} s,"
            f" {nmd / walls[1]:.1f} steps/s")

    # the ensemble: a warm-up call compiles the chunk program, then an
    # antithetic pair (same seed, lead temperatures swapped) is timed;
    # the pair's half-difference cancels the zero-point noise, which
    # otherwise hides the sign of the mean heat current
    with _spy(ens, "_fused_chunk") as calls:
        _, t_first = _timed(lambda: runner("warm", seed=99).RunEnsemble(
            ntraj, nsteps=nmd))
    fwd, t_fwd = _timed(lambda: runner("fwd", seed=7).RunEnsemble(
        ntraj, nsteps=nmd))
    rev, t_rev = _timed(lambda: runner("rev", seed=7, t_left=TR,
                                       t_right=TL).RunEnsemble(
        ntraj, nsteps=nmd))
    args, kwargs = calls[0]
    chunk = int(np.asarray(args[2][0]).shape[0])
    steady = 0.5 * (t_fwd + t_rev)
    chk.say(f"RunEnsemble({ntraj}, nsteps={nmd}): auto_chunk chose "
            f"{chunk} ({len(calls)} chunks per call); first call "
            f"{t_first:.3f} s, steady {t_fwd:.3f} / {t_rev:.3f} s -> "
            f"first-call overhead ~{t_first - steady:.3f} s, "
            f"{ntraj * nmd / steady:.1f} trajectory-steps/s")
    chk.say(f"peak device memory {_gib(_peak_bytes())}")
    compiled = ens._fused_chunk.lower(*args, **kwargs).compile()
    chk.say(f"chunk program memory_analysis: {compiled.memory_analysis()}")
    chk.true("RunEnsemble currents finite",
             np.isfinite(fwd).all() and np.isfinite(rev).all())
    anti = 0.5 * (np.asarray(fwd) - np.asarray(rev))
    mean, sem = anti.mean(0), anti.std(0, ddof=1) / np.sqrt(len(anti))
    raw_sem = np.asarray(fwd).std(0, ddof=1) / np.sqrt(len(anti))
    chk.say(f"mean bath currents (natural units): raw left "
            f"{np.mean(fwd[:, 0]):+.4e} +- {raw_sem[0]:.1e}, right "
            f"{np.mean(fwd[:, 1]):+.4e} +- {raw_sem[1]:.1e}; antithetic "
            f"left {mean[0]:+.4e} +- {sem[0]:.1e}, right {mean[1]:+.4e} "
            f"+- {sem[1]:.1e}")
    chk.true("heat flows hot -> cold (antithetic left > 0 > right)",
             mean[0] > 0 > mean[1])
    return {"steps_per_s_single": nmd / walls[1],
            "traj_steps_per_s": ntraj * nmd / steady, "chunk": chunk,
            "peak_bytes": _peak_bytes(), "jax_devices": len(jax.devices())}


def _chain_baths(size):
    """(dyn, two phonon baths) of the memory-kernel chain: nc-DOF leads
    with an ml-tap kernel, Gaussian Gamma(w) at 300 K +- 5%."""
    import jax.numpy as jnp

    from sclmd_jax import baths as B
    from sclmd_jax.models.harmonic import chain_dynmat

    nph, nc, ml, nmd = 3 * size["natoms"], size["nc"], size["ml"], size["nmd"]
    dyn = np.asarray(chain_dynmat(nph, 0.04, dtype=jnp.float32))
    gwl = np.linspace(0.0, 0.6, 64)
    gam = np.array([np.eye(nc) * 0.01 * np.exp(-(w / 0.25) ** 2)
                    for w in gwl])
    baths = [B.phbath(temp, cats, 0.3, 128, DT, nmd, ml=ml, gamma=gam,
                      gwl=gwl, dtype=jnp.float32)
             for temp, cats in ((TL, range(nc)),
                                (TR, range(nph - nc, nph)))]
    return dyn, baths


def phase_memkernel(size, chk: Checks):
    import jax.numpy as jnp

    from sclmd_jax import md as M
    from sclmd_jax.parallel import ensemble as ens

    out = os.path.join(OUT_DIR, "memkernel")
    nmd, block, ntraj = size["nmd"], size["block"], size["ntraj"]
    (dyn, baths), t = _timed(lambda: _chain_baths(size))
    chk.say(f"bath set-up (host kernels, PSD factors) {t:.3f} s")

    def runner(name, seed):
        r = M.md(DT, nmd, T, dyn=dyn, dtype=jnp.float32, seed=seed,
                 axyz=[["C", 1.4 * i, 0.0, 0.0]
                       for i in range(size["natoms"])],
                 outdir=_fresh(os.path.join(out, name)), block=block)
        for b in baths:
            r.AddBath(b)
        return r

    walls = []
    with _spy(M, "run_segment_blocked") as blocked, \
            _spy(M, "run_segment") as plain:
        for i in range(2):
            r = runner(f"run{i}", seed=i)
            _, t = _timed(r.Run)
            walls.append(t)
    chk.true("Run() routes to run_segment_blocked",
             len(blocked) == 2 and not plain,
             f"({len(blocked)} blocked, {len(plain)} plain segments)")
    chk.true("Run() heat currents finite", np.isfinite(r.curs).all())
    chk.say(f"Run() 1 trajectory x {nmd} steps, ml={size['ml']}, "
            f"block={block}: first call {walls[0]:.3f} s, steady "
            f"{walls[1]:.3f} s -> first-call overhead "
            f"~{walls[0] - walls[1]:.3f} s, "
            f"{nmd / walls[1]:.1f} steps/s")

    # blocked vs plain integrator on the same noise and initial state
    n = size["cmp_steps"]
    system = r._build_system()          # baths carry Run()'s noise
    st = r.initialise(system)
    fp, _ = M.run_segment(system, st, n)
    fb, _ = M.run_segment_blocked(system, st, n, block=min(block, n))
    chk.le(f"blocked vs plain, {n} steps, max|dp|/max|p|",
           _rel(fb.p, fp.p), BLOCKED_TOL)

    with _spy(ens, "_fused_chunk") as calls:
        _, t_first = _timed(lambda: runner("warm", 99).RunEnsemble(
            ntraj, nsteps=nmd))
    res, t = _timed(lambda: runner("ens", 7).RunEnsemble(ntraj,
                                                         nsteps=nmd))
    chunk = int(np.asarray(calls[0][0][2][0]).shape[0])
    chk.true("RunEnsemble currents finite", np.isfinite(res).all())
    chk.say(f"RunEnsemble({ntraj}, nsteps={nmd}): chunk {chunk}, first "
            f"call {t_first:.3f} s, steady {t:.3f} s -> "
            f"{ntraj * nmd / t:.1f} trajectory-steps/s; peak device "
            f"memory {_gib(_peak_bytes())}")
    return {"steps_per_s_single": nmd / walls[1],
            "traj_steps_per_s": ntraj * nmd / t}


def _noise_variance(bath) -> np.ndarray:
    """Per-channel time-averaged variance of the sampler's series,
    exactly, from the bath's own PSD factors (U_m, s_m): the mirrored
    spectrum puts Re(xi_0), (-1)^k Re(xi_h) and 2 Re(xi_m e^{-i th k m})
    into x_k, and over one full period the pseudo-covariance terms of
    1 <= m < h average out, leaving

        var_c = [sum_j (Re U_0)^2_cj s_0j^2 + sum_j (Re U_h)^2_cj s_hj^2
                 + 2 sum_{0<m<h} sum_j |U_m|^2_cj s_mj^2] / (nmd dt)^2.
    """
    ev = np.asarray(bath.nevecs)
    s2 = np.asarray(bath.nstd, np.float64) ** 2       # (h+1, nc)
    nmd, h = int(bath.nmd), int(bath.nmd) // 2
    if ev.ndim == 3 and ev.strides[0] == 0:           # one shared matrix
        u = ev[0].astype(np.complex128)
        mid = s2[1:h].sum(0) @ (np.abs(u) ** 2).T
        ends = (s2[0] + s2[h]) @ (u.real ** 2).T
    else:
        u = ev.astype(np.complex128)
        mid = np.einsum("mcj,mj->c", np.abs(u[1:h]) ** 2, s2[1:h])
        ends = (u[0].real ** 2) @ s2[0] + (u[h].real ** 2) @ s2[h]
    return (ends + 2.0 * mid) / (nmd * float(bath.dt)) ** 2


def phase_precision(size, chk: Checks):
    from functools import partial

    import jax
    import jax.numpy as jnp

    from sclmd_jax import md as M
    from sclmd_jax.models.hydrocarbon import CHDriver
    from sclmd_jax.ops.noise import sample_noise_dev_batch

    out = os.path.join(OUT_DIR, "precision")
    nmd, n = size["nmd"], size["steps"]
    axyz, part, dyn = _flagship()
    r32 = _flagship_runner(axyz, part, dyn,
                           CHDriver(axyz, dtype=jnp.float32), nmd,
                           os.path.join(out, "f32"))
    # identical inputs for both precisions: host-drawn noise and the
    # device's own float32 thermal start, each widened for float64
    noise = [np.asarray(b.gnoi_np(100 + i).noise)
             for i, b in enumerate(r32.baths)]
    sys32 = r32._build_system()
    sys32 = sys32.replace(baths=tuple(
        b.replace(noise=jnp.asarray(z)) for b, z in zip(sys32.baths, noise)))
    st32 = r32.initialise(sys32)
    fin32, _ = M.run_segment(sys32, st32, n)

    cpu = jax.devices("cpu")[0]
    with jax.enable_x64(True), jax.default_device(cpu):
        r64 = _flagship_runner(axyz, part, dyn,
                               CHDriver(axyz, dtype=jnp.float64), nmd,
                               os.path.join(out, "f64"),
                               dtype=jnp.float64)
        sys64 = r64._build_system()
        sys64 = sys64.replace(baths=tuple(
            b.replace(noise=jnp.asarray(z, jnp.float64))
            for b, z in zip(sys64.baths, noise)))
        st64 = jax.tree.map(
            lambda x: jnp.asarray(np.asarray(x), jnp.float64
                                  if jnp.issubdtype(x.dtype, jnp.floating)
                                  else x.dtype), st32)
        fin64, _ = M.run_segment(sys64, st64, n)
    for x in ("q", "p"):
        chk.le(f"{n} flagship steps, f32 HIGHEST vs CPU f64, "
               f"max|d{x}|/max|{x}|",
               _rel(getattr(fin32, x), getattr(fin64, x)), PRECISION_TOL)

    # the same steps with the precision scope removed: what default
    # matmul precision (TF32 on tensor cores) would do to the hot loop
    @jax.jit
    def unscoped(system, state):
        xs = tuple((M._noise_rows(b.noise, nmd, 0, 0, n),
                    M._noise_rows(b.noise, nmd, 0, 1, n))
                   for b in system.baths)
        return jax.lax.scan(partial(M._vv_step_body, system), state, xs)[0]

    fin_d = unscoped(sys32, st32)
    chk.say(f"{n} flagship steps without the HIGHEST scope (default "
            f"precision) vs CPU f64: max|dq|/max|q| = "
            f"{_rel(fin_d.q, fin64.q):.3e}, max|dp|/max|p| = "
            f"{_rel(fin_d.p, fin64.p):.3e}")

    # device noise sampler against the PSD integral
    bath = r32.baths[0]
    keys = jax.random.split(jax.random.PRNGKey(2024), size["noise_ntraj"])
    x = sample_noise_dev_batch(bath, keys)
    v = np.asarray(jnp.mean(x * x, axis=1), np.float64)      # (ntraj, nc)
    want = _noise_variance(bath)
    se = v.std(0, ddof=1) / np.sqrt(len(v))
    z = np.abs(v.mean(0) - want) / se
    chk.say(f"noise variance, {len(v)} trajectories x {nmd} steps x "
            f"{v.shape[1]} channels: mean relative deviation "
            f"{np.mean((v.mean(0) - want) / want):+.3e}, median SE/var "
            f"{np.median(se / want):.2e}")
    chk.le("noise variance max |z| over channels", z.max(), NOISE_Z)
    return {"noise_zmax": z.max()}


def phase_negf(size, chk: Checks):
    import jax
    import jax.numpy as jnp

    from sclmd_jax import units as U
    from sclmd_jax.md import gle_step_jacobian
    from sclmd_jax.models.hydrocarbon import CHDriver
    from sclmd_jax.negf import bpt, landauer_current_natural
    from sclmd_jax.utils.junction import relax_for_model

    stride = size["stride"]
    ref = np.load(NEGF_NPZ)
    axyz, part, dyn_ref = _flagship()

    def kappa(ws_ev, tm):
        j = float(landauer_current_natural(ws_ev, tm, TL, TR))
        return j / (T * DELTA) * U.CURCOF

    with jax.enable_x64(True):
        (_, fmax, nit), t = _timed(lambda: relax_for_model(
            axyz, lambda a: CHDriver(a, dtype=jnp.float64),
            part["fixed_atoms"], iters=1))
        chk.say(f"set-up: relax_for_model (f64 L-BFGS) {t:.3f} s, "
                f"{nit} steps")
        chk.le("relaxed geometry fmax (eV/Ang)", fmax, 5e-3)
        dyn, t = _timed(lambda: CHDriver(axyz, dtype=jnp.float64).dynmat())
        chk.say(f"set-up: CHDriver f64 dynmat ({len(dyn_ref)} DOF) {t:.3f} s")
        chk.le("dynmat vs committed CPU f64, max|dD|/max|D|",
               _rel(dyn, dyn_ref), F64_TOL)
        dyn = np.asarray(dyn)
        r = _flagship_runner(axyz, part, dyn, None, 64,
                             os.path.join(OUT_DIR, "negf"),
                             dtype=jnp.float64)
        A, t = _timed(lambda: gle_step_jacobian(r._build_system()))
        chk.say(f"set-up: exact_gle step Jacobian {A.shape} {t:.3f} s")
        chk.true("step Jacobian finite", np.isfinite(A).all())

        fixd = part["fixdofs"]
        sweep = bpt(dyn / U.RPC ** 2, MAXOMEGA_EV, 0.1,
                    [part["ecatsl"], part["ecatsr"]],
                    [fixd[:len(fixd) // 2], fixd[len(fixd) // 2:]],
                    num=NEGF_NUM // stride)
        tmn, t = _timed(sweep.gettm)
        ws_ev, tm = tmn[:, 0] * U.RPC, tmn[:, 1]
        chk.say(f"Caroli sweep, {len(tm)} points in f64: {t:.3f} s")
        tm_ref, ws_ref = ref["tm"][::stride], ref["ws_ev"][::stride]
        chk.le("transmission vs committed, max|dT|/max|T|",
               _rel(tm, tm_ref), F64_TOL)
        k_ref = (float(ref["kappa_nw_per_k"]) if stride == 1
                 else kappa(ws_ref, tm_ref))
        k = kappa(ws_ev, tm)
        chk.le(f"conductance {k:.6f} nW/K vs {k_ref:.6f}, relative",
               abs(k - k_ref) / abs(k_ref), F64_TOL)
    return {"kappa_nw_per_k": k}


def phase_four_cards(size, chk: Checks):
    """In float64: the anharmonic flagship is chaotic, and over 4096
    float32 steps it amplifies any change of summation order to ~4e-3 of
    the per-trajectory currents (as a 1e-7 change of the initial state
    does), which would hide a sharding fault; in float64 the same
    amplification stays far below the bound."""
    import jax

    with jax.enable_x64(True):
        _four_cards(size, chk)


def _four_cards(size, chk: Checks):
    import jax
    import jax.numpy as jnp

    from sclmd_jax.models.hydrocarbon import CHDriver
    from sclmd_jax.parallel.ensemble import (_noisy_system, ensemble_noise,
                                             ensemble_run, ensemble_states,
                                             make_mesh, shard_ensemble,
                                             sharded_synthesis_run)

    ncard, nmd, block = 4, size["nmd"], size["block"]
    ntraj = size["per_card"] * ncard
    skip = int(nmd * 0.25)          # the equilibration share both use
    axyz, part, dyn = _flagship()
    r = _flagship_runner(axyz, part, dyn, CHDriver(axyz, dtype=jnp.float64),
                         nmd, os.path.join(OUT_DIR, "four_cards"),
                         dtype=jnp.float64)
    sysf = _noisy_system(r)
    nkey, ikey = jax.random.split(jax.random.PRNGKey(11))
    bsys = ensemble_noise(sysf, nkey, ntraj)
    states = ensemble_states(bsys, ntraj, key=ikey,
                             hw=jnp.asarray(r.hw, jnp.float64),
                             evecs=jnp.asarray(r.U, jnp.float64), T=r.T)

    def per_traj(cur):
        return np.asarray(cur[:, skip:, :].sum(axis=1)) / (nmd - skip)

    (_, ys), t = _timed(lambda: ensemble_run(bsys, states, nmd,
                                             block=block))
    j_ref = per_traj(ys["cur"])
    del ys
    chk.say(f"one card: {ntraj} trajectories x {nmd} float64 steps "
            f"{t:.3f} s (compile included)")
    for label, axes, tp in (("dp=4", {"dp": 4}, None),
                            ("dp=2 x tp=2", {"dp": 2, "tp": 2}, "tp")):
        mesh = make_mesh(axes)
        s_sys, s_st = shard_ensemble(mesh, bsys, states, dp="dp", tp=tp)
        with jax.set_mesh(mesh):
            (_, ys), t = _timed(lambda: ensemble_run(s_sys, s_st, nmd,
                                                     block=block))
        ndev = len(ys["cur"].sharding.device_set)
        chk.say(f"{label}: {t:.3f} s (compile included)")
        chk.true(f"{label} outputs span {ncard} devices", ndev == ncard,
                 f"({ndev})")
        chk.le(f"{label} vs one card, max|dJ|/max|J| per trajectory",
               _rel(per_traj(ys["cur"]), j_ref), SHARD_TOL)
        del ys
    mesh = make_mesh({"dp": ncard})
    (_, csum), t = _timed(lambda: sharded_synthesis_run(
        mesh, sysf, states, nkey, ntraj, nmd, block=block,
        noise_window=size["window"]))
    ndev = len(csum.sharding.device_set)
    chk.say(f"sharded_synthesis_run, noise_window={size['window']}: "
            f"{t:.3f} s (compile included)")
    chk.true(f"windowed synthesis outputs span {ncard} devices",
             ndev == ncard, f"({ndev})")
    chk.le("windowed synthesis vs one card, max|dJ|/max|J| per trajectory",
           _rel(np.asarray(csum) / (nmd - skip), j_ref), SHARD_TOL)
    peaks = [_peak_bytes(d) for d in jax.devices()[:ncard]]
    chk.say("peak memory per card: " + ", ".join(_gib(p) for p in peaks))
    return {"peak_bytes": peaks}


ONE_CARD = (("flagship", phase_flagship), ("memkernel", phase_memkernel),
            ("precision", phase_precision), ("negf", phase_negf))
FOUR_CARDS = (("four_cards", phase_four_cards),)


def run_phases(phases, sizes, card: str) -> list:
    """Run each phase, printing as it goes; the names of failed phases."""
    failed = []
    for name, fn in phases:
        chk = Checks(card, name)
        t0 = time.perf_counter()
        try:
            fn(sizes[name], chk)
        except Exception:            # noqa: BLE001 — report, go on
            traceback.print_exc()
            chk.failed.append("raised")
        verdict = ("ok" if not chk.failed
                   else "FAILED: " + ", ".join(chk.failed))
        chk.say(f"phase wall {time.perf_counter() - t0:.1f} s, {verdict}")
        if chk.failed:
            failed.append(name)
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run phase 5 alone, across four cards")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    need = 4 if args.four_cards else 1
    if devices[0].platform != "gpu" or len(devices) < need:
        print(f"chip_smoke: needs {need} GPU(s) as JAX's devices, found "
              f"{len(devices)} x {devices[0].platform!r}; nothing was run",
              file=sys.stderr)
        return 2

    from sclmd_jax.utils.compile_cache import enable_compile_cache

    cache_dir = enable_compile_cache(os.path.join(REPO, ".jax_cache"))
    cache = {"hits": 0, "misses": 0}

    def on_event(event, **_):
        if event == "/jax/compilation_cache/cache_hits":
            cache["hits"] += 1
        elif event == "/jax/compilation_cache/cache_misses":
            cache["misses"] += 1

    jax.monitoring.register_event_listener(on_event)
    card = gpu_info()
    kind = devices[0].device_kind
    print(f"card (nvidia-smi name, power.limit): {card}")
    print(f"JAX {jax.__version__}: {len(devices)} x {kind}; compile cache "
          f"{cache_dir}", flush=True)

    failed = run_phases(FOUR_CARDS if args.four_cards else ONE_CARD, FULL,
                        card)
    print(f"[{card}] compile cache: {cache['hits']} hits, "
          f"{cache['misses']} misses")
    if failed:
        print(f"chip_smoke: failed phases: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
