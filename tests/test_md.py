"""Tests of the GLE velocity-Verlet scan engine (sclmd_jax.md)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sclmd_jax import baths as B
from sclmd_jax import units as U
from sclmd_jax.md import (GLESystem, MDState, initial_state, md, run_segment,
                          set_dyn, thermal_init, vv_step)
from sclmd_jax.models.harmonic import HarmonicDriver, chain_dynmat
from sclmd_jax.ops.functions import rpadleft


def reference_vv(dyn, baths_np, mask, dt, state, nsteps):
    """Plain-NumPy re-derivation of md.py:367-435 for tiny systems.

    baths_np: list of dicts {cids, kernel (ml,nc,nc), noise (nmd,nc),
    local(bool), nmd} — phonon-style friction only.
    """
    nph = dyn.shape[0]
    t, p, q = state
    ml = max(b["kernel"].shape[0] for b in baths_np)
    phis = np.zeros((ml, nph))
    qhis = np.zeros((ml, nph))

    def bf(b, it, ph, qh):
        f = b["noise"][it % b["nmd"]].copy()
        k = b["kernel"]
        for m in range(k.shape[0]):
            term = k[m] @ ph[m][b["cids"]]
            f -= term if k.shape[0] == 1 else term * dt
        out = np.zeros(nph)
        out[b["cids"]] = f
        return out

    curs, etots = [], []
    for _ in range(nsteps):
        etots.append(0.5 * p @ p)
        qhis = np.concatenate([q[None], qhis[:-1]])
        phis = np.concatenate([p[None], phis[:-1]])
        fb0 = [bf(b, t, phis, qhis) for b in baths_np]
        f = -dyn @ q + sum(fb0)
        pthalf = p + f * dt / 2
        qtt = q + p * dt + f * dt**2 / 2
        curs.append([fb @ p for fb in fb0])
        for _corr in range(2):
            tphis = np.concatenate([(pthalf if _corr == 0 else ptt1)[None],
                                    phis[:-1]])
            tqhis = np.concatenate([qtt[None], qhis[:-1]])
            f = -dyn @ qtt + sum(bf(b, t + 1, tphis, tqhis)
                                 for b in baths_np)
            ptt1 = pthalf + dt / 2 * f
        p = ptt1 * mask
        q = qtt * mask
        t += 1
    return (t, p, q), np.array(curs), np.array(etots)


def make_system(dyn, baths, dt, nmd, mask=None, savep=False, **kw):
    nph = dyn.shape[0]
    ml = max([b.ml for b in baths], default=1)
    return GLESystem(
        dyn=jnp.asarray(dyn), baths=tuple(baths),
        mask=jnp.ones(nph) if mask is None else jnp.asarray(mask),
        dt=dt, nph=nph, ml=ml, nmd=nmd, savep=savep, **kw)


class TestStepAgainstOracle:
    @pytest.mark.parametrize("ml", [1, 4])
    def test_matches_numpy_reference(self, rng, key, ml):
        nph, nmd, dt = 6, 16, 0.3
        dyn = np.asarray(chain_dynmat(nph, 0.05))
        cids = np.array([0, 1])
        if ml == 1:
            pb = B.phbath(300.0, cids, 0.1, 20, dt, nmd, dtype=jnp.float64)
        else:
            gwl = np.linspace(0, 0.5, 8)
            gam = np.array([np.eye(2) * 0.1 * np.exp(-w) for w in gwl])
            pb = B.phbath(300.0, cids, 0.25, 20, dt, nmd, ml=ml,
                          gamma=gam, gwl=gwl, dtype=jnp.float64)
        pb = pb.gnoi(key)
        mask = np.ones(nph)
        mask[-1] = 0.0
        system = make_system(dyn, [pb], dt, nmd, mask=mask)

        p0 = rng.normal(size=nph) * mask
        q0 = rng.normal(size=nph) * mask
        st = initial_state(system, dtype=jnp.float64).replace(
            p=jnp.asarray(p0), q=jnp.asarray(q0))
        nsteps = 10
        final, ys = run_segment(system, st, nsteps)

        bnp = dict(cids=cids, kernel=np.asarray(pb.kernel),
                   noise=np.asarray(pb.noise), nmd=nmd)
        (t2, p2, q2), curs, etots = reference_vv(
            dyn, [bnp], mask, dt, (0, p0.copy(), q0.copy()), nsteps)

        np.testing.assert_allclose(np.asarray(final.p), p2, rtol=1e-10,
                                   atol=1e-12)
        np.testing.assert_allclose(np.asarray(final.q), q2, rtol=1e-10,
                                   atol=1e-12)
        np.testing.assert_allclose(np.asarray(ys["cur"]), curs, rtol=1e-9,
                                   atol=1e-12)
        np.testing.assert_allclose(np.asarray(ys["etot"]), etots, rtol=1e-10)
        assert int(final.t) == nsteps

    def test_energy_conservation_no_bath(self, rng):
        """Pure Verlet on a harmonic chain conserves total energy."""
        nph, dt = 8, 0.05
        dyn = np.asarray(chain_dynmat(nph, 0.2, kend=0.2))
        system = make_system(dyn, [], dt, 128)
        q0 = rng.normal(size=nph) * 0.1
        st = initial_state(system, dtype=jnp.float64).replace(
            q=jnp.asarray(q0))
        e0 = 0.5 * q0 @ dyn @ q0
        final, ys = run_segment(system, st, 2000)
        p, q = np.asarray(final.p), np.asarray(final.q)
        e1 = 0.5 * p @ p + 0.5 * q @ dyn @ q
        assert abs(e1 - e0) / e0 < 1e-3


def _iter_eqns(jaxpr):
    """All equations of a jaxpr, recursing into scan/cond/pjit bodies."""
    for eqn in jaxpr.eqns:
        yield eqn
        for v in eqn.params.values():
            vs = v if isinstance(v, (tuple, list)) else (v,)
            for sub in vs:
                inner = getattr(sub, "jaxpr", None)
                if inner is not None:
                    yield from _iter_eqns(inner)


class TestMatmulPrecision:
    """The hot loop must trace under HIGHEST matmul precision: at
    default precision an f32 dot may run in a reduced-precision mode
    (TF32 on GPU tensor cores, one-pass bf16 elsewhere), and once vmap
    turns the conservative-force GEMV into a batched GEMM the ~1e-3
    relative error parametrically heats the junction (flagship etot
    1e1 -> 8e16 over 4096 steps in a bf16-pass run; single-trajectory
    runs looked fine, which is why this needs a trace-level pin rather
    than a CPU numerics test). The device noise samplers, thermal_init
    and the fused ensemble chunk are pinned the same way."""

    def _assert_all_highest(self, traced):
        dots = [e for e in _iter_eqns(traced.jaxpr)
                if e.primitive.name == "dot_general"]
        assert dots, "expected dot_general eqns in the hot loop"
        for e in dots:
            prec = e.params.get("precision")
            assert prec is not None and all(
                p == jax.lax.Precision.HIGHEST for p in prec), (
                e.primitive.name, prec)

    def _system(self, rng, key):
        nph, nmd, dt = 6, 32, 0.2
        dyn = np.asarray(chain_dynmat(nph, 0.1))
        pb = B.phbath(200.0, np.array([0, 5]), 0.2, 16, dt, nmd, ml=4,
                      gamma=np.array([np.eye(2) * 0.1] * 4),
                      gwl=np.linspace(0, 0.5, 4),
                      dtype=jnp.float64).gnoi(key)
        system = make_system(dyn, [pb], dt, nmd)
        st = initial_state(system, dtype=jnp.float64).replace(
            q=jnp.asarray(rng.normal(size=nph) * 0.1))
        return system, st

    def test_run_segment_dots_are_highest(self, rng, key):
        system, st = self._system(rng, key)
        self._assert_all_highest(
            jax.make_jaxpr(lambda s: run_segment(system, s, 8))(st))

    def test_run_segment_blocked_dots_are_highest(self, rng, key):
        from sclmd_jax.md import run_segment_blocked
        system, st = self._system(rng, key)
        self._assert_all_highest(jax.make_jaxpr(
            lambda s: run_segment_blocked(system, s, 16, block=8))(st))

    def test_vmapped_blocked_dots_are_highest(self, rng, key):
        """The ensemble path (vmap of the blocked integrator) is where
        the batched-GEMM downcast actually bit."""
        from sclmd_jax.md import run_segment_blocked
        system, st = self._system(rng, key)
        batch = jax.tree.map(lambda x: jnp.stack([x, x]), st)
        self._assert_all_highest(jax.make_jaxpr(jax.vmap(
            lambda s: run_segment_blocked(system, s, 16, block=8)))(batch))


    @pytest.mark.parametrize("which", ["prop", "parts", "window",
                                       "thermal_init", "fused_chunk"])
    def test_device_setup_dots_are_highest(self, rng, key, which):
        from sclmd_jax.md import thermal_init
        from sclmd_jax.ops import noise as NZ
        from sclmd_jax.parallel.ensemble import (_fused_chunk,
                                                 bath_factor_triples)

        nc, nmd, dt = 3, 32, 0.2
        ev = rng.normal(size=(nmd // 2 + 1, nc, nc))
        std = np.abs(rng.normal(size=(nmd // 2 + 1, nc)))
        if which == "prop":
            fn = lambda k: NZ.sample_noise_prop(k, ev[0], ev[0], std,
                                                dt, nmd)
        elif which == "parts":
            fn = lambda k: NZ.sample_noise_parts(k, ev, ev, std, dt, nmd)
        elif which == "window":
            fn = lambda k: NZ.sample_noise_window(k, ev, ev, std, dt, nmd,
                                                  3, 8)
        else:
            system, st = self._system(rng, key)
            hw = jnp.asarray(np.linspace(0.01, 0.3, system.nph))
            evecs = jnp.asarray(np.linalg.qr(
                rng.normal(size=(system.nph, system.nph)))[0])
            if which == "thermal_init":
                fn = lambda k: thermal_init(k, system, hw, evecs, 300.0)
            else:
                baths = tuple(b.prepare_noise() for b in system.baths)
                facs = bath_factor_triples(baths)
                hot = system.replace(baths=tuple(
                    b.replace(nevecs=None, nstd=None, noise=None)
                    for b in baths))

                def fn(k):
                    keys = jax.random.split(k, 2)
                    return _fused_chunk(hot, facs, (keys,), keys, hw,
                                        evecs, 300.0, 16, 0, 8, 4)
        self._assert_all_highest(jax.make_jaxpr(fn)(key))


class TestSegmenting:
    def test_two_segments_equal_one(self, rng, key):
        nph, nmd, dt = 4, 32, 0.2
        dyn = np.asarray(chain_dynmat(nph, 0.1))
        pb = B.phbath(200.0, np.array([0, 3]), 0.2, 16, dt, nmd,
                      dtype=jnp.float64).gnoi(key)
        system = make_system(dyn, [pb], dt, nmd)
        st = initial_state(system, dtype=jnp.float64).replace(
            q=jnp.asarray(rng.normal(size=nph) * 0.1))
        f_full, _ = run_segment(system, st, 32)
        mid, _ = run_segment(system, st, 16)
        f_two, _ = run_segment(system, mid, 16, t0=16)
        np.testing.assert_allclose(np.asarray(f_full.p), np.asarray(f_two.p),
                                   rtol=1e-12)
        np.testing.assert_allclose(np.asarray(f_full.q), np.asarray(f_two.q),
                                   rtol=1e-12)


class TestThermalisation:
    def test_classical_equipartition(self, key):
        """Wideband classical baths at T on all DOFs -> <KE> = nph kT / 2."""
        nph, dt, T = 8, 0.25 / 0.658, 300.0
        nmd = 2 ** 13
        dyn = np.asarray(chain_dynmat(nph, 0.04, kend=0.04))
        eta = np.eye(nph) / (100 / 0.658)
        eb = B.ebath(range(nph), T, dt, nmd, wmax=1.0, nw=500,
                     efric=eta, classical=True, dtype=jnp.float64)
        eb = eb.gnoi(key)
        system = make_system(dyn, [eb], dt, nmd)
        st = initial_state(system, dtype=jnp.float64)
        final, ys = run_segment(system, st, nmd)
        # discard the first quarter as equilibration
        ke = np.asarray(ys["etot"])[nmd // 4:].mean()
        expect = 0.5 * nph * U.KB * T
        assert abs(ke - expect) / expect < 0.10, (ke, expect)

    def test_heat_flows_hot_to_cold(self, key):
        nph, dt, T, delta = 8, 0.25 / 0.658, 300.0, 0.5
        nmd = 2 ** 13
        dyn = np.asarray(chain_dynmat(nph, 0.04))
        eta = np.eye(2) / (100 / 0.658)
        k1, k2 = jax.random.split(key)
        ebl = B.ebath([0, 1], T * (1 + delta / 2), dt, nmd, wmax=1.0,
                      efric=eta, dtype=jnp.float64).gnoi(k1)
        ebr = B.ebath([6, 7], T * (1 - delta / 2), dt, nmd, wmax=1.0,
                      efric=eta, dtype=jnp.float64).gnoi(k2)
        system = make_system(dyn, [ebl, ebr], dt, nmd)
        st = initial_state(system, dtype=jnp.float64)
        final, ys = run_segment(system, st, nmd)
        cur = np.asarray(ys["cur"])[nmd // 4:]
        jl, jr = cur[:, 0].mean(), cur[:, 1].mean()
        assert jl > 0 and jr < 0        # energy in from hot, out to cold
        # stationarity: net flux roughly balances
        assert abs(jl + jr) < 0.5 * max(abs(jl), abs(jr))


class TestWrapper:
    def _build(self, tmpdir, nmd=64, npie=1, seed=7):
        nat = 4
        axyz = [["C", 1.0 * i, 0.0, 0.0] for i in range(nat)]
        dyn = np.asarray(chain_dynmat(3 * nat, 0.05))
        runner = md(0.4, nmd, 300.0, axyz=axyz, dyn=dyn, nstart=0,
                    nstop=1, npie=npie, dtype=jnp.float64, seed=seed,
                    outdir=str(tmpdir))
        eta = np.eye(3) / 80.0
        eb = B.ebath(range(3), 300.0, 0.4, nmd, wmax=1.0, efric=eta,
                     dtype=jnp.float64)
        runner.AddBath(eb)
        runner.AddConstr([range(9, 12)])
        return runner

    def test_run_writes_kappa(self, tmp_path):
        runner = self._build(tmp_path)
        runner.Run()
        files = list(tmp_path.glob("kappa.300.bath0.run0.dat"))
        assert len(files) == 1
        row = files[0].read_text().split()
        assert int(row[0]) == 0 and float(row[1]) == 300.0

    def test_resume_matches_uninterrupted(self, tmp_path):
        import shutil
        d1 = tmp_path / "full"
        d2 = tmp_path / "interrupted"
        d1.mkdir()
        d2.mkdir()
        r1 = self._build(d1, nmd=64, npie=4, seed=3)
        r1.Run()
        ck1 = np.load(d1 / "MD0.npz")

        # interrupted run: execute only 2 segments, then rebuild + resume
        r2 = self._build(d2, nmd=64, npie=4, seed=3)
        system = r2._build_system()
        state = r2.initialise(system)
        for i in range(len(r2.baths)):
            r2.baths[i] = r2.baths[i].gnoi(r2._next_key())
        system = r2._build_system()
        from sclmd_jax.md import run_segment as rs
        for i in range(2):
            state, _ = rs(system, state, 16, t0=16 * i)
        r2.dump(state, 1, 0)
        # fresh wrapper resumes from the checkpoint
        r3 = self._build(d2, nmd=64, npie=4, seed=3)
        r3.Run()
        ck2 = np.load(d2 / "MD0.npz")
        np.testing.assert_allclose(ck1["p"], ck2["p"], rtol=1e-10)
        np.testing.assert_allclose(ck1["q"], ck2["q"], rtol=1e-10)

    def test_constraint_holds(self, tmp_path):
        runner = self._build(tmp_path)
        runner.Run()
        assert np.allclose(np.asarray(runner.state.q)[9:12], 0.0)
        assert np.allclose(np.asarray(runner.state.p)[9:12], 0.0)

    def test_traj_and_power_outputs(self, tmp_path):
        runner = self._build(tmp_path)
        runner.CalPowerSpec()
        runner.SaveTraj(16)
        runner.Run()
        assert (tmp_path / "power.300.run0.dat").exists()
        traj = (tmp_path / "trajectories.300.run0.ani").read_text()
        assert traj.splitlines()[0].strip() == "4"


class TestFailureDetection:
    def test_divergence_raises_with_context(self, tmp_path):
        """An unstable run aborts with a FloatingPointError naming the
        step and an honest last-good-checkpoint pointer instead of
        writing NaN output. The blow-up comes from the driver's
        anti-restoring force."""
        nat = 2
        axyz = [["C", 1.0 * i, 0.0, 0.0] for i in range(nat)]
        runner = md(4.0, 256, 300.0, axyz=axyz, dyn=None, nstop=1,
                    dtype=jnp.float64, outdir=str(tmp_path))

        class BadDriver:
            conv = np.ones(3 * nat)

            def force(self, q):
                return 5.0 * q  # anti-restoring

            force_jax = force

        runner.AddPotential(BadDriver())
        eb = B.ebath(range(3), 300.0, 4.0, 256, wmax=1.0,
                     efric=np.eye(3) * 0.01, dtype=jnp.float64)
        runner.AddBath(eb)
        with pytest.raises(FloatingPointError, match="non-finite") as ei:
            runner.Run()
        # fresh run, first segment: must NOT claim MD0.npz is good
        assert "none (run diverged" in str(ei.value)


class TestRunEnsemble:
    def test_vmapped_ensemble_writes_kappa_files(self, tmp_path):
        nat = 4
        axyz = [["C", 1.0 * i, 0.0, 0.0] for i in range(nat)]
        dyn = np.asarray(chain_dynmat(3 * nat, 0.05))
        runner = md(0.4, 256, 300.0, axyz=axyz, dyn=dyn, nstop=1,
                    dtype=jnp.float64, outdir=str(tmp_path))
        eta = np.eye(3) / 80.0
        runner.AddBath(B.ebath(range(3), 330.0, 0.4, 256, wmax=1.0,
                               efric=eta, dtype=jnp.float64))
        runner.AddBath(B.ebath(range(9, 12), 270.0, 0.4, 256, wmax=1.0,
                               efric=eta, dtype=jnp.float64))
        means = runner.RunEnsemble(4)
        assert means.shape == (4, 2)
        # 4 pseudo-runs x 2 baths of kappa files, aggregatable by calTC
        files = sorted(tmp_path.glob("kappa.300.bath*.run*.dat"))
        assert len(files) == 8
        from sclmd_jax.utils.tools import calTC
        res = calTC(delta=0.2, dlist=0, bathnum=2, workdir=str(tmp_path))
        assert np.isfinite(res["conductance"][0])
        # hot bath injects on average
        assert means[:, 0].mean() > means[:, 1].mean()

    def test_ensemble_noise_takes_factor_path(self, tmp_path,
                                              monkeypatch):
        """RunEnsemble must sample noise through the precomputed PSD
        factors (sample_noise_dev — the batched, vmappable path), never
        the eager all-jnp enoise fallback with its per-call eigh
        (regression: the factors were stripped by _build_system before
        ensemble_noise saw them)."""
        import sclmd_jax.ops.noise as NZ

        nat = 2
        axyz = [["C", 1.0 * i, 0.0, 0.0] for i in range(nat)]
        dyn = np.asarray(chain_dynmat(3 * nat, 0.05))
        runner = md(0.4, 64, 300.0, axyz=axyz, dyn=dyn, nstop=1,
                    dtype=jnp.float64, outdir=str(tmp_path))
        runner.AddBath(B.ebath(range(3), 300.0, 0.4, 64, wmax=1.0,
                               efric=np.eye(3) / 80.0,
                               dtype=jnp.float64))

        def boom(*a, **k):
            raise AssertionError("eager enoise reached from "
                                 "RunEnsemble")

        monkeypatch.setattr(NZ, "enoise", boom)
        means = runner.RunEnsemble(2)
        assert np.isfinite(np.asarray(means)).all()

    def _chunk_runner(self, outdir, seed=7):
        nat = 4
        axyz = [["C", 1.0 * i, 0.0, 0.0] for i in range(nat)]
        dyn = np.asarray(chain_dynmat(3 * nat, 0.05))
        runner = md(0.4, 128, 300.0, axyz=axyz, dyn=dyn, nstop=1,
                    dtype=jnp.float64, seed=seed, outdir=str(outdir))
        eta = np.eye(3) / 80.0
        runner.AddBath(B.ebath(range(3), 330.0, 0.4, 128, wmax=1.0,
                               efric=eta, dtype=jnp.float64))
        runner.AddBath(B.ebath(range(9, 12), 270.0, 0.4, 128, wmax=1.0,
                               efric=eta, dtype=jnp.float64))
        return runner

    def test_chunked_matches_unchunked(self, tmp_path):
        """Memory-wall chunking must not change the physics: the
        per-trajectory key schedule depends only on the trajectory
        index, so ceil(ntraj/chunk) sequential chunks reproduce the
        single-batch run's noise and init draws EXACTLY. Since round 4
        the chunk runs as ONE fused XLA program whose fusion pattern
        depends on the chunk shape, so float summation order (and only
        that) varies: equality holds to roundoff, not bitwise."""
        d1, d2, d3 = tmp_path / "a", tmp_path / "b", tmp_path / "c"
        for d in (d1, d2, d3):
            d.mkdir()
        m_full = self._chunk_runner(d1).RunEnsemble(6, chunk=6)
        m_c2 = self._chunk_runner(d2).RunEnsemble(6, chunk=2)
        m_c4 = self._chunk_runner(d3).RunEnsemble(6, chunk=4)  # ragged
        np.testing.assert_allclose(m_c2, m_full, rtol=1e-11,
                                   atol=1e-15)
        np.testing.assert_allclose(m_c4, m_full, rtol=1e-11,
                                   atol=1e-15)

    def test_fused_matches_segmented_and_checkpoint_paths(self,
                                                          tmp_path):
        """The fused single-dispatch path (npie=1, checkpoint=False —
        noise synthesis + init + run + reduce as ONE program per chunk)
        must reproduce the segmented and checkpoint paths: identical
        key schedules (ensemble_noise/ensemble_states'), equality to
        XLA-fusion roundoff."""
        d1, d2, d3 = tmp_path / "f", tmp_path / "s", tmp_path / "k"
        for d in (d1, d2, d3):
            d.mkdir()
        m_fused = self._chunk_runner(d1).RunEnsemble(5)
        m_ck = self._chunk_runner(d2).RunEnsemble(5, checkpoint=True)
        m_seg = self._chunk_runner(d3).RunEnsemble(5, npie=2)
        np.testing.assert_allclose(m_fused, m_ck, rtol=1e-11,
                                   atol=1e-15)
        np.testing.assert_allclose(m_fused, m_seg, rtol=1e-11,
                                   atol=1e-15)

    def test_auto_chunk_sizing(self, tmp_path, monkeypatch):
        """auto_chunk honours the memory budget: tiny budget -> chunk 1;
        huge budget -> capped at min(ntraj, 512) (power of two). The
        default budget is half the device allocator's bytes_limit, or
        a fixed host budget where the device reports none."""
        import jax

        from sclmd_jax.parallel import ensemble as ens
        from sclmd_jax.parallel.ensemble import auto_chunk

        runner = self._chunk_runner(tmp_path)
        system = runner._build_system()
        assert auto_chunk(system, 1024, 128, None,
                          budget_bytes=1) == 1
        big = auto_chunk(system, 1024, 128, None,
                         budget_bytes=1 << 40)
        assert big == 512
        assert auto_chunk(system, 100, 128, None,
                          budget_bytes=1 << 40) == 100

        class _Dev:
            def __init__(self, stats):
                self.stats = stats

            def memory_stats(self):
                return self.stats

        per = ens.estimate_traj_bytes(system, 128, None)
        # default budget comes from the device's memory_stats()
        monkeypatch.setattr(jax, "devices",
                            lambda *a: [_Dev({"bytes_limit": 1})])
        assert auto_chunk(system, 64, 128, None) == 1
        monkeypatch.setattr(jax, "devices", lambda *a: [_Dev(
            {"bytes_limit": 2 * 2 * 16 * per})])
        assert auto_chunk(system, 64, 128, None, depth=2) == 16
        # no limit reported (CPU backend): the stated host budget
        monkeypatch.setattr(jax, "devices", lambda *a: [_Dev(None)])
        assert ens.device_memory_budget() == ens.HOST_BUDGET_BYTES

    def test_steady_mode_temps_weighted_average(self, tmp_path):
        """Per-mode steady temperatures are coupling-weighted averages
        of the bath temperatures: bounded by [TR, TL]; modes coupled
        only to one lead sit at that lead's temperature; zero-coupling
        modes keep the global T."""
        from sclmd_jax.md import steady_mode_temps

        runner = self._chunk_runner(tmp_path)   # baths at 330 / 270 K
        Tm = steady_mode_temps(runner.U, runner.baths, runner.T,
                               hw=np.asarray(runner.hw))
        assert Tm.shape == (12,)
        assert (Tm >= 270.0 - 1e-9).all() and (Tm <= 330.0 + 1e-9).all()
        # left-right mirror symmetry of the chain: the coupling-weighted
        # profile must average to the mean T over the spectrum
        assert abs(Tm.mean() - 300.0) < 5.0
        # a mode localized on the left bath DOFs only -> T of that bath
        U_ = np.zeros((12, 1))
        U_[0, 0] = 1.0
        Tl = steady_mode_temps(U_, runner.baths, runner.T)
        assert np.allclose(Tl, 330.0)
        # zero coupling everywhere -> global T
        U0 = np.zeros((12, 1))
        U0[5, 0] = 1.0   # DOF 5 touches neither bath (0-2, 9-11)
        T0 = steady_mode_temps(U0, runner.baths, runner.T)
        assert np.allclose(T0, 300.0)

    def test_steady_init_equal_temps_matches_uniform(self, tmp_path):
        """With all baths at the same temperature the steady profile IS
        the uniform profile, so steady_init must reproduce the
        reference-shaped start bitwise (same seed, same draws)."""
        nat = 4
        axyz = [["C", 1.0 * i, 0.0, 0.0] for i in range(nat)]
        dyn = np.asarray(chain_dynmat(3 * nat, 0.05))
        eta = np.eye(3) / 80.0

        def build(outdir):
            runner = md(0.4, 128, 300.0, axyz=axyz, dyn=dyn, nstop=1,
                        dtype=jnp.float64, seed=3,
                        outdir=str(outdir))
            for dofs in (range(3), range(9, 12)):
                runner.AddBath(B.ebath(dofs, 300.0, 0.4, 128, wmax=1.0,
                                       efric=eta, dtype=jnp.float64))
            return runner

        d1, d2 = tmp_path / "u", tmp_path / "s"
        d1.mkdir(), d2.mkdir()
        m_uniform = build(d1).RunEnsemble(3)
        m_steady = build(d2).RunEnsemble(3, steady_init=True)
        np.testing.assert_array_equal(m_steady, m_uniform)


class TestPeriodicWarmStart:
    """gle_step_jacobian + periodic_fixed_point: warm-starting ON the
    discrete periodic attractor of a noise period."""

    def _system(self, key, nmd=128, ml=1):
        nat = 4
        nph = 3 * nat
        dt = 0.4
        dyn = np.asarray(chain_dynmat(nph, 0.05))
        eta = np.eye(3) / 30.0
        bl = B.ebath(range(3), 330.0, dt, nmd, wmax=1.0, efric=eta,
                     dtype=jnp.float64)
        br = B.ebath(range(9, 12), 270.0, dt, nmd, wmax=1.0, efric=eta,
                     dtype=jnp.float64)
        ks = jax.random.split(key, 2)
        bl = bl.gnoi(ks[0]).replace(nevecs=None, nstd=None)
        br = br.gnoi(ks[1]).replace(nevecs=None, nstd=None)
        mask = np.ones(nph)
        mask[:1] = 0.0
        return make_system(dyn, [bl, br], dt, nmd, mask=mask)

    def test_fixed_point_is_periodic(self, key):
        """Running one full noise period FROM the computed attractor
        point returns exactly to it — the defining property, checked
        through the real integrator (not the Jacobian model)."""
        from sclmd_jax.md import (gle_step_jacobian, periodic_fixed_point,
                                  run_segment, state_ravel, state_unravel)

        system = self._system(key)
        nmd = system.nmd
        st0 = initial_state(system, dtype=jnp.float64)
        fin1, _ = run_segment(system, st0, nmd)
        A = gle_step_jacobian(system)
        x0 = periodic_fixed_point(A, state_ravel(fin1), nmd)
        stw = state_unravel(x0, system, dtype=jnp.float64)
        fin2, _ = run_segment(system, stw, nmd)
        np.testing.assert_allclose(state_ravel(fin2), x0,
                                   rtol=0, atol=1e-9 * np.abs(x0).max())

    def test_jacobian_matches_integrator(self, key):
        """A x equals one zero-noise step of the integrator from state
        x (the map is linear in the state)."""
        from sclmd_jax.md import (gle_step_jacobian, run_segment,
                                  state_ravel, state_unravel, vv_step)

        system = self._system(key)
        A = gle_step_jacobian(system)
        rng = np.random.default_rng(5)
        x = rng.normal(size=A.shape[0])
        st = state_unravel(x, system, dtype=jnp.float64)
        zsys = system.replace(baths=tuple(
            b.replace(noise=jnp.zeros_like(b.noise))
            for b in system.baths))
        new, _ = vv_step(zsys, st)
        np.testing.assert_allclose(state_ravel(new), A @ x, rtol=1e-10,
                                   atol=1e-12)

    def test_batched_fixed_point(self, key):
        """Batch axis: per-trajectory attractor points solved in one
        call match per-trajectory solves."""
        from sclmd_jax.md import gle_step_jacobian, periodic_fixed_point

        system = self._system(key)
        A = gle_step_jacobian(system)
        rng = np.random.default_rng(7)
        x1 = rng.normal(size=(3, A.shape[0]))
        xb = periodic_fixed_point(A, x1, system.nmd)
        for i in range(3):
            xi = periodic_fixed_point(A, x1[i], system.nmd)
            np.testing.assert_allclose(xb[i], xi, rtol=1e-12)


class TestStaleCheckpoint:
    def test_mismatched_checkpoint_rejected(self, tmp_path):
        r1 = TestWrapper()._build(tmp_path, nmd=64)
        r1.Run()
        # a differently-sized system in the same directory must refuse
        nat = 6
        axyz = [["C", 1.0 * i, 0.0, 0.0] for i in range(nat)]
        dyn = np.asarray(chain_dynmat(3 * nat, 0.05))
        r2 = md(0.4, 64, 300.0, axyz=axyz, dyn=dyn, nstop=1,
                dtype=jnp.float64, outdir=str(tmp_path))
        r2.AddBath(B.ebath(range(3), 300.0, 0.4, 64, wmax=1.0,
                           efric=np.eye(3) / 80.0, dtype=jnp.float64))
        with pytest.raises(ValueError, match="stale checkpoint"):
            r2.Run()

    def test_mismatched_nmd_rejected(self, tmp_path):
        r1 = TestWrapper()._build(tmp_path, nmd=64)
        r1.Run()
        r2 = TestWrapper()._build(tmp_path, nmd=128)
        with pytest.raises(ValueError, match="stale checkpoint"):
            r2.Run()
