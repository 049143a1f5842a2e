"""Blocked-convolution integrator equivalence (md.run_segment_blocked).

The blocked path must reproduce the plain scanned vv_step trajectories
to float64 summation-order tolerance, for every bath kind, across block
boundaries, and across checkpoint-style segment chaining."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sclmd_jax import baths as B
from sclmd_jax.md import (GLESystem, initial_state, run_segment,
                          run_segment_blocked)
from sclmd_jax.models.harmonic import chain_dynmat
from sclmd_jax.ops import noise as NZ


def _system(nph=24, nmd=128, ml=17, dt=0.4, with_ebath=True,
            local_right=False, seed=3):
    dyn = jnp.asarray(chain_dynmat(nph, 0.05))
    baths = []
    ncb = 4
    if with_ebath:
        eta = np.eye(ncb) / 60.0
        m = np.eye(ncb) * 2e-4
        eb = B.ebath(range(ncb), 320.0, dt, nmd, wmax=1.0, bias=0.1,
                     efric=eta, exim=m, exip=m, dtype=jnp.float64)
        baths.append(eb.gnoi_np(seed, dtype=np.float64)
                     .replace(nevecs=None, nstd=None))
    gwl = np.linspace(0.0, 0.6, 16)
    gam = np.array([np.eye(ncb) * 0.02 * np.exp(-(w / 0.3) ** 2)
                    for w in gwl])
    if local_right:
        pb = B.phbath(280.0, range(nph - ncb, nph), 0.3, 32, dt, nmd,
                      dtype=jnp.float64)
    else:
        pb = B.phbath(280.0, range(nph - ncb, nph), 0.3, 32, dt, nmd,
                      ml=ml, gamma=gam, gwl=gwl, dtype=jnp.float64)
    baths.append(pb.gnoi_np(seed + 1, dtype=np.float64)
                 .replace(nevecs=None, nstd=None))
    # a second non-local bath in the middle exercises multi-ring carry
    pb2 = B.phbath(300.0, range(10, 10 + ncb), 0.3, 32, dt, nmd,
                   ml=max(2, ml - 5), gamma=gam, gwl=gwl,
                   dtype=jnp.float64)
    baths.append(pb2.gnoi_np(seed + 2, dtype=np.float64)
                 .replace(nevecs=None, nstd=None))
    ml_sys = max(b.ml for b in baths)
    return GLESystem(dyn=dyn, baths=tuple(baths), mask=jnp.ones(nph),
                     dt=dt, nph=nph, ml=ml_sys, nmd=nmd)


def _assert_state_close(a, b, rtol=1e-9):
    np.testing.assert_allclose(np.asarray(a.p), np.asarray(b.p),
                               rtol=rtol, atol=1e-12)
    np.testing.assert_allclose(np.asarray(a.q), np.asarray(b.q),
                               rtol=rtol, atol=1e-12)
    np.testing.assert_allclose(np.asarray(a.qhis), np.asarray(b.qhis),
                               rtol=rtol, atol=1e-12)
    assert int(a.t) == int(b.t)


class TestBlockedEquivalence:
    @pytest.mark.parametrize("block", [4, 8, 32, 64])
    def test_matches_plain(self, block):
        system = _system()
        st = initial_state(system, dtype=jnp.float64)
        f_ref, ys_ref = run_segment(system, st, 64)
        f_blk, ys_blk = run_segment_blocked(system, st, 64, block=block)
        _assert_state_close(f_blk, f_ref)
        np.testing.assert_allclose(np.asarray(ys_blk["cur"]),
                                   np.asarray(ys_ref["cur"]),
                                   rtol=1e-8, atol=1e-12)
        np.testing.assert_allclose(np.asarray(ys_blk["etot"]),
                                   np.asarray(ys_ref["etot"]),
                                   rtol=1e-9, atol=1e-12)

    @pytest.mark.parametrize("block", [8, 32])
    def test_unconstrained_carry_forward_matches(self, block):
        """unconstrained=True (force carry-forward, one potential eval
        per step) is BIT-equivalent to the two-eval path when the mask
        is all ones — same points, same float ops."""
        system = _system()
        st = initial_state(system, dtype=jnp.float64)
        f_ref, ys_ref = run_segment_blocked(system, st, 64, block=block)
        sysf = system.replace(unconstrained=True)
        f_fast, ys_fast = run_segment_blocked(sysf, st, 64, block=block)
        _assert_state_close(f_fast, f_ref, rtol=1e-13)
        np.testing.assert_allclose(np.asarray(ys_fast["cur"]),
                                   np.asarray(ys_ref["cur"]),
                                   rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(np.asarray(ys_fast["etot"]),
                                   np.asarray(ys_ref["etot"]),
                                   rtol=1e-13, atol=1e-15)

    def test_block_larger_than_kernel(self):
        # block (32) > ml (6): in-block taps dominate, O mostly zero-pad
        system = _system(ml=6)
        st = initial_state(system, dtype=jnp.float64)
        f_ref, ys_ref = run_segment(system, st, 64)
        f_blk, ys_blk = run_segment_blocked(system, st, 64, block=32)
        _assert_state_close(f_blk, f_ref)
        np.testing.assert_allclose(np.asarray(ys_blk["cur"]),
                                   np.asarray(ys_ref["cur"]),
                                   rtol=1e-8, atol=1e-12)

    def test_local_and_markovian_only(self):
        # no non-local bath: blocked path must reduce to the plain one
        system = _system(local_right=True, ml=1)
        system = system.replace(baths=system.baths[:2],
                                ml=max(b.ml for b in system.baths[:2]))
        st = initial_state(system, dtype=jnp.float64)
        f_ref, ys_ref = run_segment(system, st, 32)
        f_blk, ys_blk = run_segment_blocked(system, st, 32, block=8)
        _assert_state_close(f_blk, f_ref, rtol=1e-12)
        np.testing.assert_allclose(np.asarray(ys_blk["cur"]),
                                   np.asarray(ys_ref["cur"]), rtol=1e-12)

    def test_segment_chaining_and_resume(self):
        """Two blocked segments == one plain run, and a blocked segment
        resumed by the PLAIN integrator continues identically (the
        reconstructed phis is a valid vv_step history)."""
        system = _system(nmd=128)
        st = initial_state(system, dtype=jnp.float64)
        f_ref, ys_ref = run_segment(system, st, 96)
        f1, ys1 = run_segment_blocked(system, st, 32, t0=0, block=8)
        f2, ys2 = run_segment_blocked(system, f1, 32, t0=32, block=8)
        f3, ys3 = run_segment(system, f2, 32, t0=64)
        _assert_state_close(f3, f_ref, rtol=1e-8)
        cur = np.concatenate([np.asarray(ys1["cur"]),
                              np.asarray(ys2["cur"]),
                              np.asarray(ys3["cur"])])
        np.testing.assert_allclose(cur, np.asarray(ys_ref["cur"]),
                                   rtol=1e-7, atol=1e-12)

    def test_noise_wrap(self):
        # segment longer than nmd: the noise stream tiles identically
        system = _system(nmd=32)
        st = initial_state(system, dtype=jnp.float64)
        f_ref, ys_ref = run_segment(system, st, 64)
        f_blk, ys_blk = run_segment_blocked(system, st, 64, block=16)
        _assert_state_close(f_blk, f_ref, rtol=1e-8)

    def test_save_outputs(self):
        system = _system().replace(savep=True, saveq=True, savef=True)
        st = initial_state(system, dtype=jnp.float64)
        _, ys_ref = run_segment(system, st, 32)
        _, ys_blk = run_segment_blocked(system, st, 32, block=8)
        for k in ("ps", "qs", "f"):
            np.testing.assert_allclose(np.asarray(ys_blk[k]),
                                       np.asarray(ys_ref[k]),
                                       rtol=1e-8, atol=1e-12)

    def test_rejects_nonmultiple(self):
        system = _system()
        st = initial_state(system, dtype=jnp.float64)
        with pytest.raises(ValueError, match="multiple"):
            run_segment_blocked(system, st, 30, block=8)


class TestBlockedEnsemble:
    def test_vmapped_matches_per_trajectory(self, key):
        from sclmd_jax.parallel.ensemble import (ensemble_noise,
                                                 ensemble_run,
                                                 ensemble_states)
        system = _system()
        n = 3
        bsys = ensemble_noise(system, key, n)
        states = ensemble_states(bsys, n)
        f_blk, ys_blk = ensemble_run(bsys, states, 32, block=8)
        f_ref, ys_ref = ensemble_run(bsys, states, 32)
        np.testing.assert_allclose(np.asarray(f_blk.p),
                                   np.asarray(f_ref.p),
                                   rtol=1e-8, atol=1e-12)
        np.testing.assert_allclose(np.asarray(ys_blk["cur"]),
                                   np.asarray(ys_ref["cur"]),
                                   rtol=1e-7, atol=1e-12)


class TestWrapperBlock:
    def test_md_wrapper_block_matches_plain(self, tmp_path):
        """md(..., block=8) writes the same kappa/checkpoint outputs as
        the plain path (segments chained over npie)."""
        import jax
        from sclmd_jax.md import md

        def build(outdir, block):
            nat = 4
            axyz = [["C", 1.0 * i, 0.0, 0.0] for i in range(nat)]
            dyn = np.asarray(chain_dynmat(3 * nat, 0.05))
            r = md(0.4, 64, 300.0, axyz=axyz, dyn=dyn, nstop=1, npie=2,
                   dtype=jnp.float64, seed=11, outdir=str(outdir),
                   block=block)
            gwl = np.linspace(0.0, 0.6, 8)
            gam = np.array([np.eye(3) * 0.02] * 8)
            pb = B.phbath(300.0, range(3), 0.3, 16, 0.4, 64, ml=9,
                          gamma=gam, gwl=gwl, dtype=jnp.float64)
            r.AddBath(pb)
            return r

        d1, d2 = tmp_path / "plain", tmp_path / "blocked"
        d1.mkdir(); d2.mkdir()
        build(d1, None).Run()
        build(d2, 8).Run()
        k1 = (d1 / "kappa.300.bath0.run0.dat").read_text()
        k2 = (d2 / "kappa.300.bath0.run0.dat").read_text()
        v1 = float(k1.split()[2]); v2 = float(k2.split()[2])
        assert v1 == pytest.approx(v2, rel=1e-7)


class TestEnsembleCheckpoint:
    def _runner(self, outdir, seed=11, block=8):
        from sclmd_jax.md import md
        nat = 4
        axyz = [["C", 1.0 * i, 0.0, 0.0] for i in range(nat)]
        dyn = np.asarray(chain_dynmat(3 * nat, 0.05))
        r = md(0.4, 64, 300.0, axyz=axyz, dyn=dyn, nstop=1,
               dtype=jnp.float64, seed=seed, outdir=str(outdir),
               block=block)
        gwl = np.linspace(0.0, 0.6, 8)
        gam = np.array([np.eye(3) * 0.02] * 8)
        r.AddBath(B.phbath(310.0, range(3), 0.3, 16, 0.4, 64, ml=9,
                           gamma=gam, gwl=gwl, dtype=jnp.float64))
        r.AddBath(B.phbath(290.0, range(9, 12), 0.3, 16, 0.4, 64, ml=9,
                           gamma=gam, gwl=gwl, dtype=jnp.float64))
        return r

    def test_interrupted_ensemble_resumes_identically(self, tmp_path,
                                                      monkeypatch):
        """Kill the segmented ensemble after 2 of 4 segments; a resumed
        run (even with a different RNG seed — noise is persisted)
        reproduces the uninterrupted result exactly."""
        import sclmd_jax.parallel.ensemble as PE

        d1, d2 = tmp_path / "full", tmp_path / "cut"
        d1.mkdir(); d2.mkdir()
        means_a = self._runner(d1, seed=11).RunEnsemble(
            6, npie=4, checkpoint=True)

        orig = PE.ensemble_run
        calls = {"n": 0}

        def bomb(*a, **k):
            if calls["n"] >= 2:
                raise RuntimeError("killed mid-ensemble")
            calls["n"] += 1
            return orig(*a, **k)

        monkeypatch.setattr(PE, "ensemble_run", bomb)
        with pytest.raises(RuntimeError, match="killed"):
            self._runner(d2, seed=11).RunEnsemble(6, npie=4,
                                                  checkpoint=True)
        monkeypatch.setattr(PE, "ensemble_run", orig)
        assert (d2 / "MDE.npz").exists()
        means_b = self._runner(d2, seed=999).RunEnsemble(
            6, npie=4, checkpoint=True)
        np.testing.assert_allclose(means_b, means_a, rtol=1e-10)

    def test_interrupted_chunked_ensemble_resumes(self, tmp_path,
                                                  monkeypatch):
        """Memory-wall chunking + checkpointing: kill the run mid-way
        through the SECOND chunk; the resume skips the finished chunk,
        finishes the broken one from its persisted noise, and runs the
        rest — reproducing the uninterrupted chunked result exactly."""
        import sclmd_jax.parallel.ensemble as PE

        d1, d2 = tmp_path / "full", tmp_path / "cut"
        d1.mkdir(); d2.mkdir()
        means_a = self._runner(d1, seed=11).RunEnsemble(
            6, npie=2, chunk=2, checkpoint=True)

        orig = PE.ensemble_run
        calls = {"n": 0}

        def bomb(*a, **k):
            if calls["n"] >= 3:        # dies in chunk 1, segment 1
                raise RuntimeError("killed mid-ensemble")
            calls["n"] += 1
            return orig(*a, **k)

        monkeypatch.setattr(PE, "ensemble_run", bomb)
        with pytest.raises(RuntimeError, match="killed"):
            self._runner(d2, seed=11).RunEnsemble(
                6, npie=2, chunk=2, checkpoint=True)
        monkeypatch.setattr(PE, "ensemble_run", orig)
        ck = np.load(d2 / "MDE.npz")
        assert int(ck["ichunk"][0]) == 1
        means_b = self._runner(d2, seed=999).RunEnsemble(
            6, npie=2, chunk=2, checkpoint=True)
        np.testing.assert_allclose(means_b, means_a, rtol=1e-12)

    def test_stale_ensemble_checkpoint_rejected(self, tmp_path):
        self._runner(tmp_path, seed=1).RunEnsemble(4, npie=2,
                                                   checkpoint=True)
        with pytest.raises(ValueError, match="stale"):
            self._runner(tmp_path, seed=1).RunEnsemble(8, npie=2,
                                                       checkpoint=True)

    def test_segmented_matches_single_segment(self, tmp_path):
        d1, d2 = tmp_path / "one", tmp_path / "four"
        d1.mkdir(); d2.mkdir()
        m1 = self._runner(d1, seed=5).RunEnsemble(4)
        m4 = self._runner(d2, seed=5).RunEnsemble(4, npie=4)
        np.testing.assert_allclose(m4, m1, rtol=1e-9)
