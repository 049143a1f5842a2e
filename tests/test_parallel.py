"""Sharded ensemble tests on the 8-device virtual CPU mesh."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sclmd_jax import baths as B
from sclmd_jax.md import GLESystem, initial_state, run_segment
from sclmd_jax.models.harmonic import chain_dynmat
from sclmd_jax.parallel.ensemble import (ensemble_noise, ensemble_run,
                                         ensemble_states, make_mesh,
                                         shard_ensemble)


def _small_system(nph=12, nmd=32, dt=0.4):
    dyn = jnp.asarray(chain_dynmat(nph, 0.05))
    eta = np.eye(2) / 60.0
    ebl = B.ebath([0, 1], 330.0, dt, nmd, wmax=1.0, efric=eta,
                  dtype=jnp.float64)
    ebr = B.ebath([nph - 2, nph - 1], 270.0, dt, nmd, wmax=1.0, efric=eta,
                  dtype=jnp.float64)
    return GLESystem(dyn=dyn, baths=(ebl, ebr), mask=jnp.ones(nph),
                     dt=dt, nph=nph, ml=1, nmd=nmd)


def test_ensemble_matches_sequential(key):
    system = _small_system()
    n = 4
    bsys = ensemble_noise(system, key, n)
    states = ensemble_states(bsys, n)
    finals, ys = ensemble_run(bsys, states, 16)
    assert ys["cur"].shape == (n, 16, 2)
    # trajectory 2 must equal a sequential run with the same noise
    seq_sys = system.replace(baths=tuple(
        b.replace(noise=bb.noise[2])
        for b, bb in zip(system.baths, bsys.baths)))
    f2, ys2 = run_segment(seq_sys, initial_state(seq_sys,
                                                 dtype=jnp.float64), 16)
    np.testing.assert_allclose(np.asarray(finals.p[2]), np.asarray(f2.p),
                               rtol=1e-12)
    np.testing.assert_allclose(np.asarray(ys["cur"][2]),
                               np.asarray(ys2["cur"]), rtol=1e-12)


def test_trajectories_differ(key):
    system = _small_system()
    bsys = ensemble_noise(system, key, 3)
    states = ensemble_states(bsys, 3)
    finals, _ = ensemble_run(bsys, states, 16)
    assert not np.allclose(np.asarray(finals.p[0]), np.asarray(finals.p[1]))


@pytest.mark.parametrize("tp", [None, "tp"])
def test_sharded_run_matches_unsharded(key, tp):
    n_dev = len(jax.devices())
    assert n_dev == 8, "conftest should provide 8 virtual CPU devices"
    mesh = make_mesh({"dp": 4, "tp": 2}) if tp else make_mesh({"dp": 8})
    system = _small_system()
    n = 8
    bsys = ensemble_noise(system, key, n)
    states = ensemble_states(bsys, n)
    f_ref, ys_ref = ensemble_run(bsys, states, 12)
    ssys, sstates = shard_ensemble(mesh, bsys, states, dp="dp", tp=tp)
    with mesh:
        f_sh, ys_sh = ensemble_run(ssys, sstates, 12)
    np.testing.assert_allclose(np.asarray(f_sh.p), np.asarray(f_ref.p),
                               rtol=1e-10)
    np.testing.assert_allclose(np.asarray(ys_sh["cur"]),
                               np.asarray(ys_ref["cur"]), rtol=1e-10)


def test_graft_dryrun():
    import __graft_entry__ as ge
    ge._dryrun_impl(8)


def test_graft_dryrun_driver_path():
    """The driver's actual call path: a fresh process WITHOUT the conftest
    rewiring or any virtual-device env, where jax would default to the
    real backend. dryrun_multichip must self-configure the virtual CPU
    mesh (round-1 MULTICHIP failure mode)."""
    import os
    import subprocess
    import sys

    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["XLA_FLAGS"] = ""  # simulate the driver env: no virtual devices
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = "import __graft_entry__ as g; g.dryrun_multichip(8)"
    r = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, f"rc={r.returncode}\n{r.stderr[-3000:]}"
    assert "dryrun_multichip OK" in r.stdout
    assert "output sharded over 8 devices" in r.stdout


def test_graft_entry_compiles():
    import __graft_entry__ as ge
    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    assert np.isfinite(np.asarray(out[0])).all()


@pytest.mark.parametrize("tp", [None, "tp"])
def test_sharded_blocked_matches_unsharded(key, tp):
    """The blocked fast path under dp(+tp) sharding == unsharded."""
    mesh = make_mesh({"dp": 4, "tp": 2}) if tp else make_mesh({"dp": 8})
    system = _small_system(nph=16, nmd=32)
    # add a non-local bath so the blocked machinery engages
    gwl = np.linspace(0.0, 0.6, 8)
    gam = np.array([np.eye(2) * 0.02] * 8)
    pb = B.phbath(290.0, [7, 8], 0.3, 16, system.dt, system.nmd, ml=6,
                  gamma=gam, gwl=gwl, dtype=jnp.float64)
    system = system.replace(baths=system.baths + (pb,), ml=6)
    n = 8
    bsys = ensemble_noise(system, key, n)
    states = ensemble_states(bsys, n)
    f_ref, ys_ref = ensemble_run(bsys, states, 12, block=4)
    ssys, sstates = shard_ensemble(mesh, bsys, states, dp="dp", tp=tp)
    with mesh:
        f_sh, ys_sh = ensemble_run(ssys, sstates, 12, block=4)
    np.testing.assert_allclose(np.asarray(f_sh.p), np.asarray(f_ref.p),
                               rtol=1e-10)
    np.testing.assert_allclose(np.asarray(ys_sh["cur"]),
                               np.asarray(ys_ref["cur"]), rtol=1e-10)


def test_sharded_manybody_force_matches_unsharded(key):
    """A many-body (CHDriver) force inside the vmapped integrator
    partitions over a dp mesh with bit-identical results — the
    flagship-class workload's multi-chip path."""
    from sclmd_jax import baths as B
    from sclmd_jax.md import GLESystem
    from tests.test_hydrocarbon import benzene
    from sclmd_jax.models.hydrocarbon import CHDriver

    axyz = benzene()
    drv = CHDriver(axyz)
    nph = 3 * len(axyz)
    dt, nmd = 0.4, 32
    eta = np.eye(6) / 80.0
    ebl = B.ebath(range(6), 330.0, dt, nmd, wmax=1.0, efric=eta,
                  dtype=jnp.float64)
    ebr = B.ebath(range(nph - 6, nph), 270.0, dt, nmd, wmax=1.0,
                  efric=eta, dtype=jnp.float64)
    system = GLESystem(dyn=None, baths=(ebl, ebr),
                       mask=jnp.ones(nph, jnp.float64), dt=dt, nph=nph,
                       ml=1, nmd=nmd, force_fn=drv.force_jax)
    n = 8
    bsys = ensemble_noise(system, key, n)
    states = ensemble_states(bsys, n, dtype=jnp.float64)
    f_ref, ys_ref = ensemble_run(bsys, states, 16)
    mesh = make_mesh({"dp": 8})
    ssys, sstates = shard_ensemble(mesh, bsys, states, dp="dp")
    with mesh:
        f_sh, ys_sh = ensemble_run(ssys, sstates, 16)
    np.testing.assert_allclose(np.asarray(f_sh.p), np.asarray(f_ref.p),
                               rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(np.asarray(ys_sh["cur"]),
                               np.asarray(ys_ref["cur"]),
                               rtol=1e-8, atol=1e-12)
    assert len(f_sh.p.sharding.device_set) == 8


class TestShardedSynthesis:
    """SP/CP row: shard-local noise synthesis + time-windowed streaming
    (parallel.ensemble.sharded_synthesis_run)."""

    def _factored(self, nmd=32):
        system = _small_system(nmd=nmd)
        return system.replace(baths=tuple(
            b.prepare_noise() for b in system.baths))

    def test_sharded_synthesis_matches_unsharded(self, key):
        from sclmd_jax.parallel.ensemble import sharded_synthesis_run

        mesh = make_mesh({"dp": 8})
        sysf = self._factored()
        n = 16
        bsys = ensemble_noise(sysf, key, n)
        states = ensemble_states(bsys, n)
        finals, ys = ensemble_run(bsys, states, 32)
        csum_ref = np.asarray(ys["cur"][:, 8:, :].sum(axis=1))

        st0 = ensemble_states(sysf, n)
        fin2, csum, probe = sharded_synthesis_run(
            mesh, sysf, st0, key, n, 32, equil_frac=0.25,
            return_noise_probe=True)
        np.testing.assert_allclose(np.asarray(csum), csum_ref,
                                   rtol=1e-10)
        np.testing.assert_allclose(np.asarray(fin2.p),
                                   np.asarray(finals.p), rtol=1e-10)
        # per-shard residency: each device holds ONLY its n/8
        # trajectories' noise (synthesized locally from its key slice)
        for i, arr in enumerate(probe):
            shards = arr.addressable_shards
            assert len(shards) == 8
            assert all(s.data.shape[0] == n // 8 for s in shards)
            np.testing.assert_allclose(
                np.asarray(arr),
                np.asarray(bsys.baths[i].noise[:, 0, :]), rtol=1e-10)

    def test_windowed_streaming_matches_full(self, key):
        """noise_window streams the TIME axis: windowed trajectories
        reproduce the full-noise run to roundoff (same draws, exact
        window sampler)."""
        from sclmd_jax.parallel.ensemble import sharded_synthesis_run

        mesh = make_mesh({"dp": 4})
        sysf = self._factored(nmd=64)
        n = 8
        st0 = ensemble_states(sysf, n)
        fin_a, csum_a = sharded_synthesis_run(
            mesh, sysf, st0, key, n, 64, dp="dp", equil_frac=0.25)
        fin_b, csum_b = sharded_synthesis_run(
            mesh, sysf, st0, key, n, 64, dp="dp", equil_frac=0.25,
            noise_window=16)
        np.testing.assert_allclose(np.asarray(csum_b),
                                   np.asarray(csum_a), rtol=1e-9)
        np.testing.assert_allclose(np.asarray(fin_b.p),
                                   np.asarray(fin_a.p), rtol=1e-9,
                                   atol=1e-12)

    def test_windowed_blocked_integrator(self, key):
        """Windowed streaming composes with the blocked fast path and a
        nonzero segment offset."""
        from sclmd_jax.parallel.ensemble import sharded_synthesis_run

        mesh = make_mesh({"dp": 4})
        sysf = self._factored(nmd=64)
        n = 8
        st0 = ensemble_states(sysf, n)
        fin_a, csum_a = sharded_synthesis_run(
            mesh, sysf, st0, key, n, 32, t0=16, block=8)
        fin_b, csum_b = sharded_synthesis_run(
            mesh, sysf, st0, key, n, 32, t0=16, block=8,
            noise_window=16)
        np.testing.assert_allclose(np.asarray(csum_b),
                                   np.asarray(csum_a), rtol=1e-9,
                                   atol=1e-14)
        np.testing.assert_allclose(np.asarray(fin_b.p),
                                   np.asarray(fin_a.p), rtol=1e-9,
                                   atol=1e-12)
