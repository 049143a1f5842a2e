"""Tests for the typed config layer and profiling utilities."""

import numpy as np
import pytest

import jax.numpy as jnp

from sclmd_jax.utils.config import BathConfig, MDConfig
from sclmd_jax.utils.profiling import Tracer, flops_estimate_gle_step


class TestConfig:
    def _cfg(self, **kw):
        base = dict(dt=0.4, nmd=64, T=300.0, nstop=1,
                    baths=[BathConfig(kind="electron", cats=list(range(3)),
                                      T=300.0, wmax=1.0,
                                      efric_scale=0.01)])
        base.update(kw)
        return MDConfig(**base)

    def test_roundtrip_json(self, tmp_path):
        cfg = self._cfg()
        p = tmp_path / "run.json"
        cfg.to_json(str(p))
        cfg2 = MDConfig.from_json(str(p))
        assert cfg2.dt == cfg.dt
        assert cfg2.baths[0].kind == "electron"
        assert cfg2.baths[0].efric_scale == 0.01

    def test_validation_errors(self):
        with pytest.raises(ValueError):
            self._cfg(dt=-1).validate()
        with pytest.raises(ValueError):
            self._cfg(nmd=65, npie=2).validate()
        with pytest.raises(ValueError):
            MDConfig(dt=0.4, nmd=64, T=300.0, baths=[
                BathConfig(kind="electron", cats=[0], T=300.0)
            ]).validate()
        with pytest.raises(ValueError):
            BathConfig(kind="weird", cats=[0], T=300.0).validate()

    def test_build_and_run(self, tmp_path):
        from sclmd_jax.models.harmonic import chain_dynmat
        cfg = self._cfg(outdir=str(tmp_path), dtype="float64",
                        constraints=[[9, 10, 11]])
        nat = 4
        axyz = [["C", 1.5 * i, 0, 0] for i in range(nat)]
        runner = cfg.build(axyz=axyz,
                           dyn=np.asarray(chain_dynmat(3 * nat, 0.05)))
        assert len(runner.baths) == 1
        runner.Run()
        assert (tmp_path / "kappa.300.bath0.run0.dat").exists()
        assert np.allclose(np.asarray(runner.state.q)[9:12], 0.0)

    def test_build_named_driver(self, tmp_path):
        """driver="sw" constructs the model from axyz and derives the
        dynamical matrix automatically; the run produces currents."""
        from sclmd_jax.models.sw import diamond_cell

        pos, cell = diamond_cell(1, 1, 2)
        axyz = [["Si"] + list(p) for p in pos]
        n = 3 * len(axyz)
        cfg = MDConfig(dt=0.4, nmd=32, T=100.0, dtype="float64",
                       outdir=str(tmp_path), driver="sw",
                       driver_kwargs={"cell": cell},
                       baths=[BathConfig(kind="electron",
                                         cats=list(range(6)), T=100.0,
                                         wmax=1.0, efric_scale=0.01)])
        runner = cfg.build(axyz=axyz)
        assert runner.pforce is not None
        assert runner.dyn is not None and runner.dyn.shape == (n, n)
        runner.Run()
        assert (tmp_path / "kappa.100.bath0.run0.dat").exists()

    def test_unknown_driver_rejected(self):
        with pytest.raises(ValueError):
            MDConfig(dt=0.4, nmd=32, T=100.0, driver="rebo").validate()

    def test_build_with_lambda_file(self, tmp_path, rng):
        from sclmd_jax.utils.io import WritewbLambda
        n = 3
        eta = np.eye(n) * 0.02
        z = np.zeros((n, n))
        f = str(tmp_path / "wb.npz")
        WritewbLambda(f, eta, z, z, z, z)
        cfg = MDConfig(dt=0.4, nmd=32, T=300.0, outdir=str(tmp_path),
                       baths=[BathConfig(kind="electron", cats=[0, 1, 2],
                                         T=300.0, wmax=1.0, bias=0.5,
                                         matrices_file=f)])
        runner = cfg.build(axyz=[["C", i, 0, 0] for i in range(1)],
                           dyn=np.eye(3) * 0.01)
        np.testing.assert_allclose(np.asarray(runner.baths[0].efric), eta)

    def test_phonon_bath_config(self, tmp_path):
        cfg = MDConfig(dt=0.4, nmd=32, T=200.0, outdir=str(tmp_path),
                       baths=[BathConfig(kind="phonon", cats=[0, 1],
                                         T=200.0, debye=0.1, nw=20)])
        runner = cfg.build(dyn=np.eye(2) * 0.01,
                           axyz=None)
        assert runner.baths[0].local


class TestProfiling:
    def test_tracer_sections(self):
        tr = Tracer()
        with tr.section("outer"):
            with tr.section("inner"):
                sum(range(1000))
        with tr.section("outer"):
            pass
        assert tr.stats["outer"][0] == 2
        assert tr.stats["outer/inner"][0] == 1
        rep = tr.report()
        assert "outer/inner" in rep
        js = tr.to_json()
        assert "outer" in js

    def test_wrap_traces_device_fn(self):
        import jax
        tr = Tracer()
        f = tr.wrap("matmul", jax.jit(lambda x: x @ x))
        x = jnp.ones((16, 16))
        f(x)
        f(x)
        assert tr.stats["matmul"][0] == 2
        assert tr.stats["matmul"][1] > 0

    def test_flops_model(self):
        est = flops_estimate_gle_step(300, 2, 90, 1000)
        assert est["kernel_bytes"] == 2 * 1000 * 90 * 90 * 4
        assert est["flops"] > 0
