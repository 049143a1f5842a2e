"""Tests for the analysis utilities (sclmd_jax.utils.tools)."""

import numpy as np
import pytest

from sclmd_jax.utils import tools as T


def _write_kappa(tmpdir, values, temp=300):
    """values: (bathnum, nrun)"""
    for i, row in enumerate(values):
        for j, v in enumerate(row):
            p = tmpdir / f"kappa.{temp}.bath{i}.run{j}.dat"
            p.write_text(f"{j} {float(temp)}    {v} \n")


class TestKappaAggregation:
    def test_calHF(self, tmp_path):
        vals = np.array([[1.0, 2.0, 3.0], [-1.0, -2.0, -3.0]])
        _write_kappa(tmp_path, vals)
        out = T.calHF(dlist=1, bathnum=2, workdir=str(tmp_path))
        # dlist=1 drops run0; running mean of [2,3] = [2, 2.5]
        np.testing.assert_allclose(out[0], [2.0, 2.5])
        assert (tmp_path / "heatflux.300.dat").exists()

    def test_calTC_two_bath(self, tmp_path):
        vals = np.array([[5.0, 4.0, 6.0], [-5.0, -4.0, -6.0]])
        _write_kappa(tmp_path, vals)
        res = T.calTC(delta=0.1, dlist=1, bathnum=2, workdir=str(tmp_path))
        # kappa = (J0 - J1)/2/(0.1*300) on runs 1,2: (4+4)/2/30, (6+6)/2/30
        want = np.array([8.0, 12.0]) / 2 / 30.0
        np.testing.assert_allclose(res["conductance"][0], want.mean())
        np.testing.assert_allclose(res["flux"][0], np.array([4.0, 6.0]).mean())
        assert (tmp_path / "thermalconductance.300.dat").exists()

    def test_calTC_three_bath(self, tmp_path):
        vals = np.array([[2.0, 2.0], [2.0, 2.0], [-4.0, -4.0]])
        _write_kappa(tmp_path, vals)
        res = T.calTC(delta=0.1, dlist=0, bathnum=3, workdir=str(tmp_path))
        np.testing.assert_allclose(res["conductance"][0],
                                   (2 + 2 + 4) / 4 / (0.1 * 300))

    def test_conductivity(self, tmp_path):
        vals = np.array([[3.0, 3.0], [-3.0, -3.0]])
        _write_kappa(tmp_path, vals)
        res = T.calTC(delta=0.1, dlist=0, bathnum=2, L=10.0, A=5.0,
                      workdir=str(tmp_path))
        np.testing.assert_allclose(res["conductivity"][0],
                                   res["conductance"][0] * 10.0 / 5.0 * 10)


class TestEff:
    def test_removes_negative_modes(self, tmp_path, rng):
        n = 6
        a = rng.normal(size=(n, n))
        d = (a + a.T) / 2  # indefinite
        np.savetxt(tmp_path / "dynmat.dat", d.flatten()[:, None] if False
                   else d)
        out = T.eff("dynmat.dat", workdir=str(tmp_path))
        assert (np.linalg.eigvalsh(out) >= -1e-10).all()
        assert (tmp_path / "moddynmat.dat").exists()


class TestAniAnalytics:
    def _write_ani(self, path, frames, forces=None):
        with open(path, "w") as fh:
            for t, xyz in enumerate(frames):
                fh.write(f"{len(xyz)}\n{t}\n")
                for i, r in enumerate(xyz):
                    line = f"C    {r[0]}   {r[1]}   {r[2]}"
                    if forces is not None:
                        fr = forces[t][i]
                        line += f"   {fr[0]}   {fr[1]}   {fr[2]}"
                    fh.write(line + "\n")

    def test_read_and_average(self, tmp_path, rng):
        frames = rng.normal(size=(5, 3, 3))
        self._write_ani(tmp_path / "t0.ani", frames)
        els, pos, frc = T.read_ani(str(tmp_path / "t0.ani"))
        assert els == ["C"] * 3
        np.testing.assert_allclose(pos, frames, rtol=1e-6)
        ave = T.dumpavetraj(["t0.ani"], workdir=str(tmp_path))
        np.testing.assert_allclose(ave, frames.mean(axis=0), rtol=1e-6)

    def test_dumpdisp(self, tmp_path, rng):
        ref = np.zeros((2, 3))
        frames = np.stack([ref + 0.1, ref + 5.0, ref + 1.0])
        self._write_ani(tmp_path / "t.ani", frames)
        out = T.dumpdisp(ref, ["t.ani"], index=[1], workdir=str(tmp_path))
        np.testing.assert_allclose(out[0], ref + 5.0, rtol=1e-6)

    def test_avdf(self, tmp_path, rng):
        d = rng.normal(size=(10, 4))
        np.save(tmp_path / "deltaforce.run0.npy", d)
        T.avdf(["deltaforce.run0.npy"], workdir=str(tmp_path))
        mean = np.loadtxt(tmp_path / "deltaforce-mean0.dat")
        np.testing.assert_allclose(mean, d.mean(axis=0), rtol=1e-6)


class TestNNPDataPrep:
    def test_prepare_nnp_data(self, tmp_path):
        import jax.numpy as jnp
        from sclmd_jax.models.harmonic import chain_dynmat
        from sclmd_jax.models.driver import JaxDriver
        from sclmd_jax.models import pair as P

        axyz = [["C", 1.5 * i, 0.0, 0.0] for i in range(4)]
        x0 = np.array([a[1:] for a in axyz])
        pairs = P.neighbor_pairs(x0, 4.0)
        efn = P.morse_energy(2.0, 1.8, 1.5, 4.0, pairs)
        drv = JaxDriver(efn, axyz, dtype=jnp.float64)
        data = T.prepare_nnp_data(drv, nframes=8, outfile="train.npz",
                                  workdir=str(tmp_path))
        assert data["x"].shape == (8, 4, 3)
        assert data["f"].shape == (8, 4, 3)
        assert np.isfinite(data["e"]).all()
        loaded = np.load(tmp_path / "train.npz")
        np.testing.assert_allclose(loaded["e"], data["e"])

    def test_visualtrain(self, tmp_path):
        pytest.importorskip("matplotlib")
        p = tmp_path / "lcurve.out"
        p.write_text("step loss_e loss_f\n0 1.0 2.0\n10 0.5 1.0\n")
        out = T.visualtrain("lcurve.out", workdir=str(tmp_path))
        import os
        assert os.path.exists(out)
