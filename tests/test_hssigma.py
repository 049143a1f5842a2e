"""Tests for the HSSigma real-space self-energy extraction."""

import numpy as np
import pytest

from sclmd_jax.postprocess import hssigma as HSX
from sclmd_jax.postprocess.lambda_pipeline import LambdaPipeline, \
    fft_order_grid


def _model(rng, n=5, nk=3, ne=6):
    E = np.linspace(-1.0, 1.0, ne)
    ks = np.linspace(0, np.pi, nk, endpoint=False)
    wk = np.full(nk, 1.0 / nk)
    h0 = rng.normal(size=(n, n)); h0 = (h0 + h0.T) / 2
    t = rng.normal(size=(n, n)) * 0.2
    Hk = np.array([h0 + np.cos(k) * (t + t.T) / 2 for k in ks],
                  dtype=complex)
    Sk = np.broadcast_to(np.eye(n, dtype=complex), (nk, n, n)).copy()
    gl = np.zeros((n, n)); gl[0, 0] = 0.6
    gr = np.zeros((n, n)); gr[-1, -1] = 0.6
    SigLk = np.broadcast_to(-0.5j * gl, (ne, nk, n, n)).astype(complex)
    SigRk = np.broadcast_to(-0.5j * gr, (ne, nk, n, n)).astype(complex)
    return E, ks, wk, Hk, Sk, SigLk, SigRk


class TestExpand:
    def test_pivoted_scatter(self, rng):
        npv, n = 2, 5
        sfe = rng.normal(size=(npv, npv)) + 1j * rng.normal(size=(npv, npv))
        pivot = np.array([3, 1])
        full = HSX.expand_pivoted_sigma(sfe, pivot, n)
        assert full.shape == (n, n)
        np.testing.assert_allclose(full[3, 3], sfe[0, 0])
        np.testing.assert_allclose(full[3, 1], sfe[0, 1])
        np.testing.assert_allclose(full[1, 3], sfe[1, 0])
        assert full[0, 0] == 0

    def test_batched(self, rng):
        sfe = rng.normal(size=(4, 2, 2)).astype(complex)
        full = HSX.expand_pivoted_sigma(sfe, np.array([0, 2]), 3)
        assert full.shape == (4, 3, 3)
        np.testing.assert_allclose(full[2][0, 2], sfe[2][0, 1])


class TestKAverage:
    def test_single_kpoint_roundtrip(self, rng):
        """With one symmetric k-point, back-extraction recovers the
        input self-energies exactly."""
        E, ks, wk, Hk, Sk, SigLk, SigRk = _model(rng, nk=1)
        res = HSX.kaverage_extract(Hk, Sk, SigLk, SigRk, E, wk)
        np.testing.assert_allclose(res["SigmaL"], SigLk[:, 0], atol=1e-8)
        np.testing.assert_allclose(res["SigmaR"], SigRk[:, 0], atol=1e-8)

    def test_transmission_consistency(self, rng):
        E, ks, wk, Hk, Sk, SigLk, SigRk = _model(rng, nk=1)
        res = HSX.kaverage_extract(Hk, Sk, SigLk, SigRk, E, wk)
        # with one k-point, real-space T equals the k-resolved T
        np.testing.assert_allclose(res["T_rs"], res["T_k"][:, 0],
                                   rtol=1e-6, atol=1e-9)
        assert (res["T_k"] > -1e-10).all()

    def test_kaverage_hermitian_structure(self, rng):
        E, ks, wk, Hk, Sk, SigLk, SigRk = _model(rng, nk=3)
        res = HSX.kaverage_extract(Hk, Sk, SigLk, SigRk, E, wk)
        # averaged Sigma retarded: Im part negative semidefinite-ish on
        # the lead orbitals
        gam = 1j * (res["SigmaL"] - np.conjugate(
            np.swapaxes(res["SigmaL"], 1, 2)))
        ev = np.linalg.eigvalsh(gam)
        assert ev.min() > -1e-6

    def test_roundtrip_into_lambda_pipeline(self, rng, tmp_path):
        """hssigma output feeds the Lambda pipeline end-to-end (the
        reference workflow hssigma.py -> lambda.py)."""
        n = 5
        E, ks, wk, Hk, Sk, SigLk, SigRk = _model(rng, n=n, nk=2, ne=8)
        res = HSX.kaverage_extract(Hk, Sk, SigLk, SigRk, E, wk)
        out = str(tmp_path / "HSSigmaMEAN.npz")
        HSX.write_hssigma_mean(out, E, res)
        E2, H, S, S1, S2 = HSX.read_hssigma_mean(out)
        assert len(E2) == len(E) // 2 * 2
        nm = 2
        m = rng.normal(size=(nm, n, n))
        M = np.array([(mi + mi.T) / 2 for mi in m], dtype=complex)
        hw = np.array([0.05, 0.1])
        pl = LambdaPipeline(H, S, E2, S1, S2, M, hw)
        wb = pl.wideband(hwcut=1.0, mu0=0.0)
        assert np.isfinite(wb["eta"]).all()
        np.testing.assert_allclose(wb["eta"], wb["eta"].T, atol=1e-8)


class TestFileWorkflow:
    """The reference's RunName workflow file-to-file (hssigma.py:12-17,
    134-418) on the npz backends (sisl/netCDF4 are gated out of this
    image; the converter one-liners are documented in the readers)."""

    def _write_run(self, rng, tmp_path, runname="Dev"):
        # 4 atoms x 2 orbitals: atoms 2-3 are the device (1-based)
        nk, ne, norb = 2, 3, 2
        na = 4
        lasto = np.arange(1, na + 1) * norb          # 1-based orbital ends
        a_dev = np.array([2, 3])
        n_full = na * norb
        ens = np.linspace(-0.05, 0.05, ne)           # Ry
        kpts = np.zeros((nk, 3)); kpts[1, 0] = 0.5
        wkpt = np.full(nk, 0.5)
        npv = 2
        pvl = np.array([3, 4])                       # 1-based full-space
        pvr = np.array([5, 6])
        sig = rng.normal(size=(nk, ne, npv, npv)) * 0.05
        sigi = -np.abs(rng.normal(size=(nk, ne, npv, npv))) * 0.05
        np.savez(tmp_path / f"{runname}.TBT.SE.npz",
                 Left_pivot=pvl, Right_pivot=pvr,
                 Left_ReSelfEnergy=sig, Left_ImSelfEnergy=sigi,
                 Right_ReSelfEnergy=sig[::-1], Right_ImSelfEnergy=sigi,
                 lasto=lasto, a_dev=a_dev, kpt=kpts, wkpt=wkpt, E=ens)
        h0 = rng.normal(size=(n_full, n_full))
        h0 = (h0 + h0.T) / 2
        Hk = np.stack([h0 + 0.1 * ik * np.eye(n_full)
                       for ik in range(nk)]).astype(complex)
        Sk = np.broadcast_to(np.eye(n_full, dtype=complex),
                             (nk, n_full, n_full)).copy()
        np.savez(tmp_path / f"{runname}.HSk.npz", Hk=Hk, Sk=Sk)
        return runname

    def test_main_end_to_end(self, rng, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        runname = self._write_run(rng, tmp_path)
        res = HSX.hssigma_main(runname, eta=1e-3)
        # device window: atoms 2..3 -> orbitals 2..6 (0-based [2, 6))
        nos = 4
        assert res["SigmaL"].shape[-2:] == (nos, nos)
        assert (tmp_path / f"{runname}.HSSigmaMEAN.npz").exists()
        assert (tmp_path / "Trans.realspace.dat").exists()
        lines = (tmp_path / "Trans.realspace.dat").read_text().splitlines()
        assert len(lines) == 2 + 3                  # header + ne rows
        # output readable by the Lambda pipeline reader (readHS path)
        E, H, S, S1, S2 = HSX.read_hssigma_mean(
            str(tmp_path / f"{runname}.HSSigmaMEAN.npz"))
        assert H.shape == (nos, nos)
        assert np.isfinite(S1).all()

    def test_se_reader_units_and_window(self, rng, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        runname = self._write_run(rng, tmp_path)
        se = HSX.read_tbt_se(runname + ".TBT.SE.nc")
        # Ry -> eV on energies and self-energies (hssigma.py:21,135,245)
        d = np.load(tmp_path / f"{runname}.TBT.SE.npz")
        np.testing.assert_allclose(se["E"], d["E"] * 13.6058)
        np.testing.assert_allclose(
            se["SigL"][0, 1].real, d["Left_ReSelfEnergy"][1, 0] * 13.6058)
        # device orbital window: atoms 2..3 of 2 orbitals -> [2, 6)
        assert (se["iod1"], se["iod2"]) == (2, 6)
        # pivots are 0-based after reading
        np.testing.assert_array_equal(se["pvl"], [2, 3])

    def test_read_xv(self, tmp_path):
        bohr = 0.529177
        text = ("  10.0 0.0 0.0\n  0.0 10.0 0.0\n  0.0 0.0 10.0\n"
                "  2\n"
                "  1  6  0.0 0.0 0.0  0.0 0.0 0.0\n"
                "  1  6  2.0 0.0 0.0  0.0 0.0 0.0\n")
        (tmp_path / "Dev.XV").write_text(text)
        g = HSX.read_xv(str(tmp_path / "Dev.XV"))
        assert g["anr"].tolist() == [6, 6]
        np.testing.assert_allclose(g["xyz"][1, 0], 2.0 * bohr)
        np.testing.assert_allclose(g["cell"][0, 0], 10.0 * bohr)
