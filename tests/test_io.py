"""Tests for the artifact IO layer (utils/io.py) on the npz backend."""

import numpy as np
import pytest

from sclmd_jax.utils import io as MIO


class TestEPH:
    def test_write_read_roundtrip(self, tmp_path, rng):
        nw, nph, ns = 5, 6, 4
        wl = np.linspace(0, 1, nw)
        hw = rng.random(nph)
        U = rng.normal(size=(nph, nph))
        dyn = rng.normal(size=(nph, nph))
        sigl = rng.normal(size=(nw, ns, ns)) + 1j * rng.normal(size=(nw, ns, ns))
        sigr = rng.normal(size=(nw, ns, ns)) + 1j * rng.normal(size=(nw, ns, ns))
        fr = rng.normal(size=(nph, nph))
        path = str(tmp_path / "eph.npz")
        MIO.WriteEPHNCfile(path, wl, hw, U, dyn, sigl, sigr, fr, fr, fr,
                           fr, fr)
        eph = MIO.ReadNewEPHNCFile(path)
        np.testing.assert_allclose(eph.wl, wl)
        np.testing.assert_allclose(eph.SigL, sigl)
        np.testing.assert_allclose(eph.SigR, sigr)
        np.testing.assert_allclose(eph.efric, fr)
        np.testing.assert_allclose(eph.zeta1, fr)

    def test_read_sig(self, tmp_path, rng):
        nw, ns = 3, 2
        sig = rng.normal(size=(nw, ns, ns)) + 1j * rng.normal(size=(nw, ns, ns))
        np.savez(tmp_path / "sig.npz", Wlist=np.arange(nw),
                 ReSigL=sig.real, ImSigL=sig.imag,
                 ReSigR=sig.real, ImSigR=sig.imag)
        out = MIO.ReadSig(str(tmp_path / "sig.npz"))
        np.testing.assert_allclose(out.SigL, sig)


class TestDynmat:
    def test_read_dynmat_reconstruction(self, tmp_path, rng):
        nph = 6
        hw = np.abs(rng.random(nph)) + 0.1
        q, _ = np.linalg.qr(rng.normal(size=(nph, nph)))
        U = q.T
        np.savez(tmp_path / "dev.npz", hw=hw, U=U)
        dyn, U2, hw2 = MIO.ReadDynmat(str(tmp_path / "dev.npz"))
        want = U.T @ np.diag(hw ** 2) @ U
        np.testing.assert_allclose(dyn, (want + want.T) / 2, atol=1e-12)

    def test_ord2idx(self):
        np.testing.assert_array_equal(MIO.ord2idx([2, 1]),
                                      [3, 4, 5, 0, 1, 2])


class TestLambda:
    def test_wblambda_roundtrip(self, tmp_path, rng):
        n = 4
        mats = [rng.normal(size=(n, n)) for _ in range(5)]
        path = str(tmp_path / "wb.npz")
        MIO.WritewbLambda(path, *mats)
        bias, eta, xim, xip, z1, z2 = MIO.ReadwbLambda(path)
        assert bias == 0.0
        for got, want in zip((eta, xim, xip, z1, z2), mats):
            np.testing.assert_allclose(got, want)

    def test_lambda_extraction_conventions(self, tmp_path, rng):
        """ReadLambda's eta/xim/zeta decompositions follow myio.py:339-366."""
        nw, n = 7, 3
        wl = np.linspace(0.05, 0.65, nw)
        mus = np.array([0.6, 0.1])
        impir = rng.normal(size=(nw, n, n))
        repir = rng.normal(size=(nw, n, n))
        relam = rng.normal(size=(nw, n, n))
        path = str(tmp_path / "lam.npz")
        MIO.WriteLambda(path, wl, mus, impir, repir, relam)
        w0 = 0.32
        bias, eta, xim, xip, z1, z2 = MIO.ReadLambda(path, w0)
        idx = int(np.argmin(np.abs(wl - w0)))
        w00 = wl[idx]
        assert bias == pytest.approx(0.5)
        e0 = impir[idx]
        np.testing.assert_allclose(eta, -(e0 + e0.T) / 2 / w00)
        np.testing.assert_allclose(z2, -(e0 - e0.T) / 2 / w00 / bias)
        x0 = repir[idx]
        np.testing.assert_allclose(xim, -(x0 - x0.T) / 2 / bias)
        np.testing.assert_allclose(z1, (x0 + x0.T) / 2 / bias)
        np.testing.assert_allclose(
            xip, -np.pi * (relam[idx] + relam[idx].T) / 2 / w00)
        # symmetries: eta, zeta1, xip symmetric; xim, zeta2 antisymmetric
        np.testing.assert_allclose(eta, eta.T)
        np.testing.assert_allclose(xim, -xim.T)

    def test_lambda_feeds_biased_ebath(self, tmp_path, rng):
        """End-to-end: Lambda file -> biased ebath with wind forces
        (the rundp.py workflow, examples/current-induced/rundp.py:10,78)."""
        import jax.numpy as jnp
        from sclmd_jax import baths as B
        nw, n = 5, 3
        wl = np.linspace(0.05, 0.45, nw)
        MIO.WriteLambda(str(tmp_path / "lam.npz"), wl, np.array([0.5, 0.0]),
                        rng.normal(size=(nw, n, n)),
                        rng.normal(size=(nw, n, n)),
                        rng.normal(size=(nw, n, n)))
        bias, eta, xim, xip, z1, z2 = MIO.ReadLambda(
            str(tmp_path / "lam.npz"), 0.2)
        # eta may be indefinite for random input; symmetrize+shift for a
        # valid friction matrix
        eta = eta + np.eye(n) * (abs(np.linalg.eigvalsh(eta)).max() + 0.01)
        eb = B.ebath(range(n), 300.0, 0.5, 32, wmax=1.0, bias=bias,
                     efric=eta, exim=xim, exip=xip, zeta1=z1, zeta2=z2,
                     dtype=jnp.float64)
        assert eb.bias_terms
        assert float(eb.bias) == pytest.approx(0.5)


class TestCutlayers:
    def test_cut_and_cell_shrink(self):
        # 6 layers of 2 atoms along z, spacing 1.0
        na, nalayer = 12, 2
        xyz = np.array([[0.1 * i, 0.0, i // nalayer * 1.0]
                        for i in range(na)])
        pbc = np.diag([5.0, 5.0, 10.0])
        anr = list(range(1, na + 1))
        out = MIO.cutlayers(xyz, nalayer, nl=1, nr=2, anr=anr, pbc=pbc)
        assert out["xyz"].shape == (6, 3)
        # atoms 2..7 remain (first layer + last two layers cut)
        assert out["anr"] == [3, 4, 5, 6, 7, 8]
        np.testing.assert_allclose(out["xyz"][0, 2], 1.0)
        np.testing.assert_allclose(out["xyz"][-1, 2], 3.0)
        # z extent shrank 5.0 -> 2.0, cell follows (myio.py:40-48)
        np.testing.assert_allclose(out["pbc"][2][2], 10.0 - 3.0)
        # x/y cell untouched
        np.testing.assert_allclose(out["pbc"][0][0], 5.0)

    def test_cut_too_many_raises(self):
        xyz = np.zeros((4, 3))
        xyz[:, 2] = np.arange(4)
        with pytest.raises(ValueError, match="cutlayers"):
            MIO.cutlayers(xyz, 1, nl=2, nr=2)


class TestLammpsData:
    def _write_full(self, path):
        path.write_text(
            "# LAMMPS data file written by OVITO\n"
            "3 atoms\n2 atom types\n"
            "0.0 10.0 xlo xhi\n0.0 12.0 ylo yhi\n0.0 8.0 zlo zhi\n\n"
            "Masses\n\n1  12.0107 # C\n2  1.00794 # H\n\n"
            "Atoms # full\n\n"
            "2\t1\t1\t0\t1.0\t2.0\t3.0\n"
            "1\t1\t2\t0\t0.0\t0.5\t0.25\n"
            "3\t1\t1\t0\t4.0\t5.0\t6.0\n")

    def test_full_style(self, tmp_path):
        fn = tmp_path / "structure.data"
        self._write_full(fn)
        d = MIO.read_lammps_data(str(fn))
        # sorted by atom id; types resolve to element names via masses
        assert d["els"] == ["H", "C", "C"]
        np.testing.assert_allclose(d["axyz"][0][1:], [0.0, 0.5, 0.25])
        np.testing.assert_allclose(d["axyz"][1][1:], [1.0, 2.0, 3.0])
        np.testing.assert_allclose(np.diag(d["cell"]), [10.0, 12.0, 8.0])
        np.testing.assert_allclose(d["masses"], [1.00794, 12.0107,
                                                 12.0107])

    def test_atomic_style(self, tmp_path):
        fn = tmp_path / "s.data"
        fn.write_text(
            "2 atoms\n1 atom types\n"
            "0.0 5.0 xlo xhi\n0.0 5.0 ylo yhi\n0.0 5.0 zlo zhi\n\n"
            "Masses\n\n1 196.96657 # Au\n\n"
            "Atoms # atomic\n\n"
            "1 1 0.0 0.0 0.0\n2 1 2.9 0.0 0.0\n")
        d = MIO.read_lammps_data(str(fn))
        assert d["els"] == ["Au", "Au"]
        np.testing.assert_allclose(d["axyz"][1][1:], [2.9, 0.0, 0.0])

    def test_count_mismatch_raises(self, tmp_path):
        fn = tmp_path / "bad.data"
        fn.write_text(
            "5 atoms\n1 atom types\n"
            "0.0 5.0 xlo xhi\n0.0 5.0 ylo yhi\n0.0 5.0 zlo zhi\n\n"
            "Masses\n\n1 12.0107\n\n"
            "Atoms # atomic\n\n1 1 0.0 0.0 0.0\n")
        with pytest.raises(ValueError, match="header says"):
            MIO.read_lammps_data(str(fn))
