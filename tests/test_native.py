"""Tests for the native C++ force engine and socket server."""

import shutil
import subprocess

import numpy as np
import pytest

import jax.numpy as jnp

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no C++ toolchain")

from sclmd_jax.models import native as NV   # noqa: E402
from sclmd_jax.models import pair as P      # noqa: E402
from sclmd_jax.models.driver import HostDriver, JaxDriver  # noqa: E402


def _chain_axyz(na=6, a=1.5):
    return [["C", a * i, 0.0, 0.0] for i in range(na)]


@pytest.fixture(scope="module")
def lib():
    return NV.build_library()


class TestNativeDriver:
    def test_matches_jax_lj(self, lib, rng):
        axyz = _chain_axyz()
        eps, sigma, rcut = 0.02, 1.3, 4.0
        nd = NV.NativeDriver(axyz, ("lj", eps, sigma, rcut))
        x0 = np.array([a[1:] for a in axyz])
        pairs = P.neighbor_pairs(x0, rcut, skin=0.4)
        efn = P.lennard_jones_energy(eps, sigma, rcut, pairs)
        jd = JaxDriver(efn, axyz, dtype=jnp.float64)
        q = rng.normal(size=18) * 0.2
        np.testing.assert_allclose(np.asarray(nd.force(q)),
                                   np.asarray(jd.force(q)),
                                   rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(nd.energy(q), jd.energy(q), rtol=1e-8)

    def test_matches_jax_morse(self, lib, rng):
        axyz = _chain_axyz()
        D, alpha, r0, rcut = 2.0, 1.8, 1.5, 4.0
        nd = NV.NativeDriver(axyz, ("morse", D, alpha, r0, rcut))
        x0 = np.array([a[1:] for a in axyz])
        pairs = P.neighbor_pairs(x0, rcut, skin=0.4)
        efn = P.morse_energy(D, alpha, r0, rcut, pairs)
        jd = JaxDriver(efn, axyz, dtype=jnp.float64)
        q = rng.normal(size=18) * 0.1
        np.testing.assert_allclose(np.asarray(nd.force(q)),
                                   np.asarray(jd.force(q)),
                                   rtol=1e-8, atol=1e-10)

    def test_dynmat_matches_jax(self, lib):
        axyz = _chain_axyz(4)
        D, alpha, r0, rcut = 2.0, 1.8, 1.5, 4.0
        nd = NV.NativeDriver(axyz, ("morse", D, alpha, r0, rcut))
        x0 = np.array([a[1:] for a in axyz])
        pairs = P.neighbor_pairs(x0, rcut, skin=0.4)
        efn = P.morse_energy(D, alpha, r0, rcut, pairs)
        jd = JaxDriver(efn, axyz, dtype=jnp.float64)
        np.testing.assert_allclose(np.asarray(nd.dynmat()),
                                   np.asarray(jd.dynmat()),
                                   rtol=1e-4, atol=1e-7)

    def test_newtons_third_law(self, lib, rng):
        axyz = _chain_axyz()
        nd = NV.NativeDriver(axyz, ("lj", 0.02, 1.3, 4.0))
        q = rng.normal(size=18) * 0.3
        raw = np.asarray(nd.absforce(q)) / nd.conv
        np.testing.assert_allclose(raw.reshape(-1, 3).sum(axis=0), 0,
                                   atol=1e-10)

    def test_in_md_via_host_driver(self, lib, key):
        from sclmd_jax import baths as B
        from sclmd_jax.md import GLESystem, initial_state, run_segment
        axyz = _chain_axyz()
        nd = NV.NativeDriver(axyz, ("morse", 2.0, 1.8, 1.5, 4.0))
        hd = HostDriver(nd, nph=18, dtype=jnp.float64)
        nmd = 32
        eb = B.ebath(range(3), 300.0, 0.4, nmd, wmax=1.0,
                     efric=np.eye(3) * 0.02, dtype=jnp.float64).gnoi(key)
        system = GLESystem(dyn=None, baths=(eb,), mask=jnp.ones(18),
                           dt=0.4, nph=18, ml=1, nmd=nmd,
                           force_fn=hd.force_jax)
        final, _ = run_segment(system, initial_state(
            system, dtype=jnp.float64), nmd)
        assert np.isfinite(np.asarray(final.p)).all()


class TestSocketDriver:
    def test_server_roundtrip_matches_native(self, lib, rng):
        axyz = _chain_axyz()
        pot = ("lj", 0.02, 1.3, 4.0)
        nd = NV.NativeDriver(axyz, pot)
        sd = NV.SocketDriver(axyz, pot)
        try:
            assert sd.npairs == nd.npairs
            q = rng.normal(size=18) * 0.2
            np.testing.assert_allclose(np.asarray(sd.force(q)),
                                       np.asarray(nd.force(q)),
                                       rtol=1e-12)
            np.testing.assert_allclose(sd.energy(q), nd.energy(q),
                                       rtol=1e-12)
        finally:
            sd.quit()

    def test_clean_shutdown(self):
        axyz = _chain_axyz(3)
        sd = NV.SocketDriver(axyz, ("lj", 0.02, 1.3, 4.0))
        sd.quit()
        assert sd.proc is None


class TestSiestaShell:
    def test_genfdf(self, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        drv = NV.SiestaDriver("junction", _chain_axyz(3),
                              constraints=[(1, 2)])
        fname = drv.genfdf()
        text = (tmp_path / fname).read_text()
        assert "SystemLabel   junction" in text
        assert "Master.interface    socket" in text
        assert "%block GeometryConstraints" in text
        assert "position from 1 to 2" in text

    def test_start_requires_siesta(self, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        drv = NV.SiestaDriver("x", _chain_axyz(2))
        if shutil.which("siesta") is None:
            with pytest.raises(RuntimeError):
                drv.start()


class TestPipeDriver:
    def test_pipe_matches_native(self, lib, rng):
        axyz = _chain_axyz()
        pot = ("morse", 2.0, 1.8, 1.5, 4.0)
        nd = NV.NativeDriver(axyz, pot)
        pd = NV.PipeDriver(axyz, pot)
        try:
            assert pd.npairs == nd.npairs
            q = rng.normal(size=18) * 0.1
            np.testing.assert_allclose(np.asarray(pd.force(q)),
                                       np.asarray(nd.force(q)),
                                       rtol=1e-12)
        finally:
            pd.quit()


class TestNativeNeighbors:
    def test_matches_numpy_builder(self, rng):
        from sclmd_jax.models.native import native_neighbors
        from sclmd_jax.models.nnp import build_neighbors
        x = rng.uniform(0, 12.0, size=(80, 3))
        for cell in (None, np.array([12.0, 12.0, 12.0])):
            nbr_py, mask_py = build_neighbors(x, 2.5, 12, cell=cell,
                                              skin=0.0, backend="numpy")
            nbr_c, mask_c, worst = native_neighbors(x, 2.5, 12,
                                                    cell=cell)
            np.testing.assert_array_equal(mask_c, mask_py)
            np.testing.assert_array_equal(nbr_c, nbr_py)
            assert worst <= 12

    def test_small_periodic_cell(self, rng):
        """Cells with < 3 bins per axis exercise the wrap/dedupe path."""
        from sclmd_jax.models.native import native_neighbors
        from sclmd_jax.models.nnp import build_neighbors
        x = rng.uniform(0, 5.0, size=(20, 3))
        cell = np.array([5.0, 5.0, 5.0])
        nbr_py, mask_py = build_neighbors(x, 2.2, 16, cell=cell,
                                          skin=0.0, backend="numpy")
        nbr_c, mask_c, _ = native_neighbors(x, 2.2, 16, cell=cell)
        np.testing.assert_array_equal(mask_c, mask_py)
        np.testing.assert_array_equal(nbr_c, nbr_py)

    def test_auto_backend_consistency(self, rng):
        """backend='native' == backend='numpy' through build_neighbors."""
        from sclmd_jax.models.nnp import build_neighbors
        x = rng.uniform(0, 20.0, size=(150, 3))
        a = build_neighbors(x, 3.0, 10, backend="numpy")
        b = build_neighbors(x, 3.0, 10, backend="native")
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
