"""fsiesta protocol round-trips against the in-repo mock server.

Real Siesta is PATH-gated; the wire grammar (models/fsiesta.py) is
verified here end-to-end over both transports, and SiestaDriver's
reference force surface (newx/absforce/initforce/force,
siestadriver.py:117-155) is driven through it."""

import os

import numpy as np
import pytest

from sclmd_jax import units as U
from sclmd_jax.models.fsiesta import FsiestaClient, MockFsiestaServer
from sclmd_jax.models.native import SiestaDriver


def _harmonic(k=0.3, x0=None):
    """Mock DFT: isotropic springs to reference positions."""
    def fn(xa, cell):
        ref = np.zeros_like(xa) if x0 is None else x0
        d = xa - ref
        f = -k * d
        return 0.5 * k * float(d @ d), f, np.zeros((3, 3))
    return fn


class TestProtocol:
    def test_socket_roundtrip(self):
        client = FsiestaClient("t1", interface="socket", port=0)
        x0 = np.array([0.0, 0.0, 0.0, 1.5, 0.0, 0.0])
        srv = MockFsiestaServer(_harmonic(0.3, x0), port=client.port)
        srv.start()
        client.connect()
        xa = x0 + 0.1
        e, f = client.forces(xa, np.eye(3) * 10.0)
        np.testing.assert_allclose(f, -0.3 * 0.1 * np.ones(6), rtol=1e-12)
        assert e == pytest.approx(0.5 * 0.3 * 6 * 0.01)
        assert client.stress.shape == (3, 3)
        # repeated evaluations over the same connection
        e2, f2 = client.forces(x0, None)
        np.testing.assert_allclose(f2, 0.0, atol=1e-15)
        client.quit()
        srv.join()

    def test_pipe_roundtrip(self, tmp_path):
        os.chdir(tmp_path)
        label = "t2"
        client = FsiestaClient(label, interface="pipe")
        srv = MockFsiestaServer(_harmonic(0.5), interface="pipe",
                                label=label)
        srv.start()
        client.connect()
        xa = np.array([0.2, 0.0, -0.1])
        e, f = client.forces(xa)
        np.testing.assert_allclose(f, -0.5 * xa, rtol=1e-12)
        client.quit()
        srv.join()
        assert not os.path.exists(label + ".coords")

    def test_protocol_error_detected(self):
        client = FsiestaClient("t3", interface="socket", port=0)

        def bad(xa, cell):
            return 0.0, np.zeros_like(xa), np.zeros((3, 3))

        srv = MockFsiestaServer(bad, port=client.port)
        # corrupt the server reply: consume the whole coords message
        # (closing early would race the client's sends into EPIPE),
        # answer garbage, and keep the socket open until the client
        # has raised
        orig = srv._serve

        def serve_bad():
            import socket as s
            import time as t
            conn = s.create_connection(("127.0.0.1", client.port))
            rf = conn.makefile("r")
            while rf.readline().strip() != "end_coords":
                pass
            conn.sendall(b"not_forces\n")
            t.sleep(3)
            conn.close()
        srv._serve = serve_bad
        srv.start()
        client.connect()
        with pytest.raises(ValueError, match="begin_forces"):
            client.forces(np.zeros(3))


class TestSiestaDriver:
    def test_force_path_over_fsiesta(self, tmp_path):
        """newx/absforce/initforce/force with conv mass-weighting, driven
        through the real protocol against the mock server."""
        os.chdir(tmp_path)
        axyz = [["Au", 0.0, 0.0, 0.0], ["Au", 2.9, 0.0, 0.0]]
        drv = SiestaDriver("au2", axyz, cell=np.eye(3) * 20.0)
        x0 = drv.xyz.copy()
        client = FsiestaClient("au2", interface="socket", port=0)
        srv = MockFsiestaServer(_harmonic(0.4, x0), port=client.port)
        srv.start()
        drv.start(client=client)
        # equilibrium: f0 = 0 at zero displacement for this mock
        np.testing.assert_allclose(drv.f0, 0.0, atol=1e-14)
        q = np.full(6, 0.01)
        f = drv.force(q)
        # absforce = conv * (-k * conv * q): double conv weighting
        want = -0.4 * drv.conv ** 2 * q
        np.testing.assert_allclose(f, want, rtol=1e-9)
        # newx is xyz + conv*q (siestadriver.py:125-131)
        np.testing.assert_allclose(drv.newx(q), x0 + drv.conv * q)
        assert drv.energy() > 0.0
        drv.quit()
        srv.join()

    def test_genfdf_socket_block(self, tmp_path):
        os.chdir(tmp_path)
        axyz = [["C", 0.0, 0.0, 0.0]]
        drv = SiestaDriver("c1", axyz, port=12345)
        fn = drv.genfdf()
        text = open(fn).read()
        assert "Master.interface    socket" in text
        assert "Master.port    12345" in text

    def test_start_gated_without_binary(self, tmp_path, monkeypatch):
        os.chdir(tmp_path)
        monkeypatch.setenv("PATH", str(tmp_path))
        drv = SiestaDriver("c2", [["C", 0.0, 0.0, 0.0]])
        with pytest.raises(RuntimeError, match="PATH"):
            drv.start()
