"""Native (C++) force engines: in-process library and socket server.

The reference's native layer is (a) the LAMMPS shared library loaded
in-process via ctypes (lammpsdriver.py:17-23) and (b) the pysiesta
Fortran bridge that talks to a separate Siesta process over an INET
socket (pysiesta/siesta.f90, siestadriver.py:70-115). This module
provides the framework's own native equivalents built from
``csrc/sclmd_forces.cpp`` / ``csrc/force_server.cpp``:

* ``NativeDriver`` — in-process C++ pair-potential engine (ctypes),
  reference driver protocol, off the device hot path by design (wrap in
  models.driver.HostDriver to use inside the jitted MD step).
* ``SocketDriver`` — client for the external force server process
  (length-prefixed binary protocol over loopback TCP), the pysiesta
  IPC analog.
* ``SiestaDriver`` — fdf-generating shell mirroring
  siestadriver.genfdf/start (siestadriver.py:55-115); actually
  launching Siesta requires it on PATH (gated).

Binaries are compiled on demand with g++ into ``csrc/build`` and
cached.
"""

from __future__ import annotations

import ctypes
import os
import socket
import struct
import subprocess
import time

import numpy as np

from sclmd_jax import units as U

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "csrc")
_BUILD = os.path.join(_CSRC, "build")


def _compile(target: str, sources, extra=()):
    os.makedirs(_BUILD, exist_ok=True)
    out = os.path.join(_BUILD, target)
    srcs = [os.path.join(_CSRC, s) for s in sources]
    newest = max(os.path.getmtime(s) for s in srcs)
    if os.path.exists(out) and os.path.getmtime(out) >= newest:
        return out
    cmd = ["g++", "-O3", "-march=native", "-std=c++17"] + list(extra) + \
        srcs + ["-o", out]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            "native build failed: " + " ".join(cmd) + "\n"
            + proc.stderr[-4000:])
    return out


def build_library() -> str:
    """Compile the shared force library; returns its path."""
    return _compile("libsclmd_forces.so",
                    ["sclmd_forces.cpp", "neighbors.cpp"],
                    extra=["-shared", "-fPIC"])


def native_neighbors(xyz, cutoff: float, max_nnei: int, cell=None):
    """Cell-list neighbor table from csrc/neighbors.cpp: O(na) at fixed
    density vs the Python O(na^2) builder, identical output semantics
    (per-atom neighbors within cutoff sorted by (distance, index),
    padded to max_nnei). Returns (neighbors int64 (na, max_nnei),
    mask bool, worst int) where worst is the largest true neighbor
    count (> max_nnei means the table truncated)."""
    lib = ctypes.CDLL(build_library())
    lib.sclmd_neighbors.restype = ctypes.c_longlong
    lib.sclmd_neighbors.argtypes = [
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_double, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_void_p]
    x = np.ascontiguousarray(np.asarray(xyz, np.float64).reshape(-1, 3))
    na = len(x)
    cellv = None if cell is None else \
        np.ascontiguousarray(np.asarray(cell, np.float64).reshape(3))
    nbr = np.empty((na, max_nnei), np.int64)
    mask = np.empty((na, max_nnei), np.uint8)
    worst = lib.sclmd_neighbors(
        na, _ptr(x), None if cellv is None else _ptr(cellv),
        float(cutoff), int(max_nnei), _ptr(nbr), _ptr(mask))
    if worst < 0:
        raise ValueError("sclmd_neighbors failed (bad arguments)")
    mask = mask.astype(bool)
    return np.where(mask, nbr, 0), mask, int(worst)


def build_server() -> str:
    """Compile the standalone force-server binary; returns its path."""
    return _compile("force_server", ["force_server.cpp",
                                     "sclmd_forces.cpp"])


def _load():
    lib = ctypes.CDLL(build_library())
    lib.sclmd_engine_create.restype = ctypes.c_void_p
    lib.sclmd_engine_create.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                        ctypes.c_void_p]
    lib.sclmd_engine_destroy.argtypes = [ctypes.c_void_p]
    lib.sclmd_set_lj.argtypes = [ctypes.c_void_p] + [ctypes.c_double] * 3
    lib.sclmd_set_morse.argtypes = [ctypes.c_void_p] + [ctypes.c_double] * 4
    lib.sclmd_set_bonds.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_void_p, ctypes.c_double,
                                    ctypes.c_double]
    lib.sclmd_build_neighbors.restype = ctypes.c_int
    lib.sclmd_build_neighbors.argtypes = [ctypes.c_void_p, ctypes.c_double,
                                          ctypes.c_double]
    lib.sclmd_energy.restype = ctypes.c_double
    lib.sclmd_energy.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.sclmd_forces.restype = ctypes.c_double
    lib.sclmd_forces.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 2
    lib.sclmd_dynmat.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_double, ctypes.c_void_p]
    return lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


class NativeDriver:
    """In-process C++ force engine with the reference driver protocol.

    potential: ("lj", eps, sigma, rcut) or ("morse", D, alpha, r0, rcut);
    bonds: optional (nb, 2) index array with (kbond, rbond).
    """

    def __init__(self, axyz, potential, bonds=None, kbond=0.0, rbond=0.0,
                 cell=None, skin=0.4, md2ang=U.MD2ANG):
        self._lib = _load()
        self.axyz = axyz
        self.els = [a[0] for a in axyz]
        self.number = len(axyz)
        self.xyz = np.ascontiguousarray(
            np.array([a[1:] for a in axyz], dtype=np.float64).flatten())
        mass = np.array([U.AtomicMassTable[e] for e in self.els])
        self.conv = md2ang * np.repeat(1.0 / np.sqrt(mass), 3)
        cell_arr = None if cell is None else \
            np.ascontiguousarray(np.asarray(cell, np.float64))
        self._h = self._lib.sclmd_engine_create(
            self.number, _ptr(self.xyz),
            None if cell_arr is None else _ptr(cell_arr))
        kind = potential[0]
        if kind == "lj":
            eps, sigma, rcut = potential[1:]
            self._lib.sclmd_set_lj(self._h, eps, sigma, rcut)
        elif kind == "morse":
            D, alpha, r0, rcut = potential[1:]
            self._lib.sclmd_set_morse(self._h, D, alpha, r0, rcut)
        else:
            raise ValueError(f"unknown potential kind {kind}")
        rcut = potential[-1]
        self.npairs = self._lib.sclmd_build_neighbors(self._h, rcut, skin)
        if bonds is not None:
            b = np.ascontiguousarray(np.asarray(bonds, np.int32))
            self._lib.sclmd_set_bonds(self._h, len(b), _ptr(b),
                                      kbond, rbond)
        self.initforce()

    # --- reference protocol ---
    def newx(self, q):
        return self.xyz + self.conv * np.asarray(q, np.float64)

    def absforce(self, q):
        x = np.ascontiguousarray(self.newx(q))
        f = np.zeros_like(x)
        self._e = self._lib.sclmd_forces(self._h, _ptr(x), _ptr(f))
        return self.conv * f

    def initforce(self):
        self.f0 = self.absforce(np.zeros(3 * self.number))

    def force(self, q):
        return self.absforce(q) - self.f0

    def energy(self, q=None):
        x = np.ascontiguousarray(
            self.newx(np.zeros(3 * self.number) if q is None else q))
        return float(self._lib.sclmd_energy(self._h, _ptr(x)))

    def dynmat(self, q=None, eps=1e-5):
        """Dynamical matrix in eV^2 (conv-weighted central differences)."""
        n = 3 * self.number
        x = np.ascontiguousarray(
            self.newx(np.zeros(n) if q is None else q))
        out = np.zeros((n, n))
        self._lib.sclmd_dynmat(self._h, _ptr(x), eps, _ptr(out))
        # cartesian hessian -> mass-weighted natural units
        return self.conv[:, None] * out * self.conv[None, :]

    def quit(self):
        if getattr(self, "_h", None):
            self._lib.sclmd_engine_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.quit()
        except Exception:
            pass


class SocketDriver:
    """Force driver backed by a separate server process over loopback
    TCP — the pysiesta/fsiesta IPC analog (siestadriver.py:70-75,
    port 10001; pysiesta/Makefile socket build)."""

    def __init__(self, axyz, potential, port=0, cell=None,
                 server_cmd=None, md2ang=U.MD2ANG, timeout=20.0):
        self.axyz = axyz
        self.els = [a[0] for a in axyz]
        self.number = len(axyz)
        self.xyz = np.array([a[1:] for a in axyz],
                            dtype=np.float64).flatten()
        mass = np.array([U.AtomicMassTable[e] for e in self.els])
        self.conv = md2ang * np.repeat(1.0 / np.sqrt(mass), 3)

        if port == 0:
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
            s.close()
        self.port = port
        cmd = server_cmd or [build_server(), str(port)]
        self.proc = subprocess.Popen(cmd, stderr=subprocess.DEVNULL)
        self.sock = None
        deadline = time.time() + timeout
        while time.time() < deadline:
            try:
                self.sock = socket.create_connection(
                    ("127.0.0.1", port), timeout=2.0)
                break
            except OSError:
                time.sleep(0.05)
        if self.sock is None:
            raise RuntimeError("force_server did not come up")

        kind = potential[0]
        if kind not in ("lj", "morse"):
            raise ValueError(f"unknown potential kind {kind!r}")
        which = 1 if kind == "lj" else 2
        params = list(potential[1:]) + [0.0] * (4 - len(potential[1:]))
        cellv = np.zeros(3) if cell is None else np.asarray(cell, float)
        msg = b"I" + struct.pack("<i", self.number) \
            + self.xyz.astype("<f8").tobytes() \
            + cellv.astype("<f8").tobytes() \
            + struct.pack("<i", which) \
            + np.asarray(params, "<f8").tobytes()
        self.sock.sendall(msg)
        (self.npairs,) = struct.unpack("<i", self._recv(4))
        self.initforce()

    def _recv(self, n):
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("force_server closed")
            buf += chunk
        return buf

    def absforce(self, q):
        x = self.xyz + self.conv * np.asarray(q, np.float64)
        self.sock.sendall(b"F" + x.astype("<f8").tobytes())
        (self._e,) = struct.unpack("<d", self._recv(8))
        f = np.frombuffer(self._recv(8 * 3 * self.number), "<f8")
        return self.conv * f

    def initforce(self):
        self.f0 = self.absforce(np.zeros(3 * self.number))

    def force(self, q):
        return self.absforce(q) - self.f0

    def energy(self, q=None):
        if q is not None:
            self.absforce(q)
        return float(self._e)

    def quit(self):
        try:
            if self.sock is not None:
                self.sock.sendall(b"Q")
                self.sock.close()
                self.sock = None
        finally:
            if self.proc is not None:
                self.proc.wait(timeout=5)
                self.proc = None

    def __del__(self):
        try:
            self.quit()
        except Exception:
            pass


class PipeDriver(SocketDriver):
    """Pipe-transport variant of SocketDriver: the same binary protocol
    over the server's stdin/stdout (the reference's pysiesta "pipes"
    build, pysiesta/Makefile:48-56)."""

    def __init__(self, axyz, potential, cell=None, server_cmd=None,
                 md2ang=U.MD2ANG, **_):
        self.axyz = axyz
        self.els = [a[0] for a in axyz]
        self.number = len(axyz)
        self.xyz = np.array([a[1:] for a in axyz],
                            dtype=np.float64).flatten()
        mass = np.array([U.AtomicMassTable[e] for e in self.els])
        self.conv = md2ang * np.repeat(1.0 / np.sqrt(mass), 3)
        cmd = server_cmd or [build_server(), "--stdio"]
        self.proc = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.DEVNULL)
        self.sock = None
        kind = potential[0]
        if kind not in ("lj", "morse"):
            raise ValueError(f"unknown potential kind {kind!r}")
        which = 1 if kind == "lj" else 2
        params = list(potential[1:]) + [0.0] * (4 - len(potential[1:]))
        cellv = np.zeros(3) if cell is None else np.asarray(cell, float)
        msg = b"I" + struct.pack("<i", self.number) \
            + self.xyz.astype("<f8").tobytes() \
            + cellv.astype("<f8").tobytes() \
            + struct.pack("<i", which) \
            + np.asarray(params, "<f8").tobytes()
        self.proc.stdin.write(msg)
        self.proc.stdin.flush()
        (self.npairs,) = struct.unpack("<i", self._recv(4))
        self.initforce()

    def _recv(self, n):
        buf = self.proc.stdout.read(n)
        if buf is None or len(buf) < n:
            raise ConnectionError("force_server pipe closed")
        return buf

    def absforce(self, q):
        x = self.xyz + self.conv * np.asarray(q, np.float64)
        self.proc.stdin.write(b"F" + x.astype("<f8").tobytes())
        self.proc.stdin.flush()
        (self._e,) = struct.unpack("<d", self._recv(8))
        f = np.frombuffer(self._recv(8 * 3 * self.number), "<f8")
        return self.conv * f

    def quit(self):
        if self.proc is not None:
            try:
                self.proc.stdin.write(b"Q")
                self.proc.stdin.flush()
            except Exception:
                pass
            self.proc.wait(timeout=5)
            self.proc = None


class SiestaDriver:
    """Siesta DFT escape hatch: fdf generation + the full fsiesta force
    protocol (siestadriver.py:55-155). The wire protocol lives in
    models.fsiesta (socket or FIFO-pipe transport, the two pysiesta
    Makefile builds); running real Siesta requires the binary on PATH
    (gated in ``start``), but the complete force path — ``newx``/
    ``absforce``/``initforce``/``force`` speaking fsiesta — is testable
    against models.fsiesta.MockFsiestaServer.
    """

    def __init__(self, label, axyz, cell=None, meshcutoff=200.0,
                 dmtol=1e-4, constraints=(), port=10001,
                 interface="socket", md2ang=U.MD2ANG):
        self.label = label
        self.axyz = axyz
        self.els = [a[0] for a in axyz]
        self.number = len(axyz)
        self.xyz = np.array([a[1:] for a in axyz], float).flatten()
        mass = np.array([U.AtomicMassTable[e] for e in self.els])
        self.conv = md2ang * np.repeat(1.0 / np.sqrt(mass), 3)
        self.cell = cell
        self.meshcutoff = meshcutoff
        self.dmtol = dmtol
        self.constraints = list(constraints)
        self.port = port
        self.interface = interface
        self.proc = None
        self.client = None
        self.f0 = None

    def genfdf(self, tdir="./", comm_type="socket"):
        """Write <label>.fdf mirroring siestadriver.genfdf
        (siestadriver.py:55-89)."""
        fname = self.label + ".fdf"
        with open(fname, "w") as fn:
            fn.write("#fdf generated by sclmd_jax SiestaDriver\n")
            fn.write("SystemName   " + self.label + "\n")
            fn.write("SystemLabel   " + self.label + "\n")
            fn.write("MD.TypeOfRUN   forces\n")
            if comm_type == "socket":
                fn.write("Master.code    fsiesta\n")
                fn.write("Master.interface    socket\n")
                fn.write("Master.address    localhost\n")
                fn.write("Master.port    %d\n" % self.port)
                fn.write("Master.socketType    inet\n")
            fn.write("MeshCutoff    %s Ry\n" % self.meshcutoff)
            fn.write("DM.Tolerance  %s\n\n\n" % self.dmtol)
            for i, (lo, hi) in enumerate(self.constraints):
                if i == 0:
                    fn.write("%block GeometryConstraints\n")
                fn.write(f"position from {lo} to {hi}\n")
                if i == len(self.constraints) - 1:
                    fn.write("%endblock GeometryConstraints\n")
            fn.write("%include STRUCT.fdf\n")
            fn.write("%include " + tdir + "Default.fdf\n")
        return fname

    def start(self, npc=1, client=None):
        """Launch Siesta and complete the fsiesta handshake
        (siestadriver.py:91-115: mpirun launcher + pysiestalaunch +
        initforce). ``client`` injects a pre-built FsiestaClient whose
        peer is already being served (tests: MockFsiestaServer) — then
        no binary is needed."""
        from sclmd_jax.models.fsiesta import FsiestaClient

        if client is not None:
            self.client = client
        else:
            import shutil
            if shutil.which("siesta") is None:
                raise RuntimeError(
                    "siesta binary not found on PATH; SiestaDriver.start "
                    "is an external-DFT escape hatch (use NativeDriver/"
                    "SocketDriver or JAX potentials on-device instead). "
                    "Tests drive the identical protocol via "
                    "models.fsiesta.MockFsiestaServer")
            self.client = FsiestaClient(self.label, self.interface,
                                        port=self.port)
            launcher = (f"mpirun -np {npc} siesta < {self.label}.fdf "
                        f"> {self.label}.out")
            self.proc = subprocess.Popen(launcher, shell=True)
        self.client.connect()
        self.initforce()

    # --- reference force protocol (siestadriver.py:117-155) ---
    def newx(self, q):
        """Real coordinates from mass-weighted displacements
        (siestadriver.py:125-131)."""
        return self.xyz + self.conv * np.asarray(q, np.float64)

    def absforce(self, q):
        """Force from Siesta in mass-weighted units
        (siestadriver.py:133-141: pysiestaforce + conv)."""
        cell = self.cell if self.cell is not None else np.zeros((3, 3))
        self._e, force = self.client.forces(self.newx(q), cell)
        return self.conv * force

    def initforce(self):
        """Zero-displacement reference force (siestadriver.py:143-148)."""
        self.f0 = self.absforce(np.zeros(3 * self.number))

    def force(self, q):
        """Relative force (siestadriver.py:150-155)."""
        return self.absforce(q) - self.f0

    def energy(self, q=None):
        if q is not None:
            self.absforce(q)
        return float(self._e)

    def quit(self):
        """quit/quitting handshake, then reap the process
        (siestadriver.py:117-123)."""
        if self.client is not None:
            try:
                self.client.quit()
            finally:
                self.client = None
        if self.proc is not None:
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.terminate()
            self.proc = None
