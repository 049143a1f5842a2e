"""Lead self-energies via decimation surface Green's functions.

Reimplementation of the reference's sclmd/selfenergy.py: the
Lopez-Sancho-style decimation iteration (selfenergy.py:105-131) becomes a
``lax.while_loop`` that is ``vmap``-ed over the whole energy grid, so the
entire Sigma(w) sweep is one compiled program instead of a serial tqdm
loop (selfenergy.py:153-166).

Conventions follow the reference exactly: the recursion uses plain
transposes (not daggers), convergence is ||alpha||_F <= 1e-8 capped at
100 iterations, and Green's functions are built from ((w + i eta)^2 I - K).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from sclmd_jax import units as U


def _cdtype(dtype):
    return jnp.complex128 if dtype in (jnp.float64, np.float64) \
        else jnp.complex64


@partial(jax.jit, static_argnames=("max_iter",))
def surface_gf(omega, e, s, alpha, eta: float = 0.164e-3 / U.RPC,
               tol: float = 1e-8, max_iter: int = 100):
    """Surface Green's function by decimation (selfenergy.py:105-131).

    omega : scalar (vmap over a grid for batching)
    e     : (n, n) bulk principal-layer block (iterated)
    s     : (n, n) surface block (accumulated)
    alpha : (n, n) interlayer coupling

    Returns (g_surface, niter, converged).
    """
    cdt = _cdtype(jnp.asarray(e).dtype)
    z2 = (omega + 1j * eta) ** 2
    eye = jnp.eye(e.shape[0], dtype=cdt)

    def cond(carry):
        s_, e_, a_, it = carry
        return (jnp.linalg.norm(a_) > tol) & (it < max_iter)

    def body(carry):
        s_, e_, a_, it = carry
        g = jnp.linalg.inv(z2 * eye - e_)
        b_ = a_.T
        agb = a_ @ g @ b_
        s_ = s_ + agb
        e_ = e_ + agb + b_ @ g @ a_
        a_ = a_ @ g @ a_
        return (s_, e_, a_, it + 1)

    s0 = jnp.asarray(s, cdt)
    e0 = jnp.asarray(e, cdt)
    a0 = jnp.asarray(alpha, cdt)
    s_f, e_f, a_f, niter = jax.lax.while_loop(
        cond, body, (s0, e0, a0, jnp.asarray(0, jnp.int32)))
    g_surf = jnp.linalg.inv(z2 * eye - s_f)
    converged = jnp.linalg.norm(a_f) <= tol
    return g_surf, niter, converged


def surface_gf_np(omega, e, s, alpha, eta: float = 0.164e-3 / U.RPC,
                  tol: float = 1e-8, max_iter: int = 100):
    """Host NumPy twin of ``surface_gf`` for the host-side bath
    builders. Same
    default eta as ``surface_gf`` (the reference's 0.164e-3 eV / rpc,
    selfenergy.py:9,18)."""
    z2 = (omega + 1j * eta) ** 2
    eye = np.eye(len(e))
    s = np.asarray(s, complex).copy()
    e = np.asarray(e, complex).copy()
    a = np.asarray(alpha, complex).copy()
    for _ in range(max_iter):
        if np.linalg.norm(a) <= tol:
            break
        g = np.linalg.inv(z2 * eye - e)
        b = a.T
        agb = a @ g @ b
        s = s + agb
        e = e + agb + b @ g @ a
        a = a @ g @ a
    return np.linalg.inv(z2 * eye - s)


def lead_selfenergy_from_blocks_np(K00, K01, V01, wl, eta: float = 1e-5,
                                   max_iter: int = 100):
    """NumPy twin of ``lead_selfenergy_from_blocks`` (host-side setup)."""
    out = []
    for w in np.asarray(wl):
        g = surface_gf_np(w, K00, K00, K01, eta=eta, max_iter=max_iter)
        out.append(V01 @ g @ V01.T)
    return np.array(out)


def lead_selfenergy_from_blocks(K00, K01, V01, wl,
                                eta: float = 1e-5,
                                max_iter: int = 100):
    """Sigma(w) on system DOFs from semi-infinite-lead blocks.

    Implements the mode the reference declares but aborts on
    (baths.py:316-320): the lead has onsite block ``K00`` and inter-layer
    coupling ``K01``; the system couples to the surface layer through
    ``V01`` (nsys x nlead). Then

        Sigma(w) = V01 . g_surf(w) . V01^T

    vmapped over the grid ``wl``. All blocks in natural eV^2 units.
    """
    K00 = jnp.asarray(K00)
    K01 = jnp.asarray(K01)
    V01 = jnp.asarray(V01)

    def one(w):
        g, _, _ = surface_gf(w, K00, K00, K01, eta=eta, max_iter=max_iter)
        return V01 @ g @ V01.T

    return jax.vmap(one)(jnp.asarray(wl))


class sig:
    """Reference-compatible lead self-energy object (selfenergy.py:7-198).

    Instead of launching LAMMPS, pass the dynamical matrix directly:

    sig(dynmat, maxomega, atomgroup0, atomgroup1, ...)

    ``dynmat`` may be a square array in ps^-2 (the LAMMPS ``eskm``
    convention), a text file path of flattened rows, or a driver object
    exposing ``.dynmat()`` in eV^2 (converted internally).
    """

    def __init__(self, dynmat, maxomega, atomgroup0, atomgroup1,
                 dofatomfixed=(list(), list()), dynmatfile=None, num=1000,
                 eta=0.164e-3, write_files=False, dtype=jnp.float64):
        self.rpc = U.RPC
        self.maxomega = maxomega / self.rpc
        self.intnum = num
        self.eta = eta / self.rpc
        self.dofatomK00 = np.asarray(list(atomgroup0), dtype=np.int64)
        self.dofatomK11 = np.asarray(list(atomgroup1), dtype=np.int64)
        self.dofatomfixed = [list(g) for g in dofatomfixed]
        self.write_files = write_files
        self.dtype = dtype
        self.ep = np.linspace(0, self.maxomega, self.intnum + 1)
        self._load_dynmat(dynmat if dynmatfile is None else dynmatfile)
        self.getdk()

    # -- setup -------------------------------------------------------------
    def _load_dynmat(self, dynmat):
        if isinstance(dynmat, str):
            dat = np.loadtxt(dynmat)
            n = int(3 * np.sqrt(len(dat) / 3))
            dynmat = dat.reshape(n, n)
        elif hasattr(dynmat, "dynmat"):
            dynmat = np.asarray(dynmat.dynmat()) / U.RPC ** 2
        dynmat = np.asarray(dynmat, dtype=np.float64)
        self.dynmat = dynmat  # NOTE: fixed DOFs are NOT removed before
        # block extraction, matching selfenergy.py:93-103
        dm = np.delete(dynmat, self.dofatomfixed[0], axis=0)
        dm = np.delete(dm, self.dofatomfixed[0], axis=1)
        shift = [d - len(self.dofatomfixed[0]) for d in self.dofatomfixed[1]]
        dm = np.delete(dm, shift, axis=0)
        dm = np.delete(dm, shift, axis=1)
        eigvals, eigvecs = np.linalg.eigh((dm + dm.T) / 2)
        self.omegas = np.where(eigvals > 0, np.sqrt(np.abs(eigvals)),
                               -np.sqrt(np.abs(eigvals))) * self.rpc
        ffi = np.nonzero(eigvals <= 0)[0]
        if self.write_files:
            np.savetxt("falsefrequencies.dat", ffi, fmt="%d")
            np.savetxt("omegas.dat", self.omegas)
            np.savetxt("eigvecs.dat", eigvecs)

    def getdk(self):
        """Extract K00/K01/K10/K11 blocks + symmetry repair
        (selfenergy.py:93-103)."""
        d = self.dynmat
        self.K00 = d[np.ix_(self.dofatomK00, self.dofatomK00)]
        self.K11 = d[np.ix_(self.dofatomK11, self.dofatomK11)]
        self.K01 = d[np.ix_(self.dofatomK00, self.dofatomK11)]
        self.K10 = d[np.ix_(self.dofatomK11, self.dofatomK00)]
        mism = np.max(np.abs(self.K01 - self.K10.T)) / np.max(np.abs(self.K01))
        if mism > 1e-8:
            raise ValueError("K01 and K10 are not symmetric", mism)
        self.K01 = (self.K01 + self.K10.T) / 2
        self.K10 = self.K01.T

    # -- per-omega API (reference names) -----------------------------------
    def _blocks(self, direction):
        if direction == "R":
            return self.K00, self.K11, self.K01
        if direction == "L":
            return self.K11, self.K00, self.K10
        raise ValueError("Wrong direction, should only be R or L")

    def sgf(self, omega, direction):
        s, e, alpha = self._blocks(direction)
        g, niter, conv = surface_gf(jnp.asarray(omega), jnp.asarray(e),
                                    jnp.asarray(s), jnp.asarray(alpha),
                                    eta=self.eta)
        if not bool(conv):
            raise ValueError(
                "Iteration number exceeded 100, please increase eta")
        return g

    def selfenergy(self, omega, direction):
        if direction == "R":
            return jnp.asarray(self.K01) @ self.sgf(omega, direction) @ \
                jnp.asarray(self.K10)
        if direction == "L":
            return jnp.asarray(self.K10) @ self.sgf(omega, direction) @ \
                jnp.asarray(self.K01)
        raise ValueError("Wrong direction, should only be R or L")

    def gamma(self, Pi):
        return -1j * (Pi - jnp.conjugate(Pi).T)

    # -- batched sweeps ----------------------------------------------------
    def _sigma_batch(self, wl, direction, mesh=None, shard_axis=None):
        s, e, alpha = self._blocks(direction)
        s, e, alpha = map(jnp.asarray, (s, e, alpha))
        post_l, post_r = ((self.K01, self.K10) if direction == "R"
                          else (self.K10, self.K01))
        post_l, post_r = jnp.asarray(post_l), jnp.asarray(post_r)

        def one(w):
            g, niter, conv = surface_gf(w, e, s, alpha, eta=self.eta)
            return post_l @ g @ post_r, conv

        if mesh is not None:
            # energy-grid parallelism: shard the omega grid over a mesh
            # axis; the vmapped decimation while_loops partition across
            # devices
            from jax.sharding import NamedSharding, PartitionSpec as P
            axis = shard_axis or mesh.axis_names[0]
            n = len(wl)
            npad = (-n) % mesh.shape[axis]
            ws = jnp.asarray(np.pad(np.asarray(wl, np.float64),
                                    (0, npad), constant_values=wl[-1]))
            ws = jax.device_put(ws, NamedSharding(mesh, P(axis)))
            with mesh:
                se, conv = jax.jit(jax.vmap(one))(ws)
                jax.block_until_ready(se)
            se, conv = se[:n], conv[:n]
        else:
            @jax.jit
            def run(ws):
                return jax.lax.map(one, ws, batch_size=64)

            se, conv = run(jnp.asarray(wl))
        if not bool(jnp.all(conv)):
            raise ValueError(
                "Iteration number exceeded 100, please increase eta")
        return se

    def getse(self, direction, mesh=None, shard_axis=None):
        """Sigma(w) sweep + lead DOS (selfenergy.py:153-166); pass a
        jax.sharding.Mesh to distribute the grid across devices."""
        se = self._sigma_batch(self.ep, direction, mesh=mesh,
                               shard_axis=shard_axis)
        dosx = -jnp.einsum("wii->w", jnp.imag(se)) * \
            jnp.asarray(self.ep) / np.pi
        self.dos = np.column_stack((self.ep, np.asarray(dosx)))
        if self.write_files:
            np.savetxt(f"densityofstates_{direction}.dat",
                       np.column_stack((self.dos[:, 0] * self.rpc,
                                        self.dos[:, 1])))
        return np.asarray(se)

    def retargf(self, omega):
        """Device retarded GF with both lead self-energies
        (selfenergy.py:145-147)."""
        n = len(self.K00)
        z2 = (omega + 1e-8j) ** 2
        return jnp.linalg.inv(
            z2 * jnp.eye(n, dtype=jnp.complex128) - jnp.asarray(self.K00)
            - self.selfenergy(omega, "L") - self.selfenergy(omega, "R"))

    def tm(self, omega):
        gr = self.retargf(omega)
        gl = self.gamma(self.selfenergy(omega, "L"))
        gr2 = self.gamma(self.selfenergy(omega, "R"))
        return float(jnp.real(jnp.trace(gr @ gl @
                                        jnp.conjugate(gr).T @ gr2)))

    def gettm(self):
        """Caroli transmission over the full grid, batched
        (selfenergy.py:168-178)."""
        seL = self._sigma_batch(self.ep, "L")
        seR = self._sigma_batch(self.ep, "R")
        K00 = jnp.asarray(self.K00)
        n = len(self.K00)
        eye = jnp.eye(n, dtype=jnp.complex128)
        ws = jnp.asarray(self.ep)

        @jax.jit
        def run(ws, seL, seR):
            def one(args):
                w, sl, sr = args
                gr = jnp.linalg.inv((w + 1e-8j) ** 2 * eye - K00 - sl - sr)
                gl = -1j * (sl - jnp.conjugate(sl).T)
                g2 = -1j * (sr - jnp.conjugate(sr).T)
                return jnp.real(jnp.trace(gr @ gl @ jnp.conjugate(gr).T @ g2))
            return jax.lax.map(one, (ws, seL, seR), batch_size=64)

        tm = np.asarray(run(ws, jnp.asarray(seL), jnp.asarray(seR)))
        self.tmnumber = np.column_stack((self.ep, tm))
        if self.write_files:
            np.savetxt("transmission.dat",
                       np.column_stack((self.tmnumber[:, 0] * self.rpc,
                                        self.tmnumber[:, 1])))
        return self.tmnumber

    def plotresult(self, lines=180):
        from matplotlib import pyplot as plt
        plt.figure(0)
        plt.hist(self.omegas, bins=lines)
        plt.xlabel("Frequence(eV)")
        plt.ylabel("Number")
        plt.savefig("omegas.png")
        plt.figure(1)
        plt.plot(self.dos[:, 0] * self.rpc, self.dos[:, 1])
        plt.xlabel("Frequence(eV)")
        plt.ylabel("DOS")
        plt.savefig("densityofstates.png")
        plt.figure(2)
        plt.plot(self.tmnumber[:, 0] * self.rpc, self.tmnumber[:, 1])
        plt.xlabel("Frequence(eV)")
        plt.ylabel("Transmission")
        plt.savefig("transmission.png")
