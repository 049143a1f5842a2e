"""Ballistic phonon NEGF transport, batched over the energy grid.

Reimplementation of the reference's sclmd/negf.py (class
``bpt``): the per-omega dense inversions of the serial reference loop
(negf.py:112-116, 0.52 s/omega) become chunked, vmapped linear solves.
Key algebraic shortcut: the wideband lead broadenings are diagonal, so
the Caroli trace Tr[G Gamma_L G^dag Gamma_R] only needs the G columns on
the left-bath DOFs — a (nd, nL) solve instead of a full inverse.

Unit conventions match the reference (negf.py:12-17): frequencies
internally in ps^-1, inputs/outputs in eV via RPC; the dynamical matrix
is in ps^-2 (LAMMPS ``dynamical_matrix eskm`` convention); heat currents
in nW.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np

from sclmd_jax import units as U


class bpt:
    """Ballistic phonon transport (negf.py:8-312), LAMMPS-free.

    Parameters
    ----------
    dynmat : square array in ps^-2, path to a dynmat.dat-style text file,
        or a driver exposing ``.dynmat()`` in eV^2 (converted).
    maxomega : energy cutoff in eV (negf.py:17).
    damp : wideband lead damping time in ps; Sigma^r = -i w / damp
        (negf.py:153-157).
    dofatomofbath : [left_dofs, right_dofs] DOF index lists.
    dofatomfixed : [first_block, second_block] fixed DOFs, deleted with
        the reference's two-stage shifted indexing (negf.py:55-60,78-83).
    num : number of energy intervals (grid has num+1 points).
    """

    def __init__(self, dynmat, maxomega, damp, dofatomofbath,
                 dofatomfixed=(list(), list()), dynmatfile=None, num=1000,
                 vector=False, write_files=False,
                 els=None, xyz=None, boxlo=None, boxhi=None,
                 batch_size=32):
        self.rpc = U.RPC
        self.bc = U.BOLTZ_EV
        self.damp = damp
        self.maxomega = maxomega / self.rpc
        self.intnum = num
        self.dofatomfixed = [list(g) for g in dofatomfixed]
        self.dofatomofbath = [np.asarray(list(g), dtype=np.int64)
                              for g in dofatomofbath]
        self.isbias = False
        self.dofatomofbias = []
        self.write_files = write_files
        self.batch_size = batch_size
        self.els = None if els is None else np.asarray(els, dtype=float)
        self.xyz = None if xyz is None else np.asarray(xyz, dtype=float)
        self.boxlo, self.boxhi = boxlo, boxhi
        self._setup(dynmat if dynmatfile is None else dynmatfile)

    # ------------------------------------------------------------------
    def _setup(self, dynmat):
        if isinstance(dynmat, str):
            dat = np.loadtxt(dynmat)
            n = int(3 * np.sqrt(len(dat) / 3))
            dynmat = dat.reshape(n, n)
        elif hasattr(dynmat, "dynmat"):
            if self.els is None and hasattr(dynmat, "els"):
                els = np.asarray(dynmat.els)
                if els.dtype.kind in "US":   # element symbols -> masses
                    els = np.array(
                        [U.AtomicMassTable[e] for e in dynmat.els],
                        dtype=float)
                else:
                    els = els.astype(float)
                if 3 * len(els) == len(dynmat.dynmat()):
                    els = np.repeat(els, 3)   # per-atom -> per-DOF
                self.els = els
            if self.xyz is None and hasattr(dynmat, "xyz"):
                self.xyz = np.asarray(dynmat.xyz, dtype=float)
            dynmat = np.asarray(dynmat.dynmat()) / U.RPC ** 2
        dynmat = np.asarray(dynmat, dtype=np.float64)
        self.nd0 = len(dynmat)
        self.natoms = self.nd0 // 3
        dynmat = (dynmat + dynmat.T) / 2
        self.dynmat = self._cleanse(dynmat, axes=(0, 1))
        # element masses / coordinates trimmed the same way (negf.py:55-60)
        if self.els is not None and len(self.els) == self.nd0:
            self.els = self._cleanse(self.els, axes=(0,))
        if self.xyz is not None and len(self.xyz) == self.nd0:
            self.xyz = self._cleanse(self.xyz, axes=(0,))
        eigvals, self.eigvecs = np.linalg.eigh(self.dynmat)
        self.omegas = np.where(eigvals > 0, np.sqrt(np.abs(eigvals)),
                               -np.sqrt(np.abs(eigvals))) * self.rpc
        ffi = np.nonzero(eigvals <= 0)[0]
        print("%i false frequencies exist in %i frequencies"
              % (len(ffi), len(self.omegas)))
        if self.write_files:
            np.savetxt("falsefrequencies.dat", ffi, fmt="%d")
            np.savetxt("omegas.dat", self.omegas)
            np.savetxt("eigvecs.dat", self.eigvecs)
        # map original DOF ids -> post-deletion ids
        keep = np.ones(self.nd0, dtype=bool)
        keep[self.dofatomfixed[0]] = False
        keep[self.dofatomfixed[1]] = False
        self._newid = np.cumsum(keep) - 1
        self._keep = keep
        self.nd = int(keep.sum())
        assert self.nd == len(self.dynmat)

    def _cleanse(self, m, axes=(0, 1)):
        """Two-stage fixed-DOF deletion with shifted second block
        (negf.py:195-204)."""
        shift = [d - len(self.dofatomfixed[0]) for d in self.dofatomfixed[1]]
        for ax in axes:
            m = np.delete(m, self.dofatomfixed[0], axis=ax)
            m = np.delete(m, shift, axis=ax)
        return m

    def _bathsel(self, dofatoms):
        """Post-deletion indices of a bath DOF group."""
        ids = np.asarray(list(dofatoms), dtype=np.int64)
        if not self._keep[ids].all():
            raise ValueError("bath DOFs overlap fixed DOFs")
        return self._newid[ids]

    # ------------------------------------------------------------------
    def setbias(self, bias, bdamp=None, chiplus=None, chiminus=None,
                dofatomofbias=()):
        """Attach a bias self-energy block (negf.py:27-37); units eV, ps^-1."""
        self.isbias = True
        self.bias = bias / self.rpc
        self.biasgamma = np.asarray(bdamp)
        self.chiplus = np.asarray(chiplus)
        self.chiminus = np.asarray(chiminus)
        self.dofatomofbias = np.asarray(list(dofatomofbias), dtype=np.int64)
        if not (len(self.biasgamma) == len(self.chiminus)
                == len(self.chiplus) == len(self.dofatomofbias)):
            raise ValueError("Bias parameters not set correctly")

    # ------------------------------------------------------------------
    def bosedist(self, omega, T):
        """Bose factor with the reference's overflow guards
        (negf.py:217-226). Vectorised."""
        omega = jnp.asarray(omega, jnp.float64)
        big = float(np.iinfo(np.int32).max)
        t_small = abs(T) < 1e-30
        if t_small:
            return 1.0 / (jnp.exp(self.rpc * omega * big) - 1)
        ratio_small = jnp.abs(omega / T) < 1e-30
        x = self.rpc * omega / (self.bc * T)
        x = jnp.where(ratio_small, 1.0, x)
        return jnp.where(ratio_small, big, 1.0 / jnp.expm1(x))

    # -- wideband self-energies as diagonal vectors ---------------------
    def _sigma_diag(self, omegas, sel):
        """(nw, nd) diagonal of Sigma^r = -i w/damp on the selected DOFs."""
        nw = omegas.shape[0]
        base = jnp.zeros((self.nd,), jnp.complex128).at[sel].set(1.0)
        return (-1j * omegas / self.damp)[:, None] * base[None, :]

    def _bias_block(self, omegas):
        """(nw, nb, nb) retarded bias self-energy block (negf.py:162-172)."""
        bg = jnp.asarray(self.biasgamma, jnp.complex128)
        chim = jnp.asarray(self.chiminus, jnp.complex128)
        return (-1j * omegas[:, None, None] * bg[None]
                - self.bias * chim[None])

    def _amatrix(self, omegas):
        """(nw, nd, nd) of (w+i e)^2 I - D - Sigma_L - Sigma_R - Sigma_bias."""
        D = jnp.asarray(self.dynmat)
        selL = jnp.asarray(self._bathsel(self.dofatomofbath[0]))
        selR = jnp.asarray(self._bathsel(self.dofatomofbath[1]))
        sdiag = self._sigma_diag(omegas, selL) + \
            self._sigma_diag(omegas, selR)
        eye = jnp.eye(self.nd, dtype=jnp.complex128)
        a = (omegas + 1e-9j)[:, None, None] ** 2 * eye[None] - D[None]
        a = a - sdiag[:, :, None] * eye[None]
        if self.isbias and len(self.dofatomofbias):
            selB = jnp.asarray(self._bathsel(self.dofatomofbias))
            blk = self._bias_block(omegas)
            a = a.at[:, selB[:, None], selB[None, :]].add(-blk)
        return a

    def retargf(self, omega):
        """Dense retarded GF at one omega (ps^-1) (negf.py:206-208)."""
        a = self._amatrix(jnp.asarray([omega], jnp.float64))[0]
        return jnp.linalg.inv(a)

    def advangf(self, omega):
        a = self._amatrix(jnp.asarray([omega], jnp.float64))[0]
        return jnp.linalg.inv(jnp.conjugate(a.T))

    def gamma(self, Pi):
        return -1j * (Pi - jnp.conjugate(Pi).T)

    # -- reference-named self-energy surface (negf.py:153-204). These
    # return full post-cleanse matrices from ORIGINAL (pre-deletion)
    # DOF ids, exactly like the reference; the batched sweep internals
    # (_sigma_diag/_bias_block/_kbias_block) are the hot path.
    def cleanse(self, semat):
        """Fixed-DOF deletion of a full-space matrix (negf.py:195-204)."""
        out = self._cleanse(np.asarray(semat), axes=(0, 1))
        if len(out) != self.nd:
            raise ValueError("System DOF test failed, check again")
        return out

    def retarselfenergy(self, omega, dofatoms):
        """Wideband Sigma^r(w) on the given DOFs (negf.py:153-157)."""
        semat = np.zeros((self.nd0, self.nd0), complex)
        ids = np.asarray(list(dofatoms), np.int64)
        semat[ids, ids] = -1j * omega / self.damp
        return self.cleanse(semat)

    def advanselfenergy(self, omega, dofatoms):
        return self.retarselfenergy(omega, dofatoms).conjugate().T

    def retarbiasselfenergy(self, omega, dofatoms):
        """Bias block Sigma^r_bias (negf.py:162-172); 0 when unbiased."""
        if not self.isbias:
            return 0
        semat = np.zeros((self.nd0, self.nd0), complex)
        ids = np.asarray(list(dofatoms), np.int64)
        semat[np.ix_(ids, ids)] = (-1j * omega * self.biasgamma
                                   - self.bias * self.chiminus)
        return self.cleanse(semat)

    def advanbiasselfenergy(self, omega, dofatoms):
        b = self.retarbiasselfenergy(omega, dofatoms)
        return 0 if np.isscalar(b) else b.conjugate().T

    def kselfenergy(self, omega, T, dofatoms):
        """Keldysh Sigma^K = -2 Im Sigma^r n_B (negf.py:177-178)."""
        return -2 * np.imag(self.retarselfenergy(omega, dofatoms)) \
            * float(self.bosedist(omega, T))

    def kbiasselfenergy(self, omega, T, dofatoms):
        """Bias Keldysh self-energy with the chi+- combination
        (negf.py:180-193); 0 when unbiased."""
        if not self.isbias:
            return 0
        nB = lambda w: float(self.bosedist(w, T))
        semat = np.zeros((self.nd0, self.nd0), complex)
        ids = np.asarray(list(dofatoms), np.int64)
        blk = ((self.chiplus - 1j * self.chiminus) * (omega + self.bias)
               * (2 * nB(omega + self.bias) - 2 * nB(omega))
               + (self.chiplus + 1j * self.chiminus) * (omega - self.bias)
               * (2 * nB(omega - self.bias) - 2 * nB(omega))) / 2
        semat[np.ix_(ids, ids)] = blk
        return (1j * self.retarbiasselfenergy(omega, dofatoms)) \
            * 2 * nB(omega) + self.cleanse(semat)

    def totalkselfenergy(self, omega, T):
        """Sum of both leads' and the bias Keldysh self-energies
        (negf.py:195-196)."""
        out = self.kselfenergy(omega, T, self.dofatomofbath[0]) \
            + self.kselfenergy(omega, T, self.dofatomofbath[1])
        kb = self.kbiasselfenergy(omega, T, self.dofatomofbias)
        return out if np.isscalar(kb) else out + kb

    # ------------------------------------------------------------------
    def tm(self, omega):
        """Caroli transmission at one omega (ps^-1) (negf.py:240-243)."""
        return float(self._tm_batch(jnp.asarray([omega], jnp.float64))[0])

    def _tm_one(self, w):
        """Caroli transmission at one (traced) omega: solve only the G
        columns on the left-bath DOFs."""
        selL = jnp.asarray(self._bathsel(self.dofatomofbath[0]))
        selR = jnp.asarray(self._bathsel(self.dofatomofbath[1]))
        nd = self.nd
        a = self._amatrix(w[None])[0]
        rhs = jnp.zeros((nd, selL.shape[0]),
                        jnp.complex128).at[selL, jnp.arange(
                            selL.shape[0])].set(1.0)
        gcols = jnp.linalg.solve(a, rhs)            # (nd, nL)
        gl = 2.0 * w / self.damp                     # Gamma diag value
        grows = gcols[selR, :]                       # (nR, nL)
        val = jnp.real(jnp.sum(jnp.abs(grows) ** 2)) * gl * gl
        # Gamma(0) = 0 => T(0) = 0; also shields the w=0 singular solve
        return jnp.where(w == 0.0, 0.0, val)

    def _tm_batch(self, omegas):
        return jax.lax.map(jax.jit(self._tm_one), omegas,
                           batch_size=self.batch_size)

    def _tm_batch_sharded(self, x, mesh, axis=None):
        """Energy-grid parallelism over a device mesh: the omega grid is
        sharded along ``axis`` and the vmapped column-solves partition
        across devices (the multi-chip replacement for the reference's
        serial tqdm omega loop, negf.py:112-116)."""
        from jax.sharding import NamedSharding, PartitionSpec as P
        axis = axis or mesh.axis_names[0]
        ndev = mesh.shape[axis]
        n = len(x)
        npad = (-n) % ndev
        # pad with in-band points (w=0-safe) so every shard is equal
        xs = jnp.asarray(np.pad(np.asarray(x, np.float64), (0, npad)))
        xs = jax.device_put(xs, NamedSharding(mesh, P(axis)))
        with mesh:
            out = jax.jit(jax.vmap(self._tm_one))(xs)
            jax.block_until_ready(out)
        return np.asarray(out)[:n]

    def gettm(self, vector=False, mesh=None, shard_axis=None):
        """Transmission sweep; pass a jax.sharding.Mesh to distribute
        the energy grid across devices."""
        x = np.linspace(0, self.maxomega, self.intnum + 1)
        if mesh is not None:
            tm = self._tm_batch_sharded(x, mesh, shard_axis)
        else:
            tm = np.asarray(self._tm_batch(jnp.asarray(x)))
        self.tmnumber = np.column_stack((x, tm))
        if self.write_files:
            np.savetxt("transmission.dat",
                       np.column_stack((x * self.rpc, tm)))
        return self.tmnumber

    # ------------------------------------------------------------------
    def thermalcurrent(self, T, delta):
        """Landauer integral over the stored transmission
        (negf.py:245-270); nW."""
        x = self.tmnumber[:, 0]
        t = self.tmnumber[:, 1]
        nb = np.asarray(self.bosedist(x, T * (1 + 0.5 * delta)) -
                        self.bosedist(x, T * (1 - 0.5 * delta)))
        f = self.rpc * x / 2 / np.pi * t * nb
        n = len(x) - 1
        if n != self.intnum:
            raise ValueError("Error in number of omega")
        integral = (x[-1] - x[0]) / n / 2.0 * (2 * f.sum() - f[0] - f[-1])
        return integral * 1.60217662e2

    def thermalconductance(self, T, delta):
        return self.thermalcurrent(T, delta) / (T * delta)

    def thermalconductivity(self, T, delta, L, A):
        """L, A in angstrom / angstrom^2 -> W/m-K (negf.py:275-277)."""
        return self.thermalconductance(T, delta) * L / A * 10

    # ------------------------------------------------------------------
    def totalkselfenergy_diag_parts(self, omegas, T):
        """Keldysh self-energy: (diag part (nw, nd), bias block or None)."""
        selL = jnp.asarray(self._bathsel(self.dofatomofbath[0]))
        selR = jnp.asarray(self._bathsel(self.dofatomofbath[1]))
        nb = self.bosedist(omegas, T)
        # -2 Im(-i w/damp) * n_B = (2 w / damp) n_B on bath DOFs
        gl = (2.0 * omegas / self.damp) * nb
        base = jnp.zeros((self.nd,), jnp.float64).at[selL].add(1.0) \
            .at[selR].add(1.0)
        diag = gl[:, None] * base[None, :]
        blk = None
        if self.isbias and len(self.dofatomofbias):
            blk = self._kbias_block(omegas, T)
        return diag.astype(jnp.complex128), blk

    def _kbias_block(self, omegas, T):
        """Bias Keldysh block (negf.py:180-190)."""
        chip = jnp.asarray(self.chiplus, jnp.complex128)
        chim = jnp.asarray(self.chiminus, jnp.complex128)
        w = omegas[:, None, None]
        nbp = self.bosedist(omegas + self.bias, T)[:, None, None]
        nbm = self.bosedist(omegas - self.bias, T)[:, None, None]
        nb0 = self.bosedist(omegas, T)[:, None, None]
        semat = ((chip - 1j * chim) * (w + self.bias) * (2 * nbp - 2 * nb0)
                 + (chip + 1j * chim) * (w - self.bias)
                 * (2 * nbm - 2 * nb0)) / 2
        retar = self._bias_block(omegas)
        return 1j * retar * 2 * nb0 + semat

    def ps(self, omega, T, atomlist):
        return float(self._ps_batch(jnp.asarray([omega], jnp.float64), T,
                                    atomlist)[0])

    def _ps_batch(self, omegas, T, atomlist):
        """Power spectrum (negf.py:228-238): equilibrium branch
        -2 w^2 n_B Tr Im G^r; bias branch w^2 Tr Re[G Sig^K G^a]."""
        sel = jnp.asarray(self._newid[np.asarray(list(atomlist),
                                                 dtype=np.int64)])
        nd = self.nd

        if not self.isbias:
            def one(w):
                a = self._amatrix(w[None])[0]
                rhs = jnp.zeros((nd, sel.shape[0]), jnp.complex128) \
                    .at[sel, jnp.arange(sel.shape[0])].set(1.0)
                gcols = jnp.linalg.solve(a, rhs)
                tr = jnp.sum(jnp.imag(gcols[sel, jnp.arange(sel.shape[0])]))
                val = -2.0 * w ** 2 * self.bosedist(w, T) * tr
                return jnp.where(w == 0.0, 0.0, val)
            return jax.lax.map(jax.jit(one), omegas,
                               batch_size=self.batch_size)

        selB = jnp.asarray(self._bathsel(self.dofatomofbias)) \
            if len(self.dofatomofbias) else None

        def one_bias(w):
            wv = w[None]
            a = self._amatrix(wv)[0]
            # rows of G on sel: G[sel, :] = solve(a^T, I[:, sel])^T
            rhs = jnp.zeros((nd, sel.shape[0]), jnp.complex128) \
                .at[sel, jnp.arange(sel.shape[0])].set(1.0)
            grows = jnp.linalg.solve(a.T, rhs).T        # (nsel, nd)
            diag, blk = self.totalkselfenergy_diag_parts(wv, T)
            m = grows * diag[0][None, :]                 # G . diag(SigK)
            if blk is not None:
                m = m.at[:, selB].add(grows[:, selB] @ blk[0])
            val = jnp.sum(jnp.real(m * jnp.conjugate(grows)))
            return jnp.where(w == 0.0, 0.0, w ** 2 * val)

        return jax.lax.map(jax.jit(one_bias), omegas,
                           batch_size=self.batch_size)

    def getps(self, T, maxomega, intnum, atomlist=None, filename=None,
              vector=False, omegalist=None, mesh=None, shard_axis=None):
        """Power-spectrum sweep; pass a jax.sharding.Mesh to distribute
        the energy grid across devices (as in gettm)."""
        if atomlist is None:
            atomlist = np.arange(self.nd0)[self._keep]
        if omegalist is not None:
            x2 = np.sort(np.asarray(omegalist)) / self.rpc
        else:
            x2 = np.linspace(0, maxomega / self.rpc, intnum + 1)
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            axis = shard_axis or mesh.axis_names[0]
            npad = (-len(x2)) % mesh.shape[axis]
            xs = jnp.asarray(np.pad(np.asarray(x2, np.float64),
                                    (0, npad)))
            xs = jax.device_put(xs, NamedSharding(mesh, P(axis)))
            sel = np.asarray(list(atomlist))
            with mesh:
                one = (lambda w: self._ps_batch(w[None], T, sel)[0])
                out = jax.jit(jax.vmap(one))(xs)
                jax.block_until_ready(out)
            ps = np.asarray(out)[: len(x2)]
        else:
            ps = np.asarray(self._ps_batch(jnp.asarray(x2), T, atomlist))
        self.psnumber = np.column_stack((x2, ps))
        if self.write_files:
            name = f"powerspectrum.{filename}.{T}.dat" if filename \
                else f"powerspectrum.{T}.dat"
            np.savetxt(name, np.column_stack((x2 * self.rpc, ps)))
        return self.psnumber

    # ------------------------------------------------------------------
    # Lesser/greater Green's-function heat currents. The reference only
    # carries this as a commented-out draft (negf.py:314-379); here it is
    # implemented and validated: the Meir-Wingreen-type lead current
    #   J_L = int dw/2pi hbar w Tr[Sig<_L G> - Sig>_L G<]
    # reduces analytically (and in tests numerically) to the Landauer
    # integral for elastic transport.
    def _less_diag(self, omega, Tl, sel):
        """Sig< = +i Gamma n_B on the selected POST-DELETION DOFs, as a
        diagonal vector (hot-path form used by leadthermalcurrent)."""
        gam = jnp.zeros((self.nd,), jnp.complex128).at[sel].set(
            2.0 * omega / self.damp)
        return 1j * gam * self.bosedist(omega, Tl)

    def _great_diag(self, omega, Tl, sel):
        """Sig> = -i Gamma (n_B + 1) on the selected POST-DELETION DOFs,
        as a diagonal vector."""
        gam = jnp.zeros((self.nd,), jnp.complex128).at[sel].set(
            2.0 * omega / self.damp)
        return -1j * gam * (self.bosedist(omega, Tl) + 1.0)

    # -- reference-named lesser/greater surface (the reference carries
    # these only as a commented-out draft, negf.py:314-379; the draft
    # slices G^r but not Sigma, which cannot contract — here the
    # product is formed in the full post-deletion space and THEN
    # restricted to the requested block). ``dofatoms`` are ORIGINAL
    # (pre-deletion) DOF ids, like the retar*selfenergy family.
    def lessselfenergy(self, omega, T, dofatoms):
        """Sig^< = 2i Im Sigma^r n_B (draft negf.py:339-340)."""
        return 2j * np.imag(self.retarselfenergy(omega, dofatoms)) \
            * float(self.bosedist(omega, T))

    def greatselfenergy(self, omega, T, dofatoms):
        """Sig^> = 2i Im Sigma^r (n_B + 1) (draft negf.py:336-337)."""
        return 2j * np.imag(self.retarselfenergy(omega, dofatoms)) \
            * (float(self.bosedist(omega, T)) + 1.0)

    def lessbiasselfenergy(self, omega, T, dofatoms):
        """Bias Sig^< = 2i Im Sigma^r_bias n_B (draft negf.py:345-346);
        0 when unbiased."""
        b = self.retarbiasselfenergy(omega, dofatoms)
        return 0 if np.isscalar(b) else \
            2j * np.imag(b) * float(self.bosedist(omega, T))

    def greatbiasselfenergy(self, omega, T, dofatoms):
        """Bias Sig^> = 2i Im Sigma^r_bias (n_B + 1) (draft
        negf.py:342-343); 0 when unbiased."""
        b = self.retarbiasselfenergy(omega, dofatoms)
        return 0 if np.isscalar(b) else \
            2j * np.imag(b) * (float(self.bosedist(omega, T)) + 1.0)

    def _gf_sandwich(self, omega, sig, dofatoms):
        """(G^r sig G^a) restricted to the dofatoms block."""
        if np.isscalar(sig):
            n = len(list(dofatoms))
            return np.zeros((n, n), complex)
        g = np.asarray(self.retargf(omega))
        ga = np.asarray(self.advangf(omega))
        sub = np.asarray(self._bathsel(dofatoms))
        return (g @ np.asarray(sig) @ ga)[np.ix_(sub, sub)]

    def greatgf(self, omega, T, dofatoms):
        """Greater GF block: (G^r Sig^> G^a)[dofatoms] (draft
        negf.py:316-320)."""
        return self._gf_sandwich(
            omega, self.greatselfenergy(omega, T, dofatoms), dofatoms)

    def lessgf(self, omega, T, dofatoms):
        """Lesser GF block (draft negf.py:321-325)."""
        return self._gf_sandwich(
            omega, self.lessselfenergy(omega, T, dofatoms), dofatoms)

    def greatbiasgf(self, omega, T, dofatoms):
        """Greater GF block from the bias self-energy alone (draft
        negf.py:326-330)."""
        return self._gf_sandwich(
            omega, self.greatbiasselfenergy(omega, T, dofatoms), dofatoms)

    def lessbiasgf(self, omega, T, dofatoms):
        """Lesser GF block from the bias self-energy alone (draft
        negf.py:331-335)."""
        return self._gf_sandwich(
            omega, self.lessbiasselfenergy(omega, T, dofatoms), dofatoms)

    def biasthermalcurrent(self, T, dofatoms, num=None):
        """Heat current pumped into the bias region (nW), mirroring the
        draft's integrand Tr[G^>_bias Sig^<_bias - G^< Sig^>_bias]
        (negf.py:364-379). Zero when no bias self-energy is attached.
        """
        if not self.isbias:
            return 0.0
        num = num or self.intnum
        ws = np.linspace(0, self.maxomega, num + 1)[1:]
        sub = np.asarray(self._bathsel(dofatoms))

        def f(w):
            gg = self.greatbiasgf(w, T, dofatoms)
            sl = self.lessbiasselfenergy(w, T, dofatoms)
            gl = self.lessgf(w, T, dofatoms)
            sg = self.greatbiasselfenergy(w, T, dofatoms)
            val = np.trace(gg @ np.asarray(sl)[np.ix_(sub, sub)]
                           - gl @ np.asarray(sg)[np.ix_(sub, sub)])
            return self.rpc * w / (2 * np.pi) * np.real(val)

        integrand = np.array([f(w) for w in ws])
        return float(np.trapezoid(integrand, ws)) * 1.60217662e2

    def leadthermalcurrent(self, TL, TR, lead="L", num=None):
        """Heat current out of one lead via G lesser/greater (nW).

        Both leads may sit at different temperatures; for this elastic
        model the result equals ``thermalcurrent`` evaluated with the
        same temperatures.
        """
        num = num or self.intnum
        ws = np.linspace(0, self.maxomega, num + 1)[1:]
        selL = jnp.asarray(self._bathsel(self.dofatomofbath[0]))
        selR = jnp.asarray(self._bathsel(self.dofatomofbath[1]))
        sel_lead = selL if lead == "L" else selR
        T_lead = TL if lead == "L" else TR

        def one(w):
            a = self._amatrix(w[None])[0]
            g = jnp.linalg.inv(a)
            gd = jnp.conjugate(g.T)
            sl_less = self._less_diag(w, TL, selL) + \
                self._less_diag(w, TR, selR)
            sl_great = self._great_diag(w, TL, selL) + \
                self._great_diag(w, TR, selR)
            g_less = g * sl_less[None, :] @ gd
            g_great = g * sl_great[None, :] @ gd
            s_less = self._less_diag(w, T_lead, sel_lead)
            s_great = self._great_diag(w, T_lead, sel_lead)
            # Tr[diag(s<) G> - diag(s>) G<]
            val = jnp.sum(s_less * jnp.diagonal(g_great)) - \
                jnp.sum(s_great * jnp.diagonal(g_less))
            return jnp.real(val)

        integrand = np.asarray(jax.lax.map(jax.jit(one), jnp.asarray(ws),
                                           batch_size=self.batch_size))
        f = self.rpc * ws / (2 * np.pi) * integrand
        return float(np.trapezoid(f, ws)) * 1.60217662e2

    def write_v_sim(self, filename="anime.ascii"):
        """v_sim 3.7 phonon-mode file (negf.py:279-298): box, positions,
        and every eigenmode as a #metaData qpt block with mass-unweighted
        displacement vectors."""
        if self.els is None or self.xyz is None or self.boxhi is None:
            raise ValueError("write_v_sim needs els/xyz/box metadata")
        from sclmd_jax.units import get_atomname
        text = "# Generated file for v_sim 3.7\n"
        text += "%15.9f%15.9f%15.9f\n" % (self.boxhi[0], self.boxlo[2],
                                          self.boxhi[1])
        text += "%15.9f%15.9f%15.9f\n" % (self.boxlo[0], self.boxlo[1],
                                          self.boxhi[2])
        for i in range(len(self.els) // 3):
            text += "%15.9f%15.9f%15.9f %2s\n" % (
                self.xyz[3 * i], self.xyz[3 * i + 1], self.xyz[3 * i + 2],
                get_atomname(self.els[3 * i]))
        for i, a in enumerate(self.omegas):
            text += "#metaData: qpt=[%f;%f;%f;%f \\\n" % (0, 0, 0, a)
            for u in range(len(self.els) // 3):
                text += "#; %f; %f; %f; %f; %f; %f \\\n" % (
                    self.eigvecs[i, 3 * u] / self.els[3 * u] ** 0.5,
                    self.eigvecs[i, 3 * u + 1] / self.els[3 * u] ** 0.5,
                    self.eigvecs[i, 3 * u + 2] / self.els[3 * u] ** 0.5,
                    0, 0, 0)
            text += "# ]\n"
        with open(filename, "w") as fh:
            fh.write(text)

    def plotresult(self, lines=180):
        from matplotlib import pyplot as plt
        plt.figure(0)
        plt.hist(self.omegas, bins=lines)
        plt.xlabel("Frequence(eV)")
        plt.ylabel("Number")
        plt.savefig("omegas.png")
        plt.figure(1)
        plt.plot(self.tmnumber[:, 0] * self.rpc, self.tmnumber[:, 1])
        plt.xlabel("Frequence(eV)")
        plt.ylabel("Transmission")
        plt.savefig("transmission.png")


def landauer_current_natural(omegas, transmission, TL, TR):
    """Landauer heat current in natural units (eV frequencies, hbar=1):
    J = (1/2pi) int dw w T(w) (n_B(w,TL) - n_B(w,TR)), trapezoid rule.
    Multiply by units.CURCOF for nW. Companion to the MD heat current for
    the MD-vs-NEGF cross-check.
    """
    from sclmd_jax.ops.functions import bose
    omegas = jnp.asarray(omegas)
    tr = jnp.asarray(transmission)
    occ = bose(omegas, TL) - bose(omegas, TR)
    f = omegas * tr * occ / (2 * jnp.pi)
    return jnp.trapezoid(f, omegas)
