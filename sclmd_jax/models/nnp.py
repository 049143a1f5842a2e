"""DeepMD-style neural-network potential, fully on-device.

Replaces the reference's deepmddriver.py (TensorFlow DeepPot evaluated on
the host each step): here the descriptor + MLP run as jnp inside the
jitted MD scan, so the NN force path never leaves the device
(BASELINE.json config 4). Architecture follows the DeepMD-SE ("smooth
edition") recipe:

  * per-neighbor smooth weight s(r) = 1/r * switch(r; r_on, r_cut)
  * generalized coordinates R_ij = s(r) * (1, x/r, y/r, z/r)
  * per-type-pair embedding MLP  e(s)  -> (naxis,) features
  * symmetric descriptor D_i = (E^T R)(R^T E') / nnei^2 flattened
  * per-type fitting MLP -> atomic energy; total E = sum_i E_i

Static neighbor lists (max_nnei padding, masked) keep shapes fixed for
XLA. Training utilities (energy+force loss with optax) and npz
checkpointing included — the reference delegates training to
deepmd-kit (tools.py:262-295 only preps data).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from sclmd_jax.models.driver import DriverShell


# ---------------------------------------------------------------------------
# neighbor lists (static, padded)
# ---------------------------------------------------------------------------
def build_neighbors(xyz, cutoff: float, max_nnei: int,
                    cell: Optional[np.ndarray] = None, skin: float = 0.5,
                    backend: str = "auto"):
    """Padded neighbor table (na, max_nnei) + mask from the reference
    geometry. Index -1 marks padding (mapped to self with zero weight).

    ``backend``: "numpy" (O(na^2), always available), "native" (C++
    cell lists from csrc/neighbors.cpp, O(na) at fixed density), or
    "auto" — native for large systems when the toolchain builds it,
    numpy otherwise. Both produce identical tables.
    """
    x = np.asarray(xyz).reshape(-1, 3)
    na = len(x)
    if max_nnei is None:
        # auto-size: build with a generous cap, then shrink the table to
        # the observed occupancy (rounded up to a multiple of 4). The
        # three-body cost of the many-body potentials scales as nn^2, so
        # a tight table is a large win (diamond Si: 4 real neighbors vs
        # a 16-wide default). Grow the cap if saturated (EAM-class
        # cutoffs of ~2 lattice constants see ~80 fcc neighbors).
        cap = 64
        while True:
            nbr, mask = build_neighbors(x, cutoff, cap, cell=cell,
                                        skin=skin, backend=backend)
            occ = int(mask.sum(1).max()) if mask.any() else 1
            if occ < cap or cap >= 1024:
                break
            cap *= 2
        nn = max(4, -(-occ // 4) * 4)
        return nbr[:, :nn], mask[:, :nn]
    if backend == "native" or (backend == "auto" and na > 2000):
        try:
            from sclmd_jax.models.native import native_neighbors
            nbr, mask, _ = native_neighbors(x, cutoff + skin, max_nnei,
                                            cell=cell)
            return nbr, mask
        except Exception:
            if backend == "native":
                raise
            # auto: fall back to the numpy builder
    d = x[None, :, :] - x[:, None, :]
    if cell is not None:
        d -= np.round(d / np.asarray(cell)) * np.asarray(cell)
    r = np.sqrt((d ** 2).sum(-1))
    np.fill_diagonal(r, np.inf)
    nbr = np.full((na, max_nnei), -1, dtype=np.int64)
    for i in range(na):
        js = np.nonzero(r[i] < cutoff + skin)[0]
        js = js[np.argsort(r[i][js])][:max_nnei]
        nbr[i, : len(js)] = js
    mask = nbr >= 0
    return np.where(mask, nbr, 0), mask


def smooth_switch(r, r_on, r_cut):
    """C2-smooth switching function: 1 below r_on, 0 above r_cut."""
    u = (r - r_on) / (r_cut - r_on)
    u = jnp.clip(u, 0.0, 1.0)
    sw = 1.0 - 6 * u ** 5 + 15 * u ** 4 - 10 * u ** 3
    return sw


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------
def _mlp_params(key, sizes, dtype):
    params = []
    for i in range(len(sizes) - 1):
        key, k1, k2 = jax.random.split(key, 3)
        w = jax.random.normal(k1, (sizes[i], sizes[i + 1]),
                              dtype) / np.sqrt(sizes[i])
        b = jnp.zeros((sizes[i + 1],), dtype)
        params.append((w, b))
    return params


def _mlp_apply(params, x):
    for i, (w, b) in enumerate(params):
        x = x @ w + b
        if i < len(params) - 1:
            x = jnp.tanh(x)
    return x


class DeepPotSE:
    """Smooth-edition descriptor + fitting network.

    Parameters
    ----------
    types : (na,) int array of atom type ids (0-based).
    ntypes : number of distinct types.
    rcut, rcut_smth : outer/inner cutoff radii (angstrom).
    neighbors, nmask : static neighbor table from build_neighbors.
    embed_sizes / fit_sizes : hidden layer widths.
    naxis : number of embedding columns kept on the second factor.
    """

    def __init__(self, types, ntypes, rcut, rcut_smth, neighbors, nmask,
                 embed_sizes=(16, 32), fit_sizes=(32, 32), naxis=4,
                 cell=None, dtype=jnp.float32, seed=0):
        self.types = jnp.asarray(np.asarray(types, dtype=np.int32))
        self.ntypes = int(ntypes)
        self.rcut = float(rcut)
        self.rcut_smth = float(rcut_smth)
        self.nbr = jnp.asarray(neighbors)
        self.nmask = jnp.asarray(nmask)
        self.naxis = int(naxis)
        self.dtype = dtype
        self.cell = None if cell is None else jnp.asarray(cell, dtype)
        self.embed_sizes = tuple(embed_sizes)
        self.fit_sizes = tuple(fit_sizes)
        self.params = self.init_params(jax.random.PRNGKey(seed))

    def init_params(self, key):
        nemb = self.embed_sizes[-1]
        ndesc = nemb * self.naxis
        params = {"embed": [], "fit": []}
        for tp in range(self.ntypes):   # embedding net per NEIGHBOR type
            key, sub = jax.random.split(key)
            params["embed"].append(
                _mlp_params(sub, (1,) + self.embed_sizes, self.dtype))
        for tp in range(self.ntypes):   # fitting net per CENTER type
            key, sub = jax.random.split(key)
            params["fit"].append(
                _mlp_params(sub, (ndesc,) + self.fit_sizes + (1,),
                            self.dtype))
        return params

    # -- energy ------------------------------------------------------------
    def energy(self, params, x):
        """Total potential energy (eV) for positions x (na, 3)."""
        x = jnp.asarray(x, self.dtype)
        xi = x[:, None, :]                       # (na, 1, 3)
        xj = x[self.nbr]                         # (na, nn, 3)
        d = xj - xi
        if self.cell is not None:
            d = d - jnp.round(d / self.cell) * self.cell
        r2 = jnp.sum(d * d, axis=-1)
        r = jnp.sqrt(jnp.where(self.nmask, r2, 1.0))
        sw = smooth_switch(r, self.rcut_smth, self.rcut)
        s = jnp.where(self.nmask, sw / r, 0.0)   # (na, nn)
        # generalized coordinates (na, nn, 4)
        rhat = d / r[..., None]
        R = jnp.concatenate([s[..., None], s[..., None] * rhat], axis=-1)

        # per-neighbor-type embedding of s
        ntype = self.types[self.nbr]             # (na, nn)
        s_in = s[..., None]                      # (na, nn, 1)
        emb = jnp.zeros(s.shape + (self.embed_sizes[-1],), self.dtype)
        for tp in range(self.ntypes):
            e_tp = _mlp_apply(params["embed"][tp], s_in)
            emb = jnp.where((ntype == tp)[..., None], e_tp, emb)
        emb = jnp.where(self.nmask[..., None], emb, 0.0)

        nn = self.nbr.shape[1]
        G = jnp.einsum("ink,inl->ikl", emb, R) / nn     # (na, nemb, 4)
        Gsub = G[:, : self.naxis, :]                     # (na, naxis, 4)
        D = jnp.einsum("ikl,iml->ikm", G, Gsub)          # (na, nemb, naxis)
        D = D.reshape(D.shape[0], -1)

        e_at = jnp.zeros((D.shape[0],), self.dtype)
        for tp in range(self.ntypes):
            e_tp = _mlp_apply(params["fit"][tp], D)[:, 0]
            e_at = jnp.where(self.types == tp, e_tp, e_at)
        return jnp.sum(e_at)

    def energy_fn(self, params=None):
        p = params if params is not None else self.params
        return lambda x: self.energy(p, x)

    def forces(self, params, x):
        return -jax.grad(lambda xx: self.energy(params, xx))(x)

    # -- training ----------------------------------------------------------
    def loss(self, params, batch, wf: float = 10.0):
        """Energy + force MSE: batch = dict(x (nb,na,3), e (nb,),
        f (nb,na,3))."""
        def one(x, e, f):
            ep = self.energy(params, x)
            fp = self.forces(params, x)
            na = x.shape[0]
            return ((ep - e) / na) ** 2 + wf * jnp.mean((fp - f) ** 2)
        return jnp.mean(jax.vmap(one)(batch["x"], batch["e"], batch["f"]))

    def fit(self, data, steps=500, lr=1e-3, wf: float = 10.0,
            params=None, verbose=False):
        """Train on {x, e, f} arrays with Adam; returns trained params."""
        import optax
        params = params if params is not None else self.params
        opt = optax.adam(lr)
        state = opt.init(params)

        @jax.jit
        def step(params, state, batch):
            l, g = jax.value_and_grad(self.loss)(params, batch, wf)
            updates, state = opt.update(g, state)
            return optax.apply_updates(params, updates), state, l

        for i in range(steps):
            params, state, l = step(params, state, data)
            if verbose and i % 100 == 0:
                print(f"nnp.fit step {i}: loss {float(l):.3e}")
        self.params = params
        return params

    # -- persistence -------------------------------------------------------
    def save(self, path):
        flat, treedef = jax.tree_util.tree_flatten(self.params)
        np.savez(path, n=len(flat),
                 **{f"p{i}": np.asarray(a) for i, a in enumerate(flat)})

    def load(self, path):
        data = np.load(path)
        flat = [jnp.asarray(data[f"p{i}"]) for i in range(int(data["n"]))]
        treedef = jax.tree_util.tree_structure(self.params)
        self.params = jax.tree_util.tree_unflatten(treedef, flat)
        return self.params


class deepmddriver(DriverShell):
    """Reference-compatible NN-potential force driver
    (deepmddriver.py:11-75): same protocol (.axyz/.conv/.f0/.force/
    .energy), but the model evaluates inside the jitted MD step.

    ``model`` is a DeepPotSE (or anything with ``energy_fn()``).
    """

    def __init__(self, model, axyz, md2ang=0.06466, dtype=jnp.float32):
        self.model = model
        self._md2ang = md2ang
        self._dtype = dtype
        self._axyz = axyz
        self.refresh()

    def refresh(self):
        """Rebind the driver to the model's CURRENT parameters.

        The jitted force path captures parameters at trace time, so a
        driver built before ``model.fit`` would silently keep the
        untrained network — call refresh() (or construct the driver)
        AFTER training.
        """
        self._attach(self.model.energy_fn(), self._axyz, self._dtype,
                     md2ang=self._md2ang)

    # -- reference-named launchers (deepmddriver.py:16-56) ------------
    def dpstart(self, path):
        """Load persisted model parameters and rebind the force path —
        the analog of the reference's DeepPot(.pb) launch
        (deepmddriver.py:52-56)."""
        self.model.load(path)
        self.refresh()
        self.initforce()

    def deepmdstr(self, strinfile, fmt, label="LabeledSystem",
                  atomname=None, md2ang=0.06466):
        """dpdata-based structure ingestion (deepmddriver.py:16-50);
        dpdata is gated in this image — construct the driver from an
        ``axyz`` list instead."""
        try:
            import dpdata  # gated
        except ImportError as e:
            raise ImportError(
                "deepmdstr needs dpdata (not in this image); pass axyz "
                "to the constructor instead") from e
        cls = getattr(dpdata, label)
        sysd = cls(strinfile, fmt)
        names = atomname if label == "System" else sysd["atom_names"]
        types = sysd["atom_types"]
        xyz = np.asarray(sysd["coords"][0])
        axyz = [[names[t]] + list(xyz[i]) for i, t in enumerate(types)]
        self._axyz = axyz
        self._md2ang = md2ang
        self.refresh()
        return axyz
