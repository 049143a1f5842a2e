"""Ingest trained DeepMD-kit frozen models (.pb) — no TensorFlow needed.

The reference loads trained neural potentials through deepmd-kit's
``DeepPot(graph.pb)`` (/root/reference/sclmd/deepmddriver.py:52-64,
TensorFlow C++ runtime). This container has no TF, so reference users'
models are ported by (a) extracting every weight from the frozen
GraphDef with the pure-Python wire parser (utils/tfpb.py) and (b)
re-evaluating the DeepMD ``se_a`` descriptor + energy fitting network
in JAX — inside the jitted MD step like every other driver here, not
as a host callback.

Faithful to the published se_a recipe (DeepMD-kit v1/v2 variable
naming):

  * type-blocked neighbor slots (``sel`` per neighbor type),
  * s(r) = (1/r) * C2 switch between rcut_smth and rcut,
  * environment rows (s, s x/r, s y/r, s z/r), standardized by the
    trained per-center-type t_avg/t_std (zero rows for empty slots are
    standardized too — matching prod_env_mat),
  * embedding nets ``filter_type_{i}/matrix_{l}_{j}`` (or
    ``filter_type_all/...`` for type_one_side) with DeepMD's resnet
    rule (skip when widths match, duplicate-concat skip when doubled),
  * D_i = (G^T R / nnei)(R^T G_<M2> / nnei) flattened,
  * fitting nets ``layer_{l}_type_{t}`` (+ optional resnet ``idt``) and
    ``final_layer_type_{t}``.

Caveat (stated, not hidden): with no TF in the image the evaluator
cannot be bit-checked against deepmd-kit's output here; it is pinned
instead by a synthetic-graph round-trip + physics invariances
(tests/test_nnp.py). Hyperparameters a frozen graph does not store as
Const nodes (older graphs may lack ``descrpt_attr/sel`` or
``rcut_smth``) can be overridden by keyword.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from sclmd_jax.models.driver import DriverShell
from sclmd_jax.models.nnp import smooth_switch
from sclmd_jax.utils.tfpb import read_graph_consts


def _get(consts, name, override=None, required=True):
    if override is not None:
        return override
    if name in consts:
        return consts[name]
    if required:
        have = ", ".join(sorted(consts)[:40])
        raise KeyError(
            f"frozen graph lacks Const node {name!r} (older DeepMD "
            f"graphs may not store it) — pass it as a keyword override. "
            f"Found consts: {have} ...")
    return None


def _collect_net(consts, scope_fmt, nl_max=16):
    """Layers [(W, b, idt-or-None), ...] for a variable scope pattern.
    ``scope_fmt`` contains one ``{l}`` placeholder for the layer id."""
    layers = []
    for l in range(nl_max):
        wk = scope_fmt.format(l=l) + "/matrix"
        bk = scope_fmt.format(l=l) + "/bias"
        if wk not in consts:
            break
        idt = consts.get(scope_fmt.format(l=l) + "/idt")
        layers.append((np.asarray(consts[wk]), np.asarray(consts[bk]),
                       None if idt is None else np.asarray(idt)))
    return layers


def _resnet_apply(layers, x, final=None):
    """DeepMD embedding/fitting net: tanh layers with the resnet rule
    (y += x when widths match; y += concat(x, x) when doubled; the
    trained ``idt`` gates the residual branch when present)."""
    for w, b, idt in layers:
        y = jnp.tanh(x @ w + b)
        if idt is not None:
            y = y * idt
        if w.shape[1] == w.shape[0]:
            x = x + y
        elif w.shape[1] == 2 * w.shape[0]:
            x = jnp.concatenate([x, x], axis=-1) + y
        else:
            x = y
    if final is not None:
        w, b, _ = final
        x = x @ w + b
    return x


def build_typed_neighbors(xyz, types, sel, rcut,
                          cell: Optional[np.ndarray] = None):
    """Type-blocked padded neighbor table (DeepMD slot layout).

    Slot block t holds the (distance-sorted) neighbors of type t,
    ``sel[t]`` slots wide, -1 padding. Raises if any block overflows —
    matching deepmd-kit's hard sel limit.
    """
    x = np.asarray(xyz, float).reshape(-1, 3)
    types = np.asarray(types)
    na = len(x)
    d = x[None] - x[:, None]
    if cell is not None:
        d -= np.round(d / np.asarray(cell)) * np.asarray(cell)
    r = np.sqrt((d ** 2).sum(-1))
    np.fill_diagonal(r, np.inf)
    nnei = int(sum(sel))
    nbr = np.full((na, nnei), -1, dtype=np.int64)
    off = np.concatenate([[0], np.cumsum(sel)]).astype(int)
    for i in range(na):
        for t, st in enumerate(sel):
            ids = np.where((types == t) & (r[i] < rcut))[0]
            ids = ids[np.argsort(r[i][ids], kind="stable")]
            if len(ids) > st:
                raise ValueError(
                    f"atom {i}: {len(ids)} type-{t} neighbors exceed "
                    f"sel[{t}]={st} (model trained with too small a "
                    "sel for this structure)")
            nbr[i, off[t]:off[t] + len(ids)] = ids
    return nbr


class DeepPotPB:
    """JAX evaluator over weights imported from a DeepMD .pb graph.

    Drop-in for ``DeepPotSE`` in the ``deepmddriver`` wrapper: exposes
    ``energy_fn()`` (positions (na, 3) angstrom -> energy eV) and
    ``load(path)``.
    """

    def __init__(self, pb, els: Sequence[str], xyz, cell=None,
                 dtype=jnp.float64, sel=None, rcut=None, rcut_smth=None,
                 type_map=None):
        self.els = list(els)
        self.xyz0 = np.asarray(xyz, float).reshape(-1, 3)
        self.cell = None if cell is None else np.asarray(cell, float)
        self.dtype = dtype
        self._overrides = dict(sel=sel, rcut=rcut, rcut_smth=rcut_smth,
                               type_map=type_map)
        self.load(pb)

    # -- import ------------------------------------------------------------
    def load(self, pb):
        ov = self._overrides
        consts, _ = read_graph_consts(pb)
        tmap = ov["type_map"]
        if tmap is None:
            raw = _get(consts, "model_attr/tmap", required=False)
            if raw is None:
                raise KeyError("graph lacks model_attr/tmap — pass "
                               "type_map=['C', 'H', ...]")
            tmap = raw.decode() if isinstance(raw, bytes) else str(raw)
            tmap = tmap.split()
        self.type_map = list(tmap)
        self.ntypes = int(np.asarray(_get(
            consts, "descrpt_attr/ntypes", len(self.type_map))))
        self.rcut = float(np.asarray(_get(
            consts, "descrpt_attr/rcut", ov["rcut"])))
        rs = _get(consts, "descrpt_attr/rcut_smth", ov["rcut_smth"],
                  required=False)
        self.rcut_smth = float(np.asarray(rs)) if rs is not None \
            else 0.5 * self.rcut
        sel = _get(consts, "descrpt_attr/sel", ov["sel"])
        self.sel = [int(s) for s in np.asarray(sel).ravel()]
        nnei = sum(self.sel)

        t_avg = np.asarray(_get(consts, "descrpt_attr/t_avg"))
        t_std = np.asarray(_get(consts, "descrpt_attr/t_std"))
        self.t_avg = t_avg.reshape(self.ntypes, nnei, 4)
        self.t_std = t_std.reshape(self.ntypes, nnei, 4)

        # embedding nets: per (center, neighbor) pair, or one_side
        self.one_side = any(k.startswith("filter_type_all/")
                            for k in consts)
        emb = {}
        for ti in range(1 if self.one_side else self.ntypes):
            for tj in range(self.ntypes):
                if self.one_side:
                    scope = f"filter_type_all/matrix_{{l}}_{tj}"
                    bscope = f"filter_type_all/bias_{{l}}_{tj}"
                else:
                    scope = f"filter_type_{ti}/matrix_{{l}}_{tj}"
                    bscope = f"filter_type_{ti}/bias_{{l}}_{tj}"
                layers = []
                for l in range(16):
                    wk = scope.format(l=l)
                    bk = bscope.format(l=l)
                    if wk not in consts:
                        break
                    layers.append((np.asarray(consts[wk]),
                                   np.asarray(consts[bk]), None))
                if layers:
                    emb[(ti, tj)] = layers
        if not emb:
            raise KeyError("no filter_type_* embedding weights found in "
                           "the graph")
        self.embed = emb
        self.m1 = list(emb.values())[0][-1][0].shape[1]

        # fitting nets per center type
        self.fit = {}
        self.final = {}
        for t in range(self.ntypes):
            layers = _collect_net(consts, "layer_{l}_type_%d" % t)
            fw = consts.get(f"final_layer_type_{t}/matrix")
            fb = consts.get(f"final_layer_type_{t}/bias")
            if fw is None:
                raise KeyError(f"final_layer_type_{t}/matrix missing")
            self.fit[t] = layers
            self.final[t] = (np.asarray(fw), np.asarray(fb), None)
        # M2 from fitting input width: ndesc = M1 * M2
        ndesc = (self.fit[0][0][0].shape[0] if self.fit[0]
                 else self.final[0][0].shape[0])
        self.m2 = ndesc // self.m1

        self.types = np.array([self.type_map.index(e) for e in self.els],
                              dtype=np.int32)
        self.nbr = build_typed_neighbors(self.xyz0, self.types, self.sel,
                                         self.rcut, cell=self.cell)
        self._slot_type = np.concatenate(
            [np.full(s, t, np.int32) for t, s in enumerate(self.sel)])
        return self

    # -- evaluation ----------------------------------------------------
    def energy(self, x):
        """Total energy (eV) at positions x (na, 3) angstrom."""
        dt = self.dtype
        x = jnp.asarray(x, dt).reshape(-1, 3)
        nbr = jnp.asarray(self.nbr)
        mask = nbr >= 0
        xj = x[jnp.where(mask, nbr, 0)]
        d = xj - x[:, None, :]
        if self.cell is not None:
            cell = jnp.asarray(self.cell, dt)
            d = d - jnp.round(d / cell) * cell
        r2 = jnp.sum(d * d, -1)
        r = jnp.sqrt(jnp.where(mask, r2, 1.0))
        sw = smooth_switch(r, self.rcut_smth, self.rcut)
        s = jnp.where(mask, sw / r, 0.0)
        rhat = jnp.where(mask[..., None], d / r[..., None], 0.0)
        R = jnp.concatenate([s[..., None], s[..., None] * rhat], -1)
        # standardize by CENTER type (empty slots too: (0-avg)/std)
        avg = jnp.asarray(self.t_avg, dt)[self.types]
        std = jnp.asarray(self.t_std, dt)[self.types]
        Rn = (R - avg) / std                        # (na, nnei, 4)

        # per-pair embedding of the standardized s channel
        s_in = Rn[..., :1]                          # (na, nnei, 1)
        nnei = R.shape[1]
        G = jnp.zeros((x.shape[0], nnei, self.m1), dt)
        ctype = jnp.asarray(self.types)
        slot_t = jnp.asarray(self._slot_type)
        for (ti, tj), layers in self.embed.items():
            layers_j = [(jnp.asarray(w, dt), jnp.asarray(b, dt), None)
                        for w, b, _ in layers]
            g = _resnet_apply(layers_j, s_in)
            pick = (slot_t == tj)[None, :, None]
            if not self.one_side:
                pick = pick & (ctype == ti)[:, None, None]
            G = jnp.where(pick, g, G)

        ga = jnp.einsum("ink,inl->ikl", G, Rn) / nnei    # (na, M1, 4)
        gb = ga[:, : self.m2, :]
        D = jnp.einsum("ikl,iml->ikm", ga, gb).reshape(x.shape[0], -1)

        e_at = jnp.zeros((x.shape[0],), dt)
        for t in range(self.ntypes):
            layers_j = [(jnp.asarray(w, dt), jnp.asarray(b, dt),
                         None if i is None else jnp.asarray(i, dt))
                        for w, b, i in self.fit[t]]
            fw, fb, _ = self.final[t]
            et = _resnet_apply(
                layers_j, D,
                final=(jnp.asarray(fw, dt), jnp.asarray(fb, dt), None))
            e_at = jnp.where(ctype == t, et[:, 0], e_at)
        return jnp.sum(e_at)

    def energy_fn(self, params=None):
        return lambda x: self.energy(x)

    def forces(self, x):
        return -jax.grad(lambda xx: self.energy(xx.reshape(-1, 3)))(
            jnp.asarray(x, self.dtype))


def deepmd_pb_driver(pb, axyz, cell=None, dtype=jnp.float64, **overrides):
    """Reference-workflow entry: frozen .pb + structure -> force driver
    (the deepmddriver protocol), ready for md.AddPotential."""
    from sclmd_jax.models.nnp import deepmddriver

    els = [a[0] for a in axyz]
    xyz = np.array([a[1:] for a in axyz], float)
    model = DeepPotPB(pb, els, xyz, cell=cell, dtype=dtype, **overrides)
    return deepmddriver(model, axyz, dtype=dtype)
