"""EAM metal family: analytic Sutton-Chen, setfl tables, splines.

The reference reaches EAM only through LAMMPS ``pair_style eam/alloy``
(ref lammpsdriver.py force path); these tests pin the JAX
implementation against published lattice constants, an independent
NumPy linear-interpolation oracle, and the MD scan.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sclmd_jax.models.eam import (
    EAMDriver, SUTTON_CHEN_PARAMS, eam_tabulated_energy, fcc_cell,
    read_setfl, sutton_chen_tables, write_setfl)


def _small_cu(rcut=None):
    """2x2x2 periodic Cu cell; rcut covering the first fcc shell only
    so the minimum image stays valid (L = 7.22 > 2 (rcut + skin))."""
    a0 = SUTTON_CHEN_PARAMS["Cu"]["a"]
    pos, cell = fcc_cell(2, 2, 2, a0)
    axyz = [["Cu"] + list(p) for p in pos]
    return axyz, cell, (0.9 * a0 if rcut is None else rcut)


class TestSuttonChen:
    def test_driver_protocol(self):
        axyz, cell, rc = _small_cu()
        drv = EAMDriver(axyz, cell=cell, rcut=rc)
        n = 3 * len(axyz)
        # perfect periodic fcc: every site inversion-symmetric -> f0 = 0
        np.testing.assert_allclose(np.asarray(drv.f0), 0.0, atol=1e-9)
        q = np.zeros(n)
        q[0] = 0.01
        f = np.asarray(drv.force(q))
        assert f.shape == (n,)
        assert np.isfinite(f).all()
        # displaced along +x -> restoring force back along -x
        assert f[0] < 0.0

    def test_cohesion_and_equilibrium_lattice(self):
        """Energy per atom is minimised within 2% of the published
        Sutton-Chen lattice constant, and the cohesive energy is in
        the fitted range (Cu: about -3.5 eV/atom)."""
        p = SUTTON_CHEN_PARAMS["Cu"]
        scales = np.linspace(0.94, 1.06, 13)
        epa = []
        for s in scales:
            pos, cell = fcc_cell(4, 4, 4, s * p["a"])
            axyz = [["Cu"] + list(x) for x in pos]
            drv = EAMDriver(axyz, cell=cell)
            epa.append(drv.energy() / len(axyz))
        epa = np.array(epa)
        s_min = scales[np.argmin(epa)]
        assert abs(s_min - 1.0) <= 0.02, (s_min, epa)
        assert -4.2 < epa.min() < -2.8, epa.min()

    # experimental cohesive energies the Sutton-Chen sets were fit to
    ECOH = {"Ni": 4.44, "Cu": 3.49, "Rh": 5.75, "Pd": 3.89,
            "Ag": 2.95, "Ir": 6.94, "Pt": 5.84, "Au": 3.81,
            "Al": 3.39, "Pb": 2.03}

    @pytest.mark.slow
    @pytest.mark.parametrize("el", sorted(SUTTON_CHEN_PARAMS))
    def test_all_elements_lattice_and_cohesion(self, el):
        """Joint consistency of every parameter set: energy/atom is
        minimised AT the published lattice constant (couples c, n, m,
        a) and matches the fitted experimental cohesive energy within
        truncation error (couples eps*c)."""
        p = SUTTON_CHEN_PARAMS[el]
        scales = np.linspace(0.96, 1.04, 9)
        epa = []
        for s in scales:
            pos, cell = fcc_cell(4, 4, 4, s * p["a"])
            drv = EAMDriver([[el] + list(x) for x in pos], cell=cell)
            epa.append(drv.energy() / len(pos))
        epa = np.array(epa)
        assert scales[np.argmin(epa)] == pytest.approx(1.0, abs=0.011)
        assert epa.min() == pytest.approx(-self.ECOH[el], rel=0.07)

    def test_dynmat_translation_invariance(self):
        """Rigid translation is a zero mode of the dynamical matrix
        (exact for the periodic lattice, strained or not)."""
        axyz, cell, rc = _small_cu()
        drv = EAMDriver(axyz, cell=cell, rcut=rc)
        d = np.asarray(drv.dynmat())
        np.testing.assert_allclose(d, d.T, atol=1e-10)
        n = len(axyz)
        for ax in range(3):
            v = np.zeros(3 * n)
            v[ax::3] = 1.0  # single element: conv uniform
            resid = np.abs(d @ v).max() / np.abs(d).max()
            assert resid < 1e-8, (ax, resid)

    def test_nve_energy_conservation(self):
        from sclmd_jax.md import GLESystem, initial_state, run_segment

        axyz, cell, rc = _small_cu()
        drv = EAMDriver(axyz, cell=cell, rcut=rc)
        nph = 3 * len(axyz)
        dt = 0.05
        system = GLESystem(dyn=None, baths=(), mask=jnp.ones(nph),
                           dt=dt, nph=nph, ml=1, nmd=512,
                           force_fn=drv.force_jax)
        st = initial_state(system, dtype=jnp.float64)
        key = jax.random.PRNGKey(3)
        st = st.replace(p=0.02 * jax.random.normal(key, (nph,),
                                                   jnp.float64))

        def etot(s):
            ke = 0.5 * float(jnp.dot(s.p, s.p))
            pe = float(drv.energy(np.asarray(s.q))) - float(drv.energy())
            return ke + pe

        e0 = etot(st)
        fin, _ = run_segment(system, st, 512)
        e1 = etot(fin)
        assert np.isfinite(np.asarray(fin.q)).all()
        assert abs(e1 - e0) < 2e-3 * max(abs(e0), 1e-3), (e0, e1)


class TestSetfl:
    def test_roundtrip_and_tabulated_matches_analytic(self, tmp_path):
        """write_setfl -> read_setfl is exact, and the spline-tabulated
        driver reproduces the analytic Sutton-Chen energies/forces."""
        tbl = sutton_chen_tables("Cu", rcut=0.9 * 3.61)
        path = tmp_path / "Cu.sc.eam.alloy"
        write_setfl(path, tbl["elements"], [63.546], tbl["F"],
                    tbl["rho"], tbl["rphi"], tbl["drho"], tbl["dr"],
                    tbl["cutoff"])
        back = read_setfl(str(path))
        assert back["elements"] == ["Cu"]
        np.testing.assert_allclose(back["F"], tbl["F"], rtol=1e-12)
        np.testing.assert_allclose(back["rho"], tbl["rho"], rtol=1e-12)
        np.testing.assert_allclose(back["rphi"], tbl["rphi"], rtol=1e-12)
        assert back["nr"] == tbl["nr"] and back["drho"] == tbl["drho"]

        axyz, cell, rc = _small_cu()
        ana = EAMDriver(axyz, cell=cell, rcut=rc)
        tab = EAMDriver(axyz, cell=cell, setfl=str(path))
        q = 0.02 * np.sin(np.arange(3 * len(axyz)))
        ea, et = ana.energy(q), tab.energy(q)
        assert abs(ea - et) < 1e-4 * abs(ea), (ea, et)
        fa, ft = np.asarray(ana.force(q)), np.asarray(tab.force(q))
        np.testing.assert_allclose(ft, fa, atol=5e-4 * np.abs(fa).max())

    def test_multielement_against_numpy_oracle(self):
        """Two-element alloy tables evaluated by the JAX spline path
        match an independent NumPy linear-interpolation evaluation."""
        rc = 4.6
        cu = sutton_chen_tables("Cu", rcut=rc)
        ni = sutton_chen_tables("Ni", rcut=rc)
        nr, dr = cu["nr"], cu["dr"]
        assert ni["nr"] == nr and abs(ni["dr"] - dr) < 1e-15
        # common rho grid: take Cu's (Ni F re-tabulated onto it)
        drho, nrho = cu["drho"], cu["nrho"]
        rho_grid = np.arange(nrho) * drho
        p_ni = SUTTON_CHEN_PARAMS["Ni"]
        F = np.stack([cu["F"][0],
                      -p_ni["eps"] * p_ni["c"] * np.sqrt(rho_grid)])
        rho = np.stack([cu["rho"][0], ni["rho"][0]])
        cross = 0.5 * (cu["rphi"][0] + ni["rphi"][0])
        rphi = np.stack([cu["rphi"][0], cross, ni["rphi"][0]])
        pair_index = np.array([[0, 1], [1, 2]], np.int32)
        tbl = dict(elements=["Cu", "Ni"], mass=np.array([63.5, 58.7]),
                   nrho=nrho, drho=drho, nr=nr, dr=dr, cutoff=rc,
                   F=F, rho=rho, rphi=rphi, pair_index=pair_index)

        # mixed finite cluster (no pbc), alternating types
        pos, _ = fcc_cell(2, 2, 1, 3.58)
        rng = np.random.default_rng(5)
        pos = pos + 0.05 * rng.standard_normal(pos.shape)
        types = np.arange(len(pos)) % 2
        from sclmd_jax.models.nnp import build_neighbors
        nbr, mask = build_neighbors(pos, rc, None, skin=0.3)
        efn = eam_tabulated_energy(tbl, types, nbr, mask)
        e_jax = float(efn(jnp.asarray(pos)))

        # independent numpy oracle
        r_grid = np.arange(nr) * dr
        dmat = np.linalg.norm(pos[None] - pos[:, None], axis=-1)
        np.fill_diagonal(dmat, np.inf)
        e_pair = 0.0
        rho_i = np.zeros(len(pos))
        for i in range(len(pos)):
            for j in range(len(pos)):
                r = dmat[i, j]
                if r >= rc or i == j:
                    continue
                k = pair_index[types[i], types[j]]
                e_pair += 0.5 * np.interp(r, r_grid, rphi[k]) / r
                rho_i[i] += np.interp(r, r_grid, rho[types[j]])
        e_emb = sum(np.interp(rho_i[i], rho_grid, F[types[i]])
                    for i in range(len(pos)))
        e_np = e_pair + e_emb
        assert abs(e_jax - e_np) < 2e-4 * abs(e_np), (e_jax, e_np)

    def test_setfl_missing_element_raises(self, tmp_path):
        tbl = sutton_chen_tables("Cu", rcut=3.2)
        path = tmp_path / "Cu.eam.alloy"
        write_setfl(path, tbl["elements"], [63.546], tbl["F"],
                    tbl["rho"], tbl["rphi"], tbl["drho"], tbl["dr"],
                    tbl["cutoff"])
        axyz = [["Au", 0.0, 0.0, 0.0], ["Au", 2.0, 0.0, 0.0]]
        with pytest.raises(ValueError):
            EAMDriver(axyz, setfl=str(path))


class TestEAMTransport:
    def test_bpt_from_driver_object(self):
        """NEGF workflow from an EAM driver: dynamical matrix ->
        transmission on a small Cu slab."""
        from sclmd_jax.negf import bpt

        axyz, cell, rc = _small_cu()
        drv = EAMDriver(axyz, cell=cell, rcut=rc)
        n = 3 * len(axyz)
        bathL = list(range(6))
        bathR = list(range(n - 6, n))
        b = bpt(drv, 0.02, 1.0, [bathL, bathR], num=10)
        tm = b.gettm()
        assert tm.shape == (11, 2)
        assert np.isfinite(tm).all()
