"""C/H junction driver (models/hydrocarbon.py): the reference's
flagship structure.data workload (ref examples/runmd.py + REBO),
rebuilt as Tersoff backbone + spectroscopically-pinned H terminators."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sclmd_jax.models.hydrocarbon import CHDriver, ch_energy

REF_DATA = "/root/reference/examples/structure.data"


def benzene():
    """C6H6 ring (approximate geometry; relaxes to the model's own)."""
    axyz = []
    for k in range(6):
        th = np.pi / 3 * k
        axyz.append(["C", 1.40 * np.cos(th), 1.40 * np.sin(th), 0.0])
    for k in range(6):
        th = np.pi / 3 * k
        axyz.append(["H", 2.49 * np.cos(th), 2.49 * np.sin(th), 0.0])
    return axyz


class TestTerminate:
    def test_ribbon_edges_passivated(self):
        from sclmd_jax.models.hydrocarbon import terminate_with_h
        from sclmd_jax.models.tersoff import graphene_ribbon

        x = graphene_ribbon(4, 3)
        axyz = [["C", *row] for row in x]
        out = terminate_with_h(axyz)
        nh = sum(1 for a in out if a[0] == "H")
        assert nh > 0
        # every added H sits ~1.09 Ang from exactly one C
        pos = np.array([a[1:] for a in out])
        els = [a[0] for a in out]
        for i, e in enumerate(els):
            if e != "H":
                continue
            d = np.linalg.norm(pos[: len(axyz)] - pos[i], axis=1)
            assert abs(d.min() - 1.09) < 1e-6
            assert (d < 1.3).sum() == 1
        # the terminated structure drives end-to-end
        drv = CHDriver(out)
        assert len(drv.ch_bonds) == nh
        f = np.asarray(drv.force(np.zeros(3 * len(out))))
        assert np.isfinite(f).all()


class TestCHDriver:
    def test_rejects_non_ch(self):
        with pytest.raises(NotImplementedError):
            ch_energy([["C", 0, 0, 0], ["O", 1.2, 0, 0]])

    def test_benzene_bonds_and_forces(self):
        axyz = benzene()
        drv = CHDriver(axyz)
        assert len(drv.ch_bonds) == 6
        # every H anchored to a distinct C
        assert len(set(drv.ch_bonds[:, 1])) == 6
        n = 3 * len(axyz)
        q = np.zeros(n)
        q[0] = 0.01
        f = np.asarray(drv.force(q))
        assert f.shape == (n,) and np.isfinite(f).all()

    def test_benzene_nve_energy_conservation(self):
        """The integrator applies RELATIVE forces f(q) - f0 (the
        reference's convention, lammpsdriver.py:83-84), whose exact
        conserved quantity is KE + PE(q) + f0.q — benzene's guessed
        ring radius is not this model's equilibrium, so f0 != 0."""
        from sclmd_jax.md import GLESystem, initial_state, run_segment

        axyz = benzene()
        drv = CHDriver(axyz)
        f0 = np.asarray(drv.f0)
        nph = 3 * len(axyz)
        dt = 0.05
        system = GLESystem(dyn=None, baths=(), mask=jnp.ones(nph),
                           dt=dt, nph=nph, ml=1, nmd=512,
                           force_fn=drv.force_jax)
        st = initial_state(system, dtype=jnp.float64)
        st = st.replace(p=0.02 * jax.random.normal(
            jax.random.PRNGKey(7), (nph,), jnp.float64))

        def etot(s):
            q = np.asarray(s.q)
            ke = 0.5 * float(jnp.dot(s.p, s.p))
            pe = float(drv.energy(q)) - float(drv.energy())
            return ke + pe + float(f0 @ q)

        e0 = etot(st)
        fin, _ = run_segment(system, st, 512)
        e1 = etot(fin)
        assert np.isfinite(np.asarray(fin.q)).all()
        assert abs(e1 - e0) < 2e-3 * max(abs(e0), 1e-3), (e0, e1)


def test_ch_ensemble_runs(tmp_path):
    """CHDriver + RunEnsemble: the flagship-workload combination
    (vmapped trajectories over a many-body C/H junction)."""
    from sclmd_jax import baths as B
    from sclmd_jax.md import md

    axyz = benzene()
    drv = CHDriver(axyz)
    n = 3 * len(axyz)
    runner = md(0.4, 64, 300.0, axyz=axyz,
                dyn=np.asarray(drv.dynmat()), nstop=1,
                dtype=jnp.float64, outdir=str(tmp_path))
    runner.AddPotential(drv)
    eta = np.eye(6) / 80.0
    runner.AddBath(B.ebath(range(6), 330.0, 0.4, 64, wmax=1.0,
                           efric=eta, dtype=jnp.float64))
    runner.AddBath(B.ebath(range(n - 6, n), 270.0, 0.4, 64, wmax=1.0,
                           efric=eta, dtype=jnp.float64))
    means = runner.RunEnsemble(3)
    assert means.shape == (3, 2)
    assert np.isfinite(np.asarray(means)).all()


@pytest.mark.skipif(not os.path.exists(REF_DATA),
                    reason="reference structure.data not present")
class TestFlagshipStructure:
    """The reference's own 201-atom C/H junction input, file-to-file."""

    @pytest.fixture(scope="class")
    def driver(self):
        from sclmd_jax.utils.io import read_lammps_data
        loaded = read_lammps_data(REF_DATA)
        return loaded, CHDriver(loaded["axyz"])

    def test_loads_and_bonds(self, driver):
        loaded, drv = driver
        assert drv.number == 201
        assert len(drv.ch_bonds) == 30     # every H terminated
        f = np.asarray(drv.force(np.zeros(3 * drv.number)))
        assert np.isfinite(f).all()

    def test_h_mode_bands(self, driver):
        """H-dominated phonon bands sit in the observed windows:
        stretches ~2700-3600 cm^-1, bends/wags >= ~600 cm^-1; at most
        a couple of soft CH2 hindered rotations below."""
        loaded, drv = driver
        d = np.asarray(drv.dynmat())
        np.testing.assert_allclose(d, d.T, atol=1e-10)
        lam, vec = np.linalg.eigh(d)
        els = [a[0] for a in loaded["axyz"]]
        hmask = np.repeat(np.array([e == "H" for e in els]), 3)
        w = (vec[hmask] ** 2).sum(0)
        hm = np.sort(np.sqrt(np.clip(lam, 0.0, None))[w > 0.6])
        nstretch = len(drv.ch_bonds)
        stretches = hm[-nstretch:]
        assert stretches.min() > 0.33 and stretches.max() < 0.46, \
            (stretches.min(), stretches.max())
        soft = (hm < 0.05).sum()
        assert soft <= 2, f"{soft} soft H modes"
        bends = hm[(hm >= 0.05) & (hm < 0.33)]
        assert len(bends) > 0 and bends.min() > 0.07
