"""Junction setup helpers (utils/junction.py)."""

import os

import numpy as np
import pytest

from sclmd_jax.utils.junction import partition_by_axis, relax_for_model

REF_DATA = "/root/reference/examples/structure.data"


def test_partition_proportions():
    axyz = [["C", float(i), 0.0, 0.0] for i in range(100)]
    p = partition_by_axis(axyz)
    assert len(p["fixed_atoms"]) == 20
    assert len(p["leadl"]) == len(p["leadr"]) == 25
    assert len(p["device"]) == 30
    # DOF lists are disjoint and cover leads
    assert not (set(p["ecatsl"]) & set(p["ecatsr"]))
    assert not (set(p["fixdofs"]) & set(p["ecatsl"]))


def test_partition_rejects_degenerate():
    axyz = [["C", float(i), 0.0, 0.0] for i in range(6)]
    with pytest.raises(ValueError):
        partition_by_axis(axyz, frac_fixed=0.4, frac_lead=0.2)


@pytest.mark.skipif(not os.path.exists(REF_DATA),
                    reason="reference structure.data not present")
def test_partition_matches_reference_ranges():
    """On the x-ordered 201-atom structure.data the default partition
    reproduces the reference's hand-coded index ranges
    (ref examples/runmd.py:31-38)."""
    from sclmd_jax.utils.io import read_lammps_data

    axyz = read_lammps_data(REF_DATA)["axyz"]
    p = partition_by_axis(axyz)
    assert sorted(p["fixed_atoms"]) == (list(range(0, 20)) +
                                        list(range(181, 201)))
    assert p["ecatsl"] == list(range(20 * 3, (69 + 1) * 3))
    assert p["ecatsr"] == list(range(131 * 3, (180 + 1) * 3))


def test_relax_for_model_freezes_fixed():
    from sclmd_jax.models.eam import EAMDriver, SUTTON_CHEN_PARAMS, fcc_cell

    a0 = SUTTON_CHEN_PARAMS["Cu"]["a"]
    pos, _ = fcc_cell(2, 2, 2, a0)
    rng = np.random.default_rng(9)
    pos = pos + 0.04 * rng.standard_normal(pos.shape)
    axyz = [["Cu"] + list(p) for p in pos]

    def mk(a):
        return EAMDriver(a, rcut=1.2 * a0, cutoff_skin=0.6)

    out, fmax, nit = relax_for_model(axyz, mk, fixed_atoms=[0, 1],
                                     tol=5e-4, iters=1)
    np.testing.assert_array_equal(
        np.array([a[1:] for a in out])[:2], pos[:2])
    assert fmax <= 5e-4
