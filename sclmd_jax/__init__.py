"""sclmd_jax: semiclassical GLE molecular dynamics in JAX.

A ground-up JAX/XLA re-design of the capabilities of the
reference package sclmd (quantum-bath generalized-Langevin-equation MD
for nano-junctions + NEGF phonon transport): see SURVEY.md for the
component map. Public surface:

    sclmd_jax.md          GLE integrator (functional core + `md` runner)
    sclmd_jax.baths       ebath / phbath quantum baths
    sclmd_jax.negf        bpt ballistic phonon transport
    sclmd_jax.selfenergy  sig decimation lead self-energies
    sclmd_jax.models      force drivers (harmonic, pair, Tersoff, C/H
                          hydrocarbon, SW, EAM, NNP, native C++,
                          fsiesta) + FIRE/L-BFGS relaxation
    sclmd_jax.parallel    vmapped/sharded trajectory ensembles
    sclmd_jax.utils       analysis tools, IO, config, profiling
    sclmd_jax.postprocess Lambda + HSSigma current-induced pipelines
    sclmd_jax.units       unit system + element data
"""

__version__ = "0.1.0"

from sclmd_jax import units  # noqa: F401
