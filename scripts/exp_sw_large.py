"""Large-junction GLE throughput: 3,456-atom Stillinger-Weber slab.

The PERF.md datapoint workload: a 12x6x6-cell diamond silicon slab
(3,456 atoms, 10,368 DOF) with full many-body SW forces evaluated
inside the scan, two wideband (Markovian) phonon baths of 864 DOF each
on the slab ends, colored quantum noise. Measures steps/s on the real
chip for the production blocked integrator.

Variants (argv):
    python scripts/exp_sw_large.py           # default f32 run
    python scripts/exp_sw_large.py f64       # float64 (expected slow)
    python scripts/exp_sw_large.py steps=512 block=64
"""

from __future__ import annotations

import sys
import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    args = dict(a.split("=") for a in sys.argv[1:] if "=" in a)
    f64 = "f64" in sys.argv[1:]
    nsteps = int(args.get("steps", 256))
    block = int(args.get("block", 64))
    reps = int(args.get("reps", 3))
    nn = None if args.get("nn") == "auto" else int(args.get("nn", 16))
    skin = float(args.get("skin", 0.4))
    dtype = jnp.float64 if f64 else jnp.float32

    if f64:
        jax.config.update("jax_enable_x64", True)

    from sclmd_jax import baths as B
    from sclmd_jax.md import GLESystem, initial_state, run_segment_blocked
    from sclmd_jax.models.sw import SWDriver, diamond_cell

    t0 = time.perf_counter()
    pos, cell = diamond_cell(12, 6, 6)
    na = len(pos)
    nph = 3 * na
    axyz = [["Si", *p] for p in pos]
    drv = SWDriver(axyz, cell=cell, dtype=dtype, max_nnei=nn,
                   cutoff_skin=skin)
    print(f"setup: {na} atoms, nn={nn} skin={skin}, drv in "
          f"{time.perf_counter() - t0:.1f} s")

    dt, T, delta = 0.25 / 0.658, 300.0, 0.1
    nmd = nsteps
    # bath DOFs: first/last 288 atoms (864 DOF each), wideband
    nb = 864
    gwl = np.linspace(0.0, 0.6, 16)
    gam = np.array([np.eye(nb) * 0.01 for _ in gwl])  # wideband table

    t0 = time.perf_counter()
    pbl = B.phbath(T * (1 + delta / 2), range(nb), 0.3, 16, dt, nmd,
                   ml=1, gamma=gam, gwl=gwl, dtype=dtype)
    pbr = B.phbath(T * (1 - delta / 2), range(nph - nb, nph), 0.3, 16,
                   dt, nmd, ml=1, gamma=gam, gwl=gwl, dtype=dtype)
    print(f"baths factorised in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    key = jax.random.PRNGKey(7)
    bl = pbl.gnoi(jax.random.fold_in(key, 0)).replace(nevecs=None,
                                                      nstd=None)
    br = pbr.gnoi(jax.random.fold_in(key, 1)).replace(nevecs=None,
                                                      nstd=None)
    jax.block_until_ready(bl.noise)
    print(f"device noise sampled in {time.perf_counter() - t0:.1f} s")

    mask = np.ones(nph, np.float64 if f64 else np.float32)

    @jax.jit
    def run(mask_a, bl, br, noise_l, noise_r):
        system = GLESystem(
            dyn=None, baths=(bl.replace(noise=noise_l),
                             br.replace(noise=noise_r)),
            mask=mask_a, dt=dt, nph=nph, ml=1, nmd=nmd,
            force_fn=drv.force_jax, unconstrained=True)
        st = initial_state(system, dtype=dtype)
        fin, ys = run_segment_blocked(system, st, nsteps, 0, block=block)
        return fin.p, jnp.mean(ys["cur"], 0), jnp.isfinite(ys["etot"]).all()

    nl, nr = bl.noise, br.noise
    bl0 = bl.replace(noise=None)
    br0 = br.replace(noise=None)
    t0 = time.perf_counter()
    out = run(mask_a=jnp.asarray(mask), bl=bl0, br=br0,
              noise_l=nl, noise_r=nr)
    jax.block_until_ready(out)
    print(f"compile+first run {time.perf_counter() - t0:.1f} s; "
          f"finite={bool(out[2])} cur={np.asarray(out[1])}")

    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(run(mask_a=jnp.asarray(mask), bl=bl0,
                                  br=br0, noise_l=nl, noise_r=nr))
        ts.append(time.perf_counter() - t0)
    ts.sort()
    med = ts[len(ts) // 2]
    print(f"steps/s median {nsteps / med:.1f} best {nsteps / min(ts):.1f} "
          f"(nsteps={nsteps}, block={block}, dtype={dtype.__name__})")


if __name__ == "__main__":
    main()
