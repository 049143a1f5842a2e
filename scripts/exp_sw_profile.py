"""Decompose the large-junction step cost: SW forward vs gradient vs
bath-only GLE. Each probe is a jitted lax.scan of N iterations whose
body consumes the xs stream and whose result transfers to host (DCE
guard). Timings are medians over reps."""

from __future__ import annotations

import sys
import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    args = dict(a.split("=") for a in sys.argv[1:] if "=" in a)
    n = int(args.get("iters", 256))
    reps = int(args.get("reps", 3))
    nn = None if args.get("nn") == "auto" else int(args.get("nn", 8))
    skin = float(args.get("skin", 0.05))

    from sclmd_jax.models.sw import SWDriver, diamond_cell

    pos, cell = diamond_cell(12, 6, 6)
    na = len(pos)
    nph = 3 * na
    axyz = [["Si", *p] for p in pos]
    t0 = time.perf_counter()
    drv = SWDriver(axyz, cell=cell, dtype=jnp.float32, max_nnei=nn,
                   cutoff_skin=skin)
    print(f"{na} atoms, drv in {time.perf_counter() - t0:.1f} s")

    key = jax.random.PRNGKey(0)
    xs = jax.random.normal(key, (n, nph), jnp.float32) * 1e-3

    def timed(name, fn, *a):
        out = fn(*a)
        jax.block_until_ready(out)
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*a))
            ts.append(time.perf_counter() - t0)
        ts.sort()
        med = ts[len(ts) // 2]
        print(f"{name}: {med / n * 1e6:.1f} us/iter "
              f"({float(np.asarray(out if np.ndim(out) == 0 else out))!r:.20})")

    @jax.jit
    def scan_energy(xs):
        def body(c, dq):
            e = drv._drv._energy(c + dq)
            return c + 0.0 * e, e
        _, es = jax.lax.scan(body, jnp.zeros(nph, jnp.float32), xs)
        return jnp.sum(es)

    @jax.jit
    def scan_force(xs):
        def body(c, dq):
            f = drv.force_jax(c + dq)
            return c + 0.0 * f[0], jnp.sum(f)
        _, es = jax.lax.scan(body, jnp.zeros(nph, jnp.float32), xs)
        return jnp.sum(es)

    @jax.jit
    def scan_force2(xs):
        def body(c, dq):
            f1 = drv.force_jax(c + dq)
            f2 = drv.force_jax(c - dq)
            return c + 0.0 * f1[0], jnp.sum(f1) + jnp.sum(f2)
        _, es = jax.lax.scan(body, jnp.zeros(nph, jnp.float32), xs)
        return jnp.sum(es)

    timed("energy fwd", scan_energy, xs)
    timed("force (grad)", scan_force, xs)
    timed("2x force", scan_force2, xs)


if __name__ == "__main__":
    main()
