"""Measure the UseK noise-grid systematic vs dw (VERDICT r2 item 5).

The classical UseK crosscheck (tests/test_crosscheck.py::
test_usek_lead_blocks_conductance_matches_negf) carries a measured
~-10% deviation attributed to the noise-grid spacing dw = 2pi/(dt*nmd)
(dt- and ml-independent).  If the bias is ~linear in dw, a two-tier
Richardson extrapolation  J* = 2 J(2*nmd) - J(nmd)  cancels it and the
test bound can drop from 15% to <=3%.

This script measures J_MD/J_NEGF at nmd = 2^12..2^15 with a common-
random-number antithetic estimator (same key -> same Gaussian draws at
both temperature orderings) so the SEM is small enough to resolve the
systematic, then reports the linear fit in dw and the Richardson
residuals for each adjacent pair.

Run on CPU:  JAX_PLATFORMS=cpu python scripts/exp_usek_richardson.py
"""

import time

import numpy as np


import jax                                             # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp                                # noqa: E402

from sclmd_jax import baths as B                       # noqa: E402
from sclmd_jax import units as U                       # noqa: E402
from sclmd_jax.md import (GLESystem, initial_state,    # noqa: E402
                          run_segment_blocked)
from sclmd_jax.models.harmonic import chain_dynmat     # noqa: E402
from sclmd_jax.selfenergy import (                     # noqa: E402
    lead_selfenergy_from_blocks_np)

k = 0.04
nph = 8
dt = 0.25 / 0.658
ml = 256
T, delta = 300.0, 0.5
TL, TR = T * (1 + delta / 2), T * (1 - delta / 2)

D = np.array(chain_dynmat(nph, k))
D_negf = D.copy()
D_negf[0, 0] += k
D_negf[-1, -1] += k
K00 = np.array([[2 * k]])
K01 = np.array([[-k]])
V01 = np.array([[-k]])

ws = np.linspace(1e-4, 2.2 * np.sqrt(k), 2000)
sig_w = lead_selfenergy_from_blocks_np(K00, K01, V01, ws, eta=1e-6)
tm = []
for i, w in enumerate(ws):
    se = np.zeros((nph, nph), complex)
    se[0, 0] = sig_w[i, 0, 0]
    se[-1, -1] = sig_w[i, 0, 0]
    g = np.linalg.inv((w + 1e-9j) ** 2 * np.eye(nph) - D_negf - se)
    gam = -2 * np.imag(sig_w[i, 0, 0])
    gl = np.zeros((nph, nph)); gl[0, 0] = gam
    gr = np.zeros((nph, nph)); gr[-1, -1] = gam
    tm.append(np.real(np.trace(g @ gl @ g.conj().T @ gr)))
j_negf = np.trapezoid(np.array(tm), ws) * U.KB * (TL - TR) / (2 * np.pi)
print(f"NEGF (classical Landauer): {j_negf:.6e}")


def measure(nmd, nens, seed=5):
    def mk(Tb, cid):
        return B.phbath(Tb, [cid], np.sqrt(k), 400, dt, nmd, ml=ml,
                        K00=K00, K01=K01, V01=V01, mcof=2.2,
                        classical=True, dtype=jnp.float64)

    fwd = (mk(TL, 0), mk(TR, nph - 1))
    rev = (mk(TR, 0), mk(TL, nph - 1))
    keys = jax.random.split(jax.random.PRNGKey(seed), (nens, 2))

    def one(ks):
        def run(bl, br):
            bl = bl.gnoi(ks[0]).replace(nevecs=None, nstd=None)
            br = br.gnoi(ks[1]).replace(nevecs=None, nstd=None)
            sysb = GLESystem(dyn=jnp.asarray(D), baths=(bl, br),
                             mask=jnp.ones(nph), dt=dt, nph=nph,
                             ml=ml, nmd=nmd)
            _, ys = run_segment_blocked(
                sysb, initial_state(sysb, dtype=jnp.float64), nmd,
                block=64)
            cur = ys["cur"][nmd // 4:]
            return (jnp.mean(cur[:, 0]) - jnp.mean(cur[:, 1])) / 2

        return (run(*fwd) - run(*rev)) / 2

    t0 = time.time()
    j = np.asarray(jax.vmap(one)(keys))
    j_md = float(j.mean())
    sem = float(j.std() / np.sqrt(nens))
    dw = 2 * np.pi / dt / nmd
    dev = (j_md - j_negf) / j_negf
    print(f"nmd=2^{int(np.log2(nmd))} nens={nens}: J={j_md:.6e} "
          f"SEM {sem / j_negf * 100:.2f}%  dev {dev * 100:+.2f}%  "
          f"dw={dw:.5f}  ({time.time() - t0:.0f} s)")
    return j_md, sem, dw


if __name__ == "__main__":
    tiers = [(2 ** 12, 96), (2 ** 13, 64), (2 ** 14, 48), (2 ** 15, 32)]
    res = [measure(nmd, nens) for nmd, nens in tiers]
    js = np.array([r[0] for r in res])
    dws = np.array([r[2] for r in res])
    fit = np.polyfit(dws, js, 1)
    print(f"linear fit J(dw): slope={fit[0]:.4e} "
          f"intercept={fit[1]:.6e} "
          f"(intercept dev {(fit[1] - j_negf) / j_negf * 100:+.2f}%)")
    for a in range(len(res) - 1):
        jfine, jcoarse = js[a + 1], js[a]
        jstar = 2 * jfine - jcoarse      # dw halves between tiers
        print(f"Richardson 2^{12 + a}/2^{13 + a}: J*={jstar:.6e} "
              f"dev {(jstar - j_negf) / j_negf * 100:+.2f}%")
