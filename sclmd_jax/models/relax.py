"""Structure relaxation: FIRE minimizer over a JAX energy function.

The reference assumes pre-minimized structures from an external engine
(LAMMPS ``minimize`` before the MD workloads; "minimized structure" in
ref examples/current-induced/rundp.py). Here relaxation is native: one
jitted ``lax.while_loop`` of FIRE (Bitzek et al., PRL 97, 170201
(2006)) steps over any differentiable energy, so a raw geometry can be
brought to a force-free configuration before building drivers,
dynamical matrices, and baths.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np


def fire_relax(energy_fn: Callable, x0, tol: float = 1e-4,
               maxit: int = 5000, dt0: float = 0.02,
               dtmax_factor: float = 10.0, fixed_mask=None):
    """Minimise ``energy_fn(x)`` from x0 ((na, 3) Ang) with FIRE.

    Returns (x_relaxed (na, 3) numpy, fmax eV/Ang, iterations).
    ``tol`` is the max-|force-component| convergence bound;
    ``fixed_mask`` (na, 3) True entries are held frozen.

    Standard FIRE schedule: f_inc=1.1, f_dec=0.5, alpha0=0.1,
    f_alpha=0.99, N_min=5. The whole loop runs inside one jit (single
    dispatch), with host numpy in/out only.
    """
    x0 = np.asarray(x0, float)
    shape = x0.shape
    free = (np.ones(shape, bool) if fixed_mask is None
            else ~np.asarray(fixed_mask, bool))
    f_inc, f_dec, alpha0, f_alpha, n_min = 1.1, 0.5, 0.1, 0.99, 5
    dtmax = dtmax_factor * dt0

    grad_fn = jax.grad(energy_fn)

    def force(x):
        return -grad_fn(x) * free

    def cond(carry):
        x, v, f, dt, alpha, npos, it = carry
        return (jnp.abs(f).max() > tol) & (it < maxit)

    def body(carry):
        x, v, f, dt, alpha, npos, it = carry
        # one force evaluation per iteration: f is carried from the
        # previous step's post-move evaluation
        p = jnp.vdot(f, v)
        fnorm = jnp.sqrt(jnp.vdot(f, f)) + 1e-30
        vnorm = jnp.sqrt(jnp.vdot(v, v))
        v_mixed = (1.0 - alpha) * v + alpha * f * (vnorm / fnorm)
        uphill = p <= 0.0
        v = jnp.where(uphill, jnp.zeros_like(v), v_mixed)
        grow = (~uphill) & (npos > n_min)
        dt = jnp.where(grow, jnp.minimum(dt * f_inc, dtmax),
                       jnp.where(uphill, dt * f_dec, dt))
        alpha = jnp.where(grow, alpha * f_alpha,
                          jnp.where(uphill, alpha0, alpha))
        npos = jnp.where(uphill, 0, npos + 1)
        # semi-implicit Euler step
        v = v + dt * f
        x = x + dt * v * free
        return x, v, force(x), dt, alpha, npos, it + 1

    @jax.jit
    def run(x):
        carry = (x, jnp.zeros_like(x), force(x), jnp.asarray(dt0),
                 jnp.asarray(alpha0), jnp.asarray(0), jnp.asarray(0))
        x, v, f, dt, alpha, npos, it = jax.lax.while_loop(
            cond, body, carry)
        return x, jnp.abs(f).max(), it

    x, fmax, it = run(jnp.asarray(x0))
    return np.asarray(x).reshape(shape), float(fmax), int(it)


def lbfgs_relax(energy_fn: Callable, x0, tol: float = 1e-4,
                maxit: int = 1000, fixed_mask=None,
                memory_size: int = 20):
    """Minimise ``energy_fn(x)`` with L-BFGS + zoom linesearch
    (optax.lbfgs), optimizing only the free coordinates.

    Same contract as :func:`fire_relax`. Converges in far fewer
    iterations on stiff/soft mixed landscapes (C-H stretches vs ribbon
    bending: the 201-atom structure.data reaches fmax 5e-3 in ~1.3k
    L-BFGS steps where FIRE needs >8k), at a few energy+grad evals per
    step from the linesearch. Preferred for setup-time relaxation;
    FIRE remains for energies whose gradients are too rough for a
    linesearch."""
    import optax

    x0 = np.asarray(x0, float)
    shape = x0.shape
    free = (np.ones(shape, bool) if fixed_mask is None
            else ~np.asarray(fixed_mask, bool)).ravel()
    idx = jnp.asarray(np.nonzero(free)[0])
    base = jnp.asarray(x0.ravel())

    def fun(p):
        return energy_fn(base.at[idx].set(p).reshape(shape))

    opt = optax.lbfgs(memory_size=memory_size)
    vg = optax.value_and_grad_from_state(fun)

    def cond(c):
        p, s, it, fmax = c
        return (fmax > tol) & (it < maxit)

    import optax.tree_utils as otu

    def body(c):
        p, s, it, _ = c
        v, g = vg(p, state=s)
        updates, s = opt.update(g, s, p, value=v, grad=g, value_fn=fun)
        p = optax.apply_updates(p, updates)
        # the zoom linesearch caches the gradient at the accepted
        # point — read it instead of paying another full grad eval
        fmax = jnp.abs(otu.tree_get(s, "grad")).max()
        return p, s, it + 1, fmax

    @jax.jit
    def run(p):
        s = opt.init(p)
        fmax = jnp.abs(jax.grad(fun)(p)).max()
        return jax.lax.while_loop(cond, body, (p, s, jnp.asarray(0),
                                               fmax))

    p, _, it, fmax = run(base[idx])
    x = np.asarray(base.at[idx].set(p)).reshape(shape)
    return x, float(fmax), int(it)
