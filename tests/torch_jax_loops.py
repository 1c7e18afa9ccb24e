"""Eager runs of the JAX package's references in the port's CPU tests.

Outside a trace, `jax.lax.fori_loop` compiles its loop anew at every call:
the JAX package's field code raises to powers by `fori_loop`s of squarings
of many lengths (`ops/field.py` `_sqr_n`), and its Pallas kernel bodies
loop over doublings level by level, so one eager pow chain or kernel body
costs a dozen loop compiles.  `loops_over_jitted_bodies` runs such a loop
as a Python loop over its body jitted once, the body shared by every loop
whose body is the same code with no free variables: the same operations in
the same order, compiled once.  Inside a trace (a jitted function, a
Pallas kernel in interpret mode) the loop is JAX's own, so no traced
program changes.
"""

from __future__ import annotations

import contextlib

import jax
import pytest


@contextlib.contextmanager
def loops_over_jitted_bodies():
    real, bodies = jax.lax.fori_loop, {}

    def fori_loop(lower, upper, body_fun, init_val, **kwargs):
        leaves = jax.tree_util.tree_leaves(init_val)
        if (kwargs or type(lower) is not int or type(upper) is not int
                or any(isinstance(x, jax.core.Tracer) for x in leaves)):
            return real(lower, upper, body_fun, init_val, **kwargs)
        shared = body_fun.__closure__ is None
        step = bodies.get(body_fun.__code__) if shared else None
        if step is None:
            step = jax.jit(body_fun)
            if shared:
                bodies[body_fun.__code__] = step
        for i in range(lower, upper):
            init_val = step(i, init_val)
        return init_val

    jax.lax.fori_loop = fori_loop
    try:
        yield
    finally:
        jax.lax.fori_loop = real


@pytest.fixture(scope="module")
def jax_loops_jitted_once():
    """`loops_over_jitted_bodies` for a whole test module."""
    with loops_over_jitted_bodies():
        yield
