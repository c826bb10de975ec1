"""Checkify debug-assertion layer.

The batched equivalent of the reference's debug assert macros
(ref: include/PathTrace/base.h:59-80): `assertNormalized` (|len^2 - 1| <
1e-4), `assertNonNegative` (negated comparison so NaN fails), and
`assertFinite`. Pure-functional JAX removes the reference's data-race
surface by construction; what remains worth asserting is numerical state
health inside the wavefront loop.

Enabled with PTX_DEBUG=1 (read at trace time): the checks become
`checkify.check`s, and `checked_trace` surfaces the first failure as a
Python exception with the offending value. With the flag unset every
helper is a no-op and the traced program is unchanged.
"""
from __future__ import annotations

import os

import jax.numpy as jnp
from jax.experimental import checkify

_CHECK_SET = checkify.user_checks


def enabled() -> bool:
    return os.environ.get("PTX_DEBUG") == "1"


def check_normalized(v, name: str) -> None:
    """|length^2 - 1| < 1e-4 on the last axis (ref: base.h:59-62),
    evaluated only where `mask` lanes matter is the caller's concern —
    padded lanes should carry unit placeholders."""
    if not enabled():
        return
    len2 = jnp.sum(v * v, axis=-1)
    ok = jnp.abs(len2 - 1.0) < 1e-4
    checkify.check(
        jnp.all(ok),
        f"assertNormalized failed for {name}: worst |len2-1|={{m}}",
        m=jnp.max(jnp.abs(len2 - 1.0)),
    )


def check_non_negative(x, name: str) -> None:
    """All components >= 0; NaN fails via the negated comparison
    (ref: base.h:67-77)."""
    if not enabled():
        return
    ok = x >= 0.0  # NaN compares False, like the reference's !(x >= 0)
    checkify.check(
        jnp.all(ok), f"assertNonNegative failed for {name}: min={{m}}",
        m=jnp.min(x),
    )


def check_finite(x, name: str) -> None:
    """ref: base.h:79."""
    if not enabled():
        return
    checkify.check(jnp.all(jnp.isfinite(x)), f"assertFinite failed for {name}")


def checked(fn):
    """Wrap a traceable function so its checks raise on the host.

    Returns the function unchanged when PTX_DEBUG is off."""
    if not enabled():
        return fn

    def wrapper(*args, **kwargs):
        err, out = checkify.checkify(
            lambda *a, **k: fn(*a, **k), errors=_CHECK_SET
        )(*args, **kwargs)
        err.throw()
        return out

    return wrapper
