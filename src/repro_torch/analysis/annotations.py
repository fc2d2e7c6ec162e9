"""Static-analysis annotations (zero runtime cost).

These markers carry locking contracts that the AST lint
(:mod:`repro_torch.analysis.lint`) enforces mechanically.  They are identity
decorators at runtime — no wrapper frame, no call overhead.
"""
from __future__ import annotations

from typing import Callable, TypeVar

F = TypeVar("F", bound=Callable)


def holds_stripe(fn: F) -> F:
    """Declare that every caller of ``fn`` already holds the stripe lock.

    The ``stripe-access`` lint rule exempts the decorated function from the
    ``with s.lock:`` requirement; in exchange the *callers* are expected to
    invoke it only under the lock (the decorated body is still checked for
    blocking calls).  Use for ``_Stripe`` bookkeeping helpers like
    ``bump``/``record``/``invalidate``.
    """
    fn.__faasm_holds_stripe__ = True
    return fn
