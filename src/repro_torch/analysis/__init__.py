"""SFI-style invariant checking for the shared-memory state fabric.

Faasm's bet is that software-fault isolation makes shared memory safe; this
package is the correctness-tooling analogue for our reproduction's
hand-rolled concurrency: it makes the locking and wire-protocol discipline
*machine-verified* instead of re-audited by eyeball on every PR.

Two layers (see ``docs/invariants.md`` for the discipline itself):

  * :mod:`repro_torch.analysis.lint` — a static AST pass over ``src/`` enforcing
    the repo-specific rules (stripe accesses under the stripe lock, no
    blocking calls under stripe/key locks, ``WireFrame`` built only by the
    codec layer, no unaccounted copies of tier buffers).  Driven by
    ``scripts/faasmlint.py``; runs as a pre-test stage in
    ``scripts/tier1.sh``.
  * :mod:`repro_torch.analysis.sanitizer` — an opt-in runtime sanitizer
    (``FAASM_SANITIZE=1`` or the ``sanitize`` pytest marker): instrumented
    locks maintain a per-thread held-lock set and a global lock-order graph
    with cycle detection, buffer touches assert stripe ownership,
    generation counters catch torn zero-copy reads, and the wire fabric's
    version/window/residual invariants are checked on every frame.  When
    disabled the wrappers compile out to the raw locks at construction time
    — the steady-state cost is a module-global ``is None`` test.

This module stays import-light: only the annotation markers live here, so
``repro_torch.state`` can depend on it without dragging the linter (ast) or the
sanitizer bookkeeping into every import.
"""
from repro_torch.analysis.annotations import holds_stripe

__all__ = ["holds_stripe"]
