"""Runtime sanitizer gate (``REPRO_SANITIZE=1``; the port's own copy of
``repro/serving/sanitize.py``).

The static checks in ``tools/reprolint`` and the runtime checks guarded
by this module enforce the *same* contracts from two sides: the linter
proves every code path balances block refcounts and every scheduler
stage move names a legal edge, and the sanitizer asserts the resulting
runtime state actually satisfies the invariants (free/used partition of
the pool, positive refcounts, legal stage sequences per request).  A bug
the dataflow analysis cannot see (e.g. state corrupted through an alias)
still trips the sanitizer; a hazard that never happens to execute in a
test still trips the linter.

The flag is sampled once per *object construction* (allocator,
scheduler), not per operation, so the hot decode loop pays a single
attribute test per check site and nothing at all when disabled.  Tests
flip the environment variable and construct fresh objects.
"""

from __future__ import annotations

import os

__all__ = ["SanitizerError", "sanitizer_enabled"]


class SanitizerError(AssertionError):
    """A serving-protocol invariant (refcount partition, stage machine)
    was violated at runtime.  Subclasses AssertionError on purpose: these
    are impossible-by-construction states, not recoverable conditions."""


def sanitizer_enabled() -> bool:
    """True when ``REPRO_SANITIZE`` is set to anything but ''/'0'."""
    return os.environ.get("REPRO_SANITIZE", "") not in ("", "0")
