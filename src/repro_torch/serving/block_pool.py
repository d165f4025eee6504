"""Ref-counted physical-block allocator for the paged KV cache (the
port's own copy of ``repro/serving/block_pool.py``).

Pure-python control plane (no torch): the device-side pools live in the
engine's per-layer cache; this module only decides *which* pool blocks a
slot's block table points at.

Invariants (held to the reference in ``tests/test_torch_control_plane.py``):

* every block is either free or has refcount >= 1 — never both;
* ``free_count + len(used) == num_blocks - 1`` (block 0 is reserved);
* ``alloc`` never hands out a block that is still referenced;
* ``decref`` below zero (double-free) raises instead of corrupting the
  free list.

A block's contents are only trustworthy while it is referenced: a freed
block may be re-allocated and re-written by the very next prefill.

Block 0 is the **trash block**: it is never allocated, and every unused
block-table entry points at it.  The batched decode step runs *every*
slot — idle and finished slots included — and the engine routes the
writes of the idle ones here (``paged_scatter(valid=)``), so it must be a
physical block that is safe to clobber and is never read (reads are
length-masked).
"""

from __future__ import annotations

from typing import Dict, List

from repro_torch.serving.sanitize import SanitizerError, sanitizer_enabled

TRASH_BLOCK = 0


class OutOfBlocksError(RuntimeError):
    """The pool has no free blocks left for the requested allocation."""


class BlockAllocationError(RuntimeError):
    """Refcount misuse: double-free or touching an unallocated block."""


class BlockAllocator:
    """Free-list + refcount bookkeeping over ``num_blocks`` pool blocks.

    Refcounts express sharing: a compressed-prefix block seated in N slots
    while resident in the PrefixStore carries refcount N+1.  A block
    returns to the free list exactly when its count reaches zero.
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError("need at least 2 blocks (block 0 is reserved)")
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._ref: Dict[int, int] = {}
        # LIFO free list: recently freed blocks are re-used first (their
        # pool pages are the most likely to still be warm)
        self._free: List[int] = list(range(num_blocks - 1, TRASH_BLOCK, -1))
        # REPRO_SANITIZE=1: re-verify the free/used partition after every
        # mutation (sampled once at construction; see serving/sanitize.py)
        self._sanitize = sanitizer_enabled()

    # ---- queries ----

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return len(self._ref)

    def refcount(self, block: int) -> int:
        return self._ref.get(block, 0)

    def blocks_for(self, num_tokens: int) -> int:
        """Blocks needed to hold ``num_tokens`` cache positions."""
        return -(-max(num_tokens, 0) // self.block_size)

    # ---- allocation ----

    def alloc(self, n: int) -> List[int]:
        """Take ``n`` fresh blocks (refcount 1 each)."""
        if n < 0:
            raise ValueError(n)
        if n > len(self._free):
            raise OutOfBlocksError(
                f"requested {n} blocks, {len(self._free)} free "
                f"(pool: {self.num_blocks}, block_size: {self.block_size})")
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._ref[b] = 1
        if self._sanitize:
            self.check_invariants()
        return out

    def incref(self, block: int) -> None:
        if block == TRASH_BLOCK:
            raise BlockAllocationError("block 0 is the reserved trash block")
        if block not in self._ref:
            raise BlockAllocationError(f"incref of unallocated block {block}")
        self._ref[block] += 1
        if self._sanitize:
            self.check_invariants()

    def decref(self, block: int) -> None:
        """Drop one reference; frees the block at zero.  Raises on
        double-free (decref of a block that is already free)."""
        if block == TRASH_BLOCK:
            raise BlockAllocationError("block 0 is the reserved trash block")
        count = self._ref.get(block)
        if count is None:
            raise BlockAllocationError(f"double free of block {block}")
        if count == 1:
            del self._ref[block]
            self._free.append(block)
        else:
            self._ref[block] = count - 1
        if self._sanitize:
            self.check_invariants()

    # ---- snapshot/restore (stateless scoring runs a throwaway prefill) ----

    def snapshot(self) -> tuple:
        return dict(self._ref), list(self._free)

    def restore(self, snap: tuple) -> None:
        ref, free = snap
        self._ref = dict(ref)
        self._free = list(free)
        if self._sanitize:
            self.check_invariants()

    # ---- REPRO_SANITIZE=1 invariant check ----

    def check_invariants(self) -> None:
        """Assert the module-docstring invariants hold right now; raises
        :class:`SanitizerError` on the first violation.  Runs after every
        mutation under ``REPRO_SANITIZE=1`` (and on demand from tests) —
        the runtime half of reprolint's ``refcount-balance`` contract."""
        free, ref = self._free, self._ref
        if len(set(free)) != len(free):
            raise SanitizerError(
                f"free list holds duplicate blocks: {sorted(free)}")
        overlap = set(free) & set(ref)
        if overlap:
            raise SanitizerError(
                f"blocks both free and referenced: {sorted(overlap)}")
        if TRASH_BLOCK in ref or TRASH_BLOCK in free:
            raise SanitizerError("reserved trash block 0 entered the pool")
        bad = {b: c for b, c in ref.items() if c < 1}
        if bad:
            raise SanitizerError(f"non-positive refcounts: {bad}")
        oob = [b for b in list(free) + list(ref)
               if not 0 < b < self.num_blocks]
        if oob:
            raise SanitizerError(
                f"blocks outside the pool [1, {self.num_blocks}): {oob}")
        if len(free) + len(ref) != self.num_blocks - 1:
            raise SanitizerError(
                f"pool partition broken: {len(free)} free + {len(ref)} "
                f"used != {self.num_blocks} - 1 blocks — a block was "
                "lost or duplicated")
