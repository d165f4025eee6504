"""The port's own copies of the pure-Python serving control plane —
``BlockAllocator``, ``Scheduler``, ``VirtualClock`` and the sanitizer gate
— driven through the same scenarios as the JAX package's, with identical
outputs, plus the scheduler's aging bound as a property.

The one intended difference is ``Scheduler.effective_class``: the port
counts the aging intervals waited exactly, so a wait of ``priority *
interval`` always reaches class 0 (its docstring); the reference's
``int(waited // interval)`` stops one class short when the floor division
rounds down (``0.03 // 0.01 == 2.0``).
"""

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.serving import block_pool as jpool
from repro.serving import clock as jclock
from repro.serving import scheduler as jsched
from repro_torch.serving import block_pool as ppool
from repro_torch.serving import clock as pclock
from repro_torch.serving import sanitize as psanitize
from repro_torch.serving import scheduler as psched

SHORT = settings(max_examples=60, deadline=None)


def _outcome(fn, *args):
    """A call's result, or the name of the exception it raised."""
    try:
        return fn(*args)
    except Exception as e:  # noqa: BLE001 — the type is the outcome
        return type(e).__name__


# ---------------------------------------------------------------------------
# BlockAllocator
# ---------------------------------------------------------------------------


def _allocator_script(mod):
    a = mod.BlockAllocator(8, 4)
    log = [a.free_count, a.blocks_for(0), a.blocks_for(4), a.blocks_for(5)]
    blocks = a.alloc(3)
    log += [blocks, a.free_count, a.used_count]
    a.incref(blocks[0])
    snap = a.snapshot()
    log.append(snap)
    a.decref(blocks[0])
    a.decref(blocks[0])
    log += [a.refcount(blocks[0]), a.free_count,
            _outcome(a.decref, blocks[0]), _outcome(a.incref, blocks[0]),
            _outcome(a.incref, mod.TRASH_BLOCK), _outcome(a.alloc, 6),
            _outcome(a.alloc, -1), a.alloc(2)]
    a.restore(snap)
    log += [a.snapshot(), a.alloc(4), a.free_count]
    a.check_invariants()
    log += [_outcome(mod.BlockAllocator, 1, 4),
            _outcome(mod.BlockAllocator, 4, 0)]
    return log


def test_block_allocator_matches_reference():
    assert _allocator_script(ppool) == _allocator_script(jpool)
    assert ppool.TRASH_BLOCK == jpool.TRASH_BLOCK == 0


@SHORT
@given(ops=st.lists(st.tuples(st.sampled_from(["alloc", "incref", "decref"]),
                              st.integers(0, 9)), max_size=40))
def test_block_allocator_any_sequence_matches_reference(ops):
    """Any sequence of alloc / incref / decref (misuse included) leaves
    both allocators in the same state with the same outcomes."""
    pa, ja = ppool.BlockAllocator(10, 2), jpool.BlockAllocator(10, 2)
    for op, x in ops:
        n = x % 4 if op == "alloc" else x
        assert _outcome(getattr(pa, op), n) == _outcome(getattr(ja, op), n)
        assert pa.snapshot() == ja.snapshot()
    pa.check_invariants()


def test_sanitizer_trips_on_a_corrupted_pool(monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    assert psanitize.sanitizer_enabled()
    a = ppool.BlockAllocator(6, 2)
    b = a.alloc(2)
    a._free.append(b[0])  # a block both free and referenced
    with pytest.raises(psanitize.SanitizerError):
        a.decref(b[1])
    monkeypatch.setenv("REPRO_SANITIZE", "0")
    assert not psanitize.sanitizer_enabled()


# ---------------------------------------------------------------------------
# Scheduler
# ---------------------------------------------------------------------------


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _req(mod, uid, n=3, **kw):
    kw.setdefault("max_new", 3)
    return mod.Request(tokens=np.arange(4, 4 + n, dtype=np.int32), uid=uid,
                       **kw)


def _ids(pairs):
    return [(slot, r.uid) for slot, r in pairs]


def _scheduler_script(mod):
    clk = FakeClock()
    s = mod.Scheduler(2, clock=clk, aging_interval_s=0.5)
    log = []
    for uid, pri in ((1, 1), (2, 0), (3, 1), (4, 2)):
        s.submit(_req(mod, uid, priority=pri, max_new=2 + uid % 2,
                      stop_token=9 if uid == 3 else None,
                      prefix="a" if uid % 2 else None))
    log += [s.pending, s.has_work(), s.best_queued().uid,
            sorted(s.referenced_prefixes())]
    log.append(_ids(s.admit()))  # class 0 first, then FIFO in class 1
    log += [s.free_slots(), s.active_slots(), s.request_in(0).uid]
    log += [s.record_token(0, 5), s.record_token(0, 6)]  # budget 2 reached
    log.append(s.finish(0)[1].tolist())
    log.append(_ids(s.admit(lambda r: r.uid != 3)))  # the gate blocks 3
    log.append(_ids(s.admit()))
    clk.t = 1.2  # request 4 (class 2) has aged two intervals
    log += [s.effective_class(s.best_queued() or _req(mod, 99)),
            s.record_token(1, 9)]  # request 1: budget 3, one token so far
    log.append(s.preempt(1).uid)
    log += [s.resume_len(1), s.preemptions, [r.uid for r in s._queue]]
    log.append(_ids(s.admit()))
    log += [s.emitted_tokens(1).tolist(), s.record_token(1, 9),
            s.record_token(1, 4)]
    log.append(s.finish(1)[1].tolist())
    park = _req(mod, 5, prefix="cold")
    log += [s.park(park), s.num_waiting, s.waiting_names(),
            [r.uid for r in s.waiting_on("cold")],
            [r.uid for r in s.wake("cold")], [r.uid for r in s._queue]]
    for bad in (dict(tokens=np.zeros(0, np.int32), max_new=1),
                dict(tokens=np.ones(2, np.int32), max_new=0),
                dict(tokens=np.ones(2, np.int32), max_new=1, priority=-1),
                dict(tokens=np.ones(2, np.int32), max_new=1, arrival_s=-1.0)):
        log.append(_outcome(lambda kw: mod.Request(**kw), bad))
    shots = mod.Request(tokens=np.ones(2, np.int32), max_new=1,
                        raw_shots=np.arange(5), uid=7)
    log += [shots.prefix,
            _outcome(lambda: mod.Scheduler(1, aging_interval_s=-1.0))]
    log += [mod.STAGES, sorted(mod.LEGAL_TRANSITIONS)]
    return log


def test_scheduler_matches_reference():
    assert _scheduler_script(psched) == _scheduler_script(jsched)


@SHORT
@given(data=st.data())
def test_scheduler_any_interleaving_matches_reference(data):
    """Random submit / admit / record / preempt / finish sequences give the
    same admissions, finishes and resumptions in both schedulers (aging
    off, where the two agree by construction)."""
    slots = data.draw(st.integers(1, 3), label="slots")
    ps, js = psched.Scheduler(slots), jsched.Scheduler(slots)
    uid = 0
    for _ in range(data.draw(st.integers(1, 30), label="steps")):
        op = data.draw(st.sampled_from(["submit", "admit", "token",
                                        "preempt"]))
        if op == "submit":
            pri = data.draw(st.integers(0, 2))
            ps.submit(_req(psched, uid, priority=pri))
            js.submit(_req(jsched, uid, priority=pri))
            uid += 1
        elif op == "admit":
            assert _ids(ps.admit()) == _ids(js.admit())
        elif ps.active_slots():
            slot = data.draw(st.sampled_from(ps.active_slots()))
            if op == "preempt":
                assert ps.preempt(slot).uid == js.preempt(slot).uid
            elif ps.record_token(slot, 5) != js.record_token(slot, 5):
                pytest.fail("record_token disagrees")
            elif ps.request_in(slot).max_new <= len(ps.emitted_tokens(slot)):
                assert ps.finish(slot)[1].tolist() == \
                    js.finish(slot)[1].tolist()
        assert ps.active_slots() == js.active_slots()
        assert [r.uid for r in ps._queue] == [r.uid for r in js._queue]


@SHORT
@given(priority=st.integers(0, 8),
       interval=st.floats(0.01, 10.0),
       extra=st.floats(0.0, 100.0))
def test_aging_bounds_starvation(priority, interval, extra):
    """Waiting ``priority * interval`` seconds always ages a request to
    class 0, and aging is monotone: waiting never raises the class."""
    clk = FakeClock()
    s = psched.Scheduler(1, clock=clk, aging_interval_s=interval)
    r = _req(psched, 0, priority=priority)
    s.submit(r)
    before = s.effective_class(r)
    clk.t = priority * interval + extra
    after = s.effective_class(r)
    assert after == 0
    assert after <= before <= priority


def test_aging_counts_whole_intervals_where_the_reference_rounds_down():
    clocks = []
    for mod in (psched, jsched):
        clk = FakeClock()
        s = mod.Scheduler(1, clock=clk, aging_interval_s=0.01)
        r = _req(mod, 0, priority=3)
        s.submit(r)
        clk.t = 3 * 0.01
        clocks.append(s.effective_class(r))
        clk.t = 0.025  # two whole intervals in both
        clocks.append(s.effective_class(r))
    assert clocks == [0, 1, 1, 1]  # port, then the reference


# ---------------------------------------------------------------------------
# VirtualClock
# ---------------------------------------------------------------------------


def _clock_script(mod):
    c = mod.VirtualClock(costs={"decode_step": 2e-3}, start=1.0)
    log = [c(), c.now]
    c.charge("decode_step")
    c.charge("prefill_token", 16)
    c.charge("unknown", 5)
    log.append(c())
    c.advance(0.25)
    c.advance_to(0.5)  # never backwards
    log.append(c())
    c.advance_to(3.0)
    log += [c(), _outcome(c.advance, -1.0), sorted(c.costs.items()),
            sorted(mod.DEFAULT_COSTS.items())]
    return log


def test_virtual_clock_matches_reference():
    assert _clock_script(pclock) == _clock_script(jclock)
