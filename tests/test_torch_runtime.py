"""The port's copy of the fault-tolerance control plane
(`repro_torch.runtime.scheduler`): tests/test_runtime.py's five tests on the
copy, and both packages driven through one scripted event sequence
(requests, deaths, speculative duplicates, a resume from `to_state`) with
every assignment and counter compared."""

import random

import torch

from repro.runtime import ChunkLedger as JLedger
from repro.runtime import WorkScheduler as JScheduler
from repro_torch.runtime import ChunkLedger, WorkScheduler, WorkerPool

torch.set_num_threads(1)


def test_all_chunks_complete_happy_path():
    sched = WorkScheduler(n_chunks=10)
    t = 0.0
    while not sched.finished:
        t += 0.1
        for w in ("w0", "w1", "w2"):
            c = sched.request_work(w, t)
            if c is not None:
                sched.report_done(w, c, t)
    assert sched.ledger.done == set(range(10))
    assert sched.wasted_completions == 0


def test_worker_death_requeues_chunks():
    sched = WorkScheduler(n_chunks=4, timeout=1.0)
    c0 = sched.request_work("dead", now=0.0)
    assert c0 is not None
    t = 0.0
    while not sched.finished:
        t += 0.5
        c = sched.request_work("alive", t)
        if c is not None:
            sched.report_done("alive", c, t)
        assert t < 60
    assert c0 in sched.ledger.done


def test_straggler_speculation_bounds_tail():
    sched = WorkScheduler(n_chunks=6, timeout=1e9)
    slow_chunk = sched.request_work("slow", now=0.0)
    t = 0.0
    while not sched.finished:
        t += 0.1
        c = sched.request_work("fast", t)
        if c is not None:
            sched.report_done("fast", c, t)
        assert t < 30
    assert sched.duplicates_issued >= 1
    assert slow_chunk in sched.ledger.done
    sched.report_done("slow", slow_chunk, t + 100)
    assert sched.wasted_completions >= 1


def test_ledger_resume_roundtrip():
    led = ChunkLedger(n_chunks=8)
    for c in (0, 3, 5):
        led.next_chunk("w")
        led.complete(c)
    led2 = ChunkLedger.from_state(led.to_state())
    assert led2.done == {0, 3, 5}
    remaining = set()
    while True:
        c = led2.next_chunk("w")
        if c is None:
            break
        remaining.add(c)
        led2.complete(c)
    assert remaining == {1, 2, 4, 6, 7}


def test_randomized_chaos_all_work_completes():
    rng = random.Random(0)
    sched = WorkScheduler(n_chunks=40, timeout=2.0)
    workers = {f"w{i}": True for i in range(6)}
    t = 0.0
    while not sched.finished and t < 1000:
        t += 0.5
        for w, alive in list(workers.items()):
            if not alive:
                continue
            if rng.random() < 0.02:
                workers[w] = False
                continue
            c = sched.request_work(w, t)
            if c is not None and rng.random() < 0.9:
                sched.report_done(w, c, t)
        if all(not a for a in workers.values()):
            workers[f"w{len(workers)}"] = True
    assert sched.finished
    assert sched.ledger.done == set(range(40))


def _script(seed: int):
    """A scripted event sequence: (kind, worker, time) with kinds request,
    done (of the worker's last chunk), die (stop beating) and resume (to_state
    and back halfway)."""
    rng = random.Random(seed)
    events, t, born = [], 0.0, 4
    for i in range(500):
        t += 0.25
        w = f"w{rng.randrange(born)}"
        r = rng.random()
        # w0 takes chunks and never reports them: a straggler
        kind = ("request" if r < 0.5 or w == "w0" else "done" if r < 0.97 else "die")
        events.append((kind, w, t))
        if kind == "die":
            born += 1  # elastic scale-up: a new worker joins
        if i == 40:
            events.append(("resume", None, t))
    return events


def _drive(Scheduler, Ledger, events):
    """Every assignment and counter of one scheduler class over `events`."""
    sched = Scheduler(n_chunks=30, timeout=1.5)
    held, dead, log = {}, set(), []
    for kind, w, t in events:
        if kind == "resume":
            sched = Scheduler(n_chunks=30, timeout=1.5,
                              ledger=Ledger.from_state(sched.ledger.to_state()))
            held.clear()
            log.append(("resume", sorted(sched.ledger.done), list(sched.ledger.pending)))
            continue
        if w in dead:
            continue
        if kind == "request":
            c = sched.request_work(w, t)
            if c is not None:
                held[w] = c
            log.append(("request", w, c))
        elif kind == "done" and w in held:
            sched.report_done(w, held.pop(w), t)
            log.append(("done", w))
        elif kind == "die":
            dead.add(w)
            log.append(("die", w))
        log.append((sorted(sched.ledger.done), list(sched.ledger.pending),
                    {c: sorted(o) for c, o in sched.ledger.in_flight.items()},
                    sched.duplicates_issued, sched.wasted_completions,
                    sorted(sched.pool.last_beat), sched.finished))
    return log


def test_both_packages_take_the_same_decisions():
    for seed in range(3):
        events = _script(seed)
        mine = _drive(WorkScheduler, ChunkLedger, events)
        theirs = _drive(JScheduler, JLedger, events)
        assert mine == theirs
        # the script reaches deaths, speculation and a resume
        counters = [e for e in mine if isinstance(e[0], list)]
        assert any(e[0] == "die" for e in mine) and any(e[0] == "resume" for e in mine)
        assert counters[-1][3] > 0 and counters[-1][4] >= 0 and counters[-1][6]
    assert WorkerPool(timeout=2.0).dead_workers(0.0) == []
