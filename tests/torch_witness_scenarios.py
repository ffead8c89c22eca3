"""Lock-order scenarios that the lock-witness tests run under both packages'
witnesses (``tests/test_torch_lock_witness.py``).

Every primitive is built inside a function of this file, so a witness that
watches this file (``extra_paths``) keys each one by a site of this file.
Both packages name a site relative to their package root, so both name
``../tests/torch_witness_scenarios.py:<line>`` and their graphs compare
equal. Threads run one after another: an inverted order is recorded, never
deadlocked on.
"""

import threading


def _run(*targets) -> None:
    for target in targets:
        t = threading.Thread(target=target, daemon=True)
        t.start()
        t.join(10)
        assert not t.is_alive()


def abba() -> None:
    """Two threads take one pair of locks in opposite orders: a cycle."""
    a = threading.Lock()
    b = threading.RLock()

    def ab():
        with a:
            with b:
                pass

    def ba():
        with b:
            with a:
                pass

    _run(ab, ba)


def consistent_order() -> None:
    """Three threads take three locks in one order: edges, no cycle."""
    a = threading.Lock()
    b = threading.Lock()
    c = threading.Lock()

    def abc():
        with a:
            with b:
                with c:
                    pass

    _run(abc, abc, abc)


def three_lock_cycle() -> None:
    a = threading.Lock()
    b = threading.Lock()
    c = threading.Lock()

    def pair(first, second):
        def body():
            with first:
                with second:
                    pass
        return body

    _run(pair(a, b), pair(b, c), pair(c, a))


def lost_wakeup() -> None:
    """A thread waits on an event while holding a lock the setter takes
    before it sets the event: the cycle ``L -> E -> L``."""
    lock = threading.Lock()
    event = threading.Event()

    def waiter():
        with lock:
            event.wait(0.01)

    def setter():
        with lock:
            event.set()

    _run(waiter, setter)


def condition_handoff() -> None:
    """A consumer waits on a condition; the producer takes another lock and
    then the condition's: waiting does not hold the condition's lock, so no
    edge leaves the condition's site."""
    cond = threading.Condition()
    other = threading.Lock()
    done = []

    def consumer():
        with cond:
            while not done:
                cond.wait(0.01)

    def producer():
        with other:
            with cond:
                done.append(1)
                cond.notify_all()

    t = threading.Thread(target=consumer, daemon=True)
    t.start()
    _run(producer)
    t.join(10)
    assert not t.is_alive()


def barrier_under_lock() -> None:
    """Holding a lock across a barrier wait records ``lock -> barrier``."""
    lock = threading.Lock()
    barrier = threading.Barrier(1)

    def body():
        with lock:
            barrier.wait(1)

    _run(body)


SCENARIOS = {
    "abba": abba,
    "consistent-order": consistent_order,
    "three-lock-cycle": three_lock_cycle,
    "lost-wakeup": lost_wakeup,
    "condition-handoff": condition_handoff,
    "barrier-under-lock": barrier_under_lock,
}
