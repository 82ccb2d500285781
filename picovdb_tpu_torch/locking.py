"""Reader-writer lock for host-side state.

Same semantics as the reference's `_RWLock` (picovdb/pico_vdb.py:1019-1063):
readers coexist, a writer excludes everyone, no writer priority. In this
framework the lock only guards *host* bookkeeping (id maps, doc lists,
dirty-row sets); device arrays are immutable JAX values, so queries get
snapshot isolation for free once they have captured the current device
handles — the property the reference's snapshot tests
(tests/test_task11_snapshot_reads.py) verify by construction here.

The reference's no-writer-priority choice means a saturated reader pool can
starve writers indefinitely; this framework widens that window slightly
because readers also hold the read lock through a device-mirror currency
check (`engine._synced_read`). `RWLock(writer_priority=True)` (engine kwarg
`writer_priority`, env `PICOVDB_WRITER_PRIORITY=1`) closes it: while a
writer is waiting, *new* readers queue behind it; in-flight readers drain
normally. Default stays off for exact reference parity. Measured starvation
numbers: bench/lock_stress.py -> bench/results/lock_stress_r3.json.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager


class RWLock:
    """Readers-coexist / writer-excludes lock.

    Unlike the reference's `_RWLock`, this one detects the classic
    self-deadlock (requesting the write lock while the same thread holds a
    read lock) and raises instead of hanging — the suite's stand-in for the
    race detectors the reference lacks (SURVEY.md §5 "Race detection").
    """

    def __init__(self, writer_priority: bool = False) -> None:
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._readers = 0
        self._writer = False
        self._writer_owner: int | None = None  # thread id holding write
        self._waiting_writers = 0
        self._writer_priority = bool(writer_priority)
        self._local = threading.local()

    def _read_depth(self) -> int:
        return getattr(self._local, "read_depth", 0)

    @contextmanager
    def read_lock(self):
        self.acquire_read()
        try:
            yield
        finally:
            self.release_read()

    @contextmanager
    def write_lock(self):
        self.acquire_write()
        try:
            yield
        finally:
            self.release_write()

    def acquire_read(self) -> None:
        # The converse of acquire_write's guard: a thread holding the
        # WRITE lock that requests a read would wait on a condition only
        # its own release_write can satisfy — raise instead of hanging
        # (r5 review: the detection used to be asymmetric).
        if self._writer_owner == threading.get_ident():
            raise RuntimeError(
                "deadlock: read lock requested while this thread holds "
                "the write lock"
            )
        # A thread re-entering the read lock must not queue behind a waiting
        # writer: it already holds a read, so the writer cannot proceed until
        # it releases — gating the nested acquire would deadlock both.
        reentrant = self._read_depth() > 0
        with self._cond:
            while self._writer or (
                self._writer_priority and not reentrant and self._waiting_writers > 0
            ):
                self._cond.wait()
            self._readers += 1
        self._local.read_depth = self._read_depth() + 1

    def release_read(self) -> None:
        self._local.read_depth = max(0, self._read_depth() - 1)
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    def acquire_write(self) -> None:
        if self._read_depth() > 0:
            raise RuntimeError(
                "deadlock: write lock requested while this thread holds a "
                "read lock"
            )
        with self._cond:
            self._waiting_writers += 1
            try:
                while self._writer or self._readers > 0:
                    self._cond.wait()
            except BaseException:
                # an interrupted wait (e.g. KeyboardInterrupt) opens the
                # writer-priority gate: wake the readers it was holding
                # back, or they sleep until unrelated lock traffic
                self._waiting_writers -= 1
                self._cond.notify_all()
                raise
            self._waiting_writers -= 1
            self._writer = True
            self._writer_owner = threading.get_ident()

    def release_write(self) -> None:
        with self._cond:
            self._writer = False
            self._writer_owner = None
            self._cond.notify_all()


# Back-compat alias matching the reference's private name.
_RWLock = RWLock
