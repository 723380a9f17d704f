"""Deliberately-racy fixture for the port's whole-program pass
(BJX117/118/119): the twin of ``tests/fixtures/racy_threads.py`` (the
rules hold unchanged, so the shape is the same).

NOT production code — this module exists so
``tests/test_torch_analysis.py`` can assert the port's project pass flags
a known-bad file end to end through the CLI. It lives under
``tests/torch_fixtures/`` so the port's self-run (which scans
``blendjax_torch/``) never sees it.

Expected findings:

- BJX117 on ``Racy.counter`` — written from the spawned drain thread
  and read from the public API with no common lock.
- BJX118 on ``(Racy.lock_a, Racy.lock_b)`` — acquired a->b in
  ``both_ab`` but b->a in ``both_ba``.
- BJX119 on ``Racy.wedge`` — an untimed queue get while holding
  ``lock_a``.
"""

import queue
import threading


class Racy:
    def __init__(self):
        self.lock_a = threading.Lock()
        self.lock_b = threading.Lock()
        self.counter = 0
        self._q = queue.Queue()

    def start(self):
        threading.Thread(target=self._drain, daemon=True).start()

    def _drain(self):
        while True:
            self._q.get(timeout=0.25)
            self.counter += 1  # raced write: no lock, two contexts

    def snapshot(self) -> int:
        return self.counter  # raced read from the public API

    def both_ab(self):
        with self.lock_a:
            with self.lock_b:
                pass

    def both_ba(self):
        with self.lock_b:
            with self.lock_a:
                pass

    def wedge(self):
        with self.lock_a:
            return self._q.get()  # blocking, untimed, under a lock
