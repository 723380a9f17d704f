"""``CheckpointManager``: the API of ``blendjax/train/checkpoint.py`` over
the port's own snapshot format.

The JAX package's class wraps orbax, a JAX library with no PyTorch
counterpart; the port keeps the class's calls (``save``, ``wait``,
``latest_step``, ``restore``, ``close``) and writes
:class:`~blendjax_torch.checkpoint.SnapshotManager` snapshots, the format
``blendjax.checkpoint`` reads and writes (a chosen difference, ROADMAP).
"""

from __future__ import annotations

import os

from blendjax_torch.checkpoint import SnapshotManager
from blendjax_torch.weights import load_train_state_leaves, train_state_leaves


class CheckpointManager:
    """``save(step, state)`` / ``restore(state)`` of a port ``TrainState``."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.manager = SnapshotManager(self.directory, keep=max_to_keep)

    def save(self, step: int, state) -> None:
        """Asynchronous: the write overlaps the next steps; :meth:`wait`,
        :meth:`close` and :meth:`restore` wait for it."""
        self.manager.save_async(step, train_state_leaves(state))

    def wait(self) -> None:
        self.manager.wait()

    def latest_step(self):
        return self.manager.latest_step()

    def restore(self, target_state):
        """Restore the newest snapshot into ``target_state`` in place and
        return it; ``None`` when there is no snapshot."""
        restored = self.manager.restore(train_state_leaves(target_state))
        if restored is None:
            return None
        load_train_state_leaves(target_state, restored.state)
        return target_state

    def close(self) -> None:
        self.manager.close()
