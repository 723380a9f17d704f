"""Deliberately-broken fixture for BJX121 in the port's vocabulary: the
PR-12 policy-sync bug in torch form, the twin of
``tests/fixtures/use_after_donate_sync.py``.

NOT production code — it exists so ``tests/test_torch_analysis.py`` can
assert the port's dataflow pass flags it end to end through the CLI; it
lives under ``tests/torch_fixtures/`` so the port's self-run never sees
it.

The shape: the learner takes a view of the training state's parameters
for the actors BEFORE the captured step, which writes the state in
place, then ships that view: the actors act on the NEW parameters, and
every later replay overwrites them under the actors. The fix is a
``.clone()`` before the step (``clean_update``); passing the state
itself to the step again is how a captured step is driven and never
flags.

Expected finding: BJX121 in ``Learner.update`` at the
``self.publish(policy)`` read, alias ``policy``.
"""

from blendjax_torch.train import CapturedStep


def _fused(state, batch):
    del batch
    return state


class Learner:
    def __init__(self):
        self._step = CapturedStep(_fused)

    def publish(self, params):
        del params

    def update(self, state, batch):
        policy = {k: v.detach() for k, v in state.params.items()}
        self._step(state, batch)
        self.publish(policy)  # BJX121: a view the replay overwrote
        return state

    def clean_update(self, state, batch):
        # sanctioned: a copy taken before the step, the state passed again
        policy = {k: v.detach().clone() for k, v in state.params.items()}
        self._step(state, batch)
        self._step(state, batch)
        self.publish(policy)
        return state
