"""Deliberately-leaky fixture for BJX120 in the port's vocabulary: the
twin of ``tests/fixtures/stamp_leak_trace.py``.

NOT production code — it exists so ``tests/test_torch_analysis.py`` can
assert the port's dataflow pass flags it end to end through the CLI; it
lives under ``tests/torch_fixtures/`` so the port's self-run never sees
it.

The shape: a producer stamps the sampled frame-trace context onto a
message (``msg["_trace"] = ...``); the collate helper rebuilds the dict
but keeps every key; the stamped batch reaches the captured train step.
``CapturedStep`` keys its graphs by ``_plan_signature``, which cannot
hash the trace's list of stages: the step raises ``TypeError`` — only
when a sampled frame happens to arrive.

Expected finding: BJX120 in ``feed`` at the ``train_step`` call, keys
``_trace`` — two call hops after the stamp.
"""

from blendjax_torch.train import CapturedStep


def _train_step(state, batch):
    del batch
    return state


train_step = CapturedStep(_train_step)


def stamp(msg):
    """Producer side: the sampled-trace context rides the message."""
    msg["_trace"] = {"start": 0.0, "stages": []}
    return msg


def collate(batch):
    """The collate path: rebuilds the dict but keeps every key —
    including the sidecar it should have popped."""
    return dict(batch)


def feed(state, raw):
    msg = stamp(raw)
    batch = collate(msg)
    return train_step(state, batch)  # BJX120: '_trace' reaches the capture
