"""Deliberately-leaky fixture for BJX120 in the port's vocabulary: the
twin of ``tests/fixtures/stamp_leak_scenario.py``.

NOT production code — it exists so ``tests/test_torch_analysis.py`` can
assert the port's dataflow pass flags it end to end through the CLI; it
lives under ``tests/torch_fixtures/`` so the port's self-run never sees
it.

The shape: the echo sampler stamps the per-scenario accounting sidecar
(``batch["_scenario_rows"] = rows``) onto the draw it is about to run,
and the stamped dict goes straight into a gather graphed with
``torch.cuda.make_graphed_callables``, which takes tensors only — a
direct (zero-hop) leak. (A ``CapturedStep`` leaves ``_scenario_rows``
out of its graphs, ``aot._UNKEYED``: the port's echo token carries it
there by design.)

Expected finding: BJX120 in ``EchoSampler.draw`` at the
``self._draw_fn`` call, keys ``_scenario_rows``.
"""

import torch


def _gather_augment(batch):
    return batch


class EchoSampler:
    def __init__(self, example):
        self._draw_fn = torch.cuda.make_graphed_callables(
            _gather_augment, (example,))

    def draw(self, batch, rows):
        # per-scenario accounting sidecar, stamped on the live draw
        batch["_scenario_rows"] = rows
        return self._draw_fn(batch)  # BJX120: sidecar reaches the graph
