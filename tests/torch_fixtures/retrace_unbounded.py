"""Deliberately-recapturing fixture for BJX122 in the port's vocabulary:
the twin of ``tests/fixtures/retrace_unbounded.py``.

NOT production code — it exists so ``tests/test_torch_analysis.py`` can
assert the port's dataflow pass flags exactly the unbounded call site
end to end through the CLI; it lives under ``tests/torch_fixtures/`` so
the port's self-run never sees it.

``CapturedStep`` captures one CUDA graph per distinct plan signature,
which keys every host plan entry by value: feeding ``n=int(batch[
"count"])`` captures a graph (and a private memory pool) per distinct
count. The decode-plan contract bounds it by quantizing through the
bucket ladder first.

Expected finding: BJX122 in ``feed`` at the ``decode`` call, plan entry
``n``; ``feed_bucketed`` stays clean.
"""

from blendjax_torch.train import CapturedStep


def _decode(state, batch):
    del batch
    return state


decode = CapturedStep(_decode)


def pad_to_bucket(n):
    return max(64, 1 << int(n).bit_length())


def feed(state, batch):
    # BJX122: the host plan entry derives from the message itself
    return decode(state, {"tiles": batch["tiles"], "n": int(batch["count"])})


def feed_bucketed(state, batch):
    # sanctioned: quantized through the bucket ladder first
    n = pad_to_bucket(int(batch["count"]))
    return decode(state, {"tiles": batch["tiles"], "n": n})
