"""Per-stream shape/dtype contracts (copied from ``blendjax/data/schema.py``).

A :class:`StreamSchema` declares, per key, the per-item shape and dtype;
it is written down or inferred from the first item, and every later item
is validated against it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from blendjax_torch.scenario.accounting import SCENARIO_KEY


@dataclass(frozen=True)
class FieldSpec:
    shape: tuple
    dtype: np.dtype

    def __repr__(self):
        return (f"FieldSpec(shape={self.shape}, "
                f"dtype={np.dtype(self.dtype).name})")


class SchemaError(ValueError):
    pass


class StreamSchema:
    """Mapping ``key -> FieldSpec`` for the tensor fields of a stream;
    ``meta_keys`` (e.g. ``btid``) ride per batch in ``_meta`` instead.

    The scenario stamp ``_scenario`` is a default meta key, not only one
    inferred from the first item: a mixed fleet's first item may be
    unstamped, and a schema frozen from it would drop every later stamp
    at batch assembly."""

    DEFAULT_META_KEYS = ("btid", SCENARIO_KEY)

    def __init__(self, fields: dict, meta_keys=DEFAULT_META_KEYS):
        self.fields = {
            k: v if isinstance(v, FieldSpec)
            else FieldSpec(tuple(v[0]), np.dtype(v[1]))
            for k, v in fields.items()
        }
        self.meta_keys = tuple(meta_keys)

    @classmethod
    def infer(cls, item: dict, meta_keys=DEFAULT_META_KEYS) -> "StreamSchema":
        """Infer the contract from one item: arrays and scalars become
        fields, anything else metadata."""
        fields = {}
        meta = list(meta_keys)
        for k, v in item.items():
            if k in meta_keys:
                continue
            if isinstance(v, np.ndarray):
                fields[k] = FieldSpec(v.shape, v.dtype)
            elif isinstance(v, (bool, int, float, np.generic)):
                fields[k] = FieldSpec((), np.asarray(v).dtype)
            else:
                meta.append(k)
        return cls(fields, meta_keys=tuple(meta))

    def validate(self, item: dict) -> None:
        for k, spec in self.fields.items():
            if k not in item:
                raise SchemaError(f"item missing field {k!r}")
            v = np.asarray(item[k])
            if tuple(v.shape) != spec.shape:
                raise SchemaError(
                    f"field {k!r}: shape {v.shape} != schema {spec.shape}"
                )
            if v.dtype != spec.dtype:
                raise SchemaError(
                    f"field {k!r}: dtype {v.dtype} != schema {spec.dtype}"
                )

    def batch_shapes(self, batch_size: int) -> dict:
        """``{key: (batch_size, *per-item shape)}``."""
        return {
            k: (batch_size, *spec.shape) for k, spec in self.fields.items()
        }

    def keys(self):
        return self.fields.keys()

    def __repr__(self):
        return f"StreamSchema({self.fields}, meta={self.meta_keys})"
