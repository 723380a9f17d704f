"""The threadguard indirection of ``blendjax/utils/tg.py``, disabled.

The JAX package's ``guard`` wraps an object in a lock-discipline sanitizer
when ``BLENDJAX_THREADGUARD`` is set. The sanitizer is test tooling of the
JAX package and not part of the port, so here ``guard`` is always the
identity: the wired objects are exactly the objects passed in.
"""

from __future__ import annotations


def guard(obj, **kwargs):  # noqa: ARG001 - mirror the real signature
    """Identity: the port has no sanitizer to wrap ``obj`` in."""
    return obj


__all__ = ["guard"]
