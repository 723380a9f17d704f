"""Runtime thread-affinity / lock-discipline sanitizer (a copy of the
JAX package's ``blendjax/testing/threadguard.py``; stdlib only).

A guarded object is wrapped in a delegating proxy that, on every
attribute access, records the accessing thread and (in lock mode) the
required lock's ownership, and raises immediately on a violation, which
turns a once-in-a-soak data race into a deterministic test failure at
the exact access site.

Two disciplines:

- **affinity**: the object belongs to ONE thread: ``"creator"`` binds
  it to the constructing thread (the libzmq socket contract),
  ``"first-use"`` to whichever thread touches it first (the echo
  reservoir: born on the thread that first draws from it).
- **lock**: every access must run with the given lock held by the
  accessing thread. ``RLock``/``Condition`` ownership is exact
  (``_is_owned``); a plain ``Lock`` degrades to ``locked()`` (held by
  *someone*), since CPython records no owner for it.

Production wiring goes through :mod:`blendjax_torch.utils.tg`, which
re-exports :func:`guard` ONLY when ``BLENDJAX_THREADGUARD`` is set (not
``""``, ``"0"`` or ``"false"``) and is an identity function otherwise:
the disabled path adds no per-access cost and never imports this module.

One addition to the JAX package's copy: a method fetched through a guard
carries ``__self__`` (the guard), as a bound method does.
"""

from __future__ import annotations

import threading

__all__ = [
    "LockDisciplineError",
    "ThreadAffinityError",
    "ThreadGuardError",
    "guard",
    "unguard",
]


class ThreadGuardError(AssertionError):
    """Base: a guarded object was accessed against its declaration."""


class ThreadAffinityError(ThreadGuardError):
    """A single-thread object was touched from a second thread."""


class LockDisciplineError(ThreadGuardError):
    """A lock-guarded object was touched without its lock held."""


# Serializes first-use binding (a check-then-act) across all guards;
# module-wide is fine — binding happens once per guarded object.
_BIND_LOCK = threading.Lock()


def _lock_held(lock: object) -> bool:
    """Best-effort 'does the CALLING thread hold this lock'. RLock and
    Condition expose exact ownership; a plain Lock only knows whether
    anyone holds it."""
    is_owned = getattr(lock, "_is_owned", None)
    if is_owned is not None:
        return bool(is_owned())
    locked = getattr(lock, "locked", None)
    if locked is not None:
        return bool(locked())
    raise TypeError(f"not a lock: {lock!r}")


class _Guarded:
    """Delegating proxy: every attribute access runs the declared
    checks, then forwards to the wrapped object."""

    __slots__ = (
        "_tg_obj",
        "_tg_name",
        "_tg_mode",
        "_tg_lock",
        "_tg_thread",
        "_tg_thread_name",
        "_tg_exempt",
    )

    def __init__(self, obj, name, affinity, lock, exempt):
        object.__setattr__(self, "_tg_obj", obj)
        object.__setattr__(self, "_tg_name", name)
        object.__setattr__(self, "_tg_mode", affinity)
        object.__setattr__(self, "_tg_lock", lock)
        object.__setattr__(self, "_tg_exempt", frozenset(exempt or ()))
        bound = threading.current_thread() if affinity == "creator" else None
        object.__setattr__(
            self, "_tg_thread", bound.ident if bound else None
        )
        object.__setattr__(
            self, "_tg_thread_name", bound.name if bound else None
        )

    # -- the check ---------------------------------------------------------

    def _tg_check(self, attr: str) -> None:
        if attr in self._tg_exempt:
            return
        lock = self._tg_lock
        if lock is not None and not _lock_held(lock):
            raise LockDisciplineError(
                f"threadguard: '{self._tg_name}.{attr}' accessed from "
                f"thread '{threading.current_thread().name}' without "
                "holding the declared lock"
            )
        if self._tg_mode is not None:
            me = threading.current_thread()
            owner = self._tg_thread
            if owner is None:  # first-use: bind now
                # Binding is check-then-act: without the bind lock, two
                # threads racing the FIRST access would both pass and
                # the sanitizer would miss exactly the race it exists
                # to catch. One-time cost, never on the bound path.
                with _BIND_LOCK:
                    owner = self._tg_thread
                    if owner is None:
                        object.__setattr__(self, "_tg_thread", me.ident)
                        object.__setattr__(
                            self, "_tg_thread_name", me.name
                        )
                        return
            if owner != me.ident:
                raise ThreadAffinityError(
                    f"threadguard: '{self._tg_name}.{attr}' accessed "
                    f"from thread '{me.name}' but the object is bound "
                    f"to thread '{self._tg_thread_name}' "
                    f"({self._tg_mode} affinity)"
                )

    # -- delegation --------------------------------------------------------

    def __getattr__(self, name):
        if name in self._tg_exempt:
            return getattr(self._tg_obj, name)
        self._tg_check(name)
        value = getattr(self._tg_obj, name)
        if callable(value) and not isinstance(value, type):
            # Re-check at CALL time, not just fetch time: a bound
            # method handed to another thread (``Thread(target=
            # guarded.method)``) must still trip the guard when it
            # actually runs.
            def checked(*args, **kwargs):
                self._tg_check(name)
                return value(*args, **kwargs)

            # a bound method keeps its owner in sight, as the guard: code
            # that finds an object from its bound method (the echo step's
            # hooks from ``reservoir.draw``) reaches it through the checks
            checked.__self__ = self
            return checked
        return value

    def __setattr__(self, name, value):
        self._tg_check(name)
        setattr(self._tg_obj, name, value)

    def __getitem__(self, key):
        self._tg_check("__getitem__")
        return self._tg_obj[key]

    def __setitem__(self, key, value):
        self._tg_check("__setitem__")
        self._tg_obj[key] = value

    def __delitem__(self, key):
        self._tg_check("__delitem__")
        del self._tg_obj[key]

    def __contains__(self, key):
        self._tg_check("__contains__")
        return key in self._tg_obj

    def __iter__(self):
        self._tg_check("__iter__")
        return iter(self._tg_obj)

    def __len__(self):
        self._tg_check("__len__")
        return len(self._tg_obj)

    def __bool__(self):
        self._tg_check("__bool__")
        return bool(self._tg_obj)

    def __call__(self, *args, **kwargs):
        self._tg_check("__call__")
        return self._tg_obj(*args, **kwargs)

    def __enter__(self):
        self._tg_check("__enter__")
        return self._tg_obj.__enter__()

    def __exit__(self, *exc):
        self._tg_check("__exit__")
        return self._tg_obj.__exit__(*exc)

    def __repr__(self):
        return (
            f"<threadguard {self._tg_name!r} "
            f"{self._tg_mode or 'lock'}: {self._tg_obj!r}>"
        )


def guard(
    obj,
    *,
    name: str | None = None,
    affinity: str | None = None,
    lock: object | None = None,
    exempt: tuple = (),
):
    """Wrap ``obj`` in a checking proxy.

    - ``affinity="creator"`` — bind to the calling thread now.
    - ``affinity="first-use"`` — bind to the first accessing thread.
    - ``lock=some_lock`` — every access must hold ``some_lock``
      (composable with affinity).
    - ``exempt=("close", "lock")`` — attribute names skipped by the
      checks (teardown surfaces that legitimately cross threads, or
      the lock handle a caller must fetch BEFORE holding it).

    Idempotent: guarding a guard returns it unchanged. At least one of
    ``affinity``/``lock`` is required — an uncheckable guard is a bug
    in the wiring, not a permissive mode.
    """
    if isinstance(obj, _Guarded):
        return obj
    if affinity not in (None, "creator", "first-use"):
        raise ValueError(f"unknown affinity {affinity!r}")
    if affinity is None and lock is None:
        raise ValueError("guard() needs affinity= and/or lock=")
    return _Guarded(
        obj, name or type(obj).__name__, affinity, lock, exempt
    )


def unguard(obj):
    """The raw object behind a guard (identity for anything else)."""
    return obj._tg_obj if isinstance(obj, _Guarded) else obj
