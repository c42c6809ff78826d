"""Retry with deterministic-jitter exponential backoff.

A copy of the part of the reference package's ``runtime/retries.py``
that the checkpointer uses: :func:`retry` with its defaults, the
backoff with jitter hashed from a seed, the wrapped function's name
and the attempt index (so an interrupted-and-resumed run replays the
identical sleep schedule), and the classifier. Infrastructure flake --
filesystem, network, timeouts -- is transient and re-invoked;
programming errors surface immediately.

Only retry pure work: an idempotent artifact write or read.
"""

from __future__ import annotations

import functools
import hashlib
import sys
import time

_MAX_DELAY = 30.0

# programming errors: never retry, whatever the message says
_FATAL_TYPES = (TypeError, ValueError, KeyError, IndexError,
                AttributeError, AssertionError, ZeroDivisionError,
                NotImplementedError, KeyboardInterrupt, SystemExit)


def is_transient(exc: BaseException) -> bool:
    """True if ``exc`` looks like infrastructure flake worth another
    attempt; False for programming errors."""
    if isinstance(exc, _FATAL_TYPES):
        return False
    return isinstance(exc, (OSError, TimeoutError, ConnectionError))


def backoff_delay(attempt: int, base: float, cap: float,
                  seed: int, key: str) -> float:
    """Exponential backoff with deterministic jitter in
    [0.5x, 1.0x] of the exponential envelope."""
    envelope = min(cap, base * (2.0 ** attempt))
    digest = hashlib.sha256(
        f"{seed}:{key}:{attempt}".encode()).digest()
    frac = int.from_bytes(digest[:8], "big") / float(1 << 64)
    return envelope * (0.5 + 0.5 * frac)


def retry(max_attempts: int = 3, base_delay: float = 0.5):
    """Decorator: re-invoke on transient failures (:func:`is_transient`),
    with deterministic-jitter exponential backoff between attempts
    (seed 0, capped at ``_MAX_DELAY`` seconds); non-transient exceptions and the final attempt's
    exception propagate unchanged."""
    if max_attempts < 1:
        raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")

    def decorate(fn):
        key = getattr(fn, "__qualname__", None) or repr(fn)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            for attempt in range(max_attempts):
                try:
                    return fn(*args, **kwargs)
                except BaseException as e:  # noqa: BLE001 — classified below
                    if attempt + 1 >= max_attempts or not is_transient(e):
                        raise
                    delay = backoff_delay(attempt, base_delay,
                                          _MAX_DELAY, 0, key)
                    print(f"retries: {key} attempt "
                          f"{attempt + 1}/{max_attempts} failed "
                          f"({type(e).__name__}: {e}); retrying "
                          f"in {delay:.2f}s", file=sys.stderr)
                    time.sleep(delay)
            raise AssertionError("unreachable")  # pragma: no cover

        return wrapper

    return decorate
