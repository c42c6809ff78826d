"""Retry with deterministic-jitter exponential backoff.

A copy of the part of the reference package's ``runtime/retries.py``
that the checkpointer and the zero loop use: :func:`retry` with its
defaults and :func:`retry_call`, the
backoff with jitter hashed from a seed, the wrapped function's name
and the attempt index (so an interrupted-and-resumed run replays the
identical sleep schedule), and the classifier. Infrastructure flake --
filesystem, network, timeouts -- is transient and re-invoked;
programming errors surface immediately.

The device half of the classifier is CUDA's, where the reference names
XLA's status words: an out-of-memory error is transient (XLA's
``RESOURCE_EXHAUSTED``: the allocation may fit once other work frees
its memory), while a sticky CUDA error -- ``torch.AcceleratorError``,
or a ``RuntimeError`` whose message starts ``CUDA error:`` (an illegal
address, a launch failure) -- is not: it poisons the context, and
every retry would replay it. The module loads no torch: with torch not
imported, no CUDA error can exist, so the host-only processes (the
replay service, its synthetic actors) start without it.

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
    torch = sys.modules.get("torch")
    if torch is not None:
        if isinstance(exc, torch.cuda.OutOfMemoryError):
            return True
        # a sticky CUDA error poisons the context: never retry
        sticky = getattr(torch, "AcceleratorError", None)
        if (sticky is not None and isinstance(exc, sticky)) or (
                isinstance(exc, RuntimeError)
                and str(exc).startswith("CUDA error:")):
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


def retry(max_attempts: int = 3, base_delay: float = 0.5, logger=None):
    """Decorator: re-invoke on transient failures (:func:`is_transient`),
    with deterministic-jitter exponential backoff between attempts
    (seed 0, capped at ``_MAX_DELAY`` seconds); non-transient exceptions and the final attempt's
    exception propagate unchanged. ``logger`` (``log(event, **fields)``,
    a ``MetricsLogger``) also gets a ``retry`` event per retried
    failure."""
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
                    if logger is not None:
                        logger.log("retry", fn=key, attempt=attempt + 1,
                                   error=f"{type(e).__name__}: {e}",
                                   delay_s=round(delay, 3))
                    print(f"retries: {key} attempt "
                          f"{attempt + 1}/{max_attempts} failed "
                          f"({type(e).__name__}: {e}); retrying "
                          f"in {delay:.2f}s", file=sys.stderr)
                    time.sleep(delay)
            raise AssertionError("unreachable")  # pragma: no cover

        return wrapper

    return decorate


def retry_call(fn, *args, _retry_kwargs: dict | None = None, **kwargs):
    """One-shot form: ``retry_call(f, x, y)`` is ``retry()(f)(x, y)``."""
    return retry(**(_retry_kwargs or {}))(fn)(*args, **kwargs)
