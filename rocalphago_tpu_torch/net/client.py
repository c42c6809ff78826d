"""The client-side reconnect/backoff loop every wire client shares.

A copy of the reference package's ``net/client.py``. A wire client
faces three retriable outcomes: the socket dropped (a kill, a drain
nudge, the network: a ``*Closed`` exception or a raw ``OSError``), the
server shed with a structured refusal carrying ``retry_after_s``
(``overload``/``draining``), or a plain transient.
:func:`call_with_backoff` retries all three with the deterministic
jitter the trainers use (:func:`rocalphago_tpu_torch.runtime.retries.
backoff_delay`: a resumed run replays the identical sleep schedule),
and **honors the server's hint**: when a refusal carries
``retry_after_s``, the sleep is at least that long, so shed clients
back off to the server's pacing instead of hammering the accept queue.

Anything that classifies as a programming error raises at once.
"""

from __future__ import annotations

import time

from rocalphago_tpu_torch.runtime import retries


def default_transient(exc: BaseException) -> bool:
    """Is this a wire outcome worth a reconnect/retry?

    True for socket-level failures (``OSError`` and friends), for any
    exception carrying a non-None ``retry_after_s`` (a structured
    refusal), and for the wire clients' ``*Closed`` / ``*Refused``
    taxonomy by name, so the helper needs no import of every protocol's
    exception classes.
    """
    if isinstance(exc, (OSError, TimeoutError, ConnectionError)):
        return True
    if getattr(exc, "retry_after_s", None) is not None:
        return True
    return type(exc).__name__.endswith(("Closed", "Refused"))


def call_with_backoff(fn, *, attempts: int = 6,
                      base_delay: float = 0.25, max_delay: float = 5.0,
                      seed: int = 0, key: str = "net.client",
                      transient=None, sleep=time.sleep):
    """Invoke ``fn()`` until it succeeds or the budget runs out.

    Between attempts sleeps ``max(backoff_delay(attempt, ...),
    retry_after_s)``: deterministic jitter as the floor, the server's
    refusal hint as the override. ``transient(exc) -> bool`` replaces
    :func:`default_transient`; non-transient exceptions and the final
    attempt's exception propagate unchanged. ``sleep`` is injectable so
    tests assert the schedule instead of waiting it.
    """
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    classify = default_transient if transient is None else transient
    for attempt in range(attempts):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 -- classified below
            if attempt + 1 >= attempts or not classify(e):
                raise
            delay = retries.backoff_delay(attempt, base_delay,
                                          max_delay, seed, key)
            hint = getattr(e, "retry_after_s", None)
            if hint is not None:
                delay = max(delay, float(hint))
            sleep(delay)
    raise AssertionError("unreachable")  # pragma: no cover
