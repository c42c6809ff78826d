"""The gateway wire protocol: newline-delimited JSON, versioned.

A copy of the reference package's ``gateway/protocol.py``, with its
defaults and no environment knob. One frame = one JSON object on one
line (NDJSON). The server speaks first (a ``hello`` frame carrying
``proto`` and the active board sizes, or a structured refusal when the
gateway sheds the connection); after that the client drives
request/response pairs correlated by ``id``:

=============  =======================================================
request        response
=============  =======================================================
``hello``      ``ok`` (optional; pins the protocol version -- a
               mismatch is ``bad_proto``)
``new_game``   ``ok`` with the admitted ``board``/``komi`` (errors:
               ``bad_board``, ``overload`` + ``retry_after_s``)
``play``       ``ok`` (error ``illegal_move`` leaves the game
               untouched)
``genmove``    ``move`` with the vertex, elapsed wall time and the
               resilience rung that produced it
``komi``       ``ok`` (re-threads the live session's komi)
``close``      ``ok`` (ends the game, releases the session slot; the
               connection may open another game)
=============  =======================================================

Typed error codes (``{"type": "error", "code": ...}``) are the
protocol's refusal surface -- a shed never looks like a hang:
``overload`` and ``draining`` carry ``retry_after_s``. Frames are
bounded at :func:`max_frame_bytes` (newline included); a line over the
bound is refused with ``frame_too_big`` and the connection dropped. A
torn frame is a disconnect; a blank line is skipped.

Framing is the shared :mod:`rocalphago_tpu_torch.net.protocol` core;
this module pins the gateway's protocol CONTENT on top of it: the
version, the error-code vocabulary, the frame bound and the hello.
"""

from __future__ import annotations

from rocalphago_tpu_torch.net import protocol as _net

#: protocol revision carried in every hello; bumped on any frame schema
#: change a deployed client could observe
PROTO_VERSION = 1

#: bound on one wire frame (bytes, newline included)
MAX_FRAME_BYTES = 65536

#: every error code a frame may carry
ERROR_CODES = (
    "bad_request",     # unparseable JSON / missing required field
    "bad_proto",       # client hello pinned an unsupported version
    "frame_too_big",   # line crossed the frame bound; connection drops
    "unknown_type",    # message type outside the protocol table
    "bad_board",       # requested size not served by this pool
    "illegal_move",    # play refused; game state untouched
    "no_game",         # play/genmove/komi/close before new_game
    "game_over",       # move requested after the game ended
    "overload",        # shed (admission/conn cap); retry_after_s set
    "draining",        # server is drain-stopping; retry_after_s set
    "internal",        # handler fault; this request failed, game holds
)

#: the shared framing core's exception and encoder, re-exported
ProtocolError = _net.ProtocolError

encode_frame = _net.encode_frame


def max_frame_bytes() -> int:
    """The frame bound (the reference's default; no knob)."""
    return MAX_FRAME_BYTES


def read_frame(reader, limit: int | None = None):
    """Next frame off a buffered binary reader, bounded at the
    gateway's frame limit by default (shared reader rules:
    :func:`rocalphago_tpu_torch.net.protocol.read_frame`)."""
    return _net.read_frame(
        reader, max_frame_bytes() if limit is None else limit)


def error_frame(code: str, msg: str, id=None,
                retry_after_s: float | None = None) -> dict:
    return _net.error_frame(code, msg, id=id,
                            retry_after_s=retry_after_s,
                            codes=ERROR_CODES)


def hello_frame(boards, default_board: int,
                slo_ms: float | None) -> dict:
    return {"type": "hello", "proto": PROTO_VERSION,
            "name": "rocalphago-gateway",
            "boards": [int(b) for b in boards],
            "default_board": int(default_board),
            "slo_ms": slo_ms}
