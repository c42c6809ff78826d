"""The replaynet wire protocol: NDJSON frames for game transport.

The port of the reference package's ``replaynet/protocol.py``, over the
port's :mod:`rocalphago_tpu_torch.net.protocol` framing (sorted-key
encoding, the frame-bound / torn-frame / blank-line reader rules); both
packages speak one wire, byte for byte. The server speaks first (a
``hello`` carrying ``proto``, the record ``schema`` it accepts and the
buffer capacity, or a structured refusal when the service sheds at
accept); after that the client drives request/response pairs
correlated by ``id``:

==============  ======================================================
request         response
==============  ======================================================
``hello``       ``ok`` (optional; pins the protocol version, a
                mismatch is ``bad_proto``)
``put_games``   ``ok`` with the ``game_id`` and ``dup`` flag, sent
                ONLY after the buffer accepted (and spilled) the
                record; a retry of an already-ingested id acks
                ``dup: true`` without re-inserting (errors:
                ``bad_schema``, ``overload`` + ``retry_after_s``)
``next_batch``  ``batch`` with the record and its buffer ``seq``, or
                ``empty`` when nothing arrived within ``timeout_s``
``stats``       ``stats`` with the service probe block
==============  ======================================================

``put_games`` carries one schema-v2 game record
(:func:`rocalphago_tpu_torch.data.replay.games_to_record`) with its
content-hash ``game_id``, the identity every dedup decision keys on.
``overload`` and ``draining`` carry ``retry_after_s``, so actors back
off into their spool instead of spinning. Frames are bounded at
:data:`MAX_FRAME_BYTES` (8 MiB, the reference's default: a frame
carries a whole game batch, not a genmove); a line over the bound is
refused with ``frame_too_big`` and the connection drops. The module
imports no torch.
"""

from __future__ import annotations

from rocalphago_tpu_torch.data.replay import RECORD_SCHEMA
from rocalphago_tpu_torch.net import protocol as _net

#: protocol revision carried in every hello
PROTO_VERSION = 1

#: bound on one wire frame (bytes, newline included): the reference's
#: default, 8 MiB where the gateway's is 64 KiB
MAX_FRAME_BYTES = 8 << 20

#: every error code a frame may carry
ERROR_CODES = (
    "bad_request",     # unparseable JSON / missing required field
    "bad_proto",       # client hello pinned an unsupported version
    "frame_too_big",   # line crossed the frame bound; connection drops
    "unknown_type",    # message type outside the protocol table
    "bad_schema",      # record schema newer than this server reads
    "overload",        # shed (buffer/conn cap); retry_after_s set
    "draining",        # server is drain-stopping; retry_after_s set
    "internal",        # handler fault; this request failed, conn holds
)

ProtocolError = _net.ProtocolError

encode_frame = _net.encode_frame


def max_frame_bytes() -> int:
    return MAX_FRAME_BYTES


def read_frame(reader, limit: int | None = None):
    """Next frame off a buffered binary reader, bounded at the replaynet
    frame limit by default (the shared reader rules:
    :func:`rocalphago_tpu_torch.net.protocol.read_frame`)."""
    return _net.read_frame(
        reader, max_frame_bytes() if limit is None else limit)


def error_frame(code: str, msg: str, id=None,
                retry_after_s: float | None = None) -> dict:
    return _net.error_frame(code, msg, id=id,
                            retry_after_s=retry_after_s,
                            codes=ERROR_CODES)


def hello_frame(capacity: int) -> dict:
    return {"type": "hello", "proto": PROTO_VERSION,
            "name": "rocalphago-replaynet",
            "schema": RECORD_SCHEMA,
            "capacity": int(capacity)}
