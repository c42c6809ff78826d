"""NDJSON framing shared by every wire protocol (the gateway's).

A copy of the reference package's ``net/protocol.py``: both packages
speak one wire, so a frame that either package writes, the other
reads into the same dict.
One frame = one JSON object on one line. The rules every reader and
writer agrees on:

* frames encode with **sorted keys** (byte-stable frames make
  wire-level tests and captures diffable);
* a line longer than the frame bound (newline included) is refused
  with a FATAL ``frame_too_big``: the reader cannot resynchronize
  mid-line, so the connection drops;
* a torn frame (EOF before the newline) is a disconnect, not an error;
* a blank line is neither: it is skipped, so keepalive-style bare
  newlines do not kill the conversation;
* undecodable JSON, or JSON that is not an object, on an intact line
  is a NON-fatal ``bad_request``: the line boundary survived, the
  connection can report and go on.

Error-code vocabularies stay per protocol: :func:`error_frame`
validates against the ``codes`` tuple its caller pins (the gateway's
``ERROR_CODES``), so a typo'd code fails loudly in tests rather than
shipping an unknown refusal.
"""

from __future__ import annotations

import json


class ProtocolError(Exception):
    """A frame the reader cannot accept; ``code`` names why and
    ``fatal`` says whether the connection can survive it (a torn byte
    stream cannot: the next line boundary is unknowable)."""

    def __init__(self, code: str, msg: str, fatal: bool = False):
        super().__init__(msg)
        self.code = code
        self.fatal = fatal


def encode_frame(msg: dict) -> bytes:
    """One dict → one NDJSON line (sorted keys)."""
    return (json.dumps(msg, sort_keys=True) + "\n").encode("utf-8")


def read_frame(reader, limit: int):
    """Next frame off a buffered binary reader.

    Returns the decoded dict, or None on a clean EOF or a torn trailing
    line (both are disconnects). Blank lines are skipped. Raises
    :class:`ProtocolError` for a line longer than ``limit`` bytes,
    newline included (fatal), or undecodable JSON (non-fatal).
    """
    while True:
        line = reader.readline(limit + 1)
        if not line:
            return None
        if len(line) > limit:
            # over the bound whether or not the newline made it into
            # the read: a complete limit+1-byte line and a partial read
            # mid-line are both over
            raise ProtocolError(
                "frame_too_big",
                f"frame exceeds {limit} bytes", fatal=True)
        if not line.endswith(b"\n"):
            return None                   # torn frame at EOF
        line = line.strip()
        if line:
            break                         # blank line: keep reading
    try:
        msg = json.loads(line.decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as e:
        raise ProtocolError("bad_request", f"undecodable frame: {e}")
    if not isinstance(msg, dict):
        raise ProtocolError("bad_request",
                            "frame must be a JSON object")
    return msg


def error_frame(code: str, msg: str, id=None,
                retry_after_s: float | None = None,
                codes: tuple | None = None) -> dict:
    """A typed refusal frame. ``codes`` is the calling protocol's error
    vocabulary; passing it turns a typo'd code into an AssertionError
    in tests instead of an unknown refusal on the wire."""
    if codes is not None:
        assert code in codes, code
    out = {"type": "error", "code": code, "msg": msg}
    if id is not None:
        out["id"] = id
    if retry_after_s is not None:
        out["retry_after_s"] = round(float(retry_after_s), 3)
    return out
