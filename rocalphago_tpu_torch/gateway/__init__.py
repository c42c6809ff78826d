"""Network play gateway: the serve pool behind a wire.

The port of the reference package's ``gateway/``; both packages speak
one protocol, byte for byte, so either package's client talks to
either package's server. GTP over stdin and the pools as Python objects
are process-local; the gateway puts the pool on the network:

* :mod:`~rocalphago_tpu_torch.gateway.protocol` -- the versioned NDJSON
  wire protocol (``new_game``/``play``/``genmove``/``komi``/``close``
  plus typed error codes, ``overload`` carrying a retry-after hint);
* :mod:`~rocalphago_tpu_torch.gateway.server` -- a threaded socket
  server mapping one connection to one pool session, with
  connection caps and the pool's admission (structured refusals, never
  hangs), per-request SLO deadlines, the resilience ladder per
  session, multi-size ``board`` routing, and a SIGTERM graceful drain;
* :mod:`~rocalphago_tpu_torch.gateway.httpapi` -- ``/healthz`` (the
  pool's health JSON plus a ``"gateway"`` block) and ``/metrics`` (the
  obs registry's Prometheus rendering);
* :mod:`~rocalphago_tpu_torch.gateway.client` -- the client handle, the
  reconnecting client and the load generator.

The server's sessions search on the pool's device (the card unless
the CLI is given ``--device cpu``); the wire, the client and the probes
touch no device.
"""

from rocalphago_tpu_torch.gateway.protocol import PROTO_VERSION  # noqa: F401
