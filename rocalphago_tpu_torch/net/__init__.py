"""The shared wire-service core: the machinery every NDJSON server of
the port reuses. The port of the reference package's ``net/``, byte
for byte on the wire:

* :mod:`~rocalphago_tpu_torch.net.protocol` -- NDJSON framing (one
  JSON object per line, sorted keys), the frame-bound / torn-frame /
  blank-line reader rules, and typed error frames;
* :mod:`~rocalphago_tpu_torch.net.server` -- :class:`~rocalphago_tpu_torch.
  net.server.LineServerCore`: the threaded accept loop with structured
  admission (``overload``/``draining`` refusals, never a hang), the
  per-connection handler threads and registry, and the bounded
  three-step graceful drain;
* :mod:`~rocalphago_tpu_torch.net.client` -- :func:`~rocalphago_tpu_torch.
  net.client.call_with_backoff`: the reconnect/backoff loop every wire
  client shares, honoring a refusal's ``retry_after_s`` hint on top of
  :func:`rocalphago_tpu_torch.runtime.retries.backoff_delay`'s
  deterministic jitter.

Protocol *content* (message types, error-code vocabularies, hello
frames, versioning) stays with each service (``gateway/`` pins its
own), so this layer never needs a cross-service schema bump. Nothing
here touches a device.
"""
