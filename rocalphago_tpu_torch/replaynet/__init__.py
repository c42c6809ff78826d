"""Replay over the wire: the networked replay service.

The port of the reference package's ``replaynet/``, on the port's
``net/`` core; both packages speak one wire, byte for byte, so either
package's actors and learner talk to either package's service. Actor
processes stream finished self-play games to a replay service the
learner consumes from:

* :mod:`~rocalphago_tpu_torch.replaynet.protocol` -- the NDJSON protocol
  content (``put_games``/``next_batch``/``stats`` over schema-v2 game
  records);
* :mod:`~rocalphago_tpu_torch.replaynet.server` -- :class:`~rocalphago_
  tpu_torch.replaynet.server.ReplayService`: at-least-once ingestion
  made exactly-once (content-hash ``game_id`` dedup window, ack only
  after the buffer accepts), ``overload``/``draining`` shedding with
  ``retry_after_s``, the fault barriers ``replay.put``/``replay.take``/
  ``replay.conn``, and a drain that leaves the buffer spilled for a
  restart;
* :mod:`~rocalphago_tpu_torch.replaynet.client` -- :class:`~rocalphago_
  tpu_torch.replaynet.client.ReplayClient` (deadline-bounded requests,
  reconnect with deterministic-jitter backoff, degraded mode over a
  crash-safe spool WAL) and the learner-side :class:`~rocalphago_tpu_
  torch.replaynet.client.RemoteReplayBuffer`;
* :mod:`~rocalphago_tpu_torch.replaynet.actor` -- the actor process
  (search self-play on the card, or the synthetic generator).

Only the actor's self-play mode loads torch and touches a device.
"""

from rocalphago_tpu_torch.replaynet.protocol import PROTO_VERSION  # noqa: F401
