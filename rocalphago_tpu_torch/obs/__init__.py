"""Observability: tracing spans and the metric registry.

The port of the reference package's ``obs/`` (its ``jaxobs`` compile
tracking has no counterpart yet). Both pieces are standard library only
and share one output channel, the ``metrics.jsonl`` stream of
:class:`~rocalphago_tpu_torch.io.metrics.MetricsLogger`:

* :mod:`.trace` -- nested ``span(name)`` context managers emitting
  structured ``span`` records;
* :mod:`.registry` -- process-wide counters, gauges and bounded
  histograms with a deterministic snapshot and Prometheus-style text;
  the serving ladder and pool record here, and the GTP
  ``rocalphago-stats`` probe returns the live snapshot.
"""

from rocalphago_tpu_torch.obs import registry, trace  # noqa: F401
from rocalphago_tpu_torch.obs.registry import (  # noqa: F401
    REGISTRY,
    counter,
    gauge,
    histogram,
    render_text,
    reset,
    snapshot,
)
from rocalphago_tpu_torch.obs.trace import (  # noqa: F401
    configure,
    current_path,
    emit,
    span,
    where,
)
