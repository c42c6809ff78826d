"""Observability: tracing spans, the metric registry and launch
tracking.

The port of the reference package's ``obs/``. The pieces share one
output channel, the ``metrics.jsonl`` stream of
:class:`~rocalphago_tpu_torch.io.metrics.MetricsLogger`:

* :mod:`.trace` -- nested ``span(name)`` context managers emitting
  structured ``span`` records;
* :mod:`.registry` -- process-wide counters, gauges and bounded
  histograms with a deterministic snapshot and Prometheus-style text;
  the serving ladder and pool record here, and the GTP
  ``rocalphago-stats`` probe returns the live snapshot;
* :mod:`.torchobs` -- the counterpart of the reference's ``jaxobs``:
  ``track(entry, fn)`` counts each call's kernel launches into
  ``kernel_launches_total{entry=,kernel=}``, and the opt-in
  ``torch.profiler`` capture. Not imported here: the first two are
  standard library only.
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
