"""Share of the input pipeline's gets that found its queue empty, in
percent: ``prefetch_starved_total`` over ``prefetch_batches_total``,
both counted by ``data/pipeline.py::device_prefetch`` in the program's
registry.

The totals cover every batch the run staged: set-up's 8 steps, the
window's (about 684 at 30 s) and the traced steps after it (about 37),
so the window accounts for over 90% of them; ``run.py`` runs one cell
per process, so no other run's batches are among them. The registry is
read when the reader is called, after the run is released; a program
without these series reads None.
"""


def read(r):
    from rocalphago_tpu_torch.obs import registry

    counters = registry.REGISTRY.snapshot()["counters"]
    batches = counters.get("prefetch_batches_total")
    if not batches or "prefetch_starved_total" not in counters:
        return None
    return 100.0 * counters["prefetch_starved_total"] / batches
