"""Host milliseconds the input pipeline's worker spends staging a batch
for the card (the host tensors, the pinned copies and the transfers and
event queued on its side stream): the mean of
``prefetch_stage_seconds{stage="pin"}``, recorded by
``data/pipeline.py::device_prefetch`` in the program's registry.

The totals cover every batch the run staged: set-up's 8 steps, the
window's (about 684 at 30 s) and the traced steps after it (about 37),
so the window accounts for over 90% of them; ``run.py`` runs one cell
per process, so no other run's batches are among them. The registry is
read when the reader is called, after the run is released; a program
without these series reads None.
"""


def read(r):
    from rocalphago_tpu_torch.obs import registry

    h = registry.REGISTRY.snapshot()["histograms"].get(
        'prefetch_stage_seconds{stage="pin"}')
    if not h or not h["count"]:
        return None
    return 1e3 * h["sum"] / h["count"]
