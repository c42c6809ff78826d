"""Share of the input pipeline's worker's read and pin time in which its
thread ran on no core, in percent: one less its CPU seconds
(``prefetch_stage_cpu_seconds_total``) over its wall seconds
(``prefetch_stage_seconds``), over ``read`` and ``pin`` together, as
``data/pipeline.py::device_prefetch`` records them in the program's
registry. Waiting for a core or the GIL counts as off the CPU, and so
does waiting for torch's intra-op helper threads in the pin copy.

The totals cover every batch the run staged: set-up's 8 steps, the
window's (about 684 at 30 s) and the traced steps after it (about 37),
so the window accounts for over 90% of them; ``run.py`` runs one cell
per process, so no other run's batches are among them. The registry is
read when the reader is called, after the run is released; a program
without these series reads None.
"""


def read(r):
    from rocalphago_tpu_torch.obs import registry

    snap = registry.REGISTRY.snapshot()
    wall = cpu = 0.0
    for stage in ("read", "pin"):
        h = snap["histograms"].get(
            f'prefetch_stage_seconds{{stage="{stage}"}}')
        c = snap["counters"].get(
            f'prefetch_stage_cpu_seconds_total{{stage="{stage}"}}')
        if not h or c is None:
            return None
        wall += h["sum"]
        cpu += c
    if wall <= 0:
        return None
    return 100.0 * (1.0 - cpu / wall)
