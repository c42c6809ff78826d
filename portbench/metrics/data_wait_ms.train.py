"""Host milliseconds a step spends waiting in ``next()`` on the
input pipeline's prefetcher, over the window."""


def read(r):
    steps = r.counters.get("steps")
    if not steps or "data_wait_s" not in r.counters:
        return None
    return 1e3 * r.counters["data_wait_s"] / steps
