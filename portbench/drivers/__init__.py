"""One traffic driver per kind of traffic, found by the name in a
workload file: ``setup(run)``, ``window(live, run)``, ``release(live)``
and ``check(evidence, run)``."""
