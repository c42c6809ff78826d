"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

Loads the cell named in ``BENCHMARK.json`` (its workload file, its
configuration and its traffic driver, all found by name under
``portbench/``), sets it up, warms up every shape it uses, measures for
``--seconds`` seconds, checks the timed path's outputs against the
plain reference and prints one JSON object as the last line of
standard output. Without a CUDA card it exits with code 2 and prints
no result.
"""

import time

# set-up is timed from here: the interpreter's own start is a constant
T_START = time.monotonic()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pin_caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed
    paths, so only a checkout's first run builds and compiles."""
    base = os.path.join(ROOT, "build", "portbench")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = os.path.join(base, sub)


if __name__ == "__main__":
    _pin_caches()
    sys.path.insert(0, ROOT)
    from portbench import harness

    sys.exit(harness.main(sys.argv[1:], T_START))
