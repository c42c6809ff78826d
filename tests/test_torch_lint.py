"""The reference's static analysis (``rocalphago_tpu.analysis``, the
jaxlint rules) held over the port, on the CPU.

Every rule is on and the port must have no finding. Configuration
differs from the reference's ``[tool.jaxlint]`` only where the port's
layout does:

* the probe-schema rules read the port's own producers (its
  ``ServePool``, ``GatewayServer``, ``ReplayService``, ``RolloutRouter``
  and ``CanaryController``) against the reference's documented schemas,
  which the port keeps;
* the fault-barrier rules read the reference's resilience document,
  whose barriers the port keeps;
* the knob and metric-inventory documents are the reference's own
  tables: the port reads no environment knob at all, and its registry
  names are held to the reference's, divergences listed, by
  ``tests/test_torch_obs_training.py``; those two documents are not
  read here.

The four findings the reference suppresses or baselines carry its
suppression and its note in the port.
"""

import os
import re
import shutil

from rocalphago_tpu.analysis.config import LintConfig
from rocalphago_tpu.analysis.core import lint_source, run_lint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "rocalphago_tpu_torch"

CONFIG = dict(
    include=(PORT,),
    docs_knobs="",
    docs_observability="",
    serve_probe_module=f"{PORT}/serve/sessions.py",
    gateway_probe_module=f"{PORT}/gateway/server.py",
    replaynet_probe_module=f"{PORT}/replaynet/server.py",
    router_probe_module=f"{PORT}/rollout/router.py",
    canary_probe_module=f"{PORT}/rollout/canary.py",
)

#: the suppressed sites: (file, rule) → a phrase of the reference's note
SUPPRESSED = {
    ("training/actor.py", "callback-under-lock"):
        "the callback IS the protected resource",
    ("interface/resilient.py", "thread-no-join"):
        "joining a wedged search would",
    ("io/metrics.py", "blocking-call-under-lock"):
        "the lock exists to serialize exactly this",
}


def test_the_port_has_no_finding():
    config = LintConfig(**CONFIG)
    assert not config.disable
    findings = run_lint(ROOT, config)
    assert not findings, "\n".join(f.render() for f in findings)


def suppressions(root: str, pkg: str) -> dict:
    """``{(file, rule): [line, ...]}`` of every inline suppression."""
    out = {}
    base = os.path.join(root, pkg)
    for dirpath, _, files in os.walk(base):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            with open(path) as fh:
                lines = fh.read().splitlines()
            for i, text in enumerate(lines):
                m = re.search(r"#\s*jaxlint:\s*disable=([\w,-]+)", text)
                if m:
                    rel = os.path.relpath(path, base)
                    for rule in m.group(1).split(","):
                        out.setdefault((rel, rule), []).append(i)
    return out


def test_the_suppressions_are_the_references_with_their_notes():
    got = suppressions(ROOT, PORT)
    assert set(got) == set(SUPPRESSED)
    assert len(got[("training/actor.py", "callback-under-lock")]) == 2
    with open(os.path.join(ROOT, ".jaxlint-baseline.json")) as f:
        baseline = f.read()
    ref = suppressions(ROOT, "rocalphago_tpu")
    for (rel, rule), phrase in SUPPRESSED.items():
        # the reference suppresses the same rule in the same module, or
        # baselines it with this note
        assert (rel, rule) in ref or (
            f'"rule": "{rule}"' in baseline
            and f"rocalphago_tpu/{rel}" in baseline
            and phrase in baseline), (rel, rule)
        with open(os.path.join(ROOT, PORT, rel)) as f:
            lines = f.read().splitlines()
        for i in got[(rel, rule)]:
            # the comment block above the suppressed line, and the line
            block = " ".join(line.strip().lstrip("#").strip()
                             for line in lines[max(0, i - 4):i + 1])
            assert phrase in block or "as above" in block, (rel, i + 1)


def test_the_probe_and_concurrency_rules_are_live(tmp_path):
    # a probe field the documented schema lacks is found in the port's
    # producer
    src = os.path.join(ROOT, CONFIG["serve_probe_module"])
    dst = tmp_path / CONFIG["serve_probe_module"]
    dst.parent.mkdir(parents=True)
    with open(src) as f:
        text = f.read()
    assert text.count('"batch_occupancy":') == 1
    dst.write_text(text.replace('"batch_occupancy":', '"occupancy_x":'))
    (tmp_path / "docs").mkdir()
    shutil.copy(os.path.join(ROOT, "docs", "SERVING.md"),
                tmp_path / "docs" / "SERVING.md")
    found = run_lint(str(tmp_path), LintConfig(**CONFIG),
                     only={"serve-probe-drift"})
    assert {f.snippet for f in found} == {
        "probe:evaluator.occupancy_x", "doc-probe:evaluator.batch_occupancy"}
    # the concurrency family as the port's threads meet it
    fixture = (
        "import threading\n"
        "class Ring:\n"
        "    def __init__(self):\n"
        "        self._cond = threading.Condition()\n"
        "        self._entries = []  # guarded-by: self._cond\n"
        "    def fill(self):\n"
        "        return len(self._entries)\n")
    assert [f.rule for f in lint_source(fixture)] == [
        "unguarded-attr-access"]
