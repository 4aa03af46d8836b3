"""graftlint: framework-invariant static analysis for brpc_tpu_torch.

The framework's correctness rests on a handful of cross-cutting
invariants no unit test can guard globally — fibers must not block
their carrier pthread, IOBufs handed to the write path must not be
mutated afterwards, every native fast lane must judge-or-defer to the
classic lane, lock acquisition order must be acyclic, and every
registered protocol must be complete. ``graftlint`` walks the package
ASTs (plus the native C++ sources) and enforces each invariant as a
pluggable rule; see analysis/INVARIANTS.md for the catalogue and the
waiver syntax (``# graftlint: disable=<rule> -- reason``).

Run it:
    python -m brpc_tpu_torch.analysis brpc_tpu_torch/
    python -m brpc_tpu_torch.tools.graftlint brpc_tpu_torch/ --json
"""

from brpc_tpu_torch.analysis.core import (  # noqa: F401
    Analyzer, Finding, Rule, SourceFile,
)


def run(paths, rules=None):
    """Analyze ``paths`` and return (active, waived) finding lists."""
    a = Analyzer(rules=rules)
    return a.run(paths)
