#!/usr/bin/env python
"""graftlint launcher: ``python -m brpc_tpu_torch.tools.graftlint
[paths...]`` or ``python brpc_tpu_torch/tools/graftlint.py [paths...]``.

Thin wrapper over ``python -m brpc_tpu_torch.analysis`` for invocations
from outside the package root (CI steps, editors). Exit code = unwaived
finding count (0 = clean, capped at 100; 120 = usage error). CI and
editors consume ``--changed [BASE]`` (lint only the git diff),
``--format=json|sarif``, ``--list-rules`` and ``--show-waivers``. See
brpc_tpu_torch/analysis/INVARIANTS.md for the rule catalogue and the
waiver syntax.
"""

import os
import sys

if __name__ == "__main__" and __package__ in (None, ""):
    # run by its path: the repo root (two levels up) holds the package,
    # and takes the place of this directory on the path
    sys.path[0] = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))

from brpc_tpu_torch.analysis.__main__ import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
