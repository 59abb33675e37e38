"""Process environment shared by every test, set before any test module loads.

XLA's C++ logger writes two ~1.8 KB ERROR lines for each executable that the
persistent compilation cache hands back on a CPU whose compile-time tuning
features (``+prefer-no-scatter``, ``+prefer-no-gather``) are missing from the
host feature list. Subprocesses a test launches with a piped, undrained
stdout (the two-process workers of ``tests/test_multiprocess.py``) then fill
the 64 KiB pipe on a warm cache and block until the launcher's timeout.
Those lines are diagnostics only; XLA's errors still surface as exceptions.
"""

import os

os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")
