"""``python -m repro_torch.obs TRACE.json``: run the contract auditor on a
trace; exits 1 on a violation, 0 otherwise.

Equivalent to ``python -m repro_torch.obs.audit`` but avoids runpy's
re-execution warning (the package imports the audit module first).
"""
import sys

from repro_torch.obs.audit import main

sys.exit(main(sys.argv[1:]))
