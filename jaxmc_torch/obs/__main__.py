"""`python -m jaxmc_torch.obs` — the metrics report/diff CLI (obs/report.py).

Deliberately free of torch imports: the report path must work (and is
tested) in environments without torch.
"""

import sys

from .report import main

sys.exit(main())
