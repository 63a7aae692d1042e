"""``python -m repro_torch.obs summarize trace.jsonl`` entry point."""

import sys

from .summarize import main

sys.exit(main())
