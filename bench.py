#!/usr/bin/env python
"""Repo benchmark entry point: prints one JSON line.

{"metric": "reads_per_sec", "value": N, "unit": "reads/s", "detail": {...}}
with the device and the card's name and power limit in "detail".  Runs on
a GPU only; with none it exits non-zero and prints no result.
"""

import sys

from muscato_tpu.bench import runner

if __name__ == "__main__":
    sys.exit(runner.main())
