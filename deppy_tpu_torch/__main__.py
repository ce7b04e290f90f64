"""``python -m deppy_tpu_torch`` — the CLI entry point (copy of
``deppy_tpu/__main__.py``)."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
