"""``python -m ray_tpu_torch`` — dispatches to the CLI (scripts/cli.py)."""

import sys

from ray_tpu_torch.scripts.cli import main

if __name__ == "__main__":
    sys.exit(main())
