"""``python -m speedy_tpu_torch run|ensemble ...`` (cli.py)."""
import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
