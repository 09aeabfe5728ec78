"""``python -m babble_tpu_torch run|keygen|version|dummy|signal ...``: the
port's command line (babble_tpu_torch/cli/main.py)."""

import sys

from babble_tpu_torch.cli.main import main

if __name__ == "__main__":
    sys.exit(main())
