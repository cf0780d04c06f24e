"""``python -m gigagan_tpu_torch`` (see gigagan_tpu_torch/cli.py)."""

import sys

from gigagan_tpu_torch.cli import main

sys.exit(main())
