"""``python -m wealy_tpu_torch.cli <command> ...``: the port's command line
(:mod:`wealy_tpu_torch.cli.main`)."""

import sys

from wealy_tpu_torch.cli.main import main

if __name__ == "__main__":
    sys.exit(main())
