"""``python -m fealess_tpu_torch <action> ...``: the CLI's entry point
(reference: the FEALESS binary, test/main.cpp:14-76)."""

import sys

from fealess_tpu_torch.apps.cli import main

if __name__ == "__main__":
    sys.exit(main())
