"""``python -m schwarz_tpu_torch`` runs the command line (cf. bench_ras main)."""

import sys

from schwarz_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
