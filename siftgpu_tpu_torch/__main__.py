"""`python -m siftgpu_tpu_torch <subcommand> ...`: see `pipeline/cli.py`."""

from .pipeline.cli import main

raise SystemExit(main())
