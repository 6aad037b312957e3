import sys

from apex_tpu_torch.runtime.cli import main

# the roles of one fleet often share one output (the launcher's children,
# a supervisor's): write each line whole, in one write under the pipe's
# atomic size, so one role's record never lands inside another's line.
# Unbuffered output (PYTHONUNBUFFERED, -u) writes a print's text and its
# newline apart, which is how they interleaved.
sys.stdout.reconfigure(line_buffering=True, write_through=False)

raise SystemExit(main())
