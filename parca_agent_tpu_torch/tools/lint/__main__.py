"""``python -m parca_agent_tpu_torch.tools.lint`` — see cli.py."""

import sys

from parca_agent_tpu_torch.tools.lint.cli import main

if __name__ == "__main__":
    sys.exit(main())
