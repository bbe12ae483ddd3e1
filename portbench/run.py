"""Entry point of the benchmark: ``python3 portbench/run.py --workload
<name> --seed <n> --seconds <s> --trace <0|1>`` from the repository's
root (see harness.py)."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main())
