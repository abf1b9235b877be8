"""Run one cell of the port's benchmark once:

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The port is imported from the checkout's
``src/``; its kernels build into ``src/repro_torch/_build/`` there.
"""

import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_HERE = Path(__file__).resolve().parent
_ROOT = _HERE.parent
# the script's own directory would shadow the standard library's modules
sys.path[:] = [str(_ROOT), str(_ROOT / "src")] + [
    p for p in sys.path if Path(p or ".").resolve() != _HERE]

if __name__ == "__main__":
    from gpubench.bench import main
    sys.exit(main(t0=T0))
