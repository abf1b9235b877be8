"""Build the decode-attention kernel, hold it against its plain version and
time it, alone: ``chip_smoke.py``'s phase 3 check for this kernel, without
the other kernels' builds and phases.

    python tools/decode_attention_time.py          (on a card)

Prints the card, the build's time and each kernel's registers, shared
memory and spills from ``-Xptxas -v``, the check's lines (every case of
``chip_smoke.DECODE_CASES`` in bf16 and f32, at the split rule's chunk
length, at 64 slots and unsplit) and the timings at ``DECODE_TIMED``
(kernel, plain version, SDPA, bound; the main shape at forced chunk
lengths), one JSON line at the end.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    cs.phase_device()
    t0 = time.perf_counter()
    lib = cs.decode_module._library()
    print(f"[build] {time.perf_counter() - t0:.1f} s")
    info = cs.ptxas_info(Path(lib._name).with_suffix(".log"))
    print("[build] registers/spill bytes: " + "; ".join(
        f"{fn} {i['registers']}/{i['spill_bytes']}" for fn, i in info.items()))
    dev = cs.torch.device("cuda")
    gen = cs.torch.Generator(device=dev).manual_seed(0)
    timings = cs.check_decode(gen, dev)
    print(json.dumps(cs.significant(timings)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
