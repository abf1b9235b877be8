"""Build the latent (MLA) decode kernel, hold it against its plain version
and time it, alone: ``chip_smoke.py``'s phase 3 check for this kernel,
without the other kernels' builds and phases.

    python tools/mla_decode_time.py          (on a card)

Prints the card, the build's time and each kernel's registers, shared
memory and spills from ``-Xptxas -v``, the check's line (every case of
``chip_smoke.MLA_CASES`` in bf16 and f32, at the split rule's chunk length,
at 64 slots and unsplit, then the time at ``MLA_MAIN`` beside its bound),
and one JSON line at the end with the time by forced chunk length too.
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

CHUNKS = (128, 256, 512, 1024, 8192)        # forced chunk lengths, timed at the main shape


def main() -> int:
    cs.phase_device()
    t0 = time.perf_counter()
    lib = cs.mla_module._library()
    print(f"[build] {time.perf_counter() - t0:.1f} s")
    info = cs.ptxas_info(Path(lib._name).with_suffix(".log"))
    print("[build] registers/spill bytes: " + "; ".join(
        f"{fn} {i['registers']}/{i['spill_bytes']}" for fn, i in info.items())
        + f"; dynamic shared memory {lib.repro_mla_decode_smem_bytes()} B")
    torch = cs.torch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rec = cs.check_mla_decode(gen, dev)
    name, B, S, H, C, R, mix = cs.MLA_MAIN
    pos = cs.decode_positions(B, S, mix, torch.Generator().manual_seed(1)).to(dev)
    q = torch.randn((B, 1, H, C + R), device=dev).to(torch.bfloat16)
    cache = torch.randn((B, S, C + R), device=dev).to(torch.bfloat16)
    rec[name]["by_chunk_ms"] = {str(c): cs.time_ms(lambda c=c: cs.mla_decode_kernel(
        q, cache, pos, C, 0.1, _chunk_len=c)) for c in CHUNKS}
    print(json.dumps(cs.significant(rec)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
