"""Where ``chip_smoke.py``'s time goes: runs its ``main()`` with every line
it logs prefixed by the seconds since the start, then prints the ``--top``
longest gaps between consecutive lines (the work that ended at each line)
to standard error. The script's own exit code is returned.

    python3 tools/smoke_timeline.py [--top N] > timeline.log

Lines that the spawned ranks of phases 23-26 print carry no prefix (each
rank imports ``chip_smoke`` afresh). Needs an NVIDIA GPU and nvcc, as the
script does.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--top", type=int, default=40,
                    help="the longest gaps to print at the end")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    t0 = time.perf_counter()
    plain, stamps = chip_smoke.log, []

    def log(msg: str) -> None:
        now = time.perf_counter() - t0
        stamps.append((now, msg))
        plain(f"{now:8.2f} | {msg}")

    chip_smoke.log = log
    try:
        return chip_smoke.main()
    finally:
        gaps = sorted(((t - (stamps[i - 1][0] if i else 0.0), t, msg)
                       for i, (t, msg) in enumerate(stamps)), reverse=True)
        for gap, t, msg in gaps[:args.top]:
            print(f"{gap:8.2f} s, ended at {t:8.2f}: {msg[:110]}",
                  file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())
