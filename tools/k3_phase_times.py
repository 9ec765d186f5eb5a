"""Where K3's time goes: the device time of the Byzantine trim-gather at
Algorithm 2's main shape (N = 131,072 receivers, deg_max = 7, P = 9, F = 2,
stride-0 lies) for the kernel as it is and for copies of
``csrc/byz_trim.cu`` with one phase removed, beside a device copy of the
bytes K3 moves and of the bytes K2 moves at Algorithm 3's main shape (the
floor a kernel of that size meets on this card, launch and all). A phase's
cost is the kernel's time less the time without it. The copies compute
wrong outputs; they are timed, never used. Needs an NVIDIA GPU and nvcc;
from the repository root:

    python3 tools/k3_phase_times.py

Phases removed, one at a time:
  sort    the network and the window: the keys are added in slot order;
  loads   the gathers through the slot table: each key is made from the
          table's step instead.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

PHASES = {
    "sort": [("        sort_keys<CAP>(key);\n", ""),
             ("            if ((win >> q) & 1u) sum += key_value(key[q]);",
              "            sum += __uint_as_float(key[q]);")],
    "loads": [("key[k] = order_key(__ldg(src[k] + p * step[k]));",
               "key[k] = order_key(__int_as_float(step[k] + p));")],
}


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.byz_trim import trim_gather_cuda

    if not torch.cuda.is_available():
        print("k3_phase_times: no CUDA device", file=sys.stderr)
        return 2
    out_dir = ROOT / "build" / "k3_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "byz_trim.cu").read_text()
    procs = {}
    for name, subs in {"kernel": [], **PHASES}.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"phase {name}: its anchor is not in "
                                   f"byz_trim.cu any more")
            text = text.replace(old, new)
        cu, so = out_dir / f"{name}.cu", out_dir / f"{name}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        print(f"{name}: {cs.ptxas_report(log, 'trim_gather_kernelILi8E')}")
        libs[name] = so

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    dev = torch.device("cuda")
    model, rt, _ = cs.scenario(cs.N_FULL)
    _, bsetup, _ = cs.byz_scenario(cs.N_FULL)
    args = cs.engine_args(dev, model, rt.to(dev), bsetup[0].to(dev))
    k3 = args["k3"]
    flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    times = {}
    for rnd in range(2):                       # in turns, twice
        for name, so in libs.items():
            lib = ctypes.CDLL(str(so))
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            _build._LIBS["byz_trim"] = lib
            ms = cs.event_ms(lambda: trim_gather_cuda(*k3), cs.TIMED_RUNS,
                             flush_buf.zero_, hide_host=True)
            times.setdefault(name, []).append(ms)
            print(f"round {rnd} {name}: {ms:.5f} ms with the host hidden",
                  flush=True)
    base = min(times["kernel"])
    for name in PHASES:
        print(f"K3 without {name}: {min(times[name]):.5f} ms, so {name} "
              f"costs {base - min(times[name]):.5f} of {base:.5f} ms")
    outs = trim_gather_cuda(*k3)
    for what, moved in (
            ("K3", cs.nbytes(*k3[:3], k3[4], *outs) + 4),
            ("K2", cs.nbytes(*args["k2"]) + 2 * args["k2"][0].nbytes)):
        a = torch.ones(moved // 8, device=dev)
        b = torch.empty_like(a)
        ms = cs.event_ms(lambda: b.copy_(a), cs.TIMED_RUNS, flush_buf.zero_,
                         hide_host=True)
        print(f"a device copy of {what}'s {moved / 1e6:.2f} MB (read "
              f"{moved / 2e6:.2f}, written {moved / 2e6:.2f}): {ms:.5f} ms "
              f"with the host hidden")
    return 0


if __name__ == "__main__":
    sys.exit(main())
