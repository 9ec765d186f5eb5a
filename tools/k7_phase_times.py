"""Where K7's third pass spends its time: the device time of each of the
chunked WKV6 scan's three passes at RWKV6-1.6B's serve shape (8 requests x
32 heads x 2,048 tokens, bf16), for the kernel as it is and for copies of
``csrc/wkv6.cu`` with one phase of pass 3 removed. A phase's cost is the
kernel's time less the time without it. The copies compute wrong outputs;
they are timed, never used. Needs an NVIDIA GPU and nvcc; from the
repository root:

    python3 tools/k7_phase_times.py

Phases removed, one at a time:
  diagonal   the four diagonal 16 x 16 sub-blocks (pairwise exponentials)
             and the bonus on their diagonal;
  inter      (r . exp(E)) @ S;
  anchored   the off-diagonal scores through the anchor (their A fragments
             and products; the block's anchored keys stay);
  state      the carried state's update.
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
    "diagonal": [("diag_scores<T>(rsm, ksm, E, us, dgw, i0, lane);",
                  "for (int e = lane; e < 256; e += 32) dgw[e] = 0.0f;")],
    "inter": [("        for (int ks = 0; ks < 4; ++ks) {\n"
               "            const int c0 = 16 * ks + 2 * t;\n"
               "            uint32_t a[NP][4];",
               "        for (int ks = 0; ks < 0; ++ks) {\n"
               "            const int c0 = 16 * ks + 2 * t;\n"
               "            uint32_t a[NP][4];")],
    "anchored": [("        if (w > 0) {\n            const float* pa",
                  "        if (false) {\n            const float* pa")],
    "state": [("        update_state<T>(accS, ksm, P, vp_, dc, i0, g, t);\n"
               "        __syncthreads();                       // before the next chunk's loads",
               "        __syncthreads();")],
}


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.wkv6 import wkv6_cuda

    if not torch.cuda.is_available():
        print("k7_phase_times: no CUDA device", file=sys.stderr)
        return 2
    out_dir = ROOT / "build" / "k7_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "wkv6.cu").read_text()
    procs = {}
    for name, subs in {"kernel": [], **PHASES}.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"phase {name}: its anchor is not in "
                                   f"wkv6.cu any more")
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
        print(f"{name}: {cs.ptxas_report(log, 'wkv6_group_outputsI13')}")
        libs[name] = so

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    B, H, S = 8, 32, 2048
    r, k, v, lw, u = cs.wkv_inputs(g, B * H, S, torch.bfloat16, "model",
                                   dev)

    def heads(a):
        return a.view(B, S, H, 64).transpose(1, 2)

    uh = u[:H].expand(B, H, 64)
    flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    times = {}
    for rnd in range(2):                       # in turns, twice
        for name, so in libs.items():
            lib = ctypes.CDLL(str(so))
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            _build._LIBS["wkv6"] = lib
            t = cs.kernel_times(lambda: wkv6_cuda(heads(r), heads(k),
                                                  heads(v), heads(lw), uh),
                                5, flush_buf.zero_)
            times.setdefault(name, []).append(t["wkv6_group_outputs"][0])
            print(f"round {rnd} {name}: " + ", ".join(
                f"{n} {x:.4f} ms (mean of {c})" for n, (x, c) in t.items()),
                flush=True)
    base = min(times["kernel"])
    for name in PHASES:
        print(f"pass 3 without {name}: {min(times[name]):.4f} ms, so "
              f"{name} costs {base - min(times[name]):.4f} of {base:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
