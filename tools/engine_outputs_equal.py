"""Whether two trees of the port give the same engine outputs bit for bit:
the four engines' single runs (no plane, the chaos lane's severe fault
model, an async model) and one grid or sweep of each kind, at small sizes,
plus Algorithm 3 and HPS at N = 131,072 (chip_smoke.py's set-ups) on the
card. Each tree runs in a process of its own and writes its outputs to
an ``.npz``; the two files are then compared array by array:

    python3 tools/engine_outputs_equal.py --a DIR --b DIR [--device cpu]
        [--policy fp32]

``--a`` and ``--b`` are ``src/`` directories (``--b`` defaults to this
checkout's); ``--policy`` is the plan's precision policy for ``--b``'s
runs (``--a`` runs with none). Prints one line an array that differs and
exits 1 if any does. ``--device`` defaults to ``cuda``.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def dump(src: str, out: str, device: str, policy: str | None) -> None:
    """One tree's outputs, by name, into ``out``."""
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, src)
    import torch

    import repro_torch.core.asyncrony as ta
    import repro_torch.core.attacks as tat
    import repro_torch.core.byzantine as tb
    import repro_torch.core.faults as tf
    import repro_torch.core.graphs as tg
    import repro_torch.core.hps as th
    import repro_torch.core.pushsum as tp
    import repro_torch.core.signals as tsig
    import repro_torch.core.social as tsoc
    import repro_torch.core.sweeps as tsw
    from repro_torch.core.plan import ExecutionPlan

    rng = np.random.default_rng(0)
    el = tg.sort_by_dst(tg.edge_list(tg.random_strongly_connected(
        40, 0.2, rng)))[0]
    wp = rng.normal(size=(40, 3)).astype(np.float32)
    w = np.random.default_rng(3).normal(size=(18, 4)).astype(np.float32)
    cfg = th.HPSConfig(tg.make_hierarchy([6, 6, 6], "complete", seed=0), 4,
                       B=2, drop_prob=0.2)
    model = tsig.make_confused_model(N=18, m=3, truth=1, confusion=0.3,
                                     seed=0)
    bcfg = tb.ByzantineConfig(
        topo=tg.make_hierarchy([6, 6, 6], "complete", seed=0), F=1, byz=(2,),
        gamma_period=4, attack=tat.random_noise())
    severe = tf.gilbert_elliott_model(8.0, 0.5, leave_prob=0.1,
                                      join_prob=0.25, ps_crash_prob=0.5)
    base = ExecutionPlan() if policy is None else ExecutionPlan(
        policy=policy)
    res = {}
    for name, plan in (("none", base), ("faults", base.replace(
            faults=severe)), ("async", base.replace(
                async_=ta.make_async_model(0.6, 4)))):
        kw = dict(device=device)
        st, tr = tp.run_pushsum_sparse(wp, el.src, el.dst, 60, drop_prob=0.2,
                                       B=3, plan=plan, **kw)
        res[f"pushsum_{name}"] = [*st, tr]
        r = th.run_hps(w, cfg, 60, seed=1, F=1,
                       plan=plan.replace(store="gap"), **kw)
        res[f"hps_{name}"] = [r.ratio, r.gap, *r.final_state]
        r = tsoc.run_social_learning(model, cfg, 60, seed=2, plan=plan, **kw)
        res[f"social_{name}"] = [r.beliefs, r.log_ratio, *r.final_state]
        if name != "async":
            r = tb.run_byzantine_learning(model, bcfg, 60, seed=3, plan=plan,
                                          **kw)
            res[f"byzantine_{name}"] = [r.r, r.decisions]
            r = tsw.run_byzantine_grid(model, [bcfg], 30, [0, 1], plan=plan,
                                       **kw)
            res[f"byzantine_grid_{name}"] = [r.r, r.decisions]
        r = tsw.run_hps_grid(w, [cfg], 30, [0, 1], plan=plan, **kw)
        res[f"hps_grid_{name}"] = [r.ratio, r.gap]
        r = tsw.run_social_grid(model, [cfg], 30, [0, 1], plan=plan, **kw)
        res[f"social_grid_{name}"] = [r.beliefs, r.log_ratio]
        r = tsw.run_pushsum_sweep(wp, el, 30, drop_probs=[0.1, 0.3],
                                  seeds=[0, 1], plan=plan, **kw)
        res[f"pushsum_sweep_{name}"] = [r.err, r.final_ratio, r.mass_gap]
    if device != "cpu":
        import chip_smoke as cs
        smodel, srt, sM = cs.scenario(cs.N_FULL)
        r = tsoc.run_social_runtime(smodel, srt, sM, 50, seed=0,
                                    plan=base.replace(store="log_ratio",
                                                      dst_sorted=True))
        res["social_full"] = [r.beliefs, r.log_ratio, *r.final_state]
        hrt, hw = cs.hps_scenario(cs.N_FULL)
        r = th.run_hps_runtime(torch.from_numpy(hw).to(device),
                               hrt.to(device), 50, seed=0,
                               plan=base.replace(store="gap",
                                                 dst_sorted=True))
        res["hps_full"] = [r.ratio, r.gap, *r.final_state]
    np.savez(out, **{f"{k}_{i}": t.detach().cpu().numpy()
                     for k, v in res.items() for i, t in enumerate(v)})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--a", required=True, help="the first src/ directory")
    ap.add_argument("--b", default=str(ROOT / "src"),
                    help="the second src/ directory (default: this one)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--policy", default=None,
                    help="precision policy of --b's runs (default none)")
    ap.add_argument("--dump", nargs=2, metavar=("SRC", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.dump:
        dump(args.dump[0], args.dump[1], args.device, args.policy)
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        outs = []
        for tag, src, pol in (("a", args.a, None), ("b", args.b,
                                                    args.policy)):
            out = str(Path(tmp) / f"{tag}.npz")
            cmd = [sys.executable, __file__, "--a", args.a, "--device",
                   args.device, "--dump", str(Path(src).resolve()), out]
            if pol is not None:
                cmd += ["--policy", pol]
            subprocess.run(cmd, check=True)
            outs.append(np.load(out))
        a, b = outs
        names = sorted(set(a.files) | set(b.files))
        bad = [n for n in names if n not in a.files or n not in b.files
               or a[n].dtype != b[n].dtype
               or not np.array_equal(a[n], b[n], equal_nan=True)]
        for n in bad:
            print(f"differs: {n}")
        print(f"engine_outputs_equal: {len(names) - len(bad)} of "
              f"{len(names)} arrays bit-equal on {args.device} "
              f"(--b policy {args.policy})")
        return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
