"""Quickstart on the PyTorch/CUDA port: examples/quickstart.py's pipeline
through ``repro_torch``.

1. Build a hierarchical multi-agent system (M sub-networks + PS).
2. Run Algorithm 3 (packet-drop-tolerant non-Bayesian learning): every agent
   identifies theta* despite 30% packet loss and sparse PS fusion.
3. Run Algorithm 2 (Byzantine-resilient learning): F=2 compromised agents
   send calibrated lies; every normal agent still learns theta*.
4. Sweep 32 consensus scenarios (topology draws x drop rates x seeds) as
   ONE block-diagonal graph through the sparse edge-list push-sum core.
5. Hierarchical consensus grid: a (topology x M x Gamma x drop x seed)
   Algorithm 1 sweep as one graph — the sub-network count M varies per
   scenario, and each scenario's (T,) Theorem-1 error curve is reduced in
   the loop (``store="gap"``).
6. Phase diagram: a (drop_prob x Gamma x seed) Algorithm 3 grid as one
   graph — belief-convergence rate per cell, with the (T,) worst log-ratio
   curves reduced in the loop.
7. Asynchronous execution: agents wake on independent clocks and consume
   bounded-staleness messages — a (wake-rate x staleness) grid as one
   graph via ``ExecutionPlan(async_=...)``.

On the GPU every consensus round goes through the CUDA edge scatter (K1),
every Algorithm 3 round through the innovation kernel (K2) and every
Algorithm 2 gossip through the trim-gather kernel (K3). The consensus
sweep's graphs are sorted by receiver (the CUDA edge scatter's layout),
which permutes the per-edge link draws against examples/quickstart.py's
unsorted lists: the same distribution, other realizations.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import (
    ExecutionPlan, HPSConfig, ByzantineConfig, make_hierarchy,
    make_confused_model, make_async_model, run_social_learning,
    run_byzantine_learning, attacks, healthy_networks,
    random_strongly_connected, sort_by_dst, stack_edge_lists,
    run_pushsum_sweep, run_hps_sweep, run_social_sweep,
)


def main(device=None) -> None:
    def host(x):
        return x.cpu().numpy()

    # --- system: 3 sub-networks of 6/6/6 agents, complete intra-network
    topo = make_hierarchy([6, 6, 6], topology="complete", seed=0)
    model = make_confused_model(N=topo.N, m=3, truth=1, confusion=0.5,
                                seed=0)
    print(f"system: M={topo.M} networks, N={topo.N} agents, "
          f"m={model.m} hypotheses, theta* = {model.truth}")

    # --- Algorithm 3: packet-dropping links -------------------------------
    cfg = HPSConfig(topo=topo, gamma_period=8, B=4, drop_prob=0.3)
    res = run_social_learning(model, cfg, T=500, seed=0, device=device)
    beliefs = host(res.beliefs)
    print("\n[Alg 3] drop_prob=0.3, PS fusion every 8 steps:")
    for t in (50, 150, 499):
        b = beliefs[t, :, model.truth]
        print(f"  t={t:4d}  belief in theta*: min={b.min():.4f} "
              f"mean={b.mean():.4f}")
    assert beliefs[-1, :, model.truth].min() > 0.95

    # --- Algorithm 2: Byzantine agents ------------------------------------
    # F=2 needs n_i >= 3F+1 = 7 agents per sub-network (A3) and per-network
    # redundant observability (A4): confusion=0 keeps every agent
    # informative about its assigned hypothesis.
    topo = make_hierarchy([7, 7, 7], topology="complete", seed=0)
    model = make_confused_model(N=topo.N, m=3, truth=1, confusion=0.0,
                                seed=0)
    byz = (2, 9)        # one compromised agent in each of networks 0 and 1
    bcfg = ByzantineConfig(
        topo=topo, F=2, byz=byz, gamma_period=10,
        attack=attacks.truth_suppression(model.truth, magnitude=1e3),
    )
    C = healthy_networks(topo, bcfg.byz_mask(), bcfg.F)
    print(f"\n[Alg 2] Byzantine agents {byz} run truth-suppression; C={C}")
    bres = run_byzantine_learning(model, bcfg, T=500, seed=0, device=device)
    dec = host(bres.decisions[-1])
    normal = ~bcfg.byz_mask()
    acc = (dec[normal] == model.truth).mean()
    print(f"  normal-agent accuracy at T=500: {acc:.3f} "
          f"(decisions: {np.bincount(dec[normal], minlength=3)})")
    assert acc == 1.0

    # --- scenario sweep: 32 consensus runs as one graph -------------------
    rng = np.random.default_rng(0)
    el = sort_by_dst(stack_edge_lists([random_strongly_connected(64, 0.05,
                                                                 rng)
                                       for _ in range(2)]))[0]
    w = rng.normal(size=(64, 3)).astype(np.float32)
    sweep = run_pushsum_sweep(w, el, T=300, drop_probs=[0.0, 0.3, 0.6, 0.9],
                              seeds=[0, 1, 2, 3], B=4, device=device)
    err = host(sweep.err)
    print(f"\n[sweep] {sweep.K} scenarios (2 graphs x 4 drop rates x 4 "
          f"seeds), one block-diagonal graph:")
    for dp in (0.0, 0.9):
        sel = sweep.drop_prob.numpy() == np.float32(dp)
        print(f"  drop={dp:.1f}  worst final consensus err: "
              f"{err[sel, -1].max():.2e}")
    assert err[:, -1].max() < 1e-2

    # --- Algorithm 1 grid: topology x M x Γ x drop x seed as one graph ----
    hier_a = make_hierarchy([6, 6, 6], topology="complete", seed=0)  # M=3
    hier_b = make_hierarchy([9, 9], topology="complete", seed=1)     # M=2
    w18 = np.random.default_rng(2).normal(size=(18, 3)).astype(np.float32)
    bases = [HPSConfig(topo=t, gamma_period=8, B=2, drop_prob=0.0)
             for t in (hier_a, hier_b)]
    hps = run_hps_sweep(w18, bases, T=2000, drop_probs=[0.0, 0.3],
                        gammas=[2, 8], seeds=[0, 1], device=device)
    gaps = host(hps.gap)                         # (K, T) Thm-1 curves
    print(f"\n[Alg 1 grid] {hps.K} HPS scenarios (2 hierarchies M∈{{3,2}} "
          f"x 2 drops x 2 Γ x 2 seeds), one graph;\n"
          f"  final consensus error per (M, Γ) cell (worst over "
          f"drops/seeds):")
    for m_val in (3, 2):
        cells = []
        for g in (2, 8):
            sel = (hps.M.numpy() == m_val) & (hps.gamma.numpy() == g)
            cells.append(f"Γ={g}:{gaps[sel, -1].max():.1e}")
        print(f"  M={m_val}  " + "  ".join(cells))
    assert gaps[:, -1].max() < 5e-2   # every scenario reached consensus

    # --- Algorithm 3 phase diagram: drop x Γ x seed as one graph ----------
    topo3 = make_hierarchy([6, 6, 6], topology="complete", seed=0)
    model3 = make_confused_model(N=topo3.N, m=3, truth=1, confusion=0.5,
                                 seed=0)
    base = HPSConfig(topo=topo3, gamma_period=8, B=4, drop_prob=0.0)
    drops, gammas = [0.0, 0.3, 0.6], [4, 16]
    sw = run_social_sweep(model3, base, T=400, drop_probs=drops,
                          gammas=gammas, seeds=[0, 1], device=device)
    curves = host(sw.log_ratio)               # (K, T) worst log-ratio
    print(f"\n[phase diagram] {sw.K} Alg-3 scenarios ({len(drops)} drops x "
          f"{len(gammas)} Γ x 2 seeds), one graph;\n  log-ratio decay rate "
          f"per (drop, Γ) cell (mean over seeds, nats/iter):")
    for g in gammas:
        rates = []
        for dp in drops:
            sel = (sw.drop_prob.numpy() == np.float32(dp)) \
                & (sw.gamma.numpy() == g)
            rates.append(-(curves[sel, -1] - curves[sel, 99]).mean() / 300)
        cells = "  ".join(f"drop={d:.1f}:{r:.4f}"
                          for d, r in zip(drops, rates))
        print(f"  Γ={g:2d}  {cells}")
    assert (curves[:, -1] < -5.0).all()   # every scenario learned theta*

    # --- async mode: a (wake-rate x staleness) grid as one graph ----------
    # Agents wake on independent Bernoulli-discretized Poisson clocks; an
    # awake sender latches its message into a per-edge bounded buffer and
    # delivery accepts snapshots up to `staleness` ticks old — so a
    # sleeping sender's last message still arrives. wake=1.0/staleness=0
    # is the synchronous engine above.
    wakes, stales = [1.0, 0.8, 0.6], [0, 4]
    ams = [make_async_model(q, s) for q in wakes for s in stales]
    asw = run_social_sweep(
        model3, base, T=400, drop_probs=[0.1], seeds=[0], device=device,
        plan=ExecutionPlan(store="log_ratio", async_=ams))
    alr = host(asw.log_ratio)                 # (K, T), async minor-most
    print(f"\n[async] {asw.K} Alg-3 scenarios (3 wake rates x 2 staleness "
          f"bounds), one graph;\n  final worst log-ratio per "
          f"(wake, staleness) cell (more negative = learned faster):")
    for qi, q in enumerate(wakes):
        cells = "  ".join(
            f"stale={s}:{alr[(qi * len(stales)) + si, -1]:+.1f}"
            for si, s in enumerate(stales))
        print(f"  wake={q:.1f}  {cells}")
    assert np.isfinite(alr).all()
    assert (alr[:, -1] < 0).all()   # every async cell still learned theta*
    print("\nquickstart OK")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "plain PyTorch path)")
    main(ap.parse_args().device)
