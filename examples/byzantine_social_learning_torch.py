"""Attack gallery on the PyTorch/CUDA port: examples/byzantine_social_learning.py
through ``repro_torch`` — Algorithm 2 against every implemented Byzantine
strategy, plus the failure of the unfiltered baseline, and the Gamma (PS
fusion frequency) trade-off of Remark 3 (Algorithm 3).

On the GPU the gossip trim runs through the trim-gather kernel (K3), the
consensus through the edge scatter (K1) and the innovation through K2.

Run:  PYTHONPATH=src python examples/byzantine_social_learning_torch.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import (
    ByzantineConfig, HPSConfig, make_hierarchy, make_confused_model,
    run_byzantine_learning, run_social_learning, attacks,
)


def main(device=None) -> None:
    # confusion=0: every agent informative, so each network's A4 survives
    # removing F agents
    topo = make_hierarchy([7, 7, 7, 7], topology="complete", seed=0)
    model = make_confused_model(N=topo.N, m=3, truth=0, confusion=0.0,
                                seed=1)
    byz = (2, 9)
    normal = np.ones(topo.N, bool)
    normal[list(byz)] = False

    print(f"{topo.M} networks x 7 agents, F=2 Byzantine at {byz}, "
          f"theta*=0\n")
    print(f"{'attack':24s} {'filtered acc':>12s} {'unfiltered acc':>15s}")
    for name, factory in attacks.ATTACKS.items():
        atk = factory(0) if name == "truth_suppression" else factory()
        accs = []
        for F in (2, 0):  # paper's filter vs no filter
            cfg = ByzantineConfig(topo=topo, F=F, byz=byz, gamma_period=10,
                                  attack=atk)
            res = run_byzantine_learning(model, cfg, T=400, seed=0,
                                         device=device)
            dec = res.decisions[-1].cpu().numpy()
            accs.append((dec[normal] == model.truth).mean())
        print(f"{name:24s} {accs[0]:12.3f} {accs[1]:15.3f}")

    print("\nRemark 3 — sparser PS fusion costs almost nothing (Alg 3, 30% "
          "drop):")
    model2 = make_confused_model(N=topo.N, m=3, truth=0, confusion=0.5,
                                 seed=2)
    for gamma in (4, 16, 64):
        cfg = HPSConfig(topo=topo, gamma_period=gamma, B=2, drop_prob=0.3)
        res = run_social_learning(model2, cfg, T=500, seed=1, device=device)
        b = res.beliefs[-1].cpu().numpy()[:, 0]
        print(f"  Gamma={gamma:3d}: PS messages={500 // gamma:3d}  "
              f"min belief in theta* = {b.min():.4f}")
    print("\nbyzantine_social_learning OK")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "plain PyTorch path)")
    main(ap.parse_args().device)
