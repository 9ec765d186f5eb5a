"""repro_torch.statics — static checks of the port's engines.

The port of ``repro.statics``. The reference proves its properties on
traced jaxprs; the port's engines are eager PyTorch loops, so each check
runs an engine once at a small fixture under an op recorder and proves
its property there, or is pure arithmetic that needs no run at all:

* :mod:`~repro_torch.statics.walk`      — the op recorder (a
  ``TorchDispatchMode``) every check of a run shares
* :mod:`~repro_torch.statics.tracker`   — the step tracker (live bytes
  and their peak, bytes accessed, FLOPs, kernel launches) the dry run
  traces with
* :mod:`~repro_torch.statics.contracts` — ``@contract`` declarations
* :mod:`~repro_torch.statics.dense`     — dense-intermediate + subnormal
  linter, and the named exemption of the port's horizon-major keys
* :mod:`~repro_torch.statics.streams`   — PRNG stream-domain
  disjointness proofs (exact integer arithmetic)
* :mod:`~repro_torch.statics.memory`    — footprints and the analytic
  step-byte models on the H100's roofline
* :mod:`~repro_torch.statics.signatures` — the ``run_*`` plan contract
* :mod:`~repro_torch.statics.precision` — the reduced-precision carry
  contract
* :mod:`~repro_torch.statics.cli`       — ``python -m repro_torch.statics
  lint|budget|list``

The engines under :mod:`repro_torch.core` declare their invariants at the
definition site via :func:`contract`; the CLI replays every declaration
against fresh runs of small fixtures, on the CPU (the plain path) or the
card (the kernel path).
"""
from .contracts import (
    DEFAULT_HORIZON,
    REGISTRY,
    EngineContract,
    all_contracts,
    contract,
    get,
)
from .dense import (
    HORIZON_KEYS,
    Finding,
    assert_nonempty,
    find_forbidden,
    find_subnormal_consts,
)
from .memory import footprint, step_floor
from .precision import carried_state, find_fp32_carries, loop_carries
from .streams import AffineMap, affine_disjoint, check_streams, fit_affine
from .walk import collect_literals, collect_values, symbolize, trace

__all__ = [
    "AffineMap",
    "DEFAULT_HORIZON",
    "EngineContract",
    "Finding",
    "HORIZON_KEYS",
    "REGISTRY",
    "affine_disjoint",
    "all_contracts",
    "assert_nonempty",
    "carried_state",
    "check_streams",
    "collect_literals",
    "collect_values",
    "contract",
    "find_forbidden",
    "find_fp32_carries",
    "find_subnormal_consts",
    "fit_affine",
    "footprint",
    "get",
    "loop_carries",
    "step_floor",
    "symbolize",
    "trace",
]
