"""Signature linter — the execution plane stays behind ``plan=``.

Every execution knob of the port's ``run_*`` entry points (backend,
store, faults, async clocks, precision policy, ...) lives in the frozen
:class:`repro_torch.core.plan.ExecutionPlan`; none is a loose keyword
argument. :func:`check_entrypoints` inspects the signature of every public
``run_*`` entry point and fails the lint if

* the entry point lacks a ``plan`` parameter, or
* any *named* parameter (positional or keyword-only) is a covered
  execution knob: a field of the port's ``ExecutionPlan``, a field of the
  reference's plan the port has not grown yet (:data:`PENDING_PLAN_FIELDS`:
  the mesh and graph-sharding knobs of multi-device runs, which must
  arrive as plan fields too), or the retired ``use_kernel=`` alias.

Science knobs (``drop_probs``, ``seeds``, ``T``, ``B``, ``F``,
``attacks``, ``mode``, ``core``, ``record_every``, ...) and the port's
``device=`` are untouched: they parameterize the experiment and where it
runs, not the execution substrate.
"""
from __future__ import annotations

import dataclasses
import inspect

from .dense import Finding

__all__ = ["ENTRYPOINTS", "PENDING_PLAN_FIELDS", "check_signature",
           "check_entrypoints"]

#: module path -> public run_* entry points covered by the plan contract.
ENTRYPOINTS: tuple[tuple[str, str], ...] = (
    ("repro_torch.core.pushsum", "run_pushsum_sparse"),
    ("repro_torch.core.hps", "run_hps_runtime"),
    ("repro_torch.core.hps", "run_hps"),
    ("repro_torch.core.social", "run_social_runtime"),
    ("repro_torch.core.social", "run_social_learning"),
    ("repro_torch.core.sweeps", "run_pushsum_sweep"),
    ("repro_torch.core.sweeps", "run_byzantine_sweep"),
    ("repro_torch.core.sweeps", "run_byzantine_grid"),
    ("repro_torch.core.sweeps", "run_hps_sweep"),
    ("repro_torch.core.sweeps", "run_hps_grid"),
    ("repro_torch.core.sweeps", "run_social_sweep"),
    ("repro_torch.core.sweeps", "run_social_grid"),
)

#: the reference's plan fields the port's plan does not have yet
PENDING_PLAN_FIELDS: tuple[str, ...] = (
    "mesh", "data_axis", "graph_axis", "graph_shards", "halo")


def _covered_names() -> frozenset[str]:
    from ..core.plan import ExecutionPlan

    fields = {f.name for f in dataclasses.fields(ExecutionPlan)}
    return frozenset(fields) | set(PENDING_PLAN_FIELDS) | {"use_kernel"}


def check_signature(fn, name: str) -> list[Finding]:
    """Lint one entry point's signature against the plan contract."""
    out: list[Finding] = []
    covered = _covered_names()
    params = inspect.signature(fn).parameters
    if "plan" not in params:
        out.append(Finding(
            check="plan-signature", where=name,
            message="entry point has no plan= parameter — execution "
                    "config must arrive as ExecutionPlan",
        ))
    offenders = [
        p.name for p in params.values()
        if p.kind not in (p.VAR_KEYWORD, p.VAR_POSITIONAL)
        and p.name in covered
    ]
    if offenders:
        out.append(Finding(
            check="plan-signature", where=name,
            message=(
                f"named parameter(s) {offenders} re-introduce covered "
                "execution kwargs — these are ExecutionPlan fields (or "
                "the retired use_kernel alias) and arrive only through "
                "plan="
            ),
        ))
    return out


def check_entrypoints() -> list[Finding]:
    """Lint every registered ``run_*`` entry point."""
    import importlib

    out: list[Finding] = []
    for mod_name, fn_name in ENTRYPOINTS:
        try:
            fn = getattr(importlib.import_module(mod_name), fn_name)
        except (ImportError, AttributeError) as e:
            out.append(Finding(
                check="plan-signature", where=f"{mod_name}.{fn_name}",
                message=f"entry point missing: {type(e).__name__}: {e}",
            ))
            continue
        out.extend(check_signature(fn, f"{mod_name}.{fn_name}"))
    return out
