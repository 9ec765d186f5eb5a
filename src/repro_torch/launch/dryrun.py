"""The dry run: trace every (arch x shape x mesh) combination of the model
stack on fake tensors, rank 0 of a fake process group, through the kernels'
shape rules: the port's counterpart of ``repro.launch.dryrun``.

It proves, without the cards, what fits on H100 meshes the port cannot
run: a sharding refusal, a kernel that rejects a shape, or a peak past the
card's 80 GB is a finding. Rank 0 of the reference's production mesh
(:func:`repro_torch.launch.mesh.make_production_mesh`: 16 x 16, or 2 x 16
x 16) builds its own blocks of the parameters, the optimizer state, the
batch and the cache as fake tensors (``FakeTensorMode`` on the CPU: a
shape, a dtype and strides, nothing allocated, nothing drawn) and runs one
step of the port's own step functions on them: ``make_train_step(mesh=)``
(the FSDP mean step above :data:`FSDP_THRESHOLD` parameters, or the
robust step of ``--agg``), ``make_prefill_step`` or ``make_decode_step``.
The kernels run their shape rules (``backend="cuda"`` on fake tensors:
:mod:`repro_torch.kernels.dispatch`), the collectives go through a
:class:`~repro_torch.distributed.comm.CountingComm` on the fake group, and
a :class:`~repro_torch.statics.tracker.StepTracker` follows the live bytes,
the bytes accessed and the FLOPs. Each combination gives one JSON row with
the reference's keys where they mean the same: per-device argument bytes
and the traced peak (``memory``), the analytic model (``analytic_memory``,
with ``fits_hbm``), the roofline terms of the traced counts, the
collectives by kind and each kernel's launches, FLOPs and bytes. A
combination that raises is a row with ``ok: False`` and the port's error.

Micro-batches have equal shapes, so a train step with n_micro > 3 is
traced as a step of two of them (the first allocates the gradient
accumulator; the peak is this step's) and a step of three, and its counts
are scaled: the two-micro-batch step plus n_micro - 2 times what the
third micro-batch added (``cost_mode: "scaled"``; the reference
extrapolates its costs in depth instead). Rank 0 is traced; where a layout
makes ranks differ the row says so (``rank_note``).

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch whisper_small \\
        --shape decode_32k --skip-cost
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --multi-pod both --out dryrun.json
    PYTHONPATH=src python -m repro_torch.analysis.render dryrun.json

It needs no card and no nvcc. ``--skip-cost`` leaves out the FLOP counter
(a faster trace; the roofline's compute term is then the kernels' alone).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback
from typing import Any

import torch

from ..analysis.memory_model import serve_memory_gb, train_memory_gb
from ..analysis.roofline import HW, model_flops, roofline_terms
from ..configs import ARCH_IDS, INPUT_SHAPES, get_config
from ..configs.base import ArchConfig, InputShape
from ..data.pipeline import make_batch_specs
from ..distributed import trainer as T
from ..distributed.aggregation import AggregatorConfig
from ..distributed.comm import COLLECTIVE_KINDS, CountingComm
from ..distributed.sharding import _entry_axes, cache_specs, param_specs
from ..models import model as M
from ..optim.adamw import AdamWConfig, adamw_init
from ..statics.tracker import StepTracker
from .mesh import PRODUCTION_SHAPES, fake_mesh

__all__ = ["FSDP_THRESHOLD", "SERVE_GATHER_THRESHOLD", "LONG_WINDOW",
           "MICRO_TOKENS", "pick_remat_group", "pick_n_micro",
           "serve_cfg_for", "batch_struct", "input_specs",
           "decode_cache_len", "fake_mode", "local_params", "local_cache",
           "arg_bytes", "cache_leaves",
           "trace_step", "lower_one", "main"]

# FSDP for models whose optimizer state cannot replicate across data workers
FSDP_THRESHOLD = 2e9
# the reference's weight-gathered serving above this size (params over
# (data, model)); the port serves on the model split alone, and the rows
# above it say so (``serve_gather_reference``)
SERVE_GATHER_THRESHOLD = 50e9
# sliding window used for the long_500k serve variant of full-attention archs
LONG_WINDOW = 4096
# target tokens per device per micro-batch (activation-memory knob)
MICRO_TOKENS = 4096


def pick_remat_group(L: int) -> int:
    """Largest divisor of L bounded by ~L/12: saved-residual count stays
    small while the recompute window stays shallow."""
    cap = max(2, L // 12)
    best = 1
    for g in range(2, cap + 1):
        if L % g == 0:
            best = g
    return best


def pick_n_micro(cfg: ArchConfig, shape: InputShape, mesh) -> int:
    data_shards = mesh.shape["data"] * dict(mesh.shape).get("pod", 1)
    b_dev = max(shape.global_batch // data_shards, 1)
    tok_dev = b_dev * shape.seq_len
    n = max(1, min(tok_dev // MICRO_TOKENS, b_dev))
    while b_dev % n:
        n -= 1
    return n


def serve_cfg_for(cfg: ArchConfig, shape: InputShape) -> ArchConfig:
    """long_500k needs sub-quadratic attention: full-attention archs switch
    to their sliding-window serve variant (same params, windowed mixer)."""
    if shape.name == "long_500k" and any(
        k == "attn" for k in cfg.block_pattern
    ):
        pat = tuple("swa" if k == "attn" else k for k in cfg.block_pattern)
        return dataclasses.replace(cfg, block_pattern=pat,
                                   window=cfg.window or LONG_WINDOW)
    return cfg


def batch_struct(cfg: ArchConfig, shape: InputShape, device="meta"
                 ) -> dict[str, torch.Tensor]:
    """Stand-ins for a train/prefill batch of arch x shape: tokens and
    labels (the VLM's text after its patches), bf16 patches or frames."""
    S, B = shape.seq_len, shape.global_batch
    toks = S
    extra = {}
    if cfg.family == "vlm":
        toks = S - cfg.n_patches
        extra["patch_embeds"] = torch.empty(
            (B, cfg.n_patches, M.D_VIS), dtype=torch.bfloat16, device=device)
    if cfg.family == "audio":
        extra["frames"] = torch.empty((B, cfg.n_frames, cfg.d_model),
                                      dtype=torch.bfloat16, device=device)
    return {**make_batch_specs(toks, B, cfg.vocab, device), **extra}


def input_specs(arch: str, shape_name: str, device="meta"
                ) -> dict[str, torch.Tensor]:
    """Stand-ins for every model input of (arch, shape), nothing drawn:
    the reference's ``ShapeDtypeStruct``s with int64 token ids."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    if shape.kind in ("train", "prefill"):
        return batch_struct(serve_cfg_for(cfg, shape), shape, device)
    return {"token": torch.empty((shape.global_batch, 1), dtype=torch.int64,
                                 device=device)}


def decode_cache_len(cfg: ArchConfig, shape: InputShape) -> int:
    if shape.name == "long_500k":
        return cfg.window or LONG_WINDOW
    return min(shape.seq_len, 32768)


# ---------------------------------------------------------------------------
# rank 0's fake arguments
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_mode():
    """Fake tensors for the block: a tensor made in it on the CPU has a
    shape, a dtype and strides, and no memory."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        yield


def _local_shape(shape, spec, mesh) -> tuple[int, ...]:
    """A leaf's block under ``spec`` on ``mesh`` (anything with a
    ``shape`` mapping of dimension sizes: a ``RankMesh`` or a stand-in)."""
    out = list(shape)
    for d, e in enumerate(spec):
        out[d] //= math.prod(dict(mesh.shape).get(a, 1)
                             for a in _entry_axes(e))
    return tuple(out)


def local_params(cfg: ArchConfig, specs, mesh, device="cpu"):
    """This rank's blocks of ``cfg``'s parameters under ``specs``
    (``None``: whole, one process), as empty tensors on ``device``: fake
    under :func:`fake_mode`; no generator, nothing drawn."""
    shapes = M.param_shapes(cfg)
    if specs is None:
        return M._tmap(lambda a: torch.empty(a.shape, dtype=a.dtype,
                                             device=device), shapes)
    return M._tmap(lambda a, s: torch.empty(
        _local_shape(a.shape, s, mesh), dtype=a.dtype, device=device),
        shapes, specs)


def local_cache(cfg: ArchConfig, n_rows: int, cache_len: int, mesh,
                device="cpu"):
    """This rank's blocks of the decode cache of ``n_rows`` requests
    (``distributed.sharding.cache_specs`` of the whole cache; ``mesh``
    ``None``: whole), as empty tensors: the K/V rings, ``pos``, the
    recurrent states, and an encoder-decoder's ``enc`` (bf16, as the
    reference's dry run feeds it). ``model.init_cache`` builds the same
    blocks as zeros."""
    stacked = "groups" in M.param_shapes(cfg)
    full = M._cache_tree(cfg, stacked, n_rows, cache_len, "meta")
    if cfg.encoder_layers:
        full["enc"] = torch.empty((n_rows, cfg.n_frames, cfg.d_model),
                                  dtype=torch.bfloat16, device="meta")
    if mesh is None:
        return M._tmap(lambda a: torch.empty(a.shape, dtype=a.dtype,
                                             device=device), full)
    return M._tmap(lambda a, s: torch.empty(
        _local_shape(a.shape, s, mesh), dtype=a.dtype, device=device),
        full, cache_specs(full, cfg, mesh))


def arg_bytes(tree) -> int:
    """The bytes of a tree's tensors."""
    if isinstance(tree, dict):
        return sum(arg_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(arg_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def _rows(n_rows: int, mesh) -> int:
    """This rank's requests of a global batch: its block of (pod, data),
    or all of them where they do not split (the reference's ``fit_spec``
    replicates such a batch)."""
    n = 1 if mesh is None else mesh.size("pod", "data")
    return n_rows // n if n_rows % n == 0 else n_rows


# ---------------------------------------------------------------------------
# one traced step
# ---------------------------------------------------------------------------

def _diff(a: dict, b: dict) -> dict:
    return {k: b.get(k, 0) - a.get(k, 0) for k in set(a) | set(b)}


def _comm_counts(cc: CountingComm) -> dict:
    s = cc.summary()
    out = {f"coll/bytes/{k}": v for k, v in s["bytes_by_kind"].items()}
    out.update({f"coll/count/{k}": v for k, v in s["count_by_kind"].items()})
    return out


def cache_leaves(cache, path=()):
    """(path, tensor) of every leaf of a cache tree."""
    if isinstance(cache, dict):
        for k, v in cache.items():
            yield from cache_leaves(v, path + (str(k),))
    elif isinstance(cache, (list, tuple)):
        for i, v in enumerate(cache):
            yield from cache_leaves(v, path + (str(i),))
    elif isinstance(cache, torch.Tensor):
        yield path, cache


def _storages(cache) -> dict:
    """Each cache leaf's storage, by path: its identity on fake and on
    real tensors alike."""
    return {p: t.untyped_storage()._cdata for p, t in cache_leaves(cache)}


def _seq_split(cfg: ArchConfig, mesh) -> bool:
    """Whether a K/V ring of ``cfg`` is split over its rows on ``mesh``
    (its KV heads do not split over "model")."""
    if mesh is None or mesh.size("model") == 1:
        return False
    return cfg.n_kv_heads % mesh.size("model") != 0 and any(
        cfg.mixer_of(i) in ("attn", "swa") for i in range(cfg.n_layers))


def trace_step(cfg: ArchConfig, shape: InputShape, mesh, agg: str = "mean",
               fsdp: bool = False, n_micro: int | None = None,
               opt_dtype: str = "float32", comm_dtype: str = "float32",
               gossip_rounds: int = 8, scale: bool = True,
               count_flops: bool = True) -> dict:
    """Rank 0's fake arguments and one step of ``cfg`` x ``shape`` on
    ``mesh`` (a :class:`RankMesh`; ``None``: one process) under a
    :class:`StepTracker` -> the record: ``args`` (bytes by role),
    ``peak``, ``counts`` (the additive counters, scaled over the
    micro-batches not traced), ``calls`` (the counting communicator's),
    ``n_micro``, ``traced_micro``, and for decode ``cache_in_place`` and
    ``cache_leaves``. Call it under :func:`fake_mode`."""
    cc = CountingComm(mesh) if mesh is not None else None
    st = StepTracker(count_flops=count_flops)
    rec: dict[str, Any] = {"n_micro": 1, "traced_micro": 1}
    scaled = None               # (counts, peak, calls) of a scaled step

    def counters() -> dict:
        return {**st.counters(),
                **(_comm_counts(cc) if cc is not None else {})}

    with st:
        if shape.kind == "train":
            n_micro = n_micro or (pick_n_micro(cfg, shape, mesh)
                                  if mesh is not None else 1)
            rec["n_micro"] = n_micro
            pspecs = None if mesh is None else param_specs(
                M.param_shapes(cfg), cfg, mesh, fsdp=fsdp)
            params = local_params(cfg, pspecs, mesh)
            opt = adamw_init(params, opt_dtype)
            batch = batch_struct(cfg, shape, "cpu")
            rec["args"] = {"params": arg_bytes(params),
                           "optimizer": arg_bytes(opt),
                           "batch": arg_bytes(batch)}
            n_rank = 1 if mesh is None else mesh.size("pod", "data")
            rows = n_rank * (shape.global_batch // n_rank // n_micro)

            def train_step(n: int):
                """The step of ``n`` micro-batches, on the batch's first
                ``n`` micro-batches of rows."""
                tc = T.TrainConfig(
                    arch=cfg,
                    agg=AggregatorConfig(kind=agg, F=1,
                                         gossip_rounds=gossip_rounds,
                                         gamma_period=4, drop_prob=0.1,
                                         comm_dtype=comm_dtype,
                                         trim_backend="cuda",
                                         pushsum_backend="cuda"),
                    opt=AdamWConfig(moment_dtype=opt_dtype), fsdp=fsdp,
                    n_micro=n)
                step = T.make_train_step(tc, backend="cuda", mesh=mesh,
                                         comm=cc)
                b = batch if n == n_micro else {
                    k: v[:n * rows] for k, v in batch.items()}
                if agg == "mean":
                    return lambda: step(params, opt, b)
                from ..core.prng import prng_key
                return lambda: step(params, opt, b, prng_key(0))

            if not (scale and n_micro > 3):
                rec["traced_micro"] = n_micro
                train_step(n_micro)()
            else:
                rec["traced_micro"] = 2
                run = train_step(2)
                c0 = counters()
                run()
                c1 = counters()
                peak, n_calls = st.peak, len(cc.calls) if cc else 0
                run = train_step(3)
                c2 = counters()
                run()
                per = _diff(_diff(c0, c1), _diff(c2, counters()))
                scaled = ({k: c1.get(k, 0) + (n_micro - 2) * per.get(k, 0)
                           for k in set(c1) | set(per)}, peak, n_calls)
        else:
            params = local_params(cfg, None if mesh is None else param_specs(
                M.param_shapes(cfg), cfg, mesh), mesh)
            B = _rows(shape.global_batch, mesh)
            if shape.kind == "prefill":
                from ..distributed.server import make_prefill_step
                batch = batch_struct(cfg, dataclasses.replace(
                    shape, global_batch=B), "cpu")
                del batch["labels"]
                rec["args"] = {"params": arg_bytes(params),
                               "batch": arg_bytes(batch)}
                step = make_prefill_step(cfg, backend="cuda", mesh=mesh,
                                         comm=cc)
                step(params, batch)
            else:
                from ..distributed.server import make_decode_step
                cache_len = decode_cache_len(cfg, shape)
                cache = local_cache(cfg, shape.global_batch, cache_len,
                                    mesh)
                token = torch.empty((B, 1), dtype=torch.int64)
                rec["args"] = {"params": arg_bytes(params),
                               "cache": arg_bytes(cache),
                               "batch": arg_bytes(token)}
                before = _storages(cache)
                step = make_decode_step(cfg, backend="cuda",
                                        cache_len=cache_len, mesh=mesh,
                                        comm=cc)
                _, out = step(params, cache, token)
                after = _storages(out)
                rec["cache_in_place"] = after == before
                rec["cache_leaves"] = len(before)
    counts, peak, n_calls = scaled or (
        counters(), st.peak, len(cc.calls) if cc else 0)
    rec["peak"] = peak
    rec["counts"] = counts
    rec["calls"] = list(cc.calls[:n_calls]) if cc is not None else []
    return rec


def _collectives(counts: dict) -> dict:
    by_kind = {k: counts.get(f"coll/bytes/{k}", 0.0)
               for k in COLLECTIVE_KINDS}
    return {"wire_bytes_per_device": sum(by_kind.values()),
            "bytes_by_kind": by_kind,
            "count_by_kind": {k: int(counts.get(f"coll/count/{k}", 0))
                              for k in COLLECTIVE_KINDS}}


def _kernels(counts: dict) -> dict:
    out: dict[str, dict] = {}
    for key, v in counts.items():
        if key.startswith("kernel/"):
            _, name, what = key.split("/")
            out.setdefault(name, {})[what] = \
                int(v) if what == "launches" else v
    return out


def lower_one(arch: str, shape_name: str, multi_pod: bool, agg: str = "mean",
              skip_cost: bool = False, overrides: dict | None = None,
              opt_dtype: str = "float32", comm_dtype: str = "float32",
              gossip_rounds: int = 8) -> dict:
    """One combination on rank 0 of the production mesh -> its row (see
    the module docstring). Raises what the port raises."""
    cfg0 = get_config(arch)
    if overrides:
        cfg0 = dataclasses.replace(cfg0, **overrides)
    shape = INPUT_SHAPES[shape_name]
    cfg = serve_cfg_for(cfg0, shape) if shape.kind != "train" else cfg0
    fsdp = cfg.param_count() > FSDP_THRESHOLD and agg == "mean" \
        and shape.kind == "train"
    mesh_name = "2x16x16" if multi_pod else "16x16"
    t0 = time.time()
    with fake_mesh(*PRODUCTION_SHAPES[multi_pod]) as rm, fake_mode():
        n_dev = math.prod(PRODUCTION_SHAPES[multi_pod][0])
        mesh_shape = dict(rm.shape)
        rec = trace_step(cfg, shape, rm, agg, fsdp, opt_dtype=opt_dtype,
                         comm_dtype=comm_dtype, gossip_rounds=gossip_rounds,
                         count_flops=not skip_cost)
        seq_split = _seq_split(cfg, rm)
    trace_s = time.time() - t0
    counts = rec["counts"]
    coll = _collectives(counts)
    cost = {"flops": counts["flops"], "bytes accessed": counts["bytes"]}
    terms = roofline_terms(cost, coll, n_dev, model_flops(cfg, shape))
    if shape.kind == "train":
        analytic = train_memory_gb(
            cfg, shape, mesh_shape, fsdp, rec["n_micro"],
            worker_axis=(agg != "mean"),
            moment_bytes=2 if opt_dtype == "bfloat16" else 4)
    else:
        analytic = serve_memory_gb(
            cfg, shape, mesh_shape,
            decode_cache_len(cfg, shape) if shape.kind == "decode"
            else shape.seq_len)
    args = rec["args"]
    row = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name, "agg": agg,
        "ok": True, "fsdp": fsdp, "trace_s": round(trace_s, 1),
        "traced_rank": 0,
        "memory": {
            **{f"{k}_bytes_per_device": v for k, v in args.items()},
            "argument_bytes_per_device": sum(args.values()),
            "peak_bytes_per_device": rec["peak"],
            "peak_gb": round(rec["peak"] / 1e9, 3),
            "fits_hbm": rec["peak"] < HW().hbm_bytes,
        },
        "analytic_memory": analytic,
        "roofline": terms,
        "collectives": coll,
        "cost_mode": "scaled" if rec["traced_micro"] < rec["n_micro"]
        else "direct",
        "n_micro": rec["n_micro"],
        "kernels": _kernels(counts),
    }
    if skip_cost:
        row["cost_note"] = "--skip-cost: library FLOPs not counted"
    if shape.kind != "train" and cfg.param_count() > SERVE_GATHER_THRESHOLD:
        row["serve_gather_reference"] = (
            "the reference gathers weights over (data, model) above "
            f"{SERVE_GATHER_THRESHOLD:.0e} parameters; the port serves on "
            "the model split alone")
    if "cache_in_place" in rec:
        row["cache_in_place"] = rec["cache_in_place"]
    if seq_split and shape.kind != "train":
        row["rank_note"] = (
            "the K/V rings are split over their rows: each rank holds a "
            "block of every ring (rank 0 the first), and a prompt longer "
            "than a ring wraps into rank 0's block; shapes and ops are "
            "the same on every rank")
    return row


def _fail_row(arch, shape, multi_pod, agg, e) -> dict:
    return {"arch": arch, "shape": shape,
            "mesh": "2x16x16" if multi_pod else "16x16", "agg": agg,
            "ok": False, "error": f"{type(e).__name__}: {e}",
            "trace": traceback.format_exc()[-2000:]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--agg", default="mean")
    ap.add_argument("--skip-cost", action="store_true",
                    help="leave the library ops' FLOPs uncounted")
    ap.add_argument("--moe-impl", default=None, choices=[None, "gspmd",
                                                         "sharded"])
    ap.add_argument("--remat-group", type=int, default=None)
    ap.add_argument("--pad-heads", type=int, default=None)
    ap.add_argument("--ce-chunk", type=int, default=None)
    ap.add_argument("--opt-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--comm-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--gossip-rounds", type=int, default=8)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    overrides = {}
    if args.moe_impl:
        overrides["moe_impl"] = args.moe_impl
    if args.remat_group:
        overrides["remat_group"] = args.remat_group
    if args.pad_heads:
        overrides["pad_heads_to"] = args.pad_heads
    if args.ce_chunk:
        overrides["ce_chunk"] = args.ce_chunk

    archs = [a for a in ARCH_IDS if a != "paper_sim"] \
        if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    pods = {"single": [False], "multi": [True], "both": [False, True]}[
        args.multi_pod]

    results = []
    t_all = time.time()
    for arch in archs:
        for shape in shapes:
            for mp in pods:
                tag = f"{arch} x {shape} x {'2x16x16' if mp else '16x16'}"
                try:
                    rec = lower_one(arch, shape, mp, args.agg,
                                    skip_cost=args.skip_cost,
                                    overrides=overrides or None,
                                    opt_dtype=args.opt_dtype,
                                    comm_dtype=args.comm_dtype,
                                    gossip_rounds=args.gossip_rounds)
                    r, m = rec["roofline"], rec["memory"]
                    print(f"OK   {tag}: trace={rec['trace_s']}s "
                          f"peak={m['peak_gb']}GB fits={m['fits_hbm']} "
                          f"analytic={rec['analytic_memory']['total_gb']}GB "
                          f"compute={r['compute_s']:.4f}s "
                          f"memory={r['memory_s']:.4f}s "
                          f"coll={r['collective_s']:.4f}s "
                          f"dom={r['dominant']} "
                          f"useful={r['useful_flop_ratio']:.2f}", flush=True)
                except Exception as e:      # noqa: BLE001 — a row a case
                    rec = _fail_row(arch, shape, mp, args.agg, e)
                    print(f"FAIL {tag}: {rec['error']}", flush=True)
                results.append(rec)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")
    n_ok = sum(r["ok"] for r in results)
    print(f"{n_ok}/{len(results)} combinations traced in "
          f"{time.time() - t_all:.1f} s")


if __name__ == "__main__":
    main()
