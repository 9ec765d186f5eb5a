"""The dry run (``repro_torch.launch.dryrun``) against the reference's
(``repro.launch.dryrun``), and the pieces it stands on: the kernels' shape
rules, the counting communicator, the step tracker's micro-batch scaling
and the decode cache's storage.

* the reference's helpers (``pick_remat_group``, ``pick_n_micro``,
  ``serve_cfg_for``, ``decode_cache_len``, ``input_specs``) give the same
  answers for every architecture x shape x stand-in mesh; the port's
  token ids are int64 where the reference's are int32;
* each rank's parameter, optimizer and cache bytes equal what the
  reference's ``param_specs`` / ``cache_specs`` trees imply, at published
  size on meta tensors, for every architecture on every stand-in mesh;
* a real 2-rank gloo run records the collectives the dry run traces on a
  fake group (an FSDP mean step on data 2; a serve on model 2);
* each kernel wrapper's shape rule gives the plain version's output
  shapes and dtypes at the kernel tests' shapes, launches nothing and
  counts no launch; ``backend="cuda"`` on a real CPU tensor still raises;
* a train step scaled from steps of two and three micro-batches counts
  what the full trace counts;
* ``decode_step`` keeps the storage of every cache leaf (real tensors,
  every family; fake tensors in the dry run's row);
* the CLI prints ``1/1`` and leaves no process group behind.
"""
import dataclasses
import math
import multiprocessing as mp
import os
import socket
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import pytest
import torch
import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import _torch_dryrun_child as child

from repro_torch.configs import (ARCH_IDS, INPUT_SHAPES, InputShape,
                                 get_config, reduced)
from repro_torch.kernels.dispatch import recording, resolve_backend
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import fake_mesh
from repro_torch.models import model as M
from repro_torch.optim import adamw_init

REPO = Path(__file__).resolve().parents[1]
ARCHS = [a for a in ARCH_IDS if a != "paper_sim"]
MESHES = {
    "data2_model4": SimpleNamespace(axis_names=("data", "model"),
                                    shape={"data": 2, "model": 4}),
    "data1_model16": SimpleNamespace(axis_names=("data", "model"),
                                     shape={"data": 1, "model": 16}),
    "pod2_data2_model2": SimpleNamespace(
        axis_names=("pod", "data", "model"),
        shape={"pod": 2, "data": 2, "model": 2}),
    "16x16": SimpleNamespace(axis_names=("data", "model"),
                             shape={"data": 16, "model": 16}),
    "2x16x16": SimpleNamespace(axis_names=("pod", "data", "model"),
                               shape={"pod": 2, "data": 16, "model": 16}),
}
CACHE_B, CACHE_LEN = 32, 64
TIMEOUT = 300


@pytest.fixture(scope="module")
def ref():
    """``repro.launch.dryrun``, imported with its 512-device XLA flag
    undone, so no later JAX backend of this process takes it."""
    old = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as jd
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return jd


# ---------------------------------------------------------------------------
# the reference's helpers
# ---------------------------------------------------------------------------

def test_helpers_are_the_references(ref):
    from repro.configs import get_config as jget
    assert (D.FSDP_THRESHOLD, D.SERVE_GATHER_THRESHOLD, D.LONG_WINDOW,
            D.MICRO_TOKENS) == (ref.FSDP_THRESHOLD,
                                ref.SERVE_GATHER_THRESHOLD, ref.LONG_WINDOW,
                                ref.MICRO_TOKENS)
    for L in range(1, 200):
        assert D.pick_remat_group(L) == ref.pick_remat_group(L), L
    for arch in ARCHS:
        cfg, jcfg = get_config(arch), jget(arch)
        for name, shape in INPUT_SHAPES.items():
            jshape = ref.INPUT_SHAPES[name]
            for mname, mesh in MESHES.items():
                assert D.pick_n_micro(cfg, shape, mesh) == \
                    ref.pick_n_micro(jcfg, jshape, mesh), (arch, name, mname)
            got, want = D.serve_cfg_for(cfg, shape), \
                ref.serve_cfg_for(jcfg, jshape)
            assert (got.block_pattern, got.window) == \
                (want.block_pattern, want.window), (arch, name)
            assert D.decode_cache_len(cfg, shape) == \
                ref.decode_cache_len(jcfg, jshape), (arch, name)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_are_the_references(ref, arch):
    """Every leaf's shape and dtype; int32 token ids are int64 here."""
    import jax.numpy as jnp
    for name in INPUT_SHAPES:
        want = ref.input_specs(arch, name)
        got = D.input_specs(arch, name)
        assert sorted(got) == sorted(want), (arch, name)
        for k, t in got.items():
            w = want[k]
            wdt = "int64" if w.dtype == jnp.int32 else str(w.dtype)
            assert t.device.type == "meta"
            assert (tuple(t.shape), str(t.dtype).replace("torch.", "")) == \
                (tuple(w.shape), wdt), (arch, name, k)


# ---------------------------------------------------------------------------
# a rank's argument bytes against the reference's spec trees
# ---------------------------------------------------------------------------

def _spec_bytes(tree, specs, mesh) -> int:
    """The bytes a reference tree's leaves take on one device of ``mesh``
    under its ``PartitionSpec`` tree."""
    from jax.sharding import PartitionSpec as P
    leaves = jax.tree_util.tree_leaves(tree)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, P))
    total = 0
    for a, s in zip(leaves, spec_leaves, strict=True):
        n = math.prod(a.shape)
        for e in tuple(s):
            axes = () if e is None else (e if isinstance(e, tuple) else (e,))
            n //= math.prod(mesh.shape.get(x, 1) for x in axes)
        total += n * a.dtype.itemsize
    return total


@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_are_the_reference_specs(arch):
    import repro.distributed.sharding as js
    import repro.models.model as jm
    from repro.configs import get_config as jget
    from repro.optim import adamw_init as jadamw_init

    cfg, jcfg = get_config(arch), jget(arch)
    jparams = jax.eval_shape(lambda: jm.init_params(jax.random.PRNGKey(0),
                                                    jcfg))
    jopt = jax.eval_shape(jadamw_init, jparams)
    enc = jax.ShapeDtypeStruct((CACHE_B, jcfg.n_frames, jcfg.d_model),
                               jax.numpy.bfloat16)
    jcache = jax.eval_shape(
        lambda p, e: jm.init_cache(p, jcfg, CACHE_B, CACHE_LEN, e),
        jparams, enc) if jcfg.encoder_layers else jax.eval_shape(
        lambda p: jm.init_cache(p, jcfg, CACHE_B, CACHE_LEN), jparams)
    shapes = M.param_shapes(cfg)
    for mname, mesh in MESHES.items():
        for fsdp in (False, True):
            from repro_torch.distributed.sharding import param_specs
            params = D.local_params(cfg, param_specs(shapes, cfg, mesh,
                                                     fsdp=fsdp), mesh, "meta")
            jspecs = js.param_specs(jparams, jcfg, mesh, fsdp=fsdp)
            assert D.arg_bytes(params) == _spec_bytes(jparams, jspecs, mesh), \
                (arch, mname, fsdp)
            assert D.arg_bytes(adamw_init(params)) == _spec_bytes(
                jopt, js.opt_state_specs(jspecs), mesh), (arch, mname, fsdp)
        cache = D.local_cache(cfg, CACHE_B, CACHE_LEN, mesh, "meta")
        assert D.arg_bytes(cache) == _spec_bytes(
            jcache, js.cache_specs(jcache, jcfg, mesh), mesh), (arch, mname)


# ---------------------------------------------------------------------------
# the fake group's collectives against a real gloo run
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def gloo_runs(tmp_path_factory):
    """Each case of ``_torch_dryrun_child`` on 2 spawned gloo ranks ->
    {case: [rank records]}."""
    out = tmp_path_factory.mktemp("dryrun_gloo")
    ctx = mp.get_context("spawn")
    procs = []
    for name in child.MESHES:
        port = _free_port()
        procs += [ctx.Process(target=child.main,
                              args=(name, r, 2, port, str(out)))
                  for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(TIMEOUT)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    errs = sorted(out.glob("*.err"))
    assert not errs, "\n".join(e.read_text() for e in errs)
    assert not hung and all(p.exitcode == 0 for p in procs)
    return {name: [torch.load(out / f"{name}_{r}.pt") for r in range(2)]
            for name in child.MESHES}


def _fake_calls(name: str) -> list:
    shape, dims = child.MESHES[name]
    cfg = child.cfg()
    with fake_mesh(shape, dims) as rm, D.fake_mode():
        if name == "fsdp_data2":
            recs = [D.trace_step(cfg, child.TRAIN, rm, "mean", fsdp=True,
                                 n_micro=1)]
        else:
            S = child.SERVE
            recs = [D.trace_step(cfg, S, rm),
                    D.trace_step(cfg, dataclasses.replace(S, kind="decode"),
                                 rm)]
    return [c for r in recs for c in child.record(r["calls"])]


@pytest.mark.parametrize("name", sorted(child.MESHES))
def test_fake_group_collectives_are_a_gloo_runs(gloo_runs, name):
    fake = _fake_calls(name)
    assert fake, name
    assert not torch.distributed.is_initialized()
    for r, rec in enumerate(gloo_runs[name]):
        assert rec["loaded"] == []
        assert rec["calls"] == fake, (name, r)


# ---------------------------------------------------------------------------
# the kernels' shape rules
# ---------------------------------------------------------------------------

def _kernel_cases():
    """(wrapper, real CPU inputs, the plain version's outputs) of every
    kernel wrapper, at the shapes its CPU test file runs."""
    from repro_torch.kernels.byz_trim import trim_gather_cuda, trim_gather_ref
    from repro_torch.kernels.pushsum_edge import (dst_offsets,
                                                  edge_scatter_cuda,
                                                  edge_scatter_ref)
    from repro_torch.kernels.social_innov import (innovation_cuda,
                                                  innovation_ref)
    from repro_torch.kernels.swa import (attn_decode_cuda,
                                         attn_decode_merge_cuda,
                                         attn_decode_merge_ref,
                                         attn_decode_partial_cuda,
                                         attn_decode_partial_ref,
                                         attn_decode_ref, swa_prefill_cuda,
                                         swa_prefill_ref)
    from repro_torch.kernels.trimmed_mean import (trimmed_mean_cuda,
                                                  trimmed_mean_ref)
    from repro_torch.kernels.wkv6 import wkv6_cuda, wkv6_chunked_ref

    g = torch.Generator().manual_seed(0)

    def rn(*s, dtype=torch.float32):
        return torch.randn(s, generator=g).to(dtype)

    N, D, E = 24, 4, 60
    dst = torch.sort(torch.randint(0, N, (E,), generator=g))[0].int()
    src = torch.randint(0, N, (E,), generator=g).int()
    k1 = (rn(N, D), rn(E, D), torch.rand(E, generator=g) > 0.3, src,
          dst_offsets(dst, N))
    m, S = 3, 4
    cdf = torch.cumsum(torch.rand(N, S, generator=g), 1)
    k2 = (rn(N, m), torch.rand(N, generator=g) + 0.5,
          torch.rand(N, generator=g), cdf / cdf[:, -1:], rn(N, m, S))
    dm, P = 7, 9
    k3 = (rn(N, P), torch.randint(0, N, (N, dm), generator=g).int(),
          torch.rand(N, dm, generator=g) > 0.2,
          torch.full((), 1e3).expand(N, dm, P),
          torch.rand(N, dm, generator=g) > 0.8, 2)
    B, H, Hkv, Wc, dh = 2, 8, 2, 40, 64
    bf = torch.bfloat16
    lens = torch.tensor([Wc, 17], dtype=torch.int32)
    k5 = (rn(B, H, dh, dtype=bf), rn(B, Hkv, Wc, dh, dtype=bf),
          rn(B, Hkv, Wc, dh, dtype=bf), lens)
    acc, mm, ll = attn_decode_partial_ref(*k5)
    parts = tuple(t[None].expand(2, *t.shape).contiguous()
                  for t in (acc, mm, ll))
    Sq = 48
    k6 = (rn(B, Sq, H, dh, dtype=bf), rn(B, Sq, Hkv, dh, dtype=bf),
          rn(B, Sq, Hkv, dh, dtype=bf), 16)
    T = 70
    k7 = (rn(3, T, 64, dtype=bf), rn(3, T, 64, dtype=bf),
          rn(3, T, 64, dtype=bf), -torch.rand(3, T, 64, generator=g),
          rn(3, 64))
    x4 = rn(7, 33)
    return [
        ("edge_scatter", edge_scatter_cuda, k1,
         edge_scatter_ref(*k1[:4], dst, n_recv=N)),
        ("social_innov", innovation_cuda, k2, innovation_ref(*k2)),
        ("byz_trim", trim_gather_cuda, k3, trim_gather_ref(*k3)),
        ("attn_decode", attn_decode_cuda, k5, attn_decode_ref(*k5)),
        ("attn_decode_partial", attn_decode_partial_cuda, k5,
         (acc, mm, ll)),
        ("attn_decode_merge", attn_decode_merge_cuda, parts + (bf,),
         attn_decode_merge_ref(*parts, bf)),
        ("swa_prefill", swa_prefill_cuda, k6, swa_prefill_ref(*k6)),
        ("wkv6", wkv6_cuda, k7, wkv6_chunked_ref(*k7, chunk=64)),
        ("trimmed_mean", trimmed_mean_cuda, (x4, 2),
         trimmed_mean_ref(x4, 2)),
    ]


KERNEL_CASES = _kernel_cases()


@pytest.mark.parametrize("case", KERNEL_CASES, ids=[c[0] for c in
                                                     KERNEL_CASES])
def test_shape_rule_gives_the_plain_outputs(case):
    from torch._subclasses.fake_tensor import FakeTensorMode
    name, fn, args, want = case
    launches = fn.launches
    heard = []
    with FakeTensorMode() as fm, recording(heard.append):
        fargs = [fm.from_tensor(a) if isinstance(a, torch.Tensor) else a
                 for a in args]
        got = fn(*fargs)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert [(tuple(t.shape), t.dtype) for t in got] == \
        [(tuple(t.shape), t.dtype) for t in want], name
    assert [c.kernel for c in heard] == [name]
    assert heard[0].bytes > 0 and heard[0].flops + heard[0].fp32_ops > 0
    assert fn.launches == launches, "a shape rule counts no launch"


@pytest.mark.parametrize("case", KERNEL_CASES, ids=[c[0] for c in
                                                     KERNEL_CASES])
def test_cuda_route_still_raises_on_real_cpu_tensors(case):
    name, fn, args, _ = case
    with pytest.raises(ValueError):
        fn(*args)
    with pytest.raises(ValueError):
        resolve_backend("cuda", args[0])


# ---------------------------------------------------------------------------
# micro-batch scaling, the decode cache's storage, the CLI
# ---------------------------------------------------------------------------

def test_scaled_micro_batches_count_the_full_trace():
    cfg = child.cfg()
    shape = InputShape("train_tiny", 16, 8, "train")
    recs = {}
    with fake_mesh((2,), ("data",)) as rm, D.fake_mode():
        for scale in (True, False):
            recs[scale] = D.trace_step(cfg, shape, rm, "mean", fsdp=True,
                                       n_micro=4, scale=scale)
    scaled, full = recs[True], recs[False]
    assert (scaled["traced_micro"], full["traced_micro"]) == (2, 4)
    assert scaled["counts"].keys() == full["counts"].keys()
    for k, v in full["counts"].items():
        assert scaled["counts"][k] == pytest.approx(v, rel=1e-12), k
    # a reduced config has no remat: one K6 launch a layer a micro-batch
    assert scaled["counts"]["kernel/swa_prefill/launches"] == \
        4 * cfg.n_layers
    assert scaled["peak"] == full["peak"]


FAMILIES = ["qwen3_8b", "rwkv6_1b6", "olmoe_1b_7b", "recurrentgemma_2b",
            "whisper_small", "internvl2_26b", "command_r_35b"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_step_keeps_every_cache_storage(arch):
    """Real tensors: every leaf's ``data_ptr`` before a decode step is the
    leaf's after it, and the step returns those leaves."""
    cfg = reduced(get_config(arch))
    params = M.init_params(0, cfg, "cpu")
    B, S = 2, 8
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=g)
    stubs = {}
    if cfg.family == "audio":
        stubs["frames"] = torch.randn(B, cfg.n_frames, cfg.d_model,
                                      generator=g)
    if cfg.family == "vlm":
        stubs["patch_embeds"] = torch.randn(B, cfg.n_patches, M.D_VIS,
                                            generator=g)
    with torch.inference_mode():
        logits, cache = M.prefill(params, cfg, tokens, cache_len=S + 4,
                                  backend="torch", **stubs)
        before = {p: t.data_ptr() for p, t in D.cache_leaves(cache)}
        tok = logits[:, -1].argmax(-1)[:, None]
        for _ in range(2):
            logits, out = M.decode_step(params, cfg, cache, tok,
                                        backend="torch", cache_len=S + 4)
            after = {p: t.data_ptr() for p, t in D.cache_leaves(out)}
            assert after == before, arch
            tok = logits[:, -1].argmax(-1)[:, None]
    assert any("pos" in p for p in before) or cfg.family != "dense"


@pytest.mark.parametrize("arch", FAMILIES)
def test_dry_run_decode_keeps_every_cache_storage(arch):
    """Fake tensors on a model axis of 2: the dry run's storage check."""
    cfg = reduced(get_config(arch))
    with fake_mesh((1, 2), ("data", "model")) as rm, D.fake_mode():
        rec = D.trace_step(cfg, InputShape("d", 16, 2, "decode"), rm)
    assert rec["cache_in_place"] is True and rec["cache_leaves"] > 0


def test_cli_single_combination():
    """The entry point itself, as ``tests/test_launchers.py`` runs the
    reference's: the smallest arch, no cost counting."""
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    code = ("import runpy, sys, torch.distributed as dist\n"
            "sys.argv = ['dryrun', '--arch', 'whisper_small', '--shape', "
            "'decode_32k', '--skip-cost']\n"
            "runpy.run_module('repro_torch.launch.dryrun', "
            "run_name='__main__')\n"
            "print('group left:', dist.is_initialized())\n")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "1/1 combinations traced" in out.stdout
    assert "group left: False" in out.stdout
    assert "OK   whisper_small x decode_32k x 16x16" in out.stdout


def test_render_reads_the_rows():
    """``analysis.render``'s table: a traced row with its fit against 80
    GB and its kernels, a failed row with its error."""
    from repro_torch.analysis import render
    ok = {"arch": "qwen3_8b", "shape": "decode_32k", "mesh": "16x16",
          "ok": True,
          "roofline": {"compute_s": 1e-3, "memory_s": 2e-3,
                       "collective_s": 0.0, "dominant": "memory",
                       "useful_flop_ratio": 0.5},
          "memory": {"peak_gb": 81.5, "fits_hbm": False},
          "analytic_memory": {"total_gb": 3.7},
          "collectives": {"bytes_by_kind": {"all-reduce": 0.0,
                                            "all-gather": 5.0}},
          "kernels": {"attn_decode": {"launches": 36}}}
    bad = {"arch": "olmoe_1b_7b", "shape": "train_4k", "mesh": "16x16",
           "ok": False, "error": "NotImplementedError: experts"}
    lines = render.table([ok, bad]).splitlines()
    assert lines[0] == render.HEADER and len(lines) == 4
    cells = lines[2].rstrip(" |").split(" | ")
    assert cells[8:13] == ["81.5", "NO", "3.7", "all-gather",
                           "attn_decode 36"]
    assert "FAIL: NotImplementedError: experts" in lines[3]
    assert lines[3].count("|") == lines[2].count("|")
