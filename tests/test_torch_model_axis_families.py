"""The other model families served over a model axis on the CPU: gloo
ranks in spawned processes (``tests/_torch_model_axis_child.py``), held
against the one-process port and the reference's one-device serve.

Three meshes run once for the module, at the same time, 10 ranks: (model
2), (model 4) and (data 2 x model 2). On each, every case of
``child.CASES`` (reduced RWKV6, RecurrentGemma with a wrapping window and
with 6 query heads, Whisper and InternVL2 with their stub inputs and with
an odd vocabulary of 509, Command-R's parallel blocks; float32) runs
prefill and 3 greedy decode steps through the mesh-taking step builders on
the rank's blocks of the reference's parameters (converted). The layouts
this covers: RWKV6's heads over the axis (2 and 1 a rank), query heads
split inside a head (RecurrentGemma's 6 heads at model 4: 1.5 a rank), one
KV head split inside the head at every extent, K/V caches split over the
ring's rows (wrapped by the prompt, written by the owning rank) and a ring
whose rows do not split (whole on every rank), the RG-LRU on its
channels, Whisper's encoder and cross-attention on local heads,
vocabularies that do not split (whole on every rank), InternVL2's patch
projector, Command-R's parallel attention and MLP.

* Logits within 1e-4 of the one-process port and of the reference's
  ``prefill`` / ``decode_step`` (float32 on every side; the blocks sum
  their products in another order); greedy tokens equal to both.
* Every cache leaf of every rank within 1e-5 of its ``cache_specs`` block
  of the one-process cache.
* K5's rank-partial plain version and its merge over 1, 2 and 4 blocks of
  a ring (an empty block, a wrapped ring, requests of length 0) against
  ``attn_decode_ref`` and the reference's ``repro.kernels.swa.ref``.
* The backward rules of the model axis' new operators against one
  process's autograd (float64): ``gather_cols`` for a consumer that uses
  part of the gathered columns on each rank (its backward sums the ranks'
  gradients), ``scatter_last`` (its backward gathers the blocks') and
  ``gather_last`` for a replicated consumer.
* ``make_train_step(mesh=)`` refuses these families over a model axis
  (ROADMAP item 8c, part 3); no rank loads ``jax`` or ``repro``.
* A decode step refuses a cache split over its ring's rows without the
  prefill's ``cache_len``, or with one that gives another ring.
"""
import dataclasses
import multiprocessing as mp
import socket
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (caps torch threads under xdist)

import _torch_model_axis_child as child
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.kernels.swa.ref import attn_decode_ref as jax_attn_decode_ref
from repro.models import model as JM
from repro_torch.convert import params_from_jax
from repro_torch.distributed.sharding import cache_specs, local_block
from repro_torch.kernels.swa import (attn_decode_merge_ref,
                                     attn_decode_partial_ref,
                                     attn_decode_ref)
from repro_torch.models import model as TM

pytestmark = pytest.mark.multidevice

REPO = Path(__file__).resolve().parents[1]
WORLD = {name: d * m for name, (d, m) in child.MESHES.items()}
TIMEOUT = 300          # seconds for all three meshes
TOL, CACHE_TOL = 1e-4, 1e-5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_cfg(name: str):
    arch, extra = child.CASES[name]
    return dataclasses.replace(jax_reduced(jax_get_config(arch)), **extra)


def _inputs(cfg, seed: int) -> dict:
    """Prompts and the stub inputs (numpy float32) from a seed."""
    rng = np.random.default_rng(seed)
    B = child.SERVE_B
    stubs = {}
    if cfg.family == "audio":
        stubs["frames"] = rng.normal(size=(B, cfg.n_frames, cfg.d_model))
    if cfg.family == "vlm":
        stubs["patch_embeds"] = rng.normal(size=(B, cfg.n_patches, TM.D_VIS))
    return {"prompts": rng.integers(0, cfg.vocab, size=(B, child.SERVE_S)
                                    ).astype(np.int32),
            "stubs": {k: v.astype(np.float32) for k, v in stubs.items()}}


def _reference_serve(jp, jcfg, inputs) -> tuple[np.ndarray, np.ndarray]:
    """The reference's one-device prefill and greedy decode steps, jitted
    -> (logits (B, 1 + GEN, V), tokens (B, 1 + GEN))."""
    stubs = {k: jnp.asarray(v) for k, v in inputs["stubs"].items()}
    prefill = jax.jit(lambda p, t, s: JM.prefill(
        p, jcfg, t, cache_len=child.cache_len(jcfg), **s))
    decode = jax.jit(lambda p, c, t: JM.decode_step(p, jcfg, c, t))
    lg, cache = prefill(jp, jnp.asarray(inputs["prompts"]), stubs)
    seen = [np.asarray(lg[:, -1])]
    tok = jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32)
    toks = [np.asarray(tok)]
    for _ in range(child.SERVE_GEN):
        lg, cache = decode(jp, cache, tok)
        seen.append(np.asarray(lg[:, -1]))
        tok = jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32)
        toks.append(np.asarray(tok))
    return np.stack(seen, 1), np.concatenate(toks, 1)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Convert each case's reference parameters, launch the three meshes,
    and meanwhile run the reference's and the one-process port's serves ->
    (ranks by mesh, reference by case, one-process port by case)."""
    out = tmp_path_factory.mktemp("model_axis_families")
    jparams, inputs = {}, {}
    for i, name in enumerate(child.CASES):
        jcfg, tcfg = _jax_cfg(name), child.case_cfg(name)
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        jparams[name] = JM.init_params(jax.random.PRNGKey(i), jcfg)
        torch.save(params_from_jax(jax.tree.map(np.asarray, jparams[name]),
                                   tcfg, "cpu"), out / f"{name}_params.pt")
        inputs[name] = _inputs(tcfg, 10 + i)
        torch.save({"prompts": torch.from_numpy(inputs[name]["prompts"]),
                    "stubs": {k: torch.from_numpy(v) for k, v in
                              inputs[name]["stubs"].items()}},
                   out / f"{name}_inputs.pt")
    ctx = mp.get_context("spawn")
    procs = []
    for mesh, world in WORLD.items():
        port = _free_port()
        procs += [ctx.Process(target=child.main,
                              args=(mesh, r, world, port, str(out)))
                  for r in range(world)]
    for p in procs:
        p.start()
    ref, one = {}, {}
    try:
        for name in child.CASES:
            ref[name] = _reference_serve(jparams[name], _jax_cfg(name),
                                         inputs[name])
            cfg = child.case_cfg(name)
            params = torch.load(out / f"{name}_params.pt")
            one[name] = child.serve(params, cfg,
                                    torch.from_numpy(inputs[name]["prompts"]),
                                    {k: torch.from_numpy(v) for k, v in
                                     inputs[name]["stubs"].items()})
    finally:
        for p in procs:
            p.join(TIMEOUT)
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
    errs = sorted(out.glob("*.err"))
    assert not errs, "\n".join(e.read_text() for e in errs)
    assert not hung, f"{len(hung)} ranks did not finish in {TIMEOUT} s"
    assert all(p.exitcode == 0 for p in procs)
    ranks = {mesh: [torch.load(out / f"{mesh}_{r}.pt") for r in range(world)]
             for mesh, world in WORLD.items()}
    return ranks, ref, one


class _Coords:
    """A rank's view of a mesh for the spec rules and ``local_block``: the
    ``RankMesh`` interface without a process group."""

    axis_names = ("data", "model")

    def __init__(self, shape: tuple, coord: tuple):
        self.shape = dict(zip(self.axis_names, shape))
        self.coords = dict(zip(self.axis_names, coord))

    def size(self, *axes):
        n = 1
        for a in axes:
            n *= self.shape.get(a, 1)
        return n

    def index(self, *axes):
        i = 0
        for a in axes:
            if a in self.shape:
                i = i * self.shape[a] + self.coords[a]
        return i


def _blocks(tree, specs, mesh):
    if isinstance(tree, dict):
        return {k: _blocks(tree[k], specs[k], mesh) for k in tree}
    if isinstance(tree, (list, tuple)):
        return [_blocks(t, s, mesh) for t, s in zip(tree, specs)]
    return local_block(tree, specs, mesh)


def _close_trees(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _close_trees(got[k], want[k], f"{path}/{k}")
        return
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _close_trees(a, b, f"{path}/{i}")
        return
    assert got.shape == want.shape and got.dtype == want.dtype, path
    torch.testing.assert_close(got, want, rtol=0, atol=CACHE_TOL, msg=path)


def test_no_rank_loads_jax_or_repro(served):
    for mesh, ranks in served[0].items():
        for r, res in enumerate(ranks):
            assert res["loaded"] == [], (mesh, r, res["loaded"])
            assert res["staged_calls"] == 0        # CPU tensors


@pytest.mark.parametrize("case", list(child.CASES))
@pytest.mark.parametrize("mesh", list(child.MESHES))
def test_family_serves_over_the_model_axis(served, mesh, case):
    """Every rank's logits against the one-process port and the
    reference, its greedy tokens against both, and every cache leaf
    against its ``cache_specs`` block of the one-process cache."""
    ranks, ref, one = served
    logits, toks, cache = one[case]
    ref_logits, ref_toks = ref[case]
    cfg = child.case_cfg(case)
    shape = child.MESHES[mesh]
    b = child.SERVE_B // shape[0]
    specs = cache_specs(cache, cfg, _Coords(shape, (0, 0)))
    for res in ranks[mesh]:
        got = res["cases"][case]
        d, m = res["coordinate"]
        rows = slice(d * b, (d + 1) * b)
        assert got["logits"].shape == (b, 1 + child.SERVE_GEN, cfg.vocab)
        torch.testing.assert_close(got["logits"], logits[rows], rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(got["logits"].numpy(), ref_logits[rows],
                                   rtol=0, atol=TOL)
        assert torch.equal(got["tokens"], toks[rows])
        np.testing.assert_array_equal(got["tokens"].numpy(), ref_toks[rows])
        _close_trees(got["cache"], _blocks(cache, specs,
                                           _Coords(shape, (d, m))))


def test_the_cases_cover_the_layouts(served):
    """The cases reach what they are there for: a K/V cache split over the
    ring's rows, a whole ring, a query split inside a head, an odd
    vocabulary whole on every rank."""
    ranks = served[0]

    def kv_rows(mesh, case):
        c = ranks[mesh][0]["cases"][case]["cache"]
        return [lay["mixer"]["k"].shape[2] for lay in c["layers"]
                if "k" in lay["mixer"]]

    assert kv_rows("model2", "recurrentgemma") == [6]     # 12-row ring
    assert kv_rows("model4", "recurrentgemma") == [3]
    assert kv_rows("model2", "recurrentgemma_6h") == [5]
    assert kv_rows("model4", "recurrentgemma_6h") == [10]  # whole ring
    assert kv_rows("model4", "internvl2") == [9, 9]
    assert kv_rows("model2", "whisper") == [20, 20]       # KV heads split
    rg6 = child.case_cfg("recurrentgemma_6h")
    assert (rg6.n_heads * rg6.head_dim // 4) % rg6.head_dim != 0


@pytest.mark.parametrize("mesh", list(child.MESHES))
def test_model_axis_operators_backward(served, mesh):
    """Every rank's gradients through the operators against one process:
    the sum over ranks r of the loss each rank's consumer computes, by
    autograd on the whole tensors."""
    ranks = served[0][mesh]
    mp, n = child.MESHES[mesh][1], child.OP_COLS
    d = child.operator_inputs(mp)
    x = d["x"].clone().requires_grad_()
    W = d["W"].clone().requires_grad_()
    P = d["P"].clone().requires_grad_()
    Y = x @ W
    total = P.sum(0)
    loss = 0
    for r in range(mp):
        used = torch.arange(r * n, (r + 2) * n) % (mp * n)
        loss = loss + (Y[:, used] * d["G"][:, used]).sum()
    # the replicated consumer: the loss is computed once, on every rank
    loss = loss + (total * d["G"]).sum()
    loss.backward()
    for res in ranks:
        got = res["operator_grads"]
        r = int(res["coordinate"][1])
        torch.testing.assert_close(got["x"], x.grad, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(got["W"], W.grad[:, r * n:(r + 1) * n],
                                   rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(got["P"], P.grad[r], rtol=1e-12,
                                   atol=1e-12)


def test_train_steps_refuse_these_families_over_a_model_axis(served):
    for mesh, ranks in served[0].items():
        for case in child.CASES:
            msg = ranks[0]["cases"][case]["train_refused"]
            assert msg is not None and "item 8c, part 3" in msg, (mesh, case)


@pytest.mark.parametrize("mesh", list(child.MESHES))
def test_decode_refuses_a_split_ring_without_its_capacity(served, mesh):
    """RecurrentGemma's one KV head is split over its ring's rows on every
    mesh: a decode step refuses the cache without the prefill's
    ``cache_len``, and with one that gives a shorter ring."""
    for rank in served[0][mesh]:
        missing, shorter = rank["cases"]["recurrentgemma"]["decode_refused"]
        assert missing is not None and "cache_len" in missing, missing
        assert shorter is not None and "K/V rows" in shorter, shorter


# ---------------------------------------------------------------------------
# K5's rank-partial plain version and its merge
# ---------------------------------------------------------------------------

def _ring_case(seed: int, B=3, H=6, Hkv=2, Wc=16, dh=32):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((B, H, dh), generator=g)
    k = torch.randn((B, Hkv, Wc, dh), generator=g)
    v = torch.randn((B, Hkv, Wc, dh), generator=g)
    return q, k, v


# lengths of the whole ring: full (a wrapped ring: every row valid), a
# ring filled into its first block only (empty later blocks), inside the
# last block, a request of length 1
_LENGTHS = {"wrapped": [16, 16, 16], "first_block_only": [3, 4, 2],
            "ragged": [13, 9, 1]}


@pytest.mark.parametrize("lengths", list(_LENGTHS))
@pytest.mark.parametrize("n", [1, 2, 4])
def test_rank_partial_decode_and_merge_equal_the_whole(n, lengths):
    q, k, v = _ring_case(n)
    L = torch.tensor(_LENGTHS[lengths], dtype=torch.int32)
    Wb = k.shape[2] // n
    parts = []
    for r in range(n):
        blk = slice(r * Wb, (r + 1) * Wb)
        Lr = torch.clamp(L - r * Wb, 0, Wb).to(torch.int32)
        parts.append(attn_decode_partial_ref(q, k[:, :, blk].contiguous(),
                                             v[:, :, blk].contiguous(), Lr))
    acc, m, l = (torch.stack(t) for t in zip(*parts))
    if lengths == "first_block_only" and n > 1:
        assert bool((m[1:] == -torch.inf).all()) and \
            bool((l[1:] == 0).all()) and bool((acc[1:] == 0).all())
    got = attn_decode_merge_ref(acc, m, l)
    want = attn_decode_ref(q, k, v, L)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    jwant = jax_attn_decode_ref(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                                jnp.asarray(v.numpy()), jnp.asarray(L.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_rank_partial_merge_of_empty_requests_is_nan(n):
    """A request with no valid row in any block: 0 / 0, as the whole
    decode gives a request of length 0; the other requests are exact."""
    q, k, v = _ring_case(20 + n)
    L = torch.tensor([0, 16, 5], dtype=torch.int32)
    Wb = k.shape[2] // n
    parts = [attn_decode_partial_ref(
        q, k[:, :, r * Wb:(r + 1) * Wb], v[:, :, r * Wb:(r + 1) * Wb],
        torch.clamp(L - r * Wb, 0, Wb)) for r in range(n)]
    got = attn_decode_merge_ref(*(torch.stack(t) for t in zip(*parts)))
    want = attn_decode_ref(q, k, v, L)
    assert bool(torch.isnan(got[0]).all()) and bool(torch.isnan(want[0]).all())
    torch.testing.assert_close(got[1:], want[1:], rtol=1e-5, atol=1e-6)


def test_rank_partial_merge_casts_to_the_output_dtype():
    """bf16 inputs: the triple is float32; the merge's output takes the
    requested dtype, as the whole decode returns q's."""
    q, k, v = (t.to(torch.bfloat16) for t in _ring_case(7))
    L = torch.tensor([16, 10, 3], dtype=torch.int32)
    acc, m, l = attn_decode_partial_ref(q, k, v, L)
    assert acc.dtype == m.dtype == l.dtype == torch.float32
    got = attn_decode_merge_ref(acc[None], m[None], l[None], torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want = attn_decode_ref(q, k, v, L)
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -8,
                               atol=2 ** -8)
