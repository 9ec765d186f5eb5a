"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the reference's (``repro.distributed.sharding``), for every architecture
at its published size, on three stand-in meshes.

Both sides take the same stand-in mesh object (``axis_names`` and a
``shape`` mapping: all the rules read). The reference's trees are
``jax.eval_shape`` of its ``init_params`` / ``init_cache``; the port's are
meta tensors (``model.param_shapes``), so nothing is allocated at any
size. A reference ``PartitionSpec`` is compared as ``tuple(spec)``.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (caps torch threads under xdist)

import repro.distributed.server as jsrv
import repro.distributed.sharding as js
import repro.models.model as jm
from repro.configs import get_config as jget
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed import server as tsrv
from repro_torch.distributed import sharding as ts
from repro_torch.models import model as tm

MESHES = {
    "data2_model4": SimpleNamespace(axis_names=("data", "model"),
                                    shape={"data": 2, "model": 4}),
    "data1_model16": SimpleNamespace(axis_names=("data", "model"),
                                     shape={"data": 1, "model": 16}),
    "pod2_data2_model2": SimpleNamespace(
        axis_names=("pod", "data", "model"),
        shape={"pod": 2, "data": 2, "model": 2}),
}
CACHE_B, CACHE_LEN = 4, 64


def _ref_tree(tree):
    """A reference spec tree as nested dicts/lists of tuples."""
    from jax.sharding import PartitionSpec as P
    return jax.tree_util.tree_map(tuple, tree,
                                  is_leaf=lambda x: isinstance(x, P))


def _stack(tree):
    """A port shape tree with a leading worker axis of 4 (meta)."""
    return tm._tmap(lambda a: a.new_empty((4,) + tuple(a.shape)), tree)


_SHAPES = {}


def _shapes(arch):
    """(reference param shapes, port param shapes), once per arch."""
    if arch not in _SHAPES:
        jcfg = jget(arch)
        ref = jax.eval_shape(lambda: jm.init_params(jax.random.PRNGKey(0),
                                                    jcfg))
        _SHAPES[arch] = (ref, tm.param_shapes(get_config(arch)))
    return _SHAPES[arch]


def test_param_shapes_are_the_references():
    for arch in ARCH_IDS:
        ref, port = _shapes(arch)
        want = jax.tree_util.tree_map(lambda a: (tuple(a.shape),
                                                 str(a.dtype)), ref)
        got = tm._tmap(lambda a: (tuple(a.shape),
                                  str(a.dtype).replace("torch.", "")), port)
        assert got == want, arch
        assert all(a.device.type == "meta"
                   for a in jax.tree_util.tree_leaves(
                       tm._tmap(lambda a: a, port)))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("fsdp", [False, True])
def test_param_specs_equal_the_references(mesh, fsdp):
    m = MESHES[mesh]
    for arch in ARCH_IDS:
        ref, port = _shapes(arch)
        jcfg, cfg = jget(arch), get_config(arch)
        want = _ref_tree(js.param_specs(ref, jcfg, m, fsdp=fsdp))
        assert ts.param_specs(port, cfg, m, fsdp=fsdp) == want, arch
        # the decentralized layout: stacked copies over (pod, data)
        refw = jax.tree_util.tree_map(
            lambda a: jax.ShapeDtypeStruct((4,) + a.shape, a.dtype), ref)
        want = _ref_tree(js.param_specs(refw, jcfg, m, fsdp=fsdp,
                                        worker_axis=True))
        got = ts.param_specs(_stack(port), cfg, m, fsdp=fsdp,
                             worker_axis=True)
        assert got == want, arch
        assert ts.opt_state_specs(got) == _ref_tree(
            js.opt_state_specs(js.param_specs(refw, jcfg, m, fsdp=fsdp,
                                              worker_axis=True))), arch


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_and_cache_specs_equal_the_references(mesh):
    m = MESHES[mesh]
    assert ts.batch_specs(m) == tuple(js.batch_specs(m))
    assert ts.batch_axes(m) == js.batch_axes(m)
    for arch in ARCH_IDS:
        jcfg, cfg = jget(arch), get_config(arch)
        ref_p, port_p = _shapes(arch)
        enc_ref = (jax.ShapeDtypeStruct((CACHE_B, jcfg.n_frames,
                                         jcfg.d_model), jnp.float32)
                   if jcfg.encoder_layers else None)
        ref_c = jax.eval_shape(
            lambda p, e: jm.init_cache(p, jcfg, CACHE_B, CACHE_LEN, e),
            ref_p, enc_ref)
        enc = (torch.empty((CACHE_B, cfg.n_frames, cfg.d_model),
                           device="meta") if cfg.encoder_layers else None)
        port_c = tm.init_cache(port_p, cfg, CACHE_B, CACHE_LEN, enc)
        want = _ref_tree(js.cache_specs(ref_c, jcfg, m))
        assert ts.cache_specs(port_c, cfg, m) == want, arch
        # serve_shardings: the same parameter and cache specs, the token's
        got = tsrv.serve_shardings(cfg, m, port_p, port_c)
        ref = jsrv.serve_shardings(jcfg, m, ref_p, ref_c)
        assert got[0] == _ref_tree(ref[0]) and got[1] == want, arch
        assert got[2] == tuple(ref[2]), arch


@pytest.mark.parametrize("shape", [(12, 10), (7, 3), (5,), (4, 6, 8)])
def test_fit_spec_equals_the_references(shape):
    from jax.sharding import PartitionSpec as P
    m = MESHES["pod2_data2_model2"]
    for spec in [("model", None), (("pod", "data"), "model"),
                 ("data", "model", None), (None, ("data", "model")),
                 ("pod", None, "model", "data")]:
        assert ts.fit_spec(spec, shape, m) == \
            tuple(js.fit_spec(P(*spec), shape, m))


def test_local_blocks_tile_the_leaf():
    """``local_block`` over every coordinate of a (pod 2, data 2, model 2)
    stand-in reassembles the leaf, for a spec of two split dimensions."""
    x = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    spec = (("pod", "data"), "model")
    blocks = {}
    for p in range(2):
        for d in range(2):
            for mo in range(2):
                rm = SimpleNamespace(shape={"pod": 2, "data": 2, "model": 2},
                                     coords={"pod": p, "data": d,
                                             "model": mo})
                rm.size = lambda *a, rm=rm: int(np.prod(
                    [rm.shape[x] for x in a if x in rm.shape]))
                rm.index = lambda *a, rm=rm: int(np.ravel_multi_index(
                    [rm.coords[x] for x in a], [rm.shape[x] for x in a])) \
                    if a else 0
                blocks[(p * 2 + d, mo)] = ts.local_block(x, spec, rm)
    rows = [torch.cat([blocks[(r, mo)] for mo in range(2)], 1)
            for r in range(4)]
    assert torch.equal(torch.cat(rows, 0), x)
