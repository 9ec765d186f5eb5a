"""The port's sweep engines over ``torch.distributed`` device meshes on the
CPU: gloo ranks in spawned processes (``tests/_torch_mesh_child.py``),
held against the one-process runs of the same cases.

Three meshes run once for the module, at the same time: (graph 2), (data
2 x graph 2) and (data 4), 10 ranks. Each rank returns the full result,
so every rank's rows are checked.

* The graph axis (a rank a shard, its partials combined by gloo's
  ``all_reduce``, or ``reduce_scatter`` and ``all_gather``) against the
  emulated axis (both shards in one process, one K1 launch): bit-equal,
  since with two shards every receiver's sum has at most two non-zero
  operands and their sum does not depend on the order. That covers the
  push-sum sweep (psum, scatter, bf16 scatter, the fault plane), the
  windows of the link mask and the fault uniforms (also against the
  reference's draw sliced), and the Algorithm 3 and Algorithm 1 loops.
  The sweeps' mass gaps sum per-shard partial sums, so they are bit-equal
  too.
* The data axis (K rows padded to a multiple of the extent, a block a
  rank, all-gathered) against the unsplit grids: bit-equal, as each
  grid's rows are to its single runs (``tests/test_torch_sweeps.py``,
  ``tests/test_torch_byz_sweeps.py``): a scenario's arithmetic does not
  depend on the other scenarios of its block.
* The halo bytes each rank counts are the model's,
  ``analysis.pushsum_halo_wire_bytes``, every round.
* No rank loads ``jax`` or ``repro``.
"""
import multiprocessing as mp
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (caps torch threads under xdist)

import repro.core.pushsum as jp
import _torch_mesh_child as child
from repro_torch.analysis.roofline import pushsum_halo_wire_bytes
from repro_torch.core import graphs as tg

pytestmark = pytest.mark.multidevice

WORLD = {"graph2": 2, "data2_graph2": 4, "data4": 4}
TIMEOUT = 240    # seconds for all three meshes


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """Launch the three meshes (spawned gloo ranks), wait for them, and
    load every rank's results -> {case: [rank results]}."""
    out = tmp_path_factory.mktemp("meshes")
    ctx = mp.get_context("spawn")
    procs = []
    for name, world in WORLD.items():
        port = _free_port()
        procs += [ctx.Process(target=child.main,
                              args=(name, r, world, port, str(out)))
                  for r in range(world)]
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
    assert not hung, f"{len(hung)} ranks did not finish in {TIMEOUT} s"
    assert all(p.exitcode == 0 for p in procs)
    return {name: [torch.load(out / f"{name}_{r}.pt") for r in range(world)]
            for name, world in WORLD.items()}


@pytest.fixture(scope="module")
def one_process():
    """Each case's rows in this process: the emulated graph axis and the
    unsplit grids."""
    return {name: child.run_case(name) for name in WORLD}


@pytest.mark.parametrize("name", sorted(WORLD))
def test_ranks_load_no_jax_and_sit_on_the_mesh(meshes, name):
    shape, _ = child.MESHES[name]
    coords = set()
    for got in meshes[name]:
        assert got["loaded"] == []
        coords.add(tuple(got["rows"]["coordinate"].tolist()))
    assert len(coords) == WORLD[name] == int(np.prod(shape))


@pytest.mark.parametrize("name", sorted(WORLD))
def test_every_rank_returns_the_one_process_rows(meshes, one_process, name):
    want = one_process[name]
    for rank, got in enumerate(meshes[name]):
        rows = got["rows"]
        for key, value in want.items():
            if key.startswith(("mask_window", "uniform_window")):
                continue
            assert key in rows, key
            assert rows[key].dtype == value.dtype, key
            assert torch.equal(rows[key], value), (rank, key)


def test_graph_axis_windows_are_slices_of_the_padded_draw(meshes):
    """Rank s holds shard s's slots of the E_pad draw: the reference's
    link mask and uniforms sliced."""
    el, _ = child._pushsum_inputs()
    sh = tg.partition_edge_list(el, 2)
    e, E = sh.e_shard, sh.e_pad
    mask = np.asarray(jp.step_edge_mask(jax.random.PRNGKey(5),
                                        jnp.uint32(3), E, 0.3, 3))
    unif = np.asarray(jax.random.uniform(
        jax.random.fold_in(jax.random.PRNGKey(5), 7), (E,)))
    for got in meshes["graph2"]:
        s = int(got["rows"]["coordinate"][1])
        np.testing.assert_array_equal(got["rows"]["mask_window"].numpy(),
                                      mask[s * e:(s + 1) * e])
        np.testing.assert_array_equal(got["rows"]["uniform_window"].numpy(),
                                      unif[s * e:(s + 1) * e])


@pytest.mark.parametrize("halo,sb", [("psum", 4), ("scatter", 4),
                                     ("scatter_bf16", 2)])
def test_halo_bytes_are_the_model(meshes, halo, sb):
    """4 scenarios of N = 60 over 2 shards, T rounds: the bytes each rank
    counts are T times the model's at N = 4 x 60."""
    variant = halo.split("_")[0]
    want = child.T * pushsum_halo_wire_bytes(4 * 60, 2, 2, variant=variant,
                                             storage_bytes=sb)
    for got in meshes["graph2"]:
        assert float(got["rows"][f"sweep_{halo}_wire_bytes"]) == \
            pytest.approx(want, rel=1e-12)


def test_the_one_process_cases_are_not_degenerate(one_process):
    """The one-process rows themselves: the sweep rows are not all equal
    between the psum and the bf16 scatter combine, and the data cases
    hold K rows that are not a multiple of 4 (padded on the mesh)."""
    g = one_process["graph2"]
    assert not torch.equal(g["sweep_psum_final_ratio"],
                           g["sweep_scatter_bf16_final_ratio"])
    d = one_process["data4"]
    assert d["pushsum_err"].shape[0] == 6 and d["social_seed"].shape[0] == 10
    assert d["byz_decisions"].shape[0] == 6 and d["hps_fault"].shape[0] == 36


@pytest.mark.parametrize("name", sorted(WORLD))
def test_mesh_shape_errors(meshes, name):
    """Mesh shapes the runs refuse, and ``make_host_mesh``'s
    (world / model_parallel, model_parallel) layout."""
    for got in meshes[name]:
        msgs = got["errors"]
        assert got["rows"]["host_mesh"].tolist() == [WORLD[name] // 2, 2]
        assert "do not split into model_parallel=3" in msgs["host3"]
        if name == "data4":
            assert "has no dimension 'graph'" in msgs["graph3"]
        else:
            assert "has 2 devices but the edge list is cut into 3" in \
                msgs["graph3"]
        assert "has no dimension 'model'" in msgs["model2"]


def test_sweep_specs_are_the_references():
    """The port's table of which mesh dimensions split each argument role
    is the reference's PartitionSpecs as dimension tuples."""
    import repro.distributed.sharding as jsh
    from repro_torch.distributed.sharding import sweep_specs
    for axes in (("data", "graph"), ("rows", "cuts")):
        assert sweep_specs(*axes) == {
            k: tuple(v) for k, v in jsh.sweep_specs(*axes).items()}


def test_a_mesh_of_another_device_type_raises():
    from repro_torch.core.plan import ExecutionPlan
    from repro_torch.core import sweeps as ts

    class CudaMesh:
        device_type = "cuda"
        mesh_dim_names = ("data", "graph")

    el, w = child._pushsum_inputs()
    with pytest.raises(ValueError, match="device type 'cuda' is not"):
        ts.run_pushsum_sweep(w, el, 2, plan=ExecutionPlan(mesh=CudaMesh()),
                             device="cpu")
