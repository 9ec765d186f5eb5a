"""Mesh construction.

The port of ``repro.launch.mesh`` on ``torch.distributed``: functions, not
module-level constants, so importing this module touches no process
group.

``make_host_mesh`` spans the ranks of a real process group.
``make_production_mesh`` builds the reference's production shapes, 16 x 16
over ("data", "model") or 2 x 16 x 16 over ("pod", "data", "model") (256
or 512 cards), on torch's ``"fake"`` process-group backend: one process
plays rank 0, its collectives return at once and move nothing. It exists
for the dry run (:mod:`repro_torch.launch.dryrun`), which traces rank 0's
step on fake tensors; :func:`fake_mesh` creates the group for a block and
destroys it again.
"""
from __future__ import annotations

import contextlib
import math
from typing import Iterator

__all__ = ["make_host_mesh", "make_production_mesh", "fake_mesh",
           "PRODUCTION_SHAPES"]

#: The reference's production meshes: (shape, dimension names).
PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_host_mesh(model_parallel: int | None = None, *,
                   device_type: str = "cuda"):
    """A ``("data", "model")`` mesh over every rank of the default process
    group: ``(world // model_parallel, model_parallel)``. Call it on every
    rank after ``torch.distributed.init_process_group``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs "
                           "torch.distributed.init_process_group first")
    n = dist.get_world_size()
    mp = model_parallel or 1
    if n % mp:
        raise ValueError(f"{n} ranks do not split into model_parallel={mp}")
    return init_device_mesh(device_type, (n // mp, mp),
                            mesh_dim_names=("data", "model"))


def make_production_mesh(*, multi_pod: bool = False):
    """Rank 0's :class:`~repro_torch.distributed.sharding.RankMesh` of the
    reference's production mesh (16 x 16, or 2 x 16 x 16 with
    ``multi_pod``) on a fake process group of 256 or 512 ranks, the device
    mesh on ``"cpu"`` (a ``"cuda"`` mesh needs a card). Only for a dry
    run: it starts the default process group, and refuses where one
    exists; ``fake_mesh(*PRODUCTION_SHAPES[multi_pod])`` also destroys
    it."""
    return _fake_rank_mesh(*PRODUCTION_SHAPES[bool(multi_pod)])


def _fake_rank_mesh(shape: tuple, names: tuple):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from ..distributed.sharding import RankMesh

    if dist.is_initialized():
        raise RuntimeError("a dry run starts a fake process group of its "
                           "own; one exists already")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        return RankMesh(init_device_mesh("cpu", shape, mesh_dim_names=names))
    except BaseException:
        dist.destroy_process_group()
        raise


@contextlib.contextmanager
def fake_mesh(shape: tuple, names: tuple) -> Iterator:
    """Rank 0's ``RankMesh`` of a ``shape`` mesh over ``names`` on a fake
    process group for the block, destroyed on leaving it, so none is left
    behind (refused where a group exists)."""
    import torch.distributed as dist

    rm = _fake_rank_mesh(tuple(shape), tuple(names))
    try:
        yield rm
    finally:
        dist.destroy_process_group()
