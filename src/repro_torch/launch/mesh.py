"""Host mesh construction.

The port of ``repro.launch.mesh.make_host_mesh`` on ``torch.distributed``:
a function, not a module-level constant, so importing this module touches
no process group. ``make_production_mesh`` (the reference's TPU v5e pod)
is not ported.
"""
from __future__ import annotations

__all__ = ["make_host_mesh"]


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
