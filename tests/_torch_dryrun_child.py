"""The multi-process side of ``tests/test_torch_dryrun.py``: one gloo rank
running a reduced step of the port's model stack on the CPU with a
counting communicator, whose record the test holds against the dry run's
trace of the same step on a fake process group. Imports neither JAX nor
the JAX package.

:func:`main` is the spawned rank (the pattern of
``tests/_torch_model_mesh_child.py``): it joins the gloo group on
``localhost``, builds its mesh, runs its case and saves the collectives it
made (or its traceback) under ``out``.
"""
import sys
import traceback
from pathlib import Path

import torch

from repro_torch.configs import InputShape, get_config, reduced
from repro_torch.data import SyntheticLMData
from repro_torch.distributed.comm import CountingComm
from repro_torch.distributed.server import (make_decode_step,
                                            make_prefill_step, rank_rows)
from repro_torch.distributed.sharding import RankMesh, param_specs
from repro_torch.distributed.trainer import TrainConfig, make_train_step
from repro_torch.models import model as M
from repro_torch.optim import adamw_init

#: case -> (mesh shape, dimension names)
MESHES = {"fsdp_data2": ((2,), ("data",)),
          "serve_model2": ((1, 2), ("data", "model"))}
#: the cases' shapes: a train step (S, B) and a serve's prefill (S, B)
TRAIN = InputShape("train_tiny", 32, 4, "train")
SERVE = InputShape("serve_tiny", 16, 2, "prefill")


def cfg():
    """Reduced Qwen3-8B: the dense decoder with qk-norm."""
    return reduced(get_config("qwen3_8b"))


def record(calls) -> list:
    """(kind, axes, group size, bytes) of each call."""
    return [(k, tuple(a), n, b) for k, a, n, b, _ in calls]


def run_case(name: str, rm: RankMesh) -> list:
    c = cfg()
    cc = CountingComm(rm)
    if name == "fsdp_data2":
        specs = param_specs(M.param_shapes(c), c, rm, fsdp=True)
        params = M.init_local_params(0, c, specs, rm, "cpu")
        opt = adamw_init(params)
        data = SyntheticLMData(c.vocab, TRAIN.seq_len, TRAIN.global_batch)
        step = make_train_step(TrainConfig(arch=c, fsdp=True), mesh=rm,
                               comm=cc)
        step(params, opt, data.batch(0, "cpu"))
        return record(cc.calls)
    params = M.init_local_params(0, c, param_specs(M.param_shapes(c), c, rm),
                                 rm, "cpu")
    g = torch.Generator().manual_seed(0)
    prompts = torch.randint(0, c.vocab, (SERVE.global_batch, SERVE.seq_len),
                            generator=g)
    prefill = make_prefill_step(c, mesh=rm, comm=cc)
    decode = make_decode_step(c, cache_len=SERVE.seq_len, mesh=rm, comm=cc)
    with torch.inference_mode():
        logits, cache = prefill(params, {"tokens": rank_rows(prompts, rm)})
        decode(params, cache, logits[:, -1].argmax(-1)[:, None])
    return record(cc.calls)


def main(name: str, rank: int, world: int, port: int, out: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    path = Path(out) / f"{name}_{rank}"
    try:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=world)
        shape, dims = MESHES[name]
        rm = RankMesh(init_device_mesh("cpu", shape, mesh_dim_names=dims))
        calls = run_case(name, rm)
        dist.barrier()
        dist.destroy_process_group()
        loaded = sorted(k for k in sys.modules
                        if k.split(".")[0] in ("jax", "jaxlib", "repro"))
        torch.save({"calls": calls, "loaded": loaded}, f"{path}.pt")
    except BaseException:
        Path(f"{path}.err").write_text(traceback.format_exc())
        raise
