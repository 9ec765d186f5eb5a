"""The rank communicator: the collectives of the model stack over a
:class:`~repro_torch.distributed.sharding.RankMesh`, each named by the
mesh dimensions it runs over, as the reference's ``psum``, ``all_gather``,
``all_to_all`` and ``ppermute`` name theirs.

NCCL takes CUDA tensors for everything. gloo, which is how several ranks
share one card (NCCL refuses two ranks on one GPU) and how the ranks run
on the CPU, takes CUDA tensors for its collectives but not for a
point-to-point send (:data:`GLOO_CUDA_HOST_STAGED`). So where a group's
backend is gloo and the tensors live on the card, :meth:`Comm.send_recv`
copies them to host memory, exchanges them there and copies the result
back. That path is explicit: it is chosen by the backend and the device,
never as a fallback on an error, and each use adds to ``staged_calls`` and
``staged_bytes`` (the bytes of the tensors it hands to host memory),
which the launchers and ``chip_smoke.py`` print. Kernels still run on
the card.
"""
from __future__ import annotations

import torch

from ..core.pushsum import collective

__all__ = ["GLOO_CUDA_HOST_STAGED", "Comm"]

#: The operations gloo refuses on CUDA tensors: torch 2.11's gloo takes
#: CUDA tensors for ``all_reduce``, ``all_gather``, ``all_to_all`` and
#: ``reduce_scatter`` (float32 and bf16: FSDP's backward) but
#: hands a device pointer to ``writev`` for a point-to-point send (EFAULT,
#: "Bad address"). ``chip_smoke.py``'s phase 24 probes every operation on
#: the card and requires the probe's refusals to be this set;
#: :meth:`Comm.send_recv` stages through host memory.
GLOO_CUDA_HOST_STAGED = frozenset({"send_recv"})


class Comm:
    """Collectives over the groups of ``mesh`` (a ``RankMesh``), with the
    counters of what gloo staged through host memory."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.staged_calls = 0
        self.staged_bytes = 0

    def all_reduce(self, x: torch.Tensor, axes,
                   op: str = "sum") -> torch.Tensor:
        """The sum (or ``op="max"``) over the ranks of ``axes``, in place;
        returns ``x``."""
        import torch.distributed as dist
        axes = _axes(axes)
        group = self.mesh.group(*axes)
        rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        dist.all_reduce(x, op=rop, group=group)
        return x

    def all_gather(self, x: torch.Tensor, axes) -> torch.Tensor:
        """-> (n, *x.shape): every rank's ``x``, in the row-major order of
        ``axes`` (rank i's at row i)."""
        axes = _axes(axes)
        n = self.mesh.size(*axes)
        x = x.contiguous()
        out = x.new_empty((n * x.numel(),))     # gloo: a flat output
        collective("all_gather")(out, x.reshape(-1),
                                 group=self.mesh.group(*axes))
        return out.view((n,) + tuple(x.shape))

    def reduce_scatter(self, x: torch.Tensor, axes) -> torch.Tensor:
        """x (n * m, ...) -> (m, ...): the sum over the ranks of ``axes``
        of their ``x``, rank i keeping rows ``[i m, (i + 1) m)`` (the
        row-major order of ``axes``, as :meth:`all_gather` orders them)."""
        axes = _axes(axes)
        n = self.mesh.size(*axes)
        if x.shape[0] % n:
            raise ValueError(f"reduce_scatter over {n} ranks needs rows in "
                             f"a multiple of {n}, got {tuple(x.shape)}")
        x = x.contiguous()
        out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
        collective("reduce_scatter")(out.view(-1), x.view(-1),
                                     group=self.mesh.group(*axes))
        return out

    def all_to_all(self, x: torch.Tensor, axes) -> torch.Tensor:
        """x (n, ...) -> (n, ...): row i goes to rank i of ``axes``; row j
        of the result came from rank j (the reference's untiled
        ``all_to_all`` over the flattened axes)."""
        import torch.distributed as dist
        axes = _axes(axes)
        n = self.mesh.size(*axes)
        if x.shape[0] != n:
            raise ValueError(f"all_to_all over {n} ranks needs {n} rows, "
                             f"got {tuple(x.shape)}")
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.mesh.group(*axes))
        return out

    def send_recv(self, x: torch.Tensor | None, to: int | None,
                  frm: int | None, axes, like: torch.Tensor
                  ) -> torch.Tensor | None:
        """One exchange on ``axes``' group (a ``ppermute`` step): send
        ``x`` to group rank ``to`` (none if ``to`` is None) and receive a
        tensor shaped like ``like`` from group rank ``frm`` (none if
        ``frm`` is None) -> the received tensor or None."""
        import torch.distributed as dist
        axes = _axes(axes)
        group = self.mesh.group(*axes)
        tensors = ([x] if to is not None else []) + \
            ([like] if frm is not None else [])
        if not tensors:
            return None
        staged = any(t.is_cuda for t in tensors) and \
            dist.get_backend(group) == "gloo"
        if staged:
            self.staged_calls += 1
            self.staged_bytes += sum(t.numel() * t.element_size()
                                     for t in tensors)
        ops, recv = [], None
        if to is not None:
            src = x.contiguous()
            src = src.cpu() if staged else src
            ops.append(dist.P2POp(dist.isend, src,
                                  dist.get_global_rank(group, to), group))
        if frm is not None:
            recv = torch.empty(like.shape, dtype=like.dtype,
                               device="cpu" if staged else like.device)
            ops.append(dist.P2POp(dist.irecv, recv,
                                  dist.get_global_rank(group, frm), group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if recv is not None and staged:
            recv = recv.to(like.device)
        return recv


def _axes(axes) -> tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)
