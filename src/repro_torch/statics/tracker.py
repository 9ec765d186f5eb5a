"""The step tracker: a ``TorchDispatchMode`` beside the op recorder
(:mod:`~repro_torch.statics.walk`) that follows what a step does to the
memory of its device, op by op, on real or fake tensors.

* **Live bytes.** Every storage an op creates counts from its first
  output until the storage dies (a weak reference on it; autograd's saved
  tensors keep theirs alive as they keep the card's), each rounded up to
  the caching allocator's 512 bytes; a ``meta`` tensor holds none; a
  step's arguments count when they are made under it. ``peak`` is the
  high-water mark: the dry run's per-device peak, held against
  ``torch.cuda.max_memory_allocated`` on the card by ``chip_smoke.py``.
  Allocations inside one op (a library kernel's workspace) are not seen;
  a kernel of the port allocates its outputs and workspace with
  ``torch.empty``, which is.
* **Bytes accessed.** Every op's tensor inputs and outputs, as eager
  PyTorch reads and writes them (a view, a query such as ``x.device``, a
  fresh ``empty`` and a copy's destination read nothing), plus the port's
  kernels' bytes.
* **FLOPs.** ``torch.utils.flop_counter.FlopCounterMode`` over the
  library ops (matmuls, attention, convolutions), plus the port's
  kernels' operations (:mod:`repro_torch.kernels.costs`).
* **Kernels.** Each launch a shape rule answers for, by wrapper: launches,
  operations, bytes.

On fake tensors an op whose output size depends on the values has none.
The tracker answers three: ``aten.bincount`` with ``minlength`` bins,
which is the model's use (the MoE counts the expert ids ``< E`` of its
routes with ``minlength=E``); ``aten.nonzero``, and indexing with a
boolean mask (the MoE's kept assignments), with every element selected:
the most the shape allows, an upper bound of those temporaries.
"""
from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from ..kernels.costs import KernelCost
from ..kernels.dispatch import is_fake, recording

__all__ = ["StepTracker", "ALLOC_ROUND"]

ALLOC_ROUND = 512       # the CUDA caching allocator's rounding, bytes

_aten = torch.ops.aten
_NO_READ = {_aten.empty.memory_format, _aten.empty_strided.default,
            _aten.empty_like.default, _aten.new_empty.default,
            _aten.new_empty_strided.default}
_WRITE_ONLY = {_aten.zero_.default, _aten.fill_.Scalar, _aten.fill_.Tensor}


_INDEXING = {_aten.index.Tensor, _aten.index_put.default,
             _aten.index_put_.default, _aten._index_put_impl_.default}


def _has_fake_mask(indices) -> bool:
    return any(ix is not None and ix.dtype == torch.bool and is_fake(ix)
               for ix in indices)


def _all_selected(indices) -> list:
    """Boolean masks as the integer indices of every element (a mask of k
    dimensions is k index tensors)."""
    out = []
    for ix in indices:
        if ix is not None and ix.dtype == torch.bool:
            out += [torch.zeros(ix.numel(), dtype=torch.int64,
                                device=ix.device)] * ix.dim()
        else:
            out.append(ix)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class StepTracker(TorchDispatchMode):
    """Enter it (``with StepTracker() as st:``) around the code to follow;
    read ``peak``, ``live``, :meth:`counters` and ``kernels`` after."""

    def __init__(self, count_flops: bool = True):
        super().__init__()
        self.live = 0
        self.peak = 0
        self.accessed = 0.0
        self.kernels: dict[str, dict[str, float]] = {}
        self._sizes: dict[int, int] = {}
        self._flops = FlopCounterMode(display=False) if count_flops \
            else None
        self._sink = None

    # -- live storages ---------------------------------------------------
    def _alloc(self, t: torch.Tensor) -> None:
        if t.device.type == "meta":           # shapes only, no memory
            return
        st = t.untyped_storage()
        key = id(st)
        if key in self._sizes:
            return
        n = -(-st.nbytes() // ALLOC_ROUND) * ALLOC_ROUND
        self._sizes[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key)

    # -- counts ----------------------------------------------------------
    def _kernel(self, cost: KernelCost) -> None:
        k = self.kernels.setdefault(cost.kernel, {
            "launches": 0, "flops": 0.0, "fp32_ops": 0.0, "bytes": 0.0})
        k["launches"] += 1
        k["flops"] += cost.flops
        k["fp32_ops"] += cost.fp32_ops
        k["bytes"] += cost.bytes
        self.accessed += cost.bytes

    def counters(self) -> dict:
        """The additive counts so far: ``flops`` (library ops and
        kernels), ``bytes``, and each kernel's ``launches``, ``flops``,
        ``fp32_ops`` and ``bytes`` as ``kernel/<name>/<count>``."""
        kflops = sum(k["flops"] + k["fp32_ops"] for k in self.kernels.values())
        lib = 0.0 if self._flops is None else \
            float(self._flops.get_total_flops())
        out = {"flops": lib + kflops,
               "bytes": self.accessed}
        for name, k in self.kernels.items():
            for what, v in k.items():
                out[f"kernel/{name}/{what}"] = v
        return out

    # -- the mode ----------------------------------------------------------
    def __enter__(self):
        if self._flops is not None:
            self._flops.__enter__()
        self._sink = recording(self._kernel)
        self._sink.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._sink.__exit__(*exc)
        if self._flops is not None:
            self._flops.__exit__(*exc)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is _aten.bincount.default and is_fake(args[0]):
            minlength = kwargs.get("minlength", args[2] if len(args) > 2
                                   else 0)
            out = torch.zeros(minlength, dtype=torch.int64,
                              device=args[0].device)
        elif func is _aten.nonzero.default and is_fake(args[0]):
            x = args[0]
            out = torch.zeros((x.numel(), x.dim()), dtype=torch.int64,
                              device=x.device)
        elif func in _INDEXING and _has_fake_mask(args[1]):
            out = func(args[0], _all_selected(args[1]), *args[2:], **kwargs)
        else:
            out = func(*args, **kwargs)
        outs = _tensors(out)
        for t in outs:
            self._alloc(t)
        if not outs or getattr(func, "is_view", False) or func in (
                _aten.detach.default, _aten.alias.default):
            return out          # a query (``x.device``) or a view
        ins = _tensors((args, kwargs))
        if func in _NO_READ:
            moved = 0
        elif func in _WRITE_ONLY:
            moved = sum(_nbytes(t) for t in outs)
        elif func is _aten.copy_.default:
            moved = 2 * _nbytes(args[0])
        else:
            moved = sum(_nbytes(t) for t in ins) + \
                sum(_nbytes(t) for t in outs)
        self.accessed += moved
        return out
