"""Carry state across from the JAX package's arrays into the port.

The engines have no weights: their "parameters" are the signal tables, the
topology and scenario scalars, and the push-sum state. Each function takes
numpy arrays (``np.asarray`` of the reference's values) and builds the
port's counterpart on the CPU; ``.to(device)`` or the entry points move it
to the card. The model stack's parameter tree comes across whole with
:func:`params_from_jax`, a robust trainer's stacked parameters and AdamW
state with :func:`train_state_from_jax`, and any such tree goes back as
numpy with :func:`tree_to_numpy`. The engines' way back is ``.to_numpy()`` on
:class:`~repro_torch.core.pushsum.SparsePushSumState`,
:class:`~repro_torch.core.social.SocialLearningResult` and
:class:`~repro_torch.core.byzantine.ByzantineResult`.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.byzantine import ByzRuntime
from .core.graphs import EdgeList
from .core.hps import HPSRuntime, hps_runtime_from_edge_list
from .core.pushsum import PushSumState, SparsePushSumState
from .core.signals import SignalModel
from .core.social import SocialRuntime, social_runtime_from_edge_list

__all__ = ["signal_model_from_numpy", "social_runtime_from_numpy",
           "hps_runtime_from_numpy", "sparse_state_from_numpy",
           "dense_state_from_numpy", "byz_runtime_from_numpy",
           "params_from_jax", "train_state_from_jax", "tree_to_numpy"]


def signal_model_from_numpy(tables: np.ndarray, truth: int) -> SignalModel:
    """(N, m, S) likelihood tables and the true hypothesis."""
    return SignalModel(tables=torch.tensor(np.asarray(tables),
                                           dtype=torch.float32),
                       truth=int(truth))


def social_runtime_from_numpy(src, dst, valid, rep_mask, drop_prob, gamma,
                              B) -> SocialRuntime:
    """The fields of a reference ``SocialRuntime``, as numpy values."""
    rep_mask = np.asarray(rep_mask, bool)
    el = EdgeList(src=np.asarray(src, np.int32), dst=np.asarray(dst, np.int32),
                  n=rep_mask.shape[0], valid=np.asarray(valid, bool))
    return social_runtime_from_edge_list(
        el, rep_mask, drop_prob=float(drop_prob),
        gamma_period=int(gamma), B=int(B))


def hps_runtime_from_numpy(src, dst, valid, rep_mask, drop_prob, gamma, B,
                           M) -> HPSRuntime:
    """The eight leaves of a reference ``HPSRuntime``, as numpy values; the
    port's hoisted CSR offsets are computed from them."""
    rep_mask = np.asarray(rep_mask, bool)
    el = EdgeList(src=np.asarray(src, np.int32), dst=np.asarray(dst, np.int32),
                  n=rep_mask.shape[0], valid=np.asarray(valid, bool))
    return hps_runtime_from_edge_list(
        el, rep_mask, drop_prob=float(drop_prob), gamma_period=int(gamma),
        B=int(B), M=int(M))


def dense_state_from_numpy(z, m, sigma, sigma_m, rho, rho_m) -> PushSumState:
    """The six fields of a reference dense ``PushSumState``."""
    return PushSumState(*(torch.tensor(np.asarray(a), dtype=torch.float32)
                          for a in (z, m, sigma, sigma_m, rho, rho_m)))


def sparse_state_from_numpy(z, m, sigma, sigma_m, rho,
                            rho_m) -> SparsePushSumState:
    """The six fields of a reference ``SparsePushSumState``."""
    def cat(value, mass):
        return torch.from_numpy(np.concatenate(
            [np.asarray(value, np.float32),
             np.asarray(mass, np.float32)[:, None]], axis=1))

    return SparsePushSumState(zm=cat(z, m), sigma_zm=cat(sigma, sigma_m),
                              rho_zm=cat(rho, rho_m))


def byz_runtime_from_numpy(nbr_idx, nbr_valid, byz_mask, active, in_C,
                           offsets, sizes, F, gamma) -> ByzRuntime:
    """The nine leaves of a reference ``ByzRuntime``, as numpy values; the
    port's hoisted ``byz_nbr`` is gathered from them."""
    idx = np.asarray(nbr_idx, np.int32)
    byz = np.asarray(byz_mask, bool)
    return ByzRuntime(
        nbr_idx=torch.from_numpy(idx.copy()),
        nbr_valid=torch.from_numpy(np.asarray(nbr_valid, bool).copy()),
        byz_nbr=torch.from_numpy(byz[idx]),
        byz_mask=torch.from_numpy(byz.copy()),
        active=torch.from_numpy(np.asarray(active, bool).copy()),
        in_C=torch.from_numpy(np.asarray(in_C, bool).copy()),
        offsets=torch.from_numpy(np.asarray(offsets, np.int32).copy()),
        sizes=torch.from_numpy(np.asarray(sizes, np.int32).copy()),
        F=int(F),
        gamma=int(gamma),
    )


_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16, "int32": torch.int32}


def params_from_jax(tree, cfg, device=None):
    """The JAX package's model parameters (a pytree of dicts and lists
    whose leaves are numpy arrays, e.g. ``jax.tree.map(np.asarray,
    params)``) as the port's tree on ``device`` (``None``: the card), in
    either layout (stacked ``"groups"`` + ``"tail"``, or ``"layers"``).
    Each leaf keeps its dtype; a bfloat16 leaf (ml_dtypes) goes through
    float32, which is exact. ``cfg`` is checked against the tree's
    layout."""
    from .core.plan import resolve_device
    dev = resolve_device(device)
    want = "groups" if ("groups" in tree) else "layers"
    R = cfg.n_layers // len(cfg.block_pattern)
    if (cfg.scan_layers and R > 1) != (want == "groups"):
        raise ValueError(f"the tree has the {want!r} layout, which "
                         f"{cfg.name} (scan_layers={cfg.scan_layers}) does "
                         f"not use")

    def leaf(a):
        a = np.asarray(a)
        dtype = _TORCH_DTYPES[a.dtype.name]
        if a.dtype.name == "bfloat16":
            a = a.astype(np.float32)
        return torch.tensor(a, dtype=dtype, device=dev)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [walk(v) for v in t]
        return leaf(t)

    return walk(tree)


def train_state_from_jax(params_w, opt_w, cfg, device=None):
    """A robust trainer's state from the JAX package's numpy trees:
    stacked ``(W, ...)`` parameters (``replicate_for_workers``' layout) and
    the per-worker AdamW state ``{"m", "v", "step"}`` -> the port's
    ``(params_w, opt_w)`` on ``device`` (``None``: the card), each leaf in
    its own dtype."""
    from .core.plan import resolve_device
    dev = resolve_device(device)
    return (params_from_jax(params_w, cfg, dev),
            {"m": params_from_jax(opt_w["m"], cfg, dev),
             "v": params_from_jax(opt_w["v"], cfg, dev),
             "step": torch.tensor(np.asarray(opt_w["step"]),
                                  dtype=torch.int32, device=dev)})


def tree_to_numpy(tree):
    """A nested dict/list tree of tensors as numpy arrays on the host;
    bfloat16 leaves come back as float32, which is exact."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to_numpy(v) for v in tree]
    t = tree.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()
