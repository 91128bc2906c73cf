"""Automatic SParsity: n:m (default 2:4) structured pruning (port of the
reference's ``incubate/asp.py``).

The masks are computed in numpy exactly as the reference computes them
(per row, each group of ``m`` columns keeps its ``n`` largest magnitudes;
trailing columns stay dense), so both packages prune the same weights to
the same bits.  ``prune_model`` multiplies each supported layer's weight
(``nn.Linear``) by its mask and, with ``with_mask``, remembers the mask;
an optimizer wrapped by ``decorate`` re-applies the remembered masks after
every ``step``, and ``jit.TrainStep`` after every update, to the parameter
and its f32 master weight.  The H100's sparse tensor cores are not used:
the masks give the training-side semantics, as the reference's do on the
TPU.
"""

from __future__ import annotations

import weakref
from typing import Dict, List

import numpy as np
import torch

from ..nn.layer.common import Linear
from ..nn.layer.layers import Layer

__all__ = ["calculate_density", "check_mask_1d", "get_mask_1d", "create_mask",
           "decorate", "prune_model", "set_excluded_layers",
           "reset_excluded_layers", "ASPHelper"]


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()
    return np.asarray(x)


def calculate_density(x) -> float:
    """The share of nonzero elements."""
    arr = _numpy(x)
    return float(np.count_nonzero(arr)) / max(1, arr.size)


def get_mask_1d(mat, n: int = 2, m: int = 4) -> np.ndarray:
    """Per row, each group of ``m`` columns keeps its ``n`` largest
    magnitudes (1) and drops the rest (0); trailing columns (cols % m) stay
    1.  In ``mat``'s dtype and shape."""
    mat = _numpy(mat)
    mask = np.ones_like(mat, dtype=mat.dtype)
    rows, cols = mat.reshape(-1, mat.shape[-1]).shape
    flat = np.abs(mat.reshape(rows, cols))
    mflat = mask.reshape(rows, cols)
    usable = cols - cols % m
    if usable:
        groups = flat[:, :usable].reshape(rows, usable // m, m)
        # indices of the (m - n) smallest of each group: zeroed
        drop = np.argsort(groups, axis=-1)[..., : m - n]
        gm = np.ones_like(groups)
        np.put_along_axis(gm, drop, 0.0, axis=-1)
        mflat[:, :usable] = gm.reshape(rows, usable)
    return mask.reshape(mat.shape)


def check_mask_1d(mat, n: int = 2, m: int = 4) -> bool:
    """True when every whole group of ``m`` columns has at most ``n``
    nonzeros."""
    mat = _numpy(mat)
    rows = mat.reshape(-1, mat.shape[-1])
    cols = rows.shape[-1]
    usable = cols - cols % m
    if not usable:
        return True
    groups = rows[:, :usable].reshape(rows.shape[0], -1, m)
    return bool((np.count_nonzero(groups, axis=-1) <= n).all())


def create_mask(mat, func_name: str = "mask_1d", n: int = 2, m: int = 4):
    """The n:m mask of ``mat``: every algorithm name is the 1-d mask, whose
    rows meet the 2-d algorithms' check too, as in the reference."""
    if func_name not in ("mask_1d", "mask_2d_greedy", "mask_2d_best"):
        raise ValueError(f"unknown mask algorithm {func_name!r}")
    return get_mask_1d(mat, n, m)


class ASPHelper:
    """The pruning registry: masks keyed by the parameter's identity, each
    dropped when its parameter is collected (``weakref.finalize``), so a
    recycled id never sees a stale mask."""

    _excluded: List[str] = []
    _masks: Dict[int, torch.Tensor] = {}

    @classmethod
    def reset(cls):
        cls._excluded = []
        cls._masks = {}

    @classmethod
    def _register_mask(cls, w, mask) -> None:
        key = id(w)
        cls._masks[key] = mask
        weakref.finalize(w, cls._masks.pop, key, None)

    @classmethod
    def is_supported(cls, layer: Layer) -> bool:
        return isinstance(layer, Linear)

    @classmethod
    def prune_model(cls, model: Layer, n: int = 2, m: int = 4,
                    mask_algo: str = "mask_1d", with_mask: bool = True):
        masks = {}
        for name, layer in model.named_modules():
            if not cls.is_supported(layer):
                continue
            # an exact name or a whole dotted segment ("0" must not exclude "10")
            if any(ex == name or ex in name.split(".") for ex in cls._excluded):
                continue
            w = layer._parameters.get("weight")
            if w is None:
                continue
            mask = create_mask(_numpy(w), mask_algo, n, m)
            t = torch.as_tensor(mask, device=w.device).to(w.dtype)
            with torch.no_grad():
                w.mul_(t)
            if with_mask:
                cls._register_mask(w, t)
                masks[name] = mask
        return masks

    @classmethod
    @torch.no_grad()
    def apply_masks(cls, optimizer) -> None:
        """Each masked parameter of ``optimizer`` and its master weight
        times its mask."""
        if not cls._masks:
            return
        for p in optimizer._parameter_list:
            mask = cls._masks.get(id(p))
            if mask is not None:
                p.mul_(mask)
                mw = optimizer._master_weights.get(id(p))
                if mw is not None:
                    mw.mul_(mask.to(mw.dtype))


def set_excluded_layers(param_names: List[str], main_program=None) -> None:
    """Layers whose name, or a dotted segment of it, is listed are not
    pruned."""
    ASPHelper._excluded = list(param_names)


def reset_excluded_layers(main_program=None) -> None:
    ASPHelper._excluded = []


def prune_model(model: Layer, n: int = 2, m: int = 4,
                mask_algo: str = "mask_1d", with_mask: bool = True):
    """Apply n:m masks to every supported layer's weight; returns {layer
    name: numpy mask}.  With ``with_mask`` the masks are remembered, so a
    :func:`decorate`-d optimizer and ``jit.TrainStep`` keep the pattern."""
    return ASPHelper.prune_model(model, n, m, mask_algo, with_mask)


def decorate(optimizer):
    """Wrap ``optimizer.step`` to re-apply the pruning masks after every
    update; decorating twice wraps once."""
    if getattr(optimizer, "_asp_decorated", False):
        return optimizer
    orig_step = optimizer.step

    def step(*args, **kwargs):
        out = orig_step(*args, **kwargs)
        ASPHelper.apply_masks(optimizer)
        return out

    optimizer.step = step
    optimizer._asp_decorated = True
    return optimizer
