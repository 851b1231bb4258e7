"""Host↔device access helpers that bound the number of compiled programs.

EVERY eager operation with a distinct baked-in constant (e.g. ``x[k]``
for a new k, ``x[:n]`` for a new n) is a fresh tiny program and a fresh
compile. Host-side code should therefore only:

  * transfer whole ready buffers (``np.asarray(x)``), or
  * go through the cached, bucketed jitted slicers below.
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax
import numpy as np

_SLICE_CACHE: Dict[Tuple, object] = {}


def to_np(x) -> np.ndarray:
    """Whole-buffer device→host transfer (no compute, no compile)."""
    return np.asarray(x)


def bucket_slice(x, n: int) -> np.ndarray:
    """First n rows of a device array as numpy, transferring only a
    power-of-two bucket — O(log capacity) distinct compiled programs."""
    if n <= 0:
        return np.zeros((0,) + x.shape[1:], x.dtype)
    kb = min(1 << (n - 1).bit_length(), x.shape[0])
    key = (x.shape, str(x.dtype), kb)
    fn = _SLICE_CACHE.get(key)
    if fn is None:
        fn = jax.jit(lambda a, _kb=kb: jax.lax.slice_in_dim(a, 0, _kb,
                                                            axis=0))
        _SLICE_CACHE[key] = fn
    return np.asarray(fn(x))[:n]


def bucket_slice_cols_pair(a, b, n: int):
    """bucket_slice_cols of TWO same-width buffers with ONE combined
    device_get — on a busy shared chip every separate readback queues
    behind whatever program is in flight, so pairing halves the stall
    toll (mesher vertex+color pulls)."""
    if n <= 0:
        return (np.zeros(a.shape[:-1] + (0,), a.dtype),
                np.zeros(b.shape[:-1] + (0,), b.dtype))
    outs = []
    for x in (a, b):
        kb = min(1 << (n - 1).bit_length(), x.shape[-1])
        key = ("cols", x.shape, str(x.dtype), kb)
        fn = _SLICE_CACHE.get(key)
        if fn is None:
            fn = jax.jit(lambda arr, _kb=kb: jax.lax.slice_in_dim(
                arr, 0, _kb, axis=x.ndim - 1))
            _SLICE_CACHE[key] = fn
        outs.append(fn(x))
    ah, bh = jax.device_get(tuple(outs))
    return np.asarray(ah)[..., :n], np.asarray(bh)[..., :n]


def bucket_slice_cols(x, n: int) -> np.ndarray:
    """First n COLUMNS of a 2-D device array as numpy (bucketed like
    bucket_slice) — for plane-layout buffers whose minor axis is the
    item axis (e.g. the mesher's (9, M) triangle planes)."""
    if n <= 0:
        return np.zeros(x.shape[:-1] + (0,), x.dtype)
    kb = min(1 << (n - 1).bit_length(), x.shape[-1])
    key = ("cols", x.shape, str(x.dtype), kb)
    fn = _SLICE_CACHE.get(key)
    if fn is None:
        fn = jax.jit(lambda a, _kb=kb: jax.lax.slice_in_dim(
            a, 0, _kb, axis=x.ndim - 1))
        _SLICE_CACHE[key] = fn
    return np.asarray(fn(x))[..., :n]
