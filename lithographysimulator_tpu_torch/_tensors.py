"""Device placement shared by the port's entry points.

The port never picks a device on its own: host data (numpy arrays, lists,
Python numbers) needs an explicit ``device``; a tensor stays where it is
unless a ``device`` is given. :func:`per_device_cache` keeps the caches of
device tensors apart for each device.
"""

from __future__ import annotations

import collections
import functools
import threading

import numpy as np
import torch

CacheInfo = collections.namedtuple("CacheInfo", "hits misses maxsize currsize")


def to_tensor(x, *, device=None, dtype=None) -> torch.Tensor:
    """``x`` as a tensor of ``dtype`` on ``device`` (see module docstring)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device if device is not None else x.device,
                    dtype=dtype if dtype is not None else x.dtype)
    if device is None:
        raise ValueError("host data needs an explicit device= (e.g. 'cuda' or 'cpu')")
    host = np.asarray(x)
    if not host.flags.writeable:  # e.g. a view of a JAX array
        host = host.copy()
    return torch.as_tensor(host, dtype=dtype, device=device)


def per_device_cache(maxsize: int):
    """``functools.lru_cache(maxsize)`` kept apart for each device: the
    decorated function's last argument is a ``torch.device``, and each
    device holds up to ``maxsize`` entries of its own. A mesh of distinct
    devices (:mod:`..parallel`) then builds an entry once a device instead
    of evicting another device's entry every shard, and one device's
    memory stays bounded as before. ``cache_info()`` sums the devices';
    ``cache_clear()`` empties them all."""

    def wrap(fn):
        caches: dict = {}
        lock = threading.Lock()

        @functools.wraps(fn)
        def cached(*args):
            with lock:
                per = caches.get(args[-1])
                if per is None:
                    per = caches[args[-1]] = functools.lru_cache(maxsize)(fn)
            return per(*args)

        def cache_info() -> CacheInfo:
            with lock:
                infos = [c.cache_info() for c in caches.values()]
            return CacheInfo(sum(i.hits for i in infos),
                             sum(i.misses for i in infos), maxsize,
                             sum(i.currsize for i in infos))

        def cache_clear() -> None:
            with lock:
                caches.clear()

        cached.cache_info = cache_info
        cached.cache_clear = cache_clear
        return cached

    return wrap
