"""Device placement shared by the port's entry points.

The port never picks a device on its own: host data (numpy arrays, lists,
Python numbers) needs an explicit ``device``; a tensor stays where it is
unless a ``device`` is given.
"""

from __future__ import annotations

import numpy as np
import torch


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
