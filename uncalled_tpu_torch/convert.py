"""Carry index tables and engine state between numpy and the port's tensors.

The tests use these to feed the very same index and state to the JAX
package (as numpy) and to the port, and to compare the results key by key.
"""

from __future__ import annotations

import numpy as np
import torch

_DTYPES = {
    np.dtype(np.int32): torch.int32,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.bool_): torch.bool,
}


def _tensor(a, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {a.dtype} (int32/float32/bool)")
    return torch.from_numpy(a.copy()).to(device)


def index_from_numpy(tables: dict, device="cpu") -> dict:
    """Index tables (numpy arrays, e.g. the JAX ``device_index`` output
    pulled to host) -> tensors on ``device``; python-int metadata (``n``,
    ``primary``) passes through unchanged."""
    return {
        k: (v if isinstance(v, int) else _tensor(np.asarray(v), device))
        for k, v in tables.items()
    }


def state_from_numpy(state: dict, device="cpu") -> dict:
    """State dict of numpy arrays -> tensors on ``device`` (dtypes kept).

    Serves both engines: the pooled engine's pool state and the classic
    ``MapEngine``'s per-read state (``make_state`` of either package)."""
    return {k: _tensor(np.asarray(v), device) for k, v in state.items()}


def state_to_numpy(state: dict) -> dict:
    """State dict of tensors -> numpy arrays (dtypes kept), for the pooled
    engine's pool state and the classic ``MapEngine``'s state alike."""
    return {k: v.detach().cpu().numpy() for k, v in state.items()}
