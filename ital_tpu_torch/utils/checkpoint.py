"""Session checkpoint / resume (port of ``ital_tpu.utils.checkpoint``).

Each feedback round can snapshot the whole session state (label buffers,
Cholesky factor, whitened cross-kernel, posterior, hyperparameters, optional
density, metric curves) as one ``.npz`` file, and a resumed run continues an
interrupted session from it.  The keys and dtypes are the reference's
(``state_<field>``, ``hyper``, ``density``, ``extra_<key>``), so a snapshot
written by either package restores in the other.  The corpus features are
not stored: the template state supplies them.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ital_tpu_torch.models.gp import GPHyper, GPState

_STATE_FIELDS = ("idx", "y", "valid", "count", "l", "beta", "v", "mu", "sig2")


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_session(path: str, state: GPState, extra: Optional[Dict[str, Any]] = None) -> None:
    """Write a session snapshot (everything but the corpus) to ``path``, atomically."""
    payload: Dict[str, np.ndarray] = {
        f"state_{f}": _host(getattr(state, f)) for f in _STATE_FIELDS if f != "count"
    }
    payload["state_idx"] = payload["state_idx"].astype(np.int32)
    payload["state_count"] = np.asarray(state.count, np.int32)
    h = state.hyper
    payload["hyper"] = np.asarray(
        [float(h.length_scale), float(h.var), float(h.noise)], np.float64
    )
    if state.density is not None:
        payload["density"] = _host(state.density)
    for key, val in (extra or {}).items():
        payload[f"extra_{key}"] = np.asarray(val)
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "wb") as fh:
        np.savez(fh, **payload)
    os.replace(tmp, path)  # a crash never leaves a torn checkpoint


def load_session(path, template: GPState) -> tuple[GPState, Dict[str, np.ndarray]]:
    """Rebuild a session from a snapshot (a path or a binary file object)
    and the corpus-bearing ``template``.

    ``template`` supplies ``x``, ``x2``, the device and the posterior dtype;
    its density is kept unless the snapshot has one.  The session buffers
    are new tensors, so nothing written to the result reaches the template.
    Returns the state and the ``extra`` arrays.
    """
    dev = template.mu.device
    dt = template.mu.dtype

    def tensor(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(a)).to(dev)  # np.array: a writable copy

    with np.load(path) as blob:
        t = {f: tensor(blob[f"state_{f}"]) for f in _STATE_FIELDS if f != "count"}
        count = int(blob["state_count"])
        ls, var, noise = (torch.tensor(float(v), dtype=dt, device=dev) for v in blob["hyper"])
        density = tensor(blob["density"]) if "density" in blob.files else template.density
        extras = {k[len("extra_"):]: blob[k] for k in blob.files if k.startswith("extra_")}
    t["idx"] = t["idx"].to(torch.int64)
    t["valid"] = t["valid"].to(torch.bool)
    state = dataclasses.replace(
        template, count=count, hyper=GPHyper(length_scale=ls, var=var, noise=noise),
        density=density, **t,
    )
    return state, extras
