"""Failure snapshots: dump the exact inputs of a failing render for replay.

Port of ``stopthepop_tpu/utils/snapshot.py``, the reference's debug path
(diff_gaussian_rasterization/__init__.py:96-103, 149-156): with
``debug=True`` every tensor argument is copied to the host before the call
(``host_copies``, the reference's ``cpu_deep_copy_tuple``), and when the
forward or backward raises, the copies go into ``snapshot_<tag>.npz`` (+ a
JSON sidecar for the settings) and the exception re-raises. The copies are
taken before the call because after a kernel fault the CUDA context may be
unusable.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch


def host_copies(arrays: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Host numpy copies of ``arrays`` (tensors on any device); None
    entries are left out."""
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v))
            for k, v in arrays.items() if v is not None}


def dump_snapshot(tag: str, arrays: Dict[str, Any],
                  meta: Optional[dict] = None, directory: str = None) -> str:
    """Write snapshot_<tag>.npz (+ .json) and return the npz path.

    ``directory`` defaults to ``$STP_SNAPSHOT_DIR`` (else the working
    directory)."""
    if directory is None:
        directory = os.environ.get("STP_SNAPSHOT_DIR", ".")
    path = os.path.join(directory, f"snapshot_{tag}.npz")
    np.savez(path, **host_copies(arrays))
    if meta is not None:
        with open(path.replace(".npz", ".json"), "w") as f:
            json.dump(meta, f, indent=2, default=str)
    return path


def load_snapshot(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return dict(z)


@contextlib.contextmanager
def snapshot_on_failure(tag: str, arrays: Dict[str, Any],
                        meta: Optional[dict] = None, directory: str = None,
                        device=None):
    """Dump ``arrays`` if the body raises, print the path, re-raise.

    On a CUDA ``device`` the body's end synchronizes it inside the context,
    so that an asynchronous kernel error raises here and is dumped. Same
    contract as the reference's try/except around _C.rasterize_gaussians:
    "An error occurred in forward. Please forward snapshot_fw.dump for
    debugging."
    """
    try:
        yield
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
    except Exception:
        try:
            path = dump_snapshot(tag, arrays, meta, directory)
            print(f"\nAn error occurred in {tag}. Wrote {path} for debugging.")
        except OSError as e:
            print(f"\nAn error occurred in {tag}; the snapshot could not be "
                  f"written: {e}")
        raise
