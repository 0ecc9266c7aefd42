"""Solver-state checkpoint / resume.

The reference's persistence is file-level only — cameras.xml out,
-model_files + -has_initial_guess in; there is no mid-solve checkpointing.
This module writes the full solver state (npz + json sidecar): every
optimized parameter (CalibState), the stage machine position, and solver
bookkeeping, so a long calibration can resume where it stopped.

The format is the JAX package's (``FORMAT_VERSION`` 1, the same field names
and sidecar keys): a checkpoint written by either package loads in the
other.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from .convert import state_from_numpy, state_to_numpy
from .device import resolve_device
from .solver.problem import CalibState, StageFlags

FORMAT_VERSION = 1


def save_checkpoint(path: str, state: CalibState, flags: StageFlags = None,
                    meta: dict = None):
    """Write state (+ stage flags / metadata) to ``path`` (.npz) and
    ``path + .json``.  One device-to-host copy per state field."""
    np.savez(path, **state_to_numpy(state))
    side = {"format_version": FORMAT_VERSION,
            "fields": list(state._fields)}
    if flags is not None:
        side["stage_flags"] = dataclasses.asdict(flags)
    if meta:
        side["meta"] = meta
    with open(path + ".json", "w") as f:
        json.dump(side, f, indent=1)


def load_checkpoint(path: str, dtype=None, device="cuda"):
    """Returns (CalibState on ``device``, StageFlags-or-None, meta dict).
    With ``dtype`` None every field keeps its saved dtype."""
    dev = resolve_device(device)
    npz = path if path.endswith(".npz") else path + ".npz"
    side = {}
    for p in (npz + ".json", path + ".json"):
        if os.path.exists(p):
            with open(p) as f:
                side = json.load(f)
            break
    with np.load(npz) as z:
        state = state_from_numpy({f: z[f] for f in CalibState._fields}, dev,
                                 dtype)
    flags = None
    if "stage_flags" in side:
        flags = StageFlags(**side["stage_flags"])
    return state, flags, side.get("meta", {})
