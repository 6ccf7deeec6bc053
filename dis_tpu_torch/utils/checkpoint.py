"""Sequence-progress checkpointing for long-video runs; a copy of
``dis_tpu/utils/checkpoint.py`` (NumPy only).  The fingerprint is the
same JSON of the config's fields, so a checkpoint that ``dis_tpu``'s
runner wrote for a config resumes here for the equal port config
(``tests/test_torch_runner.py``).

The reference has no checkpoint/resume; its only durable state is the
per-frame flow written to disk (main.cpp:202).  For multi-host sequence
runs a preempted worker must be able to rejoin: we persist
(frame index, last flow, config fingerprint) atomically after each
pair, and ``resume`` returns where to continue.  Flow state rides the
same Middlebury .flo container used for outputs, so checkpoints are
inspectable with standard tools.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Optional, Tuple

import numpy as np

from .flo import load_flo, save_flo


def _fingerprint(cfg) -> str:
    d = dataclasses.asdict(cfg)
    return json.dumps(d, sort_keys=True)


class SequenceCheckpoint:
    """Atomic per-sequence progress checkpoint in a directory."""

    def __init__(self, ckpt_dir: str, cfg):
        self.dir = ckpt_dir
        self.fp = _fingerprint(cfg)
        os.makedirs(ckpt_dir, exist_ok=True)

    @property
    def _meta_path(self) -> str:
        return os.path.join(self.dir, "progress.json")

    @property
    def _flow_path(self) -> str:
        return os.path.join(self.dir, "last_flow.flo")

    def save(self, frame_idx: int, last_flow: Optional[np.ndarray] = None) -> None:
        """Record completion of pair (frame_idx, frame_idx+1)."""
        if last_flow is not None:
            tmp = self._flow_path + ".tmp"
            save_flo(tmp, last_flow)
            os.replace(tmp, self._flow_path)
        meta = {"frame_idx": frame_idx, "config": self.fp}
        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, self._meta_path)

    def resume(self) -> Tuple[int, Optional[np.ndarray]]:
        """(next frame index to process, last flow or None).

        A checkpoint written under a different config is ignored —
        resuming mid-sequence with changed parameters would silently
        mix semantics.
        """
        if not os.path.exists(self._meta_path):
            return 0, None
        try:
            with open(self._meta_path) as f:
                meta = json.load(f)
        except (json.JSONDecodeError, OSError):
            return 0, None
        if meta.get("config") != self.fp:
            return 0, None
        flow = None
        if os.path.exists(self._flow_path):
            try:
                flow = load_flo(self._flow_path)
            except ValueError:
                flow = None
        return int(meta["frame_idx"]) + 1, flow
