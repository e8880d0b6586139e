"""Render checkpoint/resume, in the format of
`miniraytracer_tpu/utils/checkpoint.py`: a checkpoint written by either
package loads in the other.

The reference has no checkpointing; its closest analogue is draw2's
progressive frame, which always holds a valid partial render averaged over
the passes done (main.cpp:221-223). A checkpoint makes that state durable:
(running-average frame, samples done, render config). The RNG is
counter-based and keyed on (pixel, sample) (`ops/rng.py`), so resuming at
pass k reproduces exactly the frames a straight render would have made.
"""

from __future__ import annotations

import json

import numpy as np

FORMAT_VERSION = 1


def checkpoint_path(path: str) -> str:
    """The path on disk: np.savez appends '.npz' when it is missing, so save
    and load both normalize to it (a bare '-checkpoint X' then '-resume X'
    round-trips)."""
    return path if path.endswith(".npz") else path + ".npz"


def save_checkpoint(path: str, frame, sample_idx: int, config: dict) -> str:
    """frame: (H*W, 3) or (H, W, 3) running average after `sample_idx`
    passes, a numpy array. Returns the path written ('.npz' appended if
    needed)."""
    path = checkpoint_path(path)
    np.savez_compressed(
        path,
        version=FORMAT_VERSION,
        frame=np.asarray(frame, np.float32),
        sample_idx=np.int64(sample_idx),
        config=json.dumps(config),
    )
    return path


def load_checkpoint(path: str):
    """Returns (frame numpy array, sample_idx, config dict)."""
    path = checkpoint_path(path)
    with np.load(path, allow_pickle=False) as z:
        if int(z["version"]) != FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {int(z['version'])}")
        return z["frame"], int(z["sample_idx"]), json.loads(str(z["config"]))
