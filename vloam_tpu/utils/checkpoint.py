"""Checkpoint / resume — a subsystem the reference lacks entirely
(SURVEY.md §5.4: map cubes + poses live only in RAM; a crash restarts the
sequence).  The whole pipeline state is one pytree, so a snapshot is its
flattened leaves in one ``.npz`` file; long KITTI sequences become
resumable jobs.

Layout: ``<path>/state.npz`` holds ``leaf_0000 ...`` (the leaves in
``jax.tree.flatten`` order), ``frame`` and ``treedef`` (the structure's
text form).  Loading checks structure, shapes and dtypes against a template
state and refuses a snapshot that does not match it.
"""

from __future__ import annotations

import os

import jax
import numpy as np

_FILE = "state.npz"


def save_checkpoint(path: str, state, frame_index: int) -> None:
    """Snapshot a VloamState (or any pytree) + frame counter under ``path``
    (a directory).  Sharded arrays are gathered to the host."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    leaves, treedef = jax.tree.flatten(state)
    arrs = {f"leaf_{i:04d}": np.asarray(x) for i, x in enumerate(leaves)}
    tmp = os.path.join(path, _FILE + ".tmp.npz")
    np.savez(tmp, frame=np.asarray(frame_index, np.int64),
             treedef=np.asarray(str(treedef)), **arrs)
    os.replace(tmp, os.path.join(path, _FILE))


def load_checkpoint(path: str, template_state):
    """Restore (state, frame_index); ``template_state`` supplies the pytree
    structure, shapes and dtypes (from init_vloam_state(cfg)).  Raises
    ValueError if the snapshot does not match it."""
    leaves, treedef = jax.tree.flatten(template_state)
    with np.load(os.path.join(os.path.abspath(path), _FILE)) as z:
        if str(z["treedef"]) != str(treedef):
            raise ValueError(f"checkpoint {path}: state structure differs from the template")
        out = []
        for i, ref in enumerate(leaves):
            a = z[f"leaf_{i:04d}"]
            ref = np.asarray(ref)
            if a.shape != ref.shape or a.dtype != ref.dtype:
                raise ValueError(
                    f"checkpoint {path}: leaf {i} is {a.dtype}{a.shape}, "
                    f"template wants {ref.dtype}{ref.shape}")
            out.append(a)
        frame = int(z["frame"])
    return jax.tree.unflatten(treedef, out), frame
