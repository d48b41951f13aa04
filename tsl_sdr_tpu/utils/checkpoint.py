"""Stream-state checkpoint/resume.

The reference has no checkpointing (its pipeline state is a few KB of
in-RAM carries, SURVEY §5); long-running deployments want to survive
restarts without losing filter history or decoder sync. Every streaming
state in this framework is a pytree of arrays (NamedTuples or bare arrays),
so checkpoints are one ``.npz`` per state.
"""

from __future__ import annotations

import json

import numpy as np
import jax


def save_state(path, state, meta: dict | None = None):
    """Serialize any pytree-of-arrays stream state to ``path`` (.npz)."""
    leaves, treedef = jax.tree.flatten(state)
    arrays = {f"leaf_{i}": np.asarray(v) for i, v in enumerate(leaves)}
    arrays["__treedef__"] = np.frombuffer(
        str(treedef).encode(), dtype=np.uint8
    )
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta or {}).encode(), dtype=np.uint8
    )
    np.savez(path, **arrays)


def load_state(path, like):
    """Load a checkpoint into the structure of ``like`` (a template state
    from ``init_state()``). Returns (state, meta). Shapes must match the
    template — a mismatch means the checkpoint came from a different plan.
    """
    data = np.load(path)
    leaves, treedef = jax.tree.flatten(like)
    restored = []
    for i, tmpl in enumerate(leaves):
        arr = data[f"leaf_{i}"]
        t = np.asarray(tmpl)
        if arr.shape != t.shape or arr.dtype != t.dtype:
            raise ValueError(
                f"checkpoint leaf {i} is {arr.dtype}{arr.shape}, plan "
                f"expects {t.dtype}{t.shape}"
            )
        restored.append(arr)
    meta = json.loads(bytes(data["__meta__"]).decode() or "{}")
    return jax.tree.unflatten(treedef, restored), meta
