"""Sharded, async checkpointing with elastic restore (port of
``repro/train/checkpoint.py``), in the reference's layout:

    <dir>/step_<N>/manifest.json      leaf paths, shapes and dtypes
    <dir>/step_<N>/shard_<p>.npz      this process's leaves
    <dir>/step_<N>/COMMITTED          written last; readers ignore a step
                                      directory without it

Leaves are keyed by their paths joined with ``/`` in the reference's
flatten order (``utils.tree.leaves_with_paths``), and dtypes are named as
the reference names them, so each package reads the other's checkpoints.
numpy has no bf16: a bf16 leaf is stored as its raw 2-byte records
(``|V2``), the bytes ``np.savez`` writes for the reference's bf16 arrays,
and read back through an int16 view. (The reference's own ``restore``
cannot cast those records, so it reads none of its bf16 checkpoints; the
port reads them.)

``AsyncCheckpointer.save`` copies the leaves to host memory before it
returns and writes them in a background thread. ``restore`` places each
leaf on the device its ``like_tree`` leaf is on, or where ``devices``
says: the port's form of the reference's target shardings (on one
controller a leaf goes whole to one device, e.g. a ``launch/mesh.py``
mesh's shard device).
"""
from __future__ import annotations

import json
import os
import threading

import numpy as np
import torch

from repro_torch.utils.tree import (leaves, leaves_with_paths, tree_map,
                                    tree_unflatten)

DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
               torch.float16: "float16", torch.float64: "float64",
               torch.int8: "int8", torch.int16: "int16",
               torch.int32: "int32", torch.int64: "int64",
               torch.uint8: "uint8", torch.bool: "bool"}
BF16_RECORDS = np.dtype("V2")


def _host(t: torch.Tensor) -> np.ndarray:
    """A leaf as the numpy array the reference writes for it (bf16 as
    ``|V2`` records of its bytes)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_RECORDS)
    return t.numpy()


def _tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A stored array as a tensor of its manifest dtype (bf16 from its
    ``|V2`` records)."""
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def save(ckpt_dir: str, step: int, tree, process_index: int = 0) -> str:
    """Synchronous checkpoint write. Returns the step directory."""
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    os.makedirs(step_dir, exist_ok=True)
    flat = leaves_with_paths(tree)
    manifest = {"step": step,
                "leaves": {k: {"shape": list(v.shape),
                               "dtype": DTYPE_NAMES[v.dtype]}
                           for k, v in flat}}
    np.savez(os.path.join(step_dir, f"shard_{process_index}.npz"),
             **{k: _host(v) for k, v in flat})
    with open(os.path.join(step_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    # commit marker: readers ignore step dirs without it (crash safety)
    with open(os.path.join(step_dir, "COMMITTED"), "w") as f:
        f.write("ok")
    return step_dir


class AsyncCheckpointer:
    """Snapshot to host synchronously, write to disk in the background."""

    def __init__(self):
        self._thread: threading.Thread | None = None

    def save(self, ckpt_dir: str, step: int, tree) -> None:
        self.wait()
        host_tree = tree_map(lambda t: t.detach().to("cpu", copy=True), tree)
        self._thread = threading.Thread(
            target=save, args=(ckpt_dir, step, host_tree), daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and os.path.exists(
                os.path.join(ckpt_dir, name, "COMMITTED")):
            steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like_tree, devices=None):
    """Load a checkpoint into the structure, shapes and dtypes of
    ``like_tree``. ``devices``: ``None`` (each leaf where its
    ``like_tree`` leaf is), one device for every leaf, or a tree of
    devices matching ``like_tree``."""
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        dtypes = {k: v["dtype"] for k, v in json.load(f)["leaves"].items()}
    data = {}
    for name in sorted(os.listdir(step_dir)):
        if name.startswith("shard_") and name.endswith(".npz"):
            with np.load(os.path.join(step_dir, name)) as z:
                data.update({k: z[k] for k in z.files})
    flat = leaves_with_paths(like_tree)
    if devices is None:
        places = [like.device for _, like in flat]
    elif isinstance(devices, (dict, list, tuple)):
        places = [torch.device(d) for d in leaves(devices)]
    else:
        places = [torch.device(devices)] * len(flat)
    out = []
    for (key, like), dev in zip(flat, places):
        arr = data[key]
        if list(arr.shape) != list(like.shape):
            raise ValueError(f"shape mismatch for {key}: "
                             f"{arr.shape} vs {tuple(like.shape)}")
        out.append(_tensor(arr, dtypes[key]).to(device=dev,
                                                dtype=like.dtype))
    return tree_unflatten(like_tree, out)
