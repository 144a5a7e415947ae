"""Fault-tolerant checkpoint manager: atomic writes, retention, auto-resume.

A torch copy of ``repro.checkpoint.manager`` with its layout on disk:
``<dir>/step_<N>/host_<h>.npz`` (entries ``leaf_<i>``, the tree's leaves
in the reference's order, ``repro_torch.tree``) and ``MANIFEST.json``.
Each file is written under a temp name, fsynced and renamed with
``os.replace``, so a crash mid-write never corrupts a published file,
and a step whose manifest or shard files are missing is not restorable.
So a checkpoint the JAX package wrote restores here, and one written
here restores there.

Multi-host: each host writes its own shard file (``host`` arg); the
manifest lists the expected host count so partially-written multi-host
checkpoints are not considered restorable.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import zipfile
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["CheckpointManager"]


def _host_array(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _structure(tree) -> str:
    """The tree's shape with its leaves as ``*`` (the manifest's record;
    restore reads only the leaf count)."""
    return str(tree_map(lambda _: "*", tree))


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, n_hosts: int = 1):
        self.dir = directory
        self.keep = keep
        self.n_hosts = n_hosts
        os.makedirs(directory, exist_ok=True)

    # ---------------- write ----------------
    def save(self, step: int, tree: Any, host: int = 0,
             extra: Optional[dict] = None) -> str:
        """Write this host's shard (+ the manifest) for ``step``.

        The step becomes restorable only when the manifest AND all
        ``n_hosts`` shard files exist (see ``steps()``). Leaves on the
        card are copied to the host first.
        """
        leaves = tree_leaves(tree)
        final = os.path.join(self.dir, f"step_{step:08d}")
        os.makedirs(final, exist_ok=True)
        arrays = {f"leaf_{i}": _host_array(x) for i, x in enumerate(leaves)}
        fd, tmp_path = tempfile.mkstemp(dir=final, prefix=f".tmp_h{host}_")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **arrays)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp_path, os.path.join(final, f"host_{host}.npz"))
        except Exception:
            if os.path.exists(tmp_path):
                os.unlink(tmp_path)
            raise
        manifest = {
            "step": step,
            "n_hosts": self.n_hosts,
            "n_leaves": len(leaves),
            "treedef": _structure(tree),
            "extra": extra or {},
        }
        fd, tmp_path = tempfile.mkstemp(dir=final, prefix=".tmp_manifest_")
        with os.fdopen(fd, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp_path, os.path.join(final, "MANIFEST.json"))
        self._retain()
        return final

    # ---------------- read ----------------
    def _complete(self, full: str) -> bool:
        mpath = os.path.join(full, "MANIFEST.json")
        if not os.path.exists(mpath):
            return False
        try:
            with open(mpath) as f:
                n_hosts = json.load(f).get("n_hosts", 1)
        except (json.JSONDecodeError, OSError):
            return False
        return all(os.path.exists(os.path.join(full, f"host_{h}.npz"))
                   for h in range(n_hosts))

    def steps(self):
        out = []
        for name in os.listdir(self.dir):
            if not name.startswith("step_"):
                continue
            if not self._complete(os.path.join(self.dir, name)):
                continue  # incomplete -> not restorable
            try:
                out.append(int(name.split("_")[1]))
            except ValueError:
                continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, template: Any, step: Optional[int] = None,
                host: int = 0) -> tuple[Any, int]:
        """Restore into the structure of ``template``. Returns (tree, step).

        Each leaf lands on its template leaf's device and dtype; a module
        in the template takes its values in place and is returned."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}", f"host_{host}.npz")
        leaves = tree_leaves(template)
        with np.load(path) as z:
            if len(z.files) != len(leaves):
                raise ValueError(
                    f"checkpoint has {len(z.files)} leaves, template has "
                    f"{len(leaves)} — config mismatch?")
            new = [z[f"leaf_{i}"] for i in range(len(leaves))]
        restored = tree_unflatten(template, [
            torch.from_numpy(n).to(device=l.device, dtype=l.dtype)
            for n, l in zip(new, leaves)])
        return restored, step

    def open_leaves(self, step: Optional[int] = None, host: int = 0
                    ) -> list:
        """The leaves of a stored step as read-only memory maps of its
        shard file, in order (nothing is read until a leaf is sliced).
        ``np.savez`` stores each array uncompressed, so each lies in one
        run of the file, after its zip entry's header and its ``.npy``
        header."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}", f"host_{host}.npz")
        leaves = []
        with zipfile.ZipFile(path) as z, open(path, "rb") as f:
            names = sorted(z.namelist(),
                           key=lambda n: int(n[len("leaf_"):-len(".npy")]))
            for name in names:
                info = z.getinfo(name)
                if info.compress_type != zipfile.ZIP_STORED:
                    raise ValueError(f"{path}: {name} is compressed")
                f.seek(info.header_offset)
                local = f.read(30)
                start = (info.header_offset + 30
                         + int.from_bytes(local[26:28], "little")
                         + int.from_bytes(local[28:30], "little"))
                f.seek(start)
                read_header = (np.lib.format.read_array_header_1_0
                               if np.lib.format.read_magic(f) == (1, 0)
                               else np.lib.format.read_array_header_2_0)
                shape, fortran, dtype = read_header(f)
                if fortran:
                    raise ValueError(f"{path}: {name} is Fortran-ordered")
                leaves.append(np.memmap(path, dtype=dtype, mode="r",
                                        offset=f.tell(), shape=shape))
        return leaves

    def manifest(self, step: int) -> dict:
        with open(os.path.join(self.dir, f"step_{step:08d}",
                               "MANIFEST.json")) as f:
            return json.load(f)

    # ---------------- retention ----------------
    def _retain(self):
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)
