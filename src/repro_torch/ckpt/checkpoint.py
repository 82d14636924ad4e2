"""Checkpoints with elastic restore (twin of ``repro.ckpt.checkpoint``).

Format, byte-compatible with the reference in both directions: one
``<group>.npz`` per top-level state group plus ``manifest.json`` (step,
the ``extra`` dict, and per group its file, the file's sha256, its keys
and a sha256 per array). A group is a nested dict / list / tuple of numpy
arrays or tensors; its keys are the ``/``-joined paths of the leaves (dict
keys sorted, sequence indices), the reference's pytree paths. A dtype
numpy cannot hold (torch bf16) is stored as fp32 and cast back on restore.

Saves take host copies, so a step carries no trace of the device or
process layout it was saved under: restore puts the arrays wherever the
restarted job wants them (``device=``), which makes an elastic rescale the
same code path as a plain restart.

Crash-safety contract
---------------------
A step directory is COMPLETE iff its manifest parses and every group file
it names exists with the recorded file-level sha256. A save builds the
whole step in a temp dir (manifest written last) and publishes it with
``os.replace``, so a crash mid-save leaves a stray temp dir, never a torn
step. Overwriting an existing step renames the old dir aside first; the
only crash window loses that one step cleanly, and readers fall back.
``latest_step`` ignores directories whose manifest is missing or
unparseable; ``complete_steps`` / ``step_complete`` add the content check,
so resume walks newest -> oldest past torn or corrupted saves.
``with_retries`` is the bounded retry-with-backoff wrapper the drivers put
around checkpoint I/O.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import threading
import time
import warnings
from typing import Any, Callable, Optional

import numpy as np
import torch


def _leaves(tree: Any, prefix: tuple = ()):
    """(path, leaf) pairs in the reference's pytree order: dict keys
    sorted, sequences by index; None is an empty subtree."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _host(leaf: Any) -> np.ndarray:
    """A leaf as a host array; dtypes numpy lacks are stored as fp32."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        try:
            return t.numpy()
        except TypeError:                  # bf16 / fp8: no numpy dtype
            return t.float().numpy()
    arr = np.asarray(leaf)
    if arr.dtype.kind not in "fiub":
        arr = arr.astype(np.float32)
    return arr


def _flatten(tree: Any) -> dict:
    """``{path: host copy}`` of the tree's leaves (copies, so an async
    save writes what the tree held at the call)."""
    return {k: np.array(_host(v)) for k, v in _leaves(tree)}


def _sha(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for blk in iter(lambda: f.read(1 << 20), b""):
            h.update(blk)
    return h.hexdigest()


def array_sha(arr) -> str:
    """Content checksum of ONE array: dtype, shape, then the C-order bytes
    (the reference's rule, so per-array checks hold across packages)."""
    a = np.ascontiguousarray(_host(arr) if isinstance(arr, torch.Tensor)
                             else arr)
    h = hashlib.sha256()
    h.update(str(a.dtype).encode())
    h.update(str(a.shape).encode())
    h.update(a.tobytes())
    return h.hexdigest()


def with_retries(fn: Callable[[], Any], attempts: int = 3,
                 backoff: float = 0.05,
                 what: str = "checkpoint I/O") -> Any:
    """Bounded retry with exponential backoff. Retries OSError only
    (transient file-system faults); corruption and shape errors propagate
    at once. Returns ``(result, retries_used)``."""
    last = None
    for i in range(max(1, attempts)):
        try:
            return fn(), i
        except OSError as e:        # noqa: PERF203 — the retry is the point
            last = e
            if i + 1 < attempts:
                time.sleep(backoff * (2 ** i))
    raise IOError(f"{what} failed after {attempts} attempts") from last


def save(directory: str, step: int, groups: dict,
         extra: Optional[dict] = None, async_: bool = False):
    """Write step dir ``directory`` from ``groups`` (e.g. ``{'svm': {...}}``).
    Blocking unless ``async_`` (a daemon thread, returned for joining)."""
    flats = {name: _flatten(tree) for name, tree in groups.items()}

    def _do():
        parent = os.path.dirname(os.path.abspath(directory)) or "."
        os.makedirs(parent, exist_ok=True)
        tmp = tempfile.mkdtemp(dir=parent)
        manifest = {"step": int(step), "groups": {}, "extra": extra or {}}
        for name, flat in flats.items():
            fn = os.path.join(tmp, f"{name}.npz")
            np.savez(fn, **flat)
            manifest["groups"][name] = {
                "file": f"{name}.npz", "sha256": _sha(fn),
                "keys": sorted(flat.keys()),
                "array_sha256": {k: array_sha(v) for k, v in flat.items()},
            }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.isdir(directory):
            # move the old step aside before publishing the new one:
            # os.replace cannot swap non-empty dirs atomically
            trash = tempfile.mkdtemp(dir=parent)
            os.replace(directory, os.path.join(trash, "old"))
            os.replace(tmp, directory)
            shutil.rmtree(trash, ignore_errors=True)
        else:
            os.replace(tmp, directory)

    if async_:
        t = threading.Thread(target=_do, daemon=True)
        t.start()
        return t
    _do()
    return None


def load_manifest(directory: str) -> dict:
    with open(os.path.join(directory, "manifest.json")) as f:
        return json.load(f)


def _cast(arr: np.ndarray, leaf: Any, device):
    """``arr`` in the dtype of ``leaf``: a numpy array, or a tensor (on
    ``device``, else on a tensor leaf's own device)."""
    if isinstance(leaf, torch.Tensor):
        dev = leaf.device if device is None else device
        return torch.as_tensor(arr, device=dev).to(leaf.dtype)
    arr = arr.astype(np.dtype(leaf.dtype))
    return arr if device is None else torch.as_tensor(arr, device=device)


def _rebuild(like: Any, it):
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(like[k], it) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        out = [_rebuild(v, it) for v in like]
        return type(like)(out) if isinstance(like, tuple) else out
    return next(it)


def restore(directory: str, name: str, like: Any, device=None,
            verify: bool = True) -> Any:
    """Group ``name`` of step dir ``directory`` in the structure of
    ``like`` (a tree of arrays, tensors or anything with ``shape`` and
    ``dtype``). Leaves come back as numpy arrays, or as tensors on
    ``device`` (a tensor leaf of ``like`` keeps its own device when
    ``device`` is None). ``verify`` checks the file's sha256 and each
    loaded array's."""
    man = load_manifest(directory)
    info = man["groups"][name]
    fn = os.path.join(directory, info["file"])
    if verify:
        got = _sha(fn)
        if got != info["sha256"]:
            raise IOError(f"checkpoint corruption: {fn}: {got[:12]} != "
                          f"{info['sha256'][:12]}")
    arr_sha = info.get("array_sha256", {})
    out = []
    with np.load(fn) as data:
        for key, leaf in _leaves(like):
            arr = data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: shape {arr.shape} != "
                                 f"{tuple(leaf.shape)}")
            if verify and key in arr_sha and array_sha(arr) != arr_sha[key]:
                raise IOError(f"checkpoint corruption: {fn}:{key} content "
                              "checksum mismatch")
            out.append(_cast(arr, leaf, device))
    return _rebuild(like, iter(out))


def save_sharded(directory: str, step: int, groups: dict, specs: dict,
                 mesh, extra: Optional[dict] = None) -> None:
    """A step saved from a mesh, in the same format (full arrays): every
    rank gathers each leaf of each group from its blocks (``specs[name]``,
    the ``launch.sharding`` spec tree of group ``name``), rank 0 writes
    the step, and every rank returns once it is published. Collective:
    call it on every rank of the mesh."""
    from repro_torch.launch import dist
    from repro_torch.launch import sharding as shd
    host, dev = {}, None
    for name, tree in groups.items():
        flat = []
        for b, spec in zip(shd.leaves(tree), shd.leaves(specs[name])):
            dev = b.device
            flat.append(shd.gather(b, spec, mesh).cpu())
        host[name] = _rebuild(tree, iter(flat))
    if mesh.rank == 0:
        save(directory, step, host, extra)
    dist.all_reduce(torch.zeros(1, device=dev), "sum")   # published


def restore_sharded(directory: str, name: str, shapes: Any, specs: Any,
                    mesh, device=None, verify: bool = True) -> Any:
    """Group ``name`` of a step dir as this rank's blocks on a mesh:
    ``shapes`` is the group's tree of whole shapes (meta tensors will do,
    e.g. ``train_lib.shardings_for``'s), ``specs`` its spec tree. The
    step may have been saved on any mesh, or on one device: the format
    holds whole arrays, so a rescale is the same code path as a
    restart."""
    from repro_torch.launch import sharding as shd
    got = restore(directory, name, shapes, device="cpu", verify=verify)
    return shd.map_with_path(lambda _, x: x.to(device), shd.shard_tree(
        got, specs, mesh))


def step_complete(directory: str) -> bool:
    """True iff the step dir is a COMPLETE save: its manifest parses and
    every group file exists with its recorded sha256 (per-array checksums
    are verified again by :func:`restore` for the arrays it loads)."""
    try:
        man = load_manifest(directory)
        for info in man["groups"].values():
            if _sha(os.path.join(directory, info["file"])) \
                    != info["sha256"]:
                return False
    except (OSError, ValueError, KeyError):
        return False
    return True


def _step_dirs(base: str) -> list:
    out = []
    if not os.path.isdir(base):
        return out
    for d in os.listdir(base):
        if d.startswith("step_"):
            try:
                out.append((int(d.split("_")[1]), os.path.join(base, d)))
            except ValueError:
                continue
    return sorted(out)


def complete_steps(base: str) -> list:
    """Every COMPLETE step under ``base``, ascending; torn (no or
    unparseable manifest) and corrupt (file checksum mismatch) saves are
    skipped. Resume walks this list from the back."""
    return [s for s, d in _step_dirs(base) if step_complete(d)]


def latest_step(base: str) -> Optional[int]:
    """The newest step under ``base`` whose manifest parses (content not
    verified; use :func:`complete_steps` where corruption matters)."""
    steps = []
    for s, d in _step_dirs(base):
        try:
            load_manifest(d)
        except (OSError, ValueError):
            warnings.warn(f"skipping torn checkpoint dir {d}")
            continue
        steps.append(s)
    return max(steps) if steps else None
