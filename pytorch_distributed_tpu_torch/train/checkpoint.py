"""Checkpoint save and load in the npz format: the port of the JAX
package's ``train/checkpoint.py``, writing the JAX package's layout and
keys, so a checkpoint either side writes, the other resumes.

One ``arrays.npz`` holds the train state's leaves keyed by their JAX tree
path: the params through ``interop.params_to_jax`` (``params/wte``,
``params/blocks/attn/c_attn/kernel`` stacked [L, ...], ...), the optimizer
state as the JAX optax chain lays it out (``opt_state/1/count``,
``opt_state/1/mu/...``, ``opt_state/1/nu/...`` for ``scale_by_adam``,
``opt_state/3/count`` for the schedule; the chain's other elements hold no
arrays), and ``step``, counts as int32 scalars. The keys are built here
without optax or JAX. A ``meta.json`` sidecar carries the caller's metadata
(the step and the loader's position).

**Integrity contract**, as in the JAX package: a save writes a per-leaf
crc32 ``manifest.json`` (meta.json's crc32 included) and a ``COMMIT``
marker inside a temporary directory that is renamed into place, the old
checkpoint parked in a ``.trash_`` sibling during the swap, so no crash
destroys both generations. ``list_checkpoints``/``latest_checkpoint``
return only committed directories, and ``load_checkpoint`` verifies the
manifest first and raises ``CheckpointCorrupt`` on a mismatch;
``Trainer.resume_latest`` then falls back to the next-older checkpoint.

Not ported yet (ROADMAP queue 1 item 5): the orbax format and the async
save; both raise ``NotImplementedError``.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import zlib
from pathlib import Path

import numpy as np
import torch

from pytorch_distributed_tpu_torch import interop
from pytorch_distributed_tpu_torch.config import ModelConfig, TrainConfig
from pytorch_distributed_tpu_torch.train.optim import make_optimizer
from pytorch_distributed_tpu_torch.train.state import (
    TrainState,
    init_train_state,
)
from pytorch_distributed_tpu_torch.utils import tree

COMMIT_NAME = "COMMIT"
MANIFEST_NAME = "manifest.json"
# The optax chain's element holding (count, mu, nu), and the schedule's.
_ADAM, _SCHEDULE = "opt_state/1", "opt_state/3"
_UNPORTED = ("not ported yet (ROADMAP queue 1 item 5): the port writes the "
             "npz format synchronously")


class CheckpointCorrupt(RuntimeError):
    """The checkpoint directory fails its integrity contract: missing
    COMMIT marker, missing/unreadable payload, or a checksum mismatch
    against its manifest."""


def _crc32(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


def _flatten(prefix: str, nested, out: dict) -> None:
    """Leaves of a nested dict keyed ``prefix/a/b``, keys sorted at every
    level (the JAX tree flattening order)."""
    if isinstance(nested, dict):
        for k in sorted(nested):
            _flatten(f"{prefix}/{k}", nested[k], out)
    else:
        out[prefix] = np.asarray(nested)


def _unflatten(prefix: str, arrays: dict) -> dict:
    """The nested dict of every ``prefix/...`` key (the inverse of
    ``_flatten``)."""
    nested: dict = {}
    for key, a in arrays.items():
        if not key.startswith(prefix + "/"):
            continue
        *path, leaf = key[len(prefix) + 1:].split("/")
        node = nested
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = a
    return nested


def _state_arrays(state: TrainState, cfg: ModelConfig) -> dict:
    """The train state as the JAX checkpoint's {key: numpy array}, in the
    JAX flattening order."""
    opt = state.opt_state
    out: dict = {}
    _flatten("params", interop.params_to_jax(state.params, cfg), out)
    out[f"{_ADAM}/count"] = np.asarray(opt["count"], np.int32)
    _flatten(f"{_ADAM}/mu", interop.params_to_jax(opt["mu"], cfg), out)
    _flatten(f"{_ADAM}/nu", interop.params_to_jax(opt["nu"], cfg), out)
    out[f"{_SCHEDULE}/count"] = np.asarray(opt["schedule_count"], np.int32)
    out["step"] = np.asarray(state.step, np.int32)
    return out


def _write_commit(tmp: Path) -> None:
    (tmp / COMMIT_NAME).write_text('{"format": "pdtpu-ckpt-commit-v1"}\n')


def _swap_into_place(tmp: Path, directory: Path) -> None:
    """Publish ``tmp`` as ``directory``: the previous generation is parked
    in a ``.trash_`` sibling for the swap (a crash between the two renames
    leaves the old data there, and no half directory at the final name)
    and removed after."""
    trash = directory.parent / (".trash_" + directory.name)
    if trash.exists():
        shutil.rmtree(trash)
    if directory.exists():
        os.replace(directory, trash)
    os.replace(tmp, directory)
    shutil.rmtree(trash, ignore_errors=True)


def save_checkpoint(directory: str | Path, state: TrainState,
                    cfg: ModelConfig, *, metadata: dict | None = None,
                    format: str = "auto") -> str:
    """Write ``state`` (the port's TrainState of a ``cfg`` model) as a JAX
    npz checkpoint. ``format`` "auto" and "npz" are the same here (one
    process holds every tensor)."""
    if format == "orbax":
        raise NotImplementedError(f"the orbax checkpoint format is "
                                  f"{_UNPORTED}")
    if format not in ("auto", "npz"):
        raise ValueError(f"unknown checkpoint format {format!r}")
    directory = Path(directory)
    os.makedirs(directory.parent, exist_ok=True)
    arrays = _state_arrays(state, cfg)
    tmp = Path(tempfile.mkdtemp(dir=directory.parent, prefix=".ckpt_tmp_"))
    try:
        np.savez(tmp / "arrays.npz", **arrays)
        meta_text = json.dumps(
            {"format": "pdtpu-ckpt-v1", "keys": sorted(arrays),
             "metadata": metadata or {}},
            indent=1,
        )
        (tmp / "meta.json").write_text(meta_text)
        manifest = {
            "format": "pdtpu-ckpt-manifest-v1",
            "meta_crc32": _crc32(meta_text.encode()),
            "leaves": {
                k: {"crc32": _crc32(np.ascontiguousarray(a).tobytes()),
                    "shape": list(a.shape), "dtype": str(a.dtype)}
                for k, a in arrays.items()
            },
        }
        (tmp / MANIFEST_NAME).write_text(json.dumps(manifest, indent=1))
        _write_commit(tmp)
        _swap_into_place(tmp, directory)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return str(directory)


def save_checkpoint_async(*args, **kwargs):
    raise NotImplementedError(f"the async checkpoint save is {_UNPORTED}")


def is_committed(directory: str | Path) -> bool:
    return (Path(directory) / COMMIT_NAME).is_file()


def _load_manifest(directory: Path) -> dict:
    """COMMIT + manifest + meta.json checks (the cheap, non-payload part
    of verification); returns the parsed manifest."""
    if not is_committed(directory):
        raise CheckpointCorrupt(
            f"checkpoint {directory} has no {COMMIT_NAME} marker "
            "(half-written save or pre-integrity format)"
        )
    try:
        manifest = json.loads((directory / MANIFEST_NAME).read_text())
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointCorrupt(
            f"checkpoint {directory}: unreadable {MANIFEST_NAME}: {e}"
        ) from e
    want_meta = manifest.get("meta_crc32")
    if want_meta is not None:
        try:
            meta_bytes = (directory / "meta.json").read_bytes()
        except OSError as e:
            raise CheckpointCorrupt(
                f"checkpoint {directory}: unreadable meta.json: {e}"
            ) from e
        got = _crc32(meta_bytes)
        if got != want_meta:
            raise CheckpointCorrupt(
                f"checkpoint {directory}: meta.json checksum mismatch "
                f"(manifest {want_meta}, file {got}) — the loader "
                "position would be untrustworthy"
            )
    return manifest


def _load_npz_arrays(directory: Path) -> dict:
    try:
        with np.load(directory / "arrays.npz") as data:
            return {k: data[k] for k in data.files}
    except Exception as e:  # zip/format damage surfaces many ways
        raise CheckpointCorrupt(
            f"checkpoint {directory}: unreadable arrays.npz: {e}"
        ) from e


def _verify_npz_leaves(directory: Path, manifest: dict, arrays: dict) -> None:
    for key, want in manifest["leaves"].items():
        if key not in arrays:
            raise CheckpointCorrupt(
                f"checkpoint {directory}: leaf {key!r} missing from "
                "arrays.npz"
            )
        got = _crc32(np.ascontiguousarray(arrays[key]).tobytes())
        if got != want["crc32"]:
            raise CheckpointCorrupt(
                f"checkpoint {directory}: leaf {key!r} checksum "
                f"mismatch (manifest {want['crc32']}, file {got})"
            )


def verify_checkpoint(directory: str | Path) -> None:
    """Integrity check without a restore: COMMIT present, manifest present,
    meta.json and every leaf checksum matching. Raises ``CheckpointCorrupt``
    naming the first offending leaf or file."""
    directory = Path(directory)
    manifest = _load_manifest_npz(directory)
    _verify_npz_leaves(directory, manifest, _load_npz_arrays(directory))


def _load_manifest_npz(directory: Path) -> dict:
    if (directory / "tree").exists():
        raise NotImplementedError(f"{directory} is an orbax checkpoint: the "
                                  f"orbax format is {_UNPORTED}")
    return _load_manifest(directory)


def _restore_like(key: str, got: torch.Tensor, like: torch.Tensor):
    if tuple(got.shape) != tuple(like.shape):
        raise ValueError(
            f"checkpoint leaf {key!r} shape {tuple(got.shape)} != expected "
            f"{tuple(like.shape)}"
        )
    if like.dtype == torch.bfloat16 and got.dtype in (torch.uint16,
                                                      torch.int16):
        got = got.view(torch.bfloat16)  # a raw bf16 payload
    return got.to(like.device, like.dtype)


def _restore_tree(prefix: str, arrays: dict, like_tree, cfg: ModelConfig):
    """A port params-shaped tree from the ``prefix/...`` keys, each leaf
    placed and typed like ``like_tree``'s."""
    try:
        got = interop.params_from_jax(_unflatten(prefix, arrays), cfg)
    except KeyError as e:
        raise KeyError(f"checkpoint missing leaf {prefix}/{e.args[0]}; has "
                       f"{len(arrays)} leaves") from e
    by_path = dict(tree.leaves_with_path(got))
    out = []
    for path, like in tree.leaves_with_path(like_tree):
        key = "/".join(map(str, (prefix, *path)))
        if path not in by_path:
            raise KeyError(f"checkpoint missing leaf {key!r}; has "
                           f"{len(arrays)} leaves")
        out.append(_restore_like(key, by_path[path], like))
    return tree.unflatten(like_tree, out)


def load_checkpoint(directory: str | Path, like: TrainState,
                    cfg: ModelConfig) -> TrainState:
    """Restore a checkpoint (written by either package) into the structure,
    dtypes and devices of ``like`` (a port TrainState, e.g. a fresh
    ``Trainer.init_state()``). The integrity manifest is checked first
    (``CheckpointCorrupt`` on damage); the npz payload is read once, and
    the checksums are taken on the arrays the restore uses."""
    directory = Path(directory)
    manifest = _load_manifest_npz(directory)
    arrays = _load_npz_arrays(directory)
    _verify_npz_leaves(directory, manifest, arrays)
    for key in (f"{_ADAM}/count", f"{_SCHEDULE}/count", "step"):
        if key not in arrays:
            raise KeyError(f"checkpoint {directory} missing leaf {key!r}; "
                           f"has {len(arrays)} leaves")
    opt = like.opt_state
    return TrainState(
        params=_restore_tree("params", arrays, like.params, cfg),
        opt_state=dict(
            opt,
            count=int(arrays[f"{_ADAM}/count"]),
            mu=_restore_tree(f"{_ADAM}/mu", arrays, opt["mu"], cfg),
            nu=_restore_tree(f"{_ADAM}/nu", arrays, opt["nu"], cfg),
            schedule_count=int(arrays[f"{_SCHEDULE}/count"]),
        ),
        step=int(arrays["step"]),
    )


def load_params_checkpoint(directory: str | Path, params,
                           cfg: ModelConfig):
    """The params of a checkpoint, restored into the structure, dtypes and
    devices of ``params`` (the generation and serving twins' weights;
    the optimizer state that ``load_checkpoint`` restores with them is
    dropped)."""
    tx = make_optimizer(TrainConfig(
        global_batch_size=1, micro_batch_size=1, num_steps=1,
        learning_rate=1e-4,
    ))
    like = init_train_state(params, tx)
    return load_checkpoint(directory, like, cfg).params


def read_metadata(directory: str | Path) -> dict:
    meta = json.loads((Path(directory) / "meta.json").read_text())
    return meta.get("metadata", {})


def _step_dirs(root: Path) -> list[tuple[int, Path]]:
    steps: list[tuple[int, Path]] = []
    for child in root.iterdir():
        if child.is_dir() and child.name.startswith("checkpoint_step_"):
            try:
                steps.append((int(child.name.rsplit("_", 1)[1]), child))
            except ValueError:
                continue
    return steps


def _step_dirs_by_commit(checkpoint_root: str | Path, *,
                         committed: bool) -> list[str]:
    root = Path(checkpoint_root)
    if not root.exists():
        return []
    steps = [(s, p) for s, p in _step_dirs(root)
             if is_committed(p) == committed]
    steps.sort(reverse=True)
    return [str(p) for _, p in steps]


def list_checkpoints(checkpoint_root: str | Path) -> list[str]:
    """COMMITTED ``checkpoint_step_{n}`` dirs, newest first — the fallback
    order ``Trainer.resume_latest`` walks when the newest one fails
    verification."""
    return _step_dirs_by_commit(checkpoint_root, committed=True)


def uncommitted_checkpoints(checkpoint_root: str | Path) -> list[str]:
    """``checkpoint_step_{n}`` dirs WITHOUT a COMMIT marker: half-written
    saves. Never resumable; surfaced so ``Trainer.resume_latest`` can warn
    instead of silently restarting from scratch next to them."""
    return _step_dirs_by_commit(checkpoint_root, committed=False)


def prune_checkpoints(checkpoint_root: str | Path, keep: int) -> list[str]:
    """Delete all but the newest ``keep`` ``checkpoint_step_{n}`` dirs, and
    sweep ``.trash_`` leftovers of a swap and temporary save dirs orphaned
    by a crash mid-save. Call after a completed save (no save is then in
    flight). Returns the removed paths."""
    if keep < 1:
        raise ValueError(f"keep must be >= 1, got {keep}")
    root = Path(checkpoint_root)
    if not root.exists():
        return []
    for child in root.iterdir():
        if child.is_dir() and child.name.startswith(
                (".trash_", ".ckpt_tmp_", ".tmp_")):
            shutil.rmtree(child, ignore_errors=True)
    steps = sorted(_step_dirs(root), reverse=True)
    removed = []
    for _, path in steps[keep:]:
        shutil.rmtree(path, ignore_errors=True)
        removed.append(str(path))
    return removed


def latest_checkpoint(checkpoint_root: str | Path) -> str | None:
    """The newest COMMITTED ``checkpoint_step_{n}`` dir; half-written
    directories (no COMMIT marker) are never returned."""
    newest = list_checkpoints(checkpoint_root)
    return newest[0] if newest else None
