"""Checkpoint manager: async, atomic, retained, corruption-tolerant.

* **Atomic**: write to ``tmp-step_N/`` then ``os.replace``: a crash
  mid-save never corrupts the latest checkpoint (restore scans for complete
  directories, and stale tmp directories are removed).
* **Corruption-tolerant**: ``latest_step`` and ``restore`` skip checkpoints
  whose manifest or arrays fail to load and fall back to the previous step,
  so a torn write costs one checkpoint interval, not the run.
* **Async**: ``save()`` snapshots the tensors to host memory in the calling
  thread and writes them in a background thread, so the train loop is not
  held up by the disk.
* **Logical layout**: one ``.npy`` per leaf keyed by its path in the state,
  and a JSON manifest with the step, the metadata and each leaf's dtype.
  numpy has no bfloat16, so a bf16 leaf is stored as its raw 16 bits
  (``view(torch.int16)``) and restored bit for bit.  The keys are the
  port's own (``params/layers.0.wq``, ``opt/master/embed``): a module's
  leaves are its named parameters, a dataclass's its fields.
* **Retention**: keep the last ``keep`` checkpoints, delete older ones.
* **Sharded states**: ``save(..., specs=...)`` on every rank of a mesh
  gathers each leaf its spec splits to its logical (whole) array; rank 0
  writes and the others wait at a barrier, so a checkpoint has the same
  layout whatever mesh saved it.  ``restore_resharded`` gives each rank its
  slice of every leaf under the *target* mesh's specs (elastic restore).
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import shutil
import threading
from typing import Any, Callable, Mapping

import numpy as np
import torch
import torch.nn as nn

from repro_torch.dist import ranks


def _flatten_with_paths(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    if isinstance(tree, nn.Module):
        return [(prefix + name, p) for name, p in tree.named_parameters()]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        items = [(f.name, getattr(tree, f.name))
                 for f in dataclasses.fields(tree)]
    elif isinstance(tree, Mapping):
        items = list(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = [(f"[{i}]", v) for i, v in enumerate(tree)]
    else:
        return [(prefix.rstrip("/"), tree)]
    return [kv for k, v in items
            for kv in _flatten_with_paths(v, f"{prefix}{k}/")]


def _unflatten(template: Any, leaves: dict, prefix: str = "") -> Any:
    """``template``'s structure with ``leaves[key]`` at each leaf.  A module
    is copied with new parameters in place of its own (``requires_grad`` as
    the template's), so no parameter of the template is copied."""
    if isinstance(template, nn.Module):
        memo = {id(p): nn.Parameter(leaves[prefix + name],
                                    requires_grad=p.requires_grad)
                for name, p in template.named_parameters()}
        return copy.deepcopy(template, memo)
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return type(template)(**{
            f.name: _unflatten(getattr(template, f.name), leaves,
                               f"{prefix}{f.name}/")
            for f in dataclasses.fields(template)})
    if isinstance(template, Mapping):
        return {k: _unflatten(v, leaves, f"{prefix}{k}/")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves, f"{prefix}[{i}]/")
                              for i, v in enumerate(template))
    return leaves[prefix.rstrip("/")]


def _to_host(leaf: Any) -> torch.Tensor:
    """A host copy of ``leaf``, which later in-place updates of the state
    do not reach."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return torch.from_numpy(np.array(leaf))


def _file(key: str) -> str:
    return key.replace("/", "__") + ".npy"


def _flatten_specs(specs: Any, prefix: str = "") -> dict[str, Any]:
    """Key -> partition spec, keyed as ``_flatten_with_paths`` keys the
    state: a spec (a tuple) is a leaf."""
    if isinstance(specs, tuple) or specs is None:
        return {prefix.rstrip("/"): specs}
    if dataclasses.is_dataclass(specs) and not isinstance(specs, type):
        items = [(f.name, getattr(specs, f.name))
                 for f in dataclasses.fields(specs)]
    elif isinstance(specs, Mapping):
        items = list(specs.items())
    else:
        items = [(f"[{i}]", v) for i, v in enumerate(specs)]
    out: dict[str, Any] = {}
    for k, v in items:
        out.update(_flatten_specs(v, f"{prefix}{k}/"))
    return out


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    # -- save ----------------------------------------------------------------

    def save(self, step: int, state: Any, metadata: dict | None = None,
             blocking: bool = False, specs: Any = None) -> None:
        """Snapshot to host memory now; write in the background.

        With ``specs`` (a tree of partition specs shaped as ``state``, such
        as ``train_state_specs``) every rank of the current mesh calls this
        with its part of a sharded state: each leaf in turn is gathered
        whole on the mesh's first rank alone (``ranks.spec_gather_first``)
        and copied to its host memory, that rank writes them and the others
        wait at a barrier until they are written (such a save is always
        blocking)."""
        self.wait()  # one in-flight save at a time
        leaves = _flatten_with_paths(state)
        if specs is not None:
            flat = _flatten_specs(specs)
            writer = ranks.axis_index(
                tuple(ranks.current_mesh().mesh_dim_names)) == 0
            host_leaves = []
            for k, v in leaves:
                if isinstance(v, torch.Tensor):
                    v = ranks.spec_gather_first(v, flat[k])
                if writer:
                    host_leaves.append((k, _to_host(v)))
                del v
            del leaves
            if not writer:
                ranks.barrier()
                return
        else:
            host_leaves = [(k, _to_host(v)) for k, v in leaves]
            del leaves
        meta = dict(metadata or {})
        meta["step"] = int(step)

        def work():
            try:
                # The tmp- prefix keeps in-flight writes out of the step_*
                # scans; os.replace makes publication atomic.
                tmp = os.path.join(self.directory, f"tmp-step_{step:08d}")
                final = os.path.join(self.directory, f"step_{step:08d}")
                if os.path.exists(tmp):
                    shutil.rmtree(tmp)
                os.makedirs(tmp)
                dtypes = {}
                for key, t in host_leaves:
                    dtypes[key] = str(t.dtype).removeprefix("torch.")
                    if t.dtype == torch.bfloat16:
                        t = t.view(torch.int16)
                    np.save(os.path.join(tmp, _file(key)), t.numpy())
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump({"meta": meta,
                               "keys": [k for k, _ in host_leaves],
                               "dtypes": dtypes}, f)
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.replace(tmp, final)
                self._gc()
            except Exception as e:  # surfaced by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        if blocking or specs is not None:
            self.wait()
        if specs is not None:
            ranks.barrier()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(self.available_steps())
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(
                os.path.join(self.directory, f"step_{s:08d}"),
                ignore_errors=True,
            )
        for name in os.listdir(self.directory):  # stale in-flight writes
            if name.startswith("tmp-step_"):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)

    # -- restore -------------------------------------------------------------

    def _manifest_ok(self, step: int) -> bool:
        """A checkpoint is loadable only if its manifest parses and every
        leaf file it lists exists (a torn write fails both ways)."""
        path = os.path.join(self.directory, f"step_{step:08d}")
        try:
            with open(os.path.join(path, "manifest.json")) as f:
                manifest = json.load(f)
            return all(os.path.exists(os.path.join(path, _file(key)))
                       for key in manifest["keys"])
        except (OSError, ValueError, KeyError, TypeError):
            return False

    def available_steps(self, verify: bool = False) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(
                    os.path.join(self.directory, name, "manifest.json")
                ):
                    out.append(int(name.split("_")[1]))
        out = sorted(out)
        if verify:
            out = [s for s in out if self._manifest_ok(s)]
        return out

    def latest_step(self) -> int | None:
        """Latest *loadable* step: corrupted checkpoints (unparseable
        manifest, missing leaves) are skipped, falling back to the previous
        step instead of handing the supervisor a restore that will crash."""
        steps = self.available_steps(verify=True)
        return steps[-1] if steps else None

    def restore(
        self,
        template: Any,
        step: int | None = None,
        put: Callable[[str, torch.Tensor], Any] | None = None,
    ) -> tuple[Any, dict]:
        """Restore into the structure of ``template``.  ``put`` maps (key,
        host tensor) to the leaf; by default each leaf goes to the template
        leaf's device and dtype.

        With ``step=None`` the newest loadable checkpoint is used; ones
        that fail to load (torn manifest, truncated ``.npy``) are skipped
        newest to oldest and recorded in ``self.skipped``.  An explicit
        ``step`` that fails still raises: the caller asked for exactly that
        one."""
        self.skipped: list[tuple[int, str]] = []
        if step is not None:
            return self._restore_step(template, step, put)
        candidates = self.available_steps(verify=True)
        if not candidates:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        for s in reversed(candidates):
            try:
                return self._restore_step(template, s, put)
            except Exception as exc:  # noqa: BLE001 - fall back one step
                self.skipped.append((s, repr(exc)))
        raise FileNotFoundError(
            f"no loadable checkpoint in {self.directory}; "
            f"skipped: {self.skipped}"
        )

    def _restore_step(
        self,
        template: Any,
        step: int,
        put: Callable[[str, torch.Tensor], Any] | None,
    ) -> tuple[Any, dict]:
        path = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        dtypes = manifest.get("dtypes", {})

        restored = {}
        for key, tmpl in _flatten_with_paths(template):
            host = torch.from_numpy(np.load(os.path.join(path, _file(key))))
            if dtypes.get(key) == "bfloat16":
                host = host.view(torch.bfloat16)
            if put is not None:
                restored[key] = put(key, host)
            else:
                restored[key] = host.to(device=tmpl.device, dtype=tmpl.dtype)
        return _unflatten(template, restored), manifest["meta"]


def restore_resharded(
    manager: CheckpointManager,
    template: Any,
    specs: Any,  # a tree of partition specs shaped as the template
    mesh,
    step: int | None = None,
) -> tuple[Any, dict]:
    """Elastic restore: each rank of ``mesh`` (a ``DeviceMesh``) gets its
    slice of every leaf under ``specs`` on that mesh, whatever mesh saved
    the checkpoint (its layout is logical); ``mesh`` None gives whole
    leaves.  Each leaf goes to the template leaf's device and dtype."""
    flat = _flatten_specs(specs)
    devices = {k: t for k, t in _flatten_with_paths(template)}

    def put(key, host):
        tmpl = devices[key]
        spec = flat.get(key)
        if mesh is not None and spec is not None:
            with ranks.use_mesh(mesh):
                host = ranks.spec_slice(host, spec)
        return host.to(device=tmpl.device, dtype=tmpl.dtype, copy=True)

    return manager.restore(template, step=step, put=put)
