"""Training checkpoints (PyTorch port of videoglamm_tpu/io/checkpoint.py:
the Orbax tree becomes one `torch.save` file per step).

  <dir>/<step>/state.pt       TrainState: parameters, optimizer state, step
  <dir>/<step>/metadata.json  what the caller passes (epoch, config)

Resume = `latest_step` + `restore`. Files are read back with
`torch.load(weights_only=True)`: tensors and plain containers only.

A sharded step's state (`TrainState.sharding`) is written whole: every
rank of its mesh takes part in gathering the parameters over `model` and
the moments over `data`, and the mesh's first rank writes them in the same
layout. So a sharded run's
checkpoint restores into one process and the other way round; `restore`
keeps each rank's shard of what it reads.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import torch
import torch.distributed as dist

from ..parallel import collectives
from ..parallel.mesh import DATA_AXIS
from ..training.train_step import TrainState


def _whole(state: TrainState):
    """(params, opt_state) of `state` in the unsharded layout."""
    params = {k: v.detach() for k, v in state.params.items()}
    sh = state.sharding
    if sh is None:
        return params, state.opt_state
    data = sh.mesh.axis(DATA_AXIS)

    def whole(name, t):
        if name in sh.data:
            t = torch.cat(collectives.all_gather(t, data).unbind(0))
        return sh.model[name].unshard(t) if name in sh.model else t

    params = {k: whole(k, v) if k in sh.model else v for k, v in params.items()}
    opt = {"count": state.opt_state["count"]}
    for k in ("mu", "nu"):
        opt[k] = {n: whole(n, t) for n, t in state.opt_state[k].items()}
    return params, opt


def _local(state: TrainState, params, opt):
    """The loaded whole tree cut to this rank's shards of `state`."""
    sh = state.sharding
    if sh is None:
        return params, opt

    def part(name, t):
        if name in sh.model:
            t = sh.model[name].take(t)
        if name in sh.data:
            t = t.narrow(0, *sh.data[name])
        return t

    params = {k: part(k, v) if k in sh.model else v for k, v in params.items()}
    opt = dict(opt, **{k: {n: part(n, t) for n, t in opt[k].items()}
                       for k in ("mu", "nu")})
    return params, opt


def _barrier(state: TrainState):
    """Hold the mesh's ranks until its first rank has written."""
    if state.sharding is not None and state.sharding.mesh.group is not None:
        dist.barrier(group=state.sharding.mesh.group)


def _copy_into(dst, src, where: str):
    """Copy the loaded tree `src` into the live tree `dst` (tensors in
    place, on their own devices); returns the merged tree."""
    if isinstance(dst, torch.Tensor):
        if dst.shape != src.shape:
            raise ValueError(f"checkpoint: {where}: shape {tuple(src.shape)} "
                             f"does not fit {tuple(dst.shape)}")
        with torch.no_grad():
            dst.copy_(src)
        return dst
    if isinstance(dst, dict):
        if set(dst) != set(src):
            raise ValueError(f"checkpoint: {where}: keys differ "
                             f"({sorted(set(dst) ^ set(src))[:8]})")
        return {k: _copy_into(v, src[k], f"{where}.{k}") for k, v in dst.items()}
    return src


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _steps(self):
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.exists(
                          os.path.join(self.directory, d, "state.pt")))

    def save(self, step: int, state: TrainState,
             metadata: Optional[dict] = None):
        """Write the whole state (model, optimizer state, step) under
        <dir>/<step>, then prune to the newest `max_to_keep` steps. A
        sharded state: every rank of its mesh calls this, the first one
        writes."""
        params, opt_state = _whole(state)
        if state.sharding is None or state.sharding.mesh.is_first:
            self._write(step, state.step, params, opt_state, metadata)
        _barrier(state)

    def _write(self, step, state_step, params, opt_state, metadata):
        final = os.path.join(self.directory, str(int(step)))
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save({"step": int(state_step), "params": params,
                    "opt_state": opt_state},
                   os.path.join(tmp, "state.pt"))
        if metadata is not None:
            with open(os.path.join(tmp, "metadata.json"), "w") as f:
                json.dump(metadata, f)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in self._steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, state_like: TrainState,
                step: Optional[int] = None) -> TrainState:
        """Restore into the live tensors of `state_like` (parameters and
        Adam moments are overwritten in place; a sharded state's shards cut
        from the whole) and return the state."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        loaded = torch.load(os.path.join(self.directory, str(step), "state.pt"),
                            map_location="cpu", weights_only=True, mmap=True)
        src_params, src_opt = _local(state_like, loaded["params"],
                                     loaded["opt_state"])
        params = _copy_into(state_like.params, src_params, "params")
        opt_state = _copy_into(state_like.opt_state, src_opt, "opt_state")
        return TrainState(int(loaded["step"]), params, opt_state,
                          state_like.sharding)

    def restore_metadata(self, step: Optional[int] = None) -> dict:
        step = self.latest_step() if step is None else step
        with open(os.path.join(self.directory, str(step), "metadata.json")) as f:
            return json.load(f)

    def close(self):
        pass


def save_params(directory: str, params: Any):
    """One-shot export of a parameter tree (inference checkpoints)."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    params = {k: v.detach() for k, v in dict(params).items()}
    torch.save(params, os.path.join(directory, "params.pt"))


def load_params(directory: str, params_like: Optional[Any] = None) -> Any:
    """Read `save_params`' tree; with `params_like`, copy it into those
    tensors in place and return them."""
    loaded = torch.load(os.path.join(os.path.abspath(directory), "params.pt"),
                        map_location="cpu", weights_only=True, mmap=True)
    if params_like is None:
        return loaded
    return _copy_into(dict(params_like), loaded, "params")
