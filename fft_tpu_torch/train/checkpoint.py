"""Checkpoint and resume (mirror of ``fft_tpu/train/checkpoint.py``).

The JAX package stores its train state with orbax; here ``torch.save``
writes plain dicts of tensors, read back with ``torch.load(weights_only=
True)``.  The layout is the JAX package's: one directory ``root/<step>/``
a checkpoint, the newest ``keep`` kept.  Each holds

- ``model.pt``: the model's ``state_dict()`` (parameters and buffers);
- ``train.pt``: AdamW's ``mu`` and ``nu`` keyed by parameter name, its
  ``count``, ``TrainState.step``, and the dropout generator's state with
  its device type.

``generate`` reads ``model.pt`` alone, so serving never loads the
optimizer's moments.  A checkpoint is written into a directory whose name
is not a number, then renamed to ``<step>``: a crash in mid-write leaves
nothing that ``latest_step`` (and so ``--resume``) would pick up.

Restoring copies into the tensors the state already holds, in place: the
optimizer keeps the model's ``Parameter`` objects (``AdamW.params``), so
new Parameters would leave it stepping orphans.  Files are read on the
CPU and then copied, so the card never holds two copies.

A sharded run (``fft_tpu_torch.parallel``) writes its checkpoint gathered,
in this same format: ``snapshot``'s ``gather`` turns each rank's shard of
the model and of the moments into the full state (every rank calls it, the
primary alone writes), and ``restore_checkpoint``'s ``shard`` cuts a full
checkpoint down to a rank's shard, so a run resumes at any layout and
``generate`` reads it.
"""

from __future__ import annotations

import os
import pathlib
import shutil
import threading
from typing import Callable, Dict, Optional

import torch

from fft_tpu_torch.train.loop import TrainState

MODEL_FILE = "model.pt"
TRAIN_FILE = "train.pt"


def _path(root) -> pathlib.Path:
    return pathlib.Path(root).absolute()


def _steps(root: pathlib.Path):
    return [int(p.name) for p in root.iterdir()
            if p.is_dir() and p.name.isdigit()]


def _prune(root: pathlib.Path, keep: int) -> None:
    for old in sorted(_steps(root))[:-keep]:
        shutil.rmtree(root / str(old), ignore_errors=True)


def _host(t: torch.Tensor) -> torch.Tensor:
    # always a copy: .cpu() of a CPU tensor is the tensor itself, which the
    # next optimizer step would update in place
    return t.detach().to("cpu", copy=True)


def _param_names(state: TrainState):
    """The model's name of each parameter the optimizer holds, in order."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    return [names[id(p)] for p in state.optimizer.params]


ShardMap = Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]


def snapshot(state: TrainState, gather: Optional[ShardMap] = None
             ) -> Dict[str, dict]:
    """A host copy of everything a resume needs: {file name: contents}.
    Synchronous, so it sees the state of the step that just ended.
    ``gather`` maps a rank's shard of a state (model, or moments keyed by
    parameter name) to the full one."""
    opt = state.optimizer
    names = _param_names(state)
    full = gather or (lambda sd: sd)

    def host(sd):
        return {k: _host(v) for k, v in full(sd).items()}

    return {
        MODEL_FILE: host(state.model.state_dict()),
        TRAIN_FILE: {
            "mu": host(dict(zip(names, opt.mu))),
            "nu": host(dict(zip(names, opt.nu))),
            "count": int(opt.count),
            "step": int(state.step),
            "generator": {"device": state.generator.device.type,
                          "state": state.generator.get_state()},
        },
    }


def _write(root: pathlib.Path, files: Dict[str, dict], step: int,
           keep: int) -> str:
    """Write ``files`` under root/<step> through a temporary directory,
    then prune to the newest ``keep``."""
    root.mkdir(parents=True, exist_ok=True)
    final = root / str(step)
    tmp = root / f"tmp.{step}.{os.getpid()}.{threading.get_ident()}"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir()
    try:
        for name, obj in files.items():
            with open(tmp / name, "wb") as f:
                torch.save(obj, f)
                f.flush()
                os.fsync(f.fileno())
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _prune(root, keep)
    return str(final)


def save_checkpoint(root, state: TrainState, step: int, *,
                    keep: int = 3) -> str:
    """Save ``state`` under root/<step>.  Returns the path."""
    return _write(_path(root), snapshot(state), step, keep)


class AsyncCheckpointWriter:
    """Overlap checkpoint writes with training.

    ``save`` snapshots the state to host memory synchronously (the only
    part that must see a consistent view), then writes it to disk on a
    background thread while the train loop keeps stepping.  At most one
    write is in flight; a second ``save`` first joins the previous write,
    so checkpoints land in step order.  A write's error is raised by the
    next ``wait`` or ``save``.  Call ``wait`` (or use as a context
    manager) before reading ``latest_step`` or exiting.

    ``gather`` (a sharded run): see ``snapshot``; every rank calls
    ``save``, and only a writer made with ``write=True`` (the primary's)
    writes.
    """

    def __init__(self, root, *, keep: int = 3,
                 gather: Optional[ShardMap] = None, write: bool = True):
        self._root = _path(root)
        self._keep = keep
        self._gather = gather
        self._write = write
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, state: TrainState, step: int) -> None:
        self.wait()
        files = snapshot(state, self._gather)
        if not self._write:
            return
        self._root.mkdir(parents=True, exist_ok=True)

        def _run():
            try:
                _write(self._root, files, step, self._keep)
            except BaseException as e:   # surfaced on the next wait/save
                self._error = e

        # non-daemon: an in-flight write completes (or fails loudly on the
        # next wait) even if the caller exits without draining; a daemon
        # thread would be killed at interpreter shutdown, silently losing
        # the checkpoint
        self._thread = threading.Thread(target=_run, daemon=False)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.wait()
        return False


def latest_step(root) -> Optional[int]:
    root = _path(root)
    if not root.exists():
        return None
    steps = _steps(root)
    return max(steps) if steps else None


def _step_dir(root, step: Optional[int]) -> pathlib.Path:
    root = _path(root)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    return root / str(step)


def _load(path: pathlib.Path) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_model(root, model: torch.nn.Module,
                  step: Optional[int] = None,
                  shard: Optional[ShardMap] = None) -> torch.nn.Module:
    """Copy the model entry of root/<step> (``None``: the latest) into
    ``model`` in place, cut to a rank's shard by ``shard``; a checkpoint of
    another preset or width raises (``load_state_dict(strict=True)``)."""
    sd = _load(_step_dir(root, step) / MODEL_FILE)
    model.load_state_dict(shard(sd) if shard else sd, strict=True)
    return model


def restore_checkpoint(root, target: TrainState,
                       step: Optional[int] = None,
                       shard: Optional[ShardMap] = None) -> TrainState:
    """Restore root/<step> (``None``: the latest) into ``target`` in place:
    the model, the optimizer's moments and count, the step and the
    dropout generator, each state cut to this rank's shard by ``shard``
    (a sharded run).  Returns ``target``."""
    path = _step_dir(root, step)
    train = _load(path / TRAIN_FILE)
    if shard:
        train["mu"], train["nu"] = shard(train["mu"]), shard(train["nu"])
    gen = train["generator"]
    if gen["device"] != target.generator.device.type:
        raise ValueError(
            f"checkpoint {path}: its dropout generator is a {gen['device']} "
            f"generator, this state's is a {target.generator.device.type} "
            "one; a generator's state does not load across device types")
    opt = target.optimizer
    names = _param_names(target)
    for key, live in (("mu", opt.mu), ("nu", opt.nu)):
        saved = train[key]
        if sorted(saved) != sorted(names):
            raise ValueError(f"checkpoint {path}: {key} holds other "
                             "parameters than this model")
        for n, t in zip(names, live):
            if saved[n].shape != t.shape:
                raise ValueError(f"checkpoint {path}: {key}[{n}] has shape "
                                 f"{tuple(saved[n].shape)}, the model's "
                                 f"{tuple(t.shape)}")
    restore_model(root, target.model, int(path.name), shard)
    with torch.no_grad():
        for key, live in (("mu", opt.mu), ("nu", opt.nu)):
            for n, t in zip(names, live):
                t.copy_(train[key][n])
    opt.count = int(train["count"])
    target.step = int(train["step"])
    target.generator.set_state(gen["state"])
    return target
