"""Checkpoints of the whole train state: the port of
``mdctgan_tpu/train/checkpoint.py``, with ``torch.save`` as the format.

One file ``step_<N>.pt`` per save holds G's and D's parameters and buffers
(the BatchNorm running statistics), both optimizers' state beside the names
of the parameters each one trains, the step and the step at which G's
accumulation window began, each net's gradients of an update still being
accumulated, and the cursor ``{epoch, epoch_iter,
units_samples}`` (``epoch_iter`` counts samples, as the reference's
``iter.txt`` does).  ``epoch_index.json`` maps each epoch-end save to its
step, so ``--which_epoch N`` finds it.  The JAX package's ``ckpt/`` holds
orbax step directories instead, never ``step_*.pt`` files, which is how
``is_port_checkpoint`` tells the two apart.

Saves are asynchronous: ``save`` copies the state to the host (the live
tensors move on at the next step) and a thread writes it; the next save,
every read and ``close`` wait for that write first.

Under data parallelism every rank holds the same state and restores from
the same directory, and only rank 0's manager (``writer``) writes: the
saves and ``epoch_index.json``, as the JAX package's process 0 writes its
index.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import threading
import time
from typing import Dict, List, Mapping, Optional, Tuple, Union

import torch

from mdctgan_tpu_torch.train.state import GANTrainState

FORMAT = "mdctgan_tpu_torch"
_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


def is_port_checkpoint(directory: str) -> bool:
    """True when ``directory`` holds a save of this format."""
    return os.path.isdir(directory) and any(
        _STEP_FILE.match(n) for n in os.listdir(directory))


def _host_copy(x):
    """``x`` with every tensor copied to the host, nested dicts and lists
    kept.  A copy even where the tensor already lies there, so the live
    state can move on."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, dict):
        return {k: _host_copy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_host_copy(v) for v in x)
    return x


def optimizer_names(opt: torch.optim.Optimizer, module: torch.nn.Module) -> List[str]:
    """The names of the parameters ``opt`` trains, in its own order (the
    order its ``state_dict`` indexes them by)."""
    name_of = {id(p): n for n, p in module.named_parameters()}
    return [name_of[id(p)] for group in opt.param_groups for p in group["params"]]


def snapshot(state: GANTrainState, accum_steps: int = 1) -> Dict:
    """The whole state as host tensors.  A net's gradients being
    accumulated are kept only in the middle of its update
    (``GANTrainState.micro_index``; G's window may start elsewhere than
    D's)."""
    out = {"step": int(state.step), "g_window_start": int(state.g_window_start),
           "generator": _host_copy(state.generator.state_dict()),
           "discriminator": _host_copy(state.discriminator.state_dict())}
    for key, opt, module in (("g_opt", state.g_opt, state.generator),
                             ("d_opt", state.d_opt, state.discriminator)):
        out[key] = {"names": optimizer_names(opt, module),
                    "state_dict": _host_copy(opt.state_dict())}
    accum = max(int(accum_steps), 1)
    for key, net, module in (("g_acc", "G", state.generator),
                             ("d_acc", "D", state.discriminator)):
        out[key] = ({n: p.grad.detach().to("cpu", copy=True)
                     for n, p in module.named_parameters() if p.grad is not None}
                    if state.micro_index(net, accum) != 0 else {})
    return out


def _tensors(x, prefix=""):
    if isinstance(x, torch.Tensor):
        yield prefix, x
    elif isinstance(x, dict):
        for k in sorted(x, key=str):
            yield from _tensors(x[k], f"{prefix}/{k}")
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            yield from _tensors(v, f"{prefix}/{i}")


def state_digest(state: Union[GANTrainState, Mapping]) -> Dict[str, str]:
    """A SHA-256 of every tensor of a state (or of its ``snapshot``), the
    optimizers' parameter names and the step: two states with equal
    digests are equal bit for bit."""
    snap = state if isinstance(state, Mapping) else snapshot(state)
    out = {"step": str(snap["step"]), "g_window_start": str(snap.get("g_window_start", 0)),
           "names": hashlib.sha256(json.dumps(
               [snap["g_opt"]["names"], snap["d_opt"]["names"]]).encode()).hexdigest()}
    for key in ("generator", "discriminator", "g_opt", "d_opt", "g_acc", "d_acc"):
        for name, t in _tensors(snap[key], key):
            raw = t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
            out[name] = hashlib.sha256(raw.numpy().tobytes()).hexdigest()
    return out


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5, writer: bool = True):
        self.directory = os.path.abspath(directory)
        self.writer = writer
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._index_path = os.path.join(self.directory, "epoch_index.json")
        self._epoch_index = self._load_index()
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # each landed save: step, bytes, snapshot_ms (blocking), write_ms
        # (in the background)
        self.saves: List[Dict] = []

    def _load_index(self) -> Dict[int, int]:
        if os.path.exists(self._index_path):
            with open(self._index_path) as f:
                return {int(k): int(v) for k, v in json.load(f).items()}
        return {}

    def _write_index(self) -> None:
        tmp = self._index_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._epoch_index, f)
        os.replace(tmp, self._index_path)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_STEP_FILE.match, os.listdir(self.directory))
                      if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait(self) -> None:
        """Wait for the save in flight; raise its error, if it failed."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err

    def save(self, state: GANTrainState, epoch: int, epoch_iter: int = 0,
             epoch_label: Optional[int] = None, accum_steps: int = 1) -> None:
        """Copy ``state`` to the host and write it in the background.
        ``epoch_label`` marks the save as that epoch's end (``--which_epoch``
        finds it, and pruning keeps it).  A step that is not newer than the
        latest save is not written again, as orbax does not: the save
        already there stands, and the epoch label points at it.  A manager
        that is not the ``writer`` writes nothing."""
        if not self.writer:
            return
        self.wait()
        step = int(state.step)
        latest = self.latest_step()
        if latest is not None and step <= latest:
            if epoch_label is not None:
                self._epoch_index[int(epoch_label)] = step
                self._write_index()
            return
        t0 = time.perf_counter()
        payload = {"format": FORMAT, "state": snapshot(state, accum_steps),
                   "cursor": {"epoch": int(epoch), "epoch_iter": int(epoch_iter),
                              "units_samples": 1}}
        snapshot_ms = (time.perf_counter() - t0) * 1e3

        def write() -> None:
            try:
                t1 = time.perf_counter()
                path = self._path(step)
                torch.save(payload, path + ".tmp")
                os.replace(path + ".tmp", path)
                # the index names a step only once its file has landed
                if epoch_label is not None:
                    self._epoch_index[int(epoch_label)] = step
                    self._write_index()
                self._prune()
                self.saves.append({"step": step, "bytes": os.path.getsize(path),
                                   "snapshot_ms": snapshot_ms,
                                   "write_ms": (time.perf_counter() - t1) * 1e3})
            except Exception as e:  # raised by the next wait()
                self._error = e

        self._writer = threading.Thread(target=write, daemon=True)
        self._writer.start()

    def _prune(self) -> None:
        """Keep the newest ``max_to_keep`` saves and every epoch-end save."""
        steps = self.all_steps()
        keep = set(steps[-self.max_to_keep:]) | set(self._epoch_index.values())
        for s in steps:
            if s not in keep:
                os.remove(self._path(s))

    def resolve_epoch(self, which_epoch: Union[str, int, None]) -> Optional[int]:
        """``--which_epoch`` -> step: ``latest`` the newest save, an integer
        the epoch-end save recorded in ``epoch_index.json``."""
        self.wait()
        if which_epoch in (None, "latest"):
            return self.latest_step()
        try:
            epoch = int(which_epoch)
        except ValueError:
            raise FileNotFoundError(
                f"--which_epoch {which_epoch!r} is neither 'latest' nor an epoch number "
                f"(available: {sorted(self._epoch_index)})")
        if epoch not in self._epoch_index:
            raise FileNotFoundError(
                f"no checkpoint recorded for epoch {epoch} under {self.directory} "
                f"(available epochs: {sorted(self._epoch_index)})")
        step = self._epoch_index[epoch]
        if step not in self.all_steps():
            raise FileNotFoundError(
                f"epoch_index.json maps epoch {epoch} to step {step}, but that checkpoint "
                f"does not exist under {self.directory} (available steps: {self.all_steps()})")
        return step

    def _load(self, step: Optional[int], mmap: bool = False) -> Tuple[int, Dict]:
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        payload = torch.load(self._path(step), map_location="cpu", weights_only=True, mmap=mmap)
        if payload.get("format") != FORMAT:
            raise ValueError(f"{self._path(step)} is not a {FORMAT} checkpoint")
        return step, payload

    def restore_fields(self, fields: Mapping[str, Mapping[str, torch.Tensor]],
                       step: Optional[int] = None) -> Dict[str, Dict[str, torch.Tensor]]:
        """Some fields of a saved state, e.g. ``{"generator":
        gen.state_dict()}``: for each, the saved tensor of every name of the
        template.  Inference needs only the weights, so this reads no
        optimizer.  A template name that the save lacks, or holds at another
        shape, fails here with the names: the model was built with other
        architecture flags than the run that saved it."""
        step, payload = self._load(step)
        out, bad = {}, []
        for field, template in fields.items():
            saved = payload["state"][field]
            for name, t in template.items():
                if name not in saved:
                    bad.append(f"{field}.{name} (missing)")
                elif tuple(saved[name].shape) != tuple(t.shape):
                    bad.append(f"{field}.{name} (saved {tuple(saved[name].shape)}, "
                               f"model {tuple(t.shape)})")
            out[field] = {name: saved[name] for name in template if name in saved}
        if bad:
            shown = ", ".join(bad[:6])
            more = f" (+{len(bad) - 6} more)" if len(bad) > 6 else ""
            raise ValueError(
                f"checkpoint {self.directory} step {step} holds no value for {len(bad)} "
                f"requested parameter(s): {shown}{more} — the constructed model's "
                f"architecture does not match the one that wrote this checkpoint (compare "
                f"--netG/--ngf/--downsample_type/--upsample_type/--n_blocks_* against the "
                f"training run's opt.txt)")
        return out

    def peek_cursor(self, step: Optional[int] = None) -> Optional[Tuple[int, int]]:
        """(epoch, epoch_iter) of a save without restoring its state (the
        file is memory-mapped, its tensors not read); None without a save.
        The optimizer to restore into depends on the epoch (the
        ``niter_fix_global`` unfreeze), so the cursor comes first."""
        self.wait()
        if step is None and self.latest_step() is None:
            return None
        _, payload = self._load(step, mmap=True)
        cur = payload["cursor"]
        return int(cur["epoch"]), int(cur["epoch_iter"])

    def restore(self, state: GANTrainState, step: Optional[int] = None,
                batch_size: int = 1) -> Tuple[GANTrainState, int, int]:
        """Load a save into ``state`` in place; returns (state, epoch,
        epoch_iter in samples).  Each optimizer's saved parameter names must
        be the ones it trains now, in order: its state is indexed by
        position, so another freeze mask would hand moments to the wrong
        tensors.  A cursor without ``units_samples`` counted batches and is
        converted with ``batch_size``."""
        step, payload = self._load(step)
        saved = payload["state"]
        for key, opt, module in (("g_opt", state.g_opt, state.generator),
                                 ("d_opt", state.d_opt, state.discriminator)):
            have, want = saved[key]["names"], optimizer_names(opt, module)
            if have != want:
                extra = sorted(set(have) - set(want))[:4]
                absent = sorted(set(want) - set(have))[:4]
                raise ValueError(
                    f"checkpoint {self.directory} step {step}: {key} was saved over "
                    f"{len(have)} parameters, this optimizer trains {len(want)} (saved only: "
                    f"{extra}; trained only: {absent}) — the freeze flags or "
                    f"--niter_fix_global differ from the run that wrote it")
        state.generator.load_state_dict(saved["generator"], strict=True)
        state.discriminator.load_state_dict(saved["discriminator"], strict=True)
        state.g_opt.load_state_dict(saved["g_opt"]["state_dict"])
        state.d_opt.load_state_dict(saved["d_opt"]["state_dict"])
        for key, module in (("g_acc", state.generator), ("d_acc", state.discriminator)):
            for name, p in module.named_parameters():
                p.grad = saved[key][name].to(p.device) if name in saved[key] else None
        state.step = int(saved["step"])
        state.g_window_start = int(saved.get("g_window_start", 0))
        cur = payload["cursor"]
        it = int(cur["epoch_iter"])
        if "units_samples" not in cur:
            it *= max(int(batch_size), 1)
        return state, int(cur["epoch"]), it

    def close(self) -> None:
        self.wait()
