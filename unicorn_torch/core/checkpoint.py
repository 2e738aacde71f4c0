"""Checkpoint save and load with torch.save / torch.load (port of
unicorn_tpu/core/checkpoint.py, which writes orbax directories).

A checkpoint is one file, `<ckpt_dir>/<name>`, holding a dict of tensors,
numbers, strings, lists and dicts (a state_dict's types), read back with
`weights_only=True`. Every save writes a temporary file beside the target
and `os.replace`s it into place, so that a process killed mid-write leaves
the previous checkpoint whole (what orbax's commit step guarantees).
"""
from __future__ import annotations

import logging
import os
import threading
from concurrent.futures import Future, ThreadPoolExecutor

import torch

_writer: ThreadPoolExecutor | None = None
_pending: list[Future] = []
_lock = threading.Lock()


def _to_host(obj):
    """A copy of obj with every tensor copied to host memory, so that the
    caller may go on updating the originals while the copy is written."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _write(state: dict, path: str):
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(state, tmp)
    os.replace(tmp, path)


def save_checkpoint(ckpt_dir: str, state: dict, name: str = "latest",
                    blocking: bool = True):
    """Write `state` to <ckpt_dir>/<name>. The state is copied to host
    memory on the calling thread either way; blocking=False then hands the
    copy to one background writer thread and returns. Call
    wait_for_checkpoints() before reading the file. Saves run in the order
    they were issued."""
    global _writer
    path = os.path.abspath(os.path.join(ckpt_dir, name))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    state = _to_host(state)
    if blocking:
        wait_for_checkpoints()
        _write(state, path)
        return
    with _lock:
        if _writer is None:
            _writer = ThreadPoolExecutor(1, thread_name_prefix="checkpoint")
        _pending.append(_writer.submit(_write, state, path))


def wait_for_checkpoints():
    """Block until every non-blocking save has been written; re-raises a
    failed write's error."""
    with _lock:
        pending = list(_pending)
        _pending.clear()
    for f in pending:
        f.result()


def load_checkpoint(ckpt_dir: str, name: str = "latest") -> dict:
    """The dict saved at <ckpt_dir>/<name>, its tensors on the CPU. With
    name "latest", ckpt_dir may itself be the checkpoint file. A missing
    checkpoint raises FileNotFoundError."""
    path = os.path.abspath(os.path.join(ckpt_dir, name))
    if not os.path.isfile(path):
        if name == "latest" and os.path.isfile(ckpt_dir):
            path = os.path.abspath(ckpt_dir)
        else:
            raise FileNotFoundError(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def load_matching(state_dict: dict, loaded: dict,
                  verbose: bool = True) -> dict:
    """A copy of `state_dict` with every entry of `loaded` whose name and
    shape match put in its place (the reference's shape-tolerant loader,
    for weight surgery across stages); what did not match is reported."""
    out = dict(state_dict)
    n_ok, skipped = 0, []
    for k, v in loaded.items():
        if k in out and tuple(v.shape) == tuple(out[k].shape):
            out[k] = v
            n_ok += 1
        else:
            skipped.append(k)
    if verbose and skipped:
        logging.getLogger("unicorn_torch").info(
            "load_matching: copied %d, skipped %d keys (first: %s)", n_ok,
            len(skipped), skipped[:5])
    return out
