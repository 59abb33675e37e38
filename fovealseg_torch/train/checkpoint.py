"""Carrying weights into the port (counterpart of the torch import/export in
``fovealseg_tpu/train/checkpoint.py``).

* :func:`from_jax_variables` maps the JAX package's parameter trees, given as
  nested dicts of numpy arrays (``flax.traverse_util`` style), to a
  ``DeformSegmentation`` state dict: conv kernels HWIO -> OIHW, Dense kernels
  transposed, BN scale -> weight, mean/var -> running_mean/running_var, under
  the four subtrees ``localization``, ``net_compress``, ``encoder``,
  ``decoder`` (or, with ``module=True``, one zoo module's whole tree). It
  is the port's own copy of the mapping in ``export_torch_state_dict``.
* :func:`load_torch_checkpoint` loads the reference's 4-file set
  ``{saliency,compress,encoder,decoder}_epoch_N.pth`` into a model.
* :func:`load_torch_weight_files` loads per-network files named one by one,
  the ``MODEL.weights_{encoder,decoder,net_saliency,net_compress}`` surface.
  Both load as the JAX package's import does (the reference's
  ``strict=False``): a key the model has no entry for, or whose shape
  differs, is skipped and logged (a ResNetZoom file's ``layer4.*`` and
  ``fc.*``), an entry the file lacks keeps its value.
* :func:`save_torch_checkpoint` writes a model's weights as that 4-file set
  (``cli/export.py --format torch``).
* :func:`save_checkpoint` / :func:`load_checkpoint` are the port's training
  checkpoint: the same 4-file set (what the JAX package's
  ``load_torch_checkpoint`` reads) plus ``train_state_epoch_{N}.pth`` with the
  optimizer state, the step count, the dropout generator's state and the
  pretrain-pool draw's state. Each numbered epoch also refreshes the
  ``_last`` copies; an off-cadence epoch writes only those. Each tag's
  ``train_state`` file is removed before its first weight file is replaced
  and written after its last one, so a crash mid-write never leaves a set
  that :func:`has_checkpoint` accepts with weights of one save beside the
  state of another. Without a saver the write is synchronous, the ``_last``
  files after the numbered ones; with an :class:`AsyncSaver`
  (``TPU.async_checkpoint``) the training thread only snapshots the state
  into host buffers, and a background thread writes the numbered files and
  then copies them to the ``_last`` names. Under data
  parallelism rank 0 writes and every rank loads; the port's own
  checkpoint loads strictly. On a 2-D mesh (``state.mesh``) every rank
  gathers the sharded weights and their optimizer state whole
  (``parallel/mesh.py::gather_state_2d``) and global rank 0 writes them, so
  the files are a one-process run's; loading cuts each rank's shards out of
  them (``slice_state_2d``), so either kind of run resumes from the other.
"""

from __future__ import annotations

import copy
import logging
import os
import shutil
import threading
import time
from collections.abc import Mapping

import numpy as np
import torch

log = logging.getLogger("fovealseg")

# file kind -> DeformSegmentation submodule
SUBMODULE_OF_FILE = {
    "saliency": "localization",
    "compress": "net_compress",
    "encoder": "encoder",
    "decoder": "decoder",
}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def from_jax_variables(params: dict, batch_stats: dict,
                       module: bool = False) -> dict[str, torch.Tensor]:
    """JAX (params, batch_stats) numpy trees -> ``DeformSegmentation`` state
    dict. ``module``: the trees of one stand-alone module, which has no such
    subtrees (a zoo backbone, legacy decoder or ``SegHRNet``), mapped whole
    to that module's own state-dict keys."""
    out: dict[str, torch.Tensor] = {}
    tops = set(SUBMODULE_OF_FILE.values())

    def put(key, arr):
        out[key] = torch.from_numpy(np.array(arr, copy=True, order="C"))

    for path, arr in _flatten(params):
        if not module and path[0] not in tops:
            continue
        mod, leaf = ".".join(path[:-1]), path[-1]
        arr = np.asarray(arr, np.float32)
        if leaf == "kernel" and arr.ndim == 4:
            put(f"{mod}.weight", arr.transpose(3, 2, 0, 1))  # HWIO -> OIHW
        elif leaf == "kernel" and arr.ndim == 2:
            put(f"{mod}.weight", arr.T)
        elif leaf == "scale":
            put(f"{mod}.weight", arr)
        elif leaf == "bias":
            put(f"{mod}.bias", arr)
        else:
            raise KeyError(f"no torch mapping for JAX parameter {'/'.join(path)}")
    for path, arr in _flatten(batch_stats):
        if not module and path[0] not in tops:
            continue
        mod, leaf = ".".join(path[:-1]), path[-1]
        if leaf not in ("mean", "var"):
            raise KeyError(f"no torch mapping for JAX batch statistic {'/'.join(path)}")
        put(f"{mod}.running_{leaf}", np.asarray(arr, np.float32))
        out.setdefault(f"{mod}.num_batches_tracked", torch.tensor(0, dtype=torch.int64))
    return out


def load_torch_checkpoint(model: torch.nn.Module, ckpt_dir: str, epoch="last",
                          strict: bool = False) -> None:
    """Load ``{saliency,compress,encoder,decoder}_epoch_{epoch}.pth`` into the
    four submodules of ``model`` (see :func:`load_torch_weight_files`). A
    missing file raises: a sub-network left at its random init would serve
    quietly wrong masks."""
    load_torch_weight_files(model, {kind: os.path.join(ckpt_dir, f"{kind}_epoch_{epoch}.pth")
                                     for kind in SUBMODULE_OF_FILE}, strict=strict)


def load_torch_weight_files(model: torch.nn.Module, paths: Mapping[str, str],
                            strict: bool = False) -> list[str]:
    """Load per-network ``.pth`` files into ``model``: ``paths`` maps a file
    kind ('saliency', 'compress', 'encoder', 'decoder') to a path. Empty
    entries are skipped, as the JAX package skips them; a named file that is
    missing raises. Each file loads as the JAX package's
    ``import_torch_state_dict`` does: the keys that the submodule has, at
    its shapes; a key it lacks or a shape that differs is skipped and logged
    (``strict`` raises instead), and an entry the file lacks keeps its
    value. Returns the kinds loaded."""
    loaded = []
    for kind, path in paths.items():
        if not path:
            continue
        if not os.path.exists(path):
            raise FileNotFoundError(f"checkpoint file missing: {path}")
        sd = torch.load(path, map_location="cpu", weights_only=True)
        sub = getattr(model, SUBMODULE_OF_FILE[kind])
        if strict:
            sub.load_state_dict(sd, strict=True)
        else:
            own = sub.state_dict()
            keep, skipped = {}, []
            for k, v in sd.items():
                if k not in own:
                    skipped.append((k, "missing"))
                elif tuple(own[k].shape) != tuple(v.shape):
                    skipped.append((k, "shape"))
                else:
                    keep[k] = v
            sub.load_state_dict(keep, strict=False)
            if skipped:
                log.warning("torch import %s: %d matched, %d skipped (strict=False): %s...",
                            path, len(keep), len(skipped), skipped[:5])
        loaded.append(kind)
    return loaded


def _write(path: str, obj) -> None:
    """``torch.save`` through a temporary file, so a crash leaves the old file."""
    tmp = f"{path}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _copy(src: str, dst: str) -> None:
    """A finished file copied through a temporary file, as :func:`_write`."""
    tmp = f"{dst}.tmp"
    shutil.copyfile(src, tmp)
    os.replace(tmp, dst)


def _tag_paths(ckpt_dir: str, tag) -> dict[str, str]:
    """{file kind: path} of one tag, ``train_state`` last."""
    return {kind: os.path.join(ckpt_dir, f"{kind}_epoch_{tag}.pth")
            for kind in (*SUBMODULE_OF_FILE, "train_state")}


def _write_tag(ckpt_dir: str, tag, put) -> list[str]:
    """Write one tag's files with ``put(kind, path)``: its ``train_state``
    file removed first and written last, so that an interrupted write leaves
    a set that :func:`has_checkpoint` refuses."""
    paths = _tag_paths(ckpt_dir, tag)
    if os.path.exists(paths["train_state"]):
        os.remove(paths["train_state"])
    for kind, path in paths.items():
        put(kind, path)
    return list(paths.values())


def _files(sd: Mapping[str, torch.Tensor], osd: dict, state) -> dict[str, dict]:
    """The contents of one tag's files: the 4-file set, then ``train_state``
    (the optimizer state dict ``osd`` and ``state``'s step, dropout
    generator and pool draw, read now)."""
    files = weight_files(sd)
    files["train_state"] = {
        "optimizer": osd,
        "step": int(state.step),
        "generator": state.generator.get_state(),
        "pool_rng": state.pool_rng.getstate(),
    }
    return files


class AsyncSaver:
    """The overlapped checkpoint write (``TPU.async_checkpoint``; the JAX
    package's ``AsyncSaver``).

    :meth:`save` blocks only for the snapshot: the model's state dict and
    the optimizer's state are copied from the card into pinned host buffers
    (``non_blocking``, then one event waited on), allocated at the first save
    and reused; the step, the dropout generator's state and the pool draw's
    state are taken at the same moment. The snapshot is whole when ``save``
    returns, so the next step may update the parameters and the optimizer
    state in place. A background thread then writes the files: the numbered
    tag through :func:`_write`, then the ``_last`` copies as file copies of
    the finished files (no second snapshot, no second ``torch.save``); an
    off-cadence save writes only ``_last``. One write is in flight at a
    time: :meth:`save`, :meth:`wait` and :meth:`close` first drain the
    previous one, and an exception raised in the writer is raised there.

    ``last_write_s`` (the writer thread's seconds) and ``last_bytes`` (the
    bytes written) describe the latest write.
    """

    def __init__(self):
        self._buffers: dict = {}
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self.last_write_s = 0.0
        self.last_bytes = 0

    def _drain(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, self._error = self._error, None
        if err is not None:
            raise err

    def _buffer(self, key, v: torch.Tensor) -> torch.Tensor:
        buf = self._buffers.get(key)
        if buf is None or buf.shape != v.shape or buf.dtype != v.dtype:
            buf = torch.empty(v.shape, dtype=v.dtype, device="cpu", pin_memory=v.is_cuda)
            self._buffers[key] = buf
        buf.copy_(v.detach(), non_blocking=v.is_cuda)
        return buf

    def _snapshot(self, sd: Mapping[str, torch.Tensor], osd: dict) -> tuple[dict, dict]:
        """Host copies of a state dict and an optimizer state dict in this
        saver's buffers; complete on return."""
        tensors = [v for v in sd.values() if torch.is_tensor(v)]
        host_sd = {k: self._buffer(("model", k), v) for k, v in sd.items()}
        state = {}
        for idx, entry in osd["state"].items():
            tensors += [v for v in entry.values() if torch.is_tensor(v)]
            state[idx] = {name: self._buffer(("optimizer", idx, name), v) if torch.is_tensor(v)
                          else copy.deepcopy(v) for name, v in entry.items()}
        for dev in {v.device for v in tensors if v.is_cuda}:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(dev))
            done.synchronize()
        return host_sd, {**osd, "state": state, "param_groups": copy.deepcopy(osd["param_groups"])}

    def save(self, ckpt_dir: str, epoch, state, only_last: bool = False,
             gathered: tuple[dict, dict] | None = None) -> list[str]:
        """Drain the previous write, snapshot ``state`` (or take
        ``gathered``, a 2-D mesh's ``(sd, osd)``, which are fresh host copies
        already) and start writing ``epoch``'s tag and the ``_last`` copies
        (only ``_last`` with ``only_last``). Returns the paths it writes."""
        self._drain()
        if gathered is None:
            gathered = self._snapshot(state.model.state_dict(), state.optimizer.state_dict())
        files = _files(*gathered, state)
        tags = ["last"] if only_last else [epoch, "last"]

        def write():
            t0 = time.perf_counter()
            _write_tag(ckpt_dir, tags[0], lambda kind, path: _write(path, files[kind]))
            if len(tags) > 1:
                src = _tag_paths(ckpt_dir, tags[0])
                _write_tag(ckpt_dir, "last", lambda kind, path: _copy(src[kind], path))
            self.last_bytes = sum(os.path.getsize(p) for tag in tags
                                  for p in _tag_paths(ckpt_dir, tag).values())
            self.last_write_s = time.perf_counter() - t0

        def run():
            try:
                write()
            except BaseException as e:  # raised at the next drain
                self._error = e

        self._thread = threading.Thread(target=run, name="checkpoint-writer", daemon=True)
        self._thread.start()
        return [p for tag in tags for p in _tag_paths(ckpt_dir, tag).values()]

    def wait(self) -> None:
        """Block until the write in flight is on disk; raise its error."""
        self._drain()

    def close(self) -> None:
        """Drain the write in flight and free the host buffers."""
        try:
            self._drain()
        finally:
            self._buffers.clear()


def save_checkpoint(ckpt_dir: str, epoch, state, only_last: bool = False,
                    saver: AsyncSaver | None = None) -> list[str]:
    """Write ``state`` (``train/step.py::TrainState``) for ``epoch``: the
    4-file set ``{kind}_epoch_{epoch}.pth`` and ``train_state_epoch_{epoch}.pth``,
    then the ``_last`` copies; with ``only_last`` just the ``_last`` files.
    In a process group only rank 0 writes (the others return at once; on a
    2-D mesh after the collective gather of the shards). ``saver``: write in
    its background thread after a snapshot (see :class:`AsyncSaver`); else
    synchronously. Returns the written paths."""
    if state.mesh is not None:
        from fovealseg_torch.parallel.mesh import gather_state_2d

        sd, osd = gather_state_2d(state.model, state.optimizer, state.mesh)
    else:
        sd, osd = None, None
    if torch.distributed.is_initialized() and torch.distributed.get_rank() != 0:
        return []
    os.makedirs(ckpt_dir, exist_ok=True)
    if saver is not None:
        return saver.save(ckpt_dir, epoch, state, only_last, None if sd is None else (sd, osd))
    if sd is None:
        sd = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
        osd = state.optimizer.state_dict()
    files = _files(sd, osd, state)
    written = []
    for tag in (["last"] if only_last else [epoch, "last"]):
        written += _write_tag(ckpt_dir, tag, lambda kind, path: _write(path, files[kind]))
    return written


def weight_files(sd: Mapping[str, torch.Tensor]) -> dict[str, dict]:
    """A ``DeformSegmentation`` state dict split into the 4-file set's
    contents: {file kind: the submodule's entries without its prefix}."""
    return {kind: {k[len(sub) + 1:]: v for k, v in sd.items() if k.startswith(sub + ".")}
            for kind, sub in SUBMODULE_OF_FILE.items()}


def save_torch_checkpoint(ckpt_dir: str, tag, model: torch.nn.Module,
                          also_last: bool = False) -> list[str]:
    """Write ``model``'s weights as the reference's 4-file set
    ``{saliency,compress,encoder,decoder}_epoch_{tag}.pth`` (the JAX
    package's ``save_torch_checkpoint``), then the ``_last`` copies when
    ``also_last``. Returns the written paths."""
    os.makedirs(ckpt_dir, exist_ok=True)
    files = weight_files({k: v.detach().cpu() for k, v in model.state_dict().items()})
    written = []
    for t in ([tag, "last"] if also_last else [tag]):
        for kind, obj in files.items():
            path = os.path.join(ckpt_dir, f"{kind}_epoch_{t}.pth")
            _write(path, obj)
            written.append(path)
    return written


def has_checkpoint(ckpt_dir: str, epoch) -> bool:
    """Whether ``ckpt_dir`` holds the port's full checkpoint for ``epoch``."""
    return all(os.path.exists(p) for p in _tag_paths(ckpt_dir, epoch).values())


def load_checkpoint(ckpt_dir: str, epoch, state) -> None:
    """Restore ``state`` in place from ``save_checkpoint``'s files for
    ``epoch`` (a number or 'last'): weights and BN statistics strictly, then
    the optimizer, the step, the dropout generator and the pool draw. On a
    2-D mesh each rank takes its shards of the full tensors."""
    ts = torch.load(os.path.join(ckpt_dir, f"train_state_epoch_{epoch}.pth"),
                    map_location="cpu", weights_only=True)
    osd = ts["optimizer"]
    if state.mesh is None:
        load_torch_checkpoint(state.model, ckpt_dir, epoch, strict=True)
    else:
        from fovealseg_torch.parallel.mesh import slice_state_2d

        sd = {}
        for kind, sub in SUBMODULE_OF_FILE.items():
            part = torch.load(os.path.join(ckpt_dir, f"{kind}_epoch_{epoch}.pth"),
                              map_location="cpu", weights_only=True)
            sd.update({f"{sub}.{k}": v for k, v in part.items()})
        sd, osd = slice_state_2d(state.model, state.optimizer, sd, osd)
        state.model.load_state_dict(sd, strict=True)
    state.optimizer.load_state_dict(osd)
    state.step = int(ts["step"])
    state.generator.set_state(ts["generator"])
    state.pool_rng.setstate(_as_tuple(ts["pool_rng"]))


def _as_tuple(v):
    """``random.Random.getstate()``'s nested tuples back from a checkpoint."""
    return tuple(_as_tuple(x) for x in v) if isinstance(v, (list, tuple)) else v
