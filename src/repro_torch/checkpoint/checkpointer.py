"""Fault-tolerant checkpointing, in the reference's on-disk format.

Counterpart of ``repro.checkpoint.checkpointer``; a checkpoint written by
either package restores in the other:
  * step-atomic: write into ``<dir>/tmp.<step>/``, fsync the manifest, then
    ``os.rename`` to ``step_<10 digits>``: a crash never leaves a readable
    half-checkpoint;
  * ``arrays.npz`` holds every leaf under its path joined by ``/``
    (``params/blocks/wq``, ``opt/step``); ``manifest.json`` its step,
    keys, shapes, stored dtypes and a caller's ``meta``;
  * npz cannot hold bf16 or fp8, so bf16 is stored as its ``uint16`` bits
    and fp8 as ``uint8`` (the reference's ``ml_dtypes`` views), and a
    restore views them back into the template's dtype;
  * async: ``save(..., blocking=False)`` copies the state to host memory
    at once (the trainer updates it in place afterwards) and writes on a
    daemon thread; ``wait()`` joins;
  * keep_n garbage collection;
  * ``arrays.npz`` is the zip that ``np.savez`` writes (stored members,
    zip64, each member an ``.npy`` of version 1.0), written and read by
    :func:`_write_npz` / :func:`_read_npz`: the members' CRC-32s are
    computed, and checked on restore, on threads (zlib releases the GIL),
    and each member's bytes move in one read or write, where ``np.savez``
    and ``np.load`` take one thread and 256 KiB pieces.

A placed state (each rank holding its shards, ``place=(placement,
specs)``: the rank's ``core.offload.Placement`` and the state's
``state_specs()``) is saved in the same format: every leaf gathered whole
over the axes that split it (every rank takes part), and only the
world's rank 0 holds the copy and writes.  ``restore(..., place=...)``
gives each rank its shards of the whole leaves under another placement's
specs: the reference's restore with ``shardings``, so a restart may land
on a mesh that differs from the one that saved.
"""
from __future__ import annotations

import io
import json
import os
import shutil
import struct
import threading
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed import collectives

Pytree = Any

_SEP = "/"
_IO_THREADS = 8
_Z64 = 0xFFFFFFFF

# dtypes npz cannot hold -> the integer type of their bits
_EXOTIC = {torch.bfloat16: (torch.int16, np.uint16),
           torch.float8_e4m3fn: (torch.uint8, np.uint8),
           torch.float8_e5m2: (torch.uint8, np.uint8)}


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` as numpy (bf16/fp8 as their bits), never
    sharing memory with ``t``."""
    t = t.detach()
    t = t.cpu() if t.device.type != "cpu" else t.clone()
    if t.dtype in _EXOTIC:
        bits, np_dt = _EXOTIC[t.dtype]
        return t.view(bits).numpy().view(np_dt)
    return t.numpy()


def _flatten(tree: Pytree, prefix: str = "", place=None, specs=None,
             keep: bool = True) -> dict[str, np.ndarray]:
    """Every leaf as host numpy under its path; on a mesh (``place``, the
    leaves' ``specs``) each leaf gathered whole first, and kept only where
    ``keep`` (the other ranks take part in the gathers and hold nothing)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}{_SEP}", place,
                                None if specs is None else specs[k], keep))
        return out
    if place is not None:
        tree = _gather_whole(place, specs, tree.detach())
    return {prefix[:-1]: _host(tree)} if keep else {}


def _gather_whole(place, spec, x: torch.Tensor) -> torch.Tensor:
    """The whole tensor of which ``x`` is this rank's shard under ``spec``."""
    for d in range(len(spec)):
        if place.split(spec.axes(d)):
            x = collectives.all_gather(x, place.mesh.group(spec.axes(d)), d)
    return x


def _leaf(arr: np.ndarray, tmpl: torch.Tensor, device: torch.device) -> torch.Tensor:
    want = tmpl.dtype
    if want in _EXOTIC and arr.dtype == _EXOTIC[want][1]:
        t = torch.from_numpy(arr.view(np.int16) if want == torch.bfloat16 else arr).view(want)
    else:
        np_dt = torch.empty((), dtype=want).numpy().dtype
        a = arr.astype(np_dt, copy=False)
        t = torch.from_numpy(a if a.flags.c_contiguous else a.copy())
    if tuple(t.shape) != tuple(tmpl.shape):
        raise ValueError(f"checkpoint leaf of shape {tuple(t.shape)} for a template of "
                         f"{tuple(tmpl.shape)}")
    return t.to(device)


def _unflatten_into(template: Pytree, flat: dict[str, np.ndarray], device,
                    prefix: str = "", place=None, specs=None) -> Pytree:
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, device, f"{prefix}{k}{_SEP}", place,
                                   None if specs is None else specs[k])
                for k, v in template.items()}
    dev = device if device is not None else (
        template.device if template.device.type != "meta" else torch.device("cpu"))
    if place is None:
        return _leaf(flat[prefix[:-1]], template, dev)
    return place.take(_leaf(flat[prefix[:-1]], template, "cpu"), specs).contiguous().to(dev)


def _npy_header(a: np.ndarray) -> bytes:
    f = io.BytesIO()
    np.lib.format.write_array_header_1_0(f, np.lib.format.header_data_from_array_1_0(a))
    return f.getvalue()


def _write_npz(path: str, flat: dict[str, np.ndarray]) -> None:
    """Write ``flat`` as ``np.savez`` would (``<key>.npy`` members, stored,
    zip64 sizes in every local and central header)."""
    names = list(flat)
    arrays = [a if a.flags.c_contiguous else a.copy(order="C") for a in flat.values()]
    heads = [_npy_header(a) for a in arrays]
    datas = [memoryview(a.reshape(-1)).cast("B") for a in arrays]
    with ThreadPoolExecutor(_IO_THREADS) as ex:
        crcs = list(ex.map(lambda hd: zlib.crc32(hd[1], zlib.crc32(hd[0])), zip(heads, datas)))
    central, off = [], 0
    with open(path, "wb") as f:
        for k, head, data, crc in zip(names, heads, datas, crcs):
            name, size = f"{k}.npy".encode(), len(head) + data.nbytes
            f.write(struct.pack("<IHHHHHIIIHH", 0x04034B50, 45, 0, 0, 0, 0x21, crc, _Z64, _Z64,
                                len(name), 20) + name + struct.pack("<HHQQ", 1, 16, size, size))
            f.write(head)
            f.write(data)
            central.append(struct.pack("<IHHHHHHIIIHHHHHII", 0x02014B50, 45, 45, 0, 0, 0, 0x21,
                                       crc, _Z64, _Z64, len(name), 28, 0, 0, 0, 0o600 << 16,
                                       _Z64) + name + struct.pack("<HHQQQ", 1, 24, size, size, off))
            off += 30 + len(name) + 20 + size
        cd = b"".join(central)
        f.write(cd)
        n = len(names)
        f.write(struct.pack("<IQHHIIQQQQ", 0x06064B50, 44, 45, 45, 0, 0, n, n, len(cd), off))
        f.write(struct.pack("<IIQI", 0x07064B50, 0, off + len(cd), 1))
        f.write(struct.pack("<IHHHHIIH", 0x06054B50, 0, 0, min(n, 0xFFFF), min(n, 0xFFFF),
                            min(len(cd), _Z64), _Z64, 0))


def _read_npz(path: str) -> dict[str, np.ndarray]:
    """Every member of an ``np.savez`` file (stored members, as the
    reference and :func:`_write_npz` write them), each CRC-32 checked."""
    import zipfile

    with zipfile.ZipFile(path) as zf:
        infos = zf.infolist()

    def member(zi):
        if zi.compress_type != zipfile.ZIP_STORED or not zi.filename.endswith(".npy"):
            raise ValueError(f"{path}: member {zi.filename} is not a stored .npy")
        with open(path, "rb") as f:
            f.seek(zi.header_offset)
            local = f.read(30)
            name_len, extra_len = struct.unpack("<HH", local[26:30])
            f.seek(zi.header_offset + 30 + name_len + extra_len)
            buf = np.empty(zi.file_size, np.uint8)
            if f.readinto(buf) != zi.file_size:
                raise ValueError(f"{path}: member {zi.filename} is truncated")
        if zlib.crc32(buf) != zi.CRC:
            raise ValueError(f"{path}: bad CRC-32 for member {zi.filename}")
        head = io.BytesIO(buf[:min(zi.file_size, 1 << 16)].tobytes())
        version = np.lib.format.read_magic(head)
        read_header = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                       else np.lib.format.read_array_header_2_0)
        shape, fortran, dtype = read_header(head)
        arr = buf[head.tell():].view(dtype)
        arr = arr.reshape(shape[::-1]).T if fortran else arr.reshape(shape)
        return zi.filename[:-len(".npy")], arr

    with ThreadPoolExecutor(_IO_THREADS) as ex:
        return dict(ex.map(member, infos))


class Checkpointer:
    def __init__(self, directory: str, keep_n: int = 3):
        self.dir = directory
        self.keep_n = keep_n
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: Pytree, meta: dict | None = None, blocking: bool = True,
             place=None):
        """Write ``state`` as step ``step``; with ``place=(placement,
        specs)`` a placed state's whole leaves, gathered, by rank 0 alone
        (every rank calls it)."""
        self.wait()
        if place is None:
            flat = _flatten(state)
        else:
            placement, specs = place
            writer = not dist.is_initialized() or dist.get_rank() == 0
            flat = _flatten(state, place=placement, specs=specs, keep=writer)
            if not writer:
                return
        if blocking:
            self._write(step, flat, meta or {})
        else:
            self._thread = threading.Thread(
                target=self._write, args=(step, flat, meta or {}), daemon=True
            )
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, flat: dict[str, np.ndarray], meta: dict):
        tmp = os.path.join(self.dir, f"tmp.{step}")
        final = os.path.join(self.dir, f"step_{step:010d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        _write_npz(os.path.join(tmp, "arrays.npz"), flat)
        manifest = {
            "step": step,
            "keys": sorted(flat),
            "shapes": {k: list(v.shape) for k, v in flat.items()},
            "dtypes": {k: str(v.dtype) for k, v in flat.items()},
            "meta": meta,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep_n]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"), ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                if os.path.exists(os.path.join(self.dir, name, "manifest.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Pytree, step: int | None = None,
                device: str | torch.device | None = None, place=None) -> tuple[int, Pytree]:
        """Restore into the structure and dtypes of ``template`` (tensors,
        on the ``meta`` device too: ``make_train_step``'s
        ``state_shapes()``, the whole leaves), on ``device`` (default: each
        template leaf's device, the CPU for a meta leaf).  With
        ``place=(placement, specs)`` each leaf is this rank's shard under
        its spec, whatever mesh wrote the checkpoint."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:010d}")
        flat = _read_npz(os.path.join(path, "arrays.npz"))
        dev = None if device is None else torch.device(device)
        placement, specs = place if place is not None else (None, None)
        return step, _unflatten_into(template, flat, dev, place=placement, specs=specs)

    def manifest(self, step: int) -> dict:
        with open(os.path.join(self.dir, f"step_{step:010d}", "manifest.json")) as f:
            return json.load(f)
