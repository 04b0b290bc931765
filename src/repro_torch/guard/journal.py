"""Delta journal + session checkpoints.

Crash recovery for a streaming session is two files' worth of state:

  * an **append-only journal** of every canonical Δ^t, written *before* the
    delta touches the snapshot (write-ahead). Records are length-prefixed
    and CRC-protected; ``scan`` replays the longest valid prefix and flags
    a torn tail (a crash mid-``append`` loses at most the record being
    written, never an earlier one);
  * periodic **checkpoints** of the full session state (ranks + the
    snapshot's host mirrors), written through ``train/checkpoint.py``'s
    atomic-manifest save/restore — a crash mid-checkpoint never corrupts
    the previous one.

``StreamSession.restore(dir)`` = load the newest checkpoint, then replay
every journaled delta with a later sequence number. The checkpoint holds
the snapshot mirrors *exactly* (free-list order included, which steers
future slot placement and so the summation order), so the restored
session is bit-identical to one that never crashed.

A copy of the JAX package's `repro.guard.journal`: the same header struct
and little-endian int32 payload (a record is byte-identical to JAX's, and
each package's ``scan`` reads the other's file), the same checkpoint
format. It imports nothing of ``repro_torch.stream``: records are plain
(seq, n, arrays) tuples and checkpoints flat dicts of numpy arrays; the
session owns the translation to and from ``Delta``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import struct
import zlib
from typing import List, Optional, Tuple

import numpy as np

from ..obs.spans import get_registry as _obs
from ..train.checkpoint import (latest_step, restore_checkpoint,
                                save_checkpoint)

__all__ = ["JournalRecord", "DeltaJournal", "journal_path",
           "save_session_checkpoint", "load_session_checkpoint"]

#: record header: magic, seq (batch index), n, n_del, n_ins, payload crc32
_MAGIC = 0x4C445247  # "GRDL"
_HEADER = struct.Struct("<IQQIII")
JOURNAL_NAME = "deltas.journal"


def journal_path(directory: str) -> str:
    return os.path.join(directory, JOURNAL_NAME)


@dataclasses.dataclass(frozen=True)
class JournalRecord:
    """One journaled canonical Δ^t (arrays int32, unique/disjoint pairs)."""
    seq: int
    n: int
    del_src: np.ndarray
    del_dst: np.ndarray
    ins_src: np.ndarray
    ins_dst: np.ndarray


def record_bytes(rec: JournalRecord) -> int:
    """A record's size in the file: its header and int32 payload."""
    return _HEADER.size + 4 * (2 * int(rec.del_src.shape[0])
                               + 2 * int(rec.ins_src.shape[0]))


def _payload(rec: JournalRecord) -> bytes:
    return b"".join(np.ascontiguousarray(a, dtype="<i4").tobytes()
                    for a in (rec.del_src, rec.del_dst,
                              rec.ins_src, rec.ins_dst))


class DeltaJournal:
    """Append-only, CRC-checked delta log. One writer, any-time readers."""

    def __init__(self, path: str, fsync: bool = False):
        self.path = path
        self._fsync = fsync
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "ab")

    def append(self, rec: JournalRecord) -> None:
        payload = _payload(rec)
        head = _HEADER.pack(_MAGIC, rec.seq, rec.n,
                            int(rec.del_src.shape[0]),
                            int(rec.ins_src.shape[0]),
                            zlib.crc32(payload) & 0xFFFFFFFF)
        self._f.write(head + payload)
        self._f.flush()
        if self._fsync:
            os.fsync(self._f.fileno())
        obs = _obs()
        obs.inc("guard.journal.appends")
        obs.inc("guard.journal.bytes", len(head) + len(payload))

    def close(self) -> None:
        self._f.close()

    @staticmethod
    def scan(path: str) -> Tuple[List[JournalRecord], bool]:
        """Read the longest valid record prefix.

        Returns ``(records, truncated)`` — ``truncated`` is True when the
        file ends in a torn/corrupt record (short header, short payload,
        bad magic or CRC mismatch), which bumps ``guard.journal.truncated``.
        Everything before the tear is intact by construction (records are
        written in one buffered write each, in order).
        """
        records: List[JournalRecord] = []
        truncated = False
        if not os.path.exists(path):
            return records, truncated
        with open(path, "rb") as f:
            data = f.read()
        off = 0
        while off < len(data):
            if off + _HEADER.size > len(data):
                truncated = True
                break
            magic, seq, n, n_del, n_ins, crc = _HEADER.unpack_from(data, off)
            body = 4 * (2 * n_del + 2 * n_ins)
            if magic != _MAGIC or off + _HEADER.size + body > len(data):
                truncated = True
                break
            payload = data[off + _HEADER.size: off + _HEADER.size + body]
            if zlib.crc32(payload) & 0xFFFFFFFF != crc:
                truncated = True
                break
            arrs = np.frombuffer(payload, dtype="<i4")
            d_s, d_d, i_s, i_d = np.split(
                arrs, [n_del, 2 * n_del, 2 * n_del + n_ins])
            records.append(JournalRecord(
                seq=int(seq), n=int(n),
                del_src=d_s.astype(np.int32), del_dst=d_d.astype(np.int32),
                ins_src=i_s.astype(np.int32), ins_dst=i_d.astype(np.int32)))
            off += _HEADER.size + body
        if truncated:
            _obs().inc("guard.journal.truncated")
        return records, truncated


# ---------------------------------------------------------------------------
# Session checkpoints: flat {name: array} dicts through train/checkpoint.py
# ---------------------------------------------------------------------------

def save_session_checkpoint(directory: str, step: int, arrays: dict,
                            extra: Optional[dict] = None) -> str:
    """Atomic checkpoint of a flat ``{name: array}`` dict (numpy arrays or
    tensors).

    ``step`` is the batch sequence number the state is valid *after*;
    ``extra`` must be JSON-serializable (session config, capacity plans).
    """
    assert all(isinstance(k, str) for k in arrays)
    extra = dict(extra or {})
    extra["leaf_keys"] = sorted(arrays)  # the files' order
    path = save_checkpoint(directory, step, arrays, extra=extra)
    _obs().inc("guard.checkpoint.saves")
    return path


@dataclasses.dataclass(frozen=True)
class _Spec:
    """A leaf's template: what the manifest says of its shape and dtype."""
    shape: tuple
    dtype: np.dtype


def load_session_checkpoint(directory: str, step: Optional[int] = None
                            ) -> Tuple[dict, dict, int]:
    """Inverse of ``save_session_checkpoint`` without needing a template:
    the manifest's shapes and dtypes build it. Returns
    ``({name: np.ndarray}, extra, step)``, every array writable (restored
    mirrors are edited in place); checksums are verified.
    """
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    ckpt = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(ckpt, "manifest.json")) as f:
        manifest = json.load(f)
    like = {}
    for i, key in enumerate(manifest["extra"]["leaf_keys"]):
        meta = manifest["files"][f"leaf_{i:05d}.npy"]
        like[key] = _Spec(tuple(meta["shape"]), np.dtype(meta["dtype"]))
    tree, extra, step = restore_checkpoint(directory, like, step=step)
    # np.load hands back owned, writable arrays: copy only what is not
    arrays = {k: v if v.flags.writeable else np.array(v)
              for k, v in tree.items()}
    return arrays, extra, step
