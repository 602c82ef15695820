"""Crash-durable SSD spill tier for the paged KV cache.

The port's copy of the JAX package's ``kvstore/spill.py``.  The files are
the same byte for byte: a group written by either package reads in the
other (``tests/test_torch_kvstore.py``).  The port's host rows hold a
bf16 pool's bytes as uint16 bit patterns (numpy has no bfloat16 without
ml_dtypes), so a store whose pool signature names ``bfloat16`` writes a
uint16 field under the dtype name ``bfloat16``, as the JAX package's
store does for its ml_dtypes rows (a pool holds no other 16-bit field).

The bottom tier of the Mooncake tower (HBM -> pinned host RAM -> SSD):
host-RAM overflow demotes block rows HERE instead of purging them, and
a respawned replica re-adopts whatever the directory holds — a crash
restart becomes a warm start (ARCHITECTURE.md invariant 13).

On-disk format (one file per block, ``<hex64>.kvb``)::

    [7B magic "AIKOKVS"][1B version]
    [4B LE header length][header: canonical JSON, crc32-sealed]
    [payload: per-field raw bytes, sorted field name, crc32 each]

The header carries the full chain identity (key / parent / depth /
key_seed / hits / eviction clock) plus the pool layout signature, the
per-field shapes, dtypes, and checksums — everything a cold process
needs to re-register the block and to prove the bytes are the bytes
that were written.  bf16 fields are stored as their uint16 bit
patterns; int8 scale planes are ordinary fields, so quantized blocks
round-trip byte-identical.

Crash consistency is per block GROUP: every file in a group is staged
as ``.tmp`` and fsync'd, then each is atomically renamed into place.
A crash mid-group leaves only (a) whole valid files and (b) ``.tmp``
litter that the next scan removes — never a half-visible block.

Corruption policy (invariant 13): a failed checksum NEVER surfaces KV
bytes.  ``read`` raises :class:`SpillCorruptionError`, the caller
counts it, deletes the file, and degrades that chain to plain
recompute.  ``scan`` validates headers and sizes only (catching torn
writes cheaply); payload bit-flips are caught by the per-field CRC at
read time, before any byte reaches the scatter.

Any OSError on the write path disables the tier (``enabled = False``):
a full or dying disk degrades the cache to the PR-9 two-tier behaviour,
it never stalls serving.  Reads keep working on a disabled tier.
"""

from __future__ import annotations

import json
import os
import struct
import time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..runtime import faults

MAGIC = b"AIKOKVS"
VERSION = 1
SUFFIX = ".kvb"
TMP_SUFFIX = ".tmp"
#: dtype-name token for bf16 bit patterns (ml_dtypes round-trips
#: unreliably through np.dtype(name); readers view as uint16 instead).
BF16 = "bfloat16"

_LEN = struct.Struct("<I")


class SpillFormatError(Exception):
    """The file speaks a different format version: not corruption,
    just not ours — skipped, never deleted (a newer binary may want
    it back)."""


class SpillCorruptionError(Exception):
    """The bytes are not the bytes that were written (torn write,
    bit-flip, bad header).  The caller must count, delete, and
    recompute — corrupt KV is never served."""


def _canonical(header: dict) -> bytes:
    return json.dumps(header, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")


class SpillStore:
    """Directory of checksummed KV block files.

    Parameters
    ----------
    root:
        Spill directory (created on demand).
    signature:
        ``transfer.pool_signature`` of the owning pool; a file written
        by a different layout is skipped at scan (the bytes would be
        reinterpreted).
    block_size:
        Tokens per block, stamped into every header for the same
        reason.
    """

    def __init__(self, root: str, signature: str, block_size: int):
        self.root = str(root)
        self.signature = str(signature)
        self.block_size = int(block_size)
        self._bf16_pool = self.signature.rsplit(":", 1)[-1] == BF16
        #: Writes are gated on this; any OSError on the write path
        #: (disk full, dying device, injected ``disk_full``) clears it
        #: for the rest of the process — the tier degrades, serving
        #: never stalls.  Reads of already-durable blocks continue.
        self.enabled = True
        self.disabled_reason = ""

    # -- write path ---------------------------------------------------

    def disable(self, reason: str) -> None:
        self.enabled = False
        self.disabled_reason = str(reason)

    def put_group(self, group: List[Tuple[str, dict, Dict[str, np.ndarray]]]
                  ) -> bool:
        """Durably write one eviction batch: ``(hex_key, meta, rows)``
        per block, ``meta`` carrying the chain identity and ``rows``
        the raw per-field arrays.  All-or-nothing at the group level:
        every file is staged + fsync'd before the first rename, so a
        crash anywhere leaves no partially-visible block.  Returns
        False (and disables the tier) on any OS failure."""
        if not self.enabled or not group:
            return False
        staged: List[Tuple[str, str]] = []
        try:
            if faults.PLAN is not None:
                params = faults.PLAN.check("disk_full", key=self.root)
                if params is not None:
                    raise OSError(28, "No space left on device (injected)")
            if faults.PLAN is not None:
                params = faults.PLAN.check("slow_disk", key=self.root)
                if params is not None:
                    time.sleep(float(params.get("ms", 50.0)) / 1000.0)
            os.makedirs(self.root, exist_ok=True)
            for hex_key, meta, rows in group:
                blob = self._encode(hex_key, meta, rows)
                if faults.PLAN is not None:
                    params = faults.PLAN.check("corrupt_disk_block",
                                               key=hex_key)
                    if params is not None:
                        # Flip one payload byte: the header stays valid
                        # (scan adopts the block) but the field CRC
                        # trips at read — the invariant-13 drill.
                        blob = blob[:-1] + bytes([blob[-1] ^ 0xFF])
                tmp = os.path.join(self.root, hex_key + TMP_SUFFIX)
                final = os.path.join(self.root, hex_key + SUFFIX)
                with open(tmp, "wb") as handle:
                    handle.write(blob)
                    handle.flush()
                    os.fsync(handle.fileno())
                staged.append((tmp, final))
            for tmp, final in staged:
                os.replace(tmp, final)
            return True
        except OSError as exc:
            for tmp, _final in staged:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
            self.disable(f"write failed: {exc}")
            return False

    def _dtype_name(self, dtype: np.dtype) -> str:
        if dtype.itemsize == 2 and \
                dtype.name not in ("uint16", "int16", "float16"):
            return BF16
        if dtype.name == "uint16" and self._bf16_pool:
            return BF16
        return dtype.name

    def _encode(self, hex_key: str, meta: dict,
                rows: Dict[str, np.ndarray]) -> bytes:
        fields = []
        payload = bytearray()
        for name in sorted(rows):
            raw = np.ascontiguousarray(rows[name]).view(np.uint8).reshape(-1)
            dtype_name = self._dtype_name(np.dtype(rows[name].dtype))
            fields.append([name, list(int(s) for s in rows[name].shape),
                           dtype_name, int(raw.nbytes),
                           zlib.crc32(raw.tobytes()) & 0xFFFFFFFF])
            payload += raw.tobytes()
        header = dict(meta)
        header.update(version=VERSION, key=hex_key, sig=self.signature,
                      block_size=self.block_size,
                      nbytes=len(payload), fields=fields)
        header["hcrc"] = zlib.crc32(_canonical(header)) & 0xFFFFFFFF
        hdr = _canonical(header)
        return (MAGIC + bytes([VERSION]) + _LEN.pack(len(hdr)) + hdr
                + bytes(payload))

    # -- read path ----------------------------------------------------

    def _path(self, hex_key: str) -> str:
        return os.path.join(self.root, hex_key + SUFFIX)

    def _parse_header(self, blob: bytes) -> dict:
        """Validate framing + header seal; raises the format/corruption
        split.  Cheap (no payload CRC) — shared by scan and read."""
        if len(blob) < len(MAGIC) + 1 + _LEN.size:
            raise SpillCorruptionError("truncated preamble")
        if blob[:len(MAGIC)] != MAGIC:
            raise SpillCorruptionError("bad magic")
        if blob[len(MAGIC)] != VERSION:
            raise SpillFormatError(f"version {blob[len(MAGIC)]}")
        offset = len(MAGIC) + 1
        (hdr_len,) = _LEN.unpack_from(blob, offset)
        offset += _LEN.size
        if len(blob) < offset + hdr_len:
            raise SpillCorruptionError("truncated header")
        try:
            header = json.loads(blob[offset:offset + hdr_len])
        except ValueError as exc:
            raise SpillCorruptionError(f"unparsable header: {exc}")
        seal = header.pop("hcrc", None)
        if seal != (zlib.crc32(_canonical(header)) & 0xFFFFFFFF):
            raise SpillCorruptionError("header checksum")
        # Torn write: the rename was atomic but an fsync lie / manual
        # truncation can still shorten the payload — size check catches
        # it without reading a byte of KV.
        if len(blob) != offset + hdr_len + int(header.get("nbytes", -1)):
            raise SpillCorruptionError("payload size mismatch")
        header["_payload_offset"] = offset + hdr_len
        return header

    def read(self, hex_key: str) -> Optional[dict]:
        """Checksum-verified block: ``{"meta": header, "rows": {field:
        uint8 1-D array}}``.  None when the file does not exist;
        :class:`SpillCorruptionError` when any seal trips (the KV
        bytes never leave this function in that case)."""
        try:
            if faults.PLAN is not None:
                params = faults.PLAN.check("slow_disk", key=hex_key)
                if params is not None:
                    time.sleep(float(params.get("ms", 50.0)) / 1000.0)
            with open(self._path(hex_key), "rb") as handle:
                blob = handle.read()
        except FileNotFoundError:
            return None
        except OSError as exc:
            raise SpillCorruptionError(f"unreadable: {exc}")
        header = self._parse_header(blob)
        offset = header.pop("_payload_offset")
        rows: Dict[str, np.ndarray] = {}
        for name, _shape, _dtype, nbytes, crc in header["fields"]:
            raw = blob[offset:offset + int(nbytes)]
            offset += int(nbytes)
            if (zlib.crc32(raw) & 0xFFFFFFFF) != crc:
                raise SpillCorruptionError(f"field {name} checksum")
            rows[name] = np.frombuffer(raw, dtype=np.uint8)
        return {"meta": header, "rows": rows}

    def scan(self) -> Tuple[List[dict], int]:
        """Warm-restart inventory: header-validated metas (chain
        identity, clock, nbytes) of every adoptable block, plus the
        count of corrupt files (deleted here — a torn write must not
        be re-adopted twice).  ``.tmp`` litter from a crash mid-group
        is swept; foreign-version and foreign-layout files are left
        alone.  Payload CRCs are NOT checked here (that cost is paid
        lazily at read, where a trip degrades to recompute)."""
        metas: List[dict] = []
        corrupt = 0
        try:
            names = sorted(os.listdir(self.root))
        except OSError:
            return metas, corrupt
        for name in names:
            path = os.path.join(self.root, name)
            if name.endswith(TMP_SUFFIX):
                try:
                    os.unlink(path)
                except OSError:
                    pass
                continue
            if not name.endswith(SUFFIX):
                continue
            try:
                with open(path, "rb") as handle:
                    blob = handle.read()
                header = self._parse_header(blob)
            except SpillFormatError:
                continue
            except (SpillCorruptionError, OSError):
                corrupt += 1
                try:
                    os.unlink(path)
                except OSError:
                    pass
                continue
            header.pop("_payload_offset", None)
            if header.get("sig") != self.signature or \
                    header.get("block_size") != self.block_size:
                continue
            if header.get("key") != name[:-len(SUFFIX)]:
                corrupt += 1
                try:
                    os.unlink(path)
                except OSError:
                    pass
                continue
            metas.append(header)
        return metas, corrupt

    def discard(self, hex_key: str) -> None:
        try:
            os.unlink(self._path(hex_key))
        except OSError:
            pass
