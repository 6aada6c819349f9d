"""Chunked binary record IO — the RecordIO analog: the port of
paddle_tpu/data/recordio.py, the same format byte for byte, so shards
written by either package read in the other.

The analog of the reference's recordio package
(reference: paddle/fluid/recordio/ — chunk.h (chunked payload with
per-chunk compression + CRC32), header.h (magic/compressor/len),
writer.h, scanner.h; python binding via pybind recordio writer).

Format (little-endian):
    chunk := magic:u32 | compressor:u8 | num_records:u32
             | payload_len:u32 | crc32:u32 | payload
    payload := concat(record_len:u32 | record_bytes)   [zlib if flagged]

`write_arrays`/`read_arrays` layer a numpy (de)serialization on top so
datasets of feature tuples round-trip; `reader_creator` returns a
fluid-style reader over the records for the decorator pipeline
(shuffle/batch/DeviceFeeder).

The chunk codec is native (paddle_tpu_torch/native/recordio.cc through
ctypes) when it builds, else pure Python (the reference's documented
fallback); `codec()` says which one runs.  A CRC mismatch raises IOError
on either codec.
"""

from __future__ import annotations

import io
import os
import struct
import zlib
from typing import Iterable, List, Sequence

import numpy as np

MAGIC = 0x0166CE11
COMPRESS_NONE = 0
COMPRESS_ZLIB = 1
_HEADER = struct.Struct("<IBIII")


class Writer:
    """Chunked record writer (reference recordio/writer.h)."""

    def __init__(self, path: str, max_chunk_records: int = 1000,
                 compressor: int = COMPRESS_ZLIB):
        self._f = open(path, "wb")
        self._max = max_chunk_records
        self._compressor = compressor
        self._records: List[bytes] = []

    def write(self, record: bytes):
        if not isinstance(record, (bytes, bytearray)):
            raise TypeError("records are bytes")
        self._records.append(bytes(record))
        if len(self._records) >= self._max:
            self._flush_chunk()

    def _flush_chunk(self):
        if not self._records:
            return
        chunk = _encode_chunk_native(self._records, self._compressor)
        if chunk is None:
            buf = io.BytesIO()
            for r in self._records:
                buf.write(struct.pack("<I", len(r)))
                buf.write(r)
            payload = buf.getvalue()
            if self._compressor == COMPRESS_ZLIB:
                payload = zlib.compress(payload)
            crc = zlib.crc32(payload) & 0xFFFFFFFF
            chunk = _HEADER.pack(MAGIC, self._compressor,
                                 len(self._records), len(payload),
                                 crc) + payload
        self._f.write(chunk)
        self._records = []

    def close(self):
        self._flush_chunk()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Scanner:
    """Sequential record reader (reference recordio/scanner.h)."""

    def __init__(self, path: str):
        self._path = path

    def __iter__(self):
        with open(self._path, "rb") as f:
            while True:
                head = f.read(_HEADER.size)
                if not head:
                    return
                if len(head) < _HEADER.size:
                    raise IOError("truncated recordio chunk header")
                magic, comp, n, plen, crc = _HEADER.unpack(head)
                if magic != MAGIC:
                    raise IOError(f"bad recordio magic {magic:#x}")
                payload = f.read(plen)
                if len(payload) < plen:
                    raise IOError("truncated recordio chunk payload")
                records = _decode_chunk_native(head + payload, n)
                if records is not None:
                    yield from records
                    continue
                if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
                    raise IOError("recordio chunk CRC mismatch")
                if comp == COMPRESS_ZLIB:
                    payload = zlib.decompress(payload)
                off = 0
                for _ in range(n):
                    (rlen,) = struct.unpack_from("<I", payload, off)
                    off += 4
                    yield payload[off:off + rlen]
                    off += rlen


def codec() -> str:
    """"native" when the C++ codec is built and loaded, else "python"."""
    from ..native import recordio_lib

    return "native" if recordio_lib() is not None else "python"


# ---------------------------------------------------------------------------
# native codec bridge (ctypes → paddle_tpu_torch/native/recordio.cc; wire
# format byte-identical, so files interoperate with the python fallback)
# ---------------------------------------------------------------------------

def _encode_chunk_native(records: Sequence[bytes], compressor: int):
    import ctypes

    from ..native import recordio_lib

    lib = recordio_lib()
    if lib is None:
        return None
    concat = b"".join(records)
    n = len(records)
    lens = (ctypes.c_uint32 * n)(*[len(r) for r in records])
    cap = lib.rio_encode_bound(len(concat), n)
    out_buf = ctypes.create_string_buffer(int(cap))
    written = lib.rio_encode_chunk(concat, lens, n, compressor, out_buf,
                                   cap)
    if written < 0:
        return None
    return out_buf.raw[:written]


def _decode_chunk_native(chunk: bytes, n: int):
    import ctypes

    from ..native import recordio_lib

    lib = recordio_lib()
    if lib is None:
        return None
    # worst case: payload fully expands; retry with growth on -5
    cap = max(4 * len(chunk), 1 << 16)
    for _ in range(6):
        out_buf = ctypes.create_string_buffer(int(cap))
        lens = (ctypes.c_uint32 * max(n, 1))()
        n_out = ctypes.c_int(0)
        rc = lib.rio_decode_chunk(chunk, len(chunk), out_buf, cap, lens,
                                  max(n, 1), ctypes.byref(n_out))
        if rc == 0:
            records = []
            off = 0
            for i in range(n_out.value):
                records.append(out_buf.raw[off:off + lens[i]])
                off += lens[i]
            return records
        if rc == -5:
            cap *= 4
            continue
        if rc == -3:
            raise IOError("recordio chunk CRC mismatch")
        if rc in (-1, -2, -6):
            raise IOError(f"corrupt recordio chunk (native rc={rc})")
        return None  # -4 zlib issue: let python path try
    return None


# ---------------------------------------------------------------------------
# numpy layer
# ---------------------------------------------------------------------------

def _pack_arrays(arrays: Sequence[np.ndarray]) -> bytes:
    buf = io.BytesIO()
    buf.write(struct.pack("<I", len(arrays)))
    for a in arrays:
        a = np.ascontiguousarray(a)
        dt = np.lib.format.dtype_to_descr(a.dtype).encode()
        buf.write(struct.pack("<I", len(dt)))
        buf.write(dt)
        buf.write(struct.pack("<I", a.ndim))
        buf.write(struct.pack(f"<{a.ndim}q", *a.shape))
        raw = a.tobytes()
        buf.write(struct.pack("<Q", len(raw)))
        buf.write(raw)
    return buf.getvalue()


def _unpack_arrays(record: bytes) -> List[np.ndarray]:
    off = 0
    (n,) = struct.unpack_from("<I", record, off)
    off += 4
    arrays = []
    for _ in range(n):
        (dlen,) = struct.unpack_from("<I", record, off)
        off += 4
        dt = np.lib.format.descr_to_dtype(record[off:off + dlen].decode())
        off += dlen
        (ndim,) = struct.unpack_from("<I", record, off)
        off += 4
        shape = struct.unpack_from(f"<{ndim}q", record, off)
        off += 8 * ndim
        (rlen,) = struct.unpack_from("<Q", record, off)
        off += 8
        arrays.append(np.frombuffer(
            record[off:off + rlen], dtype=dt).reshape(shape).copy())
        off += rlen
    return arrays


def write_arrays(path: str, samples: Iterable[Sequence[np.ndarray]],
                 max_chunk_records: int = 1000,
                 compressor: int = COMPRESS_ZLIB) -> int:
    """Write an iterable of array tuples; returns record count."""
    count = 0
    with Writer(path, max_chunk_records, compressor) as w:
        for sample in samples:
            w.write(_pack_arrays([np.asarray(a) for a in sample]))
            count += 1
    return count


def read_arrays(path: str):
    for record in Scanner(path):
        yield _unpack_arrays(record)


def reader_creator(path: str):
    """fluid-style reader over a recordio file — composes with the
    decorator pipeline (data/decorator.py shuffle/batch) and DeviceFeeder
    (reference: recordio readers in operators/reader/ +
    paddle.dataset.common convert/reader_creator)."""

    def reader():
        for arrays in read_arrays(path):
            yield tuple(arrays)

    return reader
