"""Minimal zarr-v2-compatible chunked array store (directory layout).

Plays the role of the reference's zarr intermediate store
(``process_manager.py:362-390, 993-1059``) without the
zarr dependency: each array is a directory holding a ``.zarray`` JSON plus
row-major chunk files (``"i.j"``), raw or zlib-compressed.  Arrays written
here are readable by real zarr (v2) and vice versa for the subset we emit
(C-order, no filters, zlib or raw).

Host-only code (numpy/scipy, no tensor library): a copy of
``pydem_tpu/io/store.py`` of the JAX package, the body unchanged below this
docstring, kept here because the port imports nothing of that package.
"""
from __future__ import annotations

import json
import os
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# shared pool for chunk-file IO: file reads/writes and zlib release the GIL,
# so multi-chunk windows stream at near-device-bandwidth.  Calls issued from
# INSIDE a pool task (e.g. a prefetch thread layered on the store) would
# deadlock when the pool saturates, so submission is guarded by a
# thread-local flag: nested calls fall back to serial execution.
_IO_POOL = ThreadPoolExecutor(max_workers=8)
_IN_POOL = threading.local()


def _pool_map(fn, items):
    """Map chunk tasks over the IO pool; serial when already inside it."""
    if getattr(_IN_POOL, "active", False):
        return [fn(it) for it in items]

    def wrapped(it):
        _IN_POOL.active = True
        try:
            return fn(it)
        finally:
            _IN_POOL.active = False

    return list(_IO_POOL.map(wrapped, items))

_DTYPE_MAP = {
    "float64": "<f8", "float32": "<f4", "int64": "<i8", "int32": "<i4",
    "uint8": "|u1", "bool": "|b1", "int8": "|i1",
}


class ArrayStore:
    """Directory of named chunked arrays (zarr-v2 layout)."""

    def __init__(self, root):
        self.root = root
        os.makedirs(root, exist_ok=True)
        zgroup = os.path.join(root, ".zgroup")
        if not os.path.exists(zgroup):
            with open(zgroup, "w") as f:
                json.dump({"zarr_format": 2}, f)

    def _adir(self, name):
        return os.path.join(self.root, name)

    def names(self):
        return sorted(
            d for d in os.listdir(self.root)
            if os.path.isdir(self._adir(d))
            and os.path.exists(os.path.join(self._adir(d), ".zarray")))

    def __contains__(self, name):
        return os.path.exists(os.path.join(self._adir(name), ".zarray"))

    def create(self, name, shape, dtype="float64", chunks=None, fill=0,
               compress=True, overwrite=False):
        d = self._adir(name)
        meta_fn = os.path.join(d, ".zarray")
        if os.path.exists(meta_fn) and not overwrite:
            return
        os.makedirs(d, exist_ok=True)
        dtype = np.dtype(dtype)
        chunks = list(chunks or shape)
        meta = {
            "zarr_format": 2,
            "shape": list(shape),
            "chunks": chunks,
            "dtype": _DTYPE_MAP[dtype.name],
            "compressor": ({"id": "zlib", "level": 4} if compress else None),
            # zarr-v2 serializes a NaN fill as the string "NaN" (§fill
            # value encoding); null would mean "undefined"
            "fill_value": (bool(fill) if dtype.kind == "b" else
                           ("NaN" if (isinstance(fill, float)
                                      and np.isnan(fill)) else fill)),
            "filters": None,
            "order": "C",
        }
        with open(meta_fn, "w") as f:
            json.dump(meta, f)

    def delete(self, name):
        """Remove an array (directory + metadata); silent if absent."""
        import shutil

        shutil.rmtree(self._adir(name), ignore_errors=True)

    def _meta(self, name):
        with open(os.path.join(self._adir(name), ".zarray")) as f:
            return json.load(f)

    def write(self, name, data, offset=(0, 0)):
        """Write a 2-D block at ``offset``.  Chunk-granular: only chunks
        intersecting the window are touched (read-modify-written at the
        partially-covered border), so writes are O(window), not O(array) —
        the property the out-of-core pipeline relies on."""
        meta = self._meta(name)
        shape = meta["shape"]
        data = np.asarray(data)
        if tuple(offset) == (0, 0) and list(data.shape) == shape:
            self._write_full(name, data, meta)
            return
        self.write_window(name, data, offset)

    def _fill_of(self, meta):
        dtype = np.dtype(meta["dtype"])
        fill = meta.get("fill_value")
        if fill in ("NaN", "Infinity", "-Infinity"):
            fill = float(fill.replace("Infinity", "inf"))
        if fill is None:
            fill = np.nan if dtype.kind == "f" else 0
        return fill

    def _chunk_fn(self, name, ci, cj):
        return os.path.join(self._adir(name), "%d.%d" % (ci, cj))

    def _read_chunk(self, name, meta, ci, cj):
        """One chunk as an array (fill-valued if the chunk file is absent)."""
        dtype = np.dtype(meta["dtype"])
        fn = self._chunk_fn(name, ci, cj)
        if not os.path.exists(fn):
            return np.full(meta["chunks"], self._fill_of(meta),
                           dtype.newbyteorder("="))
        with open(fn, "rb") as f:
            raw = f.read()
        if meta["compressor"]:
            raw = zlib.decompress(raw)
        return (np.frombuffer(raw, dtype).reshape(meta["chunks"])
                .astype(dtype.newbyteorder("=")))

    def _write_chunk(self, name, meta, ci, cj, block):
        dtype = np.dtype(meta["dtype"])
        raw = np.ascontiguousarray(block, dtype).tobytes()
        if meta["compressor"]:
            raw = zlib.compress(raw, meta["compressor"].get("level", 4))
        with open(self._chunk_fn(name, ci, cj), "wb") as f:
            f.write(raw)

    def read_window(self, name, rows, cols):
        """Read the window ``[rows[0]:rows[1], cols[0]:cols[1]]`` touching
        only intersecting chunks.  Out-of-bounds regions come back as the
        fill value (NaN for floats), so halo windows at the canvas border
        need no special-casing by the caller."""
        meta = self._meta(name)
        (n, m), (ch0, ch1) = meta["shape"], meta["chunks"]
        dtype = np.dtype(meta["dtype"]).newbyteorder("=")
        r0, r1 = rows
        c0, c1 = cols
        out = np.full((r1 - r0, c1 - c0), self._fill_of(meta), dtype)
        ir0, ir1 = max(r0, 0), min(r1, n)
        ic0, ic1 = max(c0, 0), min(c1, m)
        if ir0 >= ir1 or ic0 >= ic1:
            return out

        def one(ci, cj):
            blk = self._read_chunk(name, meta, ci, cj)
            # intersection of this chunk with the in-bounds window
            gr0 = max(ir0, ci * ch0)
            gr1 = min(ir1, (ci + 1) * ch0, n)
            gc0 = max(ic0, cj * ch1)
            gc1 = min(ic1, (cj + 1) * ch1, m)
            out[gr0 - r0: gr1 - r0, gc0 - c0: gc1 - c0] = \
                blk[gr0 - ci * ch0: gr1 - ci * ch0,
                    gc0 - cj * ch1: gc1 - cj * ch1]

        jobs = [(ci, cj)
                for ci in range(ir0 // ch0, (ir1 - 1) // ch0 + 1)
                for cj in range(ic0 // ch1, (ic1 - 1) // ch1 + 1)]
        if len(jobs) > 1:
            _pool_map(lambda a: one(*a), jobs)
        else:
            one(*jobs[0])
        return out

    def write_window(self, name, data, offset):
        """Write ``data`` at ``offset`` (clipped to the array bounds),
        chunk-granular with read-modify-write at partially-covered chunks."""
        meta = self._meta(name)
        (n, m), (ch0, ch1) = meta["shape"], meta["chunks"]
        dtype = np.dtype(meta["dtype"])
        data = np.asarray(data)
        r0, c0 = offset
        r1, c1 = r0 + data.shape[0], c0 + data.shape[1]
        ir0, ir1 = max(r0, 0), min(r1, n)
        ic0, ic1 = max(c0, 0), min(c1, m)
        if ir0 >= ir1 or ic0 >= ic1:
            return

        def one(ci, cj):
            gr0 = max(ir0, ci * ch0)
            gr1 = min(ir1, (ci + 1) * ch0, n)
            gc0 = max(ic0, cj * ch1)
            gc1 = min(ic1, (cj + 1) * ch1, m)
            full_cover = (gr0 == ci * ch0 and gc0 == cj * ch1
                          and gr1 - gr0 == ch0 and gc1 - gc0 == ch1)
            if full_cover:
                blk = data[gr0 - r0: gr1 - r0, gc0 - c0: gc1 - c0]
            else:
                blk = self._read_chunk(name, meta, ci, cj)
                blk[gr0 - ci * ch0: gr1 - ci * ch0,
                    gc0 - cj * ch1: gc1 - cj * ch1] = \
                    data[gr0 - r0: gr1 - r0, gc0 - c0: gc1 - c0]
            self._write_chunk(name, meta, ci, cj, blk.astype(dtype))

        jobs = [(ci, cj)
                for ci in range(ir0 // ch0, (ir1 - 1) // ch0 + 1)
                for cj in range(ic0 // ch1, (ic1 - 1) // ch1 + 1)]
        if len(jobs) > 1:
            _pool_map(lambda a: one(*a), jobs)
        else:
            one(*jobs[0])

    def _write_full(self, name, data, meta):
        d = self._adir(name)
        shape, chunks = meta["shape"], meta["chunks"]
        dtype = np.dtype(meta["dtype"])
        nci = (shape[0] + chunks[0] - 1) // chunks[0]
        ncj = (shape[1] + chunks[1] - 1) // chunks[1] if len(shape) > 1 else 1
        for ci in range(nci):
            for cj in range(ncj):
                block = np.zeros(chunks, dtype)
                i0, j0 = ci * chunks[0], cj * chunks[1]
                si = min(chunks[0], shape[0] - i0)
                sj = min(chunks[1], shape[1] - j0) if len(shape) > 1 else 1
                block[:si, :sj] = data[i0: i0 + si, j0: j0 + sj]
                raw = block.astype(dtype).tobytes()
                if meta["compressor"]:
                    raw = zlib.compress(raw, meta["compressor"].get("level", 4))
                with open(os.path.join(d, "%d.%d" % (ci, cj)), "wb") as f:
                    f.write(raw)

    def read(self, name):
        meta = self._meta(name)
        shape, chunks = meta["shape"], meta["chunks"]
        dtype = np.dtype(meta["dtype"])
        out = np.full(shape, self._fill_of(meta), dtype)
        d = self._adir(name)
        nci = (shape[0] + chunks[0] - 1) // chunks[0]
        ncj = (shape[1] + chunks[1] - 1) // chunks[1] if len(shape) > 1 else 1
        for ci in range(nci):
            for cj in range(ncj):
                fn = os.path.join(d, "%d.%d" % (ci, cj))
                if not os.path.exists(fn):
                    continue
                with open(fn, "rb") as f:
                    raw = f.read()
                if meta["compressor"]:
                    raw = zlib.decompress(raw)
                block = np.frombuffer(raw, dtype).reshape(chunks)
                i0, j0 = ci * chunks[0], cj * chunks[1]
                si = min(chunks[0], shape[0] - i0)
                sj = min(chunks[1], shape[1] - j0)
                out[i0: i0 + si, j0: j0 + sj] = block[:si, :sj]
        return out.astype(dtype.newbyteorder("="))

    def __getitem__(self, name):
        return self.read(name)

    def __setitem__(self, name, data):
        data = np.asarray(data)
        self.create(name, data.shape, data.dtype, overwrite=True)
        self.write(name, data)
