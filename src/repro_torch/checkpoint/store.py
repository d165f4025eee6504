"""Sharded, compressed, atomic checkpoint store: the format of
``repro/checkpoint/store.py``, without JAX or ``msgpack``.

Layout (one directory per checkpoint)::

    <dir>/manifest.msgpack       # entries (name, shape, dtype, shard,
                                 # offset, nbytes), meta, num_shards, codec
    <dir>/shard_00000.bin.zz     # concatenated raw leaf bytes, compressed

Leaves are named by their path in the tree, ``/``-joined, dict keys in
sorted order as JAX flattens them, and grouped into ~``shard_bytes``
shards.  Writes go to ``<dir>.tmp`` and are committed with an atomic
rename, so a preempted save is never mistaken for a checkpoint.  The codec
(``zstd`` when the optional ``zstandard`` package is importable, else
``zlib``; ``raw`` on request) is recorded in the manifest.  The manifest
is msgpack; this module carries its own encoder and decoder of the subset
the manifest uses (maps, arrays, str, bytes, int, float, bool, nil), which
writes the bytes ``msgpack.packb`` writes.  Loading returns CPU tensors
(bfloat16 included, which numpy has no type for).
"""

from __future__ import annotations

import os
import shutil
import struct
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

try:  # optional, as in the reference: zlib keeps the store importable
    import zstandard
except ImportError:
    zstandard = None

_SHARD_EXT = {"zstd": ".bin.zst", "zlib": ".bin.zz", "raw": ".bin"}


# ---------------------------------------------------------------------------
# msgpack, the manifest's subset
# ---------------------------------------------------------------------------


def _pack_into(out: bytearray, x) -> None:
    if x is None:
        out.append(0xC0)
    elif x is True or x is False:
        out.append(0xC3 if x else 0xC2)
    elif isinstance(x, int):
        if 0 <= x < 128:
            out.append(x)
        elif -32 <= x < 0:
            out.append(x & 0xFF)
        elif x >= 0:
            for code, fmt, hi in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                  (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
                if x < hi:
                    out.append(code)
                    out += struct.pack(fmt, x)
                    return
            raise OverflowError(x)
        else:
            for code, fmt, lo in ((0xD0, ">b", -(1 << 7)),
                                  (0xD1, ">h", -(1 << 15)),
                                  (0xD2, ">i", -(1 << 31)),
                                  (0xD3, ">q", -(1 << 63))):
                if x >= lo:
                    out.append(code)
                    out += struct.pack(fmt, x)
                    return
            raise OverflowError(x)
    elif isinstance(x, float):
        out.append(0xCB)
        out += struct.pack(">d", x)
    elif isinstance(x, str):
        raw = x.encode("utf-8")
        n = len(raw)
        if n < 32:
            out.append(0xA0 | n)
        elif n < 1 << 8:
            out += bytes((0xD9, n))
        elif n < 1 << 16:
            out.append(0xDA)
            out += struct.pack(">H", n)
        else:
            out.append(0xDB)
            out += struct.pack(">I", n)
        out += raw
    elif isinstance(x, (bytes, bytearray)):
        n = len(x)
        if n < 1 << 8:
            out += bytes((0xC4, n))
        elif n < 1 << 16:
            out.append(0xC5)
            out += struct.pack(">H", n)
        else:
            out.append(0xC6)
            out += struct.pack(">I", n)
        out += x
    elif isinstance(x, (list, tuple)):
        _pack_len(out, len(x), 0x90, 0xDC, 0xDD)
        for item in x:
            _pack_into(out, item)
    elif isinstance(x, dict):
        _pack_len(out, len(x), 0x80, 0xDE, 0xDF)
        for key, val in x.items():
            _pack_into(out, key)
            _pack_into(out, val)
    else:
        raise TypeError(f"cannot pack {type(x).__name__}")


def _pack_len(out: bytearray, n: int, fix: int, c16: int, c32: int) -> None:
    if n < 16:
        out.append(fix | n)
    elif n < 1 << 16:
        out.append(c16)
        out += struct.pack(">H", n)
    else:
        out.append(c32)
        out += struct.pack(">I", n)


def packb(x) -> bytes:
    """``msgpack.packb(x)`` for maps, arrays, str, bytes, int, float,
    bool and None."""
    out = bytearray()
    _pack_into(out, x)
    return bytes(out)


def unpackb(data: bytes):
    """``msgpack.unpackb(data)`` for what :func:`packb` writes (and
    float32, which msgpack may write)."""
    val, pos = _unpack(memoryview(data), 0)
    if pos != len(data):
        raise ValueError(f"{len(data) - pos} bytes after the manifest")
    return val


_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b",
          0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}


def _unpack(buf, pos: int):
    c = buf[pos]
    pos += 1
    if c < 0x80:
        return c, pos
    if c >= 0xE0:
        return c - 0x100, pos
    if 0xA0 <= c <= 0xBF:
        return _str(buf, pos, c & 0x1F)
    if 0x90 <= c <= 0x9F:
        return _array(buf, pos, c & 0x0F)
    if 0x80 <= c <= 0x8F:
        return _map(buf, pos, c & 0x0F)
    if c == 0xC0:
        return None, pos
    if c in (0xC2, 0xC3):
        return c == 0xC3, pos
    if c in _FIXED:
        fmt = _FIXED[c]
        n = struct.calcsize(fmt)
        return struct.unpack(fmt, bytes(buf[pos:pos + n]))[0], pos + n
    lens = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xC4: ">B", 0xC5: ">H",
            0xC6: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}
    if c not in lens:
        raise ValueError(f"msgpack type 0x{c:02x} is not in the manifest's "
                         "subset")
    fmt = lens[c]
    k = struct.calcsize(fmt)
    n = struct.unpack(fmt, bytes(buf[pos:pos + k]))[0]
    pos += k
    if c in (0xD9, 0xDA, 0xDB):
        return _str(buf, pos, n)
    if c in (0xC4, 0xC5, 0xC6):
        return bytes(buf[pos:pos + n]), pos + n
    if c in (0xDC, 0xDD):
        return _array(buf, pos, n)
    return _map(buf, pos, n)


def _str(buf, pos, n):
    return bytes(buf[pos:pos + n]).decode("utf-8"), pos + n


def _array(buf, pos, n):
    out = []
    for _ in range(n):
        val, pos = _unpack(buf, pos)
        out.append(val)
    return out, pos


def _map(buf, pos, n):
    out = {}
    for _ in range(n):
        key, pos = _unpack(buf, pos)
        out[key], pos = _unpack(buf, pos)
    return out, pos


# ---------------------------------------------------------------------------
# Codecs
# ---------------------------------------------------------------------------


def default_codec() -> str:
    return "zstd" if zstandard is not None else "zlib"


def _shard_ext(codec: str) -> str:
    if codec not in _SHARD_EXT:
        raise ValueError(f"unknown checkpoint codec {codec!r}; "
                         f"choose from {sorted(_SHARD_EXT)}")
    return _SHARD_EXT[codec]


def compress_bytes(data: bytes, codec: Optional[str] = None,
                   level: int = 3) -> Tuple[str, bytes]:
    """Compress a byte string; returns ``(codec, payload)``."""
    codec = codec or default_codec()
    if codec == "zstd":
        if zstandard is None:
            raise ImportError("codec 'zstd' requires the zstandard package")
        return codec, zstandard.ZstdCompressor(level=level).compress(data)
    if codec == "zlib":
        return codec, zlib.compress(data, level)
    if codec == "raw":
        return codec, data
    raise ValueError(f"unknown checkpoint codec {codec!r}; "
                     f"choose from {sorted(_SHARD_EXT)}")


def decompress_bytes(data: bytes, codec: str) -> bytes:
    if codec == "zstd":
        if zstandard is None:
            raise ImportError("checkpoint written with codec 'zstd' but "
                              "zstandard is not installed")
        return zstandard.ZstdDecompressor().decompress(data)
    if codec == "zlib":
        return zlib.decompress(data)
    if codec == "raw":
        return data
    raise ValueError(f"unknown checkpoint codec {codec!r}")


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------


def flatten(tree: Any, path: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in JAX's flattening order: dict keys sorted,
    sequences by index, None an empty subtree."""
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += flatten(tree[key], f"{path}/{key}" if path else str(key))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, sub in enumerate(tree):
            out += flatten(sub, f"{path}/{i}" if path else str(i))
        return out
    if tree is None:
        return []
    return [(path, tree)]


def _unflatten(template: Any, arrays: Dict[str, torch.Tensor],
               path: str = ""):
    if isinstance(template, dict):
        return {key: _unflatten(sub, arrays, f"{path}/{key}" if path
                                else str(key))
                for key, sub in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(
            _unflatten(sub, arrays, f"{path}/{i}" if path else str(i))
            for i, sub in enumerate(template))
    if template is None:
        return None
    return arrays[path]


def _leaf_bytes(leaf) -> Tuple[bytes, List[int], str]:
    if torch.is_tensor(leaf):
        t = leaf.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return (t.view(torch.int16).numpy().tobytes(), list(t.shape),
                    "bfloat16")
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr.tobytes(), list(arr.shape), str(arr.dtype)


def _leaf_tensor(raw: bytes, shape, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        arr = np.frombuffer(raw, dtype=np.int16).reshape(shape)
        return torch.from_numpy(arr.copy()).view(torch.bfloat16)
    arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)
    return torch.from_numpy(arr.copy())


def save_tree(path: str, tree: Any, meta: Optional[Dict] = None,
              shard_bytes: int = 64 * 1024 * 1024, level: int = 3,
              codec: Optional[str] = None) -> None:
    """Write ``tree`` (nested dicts / lists of tensors or arrays) to
    ``path`` atomically."""
    codec = codec or default_codec()
    ext = _shard_ext(codec)
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    entries = []
    shard_id, shard_buf, shard_size = 0, [], 0

    def flush():
        nonlocal shard_id, shard_buf, shard_size
        if not shard_buf:
            return
        data = b"".join(shard_buf)
        with open(os.path.join(tmp, f"shard_{shard_id:05d}{ext}"), "wb") as f:
            f.write(compress_bytes(data, codec, level)[1])
        shard_id += 1
        shard_buf, shard_size = [], 0

    for name, leaf in flatten(tree):
        raw, shape, dtype = _leaf_bytes(leaf)
        entries.append({"name": name, "shape": shape, "dtype": dtype,
                        "shard": shard_id, "offset": shard_size,
                        "nbytes": len(raw)})
        shard_buf.append(raw)
        shard_size += len(raw)
        if shard_size >= shard_bytes:
            flush()
    flush()
    manifest = {"entries": entries, "meta": meta or {}, "num_shards": shard_id,
                "codec": codec}
    with open(os.path.join(tmp, "manifest.msgpack"), "wb") as f:
        f.write(packb(manifest))
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)  # atomic commit


def load_tree(path: str, template: Any = None):
    """Returns ({name: CPU tensor}, meta), or (tree, meta) shaped like
    ``template`` (names matching) when one is given."""
    with open(os.path.join(path, "manifest.msgpack"), "rb") as f:
        manifest = unpackb(f.read())
    codec = manifest.get("codec", "zstd")  # pre-codec checkpoints: zstd
    ext = _shard_ext(codec)
    shards, arrays = {}, {}
    for e in manifest["entries"]:
        sid = e["shard"]
        if sid not in shards:
            with open(os.path.join(path, f"shard_{sid:05d}{ext}"), "rb") as f:
                shards[sid] = decompress_bytes(f.read(), codec)
        raw = shards[sid][e["offset"]:e["offset"] + e["nbytes"]]
        arrays[e["name"]] = _leaf_tensor(raw, e["shape"], e["dtype"])
    if template is None:
        return arrays, manifest["meta"]
    return _unflatten(template, arrays), manifest["meta"]
