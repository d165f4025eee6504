"""Wrapper of the hand-written Hopper paged decode-attention kernel.

``csrc/paged_attention.cu`` replaces the Pallas TPU kernel
``repro/kernels/paged_attention.py::paged_flash_decode`` and is held to
``plain.paged_decode_attention_ref``.  A CPU tensor goes to the plain
version; a CUDA tensor launches the kernel (built on first use, see
:mod:`.build`) or raises — there is no fallback.  ``launches`` counts
wrapper calls that launched the kernel.

The kernel's position plan is stated here once: :func:`num_splits` is the
host's split count, from shapes alone, and :func:`split_plan` the
positions each split of a slot walks, which the kernel derives from the
slot's own length (``plain.paged_decode_split_ref`` computes by it on the
CPU).  ``TK``, ``RMAX`` and ``MAX_SPLITS`` are the source's constants.

Head widths: the kernel is built at the (key, value) tile widths in
``HEAD_DIMS``: equal widths of 64, 128 and 256, MLA's (192, 128), and, in
bf16 only, MLA's absorbed decode at (576, 512) (one latent KV head: the
key ``[ckv | kr]``, the value ``ckv``).  Any other pair of multiples of 8
up to 256 (the Pallas kernel takes any width) runs at the narrowest of
the first four tiles that holds it (:func:`tile_dims`): the kernel reads
the pools in place at their own widths and fills the tile's further
columns of K, V and q with zeros in shared memory, and it stores only the
call's Dv output columns.  No pool is padded or copied.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, plain

launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TK = 32             # positions per tile (TK in the source)
RMAX = 8            # query rows per block (RMAX in the source)
MAX_SPLITS = 16     # one cluster of blocks merges a slot's splits
#: (key width, value width) pairs the kernel takes, by dtype
HEAD_DIMS = {torch.bfloat16: ((64, 64), (128, 128), (256, 256), (192, 128),
                              (576, 512)),
             torch.float32: ((64, 64), (128, 128), (256, 256), (192, 128))}
#: the tiles a narrower pair runs at (``launch_d``'s padded instantiations)
PAD_TILES = ((64, 64), (128, 128), (192, 128), (256, 256))
MAX_PAD_WIDTH = 256


def tile_dims(dtype, D, Dv):
    """The (key, value) tile widths the kernel runs a call at (D, Dv): the
    pair itself where it is in ``HEAD_DIMS``, else the narrowest of
    ``PAD_TILES`` (by D + Dv) that holds both, for widths that are
    multiples of 8 up to ``MAX_PAD_WIDTH`` (16-byte rows); None where no
    tile takes the call."""
    if (D, Dv) in HEAD_DIMS.get(dtype, ()):
        return D, Dv
    if dtype not in HEAD_DIMS or min(D, Dv) <= 0 or D % 8 or Dv % 8 \
            or max(D, Dv) > MAX_PAD_WIDTH:
        return None
    return min((t for t in PAD_TILES if t[0] >= D and t[1] >= Dv), key=sum)


def num_splits(B, S, Hq, Hkv, nb, bs, sms):
    """How many chunks each slot's positions are cut into, on a card with
    ``sms`` multiprocessors: split while the unsplit grid has fewer than
    2 * sms blocks, aiming at about two waves of blocks, with at least two
    tiles (2 * TK) of the table's nb * bs positions per chunk and at most
    ``MAX_SPLITS`` (the splits of a slot merge within one cluster of
    blocks).  A one-tile chunk half fills its block's ring and adds a
    split to the merge for little work: at the main paths' tables of 576
    positions this gives 9 splits, the fastest of 5-16 in device time at
    every paged shape (PERF.md section 6).  Shapes alone: no length is
    read from the device."""
    blocks = -(-S * (Hq // Hkv) // RMAX) * Hkv * B
    most = min(-(-nb * bs // (2 * TK)), MAX_SPLITS)
    if blocks >= 2 * sms or most <= 1:
        return 1
    return min(-(-2 * sms // blocks), most)


def split_plan(length, bs, nb, nsplit):
    """The positions ``[lo, hi)`` each of the ``nsplit`` splits of a slot
    of ``length`` walks: the slot's positions below min(length, nb * bs)
    in chunks of ceil(length / nsplit) rounded up to whole tiles of TK, so
    a short slot leaves its last splits empty and a wide table costs
    nothing.  Positions at or past the length are never read."""
    L = min(max(int(length), 0), nb * bs)
    chunk = -(-L // nsplit)           # ceil(L / nsplit) ...
    chunk = -(-chunk // TK) * TK      # ... in whole tiles
    return [(min(L, i * chunk), min(L, (i + 1) * chunk))
            for i in range(nsplit)]


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.load("paged_attention").paged_decode_fwd
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 10
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sms(device_index):
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _check(q, k_pool, v_pool, block_tables, lengths):
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise TypeError(f"q/k_pool/v_pool must share one of {list(_DTYPES)}, "
                        f"got {q.dtype}/{k_pool.dtype}/{v_pool.dtype}")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_tables/lengths must be int32")
    if q.dim() != 4 or k_pool.dim() != 4 or v_pool.dim() != 4:
        raise ValueError("q must be (B, S, Hq, D) and the pools "
                         "(N, block_size, Hkv, D)")
    B, S, Hq, D = q.shape
    N, bs, Hkv, Dv = v_pool.shape
    if k_pool.shape != (N, bs, Hkv, D) or v_pool.shape[:3] != (N, bs, Hkv):
        raise ValueError(f"shapes q {tuple(q.shape)} k_pool "
                         f"{tuple(k_pool.shape)} v_pool {tuple(v_pool.shape)} "
                         "do not match")
    if tile_dims(q.dtype, D, Dv) is None:
        raise NotImplementedError(
            f"head dims (D={D}, Dv={Dv}): the {q.dtype} paged kernel takes "
            f"{HEAD_DIMS[q.dtype]} and pairs of multiples of 8 up to "
            f"{MAX_PAD_WIDTH}")
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or block_tables.shape[1] < 1 or lengths.shape != (B,):
        raise ValueError("block_tables must be (B, nb >= 1) and lengths (B,)")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def paged_flash_decode(q, k_pool, v_pool, *, block_tables, lengths,
                       softcap=0.0, scale=None):
    """(B,S,Hq,D) x pools (N,bs,Hkv,D) / (N,bs,Hkv,Dv) x tables (B,nb) ->
    (B,S,Hq,Dv).

    Slot ``b`` attends causally within its logical positions ``[0,
    lengths[b])``; logical block ``j`` is pool block ``block_tables[b, j]``.
    A CUDA call runs at :func:`tile_dims`' tile, on the pools as given.
    """
    global launches
    if not q.is_cuda:
        return plain.paged_decode_attention_ref(
            q, k_pool, v_pool, block_tables=block_tables, lengths=lengths,
            softcap=softcap, scale=scale)
    _check(q, k_pool, v_pool, block_tables, lengths)
    B, S, Hq, D = q.shape
    _, bs, Hkv, Dv = v_pool.shape
    nb = block_tables.shape[1]
    tD, tDv = tile_dims(q.dtype, D, Dv)
    if scale is None:
        scale = D ** -0.5
    out = q.new_empty((B, S, Hq, Dv))
    fn = _kernel()
    nsplit = num_splits(B, S, Hq, Hkv, nb, bs, _sms(
        q.device.index if q.device.index is not None
        else torch.cuda.current_device()))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                 B, S, Hq, Hkv, D, Dv, tD, tDv, bs, nb, float(scale),
                 float(softcap or 0.0), nsplit, _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"paged_flash_decode kernel launch failed: "
                           f"cudaError {err}")
    launches += 1
    return out
