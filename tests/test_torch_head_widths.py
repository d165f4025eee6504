"""The flash and paged wrappers at the head widths the Pallas kernels take
and no CUDA kernel is built for (the smoke configs' 16, 32 and MLA's (24,
16), (40, 32); any pair of multiples of 8 up to 256), routed on the CPU:
the ctypes kernels, the device guard and the stream are stood in for, as
in ``tests/test_torch_mla.py``, and a CPU tensor that reports ``is_cuda``
takes the wrappers' CUDA branch.

What they show: which widths run padded and to which tile, that the
widths the kernels are built for reach them unpadded, that the padded
call computes the function of the unpadded one (the kernel stood in for
by the plain version on the padded tensors), that a gradient flows
through the pad, and that the paged kernel gets the pools themselves (no
copy) with the call's widths beside the tile's.  The kernels themselves
at these widths are held to the plain versions by the ``cuda`` tests in
``tests/test_torch_cuda_kernels.py``.
"""

import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import plain


class _LooksCuda(torch.Tensor):
    """A CPU tensor that reports ``is_cuda``."""

    @property
    def is_cuda(self):
        return True


def _fake(t, grad=False):
    return torch.Tensor._make_subclass(_LooksCuda, t, grad)


def _plain_tensor(t):
    return t.as_subclass(torch.Tensor)


class _Guard:
    def __init__(self, *a):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


class _Stream:
    cuda_stream = 0


@pytest.fixture
def kernels(monkeypatch):
    """Stand-ins for the ctypes kernels; returns the list of launches as
    (kernel, D, Dv, q pointer, k pointer, v pointer[, tile D, tile Dv])."""
    calls = []

    def flash(*a):  # (8 pointers, B, Sq, Skv, Hq, Hkv, D, Dv, ...)
        calls.append(("flash", a[13], a[14], a[0], a[1], a[2]))
        return 0

    def wgmma(*a):  # (7 pointers, B, Sq, Skv, Hq, Hkv, D, Dv, ...)
        calls.append(("wgmma", a[12], a[13], a[0], a[1], a[2]))
        return 0

    def bwd(*a):  # (13 pointers, B, Sq, Skv, Hq, Hkv, D, Dv, ...)
        calls.append(("bwd", a[18], a[19], a[0], a[1], a[2]))
        return 0

    def bwd_wgmma(*a):  # (14 pointers, B, Sq, Skv, Hq, Hkv, D, Dv, ...)
        calls.append(("bwd_wgmma", a[19], a[20], a[0], a[1], a[2]))
        return 0

    def paged(*a):  # (6 pointers, B, S, Hq, Hkv, D, Dv, tD, tDv, ...)
        calls.append(("paged", a[10], a[11], a[0], a[1], a[2], a[12], a[13]))
        return 0

    monkeypatch.setattr(fa, "_kernel", lambda: (flash, None, wgmma))
    monkeypatch.setattr(fa, "_bwd_kernel",
                        lambda: (bwd, bwd_wgmma, lambda *a: 64))
    monkeypatch.setattr(fa, "_splits", lambda *a: 1)
    monkeypatch.setattr(fa, "_sms", lambda i: 132)
    monkeypatch.setattr(pa, "_kernel", lambda: paged)
    monkeypatch.setattr(pa, "_sms", lambda i: 132)
    monkeypatch.setattr(torch.cuda, "device", _Guard)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    return calls


BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("D,Dv,dtype,want", [
    # the widths the kernels are built for keep them
    (64, 64, BF16, (64, 64)), (128, 128, BF16, (128, 128)),
    (256, 256, BF16, (256, 256)), (192, 128, BF16, (192, 128)),
    (576, 512, BF16, (576, 512)), (192, 128, F32, (192, 128)),
    (16, 16, F32, (16, 16)), (32, 32, F32, (32, 32)), (12, 12, F32, (12, 12)),
    # whisper and jamba smoke (16), qwen2-vl smoke and the bench target
    # (32), deepseek smoke's MLA pairs
    (16, 16, BF16, (64, 64)), (32, 32, BF16, (64, 64)),
    (24, 16, BF16, (64, 64)), (40, 32, BF16, (64, 64)),
    (24, 16, F32, (24, 24)), (40, 32, F32, (40, 40)),
    (96, 96, BF16, (128, 128)), (136, 64, BF16, (192, 128)),
    (200, 200, BF16, (256, 256)), (8, 8, BF16, (64, 64)),
    (64, 256, F32, (256, 256)),
    # nothing takes these
    (264, 264, BF16, None), (20, 16, BF16, None), (36, 16, F32, None),
    (576, 512, F32, None)])
def test_flash_tile_dims(D, Dv, dtype, want):
    assert fa.tile_dims(dtype, D, Dv) == want


@pytest.mark.parametrize("D,Dv,dtype,want", [
    (64, 64, BF16, (64, 64)), (128, 128, F32, (128, 128)),
    (192, 128, BF16, (192, 128)), (576, 512, BF16, (576, 512)),
    (16, 16, BF16, (64, 64)), (16, 16, F32, (64, 64)),
    (32, 32, F32, (64, 64)), (24, 16, BF16, (64, 64)),
    (40, 32, F32, (64, 64)), (72, 8, BF16, (128, 128)),
    (136, 128, F32, (192, 128)), (248, 256, BF16, (256, 256)),
    (264, 256, BF16, None), (12, 12, F32, None), (576, 512, F32, None)])
def test_paged_tile_dims(D, Dv, dtype, want):
    assert pa.tile_dims(dtype, D, Dv) == want


def _qkv(B, Sq, Skv, Hq, Hkv, D, Dv, dtype, grad=False, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, Sq, Hq, D, generator=g).to(dtype)
    k = torch.randn(B, Skv, Hkv, D, generator=g).to(dtype)
    v = torch.randn(B, Skv, Hkv, Dv, generator=g).to(dtype)
    kv_pos = torch.arange(Skv, dtype=torch.int32)[None].expand(B, Skv)
    return q, k, v, kv_pos[:, Skv - Sq:].contiguous(), kv_pos.contiguous()


@pytest.mark.parametrize("D,Dv,dtype", [
    (64, 64, BF16), (128, 128, BF16), (256, 256, BF16), (192, 128, BF16),
    (192, 128, F32), (32, 32, F32), (16, 16, F32)])
def test_native_widths_are_not_padded(kernels, D, Dv, dtype):
    """A call at widths a kernel is built for reaches it with q, k and v
    themselves (their own pointers), one launch."""
    q, k, v, q_pos, kv_pos = (_fake(t) for t in _qkv(1, 4, 40, 4, 2, D, Dv,
                                                     dtype))
    out = fa.flash_attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos)
    assert tuple(out.shape) == (1, 4, 4, Dv)
    assert len(kernels) == 1 and kernels[0][1:] == (
        D, Dv, q.data_ptr(), k.data_ptr(), v.data_ptr())


@pytest.mark.parametrize("D,Dv,dtype", [
    (16, 16, BF16), (32, 32, BF16), (24, 16, BF16), (40, 32, BF16),
    (96, 96, BF16), (24, 16, F32), (40, 32, F32)])
def test_padded_widths_launch_the_tile(kernels, D, Dv, dtype):
    """A call at other widths launches the kernel once at the tile, on
    padded copies (other pointers), and gives a (.., Dv) output; the
    backward does the same and cuts dq, dk, dv back to (D, D, Dv)."""
    tD, tDv = fa.tile_dims(dtype, D, Dv)
    q, k, v, q_pos, kv_pos = (_fake(t) for t in _qkv(1, 4, 40, 4, 2, D, Dv,
                                                     dtype))
    before = fa.launches
    out, lse = fa.flash_attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                                  return_lse=True)
    assert tuple(out.shape) == (1, 4, 4, Dv) and tuple(lse.shape) == (1, 4, 4)
    assert fa.launches == before + 1 and len(kernels) == 1
    assert kernels[0][1:3] == (tD, tDv)
    assert kernels[0][3] != q.data_ptr() and kernels[0][5] != v.data_ptr()
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, _fake(out), _fake(lse),
                                        _fake(out), q_pos=q_pos,
                                        kv_pos=kv_pos)
    assert kernels[1][1:3] == (tD, tDv) and kernels[1][0].startswith("bwd")
    assert [tuple(t.shape) for t in (dq, dk, dv)] == [
        (1, 4, 4, D), (1, 40, 2, D), (1, 40, 2, Dv)]


def _plain_forward(seen):
    """A stand-in for the wrapper's kernel call: the plain version on the
    (padded) tensors it is given, recording their widths."""
    def forward(q, k, v, q_pos, kv_pos, causal, softcap, scale, variant):
        seen.append((q.shape[-1], v.shape[-1], scale))
        out, lse = plain.attention_ref(
            *(_plain_tensor(t) for t in (q, k, v)),
            q_pos=_plain_tensor(q_pos), kv_pos=_plain_tensor(kv_pos),
            causal=causal, softcap=softcap, scale=scale, return_lse=True)
        return _fake(out), _fake(lse)
    return forward


@pytest.mark.parametrize("D,Dv,dtype,causal,softcap", [
    (16, 16, F32, True, 0.0), (24, 16, F32, False, 0.0),
    (40, 32, F32, True, 50.0), (32, 32, F32, True, 0.0),
    (24, 16, BF16, True, 0.0), (136, 64, F32, False, 30.0)])
def test_padded_call_computes_the_unpadded_function(kernels, monkeypatch, D,
                                                    Dv, dtype, causal,
                                                    softcap):
    """With the kernel stood in for by the plain version on the tensors it
    is handed, the padded call's output and lse are the unpadded call's
    (the zero columns add nothing to a logit; the default scale is the
    true D's), and the kernel saw the tile's widths."""
    seen = []
    monkeypatch.setattr(fa, "_forward", _plain_forward(seen))
    want = fa.tile_dims(dtype, D, Dv)
    # unpadded, the kernel call is handed no scale and takes D ** -0.5
    scale = None if want == (D, Dv) else D ** -0.5
    q, k, v, q_pos, kv_pos = _qkv(2, 5, 11, 6, 2, D, Dv, dtype)
    out, lse = fa.flash_attention(
        *(_fake(t) for t in (q, k, v)), q_pos=_fake(q_pos),
        kv_pos=_fake(kv_pos), causal=causal, softcap=softcap,
        return_lse=True)
    ref, ref_lse = plain.attention_ref(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                                       causal=causal, softcap=softcap,
                                       return_lse=True)
    assert seen == [(*want, scale)]
    tol = 1e-5 if dtype == F32 else 1e-2
    assert float((_plain_tensor(out).float() - ref.float()).abs().max()) <= tol
    assert float((_plain_tensor(lse) - ref_lse).abs().max()) <= 1e-4


@pytest.mark.parametrize("D,Dv", [(16, 8), (24, 16), (40, 32)])
def test_gradient_flows_through_the_pad(kernels, monkeypatch, D, Dv):
    """A gradient-needing float32 call at a padded width goes through
    ``FlashAttention`` at the tile (the forward and backward kernels
    stood in for by the plain versions on what they are handed); the
    gradients reaching q, k and v are those of the unpadded plain call."""
    seen, seen_bwd = [], []
    monkeypatch.setattr(fa, "_forward", _plain_forward(seen))

    def bwd(q, k, v, out, lse, dout, dlse, *, q_pos, kv_pos, causal,
            softcap, scale, need_dq):
        seen_bwd.append((q.shape[-1], v.shape[-1]))
        args = [None if t is None else _plain_tensor(t)
                for t in (q, k, v, out, lse, dout, dlse)]
        return tuple(_fake(t) for t in plain.attention_bwd_ref(
            *args, q_pos=_plain_tensor(q_pos), kv_pos=_plain_tensor(kv_pos),
            causal=causal, softcap=softcap, scale=scale))

    monkeypatch.setattr(fa, "flash_attention_bwd", bwd)
    q, k, v, q_pos, kv_pos = _qkv(1, 6, 9, 4, 2, D, Dv, F32)
    fq, fk, fv = (_fake(t.clone(), grad=True) for t in (q, k, v))
    out = fa.flash_attention(fq, fk, fv, q_pos=_fake(q_pos),
                             kv_pos=_fake(kv_pos))
    w = torch.randn(out.shape, generator=torch.Generator().manual_seed(3))
    (out * w).sum().backward()
    tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
    ref = plain.attention_ref(tq, tk, tv, q_pos=q_pos, kv_pos=kv_pos)
    (ref * w).sum().backward()
    tile = fa.tile_dims(F32, D, Dv)
    assert seen == [(*tile, D ** -0.5)] and seen_bwd == [tile]
    for got, want in ((fq, tq), (fk, tk), (fv, tv)):
        assert got.grad.shape == want.shape
        assert float((_plain_tensor(got.grad) - want.grad).abs().max()) <= 1e-5


@pytest.mark.parametrize("D,Dv,dtype", [
    (16, 16, BF16), (32, 32, F32), (24, 16, BF16), (40, 32, F32),
    (64, 64, BF16), (128, 128, F32)])
def test_paged_kernel_reads_the_pools_in_place(kernels, D, Dv, dtype):
    """The paged wrapper never pads or copies a pool: the kernel gets q and
    the pools' own pointers, the call's widths and the tile's."""
    g = torch.Generator().manual_seed(1)
    q = _fake(torch.randn(2, 1, 12, D, generator=g).to(dtype))
    kp = _fake(torch.randn(9, 4, 2, D, generator=g).to(dtype))
    vp = _fake(torch.randn(9, 4, 2, Dv, generator=g).to(dtype))
    tables = _fake(torch.arange(1, 9, dtype=torch.int32).reshape(2, 4))
    lens = _fake(torch.tensor([5, 16], dtype=torch.int32))
    out = pa.paged_flash_decode(q, kp, vp, block_tables=tables, lengths=lens)
    assert tuple(out.shape) == (2, 1, 12, Dv)
    assert kernels == [("paged", D, Dv, q.data_ptr(), kp.data_ptr(),
                        vp.data_ptr(), *pa.tile_dims(dtype, D, Dv))]
