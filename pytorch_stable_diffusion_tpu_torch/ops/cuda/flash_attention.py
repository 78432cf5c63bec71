"""Flash attention kernels of the port and their plain PyTorch versions.

* K1, heads packed in channels (B, S, H*Dh): port of
  ``pytorch_stable_diffusion_tpu/ops/pallas/flash_attention.py::
  flash_attention_bsc`` (the Pallas ``_bsc_kernel``), CUDA kernel
  ``csrc/flash_attention_bsc.cu``.
* K4, streamed long-KV attention on head-split (B, H, S, Dh), Dh <= 128,
  non-causal: port of ``_flash_attention_streamed`` (``_streamed_kernel``),
  CUDA kernel ``csrc/flash_attention_streamed.cu``.
* K3, multi-pass attention on head-split (B, H, S, Dh), Dh up to 512 (a
  multiple of 8 on the card), causal or not, KV of any length: port of
  ``flash_attention``'s multi-pass grid (``_kernel``), CUDA kernel
  ``csrc/flash_attention_multipass.cu`` (tensor cores in bf16, the head
  dim split across two consumer warpgroups).
* K2, one-pass attention on head-split (B, H, S, Dh), Dh up to 160, causal
  or not, padded KV up to 9216: port of ``flash_attention``'s one-pass call
  (``_onepass_kernel`` with ``_chunk_softmax_stats``), CUDA kernel
  ``csrc/flash_attention_onepass.cu`` (in bf16 the tensor-core template of
  K1 and K4 with a causal mode, K/V resident across a CTA's q tiles where
  they fit, and a 64-row schedule for small grids: :func:`onepass_schedule`).

Each kernel's header says what bounds it on the H100 and what its
design leaves on the table.  Which head dims each kernel takes is
:func:`takes_head_dim`, which ``ops.attention.route`` also reads.  All compute softmax(Q Kᵀ/√Dh)·V with fp32
scores and softmax and return q's dtype; a row with every score masked
gives 0 (output acc / max(l, 1e-30)).

Every kernel has a plain PyTorch version (``*_plain``) beside it.  Each
kernel is a ``torch.library`` op in the :data:`NAMESPACE` namespace
(``torch.ops.sdt_torch.flash_attention_bsc`` and so on), so that
``torch.export`` and other graph tracers record the op itself rather than
trace into either version: its CPU implementation runs the plain version,
its CUDA implementation launches the kernel or raises (there is no
fallback), and its fake implementation gives the output's shape, dtype and
strides on either device, launching nothing.  The device is chosen by the
dispatcher when the op runs, so an exported program launches the kernel
on the card.  The public wrappers check their arguments and call the op;
each counts its kernel launches in ``<wrapper>.launches``, incremented
inside the CUDA implementation where the kernel is launched, and nowhere
else (tracing counts nothing).

q, k and v may be strided views, e.g. the slices of the fused q/k/v
projection whose rows are 3C apart, or of the fused k/v projection of a
cross-attention context (2C apart): the kernels take the strides, so
nothing is copied.  Only the last (channel) stride must be 1.
"""

from __future__ import annotations

import ctypes
import math

import torch

#: K1's instantiations: SD-1.5's 40, 80, 160, 64 (SD-2.x/SDXL, and SD-1.5
#: widths at 5 heads) and 32 for the small checks
HEAD_DIMS = (32, 40, 64, 80, 160)
#: K4's instantiations: SD-1.5's 40, 64 (SD-2.x/SDXL), 128 (the largest
#: head dim K4 takes) and 16 for the small checks
STREAMED_HEAD_DIMS = (16, 40, 64, 128)
STREAMED_MAX_DH = 128
#: K3 takes every head dim that is a multiple of 8 up to 512: the kernel is
#: instantiated at padded widths (64, 128, 256, 512) and reads zeros past
#: the true Dh
MULTIPASS_MAX_DH = 512
#: K2's instantiations: SD-1.5's 40, 80 and 160, 64 and 128 (SD-2.x/SDXL
#: widths) and 16 for the small checks
ONEPASS_HEAD_DIMS = (16, 40, 64, 80, 128, 160)
ONEPASS_MAX_DH = 160
#: longest KV K2 takes, padded to 128: the JAX package's one-pass envelope
#: (``_pick_chunk``)
ONEPASS_MAX_KV = 9216
#: the head dims each fixed-set kernel is built for
_BUILT_DH = {"bsc": HEAD_DIMS, "streamed": STREAMED_HEAD_DIMS, "onepass": ONEPASS_HEAD_DIMS}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: the ``torch.library`` namespace of the port's kernels (this module's four
#: and ``ops/cuda/conv.py``'s K5)
NAMESPACE = "sdt_torch"
_LIBRARY = torch.library.Library(NAMESPACE, "DEF")


def define_op(schema: str, cpu, cuda, fake) -> None:
    """Define the op ``NAMESPACE::<schema>`` with its CPU, CUDA and fake
    implementations.  Registered on the dispatch keys themselves (not
    through ``torch.library.custom_op``, whose Python layers cost a K1
    call about as much again on the card's host), so the dispatcher calls
    the device's implementation directly.  Inference only: the ops have no
    autograd formula."""
    name = schema.split("(")[0]
    _LIBRARY.define(schema)
    _LIBRARY.impl(name, cpu, "CPU")
    _LIBRARY.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIBRARY)
#: fp32 score bytes the head-split plain versions hold at once: they walk
#: q rows in blocks, so a (2, 8, 65536, 40) call does not materialize its
#: 137 GB of scores
PLAIN_SCORE_BYTES = 1 << 30


def takes_head_dim(kernel: str, dh: int, *, cuda: bool = True) -> bool:
    """Whether the wrapper of ``kernel`` ("bsc", "streamed", "multipass" or
    "onepass") takes head dim ``dh``: on the card, the head dims its kernel
    is built for; on the CPU, where the plain version runs, every head dim
    up to the kernel's largest.  The one source of truth for the wrappers'
    checks and for ``ops.attention.route``."""
    if kernel == "multipass":
        return 0 < dh <= MULTIPASS_MAX_DH and (dh % 8 == 0 or not cuda)
    dims = _BUILT_DH[kernel]
    return dh in dims if cuda else 0 < dh <= max(dims)


def flash_attention_bsc_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, Sq, C), (B, Sk, C), (B, Sk, C) -> (B, Sq, C) in q's dtype."""
    b, sq, c = q.shape
    sk = k.shape[1]
    dh = c // n_heads

    def split(x, s):
        return x.reshape(b, s, n_heads, dh).transpose(1, 2).float()

    scores = torch.matmul(split(q, sq), split(k, sk).transpose(-1, -2))
    probs = torch.softmax(scores * (1.0 / math.sqrt(dh)), dim=-1)
    out = torch.matmul(probs, split(v, sk))
    return out.transpose(1, 2).reshape(b, sq, c).to(q.dtype)


def _check(q, k, v, n_heads):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("flash_attention_bsc wants (B, S, C) tensors")
    if k.shape != v.shape or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if q.shape[2] % n_heads:
        raise ValueError(f"channels {q.shape[2]} not divisible by {n_heads} heads")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k and v must share a dtype")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must share a device")


def aligned16(t: torch.Tensor) -> bool:
    """Whether ``t`` meets the kernels' copy rule: a unit last stride, and its
    pointer and every other stride a multiple of 16 bytes, as TMA boxes and
    16-byte asynchronous copies need.  The stride of a dimension of size 1
    is never used and is not checked."""
    if t.stride(-1) != 1 and t.shape[-1] > 1:
        return False
    item = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        t.stride(i) * item % 16 == 0 for i in range(t.dim() - 1) if t.shape[i] > 1)


#: the argument types of each kernel's C entry point (its last argument, the
#: stream, is a pointer)
_ARGTYPES = {
    "flash_attention_bsc": [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 6
    + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    "flash_attention_streamed": [ctypes.c_void_p] * 4
    + [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    "flash_attention_multipass": [ctypes.c_void_p] * 4
    + [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    "flash_attention_onepass": [ctypes.c_void_p] * 4
    + [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 7 + [ctypes.c_void_p],
}
_BOUND = {}


def _entry(name: str):
    """The library of ``csrc/<name>.cu`` and its C function ``sdt_<name>``,
    built and loaded at first use, with its argument and result types set
    once (the per-call host cost of a launch is the ctypes call alone)."""
    found = _BOUND.get(name)
    if found is None:
        from .build import load

        lib, _ = load(name)
        fn = getattr(lib, f"sdt_{name}")
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        lib.sdt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.sdt_cuda_error_string.restype = ctypes.c_char_p
        found = _BOUND[name] = (lib, fn)
    return found


def _launch(q, k, v, n_heads):
    dh = q.shape[2] // n_heads
    if not takes_head_dim("bsc", dh):
        raise ValueError(f"flash_attention_bsc kernel takes head dims "
                         f"{HEAD_DIMS}, got {dh}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash_attention_bsc kernel takes float32 or bfloat16, "
                         f"got {q.dtype}")
    if q.stride(2) != 1 or k.stride(2) != 1 or v.stride(2) != 1:
        raise ValueError("flash_attention_bsc kernel needs unit channel stride")
    if not all(aligned16(t) for t in (q, k, v)):
        raise ValueError("flash_attention_bsc kernel needs 16-byte aligned rows "
                         "(pointer and strides)")
    lib, fn = _entry("flash_attention_bsc")
    b, sq, c = q.shape
    sk = k.shape[1]
    out = torch.empty((b, sq, c), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             q.stride(0), q.stride(1), k.stride(0), k.stride(1),
             v.stride(0), v.stride(1),
             b, sq, sk, n_heads, dh, _DTYPE_CODE[q.dtype], stream)
    _raise_on_error(lib, "flash_attention_bsc", err)
    flash_attention_bsc.launches += 1
    return out


def _bsc_cpu(q, k, v, n_heads):
    return flash_attention_bsc_plain(q, k, v, n_heads)  # looked up when called


define_op("flash_attention_bsc(Tensor q, Tensor k, Tensor v, int n_heads) -> Tensor",
          _bsc_cpu, _launch,
          lambda q, k, v, n_heads: torch.empty(q.shape, dtype=q.dtype, device=q.device))


def _raise_on_error(lib, name: str, err: int) -> None:
    if err != 0:
        msg = lib.sdt_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed ({err}): {msg}")


def flash_attention_bsc(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        n_heads: int) -> torch.Tensor:
    """Non-causal attention on (B, S, H*Dh) tensors -> (B, Sq, H*Dh)."""
    _check(q, k, v, n_heads)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention_bsc runs on CPU or CUDA, not "
                         f"{q.device.type}")
    return torch.ops.sdt_torch.flash_attention_bsc(q, k, v, n_heads)


flash_attention_bsc.launches = 0


# ------------------------------------------------------------ head-split
def _attention_plain(q, k, v, causal: bool) -> torch.Tensor:
    """(B, H, Sq, Dh), (B, H, Sk, Dh) x2 -> (B, H, Sq, Dh) in q's dtype.

    Walks batch elements and blocks of q rows so that at most
    :data:`PLAIN_SCORE_BYTES` of fp32 scores exist at once.  Causal mask
    ``col <= row``; a row whose every score is masked gives 0, as the
    kernels' ``acc / max(l, 1e-30)`` does."""
    b, h, sq, dh = q.shape
    sk = k.shape[2]
    scale = 1.0 / math.sqrt(dh)
    out = torch.empty((b, h, sq, dh), dtype=q.dtype, device=q.device)
    rows = max(1, PLAIN_SCORE_BYTES // (4 * h * max(sk, 1)))
    cols = torch.arange(sk, device=q.device)
    for bi in range(b):
        kf, vf = k[bi].float(), v[bi].float()
        for r0 in range(0, sq, rows):
            s = torch.matmul(q[bi, :, r0:r0 + rows].float(), kf.transpose(-1, -2)) * scale
            if causal:
                row = torch.arange(r0, r0 + s.shape[1], device=q.device)
                s = s.masked_fill(cols[None, :] > row[:, None], float("-inf"))
            m = s.amax(-1, keepdim=True)
            m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
            p = torch.exp(s - m)
            l = p.sum(-1, keepdim=True)
            out[bi, :, r0:r0 + rows] = (torch.matmul(p, vf) / l.clamp_min(1e-30)).to(q.dtype)
    return out


def flash_attention_streamed_plain(q, k, v) -> torch.Tensor:
    """Plain version of K4: non-causal attention, head-split."""
    return _attention_plain(q, k, v, causal=False)


def flash_attention_multipass_plain(q, k, v, causal: bool) -> torch.Tensor:
    """Plain version of K3: attention with an optional causal mask."""
    return _attention_plain(q, k, v, causal)


def flash_attention_onepass_plain(q, k, v, causal: bool) -> torch.Tensor:
    """Plain version of K2: attention with an optional causal mask."""
    return _attention_plain(q, k, v, causal)


def _check_bhsd(name, q, k, v, max_dh):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name} wants (B, H, S, Dh) tensors")
    if (k.shape != v.shape or k.shape[:2] != q.shape[:2]
            or k.shape[3] != q.shape[3]):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if q.shape[3] > max_dh:
        raise ValueError(f"{name} takes head dims up to {max_dh}, got {q.shape[3]}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k and v must share a dtype")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name} takes float32 or bfloat16, got {q.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must share a device")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on CPU or CUDA, not {q.device.type}")


def _launch_bhsd(name, q, k, v, *extra):
    """Launch ``sdt_<name>`` from ``csrc/<name>.cu`` on head-split tensors.

    The output is allocated as (B, Sq, H, Dh) memory and returned as its
    (B, H, Sq, Dh) view, so merging the heads back to (B, Sq, H*Dh)
    afterwards is free."""
    b, h, sq, dh = q.shape
    sk = k.shape[2]
    kernel = name[len("flash_attention_"):]
    if not takes_head_dim(kernel, dh):
        dims = "multiples of 8 up to 512" if kernel == "multipass" else _BUILT_DH[kernel]
        raise ValueError(f"{name} kernel takes head dims {dims}, got {dh}")
    out = torch.empty((b, sq, h, dh), dtype=q.dtype, device=q.device).transpose(1, 2)
    for t in (q, k, v):
        if t.stride(3) != 1:
            raise ValueError(f"{name} kernel needs a unit head-dim stride")
        if not aligned16(t):
            raise ValueError(f"{name} kernel needs 16-byte aligned rows "
                             f"(pointer and strides)")
    if b > 65535 or h > 65535:
        raise ValueError(f"{name} kernel takes at most 65535 batch elements and heads")
    lib, fn = _entry(name)
    strides = (ctypes.c_longlong * 12)(*(t.stride(i) for t in (q, k, v, out)
                                         for i in range(3)))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
             b, h, sq, sk, dh, _DTYPE_CODE[q.dtype], *extra, stream)
    _raise_on_error(lib, name, err)
    return out


def _bhsd_fake(q, k, v, *_):
    """The output a head-split op gives: (B, H, Sq, Dh) in q's dtype, on the
    card the transposed view of (B, Sq, H, Dh) memory (:func:`_launch_bhsd`),
    on the CPU the plain version's contiguous tensor."""
    b, h, sq, dh = q.shape
    if q.device.type == "cuda":
        return torch.empty((b, sq, h, dh), dtype=q.dtype, device=q.device).transpose(1, 2)
    return torch.empty((b, h, sq, dh), dtype=q.dtype, device=q.device)


def _streamed_cuda(q, k, v):
    out = _launch_bhsd("flash_attention_streamed", q, k, v)
    flash_attention_streamed.launches += 1
    return out


def _multipass_cuda(q, k, v, causal):
    out = _launch_bhsd("flash_attention_multipass", q, k, v, int(causal))
    flash_attention_multipass.launches += 1
    return out


def _onepass_cuda(q, k, v, causal):
    out = _launch_bhsd("flash_attention_onepass", q, k, v, int(causal))
    flash_attention_onepass.launches += 1
    return out


# the CPU implementations look the plain versions up when called
define_op("flash_attention_streamed(Tensor q, Tensor k, Tensor v) -> Tensor",
          lambda q, k, v: flash_attention_streamed_plain(q, k, v), _streamed_cuda, _bhsd_fake)
define_op("flash_attention_multipass(Tensor q, Tensor k, Tensor v, bool causal) -> Tensor",
          lambda q, k, v, causal: flash_attention_multipass_plain(q, k, v, causal),
          _multipass_cuda, _bhsd_fake)
define_op("flash_attention_onepass(Tensor q, Tensor k, Tensor v, bool causal) -> Tensor",
          lambda q, k, v, causal: flash_attention_onepass_plain(q, k, v, causal),
          _onepass_cuda, _bhsd_fake)


def flash_attention_streamed(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor) -> torch.Tensor:
    """K4: non-causal attention over (B, H, S, Dh) tensors, Dh <= 128, for
    long KV -> (B, H, Sq, Dh)."""
    _check_bhsd("flash_attention_streamed", q, k, v, STREAMED_MAX_DH)
    return torch.ops.sdt_torch.flash_attention_streamed(q, k, v)


def flash_attention_multipass(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              *, causal: bool) -> torch.Tensor:
    """K3: attention over (B, H, S, Dh) tensors, Dh <= 512 (a multiple of 8
    on the card), optional causal mask (``col <= row``), KV of any length ->
    (B, H, Sq, Dh)."""
    _check_bhsd("flash_attention_multipass", q, k, v, MULTIPASS_MAX_DH)
    return torch.ops.sdt_torch.flash_attention_multipass(q, k, v, bool(causal))


def flash_attention_onepass(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            *, causal: bool) -> torch.Tensor:
    """K2: attention over (B, H, S, Dh) tensors, Dh <= 160, optional causal
    mask (``col <= row``), KV up to :data:`ONEPASS_MAX_KV` tokens padded to
    128 -> (B, H, Sq, Dh)."""
    _check_bhsd("flash_attention_onepass", q, k, v, ONEPASS_MAX_DH)
    if -(-k.shape[2] // 128) * 128 > ONEPASS_MAX_KV:
        raise ValueError(f"flash_attention_onepass takes KV up to {ONEPASS_MAX_KV} "
                         f"tokens padded to 128, got {k.shape[2]}")
    return torch.ops.sdt_torch.flash_attention_onepass(q, k, v, bool(causal))


def onepass_schedule(batch: int, heads: int, sq: int, sk: int, dh: int,
                     causal: bool) -> dict:
    """The schedule K2's bf16 kernel takes for a call of this shape on the
    current card (``plan`` in ``csrc/flash_attention_onepass.cu``):
    consumer warpgroups a CTA (1, 2 or 3: 64, 128 or 192 q rows), CTAs a
    (head, batch) (fewer than the q tiles where each CTA walks several with
    its K/V resident), K/V ring stages and shared-memory bytes.  Builds the
    kernel's library; for the card only."""
    lib, _ = _entry("flash_attention_onepass")
    fn = lib.sdt_flash_attention_onepass_config
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    _raise_on_error(lib, "flash_attention_onepass_config",
                    fn(batch, heads, sq, sk, dh, int(causal), out))
    return dict(zip(("warpgroups", "ctas", "stages", "smem"), out))


flash_attention_streamed.launches = 0
flash_attention_multipass.launches = 0
flash_attention_onepass.launches = 0
