"""Fused multi-head attention for the encoder's long sequence buckets.

Port of perceive_tpu/ops/attention.py (``fused_attention``).  ``attention``
is the entry point: on CUDA tensors it launches the hand-written kernel in
``csrc/attention.cu`` (bf16: tensor cores, head dims 16, 32, 64 and 128;
f32: a SIMT body, any even head dim up to 128); on CPU tensors it runs
``attention_plain``, the kernel's math in plain PyTorch.  A failed launch
raises.

Two plain versions live here on purpose, one per JAX path:
  * ``attention_plain`` mirrors the Pallas kernel's rounding: p is cast to
    v's dtype BEFORE p @ v, and the f32 sum is divided by l AFTER it;
  * ``xla_attention_plain`` mirrors the encoder's short-bucket attention
    (perceive_tpu/models/encoder.py ``_xla_attention``): softmax normalizes
    first, then casts.
"""

from __future__ import annotations

import math

import torch

from . import _cuda

_NEG = -1e9

# Sequence bucket at which the encoder routes attention to the kernel.
# Inherited from the JAX package's TPU crossover (encoder._PALLAS_MIN_SEQ);
# not yet measured on this card.
KERNEL_MIN_SEQ = 384

# kernel launches made by attention()
LAUNCHES = 0


def route(device_type: str, seq_len: int, impl: str = "auto") -> str:
    """Which attention a (device, sequence bucket) runs: "kernel" or
    "plain".  ``impl`` "auto" routes buckets of KERNEL_MIN_SEQ tokens and up
    on a CUDA device to the kernel; "kernel" and "plain" force one."""
    if impl == "auto":
        return "kernel" if device_type == "cuda" and seq_len >= KERNEL_MIN_SEQ else "plain"
    if impl in ("kernel", "plain"):
        return impl
    raise ValueError(f"unknown attention_impl {impl!r}")


def attention_plain(q, k, v, mask):
    """Kernel math in plain PyTorch.  q/k/v: (B, S, NH, DH); mask: (B, S),
    1 = keep.  Returns (B, S, NH, DH) in q's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    bias = (1.0 - mask.float())[:, None, None, :] * _NEG
    scores = scores * scale + bias
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    return (acc / l).to(q.dtype).permute(0, 2, 1, 3)


def xla_attention_plain(q, k, v, mask):
    """The encoder's short-bucket attention (JAX ``_xla_attention``):
    f32 scores and softmax, probabilities cast to q's dtype, then p @ v."""
    bias = (1.0 - mask.float())[:, None, None, :] * _NEG
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores / math.sqrt(q.shape[-1]) + bias
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(q.dtype)


def attention(q, k, v, mask):
    """q/k/v: (B, S, NH, DH) bf16 or f32; mask: (B, S) int32, 1 = keep.
    Returns (B, S, NH, DH) in q's dtype.  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v must share one (B, S, NH, DH) shape: {q.shape} {k.shape} {v.shape}")
    if mask.shape != q.shape[:2]:
        raise ValueError(f"mask must be (B, S) = {tuple(q.shape[:2])}, got {tuple(mask.shape)}")
    if q.device.type == "cpu":
        return attention_plain(q, k, v, mask)
    if q.device.type != "cuda":
        raise RuntimeError(f"attention: no kernel for device {q.device}")
    return _attention_cuda(q, k, v, mask)


def _attention_cuda(q, k, v, mask):
    global LAUNCHES
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"attention takes bf16 or f32 q/k/v of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if mask.dtype != torch.int32:
        raise TypeError(f"attention takes an int32 mask, got {mask.dtype}")
    for name, t in (("k", k), ("v", v), ("mask", mask)):
        if t.device != q.device:
            raise ValueError(f"attention: {name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"attention: {name} must be contiguous")
    if not q.is_contiguous():
        raise ValueError("attention: q must be contiguous")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("attention: bf16 q, k and v must be 16-byte aligned")
    b, s, nh, dh = q.shape
    lib = _cuda.library()
    dtype_code = 1 if q.dtype == torch.bfloat16 else 0
    if lib.perceive_attention_smem(dtype_code, s, dh) == 0:
        raise ValueError(f"attention kernel does not take S={s}, DH={dh} in {q.dtype}")
    out = torch.empty_like(q)
    code = lib.perceive_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
        dtype_code, b, s, nh, dh, 1.0 / math.sqrt(dh), _cuda.stream_of(q),
    )
    _cuda.check(code, "attention")
    LAUNCHES += 1
    return out
