"""Sentence-embedding encoder tower in PyTorch.

Port of perceive_tpu/models/encoder.py.  The parameter layout is the JAX
package's: a nested dict ``{"embed": {...}, "layers": {...}, "dense":
{...}}`` whose per-layer leaves carry a leading layer axis (size 1 for
ALBERT's shared layer), with every linear weight stored (in, out) so the
forward is ``x @ w``.  ``convert.params_from_jax`` carries a JAX params
tree over as is.

Numerics follow the JAX forward: embeddings sum and LayerNorm in f32, then
cast to the compute dtype; layer weights cast to the activation dtype;
LayerNorm statistics in f32; pooling and the dense head in f32.  Attention
routes per sequence bucket (ops.attention.route): buckets of 384 tokens and
up run the CUDA kernel on a CUDA device, shorter ones the plain attention.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import attention as attn_ops

Params = dict


@dataclasses.dataclass(frozen=True)
class EncoderArch:
    """Transformer-tower shape."""

    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    intermediate_size: int
    max_position_embeddings: int = 512
    type_vocab_size: int = 2  # 0 => no token-type embeddings (DistilBERT)
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0
    # RoBERTa: position ids = cumsum(mask) * mask + pad_token_id
    roberta_positions: bool = False
    # ALBERT: one layer's params reused num_layers times, and a factorized
    # embedding of embedding_size with a learned projection
    shared_layers: bool = False
    embedding_size: int = 0  # 0 => same as hidden_size
    hidden_act: str = "gelu"

    @property
    def emb_size(self) -> int:
        return self.embedding_size or self.hidden_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclasses.dataclass(frozen=True)
class HeadConfig:
    """Sentence-embedding head: pooling -> optional dense -> optional L2 norm."""

    pooling: str = "mean"  # mean | cls | max
    dense_dim: int = 0  # 0 => no dense layer
    dense_activation: str = "tanh"  # tanh | identity
    normalize: bool = False

    @property
    def has_dense(self) -> bool:
        return self.dense_dim > 0


def output_dim(arch: EncoderArch, head: HeadConfig) -> int:
    return head.dense_dim if head.has_dense else arch.hidden_size


def _trunc_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """Truncated normal on [-2, 2] (inverse CDF), times 0.02."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    u = torch.rand(shape, generator=generator, dtype=torch.float64) * (hi - lo) + lo
    x = math.sqrt(2.0) * torch.special.erfinv(2.0 * u - 1.0)
    return (x.clamp_(-2.0, 2.0) * 0.02).to(torch.float32)


def init_params(generator: torch.Generator, arch: EncoderArch, head: HeadConfig) -> Params:
    """Random params (truncated normal 0.02, unit LayerNorm scales) in the
    layout above, on the CPU.  The JAX package's init draws other numbers
    from the same seed; parity tests carry params over with
    convert.params_from_jax instead."""
    h, e, i = arch.hidden_size, arch.emb_size, arch.intermediate_size
    lp = 1 if arch.shared_layers else arch.num_layers

    def tn(*shape):
        return _trunc_normal(shape, generator)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32)

    embed = {
        "word": tn(arch.vocab_size, e),
        "position": tn(arch.max_position_embeddings, e),
        "ln_scale": ones(e),
        "ln_bias": zeros(e),
    }
    if arch.type_vocab_size > 0:
        embed["token_type"] = tn(arch.type_vocab_size, e)
    if e != h:
        embed["proj_w"] = tn(e, h)
        embed["proj_b"] = zeros(h)
    layers = {
        "q_w": tn(lp, h, h), "q_b": zeros(lp, h),
        "k_w": tn(lp, h, h), "k_b": zeros(lp, h),
        "v_w": tn(lp, h, h), "v_b": zeros(lp, h),
        "o_w": tn(lp, h, h), "o_b": zeros(lp, h),
        "ln1_scale": ones(lp, h), "ln1_bias": zeros(lp, h),
        "ffn_in_w": tn(lp, h, i), "ffn_in_b": zeros(lp, i),
        "ffn_out_w": tn(lp, i, h), "ffn_out_b": zeros(lp, h),
        "ln2_scale": ones(lp, h), "ln2_bias": zeros(lp, h),
    }
    params = {"embed": embed, "layers": layers}
    if head.has_dense:
        params["dense"] = {"w": tn(h, head.dense_dim), "b": zeros(head.dense_dim)}
    return params


_ACTIVATIONS = {
    "gelu": lambda x: F.gelu(x),
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_pytorch_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "silu": F.silu,
    "swish": F.silu,
}


def _activation(hidden_act: str):
    """FFN activation by HF config name; raises on an unknown name."""
    try:
        return _ACTIVATIONS[hidden_act]
    except KeyError:
        raise ValueError(f"unsupported hidden_act {hidden_act!r}") from None


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm with f32 statistics whatever the activation dtype."""
    dt = x.dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(dt)


def pool(hidden: torch.Tensor, attention_mask: torch.Tensor, mode: str) -> torch.Tensor:
    """Sentence pooling over (B, S, H) -> (B, H), f32."""
    mask = attention_mask.float()[:, :, None]
    h = hidden.float()
    if mode == "mean":
        denom = torch.clamp(mask.sum(dim=1), min=1e-9)
        return (h * mask).sum(dim=1) / denom
    if mode == "cls":
        return h[:, 0, :]
    if mode == "max":
        return torch.where(mask > 0, h, torch.full_like(h, float("-inf"))).amax(dim=1)
    raise ValueError(f"unknown pooling mode: {mode}")


_MATMUL_LEAVES = ("q_w", "q_b", "k_w", "k_b", "v_w", "v_b", "o_w", "o_b",
                  "ffn_in_w", "ffn_in_b", "ffn_out_w", "ffn_out_b")


class Encoder(nn.Module):
    """Token batch -> sentence embeddings (B, output_dim) f32.

    ``params`` is the nested dict layout above (tensors in f32).  The layer
    matmul weights are also kept in the compute dtype — the same values the
    JAX forward's per-layer cast produces."""

    def __init__(
        self,
        params: Params,
        arch: EncoderArch,
        head: HeadConfig,
        *,
        compute_dtype: torch.dtype = torch.float32,
        attention_impl: str = "auto",
    ):
        super().__init__()
        attn_ops.route("cpu", 0, attention_impl)  # validate the name early
        self.arch = arch
        self.head = head
        self.compute_dtype = compute_dtype
        self.attention_impl = attention_impl
        self.embed = nn.ParameterDict(
            {k: nn.Parameter(v.float(), requires_grad=False) for k, v in params["embed"].items()}
        )
        self.layers = nn.ParameterDict(
            {k: nn.Parameter(v.float(), requires_grad=False) for k, v in params["layers"].items()}
        )
        self.dense = nn.ParameterDict(
            {k: nn.Parameter(v.float(), requires_grad=False) for k, v in params.get("dense", {}).items()}
        )
        self._cast: dict[str, torch.Tensor] = {}

    def params(self) -> Params:
        """The f32 param tree this encoder was built from (its own tensors)."""
        tree = {"embed": dict(self.embed.items()), "layers": dict(self.layers.items())}
        if len(self.dense):
            tree["dense"] = dict(self.dense.items())
        return {g: {k: v.detach() for k, v in sub.items()} for g, sub in tree.items()}

    def _apply(self, fn, *args, **kwargs):  # .to(device) etc.: re-derive the casts
        out = super()._apply(fn, *args, **kwargs)
        self._cast = {}
        return out

    def _matmul_weights(self) -> dict[str, torch.Tensor]:
        if not self._cast:
            self._cast = {k: self.layers[k].to(self.compute_dtype) for k in _MATMUL_LEAVES}
        return self._cast

    def _attention(self, q, k, v, mask):
        if attn_ops.route(q.device.type, q.shape[1], self.attention_impl) == "kernel":
            return attn_ops.attention(q, k, v, mask)
        return attn_ops.xla_attention_plain(q, k, v, mask)

    def _layer(self, x: torch.Tensor, i: int, mask: torch.Tensor) -> torch.Tensor:
        """One post-LN transformer block on (B, S, H)."""
        arch = self.arch
        b, s, h = x.shape
        nh, dh = arch.num_heads, arch.head_dim
        w = self._matmul_weights()
        lyr = self.layers

        def lin(name):
            return x @ w[name + "_w"][i] + w[name + "_b"][i]

        q = lin("q").reshape(b, s, nh, dh).contiguous()
        k = lin("k").reshape(b, s, nh, dh).contiguous()
        v = lin("v").reshape(b, s, nh, dh).contiguous()
        attn = self._attention(q, k, v, mask).reshape(b, s, h)
        x = _layer_norm(
            x + (attn @ w["o_w"][i] + w["o_b"][i]),
            lyr["ln1_scale"][i], lyr["ln1_bias"][i], arch.layer_norm_eps,
        )
        ffn = _activation(arch.hidden_act)(x @ w["ffn_in_w"][i] + w["ffn_in_b"][i])
        ffn = ffn @ w["ffn_out_w"][i] + w["ffn_out_b"][i]
        return _layer_norm(x + ffn, lyr["ln2_scale"][i], lyr["ln2_bias"][i], arch.layer_norm_eps)

    def tower(self, input_ids, attention_mask, token_type_ids=None) -> torch.Tensor:
        """Embeddings + L transformer layers -> (B, S, H) hidden states."""
        arch, embed = self.arch, self.embed
        ids = input_ids.long()
        x = embed["word"][ids]
        if arch.roberta_positions:
            m = attention_mask.long()
            pos = torch.cumsum(m, dim=1) * m + arch.pad_token_id
        else:
            pos = torch.arange(ids.shape[1], device=ids.device)[None, :]
        x = x + embed["position"][pos]
        if arch.type_vocab_size > 0:
            tt = token_type_ids.long() if token_type_ids is not None else torch.zeros_like(ids)
            x = x + embed["token_type"][tt]
        x = _layer_norm(x, embed["ln_scale"], embed["ln_bias"], arch.layer_norm_eps)
        if "proj_w" in embed:  # ALBERT factorized embedding
            x = x @ embed["proj_w"] + embed["proj_b"]
        x = x.to(self.compute_dtype)
        mask = attention_mask.to(torch.int32).contiguous()
        for layer in range(arch.num_layers):
            x = self._layer(x, 0 if arch.shared_layers else layer, mask)
        return x

    def forward(self, input_ids, attention_mask, token_type_ids=None) -> torch.Tensor:
        hidden = self.tower(input_ids, attention_mask, token_type_ids)
        emb = pool(hidden, attention_mask, self.head.pooling)
        if self.head.has_dense:
            emb = emb @ self.dense["w"].float() + self.dense["b"].float()
            if self.head.dense_activation == "tanh":
                emb = torch.tanh(emb)
        if self.head.normalize:
            emb = emb / torch.clamp(torch.linalg.norm(emb, dim=-1, keepdim=True), min=1e-12)
        return emb


class TensorParallelEncoder(Encoder):
    """The tower split over model slots: the counterpart of GSPMD's
    partition of the JAX tower under parallel/mesh._LAYER_SPECS.  Slot j
    holds column block j of q/k/v and ffn_in and row block j of o and
    ffn_out (``slot_params[j]``, from ``parallel.mesh.shard_params``; the
    leaves named in ``split``), so the heads split evenly over the slots;
    slot 0 also owns the embeddings, the layernorms, the residual stream and
    the head.  The partial products of o and ffn_out are summed on slot 0
    in f32, each bias added once: the psum GSPMD inserts.  Every slot's
    attention takes its route (``ops.attention.route``: K11 at buckets of
    KERNEL_MIN_SEQ and up on a CUDA slot)."""

    def __init__(self, slot_params: list, devices: list, arch: EncoderArch, head: HeadConfig, *, split,
                 compute_dtype: torch.dtype = torch.float32, attention_impl: str = "auto"):
        mp = len(devices)
        if arch.num_heads % mp or arch.intermediate_size % mp:
            raise ValueError(f"{arch.num_heads} heads and {arch.intermediate_size} FFN columns do not split {mp} ways")
        lead = slot_params[0]
        own = {**lead, "layers": {k: v for k, v in lead["layers"].items() if k not in split}}
        super().__init__(own, arch, head, compute_dtype=compute_dtype, attention_impl=attention_impl)
        self.to(devices[0])
        self._slots = [
            (torch.device(dev), {k: p["layers"][k].to(dev).to(compute_dtype) for k in split})
            for dev, p in zip(devices, slot_params)
        ]

    def _layer(self, x: torch.Tensor, i: int, mask: torch.Tensor) -> torch.Tensor:
        from ..parallel.mesh import device_scope

        arch, lyr = self.arch, self.layers
        b, s, _ = x.shape
        nh, dh = arch.num_heads // len(self._slots), arch.head_dim
        lead, dt = x.device, x.dtype

        def spread(t):  # t on every slot
            return [t if dev == lead else t.to(dev, non_blocking=True) for dev, _ in self._slots]

        def psum(parts, bias):  # partial products summed on slot 0, in f32, the bias once
            out = parts[0].float()
            for p in parts[1:]:
                out = out + p.to(lead, non_blocking=True).float()
            return (out + bias.to(dt).float()).to(dt)

        parts = []
        for (dev, w), xj, mj in zip(self._slots, spread(x), spread(mask)):
            with device_scope(dev):
                q, k, v = ((xj @ w[n + "_w"][i] + w[n + "_b"][i]).reshape(b, s, nh, dh).contiguous()
                           for n in ("q", "k", "v"))
                parts.append(self._attention(q, k, v, mj).reshape(b, s, nh * dh) @ w["o_w"][i])
        x = _layer_norm(x + psum(parts, lyr["o_b"][i]), lyr["ln1_scale"][i], lyr["ln1_bias"][i],
                        arch.layer_norm_eps)
        act = _activation(arch.hidden_act)
        parts = []
        for (dev, w), xj in zip(self._slots, spread(x)):
            with device_scope(dev):
                parts.append(act(xj @ w["ffn_in_w"][i] + w["ffn_in_b"][i]) @ w["ffn_out_w"][i])
        ffn = psum(parts, lyr["ffn_out_b"][i])
        return _layer_norm(x + ffn, lyr["ln2_scale"][i], lyr["ln2_bias"][i], arch.layer_norm_eps)


def encode_tokens(
    params: Params,
    arch: EncoderArch,
    head: HeadConfig,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    token_type_ids: Optional[torch.Tensor] = None,
    *,
    compute_dtype: torch.dtype = torch.float32,
    attention_impl: str = "auto",
) -> torch.Tensor:
    """Functional form of ``Encoder`` (the JAX ``encode_tokens`` signature)."""
    enc = Encoder(params, arch, head, compute_dtype=compute_dtype, attention_impl=attention_impl)
    enc = enc.to(input_ids.device)
    with torch.inference_mode():
        return enc(input_ids, attention_mask, token_type_ids)
