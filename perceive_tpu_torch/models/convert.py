"""Weights into the encoder's params layout.

Port of perceive_tpu/models/convert.py, plus the bridge from the JAX
package:

  * ``params_from_jax(tree)`` takes a JAX params tree (any array type
    numpy can read, e.g. after ``jax.tree.map(np.asarray, params)``) and
    returns the same nested dict of f32 torch tensors;
  * ``load_sentence_transformer(dir)`` reads a sentence-transformers
    checkpoint (``pytorch_model.bin`` through ``torch.load(weights_only=
    True)``, or ``model.safetensors`` where the ``safetensors`` package is
    installed) through the same key tables as the JAX converter.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from .encoder import EncoderArch, HeadConfig, Params

_PREFIXES = ("bert.", "distilbert.", "roberta.", "albert.", "model.")


def params_from_jax(tree: Mapping[str, Any]) -> Params:
    """JAX params tree -> the port's params (same nesting, f32 tensors)."""
    return {
        group: {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in leaves.items()}
        for group, leaves in tree.items()
    }


def _strip_prefix(sd: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    out = {}
    for k, v in sd.items():
        for p in _PREFIXES:
            if k.startswith(p):
                k = k[len(p):]
                break
        out[k] = v
    return out


def _load_state_dict(model_dir: Path) -> dict[str, torch.Tensor]:
    st = model_dir / "model.safetensors"
    bin_path = model_dir / "pytorch_model.bin"
    # safetensors is optional: an export that also ships pytorch_model.bin
    # loads without it
    if st.exists() and (importlib.util.find_spec("safetensors") or not bin_path.exists()):
        from safetensors.torch import load_file

        return dict(load_file(str(st)))
    if bin_path.exists():
        return torch.load(str(bin_path), map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"no weights (model.safetensors / pytorch_model.bin) in {model_dir}")


def arch_from_hf_config(cfg: Mapping[str, Any]) -> EncoderArch:
    """Map an HF transformer config.json to EncoderArch."""
    mt = cfg.get("model_type", "bert")
    if mt == "distilbert":
        return EncoderArch(
            vocab_size=cfg["vocab_size"],
            hidden_size=cfg["dim"],
            num_layers=cfg["n_layers"],
            num_heads=cfg["n_heads"],
            intermediate_size=cfg["hidden_dim"],
            max_position_embeddings=cfg.get("max_position_embeddings", 512),
            type_vocab_size=0,
            layer_norm_eps=1e-12,
            pad_token_id=cfg.get("pad_token_id", 0),
            hidden_act=cfg.get("activation", "gelu"),
        )
    if mt == "albert":
        return EncoderArch(
            vocab_size=cfg["vocab_size"],
            hidden_size=cfg["hidden_size"],
            num_layers=cfg["num_hidden_layers"],
            num_heads=cfg["num_attention_heads"],
            intermediate_size=cfg["intermediate_size"],
            max_position_embeddings=cfg.get("max_position_embeddings", 512),
            type_vocab_size=cfg.get("type_vocab_size", 2),
            layer_norm_eps=cfg.get("layer_norm_eps", 1e-12),
            pad_token_id=cfg.get("pad_token_id", 0),
            shared_layers=True,
            embedding_size=cfg.get("embedding_size", cfg["hidden_size"]),
            hidden_act=cfg.get("hidden_act", "gelu_new"),
        )
    return EncoderArch(
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        intermediate_size=cfg["intermediate_size"],
        max_position_embeddings=cfg.get("max_position_embeddings", 512),
        type_vocab_size=cfg.get("type_vocab_size", 2),
        layer_norm_eps=cfg.get("layer_norm_eps", 1e-12),
        pad_token_id=cfg.get("pad_token_id", 1 if mt == "roberta" else 0),
        roberta_positions=(mt == "roberta"),
        hidden_act=cfg.get("hidden_act", "gelu"),
    )


# per-architecture key templates: ours -> theirs (with {i} layer index)
_BERT_KEYS = {
    "q_w": "encoder.layer.{i}.attention.self.query.weight",
    "q_b": "encoder.layer.{i}.attention.self.query.bias",
    "k_w": "encoder.layer.{i}.attention.self.key.weight",
    "k_b": "encoder.layer.{i}.attention.self.key.bias",
    "v_w": "encoder.layer.{i}.attention.self.value.weight",
    "v_b": "encoder.layer.{i}.attention.self.value.bias",
    "o_w": "encoder.layer.{i}.attention.output.dense.weight",
    "o_b": "encoder.layer.{i}.attention.output.dense.bias",
    "ln1_scale": "encoder.layer.{i}.attention.output.LayerNorm.weight",
    "ln1_bias": "encoder.layer.{i}.attention.output.LayerNorm.bias",
    "ffn_in_w": "encoder.layer.{i}.intermediate.dense.weight",
    "ffn_in_b": "encoder.layer.{i}.intermediate.dense.bias",
    "ffn_out_w": "encoder.layer.{i}.output.dense.weight",
    "ffn_out_b": "encoder.layer.{i}.output.dense.bias",
    "ln2_scale": "encoder.layer.{i}.output.LayerNorm.weight",
    "ln2_bias": "encoder.layer.{i}.output.LayerNorm.bias",
}

_DISTILBERT_KEYS = {
    "q_w": "transformer.layer.{i}.attention.q_lin.weight",
    "q_b": "transformer.layer.{i}.attention.q_lin.bias",
    "k_w": "transformer.layer.{i}.attention.k_lin.weight",
    "k_b": "transformer.layer.{i}.attention.k_lin.bias",
    "v_w": "transformer.layer.{i}.attention.v_lin.weight",
    "v_b": "transformer.layer.{i}.attention.v_lin.bias",
    "o_w": "transformer.layer.{i}.attention.out_lin.weight",
    "o_b": "transformer.layer.{i}.attention.out_lin.bias",
    "ln1_scale": "transformer.layer.{i}.sa_layer_norm.weight",
    "ln1_bias": "transformer.layer.{i}.sa_layer_norm.bias",
    "ffn_in_w": "transformer.layer.{i}.ffn.lin1.weight",
    "ffn_in_b": "transformer.layer.{i}.ffn.lin1.bias",
    "ffn_out_w": "transformer.layer.{i}.ffn.lin2.weight",
    "ffn_out_b": "transformer.layer.{i}.ffn.lin2.bias",
    "ln2_scale": "transformer.layer.{i}.output_layer_norm.weight",
    "ln2_bias": "transformer.layer.{i}.output_layer_norm.bias",
}

_ALBERT_LAYER = "encoder.albert_layer_groups.0.albert_layers.0."
_ALBERT_KEYS = {
    "q_w": _ALBERT_LAYER + "attention.query.weight",
    "q_b": _ALBERT_LAYER + "attention.query.bias",
    "k_w": _ALBERT_LAYER + "attention.key.weight",
    "k_b": _ALBERT_LAYER + "attention.key.bias",
    "v_w": _ALBERT_LAYER + "attention.value.weight",
    "v_b": _ALBERT_LAYER + "attention.value.bias",
    "o_w": _ALBERT_LAYER + "attention.dense.weight",
    "o_b": _ALBERT_LAYER + "attention.dense.bias",
    "ln1_scale": _ALBERT_LAYER + "attention.LayerNorm.weight",
    "ln1_bias": _ALBERT_LAYER + "attention.LayerNorm.bias",
    "ffn_in_w": _ALBERT_LAYER + "ffn.weight",
    "ffn_in_b": _ALBERT_LAYER + "ffn.bias",
    "ffn_out_w": _ALBERT_LAYER + "ffn_output.weight",
    "ffn_out_b": _ALBERT_LAYER + "ffn_output.bias",
    "ln2_scale": _ALBERT_LAYER + "full_layer_layer_norm.weight",
    "ln2_bias": _ALBERT_LAYER + "full_layer_layer_norm.bias",
}


def convert_state_dict(state_dict: Mapping[str, Any], arch: EncoderArch, model_type: str = "bert") -> Params:
    """HF state dict -> stacked params.  Linear weights transpose from
    torch's (out, in) to (in, out); per-layer tensors stack on a new leading
    layer axis."""
    sd = _strip_prefix({k: torch.as_tensor(v).float() for k, v in state_dict.items()})
    keys = {"distilbert": _DISTILBERT_KEYS, "albert": _ALBERT_KEYS}.get(model_type, _BERT_KEYS)
    emb = "embeddings."
    embed = {
        "word": sd[emb + "word_embeddings.weight"],
        "position": sd[emb + "position_embeddings.weight"],
        "ln_scale": sd[emb + "LayerNorm.weight"],
        "ln_bias": sd[emb + "LayerNorm.bias"],
    }
    if arch.type_vocab_size > 0:
        embed["token_type"] = sd[emb + "token_type_embeddings.weight"]
    if arch.emb_size != arch.hidden_size:
        embed["proj_w"] = sd["encoder.embedding_hidden_mapping_in.weight"].T.contiguous()
        embed["proj_b"] = sd["encoder.embedding_hidden_mapping_in.bias"]
    lp = 1 if arch.shared_layers else arch.num_layers
    layers = {}
    for ours, theirs in keys.items():
        mats = [sd[theirs.format(i=i)] for i in range(lp)]
        if ours.endswith("_w"):
            mats = [m.T for m in mats]
        layers[ours] = torch.stack(mats, dim=0).contiguous()
    return {"embed": embed, "layers": layers}


def load_sentence_transformer(model_dir: str | Path):
    """Load a sentence-transformers checkpoint directory.
    Returns (params, arch, head, max_seq_length)."""
    model_dir = Path(model_dir)
    cfg = json.loads((model_dir / "config.json").read_text())
    model_type = cfg.get("model_type", "bert")
    arch = arch_from_hf_config(cfg)
    params = convert_state_dict(_load_state_dict(model_dir), arch, model_type)

    pooling = "mean"
    pool_cfg_path = model_dir / "1_Pooling" / "config.json"
    if pool_cfg_path.exists():
        pc = json.loads(pool_cfg_path.read_text())
        unsupported = [
            k for k, v in pc.items()
            if v and k.startswith("pooling_mode_")
            and k not in ("pooling_mode_cls_token", "pooling_mode_max_tokens", "pooling_mode_mean_tokens")
        ]
        if unsupported:
            raise ValueError(f"unsupported pooling modes in {pool_cfg_path}: {unsupported}")
        if pc.get("pooling_mode_cls_token"):
            pooling = "cls"
        elif pc.get("pooling_mode_max_tokens"):
            pooling = "max"

    normalize = False
    dense_dirs: list[Path] = []
    modules_path = model_dir / "modules.json"
    if modules_path.exists():
        modules = json.loads(modules_path.read_text())
        normalize = any("Normalize" in m.get("type", "") for m in modules)
        dense_dirs = [
            model_dir / m["path"] for m in modules if "Dense" in m.get("type", "") and m.get("path")
        ]
    elif (model_dir / "2_Dense").exists():
        dense_dirs = [model_dir / "2_Dense"]
    if len(dense_dirs) > 1:
        raise ValueError(f"{model_dir} chains {len(dense_dirs)} Dense modules; only one is supported")

    dense_dim, dense_activation = 0, "identity"
    if dense_dirs:
        dc = json.loads((dense_dirs[0] / "config.json").read_text())
        dense_dim = dc["out_features"]
        dense_activation = "tanh" if "Tanh" in dc.get("activation_function", "") else "identity"
        dsd = {k.removeprefix("linear."): v for k, v in _load_state_dict(dense_dirs[0]).items()}
        params["dense"] = {
            "w": dsd["weight"].float().T.contiguous(),
            "b": dsd["bias"].float(),
        }
    head = HeadConfig(
        pooling=pooling, dense_dim=dense_dim, dense_activation=dense_activation, normalize=normalize
    )

    max_seq = 512
    sb_cfg = model_dir / "sentence_bert_config.json"
    if sb_cfg.exists():
        max_seq = json.loads(sb_cfg.read_text()).get("max_seq_length", 512)
    pos_budget = arch.max_position_embeddings
    if arch.roberta_positions:  # positions run cumsum(mask) + pad_id
        pos_budget -= arch.pad_token_id + 1
    return params, arch, head, min(max_seq, pos_budget)
