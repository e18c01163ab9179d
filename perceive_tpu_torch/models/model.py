"""Model facade: tokenizer + encoder on one device.

Port of perceive_tpu/models/model.py.  Token batches pad to (batch bucket)
x (sequence bucket), as in the JAX package, so both packages see the same
shapes.  ``encode_dispatch`` / ``encode_ids`` enqueue the encode on the
device's current stream and return device tensors without waiting;
``materialize`` copies to the host.  The device is explicit: nothing here
picks one.  ``shard_over`` spreads the encode over a mesh of devices
(data-parallel, or tensor-parallel under a model axis above 1).
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from ..utils import dispatchmeter
from .encoder import Encoder, EncoderArch, HeadConfig, TensorParallelEncoder, init_params, output_dim
from .registry import ModelType, checkpoint_path
from .tokenize import TextTokenizer, TokenBatch

BATCH_BUCKETS = (1, 8, 16, 32, 64, 128, 256, 512, 1024)


def batch_bucket(n: int) -> int:
    for b in BATCH_BUCKETS:
        if b >= n:
            return b
    return BATCH_BUCKETS[-1]


class ModelError(Exception):
    """Encode failed."""


class Model:
    def __init__(
        self,
        params,
        arch: EncoderArch,
        head: HeadConfig,
        tokenizer: TextTokenizer,
        *,
        device: torch.device | str,
        compute_dtype: torch.dtype = torch.bfloat16,
        attention_impl: str = "auto",
        model_id: int = -1,
        model_version: int = 0,
        name: str = "custom",
    ):
        self.device = torch.device(device)
        self.arch = arch
        self.head = head
        self.tokenizer = tokenizer
        self.model_id = model_id
        self.model_version = model_version
        self.name = name
        self.compute_dtype = compute_dtype
        # "auto" keys on the device: the CUDA kernel for long buckets on a
        # CUDA device, the plain attention everywhere else (ops.attention.route)
        self.attention_impl = attention_impl
        self.encoder = Encoder(
            params, arch, head, compute_dtype=compute_dtype, attention_impl=attention_impl
        ).to(self.device)
        # the mesh (shard_over) and the encoder of each of its data slots
        self._mesh = None
        self._data_slots: list | None = None

    # -- constructors --------------------------------------------------------

    @classmethod
    def new_pretrained(
        cls,
        model_type: ModelType | str | Path,
        *,
        device: torch.device | str,
        compute_dtype: torch.dtype = torch.bfloat16,
        attention_impl: str = "auto",
    ) -> "Model":
        """Load a sentence-transformers checkpoint (registry entry or path)."""
        from .convert import load_sentence_transformer

        model_id, version, name = -1, 0, str(model_type)
        if isinstance(model_type, str) and not Path(model_type).exists():
            model_type = ModelType.parse(model_type)
        if isinstance(model_type, ModelType):
            path = checkpoint_path(model_type)
            if path is None:
                raise ModelError(
                    f"no checkpoint for {model_type.value} under the model-data dir; "
                    "place a sentence-transformers export there "
                    "(see perceive_tpu_torch/models/registry.py)"
                )
            model_id, name = model_type.model_id, model_type.value
        else:
            path = Path(model_type)
        params, arch, head, max_seq = load_sentence_transformer(path)
        tokenizer = TextTokenizer.from_dir(path, max_seq_length=max_seq)
        return cls(
            params, arch, head, tokenizer, device=device, model_id=model_id,
            model_version=version, compute_dtype=compute_dtype,
            attention_impl=attention_impl, name=name,
        )

    @classmethod
    def random(
        cls,
        arch: EncoderArch,
        head: HeadConfig,
        tokenizer: TextTokenizer,
        *,
        device: torch.device | str,
        seed: int = 0,
        compute_dtype: torch.dtype = torch.float32,
        attention_impl: str = "auto",
        model_id: int = -1,
    ) -> "Model":
        """Randomly initialized model from a seeded torch.Generator."""
        gen = torch.Generator().manual_seed(seed)
        return cls(
            init_params(gen, arch, head), arch, head, tokenizer, device=device,
            model_id=model_id, compute_dtype=compute_dtype,
            attention_impl=attention_impl, name="random",
        )

    # -- encoding ------------------------------------------------------------

    @property
    def dim(self) -> int:
        return output_dim(self.arch, self.head)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def encode_tensors(self, ids: torch.Tensor, mask: torch.Tensor, type_ids=None) -> torch.Tensor:
        """(B, S) device tensors -> (B, dim) f32 on the device, enqueued."""
        with torch.inference_mode():
            return self.encoder(ids, mask, type_ids)

    def encode_ids(self, ids: torch.Tensor) -> torch.Tensor:
        """Ids-only encode: the mask is ``ids != pad`` on the device and
        token types are zero.  Enqueued, not waited for."""
        return self._encode_ids_with(self.encoder, ids)

    def _encode_ids_with(self, encoder, ids: torch.Tensor) -> torch.Tensor:
        mask = (ids != self.tokenizer.pad_id).to(torch.int32)
        with torch.inference_mode():
            return encoder(ids, mask, torch.zeros_like(ids))

    # -- multi-device ----------------------------------------------------------

    def shard_over(self, mesh) -> "Model":
        """Spread the encode over a device mesh (parallel.make_mesh) whose
        lead slot is this model's device.

        With the mesh's model axis at 1: data-parallel.  The params are
        replicated once per distinct device of the data slots, and a
        dispatched batch whose bucket divides the data axis splits over the
        data slots, each part encoded on its slot (K11 on each at buckets of
        KERNEL_MIN_SEQ and up) and gathered to the lead slot.  With a model
        axis above 1 each data slot's encoder is tensor-parallel over its
        row of model slots (``TensorParallelEncoder``), the lead row's
        serving the batches that do not split and the single queries.
        Batches whose bucket does not divide the data axis (the single
        query, bucket 1) take the lead slot's path."""
        from ..parallel.mesh import MODEL_AXIS, param_specs, shard_params

        if mesh.lead != self.device:
            raise ValueError(f"the mesh leads on {mesh.lead}, the model is on {self.device}")
        params = self.encoder.params()
        if mesh.shape[MODEL_AXIS] == 1:
            replicas = {self.device: self.encoder}
            for (dev,) in mesh.devices:
                if dev not in replicas:
                    replicas[dev] = Encoder(params, self.arch, self.head, compute_dtype=self.compute_dtype,
                                            attention_impl=self.attention_impl).to(dev)
            self._data_slots = [(dev, replicas[dev]) for (dev,) in mesh.devices]
        else:
            grid = shard_params(params, mesh)
            split = {n for n, axis in param_specs(params)["layers"].items() if axis is not None}
            self._data_slots = [
                (row[0], TensorParallelEncoder(grid[i], list(row), self.arch, self.head, split=split,
                                               compute_dtype=self.compute_dtype,
                                               attention_impl=self.attention_impl))
                for i, row in enumerate(mesh.devices)
            ]
            self.encoder = self._data_slots[0][1]
        self._mesh = mesh
        return self

    def _encode_ids_sharded(self, ids: np.ndarray) -> torch.Tensor:
        """The data-parallel encode of an (B, S) batch whose B divides the
        data axis: one part a data slot, enqueued on each before the parts
        are gathered to the lead slot."""
        from ..parallel.mesh import batch_sharding, device_scope

        outs = []
        for (dev, enc), part in zip(self._data_slots, batch_sharding(torch.from_numpy(ids), self._mesh)):
            with device_scope(dev):
                outs.append(self._encode_ids_with(enc, part))
        return torch.cat([o.to(self.device, non_blocking=True) for o in outs])

    def encode_token_batch(self, batch: TokenBatch) -> np.ndarray:
        """(B, S) token arrays -> (B, dim) f32 embeddings on the host."""
        # a blocking encode: a query encoded outside the fused path, a
        # highlight chunk batch (the JAX package leaves both uncounted)
        dispatchmeter.count("encode")
        try:
            out = self.encode_tensors(
                self._to_device(batch.input_ids),
                self._to_device(batch.attention_mask),
                self._to_device(batch.token_type_ids),
            )
            return out.cpu().numpy()
        except Exception as e:  # error isolation per batch
            raise ModelError(f"encode failed: {e}") from e

    def encode(self, texts: Sequence[str], *, max_batch: int = 256) -> np.ndarray:
        """Texts -> (N, dim) f32 embeddings, chunked into bucketed batches."""
        if not texts:
            return np.zeros((0, self.dim), dtype=np.float32)
        max_batch = min(max_batch, BATCH_BUCKETS[-1])
        outs = []
        for start in range(0, len(texts), max_batch):
            chunk = list(texts[start : start + max_batch])
            tb = self.tokenizer.encode_batch(chunk, pad_batch_to=batch_bucket(len(chunk)))
            outs.append(self.encode_token_batch(tb)[: len(chunk)])
        return np.concatenate(outs, axis=0)

    def encode_dispatch(self, texts: Sequence[str]):
        """Tokenize + enqueue the encode; returns a handle for ``materialize``."""
        chunk = list(texts)
        return self._dispatch_chunk(
            chunk, lambda n: self.tokenizer.encode_batch_ids(chunk, pad_batch_to=n)
        )

    def encode_dispatch_token_windows(self, windows):
        """Like ``encode_dispatch`` for pre-sliced token-id windows (the
        chunk-embedding path): wrapped with the special tokens, padded."""
        windows = list(windows)
        return self._dispatch_chunk(
            windows, lambda n: self.tokenizer.pack_token_windows(windows, pad_batch_to=n)
        )

    def _dispatch_chunk(self, items: list, ids_for):
        if len(items) > BATCH_BUCKETS[-1]:
            raise ModelError(f"batch of {len(items)} exceeds the {BATCH_BUCKETS[-1]} dispatch limit")
        ids = ids_for(batch_bucket(len(items)))
        dispatchmeter.count("encode")
        slots = self._data_slots
        if slots is not None and len(slots) > 1 and ids.shape[0] % len(slots) == 0:
            return self._encode_ids_sharded(ids), len(items)
        return self.encode_ids(self._to_device(ids)), len(items)

    @staticmethod
    def materialize(dispatched) -> np.ndarray:
        """Copy a dispatched encode to the host and trim batch padding."""
        out, n = dispatched
        return out[:n].cpu().numpy()

    def encode_query(self, query: str) -> np.ndarray:
        """Single query -> (dim,) f32."""
        return self.encode([query])[0]

    def highlight(self, query: str, documents: Sequence[str], query_emb=None):
        """Best snippet per document."""
        from .highlight import highlight as _highlight

        return _highlight(self, query, documents, query_emb=query_emb)
