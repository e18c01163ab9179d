from .encoder import Encoder, EncoderArch, HeadConfig, encode_tokens, init_params, output_dim, pool
from .highlight import highlight
from .model import BATCH_BUCKETS, Model, ModelError, batch_bucket
from .registry import ModelType, ModelVersion, checkpoint_path, model_data_dir
from .tokenize import SEQ_BUCKETS, TextTokenizer, TokenBatch, bucket_length, tiny_test_vocab

__all__ = [
    "Encoder",
    "EncoderArch",
    "HeadConfig",
    "encode_tokens",
    "init_params",
    "output_dim",
    "pool",
    "highlight",
    "Model",
    "ModelError",
    "ModelType",
    "ModelVersion",
    "checkpoint_path",
    "model_data_dir",
    "TextTokenizer",
    "TokenBatch",
    "tiny_test_vocab",
    "bucket_length",
    "batch_bucket",
    "SEQ_BUCKETS",
    "BATCH_BUCKETS",
]
