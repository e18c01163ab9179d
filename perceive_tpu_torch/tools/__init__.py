"""Checkpoint tooling for the port, run as ``python -m
perceive_tpu_torch.tools.<name>``: ``install_models`` downloads registry
checkpoints into the model-data dir, ``verify_checkpoint`` checks the
loaders and the encoder against golden vectors.  Neither imports jax or
the JAX package."""
