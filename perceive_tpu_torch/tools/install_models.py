"""Download sentence-transformers checkpoints into the model-data dir.

The port's counterpart of ``scripts/install_models.py``, which imports the
JAX package: the same downloads into the same folders, for a machine that
has only PyTorch.  The loader (``models/convert.py``) reads the
sentence-transformers layout as it is, so installing is a download into
``model_data/<checkpoint-dir>`` (``PERCEIVE_TPU_MODEL_DATA`` moves it).

Usage:
    python -m perceive_tpu_torch.tools.install_models          # the two defaults
    python -m perceive_tpu_torch.tools.install_models AllMiniLmL6V2 MsMarcoBertBaseDotV5
    python -m perceive_tpu_torch.tools.install_models --all

Needs network access to huggingface.co and the ``huggingface_hub``
package.  Without them, copy a sentence-transformers export into
``model_data/<checkpoint-dir>/`` by hand.
"""

from __future__ import annotations

import argparse
import sys

from ..cli.state import DEFAULT_HIGHLIGHT_MODEL, DEFAULT_MODEL
from ..models.registry import ModelType, model_data_dir

DEFAULTS = [DEFAULT_MODEL, DEFAULT_HIGHLIGHT_MODEL]
ALLOW_PATTERNS = ["*.json", "*.txt", "*.safetensors", "pytorch_model.bin", "1_Pooling/*", "2_Dense/*"]


def install(mt: ModelType) -> None:
    target = model_data_dir() / mt.checkpoint_dir_name
    if (target / "config.json").exists():
        print(f"{mt.value}: already installed at {target}")
        return
    from huggingface_hub import snapshot_download

    print(f"{mt.value}: downloading sentence-transformers/{mt.checkpoint_dir_name} ...")
    snapshot_download(f"sentence-transformers/{mt.checkpoint_dir_name}", local_dir=target,
                      allow_patterns=ALLOW_PATTERNS)
    print(f"{mt.value}: installed at {target}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("models", nargs="*", help="model type names (registry values)")
    ap.add_argument("--all", action="store_true", help=f"install all {len(ModelType)} registry models")
    args = ap.parse_args(argv)

    if args.all:
        targets = list(ModelType)
    elif args.models:
        targets = [ModelType.parse(m) for m in args.models]
    else:
        targets = DEFAULTS

    model_data_dir().mkdir(parents=True, exist_ok=True)
    for mt in targets:
        try:
            install(mt)
        except ModuleNotFoundError as e:
            if e.name != "huggingface_hub":
                raise
            print(f"{mt.value}: not installed: the huggingface_hub package is missing, so nothing can be "
                  f"downloaded here; copy a sentence-transformers export of {mt.checkpoint_dir_name} into "
                  f"{model_data_dir() / mt.checkpoint_dir_name}/ by hand", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
