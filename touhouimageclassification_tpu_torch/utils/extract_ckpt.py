"""Training checkpoint -> serving params (counterpart of the JAX package's
``utils/extract_ckpt.py``).

``extract`` writes ``<output>/params.safetensors``, a bare params directory
that ``infer.serve`` loads with ``--model``:

- from one epoch directory of a training checkpoint
  (``train.checkpoint.CheckpointManager``: ``meta.json`` and every
  ``state*.safetensors``, the expert shards of an expert-parallel save
  included), the model's tensors as saved, without the optimizer's
  ``opt/*`` and the accumulator's ``acc/*``;
- from a bare params directory (or a serving export), its parameters as
  they are;
- from a reference ``.pth``/``.pt``, through ``utils.convert``, which needs
  the model type.

CLI: ``python -m touhouimageclassification_tpu_torch.utils.extract_ckpt
--input <epoch dir | .pth> --output <dir> [--model vit-large]
[--num-classes 120]``
"""
from __future__ import annotations

import os

from ..train.checkpoint import SERVING_PARAMS, read_weights, save_params
from .convert import convert_and_save


def extract(input_path: str, output_path: str, model_type: str | None = None,
            num_classes: int = 120) -> str:
    if input_path.endswith((".pth", ".pt")):
        if not model_type:
            raise SystemExit("--model is required for .pth inputs")
        return convert_and_save(input_path, model_type, num_classes,
                                output_path)
    params = read_weights(input_path)
    os.makedirs(output_path, exist_ok=True)
    # written aside and renamed: the tensors read may map the file replaced
    out = os.path.join(output_path, SERVING_PARAMS)
    save_params(out + ".tmp", params)
    os.replace(out + ".tmp", out)
    return output_path


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description="Extract serving params")
    parser.add_argument("--input", required=True,
                        help="training checkpoint epoch dir or reference .pth")
    parser.add_argument("--output", required=True)
    parser.add_argument("--model", default=None, help="model type for .pth inputs")
    parser.add_argument("--num-classes", type=int, default=120)
    args = parser.parse_args(argv)
    out = extract(args.input, args.output, args.model, args.num_classes)
    print(f"Extracted to {out}")


if __name__ == "__main__":
    main()
