"""Convert a released POEM PyTorch checkpoint (``.pth.tar``) to a port weights file.

    python scripts/torch_convert_checkpoint.py -c configs/release/train_medium.yaml \\
        --torch-ckpt checkpoints/medium_model.pth.tar --out checkpoints/medium_port.pt

then load it with ``--reload checkpoints/medium_port.pt`` (or ``MODEL.PRETRAINED``),
or ``Predictor.from_config(cfg, ckpt_path=...)``, with ``MODEL.BACKBONE.NORM:
frozen_bn`` in the config. The counterpart of ``scripts/convert_checkpoint.py``
without JAX: the config's model is built on the CPU with ``NORM: frozen_bn``
(BatchNorm statistics land in FrozenBatchNorms), the reference names map to its
keys through ``poem_v2_tpu_torch/convert_reference.py``, and the output is
``{"params": state_dict}`` holding every key of the model (those the checkpoint
does not hold keep the model's initial values, seed 0). Leftover reference keys
and the keys left at their initial values are reported, never dropped
silently. Without PyYAML, ``-c`` takes a file whose stem names a config of
``poem_v2_tpu_torch/configs.py`` (``train_medium`` ...).
"""

import argparse
import copy
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-c", "--cfg", type=str, required=True)
    p.add_argument("--torch-ckpt", type=str, required=True)
    p.add_argument("--out", type=str, required=True)
    args = p.parse_args(argv)

    import torch

    from poem_v2_tpu_torch.convert_reference import convert_poem_checkpoint, load_torch_state_dict
    from poem_v2_tpu_torch.models.poem import create_poem_model
    from poem_v2_tpu_torch.utils.config import load_config_file

    cfg = load_config_file(args.cfg)
    model_cfg = copy.deepcopy(cfg["MODEL"] if "MODEL" in cfg else cfg)
    model_cfg["BACKBONE"]["NORM"] = "frozen_bn"
    model, _ = create_poem_model(model_cfg, device="cpu")
    params = model.state_dict()

    state = load_torch_state_dict(args.torch_ckpt)
    converted, leftover = convert_poem_checkpoint(state, params, arch=model_cfg["BACKBONE"]["TYPE"])
    for key, value in converted.items():
        value = torch.as_tensor(value)
        if value.shape != params[key].shape:
            raise ValueError(f"{key}: shape {tuple(value.shape)} in the checkpoint, "
                             f"{tuple(params[key].shape)} in the model")
        params[key] = value.to(params[key].dtype)
    missing = [k for k in params if k not in converted]
    print(f"converted {len(converted)}/{len(state)} tensors; leftover: {leftover[:8]}"
          f"{'...' if len(leftover) > 8 else ''}; {len(missing)} model keys at their initial "
          f"values: {missing[:8]}{'...' if len(missing) > 8 else ''}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    torch.save({"params": params}, args.out)
    print(f"wrote {args.out} (load with --reload / MODEL.PRETRAINED / Predictor ckpt_path)")
    return dict(converted=len(converted), leftover=leftover, missing=missing, out=args.out)


if __name__ == "__main__":
    main()
