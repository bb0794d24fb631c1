"""Convert ImageNet-pretrained HRNet torch weights to a port backbone file.

The counterpart of ``scripts/prepare_hrnet.py`` without JAX. Download the
``.pth`` yourself (the reference's ``prepare/download_hrnet.sh`` URLs), then

    python scripts/torch_prepare_hrnet.py \\
        --torch-ckpt checkpoints/hrnetv2_w40_imagenet_pretrained.pth \\
        --width 40 --out checkpoints/hrnet_w40.pt

and point the train config at it:

    MODEL:
      PRETRAINED_BACKBONE: checkpoints/hrnet_w40.pt

The output is ``{"params": {"backbone.<key>": tensor}}`` for an HRNet built with
``NORM: frozen_bn`` (keys the file does not hold keep their initial values,
seed 0); the ImageNet classification head is reported as leftover.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--torch-ckpt", type=str, required=True)
    p.add_argument("--width", type=int, default=40)
    p.add_argument("--out", type=str, required=True)
    args = p.parse_args(argv)

    import torch

    from poem_v2_tpu_torch.convert_reference import apply_table, hrnet_table, load_torch_state_dict
    from poem_v2_tpu_torch.models.backbones.hrnet import HRNet
    from poem_v2_tpu_torch.models.poem import init_parameters

    backbone = HRNet(width=args.width, norm="frozen_bn")
    init_parameters(backbone, torch.Generator().manual_seed(0))
    params = {f"backbone.{k}": v for k, v in backbone.state_dict().items()}
    state = load_torch_state_dict(args.torch_ckpt)
    converted, leftover = apply_table(state, hrnet_table(params))
    for key, value in converted.items():
        value = torch.as_tensor(value)
        if value.shape != params[key].shape:
            raise ValueError(f"{key}: shape {tuple(value.shape)} in the checkpoint, "
                             f"{tuple(params[key].shape)} in the model")
        params[key] = value.to(params[key].dtype)
    missing = [k for k in params if k not in converted]
    print(f"converted {len(converted)} tensors; {len(leftover)} leftover (classification head "
          f"etc.): {leftover[:5]}...; {len(missing)} backbone keys at their initial values")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    torch.save({"params": params}, args.out)
    print(f"wrote {args.out} (MODEL.PRETRAINED_BACKBONE)")
    return dict(converted=len(converted), leftover=leftover, missing=missing, out=args.out)


if __name__ == "__main__":
    main()
