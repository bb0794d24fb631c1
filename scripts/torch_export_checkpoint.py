"""Export an orbax checkpoint of the JAX package to a port weights file.

    python scripts/torch_export_checkpoint.py exp/<run>/checkpoints/checkpoint \\
        --out checkpoints/run_port.pt

Reads a JAX Recorder checkpoint (``{params, opt_state, step, rng}``,
``poem_v2_tpu/utils/recorder.py:record_checkpoint``; also the outputs of
``scripts/convert_checkpoint.py``) or a ``scripts/prepare_hrnet.py`` directory
(``{backbone}``), carries the flax parameters over by
``poem_v2_tpu_torch/convert.py:flax_to_state_dict`` and writes
``{"params": state_dict}``. Weights only, as the JAX ``Recorder.load_params``
reads them: the port reads the file with ``--reload`` / ``MODEL.PRETRAINED``,
``Predictor.from_config(cfg, ckpt_path=...)`` and, for ``backbone.*``,
``MODEL.PRETRAINED_BACKBONE``. This script imports JAX and orbax; the port does
not, so run it where the JAX package runs.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("ckpt", type=str, help="orbax checkpoint directory")
    p.add_argument("--out", type=str, required=True)
    args = p.parse_args(argv)

    import jax
    import numpy as np
    import orbax.checkpoint as ocp
    import torch

    from poem_v2_tpu_torch.convert import flax_to_state_dict

    restored = ocp.StandardCheckpointer().restore(os.path.abspath(args.ckpt))
    if "params" in restored:
        params = restored["params"]
    elif "backbone" in restored:
        params = {"backbone": restored["backbone"]}
    else:
        raise ValueError(f"{args.ckpt} holds neither params nor backbone: {sorted(restored)}")
    params = jax.tree_util.tree_map(np.asarray, params)
    state = {k: torch.from_numpy(np.array(v)) for k, v in
             flax_to_state_dict({"params": params}).items()}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    torch.save({"params": state}, args.out)
    print(f"wrote {args.out}: {len(state)} tensors (load with --reload / MODEL.PRETRAINED / "
          "Predictor ckpt_path; backbone.* also with MODEL.PRETRAINED_BACKBONE)")
    return dict(n=len(state), out=args.out)


if __name__ == "__main__":
    main()
