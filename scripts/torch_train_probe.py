"""Loss under fixed noise after each of 12 train steps of the released tiers, on one CUDA card.

    env PYTHONPATH=. python3 scripts/torch_train_probe.py small medium large large:2 huge

Each argument is a tier, optionally with the Trainer's seed after a colon
(default: the tier's ``TRAIN.MANUAL_SEED``), or with ``:global`` for steps
whose dropout draws from the global generators seeded 0 once (what a Trainer
did before it seeded dropout itself; the jitter still from its own seed). The model is built from seed 0
(bf16 compute, float32 parameters) and trained with ``Trainer.step`` on
chip_smoke's phase-4a batch (8 samples, 1-8 of 8 views); before the first
step and after every step the train-mode loss is read under fixed noise
(``chip_smoke._probe_loss``: the same reference jitter and dropout masks at
every read). Shows how far a few steps move that loss against the noise of
the steps' own dropout streams.
"""

import sys

import torch

import chip_smoke
from poem_v2_tpu_torch.configs import RELEASE
from poem_v2_tpu_torch.data.synthetic import SyntheticMultiviewDataset
from poem_v2_tpu_torch.models.poem import create_poem_model, draw_ref_noise
from poem_v2_tpu_torch.training.trainer import Trainer


def main(specs) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    raw = SyntheticMultiviewDataset(batch_size=8, view_max=8, view_range=(1, 8), image_size=256,
                                    seed=3).sample_batch()
    probe_draws = draw_ref_noise(torch.Generator().manual_seed(11), 8)
    for spec in specs:
        name, _, seed = spec.partition(":")
        global_stream = seed == "global"
        seed = None if global_stream else seed
        cfg = RELEASE[name]
        model, aux = create_poem_model(cfg["MODEL"], dtype=torch.bfloat16,
                                       param_dtype=torch.float32, device="cuda",
                                       generator=torch.Generator().manual_seed(0))
        trainer = Trainer(model, aux, cfg["TRAIN"], cfg["MODEL"]["LOSS"],
                          seed=int(seed) if seed else None)
        batch = trainer.to_device(raw)
        probes = [chip_smoke._probe_loss(trainer, batch, probe_draws)]
        torch.manual_seed(0)
        # the global stream across steps, kept apart from the reads' fixed noise
        rng = torch.get_rng_state(), torch.cuda.get_rng_state()
        for _ in range(12):
            if global_stream:
                torch.set_rng_state(rng[0])
                torch.cuda.set_rng_state(rng[1])
                trainer._train_step(batch, draw_ref_noise(trainer.generator, 8))
                rng = torch.get_rng_state(), torch.cuda.get_rng_state()
            else:
                trainer.step(batch)
            probes.append(chip_smoke._probe_loss(trainer, batch, probe_draws))
        print(f"{spec}: loss under fixed noise before and after each step: "
              + ", ".join(f"{x:.4f}" for x in probes), flush=True)
        del model, trainer
        torch.cuda.empty_cache()
    print(chip_smoke.gpu_line())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
