"""Model lifecycle protocol and adapter (counterpart of ``poem_v2_tpu/models/model_abc.py``).

The reference couples model, losses and metrics in an ``nn.Module`` lifecycle
(lib/models/model_abc.py:5-49: training_step / validation_step / testing_step /
on_*_finished). The port keeps those concerns in the Trainer
(``training/trainer.py``), the Evaluator (``training/evaluator.py``) and the
Recorder (``utils/recorder.py``); :class:`LifecycleAdapter` gives them the
reference's method names.
"""

from __future__ import annotations

from typing import Any, Dict, Protocol

from ..training.evaluator import EVAL_KEYS, IdleCallback
from ..training.prefetch import prefetch_to_device


class ModelABC(Protocol):
    """The reference lifecycle contract (for structural typing)."""

    def training_step(self, batch, step_idx, **kwargs): ...

    def validation_step(self, batch, step_idx, **kwargs): ...

    def testing_step(self, batch, step_idx, **kwargs): ...

    def on_train_finished(self, recorder, epoch_idx, **kwargs): ...

    def on_val_finished(self, recorder, epoch_idx, **kwargs): ...


class LifecycleAdapter:
    """Reference-style lifecycle over (model, aux, Trainer, Evaluator). The Trainer
    holds the state (parameters, optimiser, step); test steps add to the
    Evaluator's meters until :meth:`on_val_finished` reads and resets them."""

    def __init__(self, model, aux: Dict[str, Any], trainer, evaluator):
        self.model = model
        self.aux = aux
        self.trainer = trainer
        self.evaluator = evaluator
        self.summary = None

    # -- reference surface --------------------------------------------------
    def setup(self, summary_writer=None, **kwargs):
        self.summary = summary_writer

    def init(self, sample_batch=None):
        """The Trainer's state; it is made with the Trainer, so nothing is drawn here."""
        return self.trainer.state_dict()

    def training_step(self, batch, step_idx: int, **kwargs):
        metrics = self.trainer.step(batch)
        if self.summary is not None:
            for k, v in metrics.items():
                self.summary.add_scalar(k, float(v), step_idx)
        return metrics

    def validation_step(self, batch, step_idx: int, **kwargs):
        return self.testing_step(batch, step_idx, **kwargs)

    def testing_step(self, batch, step_idx: int, callback=None, **kwargs):
        """The measures so far, this batch added."""
        dev_batch = next(prefetch_to_device([batch], self.evaluator.device, keys=EVAL_KEYS))
        self.evaluator.feed(dev_batch, step_idx, callback or IdleCallback())
        return self.evaluator.measures()

    def on_train_finished(self, recorder, epoch_idx: int, **kwargs):
        recorder.record_checkpoint(self.trainer, epoch_idx)

    def on_val_finished(self, recorder, epoch_idx: int, **kwargs):
        results = {}
        for m in (self.evaluator.MPJPE, self.evaluator.MPVPE, self.evaluator.PA):
            results.update(m.get_measures())
        recorder.record_metric([f"{k}: {v:.6f}" for k, v in results.items()], epoch_idx)
        self.evaluator.reset()
        return results
