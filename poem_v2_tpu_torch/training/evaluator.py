"""Evaluation loop and callbacks (counterpart of ``poem_v2_tpu/training/evaluator.py``).

The reference's eval protocol (its ``testing_step``): the model in eval mode
predicts joints and vertices; joints are re-derived from the predicted and
the ground-truth meshes through the MANO joint regressor (OpenPose order),
then MPJPE / MPVPE, their root-relative forms, the reference (triangulated)
joints' error, and Procrustes-aligned errors. Callbacks add PCK-AUC or dump
predictions.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Iterable, Mapping, Optional

import numpy as np
import torch

from ..geometry.camera import mano_to_openpose
from ..metrics import Joint3DPCK, MeanEPE, PAEval, Vert3DPCK
from ..utils.logger import logger
from .prefetch import prefetch_to_device

EVAL_KEYS = ("image", "view_mask", "cam_intr", "cam_extr", "master_joints_3d",
             "master_verts_3d")


class IdleCallback:
    def __call__(self, preds, batch, step_idx, **kwargs):
        pass

    def on_finished(self):
        pass

    def reset(self):
        pass


class AUCCallback(IdleCallback):
    """PCK-AUC over joints and vertices, 0 to ``val_max`` metres in ``steps``."""

    def __init__(self, exp_dir: str = "", val_max: float = 0.02, steps: int = 20):
        self.exp_dir = exp_dir
        self.pck_j = Joint3DPCK(val_max=val_max, steps=steps)
        self.pck_v = Vert3DPCK(val_max=val_max, steps=steps)
        self.auc_j = self.auc_v = None

    def __call__(self, preds, batch, step_idx, **kwargs):
        self.pck_j.feed(preds["pred_joints_3d_rel"], batch["master_joints_3d_rel"])
        self.pck_v.feed(preds["pred_verts_3d_rel"], batch["master_verts_3d_rel"])

    def on_finished(self):
        self.auc_j, self.auc_v = self.pck_j.get_auc(), self.pck_v.get_auc()
        logger.info(f"AUC joints: {self.auc_j:.6f}, AUC verts: {self.auc_v:.6f}")
        if self.exp_dir:
            os.makedirs(self.exp_dir, exist_ok=True)
            with open(os.path.join(self.exp_dir, "res_auc_j.pkl"), "wb") as f:
                pickle.dump(self.pck_j.pck_curve(), f)
            with open(os.path.join(self.exp_dir, "res_auc_v.pkl"), "wb") as f:
                pickle.dump(self.pck_v.pck_curve(), f)
            with open(os.path.join(self.exp_dir, "auc.txt"), "a") as f:
                f.write(f"auc_j {self.auc_j:.6f} auc_v {self.auc_v:.6f}\n")

    def reset(self):
        self.pck_j.reset()
        self.pck_v.reset()


class PredictionSaverCallback(IdleCallback):
    """Predicted joints and vertices of every step, one pickle each."""

    def __init__(self, exp_dir: str):
        self.exp_dir = exp_dir
        os.makedirs(exp_dir, exist_ok=True)

    def __call__(self, preds, batch, step_idx, **kwargs):
        path = os.path.join(self.exp_dir, f"preds_{step_idx:06d}.pkl")
        payload = {"pred_joints_3d": np.asarray(preds["pred_joints_3d"]),
                   "pred_verts_3d": np.asarray(preds["pred_verts_3d"])}
        with open(path, "wb") as f:
            pickle.dump(payload, f)


class Evaluator:
    """Runs the eval protocol over batches with the model on its device.

    The model is put in ``eval()`` and runs at the dtype it was built with (a
    ``compute_dtype`` runs under autocast, as in serving); every measure is
    float32, in metres."""

    def __init__(self, model: torch.nn.Module, aux: Mapping[str, Any], center_idx: int = 0,
                 pred_joints_from_mesh: bool = True):
        self.model = model
        self.center_idx = center_idx
        self.pred_joints_from_mesh = pred_joints_from_mesh
        self.device = next(model.parameters()).device
        self.j_regressor = aux["j_regressor"].float().to(self.device)

        self.MPJPE = MeanEPE("joints_3d")
        self.MPJPE_REF = MeanEPE("joints_3d_ref")
        self.MPVPE = MeanEPE("vertices_3d")
        self.MPJPE_REL = MeanEPE("joints_3d_rel")
        self.MPVPE_REL = MeanEPE("vertices_3d_rel")
        self.MPTPE = MeanEPE("triangulate_joints")
        self.PA = PAEval(mesh_score=True)
        self.samples = 0  # samples of the last run

    def _meters(self):
        return (self.MPJPE, self.MPJPE_REF, self.MPVPE, self.MPJPE_REL, self.MPVPE_REL,
                self.MPTPE)

    def reset(self):
        for m in self._meters() + (self.PA,):
            m.reset()

    @torch.no_grad()
    def predict(self, batch: Mapping[str, torch.Tensor]):
        """(pred joints, pred verts, reference joints), float32 on the device."""
        self.model.eval()
        preds = self.model(batch["image"], batch["view_mask"], batch["cam_intr"],
                           batch["cam_extr"], batch["master_joints_3d"])
        return (preds["pred_joints_3d"].float(), preds["pred_verts_3d"].float(),
                preds["pred_ref_joints_3d"].float())

    def run(self, batches: Iterable[Mapping[str, Any]], callback: Optional[IdleCallback] = None,
            max_steps: int = 0) -> Dict[str, float]:
        """The measures over ``batches`` (numpy batches, or tensors already on the
        device). The meters start from zero on every call; the JAX Evaluator's
        keep summing over its calls, so its periodic validation reports the mean
        over all epochs so far (ROADMAP queue 3)."""
        callback = callback or IdleCallback()
        self.reset()
        self.samples = 0
        for step_idx, batch in enumerate(prefetch_to_device(batches, self.device, size=2,
                                                            keys=EVAL_KEYS)):
            if max_steps and step_idx >= max_steps:
                break
            self.feed(batch, step_idx, callback)
        callback.on_finished()
        return self.measures()

    def feed(self, batch: Mapping[str, torch.Tensor], step_idx: int, callback: IdleCallback):
        """Add one batch, its ``EVAL_KEYS`` already on the device, to the meters."""
        pred_j, pred_v, pred_ref = self.predict(batch)
        self.samples += pred_j.shape[0]
        gt_j = batch["master_joints_3d"].float()
        gt_v = batch["master_verts_3d"].float()
        if self.pred_joints_from_mesh:
            # joints re-derived from the meshes, as the reference does
            gt_j_eval = mano_to_openpose(self.j_regressor, gt_v)
            pred_j_eval = mano_to_openpose(self.j_regressor, pred_v)
        else:
            gt_j_eval, pred_j_eval = gt_j, pred_j
        centre_p = pred_j_eval[:, self.center_idx][:, None]
        centre_g = gt_j_eval[:, self.center_idx][:, None]
        pred_j_rel, pred_v_rel = pred_j_eval - centre_p, pred_v - centre_p
        gt_j_rel, gt_v_rel = gt_j_eval - centre_g, gt_v - centre_g

        host = {k: t.cpu().numpy() for k, t in dict(
            pred_ref=pred_ref, gt_j=gt_j, pred_j_eval=pred_j_eval, gt_j_eval=gt_j_eval,
            pred_v=pred_v, gt_v=gt_v, pred_j_rel=pred_j_rel, gt_j_rel=gt_j_rel,
            pred_v_rel=pred_v_rel, gt_v_rel=gt_v_rel).items()}
        self.MPTPE.feed(host["pred_ref"], host["gt_j"])
        self.MPJPE.feed(host["pred_j_eval"], host["gt_j_eval"])
        self.MPJPE_REF.feed(host["pred_ref"], host["gt_j_eval"])
        self.MPVPE.feed(host["pred_v"], host["gt_v"])
        self.MPJPE_REL.feed(host["pred_j_rel"], host["gt_j_rel"])
        self.MPVPE_REL.feed(host["pred_v_rel"], host["gt_v_rel"])
        self.PA.feed(pred_j_eval, gt_j_eval, pred_v, gt_v)

        cb_batch = dict(batch)  # tensors on the device; the root-relative targets on the host
        cb_batch["master_joints_3d_rel"] = host["gt_j_rel"]
        cb_batch["master_verts_3d_rel"] = host["gt_v_rel"]
        cb_preds = {"pred_joints_3d": host["pred_j_eval"], "pred_verts_3d": host["pred_v"],
                    "pred_joints_3d_rel": host["pred_j_rel"],
                    "pred_verts_3d_rel": host["pred_v_rel"]}
        callback(cb_preds, cb_batch, step_idx)

    def measures(self) -> Dict[str, float]:
        """The meters' measures so far."""
        results = {}
        for m in self._meters():
            results.update(m.get_measures())
        results.update(self.PA.get_measures())
        return results
