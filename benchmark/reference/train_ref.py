"""The plain float32 reference of POEM's train step, written for the benchmark.

On top of :class:`~benchmark.reference.poem_ref.Reference`'s forward it adds what
a train step does (``poem_v2_tpu_torch/training/trainer.py``): the reference
joints jittered from the step's draws, the decoder's dropout, the POEM loss
(``models/losses.py``'s terms and weights), autograd gradients, per-parameter
L2 clipping and Adam with the configuration's schedule and step count. It
imports nothing of the program and takes nothing the program made: the weights
come from the seed, and the benchmark hands it the same inputs it hands the
program: the batches, the jitter draws and the dropout masks (the step's
randomness, drawn from the step's own generator state).

The neighbour choices of the K-nearest-neighbour blocks are held fixed: a run
takes the indices of the side under test (``indices``), so the continuous
numbers compare like with like, and the choices are judged apart by
:func:`invalid_rows` against float32 distances. ``select="packed"`` lets the
reference choose by itself instead, by the key the port's selection orders by
(the squared distance formed one rounded float32 operation at a time, its 12
low bits replaced by the column, so distances within 2**-11 of each other tie
and go to the lower index), optionally from coordinates rounded by the
precision (``select_rounded``: the control's choice).

It runs in blocks of samples so that it fits: the loss divides by the whole
batch's counts, so the blocks' gradients add up to the batch's. TF32 must be
off while it runs (``poem_ref.float32_matmuls``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from .mano_ref import regress_joints
from .poem_ref import Precision, Reference

GROUPS = ("backbone", "feat_neck", "uv_neck", "head_in", "decoder")


def group_of(name: str) -> str:
    """The module group of a parameter: backbone, feature neck, heatmap neck, the
    head's input / sampling / merge layers, or the decoder."""
    if name.startswith("head.transformer."):
        return "decoder"
    if name.startswith("head."):
        return "head_in"
    return name.split(".", 1)[0]


# ---------------------------------------------------------------------------
# neighbour selection
# ---------------------------------------------------------------------------

def square_distance_rn(query: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """(B, M, 3), (B, N, 3) -> (B, M, N): ``(|q|^2 + |p|^2) - 2 q.p``, one rounded
    float32 operation at a time (no product, no fused multiply-add)."""
    q = query.float()[:, :, None, :]
    p = points.float()[:, None, :, :]

    def sq(a):
        return a[..., 0] * a[..., 0] + a[..., 1] * a[..., 1] + a[..., 2] * a[..., 2]

    cross = q[..., 0] * p[..., 0] + q[..., 1] * p[..., 1] + q[..., 2] * p[..., 2]
    return (sq(q) + sq(p)) - 2.0 * cross


def select_packed(query: torch.Tensor, points: torch.Tensor, k: int) -> torch.Tensor:
    """(B, M, k) indices by the packed key: the distance's float32 bits with the
    12 low bits replaced by the column (clouds of up to 4096 points)."""
    N = points.shape[1]
    if N > 4096:
        raise ValueError("the packed key holds columns of up to 4096 points")
    d2 = square_distance_rn(query, points)
    col = torch.arange(N, device=d2.device, dtype=torch.int32)
    keys = (d2.clamp_min(0.0).view(torch.int32) & ~0xFFF) | col
    return (torch.sort(keys, dim=-1).values[..., :k] & 0xFFF).long()


KEY_RESOLUTION = 2.0 ** -11  # relative: the packed key keeps 11 of float32's 23 mantissa bits


def invalid_rows(query: torch.Tensor, points: torch.Tensor, idx: torch.Tensor) -> int:
    """Rows of ``idx`` (B, M, K) that are not a set of K nearest ``points`` to
    ``query`` up to ties within the key's resolution: a repeated or out-of-range
    index, or a chosen point farther than an unchosen one by more than twice the
    key's resolution (relative) plus the rounding of the subtraction form
    (16 float32 ulps of |q|^2 + |p|^2), all against float32 distances."""
    B, M, K = idx.shape
    N = points.shape[1]
    idx = idx.long()
    if idx.min() < 0 or idx.max() >= N:
        return B * M
    d2 = ((query.float()[:, :, None, :] - points.float()[:, None, :, :]) ** 2).sum(-1)
    s, _ = torch.sort(idx, dim=-1)
    repeated = (s[..., 1:] == s[..., :-1]).any(-1)
    chosen = torch.zeros_like(d2, dtype=torch.bool).scatter_(-1, idx, True)
    far = torch.gather(d2, -1, idx).max(-1).values
    near_other = torch.where(chosen, torch.full_like(d2, math.inf), d2).min(-1).values
    scale = (query.float() ** 2).sum(-1) + (points.float() ** 2).sum(-1).max(-1).values[:, None]
    slack = near_other * 2 * KEY_RESOLUTION + 16 * 2.0 ** -24 * scale
    bad = repeated | (far > near_other + slack)
    return int(bad.sum())


# ---------------------------------------------------------------------------
# the train forward
# ---------------------------------------------------------------------------

def jitter(gt: torch.Tensor, draws: Sequence[torch.Tensor], ref_noise: float = 0.01,
           center_idx: int = 0) -> torch.Tensor:
    """Ground-truth joints (B, J, 3) moved by the draws' noise and scaled by
    1 +- 1% about the jittered root (the train forward's reference joints)."""
    normal_joints, normal_shift, uniform = draws
    ref = gt.float() + ref_noise * (normal_joints + normal_shift)
    root = ref[:, center_idx][:, None]
    return (0.01 * (uniform * 2.0 - 1.0) + 1.0) * (ref - root) + root


class TrainReference(Reference):
    """The forward of a train step: :class:`Reference` with the decoder's dropout
    masks and held (or its own) neighbour choices.

    ``masks[i][site]`` is block i's keep mask of a dropout site (bool, the whole
    batch's rows), ``indices`` the K-nearest choices in the program's call order
    (block 1 self, block 1 cross, block 2 self, ...), each (B, M, K). Set
    ``rows`` to the block of samples a forward runs on. ``chosen`` collects the
    (query, cloud, indices) of every selection the forward used."""

    def __init__(self, params, model_cfg, consts, precision: Precision, dropout: float,
                 select: str = "given", select_rounded: bool = False):
        super().__init__(params, model_cfg, consts, precision)
        if select not in ("given", "packed"):
            raise ValueError(f"unknown selection {select!r}")
        self.keep_scale = 1.0 / (1.0 - dropout)
        self.select, self.select_rounded = select, select_rounded
        self.masks: Optional[List[Dict[str, torch.Tensor]]] = None
        self.indices: Optional[List[torch.Tensor]] = None
        self.rows = slice(None)
        self.chosen: List = []
        self._call = 0

    def drop(self, x, i, site):
        if self.masks is None:
            return x
        return x * (self.masks[i][site][self.rows].to(x.device, x.dtype) * self.keep_scale)

    def mha_drop(self, hidden, kv, n, i, site):
        B, Q, H = hidden.shape
        nh, hd = self.heads, H // self.heads
        q = self.lin(hidden, n + ".query").reshape(B, Q, nh, hd).transpose(1, 2)
        k = self.lin(kv, n + ".key").reshape(B, -1, nh, hd).transpose(1, 2)
        v = self.lin(kv, n + ".value").reshape(B, -1, nh, hd).transpose(1, 2)
        p = torch.softmax(self.pr.mm(q, k.transpose(-1, -2)) / math.sqrt(hd), -1)
        ctx = self.pr.mm(p, v).transpose(1, 2).reshape(B, Q, H)
        return self.ln(self.drop(self.lin(ctx, n + ".out"), i, site) + hidden, n + ".ln")

    def block(self, i, query_xyz, query_feats, pt_xyz, pt_feats):
        n = f"head.transformer.block_{i}"
        q_emb = self.drop(self.lin(query_feats, n + ".embedding"), i, "q_emb")
        k_emb = self.drop(self.lin(pt_feats, n + ".embedding"), i, "k_emb")
        h = self.mha_drop(self.mha_drop(q_emb, k_emb, n + ".attn", i, "attn"), k_emb,
                          n + ".cross_attn", i, "cross_attn")
        s = n + ".vec_attn.query_self_attn"
        x = self.lin(h, s + ".fc1")
        res = self.attend(s, self.lin(x, s + ".w_qs"), query_xyz, query_xyz, x, self.k_self, i == 0)
        h = self.lin(res, s + ".fc2") + h
        c = n + ".vec_attn.query_cross_attn"
        res = self.attend(c, self.lin(h, c + ".w_qs"), query_xyz, pt_xyz, self.lin(k_emb, c + ".fc1"),
                          self.k_cross, i == 0)
        h = self.lin(res, c + ".fc2") + h
        xyz = query_xyz + self.mlp(h, n + ".vec_attn.reg_branch")
        f = n + ".ffn"
        ff = self.lin(F.gelu(self.lin(h, f + ".intermediate")), f + ".output")
        return self.ln(self.drop(ff, i, "ffn") + h, f + ".ln"), xyz

    def attend(self, n, q, query_xyz, cloud_xyz, x_cloud, k, init_block):
        if init_block:
            return super().attend(n, q, query_xyz, cloud_xyz, x_cloud, k, init_block)
        P, pr = self.P, self.pr
        with torch.no_grad():
            qx, cx = query_xyz.detach(), cloud_xyz.detach()
            if self.select == "given":
                idx = self.indices[self._call][self.rows].to(qx.device).long()
            else:
                if self.select_rounded:
                    qx, cx = pr.q(qx), pr.q(cx)
                idx = select_packed(qx, cx, k)
            self.chosen.append((query_xyz.detach(), cloud_xyz.detach(), idx))
        self._call += 1
        delta = query_xyz[:, :, None] - self.gather(cloud_xyz, idx)
        return self.vector_attention(q, self.gather(pr.mm(x_cloud, P[n + ".w_ks.kernel"]), idx),
                                     self.gather(pr.mm(x_cloud, P[n + ".w_vs.kernel"]), idx),
                                     delta, n)

    def forward_rows(self, batch, rows: slice, ref_joints):
        """The forward of the samples ``rows`` of a batch (dict of tensors)."""
        self.rows, self._call = rows, 0
        t = lambda k: batch[k][rows]
        return self.forward(t("image").float(), t("view_mask").bool(), t("cam_intr").float(),
                            t("cam_extr").float(), ref_joints=ref_joints[rows])


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

def batch_counts(batch) -> Dict[str, float]:
    """The whole batch's normalisers: samples and valid views."""
    return {"samples": float(batch["view_mask"].shape[0]),
            "views": max(float(batch["view_mask"].sum()), 1.0)}


def poem_loss(out, batch, rows: slice, counts: Dict[str, float], loss_cfg: dict,
              j_regressor: torch.Tensor, num_joints: int = 21):
    """The block of samples' share of the batch's POEM loss (non-parametric
    output): 10 x the heatmap 2D term, the 3D joints (L2, and again from the
    mesh by the MANO regressor), the vertices (L1) and the clamped
    reprojection term; means over the whole batch's counts."""
    coords = out["coords"][-1]
    joints, verts = coords[:, :num_joints], coords[:, num_joints:]
    mask = batch["view_mask"][rows].float()
    gt_j, gt_v = batch["master_joints_3d"][rows].float(), batch["master_verts_3d"][rows].float()
    gt_2d = batch["target_joints_2d"][rows].float()
    H, W = batch["image"].shape[2], batch["image"].shape[3]
    scale = math.sqrt(float(W ** 2 + H ** 2))
    S, nv = counts["samples"], counts["views"]
    views = lambda x: (x * mask[..., None]).sum() / (nv * num_joints)
    hm = views((((out["joints_uv"] - gt_2d) / scale) ** 2).sum(-1))
    l2 = lambda a, b: ((a - b) ** 2).sum() / (S * a.shape[1] * 3)
    j3d = l2(joints, gt_j)
    jmesh = l2(regress_joints(j_regressor, verts), regress_joints(j_regressor, gt_v))
    v3d = (verts - gt_v).abs().sum() / (S * verts.shape[1] * 3)
    extr = batch["cam_extr"][rows].float()
    m2c = Reference.world_to_cam(extr)
    cam = (m2c[:, :, None, :3, :3] @ joints[:, None, :, :, None])[..., 0] + m2c[:, :, None, :3, 3]
    proj = (batch["cam_intr"][rows].float()[:, :, None] @ cam[..., None])[..., 0]
    z = proj[..., 2:3]
    z = torch.where(z.abs() < 1e-7, torch.full_like(z, 1e-7), z)
    off = torch.clamp(proj[..., :2] / z - gt_2d, -0.5 * scale, 0.5 * scale) / scale
    l2d = views((off ** 2).sum(-1))
    w = lambda k, d: loss_cfg.get(k, d)
    return (w("HEATMAP_JOINTS_WEIGHT", 10.0) * hm
            + w("JOINTS_LOSS_WEIGHT", 1.0) * (j3d + jmesh)
            + w("VERTICES_LOSS_WEIGHT", 1.0) * v3d + w("JOINTS_2D_LOSS_WEIGHT", 1.0) * l2d)


# ---------------------------------------------------------------------------
# clipping, Adam and the schedule
# ---------------------------------------------------------------------------

def learning_rate(train_cfg: dict, n: int, steps_per_epoch: int) -> float:
    """The rate of the n-th update (n = 0, 1, ...): StepLR / MultiStepLR, the
    release tiers' schedule, times ``LR_DECAY_GAMMA`` at each of ``LR_DECAY_STEP``'s
    epochs."""
    lr, sched = train_cfg["LR"], train_cfg.get("SCHEDULER", "StepLR")
    if sched not in ("StepLR", "MultiStepLR"):
        raise ValueError(f"the reference follows StepLR / MultiStepLR, not {sched!r}")
    steps = train_cfg.get("LR_DECAY_STEP", [7])
    steps = [steps] if isinstance(steps, int) else steps
    return lr * train_cfg.get("LR_DECAY_GAMMA", 0.1) ** sum(n >= s * steps_per_epoch
                                                             for s in steps)


def clip_per_parameter(grads: Dict[str, torch.Tensor], max_norm: float) -> Dict[str, torch.Tensor]:
    """Each gradient scaled by min(max_norm / (its L2 norm + 1e-6), 1)."""
    return {k: g * torch.clamp(max_norm / (g.norm() + 1e-6), max=1.0) for k, g in grads.items()}


def adam(params, grads, mu, nu, t: int, lr: float, b1=0.9, b2=0.999, eps=1e-8) -> None:
    """One Adam update (t = 1, 2, ...), in place."""
    with torch.no_grad():
        for k, p in params.items():
            mu[k].mul_(b1).add_(grads[k], alpha=1 - b1)
            nu[k].mul_(b2).addcmul_(grads[k], grads[k], value=1 - b2)
            step = (mu[k] / (1 - b1 ** t)) / ((nu[k] / (1 - b2 ** t)).sqrt() + eps)
            p.sub_(lr * step)


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------

def follow_steps(weights: Dict[str, torch.Tensor], model_cfg: dict, train_cfg: dict, consts,
                 steps: List[dict], chunk: int, steps_per_epoch: int,
                 precision: Precision = Precision("float32"), select: str = "given",
                 select_rounded: bool = False, center_idx: int = 0, ref_noise: float = 0.01,
                 dropout: float = 0.1, half: bool = False) -> dict:
    """Run the train steps ``steps`` (each ``{"batch", "draws", "masks",
    "indices"}``, ``indices`` only with ``select="given"``) from ``weights``.

    Returns ``loss`` (a float a step), ``coords`` (a step's last-block
    predictions, (B, 799, 3) on the CPU), ``grad_raw`` / ``grad_clipped``
    (the first step's gradient norm a parameter, before and after clipping),
    ``change`` (the norm of each parameter's change over all steps) and
    ``chosen`` (each step's list of (query, cloud, indices)). ``half`` plants a
    fault: the loss of the first half of each batch alone, its mean over those
    samples (every sample is still predicted)."""
    params = {k: v.detach().clone().float().requires_grad_(True) for k, v in weights.items()}
    start = {k: v.detach().clone() for k, v in params.items()}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    clip = train_cfg.get("GRAD_CLIP", {}) or {}
    out = {"loss": [], "coords": [], "chosen": []}
    for t, step in enumerate(steps):
        batch = step["batch"]
        ref = TrainReference(params, model_cfg, consts, precision, dropout, select,
                             select_rounded)
        ref.masks, ref.indices = step.get("masks"), step.get("indices")
        B = batch["image"].shape[0]
        kept = B // 2 if half else B
        counts = batch_counts({"view_mask": batch["view_mask"][:kept]})
        ref_joints = jitter(batch["master_joints_3d"], [d.to(batch["image"].device)
                                                        for d in step["draws"]],
                            ref_noise, center_idx)
        loss_sum, coords = 0.0, []
        bounds = sorted({*range(0, B, chunk), kept} - {B})
        for s, e in zip(bounds, bounds[1:] + [B]):
            rows = slice(s, e)
            o = ref.forward_rows(batch, rows, ref_joints)
            if s < kept:
                loss = poem_loss(o, batch, rows, counts, model_cfg["LOSS"],
                                 consts["j_regressor"])
                loss.backward()
                loss_sum += float(loss.detach())
                del loss
            coords.append(o["coords"][-1].detach().cpu())
            del o
        out["loss"].append(loss_sum)
        out["coords"].append(torch.cat(coords))
        # each block of samples made the same calls in order: join them by call
        calls = len(ref.chosen) // len(coords)
        out["chosen"].append([tuple(torch.cat([ref.chosen[b * calls + c][j] for b in
                                               range(len(coords))]).cpu() for j in range(3))
                              for c in range(calls)])
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).detach()
                 for k, p in params.items()}
        clipped = clip_per_parameter(grads, clip.get("NORM", 1.0)) \
            if train_cfg.get("GRAD_CLIP_ENABLED", True) else grads
        if t == 0:
            out["grad_raw"] = {k: float(g.norm()) for k, g in grads.items()}
            out["grad_clipped"] = {k: float(g.norm()) for k, g in clipped.items()}
            out["grad_tensors"] = {k: g.clone() for k, g in clipped.items()}
        adam(params, clipped, mu, nu, t + 1, learning_rate(train_cfg, t, steps_per_epoch))
        for p in params.values():
            p.grad = None
        del grads, clipped, ref
    out["change"] = {k: float((params[k].detach() - start[k]).norm()) for k in params}
    return out
