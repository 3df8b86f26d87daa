"""The fused SR-GAN step, plainly, with Adam: the reference that the
benchmark holds the program's first steps to.

One step, as the SR-GAN paper and its upstream code define it:

1. D: the labeled loss on the labeled batch; feature matching between the
   batch-mean D features of the labeled and the unlabeled batch (the L2
   distance, × the unlabeled multiplier); feature contrasting, −log(1 +
   the L1 distance) of the unlabeled and fake batch-mean features (× the
   fake multiplier), with fake = G(z_d) held fixed; the gradient penalty
   mean((‖∇_x contrast(x̂)‖₂ − 1)²) × its multiplier at the per-example
   interpolates x̂ = α·unlabeled + (1 − α)·fake, differentiated again for
   D's weights. Adam on D.
2. G, against the updated D: the L2 distance of the fake batch-mean
   features (z_g) to the unlabeled ones, those held fixed. Adam on G.
3. The supervised DNN: the labeled loss. Adam on the DNN.

Adam: m ← β₁m + (1 − β₁)g, v ← β₂v + (1 − β₂)g², p ← p − lr·m̂/(√v̂ + ε)
with the bias corrections m̂ = m/(1 − β₁ᵗ), v̂ = v/(1 − β₂ᵗ), ε = 1e-8; a
decay (D and the DNN only) multiplies p by 1 − lr·decay first.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence, Tuple

import torch

from benchmark.reference.quant import EXACT, Rounding

Tensor = torch.Tensor
Weights = Dict[str, Tensor]


@dataclasses.dataclass(frozen=True)
class Hyper:
    learning_rate: float = 1e-4
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    weight_decay: float = 0.0
    unlabeled_loss_multiplier: float = 1.0
    fake_loss_multiplier: float = 1.0
    gradient_penalty_multiplier: float = 10.0


@dataclasses.dataclass(frozen=True)
class Models:
    """``d(weights, x, q) -> (predictions, features)`` (also the DNN's),
    ``g(weights, z, q) -> images``, ``labeled_loss(predictions, labels)``.
    """
    d: Callable
    g: Callable
    labeled_loss: Callable


def feature_distance(a: Tensor, b: Tensor, order: int) -> Tensor:
    diff = (a.reshape(a.shape[0], -1).mean(dim=0)
            - b.reshape(b.shape[0], -1).mean(dim=0)).abs()
    if order == 1:
        return diff.sum()
    return torch.sqrt(diff.square().sum() + 1e-12)


class Adam:
    def __init__(self, weights: Weights, hyper: Hyper, decay: float):
        self.weights = weights
        self.hyper = hyper
        self.decay = decay
        self.m = {k: torch.zeros_like(w) for k, w in weights.items()}
        self.v = {k: torch.zeros_like(w) for k, w in weights.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, Tensor]) -> None:
        h = self.hyper
        self.t += 1
        c1 = 1.0 - h.adam_b1 ** self.t
        c2 = 1.0 - h.adam_b2 ** self.t
        for k, w in self.weights.items():
            g = grads[k]
            if self.decay:
                w.mul_(1.0 - h.learning_rate * self.decay)
            self.m[k].mul_(h.adam_b1).add_(g, alpha=1.0 - h.adam_b1)
            self.v[k].mul_(h.adam_b2).addcmul_(g, g, value=1.0 - h.adam_b2)
            w.sub_(h.learning_rate * (self.m[k] / c1)
                   / ((self.v[k] / c2).sqrt() + 1e-8))


def _grads(loss: Tensor, weights: Weights) -> Dict[str, Tensor]:
    names = list(weights)
    got = torch.autograd.grad(loss, [weights[k] for k in names])
    return dict(zip(names, got))


def run_steps(models: Models, weights: Dict[str, Weights],
              batches: Sequence[Tuple[Tensor, Tensor, Tensor]],
              draws: Sequence[Tuple[Tensor, Tensor, Tensor]],
              hyper: Hyper, q: Rounding = EXACT) -> Dict:
    """``len(batches)`` steps from ``weights`` ({"d", "g", "dnn"}: name →
    float32 tensor, copied here); batch i is (labeled images, labels,
    unlabeled images), draws i is (z_d, α, z_g).

    Returns {"losses": per step {name: float}, "first_grads": {model:
    {name: gradient of step 1}}, "first_weights": the weights after step
    1, "grad_norms": per step {model: {name: the gradient's norm}},
    "weights": {model: {name: weights after the last step}}}."""
    w = {m: {k: t.detach().float().clone().requires_grad_(True)
             for k, t in ws.items()} for m, ws in weights.items()}
    opts = {"d": Adam(w["d"], hyper, hyper.weight_decay),
            "g": Adam(w["g"], hyper, 0.0),
            "dnn": Adam(w["dnn"], hyper, hyper.weight_decay)}
    d = lambda x: models.d(w["d"], x, q)  # noqa: E731
    g = lambda z: models.g(w["g"], z, q)  # noqa: E731
    h = hyper
    out = {"losses": [], "first_grads": None, "grad_norms": []}

    def contrast(f_u, f_other):
        return (-torch.log(feature_distance(f_u, f_other, 1) + 1.0)
                * h.fake_loss_multiplier)

    for (lx, labels, ux), (z_d, alpha, z_g) in zip(batches, draws):
        b = lx.shape[0]
        losses = {}
        # ---- D
        with torch.no_grad():
            fake = g(z_d)
        preds, feats = d(torch.cat([lx, ux, fake]))
        pred_l = (tuple(p[:b] for p in preds) if isinstance(preds, tuple)
                  else preds[:b])
        f_l, f_u, f_f = feats[:b], feats[b:2 * b], feats[2 * b:]
        l_loss = models.labeled_loss(pred_l, labels)
        u_loss = (feature_distance(f_l, f_u, 2)
                  * h.unlabeled_loss_multiplier)
        f_loss = contrast(f_u, f_f)
        a = alpha.view(-1, 1, 1, 1)
        interp = (a * ux + (1.0 - a) * fake).requires_grad_(True)
        _, f_i = d(interp)
        (grad_i,) = torch.autograd.grad(contrast(f_u.detach(), f_i), interp,
                                        create_graph=True)
        norms = torch.sqrt(grad_i.reshape(b, -1).square().sum(dim=1)
                           + 1e-12)
        gp = (norms - 1.0).square().mean() * h.gradient_penalty_multiplier
        total = l_loss + u_loss + f_loss + gp
        d_grads = _grads(total, w["d"])
        losses.update(d_labeled_loss=l_loss.detach(),
                      d_unlabeled_loss=u_loss.detach(),
                      d_fake_loss=f_loss.detach(),
                      d_gradient_penalty=gp.detach(),
                      d_total_loss=total.detach())
        # The D graph goes before the G update is built.
        del preds, feats, pred_l, f_l, f_u, f_f, f_i, grad_i, norms, total
        del interp, l_loss, u_loss, f_loss, gp
        opts["d"].step(d_grads)
        # ---- G, against the updated D
        fake = g(z_g)
        with torch.no_grad():
            _, f_u = d(ux)
        _, f_f = d(fake)
        g_loss = feature_distance(f_u, f_f, 2)
        g_grads = _grads(g_loss, w["g"])
        losses["g_loss"] = g_loss.detach()
        del fake, f_f, g_loss
        opts["g"].step(g_grads)
        # ---- the DNN
        pred, _ = models.d(w["dnn"], lx, q)
        dnn_loss = models.labeled_loss(pred, labels)
        dnn_grads = _grads(dnn_loss, w["dnn"])
        losses["dnn_loss"] = dnn_loss.detach()
        del pred, dnn_loss
        opts["dnn"].step(dnn_grads)
        grads = {"d": d_grads, "g": g_grads, "dnn": dnn_grads}
        if out["first_grads"] is None:
            out["first_grads"] = grads
            out["first_weights"] = {m: {k: t.detach().clone()
                                        for k, t in ws.items()}
                                    for m, ws in w.items()}
        out["grad_norms"].append({m: {k: float(t.norm()) if t.device.type
                                      != "meta" else 0.0
                                      for k, t in named.items()}
                                  for m, named in grads.items()})
        out["losses"].append({k: float(v) if v.device.type != "meta"
                              else float("nan") for k, v in losses.items()})
    out["weights"] = {m: {k: t.detach() for k, t in ws.items()}
                      for m, ws in w.items()}
    return out

