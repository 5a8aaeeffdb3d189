"""SPOCO losses: embedding instance segmentation from sparse supervision.

Counterpart of ``torch_em_tpu/loss/spoco_loss.py`` (torch-em's
``loss/spoco_loss.py``, arXiv:2103.14572): ``ContrastiveLossBase`` with the
unlabeled push and an instance term, ``ExtendedContrastiveLoss`` (a Dice
instance term through a Gaussian kernel, and/or ``AffinitySideLoss``),
``SPOCOLoss`` (the extended loss plus the consistency of anchored
probability maps between the network and its moving average), and
``SPOCOConsistencyLoss`` (the consistency term alone). Instance reductions
use ``max_instances`` slots, as ``contrastive_impl`` does.

As in the JAX package, the reference's ``loss += loss`` accumulation (which
doubles the running sum per sample) is a plain sum here, the consistency
Dice takes the anchors as channels of one batch entry, and a sample's
background-dependent terms are computed both ways and chosen with
``torch.where``, so nothing waits for the device.

Random anchors: the JAX package draws them with ``jax.random`` inside its
jitted step, which torch cannot reproduce. Here drawing and arithmetic are
apart: ``draw_anchors`` draws flat pixel indices with ``torch.multinomial``
(``SPOCOLoss``, uniform over the unlabeled pixels) or ``torch.randint``
(``SPOCOConsistencyLoss``) on the caller's ``torch.Generator``, and the
losses take the drawn indices through ``anchors=``. ``needs_rng = True``
makes the trainer pass its generator.
"""

import math
from typing import Optional, Sequence

import torch

from . import contrastive_impl as impl
from .affinity_side_loss import AffinitySideLoss
from .dice import DiceLoss

EPS = impl.EPS

__all__ = [
    "compute_cluster_means", "GaussianKernel", "CombinedAuxLoss", "ContrastiveLossBase",
    "ExtendedContrastiveLoss", "SPOCOLoss", "SPOCOConsistencyLoss", "select_stable_anchor",
]


def compute_cluster_means(embeddings, target, n_instances):
    """Mean embedding per instance id, (n_instances, E)."""
    means, _ = impl.compute_cluster_means(embeddings, target, n_instances)
    return means


def select_stable_anchor(embeddings, mean_embedding, object_mask, delta_var, norm="fro"):
    """The anchor of an object: its mean embedding, as in the JAX package and torch-em's
    active code path."""
    return mean_embedding


class GaussianKernel:
    """Distance to instance probability: exp(-d^2 / two_sigma), with the probability
    ``pmaps_threshold`` at distance ``delta_var``."""

    def __init__(self, delta_var, pmaps_threshold):
        self.delta_var = delta_var
        self.two_sigma = delta_var * delta_var / (-math.log(pmaps_threshold))
        self.init_kwargs = {"delta_var": delta_var, "pmaps_threshold": pmaps_threshold}

    def __call__(self, dist_map):
        return torch.exp(-dist_map * dist_map / self.two_sigma)


class CombinedAuxLoss:
    """Weighted sum of auxiliary SPOCO losses."""

    def __init__(self, losses, weights):
        self.losses = losses
        self.weights = weights
        self.init_kwargs = {"losses": losses, "weights": weights}

    def __call__(self, embeddings, target, instance_pmaps, instance_masks):
        result = 0.0
        for loss, weight in zip(self.losses, self.weights):
            if isinstance(loss, AffinitySideLoss):
                result = result + weight * loss(embeddings[None], target[None, None])
            elif instance_masks is not None:
                result = result + weight * loss(instance_pmaps, instance_masks)
        return result


def _anchor_pmaps(dist_to_mask, emb, anchors):
    """Probability maps (A, *spatial) around the embeddings at the flat pixel indices ``anchors``."""
    e, spatial = emb.shape[0], emb.shape[1:]
    points = emb.reshape(e, -1)[:, anchors].T  # (A, E)
    emb_spatial = torch.movedim(emb, 0, -1)  # (*spatial, E)
    diff = emb_spatial[None] - points.reshape((-1,) + (1,) * len(spatial) + (e,))
    return dist_to_mask(torch.sqrt(torch.sum(torch.square(diff), dim=-1) + EPS))


class ContrastiveLossBase:
    """Contrastive loss with an unlabeled push and an instance term that subclasses define."""

    needs_rng = True

    def __init__(self, delta_var, delta_dist, norm="fro", alpha=1.0, beta=1.0, gamma=0.001,
                 unlabeled_push_weight=0.0, instance_term_weight=1.0, impl=None,
                 max_instances: int = 64):
        assert norm == "fro"
        self.delta_var = delta_var
        self.delta_dist = delta_dist
        self.norm = norm
        self.alpha = alpha
        self.beta = beta
        self.gamma = gamma
        self.unlabeled_push_weight = unlabeled_push_weight
        self.unlabeled_push = unlabeled_push_weight > 0
        self.instance_term_weight = instance_term_weight
        self.max_instances = max_instances

    def compute_instance_term(self, embeddings, cluster_means, counts, target):
        raise NotImplementedError

    def _single(self, embeddings, target):
        target = target.long()
        means, counts = impl.compute_cluster_means(embeddings, target, self.max_instances)

        if self.unlabeled_push:
            # both ways, chosen on the device: no host sync per sample
            contains_bg = torch.any(target == 0)
            variance_term = torch.where(
                contains_bg,
                impl.compute_variance_term(means, embeddings, target, counts, self.delta_var, True),
                impl.compute_variance_term(means, embeddings, target, counts, self.delta_var, False),
            )
            push = impl.compute_unlabeled_push(means, embeddings, target, counts, self.delta_dist)
            unlabeled_push_term = torch.where(contains_bg, push, torch.zeros_like(push))
            distance_term = torch.where(
                contains_bg,
                impl.compute_distance_term(means, counts, self.delta_dist, True),
                impl.compute_distance_term(means, counts, self.delta_dist, False),
            )
        else:
            variance_term = impl.compute_variance_term(means, embeddings, target, counts, self.delta_var, False)
            unlabeled_push_term = 0.0
            distance_term = impl.compute_distance_term(means, counts, self.delta_dist, False)

        instance_term = self.compute_instance_term(embeddings, means, counts, target)
        regularization_term = impl.compute_regularizer_term(means, counts)

        return (self.alpha * variance_term + self.beta * distance_term
                + self.gamma * regularization_term
                + self.instance_term_weight * instance_term
                + self.unlabeled_push_weight * unlabeled_push_term)

    def __call__(self, input_, target, generator: Optional[torch.Generator] = None, **unused):
        if isinstance(input_, tuple):
            assert len(input_) == 2
            input_ = input_[0]
        n_batches = input_.shape[0]
        loss = 0.0
        for b in range(n_batches):
            loss = loss + self._single(input_[b], target[b, 0])
        return loss / n_batches


class ExtendedContrastiveLoss(ContrastiveLossBase):
    """Contrastive loss with an instance term (Dice through a Gaussian kernel and/or the
    affinity side loss) and the background push."""

    def __init__(self, delta_var: float, delta_dist: float, norm: str = "fro", alpha: float = 1.0,
                 beta: float = 1.0, gamma: float = 0.001, unlabeled_push_weight: float = 1.0,
                 instance_term_weight: float = 1.0, aux_loss: str = "dice",
                 pmaps_threshold: float = 0.9, max_instances: int = 64, **kwargs):
        super().__init__(delta_var, delta_dist, norm=norm, alpha=alpha, beta=beta, gamma=gamma,
                         unlabeled_push_weight=unlabeled_push_weight,
                         instance_term_weight=instance_term_weight, max_instances=max_instances)
        assert aux_loss in ("dice", "affinity", "dice_aff")
        self.aux_loss_kind = aux_loss
        if aux_loss in ("affinity", "dice_aff"):
            self.aff_loss = AffinitySideLoss(
                delta=delta_dist,
                offset_ranges=kwargs.get("offset_ranges", [(-18, 18), (-18, 18)]),
                n_samples=kwargs.get("n_samples", 9),
            )
        else:
            self.aff_loss = None
        self.use_dice = aux_loss in ("dice", "dice_aff")
        self.dice_weight = kwargs.get("dice_weight", 1.0)
        self.aff_weight = kwargs.get("aff_weight", 1.0)
        self.dist_to_mask = GaussianKernel(delta_var=self.delta_var, pmaps_threshold=pmaps_threshold)
        self.init_kwargs = {
            "delta_var": delta_var, "delta_dist": delta_dist, "norm": norm, "alpha": alpha,
            "beta": beta, "gamma": gamma, "unlabeled_push_weight": unlabeled_push_weight,
            "instance_term_weight": instance_term_weight, "aux_loss": aux_loss,
            "pmaps_threshold": pmaps_threshold, "max_instances": max_instances,
        }
        self.init_kwargs.update(kwargs)

    def _dice_instance_term(self, embeddings, cluster_means, counts, target):
        """Mean Dice error over the foreground instances between the Gaussian map around each
        cluster mean and the instance's mask, computed for every slot and masked."""
        emb_spatial = torch.movedim(embeddings, 0, -1)  # (*spatial, E)
        means = cluster_means[(slice(None),) + (None,) * target.ndim]  # (M, 1.., E)
        dist = torch.sqrt(torch.sum(torch.square(emb_spatial[None] - means), dim=-1) + EPS)  # (M, *spatial)
        pmaps = self.dist_to_mask(dist)
        masks = impl.one_hot(target, self.max_instances, pmaps.dtype).reshape(pmaps.shape)
        axes = tuple(range(1, pmaps.ndim))
        num = torch.sum(pmaps * masks, dim=axes)
        den = torch.sum(pmaps * pmaps, dim=axes) + torch.sum(masks * masks, dim=axes)
        dice = 2 * num / den.clamp(min=1e-7)
        exists = counts > 0
        exists = torch.cat([torch.zeros_like(exists[:1]), exists[1:]])  # not the background slot
        losses = (1.0 - dice) * exists
        return torch.sum(losses) / torch.sum(exists).clamp(min=1)

    def compute_instance_term(self, embeddings, cluster_means, counts, target):
        aff_loss = None
        if self.aff_loss is not None:
            aff_loss = self.aff_loss(embeddings[None], target[None, None].float())
        dice_loss = self._dice_instance_term(embeddings, cluster_means, counts, target) \
            if self.use_dice else None
        if dice_loss is None:
            return aff_loss
        if aff_loss is None:
            return dice_loss
        return self.dice_weight * dice_loss + self.aff_weight * aff_loss


class SPOCOLoss(ExtendedContrastiveLoss):
    """The SPOCO loss: the extended contrastive loss of the network's embeddings plus the
    consistency of anchored probability maps between them and the moving average's."""

    def __init__(self, delta_var: float, delta_dist: float, norm: str = "fro", alpha: float = 1.0,
                 beta: float = 1.0, gamma: float = 0.001, unlabeled_push_weight: float = 0.0,
                 instance_term_weight: float = 1.0, consistency_term_weight: float = 1.0,
                 aux_loss: str = "dice", pmaps_threshold: float = 0.9, max_anchors: int = 20,
                 volume_threshold: float = 0.05, max_instances: int = 64, **kwargs):
        super().__init__(delta_var, delta_dist, norm=norm, alpha=alpha, beta=beta, gamma=gamma,
                         unlabeled_push_weight=unlabeled_push_weight,
                         instance_term_weight=instance_term_weight, aux_loss=aux_loss,
                         pmaps_threshold=pmaps_threshold, max_instances=max_instances, **kwargs)
        self.consistency_term_weight = consistency_term_weight
        self.max_anchors = max_anchors
        self.volume_threshold = volume_threshold
        self.consistency_loss = DiceLoss()
        self.init_kwargs = {
            "delta_var": delta_var, "delta_dist": delta_dist, "norm": norm, "alpha": alpha,
            "beta": beta, "gamma": gamma, "unlabeled_push_weight": unlabeled_push_weight,
            "instance_term_weight": instance_term_weight,
            "consistency_term_weight": consistency_term_weight, "aux_loss": aux_loss,
            "pmaps_threshold": pmaps_threshold, "max_anchors": max_anchors,
            "volume_threshold": volume_threshold, "max_instances": max_instances,
        }
        self.init_kwargs.update(kwargs)

    def draw_anchors(self, mask: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``max_anchors`` flat pixel indices drawn uniformly, with replacement, from the pixels where
        ``mask`` is nonzero. An empty mask draws from all pixels; its sample's term is then zero."""
        weights = mask.reshape(-1).float()
        weights = weights + (weights.sum() == 0).float()
        return torch.multinomial(weights, self.max_anchors, replacement=True, generator=generator)

    def emb_consistency(self, emb_q, emb_k, mask, anchors):
        """Dice between the anchored maps of the two embeddings (the second without gradient);
        zero unless the mask covers ``volume_threshold`` of the pixels."""
        flat_mask = mask.reshape(-1).float()
        q_pmaps = _anchor_pmaps(self.dist_to_mask, emb_q, anchors)
        k_pmaps = _anchor_pmaps(self.dist_to_mask, emb_k.detach(), anchors)
        loss = self.consistency_loss(q_pmaps[None], k_pmaps[None])
        enough_volume = torch.sum(flat_mask) >= self.volume_threshold * flat_mask.numel()
        return torch.where(enough_volume, loss, torch.zeros_like(loss))

    def __call__(self, input_, target, generator: Optional[torch.Generator] = None,
                 anchors: Optional[Sequence[torch.Tensor]] = None, **unused):
        """``input_`` is (embeddings, moving-average embeddings); ``anchors`` (one index tensor per
        sample) replaces the draw."""
        assert len(input_) == 2
        emb_q, emb_k = input_
        loss = super().__call__(emb_q, target)
        for b in range(emb_q.shape[0]):
            unlabeled_mask = target[b, 0] == 0
            idx = self.draw_anchors(unlabeled_mask, generator) if anchors is None else anchors[b]
            cons = self.emb_consistency(emb_q[b], emb_k[b], unlabeled_mask, idx)
            loss = loss + self.consistency_term_weight * cons
        return loss


class SPOCOConsistencyLoss:
    """The anchor consistency alone, for unlabeled images; anchors uniform over all pixels."""

    needs_rng = True

    def __init__(self, delta_var: float, pmaps_threshold: float, max_anchors: int = 30,
                 norm: str = "fro"):
        self.max_anchors = max_anchors
        self.consistency_loss = DiceLoss()
        self.norm = norm
        self.dist_to_mask = GaussianKernel(delta_var=delta_var, pmaps_threshold=pmaps_threshold)
        self.init_kwargs = {"delta_var": delta_var, "pmaps_threshold": pmaps_threshold,
                            "max_anchors": max_anchors, "norm": norm}

    def draw_anchors(self, emb: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``max_anchors`` flat pixel indices of one sample's embedding (E, *spatial)."""
        return torch.randint(0, emb[0].numel(), (self.max_anchors,), generator=generator, device=emb.device)

    def emb_consistency(self, emb_q, emb_k, anchors):
        q_pmaps = _anchor_pmaps(self.dist_to_mask, emb_q, anchors)
        k_pmaps = _anchor_pmaps(self.dist_to_mask, emb_k, anchors)
        return self.consistency_loss(q_pmaps[None], k_pmaps[None])

    def __call__(self, emb_q, emb_k, generator: Optional[torch.Generator] = None,
                 anchors: Optional[Sequence[torch.Tensor]] = None):
        loss = 0.0
        for b in range(emb_q.shape[0]):
            idx = self.draw_anchors(emb_q[b], generator) if anchors is None else anchors[b]
            loss = loss + self.emb_consistency(emb_q[b], emb_k[b], idx)
        return loss
