"""The terms of the discriminative (contrastive) loss on torch tensors.

Counterpart of ``torch_em_tpu/loss/contrastive_impl.py`` (torch-em's
``loss/contrastive_impl.py``). Every instance reduction is padded to a fixed
``max_instances`` slots, as in the JAX package, with empty slots masked out;
``EPS`` sits inside every square root, so a zero distance (a single-pixel
instance) has a finite gradient.

Two points where plain torch would differ from the JAX package:

- ids outside ``[0, max_instances)``: ``jax.ops.segment_sum`` drops them
  from the sums and counts, and JAX's gather ``means[target]`` wraps a
  negative index once and clamps the rest. ``index_add_`` and indexing
  would raise a device-side assert on the card instead. Here the sums come
  from a one-hot product, in which such an id matches no slot, and the
  gathers read at ``gather_index(target)``, which wraps and clamps as JAX
  does.
- repeatability and speed: ``index_add_`` on the card adds floats with
  atomics, in an order that changes from run to run, and the backward of
  an indexing gather (``means[target]``) sorts the P indices (on the card
  it took 88 of the SPOCO loss's 105 ms at batch 8 of 256x256). The
  one-hot ``(M, P) @ (P, E)`` product (torch-em's "expand" implementation)
  sums in a fixed order, and the gather is the transposed product, so the
  loss and its gradient are bitwise repeatable on one card. The products
  select exactly as long as float32 matmuls keep full precision (PyTorch's
  default; ``torch.set_float32_matmul_precision("high")`` would round the
  embeddings to TF32).
"""

from typing import Tuple

import torch

__all__ = [
    "EPS", "gather_index", "one_hot", "gather", "compute_cluster_means", "compute_variance_term",
    "compute_distance_term", "compute_regularizer_term", "compute_unlabeled_push",
]

EPS = 1e-7


def gather_index(target: torch.Tensor, max_instances: int) -> torch.Tensor:
    """The slot JAX's gather reads for each id: a negative id wraps once, then all clamp."""
    target = target.long()
    return torch.where(target < 0, target + max_instances, target).clamp(0, max_instances - 1)


def one_hot(target: torch.Tensor, max_instances: int, dtype=torch.float32) -> torch.Tensor:
    """(M, P) membership of each pixel's id in each slot; ids outside [0, M) are in none."""
    slots = torch.arange(max_instances, device=target.device)
    return (target.reshape(1, -1).long() == slots[:, None]).to(dtype)


def gather(values: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """``values[gather_index(target)]`` for (M, K) values: (*spatial, K), as a one-hot product."""
    select = one_hot(gather_index(target, values.shape[0]), values.shape[0], values.dtype)  # (M, P)
    return (select.T @ values).reshape(tuple(target.shape) + tuple(values.shape[1:]))


def compute_cluster_means(embeddings: torch.Tensor, target: torch.Tensor, max_instances: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean embedding per instance id.

    embeddings: (E, *spatial); target: (*spatial) integer ids.
    Returns (means (M, E), counts (M,)).
    """
    e = embeddings.shape[0]
    feat = embeddings.reshape(e, -1).T  # (P, E)
    members = one_hot(target, max_instances, feat.dtype)  # (M, P)
    sums = members @ feat
    counts = members.sum(dim=1)
    means = sums / counts[:, None].clamp(min=1.0)
    return means, counts


def compute_variance_term(cluster_means, embeddings, target, counts, delta_var,
                          ignore_zero_label: bool = False):
    """Intra-cluster pull force (torch-em ``_compute_variance_term_scatter``)."""
    gathered = gather(torch.cat([cluster_means, counts[:, None]], dim=1), target)
    means_spatial, counts_spatial = gathered[..., :-1], gathered[..., -1]  # (*spatial, E), (*spatial)
    emb_spatial = torch.movedim(embeddings, 0, -1)                       # (*spatial, E)
    variance = torch.sqrt(torch.sum(torch.square(emb_spatial - means_spatial), dim=-1) + EPS)
    if ignore_zero_label:
        variance = variance * (target != 0)
    variance = torch.clamp(variance - delta_var, min=0) ** 2
    n_instances = torch.sum(counts > 0)
    if ignore_zero_label:
        n_instances = torch.clamp(n_instances - (counts[0] > 0).long(), min=1)
    per_pixel = variance / counts_spatial.clamp(min=1.0)
    return torch.sum(per_pixel) / n_instances.clamp(min=1)


def compute_distance_term(cluster_means, counts, delta_dist, ignore_zero_label: bool = False):
    """Inter-cluster push force (torch-em ``_compute_distance_term_scatter``)."""
    exists = counts > 0
    if ignore_zero_label:
        exists = torch.cat([torch.zeros_like(exists[:1]), exists[1:]])
    n = torch.sum(exists)
    diff = cluster_means[:, None, :] - cluster_means[None, :, :]
    dist = torch.sqrt(torch.sum(diff ** 2, dim=-1) + EPS)
    m = cluster_means.shape[0]
    eye = torch.eye(m, dtype=torch.bool, device=cluster_means.device)
    pair_mask = exists[:, None] & exists[None, :] & ~eye
    hinged = torch.clamp(2 * delta_dist - dist, min=0) ** 2
    hinged = torch.where(pair_mask, hinged, torch.zeros_like(hinged))
    denom = torch.clamp(n * (n - 1), min=1)
    return torch.where(n > 1, torch.sum(hinged) / denom, torch.zeros_like(hinged[0, 0]))


def compute_regularizer_term(cluster_means, counts):
    """Pull-to-origin regularizer (torch-em ``_scatter_impl_batch``)."""
    exists = counts > 0
    norms = torch.sqrt(torch.sum(torch.square(cluster_means), dim=1) + EPS) * exists
    return torch.sum(norms) / torch.sum(exists).clamp(min=1)


def compute_unlabeled_push(cluster_means, embeddings, target, counts, delta_dist):
    """Background push force (torch-em ``spoco_loss.py``): pushes background-pixel
    embeddings away from all foreground cluster means."""
    emb_spatial = torch.movedim(embeddings, 0, -1)  # (*spatial, E)
    background_mask = target == 0
    n_background = torch.sum(background_mask)
    exists = counts > 0
    exists = torch.cat([torch.zeros_like(exists[:1]), exists[1:]])
    n_instances = torch.sum(exists)
    lead = (None,) * target.ndim
    # distance of every pixel to every slot's mean: (*spatial, M)
    dist = torch.sqrt(torch.sum(torch.square(emb_spatial[..., None, :] - cluster_means[lead]), dim=-1) + EPS)
    hinged = torch.clamp((delta_dist - dist) * background_mask[..., None], min=0) ** 2
    hinged = hinged * exists[lead]
    push = torch.sum(hinged) / n_background.clamp(min=1)
    return torch.where(n_instances > 0, push / n_instances.clamp(min=1), torch.zeros_like(push))
