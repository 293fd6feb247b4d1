"""k-nearest-neighbour search as blocked matmuls (port of moss_tpu/ops/knn.py).

A frozen copy of moss_torch/ops/knn.py for the benchmark's reference (its
plain path only, imports pointed into benchmark.reference).

Distances use the same expanded form |q|^2 - 2 q.r + |r|^2 in f32 as the JAX
package (knn.py:59-63), so argmin ties fall the same way. Plain tensor code:
at k=1 the (chunk, M) distance block and its min are one matmul and one
reduction. For k > 1 a stable sort puts equal distances (repeated points,
invalid refs at +inf) in index order, as jax.lax.top_k does (knn.py:73);
torch.topk makes no such promise.
"""
from __future__ import annotations

import torch


def knn(queries, refs, k: int = 1, chunk: int = 4096, ref_valid=None):
    """(dists2 (N, k), idx (N, k) int32) of the k nearest refs per query.

    dists2 are squared euclidean distances; invalid refs (ref_valid False)
    are pushed to +inf.
    """
    r2 = torch.sum(refs * refs, dim=-1)  # (M,)
    if ref_valid is not None:
        r2 = r2 + torch.where(ref_valid, 0.0, float("inf"))
    d2s, idxs = [], []
    for s in range(0, queries.shape[0], chunk):
        q = queries[s:s + chunk]
        d2 = torch.sum(q * q, dim=-1, keepdim=True) - 2.0 * (q @ refs.T) + r2[None, :]
        if k == 1:
            d, i = torch.min(d2, dim=-1, keepdim=True)
        else:
            d, i = torch.sort(d2, dim=-1, stable=True)
            # copies: a slice would keep the chunk's whole sorted block alive
            # until the cat (49 blocks of 2.4 GB for 100,000 points)
            d, i = d[:, :k].clone(), i[:, :k].clone()
        d2s.append(d)
        idxs.append(i)
    d2 = torch.clamp_min(torch.cat(d2s), 0.0)
    return d2, torch.cat(idxs).to(torch.int32)


def mean_knn_dist2(points, chunk: int = 2048, valid=None):
    """Mean squared distance to the 3 nearest neighbours (excluding self)."""
    d2, _ = knn(points, points, k=4, chunk=chunk, ref_valid=valid)
    return torch.mean(d2[:, 1:], dim=-1)
