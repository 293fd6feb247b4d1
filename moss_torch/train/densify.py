"""Motion-aware densification in the fixed-capacity arena (port of moss_tpu/train/densify.py).

One round is masked tensor work plus scatters into free slots, slot for slot
as in the JAX package, so a cloud and its Adam moments compare between the
two packages row by row:

  1. Fisher rotation / scale fields: SVD of the window-averaged joint Fisher
     matrices with the det-sign fix, splatted per Gaussian through the
     window's blend weights; the root joint is an all-ones 3x3 and scale.
  2. clone: grad >= tau, small, KL to the nearest neighbour > kl_threshold
     and the curvature mask; the child is drawn from N(0, scl * scale),
     rotated by rot @ R, its scale times scl, its quaternion quat(rot) * q
     (elementwise, as the reference).
  3. split: grad >= tau, large, KL > kl_threshold; two children with
     scale / 1.6; the parent is pruned only if both children landed.
  4. merge: grad >= tau, small, KL < kl_merge_threshold, the partner not a
     split parent of this round; both sources pruned.
  5. prune: opacity < min_opacity, the screen and world size (when asked),
     and a Gaussian farther than 5 cm (euclidean) from the big-pose SMPL body.
  6. the reference's 45,695-point cap gates each op on the current count.

Neighbours, KL and curvature come from one k=5 kNN pass on the pre-clone
cloud (moss_tpu's one-pass approximation). Capacity-forced drops are counted
in stats["dropped_capacity"]. Appended slots get zeroed Adam moments;
surviving rows keep theirs in place.

The Gaussian noise is an input: `noise` is (3, P, 3), the clone's draw and
the two split children's ((2, P, 3) for the static round), so a caller can
replay any stream. `normals=None` computes pca_normals; given, they replace
it. Nothing here syncs with the host: the stats are 0-d tensors, and
stats["masks"] the round's masks.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..config import OptimConfig
from ..models.gaussians import FIELDS, GaussianParams, GaussianState, get_scaling, initial_state
from ..ops.knn import knn
from ..ops.transforms import quat_to_rotmat, rotmat_to_quat
from .optim import AdamState

POINT_CAP = 45695  # the reference's cap (gaussian_model.py:496)
# pca_normals solves its 3x3 eigenproblems in batches of this many: cuSOLVER's
# batched eigensolver (torch 2.11, CUDA 12.8, H100) refuses a batch of the
# 46,080 capacity (CUSOLVER_STATUS_INVALID_VALUE from its buffer-size query)
EIGH_BATCH = 4096


def kl_div_gaussians(mu0, q0, s0, mu1, q1, s1):
    """Closed-form KL(N0 || N1) of anisotropic Gaussians: mu (N, 3), q (N, 4)
    unnormalized quaternions, s (N, 3) activated scales."""
    R0 = quat_to_rotmat(q0)
    L0 = R0 * s0[..., None, :]
    cov0 = L0 @ L0.transpose(-1, -2)
    R1 = quat_to_rotmat(q1)
    L1i = R1 * (1.0 / s1)[..., None, :]
    cov1_inv = L1i @ L1i.transpose(-1, -2)
    prod = cov1_inv @ cov0
    tr = prod[..., 0, 0] + prod[..., 1, 1] + prod[..., 2, 2]
    d = mu1 - mu0
    maha = torch.einsum("ni,nij,nj->n", d, cov1_inv, d)
    logdet = torch.log(torch.prod((s1 / s0) ** 2, dim=-1) + 1e-20)
    return 0.5 * (tr + maha + logdet - 3.0)


def pca_normals(xyz, nbr_idx):
    """Unit normals: the smallest principal axis of each k-NN patch. Their
    sign is the eigensolver's (moss_tpu does not canonicalize it either)."""
    nbrs = xyz[nbr_idx.long()]  # (P, k, 3)
    d = nbrs - nbrs.mean(dim=1, keepdim=True)
    cov = torch.einsum("pki,pkj->pij", d, d) / nbr_idx.shape[1]
    cov = cov + 1e-12 * torch.eye(3, device=xyz.device)
    return torch.cat([torch.linalg.eigh(c)[1][..., 0] for c in cov.split(EIGH_BATCH)])


def angle_change_mask(xyz, normals, nbr_idx, angle_threshold=0.1, dist_threshold=0.05):
    """The reference's compute_angle_change_rate, vectorized: over each
    point's 10 neighbour pairs, normal angle against distance (pairs closer
    than dist_threshold dropped), sorted by distance, the mean of
    d(angle) / d(distance) above angle_threshold. Fewer than 2 usable pairs
    give False."""
    k = nbr_idx.shape[1]
    pairs = [(i, j) for i in range(k) for j in range(i + 1, k)]
    ii = torch.tensor([p[0] for p in pairs], device=xyz.device)
    jj = torch.tensor([p[1] for p in pairs], device=xyz.device)
    idx = nbr_idx.long()
    npos, nnorm = xyz[idx], normals[idx]  # (P, k, 3)
    d = torch.linalg.norm(npos[:, ii] - npos[:, jj], dim=-1)  # (P, 10)
    cosang = torch.sum(nnorm[:, ii] * nnorm[:, jj], dim=-1)
    cosang = torch.clamp(
        cosang / (torch.linalg.norm(nnorm[:, ii], dim=-1)
                  * torch.linalg.norm(nnorm[:, jj], dim=-1) + 1e-12), -1.0, 1.0)
    ang = torch.arccos(cosang)
    ok = d >= dist_threshold
    d_sort = torch.where(ok, d, float("inf"))
    order = torch.argsort(d_sort, dim=1, stable=True)
    d_s = torch.take_along_dim(d_sort, order, dim=1)
    a_s = torch.take_along_dim(ang, order, dim=1)
    ok_s = torch.take_along_dim(ok, order, dim=1)
    both = ok_s[:, :-1] & ok_s[:, 1:]
    dd = d_s[:, 1:] - d_s[:, :-1]
    da = a_s[:, 1:] - a_s[:, :-1]
    rate = torch.where(both, da / torch.where(torch.abs(dd) > 1e-12, dd, 1e-12), 0.0)
    cnt = torch.sum(both, dim=1)
    mean_rate = torch.sum(rate, dim=1) / torch.clamp_min(cnt, 1)
    return (cnt > 0) & (mean_rate > angle_threshold)


def _append_rows(params: GaussianParams, valid, cand: Dict, cand_mask):
    """Scatter candidate rows (one per slot) into free slots, lowest free
    slot first, candidates in slot order.

    Returns (params, valid, dest, ok, dropped): ok marks the candidates that
    landed, dest their slot (P = the drop row), dropped how many did not fit.
    """
    P = valid.shape[0]
    free_order = torch.argsort(valid.to(torch.int32), stable=True)  # free slots first
    rank = torch.cumsum(cand_mask.to(torch.int64), 0) - 1
    n_free = P - torch.sum(valid.to(torch.int64))
    ok = cand_mask & (rank < n_free)
    dest = torch.where(ok, free_order[torch.clamp(rank, 0, P - 1)], P)

    def scatter(field, new_vals):
        ext = torch.cat([field, field.new_zeros((1,) + field.shape[1:])])
        ext[dest] = new_vals  # only the drop row P is written twice
        return ext[:P]

    new_params = GaussianParams(**{f: scatter(getattr(params, f), cand[f]) for f in FIELDS})
    valid_ext = torch.cat([valid, valid.new_zeros((1,))])
    valid_ext[dest] = True
    dropped = torch.sum(cand_mask.to(torch.int32)) - torch.sum(ok.to(torch.int32))
    return new_params, valid_ext[:P], dest, ok, dropped


def _zero_opt_rows(opt_state: Dict[str, AdamState], dest, capacity: int):
    """Zero the Adam moments at the appended slots dest: every moment tensor
    whose leading dimension is the capacity."""
    hit = torch.zeros((capacity + 1,), dtype=torch.bool, device=dest.device)
    hit[dest] = True
    hit = hit[:capacity]

    def fix(t):
        if t.ndim >= 1 and t.shape[0] == capacity:
            return torch.where(hit.view((-1,) + (1,) * (t.ndim - 1)), 0.0, t)
        return t

    return {g: AdamState(s.count, {n: fix(t) for n, t in s.mu.items()},
                         {n: fix(t) for n, t in s.nu.items()})
            for g, s in opt_state.items()}


def _cand(params: GaussianParams, **over) -> Dict:
    return {**{f: getattr(params, f) for f in FIELDS}, **over}


def _mean_grads(gstate: GaussianState):
    valid = gstate.valid
    grads = gstate.xyz_grad_accum / torch.clamp_min(gstate.denom, 1e-8)
    return torch.where(torch.isnan(grads) | ~valid, 0.0, grads)


@torch.no_grad()
def densify_and_prune_static(params: GaussianParams, gstate: GaussianState,
                             opt_state: Dict[str, AdamState], noise, cfg: OptimConfig,
                             extent: float, use_size_threshold: bool):
    """Vanilla 3DGS densification for static scenes: clone copies small
    high-grad points, split draws 2 children from N(0, scale) rotated into
    the parent's frame with scale / 1.6; prune by opacity and, when asked,
    screen and world size. No KL, Fisher fields, merge or SMPL shell.
    noise: (2, P, 3). Returns (params, gstate, opt_state, stats); stats["masks"]
    holds the clone, split and prune masks."""
    P = params.capacity
    valid = gstate.valid
    grads = _mean_grads(gstate)
    scaling = get_scaling(params)
    max_scale = torch.amax(scaling, dim=-1)
    grad_hit = grads >= cfg.densify_grad_threshold
    small = max_scale <= cfg.percent_dense * extent

    stats = {"count_before": torch.sum(valid.to(torch.int32))}

    clone_mask = valid & grad_hit & small
    params, valid, dest, ok, drop1 = _append_rows(params, valid, _cand(params), clone_mask)
    opt_state = _zero_opt_rows(opt_state, dest, P)
    stats["cloned"] = torch.sum(ok.to(torch.int32))

    split_mask = gstate.valid & grad_hit & ~small
    R_old = quat_to_rotmat(params.rotation)
    child_ok = split_mask
    drop_split = torch.zeros((), dtype=torch.int32, device=valid.device)
    for n in noise[:2]:
        cand = _cand(params, xyz=torch.einsum("nij,nj->ni", R_old, n * scaling) + params.xyz,
                     scaling=torch.log(torch.clamp_min(scaling / (0.8 * 2), 1e-12)))
        params, valid, dest, ok, dr = _append_rows(params, valid, cand, split_mask)
        opt_state = _zero_opt_rows(opt_state, dest, P)
        child_ok = child_ok & ok
        drop_split = drop_split + dr
    stats["split"] = torch.sum(child_ok.to(torch.int32))

    prune = torch.sigmoid(params.opacity[:, 0]) < cfg.min_opacity
    if use_size_threshold:
        prune = prune | (gstate.max_radii2d > cfg.max_screen_size)
        prune = prune | (torch.amax(get_scaling(params), dim=-1) > 0.1 * extent)
    valid = valid & ~(prune | child_ok)

    stats["count_after"] = torch.sum(valid.to(torch.int32))
    stats["dropped_capacity"] = drop1 + drop_split
    stats["masks"] = {"clone": clone_mask, "split": split_mask, "prune": prune | child_ok}
    return params, initial_state(valid), opt_state, stats


def fisher_fields(gstate: GaussianState):
    """(rot_gauss (P, 3, 3), scl_gauss (P, 3)): the window-averaged joint
    Fisher matrices' rotations (SVD, det-sign fixed) and singular values,
    blended per Gaussian by its window-averaged LBS weights."""
    P = gstate.valid.shape[0]
    dev = gstate.valid.device
    # the window normalizer: the reference's denom[0], here the max over slots
    # (slot 0 can die in the arena), as moss_tpu does
    denom0 = torch.clamp_min(torch.amax(gstate.denom), 1.0)
    joint_F = gstate.joint_F / denom0
    lbs_avg = gstate.lbs_weight_sum / denom0  # (P, 24)
    U, S, Vh = torch.linalg.svd(joint_F)
    V = Vh.transpose(-1, -2)
    detU = torch.sign(torch.linalg.det(U))
    detV = torch.sign(torch.linalg.det(V))
    U = torch.cat([U[..., :2], U[..., 2:] * detU[:, None, None]], dim=-1)
    V = torch.cat([V[..., :2], V[..., 2:] * detV[:, None, None]], dim=-1)
    rot_joint23 = U @ V.transpose(-1, -2)
    rot24 = torch.cat([torch.ones((1, 3, 3), device=dev), rot_joint23]).reshape(24, 9)
    rot_gauss = (lbs_avg @ rot24).reshape(P, 3, 3)
    scl_gauss = lbs_avg @ torch.cat([torch.ones((1, 3), device=dev), S])
    return rot_gauss, scl_gauss


def neighbours(params: GaussianParams, valid):
    """The 5 nearest live Gaussians of every slot, itself first: one kNN
    over the capacity, dead slots parked far apart and masked as refs."""
    P = params.capacity
    far = torch.where(valid[:, None], params.xyz,
                      1e6 + torch.arange(P, dtype=torch.float32, device=valid.device)[:, None])
    return knn(far, far, k=5, ref_valid=valid)[1]


@torch.no_grad()
def densify_and_prune(params: GaussianParams, gstate: GaussianState,
                      opt_state: Dict[str, AdamState], noise, cfg: OptimConfig, extent: float,
                      t_vertices, use_size_threshold: bool, normals=None):
    """One densification round (the reference's densify_and_prune).

    noise: (3, P, 3) standard normals (clone, split child 1, split child 2);
    normals: (P, 3) in place of pca_normals, or None. Returns (params, gstate,
    opt_state, stats); stats["masks"] holds the clone, split, merge and prune
    masks and the curvature mask."""
    P = params.capacity
    valid = gstate.valid
    grads = _mean_grads(gstate)
    rot_gauss, scl_gauss = fisher_fields(gstate)

    scaling = get_scaling(params)
    max_scale = torch.amax(scaling, dim=-1)
    grad_hit = grads >= cfg.densify_grad_threshold
    small = max_scale <= cfg.percent_dense * extent
    large = ~small

    # one kNN pass on the pre-clone cloud: this round's children take part
    # from the next round on (moss_tpu's one-pass approximation)
    nbr5 = neighbours(params, valid)
    nb = nbr5[:, 1].long()  # nearest live neighbour other than itself
    kl = kl_div_gaussians(params.xyz, params.rotation, scaling,
                          params.xyz[nb], params.rotation[nb], scaling[nb])
    kl_hi = kl > cfg.kl_threshold
    kl_lo = kl < cfg.kl_merge_threshold
    if normals is None:
        normals = pca_normals(params.xyz, nbr5)
    curv = angle_change_mask(params.xyz, normals, nbr5)

    count0 = torch.sum(valid.to(torch.int32))
    stats = {"count_before": count0}

    # clone
    clone_mask = valid & grad_hit & small & kl_hi & curv & (count0 <= POINT_CAP)
    samples = noise[0] * (scl_gauss * scaling)
    rots = rot_gauss @ quat_to_rotmat(params.rotation)
    cand = _cand(params, xyz=torch.einsum("nij,nj->ni", rots, samples) + params.xyz,
                 scaling=torch.log(torch.clamp_min(scaling * scl_gauss, 1e-12)),
                 rotation=rotmat_to_quat(rot_gauss) * params.rotation)
    params, valid, dest, ok, drop1 = _append_rows(params, valid, cand, clone_mask)
    opt_state = _zero_opt_rows(opt_state, dest, P)
    stats["cloned"] = torch.sum(ok.to(torch.int32))

    # split
    count1 = torch.sum(valid.to(torch.int32))
    split_mask = gstate.valid & grad_hit & large & kl_hi & (count1 <= POINT_CAP)
    R_old = quat_to_rotmat(params.rotation)
    child_ok = split_mask
    drop_split = torch.zeros((), dtype=torch.float32, device=valid.device)
    for n in noise[1:3]:
        cand = _cand(params, xyz=torch.einsum("nij,nj->ni", R_old, n * scaling) + params.xyz,
                     scaling=torch.log(torch.clamp_min(scaling / (0.8 * 2), 1e-12)))
        params, valid, dest, ok, dr = _append_rows(params, valid, cand, split_mask)
        opt_state = _zero_opt_rows(opt_state, dest, P)
        child_ok = child_ok & ok
        drop_split = drop_split + dr
    # a parent dies only if both children landed: a full arena drops them
    prune_split = child_ok
    stats["split"] = torch.sum(child_ok.to(torch.int32))

    # merge: the partner must not be a split parent of this round
    count2 = torch.sum(valid.to(torch.int32))
    merge_mask = (gstate.valid & grad_hit & small & kl_lo & (count2 <= POINT_CAP)
                  & ~prune_split[nb])
    cand = _cand(params, xyz=0.5 * (params.xyz + params.xyz[nb]),
                 f_dc=0.5 * (params.f_dc + params.f_dc[nb]),
                 f_rest=0.5 * (params.f_rest + params.f_rest[nb]),
                 scaling=torch.log(torch.clamp_min(scaling / 0.8, 1e-12)),
                 opacity=0.5 * (params.opacity + params.opacity[nb]))
    params, valid, dest, ok_m, drop_m = _append_rows(params, valid, cand, merge_mask)
    opt_state = _zero_opt_rows(opt_state, dest, P)
    # both sources of a merge that landed die (only True is written)
    prune_merge = torch.zeros((P + 1,), dtype=torch.bool, device=valid.device)
    prune_merge[torch.where(ok_m, nb, P)] = True
    prune_merge = prune_merge[:P] | ok_m
    stats["merged"] = torch.sum(ok_m.to(torch.int32))

    # prune
    prune = torch.sigmoid(params.opacity[:, 0]) < cfg.min_opacity
    if use_size_threshold:
        # moss_tpu's parity note: the reference zeroes max_radii2D before
        # this test, so it cannot fire there in a round that densified
        prune = prune | (gstate.max_radii2d > cfg.max_screen_size)
        prune = prune | (torch.amax(get_scaling(params), dim=-1) > 0.1 * extent)
    # the 5 cm shell is euclidean; knn returns squared distances
    d2, _ = knn(params.xyz, t_vertices, k=1)
    prune = prune | (torch.sqrt(d2[:, 0]) > cfg.smpl_dist_threshold)
    prune = prune | prune_split | prune_merge
    valid = valid & ~prune

    stats["count_after"] = torch.sum(valid.to(torch.int32))
    stats["dropped_capacity"] = drop1 + drop_split + drop_m
    stats["masks"] = {"clone": clone_mask, "split": split_mask, "merge": merge_mask,
                      "prune": prune, "curv": curv}
    return params, initial_state(valid), opt_state, stats
