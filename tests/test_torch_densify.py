"""The port's densification against moss_tpu's, on the CPU from numpy inputs.

  * Counterparts of tests/test_densify.py: KL against an independent numpy
    transcription and zero for identical Gaussians; appends that fill free
    slots and drop the overflow; plane normals and the angle mask; the 5 cm
    euclidean SMPL shell; capacity; split parents surviving a full arena.
  * rotmat_to_quat and reset_opacity against moss_tpu.
  * pca_normals against moss_tpu up to sign (|cos| >= 1 - 1e-5): the two
    eigensolvers pick opposite signs on some patches, and moss_tpu does not
    canonicalize them, so the port does not either. angle_change_mask is
    exact when both sides get the same normals.
  * One whole round of densify_and_prune (a 2,000-Gaussian cloud around a
    synthetic body, in a roomy and in a tight capacity) and of
    densify_and_prune_static, with moss_tpu's noise and moss_tpu's normals
    fed in: kNN indices exact, the clone / split / merge / curvature masks
    exact against masks built from moss_tpu's own functions, valid exact,
    every param and Adam moment slot for slot at atol 1e-5, stats exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moss_tpu.config import OptimConfig as JOptimConfig
from moss_tpu.data.synthetic import make_scene as jax_make_scene
from moss_tpu.models import gaussians as JG
from moss_tpu.ops import transforms as JT
from moss_tpu.ops.knn import knn as jax_knn
from moss_tpu.train import densify as JD
from moss_torch import config, convert
from moss_torch.models import gaussians as G
from moss_torch.ops import transforms as T
from moss_torch.ops.knn import knn
from moss_torch.train import densify as D
from moss_torch.train.optim import AdamState
from test_densify import numpy_kl
from _torch_threads import two_torch_threads  # noqa: F401

CPU = "cpu"
ATOL = 1e-5


def t(x, dtype=np.float32):
    return torch.as_tensor(np.array(x, dtype=dtype))


def port_cfg(jopt):
    return config.OptimConfig(**{f.name: getattr(jopt, f.name)
                                 for f in dataclasses.fields(config.OptimConfig)})


def jax_densify_noise(key, P, static=False):
    """moss_tpu's densify draws for one round's key (densify.py:219-223,
    :336-361): split(key, 3 or 4), one normal((P, 3)) per child."""
    keys = jax.random.split(key, 3 if static else 4)[:-1]
    return np.stack([np.asarray(jax.random.normal(k, (P, 3))) for k in keys])


@jax.jit
def jax_normals(xyz, valid):
    """moss_tpu's kNN at k=5 and pca_normals as densify_and_prune runs them."""
    P = xyz.shape[0]
    far = jnp.where(valid[:, None], xyz, 1e6 + jnp.arange(P, dtype=jnp.float32)[:, None])
    _, nbr5 = jax_knn(far, far, k=5, ref_valid=valid)
    return JD.pca_normals(xyz, nbr5), nbr5


# ---- counterparts of tests/test_densify.py -----------------------------------

def test_kl_matches_numpy(rng):
    n = 20
    mu0 = rng.normal(size=(n, 3)).astype(np.float32)
    mu1 = mu0 + rng.normal(0, 0.1, (n, 3)).astype(np.float32)
    q0 = rng.normal(size=(n, 4)).astype(np.float32)
    q1 = rng.normal(size=(n, 4)).astype(np.float32)
    s0 = rng.uniform(0.5, 2, (n, 3)).astype(np.float32)
    s1 = rng.uniform(0.5, 2, (n, 3)).astype(np.float32)
    out = D.kl_div_gaussians(*(t(x) for x in (mu0, q0, s0, mu1, q1, s1))).numpy()
    for i in range(n):
        ref = numpy_kl(mu0[i], q0[i], s0[i], mu1[i], q1[i], s1[i])
        np.testing.assert_allclose(out[i], ref, rtol=1e-3, atol=1e-4)
    ref_jax = JD.kl_div_gaussians(*(jnp.asarray(x) for x in (mu0, q0, s0, mu1, q1, s1)))
    np.testing.assert_allclose(out, np.asarray(ref_jax), rtol=1e-5, atol=1e-5)


def test_kl_of_identical_gaussians_is_zero(rng):
    mu = rng.normal(size=(5, 3)).astype(np.float32)
    q = rng.normal(size=(5, 4)).astype(np.float32)
    s = rng.uniform(0.5, 2, (5, 3)).astype(np.float32)
    out = D.kl_div_gaussians(*(t(x) for x in (mu, q, s, mu, q, s)))
    np.testing.assert_allclose(out.numpy(), 0.0, atol=1e-4)


def test_append_fills_free_slots_and_drops_overflow():
    P = 16
    params = G.GaussianParams(
        xyz=torch.zeros((P, 3)), f_dc=torch.zeros((P, 1, 3)), f_rest=torch.zeros((P, 15, 3)),
        scaling=torch.zeros((P, 3)), rotation=torch.zeros((P, 4)), opacity=torch.zeros((P, 1)))
    valid = torch.tensor([True] * 12 + [False] * 4)
    cand = {"xyz": torch.ones((P, 3)) * torch.arange(P)[:, None], "f_dc": torch.ones((P, 1, 3)),
            "f_rest": torch.ones((P, 15, 3)), "scaling": torch.ones((P, 3)),
            "rotation": torch.ones((P, 4)), "opacity": torch.ones((P, 1))}
    # 6 candidates for 4 free slots: 2 dropped
    cand_mask = torch.tensor([True] * 6 + [False] * 10)
    new_params, new_valid, dest, ok, dropped = D._append_rows(params, valid, cand, cand_mask)
    assert int(dropped) == 2
    assert int(new_valid.sum()) == 16
    assert sorted(new_params.xyz[12:, 0].tolist()) == [0.0, 1.0, 2.0, 3.0]
    assert dest.tolist() == [12, 13, 14, 15] + [P] * 12
    assert ok.tolist() == [True] * 4 + [False] * 12


def test_append_takes_free_slots_in_order_as_moss_tpu(rng):
    """Scattered free slots and candidates: the same slots, rows and drops."""
    P = 64
    valid = rng.uniform(size=P) < 0.6
    mask = rng.uniform(size=P) < 0.5
    fields = {f: rng.normal(size=(P,) + s).astype(np.float32)
              for f, s in (("xyz", (3,)), ("f_dc", (1, 3)), ("f_rest", (3, 3)),
                           ("scaling", (3,)), ("rotation", (4,)), ("opacity", (1,)))}
    cand = {f: v + 10.0 for f, v in fields.items()}
    jp, jv, jdest, jok, jdrop = JD._append_rows(
        JG.GaussianParams(**{f: jnp.asarray(v) for f, v in fields.items()}), jnp.asarray(valid),
        {f: jnp.asarray(v) for f, v in cand.items()}, jnp.asarray(mask))
    p, v, dest, ok, drop = D._append_rows(
        G.GaussianParams(**{f: t(x) for f, x in fields.items()}), torch.as_tensor(valid),
        {f: t(x) for f, x in cand.items()}, torch.as_tensor(mask))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(dest.numpy(), np.asarray(jdest))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert int(drop) == int(jdrop) > 0
    for f in G.FIELDS:
        np.testing.assert_array_equal(getattr(p, f).numpy(), np.asarray(getattr(jp, f)))


def test_plane_normals(rng):
    pts = np.concatenate([rng.uniform(-1, 1, (100, 2)), np.zeros((100, 1))],
                         axis=1).astype(np.float32)
    _, idx = knn(t(pts), t(pts), k=5)
    nz = np.abs(D.pca_normals(t(pts), idx).numpy()[:, 2])
    assert (nz > 0.99).mean() > 0.95


def test_angle_mask_of_a_flat_sheet(rng):
    flat = np.concatenate([rng.uniform(-1, 1, (200, 2)), np.zeros((200, 1))],
                          axis=1).astype(np.float32)
    _, idx = knn(t(flat), t(flat), k=5)
    mask = D.angle_change_mask(t(flat), D.pca_normals(t(flat), idx), idx)
    assert float(mask.float().mean()) < 0.2


def _adam(params, rng=None):
    """{group: AdamState} over the six Gaussian fields: zeros, or random
    moments (count 7) drawn from rng."""
    out = {}
    for f in G.FIELDS:
        x = getattr(params, f)
        mu = torch.zeros_like(x) if rng is None else t(rng.normal(size=x.shape))
        nu = torch.zeros_like(x) if rng is None else t(rng.uniform(0.1, 1.0, x.shape))
        out[f] = AdamState(0 if rng is None else 7, {f: mu}, {f: nu})
    return out


def _stats_state(gstate, P, fill=10.0):
    return dataclasses.replace(
        gstate, xyz_grad_accum=torch.full((P,), fill), denom=torch.full((P,), fill),
        joint_F=torch.eye(3).repeat(23, 1, 1) * 5.0, lbs_weight_sum=torch.ones((P, 24)) * 10.0)


def test_euclidean_5cm_smpl_shell(rng):
    P = 64
    t_verts = np.stack([np.linspace(-1, 1, 50), np.zeros(50), np.zeros(50)],
                       axis=1).astype(np.float32)
    offsets = np.array([0.00, 0.02, 0.04, 0.049, 0.051, 0.06, 0.10, 0.22])
    pts = np.zeros((len(offsets), 3), np.float32)
    vidx = np.linspace(5, 44, len(offsets)).round().astype(int)
    pts[:, 0] = t_verts[vidx, 0]
    pts[:, 2] = offsets
    params, valid = G.create_from_points(pts, rng.uniform(size=(len(offsets), 3)), P, device=CPU)
    cfg = config.OptimConfig(densify_grad_threshold=1e9)  # no clone / split / merge
    _, gstate, _, _ = D.densify_and_prune(
        params, G.initial_state(valid), _adam(params), torch.zeros((3, P, 3)), cfg, 1.0,
        t(t_verts), False)
    survived = gstate.valid[:len(offsets)].numpy()
    np.testing.assert_array_equal(survived, offsets <= 0.05)


def test_round_respects_capacity_and_resets_stats(rng):
    P = 256
    pts = rng.normal(0, 0.3, (200, 3)).astype(np.float32)
    params, valid = G.create_from_points(pts, rng.uniform(size=(200, 3)), P, device=CPU)
    gstate = _stats_state(G.initial_state(valid), P)
    cfg = config.OptimConfig(smpl_dist_threshold=10.0)
    noise = torch.randn((3, P, 3), generator=torch.Generator().manual_seed(0))
    out_params, out_state, _, stats = D.densify_and_prune(
        params, gstate, _adam(params), noise, cfg, 1.0, t(pts), False)
    assert int(out_state.num_valid) <= P
    assert bool(torch.isfinite(out_params.xyz).all())
    assert float(out_state.xyz_grad_accum.sum()) == 0.0 and float(out_state.denom.sum()) == 0.0
    assert int(stats["count_after"]) == int(out_state.num_valid)


def test_split_parents_survive_a_full_arena(rng):
    P = 64
    pts = rng.normal(0, 0.3, (P, 3)).astype(np.float32)  # the arena is full
    params, valid = G.create_from_points(pts, rng.uniform(size=(P, 3)), P, device=CPU)
    params = dataclasses.replace(params, scaling=torch.full((P, 3), float(np.log(10.0))))
    gstate = _stats_state(G.initial_state(valid), P)
    cfg = config.OptimConfig(smpl_dist_threshold=1e9, kl_threshold=-1.0, kl_merge_threshold=-2.0)
    _, out_state, _, stats = D.densify_and_prune(
        params, gstate, _adam(params), torch.zeros((3, P, 3)), cfg, 100.0, t(pts), False)
    assert int(stats["split"]) == 0
    assert int(stats["dropped_capacity"]) > 0
    assert int(out_state.num_valid) == P


# ---- helpers against moss_tpu ------------------------------------------------

def test_rotmat_to_quat_matches_moss_tpu(rng):
    # rotations, and the non-orthogonal blends of them the clone feeds it
    q = rng.normal(size=(200, 4)).astype(np.float32)
    R = np.asarray(JT.quat_to_rotmat(jnp.asarray(q)))
    w = rng.dirichlet(np.ones(3), size=200).astype(np.float32)
    mixed = np.einsum("nk,nkij->nij", w, np.stack([R, R[::-1], np.roll(R, 7, 0)], 1))
    for m in (R, mixed, np.zeros((4, 3, 3), np.float32)):
        np.testing.assert_allclose(T.rotmat_to_quat(t(m)).numpy(),
                                   np.asarray(JT.rotmat_to_quat(jnp.asarray(m))), atol=1e-6)


def test_reset_opacity_matches_moss_tpu(rng):
    P = 50
    fields = {f: rng.normal(0, 3, (P,) + s).astype(np.float32)
              for f, s in (("xyz", (3,)), ("f_dc", (1, 3)), ("f_rest", (3, 3)),
                           ("scaling", (3,)), ("rotation", (4,)), ("opacity", (1,)))}
    out = G.reset_opacity(G.GaussianParams(**{f: t(v) for f, v in fields.items()}))
    ref = JG.reset_opacity(JG.GaussianParams(**{f: jnp.asarray(v) for f, v in fields.items()}))
    np.testing.assert_allclose(out.opacity.numpy(), np.asarray(ref.opacity), rtol=1e-6, atol=1e-6)
    assert float(torch.sigmoid(out.opacity).max()) <= 0.01 + 1e-7
    for f in G.FIELDS[:-1]:
        assert torch.equal(getattr(out, f), t(fields[f]))


# ---- whole rounds -------------------------------------------------------------

N_LIVE = 2000


def make_world():
    """A 2,000-Gaussian cloud 1 cm around an 800-vertex synthetic body, with
    100 close twins 1.5 mm away (merge candidates) and 100 points 4-8 cm out
    (the SMPL shell), scales either side of percent_dense, some dead
    opacities, window statistics; the arena's slots and Adam moments come
    from _arena."""
    rng = np.random.default_rng(5)
    verts = np.asarray(jax_make_scene(n_verts=800).big_pose_vertices)
    pts = verts[rng.integers(0, len(verts), N_LIVE)] + rng.normal(0, 0.01, (N_LIVE, 3))
    d = rng.normal(size=(200, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts[1800:1900] = pts[:100] + d[:100] * 0.0015
    pts[1900:] += d[100:] * rng.uniform(0.04, 0.08, (100, 1))
    log_s = rng.uniform(np.log(0.002), np.log(0.03), (N_LIVE, 3))
    log_s[:100] = rng.uniform(np.log(0.006), np.log(0.0095), (100, 3))
    rot = rng.normal(size=(N_LIVE, 4))
    log_s[1800:1900], rot[1800:1900] = log_s[:100], rot[:100]
    opacity = rng.normal(0, 2, (N_LIVE, 1))
    opacity[rng.uniform(size=N_LIVE) < 0.03] = -7.0
    denom = rng.integers(0, 11, N_LIVE).astype(np.float64)
    accum = rng.uniform(0, 4e-4, N_LIVE) * denom
    from scipy.spatial.transform import Rotation
    joint_F = sum(Rotation.random(23, random_state=s).as_matrix() for s in range(10))
    lbs = rng.dirichlet(np.full(24, 0.3), N_LIVE) * 10.0
    return dict(verts=verts, pts=pts, log_s=log_s, rot=rot, opacity=opacity, denom=denom,
                accum=accum, joint_F=joint_F, lbs=lbs,
                f_dc=rng.normal(size=(N_LIVE, 1, 3)), f_rest=rng.normal(size=(N_LIVE, 15, 3)),
                radii=rng.uniform(0, 40, N_LIVE), seed=int(rng.integers(1 << 30)))


@pytest.fixture(scope="module")
def world():
    return make_world()


def _arena(world, P):
    """numpy (fields, gstate dict, moments) with the cloud in scattered slots of P."""
    rng = np.random.default_rng(world["seed"] + P)
    slots = np.sort(rng.permutation(P)[:N_LIVE])
    live = {"xyz": world["pts"], "f_dc": world["f_dc"], "f_rest": world["f_rest"],
            "scaling": world["log_s"], "rotation": world["rot"], "opacity": world["opacity"]}
    dead = {"xyz": np.array([0.0, 0.0, -1e6]), "f_dc": 0.0, "f_rest": 0.0, "scaling": -10.0,
            "rotation": np.array([1.0, 0, 0, 0]), "opacity": -15.0}
    fields = {}
    for f, v in live.items():
        a = np.empty((P,) + v.shape[1:], np.float32)
        a[...] = dead[f]
        a[slots] = v
        fields[f] = a
    valid = np.zeros(P, bool)
    valid[slots] = True

    def per_slot(v, width=None):
        a = np.zeros((P,) if width is None else (P, width), np.float32)
        a[slots] = v
        return a

    gs = {"valid": valid, "max_radii2d": per_slot(world["radii"]),
          "xyz_grad_accum": per_slot(world["accum"]), "denom": per_slot(world["denom"]),
          "joint_F": world["joint_F"].astype(np.float32),
          "lbs_weight_sum": per_slot(world["lbs"], 24)}
    moments = {f: (rng.normal(size=v.shape).astype(np.float32),
                   rng.uniform(0.1, 1.0, v.shape).astype(np.float32))
               for f, v in fields.items()}
    return fields, gs, moments


def _jax_inputs(fields, gs, moments):
    params = JG.GaussianParams(**{f: jnp.asarray(v) for f, v in fields.items()})
    gstate = JG.GaussianState(**{k: jnp.asarray(v) for k, v in gs.items()})
    opt = {f: {"mu": jnp.asarray(m), "nu": jnp.asarray(n), "count": jnp.int32(7)}
           for f, (m, n) in moments.items()}
    return params, gstate, opt


def _port_inputs(fields, gs, moments):
    params = G.GaussianParams(**{f: t(v) for f, v in fields.items()})
    gstate = convert.gstate_from_jax(gs, CPU)
    opt = {f: AdamState(7, {f: t(m)}, {f: t(n)}) for f, (m, n) in moments.items()}
    return params, gstate, opt


def _assert_round_matches(out, ref):
    params, gstate, opt, stats = out
    jparams, jgstate, jopt, jstats = ref
    np.testing.assert_array_equal(gstate.valid.numpy(), np.asarray(jgstate.valid))
    for f in G.FIELDS:
        np.testing.assert_allclose(getattr(params, f).numpy(), np.asarray(getattr(jparams, f)),
                                   rtol=0, atol=ATOL, err_msg=f)
        np.testing.assert_allclose(opt[f].mu[f].numpy(), np.asarray(jopt[f]["mu"]), rtol=0,
                                   atol=ATOL, err_msg=f"{f} mu")
        np.testing.assert_allclose(opt[f].nu[f].numpy(), np.asarray(jopt[f]["nu"]), rtol=0,
                                   atol=ATOL, err_msg=f"{f} nu")
        assert opt[f].count == 7
    for k in ("max_radii2d", "xyz_grad_accum", "denom", "joint_F", "lbs_weight_sum"):
        assert float(getattr(gstate, k).abs().sum()) == 0.0
    assert set(k for k in stats if k != "masks") == set(jstats)
    for k, v in jstats.items():
        assert float(stats[k]) == float(v), (k, float(stats[k]), float(v))


@pytest.mark.parametrize("P", [4096, 2100], ids=["roomy", "tight"])
def test_round_matches_moss_tpu_slot_for_slot(world, P):
    fields, gs, moments = _arena(world, P)
    jcfg = JOptimConfig()
    cfg = port_cfg(jcfg)
    key = jax.random.fold_in(jax.random.PRNGKey(3407), 20)
    jparams, jgstate, jopt = _jax_inputs(fields, gs, moments)
    verts = jnp.asarray(world["verts"])
    ref = JD.densify_and_prune(jparams, jgstate, jopt, key, jcfg, 1.0, verts, False)
    normals, nbr5 = jax_normals(jparams.xyz, jgstate.valid)

    params, gstate, opt = _port_inputs(fields, gs, moments)
    nbr = D.neighbours(params, gstate.valid)
    np.testing.assert_array_equal(nbr.numpy(), np.asarray(nbr5))
    out = D.densify_and_prune(params, gstate, opt, t(jax_densify_noise(key, P)), cfg, 1.0,
                              t(world["verts"]), False, normals=t(normals))
    _assert_round_matches(out, ref)

    # the masks against ones built from moss_tpu's own functions
    masks, stats = out[3]["masks"], out[3]
    valid = jgstate.valid
    grads = jgstate.xyz_grad_accum / jnp.maximum(jgstate.denom, 1e-8)
    grad_hit = jnp.where(jnp.isnan(grads) | ~valid, 0.0, grads) >= jcfg.densify_grad_threshold
    scaling = JG.get_scaling(jparams)
    small = jnp.max(scaling, axis=-1) <= jcfg.percent_dense
    nb = nbr5[:, 1]
    kl = JD.kl_div_gaussians(jparams.xyz, jparams.rotation, scaling, jparams.xyz[nb],
                             jparams.rotation[nb], scaling[nb])
    curv = JD.angle_change_mask(jparams.xyz, normals, nbr5)
    clone = valid & grad_hit & small & (kl > jcfg.kl_threshold) & curv
    split = valid & grad_hit & ~small & (kl > jcfg.kl_threshold)
    for name, m in (("curv", curv), ("clone", clone), ("split", split)):
        np.testing.assert_array_equal(masks[name].numpy(), np.asarray(m), err_msg=name)
    if float(stats["dropped_capacity"]) == 0:  # every child landed: child_ok is split
        merge = valid & grad_hit & small & (kl < jcfg.kl_merge_threshold) & ~split[nb]
        np.testing.assert_array_equal(masks["merge"].numpy(), np.asarray(merge))
    pruned = np.asarray(valid) & ~np.asarray(ref[1].valid)
    assert (masks["prune"].numpy()[np.asarray(valid)] == pruned[np.asarray(valid)]).all()
    if P == 4096:  # room for every child: each op and the prune fired
        assert float(stats["dropped_capacity"]) == 0
        assert min(int(stats[k]) for k in ("cloned", "split", "merged")) > 0
        assert int(stats["count_after"]) < int(stats["count_before"]) + int(stats["cloned"]) \
            + 2 * int(stats["split"]) + int(stats["merged"])
    else:  # the second split children and the merges find no slot
        assert float(stats["dropped_capacity"]) > 0


def test_static_round_matches_moss_tpu_slot_for_slot(world):
    P = 4096
    fields, gs, moments = _arena(world, P)
    jcfg = JOptimConfig()
    key = jax.random.fold_in(jax.random.PRNGKey(3407), 30)
    ref = JD.densify_and_prune_static(*_jax_inputs(fields, gs, moments), key, jcfg, 1.0, True)
    params, gstate, opt = _port_inputs(fields, gs, moments)
    out = D.densify_and_prune_static(params, gstate, opt,
                                     t(jax_densify_noise(key, P, static=True)), port_cfg(jcfg),
                                     1.0, True)
    _assert_round_matches(out, ref)
    assert min(int(out[3][k]) for k in ("cloned", "split")) > 0


def test_pca_normals_match_moss_tpu_up_to_sign(world):
    fields, gs, _ = _arena(world, 4096)
    normals, nbr5 = jax_normals(jnp.asarray(fields["xyz"]), jnp.asarray(gs["valid"]))
    ours = D.pca_normals(t(fields["xyz"]), torch.as_tensor(np.asarray(nbr5)))
    valid = gs["valid"]
    cos = np.abs(np.sum(ours.numpy() * np.asarray(normals), axis=-1))[valid]
    assert cos.min() >= 1 - 1e-5, cos.min()
