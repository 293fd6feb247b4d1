"""The port's training step against moss_tpu's, from one TrainState.

  * The optimizer on identical grads: moss_tpu's optax multi_transform AdamW
    with apply_reference_update_skips against the port's adamw_step with
    skipped_groups, over iterations that hit densify, opacity-reset and final
    skips, and zero_group_moments; params to rtol and atol 1e-6, moments to
    rtol 1e-6 (moments
    also atol 1e-6 of their max: the moment update cancels where g opposes mu).
  * One whole step (64x64 synthetic frames, 320-slot cloud, both MLPs, the
    six-term loss with a random LPIPS backbone at a 48x48 crop) from one
    TrainState carried across by moss_torch.convert: loss terms; grads (read
    back from moss_tpu's first-step moments, mu = (1 - b1) g) at
    tests/test_rasterize_tpu.py:150's rule (divide by max|g_ref|, atol 5e-4);
    the densify statistics; and the params, which may differ by up to 2 lr in
    slots whose grad is below that tolerance: at eps 1e-15 the first Adam step
    is lr sign(g), and a few-ulp grad near 0 can flip its sign.
  * A 10-step loss trajectory on the same scene, rtol 2e-3: the LPIPS term
    runs in bf16, which rounds at other places in the two frameworks
    (tests/test_losses_parity.py:108 allows 2e-2 on that term alone).

Both sides rasterize with the plain blend at 16x16 tiles (the port's
rasterize_cuda takes it for CPU tensors); the ground truth comes from
moss_tpu's make_frames.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from moss_tpu import config as jconfig
from moss_tpu.data.synthetic import make_frames as jax_make_frames
from moss_tpu.data.synthetic import make_scene as jax_make_scene
from moss_tpu.models import gaussians as JG
from moss_tpu.models import lbs_field as jlbs
from moss_tpu.models import pose_refine as jpose
from moss_tpu.ops import lpips_jax
from moss_tpu.ops.rasterize_ref import rasterize_reference as jax_rasterize_reference
from moss_tpu.train import optim as joptim
from moss_tpu.train.train_step import TrainState as JTrainState
from moss_tpu.train.train_step import make_train_step as jax_make_train_step
from moss_torch import config, convert
from moss_torch.models import gaussians as G
from moss_torch.train import optim
from moss_torch.train.train_step import make_train_step
from test_torch_raster_bwd import GRAD_ATOL, assert_grad_close
from _torch_threads import two_torch_threads  # noqa: F401

H = W = 64
CROP = 48
CAP = 320
CPU = "cpu"


def _port_cfg(jcfg):
    return config.Config(
        model=config.ModelConfig(sh_degree=jcfg.model.sh_degree, capacity=jcfg.model.capacity,
                                 white_background=jcfg.model.white_background),
        optim=config.OptimConfig(**{f.name: getattr(jcfg.optim, f.name)
                                    for f in dataclasses.fields(config.OptimConfig)}))


# ---- the optimizer on identical grads ---------------------------------------

SKIP_CFG = dict(iterations=10, densify_from_iter=2, densification_interval=3,
                densify_until_iter=8, opacity_reset_interval=5)


@pytest.mark.parametrize("white_background", [False, True], ids=["black_bg", "white_bg"])
def test_optimizer_on_identical_grads_matches_optax(white_background):
    rng = np.random.default_rng(2)
    jopt_cfg = jconfig.OptimConfig(**SKIP_CFG)
    n = 16
    p, _ = JG.create_from_points(rng.normal(size=(n, 3)).astype(np.float32),
                                 rng.uniform(size=(n, 3)), n)
    jparams = {"gauss": p, "mlps": {"pose": jpose.init(jax.random.PRNGKey(1)),
                                    "lbs": jlbs.init(jax.random.PRNGKey(2))}}
    optimizer = joptim.make_optimizer(jopt_cfg)
    jstate = optimizer.init(jparams)
    update = jax.jit(optimizer.update)
    params = {"gauss": convert.gaussians_from_jax(p, CPU),
              "mlps": convert.mlps_from_jax(jparams["mlps"], CPU)}
    state = optim.init_state(params)
    opt_cfg = config.OptimConfig(**SKIP_CFG)

    skipped = set()
    for it in range(1, SKIP_CFG["iterations"] + 1):
        jgrads = jax.tree.map(lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32)),
                              jparams)
        upd, new_jstate = update(jgrads, jstate, jparams)
        jparams, jstate = joptim.apply_reference_update_skips(
            jopt_cfg, white_background, it, jparams, jstate, optax.apply_updates(jparams, upd),
            new_jstate)
        grads = {g: st.mu for g, st in
                 convert.adam_states_from_jax(_as_moments(jstate, jgrads), CPU).items()}
        skip = optim.skipped_groups(opt_cfg, white_background, it)
        skipped |= skip
        state = optim.adamw_step(opt_cfg, params, grads, state, skip)
        if it == 5:  # an opacity reset zeroes the opacity moments
            jstate = joptim.zero_group_moments(jstate, "opacity")
            state = optim.zero_group_moments(state, "opacity")

        _assert_params_close(params, jparams, rtol=1e-6, atol=1e-6)
        ref = convert.adam_states_from_jax(jstate, CPU)
        for g, st in state.items():
            assert st.count == ref[g].count, (it, g)
            for name in st.mu:
                for m, m_ref, what in ((st.mu, ref[g].mu, "mu"), (st.nu, ref[g].nu, "nu")):
                    r = m_ref[name].numpy()
                    np.testing.assert_allclose(m[name].numpy(), r, rtol=1e-6,
                                               atol=1e-6 * np.abs(r).max(),
                                               err_msg=f"{it} {g}.{name} {what}")
    assert skipped == set(optim.GAUSS_GROUPS) | {"pose", "lbs"}


def _as_moments(jstate, tree):
    """`tree` laid out as moss_tpu's optimizer state (mu = nu = tree), so the
    converter that reads moments reads it group by group."""
    inner = {}
    for g, masked in jstate.inner_states.items():
        adam = masked.inner_state[0]
        inner[g] = masked._replace(inner_state=(adam._replace(mu=tree, nu=tree),)
                                   + tuple(masked.inner_state[1:]))
    return jstate._replace(inner_states=inner)


def _assert_params_close(params, jparams, rtol, atol):
    for f in G.FIELDS:
        np.testing.assert_allclose(getattr(params["gauss"], f).numpy(),
                                   np.asarray(getattr(jparams["gauss"], f)), rtol=rtol, atol=atol,
                                   err_msg=f)
    for g, module in params["mlps"].items():
        ref = convert._mlp_state(jparams["mlps"][g], g, CPU)
        for name, t in module.named_parameters():
            np.testing.assert_allclose(t.detach().numpy(), ref[name].numpy(), rtol=rtol,
                                       atol=atol, err_msg=f"{g}.{name}")


# ---- whole steps -------------------------------------------------------------

@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(17)
    jscene = jax_make_scene(n_verts=300)
    jframes, _ = jax_make_frames(jscene, n_frames=3, H=H, W=W, crop=CROP)
    verts = np.asarray(jscene.big_pose_vertices)
    n = 300
    pts = verts + rng.normal(0, 0.005, verts.shape)
    p, gstate = JG.create_from_points(pts.astype(np.float32), rng.uniform(size=(n, 3)), CAP)
    p = dataclasses.replace(p, scaling=p.scaling + jnp.asarray(
        rng.normal(0, 0.3, (CAP, 3)).astype(np.float32)),
        rotation=jnp.asarray(rng.normal(size=(CAP, 4)).astype(np.float32)))
    mlps = {"pose": jpose.init(jax.random.PRNGKey(3)), "lbs": jlbs.init(jax.random.PRNGKey(4))}
    jcfg = jconfig.Config(model=jconfig.ModelConfig(capacity=CAP, n_init_points=n))
    lp = lpips_jax.init_random(3407)
    raster = functools.partial(jax_rasterize_reference, tile_h=16, tile_w=16)
    init_fn, step_fn = jax_make_train_step(jscene, jcfg, raster, lp, CROP, CROP)
    params = {"gauss": p, "mlps": mlps}
    jts = JTrainState(params, init_fn(params), gstate, jnp.int32(0))
    scene = convert.scene_from_jax(jscene.smpl, jscene.big_pose_params,
                                   jscene.big_pose_vertices, device=CPU)
    _, step = make_train_step(scene, _port_cfg(jcfg), None,
                              convert.lpips_params_from_jax(lp, CPU), CROP, CROP, device=CPU)
    return dict(jts=jts, step_fn=step_fn, jframes=jframes, step=step,
                frames=[convert.frame_from_jax(f, CPU) for f in jframes])


def test_one_step_matches_jax(world):
    jts0 = world["jts"]
    jts1, jlogs = world["step_fn"](jts0, world["jframes"][0], 0)
    ts0 = convert.train_state_from_jax(jts0, CPU)
    step = world["step"]
    _, _, _, grads, _ = step.grads(ts0, world["frames"][0], 0)
    ts1, logs = step(ts0, world["frames"][0], 0)

    for key in ("l1", "mask", "ssim", "nll", "s3im"):
        np.testing.assert_allclose(float(logs[key]), float(jlogs[key]), rtol=1e-5, atol=2e-6,
                                   err_msg=key)
    assert abs(float(logs["lpips"]) - float(jlogs["lpips"])) < 2e-2 * float(jlogs["lpips"])

    # moss_tpu's grads, from its first-step moments mu = (1 - b1) g
    ref = convert.adam_states_from_jax(jts1.opt_state, CPU)
    got = ts1.opt_state
    for g in ref:
        assert got[g].count == ref[g].count == 1
        # an MLP parameter is scaled by its MLP's largest grad, as in
        # tests/test_torch_grads.py (the LBS value bias has a zero grad)
        scale = (None if g in optim.GAUSS_GROUPS
                 else max(float(t.abs().max()) for t in ref[g].mu.values()) / (1 - optim.B1))
        for name in ref[g].mu:
            g_ref = ref[g].mu[name].numpy() / (1 - optim.B1)
            assert_grad_close(grads[g][name].numpy(), g_ref, f"{g}.{name}", scale=scale)
            assert_grad_close(got[g].mu[name].numpy() / (1 - optim.B1), g_ref, f"{g}.{name} mu",
                              scale=scale)
            assert_grad_close(np.sqrt(got[g].nu[name].numpy() / (1 - optim.B2)), np.abs(g_ref),
                              f"{g}.{name} sqrt nu", scale=scale)

            # params: exact but for sign flips of sub-tolerance grads (2 lr)
            p_ref = (np.asarray(getattr(jts1.params["gauss"], name)) if g in optim.GAUSS_GROUPS
                     else convert._mlp_state(jts1.params["mlps"][g], g, CPU)[name].numpy())
            p = (getattr(ts1.params["gauss"], name) if g in optim.GAUSS_GROUPS
                 else dict(ts1.params["mlps"][g].named_parameters())[name]).detach().numpy()
            lr = optim.group_lr(step.cfg.optim, g, 0)
            small = np.abs(g_ref) <= GRAD_ATOL * (np.abs(g_ref).max() if scale is None else scale)
            diff = np.abs(p - p_ref)
            bad = ~small & (diff > 1e-6 * (1 + np.abs(p_ref)))
            assert not bad.any(), (g, name, diff[bad], g_ref[bad], p_ref[bad])
            assert np.all(diff[small] <= 2 * lr * 1.001 + 1e-6), name

    gs, gs_ref = ts1.gstate, convert.gstate_from_jax(jts1.gstate, CPU)
    assert float(gs.xyz_grad_accum.max()) > 0
    assert_grad_close(gs.xyz_grad_accum.numpy(), gs_ref.xyz_grad_accum.numpy(), "xyz_grad_accum")
    for f in ("valid", "denom", "max_radii2d"):
        np.testing.assert_array_equal(getattr(gs, f).numpy(), getattr(gs_ref, f).numpy(), err_msg=f)
    for f in ("joint_F", "lbs_weight_sum"):
        np.testing.assert_allclose(getattr(gs, f).numpy(), getattr(gs_ref, f).numpy(), atol=1e-5,
                                   err_msg=f)
    assert ts1.step == int(jts1.step) == 1


def test_ten_step_loss_trajectory_matches_jax(world):
    jts = world["jts"]
    ts = convert.train_state_from_jax(jts, CPU)
    losses, jlosses = [], []
    for i in range(10):
        k = i % len(world["frames"])
        jts, jlogs = world["step_fn"](jts, world["jframes"][k], 0)
        ts, logs = world["step"](ts, world["frames"][k], 0)
        jlosses.append(float(jlogs["loss"]))
        losses.append(float(logs["loss"]))
        assert int(logs["raster_overflow"]) == 0
    np.testing.assert_allclose(losses, jlosses, rtol=2e-3)
    assert losses[-1] < losses[0]
