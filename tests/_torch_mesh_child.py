"""One rank of tests/test_torch_parallel.py's or tests/test_torch_mesh_engines.py's
gloo group, on the CPU.

    python tests/_torch_mesh_child.py <rank> <world> <port> <inputs.pt> <outdir>

Every rank builds every mesh of the inputs' cases (subgroup creation is
collective); the ranks of a case's mesh run one sharded step on the inputs'
TrainState and write what it gave to <outdir>/<case>_<rank>.npz; then every
rank runs a Trainer on the 2 x 2 mesh and writes <outdir>/trainer_<rank>.npz.

Inputs with an "engines" entry run engines() instead: on each of its meshes
(the 1 x 2 on ranks 0-1 beside the 2 x 1 on ranks 2-3, then the 2 x 2 on
all four), at its case's LPIPS weight, one step of the sharded step in its eager form and in its device
form from the same state, then a Trainer run under each dispatch engine;
each rank writes <outdir>/engines_<mesh>_<rank>.npz.
"""
import copy
import dataclasses
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, port, inputs, outdir = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                     sys.argv[4], sys.argv[5])

from moss_torch.models import gaussians as G  # noqa: E402
from moss_torch.parallel.distributed import initialize_distributed  # noqa: E402
from moss_torch.parallel.sharded import make_mesh, make_sharded_train_step  # noqa: E402
from moss_torch.train import optim  # noqa: E402
from moss_torch.train.train_step import device_state, stage_frames  # noqa: E402
from moss_torch.train.trainer import Trainer  # noqa: E402

assert initialize_distributed(f"127.0.0.1:{port}", world, rank)
d = torch.load(inputs, weights_only=False)


def flat_state(ts, prefix):
    """{prefix.name: array} of a TrainState's params, moments, counts and statistics."""
    out = {f"{prefix}.gauss.{f}": getattr(ts.params["gauss"], f).numpy() for f in G.FIELDS}
    out.update({f"{prefix}.{k}.{n}": t.detach().numpy() for k, m in ts.params["mlps"].items()
                for n, t in m.named_parameters()})
    for g, st in ts.opt_state.items():
        out[f"{prefix}.count.{g}"] = np.array(int(st.count))
        out.update({f"{prefix}.mu.{g}.{n}": t.numpy() for n, t in st.mu.items()})
        out.update({f"{prefix}.nu.{g}.{n}": t.numpy() for n, t in st.nu.items()})
    out.update({f"{prefix}.gstate.{f}": getattr(ts.gstate, f).numpy() for f in (
        "valid", "xyz_grad_accum", "denom", "max_radii2d", "joint_F", "lbs_weight_sum")})
    out[f"{prefix}.step"] = np.array(int(ts.step))
    return out


def engines(e):
    """The engines mode (module docstring)."""
    meshes = {c["name"]: make_mesh(c["n_data"], c["n_tile"], c["ranks"], device="cpu")
              for c in e["cases"]}
    for c in e["cases"]:
        mesh = meshes[c["name"]]
        if mesh is None:
            continue
        out = {"mesh": np.array([mesh.data_index, mesh.tile_index])}
        cfg = dataclasses.replace(e["cfg"], optim=dataclasses.replace(e["cfg"].optim,
                                                                      w_lpips=c["w_lpips"]))
        # one step, the eager form against the device form
        tr = Trainer(d["scene"], d["frames"], d["frames"][:1], cfg, d["lp"],
                     crop_hw=(d["crop"],) * 2, mesh=mesh, device="cpu")
        step = tr._train_step
        step.tables = optim.step_tables(cfg.optim, False, optim.param_groups(tr.ts.params),
                                        1.0, "cpu")
        idx = c["idx"]
        eager, _ = step(copy.deepcopy(tr.ts), d["frames"], idx, 1)
        dev = device_state(copy.deepcopy(tr.ts))
        step(dev, stage_frames(d["frames"]), torch.tensor(idx), torch.tensor(1))
        dev = dev._replace(step=int(dev.step), opt_state={
            g: s._replace(count=int(s.count)) for g, s in dev.opt_state.items()})
        out.update(flat_state(eager, "eager_form"))
        out.update(flat_state(dev, "device_form"))
        # the Trainer under each engine
        for engine in ("eager", "queued", "scan"):
            logged = {}
            tr = Trainer(d["scene"], d["frames"], d["frames"][:1], cfg, d["lp"],
                         crop_hw=(d["crop"],) * 2, mesh=mesh, device="cpu",
                         log_fn=lambda it, lg, logged=logged: logged.__setitem__(it, lg))
            rounds = []
            densify = tr.densify
            tr.densify = lambda it, densify=densify, rounds=rounds: rounds.append(it) or \
                densify(it)
            tr.train(eval_iters=e["evals"], dispatch_engine=engine)
            out.update(flat_state(tr.ts, engine))
            out[f"{engine}.rounds"] = np.array(rounds)
            out[f"{engine}.logged"] = np.array(sorted(logged))
            out[f"{engine}.l1"] = np.array([logged[i]["l1"] for i in sorted(logged)])
            out[f"{engine}.overflow"] = np.array([logged[i]["raster_overflow"]
                                                  for i in sorted(logged)])
            out[f"{engine}.metrics"] = np.array([[m["iteration"], m["psnr"], m["ssim"],
                                                  m["lpips"], m["raster_overflow"]]
                                                 for m in tr.metrics_history])
            b = tr.budgets
            out[f"{engine}.budgets"] = np.array([b["pair_budget"], b["max_tiles"], b["npb"],
                                                 b["eval"]["pair_budget"],
                                                 b["eval"]["max_tiles"], b["eval"]["npb"]])
        np.savez(os.path.join(outdir, f"engines_{c['name']}_{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()
    print(f"MESH_CHILD_OK {rank}", flush=True)
    sys.exit(0)


if "engines" in d:
    engines(d["engines"])
for case in d["cases"]:
    mesh = make_mesh(case["n_data"], case["n_tile"], case["ranks"], device="cpu")
    if mesh is None:
        continue
    _, step = make_sharded_train_step(d["scene"], d["cfg"][case["cfg"]], mesh, d["crop"],
                                      d["crop"], d["lp"])
    seen = {}
    grads_of = step.mesh_grads
    step.mesh_grads = lambda *a, **k: seen.setdefault("r", grads_of(*a, **k))  # one step
    ts, logs = step(copy.deepcopy(d["ts"]), d["frames"], case["idx"], d["sh"])
    out = {f"log.{k}": v.numpy() for k, v in logs.items()}
    out.update({f"grad.{g}.{n}": t.numpy() for g, gr in seen["r"][2].items()
                for n, t in gr.items()})
    out.update({f"param.gauss.{f}": getattr(ts.params["gauss"], f).numpy() for f in G.FIELDS})
    out.update({f"param.{k}.{n}": t.detach().numpy() for k, m in ts.params["mlps"].items()
                for n, t in m.named_parameters()})
    out.update({f"gstate.{f}": getattr(ts.gstate, f).numpy() for f in (
        "xyz_grad_accum", "denom", "max_radii2d", "joint_F", "lbs_weight_sum")})
    out["mesh"] = np.array([mesh.data_index, mesh.tile_index])
    np.savez(os.path.join(outdir, f"{case['name']}_{rank}.npz"), **out)

# the Trainer on the 2 x 2 mesh: a short run with densify rounds and an eval
t = d["trainer"]
mesh = make_mesh(2, 2, [0, 1, 2, 3], device="cpu")
tr = Trainer(d["scene"], d["frames"], d["frames"][:1], t["cfg"], d["lp"], crop_hw=(d["crop"],) * 2,
             mesh=mesh, device="cpu")
tr.set_state(copy.deepcopy(d["ts"]))
rounds = []
densify = tr.densify
tr.densify = lambda it: rounds.append(it) or densify(it)
hist = tr.train(t["iterations"], eval_iters=[t["iterations"]], dispatch_engine="eager")
assert tr.resume_latest(outdir) == 0  # no checkpoint there: 0 on every rank
out = {f"param.{k}": v for k, v in
       {f: getattr(tr.ts.params["gauss"], f).numpy() for f in G.FIELDS}.items()}
out.update({"valid": tr.ts.gstate.valid.numpy(), "psnr": np.array(hist[-1]["psnr"]),
            "rounds": np.array(rounds), "step": np.array(tr.ts.step)})
np.savez(os.path.join(outdir, f"trainer_{rank}.npz"), **out)
dist.barrier()
dist.destroy_process_group()  # a gloo group left to the interpreter's exit can abort it
print(f"MESH_CHILD_OK {rank}", flush=True)
