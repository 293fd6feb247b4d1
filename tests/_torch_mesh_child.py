"""One rank of tests/test_torch_parallel.py's gloo group, on the CPU.

    python tests/_torch_mesh_child.py <rank> <world> <port> <inputs.pt> <outdir>

Every rank builds every mesh of the inputs' cases (subgroup creation is
collective); the ranks of a case's mesh run one sharded step on the inputs'
TrainState and write what it gave to <outdir>/<case>_<rank>.npz; then every
rank runs a Trainer on the 2 x 2 mesh and writes <outdir>/trainer_<rank>.npz.
"""
import copy
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
from moss_torch.train.trainer import Trainer  # noqa: E402

assert initialize_distributed(f"127.0.0.1:{port}", world, rank)
d = torch.load(inputs, weights_only=False)
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
hist = tr.train(t["iterations"], eval_iters=[t["iterations"]])
assert tr.resume_latest(outdir) == 0  # no checkpoint there: 0 on every rank
out = {f"param.{k}": v for k, v in
       {f: getattr(tr.ts.params["gauss"], f).numpy() for f in G.FIELDS}.items()}
out.update({"valid": tr.ts.gstate.valid.numpy(), "psnr": np.array(hist[-1]["psnr"]),
            "rounds": np.array(rounds), "step": np.array(tr.ts.step)})
np.savez(os.path.join(outdir, f"trainer_{rank}.npz"), **out)
dist.barrier()
dist.destroy_process_group()  # a gloo group left to the interpreter's exit can abort it
print(f"MESH_CHILD_OK {rank}", flush=True)
