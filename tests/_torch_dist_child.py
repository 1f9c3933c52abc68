"""One rank of a gloo process group for tests/test_torch_parallel.py (run by
it, not collected by pytest).  Imports torch and the port only.

Usage: python _torch_dist_child.py <scenario> <dir> <rank> <world>

The rank joins the group through ``maybe_initialize_distributed`` from a
file store in <dir>, reads its inputs from <dir>/inputs.npz (written by
the test), runs <scenario> and saves what it computed to
<dir>/<scenario>_<rank>.pt.
"""

import os
import sys

scenario, root, rank, world = (sys.argv[1], sys.argv[2], int(sys.argv[3]),
                               int(sys.argv[4]))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)

from msau_tpu_torch.config import ModelConfig, TrainConfig
from msau_tpu_torch.parallel.sharding import (
    axis_group,
    host_local_batch_to_global,
    make_mesh,
    maybe_initialize_distributed,
    shard_batch,
    sum_flat,
)
from msau_tpu_torch.parallel.spatial import halo_exchange, sharded_conv2d
from msau_tpu_torch.train.trainer import Trainer

assert maybe_initialize_distributed(
    coordinator_address="file://" + os.path.join(root, "store"),
    num_processes=world, process_id=rank, backend="gloo")
assert dist.get_world_size() == world and dist.get_rank() == rank
inputs = dict(np.load(os.path.join(root, "inputs.npz")))
out = {}


def params(trainer):
    return {k: v.detach().clone() for k, v in trainer.model.named_parameters()}


def step(cfg, tcfg, mesh, batch, put=None):
    tr = Trainer(ModelConfig(**cfg), TrainConfig(**tcfg), mesh=mesh,
                 device="cpu")
    tr.init_state(batch["input"], seed=0)
    dev = tr.put_batch(batch) if put is None else put
    tr.state, metrics = tr.train_step(tr.state, dev)
    return {k: float(v) for k, v in metrics.items()}, params(tr)


MOMENTUM = dict(optimizer="momentum", learning_rate=1e-2,
                lr_decay_staircase=False)

if scenario == "spatial":
    # world 4: one spatial line of 4 ranks, then a 2 x 2 data x spatial mesh
    line = make_mesh((1, 4), ("data", "spatial"), "cpu")
    group = axis_group(line, "spatial")
    x = shard_batch({"x": inputs["conv_x"]}, line, device="cpu")["x"]
    x = x.permute(0, 3, 1, 2).contiguous()            # NCHW block
    for kh in (3, 5):
        k = torch.from_numpy(inputs[f"conv_k{kh}"])
        out[f"conv{kh}"] = sharded_conv2d(x, k, group)
    xr = x.clone().requires_grad_(True)
    loss = torch.sin(sharded_conv2d(xr, torch.from_numpy(inputs["conv_k3"]),
                                    group)).sum()
    out["conv_grad"] = torch.autograd.grad(loss, xr)[0]
    rows = torch.arange(16.0).reshape(1, 1, 16, 1)
    out["halo"] = halo_exchange(rows[:, :, 4 * rank:4 * rank + 4], 1, group)
    out["halo_2_1"] = halo_exchange(rows[:, :, 4 * rank:4 * rank + 4],
                                    (2, 1), group)
    mesh = make_mesh((2, 2), ("data", "spatial"), "cpu")
    cfg = dict(img_channels=6, n_class=5, scale_space_num=3, res_depth=2,
               feat_root=8, num_blocks=2, final_act="softmax",
               flat_scales=2, spatial_shards=2)
    batch = {k: inputs[f"sp_{k}"] for k in ("input", "label", "valid")}
    out["sp_metrics"], out["sp_params"] = step(cfg, MOMENTUM, mesh, batch)
    # flat_scales 0: every scale on the image gathered from the pair
    cfg = dict(img_channels=6, n_class=4, scale_space_num=2, res_depth=1,
               feat_root=4, num_blocks=2)
    batch = {k: inputs[f"dp_{k}"][:4] for k in ("input", "label", "valid")}
    out["sp0_metrics"], out["sp0_params"] = step(cfg, MOMENTUM, mesh, batch)
elif scenario == "data":
    # world 2: a data mesh fed the global batch, then a host-local feed
    mesh = make_mesh((-1,), ("data",), "cpu")
    cfg = dict(img_channels=6, n_class=4, scale_space_num=2, res_depth=1,
               feat_root=4, num_blocks=1)
    batch = {k: inputs[f"dp_{k}"] for k in ("input", "label", "valid")}
    out["dp_metrics"], out["dp_params"] = step(cfg, MOMENTUM, mesh, batch)
    cfg = dict(img_channels=4, n_class=3, scale_space_num=2, res_depth=1,
               feat_root=4, num_blocks=1)
    local = {k: inputs[f"mh_{k}"][2 * rank:2 * rank + 2]
             for k in ("input", "label", "valid")}
    fed = host_local_batch_to_global(local, mesh, device="cpu")
    out["mh_metrics"], _ = step(cfg, MOMENTUM, mesh, local, put=fed)
    # odd sizes, mixed dtypes: each rank's pieces, their sums and addresses
    pieces = [torch.full((n,), float(rank + 1) * n) for n in (3, 1001, 17)]
    pieces.append(torch.full((2, 3), rank + 0.5, dtype=torch.bfloat16))
    summed = sum_flat(pieces)
    out["flat_sums"] = summed
    out["flat_addresses"] = [t.data_ptr() for t in summed]
else:
    raise SystemExit(f"unknown scenario {scenario}")

torch.save(out, os.path.join(root, f"{scenario}_{rank}.pt"))
dist.destroy_process_group()
print(f"RANK_OK {scenario} {rank}")
