"""The port's ``parallel/`` on gloo process groups of CPU ranks, against the
JAX package and against the port's own single-process step.

Each group is a set of subprocesses (tests/_torch_dist_child.py, torch
only) that meet through a file store in a temporary directory, so
concurrent test workers never race for a port; a group has 60 s.  Two
groups serve the tests below:

  * 4 ranks: ``sharded_conv2d`` on a spatial line of 4 (kh 3 and 5, the
    cases of tests/test_parallel.py) against JAX's on the virtual (2, 4)
    mesh, to atol 1e-5; ``halo_exchange``'s rows; the input gradient
    routed back across ranks against ``jax.grad`` of the unsharded conv
    (1e-5); one momentum-SGD step of a flat model (flat_scales 2) on a
    (2, 2) data x spatial mesh against the single-process step at
    spatial_shards 1 (the config of tests/test_spatial_flat.py; loss rtol
    1e-5, parameters atol 1e-5, identical on every rank), and the same for
    a model with no flat scale.
  * 2 ranks: the data-parallel step of tests/test_parallel.py (momentum
    SGD; loss rtol 1e-5, parameters atol 1e-5, identical on both ranks)
    on labels whose valid non-background counts differ between the
    ranks' halves, which catches a loss normalised by each rank's own
    count; and the host-local feed of tests/test_multihost.py, whose loss
    equals JAX's single-device loss on the same global batch (rtol 1e-5);
    and ``sum_flat``'s sums and the alignment of its pieces.

Then ``train_generic --devices 2 --device cpu``: two steps on two local
workers that the CLI starts itself (60 s for them too).  With no group at
all: the slice descriptions (``batch_sharding``, ``spatial_sharding``,
``replicated``, ``spatial_shardings``) and ``shard_batch`` at every
coordinate of a (2, 4) mesh, against the blocks JAX's ``NamedSharding``s
give each device of the same mesh.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from msau_tpu.parallel import sharding as jsh
from msau_tpu.parallel import spatial as jsp
from msau_tpu.parallel.sharding import make_mesh as jax_make_mesh
from msau_tpu.parallel.spatial import halo_exchange as jax_halo_exchange
from msau_tpu.parallel.spatial import sharded_conv2d as jax_sharded_conv2d
from msau_tpu_torch.config import ModelConfig, TrainConfig
from msau_tpu_torch.parallel import sharding as psh
from msau_tpu_torch.parallel import spatial as psp
from msau_tpu_torch.train.trainer import Trainer

HERE = os.path.dirname(os.path.abspath(__file__))
CHILD = os.path.join(HERE, "_torch_dist_child.py")
GROUP_TIMEOUT = 60
MOMENTUM = dict(optimizer="momentum", learning_rate=1e-2,
                lr_decay_staircase=False)
SP_CFG = dict(img_channels=6, n_class=5, scale_space_num=3, res_depth=2,
              feat_root=8, num_blocks=2, final_act="softmax", flat_scales=2)
DP_CFG = dict(img_channels=6, n_class=4, scale_space_num=2, res_depth=1,
              feat_root=4, num_blocks=1)
MH_CFG = dict(img_channels=4, n_class=3, scale_space_num=2, res_depth=1,
              feat_root=4, num_blocks=1)


def _inputs():
    rng = np.random.default_rng(777)
    out = {"conv_x": rng.random((4, 32, 16, 3)).astype(np.float32)}
    for kh in (3, 5):
        # OIHW; JAX's HWIO is its transpose
        out[f"conv_k{kh}"] = (rng.standard_normal((5, 3, kh, 3)) * 0.1
                              ).astype(np.float32)
    n = 4
    out["sp_input"] = rng.random((n, 64, 64, 6)).astype(np.float32)
    out["sp_label"] = rng.integers(0, 5, (n, 64, 64)).astype(np.int32)
    valid = np.ones((n, 64, 64), bool)
    valid[1, 40:] = False           # the ranks' valid counts differ
    out["sp_valid"] = valid
    out["dp_input"] = rng.random((8, 16, 16, 6)).astype(np.float32)
    label = rng.integers(0, 4, (8, 16, 16)).astype(np.int32)
    label[4:, :, :10] = 0           # the second rank's half: fewer labels
    out["dp_label"] = label
    out["dp_valid"] = np.ones((8, 16, 16), bool)
    out["mh_input"] = rng.random((4, 16, 16, 4)).astype(np.float32)
    out["mh_label"] = rng.integers(0, 3, (4, 16, 16)).astype(np.int32)
    out["mh_valid"] = np.ones((4, 16, 16), bool)
    return out


def _run_group(root, scenario, world):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, CHILD, scenario, str(root), str(r), str(world)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=GROUP_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"RANK_OK {scenario} {r}" in text, text
    return [torch.load(os.path.join(root, f"{scenario}_{r}.pt"))
            for r in range(world)]


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def spatial_ranks(inputs, tmp_path_factory):
    root = tmp_path_factory.mktemp("spatial")
    np.savez(root / "inputs.npz", **inputs)
    return _run_group(root, "spatial", 4)


@pytest.fixture(scope="module")
def data_ranks(inputs, tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    np.savez(root / "inputs.npz", **inputs)
    return _run_group(root, "data", 2)


def _rows(parts):
    """The ranks' NCHW blocks joined along H."""
    return torch.cat(parts, dim=2).numpy()


class _Coord:
    """The face of a ``DeviceMesh`` that a slice reads, at one coordinate."""

    def __init__(self, shape, names, coord):
        self.shape, self.mesh_dim_names, self.coord = shape, names, coord

    def size(self, i):
        return self.shape[i]

    def get_coordinate(self):
        return list(self.coord)


# (port's sharding at a coordinate, JAX's sharding, shape of the tensor)
SLICES = {
    "batch": (lambda m: psh.batch_sharding(m, 4),
              lambda m: jsh.batch_sharding(m, 4), (4, 16, 8, 3)),
    "spatial": (lambda m: psh.spatial_sharding(m, 4),
                lambda m: jsh.spatial_sharding(m, 4), (4, 16, 8, 3)),
    "replicated": (psh.replicated, jsh.replicated, (4, 16, 8, 3)),
    "spatial_input": (lambda m: psp.spatial_shardings(m)[0],
                      lambda m: jsp.spatial_shardings(m)[0], (2, 16, 8, 3)),
    "spatial_label": (lambda m: psp.spatial_shardings(m)[1],
                      lambda m: jsp.spatial_shardings(m)[1], (2, 16, 8)),
}


@pytest.mark.parametrize("kind", sorted(SLICES))
def test_slices_match_jax_named_shardings(kind):
    """Each rank's block of a (2, 4) data x spatial mesh equals the block
    JAX's sharding places on the device at the same coordinate."""
    port, ref, shape = SLICES[kind]
    x = np.arange(np.prod(shape)).reshape(shape)
    mesh = jax_make_mesh((2, 4), ("data", "spatial"))
    where = ref(mesh).devices_indices_map(shape)
    for i in range(2):
        for j in range(4):
            got = port(_Coord((2, 4), ("data", "spatial"), (i, j))).local(x)
            np.testing.assert_array_equal(got, x[where[mesh.devices[i, j]]])


@pytest.mark.parametrize("axes", [("data",), ("data", "spatial")])
def test_shard_batch_takes_the_rank_block(axes):
    """``shard_batch`` keeps dim 0's block on the data axis and, with a
    spatial axis, H's block (of NHWC inputs and [N, H, W] labels), as
    JAX's ``spatial_shardings`` place them (``batch_sharding`` without)."""
    shape = (2, 4)[:len(axes)]
    mesh = jax_make_mesh(shape, axes)
    rng = np.random.default_rng(3)
    batch = {"input": rng.random((4, 16, 8, 3)).astype(np.float32),
             "label": rng.integers(0, 5, (4, 16, 8)).astype(np.int32)}
    if len(axes) == 2:
        refs = dict(zip(("input", "label"), jsp.spatial_shardings(mesh)))
    else:
        refs = {k: jsh.batch_sharding(mesh, v.ndim) for k, v in batch.items()}
    for coord in np.ndindex(*shape):
        got = psh.shard_batch(batch, _Coord(shape, axes, coord),
                              device="cpu")
        for k, v in batch.items():
            where = refs[k].devices_indices_map(v.shape)[mesh.devices[coord]]
            np.testing.assert_array_equal(got[k].numpy(), v[where])


@pytest.mark.parametrize("kh", [3, 5])
def test_sharded_conv2d_matches_jax(spatial_ranks, inputs, kh):
    mesh = jax_make_mesh((2, 4), ("data", "spatial"))
    x = jnp.asarray(inputs["conv_x"])
    k = jnp.asarray(inputs[f"conv_k{kh}"].transpose(2, 3, 1, 0))
    want = np.asarray(jax_sharded_conv2d(x, k, mesh))
    got = _rows([r[f"conv{kh}"] for r in spatial_ranks]).transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_halo_exchange_contents(spatial_ranks):
    """16 rows, 4 ranks of 4: rank r holds rows 4r..4r+3 between its
    halos, zeros past the image's edges; JAX's halo_exchange on a 4-shard
    mesh gives the same rows."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    mesh = jax_make_mesh((4,), ("spatial",))
    x = jnp.arange(16.0).reshape(1, 16, 1, 1)
    want = np.asarray(shard_map(
        lambda b: jax_halo_exchange(b, 1, "spatial"), mesh=mesh,
        in_specs=P(None, "spatial", None, None),
        out_specs=P(None, "spatial", None, None))(x)).reshape(4, 6)
    got = np.stack([r["halo"].reshape(-1).numpy() for r in spatial_ranks])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[1], [3, 4, 5, 6, 7, 8])
    assert got[0][0] == 0 and got[3][-1] == 0
    uneven = np.stack([r["halo_2_1"].reshape(-1).numpy()
                       for r in spatial_ranks])
    np.testing.assert_array_equal(uneven[2], [6, 7, 8, 9, 10, 11, 12])
    np.testing.assert_array_equal(uneven[0], [0, 0, 0, 1, 2, 3, 4])
    np.testing.assert_array_equal(uneven[3], [10, 11, 12, 13, 14, 15, 0])


def test_sharded_conv_grads_route_across_ranks(spatial_ranks, inputs):
    """d sum(sin(conv(x))) / dx: each halo row's gradient reaches the rank
    that owns the row."""
    k = jnp.asarray(inputs["conv_k3"].transpose(2, 3, 1, 0))

    def loss(x):
        return jnp.sum(jnp.sin(lax.conv_general_dilated(
            x, k, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))))

    want = np.asarray(jax.grad(loss)(jnp.asarray(inputs["conv_x"])))
    got = _rows([r["conv_grad"] for r in spatial_ranks]).transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def _one_process(cfg, batch):
    tr = Trainer(ModelConfig(**cfg), TrainConfig(**MOMENTUM), device="cpu")
    tr.init_state(batch["input"], seed=0)
    tr.state, metrics = tr.train_step(tr.state, tr.put_batch(batch))
    return ({k: float(v) for k, v in metrics.items()},
            {k: v.detach() for k, v in tr.model.named_parameters()})


def _check_step(ranks, key, want_metrics, want_params):
    for r in ranks:
        for name in ("loss", "loss_final", "loss_aux", "accuracy"):
            np.testing.assert_allclose(r[f"{key}_metrics"][name],
                                       want_metrics[name], rtol=1e-5)
        for name, w in want_params.items():
            np.testing.assert_allclose(r[f"{key}_params"][name].numpy(),
                                       w.numpy(), atol=1e-5, rtol=0,
                                       err_msg=name)
    for r in ranks[1:]:   # every rank applied the same update
        assert r[f"{key}_metrics"] == ranks[0][f"{key}_metrics"]
        for name, v in r[f"{key}_params"].items():
            assert torch.equal(v, ranks[0][f"{key}_params"][name]), name


def test_data_parallel_step_matches_one_process(data_ranks, inputs):
    batch = {k: inputs[f"dp_{k}"] for k in ("input", "label", "valid")}
    counts = [int((batch["label"][h] != 0).sum()) for h in (slice(0, 4),
                                                           slice(4, 8))]
    assert counts[0] - counts[1] > 100, counts
    torch.set_num_threads(1)
    _check_step(data_ranks, "dp", *_one_process(DP_CFG, batch))


def test_data_spatial_step_matches_one_process(spatial_ranks, inputs):
    """A (2, 2) data x spatial mesh at spatial_shards 2: the flat scales'
    halos from the spatial pair, the deep scales on the gathered image."""
    batch = {k: inputs[f"sp_{k}"] for k in ("input", "label", "valid")}
    torch.set_num_threads(1)
    _check_step(spatial_ranks, "sp", *_one_process(SP_CFG, batch))


def test_data_spatial_step_at_flat_scales_0(spatial_ranks, inputs):
    """The (2, 2) mesh with a model of no flat scale (two stages): each
    rank gathers the image from its spatial pair at the entry, runs every
    scale on it and keeps its rows of the logits (the JAX package lets
    GSPMD partition the NHWC convs instead)."""
    cfg = dict(DP_CFG, num_blocks=2)
    batch = {k: inputs[f"dp_{k}"][:4] for k in ("input", "label", "valid")}
    torch.set_num_threads(1)
    _check_step(spatial_ranks, "sp0", *_one_process(cfg, batch))


def test_maybe_initialize_distributed_two_processes(data_ranks, inputs):
    """Two processes that each fed their own half of the global batch
    (host_local_batch_to_global) read the same global loss, JAX's
    single-device loss on the whole batch from the same weights."""
    from msau_tpu.config import ModelConfig as JaxModelConfig
    from msau_tpu.config import TrainConfig as JaxTrainConfig
    from msau_tpu.models.msau import build_model as jax_build_model
    from msau_tpu.train.optimizer import make_optimizer
    from msau_tpu.train.trainer import TrainState, make_train_step
    from msau_tpu_torch.models.msau import build_model
    from msau_tpu_torch.utils.transplant import torch_to_flax

    losses = [r["mh_metrics"]["loss"] for r in data_ranks]
    assert losses[0] == losses[1], losses
    assert not psh.maybe_initialize_distributed()   # no coordinates here
    weights = build_model(ModelConfig(**MH_CFG),
                          torch.Generator().manual_seed(0)).state_dict()
    tcfg = JaxTrainConfig(learning_rate=1e-2, optimizer="momentum",
                          lr_decay_staircase=False, donate_state=False,
                          matmul_precision="")
    opt = make_optimizer(tcfg)
    params = jax.tree_util.tree_map(jnp.asarray, torch_to_flax(weights))
    step = make_train_step(jax_build_model(JaxModelConfig(**MH_CFG)), opt,
                           masked=True, donate=False)
    batch = {k: jnp.asarray(inputs[f"mh_{k}"])
             for k in ("input", "label", "valid")}
    _, metrics = step(TrainState.create(params, opt), batch)
    np.testing.assert_allclose(losses[0], float(metrics["loss"]), rtol=1e-5)


def test_sum_flat_sums_aligned_pieces(data_ranks):
    """sum_flat over 2 ranks: each piece the sum of the ranks' pieces, in
    its own shape and dtype, and every f32 piece starting on a multiple of
    FLAT_ALIGN bytes (so reductions over it take the same path as over a
    tensor of its own)."""
    for r in data_ranks:
        sums, addresses = r["flat_sums"], r["flat_addresses"]
        for n, got in zip((3, 1001, 17), sums):
            assert got.dtype == torch.float32
            assert torch.equal(got, torch.full((n,), 3.0 * n))
        assert sums[3].dtype == torch.bfloat16 and sums[3].shape == (2, 3)
        assert torch.equal(sums[3], torch.full((2, 3), 2.0,
                                               dtype=torch.bfloat16))
        assert all((a - addresses[0]) % psh.FLAT_ALIGN == 0
                   for a in addresses[:3]), addresses


def test_train_generic_two_devices_cpu(tmp_path, capfd, monkeypatch):
    """train_generic --devices 2 --device cpu starts two gloo workers, runs
    two steps and a validation sweep, and leaves one checkpoint; only rank 0
    logs."""
    from msau_tpu_torch.data.synth import write_corpus
    from msau_tpu_torch.tools import train_generic

    monkeypatch.setenv("OMP_NUM_THREADS", "1")   # the workers' intra-op
    spawn = psh.spawn_workers    # the CLI's workers get GROUP_TIMEOUT too
    monkeypatch.setattr(psh, "spawn_workers", lambda *a, **k: spawn(
        *a, **{**k, "timeout": GROUP_TIMEOUT}))
    pages = tmp_path / "pages"
    _, _, charset = write_corpus(str(pages), 4, 0, np.random.default_rng(5))
    out = tmp_path / "out"
    train_generic.main([
        "--train_dir", str(pages), "--val_dir", str(pages), "--charset",
        charset, "--n_classes", "17", "--device", "cpu", "--devices", "2", "--feat_root", "2",
        "--scale_space_num", "3", "--res_depth", "1", "--epochs", "1",
        "--batch_steps_per_epoch", "2", "--output_path", str(out)])
    assert (out / "model1" / "train_state.pt").exists()
    blob = torch.load(out / "model1" / "train_state.pt")
    assert blob["step"] == 2
    text = capfd.readouterr().out
    assert text.count("TRAIN epoch 1: loss=") == 1, text
    assert text.count("VAL   epoch 1: loss=") == 1, text
    loss = float(text.split("TRAIN epoch 1: loss=")[1].split()[0])
    assert np.isfinite(loss)
