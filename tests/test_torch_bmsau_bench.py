"""The benchmark's BMSAU cell (``bmsau_train_512``) on the CPU: the plain
box reference (``benchmark/reference/bmsau.py``) against the port's step
and the port's plain box convolution, the box counts, the box metrics'
readers, and whole runs of the cell through the harness at 2 images of
64 x 64 (the port correct; frozen box coordinates, a bf16 integral image
and the reference in TF32 not)."""

import dataclasses
import json
import shutil
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import box_counts, generator, harness  # noqa: E402
from benchmark.kinds import train, train_box  # noqa: E402
from benchmark.reference import bmsau as bref  # noqa: E402
from benchmark.reference import msau as ref  # noqa: E402

CELL = "bmsau_train_512"
TINY = {"batch": 2, "height": 64, "width": 64, "trace_units": 2}
# a small size: 4 scales, 2 box convs of up to 6, 64 x 64, batch 2
SMALL = {"scale_space_num": 4, "num_box_convs": 2, "max_box_sizes": 6}


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of the benchmark's data whose traffic is cut to 2 images of
    64 x 64; the harness's code is the repository's own."""
    (tmp_path / "benchmark").mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for d in ("configs", "traffic", "workloads", "metrics"):
        shutil.copytree(ROOT / "benchmark" / d, tmp_path / "benchmark" / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for path in (tmp_path / "benchmark" / "traffic").glob("*.json"):
        traffic = json.loads(path.read_text())
        traffic.update(TINY)
        path.write_text(json.dumps(traffic))
    return tmp_path


def _config():
    return json.loads((ROOT / "benchmark" / "configs" / "bmsau_default.json"
                       ).read_text())


def _inputs(model, seed, n=2, hw=64):
    traffic = {"batch": n, "height": hw, "width": hw, "rects": 6,
               "noise": 0.1, "pool": 2}
    gen = torch.Generator().manual_seed(seed)
    params = train_box.make_params(model, gen)
    return params, generator.structured_batches(traffic, model, seed, gen)


def test_reference_matches_the_port_step_in_float64():
    """One training step at the small size, float64 on both sides (the
    port's CPU path takes float64): the logits, the loss, every gradient
    (box coordinates included) and every updated parameter agree to
    float64 rounding (1e-9 of a leaf's gradient norm or the median's;
    the two sides form the box sums as banded products and as gathers)."""
    from msau_tpu_torch.config import ModelConfig, TrainConfig
    from msau_tpu_torch.models.msau import build_model
    from msau_tpu_torch.train.optimizer import make_optimizer
    from msau_tpu_torch.train.trainer import TrainState, make_train_step

    config = _config()
    model = dict(config["model"], **SMALL)
    params, batches = _inputs(model, 5)
    mc = dataclasses.replace(ModelConfig.from_model_kwargs(model),
                             use_lrn=model["use_lrn"],
                             **dict(config["program"], dtype="float64"))
    net = build_model(mc, torch.Generator().manual_seed(0)).double()
    with torch.no_grad():
        for k, p in net.named_parameters():
            p.copy_(params[k])
    batch = {"input": batches[0]["input"].double(),
             "label": batches[0]["label"]}
    p64 = {k: v.double().requires_grad_(True) for k, v in params.items()}
    with torch.no_grad():
        want, _ = bref.forward(p64, model, batch["input"], ref.Arith(),
                               ref.attention)
        _, got, _ = net(batch["input"], logits_layout="NCHW")
    assert torch.allclose(got, want, rtol=0, atol=1e-10)

    t = config["train"]
    opt = make_optimizer(TrainConfig(learning_rate=t["learning_rate"],
                                     lr_decay_staircase=False,
                                     grad_clip_norm=t["grad_clip_norm"]))
    state = TrainState.create(net, opt)
    state, metrics = make_train_step(net, opt, masked=True)(state, batch)
    loss, grads = bref.loss_and_grads(p64, model, batch, ref.Arith(),
                                      ref.attention)
    grads = ref.Adam(t["learning_rate"], t["grad_clip_norm"]).clip(grads)
    assert float(metrics["loss"]) == pytest.approx(float(loss), rel=1e-12)
    med = float(np.median([float(g.norm()) for g in grads]))
    names = list(p64)
    for k, g in zip(names, grads):
        got = state.opt_state["mu"][k] / (1 - ref.ADAM_B1)
        assert float((got - g).norm()) <= 1e-9 * max(float(g.norm()), med), k
    assert all(float(g.norm()) > 0 for k, g in zip(names, grads)
               if bref.is_box_leaf(k))
    adam = ref.Adam(t["learning_rate"], t["grad_clip_norm"])
    adam.update(list(p64.values()), grads)
    for k, q in p64.items():
        assert torch.allclose(state.params[k].detach(), q.detach(), rtol=0,
                              atol=1e-12), k


def _coords(rng, c, b, kind, m):
    """[2, C, B] ybox, xbox float64 of one kind of case."""
    def u(lo, hi):
        return rng.uniform(lo, hi, (c, b))

    if kind == "fractional":
        y, x = u(-m, 1), u(-m, 1)
        pairs = (y, y + u(0.3, 4), x, x + u(0.3, 4))
    elif kind == "swapped":
        y, x = u(-3, 3), u(-3, 3)
        pairs = (y + 2.5, y, x + 1.25, x - 0.5)
    elif kind == "tied":
        y, x = u(-3, 3), u(-3, 3)
        pairs = (y, y.copy(), x, x.copy())
    else:
        lo = np.full((c, b), -float(m))
        pairs = (lo, -lo, np.where(rng.random((c, b)) < 0.5, -m, -m - 2.5),
                 np.where(rng.random((c, b)) < 0.5, m, 1.25))
    return (torch.from_numpy(np.stack(pairs[:2])),
            torch.from_numpy(np.stack(pairs[2:])))


@pytest.mark.parametrize("kind", ["fractional", "swapped", "tied", "clamped"])
def test_reference_box_filter_matches_the_port_plain_version(kind):
    """The reference's box filter (gathers of the blended corners) against
    the port's plain formulation (banded products) in float64, and their
    gradients to the input and to the raw coordinates, ties and clamps
    included: to float64 rounding (1e-10 of max(1, max |want|))."""
    from msau_tpu_torch.ops.boxconv import box_conv_plain

    rng = np.random.default_rng(3)
    m = 5
    yb, xb = _coords(rng, 3, 2, kind, m)
    x = torch.from_numpy(rng.random((2, 3, 11, 9)))
    g = torch.from_numpy(rng.standard_normal((2, 6, 11, 9)))
    outs = []
    for fn in (lambda *a: bref.box_filter(*a, m, m),
               lambda *a: box_conv_plain(*a, max_h=m, max_w=m)):
        leaves = [t.clone().requires_grad_(True) for t in (x, yb, xb)]
        out = fn(*leaves)
        outs.append([out.detach(), *torch.autograd.grad(out, leaves, g)])
    for got, want in zip(*outs):
        scale = max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) <= 1e-10 * scale


@pytest.mark.parametrize("n,hw", [(1, 64), (2, 48)])
def test_operation_count_matches_the_flop_counter(n, hw):
    """The convolutions and the 1x1 projections of ``bmsau_flops`` against
    torch's flop counter over the reference's step (which counts no box
    filter: the box terms are the benchmark's own, from shapes)."""
    model = dict(_config()["model"], **SMALL)
    params, batches = _inputs(model, 1, n=n, hw=hw)
    want = box_counts.bmsau_flops(model, n, hw, hw)
    calls = box_counts.box_calls(model, n, hw, hw)
    box_fwd = sum(box_counts.box_flops("fwd", c) for c in calls)
    box_bwd = sum(box_counts.box_flops("bwd", c) for c in calls)
    p = {k: v.requires_grad_(True) for k, v in params.items()}
    with FlopCounterMode(display=False) as fwd:
        loss = bref.loss_fn(p, model, batches[0], ref.Arith(), ref.attention)
    with FlopCounterMode(display=False) as bwd:
        torch.autograd.grad(loss, list(p.values()), allow_unused=True)
    assert fwd.get_total_flops() == want["forward"] - box_fwd
    assert (fwd.get_total_flops() + bwd.get_total_flops()
            == want["train"] - box_fwd - box_bwd)


def test_box_calls_and_bounds_of_the_cell():
    """99 box convolutions a step at 512 x 512, batch 16: 3 stages x (6
    down + 5 up scales) x 3; the scale-0 call moves 537 MB forward and 671
    MB backward, and the step's calls are bound by bytes at ~12.6 ms."""
    model = _config()["model"]
    calls = box_counts.box_calls(model, 16, 512, 512)
    assert len(calls) == 99
    assert calls[0] == (16, 8, 3, 512, 512)
    assert calls[17] == (16, 256, 3, 16, 16)
    assert box_counts.box_bytes("fwd", calls[0]) == 4 * (
        16 * 8 * 512 * 512 * 4 + 2 * 2 * 8 * 3)
    bounds = [box_counts.box_bound_ms(k, c) for k in ("fwd", "bwd")
              for c in calls]
    assert {by for _, by in bounds} == {"bytes"}
    assert sum(ms for ms, _ in bounds) == pytest.approx(12.6, abs=0.3)


def _ctx(kernels, counters, units=2, calls=((2, 8, 3, 64, 64),) * 3):
    return types.SimpleNamespace(
        trace=types.SimpleNamespace(kernels=list(kernels)), units=units,
        counters=counters, work={"box": list(calls)})


def test_box_readers():
    """``box_ms`` sums the ``msau::box::`` kernels; each roofline share is
    the calls' bounds over its kernel's time, and None where the launch
    counter is not one a call, where the kernel is missing or with no
    trace."""
    calls = [(2, 8, 3, 64, 64)] * 3
    fwd_s = sum(box_counts.box_bound_ms("fwd", c)[0] for c in calls) * 1e-3
    kernels = [("void msau::box::filter_fwd(float const*)", fwd_s),
               ("void msau::box::filter_fwd(float const*)", fwd_s),
               ("void msau::box::filter_bwd(float const*)", 4 * fwd_s),
               ("sm90_xmma_fprop_implicit_gemm", 1.0)]
    ctx = _ctx(kernels, {"box_conv_fwd": 3.0, "box_conv_bwd": 3.0})
    read = lambda name: harness.reader(ROOT, name)(ctx)
    assert read("box_ms") == pytest.approx(1e3 * 6 * fwd_s / 2)
    assert read("box_fwd_roofline_pct") == pytest.approx(100.0)
    assert read("box_bwd_roofline_pct") is not None
    ctx.counters = {"box_conv_fwd": 2.0, "box_conv_bwd": 3.0}
    assert read("box_fwd_roofline_pct") is None
    ctx.counters = {"box_conv_fwd": 3.0}
    assert read("box_bwd_roofline_pct") is None
    ctx.trace.kernels = kernels[-1:]
    assert read("box_ms") is None
    ctx.trace = None
    for name in ("box_ms", "box_fwd_roofline_pct", "box_bwd_roofline_pct",
                 "host_box_ms"):
        assert read(name) is None


@pytest.mark.parametrize("kernel", train_box.BOX_KERNELS)
def test_a_port_without_the_box_kernels_is_refused(monkeypatch, kernel):
    """The cell's own program refuses a port whose registry lacks a box
    kernel before it builds the model, so such a run exits with no result
    instead of timing the banded einsum formulation."""
    from msau_tpu_torch import ops

    assert train_box.Cell.__init__.__defaults__ == (train_box.BoxPortTrainer,)
    model = dict(_config()["model"], **SMALL)
    params, _ = _inputs(model, 7)
    built = []
    monkeypatch.setattr(train.PortTrainer, "__init__",
                        lambda *a: built.append(a))
    config = {"model": model}
    train_box.BoxPortTrainer(config, torch.device("cpu"), params)
    assert len(built) == 1
    monkeypatch.delitem(ops.KERNEL_WRAPPERS, kernel)
    with pytest.raises(RuntimeError, match=kernel):
        train_box.BoxPortTrainer(config, torch.device("cpu"), params)
    assert len(built) == 1


# one run of the cell on the CPU, in a fresh interpreter: this suite's
# process has loaded JAX, and a run that loaded it gives no result
RUN = """
import json, sys, torch
sys.path.insert(0, {repo!r})
from benchmark import calibrate_box, harness
program = {program!r}
rc = harness.run(__import__("pathlib").Path({root!r}),
                 ["--workload", {cell!r}, "--seed", "4000000031",
                  "--seconds", "0.3", "--trace", "0"], 0.0,
                 device=torch.device("cpu"),
                 program=getattr(calibrate_box, program) if program else None)
sys.exit(rc)
"""


def _run(root, program=None):
    import subprocess

    code = RUN.format(repo=str(ROOT), root=str(root), cell=CELL,
                      program=program)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=root)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_the_cell_runs_correct_on_the_cpu(tiny_root):
    result = _run(tiny_root)
    assert result["correct"] is True
    assert set(result["metrics"]) == {"train_img_s", "setup_s"}
    assert result["attempted"] >= 1 and result["failed"] == 0


@pytest.mark.parametrize("program", ["FrozenBoxes", "Bf16Integral",
                                     "Control"],
                         ids=["frozen_boxes", "bf16_integral",
                              "control_tf32"])
def test_the_box_faults_and_the_control_are_not_correct(tiny_root, program):
    """A whole run with the box coordinates' gradients zeroed, with a bf16
    integral image in the box convolutions, or the box reference in TF32
    in the program's place."""
    result = _run(tiny_root, program=program)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())
