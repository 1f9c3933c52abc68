"""The port's profiling helpers (msau_tpu_torch.utils.profiling) and
``Trainer.fit(log_dir=)`` on the CPU, against the JAX package's:

* ``StepTimer``: the same step seconds and EMA as JAX's on the same clock
  readings, and ``sync_on`` fetches from a tensor tree;
* ``MetricsLogger``: the same JSONL rows as JAX's for the same inputs
  (numpy, torch and unconvertible values);
* ``trace`` and ``capture_trace``: a record in a profile, a trace file;
* ``fit(log_dir=)``: ``metrics.jsonl`` holds the rows the JAX trainer
  writes for the same run (same keys at the same steps).
"""

import itertools
import json
import sys

import numpy as np
import pytest
import torch

from msau_tpu.utils import profiling as oprof
from msau_tpu_torch.utils import profiling


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this file: its CPU runs stay fast when the
    suite's other workers load every core (OpenMP's barriers spin)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("ema", [0.9, 0.5])
def test_step_timer_matches_jax(monkeypatch, ema):
    ticks = [10.0, 10.25, 11.0, 11.125, 12.0, 12.75]

    def run(module, sync):
        clock = itertools.chain(ticks)
        monkeypatch.setattr(module.time, "perf_counter", lambda: next(clock))
        t = module.StepTimer(ema=ema)
        out = []
        for _ in range(3):
            t.start()
            out.append((t.stop(sync), t.avg))
        return out

    want = run(oprof, None)
    assert run(profiling, None) == want
    tree = {"b": [torch.ones(3)], "a": (torch.zeros(2, 2), 1)}
    assert run(profiling, tree) == want
    assert want[1][1] == pytest.approx(ema * 0.25 + (1 - ema) * 0.125)


def test_metrics_logger_rows_match_jax(tmp_path):
    rows = [(1, {"loss": 0.5, "acc": np.float32(0.25), "skip": "str"}),
            (2, {"loss": torch.tensor(0.4), "epoch": 3, "none": None}),
            (7, {"val/loss": np.float64(1e-3)})]
    for module, name in ((profiling, "ours"), (oprof, "jax")):
        with module.MetricsLogger(str(tmp_path / name), tensorboard=False) as ml:
            for step, m in rows:
                ml.log(step, m)
    ours = (tmp_path / "ours" / "metrics.jsonl").read_text()
    assert ours == (tmp_path / "jax" / "metrics.jsonl").read_text()
    assert json.loads(ours.splitlines()[0]) == {"step": 1, "loss": 0.5,
                                                "acc": 0.25}


def test_trace_and_capture_trace(tmp_path):
    with profiling.capture_trace(str(tmp_path / "trace")) as d:
        with profiling.trace("msau_step", step=3):
            torch.ones(8).sum()
    text = (tmp_path / "trace" / "trace.json").read_text()
    assert d == str(tmp_path / "trace") and "msau_step" in text
    with profiling.trace("outside a profile"):
        pass
    with pytest.raises(KeyError):   # the block's own errors pass through
        with profiling.trace("step"):
            raise KeyError("x")


CFG = dict(img_channels=3, n_class=3, scale_space_num=2, res_depth=1,
           feat_root=2, num_blocks=1, final_act="softmax")


class _Provider:
    size_val = 1

    def __init__(self):
        self.i = 0

    def next_data(self, split):
        rng = np.random.default_rng(1000 if split == "val" else self.i)
        self.i += split != "val"
        x = rng.random((1, 8, 8, 3)).astype(np.float32)
        y = rng.integers(0, 3, (1, 8, 8)).astype(np.int32)
        return {"input": x, "label": y, "valid": np.ones(y.shape, bool)}


def test_fit_log_dir_writes_the_jax_rows(tmp_path, monkeypatch):
    from msau_tpu.config import ModelConfig as OModelConfig
    from msau_tpu.config import TrainConfig as OTrainConfig
    from msau_tpu.train.trainer import Trainer as OTrainer
    from msau_tpu_torch.config import ModelConfig, TrainConfig
    from msau_tpu_torch.train.trainer import Trainer

    # TensorBoard events are optional in both loggers; importing their
    # writer loads TensorFlow where it is installed
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    kw = dict(optimizer="rmsprop", learning_rate=1e-3, masked_loss=False,
              batch_steps_per_epoch=2)
    logs = {}
    for name, trainer in (
            ("ours", Trainer(ModelConfig(**CFG), TrainConfig(**kw),
                             device="cpu")),
            ("jax", OTrainer(OModelConfig(**CFG), OTrainConfig(**kw)))):
        trainer.init_state(np.zeros((1, 8, 8, 3), np.float32))
        trainer.fit(_Provider(), epochs=2, log_fn=lambda s: None,
                    log_dir=str(tmp_path / name))
        logs[name] = [json.loads(l) for l in
                      (tmp_path / name / "metrics.jsonl").read_text().splitlines()]
    shape = lambda rows: [(r["step"], sorted(r)) for r in rows]
    assert shape(logs["ours"]) == shape(logs["jax"])
    assert shape(logs["ours"]) == [
        (2, ["epoch", "step", "train/accuracy", "train/loss"]),
        (2, ["step", "val/accuracy", "val/loss"]),
        (4, ["epoch", "step", "train/accuracy", "train/loss"]),
        (4, ["step", "val/accuracy", "val/loss"])]
    assert all(np.isfinite(v) for r in logs["ours"] for v in r.values())
