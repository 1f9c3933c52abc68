"""End-to-end demo on the PyTorch/CUDA port: train a small MSAU on one
synthetic document, then run the full KV extraction pipeline and score it.

Every layer of the port in one file:
  page JSON -> chargrid rasterization (paint kernel) -> MSAU training
  -> on-device decode (CCL kernel) -> field strings -> IoU-matched P/R/F1.

Run:  python examples/end_to_end_kv_torch.py [--device cuda|cpu]
Expected: F1 = 1.0 after 120 training steps.
"""

import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from msau_tpu_torch import InferConfig, ModelConfig  # noqa: E402
from msau_tpu_torch.data.pages import load_label_json_page  # noqa: E402
from msau_tpu_torch.infer.kv_model import KVModel  # noqa: E402
from msau_tpu_torch.infer.schema import FieldSchema  # noqa: E402
from msau_tpu_torch.models.msau import build_model  # noqa: E402
from msau_tpu_torch.tools.corpus_eval import (  # noqa: E402
    make_optimizer,
    make_step,
    relabel,
    training_example,
)

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "..", "tests", "fixtures", "kv_sample.json")
CHARS = "".join(sorted(set(
    "Bank NameFirst National Account 0123456789Alexandra Example Savings")))
N_CLASS = 9


def schema() -> FieldSchema:
    return FieldSchema(
        class_names=tuple(
            ["NUL"] + [f"{p}_f{i}" for i in range(1, 5) for p in ("k", "v")]
        )[:N_CLASS],
        multiple_lines_fields=(),
    )


def setup(device, charset_dir: str):
    """Write the charset under ``charset_dir``, load a KVModel on
    ``device`` and rasterize the training page -> (kv, x [H, W, V], label
    [H, W]), the page's classes = value id + 1."""
    charset_path = os.path.join(charset_dir, "charset.txt")
    with open(charset_path, "w") as f:
        f.write(CHARS)
    kv = KVModel(infer_config=InferConfig(n_class=N_CLASS), schema=schema(),
                 device=device)
    kv.load(charset=charset_path, n_class=N_CLASS)
    x, label = training_example(kv, FIXTURE)
    return kv, x, label


def build(kv):
    """The demo's model on ``kv``'s device and its step (clip 1.0, Adam
    2e-3, the class-weighted ``unet_loss``)."""
    mc = ModelConfig(
        img_channels=kv.charset.n_token, n_class=N_CLASS,
        scale_space_num=3, res_depth=1, feat_root=8, num_blocks=2,
    )
    model = build_model(mc, torch.Generator().manual_seed(0)).to(kv.device)
    return mc, model, make_step(model, make_optimizer(2e-3), N_CLASS)


def main(device="cuda", steps: int = 120, timings=None) -> float:
    """Train ``steps`` steps on the fixture page, serve it and return the
    field F1.  ``timings``: a dict that receives "train_ms_per_step" (host
    clock over the steps, closed by a fetch of the last loss)."""
    with tempfile.TemporaryDirectory(prefix="msau_demo_") as tmp:
        kv, x, label = setup(device, tmp)
        print(f"rasterized {x.shape[0]}x{x.shape[1]}x{x.shape[-1]}, classes "
              f"{np.unique(label.cpu().numpy())}")
        mc, model, step = build(kv)
        xb, yb = x[None], label[None]
        t0 = time.perf_counter()
        for i in range(steps):
            loss, metrics = step(xb, yb)
            if i % 30 == 0:
                print(f"step {i}: loss {float(loss):.4f} "
                      f"acc {float(metrics['accuracy']):.3f}")
        float(loss)
        if timings is not None:
            timings["train_ms_per_step"] = (
                (time.perf_counter() - t0) * 1e3 / max(steps, 1))

        # -- infer + evaluate ---------------------------------------------
        kv.model_config = mc
        kv.set_model(model)
        page = relabel(load_label_json_page(FIXTURE))
        results, _ = kv.predict(page)
        print("extracted fields:", {k: v for k, v in results.items() if v})
        ev = [dict(num_pred=0, num_correct=0, num_label=0)
              for _ in range(N_CLASS)]
        kv.predict(page, label_path=FIXTURE, eval_results=ev)
    nc = sum(e["num_correct"] for e in ev)
    nl = sum(e["num_label"] for e in ev)
    npd = sum(e["num_pred"] for e in ev)
    p = nc / max(npd, 1)
    r = nc / max(nl, 1)
    f1 = 2 * p * r / max(p + r, 1e-9)
    print(f"field eval: P={p:.2f} R={r:.2f} F1={f1:.2f}")
    return f1


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device that paints, trains and serves")
    f1 = main(ap.parse_args().device)
    assert f1 > 0.9, f"demo should reach F1~1.0, got {f1}"
    print("OK")
