"""Held-out accuracy point: train on a synthetic multi-page KV corpus and
report field-level P/R/F1 on unseen pages (port of
``scripts/synthetic_corpus_eval.py``).

The corpus is written in the labeling-tool JSON format
(``data/synth.py:write_corpus``, rng 7); the model never sees the held-out
layouts or value strings.  Training pages are rasterized by the serving
rasterizer (``KVModel.rasterize``) with class = value + 1; the step is the
script's own (``unet_loss`` with background weight 0.02, clip 1.0 then
Adam).  The trained weights are served at ``flat_scales`` 0 in f32 through
``KVModel.run_test`` (field F1, IoU > 0.7 box matching), and the served
argmax maps give the pixel micro precision and recall.

The flags are the JAX script's, except that ``--cpu`` becomes ``--device``
(default ``cuda``): paint, training and serving run on that device.

Run:  python -m msau_tpu_torch.tools.corpus_eval \\
          [--quick | --smoke] [--device cuda|cpu] [--dtype f32|bf16] \\
          [--flat N] [--scales S] [--model msau|msau_box] [--seed K]
Prints one JSON line {"metric": "held-out synthetic corpus field F1", ...,
"precision", "recall", "f1"}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import tempfile
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from msau_tpu_torch.config import InferConfig, ModelConfig
from msau_tpu_torch.data.pages import load_label_json_page
from msau_tpu_torch.data.rasterize import round_up, upload_programs
from msau_tpu_torch.data.synth import write_corpus
from msau_tpu_torch.infer.kv_model import KVModel
from msau_tpu_torch.infer.schema import FieldSchema
from msau_tpu_torch.models.msau import build_model
from msau_tpu_torch.ops.paint import paint_boxes
from msau_tpu_torch.train.loss import unet_loss
from msau_tpu_torch.train.optimizer import Optimizer, clip_by_global_norm_
from msau_tpu_torch.utils.transplant import BOX_LEAVES

N_CLASS = 17
BG_WEIGHT = 0.02   # the class weight of the background


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="small corpus / few epochs")
    ap.add_argument("--smoke", action="store_true",
                    help="minimal corpus, 2 epochs")
    ap.add_argument("--device", default="cuda",
                    help="torch device that paints, trains and serves")
    ap.add_argument("--dtype", default="f32", choices=["f32", "bf16"])
    ap.add_argument("--flat", type=int, default=0,
                    help="ModelConfig.flat_scales (channel-major fast path)")
    ap.add_argument("--epochs", type=int, default=0, help="override epochs")
    ap.add_argument("--seed", type=int, default=0,
                    help="model-init seed (the corpus stays fixed, so seed "
                    "sweeps estimate training-run variance)")
    ap.add_argument("--train_pages", type=int, default=0)
    ap.add_argument("--test_pages", type=int, default=0,
                    help="held-out pages (50 give ~400 fields)")
    ap.add_argument("--model", default="msau", choices=["msau", "msau_box"],
                    help="msau_box = the BMSAU box-convolution variant")
    ap.add_argument("--num_boxes", type=int, default=0,
                    help="msau_box: boxes per channel (default config: 3)")
    ap.add_argument("--max_box_size", type=int, default=0,
                    help="msau_box: coordinate clamp (default: 28)")
    ap.add_argument("--lr", type=float, default=0.0,
                    help="override the Adam learning rate (default 2e-3)")
    ap.add_argument("--scales", type=int, default=3,
                    help="scale_space_num (flat 3 needs 4: the deepest "
                    "attention scale stays unflattened)")
    ap.add_argument("--box_lr", type=float, default=0.0,
                    help="msau_box: decoupled LR for the box coordinate "
                    "params (ybox/xbox); default = --lr")
    return ap


# ---------------------------------------------------------------- data
def relabel(page):
    """Each line's class = its value id + 1 (0 stays background)."""
    return dataclasses.replace(page, lines=[
        dataclasses.replace(l, label=(l.value + 1 if l.value > 0 else 0))
        for l in page.lines])


def training_example(kv, path) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x [H, W, n_token] f32, label [H, W] int32) of a labelled page on
    ``kv``'s device: the serving rasterizer's chargrid, and the label
    program padded to a multiple of 128 boxes and painted."""
    page = relabel(load_label_json_page(path))
    x, _, _, _, progs = kv.rasterize(page)
    hb, wb = x.shape[:2]
    lab = progs.label.padded(round_up(max(len(progs.label.values), 1), 128))
    boxes, values = upload_programs([lab], x.device)
    return x, paint_boxes(boxes, values, hb, wb)


def make_batches(examples: Sequence, bs: int) -> List[Tuple]:
    """Group (x, label) examples by shape in first-seen order and cut each
    group into chunks of ``bs`` -> [(x [B, H, W, C], label [B, H, W])]."""
    by_shape: Dict[tuple, list] = {}
    for x, y in examples:
        by_shape.setdefault(tuple(x.shape), []).append((x, y))
    batches = []
    for items in by_shape.values():
        for i in range(0, len(items), bs):
            chunk = items[i:i + bs]
            batches.append((torch.stack([c[0] for c in chunk]),
                            torch.stack([c[1] for c in chunk])))
    return batches


# ---------------------------------------------------------------- train
def class_weights(n_class: int, device) -> torch.Tensor:
    return torch.tensor([BG_WEIGHT] + [1.0] * (n_class - 1),
                        dtype=torch.float32, device=device)


def loss_and_grads(model, xb, yb, cw):
    """The script's loss on one batch, in train mode -> (loss, metrics,
    {name: gradient}).  At ``flat_scales > 0`` the logits come out NCHW
    and the loss reads channel axis 1 (no NHWC transpose)."""
    flat = model.config.flat_scales > 0
    model.train()
    names, params = zip(*model.named_parameters())
    _, logits, aux = model(xb, logits_layout="NCHW" if flat else "NHWC")
    loss, metrics = unet_loss(logits, yb, aux_logits=aux, class_weights=cw,
                              channel_axis=1 if flat else -1)
    # the last stage's attention feeds nothing: zero gradients, as jax.grad
    grads = torch.autograd.grad(loss, params, materialize_grads=True)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            dict(zip(names, grads)))


class BoxLrOptimizer:
    """``optax.chain(clip_by_global_norm(clip), multi_transform({"box":
    adam(box_lr), "rest": adam(lr)}))``: one clip over every gradient, then
    a separate Adam for the box coordinates (``ybox`` / ``xbox`` leaves)
    and for the rest."""

    def __init__(self, lr: float, box_lr: float, clip_norm: float = 1.0):
        self.clip_norm = clip_norm
        self.groups = {"box": Optimizer("adam", box_lr),
                       "rest": Optimizer("adam", lr)}

    @staticmethod
    def group(name: str) -> str:
        return "box" if name.rsplit(".", 1)[-1] in BOX_LEAVES else "rest"

    def _split(self, tree: Dict) -> Dict[str, Dict]:
        out = {g: {} for g in self.groups}
        for k, v in tree.items():
            out[self.group(k)][k] = v
        return out

    def init(self, params: Dict[str, torch.Tensor]) -> Dict:
        return {g: self.groups[g].init(p)
                for g, p in self._split(params).items()}

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: Dict,
               params: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One update of ``params`` and ``state`` in place (``grads`` is
        consumed); returns the raw gradients' global norm."""
        norm = clip_by_global_norm_(list(grads.values()), self.clip_norm)
        g, p = self._split(grads), self._split(params)
        for name, opt in self.groups.items():
            if p[name]:
                opt.update(g[name], state[name], p[name])
        return norm


def make_optimizer(lr: float, box_lr: float = 0.0):
    """clip 1.0 then Adam(lr); with ``box_lr``, ``BoxLrOptimizer``."""
    if box_lr:
        return BoxLrOptimizer(lr, box_lr, clip_norm=1.0)
    return Optimizer("adam", lr, clip_norm=1.0)


def make_step(model, optimizer, n_class: int = N_CLASS):
    """(xb, yb) -> (loss, metrics): one step of the script's update on the
    model's own parameters (updated in place)."""
    params = dict(model.named_parameters())
    state = optimizer.init(params)
    cw = class_weights(n_class, next(iter(params.values())).device)

    def step(xb, yb):
        loss, metrics, grads = loss_and_grads(model, xb, yb, cw)
        optimizer.update(grads, state, params)
        return loss, metrics

    return step


# ---------------------------------------------------------------- metrics
def box_drift(init: Dict[str, torch.Tensor],
              trained: Dict[str, torch.Tensor]) -> Tuple[float, int]:
    """Mean over the box parameter tensors (a path part naming "box") of
    the RMS change from ``init`` to ``trained`` -> (drift, tensors)."""
    drifts = []
    for k, v0 in init.items():
        if any("box" in part.lower() for part in k.split(".")):
            d = trained[k].detach().float().cpu() - v0.float().cpu()
            drifts.append(float(torch.sqrt(torch.mean(d * d))))
    return (float(np.mean(drifts)) if drifts else 0.0), len(drifts)


def pixel_counts(pred: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """[tp, fn, fp] (int64, on the maps' device) of a served argmax map
    against its label: tp / fn over the label's non-background pixels, fp
    over the wrong non-background predictions."""
    nz = label != 0
    wrong = pred != label
    return torch.stack([(~wrong & nz).sum(), (wrong & nz).sum(),
                        (wrong & (pred != 0)).sum()])


def pixel_precision_recall(tp: int, fn: int, fp: int) -> Tuple[float, float]:
    return tp / max(tp + fp, 1), tp / max(tp + fn, 1)


# ---------------------------------------------------------------- the run
@dataclasses.dataclass
class EvalRun:
    """What ``run`` leaves: the JSON line, the unrounded summary, the
    epochs' mean losses and host seconds (each closed by its loss fetch),
    the KVModel serving the trained weights, the held-out pages (under
    ``out_dir``, with their labels), and the steps taken."""

    result: Dict
    summary: Dict[str, float]
    epoch_losses: List[float]
    epoch_seconds: List[float]
    kv: KVModel
    model: torch.nn.Module
    test_paths: List[str]
    out_dir: str
    steps: int


def run(argv=None) -> EvalRun:
    """Write the corpus, train, serve the held-out pages; prints the
    progress lines and the JSON line."""
    args = build_parser().parse_args(argv)
    quick = args.quick or args.smoke

    rng = np.random.default_rng(7)
    if args.smoke:
        n_train, n_test = 2, 1
    elif args.quick:
        n_train, n_test = 6, 3
    else:
        n_train, n_test = 40, 12
    n_train = args.train_pages or n_train
    n_test = args.test_pages or n_test
    out_dir = tempfile.mkdtemp(prefix="msau_corpus_")
    train_paths, test_paths, charset_path = write_corpus(
        out_dir, n_train, n_test, rng)

    dev = torch.device(args.device)
    kv = KVModel(infer_config=InferConfig(n_class=N_CLASS),
                 schema=FieldSchema(), device=dev)
    kv.load(charset=charset_path, n_class=N_CLASS)

    examples = [training_example(kv, p) for p in train_paths]
    batches = make_batches(examples, 2 if quick else 4)
    shapes = sorted({tuple(x.shape) for x, _ in examples})
    print(f"{len(examples)} train pages in {len(batches)} batches "
          f"(shapes: {shapes})")

    mc = ModelConfig(
        model=args.model,
        img_channels=kv.charset.n_token, n_class=N_CLASS,
        scale_space_num=args.scales, res_depth=2, feat_root=8,
        num_blocks=1 if quick else 2,
        dtype="bfloat16" if args.dtype == "bf16" else "float32",
        flat_scales=args.flat if args.model == "msau" else 0,
        **({"num_box_per_channel": args.num_boxes} if args.num_boxes else {}),
        **({"max_box_size": args.max_box_size} if args.max_box_size else {}),
    )
    model = build_model(mc, torch.Generator().manual_seed(args.seed)).to(dev)
    lr = args.lr or 2e-3
    step = make_step(model, make_optimizer(
        lr, args.box_lr if args.model == "msau_box" else 0.0))

    if args.epochs:
        epochs = args.epochs
    elif args.smoke:
        epochs = 2
    elif args.quick:
        epochs = 10
    else:
        epochs = 60
    epoch_losses, epoch_seconds = [], []
    for e in range(epochs):
        t0 = time.perf_counter()
        losses = []
        for xb, yb in batches:
            loss, metrics = step(xb, yb)
            losses.append(loss)
        # one fetch an epoch; the sum in float64 on the host, as the
        # script's running float sum
        epoch_losses.append(sum(torch.stack(losses).tolist()) / len(batches))
        epoch_seconds.append(time.perf_counter() - t0)
        if e % max(epochs // 6, 1) == 0:
            print(f"epoch {e}: loss {epoch_losses[-1]:.4f} "
                  f"acc {float(metrics['accuracy']):.3f}")
    print(f"trained in {sum(epoch_seconds):.1f}s")

    drift = None
    if args.model == "msau_box":
        init = build_model(mc, torch.Generator().manual_seed(args.seed))
        drift, n = box_drift(init.state_dict(), model.state_dict())
        print(f"box-coordinate RMS drift over training: {drift:.4f} "
              f"({n} box param tensors)")

    # serve through the unflattened f32 graph whatever the training layout;
    # the state_dict does not depend on flat_scales, so it drops straight in
    kv.model_config = dataclasses.replace(mc, flat_scales=0, dtype="float32")
    served = build_model(kv.model_config, torch.Generator().manual_seed(0))
    served.load_state_dict(model.state_dict())
    kv.set_model(served)
    _, _, summary = kv.run_test(test_paths, label_dir=out_dir)

    # per-pixel micro metrics on the held-out pages: non-background pixels
    # of the rasterized label against the served argmax map
    counts = torch.zeros(3, dtype=torch.int64, device=dev)
    for path in test_paths:
        x, label = training_example(kv, path)
        pred = torch.argmax(kv.forward(x[None])[0], dim=-1)
        counts += pixel_counts(pred, label)
    tp, fn, fp = counts.tolist()
    pix_p, pix_r = pixel_precision_recall(tp, fn, fp)
    print(f"pixel micro precision {pix_p:.4f} recall {pix_r:.4f}")
    result = {
        "metric": "held-out synthetic corpus field F1",
        "train_pages": n_train,
        "test_pages": n_test,
        "dtype": args.dtype,
        "flat_scales": args.flat,
        "epochs": epochs,
        "seed": args.seed,
        "model": args.model,
        "pixel_precision": round(pix_p, 4),
        "pixel_recall": round(pix_r, 4),
        **({"box_drift": round(drift, 5)} if drift is not None else {}),
        **{k: round(v, 4) for k, v in summary.items()},
    }
    print(json.dumps(result), flush=True)
    return EvalRun(result, summary, epoch_losses, epoch_seconds, kv, model,
                   test_paths, out_dir, epochs * len(batches))


def main(argv=None) -> float:
    """Run the protocol (``run``) and return the held-out field F1; the
    corpus directory is removed afterwards."""
    r = run(argv)
    shutil.rmtree(r.out_dir, ignore_errors=True)
    return r.summary["f1"]


if __name__ == "__main__":
    main()
