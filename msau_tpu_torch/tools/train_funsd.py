"""CLI: FUNSD word-grid training on one device, or data-parallel on
``--devices`` ranks.

Loads the preprocessed pickles, splits 80/20 (seed 777), builds the model
from ``model_kwargs.json`` (any variant: ``"model": "msau_box"`` too) or
the default MSAU, trains with Adam (lr 1e-4, clip 1.0, masked CE), prints
per-epoch train / val / test micro metrics and the test classification
report, and checkpoints every ``--checkpoint_every`` epochs under the
``gen_prefix`` directory.  The grids are painted, and the model trained and
evaluated (forward and argmax), on ``--device`` (default ``cuda``).

``--devices N`` > 1 trains on a data mesh of N ranks
(``parallel.run_on_devices``: N local workers, rank r on ``cuda:r`` with
NCCL or on the CPU with gloo, or the group torchrun set up); every rank
builds the same batches from ``--seed`` and trains on its slice of each
``--batch_size`` batch, which must be a multiple of N (groups short of
it are dropped); rank 0 prints, evaluates and writes the checkpoints.

Usage:
  python -m msau_tpu_torch.tools.train_funsd --data_dir ./preprocessed \
      --ckptdir ./ckpt --epochs 300 [--features chargrid|bert|bow]
"""

import argparse
import dataclasses
import json
import os
import random
import time

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_dir", required=True)
    p.add_argument("--ckptdir", default="ckpt")
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--train_ratio", type=float, default=0.8)
    p.add_argument("--seed", type=int, default=777)
    p.add_argument("--model_kwargs_path", default=None)
    p.add_argument(
        "--features", default="chargrid", choices=["chargrid", "bert", "bow"],
        help="input grid: per-char one-hot (chargrid), or per-cell BERT/BOW "
             "feature boxes",
    )
    p.add_argument("--eval_every", type=int, default=1)
    p.add_argument("--checkpoint_every", type=int, default=10)
    p.add_argument("--max_eval_examples", type=int, default=100)
    p.add_argument("--flat_scales", type=int, default=0,
                   help="shallow scales through the flat-layout kernels")
    p.add_argument("--devices", type=int, default=1,
                   help="data-parallel ranks (local workers, or torchrun's)")
    p.add_argument("--batch_size", type=int, default=1,
                   help="global batch (reference entry A is 1); same-shape "
                        "grids are grouped, leftovers train at batch 1")
    p.add_argument("--device", default="cuda",
                   help="torch device that paints, trains and evaluates")
    args = p.parse_args(argv)
    if args.batch_size % args.devices:
        raise ValueError(f"--batch_size {args.batch_size} must be a multiple "
                         f"of --devices {args.devices}")
    from msau_tpu_torch.parallel.sharding import run_on_devices

    run_on_devices(_run, args.devices, args.device, args)


def _run(args):
    import torch

    from msau_tpu_torch.config import ModelConfig, TrainConfig
    from msau_tpu_torch.data import featgrid as fgd
    from msau_tpu_torch.data import wordgrid as wg
    from msau_tpu_torch.data.pages import FUNSD_LABEL_TO_ID
    from msau_tpu_torch.train.trainer import Trainer
    from msau_tpu_torch.utils import metrics as M
    from msau_tpu_torch.parallel.sharding import make_mesh, rank_device
    from msau_tpu_torch.utils.io import create_filename, gen_prefix

    device = rank_device(args.device)
    mesh = (make_mesh((args.devices,), ("data",), device.type)
            if args.devices > 1 else None)
    main_rank = mesh is None or torch.distributed.get_rank() == 0
    log = print if main_rank else (lambda *a, **k: None)
    random.seed(args.seed)
    train_ex, charset = wg.load_preprocessed(
        os.path.join(args.data_dir, "funsd_preprocess_train_word.pkl")
    )
    test_path = os.path.join(args.data_dir, "funsd_preprocess_test_word.pkl")
    test_ex = wg.load_preprocessed(test_path)[0] if os.path.exists(test_path) else []

    n_class = len(FUNSD_LABEL_TO_ID) + 1  # labels shifted by +1, 0 = ignore
    if args.model_kwargs_path:
        with open(args.model_kwargs_path) as f:
            mc = ModelConfig.from_model_kwargs(json.load(f))
    else:
        mc = ModelConfig(
            model="msau", final_act="softmax", feat_root=8, scale_space_num=4,
            res_depth=2, n_class=n_class, img_channels=charset.n_token,
            flat_scales=args.flat_scales,
        )
        if main_rank:
            os.makedirs(args.ckptdir, exist_ok=True)
            with open(os.path.join(args.ckptdir, "model_kwargs.json"),
                      "w") as f:
                json.dump(mc.to_model_kwargs(), f)

    idx = list(range(len(train_ex)))
    random.shuffle(idx)
    cut = int(len(idx) * args.train_ratio)
    tr_idx, val_idx = idx[:cut], idx[cut:]
    log(f"train {len(tr_idx)} / val {len(val_idx)} / test {len(test_ex)}")

    # rasterize once (grids are deterministic in the word-grid path)
    def featurize(ex):
        if args.features == "chargrid":
            return wg.rasterize_wordgrid(ex, charset, device=device)
        if args.features == "bow":
            feats, _ = wg.bow_features(ex.line_texts)
        else:
            feats = wg.sentence_embedding_features(ex.line_texts)
        return fgd.rasterize_feature_example(ex, feats, style="box",
                                             device=device)

    def make_batches(examples):
        return [{k: v[None] for k, v in featurize(ex).items()}
                for ex in examples]

    train_batches = make_batches([train_ex[i] for i in tr_idx])
    # non-chargrid features change the input width; fix up the model config
    feat_dim = train_batches[0]["input"].shape[-1]
    if mc.img_channels != feat_dim:
        mc = dataclasses.replace(mc, img_channels=feat_dim)
    val_batches = make_batches([train_ex[i] for i in val_idx])
    test_batches = make_batches(test_ex)

    if args.batch_size > 1:
        by_shape = {}
        for b in train_batches:
            by_shape.setdefault(b["input"].shape, []).append(b)
        grouped = []
        for items in by_shape.values():
            for i in range(0, len(items), args.batch_size):
                chunk = items[i : i + args.batch_size]
                if len(chunk) == args.batch_size:
                    grouped.append(
                        {k: np.concatenate([c[k] for c in chunk]) for k in chunk[0]}
                    )
                elif args.devices == 1:
                    grouped.extend(chunk)  # leftover singles still train
        log(f"grouped into {len(grouped)} batches of <= {args.batch_size}")
        train_batches = grouped

    tc = TrainConfig(
        optimizer="adam", learning_rate=args.lr, lr_decay_staircase=False,
        grad_clip_norm=1.0, masked_loss=True, seed=args.seed,
    )
    trainer = Trainer(mc, tc, mesh=mesh, device=device)
    trainer.init_state(train_batches[0]["input"])
    prefix = gen_prefix("funsd", "msau", mc.feat_root, n_class)

    @torch.no_grad()
    def evaluate(batches, name, testing=False, max_n=None):
        labels, preds = [], []
        for bi, b in enumerate(batches):
            x = torch.as_tensor(b["input"], device=device)
            _, logits, _ = trainer.model(x)
            pred = logits[0].argmax(-1).cpu().numpy()
            lab = b["label"][0]
            keep = lab != 0
            pr = pred[keep]
            if testing:
                pr = np.where(pr == 0, FUNSD_LABEL_TO_ID["other"] + 1, pr)
            labels.append(lab[keep])
            preds.append(pr)
            if max_n and bi + 1 >= max_n:
                break
        labels = np.concatenate(labels) if labels else np.zeros(0, int)
        preds = np.concatenate(preds) if preds else np.zeros(0, int)
        m = M.micro_metrics(labels, preds, drop_background=False)
        log(f"{name} acc: {m['acc']:.4f}")
        if testing and labels.size:
            names = ["bg"] + [
                k for k, _ in sorted(FUNSD_LABEL_TO_ID.items(), key=lambda kv: kv[1])
            ]
            log(M.classification_report(labels, preds, target_names=names,
                                          n_class=n_class))
        return m

    for epoch in range(args.epochs):
        t0 = time.time()
        total = 0.0
        for bi, b in enumerate(train_batches):
            trainer.state, mets = trainer.train_step(trainer.state, trainer.put_batch(b))
            total += float(mets["loss"])
            if bi % 10 == 0:
                log(f"batch {bi} loss {float(mets['loss']):.4f}")
        log(f"epoch {epoch}: avg loss {total / max(len(train_batches), 1):.4f} "
              f"({time.time() - t0:.1f}s)")
        if main_rank and (epoch + 1) % args.eval_every == 0:
            evaluate(train_batches, "Train", max_n=args.max_eval_examples)
            if val_batches:
                evaluate(val_batches, "Validation")
            if test_batches:
                evaluate(test_batches, "Test", testing=True)
        if main_rank and epoch % args.checkpoint_every == 0:
            trainer.save(create_filename(args.ckptdir, prefix, epoch))
    if main_rank:
        trainer.save(create_filename(args.ckptdir, prefix, args.epochs))
    log("Finished")


if __name__ == "__main__":
    main()
