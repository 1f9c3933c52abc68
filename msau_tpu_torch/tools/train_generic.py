"""CLI: entry-B generic-document training from label JSONs, on one device
or data-parallel on ``--devices`` ranks.

Equivalent of the Trainer/DataGenerator pipeline
(model/training/trainer.py:57-207 + data_generator/data_generator_text.py):
threaded chargrid provider (host box programs in worker threads; paint and
augmentation on ``--device``), staircase LR (0.001 * 0.95^(epoch//10)),
0.5/0.5 aux loss (``unet_loss``), val sweep per epoch, best-loss
checkpointing under ``--output_path``.  The same flags as
``msau_tpu.tools.train_generic`` plus ``--device`` (default ``cuda``).

``--devices N`` > 1 trains on a data mesh of N ranks
(``parallel.run_on_devices``): outside torchrun the CLI starts N local
workers itself (rank r on ``cuda:r`` with NCCL, or on the CPU with gloo
under ``--device cpu``), under torchrun it joins the group torchrun set
up.  Every rank builds the same provider from the same seed (one worker
thread a split, so every rank draws the same sequence), pulls the same
global batch of ``devices * per_device_batch`` examples and trains on its
slice; rank 0 logs and writes the checkpoints.  So each rank paints and
augments the whole global batch: its data work a step grows N times, on
one worker thread a split where a single device has ``num_workers``.

Usage:
  python -m msau_tpu_torch.tools.train_generic --train_dir data/train \
      --val_dir data/val --charset charset.txt --n_classes 17 \
      --output_path ./out [--devices 4]
  torchrun --nproc_per_node 4 -m msau_tpu_torch.tools.train_generic ... \
      --devices 4
"""

import argparse
import glob
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--train_dir", required=True)
    p.add_argument("--val_dir", default=None)
    p.add_argument("--charset", required=True)
    p.add_argument("--n_classes", type=int, required=True)
    p.add_argument("--output_path", default="./out")
    p.add_argument("--epochs", type=int, default=250)
    p.add_argument("--batch_steps_per_epoch", type=int, default=1024)
    p.add_argument("--optimizer", default="rmsprop")
    p.add_argument("--learning_rate", type=float, default=0.001)
    p.add_argument("--restore_path", default=None)
    p.add_argument("--scale_min", type=float, default=2.0)
    p.add_argument("--scale_max", type=float, default=4.0)
    p.add_argument("--text_err", type=float, default=0.0)
    # augmentation (reference kwargs_dat flags, data_generator_text.py:58-73)
    p.add_argument("--affine", action="store_true")
    p.add_argument("--affine_value", type=float, default=0.025)
    p.add_argument("--elastic", action="store_true")
    p.add_argument("--elastic_value_x", type=float, default=0.0002)
    p.add_argument("--elastic_value_y", type=float, default=0.0002)
    p.add_argument("--rotate", action="store_true")
    p.add_argument("--rotate_mod90", action="store_true")
    p.add_argument("--feat_root", type=int, default=8)
    p.add_argument("--scale_space_num", type=int, default=6)
    p.add_argument("--res_depth", type=int, default=3)
    p.add_argument("--flat_scales", type=int, default=0,
                   help="shallow scales through the flat-layout kernels "
                        "(3 for the flagship)")
    p.add_argument("--devices", type=int, default=1,
                   help="data-parallel ranks (local workers, or torchrun's)")
    p.add_argument("--per_device_batch", type=int, default=1,
                   help="examples per step; same-bucket pages are grouped "
                        "by the BatchingProvider")
    p.add_argument("--device", default="cuda",
                   help="torch device that paints, augments and trains")
    return p


def configs(args, charset):
    """(DataConfig, ModelConfig, TrainConfig) of a parsed command line."""
    from msau_tpu_torch.config import DataConfig, ModelConfig, TrainConfig

    dcfg = DataConfig(
        n_classes=args.n_classes,
        scale_min=args.scale_min,
        scale_max=args.scale_max,
        text_err=args.text_err,
        affine=args.affine,
        affine_value=args.affine_value,
        elastic=args.elastic,
        elastic_value_x=args.elastic_value_x,
        elastic_value_y=args.elastic_value_y,
        rotate=args.rotate,
        rotate_mod90=args.rotate_mod90,
    )
    mc = ModelConfig(
        img_channels=charset.n_token + 2,
        n_class=args.n_classes,
        feat_root=args.feat_root,
        scale_space_num=args.scale_space_num,
        res_depth=args.res_depth,
        flat_scales=args.flat_scales,
    )
    tc = TrainConfig(
        optimizer=args.optimizer,
        learning_rate=args.learning_rate,
        lr_decay_staircase=True,
        epochs=args.epochs,
        batch_steps_per_epoch=args.batch_steps_per_epoch,
        masked_loss=False,
        donate_state=False,
    )
    return dcfg, mc, tc


def train(args, log_dir=None, setup=None):
    """Run entry B for parsed ``args`` -> (trainer, history).  ``log_dir``
    goes to ``Trainer.fit`` (per-epoch scalars in ``metrics.jsonl``);
    ``setup(trainer, chargrid, provider)``, when given, is called before
    the first batch is pulled: ``chargrid`` is the ChargridProvider,
    ``provider`` what ``fit`` pulls from (the BatchingProvider around it,
    or itself at batch 1).  ``--devices`` > 1 needs the process group of
    ``args.devices`` ranks (``main`` sets it up)."""
    import dataclasses

    from msau_tpu_torch.data.charset import Charset
    from msau_tpu_torch.data.pipeline import BatchingProvider, ChargridProvider
    from msau_tpu_torch.parallel.sharding import make_mesh, rank_device
    from msau_tpu_torch.train.trainer import Trainer

    charset = Charset.from_file(args.charset)
    dcfg, mc, tc = configs(args, charset)
    mesh, seed, device = None, None, args.device
    if args.devices > 1:
        device = rank_device(args.device)
        mesh = make_mesh((args.devices,), ("data",), device.type)
        dcfg = dataclasses.replace(dcfg, num_workers=1)
        seed = tc.seed
    train_paths = sorted(glob.glob(os.path.join(args.train_dir, "*.json")))
    val_paths = (
        sorted(glob.glob(os.path.join(args.val_dir, "*.json")))
        if args.val_dir
        else None
    )
    global_batch = args.devices * args.per_device_batch
    trainer = Trainer(mc, tc, mesh=mesh, device=device)
    with ChargridProvider(train_paths, val_paths, charset, dcfg,
                          device=device, seed=seed) as inner:
        provider = (
            BatchingProvider(inner, global_batch) if global_batch > 1 else inner
        )
        if setup is not None:
            setup(trainer, inner, provider)
        first = provider.next_data("train")
        if first is None:
            raise RuntimeError("no training data")
        trainer.init_state(first["input"])
        history = trainer.fit(
            provider,
            output_path=args.output_path,
            epochs=args.epochs,
            batch_steps_per_epoch=args.batch_steps_per_epoch,
            restore_path=args.restore_path,
            log_dir=log_dir,
        )
    return trainer, history


def _train(args):
    train(args)


def main(argv=None):
    from msau_tpu_torch.parallel.sharding import run_on_devices

    args = build_parser().parse_args(argv)
    run_on_devices(_train, args.devices, args.device, args)


if __name__ == "__main__":
    main()
