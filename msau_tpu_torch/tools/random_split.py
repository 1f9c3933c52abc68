"""CLI: split a folder of JSONs into train.lst / val.lst.

Equivalent of scripts/random_split.py:8-40 (host copy of
``msau_tpu.tools.random_split``: the same lists for the same seed).

Usage:
  python -m msau_tpu_torch.tools.random_split --data_dir data --train_ratio 0.75
"""

import argparse
import glob
import os
import random


def random_split(data_dir: str, train_ratio: float, prefix: str = "", seed=None):
    rng = random.Random(seed)
    files = sorted(
        os.path.basename(f) for f in glob.glob(os.path.join(data_dir, "*.json"))
    )
    rng.shuffle(files)
    cut = int(train_ratio * len(files))
    return [prefix + f for f in files[:cut]], [prefix + f for f in files[cut:]]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_dir", required=True)
    p.add_argument("--train_ratio", type=float, default=0.75)
    p.add_argument("--prefix", default="")
    p.add_argument("--seed", type=int, default=None)
    args = p.parse_args(argv)
    train, val = random_split(args.data_dir, args.train_ratio, args.prefix, args.seed)
    for name, lst in (("train.lst", train), ("val.lst", val)):
        with open(os.path.join(args.data_dir, name), "w") as f:
            f.write("\n".join(lst) + "\n")
    print(f"train {len(train)} / val {len(val)}")


if __name__ == "__main__":
    main()
