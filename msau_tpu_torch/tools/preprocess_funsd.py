"""CLI: FUNSD annotations -> preprocessed word-grid pickles + charset (the
train and test splits share the charset built from the train split).

Usage:
  python -m msau_tpu_torch.tools.preprocess_funsd \
      --train_dir dataset/training_data/annotations \
      --test_dir dataset/testing_data/annotations \
      --out_dir ./preprocessed
"""

import argparse
import os

from msau_tpu_torch.data import wordgrid as wg
from msau_tpu_torch.data.charset import Charset


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--train_dir", required=True)
    p.add_argument("--test_dir", default=None)
    p.add_argument("--out_dir", default=".")
    args = p.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    train, corpus = wg.preprocess_funsd_dir(args.train_dir)
    charset = Charset.from_corpus(corpus)
    wg.save_preprocessed(
        os.path.join(args.out_dir, "funsd_preprocess_train_word.pkl"), train, charset
    )
    charset.save(os.path.join(args.out_dir, "charset.txt"))
    print(f"train: {len(train)} pages, charset {charset.n_token} tokens")
    if args.test_dir:
        test, _ = wg.preprocess_funsd_dir(args.test_dir)
        wg.save_preprocessed(
            os.path.join(args.out_dir, "funsd_preprocess_test_word.pkl"), test, charset
        )
        print(f"test: {len(test)} pages")


if __name__ == "__main__":
    main()
