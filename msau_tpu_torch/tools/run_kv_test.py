"""CLI: KV inference sweep over a folder of layout/OCR JSONs, on one device.

Equivalent of KVModel.run_test (inference/kv_model.py:341-387): per-file
predict, optional GT matching (IoU > 0.7), aggregate P/R/F1, CSV reports,
optional debug overlays (``--debug_images`` needs PIL).  ``--model_weight``
is a ``Trainer.save`` checkpoint (its directory or its ``train_state.pt``)
or a saved state dict; paint, the forward and the decode run on
``--device`` (default ``cuda``).  The flags are the JAX CLI's, plus
``--device``.

Usage:
  python -m msau_tpu_torch.tools.run_kv_test --input_dir data/test \
      --charset charset.txt --n_class 17 --model_weight out/model42 \
      --model_kwargs out/model_kwargs.json --out_dir results \
      [--label_dir data/labels]
"""

import argparse
import glob
import os


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--input_dir", required=True)
    p.add_argument("--charset", required=True)
    p.add_argument("--n_class", type=int, required=True)
    p.add_argument("--model_weight", required=True)
    p.add_argument("--model_kwargs", default=None)
    p.add_argument("--out_dir", default="results")
    p.add_argument("--label_dir", default=None)
    p.add_argument("--debug_images", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device that paints, runs the model and decodes")
    args = p.parse_args(argv)

    from msau_tpu_torch.infer.kv_model import KVModel
    from msau_tpu_torch.utils.io import write_csv_report_by_row

    os.makedirs(args.out_dir, exist_ok=True)
    kv = KVModel(device=args.device)
    kv.load(
        model_weight=args.model_weight,
        charset=args.charset,
        n_class=args.n_class,
        model_kwargs_path=args.model_kwargs,
    )
    files = sorted(glob.glob(os.path.join(args.input_dir, "*.json")))
    results, eval_results, summary = kv.run_test(
        files, out_dir=args.out_dir, label_dir=args.label_dir
    )
    for f, r in zip(files, results):
        print(os.path.basename(f), r)
    write_csv_report_by_row(os.path.join(args.out_dir, "kv_results.csv"), files, results)
    if summary:
        print(
            "Precision : {precision:.4f}   Recall : {recall:.4f}    "
            "F1-score : {f1:.4f}".format(**summary)
        )

    if args.debug_images:
        from msau_tpu_torch.utils.viz import visualize_kv_results

        for f in files:
            _, extras = kv.predict(f, return_maps=True)
            pred_map = extras["pred"].argmax(-1).cpu().numpy()
            img = visualize_kv_results(pred_map, extras["values"])
            img.save(
                os.path.join(
                    args.out_dir, os.path.basename(f).split(".")[0] + ".png"
                )
            )
    return results, eval_results, summary


if __name__ == "__main__":
    main()
