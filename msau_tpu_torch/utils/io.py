"""Checkpoint naming, list reading and CSV reports (port of the host half
of ``msau_tpu.utils.io``; checkpoints themselves are ``Trainer.save`` and
``utils.checkpoint``).  Naming follows the reference's io_utils scheme:
``<ckptdir>/<dataset>[_<name>]_<method>_h<hidden>_o<out>/<epoch>``.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional, Sequence


def gen_prefix(dataset: str, method: str, hidden_dim: int, output_dim: int,
               name: Optional[str] = None) -> str:
    parts = [dataset]
    if name:
        parts.append(name)
    parts.append(method)
    parts.append(f"h{hidden_dim}_o{output_dim}")
    return "_".join(parts)


def create_filename(ckptdir: str, prefix: str, epoch: Optional[int] = None) -> str:
    """``ckptdir/prefix/<epoch or "best">``, the prefix directory created."""
    d = os.path.join(ckptdir, prefix)
    os.makedirs(d, exist_ok=True)
    name = str(epoch) if epoch is not None else "best"
    return os.path.join(d, name)


def read_image_list(path: str, prefix: Optional[str] = None) -> List[str]:
    """One path per line; optional prefix join."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            out.append(os.path.join(prefix, line) if prefix else line)
    return out


def glob_folder(path: str, extension: str, use_dirname: bool = False) -> Dict[str, str]:
    """Recursive basename (or parent directory name) -> path map; the first
    path found for a name wins."""
    file_map: Dict[str, str] = {}
    for dirpath, _, filenames in os.walk(path):
        for fn in filenames:
            if fn.endswith(extension):
                base = (
                    os.path.basename(dirpath)
                    if use_dirname
                    else os.path.basename(fn).split(".")[0]
                )
                file_map.setdefault(base, os.path.join(dirpath, fn))
    return file_map


def write_csv_report_by_row(
    out_path: str,
    file_list: Sequence[str],
    kv_results: Sequence[Dict[str, str]],
) -> None:
    """One row per file, one column per field."""
    fields = sorted({k for r in kv_results for k in r})
    with open(out_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["file"] + fields)
        for path, result in zip(file_list, kv_results):
            w.writerow([os.path.basename(path)] + [result.get(k, "") for k in fields])


def write_csv_report_by_field(
    out_path: str,
    file_list: Sequence[str],
    kv_results: Sequence[Dict[str, str]],
) -> None:
    """Field-major listing: (field, file, value) rows."""
    with open(out_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["field", "file", "value"])
        for path, result in zip(file_list, kv_results):
            for k in sorted(result):
                w.writerow([k, os.path.basename(path), result[k]])
