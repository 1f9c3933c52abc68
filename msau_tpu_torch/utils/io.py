"""Checkpoint naming, rich checkpoints, list reading and CSV reports (port
of ``msau_tpu.utils.io``).  Naming follows the reference's io_utils
scheme: ``<ckptdir>/<dataset>[_<name>]_<method>_h<hidden>_o<out>/<epoch>``.

A rich checkpoint (``save_checkpoint`` / ``load_checkpoint``) is the
train state where ``Trainer.save`` writes it (``path/train_state.pt``,
``utils.checkpoint``), a JSON sidecar ``path + ".meta.json"`` with the
epoch and the config, and ``path + ".cg.npz"`` of auxiliary arrays: the
JAX package's names and contents (it stores the state with orbax).
"""

from __future__ import annotations

import csv
import json
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from msau_tpu_torch.utils.checkpoint import read_state, write_state


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


def save_checkpoint(
    path: str,
    state,
    config: Optional[Dict[str, Any]] = None,
    cg_dict: Optional[Dict[str, Any]] = None,
    epoch: int = -1,
) -> None:
    """Full checkpoint: the train state (``path/train_state.pt``), a JSON
    sidecar (epoch, config) and, when ``cg_dict`` holds any, an npz of its
    arrays that are not None."""
    path = os.path.abspath(path)
    write_state(path, state)
    meta = {"epoch": epoch, "config": config or {}}
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f)
    if cg_dict:
        np.savez_compressed(
            path + ".cg.npz",
            **{k: np.asarray(v) for k, v in cg_dict.items() if v is not None},
        )


def load_checkpoint(path: str, state_template):
    """-> (state, meta): the saved train state loaded into
    ``state_template`` in place (the template's devices and dtypes; a key
    or shape that differs raises ``ValueError``), and the sidecar's
    ``{"epoch", "config"}``, or ``{}`` where there is none."""
    path = os.path.abspath(path)
    state = read_state(path, state_template)
    meta = {}
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            meta = json.load(f)
    return state, meta


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
