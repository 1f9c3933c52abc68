"""End-to-end KV inference model — port of ``msau_tpu.infer.kv_model``.

``predict`` builds the box programs on the host, uploads them as ONE int32
buffer, and runs paint x3 -> one-hot -> MSAU forward -> device decode on
the model's device (the hand-written CUDA kernels on a card); ONE packed
int32 vector of decode tables comes back, and the host assembles the
strings.

Charset convention at inference: file contents prefixed with ' ' and '$',
blank index 1.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from msau_tpu_torch.config import InferConfig, ModelConfig
from msau_tpu_torch.data.charset import Charset
from msau_tpu_torch.data.pages import Line, Page, load_label_json_page
from msau_tpu_torch.data.rasterize import (
    build_chargrid_programs,
    pad_to_bucket,
    paint_boxes,
    round_up,
)
from msau_tpu_torch.infer.decode import (
    decode_fields_device,
    extract_values,
    pack_decode_out,
    unpack_decode_out,
)
from msau_tpu_torch.infer.schema import FieldSchema, post_process_kv
from msau_tpu_torch.models.msau import DTYPES, build_model, check_supported
from msau_tpu_torch.utils.checkpoint import read_params
from msau_tpu_torch.utils.transplant import flax_to_torch

INFER_SPECIALS = (" ", "$")


def _is_state_dict(params: Mapping) -> bool:
    return any(isinstance(v, torch.Tensor) for v in params.values())


def prepare_host(page: Page, charset: Charset, scale: float,
                 buckets: Sequence[int] = (256, 512, 1024)):
    """Host half of rasterization: box programs + padded paint inputs.
    Returns (progs, scaled_lines, paint_arrays, hb, wb)."""
    progs = build_chargrid_programs(
        page,
        charset,
        scale_min=scale,
        scale_max=scale,
        normalize_digits=True,
        char_w_cap_factor=1.2,
        pad_factor_fixed=3.0,
        label_style="box",
    )
    hb, wb = pad_to_bucket(progs.height, progs.width, buckets)
    cap = round_up(max(len(progs.char.values), 1), 512)
    char = progs.char.padded(cap)
    lcap = round_up(max(len(progs.line_id.values), 1), 512)
    lid = progs.line_id.padded(lcap)
    cid = progs.char_id.padded(lcap)
    arrays = (
        char.boxes, char.values, lid.boxes, lid.values,
        cid.boxes, cid.values,
    )
    # re-index scaled lines 1-based for decode bookkeeping
    scaled = [
        dataclasses.replace(l, id=i + 1) for i, l in enumerate(progs.scaled_lines)
    ]
    return progs, scaled, arrays, hb, wb


class KVModel:
    """Load -> predict, mirroring the reference API surface.

    ``device`` is required: the model never picks a device by itself.  The
    compute dtype is ``model_config.dtype`` ("float32" or "bfloat16");
    parameters are cast to it, probabilities come out in f32.
    """

    def __init__(
        self,
        model_config: Optional[ModelConfig] = None,
        infer_config: Optional[InferConfig] = None,
        schema: Optional[FieldSchema] = None,
        *,
        device,
    ):
        self.model_config = model_config
        self.cfg = infer_config or InferConfig()
        self.schema = schema or FieldSchema()
        self.device = torch.device(device)
        self.charset: Optional[Charset] = None
        self.model = None
        self.n_class = self.cfg.n_class

    # ------------------------------------------------------------------
    def load(
        self,
        model_weight: Optional[str] = None,
        charset: Optional[str] = None,
        n_class: Optional[int] = None,
        params=None,
        model_kwargs_path: Optional[str] = None,
        warmup=None,
        generator: Optional[torch.Generator] = None,
    ) -> "KVModel":
        """Load charset / config / weights.

        Weights come from ``params`` (a flax parameter tree with numpy
        leaves, or a torch state_dict), from ``model_weight`` (a
        ``torch.save``d state_dict, or a ``Trainer.save`` checkpoint
        directory or file), or are drawn fresh from ``generator``;
        with none of them the model stays unbuilt.  ``warmup``: bucket
        size(s) to run once before the first request.
        """
        if charset is not None:
            self.charset = Charset.from_file(charset, specials=INFER_SPECIALS)
        if n_class is not None:
            self.n_class = n_class
        # keep the field schema aligned with n_class: truncate a longer
        # default, or pad with generated k_/v_ names
        if self.schema.n_class != self.n_class:
            names = list(self.schema.class_names[: self.n_class])
            while len(names) < self.n_class:
                prefix = "k_" if len(names) % 2 == 1 else "v_"
                names.append(f"{prefix}f{(len(names) - 1) // 2 + 1}")
            self.schema = dataclasses.replace(
                self.schema,
                class_names=tuple(names),
                multiple_lines_fields=tuple(
                    c for c in self.schema.multiple_lines_fields if c < self.n_class
                ),
            )
        if model_kwargs_path is not None:
            with open(model_kwargs_path) as f:
                self.model_config = ModelConfig.from_model_kwargs(json.load(f))
        if self.model_config is None:
            if self.charset is None:
                raise ValueError("load needs a charset or a model_config")
            self.model_config = ModelConfig(
                img_channels=self.charset.n_token, n_class=self.n_class
            )
        check_supported(self.model_config)
        if model_weight is not None:
            params = read_params(model_weight)
        if params is not None or generator is not None:
            model = build_model(self.model_config,
                                generator or torch.Generator().manual_seed(0))
            if params is not None:
                sd = params if _is_state_dict(params) else flax_to_torch(params)
                model.load_state_dict(sd)
            self.set_model(model)
        if warmup is not None and self.model is not None:
            sizes = (warmup,) if isinstance(warmup, int) else tuple(warmup)
            for hb in sizes:
                self.warmup_bucket(hb)
        return self

    def set_model(self, model: torch.nn.Module) -> None:
        """Install ``model`` on this KVModel's device and compute dtype
        (parameters cast once: the same as casting at every use)."""
        dtype = DTYPES[self.model_config.dtype]
        self.model = model.to(device=self.device, dtype=dtype).eval()

    def warmup_bucket(self, hb: int, wb: Optional[int] = None) -> None:
        """Run a tiny synthetic page through ``predict`` at one bucket shape
        so the first real request finds allocator pools and cuDNN plans
        ready."""
        wb = wb or hb
        page = Page(
            lines=[Line(box=(10, 10, wb, 40), text="warm", label=2, value=1)],
            img_shape=(hb * 3, wb * 3),
        )
        self.predict(page, buckets=(hb,))

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Final-activation forward of NHWC ``x`` -> NHWC probabilities."""
        probs, _, _ = self.model(x)
        return probs

    # ------------------------------------------------------------------
    def _prepare_host(self, page: Page, buckets: Sequence[int] = (256, 512, 1024)):
        """Host half of rasterization (``prepare_host``) with this model's
        charset and scale."""
        if self.charset is None:
            raise ValueError("no charset loaded")
        return prepare_host(page, self.charset, self.cfg.scale, buckets)

    def _multiline_classes(self) -> Tuple[int, ...]:
        return tuple(
            sorted(
                c for c in self.schema.multiple_lines_fields
                if 2 <= c < self.n_class
            )
        )

    @torch.inference_mode()
    def _serve(self, buf: torch.Tensor, *, hb: int, wb: int, num_lines: int,
               cap: int, lcap: int):
        """paint x3 -> one-hot -> forward -> decode on ``buf``'s device;
        returns (packed tables, probs [H, W, C], chosen_class [H, W])."""
        o = 0
        cb = buf[o:o + cap * 4].view(cap, 4); o += cap * 4
        cv = buf[o:o + cap]; o += cap
        lb = buf[o:o + lcap * 4].view(lcap, 4); o += lcap * 4
        lv = buf[o:o + lcap]; o += lcap
        db = buf[o:o + lcap * 4].view(lcap, 4); o += lcap * 4
        dv = buf[o:o + lcap]
        ids = paint_boxes(cb, cv, hb, wb)
        line_id = paint_boxes(lb, lv, hb, wb)
        char_id = paint_boxes(db, dv, hb, wb)
        tokens = torch.arange(self.charset.n_token, dtype=torch.int32,
                              device=buf.device)
        x = (ids[..., None] == tokens).to(torch.float32)   # one-hot [H, W, V]
        probs, _, _ = self.model(x[None])
        dev = decode_fields_device(
            probs[0], line_id, char_id, self._multiline_classes(),
            n_class=self.n_class, num_lines=num_lines, k=8,
            min_area=self.cfg.min_component_area,
        )
        return pack_decode_out(dev), probs[0], dev["chosen_class"]

    # ------------------------------------------------------------------
    def predict(
        self, data, label_path: Optional[str] = None, eval_results=None,
        timings: Optional[Dict[str, float]] = None,
        return_maps: bool = True,
        buckets: Sequence[int] = (256, 512, 1024),
    ) -> Tuple[Dict[str, str], Dict]:
        """data: a Page, or a path to a layout/OCR JSON, or (json_path, img).

        ``timings``: optional dict filled with per-stage host wall times
        (ms): 'prep' (box programs + packing), 'device' (upload, device
        program and the packed fetch, which waits for the device),
        'strings' (host value assembly).

        ``return_maps=False`` is the serving protocol: extras omit the
        probability map 'pred' and the selected-class map 'chosen_class'
        (both [H, W] tensors left on the device).
        """
        if label_path is not None and eval_results is not None:
            raise NotImplementedError(
                "field evaluation (infer/evaluate.py) is not ported yet: "
                "ROADMAP Queue 1 item 8")
        if self.model is None:
            raise ValueError("no model loaded")
        if isinstance(data, tuple):
            data = data[0]
        page = data if isinstance(data, Page) else load_label_json_page(data)
        t0 = time.perf_counter()
        progs, scaled_lines, arrays, hb, wb = self._prepare_host(page, buckets)
        num_lines = round_up(max(len(scaled_lines), 1), 128)
        cap, lcap = arrays[1].shape[0], arrays[3].shape[0]
        buf = np.concatenate([np.asarray(a, np.int32).ravel() for a in arrays])
        t1 = time.perf_counter()
        # one host->device upload, one packed device->host fetch
        buf_dev = torch.from_numpy(buf).to(self.device)
        packed, pred, chosen = self._serve(
            buf_dev, hb=hb, wb=wb, num_lines=num_lines, cap=cap, lcap=lcap)
        packed_host = packed.cpu().numpy()
        t2 = time.perf_counter()
        host = unpack_decode_out(packed_host, self.n_class, 8, num_lines)
        values = extract_values(host, scaled_lines, self.schema)
        kv_results = post_process_kv(values, self.schema)
        if timings is not None:
            t3 = time.perf_counter()
            timings["prep"] = (t1 - t0) * 1e3
            timings["device"] = (t2 - t1) * 1e3
            timings["strings"] = (t3 - t2) * 1e3

        extras = {
            "values": values,
            "programs": progs,
            "scaled_lines": scaled_lines,
        }
        if return_maps:
            extras["pred"] = pred
            extras["chosen_class"] = chosen
        return kv_results, extras

    def predict_batch(self, pages, buckets=(256, 512, 1024)):
        raise NotImplementedError(
            "predict_batch is not ported yet: ROADMAP Queue 1 item 8")

    def run_test(self, list_inf, out_dir=None, label_dir=None, img_dir=None):
        raise NotImplementedError(
            "run_test is not ported yet: ROADMAP Queue 1 item 8")
