"""End-to-end KV inference model — port of ``msau_tpu.infer.kv_model``.

``predict`` builds the box programs on the host, uploads them as ONE int32
buffer, and runs paint x3 -> one-hot -> MSAU forward -> device decode on
the model's device (the hand-written CUDA kernels on a card); a model
trained on entry B's input (``img_channels`` = the training charset's
``n_token`` + 2) is served that input: the training charset's one-hot,
then the line-mask and char-sep planes painted by the training rule
(paint x5; the JAX package serves the one-hot alone); ONE packed
int32 vector of decode tables comes back, and the host assembles the
strings.  ``predict_batch`` groups pages by bucket and runs one forward and
one batched decode (one labelling launch) per group, with one packed [B, L]
fetch; ``predict(label_path=, eval_results=)`` and ``run_test`` count
field matches against labelled pages (``infer.evaluate``).

Charset convention at inference: file contents prefixed with ' ' and '$',
blank index 1 (the training pipeline's prefix is ``DEFAULT_SPECIALS``).
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from msau_tpu_torch.config import InferConfig, ModelConfig
from msau_tpu_torch.data.charset import Charset
from msau_tpu_torch.data.pages import Line, Page, load_label_json_page
from msau_tpu_torch.data.rasterize import (
    BoxProgram,
    assemble_chargrid_input,
    build_chargrid_programs,
    pad_to_bucket,
    paint_boxes,
    round_up,
    upload_programs,
)
from msau_tpu_torch.infer.decode import (
    decode_fields_device,
    extract_values,
    pack_decode_out,
    unpack_decode_out,
)
from msau_tpu_torch.infer.evaluate import accumulate_field_eval, read_json_gt
from msau_tpu_torch.infer.schema import FieldSchema, post_process_kv
from msau_tpu_torch.models.msau import DTYPES, build_model, check_supported
from msau_tpu_torch.utils.checkpoint import read_params
from msau_tpu_torch.utils.transplant import flax_to_torch

INFER_SPECIALS = (" ", "$")


def _is_state_dict(params: Mapping) -> bool:
    return any(isinstance(v, torch.Tensor) for v in params.values())


def prepare_host(page: Page, charset: Charset, scale: float,
                 buckets: Sequence[int] = (256, 512, 1024),
                 id_planes: bool = False):
    """Host half of rasterization: box programs + padded paint inputs.
    Returns (progs, scaled_lines, paint_arrays, hb, wb); paint_arrays are
    the (boxes, values) pairs of the char, line-id and char-id programs,
    then with ``id_planes`` those of the char-sep and line-mask ones."""
    progs = build_chargrid_programs(
        page,
        charset,
        scale_min=scale,
        scale_max=scale,
        normalize_digits=True,
        char_w_cap_factor=1.2,
        pad_factor_fixed=3.0,
        label_style="box",
        id_planes=id_planes,
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
    if id_planes:
        # every line-mask record is a line's, so lcap holds them
        sep, lm = progs.char_sep.padded(cap), progs.line_mask.padded(lcap)
        arrays += (sep.boxes, sep.values, lm.boxes, lm.values)
    # re-index scaled lines 1-based for decode bookkeeping
    scaled = [
        dataclasses.replace(l, id=i + 1) for i, l in enumerate(progs.scaled_lines)
    ]
    return progs, scaled, arrays, hb, wb


class KVModel:
    """Load -> predict -> run_test, mirroring the reference API surface.

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
        self.train_charset: Optional[Charset] = None
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
            self.train_charset = Charset.from_file(charset)
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
        charset, id_planes = self._input_charset()
        return prepare_host(page, charset, self.cfg.scale, buckets, id_planes)

    def _input_charset(self) -> Tuple[Charset, bool]:
        """(the charset whose ids are painted, whether the line-mask and
        char-sep planes follow its one-hot), by the model's width: a model
        as wide as the serving charset's one-hot is served that one-hot, as
        the JAX package serves; one as wide as entry B's training input
        (``train_generic``'s ``img_channels``: the training charset's
        one-hot, then the line-mask and char-sep planes) is served that
        input, with the training charset's ids.  Any other width raises."""
        c = self.model_config.img_channels
        if c == self.charset.n_token:
            return self.charset, False
        if (self.train_charset is not None
                and c == self.train_charset.n_token + 2):
            return self.train_charset, True
        n = self.charset.n_token
        raise ValueError(
            f"the model takes {c} input channels; the serving charset's "
            f"one-hot has {n}"
            + (f", entry B's training input {self.train_charset.n_token + 2}"
               if self.train_charset is not None else ""))

    def _multiline_classes(self) -> Tuple[int, ...]:
        return tuple(
            sorted(
                c for c in self.schema.multiple_lines_fields
                if 2 <= c < self.n_class
            )
        )

    def _paint(self, arrays, hb: int, wb: int):
        """ONE upload of ``prepare_host``'s paint arrays, then paint x3
        (x5 with the id planes) -> (model input [H, W, img_channels] f32,
        line_id [H, W], char_id [H, W])."""
        t = upload_programs([BoxProgram(b, v) for b, v in
                             zip(arrays[0::2], arrays[1::2])], self.device)
        line_id = paint_boxes(t[2], t[3], hb, wb)
        char_id = paint_boxes(t[4], t[5], hb, wb)
        n_token = self._input_charset()[0].n_token
        if len(t) > 6:
            x = assemble_chargrid_input(t[0], t[1], *t[6:], hb, wb, n_token)
        else:
            ids = paint_boxes(t[0], t[1], hb, wb)
            tokens = torch.arange(n_token, dtype=torch.int32,
                                  device=ids.device)
            x = (ids[..., None] == tokens).to(torch.float32)
        return x, line_id, char_id

    def _decode(self, probs, line_id, char_id, num_lines: int):
        return decode_fields_device(
            probs, line_id, char_id, self._multiline_classes(),
            n_class=self.n_class, num_lines=num_lines, k=8,
            min_area=self.cfg.min_component_area,
        )

    @torch.inference_mode()
    def _serve(self, arrays, *, hb: int, wb: int, num_lines: int):
        """upload, paint -> forward -> decode on the model's device;
        returns (packed tables, probs [H, W, C], chosen_class [H, W])."""
        x, line_id, char_id = self._paint(arrays, hb, wb)
        probs, _, _ = self.model(x[None])
        dev = self._decode(probs[0], line_id, char_id, num_lines)
        return pack_decode_out(dev), probs[0], dev["chosen_class"]

    @torch.inference_mode()
    def serve_group(self, x: torch.Tensor, line_id: torch.Tensor,
                    char_id: torch.Tensor, num_lines: int):
        """One bucket group of ``predict_batch``: a batched forward of
        ``x`` [B, H, W, V], then one batched decode -> (packed tables [B,
        L], probs [B, H, W, C])."""
        probs, _, _ = self.model(x)
        return pack_decode_out(self._decode(probs, line_id, char_id,
                                            num_lines)), probs

    def rasterize(self, page: Page, buckets: Sequence[int] = (256, 512, 1024)):
        """KV-variant chargrid on the model's device: digits normalized,
        box-filled line ids, char-position plane -> (model input [H, W,
        img_channels] f32, line_id, char_id, scaled lines, programs)."""
        progs, scaled, arrays, hb, wb = self._prepare_host(page, buckets)
        x, line_id, char_id = self._paint(arrays, hb, wb)
        return x, line_id, char_id, scaled, progs

    # ------------------------------------------------------------------
    def predict(
        self, data, label_path: Optional[str] = None, eval_results=None,
        timings: Optional[Dict[str, float]] = None,
        return_maps: bool = True,
        buckets: Sequence[int] = (256, 512, 1024),
    ) -> Tuple[Dict[str, str], Dict]:
        """data: a Page, or a path to a layout/OCR JSON, or (json_path, img).

        ``timings``: optional dict filled with per-stage host wall times
        (ms): 'prep' (box programs), 'device' (packing, upload, device
        program and the packed fetch, which waits for the device),
        'strings' (host value assembly).

        ``return_maps=False`` is the serving protocol: extras omit the
        probability map 'pred' ([H, W, C]) and the selected-class map
        'chosen_class' ([H, W]), both tensors left on the device.

        With ``label_path`` (a labelled page JSON) and ``eval_results``
        (per-class counter dicts), the page's field boxes are matched
        against the labels, brought into the chargrid's frame, and the
        counters updated (``accumulate_field_eval``); a label file that
        cannot be read counts nothing.
        """
        if self.model is None:
            raise ValueError("no model loaded")
        if isinstance(data, tuple):
            data = data[0]
        page = data if isinstance(data, Page) else load_label_json_page(data)
        t0 = time.perf_counter()
        progs, scaled_lines, arrays, hb, wb = self._prepare_host(page, buckets)
        num_lines = round_up(max(len(scaled_lines), 1), 128)
        t1 = time.perf_counter()
        # one host->device upload, one packed device->host fetch
        packed, pred, chosen = self._serve(
            arrays, hb=hb, wb=wb, num_lines=num_lines)
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
        if label_path is not None and eval_results is not None:
            offset = (progs.extent[0] - progs.pad, progs.extent[1] - progs.pad)
            try:
                correct = read_json_gt(label_path, scale=progs.scale,
                                       offset=offset)
            except IOError:
                correct = None
            if correct is not None:
                accumulate_field_eval(values, correct, eval_results,
                                      iou_threshold=self.cfg.iou_threshold)
        return kv_results, extras

    # ------------------------------------------------------------------
    def predict_batch(self, pages: Sequence, buckets=(256, 512, 1024)):
        """Batched serving: rasterize every page, group the pages by bucket
        shape, run one forward and one batched decode per group (``num_lines``
        the group's most lines, rounded up to 128), fetch the group's packed
        [B, L] tables at once, and assemble the strings page by page.

        Returns a list of (kv_results, values) in input order.
        """
        if self.model is None:
            raise ValueError("no model loaded")
        groups = collections.defaultdict(list)
        for i, page in enumerate(pages):
            if not isinstance(page, Page):
                page = load_label_json_page(page)
            x, line_id, char_id, scaled, _ = self.rasterize(page, buckets)
            groups[tuple(x.shape)].append((i, x, line_id, char_id, scaled))

        results: List = [None] * len(pages)
        for items in groups.values():
            nl = round_up(max(max(len(it[4]) for it in items), 1), 128)
            packed, _ = self.serve_group(
                torch.stack([it[1] for it in items]),
                torch.stack([it[2] for it in items]),
                torch.stack([it[3] for it in items]), nl)
            for (i, _, _, _, scaled), vec in zip(items, packed.cpu().numpy()):
                host = unpack_decode_out(vec, self.n_class, 8, nl)
                values = extract_values(host, scaled, self.schema)
                results[i] = (post_process_kv(values, self.schema), values)
        return results

    # ------------------------------------------------------------------
    def run_test(
        self,
        list_inf: Sequence[str],
        out_dir: Optional[str] = None,
        label_dir: Optional[str] = None,
        img_dir: Optional[str] = None,
    ):
        """Predict every page of ``list_inf``; with ``label_dir`` (labels
        named as the pages, ``<name>.json``) also count field matches and
        summarise them as precision, recall and F1 over all classes.
        ``out_dir`` and ``img_dir`` are accepted for the JAX signature and
        not used.  Returns (kv_results, eval_results, summary or None)."""
        eval_results = [
            {"num_pred": 0, "num_correct": 0, "num_label": 0}
            for _ in range(self.n_class)
        ]
        kv_results = []
        for file_path in list_inf:
            basename = os.path.basename(file_path).split(".")[0]
            label_path = (
                os.path.join(label_dir, basename + ".json") if label_dir else None
            )
            result, _ = self.predict(
                file_path, label_path=label_path, eval_results=eval_results
            )
            kv_results.append(result)

        summary = None
        if label_dir is not None:
            num_correct = sum(c["num_correct"] for c in eval_results)
            num_label = sum(c["num_label"] for c in eval_results)
            num_pred = sum(c["num_pred"] for c in eval_results)
            recall = num_correct / num_label if num_label else 0.0
            precision = num_correct / num_pred if num_pred else 0.0
            f1 = (
                2 * recall * precision / (recall + precision)
                if (recall + precision)
                else 0.0
            )
            summary = {"precision": precision, "recall": recall, "f1": f1}
        return kv_results, eval_results, summary
