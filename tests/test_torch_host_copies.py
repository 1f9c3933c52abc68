"""The port's copies of jax-free host code equal their originals: same
outputs on the fixtures and on synthetic pages (the originals live in
packages whose ``__init__`` imports JAX, so the port cannot import them)."""

import dataclasses
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest

from msau_tpu.data import charset as o_charset
from msau_tpu.data import pages as o_pages
from msau_tpu.data import rasterize as o_rast
from msau_tpu.data import synth as o_synth
from msau_tpu.data import wordgrid as o_wordgrid
from msau_tpu.infer import decode as o_decode
from msau_tpu.infer import evaluate as o_evaluate
from msau_tpu.infer import reading_order as o_ro
from msau_tpu.infer import schema as o_schema
from msau_tpu_torch.data import charset, pages, rasterize, synth, wordgrid
from msau_tpu_torch.infer import decode, evaluate, reading_order, schema

FIX = os.path.join(os.path.dirname(__file__), "fixtures")


def _progs_equal(a, b):
    for f in ("height", "width", "scale", "pad", "extent"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("char", "char_sep", "line_mask", "label", "line_id", "char_id"):
        np.testing.assert_array_equal(getattr(a, f).boxes, getattr(b, f).boxes)
        np.testing.assert_array_equal(getattr(a, f).values, getattr(b, f).values)
    assert [dataclasses.asdict(l) for l in a.scaled_lines] == \
        [dataclasses.asdict(l) for l in b.scaled_lines]


@pytest.mark.parametrize("style", ["box", "underline"])
@pytest.mark.parametrize("seed", [0, 3])
def test_chargrid_programs_match(style, seed):
    doc = synth.make_page(np.random.default_rng(seed), n_cols=2, rows_per_col=2)
    assert doc == o_synth.make_page(np.random.default_rng(seed), n_cols=2,
                                    rows_per_col=2)
    cs = charset.Charset(chars=" $" + synth.BENCH_CHARSET)
    ocs = o_charset.Charset(chars=" $" + o_synth.BENCH_CHARSET)
    kw = dict(scale_min=3.0, scale_max=3.0, normalize_digits=True,
              char_w_cap_factor=1.2, pad_factor_fixed=3.0, label_style=style)
    a = rasterize.build_chargrid_programs(pages.page_from_label_dict(doc), cs, **kw)
    b = o_rast.build_chargrid_programs(o_pages.page_from_label_dict(doc), ocs, **kw)
    _progs_equal(a, b)
    hb, wb = rasterize.pad_to_bucket(a.height, a.width, (256, 512, 1024))
    assert (hb, wb) == o_rast.pad_to_bucket(b.height, b.width, (256, 512, 1024))
    assert rasterize.round_up(a.char.values.size, 512) == \
        o_rast.round_up(b.char.values.size, 512)
    np.testing.assert_array_equal(
        rasterize.paint_boxes_numpy(a.line_id, hb, wb),
        o_rast.paint_boxes_numpy(b.line_id, hb, wb))


@pytest.mark.parametrize("bs,hw,n_class,channels", [(2, 64, 17, 64),
                                                    (3, 40, 5, 6)])
def test_structured_batch_matches(bs, hw, n_class, channels):
    a = synth.make_structured_batch(np.random.default_rng(0), bs, hw,
                                    n_class, channels)
    b = o_synth.make_structured_batch(np.random.default_rng(0), bs, hw,
                                      n_class, channels)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_page_loaders_and_charset_match(tmp_path):
    p = os.path.join(FIX, "kv_sample.json")
    a, b = pages.load_label_json_page(p), o_pages.load_label_json_page(p)
    assert [dataclasses.asdict(l) for l in a.lines] == \
        [dataclasses.asdict(l) for l in b.lines]
    f = os.path.join(FIX, "funsd_sample.json")
    a, b = pages.load_funsd_page(f), o_pages.load_funsd_page(f)
    assert [dataclasses.asdict(l) for l in a.lines] == \
        [dataclasses.asdict(l) for l in b.lines]
    corpus = a.texts
    c1, c2 = charset.Charset.from_corpus(corpus), o_charset.Charset.from_corpus(corpus)
    assert c1.chars == c2.chars
    np.testing.assert_array_equal(c1.encode("Date 12 ?", normalize_digits=True),
                                  c2.encode("Date 12 ?", normalize_digits=True))


def test_reading_order_and_schema_match():
    rng = np.random.default_rng(0)
    boxes = [{"box": [int(x), int(y), int(x) + 40, int(y) + 12]}
             for x, y in rng.integers(0, 300, (25, 2))]
    assert reading_order.sort_box_reading_order(boxes) == \
        o_ro.sort_box_reading_order(boxes)
    vals = [(f"t{i}", None, None, None) for i in range(17)]
    for compat in (False, True):
        assert schema.post_process_kv(vals, schema.FieldSchema(), compat) == \
            o_schema.post_process_kv(vals, o_schema.FieldSchema(), compat)


def test_extract_values_matches():
    """Same decode tables in, same FieldValues out (incl. the shared-line
    char-range slicing and multi-line joins)."""
    rng = np.random.default_rng(1)
    n_class, k, nl = 17, 8, 12
    tables = {
        "active": rng.random(n_class) < 0.7,
        "main_bbox": rng.integers(0, 50, (n_class, 4)),
        "alt_bbox": rng.integers(0, 50, (n_class, k, 4)),
        "alt_valid": rng.random((n_class, k)) < 0.3,
        "line_overlap": rng.random((n_class, nl)) < 0.3,
        "comp_per_line": rng.integers(0, 3, (n_class, nl)),
        "char_min": rng.integers(0, 4, (n_class, nl)),
        "char_max": rng.integers(0, 9, (n_class, nl)),
    }
    lines = [pages.Line(box=(int(x), int(y), int(x) + 30, int(y) + 8),
                        text=f"line {i} text", id=i + 1)
             for i, (x, y) in enumerate(rng.integers(0, 200, (nl - 1, 2)))]
    olines = [o_pages.Line(**dataclasses.asdict(l)) for l in lines]
    sch = schema.FieldSchema(multiple_lines_fields=(5, 11))
    osch = o_schema.FieldSchema(multiple_lines_fields=(5, 11))
    a = decode.extract_values(tables, lines, sch)
    b = o_decode.extract_values(tables, olines, osch)
    assert [tuple(v) for v in a] == [tuple(v) for v in b]
    vec = np.concatenate([np.asarray(tables[key], np.int32).ravel()
                          for key in decode._PACK_KEYS])
    ua = decode.unpack_decode_out(vec, n_class, k, nl - 1)
    ub = o_decode.unpack_decode_out(vec, n_class, k, nl - 1)
    for key in ub:
        np.testing.assert_array_equal(ua[key], ub[key])


def test_write_corpus_matches(tmp_path):
    """The same pages, paths and charset file from the same seed."""
    kw = dict(n_cols=2, rows_per_col=1)
    a = synth.write_corpus(str(tmp_path / "a"), 2, 3,
                           np.random.default_rng(11), **kw)
    b = o_synth.write_corpus(str(tmp_path / "b"), 2, 3,
                             np.random.default_rng(11), **kw)
    assert [len(x) for x in a[:2]] == [2, 3]
    for pa, pb in zip(a[0] + a[1] + [a[2]], b[0] + b[1] + [b[2]]):
        assert os.path.basename(pa) == os.path.basename(pb)
        with open(pa) as fa, open(pb) as fb:
            assert fa.read() == fb.read()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evaluate_matches(tmp_path, seed):
    """read_json_gt on a labelled synthetic page (scaled and offset) and
    accumulate_field_eval on predictions near, on and far from its boxes;
    the IoU helpers on random boxes."""
    rng = np.random.default_rng(seed)
    path = synth.write_corpus(str(tmp_path), 0, 1, rng, n_cols=2)[1][0]
    kw = dict(scale=0.37 + seed, offset=(11.5, -3.0))
    got, want = evaluate.read_json_gt(path, **kw), o_evaluate.read_json_gt(path, **kw)
    assert got == want and len(got) >= 3
    n_class = 17
    values = []
    for c in range(n_class):
        if c not in got or rng.random() < 0.2:
            values.append(decode.FieldValue("", None, None, None))
            continue
        gt = np.asarray(got[c][0][0])
        boxes = [list(map(int, gt + rng.integers(-j * 4, j * 4 + 1, 4)))
                 for j in range(int(rng.integers(1, 4)))]
        boxes.append(list(map(int, gt + [300, 0, 300, 0])))   # far off
        values.append(decode.FieldValue("x", boxes, None, None))
    counts = [{"num_pred": 0, "num_correct": 0, "num_label": 0}
              for _ in range(n_class)]
    ocounts = [dict(c) for c in counts]
    evaluate.accumulate_field_eval(values, got, counts, iou_threshold=0.7)
    o_evaluate.accumulate_field_eval(values, want, ocounts, iou_threshold=0.7)
    assert counts == ocounts
    assert 0 < sum(c["num_correct"] for c in counts) < \
        sum(c["num_pred"] for c in counts)
    for a, b in rng.integers(0, 60, (20, 2, 4)):
        a, b = sorted(a[:2]) + sorted(a[2:]), sorted(b[:2]) + sorted(b[2:])
        a, b = [a[0], a[2], a[1], a[3]], [b[0], b[2], b[1], b[3]]
        assert evaluate.rect_area(a) == o_evaluate.rect_area(a)
        assert evaluate.intersect_area(a, b) == o_evaluate.intersect_area(a, b)
        assert evaluate.iou_pred(a, b) == o_evaluate.iou_pred(a, b)


def test_port_imports_without_jax():
    """The serve path imports with JAX made unimportable."""
    code = ("import sys; sys.modules['jax'] = None; "
            "import msau_tpu_torch.infer.kv_model; "
            "assert not any(m == 'jax' or m.startswith('jax.') or "
            "m.startswith('flax') for m in sys.modules if sys.modules[m])")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_train_path_imports_without_jax():
    """The train path imports with JAX made unimportable."""
    code = ("import sys; sys.modules['jax'] = None; "
            "import msau_tpu_torch.train.trainer; "
            "assert not any(m == 'jax' or m.startswith('jax.') or "
            "m.startswith('flax') or m.startswith('optax') "
            "for m in sys.modules if sys.modules[m])")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("name", ["ModelConfig", "TrainConfig", "InferConfig",
                                  "DataConfig"])
def test_config_copies_match(name):
    """The port's config dataclasses: the original's field names, order and
    defaults, and the model_kwargs round trip."""
    from msau_tpu import config as o_config
    from msau_tpu_torch import config

    ours, orig = getattr(config, name), getattr(o_config, name)
    fields = [(f.name, f.default, f.default_factory)
              for f in dataclasses.fields(ours)]
    assert fields == [(f.name, f.default, f.default_factory)
                      for f in dataclasses.fields(orig)]
    assert dataclasses.asdict(ours()) == dataclasses.asdict(orig())
    if name == "ModelConfig":
        kw = {"featRoot": 16, "scale_space_num": 4, "n_class": 17,
              "max_box_sizes": 9, "num_blocks": 2, "unknown": 1}
        a, b = ours.from_model_kwargs(kw), orig.from_model_kwargs(kw)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.to_model_kwargs() == b.to_model_kwargs()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_char_records_copy_matches(seed):
    """Seeded lines (some empty) through the port's records (its numpy
    version, and the dispatch, which takes the C core where it is built)
    and the JAX package's numpy path."""
    from msau_tpu.native import _char_records_numpy
    from msau_tpu_torch.data.native import char_records, char_records_plain

    rng = np.random.default_rng(seed)
    n = 12
    x1, y1 = rng.integers(0, 400, n), rng.integers(0, 400, n)
    boxes = np.stack([x1, y1, x1 + rng.integers(1, 200, n),
                      y1 + rng.integers(1, 30, n)], 1).astype(np.int32)
    lens = rng.integers(0, 9, n)
    lens[seed] = 0
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    ids = rng.integers(0, 64, int(offsets[-1])).astype(np.int32)
    want = _char_records_numpy(boxes, offsets, ids, 1.2)
    for fn in (char_records_plain, char_records):
        got = fn(boxes, offsets, ids, 1.2)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        empty = fn(boxes[:2], np.zeros(3, np.int32), np.zeros(0, np.int32),
                   1.2)
        assert [e.shape for e in empty] == [(0, 5), (0,), (0,)]


# modules the walk below must reach (the box model, the extras, the word-
# and feature-grid data side, metrics and io, the FUNSD tools, entry B:
# augmentation, the pipeline, profiling, viz, the host helpers and the
# four CLIs, parallel/, the held-out accuracy tools, the end-to-end
# demo, loaded from examples/, the native rasterizer core and the
# reference-layout weights among them)
NEW_PORT_MODULES = (
    "msau_tpu_torch.ops.boxconv", "msau_tpu_torch.models.msau_box",
    "msau_tpu_torch.models.extras", "msau_tpu_torch.data.wordgrid",
    "msau_tpu_torch.data.featgrid", "msau_tpu_torch.utils.metrics",
    "msau_tpu_torch.utils.io", "msau_tpu_torch.tools.preprocess_funsd",
    "msau_tpu_torch.tools.train_funsd", "msau_tpu_torch.data.augment",
    "msau_tpu_torch.data.pipeline", "msau_tpu_torch.data.bbox",
    "msau_tpu_torch.data.cellgraph", "msau_tpu_torch.data.corners",
    "msau_tpu_torch.utils.profiling", "msau_tpu_torch.utils.viz",
    "msau_tpu_torch.tools.train_generic", "msau_tpu_torch.tools.run_kv_test",
    "msau_tpu_torch.tools.random_split",
    "msau_tpu_torch.tools.extract_training_data",
    "msau_tpu_torch.parallel", "msau_tpu_torch.parallel.sharding",
    "msau_tpu_torch.parallel.spatial", "msau_tpu_torch.tools.corpus_eval",
    "msau_tpu_torch.tools.accuracy_matrix", "end_to_end_kv_torch",
    "msau_tpu_torch.native", "msau_tpu_torch.utils.reference_weights")


def test_port_imports_nothing_of_jax_or_the_jax_package():
    """Every module of msau_tpu_torch (the tools too), chip_smoke and
    examples/end_to_end_kv_torch.py, imported in a fresh interpreter:
    neither jax nor any msau_tpu module gets loaded."""
    code = (
        "import importlib, importlib.util, pkgutil, sys\n"
        "import msau_tpu_torch\n"
        "for m in pkgutil.walk_packages(msau_tpu_torch.__path__, "
        "'msau_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "s = importlib.util.spec_from_file_location('end_to_end_kv_torch', "
        "'examples/end_to_end_kv_torch.py')\n"
        "sys.modules[s.name] = importlib.util.module_from_spec(s)\n"
        "s.loader.exec_module(sys.modules[s.name])\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'msau_tpu' or "
        "m.startswith('msau_tpu.'))\n"
        "assert not bad, bad\n"
        "print(' '.join(m for m in sys.modules "
        "if m.startswith('msau_tpu_torch') or m == 'end_to_end_kv_torch'))"
        "\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    loaded = set(proc.stdout.split())
    assert len(loaded) > 20
    assert set(NEW_PORT_MODULES) <= loaded, set(NEW_PORT_MODULES) - loaded


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wordgrid_records_copy_matches(seed, monkeypatch):
    """Seeded words (some empty) through the port's records (its numpy
    version, and the dispatch) and the JAX package's numpy path (its C core
    switched off)."""
    from msau_tpu import native as o_native
    from msau_tpu_torch.data.native import (
        wordgrid_records,
        wordgrid_records_plain,
    )

    monkeypatch.setattr(o_native, "_load", lambda: None)
    rng = np.random.default_rng(seed)
    n = 11
    boxes = np.stack([rng.uniform(0, 400, n), rng.uniform(0, 400, n),
                      rng.uniform(3, 120, n), rng.uniform(5, 30, n)], 1)
    lens = rng.integers(0, 9, n)
    lens[seed] = 0
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    ids = rng.integers(0, 64, int(offsets[-1])).astype(np.int32)
    geo = (float(boxes[:, 0].min()), float(boxes[:, 1].min()), 2.5,
           float(boxes[:, 3].min()))
    want = o_native.wordgrid_records(boxes, offsets, ids, *geo)
    for fn in (wordgrid_records_plain, wordgrid_records):
        got = fn(boxes, offsets, ids, *geo)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _params(fn):
    return [(p.name, p.kind, p.default)
            for p in inspect.signature(fn).parameters.values()]


@pytest.mark.parametrize("module,names", [
    ("data.wordgrid", ("preprocess_funsd_dir", "save_preprocessed",
                       "load_preprocessed", "wordgrid_programs",
                       "bow_features", "char_ngram_features",
                       "sentence_embedding_features")),
    ("data.featgrid", ("cell_unit_layout", "cell_index_programs")),
    ("utils.io", ("gen_prefix", "create_filename", "read_image_list",
                  "glob_folder", "write_csv_report_by_row",
                  "write_csv_report_by_field")),
    ("utils.metrics", ("micro_metrics", "confusion_matrix",
                       "confusion_matrix_device", "report_from_confusion",
                       "classification_report")),
])
def test_new_host_copies_keep_signatures(module, names):
    """The host copies of this slice take the originals' parameters (names,
    kinds, defaults); their outputs are pinned in test_torch_wordgrid,
    test_torch_featgrid and test_torch_tools."""
    import importlib

    ours = importlib.import_module(f"msau_tpu_torch.{module}")
    orig = importlib.import_module(f"msau_tpu.{module}")
    for name in names:
        assert _params(getattr(ours, name)) == _params(getattr(orig, name)), name
    ex = [f.name for f in dataclasses.fields(wordgrid.WordGridExample)]
    assert ex == [f.name for f in dataclasses.fields(o_wordgrid.WordGridExample)]


def test_save_label_json_matches(tmp_path):
    lines = [pages.Line(box=(3, 4, 50, 19), text="Total 1.20 €", label=2,
                        value=2),
             pages.Line(box=(3.5, 30, 60, 41.25), text="", label=0, value=0)]
    pages.save_label_json(str(tmp_path / "a.json"), (300, 200), lines)
    o_pages.save_label_json(str(tmp_path / "b.json"), (300, 200),
                            [o_pages.Line(**dataclasses.asdict(l))
                             for l in lines])
    assert (tmp_path / "a.json").read_bytes() == \
        (tmp_path / "b.json").read_bytes()
    back = pages.load_label_json_page(str(tmp_path / "a.json"))
    assert [l.box for l in back.lines] == [l.box for l in lines]


@pytest.mark.parametrize("seed", [0, 1])
def test_bbox_cellgraph_corners_copies_match(seed):
    """Seeded boxes through the port's bbox predicates and overlap filters,
    cell graph and corner targets, and the originals."""
    from msau_tpu.data import bbox as o_bbox
    from msau_tpu.data import cellgraph as o_cellgraph
    from msau_tpu.data import corners as o_corners
    from msau_tpu_torch.data import bbox, cellgraph, corners

    rng = np.random.default_rng(seed)
    xywh = np.concatenate([rng.integers(0, 200, (14, 2)),
                           rng.integers(2, 60, (14, 2))], 1).tolist()
    xywh.append(list(xywh[0]))                  # a duplicate
    xywh.append([xywh[1][0] + 1, xywh[1][1] + 1, 2, 2])   # contained
    for a in xywh:
        for b in xywh:
            for name in ("check_intersect_bbox", "get_intersect_range_horizontal_proj",
                         "get_intersect_range_vertical_proj",
                         "check_bbox_contains_each_other",
                         "check_bbox_almost_contains_each_other"):
                assert getattr(bbox, name)(a, b) == getattr(o_bbox, name)(a, b)
    assert bbox.get_min_bbox_contains_all(xywh) == \
        o_bbox.get_min_bbox_contains_all(xywh)
    corners_xyxy = [[x, y, x + w, y + h] for x, y, w, h in xywh]
    for idx in (False, True):
        assert bbox.filter_overlap_boxes(corners_xyxy, idx) == \
            o_bbox.filter_overlap_boxes(corners_xyxy, idx)
        assert bbox.filter_overlap_boxes_bigger(corners_xyxy, 0.5, 4, idx) == \
            o_bbox.filter_overlap_boxes_bigger(corners_xyxy, 0.5, 4, idx)
    arr = np.asarray(xywh, np.float64)
    adj = cellgraph.build_adjacency(arr, chunk=5)
    np.testing.assert_array_equal(adj, o_cellgraph.build_adjacency(arr, chunk=5))
    assert adj.any()
    assert cellgraph.neighbor_lists(adj) == o_cellgraph.neighbor_lists(adj)
    texts = [f"c{i}" for i in range(len(xywh))]
    assert [dataclasses.asdict(c) for c in cellgraph.get_list_cells(xywh, texts)] \
        == [dataclasses.asdict(c) for c in o_cellgraph.get_list_cells(xywh, texts)]
    boxes = {i: (b, int(rng.integers(0, 3)), "t", None, [])
             for i, b in enumerate(corners_xyxy)}
    got = corners.corner_targets(boxes, (260, 260), (64, 64))
    want = o_corners.corner_targets(boxes, (260, 260), (64, 64))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for det in ((10.0, 20.0), (3.0, 90.0)):
        assert corners.gaussian_radius(det) == o_corners.gaussian_radius(det)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_augment_host_functions_match(seed):
    """The host halves of augmentation draw the same numbers from the same
    Generator: affine matrices, elastic fields, rotations and canvases."""
    from msau_tpu.data import augment as o_aug
    from msau_tpu_torch.data import augment as aug

    shape = ((64, 80), (512, 512), (130, 97))[seed]
    got = [aug.random_affine_matrix(shape, 0.025, np.random.default_rng(seed)),
           *aug.elastic_fields(shape, 2e-4, 3e-4, np.random.default_rng(seed))]
    want = [o_aug.random_affine_matrix(shape, 0.025,
                                       np.random.default_rng(seed)),
            *o_aug.elastic_fields(shape, 2e-4, 3e-4,
                                  np.random.default_rng(seed))]
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for flags in (dict(rotate=True, rotate_mod90=False),
                  dict(rotate=False, rotate_mod90=True),
                  dict(rotate=False, rotate_mod90=False)):
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        for _ in range(4):
            assert aug.sample_rotation(r1, **flags) == \
                o_aug.sample_rotation(r2, **flags)
    for angle in (0.0, 90.0, -13.5, 20.0, 180.0):
        rot = aug.rotated_canvas(*shape, angle)
        assert rot == o_aug.rotated_canvas(*shape, angle)
        np.testing.assert_array_equal(aug.rotation_matrix(shape, rot, angle),
                                      o_aug.rotation_matrix(shape, rot, angle))


def test_rasterlib_source_is_a_byte_copy():
    """The port's C core is the JAX package's source, byte for byte."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "msau_tpu", "native", "rasterlib.c"),
              "rb") as a, open(os.path.join(root, "msau_tpu_torch", "native",
                                            "rasterlib.c"), "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("scale_space_num,res_depth", [(2, 1), (4, 2)])
def test_reference_converter_copy_matches(scale_space_num, res_depth):
    """The port's torch_state_dict_to_flax: the original's rules and
    patterns, and its output leaf for leaf on a seeded reference-layout
    state dict (tests/test_torch_reference_migration.py holds the forward
    and the errors)."""
    from msau_tpu.utils import transplant as o_transplant
    from msau_tpu_torch.config import ModelConfig
    from msau_tpu_torch.utils import transplant
    from msau_tpu_torch.utils.reference_weights import reference_state_dict

    assert [(p.pattern, t, k) for p, t, k in transplant._RULES] == \
        [(p.pattern, t, k) for p, t, k in o_transplant._RULES]
    for name in ("_PREFIX", "_BLOCK_RE", "_END_RE"):
        a, b = getattr(transplant, name), getattr(o_transplant, name)
        assert getattr(a, "pattern", a) == getattr(b, "pattern", b), name
    w = np.random.default_rng(0).normal(size=(6, 4, 3, 3)).astype(np.float32)
    for fn in ("_conv_kernel", "_deconv_kernel"):
        np.testing.assert_array_equal(getattr(transplant, fn)(w),
                                      getattr(o_transplant, fn)(w))
    sd = reference_state_dict(ModelConfig(
        img_channels=6, n_class=4, feat_root=4, scale_space_num=scale_space_num,
        res_depth=res_depth, num_blocks=3), seed=1)
    got = transplant.torch_state_dict_to_flax(sd, scale_space_num)
    want = o_transplant.torch_state_dict_to_flax(sd, scale_space_num)

    def leaves(t, pre=()):
        for k, v in t.items():
            yield from (leaves(v, pre + (k,)) if isinstance(v, dict)
                        else [(pre + (k,), v)])

    got, want = dict(leaves(got)), dict(leaves(want))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
