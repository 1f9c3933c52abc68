"""The port's native rasterizer core (``msau_tpu_torch.native``): its
records against its numpy versions (``data.native.*_plain``) and against
the JAX package's core and numpy paths, on tests/test_native.py's random
lines over several seeds and on edge cases; where it is built (under
``build/``, never in the package); several processes at first use build it
once and each gets it; a failed build raises with the compiler's output;
no compiler means the numpy versions, said by ``native_available()``; and
the chargrid programs are the same with either backend.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import msau_tpu.native as jax_native
from msau_tpu_torch import native
from msau_tpu_torch.data import native as dn
from msau_tpu_torch.data import rasterize
from msau_tpu_torch.data.charset import Charset
from msau_tpu_torch.data.pages import load_funsd_page

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "fixtures" / "funsd_sample.json"


def _random_lines(seed, n_lines=30):
    """tests/test_native.py's generator: random line boxes, 0-15 chars a
    line (some empty)."""
    rng = np.random.default_rng(seed)
    boxes = np.zeros((n_lines, 4), np.int32)
    boxes[:, 0] = rng.integers(0, 200, n_lines)
    boxes[:, 2] = boxes[:, 0] + rng.integers(10, 120, n_lines)
    boxes[:, 1] = rng.integers(0, 300, n_lines)
    boxes[:, 3] = boxes[:, 1] + rng.integers(5, 15, n_lines)
    lens = rng.integers(0, 16, n_lines)
    off = np.zeros(n_lines + 1, np.int32)
    off[1:] = np.cumsum(lens)
    ids = rng.integers(1, 80, off[-1]).astype(np.int32)
    return boxes, off, ids


def _edge_cases():
    """(name, boxes, offsets, ids, cap factor): every line empty, no lines,
    one-character lines, and a cap factor that binds (wide chars on short
    lines: the width is cut to (int)(height * factor))."""
    one = np.array([[5, 5, 40, 17], [0, 30, 3, 31], [9, 60, 9, 70]], np.int32)
    wide = np.array([[0, 0, 400, 6], [10, 20, 300, 23], [3, 50, 90, 52]],
                    np.int32)
    return [
        ("all empty", one, np.zeros(4, np.int32), np.zeros(0, np.int32), 1.2),
        ("no lines", np.zeros((0, 4), np.int32), np.zeros(1, np.int32),
         np.zeros(0, np.int32), 1.2),
        ("one char a line", one, np.arange(4, dtype=np.int32),
         np.array([7, 8, 9], np.int32), 1.2),
        ("cap binds", wide, np.array([0, 3, 5, 9], np.int32),
         np.arange(1, 10, dtype=np.int32), 0.5),
    ]


def _same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def jax_core():
    if not jax_native.native_available():
        pytest.skip("the JAX package's core is not built")


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 777])
def test_char_records_random_lines(seed, jax_core):
    boxes, off, ids = _random_lines(seed)
    got = native.char_records(boxes, off, ids, 1.2)
    _same(got, dn.char_records_plain(boxes, off, ids, 1.2))
    _same(got, jax_native.char_records(boxes, off, ids, 1.2))
    _same(got, jax_native._char_records_numpy(boxes, off, ids, 1.2))
    assert 0 < len(got[0]) == int(off[-1])


@pytest.mark.parametrize("case", range(len(_edge_cases())),
                         ids=[c[0] for c in _edge_cases()])
def test_char_records_edge_cases(case, jax_core):
    name, boxes, off, ids, cap = _edge_cases()[case]
    got = native.char_records(boxes, off, ids, cap)
    _same(got, dn.char_records_plain(boxes, off, ids, cap))
    _same(got, jax_native.char_records(boxes, off, ids, cap))
    if name == "cap binds":
        width = got[0][:, 3] - got[0][:, 2]
        cap_px = ((boxes[:, 3] - boxes[:, 1]) * cap).astype(np.int64)
        assert (width <= np.repeat(cap_px, np.diff(off))).all()
        assert (width < 0.9 * np.repeat((boxes[:, 2] - boxes[:, 0])
                                        / np.diff(off), np.diff(off))).any()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_wordgrid_records(seed, jax_core, monkeypatch):
    """Seeded words (some empty, some narrower than a cell a char) through
    the C core, the numpy version and the JAX package's core and numpy
    path."""
    rng = np.random.default_rng(seed)
    n = 13
    boxes = np.stack([rng.uniform(0, 400, n), rng.uniform(0, 400, n),
                      rng.uniform(0.5, 120, n), rng.uniform(0.5, 30, n)], 1)
    lens = rng.integers(0, 9, n)
    lens[seed] = 0
    off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    ids = rng.integers(0, 64, int(off[-1])).astype(np.int32)
    geo = (float(boxes[:, 0].min()), float(boxes[:, 1].min()), 2.5,
           float(boxes[:, 3].min()))
    got = native.wordgrid_records(boxes, off, ids, *geo)
    _same([got], [dn.wordgrid_records_plain(boxes, off, ids, *geo)])
    _same([got], [jax_native.wordgrid_records(boxes, off, ids, *geo)])
    monkeypatch.setattr(jax_native, "_load", lambda: None)
    _same([got], [jax_native.wordgrid_records(boxes, off, ids, *geo)])


def test_dispatch_takes_the_core():
    assert native.native_available()
    boxes, off, ids = _random_lines(9)
    _same(dn.char_records(boxes, off, ids, 1.2),
          native.char_records(boxes, off, ids, 1.2))


def test_library_lands_under_build():
    assert native.native_available()
    path = Path(native.BUILD_INFO["path"])
    assert path == native.library_path() and path.exists()
    assert path.parent == ROOT / "build" / "msau_tpu_torch"
    assert path.name == f"librasterlib-{native.source_hash()}.so"
    pkg = Path(native.__file__).parent
    assert sorted(p.name for p in pkg.iterdir()
                  if p.suffix not in (".pyc",) and p.name != "__pycache__") \
        == ["__init__.py", "rasterlib.c"]


_CHILD = """
import json, sys, time
from pathlib import Path
import numpy as np
import msau_tpu_torch.native as n
n.BUILD_DIR = Path(sys.argv[1])
time.sleep(max(0.0, float(sys.argv[2]) - time.time()))
rec = n.char_records(np.array([[0, 0, 10, 5]], np.int32),
                     np.array([0, 2], np.int32), np.array([3, 4], np.int32),
                     1.2)
print(json.dumps({"built": n.BUILD_INFO["built"], "path": n.BUILD_INFO["path"],
                  "rec": rec[0].tolist()}))
"""


def test_processes_at_first_use_build_once(tmp_path):
    """Six processes reach first use together (the suite's workers): one
    compiles, each loads the same library and gets the same records."""
    start = time.time() + 6.0
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, str(tmp_path),
                               str(start)], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        outs.append(json.loads(out.strip().splitlines()[-1]))
    assert sum(o["built"] for o in outs) == 1
    assert {o["path"] for o in outs} == {
        str(tmp_path / f"librasterlib-{native.source_hash()}.so")}
    want = dn.char_records_plain(np.array([[0, 0, 10, 5]], np.int32),
                                 np.array([0, 2], np.int32),
                                 np.array([3, 4], np.int32), 1.2)[0].tolist()
    assert all(o["rec"] == want for o in outs)
    assert sorted(p.suffix for p in tmp_path.iterdir()) == [".lock", ".so"]


@pytest.fixture
def fresh_core(monkeypatch, tmp_path):
    """The core's module state reset to before first use, building into an
    empty directory; restored after the test."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_ERROR", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "BUILD_INFO", {})
    return tmp_path


def test_failed_build_raises_with_compiler_output(fresh_core, monkeypatch):
    bad = fresh_core / "rasterlib.c"
    bad.write_text("int64_t build_char_records( {\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    for _ in range(2):   # the first call and every later one
        with pytest.raises(RuntimeError, match="error") as e:
            native.native_available()
        assert str(bad) in str(e.value)
    with pytest.raises(RuntimeError):
        dn.char_records(*_random_lines(0), 1.2)
    assert not list((fresh_core / "build").glob("*.so"))


def test_no_compiler_takes_numpy(fresh_core, monkeypatch):
    monkeypatch.setattr(native, "compiler", lambda: None)
    assert not native.native_available()
    boxes, off, ids = _random_lines(5)
    _same(dn.char_records(boxes, off, ids, 1.2),
          dn.char_records_plain(boxes, off, ids, 1.2))
    with pytest.raises(RuntimeError, match="not built"):
        native.char_records(boxes, off, ids, 1.2)
    assert not (fresh_core / "build").exists()


def test_chargrid_programs_same_with_either_backend(monkeypatch):
    page = load_funsd_page(str(FIXTURE))
    cs = Charset.from_corpus(page.texts)
    kw = dict(scale_min=3.0, scale_max=3.0)
    assert native.native_available()
    a = rasterize.build_chargrid_programs(page, cs, **kw)
    monkeypatch.setattr(native, "native_available", lambda: False)
    b = rasterize.build_chargrid_programs(page, cs, **kw)
    for f in ("char", "char_sep", "line_mask", "label", "line_id", "char_id"):
        np.testing.assert_array_equal(getattr(a, f).boxes, getattr(b, f).boxes)
        np.testing.assert_array_equal(getattr(a, f).values,
                                      getattr(b, f).values)
