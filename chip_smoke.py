#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (msau_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is non-zero:

  0. require a CUDA card; print the card's name and power limit, the torch
     and CUDA versions, and build the hand-written kernels from csrc/
     (nvcc, sm_90a) with the build time;
  1. each kernel against its plain PyTorch version on the card, at the serve
     slice's shapes, with its time beside the plain version's:
       paint      512^2, B = 4096 (random overlapping / cross-tile / empty /
                  zero-padded boxes, and the bench page's programs), exact;
       attention  N=1, T=4096, Cb=8, C=64 in f32 (1e-5) and bf16 (2e-2), and
                  a ragged T = 66 (1e-5);
       CCL        512^2 blobby, noisy 3-class and maze maps, exact;
  2. the serve path, KVModel.predict, of the flagship model (img_channels 64,
     17 classes, 4 scales, feat_root 8, res_depth 2, 3 stages, flat_scales
     0) with seeded random weights on the 512^2 bench page: warm-up, then 5
     requests in f32 and 5 in bf16 with the launch counters reset just
     before.  Checks: each kernel launched 3 / 3 / 1 times per request; the
     decode tables equal the same pipeline's with the plain versions (CPU)
     on the same probabilities; the f32 forward agrees with the CPU forward
     on a small input; p50 of each predict stage.

The line before the last is one JSON object with every kernel's route,
source, the TPU kernel it replaces, its launches in phase 2, its largest
error against the plain version and both times; the last line is the
device record.  A fuller report, with nvcc's register and shared-memory
lines for each kernel, goes to build/chip_smoke.json.
"""

import json
import subprocess
import sys
import time


def _cuda_ms(fn, iters):
    """Mean device time of ``fn`` in ms (CUDA events over ``iters`` calls)."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _max_abs(a, b):
    return float((a.double() - b.double()).abs().max())


def check_kernels(dev, bench_progs):
    """Phase 1 -> {kernel: {max_abs_err, ms, plain_ms, cases}}."""
    import numpy as np
    import torch

    from msau_tpu_torch.ops.attention import (
        resident_attention_cuda,
        resident_attention_plain,
    )
    from msau_tpu_torch.ops.ccl import (
        connected_components_multiclass_cuda,
        connected_components_multiclass_plain,
    )
    from msau_tpu_torch.ops.paint import paint_boxes_cuda, paint_boxes_plain
    from msau_tpu_torch.utils.kernel_inputs import (
        attention_inputs,
        ccl_map,
        paint_program,
    )

    out = {}
    # ---- paint -------------------------------------------------------
    cases = {"random_b4096": paint_program(np.random.default_rng(0), 3500,
                                           512, 512, 4096)}
    for name, prog in bench_progs.items():
        cases[f"bench_{name}"] = prog
    errs = {}
    for name, (boxes, values) in cases.items():
        b = torch.from_numpy(boxes).to(dev)
        v = torch.from_numpy(values).to(dev)
        got = paint_boxes_cuda(b, v, 512, 512)
        torch.cuda.synchronize()
        want = paint_boxes_plain(b, v, 512, 512)
        errs[name] = int((got != want).sum())
        if errs[name]:
            raise AssertionError(f"paint {name}: {errs[name]} pixels differ")
    b = torch.from_numpy(bench_progs["char"][0]).to(dev)
    v = torch.from_numpy(bench_progs["char"][1]).to(dev)
    out["paint"] = {
        "max_abs_err": 0.0, "cases": errs, "timed_on": "bench char program",
        "n_boxes": int(b.shape[0]),
        "ms": _cuda_ms(lambda: paint_boxes_cuda(b, v, 512, 512), 50),
        "plain_ms": _cuda_ms(lambda: paint_boxes_plain(b, v, 512, 512), 3),
    }
    print(f"[phase 1] paint exact on {list(errs)}; "
          f"{out['paint']['ms']:.4f} ms vs plain {out['paint']['plain_ms']:.2f} ms",
          flush=True)

    # ---- attention ---------------------------------------------------
    errs, times = {}, {}
    for t, dtype, tol in ((4096, torch.float32, 1e-5),
                          (4096, torch.bfloat16, 2e-2),
                          (66, torch.float32, 1e-5)):
        f, g, h = (torch.from_numpy(a).to(dev, dtype) for a in
                   attention_inputs(np.random.default_rng(t), 1, t, 8, 64))
        got, m, l = resident_attention_cuda(f, g, h)
        torch.cuda.synchronize()
        want = resident_attention_plain(f, g, h)
        key = f"T{t}_{str(dtype).split('.')[-1]}"
        err = _max_abs(got, want)
        rel = float(((got.double() - want.double()).abs()
                     / (want.double().abs() + 1.0)).max())
        errs[key] = {"max_abs_err": err, "tol": tol}
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
        if not (torch.isfinite(m).all() and (l >= 1).all()):
            raise AssertionError(f"attention {key}: bad softmax stats")
        if t == 4096:
            times[key] = {
                "ms": _cuda_ms(lambda: resident_attention_cuda(f, g, h), 20),
                "plain_ms": _cuda_ms(lambda: resident_attention_plain(f, g, h), 20),
            }
        print(f"[phase 1] attention {key}: max abs err {err:.3e} "
              f"(rel {rel:.3e}, tol {tol})", flush=True)
    out["resident_attention_fwd"] = {
        "max_abs_err": errs["T4096_float32"]["max_abs_err"],
        "cases": errs, "times": times,
        "ms": times["T4096_float32"]["ms"],
        "plain_ms": times["T4096_float32"]["plain_ms"],
    }
    print(f"[phase 1] attention times {json.dumps(times)}", flush=True)

    # ---- CCL ---------------------------------------------------------
    errs = {}
    maps = {kind: torch.from_numpy(ccl_map(kind, 512, 512,
                                           np.random.default_rng(5))).to(dev)
            for kind in ("blobby", "noisy", "maze")}
    for kind, cls in maps.items():
        got = connected_components_multiclass_cuda(cls)
        torch.cuda.synchronize()
        want = connected_components_multiclass_plain(cls)
        errs[kind] = int((got != want).sum())
        if errs[kind]:
            raise AssertionError(f"ccl {kind}: {errs[kind]} labels differ")
    cls = maps["noisy"]
    out["ccl_multiclass"] = {
        "max_abs_err": 0.0, "cases": errs, "timed_on": "noisy 512^2",
        "ms": _cuda_ms(lambda: connected_components_multiclass_cuda(cls), 50),
        "plain_ms": _cuda_ms(lambda: connected_components_multiclass_plain(cls), 3),
    }
    print(f"[phase 1] ccl exact on {list(errs)}; "
          f"{out['ccl_multiclass']['ms']:.4f} ms vs plain "
          f"{out['ccl_multiclass']['plain_ms']:.2f} ms", flush=True)
    return out


def serve_path(dev):
    """Phase 2 -> (launch counts, per-dtype stage p50s, checks)."""
    import numpy as np
    import torch

    from msau_tpu_torch.config import InferConfig, ModelConfig
    from msau_tpu_torch import ops
    from msau_tpu_torch.data.charset import Charset
    from msau_tpu_torch.data.pages import page_from_label_dict
    from msau_tpu_torch.data.rasterize import paint_boxes
    from msau_tpu_torch.data.synth import BENCH_CHARSET, make_page
    from msau_tpu_torch.infer.decode import decode_fields_device, pack_decode_out
    from msau_tpu_torch.infer.kv_model import KVModel
    from msau_tpu_torch.models.msau import build_model

    base = dict(img_channels=64, n_class=17, scale_space_num=4, res_depth=2,
                feat_root=8, num_blocks=3, final_act="softmax", flat_scales=0)
    page = page_from_label_dict(
        make_page(np.random.default_rng(3), n_cols=5, rows_per_col=10))
    models = {}
    for dtype in ("float32", "bfloat16"):
        kv = KVModel(model_config=ModelConfig(**base, dtype=dtype),
                     infer_config=InferConfig(n_class=17), device=dev)
        kv.charset = Charset(chars=" $" + BENCH_CHARSET)
        assert kv.charset.n_token == 64
        kv.load(n_class=17, generator=torch.Generator().manual_seed(0))
        kv.warmup_bucket(512)
        kv.predict(page, return_maps=False)   # the bench page once, unmeasured
        models[dtype] = kv

    n_req = 5
    ops.reset_launch_counts()
    timings = {}
    for dtype, kv in models.items():
        rows = []
        for _ in range(n_req):
            t = {}
            kv.predict(page, return_maps=False, timings=t)
            rows.append(t)
        timings[dtype] = {k: float(np.median([r[k] for r in rows]))
                          for k in ("prep", "device", "strings")}
    counts = ops.launch_counts()
    per_req = {"paint": 3, "resident_attention_fwd": 3, "ccl_multiclass": 1}
    for name, n in per_req.items():
        want = n * n_req * len(models)
        if counts[name] != want:
            raise AssertionError(f"{name}: {counts[name]} launches in "
                                 f"{n_req * len(models)} requests, want {want}")
    print(f"[phase 2] launches over {n_req * len(models)} requests: {counts}",
          flush=True)
    for dtype, t in timings.items():
        print(f"[phase 2] {dtype} predict p50 ms: " +
              ", ".join(f"{k} {v:.3f}" for k, v in t.items()), flush=True)

    # ---- correctness of what comes out -----------------------------------
    checks = {}
    for dtype, kv in models.items():
        res, extras = kv.predict(page, return_maps=True)
        probs = extras["pred"]
        progs = extras["programs"]
        hb, wb = 512, 512
        assert probs.shape == (hb, wb, 17), probs.shape
        assert torch.isfinite(probs).all()
        assert torch.allclose(probs.sum(-1), torch.ones((), device=dev), atol=1e-4)
        num_lines = -(-max(len(extras["scaled_lines"]), 1) // 128) * 128
        planes = {}
        for name in ("line_id", "char_id"):
            prog = getattr(progs, name).padded(
                -(-max(len(getattr(progs, name).values), 1) // 512) * 512)
            b, v = torch.from_numpy(prog.boxes), torch.from_numpy(prog.values)
            on_card = paint_boxes(b.to(dev), v.to(dev), hb, wb)
            plain = paint_boxes(b, v, hb, wb)
            assert torch.equal(on_card.cpu(), plain), name
            planes[name] = (on_card, plain)
        kw = dict(n_class=17, num_lines=num_lines, k=8,
                  min_area=kv.cfg.min_component_area)
        mlc = kv._multiline_classes()
        card = decode_fields_device(probs, planes["line_id"][0],
                                    planes["char_id"][0], mlc, **kw)
        host = decode_fields_device(probs.cpu(), planes["line_id"][1],
                                    planes["char_id"][1], mlc, **kw)
        same = torch.equal(pack_decode_out(card).cpu(), pack_decode_out(host))
        assert torch.equal(card["chosen_class"].cpu(), host["chosen_class"])
        assert torch.equal(card["chosen_class"], extras["chosen_class"])
        if not same:
            raise AssertionError(f"{dtype}: decode tables differ from the "
                                 "plain-version pipeline")
        checks[dtype] = {"decode_tables_equal_plain": True,
                         "active_fields": int(card["active"].sum()),
                         "n_results": len(res)}
        print(f"[phase 2] {dtype}: decode tables equal the plain pipeline's; "
              f"{checks[dtype]['active_fields']} active classes", flush=True)

    # the f32 forward against the same model on the CPU, small input
    kv = models["float32"]
    cpu_model = build_model(kv.model_config, torch.Generator().manual_seed(0)).eval()
    cpu_model.load_state_dict({k: v.cpu() for k, v in kv.model.state_dict().items()})
    ids = np.random.default_rng(1).integers(0, 64, (1, 64, 64))
    x = torch.from_numpy(np.eye(64, dtype=np.float32)[ids])
    with torch.inference_mode():
        p_card = kv.model(x.to(dev))[0].cpu()
        p_cpu = cpu_model(x)[0]
    err = _max_abs(p_card, p_cpu)
    if err > 1e-4:
        raise AssertionError(f"f32 forward card vs CPU: max abs err {err}")
    checks["forward_f32_vs_cpu_64x64_max_abs_err"] = err
    print(f"[phase 2] f32 forward card vs CPU at 64x64: max abs err {err:.3e}",
          flush=True)
    return counts, timings, checks


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        from msau_tpu_torch.ops import cuda_lib
    except ImportError as e:
        print(f"chip_smoke: the msau_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0]
    dev = torch.device("cuda", 0)
    print(f"[phase 0] card: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}", flush=True)
    t0 = time.perf_counter()
    lib = cuda_lib.library()
    print(f"[phase 0] kernels built in {lib.build_seconds:.1f} s "
          f"({time.perf_counter() - t0:.1f} s with loading): {lib.path.name}",
          flush=True)

    from msau_tpu_torch.data.charset import Charset
    from msau_tpu_torch.data.pages import page_from_label_dict
    from msau_tpu_torch.data.rasterize import build_chargrid_programs, round_up
    from msau_tpu_torch.data.synth import BENCH_CHARSET, make_page
    import numpy as np

    progs = build_chargrid_programs(
        page_from_label_dict(make_page(np.random.default_rng(3), n_cols=5,
                                       rows_per_col=10)),
        Charset(chars=" $" + BENCH_CHARSET), scale_min=3.0, scale_max=3.0,
        normalize_digits=True, char_w_cap_factor=1.2, pad_factor_fixed=3.0,
        label_style="box")
    bench_progs = {}
    for name in ("char", "line_id", "char_id"):
        p = getattr(progs, name)
        p = p.padded(round_up(max(len(p.values), 1), 512))
        bench_progs[name] = (p.boxes, p.values)

    kernels = check_kernels(dev, bench_progs)
    counts, timings, checks = serve_path(dev)

    sources = {
        "paint": ("msau_tpu_torch/csrc/paint.cu",
                  "msau_tpu/ops/paint_pallas.py:25"),
        "resident_attention_fwd": ("msau_tpu_torch/csrc/attention.cu",
                                   "msau_tpu/ops/pallas_attn.py:238"),
        "ccl_multiclass": ("msau_tpu_torch/csrc/ccl.cu",
                           "msau_tpu/ops/ccl.py:337"),
    }
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name], "max_abs_err": kernels[name]["max_abs_err"],
         "ms": kernels[name]["ms"], "plain_ms": kernels[name]["plain_ms"]}
        for name, (src, rep) in sources.items()]}
    report = {"card": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_seconds": lib.build_seconds,
              "ptxas": lib.build_log, "kernels": kernels, "launches": counts,
              "predict_p50_ms": timings, "checks": checks}
    with open(cuda_lib.BUILD_DIR.parent / "chip_smoke.json", "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
