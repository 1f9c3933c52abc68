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
     and the train slice's kernels at the flagship train step's shapes:
       attention bwd  N=16, T=4096, Cb=8, C=64 in f32 (1e-4 of the largest
                  |gradient|) and bf16 (2e-2), and a ragged T = 66 (1e-4);
       masked CE  fwd and bwd on [16, 17, 512^2] f32 and bf16 logits with
                  label-0 pixels and a masked-out band: correct exact,
                  ce_sum rel 1e-5, dlogits 1e-6 (f32) / 1e-2 (bf16);
  2. the serve path, KVModel.predict, of the flagship model (img_channels 64,
     17 classes, 4 scales, feat_root 8, res_depth 2, 3 stages, flat_scales
     0) with seeded random weights on the 512^2 bench page: warm-up, then 5
     requests in f32 and 5 in bf16 with the launch counters reset just
     before.  Checks: each kernel launched 3 / 3 / 1 times per request; the
     decode tables equal the same pipeline's with the plain versions (CPU)
     on the same probabilities; the f32 forward agrees with the CPU forward
     on a small input; p50 of each predict stage;
  3. the train path: the same model through Trainer.init_state and its
     train step (masked CE, Adam lr 1e-4, clip 1.0) at batch 16, 512^2, on
     the bench's structured batch, bf16 activations with f32 parameters,
     then f32: 2 warm-up steps, then 10 timed steps with the launch
     counters reset just before (img/s, ms/step, peak memory).  Checks: per
     step exactly 3 attention forwards, 2 attention backwards (the last
     stage's attention output feeds nothing, so autograd runs no backward
     for it), 2 CE forwards and 2 CE backwards; the loss finite, and below
     its first value after 20 bf16 steps; and one f32 step at 128^2, batch
     2, on the card against the CPU (plain versions) from the same weights:
     loss rel 1e-5, grad_norm rel 1e-4, each parameter's gradient within
     1e-3 of that tensor's largest |gradient| plus 1e-6 of the model's.

The line before the last is one JSON object with every kernel's route,
source, the TPU kernel it replaces, its launches in phases 2 and 3, its
largest error against the plain version and both times; the last line is
the device record.  A fuller report, with nvcc's register and
shared-memory lines for each kernel, goes to build/chip_smoke.json.
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


def _scaled_err(got, want):
    """max |got - want| / max(1, max |want|)."""
    want = want.double()
    return float((got.double() - want).abs().max()
                 / max(1.0, float(want.abs().max())))


# (N, T, dtype, tolerance) of the attention backward's cases, and the
# masked CE's logits shape: the flagship train step's
ATTN_BWD_CASES = ((16, 4096, "float32", 1e-4), (16, 4096, "bfloat16", 2e-2),
                  (3, 66, "float32", 1e-4))
CE_SHAPE = (16, 17, 512 * 512)


def check_train_kernels(dev):
    """Phase 1, the train slice's kernels -> {kernel: {max_abs_err, ms,
    plain_ms, cases}}."""
    import numpy as np
    import torch

    from msau_tpu_torch.ops.attention import (
        resident_attention_bwd_cuda,
        resident_attention_bwd_plain,
        resident_attention_plain_stats,
    )
    from msau_tpu_torch.ops.ce_loss import (
        masked_ce_bwd_cuda,
        masked_ce_bwd_plain,
        masked_ce_fwd_cuda,
        masked_ce_fwd_plain,
    )
    from msau_tpu_torch.utils.kernel_inputs import attention_inputs, ce_inputs

    out = {}
    # ---- attention backward ------------------------------------------
    errs, times = {}, {}
    timed_t = ATTN_BWD_CASES[0][1]
    for n, t, dtype, tol in ATTN_BWD_CASES:
        dtype = getattr(torch, dtype)
        rng = np.random.default_rng(t)
        f, g, h = (torch.from_numpy(a).to(dev, dtype)
                   for a in attention_inputs(rng, n, t, 8, 64))
        dout = torch.from_numpy(rng.normal(size=(n, t, 64)).astype(
            np.float32)).to(dev, dtype)
        _, m, l = resident_attention_plain_stats(f, g, h)
        got = resident_attention_bwd_cuda(f, g, h, m, l, dout)
        torch.cuda.synchronize()
        want = resident_attention_bwd_plain(f, g, h, m, l, dout)
        key = f"N{n}_T{t}_{str(dtype).split('.')[-1]}"
        errs[key] = {"tol": tol}
        timed = t == timed_t
        for name, a, b in zip(("df", "dg", "dh"), got, want):
            errs[key][name] = {"max_abs_err": _max_abs(a, b),
                               "scaled_err": _scaled_err(a, b)}
            if a.dtype != dtype or errs[key][name]["scaled_err"] > tol:
                raise AssertionError(f"attention bwd {key} {name}: "
                                     f"{errs[key][name]} (tol {tol})")
        if timed:
            del got, want
            times[key] = {
                "ms": _cuda_ms(lambda: resident_attention_bwd_cuda(
                    f, g, h, m, l, dout), 10),
                "plain_ms": _cuda_ms(lambda: resident_attention_bwd_plain(
                    f, g, h, m, l, dout), 5),
            }
        print(f"[phase 1] attention bwd {key}: " + ", ".join(
            f"{k} max abs {v['max_abs_err']:.3e} (scaled {v['scaled_err']:.3e})"
            for k, v in errs[key].items() if k != "tol") + f"; tol {tol}",
            flush=True)
    main = "N{}_T{}_{}".format(*ATTN_BWD_CASES[0][:3])
    out["resident_attention_bwd"] = {
        "max_abs_err": max(errs[main][k]["max_abs_err"]
                           for k in ("df", "dg", "dh")),
        "cases": errs, "times": times,
        "ms": times[main]["ms"], "plain_ms": times[main]["plain_ms"],
    }
    print(f"[phase 1] attention bwd times {json.dumps(times)}", flush=True)

    # ---- masked CE ---------------------------------------------------
    logits32, labels, maskf = (
        torch.from_numpy(a).to(dev) for a in
        ce_inputs(np.random.default_rng(0), *CE_SHAPE))
    g = torch.tensor(0.37, device=dev)
    cases, times = {}, {}
    for dtype, tol in ((torch.float32, 1e-6), (torch.bfloat16, 1e-2)):
        logits = logits32.to(dtype)
        key = str(dtype).split(".")[-1]
        s, c = masked_ce_fwd_cuda(logits, labels, maskf)
        torch.cuda.synchronize()
        ps, pc = masked_ce_fwd_plain(logits, labels, maskf)
        rel = abs(float(s) - float(ps)) / abs(float(ps))
        if float(c) != float(pc) or rel > 1e-5:
            raise AssertionError(f"masked CE fwd {key}: ce_sum {float(s)} vs "
                                 f"{float(ps)}, correct {float(c)} vs {float(pc)}")
        dl = masked_ce_bwd_cuda(logits, labels, maskf, g)
        torch.cuda.synchronize()
        dl_err = _max_abs(dl, masked_ce_bwd_plain(logits, labels, maskf, g))
        if dl.dtype != dtype or dl_err > tol:
            raise AssertionError(f"masked CE bwd {key}: max abs err {dl_err}")
        cases[key] = {"ce_sum": float(s), "ce_sum_abs_err": abs(float(s) - float(ps)),
                      "ce_sum_rel_err": rel, "correct": float(c),
                      "correct_equal": True, "dlogits_max_abs_err": dl_err,
                      "dlogits_tol": tol}
        times[key] = {
            "fwd_ms": _cuda_ms(lambda: masked_ce_fwd_cuda(logits, labels, maskf), 20),
            "fwd_plain_ms": _cuda_ms(lambda: masked_ce_fwd_plain(logits, labels, maskf), 10),
            "bwd_ms": _cuda_ms(lambda: masked_ce_bwd_cuda(logits, labels, maskf, g), 20),
            "bwd_plain_ms": _cuda_ms(lambda: masked_ce_bwd_plain(logits, labels, maskf, g), 10),
        }
        print(f"[phase 1] masked CE {key}: ce_sum rel err {rel:.3e}, correct "
              f"{float(c):.0f} exact, dlogits max abs err {dl_err:.3e} "
              f"(tol {tol}); {json.dumps(times[key])}", flush=True)
    out["masked_ce_fwd"] = {
        "max_abs_err": cases["float32"]["ce_sum_abs_err"], "cases": cases,
        "ms": times["float32"]["fwd_ms"], "plain_ms": times["float32"]["fwd_plain_ms"],
        "times": times}
    out["masked_ce_bwd"] = {
        "max_abs_err": cases["float32"]["dlogits_max_abs_err"], "cases": cases,
        "ms": times["float32"]["bwd_ms"], "plain_ms": times["float32"]["bwd_plain_ms"],
        "times": times}
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


FLAGSHIP = dict(img_channels=64, n_class=17, scale_space_num=4, res_depth=2,
                feat_root=8, num_blocks=3, final_act="softmax", flat_scales=0,
                remat=False)
# kernel launches per train step: the last stage's attention output feeds
# nothing, so autograd runs its forward but no backward
PER_STEP = {"resident_attention_fwd": 3, "resident_attention_bwd": 2,
            "masked_ce_fwd": 2, "masked_ce_bwd": 2, "paint": 0,
            "ccl_multiclass": 0}
TRAIN_BATCH = (16, 512)  # images per step, side
CHECK_BATCH = (2, 128)   # the card-vs-CPU step


def train_path(dev):
    """Phase 3, the flagship train step at TRAIN_BATCH -> (launch counts,
    per-dtype results)."""
    import numpy as np
    import torch

    from msau_tpu_torch import ops
    from msau_tpu_torch.config import ModelConfig, TrainConfig
    from msau_tpu_torch.data.synth import make_structured_batch
    from msau_tpu_torch.train.trainer import Trainer

    (bs, hw), warm, timed = TRAIN_BATCH, 2, 10
    x, y = make_structured_batch(np.random.default_rng(0), bs, hw, 17, 64)
    tcfg = TrainConfig(learning_rate=1e-4, lr_decay_staircase=False)
    total = {k: 0 for k in ops.KERNEL_WRAPPERS}
    results = {}
    for dtype in ("bfloat16", "float32"):
        tr = Trainer(ModelConfig(**FLAGSHIP, dtype=dtype), tcfg, device=dev)
        tr.init_state(x, seed=0)
        batch = tr.put_batch({"input": x, "label": y,
                              "valid": np.ones(y.shape, bool)})
        # the bench feeds the batch in the compute dtype (bench.py:88)
        batch["input"] = batch["input"].to(tr.model.compute_dtype)
        torch.cuda.reset_peak_memory_stats(dev)
        losses = []
        t0 = time.perf_counter()
        for _ in range(warm):
            tr.state, metrics = tr.train_step(tr.state, batch)
            losses.append(float(metrics["loss"]))
        warm_s = time.perf_counter() - t0
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        for _ in range(timed):
            tr.state, metrics = tr.train_step(tr.state, batch)
        losses.append(float(metrics["loss"]))  # closes the timed window
        dt = (time.perf_counter() - t0) / timed
        counts = ops.launch_counts()
        for name, per in PER_STEP.items():
            if counts[name] != per * timed:
                raise AssertionError(f"{dtype}: {name} launched {counts[name]} "
                                     f"times in {timed} steps, want {per * timed}")
            total[name] += counts[name]
        peak = torch.cuda.max_memory_allocated(dev)
        res = {"ms_per_step": dt * 1e3, "img_per_s": bs / dt,
               "peak_mem_gib": peak / 2**30, "warmup_s": warm_s,
               "first_loss": losses[0], "grad_norm": float(metrics["grad_norm"]),
               "launches_per_step": {k: counts[k] / timed for k in PER_STEP}}
        if dtype == "bfloat16":
            for _ in range(20 - warm - timed):
                tr.state, metrics = tr.train_step(tr.state, batch)
            losses.append(float(metrics["loss"]))
            res["loss_after_20"] = losses[-1]
            if not losses[-1] < losses[0]:
                raise AssertionError(f"bf16 loss did not fall in 20 steps: "
                                     f"{losses[0]} -> {losses[-1]}")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{dtype}: non-finite loss {losses}")
        res["losses"] = losses
        results[dtype] = res
        print(f"[phase 3] {dtype} bs {bs} {hw}^2: {res['ms_per_step']:.2f} "
              f"ms/step, {res['img_per_s']:.3f} img/s, peak "
              f"{res['peak_mem_gib']:.2f} GiB, loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}; launches/step {res['launches_per_step']}",
              flush=True)
        del tr, batch, metrics
        torch.cuda.empty_cache()
    return total, results


def train_step_check(dev):
    """Phase 3, one f32 step at 128^2, bs 2 (T = 256 at the deepest scale) on
    the card and on the CPU (plain versions) from the same weights."""
    import numpy as np
    import torch

    from msau_tpu_torch.config import ModelConfig
    from msau_tpu_torch.models.msau import build_model
    from msau_tpu_torch.data.synth import make_structured_batch
    from msau_tpu_torch.train.optimizer import global_norm
    from msau_tpu_torch.train.trainer import make_loss_and_grad

    cfg = ModelConfig(**FLAGSHIP, dtype="float32")
    x, y = make_structured_batch(np.random.default_rng(1), *CHECK_BATCH, 17, 64)
    batch = {"input": torch.from_numpy(x), "label": torch.from_numpy(y),
             "valid": torch.ones(y.shape, dtype=torch.bool)}
    out = {}
    for where in ("cpu", dev):
        model = build_model(cfg, torch.Generator().manual_seed(0)).to(where)
        loss, metrics, grads = make_loss_and_grad(model)(
            {k: v.to(where) for k, v in batch.items()})
        out[str(where)] = (float(loss), float(global_norm(list(grads.values()))),
                           {k: v.cpu() for k, v in grads.items()})
    (l_cpu, n_cpu, g_cpu), (l_card, n_card, g_card) = out["cpu"], out[str(dev)]
    scale = max(float(v.abs().max()) for v in g_cpu.values())
    worst, worst_name = 0.0, None
    for name, want in g_cpu.items():
        err = _max_abs(g_card[name], want)
        bound = 1e-3 * float(want.abs().max()) + 1e-6 * scale
        if err > bound:
            raise AssertionError(f"grad {name}: card vs CPU max abs err {err} "
                                 f"> {bound}")
        ratio = err / bound
        if ratio >= worst:
            worst, worst_name = ratio, name
    check = {"loss_cpu": l_cpu, "loss_card": l_card,
             "loss_rel_err": abs(l_card - l_cpu) / abs(l_cpu),
             "grad_norm_cpu": n_cpu, "grad_norm_card": n_card,
             "grad_norm_rel_err": abs(n_card - n_cpu) / abs(n_cpu),
             "worst_grad_err_over_bound": worst, "worst_grad": worst_name}
    if check["loss_rel_err"] > 1e-5 or check["grad_norm_rel_err"] > 1e-4:
        raise AssertionError(f"card vs CPU step: {check}")
    print(f"[phase 3] f32 step {CHECK_BATCH[1]}^2 bs {CHECK_BATCH[0]}, card "
          f"vs CPU: loss rel err "
          f"{check['loss_rel_err']:.3e}, grad_norm rel err "
          f"{check['grad_norm_rel_err']:.3e}, worst gradient at "
          f"{worst:.3f} of its bound ({worst_name})", flush=True)
    return check


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
    kernels.update(check_train_kernels(dev))
    counts, timings, checks = serve_path(dev)
    train_counts, train = train_path(dev)
    checks["train_step_card_vs_cpu"] = train_step_check(dev)
    launches = {k: counts[k] + train_counts[k] for k in counts}
    print(f"[phase 3] launches: serve {counts}, train {train_counts}",
          flush=True)

    sources = {
        "paint": ("msau_tpu_torch/csrc/paint.cu",
                  "msau_tpu/ops/paint_pallas.py:25"),
        "resident_attention_fwd": ("msau_tpu_torch/csrc/attention.cu",
                                   "msau_tpu/ops/pallas_attn.py:238"),
        "ccl_multiclass": ("msau_tpu_torch/csrc/ccl.cu",
                           "msau_tpu/ops/ccl.py:337"),
        "resident_attention_bwd": ("msau_tpu_torch/csrc/attention_bwd.cu",
                                   "msau_tpu/ops/pallas_attn.py:262"),
        "masked_ce_fwd": ("msau_tpu_torch/csrc/ce_loss.cu",
                          "msau_tpu/ops/ce_loss.py:39"),
        "masked_ce_bwd": ("msau_tpu_torch/csrc/ce_loss.cu",
                          "msau_tpu/ops/ce_loss.py:61"),
    }
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name],
         "max_abs_err": kernels[name]["max_abs_err"],
         "ms": kernels[name]["ms"], "plain_ms": kernels[name]["plain_ms"]}
        for name, (src, rep) in sources.items()]}
    report = {"card": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_seconds": lib.build_seconds,
              "ptxas": lib.build_log, "kernels": kernels,
              "launches": {"serve": counts, "train": train_counts},
              "predict_p50_ms": timings, "train": train, "checks": checks}
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
