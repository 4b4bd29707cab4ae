"""Chip smoke test of paddle_tpu_torch on one CUDA card (H100).

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero before the result line):
  1. device   — prints the card's name and power limit (nvidia-smi);
                no CUDA device -> exit 1.
  2. build    — builds every kernel from paddle_tpu_torch/csrc with nvcc.
  3. check    — each kernel against its plain PyTorch version on the card
                at the main path's shapes (int8_matmul at the decode M and
                at every prefill bucket the serve phase's prompts fill);
                |kernel - plain| must stay within 1e-4 + 1e-4 * |plain|
                (f32 sums in another order).
  4. time     — device times (a CUDA graph replayed, CUDA events) of each
                kernel, its plain version and a PyTorch library call on the
                same inputs, over a sweep of 24 layers' distinct tensors (the
                weights / KV do not fit the 50 MB L2, as in a real decode
                step), beside the bound; "call_ms" is the kernel called
                eagerly, host launch cost included.
  5. serve    — GPT-2 medium (24 x 1024, vocab 50304), random weights from
                --seed, int8 weight-only, paged KV (block 16, 8 slots,
                max_len 1024): 8 requests (prompts 32..400, 64 new tokens,
                6 greedy + 2 sampled).  Kernel launch counters are zeroed
                just before and read just after; both must be > 0.  Then one
                decode step's logits on the kernel path are held against the
                same step run by the plain versions (on the CPU) on the same
                KV state, and greedy agreement with solo generate() is
                printed.
  6. fixed    — a 4-layer full-width f32 engine on the fixed pool: greedy
                streams must equal solo generate().
  7. flash    — the flash kernels K1 (forward) and K2 (backward) against
                their plain versions on the card at the training shape
                (B 4, S 1024, H 16, D 64, causal, dropout 0.1, fixed seed)
                in bf16 and f32, and at small shapes with a bias, segment
                ids and Sk != Sq (every gradient, dbias included); then
                timed like K3/K4 over 24 layers' tensors, beside the bound
                and torch's scaled_dot_product_attention as the yardstick.
  8. train    — GPT-2 medium (24 x 1024, 16 heads, vocab 50304), B 4,
                S 1024, O1 bf16, AdamW(1e-4), dropout 0.1, random weights
                and one random batch from --seed, through jit.TrainStep:
                8 steps on the batch, each loss printed, steady step time
                and tokens/s; the loss must be finite and fall, and K1/K2
                must launch 24 times per step each (counters zeroed just
                before the steps).  One more step is profiled.
  9. traincheck — one step's loss and every parameter's gradient of a
                2-layer full-width f32 GPT (dropout 0, B 1, S 1024) on the
                kernel path against the same step by the plain versions on
                the CPU, same weights and batch.
Before the last line it prints one JSON line with every kernel's launches,
error and times; the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
import time

import numpy as np

TOL = 1e-4          # |kernel - plain| <= TOL + TOL * |plain|
LOGIT_TOL = 2e-3    # kernel-path vs plain-path decode logits, max abs
# flash kernels vs their plain versions, (atol, rtol): f32 outputs sum in
# another order; f32 gradients sum over up to 1024 rows; bf16 values are
# rounded to bf16 by both, one bf16 unit (2**-8 relative) apart at most
FLASH_TOL = {"float32": ((1e-4, 1e-4), (2e-4, 1e-3)),
             "bfloat16": ((1e-2, 1e-2), (1e-2, 1e-2))}
# kernel-path vs CPU plain-path training step (f32, TF32 off): the loss
# within 1e-4 relative, each gradient within GRAD_TOL of its tensor's
# largest |gradient| (cuBLAS and the CPU sum in other orders)
GRAD_TOL = 1e-3
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12     # H100 SXM dense bf16 tensor cores
LAYERS = 24
SLOTS = 8
BLOCK = 16
MAX_LEN = 1024
PROMPT_LENS = (32, 64, 100, 160, 220, 280, 340, 400)   # serve phase
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 1024, 8               # train phase


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def call_ms(torch, fn, iters: int) -> float:
    """Mean ms per fn() called eagerly back to back (host launch cost
    included), after warm-up, by CUDA events."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def graph_ms(torch, fn, replays: int = 20) -> float:
    """Mean device ms of fn(): captured once as a CUDA graph and replayed,
    so host launch cost is out of the number; CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / replays


def bound_ms(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S):
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def max_err(torch, got, want, atol=TOL, rtol=TOL):
    err = (got.float() - want.float()).abs()
    ok = bool((err <= atol + rtol * want.float().abs()).all())
    return float(err.max()), ok


def prefill_buckets():
    """The prefill buckets (M of every prefill Linear) the serve phase's
    prompts land in, by the engine's own default bucket rule."""
    from paddle_tpu_torch.serving.engine import _default_buckets
    buckets = _default_buckets(MAX_LEN)
    return sorted({min(b for b in buckets if b >= n) for n in PROMPT_LENS})


def int8_phase(torch, rng, dev):
    """K4 checked at every M of the main path (8 decode slots and each
    prefill bucket) over one GPT-2-medium layer's four Linears; timed at
    decode M per layer, swept over 24 layers' weights."""
    from paddle_tpu_torch.ops import int8_matmul as im
    from paddle_tpu_torch.quantization import quantize_weight_int8
    shapes = [(1024, 3072), (1024, 1024), (1024, 4096), (4096, 1024)]
    m = SLOTS
    xs = {k: torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(dev)
          for k in (1024, 4096)}
    layers = []
    for _ in range(LAYERS):
        ws = []
        for k, n in shapes:
            w = torch.randn(k, n, device=dev) * 0.02
            ws.append(quantize_weight_int8(w))
        layers.append(ws)
    err, ok = 0.0, True
    for mc in [m] + prefill_buckets():
        for (k, n), (wi, s) in zip(shapes, layers[0]):
            x = xs[k] if mc == m else torch.from_numpy(
                rng.randn(mc, k).astype(np.float32)).to(dev)
            got = im.dequant_matmul(x, wi, s)
            want = im._plain(x, wi, s)
            torch.cuda.synchronize()
            e, o = max_err(torch, got, want)
            err, ok = max(err, e), ok and o
            print(f"check int8_matmul M={mc} K={k} N={n}: "
                  f"max_abs_err={e:.3e}{'' if o else ' OUT OF TOLERANCE'}")
    if not ok:
        fail(f"int8_matmul disagrees with its plain version ({err:.3e})")

    def sweep(f):
        def run():
            for ws in layers:
                for (k, n), (wi, s) in zip(shapes, ws):
                    f(xs[k], wi, s)
        return run
    ms = graph_ms(torch, sweep(im.dequant_matmul)) / LAYERS
    eager = call_ms(torch, sweep(im.dequant_matmul), 10) / LAYERS
    plain = graph_ms(torch, sweep(im._plain)) / LAYERS
    lib = graph_ms(torch, sweep(
        lambda x, wi, s: torch.matmul(x, wi.float() * s))) / LAYERS
    nbytes = sum(m * k * 4 + k * n + 4 * n + m * n * 4 for k, n in shapes)
    ops = sum(2 * m * k * n for k, n in shapes)
    b, by = bound_ms(nbytes, ops)
    return {"name": "int8_matmul", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/int8_matmul.cu",
            "replaces": "paddle_tpu/ops/int8_matmul.py:49",
            "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": b,
            "bound_by": by, "library_ms": lib, "call_ms": eager}


def paged_phase(torch, rng, dev):
    """K3 at decode shapes: 8 slots, ragged pos 17..1000, block 16, the
    engine's default pool (8 * 64 blocks), sentinel tail entries; times
    per layer, swept over 24 layers' pools."""
    from paddle_tpu_torch.ops import paged_attention as pa
    h, d = 16, 64
    nb = MAX_LEN // BLOCK
    num_blocks = SLOTS * nb
    pos_np = np.array([17, 150, 300, 511, 512, 700, 901, 1000], np.int32)
    tables_np = np.full((SLOTS, nb), num_blocks, np.int32)
    perm = rng.permutation(num_blocks)
    for i, p in enumerate(pos_np):
        live = -(-(int(p) + 1) // BLOCK)
        tables_np[i, :live] = perm[i * nb:i * nb + live]
    tables = torch.from_numpy(tables_np).to(dev)
    pos = torch.from_numpy(pos_np).to(dev)
    q = torch.from_numpy(rng.randn(SLOTS, h, d).astype(np.float32)).to(dev)
    pools = [(torch.randn(num_blocks, BLOCK, h, d, device=dev),
              torch.randn(num_blocks, BLOCK, h, d, device=dev))
             for _ in range(LAYERS)]
    kp, vp = pools[0]
    got = pa.paged_attention(q, kp, vp, tables, pos)
    want = pa._plain(q, kp, vp, tables, pos)
    torch.cuda.synchronize()
    err, ok = max_err(torch, got, want)
    print(f"check paged_attention S={SLOTS} H={h} D={d} block={BLOCK} "
          f"pos={pos_np.tolist()}: max_abs_err={err:.3e}")
    if not ok:
        fail(f"paged_attention disagrees with its plain version ({err:.3e})")
    def kern():
        for k, v in pools:
            pa.paged_attention(q, k, v, tables, pos)

    def plain_fn():
        for k, v in pools:
            pa._plain(q, k, v, tables, pos)
    ms = graph_ms(torch, kern) / LAYERS
    eager = call_ms(torch, kern, 10) / LAYERS
    plain = graph_ms(torch, plain_fn, 5) / LAYERS
    # library yardstick: SDPA on views gathered beforehand (the gather
    # itself is not timed), masked to each slot's rows <= pos
    views = [tuple(pa.gather_block_rows(t, tables).permute(0, 2, 1, 3)
                   .contiguous() for t in kv) for kv in pools]
    t_idx = torch.arange(nb * BLOCK, device=dev)
    mask = (t_idx[None, :] <= pos[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def lib_fn():
        for k, v in views:
            sdpa(q4, k, v, attn_mask=mask)
    lib = graph_ms(torch, lib_fn) / LAYERS
    rows = int(np.minimum(pos_np + 1, nb * BLOCK).sum())
    nbytes = (rows * h * d * 4 * 2 + 2 * q.numel() * 4
              + tables.numel() * 4 + pos.numel() * 4)
    b, by = bound_ms(nbytes, 4.0 * rows * h * d)
    return {"name": "paged_attention", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/paged_attention.cu",
            "replaces": "paddle_tpu/ops/paged_attention.py:109",
            "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": b,
            "bound_by": by, "library_ms": lib, "call_ms": eager}


def device_profile(torch, step, steps: int, what: str, card: str):
    """Where a steady step's time goes: host wall per step (no profiler),
    then device busy time per step and the top kernels from torch.profiler
    over as many further steps.  Prints them; returns (wall ms, busy ms or
    None)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    rows = []
    for e in prof.key_averages():
        if e.device_type != cuda:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((us / 1e3 / steps, e.key))
    rows.sort(reverse=True)
    busy = sum(ms for ms, _ in rows)
    print(f"profile [{card}]: {what}: wall {step_ms:.3f} ms, device busy "
          + (f"{busy:.3f} ms, idle {1 - busy / step_ms:.1%}" if rows
             else "not measured (no device events)"))
    for ms, name in rows[:8]:
        print(f"profile:   {ms:8.3f} ms/step  {name[:90]}")
    return step_ms, (busy if rows else None)


def decode_profile(torch, eng, steps: int, card: str):
    device_profile(torch, eng.step, steps,
                   f"decode step (8 slots x {eng.decode_chunk} tokens, "
                   f"{eng.model.gpt.config.num_hidden_layers} layers)", card)


def serve_phase(torch, args, dev, card):
    """GPT-2 medium, int8 weights, paged KV: the main path."""
    from paddle_tpu_torch.generation import generate
    from paddle_tpu_torch.models import GPTForPretraining, gpt2_medium_config
    from paddle_tpu_torch.ops import int8_matmul as im
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.quantization import quantize_for_serving
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.serving.engine import paged_decode_logits

    cfg = gpt2_medium_config(hidden_dropout_prob=0.0,
                             attention_probs_dropout_prob=0.0)
    model = GPTForPretraining(cfg, device=dev, seed=args.seed).eval()
    quantize_for_serving(model)
    eng = ServingEngine(model, max_slots=SLOTS, max_len=MAX_LEN,
                        kv="paged", block_size=BLOCK, device=dev)
    warm = eng.warmup()
    print(f"serve: warmup {warm['seconds']:.2f}s")
    rng = np.random.RandomState(args.seed)
    prompts = [rng.randint(0, cfg.vocab_size, (n,)) for n in PROMPT_LENS]
    sampled = {3: dict(temperature=0.8, top_k=40, top_p=0.9, seed=11),
               6: dict(temperature=1.2, top_k=0, top_p=0.8, seed=12)}
    torch.cuda.synchronize()
    im.dequant_matmul.launches = 0
    pa.paged_attention.launches = 0
    t0 = time.perf_counter()
    resps = [eng.submit(p, max_new_tokens=64,
                        **({"decode_strategy": "sampling", **sampled[i]}
                           if i in sampled else {}))
             for i, p in enumerate(prompts)]
    eng.run_until_drained(timeout=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"int8_matmul": im.dequant_matmul.launches,
                "paged_attention": pa.paged_attention.launches}
    outs = [r.tokens(timeout=5) for r in resps]
    if any(len(o) != 64 for o in outs):
        fail("a request did not produce 64 tokens")
    if any(not (0 <= t < cfg.vocab_size) for o in outs for t in o):
        fail("token out of the vocabulary")
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")
    ttfts = sorted(r.ttft for r in resps)
    total = sum(len(o) for o in outs)
    print(f"serve [{card}]: 8 requests, {total} tokens in {wall:.3f}s: "
          f"{total / wall:.1f} tokens/s; TTFT p50 "
          f"{ttfts[len(ttfts) // 2] * 1e3:.1f} ms, max "
          f"{ttfts[-1] * 1e3:.1f} ms; launches {launches}")

    # one decode step, kernel path vs plain path on the same KV state
    check = [eng.submit(p, max_new_tokens=40) for p in prompts]
    eng.step()                       # admits all eight + one decode chunk
    eng._ensure_decode_blocks()      # back the next row, as a step would
    b = eng._batch
    tables_np, tables_dev = eng._paged_tables()
    state = dict(tables_np=tables_np.copy(), active=b["active"].copy(),
                 pos=b["pos"].copy(), tokens=b["tokens"].clone())
    pools = [(k.clone(), v.clone()) for k, v in eng._pools]
    geo = (eng.kv_pool.num_blocks, BLOCK, MAX_LEN)
    with torch.inference_mode():
        kern = paged_decode_logits(
            model, pools, state["tables_np"], tables_dev, state["active"],
            state["pos"], state["tokens"], *geo).cpu()
        cpu_model = copy.deepcopy(model).cpu()
        cpu_pools = [(k.cpu(), v.cpu()) for k, v in eng._pools]
        plain = paged_decode_logits(
            cpu_model, cpu_pools, state["tables_np"],
            torch.from_numpy(state["tables_np"]), state["active"],
            state["pos"], state["tokens"].cpu(), *geo)
    del cpu_model, cpu_pools, pools
    decode_profile(torch, eng, 3, card)
    eng.run_until_drained(timeout=300)
    [r.tokens(timeout=5) for r in check]
    err = float((kern - plain).abs().max())
    print(f"serve: decode-step logits kernel path vs plain path: max abs "
          f"err {err:.3e} (tolerance {LOGIT_TOL}), |logits| max "
          f"{float(plain.abs().max()):.3f}")
    if not err <= LOGIT_TOL:
        fail(f"decode logits disagree: {err:.3e}")
    agree = []
    for i, p in enumerate(prompts):
        if i in sampled:
            continue
        solo, _ = generate(model, p, max_new_tokens=64, device=dev)
        solo = solo[0].tolist()
        agree.append(sum(a == s for a, s in zip(outs[i], solo)))
    print(f"serve: greedy tokens equal to solo generate(): {agree} of 64 "
          "per request")
    eng.close()
    return launches


def fixed_phase(torch, args, dev):
    """4-layer full-width f32 engine on the fixed pool vs solo generate."""
    from paddle_tpu_torch.generation import generate
    from paddle_tpu_torch.models import GPTForPretraining, gpt2_medium_config
    from paddle_tpu_torch.serving import ServingEngine
    cfg = gpt2_medium_config(num_hidden_layers=4, hidden_dropout_prob=0.0,
                             attention_probs_dropout_prob=0.0)
    model = GPTForPretraining(cfg, device=dev, seed=args.seed + 1).eval()
    eng = ServingEngine(model, max_slots=SLOTS, max_len=256, kv="fixed",
                        device=dev)
    rng = np.random.RandomState(args.seed + 1)
    prompts = [rng.randint(0, cfg.vocab_size, (n,))
               for n in (5, 17, 40, 64, 90, 120)]
    resps = [eng.submit(p, max_new_tokens=32) for p in prompts]
    eng.run_until_drained(timeout=300)
    for p, r in zip(prompts, resps):
        solo, _ = generate(model, p, max_new_tokens=32, device=dev)
        if r.tokens(timeout=5) != solo[0].tolist():
            fail("fixed-pool greedy stream differs from solo generate()")
    eng.close()
    print(f"fixed: {len(prompts)} greedy streams equal solo generate()")


def _flash_inputs(torch, rng, dev, b, sq, sk, h, d, dtype, bias=False,
                  seg=False):
    """q/k/v as views of one fused (B, S, 3, H, D) tensor, as GPT passes
    them; do, an optional bias and two-segment ids."""
    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            dev).to(dtype)
    qkv = t(b, sq, 3, h, d)
    q = qkv[:, :, 0]
    if sk == sq:
        k, v = qkv[:, :, 1], qkv[:, :, 2]
    else:
        k, v = t(b, sk, h, d), t(b, sk, h, d)
    bi = qs = ks = None
    if bias:
        bi = torch.from_numpy(rng.randn(b, sk).astype(np.float32)).to(dev)
    if seg:
        qs = torch.zeros(b, sq, dtype=torch.int32, device=dev)
        ks = torch.zeros(b, sk, dtype=torch.int32, device=dev)
        qs[:, sq // 2:] = 1
        ks[:, sk // 3:] = 1
    return q, k, v, t(b, sq, h, d), bi, qs, ks


def flash_check(torch, fa, args, label):
    """K1 and K2 against their plain versions on the same inputs; returns
    the largest error and prints one line."""
    q, k, v, do, bi, qs, ks, seed, causal, p = args
    o, lse = fa.flash_fwd(q, k, v, bi, qs, ks, seed, causal, p)
    grads = fa.flash_bwd(q, k, v, bi, qs, ks, seed, o, lse, do, causal, p)
    po, plse = fa._plain_fwd(q, k, v, bi, qs, ks, seed, causal, p)
    pgrads = fa._plain_bwd(q, k, v, bi, qs, ks, seed, o, lse, do, causal, p)
    torch.cuda.synchronize()
    (oa, orl), (ga, grl) = FLASH_TOL[str(q.dtype).replace("torch.", "")]
    errs = {"o": max_err(torch, o, po, oa, orl),
            "lse": max_err(torch, lse, plse)}
    for name, g, pg in zip(("dq", "dk", "dv", "dbias"), grads, pgrads):
        if pg is not None:
            errs[name] = max_err(torch, g, pg, ga, grl)
    bad = [n for n, (_, ok) in errs.items() if not ok]
    print(f"check flash {label}: " + ", ".join(
        f"{n} {e:.2e}" for n, (e, _) in errs.items())
        + (f" OUT OF TOLERANCE: {bad}" if bad else ""))
    if bad:
        fail(f"flash attention disagrees with its plain version ({label}: "
             f"{bad})")
    return max(e for e, _ in errs.values())


def flash_phase(torch, rng, dev):
    """K1/K2 checked at the training shape in bf16 and f32 and at small
    variant shapes; timed at the training shape in bf16 per layer over 24
    layers' tensors."""
    from paddle_tpu_torch.ops import flash_attention as fa
    b, s, h, d, p = TRAIN_B, TRAIN_S, 16, 64, 0.1
    seed = torch.tensor([20260417], dtype=torch.int32, device=dev)
    err_f, err_b = 0.0, 0.0
    for dtype in (torch.bfloat16, torch.float32):
        ins = _flash_inputs(torch, rng, dev, b, s, s, h, d, dtype)
        e = flash_check(torch, fa, (*ins[:4], None, None, None, seed, True,
                                    p), f"{str(dtype)[6:]} B={b} S={s} "
                                        f"H={h} D={d} causal p={p}")
        err_f = max(err_f, e)
        torch.cuda.empty_cache()
    for name, (bb, sq, sk, hh, dd, dt, causal, bias, seg, pp) in {
            "bias": (2, 256, 256, 2, 64, torch.float32, False, True, False,
                     0.0),
            "segments": (2, 256, 256, 2, 128, torch.float32, False, False,
                         True, 0.0),
            "sk!=sq": (2, 128, 384, 2, 64, torch.bfloat16, True, False,
                       False, 0.1),
            "bias+dropout d256": (1, 256, 256, 2, 256, torch.float32, True,
                                  True, False, 0.2)}.items():
        q, k, v, do, bi, qs, ks = _flash_inputs(
            torch, rng, dev, bb, sq, sk, hh, dd, dt, bias, seg)
        err_b = max(err_b, flash_check(
            torch, fa, (q, k, v, do, bi, qs, ks, seed, causal, pp),
            f"{name} {str(dt)[6:]} B={bb} Sq={sq} Sk={sk} H={hh} D={dd}"))

    # timing: 24 layers' distinct bf16 tensors (the step's working set)
    layers = [_flash_inputs(torch, rng, dev, b, s, s, h, d,
                            torch.bfloat16)[:4] for _ in range(LAYERS)]
    saved = [fa.flash_fwd(q, k, v, None, None, None, seed, True, p)
             for q, k, v, _ in layers]

    def fwd(f):
        def run():
            for q, k, v, _ in layers:
                f(q, k, v, None, None, None, seed, True, p)
        return run

    def bwd(f):
        def run():
            for (q, k, v, do), (o, lse) in zip(layers, saved):
                f(q, k, v, None, None, None, seed, o, lse, do, True, p)
        return run
    times = {"fwd": (graph_ms(torch, fwd(fa.flash_fwd)) / LAYERS,
                     call_ms(torch, fwd(fa.flash_fwd), 5) / LAYERS,
                     graph_ms(torch, fwd(fa._plain_fwd), 3) / LAYERS),
             "bwd": (graph_ms(torch, bwd(fa.flash_bwd)) / LAYERS,
                     call_ms(torch, bwd(fa.flash_bwd), 5) / LAYERS,
                     graph_ms(torch, bwd(fa._plain_bwd), 3) / LAYERS)}
    torch.cuda.empty_cache()
    # library yardstick: torch's SDPA, causal, dropout 0.1, on the same
    # inputs in its (B, H, S, D) view; backward = (fwd + grad) - fwd
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_in = [tuple(t.transpose(1, 2).detach().requires_grad_()
                    for t in (q, k, v)) + (do.transpose(1, 2),)
              for q, k, v, do in layers]

    def lib_fwd():
        for q, k, v, _ in lib_in:
            sdpa(q, k, v, is_causal=True, dropout_p=p)

    def lib_fwd_bwd():
        for q, k, v, do in lib_in:
            out = sdpa(q, k, v, is_causal=True, dropout_p=p)
            torch.autograd.grad(out, (q, k, v), do)
    lib_f = graph_ms(torch, lib_fwd) / LAYERS
    lib_b = graph_ms(torch, lib_fwd_bwd) / LAYERS - lib_f
    # bound per layer, from this run's shapes: each input read once, each
    # output written once; tensor-core operations over the visible
    # (causal) score pairs, 2 * D per pair and product
    elem = b * s * h * d * 2                       # one bf16 (B, S, H, D)
    pairs = b * h * s * (s + 1) // 2
    rows = b * h * s * 4                           # one f32 (B, H, S)
    bound = {"fwd": bound_ms(3 * elem + elem + rows + 4, 2 * 2 * d * pairs,
                             BF16_OPS_PER_S),
             # q, k, v, o, do and lse in; dq, dk, dv out; 5 products
             "bwd": bound_ms(5 * elem + rows + 4 + 3 * elem,
                             5 * 2 * d * pairs, BF16_OPS_PER_S)}
    out = []
    for key, lib, err, line in (("fwd", lib_f, err_f, 257),
                                ("bwd", lib_b, max(err_f, err_b), 417)):
        ms, eager, plain = times[key]
        bms, by = bound[key]
        print(f"time flash_attention_{key} (bf16, per layer): {ms:.4f} ms "
              f"(call {eager:.4f}), plain {plain:.4f}, SDPA {lib:.4f}, "
              f"bound {bms:.4f} ({by})")
        out.append({"name": f"flash_attention_{key}", "route": "cuda",
                    "source": "paddle_tpu_torch/csrc/flash_attention.cu",
                    "replaces": f"paddle_tpu/ops/flash_attention.py:{line}",
                    "max_abs_err": err, "ms": ms, "plain_ms": plain,
                    "bound_ms": bms, "bound_by": by, "library_ms": lib,
                    "call_ms": eager})
    del layers, saved, lib_in
    torch.cuda.empty_cache()
    return out


def _train_batch(cfg, seed: int, b: int, s: int):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, cfg.vocab_size, (b, s)),
            rng.randint(0, cfg.vocab_size, (b, s)))


def train_phase(torch, args, dev, card):
    """GPT-2 medium, O1 bf16, AdamW: the training leg of the main path."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (GPTForPretraining,
                                         GPTPretrainingCriterion,
                                         gpt2_medium_config)
    from paddle_tpu_torch.ops import flash_attention as fa
    pt.seed(args.seed)
    cfg = gpt2_medium_config()
    model = GPTForPretraining(cfg, device=dev, seed=args.seed)
    crit = GPTPretrainingCriterion()
    opt = pt.optimizer.AdamW(learning_rate=1e-4,
                             parameters=model.parameters())
    step = TrainStep(model, lambda logits, y: crit(logits, y), opt,
                     amp_level="O1", amp_dtype="bfloat16")
    ids, lab = (torch.from_numpy(a).to(dev)
                for a in _train_batch(cfg, args.seed, TRAIN_B, TRAIN_S))
    torch.cuda.synchronize()
    fa.flash_fwd.launches = 0
    fa.flash_bwd.launches = 0
    losses, t_steps = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(step(ids, lab))
        torch.cuda.synchronize()
        t_steps.append(time.perf_counter() - t0)
    launches = {"flash_attention_fwd": fa.flash_fwd.launches,
                "flash_attention_bwd": fa.flash_bwd.launches}
    vals = [float(x) for x in losses]
    print("train: losses " + ", ".join(f"{x:.4f}" for x in vals))
    want = cfg.num_hidden_layers * TRAIN_STEPS
    if not all(np.isfinite(vals)):
        fail(f"non-finite training loss: {vals}")
    if not vals[-1] < vals[0]:
        fail(f"training loss did not fall: {vals[0]} -> {vals[-1]}")
    if any(n != want for n in launches.values()):
        fail(f"flash launches {launches}, expected {want} each "
             f"({cfg.num_hidden_layers} layers x {TRAIN_STEPS} steps)")
    steady = float(np.median(t_steps[2:])) * 1e3
    print(f"train [{card}]: GPT-2 medium B={TRAIN_B} S={TRAIN_S} O1 bf16: "
          f"first step {t_steps[0] * 1e3:.1f} ms, steady step {steady:.1f} "
          f"ms (median of steps 3-{TRAIN_STEPS}), "
          f"{TRAIN_B * TRAIN_S / steady * 1e3:.0f} tokens/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB; "
          f"launches {launches}")
    device_profile(torch, lambda: step(ids, lab), 1,
                   f"train step (GPT-2 medium, B {TRAIN_B} x S {TRAIN_S}, "
                   "O1 bf16)", card)
    del step, model, opt
    torch.cuda.empty_cache()
    return launches


def train_check_phase(torch, args, dev):
    """One f32 step of a 2-layer full-width GPT (dropout 0, B 1, S 1024):
    loss and every parameter gradient on the kernel path against the plain
    versions on the CPU, same weights and batch."""
    from paddle_tpu_torch.jit import forward_loss
    from paddle_tpu_torch.models import (GPTForPretraining,
                                         GPTPretrainingCriterion,
                                         gpt2_medium_config)
    from paddle_tpu_torch.ops import flash_attention as fa
    cfg = gpt2_medium_config(num_hidden_layers=2, hidden_dropout_prob=0.0,
                             attention_probs_dropout_prob=0.0)
    crit = GPTPretrainingCriterion()
    batch = _train_batch(cfg, args.seed + 2, 1, TRAIN_S)
    gpu = GPTForPretraining(cfg, device=dev, seed=args.seed + 2)
    cpu = copy.deepcopy(gpu).cpu()
    out = []
    for model, d in ((gpu, dev), (cpu, torch.device("cpu"))):
        n0 = fa.flash_fwd.launches
        ids, lab = (torch.from_numpy(a).to(d) for a in batch)
        loss = forward_loss(model, lambda lg, y: crit(lg, y), (ids, lab))
        names = [n for n, _ in model.named_parameters()]
        grads = torch.autograd.grad(loss, [p for _, p in
                                           model.named_parameters()])
        out.append((float(loss.detach()),
                    {n: g.cpu() for n, g in zip(names, grads)},
                    fa.flash_fwd.launches - n0))
    (lg, gg, ng), (lc, gc, _) = out
    if ng != cfg.num_hidden_layers:
        fail(f"the kernel path launched K1 {ng} times, not once per layer")
    worst = max(((gg[n] - gc[n]).abs().max() / gc[n].abs().max()
                 .clamp_min(1e-30)).item() for n in gc)
    print(f"traincheck: 2-layer f32 step, kernel path vs CPU plain path: "
          f"loss {lg:.6f} vs {lc:.6f}; largest gradient difference "
          f"{worst:.2e} of its tensor's max (tolerance {GRAD_TOL}) over "
          f"{len(gc)} parameters")
    if not abs(lg - lc) <= 1e-4 * abs(lc) or not worst <= GRAD_TOL:
        fail("the kernel-path training step disagrees with the plain path")
    del gpu, cpu
    torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    try:
        from paddle_tpu_torch.ops import _build
    except ImportError as e:
        fail(f"run from the root of a checkout of the repository ({e})")
    if "jax" in sys.modules:
        fail("the port imported jax")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"device: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    t0 = time.perf_counter()
    rep = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f}s "
          f"({len(rep['logs'])} compiled now)")
    for name, log in rep["logs"].items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build {name}: {line.strip()}")
    rng = np.random.RandomState(args.seed)
    kernels = [paged_phase(torch, rng, dev), int8_phase(torch, rng, dev)]
    torch.cuda.empty_cache()
    launches = serve_phase(torch, args, dev, card)
    torch.cuda.empty_cache()
    fixed_phase(torch, args, dev)
    torch.cuda.empty_cache()
    kernels += flash_phase(torch, rng, dev)
    launches.update(train_phase(torch, args, dev, card))
    train_check_phase(torch, args, dev)
    if any(m.startswith("paddle_tpu.") or m in ("jax", "paddle_tpu")
           for m in sys.modules):
        fail("the JAX package was imported")
    for k in kernels:
        k["launches"] = launches[k["name"]]
    order = ["name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "call_ms"]
    print(card)
    print(json.dumps({"kernels": [{key: k[key] for key in order}
                                  for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
