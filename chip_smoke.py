"""Chip smoke test of paddle_tpu_torch on one CUDA card (H100).

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero before the result line):
  1. device   — prints the card's name and power limit (nvidia-smi);
                no CUDA device -> exit 1.
  2. build    — builds every kernel from paddle_tpu_torch/csrc with nvcc.
  3. check    — each kernel against its plain PyTorch version on the card
                at the main path's shapes (int8_matmul at the decode M and
                at every prefill bucket the serve, pressure and prefix
                phases' prompts fill;
                paged_attention also at max_len 4096 with slots at pos
                4095 and 0), in f32 and with bf16 operands (K3: every pair
                of q and pool dtypes); |kernel - plain| must stay within
                1e-4 + 1e-4 * |plain| in f32 (sums in another order) and
                1e-3 + 8e-3 * |plain| with bf16 (one bf16 unit), and two
                calls must give bit-equal results.
  4. time     — device times (a CUDA graph replayed, CUDA events) of each
                kernel, its plain version and a PyTorch library call on the
                same inputs, over a sweep of 24 layers' distinct tensors (the
                weights / KV do not fit the 50 MB L2, as in a real decode
                step), beside the bound; "call_ms" is the kernel called
                eagerly, host launch cost included.  paged_attention is
                also timed at the serve phase's own positions, and
                int8_matmul at the largest prefill bucket; both in f32 and
                in bf16 (rows "paged_attention_bf16", "int8_matmul_bf16").
  5. serve    — GPT-2 medium (24 x 1024, vocab 50304), random weights from
                --seed, int8 weight-only, paged KV (block 16, 8 slots,
                max_len 1024): warmup must capture every program as a
                CUDA graph (one prefill per bucket, the decode chunk
                all-greedy and mixed: len(buckets) + 2).  8 requests
                (prompts 32..400, 64 new tokens, 6 greedy + 2 sampled)
                through the captured engine; kernel launch counters are
                zeroed just before and read just after (the engine adds
                each graph's K3 / K4 launches at every replay); both must be
                > 0.  The same requests then run through the same program
                functions uncaptured: greedy streams must be equal, and no
                program may be captured after warmup.  Then one decode
                step's logits on the kernel path are held against the same
                step run by the plain versions (on the CPU) on the same KV
                state, the decode step is profiled captured and uncaptured
                (wall, device busy, idle share, kernels per step; the
                graph's replay span by CUDA events), and greedy agreement
                with solo generate() is printed.  Then the same for the
                model decorated to bf16 (amp.decorate O2, then int8) on
                bf16 pools (ServingEngine(dtype=torch.bfloat16)): K3/K4
                launch on bf16 operands, and the logits stay within 5% of
                their largest |value| of the CPU plain path.  Each run
                prints tokens/s, TTFT p50 and max, warmup seconds and the
                capture count, captured and uncaptured.
  6. pressure — the serve model (f32) on a paged pool of 224 blocks where
                512 back every slot: 16 requests (prompts 200..400, 256 new
                tokens, 12 greedy + 4 keyed-sampled), first on the full
                pool, then on the short one, each engine captured.  On the
                short pool runs must be preempted and parked (at least
                one), every one resumed, none failed, and every stream must
                equal the full pool's token for token.  K3 / K4 launches
                counted through the replays of each run (zeroed just
                before, read just after) must be > 0.  Prints tokens/s,
                TTFT and the ms of each preemption and restore.
  7. prefix   — the serve model with prefix_cache=True against the same
                engine without: one request of a 384-token prefix plus 16
                tokens fills the cache, then 16 greedy requests of the
                prefix plus 16..96 tokens and the bare prefix (24 full
                blocks: copy-on-write), 64 new tokens each.  The cache must
                hit, copy once, capture nothing after warmup and leave the
                prefix's 24 blocks unchanged bit for bit; K3 / K4 must
                launch; a stream may split from the uncached engine's only
                where the uncached path's top-two logit margin is below
                2e-3 (each split printed with its margin).  Prints TTFT p50
                and max with and without the cache, and the device ms of a
                warm prefill (bucket 64 at cached_len 384) against a cold
                one (bucket 512; and the uncached engine's bucket 512).
  8. fixed    — 4-layer full-width engines on the fixed pool, captured, f32
                and bf16: greedy streams must equal the uncaptured path's,
                and in f32 solo generate()'s.
  9. flash    — the tensor-core instructions (HMMA / HGMMA lines of
                cuobjdump -sass) of every kernel in the built flash
                library, failing if a bf16 (tensor-core route) kernel has
                none; the flash kernels K1 (forward) and K2 (backward)
                against their plain versions on the card at the training
                shape (B 4, S 1024, H 16, D 64, causal, dropout 0.1, fixed
                seed) in bf16 and f32, and at small shapes with a bias,
                segment ids, Sk != Sq, D 128 and D 256, in both types
                (every gradient, dbias included); two bf16 K2 calls at the
                training shape must give bit-equal gradients, and the peak
                memory of one call is printed; then timed like K3/K4 over
                24 layers' tensors, beside the bound and torch's
                scaled_dot_product_attention as the yardstick.
 10. train    — GPT-2 medium (24 x 1024, 16 heads, vocab 50304), B 4,
                S 1024, O1 bf16, AdamW(1e-4), dropout 0.1, random weights
                and one random batch from --seed, through jit.TrainStep's
                captured step: warmup() captures the step's CUDA graph
                (timed; no capture may follow), 8 steps replay it, each
                loss printed, steady step time and tokens/s; the loss must
                be finite and fall, and K1/K2 must launch 24 times per
                step each through the replays (counters zeroed just before
                the steps).  A steady step is profiled (wall, device busy,
                idle share, kernels), and one uncaptured step gives the
                peak memory.  Then the same 8 steps uncaptured (the same
                program functions without the graph, from the same seed):
                losses must be bit-equal to the captured run's.  Then 3
                captured steps under recompute_policy("stages") with
                "dots_saveable" and with "nothing_saveable": losses within
                1e-5 relative of the plain run's (bit-equality expected;
                both printed), K1 48 and K2 24 launches per step, peak
                memory below the plain run's, device time printed.
 11. traincheck — one step's loss and every parameter's gradient of a
                2-layer full-width f32 GPT (dropout 0, B 1, S 1024) on the
                kernel path against the same step by the plain versions on
                the CPU, same weights and batch.
 12. bn       — the fused BatchNorm kernels K5-K9 against their plain
                versions on the card: at the ResNet-50 b256 main path's
                shapes (the stem, 3,211,264 x 64; layer1's bn3 with its
                residual, 802,816 x 256; layer4, 12,544 x 2048) and at
                small odd shapes (C 24 and 40, M no multiple of any
                block), f32 and bf16, every activation, no / plain / dual
                residual; then the three autograd Functions (outputs,
                statistics, dx / dgamma / dbeta / dres) against autograd
                of the plain references.  Kernels: f32 within 1e-5 of each
                tensor's largest |value|, bf16 within one bf16 unit
                (1e-2 + 1e-2 * |plain|).  Functions: f32 within 1e-4 of
                each tensor's largest |value|, bf16 within 2e-2 of it
                plus 2e-2 * |plain|, at most one element in a million off
                (an activation mask flipped by statistics summed in
                another order).  K9 (bn_pool_apply) takes its ring route
                where the row slots fit (the bf16 stem must; rings of up
                to 28 slots are checked) and its window route elsewhere
                and for a bf16 average; both are checked, max bit-equal
                to the plain version, a bf16 average within one bf16
                unit (2**-7 of the larger value, plus 1e-5 of the largest
                |value|), two calls bit-equal.  Then each kernel timed
                (CUDA graph replay) at layer1's bn3 and at the stem, beside
                its bound, its plain version and PyTorch's own BatchNorm
                kernels; K9's ring route in turns with its window route.
 13. resnet   — ResNet-50 (BASELINE config #2): resnet50() under
                jit.layout_policy("NHWC"), TrainStep O2 bf16, cross-entropy
                on the logits, Momentum(0.1, 0.9), one random batch of
                256 x 3 x 224 x 224 from --seed, 8 steps through the
                captured step (as the train phase: warmup captures, no
                capture follows): each loss printed (all finite), the
                steady step's wall, images/s, device busy and idle share,
                the top device entries with the cuDNN convolutions and
                K5-K9 summed apart, K5-K9 launches per step through the
                replays (asserted against the counts derived from the
                model's blocks; K9 on its ring route), layout copies per
                step, peak memory.  Then the same 8 steps uncaptured
                (losses bit-equal; its profile puts the stem's plain
                backward recompute, _BnPool.backward, on a line of its
                own), and 3 captured steps under recompute_policy("stages")
                (losses within 1e-5 relative, K5 / K6 launched again at
                every block site: 105 / 96 per step, peak memory below the
                plain run's).  Then K7 and K8 timed at each of the step's
                48 BN backward sites' shapes beside each site's bound.
 14. resnetcheck — one f32 step of ResNet-18 (10 classes, 4 x 3 x 64 x 64)
                on the kernel path against the same step by the plain
                versions on the CPU, same weights and batch: the loss,
                every gradient and every running statistic within 1e-3 of
                its tensor's largest |value|.
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
# K3 / K4 on bf16 operands, (atol, rtol): kernel and plain version both
# compute in f32 and round once to bf16, so f32 values that differ in
# their last bits may round to neighbouring bf16 values: one bf16 unit
# (8e-3 > 2**-7, a unit's largest relative size)
BF16_TOL = (1e-3, 8e-3)
LOGIT_TOL = 2e-3    # kernel-path vs plain-path decode logits, max abs
# the same in bf16, as a share of the logits' largest |value|: the card
# and the CPU round the bf16 activations of 24 layers at other places
# (cuBLAS and the CPU's matmul, layer norm), a few bf16 units each
BF16_LOGIT_TOL = 5e-2
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
# pressure phase: 224 blocks where parity would give 512 (8 x 64); 16
# requests of 200..400 prompt tokens and 256 new ones, every 4th sampled
PRESSURE_BLOCKS, PRESSURE_NEW = 224, 256
PRESSURE_LENS = tuple(int(n) for n in np.linspace(200, 400, 16))
# prefix phase: 16 requests of one 384-token prefix plus 16..96 suffix
# tokens (buckets 16..128 of the suffix), and the bare prefix (24 full
# blocks: the copy-on-write path), 64 new tokens each
PREFIX_LEN, PREFIX_NEW = 384, 64
PREFIX_SUFFIXES = tuple(int(n) for n in np.linspace(16, 96, 16))
MARGIN_TOL = 2e-3   # a cached / uncached greedy split needs a nearer tie
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 1024, 8               # train phase
RECOMPUTE_STEPS = 3        # the train / resnet phases' recompute legs
RESNET_B, RESNET_HW, RESNET_STEPS = 256, 224, 8           # resnet phase
# the fused-BN kernels' main-path shapes at batch 256, as (N, H, W, C)
BN_STEM = (RESNET_B, 112, 112, 64)       # M = 3,211,264
BN_LAYER1 = (RESNET_B, 56, 56, 256)      # layer1's bn3, M = 802,816
BN_LAYER4 = (RESNET_B, 7, 7, 2048)       # M = 12,544
BN_KERNELS = ("bn_stats", "bn_apply", "bn_bwd_reduce", "bn_bwd_dx",
              "bn_pool_apply")
BN_LINES = {"bn_stats": 119, "bn_apply": 132, "bn_bwd_reduce": 153,
            "bn_bwd_dx": 183, "bn_pool_apply": 611}


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
    """The prefill buckets (M of every prefill Linear) the serve,
    pressure and prefix phases' prompts (the prefix phase's: their
    uncached suffixes) land in, by the engine's own default bucket rule."""
    from paddle_tpu_torch.serving.engine import _default_buckets
    buckets = _default_buckets(MAX_LEN)
    lens = (PROMPT_LENS + PRESSURE_LENS + PREFIX_SUFFIXES
            + (PREFIX_LEN + PREFIX_SUFFIXES[0], 1))
    return sorted({min(b for b in buckets if b >= n) for n in lens})


def int8_phase(torch, rng, dev):
    """K4 checked at every M of the main path (8 decode slots and each
    prefill bucket) over one GPT-2-medium layer's four Linears, with f32
    and bf16 x, two calls bit-equal at each; timed per layer in both types
    at decode M and at the largest prefill bucket, swept over 24 layers'
    weights.  Returns the f32 and the bf16 row of the kernel table."""
    from paddle_tpu_torch.ops import _build, int8_matmul as im
    from paddle_tpu_torch.quantization import quantize_weight_int8
    shapes = [(1024, 3072), (1024, 1024), (1024, 4096), (4096, 1024)]
    layers = []
    for _ in range(LAYERS):
        ws = []
        for k, n in shapes:
            w = torch.randn(k, n, device=dev) * 0.02
            ws.append(quantize_weight_int8(w))
        layers.append(ws)
    ms_at = [SLOTS] + prefill_buckets()
    xs_at = {mc: {k: torch.from_numpy(rng.randn(mc, k).astype(np.float32))
                  .to(dev) for k in (1024, 4096)} for mc in ms_at}
    sms = _build.sm_count(dev.index)
    rows = []
    for dt, (atol, rtol) in ((torch.float32, (TOL, TOL)),
                             (torch.bfloat16, BF16_TOL)):
        name = "int8_matmul" + ("" if dt == torch.float32 else "_bf16")
        xs_dt = {mc: {k: x.to(dt) for k, x in xs.items()}
                 for mc, xs in xs_at.items()}
        err, ok = 0.0, True
        for mc in ms_at:
            for (k, n), (wi, s) in zip(shapes, layers[0]):
                x = xs_dt[mc][k]
                got = im.dequant_matmul(x, wi, s)
                again = im.dequant_matmul(x, wi, s)
                want = im._plain(x, wi, s)
                torch.cuda.synchronize()
                e, o = max_err(torch, got, want, atol, rtol)
                rep = torch.equal(got, again)
                o = o and got.dtype == dt
                err, ok = max(err, e), ok and o and rep
                print(f"check {name} M={mc} K={k} N={n} "
                      f"{im._plan(mc, k, n, sms, x.element_size())}: "
                      f"max_abs_err={e:.3e}"
                      f"{'' if o else ' OUT OF TOLERANCE'}"
                      f"{'' if rep else ' NOT BIT-REPEATABLE'}")
        if not ok:
            fail(f"{name} disagrees with its plain version or does not "
                 f"repeat ({err:.3e})")
        rows.append(_int8_time(torch, im, layers, shapes, xs_dt,
                               [SLOTS, ms_at[-1]], name, err))
    return rows


def _int8_time(torch, im, layers, shapes, xs_at, ms, name, err):
    """K4's row of the kernel table: ms per layer (graph replay over 24
    layers' weights), plain and library times and the bound at decode M
    (and printed at the largest prefill M)."""
    def sweep(f, xs):
        def run():
            for ws in layers:
                for (k, n), (wi, s) in zip(shapes, ws):
                    f(xs[k], wi, s)
        return run

    def bound(m, elem):
        nbytes = sum(m * k * elem + k * n + 4 * n + m * n * elem
                     for k, n in shapes)
        return bound_ms(nbytes, sum(2 * m * k * n for k, n in shapes))
    lib_f = lambda x, wi, s: torch.matmul(x, wi.to(x.dtype) * s.to(x.dtype))
    out = {}
    for mc in ms:
        xs = xs_at[mc]
        elem = xs[1024].element_size()
        out[mc] = dict(ms=graph_ms(torch, sweep(im.dequant_matmul, xs)) / LAYERS,
                       plain=graph_ms(torch, sweep(im._plain, xs)) / LAYERS,
                       lib=graph_ms(torch, sweep(lib_f, xs)) / LAYERS,
                       bound=bound(mc, elem))
        print(f"time {name} M={mc}: {out[mc]['ms']:.4f} ms per layer "
              f"(plain {out[mc]['plain']:.4f}, matmul(x, w.to(x.dtype)*s) "
              f"{out[mc]['lib']:.4f}, bound {out[mc]['bound'][0]:.4f} "
              f"{out[mc]['bound'][1]})")
    d = out[ms[0]]
    eager = call_ms(torch, sweep(im.dequant_matmul, xs_at[ms[0]]), 10) / LAYERS
    return {"name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/int8_matmul.cu",
            "replaces": "paddle_tpu/ops/int8_matmul.py:49",
            "max_abs_err": err, "ms": d["ms"], "plain_ms": d["plain"],
            "bound_ms": d["bound"][0], "bound_by": d["bound"][1],
            "library_ms": d["lib"], "call_ms": eager}


def _paged_case(torch, rng, dev, pos_np, nb, h=16, d=64, block=BLOCK,
                layers=1):
    """q, per-layer (kpool, vpool), tables, pos for len(pos_np) slots:
    each slot owns nb table entries, the live ones from a random
    permutation of the pool, the tail holding the allocator's sentinel."""
    s = len(pos_np)
    num_blocks = s * nb
    tables_np = np.full((s, nb), num_blocks, np.int32)
    perm = rng.permutation(num_blocks)
    for i, p in enumerate(pos_np):
        live = min(-(-(int(p) + 1) // block), nb)
        tables_np[i, :live] = perm[i * nb:i * nb + live]
    q = torch.from_numpy(rng.randn(s, h, d).astype(np.float32)).to(dev)
    pools = [(torch.randn(num_blocks, block, h, d, device=dev),
              torch.randn(num_blocks, block, h, d, device=dev))
             for _ in range(layers)]
    return (q, pools, torch.from_numpy(tables_np).to(dev),
            torch.from_numpy(np.asarray(pos_np, np.int32)).to(dev))


def paged_phase(torch, rng, dev):
    """K3 at decode shapes: 8 slots, ragged pos 17..1000, block 16, the
    engine's default pool (8 * 64 blocks), sentinel tail entries; and a
    long context (max_len 4096, a slot at pos 4095 and one at pos 0); f32,
    bf16 and the two mixed dtype pairs (q and the pools); two calls
    bit-equal at each.  Times per layer in f32 and bf16, swept over 24
    layers' pools, at these positions and at the serve phase's own (each
    prompt plus 32 of its 64 new tokens).  Returns the f32 and the bf16
    row of the kernel table."""
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import paged_attention as pa
    h, d = 16, 64
    nb = MAX_LEN // BLOCK
    sms = _build.sm_count(dev.index)
    f32, bf16 = torch.float32, torch.bfloat16
    pos_np = np.array([17, 150, 300, 511, 512, 700, 901, 1000], np.int32)
    long_np = np.array([4095, 0, 2047, 3000, 17, 1023, 4000, 64], np.int32)
    q, pools, tables, pos = _paged_case(torch, rng, dev, pos_np, nb,
                                        layers=LAYERS)
    lq, lpools, ltables, lpos = _paged_case(torch, rng, dev, long_np,
                                            4096 // BLOCK)
    errs = {f32: 0.0, bf16: 0.0}
    ok = True
    for label, args in (("main", (q, *pools[0], tables, pos)),
                        ("max_len 4096", (lq, *lpools[0], ltables, lpos))):
        for qd, kvd in ((f32, f32), (bf16, bf16), (f32, bf16), (bf16, f32)):
            a = (args[0].to(qd), args[1].to(kvd), args[2].to(kvd),
                 *args[3:])
            got = pa.paged_attention(*a)
            again = pa.paged_attention(*a)
            want = pa._plain(*a)
            torch.cuda.synchronize()
            atol, rtol = (TOL, TOL) if qd == kvd == f32 else BF16_TOL
            e, o = max_err(torch, got, want, atol, rtol)
            o = o and got.dtype == qd
            rep = torch.equal(got, again)
            key = f32 if qd == kvd == f32 else bf16
            errs[key], ok = max(errs[key], e), ok and o and rep
            print(f"check paged_attention {label} q {str(qd)[6:]} pools "
                  f"{str(kvd)[6:]} S={a[0].shape[0]} H={h} D={d} "
                  f"block={BLOCK} "
                  f"{pa._plan(8, h, d, a[3].shape[1], sms, kvd.itemsize)} "
                  f"pos={a[4].tolist()}: max_abs_err={e:.3e}"
                  f"{'' if o else ' OUT OF TOLERANCE'}"
                  f"{'' if rep else ' NOT BIT-REPEATABLE'}")
    del lq, lpools, ltables, lpos
    if not ok:
        fail(f"paged_attention disagrees with its plain version or does "
             f"not repeat ({errs})")
    rows = []
    for dt in (f32, bf16):
        dq = q.to(dt)
        dpools = pools if dt == f32 else [(k.to(dt), v.to(dt))
                                          for k, v in pools]
        rows.append(_paged_time(torch, pa, sms, dq, dpools, tables, pos,
                                pos_np, nb, errs[dt]))
        del dpools
        torch.cuda.empty_cache()
    return rows


def _paged_time(torch, pa, sms, q, pools, tables, pos, pos_np, nb, err):
    """K3's row of the kernel table in q's and the pools' dtype (one
    dtype): ms per layer over 24 layers' pools, plain and SDPA times, the
    bound (the pools' element size sets the live K/V bytes)."""
    import ctypes
    from paddle_tpu_torch.ops import _build
    h, d = q.shape[1], q.shape[2]
    elem = pools[0][0].element_size()
    name = "paged_attention" + ("" if elem == 4 else "_bf16")
    dev = q.device
    plan = pa._plan(SLOTS, h, d, nb, sms, elem)
    fits = ctypes.c_int(0)
    _build.check(_build.function(
        "paged_attention", "pdt_paged_attention_max_clusters",
        [ctypes.c_int] * 5 + [ctypes.c_void_p])(
            h, d, plan.hpb, plan.splits, int(elem == 2), ctypes.byref(fits)),
        "paged_attention max clusters")
    print(f"{name} plan {plan}: grid {plan.grid(SLOTS, h)}, "
          f"{fits.value} clusters of {plan.splits} resident at once")

    def kern(p):
        return lambda: [pa.paged_attention(q, k, v, tables, p)
                        for k, v in pools]

    def bound(p_np):
        rows = int(np.minimum(p_np + 1, nb * BLOCK).sum())
        nbytes = (rows * h * d * elem * 2 + 2 * q.numel() * q.element_size()
                  + tables.numel() * 4 + p_np.size * 4)
        return bound_ms(nbytes, 4.0 * rows * h * d)
    ms = graph_ms(torch, kern(pos)) / LAYERS
    eager = call_ms(torch, kern(pos), 10) / LAYERS
    plain = graph_ms(torch, lambda: [pa._plain(q, k, v, tables, pos)
                                     for k, v in pools], 5) / LAYERS
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
    del views
    b, by = bound(pos_np)
    serve_np = np.array([n - 1 + 32 for n in PROMPT_LENS], np.int32)
    serve_pos = torch.from_numpy(serve_np).to(dev)
    serve_ms = graph_ms(torch, kern(serve_pos)) / LAYERS
    sb, _ = bound(serve_np)
    print(f"time {name} pos={pos_np.tolist()}: {ms:.4f} ms per layer "
          f"(plain {plain:.4f}, SDPA pre-gathered {lib:.4f}, bound {b:.4f}); "
          f"serve pos={serve_np.tolist()}: {serve_ms:.4f} ms per layer "
          f"(bound {sb:.4f})")
    return {"name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/paged_attention.cu",
            "replaces": "paddle_tpu/ops/paged_attention.py:109",
            "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": b,
            "bound_by": by, "library_ms": lib, "call_ms": eager}


def device_profile(torch, step, steps: int, what: str, card: str,
                   groups=None, top: int = 8, ranges=None):
    """Where a steady step's time goes: host wall per step (no profiler),
    then device busy time per step and the top kernels from torch.profiler
    over as many further steps; with ``groups`` ({label: substrings}), the
    device time per step of the kernels whose names hold one of a group's
    substrings (first group that matches); with ``ranges`` ({label:
    record_function name}), the kernels launched inside each named range
    are taken out of their groups into a group of their own (an eager step
    only: a graph replay launches its kernels from no range).  Prints
    them; returns (wall ms, busy ms or None, {label: ms}, kernels per
    step)."""
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

    def kernel(e):
        # a record_function range also shows as a device row spanning its
        # kernels: not a kernel of its own
        return (e.device_type == cuda and e.key not in (ranges or {}).values()
                and not getattr(e, "is_user_annotation", False))
    rows = []
    for e in prof.key_averages():
        if not kernel(e):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((us / 1e3 / steps, e.key))
    rows.sort(reverse=True)
    busy = sum(ms for ms, _ in rows)
    kernels = sum(e.count for e in prof.key_averages() if kernel(e)) / steps
    print(f"profile [{card}]: {what}: wall {step_ms:.3f} ms, device busy "
          + (f"{busy:.3f} ms, idle {1 - busy / step_ms:.1%}, "
             f"{kernels:.0f} kernels per step" if rows
             else "not measured (no device events)"))
    for ms, name in rows[:top]:
        print(f"profile:   {ms:8.3f} ms/step  {name[:90]}")

    def group(name):
        return next((g for g, keys in (groups or {}).items()
                     if any(k in name for k in keys)), "other")
    sums = {}
    for ms, name in rows:
        sums[group(name)] = sums.get(group(name), 0.0) + ms
    for label, range_name in (ranges or {}).items():
        inside = [k for e in prof.events() if e.name == range_name
                  for k in _kernels_under(e)]
        for name, us in inside:
            sums[group(name)] -= us / 1e3 / steps
        sums[label] = sum(us for _, us in inside) / 1e3 / steps
    if groups:
        print("profile: by group: " + ", ".join(
            f"{g} {ms:.3f} ms ({ms / busy:.1%})"
            for g, ms in sorted(sums.items(), key=lambda kv: -kv[1])))
    return step_ms, (busy if rows else None), sums, kernels


def _kernels_under(event):
    """(name, us) of every kernel launched inside a profiler CPU event."""
    out = [(k.name, k.duration) for k in event.kernels]
    for child in event.cpu_children:
        out += _kernels_under(child)
    return out


def decode_profile(torch, eng, steps: int, card: str, tag: str = "serve"):
    mode = "uncaptured" if eng._run_uncaptured else "captured"
    return device_profile(torch, eng.step, steps,
                          f"{tag} {mode} decode step (8 slots x "
                          f"{eng.decode_chunk} tokens, "
                          f"{eng.model.gpt.config.num_hidden_layers} layers)",
                          card)


def sampler_ms(torch, dev, seed: int, vocab: int):
    """Device ms of the keyed sampler for one token of 8 slots, all
    sampling (top-k 40, top-p 0.9, temperature 0.8), and of the
    all-greedy step on the same logits (CUDA graph replay)."""
    from paddle_tpu_torch.generation.keyed import greedy_step, sample_step
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    last = torch.randn(SLOTS, vocab, generator=gen, device=dev) * 3.0
    keys = torch.randint(0, 2 ** 32, (SLOTS, 2), generator=gen, device=dev)
    pos = torch.arange(100, 100 + SLOTS, dtype=torch.int32, device=dev)
    knobs = (torch.full((SLOTS,), 0.8, device=dev),
             torch.full((SLOTS,), 40, dtype=torch.int64, device=dev),
             torch.full((SLOTS,), 0.9, device=dev),
             torch.zeros(SLOTS, dtype=torch.bool, device=dev))
    with torch.inference_mode():
        mixed = graph_ms(torch, lambda: sample_step(last, keys, pos, *knobs))
        greedy = graph_ms(torch, lambda: greedy_step(last))
    return mixed, greedy


def replay_span_ms(torch, eng, steps: int) -> float:
    """Device ms per decode step of the captured engine by CUDA events
    around each replay of a decode graph: the graph's span on the card,
    the gaps between its kernels included (no profiler)."""
    spans = []
    progs = [eng._programs[n] for n in ("decode", "decode_greedy")]
    saved = [p.graph.replay for p in progs]

    def timed(replay):
        def run():
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            replay()
            b.record()
            spans.append((a, b))
        return run

    for p, replay in zip(progs, saved):
        p.graph.replay = timed(replay)
    try:
        for _ in range(steps):
            eng.step()
    finally:
        for p, replay in zip(progs, saved):
            p.graph.replay = replay
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in spans) / len(spans)


def decode_logits_check(torch, eng, model, dev):
    """One decode step's logits on the engine's current paged state, by
    the kernel path on the card and by the plain versions on the CPU (the
    host-planned writes of ``paged_decode_logits``, on copies of the
    pools).  Returns (max abs difference, the plain logits' largest
    |value|)."""
    from paddle_tpu_torch.serving.engine import paged_decode_logits
    eng._ensure_decode_blocks()      # back the next row, as a step would
    tables_np = eng._host_tables()
    active = np.zeros(SLOTS, bool)
    pos = np.zeros(SLOTS, np.int64)
    tokens = torch.zeros(SLOTS, dtype=torch.long)
    for slot, run in eng._slots.items():
        active[slot], pos[slot], tokens[slot] = True, run.pos, run.last_token
    geo = (eng.kv_pool.num_blocks, BLOCK, MAX_LEN)
    with torch.inference_mode():
        pools = [(k.clone(), v.clone()) for k, v in eng._pools]
        kern = paged_decode_logits(
            model, pools, tables_np, torch.from_numpy(tables_np).to(dev),
            active, pos, tokens.to(dev), *geo).cpu()
        del pools
        cpu_model = copy.deepcopy(model).cpu()
        cpu_pools = [(k.cpu(), v.cpu()) for k, v in eng._pools]
        plain = paged_decode_logits(
            cpu_model, cpu_pools, tables_np, torch.from_numpy(tables_np),
            active, pos, tokens, *geo)
    return float((kern - plain).abs().max()), float(plain.abs().max())


def serve_run(torch, eng, prompts, sampled, new_tokens, launch_names):
    """The requests through the engine (counters zeroed just before and
    read just after).  Returns the streams, wall seconds, TTFTs and the
    kernels' launches by name."""
    from paddle_tpu_torch.ops import int8_matmul as im
    from paddle_tpu_torch.ops import paged_attention as pa
    torch.cuda.synchronize()
    im.dequant_matmul.launches = 0
    pa.paged_attention.launches = 0
    t0 = time.perf_counter()
    resps = [eng.submit(p, max_new_tokens=new_tokens,
                        **({"decode_strategy": "sampling", **sampled[i]}
                           if i in sampled else {}))
             for i, p in enumerate(prompts)]
    eng.run_until_drained(timeout=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(zip(launch_names, (im.dequant_matmul.launches,
                                       pa.paged_attention.launches)))
    return ([r.tokens(timeout=5) for r in resps], wall,
            sorted(r.ttft for r in resps), launches)


def serve_model(torch, args, dev, dtype=None):
    """GPT-2 medium from --seed, int8 weight-only; with dtype bf16
    decorated to bf16 (amp O2) before quantization."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import GPTForPretraining, gpt2_medium_config
    from paddle_tpu_torch.quantization import quantize_for_serving
    cfg = gpt2_medium_config(hidden_dropout_prob=0.0,
                             attention_probs_dropout_prob=0.0)
    model = GPTForPretraining(cfg, device=dev, seed=args.seed).eval()
    if dtype == torch.bfloat16:
        amp.decorate(models=model, level="O2", dtype="bfloat16")
    return quantize_for_serving(model)


def serve_phase(torch, args, dev, card, model, dtype=None):
    """GPT-2 medium (``serve_model``), paged KV: the main path; with
    dtype bf16 the engine's pools are bf16.  The engine's programs run as
    CUDA graphs (captured by warmup); the same requests then run again
    through the same program functions uncaptured, for an A/B.  Returns
    the launches of K3 and K4 in the captured run, keyed by their
    kernel-table names."""
    from paddle_tpu_torch.generation import generate
    from paddle_tpu_torch.serving import ServingEngine

    bf16 = dtype == torch.bfloat16
    tag = "serve bf16" if bf16 else "serve"
    cfg = model.gpt.config
    eng = ServingEngine(model, max_slots=SLOTS, max_len=MAX_LEN,
                        kv="paged", block_size=BLOCK, dtype=dtype,
                        device=dev)
    pool_dt = eng._pools[0][0].dtype
    if pool_dt != (dtype or torch.float32):
        fail(f"{tag}: the engine built {pool_dt} pools")
    warm = eng.warmup()
    counts = warm["compile_counts"]
    if not warm["captured"] or counts["total"] != counts["bound"]:
        fail(f"{tag}: warmup captured {counts} (want the bound, "
             f"{counts['bound']} CUDA graphs)")
    print(f"{tag}: warmup {warm['seconds']:.2f}s, {counts['total']} CUDA "
          f"graphs captured (bound {counts['bound']}: prefill buckets "
          f"{sorted(counts['prefill'])}, decode x{counts['decode']}); pools "
          f"{pool_dt}, weights {next(model.parameters()).dtype} + int8")
    rng = np.random.RandomState(args.seed)
    prompts = [rng.randint(0, cfg.vocab_size, (n,)) for n in PROMPT_LENS]
    sampled = {3: dict(temperature=0.8, top_k=40, top_p=0.9, seed=11),
               6: dict(temperature=1.2, top_k=0, top_p=0.8, seed=12)}
    suffix = "_bf16" if bf16 else ""
    names = ("int8_matmul" + suffix, "paged_attention" + suffix)
    runs = {}
    for mode in ("captured", "uncaptured"):
        eng._run_uncaptured = mode == "uncaptured"
        outs, wall, ttfts, launches = serve_run(torch, eng, prompts,
                                                sampled, 64, names)
        if any(len(o) != 64 for o in outs):
            fail(f"{tag} {mode}: a request did not produce 64 tokens")
        if any(not (0 <= t < cfg.vocab_size) for o in outs for t in o):
            fail(f"{tag} {mode}: token out of the vocabulary")
        total = sum(len(o) for o in outs)
        runs[mode] = dict(outs=outs, tps=total / wall, ttfts=ttfts)
        print(f"{tag} {mode} [{card}]: 8 requests, {total} tokens in "
              f"{wall:.3f}s: {total / wall:.1f} tokens/s; TTFT p50 "
              f"{ttfts[len(ttfts) // 2] * 1e3:.1f} ms, max "
              f"{ttfts[-1] * 1e3:.1f} ms; launches {launches}")
        if mode == "captured":
            main_launches = launches
    eng._run_uncaptured = False
    for name, n in main_launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")
    cap, unc = runs["captured"]["outs"], runs["uncaptured"]["outs"]
    for i in range(len(prompts)):
        if i not in sampled and cap[i] != unc[i]:
            fail(f"{tag}: captured greedy stream {i} differs from the "
                 "uncaptured one")
    print(f"{tag}: greedy streams captured == uncaptured; sampled streams "
          f"equal: {[cap[i] == unc[i] for i in sorted(sampled)]}")
    if eng.post_warmup_compiles() != 0:
        fail(f"{tag}: {eng.post_warmup_compiles()} programs captured after "
             "warmup")

    # the decode step, all-greedy and mixed (the main run's two sampled
    # requests), profiled captured and uncaptured; on the greedy state
    # first one step's logits, kernel path vs plain path
    prof, spans = {}, {}
    for kind in ("greedy", "mixed"):
        knobs = sampled if kind == "mixed" else {}
        check = [eng.submit(p, max_new_tokens=96,
                            **({"decode_strategy": "sampling", **knobs[i]}
                               if i in knobs else {}))
                 for i, p in enumerate(prompts)]
        eng.step()                   # admits all eight + one decode chunk
        if kind == "greedy":
            err, top = decode_logits_check(torch, eng, model, dev)
        for mode in ("captured", "uncaptured"):
            eng._run_uncaptured = mode == "uncaptured"
            prof[kind, mode] = decode_profile(torch, eng, 3, card,
                                              f"{tag} {kind}")
        eng._run_uncaptured = False
        spans[kind] = replay_span_ms(torch, eng, 3)
        print(f"{tag} {kind} captured [{card}]: decode graph replay span "
              f"{spans[kind]:.3f} ms per step (CUDA events)")
        eng.run_until_drained(timeout=300)
        [r.tokens(timeout=5) for r in check]
    if eng.post_warmup_compiles() != 0:
        fail(f"{tag}: programs captured after warmup")
    tol = BF16_LOGIT_TOL * top if bf16 else LOGIT_TOL
    print(f"{tag}: decode-step logits kernel path vs plain path: max abs "
          f"err {err:.3e} (tolerance {tol:.3e}), |logits| max {top:.3f}")
    if not err <= tol:
        fail(f"{tag}: decode logits disagree: {err:.3e}")
    if not bf16:
        mixed_ms, greedy_ms = sampler_ms(torch, dev, args.seed,
                                         cfg.vocab_size)
        print(f"{tag} [{card}]: keyed sampler, one token of 8 slots x "
              f"{cfg.vocab_size}: {mixed_ms:.4f} ms (all-greedy step "
              f"{greedy_ms:.4f} ms), {eng.decode_chunk} tokens per decode "
              f"step: {eng.decode_chunk * (mixed_ms - greedy_ms):.3f} ms "
              "more per mixed step (CUDA graph replay)")
    agree = []
    for i, p in enumerate(prompts):
        if i in sampled:
            continue
        solo, _ = generate(model, p, max_new_tokens=64, device=dev)
        solo = solo[0].tolist()
        agree.append(sum(a == s for a, s in zip(cap[i], solo)))
    print(f"{tag}: greedy tokens equal to solo generate(): {agree} of 64 "
          "per request")
    for mode in ("captured", "uncaptured"):
        r = runs[mode]
        ttfts = r["ttfts"]
        steps = []
        for kind in ("greedy", "mixed"):
            wall_ms, busy_ms, _, kernels = prof[kind, mode]
            steps.append(
                f"{kind} step wall {wall_ms:.3f} ms, device "
                + (f"{busy_ms:.3f} ms, idle {1 - busy_ms / wall_ms:.1%}, "
                   f"{kernels:.0f} kernels" if busy_ms else "not measured")
                + (f", replay span {spans[kind]:.3f} ms"
                   if mode == "captured" else ""))
        print(f"{tag} {mode} summary [{card}]: {r['tps']:.1f} tokens/s, "
              f"TTFT p50 {ttfts[len(ttfts) // 2] * 1e3:.1f} ms, max "
              f"{ttfts[-1] * 1e3:.1f} ms; " + "; ".join(steps)
              + f"; warmup {warm['seconds']:.2f}s, captures "
              f"{counts['total']}, logits err {err:.3e}")
    eng.close()
    del eng
    torch.cuda.empty_cache()
    return main_launches


def _timed(torch, fn, out):
    """fn, with the ms of each call that did its work (did not return
    False) appended to ``out``; the card is synchronized around it."""
    def run(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(*args)
        torch.cuda.synchronize()
        if res is not False:
            out.append((time.perf_counter() - t0) * 1e3)
        return res
    return run


def _ms_line(label, ms):
    return (f"{label} {np.mean(ms):.3f} ms per run (max {max(ms):.3f}, "
            f"{len(ms)} runs)" if ms else f"{label}: none")


def _paged_engine(model, dev, **kw):
    from paddle_tpu_torch.serving import ServingEngine
    eng = ServingEngine(model, max_slots=SLOTS, max_len=MAX_LEN, kv="paged",
                        block_size=BLOCK, device=dev, **kw)
    warm = eng.warmup()
    counts = warm["compile_counts"]
    if not warm["captured"] or counts["total"] != counts["bound"]:
        fail(f"warmup captured {counts} (want {counts['bound']} graphs)")
    return eng


def _drive(torch, eng, prompts, sampled, new_tokens, tag):
    """serve_run with every request required to finish with its tokens
    and K3 / K4 required to launch (counted through the replays)."""
    names = ("int8_matmul", "paged_attention")
    try:
        outs, wall, ttfts, launches = serve_run(torch, eng, prompts, sampled,
                                                new_tokens, names)
    except Exception as e:  # noqa: BLE001 — a failed request fails the phase
        fail(f"{tag}: a request failed: {e!r}")
    if any(len(o) != new_tokens for o in outs):
        fail(f"{tag}: a request did not produce {new_tokens} tokens")
    for name, n in launches.items():
        if n <= 0:
            fail(f"{tag}: kernel {name} was not launched")
    if eng.post_warmup_compiles() != 0:
        fail(f"{tag}: {eng.post_warmup_compiles()} captures after warmup")
    return outs, wall, ttfts, launches


def pressure_phase(torch, args, dev, card, model):
    """The serve model's paged engine on 224 blocks where 512 back every
    slot: 16 requests of 200..400 prompt tokens and 256 new ones (every
    4th keyed-sampled).  Runs are parked and resumed as the pool runs
    short; every request must complete, with its stream equal token for
    token to the same requests on the full pool."""
    rng = np.random.RandomState(args.seed + 2)
    vocab = model.gpt.config.vocab_size
    prompts = [rng.randint(0, vocab, (n,)) for n in PRESSURE_LENS]
    sampled = {i: dict(temperature=0.8, top_k=40, top_p=0.9, seed=20 + i)
               for i in range(1, len(prompts), 4)}
    runs = {}
    for tag, extra in (("full pool", {}),
                       ("pressure", dict(num_blocks=PRESSURE_BLOCKS))):
        eng = _paged_engine(model, dev, **extra)
        pre_ms, res_ms = [], []
        eng.preempt_slot = _timed(torch, eng.preempt_slot, pre_ms)
        eng.restore_run = _timed(torch, eng.restore_run, res_ms)
        outs, wall, ttfts, launches = _drive(torch, eng, prompts, sampled,
                                             PRESSURE_NEW, f"pressure {tag}")
        kv = eng.metrics()["kv_pool"]
        total = sum(len(o) for o in outs)
        print(f"pressure {tag} [{card}]: {len(prompts)} requests, "
              f"{eng.kv_pool.num_blocks} blocks, {total} tokens in "
              f"{wall:.3f}s: {total / wall:.1f} tokens/s; TTFT p50 "
              f"{ttfts[len(ttfts) // 2] * 1e3:.1f} ms, max "
              f"{ttfts[-1] * 1e3:.1f} ms; preemptions {kv['oom_preempts']}, "
              f"resumes {kv['oom_resumes']}, failed {kv['oom_failed']}; "
              + _ms_line("preempt", pre_ms) + "; "
              + _ms_line("restore", res_ms) + f"; launches {launches}")
        if kv["oom_failed"] or kv["oom_paused"] or \
                kv["oom_resumes"] != kv["oom_preempts"]:
            fail(f"pressure {tag}: {kv}")
        runs[tag] = (outs, kv["oom_preempts"])
        eng.close()
        del eng
        torch.cuda.empty_cache()
    if runs["pressure"][1] < 1:
        fail("pressure: the short pool preempted no run")
    diff = [i for i, (a, b) in enumerate(zip(runs["pressure"][0],
                                             runs["full pool"][0])) if a != b]
    if diff:
        fail(f"pressure: streams {diff} differ from the full pool's")
    print(f"pressure: all {len(prompts)} streams (greedy and sampled) equal "
          "the full pool's token for token")


def _replay_ms(torch, prog, n: int = 10) -> float:
    """Device ms per replay of a captured program (CUDA events)."""
    prog.graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        prog.graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def _top2_margin(torch, model, dev, ids) -> float:
    """Top-two margin of the next-token logits of ``ids`` (a full
    forward, no cache)."""
    with torch.inference_mode():
        logits = model(torch.as_tensor(np.asarray(ids)[None]).to(dev))
    top = logits[0, -1].float().topk(2).values
    return float(top[0] - top[1])


def prefix_phase(torch, args, dev, card, model):
    """The serve model's paged engine with prefix_cache=True against one
    without: a request of the 384-token prefix plus 16 tokens fills the
    cache, then 16 greedy requests of the prefix plus 16..96 tokens and
    the bare prefix (copy-on-write), 64 new tokens each.  The cache must
    hit, copy once, capture nothing after warmup and leave the prefix's
    blocks bit for bit unchanged; a stream may split from the uncached
    engine's only at a near tie (the uncached path's top-two margin below
    2e-3 there).  Prints TTFT and the device ms of a warm prefill (bucket
    64 at cached_len 384) against a cold one (bucket 512)."""
    rng = np.random.RandomState(args.seed + 3)
    vocab = model.gpt.config.vocab_size
    prefix = rng.randint(0, vocab, (PREFIX_LEN,))
    first = np.concatenate([prefix, rng.randint(0, vocab,
                                                (PREFIX_SUFFIXES[0],))])
    prompts = [np.concatenate([prefix, rng.randint(0, vocab, (n,))])
               for n in PREFIX_SUFFIXES] + [prefix]
    runs = {}
    for cached in (False, True):
        tag = "prefix cached" if cached else "prefix uncached"
        eng = _paged_engine(model, dev, prefix_cache=cached)
        eng.submit(first, max_new_tokens=PREFIX_NEW)
        eng.run_until_drained(timeout=300)
        if cached:
            chain = eng.prefix_cache.match("default", prefix)
            if len(chain) != PREFIX_LEN // BLOCK:
                fail(f"{tag}: {len(chain)} prefix blocks cached")
            shared = [[t[b].clone() for pair in eng._pools for t in pair]
                      for b in chain]
            hits = eng.prefix_cache.hits
        outs, wall, ttfts, launches = _drive(torch, eng, prompts, {},
                                             PREFIX_NEW, tag)
        extra = ""
        if cached:
            stats = eng.prefix_cache.stats()
            if stats["hits"] <= hits or stats["cow_copies"] < 1:
                fail(f"{tag}: {stats}")
            for b, before in zip(chain, shared):
                after = [t[b] for pair in eng._pools for t in pair]
                if not all(torch.equal(x, y) for x, y in zip(before, after)):
                    fail(f"{tag}: shared block {b} was written")
            extra = (f"; {stats['hits']} block hits, {stats['misses']} "
                     f"misses, {stats['cow_copies']} copy-on-write, shared "
                     f"blocks unchanged")
            warm_table = eng.kv_pool.sentinel_table()
            warm_table[:len(chain)] = chain  # reads the prefix, writes drop
            timed = ((64, PREFIX_LEN, warm_table),
                     (512, 0, eng.kv_pool.sentinel_table()))
        else:
            timed = ((512, None, eng.kv_pool.sentinel_table()),)
        prefill = {}
        for bucket, cached_len, table in timed:
            prog = eng._programs[bucket]
            fill = dict(target=table, prompt_len=(cached_len or 0) + bucket)
            if cached_len is not None:
                fill["cached_len"] = cached_len
            with torch.inference_mode():
                eng._fill(prog.inputs, **fill)
                prefill[bucket] = _replay_ms(torch, prog)
        runs[cached] = outs
        print(f"{tag} [{card}]: {len(prompts)} requests, "
              f"{sum(len(o) for o in outs)} tokens in {wall:.3f}s; TTFT p50 "
              f"{ttfts[len(ttfts) // 2] * 1e3:.1f} ms, max "
              f"{ttfts[-1] * 1e3:.1f} ms; prefill device ms "
              + ", ".join(f"bucket {b}"
                          + (f" (cached_len {c})" if c else "")
                          + f" {prefill[b]:.3f}" for b, c, _ in timed)
              + f"{extra}; launches {launches}")
        eng.close()
        del eng
        torch.cuda.empty_cache()
    splits = []
    for i, (got, want) in enumerate(zip(runs[True], runs[False])):
        if got == want:
            continue
        j = next(k for k, (a, b) in enumerate(zip(got, want)) if a != b)
        margin = _top2_margin(torch, model, dev,
                              np.concatenate([prompts[i], want[:j]]))
        splits.append((i, j, margin))
        print(f"prefix: stream {i} splits from the uncached one at token "
              f"{j}: uncached top-two margin {margin:.3e}")
        if margin >= MARGIN_TOL:
            fail(f"prefix: stream {i} splits at token {j} where the margin "
                 f"is {margin:.3e} (>= {MARGIN_TOL})")
    print(f"prefix: {len(prompts) - len(splits)} of {len(prompts)} greedy "
          "streams equal the uncached engine's token for token; splits "
          f"only at near ties: {splits}")


def fixed_phase(torch, args, dev):
    """4-layer full-width engines on the fixed pool, captured: the f32
    engine's greedy streams equal solo generate(); the bf16 one's equal
    its uncaptured path's (solo generate() runs other shapes, whose bf16
    rounding may split a near tie)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.generation import generate
    from paddle_tpu_torch.models import GPTForPretraining, gpt2_medium_config
    from paddle_tpu_torch.serving import ServingEngine
    cfg = gpt2_medium_config(num_hidden_layers=4, hidden_dropout_prob=0.0,
                             attention_probs_dropout_prob=0.0)
    rng = np.random.RandomState(args.seed + 1)
    prompts = [rng.randint(0, cfg.vocab_size, (n,))
               for n in (5, 17, 40, 64, 90, 120)]
    for dtype in (None, torch.bfloat16):
        model = GPTForPretraining(cfg, device=dev, seed=args.seed + 1).eval()
        if dtype is not None:
            amp.decorate(models=model, level="O2", dtype="bfloat16")
        streams = []
        for uncaptured in (False, True):
            eng = ServingEngine(model, max_slots=SLOTS, max_len=256,
                                kv="fixed", dtype=dtype, device=dev)
            eng._run_uncaptured = uncaptured
            resps = [eng.submit(p, max_new_tokens=32) for p in prompts]
            eng.run_until_drained(timeout=300)
            counts = eng.compile_counts()
            if counts["total"] != counts["bound"] \
                    or eng.post_warmup_compiles() != 0:
                fail(f"fixed: captures {counts}, "
                     f"{eng.post_warmup_compiles()} after warmup")
            streams.append([r.tokens(timeout=5) for r in resps])
            eng.close()
        if streams[0] != streams[1]:
            fail("fixed-pool captured streams differ from the uncaptured")
        if dtype is None:
            for p, got in zip(prompts, streams[0]):
                solo, _ = generate(model, p, max_new_tokens=32, device=dev)
                if got != solo[0].tolist():
                    fail("fixed-pool greedy stream differs from solo "
                         "generate()")
        print(f"fixed {'bf16' if dtype else 'f32'}: {len(prompts)} greedy "
              f"streams captured == uncaptured"
              + ("" if dtype else " == solo generate()")
              + f"; {counts['total']} CUDA graphs")
        del model
        torch.cuda.empty_cache()


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


FLASH_TC_KERNELS = ("flash_fwd_tc_kernel", "flash_bwd_dq_tc_kernel",
                    "flash_bwd_dkdv_tc_kernel")


def _cuobjdump() -> str:
    """cuobjdump from PATH, the toolkit, or Triton's bundled copy."""
    import shutil
    from pathlib import Path
    found = shutil.which("cuobjdump")
    if found:
        return found
    cands = [Path("/usr/local/cuda/bin/cuobjdump")]
    try:
        import triton
        cands.append(Path(triton.__file__).parent / "backends" / "nvidia" /
                     "bin" / "cuobjdump")
    except ImportError:
        pass
    for c in cands:
        if c.exists():
            return str(c)
    fail("cuobjdump not found (toolkit or triton/backends/nvidia/bin)")


def _kernel_name(mangled: str) -> str:
    """A kernel's name and template arguments from its mangled symbol,
    e.g. flash_fwd_tc_kernel<64,64,1>: the last length-prefixed name of
    the (nested) symbol, then its integer and type arguments."""
    import re
    i = 2 if mangled.startswith("_Z") else 0
    i += mangled[i:i + 1] == "N"
    name = mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name, i = mangled[j:j + n], j + n
    rest = mangled[i:]
    if not rest.startswith("I"):
        return name
    dtype = {"If": ["f32"], "I13__nv_bfloat16": ["bf16"]}
    head = next((v for k, v in dtype.items() if rest.startswith(k)), [])
    args = head + re.findall(r"L[ib](\d+)E", rest)
    return f"{name}<{','.join(args)}>"


def flash_sass_check():
    """Tensor-core instructions (HMMA / HGMMA lines of the SASS) in every
    kernel of the built flash library; fails unless each of the bf16
    route's kernels (3 kinds x 3 head_dims) has some."""
    from paddle_tpu_torch.ops import _build
    lib = _build._target("flash_attention")
    sass = subprocess.run([_cuobjdump(), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = _kernel_name(line.split("Function :")[1].strip())
            counts[name] = 0
        elif name and ("HMMA" in line or "HGMMA" in line):
            counts[name] += 1
    for n in sorted(counts):
        print(f"sass {n}: {counts[n]} HMMA/HGMMA")
    tc = {n: c for n, c in counts.items() if n.split("<")[0] in
          FLASH_TC_KERNELS}
    if len(tc) != 3 * len(FLASH_TC_KERNELS) or not all(tc.values()):
        fail(f"a bf16 flash kernel has no tensor-core instruction: {tc}")
    return tc


def flash_phase(torch, rng, dev):
    """K1/K2 checked at the training shape in bf16 and f32 and at small
    variant shapes; timed at the training shape in bf16 per layer over 24
    layers' tensors."""
    from paddle_tpu_torch.ops import flash_attention as fa
    flash_sass_check()
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
    for name, bb, sq, sk, hh, dd, dt, causal, bias, seg, pp in (
            ("bias", 2, 256, 256, 2, 64, torch.float32, False, True, False,
             0.0),
            ("segments", 2, 256, 256, 2, 128, torch.float32, False, False,
             True, 0.0),
            ("sk!=sq", 2, 128, 384, 2, 64, torch.bfloat16, True, False,
             False, 0.1),
            ("bias+dropout d256", 1, 256, 256, 2, 256, torch.float32, True,
             True, False, 0.2),
            ("segments d128", 2, 256, 256, 2, 128, torch.bfloat16, False,
             False, True, 0.0),
            ("bias+dropout d256", 1, 256, 256, 2, 256, torch.bfloat16, True,
             True, False, 0.2)):
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
    # K2 repeats bit for bit, and one call allocates no dQ partials
    q, k, v, do = layers[0]
    o, lse = saved[0]
    first = fa.flash_bwd(q, k, v, None, None, None, seed, o, lse, do, True,
                         p)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    second = fa.flash_bwd(q, k, v, None, None, None, seed, o, lse, do, True,
                          p)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    same = all(torch.equal(x, y) for x, y in zip(first[:3], second[:3]))
    partials = (s // 64) * b * h * s * d * 4
    print(f"check flash K2 repeat (bf16 B={b} S={s} H={h} D={d} causal "
          f"p={p}): dq, dk, dv {'bit-equal' if same else 'DIFFER'}; peak "
          f"memory of one call {peak / 2 ** 20:.1f} MiB (the f32 dQ "
          f"partials alone would be {partials / 2 ** 20:.1f} MiB)")
    if not same:
        fail("two flash backward calls on the same inputs differ")
    if peak >= partials:
        fail(f"a bf16 flash backward call took {peak} bytes")
    del first, second

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


def train_leg(torch, make, batch, steps: int, counters, card: str,
              what: str, policy=None, uncaptured: bool = False, **prof):
    """One training run from a fresh model and TrainStep (``make()``, the
    same seed each time) under the recompute ``policy`` ((spec, policy) or
    None): ``warmup()`` (on the card the step's capture) timed, then
    ``steps`` steps on ``batch``, each timed to its end, with the launch
    counters zeroed just before the steps and read just after
    (``counters``: a callable that zeroes them and returns a reader); a
    steady step profiled (``device_profile``, keyword arguments ``prof``);
    the peak memory of one uncaptured step (the same program function
    without its graph; peak stats reset just before).  ``uncaptured``
    runs every step so (the A/B: programs, no graphs).  The model and the
    step are freed before it returns its numbers."""
    import gc
    from paddle_tpu_torch.jit import recompute_policy
    with recompute_policy(*policy) if policy else recompute_policy(None):
        model, step = make()
        step._run_uncaptured = uncaptured
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        warm = step.warmup(*batch)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        made = step.compile_counts()["total"]
        read = counters()
        losses, t_steps = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            losses.append(step(*batch))
            torch.cuda.synchronize()
            t_steps.append(time.perf_counter() - t0)
        out = dict(losses=[float(x) for x in losses], launches=read(),
                   warm=warm, warm_s=warm_s,
                   recaptured=step.compile_counts()["total"] - made,
                   first_ms=t_steps[0] * 1e3,
                   steady_ms=float(np.median(t_steps[2:] or t_steps)) * 1e3)
        out["profile"] = device_profile(torch, lambda: step(*batch), 2,
                                        what, card, **prof)
        step._run_uncaptured = True
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step(*batch)
        torch.cuda.synchronize()
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del model, step
    gc.collect()          # a step and its programs' bound methods: a cycle
    torch.cuda.empty_cache()
    return out


def _leg_line(tag: str, card: str, leg: dict, items: int, unit: str):
    wall, busy, _, kernels = leg["profile"]
    return (f"{tag} [{card}]: warmup {leg['warm_s']:.2f} s "
            f"(compiled {leg['warm']['compiled']}), first step "
            f"{leg['first_ms']:.1f} ms, steady step {leg['steady_ms']:.2f} ms "
            f"({items / leg['steady_ms'] * 1e3:.0f} {unit}/s); profiled: "
            f"wall {wall:.3f} ms, device "
            + (f"{busy:.3f} ms, idle {1 - busy / wall:.1%}"
               if busy else "not measured")
            + f", {kernels:.0f} kernels per step; peak memory of an "
            f"uncaptured step {leg['peak_gib']:.2f} GiB; captures after "
            f"warmup {leg['recaptured']}; launches {leg['launches']}")


def _check_recompute_losses(tag: str, got, want):
    """A recompute leg's losses against the plain leg's first steps: within
    1e-5 relative (bit-equality is the expectation); both printed."""
    want = want[:len(got)]
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    print(f"{tag}: losses {', '.join(repr(x) for x in got)} vs without "
          f"recompute {', '.join(repr(x) for x in want)}: "
          + ("bit-equal" if got == want else f"largest relative {rel:.2e}"))
    if not rel <= 1e-5:
        fail(f"{tag}: losses {got} differ from the plain run's {want}")


def train_phase(torch, args, dev, card):
    """GPT-2 medium, O1 bf16, AdamW(1e-4), dropout 0.1: the training leg of
    the main path, through the step's CUDA graph; then the same steps
    uncaptured (the A/B: losses bit-equal) and under
    recompute_policy("stages") with each policy (RECOMPUTE_STEPS steps:
    losses within 1e-5 relative of the plain run's, K1 twice per layer,
    peak memory below the plain run's)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (GPTForPretraining,
                                         GPTPretrainingCriterion,
                                         gpt2_medium_config)
    from paddle_tpu_torch.ops import flash_attention as fa
    cfg = gpt2_medium_config()
    crit = GPTPretrainingCriterion()
    layers = cfg.num_hidden_layers

    def make():
        pt.seed(args.seed)
        model = GPTForPretraining(cfg, device=dev, seed=args.seed)
        opt = pt.optimizer.AdamW(learning_rate=1e-4,
                                 parameters=model.parameters())
        return model, TrainStep(model, lambda logits, y: crit(logits, y),
                                opt, amp_level="O1", amp_dtype="bfloat16")

    def counters():
        fa.flash_fwd.launches = fa.flash_bwd.launches = 0
        return lambda: {"flash_attention_fwd": fa.flash_fwd.launches,
                        "flash_attention_bwd": fa.flash_bwd.launches}
    batch = tuple(torch.from_numpy(a).to(dev)
                  for a in _train_batch(cfg, args.seed, TRAIN_B, TRAIN_S))
    what = f"train step (GPT-2 medium, B {TRAIN_B} x S {TRAIN_S}, O1 bf16"
    tokens = TRAIN_B * TRAIN_S
    cap = train_leg(torch, make, batch, TRAIN_STEPS, counters, card,
                    what + ", captured)")
    vals = cap["losses"]
    print("train: losses " + ", ".join(f"{x:.4f}" for x in vals))
    print("train: losses in full (f32 values, to compare runs bit for bit) "
          + ", ".join(repr(x) for x in vals))
    if not all(np.isfinite(vals)):
        fail(f"non-finite training loss: {vals}")
    if not vals[-1] < vals[0]:
        fail(f"training loss did not fall: {vals[0]} -> {vals[-1]}")
    want = layers * TRAIN_STEPS
    if any(n != want for n in cap["launches"].values()):
        fail(f"flash launches {cap['launches']}, expected {want} each "
             f"({layers} layers x {TRAIN_STEPS} steps, through replays)")
    if not cap["warm"]["compiled"] or cap["recaptured"]:
        fail(f"train: warmup {cap['warm']}, {cap['recaptured']} captures "
             "after it (expected one capture, by warmup)")
    print(_leg_line("train captured", card, cap, tokens, "tokens"))
    unc = train_leg(torch, make, batch, TRAIN_STEPS, counters, card,
                    what + ", uncaptured)", uncaptured=True)
    print(_leg_line("train uncaptured", card, unc, tokens, "tokens"))
    if unc["losses"] != vals:
        fail(f"train: captured losses {vals} differ from the uncaptured "
             f"step's {unc['losses']}")
    print("train: captured and uncaptured losses bit-equal over "
          f"{TRAIN_STEPS} steps")
    for pol in ("dots_saveable", "nothing_saveable"):
        tag = f"train stages/{pol}"
        leg = train_leg(torch, make, batch, RECOMPUTE_STEPS, counters, card,
                        what + f", captured, recompute stages/{pol})",
                        policy=("stages", pol))
        print(_leg_line(tag, card, leg, tokens, "tokens"))
        _check_recompute_losses(tag, leg["losses"], vals)
        stated = {"flash_attention_fwd": 2 * layers * RECOMPUTE_STEPS,
                  "flash_attention_bwd": layers * RECOMPUTE_STEPS}
        if leg["launches"] != stated:
            fail(f"{tag}: flash launches {leg['launches']}, stated {stated}"
                 " (each block's region reruns K1 in the backward)")
        if not leg["peak_gib"] < cap["peak_gib"]:
            fail(f"{tag}: peak memory {leg['peak_gib']:.2f} GiB is not "
                 f"below the plain step's {cap['peak_gib']:.2f} GiB")
        print(f"{tag} [{card}]: device time {leg['profile'][1] or 0:.3f} "
              f"ms vs {cap['profile'][1] or 0:.3f} ms without recompute; "
              f"peak memory "
              f"{leg['peak_gib']:.2f} vs {cap['peak_gib']:.2f} GiB "
              f"({leg['peak_gib'] / cap['peak_gib']:.1%})")
    return cap["launches"]


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


def bn_err(torch, got, want):
    """(max abs err, ok) of a fused-BN kernel against its plain version:
    f32 within 1e-5 of the tensor's largest |value| (the column sums add
    in another order; the elementwise kernels round like the plain
    version); bf16 within one bf16 unit, 1e-2 + 1e-2 * |plain|."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    if want.dtype == torch.bfloat16:
        ok = bool((err <= 1e-2 + 1e-2 * w.abs()).all())
    else:
        ok = float(err.max()) <= 1e-5 * max(float(w.abs().max()), 1e-30)
    return float(err.max()), ok


def _bn_rows(torch, gen, dev, m, c, dtype, shift=0.5):
    return (torch.randn(m, c, generator=gen, device=dev) * 1.5
            + shift).to(dtype)


def _bn_coef(torch, gen, dev, c):
    """An (8, C) coef: a, b, mean, invstd and the dx rows A, B, Cc."""
    rows = [torch.rand(c, generator=gen, device=dev) + 0.5,
            torch.randn(c, generator=gen, device=dev),
            0.3 * torch.randn(c, generator=gen, device=dev),
            torch.rand(c, generator=gen, device=dev) + 0.5]
    rows += [torch.randn(c, generator=gen, device=dev) for _ in range(3)]
    rows.append(torch.zeros(c, device=dev))
    return torch.stack(rows).contiguous()


def bn_kernel_check(torch, fbn, gen, dev, m, c, dtype, act, res, errs):
    """K5-K8 at one (M, C, dtype, act, residual form) against their plain
    versions; the largest error per kernel goes into errs."""
    x = _bn_rows(torch, gen, dev, m, c, dtype)
    g = _bn_rows(torch, gen, dev, m, c, dtype, shift=0.0)
    r = None if res == "none" else _bn_rows(torch, gen, dev, m, c, dtype)
    coef = _bn_coef(torch, gen, dev, c)
    coefr = _bn_coef(torch, gen, dev, c) if res == "dual" else None
    pairs = {"bn_stats": (fbn.bn_stats(x), fbn._plain_stats(x)),
             "bn_apply": ((fbn.bn_apply(x, coef, r, act, coefr),),
                          (fbn._plain_apply(x, coef, r, act, coefr),)),
             "bn_bwd_reduce": (fbn.bn_bwd_reduce(g, x, coef, r, act, coefr),
                               fbn._plain_bwd_reduce(g, x, coef, r, act,
                                                     coefr)),
             "bn_bwd_dx": (fbn.bn_bwd_dx(g, x, coef, r, act, coefr),
                           fbn._plain_bwd_dx(g, x, coef, r, act, coefr))}
    torch.cuda.synchronize()
    bad = []
    for name, (got, want) in pairs.items():
        for a, b in zip(got, want):
            if b is None:
                continue
            e, ok = bn_err(torch, a, b)
            errs[name] = max(errs.get(name, 0.0), e)
            if not ok:
                bad.append(f"{name} {e:.3e}")
    if bad:
        fail(f"fused-BN kernels disagree with their plain versions at M={m} "
             f"C={c} {dtype} act={act} residual={res}: {bad}")


def bn_pool_check(torch, fbn, gen, dev, shape, dtype, act, pool, errs,
                  route=None):
    """K9 against its plain version: max bit-equal, avg within bn_err's
    bound and, in bf16, within one bf16 unit of the larger value (2**-7
    of it) plus 1e-5 of the largest |value| (both sum in f32 and round
    once); two calls bit-equal.  By the wrapper's own route choice, or
    ``route`` "window" to hold the window route at a shape the ring takes.
    Returns the route taken."""
    n, h, w, c = shape
    x = _bn_rows(torch, gen, dev, n * h * w, c, dtype).view(n, h, w, c)
    coef = _bn_coef(torch, gen, dev, c)
    before = dict(fbn.bn_pool_apply.routes)
    call = fbn._pool_window if route == "window" else fbn.bn_pool_apply
    got = call(x, coef, act, *pool)
    again = call(x, coef, act, *pool)
    want = fbn._plain_pool_apply(x, coef, act, *pool)
    torch.cuda.synchronize()
    taken = next(r for r, v in fbn.bn_pool_apply.routes.items()
                 if v != before[r])
    e, ok = bn_err(torch, got, want)
    if pool[0] == "avg" and dtype == torch.bfloat16:
        g, w = got.float(), want.float()
        ok = ok and bool(((g - w).abs() <= 2.0 ** -7 * torch.maximum(
            g.abs(), w.abs()) + 1e-5 * float(w.abs().max())).all())
    exact = pool[0] != "max" or torch.equal(got, want)
    rep = torch.equal(got, again)
    key = "bn_pool_apply" if taken == "ring" else "bn_pool_apply (window)"
    errs[key] = max(errs.get(key, 0.0), e)
    if not (ok and exact and rep) or got.shape != want.shape:
        fail(f"bn_pool_apply ({taken} route) disagrees with its plain "
             f"version at {shape} {dtype} act={act} pool={pool}: {e:.3e}"
             f"{'' if exact else ', max not bit-equal'}"
             f"{'' if rep else ', not bit-repeatable'}")
    return taken


def bn_function_check(torch, fbn, gen, dev, form, shape, dtype):
    """One autograd Function (both directions on the kernels) against
    autograd of its plain reference: outputs, f32 statistics and the
    gradients of x, gamma, beta (and the residual's), for a logical NCHW
    input in channels-last memory.  Returns the largest error."""
    n, h, w, c = shape

    def act_t():
        return (torch.randn(n, c, h, w, generator=gen, device=dev) + 0.3).to(
            dtype).contiguous(memory_format=torch.channels_last)

    def scale():
        return torch.rand(c, generator=gen, device=dev) + 0.5

    def shift():
        return torch.randn(c, generator=gen, device=dev)
    x, r = act_t(), act_t()
    gamma, beta, gr, br = scale(), shift(), scale(), shift()
    pool = ("max", 3, 2, 1)
    eps = 1e-5
    if form == "single":
        ins = [x, gamma, beta, r]
        kern = lambda x, g, b, r: fbn.bn_act_train(x, g, b, eps, "relu", r,
                                                   False)
        plain = lambda x, g, b, r: fbn.bn_act_reference(x, g, b, eps, "relu",
                                                        r, 1)
    elif form == "dual":
        ins = [x, gamma, beta, r, gr, br]
        kern = lambda *a: fbn.bn2_act_train(*a, eps, "relu", False)
        plain = lambda *a: fbn.bn2_act_reference(*a, eps, "relu", 1)
    else:
        ins = [x, gamma, beta]
        kern = lambda x, g, b: fbn.bn_act_pool_train(x, g, b, eps, "relu",
                                                     pool, False)
        plain = lambda x, g, b: fbn.bn_act_pool_reference(x, g, b, eps,
                                                          "relu", pool, 1)
    with torch.no_grad():
        shapes = [t.shape for t in plain(*ins)]
    cts = [(torch.randn(shapes[0], generator=gen, device=dev)).to(
        dtype).contiguous(memory_format=torch.channels_last)]
    cts += [0.1 * torch.randn(s, generator=gen, device=dev)
            for s in shapes[1:]]

    def run(fn):
        leaves = [t.detach().clone().requires_grad_() for t in ins]
        outs = fn(*leaves)
        grads = torch.autograd.grad(outs, leaves, cts)
        return [o.detach() for o in outs] + list(grads)
    got, want = run(kern), run(plain)
    torch.cuda.synchronize()
    worst = 0.0
    for a, b in zip(got, want):
        a, b = a.float(), b.float()
        err = (a - b).abs()
        scale = float(b.abs().max())
        bad = (err > 2e-2 * scale + 2e-2 * b.abs()) if dtype == \
            torch.bfloat16 else (err > 1e-4 * scale)
        worst = max(worst, float(err.max()))
        if int(bad.sum()) > a.numel() // 1_000_000:
            fail(f"{form} fused-BN Function disagrees with autograd of its "
                 f"plain reference at {shape} {dtype}: {int(bad.sum())} "
                 f"elements off, max err {float(err.max()):.3e} of "
                 f"{scale:.3e}")
    print(f"check bn Function {form} {str(dtype)[6:]} NHWC={shape}: max "
          f"abs err {worst:.3e} over outputs and gradients")
    return worst


def bn_bytes_ops(name, m, c, elem, res, mo=None, window=9):
    """(bytes, f32 operations) of one kernel call: each input read once,
    each output written once; the operations this call's arithmetic
    does per element."""
    n = m * c
    coef = 8 * c * 4
    rows = 1 if res == "none" else 2
    if name == "bn_stats":
        return n * elem + 2 * c * 4, 3 * n
    if name == "bn_apply":
        return (rows + 1) * n * elem + coef * (2 if res == "dual" else 1), \
            (4 + 2 * (rows - 1)) * n
    if name == "bn_bwd_reduce":
        return (rows + 1) * n * elem + coef + 3 * c * 4, 10 * n
    if name == "bn_bwd_dx":   # g, x (, r) in; dx (, dres) out
        return (rows + 2 + (res != "none")) * n * elem + coef, 10 * n
    # bn_pool_apply: x in, the pooled output out
    return n * elem + mo * c * elem + coef, 4 * window * mo * c


def library_ms(torch, fn, what):
    """graph_ms of a PyTorch yardstick call, or None (printed) where this
    build of PyTorch refuses the call: a yardstick is measured, never
    relied on."""
    try:
        return graph_ms(torch, fn)
    except RuntimeError as e:
        print(f"time: yardstick {what} not measured: {str(e)[:160]}")
        torch.cuda.synchronize()
        return None


def bn_time(torch, fbn, gen, dev, shape, res):
    """Per kernel at one main-path site (bf16, relu): graph ms, eager call
    ms, plain ms, PyTorch's own BatchNorm kernel for the same function
    (the SyncBatchNorm building blocks; None where there is none), bound
    ms and what bounds it.  Also prints the pair yardsticks
    (batch_norm + relu_, native_batch_norm_backward) and var_mean."""
    n, h, w, c = shape
    m = n * h * w
    dt = torch.bfloat16
    x = _bn_rows(torch, gen, dev, m, c, dt)
    g = _bn_rows(torch, gen, dev, m, c, dt, shift=0.0)
    r = _bn_rows(torch, gen, dev, m, c, dt) if res != "none" else None
    coef = _bn_coef(torch, gen, dev, c)
    x4, g4 = (t.view(n, h, w, c).permute(0, 3, 1, 2) for t in (x, g))
    r4 = r.view(n, h, w, c).permute(0, 3, 1, 2) if r is not None else None
    wgt, bia = coef[0].to(dt), coef[1].to(dt)
    eps = 1e-5
    # inputs of PyTorch's own BatchNorm kernels (the SyncBatchNorm
    # building blocks), each the same function as one of K5-K8 without
    # the activation and the residual
    mean, invstd = torch.batch_norm_stats(x4, eps)
    sums = torch.batch_norm_backward_reduce(g4, x4, mean, invstd, wgt,
                                            True, False, False)
    count = torch.full((1,), m, dtype=torch.int32, device=dev)
    calls = {
        "bn_stats": (lambda: fbn.bn_stats(x), lambda: fbn._plain_stats(x),
                     lambda: torch.batch_norm_stats(x4, eps)),
        "bn_apply": (lambda: fbn.bn_apply(x, coef, r, "relu"),
                     lambda: fbn._plain_apply(x, coef, r, "relu"),
                     lambda: torch.batch_norm_elemt(x4, wgt, bia, mean,
                                                    invstd, eps)),
        "bn_bwd_reduce": (
            lambda: fbn.bn_bwd_reduce(g, x, coef, r, "relu"),
            lambda: fbn._plain_bwd_reduce(g, x, coef, r, "relu"),
            lambda: torch.batch_norm_backward_reduce(
                g4, x4, mean, invstd, wgt, True, True, True)),
        "bn_bwd_dx": (
            lambda: fbn.bn_bwd_dx(g, x, coef, r, "relu"),
            lambda: fbn._plain_bwd_dx(g, x, coef, r, "relu"),
            lambda: torch.batch_norm_backward_elemt(
                g4, x4, mean, invstd, wgt, sums[0], sums[1], count))}
    out = {}
    for name, (kern, plain, lib) in calls.items():
        b, by = bound_ms(*bn_bytes_ops(name, m, c, 2, res))
        out[name] = dict(ms=graph_ms(torch, kern),
                         call_ms=call_ms(torch, kern, 10),
                         plain_ms=graph_ms(torch, plain, 5),
                         library_ms=library_ms(torch, lib, name), bound_ms=b,
                         bound_by=by)
    if res == "none":    # the stem: the pooled epilogue
        from paddle_tpu_torch.ops import _build
        sms = _build.sm_count(dev.index), _build.smem_limits(dev.index)
        x4n = x.view(n, h, w, c)
        pool = ("max", (3, 3), (2, 2), (1, 1))
        ho, wo = (h + 2 - 3) // 2 + 1, (w + 2 - 3) // 2 + 1
        b, by = bound_ms(*bn_bytes_ops("bn_pool_apply", m, c, 2, res,
                                       mo=n * ho * wo))
        kern = lambda: fbn.bn_pool_apply(x4n, coef, "relu", *pool)
        old = lambda: fbn._pool_window(x4n, coef, "relu", *pool)
        # the ring route (kern) and the window route it replaced (old),
        # in turns
        times = [graph_ms(torch, f) for f in (kern, old, old, kern)]
        out["bn_pool_apply"] = dict(
            ms=times[0], call_ms=call_ms(torch, kern, 10),
            plain_ms=graph_ms(torch, lambda: fbn._plain_pool_apply(
                x4n, coef, "relu", *pool), 5),
            library_ms=None, bound_ms=b, bound_by=by)
        print(f"time bn_pool_apply at the stem {shape} bf16 relu max 3x3/2: "
              f"ring route {times[0]:.4f} / {times[3]:.4f} ms, window route "
              f"(the kernel it replaced) {times[1]:.4f} / {times[2]:.4f} ms, "
              f"bound {b:.4f} ms ({by}); plan " + str(fbn._pool_plan(
                  n, h, w, c, 2, "max", (3, 3), (2, 2), (1, 1), *sms)))

    def fwd_pair():
        y = torch.nn.functional.batch_norm(x4, None, None, wgt, bia, True,
                                           0.1, eps)
        if r4 is not None:
            y.add_(r4)
        return y.relu_()
    save = torch.native_batch_norm(x4, wgt, bia, None, None, True, 0.1, eps)
    bwd_pair = lambda: torch.ops.aten.native_batch_norm_backward(
        g4, x4, wgt, None, None, save[1], save[2], True, eps,
        [True, True, True])
    pair = [library_ms(torch, f, w) for f, w in (
        (fwd_pair, "batch_norm"), (bwd_pair, "native_batch_norm_backward"),
        (lambda: torch.var_mean(x, 0, correction=0), "var_mean"))]
    pair = [float("nan") if p is None else p for p in pair]
    print(f"time bn at NHWC={shape} bf16 relu residual={res}: " + "; ".join(
        f"{k} {v['ms']:.4f} ms (call {v['call_ms']:.4f}, plain "
        f"{v['plain_ms']:.4f}, torch "
        + (f"{v['library_ms']:.4f}" if v['library_ms'] is not None else "-")
        + f", bound {v['bound_ms']:.4f} {v['bound_by']})"
        for k, v in out.items()))
    print(f"time bn pair yardsticks at NHWC={shape}: batch_norm(training)"
          f"{' + add_' if r4 is not None else ''} + relu_ {pair[0]:.4f} ms "
          f"(K5+K6 {out['bn_stats']['ms'] + out['bn_apply']['ms']:.4f}); "
          f"native_batch_norm_backward {pair[1]:.4f} ms (K7+K8 "
          f"{out['bn_bwd_reduce']['ms'] + out['bn_bwd_dx']['ms']:.4f}); "
          f"var_mean {pair[2]:.4f} ms (K5 {out['bn_stats']['ms']:.4f})")
    del x, g, r, x4, g4, r4, save
    torch.cuda.empty_cache()
    return out


def bn_phase(torch, args, dev):
    """K5-K9 checked at the main path's shapes and at small odd ones, the
    Functions against autograd of the plain references, then timed."""
    from paddle_tpu_torch.ops import fused_bn_act as fbn
    gen = torch.Generator(device=dev).manual_seed(args.seed + 3)
    errs = {}
    f32, bf16 = torch.float32, torch.bfloat16
    acts = (None, "relu", "relu6")
    forms = ("none", "plain", "dual")
    main_cases = [
        (BN_STEM, "relu", "none"), (BN_LAYER1, "relu", "plain"),
        (BN_LAYER4, "relu", "dual"), (BN_LAYER4, "relu", "none")]
    for (n, h, w, c), act, res in main_cases:
        for dtype in (bf16, f32):
            bn_kernel_check(torch, fbn, gen, dev, n * h * w, c, dtype, act,
                            res, errs)
            torch.cuda.empty_cache()
    small = [(1037, 24), (515, 40), (333, 7)]
    for m, c in small:
        for dtype in (bf16, f32):
            for act in acts:
                for res in forms:
                    bn_kernel_check(torch, fbn, gen, dev, m, c, dtype, act,
                                    res, errs)
    pools = [("max", (3, 3), (2, 2), (1, 1)), ("avg", (3, 3), (2, 2), (1, 1)),
             ("max", (2, 3), (2, 1), (0, 1))]
    routes = {}
    for dtype in (bf16, f32):
        for route in (None, "window"):   # the stem: the ring, and the old
            routes[("stem", str(dtype), route)] = bn_pool_check(
                torch, fbn, gen, dev, BN_STEM, dtype, "relu", pools[0], errs,
                route)
            torch.cuda.empty_cache()
        for shape in ((3, 9, 11, 24), (2, 12, 12, 40), (1, 7, 5, 3),
                      (2, 6, 480 // dtype.itemsize * 2, 64)):
            for act in acts:
                for pool in pools:
                    routes[(shape, str(dtype), act, pool)] = bn_pool_check(
                        torch, fbn, gen, dev, shape, dtype, act, pool, errs)
        # rings of 18 and 28 slots: a barrier per slot past the first 16
        for shape, pool in (
                ((2, 10, 10, 32), ("max", (9, 9), (1, 1), (0, 0))),
                ((2, 14, 14, 64), ("avg", (14, 14), (1, 1), (0, 0)))):
            routes[(shape, str(dtype), "relu", pool)] = bn_pool_check(
                torch, fbn, gen, dev, shape, dtype, "relu", pool, errs)
    taken = {r: sum(v == r for v in routes.values()) for r in
             ("ring", "window")}
    print(f"check bn_pool_apply routes: {taken} of {len(routes)} checks; "
          "the stem by the wrapper's choice: "
          + ", ".join(f"{k[1][6:]} {v}" for k, v in routes.items()
                      if k[0] == "stem" and k[2] is None))
    if routes[("stem", str(bf16), None)] != "ring":
        fail("the bf16 stem did not take K9's ring route")
    print("check bn kernels vs plain (main-path shapes and small odd ones, "
          "f32 and bf16, every activation and residual form): max abs err "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    fn_err = 0.0
    for form, shape in (("single", BN_LAYER1), ("dual", BN_LAYER4),
                        ("pool", BN_STEM)):
        fn_err = max(fn_err, bn_function_check(torch, fbn, gen, dev, form,
                                               shape, bf16))
        torch.cuda.empty_cache()
        fn_err = max(fn_err, bn_function_check(
            torch, fbn, gen, dev, form, (3, 7, 9, 24), f32))
    times = {"layer1": bn_time(torch, fbn, gen, dev, BN_LAYER1, "plain"),
             "stem": bn_time(torch, fbn, gen, dev, BN_STEM, "none")}
    rows = []
    for name in BN_KERNELS:
        t = times["stem" if name == "bn_pool_apply" else "layer1"][name]
        rows.append({"name": name, "route": "cuda",
                     "source": "paddle_tpu_torch/csrc/fused_bn_act.cu",
                     "replaces": f"paddle_tpu/ops/fused_bn_act.py:"
                                 f"{BN_LINES[name]}",
                     "max_abs_err": errs[name], **t})
    return rows


def bn_sites(model):
    """(single, dual, pooled) fused-BN call sites of one ResNet forward,
    read from the model's blocks the way ``vision.models.resnet`` routes
    them: bn1 (and bn2 of a bottleneck) are single sites; the last BN of a
    block is dual when its downsample splits into (conv, BatchNorm), else
    single; the stem is pooled when its max pool is fusable."""
    from paddle_tpu_torch.ops.fused_bn_act import fusable_pool_spec
    from paddle_tpu_torch.vision.models.resnet import (BottleneckBlock,
                                                       _split_downsample)
    pooled = int(fusable_pool_spec(model.maxpool, model.data_format)
                 is not None)
    single, dual = 1 - pooled, 0
    for layer in (model.layer1, model.layer2, model.layer3, model.layer4):
        for blk in layer:
            single += 2 if isinstance(blk, BottleneckBlock) else 1
            if _split_downsample(blk.downsample) is not None:
                dual += 1
            else:
                single += 1
    return single, dual, pooled


def bn_launches_per_step(model, recompute: bool = False):
    """Expected K5-K9 launches of one training step (forward + backward):
    K5 once per single site, twice per dual and once at the pooled stem;
    K6, K7 and K8 once per single or dual site; K9 once per pooled site
    (its backward is plain tensor code).  With ``recompute`` (every block a
    region), each block's forward runs again in the backward: K5 and K6
    once more at every block site (the stem is in no block)."""
    single, dual, pooled = bn_sites(model)
    out = {"bn_stats": single + 2 * dual + pooled,
           "bn_apply": single + dual, "bn_bwd_reduce": single + dual,
           "bn_bwd_dx": single + dual, "bn_pool_apply": pooled}
    if recompute:
        blocks = single - (1 - pooled)
        out["bn_stats"] += blocks + 2 * dual
        out["bn_apply"] += blocks + dual
    return out


def bn_site_list(model, batch: int, hw: int):
    """Every fused-BN site of one ResNet step as (label, M, C, form):
    the pooled stem ("pool"), then each block's BatchNorms in order, the
    last one "plain" (a residual) or "dual" (a BatchNorm on the
    downsample too), the others "none".  Shapes from the blocks'
    convolution strides and BatchNorm widths."""
    from paddle_tpu_torch.ops.fused_bn_act import _pool_out
    from paddle_tpu_torch.vision.models.resnet import (BottleneckBlock,
                                                       _split_downsample)

    def stride(conv):
        st = conv.stride
        return st[0] if isinstance(st, (tuple, list)) else int(st)
    h = hw // stride(model.conv1)
    sites = [("stem", batch * h * h, model.bn1.num_features, "pool")]
    h, _ = _pool_out(h, h, (3, 3), (2, 2), (1, 1))
    for li, layer in enumerate((model.layer1, model.layer2, model.layer3,
                                model.layer4)):
        for bi, blk in enumerate(layer):
            tag = f"layer{li + 1}.{bi}"
            last = blk.bn3 if isinstance(blk, BottleneckBlock) else blk.bn2
            res = ("dual" if _split_downsample(blk.downsample) is not None
                   else "plain")
            if isinstance(blk, BottleneckBlock):
                sites.append((f"{tag}.bn1", batch * h * h,
                              blk.bn1.num_features, "none"))
                h //= stride(blk.conv2)
                sites.append((f"{tag}.bn2", batch * h * h,
                              blk.bn2.num_features, "none"))
            else:
                h //= stride(blk.conv1)
                sites.append((f"{tag}.bn1", batch * h * h,
                              blk.bn1.num_features, "none"))
            sites.append((f"{tag}.{'bn3' if isinstance(blk, BottleneckBlock) else 'bn2'}",
                          batch * h * h, last.num_features, res))
    return sites


def bn_step_bounds(model, batch: int, hw: int):
    """Per-step bound (ms, bytes at 3.35 TB/s) of each of K5-K9 over this
    ResNet's BatchNorm sites for a batch of batch x hw x hw: each input
    read once, each output written once (bf16)."""
    from paddle_tpu_torch.ops.fused_bn_act import _pool_out
    total = dict.fromkeys(BN_KERNELS, 0.0)
    for _, m, c, form in bn_site_list(model, batch, hw):
        if form == "pool":
            h = int(round((m // batch) ** 0.5))
            ho, _ = _pool_out(h, h, (3, 3), (2, 2), (1, 1))
            total["bn_stats"] += bn_bytes_ops("bn_stats", m, c, 2, "none")[0]
            total["bn_pool_apply"] += bn_bytes_ops(
                "bn_pool_apply", m, c, 2, "none", mo=batch * ho * ho)[0]
            continue
        for name in ("bn_stats",) * (2 if form == "dual" else 1) + (
                "bn_apply", "bn_bwd_reduce", "bn_bwd_dx"):
            total[name] += bn_bytes_ops(name, m, c, 2, form)[0]
    return {k: v / HBM_BYTES_PER_S * 1e3 for k, v in total.items()}


def bn_backward_sites(torch, fbn, dev, model, card):
    """K7 and K8 timed (CUDA graph replay, bf16, relu) at each of the
    step's BN backward sites' shapes, beside each one's bound: where
    their per-step time over bound comes from.  Sites of one shape are
    timed once.  Prints a table; returns the per-step sums."""
    gen = torch.Generator(device=dev).manual_seed(7)
    sites = [t for t in bn_site_list(model, RESNET_B, RESNET_HW)
             if t[3] != "pool"]
    timed = {}
    for _, m, c, form in sites:
        if (m, c, form) in timed:
            continue
        x = _bn_rows(torch, gen, dev, m, c, torch.bfloat16)
        g = _bn_rows(torch, gen, dev, m, c, torch.bfloat16, shift=0.0)
        r = None if form == "none" else _bn_rows(torch, gen, dev, m, c,
                                                 torch.bfloat16)
        coef = _bn_coef(torch, gen, dev, c)
        coefr = _bn_coef(torch, gen, dev, c) if form == "dual" else None
        timed[(m, c, form)] = {
            "bn_bwd_reduce": graph_ms(torch, lambda: fbn.bn_bwd_reduce(
                g, x, coef, r, "relu", coefr)),
            "bn_bwd_dx": graph_ms(torch, lambda: fbn.bn_bwd_dx(
                g, x, coef, r, "relu", coefr))}
        del x, g, r
    torch.cuda.empty_cache()
    print(f"bn backward sites [{card}]: site, M, C, residual; K7 ms "
          "(bound), K8 ms (bound), share of bound")
    sums = {"bn_bwd_reduce": [0.0, 0.0], "bn_bwd_dx": [0.0, 0.0]}
    for label, m, c, form in sites:
        cells = []
        for name in ("bn_bwd_reduce", "bn_bwd_dx"):
            t = timed[(m, c, form)][name]
            b, _ = bound_ms(*bn_bytes_ops(name, m, c, 2, form))
            sums[name][0] += t
            sums[name][1] += b
            cells.append(f"{t:.4f} ({b:.4f}) {b / t:.0%}")
        print(f"bn site {label:<14} M={m:>9} C={c:>4} {form:<5}  "
              + "  ".join(cells))
    print("bn backward sites: per step K7 {:.3f} ms (bound {:.3f}, {:.0%}), "
          "K8 {:.3f} ms (bound {:.3f}, {:.0%}) over {} sites".format(
              *sums["bn_bwd_reduce"],
              sums["bn_bwd_reduce"][1] / sums["bn_bwd_reduce"][0],
              *sums["bn_bwd_dx"], sums["bn_bwd_dx"][1] / sums["bn_bwd_dx"][0],
              len(sites)))
    return sums


def resnet_phase(torch, args, dev, card):
    """ResNet-50, BASELINE config #2: the conv-net leg of the main path,
    through the step's CUDA graph; then the same steps uncaptured (the A/B:
    losses bit-equal; the profile with the stem's plain backward recompute
    on a line of its own) and under recompute_policy("stages")
    (RECOMPUTE_STEPS steps: losses within 1e-5 relative, K5 / K6 again at
    every block site, peak memory below the plain run's)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.jit import TrainStep, layout_policy
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import fused_bn_act as fbn
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50
    torch.cuda.empty_cache()
    entries = (fbn.bn_act_train, fbn.bn2_act_train, fbn.bn_act_pool_train)

    def make():
        pt.seed(args.seed)
        model = resnet50(device=dev, seed=args.seed)
        opt = Momentum(learning_rate=0.1, momentum=0.9,
                       parameters=model.parameters())
        return model, TrainStep(model, lambda lg, y: F.cross_entropy(lg, y),
                                opt, amp_level="O2", amp_dtype="bfloat16")

    def counters():
        for name in BN_KERNELS:
            getattr(fbn, name).launches = 0
        fbn.bn_pool_apply.routes.update(ring=0, window=0)
        for e in entries:
            e.relayouts = 0
        return lambda: dict(
            {n: getattr(fbn, n).launches for n in BN_KERNELS},
            routes=dict(fbn.bn_pool_apply.routes),
            relayouts=sum(e.relayouts for e in entries))
    groups = {f"{n} (K{5 + i})": (f"{n}_kernel",)
              for i, n in enumerate(BN_KERNELS)}
    groups["bn_pool_apply (K9)"] += ("bn_pool_ring_kernel",)
    groups["bn_sum_partials (K5, K7)"] = ("bn_sum_partials",)
    groups["pooling (PyTorch)"] = ("max_pool", "avg_pool", "adaptive_avg")
    groups["convolutions (cuDNN)"] = (
        "conv", "xmma", "cudnn", "cutlass", "implicit_gemm", "dgrad",
        "wgrad", "fprop", "nhwc", "nchw")
    stem = "stem backward recompute (_BnPool.backward, plain)"
    what = (f"train step (ResNet-50, b{RESNET_B} x {RESNET_HW}^2, O2 bf16, "
            "NHWC")
    with layout_policy("NHWC"):
        model = resnet50(device=dev, seed=args.seed)   # sites and bounds
        per_step = bn_launches_per_step(model)
        want = {"bn_stats": 53, "bn_apply": 48, "bn_bwd_reduce": 48,
                "bn_bwd_dx": 48, "bn_pool_apply": 1}
        if per_step != want:
            fail(f"ResNet-50's fused-BN sites give {per_step} launches per "
                 f"step, not {want}")
        per_step_rc = bn_launches_per_step(model, recompute=True)
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        x = torch.randn(RESNET_B, 3, RESNET_HW, RESNET_HW, generator=gen,
                        device=dev)
        y = torch.randint(0, 1000, (RESNET_B,), generator=gen, device=dev)
        cap = train_leg(torch, make, (x, y), RESNET_STEPS, counters, card,
                        what + ", captured)", groups=groups, top=14)
        vals = cap["losses"]
        launches = {n: cap["launches"][n] for n in BN_KERNELS}
        print("resnet: losses " + ", ".join(f"{v:.4f}" for v in vals))
        print("resnet: losses in full " + ", ".join(repr(v) for v in vals))
        if not all(np.isfinite(vals)):
            fail(f"non-finite ResNet-50 training loss: {vals}")
        expect = {k: v * RESNET_STEPS for k, v in per_step.items()}
        if launches != expect:
            fail(f"K5-K9 launches {launches}, expected {expect} "
                 f"({per_step} per step x {RESNET_STEPS} steps, through "
                 "replays)")
        if cap["launches"]["routes"] != {"ring": expect["bn_pool_apply"],
                                         "window": 0}:
            fail(f"K9 took routes {cap['launches']['routes']} on the main "
                 "path, not the ring")
        if not cap["warm"]["compiled"] or cap["recaptured"]:
            fail(f"resnet: warmup {cap['warm']}, {cap['recaptured']} "
                 "captures after it (expected one capture, by warmup)")
        print(f"resnet [{card}]: ResNet-50 b{RESNET_B} {RESNET_HW}x"
              f"{RESNET_HW} O2 bf16 NHWC, Momentum(0.1, 0.9), captured: "
              f"K5-K9 launches per step {per_step}; layout copies per step "
              f"{cap['launches']['relayouts'] / RESNET_STEPS:g}")
        print(_leg_line("resnet captured", card, cap, RESNET_B, "images"))
        busy, sums = cap["profile"][1], cap["profile"][2]
        bounds = bn_step_bounds(model, RESNET_B, RESNET_HW)
        fused = sum(v for k, v in sums.items() if k.startswith("bn_"))
        print(f"resnet: K5-K9 per step {fused:.3f} ms of {busy or 0:.3f} ms "
              f"device time; per kernel, device ms vs bound ms over this "
              "step's sites: " + ", ".join(
                  f"{n} {sums.get(f'{n} (K{5 + i})', 0.0):.3f} vs "
                  f"{bounds[n]:.3f}" for i, n in enumerate(BN_KERNELS))
              + f" (K5-K8 bound {sum(bounds.values()) - bounds['bn_pool_apply']:.3f})")
        unc = train_leg(torch, make, (x, y), RESNET_STEPS, counters, card,
                        what + ", uncaptured)", uncaptured=True,
                        groups=groups, top=14,
                        ranges={stem: "bn_pool_backward"})
        print(_leg_line("resnet uncaptured", card, unc, RESNET_B, "images"))
        if unc["losses"] != vals:
            fail(f"resnet: captured losses {vals} differ from the "
                 f"uncaptured step's {unc['losses']}")
        print(f"resnet: captured and uncaptured losses bit-equal over "
              f"{RESNET_STEPS} steps; the stem's plain backward recompute "
              f"{unc['profile'][2].get(stem, 0.0):.3f} ms per step "
              "(uncaptured profile)")
        tag = "resnet stages/dots_saveable"
        leg = train_leg(torch, make, (x, y), RECOMPUTE_STEPS, counters, card,
                        what + ", captured, recompute stages)",
                        policy=("stages", "dots_saveable"), groups=groups,
                        top=14)
        print(_leg_line(tag, card, leg, RESNET_B, "images"))
        _check_recompute_losses(tag, leg["losses"], vals)
        stated = {k: v * RECOMPUTE_STEPS for k, v in per_step_rc.items()}
        got = {n: leg["launches"][n] for n in BN_KERNELS}
        if got != stated:
            fail(f"{tag}: K5-K9 launches {got}, stated {stated} "
                 f"({per_step_rc} per step: K5 / K6 again at every block "
                 "site)")
        if not leg["peak_gib"] < cap["peak_gib"]:
            fail(f"{tag}: peak memory {leg['peak_gib']:.2f} GiB is not "
                 f"below the plain step's {cap['peak_gib']:.2f} GiB")
        print(f"{tag} [{card}]: device time {leg['profile'][1] or 0:.3f} "
              f"ms vs {busy or 0:.3f} ms without recompute; peak memory "
              f"{leg['peak_gib']:.2f} vs {cap['peak_gib']:.2f} GiB "
              f"({leg['peak_gib'] / cap['peak_gib']:.1%})")
        bn_backward_sites(torch, fbn, dev, model, card)
    del model, x
    torch.cuda.empty_cache()
    return launches


def resnet_check_phase(torch, args, dev):
    """One f32 ResNet-18 step (10 classes, 4 x 3 x 64 x 64) on the kernel
    path (NHWC policy) against the plain path on the CPU, same weights and
    batch: loss, gradients and running statistics."""
    from paddle_tpu_torch.jit import forward_loss, layout_policy
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import fused_bn_act as fbn
    from paddle_tpu_torch.vision.models import resnet18
    rng = np.random.RandomState(args.seed + 4)
    batch = (rng.randn(4, 3, 64, 64).astype(np.float32),
             rng.randint(0, 10, (4,)))
    gpu = resnet18(num_classes=10, device=dev, seed=args.seed + 4)
    cpu = copy.deepcopy(gpu).cpu()
    out = []
    for model, d, policy in ((gpu, dev, "NHWC"),
                             (cpu, torch.device("cpu"), None)):
        n0 = {k: getattr(fbn, k).launches for k in BN_KERNELS}
        x, y = (torch.from_numpy(a).to(d) for a in batch)
        with layout_policy(policy):
            loss = forward_loss(model, lambda lg, yy: F.cross_entropy(lg, yy),
                                (x, y))
            names = [n for n, _ in model.named_parameters()]
            grads = torch.autograd.grad(loss, [p for _, p in
                                               model.named_parameters()])
        stats = {k: v.detach().cpu() for k, v in model.state_dict().items()
                 if k.endswith(("_mean", "_variance"))}
        out.append((float(loss.detach()),
                    {n: g.cpu() for n, g in zip(names, grads)}, stats,
                    {k: getattr(fbn, k).launches - n0[k]
                     for k in BN_KERNELS}))
    (lg, gg, sg, ng), (lc, gc, sc, nc) = out
    if ng != bn_launches_per_step(gpu) or any(nc.values()):
        fail(f"ResNet-18 check: kernel launches {ng} on the card, {nc} on "
             f"the CPU; expected {bn_launches_per_step(gpu)} and none")

    def worst(a, b):
        return max(((a[k] - b[k]).abs().max() / b[k].abs().max()
                    .clamp_min(1e-30)).item() for k in b)
    wg, ws = worst(gg, gc), worst(sg, sc)
    print(f"resnetcheck: ResNet-18 f32 step, kernel path vs CPU plain path: "
          f"loss {lg:.6f} vs {lc:.6f}; largest gradient difference {wg:.2e} "
          f"and running-statistic difference {ws:.2e} of their tensor's "
          f"max (tolerance {GRAD_TOL}) over {len(gc)} parameters and "
          f"{len(sc)} statistics; launches {ng}")
    if not abs(lg - lc) <= GRAD_TOL * abs(lc) or not wg <= GRAD_TOL or \
            not ws <= GRAD_TOL:
        fail("the kernel-path ResNet step disagrees with the plain path")
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
        kern = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                kern = " " + _kernel_name(line.split("'")[1])
            elif "registers" in line or "spill" in line:
                print(f"build {name}{kern}: {line.strip()}")
    rng = np.random.RandomState(args.seed)
    kernels = paged_phase(torch, rng, dev) + int8_phase(torch, rng, dev)
    torch.cuda.empty_cache()
    model = serve_model(torch, args, dev)
    launches = serve_phase(torch, args, dev, card, model)
    pressure_phase(torch, args, dev, card, model)
    prefix_phase(torch, args, dev, card, model)
    del model
    launches.update(serve_phase(torch, args, dev, card,
                                serve_model(torch, args, dev, torch.bfloat16),
                                torch.bfloat16))
    torch.cuda.empty_cache()
    fixed_phase(torch, args, dev)
    torch.cuda.empty_cache()
    kernels += flash_phase(torch, rng, dev)
    launches.update(train_phase(torch, args, dev, card))
    train_check_phase(torch, args, dev)
    torch.cuda.empty_cache()
    kernels += bn_phase(torch, args, dev)
    launches.update(resnet_phase(torch, args, dev, card))
    resnet_check_phase(torch, args, dev)
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
