#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Builds the hand-written kernels from `src/repro_torch/csrc/` (nvcc, sm_90a),
then runs twenty-five phases, each printing one JSON line, and a
twenty-sixth line:

  device         the card's name and power limit; ptxas entry, register,
                 shared-memory and spill lines of both sources, the
                 tensor-core (HMMA/HGMMA) instructions per kernel in the SASS,
                 and each ChaCha20 kernel's SASS and SHFL instruction counts
  chacha20       RFC 8439 vectors through the kernel; kernel == plain version
                 bit for bit at the k-means wire (64 rows x 132 blocks) and
                 at a 64 MiB wire with random counters (wrapping at 2**32),
                 for both kernel designs (4 lanes per block, the default, and
                 one thread per block); on the main path's packed wire, card
                 == CPU plain version; each design's device time (`kernel_ms`:
                 20 calls in one CUDA graph, its replays timed by CUDA
                 events) and the wrapper-inclusive time
                 by CUDA events (`call_ms`); the round id read from device
                 memory (`round_dev`) == the by-value round bit for bit at
                 rounds 0, 1, 2**31, 2**32-1 on both designs, and its time
                 (`kernel_ms_round_dev`); the k-means wire's placed and
                 unplaced stores against the plain version; at granite-moe's
                 leg wire (1.01 GB) the send side's placed store
                 (`moe_leg_placed`: each row at its receiver's row) against
                 the plain version in receiver order, bit for bit, and the
                 device times of both stores
  attention      the prefill's fused causal attention kernel at granite-moe's
                 per-layer shape (8 x 4,096 tokens, 24 heads on 8 KV heads,
                 Dh 64) and qwen2-moe's (16 heads on 16, Dh 128): kernel ms
                 (CUDA events over a graph of its calls) beside its bound
                 (causal operations at 989 TFLOP/s), the plain path's ms
                 (the model's query-chunked `attend`) and, as a yardstick
                 only, scaled_dot_product_attention's (`library_ms`); its
                 relative error and the plain path's against a float32
                 softmax of the same inputs over the whole batch
                 (asserted: the kernel's no larger), two runs equal bit for
                 bit; the float32 specialisation at granite's shape, one
                 prompt: ms, the plain path's, error against float64
                 (asserted within 2**-16)
  crypt_call     the shuffle's crypt call on the main path's wire: warm call
                 time (host clock to a synchronise), device operations and
                 synchronising calls per crypt (asserted: 1 and 0, and the two
                 crypts of a round run under set_sync_debug_mode("error")),
                 the kernel's device time inside the call at the wire and at
                 64 MiB, and device operations and synchronising calls per
                 executed secure and plaintext round
  kmeans_assign  S=8 x 524,288 points, D=64, K=256: sums/counts against the
                 plain accumulate fed the kernel's assignments, assignments
                 against the plain version outside near-ties, two runs equal
                 bit for bit; kernel, plain and cuBLAS distance-product times,
                 the time of each kernel inside the call (assign, accumulate,
                 CTA reduce; torch.profiler), and two bounds: FP32 CUDA cores
                 (bound_ms) and 3xTF32 on the tensor cores (bound_tc_ms);
                 the same checks and figures at D=128, K=1024 (`d128_k1024`,
                 2 GiB of points; the plain version timed on one shard)
  kmeans_fit     secure k-means, 4,194,304 x 64 points, K=256, 8 virtual
                 shards, to the paper's threshold; kernel launches counted on
                 this run alone; plaintext fit identical bit for bit; the
                 same fit through make_kmeans_runner (CUDA graphs of one
                 round) equal bit for bit, cold and warm times, idle share
  parity_small   the same fit at N=4096, K=8, D=4 on the card and on the CPU
                 (plain versions), and one fixed wire encrypted on both
  sort           secure sample_sort of 2**24 lognormal f32 values, 8 shards,
                 lossless capacity (a 1 GiB wire a round), balance 1.5, a
                 6-round budget: output == np.sort bit for bit, counts sum to
                 n, no drop in the last round, halted, sharded == replicated
                 layout and plaintext == secure bit for bit, one sync a round;
                 ms per job and round, rounds, wire bytes, the ChaCha kernel at
                 this wire against its bytes bound, device operations and
                 syncs per round, peak memory
  grep           secure grep_count of 2**26 Zipf tokens (vocabulary 65,536)
                 for 16 patterns of ranks 64-4096, 16 rounds (a 256 MiB wire a
                 round), and with max_matches at half the hits: hits == numpy
                 exactly (over the executed chunks when limited), the limited
                 job halts early, one sync a round; the same figures
  wordcount      secure wordcount of the same tokens: counts == np.bincount
                 exactly, plaintext == secure; ms per job, wire, ChaCha time
  serve          the secure job service (8 shards, one RunnerCache,
                 max_concurrent=3): a cold k-means job of 3,000,000 points
                 (bucket 4,194,304), warm jobs of 4,194,304 and 2,500,000
                 points (0 misses, no new capture; the full one == kmeans_fit
                 bit for bit), then k-means, sort (2**24 values) and grep
                 (2**26 tokens) together and then serially on a fresh service
                 (all warm, equal bit for bit, sort == np.sort, grep ==
                 numpy); latencies, misses, chunks, round bases, cache stats
                 with captures, ms per round per kind, the idle share of a
                 profiled warm job, per kind a warm chunk's ms, syncs, host
                 launch calls and device operations, k-means copy-in/out
                 ms, pool bytes, peak memory, and the kernels' launches on
                 the path by profiler
  enclave        SecVM at 2**24 lanes == its oracle (rtol 1e-5), run_encrypted
                 clean under set_sync_debug_mode("error"), one kernel sequence
                 for two programs of one length (three calls each in turns
                 in one profiler session of a fresh child process, split at
                 marker kernels; each program's sequence the one two of its
                 calls agree on), ms per instruction; SecVM as
                 the map function of a secure run_mapreduce on 8 shards (exact
                 sums, 4 ChaCha launches: the round's two crypts and the
                 program's decryption); the port's quickstart (cluster and
                 device word count); the cluster k-means == make_kmeans_step on
                 the card (rtol 1e-4, atol 1e-5); mac_tag_words == mac_tag_host
                 at 1,024, 2**20 and 2**22 words, its time at 2**28 words
                 against the bytes bound; the kernels' launches on this path
                 (its own calls, not the check's reference step: ChaCha > 0,
                 k-means 0, as the cluster k-means runs on the host)
  calibrate      the calibrated cost model on the card: run_calibration(quick)
                 on 8 virtual shards, then each main-path workload's own item
                 term (`probe_workload_items`: its plaintext round through
                 the graph runner at three per-shard sizes of at most 1/8 of
                 the main path's), every fitted constant >= 0 and finite,
                 and the seconds both took (`calibration_s`); saved to a
                 temporary JSON and activated through $REPRO_CALIBRATION,
                 each `auto` resolver answers the model's recommendation,
                 and with the variable unset its default; trace_workload of
                 the main path's secure k-means round (4,194,304 x 64,
                 K=256), a sort round (2**24 values) and a grep round (2**26
                 tokens), each with its item term: predicted wire bytes ==
                 the wire record of the path's own rounds exactly, the
                 predicted round beside the served graph round's ms,
                 ASSERTED |pred - measured| / measured <= PRED_ERROR_MAX
                 (0.5, `benchmarks/bench_costmodel.py`'s bar), the generic
                 slope's prediction beside it, and the predicted capture
                 seconds; hillclimb cells S and K on this calibration (best
                 vector, resolver vector); the kernels' launches on this
                 path (ChaCha > 0 from the secure probes and traces, k-means
                 >= 1 from the k-means trace)
  paper          the paper's evaluation script, `python -m
                 repro_torch.kmeans_secure`, whole on the card: the secure
                 fit (20,000 x 2 points, K = 10) on a one-shard mesh, both
                 kernels launched; its rounds equal the same fit's on the
                 CPU and its centres within PAPER_TOL; the cluster sweep's
                 virtual times and overheads and the paging cliff's bytes
  lm_serve       LM serving of granite-moe-3b-a800m at its published config
                 (32 layers, d_model 1536, 40 experts top-8, bf16, seeded
                 weights) with its experts on 8 virtual shards: a secure
                 prefill of 8 x 4096 tokens (the batch cut to 4 past 60 GB of
                 peak memory), its expert exchanges ChaCha20-encrypted
                 (asserted: 4 kernel launches a layer, 128 a prefill), plain
                 and secure prefills in turns (logits and KV cache equal bit
                 for bit), 64 sampled decode steps (no ChaCha launch, logits
                 finite); parameter and KV-cache bytes, prefill ms, prompt
                 tokens/s, secure over plain, decode ms per step and tokens/s,
                 a profiled decode step's idle share and device operations,
                 peak memory, wire bytes per prefill, the kernel on one leg's
                 wire (== plain version bit for bit) against its bytes bound,
                 the prefill's operations bound and the decode step's bytes
                 bound; the reduced model on 4 shards, secure, card == CPU
                 within 1e-3
  lm_train       LM training of granite-moe-3b-a800m at its published config:
                 float32 masters, bf16 compute, experts on 8 virtual shards,
                 batch 4 x 1024 from the secure data pipeline (cut to 2 past
                 75 GB of peak memory), secure ingest and a secure MoE, remat
                 sqrt (4 groups of 8) with save_shuffle, AdamW in place: from
                 one seeded state, secure gradients == plain bit for bit and a
                 secure step == a plain step (loss, parameters, moments) bit
                 for bit, every expert weight's gradient nonzero; steps 2-9
                 secure and plain in turns, every loss and gradient norm
                 finite, 1 + 8 ChaCha launches a layer per secure step (no
                 exchange replayed); a profiled step's idle share and largest
                 device items; the optimizer update's ms; peak memory; step
                 ms, tokens/s and the step's operations bound; the update's
                 bytes bound; the kernel on a training leg's wire (== plain
                 bit for bit, rounds 0 and 2**31) against its bytes bound;
                 what the fixed-order backwards cost against float atomics;
                 the reduced model on 4 shards card == CPU within rtol 1e-4
                 after two steps, and 2 steps + a checkpoint + 2 resumed ==
                 4 straight steps bit for bit on the card
  lm_ssm         rwkv6-1.6b at its published config (24 layers, d_model
  lm_hybrid      2048), zamba2-1.2b at its (38 mamba layers, one shared
  lm_audio       attention+MLP block every 6) and whisper-base at its (6 + 6
                 layers, d_model 512, 1,500 frames), bf16, seeded weights.
                 Serving: one sequence's 16 decode steps after a prefill ==
                 a prefill of the same tokens within FAMILY_CONSIST_TOL of
                 the largest logit (rwkv, zamba2: after 4,080 of 4,096
                 tokens; whisper: after its 4-token prompt, on the same
                 frames); a batch of 8 x 4,096 prompt tokens (whisper: 8 x
                 1,500 frames, a 4-token prompt, a 448-token cache) and 64
                 sampled decode steps (whisper 128), every logit finite, no
                 ChaCha launch; prefill ms and tokens/s, the prefill's
                 device operations and idle share, decode ms per step, a
                 profiled step's idle share and device operations, the
                 prefill's operations bound and the step's bytes bound; one
                 layer's blocked WKV == the per-token scan within 2e-4, or
                 ssm_apply (chunk 256) == ssm_decode_step iterated within
                 2e-2 of the largest magnitude. Training: float32 masters,
                 remat sqrt, 4 x 4,096 tokens from the secure pipeline
                 (whisper: 8 x 448 with encrypted frames at ctr + 2**16, the
                 steps' counters spaced so no two share a pad; cut to 4 x
                 1,024 past 75 GB): secure gradients and a secure step ==
                 plain bit for bit from one seeded state, every loss and
                 gradient finite (zamba2's a_log, dt_bias and in_proj too),
                 ChaCha launches per secure step 1 (whisper 2); step ms,
                 tokens/s, a profiled step's idle share and largest device
                 items, peak memory, the step's operations bound; the
                 kernel on the ingest wire (and the frames) == plain bit
                 for bit against its bound; the reduced model card == CPU
                 after two steps (lm_train's rule). lm_hybrid also holds
                 the published 38 layers on the card against the CPU's
                 plain path in float32 on the same seeded weights: a
                 64-token sequence's forward logits, its prefill and 2
                 decode steps and every cache entry within 4x the CPU's
                 own response to rounding-size weight changes, and the two
                 mamba layers after the sixth shared block, fed one hidden
                 state, within HYBRID_CPU_TOL (1e-4) of their largest
                 magnitude
  lm_dense       glm4-9b (40 layers, d_model 4096, 32 heads with 2 KV
  lm_moe_shared  heads, d_ff 13,696) and qwen2-moe-a2.7b (24 layers, 60
                 routed experts top-4 padded to 64 over 8 virtual shards, 4
                 shared experts of hidden 5,632) at their published configs,
                 asserted field by field, bf16, seeded weights, served: one
                 sequence's 16th decode step after a prefill == a prefill of
                 the same tokens within FAMILY_CONSIST_TOL in float32
                 (qwen2-moe at a capacity that drops nothing; at the
                 published capacity measured), in bf16 measured; a batch of
                 8 x 4,096 prompt tokens (cut to 4 past LM_PEAK_LIMIT) and
                 64 sampled decode steps, every logit finite, no ChaCha
                 launch in decode; qwen2-moe's prefill secure: 4 ChaCha
                 launches a layer, secure == plain bit for bit (logits, KV
                 cache), no token routed to a padding expert, the kernel on
                 one leg's wire == plain against its bytes bound; glm4's
                 prefill runs no shuffle; prefill ms and tokens/s, device
                 operations and idle share, decode ms per step, a profiled
                 step's idle share and operations, peak memory, the
                 prefill's operations bound and the step's bytes bound
  lm_mqa         granite-20b (52 layers, d_model 6144, 48 heads with one KV
  lm_vlm         head, d_ff 24,576; 55.7 GB of bf16 weights) and
                 chameleon-34b (48 layers, d_model 8192, 64 heads with 8 KV
                 heads, d_ff 22,016, qk_norm; 67.5 GB), asserted field by
                 field, bf16, seeded weights, served plain as lm_dense
                 serves glm4-9b, but: at entry less than 1 GB allocated
                 (the job service's runner cache released), the free bytes
                 reported; the float32 consistency at the published widths
                 4 layers deep (float32 weights of the full depth do not
                 fit), the bf16 one on the full model; the batch reckoned
                 from bytes before any prefill (`serve_batch`: 8 halved
                 until the weights, the KV cache, the float32 score chunk
                 and the activations fit), reported with the cuts in
                 `reduced`; 0 ChaCha and 0 k-means launches
  hillclimb_lm   hillclimb cells A, B and C of `repro_torch.launch.hillclimb`
                 on the card (`measure_lm_cell`): every variant's step, one
                 warm-up and the median of 3, host clock to a synchronise;
                 ms, tokens/s, peak memory, ChaCha launches a step, beside
                 its abstract counts at the same shape (one process
                 started with the script counts them on `meta`). A:
                 rwkv6-1.6b training at 4 x 4,096 (batch halved if a
                 variant's step, reckoned from one at batch 1, would not
                 fit), the per-token scan and the blocked WKV beside it at
                 4 x 64; B: qwen2-moe-a2.7b decode at a 32,768-token
                 context, the cache filled with seeded random K/V, float32
                 weights (v3: bf16, asserted half the bytes), the batch
                 reckoned beside them; C: granite-moe-3b-a800m training at
                 4 x 1,024 with secure ingest: ChaCha launches a step
                 asserted 1 + 8 a layer for v0, v1, v2, v4 (v0 inherits the
                 config's save_shuffle), 1 for v3, and more than v1's for
                 the port's x0 (the full MoE remat replays the exchange),
                 each equal to its abstract count plus the ingest; v4 runs
                 v1's program and their difference is the noise reading
  memory         the device bytes that collecting the interpreter's
                 reference cycles freed after each phase (collected before
                 the next phase, whose peak memory then counts only what is
                 alive)
  kernels        per kernel: launches on the main path, time, bound, plain
                 and library times; each kernel's launches on each path
                 (the attention kernel: every LM path's prefills, 0 on the
                 others)
                 (ChaCha20: k-means, sort, grep, wordcount, enclave,
                 calibrate, paper, lm_serve, lm_train, lm_ssm, lm_hybrid,
                 lm_audio, lm_moe_shared, hillclimb_lm (by cell, and per
                 step by variant of C), and 0 on lm_dense, lm_mqa and
                 lm_vlm, which have no exchange; k-means: k-means,
                 calibrate, paper, and 0 on the LM paths),
                 each counted from 0
                 just before that
                 path's run, and on the serve path (by profiler: replayed
                 graphs bypass the wrappers' counters); the k-means kernel's
                 D=128, K=1024 figures

Then the nvidia-smi line and, last, {"ok": true, "device": {...}}. Any failed
check raises, and the script exits non-zero. It needs a CUDA card and the
repository's `src/` beside it. To compare with an older commit, run that
commit's own chip_smoke.py from its checkout in the same chip call.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import io
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import statistics
import tempfile
import time
import warnings
from dataclasses import replace

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

N_POINTS, K, D, SHARDS = 4_194_304, 256, 64, 8
MAX_ITER, ROUNDS_PER_DISPATCH = 200, 8
PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_S = 67e12  # H100 SXM FP32 outside the tensor cores
PEAK_TF32_S = 495e12  # H100 SXM TF32 tensor cores, dense
# 32-bit integer ops: per SM and clock, 64 on the INT32 pipe (add, logic,
# shifts) plus 64 integer multiply-adds on the FMA pipe; x 132 SMs x 1.98 GHz
# boost (the same count gives the FP32 67 TFLOP/s: 128 lanes, FMA = 2 ops).
# With 64 per clock alone the 64 MiB wire ran faster than that bound.
PEAK_I32_S = 128 * 132 * 1.98e9
CHACHA_OPS_PER_BLOCK = 80 * 12 + 16 + 16 + 2  # QRs, feed-forward, XOR, counter
KEY = bytes(range(32))
# sort: 2**24 lognormal values, the largest power of two whose f32 counts stay exact
SORT_N, SORT_SEED, SORT_ROUNDS, SORT_BALANCE = 2**24, 0, 6, 1.5
# grep and wordcount: 2**26 Zipf tokens over 65,536 words; 16 patterns of ranks 64-4096
N_TOKENS, VOCAB, TOKEN_SEED = 2**26, 65536, 0
GREP_SEED, GREP_PATTERNS, GREP_ROUNDS = 1, 16, 16
# k-means past the old (K, D) range: 4,194,304 x 128 points, K=1024
WIDE_D, WIDE_K, WIDE_SEED = 128, 1024, 1
# enclave: SecVM lanes, MAC words checked against the host tag and timed
SECVM_LANES, MAC_WORDS_CHECKED, MAC_WORDS_TIMED = 2**24, (1024, 2**20, 2**22), 2**28


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps: int, warm: int = 2) -> float:
    """Mean milliseconds per call over `reps` calls, by CUDA events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def collect_garbage() -> int:
    """Device bytes freed by collecting the interpreter's reference cycles.

    Called after each phase, so the next phase starts with only what is
    really alive: a peak-memory figure would otherwise count whatever cyclic
    garbage the collector had not reached yet."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    gc.collect()
    return before - torch.cuda.memory_allocated()


def u32(a, dev):
    return torch.as_tensor(np.asarray(a, np.uint64).astype(np.uint32).view(np.int32), device=dev)


def phase_device(build):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.time()
    build.build("chacha20", "kmeans", "moe")
    for dqk, dv in ATTN_BUILDS:
        build.build("attention", defines={"QK_DIM": dqk, "V_DIM": dv})
    sass = {n: sass_counts(build.library_path(n)) for n in ("chacha20", "kmeans")}
    sass.update({f"attention_{dqk}_{dv}": sass_counts(build.library_path(
        "attention", {"QK_DIM": dqk, "V_DIM": dv})) for dqk, dv in ATTN_BUILDS})
    tensor_ops = {n: None if c is None else {f: v["tensor_core"] for f, v in c.items()}
                  for n, c in sass.items()}
    if tensor_ops["kmeans"] is not None:
        check(all(c > 0 for f, c in tensor_ops["kmeans"].items() if "kmeans_assign_kernel" in f),
              "the k-means assign kernel has no tensor-core instruction")
    for dqk, dv in ATTN_BUILDS:
        if tensor_ops[f"attention_{dqk}_{dv}"] is not None:
            check(all(c > 0 for f, c in tensor_ops[f"attention_{dqk}_{dv}"].items()
                      if "attention_prefill_kernel" in f),
                  f"the bf16 attention kernel ({dqk}, {dv}) has no tensor-core instruction")
    emit({"phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": round(time.time() - t0, 3),
          "ptxas": {**{n: [ln for ln in build.ptxas_info(n)
                           if "entry function" in ln or "registers" in ln or "smem" in ln
                           or "spill" in ln]
                       for n in ("chacha20", "kmeans", "moe")},
                    **{f"attention_{dqk}_{dv}": [ln for ln in build.ptxas_info(
                        "attention", {"QK_DIM": dqk, "V_DIM": dv})
                        if "registers" in ln or "spill" in ln]
                       for dqk, dv in ATTN_BUILDS}},
          "sass_tensor_core_ops": tensor_ops,
          "sass_chacha20": sass["chacha20"]})
    return smi


def sass_counts(lib):
    """Per kernel in a built library, read with the toolkit's cuobjdump: its
    SASS instructions, tensor-core instructions (HMMA, HGMMA) and warp
    shuffles (SHFL); None where cuobjdump is missing."""
    tool = shutil.which("cuobjdump")
    if tool is None:
        cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
        tool = cand if os.path.exists(cand) else None
    if tool is None:
        return None
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, timeout=120)
    if out.returncode != 0:
        return None
    counts, fn = {}, None
    for ln in out.stdout.splitlines():
        if "Function :" in ln:
            fn = ln.split("Function :", 1)[1].strip()
            counts[fn] = {"instructions": 0, "tensor_core": 0, "shfl": 0}
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", ln)
        if fn is None or m is None:
            continue
        op = m.group(1).split(".")[0]
        counts[fn]["instructions"] += 1
        counts[fn]["tensor_core"] += op in ("HMMA", "HGMMA")
        counts[fn]["shfl"] += op == "SHFL"
    return counts


def phase_chacha(dev):
    from repro_torch.crypto import chacha
    from repro_torch.kernels.chacha20 import kernel as ck, ops, ref as cr
    from repro_torch.kernels.chacha20.table import block_table

    # RFC 8439 §2.3.2 block and §2.4.2 encryption, through the kernel
    rfc_block = np.array([0xE4E7F110, 0x15593BD1, 0x1FDD0F50, 0xC47120A3, 0xC7F4D1C7,
                          0x0368C033, 0x9AAA2204, 0x4E6CD4C3, 0x466482D2, 0x09AA9F07,
                          0x05D7C214, 0xA2028BD9, 0xD19C12B5, 0xB94E16DE, 0xE883D0CB,
                          0x4E3C50A2], np.uint32)
    s0 = ops.make_state0(chacha.key_to_words(KEY),
                         chacha.nonce_to_words(bytes.fromhex("000000090000004a00000000")), 1,
                         device=dev)
    blk = ops.chacha20_xor_words(torch.zeros(16, dtype=torch.int32, device=dev), s0)
    check(np.array_equal(blk.cpu().numpy().view(np.uint32), rfc_block), "RFC 8439 2.3.2")
    pt = (b"Ladies and Gentlemen of the class of '99: If I could offer you "
          b"only one tip for the future, sunscreen would be it.")
    ct = ops.ctr_crypt_array(torch.frombuffer(bytearray(pt), dtype=torch.uint8).to(dev),
                             chacha.key_to_words(KEY),
                             chacha.nonce_to_words(bytes.fromhex("000000000000004a00000000")), 1)
    check(bytes(ct.cpu().numpy()) == chacha.chacha20_encrypt_bytes(
        KEY, bytes.fromhex("000000000000004a00000000"), 1, pt), "RFC 8439 2.4.2")

    rng = np.random.default_rng(1)
    out = {}
    for label, rows, blocks, reps in (("wire", 64, 132, 500), ("64MiB", 64, 16384, 50)):
        x = u32(rng.integers(0, 2**32, (rows, 16 * blocks)), dev)
        j = np.arange(blocks)
        base = rng.integers(0, 2**32, blocks)
        mul = rng.integers(0, 2**32, blocks)
        # counters near 2**32 with small strides wrap inside the buffer
        base[: blocks // 2] = 2**32 - 1 - j[: blocks // 2]
        mul[: blocks // 2] = j[: blocks // 2] % 5
        table = block_table(base, mul, 16 * j, np.full(blocks, 16), dev)
        nid = u32(rng.integers(0, 2**32, rows), dev)
        crow = u32(rng.integers(0, 2**32, rows), dev)
        key, nonce = rng.integers(0, 2**32, 8), rng.integers(0, 2**32, 3)
        args = (x, table, key, nonce, int(rng.integers(0, 2**32)), nid, crow)
        y_ref = cr.chacha20_xor_packed_ref(*args)
        res = {"rows": rows, "blocks": blocks, "bit_exact": True, "round_dev_bit_exact": True}
        for lanes in (4, 1):
            y = ck.chacha20_xor_packed_cuda(*args, lanes=lanes)
            torch.cuda.synchronize()
            check(torch.equal(y, y_ref), f"chacha20 kernel (lanes={lanes}) != plain at {label}")
            res[f"kernel_ms_lanes{lanes}"] = kernel_device_ms(
                lambda: ck.chacha20_xor_packed_cuda(*args, lanes=lanes), 20)
            # the round id read from device memory: the by-value round's bits
            for rnd in (0, 1, 2**31, 2**32 - 1):
                xored = np.asarray(nonce, np.uint64).astype(np.uint32)
                xored[1] ^= np.uint32(rnd)
                rd = u32([rnd], dev)
                got = ck.chacha20_xor_packed_cuda(x, table, key, nonce, args[4], nid, crow,
                                                  round_dev=rd, lanes=lanes)
                want = ck.chacha20_xor_packed_cuda(x, table, key, xored, args[4], nid, crow,
                                                   lanes=lanes)
                check(torch.equal(got, want) and (rnd or torch.equal(got, y)),
                      f"chacha20 round_dev (lanes={lanes}, round {rnd}) != by value at {label}")
            res[f"kernel_ms_round_dev_lanes{lanes}"] = kernel_device_ms(
                lambda: ck.chacha20_xor_packed_cuda(*args, round_dev=rd, lanes=lanes), 20)
        n_blocks = rows * blocks
        nbytes = 2 * x.numel() * 4 + table.words.numel() * 4 + 2 * rows * 4
        lanes = ck.lanes_for(rows * blocks, x.device)
        res.update({
            "lanes": lanes,
            "kernel_ms": res[f"kernel_ms_lanes{lanes}"],
            "kernel_ms_round_dev": res[f"kernel_ms_round_dev_lanes{lanes}"],
            # the same bytes through a plain elementwise XOR: what moving them costs
            "xor_copy_ms": kernel_device_ms(lambda: torch.bitwise_xor(x, 5), 20),
            "call_ms": cuda_ms(lambda: ck.chacha20_xor_packed_cuda(*args), reps),
            "plain_ms": cuda_ms(lambda: cr.chacha20_xor_packed_ref(*args),
                                3 if blocks < 1000 else 1, 1),
            "bound_ms": 1e3 * max(nbytes / PEAK_BYTES_S,
                                  n_blocks * CHACHA_OPS_PER_BLOCK / PEAK_I32_S),
            "bound_by": "operations" if n_blocks * CHACHA_OPS_PER_BLOCK / PEAK_I32_S
            > nbytes / PEAK_BYTES_S else "bytes",
        })
        out[label] = res

    # the main path's packed wire (one k-means round's send buffers), card ==
    # CPU plain version through the shuffle's own crypt: the send side's
    # placed store (each row at its receiver's row) and the receive side's
    # unplaced one
    from repro_torch.core import shuffle
    tree = _round_tree(np.random.default_rng(2))
    got = {}
    for d in (dev, torch.device("cpu")):
        t = {"k": tree["k"].to(d), "v": {n: v.to(d) for n, v in tree["v"].items()}}
        wire, layout, _ = shuffle._pack_wire_coalesced(t, lead=2)
        ids = shuffle._exchange_ids(SHARDS, SHARDS, d)
        for place in (SHARDS, 0):
            got[d.type, place] = shuffle._crypt_wire_coalesced(
                wire.reshape(SHARDS * SHARDS, -1), layout, _secure_cfg(), ids[0], ids[1],
                2**32 - 1, place_rows=place).cpu()
    for place in (SHARDS, 0):
        check(torch.equal(got["cuda", place], got["cpu", place]),
              f"main-path packed wire (place_rows {place}): card != plain")
    check(torch.equal(got["cpu", SHARDS].reshape(SHARDS, SHARDS, -1),
                      got["cpu", 0].reshape(SHARDS, SHARDS, -1).transpose(0, 1)),
          "main-path packed wire: the placed store is not the receivers' order")
    out["main_wire"] = {"rows": SHARDS * SHARDS, "words": got["cpu", 0].shape[1],
                        "blocks": layout.total_blocks, "bit_exact": True,
                        "placed_bit_exact": True}
    out["moe_leg_placed"] = chacha_placed(dev)
    emit({"phase": "chacha20", "rfc8439": True, **out})
    return out


def chacha_placed(dev, reps: int = 5, turns: int = 3) -> dict:
    """The exchange's send-side crypt with the placed store (each row at the
    row its receiver reads, `place_rows`) against the unplaced one, at
    granite-moe's leg wire (one MoE layer's send buffers at 8 x 4,096 tokens
    on 8 shards: 8 x 8 rows of 246,720 blocks, 1.01 GB bf16 of seeded random
    bits, packed as a view). The placed output equals the plain version
    (`chacha20_xor_packed_ref`, run on the card one sender shard at a time)
    in the receivers' row order, bit for bit; device ms per launch of each
    store (`kernel_device_ms`, `turns` times in alternation) and their ratio
    of medians."""
    from repro_torch.configs import get_config
    from repro_torch.core import shuffle
    from repro_torch.kernels.chacha20 import ref as cr
    from repro_torch.models.moe import _capacity, padded_experts

    cfg = get_config(LM_ARCH)
    e_pad = padded_experts(cfg, LM_SHARDS)
    cap = _capacity(cfg, LM_BATCH * LM_PROMPT // LM_SHARDS, e_pad)
    g = torch.Generator(device=dev).manual_seed(19)
    send = torch.randint(-2**15, 2**15, (LM_SHARDS, LM_SHARDS, e_pad // LM_SHARDS * cap,
                                         cfg.d_model),
                         dtype=torch.int16, device=dev, generator=g).view(torch.bfloat16)
    wire, layout, _ = shuffle._pack_wire_coalesced({"x": send}, lead=2)
    check(wire.data_ptr() == send.data_ptr(), "chacha placed: the one-leaf wire was copied")
    s, r, w_ = wire.shape
    flat = wire.reshape(s * r, w_)
    ids = shuffle._exchange_ids(s, r, dev)
    cfg_ = _secure_cfg()

    def crypt(place_rows):
        return shuffle._crypt_wire_coalesced(flat, layout, cfg_, ids[0], ids[1], 0,
                                             place_rows=place_rows)

    placed = crypt(r).reshape(r, s, w_)
    table = shuffle._layout_table(layout, dev)
    nonce, _ = shuffle._round_key(cfg_, 0)
    for sh in range(s):
        rows = slice(sh * r, (sh + 1) * r)
        want = cr.chacha20_xor_packed_ref(flat[rows], table, cfg_.key_words, nonce,
                                          cfg_.counter0, ids[0][rows], ids[1][rows])
        check(torch.equal(placed[:, sh], want),
              f"chacha placed: sender shard {sh}'s rows != plain in receiver order")
        del want
    del placed
    torch.cuda.empty_cache()
    ms = {"unplaced": [], "placed": []}
    for _ in range(turns):
        ms["unplaced"].append(kernel_device_ms(lambda: crypt(0), reps))
        ms["placed"].append(kernel_device_ms(lambda: crypt(r), reps))
    del send, wire, flat
    torch.cuda.empty_cache()
    med = {k: statistics.median(v) for k, v in ms.items()}
    return {"rows": s * r, "blocks": layout.total_blocks,
            "wire_bytes": s * r * layout.payload_words * 4, "bit_exact": True,
            "kernel_ms_unplaced": ms["unplaced"], "kernel_ms_placed": ms["placed"],
            "placed_over_unplaced": med["placed"] / med["unplaced"]}


def kernel_device_ms(fn, reps: int) -> float:
    """Mean device ms per call of `fn`, a call that runs the timed kernel
    and nothing else on the card: `reps` warm calls captured in one CUDA
    graph, three replays timed by CUDA events, so the host's launch gaps
    drop out. Not by torch.profiler: on the card it now and then loses a
    whole session's records."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    ms = cuda_ms(graph.replay, 3, 1) / reps
    del graph
    return ms


def moe_launches(mk, before=None) -> dict:
    """The MoE kernels' launch counts, or their growth since `before`."""
    now = {"moe_dispatch": mk.dispatch_launches, "moe_combine": mk.combine_launches}
    return now if before is None else {name: now[name] - before[name] for name in now}


# attention: the prefill kernel at granite-moe's, qwen2-moe's and moonlight's
# per-layer shapes; its (Dqk, Dv) builds: the published models' head sizes,
# the reduced configs', latent attention's
ATTN_BUILDS = ((64, 64), (128, 128), (16, 16), (192, 128))
ATTN_SHAPES = {"granite-moe-3b-a800m": (8, 4096, 24, 8, 64, 64),
               "qwen2-moe-a2.7b": (8, 4096, 16, 16, 128, 128),
               "moonlight-16b-a3b": (4, 8192, 16, 16, 192, 128)}  # B, T, H, Hkv, Dqk, Dv
ATTN_F32_TOL = 2**-16  # the float32 kernel against float64; a 16-bit rounding reads ~2**-9


def attn_exact(q, k, v, dtype=torch.float32):
    """Causal softmax(q k^T / sqrt(Dqk)) v in `dtype`, one batch row at a time."""
    h, dh = q.shape[2], q.shape[3]
    kk = k.to(dtype).repeat_interleave(h // k.shape[2], dim=2)
    vv = v.to(dtype).repeat_interleave(h // k.shape[2], dim=2)
    out = torch.empty(q.shape[:3] + v.shape[3:], dtype=dtype, device=q.device)
    for i in range(q.shape[0]):
        s = torch.einsum("thd,shd->hts", q[i].to(dtype), kk[i]) / dh ** 0.5
        keep = torch.ones(s.shape[1:], dtype=torch.bool, device=q.device).tril()
        out[i] = torch.einsum("hts,shd->thd", s.masked_fill(~keep, float("-inf")).softmax(-1),
                              vv[i])
        del s, keep
    return out


def attn_heads(cfg):
    """(H, Hkv, Dqk, Dv) of a config's self-attention."""
    if cfg.attention == "mla":
        return (cfg.n_heads, cfg.n_heads, cfg.qk_nope_head_dim + cfg.qk_rope_head_dim,
                cfg.v_head_dim)
    return cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.head_dim


def attn_plain(cfg, q, k, v):
    """The plain path of a prefill's attention: the model's `attend`, query
    chunks of `cfg.attn_chunk`."""
    from repro_torch.models.attention import attend

    pos = torch.arange(q.shape[1], device=q.device)[None].expand(q.shape[0], -1)
    return attend(cfg, q, k, v, pos, pos, None, True)


def _rel_err(x, want) -> float:
    return float((x.to(want.dtype) - want).norm() / want.norm())


def phase_attention(dev):
    """The prefill attention kernel against its bound, the plain path and a
    library call (a yardstick the port never calls) at the main path's
    per-layer shapes; its error and the plain path's against float32 over
    the whole batch. Its float32 specialisation (float32 models on the
    card) at granite's shape, one prompt, against float64 and the plain
    path's float32 matmuls."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.attention import kernel as ak

    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {"phase": "attention"}
    for arch, (b, t, h, hkv, dh, dv) in ATTN_SHAPES.items():
        cfg = get_config(arch)
        check(attn_heads(cfg) == (h, hkv, dh, dv),
              f"attention: {arch}'s heads are not {h}, {hkv}, {dh}, {dv}")
        g = torch.Generator(device=dev).manual_seed(dh)
        q, k, v = (torch.randn((b, t, n, w), generator=g, device=dev).to(torch.bfloat16)
                   for n, w in ((h, dh), (hkv, dh), (hkv, dv)))
        got = ak.attention_prefill_cuda(q, k, v)
        check(torch.equal(got, ak.attention_prefill_cuda(q, k, v)),
              f"attention: two runs differ at {arch}'s shape")
        want = attn_exact(q, k, v)
        err = {"kernel": _rel_err(got, want), "plain": _rel_err(attn_plain(cfg, q, k, v), want)}
        check(err["kernel"] <= err["plain"], f"attention: kernel error {err} at {arch}'s shape")
        del got, want
        flops = 2 * b * h * t * t * (dh + dv) / 2
        ms = kernel_device_ms(lambda: ak.attention_prefill_cuda(q, k, v), 10)
        plain_ms = cuda_ms(lambda: attn_plain(cfg, q, k, v), 3, 1)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        try:  # None where no backend of this PyTorch takes the widths
            library_ms = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True), 10)
        except RuntimeError:
            library_ms = None
        out[arch] = {"shape": {"B": b, "T": t, "H": h, "Hkv": hkv, "Dh": dh, "Dv": dv},
                     "ms": ms, "bound_ms": 1e3 * flops / PEAK_BF16_S, "bound_by": "operations",
                     "pct_of_peak": 100 * flops / PEAK_BF16_S / (ms / 1e3),
                     "plain_ms": plain_ms, "plain_attn_chunk": cfg.attn_chunk,
                     "library_ms": library_ms,
                     "library": "scaled_dot_product_attention(is_causal, enable_gqa) on "
                                "(B, H, T, Dh) copies; a yardstick, never called by the port",
                     "rel_err_vs_f32": err, "rel_err_rows": b}
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()

    arch = "granite-moe-3b-a800m"  # float32, one prompt
    cfg = get_config(arch)
    _, t, h, hkv, dh, _ = ATTN_SHAPES[arch]
    g = torch.Generator(device=dev).manual_seed(dh + 1)
    q, k, v = (torch.randn((1, t, n, dh), generator=g, device=dev) for n in (h, hkv, hkv))
    got = ak.attention_prefill_cuda(q, k, v)
    check(got.dtype == torch.float32 and torch.equal(got, ak.attention_prefill_cuda(q, k, v)),
          "attention: float32 runs differ")
    want = attn_exact(q, k, v, torch.float64)
    err = {"kernel": _rel_err(got, want), "plain": _rel_err(attn_plain(cfg, q, k, v), want)}
    check(err["kernel"] <= ATTN_F32_TOL, f"attention: float32 kernel error {err}")
    del got, want
    out["float32"] = {"arch": arch, "shape": {"B": 1, "T": t, "H": h, "Hkv": hkv, "Dh": dh},
                      "ms": kernel_device_ms(lambda: ak.attention_prefill_cuda(q, k, v), 3),
                      "plain_ms": cuda_ms(lambda: attn_plain(cfg, q, k, v), 3, 1),
                      "rel_err_vs_f64": err, "tolerance": ATTN_F32_TOL}
    del q, k, v
    torch.cuda.empty_cache()
    emit(out)
    return out


# moe: the prefill's dispatch and combine kernels at granite-moe's and
# qwen2-moe's per-layer shapes (8 shards, a batch of 8 x 4,096 prompt tokens)
MOE_ARCHS = ("granite-moe-3b-a800m", "qwen2-moe-a2.7b")


def phase_moe(dev):
    """The MoE prefill's two row movers against their bytes bounds, their
    plain versions and the gradient path's code they replace in a prefill
    (the k-fold copy through `bucket_pack`; `_combine` over the received
    buffer with its zero row), at each model's per-layer shape, bf16, on a
    uniform random top-k routing at the published capacity; each kernel ==
    its plain version bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.core.shuffle import bucket_pack
    from repro_torch.kernels.moe import kernel as mk
    from repro_torch.kernels.moe.ref import moe_combine_ref, moe_dispatch_ref
    from repro_torch.models import moe as moe_mod

    out = {"phase": "moe"}
    for arch in MOE_ARCHS:
        cfg = get_config(arch)
        r, k, d = LM_SHARDS, cfg.n_experts_per_tok, cfg.d_model
        n = LM_BATCH * LM_PROMPT // r
        e_pad = moe_mod.padded_experts(cfg, r)
        cap = moe_mod._capacity(cfg, n, e_pad)
        g = torch.Generator(device=dev).manual_seed(29)
        eidx = torch.rand((r, n, cfg.n_experts), generator=g, device=dev).argsort(-1)[..., :k]
        eidx = eidx.to(torch.int32)
        gates = torch.rand((r, n, k), generator=g, device=dev).to(torch.bfloat16)
        x2 = torch.randn((r, n, d), generator=g, device=dev).to(torch.bfloat16)
        keys = moe_mod._entry_keys(n, k, dev).expand(r, -1)
        slots, _, dropped, pos = bucket_pack(keys, eidx.reshape(r, -1), {}, e_pad, cap,
                                             return_positions=True)
        slots = slots.reshape(r, -1)
        size, row = x2.element_size(), d * x2.element_size()

        def old_dispatch():
            return bucket_pack(keys, eidx.reshape(r, -1), {"x": moe_mod._entry_values(x2, k)},
                               e_pad, cap, return_positions=True)

        send = mk.moe_dispatch_cuda(x2, slots, k)
        check(torch.equal(send.view(torch.int16), moe_dispatch_ref(x2, slots, k).view(
            torch.int16)), f"moe: the dispatch kernel != its plain version at {arch}'s shape")
        d_bytes = send.numel() * size + x2.numel() * size + slots.numel() * 4
        d_ms = kernel_device_ms(lambda: mk.moe_dispatch_cuda(x2, slots, k), 5)
        d_plain = cuda_ms(lambda: moe_dispatch_ref(x2, slots, k), 3, 1)
        d_old = cuda_ms(old_dispatch, 3, 1)
        del send
        torch.cuda.empty_cache()

        got = torch.randn((r, e_pad * cap, d), generator=g, device=dev).to(torch.bfloat16)
        y = mk.moe_combine_cuda(got, pos, gates, LM_BATCH)
        check(torch.equal(y.view(torch.int16), moe_combine_ref(got, pos, gates, LM_BATCH).view(
            torch.int16)), f"moe: the combine kernel != its plain version at {arch}'s shape")
        kept = r * n * k - int(dropped.sum())
        c_bytes = (kept + r * n) * row + pos.numel() * 4 + gates.numel() * size
        c_ms = kernel_device_ms(lambda: mk.moe_combine_cuda(got, pos, gates, LM_BATCH), 5)
        c_plain = cuda_ms(lambda: moe_combine_ref(got, pos, gates, LM_BATCH), 3, 1)
        c_old = cuda_ms(lambda: moe_mod._combine(moe_mod._with_zero_row(got), pos, gates, n)
                        .reshape(r, LM_BATCH, n // LM_BATCH, d).transpose(0, 1)
                        .reshape(LM_BATCH, -1, d), 3, 1)
        del y, got
        torch.cuda.empty_cache()
        out[arch] = {
            "shape": {"R": r, "n": n, "k": k, "E_pad": e_pad, "C": cap, "d": d,
                      "dtype": "bfloat16"},
            "dropped_share": int(dropped.sum()) / (r * n * k),
            "dispatch": {"ms": d_ms, "bytes": d_bytes, "bound_ms": 1e3 * d_bytes / PEAK_BYTES_S,
                         "bound_by": "bytes",
                         "pct_of_bound": 100 * d_bytes / PEAK_BYTES_S / (d_ms / 1e3),
                         "plain_ms": d_plain, "replaced_ms": d_old,
                         "replaced": "bucket_pack of the k-fold copy (_entry_values)"},
            "combine": {"ms": c_ms, "bytes": c_bytes, "bound_ms": 1e3 * c_bytes / PEAK_BYTES_S,
                        "bound_by": "bytes",
                        "pct_of_bound": 100 * c_bytes / PEAK_BYTES_S / (c_ms / 1e3),
                        "plain_ms": c_plain, "replaced_ms": c_old,
                        "replaced": "_combine(_with_zero_row(got)) and y's transpose"},
            "bit_exact": True}
        del x2, gates, eidx, slots, pos, keys
        torch.cuda.empty_cache()
    out["launches"] = {"moe_dispatch": mk.dispatch_launches, "moe_combine": mk.combine_launches}
    emit(out)
    return out


def _round_tree(rng, rows: int = SHARDS, n_shards: int = SHARDS):
    """One k-means round's send buffers: keys and per-centre partials, as
    bucket_pack lays them out (S, R, ceil(K / R), ...)."""
    cap = -(-K // rows)
    keys = rng.integers(-1, K, (n_shards, rows, cap)).astype(np.int32)
    return {"k": torch.as_tensor(keys),
            "v": {"c": torch.as_tensor(rng.random((n_shards, rows, cap)).astype(np.float32)),
                  "s": torch.as_tensor(rng.random((n_shards, rows, cap, D)).astype(np.float32))}}


def _kmeans_assign_case(dev, points, centers, plain_points):
    """Check and time the k-means kernel at one shape: sums/counts against
    the plain accumulate fed its assignments (per shard), assignments
    against the plain version outside near-ties, two runs equal bit for bit;
    its time, the time of each kernel inside the call, the plain version's
    time on `plain_points` shards, cuBLAS's distance product, and bounds."""
    from repro_torch.kernels.kmeans import kernel as kk, ref as kr

    s, n, d = points.shape
    k = centers.shape[0]
    weights = torch.ones((s, n), dtype=torch.float32, device=dev)
    a1, s1, c1 = kk.kmeans_assign_cuda(points, centers, weights)
    a2, s2, c2 = kk.kmeans_assign_cuda(points, centers, weights)
    torch.cuda.synchronize()
    check(torch.equal(a1, a2) and torch.equal(s1, s2) and torch.equal(c1, c2),
          f"kmeans kernel not deterministic at D={d}, K={k}")
    max_err = 0.0
    for sh in range(s):  # per shard: the one-hot of a shard at K=1024 is 4 GiB
        ps, pc = kr.kmeans_accumulate_ref(points[sh], a1[sh], weights[sh], k)
        check(torch.allclose(s1[sh], ps, rtol=1e-5, atol=1e-5),
              f"kmeans sums vs plain accumulate at D={d}, K={k}")
        check(torch.allclose(c1[sh], pc, rtol=1e-6, atol=0.0),
              f"kmeans counts vs plain accumulate at D={d}, K={k}")
        max_err = max(max_err, float((s1[sh] - ps).abs().max()))
        del ps, pc

    # plain assignments, with near-ties: the two smallest plain d2 closer than
    # 1e-5 of the operands' magnitude |x|^2 + |c|^2 (the rounding scale of
    # the expanded distance)
    c2n = torch.sum(centers * centers, dim=1)
    mism = ties = total_mism = 0
    for sh in range(s):
        for i in range(0, n, 1 << 17):
            x = points[sh, i:i + (1 << 17)]
            x2 = torch.sum(x * x, dim=1, keepdim=True)
            d2 = x2 + c2n[None, :] - 2.0 * (x @ centers.T)
            top = torch.topk(d2, 2, dim=1, largest=False)
            best = torch.argmin(d2, dim=1).to(torch.int32)
            scale = x2[:, 0] + c2n[best.long()]
            tie = (top.values[:, 1] - top.values[:, 0]) <= 1e-5 * scale
            diff = best != a1[sh, i:i + (1 << 17)]
            ties += int(tie.sum())
            total_mism += int(diff.sum())
            mism += int((diff & ~tie).sum())
    check(mism == 0, f"{mism} assignments differ from the plain version outside near-ties "
          f"at D={d}, K={k}")
    del a1, s1, c1, a2, s2, c2

    flat = points.reshape(-1, d)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        library_ms = cuda_ms(lambda: torch.matmul(flat, centers.T), 5)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    n_all = s * n
    ops_ = 2 * n_all * k * d + 4 * n_all * k + 4 * n_all * d
    bytes_ = n_all * d * 4 + n_all * 4 + n_all * 4 + k * d * 4 + s * k * (d + 1) * 4
    # on the tensor cores: the three products of the 3xTF32 split
    ops_tc = 3 * 2 * n_all * k * d
    run = lambda: kk.kmeans_assign_cuda(points, centers, weights)  # noqa: E731

    def five_runs():
        for _ in range(5):
            run()
        torch.cuda.synchronize()

    # device time of each kernel inside the one call, by torch.profiler
    _, _, top = _profiled(five_runs)
    kernel_ms = {name: sum(ms for op, ms in top if name in op) / 5 or None
                 for name in ("kmeans_assign_kernel", "kmeans_assign_dchunk_kernel",
                              "kmeans_accumulate_kernel", "kmeans_reduce_kernel")}
    pp, pw = points[:plain_points], weights[:plain_points]
    return {"shards": s, "points_per_shard": n, "d": d, "k": k,
            "near_ties": ties, "mismatches": total_mism, "mismatches_outside_ties": mism,
            "deterministic": True, "max_abs_err": max_err,
            "ms": cuda_ms(run, 10),
            "kernel_ms": kernel_ms,
            "plain_ms": cuda_ms(lambda: kr.kmeans_assign_ref(pp, centers, pw), 2, 1),
            "plain_shards": plain_points,
            "library_ms": library_ms, "library_call": "torch.matmul(points, centers.T) FP32, "
            "allow_tf32=False: the distance product alone",
            "bound_ms": 1e3 * max(ops_ / PEAK_F32_S, bytes_ / PEAK_BYTES_S),
            "bound_by": "operations" if ops_ / PEAK_F32_S > bytes_ / PEAK_BYTES_S else "bytes",
            "bound_tc_ms": 1e3 * max(ops_tc / PEAK_TF32_S, bytes_ / PEAK_BYTES_S),
            "bound_tc_by": "operations" if ops_tc / PEAK_TF32_S > bytes_ / PEAK_BYTES_S
            else "bytes",
            "bound_bytes_ms": 1e3 * bytes_ / PEAK_BYTES_S}


def phase_kmeans_assign(dev, points, centers):
    """The main path's shape, then D=128, K=1024 (past the range the kernel
    took before it walked D in chunks): 2 GiB of seeded points made on the
    card around 1,024 centres, the first 1,024 points as the centres."""
    res = {"phase": "kmeans_assign",
           **_kmeans_assign_case(dev, points, centers, points.shape[0])}
    g = torch.Generator(device=dev).manual_seed(WIDE_SEED)
    s, n = points.shape[:2]
    true_c = 0.1 + 0.8 * torch.rand((WIDE_K, WIDE_D), generator=g, device=dev)
    idx = torch.randint(0, WIDE_K, (s * n,), generator=g, device=dev)
    wide = true_c[idx] + 0.05 * torch.randn((s * n, WIDE_D), generator=g, device=dev)
    del idx
    wide = wide.reshape(s, n, WIDE_D)
    res["d128_k1024"] = _kmeans_assign_case(dev, wide, wide[0, :WIDE_K].contiguous(), 1)
    del wide
    torch.cuda.empty_cache()
    emit(res)
    return res


def _secure_cfg():
    from repro_torch.convert import secure_config
    from repro_torch.crypto import chacha
    return secure_config(chacha.key_to_words(KEY), chacha.nonce_to_words(b"\x09" * 12),
                         counter0=7)


def _device_events(fn):
    """Run fn under torch.profiler; (result, [[name, device ms]] of every
    kernel, copy and fill the card ran, in order)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # a first kernel the counts leave out: the trace has been seen to miss
        # the first launch of a session
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        out = fn()
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and "spin_kernel" not in e.name),
                    key=lambda e: e.time_range.start)
    return out, [[e.name, e.time_range.elapsed_us() / 1e3] for e in events]


def _kernel_sequences(fns) -> list:
    """Each fn's device events (names, in order), all in one profiler
    session, told apart by spin-kernel markers: before each fn and after the
    last. The profiler has been seen to lose the first kernel launched after
    a synchronise, so a sacrificial spin kernel goes first after each one;
    empty segments (both spins recorded) are skipped."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        for fn in list(fns) + [None]:
            torch.cuda._sleep(1000)  # sacrificial
            torch.cuda._sleep(1000)  # marker
            if fn is not None:
                fn()
            torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    segments, cur = [], None
    for e in events:
        if "spin_kernel" in e.name:
            if cur:
                segments.append(tuple(cur))
            cur = []
        elif cur is not None:
            cur.append(e.name)
    spins = sum("spin_kernel" in e.name for e in events)
    check(len(segments) == len(fns), f"profiler: {len(segments)} marked segments, not "
          f"{len(fns)} ({spins} of {2 * len(fns) + 2} spin kernels recorded)")
    return segments


def _count_syncs(fn):
    """Run fn under torch.cuda.set_sync_debug_mode("warn"); (result, number
    of synchronising calls torch reported)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in got)


def _profiled(fn):
    """Run fn under torch.profiler; (result, device busy ms, top ops by device ms).

    Busy time is the sum of kernel and copy durations on the card; None when
    the profiler saw no device activity (then the idle share is not measured).
    """
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        return out, None, []
    busy_us = sum(e.time_range.elapsed_us() for e in events)
    by_name: dict = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return out, busy_us / 1e3, [[name[:80], us / 1e3] for name, us in top]


def phase_crypt_call(dev, points):
    """The crypt call of the shuffle and a round around it: one device
    operation and no synchronising call per crypt."""
    from repro_torch import VirtualMesh
    from repro_torch.core import driver, shuffle
    from repro_torch.core.kmeans import make_kmeans_iterative_spec, paper_threshold

    cfg = _secure_cfg()
    res = {"phase": "crypt_call"}
    for label, tree in (("wire", _round_tree(np.random.default_rng(5))),
                        ("64MiB", {"x": torch.zeros((SHARDS, SHARDS, 262144), dtype=torch.int32)})):
        tree = {k: (v.to(dev) if torch.is_tensor(v) else {n: x.to(dev) for n, x in v.items()})
                for k, v in tree.items()}
        wire, layout, _ = shuffle._pack_wire_coalesced(tree, lead=2)
        flat = wire.reshape(SHARDS * SHARDS, -1)
        ids = shuffle._exchange_ids(SHARDS, SHARDS, dev)

        def crypt():
            return shuffle._crypt_wire_coalesced(flat, layout, cfg, ids[0], ids[1], 3)

        res[f"kernel_ms_{label}"] = kernel_device_ms(crypt, 20)
        if label != "wire":
            continue
        res["wire_words"] = int(flat.shape[1])
        crypt()
        torch.cuda.synchronize()
        reps = 200
        t0 = time.perf_counter()
        for _ in range(reps):
            crypt()
        torch.cuda.synchronize()
        res["call_ms"] = 1e3 * (time.perf_counter() - t0) / reps
        res["call_reps"] = reps
        _, ops_ = _device_events(lambda: (crypt(), torch.cuda.synchronize()))
        res["device_ops_per_crypt"] = len(ops_)
        res["device_ops_names"] = sorted({op[:60] for op, _ in ops_})
        res["syncs_per_crypt"] = _count_syncs(crypt)[1]
        check(len(ops_) == 1 and "chacha20" in ops_[0][0],
              f"a warm crypt ran {len(ops_)} device operations: {res['device_ops_names']}")
        check(res["syncs_per_crypt"] == 0, f"a warm crypt synchronised "
              f"{res['syncs_per_crypt']} times")
        send_ids, send_rows, recv_ids, recv_rows = shuffle._exchange_ids(SHARDS, SHARDS, dev)
        mesh = VirtualMesh(SHARDS, dev)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:  # the two crypts of one secure round
            ct = shuffle._crypt_wire_coalesced(flat, layout, cfg, send_ids, send_rows, 3)
            moved = mesh.all_to_all(ct.reshape(SHARDS, SHARDS, -1)).reshape(flat.shape)
            back = shuffle._crypt_wire_coalesced(moved, layout, cfg, recv_ids, recv_rows, 3)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        check(torch.equal(back, mesh.all_to_all(wire).reshape(flat.shape)),
              "the round's two crypts do not invert")
        res["round_crypts_under_sync_error_mode"] = True

    # one executed round as the driver runs it (map, shuffle, reduce, then
    # the halt read), secure and plaintext
    mesh = VirtualMesh(SHARDS, dev)
    spec = make_kmeans_iterative_spec(K, mesh, threshold=paper_threshold(points))
    weights = torch.ones((points.shape[0],), dtype=torch.float32, device=dev)
    for name, sec in (("secure", cfg), ("plain", None)):
        ops_, syncs = round_counts(driver, spec, {"p": points, "w": weights},
                                   points[:K].contiguous(), mesh, sec)
        res[f"device_ops_per_{name}_round"] = ops_
        res[f"syncs_per_{name}_round"] = syncs
    emit(res)
    return res


def round_counts(driver, spec, inputs, init_state, mesh, secure):
    """(device operations, synchronising calls) of one warm executed round as
    the driver runs it: map, shuffle, reduce, then the halt read when the
    spec has a halt."""
    inp, state, layout = driver._place(spec, mesh, inputs, init_state)

    def one_round():
        st, aux, _ = driver._round(spec, mesh, inp, state, 0, secure, True, {}, layout,
                                   capacity_factor=2.0)
        if spec.halt_fn is None:
            return None
        return bool(spec.halt_fn(st, aux, 0))

    one_round()
    _, ops_ = _device_events(one_round)
    return len(ops_), _count_syncs(one_round)[1]


def phase_kmeans_fit(dev, points):
    from repro_torch import VirtualMesh
    from repro_torch.core.kmeans import kmeans_fit
    from repro_torch.core.shuffle import record_wire_bytes
    from repro_torch.kernels.chacha20 import kernel as ck
    from repro_torch.kernels.kmeans import kernel as kk

    mesh = VirtualMesh(SHARDS, dev)
    torch.cuda.synchronize()
    ck.launches = 0
    kk.launches = 0
    t0 = time.perf_counter()
    with record_wire_bytes() as recs:
        sec = kmeans_fit(points, K, mesh, secure=_secure_cfg(), init="first",
                         max_iter=MAX_ITER, rounds_per_dispatch=ROUNDS_PER_DISPATCH)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {"chacha20": ck.launches, "kmeans_assign": kk.launches}

    rounds = sec.n_iter
    check(sec.halted, "secure fit did not halt")
    check(launches["kmeans_assign"] == rounds,
          f"kmeans kernel launches {launches['kmeans_assign']} != rounds {rounds}")
    check(launches["chacha20"] == 2 * rounds,
          f"chacha20 kernel launches {launches['chacha20']} != 2 x rounds {rounds}")
    check(len(recs) == rounds and all(r["keystream_launches"] == 2 for r in recs),
          "one secure shuffle with 2 keystream launches per round")
    check(bool(torch.isfinite(sec.centers).all()) and tuple(sec.centers.shape) == (K, D),
          "centres finite, (K, D)")

    def fit(secure):
        t = time.perf_counter()
        out = kmeans_fit(points, K, mesh, secure=secure, init="first", max_iter=MAX_ITER,
                         rounds_per_dispatch=ROUNDS_PER_DISPATCH)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    # warm runs in turns: plain, secure, secure, plain
    plain, plain_s1 = fit(None)
    _, sec_s1 = fit(_secure_cfg())
    prof, busy_ms, top = _profiled(lambda: fit(_secure_cfg()))
    sec_s2 = prof[1]
    _, plain_s2 = fit(None)
    check(torch.equal(sec.centers, plain.centers), "secure centres != plaintext centres")
    check(sec.center_shift == plain.center_shift, "secure shifts != plaintext shifts")
    check(torch.equal(prof[0].centers, sec.centers), "secure fit not repeatable")
    warm_sec = min(sec_s1, sec_s2)
    warm_plain = min(plain_s1, plain_s2)
    graph = graph_fit(dev, points, mesh, sec)
    res = {"phase": "kmeans_fit", "n": N_POINTS, "k": K, "d": D, "shards": SHARDS,
           "n_iter": sec.n_iter, "rounds_executed": rounds,
           "rounds_dispatched": sec.n_rounds_dispatched, "n_dispatches": sec.n_dispatches,
           "halted": sec.halted, "first_fit_s": fit_s,
           "fit_s": warm_sec, "ms_per_round": 1e3 * warm_sec / rounds,
           "plain_fit_s": warm_plain, "plain_ms_per_round": 1e3 * warm_plain / plain.n_iter,
           "fit_s_runs": {"plain": [plain_s1, plain_s2], "secure": [sec_s1, sec_s2]},
           "profiled_fit_s": sec_s2,
           "device_busy_ms": busy_ms,
           "device_idle_share": None if busy_ms is None else 1 - busy_ms / (1e3 * sec_s2),
           "top_device_ops": top,
           "wire_bytes_per_round_per_shard": recs[0]["wire_bytes"],
           "wire_bytes_per_round": recs[0]["wire_bytes"] * SHARDS,
           "keystream_blocks_per_round_per_shard": recs[0]["keystream_blocks"],
           "inertia": sec.inertia, "last_shifts": sec.center_shift[-3:],
           "launches": launches, "secure_equals_plain": True, "graph": graph}
    emit(res)
    return res


def graph_fit(dev, points, mesh, eager):
    """The same secure fit through `make_kmeans_runner(...)`: CUDA graphs of
    one round, captured by the first (cold) fit; warm fits in turns with the
    eager fit's figures beside them, one profiled. Equal to the eager fit bit
    for bit."""
    from repro_torch.core.kmeans import kmeans_fit, make_kmeans_runner, paper_threshold

    runner = make_kmeans_runner(mesh, K, secure=_secure_cfg(), threshold=paper_threshold(points),
                                rounds_per_dispatch=ROUNDS_PER_DISPATCH)

    def fit():
        return kmeans_fit(points, K, mesh, runner=runner, max_iter=MAX_ITER)

    cold, cold_s = timed(fit)
    check(torch.equal(cold.centers, eager.centers) and cold.n_iter == eager.n_iter
          and cold.center_shift == eager.center_shift, "graph-runner fit != eager fit")
    _, g1 = timed(fit)
    prof, busy_ms, top = _profiled(lambda: timed(fit))
    g2 = prof[1]
    check(torch.equal(prof[0].centers, eager.centers), "graph-runner fit not repeatable")
    (_, syncs) = _count_syncs(fit)
    return {"first_fit_s": cold_s, "fit_s": min(g1, g2), "fit_s_runs": [g1, g2],
            "ms_per_round": 1e3 * min(g1, g2) / cold.n_iter, "n_iter": cold.n_iter,
            "rounds_dispatched": cold.n_rounds_dispatched, "n_dispatches": cold.n_dispatches,
            "device_busy_ms": busy_ms,
            "device_idle_share": None if busy_ms is None else 1 - busy_ms / (1e3 * g2),
            "top_device_ops": top, "syncs_per_fit": syncs,
            "chunk_sizes": sorted(runner.runners.keys()),
            "captures": runner.runners.captures(),
            "pool_bytes": runner.runners.pool_bytes(), "equals_eager": True}


def phase_parity_small(dev):
    from repro_torch import VirtualMesh
    from repro_torch.core import shuffle
    from repro_torch.core.kmeans import generate_points, kmeans_fit

    pts, _ = generate_points(4096, 8, d=4, seed=3)
    fits = {}
    for name in ("cuda", "cpu"):
        fits[name] = kmeans_fit(pts, 8, VirtualMesh(SHARDS, name), secure=_secure_cfg(),
                                max_iter=MAX_ITER, rounds_per_dispatch=ROUNDS_PER_DISPATCH)
    g, c = fits["cuda"], fits["cpu"]
    check(g.n_iter == c.n_iter and g.n_rounds_dispatched == c.n_rounds_dispatched,
          "card and CPU differ in rounds")
    check(np.allclose(g.centers.cpu().numpy(), c.centers.numpy(), rtol=1e-5, atol=1e-5),
          "card and CPU centres differ")

    rng = np.random.default_rng(4)
    cap = 1
    tree = {"k": rng.integers(-1, 8, (SHARDS, SHARDS, cap)).astype(np.int32),
            "v": {"c": rng.random((SHARDS, SHARDS, cap)).astype(np.float32),
                  "s": rng.normal(size=(SHARDS, SHARDS, cap, 4)).astype(np.float32)}}
    wires = {}
    for name in ("cuda", "cpu"):
        t = {"k": torch.as_tensor(tree["k"], device=name),
             "v": {kk: torch.as_tensor(v, device=name) for kk, v in tree["v"].items()}}
        wire, layout, _ = shuffle._pack_wire_coalesced(t, lead=2)
        w = wire.reshape(SHARDS * SHARDS, -1)
        shard = torch.arange(SHARDS, device=name).repeat_interleave(SHARDS)
        dest = torch.arange(SHARDS, device=name).repeat(SHARDS)
        wires[name] = shuffle._crypt_wire_coalesced(w, layout, _secure_cfg(), shard, dest,
                                                    round_id=0).cpu()
    check(torch.equal(wires["cuda"], wires["cpu"]), "fixed wire ciphertext differs")
    res = {"phase": "parity_small", "n_iter": g.n_iter, "rounds_dispatched": g.n_rounds_dispatched,
           "max_centre_diff": float(np.abs(g.centers.cpu().numpy() - c.centers.numpy()).max()),
           "wire_words": int(wires["cpu"].numel()), "wire_bit_exact": True}
    emit(res)
    return res


def wire_crypt(dev, tree, reps: int, round_id: int):
    """The ChaCha20 kernel at a workload's round wire (the send buffers of one
    round, (S, R, C) leaves): the shuffle's crypt on the card against the
    plain version on the same wire, table, ids and round, bit for bit (row
    groups of at most 2**20 blocks, so the plain version's temporaries stay
    small); then device ms per launch (`kernel_device_ms`), the lanes chosen,
    and the bytes bound (wire words read and written once, plus the block
    table and ids, over 3.35 TB/s)."""
    from repro_torch.core import shuffle
    from repro_torch.kernels.chacha20 import kernel as ck, ref as cr

    wire, layout, _ = shuffle._pack_wire_coalesced(tree, lead=2)
    s, r = wire.shape[:2]
    flat = wire.reshape(s * r, -1)
    ids = shuffle._exchange_ids(s, r, dev)
    cfg = _secure_cfg()
    table = shuffle._layout_table(layout, dev)
    nonce = shuffle._round_nonce(cfg, round_id)
    got = shuffle._crypt_wire_coalesced(flat, layout, cfg, ids[0], ids[1], round_id)
    step = max(1, (1 << 20) // layout.total_blocks)
    for i in range(0, s * r, step):
        want = cr.chacha20_xor_packed_ref(flat[i:i + step], table, cfg.key_words, nonce,
                                          cfg.counter0, ids[0][i:i + step], ids[1][i:i + step])
        check(torch.equal(got[i:i + step], want),
              f"chacha20 kernel != plain on the {s}x{r}x{layout.total_blocks}-block wire, "
              f"rows {i}..{min(i + step, s * r)}")
        del want
    del got
    blocks = s * r * layout.total_blocks
    nbytes = 2 * flat.numel() * 4 + layout.total_blocks * 16 + 2 * s * r * 4
    ops_ = blocks * CHACHA_OPS_PER_BLOCK
    ms = kernel_device_ms(lambda: shuffle._crypt_wire_coalesced(flat, layout, cfg, ids[0],
                                                                ids[1], round_id),
                          reps)
    del wire, flat
    return {"wire_bytes": s * r * layout.payload_words * 4, "blocks": blocks,
            "leaves": len(layout.leaves), "round_id": round_id, "bit_exact": True,
            "lanes": ck.lanes_for(blocks, dev), "kernel_ms": ms,
            "bound_ms": 1e3 * max(nbytes / PEAK_BYTES_S, ops_ / PEAK_I32_S),
            "bound_by": "operations" if ops_ / PEAK_I32_S > nbytes / PEAK_BYTES_S else "bytes"}


def _send_tree(dev, cap: int, seed: int, values=("v",)):
    """Send buffers of one round filled with seeded random bits: an int32 key
    leaf and f32 value leaves, each (S, R, cap)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (SHARDS, SHARDS, cap)

    def bits():
        return torch.randint(-2**31, 2**31, shape, dtype=torch.int32, device=dev, generator=g)

    return {"k": bits(), "v": {n: bits().view(torch.float32) for n in values}}


def timed(fn):
    """(result, host seconds) of fn, ending in a synchronise."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def phase_sort(dev):
    """Secure sampling sort of 2**24 lognormal f32 values on 8 virtual shards."""
    from repro_torch import VirtualMesh
    from repro_torch.core import driver
    from repro_torch.core.shuffle import record_wire_bytes
    from repro_torch.core.sort import initial_edges, make_sample_sort_spec, sample_sort
    from repro_torch.kernels.chacha20 import kernel as ck

    n = SORT_N
    check(n <= 2**24, "f32 counts are exact only up to 2**24 records")
    values_np = np.random.default_rng(SORT_SEED).lognormal(0.0, 1.0, n).astype(np.float32)
    values = torch.from_numpy(values_np).to(dev)
    mesh = VirtualMesh(SHARDS, dev)
    cfg = _secure_cfg()

    def job(secure, shard_state="auto"):
        return sample_sort(values, mesh, secure=secure, n_rounds=SORT_ROUNDS,
                           balance=SORT_BALANCE, shard_state=shard_state)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ck.launches = 0
    with record_wire_bytes() as recs:
        (out, counts, dropped), first_s = timed(lambda: job(cfg))
    launches = ck.launches
    peak = torch.cuda.max_memory_allocated()
    rounds = len(dropped)
    check(launches == 2 * rounds, f"sort: {launches} ChaCha launches for {rounds} rounds")
    check(len(recs) == rounds and all(r["keystream_launches"] == 2 for r in recs),
          "sort: one secure shuffle with 2 keystream launches per round")
    expect = np.sort(values_np, kind="stable")
    check(np.array_equal(out.view(np.uint32), expect.view(np.uint32)),
          "sort output != np.sort(values) bit for bit")
    check(float(counts.sum()) == n and int(dropped[-1]) == 0,
          f"sort: counts sum {float(counts.sum())}, last round dropped {int(dropped[-1])}")

    # the same job through run_until, both layouts of the sorted table: the
    # round figures and the halt, and the layouts equal bit for bit
    cap = n // SHARDS
    edges = torch.from_numpy(initial_edges(float(values_np.min()), float(values_np.max()),
                                           SHARDS)).to(dev)
    init = {"edges": edges, "counts": torch.zeros(SHARDS, device=dev),
            "sorted": torch.full((SHARDS, SHARDS * cap), torch.inf, device=dev)}
    specs = {shard: make_sample_sort_spec(mesh, cap, halt_total=n, balance=SORT_BALANCE,
                                          shard_state=shard) for shard in (True, False)}
    runs = {shard: driver.run_until(spec, {"v": values}, init, mesh, secure=cfg,
                                    max_rounds=SORT_ROUNDS, warn_on_overflow=False)
            for shard, spec in specs.items()}
    sh, rep = runs[True], runs[False]
    check(sh.halted and sh.rounds_executed == rounds, "sort: the job did not halt")
    for k in sh.state:
        check(torch.equal(sh.state[k].view(torch.int32), rep.state[k].view(torch.int32)),
              f"sort: sharded and replicated layouts differ in {k}")
    check((sh.rounds_executed, sh.rounds_dispatched) == (rep.rounds_executed,
                                                         rep.rounds_dispatched),
          "sort: layouts differ in rounds")
    loads = [float(c.max()) * SHARDS / n for c in sh.aux["counts"]]
    del runs, rep

    plain, _ = timed(lambda: job(None))
    check(np.array_equal(plain[0].view(np.uint32), out.view(np.uint32)),
          "sort: plaintext output != secure output")
    # warm runs in turns: plain, secure, secure, plain
    _, p1 = timed(lambda: job(None))
    _, s1 = timed(lambda: job(cfg))
    prof, busy_ms, top = _profiled(lambda: timed(lambda: job(cfg)))
    s2 = prof[1]
    _, p2 = timed(lambda: job(None))
    _, rep_s = timed(lambda: job(cfg, "replicated"))

    ops_, syncs = round_counts(driver, specs[True], {"v": values}, init, mesh, cfg)
    check(syncs == 1, f"a sort round synchronised {syncs} times (only the halt read may)")
    crypt = wire_crypt(dev, _send_tree(dev, cap, 11), 10, 5)
    check(crypt["wire_bytes"] == recs[0]["wire_bytes"] * SHARDS, "sort wire size")
    res = {"phase": "sort", "n": n, "shards": SHARDS, "capacity": cap,
           "balance": SORT_BALANCE, "n_rounds": SORT_ROUNDS,
           "rounds_executed": rounds, "rounds_dispatched": sh.rounds_dispatched,
           "n_dispatches": sh.n_dispatches, "halted": sh.halted,
           "max_load_over_fair": loads, "dropped": [int(x) for x in dropped],
           "first_job_s": first_s, "job_ms": 1e3 * min(s1, s2),
           "ms_per_round": 1e3 * min(s1, s2) / rounds,
           "plain_job_ms": 1e3 * min(p1, p2), "plain_ms_per_round": 1e3 * min(p1, p2) / rounds,
           "replicated_job_ms": 1e3 * rep_s,
           "job_s_runs": {"plain": [p1, p2], "secure": [s1, s2]},
           "device_busy_ms": busy_ms,
           "device_idle_share": None if busy_ms is None else 1 - busy_ms / (1e3 * s2),
           "top_device_ops": top,
           "wire_bytes_per_round": recs[0]["wire_bytes"] * SHARDS,
           "chacha": crypt, "launches": {"chacha20": launches},
           "device_ops_per_round": ops_, "syncs_per_round": syncs,
           "peak_memory_bytes": peak, "sorted_equals_numpy": True,
           "layouts_equal": True, "secure_equals_plain": True}
    emit(res)
    return res


def zipf_tokens(n: int, vocab: int, seed: int) -> np.ndarray:
    """n int32 token ids, Zipf (s = 1) over `vocab` ranks: token t has rank t + 1."""
    rng = np.random.default_rng(seed)
    cdf = np.cumsum(1.0 / np.arange(1, vocab + 1))
    cdf /= cdf[-1]
    out = np.empty(n, np.int32)
    step = 1 << 22
    for i in range(0, n, step):
        u = rng.random(min(step, n - i))
        out[i:i + u.size] = np.minimum(np.searchsorted(cdf, u, side="right"), vocab - 1)
    return out


def phase_grep(dev, tokens_np, tokens):
    """Secure streaming grep of 2**26 Zipf tokens for 16 patterns, 16 rounds."""
    from repro_torch import VirtualMesh
    from repro_torch.core import driver
    from repro_torch.core.grep import grep_count, make_grep_spec
    from repro_torch.core.shuffle import record_wire_bytes
    from repro_torch.kernels.chacha20 import kernel as ck

    rng = np.random.default_rng(GREP_SEED)
    patterns = rng.choice(np.arange(63, 4096), GREP_PATTERNS, replace=False).astype(np.int32)
    freq = np.bincount(tokens_np, minlength=VOCAB)
    want = freq[patterns].astype(np.float32)
    check(freq.max() <= 2**24, "f32 counts are exact only up to 2**24")
    mesh = VirtualMesh(SHARDS, dev)
    cfg = _secure_cfg()
    chunk = tokens_np.size // SHARDS // GREP_ROUNDS

    torch.cuda.synchronize()
    ck.launches = 0
    with record_wire_bytes() as recs:
        (hits, round_hits, dropped), first_s = timed(lambda: grep_count(
            tokens, patterns, mesh, secure=cfg, n_rounds=GREP_ROUNDS))
    launches = ck.launches
    check(np.array_equal(hits.cpu().numpy(), want), "grep hits != numpy count")
    check(int(dropped.sum()) == 0, "grep: a round dropped records")
    # the same job through run_until, as grep_count runs it (one dispatch of
    # every round): the round figures as the driver reports them
    init = {"hits": torch.zeros(GREP_PATTERNS, device=dev),
            "cursor": torch.zeros((), dtype=torch.int64, device=dev)}
    full = driver.run_until(make_grep_spec(patterns, chunk, mesh), {"t": tokens}, init, mesh,
                            secure=cfg, max_rounds=GREP_ROUNDS, min_chunk=GREP_ROUNDS)
    rounds = full.rounds_executed
    check(torch.equal(full.state["hits"], hits) and round_hits.shape == (rounds, GREP_PATTERNS),
          "grep_count != its run_until")
    check(rounds == GREP_ROUNDS, f"grep executed {rounds} of {GREP_ROUNDS} rounds")
    check(launches == 2 * rounds, f"grep: {launches} ChaCha launches for {rounds} rounds")
    limit = int(want.sum()) // 2
    spec_lim = make_grep_spec(patterns, chunk, mesh, max_matches=limit)
    lim = driver.run_until(spec_lim, {"t": tokens}, init, mesh, secure=cfg,
                           max_rounds=GREP_ROUNDS)
    executed = lim.rounds_executed
    seen = tokens_np.reshape(SHARDS, GREP_ROUNDS, chunk)[:, :executed]
    want_lim = np.bincount(seen.reshape(-1), minlength=VOCAB)[patterns].astype(np.float32)
    check(lim.halted and executed < GREP_ROUNDS, "grep -m did not halt early")
    check(np.array_equal(lim.state["hits"].cpu().numpy(), want_lim),
          "grep -m hits != numpy count over the executed chunks")
    (h2, rh2, _), _ = timed(lambda: grep_count(tokens, patterns, mesh, secure=cfg,
                                               n_rounds=GREP_ROUNDS, max_matches=limit))
    check(torch.equal(h2, lim.state["hits"]) and rh2.shape[0] == executed,
          "grep_count with max_matches != its run_until")
    (hp, _, _), _ = timed(lambda: grep_count(tokens, patterns, mesh, n_rounds=GREP_ROUNDS))
    check(torch.equal(hp, hits), "grep: plaintext hits != secure hits")

    _, p1 = timed(lambda: grep_count(tokens, patterns, mesh, n_rounds=GREP_ROUNDS))
    _, s1 = timed(lambda: grep_count(tokens, patterns, mesh, secure=cfg, n_rounds=GREP_ROUNDS))
    prof, busy_ms, top = _profiled(lambda: timed(lambda: grep_count(
        tokens, patterns, mesh, secure=cfg, n_rounds=GREP_ROUNDS)))
    s2 = prof[1]
    _, p2 = timed(lambda: grep_count(tokens, patterns, mesh, n_rounds=GREP_ROUNDS))
    _, l1 = timed(lambda: grep_count(tokens, patterns, mesh, secure=cfg, n_rounds=GREP_ROUNDS,
                                     max_matches=limit))

    ops_lim, syncs_lim = round_counts(driver, spec_lim, {"t": tokens}, init, mesh, cfg)
    check(syncs_lim == 1, f"a grep round synchronised {syncs_lim} times (only the halt read may)")
    ops_free, syncs_free = round_counts(driver, make_grep_spec(patterns, chunk, mesh),
                                        {"t": tokens}, init, mesh, cfg)
    crypt = wire_crypt(dev, _send_tree(dev, chunk, 12, ("one",)), 20, 2**32 - 1)
    seg = segment_sum_times(tokens, patterns, chunk)
    check(crypt["wire_bytes"] == recs[0]["wire_bytes"] * SHARDS, "grep wire size")
    res = {"phase": "grep", "n": int(tokens_np.size), "vocab": VOCAB, "shards": SHARDS,
           "patterns": patterns.tolist(), "hits": want.tolist(),
           "max_count": int(freq.max()), "chunk_per_shard": chunk,
           "rounds_executed": rounds, "rounds_dispatched": full.rounds_dispatched,
           "n_dispatches": full.n_dispatches,
           "limited": {"max_matches": limit, "rounds_executed": executed,
                       "rounds_dispatched": lim.rounds_dispatched,
                       "n_dispatches": lim.n_dispatches, "halted": lim.halted,
                       "job_ms": 1e3 * l1, "ms_per_round": 1e3 * l1 / executed},
           "first_job_s": first_s, "job_ms": 1e3 * min(s1, s2),
           "ms_per_round": 1e3 * min(s1, s2) / rounds,
           "plain_job_ms": 1e3 * min(p1, p2),
           "plain_ms_per_round": 1e3 * min(p1, p2) / rounds,
           "job_s_runs": {"plain": [p1, p2], "secure": [s1, s2]},
           "device_busy_ms": busy_ms,
           "device_idle_share": None if busy_ms is None else 1 - busy_ms / (1e3 * s2),
           "top_device_ops": top,
           "wire_bytes_per_round": recs[0]["wire_bytes"] * SHARDS,
           "chacha": crypt, "segment_sum": seg, "launches": {"chacha20": launches},
           "device_ops_per_round": ops_lim, "syncs_per_round": syncs_lim,
           "device_ops_per_round_no_limit": ops_free, "syncs_per_round_no_limit": syncs_free,
           "hits_equal_numpy": True, "secure_equals_plain": True}
    emit(res)
    return res


def segment_sum_times(tokens, patterns, chunk: int):
    """grep's reduce segment sum at one round's receive shape (S, R * chunk):
    the pattern ids of each shard's first R * chunk tokens, -1 where none
    matches (R times the hits of a real receive buffer, whose other slots
    are padding too). The port's design (dropped ids spread over SPILL
    scratch segments) against the reference's (dropped ids sent to segment
    0 with value 0, so their atomics share one address per shard). Equal
    results asserted; ms by CUDA events."""
    from repro_torch.core.grep import SPILL, segment_sum

    dev = tokens.device
    t = tokens.reshape(SHARDS, -1)[:, :SHARDS * chunk]
    pat = torch.as_tensor(patterns, device=dev)
    eq = t[..., None] == pat
    ids = torch.where(eq.any(-1), eq.to(torch.uint8).argmax(-1), -1).to(torch.int32)
    del eq
    ones = torch.ones(ids.shape, device=dev)
    n = pat.numel()
    base = n * torch.arange(SHARDS, device=dev)[:, None]

    def one_address():
        valid = ids >= 0
        out = torch.zeros(SHARDS * n, device=dev)
        out.index_add_(0, (torch.where(valid, ids, 0) + base).reshape(-1),
                       torch.where(valid, ones, 0.0).reshape(-1))
        return out.reshape(SHARDS, n)

    check(torch.equal(segment_sum(ones, ids, n), one_address()),
          "segment_sum designs disagree")
    return {"slots": ids.numel(), "valid_share": float((ids >= 0).float().mean()),
            "spill_segments": SPILL, "spill_ms": cuda_ms(lambda: segment_sum(ones, ids, n), 20),
            "one_address_ms": cuda_ms(one_address, 20)}


def phase_wordcount(dev, tokens_np, tokens):
    """Secure word count of the same 2**26 tokens over 65,536 words."""
    from repro_torch import VirtualMesh
    from repro_torch.core.shuffle import record_wire_bytes
    from repro_torch.core.wordcount import wordcount
    from repro_torch.kernels.chacha20 import kernel as ck

    mesh = VirtualMesh(SHARDS, dev)
    cfg = _secure_cfg()
    want = np.bincount(tokens_np, minlength=VOCAB).astype(np.float32)
    check(want.max() <= 2**24, "f32 counts are exact only up to 2**24")
    torch.cuda.synchronize()
    ck.launches = 0
    with record_wire_bytes() as recs:
        (counts, dropped), first_s = timed(lambda: wordcount(tokens, VOCAB, mesh, secure=cfg))
    launches = ck.launches
    check(launches == 2, f"wordcount: {launches} ChaCha launches for its one round")
    check(np.array_equal(counts.cpu().numpy(), want) and int(dropped) == 0,
          "wordcount counts != np.bincount")
    (plain, _), _ = timed(lambda: wordcount(tokens, VOCAB, mesh))
    check(torch.equal(plain, counts), "wordcount: plaintext counts != secure counts")
    _, p1 = timed(lambda: wordcount(tokens, VOCAB, mesh))
    _, s1 = timed(lambda: wordcount(tokens, VOCAB, mesh, secure=cfg))
    prof, busy_ms, top = _profiled(lambda: timed(lambda: wordcount(tokens, VOCAB, mesh,
                                                                   secure=cfg)))
    s2 = prof[1]
    _, p2 = timed(lambda: wordcount(tokens, VOCAB, mesh))
    crypt = wire_crypt(dev, _send_tree(dev, -(-VOCAB // SHARDS), 13), 20, 0)
    check(crypt["wire_bytes"] == recs[0]["wire_bytes"] * SHARDS, "wordcount wire size")
    res = {"phase": "wordcount", "n": int(tokens_np.size), "vocab": VOCAB, "shards": SHARDS,
           "first_job_s": first_s, "job_ms": 1e3 * min(s1, s2), "plain_job_ms": 1e3 * min(p1, p2),
           "job_s_runs": {"plain": [p1, p2], "secure": [s1, s2]},
           "device_busy_ms": busy_ms,
           "device_idle_share": None if busy_ms is None else 1 - busy_ms / (1e3 * s2),
           "top_device_ops": top, "wire_bytes": recs[0]["wire_bytes"] * SHARDS,
           "chacha": crypt, "launches": {"chacha20": launches},
           "counts_equal_numpy": True, "secure_equals_plain": True}
    emit(res)
    return res


ENCLAVE_LINES = [
    "the quick brown fox jumps over the lazy dog",
    "mapreduce inside enclaves keeps the data private",
    "the router only ever sees ciphertext",
] * 5


def _secvm_programs():
    """Two programs of one length: r0 = 2x^2 + 3x + 1 (NOP-padded) and a
    distance sqrt((x-a)^2 + (y-b)^2); x in r1, y in r2."""
    from repro_torch.core import secvm

    poly = secvm.assemble([("LOADC", 2, 0, 0), ("LOADC", 3, 0, 1), ("LOADC", 0, 0, 2),
                           ("MUL", 4, 1, 1), ("FMA", 0, 4, 2), ("FMA", 0, 1, 3),
                           ("NOP", 0, 0, 0)], consts=[2.0, 3.0, 1.0])
    dist = secvm.assemble([("LOADC", 3, 0, 0), ("LOADC", 4, 0, 1), ("SUB", 5, 1, 3),
                           ("SUB", 6, 2, 4), ("MUL", 5, 5, 5), ("FMA", 5, 6, 6),
                           ("SQRT", 0, 5, 0)], consts=[0.5, -1.5, 0.0])
    return poly, dist


def secvm_kernel_sequences() -> dict:
    """The profiler's kernel sequences of the two SecVM programs' warm
    run_encrypted at 2**24 lanes, three calls of each in turns in one
    session; each program's sequence is the one two of its calls agree on.
    Run in a fresh process (`_in_fresh_process`), which starts with no
    profiler session behind it."""
    from repro_torch.core import secvm
    from repro_torch.crypto import chacha

    dev = torch.device("cuda")
    kw, nw = chacha.key_to_words(KEY), chacha.nonce_to_words(b"\x0b" * 12)
    x = np.random.default_rng(5).normal(size=(2, SECVM_LANES)).astype(np.float32)
    xd = torch.from_numpy(x).to(dev)
    calls = []
    for prog in _secvm_programs():
        code_ct, consts_ct = secvm.encrypt_program(prog, kw, nw, 21, device=dev)
        secvm.run_encrypted(code_ct, consts_ct, xd, kw, nw, 21)  # warm
        calls.append(lambda c=code_ct, k=consts_ct: secvm.run_encrypted(c, k, xd, kw, nw, 21))
    seqs = _kernel_sequences(calls * 3)
    out = {"agreed": [], "calls_disagreeing": 0}
    for i in (0, 1):
        mine = seqs[i::2]
        best = max(set(mine), key=mine.count)
        check(mine.count(best) >= 2, "no two calls' kernel sequences agree")
        out["agreed"].append(best)
        out["calls_disagreeing"] += 3 - mine.count(best)
    return out


def _in_fresh_process(fn_name: str) -> dict:
    """Run `fn_name()` of this script in a child process on the same card and
    return its JSON result; the child is waited for."""
    code = (f"import json, sys; sys.path.insert(0, {SRC!r}); sys.path.insert(0, {ROOT!r}); "
            f"import chip_smoke; print(json.dumps(chip_smoke.{fn_name}()))")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600)
    check(p.returncode == 0, f"{fn_name} in a child process failed:\n{p.stderr[-3000:]}")
    return json.loads(p.stdout.strip().splitlines()[-1])


def phase_enclave(dev):
    """The enclave layers on the card: SecVM, the MAC, the cluster runtime.

    SecVM at 2**24 lanes against its oracle (rtol 1e-5), warm run_encrypted
    under set_sync_debug_mode("error"), the profiler's kernel sequence of two
    programs of one length, ms per instruction; SecVM as the map function of
    a secure run_mapreduce on 8 shards (integer-valued, so the float sums are
    exact in any order); mac_tag_words == mac_tag_host at 1,024, 2**20 and
    2**22 words and its time at 2**28 against the bytes bound; the port's
    quickstart (the cluster word count, and the device word count on the
    card); the cluster k-means held to make_kmeans_step on the card (rtol
    1e-4, atol 1e-5). The ChaCha and k-means kernels' launches are counted
    from 0 over the path's own calls (the SecVM map job, the quickstart, the
    cluster k-means), before the check's reference step: ChaCha launches,
    the k-means kernel does not (the cluster k-means runs on the host)."""
    from repro_torch import VirtualMesh
    from repro_torch import quickstart
    from repro_torch.core import secvm
    from repro_torch.core.engine import MapReduceSpec, identity_hash, run_mapreduce
    from repro_torch.core.grep import segment_sum
    from repro_torch.core.kmeans import generate_points, make_kmeans_step
    from repro_torch.crypto import chacha, ctr, mac
    from repro_torch.kernels.chacha20 import kernel as ck
    from repro_torch.kernels.kmeans import kernel as kk
    from repro_torch.runtime.jobs import make_cluster, run_kmeans

    res = {"phase": "enclave"}
    kw, nw = chacha.key_to_words(KEY), chacha.nonce_to_words(b"\x0b" * 12)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, SECVM_LANES)).astype(np.float32)
    xd = torch.from_numpy(x).to(dev)
    progs = _secvm_programs()
    per = {}
    for name, prog in zip(("poly", "dist"), progs):
        code_ct, consts_ct = secvm.encrypt_program(prog, kw, nw, 21, device=dev)
        got = secvm.run_encrypted(code_ct, consts_ct, xd, kw, nw, 21)
        want = secvm.run_oracle(prog, x)
        check(np.allclose(got.cpu().numpy(), want, rtol=1e-5, atol=1e-5, equal_nan=True),
              f"SecVM {name} program differs from its oracle")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            secvm.run_encrypted(code_ct, consts_ct, xd, kw, nw, 21)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        run = lambda: secvm.run_encrypted(code_ct, consts_ct, xd, kw, nw, 21)  # noqa: E731
        # the call, then its two parts: decryption (two ChaCha20 kernel
        # launches) and the interpreter
        blocks = -(-code_ct.numel() // 16)

        def decrypt():
            return (ctr.decrypt_array(code_ct, kw, nw, 21),
                    ctr.decrypt_array(consts_ct, kw, nw, 21 + blocks))

        code, consts = decrypt()
        interp_ms = cuda_ms(lambda: secvm.run_program(code, consts, xd), 3)
        _, busy_ms, _ = _profiled(lambda: (run(), torch.cuda.synchronize()))
        per[name] = {"ms": cuda_ms(run, 3), "decrypt_ms": cuda_ms(decrypt, 3),
                     "interpret_ms": interp_ms, "ms_per_instruction": interp_ms / prog.length,
                     "device_busy_ms": busy_ms,
                     "max_abs_err": float(np.nanmax(np.abs(got.cpu().numpy() - want)))}
    seq = _in_fresh_process("secvm_kernel_sequences")
    kernels = [list(k) for k in seq["agreed"]]
    odd_sessions = seq["calls_disagreeing"]
    for name, k in zip(("poly", "dist"), kernels):
        per[name]["device_ops"] = len(k)
    if kernels[0] != kernels[1]:
        j = next((i for i, (a, b) in enumerate(zip(*kernels)) if a != b), None)
        check(False, "two SecVM programs of one length ran other kernels: "
              f"{len(kernels[0])} and {len(kernels[1])} kernels, first difference at {j}: "
              f"{kernels[0][max(0, j - 2):j + 3] if j is not None else ''} | "
              f"{kernels[1][max(0, j - 2):j + 3] if j is not None else ''}")
    res["secvm"] = {"lanes": SECVM_LANES, "instructions": progs[0].length,
                    "oracle_rtol": 1e-5, "sync_free": True, "identical_kernel_sequence": True,
                    "profiled_calls_disagreeing": odd_sessions, **per}

    # -- the enclave path: its kernels' launches counted from 0 ----------------
    torch.cuda.synchronize()
    ck.launches = kk.launches = 0
    mesh = VirtualMesh(SHARDS, dev)
    n_map = 2**22
    keys = np.arange(n_map, dtype=np.int32) % 64
    vals = rng.integers(0, 10, n_map).astype(np.float32)  # f(x) sums stay exact
    code_ct, consts_ct = secvm.encrypt_program(progs[0], kw, nw, 0, device=dev)

    def map_fn(k, v):
        out = secvm.run_encrypted(code_ct, consts_ct, v.reshape(1, -1), kw, nw, 0)
        return k, out.reshape(v.shape)

    def reduce_fn(k, v, valid):
        return mesh.psum(segment_sum(torch.where(valid, v, 0.0), torch.where(valid, k, -1), 64))

    before = ck.launches
    (out, dropped), map_s = timed(lambda: run_mapreduce(
        MapReduceSpec(map_fn, reduce_fn, hash_fn=identity_hash, capacity=n_map // SHARDS),
        keys, vals, mesh, secure=_secure_cfg()))
    v64 = vals.astype(np.float64)
    want = np.bincount(keys, weights=2 * v64 ** 2 + 3 * v64 + 1, minlength=64)
    check(int(dropped) == 0 and np.array_equal(out.cpu().numpy(), want.astype(np.float32)),
          "SecVM map function in a secure run_mapreduce")
    # the round's two crypts, and the program's decryption (code, consts) in the map
    check(ck.launches - before == 4, "a secure run_mapreduce round with SecVM as its map "
          "is 4 ChaCha launches")
    res["secvm_mapreduce"] = {"shards": SHARDS, "values": n_map, "job_s": map_s,
                              "chacha_launches": ck.launches - before, "exact": True}

    with contextlib.redirect_stdout(io.StringIO()):  # its report, not a phase line
        counts, hist = quickstart.main([])
    words = {}
    for line in ENCLAVE_LINES:
        for w in line.split():
            words[w] = words.get(w, 0) + 1
    check(counts == words and hist.device.type == "cuda", "quickstart word counts")
    pts, _ = generate_points(120, 4, d=2, seed=2)
    cluster, client, _ = make_cluster(7)
    centers, hist_k = run_kmeans(cluster, client, pts, 4, n_mappers=4, n_reducers=2, max_iter=2,
                                 threshold=0.0)
    # the path ends here: the cluster k-means runs on the host and launches no
    # k-means kernel; the check's own make_kmeans_step below is not counted
    torch.cuda.synchronize()
    res["launches"] = {"chacha20": ck.launches, "kmeans_assign": kk.launches}
    check(res["launches"]["chacha20"] > 0 and res["launches"]["kmeans_assign"] == 0,
          f"enclave path: {res['launches']}")
    step = make_kmeans_step(VirtualMesh(1, dev))
    ref = torch.from_numpy(pts[:4]).to(dev)
    for _ in range(len(hist_k)):
        ref, _ = step(torch.from_numpy(pts).to(dev), torch.ones(len(pts), device=dev), ref)
    check(np.allclose(centers, ref.cpu().numpy(), rtol=1e-4, atol=1e-5),
          "cluster k-means differs from make_kmeans_step on the card")
    res["cluster"] = {"wordcount_words": len(counts), "kmeans_iterations": len(hist_k),
                      "kmeans_matches_card_step": True}

    # -- the MAC -------------------------------------------------------------
    rs, ss = mac.mac_keys_from_keystream(kw, nw, 3)
    for n in MAC_WORDS_CHECKED:
        msg = rng.integers(0, 2**32, n, dtype=np.uint32)
        tag = mac.mac_tag_words(torch.from_numpy(msg.view(np.int32)).to(dev), rs, ss)
        check(np.array_equal(tag.cpu().numpy().view(np.uint32), mac.mac_tag_host(msg, rs, ss)),
              f"mac_tag_words on the card != mac_tag_host at {n} words")
    big = torch.randint(-2**31, 2**31, (MAC_WORDS_TIMED,), dtype=torch.int32, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(3))
    t1 = mac.mac_tag_words(big, rs, ss)
    check(torch.equal(t1, mac.mac_tag_words(big, rs, ss)), "mac_tag_words not deterministic")
    mac_bytes = MAC_WORDS_TIMED * 4 + 4 * 4
    res["mac"] = {"checked_words": list(MAC_WORDS_CHECKED), "equals_host": True,
                  "timed_words": MAC_WORDS_TIMED,
                  "ms": cuda_ms(lambda: mac.mac_tag_words(big, rs, ss), 3, 1),
                  "bound_ms": 1e3 * mac_bytes / PEAK_BYTES_S, "bound_by": "bytes"}
    del big
    torch.cuda.empty_cache()
    emit(res)
    return res



# lm_serve: granite-moe-3b-a800m at its published config, experts on 8 shards
LM_ARCH, LM_SHARDS, LM_BATCH, LM_PROMPT, LM_DECODE, LM_SEED = (
    "granite-moe-3b-a800m", 8, 8, 4096, 64, 0)
LM_PEAK_LIMIT = 60e9  # past it the batch is cut to 4
LM_SMALL_SHARDS, LM_SMALL_TOL = 4, 1e-3  # reduced config, card == CPU within rtol/atol
PEAK_BF16_S = 989e12  # H100 SXM bf16 tensor cores, dense


def lm_prefill_flops(cfg, b: int, t: int, n_shards: int) -> dict:
    """Operations of one prefill as the port computes them: every projection
    (q, k, v, o, router), the experts over their capacity-padded slots (and
    a shared expert over every token), the
    full (unmasked) score and context products of the query-chunked
    attention, and the last token's unembedding; 2 per multiply-add."""
    from repro_torch.models.moe import _capacity, padded_experts

    n, d, dh = b * t, cfg.d_model, cfg.head_dim
    e_pad = padded_experts(cfg, n_shards)
    cap = _capacity(cfg, n // n_shards, e_pad)
    proj = 2 * n * d * (2 * cfg.n_heads * dh + 2 * cfg.n_kv_heads * dh + e_pad)
    experts = 2 * 3 * n_shards * e_pad * cap * d * (cfg.moe_d_ff or cfg.d_ff)
    scores = 2 * 2 * b * cfg.n_heads * t * t * dh
    per_layer = {"projections": proj, "experts": experts, "attention": scores}
    if cfg.n_shared_experts:  # the shared expert over every token, and its gate
        per_layer["shared_experts"] = 2 * n * d * (3 * cfg.shared_d_ff + 1)
    out = {k: v * cfg.n_layers for k, v in per_layer.items()}
    out["unembed"] = 2 * b * d * cfg.padded_vocab
    out["total"] = sum(out.values())
    return out


def lm_decode_bytes(model, cfg, b: int, kv_len: int) -> int:
    """Bytes one decode step must move: every weight once (the replicated
    dispatch runs every expert; the embedding table is read by the
    unembedding), the K/V of the kv_len positions it attends, the new K/V
    written, the float32 logits written."""
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    kv_row = cfg.n_layers * b * cfg.n_kv_heads * cfg.head_dim * 2 * 2  # k and v, bf16
    return weights + kv_row * (kv_len + 1) + b * cfg.padded_vocab * 4


def lm_small_on_card_and_cpu(dev):
    """Reduced granite-moe on 4 virtual shards, secure: one seeded model and
    prompt, prefill and two decode steps on the card and on the CPU (plain
    versions); the largest difference of each logits set."""
    from repro_torch import VirtualMesh
    from repro_torch.configs import get_config
    from repro_torch.kernels.attention import kernel as ak
    from repro_torch.models.lm import LM, init_params
    from repro_torch.serve.engine import decode_step, init_cache, prefill

    cfg = get_config(LM_ARCH).reduced()
    cpu_model = init_params(cfg, torch.Generator().manual_seed(3), LM_SMALL_SHARDS, "cpu")
    card_model = LM(cfg, LM_SMALL_SHARDS, dev)
    card_model.load_state_dict(cpu_model.state_dict())
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 18)).astype(np.int32))
    outs, attn = {}, {}
    for name, model, device in (("card", card_model, dev), ("cpu", cpu_model, "cpu")):
        mesh = VirtualMesh(LM_SMALL_SHARDS, device)
        cache = init_cache(cfg, 2, 24, device)
        t = toks.to(device)
        before = ak.launches
        got = [prefill(cfg, model, t[:, :16], cache, mesh=mesh, secure_moe=_secure_cfg())]
        attn[name] = ak.launches - before
        for i in (16, 17):
            got.append(decode_step(cfg, model, cache, t[:, i:i + 1], mesh=mesh))
        outs[name] = [g.float().cpu() for g in got]
    check(attn == {"card": cfg.n_layers, "cpu": 0},
          f"lm_serve: {attn} attention launches in the reduced {cfg.dtype} prefills")
    diffs = []
    for a, b in zip(outs["card"], outs["cpu"]):
        check(torch.allclose(a, b, rtol=LM_SMALL_TOL, atol=LM_SMALL_TOL),
              f"lm_serve: card != CPU on the reduced model (max diff {float((a - b).abs().max())})")
        diffs.append(float((a - b).abs().max()))
    return {"arch": cfg.name + " (reduced)", "shards": LM_SMALL_SHARDS, "secure": True,
            "dtype": cfg.dtype, "steps": ["prefill", "decode", "decode"],
            "attention_launches_card_prefill": attn["card"], "max_abs_diff": diffs,
            "tolerance": LM_SMALL_TOL}


def phase_lm_serve(dev):
    """LM serving of granite-moe-3b-a800m at its published config (32 layers,
    d_model 1536, 40 experts top-8, vocab 49155), bf16 compute, weights from
    a seeded generator, the experts on 8 virtual shards: a secure prefill of
    8 x 4096 tokens (query-chunked attention, two chunks of 2048) whose
    expert exchanges are encrypted by the ChaCha20 kernel, plain and secure
    prefills in turns, then 64 sampled decode steps. Asserts: 4 ChaCha
    launches a layer per secure prefill and none in decode, secure logits
    and KV cache == plain bit for bit, every logit finite, the kernel ==
    its plain version bit for bit on this wire, and the reduced model on 4
    shards card == CPU within LM_SMALL_TOL."""
    from repro_torch import VirtualMesh
    from repro_torch.configs import get_config
    from repro_torch.core.shuffle import record_wire_bytes
    from repro_torch.kernels.attention import kernel as ak
    from repro_torch.kernels.chacha20 import kernel as ck
    from repro_torch.kernels.moe import kernel as mk
    from repro_torch.models.lm import init_params
    from repro_torch.models.moe import _capacity, padded_experts
    from repro_torch.serve.engine import decode_step, init_cache, prefill
    from repro_torch.serve_lm import sample

    t_phase = time.perf_counter()
    cfg = get_config(LM_ARCH)
    check((cfg.n_layers, cfg.d_model, cfg.n_experts, cfg.n_experts_per_tok, cfg.vocab_size)
          == (32, 1536, 40, 8, 49155), "lm_serve: not the published granite-moe config")
    mesh = VirtualMesh(LM_SHARDS, dev)
    sec = _secure_cfg()
    torch.cuda.reset_peak_memory_stats()
    (model, init_s) = timed(lambda: init_params(
        cfg, torch.Generator(device=dev).manual_seed(LM_SEED), LM_SHARDS, dev))
    param_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    batch, batch_cut = LM_BATCH, None
    smax = LM_PROMPT + LM_DECODE + 2

    def setup(b):
        g = torch.Generator(device=dev).manual_seed(LM_SEED + 1)
        toks = torch.randint(0, cfg.vocab_size, (b, LM_PROMPT), generator=g, device=dev,
                             dtype=torch.int32)
        return g, toks, init_cache(cfg, b, smax, dev)

    def run_prefill(secure):
        return prefill(cfg, model, prompts, cache, mesh=mesh, secure_moe=secure)

    gen, prompts, cache = setup(batch)
    torch.cuda.synchronize()
    ck.launches = 0
    attn_before = ak.launches
    moe_before = moe_launches(mk)
    with record_wire_bytes() as recs:
        lg_secure, first_s = timed(lambda: run_prefill(sec))
    launches = ck.launches
    attn_launches = ak.launches - attn_before
    moe_prefill = moe_launches(mk, moe_before)
    if torch.cuda.max_memory_allocated() > LM_PEAK_LIMIT:
        batch_cut = {"from": batch, "peak_bytes": torch.cuda.max_memory_allocated()}
        batch = 4
        del cache, prompts, lg_secure
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        gen, prompts, cache = setup(batch)
        ck.launches = 0
        attn_before = ak.launches
        moe_before = moe_launches(mk)
        with record_wire_bytes() as recs:
            lg_secure, first_s = timed(lambda: run_prefill(sec))
        launches = ck.launches
        attn_launches = ak.launches - attn_before
        moe_prefill = moe_launches(mk, moe_before)
    check(moe_prefill == {"moe_dispatch": cfg.n_layers, "moe_combine": cfg.n_layers},
          f"lm_serve: {moe_prefill} MoE kernel launches in a prefill, not {cfg.n_layers} each")
    check(launches == 4 * cfg.n_layers,
          f"lm_serve: {launches} ChaCha launches in a secure prefill, not {4 * cfg.n_layers}")
    check(attn_launches == cfg.n_layers,
          f"lm_serve: {attn_launches} attention launches in a prefill, not {cfg.n_layers}")
    check(len(recs) == 2 * cfg.n_layers and all(r["secure"] for r in recs),
          f"lm_serve: {len(recs)} wire records in a secure prefill")
    kv_secure = cache["k"].clone()
    times = {"plain": [], "secure": []}
    for name in ("plain", "secure", "secure", "plain"):
        lg, s = timed(lambda: run_prefill(sec if name == "secure" else None))
        times[name].append(s)
        check(torch.equal(lg, lg_secure), f"lm_serve: {name} prefill logits != the first "
              "secure prefill's, bit for bit")
    check(torch.equal(cache["k"], kv_secure), "lm_serve: plain KV cache != secure KV cache")
    del kv_secure
    pre_prof, pre_busy_ms, pre_top = _profiled(lambda: timed(lambda: run_prefill(sec)))
    check(torch.equal(pre_prof[0], lg_secure), "lm_serve: profiled prefill logits differ")
    check(bool(torch.isfinite(lg_secure[:, :cfg.vocab_size]).all()),
          "lm_serve: non-finite prefill logits")
    prefill_s = min(times["secure"])

    # 64 sampled decode steps from the prompt's cache
    ck.launches = 0
    attn_before = ak.launches
    moe_before = moe_launches(mk)
    torch.cuda.synchronize()
    finite = torch.ones((), dtype=torch.bool, device=dev)
    lg = lg_secure
    t0 = time.perf_counter()
    for _ in range(LM_DECODE):
        nxt = sample(lg, cfg.vocab_size, 0.8, gen)
        lg = decode_step(cfg, model, cache, nxt, mesh=mesh)
        finite &= torch.isfinite(lg[:, :cfg.vocab_size]).all()
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    check(bool(finite), "lm_serve: non-finite decode logits")
    check(ck.launches == 0, f"lm_serve: {ck.launches} ChaCha launches in decode")
    check(ak.launches == attn_before, "lm_serve: decode launched the attention kernel")
    check(not any(moe_launches(mk, moe_before).values()),
          "lm_serve: decode launched the MoE kernels")
    nxt = sample(lg, cfg.vocab_size, 0.8, gen)
    kv_len = int(cache["pos"][0])
    prof, busy_ms, top = _profiled(lambda: timed(lambda: decode_step(cfg, model, cache, nxt,
                                                                     mesh=mesh)))
    _, events = _device_events(lambda: decode_step(cfg, model, cache, nxt, mesh=mesh))
    peak = torch.cuda.max_memory_allocated()
    flops = lm_prefill_flops(cfg, batch, LM_PROMPT, LM_SHARDS)
    dec_bytes = lm_decode_bytes(model, cfg, batch, kv_len)
    kv_bytes = 2 * cache["k"].numel() * cache["k"].element_size()
    del cache, model, lg, lg_secure
    torch.cuda.empty_cache()

    # the ChaCha kernel on this wire: one leg's send buffers, seeded random bf16 bits
    e_pad = padded_experts(cfg, LM_SHARDS)
    cap = _capacity(cfg, batch * LM_PROMPT // LM_SHARDS, e_pad)
    g = torch.Generator(device=dev).manual_seed(17)
    send = torch.randint(-2**15, 2**15, (LM_SHARDS, LM_SHARDS, e_pad // LM_SHARDS * cap,
                                         cfg.d_model),
                         dtype=torch.int16, device=dev, generator=g).view(torch.bfloat16)
    crypt = wire_crypt(dev, {"x": send}, 5, 0)
    del send
    leg_bytes = recs[0]["wire_bytes"] * LM_SHARDS
    check(crypt["wire_bytes"] == leg_bytes, "lm_serve: the timed wire is not a leg's wire")
    small = lm_small_on_card_and_cpu(dev)
    res = {"phase": "lm_serve", "arch": cfg.name, "config": "full (published)",
           "dtype": cfg.dtype, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "experts": cfg.n_experts, "top_k": cfg.n_experts_per_tok, "shards": LM_SHARDS,
           "batch": batch, "batch_cut": batch_cut, "prompt_tokens": LM_PROMPT,
           "decode_steps": LM_DECODE, "capacity_per_expert": cap,
           "param_bytes": param_bytes, "kv_cache_bytes": kv_bytes, "init_s": init_s,
           "first_secure_prefill_s": first_s,
           "prefill_ms": 1e3 * prefill_s, "plain_prefill_ms": 1e3 * min(times["plain"]),
           "prefill_s_runs": times,
           "prompt_tokens_per_s": batch * LM_PROMPT / prefill_s,
           "secure_over_plain": prefill_s / min(times["plain"]),
           "profiled_prefill_ms": 1e3 * pre_prof[1], "prefill_device_busy_ms": pre_busy_ms,
           "prefill_device_idle_share": None if pre_busy_ms is None
           else 1 - pre_busy_ms / (1e3 * pre_prof[1]),
           "prefill_top_device_ops": pre_top,
           "prefill_flops": flops, "prefill_bound_ms": 1e3 * flops["total"] / PEAK_BF16_S,
           "prefill_bound_by": "operations",
           "decode_ms_per_step": 1e3 * decode_s / LM_DECODE,
           "decode_tokens_per_s": batch * LM_DECODE / decode_s,
           "decode_step_bytes": dec_bytes, "decode_bound_ms": 1e3 * dec_bytes / PEAK_BYTES_S,
           "decode_bound_by": "bytes", "decode_kv_len": kv_len,
           "profiled_decode_step_ms": 1e3 * prof[1], "decode_device_busy_ms": busy_ms,
           "decode_device_idle_share": None if busy_ms is None else 1 - busy_ms / (1e3 * prof[1]),
           "decode_idle_share_of_unprofiled_step": None if busy_ms is None
           else 1 - busy_ms * LM_DECODE / (1e3 * decode_s),
           "decode_device_ops": len(events), "decode_top_device_ops": top,
           "peak_memory_bytes": peak,
           "wire_bytes_per_prefill": sum(r["wire_bytes"] for r in recs) * LM_SHARDS,
           "wire_bytes_per_leg": leg_bytes,
           "chacha_launches_per_prefill": launches, "chacha_launches_per_decode": 0,
           "attention_launches_per_prefill": attn_launches, "attention_launches_per_decode": 0,
           "moe_launches_per_prefill": moe_prefill, "moe_launches_per_decode": 0,
           "chacha": crypt, "secure_equals_plain": True, "logits_finite": True,
           "reduced_card_vs_cpu": small, "launches": {"chacha20": launches},
           "phase_s": time.perf_counter() - t_phase}
    emit(res)
    return res


# lm_train: granite-moe-3b-a800m at its published config, float32 masters,
# bf16 compute, experts on 8 shards, batch 4 x 1024 from the secure pipeline
TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEED, TRAIN_LR = 4, 1024, 0, 3e-4
TRAIN_PEAK_LIMIT = 75e9  # past it the batch is cut to 2
# reduced model, card == CPU after two steps at lr 1e-3: losses within rtol
# 1e-4; parameters within 1e-2 x lr where the gradient, at each step, is at
# least 1e-2 of its leaf's largest (`adam_steady_mask`): a gradient's
# rounding, ~1e-6 of its leaf's scale, is then a small share of the
# element's own, and so is its update's share of lr. Adam normalises each
# element, so a smaller gradient's rounding reaches its update at full size
# (at step 1 the update is lr x sign(g)).
TRAIN_SMALL_TOL, TRAIN_SMALL_PARAM_ATOL = 1e-4, 1e-2 * 1e-3
TRAIN_INGEST_KEY = b"\x42" * 32


def adam_steady_mask(mus: list, b1: float = 0.9) -> torch.Tensor:
    """Elements whose gradient is at least 1e-2 of the leaf's largest at
    every step, from the first moments after each step: mu_t - b1 mu_{t-1}
    is (1 - b1) times step t's clipped gradient."""
    prev, mask = torch.zeros_like(mus[0]), torch.ones_like(mus[0], dtype=torch.bool)
    for mu in mus:
        g = (mu - b1 * prev).abs()
        mask &= g >= 1e-2 * g.max()
        prev = mu
    return mask


def lm_train_flops(cfg, b: int, t: int, n_shards: int) -> dict:
    """Model operations of one training step: 3 x the forward (the forward
    once, the backward twice), the forward as `lm_prefill_flops` counts it
    but with every token unembedded; remat's recomputation is not counted."""
    fwd = lm_prefill_flops(cfg, b, t, n_shards)
    fwd["unembed"] = 2 * b * t * cfg.d_model * cfg.padded_vocab
    fwd["total"] = sum(v for k, v in fwd.items() if k != "total")
    return {k: 3 * v for k, v in fwd.items()}


def _digest(tensors) -> list:
    """Per tensor, two int64 sums of its 32-bit words (plain, and weighted by
    position; both wrap): equal trees give equal digests, and a flipped bit
    anywhere changes one."""
    sums = []
    for t in tensors:
        w = t.detach().reshape(-1).view(torch.int32).long()
        sums.append(torch.stack([w.sum(), (w * torch.arange(1, w.numel() + 1,
                                                             device=w.device)).sum()]))
    return torch.stack(sums).cpu().tolist()


def _state_digest(model, opt) -> list:
    return _digest(list(model.parameters()) + list(opt["mu"].values())
                   + list(opt["nu"].values()) + [opt["count"]])


def _train_setup(cfg, dev, batch, seq, shards, seed):
    """(step factories' shared kwargs, ingest, secure source, plain batches)."""
    from repro_torch.crypto.keys import make_session_keys
    from repro_torch.data.pipeline import SecureShardedSource
    from repro_torch.data.synthetic import batches, synthetic_tokens
    from repro_torch.train.step import SecureIngest

    session = make_session_keys(TRAIN_INGEST_KEY)
    ingest = SecureIngest(key_words=session.words("data"),
                          nonce_words=session.nonce_words("data", 0))
    toks = synthetic_tokens(max(16 * batch * seq, 65536), cfg.vocab_size, seed=seed)
    src = SecureShardedSource(toks, batch=batch, seq=seq, session=session, seed=seed + 1,
                              device=dev)
    plain = batches(toks, batch, seq, seed=seed + 1)  # the same draws, in plaintext
    return ingest, src, plain


def lm_train_small_on_card_and_cpu(dev):
    """Reduced granite-moe (float32) on 4 virtual shards, secure ingest and
    MoE: two steps from one seeded state on the card and on the CPU (plain
    versions), and on the card 2 steps + a checkpoint + 2 resumed steps
    against 4 straight steps."""
    import tempfile

    from repro_torch import VirtualMesh
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM, init_params
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.step import make_train_step

    cfg = get_config(LM_ARCH).reduced()
    shards = LM_SMALL_SHARDS
    cpu_model = init_params(cfg, torch.Generator().manual_seed(5), shards, "cpu",
                            torch.float32)

    def run(device, n_steps, mgr=None, save_at=None, resume_at=None):
        model = LM(cfg, shards, device, torch.float32)
        model.load_state_dict(cpu_model.state_dict())
        opt = adamw_init(dict(model.named_parameters()))
        ingest, src, _ = _train_setup(cfg, device, 4, 16, shards, 7)
        step = make_train_step(cfg, VirtualMesh(shards, device), secure_ingest=ingest,
                               secure_moe=_secure_cfg(), peak_lr=1e-3, warmup=1,
                               total_steps=10)
        start = 0
        if resume_at is not None:
            (params, opt), extra = mgr.restore(resume_at, (dict(model.named_parameters()), opt),
                                               device=device)
            model.load_state_dict(params)
            src.restore(extra["data_cursor"])
            start = extra["step"]
        losses, mus = [], []
        for i in range(start, n_steps):
            model, opt, m = step(model, opt, src.next_batch(), i + 1)
            losses.append(float(m["loss"]))
            mus.append({k: v.detach().cpu().clone() for k, v in opt["mu"].items()})
            if save_at == i + 1:
                mgr.save(save_at, (dict(model.named_parameters()), opt),
                         extra={"step": save_at, "data_cursor": src.state})
        return model, opt, losses, mus

    card_model, _, card_losses, _ = run(dev, 2)
    cpu_model2, _, cpu_losses, cpu_mus = run("cpu", 2)
    check(all(np.isclose(a, b, rtol=TRAIN_SMALL_TOL, atol=0)
              for a, b in zip(card_losses, cpu_losses)),
          f"lm_train: reduced losses card {card_losses} != CPU {cpu_losses}")
    worst, compared = 0.0, 0
    for (k, a), (_, b) in zip(card_model.named_parameters(), cpu_model2.named_parameters()):
        live = adam_steady_mask([mu[k] for mu in cpu_mus])
        diff = (a.detach().cpu() - b.detach())[live].abs()
        check(bool((diff <= TRAIN_SMALL_PARAM_ATOL).all()),
              f"lm_train: reduced {k} card != CPU (max diff {float(diff.max())})")
        worst = max(worst, float(diff.max()) if diff.numel() else 0.0)
        compared += int(live.sum())
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        full_model, full_opt, full_losses, _ = run(dev, 4)
        run(dev, 2, mgr, save_at=2)
        res_model, res_opt, res_losses, _ = run(dev, 4, mgr, resume_at=2)
        resumed_equal = (_state_digest(full_model, full_opt) == _state_digest(res_model, res_opt)
                         and all(torch.equal(a, b) for a, b in zip(full_model.parameters(),
                                                                   res_model.parameters()))
                         and full_losses[2:] == res_losses)
    check(resumed_equal, "lm_train: a resumed reduced run != the straight run, bit for bit")
    return {"arch": cfg.name + " (reduced)", "shards": shards, "secure": True, "steps": 2,
            "losses_card": card_losses, "losses_cpu": cpu_losses,
            "max_abs_param_diff": worst, "params_compared": compared,
            "loss_rtol": TRAIN_SMALL_TOL, "param_atol": TRAIN_SMALL_PARAM_ATOL,
            "params_compared_where": "gradient >= 1e-2 x the leaf's largest at both steps",
            "resume_2_ckpt_2_equals_4_bit_for_bit": True}


def determinism_costs(dev, cfg, b: int, t: int, shards: int) -> dict:
    """What the fixed-order backwards cost against the default scatters with
    float atomics, at this phase's shapes (CUDA events): the embedding
    lookup's (once a step) and each MoE layer's k-fold token broadcast (once
    a layer)."""
    from repro_torch.models.layers import _EmbedLookup
    from repro_torch.models.moe import _entry_values

    g = torch.Generator(device=dev).manual_seed(3)
    table = torch.randn(cfg.padded_vocab, cfg.d_model, device=dev, generator=g)
    tokens = torch.randint(0, cfg.vocab_size, (b, t), device=dev, generator=g)
    ct = torch.randn(b, t, cfg.d_model, device=dev, generator=g).to(torch.bfloat16)
    tab = table.requires_grad_()
    out = _EmbedLookup.apply(tab, tokens, torch.bfloat16)
    fixed = cuda_ms(lambda: torch.autograd.grad(out, tab, ct, retain_graph=True), 5)
    atomic = cuda_ms(lambda: torch.zeros(cfg.padded_vocab, cfg.d_model, device=dev,
                                         dtype=torch.bfloat16).index_put_(
        (tokens.reshape(-1),), ct.reshape(-1, cfg.d_model), accumulate=True).float(), 5)
    k = cfg.n_experts_per_tok
    n = b * t // shards
    x2 = torch.randn(shards, n, cfg.d_model, device=dev, generator=g).to(
        torch.bfloat16).requires_grad_()
    ev = _entry_values(x2, k)
    cte = torch.randn(ev.shape, device=dev, generator=g).to(torch.bfloat16)
    token = torch.arange(n, device=dev).repeat_interleave(k)
    fixed_e = cuda_ms(lambda: torch.autograd.grad(ev, x2, cte, retain_graph=True), 5)
    atomic_e = cuda_ms(lambda: torch.zeros_like(x2).index_add_(1, token, cte), 5)
    return {"embed_backward_ms": fixed, "embed_index_put_accumulate_ms": atomic,
            "entry_broadcast_backward_ms": fixed_e, "entry_index_add_ms": atomic_e,
            "fixed_order_minus_atomics_ms_per_step":
                (fixed - atomic) + cfg.n_layers * (fixed_e - atomic_e)}


def _lm_train_at(dev, cfg, batch):
    """The phase at one batch size (see `phase_lm_train`)."""
    from repro_torch import VirtualMesh
    from repro_torch.core.shuffle import record_wire_bytes
    from repro_torch.kernels.chacha20 import kernel as ck
    from repro_torch.models.lm import init_params
    from repro_torch.optim.adamw import adamw_init, adamw_update
    from repro_torch.train.step import decrypt_batch, make_train_step, value_and_grad

    mesh = VirtualMesh(LM_SHARDS, dev)
    sec = _secure_cfg()
    ingest, src, plain = _train_setup(cfg, dev, batch, TRAIN_SEQ, LM_SHARDS, TRAIN_SEED)
    kw = dict(peak_lr=TRAIN_LR, warmup=1, total_steps=100)
    secure_step = make_train_step(cfg, mesh, secure_ingest=ingest, secure_moe=sec, **kw)
    plain_step = make_train_step(cfg, mesh, **kw)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    def fresh():
        return init_params(cfg, torch.Generator(device=dev).manual_seed(TRAIN_SEED),
                           LM_SHARDS, dev, torch.float32)

    def draw():
        ct = src.next_batch()
        return ct, {"tokens": torch.from_numpy(next(plain)).to(dev)}

    # 1. the gradients of one batch from the seeded state, secure == plain
    model, init_s = timed(fresh)
    init_digest = _digest(model.parameters())
    param_count = sum(p.numel() for p in model.parameters())
    ct1, plain1 = draw()
    lp, mp, gp = value_and_grad(cfg, model, plain1, mesh, None)
    ls, ms_, gs = value_and_grad(cfg, model, decrypt_batch(ct1, ingest), mesh, sec)
    check(torch.equal(lp, ls) and all(torch.equal(mp[k], ms_[k]) for k in mp),
          "lm_train: secure loss != plain loss, bit for bit")
    check(all(torch.equal(gp[k], gs[k]) for k in gp),
          "lm_train: secure gradients != plain gradients, bit for bit")
    del gs
    finite = torch.stack([torch.isfinite(g).all() for g in gp.values()]).all()
    check(bool(finite) and bool(torch.isfinite(lp)), "lm_train: non-finite loss or gradient")
    expert_sums = torch.stack([gp[f"layers.{i}.moe.{w}"].abs().sum()
                               for i in range(cfg.n_layers) for w in ("wi", "wg", "wo")])
    check(bool((expert_sums > 0).all()), "lm_train: an expert weight has a zero gradient")
    del gp

    # 2. a plain step and a secure step from the same seeded state
    opt = adamw_init(dict(model.named_parameters()))
    (model, opt, m_plain), plain_first_s = timed(lambda: plain_step(model, opt, plain1, 1))
    plain_digest, m_plain = _state_digest(model, opt), {k: float(v) for k, v in m_plain.items()}
    del model, opt
    model = fresh()
    check(_digest(model.parameters()) == init_digest, "lm_train: the seeded init differs")
    opt = adamw_init(dict(model.named_parameters()))
    peaks, step_s, launches, records = [], {"secure": [], "plain": []}, [], []
    ck.launches = 0  # the main path: secure steps from here, plain ones in turn
    pipeline_launches = 0  # the data pipeline's encryptions of the path's batches
    torch.cuda.reset_peak_memory_stats()
    before = ck.launches
    with record_wire_bytes() as recs:
        (model, opt, m1), first_s = timed(lambda: secure_step(model, opt, ct1, 1))
    launches.append(ck.launches - before)
    records.append(recs)
    peaks.append(torch.cuda.max_memory_allocated())
    secure_digest, m1 = _state_digest(model, opt), {k: float(v) for k, v in m1.items()}
    check(secure_digest == plain_digest and m1 == m_plain,
          "lm_train: the secure step's parameters, moments or metrics != the plain step's")
    metrics = [m1]

    # 3. steps 2..9: secure and plain in turns (the plain ones: plaintext
    # tokens, plain MoE), every loss and gradient norm finite
    for i, name in zip(range(2, 10), ("secure", "plain") * 4):
        before = ck.launches
        ct, pl = draw()
        pipeline_launches += ck.launches - before
        before = ck.launches
        with record_wire_bytes() as recs:
            if name == "secure":
                (model, opt, m), s = timed(lambda: secure_step(model, opt, ct, i))
            else:
                (model, opt, m), s = timed(lambda: plain_step(model, opt, pl, i))
        step_s[name].append(s)
        if name == "secure":
            launches.append(ck.launches - before)
            records.append(recs)
        else:
            check(ck.launches == before, "lm_train: a plain step launched the ChaCha kernel")
        metrics.append({k: float(v) for k, v in m.items()})
        peaks.append(torch.cuda.max_memory_allocated())
    path_launches = ck.launches
    for m in metrics:
        check(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]),
              f"lm_train: non-finite loss or gradient norm {m}")
    per_step = 1 + 8 * cfg.n_layers
    check(launches == [per_step] * 5,
          f"lm_train: ChaCha launches per secure step {launches}, not {per_step}")
    check(all(len(r) == 4 * cfg.n_layers and all(x["secure"] for x in r) for r in records),
          "lm_train: not 4 secure wire records a layer per step (2 legs, 2 cotangent legs)")

    # 4. a profiled secure step
    ct, _ = draw()
    prof, busy_ms, top = _profiled(lambda: timed(lambda: secure_step(model, opt, ct, 10)))
    prof_ms = 1e3 * prof[1]
    # 5. the optimizer update alone, on zero gradients
    named = dict(model.named_parameters())
    grads = {k: torch.zeros_like(p) for k, p in named.items()}
    lr = torch.tensor(TRAIN_LR, device=dev)
    update_ms = cuda_ms(lambda: adamw_update(named, grads, opt, lr), 3, warm=1)
    del grads, named
    peak = max(peaks)
    wire_bytes_step = sum(r["wire_bytes"] for r in records[0]) * LM_SHARDS
    del model, opt, prof
    torch.cuda.empty_cache()
    return {"batch": batch, "param_count": param_count,
            "state_bytes": 4 * 4 * param_count, "init_s": init_s,
            "loss_step1": m1["loss"], "grad_norm_step1": m1["grad_norm"],
            "metrics": metrics, "first_secure_step_s": first_s,
            "first_plain_step_s": plain_first_s, "step_s": step_s,
            "launches_per_secure_step": launches, "pipeline_launches": pipeline_launches,
            "path_launches": path_launches, "wire_bytes_per_step": wire_bytes_step,
            "wire_bytes_per_leg": records[0][0]["wire_bytes"] * LM_SHARDS,
            "profiled_step_ms": prof_ms, "device_busy_ms": busy_ms,
            "device_idle_share": None if busy_ms is None else 1 - busy_ms / prof_ms,
            "idle_share_of_unprofiled_step": None if busy_ms is None
            else 1 - busy_ms / (1e3 * float(np.median(step_s["secure"]))),
            "top_device_ops": top, "update_ms": update_ms, "peak_memory_bytes": peak}


def phase_lm_train(dev):
    """LM training of granite-moe-3b-a800m at its published config (32
    layers, d_model 1536, 40 experts top-8, vocab 49155): float32 masters,
    bf16 compute, weights from a seeded generator, experts on 8 virtual
    shards, batch 4 x 1024 from `SecureShardedSource` (cut to 2 past 75 GB
    of peak memory), secure ingest and a secure MoE, remat `sqrt` (4 groups
    of 8 layers) with `save_shuffle`, AdamW in place. Asserts: secure
    gradients, loss, updated parameters and moments == plain bit for bit
    from one seeded state; every expert weight's gradient nonzero; every loss
    and gradient norm finite; 1 + 8 ChaCha launches a layer per secure step
    (the ingest decrypt; 2 legs and 2 cotangent legs, 2 crypts each) and none
    replayed; the kernel == its plain version on a training leg's wire at
    rounds 0 and 2**31; the reduced model card == CPU within
    TRAIN_SMALL_TOL after two steps; a resumed reduced run == the straight
    run bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import _remat_groups
    from repro_torch.models.moe import _capacity, padded_experts

    t_phase = time.perf_counter()
    cfg = get_config(LM_ARCH)
    check((cfg.n_layers, cfg.d_model, cfg.n_experts, cfg.n_experts_per_tok, cfg.vocab_size,
           cfg.remat, cfg.moe_remat) == (32, 1536, 40, 8, 49155, "sqrt", "save_shuffle"),
          "lm_train: not the published granite-moe config")
    batch, batch_cut = TRAIN_BATCH, None
    res = _lm_train_at(dev, cfg, batch)
    if res["peak_memory_bytes"] > TRAIN_PEAK_LIMIT:
        batch_cut = {"from": batch, "peak_bytes": res["peak_memory_bytes"]}
        batch = 2
        res = _lm_train_at(dev, cfg, batch)
    tokens = batch * TRAIN_SEQ
    secure_s = float(np.median(res["step_s"]["secure"]))
    plain_s = float(np.median(res["step_s"]["plain"]))
    flops = lm_train_flops(cfg, batch, TRAIN_SEQ, LM_SHARDS)
    update_bytes = 7 * 4 * res["param_count"]  # read p, g, mu, nu; write p, mu, nu

    # the ChaCha kernel on one training leg's wire, forward and cotangent rounds
    e_pad = padded_experts(cfg, LM_SHARDS)
    cap = _capacity(cfg, tokens // LM_SHARDS, e_pad)
    g = torch.Generator(device=dev).manual_seed(19)
    send = torch.randint(-2**15, 2**15, (LM_SHARDS, LM_SHARDS, e_pad // LM_SHARDS * cap,
                                         cfg.d_model),
                         dtype=torch.int16, device=dev, generator=g).view(torch.bfloat16)
    crypt = wire_crypt(dev, {"x": send}, 20, 0)
    crypt_ct = wire_crypt(dev, {"x": send}, 5, 1 << 31)
    del send
    check(crypt["wire_bytes"] == res["wire_bytes_per_leg"],
          "lm_train: the timed wire is not a training leg's wire")
    costs = determinism_costs(dev, cfg, batch, TRAIN_SEQ, LM_SHARDS)
    torch.cuda.empty_cache()
    small = lm_train_small_on_card_and_cpu(dev)
    out = {"phase": "lm_train", "arch": cfg.name, "config": "full (published)",
           "dtype": cfg.dtype, "param_dtype": "float32", "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "experts": cfg.n_experts, "top_k": cfg.n_experts_per_tok,
           "shards": LM_SHARDS, "batch": batch, "seq": TRAIN_SEQ, "batch_cut": batch_cut,
           "remat": cfg.remat, "remat_groups": _remat_groups(cfg, cfg.n_layers),
           "moe_remat": cfg.moe_remat, "capacity_per_expert": cap,
           **{k: v for k, v in res.items() if k not in ("batch",)},
           "step_ms": 1e3 * secure_s, "plain_step_ms": 1e3 * plain_s,
           "secure_over_plain": secure_s / plain_s, "tokens_per_s": tokens / secure_s,
           "flops": flops, "step_bound_ms": 1e3 * flops["total"] / PEAK_BF16_S,
           "step_bound_by": "operations",
           "update_bytes": update_bytes, "update_bound_ms": 1e3 * update_bytes / PEAK_BYTES_S,
           "update_bound_by": "bytes",
           "chacha": crypt, "chacha_cotangent_round": crypt_ct,
           "determinism": costs, "secure_equals_plain": True,
           "reduced": small, "launches": {"chacha20": res["path_launches"]},
           "phase_s": time.perf_counter() - t_phase}
    emit(out)
    return out


# lm_ssm, lm_hybrid, lm_audio: the ssm, hybrid and audio families at their
# published configs, seeded weights, bf16 compute; served, then trained
# (float32 masters, remat sqrt, secure ingest)
FAMILY_PHASES = {
    "lm_ssm": {"arch": "rwkv6-1.6b", "batch": 8, "prompt": 4096, "decode": 64,
               "train": (4, 4096),
               "published": {"n_layers": 24, "d_model": 2048, "n_heads": 32, "d_ff": 7168,
                             "vocab_size": 65536}},
    "lm_hybrid": {"arch": "zamba2-1.2b", "batch": 8, "prompt": 4096, "decode": 64,
                  "train": (4, 4096),
                  "published": {"n_layers": 38, "d_model": 2048, "n_heads": 32, "d_ff": 8192,
                                "vocab_size": 32000, "ssm_state": 64, "ssm_conv": 4,
                                "attn_every": 6}},
    # whisper: 30 s of frames, a 4-token prompt (SOT, language, task,
    # no-timestamps), its text context of 448 as the cache
    "lm_audio": {"arch": "whisper-base", "batch": 8, "prompt": 4, "decode": 128, "smax": 448,
                 "train": (8, 448),
                 "published": {"n_layers": 6, "n_encoder_layers": 6, "d_model": 512,
                               "n_heads": 8, "d_ff": 2048, "vocab_size": 51865,
                               "encoder_seq": 1500, "norm": "layernorm", "act": "gelu"}},
}
FAMILY_SEED, FAMILY_CONSIST_STEPS, FAMILY_SCAN_T, FAMILY_TRAIN_STEPS = 0, 16, 1024, 4
FAMILY_TRAIN_CUT = (4, 1024)  # the training batch past TRAIN_PEAK_LIMIT
# Serving consistency at full width, one sequence: the 16th decode step's
# logits against a prefill of the same tokens. Asserted in float32 compute
# (the published config, weights drawn from the same seed), within
# FAMILY_CONSIST_TOL of the prefill logits' largest magnitude: the two run
# by other orders (blocked WKV or chunked SSD against the per-token
# recurrence, GEMM against GEMV), ~1e-4 on the CPU at full depth, and a
# state carried wrong moves the logits by their own size. In bf16 the same
# comparison is measured, not held: seeded random weights make these
# models chaotic (a 4e-3 relative perturbation of the embedding moves
# zamba2's float32 logits by 70% of their largest, rwkv6's by 22%, at full
# depth and d_model 256 on the CPU), so bf16 roundings taken in another
# order move the logits by as much.
FAMILY_CONSIST_TOL = 1e-2
# one layer at full width: the blocked WKV against the per-token scan on the
# same float32 inputs (tests/test_rwkv_wkv.py's 2e-4); ssm_apply (the chunked
# SSD at chunk 256) against ssm_decode_step iterated, whose bf16 projections
# (GEMV per token against one GEMM) differ in the last bit: within 2e-2 of
# the largest magnitude
WKV_TOL, SSD_TOL = 2e-4, 2e-2


def family_prefill_flops(cfg, b: int, t: int) -> dict:
    """Operations of one prefill as the port computes them, 2 per
    multiply-add: every matrix product of the layers (dense: the
    projections, the gated MLP and the full-square attention chunks), the
    scans' products
    (rwkv: per token and head the intra-block pairs and their values, the
    carried state's product and the state increment; zamba2: C·B, the
    intra-chunk product, the chunk's state increment and the inter-chunk
    product), the shared block's full-square attention chunks, whisper's
    encoder over its frames and the cross K/V of every decoder layer, and
    the last token's unembedding."""
    from repro_torch.models.rwkv import DECAY_RANK, WKV_BLOCK, rwkv_dims
    from repro_torch.models.ssm import HEAD_P, ssm_dims

    n, d, L, dh = b * t, cfg.d_model, cfg.n_layers, cfg.head_dim
    attn_proj = 2 * cfg.n_heads * dh * d + 2 * cfg.n_kv_heads * dh * d  # q, o; k, v
    mlp = 3 * d * cfg.d_ff  # gated: wi, wg, wo
    out = {}
    if cfg.family == "ssm":
        h, dk = rwkv_dims(cfg)
        out["projections"] = 2 * n * (6 * d * d + 2 * d * cfg.d_ff + 2 * d * DECAY_RANK) * L
        out["wkv"] = 2 * n * h * (2 * WKV_BLOCK * dk + 2 * dk * dk) * L
    elif cfg.family == "hybrid":
        d_inner, h = ssm_dims(cfg)
        nst, q = cfg.ssm_state, 256
        while t % q:
            q //= 2
        n_inv = L // cfg.attn_every
        out["projections"] = 2 * n * d * (3 * d_inner + 2 * nst + h) * L
        out["ssd"] = 2 * n * (q * nst + h * q * HEAD_P + 2 * h * nst * HEAD_P) * L
        out["shared_block"] = 2 * n * (attn_proj + mlp) * n_inv
        out["attention"] = 2 * 2 * b * cfg.n_heads * t * t * dh * n_inv
    elif cfg.family in ("dense", "vlm"):
        out["projections"] = 2 * n * (attn_proj + mlp) * L
        out["attention"] = 2 * 2 * b * cfg.n_heads * t * t * dh * L
    else:
        s, le = cfg.encoder_seq, cfg.n_encoder_layers
        out["encoder"] = (2 * b * s * (attn_proj + mlp) + 2 * 2 * b * cfg.n_heads * s * s * dh) * le
        out["cross_kv"] = 2 * b * s * 2 * cfg.n_kv_heads * dh * d * L
        out["decoder"] = (2 * n * (attn_proj + 2 * cfg.n_heads * dh * d + mlp)
                          + 2 * 2 * b * cfg.n_heads * t * (t + s) * dh) * L
    out["unembed"] = 2 * b * d * cfg.padded_vocab
    out["total"] = sum(out.values())
    return out


def family_train_flops(cfg, b: int, t: int) -> dict:
    """3 x the forward (as `family_prefill_flops`, every token unembedded);
    remat's recomputation is not counted."""
    fwd = family_prefill_flops(cfg, b, t)
    fwd["unembed"] = 2 * b * t * cfg.d_model * cfg.padded_vocab
    fwd["total"] = sum(v for k, v in fwd.items() if k != "total")
    return {k: 3 * v for k, v in fwd.items()}


def family_decode_bytes(model, cfg, cache, kv_len: int) -> int:
    """Bytes one decode step must move: every weight once, the recurrent
    states read and written, the K/V of the kv_len positions attended read
    and the new K/V written, the encoder's cross K/V read, the float32
    logits written."""
    size = {k: v.numel() * v.element_size() for k, v in cache.items()}
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    states = sum(size.get(k, 0) for k in ("tshift", "wkv", "cshift", "ssm_h", "conv"))
    kv = sum(size[k] * (kv_len + 1) // cache[k].shape[2]
             for k in ("k", "v", "attn_k", "attn_v") if k in cache)
    cross = size.get("xk", 0) + size.get("xv", 0)
    return weights + 2 * states + kv + cross + cache["pos"].shape[0] * cfg.padded_vocab * 4


def _profile_ops(fn):
    """fn under torch.profiler: (result, host ms to a synchronise, device
    busy ms (None when the profiler saw no device activity), the top device
    operations by ms, the number of device operations)."""
    (out, s), events = _device_events(lambda: timed(fn))
    by_name: dict = {}
    for name, ms in events:
        by_name[name] = by_name.get(name, 0.0) + ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    busy = sum(ms for _, ms in events) if events else None
    return out, 1e3 * s, busy, [[name[:80], ms] for name, ms in top], len(events)


def family_scan_check(dev, cfg, model) -> dict:
    """One layer of the full model, B = 1, T = FAMILY_SCAN_T, its bf16 input
    normalised as the block does: rwkv's blocked WKV against the per-token
    scan on the same float32 r, k, v, w; zamba2's ssm_apply (the chunked
    SSD at chunk 256) against ssm_decode_step iterated."""
    from repro_torch.models import rwkv, ssm
    from repro_torch.models.layers import apply_norm

    g = torch.Generator(device=dev).manual_seed(FAMILY_SEED + 3)
    x = torch.randn((1, FAMILY_SCAN_T, cfg.d_model), generator=g, device=dev)
    p = model.layers[0]
    hn = apply_norm(cfg, p.ln1, x.to(torch.bfloat16))
    if cfg.family == "ssm":
        r, k, v, w, _ = rwkv.time_mix_inputs(cfg, p.tmix, hn)
        s0 = torch.zeros((1, r.shape[2], r.shape[3], r.shape[3]), device=dev)
        (yb, sb), blocked_s = timed(lambda: rwkv._wkv_blocked(r, k, v, w, p.tmix.u, s0))
        (ys, ss), scan_s = timed(lambda: rwkv._wkv_scan(r, k, v, w, p.tmix.u, s0, 256))
        ok = all(torch.allclose(a, b_, rtol=WKV_TOL, atol=WKV_TOL) for a, b_ in ((yb, ys), (sb, ss)))
        check(ok, f"lm_ssm: blocked WKV != per-token scan within {WKV_TOL} (max diff "
                  f"{float((yb - ys).abs().max())})")
        return {"form": "_wkv_blocked vs _wkv_scan", "T": FAMILY_SCAN_T,
                "max_abs_diff_y": float((yb - ys).abs().max()),
                "max_abs_diff_state": float((sb - ss).abs().max()),
                "max_abs_y": float(ys.abs().max()), "tolerance": WKV_TOL,
                "blocked_ms": 1e3 * blocked_s, "scan_ms": 1e3 * scan_s}
    (out, (h_end, _)), apply_s = timed(lambda: ssm.ssm_apply(cfg, p.ssm, hn))

    def iterate():
        d_inner, h = ssm.ssm_dims(cfg)
        hs = torch.zeros((1, h, cfg.ssm_state, ssm.HEAD_P), device=dev)
        conv = torch.zeros((1, cfg.ssm_conv - 1, d_inner), dtype=hn.dtype, device=dev)
        outs = []
        for i in range(FAMILY_SCAN_T):
            o, hs, conv = ssm.ssm_decode_step(cfg, p.ssm, hn[:, i:i + 1], hs, conv)
            outs.append(o)
        return torch.cat(outs, 1), hs

    (outs, hs), step_s = timed(iterate)
    rel_out = float((out.float() - outs.float()).abs().max() / outs.float().abs().max())
    rel_h = float((h_end - hs).abs().max() / hs.abs().max())
    check(rel_out <= SSD_TOL and rel_h <= SSD_TOL,
          f"lm_hybrid: ssm_apply != ssm_decode_step iterated (relative {rel_out}, {rel_h})")
    return {"form": "ssm_apply (chunk 256) vs ssm_decode_step iterated", "T": FAMILY_SCAN_T,
            "max_rel_diff_out": rel_out, "max_rel_diff_state": rel_h, "tolerance": SSD_TOL,
            "apply_ms": 1e3 * apply_s, "iterated_ms": 1e3 * step_s}


def family_consistency(dev, cfg, spec, model=None, mesh=None) -> dict:
    """One sequence: 16 decode steps after a prefill against a prefill of
    the same tokens (rwkv, zamba2: after 4,080 of 4,096 tokens, a multiple
    of 16, so the blocked WKV and the chunked SSD run; whisper: after its
    prompt, on the same frames), every logit finite; `model` None draws the
    config's model from the phase's seed (its experts over `mesh`'s shards,
    which carry the MoE)."""
    from repro_torch.models.lm import init_params
    from repro_torch.serve.engine import decode_step, init_cache, prefill

    audio, vocab = cfg.family == "audio", cfg.vocab_size
    if model is None:
        n_model = 1 if mesh is None else mesh.n_shards
        model = init_params(cfg, torch.Generator(device=dev).manual_seed(FAMILY_SEED), n_model,
                            dev)
    g = torch.Generator(device=dev).manual_seed(FAMILY_SEED + 2)
    n_tok = spec["prompt"] + FAMILY_CONSIST_STEPS if audio else spec["prompt"]
    head = n_tok - FAMILY_CONSIST_STEPS
    toks = torch.randint(0, vocab, (1, n_tok), generator=g, device=dev, dtype=torch.int32)
    fr = torch.randn((1, cfg.encoder_seq, cfg.d_model), generator=g, device=dev) if audio else None
    smax = spec.get("smax", n_tok + 1)
    cache = init_cache(cfg, 1, smax, dev)
    lg = prefill(cfg, model, toks[:, :head], cache, mesh=mesh, frames=fr)
    ok = [torch.isfinite(lg[:, :vocab]).all()]
    for i in range(head, n_tok):
        lg = decode_step(cfg, model, cache, toks[:, i:i + 1], mesh=mesh)
        ok.append(torch.isfinite(lg[:, :vocab]).all())
    full = prefill(cfg, model, toks, init_cache(cfg, 1, smax, dev), mesh=mesh, frames=fr).float()
    ok.append(torch.isfinite(full[:, :vocab]).all())
    check(bool(torch.stack(ok).all()), f"{cfg.name}: non-finite logits ({cfg.dtype}, one sequence)")
    diff = float((lg - full)[:, :vocab].abs().max())
    scale = float(full[:, :vocab].abs().max())
    return {"dtype": cfg.dtype, "prefill_tokens": head, "decode_steps": FAMILY_CONSIST_STEPS,
            "against_prefill_tokens": n_tok, "max_abs_diff": diff, "max_abs_logit": scale,
            "rel_diff": diff / scale, "logits_finite": True,
            "argmax_equal": bool(torch.equal(lg[:, :vocab].argmax(-1),
                                             full[:, :vocab].argmax(-1)))}


def _family_serve(dev, cfg, spec) -> dict:
    """The serving half of a family phase (see `phase_lm_family`)."""
    from repro_torch.kernels.chacha20 import kernel as ck
    from repro_torch.models.lm import init_params
    from repro_torch.serve.engine import decode_step, init_cache, prefill
    from repro_torch.serve_lm import sample

    audio, vocab = cfg.family == "audio", cfg.vocab_size
    torch.cuda.reset_peak_memory_stats()
    model, init_s = timed(lambda: init_params(
        cfg, torch.Generator(device=dev).manual_seed(FAMILY_SEED), 1, dev))
    g = torch.Generator(device=dev).manual_seed(FAMILY_SEED + 1)

    def finite(lg):
        return torch.isfinite(lg[:, :vocab]).all()

    # 1. one sequence: decode after a prefill == a prefill of the same tokens
    consist = {"float32": family_consistency(dev, replace(cfg, dtype="float32"), spec)}
    check(consist["float32"]["rel_diff"] <= FAMILY_CONSIST_TOL,
          f"{cfg.name}: float32 decode after prefill != prefill ({consist['float32']})")
    consist["float32"]["tolerance"] = FAMILY_CONSIST_TOL
    consist["bfloat16"] = family_consistency(dev, cfg, spec, model)

    # 2. the batch: prefill, then sampled decode steps
    b, tp, n_dec = spec["batch"], spec["prompt"], spec["decode"]
    prompts = torch.randint(0, vocab, (b, tp), generator=g, device=dev, dtype=torch.int32)
    frames = None
    if audio:
        frames = torch.randn((b, cfg.encoder_seq, cfg.d_model), generator=g, device=dev)
    cache = init_cache(cfg, b, spec.get("smax", tp + n_dec + 4), dev)
    cache_bytes = sum(v.numel() * v.element_size() for v in cache.values())
    launches = ck.launches

    def run_prefill():
        return prefill(cfg, model, prompts, cache, frames=frames)

    lg, first_s = timed(run_prefill)
    runs = [timed(run_prefill)[1] for _ in range(2)]
    pre_lg, pre_ms, pre_busy, pre_top, pre_ops = _profile_ops(run_prefill)
    check(torch.equal(pre_lg, lg) and bool(finite(lg)),
          f"{cfg.name}: prefill logits non-finite or not repeatable")
    prefill_s = min(runs)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_dec):
        lg = decode_step(cfg, model, cache, sample(lg, vocab, 0.8, g))
        ok &= finite(lg)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    check(bool(ok), f"{cfg.name}: non-finite decode logits")
    kv_len = int(cache["pos"][0])
    nxt = sample(lg, vocab, 0.8, g)
    _, dec_ms, dec_busy, dec_top, dec_ops = _profile_ops(
        lambda: decode_step(cfg, model, cache, nxt))
    check(ck.launches == launches, f"{cfg.name}: serving launched the ChaCha kernel")
    flops = family_prefill_flops(cfg, b, tp)
    dec_bytes = family_decode_bytes(model, cfg, cache, kv_len)
    del cache, lg
    scan = None if audio else family_scan_check(dev, cfg, model)
    param_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    peak = torch.cuda.max_memory_allocated()
    del model
    torch.cuda.empty_cache()
    return {"param_bytes": param_bytes, "cache_bytes": cache_bytes, "init_s": init_s,
            "consistency": consist, "batch": b, "prompt_tokens": tp, "decode_steps": n_dec,
            "first_prefill_s": first_s, "prefill_s_runs": runs, "prefill_ms": 1e3 * prefill_s,
            "prompt_tokens_per_s": b * tp / prefill_s,
            "profiled_prefill_ms": pre_ms, "prefill_device_busy_ms": pre_busy,
            "prefill_device_idle_share": None if pre_busy is None else 1 - pre_busy / pre_ms,
            "prefill_device_ops": pre_ops, "prefill_top_device_ops": pre_top,
            "prefill_flops": flops, "prefill_bound_ms": 1e3 * flops["total"] / PEAK_BF16_S,
            "prefill_bound_by": "operations",
            "decode_ms_per_step": 1e3 * decode_s / n_dec,
            "decode_tokens_per_s": b * n_dec / decode_s, "decode_kv_len": kv_len,
            "profiled_decode_step_ms": dec_ms, "decode_device_busy_ms": dec_busy,
            "decode_device_idle_share": None if dec_busy is None else 1 - dec_busy / dec_ms,
            "decode_device_ops": dec_ops, "decode_top_device_ops": dec_top,
            "decode_step_bytes": dec_bytes, "decode_bound_ms": 1e3 * dec_bytes / PEAK_BYTES_S,
            "decode_bound_by": "bytes", "scan_vs_recurrence": scan,
            "serve_peak_memory_bytes": peak, "chacha_launches_serving": 0}


def _family_batches(cfg, dev, batch: int, seq: int, seed: int):
    """(ingest, draw): draw() -> (secure batch, the same batch in plaintext),
    the tokens drawn as the data pipeline draws them. rwkv and zamba2: the
    secure source's ciphertext (one ChaCha launch a batch on the card).
    whisper: float32 frames from a numpy seed beside the tokens, both
    encrypted here (two launches), the frames at ctr + 2**16 as the step
    decrypts them; the steps' ctr are spaced by 2**16 + the frames' blocks,
    so that no two steps share a pad."""
    from repro_torch.crypto.ctr import encrypt_array, words_for
    from repro_torch.train.step import FRAMES_CTR_OFFSET

    ingest, src, plain = _train_setup(cfg, dev, batch, seq, 1, seed)
    if cfg.family != "audio":
        return ingest, lambda: (src.next_batch(),
                                {"tokens": torch.from_numpy(next(plain)).to(dev)})
    rng = np.random.default_rng(seed + 2)
    shape = (batch, cfg.encoder_seq, cfg.d_model)
    stride = FRAMES_CTR_OFFSET + -(-words_for(shape, torch.float32) // 16)
    count = itertools.count()
    kw, nw = ingest.key_words, ingest.nonce_words

    def draw():
        toks = torch.from_numpy(next(plain)).to(dev)
        frames = torch.from_numpy(rng.standard_normal(shape, np.float32)).to(dev)
        ctr = next(count) * stride
        ct = {"tokens": encrypt_array(toks, kw, nw, ctr),
              "frames": encrypt_array(frames, kw, nw, ctr + FRAMES_CTR_OFFSET),
              "ctr": torch.tensor(ctr, dtype=torch.int64, device=dev)}
        return ct, {"tokens": toks, "frames": frames}

    return ingest, draw


def _family_train_at(dev, cfg, batch: int, seq: int):
    """The training half of a family phase at one batch (see
    `phase_lm_family`): (figures, the first batch's plaintext, the ingest)."""
    from repro_torch.kernels.chacha20 import kernel as ck
    from repro_torch.models.lm import init_params
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.step import decrypt_batch, make_train_step, value_and_grad

    ingest, draw = _family_batches(cfg, dev, batch, seq, TRAIN_SEED)
    kw = dict(peak_lr=TRAIN_LR, warmup=1, total_steps=100)
    secure_step = make_train_step(cfg, secure_ingest=ingest, **kw)
    plain_step = make_train_step(cfg, **kw)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    def fresh():
        return init_params(cfg, torch.Generator(device=dev).manual_seed(TRAIN_SEED), 1, dev,
                           torch.float32)

    ck.launches = 0  # the path: the pipeline's encryptions and the steps' decrypts
    model, init_s = timed(fresh)
    init_digest = _digest(model.parameters())
    param_count = sum(p.numel() for p in model.parameters())
    # 1. one batch's gradients from the seeded state, secure == plain
    ct1, plain1 = draw()
    lp, mp, gp = value_and_grad(cfg, model, plain1)
    ls, ms_, gs = value_and_grad(cfg, model, decrypt_batch(ct1, ingest))
    check(torch.equal(lp, ls) and all(torch.equal(mp[k], ms_[k]) for k in mp),
          f"{cfg.name}: secure loss != plain loss, bit for bit")
    check(all(torch.equal(gp[k], gs[k]) for k in gp),
          f"{cfg.name}: secure gradients != plain gradients, bit for bit")
    del gs
    finite = torch.stack([torch.isfinite(g).all() for g in gp.values()]).all()
    check(bool(finite) and bool(torch.isfinite(lp)), f"{cfg.name}: non-finite loss or gradient")
    watched = {}
    if cfg.family == "hybrid":  # NaN in the reference at this length
        for leaf in ("a_log", "dt_bias", "in_proj"):
            gl = [gp[f"layers.{i}.ssm.{leaf}"] for i in range(cfg.n_layers)]
            watched[leaf] = {"finite": True, "max_abs": float(max(g.abs().max() for g in gl)),
                             "nonzero_layers": sum(bool(g.any()) for g in gl)}
    del gp

    # 2. a plain step and a secure step from the same seeded state
    opt = adamw_init(dict(model.named_parameters()))
    (model, opt, m_plain), plain_first_s = timed(lambda: plain_step(model, opt, plain1, 1))
    plain_digest, m_plain = _state_digest(model, opt), {k: float(v) for k, v in m_plain.items()}
    del model, opt
    model = fresh()
    check(_digest(model.parameters()) == init_digest, f"{cfg.name}: the seeded init differs")
    opt = adamw_init(dict(model.named_parameters()))
    before = ck.launches
    (model, opt, m1), first_s = timed(lambda: secure_step(model, opt, ct1, 1))
    launches = [ck.launches - before]
    m1 = {k: float(v) for k, v in m1.items()}
    check(_state_digest(model, opt) == plain_digest and m1 == m_plain,
          f"{cfg.name}: the secure step's parameters, moments or metrics != the plain step's")

    # 3. more steps, secure and plain in turns
    metrics, step_s, pipeline = [m1], {"secure": [], "plain": []}, 0
    for i, name in zip(range(2, 2 + FAMILY_TRAIN_STEPS), ("secure", "plain") * 4):
        before = ck.launches
        ct, pl = draw()
        pipeline += ck.launches - before
        before = ck.launches
        if name == "secure":
            (model, opt, m), s = timed(lambda: secure_step(model, opt, ct, i))
            launches.append(ck.launches - before)
        else:
            (model, opt, m), s = timed(lambda: plain_step(model, opt, pl, i))
            check(ck.launches == before, f"{cfg.name}: a plain step launched the ChaCha kernel")
        step_s[name].append(s)
        metrics.append({k: float(v) for k, v in m.items()})
    for m in metrics:
        check(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]),
              f"{cfg.name}: non-finite loss or gradient norm {m}")
    per_step = 2 if cfg.family == "audio" else 1
    check(launches == [per_step] * len(launches),
          f"{cfg.name}: ChaCha launches per secure step {launches}, not {per_step}")
    path_launches = ck.launches
    ct, _ = draw()
    _, prof_ms, busy, top, n_ops = _profile_ops(lambda: secure_step(model, opt, ct, 10))
    peak = torch.cuda.max_memory_allocated()
    del model, opt
    torch.cuda.empty_cache()
    return {"batch": batch, "seq": seq, "param_count": param_count,
            "state_bytes": 4 * 4 * param_count, "init_s": init_s, "metrics": metrics,
            "first_secure_step_s": first_s, "first_plain_step_s": plain_first_s,
            "step_s": step_s, "launches_per_secure_step": launches,
            "pipeline_launches": pipeline, "path_launches": path_launches,
            "watched_gradients": watched, "profiled_step_ms": prof_ms,
            "device_busy_ms": busy, "device_idle_share": None if busy is None
            else 1 - busy / prof_ms, "step_device_ops": n_ops, "top_device_ops": top,
            "peak_memory_bytes": peak}, plain1, ingest


def ingest_crypt(dev, x, ingest, ctr: int, reps: int) -> dict:
    """The ChaCha20 kernel on an ingest wire (one tensor of the batch, at
    counter ctr): the card's `encrypt_array` == the CPU's plain ARX bit for
    bit; device ms per launch (`kernel_device_ms`) against the bytes bound
    (the words read and written once over 3.35 TB/s) and the integer
    operations bound."""
    from repro_torch.crypto.ctr import encrypt_array, words_for

    kw, nw = ingest.key_words, ingest.nonce_words
    got = encrypt_array(x, kw, nw, ctr).cpu().view(torch.uint8)  # bits: floats may be NaN
    check(torch.equal(got, encrypt_array(x.cpu(), kw, nw, ctr).view(torch.uint8)),
          f"chacha20 kernel != plain on the {tuple(x.shape)} ingest wire")
    words = words_for(x.shape, x.dtype)
    blocks = -(-words // 16)
    nbytes, ops_ = 2 * 4 * words, blocks * CHACHA_OPS_PER_BLOCK
    ms = kernel_device_ms(lambda: encrypt_array(x, kw, nw, ctr), reps)
    return {"shape": list(x.shape), "dtype": str(x.dtype).replace("torch.", ""),
            "wire_bytes": 4 * words, "blocks": blocks, "bit_exact": True, "kernel_ms": ms,
            "bound_ms": 1e3 * max(nbytes / PEAK_BYTES_S, ops_ / PEAK_I32_S),
            "bound_by": "operations" if ops_ / PEAK_I32_S > nbytes / PEAK_BYTES_S else "bytes"}


def family_train_small(dev, arch: str) -> dict:
    """The reduced config (float32), secure ingest: two steps from one
    seeded state on the card and on the CPU (plain versions), held by
    lm_train's rule (TRAIN_SMALL_TOL, TRAIN_SMALL_PARAM_ATOL where
    `adam_steady_mask`)."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM, init_params
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.step import make_train_step

    cfg = get_config(arch).reduced()
    cpu_model = init_params(cfg, torch.Generator().manual_seed(5), 1, "cpu", torch.float32)

    def run(device):
        model = LM(cfg, 1, device, torch.float32)
        model.load_state_dict(cpu_model.state_dict())
        opt = adamw_init(dict(model.named_parameters()))
        ingest, draw = _family_batches(cfg, device, 4, 16, 7)
        step = make_train_step(cfg, secure_ingest=ingest, peak_lr=1e-3, warmup=1,
                               total_steps=10)
        losses, mus = [], []
        for i in range(2):
            model, opt, m = step(model, opt, draw()[0], i + 1)
            losses.append(float(m["loss"]))
            mus.append({k: v.detach().cpu().clone() for k, v in opt["mu"].items()})
        return model, losses, mus

    card_model, card_losses, _ = run(dev)
    cpu_model2, cpu_losses, cpu_mus = run("cpu")
    check(all(np.isclose(a, b, rtol=TRAIN_SMALL_TOL, atol=0)
              for a, b in zip(card_losses, cpu_losses)),
          f"{arch}: reduced losses card {card_losses} != CPU {cpu_losses}")
    worst, compared = 0.0, 0
    for (k, a), (_, b) in zip(card_model.named_parameters(), cpu_model2.named_parameters()):
        live = adam_steady_mask([mu[k] for mu in cpu_mus])
        diff = (a.detach().cpu() - b.detach())[live].abs()
        check(bool((diff <= TRAIN_SMALL_PARAM_ATOL).all()),
              f"{arch}: reduced {k} card != CPU (max diff {float(diff.max())})")
        worst = max(worst, float(diff.max()) if diff.numel() else 0.0)
        compared += int(live.sum())
    return {"arch": cfg.name + " (reduced)", "steps": 2, "losses_card": card_losses,
            "losses_cpu": cpu_losses, "max_abs_param_diff": worst,
            "params_compared": compared, "loss_rtol": TRAIN_SMALL_TOL,
            "param_atol": TRAIN_SMALL_PARAM_ATOL,
            "params_compared_where": "gradient >= 1e-2 x the leaf's largest at both steps"}


# zamba2's published 38 layers on the card against the CPU in float32. The
# two remainder layers (after the sixth shared block), fed one hidden state
# on both, are held within HYBRID_CPU_TOL. The whole model is held within
# HYBRID_SENS_X times the CPU's own response to a rounding-size change of
# its weights (each multiplied by 1 + 2**-24 x N(0, 1)), which the check
# measures: through 38 layers of seeded random weights such a change moves
# the logits by more than 1e-4 of their largest, and a wrong walk moves
# them by their own size.
HYBRID_CPU_TOL, HYBRID_SENS_X, HYBRID_CPU_PROMPT, HYBRID_CPU_DECODE = 1e-4, 4.0, 64, 2


def _rel(got: dict, want: dict) -> dict:
    """{entry: max |got - want| / max |want|} over float entries; integer
    entries must be equal."""
    out = {}
    for k, w in want.items():
        if not w.is_floating_point():
            check(torch.equal(got[k], w), f"{k}: integer entries differ")
            continue
        out[k] = float((got[k] - w).abs().max()) / (float(w.abs().max()) or 1.0)
    return out


def hybrid_card_vs_cpu(dev, cfg) -> dict:
    """zamba2 at its published 38 layers, float32, one seeded model on the
    card and the same weights on the CPU (the plain path). The whole model:
    a 64-token sequence's forward logits, its prefill and 2 decode steps,
    and every cache entry (the remainder layers' SSM states and conv among
    them), held within HYBRID_SENS_X x the CPU's response to rounding-size
    weight changes, entry by entry at the worst. The remainder alone: layers
    36 and 37 walked as a prefill from one seeded hidden state, then one
    decode step each, on both: outputs, SSM states and conv states within
    HYBRID_CPU_TOL of their largest magnitude."""
    import copy

    from repro_torch.models import blocks as B
    from repro_torch.models import ssm
    from repro_torch.models.layers import apply_norm
    from repro_torch.models.lm import forward, init_params
    from repro_torch.serve.engine import decode_step, init_cache, prefill

    f32 = replace(cfg, dtype="float32")
    every = f32.attn_every
    tail = list(range((f32.n_layers // every) * every, f32.n_layers))
    check(len(tail) == 2, f"{cfg.name}: {len(tail)} layers after the last shared block, not 2")
    card = init_params(f32, torch.Generator(device=dev).manual_seed(FAMILY_SEED + 4), 1, dev)
    host = copy.deepcopy(card).to("cpu")
    nudged = copy.deepcopy(host)
    g = torch.Generator().manual_seed(FAMILY_SEED + 5)
    with torch.no_grad():
        for p in nudged.parameters():
            p.mul_(1 + 2.0**-24 * torch.randn(p.shape, generator=g))
    n = HYBRID_CPU_PROMPT + HYBRID_CPU_DECODE
    toks = torch.randint(0, f32.vocab_size, (1, n), generator=g, dtype=torch.int32)
    x0 = torch.randn((1, HYBRID_CPU_PROMPT, f32.d_model), generator=g)
    xt = torch.randn((1, 1, f32.d_model), generator=g)

    def run(model, device):
        t = toks.to(device)
        with torch.no_grad():
            outs = {"forward": forward(f32, model, {"tokens": t[:, :HYBRID_CPU_PROMPT]})[0]}
            cache = init_cache(f32, 1, n + 1, device)
            outs["prefill"] = prefill(f32, model, t[:, :HYBRID_CPU_PROMPT], cache)
            for i in range(HYBRID_CPU_DECODE):
                j = HYBRID_CPU_PROMPT + i
                outs[f"decode_{i + 1}"] = decode_step(f32, model, cache, t[:, j:j + 1])
            outs.update({f"cache_{k}": v for k, v in cache.items()})
            x, xd = x0.to(device), xt.to(device)  # the remainder alone
            for i in tail:
                p = model.layers[i]
                x, h, conv = B.apply_mamba_block(f32, p, x)
                y, h1, conv1 = ssm.ssm_decode_step(f32, p.ssm, apply_norm(f32, p.ln1, xd), h,
                                                   conv)
                xd = xd + y
                outs.update({f"tail{i}_prefill_out": x, f"tail{i}_ssm_h": h,
                             f"tail{i}_conv": conv, f"tail{i}_decode_out": xd,
                             f"tail{i}_decode_ssm_h": h1, f"tail{i}_decode_conv": conv1})
        return {k: v.float().cpu() if v.is_floating_point() else v.cpu() for k, v in outs.items()}

    (got, card_s), (want, cpu_s) = timed(lambda: run(card, dev)), timed(lambda: run(host, "cpu"))
    sens = _rel(run(nudged, "cpu"), want)
    del card, host, nudged
    rel = _rel(got, want)
    whole = {k: v for k, v in rel.items() if not k.startswith("tail")}
    alone = {k: v for k, v in rel.items() if k.startswith("tail")}
    bound = HYBRID_SENS_X * max(v for k, v in sens.items() if not k.startswith("tail"))
    check(max(alone.values()) <= HYBRID_CPU_TOL,
          f"{cfg.name}: the remainder layers on the card != the CPU within {HYBRID_CPU_TOL}: "
          f"{alone}")
    check(max(whole.values()) <= bound,
          f"{cfg.name}: card != CPU at 38 layers past {HYBRID_SENS_X} x the rounding "
          f"sensitivity {bound / HYBRID_SENS_X:.3g}: {whole}")
    return {"n_layers": f32.n_layers, "remainder_layers": tail,
            "prompt_tokens": HYBRID_CPU_PROMPT, "decode_steps": HYBRID_CPU_DECODE,
            "max_rel_diff_whole": whole, "cpu_rounding_sensitivity": {
                k: v for k, v in sens.items() if not k.startswith("tail")},
            "whole_bound": bound, "max_rel_diff_remainder_alone": alone,
            "remainder_tolerance": HYBRID_CPU_TOL,
            "whole_within_1e-4": max(whole.values()) <= HYBRID_CPU_TOL,
            "card_s": card_s, "cpu_s": cpu_s}


def phase_lm_family(dev, phase: str) -> dict:
    """One of the ssm, hybrid and audio families at its published config
    (FAMILY_PHASES), bf16 compute, weights from a seeded generator.

    Serving: one sequence, 16 decode steps after a prefill == a prefill of
    the same tokens within FAMILY_CONSIST_TOL (rwkv and zamba2: a prefill of
    4,080 tokens, a multiple of 16, so the blocked WKV and the chunked SSD
    run; whisper: prompt + 16 tokens on the same frames); the batch's
    prefill (profiled: device operations, idle share) and sampled decode
    steps; every logit finite; no ChaCha launch. One layer's scan against
    its recurrence (`family_scan_check`). Training: float32 masters, remat
    sqrt, batches from the secure pipeline (cut to FAMILY_TRAIN_CUT past
    TRAIN_PEAK_LIMIT): secure gradients == plain and a secure step == a
    plain step bit for bit from one seeded state; every loss and gradient
    finite (zamba2's a_log, dt_bias and in_proj among them); ChaCha launches
    per secure step 1 (whisper 2: the frames); a profiled step; the kernel
    on the ingest wire (and the frames) == plain bit for bit against its
    bound; the reduced model card == CPU after two steps."""
    from dataclasses import asdict

    from repro_torch.configs import get_config
    from repro_torch.kernels.chacha20 import kernel as ck
    from repro_torch.kernels.kmeans import kernel as kk
    from repro_torch.models.lm import _remat_groups

    t_phase = time.perf_counter()
    spec = FAMILY_PHASES[phase]
    cfg = get_config(spec["arch"])
    fields = asdict(cfg)
    check(all(fields[k] == v for k, v in spec["published"].items()),
          f"{phase}: not the published {spec['arch']} config")
    ck.launches = kk.launches = 0  # the path: serving, then training
    card_vs_cpu = hybrid_card_vs_cpu(dev, cfg) if cfg.family == "hybrid" else None
    serve = _family_serve(dev, cfg, spec)
    batch, seq = spec["train"]
    batch_cut = None
    train, plain, ingest = _family_train_at(dev, cfg, batch, seq)
    if train["peak_memory_bytes"] > TRAIN_PEAK_LIMIT:
        batch_cut = {"from": [batch, seq], "peak_bytes": train["peak_memory_bytes"]}
        batch, seq = FAMILY_TRAIN_CUT
        train, plain, ingest = _family_train_at(dev, cfg, batch, seq)
    launches = {"chacha20": train["path_launches"], "kmeans_assign": kk.launches}
    check(launches["kmeans_assign"] == 0, f"{phase}: the k-means kernel ran")
    chacha = {"tokens": ingest_crypt(dev, plain["tokens"], ingest, 0, 20)}
    if "frames" in plain:
        chacha["frames"] = ingest_crypt(dev, plain["frames"], ingest, 1 << 16, 20)
    del plain
    secure_s = float(np.median(train["step_s"]["secure"]))
    plain_s = float(np.median(train["step_s"]["plain"]))
    tokens = batch * seq
    flops = family_train_flops(cfg, batch, seq)
    small = family_train_small(dev, spec["arch"])
    out = {"phase": phase, "arch": cfg.name, "config": "full (published)",
           "family": cfg.family, "dtype": cfg.dtype, "param_dtype": "float32",
           "n_layers": cfg.n_layers, "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "serve": serve, "card_vs_cpu": card_vs_cpu,
           "train": {**train, "batch_cut": batch_cut, "remat": cfg.remat,
                     "remat_groups": _remat_groups(cfg, cfg.n_layers),
                     "step_ms": 1e3 * secure_s, "plain_step_ms": 1e3 * plain_s,
                     "secure_over_plain": secure_s / plain_s,
                     "tokens_per_s": tokens / secure_s, "flops": flops,
                     "step_bound_ms": 1e3 * flops["total"] / PEAK_BF16_S,
                     "step_bound_by": "operations", "chacha": chacha,
                     "secure_equals_plain": True, "reduced": small},
           "peak_memory_bytes": max(serve["serve_peak_memory_bytes"],
                                    train["peak_memory_bytes"]),
           "launches": launches, "phase_s": time.perf_counter() - t_phase}
    emit(out)
    return out


# paper: the paper's evaluation script (`python -m repro_torch.kmeans_secure`)
# on the card; its fit held against the same fit on the CPU
PAPER_TOL = 1e-4


def phase_paper(dev):
    """`repro_torch.kmeans_secure.main(device="cuda")` whole: the secure fit
    of 20,000 x 2 points, K = 10, on a one-shard mesh of the card (both
    kernels launched, counted from 0 just before), the cluster sweep and
    the paging cliff (host code); the fit's n_iter, rounds and dispatches
    equal the same fit's on the CPU and its centres within PAPER_TOL; the
    virtual times and overheads of the sweep and the paged bytes as printed;
    the script's printed lines."""
    from repro_torch import kmeans_secure
    from repro_torch.core.kmeans import generate_points
    from repro_torch.kernels.chacha20 import kernel as ck
    from repro_torch.kernels.kmeans import kernel as kk

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    ck.launches = kk.launches = 0
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        res, secs = timed(lambda: kmeans_secure.main(device="cuda"))
    launches = {"chacha20": ck.launches, "kmeans_assign": kk.launches}
    check(res["device"] == "cuda" and launches["chacha20"] > 0 and launches["kmeans_assign"] > 0,
          f"paper: the script's fit did not run both kernels on the card ({launches})")
    pts, true_centers = generate_points(kmeans_secure.N_POINTS, kmeans_secure.K,
                                        d=kmeans_secure.D, seed=kmeans_secure.SEED,
                                        spread=kmeans_secure.SPREAD)
    (card, fit_s), (cpu, cpu_s) = (timed(lambda d=d: kmeans_secure.convergence(
        pts, true_centers, torch.device(d))) for d in ("cuda", "cpu"))
    rounds = ("n_iter", "n_rounds_dispatched", "n_dispatches")
    check(all(res["convergence"][k] == card[k] == cpu[k] for k in rounds),
          f"paper: rounds differ, card {[card[k] for k in rounds]} CPU {[cpu[k] for k in rounds]}")
    diff = float(np.abs(card["centers"] - cpu["centers"]).max())
    check(diff <= PAPER_TOL and np.array_equal(card["centers"], res["convergence"]["centers"]),
          f"paper: card centres != CPU centres within {PAPER_TOL} ({diff})")
    conv = {k: v for k, v in res["convergence"].items() if k != "centers"}
    out = {"phase": "paper", "script": "python -m repro_torch.kmeans_secure",
           "script_s": secs, "convergence": conv, "fit_card_s": fit_s, "fit_cpu_s": cpu_s,
           "card_vs_cpu": {"rounds_equal": True, "max_abs_diff_centers": diff,
                           "tolerance": PAPER_TOL},
           "overheads": res["overheads"], "paging": res["paging"],
           "printed": printed.getvalue().splitlines(), "launches": launches,
           "phase_s": time.perf_counter() - t_phase}
    emit(out)
    return out


# lm_dense, lm_moe_shared: glm4-9b (GQA with 2 KV heads, the gated dense MLP)
# and qwen2-moe-a2.7b (60 routed experts top-4 padded to 64 over 8 virtual
# shards, 4 shared experts as one of hidden 5,632, a secure exchange) at
# their published configs, bf16, seeded weights; served only: neither
# model's float32 Adam state fits one card. lm_mqa, lm_vlm: granite-20b
# (multi-query attention, one KV head; 55.7 GB of bf16 weights) and
# chameleon-34b (the vlm family's qk_norm; 67.5 GB): their float32 weights
# do not fit one card, so their float32 consistency runs at the published
# widths with the depth cut to `consist_layers`, and their batch is reckoned
# from bytes before any prefill (`serve_batch`)
PUBLISHED_PHASES = {
    "lm_dense": {"arch": "glm4-9b", "shards": 1, "secure": False, "batch": 8,
                 "prompt": 4096, "decode": 64,
                 "published": {"family": "dense", "n_layers": 40, "d_model": 4096,
                               "n_heads": 32, "n_kv_heads": 2, "d_ff": 13696,
                               "vocab_size": 151552}},
    "lm_moe_shared": {"arch": "qwen2-moe-a2.7b", "shards": 8, "secure": True, "batch": 8,
                      "prompt": 4096, "decode": 64,
                      "published": {"family": "moe", "n_layers": 24, "d_model": 2048,
                                    "n_heads": 16, "n_kv_heads": 16, "moe_d_ff": 1408,
                                    "n_experts": 60, "n_experts_per_tok": 4,
                                    "n_shared_experts": 4, "shared_d_ff": 5632,
                                    "capacity_factor": 1.25, "vocab_size": 151936}},
    "lm_mqa": {"arch": "granite-20b", "shards": 1, "secure": False, "batch": 8,
               "prompt": 4096, "decode": 64, "consist_layers": 4,
               "published": {"family": "dense", "n_layers": 52, "d_model": 6144,
                             "n_heads": 48, "n_kv_heads": 1, "d_ff": 24576,
                             "vocab_size": 49152}},
    "lm_vlm": {"arch": "chameleon-34b", "shards": 1, "secure": False, "batch": 8,
               "prompt": 4096, "decode": 64, "consist_layers": 4,
               "published": {"family": "vlm", "n_layers": 48, "d_model": 8192,
                             "n_heads": 64, "n_kv_heads": 8, "d_ff": 22016,
                             "vocab_size": 65536, "qk_norm": True}},
}
ENTRY_ALLOCATED_MAX = 1e9  # bytes a big model's phase may find allocated at its entry
SERVE_MARGIN = 4e9  # bytes of the card kept free past a reckoned batch


def serve_batch(cfg, weight_bytes: int, prompt: int, smax: int, free: float,
                start: int = 8) -> tuple:
    """(batch, the reckoning): halved from `start` until the weights and,
    per sequence, the KV cache, the prefill's float32 score chunk three
    times over (its bf16 product, its float32 copy and the softmax's output
    and bf16 cast), the activations of one layer (residual, norms and
    projections at six widths of d_model, the gated MLP's three of d_ff, in
    bf16) and two float32 logit rows fit `free` less SERVE_MARGIN."""
    kv = 2 * cfg.n_layers * smax * cfg.n_kv_heads * cfg.head_dim * 2
    chunk = min(cfg.attn_chunk or prompt, prompt)
    scores = 3 * cfg.n_heads * chunk * prompt * 4
    acts = prompt * (6 * cfg.d_model + 3 * cfg.d_ff) * 2
    per_seq = kv + scores + acts + 2 * cfg.padded_vocab * 4
    budget = free - SERVE_MARGIN
    b = start
    while b > 1 and weight_bytes + b * per_seq > budget:
        b //= 2
    need = weight_bytes + b * per_seq
    check(need <= budget, f"{cfg.name}: one sequence does not fit: {need:.4g} bytes reckoned, "
          f"{budget:.4g} free")
    return b, {"weight_bytes": weight_bytes, "kv_bytes_per_sequence": kv,
               "score_bytes_per_sequence": scores, "activation_bytes_per_sequence": acts,
               "free_bytes": free, "margin_bytes": SERVE_MARGIN, "reckoned_bytes": need,
               "batch": b}


def release_card() -> dict:
    """Before a big model: drop the job service's process-wide runner cache
    (its graph captures) if one is held, collect, return the cached blocks;
    the bytes still allocated (asserted under ENTRY_ALLOCATED_MAX) and the
    card's free bytes."""
    from repro_torch.serve import service

    cache = service._default_cache
    held = cache is not None
    if held:
        cache.clear()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    allocated = torch.cuda.memory_allocated()
    check(allocated < ENTRY_ALLOCATED_MAX,
          f"{allocated} bytes still allocated at a big model's entry")
    free, total = torch.cuda.mem_get_info()
    return {"allocated_bytes": allocated, "free_bytes": free, "total_bytes": total,
            "runner_cache_released": held}


@contextlib.contextmanager
def _routing_recorded(e_pad: int, dev):
    """Inside: the tokens each expert slot is routed (the MoE's `_route`,
    every layer's, summed on the card) and the tokens the shuffle dropped
    (`moe_apply`'s count), both as device tensors in the yielded dict."""
    from repro_torch.models import moe as moe_mod

    rec = {"per_expert": torch.zeros((e_pad,), dtype=torch.int64, device=dev),
           "dropped": torch.zeros((), dtype=torch.int64, device=dev)}
    route, apply = moe_mod._route, moe_mod.moe_apply

    def routed(cfg, router_w, x2, e, bias=None):
        gates, eidx, aux = route(cfg, router_w, x2, e, bias)
        rec["per_expert"] += torch.bincount(eidx.reshape(-1).long(), minlength=e_pad)
        return gates, eidx, aux

    def applied(*args, **kwargs):
        y, aux, dropped = apply(*args, **kwargs)
        rec["dropped"] += dropped.to(torch.int64)
        return y, aux, dropped

    moe_mod._route, moe_mod.moe_apply = routed, applied
    try:
        yield rec
    finally:
        moe_mod._route, moe_mod.moe_apply = route, apply


def phase_lm_published(dev, phase: str) -> dict:
    """glm4-9b (lm_dense), qwen2-moe-a2.7b (lm_moe_shared), granite-20b
    (lm_mqa) or chameleon-34b (lm_vlm) at its published config
    (PUBLISHED_PHASES, asserted field by field), bf16 compute, weights from a
    seeded generator. A big model (`consist_layers` in its spec) starts from
    a released card (`release_card`), holds its float32 consistency that
    many layers deep and reckons its batch from bytes before any prefill
    (`serve_batch`). One sequence in float32: the 16th decode step
    after a prefill of 4,080 tokens == a prefill of the 4,096 within
    FAMILY_CONSIST_TOL of the largest logit (qwen2-moe with a capacity that
    drops no token: a prefill at the published 1.25 drops tokens that decode
    never drops, so there the two are measured, not held); in bf16
    measured. The batch: 8 x 4,096 prompt tokens (cut to 4 past
    LM_PEAK_LIMIT), then 64 sampled decode steps, every logit finite, no
    ChaCha launch in decode; qwen2-moe's prefill secure, 4 ChaCha launches
    a layer, plain and secure in turns equal bit for bit (logits and KV
    cache), every token routed to one of the 60 real experts (the 4 padding
    experts receive none), the kernel on one leg's wire == plain against
    its bytes bound; glm4's prefill launches no ChaCha. Prefill ms and
    prompt tokens/s, the prefill's device operations and idle share, decode
    ms per step, a profiled step's idle share and device operations, peak
    memory, the prefill's operations bound and the step's bytes bound."""
    from dataclasses import asdict

    from repro_torch import VirtualMesh
    from repro_torch.configs import get_config, get_shape
    from repro_torch.core.shuffle import record_wire_bytes
    from repro_torch.kernels.attention import kernel as ak
    from repro_torch.kernels.chacha20 import kernel as ck
    from repro_torch.kernels.kmeans import kernel as kk
    from repro_torch.kernels.moe import kernel as mk
    from repro_torch.models.lm import init_params
    from repro_torch.models.moe import _capacity, padded_experts
    from repro_torch.serve.engine import decode_step, init_cache, prefill
    from repro_torch.serve_lm import sample
    from repro_torch.tools.roofline import model_flops, param_counts

    t_phase = time.perf_counter()
    spec = PUBLISHED_PHASES[phase]
    cfg = get_config(spec["arch"])
    fields = asdict(cfg)
    check(all(fields[k] == v for k, v in spec["published"].items()),
          f"{phase}: not the published {spec['arch']} config")
    moe, shards, vocab = cfg.family == "moe", spec["shards"], cfg.vocab_size
    mesh = VirtualMesh(shards, dev)
    sec = _secure_cfg() if spec["secure"] else None
    e_pad = padded_experts(cfg, shards) if moe else 0
    big = "consist_layers" in spec  # weights too large for float32, or for the old batch rule
    entry = release_card() if big else None
    ck.launches = kk.launches = 0  # the path

    # 1. one sequence, decode after prefill == prefill, in float32 first (a
    # big model's at the published widths, `consist_layers` deep)
    f32 = replace(cfg, dtype="float32", n_layers=spec.get("consist_layers", cfg.n_layers))
    m32 = init_params(f32, torch.Generator(device=dev).manual_seed(FAMILY_SEED), shards, dev)
    consist = {}
    if moe:
        consist["float32_published_capacity"] = family_consistency(dev, f32, spec, m32, mesh)
        f32 = replace(f32, capacity_factor=e_pad / cfg.n_experts_per_tok)
    consist["float32"] = family_consistency(dev, f32, spec, m32, mesh)
    consist["float32"].update(tolerance=FAMILY_CONSIST_TOL, n_layers=f32.n_layers,
                              capacity_factor=f32.capacity_factor if moe else None)
    check(consist["float32"]["rel_diff"] <= FAMILY_CONSIST_TOL,
          f"{cfg.name}: float32 decode after prefill != prefill ({consist['float32']})")
    del m32
    torch.cuda.empty_cache()

    # 2. the bf16 model and the batch
    torch.cuda.reset_peak_memory_stats()
    model, init_s = timed(lambda: init_params(
        cfg, torch.Generator(device=dev).manual_seed(FAMILY_SEED), shards, dev))
    param_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    consist["bfloat16"] = family_consistency(dev, cfg, spec, model, mesh)
    batch, batch_cut, tp, n_dec = spec["batch"], None, spec["prompt"], spec["decode"]
    smax = tp + n_dec + 2
    reckoning = None
    if big:  # the batch from bytes, before any prefill
        torch.cuda.empty_cache()
        batch, reckoning = serve_batch(cfg, param_bytes, tp, smax,
                                       torch.cuda.mem_get_info()[0] + param_bytes, batch)
    g = torch.Generator(device=dev).manual_seed(FAMILY_SEED + 1)

    def setup(b):
        toks = torch.randint(0, vocab, (b, tp), generator=g, device=dev, dtype=torch.int32)
        return toks, init_cache(cfg, b, smax, dev)

    def run_prefill(secure=sec):
        return prefill(cfg, model, prompts, cache, mesh=mesh, secure_moe=secure)

    def first_prefill():
        before, attn_before, moe_before = ck.launches, ak.launches, moe_launches(mk)
        with record_wire_bytes() as recs, _routing_recorded(max(e_pad, 1), dev) as routed:
            lg, s = timed(run_prefill)
        return (lg, s, ck.launches - before, recs, routed, ak.launches - attn_before,
                moe_launches(mk, moe_before))

    prompts, cache = setup(batch)
    lg_first, first_s, launches, recs, routed, attn_launches, moe_prefill = first_prefill()
    if not big and torch.cuda.max_memory_allocated() > LM_PEAK_LIMIT:
        batch_cut = {"from": batch, "peak_bytes": torch.cuda.max_memory_allocated()}
        batch = 4
        del cache, prompts, lg_first
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        prompts, cache = setup(batch)
        lg_first, first_s, launches, recs, routed, attn_launches, moe_prefill = first_prefill()
    check(bool(torch.isfinite(lg_first[:, :vocab]).all()), f"{cfg.name}: non-finite prefill logits")
    check(attn_launches == cfg.n_layers,
          f"{cfg.name}: {attn_launches} attention launches in a prefill, not {cfg.n_layers}")
    moe_layers = cfg.n_layers if moe else 0
    check(moe_prefill == {"moe_dispatch": moe_layers, "moe_combine": moe_layers},
          f"{cfg.name}: {moe_prefill} MoE kernel launches in a prefill, not {moe_layers} each")
    runs = {"plain": [], "secure": []}
    if moe:
        check(launches == 4 * cfg.n_layers,
              f"{cfg.name}: {launches} ChaCha launches in a secure prefill, not "
              f"{4 * cfg.n_layers}")
        check(len(recs) == 2 * cfg.n_layers and all(r["secure"] for r in recs),
              f"{cfg.name}: {len(recs)} wire records in a secure prefill")
        per_expert = routed["per_expert"].cpu()
        check(int(per_expert[cfg.n_experts:].sum()) == 0
              and int(per_expert.sum()) == cfg.n_layers * batch * tp * cfg.n_experts_per_tok,
              f"{cfg.name}: tokens routed to the padding experts ({per_expert.tolist()})")
        kv_first = cache["k"].clone()
        for name in ("plain", "secure", "secure", "plain"):
            lg, s = timed(lambda: run_prefill(sec if name == "secure" else None))
            runs[name].append(s)
            check(torch.equal(lg, lg_first), f"{cfg.name}: {name} prefill logits != the first "
                  "secure prefill's, bit for bit")
        check(torch.equal(cache["k"], kv_first), f"{cfg.name}: plain KV cache != secure")
        del kv_first
    else:
        check(launches == 0 and not recs, f"{cfg.name}: a dense prefill ran the shuffle")
        runs["plain"] = [timed(run_prefill)[1] for _ in range(2)]
    pre_lg, pre_ms, pre_busy, pre_top, pre_ops = _profile_ops(run_prefill)
    check(torch.equal(pre_lg, lg_first), f"{cfg.name}: profiled prefill logits differ")
    prefill_s = min(runs["secure"] or runs["plain"])

    # 3. sampled decode steps from the prompt's cache
    before, moe_before = ck.launches, moe_launches(mk)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    lg = lg_first
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_dec):
        lg = decode_step(cfg, model, cache, sample(lg, vocab, 0.8, g), mesh=mesh)
        ok &= torch.isfinite(lg[:, :vocab]).all()
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    check(bool(ok), f"{cfg.name}: non-finite decode logits")
    check(ck.launches == before, f"{cfg.name}: decode launched the ChaCha kernel")
    check(not any(moe_launches(mk, moe_before).values()),
          f"{cfg.name}: decode launched the MoE kernels")
    kv_len = int(cache["pos"][0])
    nxt = sample(lg, vocab, 0.8, g)
    _, dec_ms, dec_busy, dec_top, dec_ops = _profile_ops(
        lambda: decode_step(cfg, model, cache, nxt, mesh=mesh))
    peak = torch.cuda.max_memory_allocated()
    flops = (lm_prefill_flops(cfg, batch, tp, shards) if moe
             else family_prefill_flops(cfg, batch, tp))
    dec_bytes = lm_decode_bytes(model, cfg, batch, kv_len)
    kv_bytes = 2 * cache["k"].numel() * cache["k"].element_size()
    del cache, model, lg, lg_first, pre_lg
    torch.cuda.empty_cache()
    total, active = param_counts(cfg)
    shape = replace(get_shape("prefill_32k"), seq_len=tp, global_batch=batch)
    res = {"phase": phase, "arch": cfg.name, "config": "full (published)",
           "family": cfg.family, "dtype": cfg.dtype, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
           "vocab": vocab, "shards": shards, "secure": bool(sec),
           "param_counts": {"total": total, "active": active},
           "param_bytes": param_bytes, "kv_cache_bytes": kv_bytes, "init_s": init_s,
           "consistency": consist, "batch": batch, "prompt_tokens": tp, "decode_steps": n_dec,
           "reduced": {"batch_cut": batch_cut, **({
               "batch": [spec["batch"], batch, "reckoned from bytes before any prefill: "
                         "the weights, and per sequence the KV cache, the float32 score "
                         "chunk and the activations (`serve_batch`)"],
               "float32_consistency_layers": [cfg.n_layers, f32.n_layers, "float32 weights "
                                              "of the full depth do not fit one card"]}
               if big else {})},
           "entry": entry, "batch_reckoning": reckoning,
           "first_prefill_s": first_s, "prefill_s_runs": runs, "prefill_ms": 1e3 * prefill_s,
           "prompt_tokens_per_s": batch * tp / prefill_s,
           "profiled_prefill_ms": pre_ms, "prefill_device_busy_ms": pre_busy,
           "prefill_device_idle_share": None if pre_busy is None else 1 - pre_busy / pre_ms,
           "prefill_device_ops": pre_ops, "prefill_top_device_ops": pre_top,
           "prefill_flops": flops, "prefill_bound_ms": 1e3 * flops["total"] / PEAK_BF16_S,
           "prefill_bound_by": "operations", "prefill_model_flops": model_flops(cfg, shape),
           "decode_ms_per_step": 1e3 * decode_s / n_dec,
           "decode_tokens_per_s": batch * n_dec / decode_s, "decode_kv_len": kv_len,
           "profiled_decode_step_ms": dec_ms, "decode_device_busy_ms": dec_busy,
           "decode_device_idle_share": None if dec_busy is None else 1 - dec_busy / dec_ms,
           "decode_device_ops": dec_ops, "decode_top_device_ops": dec_top,
           "decode_step_bytes": dec_bytes, "decode_bound_ms": 1e3 * dec_bytes / PEAK_BYTES_S,
           "decode_bound_by": "bytes", "peak_memory_bytes": peak,
           "chacha_launches_per_prefill": launches, "chacha_launches_per_decode": 0,
           "attention_launches_per_prefill": attn_launches, "attention_launches_per_decode": 0,
           "moe_launches_per_prefill": moe_prefill, "moe_launches_per_decode": 0,
           "launches": {"chacha20": ck.launches, "kmeans_assign": kk.launches}}
    check(kk.launches == 0, f"{phase}: the k-means kernel ran")
    if moe:
        cap = _capacity(cfg, batch * tp // shards, e_pad)
        gen = torch.Generator(device=dev).manual_seed(17)
        send = torch.randint(-2**15, 2**15, (shards, shards, e_pad // shards * cap, cfg.d_model),
                             dtype=torch.int16, device=dev, generator=gen).view(torch.bfloat16)
        crypt = wire_crypt(dev, {"x": send}, 5, 0)
        del send
        leg_bytes = recs[0]["wire_bytes"] * shards
        check(crypt["wire_bytes"] == leg_bytes, f"{phase}: the timed wire is not a leg's wire")
        res.update(experts_padded=e_pad, capacity_per_expert=cap,
                   tokens_per_expert=per_expert.tolist(), padding_experts_tokens=0,
                   dropped_tokens_per_prefill=int(routed["dropped"]),
                   wire_bytes_per_prefill=sum(r["wire_bytes"] for r in recs) * shards,
                   wire_bytes_per_leg=leg_bytes, chacha=crypt,
                   plain_prefill_ms=1e3 * min(runs["plain"]),
                   secure_over_plain=prefill_s / min(runs["plain"]), secure_equals_plain=True)
    res["phase_s"] = time.perf_counter() - t_phase
    emit(res)
    return res


# hillclimb_lm: cells A, B and C of `repro_torch.launch.hillclimb`, measured
# on the card; their abstract counts at the same shapes come from one
# process started with the script, which counts them on `meta` (~0.5 ms an
# operation on the host: minutes in all) one host thread at low priority
HILLCLIMB_PLAN_WAIT_S = 300  # at most, past the card's own measurement
HILLCLIMB_PLAN_ORDER = "BCA"  # cheapest first; A's batch cuts come last
ABSTRACT_KEYS = ("flops", "bytes_accessed", "device_ops", "kernel_calls", "fits_one_card")


def start_hillclimb_plan(tmpdir: str) -> tuple:
    """(process, report path, log): `hillclimb.run_lm_cell(cell,
    plan=True)` for B, C and A in turn, each row written as it is counted,
    with no card visible."""
    out = os.path.join(tmpdir, "plan.json")
    log = open(os.path.join(tmpdir, "plan.log"), "w")
    code = ("import os, torch; os.nice(10); torch.set_num_threads(1)\n"
            "from repro_torch.launch import hillclimb as h\n"
            f"r = {{}}\nfor c in {HILLCLIMB_PLAN_ORDER!r}:\n"
            f"    h.run_lm_cell(c, plan=True, results=r, path={out!r})\n")
    env = dict(os.environ, PYTHONPATH=SRC, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen([sys.executable, "-c", code], env=env, cwd=ROOT, stdout=log,
                            stderr=subprocess.STDOUT)
    return proc, out, log


def stop_process(plan: tuple) -> None:
    proc, _, log = plan
    if proc.poll() is None:
        proc.kill()
    proc.wait()
    log.close()


def _plan_rows(plan: tuple, keys: set, deadline: float) -> dict:
    """The planned abstract rows once `keys` are all in the report (the
    process is then stopped: it goes on to batches the card did not cut
    to) or the process has ended; past `deadline` what is there."""
    proc, out, log = plan
    rows = {}
    while True:
        done = proc.poll() is not None
        try:
            with open(out) as f:
                rows = json.load(f)
        except (OSError, ValueError):  # not written yet, or mid-write
            pass
        if done or keys <= set(rows) or time.perf_counter() > deadline:
            break
        time.sleep(1.0)
    if proc.poll() is None:
        proc.kill()
        proc.wait()
    else:
        log.flush()
        if proc.returncode != 0:
            with open(log.name) as f:
                check(False, f"the hillclimb plan failed (rc {proc.returncode}): "
                      f"{f.read()[-1500:]}")
    return rows


def phase_hillclimb_lm(dev, plan: tuple) -> dict:
    """Hillclimb cells A, B and C on the card (`hillclimb.measure_lm_cell`:
    one warm-up, the median of 3 steps, host clock to a synchronise), each
    variant beside its abstract counts at the measured shape (from the
    plan process, `start_hillclimb_plan`). A: rwkv6-1.6b training at 4 x
    4,096, the batch halved until every variant's step fits (reckoned from
    one at batch 1), the scan and the blocked WKV beside it at 4 x 64, plain
    batches, 0 ChaCha launches; B: qwen2-moe-a2.7b decode at a
    32,768-token context, v0-v2 on float32 weights and v3 on bf16 (half
    their bytes), 0 launches; C: granite-moe-3b-a800m training at 4 x 1,024
    with secure ingest: 1 + 8 launches a layer under save_shuffle (v0 too:
    it inherits save_shuffle from the config), each equal to its abstract
    count plus the ingest; more under the full MoE remat (x0: the backward
    replays the forward's exchange), equal to its abstract count too; 1 for
    the plain exchange (v3); v4 runs v1's program, and their difference is
    the noise reading. Every variant's step ran (no NO_FIT row), every loss
    and logit finite."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.chacha20 import kernel as ck
    from repro_torch.kernels.kmeans import kernel as kk
    from repro_torch.launch import hillclimb as hc

    t_phase = time.perf_counter()
    entry = release_card()
    ck.launches = kk.launches = 0  # the path
    cells = {}
    for cell in hc.CELLS:
        before = ck.launches
        rows, secs = timed(lambda cell=cell: hc.measure_lm_cell(cell, dev))
        cells[cell] = {"arch": hc.CELLS[cell]["arch"], "phase_s": secs,
                       "chacha_launches": ck.launches - before,
                       "variants": {f"{v}|{shape}": r for (v, shape), r in rows.items()}}
    t_wait = time.perf_counter()
    planned = _plan_rows(plan, {hc.lm_key(cell, *k.split("|")[::-1]) for cell, c in
                                cells.items() for k in c["variants"]},
                         t_wait + HILLCLIMB_PLAN_WAIT_S)
    plan_wait = time.perf_counter() - t_wait
    for cell, c in cells.items():
        for key, r in c["variants"].items():
            check(r["status"] == "OK", f"hillclimb {cell} {key}: {r['status']} {r.get('reckoning')}")
            v, shape = key.split("|")
            a = planned.get(hc.lm_key(cell, shape, v), {}).get("abstract")
            check(a is not None, f"hillclimb {cell} {key}: no abstract count at its shape")
            r["abstract"] = {
                **{k: a[k] for k in ABSTRACT_KEYS}, "wire_bytes": a["collectives"]["wire_bytes"],
                "params_bytes": a["memory"]["params_bytes"],
                "peak_per_device": a["memory"]["peak_per_device"],
                "roofline": {k: a["roofline"][k] for k in ("compute_s", "memory_s",
                                                          "collective_s", "dominant")}}
            finite = r.get("losses_finite", r.get("logits_finite"))
            check(finite, f"hillclimb {cell} {key}: non-finite loss or logits")

    for cell in "AB":
        n = {k: r["chacha_launches_per_step"] for k, r in cells[cell]["variants"].items()}
        check(not any(n.values()), f"hillclimb {cell}: ChaCha launched {n}")
    b = {k.split("|")[0]: r for k, r in cells["B"]["variants"].items()}
    check(2 * b["v3_bf16_serve_params"]["param_bytes"] == b["v0_tp_baseline"]["param_bytes"],
          "hillclimb B: bf16 serving weights are not half the float32 ones")
    c = {k.split("|")[0]: r for k, r in cells["C"]["variants"].items()}
    layers = get_config(hc.CELLS["C"]["arch"]).n_layers
    want = {"v0_secure_shuffle_paper_faithful": 1 + 8 * layers,
            "v1_secure_save_shuffle_remat": 1 + 8 * layers,
            "v2_secure_saveshuf_bf16_scores": 1 + 8 * layers, "v3_plain_saveshuf_bf16": 1,
            "v4_secure_saveshuf_no_expert_fsdp": 1 + 8 * layers}
    got = {v: r["chacha_launches_by_step"] for v, r in c.items()}
    x0 = set(got["x0_secure_full_moe_remat"])
    check(all(set(got[v]) == {n} for v, n in want.items()) and len(x0) == 1
          and min(x0) > want["v1_secure_save_shuffle_remat"],
          f"hillclimb C: ChaCha launches per step {got}, not {want} (x0 above v1's)")
    want["x0_secure_full_moe_remat"] = min(x0)
    # the abstract run has no ingest: one launch fewer
    abstract_plus_ingest = {v: r["abstract"]["kernel_calls"].get("chacha20_xor_packed", 0) + 1
                            for v, r in c.items()}
    check(abstract_plus_ingest == want,
          f"hillclimb C: abstract ChaCha calls + the ingest {abstract_plus_ingest} != {want}")
    v1, v4 = c["v1_secure_save_shuffle_remat"], c["v4_secure_saveshuf_no_expert_fsdp"]
    launches = {"chacha20": ck.launches, "kmeans_assign": kk.launches}
    check(kk.launches == 0, "hillclimb_lm: the k-means kernel ran")
    out = {"phase": "hillclimb_lm", "entry": entry, "cells": cells,
           "chacha_launches_per_step_C": want,
           "chacha_abstract_plus_ingest_C": abstract_plus_ingest, "plan_wait_s": plan_wait,
           "noise_C_v4_minus_v1_ms": v4["step_ms"] - v1["step_ms"],
           "noise_C_rel": (v4["step_ms"] - v1["step_ms"]) / v1["step_ms"],
           "launches": launches, "phase_s": time.perf_counter() - t_phase}
    emit(out)
    return out


# serve: chunk sizes fixed per kind, so every job of a kind replays one runner
SERVE_COLD_N, SERVE_SMALL_N, SERVE_CHUNK, SERVE_GREP_CHUNK = 3_000_000, 2_500_000, 2, 4
_HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch",
                      "cudaMemcpyAsync", "cudaMemsetAsync")


def phase_serve(dev, tokens_np, tokens, pts_np):
    """The secure job service on 8 virtual shards, one shared RunnerCache,
    max_concurrent=3: a cold k-means job (3,000,000 of the main path's points,
    bucket 4,194,304), warm ones of 4,194,304 and 2,500,000 points (0 misses,
    no new capture; the full one equal to kmeans_fit bit for bit), then
    k-means, sort and grep together, then the same three one at a time on a
    fresh service sharing the cache (all warm; equal bit for bit; sort ==
    np.sort, grep == numpy)."""
    from repro_torch import VirtualMesh
    from repro_torch.core import driver
    from repro_torch.core.kmeans import kmeans_fit, paper_threshold
    from repro_torch.kernels.chacha20 import kernel as ck
    from repro_torch.kernels.kmeans import kernel as kk
    from repro_torch.serve import RunnerCache, SecureJobService
    from repro_torch.tools.opcount import spans

    points = torch.from_numpy(pts_np).to(dev)
    values_np = np.random.default_rng(SORT_SEED).lognormal(0.0, 1.0, SORT_N).astype(np.float32)
    values = torch.from_numpy(values_np).to(dev)
    patterns = np.random.default_rng(GREP_SEED).choice(
        np.arange(63, 4096), GREP_PATTERNS, replace=False).astype(np.int32)
    want_hits = np.bincount(tokens_np, minlength=VOCAB)[patterns].astype(np.float32)
    mesh = VirtualMesh(SHARDS, dev)
    cfg = _secure_cfg()
    cache = RunnerCache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ck.launches = kk.launches = 0

    def km(n):
        return ("kmeans", (points[:n], K), {"max_rounds": MAX_ITER, "min_chunk": SERVE_CHUNK,
                                             "max_chunk": SERVE_CHUNK})

    mix = [km(N_POINTS),
           ("sort", (values,), {"max_rounds": SORT_ROUNDS, "balance": SORT_BALANCE,
                                "min_chunk": SERVE_CHUNK, "max_chunk": SERVE_CHUNK}),
           ("grep", (tokens, patterns), {"n_rounds": GREP_ROUNDS, "min_chunk": SERVE_GREP_CHUNK,
                                         "max_chunk": SERVE_GREP_CHUNK})]

    chunk_s = {}  # id(handle) -> host seconds of each of its chunks

    def serve(jobs, max_concurrent=3):
        """Submit `jobs` to a fresh service on the shared cache; (handles, results)."""
        with spans.recording() as recorded, \
                SecureJobService(mesh, secure=cfg, cache=cache,
                                 max_concurrent=max_concurrent) as svc:
            hs = [getattr(svc, "submit_" + kind)(*a, **kw) for kind, a, kw in jobs]
            results = [h.result(timeout=600) for h in hs]
        for h in hs:
            chunk_s[id(h)] = [t1 - t0 for name, t0, t1, attrs in recorded
                              if name == "service.chunk" and attrs["job"] == h.job_id]
        return hs, results

    def job(h, r):
        rounds = r.get("n_iter", r.get("rounds"))
        run_s = h.finished_at - h.started_at
        return {"kind": h.kind, "n": h.n, "bucket": h.bucket, "round_base": h.round_base,
                "misses": h.runner_misses, "chunks": h.chunks, "rounds": rounds,
                "latency_s": h.latency_s, "queue_s": h.queue_s, "chunk_s": chunk_s[id(h)],
                "after_chunks_s": run_s - sum(chunk_s[id(h)]),  # the result's copy back
                "ms_per_round": 1e3 * run_s / rounds}

    (hc,), (rc,) = serve([km(SERVE_COLD_N)])
    check(hc.bucket == N_POINTS and not hc.warm, "the cold job's bucket / misses")
    captures = cache.captures()
    warm_h, warm_r = [], []
    for n in (N_POINTS, SERVE_SMALL_N):
        (h,), (r,) = serve([km(n)])
        check(h.warm and cache.captures() == captures, f"the warm {n}-point job captured")
        warm_h.append(h)
        warm_r.append(r)
    eager = kmeans_fit(points, K, mesh, secure=cfg, max_iter=MAX_ITER,
                       rounds_per_dispatch=ROUNDS_PER_DISPATCH)
    check(np.array_equal(warm_r[0]["centers"], eager.centers.cpu().numpy())
          and warm_r[0]["n_iter"] == eager.n_iter, "served k-means != kmeans_fit")
    # two warm jobs in one profiler session: the first pays the tracer's
    # start-up on the host; the second's run time is the window, and the
    # device busy time is half the session's (the same job twice)
    prof, busy_ms, top = _profiled(lambda: [serve([km(N_POINTS)]) for _ in range(2)])
    ph = prof[1][0][0]
    check(all(np.array_equal(p[1][0]["centers"], warm_r[0]["centers"]) for p in prof),
          "profiled job differs")

    together_h, together_r = serve(mix, 3)
    serial_h, serial_r = serve(mix, 1)
    check(all(h.warm for h in serial_h), "a serial job was not warm")
    for a, b in zip(together_r, serial_r):
        check(a.keys() == b.keys() and all(np.array_equal(np.asarray(a[k]), np.asarray(b[k]))
                                           for k in a), "together != serial")
    check(np.array_equal(serial_r[1]["sorted"].view(np.uint32),
                         np.sort(values_np, kind="stable").view(np.uint32)),
          "served sort != np.sort")
    check(np.array_equal(serial_r[2]["counts"], want_hits), "served grep != numpy")
    # the serve path's launches, by profiler (the graphs' kernels never pass
    # through the wrappers' counters), over an all-warm serial run
    _, names = _device_events(lambda: serve(mix, 1))
    rounds = {h.kind: r.get("n_iter", r.get("rounds")) for h, r in zip(serial_h, serial_r)}
    launches = {"chacha20": sum("chacha20" in n for n, _ in names),
                "kmeans_assign": sum("kmeans_assign_kernel" in n for n, _ in names)}
    check(launches["chacha20"] == 2 * sum(rounds.values())
          and launches["kmeans_assign"] == rounds["kmeans"],
          f"serve path launches {launches} for rounds {rounds}")
    wrapper_launches = {"chacha20": ck.launches, "kmeans_assign": kk.launches}
    peak = torch.cuda.max_memory_allocated()
    km_view = cache.view(spec_id=("kmeans", K, D, N_POINTS), mesh=mesh, secure=cfg)
    km_inputs = {"p": points, "w": torch.ones((N_POINTS,), device=dev)}
    km_init = {"c": points[:K].clone(),
               "thr": torch.full((), paper_threshold(points), device=dev)}
    chunk_by_kind = {"kmeans": chunk_times(driver, km_view, SERVE_CHUNK, km_inputs, km_init)}
    chunk_by_kind["kmeans"].update(copy_figures(driver, km_view, mesh, km_inputs, km_init))
    cap = SORT_N // SHARDS
    lo, hi = float(values_np.min()), float(values_np.max())
    span = max(hi - lo, 1e-6)
    edges = np.asarray(lo + span * np.arange(SHARDS + 1) / SHARDS, np.float32)
    edges[-1] = hi + 1e-3 * span
    chunk_by_kind["sort"] = chunk_times(driver, cache.view(
        spec_id=("sort", SHARDS, cap, float(SORT_BALANCE), "sharded", SORT_N), mesh=mesh,
        secure=cfg), SERVE_CHUNK, {"v": values},
        {"edges": torch.from_numpy(edges).to(dev),
         "sorted": torch.full((SHARDS, SHARDS * cap), torch.inf, device=dev),
         "counts": torch.zeros((SHARDS,), device=dev),
         "total": torch.full((), float(SORT_N), device=dev)})
    chunk_by_kind["grep"] = chunk_times(driver, cache.view(
        spec_id=("grep", patterns.tobytes(), N_TOKENS // SHARDS // GREP_ROUNDS, None, N_TOKENS),
        mesh=mesh, secure=cfg), SERVE_GREP_CHUNK, {"t": tokens},
        {"hits": torch.zeros((GREP_PATTERNS,), device=dev),
         "cursor": torch.zeros((), dtype=torch.int64, device=dev)})
    res = {"phase": "serve", "shards": SHARDS, "max_concurrent": 3,
           "cold": job(hc, rc), "warm": [job(h, r) for h, r in zip(warm_h, warm_r)],
           "warm_equals_kmeans_fit": True,
           "profiled_warm_job": {"latency_s": [p[0][0].latency_s for p in prof],
                                 "device_busy_ms": None if busy_ms is None else busy_ms / 2,
                                 "device_idle_share": None if busy_ms is None else
                                 1 - busy_ms / 2 / (1e3 * (ph.finished_at - ph.started_at)),
                                 "top_device_ops": top},
           "together": [job(h, r) for h, r in zip(together_h, together_r)],
           "serial": [job(h, r) for h, r in zip(serial_h, serial_r)],
           "together_equals_serial": True, "sort_equals_numpy": True,
           "grep_equals_numpy": True,
           "ms_per_round": {h.kind: job(h, r)["ms_per_round"]
                            for h, r in zip(serial_h, serial_r)},
           "cache": cache.stats(),
           "runners": [{"kind": k[0][0], "bucket": k[0][-1], "n_rounds": k[-1],
                        "pool_bytes": r.pool_bytes}
                       for k, r in zip(cache.keys(), cache._resident())],
           "chunk_by_kind": chunk_by_kind, "launches_by_profiler": launches,
           "wrapper_launches": wrapper_launches, "peak_memory_bytes": peak}
    emit(res)
    return res


def chunk_times(driver, view, n_rounds, inputs, init):
    """A warm chunk of a served kind's cached runner, called directly from
    its first round: host ms per chunk (to a synchronise; the least of four
    calls made in turns with the eager chunk's) and per executed round
    beside the eager chunk's (equal bit for bit), synchronising calls, host
    launch calls and device operations."""
    from torch.profiler import ProfilerActivity, profile

    runner = view.get_or_build(n_rounds, lambda: None)
    check(isinstance(runner, driver._GraphRunner), "no captured runner in the cache")
    eager = driver._EagerRunner(runner.spec, runner.mesh, runner.secure, n_rounds,
                                runner.coalesce)
    runner(inputs, init, 0)
    want = eager(inputs, init, 0)
    graph_s, eager_s = [], []
    for first, second in ((runner, eager), (eager, runner)) * 2:  # in turns
        for fn in (first, second):
            out_, secs = timed(lambda: fn(inputs, init, 0))
            (graph_s if fn is runner else eager_s).append(secs)
            if fn is runner:
                out = out_
    secs, eager_secs = min(graph_s), min(eager_s)
    check(out[3:] == want[3:] and all(torch.equal(a, b) for a, b in zip(
        driver.tree_flatten(out[:3])[0], driver.tree_flatten(want[:3])[0])),
        "graph chunk != eager chunk")
    syncs = _count_syncs(lambda: runner(inputs, init, 0))[1]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        runner(inputs, init, 0)
        torch.cuda.synchronize()
    events = prof.events()
    return {"n_rounds": n_rounds, "rounds_executed": out[3], "chunk_ms": 1e3 * secs,
            "ms_per_round": 1e3 * secs / out[3], "eager_chunk_ms": 1e3 * eager_secs,
            "chunk_ms_runs": [1e3 * x for x in graph_s],
            "eager_chunk_ms_runs": [1e3 * x for x in eager_s],
            "equals_eager": True, "syncs_per_chunk": syncs,
            "host_launch_calls_per_chunk": sum(
                any(e.name.startswith(c) for c in _HOST_LAUNCH_CALLS) for e in events
                if e.device_type == torch.autograd.DeviceType.CPU),
            "device_ops_per_chunk": sum(e.device_type == torch.autograd.DeviceType.CUDA
                                        for e in events),
            "pool_bytes": runner.pool_bytes}


def copy_figures(driver, view, mesh, inputs, init):
    """Copy-in (state only; state and inputs) and copy-out ms of a warm chunk
    of the served k-means runner, by CUDA events; the eager round's device
    operations and syncs are in phase crypt_call."""
    from repro_torch.tree import tree_map

    runner = view.get_or_build(SERVE_CHUNK, lambda: None)
    st, = runner._statics.values()
    src = driver.tree_flatten(inputs)[0]
    inp, carried, _ = driver._place(runner.spec, mesh, inputs, init)

    def load_all():
        st._src = []  # as if another job's inputs were resident
        st.load(src, inp, carried)

    load_all()
    return {"copy_in_state_ms": cuda_ms(lambda: st.load(src, inp, carried), 10),
            "copy_in_state_and_inputs_ms": cuda_ms(load_all, 10),
            "copy_out_ms": cuda_ms(lambda: tree_map(torch.clone, st.state), 10)}


# the cost model's accuracy bar: `benchmarks/bench_costmodel.py`'s, unchanged
PRED_ERROR_MAX = 0.5
# per-workload item probes: per-shard sizes, each <= 1/8 of the main path's
CAL_ITEM_SIZES = {"kmeans": (16384, 32768, 65536), "sort": (65536, 131072, 262144),
                  "grep": (16384, 32768, 65536)}
CAL_KNOB_ENVS = ("REPRO_SHUFFLE_COALESCE", "REPRO_CHUNK_GROWTH", "REPRO_STATE_SPECS",
                 "REPRO_BUCKET_GROWTH", "REPRO_SERVICE_MAX_RUNNERS")


def phase_calibrate(dev, pts_np, tokens, fit, srt, grp, srv):
    """The calibrated cost model on the card: a quick calibration on 8
    virtual shards, the `auto` resolvers under it (through
    $REPRO_CALIBRATION) and without it, the main path's k-means, sort and
    grep rounds traced and predicted, and hillclimb cells S and K on it."""
    import tempfile

    from repro_torch import VirtualMesh
    from repro_torch.core import driver, shuffle
    from repro_torch.core.grep import make_grep_spec
    from repro_torch.core.kmeans import make_kmeans_iterative_spec, paper_threshold
    from repro_torch.core.sort import initial_edges, make_sample_sort_spec
    from repro_torch.kernels.chacha20 import kernel as ck
    from repro_torch.kernels.kmeans import kernel as kk
    from repro_torch.launch import hillclimb
    from repro_torch.perf import calibrate, model as perf_model
    from repro_torch.serve import service

    t_phase = time.perf_counter()
    set_knobs = [v for v in CAL_KNOB_ENVS + (calibrate.CALIBRATION_ENV,) if v in os.environ]
    check(not set_knobs, f"knob variables set in the environment: {set_knobs}")
    mesh = VirtualMesh(SHARDS, dev)
    cfg = _secure_cfg()
    points = torch.from_numpy(pts_np).to(dev)
    weights = torch.ones((N_POINTS,), dtype=torch.float32, device=dev)
    values_np = np.random.default_rng(SORT_SEED).lognormal(0.0, 1.0, SORT_N).astype(np.float32)
    values = torch.from_numpy(values_np).to(dev)
    patterns = np.asarray(grp["patterns"], np.int32)
    threshold = paper_threshold(points)

    def kmeans_spec(n_local):
        return make_kmeans_iterative_spec(K, mesh, threshold=threshold)

    def kmeans_inputs(n_local):
        n = n_local * SHARDS
        return {"p": points[:n], "w": weights[:n]}, points[:K].contiguous()

    def sort_spec(n_local):
        return make_sample_sort_spec(mesh, n_local, halt_total=n_local * SHARDS,
                                     balance=SORT_BALANCE, shard_state=True)

    def sort_inputs(n_local):
        v = values[:n_local * SHARDS]
        v_np = values_np[:n_local * SHARDS]
        edges = initial_edges(float(v_np.min()), float(v_np.max()), SHARDS)
        return {"v": v}, {"edges": torch.from_numpy(edges).to(dev),
                          "counts": torch.zeros(SHARDS, device=dev),
                          "sorted": torch.full((SHARDS, SHARDS * n_local), torch.inf,
                                               device=dev)}

    def grep_spec(n_local):
        return make_grep_spec(patterns, n_local, mesh)

    def grep_state():
        return {"hits": torch.zeros(GREP_PATTERNS, device=dev),
                "cursor": torch.zeros((), dtype=torch.int64, device=dev)}

    def grep_inputs(n_local):
        return {"t": tokens[:n_local * SHARDS * GREP_ROUNDS]}, grep_state()

    # kind: (spec at n_local items a shard, its inputs and state, the main
    # path's n_local, the served chunk's rounds)
    kinds = {"kmeans": (kmeans_spec, kmeans_inputs, N_POINTS // SHARDS, SERVE_CHUNK),
             "sort": (sort_spec, sort_inputs, SORT_N // SHARDS, SERVE_CHUNK),
             "grep": (grep_spec, grep_inputs, N_TOKENS // SHARDS // GREP_ROUNDS,
                      SERVE_GREP_CHUNK)}
    torch.cuda.synchronize()
    ck.launches = kk.launches = 0
    t0 = time.perf_counter()
    cal = calibrate.run_calibration(mesh, quick=True)
    generic_s = time.perf_counter() - t0
    # each workload's own item term: its plaintext round at per-shard sizes
    # of at most 1/8 of the main path's, timed as the served chunk runs
    items = {kind: calibrate.probe_workload_items(
        lambda n, spec=spec, rounds=rounds: driver.make_iterative_runner(
            spec(n), mesh, None, n_rounds=rounds),
        make, CAL_ITEM_SIZES[kind], target_items=n_local)
        for kind, (spec, make, n_local, rounds) in kinds.items()}
    cal = replace(cal, items=items)
    cal_s = time.perf_counter() - t0
    consts = {"chacha": cal.chacha, "all_to_all": cal.all_to_all, "dispatch": cal.dispatch,
              "round": cal.round, "compile": cal.compile,
              "items": {k: {f: v[f] for f in ("us_per_item", "base_us")} for k, v in items.items()}}
    numbers = [v for part in consts.values() for e in part.values()
               for v in (e.values() if isinstance(e, dict) else [e])
               if isinstance(v, (int, float)) and not isinstance(v, bool)]
    check(all(np.isfinite(v) and v >= 0 for v in numbers), f"calibration constants {consts}")
    check(cal.key == f"torch-cuda/{torch.cuda.device_count()}" and cal.n_shards == SHARDS,
          f"calibration key {cal.key}, shards {cal.n_shards}")
    cm = perf_model.CostModel(cal)

    def resolved():
        rec = perf_model.recommendation("sort_capacity", bucket=SORT_N, n_shards=SHARDS)
        return {"coalesce": shuffle.resolve_coalesce("auto"),
                "chunk_growth": driver.resolve_chunk_growth(
                    "auto", min_chunk=1, max_rounds=MAX_ITER, max_chunk=ROUNDS_PER_DISPATCH),
                "capacity_factor": driver.resolve_capacity_factor(),
                "bucket_growth": service.resolve_bucket_growth(),
                "max_resident": service.resolve_max_resident("auto"),
                "sort_capacity": SORT_N // SHARDS if rec is None else int(rec)}

    model_answers = {
        "coalesce": cm.recommend("coalesce"),
        "chunk_growth": cm.recommend("chunk_growth", min_chunk=1, max_rounds=MAX_ITER,
                                     max_chunk=ROUNDS_PER_DISPATCH),
        "capacity_factor": cm.recommend("capacity_factor"),
        "bucket_growth": cm.recommend("bucket_growth"),
        "max_resident": (None if cm.recommend("max_resident") == "unbounded"
                         else cm.recommend("max_resident")),
        "sort_capacity": cm.recommend("sort_capacity", bucket=SORT_N, n_shards=SHARDS)}
    defaults = {"coalesce": True, "chunk_growth": 2, "capacity_factor": 2.0,
                "bucket_growth": 2.0, "max_resident": None, "sort_capacity": SORT_N // SHARDS}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "calibration.json")
        calibrate.save_calibration(cal, path)
        os.environ[calibrate.CALIBRATION_ENV] = path
        perf_model.clear_active_model()
        try:
            check(perf_model.active_model().cal == cal, "$REPRO_CALIBRATION loaded another entry")
            under_model = resolved()
        finally:
            del os.environ[calibrate.CALIBRATION_ENV]
            perf_model.clear_active_model()
    check(under_model == model_answers,
          f"resolvers under the calibration {under_model} != the model's {model_answers}")
    without = resolved()
    check(without == defaults, f"resolvers without a calibration {without} != {defaults}")

    # the main path's rounds, traced (one eager round each) and predicted
    # with their own item terms, held to the reference's accuracy bar
    wires = {"kmeans": fit["wire_bytes_per_round_per_shard"],
             "sort": srt["wire_bytes_per_round"] // SHARDS,
             "grep": grp["wire_bytes_per_round"] // SHARDS}
    main_inputs = {"kmeans": ({"p": points, "w": weights}, points[:K].contiguous()),
                   "sort": sort_inputs(SORT_N // SHARDS),
                   "grep": ({"t": tokens}, grep_state())}
    traces = {}
    for kind, (spec, _, n_local, _) in kinds.items():
        inputs, state = main_inputs[kind]
        runner = driver.make_iterative_runner(spec(n_local), mesh, cfg, n_rounds=SERVE_CHUNK)
        tr = perf_model.trace_workload(runner, inputs, state, n_shards=SHARDS,
                                       n_local_items=n_local, items=cal.items[kind])
        wire = wires[kind]
        check(cm.predict_wire_bytes(tr) == wire,
              f"{kind}: predicted wire {cm.predict_wire_bytes(tr)} != the path's record {wire}")
        check(tr.secure and tr.keystream_launches == 2 and tr.collectives == 1,
              f"{kind}: traced round {tr}")
        pred_ms = cm.predict_round_us(tr) / 1e3
        generic_ms = cm.predict_round_us(tr.with_item_us(None)) / 1e3
        measured = srv["chunk_by_kind"][kind]["ms_per_round"]
        err = abs(pred_ms - measured) / measured
        traces[kind] = {"n_local_items": n_local, "device_ops": tr.n_eqns,
                        "wire_bytes_per_shard": tr.wire_bytes,
                        "keystream_launches": tr.keystream_launches,
                        "keystream_blocks": tr.keystream_blocks,
                        "item_us": tr.item_us, "item_probe_sizes": items[kind]["sizes"],
                        "item_probe_round_us": items[kind]["round_us"],
                        "predicted_round_ms": pred_ms, "measured_graph_round_ms": measured,
                        "pred_over_measured": pred_ms / measured, "pred_error": err,
                        "pred_error_max": PRED_ERROR_MAX,
                        "predicted_round_ms_generic": generic_ms,
                        "pred_over_measured_generic": generic_ms / measured,
                        "predicted_capture_s": cm.predict_compile_s(tr),
                        "wire_equals_record": True}
        check(err <= PRED_ERROR_MAX,
              f"{kind}: the cost model's round {pred_ms} ms against the served {measured} ms, "
              f"error {err} > {PRED_ERROR_MAX}")
    del points, weights, values, main_inputs

    cell_s = {}
    for vname, knobs in hillclimb.SERVICE_VARIANTS:
        r = hillclimb.run_service_cell(**knobs)
        cell_s[vname] = {t: {"bucketed_makespan_s": v["bucketed_makespan_s"],
                             "compiles": v["compiles"], "evictions": v["evictions"]}
                         for t, v in r["traces"].items()}
    cell_k = hillclimb.rank_knob_vectors(cm, top=3)
    launches = {"chacha20": ck.launches, "kmeans_assign": kk.launches}
    check(launches["chacha20"] > 0 and launches["kmeans_assign"] >= 1,
          f"calibrate path launches {launches}")
    res = {"phase": "calibrate", "shards": SHARDS, "key": cal.key, "calibration_s": cal_s,
           "generic_calibration_s": generic_s,
           "item_probe_s": {k: v["probe_s"] for k, v in items.items()},
           "constants": consts, "resolved_under_model": under_model,
           "resolved_without": without, "traces": traces, "hillclimb_S": cell_s,
           "hillclimb_K": {"n_vectors": cell_k["n_vectors"], "best": cell_k["best"],
                           "top": cell_k["top"], "resolver_vector": cell_k["resolver_vector"]},
           "launches": launches, "phase_s": time.perf_counter() - t_phase}
    emit(res)
    return res


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: the port's sources are missing ({SRC}/repro_torch)", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    tmpdir = tempfile.mkdtemp(prefix="chip_smoke_")
    plan = start_hillclimb_plan(tmpdir)
    try:
        return _main(plan)
    finally:
        stop_process(plan)
        shutil.rmtree(tmpdir, ignore_errors=True)


def _main(plan: tuple) -> int:
    from repro_torch.core.kmeans import generate_points
    from repro_torch.kernels import _build

    from repro_torch.kernels.attention import kernel as ak

    dev = torch.device("cuda")
    smi = phase_device(_build)
    cha = phase_chacha(dev)
    att = phase_attention(dev)
    moe_k = phase_moe(dev)
    attn_by_path = {}  # the attention kernel's launches on each path from here on
    ak.launches = 0

    def attn_path(name):
        attn_by_path[name] = ak.launches - sum(attn_by_path.values())

    pts_np, _ = generate_points(N_POINTS, K, d=D, seed=0)  # kept for serve and calibrate
    points = torch.from_numpy(pts_np).to(dev)
    freed = {}
    km = phase_kmeans_assign(dev, points.reshape(SHARDS, -1, D), points[:K].contiguous())
    freed["kmeans_assign"] = collect_garbage()
    crypt = phase_crypt_call(dev, points)
    freed["crypt_call"] = collect_garbage()
    fit = phase_kmeans_fit(dev, points)
    freed["kmeans_fit"] = collect_garbage()
    phase_parity_small(dev)
    del points
    freed["parity_small"] = collect_garbage()
    torch.cuda.empty_cache()
    srt = phase_sort(dev)
    freed["sort"] = collect_garbage()
    torch.cuda.empty_cache()
    tokens_np = zipf_tokens(N_TOKENS, VOCAB, TOKEN_SEED)
    tokens = torch.from_numpy(tokens_np).to(dev)
    grp = phase_grep(dev, tokens_np, tokens)
    freed["grep"] = collect_garbage()
    wc = phase_wordcount(dev, tokens_np, tokens)
    freed["wordcount"] = collect_garbage()
    torch.cuda.empty_cache()
    srv = phase_serve(dev, tokens_np, tokens, pts_np)
    freed["serve"] = collect_garbage()
    torch.cuda.empty_cache()
    cal = phase_calibrate(dev, pts_np, tokens, fit, srt, grp, srv)
    del tokens, pts_np
    freed["calibrate"] = collect_garbage()
    torch.cuda.empty_cache()
    attn_path("kmeans_sort_grep_wordcount_serve_calibrate")
    enc = phase_enclave(dev)
    freed["enclave"] = collect_garbage()
    paper = phase_paper(dev)
    freed["paper"] = collect_garbage()
    attn_path("enclave_paper")
    torch.cuda.empty_cache()
    lm = phase_lm_serve(dev)
    freed["lm_serve"] = collect_garbage()
    attn_path("lm_serve")
    torch.cuda.empty_cache()
    tr = phase_lm_train(dev)
    freed["lm_train"] = collect_garbage()
    attn_path("lm_train")
    fam = {}
    for phase in FAMILY_PHASES:
        torch.cuda.empty_cache()
        fam[phase] = phase_lm_family(dev, phase)
        freed[phase] = collect_garbage()
        attn_path(phase)
    pub = {}
    for phase in PUBLISHED_PHASES:
        torch.cuda.empty_cache()
        pub[phase] = phase_lm_published(dev, phase)
        freed[phase] = collect_garbage()
        attn_path(phase)
    torch.cuda.empty_cache()
    hill = phase_hillclimb_lm(dev, plan)
    freed["hillclimb_lm"] = collect_garbage()
    attn_path("hillclimb_lm")
    check(all(attn_by_path[p] == 0 for p in ("kmeans_sort_grep_wordcount_serve_calibrate",
                                              "enclave_paper", "lm_train")),
          f"the attention kernel ran outside a prefill: {attn_by_path}")
    check(all(attn_by_path[p] > 0 for p in ("lm_serve", "lm_hybrid", "lm_audio",
                                             *PUBLISHED_PHASES)),
          f"a prefill path did not launch the attention kernel: {attn_by_path}")
    emit({"phase": "memory", "freed_by_collector_bytes": freed})

    rounds = fit["rounds_executed"]
    wire, big = cha["wire"], cha["64MiB"]
    by_path = {"kmeans": fit["launches"]["chacha20"], "sort": srt["launches"]["chacha20"],
               "grep": grp["launches"]["chacha20"], "wordcount": wc["launches"]["chacha20"],
               "enclave": enc["launches"]["chacha20"],
               "calibrate": cal["launches"]["chacha20"],
               "lm_serve": lm["launches"]["chacha20"],
               "lm_train": tr["launches"]["chacha20"],
               **{phase: res["launches"]["chacha20"] for phase, res in fam.items()},
               "paper": paper["launches"]["chacha20"],
               **{phase: res["launches"]["chacha20"] for phase, res in pub.items()},
               "hillclimb_lm": hill["launches"]["chacha20"]}
    # the dense models' layers have no expert exchange: their paths run no ChaCha
    no_chacha = [p for p, spec in PUBLISHED_PHASES.items() if not spec["secure"]]
    check(all((v == 0) == (p in no_chacha) for p, v in by_path.items()),
          f"a path ran no ChaCha launch, or a dense one ran some: {by_path}")
    emit({"kernels": [
        {"name": "chacha20_xor_packed", "route": "cuda",
         "source": "src/repro_torch/csrc/chacha20.cu",
         "replaces": "src/repro/kernels/chacha20/kernel.py:180",
         "replaces_function": "chacha20_xor_row_lanes",
         "launches": fit["launches"]["chacha20"],
         "launches_by_path": by_path,
         "launches_serve_by_profiler": srv["launches_by_profiler"]["chacha20"],
         "ms_round_dev": wire["kernel_ms_round_dev"],
         "ms_round_dev_64MiB": big["kernel_ms_round_dev"],
         "launches_per_round": {"kmeans": by_path["kmeans"] / rounds,
                                "sort": by_path["sort"] / srt["rounds_executed"],
                                "grep": by_path["grep"] / grp["rounds_executed"],
                                "wordcount": by_path["wordcount"] / 1},
         "ms_sort_wire": srt["chacha"]["kernel_ms"],
         "bound_ms_sort_wire": srt["chacha"]["bound_ms"], "lanes_sort_wire": srt["chacha"]["lanes"],
         "ms_grep_wire": grp["chacha"]["kernel_ms"],
         "bound_ms_grep_wire": grp["chacha"]["bound_ms"], "lanes_grep_wire": grp["chacha"]["lanes"],
         "ms_lm_serve_wire": lm["chacha"]["kernel_ms"],
         "bound_ms_lm_serve_wire": lm["chacha"]["bound_ms"],
         "lanes_lm_serve_wire": lm["chacha"]["lanes"],
         "launches_per_lm_train_step": tr["launches_per_secure_step"][0],
         "ms_lm_train_wire": tr["chacha"]["kernel_ms"],
         "bound_ms_lm_train_wire": tr["chacha"]["bound_ms"],
         "lanes_lm_train_wire": tr["chacha"]["lanes"],
         "launches_per_secure_step_by_family": {
             phase: res["train"]["launches_per_secure_step"][0] for phase, res in fam.items()},
         "ingest_wire": {phase: {name: {k: c[k] for k in ("wire_bytes", "kernel_ms", "bound_ms",
                                                           "bound_by")}
                                 for name, c in res["train"]["chacha"].items()}
                         for phase, res in fam.items()},
         "launches_by_cell_hillclimb_lm": {c: r["chacha_launches"]
                                           for c, r in hill["cells"].items()},
         "launches_per_step_hillclimb_C": hill["chacha_launches_per_step_C"],
         "ms_lm_moe_shared_wire": pub["lm_moe_shared"]["chacha"]["kernel_ms"],
         "bound_ms_lm_moe_shared_wire": pub["lm_moe_shared"]["chacha"]["bound_ms"],
         "lanes_lm_moe_shared_wire": pub["lm_moe_shared"]["chacha"]["lanes"],
         "ms_wordcount_wire": wc["chacha"]["kernel_ms"],
         "bound_ms_wordcount_wire": wc["chacha"]["bound_ms"],
         "lanes_wordcount_wire": wc["chacha"]["lanes"],
         "max_abs_err": 0, "ms": wire["kernel_ms"], "call_ms": wire["call_ms"],
         "crypt_call_ms": crypt["call_ms"], "plain_ms": wire["plain_ms"],
         "bound_ms": wire["bound_ms"], "bound_by": wire["bound_by"],
         "library_ms": None, "shape": "64 rows x 132 blocks",
         "lanes": wire["lanes"], "kernel_ms_lanes4": wire["kernel_ms_lanes4"],
         "kernel_ms_lanes1": wire["kernel_ms_lanes1"],
         "ms_64MiB": big["kernel_ms"], "lanes_64MiB": big["lanes"],
         "kernel_ms_lanes4_64MiB": big["kernel_ms_lanes4"],
         "kernel_ms_lanes1_64MiB": big["kernel_ms_lanes1"],
         "bound_ms_64MiB": big["bound_ms"], "plain_ms_64MiB": big["plain_ms"],
         "xor_copy_ms_64MiB": big["xor_copy_ms"]},
        {"name": "kmeans_assign", "route": "cuda",
         "source": "src/repro_torch/csrc/kmeans.cu",
         "replaces": "src/repro/kernels/kmeans/kernel.py:84",
         "replaces_function": "kmeans_assign_tiles",
         "launches": fit["launches"]["kmeans_assign"],
         "launches_per_round": fit["launches"]["kmeans_assign"] / rounds,
         "launches_by_path": {"kmeans": fit["launches"]["kmeans_assign"],
                              "calibrate": cal["launches"]["kmeans_assign"],
                              "paper": paper["launches"]["kmeans_assign"],
                              **{phase: res["launches"]["kmeans_assign"]
                                 for phase, res in {**fam, **pub}.items()},
                              "hillclimb_lm": hill["launches"]["kmeans_assign"]},
         "launches_serve_by_profiler": srv["launches_by_profiler"]["kmeans_assign"],
         "max_abs_err": km["max_abs_err"], "ms": km["ms"], "plain_ms": km["plain_ms"],
         "bound_ms": km["bound_ms"], "bound_by": km["bound_by"],
         "bound_tc_ms": km["bound_tc_ms"], "bound_tc_by": km["bound_tc_by"],
         "kernel_ms": km["kernel_ms"],
         "library_ms": km["library_ms"], "shape": "8 x 524288 x 64 points, K=256",
         "d128_k1024": {f: km["d128_k1024"][f] for f in (
             "ms", "kernel_ms", "plain_ms", "plain_shards", "library_ms", "bound_ms",
             "bound_by", "bound_tc_ms", "bound_tc_by", "bound_bytes_ms", "max_abs_err")}},
        {"name": "attention_prefill", "route": "cuda",
         "source": "src/repro_torch/csrc/attention.cu",
         "replaces": None,
         "replaces_note": "no Pallas kernel: the JAX package's attention is plain jnp "
                          "code; it replaces the port's chunked score passes in a prefill",
         "bound_by": "operations (tensor cores); the scores stay on chip",
         "launches": lm["attention_launches_per_prefill"],
         "launches_per_prefill_lm_serve": lm["attention_launches_per_prefill"],
         "launches_by_path": attn_by_path,
         **{arch: att[arch] for arch in ATTN_SHAPES}},
        {"name": "moe_dispatch_combine", "route": "cuda",
         "source": "src/repro_torch/csrc/moe.cu",
         "replaces": None,
         "replaces_note": "no Pallas kernel: the JAX package's MoE is plain jnp code; they "
                          "replace the k-fold copy, bucket_pack's value gather and scatter and "
                          "_combine's gathers in a prefill with no gradient",
         "bound_by": "bytes",
         "launches_per_prefill_lm_serve": lm["moe_launches_per_prefill"],
         "launches_per_prefill_lm_moe_shared": pub["lm_moe_shared"]["moe_launches_per_prefill"],
         **{arch: moe_k[arch] for arch in MOE_ARCHS}},
    ]})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
