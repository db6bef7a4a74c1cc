#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure (build, launch, tolerance) ends the run with
a non-zero exit and no result line:

  1. card     the card's name and power limit, and the device count;
  2. build    nvcc builds the five kernels (mriq, flash_attention, swiglu,
              ssd, rglru) for sm_90a from the sources in the checkout, all
              at once, and prints each kernel's registers, shared memory
              and spills, and, from ``cuobjdump -sass``, the tensor-core
              (HMMA/HGMMA) and atomic instructions of each function of the
              three tensor-core kernels (flash_attention, swiglu, ssd:
              each of ssd's bf16 functions must hold HMMA/HGMMA) and of
              rglru (no RED/ATOM in any function of ssd or rglru), and the
              special-function (MUFU) instructions of mriq, which must
              hold some and whose ptxas report must show no stack frame
              and no spills;
  3. kernels  each kernel against its plain PyTorch version on the card, at
              the shapes the main path gives it (mriq also against the
              plain version in f64 at the bound its arithmetic allows
              (ref.mriq_f32_tolerance), at N 262147 / M 3073 and with
              phases up to 2^12 turns, and launched twice and held bit
              for bit; its SFU floor on a log line; flash_attention also at
              recurrentgemma-9b's D=256 with its 2048 window; ssd in bf16
              and f32 at mamba2-1.3b's prefill (S 512, chunk 256) and
              forward (S 520, chunk 130), and in bf16 at its train
              microbatch (1 x 4096, chunk 256), also against the
              token-by-token recurrence; rglru at recurrentgemma-9b's prefill and forward
              S; ssd and rglru launched twice and held bit for bit); plain
              and library times from CUDA events, the kernel's from a CUDA
              graph of its launches replayed (the host's launch cost does
              not bound a short kernel; ssd's also eager), the card's least
              time (bound) and the kernel's share of it; for the bf16
              tensor-core kernels also the library call's error against
              the same plain version (the kernel's may be at most twice
              it), and both swiglu designs timed on either side of their
              switch; flash_attention and swiglu also at every shape
              the seven new archs' paths give them (flash D 64, D 80
              non-causal, D 160 and the groups 48:1, 128:8, 64:8, 16:16 at
              D 128; swiglu at stablelm-12b's, llama3-405b's and
              internvl2-76b's widths, at T 1024 and at a decode step's 2);
              plus reduced qwen2-7b, mamba2-1.3b and recurrentgemma-9b on
              the card (kernels, f32) against the plain path on the CPU;
  4. calibrate the card's idle draw and two kernel windows (swiglu T=1024,
              rglru S 2560) under the NVML sampler, and the energy
              constants solved from them beside the ones ``core.power.H100``
              commits (``repro_torch.benchmarks.calibrate_power``);
  5. models   for each of qwen2-7b, mamba2-1.3b and recurrentgemma-9b at
              full width under the offload plan (every site on the
              kernels), random weights from seeded generators on the card,
              one model at a time:
              Fig. 5   (qwen2-7b's path) the paper's MRI-Q A/B at its size
                       (64^3 voxels, 3072 k-space points) through
                       ``repro_torch.benchmarks.bench_mriq``: the card's name,
                       power limit and energy counter period, its idle
                       draw, the CPU-only leg, the offloaded leg from pinned
                       buffers (H2D + kernel + D2H, each part's median and
                       range over 5 legs), the Fig. 5 rows at the paper's
                       R740 node points and the offloaded leg at the card's
                       measured draw (card-only); its inputs the pattern
                       search's (phiMag formed on the host from phiR, phiI);
              patterns (qwen2-7b's path) the paper's §4 pattern search on
                       MRI-Q measured on the card
                       (``repro_torch.examples.mriq_offload``) at the same
                       size, reusing Fig. 5's CPU-only leg and its card
                       window of the full nest: per-voxel launches over
                       4096 voxels (scaled), device trig with the sums on
                       the host, the full nest, the full nest with phiMag
                       on the card; each (Qr, Qi) held to the CPU-only leg,
                       each new 5-s card window checked; seconds, node and
                       card Ws, fitness, the selected pattern or tie, the
                       reference's model beside; within PATTERN_BUDGET_S;
              prefill  2 x 512 tokens (2 x 2560 for recurrentgemma-9b, past
                       its 2048 window), then 8 decode steps, held against
                       the teacher-forced forward (qwen2-7b for three weight
                       seeds; mamba2-1.3b in f32 compute, its bf16 run held
                       to finite logits, see PREFILL_F32);
              serve    ``ServeLoop`` (8 slots, max_seq 256) billing a
                       ``DecodeEnergyMeter`` at the accelerated R740 node
                       point: 8 requests, 16 new tokens each, every step a
                       replay of the loop's captured decode graph; before
                       the run, from the state after the first request's
                       prompt has filled, GRAPH_STEPS replays held to the
                       eager step on a copy of the cache (logits and every
                       cache tensor bit for bit, else named and within
                       GRAPH_REL), the capture's ms and its pool's bytes;
              offload  (qwen2-7b's path, on the first 7 of its 28 loaded
                       layers, OFFLOAD_LAYERS) the paper's offload search,
                       ``core.adapt`` at prefill_32k_b1: GA and narrowing
                       on the analytic rung, the finalists
                       and the chosen plan's smoke trial measured on the
                       card (wall clock, NVML energy); each finalist's
                       seconds, W, Ws and fitness or its penalty, the chosen
                       plan; fails unless a finalist is confirmed on the
                       measured rung and the chosen plan's trial launched
                       the kernels its genes name; when no finalist runs
                       stock attention (the sharding genes are inert on
                       one card, so the finalists can be kernel plans
                       apart only in them) the arch's plan is measured
                       beside them;
              counts   the kernels' launch counts over that model's path,
                       each kernel of the path > 0;
              fleet    (qwen2-7b's path, on the first 7 of its 28 loaded
                       layers, FLEET_LAYERS, counted as a
                       path of its own: swiglu must launch) Step 7 and the
                       object fleet: (a) the serving CLI's library entry
                       (``repro_torch.launch.serve.run``): 16 requests on
                       two nodes of 8 slots with paced arrivals, teamB's
                       Ws budget (it must be throttled, with zero Ws
                       booked), consolidate-and-gate placement and a
                       governor per node re-verifying on the measured
                       rung; every admitted request finishes, the bills
                       sum to the fleet ledger and its rollups, the
                       attribution conserves each node and the persisted
                       ledger reads back; (b) one governed node whose
                       watts step up 3x partway through serving 8
                       requests: exactly one migration judged, the
                       pending plan and the incumbent each measured on
                       the card at decode_32k_b8 (a 32k cache at batch 8,
                       16 decode steps a call, each a replay of the trial's
                       captured decode step, a 5-s NVML window), neither
                       a penalty; the event and both trials printed, each
                       with its capture's ms and pool bytes;
                       then the ledger and spans of (a) rendered on the
                       host by the port's own readers
                       (``repro_torch.scripts.power_report --ledger`` and
                       ``trace_report --trace --metrics``);
              plans    (qwen2-7b's path, on the first OFFLOAD_LAYERS of
                       its loaded layers, counted as a path of its own: its
                       plans run stock ops) the sharding plan: (a)
                       ``launch.mesh.make_host_mesh()``, the (1, 1) mesh
                       over its own one-rank NCCL group; the rules of the
                       arch's plan and of the three optimized plans
                       resolved over the parameters, a decode_32k_b8
                       cache and every shape's batch, each spec replicated;
                       (b) the arch's plan and ``optimized_plan(arch,
                       "decode")`` (int8 KV cache) measured on that mesh at
                       decode_32k_b8, each trial's decode step captured
                       under the plan's rules and replayed (the capture's
                       ms and pool bytes logged), each NVML window checked,
                       each plan's last logits held to the other's
                       (PREFILL_TOL), and for each plan one replayed call
                       held to one eager call from the same cache state
                       (logits and cache bit for bit, else named and within
                       GRAPH_REL of the tensor's max);
                       (c) a 256-chip, 16-way TP context, which the
                       measured rung must refuse; the group destroyed;
  6. profile  qwen2-7b's 8 requests served again (the graph captured
              before the window), and one bf16 prefill of
              mamba2-1.3b, under torch.profiler: kernels by device time,
              the CUDA runtime calls by host time, and the device's busy
              share of each window;
  7. fleet-scale  the vectorized fleet engines, no model, counted as a path
              of its own (it launches none of the five kernels: its device
              work is stock torch ops): (a) the control plane's torch twins
              on the card against numpy over 300 seeded inputs each, the
              route argmin over 1024 nodes (float-equal marginal and load
              ties; winners exact) and the Erlang-C sweep at the fleet's
              cumulative slots (c_max 4096; rtol 1e-9, atol 1e-12), each
              call timed beside numpy's; (b) the reference's fleet_scale
              shape, 2 x 10^4 seeded diurnal arrivals over 1024 nodes under
              consolidate-and-gate, through vector-seg, vector-torch (the
              booking plane folded on the card) and vector-shard (inline,
              and with worker processes); the numpy arms run in processes
              forked after the card is up, beside the torch arm and (c):
              the same placement events, finished sets and tokens, the
              shard ledgers bit for bit vector-seg's, vector-torch's
              within rtol 1e-12; (c) the reference's fleet_diurnal_1m rung, a simulated
              day (24 h x 2000 steps) of 10^6 arrivals over 1024 nodes
              through ``launch.serve.run_vector`` (--engine vector-torch
              --placement gate, nodes at the H100 envelope) with a flight
              recorder sampling 1 % of the requests and a snapshot each
              hour: every request finishes, the bills sum to the ledger
              (rel 1e-9); wall s, simulated arrivals/s, the fold's device
              ms and H2D ms per chunk (CUDA events), total Ws, the hourly
              powered-node curve and the flight rows;
  8. archs    the seven archs of the MoE / LayerNorm / front-end slice
              (granite-moe-1b-a400m, moonshot-v1-16b-a3b, granite-20b,
              stablelm-12b, llama3-405b, internvl2-76b, hubert-xlarge) at
              their published widths under the offload plan, one arch's
              weights at a time, depth cut only where the published depth
              does not fit in 80 GB (ARCH_LAYERS, logged as "layers L of
              N"): a warm prefill of 2 x 512 tokens at the arch's own
              config; prefill + 8 decode steps against the forward (bf16,
              ARCH_TOL; internvl2-76b's prompt starts with 256 patch
              embeddings); the MoE archs at capacity factor 16 in f32
              (held, MOE_F32_TOL) and bf16 (read, with decode's argmax
              agreement), with the share of assignments each layer drops
              at the published 1.25; granite-moe-1b-a400m also serves 8
              requests as in phase 5; every arch's bf16 offload forward
              over 2 x 512 tokens (hubert-xlarge, an encoder: frames)
              against its f32 stock-op forward (phase_forward: ARCH_TOL,
              or BF16_GAP_SLACK x the stock-op bf16 forward's own error
              where that is larger); each phase's peak device memory, its
              launches (flash_attention on every arch, swiglu too on
              stablelm-12b, llama3-405b and internvl2-76b) and seconds;
  9. train    each autograd Function (flash_attention at D 128 causal and
              at D 256 with the 2048 window, swiglu, ssd in bf16, rglru)
              at a train microbatch's shape (one 4096-token sequence): its
              forward (the kernel) held to the plain version by the
              tolerances above, its gradients to autograd of the plain
              version on the card (bit for bit, else GRAD_REL), the
              kernel's forward, the Function's backward and the plain
              graph's backward timed beside SDPA's / the cuBLAS chain's
              forward and backward (rglru's also the device memory its
              plain version keeps for the backward and its peak); then
              qwen2-7b, mamba2-1.3b and
              recurrentgemma-9b at published width (TRAIN_LAYERS: depth
              cut, logged "layers L of N"), one model's weights at a time:
              the stock plan's first step (loss and gradient norm) in f32
              and bf16, then AdamW steps under the offload plan on
              SyntheticLM batches at train_4k_b4 (TRAIN_STEPS, logged
              "steps S of 4"; the configs' remat="full", microbatches=4)
              through ``train.step.TrainGraph``, the port's jitted step:
              the first step eager and the step's capture as a CUDA graph,
              timed apart with the capture's ms and pool bytes, the later
              steps replays; finite, the first within max(2^-8,
              BF16_GAP_SLACK x the stock bf16 gap) of the f32 stock step,
              with step times and peak memory; the measured rung's train
              trial at train_4k_b4 (its warm-up the capture, each call a
              replay; s, W, Ws a step, its NVML window checked) beside the
              analytic estimate; each path's kernels must launch, counted
              across replays; then, in a child process with deterministic
              algorithms, the graph against the eager step at published
              width (TRAIN_GRAPH_LAYERS, train_4k_b4): from the same seeded
              weights, three ``make_train_step`` steps and three
              ``TrainGraph`` steps (the first eager, then two replays),
              the loss, the gradient norm, every parameter and every
              optimizer-state tensor bit for bit (each that differs
              named), and a replay's launches equal to one eager step's,
              kernel by kernel; then in the same child
              ``launch.train.run`` (the captured step) on tiny-lm (8
              steps, cut from 12 for the run's time, a
              checkpoint every 4, a failure at step 6, a resume): the
              resumed losses equal the uninterrupted run's bit for bit
              and the loss falls;
 10. pod      the pod-scale half, counted as a path of its own (the
              rules steps' launches: flash_attention and swiglu must each
              launch once a layer, microbatch and remat pass in the first
              rules step, and a replay as often), in at most POD_BUDGET_S,
              (a)-(c) under deterministic algorithms: (a) qwen2-7b at
              published width on POD_LAYERS layers, AdamW steps at
              train_4k_b4 under the offload plan with fused_grad_reduce:
              one step without rules, then POD_GRAPH_STEPS steps with
              ``rules`` on ``make_host_mesh()`` (the one-rank NCCL group;
              parameters and AdamW state as DTensors at the plan's
              placements, each shard the whole on one rank; every layer
              kind through the tensor-parallel regions of ``parallel.tp``,
              which must be the route each kind ran, the kernels inside on
              the local tensors), eagerly, and as many through
              ``TrainGraph(model, rules)`` (the first eager with the
              capture, then replays) from the same seed: the first rules
              step's loss and gradient norm held to the step without rules
              (bit for bit, else the gap printed and held under 2^-8
              relative); the graph's steps to the eager rules steps bit
              for bit (loss, gradient norm, every local shard of the
              parameters and the state), a replay launching what an eager
              step launches; the collectives an eager rules step and the
              graph's first call issue (``CommDebugMode``), the capture's
              ms and pool bytes; (b) ``train.compress.compressed_psum`` on
              a CUDA tensor over that group, within one quantization step
              of its input; (c) the graph's first layer's DTensor
              attention and norm parameters saved and restored onto the
              mesh's placements, bit for bit;
              then on the host, the card idle, in a child process: (d)
              the compiled rung (``core.backends.CompiledBackend``): one
              trial of qwen2-7b at full depth, decode_32k on pod16x16 (the
              pod dry run over a fake 256-rank group), its stage times,
              seconds and Ws at the R740 CPU-node envelope; (e) its
              roofline row on the H100 spec (``core.roofline``); (f)
              ``core.adapt`` Steps 4-5 over slices of 64, 128, 256 and 512
              chips on the analytic rung at train_4k (POD_COST, an
              operator's assumption), and the best slice's placement.

Every window sampled from the card's NVML energy counter must agree with
the counter's own difference over it within 5 %.  Kernel phase 3 also times
flash_attention and swiglu at qwen2-7b's 32k-token prefill, beside their
bounds (their plain versions are held at the shapes above).  It exits
non-zero when no CUDA device is visible, and when the port's package is
not beside it.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import contextlib
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

#: the card's published peaks (NVIDIA H100 SXM data sheet, dense, at 700 W)
PEAK_BF16 = 989e12      # FLOP/s, tensor cores
PEAK_F32 = 67e12        # FLOP/s, CUDA cores
PEAK_BYTES = 3.35e12    # B/s, HBM3

#: one bf16 rounding, f32 sums in another order: rtol 2^-8 (bf16's 8-bit
#: mantissa) + atol 1e-5
BF16_TOL = (1e-5, 2.0 ** -8)
#: the bf16 flash and swiglu kernels run on the tensor cores and round one
#: intermediate to bf16 before the second product, as the library calls
#: do: P (each weight moves by at most 2^-9 of itself and the weights sum
#: to 1, so o moves by at most 2^-9 max|v|) and a (y moves by at most
#: 2^-9 (|a| @ |wo|)).  Held against the plain version in f32 on the same
#: bf16 inputs at that bound + BF16_TOL, and at most 2x the library call's
#: error against the same plain version.
ROUND = 2.0 ** -9
#: f32 sums of many products in another order on the tensor cores, as a
#: share of the sum of |products|, up to a sum over qwen2-7b's f (18944
#: products); a deeper sum takes more accumulation steps, each of which may
#: lose up to a unit in the last place, so its share grows in proportion.
#: The second product's readings on the H100 at T=1024: 6.5e-7 at f 18944,
#: 1.47e-6 at llama3-405b's f 53248 (PERF.md)
SUM_ORDER = 2.0 ** -20
SUM_DEPTH = 18944


def sum_order(k: int) -> float:
    """The sum-order allowance of a sum over ``k`` products."""
    return SUM_ORDER * max(1.0, k / SUM_DEPTH)


FLASH_TOL_TEXT = ("atol 2^-9 max|v| + 1e-5 + rtol 2^-8, vs the plain "
                  "version in f32")
SWIGLU_TOL_TEXT = ("atol 2^-9 (|a| @ |wo|) + 1e-5 + rtol 2^-8, vs the plain "
                   "version in f32; a and y = a @ wo each at atol 2^-20 "
                   "max(1, K/18944) sum|products| + 1e-5 + rtol 2^-8")
#: the bf16 kernels' error may be at most this multiple of the library's
LIBRARY_ERR_FACTOR = 2.0

#: prefill + decode against the full forward, as a share of max|logit|:
#: about 3x the largest reading on H100 runs (PERF.md, section 6: 0.0159,
#: 0.0086 in f32, 0.0179)
PREFILL_TOL = {"qwen2-7b": 0.045, "mamba2-1.3b": 0.025,
               "recurrentgemma-9b": 0.05}
#: archs whose check runs in f32 compute: mamba2-1.3b's random-init stack
#: amplifies last-bit differences through its 48 layers, so in bf16 its
#: prefill + decode and its forward (SSD chunks of 256 and of 130) part
#: completely (0.88 of max|logit| on the H100 and on the CPU's plain
#: path), while in f32 they agree (0.0086 on the H100).  Its bf16 run, the
#: config's plan that serving uses, is held to finite logits.
PREFILL_F32 = ("mamba2-1.3b",)
#: weight seeds of qwen2-7b's prefill check; its serve phase uses the first
PREFILL_SEEDS = (0, 1, 2)
#: prompt length of each model's prefill check: recurrentgemma-9b's runs
#: past its 2048 local-attention window
PREFILL_LEN = {"qwen2-7b": 512, "mamba2-1.3b": 512,
               "recurrentgemma-9b": 2560}

SOURCES = {
    "mriq": ("src/repro_torch/kernels/csrc/mriq.cu",
             "src/repro/kernels/mriq.py:44"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:71"),
    "swiglu": ("src/repro_torch/kernels/csrc/swiglu.cu",
               "src/repro/kernels/swiglu.py:43"),
    "ssd": ("src/repro_torch/kernels/csrc/ssd.cu",
            "src/repro/kernels/ssd.py:58"),
    "rglru": ("src/repro_torch/kernels/csrc/rglru.cu",
              "src/repro/kernels/rglru.py:40"),
}
#: mriq, ssd and rglru: no single PyTorch call computes the same function
NO_LIBRARY = "none: no single PyTorch call computes it"
#: the offload plan: every compute site on its kernel (bench_power.py)
OFFLOAD = dict(attn_impl="pallas", mlp_impl="pallas", ssm_impl="pallas",
               rglru_impl="pallas")
#: the kernels each model's path must launch: the three models' paths,
#: then the seven archs' phases (ARCH_LAYERS)
PATH_KERNELS = {"qwen2-7b": ("mriq", "flash_attention", "swiglu"),
                "mamba2-1.3b": ("ssd",),
                "recurrentgemma-9b": ("flash_attention", "rglru"),
                "granite-moe-1b-a400m": ("flash_attention",),
                "moonshot-v1-16b-a3b": ("flash_attention",),
                "granite-20b": ("flash_attention",),
                "stablelm-12b": ("flash_attention", "swiglu"),
                "llama3-405b": ("flash_attention", "swiglu"),
                "internvl2-76b": ("flash_attention", "swiglu"),
                "hubert-xlarge": ("flash_attention",)}
#: the whole run's wall-time hold, under a 900-s call on the card: a new
#: on-card phase pays for its time with a logged cut of depth, steps or
#: repetitions
RUN_HOLD_S = 840.0
#: the three models driven through serving, Fig. 5, the search and the fleet
MODEL_PATHS = ("qwen2-7b", "mamba2-1.3b", "recurrentgemma-9b")
#: the seven archs of the MoE / LayerNorm / front-end slice at their
#: published widths: the layers on the card, and where the published depth
#: does not fit in 80 GB beside its activations, why it is cut (layers
#: only; no cut config is registered)
ARCH_LAYERS = {
    "granite-moe-1b-a400m": (24, ""),
    "moonshot-v1-16b-a3b": (24, "48 layers hold 112 GB of f32 weights"),
    "granite-20b": (26, "52 layers hold 81.3 GB of f32 weights"),
    "stablelm-12b": (40, ""),
    "llama3-405b": (6, "126 layers hold 812 GB of bf16 weights"),
    "internvl2-76b": (12, "80 layers hold 282 GB of f32 weights"),
    "hubert-xlarge": (48, ""),
}
#: the dense archs' bf16 prefill and decode against the forward, and each
#: arch's bf16 offload forward against its f32 stock-op forward (the floor
#: of phase_forward's limits), as a share of max|logit|: the CPU twins'
#: bf16 rule (tests/test_torch_model.py)
ARCH_TOL = 0.05
#: phase_forward: the offload forward's error against the f32 stock-op
#: forward, at the median and the worst position, may be this multiple of
#: the stock-op bf16 forward's own (the CPU twins' rule for the MoE archs
#: takes the reference's bf16 gap as the limit; the kernels' roundings
#: flip other router near-ties, so the worst position differs by some
#: per cent either way)
BF16_GAP_SLACK = 1.25
#: the MoE archs' f32 prefill and decode against the forward (at capacity
#: factor 16): mamba2-1.3b's f32 tolerance (PREFILL_TOL)
MOE_F32_TOL = 0.025
#: the MoE archs are held at this capacity factor: token-choice capacity is
#: not causal, so with drops a prefill and a longer forward route
#: differently (tests/test_decode_consistency.py raises it the same way)
MOE_HELD_FACTOR = 16.0


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` back-to-back calls,
    CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` calls captured in one CUDA
    graph and replayed, CUDA events: the card's time for the launches,
    without the host's time to make them (a wrapper's Python and launch
    cost would otherwise bound a kernel shorter than it)."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()          # warm-up off the capture, as
    side.wait_stream(torch.cuda.current_stream())   # torch.cuda.graphs asks
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, peak: float, nbytes: float) -> dict:
    """The card's least time in ms for the work (the larger of its
    operations at ``peak`` and its bytes at the HBM rate), what bounds it,
    and which peak the operations were held to."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": by,
            "bound_peak": {PEAK_BF16: "bf16 989 TFLOP/s",
                           PEAK_F32: "f32 67 TFLOP/s"}[peak]}


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check(name: str, got, want, atol: float, rtol: float) -> float:
    err = max_err(got, want)
    if not torch.isfinite(got.float()).all():
        raise RuntimeError(f"{name}: non-finite output")
    excess = float(((got.float() - want.float()).abs()
                    - (atol + rtol * want.float().abs())).max())
    if excess > 0:
        atol_s = f"{atol}" if isinstance(atol, float) else "(per element)"
        raise RuntimeError(f"{name}: max_err {err:.3e} over atol {atol_s} + "
                           f"rtol {rtol}*|plain|")
    return err


def check_library(name: str, err: float, lib_err: float) -> None:
    """A bf16 tensor-core kernel's error against the plain f32 version may
    be at most LIBRARY_ERR_FACTOR times the library call's."""
    if err > LIBRARY_ERR_FACTOR * lib_err:
        raise RuntimeError(f"{name}: max_err {err:.3e} over "
                           f"{LIBRARY_ERR_FACTOR} x the library's "
                           f"{lib_err:.3e}")


# ---------------------------------------------------------------------------
# phase 1-2
# ---------------------------------------------------------------------------


def phase_card() -> dict:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    card = {"smi": smi.splitlines()[0],
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}
    log(f"[card] {card['smi']} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {card['kind']} x{card['count']}")
    return card


#: the kernels whose bf16 instance runs on the tensor cores
TENSOR_CORE = ("flash_attention", "swiglu", "ssd")
#: functions (by a part of their name) that must each hold a tensor-core
#: instruction: ssd's bf16 functions
TC_FUNCTIONS = {"ssd": "_tc"}
#: functions (by parts of their name; "" for all) whose sums must hold no
#: atomic instruction
NO_ATOMICS = {"swiglu": ("gemm", "combine"), "ssd": ("",), "rglru": ("",)}
#: kernels whose ptxas report must show no stack frame and no spills
NO_SPILLS = ("mriq",)
#: kernels whose SASS must hold special-function-unit (MUFU) instructions
SFU = ("mriq",)


def sass_counts(lib: Path) -> dict | None:
    """Tensor-core (HMMA/HGMMA), atomic (RED/ATOM) and special-function
    (MUFU) instructions in each function of a built library, from
    ``cuobjdump -sass``; None where the toolkit has no cuobjdump."""
    from repro_torch.kernels._build import nvcc
    tool = Path(nvcc()).parent / "cuobjdump"
    if not tool.is_file():
        return None
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    filt = Path(nvcc()).parent / "cu++filt"
    counts: dict = {}
    fn = None
    for line in sass.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ")[1].strip()
            counts[fn] = {"tensor_core": 0, "atomic": 0, "mufu": 0}
        elif fn is not None:
            # "/*0120*/  @P0 HMMA.16816.F32.BF16 R4, ... ;  /* 0x... */"
            m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z]\w*)",
                          line)
            op = m.group(1) if m else ""
            counts[fn]["tensor_core"] += op in ("HMMA", "HGMMA")
            counts[fn]["atomic"] += op.startswith(("RED", "ATOM"))
            counts[fn]["mufu"] += op == "MUFU"
    if filt.is_file():
        names = subprocess.run([str(filt)], input="\n".join(counts),
                               capture_output=True, text=True,
                               timeout=60).stdout.splitlines()
        if len(names) == len(counts):
            counts = dict(zip(names, counts.values()))
    return counts


def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build(SOURCES)
    log(f"[build] {len(logs)} kernels in {time.perf_counter() - t0:.1f} s "
        f"(nvcc, sm_90a)")
    for name, text in logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling")):
                log(f"[build] {name}: {line.strip()}")
            # "8 bytes stack frame, 12 bytes spill stores, 12 bytes spill
            # loads"
            if name in NO_SPILLS and "stack frame" in line and any(
                    int(v) for v in re.findall(r"(\d+) bytes", line)):
                raise RuntimeError(f"{name}: stack frame or spills: "
                                   f"{line.strip()}")
    for name in dict.fromkeys(TENSOR_CORE + tuple(NO_ATOMICS) + SFU):
        counts = sass_counts(_build.library_path(name))
        if counts is None:
            log(f"[build] {name}: no cuobjdump, SASS not read")
            continue
        for fn, c in counts.items():
            log(f"[build] {name} SASS: {c['tensor_core']} HMMA/HGMMA, "
                f"{c['atomic']} RED/ATOM, {c['mufu']} MUFU in {fn[:110]}")
        if name in SFU and not sum(c["mufu"] for c in counts.values()):
            raise RuntimeError(f"{name}: no MUFU instruction in SASS")
        if name in TENSOR_CORE and not sum(
                c["tensor_core"] for c in counts.values()):
            raise RuntimeError(f"{name}: no tensor-core instruction in SASS")
        part = TC_FUNCTIONS.get(name)
        bare = [fn for fn, c in counts.items()
                if part and part in fn and not c["tensor_core"]]
        if bare:
            raise RuntimeError(f"{name}: no tensor-core instruction in {bare}")
        held = [fn for fn, c in counts.items() if c["atomic"] and any(
            w in fn for w in NO_ATOMICS.get(name, ()))]
        if held:
            raise RuntimeError(f"{name}: atomics in {held}")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


#: the SFU's sine/cosine rate assumed for its floor: 16 lanes an SM a
#: clock on 132 SMs at the H100 SXM's 1.98 GHz boost clock
SFU_RATE = 132 * 16 * 1.98e9
MRIQ_DESIGN = ("phase in turns reduced exactly; sin/cos on the SFU (MUFU); "
               "4 voxels a thread, k-space in shared memory; group sums of "
               "96 into Kahan sums")


def mriq_truth(label: str, args, vs_plain: bool = True) -> dict:
    """The kernel against the f32 plain version (atol 5e-4 + rtol 1e-4,
    tests/test_kernels.py's) where ``vs_plain``, and against the f64 plain
    version: elementwise within ``ref.mriq_f32_tolerance`` (derived from
    the kernel's arithmetic), with a max error at most twice the f32 plain
    version's; two launches bit for bit.  Without ``vs_plain`` (large
    phases) the f32 plain version must itself miss f64 by more than that
    tolerance: it rounds 2 pi t of thousands of turns."""
    from repro_torch.kernels import mriq as K, ref
    got = K.mriq_cuda(*args)
    assert_repeats(label, lambda: K.mriq_cuda(*args))
    plain = ref.mriq_ref(*args)
    exact = ref.mriq_ref(*[a.double() for a in args])
    bnd = ref.mriq_f32_tolerance(*args)
    row = {"max_abs_err": None, "f64_max_abs_err": 0.0,
           "plain_f64_max_abs_err": 0.0, "f64_bound_used": 0.0}
    for part, g, p, e in zip(("qr", "qi"), got, plain, exact):
        if vs_plain:
            row["max_abs_err"] = max(row["max_abs_err"] or 0.0, check(
                f"{label} {part}", g, p, 5e-4, 1e-4))
        err = (g.double() - e).abs()
        p_err = float((p.double() - e).abs().max())
        used = float((err / bnd).max())
        if used > 1:
            raise RuntimeError(f"{label} {part}: over the derived f64 bound "
                               f"({used:.3f} of it)")
        if float(err.max()) > 2 * p_err:
            raise RuntimeError(f"{label} {part}: f64 error {err.max():.3e} "
                               f"over twice the plain version's {p_err:.3e}")
        if not vs_plain and p_err <= 5e-4 + 1e-4 * float(e.abs().max()):
            raise RuntimeError(f"{label} {part}: the plain version is within "
                               f"the vs-plain tolerance; hold the kernel to "
                               f"it")
        row["f64_max_abs_err"] = max(row["f64_max_abs_err"], float(err.max()))
        row["plain_f64_max_abs_err"] = max(row["plain_f64_max_abs_err"],
                                           p_err)
        row["f64_bound_used"] = max(row["f64_bound_used"], used)
    del plain, exact, bnd
    log(f"[kernels] {label}: max_err vs f32 plain "
        + ("n/a (the plain version misses f64 by more than the tolerance)"
           if row["max_abs_err"] is None else f"{row['max_abs_err']:.3e}")
        + f"; vs f64 {row['f64_max_abs_err']:.3e} (the f32 plain version's "
        f"{row['plain_f64_max_abs_err']:.3e}; at most "
        f"{row['f64_bound_used']:.3f} of the derived bound); two launches "
        f"bit for bit")
    return row


def kernel_mriq(rows: dict) -> None:
    from repro_torch.kernels import mriq as K, ref
    args = ref.mriq_inputs(0, 64 ** 3, 3072, device="cuda")
    n, m = args[4].shape[0], args[0].shape[0]
    row = mriq_truth(f"mriq N={n} M={m}", args)
    bnd = bound(16.0 * n * m, PEAK_F32, (3 * n + 4 * m + 2 * n) * 4)
    rows["mriq"] = {
        **row, "tol": "atol 0.0005 + rtol 0.0001 vs the f32 plain version; "
        "derived bound (ref.mriq_f32_tolerance) vs the f64 plain version",
        "design": MRIQ_DESIGN,
        "ms": graph_ms(lambda: K.mriq_cuda(*args), reps=10),
        "plain_ms": cuda_ms(lambda: ref.mriq_ref(*args), reps=3),
        **bnd, "library_ms": None, "library": NO_LIBRARY,
        "shape": f"N={n} M={m} f32"}
    floor = 2.0 * n * m / SFU_RATE * 1e3
    log(f"[kernels] mriq: SFU floor {floor:.4f} ms (2 MUFU a pair at 16 "
        f"lanes/SM/clock x 132 SMs x 1.98 GHz, an assumed clock), kernel at "
        f"{floor / rows['mriq']['ms']:.4f} of it; design {MRIQ_DESIGN}")
    del args
    # ragged: N past a whole block, M past whole groups and strides
    args = ref.mriq_inputs(1, 64 ** 3 + 3, 3073, device="cuda")
    rows["mriq"]["ragged"] = mriq_truth("mriq N=262147 M=3073", args)
    # phases up to 2^12 turns: the turn reduction must still hold
    args = ref.mriq_inputs(2, 64 ** 3, 3072, t_max=2.0 ** 12, device="cuda")
    rows["mriq"]["large_phase"] = mriq_truth(
        "mriq N=262144 M=3072 |t| <= 2^12", args, vs_plain=False)


def flash_case(s: int, hq: int, hkv: int, d: int, window: int, seed: int,
               reps: int, causal: bool = True) -> dict:
    from repro_torch.kernels import flash_attention as K, ref
    b = 2
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn((b, s, h, d), generator=g, device="cuda",
                           dtype=torch.float32).to(torch.bfloat16)
               for h in (hq, hkv, hkv))
    got = K.flash_attention_cuda(q, k, v, causal, window)
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(), causal,
                                   window)
    err = check(f"flash_attention D={d}", got, want,
                ROUND * float(v.float().abs().max()) + BF16_TOL[0],
                BF16_TOL[1])
    # library yardstick: SDPA on (B,H,S,D) with the KV heads repeated (and
    # the window as a boolean mask)
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(hq // hkv, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(hq // hkv, dim=2).transpose(1, 2).contiguous()
    pos = torch.arange(s, device="cuda")
    keep = pos[None, :] <= pos[:, None] if causal \
        else torch.ones((s, s), dtype=torch.bool, device="cuda")
    if window:
        keep &= pos[:, None] - pos[None, :] < window

    def sdpa():
        if window:
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep)
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    sdpa_err = max_err(sdpa().transpose(1, 2), want)
    del want
    check_library(f"flash_attention D={d}", err, sdpa_err)
    pairs = int(keep.sum())     # (q, k) pairs the mask keeps
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2
    bnd = bound(4.0 * b * hq * d * pairs, PEAK_BF16, nbytes)
    mask = ("causal" if causal else "non-causal") \
        + (f" window {window}" if window else "")
    return {"max_abs_err": err, "tol": FLASH_TOL_TEXT,
            "design": "mma.sync m16n8k16 bf16, cp.async 2-stage K/V ring, "
                      + ("64 queries x 4 warps" if d <= 128
                         else "128 queries x 8 warps") + ", 64-key tiles",
            "ms": graph_ms(lambda: K.flash_attention_cuda(q, k, v, causal,
                                                          window), reps),
            "plain_ms": cuda_ms(lambda: ref.flash_attention_ref(
                q, k, v, causal, window), reps),
            **bnd,
            "library_ms": cuda_ms(sdpa, reps),
            "library": "F.scaled_dot_product_attention, KV repeated",
            "library_max_abs_err": sdpa_err,
            "shape": f"B={b} S=T={s} Hq={hq} Hkv={hkv} D={d} bf16 {mask}"}


SWIGLU_DESIGNS = {
    "decode": "mma.sync m16n8k16 bf16, 32-row x tiles, 64x64 weight tiles, "
              "cp.async 4 stages, K split over ~8 waves + fixed-order sums",
    "prefill": "wgmma m64n128k16 bf16, both operands by 128B-swizzled "
               "descriptor (weights M-major), dual GEMM 128x128x64 + GEMM "
               "128x128x64, cp.async 4 stages, a in bf16 scratch"}


def mlp_weights(seed: int, d: int = 3584, f: int = 18944):
    """An MLP's weights in bf16 on the card, qwen2-7b's widths (d 3584,
    f 18944) unless given."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(shape, scale):
        return (torch.randn(shape, generator=g, device="cuda") * scale
                ).to(torch.bfloat16)
    return (randn((d, f), d ** -0.5), randn((d, f), d ** -0.5),
            randn((f, d), f ** -0.5), g)


def swiglu_case(t: int, seed: int, d: int = 3584, f: int = 18944) -> dict:
    from repro_torch.kernels import swiglu as K, ref
    wi, wg, wo, g = mlp_weights(seed, d, f)
    d, f = wi.shape
    x = torch.randn((t, d), generator=g, device="cuda").to(torch.bfloat16)
    a_k = torch.empty((t, f), dtype=torch.bfloat16, device="cuda")
    got = K.swiglu_cuda(x, wi, wg, wo, out_a=a_k)
    x32, wi32, wg32, wo32 = (w.float() for w in (x, wi, wg, wo))
    h, gt = x32 @ wi32, x32 @ wg32
    a = F.silu(gt) * h
    # a moves by |silu(g)| dh + |h| |silu'(g)| dg, |silu'| < 1.1
    sums = (F.silu(gt).abs() * (x32.abs() @ wi32.abs())
            + 1.1 * h.abs() * (x32.abs() @ wg32.abs()))
    del wi32, wg32, h, gt
    want = a @ wo32
    err = check(f"swiglu T={t}", got, want,
                ROUND * (a.abs() @ wo32.abs()) + BF16_TOL[0], BF16_TOL[1])
    err_a = check(f"swiglu T={t} a", a_k, a, sum_order(d) * sums
                  + BF16_TOL[0], BF16_TOL[1])
    want_y, sums_y = a_k.float() @ wo32, a_k.float().abs() @ wo32.abs()
    err_y = check(f"swiglu T={t} y vs a @ wo", got, want_y,
                  sum_order(f) * sums_y + BF16_TOL[0], BF16_TOL[1])
    # the second product's sum-order error past y's own rounding, as a
    # share of its sum of |products|
    reading = float(((got.float() - want_y).abs()
                     - BF16_TOL[1] * want_y.abs()).clamp(min=0).div(sums_y)
                    .max())
    del sums, want_y, sums_y
    del a, wo32, x32
    lib_err = max_err((F.silu(x @ wg) * (x @ wi)) @ wo, want)
    del want
    check_library(f"swiglu T={t}", err, lib_err)
    nbytes = (3 * d * f + 2 * t * d) * 2
    bnd = bound(6.0 * t * d * f, PEAK_BF16, nbytes)
    reps = 20 if t <= K.DECODE_MAX_T else 5
    return {"max_abs_err": err, "tol": SWIGLU_TOL_TEXT,
            "a_max_abs_err": err_a, "y_vs_a_wo_max_abs_err": err_y,
            "y_sum_order_reading": reading,
            "y_sum_order_allowed": sum_order(f),
            "design": SWIGLU_DESIGNS[K.plan(t, d, f, x.dtype)["design"]],
            "ms": graph_ms(lambda: K.swiglu_cuda(x, wi, wg, wo), reps),
            "plain_ms": cuda_ms(lambda: ref.swiglu_ref(x, wi, wg, wo), reps),
            **bnd,
            # the cuBLAS chain (silu(x@wg)*(x@wi))@wo, timed as a yardstick
            "library_ms": cuda_ms(
                lambda: (F.silu(x @ wg) * (x @ wi)) @ wo, reps),
            "library": "cuBLAS chain (silu(x@wg)*(x@wi))@wo",
            "library_max_abs_err": lib_err,
            "shape": f"T={t} d={d} f={f} bf16"}


#: flash_attention at each of the seven archs' prefill shapes (arch, Hq,
#: Hkv, D, causal): D 64, D 80 (padded into the 128-wide instance; an
#: encoder, so non-causal), D 160 (the 256-wide instance) and the groups
#: 48:1, 128:8, 64:8 and 16:16 at D 128
NEW_FLASH_SHAPES = (("granite-moe-1b-a400m", 16, 8, 64, True),
                    ("hubert-xlarge", 16, 16, 80, False),
                    ("stablelm-12b", 32, 8, 160, True),
                    ("granite-20b", 48, 1, 128, True),
                    ("llama3-405b", 128, 8, 128, True),
                    ("internvl2-76b", 64, 8, 128, True),
                    ("moonshot-v1-16b-a3b", 16, 16, 128, True))
#: swiglu at the widths of the archs whose path runs it (arch, d, f), each
#: at the prefill's T (2 x 512) and a decode step's (2 sequences)
NEW_SWIGLU_WIDTHS = (("stablelm-12b", 5120, 13824),
                     ("llama3-405b", 16384, 53248),
                     ("internvl2-76b", 8192, 28672))


#: token counts at which both bf16 swiglu designs are timed: decode,
#: prefill, and around the switch (swiglu.DECODE_MAX_T)
SWITCH_T = (8, 32, 33, 64, 65, 128, 256, 1024)


def swiglu_designs() -> dict:
    """Both bf16 swiglu designs timed at each of SWITCH_T, at qwen2-7b's
    widths (the wrapper takes decode up to swiglu.DECODE_MAX_T)."""
    from repro_torch.kernels import swiglu as K
    wi, wg, wo, g = mlp_weights(8)
    out = {}
    for t in SWITCH_T:
        x = torch.randn((t, wi.shape[0]), generator=g,
                        device="cuda").to(torch.bfloat16)
        reps = 20 if t <= 256 else 5
        out[t] = {dz: graph_ms(lambda: K.swiglu_cuda(x, wi, wg, wo, dz),
                               reps) for dz in ("decode", "prefill")}
        log(f"[kernels] swiglu T={t} d=3584 f=18944 bf16: decode design "
            f"{out[t]['decode']:.4f} ms, prefill design "
            f"{out[t]['prefill']:.4f} ms (wrapper takes "
            f"{K.plan(t, 3584, 18944, x.dtype)['design']})")
    return out


#: the SSD shapes (batch, tokens, chunk): mamba2-1.3b's prefill (2 x 512,
#: chunk 256), forward (2 x 520, chunk _blk(520, 256) = 130) and train
#: microbatch (1 x 4096, chunk 256: 16 chunks carry the state), 64 heads of
#: 64, state 128
SSD_SHAPE = dict(h=64, p=64, n=128)
SSD_CASES = {"": (torch.bfloat16, 2, 512, 256),
             "forward": (torch.bfloat16, 2, 520, 130),
             "train": (torch.bfloat16, 1, 4096, 256),
             "f32": (torch.float32, 2, 512, 256),
             "f32_forward": (torch.float32, 2, 520, 130)}
SSD_TOL_TEXT = {
    torch.float32: "atol 1e-4 x max|plain| + rtol 1e-4, vs the plain version",
    torch.bfloat16: "ref.ssd_bf16_tolerance: y's own rounding 2^-8 |plain| "
                    "+ the splits' 2 u^2 (1 + u^2) Y_abs (y), u^2 (1 + u^2) "
                    "S_abs (state), u = 2^-8, + 1e-4 (max|plain| + "
                    "|plain|), vs the plain version in f32"}
SSD_DESIGN = {
    torch.bfloat16: "scores C B^T once per chunk (mma.sync m16n8k16), chunk "
                    "states x^T B' (mma.sync), states passed in order, "
                    "64-row query tiles: W' in registers into W' x and "
                    "C S^T (mma.sync), x by a 2-stage cp.async ring; B', "
                    "S and W' enter their products as bf16 hi + lo",
    torch.float32: "the same passes on the CUDA cores, 4x4 register patches "
                   "from float4 rows of shared tiles"}


def ssd_inputs(seed: int, dtype, b: int, s: int, dt_shift: float = 0.0):
    """Inputs as mamba2's prefill gives them: x = silu(.), dt = softplus(.)
    (shifted down to make the decay slow), A = -exp(0.2 N(0,1))."""
    h, p, n = (SSD_SHAPE[k] for k in "hpn")
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    x = F.silu(randn(b, s, h, p)).to(dtype)
    dt = F.softplus(randn(b, s, h) + dt_shift)
    A = -torch.exp(0.2 * randn(h))
    return x, dt, A, randn(b, s, n).to(dtype), randn(b, s, n).to(dtype)


def check_ssd(name: str, got, want, args, q: int) -> float:
    """y against y, state against state: f32 at atol 1e-4 x max|plain| +
    rtol 1e-4, bf16 at ``ref.ssd_bf16_tolerance``."""
    from repro_torch.kernels import ref
    if got[0].dtype == torch.bfloat16:
        bounds = ref.ssd_bf16_tolerance(*args, q, want)
        return max(check(f"{name} {part}", g, w, bnd, 0.0) for part, g, w, bnd
                   in zip(("y", "state"), got, want, bounds))
    return max(check(f"{name} {part}", g, w, 1e-4 * float(w.abs().max()),
                     1e-4) for part, g, w in zip(("y", "state"), got, want))


def ssd_work(b: int, s: int, h: int, p: int, n: int, q: int,
             elt: int) -> tuple:
    """Operations and bytes the SSD function needs at this shape: the
    scores C B^T once per chunk (they do not depend on the head); per head
    W' x over the pairs j <= i, the chunk's state and, for the chunks after
    the first (the state entering the first is zero), the carried state's
    part of y; each input read once, y and the final state written once."""
    flops = 0
    for c0 in range(0, s, q):
        L = min(q, s - c0)
        pairs = L * (L + 1) // 2
        flops += 2 * b * pairs * n + 2 * b * h * (
            pairs * p + L * p * n + (L * p * n if c0 else 0))
    nbytes = (2 * b * s * h * p + 2 * b * s * n) * elt + (b * s * h + h) * 4 \
        + b * h * p * n * 4
    return flops, nbytes


def assert_repeats(name: str, fn) -> None:
    """Two launches on the same inputs agree bit for bit."""
    a, b = fn(), fn()
    for u, v in zip(a if isinstance(a, tuple) else (a,),
                    b if isinstance(b, tuple) else (b,)):
        if not torch.equal(u, v):
            raise RuntimeError(f"{name}: two launches differ")


def ssd_case(dtype, b: int, s: int, q: int) -> dict:
    from repro_torch.kernels import ref, ssd as K
    args = ssd_inputs(4, dtype, b, s)
    x, dt, A, Bm, Cm = args
    f32 = (x.float(), dt, A, Bm.float(), Cm.float())
    got = K.ssd_cuda(*args, q)
    label = f"ssd {str(dtype).split('.')[-1]} B={b} S={s} chunk {q}"
    err = check_ssd(f"{label} vs plain", got, ref.ssd_ref(*f32, q), args, q)
    # the token-by-token recurrence holds the chunk math where the JAX
    # reference is NaN (chunk 256: cum spans far past 88)
    err_rec = check_ssd(f"{label} vs recurrence", got,
                        ref.ssd_scan_ref(*f32), args, q)
    assert_repeats(label, lambda: K.ssd_cuda(*args, q))
    h, p, n = (SSD_SHAPE[k] for k in "hpn")
    peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
    flops, nbytes = ssd_work(b, s, h, p, n, q, x.element_size())
    return {"max_abs_err": err, "tol": SSD_TOL_TEXT[dtype],
            "recurrence_max_abs_err": err_rec, "design": SSD_DESIGN[dtype],
            "ms": graph_ms(lambda: K.ssd_cuda(*args, q), 20),
            "eager_ms": cuda_ms(lambda: K.ssd_cuda(*args, q), 20),
            "plain_ms": cuda_ms(lambda: ref.ssd_ref(*args, q), 5),
            **bound(flops, peak, nbytes), "library_ms": None,
            "library": NO_LIBRARY,
            "shape": f"B={b} S={s} H={h} P={p} N={n} chunk {q}, x/B/C/y "
                     f"{str(dtype).split('.')[-1]}"}


def kernel_ssd(rows: dict) -> None:
    from repro_torch.kernels import ref, ssd as K
    for label, (dtype, b, s, q) in SSD_CASES.items():
        row = ssd_case(dtype, b, s, q)
        if label:
            rows["ssd"][label] = row
        else:
            rows["ssd"] = row
    # with dt small enough that the state carries across tiles and chunks,
    # the f32 kernel against the recurrence
    slow = ssd_inputs(5, torch.float32, 2, 512, dt_shift=-4.0)
    rows["ssd"]["slow_decay_f32_max_abs_err"] = check_ssd(
        "ssd f32 slow decay vs recurrence", K.ssd_cuda(*slow, 256),
        ref.ssd_scan_ref(*slow), slow, 256)


def rglru_case(s: int) -> dict:
    from repro_torch.kernels import ref, rglru as K
    b, w = 2, 4096
    g = torch.Generator(device="cuda").manual_seed(6)
    # gates as the model makes them: a = exp(log_a) in (0.9, 0.999)^r
    u = torch.empty(w, device="cuda").uniform_(0.9 ** 2, 0.999 ** 2,
                                               generator=g)
    lam = torch.log(torch.exp(-torch.log(u) / 16.0) - 1.0)
    r = torch.sigmoid(torch.randn((b, s, w), generator=g, device="cuda"))
    log_a = -8.0 * F.softplus(lam) * r
    bb = torch.sqrt(1.0 - torch.exp(2.0 * log_a)) \
        * torch.randn((b, s, w), generator=g, device="cuda")
    got = K.rglru_cuda(log_a, bb)
    atol, rtol = 2e-5, 2e-5         # tests/test_kernels.py, rglru
    err = check("rglru", got, ref.rglru_ref(log_a, bb), atol, rtol)
    assert_repeats(f"rglru S={s}", lambda: K.rglru_cuda(log_a, bb))
    bnd = bound(3.0 * b * s * w, PEAK_F32, 12.0 * b * s * w)
    return {"max_abs_err": err, "tol": f"atol {atol} + rtol {rtol}",
            "design": "32 channels x one batch row a block, 8 warps x 32 "
                      "steps a window, segments combined in warp order",
            "ms": graph_ms(lambda: K.rglru_cuda(log_a, bb), 20),
            "plain_ms": cuda_ms(lambda: ref.rglru_ref(log_a, bb), 3),
            **bnd, "library_ms": None, "library": NO_LIBRARY,
            "shape": f"B={b} S={s} W={w} f32"}


#: qwen2-7b's prefill_32k_b1: one sequence of 32768 tokens
PREFILL_32K = 32768


def rows_32k(n: int) -> torch.Tensor:
    """The rows of a 32k-token output held against the plain version (which
    is not run in full there): the first 64, the 128 across the middle and
    the last 256, whose queries see every key."""
    return torch.cat([torch.arange(0, 64),
                      torch.arange(n // 2 - 64, n // 2 + 64),
                      torch.arange(n - 256, n)]).cuda()


def flash_32k() -> dict:
    """flash_attention at qwen2-7b's 32k-token prefill (B1 S=T=32768 Hq28
    Hkv4 D128 bf16 causal), timed beside its bound and SDPA; the rows of
    ``rows_32k`` held against the plain version in f32 over all 32768 keys
    and against SDPA's error there, as ``flash_case`` holds the full
    output."""
    from repro_torch.kernels import flash_attention as K, ref
    s, hq, hkv, d = PREFILL_32K, 28, 4, 128
    g = torch.Generator(device="cuda").manual_seed(11)
    q, k, v = (torch.randn((1, s, h, d), generator=g, device="cuda")
               .to(torch.bfloat16) for h in (hq, hkv, hkv))
    o = K.flash_attention_cuda(q, k, v, True, 0)
    idx = rows_32k(s)
    want = ref.attention_naive(q[:, idx].float(), k.float(), v.float(), idx,
                               torch.arange(s, device="cuda"), True, 0)
    err = check(f"flash_attention S={s} rows", o[:, idx], want,
                ROUND * float(v.float().abs().max()) + BF16_TOL[0],
                BF16_TOL[1])
    del o
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(hq // hkv, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(hq // hkv, dim=2).transpose(1, 2).contiguous()
    sdpa_err = max_err(F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True)[:, :, idx].transpose(1, 2), want)
    del want
    check_library(f"flash_attention S={s} rows", err, sdpa_err)
    pairs = s * (s + 1) // 2
    return {"rows_max_abs_err": err, "rows": len(idx),
            "library_max_abs_err": sdpa_err, "tol": FLASH_TOL_TEXT,
            "ms": cuda_ms(lambda: K.flash_attention_cuda(q, k, v, True, 0),
                          3, warmup=1),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True), 3, warmup=1),
            **bound(4.0 * hq * d * pairs, PEAK_BF16,
                    (2 * q.numel() + k.numel() + v.numel()) * 2),
            "shape": f"B=1 S=T={s} Hq={hq} Hkv={hkv} D={d} bf16 causal"}


def swiglu_32k() -> dict:
    """swiglu at qwen2-7b's 32k-token prefill (T 32768, d 3584, f 18944,
    bf16: the wgmma prefill design), timed beside its bound and the cuBLAS
    chain; the rows of ``rows_32k`` held against the plain version in f32
    and against the chain's error there, as ``swiglu_case`` holds y."""
    from repro_torch.kernels import swiglu as K
    wi, wg, wo, g = mlp_weights(12)
    d, f = wi.shape
    t = PREFILL_32K
    x = torch.randn((t, d), generator=g, device="cuda").to(torch.bfloat16)
    y = K.swiglu_cuda(x, wi, wg, wo)
    idx = rows_32k(t)
    xr = x[idx]
    wo32 = wo.float()
    a = F.silu(xr.float() @ wg.float()) * (xr.float() @ wi.float())
    want = a @ wo32
    err = check(f"swiglu T={t} rows", y[idx], want,
                ROUND * (a.abs() @ wo32.abs()) + BF16_TOL[0], BF16_TOL[1])
    del y, a, wo32
    lib_err = max_err((F.silu(xr @ wg) * (xr @ wi)) @ wo, want)
    check_library(f"swiglu T={t} rows", err, lib_err)
    return {"rows_max_abs_err": err, "rows": len(idx),
            "library_max_abs_err": lib_err, "tol": SWIGLU_TOL_TEXT,
            "ms": cuda_ms(lambda: K.swiglu_cuda(x, wi, wg, wo), 3,
                          warmup=1),
            "library_ms": cuda_ms(
                lambda: (F.silu(x @ wg) * (x @ wi)) @ wo, 3, warmup=1),
            **bound(6.0 * t * d * f, PEAK_BF16, (3 * d * f + 2 * t * d) * 2),
            "design": K.plan(t, d, f, x.dtype)["design"],
            "shape": f"T={t} d={d} f={f} bf16"}


def kernel_rglru(rows: dict) -> None:
    rows["rglru"] = rglru_case(2560)
    rows["rglru"]["forward"] = rglru_case(2568)


def small_model_check(arch: str) -> float:
    """A reduced config in f32: the offload plan on the card (every
    kernel's model path) against the plain path on the CPU."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    cfg = get_config(arch, reduced=True)
    cfg = dataclasses.replace(cfg, plan=cfg.plan.replace(
        compute_dtype="float32", kv_cache_dtype="float32"))
    cpu = Model(cfg, cfg.plan.replace(attn_impl="xla"), device="cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    gpu = Model(cfg, cfg.plan.replace(**OFFLOAD), device="cuda")
    gparams = gpu.load(params.state_dict())
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 48)).astype(np.int32))
    want = cpu.forward(params, {"tokens": toks})
    got = gpu.forward(gparams, {"tokens": toks.cuda()}).cpu()
    return check(f"reduced {arch} f32, card vs CPU", got, want, 1e-4, 1e-4)


def phase_kernels() -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows: dict = {}
    kernel_mriq(rows)
    rows["flash_attention"] = flash_case(512, 28, 4, 128, 0, seed=1, reps=20)
    # recurrentgemma-9b's local attention
    rows["flash_attention"]["local"] = flash_case(2560, 16, 1, 256, 2048,
                                                  seed=7, reps=5)
    rows["swiglu"] = swiglu_case(8, seed=2)
    rows["swiglu"]["prefill"] = swiglu_case(1024, seed=3)
    rows["swiglu"]["designs_ms"] = swiglu_designs()
    # the prefill shapes of the seven archs' paths (2 x 512 tokens)
    for arch, hq, hkv, d, causal in NEW_FLASH_SHAPES:
        rows["flash_attention"][arch] = flash_case(512, hq, hkv, d, 0,
                                                   seed=hq + d, reps=20,
                                                   causal=causal)
    for arch, d, f in NEW_SWIGLU_WIDTHS:
        rows["swiglu"][arch] = swiglu_case(1024, seed=d, d=d, f=f)
        rows["swiglu"][f"{arch} decode"] = swiglu_case(2, seed=d + 2, d=d,
                                                       f=f)
    kernel_ssd(rows)
    kernel_rglru(rows)
    rows["flash_attention"]["prefill_32k"] = flash_32k()
    rows["swiglu"]["prefill_32k"] = swiglu_32k()
    for name in ("flash_attention", "swiglu"):
        rr = rows[name]["prefill_32k"]
        log(f"[kernels] {name} prefill_32k ({rr['shape']}): kernel_ms "
            f"{rr['ms']:.4f} library_ms {rr['library_ms']:.4f} bound_ms "
            f"{rr['bound_ms']:.4f} ({rr['bound_by']}; operations at "
            f"{rr['bound_peak']}); share of bound "
            f"{rr['bound_ms'] / rr['ms']:.4f}; {rr['rows']} rows vs the "
            f"plain version: max_err {rr['rows_max_abs_err']:.3e} tol "
            f"{rr['tol']}, library's {rr['library_max_abs_err']:.3e}")
    for name, r in rows.items():
        for label in ("", "prefill", "local", "forward", "f32",
                      "f32_forward", *ARCH_LAYERS,
                      *(f"{a} decode" for a in ARCH_LAYERS)):
            rr = r.get(label, r) if label else r
            if label and label not in r:
                continue
            lib = "null" if rr["library_ms"] is None \
                else f"{rr['library_ms']:.4f}"
            log(f"[kernels] {name} {label} ({rr['shape']}): max_err "
                f"{rr['max_abs_err']:.3e} tol {rr['tol']}; kernel_ms "
                f"{rr['ms']:.4f} plain_ms {rr['plain_ms']:.4f} library_ms "
                f"{lib} bound_ms {rr['bound_ms']:.4f} ({rr['bound_by']}; "
                f"operations at {rr['bound_peak']}); share of bound "
                f"{rr['bound_ms'] / rr['ms']:.4f}")
            if "library_max_abs_err" in rr:
                log(f"[kernels] {name} {label}: library max_err vs the plain "
                    f"version {rr['library_max_abs_err']:.3e}; design "
                    f"{rr.get('design', '')}")
            if "y_sum_order_reading" in rr:
                log(f"[kernels] {name} {label}: y vs a @ wo sum-order reading "
                    f"{rr['y_sum_order_reading']:.3e} of sum|products| "
                    f"(allowed {rr['y_sum_order_allowed']:.3e})")
    for label in SSD_CASES:
        rr = rows["ssd"][label] if label else rows["ssd"]
        log(f"[kernels] ssd {label or 'bf16'} vs the token-by-token "
            f"recurrence: max_err {rr['recurrence_max_abs_err']:.3e}; eager "
            f"(host launches included) {rr['eager_ms']:.4f} ms; design "
            f"{rr['design']}")
    log(f"[kernels] ssd f32 with slow decay vs the recurrence: max_err "
        f"{rows['ssd']['slow_decay_f32_max_abs_err']:.3e}; ssd and rglru "
        f"repeat bit for bit")
    for arch in MODEL_PATHS:
        err = small_model_check(arch)
        log(f"[kernels] reduced {arch} f32 logits, card (kernels) vs CPU "
            f"(plain): max_err {err:.3e} tol atol 1e-4 + rtol 1e-4")
    return rows


# ---------------------------------------------------------------------------
# phase 4-6: the main path
# ---------------------------------------------------------------------------


def phase_calibrate(source) -> dict:
    """The H100 spec's energy constants measured again, beside the
    committed ones."""
    from repro_torch.benchmarks.calibrate_power import CONSTANTS, calibrate
    from repro_torch.core.power import H100
    from repro_torch.telemetry.nvml import check_window
    out = calibrate(source, log=log)
    check_window("calibrate idle", out["idle_counter"])
    for w in out["windows"]:
        check_window(f"calibrate {w['name']}", w["counter"])
    log("[calibrate] committed in core.power.H100 / this run: " + ", ".join(
        f"{k} {getattr(H100, k):.6g} / {out[k]:.6g}" for k in CONSTANTS))
    return out


def phase_fig5(source) -> dict:
    """The paper's Fig. 5 through the port's harness (bench_mriq), on the
    card's power source, on the pattern search's inputs (phiMag formed on
    the host from phiR and phiI)."""
    from repro_torch.benchmarks import bench_mriq
    from repro_torch.examples import mriq_offload
    from repro_torch.telemetry.nvml import check_window
    out = bench_mriq.run(source=source, host=mriq_offload.fig5_inputs(0),
                         log=log)
    check_window("fig5 idle window", out["idle_counter"])
    check_window("fig5 card-draw window", out["card_counter"])
    return out


#: the pattern phase's budget, seconds: three 5-s NVML windows (naive,
#: device trig, combination; the full nest's is Fig. 5's) and their calls
PATTERN_BUDGET_S = 20.0


def phase_patterns(fig5: dict, source, smi: str) -> dict:
    """The paper's §4 pattern search on MRI-Q measured on the card
    (``repro_torch.examples.mriq_offload``) at its size, reusing Fig. 5's
    CPU-only leg and its card window of the full-nest leg; each pattern's
    (Qr, Qi) held to the CPU-only leg (the example raises otherwise), each
    new card window checked, the phase within PATTERN_BUDGET_S."""
    from repro_torch.examples import mriq_offload
    from repro_torch.telemetry.nvml import check_window
    t0 = time.perf_counter()
    log(f"[patterns] {smi}: MRI-Q's offload patterns at "
        f"{mriq_offload.N_VOX} voxels x {mriq_offload.N_K} k-points, the "
        f"CPU-only leg and the full nest's card window Fig. 5's")
    out = mriq_offload.run(source=source, fig5=fig5,
                           log=lambda m: log(f"[patterns] {m}"))
    for r in out["rows"]:
        if r["name"] not in ("cpu_only", "full_nest_batched"):
            check_window(f"patterns {r['name']} card window",
                         r["card_counter"])
    out["seconds"] = time.perf_counter() - t0
    log(f"[patterns] selected {out['selected']}"
        + (f", tie with {', '.join(out['tie'])}" if out["tie"] else "")
        + f"; phase {out['seconds']:.1f} s (budget {PATTERN_BUDGET_S:.0f} "
        f"s); {smi}")
    log("patterns " + json.dumps(
        {"selected": out["selected"], "tie": out["tie"], "smi": smi,
         "rows": [{k: v for k, v in r.items() if k != "card_counter"}
                  for r in out["rows"]]}))
    if out["seconds"] > PATTERN_BUDGET_S:
        raise RuntimeError(f"patterns: {out['seconds']:.1f} s, over its "
                           f"{PATTERN_BUDGET_S:.0f}-s budget")
    return out


def phase_reports(files: dict) -> None:
    """The fleet phase's ledger and spans rendered on the host through the
    port's own readers (``repro_torch.scripts.power_report`` and
    ``trace_report``), as a user reads them."""
    import contextlib
    import io
    from repro_torch.scripts import power_report, trace_report
    for main, argv, want in (
            (power_report.main, ["--ledger", str(files["ledger"])],
             "by tenant:"),
            (trace_report.main, ["--trace", str(files["spans"]),
                                 "--metrics", str(files["metrics"])],
             "attributed Ws by phase")):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(argv)
        text = buf.getvalue()
        for line in text.splitlines():
            log(f"[reports] {line}")
        if want not in text:
            raise RuntimeError(f"reports: {main.__module__} {argv} printed "
                               f"no '{want}'")


def init_weights(model, seed: int):
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    log(f"[prefill] {model.cfg.name} weights, seed {seed} "
        f"({model.cfg.param_count() / 1e9:.2f} B params, "
        f"{model.plan.param_dtype}) initialised on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    return params


def phase_prefill(model, params, held=True, tol_share=None) -> dict:
    """Prefill, then 8 decode steps, against the teacher-forced forward,
    at ``tol_share`` of max|logit| (default PREFILL_TOL); ``held=False``
    reads the errors and holds the logits to be finite.  A vision arch's
    prompt starts with its patch embeddings (random, seeded)."""
    cfg = model.cfg
    b, s, n_dec = 2, PREFILL_LEN.get(cfg.name, 512), 8
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s + n_dec))
                            .astype(np.int32)).cuda()
    extra = {}
    if cfg.frontend == "vision_patches":
        g = torch.Generator(device="cuda").manual_seed(2)
        extra["patch_embeds"] = torch.randn(
            (b, cfg.n_patches, cfg.d_model), generator=g, device="cuda")
    cache = model.init_cache(b, s + n_dec)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last, cache = model.prefill(params, {"tokens": toks[:, :s], **extra},
                                cache)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    steps = []
    for t in range(s, s + n_dec):
        lg, cache = model.decode_step(
            params, {"tokens": toks[:, t:t + 1], "pos": t}, cache)
        steps.append(lg)
    dec = torch.stack(steps, dim=1)
    full = model.forward(params, {"tokens": toks, **extra})
    for name, t in (("forward", full), ("prefill", last), ("decode", dec)):
        if not torch.isfinite(t).all():
            raise RuntimeError(f"{cfg.name}: non-finite {name} logits")
    scale = float(full.abs().max())
    tol = None
    # roundings taken in another order along the residual layers (at
    # prefill the kernels round P and a to bf16; decode attention runs the
    # stock ops)
    if held:
        share = PREFILL_TOL[cfg.name] if tol_share is None else tol_share
        tol = share * scale
        e_pre = check("prefill last logits vs forward", last,
                      full[:, s - 1], tol, 0.0)
        e_dec = check("decode logits vs forward", dec, full[:, s:], tol, 0.0)
        held_by = f"tol {tol:.4f} = {share} max|logit|"
    else:
        e_pre = max_err(last, full[:, s - 1])
        e_dec = max_err(dec, full[:, s:])
        held_by = "not held: finite only"
    agree = float((dec.argmax(-1) == full[:, s:].argmax(-1)).float().mean())
    out = {"prefill_s": t_prefill, "prefill_err": e_pre, "decode_err": e_dec,
           "logit_scale": scale, "tol": tol, "argmax_agree": agree}
    log(f"[prefill] {cfg.name} full width, {cfg.n_layers} layers, "
        f"{model.plan.compute_dtype}, 2x{s} tokens: prefill "
        f"{t_prefill:.4f} s; max|logit| {scale:.3f}; prefill err "
        f"{e_pre:.4f} = {e_pre / scale:.4f}, decode err {e_dec:.4f} = "
        f"{e_dec / scale:.4f} max|logit| ({held_by}); decode argmax agrees "
        f"with forward on {agree:.3f}")
    return out


def serve_loop(model, params, meter=None):
    """A ``ServeLoop`` with 8 slots holding the 8 requests of
    ``launch/serve.py``'s recipe."""
    from repro_torch.serve.engine import Request, ServeLoop
    loop = ServeLoop(model, params, batch_slots=8, max_seq=256, meter=meter)
    rng = np.random.default_rng(0)
    for i in range(8):
        plen = int(rng.integers(4, 12))
        prompt = rng.integers(2, model.cfg.vocab_size,
                              size=plen).astype(np.int32)
        loop.submit(Request(rid=i, prompt=prompt, max_new=16))
    return loop


#: the serve loop's graph replays against the eager step: steps held, and
#: where not bit for bit, the share of the largest |value| that a logit or
#: a cache entry may move (one bf16 rounding)
GRAPH_STEPS = 4
GRAPH_REL = 2.0 ** -8


def _cache_copy(cache) -> list:
    return [{k: v.clone() for k, v in c.items()} for c in cache]


def graph_check(loop) -> dict:
    """The loop's captured decode graph against the eager step.  The first
    queued request's prompt is teacher-forced through the loop (slot 0,
    the other slots on seeded tokens; the first step captures the graph);
    from that state GRAPH_STEPS replays and as many eager steps
    (``make_decode_step`` called directly, an int position) on a copy of
    the cache, greedy tokens fed back: logits and every cache tensor bit
    for bit, or else each one that differs named and held within
    GRAPH_REL of its largest |value|.  The cache is then put back as it
    was, so the run serves from the state it would have."""
    from repro_torch.serve.engine import make_decode_step
    t_start = time.perf_counter()
    model, params, cache = loop.model, loop.params, loop.cache
    saved = _cache_copy(cache)
    prompt = np.asarray(loop.queue[0].prompt, np.int32)
    toks = np.random.default_rng(2).integers(
        2, model.cfg.vocab_size, (loop.slots, 1)).astype(np.int32)
    for t, tok in enumerate(prompt[:-1]):
        toks[0, 0] = tok
        loop.decode(toks, t)
    eager = _cache_copy(cache)
    step = make_decode_step(model)
    toks[0, 0] = prompt[-1]
    pos = len(prompt) - 1
    differ: dict = {}

    def held(name, got, want):
        if torch.equal(got, want):
            return
        scale = max(float(want.float().abs().max()), 1e-30)
        rel = float((got.float() - want.float()).abs().max()) / scale
        differ[name] = max(rel, differ.get(name, 0.0))
    for i in range(GRAPH_STEPS):
        got = loop.decode(toks, pos).clone()
        with torch.no_grad():
            want, _ = step(params, {"tokens": torch.from_numpy(toks.copy())
                                    .cuda(), "pos": pos}, eager)
        held("logits", got, want)
        for layer, (c, e) in enumerate(zip(cache, eager)):
            for k in c:
                held(f"layer {layer} {k}", c[k], e[k])
        toks = torch.argmax(got, dim=-1).to(torch.int32).cpu().numpy()[:, None]
        pos += 1
    for c, sv in zip(cache, saved):
        for k in c:
            c[k].copy_(sv[k])
    torch.cuda.synchronize()
    g = loop.graph
    out = {"bit_equal": not differ, "differ": differ,
           "capture_ms": g.capture_ms, "pool_bytes": g.pool_bytes,
           "frozen_bytes": g.frozen_bytes,
           "launches_a_replay": {k.name: n for k, n in g.launches.items()},
           "seconds": time.perf_counter() - t_start}
    log(f"[serve] {model.cfg.name} decode graph: captured in "
        f"{g.capture_ms:.1f} ms, private pool {g.pool_bytes} B, frozen "
        f"casts {g.frozen_bytes} B, launches "
        f"a replay "
        f"{json.dumps(out['launches_a_replay'])}; {len(prompt) - 1} prompt "
        f"steps then {GRAPH_STEPS} replays vs the eager step on a copy of "
        f"the cache: " + ("logits and every cache tensor bit for bit"
                          if not differ else "differ in " + ", ".join(
                              f"{n} ({r:.3e} of max)"
                              for n, r in sorted(differ.items())))
        + f"; {out['seconds']:.2f} s")
    over = {n: r for n, r in differ.items() if r > GRAPH_REL}
    if over:
        raise RuntimeError(f"serve {model.cfg.name}: the graph's replays "
                           f"differ from the eager step beyond {GRAPH_REL} "
                           f"of max: {over}")
    return out


def phase_serve(model, params) -> float:
    from repro_torch.core.power import R740_ARRIA10
    from repro_torch.telemetry import DecodeEnergyMeter, node_envelope
    cfg = model.cfg
    t_phase = time.perf_counter()
    meter = DecodeEnergyMeter(envelope=node_envelope(R740_ARRIA10,
                                                     accelerated=True))
    loop = serve_loop(model, params, meter)
    graph = graph_check(loop)
    graph_obj = loop.graph
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    done = loop.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if sorted(r.rid for r in done) != list(range(8)):
        raise RuntimeError("serve: not every request finished")
    for r in done:
        if not (1 <= len(r.out) <= 16
                and all(0 <= t < cfg.vocab_size for t in r.out)):
            raise RuntimeError(f"serve: request {r.rid} output {r.out}")
    billed = sum(r.energy_ws for r in done)
    if not math.isclose(billed, meter.ledger.total_ws, rel_tol=1e-9):
        raise RuntimeError("serve: request bills do not sum to the ledger")
    n_tok = sum(len(r.out) for r in done)
    # every slot fill teacher-forces prompt[:-1] through full-batch steps
    forced = sum(len(r.prompt) - 1 for r in done)
    if loop.graph is not graph_obj:
        raise RuntimeError(f"serve {cfg.name}: the run recaptured its graph")
    out = {"wall_s": wall, "tokens": n_tok, "tokens_per_s": n_tok / wall,
           "steps": loop.steps_done, "forced_steps": forced,
           "ledger_ws": meter.ledger.total_ws,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "requests": [{"rid": r.rid, "prompt": len(r.prompt),
                         "tokens": len(r.out), "prefill_ws": r.prefill_ws,
                         "decode_ws": r.decode_ws} for r in done]}
    log(f"[serve] {cfg.name}: 8 requests, {n_tok} tokens in {wall:.3f} s "
        f"({out['tokens_per_s']:.2f} tokens/s; {forced} prompt steps + "
        f"{loop.steps_done} decode steps, all 8 slots wide, each a replay "
        f"of the graph captured before the run); "
        f"ledger {out['ledger_ws']:.3f} Ws at the accelerated R740 point; "
        f"peak device memory {out['peak_gb']:.2f} GB")
    for r in out["requests"]:
        log(f"[serve] request {r['rid']}: prompt {r['prompt']} tokens, "
            f"{r['tokens']} new, prefill {r['prefill_ws']:.4f} Ws, decode "
            f"{r['decode_ws']:.4f} Ws")
    log(f"[time] serve {cfg.name}: {time.perf_counter() - t_phase:.1f} s "
        f"(the graph check {graph['seconds']:.1f} s, the run {wall:.1f} s)")
    return wall


def profile_serve(model, params, wall_s: float) -> None:
    """Where the card's time goes while the 8 requests are served: the
    serve phase again, with no meter, under torch.profiler.  Busy share =
    device time of every kernel and copy over the profiled window's wall
    time (one stream, so they do not overlap).  The card's activity only
    (its kernels and copies, and the CUDA runtime calls): the window
    launches ~2 x 10^5 kernels, and recording every operator on the host
    as well stretched the window 2.7x and multiplied the events that
    ``key_averages`` reduces on the host."""
    from torch.profiler import ProfilerActivity, profile
    t_phase = time.perf_counter()
    loop = serve_loop(model, params)
    graph = loop.capture()              # outside the profiled window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loop.run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if loop.graph is not graph:
        raise RuntimeError("serve profile: the run recaptured its graph")
    report_profile(f"{model.cfg.name} serve window, every step a replay of "
                   f"the captured decode graph", prof, wall_ms,
                   f"unprofiled {wall_s * 1e3:.3f} ms")
    log(f"[time] serve profile {model.cfg.name}: "
        f"{time.perf_counter() - t_phase:.1f} s")


def report_profile(what: str, prof, wall_ms: float, note: str) -> None:
    """A profiled window: the device's busy share of its wall time (one
    stream, so kernels and copies do not overlap), the kernels by device
    time and the CUDA runtime calls by host time."""
    events = prof.key_averages()
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    launches = sum(e.count for e in device)
    log(f"[profile] {what}, profiled: wall {wall_ms:.3f} ms ({note}), "
        f"{launches} device ops, device time {busy_ms:.3f} ms -> busy "
        f"{busy_ms / wall_ms:.4f}, idle {1 - busy_ms / wall_ms:.4f}")
    for e in sorted(device, key=lambda e: e.self_device_time_total,
                    reverse=True)[:8]:
        log(f"[profile]   device {e.self_device_time_total / 1e3:9.3f} ms "
            f"x{e.count:<6d} {e.key[:80]}")
    runtime = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CPU
               and e.key.startswith("cuda")]
    for e in sorted(runtime, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:5]:
        log(f"[profile]   host   {e.self_cpu_time_total / 1e3:9.3f} ms "
            f"x{e.count:<6d} {e.key[:80]}")


def profile_prefill(model, params, prefill_s: float) -> None:
    """One prefill of the model's own plan (2 x PREFILL_LEN tokens) again,
    under torch.profiler: is it bound by the card or by the host?"""
    from torch.profiler import ProfilerActivity, profile
    cfg = model.cfg
    b, s = 2, PREFILL_LEN[cfg.name]
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)).cuda()
    cache = model.init_cache(b, s)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.prefill(params, {"tokens": toks}, cache)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    report_profile(f"{cfg.name} {model.plan.compute_dtype} prefill 2x{s}",
                   prof, wall_ms, f"unprofiled {prefill_s * 1e3:.3f} ms")


#: the offload search's requirement: a 32k-token prefill in 0.5 s.  The
#: estimate of no plan meets it on one H100 (2.48 s), so the search runs
#: all three stages (paper section 3.3 stops at the first stage whose
#: pattern meets the requirement) and promotes its finalists to the card
OFFLOAD_SLO_S = 0.5
OFFLOAD_SHAPE = "prefill_32k_b1"
#: the search's depth: the first layers of the loaded weights (shared, not
#: copied), cut from 28 for the run's time: each stock-attention finalist
#: takes ~20 s a 32k prefill at 28 layers (~10 s at 14)
OFFLOAD_LAYERS = 7
#: calls a trial after its warm-up, at least (the rung's default 3), cut for
#: the run's time: a stock-attention finalist's 5.4-s prefill outlasts the
#: 5-s window alone (its three calls spread 0.04 %), and a kernel plan's
#: 0.73-s prefill still fills the window with 7
OFFLOAD_MIN_CALLS = 1


class Recorded:
    """A measurement rung whose trials are kept, by plan, for the report."""

    def __init__(self, backend):
        self.backend = backend
        self.name = backend.name
        self.trials: list = []

    def __getattr__(self, name):
        return getattr(self.backend, name)

    def measure(self, ctx, plan):
        m = self.backend.measure(ctx, plan)
        self.trials.append((plan, m))
        return m


def first_layers(params, cfg, layers: int):
    """``params`` cut to its first ``layers`` layers, sharing every tensor
    (embedding, final norm and head included), and the config to match."""
    import copy
    import dataclasses
    sub = copy.copy(params)
    sub._parameters = dict(params._parameters)
    sub._modules = dict(params._modules)
    sub._modules["layers"] = torch.nn.ModuleList(
        list(params.layers)[:layers])
    sub.cfg = dataclasses.replace(cfg, n_layers=layers)
    return sub, sub.cfg


def phase_offload(model, params, source) -> dict:
    """The paper's offload search for qwen2-7b at prefill_32k_b1 on the
    card: finalists and the smoke trial on the measured rung, on the
    loaded weights' first OFFLOAD_LAYERS layers."""
    from repro_torch.core.adapt import adapt
    from repro_torch.core.backends import (MeasureContext, MeasuredBackend,
                                           plan_kernels, plan_tag)
    from repro_torch.core.destinations import Requirement
    from repro_torch.core.verifier import RungPolicy
    from repro_torch.telemetry.nvml import WINDOW_S, check_window
    params, cfg = first_layers(params, model.cfg, OFFLOAD_LAYERS)
    log(f"[offload] {cfg.name}: layers {OFFLOAD_LAYERS} of "
        f"{model.cfg.n_layers} (cut for the run's time: a stock-attention "
        f"finalist takes ~20 s a prefill at {model.cfg.n_layers}); at least "
        f"{OFFLOAD_MIN_CALLS} of 3 calls a trial after its warm-up (cut for "
        f"the run's time: the window takes what fills {WINDOW_S:.0f} s)")
    t0 = time.perf_counter()
    rung = Recorded(MeasuredBackend(source=source, params={cfg.name: params},
                                    log=log, min_calls=OFFLOAD_MIN_CALLS))
    rep = adapt(cfg, OFFLOAD_SHAPE,
                requirement=Requirement(max_seconds=OFFLOAD_SLO_S),
                rungs=RungPolicy(search="analytic", finalist="measured",
                                 smoke="measured"),
                verify=True, backends={"measured": rung},
                log=lambda m: log(f"[offload] {m}"))
    finalists = [plan_tag(p) for p, _ in rung.trials]
    log(f"[offload] finalists and smoke measured on the card: "
        + "; ".join(f"{plan_tag(p)} {p.describe()}" for p, _ in rung.trials))
    if all(p.attn_impl == "pallas" for p, _ in rung.trials):
        # the sharding genes are inert on one card, so the GA's finalists
        # can be kernel plans apart only in them: the paper's comparison
        # then takes the arch's plan (chunked stock attention) beside them
        log(f"[offload] no stock-attention plan among the finalists: the "
            f"arch's plan {plan_tag(cfg.plan)} measured as one extra trial")
        rung.measure(MeasureContext(cfg, OFFLOAD_SHAPE), cfg.plan)
    for plan, m in rung.trials:
        what = f"[offload] trial plan {plan_tag(plan)} ({plan.attn_impl} " \
               f"attention, chunk {plan.attn_chunk}, {plan.mlp_impl} mlp, " \
               f"{plan.kv_cache_dtype} cache)"
        if not m.ok:
            log(f"{what}: PENALTY {m.error}")
            continue
        check_window(what, m.trace.meta["counter"])
        log(f"{what}: {m.seconds:.4f} s, {m.watts:.2f} W, {m.energy_j:.3f} Ws "
            f"a prefill (card-only), fitness {m.fitness():.6f}, peak "
            f"{m.peak_mem_per_chip / 1e9:.2f} GB")
    fin = [st for st in rep.selection.stages
           if st["stage"].startswith("finalist")]
    if not fin or not fin[0]["confirmed"]:
        raise RuntimeError(f"offload: no finalist confirmed on the measured "
                           f"rung ({fin})")
    smoke = rep.verified
    if smoke is None or smoke["status"] != "OK":
        raise RuntimeError(f"offload: the chosen plan's smoke trial failed "
                           f"({smoke})")
    want = plan_kernels(rep.plan, rep.genes)
    missing = [k for k in want if not smoke["launches"].get(k)]
    if missing:
        raise RuntimeError(f"offload: the chosen plan's trial launched no "
                           f"{missing} ({smoke['launches']})")
    # every plan tried computes the same function: each one's last logits
    # against the chosen plan's, held as a prefill is against the forward
    outputs = rung.backend.outputs
    mine = outputs[plan_tag(rep.plan)]
    tol = PREFILL_TOL[cfg.name] * float(mine.abs().max())
    agree = {tag: check(f"offload: plan {tag}'s last logits vs the chosen "
                        f"plan's", logits, mine, tol, 0.0)
             for tag, logits in outputs.items() if tag != plan_tag(rep.plan)}
    log(f"[offload] last logits of each plan tried vs the chosen plan's: "
        f"max_err {agree} tol {tol:.4f} = {PREFILL_TOL[cfg.name]} "
        f"max|logit|")
    chosen = rep.selection.chosen
    out = {"stage": chosen.name, "plan": chosen.genome.describe(),
           "kernels": want, "smoke": smoke, "logits_max_abs_err": agree,
           "finalists": finalists,
           "seconds_total": time.perf_counter() - t0,
           "trials": [{"plan": plan_tag(p), "describe": p.describe(),
                       "attn_impl": p.attn_impl,
                       "attn_chunk": p.attn_chunk, "mlp_impl": p.mlp_impl,
                       "kv_cache_dtype": p.kv_cache_dtype, "ok": m.ok,
                       "error": m.error, "seconds": m.seconds,
                       "watts": m.watts, "ws": m.energy_j,
                       "fitness": m.fitness()} for p, m in rung.trials]}
    log(f"[offload] chosen {chosen.name}: {out['plan']}; smoke trial "
        f"{smoke['seconds']:.4f} s, {smoke['watts']:.2f} W, "
        f"{smoke['energy_ws']:.3f} Ws, launches {smoke['launches']} (its "
        f"genes name {want}); search {out['seconds_total']:.1f} s")
    log("offload " + json.dumps(out))
    return out


#: the fleet phase's CLI run (launch/serve.py's object engine): two nodes
#: of 8 slots on the one card, paced arrivals, teamB under a Ws budget
#: small enough to throttle it (its window is the whole 64-step run).  A
#: qwen2-7b request bills 400-650 Ws at the H100 envelope on the card at
#: 28 layers, 110-225 Ws at 14; the budget follows the depth, so teamB is
#: served about twice and then throttled
FLEET_BUDGET_WS = 225.0
#: the fleet phase's depth: the loaded weights' first layers (shared), cut
#: from 28 for the run's time (its decode steps and the governors' trials
#: at decode_32k_b8 are host-bound, 7 s a call at 28 layers, ~3 s at 14)
FLEET_LAYERS = 7
FLEET_ARGS = ["--fleet", "2", "--slots", "8", "--max-seq", "256",
              "--max-new", "16", "--requests", "16",
              "--tenants", "teamA,teamB",
              "--admission", f"teamB={FLEET_BUDGET_WS:g}",
              "--admission-window", "64", "--arrival-every", "2",
              "--placement", "gate", "--govern", "--verify-rung", "measured"]
#: the governed drift run: the node's watts step up 3x after DRIFT_AFTER
#: decode steps of busy time (the reference's own acceptance setup in
#: tests/test_governor.py: a replayed source with a boost-watts tail)
DRIFT_WATTS = (300.0, 900.0)
DRIFT_AFTER = 6
RECON_SHAPE = "decode_32k_b8"


def check_fleet_run(out: dict, vocab: int, ledger_path: Path) -> dict:
    """The CLI run's invariants: every admitted request finished with
    tokens in the vocabulary, the bills sum to the fleet ledger and every
    rollup to its total, attribution conserves each node, the persisted
    ledger reads back, and teamB was throttled with zero Ws booked."""
    from repro_torch.telemetry import EnergyLedger
    sched, done = out["sched"], out["finished"]
    rejected = {r.rid for r in out["admission"].rejections}
    admitted = [r for r in out["requests"] if r.rid not in rejected]
    if sorted(r.rid for r in done) != sorted(r.rid for r in admitted):
        raise RuntimeError(f"fleet: admitted requests did not all finish "
                           f"({sorted(r.rid for r in done)})")
    for r in done:
        if not (1 <= len(r.out) <= 16
                and all(0 <= t < vocab for t in r.out)):
            raise RuntimeError(f"fleet: request {r.rid} output {r.out}")
    if not rejected or "teamB" not in out["admission"].rejected_by_tenant():
        raise RuntimeError("fleet: teamB was never throttled")
    served = {r.rid for n in sched.nodes for r in n.served}
    for r in out["requests"]:
        if r.rid in rejected and (r.energy_ws != 0.0 or r.rid in served):
            raise RuntimeError(f"fleet: throttled request {r.rid} booked "
                               f"{r.energy_ws} Ws")
    led = sched.ledger
    infra = led.rollup("tenant").get("fleet")
    billed = sum(r.energy_ws for r in done) + (infra.ws if infra else 0.0)
    if not math.isclose(billed, led.total_ws, rel_tol=1e-9):
        raise RuntimeError(f"fleet: bills {billed} Ws != ledger "
                           f"{led.total_ws} Ws")
    for by in ("node", "tenant", "phase"):
        cut = sum(pe.ws for pe in led.rollup(by).values())
        if not math.isclose(cut, led.total_ws, rel_tol=1e-9):
            raise RuntimeError(f"fleet: rollup by {by} sums to {cut} Ws")
    meters = sum(n.meter.ledger.total_ws for n in sched.nodes)
    if not math.isclose(meters, led.total_ws, rel_tol=1e-9):
        raise RuntimeError("fleet: the node meters do not sum to the ledger")
    rows = out["attribution"].conservation(led)
    if not rows or not all(row["ok"] for row in rows.values()):
        raise RuntimeError(f"fleet: attribution DRIFT {rows}")
    back = EnergyLedger.from_json(ledger_path).total_ws
    if not math.isclose(back, led.total_ws, rel_tol=1e-12):
        raise RuntimeError(f"fleet: the ledger JSON reads back {back} Ws")
    tenant_ws = {t: pe.ws for t, pe in led.rollup("tenant").items()}
    served_by = {t: sum(1 for r in done if r.tenant == t)
                 for t in ("teamA", "teamB")}
    return {"served": len(done), "throttled": sorted(rejected),
            "tokens": sum(len(r.out) for r in done),
            "ledger_ws": led.total_ws, "tenant_ws": tenant_ws,
            "ws_per_request": {t: tenant_ws[t] / n
                               for t, n in served_by.items() if n},
            "fleet_steps": sched.steps,
            "drains": [e.to_dict() for e in sched.events],
            "placement": [e.to_dict() for e in out["planner"].events],
            "reconfig": [e.to_dict() for n in out["nodes"]
                         for e in n.governor.events],
            "wall_s": out["wall_s"]}


def trial_graph(name: str, m) -> dict:
    """The captured graph of a measured decode or train trial (its capture
    ms and pool bytes); raises when the trial ran eagerly."""
    graph = m.trace.meta["graph"]
    if graph is None:
        raise RuntimeError(f"{name}: the trial ran eagerly, not as a "
                           f"captured graph")
    return graph


def report_trials(what: str, trials: list) -> list:
    """Each measured trial of a governor's re-verification: its window
    must pass the counter check, be no penalty and replay a captured
    graph."""
    from repro_torch.core.backends import plan_tag
    from repro_torch.telemetry.nvml import check_window
    rows = []
    for plan, m in trials:
        name = (f"{what} trial plan {plan_tag(plan)} ({plan.attn_impl} "
                f"attention, {plan.mlp_impl} mlp, {plan.kv_cache_dtype} "
                f"cache) at {RECON_SHAPE}")
        if not m.ok:
            raise RuntimeError(f"{name}: PENALTY {m.error}")
        check_window(name, m.trace.meta["counter"])
        graph = trial_graph(name, m)
        log(f"{name}: {m.seconds:.4f} s, {m.watts:.2f} W, {m.energy_j:.3f} "
            f"Ws a call of {m.trace.meta['calls']} (16 decode steps, each "
            f"a graph replay, card-only), fitness {m.fitness():.6f}, peak "
            f"{m.peak_mem_per_chip / 1e9:.2f} GB, launches "
            f"{m.trace.meta['launches']}; captured in "
            f"{graph['capture_ms']:.1f} ms, pool {graph['pool_bytes']} B")
        rows.append({"plan": plan_tag(plan), "attn_impl": plan.attn_impl,
                     "mlp_impl": plan.mlp_impl, "seconds": m.seconds,
                     "watts": m.watts, "ws": m.energy_j,
                     "fitness": m.fitness(),
                     "calls": m.trace.meta["calls"],
                     "peak_gb": m.peak_mem_per_chip / 1e9, **graph})
    return rows


def phase_fleet(model, params, source) -> dict:
    """Step 7 and the object fleet on the card, on qwen2-7b's loaded
    weights under the offload plan.  (a) the serving CLI's library entry
    (launch/serve.py): two nodes under one scheduler, admission, placement
    and per-node governors re-verifying on the measured rung; (b) one
    governed node whose watts step up partway through serving: exactly one
    migration judged, both plans tried on the card at decode_32k_b8."""
    from repro_torch import obs
    from repro_torch.core.adapt import ReconfigPolicy, Reconfigurator
    from repro_torch.core.backends import MeasuredBackend
    from repro_torch.core.ga import GAConfig
    from repro_torch.core.verifier import Verifier
    from repro_torch.fleet import Node
    from repro_torch.launch import serve
    from repro_torch.serve.engine import Request
    from repro_torch.telemetry import (GovernorPolicy, PowerGovernor,
                                       ReplaySource)
    cfg = model.cfg
    out_dir = Path(__file__).resolve().parent / "artifacts" / "serve"
    files = {"ledger": out_dir / "fleet.json",
             "spans": out_dir / "trace.json",
             "metrics": out_dir / "metrics.prom"}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    log(f"[fleet] {cfg.name} full width, offload plan: both nodes serve "
        f"one model and its weights and time-share the one card; teamB's "
        f"budget {FLEET_BUDGET_WS:g} Ws per 64-step window")
    args = serve.parser().parse_args(FLEET_ARGS + [
        "--ledger-out", str(files["ledger"]),
        "--trace-spans", str(files["spans"]),
        "--metrics-out", str(files["metrics"])])
    cli_rung = Recorded(MeasuredBackend(source=source,
                                        params={cfg.name: params}, log=log))
    try:
        run = serve.run(args, model=model, params=params, measured=cli_rung)
    finally:
        obs.disable()
    cli = check_fleet_run(run, cfg.vocab_size, files["ledger"])
    for node in run["nodes"]:
        for ev in node.governor.events:
            log(f"[fleet] cli {ev.node}: drift {ev.drift_ratio:.2f}x at "
                f"step {ev.detected_step} (not injected: the wall clock's "
                f"own) -> {'APPLIED' if ev.applied else 'REJECTED'} "
                f"{ev.reject_reason}")
    cli["trials"] = report_trials("[fleet] cli", cli_rung.trials)
    cli["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"[fleet] cli: {cli['served']} served, throttled {cli['throttled']}, "
        f"{cli['tokens']} tokens, {cli['fleet_steps']} fleet steps in "
        f"{cli['wall_s']:.3f} s; ledger {cli['ledger_ws']:.3f} Ws at the "
        f"H100 envelope, Ws/request {cli['ws_per_request']}; "
        f"{len(cli['drains'])} drains, {len(cli['placement'])} placement "
        f"events, {len(cli['reconfig'])} governor events; peak "
        f"{cli['peak_gb']:.2f} GB")

    # (b) the governed drift run: the first step fills the 8 slots
    # (teacher-forcing each prompt) and decodes once; the watts step is
    # then placed DRIFT_AFTER - 1 decode steps further on the node's busy
    # timeline, at the step time that first step measured
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(8):
        plen = int(rng.integers(4, 12))
        prompt = rng.integers(2, cfg.vocab_size, size=plen).astype(np.int32)
        reqs.append(Request(rid=i, prompt=prompt, max_new=16))
    rung = Recorded(MeasuredBackend(source=source, params={cfg.name: params},
                                    log=log))
    recon = Reconfigurator(
        cfg, RECON_SHAPE, policy=ReconfigPolicy(),
        ga=GAConfig(population=6, generations=2), node="drift0",
        verifier_factory=lambda: Verifier(cfg, RECON_SHAPE, mode="analytic",
                                          backends={"measured": rung}))
    gov = PowerGovernor(recon, plan=model.plan,
                        policy=GovernorPolicy(flush_every=2,
                                              checkpoint_every=4),
                        verify_rung="measured")
    node = Node.build("drift0", model, params, slots=8, max_seq=256,
                      source=ReplaySource([(0.0, DRIFT_WATTS[0])]),
                      governor=gov)
    for r in reqs:
        node.submit(r)
    node.loop.step()
    dec = node.meter.ledger.phases["decode"]
    step_s = dec.seconds / dec.count
    t_step = node.meter.now + (DRIFT_AFTER - 1) * step_s
    node.meter.source = ReplaySource([(0.0, DRIFT_WATTS[0]),
                                      (t_step, DRIFT_WATTS[1])])
    node.loop.run()
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t1
    if sorted(r.rid for r in node.loop.finished) != list(range(8)):
        raise RuntimeError("fleet drift: not every request finished")
    if len(gov.events) != 1:
        raise RuntimeError(
            f"fleet drift: {len(gov.events)} migrations judged, not 1 "
            f"({gov.events}); drift windows (s, Ws) "
            f"{gov.monitor('drift0').ledger.steps}, busy "
            f"{node.meter.now:.4f} s, watts step at {t_step:.4f} s")
    ev = gov.events[0]
    if len(rung.trials) != 2:
        raise RuntimeError(f"fleet drift: {len(rung.trials)} trials, not 2")
    forced = sum(len(r.prompt) - 1 for r in reqs)
    log(f"[fleet] drift run: watts {DRIFT_WATTS[0]:g} -> {DRIFT_WATTS[1]:g} "
        f"W at {t_step:.4f} s of busy time (the first step's {forced} "
        f"prompt steps and decode step, then {DRIFT_AFTER - 1} decode steps "
        f"at {step_s:.5f} s); {node.loop.steps_done} steps in "
        f"{wall_b:.3f} s")
    log(f"[fleet] GovernorEvent: step {ev.step} (detected "
        f"{ev.detected_step}), drift {ev.drift_ratio:.3f}x (window "
        f"{ev.window_ws:.3f} Ws vs median {ev.median_ws:.3f} Ws) -> "
        f"{'APPLIED' if ev.applied else 'REJECTED'} on the {ev.verify_rung} "
        f"rung {ev.reject_reason}; new plan {ev.new_plan}; incumbent "
        f"{ev.old_plan}")
    drift = {"event": ev.to_dict(),
             "trials": report_trials("[fleet] drift", rung.trials),
             "wall_s": wall_b, "t_step_s": t_step, "step_s": step_s,
             "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
             "plan_migrations": len(node.loop.plan_migrations)}
    out = {"cli": cli, "drift": drift, "files": files,
           "budget_ws": FLEET_BUDGET_WS,
           "wall_s": time.perf_counter() - t0}
    log(f"[fleet] phase: {out['wall_s']:.1f} s; peak device memory "
        f"{cli['peak_gb']:.2f} GB (cli), {drift['peak_gb']:.2f} GB (drift "
        f"run and its trials)")
    log("fleet " + json.dumps(out, default=str))
    return out


def run_path(arch: str, counters: dict, seeds=(0,), before=None,
             after=None) -> dict:
    """One model's path under the offload plan: its weights on the card,
    prefill + decode against the forward for each of ``seeds`` (the serve
    phase keeps the first), then serving.  The launch counts are set to 0
    just before and read just after; ``before()`` (the Fig. 5 and pattern
    phases) runs first and ``after(model, params)`` (the offload search)
    last on the path, both counted.  Returns the counts, the model and its weights."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    for k in counters.values():
        k.launches = 0
    if before is not None:
        before()
    cfg = get_config(arch)
    model = Model(cfg, cfg.plan.replace(**OFFLOAD))
    torch.cuda.reset_peak_memory_stats()
    params = None
    for seed in reversed(seeds):        # ends on the serve phase's seed
        params = None                   # one set of weights at a time
        params = init_weights(model, seed)
        if arch in PREFILL_F32:
            phase_prefill(model.with_plan(model.plan.replace(
                compute_dtype="float32")), params)
            prefill = phase_prefill(model, params, held=False)
        else:
            prefill = phase_prefill(model, params)
    log(f"[prefill] {arch} peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    wall_s = phase_serve(model, params)
    if after is not None:
        after(model, params)
    launches = {name: k.launches for name, k in counters.items()}
    log(f"kernels {arch} " + json.dumps(launches))
    missing = [k for k in PATH_KERNELS[arch] if not launches[k]]
    if missing:
        raise RuntimeError(f"{arch}: kernels of its path never launched: "
                           f"{missing} ({launches})")
    return {"launches": launches, "model": model, "params": params,
            "wall_s": wall_s, "prefill_s": prefill["prefill_s"]}


def run_fleet(model, params, source, counters: dict) -> dict:
    """The fleet phase as a path of its own, on the first FLEET_LAYERS
    layers of the loaded weights: the launch counts set to 0 just before
    it and read just after; swiglu must have launched."""
    from repro_torch.models.model import Model
    params, cfg = first_layers(params, model.cfg, FLEET_LAYERS)
    log(f"[fleet] {cfg.name}: layers {FLEET_LAYERS} of {model.cfg.n_layers} "
        f"(cut for the run's time: the trials at {RECON_SHAPE} take ~7 s a "
        f"call at {model.cfg.n_layers})")
    for k in counters.values():
        k.launches = 0
    out = phase_fleet(Model(cfg, model.plan, model.device), params, source)
    launches = {name: k.launches for name, k in counters.items()}
    log("kernels fleet " + json.dumps(launches))
    if not launches["swiglu"]:
        raise RuntimeError(f"fleet: swiglu never launched ({launches})")
    phase_reports(out["files"])
    return launches


#: the plans phase: the optimized decode plan against the arch's plan at
#: decode_32k_b8, as the fleet phase's Step 7 trials run it (16 decode
#: steps a call from a seeded cache), on the loaded weights' first
#: OFFLOAD_LAYERS layers
PLANS_SHAPE = "decode_32k_b8"


def replay_vs_eager(rung, model, shape, rules) -> dict:
    """The measured rung's decode trial of ``model`` under ``rules``
    (``MeasuredBackend.make_trial``): after its first call (the capture),
    one replayed call and one eager call (``DecodeTrial.eager``) from the
    same cache state, their logits and every cache tensor compared.
    Returns what differs (name -> (max_err, tol), none when bit for bit)
    and the two calls' wall times; raises when a difference exceeds
    GRAPH_REL of that tensor's max |value|."""
    trial = rung.make_trial(model, rung.weights(model), shape, model.device,
                            rules)
    trial()
    start = _cache_copy(trial.cache)
    t0 = time.perf_counter()
    got = trial()
    replay_s = time.perf_counter() - t0
    replayed = _cache_copy(trial.cache)
    for c, s0 in zip(trial.cache, start):
        for k, t in c.items():
            t.copy_(s0[k])
    del start
    t0 = time.perf_counter()
    want = trial.eager()
    eager_s = time.perf_counter() - t0
    pairs = [("logits", got, want)] + [
        (f"layer {i} {k}", r[k], c[k])
        for i, (r, c) in enumerate(zip(replayed, trial.cache)) for k in c]
    differ = {}
    for name, a, b in pairs:
        if not torch.equal(a, b):
            a, b = a.float(), b.float()
            differ[name] = (float((a - b).abs().max()),
                            GRAPH_REL * float(b.abs().max()))
    bad = {k: v for k, v in differ.items() if v[0] > v[1]}
    if bad:
        raise RuntimeError(f"the replayed decode call is beyond "
                           f"{GRAPH_REL} max|value| of the eager call in "
                           f"{bad}")
    return {"differ": differ, "eager_s": eager_s, "replay_s": replay_s}


def phase_plans(model, params, source) -> dict:
    """The sharding plan on the card, on qwen2-7b's loaded weights cut to
    OFFLOAD_LAYERS.  (a) ``make_host_mesh()``: the (1, 1) mesh over its own
    one-rank NCCL group; the rules of the arch's plan and of the three
    optimized plans resolved over the parameters, a decode_32k_b8 cache
    (on the meta device) and each shape's batch, every spec replicated;
    (b) the arch's plan and ``optimized_plan(arch, "decode")`` (int8 KV
    cache) measured on that mesh, each trial's decode step captured and
    replayed, each window checked and each plan's last logits held to the
    other's, and for each plan one replayed call held to one eager call
    from the same cache state (``replay_vs_eager``); (c) a 256-chip,
    16-way TP context refused by the measured rung.  The group is
    destroyed at the end."""
    import dataclasses

    import torch.distributed as dist
    from repro_torch.configs import SHAPES
    from repro_torch.configs.optimized import optimized_plan
    from repro_torch.core.backends import (MeasureContext, MeasuredBackend,
                                           plan_tag)
    from repro_torch.launch.mesh import host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.model import Model
    from repro_torch.parallel import param_sharding as PS
    from repro_torch.parallel.sharding import make_rules, n_shards
    from repro_torch.telemetry.nvml import check_window
    t0 = time.perf_counter()
    params, cfg = first_layers(params, model.cfg, OFFLOAD_LAYERS)
    log(f"[plans] {cfg.name}: layers {OFFLOAD_LAYERS} of "
        f"{model.cfg.n_layers} (the offload search's cut)")
    plans = {"arch": cfg.plan}
    plans.update({k: optimized_plan(cfg.name, k)
                  for k in ("prefill", "decode", "train")})
    out: dict = {"specs": {}, "trials": {}}
    with host_mesh(device=model.device) as dm:
        log(f"[plans] host mesh {tuple(dm.shape)} {dm.mesh_dim_names} on "
            f"{dm.device_type}, {dist.get_backend()} group of "
            f"{dist.get_world_size()}")
        if tuple(dm.shape) != (1, 1):
            raise RuntimeError(f"plans: host mesh {tuple(dm.shape)}")
        for name, p in plans.items():
            pcfg = dataclasses.replace(cfg, plan=p)
            rules = make_rules(pcfg, dm, p)
            cache = T.init_cache(pcfg, 8, 32768, torch.device("meta"))
            specs = {
                "params": list(PS.param_spec_tree(params, rules).values()),
                "cache": [s for layer in PS.cache_shardings(cache, rules)
                          for s in layer.values()],
                "batch": [s for sh in SHAPES.values() for s in
                          PS.batch_shardings(Model(pcfg, p, model.device),
                                             sh, rules).values()]}
            counts = {k: len(v) for k, v in specs.items()}
            split = {k: sum(n_shards(s, dm) > 1 for s in v)
                     for k, v in specs.items()}
            if any(split.values()) or not all(counts.values()):
                raise RuntimeError(f"plans: {name} specs not all replicated "
                                   f"on (1, 1): {split} of {counts}")
            out["specs"][name] = counts
            log(f"[plans] {name} plan {plan_tag(p)} on (1, 1): {counts} "
                f"specs (params, cache, batch), all replicated")

        rung = MeasuredBackend(device=model.device, source=source,
                               params={cfg.name: params}, mesh=dm, log=log)
        try:
            rung.measure(MeasureContext(cfg, PLANS_SHAPE, n_chips=256,
                                        tp=16), cfg.plan)
        except ValueError as e:
            out["refusal"] = str(e)
            log(f"[plans] a 256-chip, 16-way TP context on the (1, 1) mesh: "
                f"refused ({e})")
        else:
            raise RuntimeError("plans: the measured rung ran a 256-chip "
                               "context on a one-card mesh")
        for name in ("arch", "decode"):
            p = plans[name]
            ctx = MeasureContext(cfg, PLANS_SHAPE)
            m = rung.measure(ctx, p)
            what = (f"[plans] {name} plan {plan_tag(p)} ({p.attn_impl} "
                    f"attention, {p.mlp_impl} mlp, {p.kv_cache_dtype} cache) "
                    f"at {PLANS_SHAPE}")
            if not m.ok:
                raise RuntimeError(f"{what}: PENALTY {m.error}")
            check_window(what, m.trace.meta["counter"])
            graph = trial_graph(what, m)
            out["trials"][name] = {
                "plan": plan_tag(p), "kv_cache_dtype": p.kv_cache_dtype,
                "seconds": m.seconds, "watts": m.watts, "ws": m.energy_j,
                "calls": m.trace.meta["calls"],
                "peak_gb": m.peak_mem_per_chip / 1e9, **graph}
            log(f"{what}: {m.seconds:.4f} s, {m.watts:.2f} W, "
                f"{m.energy_j:.3f} Ws a call of 16 decode steps, each a "
                f"graph replay (card-only), {m.trace.meta['calls']} calls, "
                f"peak {m.peak_mem_per_chip / 1e9:.2f} GB; captured in "
                f"{graph['capture_ms']:.1f} ms, pool {graph['pool_bytes']} "
                f"B")
            held = replay_vs_eager(rung, Model(dataclasses.replace(
                cfg, plan=p), p, model.device), ctx.shape,
                make_rules(dataclasses.replace(cfg, plan=p), dm, p))
            out["trials"][name]["replay_vs_eager"] = held
            log(f"[plans] {name} plan: one replayed call against one eager "
                f"call from the same cache state: "
                + ("logits and every cache tensor bit for bit"
                   if not held["differ"] else
                   "differ in " + ", ".join(
                       f"{k} (max_err {e:.3e}, tol {t:.3e})"
                       for k, (e, t) in held["differ"].items()))
                + f"; eager call {held['eager_s']:.4f} s, replayed "
                f"{held['replay_s']:.4f} s")
        a = rung.outputs[plan_tag(plans["arch"])]
        b = rung.outputs[plan_tag(plans["decode"])]
        tol = PREFILL_TOL[cfg.name] * float(a.abs().max())
        out["logits_max_abs_err"] = check(
            "plans: the int8-cache plan's last logits vs the arch plan's",
            b, a, tol, 0.0)
        log(f"[plans] last logits, int8 cache vs bf16 cache: max_err "
            f"{out['logits_max_abs_err']:.4f}, tol {tol:.4f} = "
            f"{PREFILL_TOL[cfg.name]} max|logit|")
        del rung
    if dist.is_initialized():
        raise RuntimeError("plans: the host mesh's group outlived it")
    out["wall_s"] = time.perf_counter() - t0
    log(f"[plans] phase: {out['wall_s']:.1f} s")
    log("plans " + json.dumps(out))
    return out


#: the fleet-scale phase: the reference's fleet_scale and fleet_diurnal_1m
#: rungs (benchmarks/bench_power.py) on the port's vectorized engines, no
#: model.  Its device work is the control-plane twins and the torch
#: booking plane (stock torch ops); it launches none of the five kernels
SCALE_NODES = 1024
SCALE_SLOTS = 4
SCALE_TWIN_ARRIVALS = 20_000
SCALE_DAY_ARRIVALS = 1_000_000
SCALE_HOURS = 24
SCALE_STEPS_PER_HOUR = 2000
SCALE_TENANTS = 4
SCALE_SAMPLE = 0.01
SCALE_CONTROL_INPUTS = 300
#: the Lq sweep's twin tolerance (the reference's own,
#: tests/test_fleet_jax_kernels.py:77); the torch booking plane's
#: (a sum over a chunk reorders additions)
LQ_TOL = dict(rtol=1e-9, atol=1e-12)
FOLD_RTOL = 1e-12


def scale_fleet(**kw):
    """The reference's ``fleet_scale`` fleet (bench_power.py
    ``_scale_fleet``) on the port's engines: SCALE_NODES nodes of 4 slots
    at the accelerated R740 point, a 4-ms tick, consolidate-and-gate
    planning every 16 steps.  ``kw``: the segment engine's ``backend`` /
    ``device``, or the sharded engine's ``shards`` / ``parallel``."""
    from repro_torch.core.power import R740_ARRIA10
    from repro_torch.fleet import (FleetPolicy, PowerPlanPolicy,
                                   PowerStatePolicy, SegmentFleet,
                                   ShardedSegmentFleet, VectorNodeSpec)
    from repro_torch.telemetry import node_envelope
    env = node_envelope(R740_ARRIA10, accelerated=True)
    specs = [VectorNodeSpec(f"pod{i:04d}", env, slots=SCALE_SLOTS,
                            step_s=0.004, max_seq=64)
             for i in range(SCALE_NODES)]
    ppol = PowerPlanPolicy(
        mode="gate", slo_queue_depth=4.0, plan_every=16,
        min_active=max(SCALE_NODES // 128, 1), min_active_steps=64,
        horizon_steps=64.0,
        states=PowerStatePolicy(gate_watts=3.0, boot_energy_ws=2.0,
                                warmup_steps=8, cooldown_steps=32))
    cls = ShardedSegmentFleet if "shards" in kw else SegmentFleet
    return cls(specs, policy=FleetPolicy(flush_every=8, checkpoint_every=16,
                                         migrate_on_drift=False),
               plan=ppol, loop_model="serve", **kw)


def host_ms(fn) -> float:
    """Milliseconds of one call of ``fn`` on the host's clock (a call that
    returns host values waits for the card itself)."""
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def control_twins(dev) -> dict:
    """(a) The control plane's torch twins on the card against numpy, over
    SCALE_CONTROL_INPUTS seeded inputs each: the route argmin over
    SCALE_NODES nodes (quantized marginals and loads: float-equal ties at
    both levels; some inputs with almost nothing or nothing active),
    winners exact; the Erlang-C sweep at the fleet's cumulative slots
    (c_max = SCALE_NODES x SCALE_SLOTS) over rates from a trough to
    saturation, within LQ_TOL.  Each call timed on the host's clock beside
    the numpy call's."""
    from repro_torch.fleet.power.forecast import ArrivalForecaster
    from repro_torch.fleet.torch_backend import (
        expected_queue_depth_many_torch, route_argmin_np, route_argmin_torch)
    rng = np.random.default_rng(0)
    n = SCALE_NODES
    t = {"route": ([], []), "lq": ([], [])}
    ties = {"marginal": 0, "load": 0, "none_active": 0}
    route_argmin_torch(np.zeros(n), np.zeros(n), np.arange(n),
                       np.ones(n, bool), device=dev)          # warm-up
    for i in range(SCALE_CONTROL_INPUTS):
        marg = rng.integers(0, 6, n) * 0.125
        marg[rng.random(n) < 0.05] = np.inf
        load = rng.integers(0, 5, n) / 4.0
        rank = rng.permutation(n)
        active = rng.random(n) < (0.5 if i % 5 else 0.003)
        if i % 50 == 49:
            active[:] = False
        out = {}
        t["route"][1].append(host_ms(lambda: out.__setitem__(
            "np", route_argmin_np(marg, load, rank, active))))
        t["route"][0].append(host_ms(lambda: out.__setitem__(
            "torch", route_argmin_torch(marg, load, rank, active,
                                        device=dev))))
        if out["torch"] != out["np"]:
            raise RuntimeError(f"fleet-scale route input {i}: torch winner "
                               f"{out['torch']}, numpy {out['np']}")
        if not active.any():
            ties["none_active"] += 1
            continue
        m = np.where(active, marg, np.inf)
        t1 = active & (m == m.min())
        ties["marginal"] += int(t1.sum() > 1)
        lo = np.where(t1, load, np.inf)
        ties["load"] += int((t1 & (lo == lo.min())).sum() > 1)
    servers = np.cumsum(np.full(n, SCALE_SLOTS))
    fc = ArrivalForecaster()
    expected_queue_depth_many_torch(servers, 16.0, 1.0, device=dev)
    worst = 0.0
    with np.errstate(all="ignore"):
        for i in range(SCALE_CONTROL_INPUTS):
            fc._n, fc._last_t = 1, 0.0
            fc._gap_ewma = 10.0 ** rng.uniform(-3.5, 3.0)
            lam = fc.rate(now=0.0)
            service = 10.0 ** rng.uniform(0.0, 2.5)
            horizon = float(rng.choice([16.0, 64.0, 256.0]))
            out = {}
            t["lq"][1].append(host_ms(lambda: out.__setitem__(
                "np", fc.expected_queue_depth_many(servers, service, now=0.0,
                                                   horizon=horizon))))
            t["lq"][0].append(host_ms(lambda: out.__setitem__(
                "torch", expected_queue_depth_many_torch(
                    servers, service, lam, horizon, device=dev))))
            np.testing.assert_allclose(
                out["torch"], out["np"], **LQ_TOL,
                err_msg=f"fleet-scale Lq input {i} (lam {lam}, service "
                        f"{service}, horizon {horizon})")
            fin = np.isfinite(out["np"]) & (out["np"] != 0)
            if fin.any():
                worst = max(worst, float(np.max(np.abs(
                    out["torch"][fin] / out["np"][fin] - 1.0))))
    res = {"inputs": SCALE_CONTROL_INPUTS, "ties": ties,
           "lq_c_max": int(servers[-1]), "lq_max_rel_err": worst}
    for name, (tt, tn) in t.items():
        res[f"{name}_torch_ms"] = {"median": float(np.median(tt)),
                                   "min": float(np.min(tt))}
        res[f"{name}_numpy_ms"] = {"median": float(np.median(tn)),
                                   "min": float(np.min(tn))}
    log(f"[fleet-scale] (a) control plane on {dev}, {SCALE_CONTROL_INPUTS} "
        f"seeded inputs each: route argmin over {n} nodes, winners exact "
        f"(marginal ties in {ties['marginal']}, load ties in "
        f"{ties['load']}, none active in {ties['none_active']}); torch "
        f"{res['route_torch_ms']['median']:.4f} ms a call (median, host "
        f"clock, the copies in and the winner out included), numpy "
        f"{res['route_numpy_ms']['median']:.4f}; Erlang-C sweep at c_max "
        f"{res['lq_c_max']} ({n} candidates) within rtol 1e-9, atol 1e-12 "
        f"(worst rel {worst:.2e}): torch "
        f"{res['lq_torch_ms']['median']:.4f} ms, numpy "
        f"{res['lq_numpy_ms']['median']:.4f}")
    return res


def _ledger_numbers(fleet) -> dict:
    led = fleet.ledger
    return {"cells": {k: (v.ws, v.seconds, v.count, v.peak_w)
                      for k, v in led.cells.items()},
            "phases": {k: (v.ws, v.seconds, v.count, v.peak_w)
                       for k, v in led.phases.items()},
            "nodes": dict(led.nodes)}


def _outcome(fleet, finished) -> tuple:
    """Placement events, the finished set and the tokens of every
    request."""
    return ([(e.step, e.node, e.action, tuple(e.moved_rids))
             for e in fleet.events], finished,
            fleet.r_done_tokens.tolist())


def _fold_close(name: str, got: dict, want: dict) -> float:
    """``got``'s ledger within FOLD_RTOL of ``want``'s, integer counts
    and peaks exact; returns the worst relative difference."""
    worst = 0.0
    for part in ("cells", "phases"):
        if set(got[part]) != set(want[part]):
            raise RuntimeError(f"{name}: {part} differ in their keys")
        for key, (ws, s, n, pk) in want[part].items():
            gws, gs, gn, gpk = got[part][key]
            if (gn, gpk) != (n, pk):
                raise RuntimeError(f"{name}: {part} {key} count/peak "
                                   f"{(gn, gpk)} != {(n, pk)}")
            for a, b in ((gws, ws), (gs, s)):
                if not math.isclose(a, b, rel_tol=FOLD_RTOL, abs_tol=0.0):
                    raise RuntimeError(f"{name}: {part} {key} {a!r} vs "
                                       f"{b!r} over rtol {FOLD_RTOL}")
                if b:
                    worst = max(worst, abs(a / b - 1.0))
    for node, ws in want["nodes"].items():
        if not math.isclose(got["nodes"][node], ws, rel_tol=FOLD_RTOL):
            raise RuntimeError(f"{name}: node {node} Ws over rtol")
    return worst


#: (b)'s arms: each engine's constructor arguments.  The numpy arms run
#: in processes forked after the card is up (concurrent with the torch arm
#: and with (c)); vector-shard's process arm forks its workers from there
TWIN_ARMS = {"vector-seg": dict(backend="numpy"),
             "vector-shard inline": dict(shards=2, parallel="inline"),
             "vector-shard process": dict(shards=2, parallel="process")}


def twin_arrivals():
    """(b)'s stream: the reference fleet_scale's seeded diurnal day."""
    from repro_torch.fleet import VectorArrivals
    return VectorArrivals.diurnal(SCALE_TWIN_ARRIVALS, tenants=SCALE_TENANTS,
                                  hours=SCALE_HOURS,
                                  steps_per_hour=SCALE_STEPS_PER_HOUR,
                                  max_new=8, seed=7)


def run_arm(kw: dict, arr) -> dict:
    """One engine of (b) over ``arr``: its wall time, outcome and
    ledger."""
    fleet = scale_fleet(**kw)
    t0 = time.perf_counter()
    finished = fleet.run(arr, max_steps=60_000)
    wall = time.perf_counter() - t0
    row = {"wall_s": wall, "arrivals_per_s": len(arr) / wall,
           "finished": len(finished), "steps": fleet.steps,
           "events": len(fleet.events), "total_ws": fleet.total_ws}
    if kw.get("backend") == "torch":
        row["records"] = fleet._acc.records
    return {"row": row, "outcome": _outcome(fleet, finished),
            "ledger": _ledger_numbers(fleet)}


def _arm_child(conn, kw: dict) -> None:
    """A forked arm: numpy only (it touches neither torch nor the card);
    sends its result, or its traceback, up the pipe."""
    import traceback
    try:
        conn.send(("ok", run_arm(kw, twin_arrivals())))
    except BaseException:
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


def start_numpy_arms() -> dict:
    """Fork one process per numpy arm of (b); returns name -> (process,
    pipe)."""
    from multiprocessing import get_context
    ctx = get_context("fork")
    arms = {}
    for name, kw in TWIN_ARMS.items():
        parent, child = ctx.Pipe(duplex=False)
        proc = ctx.Process(target=_arm_child, args=(child, kw),
                           name=f"fleet-scale {name}")
        proc.start()
        child.close()
        arms[name] = (proc, parent)
    return arms


def collect_arms(arms: dict, timeout_s: float = 300.0) -> dict:
    """Each forked arm's result; every process joined (terminated past
    ``timeout_s``)."""
    out, errors = {}, []
    try:
        for name, (proc, conn) in arms.items():
            if not conn.poll(timeout_s):
                errors.append(f"{name}: no result in {timeout_s:g} s")
                continue
            status, body = conn.recv()
            if status != "ok":
                errors.append(f"{name}: {body}")
            else:
                out[name] = body
    finally:
        for proc, conn in arms.values():
            conn.close()
            proc.join(timeout=10.0)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=10.0)
    if errors:
        raise RuntimeError("fleet-scale (b) arms failed: "
                           + "; ".join(errors))
    return out


def engine_twins(arms: dict, torch_arm: dict) -> dict:
    """(b) The reference's fleet_scale shape (one seeded diurnal stream of
    SCALE_TWIN_ARRIVALS arrivals over SCALE_NODES nodes, gate placement)
    through vector-seg (numpy), vector-torch (its booking plane folded on
    the card) and vector-shard (inline, and in worker processes): the
    same placement events, finished sets and tokens; the shard ledgers
    bit for bit vector-seg's; vector-torch's cells, per-node Ws and phase
    rollups within FOLD_RTOL, counts exact.  ``arms`` are the forked numpy
    arms' results, ``torch_arm`` the torch arm's."""
    ref = arms["vector-seg"]
    if ref["row"]["finished"] != SCALE_TWIN_ARRIVALS:
        raise RuntimeError(f"fleet-scale vector-seg: {ref['row']['finished']}"
                           f" of {SCALE_TWIN_ARRIVALS} finished")
    res = {}
    for name, arm in (("vector-seg", ref), ("vector-torch", torch_arm),
                      ("vector-shard inline", arms["vector-shard inline"]),
                      ("vector-shard process",
                       arms["vector-shard process"])):
        row = arm["row"]
        if name != "vector-seg":
            if arm["outcome"] != ref["outcome"]:
                raise RuntimeError(f"fleet-scale {name}: placement events, "
                                   f"finished set or tokens differ from "
                                   f"vector-seg's")
            if name.startswith("vector-shard"):
                if arm["ledger"] != ref["ledger"]:
                    raise RuntimeError(f"fleet-scale {name}: ledger not bit "
                                       f"for bit vector-seg's")
                row["ledger"] = "bit for bit vector-seg's"
            else:
                row["max_rel_diff"] = _fold_close(name, arm["ledger"],
                                                  ref["ledger"])
        res[name] = row
        where = "this process" if name == "vector-torch" else \
            "a process forked after the card was up, beside (c)"
        log(f"[fleet-scale] (b) {name} ({where}): {SCALE_TWIN_ARRIVALS} "
            f"arrivals over {SCALE_NODES} nodes in {row['wall_s']:.3f} s "
            f"({row['arrivals_per_s']:.0f} simulated arrivals/s, "
            f"{row['steps']} fleet steps, {row['finished']} finished, "
            f"{row['events']} placement events, {row['total_ws']:.3f} Ws)"
            + (f"; {row['ledger']}" if "ledger" in row else "")
            + (f"; within rtol {FOLD_RTOL} of vector-seg (worst "
               f"{row['max_rel_diff']:.2e}), {row['records']} records"
               if "max_rel_diff" in row else ""))
    return res


def hourly_curve(events, due, n_nodes: int) -> list:
    """Per simulated hour: arrivals, powered nodes at the hour's end
    (gate/regate power a node off, wake powers it back on), gates and
    wakes (bench_power.py's ``fleet_diurnal_1m`` curve)."""
    gated: set = set()
    events = sorted(events, key=lambda e: e.step)
    ei, curve = 0, []
    for hour in range(SCALE_HOURS):
        end = (hour + 1) * SCALE_STEPS_PER_HOUR
        gates = wakes = 0
        while ei < len(events) and events[ei].step <= end:
            if events[ei].action in ("gate", "regate"):
                gated.add(events[ei].node)
                gates += 1
            elif events[ei].action == "wake":
                gated.discard(events[ei].node)
                wakes += 1
            ei += 1
        curve.append({"hour": hour,
                      "arrivals": int(((due >= hour * SCALE_STEPS_PER_HOUR)
                                       & (due < end)).sum()),
                      "powered_nodes": n_nodes - len(gated),
                      "gates": gates, "wakes": wakes})
    return curve


def fleet_day(dev) -> dict:
    """(c) The users' scale, the reference's fleet_diurnal_1m rung: a
    simulated day (SCALE_HOURS x SCALE_STEPS_PER_HOUR steps) of
    SCALE_DAY_ARRIVALS arrivals over SCALE_NODES nodes through the serving
    CLI's library entry (``launch.serve.run_vector``, ``--engine
    vector-torch --placement gate``; nodes at the H100 envelope), a flight
    recorder sampling SCALE_SAMPLE of the requests with a snapshot every
    SCALE_STEPS_PER_HOUR steps.  Holds: every request finishes, and the
    bills (prefill + decode of every request, plus the infra tenant's
    idle and transition Ws) sum to the ledger (rel 1e-9).  The card holds
    only the booking plane's carries and the chunk in flight."""
    import io
    from contextlib import redirect_stdout
    from repro_torch import obs
    from repro_torch.fleet import VectorArrivals
    from repro_torch.launch import serve
    out_dir = Path(__file__).resolve().parent / "artifacts" / "fleet_scale"
    arr = VectorArrivals.diurnal(SCALE_DAY_ARRIVALS, tenants=SCALE_TENANTS,
                                 hours=SCALE_HOURS,
                                 steps_per_hour=SCALE_STEPS_PER_HOUR,
                                 max_new=8, seed=11)
    args = serve.parser().parse_args([
        "--engine", "vector-torch", "--device", str(dev), "--placement",
        "gate", "--fleet", str(SCALE_NODES), "--slots", str(SCALE_SLOTS),
        "--tick", "0.004", "--max-seq", "64", "--max-new", "8",
        "--flush-every", "8", "--checkpoint-every", "16",
        "--trace-sample", str(SCALE_SAMPLE),
        "--snapshot-every", str(SCALE_STEPS_PER_HOUR),
        "--flight-log", str(out_dir / "flight.jsonl"),
        "--ledger-out", str(out_dir / "ledger.json")])
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    text = io.StringIO()         # one line per request: kept off the log
    t0 = time.perf_counter()
    try:
        with redirect_stdout(text):
            run = serve.run_vector(args, arrivals=arr,
                                   max_steps=(SCALE_HOURS + 1)
                                   * SCALE_STEPS_PER_HOUR)
        rows = list(obs.FLIGHT.snapshots)
    finally:
        obs.disable()
    phase_s = time.perf_counter() - t0
    fleet = run["fleet"]
    if len(run["finished"]) != len(arr) or not fleet.r_finished.all():
        raise RuntimeError(f"fleet-scale day: {len(run['finished'])} of "
                           f"{len(arr)} requests finished")
    led = fleet.ledger
    infra = led.rollup("tenant")["fleet"].ws
    billed = float(fleet.r_prefill_ws.sum() + fleet.r_decode_ws.sum()) \
        + infra
    if not math.isclose(billed, led.total_ws, rel_tol=1e-9):
        raise RuntimeError(f"fleet-scale day: bills {billed} Ws != ledger "
                           f"{led.total_ws} Ws")
    for by in ("node", "tenant", "phase"):
        cut = sum(pe.ws for pe in led.rollup(by).values())
        if not math.isclose(cut, led.total_ws, rel_tol=1e-9):
            raise RuntimeError(f"fleet-scale day: rollup by {by} sums to "
                               f"{cut} Ws")
    sa = run["sampled"]
    if sa is None or not sa.ok:
        raise RuntimeError(f"fleet-scale day: sampled scale-up {sa}")
    chunks = fleet._acc.timings()
    if dev.type == "cuda" and not chunks:
        raise RuntimeError("fleet-scale day: no chunk of the booking plane "
                           "was timed on the card")
    fold = np.array([c["fold_ms"] for c in chunks] or [np.nan])
    h2d = np.array([c["h2d_ms"] for c in chunks] or [np.nan])
    curve = hourly_curve(fleet.events, np.asarray(arr.due, np.int64),
                         SCALE_NODES)
    res = {"arrivals": len(arr), "nodes": SCALE_NODES,
           "wall_s": run["wall_s"], "phase_s": phase_s,
           "arrivals_per_s": len(arr) / run["wall_s"],
           "steps": fleet.steps, "total_ws": led.total_ws,
           "billed_ws": billed, "infra_ws": infra,
           "placement_events": len(fleet.events),
           "chunks": len(chunks), "records": fleet._acc.records,
           "fold_ms": {"median": float(np.median(fold)),
                       "mean": float(fold.mean()), "max": float(fold.max()),
                       "total": float(fold.sum())},
           "h2d_ms": {"median": float(np.median(h2d)),
                      "mean": float(h2d.mean()), "max": float(h2d.max()),
                      "total": float(h2d.sum())},
           "peak_mb": torch.cuda.max_memory_allocated() / 1e6
           if dev.type == "cuda" else None,
           "sampled": {"requests": sa.sampled_requests,
                       "of": sa.total_requests, "scaled_ws": sa.scaled_ws,
                       "ledger_request_ws": sa.ledger_request_ws,
                       "error_ws": sa.error_ws,
                       "bound_ws": sa.error_bound_ws},
           "profile": fleet.summary().get("profile"),
           "hourly": curve, "flight": rows}
    trough = min(curve, key=lambda r: r["powered_nodes"])
    log(f"[fleet-scale] (c) {len(arr)} arrivals over {SCALE_NODES} nodes, "
        f"a simulated day ({SCALE_HOURS} h x {SCALE_STEPS_PER_HOUR} steps), "
        f"through launch.serve.run_vector --engine vector-torch --placement "
        f"gate: {run['wall_s']:.3f} s wall ({res['arrivals_per_s']:.0f} "
        f"simulated arrivals/s, {fleet.steps} fleet steps), every request "
        f"finished; total {led.total_ws:.3f} Ws at the H100 envelope, "
        f"bills sum to the ledger (rel 1e-9); {len(fleet.events)} placement "
        f"events, trough hour {trough['hour']} at "
        f"{trough['powered_nodes']}/{SCALE_NODES} nodes powered")
    log(f"[fleet-scale] (c) booking plane on {dev}: {len(chunks)} chunks "
        f"of up to 64 records ({fleet._acc.records} records); fold "
        f"{res['fold_ms']['median']:.4f} ms a chunk (median, CUDA events; "
        f"mean {res['fold_ms']['mean']:.4f}, total "
        f"{res['fold_ms']['total']:.1f} ms), H2D "
        f"{res['h2d_ms']['median']:.4f} ms a chunk (median; total "
        f"{res['h2d_ms']['total']:.1f} ms); the card holds only the "
        f"booking carries ({SCALE_NODES} nodes x {SCALE_TENANTS + 1} "
        f"tenants, float64) and the chunk in flight: peak "
        f"{res['peak_mb']} MB")
    log(f"[fleet-scale] (c) flight: sampled {sa.sampled_requests}/"
        f"{sa.total_requests} requests (rate {SCALE_SAMPLE:g}), scaled "
        f"{sa.scaled_ws:.2f} Ws vs ledger {sa.ledger_request_ws:.2f} Ws "
        f"request-phase (err {sa.error_ws:+.2f} Ws, bound "
        f"{sa.error_bound_ws:.2f} Ws); {len(rows)} snapshot rows")
    log("[fleet-scale] (c) hourly (hour: arrivals, powered nodes, "
        "gates/wakes): " + "; ".join(
            f"{r['hour']}: {r['arrivals']}, {r['powered_nodes']}, "
            f"{r['gates']}/{r['wakes']}" for r in curve))
    for row in rows:
        log("[fleet-scale] (c) flight row " + json.dumps(row))
    for line in text.getvalue().splitlines():
        if line.startswith("profile ") or line.startswith("flight "):
            log(f"[fleet-scale] (c) cli: {line}")
    return res


def phase_fleet_scale(dev=None) -> dict:
    """The vectorized fleet engines at the reference's scale rungs: (a)
    the control-plane twins, (b) the engine twins at fleet_scale's shape,
    (c) a simulated day of SCALE_DAY_ARRIVALS arrivals through the CLI's
    library entry on the torch booking plane.  (b)'s numpy arms run in
    forked processes while this one runs (b)'s torch arm and (c)."""
    dev = torch.device("cuda") if dev is None else dev
    t0 = time.perf_counter()
    out = {"control": control_twins(dev)}
    arms = start_numpy_arms()
    try:
        torch_arm = run_arm(dict(backend="torch", device=dev),
                            twin_arrivals())
        out["day"] = fleet_day(dev)
    finally:
        done = collect_arms(arms)
    out["engines"] = engine_twins(done, torch_arm)
    out["seconds"] = time.perf_counter() - t0
    log(f"[fleet-scale] phase: {out['seconds']:.1f} s")
    log("fleet-scale " + json.dumps({k: v for k, v in out.items()
                                     if k != "day"}))
    return out


def moe_drops(model, params, toks) -> list:
    """The share of its assignments each MoE layer drops at the config's
    capacity factor, over one forward of ``toks`` (the router run again
    on each layer's input beside the layer)."""
    from repro_torch.models import layers as L
    run, shares = L.run_moe, []

    def counting(p, x, cfg, plan):
        t = x.shape[0] * x.shape[1]
        _, _, idx = L.moe_route(p, x.reshape(t, -1), cfg, plan)
        _, keep = L.moe_slots(idx, cfg.moe.n_experts, L.moe_capacity(cfg, t))
        shares.append(1.0 - float(keep.float().mean()))
        return run(p, x, cfg, plan)
    L.run_moe = counting
    try:
        model.forward(params, {"tokens": toks})
    finally:
        L.run_moe = run
    return shares


def arch_batch(cfg, toks) -> dict:
    """A batch of ``toks``; a vision arch's prompt starts with its patch
    embeddings (random, seeded)."""
    batch = {"tokens": toks}
    if cfg.frontend == "vision_patches":
        g = torch.Generator(device="cuda").manual_seed(2)
        batch["patch_embeds"] = torch.randn(
            (toks.shape[0], cfg.n_patches, cfg.d_model), generator=g,
            device="cuda")
    return batch


def timed_prefill(model, params, toks) -> float:
    """Seconds of one warm prefill of ``toks`` at the model's own config
    and plan (a vision arch's prompt starting with its patch embeddings),
    after one untimed prefill."""
    cfg = model.cfg
    batch = arch_batch(cfg, toks)
    seconds = []
    for _ in range(2):
        cache = model.init_cache(*toks.shape)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last, _ = model.prefill(params, batch, cache)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    if not torch.isfinite(last).all():
        raise RuntimeError(f"{cfg.name}: non-finite prefill logits")
    log(f"[arch] {cfg.name} prefill 2x{toks.shape[1]} tokens, "
        f"{model.plan.compute_dtype}, its own config: {seconds[1]:.4f} s "
        f"warm ({seconds[0]:.4f} s cold)")
    return seconds[1]


def phase_forward(model, params, batch) -> dict:
    """The bf16 offload forward over ``batch`` against the f32 forward on
    stock ops (naive attention, stock MLP, no kernel), by each position's
    largest error as a share of max|logit|.  An encoder is held at
    ARCH_TOL at every position.  Else the stock-op bf16 forward is read
    too, and at the median position and the worst one the offload
    forward's error may be at most BF16_GAP_SLACK times the stock one's,
    or ARCH_TOL where that is larger: a bf16 rounding that flips a router's
    expert is the model's own bf16 gap, kernels or not."""
    cfg = model.cfg
    model.forward(params, batch)                        # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = model.forward(params, batch)
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    stock = model.plan.replace(attn_impl="xla", mlp_impl="xla")
    want = model.with_plan(stock.replace(compute_dtype="float32")).forward(
        params, batch).float()
    if not torch.isfinite(got).all():
        raise RuntimeError(f"{cfg.name}: non-finite forward logits")
    scale = float(want.abs().max())

    def spread(x) -> tuple:
        e = (x.float() - want).abs().amax(-1).flatten() / scale
        return float(e.median()), float(e.max())
    med, top = spread(got)
    out = {"forward_s": t_fwd, "median_err": med, "max_err": top,
           "logit_scale": scale,
           "argmax_agree": float((got.argmax(-1) == want.argmax(-1))
                                 .float().mean())}
    if cfg.is_encoder:
        limits = (ARCH_TOL, ARCH_TOL)
        rule = f"tol {ARCH_TOL}"
    else:
        out["stock_median_err"], out["stock_max_err"] = spread(
            model.with_plan(stock).forward(params, batch))
        limits = (max(ARCH_TOL, BF16_GAP_SLACK * out["stock_median_err"]),
                  max(ARCH_TOL, BF16_GAP_SLACK * out["stock_max_err"]))
        rule = (f"stock-op bf16 forward's median {out['stock_median_err']:.4f}"
                f" and max {out['stock_max_err']:.4f}; tol max({ARCH_TOL}, "
                f"{BF16_GAP_SLACK} x stock's)")
    unit = "frames" if cfg.is_encoder else "tokens"
    n = batch["features" if cfg.is_encoder else "tokens"].shape[1]
    log(f"[arch] {cfg.name} forward 2x{n} {unit}, bfloat16 offload plan: "
        f"{t_fwd:.4f} s; vs the f32 stock-op forward, by position: median "
        f"{med:.4f}, max {top:.4f} max|logit| ({rule}: {limits[0]:.4f}, "
        f"{limits[1]:.4f}); max|logit| {scale:.3f}; argmax agrees on "
        f"{out['argmax_agree']:.3f}")
    if med > limits[0] or top > limits[1]:
        raise RuntimeError(f"{cfg.name}: bf16 offload forward vs the f32 "
                           f"stock-op forward: median {med:.4f}, max "
                           f"{top:.4f} over {limits[0]:.4f}, {limits[1]:.4f}")
    return out


def run_arch(arch: str, counters: dict, smi: str) -> dict:
    """One arch of the MoE / LayerNorm / front-end slice at its published
    width under the offload plan, its depth cut as ARCH_LAYERS says:
    random weights (seed 0) on the card, then its checks: the bf16
    forward against the f32 stock-op forward (phase_forward); unless an
    encoder, a warm prefill, and prefill + decode against the forward (a
    MoE arch: the drops at its capacity factor, prefill + decode at
    MOE_HELD_FACTOR held in f32 and read in bf16, and granite-moe-1b-a400m
    also serving 8 requests; else held in bf16).  The launch counts are
    set to 0 just before and read just after."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    for k in counters.values():
        k.launches = 0
    t_start = time.perf_counter()
    pub = get_config(arch)
    layers, why = ARCH_LAYERS[arch]
    cfg = dataclasses.replace(pub, n_layers=layers)
    log(f"[arch] {arch}: layers {layers} of {pub.n_layers}"
        + (f" ({why})" if why else "") + f"; {smi}")
    model = Model(cfg, cfg.plan.replace(**OFFLOAD))
    torch.cuda.reset_peak_memory_stats()
    params = init_weights(model, 0)
    out: dict = {"layers": layers, "of": pub.n_layers}
    if cfg.is_encoder:
        g = torch.Generator(device="cuda").manual_seed(1)
        frames = torch.randn((2, 512, cfg.d_model), generator=g,
                             device="cuda")
        out["forward"] = phase_forward(model, params, {"features": frames})
    else:
        toks = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (2, 512)).astype(np.int32)).cuda()
        out["prefill_s"] = timed_prefill(model, params, toks)
        out["forward"] = phase_forward(model, params, arch_batch(cfg, toks))
        if cfg.moe is not None:
            drops = moe_drops(model, params, toks)
            out["dropped"] = drops
            log(f"[arch] {arch}: assignments dropped at capacity factor "
                f"{cfg.moe.capacity_factor} over 2x512 tokens, by layer: "
                f"mean {np.mean(drops):.4f}, max {max(drops):.4f}")
            held_cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=MOE_HELD_FACTOR))
            # the config's own plan sets the KV cache's dtype
            f32 = dataclasses.replace(held_cfg, plan=model.plan.replace(
                compute_dtype="float32", kv_cache_dtype="float32"))
            out["f32"] = phase_prefill(Model(f32), params,
                                       tol_share=MOE_F32_TOL)
            # in bf16 a router near-tie flips an expert where decode's
            # stock attention and the forward's kernel round differently:
            # read, not held (the forward above holds the bf16 path)
            out["prefill"] = phase_prefill(Model(held_cfg, model.plan),
                                           params, held=False)
        else:
            out["prefill"] = phase_prefill(model, params, tol_share=ARCH_TOL)
        if arch == "granite-moe-1b-a400m":
            out["serve_s"] = phase_serve(model, params)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["launches"] = {name: k.launches for name, k in counters.items()}
    out["seconds"] = time.perf_counter() - t_start
    log(f"[arch] {arch}: peak device memory {out['peak_gb']:.2f} GB; "
        f"launches {json.dumps(out['launches'])}; phase "
        f"{out['seconds']:.1f} s; {smi}")
    missing = [k for k in PATH_KERNELS[arch] if not out["launches"][k]]
    if missing:
        raise RuntimeError(f"{arch}: kernels of its path never launched: "
                           f"{missing} ({out['launches']})")
    return out


# ---------------------------------------------------------------------------
# phase 8: training
# ---------------------------------------------------------------------------

#: the three models' train paths at published width: the layers on the
#: card and why the depth is cut (AdamW with f32 parameters holds 16 B a
#: parameter: parameters, gradients and two moments).  recurrentgemma-9b
#: would fit 6 layers (two units; 73.1 GB at peak); it keeps the one unit
#: its earlier runs took (when its plain RG-LRU backward, a loop over
#: time, took 1.1 s a call), so that its steps compare with theirs
TRAIN_LAYERS = {
    "qwen2-7b": (8, "28 layers hold 122 GB of f32 params, grads and AdamW "
                    "moments"),
    "mamba2-1.3b": (48, ""),
    "recurrentgemma-9b": (3, "38 layers hold 148 GB of f32 params, grads "
                             "and AdamW moments; one unit (rec, rec, attn), "
                             "as in every run since the train phase began, "
                             "not the 6 layers that fit"),
}
#: the reference's train_4k (4096 x 256) with the batch cut to 4: under
#: the configs' own remat="full", microbatches=4, one sequence a microbatch
TRAIN_SHAPE = "train_4k_b4"
#: AdamW steps under the offload plan (the first held against the stock
#: f32 step), of TRAIN_STEPS_OF; cut (with the reason) where a step would
#: take the run past its hold
TRAIN_STEPS_OF = 4
TRAIN_STEPS = {
    "qwen2-7b": (4, ""),
    "mamba2-1.3b": (4, ""),
    "recurrentgemma-9b": (4, ""),
}
#: the kernels each train path must launch
TRAIN_KERNELS = {"qwen2-7b": ("flash_attention", "swiglu"),
                 "mamba2-1.3b": ("ssd",),
                 "recurrentgemma-9b": ("flash_attention", "rglru")}
#: the floor of the first step's hold, relative to the f32 value: one bf16
#: rounding (where the stock bf16 step happens to sit closer to f32)
TRAIN_FLOOR = 2.0 ** -8
#: a Function's gradients against autograd of its plain version on the
#: card: the same code on the same inputs, so bit for bit; where not, at
#: most this share of the gradient's largest element
GRAD_REL = 1e-6
#: the tiny-lm CLI run: 8 steps (of CLI_STEPS_OF, cut for the run's time:
#: each checkpoint writes tiny-lm's f32 weights and AdamW moments, about
#: 1.4 GB), a checkpoint every 4, a failure at 6
CLI_STEPS, CLI_EVERY, CLI_FAIL = 8, 4, 6
CLI_STEPS_OF = 12
#: the captured train step against the eager one, at published width and
#: train_4k_b4: the layers of each model (the fewest that hold a layer
#: loop and the residual across layers; recurrentgemma-9b's one unit, rec,
#: rec, attn) and the steps of each side
TRAIN_GRAPH_LAYERS = {"qwen2-7b": 2, "mamba2-1.3b": 2,
                      "recurrentgemma-9b": 3}
TRAIN_GRAPH_STEPS = 3


def timed_backward(fn, args, cots, reps: int) -> float:
    """Mean ms of the backward alone: ``fn``'s graph built once, then its
    gradients taken ``reps`` times (CUDA events)."""
    out = fn(*args)
    outs = out if isinstance(out, tuple) else (out,)
    return cuda_ms(lambda: torch.autograd.grad(outs, args, cots,
                                               retain_graph=True), reps, 1)


def function_case(name: str, fn, plain, library, args, hold, work: tuple,
                  reps: int, shape: str) -> dict:
    """One autograd Function at a training shape: the forward (the kernel)
    held by ``hold(got)``; the gradients against autograd of the
    plain version on the same inputs and cotangents (GRAD_REL); the
    kernel's forward, the Function's backward (the plain version
    rematerialized, then differentiated) and the plain graph's backward
    alone, beside the library's forward and backward (``library``: None
    where no PyTorch call computes it)."""
    from repro_torch.kernels import ops
    args = [a.detach().requires_grad_() for a in args]
    out = fn(*args)
    outs = out if isinstance(out, tuple) else (out,)
    with torch.no_grad():
        err = hold(tuple(o.detach() for o in outs) if isinstance(out, tuple)
                   else out.detach())
    g = torch.Generator(device="cuda").manual_seed(3)
    cots = [torch.randn(o.shape, generator=g, device="cuda").to(o.dtype)
            for o in outs]
    got = torch.autograd.grad(outs, args, cots)
    del out, outs
    pout = plain(*args)
    pouts = pout if isinstance(pout, tuple) else (pout,)
    ref_g = torch.autograd.grad(pouts, args, cots)
    del pout, pouts
    equal = all(torch.equal(a, b) for a, b in zip(got, ref_g))
    rel = max(float((a.float() - b.float()).abs().max())
              / max(float(b.float().abs().max()), 1e-30)
              for a, b in zip(got, ref_g))
    del got, ref_g
    if rel > GRAD_REL:
        raise RuntimeError(f"{name} Function: gradients {rel:.3e} of max "
                           f"from autograd of the plain version (> "
                           f"{GRAD_REL})")
    with torch.no_grad():
        ms = graph_ms(lambda: fn(*args), reps)
    ops_bwd = cuda_ms(lambda: ops._plain_vjp(name, plain, args, cots), reps,
                      1)
    row = {"max_abs_err": err, "grad_bit_equal": equal, "grad_max_rel": rel,
           "ms": ms, "function_bwd_ms": ops_bwd,
           "plain_bwd_ms": timed_backward(plain, args, cots, reps),
           **bound(*work), "shape": shape}
    if library is not None:
        lib_fn, lib_args = library
        lib_args = [a.detach().requires_grad_() for a in lib_args]
        with torch.no_grad():
            row["library_ms"] = cuda_ms(lambda: lib_fn(*lib_args), reps)
        lout = lib_fn(*lib_args)
        lcot = [torch.randn(lout.shape, generator=g, device="cuda")
                .to(lout.dtype)]
        del lout
        row["library_bwd_ms"] = timed_backward(lib_fn, lib_args, lcot, reps)
    else:
        row["library_ms"] = row["library_bwd_ms"] = None
    lib = "null" if row["library_ms"] is None else \
        f"{row['library_ms']:.4f} fwd, {row['library_bwd_ms']:.4f} bwd"
    log(f"[train] {name} Function ({shape}): forward max_err {err:.3e}; "
        f"gradients vs autograd of the plain version "
        f"{'bit-equal' if equal else f'{rel:.3e} of max'}; kernel fwd "
        f"{ms:.4f} ms (bound {row['bound_ms']:.4f}, {row['bound_by']}); "
        f"Function bwd (plain rematerialized + autograd) {ops_bwd:.4f} ms; "
        f"plain bwd alone {row['plain_bwd_ms']:.4f} ms; library "
        f"{lib}")
    return row


def phase_functions() -> dict:
    """Each autograd Function at its train path's shape (one sequence of
    TRAIN_SHAPE's 4096 tokens a microbatch), against its plain version on
    the card."""
    from repro_torch.configs.base import get_shape
    from repro_torch.kernels import ops, ref
    s, rows = get_shape(TRAIN_SHAPE).seq_len, {}
    g = torch.Generator(device="cuda").manual_seed(11)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale
                ).to(dtype)

    def flash(hq, hkv, d, window, label):
        q, k, v = randn(1, s, hq, d), randn(1, s, hkv, d), randn(1, s, hkv, d)

        def hold(got):
            want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                           True, window)
            return check(f"flash {label}", got, want,
                         ROUND * float(v.float().abs().max()) + BF16_TOL[0],
                         BF16_TOL[1])
        pos = torch.arange(s, device="cuda")
        keep = pos[None, :] <= pos[:, None]
        if window:
            keep &= pos[:, None] - pos[None, :] < window
        rep = hq // hkv

        def sdpa(a, b, c):
            a, b, c = (t.transpose(1, 2) for t in (
                a, b.repeat_interleave(rep, 2), c.repeat_interleave(rep, 2)))
            o = F.scaled_dot_product_attention(a, b, c, attn_mask=keep) \
                if window else F.scaled_dot_product_attention(a, b, c,
                                                              is_causal=True)
            return o.transpose(1, 2)
        pairs = int(keep.sum())
        work = (4.0 * hq * d * pairs, PEAK_BF16,
                (2 * q.numel() + k.numel() + v.numel()) * 2)
        return function_case(
            f"flash_attention {label}",
            lambda a, b, c: ops.flash_attention(a, b, c, True, window),
            lambda a, b, c: ref.flash_attention_ref(a, b, c, True, window),
            (sdpa, [q, k, v]), [q, k, v], hold, work, 5,
            f"B=1 S=T={s} Hq={hq} Hkv={hkv} D={d} bf16 causal"
            + (f" window {window}" if window else ""))
    rows["flash_attention"] = flash(28, 4, 128, 0, "qwen2-7b")
    rows["flash_attention_local"] = flash(16, 1, 256, 2048,
                                          "recurrentgemma-9b")

    d, f = 3584, 18944
    x = randn(s, d)
    wi, wg = randn(d, f, scale=d ** -0.5), randn(d, f, scale=d ** -0.5)
    wo = randn(f, d, scale=f ** -0.5)

    def swiglu_hold(got):
        x32, wi32, wg32, wo32 = (t.float() for t in (x, wi, wg, wo))
        a = F.silu(x32 @ wg32) * (x32 @ wi32)
        return check("swiglu", got, a @ wo32,
                     ROUND * (a.abs() @ wo32.abs()) + BF16_TOL[0],
                     BF16_TOL[1])

    def chain(xx, a, b, c):
        return (F.silu(xx @ b) * (xx @ a)) @ c
    rows["swiglu"] = function_case(
        "swiglu", ops.fused_swiglu, ref.swiglu_ref, (chain, [x, wi, wg, wo]),
        [x, wi, wg, wo], swiglu_hold,
        (6.0 * s * d * f, PEAK_BF16, (3 * d * f + 2 * s * d) * 2), 3,
        f"T={s} d={d} f={f} bf16")

    h, p, n, q = 64, 64, 128, 256
    sargs = [F.silu(randn(1, s, h, p, dtype=torch.float32)).bfloat16(),
             F.softplus(randn(1, s, h, dtype=torch.float32)),
             -torch.exp(0.2 * randn(h, dtype=torch.float32)),
             randn(1, s, n), randn(1, s, n)]

    def ssd_hold(got):
        f32 = [t.float() for t in sargs]
        return check_ssd("ssd", got, ref.ssd_ref(*f32, q), sargs, q)
    flops, nbytes = ssd_work(1, s, h, p, n, q, 2)
    rows["ssd"] = function_case(
        "ssd", lambda *a: ops.ssd(*a, chunk=q),
        lambda *a: ref.ssd_ref(*a, q), None, sargs, ssd_hold,
        (flops, PEAK_BF16, nbytes), 3,
        f"B=1 S={s} H={h} P={p} N={n} chunk {q}, x/B/C/y bf16")

    w = 4096
    u = torch.empty(w, device="cuda").uniform_(0.9 ** 2, 0.999 ** 2,
                                               generator=g)
    lam = torch.log(torch.exp(-torch.log(u) / 16.0) - 1.0)
    log_a = -8.0 * F.softplus(lam) * torch.sigmoid(
        randn(1, s, w, dtype=torch.float32))
    bb = torch.sqrt(1.0 - torch.exp(2.0 * log_a)) \
        * randn(1, s, w, dtype=torch.float32)
    rows["rglru"] = function_case(
        "rglru", ops.rglru, ref.rglru_ref, None, [log_a, bb],
        lambda got: check("rglru", got, ref.rglru_ref(log_a, bb), 2e-5,
                          2e-5),
        (3.0 * s * w, PEAK_F32, 12.0 * s * w), 5, f"B=1 S={s} W={w} f32")
    mem = autograd_bytes(ref.rglru_ref, [log_a, bb])
    rows["rglru"].update(mem)
    log(f"[train] rglru plain version (the associative scan) at B=1 S={s} "
        f"W={w}: keeps {mem['kept_bytes'] / 1e6:.1f} MB for its backward "
        f"(its output included), peak {mem['peak_bytes'] / 1e6:.1f} MB over "
        f"forward and backward; one (B,S,W) f32 tensor is "
        f"{4 * s * w / 1e6:.1f} MB")
    return rows


def autograd_bytes(fn, args) -> dict:
    """Device bytes that one call of ``fn`` under autograd keeps until its
    backward (its output included), and the most allocated over its
    forward and backward, both above what was allocated before."""
    args = [a.detach().requires_grad_() for a in args]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn(*args)
    kept = torch.cuda.memory_allocated() - base
    grads = torch.autograd.grad(out, args, torch.ones_like(out))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out, grads
    return {"kept_bytes": kept, "peak_bytes": peak}


def train_batches(cfg, shape, n: int) -> list:
    """The first ``n`` batches of the synthetic pipeline at ``shape``, on
    the card."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=shape.seq_len,
                                  global_batch=shape.global_batch))
    return [{k: torch.from_numpy(v).cuda() for k, v in data.batch(i).items()}
            for i in range(n)]


def first_step(model, params, batch) -> tuple:
    """The first step's loss and gradient norm (before the clip), without
    the update."""
    from repro_torch.train.step import (global_norm, make_grad_step,
                                        param_leaves)
    grads, loss = make_grad_step(model)(params, batch)
    gnorm = float(global_norm(param_leaves(model.cfg, grads)))
    return float(loss), gnorm


def run_train_path(arch: str, counters: dict, source, smi: str) -> dict:
    """One model's train path at published width, depth cut as
    TRAIN_LAYERS says: random weights (seed 0) on the card; the first
    step's loss and gradient norm under the stock plan in f32 and bf16
    compute; then, with the launch counts set to 0, TRAIN_STEPS[arch]
    steps of AdamW under the offload plan on SyntheticLM batches at
    TRAIN_SHAPE (the first held against the f32 stock step), and the
    measured rung's train trial at the same shape beside the analytic
    estimate; the counts read after."""
    import dataclasses
    import gc
    from repro_torch.configs import get_config
    from repro_torch.configs.base import get_shape
    from repro_torch.core.backends import (AnalyticBackend, MeasureContext,
                                           MeasuredBackend)
    from repro_torch.models.model import Model
    from repro_torch.telemetry.nvml import check_window
    from repro_torch.train.step import TrainGraph, make_opt_init
    t_start = time.perf_counter()
    pub = get_config(arch)
    layers, why = TRAIN_LAYERS[arch]
    steps, steps_why = TRAIN_STEPS[arch]
    cfg = dataclasses.replace(pub, n_layers=layers)
    shape = get_shape(TRAIN_SHAPE)
    log(f"[train] {arch}: layers {layers} of {pub.n_layers}"
        + (f" ({why})" if why else "") + f"; steps {steps} of "
        f"{TRAIN_STEPS_OF}" + (f" ({steps_why})" if steps_why else "")
        + f"; {TRAIN_SHAPE} ({shape.global_batch}"
        f" x {shape.seq_len}), remat {cfg.plan.remat}, microbatches "
        f"{cfg.plan.microbatches}, {cfg.optimizer}; {smi}")
    batches = train_batches(cfg, shape, steps)
    stock = Model(cfg)
    params = init_weights(stock, 0)
    out: dict = {"layers": layers, "of": pub.n_layers, "steps": steps,
                 "steps_of": TRAIN_STEPS_OF}
    for label, plan in (("stock_f32", cfg.plan.replace(
            compute_dtype="float32")), ("stock", cfg.plan)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[label] = first_step(Model(cfg, plan), params, batches[0])
        torch.cuda.synchronize()
        log(f"[train] {arch} first step, {label.replace('_', ' ')} plan "
            f"({plan.attn_impl}/{plan.mlp_impl}/{plan.ssm_impl}/"
            f"{plan.rglru_impl}, {plan.compute_dtype}): loss "
            f"{out[label][0]:.6f}, grad norm {out[label][1]:.6f} "
            f"({time.perf_counter() - t0:.2f} s)")

    for k in counters.values():
        k.launches = 0
    model = Model(cfg, cfg.plan.replace(**OFFLOAD))
    torch.cuda.reset_peak_memory_stats()
    opt = make_opt_init(model)(params)
    step = TrainGraph(model)
    losses, norms, seconds = [], [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, met = step(params, opt, b)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
        seconds.append(time.perf_counter() - t0)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out.update(losses=losses, grad_norms=norms,
               step_s={"first (eager + capture)": seconds[0],
                       "replays": seconds[1:]},
               capture_ms=step.capture_ms, pool_bytes=step.pool_bytes,
               launches_a_replay={k.name: n
                                  for k, n in step.launches.items()})
    if not all(math.isfinite(v) for v in losses + norms):
        raise RuntimeError(f"{arch}: non-finite train loss or grad norm "
                           f"({losses}, {norms})")
    ref32, ref16 = out["stock_f32"], out["stock"]
    for i, what in enumerate(("loss", "grad norm")):
        got, want = (losses[0], norms[0])[i], ref32[i]
        gap = abs(ref16[i] - want)
        limit = max(TRAIN_FLOOR * abs(want), BF16_GAP_SLACK * gap)
        log(f"[train] {arch} first step {what}: offload {got:.6f}, stock "
            f"f32 {want:.6f}, stock bf16 {ref16[i]:.6f}; |offload - f32| "
            f"{abs(got - want):.3e} (limit {limit:.3e} = max(2^-8 "
            f"|f32|, {BF16_GAP_SLACK} x the stock bf16 gap {gap:.3e}))")
        if abs(got - want) > limit:
            raise RuntimeError(f"{arch}: first step {what} {got} is "
                               f"{abs(got - want):.3e} from the stock f32 "
                               f"step's {want} (limit {limit:.3e})")
    log(f"[train] {arch} offload plan, {steps} AdamW steps through the "
        f"captured step: losses "
        + ", ".join(f"{v:.4f}" for v in losses) + "; grad norms "
        + ", ".join(f"{v:.4f}" for v in norms) + "; step s: first (eager "
        f"+ capture) {seconds[0]:.3f}, replays "
        + ", ".join(f"{v:.3f}" for v in seconds[1:])
        + f"; capture {step.capture_ms:.1f} ms, private pool "
        f"{step.pool_bytes} B, launches a replay "
        + json.dumps(out["launches_a_replay"])
        + f"; peak device memory {out['peak_gb']:.2f} GB; {smi}")
    del params, opt, step, model, stock, batches
    gc.collect()
    torch.cuda.empty_cache()

    plan = cfg.plan.replace(**OFFLOAD)
    ctx = MeasureContext(cfg, TRAIN_SHAPE)
    # one call after the warm-up suffices where a step outlasts the 5-s
    # window (mamba2-1.3b, recurrentgemma-9b)
    rung = MeasuredBackend(device="cuda", source=source, log=log,
                           min_calls=1)
    m = rung.measure(ctx, plan)
    if not m.ok:
        raise RuntimeError(f"{arch}: measured train trial failed: {m.error}")
    check_window(f"{arch} train trial", m.trace.meta["counter"])
    est = AnalyticBackend().measure(ctx, plan)
    out["trial"] = {"s": m.seconds, "w": m.watts, "ws": m.energy_j,
                    "peak_gb": m.peak_mem_per_chip / 1e9,
                    "calls": m.trace.meta["calls"],
                    "est_s": est.seconds, "est_w": est.watts,
                    "est_ws": est.energy_j}
    log(f"[train] {arch} measured train trial at {TRAIN_SHAPE}: "
        f"{m.seconds:.4f} s, {m.watts:.2f} W, {m.energy_j:.2f} Ws a step "
        f"(card-only; {m.trace.meta['calls']} steps in the window, peak "
        f"{m.peak_mem_per_chip / 1e9:.2f} GB); analytic estimate "
        f"{est.seconds:.4f} s, {est.watts:.2f} W, {est.energy_j:.2f} Ws; "
        f"{smi}")
    del rung, m
    gc.collect()
    torch.cuda.empty_cache()
    out["launches"] = {name: k.launches for name, k in counters.items()}
    out["seconds"] = time.perf_counter() - t_start
    log(f"kernels train {arch} " + json.dumps(out["launches"])
        + f"; phase {out['seconds']:.1f} s")
    missing = [k for k in TRAIN_KERNELS[arch] if not out["launches"][k]]
    if missing:
        raise RuntimeError(f"train {arch}: kernels of its path never "
                           f"launched: {missing} ({out['launches']})")
    return out


def _state_tensors(state: dict, prefix: str = "") -> dict:
    """path -> tensor of every tensor of a nested optimizer-state dict."""
    out = {}
    for k, v in state.items():
        if isinstance(v, dict):
            out.update(_state_tensors(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def train_graph_case(arch: str) -> dict:
    """One model's ``TrainGraph`` against ``make_train_step`` at published
    width, TRAIN_GRAPH_LAYERS[arch] layers, train_4k_b4 under the offload
    plan, deterministic algorithms on (set by the caller): from the same
    seeded weights, TRAIN_GRAPH_STEPS eager steps (their end state kept on
    the host, so that one model's state at a time lies on the card), then
    as many graph steps (the first eager with the capture, the rest
    replays).  Returns the tensors that differ (none when bit for bit),
    one eager step's launches and a replay's, and the capture's ms and
    pool bytes."""
    import dataclasses
    import gc
    from repro_torch.configs import get_config
    from repro_torch.configs.base import get_shape
    from repro_torch.kernels import flash_attention, mriq, rglru, ssd, swiglu
    from repro_torch.models.model import Model
    from repro_torch.train.step import (TrainGraph, make_opt_init,
                                        make_train_step)
    kernels = [m.KERNEL for m in (mriq, flash_attention, swiglu, ssd, rglru)]
    t0 = time.perf_counter()
    pub = get_config(arch)
    layers = TRAIN_GRAPH_LAYERS[arch]
    cfg = dataclasses.replace(pub, n_layers=layers)
    batches = train_batches(cfg, get_shape(TRAIN_SHAPE), TRAIN_GRAPH_STEPS)
    model = Model(cfg, cfg.plan.replace(**OFFLOAD))

    def run(step):
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        opt = make_opt_init(model)(params)
        mets, first = [], None
        for b in batches:
            counts = [k.launches for k in kernels]
            params, opt, met = step(params, opt, b)
            mets.append([met["loss"].clone(), met["grad_norm"].clone()])
            if first is None:
                first = {k.name: k.launches - n
                         for k, n in zip(kernels, counts) if k.launches != n}
        torch.cuda.synchronize()
        return params, opt, [[float(v) for v in m] for m in mets], \
            [[v.cpu() for v in m] for m in mets], first

    ep, eo, eager_mets, emets, eager_launches = run(make_train_step(model))
    host_p = {n: p.cpu() for n, p in ep.named_parameters()}
    host_o = {k: t.cpu() for k, t in _state_tensors(eo).items()}
    del ep, eo
    gc.collect()
    torch.cuda.empty_cache()
    graph = TrainGraph(model)
    gp, go, graph_mets, gmets, _ = run(graph)
    differ = []
    for i, (e, g) in enumerate(zip(emets, gmets)):
        for what, a, b in zip(("loss", "grad norm"), e, g):
            if not torch.equal(a, b):
                differ.append(f"step {i + 1} {what}")
    for n, p in gp.named_parameters():
        if not torch.equal(p.cpu(), host_p[n]):
            differ.append(f"parameter {n}")
    for k, t in _state_tensors(go).items():
        if not torch.equal(t.cpu(), host_o[k]):
            differ.append(f"optimizer state {k}")
    out = {"layers": layers, "of": pub.n_layers, "differ": differ,
           "eager": eager_mets, "graph": graph_mets,
           "eager_launches": eager_launches,
           "launches_a_replay": {k.name: n
                                 for k, n in graph.launches.items()},
           "capture_ms": graph.capture_ms, "pool_bytes": graph.pool_bytes,
           "n_params": len(host_p), "n_state": len(host_o)}
    del gp, go, graph, host_p, host_o
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


def check_train_graph(res: dict) -> None:
    """Log ``train_graph_case``'s result for each model and raise unless
    the loss, the gradient norm, every parameter and every
    optimizer-state tensor are bit for bit and a replay launches what one
    eager step does, kernel by kernel."""
    bad = []
    for arch in TRAIN_GRAPH_LAYERS:
        r = res[arch]
        log(f"[train-graph] {arch}, layers {r['layers']} of {r['of']}, "
            f"{TRAIN_SHAPE}, offload plan, deterministic: "
            f"{TRAIN_GRAPH_STEPS} eager steps against {TRAIN_GRAPH_STEPS} "
            f"graph steps (the first eager with the capture, then "
            f"replays): "
            + ("loss, grad norm, every parameter "
               f"({r['n_params']}) and optimizer-state tensor "
               f"({r['n_state']}) bit for bit" if not r["differ"] else
               "differ in " + ", ".join(r["differ"]))
            + "; losses " + ", ".join(f"{m[0]:.6f}" for m in r["graph"])
            + "; grad norms " + ", ".join(f"{m[1]:.6f}" for m in r["graph"])
            + f"; launches an eager step {json.dumps(r['eager_launches'])}"
            f", a replay {json.dumps(r['launches_a_replay'])}; capture "
            f"{r['capture_ms']:.1f} ms, private pool {r['pool_bytes']} B; "
            f"{r['seconds']:.1f} s")
        if r["differ"]:
            bad.append(f"{arch}: {r['differ'][:20]}")
        if r["eager_launches"] != r["launches_a_replay"] \
                or not r["eager_launches"]:
            bad.append(f"{arch}: a replay launches "
                       f"{r['launches_a_replay']}, an eager step "
                       f"{r['eager_launches']}")
    log(f"[time] the train graph check: {res['seconds']:.1f} s in the "
        f"train CLI's child")
    if bad:
        raise RuntimeError("train graph against the eager step: "
                           + "; ".join(bad))


def train_cli_child(root: str) -> int:
    """Deterministic algorithms on (``CUBLAS_WORKSPACE_CONFIG`` set by the
    parent): first the captured train step against the eager one
    (``train_graph_case`` for each of TRAIN_GRAPH_LAYERS, one JSON line),
    then the tiny-lm CLI on the card under the offload plan, its launches
    counted from 0: an uninterrupted run of CLI_STEPS steps, a run that
    fails at CLI_FAIL, and its resume from the last checkpoint (one JSON
    line)."""
    from repro_torch.configs import get_config
    from repro_torch.ft.driver import InjectedFailure
    from repro_torch.kernels import flash_attention, swiglu
    from repro_torch.launch import train as LT
    from repro_torch.models.model import Model
    torch.use_deterministic_algorithms(True)
    t0 = time.perf_counter()
    graph = {arch: train_graph_case(arch) for arch in TRAIN_GRAPH_LAYERS}
    graph["seconds"] = time.perf_counter() - t0
    print("GRAPH_RESULT " + json.dumps(graph), flush=True)
    for k in (flash_attention.KERNEL, swiglu.KERNEL):
        k.launches = 0
    cfg = get_config("tiny-lm")
    model = Model(cfg, cfg.plan.replace(**OFFLOAD))
    base = ["--arch", "tiny-lm", "--steps", str(CLI_STEPS), "--ckpt-every",
            str(CLI_EVERY), "--log-every", "4"]
    ref = LT.run(LT.parser().parse_args(
        base + ["--ckpt-dir", f"{root}/ref"]), model=model)
    failed = False
    try:
        LT.run(LT.parser().parse_args(
            base + ["--ckpt-dir", f"{root}/ft", "--fail-at",
                    str(CLI_FAIL)]), model=model)
    except InjectedFailure:
        failed = True
    res = LT.run(LT.parser().parse_args(
        base + ["--ckpt-dir", f"{root}/ft", "--resume"]), model=model)
    print("CLI_RESULT " + json.dumps({
        "ref": [r["loss"] for r in ref["losses"]],
        "resumed_steps": [r["step"] for r in res["losses"]],
        "resumed": [r["loss"] for r in res["losses"]], "failed": failed,
        "launches": {"flash_attention": flash_attention.KERNEL.launches,
                     "swiglu": swiglu.KERNEL.launches}}), flush=True)
    return 0


def phase_train_cli() -> dict:
    """The child process of ``train_cli_child`` (deterministic algorithms
    and their cuBLAS workspace stay out of the other phases): the
    captured train step against the eager one (``check_train_graph``),
    then ``launch.train.run`` on tiny-lm: the resumed losses equal the
    uninterrupted run's bit for bit, and the loss falls."""
    import os
    import shutil
    root = Path(__file__).resolve().parent / "artifacts" / "train_cli"
    shutil.rmtree(root, ignore_errors=True)
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           "--train-cli-child", str(root)],
                          capture_output=True, text=True, env=env,
                          timeout=600)
    for line in proc.stdout.splitlines():
        if not line.startswith(("CLI_RESULT", "GRAPH_RESULT")):
            log(f"[train-cli] {line}")
    if proc.returncode:
        raise RuntimeError(f"train CLI child exited {proc.returncode}: "
                           f"{proc.stderr[-3000:]}")
    check_train_graph(json.loads(next(
        line for line in proc.stdout.splitlines()
        if line.startswith("GRAPH_RESULT"))[13:]))
    res = json.loads(next(line for line in proc.stdout.splitlines()
                          if line.startswith("CLI_RESULT"))[11:])
    want = res["ref"][CLI_FAIL - CLI_FAIL % CLI_EVERY:]
    if not res["failed"]:
        raise RuntimeError("train CLI: the injected failure did not fire")
    if res["resumed_steps"] != list(range(CLI_FAIL - CLI_FAIL % CLI_EVERY,
                                          CLI_STEPS)):
        raise RuntimeError(f"train CLI resumed at {res['resumed_steps']}")
    if res["resumed"] != want:
        raise RuntimeError(f"train CLI: resumed losses {res['resumed']} "
                           f"differ from the uninterrupted {want}")
    first, last = np.mean(res["ref"][:4]), np.mean(res["ref"][-4:])
    if not last < first:
        raise RuntimeError(f"train CLI: loss did not fall ({res['ref']})")
    if not all(res["launches"].values()):
        raise RuntimeError(f"train CLI: kernels never launched "
                           f"({res['launches']})")
    res["seconds"] = time.perf_counter() - t0
    log(f"[train-cli] tiny-lm, offload plan, deterministic: {CLI_STEPS} "
        f"steps of {CLI_STEPS_OF} (cut for the run's time), failure at "
        f"{CLI_FAIL}, resumed from step "
        f"{res['resumed_steps'][0]}: resumed losses equal the uninterrupted "
        f"run's bit for bit; loss {first:.4f} -> {last:.4f} (mean of the "
        f"first and last 4); launches {json.dumps(res['launches'])}; "
        f"{res['seconds']:.1f} s")
    return res


#: the pod phase: qwen2-7b's layers in the rules step (a), the phase's
#: wall-time budget, and Steps 4-5's cost rates — one currency unit a
#: chip-hour and one a kWh, an operator's assumption for the smoke run,
#: not a price
POD_LAYERS = 2
POD_GRAPH_STEPS = 3
POD_BUDGET_S = 45.0
POD_SLICES = (64, 128, 256, 512)
POD_REL = 2.0 ** -8
#: the layer kinds the rules step must run on the tensor-parallel regions
POD_KINDS = {"attn", "embed", "logits", "loss", "mlp"}


def pod_state(model, rules=None) -> tuple:
    """``model``'s weights made from seed 0 and their AdamW state, laid out
    on ``rules``' mesh when given."""
    from repro_torch.parallel.param_sharding import distribute
    from repro_torch.train.step import make_opt_init
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    opt = make_opt_init(model)(params)
    if rules is not None:
        params, opt, _ = distribute(rules, params, opt)
    return params, opt


def whole(t) -> torch.Tensor:
    """A ``DTensor`` read whole; a plain tensor as it is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms for a block (the embedding's backward
    accumulates with atomics otherwise), with cuBLAS's deterministic
    workspace setting, which on the H100 is its default size."""
    import os
    before = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        if before is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = before


def pod_rules_steps(model, rules, batches, counters: dict) -> dict:
    """POD_GRAPH_STEPS AdamW steps of ``model`` under ``rules`` from seed
    0, first eagerly (``make_train_step(model, rules)``, the state laid
    back at its placements between steps as the graph does,
    ``train.step.pin_state``), then through ``TrainGraph(model, rules)``
    (the first call eager with the capture, then replays); deterministic
    algorithms on (set by the caller).  Returns each side's losses and
    grad norms, the tensors that differ (none when bit for bit: every
    local shard of the parameters and the state), the first eager step's
    routes, launches and collectives (``CommDebugMode``), a replay's
    launches, the collectives of the graph's first call (its eager step
    and the capture), the capture's ms and pool bytes, the graph's
    parameters (for the checkpoint) and the wall times."""
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.parallel.tp import record_routes
    from repro_torch.train.step import TrainGraph, make_train_step, pin_state

    def counts():
        return {name: k.launches for name, k in counters.items()}

    def comm_counts(mode) -> dict:
        return {str(op): n for op, n in mode.get_comm_counts().items()}
    out: dict = {}
    t0 = time.perf_counter()
    params, opt = pod_state(model, rules)
    step = make_train_step(model, rules)
    eager = []
    for i, b in enumerate(batches):
        if i == 0:
            n0 = counts()
            with record_routes() as routes, CommDebugMode() as comm:
                params, new, met = step(params, opt, b)
            out["routes"] = dict(routes)
            out["launches"] = {k: v - n0[k] for k, v in counts().items()}
            out["eager_comm"] = comm_counts(comm)
        else:
            params, new, met = step(params, opt, b)
        opt = pin_state(new, opt)
        eager.append([whole(met["loss"]).clone(),
                      whole(met["grad_norm"]).clone()])
    torch.cuda.synchronize()
    out["eager_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    gparams, gopt = pod_state(model, rules)
    graph = TrainGraph(model, rules)
    graphed = []
    for i, b in enumerate(batches):
        if i == 0:
            with CommDebugMode() as comm:
                gparams, gopt, met = graph(gparams, gopt, b)
            out["graph_comm"] = comm_counts(comm)
            torch.cuda.synchronize()
            out["first_s"] = time.perf_counter() - t0
            t1 = time.perf_counter()
        else:
            gparams, gopt, met = graph(gparams, gopt, b)
        graphed.append([whole(met["loss"]).clone(),
                        whole(met["grad_norm"]).clone()])
    torch.cuda.synchronize()
    out["replay_s"] = (time.perf_counter() - t1) / (len(batches) - 1)
    differ = []
    for i, (e, g) in enumerate(zip(eager, graphed)):
        for what, a, b in zip(("loss", "grad norm"), e, g):
            if not torch.equal(a, b):
                differ.append(f"step {i + 1} {what}")
    for (n, p), q in zip(params.named_parameters(), gparams.parameters()):
        if not torch.equal(p.to_local(), q.to_local()):
            differ.append(f"parameter {n}")
    gstate = _state_tensors(gopt)
    for k, t in _state_tensors(opt).items():
        if t.placements != gstate[k].placements \
                or not torch.equal(t.to_local(), gstate[k].to_local()):
            differ.append(f"optimizer state {k}")
    out.update(
        eager_mets=[[float(v) for v in m] for m in eager],
        graph_mets=[[float(v) for v in m] for m in graphed],
        differ=differ, n_params=len(list(gparams.parameters())),
        n_state=len(gstate), capture_ms=graph.capture_ms,
        pool_bytes=graph.pool_bytes,
        replay_launches={k.name: n for k, n in graph.launches.items()},
        params=gparams)
    return out


def pod_compiled(out: dict) -> None:
    """(d)-(f), on the host: the compiled rung's trial of qwen2-7b at
    decode_32k on pod16x16, its roofline row, and Steps 4-5."""
    from repro_torch.configs import get_config
    from repro_torch.core.adapt import (CostModel, adjust_placement,
                                        adjust_resources)
    from repro_torch.core.backends import (CompiledBackend, MeasureContext,
                                           load_record, plan_tag)
    from repro_torch.core.roofline import analyze_record
    cfg = get_config("qwen2-7b")
    t0 = time.perf_counter()
    rung = CompiledBackend()
    key = f"qwen2-7b__decode_32k__pod16x16_p{plan_tag(cfg.plan)}"
    for suffix in (".json", ".stages.json", ".trace.jsonl"):
        # a record cached by an earlier run would be served as this trial
        (rung.art_dir / f"{key}{suffix}").unlink(missing_ok=True)
    m = rung.measure(MeasureContext(cfg, "decode_32k", n_chips=256, tp=16),
                     cfg.plan)
    rec = load_record(rung.art_dir / f"{key}.json")
    if not m.ok:
        raise RuntimeError(f"compiled rung: {m.error}")
    out["compiled"] = {
        "s": m.seconds, "w": m.watts, "ws": m.energy_j,
        "stages": {s.name: s.t1 - s.t0 for s in m.trace.spans
                   if s.depth == 1},
        "flops": rec["flops"], "coll_bytes": rec["collectives"]["total_bytes"],
        "arg_bytes": rec["memory"]["argument_size_in_bytes"],
        "execution": rec["execution"], "wall_s": time.perf_counter() - t0}
    row = analyze_record(rec)
    out["roofline"] = {"dominant": row.dominant, "t_compute": row.t_compute,
                       "t_memory": row.t_memory,
                       "t_collective": row.t_collective,
                       "w_per_chip": row.watts_per_chip,
                       "useful": row.useful_ratio}
    cost = CostModel(hw_rate=1.0 / 3600.0, energy_rate=1.0 / 3.6e6)
    choices = adjust_resources(cfg, "train_4k", cfg.plan, POD_SLICES, cost)
    out["slices"] = [{"chips": c.chips, "s": c.measurement.seconds,
                      "ws": c.measurement.energy_j, "cost": c.cost}
                     for c in choices]
    out["placement"] = adjust_placement(choices[0].chips)


def phase_pod(counters: dict, smi: str) -> dict:
    """Phase 10 (module docstring): (a)-(c) on the card, then (d)-(f) on
    the host with the card idle (the dry run is a child process)."""
    import dataclasses
    import logging
    import shutil

    import torch.distributed as dist
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.configs.base import get_shape
    from repro_torch.launch.mesh import host_mesh
    from repro_torch.models.model import Model
    from repro_torch.parallel.param_sharding import shardings_of
    from repro_torch.parallel.sharding import make_rules
    from repro_torch.train import compress as C
    from repro_torch.train.step import make_train_step
    t0 = time.perf_counter()
    # DTensor's advice to flatten the mesh, once a redistribute: the (1, 1)
    # mesh has nothing to flatten
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    pub = get_config("qwen2-7b")
    cfg = dataclasses.replace(pub, n_layers=POD_LAYERS)
    plan = cfg.plan.replace(**OFFLOAD, fused_grad_reduce=True)
    batches = train_batches(cfg, get_shape(TRAIN_SHAPE), POD_GRAPH_STEPS)
    model = Model(cfg, plan)
    # the kernels' forwards, in each microbatch and again in its remat
    # recompute; the backwards are the plain versions
    want = POD_LAYERS * plan.microbatches * (2 if plan.remat == "full" else 1)
    out: dict = {"layers": POD_LAYERS, "of": pub.n_layers}
    with deterministic():
        for k in counters.values():
            k.launches = 0
        t1 = time.perf_counter()
        params, opt = pod_state(model)
        _, _, met = make_train_step(model)(params, opt, batches[0])
        loss0, gnorm0 = float(met["loss"]), float(met["grad_norm"])
        t_plain = time.perf_counter() - t1
        out["plain_launches"] = {name: k.launches
                                 for name, k in counters.items()}
        del params, opt, met
        torch.cuda.empty_cache()
        with host_mesh() as dm:
            rules = make_rules(cfg, dm, plan)
            for k in counters.values():
                k.launches = 0
            rs = pod_rules_steps(model, rules, batches, counters)
            params = rs.pop("params")
            out["rules_graph"] = rs
            routes = rs["routes"]
            out["routes"] = routes
            out["launches"] = {name: k.launches
                               for name, k in counters.items()}
            loss1, gnorm1 = rs["eager_mets"][0]
            gaps = [abs(loss1 - loss0) / abs(loss0),
                    abs(gnorm1 - gnorm0) / abs(gnorm0)]
            out.update(loss=(loss0, loss1), grad_norm=(gnorm0, gnorm1),
                       gaps=gaps, plain_s=t_plain)
            log(f"[pod] (a) qwen2-7b, layers {POD_LAYERS} of "
                f"{pub.n_layers}, {TRAIN_SHAPE}, offload plan, "
                f"fused_grad_reduce, AdamW, deterministic algorithms: "
                f"without rules loss {loss0!r}, grad norm {gnorm0!r}; "
                f"with rules on the {tuple(dm.shape)} host mesh "
                f"({dist.get_backend()}) loss {loss1!r}, grad norm "
                f"{gnorm1!r}"
                + ("; bit for bit" if gaps == [0.0, 0.0] else
                   f"; relative gaps {gaps[0]:.3e}, {gaps[1]:.3e} (limit "
                   f"2^-8)")
                + f"; launches in the first rules step "
                f"{json.dumps(rs['launches'])} (want {want} each of "
                f"flash_attention and swiglu: {POD_LAYERS} layers x "
                f"{plan.microbatches} microbatches x forward and remat "
                f"recompute); routes {json.dumps(routes)}; in the step "
                f"without rules {json.dumps(out['plain_launches'])}; the "
                f"step without rules (init, step and loss read) "
                f"{t_plain:.2f} s")
            log(f"[pod] (a) the rules step as a graph, "
                f"TrainGraph(model, rules): {POD_GRAPH_STEPS} eager rules "
                f"steps against {POD_GRAPH_STEPS} graph steps (the first "
                f"eager with the capture, then replays) from one seed: "
                + ("loss, grad norm, every parameter "
                   f"({rs['n_params']}) and optimizer-state ({rs['n_state']})"
                   f" shard bit for bit" if not rs["differ"] else
                   "differ in " + ", ".join(rs["differ"]))
                + "; losses " + ", ".join(f"{m[0]!r}"
                                          for m in rs["graph_mets"])
                + f"; launches an eager step {json.dumps(rs['launches'])}, "
                f"a replay {json.dumps(rs['replay_launches'])}; "
                f"collectives an eager rules step issues "
                f"{json.dumps(rs['eager_comm'])}, the graph's first call "
                f"(its eager step, the communicators made and the capture) "
                f"{json.dumps(rs['graph_comm'])} (a redistribute over a "
                f"one-rank mesh dim issues none); capture "
                f"{rs['capture_ms']:.1f} ms, private pool "
                f"{rs['pool_bytes']} B; eager steps "
                f"{rs['eager_s'] / POD_GRAPH_STEPS:.3f} s each (with the "
                f"state's init), the graph's first call "
                f"{rs['first_s']:.3f} s, a replay {rs['replay_s']:.3f} s")
            if set(routes) != POD_KINDS or set(routes.values()) != {"tp"}:
                raise RuntimeError(f"pod: the rules step ran the routes "
                                   f"{routes}, want the tensor-parallel "
                                   f"regions for {sorted(POD_KINDS)}")
            if max(gaps) > POD_REL:
                raise RuntimeError(f"pod: the rules step is {gaps} from the "
                                   f"step without rules (limit 2^-8)")
            short = {k: (rs["launches"][k], out["plain_launches"][k])
                     for k in ("flash_attention", "swiglu")
                     if (rs["launches"][k], out["plain_launches"][k])
                     != (want, want)}
            if short:
                raise RuntimeError(f"pod: launches (rules step, step "
                                   f"without rules) {short}, want {want} "
                                   f"each")
            if rs["differ"]:
                raise RuntimeError(f"pod: the rules graph's steps differ "
                                   f"from the eager rules steps in "
                                   f"{rs['differ'][:20]}")
            if rs["replay_launches"] != {k: n for k, n in
                                         rs["launches"].items() if n}:
                raise RuntimeError(f"pod: a replay launches "
                                   f"{rs['replay_launches']}, an eager "
                                   f"rules step {rs['launches']}")

            gen = torch.Generator(device="cuda").manual_seed(1)
            x = torch.randn((1 << 20,), generator=gen, device="cuda") * 5
            y = C.compressed_psum(x)
            step = float(C.quantize(x)[1].max()) * 0.5
            err = float((y - x).abs().max())
            out["psum"] = {"err": err, "half_step": step}
            log(f"[pod] (b) compressed_psum of 2^20 f32 on the card over the "
                f"one-rank group: max |y - x| {err:.3e} (limit half a "
                f"quantization step, {step:.3e})")
            if not err <= step + 1e-5:
                raise RuntimeError(f"pod: compressed_psum off by {err}")

            root = Path(__file__).resolve().parent / "artifacts" / "pod_ckpt"
            shutil.rmtree(root, ignore_errors=True)
            # layer 0's attention and norms: every kind of leaf the step
            # holds, at a ninth of the layer's bytes (its MLP is 0.81 GB)
            tree = {"p": {n: p for n, p in params.state_dict().items()
                          if n.startswith("layers.0.") and ".mlp." not in n}}
            nbytes = sum(t.to_local().numel() * t.to_local().element_size()
                         for t in tree["p"].values())
            t1 = time.perf_counter()
            ckpt.save(root, 1, tree)
            back, _ = ckpt.restore(root, 1, tree, shardings=shardings_of(tree))
            same = all(
                back["p"][n].placements == t.placements
                and torch.equal(back["p"][n].to_local(), t.to_local())
                for n, t in tree["p"].items())
            out["ckpt"] = {"bytes": nbytes, "s": time.perf_counter() - t1}
            log(f"[pod] (c) checkpoint of layer 0's {len(tree['p'])} "
                f"DTensor attention and norm parameters "
                f"({nbytes / 1e9:.3f} GB): saved and restored onto the "
                f"mesh's placements in {out['ckpt']['s']:.2f} s, "
                + ("bit for bit" if same else "DIFFERENT"))
            if not same:
                raise RuntimeError("pod: the restored parameters differ")
            del params, tree, back
            shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    host: dict = {}
    pod_compiled(host)
    out.update(host)
    c = host["compiled"]
    log(f"[pod] (d) compiled rung, qwen2-7b decode_32k on pod16x16 (host, "
        f"the card idle): "
        f"stages " + ", ".join(f"{k} {v:.2f} s" for k, v in
                               c["stages"].items())
        + f"; {c['s']:.2f} s, {c['w']:.2f} W, {c['ws']:.2f} Ws at the R740 "
        f"CPU-node envelope; {c['flops']:.4g} FLOPs, "
        f"{c['coll_bytes']:.4g} collective B a rank, "
        f"{c['arg_bytes']} argument B a rank; {c['wall_s']:.1f} s with "
        f"the child's start; execution {c['execution']!r}")
    r = host["roofline"]
    log(f"[pod] (e) roofline on the H100 spec: {r['dominant']}-bound, "
        f"t_compute {r['t_compute']:.6f} s, t_memory {r['t_memory']:.6f} s, "
        f"t_collective {r['t_collective']:.6f} s, {r['w_per_chip']:.1f} W "
        f"a chip, useful {r['useful']:.4f}")
    log("[pod] (f) Steps 4-5, qwen2-7b train_4k, analytic: "
        + ", ".join(f"{s['chips']} chips {s['s']:.4f} s {s['cost']:.6f}"
                    for s in host["slices"])
        + f" -> {host['slices'][0]['chips']} chips, "
        f"{host['placement']['pods']} pod(s), mesh "
        f"{host['placement']['mesh']}")
    out["seconds"] = time.perf_counter() - t0
    log(f"kernels pod " + json.dumps(out["launches"])
        + f"; phase {out['seconds']:.1f} s (budget {POD_BUDGET_S:.0f} s); "
        f"{smi}")
    if out["seconds"] > POD_BUDGET_S:
        raise RuntimeError(f"pod: the phase took {out['seconds']:.1f} s, "
                           f"over its {POD_BUDGET_S:.0f}-s budget")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    try:
        from repro_torch.kernels import (flash_attention, mriq, rglru, ssd,
                                         swiglu)
        from repro_torch.telemetry.nvml import NvmlSource
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing ({e})",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()

    def mark(what: str) -> None:
        log(f"[time] {what}: {time.perf_counter() - t_start:.1f} s since "
            f"the start")
    card = phase_card()
    phase_build()
    mark("build")
    rows = phase_kernels()
    mark("kernels")

    counters = {"mriq": mriq.KERNEL, "flash_attention": flash_attention.KERNEL,
                "swiglu": swiglu.KERNEL, "ssd": ssd.KERNEL,
                "rglru": rglru.KERNEL}
    launches = dict.fromkeys(counters, 0)
    source = NvmlSource(torch.device("cuda"))
    log(f"[nvml] {source.describe()} (bus {source.bus_id})")
    phase_calibrate(source)
    mark("calibrate")

    for arch in MODEL_PATHS:            # one model's weights at a time
        qwen = arch == "qwen2-7b"
        path = run_path(
            arch, counters,
            seeds=PREFILL_SEEDS if qwen else (0,),
            before=(lambda: phase_patterns(phase_fig5(source), source,
                                           card["smi"])) if qwen else None,
            after=(lambda m, p: phase_offload(m, p, source)) if qwen
            else None)
        for name, n in path["launches"].items():
            launches[name] += n
        if qwen:
            fleet = run_fleet(path["model"], path["params"], source,
                              counters)
            for name, n in fleet.items():
                launches[name] += n
            # the sharding plan as a path of its own: its two plans run
            # stock ops only, so its counts stay 0
            for k in counters.values():
                k.launches = 0
            phase_plans(path["model"], path["params"], source)
            log("kernels plans " + json.dumps(
                {name: k.launches for name, k in counters.items()}))
            mark("qwen2-7b's path before its serve profile")
            profile_serve(path["model"], path["params"], path["wall_s"])
        if arch == "mamba2-1.3b":
            profile_prefill(path["model"], path["params"], path["prefill_s"])
        del path
        torch.cuda.empty_cache()
        mark(f"{arch}'s path")
    # the vectorized fleet as a path of its own: it runs none of the five
    # kernels (its device work is stock torch ops), so its counts stay 0
    for k in counters.values():
        k.launches = 0
    phase_fleet_scale()
    log("kernels fleet-scale " + json.dumps(
        {name: k.launches for name, k in counters.items()}))
    mark("fleet scale")
    t_archs = time.perf_counter()
    for arch in ARCH_LAYERS:            # one arch's weights at a time
        out = run_arch(arch, counters, card["smi"])
        for name, n in out["launches"].items():
            launches[name] += n
        log(f"arch {arch} " + json.dumps(out))
        del out
        torch.cuda.empty_cache()
    log(f"[arch] the seven archs: {time.perf_counter() - t_archs:.1f} s")
    t_train = time.perf_counter()
    phase_functions()
    mark("the train Functions")
    for arch in TRAIN_LAYERS:           # one model's weights at a time
        out = run_train_path(arch, counters, source, card["smi"])
        for name, n in out["launches"].items():
            launches[name] += n
        log(f"train {arch} " + json.dumps(out))
        del out
        torch.cuda.empty_cache()
        mark(f"train {arch}")
    cli = phase_train_cli()
    mark("the train graph check and the train CLI")
    for name, n in cli["launches"].items():
        launches[name] += n
    log(f"[train] the train phase: {time.perf_counter() - t_train:.1f} s")
    pod = phase_pod(counters, card["smi"])
    for name, n in pod["launches"].items():
        launches[name] += n
    mark("pod")
    log("kernels " + json.dumps(launches))
    log(f"[done] {time.perf_counter() - t_start:.1f} s (hold {RUN_HOLD_S:.0f}"
        f" s)")

    kernels = []
    for name, (src, replaces) in SOURCES.items():
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        **rows[name]})
    print(card["smi"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card["kind"], "count": card["count"]}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--train-cli-child"]:
        sys.exit(train_cli_child(sys.argv[2]))
    sys.exit(main())
