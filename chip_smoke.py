#!/usr/bin/env python3
"""Checks of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

It checks and prints no time: a kernel alone is timed by
``scripts/profile_port.py``, the system by ``portbench/``. Phases, each
printing JSON lines; any failure raises and exits non-zero before the
final line:

1. device: the card's name and power limit (nvidia-smi), the torch and
   CUDA versions; the kernels built from ``src/repro_torch/kernels/csrc``
   (nvcc, at first use, into ``build/``), then ptxas's registers, spills
   and static shared memory per kernel.
2. kernels: each wire kernel against its plain PyTorch version on the
   card, bit for bit, on every parameter-leaf shape of the full-width
   char-LM (delta-like values), on edge cases and on the whole delta
   staged into one buffer as ``compress_decompress`` runs it. The
   quantizer also at block widths 128, 512 and 1,024 (its warp-per-block
   kernel), 100 and 257 (its CTA-per-row kernel) and on an input one
   value off a 16-byte boundary, bits 8 and 2; the top-k quantizer
   likewise at widths 128, 256, 384, 512 and 1,024 (its warp kernel) and
   100, 257 and one value off 16 bytes (its CTA kernel), k in {1, 2, 63,
   64, 65, block - 1}, each run checked to take the kernel it should.
   Every input is led by rows no healthy delta holds (``special_rows``:
   NaN, +-inf, subnormals, a scale that underflows, ties at the k-th
   magnitude), where the kernels must still follow the reference; top-k
   keeps exactly k per block, and every NaN on top of k.
   The masked-sum fold likewise, both entries (the uint64 one of the main
   path and the limb one of the TPU function's contract), at C in
   {1, 2, 6, 17} clients and n in {1, 511, 513, 1,900,800} columns
   (random and all-ones uint64), the uint64 entry also against
   ``np.add.reduce`` and on a view one column off a 16-byte boundary;
   and one full-width masked round through ``MaskedSumAggregator``, its
   mean against the plain mean. The flash-attention kernel against its
   plain version over f32 / bf16, D in {24, 64, 128, 192, 256}, GQA
   groups {1, 2, 4, 10} (10 at S <= 1,000), causal or not, window {None,
   64, 4096}, softcap {None, 50}, S in {1, 7, 128, 129, 1000, 8192} and
   B in {1, 2} (B = 1 only at S = 8192), and non-causal with q and k of
   different lengths (Sq in {1, 7, 129} against Sk in {128, 1000,
   4096}), at the tolerances below; then at each of the main path's
   shapes (``FLASH_TIMED``).
3. rounds: the full-width ``charlm-shakespeare`` model through five
   CAFL-L client rounds on the card (policy -> ``train_client`` x 6 ->
   ``aggregate`` -> ``apply_delta`` -> usage -> ``dual_update`` ->
   eval): three rounds from zero duals (q = 0, then q = 2), one at
   lambda_C = 0.5 (q = 1), one with ``wire_topk = 64`` (its six top-k
   launches must all take the warp kernel); every round's clients
   launch the fused AdamW kernel, and a q = 0 round no wire kernel. Then one
   client's first microbatch on the card and on the CPU from the same
   parameters and batch.
4. engine: ``repro_torch.launch.train.main(["--method", "both",
   "--rounds", "3", ...])`` in torch's default mode, its histories and
   checkpoints read back; then the CAFL-L engine with the sync and with
   the masked aggregator, both under
   ``torch.use_deterministic_algorithms(True)``, held to each other at
   the reference's tolerances (and the sync one set beside
   ``train.main``'s CAFL-L run). The masked run carries the runtime
   sanitizers (``repro_torch.analysis.runtime``): ``SyncGuardCallback``
   records each synchronising CUDA call of rounds 2 and 3 by call site (a
   ``sync_round`` line per round; a site outside ``EXPLICIT_READS``
   fails) and ``RecompileWatchCallback`` counts kernel library builds
   and loads and compiles per round (none after round 1).
5. fleet: CAFL-L for 2 rounds with the sequential and with the batched
   executor under deterministic algorithms, held to each other at 2e-3
   with equal knobs, participants and launch counts (but the
   optimizer's: only the sequential client runs the AdamW kernel). Then
   ``examples/async_fleet.py``'s fleet on the wall clock, 3 rounds with
   the sync barrier and with FedBuff (buffer 3): FedBuff must apply late
   reports and the barrier lose them. Then one 2-round run stacking
   ``cafl+adam``, the PI controller, the deadline-aware knob policy,
   ``paper+wire_mb+latency``, resource-aware sampling, Bernoulli churn,
   deadline stragglers and ``wire_topk = 64``: one top-k launch per
   compressed delta, every one on the warp kernel.
6. analysis: the schedule gate's three scenarios (``sync_ties``,
   ``masked_shuffle``, ``fedbuff_wall``) with the char-LM at full width
   in the gate's own setting (``SCHED_SETTING``), 4, 4 and 8 tie
   permutations, under deterministic algorithms: each ok, 0 races,
   something swapped; ``masked_shuffle`` folds through
   ``masked_sum_u64`` in every replay, and every q >= 1 round launches
   the wire kernels. Then the trace analysis (``drive_trace``): the
   static trace equal to ``TRACE_BUDGETS_TORCH.json`` with 0 findings;
   each of the 11 entries run once on the card, its static peak over
   ``MemTracker``'s within [0.5, 4.0], the wire tuples and the fold equal
   to the CPU twins'; the client's local step at full width at b 8 and
   32, static peak over ``max_memory_allocated`` within the band.
7. serve (``drive_serving``): Gemma2-9B at full width and depth (bf16,
   weights drawn on the card) on one 8,192-token prompt and 16 greedy
   decode steps: 42 flash launches per prefill, all on the tensor-core
   variant (``mma_bf16``); the last-token logits against the same model
   with the plain attention in its place (a); decode logits after the
   first and the last step against a prefill over the prompt plus the
   tokens so far (b); peak memory. Then Phi-3.5-MoE (16 of 32 layers)
   and DeepSeek-V3 (4 of 61 layers), full width: (b) at a capacity
   factor where nothing drops, its prefill on the experts decode chose
   (``routing_replay``), routing flips and drop shares printed;
   RecurrentGemma-2B, xLSTM-1.3B (check (b) in f32) and
   SeamlessM4T-medium at full width and depth. Bound: 2 x 2^-8 x
   sqrt(2 L) for L layers. Then ``serve_smoke``: each zoo config but
   Gemma2 at its SMOKE size, f32, prefill on the card against the CPU,
   within 1e-4.
8. train: ``launch.steps.make_train_step``. The char-LM and each zoo
   config at SMOKE size, f32, 2 AdamW steps (2 microbatches) on the card
   (deterministic) and on the CPU from the same weights: losses,
   each leaf's change and Adam's moments within their bounds. Then each
   zoo config at full width in bf16, depth ``TRAIN_DEPTH``, 2 AdamW steps
   of 2 x 4,096 tokens (xLSTM 2 x 64) in 2 microbatches under the
   freezing mask at k = 1: the loss finite and falling, every frozen
   part bit-equal, no flash launch, peak memory beside the port's
   dry-run estimate (``launch.dryrun``, in worker processes meanwhile).
   Then the fused AdamW kernel against the plain piece path, bit for bit
   (``adamw`` lines).
9. mesh: rank 0 of the 256-card mesh (data 16 x model 16, the
   ``default`` recipe, a fake process group), Gemma2-9B at full width and
   depth, each cell a rank's share of ``INPUT_SHAPES``: ``train_4k``,
   ``prefill_32k`` and ``decode_32k``, run on the dry-run's own step and
   arguments (``dryrun._step_and_args``), seeded, while the CPU dry-run
   of each cell runs in worker processes. One ``mesh`` line a cell:
   placements as ``specs.param_shardings`` gives them; the first run's
   collectives equal in count and bytes per type to the record's; peak
   memory over the record's in [0.8, 1.25]; host syncs of the later runs
   (printed); the flash kernel launched under the prefill and not under
   the train step, and on one layer's seeded share equal to its twin
   within the sweep's bound. The fake group moves no data.
10. the run's ``total`` seconds, a ``kernel_off_path`` line for the limb
   entry of the masked sum (no main path runs it: its launches must be
   0), the ``{"kernels": [...]}`` summary of the main paths' kernels
   (launches and largest error), the nvidia-smi line, and the final
   ``{"ok": true, ...}`` line.

Each path of phases 3 to 9 runs with the launch counters zeroed just
before it and read just after; phases 3 to 7 fail if a kernel of their
path was never launched, phase 8 if the flash kernel was launched under
a gradient, phase 9 on either.

Needs one card and the CUDA toolkit (nvcc); imports neither JAX nor the
JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Optional

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

BLOCK = 256
SOURCE = "src/repro_torch/kernels/csrc/wire_kernels.cu"
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
#: the summary's kernels of the main paths: (name, the TPU kernel it
#: replaces, its source); and the limb entry of the masked sum, which
#: serves the TPU function's contract and no main path
MAIN_KERNELS = (
    ("quantize_blocks", "src/repro/kernels/quantize.py:47", SOURCE),
    ("dequantize_blocks", "src/repro/kernels/quantize.py:65", SOURCE),
    ("quantize_topk_blocks", "src/repro/kernels/wire.py:84", SOURCE),
    ("masked_sum_u64", "src/repro/kernels/wire.py:130", SOURCE),
    ("flash_attention_bhsd", "src/repro/kernels/flash_attention.py:90",
     FLASH_SOURCE))
OFF_PATH_KERNEL = ("masked_sum_limbs", "src/repro/kernels/wire.py:130",
                   SOURCE)
#: rounds of each engine run (train.main's FedAvg and CAFL-L, the masked
#: CAFL-L run)
ENGINE_ROUNDS = 3
#: masked against sync, the reference's own bounds
#: (tests/test_fl_aggregator.py::test_engine_masked_matches_sync)
MASKED_TRAIN_ATOL = 1e-6
MASKED_VAL_ATOL = 2e-3
#: the fleet phase: rounds of the executor pair and of the stacked run,
#: rounds of each wall-clock run, and batched against sequential at the
#: reference's own bound
#: (tests/test_fl_engine.py::test_sequential_and_batched_histories_match)
FLEET_ROUNDS = 2
ASYNC_ROUNDS = 3
BATCHED_ATOL = 2e-3
#: the analysis phase: the schedule gate's permutations per scenario (the
#: reference's), run in the gate's own federated setting
SCHED_PERMUTATIONS = {"sync_ties": 4, "masked_shuffle": 4, "fedbuff_wall": 8}
SCHED_SETTING = ("the gate's scenarios as defined (3 rounds; 6 clients, 3 "
                 "a round, FedBuff over all 6; s_base 3, b_base 8, seq 16, "
                 "eval 1 x 8), the model at full width and depth: the "
                 "paper's 16-client fleet splits into tie groups of 5, 5 "
                 "and 6, which FedBuff's fills of 2 cannot align with")
#: the masked-sum cases: clients x columns (1,900,800 = the full-width
#: char-LM's parameter count, one round's fold)
SUM_COHORTS = (1, 2, 6, 17)
SUM_WIDTHS = (1, 511, 513, 1_900_800)
SUM_TIMED = (6, 1_900_800)
#: the quantizer's other block widths: multiples of 128 take its
#: warp-per-block kernel, the others its CTA-per-row kernel; rows not a
#: multiple of the warp kernel's 8 blocks per CTA
QUANT_WIDTHS = (128, 512, 1024, 100, 257)
QUANT_ROWS = 1001
#: the top-k kernel's block widths (multiples of 128 take its warp kernel,
#: the others its CTA kernel) and values of k at each (``topk_ks``)
TOPK_WIDTHS = (128, 256, 384, 512, 1024, 100, 257)


def topk_ks(block: int):
    return sorted({1, 2, 63, 64, 65, block - 1})


#: the flash kernel's sweep (see the docstring); heads are KVH = 2 times
#: the group size
FLASH_DTYPES = ("float32", "bfloat16")
FLASH_DIMS = (24, 64, 128, 192, 256)
FLASH_GROUPS = (1, 2, 4, 10)
#: the groups at S = 8,192 (group 10, RecurrentGemma's 10 heads over 1,
#: runs at S <= 1,000 only, to hold the sweep's time)
FLASH_GROUPS_LONG = (1, 2, 4)
FLASH_MASKS = [(causal, window, softcap) for causal in (True, False)
               for window in (None, 64, 4096) for softcap in (None, 50.0)]
FLASH_LENGTHS = (1, 7, 128, 129, 1000, 8192)
#: non-causal pairs with q and k of different lengths (the
#: cross-attention: Sq 4,096 in prefill and 1 in decode against Sk 4,096)
FLASH_CROSS = [(sq, sk) for sq in (1, 7, 129) for sk in (128, 1000, 4096)]
#: kernel vs plain version: f32 within 2e-5 at unit-scale inputs (both
#: fp32, summed in other orders); bf16 within one bf16 ulp of the larger
#: magnitude plus that f32 bound (both round an fp32 result once; the f32
#: term covers outputs near zero, where heads of both signs cancel)
FLASH_F32_ATOL = 2e-5
#: the serving run: Gemma2-9B, one prompt of 8,192 tokens, 16 decode steps
SERVE_PROMPT = 8192
SERVE_STEPS = 16
SERVE_REDUCES = ("prefill_32k (B=32, S=32,768): batch and length cut, "
                 "widths unchanged")


def serve_rel_l2(layers: int) -> float:
    """Logits against logits along the bf16 path, as ||a - b|| / ||b||.
    Each of the L layers rounds its residual update to bf16 (relative
    spacing 2^-8), independently in two runs that differ anywhere
    upstream, so two runs part by about 2^-8 * sqrt(2 L); the check
    allows twice that. It holds the kernel against the plain attention
    inside the model (a) and decode against prefill (b). Gemma2-9B's 42
    layers: 0.072."""
    return 2 * 2.0 ** -8 * math.sqrt(2 * layers)


#: the MoE serving runs (keyword arguments of ``drive_serving``): depth
#: cut to fit one card, widths as published; (b) at a capacity factor
#: where the capacity is the group size (Phi: 2048 x 2 x 8 / 16; DeepSeek:
#: 1024 x 8 x 32 / 256)
SERVE_MOE = dict(
    arch="phi3.5-moe-42b-a6.6b", phase="serve_moe", layers=16,
    prompt_len=8192, steps=16, check_capacity=8.0,
    reduces="depth 32 -> 16 layers (42 GB of bf16 weights at 16 layers, "
            "84 GB at 32); prefill_32k (B=32, S=32,768) cut in batch and "
            "length; capacity factor 1.25 -> 8 for the decode checks only; "
            "widths unchanged")
SERVE_MLA = dict(
    arch="deepseek-v3-671b", phase="serve_mla", layers=4, prompt_len=1024,
    steps=8, check_capacity=32.0,
    reduces="depth 61 -> 4 layers (the 3 dense prefix layers and 1 MoE "
            "layer: 31 GB of bf16 weights); prefill_32k (B=32, S=32,768) "
            "cut to one MoE group (B=1, S=1,024); capacity factor 1.25 -> "
            "32 for the decode checks only; widths unchanged")
#: the recurrent and encoder-decoder serving runs: full width and depth
SERVE_REC = dict(
    arch="recurrentgemma-2b", phase="serve_rec", prompt_len=8192, steps=16,
    reduces="prefill_32k (B=32, S=32,768): batch and length cut; all 26 "
            "layers, widths unchanged")
SERVE_XLSTM = dict(
    arch="xlstm-1.3b", phase="serve_xlstm", prompt_len=2048, steps=16,
    check_dtype=torch.float32,
    reduces="prefill_32k (B=32, S=32,768): batch and length cut, the "
            "length to 2,048 because each sLSTM layer steps once per token "
            "on the host; all 48 blocks, widths unchanged")
SERVE_ENCDEC = dict(
    arch="seamless-m4t-medium", phase="serve_encdec", prompt_len=4096,
    steps=16,
    reduces="prefill_32k (B=32, S=32,768): batch and length cut (S = 8,192 "
            "split as the reference's synthetic batch splits it: 4,096 "
            "source frames, 4,096 target tokens); all 12 + 12 layers, widths "
            "unchanged")
#: the serve_smoke phase: each new config at its SMOKE size, f32, card
#: against CPU, within this share of each tensor's largest magnitude
#: (fp32 on both, sums in other orders; no TF32)
SMOKE_ARCHS = ("qwen2-72b", "mistral-large-123b", "minitron-8b",
               "paligemma-3b", "phi3.5-moe-42b-a6.6b", "deepseek-v3-671b",
               "recurrentgemma-2b", "xlstm-1.3b", "seamless-m4t-medium")
SMOKE_CARD_RTOL = 1e-4
#: |loss(card) - loss(cpu)| / |loss(cpu)| allowed for one microbatch:
#: fp32 on both, sums taken in another order (no TF32 on the card)
CPU_CARD_RTOL = 1e-4
#: the train phase: ``launch.steps.make_train_step`` with AdamW at
#: ``train_4k``'s length (4,096) cut to batch 2 in 2 microbatches, under
#: a freezing mask at k = 1, 2 steps on the same batch. bf16 parameters
#: of |p| ~ 0.02 move by ~8 ulps at lr 1e-3.
TRAIN_SEQ = 4096
TRAIN_BATCH = 2
TRAIN_MICROBATCHES = 2
TRAIN_K = 1
TRAIN_STEPS = 2
TRAIN_LR = 1e-3
#: full-width depth of each zoo config in the step: as many layers as
#: fit at ~16 B a parameter (bf16 parameter and gradient, fp32 moments,
#: the fp32 accumulator of 2 microbatches) beside the activations, which
#: the port's dry-run estimates (``launch.dryrun``; <= ~76 GB). Widths
#: unchanged; SeamlessM4T, PaliGemma, RecurrentGemma and xLSTM whole;
#: 2 layers at least, so that k = 1 freezes a part (at depth 1 it
#: freezes nothing).
TRAIN_DEPTH = {
    "gemma2-9b": 13, "qwen2-72b": 2, "mistral-large-123b": 2,
    "minitron-8b": 8, "paligemma-3b": 18, "phi3.5-moe-42b-a6.6b": 2,
    "deepseek-v3-671b": 2, "recurrentgemma-2b": 26, "xlstm-1.3b": 48,
    "seamless-m4t-medium": 12}
TRAIN_NOTES = {
    "qwen2-72b":
        "2 of 80 layers (4.2 B parameters, 2.5 B of them the embedding and "
        "the head; dry-run 75.7 GB)",
    "deepseek-v3-671b":
        "2 of 61 layers, of the 3 of the dense MLA prefix: the prefix is "
        "not recomputed (as in the reference), so each prefix layer keeps "
        "~10 GB of 128-head scores at 4,096 tokens (dry-run: 94 GB at 3 "
        "layers, 74 GB at 2); one MoE layer is 11.9 B parameters (~140 GB "
        "with AdamW): MoE training at full width is Phi-3.5-MoE's",
    "xlstm-1.3b":
        "tokens cut to 2 x 64 (not the depth): each sLSTM layer steps once "
        "per token on the host, forward, recompute and backward (2 x 128: "
        "20 s on the card), and the dry-run traces every such step",
}
#: xLSTM's tokens per sequence in the full-width step
TRAIN_XLSTM_TOKENS = 64
TRAIN_REDUCES = ("train_4k (B 256, S 4,096): batch cut to 2 (2 "
                 "microbatches of 1), depth cut to fit (TRAIN_DEPTH); widths "
                 "unchanged")
#: the train phase at SMOKE size, f32: card against CPU, 2 steps each
#: from the same weights. The losses within ``TRAIN_SMOKE_RTOL``
#: relative; each leaf's change over the 2 steps (card against CPU)
#: within ``TRAIN_SMOKE_STEP_RTOL`` of that change's largest element, and
#: each leaf of Adam's mu and nu within ``TRAIN_SMOKE_STATE_RTOL`` of its
#: largest element. The moments see what Adam's normalisation hides from
#: the change: a gradient scaled by 2 (a wrong microbatch scale) moves
#: mu by 2x and nu by 4x. The bounds stand above the readings on the
#: H100 (changes 8.2e-4 to 1.9e-2, xLSTM's the largest; moments at most
#: 7.1e-6): Adam turns the float noise in a gradient near eps into a
#: visible part of that element's step. AdamW's eps is 1e-6 here: at its
#: default 1e-8 an element whose gradient is of order 1e-8 turns the
#: ~1e-9 float noise between card and CPU in that gradient into up to
#: half a step, so the change's check would measure Adam's amplification
#: of the noise rather than the card
TRAIN_SMOKE_LR = 1e-4
TRAIN_SMOKE_EPS = 1e-6
TRAIN_SMOKE_RTOL = 1e-4
TRAIN_SMOKE_STEP_RTOL = 5e-2
TRAIN_SMOKE_STATE_RTOL = 1e-4
#: the mesh phase: rank 0 of the single mesh (256 cards as data 16 x
#: model 16, the default recipe) over a fake process group, Gemma2-9B at
#: full width and depth, each cell's local share of INPUT_SHAPES: the
#: train step (16 x 4,096 a rank) twice, the prefill (2 x 32,768) twice,
#: the decode step (8 over a 32,768-slot cache split over model, 32,000
#: tokens in) four times; the first run of each counts the collectives,
#: the others the host syncs. Peak memory over the port's CPU dry-run record
#: of the same cell within MESH_MEMORY_BAND.
MESH_ARCH = "gemma2-9b"
MESH_RUNS = {"train_4k": 2, "prefill_32k": 2, "decode_32k": 4}
MESH_FILLED = 32_000
MESH_MEMORY_BAND = (0.8, 1.25)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def delta_like(gen: torch.Generator, shape) -> torch.Tensor:
    """Update-like values: normal x 1e-3, ~5% exact zeros, and a run of
    tied magnitudes of both signs at the front."""
    x = torch.randn(shape, generator=gen) * 1e-3
    x[torch.rand(shape, generator=gen) < 0.05] = 0.0
    flat = x.view(-1)
    if flat.numel() > 64:
        flat[:32] = flat[40]
        flat[32:40] = -flat[40]
    return x


def special_rows(gen: torch.Generator, block: int, k: int) -> torch.Tensor:
    """Rows no healthy delta holds, where the wire kernels must still
    follow the reference: a NaN, two NaNs (one negative), +inf, -inf, a
    NaN beside +inf, a quarter NaNs, absmax 1e-37 (a scale that underflows
    at 8 bits), only subnormals (the reference flushes them to zero),
    subnormals and zeros around the k-th magnitude, one magnitude, ties
    straddling the k-th magnitude, and two rows of subnormals whose scale
    (at 8 and at 2 bits) lies in [2^-126, 2^-125): (13, block) f32 on
    the CPU."""
    def base():
        return torch.randn(block, generator=gen) * 1e-3

    def pick(values):
        values = torch.tensor(values, dtype=torch.float32)
        return values[torch.randint(len(values), (block,), generator=gen)]

    def perm():
        return torch.randperm(block, generator=gen)

    nan, inf = float("nan"), float("inf")
    rows = [base() for _ in range(7)]
    rows[0][block // 3] = nan
    rows[1][0] = nan
    rows[1][-1] = torch.copysign(torch.tensor(nan), torch.tensor(-1.0))
    rows[2][block // 2] = inf
    rows[3][7] = -inf
    rows[4][3], rows[4][block - 5] = inf, nan
    rows[5][perm()[:block // 4]] = nan
    rows[6] = rows[6] / rows[6].abs().max() * 1e-37
    rows.append(pick([2e-40, 1e-40, -2e-40, 5e-45, -1e-39]))
    r = torch.where(torch.arange(block) % 2 == 0, pick([3e-40, -3e-40, 1e-41]),
                    pick([0.0, -0.0]))
    r[perm()[:k // 2]] = base()[:k // 2] + 1e-2
    rows.append(r)
    rows.append(pick([0.25, -0.25]))
    n_big, m = max(min(k - 3, block - 8), 0), 5e-3
    r = (torch.rand(block, generator=gen) * 0.8 + 0.1) * m
    order = perm()
    r[order[:n_big]] = m * (1.5 + 2.5 * torch.rand(n_big, generator=gen))
    r[order[n_big:n_big + 7]] = pick([m, -m])[:7]
    rows.append(r)
    for absmax, normal in ((2e-36, 3e-38), (1.5e-38, -1.3e-38)):
        r = torch.zeros(block)
        r[1::3], r[2::3] = 1.1e-38, -9e-39
        r[0], r[4] = absmax, normal
        rows.append(r)
    return torch.stack(rows)


def kept_per_row(x: torch.Tensor, k: int) -> torch.Tensor:
    """The reference's top-k mask row sums: every NaN is kept on top of
    min(k, the row's non-NaN count)."""
    nan = torch.isnan(x).sum(dim=1)
    return torch.clamp(x.shape[1] - nan, max=k) + nan


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def max_gap(*pairs) -> float:
    """Largest |a - b| over the (kernel, plain) output pairs, as float64;
    0 where both are the same infinity or both NaN, inf where one is NaN
    and the other not, or a pair's shapes differ."""
    worst = 0.0
    for a, b in pairs:
        if a.shape != b.shape:
            return math.inf
        if a.numel():
            x, y = a.double(), b.double()
            gap = torch.where((x == y) | (x.isnan() & y.isnan()), 0.0,
                              (x - y).abs())
            worst = max(worst, float(gap.nan_to_num(nan=math.inf).max()))
    return worst


# ---------------------------------------------------------------------------
# phase 2: kernels
# ---------------------------------------------------------------------------


def check_kernels(leaves, dev) -> dict:
    """Hold each kernel against its plain version on the card, on the
    same inputs: each leaf's blocks, edge cases, and the whole delta
    staged into one buffer as ``compress_decompress`` hands it to the
    kernels (whose round trip must also equal the per-leaf plain one).
    Returns each kernel's largest |kernel - plain| over all its outputs
    and cases (codes, scales and mask included). Any bit of difference
    fails the run."""
    from repro_torch.core.compression import compress_decompress, stage_blocks
    from repro_torch.kernels import cuda_lib, ops, quantize, ref, wire
    gen = torch.Generator().manual_seed(7)
    edge = [torch.zeros(()), torch.zeros((0,)), torch.zeros((512,)),
            delta_like(gen, (1,)), delta_like(gen, (1000,)),
            delta_like(gen, (3, 129)), special_rows(gen, BLOCK, 64)]
    edge[4][256:512] = 0.0                             # an all-zero row
    cases = [x.to(dev) for x in edge] + list(leaves)
    worst = dict.fromkeys(("quantize_blocks", "dequantize_blocks",
                           "quantize_topk_blocks"), 0.0)
    staged = stage_blocks(list(leaves), BLOCK)[0]
    for x in cases + [staged]:
        blocks = stage_blocks([x], BLOCK)[0]
        for bits in (8, 2):
            c, s = quantize.quantize_blocks(blocks, bits)
            rc, rs = ref.quantize_blocks_ref(blocks, bits)
            d = quantize.dequantize_blocks(rc, rs)
            rd = ref.dequantize_blocks_ref(rc, rs)
            torch.cuda.synchronize()
            worst["quantize_blocks"] = max(worst["quantize_blocks"],
                                           max_gap((c, rc), (s, rs)))
            worst["dequantize_blocks"] = max(worst["dequantize_blocks"],
                                             max_gap((d, rd)))
            check(bits_equal(c, rc) and bits_equal(s, rs),
                  f"quantize_blocks differs at {tuple(x.shape)} bits={bits}")
            check(bits_equal(d, rd),
                  f"dequantize_blocks differs at {tuple(x.shape)}")
            for k in (32, 64):
                got = wire.quantize_topk_blocks(blocks, bits, k)
                want = ref.quantize_topk_blocks_ref(blocks, bits, k)
                torch.cuda.synchronize()
                worst["quantize_topk_blocks"] = max(
                    worst["quantize_topk_blocks"], max_gap(*zip(got, want)))
                check(all(bits_equal(g, w) for g, w in zip(got, want)),
                      f"quantize_topk_blocks differs at {tuple(x.shape)} "
                      f"bits={bits} k={k}")
                # exactly k per block, and every NaN on top of k
                check(torch.equal(got[2].sum(dim=1, dtype=torch.int64),
                                  kept_per_row(blocks, k)),
                      f"top-k did not keep min(k, non-NaN) + NaN per block "
                      f"at {tuple(x.shape)} k={k}")
            y = ops.quantize_dequantize(x, bits=bits, topk=64)
            check(bits_equal(y, ref.quantize_dequantize_ref(x, bits, topk=64)),
                  f"ops.quantize_dequantize differs at {tuple(x.shape)}")
    # the quantizer at other widths and one value off a 16-byte boundary
    # (the CTA-per-row kernel at the main path's width), each input led by
    # the NaN, inf and subnormal rows
    def sweep_rows(block, k):
        x = delta_like(gen, (QUANT_ROWS, block))
        rows = special_rows(gen, block, k)
        x[:len(rows)] = rows
        x[-1] = 0.5                                   # one magnitude
        return x

    flat = torch.cat([torch.zeros(1), sweep_rows(BLOCK, 64).view(-1)]).to(dev)
    offset = flat[1:].view(QUANT_ROWS, BLOCK)
    check(offset.data_ptr() % 16 != 0, "the offset input is aligned")
    for x2d in [sweep_rows(w, 64).to(dev) for w in QUANT_WIDTHS] + [offset]:
        for bits in (8, 2):
            c, s = quantize.quantize_blocks(x2d, bits)
            rc, rs = ref.quantize_blocks_ref(x2d, bits)
            torch.cuda.synchronize()
            worst["quantize_blocks"] = max(worst["quantize_blocks"],
                                           max_gap((c, rc), (s, rs)))
            check(bits_equal(c, rc) and bits_equal(s, rs),
                  f"quantize_blocks differs at block {x2d.shape[1]} (base "
                  f"{x2d.data_ptr() % 16} bytes off 16) bits={bits}")
    # the top-k kernels: the warp kernel at multiples of 128 (QUANT_ROWS
    # rows, so the last CTA is ragged), the CTA kernel at other widths and
    # one value off a 16-byte boundary
    for block in TOPK_WIDTHS:
        for k in topk_ks(block):
            x2d = sweep_rows(block, k).to(dev)
            inputs = [(x2d, block % 128 == 0)]
            if block == BLOCK:
                flat = torch.cat([torch.zeros(1, device=dev), x2d.view(-1)])
                inputs.append((flat[1:].view(QUANT_ROWS, block), False))
            for x_in, warp in inputs:
                for bits in (8, 2):
                    before = dict(cuda_lib.TOPK_VARIANTS)
                    got = wire.quantize_topk_blocks(x_in, bits, k)
                    want = ref.quantize_topk_blocks_ref(x_in, bits, k)
                    torch.cuda.synchronize()
                    kernel = "warp" if warp else "cta"
                    check(cuda_lib.TOPK_VARIANTS[kernel] == before[kernel] + 1,
                          f"quantize_topk_blocks at block {block} (base "
                          f"{x_in.data_ptr() % 16} bytes off 16) did not take "
                          f"its {kernel} kernel")
                    worst["quantize_topk_blocks"] = max(
                        worst["quantize_topk_blocks"], max_gap(*zip(got, want)))
                    check(all(bits_equal(g, w) for g, w in zip(got, want)),
                          f"quantize_topk_blocks differs at block {block} "
                          f"(base {x_in.data_ptr() % 16} bytes off 16) "
                          f"bits={bits} k={k}")
                    check(torch.equal(got[2].sum(dim=1, dtype=torch.int64),
                                      kept_per_row(x_in, k)),
                          f"top-k kept the wrong count at block {block} k={k}")
    tree = {f"leaf{i}": x for i, x in enumerate(cases)}
    for q, topk in ((1, None), (2, None), (2, 64)):
        got = compress_decompress(tree, q, topk=topk)
        for name, x in tree.items():
            want = ref.quantize_dequantize_ref(x, 8 if q == 1 else 2,
                                               topk=topk)
            check(bits_equal(got[name], want),
                  f"compress_decompress differs from the per-leaf plain "
                  f"round trip at {tuple(x.shape)} q={q} topk={topk}")
    return worst


def check_masked_sum(dev) -> dict:
    """Both masked-sum entries against their plain versions on the card,
    bit for bit, on random and all-ones uint64 cohorts: ``masked_sum_u64``
    on the values' int64 bits (also against ``np.add.reduce``, and on a
    view one column off a 16-byte boundary), ``masked_sum_limbs`` on their
    uint32 limbs. Returns each entry's largest |kernel - plain|."""
    from repro_torch.kernels import ops, ref, wire
    rng = np.random.default_rng(11)
    worst = {"masked_sum_u64": 0.0, "masked_sum_limbs": 0.0}

    def check_u64(bits, vals, what):
        got = wire.masked_sum_u64(bits)
        want = ref.masked_sum_u64_ref(bits)
        torch.cuda.synchronize()
        worst["masked_sum_u64"] = max(worst["masked_sum_u64"],
                                      max_gap((got, want)))
        check(bits_equal(got, want), f"masked_sum_u64 differs from its "
              f"plain version at {what}")
        check(np.array_equal(got.cpu().numpy().view(np.uint64),
                             np.add.reduce(vals, axis=0)),
              f"masked_sum_u64 differs from np.add.reduce at {what}")

    for c in SUM_COHORTS:
        for n in SUM_WIDTHS:
            for fill in ("random", "ones"):
                if fill == "ones":
                    vals = np.full((c, n), 2 ** 64 - 1, dtype=np.uint64)
                else:
                    vals = rng.integers(0, 2 ** 64, size=(c, n),
                                        dtype=np.uint64)
                check_u64(torch.from_numpy(vals.view(np.int64)).to(dev),
                          vals, f"C={c} n={n} {fill}")
                hi, lo = (torch.from_numpy(x).to(dev)
                          for x in ops.split_limbs(vals))
                got = wire.masked_sum_limbs(hi, lo)
                want = ref.masked_sum_ref(hi, lo)
                torch.cuda.synchronize()
                gap = max_gap(*((g.view(torch.int32).long() & 0xFFFFFFFF,
                                 w.view(torch.int32).long() & 0xFFFFFFFF)
                                for g, w in zip(got, want)))
                worst["masked_sum_limbs"] = max(worst["masked_sum_limbs"],
                                                gap)
                check(all(bits_equal(g, w) for g, w in zip(got, want)),
                      f"masked_sum_limbs differs at C={c} n={n} {fill}")
                if fill == "random" and n == SUM_WIDTHS[-1]:
                    # the host-level fold too, against NumPy's uint64 sum
                    check(np.array_equal(ops.masked_sum_u64(vals, device=dev),
                                         np.add.reduce(vals, axis=0)),
                          f"ops.masked_sum_u64 differs at C={c}")
    # a view one column off a 16-byte boundary: the scalar kernel at the
    # main path's shape
    c, n = SUM_TIMED
    vals = rng.integers(0, 2 ** 64, size=(c, n), dtype=np.uint64)
    flat = torch.from_numpy(np.concatenate(
        [np.zeros(1, np.uint64), vals.reshape(-1)]).view(np.int64)).to(dev)
    offset = flat[1:].view(c, n)
    check(offset.data_ptr() % 16 == 8, "the offset view is aligned")
    check_u64(offset, vals, f"C={c} n={n}, one column off 16 bytes")
    return worst


def masked_round(dev, model):
    """One full-width masked round, not yet run: a ``MaskedSumAggregator``
    begun over FedAvg's 6 clients, one report per client (the delta:
    1e-3 x the parameters) -> (aggregator, reports, parameters)."""
    from repro_torch.configs.charlm_shakespeare import FL
    from repro_torch.core.policy import fedavg_knobs
    from repro_torch.fl import (ClientInfo, ClientReport, DeviceProfile,
                                FedAvg, MaskedSumAggregator)
    params = model.init(torch.Generator().manual_seed(3), dev).params()
    cohort = [ClientInfo(i, DeviceProfile("default", FL.budgets), 1)
              for i in range(FL.clients_per_round)]
    kn = fedavg_knobs(FL)
    agg = MaskedSumAggregator()
    agg.reset(FedAvg(FL).aggregate)
    agg.begin_round(1, cohort)
    reports = [ClientReport(client=ci, delta={k: v * 1e-3 for k, v in
                                              params.items()},
                            weight=1.0, knobs=kn, policy_knobs=kn,
                            round_trained=1) for ci in cohort]
    return agg, reports, params


def check_masked_mean(update, params) -> float:
    """The masked round's mean back on the card and within 1e-6 of the
    plain mean -> its largest |error|."""
    mean = update.delta
    check(all(t.is_cuda for t in mean.values()),
          "the masked mean did not come back on the card")
    err = max(float((mean[k] - params[k] * 1e-3).abs().max()) for k in mean)
    check(err <= 1e-6, f"masked mean off the plain mean by {err}")
    return err


def check_masked_round(dev, model) -> dict:
    """One full-width masked round (``masked_round``): each client's
    ``submit`` (fixed point + 5 pairwise masks of 1.9M uint64), then the
    ``flush`` (the fold, the mean back on the card)."""
    agg, reports, params = masked_round(dev, model)
    for report in reports:
        agg.submit(report)
    err = check_masked_mean(agg.flush(1), params)
    return {"phase": "masked_round", "clients": len(reports),
            "columns": sum(t.numel() for t in params.values()),
            "mean_max_abs_err": err}


def flash_inputs(gen, b, s, h, kvh, d, dtype, dev, sk=None):
    """Unit-normal q (B,S,H,D), k and v (B,Sk,KVH,D) on the card (Sk = S
    unless given)."""
    sk = s if sk is None else sk
    return [torch.randn((b, n, heads, d), generator=gen, device=dev).to(
        getattr(torch, dtype)) for n, heads in ((s, h), (sk, kvh), (sk, kvh))]


def flash_gap(got, want, dtype: str):
    """(largest |kernel - plain|, whether every value is within the
    stated bound)."""
    got, want = got.double(), want.double()
    gap = (got - want).abs()
    if dtype == "bfloat16":
        _, e = torch.frexp(torch.maximum(got.abs(), want.abs()).float())
        bound = torch.ldexp(torch.ones_like(gap), e - 8) + FLASH_F32_ATOL
    else:
        bound = torch.full_like(gap, FLASH_F32_ATOL)
    return float(gap.max()), bool((gap <= bound).all())


def check_flash(dev) -> dict:
    """``flash_attention_bhsd`` against its plain version on the card over
    the sweep and the non-causal Sq != Sk pairs; fails on any value
    outside the bound. Returns the largest |kernel - plain| per dtype
    and the number of cases."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(21)
    worst = dict.fromkeys(FLASH_DTYPES, 0.0)
    cases = 0

    def hold(q, k, v, what, **kw):
        nonlocal cases
        got = ops.flash_attention(q, k, v, **kw)
        want = ref.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        dtype = str(q.dtype).split(".")[-1]
        gap, ok = flash_gap(got, want, dtype)
        worst[dtype] = max(worst[dtype], gap)
        cases += 1
        check(got.dtype == q.dtype and ok,
              f"flash_attention_bhsd differs at {what} {dtype} {kw}: max "
              f"|gap| {gap}")

    for s in FLASH_LENGTHS:
        for b in ((1,) if s == 8192 else (1, 2)):
            for dtype in FLASH_DTYPES:
                for d in FLASH_DIMS:
                    for g in (FLASH_GROUPS_LONG if s > 1000
                              else FLASH_GROUPS):
                        q, k, v = flash_inputs(gen, b, s, 2 * g, 2, d, dtype,
                                               dev)
                        for causal, window, softcap in FLASH_MASKS:
                            hold(q, k, v, f"B={b} S={s} D={d} g={g}",
                                 causal=causal, window=window,
                                 softcap=softcap)
    for sq, sk in FLASH_CROSS:
        for dtype in FLASH_DTYPES:
            for d in FLASH_DIMS:
                for g in FLASH_GROUPS:
                    q, k, v = flash_inputs(gen, 1, sq, 2 * g, 2, d, dtype,
                                           dev, sk=sk)
                    for softcap in (None, 50.0):
                        hold(q, k, v, f"Sq={sq} Sk={sk} D={d} g={g}",
                             causal=False, softcap=softcap)
    return {"phase": "flash_check", "cases": cases, "max_abs_err": worst,
            "f32_atol": FLASH_F32_ATOL, "bf16_bound": "1 bf16 ulp + f32_atol"}


#: (label, B, Sq, Sk, H, KVH, D, dtype, causal, window, softcap) at the
#: main path's shapes: Gemma2's global and local layers, a Phi-3.5-MoE
#: layer, a DeepSeek-V3 MLA layer, a RecurrentGemma local layer, a
#: SeamlessM4T encoder layer (also its prefill cross-attention's shape)
#: in prefill, SeamlessM4T's cross-attention in decode (one query over
#: 4,096 source frames), and the char-LM eval (its FL config's seq_len
#: 32; also at FLConfig's default 128)
FLASH_TIMED = (
    ("gemma2 global layer", 1, 8192, 8192, 16, 8, 256, "bfloat16", True,
     None, 50.0),
    ("gemma2 local layer", 1, 8192, 8192, 16, 8, 256, "bfloat16", True,
     4096, 50.0),
    ("phi3.5-moe layer", 1, 8192, 8192, 32, 8, 128, "bfloat16", True, None,
     None),
    ("deepseek-v3 mla layer, v padded", 1, 1024, 1024, 128, 128, 192,
     "bfloat16", True, None, None),
    ("recurrentgemma local layer", 1, 8192, 8192, 10, 1, 256, "bfloat16",
     True, 2048, None),
    ("seamless-m4t encoder layer", 1, 4096, 4096, 16, 16, 64, "bfloat16",
     False, None, None),
    ("seamless-m4t decode cross-attention", 1, 1, 4096, 16, 16, 64,
     "bfloat16", False, None, None),
    ("charlm eval", 64, 32, 32, 8, 8, 24, "float32", True, None, None),
    ("charlm eval, S = 128", 64, 128, 128, 8, 8, 24, "float32", True, None,
     None),
)


def check_flash_shapes(dev) -> float:
    """The flash kernel against its plain version at each of the main
    path's shapes (``FLASH_TIMED``), at the sweep's bounds; a
    ``flash_shape`` line each -> the largest |kernel - plain|."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import variant
    gen = torch.Generator(device=dev).manual_seed(22)
    worst = 0.0
    for (label, b, sq, sk, h, kvh, d, dtype, causal, window,
         softcap) in FLASH_TIMED:
        q, k, v = flash_inputs(gen, b, sq, h, kvh, d, dtype, dev, sk=sk)
        kw = dict(causal=causal, window=window, softcap=softcap)
        got = ops.flash_attention(q, k, v, **kw)
        want = ref.flash_attention_ref(q, k, v, **kw)
        gap, ok = flash_gap(got, want, dtype)
        check(got.dtype == q.dtype and ok,
              f"flash_attention_bhsd differs at the {label} shape: max "
              f"|gap| {gap}")
        emit({"phase": "flash_shape", "shape": label,
              "variant": variant(q.dtype, d), "batch": b, "seq": sq,
              "seq_k": sk, "heads": h, "kv_heads": kvh, "head_dim": d,
              "dtype": dtype, **kw, "max_abs_err": gap})
        worst = max(worst, gap)
    return worst


# ---------------------------------------------------------------------------
# phase 3: the CAFL-L client rounds
# ---------------------------------------------------------------------------


def n_active_closed_form(cfg, params, k: int) -> int:
    """Exact trainable-parameter count at freezing depth ``k``: the top
    ``k`` units, the final norm, and the embeddings only when nothing is
    frozen."""
    n = 0
    k = max(1, min(k, cfg.num_layers))
    for name, t in params.items():
        path = name.split(".")
        if path[:2] == ["stack", "units"]:
            n += t.numel() // t.shape[0] * k
        elif path[1] in ("embed", "pos_embed"):
            n += t.numel() if k >= cfg.num_layers else 0
        else:
            n += t.numel()
    return n


def wire_mb_closed_form(n_active: int, q: int, topk) -> float:
    """Bytes per trainable parameter: 4 at q=0; 1 + 1/64 (int8 + the fp32
    scale of a 256-block) at q=1; 1/4 + 1/64 at q=2; with top-k, the kept
    codes, a 1-bit mask and the scale: (topk*bits + 288) / 2048."""
    if q == 0:
        per_param = 4.0
    elif topk is None or topk >= BLOCK:
        per_param = (1.0 if q == 1 else 0.25) + 1 / 64
    else:
        per_param = (topk * (8 if q == 1 else 2) + 288) / 2048
    return n_active * per_param / 1e6


def drive_rounds(dev, cfg, fl, ds):
    """Five CAFL-L client rounds on ``dev``; returns the initial params,
    the per-round records and the summed launch counts."""
    from repro_torch.core import (RESOURCES, DualState, aggregation,
                                  calibrate, dual_update, make_eval_fn,
                                  policy)
    from repro_torch.core.client import ClientRunner
    from repro_torch.core.freezing import count_params
    from repro_torch.data import FederatedData
    from repro_torch.kernels import cuda_lib, ops
    from repro_torch.models import build

    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(fl.seed), dev).params()
    init_params = {k: v.clone() for k, v in params.items()}
    data = FederatedData(ds.train, fl.num_clients, seed=fl.seed,
                         noniid_alpha=fl.noniid_alpha)
    resources = calibrate(count_params(params), fl)
    evaluate = make_eval_fn(model, ds, fl, device=dev)
    rng = np.random.default_rng(fl.seed)
    duals = DualState()
    schedule = [("cafl", None), ("cafl", None), ("cafl", None),
                ("lambda_c=0.5", None), ("wire_topk=64", 64)]
    records = []
    ops.reset_launches()
    for t, (mode, topk) in enumerate(schedule, start=1):
        if mode == "lambda_c=0.5":
            duals = DualState(lam={r: (0.5 if r == "comm" else 0.0)
                                   for r in RESOURCES})
        run_fl = fl.replace(wire_topk=topk)
        runner = ClientRunner(model, run_fl, data, resources, device=dev)
        val_loss = evaluate(params)
        kn = policy(duals, run_fl)
        clients = rng.choice(fl.num_clients, size=fl.clients_per_round,
                             replace=False)
        before = dict(ops.LAUNCHES)
        before_topk = dict(cuda_lib.TOPK_VARIANTS)
        results = [runner.train_client(int(c), params, kn) for c in clients]
        torch.cuda.synchronize()
        launched = {k: ops.LAUNCHES[k] - before[k] for k in before}
        topk_kernels = {k: cuda_lib.TOPK_VARIANTS[k] - before_topk[k]
                        for k in before_topk}
        params = aggregation.apply_delta(
            params, aggregation.aggregate([r.delta for r in results]))
        usages = [resources.usage(r.params_active, kn) for r in results]
        mean = {r: sum(u[r] for u in usages) / len(usages)
                for r in RESOURCES}
        duals = dual_update(duals, mean, fl.budgets, fl.duals)

        n_active = n_active_closed_form(cfg, params, kn.k)
        want_mb = wire_mb_closed_form(n_active, kn.q, topk)
        rec = {"phase": "round", "round": t, "mode": mode,
               "clients": [int(c) for c in clients], "knobs": kn.as_dict(),
               "val_loss": val_loss,
               "train_loss": float(np.mean([r.train_loss for r in results])),
               "wire_mb_actual": results[0].wire_mb_actual,
               "wire_mb_closed_form": want_mb,
               "params_active": results[0].params_active,
               "launches": launched, "topk_kernels": topk_kernels,
               "duals_after": dict(duals.lam)}
        emit(rec)
        records.append(rec)

        check(math.isfinite(val_loss) and all(
            math.isfinite(r.train_loss) for r in results),
            f"round {t}: non-finite loss")
        for r in results:
            check(r.wire_mb_actual == want_mb,
                  f"round {t}: wire_mb_actual {r.wire_mb_actual} != closed "
                  f"form {want_mb}")
            check(abs(r.params_active - n_active) <= 1e-6 * n_active,
                  f"round {t}: params_active {r.params_active} != {n_active}")
        # each client's local steps run the fused AdamW kernel
        check(launched["adamw_update"] > 0,
              f"round {t}: the clients' AdamW launched no kernel: "
              f"{launched}")
        # one launch of each wire kernel per client delta: its 16 leaves
        # are staged into one buffer of blocks (compress_decompress)
        per_client = len(results)
        if kn.q == 0:
            wire = {k: n for k, n in launched.items() if k != "adamw_update"}
            check(not any(wire.values()),
                  f"round {t}: wire kernels launched at q=0: {launched}")
        else:
            quant = ("quantize_topk_blocks" if topk is not None
                     else "quantize_blocks")
            check(launched[quant] == per_client
                  and launched["dequantize_blocks"] == per_client,
                  f"round {t}: expected {per_client} launches of {quant} "
                  f"and dequantize_blocks, got {launched}")
            # the staged buffer is aligned and 256 wide: the warp kernel
            check(topk_kernels["cta"] == 0 and topk_kernels["warp"] ==
                  launched["quantize_topk_blocks"],
                  f"round {t}: top-k launches by kernel {topk_kernels}")
    check(records[0]["knobs"]["q"] == 0, "round 1 must run at q=0")
    check(records[1]["knobs"]["q"] == 2 and records[2]["knobs"]["q"] == 2,
          "rounds 2-3 must run at q=2")
    check(records[3]["knobs"]["q"] == 1, "round 4 must run at q=1")
    check(records[4]["knobs"]["q"] >= 1, "round 5 must run at q>=1")
    return init_params, records, dict(ops.LAUNCHES)


def cpu_card_microbatch(cfg, fl, ds, params):
    """One client's first microbatch through the train loss on the card
    and on the CPU, from the same parameters and batch."""
    from repro_torch.data import FederatedData
    from repro_torch.models import build

    model = build(cfg)
    data = FederatedData(ds.train, fl.num_clients, seed=fl.seed)
    batch = data.batch(0, fl.b_base, fl.seq_len)
    losses = {}
    for dev in ("cuda", "cpu"):
        p = {k: v.to(dev) for k, v in params.items()}
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        with torch.no_grad():
            losses[dev] = float(model.train_loss(p, b)[0])
    rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    emit({"phase": "cpu_vs_card", "loss_cuda": losses["cuda"],
          "loss_cpu": losses["cpu"], "rel_diff": rel, "rtol": CPU_CARD_RTOL})
    check(rel <= CPU_CARD_RTOL, f"card and CPU losses differ by {rel}")


# ---------------------------------------------------------------------------
# phase 4: the engine through its entry points
# ---------------------------------------------------------------------------


def engine_rounds(method: str, aggregator: str, mode: str, history) -> None:
    for r in history:
        rec = r if isinstance(r, dict) else r.__dict__
        emit({"phase": "engine_round", "method": method,
              "aggregator": aggregator, "mode": mode,
              **{k: rec[k] for k in ("round", "knobs", "val_loss",
                                     "train_loss", "duals", "participants",
                                     "wire_mb_actual")}})


@contextlib.contextmanager
def deterministic():
    """``torch.use_deterministic_algorithms(True)`` for the block. Every
    output of the engine is written in full, so fresh tensors need no
    pre-fill."""
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = fill


def drive_train(dev, out_dir: str):
    """``launch.train.main`` (FedAvg then CAFL-L, sync aggregator) on the
    card, in torch's default (nondeterministic) mode as a user runs it;
    its histories and checkpoints read back. The launch counts are zeroed
    just before it and read just after."""
    from repro_torch import checkpointing
    from repro_torch.configs import get_fl_config
    from repro_torch.core.duals import DualState
    from repro_torch.core.policy import fedavg_knobs, policy
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    out = os.path.join(out_dir, "fl")
    ops.reset_launches()
    results = train.main(["--method", "both", "--rounds", str(ENGINE_ROUNDS),
                          "--out", out, "--device", str(dev), "--quiet"])
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    fl = get_fl_config().replace(rounds=ENGINE_ROUNDS)
    for method, res in results.items():
        with open(f"{out}_{method}.json") as f:
            payload = json.load(f)
        check(payload["method"] == method and
              len(payload["history"]) == ENGINE_ROUNDS,
              f"{method}: history file does not hold {ENGINE_ROUNDS} rounds")
        engine_rounds(method, "sync", "default", payload["history"])
        prev = DualState()
        for r in res.history:
            check(math.isfinite(r.val_loss) and math.isfinite(r.train_loss),
                  f"{method} round {r.round}: non-finite loss")
            check(all(lam >= 0.0 for lam in r.duals.values()),
                  f"{method} round {r.round}: negative dual {r.duals}")
            want = (fedavg_knobs(fl) if method == "fedavg"
                    else policy(prev, fl)).as_dict()
            check(r.knobs == want, f"{method} round {r.round}: knobs "
                  f"{r.knobs} do not follow the duals ({want})")
            prev = DualState(lam=dict(r.duals))
        back = checkpointing.load(f"{out}_{method}.ckpt", res.final_params)
        check(all(bits_equal(back[k], v)
                  for k, v in res.final_params.items()),
              f"{method}: checkpoint does not read back with the same bits")
    check(any(r.knobs["q"] > 0 for r in results["cafl"].history),
          "CAFL-L never compressed")
    check(launches["quantize_blocks"] > 0
          and launches["dequantize_blocks"] > 0,
          f"the engine path launched no wire kernel: {launches}")
    check(launches["flash_attention_bhsd"] > 0,
          f"the engine's eval launched no flash kernel: {launches}")
    emit({"phase": "engine", "runs": "train.main --method both",
          "mode": "default", "launches": launches})
    return results["cafl"].history, launches


def drive_masked(dev, default_cafl):
    """The CAFL-L engine twice more on the card, with the sync and then
    the masked aggregator, held to each other at the reference's own
    tolerances. Those assume a deterministic backend; left to its atomic
    adds (the embedding lookup's backward), an H100 does not repeat a run
    bit for bit, and one masked run's train loss parted from its sync
    run's by 1.7e-6. So both run under
    ``torch.use_deterministic_algorithms(True)``; every output is written
    in full, so fresh tensors need no pre-fill. ``default_cafl`` (the
    CAFL-L history of ``drive_train``, default mode, same seed) is set
    beside the deterministic sync run: participants and knobs must be
    equal, and the loss gaps are the card's nondeterminism, reported."""
    from repro_torch.analysis.runtime import (RecompileWatchCallback,
                                              SyncGuardCallback)
    from repro_torch.configs import get_config, get_fl_config
    from repro_torch.data import load_corpus
    from repro_torch.fl import FederatedEngine
    from repro_torch.kernels import ops
    from repro_torch.models import build

    ds = load_corpus()
    cfg = get_config("charlm-shakespeare")
    if cfg.vocab_size < ds.vocab_size:
        cfg = cfg.replace(vocab_size=ds.vocab_size)
    fl = get_fl_config().replace(rounds=ENGINE_ROUNDS)
    guard, watch = SyncGuardCallback(from_round=2), RecompileWatchCallback()
    with deterministic():
        runs, launches = {}, {}
        for aggregator in ("sync", "masked"):
            engine = FederatedEngine(
                build(cfg), fl, ds, strategy="cafl", aggregator=aggregator,
                callbacks=[guard, watch] if aggregator == "masked" else [],
                device=dev)
            ops.reset_launches()
            try:
                runs[aggregator] = engine.run().history
            finally:
                guard.close()
            torch.cuda.synchronize()
            launches[aggregator] = dict(ops.LAUNCHES)
            engine_rounds("cafl", aggregator, "deterministic",
                          runs[aggregator])
            emit({"phase": "engine", "runs": f"cafl {aggregator}",
                  "mode": "deterministic",
                  "launches": launches[aggregator]})
    sync, masked = runs["sync"], runs["masked"]
    for aggregator, counts in launches.items():
        check(counts["quantize_blocks"] > 0
              and counts["dequantize_blocks"] > 0
              and counts["flash_attention_bhsd"] > 0,
              f"the {aggregator} engine run launched no wire or flash "
              f"kernel: {counts}")
    with_reports = sum(1 for r in masked if r.participants)
    check(launches["masked"]["masked_sum_u64"] == with_reports
          and launches["masked"]["masked_sum_limbs"] == 0,
          f"{launches['masked']['masked_sum_u64']} masked_sum_u64 and "
          f"{launches['masked']['masked_sum_limbs']} masked_sum_limbs "
          f"launches for {with_reports} rounds with reporters (expected "
          f"one uint64 fold each and no limbs)")
    for a, b in zip(sync, masked):
        check(a.participants == b.participants,
              f"round {a.round}: masked participants {b.participants} != "
              f"sync {a.participants}")
        check(abs(a.train_loss - b.train_loss) <= MASKED_TRAIN_ATOL,
              f"round {a.round}: masked train loss {b.train_loss} vs sync "
              f"{a.train_loss}")
        check(abs(a.val_loss - b.val_loss) <= MASKED_VAL_ATOL,
              f"round {a.round}: masked val loss {b.val_loss} vs sync "
              f"{a.val_loss}")
    for a, b in zip(default_cafl, sync):
        check(a.participants == b.participants and a.knobs == b.knobs,
              f"round {a.round}: the default-mode run's participants or "
              f"knobs differ from the deterministic run's")
    emit({"phase": "masked_vs_sync", "mode": "deterministic",
          "max_train_loss_gap": max(abs(a.train_loss - b.train_loss)
                                    for a, b in zip(sync, masked)),
          "max_val_loss_gap": max(abs(a.val_loss - b.val_loss)
                                  for a, b in zip(sync, masked)),
          "train_atol": MASKED_TRAIN_ATOL, "val_atol": MASKED_VAL_ATOL})
    emit({"phase": "default_vs_deterministic", "aggregator": "sync",
          "max_train_loss_gap": max(abs(a.train_loss - b.train_loss)
                                    for a, b in zip(default_cafl, sync)),
          "max_val_loss_gap": max(abs(a.val_loss - b.val_loss)
                                  for a, b in zip(default_cafl, sync))})
    check_sanitizers(guard, watch)
    return {k: launches["sync"][k] + launches["masked"][k]
            for k in launches["sync"]}


def check_sanitizers(guard, watch) -> None:
    """The runtime sanitizers of the masked CAFL-L run: each steady-state
    round's synchronising CUDA calls by call site (none outside
    ``EXPLICIT_READS``, and some recorded: the round reads each client's
    loss), and no kernel-library build or load, or compile, after
    round 1."""
    from repro_torch.analysis.runtime import EXPLICIT_READS

    check(guard.guarded_rounds == list(range(2, ENGINE_ROUNDS + 1)),
          f"the sync guard covered rounds {guard.guarded_rounds}")
    for rnd in guard.guarded_rounds:
        sites = guard.per_round.get(rnd, {})
        emit({"phase": "sync_round", "aggregator": "masked", "round": rnd,
              "syncs": sum(sites.values()), "sites": dict(sorted(
                  sites.items(), key=lambda kv: -kv[1]))})
        check(sites, f"round {rnd}: the sync guard recorded no sync at all")
    faults = guard.faults()
    check(not faults, f"steady-state syncs outside EXPLICIT_READS: {faults}")
    emit({"phase": "sanitizers", "aggregator": "masked",
          "explicit_reads": sorted(EXPLICIT_READS),
          "builds_per_round": watch.per_round})
    check(watch.steady_state_compiles(2) == 0,
          f"the kernel library was built or loaded, or something compiled, "
          f"after round 1: {watch.per_round}")


# ---------------------------------------------------------------------------
# phase 5: the fleet: the batched executor, the wall clock, the other stacks
# ---------------------------------------------------------------------------


def charlm_fleet_setting():
    """The full-width char-LM (vocab widened to the corpus), its corpus
    and the paper's FL config (16 clients, 6 a round)."""
    from repro_torch.configs import get_config, get_fl_config
    from repro_torch.data import load_corpus

    ds = load_corpus()
    cfg = get_config("charlm-shakespeare")
    if cfg.vocab_size < ds.vocab_size:
        cfg = cfg.replace(vocab_size=ds.vocab_size)
    return cfg, get_fl_config(), ds


def drive_executors(dev) -> dict:
    """CAFL-L for FLEET_ROUNDS rounds with the sequential and with the
    batched executor, both under deterministic algorithms, held to each
    other at BATCHED_ATOL with equal knobs, participants and launch
    counts (but ``adamw_update``'s, launched by the sequential client
    alone)."""
    from repro_torch.fl import FederatedEngine
    from repro_torch.kernels import ops
    from repro_torch.models import build

    cfg, fl, ds = charlm_fleet_setting()
    fl = fl.replace(rounds=FLEET_ROUNDS)
    runs, launches = {}, {}
    with deterministic():
        for executor in ("sequential", "batched"):
            engine = FederatedEngine(build(cfg), fl, ds, strategy="cafl",
                                     executor=executor, device=dev)
            ops.reset_launches()
            runs[executor] = engine.run().history
            torch.cuda.synchronize()
            launches[executor] = dict(ops.LAUNCHES)
            engine_rounds("cafl", "sync", f"deterministic {executor}",
                          runs[executor])
    seq, bat = runs["sequential"], runs["batched"]
    # the sequential client's in-place AdamW runs the fused kernel; the
    # batched executor's vmapped functional update runs plain ops
    wire = {ex: {k: n for k, n in c.items() if k != "adamw_update"}
            for ex, c in launches.items()}
    check(wire["batched"] == wire["sequential"]
          and launches["sequential"]["adamw_update"] > 0
          and launches["batched"]["adamw_update"] == 0,
          f"batched launches {launches['batched']} != sequential "
          f"{launches['sequential']} (but the optimizer's)")
    counts = launches["batched"]
    check(counts["quantize_blocks"] > 0 and counts["dequantize_blocks"] > 0
          and counts["flash_attention_bhsd"] > 0,
          f"the executor runs launched no wire or flash kernel: {counts}")
    for a, b in zip(seq, bat):
        check(a.knobs == b.knobs and a.participants == b.participants,
              f"round {a.round}: batched knobs / participants differ")
        check(abs(a.val_loss - b.val_loss) <= BATCHED_ATOL
              and abs(a.train_loss - b.train_loss) <= BATCHED_ATOL,
              f"round {a.round}: batched losses ({b.val_loss}, "
              f"{b.train_loss}) vs sequential ({a.val_loss}, "
              f"{a.train_loss})")
    emit({"phase": "fleet_executors", "rounds": FLEET_ROUNDS,
          "mode": "deterministic", "launches": counts,
          "max_val_loss_gap": max(abs(a.val_loss - b.val_loss)
                                  for a, b in zip(seq, bat)),
          "max_train_loss_gap": max(abs(a.train_loss - b.train_loss)
                                    for a, b in zip(seq, bat)),
          "atol": BATCHED_ATOL})
    return {k: launches["sequential"][k] + launches["batched"][k]
            for k in counts}


def drive_async(dev) -> dict:
    """``examples/async_fleet.py``'s fleet at full width on the wall
    clock: two tiers (half at compute_scale 2.0), deadline stragglers at
    1.1 with jitter 0.2, the batched executor, ASYNC_ROUNDS rounds with
    the sync barrier and with FedBuff (buffer 3). FedBuff must apply
    late reports; the barrier loses them."""
    from repro_torch.fl import (DeadlineStragglers, FedBuffAggregator,
                                FederatedEngine, FleetClass, FleetDynamics,
                                UniformSampler, make_fleet)
    from repro_torch.kernels import ops
    from repro_torch.models import build

    cfg, fl, ds = charlm_fleet_setting()
    fl = fl.replace(rounds=ASYNC_ROUNDS)
    profiles, cp = make_fleet(fl, [
        FleetClass("fast", fraction=0.5),
        FleetClass("slow", fraction=0.5, compute_scale=2.0)])
    total = {}
    rows = {}
    for name, agg in (("sync", "sync"),
                      ("fedbuff", FedBuffAggregator(buffer_size=3))):
        dyn = FleetDynamics(
            sampler=UniformSampler(fl.clients_per_round),
            stragglers=DeadlineStragglers.for_config(fl, deadline=1.1,
                                                     jitter=0.2))
        engine = FederatedEngine(build(cfg), fl, ds, strategy="fedavg",
                                 executor="batched", profiles=profiles,
                                 client_profiles=cp, dynamics=dyn,
                                 aggregator=agg, device=dev)
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launches()
        hist = engine.run(time_mode="wall_clock").history
        torch.cuda.synchronize()
        counts = dict(ops.LAUNCHES)
        check(counts["flash_attention_bhsd"] > 0,
              f"the {name} wall-clock run launched no flash kernel")
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
        sim = [r.sim_time for r in hist]
        check(all(math.isfinite(r.val_loss) for r in hist)
              and sim == sorted(sim) and sim[0] > 0.0,
              f"{name}: non-finite loss or a clock that ran back {sim}")
        row = rows[name] = {
            "phase": "fleet_async", "aggregator": name,
            "time_mode": "wall_clock", "rounds": len(hist),
            "sim_seconds": sim[-1],
            "round_seconds": [r.round_seconds for r in hist],
            "reports_applied": sum(r.reports_applied for r in hist),
            "late": sum(len(r.late_arrivals) for r in hist),
            "lost": sum(len(r.dropped) for r in hist),
            "val_loss": [r.val_loss for r in hist],
            "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
            "launches": counts}
        emit(row)
    check(rows["fedbuff"]["late"] > 0,
          "FedBuff applied no late report on the wall clock")
    check(rows["sync"]["late"] == 0 and rows["sync"]["lost"] > 0,
          f"the sync barrier should lose the slow tier's reports: {rows}")
    return total


def drive_stacked(dev) -> dict:
    """One FLEET_ROUNDS-round run stacking the other pieces:
    ``cafl+adam``, the PI controller, the deadline-aware knob policy,
    ``paper+wire_mb+latency``, resource-aware sampling, Bernoulli churn,
    deadline stragglers (so the latency dual and the deadline policy
    have arrival times to read), ``wire_topk = 64`` and the batched
    executor. Every top-k launch must take the warp kernel."""
    from repro_torch.fl import FederatedEngine, make_dynamics
    from repro_torch.kernels import cuda_lib, ops
    from repro_torch.models import build

    cfg, fl, ds = charlm_fleet_setting()
    fl = fl.replace(rounds=FLEET_ROUNDS,
                    constraints="paper+wire_mb+latency",
                    dual_controller="pi", knob_policy="deadline_aware",
                    wire_topk=64, executor="batched")
    dyn = make_dynamics(fl, "resource_aware", "bernoulli", "deadline")
    engine = FederatedEngine(build(cfg), fl, ds, strategy="cafl+adam",
                             dynamics=dyn, device=dev)
    ops.reset_launches()
    hist = engine.run().history
    torch.cuda.synchronize()
    counts, topk = dict(ops.LAUNCHES), dict(cuda_lib.TOPK_VARIANTS)
    engine_rounds("cafl+adam", "sync", "stacked", hist)
    shipped = sum(len(r.participants) for r in hist if r.knobs.get("q"))
    check(all(math.isfinite(r.val_loss) for r in hist)
          and all(0.0 <= lam for r in hist for lam in r.duals.values()),
          "the stacked run has a non-finite loss or a negative dual")
    check(set(hist[-1].constraints) == {"energy", "comm", "memory", "temp",
                                        "wire_mb", "latency"},
          f"stacked constraints {sorted(hist[-1].constraints)}")
    check(shipped > 0 and counts["quantize_topk_blocks"] == shipped
          and counts["dequantize_blocks"] == shipped
          and counts["quantize_blocks"] == 0,
          f"{shipped} compressed deltas, launches {counts}")
    check(topk["warp"] == shipped and topk["cta"] == 0,
          f"top-k launches by kernel {topk}")
    check(counts["flash_attention_bhsd"] > 0,
          "the stacked run launched no flash kernel")
    emit({"phase": "fleet_stack", "strategy": engine.strategy.name,
          "rounds": len(hist),
          "knobs": [r.knobs for r in hist],
          "participants": [r.participants for r in hist],
          "dropped": [r.dropped for r in hist],
          "deadline": dyn.stragglers.deadline,
          "constraints": hist[-1].constraints, "launches": counts,
          "topk_kernels": topk})
    return counts


def drive_fleet(dev) -> dict:
    """The fleet phase's three paths, each with the counts zeroed just
    before it and read just after -> their summed launch counts."""
    parts = [drive_executors(dev), drive_async(dev), drive_stacked(dev)]
    return {k: sum(p.get(k, 0) for p in parts) for k in parts[0]}


# ---------------------------------------------------------------------------
# phase 6: analysis: the schedule gate on the card
# ---------------------------------------------------------------------------


def launch_log():
    """A round callback keeping the growth of ``ops.LAUNCHES`` over each
    engine run (``runs``) and each of its rounds (``rounds``: per run,
    (round, knobs, participants, launches))."""
    from repro_torch.fl.callbacks import RoundCallback
    from repro_torch.kernels import ops

    def grown(since):
        return {k: v - since[k] for k, v in ops.LAUNCHES.items()}

    class LaunchLog(RoundCallback):
        def __init__(self):
            self.runs, self.rounds = [], []

        def on_train_start(self, engine):
            self._run0 = dict(ops.LAUNCHES)
            self.rounds.append([])

        def on_round_start(self, engine, rnd):
            self._round0 = dict(ops.LAUNCHES)

        def on_round_end(self, engine, record):
            self.rounds[-1].append((record.round, dict(record.knobs),
                                    list(record.participants),
                                    grown(self._round0)))

        def on_train_end(self, engine, result):
            self.runs.append(grown(self._run0))

    return LaunchLog()


def drive_sched(dev) -> dict:
    """The schedule gate's three scenarios (``analysis.sched.gate``) on
    the card with the char-LM at full width and depth, under
    deterministic algorithms, with the reference's permutation counts;
    the launch counts zeroed before each scenario and read after -> the
    summed launches."""
    from repro_torch.analysis.sched.gate import full_width_stack, run_scenario
    from repro_torch.kernels import ops

    model, fl, ds = full_width_stack()
    total: dict = {}
    with deterministic():
        for name, perms in SCHED_PERMUTATIONS.items():
            log = launch_log()
            ops.reset_launches()
            row, findings, problems = run_scenario(
                name, model, fl, ds, permutations=perms, device=dev,
                callbacks=[log])
            torch.cuda.synchronize()
            launches = dict(ops.LAUNCHES)
            q_rounds = [(rnd, counts) for run in log.rounds
                        for rnd, knobs, _, counts in run
                        if knobs.get("q", 0) >= 1]
            emit({"phase": "sched", "scenario": name,
                  "aggregator": row["aggregator"],
                  "commutativity": row["commutativity"], "mode": row["mode"],
                  "permutations": row["permutations"],
                  "swapped": row["swapped"],
                  "total_swapped": row["total_swapped"],
                  "unordered_pairs": row["unordered_pairs"],
                  "races": row["races"],
                  "races_certified": row["races_certified"],
                  "replays": len(log.runs), "q_rounds": len(q_rounds),
                  "launches": launches, "problems": problems[:4]})
            check(not problems and not findings,
                  f"{name}: {len(problems)} problem(s), {len(findings)} "
                  f"race finding(s): {problems[:4]}")
            check(row["ok"] and row["races"] == 0
                  and row["total_swapped"] > 0,
                  f"{name}: ok={row['ok']} races={row['races']} "
                  f"swapped={row['total_swapped']}")
            check(len(log.runs) == perms + 2,
                  f"{name}: {len(log.runs)} replays for {perms} "
                  f"permutations (expected the base twice and each one)")
            check(launches["flash_attention_bhsd"] > 0,
                  f"{name}: the eval launched no flash kernel")
            for rnd, counts in q_rounds:
                check(counts["quantize_blocks"] > 0
                      and counts["dequantize_blocks"] > 0,
                      f"{name} round {rnd}: q >= 1 but the wire kernels "
                      f"were not launched: {counts}")
            if row["aggregator"] == "masked":
                for i, run in enumerate(log.runs):
                    folds = sum(1 for _, _, who, _ in log.rounds[i] if who)
                    check(run["masked_sum_u64"] == folds > 0
                          and run["masked_sum_limbs"] == 0,
                          f"{name} replay {i}: {run['masked_sum_u64']} "
                          f"masked_sum_u64 launches for {folds} rounds with "
                          f"reporters")
            else:
                check(q_rounds, f"{name}: no round compressed (q >= 1), so "
                      f"the wire kernels were never checked")
            total = {k: total.get(k, 0) + v for k, v in launches.items()}
    emit({"phase": "analysis", "config": model.cfg.name,
          "params": model.param_count()["total"],
          "setting": SCHED_SETTING})
    return total


#: the char-LM's full width (``configs/charlm_shakespeare.py``: 6 layers,
#: d 192, 8 heads of 24, d_ff 384, vocab 128, seq 32; 1,900,800
#: parameters), for the trace phase's memory check
TRACE_FULL_WIDTH = {"vocab": 128, "num_layers": 6, "d_model": 192,
                    "num_heads": 8, "head_dim": 24, "d_ff": 384,
                    "seq_len": 32}
#: the reference's band of the static peak over a measured one
#: (``tests/test_analysis_trace.py``)
TRACE_BRACKET = (0.5, 4.0)
#: the CUDA caching allocator's block: every allocation takes a multiple
#: of 512 bytes, so the estimate set beside a card's peak rounds each
#: storage up to it (the dual update's 16-byte tensors take 512 each)
CUDA_BLOCK = 512


def to_card(tree, dev):
    from torch.utils._pytree import tree_map
    return tree_map(lambda t: t.to(dev) if isinstance(t, torch.Tensor)
                    else t, tree)


def all_finite(tree) -> bool:
    from torch.utils._pytree import tree_leaves
    return all(bool(torch.isfinite(t).all()) for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor) and t.is_floating_point())


def tracked_peak(fn, args):
    """``fn(*args)`` under ``MemTracker``: (its outputs, the peak of the
    live tensors' memory, the arguments included; on the card each
    storage counts its allocator blocks)."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils._pytree import tree_leaves
    tracker = MemTracker()
    tracker.track_external(*[t for t in tree_leaves(args)
                             if isinstance(t, torch.Tensor)])
    with tracker:
        out = fn(*args)
    torch.cuda.synchronize()
    peak = max(snap["Total"] for snap in
               tracker.get_tracker_snapshot("peak").values())
    return out, peak


def allocator_peak(fn, args, dev):
    """``args`` moved to the card, then ``fn`` after
    ``reset_peak_memory_stats``: (its outputs, ``max_memory_allocated``
    above what was allocated before the arguments), i.e. arguments +
    outputs + temporaries, as the reference counts XLA's memory
    analysis."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    args = to_card(args, dev)
    torch.cuda.reset_peak_memory_stats()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def drive_trace(dev) -> dict:
    """The trace analysis (``repro_torch.analysis.trace``) on the card:
    the static trace, equal row for row to the committed
    ``TRACE_BUDGETS_TORCH.json``; each of the 11 entries run for real at
    its declared shape, its static peak (in allocator blocks) held to
    the tracked peak of the run, the wire kernels and the fold launched
    and their outputs equal to the CPU twins'; then the local step at
    the char-LM's full width at b 8 and 32, static peak against
    ``max_memory_allocated``, and the gate's units from both -> the
    entries' launches."""
    from repro_torch.analysis.trace import (EntryPoint, charlm_trace_setup,
                                            collect_entry_points,
                                            cost_of_graph, run_trace,
                                            trace_entry)
    from repro_torch.analysis.trace.gate import (DEFAULT_TRACE_TABLE,
                                                 build_table, load_table,
                                                 memory_budget_units,
                                                 to_units)
    from repro_torch.analysis.trace.registry import anchor
    from repro_torch.core import client
    from repro_torch.kernels import ops

    lo, hi = TRACE_BRACKET
    report = run_trace(ROOT)
    for t in report.traced:
        emit({"phase": "trace", "entry": t.entry.name, **t.cost.to_json(),
              "dot_flops": t.cost.dot_flops,
              "inplace_leaves": t.inplace_leaves,
              "donatable_leaves": t.donatable_leaves})
    for row in report.gate:
        emit({"phase": "trace_gate", **row.to_json()})
    table = load_table(os.path.join(ROOT, DEFAULT_TRACE_TABLE))
    fresh = json.loads(json.dumps(build_table(report.traced, report.gate)))
    rows = (table or {}).get("entries", {})
    check(table == fresh,
          f"the static trace differs from {DEFAULT_TRACE_TABLE}: "
          f"{[n for n, r in fresh['entries'].items() if rows.get(n) != r]}")
    check(not report.findings and not report.problems,
          f"trace: {len(report.findings)} finding(s), problems "
          f"{report.problems[:4]}")
    static = {t.entry.name: (t.cost.peak_bytes, cost_of_graph(
        t.graph, t.donated, granule=CUDA_BLOCK).peak_bytes)
        for t in report.traced}

    entries = collect_entry_points()
    ops.reset_launches()
    outs = {}
    for ep in entries:
        fn, args = ep.build()
        out, peak = tracked_peak(fn, to_card(args, dev))
        outs[ep.name] = (fn, args, out)
        exact, blocks = static[ep.name]
        ratio = blocks / peak
        emit({"phase": "trace_run", "entry": ep.name,
              "static_peak_bytes": exact, "static_peak_blocks": blocks,
              "measured_peak_bytes": peak, "ratio": ratio})
        check(all_finite(out), f"trace run {ep.name}: non-finite output")
        check(lo <= ratio <= hi,
              f"trace run {ep.name}: static {blocks} B in blocks over "
              f"measured {peak} B = {ratio:.3f}, outside [{lo}, {hi}]")
    launches = dict(ops.LAUNCHES)
    for kernel in ("quantize_blocks", "quantize_topk_blocks",
                   "masked_sum_u64"):
        check(launches[kernel] > 0,
              f"the trace entries did not launch {kernel}: {launches}")
    check(launches["masked_sum_limbs"] == 0,
          f"the trace entries launched masked_sum_limbs: {launches}")
    # the card's outputs against the CPU twins' (these launches, the
    # decode's included, compare and are not counted)
    for name in ("kernels.wire_dense", "kernels.wire_topk"):
        fn, args, out = outs[name]
        want = fn(*args)
        for got_t, want_t in zip(out[:3], want[:3]):
            if want_t is not None:
                check(bits_equal(got_t.cpu(), want_t),
                      f"{name}: the card's wire tuple differs from the twin's")
        check(bits_equal(ops.dequantize_blocks(out[0], out[1]).cpu(),
                         ops.dequantize_blocks(want[0], want[1])),
              f"{name}: the card's decode differs from the twin's")
    fn, args, out = outs["kernels.masked_sum"]
    check(torch.equal(out.cpu(), fn(*args)),
          "kernels.masked_sum: the card's fold differs from the twin's")

    peaks = {}
    for b in (client.TRACE_ADAPTED_B, client.TRACE_BASELINE_B):
        runner, params, batch = charlm_trace_setup(b=b,
                                                   model=TRACE_FULL_WIDTH)
        mask, _ = runner.mask_for(params, 0)
        step = functools.partial(client._local_step, runner)

        def fresh_args():
            # the step overwrites its optimizer state: a fresh one a run
            return params, runner.opt.init(params), batch, mask

        ep = EntryPoint(name=f"fl.client_local_step@full_b{b}",
                        **anchor(client._local_step),
                        build=lambda: (step, fresh_args()), donatable=(1,))
        t = trace_entry(ep)
        static_b = t.cost.peak_bytes
        blocks = cost_of_graph(t.graph, t.donated,
                               granule=CUDA_BLOCK).peak_bytes
        out, _ = allocator_peak(step, fresh_args(), dev)     # warm-up
        del out
        out, measured = allocator_peak(step, fresh_args(), dev)
        check(all_finite(out), f"full width b {b}: non-finite output")
        del out
        peaks[b] = (static_b, measured)
        emit({"phase": "trace_full", "b": b,
              "params": sum(p.numel() for p in params.values()),
              "static_peak_bytes": static_b, "static_peak_blocks": blocks,
              "measured_peak_bytes": measured, "ratio": blocks / measured})
        check(lo <= blocks / measured <= hi,
              f"full width b {b}: static {blocks} B in blocks over "
              f"measured {measured} B = {blocks / measured:.3f}, outside "
              f"[{lo}, {hi}]")
    budget = memory_budget_units()
    (s8, m8), (s32, m32) = (peaks[client.TRACE_ADAPTED_B],
                            peaks[client.TRACE_BASELINE_B])
    units = {"static": to_units(s8, s32), "measured": to_units(m8, m32)}
    verdicts = {k: "VIOLATED" if u > budget else "ok"
                for k, u in units.items()}
    emit({"phase": "trace_full_gate", "budget_units": budget,
          "static_units": units["static"],
          "measured_units": units["measured"],
          "static_verdict": verdicts["static"],
          "measured_verdict": verdicts["measured"],
          "verdicts_agree": verdicts["static"] == verdicts["measured"]})
    emit({"phase": "trace_total", "launches": launches})
    return launches


# ---------------------------------------------------------------------------
# phase 7: Gemma2-9B prefill and decode through the serving steps
# ---------------------------------------------------------------------------


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def logit_gap(name: str, got, want, bound: float, config: str,
              checked: bool = True) -> float:
    """Emit how far two logits part (relative L2); fail past ``bound``
    unless the line is for information only (``checked`` false)."""
    gap = rel_l2(got, want)
    rec = {"phase": "serve_check", "config": config, "check": name,
           "rel_l2": gap,
           "max_abs": float((got.double() - want.double()).abs().max()),
           "max_abs_logit": float(want.abs().max()),
           "argmax_equal": bool(torch.equal(got.argmax(-1), want.argmax(-1))),
           "rel_l2_bound": bound if checked else None}
    emit(rec)
    if checked:
        check(math.isfinite(gap) and gap <= bound,
              f"{config} {name}: logits part by {gap} (bound {bound})")
    return gap


@contextlib.contextmanager
def routing_log():
    """While open, every MoE layer's routing (``models.moe.route``, one
    call per MoE layer and forward, in layer order) is logged: each real
    token's experts, sorted, and whether each choice was kept. Yields the
    list of (experts (T, K), kept (T, K)) pairs, on the card."""
    from repro_torch.models import moe
    real, calls = moe.route, []

    def route(p, x, cfg):
        r = real(p, x, cfg)
        k = r.expert.shape[-1]
        calls.append((r.expert.reshape(-1, k)[:r.n_tok].sort(-1).values,
                      r.kept.reshape(-1, k)[:r.n_tok]))
        return r

    moe.route = route
    try:
        yield calls
    finally:
        moe.route = real


@contextlib.contextmanager
def routing_replay(logged):
    """While open, every MoE layer's routing (in layer order, as
    ``routing_log`` logs it) takes its real tokens' experts from
    ``logged`` (one (T, K) tensor per layer call), its gates from its
    own router's probabilities at those experts (renormalised as
    ``route`` does), and its queue slots and kept flags anew from them.
    Yields, as ``routing_log`` does, per call the (sorted) experts the
    layer chose itself and the kept flags it ran with: a check of decode
    against prefill runs the prefill on decode's routing, so that a
    near-tie that bf16 rounding tips the other way (a routing flip)
    does not part the logits, and the flips are still counted."""
    from repro_torch.models import moe
    real, calls = moe.route, []

    def route(p, x, cfg):
        r = real(p, x, cfg)
        g, gs, k = r.expert.shape
        n_exp = r.probs.shape[-1]
        own = r.expert.reshape(-1, k)[:r.n_tok]
        expert = r.expert.reshape(-1, k).clone()
        expert[:r.n_tok] = logged[len(calls)]
        expert = expert.reshape(g, gs, k)
        gate = r.probs.gather(-1, expert)
        gate = gate / (torch.sum(gate, dim=-1, keepdim=True) + 1e-9)
        onehot = torch.nn.functional.one_hot(expert, n_exp).to(torch.int32)
        queue = onehot.reshape(g, gs * k, -1).cumsum(1)
        pos = queue.reshape(onehot.shape).gather(
            -1, expert[..., None])[..., 0] - 1
        kept = pos < r.capacity
        calls.append((own.sort(-1).values, kept.reshape(-1, k)[:r.n_tok]))
        return r._replace(gate=gate, expert=expert, pos=pos, kept=kept)

    moe.route = route
    try:
        yield calls
    finally:
        moe.route = real


def replayed(prompt_routes, decoded, n_moe: int, steps: int) -> list:
    """Per MoE layer, the experts of the prompt's tokens (``routing_log``
    of the prefill that built decode's caches) and of the first ``steps``
    decoded tokens (``routing_log`` of the decode steps, ``n_moe`` calls
    a step), in token order: ``routing_replay``'s ``logged``."""
    return [torch.cat([prompt_routes[layer][0]]
                      + [decoded[i * n_moe + layer][0]
                         for i in range(steps)])
            for layer in range(n_moe)]


def flips(a, b, rows=slice(None)) -> list:
    """Per MoE layer, the tokens (of ``rows``) whose expert set differs
    between two logs of the same layers."""
    return [int((x[rows] != y[rows]).any(-1).sum())
            for (x, _), (y, _) in zip(a, b)]


def flash_per_prefill(cfg) -> int:
    """Flash launches of one prefill: one per attention layer (none in
    xLSTM), and under an encoder-decoder one per encoder layer and two per
    decoder layer (its causal self-attention and its cross-attention)."""
    if cfg.encdec:
        return cfg.enc_layers + 2 * cfg.num_layers
    return sum(cfg.layer_kind(i) == "attn" for i in range(cfg.num_layers))


def drive_serving(dev, smi: str, arch: str = "gemma2-9b", *,
                  phase: str = "serve", layers: int = 0,
                  prompt_len: int = SERVE_PROMPT, steps: int = SERVE_STEPS,
                  check_capacity: float = 0.0,
                  check_dtype: Optional[torch.dtype] = None,
                  reduces: str = SERVE_REDUCES) -> int:
    """One config at full width on the card (depth cut to ``layers``
    when given): prefill one ``prompt_len``-token prompt (an
    encoder-decoder: ``synthetic_batch(cfg, 1, 2 * prompt_len)``,
    ``prompt_len`` source frames and target tokens) and decode ``steps``
    greedy tokens through the serving steps; returns the flash launches
    of the first prefill and of the decode steps.

    Checks: (a) the prefill's last logits against the same model
    with the plain attention in its place (a config with attention); (b)
    decode after the first and the last step against a prefill over the
    prompt plus the tokens so far. Both within 2 x 2^-8 x sqrt(2 L)
    relative L2 (``serve_rel_l2``, L every layer, the encoder's too).
    An MoE config drops tokens over capacity in prefill, and a one-token
    decode never does; so (b) runs a model at ``check_capacity``, where
    the capacity is the group size and nothing drops, and the line prints
    the drop share at the config's own factor beside it; the check's
    prefill takes the experts decode chose (``routing_replay``), and the
    line prints, per MoE layer, the tokens whose own choice differs
    (routing flips from bf16 rounding). With ``check_dtype``
    (xLSTM: float32), (b) runs the same weights in that dtype, prefill
    and decode fed the bf16 run's tokens, and the bf16 decode's own gaps
    are printed beside it, unchecked: the 48-block xLSTM stack parts two
    bf16 runs by more than the bound even when they differ only in a
    GEMM's tiling (``SERVE_XLSTM``)."""
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.data import synthetic_batch
    from repro_torch.kernels import cuda_lib, ops, ref
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import build
    from repro_torch.models.convert import flatten

    published = get_config(arch)
    cfg = published.replace(num_layers=layers) if layers else published
    model = build(cfg)
    check_model = model
    if check_capacity:
        check_model = build(cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=check_capacity)))
    if check_dtype is not None:
        check_model = build(cfg.replace(param_dtype=check_dtype,
                                        compute_dtype=check_dtype))
    bound = serve_rel_l2(cfg.num_layers + cfg.enc_layers)
    n_flash = flash_per_prefill(cfg)
    shape = dataclasses.replace(INPUT_SHAPES["prefill_32k"],
                                seq_len=prompt_len, global_batch=1)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen, dev).params()
    n_params = sum(t.numel() for t in params.values())
    counts = model.param_count()
    check(n_params == counts["total"],
          f"{n_params} parameters drawn, {counts} expected")
    src = None
    if cfg.encdec:
        drawn = synthetic_batch(cfg, 1, 2 * prompt_len, seed=1)
        src = torch.from_numpy(drawn["src_embeds"]).to(dev)
        prompt = torch.from_numpy(drawn["tokens"]).long().to(dev)
    else:
        prompt = torch.randint(0, cfg.vocab_size, (1, prompt_len),
                               generator=torch.Generator(
                                   device=dev).manual_seed(1), device=dev)

    def batch(tokens):
        return {"tokens": tokens} if src is None else {"tokens": tokens,
                                                       "src_embeds": src}

    prefill = make_prefill_step(model, shape, max_new_tokens=steps)
    check_prefill = make_prefill_step(check_model, shape,
                                      max_new_tokens=steps)
    decode = make_decode_step(model if check_dtype else check_model)

    ops.reset_launches()
    logits, caches = prefill(params, batch(prompt))
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    variants = dict(cuda_lib.FLASH_VARIANTS)
    check(launches["flash_attention_bhsd"] == n_flash,
          f"{launches['flash_attention_bhsd']} flash launches in one "
          f"prefill, expected {n_flash}")
    check(variants["mma_bf16"] == n_flash,
          f"prefill's flash launches by variant {variants}: expected all "
          f"{n_flash} on the tensor cores (mma_bf16)")
    check(tuple(logits.shape) == (1, 1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"prefill logits {tuple(logits.shape)} not finite or misshapen")
    prompt_routes = []
    if check_capacity:
        del caches
        with routing_log() as prompt_routes:
            start, caches = check_prefill(params, batch(prompt))
    else:
        start = logits
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in flatten(caches).values())

    tokens = []
    tok = start.argmax(-1)
    first = None
    flash_before = ops.LAUNCHES["flash_attention_bhsd"]
    with routing_log() as decoded:
        for i in range(steps):
            tokens.append(tok)
            out, caches = decode(params, caches, tok)
            check(bool(torch.isfinite(out).all()),
                  f"decode step {i}: not finite")
            if i == 0:
                first = out.clone()
            tok = out.argmax(-1)
    decode_flash = ops.LAUNCHES["flash_attention_bhsd"] - flash_before
    # the encoder-decoder's cross-attention is a no-grad full attention:
    # the kernel at Sq 1; every other decode attention is plain
    want_flash = steps * cfg.num_layers if cfg.encdec else 0
    check(decode_flash == want_flash,
          f"decode launched the flash kernel {decode_flash} times, "
          f"expected {want_flash}")
    del caches
    n_moe = len(decoded) // steps

    # (b) decode against prefill over the prompt plus the tokens so far
    bf16_gaps = None
    if check_dtype is not None:
        # the bf16 decode's gaps, printed, not checked
        bf16_gaps = [logit_gap(f"{cfg.param_dtype} decode step {n} vs "
                               f"prefill (not checked)", got,
                               prefill(params, batch(torch.cat(
                                   [prompt] + tokens[:n], 1)))[0], bound,
                               cfg.name, checked=False)
                     for n, got in ((1, first), (steps, out))]
        # the check: the same weights in check_dtype, decode fed the
        # same tokens
        params_c = {k: v.to(check_dtype) for k, v in params.items()}
        _, caches_c = check_prefill(params_c, batch(prompt))
        decode_c = make_decode_step(check_model)
        for i, t in enumerate(tokens):
            out, caches_c = decode_c(params_c, caches_c, t)
            if i == 0:
                first = out.clone()
        del caches_c
    else:
        params_c = params
    # an MoE config's prefill runs on decode's routing (each layer's
    # experts for the prompt and the decoded tokens); the flips, where
    # the prefill's own choice differs, are counted beside
    with routing_replay(replayed(prompt_routes, decoded, n_moe, 1)) \
            as after_one_routes:
        after_one, _ = check_prefill(params_c, batch(torch.cat(
            [prompt, tokens[0]], 1)))
    logit_gap("decode step 1 vs prefill", first, after_one, bound, cfg.name)
    with routing_replay(replayed(prompt_routes, decoded, n_moe, steps)) \
            as after_all_routes:
        after_all, _ = check_prefill(params_c, batch(torch.cat(
            [prompt] + tokens, 1)))
    logit_gap(f"decode step {steps} vs prefill", out, after_all, bound,
              cfg.name)
    del after_one, after_all, params_c

    # (a) the kernel against the plain attention inside the same model
    real = ops.flash_attention
    flash_before = ops.LAUNCHES["flash_attention_bhsd"]
    with routing_log() as kernel_routes:
        kernel, _ = prefill(params, batch(prompt))
    again = ops.LAUNCHES["flash_attention_bhsd"] - flash_before
    check(again == n_flash, f"the kernel's prefill of check (a) launched "
          f"flash {again} times, expected {n_flash}")
    if n_flash:
        with routing_log() as plain_routes:
            ops.flash_attention = ref.flash_attention_ref
            try:
                plain, _ = prefill(params, batch(prompt))
            finally:
                ops.flash_attention = real
        logit_gap("prefill kernel vs plain attention", kernel, plain, bound,
                  cfg.name)
    peak = torch.cuda.max_memory_allocated()
    rec = {"phase": phase, "config": cfg.name, "params": n_params,
           "active_params": counts["active"], "layers": cfg.num_layers,
           "enc_layers": cfg.enc_layers,
           "dtype": str(cfg.param_dtype), "batch": 1, "prompt": prompt_len,
           "source_frames": 0 if src is None else src.shape[1],
           "decode_steps": steps, "reduces": reduces,
           "peak_memory_bytes": peak, "decode_cache_bytes": cache_bytes,
           "rel_l2_bound": bound, "check_dtype": str(check_dtype),
           "bf16_decode_gaps_unchecked": bf16_gaps, "launches": launches,
           "decode_flash_launches": decode_flash,
           "flash_variants": variants, "nvidia_smi": smi}
    if cfg.moe:
        dropped = [float(1 - kept.float().mean()) for _, kept in kernel_routes]
        last = slice(-1, None)
        rec.update({
            "capacity_factor": cfg.moe.capacity_factor,
            "drop_share": sum(dropped) / len(dropped),
            "drop_share_per_layer": dropped,
            "check_capacity_factor": check_capacity,
            "check_drop_share": max(
                float(1 - kept.float().mean())
                for _, kept in after_all_routes),
            "flips_kernel_vs_plain": flips(kernel_routes, plain_routes),
            "flips_decode_vs_prefill": {
                "step 1": flips(decoded[:n_moe], after_one_routes, last),
                f"step {steps}": flips(decoded[-n_moe:], after_all_routes,
                                       last)},
        })
        check(rec["check_drop_share"] == 0.0,
              f"the decode checks' prefill dropped tokens at capacity "
              f"factor {check_capacity}")
    emit(rec)
    return launches["flash_attention_bhsd"] + decode_flash


def drive_serve_smoke(dev) -> int:
    """Each zoo config at its SMOKE size (f32) on the card: a prefill of a
    ``synthetic_batch`` (2 x 64 tokens; PaliGemma's 8 patch tokens among
    them; SeamlessM4T's 32 source frames and 32 target tokens) against
    the same prefill on the CPU from the same weights, logits and every
    cache (recurrent states included) within ``SMOKE_CARD_RTOL`` of their
    largest magnitude; one flash launch per attention
    (``flash_per_prefill``). Returns the flash launches."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import synthetic_batch
    from repro_torch.kernels import ops
    from repro_torch.models import build
    from repro_torch.models.convert import flatten

    total = 0
    for arch in SMOKE_ARCHS:
        cfg = get_smoke_config(arch)
        model = build(cfg)
        params = model.init(torch.Generator().manual_seed(5), "cpu").params()
        batch = {k: torch.from_numpy(v) for k, v in
                 synthetic_batch(cfg, 2, 64, seed=5).items()}
        want, want_cache = model.prefill(params, batch, max_new_tokens=4)
        ops.reset_launches()
        got, got_cache = model.prefill(
            {k: v.to(dev) for k, v in params.items()},
            {k: v.to(dev) for k, v in batch.items()}, max_new_tokens=4)
        torch.cuda.synchronize()
        launches = ops.LAUNCHES["flash_attention_bhsd"]
        check(launches == flash_per_prefill(cfg),
              f"{arch} SMOKE: {launches} flash launches in one prefill, "
              f"expected {flash_per_prefill(cfg)}")
        gaps = {"logits": (got.cpu() - want).abs().max().item()
                / want.abs().max().item()}
        want_flat, got_flat = flatten(want_cache), flatten(got_cache)
        for name, w in want_flat.items():
            w = w.double()
            gaps[name] = ((got_flat[name].cpu().double() - w).abs().max()
                          / max(w.abs().max(), 1e-30)).item()
        worst = max(gaps.values())
        emit({"phase": "serve_smoke", "config": cfg.name,
              "layers": cfg.num_layers, "dtype": str(cfg.param_dtype),
              "tokens": int(batch["tokens"].shape[1]),
              "flash_launches": launches, "max_rel_gap": worst,
              "worst": max(gaps, key=gaps.get), "bound": SMOKE_CARD_RTOL})
        check(worst <= SMOKE_CARD_RTOL,
              f"{arch} SMOKE: card and CPU prefill part by {worst} "
              f"({max(gaps, key=gaps.get)})")
        total += launches
    return total


# ---------------------------------------------------------------------------
# phase 8: the train step (launch.steps.make_train_step)
# ---------------------------------------------------------------------------


def train_setting(arch: str):
    """-> (config at the step's depth, tokens per sequence, published
    depth)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return (cfg.replace(num_layers=TRAIN_DEPTH[arch]),
            TRAIN_XLSTM_TOKENS if arch == "xlstm-1.3b" else TRAIN_SEQ,
            cfg.num_layers)


def train_dryrun(arch: str) -> dict:
    """The port's dry-run record of the full-width step's setting (run in
    a worker process while the card trains)."""
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun

    cfg, seq, _ = train_setting(arch)
    shape = InputShape("train_4k", seq, TRAIN_BATCH, "train")
    return dryrun.analyze(cfg, shape, microbatches=TRAIN_MICROBATCHES)


def leaf_gaps(got: dict, want: dict) -> dict:
    """Per leaf: max |got - want| over max |want| (the absolute gap where
    ``want`` is all zero)."""
    out = {}
    for k, w in want.items():
        top = float(w.abs().max()) if w.numel() else 0.0
        gap = float((got[k] - w).abs().max()) if w.numel() else 0.0
        out[k] = gap / top if top else gap
    return out


def drive_train_smoke(dev) -> None:
    """The char-LM and each zoo config at SMOKE size, f32: 2 steps of
    ``make_train_step`` (AdamW, 2 microbatches) on the card under
    deterministic algorithms and 2 on the CPU, from the same weights and
    batch; losses within ``TRAIN_SMOKE_RTOL`` relative, each leaf's
    change within ``TRAIN_SMOKE_STEP_RTOL`` of its largest element, Adam's
    moments within ``TRAIN_SMOKE_STATE_RTOL`` of theirs; no flash
    launch."""
    from repro_torch.configs import ARCH_IDS, get_smoke_config
    from repro_torch.data import synthetic_batch
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build
    from repro_torch.optim import adamw

    for arch in ("charlm-shakespeare", *ARCH_IDS):
        cfg = get_smoke_config(arch)
        model = build(cfg)
        init = model.init(torch.Generator().manual_seed(6), "cpu").params()
        batch = {k: torch.from_numpy(v) for k, v in
                 synthetic_batch(cfg, 2, 64, seed=6).items()}
        opt = adamw(TRAIN_SMOKE_LR, eps=TRAIN_SMOKE_EPS)
        step = make_train_step(model, opt, microbatches=TRAIN_MICROBATCHES)
        out = {}
        for where in ("cpu", dev):
            params = {k: v.clone().to(where) for k, v in init.items()}
            b = {k: v.to(where) for k, v in batch.items()}
            state = opt.init(params)
            losses = []
            ops.reset_launches()
            with (deterministic() if where != "cpu"
                  else contextlib.nullcontext()):
                for _ in range(TRAIN_STEPS):
                    params, state, loss = step(params, state, b)
                    losses.append(float(loss))
            host = lambda tree: {k: v.cpu() for k, v in tree.items()}
            out[str(where)] = (
                losses, {k: v.cpu() - init[k] for k, v in params.items()},
                host(state.mu), host(state.nu),
                ops.LAUNCHES["flash_attention_bhsd"])
        want, got = out["cpu"], out[str(dev)]
        flash = got[4]
        loss_rel = max(abs(g - w) / abs(w) for g, w in zip(got[0], want[0]))
        gaps = {part: leaf_gaps(got[i], want[i])
                for i, part in ((1, "step"), (2, "mu"), (3, "nu"))}
        worst = {part: max(g, key=g.get) for part, g in gaps.items()}
        emit({"phase": "train_smoke", "config": cfg.name,
              "layers": cfg.num_layers, "dtype": str(cfg.param_dtype),
              "loss_card": got[0], "loss_cpu": want[0], "loss_rel": loss_rel,
              **{f"{part}_rel": gaps[part][k] for part, k in worst.items()},
              **{f"{part}_worst": k for part, k in worst.items()},
              "flash_launches": flash,
              "bounds": {"loss": TRAIN_SMOKE_RTOL,
                         "step": TRAIN_SMOKE_STEP_RTOL,
                         "mu": TRAIN_SMOKE_STATE_RTOL,
                         "nu": TRAIN_SMOKE_STATE_RTOL}})
        check(loss_rel <= TRAIN_SMOKE_RTOL,
              f"{arch} SMOKE train: card and CPU losses part by {loss_rel}")
        for part, bound in (("step", TRAIN_SMOKE_STEP_RTOL),
                            ("mu", TRAIN_SMOKE_STATE_RTOL),
                            ("nu", TRAIN_SMOKE_STATE_RTOL)):
            k = worst[part]
            check(gaps[part][k] <= bound,
                  f"{arch} SMOKE train: card and CPU {part} part by "
                  f"{gaps[part][k]} of its largest element ({k})")
        check(flash == 0, f"{arch} SMOKE train launched flash {flash} times")


def frozen_parts(params, mask) -> dict:
    """Host copies of every frozen part: whole leaves under a 0 scalar
    mask, the frozen units of stacked leaves."""
    out = {}
    for name, m in mask.items():
        if m.ndim == 0:
            if float(m) == 0.0:
                out[name] = (None, params[name].cpu())
        else:
            units = torch.nonzero(m.reshape(-1) == 0).reshape(-1)
            if len(units):
                out[name] = (units, params[name][units].cpu())
    return out


def drive_train_full(dev, smi: str, records) -> None:
    """Each zoo config at full width (depth ``TRAIN_DEPTH``), bf16, weights
    drawn on the card: 2 AdamW steps of ``make_train_step`` at B 2 x
    4,096 (xLSTM: 2 x ``TRAIN_XLSTM_TOKENS``) in 2 microbatches under the
    freezing mask at k = 1, on the same batch. The loss must be finite
    and fall from step 1 to step 2, the mask freeze some part and every
    frozen part keep its bits, and no flash kernel launch (attention
    under a gradient is the plain ``blockwise_attention``). Prints the
    peak memory beside the dry-run's estimate (``records``: futures of
    ``train_dryrun``)."""
    from repro_torch.core.freezing import mask_tree
    from repro_torch.data import synthetic_batch
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build
    from repro_torch.optim import adamw

    for arch in TRAIN_DEPTH:
        cfg, seq, published = train_setting(arch)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = build(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(0),
                            dev).params()
        opt = adamw(TRAIN_LR)
        state = opt.init(params)
        mask = mask_tree(params, cfg, TRAIN_K)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in
                 synthetic_batch(cfg, TRAIN_BATCH, seq, seed=7).items()}
        frozen = frozen_parts(params, mask)
        step = make_train_step(model, opt, True, TRAIN_MICROBATCHES)
        ops.reset_launches()
        losses = []
        for _ in range(TRAIN_STEPS):
            params, state, loss = step(params, state, batch, mask)
            losses.append(float(loss))
        peak = torch.cuda.max_memory_allocated()
        flash = ops.LAUNCHES["flash_attention_bhsd"]
        kept = all(torch.equal((params[name] if units is None
                                else params[name][units]).cpu(), before)
                   for name, (units, before) in frozen.items())
        del params, state, batch
        rec = records[arch].result()
        est = rec["memory"]["per_device_total_gb"] * 1e9
        emit({"phase": "train", "config": cfg.name,
              "layers": f"{cfg.num_layers} of {published}",
              "params": model.param_count()["total"],
              "dtype": str(cfg.param_dtype).split(".")[-1],
              "batch": [TRAIN_BATCH, seq], "microbatches":
              TRAIN_MICROBATCHES, "mask_k": TRAIN_K, "losses": losses,
              "peak_gb": peak / 1e9, "dryrun_gb": est / 1e9,
              "peak_over_dryrun": peak / est,
              "frozen_parts": len(frozen), "flash_launches": flash,
              "reduces": TRAIN_NOTES.get(arch, TRAIN_REDUCES),
              "nvidia_smi": smi})
        check(all(math.isfinite(v) for v in losses),
              f"{arch} train: non-finite loss {losses}")
        check(losses[1] < losses[0],
              f"{arch} train: the loss did not fall on the same batch "
              f"{losses}")
        check(kept, f"{arch} train: a frozen parameter moved")
        check(len(frozen) > 0, f"{arch} train: k = 1 of {cfg.num_layers} "
              "layers froze nothing")
        check(flash == 0, f"{arch} train launched flash {flash} times")


@contextlib.contextmanager
def adamw_against_plain(seen: list):
    """While open, each parameter's AdamW step on the card (the fused
    kernel, through ``ops.adamw_update_``) is first taken by the plain
    piece path (``ref.adamw_update_ref``) on copies of its gradient,
    parameter and moments; ``seen`` gets one (shape, [the parts that
    differ, of parameter, mu and nu, by ``torch.equal``]) per step."""
    from repro_torch.kernels import ops, ref
    real = ops.adamw_update_

    def checked(grad, param, mu, nu, mask, count, *, corrections, **kw):
        want = [t.clone() for t in (param, mu, nu)]
        ref.adamw_update_ref(grad.clone(), *want, mask, count, **kw)
        real(grad, param, mu, nu, mask, count, corrections=corrections,
             **kw)
        seen.append((list(param.shape), [
            part for part, got, w in zip(("param", "mu", "nu"),
                                         (param, mu, nu), want)
            if not torch.equal(got, w)]))

    ops.adamw_update_ = checked
    try:
        yield
    finally:
        ops.adamw_update_ = real


def drive_adamw(dev) -> None:
    """The fused AdamW kernel against the plain piece path, bit for bit
    (``adamw_against_plain``): (a) the expert leaves of one full-width
    Phi-3.5-MoE layer (16 x 3 x 4,096 x 6,400: bf16 weights, fp32
    gradients and moments, a 0-d mask of 1, decay 0.1), 2 steps; (b)
    Phi-3.5-MoE's full-width train step at the train phase's setting
    (``TRAIN_DEPTH`` layers, 2 x 4,096 tokens in 2 microbatches, mask
    k = 1), 2 steps, every parameter. Each step launches the kernel once
    a parameter."""
    from repro_torch.configs.base import InputShape
    from repro_torch.core.freezing import mask_tree
    from repro_torch.data import synthetic_batch
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build
    from repro_torch.optim import adamw

    arch = "phi3.5-moe-42b-a6.6b"
    cfg, seq, _ = train_setting(arch)
    d, f, e = cfg.d_model, cfg.moe.d_ff_expert, cfg.moe.num_experts
    gen = torch.Generator(device=dev).manual_seed(31)
    shapes = {"expert_gate": (e, d, f), "expert_up": (e, d, f),
              "expert_down": (e, f, d)}
    params = {k: (torch.randn(s, generator=gen, device=dev) * 0.02
                  ).to(torch.bfloat16) for k, s in shapes.items()}
    opt = adamw(TRAIN_LR, weight_decay=0.1)
    state = opt.init(params)
    mask = {k: torch.tensor(1.0, device=dev) for k in params}
    seen = []
    ops.reset_launches()
    with adamw_against_plain(seen):
        for _ in range(TRAIN_STEPS):
            grads = {k: torch.randn(s, generator=gen, device=dev) * 1e-3
                     for k, s in shapes.items()}
            opt.update_(grads, state, params, mask)
    torch.cuda.synchronize()
    leaf = {"phase": "adamw", "check": "expert_leaves",
            "elements": sum(p.numel() for p in params.values()),
            "steps": TRAIN_STEPS,
            "launches": ops.LAUNCHES["adamw_update"],
            "differ": [s for s in seen if s[1]]}
    emit(leaf)
    check(len(seen) == len(shapes) * TRAIN_STEPS and not leaf["differ"]
          and leaf["launches"] == len(shapes) * TRAIN_STEPS,
          f"AdamW kernel vs the piece path at Phi's expert leaves: {leaf}")
    del params, state, grads
    torch.cuda.empty_cache()

    shape = InputShape("train_4k", seq, TRAIN_BATCH, "train")
    model = build(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        dev).params()
    state = opt.init(params)
    mask = mask_tree(params, cfg, TRAIN_K)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             synthetic_batch(cfg, shape.global_batch, seq, seed=7).items()}
    step = make_train_step(model, opt, True, TRAIN_MICROBATCHES)
    seen = []
    ops.reset_launches()
    with adamw_against_plain(seen):
        for _ in range(TRAIN_STEPS):
            params, state, loss = step(params, state, batch, mask)
    torch.cuda.synchronize()
    full = {"phase": "adamw", "check": "train_step", "config": cfg.name,
            "layers": cfg.num_layers, "params": len(params),
            "steps": TRAIN_STEPS, "loss": float(loss),
            "launches": ops.LAUNCHES["adamw_update"],
            "differ": [s for s in seen if s[1]]}
    emit(full)
    check(len(seen) == len(params) * TRAIN_STEPS and not full["differ"]
          and full["launches"] == len(params) * TRAIN_STEPS
          and math.isfinite(full["loss"]),
          f"AdamW kernel vs the piece path in {arch}'s train step: {full}")
    del params, state, batch, step
    torch.cuda.empty_cache()


def drive_train_phase(dev, smi: str) -> None:
    """Phase 8: the dry-runs of the full-width settings start in worker
    processes (xLSTM's, the longest, first), the SMOKE card-vs-CPU steps,
    the full-width steps and the AdamW kernel's checks run meanwhile."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    order = sorted(TRAIN_DEPTH, key=lambda a: a != "xlstm-1.3b")
    # the full-width steps fill 78-80 GB in blocks of many sizes (96- and
    # 128-head scores beside the weights), where fixed segments leave
    # gigabytes reserved but unusable (Mistral-Large at 2 layers: out of
    # memory at 75.1 GB allocated, 5.7 GB more reserved); expandable
    # segments (PYTORCH_CUDA_ALLOC_CONF's knob) map pages into one range
    # instead. Switched on for this phase alone, so that the earlier
    # phases run with the allocator a user gets.
    torch.cuda.empty_cache()
    torch._C._accelerator_setAllocatorSettings("expandable_segments:True")
    try:
        with ProcessPoolExecutor(
                max_workers=4,
                mp_context=multiprocessing.get_context("spawn")) as pool:
            records = {arch: pool.submit(train_dryrun, arch)
                       for arch in order}
            drive_train_smoke(dev)
            drive_train_full(dev, smi, records)
            drive_adamw(dev)
    finally:
        torch.cuda.empty_cache()
        torch._C._accelerator_setAllocatorSettings("expandable_segments:False")


def mesh_record(arch, shape) -> dict:
    """The port's CPU dry-run record of a cell on rank 0 of the single
    mesh (``launch.dryrun --mesh single``; run in a worker process while
    the card runs the cell)."""
    from repro_torch.launch import dryrun
    out = tempfile.mkdtemp(prefix="mesh_dryrun_")
    try:
        return dryrun.run_one(arch, shape, out_dir=out, force=True,
                              mesh="single")
    finally:
        shutil.rmtree(out, ignore_errors=True)


def seeded_(tree, gen, vocab: int):
    """Fill each DTensor leaf's local shard in place from ``gen``:
    normals x 0.02 (floats), ids below ``vocab`` (integers)."""
    from torch.utils._pytree import tree_leaves
    for t in tree_leaves(tree):
        local = t.to_local()
        if local.dtype.is_floating_point:
            local.normal_(0.0, 0.02, generator=gen)
        else:
            local.random_(0, vocab, generator=gen)
    return tree


def flash_layer_check(dev, cfg, mesh) -> dict:
    """The flash wrapper on one Gemma2 local layer's share of rank 0 at
    prefill_32k, as the mesh's prefill feeds it: q (2 x 32,768, its one
    query head of 16, split over ``model``) and k/v gathered over the
    head split (all 8 KV heads), seeded, through ``ops.flash_attention``
    (``attention_local`` slices rank 0's KV head, a strided view of the
    gathered k/v) against the plain version on the contiguous slice, at
    the sweep's bound."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(23)
    q, k, v = flash_inputs(gen, 2, 32_768, 1, cfg.num_kv_heads,
                           cfg.head_dim, "bfloat16", dev)
    heads = cfg.num_heads // mesh.shape[1]
    # rank 0's shares: global batch 32 over data, 16 q heads over model
    qd = DTensor.from_local(q, mesh, [Shard(0), Shard(2)], run_check=False)
    kd, vd = (DTensor.from_local(t, mesh, [Shard(0), Replicate()],
                                 run_check=False) for t in (k, v))
    kw = dict(causal=True, window=cfg.window, softcap=cfg.attn_softcap)
    got = ops.flash_attention(qd, kd, vd, **kw).to_local()
    g = cfg.num_heads // cfg.num_kv_heads
    kv = slice(0, max(1, heads // g))       # rank 0's KV heads
    want = ref.flash_attention_ref(q, k[:, :, kv].contiguous(),
                                   v[:, :, kv].contiguous(), **kw)
    torch.cuda.synchronize()
    gap, ok = flash_gap(got, want, "bfloat16")
    check(ok, f"mesh: flash_attention_bhsd through attention_local differs "
          f"on a rank's layer: max |gap| {gap}")
    return {"q": list(q.shape), "kv_gathered": list(k.shape), **kw,
            "max_abs_err": gap}


def drive_mesh(dev, smi: str) -> int:
    """Phase 9: rank 0 of the single mesh on the card, one cell a
    ``mesh`` line (``MESH_RUNS``); the dry-run records of the same cells
    come from worker processes meanwhile. Each cell's step and arguments
    are the dry-run's own (``dryrun._step_and_args``: the recipe's
    placements, local shards on the card), seeded. Each cell: every
    parameter's placements as ``specs.param_shardings`` gives them
    (after the steps too); the collectives of the first run, counted by
    the dry-run's ``_Traffic``, per type equal in count and bytes to the
    record's; peak memory over the record's within ``MESH_MEMORY_BAND``;
    the flash kernel launched under the prefill and not under the train
    step, and the flash wrapper on a rank's layer held against its plain
    version; the host syncs of the later runs counted (torch's sync debug
    mode). -> the prefill's flash launches."""
    import multiprocessing
    import warnings
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch import specs as S
    from repro_torch.launch.mesh import axis_size, use_mesh

    cfg = get_config(MESH_ARCH)
    shapes = [INPUT_SHAPES[name] for name in MESH_RUNS]
    flash_total = 0
    with ProcessPoolExecutor(
            max_workers=len(shapes),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        records = {s.name: pool.submit(mesh_record, cfg, s) for s in shapes}
        for shape in shapes:
            torch.cuda.empty_cache()
            with use_mesh("single", dev.type) as mesh:
                gen = torch.Generator(device=dev).manual_seed(0)
                step, args = dryrun._step_and_args(cfg, shape, "adamw", 1,
                                                   mesh)
                for i, tree in enumerate(args):
                    if not (shape.kind == "train" and i == 1):  # moments
                        seeded_(tree, gen, cfg.vocab_size)
                if shape.kind == "decode":
                    for name, t in S._tree_paths(args[1]):
                        if name.endswith("index"):
                            t.to_local().fill_(MESH_FILLED)
                params = args[0]
                want = S.param_shardings(mesh, params, cfg)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                ops.reset_launches()
                count = dryrun._Traffic()
                with dryrun._shape_inference_paused(), count:
                    out = step(*args)
                del out
                syncs = 0
                for _ in range(MESH_RUNS[shape.name] - 1):
                    with warnings.catch_warnings(record=True) as caught:
                        warnings.simplefilter("always")
                        torch.cuda.set_sync_debug_mode("warn")
                        out = step(*args)
                        torch.cuda.set_sync_debug_mode(0)
                        torch.cuda.synchronize()
                    syncs += sum("synchroniz" in str(w.message)
                                 for w in caught)
                    del out
                peak = torch.cuda.max_memory_allocated()
                flash = ops.LAUNCHES["flash_attention_bhsd"]
                placed = sum(tuple(params[n].placements) == want[n]
                             for n in want)
                local_batch = shape.global_batch // axis_size(mesh, "data")
                del step, args, params
                layer = (flash_layer_check(dev, cfg, mesh)
                         if shape.kind == "prefill" else None)
            rec = records[shape.name].result()
            check(rec["status"] == "ok", f"mesh dry-run {shape.name}: "
                  f"{rec.get('error', '')[-1500:]}")
            coll = rec["collectives"]
            est = rec["memory"]["per_device_total_gb"] * 1e9
            line = {"phase": "mesh", "config": cfg.name,
                    "shape": shape.name, "mesh": rec["mesh"], "rank": 0,
                    "recipe": rec["recipe"], "layers": cfg.num_layers,
                    "local_batch": local_batch,
                    "seq": shape.seq_len, "runs": MESH_RUNS[shape.name],
                    "placements_ok": f"{placed} of {len(want)}",
                    "collective_counts": count.coll_counts,
                    "collective_bytes": count.coll_bytes,
                    "dryrun_counts": coll["counts"],
                    "dryrun_bytes": coll["bytes_per_device"],
                    "peak_gb": peak / 1e9, "dryrun_gb": est / 1e9,
                    "peak_over_dryrun": peak / est,
                    "flash_launches": flash, "host_syncs": syncs,
                    "nvidia_smi": smi}
            if layer is not None:
                line["flash_layer"] = layer
            emit(line)
            off = len(want) - placed
            check(off == 0, f"mesh {shape.name}: {off} parameters off "
                  "their recipe's placements")
            for name in coll["counts"]:
                got = (count.coll_counts[name], count.coll_bytes[name])
                check(got == (coll["counts"][name],
                              coll["bytes_per_device"][name]),
                      f"mesh {shape.name}: {name} x {got[0]} ({got[1]} B) "
                      f"on the card, x {coll['counts'][name]} "
                      f"({coll['bytes_per_device'][name]} B) in the dry-run")
            lo, hi = MESH_MEMORY_BAND
            check(lo <= peak / est <= hi,
                  f"mesh {shape.name}: peak {peak / 1e9:.2f} GB over the "
                  f"dry-run's {est / 1e9:.2f} GB out of [{lo}, {hi}]")
            if shape.kind == "prefill":
                check(flash > 0, "mesh: the prefill launched no flash")
                flash_total += flash
            if shape.kind == "train":
                check(flash == 0, f"mesh: the train step launched "
                      f"flash {flash} times")
    return flash_total


def full_width(dev):
    """The full-width char-LM's config (vocab widened to the corpus), FL
    config, corpus, model, and one delta-like tensor per parameter leaf
    on ``dev``."""
    from repro_torch.configs.charlm_shakespeare import CONFIG, FL
    from repro_torch.data import load_corpus
    from repro_torch.models import build

    ds = load_corpus()
    cfg = CONFIG
    if cfg.vocab_size < ds.vocab_size:
        cfg = cfg.replace(vocab_size=ds.vocab_size)
    model = build(cfg)
    probe = model.init(torch.Generator().manual_seed(1), dev).params()
    gen = torch.Generator().manual_seed(2)
    leaves = [delta_like(gen, tuple(t.shape)).to(dev) for t in probe.values()]
    return cfg, FL, ds, model, leaves


def main() -> int:
    # the port is imported before anything is printed: without it (a
    # directory holding only this script) the run fails with no result
    from repro_torch.device import resolve_device
    from repro_torch.kernels import cuda_lib

    start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # deterministic cuBLAS for drive_masked; read when the first cuBLAS
    # handle is made, so it is set before any work
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    dev = resolve_device("cuda")
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    cuda_lib.load_library()
    emit({"phase": "device", "nvidia_smi": smi, "name": name,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "library": os.path.relpath(cuda_lib.library_path(), ROOT)})
    for row in cuda_lib.ptxas_report():
        emit({"phase": "ptxas", **row})

    cfg, fl, ds, model, leaves = full_width(dev)
    emit({"phase": "model", "config": cfg.name, "params":
          model.param_count()["total"], "leaves": len(leaves)})

    worst = check_kernels(leaves, dev)
    worst.update(check_masked_sum(dev))
    emit(check_masked_round(dev, model))
    flash_check = check_flash(dev)
    emit(flash_check)
    worst["flash_attention_bhsd"] = max(*flash_check["max_abs_err"].values(),
                                        check_flash_shapes(dev))

    init_params, rounds, launches = drive_rounds(dev, cfg, fl, ds)
    emit({"phase": "rounds", "rounds": len(rounds), "launches": launches})
    for kernel in ("quantize_blocks", "dequantize_blocks",
                   "quantize_topk_blocks", "flash_attention_bhsd"):
        check(launches[kernel] > 0,
              f"{kernel} was not launched on the client-round path")
    cpu_card_microbatch(cfg, fl, ds, init_params)

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        default_cafl, train_launches = drive_train(dev, out_dir)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    det_launches = drive_masked(dev, default_cafl)
    fleet_launches = drive_fleet(dev)
    sched_launches = drive_sched(dev)
    trace_launches = drive_trace(dev)
    serve_flash = drive_serving(dev, smi)
    serve_flash += drive_serving(dev, smi, **SERVE_MOE)
    serve_flash += drive_serving(dev, smi, **SERVE_MLA)
    serve_flash += drive_serving(dev, smi, **SERVE_REC)
    serve_flash += drive_serving(dev, smi, **SERVE_XLSTM)
    serve_flash += drive_serving(dev, smi, **SERVE_ENCDEC)
    serve_flash += drive_serve_smoke(dev)
    drive_train_phase(dev, smi)
    serve_flash += drive_mesh(dev, smi)
    parts = (launches, train_launches, det_launches, fleet_launches,
             sched_launches, trace_launches,
             {"flash_attention_bhsd": serve_flash})

    def summary(name, replaces, source):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": sum(p.get(name, 0) for p in parts),
                "max_abs_err": worst[name]}

    recs = [summary(*kernel) for kernel in MAIN_KERNELS]
    limbs_rec = summary(*OFF_PATH_KERNEL)
    for r in recs:
        check(r["launches"] > 0,
              f"{r['name']} was not launched on the main path")
    # the limb entry serves the TPU function's contract (ops.masked_sum);
    # the main path's fold goes through the uint64 entry alone
    check(limbs_rec["launches"] == 0,
          f"the main path launched masked_sum_limbs "
          f"{limbs_rec['launches']} times")

    emit({"phase": "total", "seconds": time.perf_counter() - start})
    emit({"phase": "kernel_off_path", **limbs_rec,
          "entry": "(hi, lo) uint32 limbs"})
    emit({"kernels": recs})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
