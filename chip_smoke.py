"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths on the card — the lockVM sweep behind the
paper's fig3 and the results store and lock advisor it feeds, the
differential checker's lane on the lockVM kernel, the lockVM figures,
the serve↔lockVM loop and the fuzz smoke suite, the host-lock suites
(Table 1, host threads, admission), serving granite-moe-1b-a400m at full
width through the ticket-FIFO ``ServeEngine`` (its MoE routing plan
through the routing-plan kernel, and through the ticket kernel), serving
falcon-mamba-7b and recurrentgemma-9b at full width through the same
engine (in bf16 and in float32), serving deepseek-7b, gemma3-1b and
gemma2-27b at full width and depth and mistral-large-123b and grok-1-314b
at full width, depth cut, training granite-moe-1b-a400m at full width on the paper's
host-side locks (with and without the ticket kernel, with and without
remat), training deepseek-7b (also with gradient accumulation), gemma3-1b,
gemma2-27b, mistral-large-123b, falcon-mamba-7b and recurrentgemma-9b at
full width, depth cut to about 2.5 B parameters, training hubert-xlarge at full width and depth, qwen2-vl-72b's
vision frontend and M-RoPE at full width (4 layers), and the five example
scripts — through the entry points a user calls, and checks them:

1. card and build: the card's name and power limit; ``csrc/lockvm.cu``,
   ``csrc/ticket_dispatch.cu``, ``csrc/mamba_scan.cu``,
   ``csrc/rglru_scan.cu`` and ``csrc/moe_plan.cu`` built with ``nvcc`` for
   ``sm_90a`` from the checkout, all at once.
2. kernel vs plain: the lockVM kernel (``mode="cuda"``) against the plain
   PyTorch engine on the card, bit-identical on all eight output stats, on
   the 14 ``tests/corpus`` entries, a fault sweep (preemptions, spurious
   wakes and aborts), cells of 130 threads (past the 128 whose rows the
   kernel keeps in registers), ``figures_reduced`` (each lockVM figure's
   own axes at horizon 2,000, one call per lock count: fig9's cost-grid
   corners and ``twa-sem`` permits, fig10's ``twa-rw`` reader fractions
   and fissile handover, fig12's preemption axis and fig7's
   ``outside_work`` at 1 lock; fig8's collision counting at 4; fig2's
   shared and private arrays at 8 locks and at 64, whose 284,672-word
   cells run from global scratch) and the fig3 cells at a reduced
   horizon.
3. main path: ``repro_torch.sim.run_sweeps`` with ``mode="auto"`` over the
   full fig3 spec (13 locks at 1-64 threads, ``twa-timo`` at 1-32, seeds
   1-3, horizon 1.5M cycles), which must resolve to the kernel; then the
   kernel alone on the same inputs (CUDA events), its microseconds per
   event on the longest cell's chain and the SM clock while it runs.
3a. results_advisor: the main path's 291 fig3 rows appended to a results
   store in a temporary directory, loaded back (schema v2, ``mode``
   ``"cuda"``); ``recommend_lock`` at 64 threads equal to the lock of
   highest median throughput computed from the rows; ``ServeEngine(
   lock="auto")`` on that store resolving that lock's gate; and a small
   ``run_sweep`` under ``$REPRO_RESULTS_STORE`` appending each cell once.
3b. fuzz_cuda: the differential checker's ``cuda`` lane
   (``repro_torch.sim.check``): 1,024 cases generated from a seed drawn
   anew and printed, a quarter with fault schedules and a tenth
   trace-compiled, through the lockVM kernel against the batch oracle's C
   path with the invariant catalog, no differential and no failure but the
   reference's known ``twa-staged`` stall (counted), each case's state
   pinned in shared memory or global scratch (one launch per placement);
   the 14 ``tests/corpus`` entries replayed
   through the kernel to their ``expect_classes``; and the self-test, the
   same batch against an oracle whose stores are eagerly visible, which
   must fail.
4. the paper's fig3 claims on the kernel (ticket collapses, TWA stays flat
   and meets MCS, handover scaling).
4a. figures: fig1, fig2, fig5-fig11 and fig12deg at the reference's full
   specs through ``repro_torch.bench.run``'s suites on the card, each
   suite's launch count set to 0 just before it: every engine call
   resolves to the kernel, each figure's own assertions hold (fig12deg's
   zero-fault column bit-identical to its ``faults=None`` sweep); one
   line a suite with its rows, launches, wall and kernel seconds, the
   largest cell's events, each launch's state placement (fig2's 64-lock
   launch in global scratch) and its headline rows.
4b. fig13: the serve↔lockVM loop end to end (gemma3-1b reduced, random
   weights from a seeded generator): a trace recorded from a
   continuous-batching serve, its replay through the kernel, tokens/s per
   admission gate, ``recommend_lock``'s answer and the ``auto`` gate.
4c. fuzz_smoke: the fuzz smoke suite at the reference's full size: the
   differential stage through the plain engine and the kernel, the
   mutation self-tests, and the host's batch-oracle stage, whose speedup
   gate alone may fail as a recorded reference caveat (printed, counted).
4d. host_locks: ``repro_torch.bench.run``'s ``table1``, ``threads`` and
   ``admission`` suites on the card's host: Table 1 measured on the port's
   lock classes equal to the reference's numbers (``TABLE1``), every
   host-thread cell acquiring, and the admission suite's gates FIFO, its
   ticket/TWA ratios of hot-counter polls and hot-key reads above 1, its
   lockVM sweep (the reference's geometry, full horizon) resolving to the
   kernel (launches counted); every row printed.
5. ticket kernel vs plain: the ticket-dispatch kernel against its plain
   version on the card, tickets and slots equal, on granite-moe's prefill
   and decode groups, 16 groups in one launch, a million arrivals in one
   group, 1 to 3,418 experts, a skewed draw that drops pairs, ids
   outside [0, E) and ids drawn in [-2E, 2E) (wrapped once, or filled with
   INT32_MIN, as the reference's ``dispatch_ref``); the kernel alone under
   ``torch.profiler`` at the decode and a 256-token prefill group, and at
   a train step's MoE layer (8 groups of 4,096 arrivals), beside the
   device time of a one-element ``torch.add`` (the launch floor).
   Then the MoE routing-plan kernel against its plain version
   (``plan_ref``) on the card, every output equal but the aux loss's gate
   sums (rtol 1e-6: summed in another order), on seeded softmax gates at
   granite-moe's prefill groups (Lp 16, 128, 256, 512) and decode group,
   16 groups in one launch, gates tied to the bit, all mass on one expert
   (drops) and grok-1's E 8 / K 2; its time alone and back to back at the
   decode and a 256-token prefill group, beside the launch floor.
6. serve: ``repro_torch.serve.ServeEngine`` on granite-moe-1b-a400m at
   full width in bf16 (random weights from a seeded generator): 16 requests
   of 16-256 prompt tokens and 32 new tokens each, 8 lanes, greedy, the
   default TWA gate.  Every MoE layer's routing plan is one launch of the
   routing-plan kernel (``dispatch="auto"``); a run with
   ``dispatch="ticket"`` (the plain plan around the ticket kernel, one
   launch a layer) and one with ``dispatch="torch"`` (the plain plan) must
   give the same tokens, bit for bit.  A reduced float32 model on the card
   agrees with the same model on the CPU.
7. scan kernel vs plain: the selective-scan kernel against the plain loop
   on float32 casts of its inputs, within 1e-5 (float32 inputs) and 5e-2
   (bf16), at falcon-mamba-7b's full-width prefill shape and small, ragged,
   batched, h0-threaded and mixed-dtype cases; its time at the full-width
   prefill (back-to-back calls, and the kernel alone under
   ``torch.profiler``) beside the plain loop's.
7b. conv kernel vs plain: the causal conv kernel (the Mamba mixer's
   depthwise conv with its bias and SiLU) against the plain version at
   falcon-mamba-7b's prefill (d_inner 8,192, width 4, x the in-projection's
   strided half) at S 256, 2,048 and 10,857 in bf16 and 256 in float32,
   and small, ragged, batched cases: within ``kernel_pair.conv_bound``,
   in bf16 bit for bit on all but at most 1e-5 of the elements, tails
   equal; its time alone at the three prompt lengths beside its bytes
   bound, the plain version's and ``F.conv1d``'s
   (``kernel_pair.conv_times``).
8. serve_mamba: the same traffic on falcon-mamba-7b at full width (64
   layers, d 4,096, bf16, random weights from a seeded generator): every
   prefill goes through the conv and scan kernels once per layer, decode
   through neither.  A second run with ``scan="torch"`` (the plain
   versions; the scan loop's state is bf16 where the kernel's is float32)
   must give the same first token wherever its top-2 margin exceeds twice
   the largest first-token logit difference.  Where the two runs' token
   streams part, the first parting step's top-2 margins and |Δlogit|;
   then the same pair in float32 (the weights cast, ``dtype="float32"``),
   which may part on no more streams, with a first-token logit difference
   at most a tenth of bf16's.  A
   reduced float32 model on the card agrees with the same model on the
   CPU.
9. RG-LRU kernel vs plain: the RG-LRU scan kernel against the plain loop
   on float32 casts of its inputs, equal on float32 inputs and within 5e-2
   on bf16, and within one ulp of the output's dtype of that loop rounded
   to it, at recurrentgemma-9b's full-width prefill shapes (L 256 and
   2,600, D 4,096) and small, ragged, batched, h0-threaded and mixed-dtype
   cases; at the full-width shapes the bf16-state loop must fail the ulp
   limit, so that it tells a float32 state from a bf16 one; its time at
   both prefill shapes (back-to-back calls, and the kernel alone under
   ``torch.profiler`` beside the launch floor) beside the plain loop's;
   its block shape and ring.
10. serve_griffin: recurrentgemma-9b at full width (38 layers, d 4,096,
   window 2,048, bf16, random weights from a seeded generator) on the
   shared traffic plus two long requests (2,030 prompt tokens, whose
   decode crosses the ring's wrap, and 2,600, whose prefill takes the
   banded chunked attention and the ring reorder), ``max_ctx`` 4,096:
   every prefill goes through the RG-LRU kernel once per RG-LRU layer,
   decode through none; the first-token margin rule against
   ``scan="torch"`` and the bf16 and float32 pairs as in phase 8.  A
   reduced float32 model on the card, on a prompt longer than its window,
   agrees with the same model on the CPU.
10a. serve_archs: the same traffic on deepseek-7b (30 layers), gemma3-1b
   (26: 5 local to 1 global, window 512, head_dim 256, plus prompts of 496
   and 1,024 tokens, ``max_ctx`` 2,048), gemma2-27b (46: local and global,
   window 4,096, softcaps 50 and 30, plus 4,080 and 4,160 tokens,
   ``max_ctx`` 4,224, 4 lanes), mistral-large-123b (8 of 88 layers, d
   12,288, 96 heads on 8 KV heads) and grok-1-314b (4 of 64 layers, d
   6,144, 8 experts top-2), bf16, random weights from a seeded generator,
   one line each: the serve checked as phase 6, its times, peak memory
   beside a reckoning from the shapes; the engine's decode rows at the
   first, the window-crossing and the last step of the long requests and
   two short ones against a fresh prefill of the prompt and the tokens so
   far (tokens equal wherever the re-prefill's top-2 margin exceeds twice
   the largest |Δlogit|), and a control, the same decode step outside the
   engine from a cache whose keys are rolled by one position against their
   values, at least 4× as far; grok's three dispatch modes as phase 6
   (the rule itself on a serve whose experts drop no token); the reduced
   float32 model on the card against the CPU.
11. train: ``repro_torch.launch.train.main`` on granite-moe-1b-a400m at full
   width (24 layers, d 1,024, 32 experts top-8, bf16, random weights from a
   seeded generator), batch 8 × seq 512, 6 steps with the Prefetcher on
   the default TWA lock and a checkpoint every 3 steps into a temporary
   directory (free disk space printed first; a save that cannot be
   written fails the phase): every loss finite, step 0's within 10% of
   ln(vocab); the median step time after the first, tokens/s, peak memory,
   the checkpoints' bytes and seconds; the last checkpoint restored bit for
   bit; a run resumed from step 3 (its losses bit-identical to the
   uninterrupted run's: the MoE backward sums in a fixed order, so a step
   on the card repeats itself); 4 steps with ``--use-pallas``, the ticket
   kernel launched twice a MoE layer and step (192: the forward, and the
   backward pass's recompute of each period under the config's
   ``remat="full"``), every loss bit-identical to the plain plan's; 6
   steps with ``remat="none"`` (every activation kept), every loss
   bit-identical, their time and peak memory beside the remat run's.
11a. train_archs, one line an arch: ``repro_torch.launch.train.main`` on
   deepseek-7b (8 of 30 layers, batch 8 × 512), gemma3-1b (all 26, 4 ×
   1,024, past its window of 512), gemma2-27b (one local and one global
   layer of 46, 1 × 4,160, past its window of 4,096), mistral-large-123b
   (1 of 88, 8 × 512), falcon-mamba-7b (8 of 64, 8 × 512, the plain
   selective scan under autograd) and recurrentgemma-9b (6 of 38, 2 ×
   2,600, the plain RG-LRU loop and the window of 2,048), each at full
   width in bf16 with float32 moments: 4 steps, every loss finite and step
   0's within 10% of the start the init implies (``reckoned_start``; a
   tied head's spike at each position's own token read from a forward
   pass); ms a step after the first, tokens/s, the peak beside the
   reckoning from the shapes (``reckon_train_bytes``), seconds; 2 more
   steps of the same argv, losses bit-identical; deepseek-7b again with
   ``--accum 2``, step 0 within ``TRAIN_LOSS_RTOL`` of the first run's,
   every step printed beside it.  Then grok-1-314b's reckoning: one layer
   at full width needs more than the card for its update.
11b. entry_points: the launchers as a user starts them, each in a child
   process (``sys.executable``, PYTHONPATH=src) of a clean environment:
   no ``PYTORCH_CUDA_ALLOC_CONF`` (this script sets one when imported),
   no ``REPRO_*`` variable, nothing of this script imported.  granite's
   ``launch.train`` command line, 4 steps at 8 × 512, plain and with
   ``--use-pallas``: losses bit-identical to phase 11's runs, as many
   ticket launches.  gemma2-27b at phase 11a's cut (2 of 46 layers, 1 ×
   4,160), which trains only with the launchers' allocator default
   (expandable segments): losses bit-identical to phase 11a's, peak within
   1% of it; then the same child with ``expandable_segments:False`` set by
   the caller, left alone by the launcher, whose outcome (out of memory or
   not) is recorded.  granite's ``launch.serve`` command line (8 requests,
   4 lanes): every request's tokens equal to those of the same argv
   through ``launch.serve.main`` in this process, whose routing-plan
   launches are counted, and as many in the child.
11c. train_chunked, one line an arch: falcon-mamba-7b and
   recurrentgemma-9b at phase 11a's cut through ``launch.train``'s command
   line in a child as in 11b, with the reference's ``$REPRO_SCAN_CHUNK``
   set in its environment (Lc 64; 130, since 2,600 = 20 × 130): every scan
   the chunked form (calls counted in the child, one a recurrent layer and
   pass, none of the sequential loop), losses finite, step 0 within 10%
   of the reckoned start and within ``TRAIN_LOSS_RTOL`` of phase 11a's
   sequential run, 2 more steps in the same child bit-identical; ms a
   step, tokens/s and the peak beside the reckoning of the chunked scans.
12. train_devices: reduced float32 granite-moe, falcon-mamba,
   recurrentgemma, qwen2-vl (three distinct M-RoPE streams), hubert,
   deepseek, gemma3, gemma2, mistral and grok-1 (E 4, top-2) take 3 steps
   on the card and on the CPU from the same weights and batches (the
   plain routing plan and scans under autograd), with ``accum_steps`` 1
   and 2: losses within ``DEVICES_LOSS_RTOL``; granite and grok-1 again on
   the card with ``use_pallas=True``: one ticket launch a MoE layer and
   step, losses bit-identical to the plain dispatch's.
13. train_hubert: ``repro_torch.launch.train.main`` on hubert-xlarge at
   full width and depth (48 layers, d 1,280, bidirectional, 504 classes,
   bf16, random weights from a seeded generator), batch 8 × 512 synthetic
   frames, 6 steps, with the config's ``remat="full"`` and with
   ``"none"``: losses finite, step 0's within 10% of ln(504) and equal
   under both; ms a step after the first, frames/s and peak memory each.
14. frontends: qwen2-vl-72b at full width (d 8,192, 64 heads and 8 KV
   heads of 128, d_ff 29,568, vocab 152,064, M-RoPE (16, 24, 24), bf16)
   cut to 4 layers, batch 2 × 1,024 with the synthetic vision span (the
   first 256 positions) and three distinct position streams: ``loss_fn``
   and its backward pass twice (no optimizer step: it would not fit), the
   loss within 10% of ln(vocab) + σ²/2, the cross entropy of random
   weights whose logits have std σ = 0.02·sqrt(d_model) (13.57 here, where
   ln(vocab) is 11.93), gradients finite and non-zero on the layers; a
   prefill of 1,023 positions and ``decode_step`` at 1,023 give the full
   prefill's last argmax wherever the top-2 margin exceeds twice their
   logit difference; ms of the forward, backward and decode, peak memory.
15. examples: ``repro_torch.examples`` quickstart, lock_playground,
   elastic_restart, serve_continuous_batching and train_moe at their own
   specs on the card (the lockVM sweeps through the kernel, launches
   counted), each script's own checks holding.
16. launch: the dry run (``repro_torch.launch.dryrun``) of every reduced
   config × applicable shape on pod16x16 and of seven decode and
   long_500k cells at full width, depth cut (any raise fails the phase),
   then of granite-moe-1b-a400m × train_4k × pod16x16 at full width, on fake
   tensors over a fake process group on the host's CPU: GiB a device,
   product FLOPs and collective bytes beside the reference dry run's
   (constants: the card's host has no JAX), the four roofline terms, the
   dominant one, wall seconds.  These dry runs use no card: they run in a
   child process with none visible, started before phase 1, beside the
   phases on the card (one host core of the eight).  Then the
   one-device roofline (1×1 mesh, no card time) of phase 11's step (batch
   8 × seq 512, with the config's remat and with ``"none"``): its bound
   may not exceed the measured ms a step, and ``train_mfu`` = model FLOPs
   / (989e12 × the measured seconds).

Each phase prints one JSON line.  Before the last line come the kernel
table (a JSON object with key ``kernels``) and the ``nvidia-smi`` name and
power limit; the last line is ``{"ok": true, "device": ...}``.  Any failure
exits non-zero.  Without a CUDA device it exits 1 and prints no result.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import secrets
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# The caching allocator grows by segments that can be unmapped and
# extended, unless the caller configured it: with fixed segments, a
# training step of gemma2-27b (8.6 GB score blocks, 4.7 GB leaves of the
# tied embedding) left 24-26 GiB reserved but free in pieces too small for
# its next 4.4-8 GiB request with 50 GiB allocated (PERF.md §6).  The
# launchers set the same default themselves (``repro_torch.device.
# default_allocator``); this line stays for the phases that build a
# ServeEngine or a train step directly, in this process, without a launcher.
# The entry_points phase's children start without it.
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np  # noqa: E402
import torch  # noqa: E402

# Peak rates of one H100 SXM (NVIDIA's data sheet): HBM bandwidth, and the
# 32-bit rate outside the tensor cores, used for the kernels' bounds.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

# The serve phases: granite-moe-1b-a400m, falcon-mamba-7b and
# recurrentgemma-9b at full width, on one traffic (recurrentgemma's with two
# long requests added, GRIFFIN_LONG prompt tokens, and a longer context).
SERVE_ARCH = "granite-moe-1b-a400m"
GROK_ARCH = "grok-1-314b"        # the routing plan's E 8 / K 2 check
MAMBA_ARCH = "falcon-mamba-7b"
GRIFFIN_ARCH = "recurrentgemma-9b"
GRIFFIN_LONG = (2030, 2600)
GRIFFIN_CTX = 4096
# the RG-LRU kernel's timed shapes: a 256-token and the 2,600-token prefill
GRIFFIN_PREFILL_L = (256, 2600)
SERVE_REQUESTS = 16
SERVE_PROMPT = (16, 256)       # prompt lengths drawn in [16, 256]
SERVE_NEW = 32
SERVE_LANES = 8
SERVE_CTX = 512
# The serve_archs phase: the decoders the phases above do not serve, at full
# width on the shared traffic.  arch: (layers run, None for all; lanes; long
# prompt lengths, multiples of 16 so that no pad key rings; max_ctx).
# gemma3-1b's 496 and gemma2-27b's 4,080 wrap the ring in decode, 1,024 and
# 4,160 prefill past the window.  mistral-large-123b (88 layers, 245 GB in
# bf16) and grok-1-314b (64 layers, 633 GB) keep their width, cut in depth
# to fit one card.  gemma2-27b's lanes are cut to 4: at 8, 54.5 GB of
# weights, 12.5 GB of caches and the 4,160-token prefill's 8.6 GB float32
# scores of a local layer ran out of the card's 79.2 GiB (PERF.md §6).
SERVE_ARCHS = {
    "deepseek-7b": (None, SERVE_LANES, (), SERVE_CTX),
    "gemma3-1b": (None, SERVE_LANES, (496, 1024), 2048),
    "gemma2-27b": (None, 4, (4080, 4160), 4224),
    "mistral-large-123b": (8, SERVE_LANES, (), SERVE_CTX),
    "grok-1-314b": (4, SERVE_LANES, (), SERVE_CTX),
}

FIG3_THREADS = (1, 2, 4, 8, 16, 32, 64)
TIMO_THREADS = (1, 2, 4, 8, 16, 32)  # gen_twa_timo_acquire: T <= 32
# the fig3 cells' horizon in phase 2, where the plain engine takes several
# ms an event step (at 10,000 it took 60 s of the phase: cut so that the
# whole script keeps its time limit beside the entry_points children)
CHECK_HORIZON = 4_000
FIG3_ROWS = 13 * len(FIG3_THREADS) * 3 + len(TIMO_THREADS) * 3   # 291
FUZZ_CASES = 1024
CLAIMS_HORIZON = 800_000

# The figures phase: every lockVM figure suite of repro_torch.bench.run at
# the reference's full spec, with the rows each prints as its headline.
FIGURE_SUITES = {
    "fig1": ("fig1/throughput_ratio_63r_vs_0r",),
    "fig2": ("fig2/locks=", "fig2/worst_penalty"),
    "fig5": ("fig5/twa_over_ticket@64", "fig5/twa/threads=64/lat_p99",
             "fig5/ticket/threads=64/lat_p99"),
    "fig6": ("fig6[rrc]/twa_over_ticket@64",),
    "fig7": ("fig7/twa/threads=64", "fig7/ticket/threads=64"),
    "fig8": ("fig8/decay/",),
    "fig9": ("fig9/sem_scaling", "fig9/ratio_span/"),
    "fig10": ("fig10/read_only_gain", "fig10/fissile_over_twa@"),
    "fig11": ("fig11/twa_over_ticket@64", "fig12/twa_over_ticket@64"),
    "fig12deg": ("fig12deg/zero_fault_bitidentical",
                 "fig12deg/fissile_over_ticket_retained",
                 "fig12deg/retained/"),
}
# kernel_vs_plain's figures_reduced sets: each figure's own axes at this
# horizon (the plain engine pays several ms a step on the card)
FIGURES_REDUCED_HORIZON = 2_000

# The host_locks phase: Table 1 as the reference's table1() measures it
# (algorithm: NPath lock, NPath unlock, cyclomatic lock, cyclomatic
# unlock), and the admission suite's ratios that must exceed 1.
TABLE1 = {"ticket": (2, 1, 2, 1), "twa": (72, 1, 10, 1),
          "twa-staged": (180, 1, 11, 1), "mcs": (6, 5, 4, 5)}
ADMISSION_RATIOS = ("admission/grant_polls_ticket_over_twa",
                    "admission/dist/hot_key_load_ratio_ticket_over_twa")

# The train phase: granite-moe-1b-a400m at full width through
# repro_torch.launch.train, checkpointed at step TRAIN_CKPT_EVERY and
# resumed from it; then TRAIN_PALLAS_STEPS steps through the ticket kernel.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 6
TRAIN_CKPT_EVERY = 3
TRAIN_PALLAS_STEPS = 4
# |loss - loss of the same step in another run| / loss, for hubert's steps
# after a backward pass on the card (its remat and plain runs sum in other
# orders): a step moves the loss by about 2e-3 of itself.  Granite's runs
# (the train phase) must agree bit for bit.
TRAIN_LOSS_RTOL = 1e-4
# step 0's loss within 10% of ln(vocab): random weights predict uniformly
TRAIN_LOSS0_RTOL = 0.1
# the train_devices phase: reduced float32 models, 3 steps on the card and
# on the CPU from the same weights; losses within this relative tolerance
# (granite and grok also with use_pallas=True on the card, and every arch
# with accum_steps 1 and 2)
VLM_ARCH = "qwen2-vl-72b"
AUDIO_ARCH = "hubert-xlarge"
DEVICES_ARCHS = (SERVE_ARCH, MAMBA_ARCH, GRIFFIN_ARCH, VLM_ARCH, AUDIO_ARCH,
                 "deepseek-7b", "gemma3-1b", "gemma2-27b",
                 "mistral-large-123b", GROK_ARCH)
DEVICES_PALLAS_ARCHS = (SERVE_ARCH, GROK_ARCH)
DEVICES_STEPS = 3
DEVICES_LOSS_RTOL = 1e-5
# The train_archs phase: the decoders no phase above trains at full width,
# through repro_torch.launch.train, bf16 with float32 moments, width uncut
# and depth cut to about 2.5 B parameters (the update holds about 22 bytes
# a parameter at its peak); a local layer's sequence passes its window.
# falcon-mamba-7b runs 8 of its 64 layers (1.4 B parameters): its plain
# loop takes one token at a time, 14-19 s a step at 16 layers, and the
# train_chunked lines run the same cut again.
# arch: (layers run, None for all; batch; seq).  TRAIN_ARCHS_STEPS steps,
# then TRAIN_ARCHS_REPEAT steps of the same argv, which must give the same
# losses bit for bit; TRAIN_ACCUM_ARCH again with --accum 2.
TRAIN_ARCHS = {
    "deepseek-7b": (8, 8, 512),
    "gemma3-1b": (None, 4, 1024),
    "gemma2-27b": (2, 1, 4160),
    "mistral-large-123b": (1, 8, 512),
    "falcon-mamba-7b": (8, 8, 512),
    "recurrentgemma-9b": (6, 2, 2600),
}
TRAIN_ARCHS_STEPS, TRAIN_ARCHS_REPEAT = 4, 2
TRAIN_ACCUM_ARCH = "deepseek-7b"
# The entry_points phase: the launchers as a user starts them, each in a
# child process of a clean environment (no allocator setting, no REPRO_*
# variable, PYTHONPATH=src), held to this process's runs of the same argv:
# granite's train (plain and --use-pallas) and serve through the command
# line, gemma2-27b at TRAIN_ARCHS' cut, and that gemma2 run again with
# fixed segments set by the caller (the control: recorded, not a gate).
# A child's peak within ENTRY_PEAK_RTOL of the in-process run's.
ENTRY_TRAIN_STEPS = 4
ENTRY_SERVE_ARGV = ["--arch", SERVE_ARCH, "--requests", "8", "--lanes", "4",
                    "--max-ctx", "128", "--max-new", "8"]
ENTRY_GEMMA2 = "gemma2-27b"
ENTRY_PEAK_RTOL = 0.01
CHILD_TIMEOUT_S = 600
# The train_chunked phase: falcon-mamba-7b and recurrentgemma-9b at
# TRAIN_ARCHS' cut in a child under the reference's $REPRO_SCAN_CHUNK
# (its hillclimb sets 64 and 128; 128 does not divide 2,600 = 20 × 130, so
# recurrentgemma takes 130): arch -> Lc.
TRAIN_SCAN_CHUNK = {MAMBA_ARCH: 64, GRIFFIN_ARCH: 130}
# The train_hubert phase: hubert-xlarge at full width and depth through
# repro_torch.launch.train, with the config's remat ("full") and "none".
AUDIO_BATCH, AUDIO_SEQ, AUDIO_STEPS = 8, 512, 6
# The frontends phase: qwen2-vl-72b at full width with its depth cut to
# VLM_LAYERS (80 layers, 72.7 B parameters, do not fit one card), one loss
# and backward pass (an optimizer step holds old and new parameters and
# float32 moments, about 22 bytes a parameter: 132 GB at 4 layers), and
# decode at the last position against a prefill of all of them.
VLM_LAYERS = 4
VLM_BATCH, VLM_SEQ = 2, 1024
# The examples phase: each script of repro_torch.examples at its own spec.
EXAMPLES = ("quickstart", "lock_playground", "elastic_restart",
            "serve_continuous_batching", "train_moe")


def query_smi(fields: str) -> str:
    """``nvidia-smi --query-gpu=<fields>`` of the first card."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def fig3_specs(sim, horizon: int, max_events: int = 2_000_000) -> list:
    """The fig3 sweep: every lock at 1-64 threads, twa-timo at 1-32."""
    kw = dict(seeds=(1, 2, 3), cs_work=4, ncs_max=200, horizon=horizon,
              max_events=max_events, collect_latency=True)
    others = tuple(lk for lk in sim.SIM_LOCKS if lk != "twa-timo")
    return [sim.SweepSpec(locks=others, threads=FIG3_THREADS, **kw),
            sim.SweepSpec(locks="twa-timo", threads=TIMO_THREADS, **kw)]


def cuda_ms(fn, repeats: int = 1) -> tuple[float, object]:
    """Median device time of ``fn()`` in ms (CUDA events), and its result."""
    times, out = [], None
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)), out


def nbytes(tensors) -> int:
    total = 0
    for x in tensors:
        if x is None:
            continue
        if isinstance(x, (tuple, list)):
            total += nbytes(x)
        else:
            total += x.numel() * x.element_size()
    return total


def compare(name: str, args, n_locks: int, engine, engine_cuda) -> dict:
    """Kernel vs plain engine on one set of input tensors on the card."""
    t0 = time.perf_counter()
    kernel_ms, k_out = cuda_ms(lambda: engine_cuda.run_cells(
        *args, n_locks=n_locks))
    plain_ms, p_out = cuda_ms(lambda: engine.run_cells(*args,
                                                       n_locks=n_locks))
    err = 0
    for key in engine.OUT_KEYS:
        diff = (k_out[key].long() - p_out[key].long()).abs()
        err = max(err, int(diff.max()) if diff.numel() else 0)
    if err:
        bad = [k for k in engine.OUT_KEYS if not torch.equal(k_out[k],
                                                             p_out[k])]
        raise AssertionError(f"{name}: kernel != plain engine on {bad}")
    return {"set": name, "cells": int(args[0].shape[0]),
            "max_events": int(p_out["events"].max()),
            "sum_events": int(p_out["events"].long().sum()),
            "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "plain_ms_per_step": plain_ms / max(int(p_out["events"].max()),
                                                1),
            "max_abs_err": err, "seconds": time.perf_counter() - t0,
            "bytes": nbytes(args) + nbytes(k_out.values()), "out": k_out}


def bound_ms(nbytes_moved: int, n_ops: int) -> tuple[float, str]:
    """Least time for the work: bytes over HBM bandwidth, or its 32-bit
    operations (one per executed event or arrival's counter step; seven per
    scan element) over the scalar peak — the larger."""
    t_bytes = nbytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def launch_ms(fn, launches: int = 200, repeats: int = 5) -> float:
    """Median over ``repeats`` of the device time per call of ``fn`` over
    ``launches`` back-to-back calls (CUDA events), after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return float(np.median(times))


def ticket_cases(dev, moe_capacity, cfg, max_experts: int) -> list:
    """(name, ids (G, n) int32 on the card, E, capacity) of the ticket
    check: granite-moe's prefill groups (N·K = 8·Lp arrivals, E = 32) and
    its decode group at 8 lanes, 16 groups in one launch, one group of
    2**20 arrivals, E from 1 to the shared-memory limit, a skewed draw (all
    to one expert), ids outside [0, E) and ids in [-2E, 2E), whose wrapped
    and filled ids take the reference's tickets."""
    rng = np.random.default_rng(12)
    E, K = cfg.n_experts, cfg.top_k

    def ids(shape, lo, hi):
        return torch.from_numpy(rng.integers(lo, hi, size=shape).astype(
            np.int32)).to(dev)

    cases = [(f"prefill_Lp{lp}", ids((1, K * lp), 0, E), E,
              moe_capacity(cfg, lp)) for lp in (16, 128, 256, 512)]
    cases += [("decode_8_lanes", ids((1, K * SERVE_LANES), 0, E), E,
               moe_capacity(cfg, SERVE_LANES)),
              ("16_groups", ids((16, K * 128), 0, E), E,
               moe_capacity(cfg, 128)),
              ("one_group_2^20", ids((1, 1 << 20), 0, E), E,
               moe_capacity(cfg, (1 << 20) // K))]
    cases += [(f"E{e}", ids((3, 777), 0, e), e, 64)
              for e in (1, 5, 8, 100, 128, max_experts)]
    cases += [("skewed_drop", torch.full((2, 5000), 7, dtype=torch.int32,
                                         device=dev), E, 160),
              ("ids_outside", ids((2, 999), -3, E + 3), E, 20),
              ("ids_wrap_fill", ids((2, 999), -2 * E, 2 * E), E, 20)]
    return cases


def ticket_phase(dev, kernel, ref, moe_capacity, cfg) -> dict:
    """The ticket kernel against its plain version on the card (exact), and
    its time (back to back, and alone beside the launch floor) and bound at
    the serve path's shapes."""
    from repro_torch.bench.kernel_pair import profiled_ms

    t0 = time.perf_counter()
    sets = []
    for name, ids, n_experts, capacity in ticket_cases(
            dev, moe_capacity, cfg, kernel.MAX_EXPERTS):
        t, s = kernel.ticket_dispatch(ids, n_experts, capacity)
        torch.cuda.synchronize()
        p_t, p_s = ref.dispatch_ref(ids, n_experts, capacity, grouped=True)
        err = max(int((t.long() - p_t.long()).abs().max()),
                  int((s.long() - p_s.long()).abs().max()))
        if err:
            raise AssertionError(f"ticket kernel != plain on {name}: "
                                 f"max |err| {err}")
        sets.append({"set": name, "shape": list(ids.shape), "E": n_experts,
                     "capacity": capacity,
                     "dropped": int((s < 0).sum()) - int((t < 0).sum()),
                     "max_abs_err": err})
    timed = {}
    # (name, tokens a group, groups, seed of the ids): the serve's decode
    # group and a 256-token prefill, and a train step's MoE layer (a group
    # a sequence)
    for name, tokens, groups, seed in (
            ("decode", SERVE_LANES, 1, 0), ("prefill_Lp256", 256, 1, 256),
            ("train", TRAIN_SEQ, TRAIN_BATCH, TRAIN_SEQ)):
        n = cfg.top_k * tokens
        cap = moe_capacity(cfg, tokens)
        ids = torch.from_numpy(np.random.default_rng(seed).integers(
            0, cfg.n_experts, size=(groups, n)).astype(np.int32)).to(dev)
        ms = launch_ms(lambda: kernel.ticket_dispatch(ids, cfg.n_experts,
                                                      cap))
        device_ms, floor_ms = profiled_ms(
            lambda: kernel.ticket_dispatch(ids, cfg.n_experts, cap),
            "ticket_dispatch_kernel")
        plain = launch_ms(lambda: ref.dispatch_ref(ids, cfg.n_experts, cap,
                                                   grouped=True))
        # id read once, ticket and slot written once; one counter step each
        bound, bound_by = bound_ms(12 * n * groups, n * groups)
        timed[name] = {"arrivals": n, "groups": groups, "E": cfg.n_experts,
                       "capacity": cap,
                       "ms": ms, "device_ms": device_ms,
                       "launch_floor_ms": floor_ms, "plain_ms": plain,
                       "bound_ms": bound, "bound_by": bound_by}
    return {"phase": "ticket_kernel_vs_plain", "tolerance": "exact",
            "seconds": time.perf_counter() - t0, "sets": sets,
            "timed": timed}


def plan_cases(dev, moe_capacity, cfg, grok) -> list:
    """(name, gates_full (G, N, E) float32 on the card, K, capacity, gate
    dtype) of the routing-plan check: seeded softmax gates at granite-moe's
    prefill groups and decode group at 8 lanes, 16 groups in one launch,
    gates tied to the bit, all mass on one expert (drops), and grok-1's
    E 8 / K 2 at its decode and prefill groups."""
    rng = np.random.default_rng(13)
    E, K = cfg.n_experts, cfg.top_k

    def soft(logits):
        return torch.softmax(torch.from_numpy(np.asarray(
            logits, np.float32)).to(dev), -1)

    bf16 = torch.bfloat16
    cases = [(f"prefill_Lp{lp}", soft(rng.normal(size=(1, lp, E))), K,
              moe_capacity(cfg, lp), bf16) for lp in (16, 128, 256, 512)]
    cases += [("decode_8_lanes", soft(rng.normal(size=(1, SERVE_LANES, E))),
               K, moe_capacity(cfg, SERVE_LANES), bf16),
              ("16_groups", soft(rng.normal(size=(16, 128, E))), K,
               moe_capacity(cfg, 128), bf16),
              ("16_groups_float32", soft(rng.normal(size=(16, 128, E))), K,
               moe_capacity(cfg, 128), torch.float32),
              ("ties", torch.from_numpy((rng.integers(0, 4, size=(
                  2, 256, E)) / 64).astype(np.float32)).to(dev), K,
               moe_capacity(cfg, 256), bf16),
              ("one_expert_drops", soft(np.where(np.arange(E) == 5, 20.0,
                                                 0.0) * np.ones((2, 256, E))),
               K, moe_capacity(cfg, 256), bf16)]
    cases += [(f"grok_E{grok.n_experts}_K{grok.top_k}_{name}",
               soft(rng.normal(size=(g, n, grok.n_experts))), grok.top_k,
               moe_capacity(grok, n), bf16)
              for name, g, n in (("decode", 1, SERVE_LANES),
                                 ("prefill", 4, 256))]
    return cases


def plan_phase(dev, plan, ref, moe_capacity, cfg, grok) -> dict:
    """The routing-plan kernel against its plain version on the card (every
    output equal, the gate sums within 1e-6 relative), and its time (back to
    back, and alone beside the launch floor) and bound at the serve path's
    decode and 256-token prefill groups."""
    from repro_torch.bench.kernel_pair import profiled_ms

    t0 = time.perf_counter()
    sets = []
    for name, gates_full, K, cap, dtype in plan_cases(dev, moe_capacity, cfg,
                                                     grok):
        got = plan.moe_plan(gates_full, K, cap, dtype)
        torch.cuda.synchronize()
        want = ref.plan_ref(gates_full, K, cap, dtype)
        unequal = [k for k in want if k != "gate_sums"
                   and not torch.equal(got[k], want[k])]
        if unequal:
            raise AssertionError(f"routing-plan kernel != plain on {name}: "
                                 f"{unequal}")
        rel = float(((got["gate_sums"] - want["gate_sums"]).abs()
                     / want["gate_sums"].abs().clamp_min(1e-30)).max())
        assert rel <= 1e-6, (name, rel)
        sets.append({"set": name, "shape": list(gates_full.shape), "K": K,
                     "capacity": cap, "gates": str(dtype).split(".")[-1],
                     "dropped": int((~got["kept"]).sum()),
                     "max_abs_err": 0, "gate_sums_max_rel_err": rel})
    timed = {}
    for name, lp in (("decode", None), ("prefill_Lp256", 256)):
        n = SERVE_LANES if lp is None else lp
        cap = moe_capacity(cfg, n)
        gates_full = torch.softmax(torch.from_numpy(np.random.default_rng(
            lp or 0).normal(size=(1, n, cfg.n_experts)).astype(
                np.float32)).to(dev), -1)

        def fn():
            return plan.moe_plan(gates_full, cfg.top_k, cap, torch.bfloat16)

        ms = launch_ms(fn)
        device_ms, floor_ms = profiled_ms(fn, "moe_plan_kernel")
        plain = launch_ms(lambda: ref.plan_ref(gates_full, cfg.top_k, cap,
                                               torch.bfloat16),
                          launches=20)
        # gates_full read once, every output written once; the top-k's
        # compares (E per gate) and one counter step a pair
        bound, bound_by = bound_ms(nbytes([gates_full]) + nbytes(fn().values()),
                                   gates_full.numel() * cfg.n_experts
                                   + n * cfg.top_k)
        timed[name] = {"tokens": n, "E": cfg.n_experts, "K": cfg.top_k,
                       "capacity": cap, "ms": ms, "device_ms": device_ms,
                       "launch_floor_ms": floor_ms, "plain_ms": plain,
                       "bound_ms": bound, "bound_by": bound_by}
    return {"phase": "moe_plan_kernel_vs_plain",
            "tolerance": "exact; gate_sums rtol 1e-6",
            "seconds": time.perf_counter() - t0, "sets": sets,
            "timed": timed}


def serve_prompts(cfg, long: tuple = ()) -> list:
    """The serve traffic's prompts: SERVE_REQUESTS seeded draws of
    SERVE_PROMPT lengths, then one prompt of each length in ``long`` from
    the same draw."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, size=int(rng.integers(
        SERVE_PROMPT[0], SERVE_PROMPT[1] + 1))).tolist()
        for _ in range(SERVE_REQUESTS)]
    return prompts + [rng.integers(1, cfg.vocab, size=n).tolist()
                      for n in long]


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed_serve(ServeEngine, cfg, params, dev, prompts, max_new, kernel,
                max_ctx: int = SERVE_CTX, lanes: int = SERVE_LANES,
                keep=(), **modes) -> dict:
    """One engine run over ``prompts`` with the kernel modes ``modes``: its
    requests, the wall time, each prefill's seconds and kernel launches,
    the launches of the whole run, the engine's prefills, decode steps and
    gate stats, each request's first-token logits (float32, on the host)
    and, for the requests whose indices are in ``keep``, ``rows[i][t]``:
    the logit row (the vocab's columns, float32, on the host) that gave
    token t.  The engine is dropped at the end."""
    eng = ServeEngine(cfg, params, lanes=lanes, max_ctx=max_ctx, device=dev,
                      **modes)
    prefill_s, prefill_launches, first = [], [], []
    rows = {i: [] for i in keep}
    admitting = [None]
    admit, sample = eng._admit, eng._sample

    def timed_admit(lane, req):
        admitting[0] = req.rid
        t, n = time.perf_counter(), kernel.launches
        admit(lane, req)
        _sync(dev)
        prefill_s.append(time.perf_counter() - t)
        prefill_launches.append(kernel.launches - n)

    def recorded_sample(logits):
        if logits.shape[0] == 1:                   # a prefill's first token
            first.append(logits[0].float().cpu())
            if admitting[0] in rows:
                rows[admitting[0]].append(first[-1][:cfg.vocab])
            return sample(logits)
        kept = [(lane, r.rid) for lane, r in enumerate(eng.lane_req)
                if r is not None and r.rid in rows]
        if kept:
            host = logits[:, :cfg.vocab].float().cpu()
            for lane, rid in kept:
                rows[rid].append(host[lane].clone())
        return sample(logits)

    eng._admit, eng._sample = timed_admit, recorded_sample
    reqs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    _sync(dev)
    kernel.launches = 0
    t0 = time.perf_counter()
    eng.run()
    _sync(dev)
    wall = time.perf_counter() - t0
    # the wrappers hold the engine's bound methods: a reference cycle that
    # would keep the engine, and its cache, alive past the run
    del eng._admit, eng._sample
    for i, r in rows.items():
        assert len(r) == len(reqs[i].tokens_out), (i, len(r))
    return {"reqs": reqs, "wall": wall, "prefill_s": prefill_s,
            "prefill_launches": prefill_launches, "launches": kernel.launches,
            "first_logits": first, "rows": rows,
            "prefills": eng.prefill_count, "steps": eng.step_count,
            "stats": eng.stats()}


def check_served(run: dict, cfg, n_requests: int) -> None:
    """FIFO admission, every request done with SERVE_NEW in-range tokens,
    a finite first-token logit row each."""
    reqs = run["reqs"]
    assert [r.ticket for r in reqs] == list(range(n_requests))
    for r in reqs:
        assert r.done.is_set() and len(r.tokens_out) == SERVE_NEW, r.rid
        assert all(0 <= t < cfg.vocab for t in r.tokens_out), r.rid
    adm = [r.admitted_at_step for r in reqs]
    assert adm == sorted(adm), adm                   # admitted in ticket order
    assert run["prefills"] == n_requests
    assert len(run["first_logits"]) == n_requests
    for row in run["first_logits"]:
        assert bool(torch.isfinite(row[:cfg.vocab]).all())


def serve_times(run: dict, n_short: int | None = None) -> dict:
    """Tokens/s, prefill ms per request and decode ms per step of a run;
    with ``n_short``, the prefill ms of the first ``n_short`` requests
    apart from the long ones after them."""
    n_tok = sum(len(r.tokens_out) for r in run["reqs"])
    prefill = sum(run["prefill_s"])
    out = {"wall_s": run["wall"], "tokens_per_s": n_tok / run["wall"],
           "prefill_ms_per_request": 1e3 * prefill / len(run["prefill_s"]),
           "decode_ms_per_step": 1e3 * (run["wall"] - prefill) / run["steps"]}
    if n_short is not None:
        ms = [1e3 * t for t in run["prefill_s"]]
        out["prefill_ms_per_short_request"] = float(np.mean(ms[:n_short]))
        out["prefill_ms_long"] = ms[n_short:]
    return out


def serve_phase(dev, cfg, params, ServeEngine, plan, ticket) -> dict:
    """Serve SERVE_REQUESTS requests at full width, first through the
    routing-plan kernel (``dispatch="auto"``), then through the ticket
    kernel (``dispatch="ticket"``) and with ``dispatch="torch"``; the tokens
    must be equal."""
    prompts = serve_prompts(cfg)
    counters = {"auto": plan, "ticket": ticket, "torch": plan}

    def run(dispatch, max_new):
        return timed_serve(ServeEngine, cfg, params, dev, prompts, max_new,
                           counters[dispatch], dispatch=dispatch)

    t0 = time.perf_counter()
    for dispatch in counters:           # warm-up: allocator, GEMM plans
        run(dispatch, 2)
    torch.cuda.reset_peak_memory_stats()
    auto = run("auto", SERVE_NEW)
    peak = torch.cuda.max_memory_allocated()
    check_served(auto, cfg, SERVE_REQUESTS)
    others = three_dispatches(auto, cfg, run)
    return {"phase": "serve", "entry": "repro_torch.serve.ServeEngine",
            "arch": cfg.name, "dtype": cfg.dtype, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "experts": cfg.n_experts,
            "top_k": cfg.top_k, "vocab": cfg.vocab,
            "params": sum(v.numel() for v in _leaves(params)),
            "requests": SERVE_REQUESTS, "new_tokens": SERVE_NEW,
            "prompt_lengths": [len(p) for p in prompts],
            "lanes": SERVE_LANES, "max_ctx": SERVE_CTX,
            "gate": auto["stats"]["lock"], "prefills": auto["prefills"],
            "decode_steps": auto["steps"], **others,
            **serve_times(auto),
            "prefill_ms": [1e3 * t for t in auto["prefill_s"]],
            "peak_memory_bytes": peak,
            "admission": {k: v for k, v in auto["stats"].items()
                          if k != "lock"},
            "seconds": time.perf_counter() - t0}


def three_dispatches(auto: dict, cfg, run) -> dict:
    """A MoE serve's dispatch modes: ``auto``'s run made one routing-plan
    launch a layer and engine pass; ``run(dispatch, SERVE_NEW)`` with
    ``"ticket"`` makes as many ticket launches, with ``"torch"`` none, and
    both give ``auto``'s tokens bit for bit in as many steps.  Returns the
    launches and the other modes' times."""
    want = cfg.n_layers * (auto["prefills"] + auto["steps"])
    assert auto["launches"] == want, (auto["launches"], want)
    out = {"plan_launches": auto["launches"]}
    tokens = [r.tokens_out for r in auto["reqs"]]
    for name, dispatch, launches in (("ticket", "ticket", want),
                                     ("plain", "torch", 0)):
        other = run(dispatch, SERVE_NEW)
        assert other["launches"] == launches, (dispatch, other["launches"])
        o_tokens = [r.tokens_out for r in other["reqs"]]
        if o_tokens != tokens:
            bad = [i for i, (a, b) in enumerate(zip(tokens, o_tokens))
                   if a != b]
            raise AssertionError(f"tokens with the routing-plan kernel "
                                 f"differ from dispatch={dispatch!r} on "
                                 f"requests {bad}")
        assert other["steps"] == auto["steps"]
        if dispatch == "ticket":
            out["ticket_launches"] = other["launches"]
        out[f"{name}_dispatch"] = {k: serve_times(other)[k] for k in (
            "wall_s", "prefill_ms_per_request", "decode_ms_per_step")}
    out["tokens_bit_identical"] = True
    return out


def margin_rule(auto: dict, plain: dict, cfg) -> dict:
    """First tokens of a kernel run (float32 state) against a plain run
    (bf16 state): they must agree wherever the plain run's top-2 margin
    exceeds twice the largest first-token logit difference, since tokens
    may part only where logits nearly tie.  Returns the differences and
    the counts of decided, equal first tokens and equal streams."""
    diffs = [float((a - b)[:cfg.vocab].abs().max())
             for a, b in zip(auto["first_logits"], plain["first_logits"])]
    delta = max(diffs)
    decided, agree = 0, 0
    for a_req, p_req, row in zip(auto["reqs"], plain["reqs"],
                                 plain["first_logits"]):
        top2 = torch.topk(row[:cfg.vocab], 2).values
        if float(top2[0] - top2[1]) > 2 * delta:
            decided += 1
            assert a_req.tokens_out[0] == p_req.tokens_out[0], a_req.rid
        agree += a_req.tokens_out[0] == p_req.tokens_out[0]
    streams = sum(a.tokens_out == b.tokens_out
                  for a, b in zip(auto["reqs"], plain["reqs"]))
    return {"first_logit_max_abs_diff": delta,
            "first_logit_max_abs_diff_per_request": diffs,
            "first_tokens_decided_by_margin": decided,
            "first_tokens_equal": int(agree),
            "token_streams_equal": int(streams)}


def _top2_margin(row) -> float:
    top2 = torch.topk(row, 2).values
    return float(top2[0] - top2[1])


def parting_rule(a: dict, b: dict) -> dict:
    """Where the token streams of two runs over one traffic part (runs
    that kept every request's rows): for each request whose streams
    differ, the first step t at which they do, both runs' top-2 margins at
    t and the largest |Δlogit| between their two rows at t (the same
    tokens came before, so the rows are one computation in the two
    modes).  A parting is explained when either margin is at most twice
    that difference: a near-tie under the drift the modes allow.  Every
    parting must be explained."""
    partings = []
    for ra, rb in zip(a["reqs"], b["reqs"]):
        t = next((i for i, (x, y) in enumerate(zip(ra.tokens_out,
                                                   rb.tokens_out))
                  if x != y), None)
        if t is None:
            continue
        row_a, row_b = a["rows"][ra.rid][t], b["rows"][rb.rid][t]
        diff = float((row_a - row_b).abs().max())
        margins = [_top2_margin(row_a), _top2_margin(row_b)]
        partings.append({"request": ra.rid, "step": t, "margins": margins,
                         "max_abs_diff": diff,
                         "explained": min(margins) <= 2 * diff})
    unexplained = [p for p in partings if not p["explained"]]
    assert not unexplained, unexplained
    return {"streams": len(a["reqs"]), "streams_parted": len(partings),
            "first_logit_max_abs_diff": max(
                float((a["rows"][i][0] - b["rows"][i][0]).abs().max())
                for i in a["rows"]),
            "partings": partings}


def scan_pairs(dev, cfg, params, ServeEngine, kernel, prompts, max_ctx,
               auto: dict, plain: dict) -> dict:
    """ROADMAP §3.3, the streams that part from ``scan="torch"``: the bf16
    pair (``auto``, the kernel's float32 state, against ``plain``, the
    plain loop's bf16 state) and the same traffic in float32 (the config's
    dtype float32, the same seeded weights cast: activations, caches and
    the plain loop's state float32 too), through the kernel
    (``scan="auto"``) and the plain loop (``scan="torch"``), each pair held
    to :func:`parting_rule`.  The float32 pair may part on no more streams
    than the bf16 pair, with a largest first-token difference at most a
    tenth of the bf16 pair's."""
    bf16 = parting_rule(auto, plain)
    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = _to(params, torch.float32)
    runs = {scan: timed_serve(ServeEngine, cfg32, params32, dev, prompts,
                              SERVE_NEW, kernel, max_ctx=max_ctx,
                              keep=range(len(prompts)), scan=scan)
            for scan in ("auto", "torch")}
    del params32
    for scan, run in runs.items():
        check_served(run, cfg32, len(prompts))
        want = auto["prefill_launches"] if scan == "auto" else \
            [0] * len(prompts)
        assert run["prefill_launches"] == want, (scan,
                                                 run["prefill_launches"])
        assert run["launches"] == sum(want), (scan, run["launches"])
    f32 = parting_rule(runs["auto"], runs["torch"])
    assert f32["streams_parted"] <= bf16["streams_parted"], (f32, bf16)
    assert f32["first_logit_max_abs_diff"] <= \
        bf16["first_logit_max_abs_diff"] / 10, (f32, bf16)
    return {"bf16": bf16, "float32": {
        **f32, "seconds": time.perf_counter() - t0,
        "decode_ms_per_step": {scan: serve_times(run)["decode_ms_per_step"]
                               for scan, run in runs.items()}},
        "rule": "a parting is explained where either run's top-2 margin at "
                "its first differing step is at most twice the rows' "
                "largest |dlogit|"}


def serve_mamba_phase(dev, cfg, params, ServeEngine, kernel, conv) -> dict:
    """Serve the same traffic on falcon-mamba-7b at full width through the
    scan and conv kernels (``scan="auto"``): each prefill launches each once
    per layer, decode never.  Then the same prompts with ``scan="torch"``,
    the plain versions (the scan loop in bf16), held to
    :func:`margin_rule`; then both pairs of :func:`scan_pairs`."""
    prompts = serve_prompts(cfg)
    every = range(len(prompts))

    def run(scan, max_new, keep=()):
        n = conv.launches
        out = timed_serve(ServeEngine, cfg, params, dev, prompts, max_new,
                          kernel, scan=scan, keep=keep)
        out["conv_launches"] = conv.launches - n
        return out

    t0 = time.perf_counter()
    run("auto", 2)                      # warm-up: allocator, GEMM plans
    torch.cuda.reset_peak_memory_stats()
    auto = run("auto", SERVE_NEW, every)
    peak = torch.cuda.max_memory_allocated()
    check_served(auto, cfg, SERVE_REQUESTS)
    assert auto["prefill_launches"] == [cfg.n_layers] * SERVE_REQUESTS, \
        auto["prefill_launches"]
    # every launch came from a prefill: decode launched none
    assert auto["launches"] == sum(auto["prefill_launches"]) \
        == cfg.n_layers * SERVE_REQUESTS, auto["launches"]
    assert auto["conv_launches"] == cfg.n_layers * SERVE_REQUESTS, \
        auto["conv_launches"]
    t_plain = time.perf_counter()
    plain = run("torch", SERVE_NEW, every)
    plain_s = time.perf_counter() - t_plain
    assert plain["launches"] == plain["conv_launches"] == 0, (
        plain["launches"], plain["conv_launches"])
    check_served(plain, cfg, SERVE_REQUESTS)
    margins = margin_rule(auto, plain, cfg)
    times, p_times = serve_times(auto), serve_times(plain)
    return {"phase": "serve_mamba", "entry": "repro_torch.serve.ServeEngine",
            "arch": cfg.name, "dtype": cfg.dtype, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "d_inner": cfg.d_inner,
            "ssm_state": cfg.ssm_state, "vocab": cfg.vocab,
            "params": sum(v.numel() for v in _leaves(params)),
            "requests": SERVE_REQUESTS, "new_tokens": SERVE_NEW,
            "prompt_lengths": [len(p) for p in prompts],
            "lanes": SERVE_LANES, "max_ctx": SERVE_CTX,
            "gate": auto["stats"]["lock"], "prefills": auto["prefills"],
            "decode_steps": auto["steps"],
            "scan_launches": auto["launches"], "decode_scan_launches": 0,
            "conv_launches": auto["conv_launches"],
            **times, "prefill_ms": [1e3 * t for t in auto["prefill_s"]],
            "peak_memory_bytes": peak,
            "plain_scan": {"requests": SERVE_REQUESTS, "seconds": plain_s,
                           **{k: p_times[k] for k in (
                               "wall_s", "prefill_ms_per_request",
                               "decode_ms_per_step")}},
            **margins,
            "partings": scan_pairs(dev, cfg, params, ServeEngine, kernel,
                                   prompts, SERVE_CTX, auto, plain),
            "admission": {k: v for k, v in auto["stats"].items()
                          if k != "lock"},
            "seconds": time.perf_counter() - t0}


def serve_griffin_phase(dev, cfg, params, ServeEngine, kernel) -> dict:
    """Serve the shared traffic plus the two long requests on
    recurrentgemma-9b at full width through the RG-LRU kernel
    (``scan="auto"``): each prefill launches it once per RG-LRU layer,
    decode never.  Then the same prompts with ``scan="torch"``, the plain
    loop in bf16, held to :func:`margin_rule`; then both pairs of
    :func:`scan_pairs`."""
    prompts = serve_prompts(cfg, GRIFFIN_LONG)
    n_req = len(prompts)
    n_rglru = cfg.layer_kinds().count("rglru")

    def run(scan, max_new, keep=()):
        return timed_serve(ServeEngine, cfg, params, dev, prompts, max_new,
                           kernel, max_ctx=GRIFFIN_CTX, scan=scan, keep=keep)

    t0 = time.perf_counter()
    run("auto", 2)                      # warm-up: allocator, GEMM plans
    torch.cuda.reset_peak_memory_stats()
    auto = run("auto", SERVE_NEW, range(n_req))
    peak = torch.cuda.max_memory_allocated()
    check_served(auto, cfg, n_req)
    assert auto["prefill_launches"] == [n_rglru] * n_req, \
        auto["prefill_launches"]
    # every launch came from a prefill: decode launched none
    assert auto["launches"] == sum(auto["prefill_launches"]) \
        == n_rglru * n_req, auto["launches"]
    t_plain = time.perf_counter()
    plain = run("torch", SERVE_NEW, range(n_req))
    plain_s = time.perf_counter() - t_plain
    assert plain["launches"] == 0, plain["launches"]
    check_served(plain, cfg, n_req)
    margins = margin_rule(auto, plain, cfg)
    times = serve_times(auto, SERVE_REQUESTS)
    p_times = serve_times(plain, SERVE_REQUESTS)
    return {"phase": "serve_griffin", "entry": "repro_torch.serve.ServeEngine",
            "arch": cfg.name, "dtype": cfg.dtype, "n_layers": cfg.n_layers,
            "rglru_layers": n_rglru, "d_model": cfg.d_model,
            "lru_width": cfg.lru_width, "window": cfg.window,
            "vocab": cfg.vocab,
            "params": sum(v.numel() for v in _leaves(params)),
            "param_count_formula": cfg.param_count(),
            "requests": n_req, "new_tokens": SERVE_NEW,
            "prompt_lengths": [len(p) for p in prompts],
            "lanes": SERVE_LANES, "max_ctx": GRIFFIN_CTX,
            "gate": auto["stats"]["lock"], "prefills": auto["prefills"],
            "decode_steps": auto["steps"],
            "rglru_launches": auto["launches"], "decode_rglru_launches": 0,
            **times, "prefill_ms": [1e3 * t for t in auto["prefill_s"]],
            "peak_memory_bytes": peak,
            "plain_scan": {"requests": n_req, "seconds": plain_s,
                           **{k: p_times[k] for k in (
                               "wall_s", "prefill_ms_per_request",
                               "decode_ms_per_step", "prefill_ms_long")}},
            **margins,
            "partings": scan_pairs(dev, cfg, params, ServeEngine, kernel,
                                   prompts, GRIFFIN_CTX, auto, plain),
            "admission": {k: v for k, v in auto["stats"].items()
                          if k != "lock"},
            "seconds": time.perf_counter() - t0}


def _leaves(params):
    yield params["embed"]
    yield params["final_norm"]
    for slot in params["stack"].values():
        yield from slot.values()
    for layer in params["tail"]:
        yield from layer.values()
    if "lm_head" in params:
        yield params["lm_head"]


def _to(tree, target):
    """A parameter or cache tree with every tensor moved to ``target``, a
    device or a dtype."""
    if isinstance(tree, dict):
        return {k: _to(v, target) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, target) for v in tree]
    return tree.to(target)


def small_model_phase(dev, cfg, model, kernel, launches_per_pass) -> dict:
    """A reduced float32 model on the card (its kernel) against the same
    weights on the CPU (plain versions): prefill logits and two decode
    steps, the kernel launched ``launches_per_pass[i]`` times in pass i.
    Tolerance rtol = atol = 1e-4: float32 sums run in another order on the
    card (TF32 is off)."""
    params = model.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    on_card = _to(params, dev)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        1, cfg.vocab, size=(2, 40)))
    steps = [(torch.tensor([[5], [9]]), torch.tensor([40, 17])),
             (torch.tensor([[7], [11]]), torch.tensor([41, 18]))]

    def grow(cache):
        """The prefill cache with room for 40 more positions in the keys
        and values of global attention layers; a sliding-window layer's
        ring (the prompt is longer than the window) and state leaves stay
        as they are."""
        def more(kind, k, v, dim):
            if kind != "global" or k not in ("k", "v"):
                return v
            return torch.cat([v, torch.zeros_like(v)], dim=dim)
        return {"stack": {j: {k: more(cfg.layer_pattern[int(j[4:])], k, v, 2)
                              for k, v in slot.items()}
                          for j, slot in cache["stack"].items()},
                "tail": [{k: more(kind, k, v, 1) for k, v in layer.items()}
                         for kind, layer in zip(cfg.tail_kinds,
                                                cache["tail"])]}

    def prefill_and_steps(p, device):
        counts = []
        n = kernel.launches
        logits, _, cache = model.forward(p, {"tokens": tokens.to(device)},
                                         cfg, collect_cache=True)
        outs = [logits.cpu()]
        counts.append(kernel.launches - n)
        cache = grow(cache)
        for tok, pos in steps:
            n = kernel.launches
            d_logits, cache = model.decode_step(p, cache, tok.to(device),
                                                pos.to(device), cfg)
            outs.append(d_logits.cpu())
            counts.append(kernel.launches - n)
        return outs, counts

    card, launches = prefill_and_steps(on_card, dev)
    assert launches == list(launches_per_pass), launches
    host, host_launches = prefill_and_steps(params, torch.device("cpu"))
    assert host_launches == [0, 0, 0], host_launches
    errs = []
    for a, b in zip(card, host):
        assert torch.isfinite(a[..., :cfg.vocab]).all()
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
        errs.append(float((a - b).abs()[..., :cfg.vocab].max()))
    return {"arch": cfg.name + " reduced", "dtype": cfg.dtype,
            "tolerance": "rtol=atol=1e-4 vs the CPU",
            "passes": ["prefill", "decode", "decode"], "max_abs_err": errs,
            "launches": launches}


def reprefill_steps(cfg, prompt_len: int) -> list:
    """The decode steps of a request the re-prefill rule checks: the first,
    the one whose position reaches a local layer's window (the ring's
    first wrap, where the decode crosses it) and the last.  Step t feeds
    token t - 1 at position ``prompt_len + t - 1`` and gives token t."""
    steps = {1, SERVE_NEW - 1}
    cross = cfg.window - prompt_len + 1
    if "local" in cfg.layer_pattern and 1 < cross < SERVE_NEW - 1:
        steps.add(cross)
    return sorted(steps)


def last_logits(model, cfg, params, ids, dev) -> torch.Tensor:
    """The last position's logits (the vocab's columns, float32, on the
    host) of a fresh ``forward`` over ``ids``."""
    tokens = torch.tensor([ids], device=dev)
    logits, _, _ = model.forward(params, {"tokens": tokens}, cfg)
    return logits[0, -1, :cfg.vocab].float().cpu()


# The re-prefill rule's controls: a cache's attention leaves rolled by one
# position along the sequence in every attention layer.  "keys" rolls the
# keys against their values (each key pairs with the value of the position
# before it): the control the rule must tell from rounding.  "slots" rolls
# keys and values together, which only reorders the pairs, to which
# attention is blind (RoPE is in the cached keys): the new key overwrites
# the previous position's pair and one stale pair stays, one pair in n,
# which on the card moved the logits 1.0-3.5× as far as bf16 rounding does
# but for mistral's 14.9× (PERF.md §6): printed.
CONTROLS = {"keys": ("k",), "slots": ("k", "v")}


def outside_decodes(model, cfg, params, ids, dev, max_ctx) -> dict:
    """The decode step of ``ids[-1]`` taken outside the engine under each
    of :data:`CONTROLS`: a prefill of ``ids[:-1]`` written into a one-lane
    cache of ``max_ctx`` positions, the control's leaves rolled by one
    position along the sequence, then ``decode_step``; its logits (as
    :func:`last_logits`) by control."""
    from repro_torch.serve.kv_cache import insert_prefill
    n = len(ids) - 1
    _, _, prefilled = model.forward(
        params, {"tokens": torch.tensor([ids[:-1]], device=dev)}, cfg,
        collect_cache=True)
    out = {}
    for name, keys in CONTROLS.items():
        cache = model.init_cache(cfg, 1, max_ctx, device=dev)
        insert_prefill(cache, prefilled, 0)
        for leaves, dim in [(slot, 2) for slot in cache["stack"].values()] \
                + [(layer, 1) for layer in cache["tail"]]:
            for key in keys:
                if key in leaves:
                    leaves[key].copy_(leaves[key].roll(1, dims=dim))
        logits, _ = model.decode_step(params, cache,
                                      torch.tensor([[ids[-1]]], device=dev),
                                      torch.tensor([n], device=dev), cfg)
        out[name] = logits[0, :cfg.vocab].float().cpu()
        del cache, logits
    return out


def reprefill_rule(model, cfg, params, run, checked, dev, max_ctx) -> dict:
    """The engine's decode rows held to a fresh prefill: for each request
    of ``checked`` (whose rows ``run`` kept) at each of its
    :func:`reprefill_steps`, the row of step t against the last-position
    logits of a ``forward`` over the prompt and tokens 0..t-1.  Tokens must
    be equal wherever the re-prefill's top-2 margin exceeds twice the
    largest |Δlogit| over those rows.  The "keys" control of
    :func:`outside_decodes` at the same steps must depart from the
    re-prefill at least 4× as far as the engine's rows do, or the rule
    could not tell a misplaced cache slot from rounding."""
    rows = []
    for i in checked:
        req = run["reqs"][i]
        for step in reprefill_steps(cfg, len(req.prompt)):
            ids = list(req.prompt) + req.tokens_out[:step]
            fresh = last_logits(model, cfg, params, ids, dev)
            controls = outside_decodes(model, cfg, params, ids, dev, max_ctx)
            rows.append({
                "request": i, "prompt_len": len(req.prompt), "step": step,
                "position": len(ids) - 1,
                "max_abs_diff": float((run["rows"][i][step] - fresh)
                                      .abs().max()),
                **{f"{name}_roll_max_abs_diff": float(
                    (row - fresh).abs().max())
                   for name, row in controls.items()},
                "margin": _top2_margin(fresh),
                "token_equal": req.tokens_out[step] == int(fresh.argmax())})
    delta = max(r["max_abs_diff"] for r in rows)
    control = {name: max(r[f"{name}_roll_max_abs_diff"] for r in rows)
               for name in CONTROLS}
    decided = [r for r in rows if r["margin"] > 2 * delta]
    assert all(r["token_equal"] for r in decided), (delta, rows)
    assert control["keys"] >= 4 * delta, (control, delta, rows)
    return {"max_abs_diff": delta,
            **{f"{name}_roll_max_abs_diff": c for name, c in control.items()},
            **{f"{name}_roll_over_true": c / delta if delta else math.inf
               for name, c in control.items()},
            "rows_decided_by_margin": len(decided),
            "tokens_equal": sum(r["token_equal"] for r in rows),
            "keys_roll_rows_at_4x": sum(
                r["keys_roll_max_abs_diff"] >= 4 * delta for r in rows),
            "rows": rows}


def reckon_serve_bytes(cfg, model, params, lanes: int, max_ctx: int,
                       longest: int) -> dict:
    """A serve's device bytes reckoned from its shapes: the weights, the
    engine's caches (``init_cache`` on the meta device), and the longest
    prefill's (padded to 16) largest transient, whichever is larger of its
    float32 logits with the product they are cast from and its largest
    float32 score tensor with its probabilities (computed in place: one
    float32 copy of each)."""
    from repro_torch.tree import tree_leaves
    elt = model.torch_dtype(cfg).itemsize
    weights = nbytes(tree_leaves(params))
    cache_bytes = nbytes(tree_leaves(model.init_cache(cfg, lanes, max_ctx,
                                                      device="meta")))
    S = -(-longest // 16) * 16
    H, w, qc = cfg.n_heads, cfg.window, model.L.Q_CHUNK
    scores = []
    if "global" in cfg.layer_pattern:
        scores.append(H * (qc if S > 2 * qc else S) * S)
    if "local" in cfg.layer_pattern:
        scores.append(H * S * S if S <= w else -(-S // w) * H * w * 2 * w)
    transient = (4 + elt) * max(S * cfg.padded_vocab, *scores)
    return {"weights": weights, "caches": cache_bytes,
            "prefill_transient": transient,
            "total": weights + cache_bytes + transient}


def serve_arch_phase(dev, cfg, model, ServeEngine, plan, ticket, *,
                     lanes: int, long: tuple, max_ctx: int) -> dict:
    """One decoder of SERVE_ARCHS at full width (depth as ``cfg`` has it),
    bf16, random weights from a seeded generator on the card, through
    ``ServeEngine``: the shared traffic plus ``long`` prompts on ``lanes``
    lanes of ``max_ctx`` positions, checked as the other serves
    (:func:`check_served`), its decode rows held to :func:`reprefill_rule`
    (the long requests and requests 0 and 1; a MoE model's on a serve whose
    experts drop no token), a MoE model's three dispatch modes
    (:func:`three_dispatches`), and the reduced float32 model on the card
    against the CPU (:func:`small_model_phase`).  The weights are dropped
    at the end."""
    t0 = time.perf_counter()
    params = model.init_params(cfg, torch.Generator(device=dev).manual_seed(
        0), device=dev)
    _sync(dev)
    init_s = time.perf_counter() - t0
    prompts = serve_prompts(cfg, long)
    n_req = len(prompts)
    checked = (0, 1, *range(SERVE_REQUESTS, n_req))
    moe = bool(cfg.n_experts)
    counters = {"auto": plan, "ticket": ticket, "torch": plan}

    def run(dispatch, max_new, keep=()):
        return timed_serve(ServeEngine, cfg, params, dev, prompts, max_new,
                           counters[dispatch], max_ctx=max_ctx, lanes=lanes,
                           keep=keep, dispatch=dispatch)

    for dispatch in (counters if moe else ("auto",)):   # warm-up
        run(dispatch, 2)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    auto = run("auto", SERVE_NEW, checked)
    peak = torch.cuda.max_memory_allocated(dev)
    check_served(auto, cfg, n_req)
    out = {"phase": "serve_archs", "entry": "repro_torch.serve.ServeEngine",
           "arch": cfg.name, "dtype": cfg.dtype, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "n_heads": cfg.n_heads,
           "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
           "d_ff": cfg.d_ff, "vocab": cfg.vocab,
           "layer_pattern": list(cfg.layer_pattern),
           **({"window": cfg.window} if "local" in cfg.layer_pattern else {}),
           "attn_softcap": cfg.attn_softcap,
           "logit_softcap": cfg.logit_softcap,
           "experts": cfg.n_experts, "top_k": cfg.top_k,
           "params": sum(v.numel() for v in _leaves(params)),
           "param_count_formula": cfg.param_count(),
           "init_params_s": init_s, "requests": n_req,
           "new_tokens": SERVE_NEW,
           "prompt_lengths": [len(p) for p in prompts], "lanes": lanes,
           "max_ctx": max_ctx, "gate": auto["stats"]["lock"],
           "prefills": auto["prefills"], "decode_steps": auto["steps"],
           **serve_times(auto, SERVE_REQUESTS),
           "peak_memory_bytes": peak,
           "reckoned_bytes": reckon_serve_bytes(
               cfg, model, params, lanes, max_ctx, max(map(len, prompts)))}
    if lanes != SERVE_LANES:
        out["lanes_cut"] = f"{SERVE_LANES} -> {lanes}"
    rule_cfg, rule_run = cfg, auto
    if moe:
        out.update(three_dispatches(auto, cfg, run))
        # each prefill routes its sequence as one group, padded to 16, and
        # a re-prefill routes a longer one: under the config's capacity
        # their experts drop other tokens, so the rule runs on a serve whose
        # experts take every token (capacity factor E / K)
        rule_cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.top_k)
        rule_run = timed_serve(ServeEngine, rule_cfg, params, dev, prompts,
                               SERVE_NEW, plan, max_ctx=max_ctx, lanes=lanes,
                               keep=checked)
        check_served(rule_run, rule_cfg, n_req)
        assert rule_run["launches"] == cfg.n_layers * (
            rule_run["prefills"] + rule_run["steps"]), rule_run["launches"]
        out["reprefill_capacity_factor"] = rule_cfg.capacity_factor
    else:
        assert auto["launches"] == 0, auto["launches"]
    out["reprefill"] = reprefill_rule(model, rule_cfg, params, rule_run,
                                      checked, dev, max_ctx)
    del params, auto, rule_run
    gc.collect()
    torch.cuda.empty_cache()
    small = cfg.reduced()
    out["small_model"] = small_model_phase(
        dev, small, model, plan, [small.n_layers if moe else 0] * 3)
    out["seconds"] = time.perf_counter() - t0
    return out


def scan_cases(dev) -> list:
    """(name, float32 inputs on the card, dtype) of the scan check:
    falcon-mamba-7b's full-width prefill (L 256, D 8,192, N 16) in bf16 and
    float32, the reference tests' shapes, L 1 and 33, D 20, N 4 and 8, a
    batch of 2 with h0 shared and per sequence, and mixed dtypes (float32
    A and D_skip, bf16 rest)."""
    rng = np.random.default_rng(21)

    def draw(L, D, N, lead=(), per_seq=False, h0=False):
        own = lead if per_seq else ()
        arrays = [rng.normal(size=lead + (L, D)),
                  rng.uniform(0.01, 0.2, size=lead + (L, D)),
                  -rng.uniform(0.5, 2.0, size=own + (D, N)),
                  rng.normal(size=lead + (L, N)),
                  rng.normal(size=lead + (L, N)), rng.normal(size=own + (D,)),
                  rng.normal(size=own + (D, N)) if h0 else None]
        return [None if a is None else torch.from_numpy(
            a.astype(np.float32)).to(dev) for a in arrays]

    cases = [("prefill_L256_D8192_N16_bf16", draw(256, 8192, 16), "bf16"),
             ("prefill_L256_D8192_N16_f32", draw(256, 8192, 16), "f32")]
    cases += [(f"L{L}_D{D}_N{N}_{dt}", draw(L, D, N), dt)
              for L, D, N, dt in ((16, 8, 4, "f32"), (100, 96, 16, "f32"),
                                  (256, 128, 16, "f32"), (33, 20, 8, "f32"),
                                  (64, 64, 16, "bf16"), (1, 40, 16, "f32"),
                                  (1, 8192, 16, "bf16"), (33, 40, 16, "bf16"),
                                  (70, 20, 4, "f32"), (70, 20, 8, "f32"))]
    cases += [("batch2_h0_shared", draw(40, 24, 8, (2,), h0=True), "f32"),
              ("batch2_h0_per_seq", draw(40, 24, 8, (2,), True, True),
               "bf16"),
              ("mixed_dtypes", draw(50, 30, 16), "mixed")]
    return cases


def as_dtype(args, dtype: str) -> list:
    """The inputs all in ``dtype`` ("f32", "bf16"), or bf16 with float32 A
    and D_skip ("mixed")."""
    return [None if a is None else
            a.to(torch.bfloat16) if dtype == "bf16" or (
                dtype == "mixed" and i not in (2, 5)) else a
            for i, a in enumerate(args)]


def scan_phase(dev, kernel, ref) -> dict:
    """The scan kernel against the plain loop on float32 casts of its
    inputs (rtol = atol = 1e-5 for float32 inputs, 5e-2 otherwise), the
    h0 threading, and its time and bound at the full-width prefill."""
    from repro_torch.bench.kernel_pair import profiled_ms

    t0 = time.perf_counter()
    sets = []
    cases = scan_cases(dev)
    for name, f32_args, dtype in cases:
        args = as_dtype(f32_args, dtype)
        y, h = kernel.selective_scan(*args)
        torch.cuda.synchronize()
        assert y.dtype == h.dtype == args[0].dtype, name
        ry, rh = ref.selective_scan_ref(*(None if a is None else a.float()
                                          for a in args))
        tol = 1e-5 if dtype == "f32" else 5e-2
        for got, want in ((y, ry), (h, rh)):
            assert bool(torch.isfinite(got).all()), name
            torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol,
                                       msg=name)
        sets.append({"set": name, "shape": list(args[0].shape),
                     "N": args[2].shape[-1], "dtype": dtype,
                     "tolerance": tol,
                     "max_abs_err": max(float((y.float() - ry).abs().max()),
                                        float((h.float() - rh).abs().max()))})
    # h0 threads through: two halves equal one scan (float32, L 100)
    x, dt, A, B, C, Dsk, _ = cases[3][1]
    y_full, h_full = ref.selective_scan_ref(x, dt, A, B, C, Dsk)
    y_a, h_a = kernel.selective_scan(x[:37], dt[:37], A, B[:37], C[:37],
                                     Dsk)
    y_b, h_b = kernel.selective_scan(x[37:], dt[37:], A, B[37:], C[37:],
                                     Dsk, h_a)
    torch.testing.assert_close(torch.cat([y_a, y_b]), y_full, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(h_b, h_full, rtol=1e-5, atol=1e-5)
    sets.append({"set": "two_halves_L100", "tolerance": 1e-5,
                 "max_abs_err": max(
                     float((torch.cat([y_a, y_b]) - y_full).abs().max()),
                     float((h_b - h_full).abs().max()))})
    # time and bound at the full-width prefill, bf16 as the serve runs it
    args = as_dtype(cases[0][1], "bf16")[:6]
    ms = launch_ms(lambda: kernel.selective_scan(*args))
    device_ms, floor_ms = profiled_ms(lambda: kernel.selective_scan(*args),
                                      "mamba_scan_kernel")
    plain_ms = launch_ms(lambda: ref.selective_scan_ref(*args), launches=3,
                         repeats=3)
    L, D = args[0].shape
    N = args[2].shape[-1]
    out = kernel.selective_scan(*args)
    bound, bound_by = bound_ms(nbytes(args) + nbytes(out),
                               7 * L * D * N + 2 * L * D)
    return {"phase": "scan_kernel_vs_plain",
            "tolerance": "rtol=atol=1e-5 (float32 inputs), 5e-2 (bf16)",
            "seconds": time.perf_counter() - t0, "sets": sets,
            "lanes_per_channel": kernel.LANES,
            "timed": {"shape": [L, D, N], "dtype": "bf16", "ms": ms,
                      "device_ms": device_ms, "launch_floor_ms": floor_ms,
                      "plain_ms": plain_ms,
                      "bound_ms": bound, "bound_by": bound_by}}


def conv_phase(dev, kernel, ref) -> dict:
    """The conv kernel against the plain version (within ``conv_bound``; in
    bf16 bit for bit but on at most 1e-5 of the elements; tails equal) at
    falcon-mamba-7b's prefill and small cases, and its time at the
    prefill's lengths."""
    from repro_torch.bench.kernel_pair import (conv_bound, conv_times,
                                               ulps_apart)

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(23)
    sets = []
    for B, S, d, kw, dtype, strided in (
            (1, 256, 8192, 4, "bf16", True), (1, 2048, 8192, 4, "bf16", True),
            (1, 10857, 8192, 4, "bf16", True), (1, 256, 8192, 4, "f32", True),
            (1, 1, 64, 4, "bf16", True), (3, 2, 20, 4, "f32", True),
            (3, 257, 20, 4, "bf16", False), (2, 9, 24, 2, "f32", False),
            (2, 33, 24, 3, "bf16", True)):
        dt = torch.bfloat16 if dtype == "bf16" else torch.float32
        full = torch.randn((B, S, 2 * d), generator=gen, device=dev).to(dt)
        x = full.chunk(2, -1)[0] if strided else full[..., :d].clone(
            memory_format=torch.contiguous_format)
        w = (0.5 * torch.randn((d, kw), generator=gen, device=dev)).to(dt)
        b = (0.1 * torch.randn((d,), generator=gen, device=dev)).to(dt)
        y, tail = kernel.causal_conv(x, w, b)
        ry, rtail = ref.causal_conv_ref(x, w, b)
        torch.cuda.synchronize()
        name = f"B{B}_S{S}_d{d}_kw{kw}_{dtype}"
        assert y.dtype == tail.dtype == dt, name
        assert torch.equal(tail, rtail), name
        ulps = ulps_apart(y, ry)
        err = (y.double() - ry.double()).abs()
        assert bool((err <= conv_bound(x, w, b, ry)).all()), name
        if dt == torch.bfloat16:
            assert float((ulps > 0).float().mean()) <= 1e-5, name
        sets.append({"set": name, "strided": strided,
                     "max_ulps": int(ulps.max()),
                     "differing_share": float((ulps > 0).float().mean()),
                     "max_abs_err": float((y.float() - ry.float()).abs()
                                          .max())})
    timed = conv_times(dev)
    return {"phase": "conv_kernel_vs_plain",
            "tolerance": "conv_bound; bf16 differing on at most 1e-5",
            "seconds": time.perf_counter() - t0, "sets": sets,
            "timed": timed}


def rglru_cases(dev) -> list:
    """(name, float32 (a, b, h0) on the card, dtype) of the RG-LRU check:
    recurrentgemma-9b's full-width prefills (L 256 and 2,600, D 4,096) in
    bf16 and float32, the reference tests' shapes, L 1, 31 and 65, D 20,
    70 and 129 (ragged), a batch of 3 with h0 per sequence and of 2 with
    h0 shared, and mixed dtypes (float32 a, bf16 b and h0)."""
    rng = np.random.default_rng(22)

    def draw(L, D, lead=(), h0=None):
        arrays = [rng.uniform(0.3, 0.999, size=lead + (L, D)),
                  rng.normal(size=lead + (L, D)),
                  None if h0 is None else rng.normal(size=h0)]
        return [None if a is None else torch.from_numpy(
            a.astype(np.float32)).to(dev) for a in arrays]

    cases = [(f"prefill_L{L}_D4096_bf16", draw(L, 4096), "bf16")
             for L in GRIFFIN_PREFILL_L]
    cases += [("prefill_L256_D4096_f32", draw(256, 4096), "f32")]
    cases += [(f"L{L}_D{D}_{dt}", draw(L, D), dt)
              for L, D, dt in ((16, 8, "f32"), (100, 96, "f32"),
                               (256, 256, "f32"), (33, 20, "f32"),
                               (128, 64, "bf16"), (1, 20, "f32"),
                               (31, 70, "bf16"), (65, 129, "f32"))]
    cases += [("batch3_h0_per_seq", draw(40, 24, (3,), (3, 24)), "f32"),
              ("batch2_h0_shared", draw(40, 24, (2,), (24,)), "bf16"),
              ("mixed_dtypes", draw(50, 30, (), (30,)), "mixed")]
    return cases


def rglru_phase(dev, kernel, ref) -> dict:
    """The RG-LRU kernel against the plain loop on float32 casts of its
    inputs (equal for float32 inputs, rtol = atol = 5e-2 otherwise), and
    within one ulp of the output's dtype of that loop rounded to it: a
    float32 state rounds only at the output.  At both full-width bf16
    prefills the bf16-state loop must fall outside that ulp limit, so the
    limit tells the two states apart.  Also the h0 threading, and the
    kernel's time and bound at both full-width prefills."""
    from repro_torch.bench.kernel_pair import outside_one_ulp, profiled_ms

    t0 = time.perf_counter()
    sets = []
    cases = rglru_cases(dev)
    for name, f32_args, dtype in cases:
        args = [None if a is None else a.to(torch.bfloat16)
                if dtype == "bf16" or (dtype == "mixed" and i > 0) else a
                for i, a in enumerate(f32_args)]
        y, h = kernel.rglru_scan(*args)
        torch.cuda.synchronize()
        assert y.dtype == h.dtype == args[0].dtype, name
        ry, rh = ref.rglru_scan_ref(*(None if a is None else a.float()
                                      for a in args))
        tol = 1e-5 if dtype == "f32" else 5e-2
        for got, want in ((y, ry), (h, rh)):
            assert bool(torch.isfinite(got).all()), name
            torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol,
                                       msg=name)
            assert outside_one_ulp(got, want) == 0.0, name
            # the product and the sum rounded apart, as the loop does
            assert dtype != "f32" or torch.equal(got, want), name
        sets.append({"set": name, "shape": list(args[0].shape),
                     "dtype": dtype, "tolerance": tol,
                     "max_abs_err": max(float((y.float() - ry).abs().max()),
                                        float((h.float() - rh).abs().max())),
                     "max_abs_err_rounded": max(
                         float((y.float() - ry.to(y.dtype).float()).abs()
                               .max()),
                         float((h.float() - rh.to(h.dtype).float()).abs()
                               .max()))})
    # h0 threads through: two halves equal one scan (float32, L 100)
    a, b, _ = cases[len(GRIFFIN_PREFILL_L) + 2][1]
    y_full, h_full = ref.rglru_scan_ref(a, b)
    y_a, h_a = kernel.rglru_scan(a[:37], b[:37])
    y_b, h_b = kernel.rglru_scan(a[37:], b[37:], h_a)
    torch.testing.assert_close(torch.cat([y_a, y_b]), y_full, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(h_b, h_full, rtol=1e-5, atol=1e-5)
    sets.append({"set": "two_halves_L100", "tolerance": 1e-5,
                 "max_abs_err": max(
                     float((torch.cat([y_a, y_b]) - y_full).abs().max()),
                     float((h_b - h_full).abs().max()))})
    # time and bound at both full-width prefills, bf16 as the serve runs it
    timed = {}
    for (name, f32_args, _), L in zip(cases, GRIFFIN_PREFILL_L):
        a, b = (t.to(torch.bfloat16) for t in f32_args[:2])
        ms = launch_ms(lambda: kernel.rglru_scan(a, b))
        device_ms, floor_ms = profiled_ms(lambda: kernel.rglru_scan(a, b),
                                          "rglru_scan_kernel")
        plain_ms = launch_ms(lambda: ref.rglru_scan_ref(a, b), launches=1,
                             repeats=3)
        out = kernel.rglru_scan(a, b)
        ry, _ = ref.rglru_scan_ref(a.float(), b.float())
        bf16_state = outside_one_ulp(ref.rglru_scan_ref(a, b)[0], ry)
        assert outside_one_ulp(out[0], ry) == 0.0 < bf16_state, name
        # a and b read once, y and h_final written once (no h0 is read);
        # one multiply and one add per element
        bound, bound_by = bound_ms(nbytes((a, b)) + nbytes(out),
                                   2 * a.numel())
        timed[f"L{L}"] = {"shape": list(a.shape), "dtype": "bf16", "ms": ms,
                          "device_ms": device_ms,
                          "launch_floor_ms": floor_ms, "plain_ms": plain_ms,
                          "bound_ms": bound, "bound_by": bound_by,
                          "bf16_state_loop_outside_one_ulp": bf16_state}
    return {"phase": "rglru_kernel_vs_plain",
            "tolerance": "equal (float32 inputs), rtol=atol=5e-2 (bf16); "
                         "one ulp of the output's dtype from the float32 "
                         "loop rounded to it",
            "block": {"channels": kernel.CHANNELS, "threads": kernel.THREADS,
                      "warps": ["chain", "copy", "store"]},
            "ring": {"stages": kernel.STAGES, "steps_per_stage": kernel.STEPS,
                     "smem_bytes_bf16": kernel.smem_bytes(True, True)},
            "seconds": time.perf_counter() - t0, "sets": sets,
            "timed": timed}


def results_advisor_phase(dev, sim, rows, ServeEngine, model,
                          small_cfg) -> dict:
    """The main path's fig3 rows through the results store and the lock
    advisor, ``ServeEngine(lock="auto")`` on the store, and the store hook
    of ``run_sweep`` (``$REPRO_RESULTS_STORE``) on a small sweep."""
    from repro_torch.serve.admission import gate_kind_for_lock
    from repro_torch.sim import engine_cuda, results
    from repro_torch.sim.workloads import RESULTS_STORE_ENV
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "fig3.jsonl"
        store = results.ResultsStore(path)
        assert store.append_sweep(rows) == len(rows)
        loaded = store.load()
        assert len(loaded) == FIG3_ROWS, len(loaded)
        assert all(r["mode"] == "cuda" and r["schema_version"] == 2
                   for r in loaded)
        rec = results.recommend_lock(store, {"n_threads": 64})
        # the same answer computed from the in-memory rows: the lock (and
        # waiting-array size) of highest median throughput at 64 threads
        at64: dict = {}
        for r in rows:
            if r["n_threads"] == 64:
                at64.setdefault((r["lock"], r["wa_size"]), []).append(
                    r["throughput"])
        medians = {k: float(np.median(v)) for k, v in at64.items()}
        best = max(medians, key=medians.get)
        assert (rec["lock"], rec["wa_size"]) == best, (rec, best)
        assert rec["throughput"] == medians[best]
        assert rec["confidence"] == "exact" and rec["n_threads"] == 64
        params = model.init_params(small_cfg, torch.Generator(
            device=dev).manual_seed(0), device=dev)
        served = ServeEngine(small_cfg, params, lock="auto", store=str(path),
                             workload={"n_threads": 64}, device=dev)
        assert served.gate.kind == gate_kind_for_lock(rec["lock"])
        assert served.lock_choice == {
            "source": "advisor", "gate": served.gate.kind,
            "sim_lock": rec["lock"], "confidence": "exact",
            "throughput": rec["throughput"]}, served.lock_choice
        hook = Path(tmp) / "hook.jsonl"
        os.environ[RESULTS_STORE_ENV] = str(hook)
        try:
            engine_cuda.launches = 0
            small = sim.run_sweep(sim.SweepSpec(
                locks=("ticket", "twa"), threads=(4, 16), seeds=(1, 2),
                horizon=20_000), device=dev)
            hook_launches = engine_cuda.launches
        finally:
            del os.environ[RESULTS_STORE_ENV]
        hooked = results.ResultsStore(hook).load()
        assert hook_launches == 1, hook_launches
        assert hooked == [results.row_from_result(r) for r in small]
        assert len(hooked) == 8 and all(r["mode"] == "cuda" for r in hooked)
    return {"phase": "results_advisor", "rows": len(loaded),
            "recommend_T64": {k: rec[k] for k in (
                "lock", "n_threads", "wa_size", "throughput", "confidence",
                "n_rows")},
            "medians_T64": {f"{lk}/{wa}": v
                            for (lk, wa), v in sorted(medians.items())},
            "serve_gate": served.gate.kind, "lock_choice": served.lock_choice,
            "hook_rows": len(hooked), "hook_launches": hook_launches,
            "seconds": time.perf_counter() - t0}


def fuzz_cuda_phase(root: Path, dev) -> dict:
    """The differential checker's ``cuda`` lane: a fault-enabled batch at a
    seed drawn anew through the lockVM kernel against the batch oracle's C
    path (no differential, both state placements), the corpus replayed
    through the kernel, and the checker's self-test (an injected
    store-visibility bug in the oracle must fail the lane).

    A failing case fails the phase unless it is the reference's known
    ``twa-staged`` stall (``check.reference_stall``: ``recovery`` only, no
    differential, the sequential oracle agreeing); those are counted.  The
    printed seed replays the batch: ``python -m repro_torch.sim.check
    --cases 1024 --seed S --fault-fraction 0.25 --trace-fraction 0.1
    --batch-oracle --modes cuda``."""
    from repro_torch.sim import check, engine_cuda
    seed = secrets.randbelow(1 << 31)
    print(f"fuzz_cuda seed {seed}", flush=True)
    t0 = time.perf_counter()
    batch = check.generate_batch(FUZZ_CASES, seed, fault_fraction=0.25,
                                 trace_fraction=0.1)
    gen_s = time.perf_counter() - t0
    engine_cuda.launches = 0
    t1 = time.perf_counter()
    report = check.fuzz(batch, modes=("cuda",), sched_seed=seed,
                        batch_oracle=True, device=dev)
    fuzz_s = time.perf_counter() - t1
    launches = engine_cuda.launches
    stalls = [i for i, s, msgs in report.failures
              if check.reference_stall(s, msgs)]
    assert len(stalls) == len(report.failures), \
        f"seed {seed}: " + report.summary()
    assert report.oracle_impl == "c", report.oracle_impl
    assert launches == 2, launches
    assert set(report.placements) == {"cuda:smem", "cuda:global"}, \
        report.placements
    n_faults = sum(bool(s.meta.get("faults")) for s in batch)
    n_traces = sum(s.meta.get("workload") == "trace" for s in batch)
    assert n_faults > 0 and n_traces > 0

    paths = sorted((root / "tests" / "corpus").glob("*.npz"))
    assert len(paths) == 14, len(paths)
    engine_cuda.launches = 0
    problems = check.replay_corpus(paths, modes=("cuda",), device=dev)
    replay_launches = engine_cuda.launches
    corpus = {}
    for path, probs in zip(paths, problems):
        expect = sorted(check.load_scenario(path).meta.get(
            "expect_classes", []))
        got = sorted(check.failure_classes(probs))
        assert got == expect, (path.stem, expect, got, probs[:4])
        corpus[path.stem] = got
    assert replay_launches > 0

    engine_cuda.launches = 0
    mutant = check.fuzz(batch, modes=("cuda",), sched_seed=seed,
                        oracle_mutate=("eager_store",), batch_oracle=True,
                        device=dev)
    caught = sum(any(p.startswith("differential[cuda]") for p in msgs)
                 for _, _, msgs in mutant.failures)
    assert caught > 0, "the eager_store self-test was not caught"
    return {"phase": "fuzz_cuda", "seed": seed, "cases": report.n_cases,
            "fault_cases": n_faults, "trace_cases": n_traces,
            "oracle_events": report.total_events,
            "oracle_impl": report.oracle_impl,
            "placements": report.placements,
            "failing": len(report.failures), "reference_stalls": stalls,
            "kernel_launches": launches, "generate_seconds": gen_s,
            "fuzz_seconds": fuzz_s, "cases_per_s": report.n_cases / fuzz_s,
            "corpus_entries": len(corpus), "corpus_classes": corpus,
            "corpus_launches": replay_launches,
            "self_test": {"mutation": "eager_store",
                          "failing": len(mutant.failures),
                          "differential_cuda": caught,
                          "launches": engine_cuda.launches},
            "seconds": time.perf_counter() - t0}


def figures_reduced_sets(sim, horizon: int) -> list:
    """(name, specs) of kernel_vs_plain's ``figures_reduced`` sets: each
    figure's own axes at ``horizon``, one engine call per ``n_locks``.

    fig9's cost-grid corners and ``twa-sem`` permits, fig10's ``twa-rw``
    reader fractions and the fissile handover locks, fig12's preemption
    axis at ``preempt_cost`` 2,048 and fig7's fixed ``outside_work`` share
    one call at 1 lock; fig8's collision counting (waiting arrays of 8 and
    2,048 slots, thresholds 1 and 4) runs at 4 locks; fig2's shared and
    private arrays at 8 locks (shared memory) and 64 (284,672 words a
    cell: global scratch)."""
    spec = sim.SweepSpec
    corners = tuple(dataclasses.replace(sim.DEFAULT_COSTS, C_INV=ci,
                                        C_XFER=cx)
                    for ci in (0, 48) for cx in (30, 180))
    one_lock = [
        spec(locks=("ticket", "twa", "mcs"), threads=32, seeds=1,
             costs=corners, horizon=horizon),
        spec(locks="twa-sem", threads=32, seeds=1, sem_permits=(1, 2, 4, 8),
             horizon=horizon),
        spec(locks="twa-rw", threads=16, seeds=1, cs_work=80, ncs_max=100,
             reader_fraction=(0, 25, 50, 75, 90, 100), horizon=horizon),
        spec(locks=("fissile-twa", "twa", "ticket"), threads=(1, 2, 16, 32),
             seeds=1, horizon=horizon),
        spec(locks=("ticket", "twa", "fissile-twa", "twa-timo"), threads=8,
             seeds=1, cs_work=20, ncs_max=50, horizon=horizon,
             max_events=2 * horizon, preempt_faults=(0, 2, 16),
             preempt_cost=2048, fault_evt_span=horizon // 8),
        spec(locks=("ticket", "twa", "mcs"), threads=(8, 64), seeds=1,
             cs_work=20, outside_work=20, ncs_max=480, horizon=horizon,
             collect_latency=True)]
    fig2 = dict(locks="twa", threads=64, seeds=1, cs_work=50, ncs_max=100,
                private_arrays=(False, True), horizon=horizon)
    return [
        ("figures_reduced/locks_1", one_lock),
        ("figures_reduced/fig8_locks_4", [spec(
            locks="twa", threads=(16, 64), seeds=1, wa_size=(8, 2048),
            long_term_threshold=(1, 4), n_locks=4, count_collisions=True,
            horizon=horizon)]),
        ("figures_reduced/fig2_locks_8", [spec(**fig2, n_locks=8)]),
        ("figures_reduced/fig2_locks_64", [spec(**fig2, n_locks=64)])]


@contextlib.contextmanager
def observe_lockvm(engine, engine_cuda):
    """Record, while active, every ``engine.run_sweep`` call (its resolved
    mode, cells and events) and every kernel launch (its cells, shapes,
    state placement and device ms, by CUDA events around the launch).  The
    launch count itself stays the wrapper's own."""
    record = {"sweeps": [], "launches": []}
    run_cells, run_sweep = engine_cuda.run_cells, engine.run_sweep

    def launch(*args, n_locks, cuda_state="auto", **kw):
        program, init_pc, init_mem = args[0], args[1], args[3]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = run_cells(*args, n_locks=n_locks, cuda_state=cuda_state, **kw)
        end.record()
        torch.cuda.synchronize()
        record["launches"].append({
            "cells": int(program.shape[0]), "threads": int(init_pc.shape[1]),
            "mem_words": int(init_mem.shape[1]), "n_locks": n_locks,
            "state": engine_cuda.state_placement(
                int(init_pc.shape[1]), int(init_mem.shape[1]), n_locks,
                int(program.shape[1]), cuda_state),
            "ms": start.elapsed_time(end)})
        return out

    def sweep(*args, **kw):
        res = run_sweep(*args, **kw)
        record["sweeps"].append({
            "mode": res["mode"], "cells": int(len(res["events"])),
            "max_events": res["pad_stats"]["max_events"],
            "sum_events": res["pad_stats"]["sum_events"]})
        return res

    engine_cuda.run_cells, engine.run_sweep = launch, sweep
    try:
        yield record
    finally:
        engine_cuda.run_cells, engine.run_sweep = run_cells, run_sweep


def csv_rows(text: str) -> dict:
    """``{name: (value, derived)}`` of a suite's ``name,value,derived``
    rows."""
    rows = {}
    for line in text.splitlines():
        name, value, derived = line.split(",", 2)
        rows[name] = (value, derived)
    return rows


def run_observed(bench_run, name: str, dev, engine, engine_cuda, **kw):
    """One suite of ``repro_torch.bench.run`` on the card, its launch count
    set to 0 just before and read just after: ``(what run returns, rows,
    launches, wall seconds, the observed sweeps and launches)``."""
    buf = io.StringIO()
    engine_cuda.launches = 0
    t0 = time.perf_counter()
    with observe_lockvm(engine, engine_cuda) as record, \
            contextlib.redirect_stdout(buf):
        out = bench_run.run_suite(name, device=dev, **kw)
    wall = time.perf_counter() - t0
    launches = engine_cuda.launches
    assert launches > 0, (name, launches)
    assert launches == len(record["launches"]), (name, launches)
    assert record["sweeps"] and all(
        sw["mode"] == "cuda" for sw in record["sweeps"]), (name, record)
    return out, csv_rows(buf.getvalue()), launches, wall, record


def figures_phase(dev, engine, engine_cuda, bench_run) -> list:
    """Each lockVM figure suite at the reference's full spec through the
    kernel: every engine call resolved to ``mode`` ``"cuda"`` and launched
    it, each figure's own assertions holding.  One JSON line a suite."""
    lines = []
    for name, headline in FIGURE_SUITES.items():
        _, rows, launches, wall, record = run_observed(
            bench_run, name, dev, engine, engine_cuda)
        placements = [ln["state"] for ln in record["launches"]]
        if name == "fig2":      # pools 1, 8, 64: the last from global scratch
            assert [ln["n_locks"] for ln in record["launches"]] == \
                [1, 8, 64], record["launches"]
            assert placements == ["smem", "smem", "global"], placements
        if name == "fig12deg":  # the fault sweep, then the faults=None one
            assert rows["fig12deg/zero_fault_bitidentical"][0] == "1"
            assert len(record["launches"]) == 2
        lines.append({
            "phase": "figures", "suite": name, "rows": len(rows),
            "cells": sum(sw["cells"] for sw in record["sweeps"]),
            "launches": launches, "wall_seconds": wall,
            "kernel_seconds": sum(ln["ms"] for ln in record["launches"])
            / 1e3,
            "max_cell_events": max(sw["max_events"]
                                   for sw in record["sweeps"]),
            "sum_events": sum(sw["sum_events"] for sw in record["sweeps"]),
            "launch_shapes": [
                {k: ln[k] for k in ("cells", "threads", "mem_words",
                                    "n_locks", "state", "ms")}
                for ln in record["launches"]],
            "headline": {k: v[0] for k, v in rows.items()
                         if k.startswith(headline)}})
    return lines


def fig13_phase(dev, engine, engine_cuda, bench_run) -> dict:
    """The serve↔lockVM loop end to end on the card (fig13 at the
    reference's full spec): a trace recorded from a continuous-batching
    serve, its lockVM replay through the kernel, tokens/s per admission
    gate, the advisor's answer and the ``auto`` gate that instantiates
    it."""
    from repro_torch.serve.admission import gate_kind_for_lock
    out, rows, launches, wall, record = run_observed(
        bench_run, "fig13", dev, engine, engine_cuda)
    sim_rows = out["sim_rows"]
    assert all(r["mode"] == "cuda" for r in sim_rows)
    assert rows["fig13/trace/requests"][0] == "10"
    assert len(out["trace"]) == 10
    e2e = {k.removeprefix("fig13/e2e/"): float(v[0])
           for k, v in rows.items() if k.startswith("fig13/e2e/")}
    assert e2e and all(math.isfinite(v) and v > 0 for v in e2e.values())
    assert {k.split("/")[0] for k in e2e} == {
        "ticket", "twa", "fissile-twa", "twa-rw"}, e2e
    rec = out["recommend"]
    assert out["auto_gate"] == gate_kind_for_lock(rec["lock"])
    assert rows["fig13/loop/auto_gate"][0] == out["auto_gate"]
    return {"phase": "fig13", "wall_seconds": wall, "launches": launches,
            "kernel_seconds": sum(ln["ms"] for ln in record["launches"])
            / 1e3,
            "trace": {k.removeprefix("fig13/trace/"): v[0]
                      for k, v in rows.items()
                      if k.startswith("fig13/trace/")},
            "sim_rows": len(sim_rows),
            "sim_mode": sorted({r["mode"] for r in sim_rows}),
            "sim_acq_per_cycle": {k.removeprefix("fig13/sim/"): float(v[0])
                                  for k, v in rows.items()
                                  if k.startswith("fig13/sim/")},
            "e2e_tokens_per_s": e2e,
            "recommend": {k: rec[k] for k in ("lock", "confidence",
                                              "n_threads", "throughput")},
            "auto_gate": out["auto_gate"]}


def fuzz_smoke_phase(dev, engine, engine_cuda, fuzz_smoke) -> dict:
    """The fuzz smoke suite on the card at the reference's full size: the
    differential stage through the plain engine and the kernel, the
    mutation self-tests through the kernel, and the host's batch-oracle
    stage.  That stage's speedup gate (the batch path at least
    ``SPEEDUP_GATE``× the sequential cases a second) is a property of the
    host, and the card's host misses it with the reference's own referees
    (``ROADMAP.md`` §3): the phase lets that one assertion through, prints
    it and counts it; any other failure fails the run."""
    from repro_torch.sim.check import generate_batch
    t0 = time.perf_counter()
    buf = io.StringIO()
    scenarios = generate_batch(fuzz_smoke.CASES, fuzz_smoke.SEED)
    engine_cuda.launches = 0
    with observe_lockvm(engine, engine_cuda) as record, \
            contextlib.redirect_stdout(buf):
        report = fuzz_smoke.run_differential(scenarios, device=dev)
        mutated = fuzz_smoke.run_mutation(scenarios, batch_oracle=False,
                                          device=dev)
        mutated_b = fuzz_smoke.run_mutation(scenarios, batch_oracle=True,
                                            device=dev)
    launches = engine_cuda.launches
    assert launches > 0 and launches == len(record["launches"])
    modes = sorted({sw["mode"] for sw in record["sweeps"]})
    assert modes == ["cuda", "torch"], modes
    assert sorted(report.placements) == [
        "cuda:global", "cuda:smem", "torch:1", "torch:16", "torch:7"], \
        report.placements
    with contextlib.redirect_stdout(buf):
        gate = fuzz_smoke.batch_gate(fuzz_smoke.BENCH_CASES)
    caveats = []
    try:
        fuzz_smoke.check_batch_gate(gate)
    except AssertionError as e:
        if not (str(e).startswith("batch oracle ")
                and gate["speedup"] < fuzz_smoke.SPEEDUP_GATE
                and gate["divergences"] == gate["corpus_div"] == 0
                and gate["impl"] == "c"):
            raise
        caveats.append(str(e))
        print(f"fuzz_smoke: reference caveat (host speedup gate): {e}",
              flush=True)
    rows = csv_rows(buf.getvalue())
    return {"phase": "fuzz_smoke", "cases": report.n_cases,
            "modes": modes, "placements": report.placements,
            "failures": len(report.failures),
            "oracle_events": report.total_events,
            "mutation_caught": len(mutated.failures),
            "mutation_caught_batch": len(mutated_b.failures),
            "kernel_launches": launches,
            "engine_calls": len(record["sweeps"]),
            "bench_cases": gate["bench_cases"],
            "seq_cases_per_s": gate["seq_cps"],
            "batch_cases_per_s": gate["batch_cps"],
            "speedup": gate["speedup"],
            "speedup_gate": fuzz_smoke.SPEEDUP_GATE,
            "batch_divergences": gate["divergences"],
            "corpus_divergences": gate["corpus_div"],
            "oracle_impl": gate["impl"], "reference_caveats": caveats,
            "rows": len(rows), "seconds": time.perf_counter() - t0}


def host_locks_phase(dev, engine, engine_cuda, bench_run) -> dict:
    """The host-lock suites of ``repro_torch.bench.run`` on the card's host:
    Table 1 equal to the reference's, the host-thread microbenchmark, and
    the admission suite, whose lockVM sweep must resolve to the kernel and
    whose ticket/TWA ratios must exceed 1, every gate FIFO."""
    out = {"phase": "host_locks", "suites": {}}
    t_phase = time.perf_counter()
    for name in ("table1", "threads"):
        buf = io.StringIO()
        engine_cuda.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            bench_run.run_suite(name, device=dev)
        rows = csv_rows(buf.getvalue())
        assert engine_cuda.launches == 0, (name, engine_cuda.launches)
        out["suites"][name] = {"wall_seconds": time.perf_counter() - t0,
                               "rows": {k: v[0] for k, v in rows.items()}}
    t1 = out["suites"]["table1"]["rows"]
    got = {lk: tuple(int(t1[f"table1/{lk}/{m}"]) for m in (
        "npath_lock", "npath_unlock", "cyclomatic_lock", "cyclomatic_unlock"))
        for lk in TABLE1}
    assert got == TABLE1, got
    assert t1["table1/ordering_ok"] == "1"
    threads = out["suites"]["threads"]["rows"]
    assert len(threads) == 12 and all(int(v) > 0 for v in threads.values()), \
        threads
    _, rows, launches, wall, record = run_observed(
        bench_run, "admission", dev, engine, engine_cuda)
    for key in ADMISSION_RATIOS:
        assert float(rows[key][0]) > 1, (key, rows[key])
    fifo = {k: v[1] for k, v in rows.items()
            if k.endswith("/grant_polls_per_handover")}
    assert len(fifo) == 4 and all(v == "fifo_ok=True" for v in fifo.values()), \
        fifo
    sim = {k: float(v[0]) for k, v in rows.items()
           if k.startswith("admission/sim/")}
    assert len(sim) == 8 and all(v > 0 for v in sim.values()), sim
    out["suites"]["admission"] = {
        "wall_seconds": wall, "launches": launches,
        "modes": sorted({sw["mode"] for sw in record["sweeps"]}),
        "kernel_seconds": sum(ln["ms"] for ln in record["launches"]) / 1e3,
        "cells": sum(sw["cells"] for sw in record["sweeps"]),
        "rows": {k: list(v) for k, v in rows.items()}}
    out["seconds"] = time.perf_counter() - t_phase
    return out


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtype, shape and bytes (a NaN equals itself)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.element_size() == 2:
        a, b = a.view(torch.int16), b.view(torch.int16)
    elif a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


@contextlib.contextmanager
def configured(launch_train, cfg):
    """``launch_train.main`` building ``cfg`` for ``--arch cfg.name`` (a
    config the command line cannot name: another remat, a cut depth)."""
    orig = launch_train.get_config
    launch_train.get_config = lambda name: cfg if name == cfg.name \
        else orig(name)
    try:
        yield
    finally:
        launch_train.get_config = orig


def timed_train(dev, launch_train, argv, cfg=None, kernels=()) -> tuple:
    """One ``launch_train.main(argv)`` run (with ``cfg`` in place of the
    named config, if given), its stdout captured, the launch counts of
    ``kernels`` set to 0 just before it: (result, summary).  The summary
    has the median step time after the first and the peak memory."""
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf), (
            configured(launch_train, cfg) if cfg is not None
            else contextlib.nullcontext()):
        res = launch_train.main(argv)
    wall = time.perf_counter() - t0
    losses = res["losses"]
    assert all(math.isfinite(x) for x in losses), (argv, losses)
    summary = {
        "argv": argv, "losses": losses, "start_step": res["start_step"],
        "wall_seconds": wall, "step_ms": [t * 1e3 for t in
                                          res["step_seconds"]],
        "median_step_ms_after_first":
            float(np.median(res["step_seconds"][1:])) * 1e3,
        "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
        "log": buf.getvalue().splitlines()}
    return res, summary


def train_phase(dev, launch_train, ckpt, tree, ticket_kernel,
                plan_kernel) -> dict:
    """granite-moe-1b-a400m at full width through ``launch.train.main``:
    TRAIN_STEPS steps of TRAIN_BATCH × TRAIN_SEQ tokens with the Prefetcher
    on the default TWA lock and a checkpoint every TRAIN_CKPT_EVERY steps;
    the saved state restored bit for bit; a run resumed from the first
    checkpoint; TRAIN_PALLAS_STEPS steps with ``--use-pallas``, the ticket
    kernel launched in every MoE layer's forward and again in its
    recompute (the config's remat is ``"full"``); and TRAIN_STEPS steps
    with ``remat="none"``.  Every run's losses equal the first run's bit
    for bit, step for step (the MoE backward, ``layers._Dispatch``, sums in
    a fixed order)."""
    from repro_torch.configs import get_config

    cfg = get_config(SERVE_ARCH)
    ln_vocab = math.log(cfg.vocab)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    base = ["--arch", SERVE_ARCH, "--batch", str(TRAIN_BATCH), "--seq",
            str(TRAIN_SEQ), "--device", str(dev)]
    out = {"phase": "train", "arch": SERVE_ARCH, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "lock": os.environ.get("REPRO_LOCK", "twa"),
           "remat": cfg.remat}
    t_phase = time.perf_counter()

    def run(argv, name, run_cfg=None):
        res, summary = timed_train(dev, launch_train, base + argv, run_cfg,
                                   (ticket_kernel, plan_kernel))
        summary["tokens_per_s"] = TRAIN_BATCH * TRAIN_SEQ / summary[
            "median_step_ms_after_first"] * 1e3
        summary["ticket_launches"] = ticket_kernel.launches
        summary["plan_launches"] = plan_kernel.launches
        summary["checkpoints"] = res["checkpoints"]
        out[name] = summary
        assert plan_kernel.launches == 0, (name, plan_kernel.launches)
        return res

    try:
        disk = shutil.disk_usage(tmp)
        out["disk_free_gb_before_save"] = disk.free / 1e9
        print(f"chip_smoke: train checkpoints in {tmp}, "
              f"{disk.free / 1e9:.1f} GB free", file=sys.stderr, flush=True)
        full = run(["--steps", str(TRAIN_STEPS), "--ckpt-dir", tmp,
                    "--ckpt-every", str(TRAIN_CKPT_EVERY)], "plain")
        losses = full["losses"]
        assert len(losses) == TRAIN_STEPS and full["start_step"] == 0
        assert _rel(losses[0], ln_vocab) <= TRAIN_LOSS0_RTOL, \
            (losses[0], ln_vocab)
        assert out["plain"]["ticket_launches"] == 0
        saved = [c["step"] for c in full["checkpoints"]]
        assert saved == list(range(TRAIN_CKPT_EVERY, TRAIN_STEPS + 1,
                                   TRAIN_CKPT_EVERY)), saved
        # the state saved last, read back: bit for bit
        t0 = time.perf_counter()
        back, step = ckpt.restore(tmp, step=TRAIN_STEPS,
                                  like=full["final_state"])
        torch.cuda.synchronize(dev)
        out["restore_seconds"] = time.perf_counter() - t0
        saved_leaves = tree.flatten_with_path(full["final_state"])
        back_leaves = tree.flatten_with_path(back)
        assert step == TRAIN_STEPS and list(back_leaves) == list(saved_leaves)
        bad = [k for k in saved_leaves
               if not _same_bits(back_leaves[k], saved_leaves[k])]
        assert not bad, bad
        out["restored_leaves_bit_identical"] = len(saved_leaves)
        out["state_bytes"] = sum(t.numel() * t.element_size()
                                 for t in saved_leaves.values())
        del back, back_leaves, saved_leaves, full["final_state"]
        gc.collect()
        torch.cuda.empty_cache()

        # resume from the first checkpoint
        for name in os.listdir(tmp):
            if name != f"step_{TRAIN_CKPT_EVERY:08d}":
                shutil.rmtree(os.path.join(tmp, name))
        resumed = run(["--steps", str(TRAIN_STEPS), "--ckpt-dir", tmp,
                       "--resume"], "resumed")
        assert resumed["start_step"] == TRAIN_CKPT_EVERY
        tail = losses[TRAIN_CKPT_EVERY:]
        rel = [_rel(a, b) for a, b in zip(resumed["losses"], tail)]
        out["resumed"]["max_rel_diff"] = max(rel)
        assert resumed["losses"] == tail, (resumed["losses"], tail)
        del resumed
        gc.collect()
        torch.cuda.empty_cache()

        # the ticket kernel in every MoE layer's forward, and again in
        # the backward pass's recompute of each checkpointed period
        pallas = run(["--steps", str(TRAIN_PALLAS_STEPS), "--use-pallas"],
                     "use_pallas")
        passes = 1 if cfg.remat == "none" else 2
        n_moe = cfg.n_layers * TRAIN_PALLAS_STEPS * passes
        assert out["use_pallas"]["ticket_launches"] == n_moe, \
            (out["use_pallas"]["ticket_launches"], n_moe)
        rel = [_rel(a, b) for a, b in zip(pallas["losses"], losses)]
        out["use_pallas"]["max_rel_diff"] = max(rel)
        assert pallas["losses"] == losses[:TRAIN_PALLAS_STEPS], \
            (pallas["losses"], losses)
        del pallas
        gc.collect()
        torch.cuda.empty_cache()

        # every activation kept: the same losses, more memory
        none = run(["--steps", str(TRAIN_STEPS)], "remat_none",
                   dataclasses.replace(cfg, remat="none"))
        rel = [_rel(a, b) for a, b in zip(none["losses"], losses)]
        out["remat_none"]["max_rel_diff"] = max(rel)
        assert none["losses"] == losses, (none["losses"], losses)
        del none
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    return out


def train_devices_phase(dev, model, train_step, optim, tree,
                        ticket_kernel) -> dict:
    """Reduced float32 models (DEVICES_ARCHS: granite-moe, falcon-mamba,
    recurrentgemma, qwen2-vl with three distinct position streams, hubert,
    deepseek, gemma3 and gemma2 past their window of 32, mistral, grok's
    E 4 / top-2) take DEVICES_STEPS steps on the card and on the CPU from
    the same weights and batches, with ``accum_steps`` 1 and 2: the plain
    routing plan and scans under autograd on the card agree with the CPU's
    within DEVICES_LOSS_RTOL.  DEVICES_PALLAS_ARCHS take the same steps on
    the card with ``use_pallas=True``: the ticket kernel launched once a MoE
    layer a pass (the reduced configs' remat is ``"none"``, one pass a
    step; ``"full"`` adds the recompute's), the losses equal to the plain
    dispatch's on the card bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_batch

    out = {"phase": "train_devices", "loss_rtol": DEVICES_LOSS_RTOL,
           "archs": {}}
    t_phase = time.perf_counter()

    def steps(cfg, weights, batches, device, options):
        opt = optim.AdamW()
        params = model.params_from_numpy(cfg, weights, device=device)
        state = train_step.TrainState(params, opt.init(params))
        step = train_step.build_train_step(cfg, opt, options)
        run = []
        for b in batches:
            state, m = step(state, {k: torch.from_numpy(v).to(device)
                                    for k, v in b.items()})
            run.append(float(m["loss"]))
        return run

    for arch in DEVICES_ARCHS:
        cfg = get_config(arch).reduced()
        weights = tree.tree_map(lambda t: t.numpy(), model.init_params(
            cfg, torch.Generator().manual_seed(0), device="cpu"))
        batches = [frontend_batch(synthetic_batch, cfg, s, 4, 64)
                   for s in range(DEVICES_STEPS)]
        line = out["archs"][arch] = {}
        for accum in (1, 2):
            options = train_step.TrainOptions(accum_steps=accum)
            losses = {label: steps(cfg, weights, batches, device, options)
                      for label, device in (("card", dev),
                                            ("cpu", torch.device("cpu")))}
            rel = [_rel(a, b) for a, b in zip(losses["card"],
                                              losses["cpu"])]
            assert all(math.isfinite(x) for x in losses["card"]), losses
            assert max(rel) <= DEVICES_LOSS_RTOL, (arch, accum, losses)
            line[f"accum{accum}"] = {"losses": losses,
                                     "max_rel_diff": max(rel)}
        if arch in DEVICES_PALLAS_ARCHS:
            ticket_kernel.launches = 0
            pallas = steps(cfg, weights, batches, dev,
                           train_step.TrainOptions(use_pallas=True))
            passes = 1 if cfg.remat == "none" else 2
            n_moe = len(cfg.layer_kinds())
            line["use_pallas"] = {"losses": pallas,
                                  "ticket_launches": ticket_kernel.launches,
                                  "moe_layers": n_moe, "passes": passes}
            assert ticket_kernel.launches == n_moe * DEVICES_STEPS * passes, \
                line["use_pallas"]
            assert pallas == line["accum1"]["losses"]["card"], line
    out["dots_policy"] = {arch: dots_policy_probe(
        dev, model, get_config(arch).reduced())
        for arch in (SERVE_ARCH, "deepseek-7b")}
    out["seconds"] = time.perf_counter() - t_phase
    return out


def frontend_batch(synthetic_batch, cfg, step: int, batch: int,
                   seq: int) -> dict:
    """The synthetic batch of ``step``, a vision model's with three distinct
    position streams (``repro_torch.data.mrope_positions``)."""
    from repro_torch.data import mrope_positions

    b = synthetic_batch(cfg, step=step, batch=batch, seq=seq)
    if cfg.frontend == "vision_patches":
        b["positions"] = mrope_positions(step, batch, seq,
                                         int(b["vision_mask"][0].sum()))
    return b


def dots_policy_probe(dev, model, cfg) -> dict:
    """The ``"dots"`` remat policy's decisions on this torch: one reduced
    float32 loss and backward pass with ``remat="dots"`` on the card,
    recording what ``models.model._dots_policy`` decides for each product
    (``mm``/``addmm``/``bmm``) of the forward pass.  It must keep exactly
    the batch-free products (q, k, v, the output projection, and the MLP's
    three or the router: ``torch.einsum`` lowers them to ``mm``/``addmm`` or
    a ``bmm`` of batch extent 1) and recompute the batched ones, and give
    the loss of ``remat="none"``."""
    from repro_torch.data import synthetic_batch

    aten = torch.ops.aten
    products = (aten.mm.default, aten.addmm.default, aten.bmm.default)
    keep = torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
    seen = {}
    orig = model._dots_policy

    def policy(ctx, op, *args, **kw):
        d = orig(ctx, op, *args, **kw)
        if not ctx.is_recompute and op in products:
            what = "save" if d == keep else "recompute"
            key = f"{op}:batch={args[0].shape[0]}:{what}"
            seen[key] = seen.get(key, 0) + 1
        return d

    params = model.init_params(cfg, torch.Generator(device=dev).manual_seed(
        0), device=dev)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             synthetic_batch(cfg, step=0, batch=2, seq=32).items()}
    losses = {}
    model._dots_policy = policy
    try:
        for remat in ("none", "dots"):
            run_cfg = dataclasses.replace(cfg, remat=remat)
            leaves = [p.requires_grad_(True) for p in _leaves(params)]
            loss, _ = model.loss_fn(params, batch, run_cfg)
            torch.autograd.grad(loss, leaves)
            losses[remat] = loss.item()
    finally:
        model._dots_policy = orig
    kept = sum(n for k, n in seen.items() if k.endswith(":save"))
    expected = cfg.n_layers * (4 + (1 if cfg.n_experts else 3))
    assert kept == expected, (seen, expected)
    for k in seen:
        batch_free = k.startswith(("aten.mm.", "aten.addmm.")) or \
            ":batch=1:" in k
        assert k.endswith(":save") == batch_free, seen
    assert losses["dots"] == losses["none"], losses
    return {"decisions": seen, "kept": kept, "losses": losses}


def train_hubert_phase(dev, launch_train, cfg, batch: int = AUDIO_BATCH,
                       seq: int = AUDIO_SEQ, steps: int = AUDIO_STEPS) -> dict:
    """hubert-xlarge (``cfg``) through ``launch.train.main``: ``steps`` steps
    of ``batch`` × ``seq`` synthetic frames (seed 0) with the Prefetcher on
    the default TWA lock, with the config's remat and then ``"none"``:
    losses finite, step 0's within 10% of ln(vocab) and equal under both
    (the forward is the same), the later ones within TRAIN_LOSS_RTOL."""
    out = {"phase": "train_hubert", "arch": cfg.name,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "params": cfg.param_count(), "batch": batch, "seq": seq,
           "dtype": cfg.dtype, "loss_rtol": TRAIN_LOSS_RTOL}
    t0 = time.perf_counter()
    for remat in dict.fromkeys((cfg.remat, "none")):
        run_cfg = dataclasses.replace(cfg, remat=remat)
        _, summary = timed_train(dev, launch_train, [
            "--arch", cfg.name, "--batch", str(batch), "--seq", str(seq),
            "--steps", str(steps), "--device", str(dev)], run_cfg)
        summary["frames_per_s"] = batch * seq / summary[
            "median_step_ms_after_first"] * 1e3
        out[f"remat_{remat}"] = summary
        loss0 = summary["losses"][0]
        assert _rel(loss0, math.log(cfg.vocab)) <= TRAIN_LOSS0_RTOL, \
            (remat, loss0)
        gc.collect()
        torch.cuda.empty_cache()
    first, none = out[f"remat_{cfg.remat}"]["losses"], out["remat_none"][
        "losses"]
    assert none[0] == first[0], (none[0], first[0])
    out["max_rel_diff"] = max(_rel(a, b) for a, b in zip(none, first))
    assert out["max_rel_diff"] <= TRAIN_LOSS_RTOL, out["max_rel_diff"]
    out["seconds"] = time.perf_counter() - t0
    return out


def reckoned_start(cfg, self_logits=None) -> float:
    """The cross entropy that random weights start from.  Each head logit
    is ĥ·w_v, ĥ the final norm's output (RMS 1 over d) and w_v's entries
    normal × 0.02, so the vocab's logits have std σ = 0.02·sqrt(d), capped
    where the config softcaps them, and V of them cost
    ln(V·E[exp(cap(σz))]), z standard normal: ln(V) + σ²/2 uncapped,
    12.36 at deepseek's d 4,096, 11.90 at falcon-mamba's, 12.85 at
    mistral's 12,288 and 13.57 at qwen2-vl's 8,192, where ln(V) is 10.40
    and 11.93 (at granite's or hubert's width within 5% of ln(V)).

    A tied head (gemma3, gemma2, recurrentgemma) adds each position's own
    token: its row is the embedding that entered the stack scaled by
    sqrt(d), so its logit s_t = ĥ_t·e_tok is a spike of up to 0.02·d (92 at
    gemma2's d 4,608, capped to 29.8) where the layers leave the embedding
    dominant, and the start is the mean over positions of
    ln(exp(s_t) + (V-1)·E[exp(cap(σz))]).  How far the random stack
    dilutes the spike has no closed form: a gated MLP of width ff adds
    ff·0.02²·E[act(az)²]·a² to the residual's variance (a² = 0.02²·d:
    about 23 a layer at gemma2's 36,864 against the embedding's 1.84, 0.2
    at gemma3's 6,912 against 0.46), and attention's component common to
    all positions grows with depth (0.003 to 0.12 a layer over 24 layers
    at d 1,024, a float32 probe at granite's width).  So ``self_logits``
    (the s_t, from a forward pass of the same seeded weights and batch)
    are read and the rest reckoned: the check is that the other V-1
    logits, the softmax and the label's pick behave as random weights
    predict."""
    z, w = np.polynomial.hermite_e.hermegauss(80)
    c, sigma = cfg.logit_softcap, 0.02 * math.sqrt(cfg.d_model)
    capped = c * np.tanh(sigma * z / c) if c else sigma * z
    bulk = float((w * np.exp(capped)).sum() / w.sum())
    if self_logits is None:
        return math.log(cfg.vocab * bulk)
    s = np.asarray(self_logits, np.float64)
    return float(np.mean(np.logaddexp(s, math.log((cfg.vocab - 1) * bulk))))


def measured_self_logits(model, cfg, batch: dict, dev) -> np.ndarray:
    """Each position's logit at its own input token, from a forward pass
    (no autograd) of the weights ``launch.train`` makes for seed 0 on
    ``dev`` over ``batch`` (numpy), in the training forward's modes."""
    params = model.init_params(cfg, torch.Generator(device=dev).manual_seed(
        0), device=dev)
    tokens = torch.from_numpy(batch["tokens"]).to(dev)
    with torch.no_grad():
        logits, _, _ = model.forward(params, {"tokens": tokens}, cfg,
                                     dispatch="torch", scan="torch")
        out = logits.gather(-1, tokens.long()[..., None])[..., 0]
        out = out.double().cpu().numpy()
    del params, logits
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _score_elements(kind: str, cfg, batch: int, seq: int,
                    q_chunk: int) -> int:
    """The elements of one attention layer's float32 scores over a
    training step (all of a long sequence's query chunks of ``q_chunk``:
    each is kept for the backward)."""
    H = cfg.n_heads
    if kind == "local" and seq > cfg.window:
        w = cfg.window
        return batch * H * -(-seq // w) * w * 2 * w
    if kind == "global" and seq > 2 * q_chunk:
        return batch * H * -(-seq // q_chunk) * q_chunk * seq
    return batch * H * seq * seq


def reckon_train_bytes(model, cfg, batch: int, seq: int,
                       accum: int = 1, scan_chunk: int = 0) -> dict:
    """A training step's peak device memory, reckoned from the shapes
    before any run (bytes).  The state: the weights and their gradients in
    their dtypes, the float32 moments.  The update's peak: the old and
    new weights and moments beside the gradients (AdamW is functional:
    about 22 bytes a bf16 parameter) and four float32 temporaries of a
    slice of ``optim.adamw.UPDATE_CHUNK`` elements.  The backward's peak: the weights, moments and gradients,
    the float32 sum of the microbatches' gradients under accumulation,
    each period's checkpointed input, and the larger of the loss's and one
    recomputed period's activations.  The loss keeps one float32 (B, S, V)
    logits tensor (softcapped or not: ``layers._Softcap`` keeps its output,
    which the logsumexp keeps too) and makes three more in its backward; a
    period keeps, per attention layer, its float32 softmax and bf16
    probabilities (softcapped or not: ``layers._CappedSoftmax``), about
    twelve bf16 (B, S, d) and (B, S, H·hd) tensors, four (B, S, ff) of its
    MLP, the Mamba loop's bf16 (B, d_inner, N) state and factor a token,
    and the backward of its largest layer three float32 copies of that
    layer's scores.  Under ``$REPRO_SCAN_CHUNK`` (``scan_chunk``) a Mamba
    layer's chunked scan keeps four float32 (B, L, d_inner, N) tensors
    instead (each step's decay and state, the running decay and the carry
    factors E) and holds three more while it runs (its inputs z and b and
    the factors before they are stacked); an RG-LRU layer's keeps four
    float32 (B, L, lru_width) tensors (the decays, states, running products
    and their stack)."""
    from repro_torch.optim.adamw import UPDATE_CHUNK

    leaves = _leaves(model.param_shapes(cfg))
    dtypes = _leaves(model.param_dtypes(cfg))
    n = [math.prod(s) for s in leaves]
    P = sum(n)
    weights = sum(k * torch.empty((), dtype=dt).element_size()
                  for k, dt in zip(n, dtypes))
    moments = 8 * P
    update = 3 * weights + 2 * moments + 16 * min(max(n), UPDATE_CHUNK)
    T = batch * seq // accum                   # tokens a microbatch
    mb = batch // accum
    d, hd = cfg.d_model, cfg.n_heads * cfg.head_dim
    loss = (1 + 3) * T * cfg.padded_vocab * 4
    kept, transient = 0, 0
    for kind in cfg.layer_pattern:
        if kind in ("global", "local"):
            sc = _score_elements(kind, cfg, mb, seq, model.L.Q_CHUNK)
            kept += sc * 6 + 12 * T * max(d, hd) * 2
            transient = max(transient, 3 * 4 * sc)
        elif kind == "mamba":
            bldn = T * cfg.d_inner * cfg.ssm_state
            kept += (4 * bldn * 4 if scan_chunk else 2 * bldn * 2) \
                + 12 * T * cfg.d_inner * 2
            if scan_chunk:
                transient = max(transient, 3 * bldn * 4)
        else:
            kept += 12 * T * cfg.lru_width * 2 \
                + (4 * T * cfg.lru_width * 4 if scan_chunk else 0)
        if kind != "mamba":
            kept += 4 * T * cfg.d_ff * 2
    backward = 2 * weights + moments + (4 * P if accum > 1 else 0) \
        + cfg.n_periods * T * d * 2 + max(loss, kept + transient)
    return {"params": P, "state": 2 * weights + moments, "update": update,
            "backward": backward, "loss_activations": loss,
            "period_activations": kept + transient,
            "peak": max(update, backward)}


def train_arch_phase(dev, launch_train, model, cfg, batch: int, seq: int,
                     n_layers_config: int, accum: bool = False) -> dict:
    """``cfg`` (full width, depth as given) through ``launch.train.main``:
    TRAIN_ARCHS_STEPS steps of ``batch`` × ``seq`` synthetic tokens (seed 0,
    the Prefetcher on the default TWA lock), losses finite and step 0's
    within TRAIN_LOSS0_RTOL of :func:`reckoned_start`; the peak beside
    :func:`reckon_train_bytes`; then TRAIN_ARCHS_REPEAT steps of the same
    argv, whose losses equal the first run's bit for bit (every backward
    sums in a fixed order); with ``accum`` the same steps with
    ``--accum 2``, step 0's loss within TRAIN_LOSS_RTOL of the first
    run's (only the microbatches' shape and the order of the float32
    gradient sum differ)."""
    from repro_torch.data import synthetic_batch

    t0 = time.perf_counter()
    reckoned = reckon_train_bytes(model, cfg, batch, seq)
    out = {"phase": "train_archs", "arch": cfg.name,
           "n_layers": cfg.n_layers, "n_layers_config": n_layers_config,
           "d_model": cfg.d_model, "params": cfg.param_count(),
           "batch": batch, "seq": seq, "dtype": cfg.dtype,
           "remat": cfg.remat, "window": cfg.window if "local" in
           cfg.layer_kinds() else None,
           "reckoned_gb": {k: v / 1e9 for k, v in reckoned.items()
                           if k != "params"}}
    self_logits = None
    if cfg.tie_embeddings:
        self_logits = measured_self_logits(
            model, cfg, synthetic_batch(cfg, step=0, batch=batch, seq=seq),
            dev)
        out["self_logit_mean"] = float(self_logits.mean())
    start = reckoned_start(cfg, self_logits)
    out["reckoned_start"] = start
    out["ln_vocab"] = math.log(cfg.vocab)
    argv = ["--arch", cfg.name, "--batch", str(batch), "--seq", str(seq),
            "--device", str(dev)]

    def run(extra, name):
        _, summary = timed_train(dev, launch_train, argv + extra, cfg)
        summary.pop("log")
        summary["tokens_per_s"] = batch * seq / summary[
            "median_step_ms_after_first"] * 1e3
        out[name] = summary
        gc.collect()
        torch.cuda.empty_cache()
        return summary["losses"]

    losses = run(["--steps", str(TRAIN_ARCHS_STEPS)], "run")
    assert len(losses) == TRAIN_ARCHS_STEPS, losses
    assert _rel(losses[0], start) <= TRAIN_LOSS0_RTOL, (losses[0], start)
    out["peak_gb"] = out["run"]["peak_memory_gb"]
    again = run(["--steps", str(TRAIN_ARCHS_REPEAT)], "repeat")
    assert again == losses[:TRAIN_ARCHS_REPEAT], (again, losses)
    if accum:
        acc = run(["--steps", str(TRAIN_ARCHS_STEPS), "--accum", "2"],
                  "accum2")
        out["accum2"]["loss_beside_accum1"] = list(zip(acc, losses))
        out["accum2"]["rel_diff"] = [_rel(a, b) for a, b in
                                     zip(acc, losses)]
        assert _rel(acc[0], losses[0]) <= TRAIN_LOSS_RTOL, (acc, losses)
    out["seconds"] = time.perf_counter() - t0
    return out


def grok_train_reckoning(model, cfg) -> dict:
    """Why grok-1-314b takes no training step at full width on one card:
    one layer at its width (6,144; E 8 experts of d_ff 32,768) already
    holds more state, weights and gradients in bf16 and float32 moments,
    than the card has memory (its E 8 / top-2 backward is held at reduced
    size by the train_devices phase)."""
    one = dataclasses.replace(cfg, n_layers=1)
    reckoned = reckon_train_bytes(model, one, 1, 128)
    card = torch.cuda.get_device_properties(0).total_memory
    out = {"phase": "train_archs", "arch": cfg.name, "trained": False,
           "n_layers_config": cfg.n_layers, "params_one_layer":
           one.param_count(), "experts_params_one_layer":
           3 * cfg.n_experts * cfg.d_model * cfg.d_ff,
           "state_gb_one_layer": reckoned["state"] / 1e9,
           "update_gb_one_layer": reckoned["update"] / 1e9,
           "card_gb": card / 1e9}
    assert reckoned["update"] > card, out
    return out


# A child of the entry_points and train_chunked phases: the launcher's
# main() run with sys.argv as ``python -m repro_torch.launch.<launcher>``
# sets it (no allocator setting or CUDA call before it), once a command
# line of ``spec["runs"]``, and one JSON line last on stdout: each run's
# losses or tokens, step seconds, peak memory, the allocator's segments and
# how many are expandable, the kernels' launches and (``count_scans``) the
# calls of the plain scans.  ``layers`` cuts the config's depth as
# ``configured`` does; ``record_oom`` reports a run out of memory instead
# of failing.  It imports nothing of this script.
CHILD_PROGRAM = r'''
import dataclasses, gc, json, os, sys, time
spec = json.loads(sys.argv.pop(1))
import torch
from repro_torch.configs import get_config
from repro_torch.kernels.ticket_dispatch import kernel as ticket, plan
from repro_torch.launch import serve, train
launcher = {"train": train, "serve": serve}[spec["launcher"]]
if spec.get("layers"):
    cut = dataclasses.replace(get_config(spec["arch"]),
                              n_layers=spec["layers"])
    launcher.get_config = lambda name: cut if name == cut.name \
        else get_config(name)
scans = {}
if spec.get("count_scans"):
    from repro_torch.kernels.mamba_scan import ops as mamba_ops
    from repro_torch.kernels.rglru import ops as rglru_ops
    for ops, name in ((mamba_ops, "selective_scan_chunked"),
                      (mamba_ops, "selective_scan_ref"),
                      (rglru_ops, "rglru_scan_chunked"),
                      (rglru_ops, "rglru_scan_ref")):
        def counted(*args, _real=getattr(ops, name), _name=name, **kw):
            scans[_name] = scans.get(_name, 0) + 1
            return _real(*args, **kw)
        setattr(ops, name, counted)
runs = []
for argv in spec["runs"]:
    sys.argv = ["python -m repro_torch.launch." + spec["launcher"], *argv]
    if torch.cuda.is_initialized():
        torch.cuda.reset_peak_memory_stats()
    ticket.launches = plan.launches = 0
    scans.clear()
    run = {"argv": argv}
    t0 = time.perf_counter()
    try:
        res = launcher.main()
    except torch.OutOfMemoryError as e:
        if not spec.get("record_oom"):
            raise
        run["out_of_memory"] = str(e)[:600]
        res = None
    run["seconds"] = time.perf_counter() - t0
    if res and spec["launcher"] == "train":
        run.update(losses=res["losses"], step_seconds=res["step_seconds"])
    elif res:
        run.update(tokens_out=[r.tokens_out for r in res["requests"]],
                   engine_steps=res["stats"]["steps"])
    if torch.cuda.is_initialized():
        segments = torch.cuda.memory_snapshot()
        run.update(peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                   segments=len(segments),
                   expandable_segments=sum(bool(s.get("is_expandable"))
                                           for s in segments))
    run.update(ticket_launches=ticket.launches, plan_launches=plan.launches,
               scans=dict(scans))
    runs.append(run)
    del res
    gc.collect()
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()
print(json.dumps({"child": {
    "runs": runs, "torch": torch.__version__,
    "alloc_conf": os.environ.get("PYTORCH_CUDA_ALLOC_CONF")}}))
'''


def child_env(extra: dict | None = None) -> dict:
    """A clean environment for a child: this process's without the
    allocator's settings (this script sets one when it is imported) and
    without the repo's own ``REPRO_*`` variables, with PYTHONPATH=src;
    then ``extra``."""
    from repro_torch.device import ALLOC_CONF_VARS

    env = {k: v for k, v in os.environ.items()
           if k not in ALLOC_CONF_VARS and not k.startswith("REPRO_")}
    env["PYTHONPATH"] = "src"
    env.update(extra or {})
    return env


def run_child(root: Path, spec: dict, extra_env: dict | None = None,
              timeout: float = CHILD_TIMEOUT_S) -> dict:
    """``CHILD_PROGRAM`` on ``spec`` in a child process started from the
    repo's root in :func:`child_env`; its JSON result with the wall seconds
    of the process.  A child that fails raises, with its stderr's tail."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", CHILD_PROGRAM, json.dumps(spec)], cwd=root,
        env=child_env(extra_env), capture_output=True, text=True,
        timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"child {spec} exited {proc.returncode}:\n"
                           f"{proc.stderr[-3000:]}")
    lines = proc.stdout.strip().splitlines()
    out = json.loads(lines[-1])["child"]
    out.update(process_seconds=time.perf_counter() - t0,
               env=extra_env or {}, log_tail=lines[-4:-1])
    return out


def _release(dev) -> float:
    """Give this process's cached device memory back before a child runs:
    the GB it still reserves."""
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved(dev) / 1e9


def _train_summary(run: dict, tokens: int) -> dict:
    """A child's train run with the median step after the first and
    tokens/s, as ``timed_train`` summarises one in this process."""
    ms = float(np.median(run["step_seconds"][1:])) * 1e3
    return {**run, "median_step_ms_after_first": ms,
            "tokens_per_s": tokens / ms * 1e3}


def entry_points_phase(root: Path, dev, launch_serve, plan_kernel,
                       train: dict, gemma2: dict) -> dict:
    """The launchers as a user starts them, each in a child process of a
    clean environment (:func:`child_env`: no allocator setting), held to
    this process's runs of the same argv.  granite-moe-1b-a400m through
    ``launch.train``'s command line, ENTRY_TRAIN_STEPS steps plain and with
    ``--use-pallas``: losses bit-identical to the train phase's runs, the
    ticket kernel launched as often.  gemma2-27b at TRAIN_ARCHS' cut
    (``gemma2``: its train_archs line): its losses bit-identical to that
    run's and its peak within ENTRY_PEAK_RTOL of it, which it reaches only
    with the launchers' default, expandable segments (PERF.md §6);
    then the control, the same child with fixed segments set by the caller:
    the launcher leaves that value alone, and whether the run fits is
    recorded, not held.  granite's serve through ``launch.serve``'s command
    line: every request's tokens equal those of the same argv through
    ``launch.serve.main`` here, where the routing-plan kernel's launches
    are counted (and in the child, as many)."""
    t_phase = time.perf_counter()
    out = {"phase": "entry_points", "python": sys.executable,
           "pythonpath": "src", "removed": "PYTORCH_ALLOC_CONF, "
           "PYTORCH_CUDA_ALLOC_CONF, REPRO_*"}
    base = ["--arch", SERVE_ARCH, "--batch", str(TRAIN_BATCH), "--seq",
            str(TRAIN_SEQ), "--steps", str(ENTRY_TRAIN_STEPS)]
    assert TRAIN_PALLAS_STEPS == ENTRY_TRAIN_STEPS <= TRAIN_STEPS
    for name, extra, inproc in (("train", [], "plain"),
                                ("train_use_pallas", ["--use-pallas"],
                                 "use_pallas")):
        reserved = _release(dev)
        child = run_child(root, {"launcher": "train", "runs": [base + extra]})
        run = _train_summary(child.pop("runs")[0], TRAIN_BATCH * TRAIN_SEQ)
        want = train[inproc]["losses"][:ENTRY_TRAIN_STEPS]
        out[name] = {**child, "run": run,
                     "parent_reserved_gb": reserved,
                     "in_process_losses": want}
        assert run["losses"] == want, (name, run["losses"], want)
        assert run["ticket_launches"] == \
            train[inproc]["ticket_launches"], (name, run)
        assert run["plan_launches"] == 0, (name, run)

    layers, batch, seq = TRAIN_ARCHS[ENTRY_GEMMA2]
    spec = {"launcher": "train", "arch": ENTRY_GEMMA2, "layers": layers,
            "runs": [["--arch", ENTRY_GEMMA2, "--batch", str(batch),
                      "--seq", str(seq), "--steps",
                      str(TRAIN_ARCHS_STEPS)]]}
    want = gemma2["run"]
    reserved = _release(dev)
    child = run_child(root, spec)
    run = _train_summary(child.pop("runs")[0], batch * seq)
    out["gemma2"] = {**child, "run": run, "n_layers": layers,
                     "parent_reserved_gb": reserved,
                     "in_process_losses": want["losses"],
                     "in_process_peak_gb": want["peak_memory_gb"],
                     "peak_rel_diff": _rel(run["peak_memory_gb"],
                                           want["peak_memory_gb"])}
    assert run["losses"] == want["losses"], (run["losses"], want["losses"])
    assert out["gemma2"]["peak_rel_diff"] <= ENTRY_PEAK_RTOL, out["gemma2"]
    fixed = "expandable_segments:False"
    _release(dev)
    child = run_child(root, {**spec, "record_oom": True},
                      {"PYTORCH_CUDA_ALLOC_CONF": fixed})
    run = child.pop("runs")[0]
    out["gemma2_fixed_segments"] = {
        **child, "run": run,
        "out_of_memory": "out_of_memory" in run,
        "losses_equal": run.get("losses") == want["losses"]}
    assert child["alloc_conf"] == fixed, child["alloc_conf"]

    _release(dev)
    plan_kernel.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = launch_serve.main(list(ENTRY_SERVE_ARGV))
    tokens = [r.tokens_out for r in res["requests"]]
    out["serve"] = {"argv": ENTRY_SERVE_ARGV,
                    "in_process_seconds": time.perf_counter() - t0,
                    "in_process_plan_launches": plan_kernel.launches,
                    "in_process_tokens_out": tokens}
    del res
    reserved = _release(dev)
    child = run_child(root, {"launcher": "serve",
                             "runs": [ENTRY_SERVE_ARGV]})
    run = child.pop("runs")[0]
    out["serve"].update({**child, "run": run,
                         "parent_reserved_gb": reserved})
    assert plan_kernel.launches > 0
    assert run["tokens_out"] == tokens, (run["tokens_out"], tokens)
    assert run["plan_launches"] == plan_kernel.launches, run
    out["seconds"] = time.perf_counter() - t_phase
    return out


def train_chunked_phase(root: Path, dev, model, cfg, batch: int, seq: int,
                        chunk: int, sequential: dict) -> dict:
    """``cfg`` (falcon-mamba-7b or recurrentgemma-9b at TRAIN_ARCHS' cut)
    through ``launch.train``'s command line in a child started as the
    entry_points phase's are, with ``$REPRO_SCAN_CHUNK`` = ``chunk`` in its
    environment: TRAIN_ARCHS_STEPS steps, then TRAIN_ARCHS_REPEAT steps of
    the same argv in the same child, losses bit-identical.  Every scan
    takes the chunked form (counted in the child: one call a recurrent
    layer and pass, none of the sequential loop); losses finite, step 0
    within TRAIN_LOSS0_RTOL of the reckoned start and within
    TRAIN_LOSS_RTOL of the sequential run's (``sequential``: the
    train_archs line of the same cut, this call); ms a step after the
    first, tokens/s, the peak beside ``reckon_train_bytes`` of the chunked
    scans."""
    t0 = time.perf_counter()
    kinds = cfg.layer_kinds()
    scan = "selective_scan" if "mamba" in kinds else "rglru_scan"
    recurrent = sum(k in ("mamba", "rglru") for k in kinds)
    passes = 1 if cfg.remat == "none" else 2
    reckoned = reckon_train_bytes(model, cfg, batch, seq, scan_chunk=chunk)
    argv = ["--arch", cfg.name, "--batch", str(batch), "--seq", str(seq),
            "--steps"]
    spec = {"launcher": "train", "arch": cfg.name, "layers": cfg.n_layers,
            "count_scans": True,
            "runs": [argv + [str(TRAIN_ARCHS_STEPS)],
                     argv + [str(TRAIN_ARCHS_REPEAT)]]}
    reserved = _release(dev)
    child = run_child(root, spec, {"REPRO_SCAN_CHUNK": str(chunk)})
    run, again = (_train_summary(r, batch * seq) for r in child.pop("runs"))
    losses = run["losses"]
    start = sequential["reckoned_start"]
    seq0 = sequential["run"]["losses"][0]
    out = {"phase": "train_chunked", "arch": cfg.name,
           "n_layers": cfg.n_layers, "batch": batch, "seq": seq,
           "scan_chunk": chunk, "remat": cfg.remat,
           "reckoned_gb": {k: v / 1e9 for k, v in reckoned.items()
                           if k != "params"},
           "reckoned_start": start, "sequential_step0": seq0,
           "sequential_ms": sequential["run"]["median_step_ms_after_first"],
           "sequential_peak_gb": sequential["peak_gb"],
           "parent_reserved_gb": reserved, "run": run, "repeat": again,
           "peak_gb": run["peak_memory_gb"],
           "step0_rel_to_start": _rel(losses[0], start),
           "step0_rel_to_sequential": _rel(losses[0], seq0),
           **child}
    assert all(math.isfinite(x) for x in losses), losses
    want = recurrent * passes * TRAIN_ARCHS_STEPS
    assert run["scans"] == {f"{scan}_chunked": want}, (run["scans"], want)
    assert out["step0_rel_to_start"] <= TRAIN_LOSS0_RTOL, out
    assert out["step0_rel_to_sequential"] <= TRAIN_LOSS_RTOL, out
    assert again["losses"] == losses[:TRAIN_ARCHS_REPEAT], (again, losses)
    out["seconds"] = time.perf_counter() - t0
    return out


def frontends_phase(dev, model, synthetic_batch, cfg, batch: int = VLM_BATCH,
                    seq: int = VLM_SEQ) -> dict:
    """qwen2-vl (``cfg``, random weights from a seeded generator): a batch
    whose first quarter is the synthetic vision span with three distinct
    M-RoPE streams; ``loss_fn`` and its backward pass twice (the loss
    within 10% of :func:`reckoned_start`, every gradient finite, the
    layers' non-zero);
    then, under ``torch.no_grad``, a prefill of all ``seq`` positions
    against a prefill of the first ``seq`` − 1 and one ``decode_step`` at
    position ``seq`` − 1 (which carries ``seq`` − 1 in all three streams,
    as decode broadcasts one position), into a cache of ``seq``: the same
    argmax wherever the top-2 margin exceeds twice the largest logit
    difference."""
    out = {"phase": "frontends", "arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "params": cfg.param_count(),
           "mrope_sections": list(cfg.mrope_sections), "remat": cfg.remat,
           "dtype": cfg.dtype, "batch": batch, "seq": seq}
    t_phase = time.perf_counter()
    params = model.init_params(cfg, torch.Generator(device=dev).manual_seed(
        0), device=dev)
    torch.cuda.synchronize(dev)
    out["init_params_s"] = time.perf_counter() - t_phase
    b = frontend_batch(synthetic_batch, cfg, 0, batch, seq)
    b["positions"][:, :, -1] = seq - 1
    tb = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
    out["vision_positions"] = int(b["vision_mask"][0].sum())
    leaves = list(_leaves(params))
    layer_leaves = [v for slot in params["stack"].values()
                    for v in slot.values()]
    for p in leaves:
        p.requires_grad_(True)
    torch.cuda.reset_peak_memory_stats(dev)
    passes = []
    for _ in range(2):
        t0 = time.perf_counter()
        loss, _ = model.loss_fn(params, tb, cfg)
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize(dev)
        t2 = time.perf_counter()
        by_leaf = {id(p): g for p, g in zip(leaves, grads)}
        passes.append({
            "loss": loss.item(), "forward_ms": (t1 - t0) * 1e3,
            "backward_ms": (t2 - t1) * 1e3,
            "grads_finite": all(bool(torch.isfinite(g).all())
                                for g in grads),
            "layer_grads_nonzero": all(bool(by_leaf[id(p)].any())
                                       for p in layer_leaves)})
        del loss, grads, by_leaf
    out["peak_memory_gb_train"] = torch.cuda.max_memory_allocated(dev) / 1e9
    for p in leaves:
        p.requires_grad_(False)
    out["passes"] = passes
    out["expected_loss"] = reckoned_start(cfg)
    assert passes[0]["loss"] == passes[1]["loss"], passes
    assert math.isfinite(passes[0]["loss"]) and _rel(
        passes[0]["loss"], out["expected_loss"]) <= TRAIN_LOSS0_RTOL, passes
    assert all(p["grads_finite"] and p["layer_grads_nonzero"]
               for p in passes), passes

    torch.cuda.reset_peak_memory_stats(dev)
    head = {k: (v[..., :seq - 1] if k == "positions" else v[:, :seq - 1])
            for k, v in tb.items()}
    with torch.no_grad():
        full, _ = model.prefill(params, tb, cfg)
        _, cache = model.prefill(params, head, cfg)
        grown = model.init_cache(cfg, batch, seq, device=dev)
        for j, slot in cache["stack"].items():
            for k, v in slot.items():
                grown["stack"][j][k][:, :, :seq - 1] = v
        del cache
        decode_ms = []
        for _ in range(2):
            t0 = time.perf_counter()
            logits, _ = model.decode_step(params, grown,
                                          tb["tokens"][:, seq - 1:],
                                          seq - 1, cfg)
            torch.cuda.synchronize(dev)
            decode_ms.append((time.perf_counter() - t0) * 1e3)
    out["decode_ms"] = decode_ms
    out["peak_memory_gb_serve"] = torch.cuda.max_memory_allocated(dev) / 1e9
    V = cfg.vocab
    delta = float((logits - full)[:, :V].abs().max())
    decided = agree = 0
    for a, row in zip(logits, full):
        top2 = torch.topk(row[:V], 2).values
        same = int(a[:V].argmax()) == int(row[:V].argmax())
        if float(top2[0] - top2[1]) > 2 * delta:
            decided += 1
            assert same, (delta, top2.tolist())
        agree += same
    out["decode_vs_prefill"] = {"max_abs_logit_diff": delta,
                                "argmax_decided_by_margin": decided,
                                "argmax_equal": agree, "rows": batch}
    out["seconds"] = time.perf_counter() - t_phase
    del params, grown, full, logits
    gc.collect()
    torch.cuda.empty_cache()
    return out


def examples_phase(dev, engine_cuda, names=EXAMPLES, argv=()) -> dict:
    """Each ``repro_torch.examples`` script through its ``main`` on the card
    at its own spec (plus ``argv``), stdout captured, the lockVM kernel's
    launch count set to 0 just before each: the scripts' own checks hold
    (quickstart's counter, the FIFO admission order, train_moe's learning,
    elastic_restart's drift under 5e-3, every host lock acquiring 2,000
    times)."""
    import importlib

    out = {"phase": "examples", "scripts": {}}
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_examples_")
    extra = {"serve_continuous_batching": ["--record",
                                           os.path.join(tmp, "trace.npz")],
             "train_moe": ["--ckpt-dir", os.path.join(tmp, "train_moe")]}
    try:
        for name in names:
            mod = importlib.import_module(f"repro_torch.examples.{name}")
            engine_cuda.launches = 0
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                res = mod.main([*extra.get(name, []), *argv,
                                "--device", str(dev)])
            torch.cuda.synchronize(dev)
            line = {"seconds": time.perf_counter() - t0,
                    "lockvm_launches": engine_cuda.launches,
                    "stdout_tail": buf.getvalue().splitlines()[-6:]}
            if name == "quickstart":
                assert res["counter"] == 4000
                line["mutexbench"] = {str(t): r for t, r in
                                      res["mutexbench"].items()}
                line["losses"] = res["losses"]
            elif name == "lock_playground":
                assert set(res["host_threads"].values()) == {2000}, res
                line["cells"] = len(res["sweep"])
                line["throughput_T64"] = {lk: res["sweep"][lk, 64][0]
                                          for lk in ("ticket", "twa", "mcs")}
                line["sem"] = {str(k): v for k, v in res["sem"].items()}
                line["collisions"] = {str(k): v for k, v in
                                      res["collisions"].items()}
            elif name == "elastic_restart":
                assert res["verdict"] == "OK", res["drift"]
                line["drift"] = res["drift"]
            elif name == "serve_continuous_batching":
                line["requests"] = len(res["results"])
                line["trace_requests"] = len(res["trace"])
                line["gate"] = res["gate"]
            else:
                line.update({k: res[k] for k in ("first10", "last10",
                                                 "params")})
                line["steps"] = len(res["losses"])
            if name in ("quickstart", "lock_playground"):
                assert engine_cuda.launches > 0, name
            out["scripts"][name] = line
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    return out


# The reference dry run of granite-moe-1b-a400m × train_4k × pod16x16 at
# full width (repro.launch.dryrun.run_cell, then repro.launch.roofline's
# analyzer; jax 0.9.0 on a CPU): total_per_device in GiB, hlo_flops,
# coll_bytes.  The card's host has no JAX, so they are constants here.
DRYRUN_REFERENCE = {"gib_per_device": 12.47, "hlo_flops": 2.382e13,
                    "coll_bytes": 5.553e11}


# decode and long-context cells at full width, depth cut (n_layers): the
# one-token paths at real head counts (tests/test_torch_launch_fidelity_
# decode.py holds their counts to the reference's dry run)
CUT_DRYRUNS = (("granite-moe-1b-a400m", "decode_32k", 2),
               ("gemma3-1b", "decode_32k", 2),
               ("recurrentgemma-9b", "decode_32k", 3),
               ("falcon-mamba-7b", "long_500k", 2),
               ("recurrentgemma-9b", "long_500k", 3),
               ("gemma3-1b", "long_500k", 2),
               ("gemma2-27b", "long_500k", 2),
               # autograd cells: their forward and backward run
               # shard_utils.relocate (falcon-mamba's in-projection halves,
               # recurrentgemma's gate parts)
               ("falcon-mamba-7b", "train_4k", 2),
               ("recurrentgemma-9b", "prefill_32k", 3),
               ("recurrentgemma-9b", "train_4k", 3))

# The reference dry run of each CUT_DRYRUNS cell (its n_layers, the
# config's dtype, pod16x16; repro.launch.dryrun.run_cell, then
# repro.launch.roofline.analyze_hlo_text; jax 0.9.0 on a CPU): product
# FLOPs, collective bytes, and collective bytes with each float32 tensor
# counted at the model's 2 bytes (its CPU backend reduces a bf16
# product's partial sums in float32, the port in bf16).  From
#   PYTHONPATH=src JAX_PLATFORMS=cpu python tests/launch_fidelity_table.py \
#     --layers N --arch A --shape S --out F
# (its rows' ref "flops", "coll_bytes", "coll_bf16").  The card's host
# has no JAX, so they are constants here.
CUT_REFERENCE = {
    "granite-moe-1b-a400m/decode_32k/L2": (223608832, 27404544.0,
                                           13831168.0),
    "gemma3-1b/decode_32k/L2": (393150464, 36881024.0, 18440768.0),
    "recurrentgemma-9b/decode_32k/L3": (1721794560, 342353280.0,
                                        171176896.0),
    "falcon-mamba-7b/long_500k/L2": (4775936, 76422.5, 38211.25),
    "recurrentgemma-9b/long_500k/L3": (14684160, 222052.5, 111026.25),
    "gemma3-1b/long_500k/L2": (3731968, 438161.5, 219080.75),
    "gemma2-27b/long_500k/L2": (559128576, 207637.5, 103818.75),
    # the product FLOPs less the reference's one-hot label contraction
    # (the port takes the label logit without a product)
    "falcon-mamba-7b/train_4k/L2": (12886512500736, 27561625799.5,
                                    13783696483.75),
    "recurrentgemma-9b/prefill_32k/L3": (14500078026752, 24219722752.0,
                                         12111958528.0),
    "recurrentgemma-9b/train_4k/L3": (48740094181376, 101747698133.5,
                                      50876732650.75),
}

# The port's own product FLOPs of the autograd cells (the same dry run on
# torch 2.13 and a CPU: reduced_dryruns(...)["cells"][key]["flops"]), held
# in place of the reference's where they part, each gap named:
# * falcon-mamba-7b train_4k: 1.0000417× the reference's, 536,870,912
#   FLOPs: one of the depthwise conv's two backward products
#   (bsdk,dk->bsd: 512×16384×4 by 4×1 a device, 2 layers × 4
#   microbatches), a product on the port's side, an elementwise multiply
#   (no dot) on the reference's;
# * recurrentgemma-9b train_4k: 1.0052927× the reference's,
#   257,966,473,216 FLOPs: that conv term (268,435,456), and 15/16 of 8
#   products of 16384×4096×256 a device in the key and value projections
#   (bsd,dhk->bshk) of its local attention layer, whose one KV head does
#   not divide model: the port runs them whole on every device, the
#   reference's partitioner splits one of their backward products over
#   model.
CUT_PORT_FLOPS = {
    "falcon-mamba-7b/train_4k/L2": 12887049371648,
    "recurrentgemma-9b/prefill_32k/L3": 14500078026752,
    "recurrentgemma-9b/train_4k/L3": 48998060654592,
}

# The relocations of the autograd cells (shard_utils.relocate, forward and
# backward): the part each device takes, a collective_permute row over
# model, and the shapes of which no all-gather over model may be left: the
# part, and for falcon-mamba a device's part of the in-projection, which
# chunking the weight gathered.
CUT_MOVES = {
    "falcon-mamba-7b/train_4k/L2": ("4096x512", ("4096x512", "4096x1024")),
    "recurrentgemma-9b/prefill_32k/L3": ("2x32768x256", ("2x32768x256",)),
    "recurrentgemma-9b/train_4k/L3": ("4x4096x256", ("4x4096x256",)),
}


def held_to_reference(cells: dict) -> dict:
    """Each cut cell of :func:`reduced_dryruns` beside
    :data:`CUT_REFERENCE`: its FLOPs equal the reference's (an autograd
    cell's the port's own count, :data:`CUT_PORT_FLOPS`), and a long_500k
    or autograd cell's collective bytes are within 2× of the reference's
    counted at the model's dtype, nothing taken out; an autograd cell's
    relocations are collective-permutes with no all-gather of their parts
    (:data:`CUT_MOVES`).  Returns the ratios; a cell outside raises."""
    out, bad = {}, []
    for key, (flops, coll, coll_model) in CUT_REFERENCE.items():
        got = cells[key]
        out[key] = {"flops": got["flops"] / flops,
                    "coll": got["coll_bytes"] / coll,
                    "coll_model_dtype": got["coll_bytes"] / coll_model}
        held = "long_500k" in key or key in CUT_PORT_FLOPS
        ok = got["flops"] == CUT_PORT_FLOPS.get(key, flops) and (
            not held or 0.5 <= out[key]["coll_model_dtype"] <= 2)
        if key in CUT_MOVES:
            part, ungathered = CUT_MOVES[key]
            out[key]["permutes"] = got["permutes"]
            ok = ok and [part, ["model"]] in [
                p[:2] for p in got["permutes"]] and not any(
                g in [[u, ["model"]] for u in ungathered]
                for g in got["gathers"])
        if not ok:
            bad.append((key, got, (flops, coll, coll_model)))
    assert not bad, bad
    return out


def reduced_dryruns(out_dir: str) -> dict:
    """The dry run of every config's ``reduced()`` × applicable shape on
    pod16x16 (fake tensors, the host's CPU), then of ``CUT_DRYRUNS``: GiB a
    device, product FLOPs and collective bytes a cell.  A cell that raises
    fails the phase."""
    from repro_torch.configs import ARCHS, SHAPES, applicable
    from repro_torch.launch import dryrun, roofline

    cells, t0 = {}, time.perf_counter()
    for arch in sorted(ARCHS):
        full, red = ARCHS[arch], ARCHS[arch].reduced()
        overrides = {f.name: getattr(red, f.name)
                     for f in dataclasses.fields(full)
                     if f.name != "name"
                     and getattr(red, f.name) != getattr(full, f.name)}
        todo = [(f"{arch}/{shape}", arch, shape, overrides)
                for shape in SHAPES if applicable(full, SHAPES[shape])[0]]
        todo += [(f"{a}/{shape}/L{n}", a, shape, {"n_layers": n})
                 for a, shape, n in CUT_DRYRUNS if a == arch]
        for key, arch_, shape, ov in todo:
            res = dryrun.run_cell(arch_, shape, multi_pod=False,
                                  cfg_overrides=ov, out_dir=out_dir)
            assert res["status"] == "ok", res
            r = roofline.roofline_cell(res["ops_path"].replace(
                ".ops.json", ".json"))
            cells[key] = {
                "mib": res["memory"]["total_per_device"] / 2**20,
                "flops": r["op_flops"], "coll_bytes": r["coll_bytes"]}
            if key in CUT_MOVES:
                with open(res["ops_path"]) as f:
                    rows = json.load(f)

                def part(op):
                    return [[row["shapes"].split(",")[0], row["axes"],
                             row["calls"]] for row in rows
                            if row["op"] == "_c10d_functional." + op]
                cells[key].update(permutes=part("collective_permute"),
                                  gathers=[g[:2] for g in part(
                                      "all_gather_into_tensor")])
    return {"cells": cells, "count": len(cells),
            "seconds": time.perf_counter() - t0}


def launch_dryruns(out_dir: str) -> dict:
    """The launch phase's dry runs, on the host's CPU alone (fake tensors,
    no card): :func:`reduced_dryruns`, its cut cells held to the
    reference's (:func:`held_to_reference`), then granite-moe-1b-a400m ×
    train_4k × pod16x16 at full width (``repro_torch.launch.dryrun.run_cell``
    over a fake process group of 256 ranks) and its Hopper roofline, held
    to the reference's dry run: at most 2× its bytes a device, FLOPs within
    10%."""
    from repro_torch.launch import dryrun, roofline

    out = {"reduced_cells": reduced_dryruns(out_dir)}
    out["cut_vs_reference"] = held_to_reference(out["reduced_cells"]["cells"])
    t0 = time.perf_counter()
    res = dryrun.run_cell(SERVE_ARCH, "train_4k", multi_pod=False,
                          out_dir=out_dir)
    wall = time.perf_counter() - t0
    assert res["status"] == "ok", res
    r = roofline.roofline_cell(os.path.join(out_dir, res["cell"] + ".json"))
    gib = res["memory"]["total_per_device"] / 2**30
    out["dryrun"] = {
        "cell": res["cell"], "gib_per_device": r["memory_gib"],
        **{k: r[k] for k in ("op_flops", "coll_bytes", "compute_s",
                             "memory_s", "collective_s", "latency_s",
                             "dominant", "step_time_bound_s",
                             "roofline_fraction")},
        "reference": DRYRUN_REFERENCE,
        "ratio": {"gib": gib / DRYRUN_REFERENCE["gib_per_device"],
                  "flops": r["op_flops"] / DRYRUN_REFERENCE["hlo_flops"],
                  "coll_bytes": r["coll_bytes"]
                  / DRYRUN_REFERENCE["coll_bytes"]},
        "memory": res["memory"], "wall_seconds": wall,
        # bytes a device, product FLOPs and collective bytes are held to
        # the reference's dry run by the CPU tests (narrow cells with real
        # head counts, tests/test_torch_launch_fidelity*.py); HBM bytes and
        # launches are eager PyTorch's, with no counterpart to hold them to
        "unverified": ["memory_s", "latency_s", "dominant",
                       "step_time_bound_s", "roofline_fraction"]}
    assert 0 < r["memory_gib"] and r["dominant"] in (
        "compute", "memory", "collective", "latency"), r
    assert gib <= 2 * DRYRUN_REFERENCE["gib_per_device"], out["dryrun"]
    assert abs(out["dryrun"]["ratio"]["flops"] - 1) <= 0.1, out["dryrun"]
    return out


# The launch phase's dry runs in a child process with no card visible:
# root, scratch dir and result file as arguments.
DRYRUN_PROGRAM = r'''
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src"]
import chip_smoke
with open(sys.argv[3], "w") as f:
    json.dump(chip_smoke.launch_dryruns(sys.argv[2]), f)
'''


def start_dryruns(root: Path) -> dict:
    """Start :func:`launch_dryruns` in a child process with no card visible
    (``CUDA_VISIBLE_DEVICES`` empty), so that its minute and a half of one
    host core runs beside the phases on the card; it is stopped and its
    scratch removed when this script exits."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    job = {"result": os.path.join(tmp, "result.json"),
           "log": os.path.join(tmp, "log.txt")}
    with open(job["log"], "w") as log:
        job["proc"] = subprocess.Popen(
            [sys.executable, "-c", DRYRUN_PROGRAM, str(root),
             os.path.join(tmp, "cells"), job["result"]],
            env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
            stdout=log, stderr=subprocess.STDOUT)

    def stop():
        if job["proc"].poll() is None:
            job["proc"].kill()
            job["proc"].wait()
        shutil.rmtree(tmp, ignore_errors=True)

    atexit.register(stop)
    return job


def finish_dryruns(job: dict, timeout: float = 900) -> dict:
    """The result of :func:`start_dryruns`' child, waited for; its log's
    tail raised if it failed."""
    rc = job["proc"].wait(timeout=timeout)
    if rc != 0:
        with open(job["log"]) as f:
            raise RuntimeError(f"dry runs exited {rc}:\n{f.read()[-3000:]}")
    with open(job["result"]) as f:
        return json.load(f)


def launch_phase(train: dict, smi: str, dryruns: dict) -> dict:
    """The launch tools on the host's CPU (fake tensors, no card time): the
    dry runs of :func:`launch_dryruns` (``dryruns``, run beside the earlier
    phases); then the one-device roofline (1×1 mesh) of the step phase 11
    timed, with the config's remat and with ``"none"``, held against the
    measured ms a step: the bound may not exceed it, and ``train_mfu`` is
    the model's FLOPs over the card's bf16 peak times the measured step."""
    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim import AdamW

    cfg = get_config(SERVE_ARCH)
    out = {"phase": "launch", "arch": SERVE_ARCH, "card": smi, **dryruns}
    cell = ShapeCell("train_b8_s512", "train", TRAIN_SEQ, TRAIN_BATCH)
    measured = {cfg.remat: train["plain"]["median_step_ms_after_first"],
                "none": train["remat_none"]["median_step_ms_after_first"]}
    out["one_device"] = {}
    for remat, step_ms in measured.items():
        run_cfg = dataclasses.replace(cfg, remat=remat)
        t0 = time.perf_counter()
        with make_local_mesh(1, 1) as mesh:
            memory, rows = dryrun.execute_cell(run_cfg, cell, mesh,
                                               optimizer=AdamW())
        rf = roofline.roofline({
            "cell": f"{SERVE_ARCH}__{cell.name}__1x1", "arch": SERVE_ARCH,
            "shape": cell.name, "kind": "train", "seq_len": cell.seq_len,
            "global_batch": cell.global_batch, "mesh": [1, 1],
            "mesh_axes": ["data", "model"], "params": run_cfg.param_count(),
            "active_params": run_cfg.active_param_count(),
            "memory": memory}, rows)
        bound_ms = rf["step_time_bound_s"] * 1e3
        line = {k: rf[k] for k in ("compute_s", "memory_s", "latency_s",
                                   "dominant", "op_flops", "op_bytes",
                                   "launches", "model_flops")}
        line.update(bound_ms=bound_ms, measured_ms=step_ms,
                    bound_share=bound_ms / step_ms,
                    train_mfu=rf["model_flops"] / (
                        roofline.PEAK_FLOPS * step_ms / 1e3),
                    gib=rf["memory_gib"],
                    seconds=time.perf_counter() - t0)
        out["one_device"][remat] = line
        assert bound_ms <= step_ms, (remat, bound_ms, step_ms)
    return out


def check_claims(by: dict) -> None:
    """The fig3 inequalities of tests/test_sim_paper_claims.py."""
    for T in (1, 2, 4):
        tk, tw, mc = (by[lk, T]["throughput"] for lk in ("ticket", "twa",
                                                          "mcs"))
        assert tk >= tw * 0.98, (T, tk, tw)
        assert tw >= tk * 0.90, (T, tk, tw)
        if T == 1:
            assert tk > mc, (T, tk, mc)
        else:
            assert tk >= mc * 0.97, (T, tk, mc)
    tk16, tk64 = (by["ticket", T]["throughput"] for T in (16, 64))
    tw16, tw64 = (by["twa", T]["throughput"] for T in (16, 64))
    mc16, mc64 = (by["mcs", T]["throughput"] for T in (16, 64))
    assert tk64 < 0.5 * tk16
    assert tw64 > 0.85 * tw16
    assert mc64 > 0.85 * mc16
    assert tw64 > 2.5 * tk64
    assert tw64 >= mc64
    assert mc64 > tk64
    h_tk8, h_tk64 = (by["ticket", T]["avg_handover"] for T in (8, 64))
    h_tw8, h_tw64 = (by["twa", T]["avg_handover"] for T in (8, 64))
    h_mc64 = by["mcs", 64]["avg_handover"]
    assert h_tk64 > 2.5 * h_tk8
    assert h_tw64 < 1.3 * h_tw8
    assert h_tw64 < h_tk64 / 2
    assert h_tw64 < h_mc64 * 1.6


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch import _build, ckpt, optim, sim, tree
    from repro_torch.bench import fuzz_smoke
    from repro_torch.bench import run as bench_run
    from repro_torch.bench.fig13_serve_e2e import TRACE_ENV
    from repro_torch.configs import get_config
    from repro_torch.kernels.causal_conv import kernel as conv_kernel
    from repro_torch.kernels.causal_conv import ref as conv_ref
    from repro_torch.kernels.mamba_scan import kernel as scan_kernel
    from repro_torch.kernels.mamba_scan import ref as scan_ref
    from repro_torch.kernels.rglru import kernel as rglru_kernel
    from repro_torch.kernels.rglru import ref as rglru_ref
    from repro_torch.kernels.ticket_dispatch import kernel as ticket_kernel
    from repro_torch.kernels.ticket_dispatch import plan as plan_kernel
    from repro_torch.kernels.ticket_dispatch import ref as ticket_ref
    from repro_torch.models import model
    from repro_torch.models.layers import moe_capacity
    from repro_torch.serve import ServeEngine
    from repro_torch.sim import engine, engine_cuda
    from repro_torch.sim.corpus import load_scenario, scenario_sweep_args
    from repro_torch.sim.workloads import RESULTS_STORE_ENV
    from repro_torch.data import synthetic_batch
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    from repro_torch.train import train_step

    # the sweeps here write to no results store but the phase's own, and
    # fig13 records its own trace
    os.environ.pop(RESULTS_STORE_ENV, None)
    os.environ.pop(TRACE_ENV, None)

    root = Path(__file__).resolve().parent
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # float32 products in full float32 (the small-model check); the serve
    # path is bf16 and takes no TF32 either way
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def spec_inputs(specs):
        """The kernel's input tensors on the card for one engine call."""
        progs, kw, _ = sim.sweep_engine_args(specs)
        kw.pop("live_mem_words")
        n_locks = kw.pop("n_locks")
        return engine.sweep_inputs(progs, **kw, device=dev), n_locks

    # the launch phase's dry runs (host CPU only), beside the phases below
    dryruns = start_dryruns(root)

    # ---- 1. card and build
    smi = query_smi("name,power.limit")
    kind = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    libraries = ["lockvm", "ticket_dispatch", "mamba_scan", "rglru_scan",
                 "moe_plan"]
    _build.load_libraries(libraries)
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in _build.build_logs.get(name, "")
                    .splitlines() if "registers" in ln or "spill" in ln]
             for name in libraries}
    assert ticket_kernel.smem_bytes_from_kernel(32) == \
        ticket_kernel.smem_bytes(32)
    for args in ((32, 8, 8), (32, 512, 8), (32, 5000, 8), (8, 256, 2),
                 (32, 1, 32)):
        assert plan_kernel.smem_bytes_from_kernel(*args) == \
            plan_kernel.smem_bytes(*args), args
    for mask in range(8):
        assert rglru_kernel.smem_bytes_from_kernel(mask) == \
            rglru_kernel.smem_bytes(bool(mask & 1), bool(mask & 2)), mask
    n_fig3_threads = max(FIG3_THREADS)
    mem64 = sim.Layout(n_threads=n_fig3_threads, n_locks=1).mem_words
    words = engine_cuda.state_words_from_kernel(n_fig3_threads, mem64, 1)
    assert 4 * words == engine_cuda.cell_state_bytes(n_fig3_threads, mem64), \
        (words, engine_cuda.cell_state_bytes(n_fig3_threads, mem64))
    emit({"phase": "build", "card": smi, "kind": kind,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_seconds": build_s, "ptxas": ptxas,
          "ticket_smem_bytes_E32": ticket_kernel.smem_bytes(32),
          "plan_smem_bytes_E32_K8_Lp512": plan_kernel.smem_bytes(32, 512, 8),
          "cell_state_bytes_T64": 4 * words})

    # ---- 2. kernel vs plain engine on the card
    t0 = time.perf_counter()
    corpus = [load_scenario(p) for p in sorted((root / "tests" / "corpus")
                                               .glob("*.npz"))]
    assert len(corpus) == 14, len(corpus)
    progs, kw = scenario_sweep_args(corpus)
    checks = [compare("corpus", engine.sweep_inputs(
        progs, **{k: v for k, v in kw.items() if k != "n_locks"},
        device=dev), kw["n_locks"], engine, engine_cuda)]
    # faults on every lane of a warp and past it (T = 40: two bitset words,
    # two threads per lane); twa-timo's generator stops at 32 threads
    fault_kw = dict(seeds=(1, 2), horizon=4_000, preempt_faults=3,
                    spurious_faults=2, abort_faults=1, preempt_cost=512,
                    fault_evt_span=3_000)
    fault_specs = [sim.SweepSpec(locks=("ticket", "twa", "mcs", "twa-sem"),
                                 threads=(4, 16, 40), **fault_kw),
                   sim.SweepSpec(locks="twa-timo", threads=(4, 16),
                                 **fault_kw)]
    # 130 threads: past the 128 the kernel keeps in registers (rows in
    # shared memory)
    wide_specs = [sim.SweepSpec(locks=("ticket", "twa"), threads=(130,),
                                seeds=1, horizon=600, collect_latency=True)]
    sets = [("faults", fault_specs), ("rows_in_memory_T130", wide_specs),
            *figures_reduced_sets(sim, FIGURES_REDUCED_HORIZON),
            ("fig3_reduced", fig3_specs(sim, CHECK_HORIZON))]
    for name, specs in sets:
        args, n_locks = spec_inputs(specs)
        if name == "faults":
            assert args[-1] is not None and bool((args[-1][0] != 0).any())
        checks.append(compare(name, args, n_locks, engine, engine_cuda))
        checks[-1]["state"] = engine_cuda.state_placement(
            int(args[1].shape[1]), int(args[3].shape[1]), n_locks,
            int(args[0].shape[1]))
    assert checks[-2]["state"] == "global", checks[-2]   # fig2, 64 locks
    emit({"phase": "kernel_vs_plain", "tolerance": "bit-identical",
          "seconds": time.perf_counter() - t0,
          "sets": [{k: v for k, v in c.items() if k != "out"}
                   for c in checks]})
    reduced = checks[-1]
    # kernel time on the reduced fig3 inputs (warm): the median of 3
    kernel_ms, _ = cuda_ms(lambda: engine_cuda.run_cells(
        *args, n_locks=n_locks), repeats=3)

    # ---- 3. the main path at full size, through the user's entry point
    specs = fig3_specs(sim, 1_500_000)
    t0 = time.perf_counter()
    engine_cuda.launches = 0
    results = sim.run_sweeps(specs, device=dev)
    launches = engine_cuda.launches
    wall = time.perf_counter() - t0
    rows = [r for rs in results for r in rs]
    assert len(rows) == FIG3_ROWS, len(rows)
    assert all(r["mode"] == "cuda" for r in rows), rows[0]["mode"]
    assert launches > 0, launches
    for r in rows:
        assert r["acquisitions"].shape == (r["n_threads"],)
        assert 0 < int(r["events"]) <= 2_000_000, r["events"]
        assert (r["acquisitions"] >= 0).all() and r["acquisitions"].sum() > 0
        assert math.isfinite(r["throughput"]) and r["throughput"] > 0
        for col in ("lat_p50", "lat_p99", "lat_p999"):
            assert math.isfinite(r[col]), (r["lock"], r["n_threads"], col)
        assert r["lat_p50"] <= r["lat_p99"] <= r["lat_p999"]
    events = np.asarray([int(r["events"]) for r in rows])
    by = {(r["lock"], r["n_threads"], r["seed"]): r for r in rows}
    # the kernel alone on the main path's inputs (device time), and the SM
    # clock sampled while it runs
    main_args, n_locks = spec_inputs(specs)
    main_ms, main_out = cuda_ms(lambda: engine_cuda.run_cells(
        *main_args, n_locks=n_locks), repeats=3)
    assert np.array_equal(main_out["events"].cpu().numpy(), events)
    engine_cuda.run_cells(*main_args, n_locks=n_locks)
    sm_clock = query_smi("clocks.sm,clocks.max.sm")
    torch.cuda.synchronize()
    us_per_event = main_ms * 1e3 / int(events.max())
    main_bound, main_bound_by = bound_ms(
        nbytes(main_args) + nbytes(main_out.values()), int(events.sum()))
    emit({"phase": "main_path", "entry": "repro_torch.sim.run_sweeps",
          "mode": rows[0]["mode"], "launches": launches, "cells": len(rows),
          "wall_seconds": wall, "kernel_ms": main_ms,
          "sum_events": int(events.sum()), "max_events": int(events.max()),
          "events_per_s": float(events.sum()) / wall,
          "throughput_T64": {lk: float(np.median(
              [by[lk, 64, s]["throughput"] for s in (1, 2, 3)]))
              for lk in ("ticket", "twa", "mcs")},
          "us_per_event_longest_cell": us_per_event,
          "sm_clock_during_kernel": sm_clock,
          "bound_ms": main_bound, "bound_by": main_bound_by})

    # ---- 3a. the main path's rows through the results store and advisor
    emit(results_advisor_phase(dev, sim, rows, ServeEngine, model,
                               get_config(SERVE_ARCH).reduced()))

    # ---- 3b. the differential checker's cuda lane
    emit(fuzz_cuda_phase(root, dev))

    # ---- 4. the paper's fig3 claims on the kernel
    t0 = time.perf_counter()
    engine_cuda.launches = 0
    claims = sim.run_sweep(sim.SweepSpec(
        locks=("ticket", "twa", "mcs"), threads=(1, 2, 4, 8, 16, 64),
        seeds=1, horizon=CLAIMS_HORIZON), device=dev)
    assert engine_cuda.launches > 0 and claims[0]["mode"] == "cuda"
    check_claims({(r["lock"], r["n_threads"]): r for r in claims})
    emit({"phase": "paper_claims", "seconds": time.perf_counter() - t0,
          "launches": engine_cuda.launches, "checked": [
              "low_contention_ticket_best_twa_close",
              "high_contention_ticket_collapses_twa_wins",
              "handover_scaling"]})

    # ---- 4a. the lockVM figures at the reference's full specs
    figures = figures_phase(dev, engine, engine_cuda, bench_run)
    for line in figures:
        emit(line)

    # ---- 4b. fig13: the serve<->lockVM loop end to end
    emit(fig13_phase(dev, engine, engine_cuda, bench_run))

    # ---- 4c. the fuzz smoke suite with both engine modes
    emit(fuzz_smoke_phase(dev, engine, engine_cuda, fuzz_smoke))

    # ---- 4d. the host-lock suites: Table 1, host threads, admission
    host_locks = host_locks_phase(dev, engine, engine_cuda, bench_run)
    emit(host_locks)

    # ---- 5. the ticket kernel against its plain version
    cfg = get_config(SERVE_ARCH)
    ticket = ticket_phase(dev, ticket_kernel, ticket_ref, moe_capacity, cfg)
    emit(ticket)
    plan = plan_phase(dev, plan_kernel, ticket_ref, moe_capacity, cfg,
                      get_config(GROK_ARCH))
    emit(plan)

    # ---- 6. serve granite-moe-1b-a400m at full width
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init_params(cfg, gen, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    probe = torch.from_numpy(np.random.default_rng(1).integers(
        1, cfg.vocab, size=(1, 64))).to(dev)
    logits, _, _ = model.forward(params, {"tokens": probe}, cfg)
    assert logits.shape == (1, 64, cfg.padded_vocab)
    assert torch.isfinite(logits[..., :cfg.vocab]).all()
    assert bool((logits[..., cfg.vocab:] == -1e30).all())
    served = serve_phase(dev, cfg, params, ServeEngine, plan_kernel,
                         ticket_kernel)
    served["init_params_s"] = init_s
    small = cfg.reduced()
    served["small_model"] = small_model_phase(
        dev, small, model, plan_kernel, [small.n_layers] * 3)
    emit(served)
    del params, logits
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 7. the scan kernel against its plain version
    scan = scan_phase(dev, scan_kernel, scan_ref)
    emit(scan)

    # ---- 7b. the conv kernel against its plain version
    conv = conv_phase(dev, conv_kernel, conv_ref)
    emit(conv)

    # ---- 8. serve falcon-mamba-7b at full width
    t0 = time.perf_counter()
    mcfg = get_config(MAMBA_ARCH)
    params = model.init_params(mcfg, torch.Generator(device=dev).manual_seed(
        0), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    mamba = serve_mamba_phase(dev, mcfg, params, ServeEngine, scan_kernel,
                              conv_kernel)
    mamba["init_params_s"] = init_s
    small = mcfg.reduced()
    mamba["small_model"] = small_model_phase(dev, small, model, scan_kernel,
                                             [small.n_layers, 0, 0])
    emit(mamba)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 9. the RG-LRU kernel against its plain version
    rglru = rglru_phase(dev, rglru_kernel, rglru_ref)
    emit(rglru)

    # ---- 10. serve recurrentgemma-9b at full width
    t0 = time.perf_counter()
    gcfg = get_config(GRIFFIN_ARCH)
    params = model.init_params(gcfg, torch.Generator(device=dev).manual_seed(
        0), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    griffin = serve_griffin_phase(dev, gcfg, params, ServeEngine,
                                  rglru_kernel)
    griffin["init_params_s"] = init_s
    small = gcfg.reduced()
    griffin["small_model"] = small_model_phase(
        dev, small, model, rglru_kernel,
        [small.layer_kinds().count("rglru"), 0, 0])
    emit(griffin)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 10a. serve the other decoders at full width
    archs = {}
    for arch, (layers, lanes, long, max_ctx) in SERVE_ARCHS.items():
        acfg = get_config(arch)
        archs[arch] = serve_arch_phase(
            dev, dataclasses.replace(acfg, n_layers=layers or acfg.n_layers),
            model, ServeEngine, plan_kernel, ticket_kernel, lanes=lanes,
            long=long, max_ctx=max_ctx)
        emit({**archs[arch], "n_layers_config": acfg.n_layers})

    # ---- 11. train granite-moe-1b-a400m at full width
    train = train_phase(dev, launch_train, ckpt, tree, ticket_kernel,
                        plan_kernel)
    emit(train)

    # ---- 11a. the other decoders at full width, depth cut, and why grok-1
    # takes no step at full width
    trained = {}
    for arch, (layers, batch, seq) in TRAIN_ARCHS.items():
        acfg = get_config(arch)
        trained[arch] = train_arch_phase(
            dev, launch_train, model,
            dataclasses.replace(acfg, n_layers=layers or acfg.n_layers),
            batch, seq, acfg.n_layers, accum=arch == TRAIN_ACCUM_ARCH)
        emit(trained[arch])
    emit(grok_train_reckoning(model, get_config(GROK_ARCH)))

    # ---- 11b. the launchers as a user starts them, in child processes
    emit(entry_points_phase(root, dev, launch_serve, plan_kernel, train,
                            trained[ENTRY_GEMMA2]))

    # ---- 11c. the recurrent trains under the reference's $REPRO_SCAN_CHUNK
    for arch, chunk in TRAIN_SCAN_CHUNK.items():
        layers, batch, seq = TRAIN_ARCHS[arch]
        emit(train_chunked_phase(
            root, dev, model,
            dataclasses.replace(get_config(arch), n_layers=layers), batch,
            seq, chunk, trained[arch]))

    # ---- 12. reduced models train alike on the card and on the CPU
    emit(train_devices_phase(dev, model, train_step, optim, tree,
                             ticket_kernel))

    # ---- 13. train hubert-xlarge at full width and depth
    emit(train_hubert_phase(dev, launch_train, get_config(AUDIO_ARCH)))

    # ---- 14. qwen2-vl-72b at full width, 4 layers: loss, backward, decode
    emit(frontends_phase(dev, model, synthetic_batch, dataclasses.replace(
        get_config(VLM_ARCH), n_layers=VLM_LAYERS)))

    # ---- 15. the example scripts at their own specs
    examples = examples_phase(dev, engine_cuda)
    emit(examples)

    # ---- 16. the launch tools: the dry run and the Hopper roofline
    emit(launch_phase(train, smi, finish_dryruns(dryruns)))

    bound, bound_by = bound_ms(reduced["bytes"], reduced["sum_events"])
    dec = ticket["timed"]["decode"]
    pre = ticket["timed"]["prefill_Lp256"]
    ttr = ticket["timed"]["train"]
    pdec = plan["timed"]["decode"]
    ppre = plan["timed"]["prefill_Lp256"]
    print(json.dumps({"kernels": [{
        "name": "lockvm_run", "route": "cuda",
        "source": "src/repro_torch/csrc/lockvm.cu",
        "replaces": "src/repro/sim/engine_pallas.py:154",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in checks),
        "ms": kernel_ms, "plain_ms": reduced["plain_ms"],
        "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
        "timed_on": f"fig3 cells at horizon {CHECK_HORIZON}",
        "max_events": reduced["max_events"],
        "main_path_ms": main_ms, "main_path_bound_ms": main_bound,
        "main_path_max_events": int(events.max()),
        "main_path_us_per_event": us_per_event,
        "sm_clock_during_kernel": sm_clock,
        "figure_launches": {ln["suite"]: ln["launches"] for ln in figures},
        "admission_launches": host_locks["suites"]["admission"]["launches"],
        "figure_kernel_seconds": {ln["suite"]: ln["kernel_seconds"]
                                  for ln in figures},
        "example_launches": {name: ln["lockvm_launches"] for name, ln in
                             examples["scripts"].items()}}, {
        "name": "ticket_dispatch_run", "route": "cuda",
        "source": "src/repro_torch/csrc/ticket_dispatch.cu",
        "replaces": "src/repro/kernels/ticket_dispatch/kernel.py:72",
        "launches": served["ticket_launches"],
        "launches_on": "serve, dispatch='ticket'",
        "train_launches": train["use_pallas"]["ticket_launches"],
        "train_launches_on": f"train, use_pallas=True, "
                             f"{TRAIN_PALLAS_STEPS} steps, remat "
                             f"{train['remat']!r} (forward and recompute)",
        "max_abs_err": max(c["max_abs_err"] for c in ticket["sets"]),
        "ms": dec["ms"], "device_ms": dec["device_ms"],
        "launch_floor_ms": dec["launch_floor_ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
        "library_ms": None,
        "timed_on": f"decode group: {dec['arrivals']} arrivals, "
                    f"E={dec['E']}",
        "prefill_Lp256_ms": pre["ms"],
        "prefill_Lp256_device_ms": pre["device_ms"],
        "prefill_Lp256_plain_ms": pre["plain_ms"],
        "prefill_Lp256_bound_ms": pre["bound_ms"],
        "train_group_ms": ttr["ms"], "train_group_device_ms": ttr["device_ms"],
        "train_group_plain_ms": ttr["plain_ms"],
        "train_group_bound_ms": ttr["bound_ms"],
        "train_group": f"{ttr['groups']} groups of {ttr['arrivals']} "
                       f"arrivals"}, {
        "name": "moe_plan_run", "route": "cuda",
        "source": "src/repro_torch/csrc/moe_plan.cu",
        "replaces": "src/repro/kernels/ticket_dispatch/kernel.py:72",
        "launches": served["plan_launches"],
        "launches_on": "serve, dispatch='auto'",
        "grok_serve_launches": archs[GROK_ARCH]["plan_launches"],
        "max_abs_err": max(c["max_abs_err"] for c in plan["sets"]),
        "gate_sums_max_rel_err": max(c["gate_sums_max_rel_err"]
                                     for c in plan["sets"]),
        "ms": pdec["ms"], "device_ms": pdec["device_ms"],
        "launch_floor_ms": pdec["launch_floor_ms"],
        "plain_ms": pdec["plain_ms"], "bound_ms": pdec["bound_ms"],
        "bound_by": pdec["bound_by"], "library_ms": None,
        "timed_on": f"decode group: {pdec['tokens']} tokens, "
                    f"E={pdec['E']}, K={pdec['K']}",
        "prefill_Lp256_ms": ppre["ms"],
        "prefill_Lp256_device_ms": ppre["device_ms"],
        "prefill_Lp256_plain_ms": ppre["plain_ms"],
        "prefill_Lp256_bound_ms": ppre["bound_ms"]}, {
        "name": "mamba_scan_run", "route": "cuda",
        "source": "src/repro_torch/csrc/mamba_scan.cu",
        "replaces": "src/repro/kernels/mamba_scan/kernel.py:94",
        "launches": mamba["scan_launches"],
        "max_abs_err": max(c["max_abs_err"] for c in scan["sets"]),
        "max_abs_err_float32": max(c["max_abs_err"] for c in scan["sets"]
                                   if c["tolerance"] == 1e-5),
        "ms": scan["timed"]["ms"], "device_ms": scan["timed"]["device_ms"],
        "launch_floor_ms": scan["timed"]["launch_floor_ms"],
        "plain_ms": scan["timed"]["plain_ms"],
        "bound_ms": scan["timed"]["bound_ms"],
        "bound_by": scan["timed"]["bound_by"], "library_ms": None,
        "timed_on": "falcon-mamba-7b prefill: L 256, D 8192, N 16, bf16"}, {
        "name": "causal_conv_run", "route": "cuda",
        "source": "src/repro_torch/csrc/causal_conv.cu",
        "replaces": None, "replaces_why": "the reference's conv is plain XLA",
        "launches": mamba["conv_launches"],
        "max_ulps": max(c["max_ulps"] for c in conv["sets"]),
        "device_ms": conv["timed"]["S2048"]["kernel_ms"],
        "launch_floor_ms": conv["timed"]["S2048"]["launch_floor_ms"],
        "plain_ms": conv["timed"]["S2048"]["plain_ms"],
        "bound_ms": conv["timed"]["S2048"]["bound_ms"], "bound_by": "bytes",
        "library_ms": conv["timed"]["S2048"]["library_ms"],
        "timed_on": "falcon-mamba-7b prefill conv: S 2048, d_inner 8192, "
                    "width 4, bf16",
        "by_length": conv["timed"]}, {
        "name": "rglru_scan_run", "route": "cuda",
        "source": "src/repro_torch/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru/kernel.py:94",
        "launches": griffin["rglru_launches"],
        "max_abs_err": max(c["max_abs_err"] for c in rglru["sets"]),
        "max_abs_err_float32": max(c["max_abs_err"] for c in rglru["sets"]
                                   if c["tolerance"] == 1e-5),
        "ms": rglru["timed"]["L256"]["ms"],
        "device_ms": rglru["timed"]["L256"]["device_ms"],
        "launch_floor_ms": rglru["timed"]["L256"]["launch_floor_ms"],
        "plain_ms": rglru["timed"]["L256"]["plain_ms"],
        "bound_ms": rglru["timed"]["L256"]["bound_ms"],
        "bound_by": rglru["timed"]["L256"]["bound_by"], "library_ms": None,
        "timed_on": "recurrentgemma-9b prefill: L 256, D 4096, bf16",
        "L2600_ms": rglru["timed"]["L2600"]["ms"],
        "L2600_device_ms": rglru["timed"]["L2600"]["device_ms"],
        "L2600_plain_ms": rglru["timed"]["L2600"]["plain_ms"],
        "L2600_bound_ms": rglru["timed"]["L2600"]["bound_ms"]}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
