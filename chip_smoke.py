#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``ital_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:

1. device: the card's name and power limit (``nvidia-smi``), torch and CUDA
   versions.  Exits non-zero at once when ``torch.cuda.is_available()`` is
   False.
2. build: compiles ``ital_tpu_torch/csrc/*.cu`` for sm_90a with ``nvcc`` (one
   process per source, all at once) and loads the library; prints the
   seconds it took and the compiler's register/shared-memory report.
3. kernel vs plain: both routes of the CUDA RBF kernel (the tensor-core
   route ``rbf_wgmma.cu`` and the FMA tile kernel ``rbf_tile.cu``) against
   their plain PyTorch version on the card, at the shapes the session and
   the harness give them plus two more, on MIRFLICKR-surrogate features.
   For each shape: the route the router picks, each route's error, and the
   per-launch times of both routes (each forced) and the plain version, as
   runs of 50 launches between two CUDA events taken in turns (median of 5
   runs each, after warm-up), and each route's device time per launch (the
   median over 20 launches of two CUDA events around each, a sleep kernel
   queued ahead so that no launch waits on the host).  The picked route must
   not be slower than the tile kernel beyond the runs' spread, and no event
   or device time may lie more than 3 % under its bound, here and at every
   later phase's shapes.
4. session: the production configuration (``configs/mirflickr_production.ini``)
   on the 25 000 x 512 MIRFLICKR surrogate: ``update_query`` and 10 rounds of
   fetch / simulated user / update / AP through ``ActiveRetrieval``.  The
   kernel's launch count is reset just before and must grow in every step.
5. card vs CPU: a mid-session state copied to the CPU picks the same batch (up
   to MI ties at f32 resolution, checked step by step) and reaches the same
   posterior mean on the plain path.
6. harness: ``ital_tpu_torch.runner.run_experiment`` on ``configs/mirflickr.ini``
   (25 000 x 512, depth cut to 1 class x 5 rounds) for eight strategies:
   ITAL with the production options, EMOC, batch EMOC, MCMI[min], SUD, RBMAL,
   uncertainty and random sampling.  The launch counts are reset just
   before; every selection of the five strategies that build kernel blocks
   must launch the kernel, and every EMOC, batch-EMOC and MCMI selection the
   tensor-core route.  The EMOC run checkpoints every round; its round-2
   checkpoint is restored on the CPU through ``load_session`` and must pick
   the card's batch up to EMOC-score ties.  One more run, ITAL with
   ``GP.learn_every=2`` (1 class x 4 rounds), must log finite learned
   hyperparameters and move the length scale; its select and update spans
   and each re-learn (one program, synchronized) are timed.
7. serving: ``ital_tpu_torch.serve`` on the same corpus with the production
   [GP]/[USER]/[METHOD] settings and cap 64, served over HTTP on an
   ephemeral port from a daemon thread and driven with ``urllib``: four ITAL
   sessions on queries of two classes (two of them with one history, one
   through the cohort endpoints and one through ``GET /batch`` and
   ``POST /feedback``, whose batches must agree up to MI ties; one with
   ``randomize_qmc``; one on a random 4096-item subsample) and a ``sud``
   session, three rounds of ``/batch_select``, a seeded simulated user and
   ``/batch_feedback``, then ``/ranking``, ``/snapshot`` restored into a CPU
   service (posterior mean within ``CPU_MU_ATOL`` after one more update on
   both) and ``/learn`` (50 steps; on the card one captured program) on the
   card and on the CPU from that state: the length scale and variance must
   move, and agree within
   ``LEARN_RTOL``.  Every request kind that forms RBF blocks must launch the
   kernel; each kind's synchronized host latency is printed with the card's
   name and power limit.
8. cohort: the stacked cohort programs at the production configuration.
   First the kernel's stacked forms at a cohort of eight's shapes (the
   selection's pool cross-kernel and batch block, the update's three
   blocks, one of them in two hyperparameter groups), each held against the
   plain version within ``F32_ATOL`` x var and timed against one launch per
   session, beside the bound of the function it computes (each input read
   once, a shared corpus once for all groups, only the K blocks it returns
   written) and the bound of its launches' own work.  Then the runner (3 classes x
   2 queries, depth cut to 3 rounds, cap 64) serially (uncounted: the
   baseline), then with ``fused_sessions`` (one captured program of all of
   a session's rounds; the fused path's count), with ``query_batch = 4``
   (one captured program a cohort round, the second cohort of 2 padded to
   4 and replaying it; the cohort path's count starts here) and with both
   (one program of all of a cohort's rounds), each mode in four turns, graphed, eager, eager, graphed (``graphs.eager()``,
   uncounted): graphed picks and curves equal to eager, the posterior means
   after every program bit-equal (or within ``COHORT_MU_ATOL``); each
   stacked pick is replayed on its session alone and must agree up to MI
   ties, the fused runs must give the unfused runs' curves, and each turn's
   time is printed beside the serial run's.  Then over HTTP, in the same
   four turns on one server, eight ITAL sessions of four classes through
   ``/batch_select`` and ``/batch_feedback`` (one captured program each on
   the graphed turns, the second graphed turn with no new capture) for
   three rounds beside eight twins served one request at a time
   (uncounted), which absorb the same answers: graphed picks and means
   equal to eager, picks up to MI ties and each posterior mean within
   ``CPU_MU_ATOL`` of its twin's.  Every stacked request must launch the
   kernel; each request kind's host latency, its launches and the device
   memory a stacked request adds (in copies of one session's (cap, N) f32
   buffer, held to the server's budget model), and each program's warm-up,
   capture and instantiate ms, replays, launches, static buffers and pool
   growth, are printed with the card's name and power limit.  Last, mixed
   cohort traffic over HTTP in the same four turns: eight sessions, three
   of them after ``/learn`` (eager in the eager turns), through
   ``MIX_REQUESTS`` (cohorts of 2, 3, 4
   and 8 in varying orders and mixes of learned and default sessions, a
   ``/batch_select`` and a ``/batch_feedback`` each), twice: graphed picks
   equal eager picks, and the second graphed turn captures nothing (every
   program's stages held within ``graphs.STACK_BYTES``); per turn and pass
   the request latencies, the captures and their ms, the programs held,
   the stages' MiB and the graph pools' MiB.
9. sharded: the corpus-sharded path (``ital_tpu_torch.parallel``).  A mesh of
   one card must run on NCCL.  The kernel at the two whole-corpus shapes the
   100 000-row path adds, (64, 100000, 512) and (4, 100000, 512) f32, against
   its plain version, the tile route forced and its bound.  Then ``configs/scale100k.ini``
   (``corpus100k``, 100 000 x 512, ITAL, cap 64; depth cut to 1 class x 3
   rounds) through the runner with ``mesh_devices = 8``, which clamps to the
   card (a world of one on NCCL), beside the same configuration with
   ``mesh_devices = 0`` (uncounted: the baseline): picks agree round by round
   up to MI ties (``MI_TIE_ATOL``) and the AP curves while they do.  Then the
   same configuration's per-round select and update as mesh programs
   (``make_sharded_round``: a ``sharded_select`` and a ``sharded_absorb``
   graph with their collectives inside) on one NCCL mesh of one, one session
   in graphed, eager, eager, graphed turns: picks equal (else MI ties on the
   eager state), AP and ``mu`` within ``GRAPH_MU_ATOL`` while they agree, the
   first graphed turn capturing and the second none; select and update ms
   of every turn and each program's captures, launches per replay and
   static MiB.  The same
   for EMOC, MCMI[min] and SUD on the 25 000-row harness configuration (1
   class x 2 rounds), up to ``EMOC_TIE_RTOL``.  The kernel's launch count is
   reset before the sharded runs and must grow.  Select and update ms and
   the device memory peak of both paths are printed with the card's name
   and power limit.  Last, the memory one stacked selection and update of 8
   production sessions add at 100 000 rows, which with phase 8's at 25 000
   rows fits the server's select budget for ITAL (``serve.SELECT_BUDGET``:
   (cap, N) copies plus fixed bytes a session), held to it.

10. mesh programs: the mesh's fused and cohort programs and the mesh
   service (``parallel.sharded.make_sharded_session`` /
   ``make_sharded_cohort``, ``parallel.interactive``).  The kernel at the
   stacked shard shapes of a cohort of 4 at 100 000 rows, (16, 100000, 512)
   and (100000, 12, 512) f32, against its plain version and its bound.
   Then ``configs/scale100k.ini`` (100 000 x 512, depth cut to 2 classes x
   2 queries x 3 rounds) through the runner with ``query_batch = 4`` and
   ``fused_sessions``, and with ``fused_sessions`` alone, each on the mesh
   (clamped to the card) beside the plan on one device round by round
   (``query_batch = 4`` unfused, or the serial run; uncounted): picks agree
   round by round up to MI ties on the single-device state, the AP curves
   while they agree.  With two cards or more the cohort also runs
   on a world of 2 on NCCL; with one, a line says it did not.  Then the mesh
   service (``mesh_devices = 1``, NCCL) over ``corpus100k`` at the
   production selection options, cap 64: eight ITAL sessions through
   ``/batch_select`` and ``/batch_feedback`` for three rounds beside eight
   twins on a single-device service served one request at a time
   (uncounted), which absorb the same answers (picks up to MI ties, each
   mean within ``CPU_MU_ATOL`` of its twin's), then ``/ranking``, ``/learn``
   (against the twin's within ``LEARN_RTOL``) and ``/snapshot`` ->
   ``/restore``; the service is closed before the phase ends.  Each mesh
   program is also held to ``graphs.eager()`` in graphed, eager, eager,
   graphed turns on one NCCL mesh of one (the first graphed turn captures,
   the second replays): the fused session (``FUSED_SESSIONS`` a turn) and
   the fused cohort of 4 at 100 000 rows (picks and curves equal to eager,
   else MI ties on the per-round path's state); EMOC's mesh cohort selection
   of 4 at 25 000 rows as one stacked program against four single
   programs (picks up to EMOC ties); on the mesh service ``GET /batch``,
   ``/feedback`` (means within ``GRAPH_MU_ATOL``) and a ``/batch_select`` of
   8 sessions of two user models as one program against one per user model
   (picks up to MI ties), with the device's busy share of three replayed
   and three eager fetches (``torch.profiler``).  The launch
   count is reset before the mesh runs and must grow in every mesh request
   that forms RBF blocks; each request kind's host latency (device
   synchronized), launches and device memory peak, and each mode's cohort
   or session time, are printed with the card's name and power limit.
11. large cap: the per-round mesh past ``GP.chol2d_threshold``
   (``parallel.bigcap``, ``parallel.chol2d``: ``l`` in block-rows and a
   distributed refit every round).  The kernel at the refit's two shapes,
   (1024, 100000, 512) f32 with b2 and (1024, 1024, 512) f32, against its
   plain version and its bound.  Then ``configs/scale100k.ini`` at cap 1024
   and ``GP.chol2d_threshold = 1024`` with ITAL's production options (pool
   4096, n_qmc 32, top 64 re-scored at 512; the reference's own large-cap
   record), cut to 1 class x 3 rounds, on the mesh (clamped to the card),
   checkpointing every round, beside the same run with
   ``GP.chol2d_threshold = 0`` (the replicated factor, uncounted): the
   bigcap run must report ``"chol2d": True`` with one rank's ``l`` (cap / p,
   cap), its picks must agree round by round up to MI ties (on the
   replicated state) and its posterior mean within ``CPU_MU_ATOL`` while
   they do.  Its round-1 snapshot must load into the single-device
   ``load_session`` on the CPU with a (cap, cap) ``l``, and a copy resumed
   from it (uncounted) must give the uninterrupted curve.  The launch
   count is reset before the bigcap run; each round's absorption is one
   program (``bigcap_absorb``: the user, the labels, the distributed refit
   and AP, one CUDA graph with the collectives inside), replayed every
   round and launching the kernel's two blocks at each replay.  Select and
   update ms and the device memory peak of both runs, the refit's split
   (kernel blocks, Cholesky, beta, whitening, the rest, the whole refit as
   its program and eagerly; CUDA events) and its kernels by device time
   (``torch.profiler``) are printed with the card's name and power limit.
   Then the programs beside ``graphs.eager()`` (uncounted), in graphed,
   eager, eager, graphed turns: the runner's large-cap session (the
   checkpointing run is the first graphed turn), and on one NCCL mesh of
   one a session of the large-cap round with ``BIGCAP_FITS`` distributed
   refits (``bigcap_fit``) of its last state.  Graphed picks equal eager
   (else MI ties on the eager state), ``mu`` and AP within
   ``GRAPH_MU_ATOL`` while they agree, the refits' ``mu`` too, and the
   second graphed turn on the mesh captures nothing.  Each turn's select,
   update and refit ms, the device's busy share of three rounds, three
   refits and a whole run graphed and eager (``torch.profiler``), each
   program's captures, launches per replay, static buffers and pool
   growth, and the device memory an eager refit, round and session start
   allocate above what was held before them are printed with the card's
   name and power limit.

12. graphs: the round's compiled programs as captured CUDA graphs
   (``ital_tpu_torch.graphs``) beside their eager runs
   (``graphs.eager()``, uncounted).  The production session on a corpus
   of its own in four turns, graphed, eager, eager, graphed: picks equal
   round by round (else MI ties on the eager state) and the posterior mean
   within ``GRAPH_MU_ATOL`` while they agree; the second graphed session
   must replay the first one's programs with no new capture.  Fetch and
   update host ms of every turn, the device's busy share of three graphed
   and three eager fetches and updates (``torch.profiler``), each
   program's warm-up, capture and instantiate ms, replays, launches per
   replay and static buffers, and the graph pools' memory.  Then
   ``round_step`` at ``__graft_entry__.entry``'s example size and the
   serial harness at the production options (2 classes x 5 rounds),
   graphed against eager: equal AP, picks and MAP up to MI ties.  The
   launch count is reset before the graphed runs and counts the replays.
   Programs are counted by ``graphs.captures()`` and held by identity: a
   capture may release other programs.

13. learn: the hyperparameter ascent as programs.  ``/learn``
   (``RetrievalService.learn``, 50 steps) on two production sessions with
   three rounds of history each, in four turns, graphed, eager, eager,
   graphed, each history learned by a session and its twin: one
   ``relearn`` program (the ascent and the refit), replayed by the second
   history; learned values within ``LEARN_GRAPH_RTOL`` of eager, ``mu``
   after the refit bit-equal; the ascent's gradient at every step within
   ``LEARN_GRAPH_RTOL`` of eager (uncounted); the CPU's re-learn from the
   same state within ``LEARN_RTOL``; host ms of ``LEARN_TIMED`` re-learns
   a turn.  Then two fused cohorts of 4 x ``LEARN_COHORT_ROUNDS`` rounds at the
   production options with ``GP.learn_every = LEARN_EVERY``, graphed then
   eager: one program per cohort, its three stacked re-learns inside
   (held by identity and replays), graphed picks equal to eager up to the
   first MI tie (on the eager state) and the curves while they agree; its
   ms against eager and against the same cohort with learning off; each
   program's warm-up, capture and instantiate ms, replays, launches per
   replay, static buffers and pool growth.  The launch count is reset
   before the phase.

14. strategies: every strategy but ITAL (the 15 baselines and
   ``ital_regression``) as programs, on the 25 000 x 512 surrogate at the
   harness's settings (``configs/mirflickr.ini``; batch 4, cap 64).  First
   the kernel at the blocks their programs launch (the diversity penalties'
   (N, cap) and (N, t) similarity blocks, alone and for a stack of 8, EMOC's
   (N, 2048) and MCMI's (N, 512) column blocks) against its plain version
   and its bound.  Then, per strategy, on one service: a ``/batch_select``
   of 8 sessions with four user models (``RetrievalService.next_batch_many``)
   must be one program call, captured then replayed; its batches are held to
   8 twins fetched one at a time (uncounted) up to score ties
   (``EMOC_TIE_RTOL`` relative at the first parting, scored on the twin's
   state); the device memory it adds per session is printed in copies of a
   (cap, N) f32 buffer and held to the strategy's ``serve.SELECT_BUDGET``
   entry, which it is the source of; its time graphed and eager.  A twin's
   fetch in graphed, eager, eager, graphed turns (picks up to ties).  Then
   two fused cohorts of 4 x 3 rounds through the runner, one
   ``fused_session`` program call each (a capture, then a replay), the
   first cohort eager beside (uncounted): picks up to ties, the curves equal
   while the picks agree.  Each program's capture ms, launches per replay,
   static buffers and pool growth, and the graph pools' MiB, are printed
   with the card's name and power limit.  The launch count is reset before
   the phase's programs.

15. 1M rows: the JAX package's largest scale (``scripts/scale1m.py``,
   ``scripts/serve_throughput.py``'s ``corpus1m``), on ``corpus100k``'s
   generator at 1 000 000 x 512, built once on the host (its seconds
   printed) and stored in bfloat16, with the production [GP]/[USER]/[METHOD]
   at cap 64.  First the kernel at the path's 1M-row blocks: ``gp_fit``'s
   (64, N, 512) b2 in bf16 and f32, the update's (4, N, 512) b2 in bf16,
   the full scan's (N, 3, 512) a2 in bf16 and f32 and the pool's
   (4096, 3, 512) cross block, each against its plain version (within
   ``BF16_ATOL`` or ``F32_ATOL`` x var) and against the route the router
   did not pick, forced, with event ms, device us and its bound.
   Then one ``ActiveRetrieval`` over the bfloat16 corpus (rounded on the
   card, held bit-equal to the host's rounding; its norms f32 sums of the
   stored values): ``update_query`` and ``SCALE1M_ROUNDS`` graphed rounds
   of fetch, simulated user, update and AP (the path's count; the kernel
   must launch in every step), then fetches timed on the last state; init
   + query seconds, fetch, update and round ms, the device memory the
   session took and each program's static buffers, pool growth and launches
   per replay.  The round-``SCALE1M_MID`` state copied to the CPU must pick
   the card's batch up to MI ties and reach its posterior mean within
   ``CPU_MU_ATOL`` after the same update.  Last, the server over the same
   bfloat16 corpus over HTTP: ``SCALE1M_K`` sessions and
   ``SCALE1M_SERVE_ROUNDS`` rounds of ``/batch_select`` and
   ``/batch_feedback`` of all of them (the path's count); the second round
   captures nothing (the two stacked programs' shared stages held within
   ``graphs.STACK_BYTES``), every request that forms RBF blocks launches
   the kernel, and the device memory each cohort request adds per session
   is held to the server's budget and printed beside the 25 000/100 000-row
   fit; host ms per request kind with the card's name and power limit.
   Between the session and the server, one ``ital_regression`` fetch on
   the session's last state (its (K, t, N) solves through ``tri_solve``),
   uncounted, graphed / eager / eager / graphed: picks equal, host ms and
   launches per replay.

16. records: the reference's records at reduced depth, on the 25 000 x 512
   surrogate.  The method comparison's run function
   (``scripts/method_comparison_torch.py``) for ITAL at the production
   options and for ``random``, seed 0, 14 sessions in fused cohorts of 7,
   10 rounds: each final MAP must lie within the per-seed finals of its
   reference record (``results/mirflickr_methods_italpool.json``,
   ``results/mirflickr_methods.json``) and ITAL's above random's; both
   curves are printed beside the records' means.  Then the drift study
   (``scripts/drift_study_torch.py``) at cap 256 for 60 rounds with the
   noisy user: at rounds 20, 40 and 60 the appended posterior mean within
   ``DRIFT_MU_ATOL`` of the f64 oracle's and the oracle's top 100 kept to
   ``DRIFT_MIN_OVERLAP``.  The launch count is reset before the phase.

17. studies: the selection-config studies (``scripts/pool_refine_torch.py``,
   ``refine_study_torch.py``, ``pool_sweep_torch.py``,
   ``randomize_qmc_study_torch.py``, ``batch_size_timing_torch.py``,
   ``block_sweep_torch.py``) at reduced depth: one timing row of each at
   25 000 rows on the reference's mid-session state, graphed and eager, with
   its launches a call; then ``full 128`` at seed 0 (14 sessions in fused
   cohorts of 7) for ``STUDIES_ROUNDS`` rounds on the reference's user
   draws (``STUDIES_DRAWS``), its curve printed beside
   ``results/pool_refine_map_cpu.json``'s, each session's first pick within
   ``STUDIES_MI_TIE`` of the CPU's maximal MI at the query.  The launch
   count is reset just before that run and read just after it.

18. batch 8: the MI scan's default block (``select.ital.mi_block``, sized
   from its working set) at the largest MI batch.  ``full 128`` and ``full
   256`` at m = 8 (``scripts/mi_block_torch.py``) on the reference's
   mid-session state at 25 000 rows, eager then graphed, in one process
   beside the programs the earlier phases left, with no release by the
   script: a capture that runs out of device memory releases the
   single-device programs and captures again (``graphs.run``; the count
   it released is printed).  The launch count is reset just before and
   read just after.  Graphed picks equal eager; the blocks of every greedy
   step, the device-memory peak and the graph pool's growth are printed
   with the card's name and power limit; each step's pick of the eager run
   is held, before the graphed runs, to the CPU's MI over the card's top
   256 candidates and 2048 random rows (``mi_block_torch.REPLAY_TOP``,
   ``REPLAY_SAMPLE``, as the record's replay) up to ``MI_TIE_ATOL``.  Then two of
   the QMC study's problems (``scripts/qmc_error_study_torch.py``) at m = 8,
   n_qmc 256, the four estimators on the card within ``QMC_SMOKE_ATOL`` of
   the CPU's, and one row of each case of the router A/B
   (``scripts/pallas_ab_torch.py``) at ``AB_N`` rows through each route,
   timed graphed and eager and held to plain within ``F32_ATOL`` x var.

19. final: the port's last counterparts of the reference.  (a) The digits
   (``ital_tpu_torch/data/digits.npz``, no scikit-learn: the phase asserts
   that no ``sklearn`` module was imported in the process) through
   ``configs/digits.ini``'s fused cohorts of 5 for ``DIGITS_ROUNDS`` rounds,
   every pick equal to the CPU run's or, at its first parting, within
   ``MI_TIE_ATOL`` of the CPU's MI maximum on the CPU's state.  (b)
   ``scripts/round_term_split_torch.py``'s six terms at 25 000 rows on the
   reference's mid-session state, each one program timed graphed and eager
   with its launches a call (the timing uncounted; the path's count is one
   graphed and one eager call of each term): graphed outputs equal to
   eager's bit for bit, and ``round_full``'s batch, mean and AP equal to
   ``select``, the user, ``update`` and ``ap`` run one after the other.  (c) A fused learning
   cohort (``LEARN_FLOOR_OVERRIDES``: the heavy-noise user, GP noise 1.0,
   ``learn_prior_strength=1.0``, ``learn_noise_floor=0.05``, two re-learns)
   graphed and eager, picks and learned values equal, and on the CPU, its
   learned (length scale, variance, noise) within ``LEARN_RTOL`` where the
   picks agree (a parting held to ``MI_TIE_ATOL`` on the CPU's state).  The
   terms' kernel shapes are phase 3's and phase 4's (the update's
   (4, 25000, 512) b2 block, the pool's (4096, t, 512) and the batch's
   (t, t)).  The digits path's blocks are new: every block its card run
   called the kernel wrapper on (eagerly or at a capture: the 1797-row
   cross blocks, the update's, the cap's and the batch's, all 64 wide) is
   then held to the plain version within ``F32_ATOL`` x var and timed
   against its bound as in phase 3 (``shapes_digits``).  Each part's launch
   count is reset just before it and read just after.

The second-to-last line is a JSON object describing the kernel (launches on
the main paths in all, per route and per path, its bound, its time and the
plain version's, and its times at the 100 000-row shapes, at the mesh
cohort's stacked shard shapes, at the large-cap refit's shapes and at the
ascent's (64, 64, 512) block with its launches per ``/learn``, at the
strategies' blocks and at the 1M-row blocks, and each mesh, large-cap,
strategy and 1M-row program's launches per replay; ``launches_by_path``
includes ``records``, phase 16's, ``studies``, phase 17's, ``batch8``,
phase 18's, and ``digits``, ``round_terms`` and ``learn_floor``, phase
19's, with the terms' launches a call in ``launches_per_term_25k`` and the
digits path's blocks in ``shapes_digits``); the
last line is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import shutil
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path
from typing import Optional

import numpy as np

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "mirflickr_production.ini"
HARNESS_CONFIG = ROOT / "configs" / "mirflickr.ini"
# Depth cut to 1 class x 5 rounds; the labeled buffers keep the width the
# 10-round configuration sizes automatically (1 + 10 x 4 slots -> 48).
HARNESS_OVERRIDES = ("EXPERIMENT.max_classes=1", "EXPERIMENT.n_rounds=5", "GP.cap=48")
HARNESS_METHODS = ("ital", "emoc", "emoc_batch", "mcmi_min", "sud", "rbmal",
                   "uncertainty_sampling", "random")
# Strategies whose every selection forms RBF blocks (pool cross-kernels,
# EMOC/MCMI column blocks, similarity penalties).
KERNEL_SELECTING = {"ital", "emoc", "emoc_batch", "mcmi_min", "rbmal"}
# ... and those whose every selection forms whole-corpus blocks, which the
# tensor-core route takes.
WGMMA_SELECTING = {"emoc", "emoc_batch", "mcmi_min"}
REPLAY_ROUND = 2  # the EMOC checkpoint replayed on the CPU
WORK_DIR = ROOT / "build" / "chip_smoke"
SEED = 0
CAP = 64
MID_ROUND = 5  # round whose state is replayed on the CPU in phase 5
# The (cap, cap, D) block that gp_fit forms once and the ascent at every step.
ASCENT_SHAPE = "k_ll (64, 64, 512): gp_fit, the ascent"
F32_ATOL = 1e-5  # times var: f32 kernel vs plain f32
BF16_ATOL = 1e-4  # times var: bf16 kernel vs plain on the same bf16 values
CPU_MU_ATOL = 1e-4  # posterior mean, card vs CPU after one update
# MI scores of one candidate differ by up to ~1.4e-6 between the card and the
# CPU (f32, different transcendental implementations); a pick that differs by
# less than this is a tie.
MI_TIE_ATOL = 1e-5
# An EMOC score sums 25 000 |k_post| entries; card and CPU sum them in other
# orders, with kernel errors of up to ~2e-6 x var per entry, so picks whose
# scores differ by less than this fraction of the step's best score are ties.
EMOC_TIE_RTOL = 1e-4
# Phase 7: three serving rounds of batch 4; hyperparameters learned from one
# state on the card and on the CPU agree to this relative tolerance (the
# kernel's ~1e-6 relative error in K moves Adam's iterate by far less).
SERVE_ROUNDS = 3
SERVE_K = 4
LEARN_STEPS = 50
LEARN_RTOL = 1e-3
# Request kinds whose every request forms RBF blocks on the card.
KERNEL_REQUESTS = ("create with density", "query", "batch_select", "batch",
                   "batch_feedback", "feedback", "learn")
# Phase 8: the runner's cohorts of 4 (3 classes x 2 queries, 3 rounds: a full
# cohort and a padded one of 2) and the HTTP cohort of 8 sessions (4 classes x
# 2 queries) beside 8 twins.
COHORT_CLASSES = 3
COHORT_QB = 4
COHORT_ROUNDS = 3
COHORT_K = 8
COHORT_KINDS = ("batch_select", "batch", "batch_feedback", "feedback")
COHORT_MODES = {"fused": {"fused_sessions": True}, "query_batch": {"query_batch": COHORT_QB},
                "query_batch+fused": {"query_batch": COHORT_QB, "fused_sessions": True}}
# Graphed against eager stacked means where they are not bit-equal (a layout
# or a kernel route that differs between the program's buffers and eager's).
COHORT_MU_ATOL = 1e-7
# Phase 9: configs/scale100k.ini (100 000 x 512, mesh_devices = 8, clamped to
# the cards), depth cut to 1 class x 3 rounds; then the ring strategies on the
# harness configuration's 25 000 rows, 1 class x 2 rounds.
SCALE_CONFIG = ROOT / "configs" / "scale100k.ini"
SCALE_OVERRIDES = ("EXPERIMENT.max_classes=1", "EXPERIMENT.n_rounds=3")
RING_METHODS = ("emoc", "mcmi_min", "sud")
RING_OVERRIDES = HARNESS_OVERRIDES + ("EXPERIMENT.n_rounds=2",)
# Phase 10: configs/scale100k.ini cut to 2 classes x 2 queries x 3 rounds,
# fused sessions and cohorts of 4 on the mesh (clamped to the cards).
MESH_OVERRIDES = ("EXPERIMENT.max_classes=2", "EXPERIMENT.queries_per_class=2",
                  "EXPERIMENT.n_rounds=3")
MESH_QB = 4
# The mesh programs graphed against eager (phases 9 and 10): fused sessions
# a turn, and the second user model of the mixed /batch_select of 8.
FUSED_SESSIONS = 2
MIXED_LABEL_PROB, MIXED_MISTAKE_PROB = 0.95, 0.02
# Phase 11: the reference's own large-cap record (scripts/record_bigcap_session.py
# with the fast selection of results/bigcap_session_100k_fastsel.json).
BIGCAP_OVERRIDES = SCALE_OVERRIDES + (
    "GP.cap=1024", "GP.chol2d_threshold=1024", "METHOD.pool_size=4096", "METHOD.n_qmc=32",
    "METHOD.refine_top=64", "METHOD.refine_n_qmc=512")
BIGCAP_FITS = 3  # distributed refits timed a turn
# Phase 12: the captured programs beside their eager runs.  The production
# session's 10 rounds in turns graphed, eager, eager, graphed; entry's round
# step at its example size (__graft_entry__._make_state: 2048 x 64, ls 6, cap
# 64, query 7); the serial harness at the production options cut to 2
# classes x 5 rounds.  Graphed and eager run the same kernels on the same
# inputs, so the means are expected bit-equal.
GRAPH_TURNS = ("graphed", "eager", "eager", "graphed")
GRAPH_MU_ATOL = 1e-6
ROUND_STEPS = 5
ENTRY_SHAPE = {"n": 2048, "d": 64, "cap": 64, "ls": 6.0, "query": 7}
GRAPH_HARNESS_OVERRIDES = ("EXPERIMENT.max_classes=2", "EXPERIMENT.n_rounds=5")
# Phase 15: the JAX package's largest scale (scripts/scale1m.py and
# scripts/serve_throughput.py's corpus1m): corpus100k's generator at 1M x 512,
# stored in bfloat16, the production [GP]/[USER]/[METHOD] at cap 64.
SCALE1M_N = 1_000_000
SCALE1M_DTYPE = "bfloat16"
SCALE1M_ROUNDS = 3
SCALE1M_MID = 2  # the round whose state the CPU replays
SCALE1M_FETCHES = 5  # fetches timed on the last state (uncounted)
SCALE1M_K = 8  # sessions of the server's cohort
SCALE1M_SERVE_ROUNDS = 2
SCALE1M_REGRESSION_CALLS = 3  # ital_regression fetches a turn
# ITAL's select budget fitted at 25 000 and 100 000 rows (phases 8-9): (cap, N)
# copies and fixed bytes a session, held at 1M rows.
SELECT_FIT = (1.07, 89.0 * 2**20)
# Phase 13: /learn's programs and a fused learning cohort of 4 x 6 rounds.
LEARN_GRAPH_RTOL = 1e-6  # learned values and gradients, graphed vs eager on the card
LEARN_TIMED = 3  # re-learns timed per turn
LEARN_COHORT_ROUNDS = 6
LEARN_EVERY = 2
# The card's published peaks (H100 SXM, dense), for the kernel's bound: HBM
# bytes per second, and TF32 and bf16 tensor operations per second (the f32
# route does its products as 3xTF32: three TF32 products per f32 one).
HBM_BYTES_PER_S = 3.35e12
TF32_OPS_PER_S = 495e12
BF16_OPS_PER_S = 989e12


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def rbf_bound_ms(m: int, n: int, d: int, bf16: bool, norms: int,
                 same: bool = False) -> tuple[float, str]:
    """The least time the card could take for one (M, N, D) RBF block, and
    which of bytes and operations sets it.

    Bytes: a and b read once (once in all where ``same``: b is a's rows, as
    in a labeled set's own block K(xl, xl)), the ``norms`` given f32 norm
    vectors (their entries) read once, the f32 output written once.
    Operations: the 2 M N D of the product, three times over in TF32 for f32
    inputs (3xTF32), once in bf16 for a bf16 corpus.
    """
    item = 2 if bf16 else 4
    nbytes = (m if same else m + n) * d * item + 4 * norms + 4 * m * n
    ops = 2.0 * m * n * d * (1 if bf16 else 3)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / (BF16_OPS_PER_S if bf16 else TF32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_phase(torch) -> tuple[str, str]:
    check(torch.cuda.is_available(), "torch.cuda.is_available() (a CUDA device is required)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}; torch {torch.__version__}; CUDA {torch.version.cuda}; "
          f"devices {torch.cuda.device_count()}")
    return kind, smi


def build_phase() -> float:
    from ital_tpu_torch.ops import _build, rbf_hopper

    t0 = time.perf_counter()
    lib = _build.build()
    rbf_hopper._library()
    secs = time.perf_counter() - t0
    print(f"build: {secs:.3f} s -> {lib.relative_to(ROOT)}")
    log = lib.with_suffix(".so.log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas: {line.strip()}")
    return secs


def _time_turns_ms(torch, fns, launches: int = 50, runs: int = 5,
                   warmup: int = 3) -> list[tuple[float, float]]:
    """Per-launch CUDA-event times of each of ``fns``, taken in turns.

    Each run records two events around ``launches`` back-to-back launches of
    one version and divides by their count; every run goes through all the
    versions, the order rotated from run to run.  Returns, per version, the
    median over ``runs`` runs and their spread (max - min).
    """
    for _ in range(warmup):
        for fn in fns:
            fn()
    times = [[] for _ in fns]
    for r in range(runs):
        for i in [(r + j) % len(fns) for j in range(len(fns))]:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(launches):
                fns[i]()
            end.record()
            end.synchronize()
            times[i].append(start.elapsed_time(end) / launches)
    return [(float(np.median(t)), float(max(t) - min(t))) for t in times]


SLEEP_CYCLES = 50_000_000  # the sleep kernel queued ahead of a device-time reading (~25 ms)


def _device_us(torch, fn, launches: int = 20) -> float:
    """Device time per launch of the kernel that ``fn`` launches: the median,
    over ``launches`` launches, of the device-clock time between two CUDA
    events recorded just before and just after it on the stream.  A sleep
    kernel queued first keeps the host ahead of the device, so no launch
    waits on the host and each interval holds the kernel alone.

    ``torch.profiler``'s CUDA records are not used: late in this process it
    kept 8-17 of 20 kernel records a reading, and once kept all 20 at less
    than half their length (59.37 us for the mesh cohort's 123 us kernel,
    under its 63.17 us bound), which failed the bound check on a sound
    kernel."""
    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(launches)]
    torch.cuda._sleep(SLEEP_CYCLES)
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([start.elapsed_time(end) for start, end in pairs])) * 1e3


def _check_bound(what: str, ms: float, dev_us: float, bound_ms: float) -> None:
    """A kernel cannot beat its bound: an event time or a device time more
    than 3 % under it is a faulty measurement, not a fast kernel."""
    for name, t in (("event time", ms), ("device time", dev_us * 1e-3)):
        check(t >= 0.97 * bound_ms,
              f"{what}: {name} {t * 1e3:.2f} us is under its bound {bound_ms * 1e3:.2f} us")


def _kernel_case(torch, name, a, b, norms, l, v, atol) -> dict:
    """One block through ``rbf_kernel`` (its route counted once), each route
    and the plain version: every route within ``atol`` x var of plain, timed
    against its bound, the chosen route no slower than the tile kernel.
    Returns the shape's record (with ``worst``, the largest error of any
    route)."""
    from ital_tpu_torch.ops import rbf_hopper
    from ital_tpu_torch.ops.kernels import rbf_kernel, rbf_kernel_plain

    m, d = a.shape
    route = rbf_hopper.choose_route(m, b.shape[0], d, a.dtype, a.data_ptr(), b.data_ptr())
    fns = {"plain": lambda: rbf_kernel_plain(a, b, l, v, **norms),
           "tile": lambda: rbf_hopper.rbf_tile(a, b, l, v, _route="tile", **norms)}
    if rbf_hopper.wgmma_takes(m, b.shape[0], d, a.dtype, a.data_ptr(), b.data_ptr()):
        fns["wgmma"] = lambda: rbf_hopper.rbf_tile(a, b, l, v, _route="wgmma", **norms)
    before = dict(rbf_hopper.ROUTE_LAUNCHES)
    got = rbf_kernel(a, b, l, v, **norms)
    check(rbf_hopper.ROUTE_LAUNCHES[route.name] == before[route.name] + 1,
          f"{name}: rbf_kernel launched the {route.name} route")
    want = fns["plain"]()
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == torch.float32, f"{name}: shape/dtype")
    tol = atol * float(v)
    errs = {r: float((fns[r]() - want).abs().max()) for r in fns if r != "plain"}
    err = float((got - want).abs().max())
    timed = dict(zip(fns, _time_turns_ms(torch, list(fns.values()))))
    dev_us = {r: _device_us(torch, fns[r]) for r in errs}
    ms, spread = timed[route.name]
    bound, bound_by = rbf_bound_ms(m, b.shape[0], d, a.dtype == torch.bfloat16,
                                   sum(v.numel() for v in norms.values()), same=a is b)
    print(f"kernel: {name}: bound {bound * 1e3:.2f} us ({bound_by}); "
          f"route {route.name} (variant {route.variant}, transposed "
          f"{route.transposed}); max_abs_err {err:.3e} (atol {tol:.1e}; per route "
          + ", ".join(f"{r} {e:.3e}" for r, e in errs.items()) + "); per launch ms "
          + ", ".join(f"{r} {t:.4f} (spread {sp:.4f})" for r, (t, sp) in timed.items())
          + "; device us per launch " + ", ".join(f"{r} {u:.2f}" for r, u in dev_us.items()))
    for r, e in errs.items():
        check(e <= tol, f"{name}: {r} route max_abs_err {e} > {tol}")
        _check_bound(f"{name} {r} route", timed[r][0], dev_us[r], bound)
    check(err <= tol, f"{name}: max_abs_err {err} > {tol}")
    tile_ms, tile_spread = timed["tile"]
    check(ms <= tile_ms + max(spread, tile_spread),
          f"{name}: the chosen route ({ms} ms) is not slower than the tile kernel "
          f"({tile_ms} ms) beyond the runs' spread")
    return {"ms": ms, "plain_ms": timed["plain"][0], "bound_ms": bound, "bound_by": bound_by,
            "max_abs_err": err, "worst": max(err, *errs.values())}


def kernel_phase(torch, ds) -> dict:
    """Both routes and the plain version at the session's and the harness's
    shapes; returns the JSON record's numbers."""
    from ital_tpu_torch.ops import rbf_hopper

    dev = torch.device("cuda")
    x = torch.from_numpy(ds.x).to(dev)
    x2 = (x * x).sum(-1)
    xb = x.to(torch.bfloat16)
    xb2 = (xb.float() * xb.float()).sum(-1)
    n = x.shape[0]
    rng = np.random.default_rng(SEED)
    pick = lambda k: torch.from_numpy(rng.choice(n, size=k, replace=False)).to(dev)
    i64, i4, i3, i4096 = pick(64), pick(4), pick(3), pick(4096)
    i2048, i512, i48 = pick(2048), pick(512), pick(48)
    xl = x[i64]  # a labeled set, whose own block the fit and the ascent form
    ls = torch.tensor(50.0, device=dev)
    var = torch.tensor(1.0, device=dev)
    # name, a, b, norms, length scale, var, atol (times var)
    cases = [
        ("gp_fit cross (64, 25000, 512) b2", x[i64], x, {"b2": x2}, ls, var, F32_ATOL),
        ("gp_update cross (4, 25000, 512) b2", x[i4], x, {"b2": x2}, ls, var, F32_ATOL),
        ("pool cross (4096, 3, 512)", x[i4096], x[i3], {}, ls, var, F32_ATOL),
        (ASCENT_SHAPE, xl, xl, {}, ls, var, F32_ATOL),
        ("cov columns (25000, 3, 512) a2", x, x[i3], {"a2": x2}, ls, var, F32_ATOL),
        ("ragged (100, 300, 8)", x[:100, :8].contiguous(), x[100:400, :8].contiguous(), {},
         torch.tensor(4.0, device=dev), torch.tensor(0.9, device=dev), F32_ATOL),
        ("bf16 (64, 25000, 512) b2", xb[i64], xb, {"b2": xb2}, ls, var, BF16_ATOL),
        ("emoc block (25000, 2048, 512) a2 b2", x, x[i2048], {"a2": x2, "b2": x2[i2048]},
         ls, var, F32_ATOL),
        ("mcmi block (25000, 512, 512) a2", x, x[i512], {"a2": x2}, ls, var, F32_ATOL),
        ("density block (2048, 25000, 512) a2 b2", x[:2048], x, {"a2": x2[:2048], "b2": x2},
         ls, var, F32_ATOL),
        ("similarity (25000, 48, 512) a2", x, x[i48], {"a2": x2}, ls, var, F32_ATOL),
        ("ragged (129, 257, 100)", x[:129, :100].contiguous(), x[200:457, :100].contiguous(), {},
         torch.tensor(20.0, device=dev), torch.tensor(0.9, device=dev), F32_ATOL),
        ("bf16 emoc block (25000, 2048, 512) a2 b2", xb, xb[i2048],
         {"a2": xb2, "b2": xb2[i2048]}, ls, var, BF16_ATOL),
    ]
    by_shape = {name: _kernel_case(torch, name, a, b, norms, l, v, atol)
                for name, a, b, norms, l, v, atol in cases}
    worst = max(r.pop("worst") for r in by_shape.values())
    main = by_shape[cases[0][0]]
    check(all(c > 0 for c in rbf_hopper.ROUTE_LAUNCHES.values()), "both routes launched in phase 3")
    return {"max_abs_err": worst, "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"], "by_shape": by_shape}


def session_phase(torch, ds, cfg, dev) -> dict:
    from ital_tpu_torch.data.user import simulate_feedback
    from ital_tpu_torch.models import gp as gp_mod
    from ital_tpu_torch.models.session import ActiveRetrieval
    from ital_tpu_torch.ops import rbf_hopper
    from ital_tpu_torch.utils.metrics import average_precision

    x = torch.from_numpy(ds.x).to(dev)
    sess = ActiveRetrieval(
        x, length_scale=cfg.gp.length_scale, var=cfg.gp.var, noise=cfg.gp.noise,
        cap=CAP, strategy=cfg.method, label_prob=cfg.user.label_prob,
        mistake_prob=cfg.user.mistake_prob, seed=SEED,
        method_kwargs=cfg.method_kwargs, corpus_dtype=cfg.gp.corpus_dtype or None,
    )
    rng = np.random.default_rng(SEED)
    cls = int(rng.choice(ds.classes))
    q = int(ds.queries_for_class(cls, rng, 1)[0])
    relevant = torch.from_numpy(ds.relevance[:, cls]).to(dev)
    exclude = torch.zeros(ds.n, dtype=torch.bool, device=dev)
    exclude[q] = True
    gen = torch.Generator(device=dev).manual_seed(SEED)
    k = cfg.batch_size
    torch.cuda.synchronize()

    _reset_counts()  # the main path's count starts here
    t0 = time.perf_counter()
    sess.update_query(q)
    torch.cuda.synchronize()
    query_ms = (time.perf_counter() - t0) * 1e3
    check(rbf_hopper.LAUNCHES > 0, "kernel launched in update_query")
    print(f"session: query {q} (class {cls}); update_query {query_ms:.3f} ms, "
          f"launches {rbf_hopper.LAUNCHES}")

    labeled = {q}
    fetch_ms, update_ms, aps = [], [], []
    mid = None
    for r in range(cfg.n_rounds):
        before = rbf_hopper.LAUNCHES
        snapshot = gp_mod.state_to_arrays(sess.state) if r == MID_ROUND else None
        t0 = time.perf_counter()
        batch = sess.fetch_unlabelled(k)  # returns host indices: synchronizes
        t1 = time.perf_counter()
        check(len(set(batch.tolist())) == k, f"round {r}: {k} distinct indices {batch}")
        check(bool(((batch >= 0) & (batch < ds.n)).all()), f"round {r}: indices in range")
        check(not (set(batch.tolist()) & labeled), f"round {r}: batch avoids labeled items")
        y, valid = simulate_feedback(gen, torch.as_tensor(batch, device=dev), relevant,
                                     sess.params.label_prob, sess.params.mistake_prob)
        fb = {int(i): (int(yy) if vv else 0)
              for i, yy, vv in zip(batch.tolist(), y.tolist(), valid.tolist())}
        t2 = time.perf_counter()
        sess.update(fb)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        ap = float(average_precision(sess.state.mu, relevant, exclude))
        check(rbf_hopper.LAUNCHES > before, f"round {r}: kernel launched")
        labeled |= {i for i, v in fb.items() if v}
        fetch_ms.append((t1 - t0) * 1e3)
        update_ms.append((t3 - t2) * 1e3)
        aps.append(ap)
        print(f"round {r}: batch {batch.tolist()} feedback {list(fb.values())} "
              f"fetch {fetch_ms[-1]:.3f} ms update {update_ms[-1]:.3f} ms AP {ap:.6f}")
        if snapshot is not None:
            mid = {"arrays": snapshot, "batch": batch, "feedback": fb,
                   "mu": sess.scores()}
    launches = dict(rbf_hopper.ROUTE_LAUNCHES)

    st = sess.state
    check(st.count == 1 + cfg.n_rounds * k, f"count {st.count} == {1 + cfg.n_rounds * k}")
    check(bool(torch.isfinite(st.mu).all() and torch.isfinite(st.sig2).all()),
          "mu and sig2 finite")
    check(all(np.isfinite(aps)), "AP finite")
    print(f"session: AP curve {[round(a, 6) for a in aps]}")
    print(f"session: fetch ms {[round(t, 3) for t in fetch_ms]}")
    print(f"session: update ms {[round(t, 3) for t in update_ms]}")
    print(f"session: median fetch {np.median(fetch_ms):.3f} ms, median update "
          f"{np.median(update_ms):.3f} ms, launches by route {launches}")
    return {"launches": launches, "mid": mid}


def _tie_gaps(sess, card_batch, kw) -> list[float]:
    """Replay the card's greedy picks on ``sess`` (the CPU) step by step.

    At each step, with the card's picks so far as the partial batch, the CPU
    makes its own pick; where it differs from the card's, the refined MI of
    the CPU's pick minus that of the card's is that step's gap (0 where they
    agree).  A gap within ``MI_TIE_ATOL`` is a tie at f32 resolution.
    """
    import torch
    from ital_tpu_torch.select import ital

    st, p = sess.state, sess.params
    pool_idx, forbid = ital.candidate_pool_indices(st, st.mu, min(kw["pool_size"], st.x.shape[0]))
    local = {g: i for i, g in enumerate(pool_idx.tolist())}
    x_pool, v_pool = st.x[pool_idx], st.v[:, pool_idx]
    mu_pool, sig2_pool = st.mu[pool_idx], st.sig2[pool_idx] + p.jitter
    card = torch.as_tensor(card_batch, device=st.idx.device)
    gaps = []
    for t in range(card.shape[0]):
        theirs = local.get(int(card[t]))
        check(theirs is not None and not bool(forbid[theirs]),
              f"step {t}: the card's pick {int(card[t])} is an eligible pool member")
        mu_b, cov_bb, cross = ital.pool_batch_moments(st, p, x_pool, v_pool, card[:t])
        scores = ital.mi_scores_from_moments(mu_pool, sig2_pool, cross, mu_b, cov_bb, p,
                                             t=t, n_qmc=kw["n_qmc"])
        scores = torch.where(forbid, -torch.inf, scores)
        own = int(ital.refined_pick(scores, mu_pool, sig2_pool, cross, mu_b, cov_bb, p, t=t,
                                    refine_top=kw["refine_top"], refine_n_qmc=kw["refine_n_qmc"]))
        gap = 0.0
        if own != theirs:
            pair = torch.tensor([own, theirs], device=st.idx.device)
            r = ital.mi_scores_from_moments(mu_pool[pair], sig2_pool[pair], cross[pair], mu_b,
                                            cov_bb, p, t=t, n_qmc=kw["refine_n_qmc"])
            gap = float(r[0] - r[1])
        gaps.append(gap)
        forbid[theirs] = True
    return gaps


def cpu_phase(torch, ds, cfg, mid, corpus_dtype=None, what: str = "cpu") -> None:
    """Replay the mid-session round on the CPU's plain path from the same state
    (a corpus of ``corpus_dtype``, as the card's)."""
    from ital_tpu_torch.models import gp as gp_mod
    from ital_tpu_torch.models.session import ActiveRetrieval

    sess = ActiveRetrieval(
        ds.x, length_scale=cfg.gp.length_scale, var=cfg.gp.var, noise=cfg.gp.noise,
        cap=CAP, strategy=cfg.method, label_prob=cfg.user.label_prob,
        mistake_prob=cfg.user.mistake_prob, seed=SEED,
        method_kwargs=cfg.method_kwargs, corpus_dtype=corpus_dtype, device="cpu",
    )
    sess.state = gp_mod.state_from_arrays(mid["arrays"], "cpu")
    if corpus_dtype:  # the carrier hands a bfloat16 corpus back as float32
        sess.state.x = sess.state.x.to(getattr(torch, corpus_dtype))
    batch = sess.fetch_unlabelled(cfg.batch_size)
    same = bool(np.array_equal(batch, mid["batch"]))
    print(f"{what}: batch {batch.tolist()} (card {mid['batch'].tolist()}), equal: {same}")
    if not same:
        # The production pool's low-mean edge saturates MI: many candidates
        # score the same to f32 resolution, and the two devices' last-ulp
        # differences pick different members of a tie.
        gaps = _tie_gaps(sess, mid["batch"], cfg.method_kwargs)
        print(f"{what}: per-step refined-MI gap, CPU pick minus card pick: {gaps} "
              f"(tie atol {MI_TIE_ATOL})")
        check(all(abs(g) <= MI_TIE_ATOL for g in gaps),
              f"{what}: card and CPU batches differ only by ties")
    sess.update(mid["feedback"])
    err = float(np.abs(sess.state.mu.numpy() - mid["mu"]).max())
    print(f"{what}: max |mu_cpu - mu_card| after the update {err:.3e} (atol {CPU_MU_ATOL})")
    check(err <= CPU_MU_ATOL, f"{what}: mu card vs CPU {err} > {CPU_MU_ATOL}")


def _reset_counts() -> None:
    from ital_tpu_torch.ops import rbf_hopper

    rbf_hopper.reset_launch_counts()


@contextlib.contextmanager
def _watch_selections(name: str, on_call):
    """Call ``on_call(launches, wgmma_launches, batch)`` after each selection of
    strategy ``name``, with the kernel launches that selection made (all, and
    those of the tensor-core route)."""
    from ital_tpu_torch.ops import rbf_hopper
    from ital_tpu_torch.select.base import STRATEGIES

    orig = STRATEGIES[name]

    @functools.wraps(orig)
    def watched(*args, **kwargs):
        before = rbf_hopper.LAUNCHES
        before_wgmma = rbf_hopper.ROUTE_LAUNCHES["wgmma"]
        batch = orig(*args, **kwargs)
        on_call(rbf_hopper.LAUNCHES - before, rbf_hopper.ROUTE_LAUNCHES["wgmma"] - before_wgmma,
                batch)
        return batch

    STRATEGIES[name] = watched
    try:
        yield
    finally:
        STRATEGIES[name] = orig


def harness_phase(torch, ds, dev) -> dict:
    """The experiment harness on ``dev`` for each of ``HARNESS_METHODS``.

    Returns the kernel launches of the phase and what the CPU replay needs:
    a copy of the EMOC session's round-``REPLAY_ROUND`` checkpoint and the
    batch the card picked from it.
    """
    from ital_tpu_torch import runner
    from ital_tpu_torch.ops import rbf_hopper
    from ital_tpu_torch.utils.config import load_config

    base = load_config(str(HARNESS_CONFIG), HARNESS_OVERRIDES)
    production = load_config(str(CONFIG))
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    ckpt_dir = WORK_DIR / "checkpoints"
    replay = {"path": WORK_DIR / f"emoc_round{REPLAY_ROUND}.npz", "cfg": None, "batch": None}
    n_sessions = base.max_classes * base.queries_per_class * base.repetitions
    torch.cuda.synchronize()

    _reset_counts()  # the main path's count starts here
    for method in HARNESS_METHODS:
        cfg = dataclasses.replace(
            base, method=method,
            method_kwargs=dict(production.method_kwargs) if method == "ital" else {},
            checkpoint_dir=str(ckpt_dir) if method == "emoc" else None,
        )
        calls, wgmma_calls = [], []

        def on_call(launches, wgmma, batch, cfg=cfg, calls=calls, wgmma_calls=wgmma_calls):
            if cfg.checkpoint_dir and len(calls) == REPLAY_ROUND:
                # The first session's checkpoint now holds the state this pick came from.
                (saved,) = Path(cfg.checkpoint_dir).glob("*.npz")
                shutil.copy(saved, replay["path"])
                replay.update(cfg=cfg, batch=batch.cpu().numpy())
            calls.append(launches)
            wgmma_calls.append(wgmma)

        before = rbf_hopper.LAUNCHES
        with _watch_selections(method, on_call):
            res = runner.run_experiment(cfg, ds, device=dev)
        launches = rbf_hopper.LAUNCHES - before
        check(res["ap"].shape == (n_sessions, cfg.n_rounds), f"{method}: AP shape {res['ap'].shape}")
        check(bool(np.isfinite(res["ap"]).all()), f"{method}: AP finite")
        check(len(calls) == n_sessions * cfg.n_rounds, f"{method}: {len(calls)} selections")
        if method in KERNEL_SELECTING:
            check(all(c > 0 for c in calls), f"{method}: the kernel launched in every selection")
        if method in WGMMA_SELECTING:
            check(all(c > 0 for c in wgmma_calls),
                  f"{method}: the tensor-core route launched in every selection")
        print(f"harness {method}: MAP {[round(float(m), 6) for m in res['map']]}; select "
              f"{res['select_ms']:.3f} ms mean, {res['select_ms_steady']:.3f} ms steady; update "
              f"{res['update_ms']:.3f} ms mean, {res['update_ms_steady']:.3f} ms steady; first "
              f"round {res['first_round_ms']:.1f} ms; launches {launches} "
              f"({min(calls)}-{max(calls)} per selection, {min(wgmma_calls)}-{max(wgmma_calls)} "
              f"on the tensor-core route) on {res['device']}")
    _learn_run(runner, base, production, ds, dev)
    launches = dict(rbf_hopper.ROUTE_LAUNCHES)
    check(replay["batch"] is not None, "the EMOC round-2 checkpoint was captured")
    return {"launches": launches, "replay": replay}


def _learn_run(runner, base, production, ds, dev) -> None:
    """ITAL with ``GP.learn_every=2``, 1 class x 4 rounds: the logged
    hyperparameters must be finite and the length scale must move."""
    from ital_tpu_torch.ops import rbf_hopper

    import torch

    log = WORK_DIR / "learn_every.jsonl"
    cfg = dataclasses.replace(
        base, method="ital", method_kwargs=dict(production.method_kwargs), max_classes=1,
        n_rounds=4, gp=dataclasses.replace(base.gp, learn_every=2), log_jsonl=str(log))
    before = rbf_hopper.LAUNCHES
    relearn, relearn_ms = runner._relearn_hyperparams, []

    def timed(state, c):  # the re-learn program, synchronized
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = relearn(state, c)
        torch.cuda.synchronize()
        relearn_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    runner._relearn_hyperparams = timed
    try:
        res = runner.run_experiment(cfg, ds, device=dev)
    finally:
        runner._relearn_hyperparams = relearn
    rows = [json.loads(line) for line in log.read_text().splitlines()]
    hyper = [(r["length_scale"], r["gp_var"], r["gp_noise"]) for r in rows]
    print(f"harness ital learn_every=2: MAP {[round(float(m), 6) for m in res['map']]}; "
          f"(length_scale, var, noise) per round {hyper}; select {res['select_ms']:.3f} ms "
          f"mean, {res['select_ms_steady']:.3f} steady; update {res['update_ms']:.3f} ms mean, "
          f"{res['update_ms_steady']:.3f} steady; re-learn (one program, synchronized) ms "
          f"{[round(t, 3) for t in relearn_ms]} (the first with its capture); launches "
          f"{rbf_hopper.LAUNCHES - before}")
    check(len(rows) == cfg.n_rounds and bool(np.isfinite(res["ap"]).all()), "learn_every: AP rows")
    check(all(np.isfinite(h).all() and min(h) > 0 for h in hyper),
          "learn_every: finite positive hyperparameters")
    check(hyper[-1][0] != cfg.gp.length_scale, "learn_every: the length scale moved")


def _user(rng, ds, label_prob: float, mistake_prob: float):
    """The simulated user's answers for a batch, as ``/feedback`` labels:
    each item labeled with ``label_prob`` (else skipped, 0), its relevance to
    class ``c`` flipped with ``mistake_prob``; draws from ``rng`` in order."""
    def answer(batch, c):
        out = {}
        for i in batch:
            y = 0
            if rng.random() < label_prob:
                y = 1 if ds.relevance[i, c] else -1
                if rng.random() < mistake_prob:
                    y = -y
            out[str(i)] = y
        return out

    return answer


def serve_phase(torch, ds, cfg, dev, smi: str) -> dict:
    """The serving layer over HTTP on ``dev``, with a CPU service beside it."""
    from ital_tpu_torch import serve
    from ital_tpu_torch.ops import rbf_hopper

    svc = serve.service_from_config(cfg, device=dev)
    cpu_svc = serve.service_from_config(cfg, device="cpu")
    srv = serve.make_server(svc, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    times, launches = {}, {}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def call(kind, method, path, body=None, raw=False):
        """One request; its host time runs until the device is idle again."""
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(base + path, data=data, method=method,
                                     headers={"Content-Type": "application/json"})
        before = rbf_hopper.LAUNCHES
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=600) as resp:
                payload = resp.read()
        except urllib.error.HTTPError as e:
            raise RuntimeError(f"{method} {path}: HTTP {e.code} {e.read()!r}") from e
        sync()
        times.setdefault(kind, []).append((time.perf_counter() - t0) * 1e3)
        launches.setdefault(kind, []).append(rbf_hopper.LAUNCHES - before)
        return payload if raw else json.loads(payload)

    try:
        rng = np.random.default_rng(SEED + 7)
        c1, c2 = (int(c) for c in rng.choice(ds.classes, 2, replace=False))
        q1 = int(ds.queries_for_class(c1, rng, 1)[0])
        q2 = int(ds.queries_for_class(c2, rng, 1)[0])
        user = _user(rng, ds, cfg.user.label_prob, cfg.user.mistake_prob)
        sync()
        _reset_counts()  # this path's count starts here
        health = call("healthz", "GET", "/healthz")
        check(health["n"] == ds.n and health["device"].startswith(dev.type), f"healthz {health}")
        sessions = {  # name -> (POST /sessions body, query, class)
            "twin_cohort": ({}, q1, c1),
            "twin_single": ({}, q1, c1),
            "randomize_qmc": ({"method_kwargs": {"randomize_qmc": True}}, q2, c2),
            "subsample": ({"method_kwargs": {"subsample_size": 4096, "pool_size": 0}}, q2, c2),
            "sud": ({"strategy": "sud"}, q1, c1),
        }
        sid = {}
        for name, (body, q, _) in sessions.items():
            kind = "create with density" if body.get("strategy") == "sud" else "create"
            sid[name] = call(kind, "POST", "/sessions", body)["session_id"]
            call("query", "POST", f"/sessions/{sid[name]}/query", {"index": q})
        labeled = {name: {q} for name, (_, q, _) in sessions.items()}
        cohort = [n for n in sessions if n != "twin_single"]
        for r in range(SERVE_ROUNDS):
            picks = call("batch_select", "POST", "/batch_select",
                         {"session_ids": [sid[n] for n in cohort], "k": SERVE_K})["batches"]
            picks = {n: picks[sid[n]] for n in cohort}
            single = call("batch", "GET", f"/sessions/{sid['twin_single']}/batch?k={SERVE_K}")
            picks["twin_single"] = single["batch"]
            for name, batch in picks.items():
                check(len(set(batch)) == SERVE_K and all(0 <= i < ds.n for i in batch),
                      f"round {r} {name}: {SERVE_K} distinct indices in range {batch}")
                check(not set(batch) & labeled[name], f"round {r} {name}: batch avoids labels")
            if picks["twin_cohort"] != picks["twin_single"]:
                twin, _ = svc._entry(sid["twin_single"])
                gaps = _tie_gaps(twin, picks["twin_cohort"], twin.method_kwargs)
                print(f"serve round {r}: cohort {picks['twin_cohort']} vs single "
                      f"{picks['twin_single']}; refined-MI gaps {gaps} (tie atol {MI_TIE_ATOL})")
                check(all(abs(g) <= MI_TIE_ATOL for g in gaps),
                      "cohort and single twin batches differ only by ties")
            answers = {n: user(picks[n], sessions[n][2]) for n in cohort}
            got = call("batch_feedback", "POST", "/batch_feedback",
                       {"feedback": {sid[n]: answers[n] for n in cohort}})["sessions"]
            # The twin absorbs the cohort twin's answers: one history for both.
            answers["twin_single"] = answers["twin_cohort"]
            got_single = call("feedback", "POST", f"/sessions/{sid['twin_single']}/feedback",
                              {"labels": answers["twin_single"]})
            want = 1 + (r + 1) * SERVE_K
            check(all(got[sid[n]] == {"labeled": want} for n in cohort)
                  and got_single == {"labeled": want}, f"round {r}: labeled {got} {got_single}")
            for name, ans in answers.items():
                labeled[name] |= {int(i) for i, y in ans.items() if y}
            print(f"serve round {r}: " + "; ".join(
                f"{n} {picks[n]} {list(answers[n].values())}" for n in sessions))

        a = sid["twin_cohort"]
        rank = call("ranking", "GET", f"/sessions/{a}/ranking?k=20")
        check(len(rank["top"]) == 20 and all(np.isfinite(rank["scores"]))
              and rank["scores"] == sorted(rank["scores"], reverse=True), f"ranking {rank}")
        blob = call("snapshot", "GET", f"/sessions/{a}/snapshot", raw=True)
        card, _ = svc._entry(a)
        h0 = {f: float(getattr(card.state.hyper, f)) for f in ("length_scale", "var", "noise")}
        cpu_sid = cpu_svc.restore(blob)
        cpu, _ = cpu_svc._entry(cpu_sid)
        err_restored = float(np.abs(cpu.scores() - card.scores()).max())
        nxt = call("batch", "GET", f"/sessions/{a}/batch?k={SERVE_K}")["batch"]
        ans = user(nxt, c1)
        call("feedback", "POST", f"/sessions/{a}/feedback", {"labels": ans})
        cpu_svc.feedback(cpu_sid, ans)
        err = float(np.abs(cpu.scores() - card.scores()).max())
        print(f"serve snapshot: {len(blob)} bytes; restored on the CPU, max |mu_cpu - mu_card| "
              f"{err_restored:.3e}, after one more update {err:.3e} (atol {CPU_MU_ATOL})")
        check(err_restored <= CPU_MU_ATOL and err <= CPU_MU_ATOL,
              f"mu card vs CPU from the snapshot {err_restored}, {err} > {CPU_MU_ATOL}")
        learned = call("learn", "POST", f"/sessions/{a}/learn", {"steps": LEARN_STEPS})
        cpu_learned = cpu_svc.learn(cpu_sid, LEARN_STEPS)
        rel = {f: abs(learned[f] - cpu_learned[f]) / abs(cpu_learned[f]) for f in h0}
        print(f"serve learn ({card.state.count} labeled slots, {LEARN_STEPS} steps): from {h0} "
              f"to {learned} on the card, {cpu_learned} on the CPU; relative gaps {rel} "
              f"(rtol {LEARN_RTOL})")
        check(all(np.isfinite(v) and v > 0 for v in learned.values()), "learned values finite")
        check(learned["length_scale"] != h0["length_scale"] and learned["var"] != h0["var"],
              "the length scale and the variance moved on the card")
        check(all(r <= LEARN_RTOL for r in rel.values()), "card and CPU learn agree")
        check(bool(torch.isfinite(card.state.mu).all()), "mu finite after learn")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    route_launches = dict(rbf_hopper.ROUTE_LAUNCHES)
    for kind in KERNEL_REQUESTS:
        check(all(n > 0 for n in launches[kind]),
              f"serve {kind}: the kernel launched in every request {launches[kind]}")
    for kind, ms in times.items():
        print(f"serve {kind}: {len(ms)} requests, host ms median {np.median(ms):.3f} "
              f"min {min(ms):.3f} max {max(ms):.3f}; kernel launches per request "
              f"{min(launches[kind])}-{max(launches[kind])} [{smi}]")
    return {"launches": route_launches}


@contextlib.contextmanager
def _uncounted():
    """Launches inside the block (comparisons, not the path) are not counted."""
    from ital_tpu_torch.ops import rbf_hopper

    launches, routes = rbf_hopper.LAUNCHES, dict(rbf_hopper.ROUTE_LAUNCHES)
    try:
        yield
    finally:
        with rbf_hopper._COUNT_LOCK:
            rbf_hopper.LAUNCHES = launches
            rbf_hopper.ROUTE_LAUNCHES.update(routes)


def _check_stacked_picks(torch, st, picks, params, kw, what: str) -> int:
    """Replay each session of stack ``st`` alone (eagerly, uncounted) and
    hold the stacked picks to its own up to MI ties; returns the number of
    sessions whose picks differ."""
    import types

    from ital_tpu_torch import graphs
    from ital_tpu_torch.models import gp as gp_mod
    from ital_tpu_torch.select.ital import select_ital

    differ = 0
    with _uncounted(), graphs.eager():
        for k in range(st.k):
            sess = types.SimpleNamespace(state=gp_mod.session_state(st, k), params=params)
            own = select_ital(sess.state, picks.shape[1], None, params, **kw)
            if not torch.equal(own, picks[k]):
                differ += 1
                gaps = _tie_gaps(sess, picks[k].tolist(), kw)
                print(f"{what}: session {k} stacked {picks[k].tolist()} alone {own.tolist()}; "
                      f"refined-MI gaps {gaps} (tie atol {MI_TIE_ATOL})")
                check(all(abs(g) <= MI_TIE_ATOL for g in gaps),
                      f"{what}: stacked and per-session picks differ only by ties")
    return differ


@contextlib.contextmanager
def _record_cohort_programs(record: list, keep_stacks: bool):
    """Append ``(the stack before or None, mu after)`` to ``record`` for each
    call of the runner's cohort programs (``runner._cohort_rounds``)."""
    import torch

    from ital_tpu_torch import runner
    from ital_tpu_torch.models import gp as gp_mod

    rounds = runner._cohort_rounds

    def watched(cfg, states, *args, **kwargs):
        before = gp_mod.stack_states(states) if keep_stacks else None
        out = rounds(cfg, states, *args, **kwargs)
        record.append((before, torch.stack([s.mu for s in states])))
        return out

    runner._cohort_rounds = watched
    try:
        yield
    finally:
        runner._cohort_rounds = rounds


def _mu_gap(torch, graphed: list, eager: list, what: str) -> float:
    """Hold graphed means to eager ones, pair by pair: bit-equal, or within
    ``COHORT_MU_ATOL`` where a layout differs.  Returns the largest gap."""
    check(len(graphed) == len(eager), f"{what}: {len(graphed)} graphed, {len(eager)} eager means")
    gap = max((float((a - b).abs().max()) for a, b in zip(graphed, eager)), default=0.0)
    if gap:
        print(f"{what}: graphed mu differs from eager by {gap:.3e}: the program's buffers and "
              f"the eager stack differ in layout or in the route a block took")
    check(gap <= COHORT_MU_ATOL, f"{what}: graphed mu within {COHORT_MU_ATOL} of eager ({gap})")
    return gap


def _known_programs() -> dict:
    """The live programs and their replays, ``{id: (program, replays)}``: the
    program is held so that no later one, once it is released, takes its id."""
    from ital_tpu_torch import graphs

    return {id(p): (p, p.replays) for p in graphs.programs()}


def _replayed_since(known: dict, p) -> bool:
    return p.replays > known.get(id(p), (None, 0))[1]


def _phase_programs(known: dict) -> list:
    """The programs captured or replayed since ``known`` (``_known_programs``)."""
    from ital_tpu_torch import graphs

    return [p for p in graphs.programs() if _replayed_since(known, p)]


def _print_programs(progs: list, known: dict, what: str, smi: str) -> None:
    for p in progs:
        mu = p.inputs.get("mu")
        k = ("released since" if p.graph is None
             else f"K = {mu.shape[0] if mu is not None and mu.dim() == 2 else 1}")
        print(f"{what} program {p.name} ({k}){'' if id(p) not in known else ' (captured earlier)'}"
              f": warm-up {p.warmup_ms:.1f} ms, capture {p.capture_ms:.1f} ms, instantiate "
              f"{p.instantiate_ms:.1f} ms, replays {p.replays}, launches per replay "
              f"{sum(p.launches.values())}, static buffers {p.static_bytes / 2**20:.2f} MiB, pool "
              f"growth at capture {p.pool_bytes / 2**20:.2f} MiB [{smi}]")


def _cohort_runner(torch, ds, cfg, dev, smi: str) -> dict:
    """The runner's serial run and its fused, cohort and cohort-fused modes
    on one plan, each mode graphed and eager in ``GRAPH_TURNS``; returns the
    graphed fused runs' launches by route.  The cohort path's count starts
    at the cohort's first turn and goes on counting after the return.

    Each mode: graphed picks and curves equal to eager, ``mu`` after every
    program call bit-equal (or within ``COHORT_MU_ATOL``).  Each stacked
    pick of the cohort's first turn is replayed on its session alone, up to
    MI ties.  Against the serial run, a session's picks in the cohort and in
    the fused run agree round by round up to the first round whose picks
    differ by an MI tie: on the card a stack and the session's own buffers
    round differently (~1e-7), so a later tie may fall the other way.  The
    cohort-fused run repeats the cohort's operations and must give its
    picks and curves.
    """
    import types

    from ital_tpu_torch import graphs, runner
    from ital_tpu_torch.models import gp as gp_mod
    from ital_tpu_torch.ops import rbf_hopper
    from ital_tpu_torch.select import base
    from ital_tpu_torch.select.base import StrategyParams

    plan = dataclasses.replace(cfg, max_classes=COHORT_CLASSES, queries_per_class=2,
                               n_rounds=COHORT_ROUNDS, gp=dataclasses.replace(cfg.gp, cap=CAP))
    n_sess = 2 * COHORT_CLASSES
    kw, rounds = plan.method_kwargs, plan.n_rounds
    params = StrategyParams.create(dev, label_prob=plan.user.label_prob,
                                   mistake_prob=plan.user.mistake_prob)
    single = base.STRATEGIES["ital"]
    serial_states, serial_picks = [], []

    def watched_single(state, batch_size, generator, params, **kwargs):
        out = single(state, batch_size, generator, params, **kwargs)
        serial_states.append((gp_mod.gp_session_copy(state), params))
        serial_picks.append(out.tolist())
        return out

    # The serial run is the baseline, counted in no path.
    base.STRATEGIES["ital"] = watched_single
    try:
        with _uncounted():
            serial = runner.run_experiment(plan, ds, device=dev)
    finally:
        base.STRATEGIES["ital"] = single
    serial_picks = [serial_picks[k * rounds:(k + 1) * rounds] for k in range(n_sess)]

    known = _known_programs()
    runs, fused_launches, progs = {}, None, []
    for mode, change in COHORT_MODES.items():
        if mode in ("fused", "query_batch"):
            _reset_counts()
        runs[mode] = []
        for i, turn in enumerate(GRAPH_TURNS):
            record = []
            keep = mode == "query_batch" and i == 0
            with _graphed_or_eager(turn), _record_cohort_programs(record, keep):
                before = rbf_hopper.LAUNCHES
                res = runner.run_experiment(dataclasses.replace(plan, **change), ds, device=dev)
                res["launches"] = rbf_hopper.LAUNCHES - before
            check(res["ap"].shape == (n_sess, rounds) and bool(np.isfinite(res["ap"]).all()),
                  f"cohort runner {mode} {turn}: AP shape and values")
            check(res["picks"].shape == (n_sess, rounds, plan.batch_size),
                  f"cohort runner {mode} {turn}: the programs' picks")
            runs[mode].append((turn, res, record))
        if mode == "fused":
            fused_launches = dict(rbf_hopper.ROUTE_LAUNCHES)
        # Collected per mode: the next mode's first capture releases the
        # programs of this one's corpora, which are gone.
        progs += [p for p in _phase_programs(known) if all(p is not q for q in progs)]
    gaps = {}
    for mode, turns in runs.items():
        for (tg, g, rg), (te, e, re_) in ((turns[0], turns[1]), (turns[3], turns[2])):
            check(np.array_equal(g["picks"], e["picks"]),
                  f"cohort runner {mode}: graphed picks equal eager picks")
            check(np.array_equal(g["ap"], e["ap"]),
                  f"cohort runner {mode}: graphed curves equal eager curves")
            gaps[mode] = max(gaps.get(mode, 0.0),
                             _mu_gap(torch, [m for _, m in rg], [m for _, m in re_],
                                     f"cohort runner {mode}"))
        check(np.array_equal(turns[0][1]["picks"], turns[3][1]["picks"]),
              f"cohort runner {mode}: both graphed turns pick alike")
    res = {mode: turns[0][1] for mode, turns in runs.items()}
    # Cohorts of COHORT_QB, the last padded: call i is round i % rounds of
    # cohort i // rounds, whose padded rows are not the plan's.
    qb_record = runs["query_batch"][0][2]
    n_cohorts = -(-n_sess // COHORT_QB)
    check(len(qb_record) == n_cohorts * rounds, "one cohort program a round")
    differ = 0
    for i, (st, _) in enumerate(qb_record):
        c, r = divmod(i, rounds)
        rows = res["query_batch"]["picks"][c * COHORT_QB:(c + 1) * COHORT_QB, r]
        real = gp_mod.stack_states([gp_mod.session_state(st, k) for k in range(len(rows))])
        differ += _check_stacked_picks(torch, real, torch.as_tensor(rows, device=dev), params,
                                       kw, f"cohort runner cohort {c} round {r}")
    apart = {}
    with _uncounted():
        for mode in ("query_batch", "fused"):
            apart[mode] = []
            for k in range(n_sess):
                picks = res[mode]["picks"][k].tolist()
                r = next((r for r in range(rounds) if picks[r] != serial_picks[k][r]), rounds)
                if r < rounds:
                    state, sp = serial_states[k * rounds + r]
                    tie = _tie_gaps(types.SimpleNamespace(state=state, params=sp), picks[r], kw)
                    print(f"cohort runner {mode} session {k}: round {r} serial "
                          f"{serial_picks[k][r]}, {mode} {picks[r]}; refined-MI gaps on the "
                          f"serial state {tie} (tie atol {MI_TIE_ATOL})")
                    check(all(abs(g) <= MI_TIE_ATOL for g in tie),
                          f"{mode} and serial picks differ only by ties")
                check(np.abs(res[mode]["ap"][k, :r] - serial["ap"][k, :r]).max(initial=0.0)
                      <= 1e-4, f"{mode} and serial AP agree while their picks do")
                apart[mode].append(r)
    ap_gaps = {mode: float(np.abs(res[mode]["ap"] - res[ref]["ap"]).max()) if ref != "serial"
               else float(np.abs(res[mode]["ap"] - serial["ap"]).max())
               for mode, ref in (("query_batch", "serial"), ("query_batch+fused", "query_batch"),
                                 ("fused", "serial"))}
    print(f"cohort runner: max |AP - AP_ref| {ap_gaps}; graphed vs eager max |mu| gap {gaps}; "
          f"stacked picks that differed from the session's own on its state: {differ} of "
          f"{n_sess * rounds}; first round whose picks differ from the serial run's, per session: "
          f"{apart} of {rounds}")
    check(ap_gaps["query_batch+fused"] <= 1e-6
          and np.array_equal(res["query_batch+fused"]["picks"], res["query_batch"]["picks"]),
          "the cohort-fused run gives the cohort's picks and curves")
    serial_round = serial["select_ms_steady"] + serial["update_ms_steady"]
    print(f"cohort runner serial (graphed programs): select + update steady {serial_round:.3f} "
          f"ms a round; {COHORT_QB} x = {COHORT_QB * serial_round:.3f} ms, a session of "
          f"{rounds} rounds {rounds * serial_round:.3f} ms [{smi}]")
    for mode, turns in runs.items():
        cells = []
        for turn, r, _ in turns:
            if mode == "query_batch":
                cells.append(f"{turn} {r['select_ms_steady']:.3f} ms a round steady (first "
                             f"{r['first_round_ms']:.1f})")
            elif mode == "fused":
                cells.append(f"{turn} {r['select_ms'] * rounds:.3f} ms a session mean, "
                             f"{r['select_ms_steady'] * rounds:.3f} steady (first "
                             f"{r['first_round_ms']:.1f})")
            else:
                cells.append(f"{turn} {r['select_ms_steady']:.3f} ms a cohort of {rounds} "
                             f"rounds steady (first {r['first_round_ms']:.1f})")
            cells[-1] += f", launches {r['launches']}"
        print(f"cohort runner {mode} turns: " + "; ".join(cells) + f" [{smi}]")
    _print_programs(progs, known, "cohort runner", smi)
    return fused_launches


@contextlib.contextmanager
def _eager_service(svc, eager: bool):
    """Run the service's request methods in ``graphs.eager()`` on whatever
    thread serves them (the mode is the thread's own) when ``eager``."""
    from ital_tpu_torch import graphs

    if not eager:
        yield
        return
    names = ("next_batch_many", "feedback_many", "next_batch", "feedback", "set_query", "learn")
    orig = {n: getattr(svc, n) for n in names}

    def wrap(fn):
        @functools.wraps(fn)
        def eager_fn(*args, **kwargs):
            with graphs.eager():
                return fn(*args, **kwargs)
        return eager_fn

    for n in names:
        setattr(svc, n, wrap(orig[n]))
    try:
        yield
    finally:
        for n in names:
            delattr(svc, n)


def _cohort_http(torch, ds, cfg, dev, smi: str):
    """Eight sessions through the cohort endpoints beside eight twins, in
    ``GRAPH_TURNS`` on one server: the graphed turns replay the stacked
    select and update programs (the second one with no new capture), and
    their picks and means are held to the eager turns'.  Returns the device
    memory the largest stacked selection and update added per session over
    all turns (None on the CPU)."""
    from ital_tpu_torch import graphs, serve
    from ital_tpu_torch.ops import rbf_hopper

    svc = serve.service_from_config(cfg, device=dev)
    srv = serve.make_server(svc, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    times, launches, rise = {}, {}, {}
    cuda = dev.type == "cuda"
    known = _known_programs()

    def call(kind, method, path, body=None):
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(base + path, data=data, method=method,
                                     headers={"Content-Type": "application/json"})
        before = rbf_hopper.LAUNCHES
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            allocated = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=600) as resp:
                payload = json.loads(resp.read())
        except urllib.error.HTTPError as e:
            raise RuntimeError(f"{method} {path}: HTTP {e.code} {e.read()!r}") from e
        if cuda:
            torch.cuda.synchronize()
        times.setdefault((turn, kind), []).append((time.perf_counter() - t0) * 1e3)
        launches.setdefault((turn, kind), []).append(rbf_hopper.LAUNCHES - before)
        if cuda:
            rise.setdefault((turn, kind), []).append(
                torch.cuda.max_memory_allocated() - allocated)
        return payload

    turns = []
    try:
        for i, turn in enumerate(GRAPH_TURNS):
            rng = np.random.default_rng(SEED + 11)
            classes = [int(c) for c in rng.choice(ds.classes, COHORT_K // 2, replace=False)]
            queries = [(int(q), c) for c in classes for q in ds.queries_for_class(c, rng, 2)]
            user = _user(rng, ds, cfg.user.label_prob, cfg.user.mistake_prob)
            picks_by_round, mu_by_round = [], []
            captured = graphs.captures()
            with _graphed_or_eager(turn), _eager_service(svc, turn == "eager"):
                # The twins are the baseline: their requests count in no path.
                cohort, twins = [], []
                for q, _ in queries:
                    for out in (cohort, twins):
                        with _uncounted() if out is twins else contextlib.nullcontext():
                            sid = call("create", "POST", "/sessions", {})["session_id"]
                            call("query", "POST", f"/sessions/{sid}/query", {"index": q})
                        out.append(sid)
                for r in range(SERVE_ROUNDS):
                    picks = call("batch_select", "POST", "/batch_select",
                                 {"session_ids": cohort, "k": SERVE_K})["batches"]
                    for j, (a, b) in enumerate(zip(cohort, twins)):
                        with _uncounted():
                            single = call("batch", "GET",
                                          f"/sessions/{b}/batch?k={SERVE_K}")["batch"]
                        check(len(set(picks[a])) == SERVE_K, f"round {r}: {SERVE_K} distinct picks")
                        if picks[a] != single:
                            twin, _ = svc._entry(b)
                            with _uncounted(), graphs.eager():
                                gaps = _tie_gaps(twin, picks[a], twin.method_kwargs)
                            print(f"cohort serve {turn} round {r} session {j}: cohort {picks[a]} "
                                  f"single {single}; refined-MI gaps {gaps} (tie atol "
                                  f"{MI_TIE_ATOL})")
                            check(all(abs(g) <= MI_TIE_ATOL for g in gaps),
                                  "cohort and single twin batches differ only by ties")
                    answers = {a: user(picks[a], c) for a, (_, c) in zip(cohort, queries)}
                    got = call("batch_feedback", "POST", "/batch_feedback",
                               {"feedback": answers})["sessions"]
                    want = 1 + (r + 1) * SERVE_K
                    for a, b in zip(cohort, twins):
                        with _uncounted():
                            single = call("feedback", "POST", f"/sessions/{b}/feedback",
                                          {"labels": answers[a]})
                        check(got[a] == single == {"labeled": want},
                              f"round {r}: labeled {got[a]} {single}")
                        err = float((svc._entry(a)[0].state.mu
                                     - svc._entry(b)[0].state.mu).abs().max())
                        check(err <= CPU_MU_ATOL,
                              f"round {r}: cohort mu within {CPU_MU_ATOL} of the twin's")
                    picks_by_round.append([picks[a] for a in cohort])
                    mu_by_round.append([svc._entry(a)[0].state.mu.clone() for a in cohort])
                    print(f"cohort serve {turn} round {r}: " + "; ".join(
                        f"{picks[a]} {list(answers[a].values())}" for a in cohort))
            if turn == "graphed" and i > 0:
                check(graphs.captures() == captured,
                      "the second graphed cohort replays the first one's programs")
            turns.append((turn, picks_by_round, mu_by_round))
            for sid in cohort + twins:
                svc.delete(sid)
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    gap = 0.0
    for (_, gp_, gm), (_, ep, em) in ((turns[0], turns[1]), (turns[3], turns[2])):
        check(gp_ == ep, "cohort serve: graphed picks equal eager picks")
        gap = max(gap, _mu_gap(torch, [m for row in gm for m in row],
                               [m for row in em for m in row], "cohort serve"))
    for turn in ("graphed", "eager"):
        for kind in COHORT_KINDS:
            check(all(n > 0 for n in launches[(turn, kind)]),
                  f"cohort serve {turn} {kind}: the kernel launched in every request "
                  f"{launches[(turn, kind)]}")
    cap = svc.defaults["cap"]
    per = COHORT_K * cap * ds.n * 4
    for turn in ("graphed", "eager"):
        for kind in COHORT_KINDS:
            ms = times[(turn, kind)]
            mem = ""
            if rise:
                peak = max(rise[(turn, kind)])
                mem = (f"; device memory added per request max {peak / 2**20:.1f} MiB"
                       + (f" = {peak / per:.3f} (cap, N) copies a session, first request "
                          f"{rise[(turn, kind)][0] / 2**20:.1f} MiB, later max "
                          f"{max(rise[(turn, kind)][1:], default=0) / 2**20:.1f} MiB"
                          if kind in ("batch_select", "batch_feedback") else ""))
            print(f"cohort serve {turn} {kind} "
                  f"({COHORT_K if kind.startswith('batch_') else 1} session(s)): {len(ms)} "
                  f"requests, host ms median {np.median(ms):.3f} min {min(ms):.3f} max "
                  f"{max(ms):.3f}; kernel launches per request {min(launches[(turn, kind)])}-"
                  f"{max(launches[(turn, kind)])}{mem} [{smi}]")
    print(f"cohort serve: graphed picks equal eager in every round; max |mu| gap {gap:.3e}")
    _print_programs(_phase_programs(known), known, "cohort serve", smi)
    if not rise:
        return None
    per_session = {kind: max(max(rise[(turn, kind)]) for turn in ("graphed", "eager")) / COHORT_K
                   for kind in ("batch_select", "batch_feedback")}
    _check_budget(per_session, cap, ds.n)
    return per_session


# The mixed cohort traffic (phase 8): eight sessions, those of MIX_LEARNED
# with learned hyperparameters, then MIX_REQUESTS passes over cohorts of
# several sizes and mixes, each a /batch_select and a /batch_feedback.
MIX_LEARNED = (1, 4, 6)
MIX_REQUESTS = ([0, 1, 2, 3, 4, 5, 6, 7], [1, 0], [3, 4, 2, 6], [5, 7, 1], [0, 2, 3, 5],
                [7, 6], [4, 0, 2], [6, 7, 1, 3], [2, 5], [6, 4, 1])
MIX_PASSES = 2


def _cohort_mix(torch, ds, cfg, dev, smi: str) -> None:
    """Cohort requests of several sizes and hyperparameter mixes over HTTP,
    in ``GRAPH_TURNS``: eight production sessions answer one cohort round,
    three of them ``/learn``, then ``MIX_PASSES`` passes over
    ``MIX_REQUESTS`` (K = 2, 3, 4 and 8, learned and default sessions in
    varying orders).  A graphed turn captures one program per signature (K,
    block width and group sizes: a cohort is laid out by hyperparameter
    group first) and replays it after; the second graphed turn captures
    nothing if the stages of the traffic's programs stayed within
    ``graphs.STACK_BYTES``.  Graphed picks equal eager picks request by
    request.  Prints per turn and pass the host ms of each request kind,
    the captures, the programs held, the stages' MiB and the graph pools'
    MiB."""
    from ital_tpu_torch import graphs, serve

    svc = serve.service_from_config(cfg, device=dev)
    srv = serve.make_server(svc, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"

    def call(method, path, body=None):
        req = urllib.request.Request(base + path, method=method,
                                     data=None if body is None else json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=600) as resp:
                return json.loads(resp.read())
        except urllib.error.HTTPError as e:
            raise RuntimeError(f"{method} {path}: HTTP {e.code} {e.read()!r}") from e

    def timed(method, path, body):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = call(method, path, body)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    picks_by_turn = []
    try:
        for turn in GRAPH_TURNS:
            rng = np.random.default_rng(SEED + 13)
            classes = [int(c) for c in rng.choice(ds.classes, 4, replace=False)]
            queries = [(int(q), c) for c in classes for q in ds.queries_for_class(c, rng, 2)]
            user = _user(rng, ds, cfg.user.label_prob, cfg.user.mistake_prob)
            picks, ms = [], {}
            known, captured = _known_programs(), graphs.captures()
            with _graphed_or_eager(turn), _eager_service(svc, turn == "eager"):
                sids = []
                for q, _ in queries:
                    sids.append(call("POST", "/sessions", {})["session_id"])
                    call("POST", f"/sessions/{sids[-1]}/query", {"index": q})
                got = call("POST", "/batch_select", {"session_ids": sids, "k": SERVE_K})["batches"]
                call("POST", "/batch_feedback", {"feedback": {
                    s: user(got[s], c) for s, (_, c) in zip(sids, queries)}})
                for j in MIX_LEARNED:
                    call("POST", f"/sessions/{sids[j]}/learn", {"steps": LEARN_STEPS})
                for pas in range(MIX_PASSES):
                    for req in MIX_REQUESTS:
                        ids = [sids[j] for j in req]
                        got, t_sel = timed("POST", "/batch_select",
                                           {"session_ids": ids, "k": SERVE_K})
                        answers = {sids[j]: user(got["batches"][sids[j]], queries[j][1])
                                   for j in req}
                        fed, t_fb = timed("POST", "/batch_feedback", {"feedback": answers})
                        check(all("error" not in v for v in fed["sessions"].values()),
                              f"cohort mix {turn}: every session absorbed its answers")
                        picks.append([got["batches"][s] for s in ids])
                        ms.setdefault((pas, "batch_select"), []).append(t_sel)
                        ms.setdefault((pas, "batch_feedback"), []).append(t_fb)
            for s in sids:
                svc.delete(s)
            picks_by_turn.append(picks)
            new = [p for p in graphs.programs() if id(p) not in known]
            held = [p for p in graphs.programs() if p.stacks and p.graph is not None]
            pool = _pool_mib(torch)
            cells = "; ".join(
                f"pass {pas} {kind} median {np.median(v):.3f} min {min(v):.3f} max {max(v):.3f}"
                for (pas, kind), v in sorted(ms.items()))
            print(f"cohort mix {turn}: {len(MIX_REQUESTS)} requests a pass, K "
                  f"{sorted({len(r) for r in MIX_REQUESTS})}, sessions {list(MIX_LEARNED)} "
                  f"learned; host ms {cells}; programs captured in the turn {len(new)} ("
                  + ", ".join(f"{p.name} K = {p.inputs['mu'].shape[0]} capture "
                              f"{p.warmup_ms + p.capture_ms + p.instantiate_ms:.1f} ms"
                              for p in new if p.stacks and p.graph is not None)
                  + f"); stacking programs held {len(held)}, stages "
                  f"{sum(s.nbytes for s in graphs.stages()) / 2**20:.2f} MiB of "
                  f"{graphs.STACK_BYTES / 2**20:.0f}; graph pools "
                  f"{'not measured' if pool is None else f'{pool:.1f} MiB'} [{smi}]")
            if turn == "graphed" and picks_by_turn[:-1]:
                check(graphs.captures() == captured,
                      "cohort mix: the second graphed turn replays the first one's programs "
                      "(their stages held within graphs.STACK_BYTES)")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    for g, e in ((0, 1), (3, 2)):
        check(picks_by_turn[g] == picks_by_turn[e], "cohort mix: graphed picks equal eager picks")
    print("cohort mix: graphed picks equal eager picks in every request")


def _check_budget(per_session: dict, cap: int, n: int) -> None:
    """Hold the device memory a stacked request added per session to the
    server's budget model (``serve.max_cohort_sessions``' terms)."""
    from ital_tpu_torch import serve

    copies, fixed = serve.SELECT_BUDGET["ital"]
    model = {"batch_select": copies * cap * n * 4 + fixed,
             "batch_feedback": serve.UPDATE_COPIES * cap * n * 4}
    print(f"cohort budget at {n} rows, cap {cap}: per session " + "; ".join(
        f"{kind} {per_session[kind] / 2**20:.2f} MiB against the model's "
        f"{model[kind] / 2**20:.2f} MiB" for kind in model))
    check(all(per_session[k] <= model[k] for k in model),
          "the stacked requests stay within the budget model")


def _cohort_kernel_forms(torch, ds, cfg, dev, smi: str) -> None:
    """The kernel's stacked forms in a production cohort of ``COHORT_K``
    sessions, on surrogate rows: the selection's pool cross-kernel and batch
    block at the last greedy step (diagonal blocks of one launch), the
    update's slot-by-new and new-by-new blocks (the same) and its corpus
    block, the last also with the sessions in two hyperparameter groups.
    Each form is held against the plain version on the same inputs and
    timed against one launch per session."""
    from ital_tpu_torch.ops.kernels import rbf_kernel, rbf_kernel_plain, rbf_sessions

    x = torch.from_numpy(ds.x).to(dev)
    x2 = (x * x).sum(-1)
    rng = np.random.default_rng(SEED + 3)
    k, pool, t, b, d = COHORT_K, cfg.method_kwargs["pool_size"], SERVE_K - 1, SERVE_K, ds.x.shape[1]

    def rows(m):
        return x[torch.from_numpy(rng.integers(0, ds.n, size=(k, m))).to(dev)]

    pools, sel, slots, new = rows(pool), rows(t), rows(CAP), rows(b)
    ls = torch.full((k,), cfg.gp.length_scale, device=dev)
    var = torch.full((k,), cfg.gp.var, device=dev)
    ls2 = torch.cat([ls[:k // 2], 0.8 * ls[k // 2:]])
    one, two = [list(range(k))], [list(range(k // 2)), list(range(k // 2, k))]
    forms = {  # name: (a, b, length scales, groups, norms)
        f"pool cross ({k} x {pool}, {k} x {t}, {d})": (pools, sel, ls, one, {}),
        f"batch block ({k} x {t}, {k} x {t}, {d})": (sel, sel, ls, one, {}),
        f"update k_lb ({k} x {CAP}, {k} x {b}, {d})": (slots, new, ls, one, {}),
        f"update k_bb ({k} x {b}, {k} x {b}, {d})": (new, new, ls, one, {}),
        f"update corpus block ({k} x {b}, {ds.n}, {d}) b2": (new, x, ls, one, {"b2": x2}),
        f"update corpus block ({k} x {b}, {ds.n}, {d}) b2, 2 groups": (new, x, ls2, two,
                                                                       {"b2": x2}),
    }

    def bound(a, bb, norms):
        """The least time of the function a form computes, whatever its
        launches, and what sets it: each input read once (a shared side once
        for every group), the norms read once, only the K (m, n) blocks it
        returns written once (not the off-diagonal blocks of a (G m, G n)
        launch), and the 3xTF32 operations of those K blocks."""
        k_, m = a.shape[0], a.shape[-2]
        n = bb.shape[0] if bb.dim() == 2 else bb.shape[-2]
        nbytes = 4 * (a.numel() + bb.numel() + (n if norms else 0) + k_ * m * n)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 2.0 * k_ * m * n * d * 3 / TF32_OPS_PER_S * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    def launch_work(a, bb, groups, norms):
        """The bound of the launches themselves: one (G m, G n) block per
        group of G sessions (G m against a shared side's rows, which each
        group's launch reads again)."""
        total = 0.0
        for g in groups:
            m = len(g) * a.shape[-2]
            n = bb.shape[0] if bb.dim() == 2 else len(g) * bb.shape[-2]
            total += rbf_bound_ms(m, n, d, False, n if norms else 0)[0]
        return total

    def per_session(fn, a, bb, lsk, norms):
        return lambda: torch.stack([fn(a[j], bb if bb.dim() == 2 else bb[j], lsk[j], var[j],
                                       **norms) for j in range(k)])

    with _uncounted():
        for name, (a, bb, lsk, groups, norms) in forms.items():
            stacked = functools.partial(rbf_sessions, a, bb, lsk, var, groups, **norms)
            each = per_session(rbf_kernel, a, bb, lsk, norms)
            got = stacked()
            err = float((got - per_session(rbf_kernel_plain, a, bb, lsk, norms)()).abs().max())
            diff = float((got - each()).abs().max())
            check(err <= F32_ATOL * cfg.gp.var, f"{name}: stacked form agrees with plain")
            (ms_s, sp_s), (ms_e, sp_e) = _time_turns_ms(torch, [stacked, each], launches=20)
            need, by = bound(a, bb, norms)
            print(f"cohort kernel {name}: {len(groups)} launch(es) {ms_s:.4f} ms (spread "
                  f"{sp_s:.4f}) against the function's bound {need * 1e3:.2f} us ({by}; "
                  f"{100 * need / ms_s:.1f} %), the launches' own work "
                  f"{launch_work(a, bb, groups, norms) * 1e3:.2f} us; {k} launches {ms_e:.4f} "
                  f"ms (spread {sp_e:.4f}); max "
                  f"|stacked - plain| {err:.2e} (atol {F32_ATOL * cfg.gp.var:.0e}), max "
                  f"|stacked - per-session launches| {diff:.2e} [{smi}]")


def cohort_phase(torch, ds, cfg, dev, smi: str) -> tuple[dict, dict]:
    """Phase 8: the stacked cohort programs, in the runner and over HTTP.
    Returns the launches by route of two paths, the runner's fused run and
    the cohort (the runner's stacked runs and the HTTP cohort), and the
    device memory a stacked request added per session (None on the CPU)."""
    from ital_tpu_torch.ops import rbf_hopper

    if dev.type == "cuda":
        _cohort_kernel_forms(torch, ds, cfg, dev, smi)
        torch.cuda.synchronize()
    fused = _cohort_runner(torch, ds, cfg, dev, smi)
    rise = _cohort_http(torch, ds, cfg, dev, smi)
    if dev.type == "cuda":
        _cohort_mix(torch, ds, cfg, dev, smi)
    return ({"fused": {"launches": fused}, "cohort": {"launches": dict(rbf_hopper.ROUTE_LAUNCHES)}},
            rise)


@contextlib.contextmanager
def _record_serial(method: str, record: list):
    """Append ``(state before, batch)`` to ``record`` for each single-device
    selection of ``method``."""
    from ital_tpu_torch.models import gp as gp_mod
    from ital_tpu_torch.select.base import STRATEGIES

    orig = STRATEGIES[method]

    @functools.wraps(orig)
    def watched(state, *args, **kwargs):
        before = gp_mod.gp_session_copy(state)
        batch = orig(state, *args, **kwargs)
        record.append((before, batch.tolist()))
        return batch

    STRATEGIES[method] = watched
    try:
        yield
    finally:
        STRATEGIES[method] = orig


@contextlib.contextmanager
def _record_sharded(record: list):
    """Append each batch the sharded path selects to ``record``."""
    from ital_tpu_torch.parallel import sharded

    orig = sharded.make_sharded_select

    def make(*args, **kwargs):
        select = orig(*args, **kwargs)

        def watched(*a, **kw):
            batch = select(*a, **kw)
            record.append(batch.tolist())
            return batch

        return watched

    sharded.make_sharded_select = make
    try:
        yield
    finally:
        sharded.make_sharded_select = orig


def _mi_gaps(torch, state, params, kw, picks) -> list[float]:
    """A full-scan ITAL batch ``picks`` replayed step by step on ``state``:
    each step's best MI minus the MI of that step's pick (0 where it is the
    best), with the earlier picks as the partial batch."""
    from ital_tpu_torch.select import ital
    from ital_tpu_torch.select.base import labeled_mask

    excluded = labeled_mask(state)
    batch = torch.as_tensor(picks, device=state.mu.device)
    gaps = []
    for t, pick in enumerate(picks):
        scores = ital.score_candidates_mi(state, batch, t, params, n_qmc=kw.get("n_qmc", 128))
        scores = torch.where(excluded, -torch.inf, scores)
        gaps.append(float(scores.max() - scores[pick]))
        excluded[pick] = True
    return gaps


def _ring_gaps(torch, method, state, params, picks) -> list[float]:
    """The relative score gap of each pick below the best eligible score on
    ``state``, step by step, for a batch-independent ring strategy (scores
    from the sharded functions on a mesh of one)."""
    from ital_tpu_torch.parallel import make_mesh, sharded
    from ital_tpu_torch.select.base import labeled_mask

    with make_mesh(1, device=state.mu.device) as mesh:
        st = sharded.shard_state(state, mesh)
        valid = torch.ones_like(st.mu)
        if method == "emoc":
            scores = sharded._sharded_emoc_scores(mesh, st, valid)
        elif method == "mcmi_min":
            scores = sharded._sharded_mcmi_scores(mesh, st, valid)
        else:
            scores = sharded._LOCAL_SCORES[method](st, params)
    excluded = labeled_mask(state)
    gaps = []
    for pick in picks:
        best = float(torch.where(excluded, -torch.inf, scores).max())
        gaps.append((best - float(scores[pick])) / abs(best))
        excluded[pick] = True
    return gaps


def _sharded_vs_serial(torch, ds, cfg, dev, what: str, tie_gaps) -> dict:
    """``cfg`` through the runner serially (uncounted: the baseline) and on
    the mesh (counted); the picks must agree round by round up to the first
    round whose picks differ only by ties (``tie_gaps(state, params, picks)``
    on the serial state), and the AP curves while they agree.  Returns both
    results and the device memory each run peaked at."""
    from ital_tpu_torch import runner
    from ital_tpu_torch.select.base import StrategyParams

    serial, sharded_picks, out = [], [], {}
    for mode, mesh in (("serial", 0), ("sharded", 8)):
        run = dataclasses.replace(cfg, mesh_devices=mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with (_uncounted() if mode == "serial" else contextlib.nullcontext()), \
                (_record_serial(cfg.method, serial) if mode == "serial"
                 else _record_sharded(sharded_picks)):
            out[mode] = runner.run_experiment(run, ds, device=dev)
        out[mode]["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    check(out["sharded"].get("mesh_devices") == 1, f"{what}: the mesh clamped to one card")
    params = StrategyParams.create(dev, label_prob=cfg.user.label_prob,
                                   mistake_prob=cfg.user.mistake_prob)
    rounds = cfg.n_rounds
    n_sessions = len(out["serial"]["sessions"])
    check(len(serial) == len(sharded_picks) == n_sessions * rounds, f"{what}: selections")
    with _uncounted():
        for k in range(n_sessions):
            rows = range(k * rounds, (k + 1) * rounds)
            r = next((r for r in range(rounds)
                      if serial[rows[r]][1] != sharded_picks[rows[r]]), rounds)
            if r < rounds:
                state, picks = serial[rows[r]]
                gaps = tie_gaps(state, params, sharded_picks[rows[r]])
                print(f"{what} session {k}: round {r} serial {picks}, sharded "
                      f"{sharded_picks[rows[r]]}; gaps on the serial state {gaps}")
                check(all(g >= 0 for g in gaps), f"{what}: gaps are below the best")
                out["gaps"] = gaps
            check(np.abs(out["sharded"]["ap"][k, :r] - out["serial"]["ap"][k, :r]).max(
                initial=0.0) <= 1e-6, f"{what}: AP curves agree while the picks do")
            out.setdefault("apart", []).append(r)
    return out


def sharded_phase(torch, ds, cfg, dev, smi: str, rise25: dict) -> dict:
    """Phase 9: the corpus-sharded path on NCCL; returns its launches by
    route and the kernel's times at the 100 000-row shapes."""
    from ital_tpu_torch.data.datasets import load_dataset
    from ital_tpu_torch.ops import rbf_hopper
    from ital_tpu_torch.parallel import make_mesh, sharded
    from ital_tpu_torch.utils.config import load_config

    t_phase = time.perf_counter()
    with make_mesh(1, device=dev) as mesh:
        check(mesh.backend == "nccl" and mesh.device == torch.device("cuda", 0),
              f"a mesh of one card runs on NCCL: {mesh.backend} {mesh.device}")
        check(torch.equal(sharded.psum(mesh, torch.ones(3, device=dev)),
                          torch.ones(3, device=dev)), "NCCL all_reduce on a mesh of one")
    scale = load_config(str(SCALE_CONFIG), SCALE_OVERRIDES)
    big = load_dataset(scale.dataset, **scale.dataset_kwargs)
    print(f"sharded: {scale.dataset} {big.x.shape[0]} x {big.x.shape[1]}, mesh_devices "
          f"{scale.mesh_devices} on {torch.cuda.device_count()} card(s)")
    shapes = _big_kernel_times(torch, big, scale, dev, smi)
    torch.cuda.synchronize()

    _reset_counts()  # the sharded path's count starts here
    res = _sharded_vs_serial(
        torch, big, scale, dev, "scale100k",
        lambda st, p, picks: _mi_gaps(torch, st, p, scale.method_kwargs, picks))
    check(rbf_hopper.LAUNCHES > 0, "the kernel launched on the sharded path")
    check(all(abs(g) <= MI_TIE_ATOL for g in res.get("gaps", [])),
          "sharded and serial picks differ only by MI ties")
    for mode in ("serial", "sharded"):
        r = res[mode]
        print(f"sharded scale100k {mode}: MAP {[round(float(m), 6) for m in r['map']]}; select "
              f"{r['select_ms']:.3f} ms mean, {r['select_ms_steady']:.3f} ms steady; update "
              f"{r['update_ms']:.3f} ms mean, {r['update_ms_steady']:.3f} ms steady; first round "
              f"{r['first_round_ms']:.1f} ms; device memory peak {r['peak_mib']:.1f} MiB [{smi}]")
    print(f"sharded scale100k: first round whose picks differ, per session: {res['apart']} of "
          f"{scale.n_rounds}; launches {rbf_hopper.LAUNCHES}")
    per_replay = _mesh_round_turns(
        torch, big, scale, dev, smi, "mesh round", "scale100k round", SEED + 29,
        lambda mesh: sharded.make_sharded_round(mesh, strategy=scale.method,
                                                batch_size=scale.batch_size,
                                                **scale.method_kwargs),
        lambda params: lambda before, picks: _mi_gaps(torch, before, params,
                                                      scale.method_kwargs, picks))

    base = load_config(str(HARNESS_CONFIG), RING_OVERRIDES)
    for method in RING_METHODS:
        before = rbf_hopper.LAUNCHES
        res = _sharded_vs_serial(
            torch, ds, dataclasses.replace(base, method=method), dev, f"ring {method}",
            lambda st, p, picks, method=method: _ring_gaps(torch, method, st, p, picks))
        check(all(g <= EMOC_TIE_RTOL for g in res.get("gaps", [])),
              f"{method}: sharded and serial picks differ only by score ties")
        s, m = res["serial"], res["sharded"]
        print(f"sharded ring {method} ({ds.n} rows, {base.n_rounds} rounds): MAP serial "
              f"{[round(float(v), 6) for v in s['map']]}, sharded "
              f"{[round(float(v), 6) for v in m['map']]}; select ms steady serial "
              f"{s['select_ms_steady']:.3f}, sharded {m['select_ms_steady']:.3f}; update ms "
              f"steady serial {s['update_ms_steady']:.3f}, sharded {m['update_ms_steady']:.3f}; "
              f"launches {rbf_hopper.LAUNCHES - before} [{smi}]")
    launches = dict(rbf_hopper.ROUTE_LAUNCHES)
    with _uncounted():
        known = _known_programs()
        rise100 = _cohort_rise_at(torch, big, cfg, dev)
        _print_programs(_phase_programs(known), known, f"cohort at {big.n} rows", smi)
    if rise25 is not None:
        fit = _fit_budget(rise25, ds.n, rise100, big.n, CAP)
        print(f"cohort budget fit from {ds.n} and {big.n} rows: select {fit['copies']:.3f} "
              f"(cap, N) copies + {fit['fixed'] / 2**20:.2f} MiB a session; update per "
              f"session {rise25['batch_feedback'] / 2**20:.2f} MiB at {ds.n}, "
              f"{rise100['batch_feedback'] / 2**20:.2f} MiB at {big.n} [{smi}]")
    _check_budget(rise100, CAP, big.n)
    print(f"sharded phase: {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "shapes": shapes, "big": big, "per_replay": per_replay}


def _fit_budget(r_a: dict, n_a: int, r_b: dict, n_b: int, cap: int) -> dict:
    """The select budget's per-session terms through two measurements:
    ``copies`` (cap, N) f32 buffers plus ``fixed`` bytes."""
    copies = (r_b["batch_select"] - r_a["batch_select"]) / ((n_b - n_a) * cap * 4)
    return {"copies": copies, "fixed": r_a["batch_select"] - copies * n_a * cap * 4}


def _cohort_rise_at(torch, ds, cfg, dev) -> dict:
    """The device memory one stacked selection and one stacked update of
    ``COHORT_K`` production sessions add per session over ``ds`` (two rounds,
    the larger rise of each)."""
    from ital_tpu_torch import serve

    svc = serve.RetrievalService(
        ds.x, length_scale=cfg.gp.length_scale, var=cfg.gp.var, noise=cfg.gp.noise, cap=CAP,
        label_prob=cfg.user.label_prob, mistake_prob=cfg.user.mistake_prob,
        method_kwargs=cfg.method_kwargs, device=dev)
    rng = np.random.default_rng(SEED + 13)
    classes = [int(c) for c in rng.choice(ds.classes, COHORT_K // 2, replace=False)]
    queries = [(int(q), c) for c in classes for q in ds.queries_for_class(c, rng, 2)]
    user = _user(rng, ds, cfg.user.label_prob, cfg.user.mistake_prob)
    sids = []
    for q, _ in queries:
        sids.append(svc.create_session())
        svc.set_query(sids[-1], q)
    rise = {"batch_select": 0, "batch_feedback": 0}

    def measured(kind, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        allocated = torch.cuda.memory_allocated()
        out = fn()
        torch.cuda.synchronize()
        rise[kind] = max(rise[kind], (torch.cuda.max_memory_allocated() - allocated) / COHORT_K)
        return out

    for _ in range(2):
        picks = measured("batch_select", lambda: svc.next_batch_many(sids, SERVE_K))
        answers = {a: user(picks[a], c) for a, (_, c) in zip(sids, queries)}
        measured("batch_feedback", lambda: svc.feedback_many(answers))
    return rise


def _big_kernel_times(torch, big, scale, dev, smi: str) -> list:
    """The kernel at the whole-corpus shapes the 100 000-row path adds, f32,
    with b2: against the plain version and against its bound."""
    x = torch.from_numpy(big.x).to(dev)
    x2 = (x * x).sum(-1)
    rng = np.random.default_rng(SEED + 17)
    ls = torch.tensor(scale.gp.length_scale, device=dev)
    var = torch.tensor(scale.gp.var, device=dev)
    n, d = big.x.shape
    return _kernel_shapes(torch, "sharded", [
        (f"{m}x{n}x{d}", x[torch.from_numpy(rng.choice(n, size=m, replace=False)).to(dev)], x,
         {"b2": x2}) for m in (CAP, 4)], ls, var, smi, other_route=True)


def _per_session(calls: list, n_sessions: int, rounds: int, cohort: bool) -> list:
    """``[session][round]`` picks from the calls of a cohort (call r: round r
    of every session) or of sessions run one after another."""
    if cohort:
        return [[calls[r][k] for r in range(rounds)] for k in range(n_sessions)]
    rows = [row for call in calls for row in call]
    return [rows[k * rounds:(k + 1) * rounds] for k in range(n_sessions)]


def _mesh_vs_single(torch, big, scale, dev, mode: str, change: dict, smi: str) -> dict:
    """The runner's ``change`` mode on the mesh (counted) beside the same
    plan on one device (``mesh_devices = 0``, uncounted) run round by round,
    whose state before each round the check reads: the cohort's per-round
    programs (``query_batch``; its fused program gives the same picks and
    curves, phase 8) or the serial run (for ``fused_sessions`` alone).
    Picks agree round by round up to the first round whose picks differ by
    MI ties (on the single-device state), the AP curves while they agree.
    Returns both results."""
    from ital_tpu_torch import runner
    from ital_tpu_torch.models import gp as gp_mod
    from ital_tpu_torch.ops import rbf_hopper
    from ital_tpu_torch.select.base import StrategyParams

    cohort = change.get("query_batch", 0) > 1
    per_round = {k: v for k, v in change.items() if k != "fused_sessions"}
    record, res = [], {}
    for run, mesh in (("single", 0), ("mesh", 8)):
        cfg = dataclasses.replace(scale, mesh_devices=mesh, **(per_round if run == "single"
                                                                else change))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = rbf_hopper.LAUNCHES
        with (_uncounted() if run == "single" else contextlib.nullcontext()), \
                ((_record_cohort_programs(record, keep_stacks=True) if cohort
                  else _record_serial("ital", record)) if run == "single"
                 else contextlib.nullcontext()):
            res[run] = runner.run_experiment(cfg, big, device=dev)
        torch.cuda.synchronize()
        res[run]["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
        res[run]["launches"] = rbf_hopper.LAUNCHES - before
    check(res["mesh"]["mesh_devices"] == 1 and res["mesh"]["fused"] is True,
          f"mesh {mode}: a fused run on the one card")
    rounds, n_sess = scale.n_rounds, len(res["single"]["sessions"])
    if cohort:  # one cohort: call r holds round r of every session
        serial_calls = [([gp_mod.gp_session_copy(gp_mod.session_state(st, k))
                          for k in range(st.k)], res["single"]["picks"][:, r].tolist())
                        for r, (st, _) in enumerate(record)]
    else:
        serial_calls = [([state], [batch]) for state, batch in record]
    single = _per_session([c[1] for c in serial_calls], n_sess, rounds, cohort)
    states = _per_session([c[0] for c in serial_calls], n_sess, rounds, cohort)
    on_mesh = [res["mesh"]["picks"][k].tolist() for k in range(n_sess)]
    params = StrategyParams.create(dev, label_prob=scale.user.label_prob,
                                   mistake_prob=scale.user.mistake_prob)
    apart = []
    with _uncounted():
        for k in range(n_sess):
            r = next((r for r in range(rounds) if single[k][r] != on_mesh[k][r]), rounds)
            if r < rounds:
                gaps = _mi_gaps(torch, states[k][r], params, scale.method_kwargs, on_mesh[k][r])
                print(f"mesh {mode} session {k}: round {r} single {single[k][r]}, mesh "
                      f"{on_mesh[k][r]}; MI gaps on the single-device state {gaps}")
                check(all(0 <= g <= MI_TIE_ATOL for g in gaps),
                      f"mesh {mode}: picks differ only by MI ties")
            check(np.abs(res["mesh"]["ap"][k, :r] - res["single"]["ap"][k, :r]).max(
                initial=0.0) <= 1e-6, f"mesh {mode}: AP curves agree while the picks do")
            apart.append(r)
    for run in ("single", "mesh"):
        r = res[run]
        # A fused cohort's select_ms is the whole cohort's time, a fused
        # session's per round; the per-round runs' per round.
        total = (r["select_ms"] if cohort else r["select_ms"] * rounds) if run == "mesh" else \
            (r["select_ms"] if cohort else r["select_ms"] + r["update_ms"]) * rounds
        what = (f"{'cohort of ' + str(change['query_batch']) if cohort else 'session'} "
                f"{total:.3f} ms mean for {rounds} rounds ({total / rounds:.3f} ms a round), "
                f"first {r['first_round_ms']:.1f} ms")
        print(f"mesh {mode} {run}: MAP {[round(float(m), 6) for m in r['map']]}; {what}; "
              f"device memory peak {r['peak_mib']:.1f} MiB; launches {r['launches']} [{smi}]")
    print(f"mesh {mode}: first round whose picks differ, per session: {apart} of {rounds}")
    return res


def _mesh_kernel_shapes(torch, big, scale, dev, smi: str) -> list:
    """The kernel at the stacked shard shapes the mesh cohort launches at
    100 000 x 512: the cohort update's new rows against the shard (K b, N)
    and the greedy step's shard against the K partial batches (N, K t), at
    K = 4, b = 4, t = 3; against the plain version and the bound."""
    x = torch.from_numpy(big.x).to(dev)
    x2 = (x * x).sum(-1)
    rng = np.random.default_rng(SEED + 19)
    ls = torch.tensor(scale.gp.length_scale, device=dev)
    var = torch.tensor(scale.gp.var, device=dev)
    k, n, d = MESH_QB, big.n, big.x.shape[1]

    def rows(m):
        return x[torch.from_numpy(rng.choice(n, size=m, replace=False)).to(dev)]

    new, part = rows(k * SERVE_K), rows(k * (SERVE_K - 1))
    return _kernel_shapes(torch, "mesh cohort", [
        (f"({k * SERVE_K}, {n}, {d}) b2", new, x, {"b2": x2}),
        (f"({n}, {k * (SERVE_K - 1)}, {d}) a2", x, part, {"a2": x2})], ls, var, smi)


def _kernel_shapes(torch, what: str, shapes, ls, var, smi: str,
                   other_route: bool = False) -> list:
    """Each ``(name, a, b, norms)`` of ``shapes`` through the kernel, f32 or
    a bf16 corpus, against its plain version (error within ``F32_ATOL`` or
    ``BF16_ATOL`` x var, event times in turns, device time) and
    against its bound; with ``other_route``, also the route the router did
    not pick, forced, in the same turns.  Uncounted: comparisons, not the
    path."""
    from ital_tpu_torch.ops import rbf_hopper
    from ital_tpu_torch.ops.kernels import rbf_kernel, rbf_kernel_plain

    out = []
    with _uncounted():
        for name, a, b, norms in shapes:
            d = a.shape[1]
            bf16 = a.dtype == torch.bfloat16
            atol = (BF16_ATOL if bf16 else F32_ATOL) * float(var)
            route = rbf_hopper.choose_route(a.shape[0], b.shape[0], d, a.dtype, a.data_ptr(),
                                            b.data_ptr()).name
            fns = [functools.partial(rbf_kernel, a, b, ls, var, **norms),
                   functools.partial(rbf_kernel_plain, a, b, ls, var, **norms)]
            other = {"wgmma": "tile", "tile": "wgmma"}[route]
            if other_route and (other == "tile" or rbf_hopper.wgmma_takes(
                    a.shape[0], b.shape[0], d, a.dtype, a.data_ptr(), b.data_ptr())):
                fns.append(functools.partial(rbf_hopper.rbf_tile, a, b, ls, var, _route=other,
                                             **norms))
            want = fns[1]()
            errs = [float((fn() - want).abs().max()) for fn in fns[::2]]
            del want
            timed = _time_turns_ms(torch, fns)
            (ms, spread), (plain_ms, plain_spread) = timed[:2]
            dev_us = _device_us(torch, fns[0])
            bound, bound_by = rbf_bound_ms(a.shape[0], b.shape[0], d, bf16,
                                           sum(v.numel() for v in norms.values()), same=a is b)
            label = "bf16" if bf16 else "f32"
            forced = (f"; forced {other} route: max_abs_err {errs[1]:.3e}, per launch ms "
                      f"{timed[2][0]:.4f} (spread {timed[2][1]:.4f})" if len(fns) > 2 else "")
            print(f"kernel: {what} {name} {label}: route {route}; max_abs_err {errs[0]:.3e} "
                  f"(atol {atol:.0e}); per launch ms {ms:.4f} (spread {spread:.4f}), "
                  f"plain {plain_ms:.4f} (spread {plain_spread:.4f}); device us {dev_us:.2f}; "
                  f"bound {bound * 1e3:.2f} us ({bound_by}), {bound / ms * 100:.1f} % of it"
                  f"{forced} [{smi}]")
            check(all(e <= atol for e in errs), f"{what} {name} {label}: kernel against plain")
            _check_bound(f"{what} {name} {label}", ms, dev_us, bound)
            rec = {"shape": f"{name} {label}", "route": route, "max_abs_err": errs[0], "ms": ms,
                   "plain_ms": plain_ms, "device_us": dev_us, "bound_ms": bound,
                   "bound_by": bound_by}
            if len(fns) > 2:
                rec.update(other_route=other, other_ms=timed[2][0], other_max_abs_err=errs[1])
            out.append(rec)
    return out


def _mesh_service(torch, big, cfg, dev, smi: str) -> dict:
    """The mesh service (a mesh of one card, NCCL) over ``big`` at the
    production selection options: ``COHORT_K`` ITAL sessions through
    ``/batch_select`` and ``/batch_feedback`` for ``SERVE_ROUNDS`` rounds,
    beside twins on a single-device service served one request at a time
    (uncounted), which absorb the same answers; then ``/ranking``,
    ``/learn`` (against the twin's) and ``/snapshot`` -> ``/restore``;
    before ``/ranking``, the mesh programs against eager
    (:func:`_mesh_service_turns`).  Closes the service, and its process
    group, before it returns the programs' launches per replay."""
    from ital_tpu_torch import serve
    from ital_tpu_torch.ops import rbf_hopper

    kw = dict(length_scale=cfg.gp.length_scale, var=cfg.gp.var, noise=cfg.gp.noise, cap=CAP,
              label_prob=cfg.user.label_prob, mistake_prob=cfg.user.mistake_prob,
              method_kwargs=dict(cfg.method_kwargs), corpus_name=big.name, device=dev)
    t0 = time.perf_counter()
    mesh = serve.RetrievalService(big.x, mesh_devices=1, **kw)
    start_ms = (time.perf_counter() - t0) * 1e3
    times, launches, peaks = {}, {}, {}

    def timed(kind, fn):
        """One request; its host time runs until the device is idle again."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = rbf_hopper.LAUNCHES
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.setdefault(kind, []).append((time.perf_counter() - t) * 1e3)
        launches.setdefault(kind, []).append(rbf_hopper.LAUNCHES - before)
        peaks[kind] = max(peaks.get(kind, 0), torch.cuda.max_memory_allocated())
        return out

    try:
        h = mesh.health()
        check(h["mesh_devices"] == 1 and mesh._world.mesh.backend == "nccl",
              f"the mesh service runs a world of one card on NCCL: {h}")
        with _uncounted():
            single = serve.RetrievalService(big.x, **kw)
        rng = np.random.default_rng(SEED + 23)
        classes = [int(c) for c in rng.choice(big.classes, COHORT_K // 2, replace=False)]
        queries = [(int(q), c) for c in classes for q in big.queries_for_class(c, rng, 2)]
        user = _user(rng, big, cfg.user.label_prob, cfg.user.mistake_prob)
        cohort, twins = [], []
        for q, _ in queries:
            sid = timed("create", mesh.create_session)
            timed("query", lambda: mesh.set_query(sid, q))
            cohort.append(sid)
            with _uncounted():
                twins.append(single.create_session())
                single.set_query(twins[-1], q)
        round_ms = []
        for r in range(SERVE_ROUNDS):
            picks = timed("batch_select", lambda: mesh.next_batch_many(cohort, SERVE_K))
            for j, (a, b) in enumerate(zip(cohort, twins)):
                with _uncounted():
                    alone = single.next_batch(b, SERVE_K)
                check(len(set(picks[a])) == SERVE_K, f"mesh serve round {r}: distinct picks")
                if picks[a] != alone:
                    twin = single._entry(b)[0]
                    with _uncounted():
                        gaps = _tie_gaps(twin, picks[a], twin.method_kwargs)
                    print(f"mesh serve round {r} session {j}: mesh {picks[a]} single {alone}; "
                          f"refined-MI gaps {gaps} (tie atol {MI_TIE_ATOL})")
                    check(all(abs(g) <= MI_TIE_ATOL for g in gaps),
                          "mesh and single-device batches differ only by ties")
            answers = {a: user(picks[a], c) for a, (_, c) in zip(cohort, queries)}
            got = timed("batch_feedback", lambda: mesh.feedback_many(answers))
            round_ms.append(times["batch_select"][-1] + times["batch_feedback"][-1])
            for a, b in zip(cohort, twins):
                with _uncounted():
                    alone = single.feedback(b, answers[a])
                    err = float(np.abs(mesh._world.run(_mesh_scores, a)
                                       - single._entry(b)[0].scores()).max())
                check(got[a] == alone == {"labeled": 1 + (r + 1) * SERVE_K},
                      f"mesh serve round {r}: labeled {got[a]} {alone}")
                check(err <= CPU_MU_ATOL, f"mesh serve round {r}: mu within {CPU_MU_ATOL} "
                                          f"of the twin's ({err})")
        per_replay = _mesh_service_turns(torch, mesh, cfg, queries, user, smi)
        a, b = cohort[0], twins[0]
        ranked = timed("ranking", lambda: mesh.ranking(a, 20))
        with _uncounted():
            want = single._entry(b)[0].scores()
        check(len(set(ranked["top"])) == 20 and max(ranked["top"]) < big.n,
              "the mesh ranking names 20 real rows")
        check(np.allclose(ranked["scores"], want[ranked["top"]], atol=CPU_MU_ATOL),
              "the mesh ranking's scores are the twin's")
        learned = timed("learn", lambda: mesh.learn(a, steps=LEARN_STEPS))
        with _uncounted():
            twin_learned = single.learn(b, steps=LEARN_STEPS)
        print(f"mesh serve learn: mesh {learned}, single-device {twin_learned}")
        check(all(abs(learned[f] / twin_learned[f] - 1) <= LEARN_RTOL for f in learned),
              f"the mesh /learn agrees with the single-device one within {LEARN_RTOL}")
        blob = timed("snapshot", lambda: mesh.snapshot(a))
        restored = timed("restore", lambda: mesh.restore(blob))
        check(mesh.ranking(restored, 20)["top"] == mesh.ranking(a, 20)["top"],
              "the restored session ranks as the snapshot's")
    finally:
        mesh.close()
    check(all(n > 0 for k in ("query", "batch_select", "batch_feedback", "learn")
              for n in launches[k]), f"the kernel launched in every mesh request: {launches}")
    print(f"mesh serve: start {start_ms:.1f} ms (corpus {big.n} x {big.x.shape[1]} to the card); "
          f"cohort round (batch_select + batch_feedback of {COHORT_K}) ms {round_ms} [{smi}]")
    for kind, ms in times.items():
        print(f"mesh serve {kind}: {len(ms)} requests, host ms median {np.median(ms):.3f} min "
              f"{min(ms):.3f} max {max(ms):.3f}; kernel launches per request "
              f"{min(launches[kind])}-{max(launches[kind])}; device memory peak "
              f"{peaks[kind] / 2**20:.1f} MiB [{smi}]")
    return per_replay


def _mesh_scores(ctx, sid):
    return ctx.sessions[sid].scores()


def _mesh_turns(torch, run, what: str) -> list:
    """``run(mode)`` in graphed, eager, eager, graphed turns; each turn's
    result gains the programs it captured (``graphs.captures()``)."""
    from ital_tpu_torch import graphs

    out = []
    for mode in GRAPH_TURNS:
        c0 = graphs.captures()
        res = run(mode)
        res["mode"], res["captures"] = mode, graphs.captures() - c0
        out.append(res)
    check(out[0]["captures"] > 0 and out[3]["captures"] == 0 and out[1]["captures"] == 0,
          f"{what}: the first graphed turn captures, the second replays "
          f"({[t['captures'] for t in out]})")
    return out


def _mesh_launches(progs: list, what: str) -> dict:
    """Kernel launches per replay of each mesh program, keyed ``what`` and
    its name (the largest, where a name has several signatures)."""
    out: dict = {}
    for p in progs:
        if p.mesh is not None:
            key = f"{what}: {p.name}"
            out[key] = max(out.get(key, 0), sum(p.launches.values()))
    return out


def _ms(values) -> str:
    return f"{np.median(values):.3f} (min {min(values):.3f}, max {max(values):.3f})"


def _held_to_eager(turns: list, tie_gaps, what: str) -> None:
    """Hold the graphed turns of a session (``_mesh_turns``' first and last)
    to the first eager turn: picks equal round by round, else
    ``tie_gaps(before, picks)`` (the eager state the round selected from,
    the graphed picks) all within ``MI_TIE_ATOL`` and the histories part
    there; AP and ``mu`` within ``GRAPH_MU_ATOL`` while they agree."""
    eager = turns[1]
    check(turns[2]["picks"] == eager["picks"], f"{what}: the eager turns agree")
    for t in (turns[0], turns[3]):
        for r, (gp, ep) in enumerate(zip(t["picks"], eager["picks"])):
            if gp != ep:
                with _uncounted():
                    gaps = tie_gaps(eager["before"][r], gp)
                print(f"{what}: round {r} graphed {gp} eager {ep}; MI gaps on the eager state "
                      f"{gaps} (tie atol {MI_TIE_ATOL})")
                check(all(abs(g) <= MI_TIE_ATOL for g in gaps),
                      f"{what}: graphed and eager picks differ only by MI ties")
                break
            err = float((t["mu"][r] - eager["mu"][r]).abs().max())
            check(err <= GRAPH_MU_ATOL and abs(t["ap"][r] - eager["ap"][r]) <= 1e-6,
                  f"{what} round {r}: graphed mu and AP within {GRAPH_MU_ATOL} of eager ({err})")


def _mesh_round_turns(torch, big, scale, dev, smi: str, what: str, key: str, seed: int,
                      make_round, tie_gaps, layout=None, refit=None, after=None) -> dict:
    """A per-round mesh session on scale100k (a NCCL mesh of one) in
    graphed, eager, eager, graphed turns on one mesh: ``make_round(mesh)``
    gives the round, ``layout(state, mesh)`` lays out the state after
    ``gp_set_query``, ``tie_gaps(params)`` the tie check of
    ``_held_to_eager``.  ``refit(mesh)``, where given, is refit
    ``BIGCAP_FITS`` times on a copy of each turn's last state, its ``mu``
    held to eager where the picks agree.  Prints each turn's synchronized
    select, update (and refit) ms and each program's captures, launches per
    replay and static MiB; ``after(start, one_round, fit, last)`` runs on
    the mesh before it closes.  Returns the programs' launches per replay,
    keyed ``key``."""
    from ital_tpu_torch import runner
    from ital_tpu_torch.models import gp as gp_mod
    from ital_tpu_torch.parallel import make_mesh, sharded
    from ital_tpu_torch.select.base import StrategyParams
    from ital_tpu_torch.utils.logging import Timer

    rng = np.random.default_rng(seed)
    cls = int(rng.choice(big.classes))
    q = int(big.queries_for_class(cls, rng, 1)[0])
    b = scale.batch_size
    with make_mesh(1, device=dev) as mesh:
        known = _known_programs()
        # A world of one's shard is the whole corpus.
        state0 = gp_mod.gp_init(torch.from_numpy(big.x).to(dev), scale.gp.length_scale,
                                scale.gp.var, scale.gp.noise, scale.cap,
                                corpus_dtype=scale.gp.corpus_dtype or None)
        params = StrategyParams.create(dev, label_prob=scale.user.label_prob,
                                       mistake_prob=scale.user.mistake_prob)
        relevant = torch.from_numpy(np.ascontiguousarray(big.relevance[:, cls])).to(dev)
        sel_forbid, exclude = sharded.make_masks(big.n, big.n, q, dev)
        round_fn = make_round(mesh)
        set_query = sharded.make_sharded_set_query(mesh)
        fit = refit(mesh) if refit is not None else None

        def start():
            st = set_query(gp_mod.gp_session_copy(state0), q)
            return st if layout is None else layout(st, mesh)

        def one_round(st, r, timer=None):
            draws = runner.round_draws(scale.seed, 0, cls, q, r, b, dev)
            return round_fn(st, *draws, relevant, sel_forbid, exclude, params, timer=timer,
                            n_real=big.n)

        def session(mode):
            timer = Timer(dev)
            out = {"picks": [], "ap": [], "mu": [], "before": [], "fit_ms": []}
            with _graphed_or_eager(mode):
                st = start()
                for r in range(scale.n_rounds):
                    if mode == "eager":  # the states the ties are read on
                        out["before"].append(gp_mod.gp_session_copy(st))
                    st, batch, ap, _ = one_round(st, r, timer)
                    out["picks"].append(batch.tolist())
                    out["ap"].append(float(ap))
                    out["mu"].append(st.mu.clone())
                if fit is not None:
                    copy = gp_mod.gp_session_copy(st)
                    for _ in range(BIGCAP_FITS):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        fit(copy)
                        torch.cuda.synchronize()
                        out["fit_ms"].append((time.perf_counter() - t0) * 1e3)
                    out["fit_mu"] = copy.mu.clone()
            out.update({f"{k}_ms": [v * 1e3 for v in timer.values[k]]
                        for k in ("select", "update")})
            out["last"] = st
            return out

        turns = _mesh_turns(torch, session, what)
        _held_to_eager(turns, tie_gaps(params), what)
        if fit is not None and turns[0]["picks"] == turns[1]["picks"] == turns[3]["picks"]:
            errs = [float((t["fit_mu"] - turns[1]["fit_mu"]).abs().max()) for t in turns]
            check(max(errs) <= GRAPH_MU_ATOL, f"{what} refit: graphed mu within "
                                              f"{GRAPH_MU_ATOL} of eager ({errs})")
        for t in turns:
            refit_ms = f" refit ms {_ms(t['fit_ms'])};" if t["fit_ms"] else ""
            print(f"{what} {t['mode']} (scale100k, cap {scale.cap}, {big.n} x {big.x.shape[1]}, "
                  f"world of 1 on NCCL): select ms {_ms(t['select_ms'])}; update ms "
                  f"{_ms(t['update_ms'])};{refit_ms} captures {t['captures']}; picks "
                  f"{t['picks']} [{smi}]")
        if after is not None:
            after(start, one_round, fit, turns[3]["last"])
        progs = _phase_programs(known)
        _print_programs(progs, known, what, smi)
        return _mesh_launches(progs, key)


def _mesh_plan(big, k: int, seed: int) -> list:
    """``k`` (rep, class, query) sessions, two queries per class."""
    rng = np.random.default_rng(seed)
    classes = [int(c) for c in rng.choice(big.classes, k // 2, replace=False)]
    return [(0, c, int(q)) for c in classes for q in big.queries_for_class(c, rng, 2)]


def _fused_gaps(torch, mesh, state0, cfg, plan_k, params, masks, picks, r) -> list:
    """MI gaps of a fused program's round-``r`` picks on the state the
    per-round mesh path (eager, uncounted) reaches from the same draws."""
    from ital_tpu_torch import graphs, runner
    from ital_tpu_torch.models import gp as gp_mod
    from ital_tpu_torch.parallel import sharded

    _, c, q = plan_k
    round_fn = sharded.make_sharded_round(mesh, strategy=cfg.method, batch_size=cfg.batch_size,
                                          **cfg.method_kwargs)
    with _uncounted(), graphs.eager():
        st = sharded.make_sharded_set_query(mesh)(gp_mod.gp_session_copy(state0), q)
        for rnd in range(r):
            draws = runner.round_draws(cfg.seed, 0, c, q, rnd, cfg.batch_size, state0.mu.device)
            st = round_fn(st, *draws, *masks, params)[0]
        return _mi_gaps(torch, st, params, cfg.method_kwargs, picks)


def _mesh_fused_turns(torch, big, scale, dev, smi: str) -> dict:
    """The fused session and the fused cohort of ``MESH_QB`` as mesh programs
    (``make_sharded_session`` / ``make_sharded_cohort``) on a NCCL mesh of
    one over scale100k, ``MESH_QB`` sessions of ``scale.n_rounds`` rounds,
    in graphed, eager, eager, graphed turns on one mesh: picks and curves
    equal to eager (else MI ties on the per-round path's state); each
    turn's synchronized ms; each program's captures, launches per replay
    and held MiB.  Returns the programs' launches per replay."""
    from ital_tpu_torch import runner
    from ital_tpu_torch.models import gp as gp_mod
    from ital_tpu_torch.parallel import make_mesh, sharded
    from ital_tpu_torch.select.base import StrategyParams

    plan = _mesh_plan(big, MESH_QB, SEED + 31)
    b, n, kw = scale.batch_size, big.n, scale.method_kwargs
    opts = dict(strategy=scale.method, batch_size=b, n_rounds=scale.n_rounds, **kw)
    with make_mesh(1, device=dev) as mesh:
        known = _known_programs()
        state0 = gp_mod.gp_init(torch.from_numpy(big.x).to(dev), scale.gp.length_scale,
                                scale.gp.var, scale.gp.noise, scale.cap,
                                corpus_dtype=scale.gp.corpus_dtype or None)
        params = StrategyParams.create(dev, label_prob=scale.user.label_prob,
                                       mistake_prob=scale.user.mistake_prob)
        relevant = torch.from_numpy(np.stack([big.relevance[:, c] for _, c, _ in plan])).to(dev)
        pad = torch.zeros(n, dtype=torch.bool, device=dev)
        exclude = torch.stack([sharded.make_masks(n, n, q, dev)[1] for *_, q in plan])
        set_query = sharded.make_sharded_set_query(mesh)
        session = sharded.make_sharded_session(mesh, **opts)
        cohort = sharded.make_sharded_cohort(mesh, **opts)

        def queried():
            return [set_query(gp_mod.gp_session_copy(state0), q) for *_, q in plan]

        def run_sessions(mode):
            out = {"aps": [], "picks": [], "ms": []}
            with _graphed_or_eager(mode):
                for k, (rep, c, q) in enumerate(plan[:FUSED_SESSIONS]):
                    st = set_query(gp_mod.gp_session_copy(state0), q)
                    draws = [runner.round_draws(scale.seed, rep, c, q, r, b, dev)
                             for r in range(scale.n_rounds)]
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    _, aps, picks = session(st, draws, relevant[k], pad, exclude[k], params,
                                            picks=True)
                    torch.cuda.synchronize()
                    out["ms"].append((time.perf_counter() - t0) * 1e3)
                    out["aps"].append(aps.tolist())
                    out["picks"].append(picks.tolist())
            return out

        def run_cohort(mode):
            with _graphed_or_eager(mode):
                st = gp_mod.stack_states(queried())
                draws = [runner._cohort_draws(scale, plan, r, dev) for r in range(scale.n_rounds)]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, aps, picks = cohort(st, draws, relevant, pad, exclude, params, picks=True)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
            return {"aps": aps.tolist(), "picks": picks.transpose(0, 1).tolist(), "ms": [ms]}

        for what, run in (("fused session", run_sessions), (f"fused cohort of {MESH_QB}",
                                                             run_cohort)):
            turns = _mesh_turns(torch, run, f"mesh {what}")
            eager = turns[1]
            check(turns[2]["picks"] == eager["picks"], f"mesh {what}: the eager turns agree")
            for t in (turns[0], turns[3]):
                for k, (gk, ek) in enumerate(zip(t["picks"], eager["picks"])):
                    r = next((r for r in range(len(gk)) if gk[r] != ek[r]), len(gk))
                    if r < len(gk):
                        gaps = _fused_gaps(torch, mesh, state0, scale, plan[k], params,
                                           (relevant[k], pad, exclude[k]), gk[r], r)
                        print(f"mesh {what} session {k}: round {r} graphed {gk[r]} eager {ek[r]};"
                              f" MI gaps on the per-round state {gaps}")
                        check(all(0 <= g <= MI_TIE_ATOL for g in gaps),
                              f"mesh {what}: graphed and eager picks differ only by MI ties")
                    check(np.abs(np.asarray(t["aps"][k][:r]) - np.asarray(eager["aps"][k][:r]))
                          .max(initial=0.0) <= 1e-6, f"mesh {what}: curves agree with eager")
            for t in turns:
                print(f"mesh {what} {t['mode']} (scale100k, {scale.n_rounds} rounds): ms "
                      f"{_ms(t['ms'])} a call; captures {t['captures']} [{smi}]")
        progs = _phase_programs(known)
        _print_programs(progs, known, "mesh fused", smi)
        return _mesh_launches(progs, "scale100k fused")


def _mesh_ring_cohort(torch, ds, dev, smi: str) -> dict:
    """EMOC's mesh cohort selection of ``MESH_QB`` sessions as one stacked
    program (the ring's blocks shared by the sessions) against
    ``MESH_QB`` single mesh selections, each graphed and eager in turns, on
    a NCCL mesh of one over the 25 000-row harness corpus: equal picks (else
    EMOC ties on the session's state); synchronized ms and the programs'
    launches per replay."""
    from ital_tpu_torch.models import gp as gp_mod
    from ital_tpu_torch.parallel import make_mesh, sharded
    from ital_tpu_torch.select.base import StrategyParams
    from ital_tpu_torch.utils.config import load_config

    base = load_config(str(HARNESS_CONFIG), RING_OVERRIDES)
    plan = _mesh_plan(ds, MESH_QB, SEED + 37)
    n, b = ds.n, base.batch_size
    with make_mesh(1, device=dev) as mesh:
        known = _known_programs()
        state0 = gp_mod.gp_init(torch.from_numpy(ds.x).to(dev), base.gp.length_scale,
                                base.gp.var, base.gp.noise, base.cap)
        set_query = sharded.make_sharded_set_query(mesh)
        states = [set_query(gp_mod.gp_session_copy(state0), q) for *_, q in plan]
        params = StrategyParams.create(dev, label_prob=base.user.label_prob,
                                       mistake_prob=base.user.mistake_prob)
        pad = torch.zeros(n, dtype=torch.bool, device=dev)
        stacked = sharded.make_sharded_cohort_select(mesh, strategy="emoc", batch_size=b)
        single = sharded.make_sharded_select(mesh, strategy="emoc", batch_size=b)
        forms = {
            "one stacked program": lambda: stacked(states, [None] * len(states), pad, params,
                                                   n_real=n),
            f"{len(states)} single programs": lambda: torch.stack(
                [single(s, None, pad, params, n_real=n) for s in states])}
        picks = {}
        for what, fn in forms.items():
            def run(mode, fn=fn):
                with _graphed_or_eager(mode):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = fn()
                    torch.cuda.synchronize()
                return {"picks": out.tolist(), "ms": [(time.perf_counter() - t0) * 1e3]}

            turns = _mesh_turns(torch, run, f"mesh ring cohort, {what}")
            picks[what] = [t["picks"] for t in turns]
            print(f"mesh ring cohort emoc ({n} x {ds.x.shape[1]}, K = {len(states)}), {what}: "
                  + "; ".join(f"{t['mode']} {t['ms'][0]:.3f} ms" for t in turns) + f" [{smi}]")
        progs = _phase_programs(known)
        _print_programs(progs, known, "mesh ring cohort", smi)
        launches = _mesh_launches(progs, "emoc cohort")
    # _ring_gaps scores on a mesh of its own: after this one is closed.
    want = picks[f"{len(states)} single programs"][1]
    for what, runs in picks.items():
        for got in runs:
            for k, (g, w) in enumerate(zip(got, want)):
                if g != w:
                    with _uncounted():
                        gaps = _ring_gaps(torch, "emoc", states[k], params, g)
                    print(f"mesh ring cohort {what} session {k}: {g}, eager single {w}; "
                          f"relative gaps {gaps}")
                    check(all(x <= EMOC_TIE_RTOL for x in gaps),
                          "mesh ring cohort: picks differ only by EMOC ties")
    return launches


def _mesh_service_turns(torch, svc, cfg, queries, user, smi: str) -> dict:
    """On the mesh service (a world of one, NCCL): ``GET /batch`` and
    ``/feedback``, each graphed and eager in turns, and a ``/batch_select``
    of ``COHORT_K`` sessions of two user models as one program against one
    per user model (the split the service made before), each graphed and
    eager in turns: equal picks (else MI ties on the session's state), means
    within ``GRAPH_MU_ATOL``; synchronized ms; the device's busy share of a
    replayed fetch and of an eager one (``torch.profiler``).  Returns the
    programs' launches per replay."""
    known = _known_programs()
    models = ({"label_prob": cfg.user.label_prob, "mistake_prob": cfg.user.mistake_prob},
              {"label_prob": MIXED_LABEL_PROB, "mistake_prob": MIXED_MISTAKE_PROB})
    sids = []
    for j, (q, _) in enumerate(queries):
        sids.append(svc.create_session(**models[j % 2]))
        svc.set_query(sids[-1], q)
    sess = {sid: svc._entry(sid)[0] for sid in sids}
    saved = {sid: s.generator.get_state() for sid, s in sess.items()}
    kw = dict(cfg.method_kwargs)

    def timed(mode, fn):
        with _graphed_or_eager(mode):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
        return out, [(time.perf_counter() - t0) * 1e3]

    def batch_select(groups):
        def run(mode):
            for sid, s in sess.items():
                s.generator.set_state(saved[sid])
            out, ms = timed(mode, lambda: {k: v for g in groups
                                           for k, v in svc.next_batch_many(g, SERVE_K).items()})
            return {"picks": [out[s] for s in sids], "ms": ms}
        return run

    forms = {"one program": [sids], "one program per user model": [sids[0::2], sids[1::2]]}
    runs = {}
    for what, groups in forms.items():
        runs[what] = _mesh_turns(torch, batch_select(groups), f"mesh /batch_select, {what}")
        print(f"mesh serve /batch_select of {len(sids)} (two user models), {what}: "
              + "; ".join(f"{t['mode']} {t['ms'][0]:.3f} ms" for t in runs[what]) + f" [{smi}]")
    want = runs["one program"][1]["picks"]
    for what, turns in runs.items():
        for t in turns:
            for j, (g, w) in enumerate(zip(t["picks"], want)):
                if g != w:
                    with _uncounted():
                        gaps = _tie_gaps(sess[sids[j]], g, kw)
                    print(f"mesh /batch_select {what} {t['mode']} session {j}: {g}, eager one "
                          f"program {w}; refined-MI gaps {gaps}")
                    check(all(abs(x) <= MI_TIE_ATOL for x in gaps),
                          "mesh /batch_select: picks differ only by MI ties")

    first = sess[sids[0]]

    def fetch(mode):
        first.generator.set_state(saved[sids[0]])
        out, ms = timed(mode, lambda: svc.next_batch(sids[0], SERVE_K))
        return {"picks": out, "ms": ms}

    fetches = _mesh_turns(torch, fetch, "mesh GET /batch")
    check(all(t["picks"] == fetches[1]["picks"] for t in fetches),
          f"mesh GET /batch: graphed picks equal eager ({[t['picks'] for t in fetches]})")
    fb_sids = [svc.create_session() for _ in GRAPH_TURNS]
    for sid in fb_sids:
        svc.set_query(sid, queries[0][0])
    answers = user(fetches[1]["picks"], queries[0][1])
    order = iter(fb_sids)

    def feedback(mode):
        sid = next(order)
        _, ms = timed(mode, lambda: svc.feedback(sid, answers))
        with _uncounted():
            return {"mu": svc._world.run(_mesh_scores, sid), "ms": ms}

    fbs = _mesh_turns(torch, feedback, "mesh /feedback")
    err = max(float(np.abs(t["mu"] - fbs[1]["mu"]).max()) for t in fbs)
    check(err <= GRAPH_MU_ATOL, f"mesh /feedback: graphed mu within {GRAPH_MU_ATOL} of eager "
                                f"({err})")
    for what, turns in (("GET /batch", fetches), ("/feedback", fbs)):
        print(f"mesh serve {what}: " + "; ".join(f"{t['mode']} {t['ms'][0]:.3f} ms"
                                                 for t in turns) + f" [{smi}]")
    busy = {}
    for mode in ("graphed", "eager"):
        with _graphed_or_eager(mode):
            busy[mode] = _device_profile(torch, lambda: first.fetch_unlabelled(SERVE_K))
    print("mesh serve fetch device busy share (torch.profiler, 3 fetches): " + "; ".join(
        f"{m} {'not measured' if b is None else f'{b * 100:.1f} %'}, {ops:.0f} device "
        f"operations a fetch" for m, (b, ops) in busy.items()) + f" [{smi}]")
    progs = _phase_programs(known)
    _print_programs(progs, known, "mesh serve", smi)
    return _mesh_launches(progs, "production serve")


def mesh_phase(torch, ds, big, cfg, dev, smi: str) -> dict:
    """Phase 10: the mesh's fused and cohort programs and the mesh service;
    returns the mesh path's launches by route, the kernel's times at the
    stacked shard shapes and the mesh programs' launches per replay."""
    from ital_tpu_torch import runner
    from ital_tpu_torch.ops import rbf_hopper
    from ital_tpu_torch.utils.config import load_config

    t_phase = time.perf_counter()
    scale = load_config(str(SCALE_CONFIG), MESH_OVERRIDES)
    shapes = _mesh_kernel_shapes(torch, big, scale, dev, smi)
    torch.cuda.synchronize()
    _reset_counts()  # the mesh path's count starts here
    for mode, change in (("query_batch+fused", {"query_batch": MESH_QB, "fused_sessions": True}),
                         ("fused", {"fused_sessions": True})):
        _mesh_vs_single(torch, big, scale, dev, mode, change, smi)
    per_replay = _mesh_fused_turns(torch, big, scale, dev, smi)
    per_replay.update(_mesh_ring_cohort(torch, ds, dev, smi))
    if torch.cuda.device_count() >= 2:
        with _uncounted():
            two = runner.run_experiment(dataclasses.replace(
                scale, mesh_devices=2, query_batch=MESH_QB, fused_sessions=True), big, device=dev)
        check(two["mesh_devices"] == 2 and bool(np.isfinite(two["ap"]).all()),
              "a world of 2 on NCCL runs the cohort")
        print(f"mesh query_batch+fused on a world of 2 (NCCL): MAP "
              f"{[round(float(m), 6) for m in two['map']]}; cohort {two['select_ms']:.3f} ms "
              f"[{smi}]")
    else:
        print(f"mesh: a world of 2 on NCCL did not run ({torch.cuda.device_count()} card)")
    per_replay.update(_mesh_service(torch, big, cfg, dev, smi))
    check(rbf_hopper.LAUNCHES > 0, "the kernel launched on the mesh programs")
    print(f"mesh phase: {time.perf_counter() - t_phase:.1f} s; launches {rbf_hopper.LAUNCHES}")
    return {"launches": dict(rbf_hopper.ROUTE_LAUNCHES), "shapes": shapes,
            "per_replay": per_replay}


@contextlib.contextmanager
def _record_rounds(record: list, *, keep_states: bool):
    """Append ``{"picks", "mu", "state", "programs"}`` (the posterior mean
    after the round, the state itself, and the mesh programs' replays and
    launches per replay so far by name) for each round of the sharded and
    the large-cap per-round paths, and with
    ``keep_states`` ``"before"``: a host copy of the session buffers the
    round selected from (off the card, so the run's memory peak is its own)."""
    from ital_tpu_torch import graphs
    from ital_tpu_torch.models import gp as gp_mod
    from ital_tpu_torch.parallel import bigcap, sharded

    orig = {(bigcap, "make_bigcap_round"): bigcap.make_bigcap_round,
            (sharded, "make_sharded_round"): sharded.make_sharded_round}

    def wrap(make):
        def made(*args, **kwargs):
            round_fn = make(*args, **kwargs)

            def watched(state, *a, **kw):
                before = gp_mod.gp_session_copy(state, "cpu") if keep_states else None
                out = round_fn(state, *a, **kw)
                record.append({"picks": out[1].tolist(), "mu": out[0].mu.clone(),
                               "before": before, "state": out[0], "programs": {
                                   p.name: (p.replays, sum(p.launches.values()))
                                   for p in graphs.programs() if p.mesh is not None}})
                return out

            return watched
        return made

    for (mod, name), make in orig.items():
        setattr(mod, name, wrap(make))
    try:
        yield
    finally:
        for (mod, name), make in orig.items():
            setattr(mod, name, make)


@contextlib.contextmanager
def _keep_snapshot(round_: int, dest: Path):
    """Copy the sharded path's snapshot of round ``round_`` (``next_round``
    ``round_``) to ``dest``, which the runner's next write would replace."""
    from ital_tpu_torch.parallel import sharded

    orig = sharded.save_sharded_session

    def save(mesh, path, state, extra=None):
        orig(mesh, path, state, extra)
        if int(extra["next_round"]) == round_:
            dest.mkdir(parents=True, exist_ok=True)
            shutil.copy(path, dest / Path(path).name)

    sharded.save_sharded_session = save
    try:
        yield
    finally:
        sharded.save_sharded_session = orig


def _refit_split(torch, state, smi: str) -> dict:
    """The distributed refit of ``state`` (a NCCL mesh of one card), step by
    step in CUDA-event times: the kernel's two blocks, the Cholesky, the
    forward solve for beta, the whitening, the rest (mu, sig2), and the
    whole fit as its program (``bigcap_fit``) and eagerly.  Uncounted."""
    from ital_tpu_torch import graphs
    from ital_tpu_torch.models import gp as gp_mod
    from ital_tpu_torch.ops.kernels import rbf_kernel
    from ital_tpu_torch.parallel import bigcap, chol2d, make_mesh, sharded

    h = state.hyper
    with _uncounted(), make_mesh(1, device=state.mu.device) as mesh:
        xl = sharded.gather_rows(mesh, state.x, state.idx)
        active = state.active
        k_row = rbf_kernel(xl, xl, h.length_scale, h.var)
        l = chol2d.chol2d_local(mesh, k_row, active, h.noise)
        k_cols = rbf_kernel(xl, state.x, h.length_scale, h.var, b2=state.x2)
        v = chol2d.whiten2d_local(mesh, l, k_cols)
        y = torch.where(active, state.y, 0.0)[:, None]
        beta = chol2d.solve2d_local(mesh, l, y)[:, 0]
        fit = bigcap.make_bigcap_fit(mesh)
        copy = gp_mod.gp_session_copy(state)

        def eager_fit():
            with graphs.eager():
                fit(copy)

        steps = {
            "blocks": lambda: (rbf_kernel(xl, xl, h.length_scale, h.var),
                               rbf_kernel(xl, state.x, h.length_scale, h.var, b2=state.x2)),
            "cholesky": lambda: chol2d.chol2d_local(mesh, k_row, active, h.noise),
            "beta": lambda: chol2d.solve2d_local(mesh, l, y),
            # with the copy of K that whiten2d_local takes (the fit whitens in place)
            "whitening": lambda: chol2d.whiten2d_local(mesh, l, k_cols),
            "rest": lambda: (v.T @ beta, torch.clamp(h.var - (v * v).sum(0), min=1e-8)),
            "fit": lambda: fit(copy),
            "fit eager": eager_fit,
        }
        times = _time_turns_ms(torch, list(steps.values()), launches=5, runs=3, warmup=1)
        out = {name: ms for name, (ms, _) in zip(steps, times)}
        print("bigcap refit split, event ms per call: " + ", ".join(
            f"{name} {ms:.3f} (spread {spread:.3f})" for name, (ms, spread) in zip(steps, times))
            + f"; the steps sum to "
            f"{sum(t for k, t in out.items() if not k.startswith('fit')):.3f} [{smi}]")
        if state.mu.device.type == "cuda":
            out["kernels_ms"] = _fit_kernels(torch, steps["fit"], out["fit"], smi)
    return out


def _fit_kernels(torch, fit, fit_ms: float, smi: str) -> dict:
    """Device time per fit by kernel (``torch.profiler``, three fits), the
    eight largest, and the device's busy share of the fit's event time."""
    from torch.profiler import ProfilerActivity, profile

    fit()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fit()
        torch.cuda.synchronize()
    kernels = {}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(evt, "self_device_time_total", 0.0) or evt.device_time_total
            kernels[evt.key] = us / 3 / 1e3
    busy = sum(kernels.values())
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:8])
    print(f"bigcap refit kernels, device ms per fit: {busy:.3f} in all, {busy / fit_ms * 100:.1f} "
          f"% of the fit's {fit_ms:.3f} ms; " + "; ".join(
              f"{name[:60]} {ms:.3f}" for name, ms in top.items()) + f" [{smi}]")
    return top


def _refined_gaps(params, kw: dict):
    """``_held_to_eager``'s tie check for the large-cap path: the refined-MI
    gaps (``_tie_gaps``) of the graphed picks on the eager state, on the
    card or a host copy of its buffers."""
    import types

    from ital_tpu_torch.models import gp as gp_mod

    def gaps(before, picks):
        sess = types.SimpleNamespace(state=gp_mod.gp_session_copy(before, before.x.device),
                                     params=params)
        return _tie_gaps(sess, picks, kw)

    return gaps


def _bigcap_turns(torch, big, scale, dev, smi: str) -> dict:
    """The large-cap round (``sharded_select`` and ``bigcap_absorb``) and the
    distributed refit (``bigcap_fit``) as mesh programs beside
    ``graphs.eager()`` (``_mesh_round_turns``); then the device's busy share
    of three rounds and three refits graphed and eager (``torch.profiler``)
    and an eager call's temporaries.  Returns the programs' launches per
    replay."""
    from ital_tpu_torch import runner
    from ital_tpu_torch.models import gp as gp_mod
    from ital_tpu_torch.parallel import bigcap

    def after(start, one_round, fit, last):
        shares = {}
        for mode in ("graphed", "eager"):
            with _graphed_or_eager(mode):
                copies = [gp_mod.gp_session_copy(last) for _ in range(4)]
                rounds = iter(copies)
                shares[mode] = (
                    _busy_share(torch, lambda: one_round(next(rounds), scale.n_rounds)),
                    _busy_share(torch, lambda: fit(copies[-1])))
            del copies, rounds
        print("bigcap busy share (profiler, 3 calls back to back): " + "; ".join(
            f"{mode} round {_share(r)}, refit {_share(f)}" for mode, (r, f) in shares.items())
            + f" [{smi}]")
        # What a capture keeps in the graph pool: the body's temporaries,
        # read as an eager call's peak above the memory held before it.
        with _graphed_or_eager("eager"):
            copy = gp_mod.gp_session_copy(last)
            temps = {"refit": _temporaries_mib(torch, lambda: fit(copy)),
                     "round": _temporaries_mib(torch, lambda: one_round(copy, scale.n_rounds)),
                     "set_query": _temporaries_mib(torch, start)}
            del copy
        print("bigcap temporaries, an eager call's peak above the memory held before it: "
              + ", ".join(f"{k} {v:.1f} MiB" for k, v in temps.items())
              + f" (one (cap, N) f32 block is {scale.cap * big.n * 4 / 2**20:.1f} MiB) [{smi}]")

    kw = scale.method_kwargs
    return _mesh_round_turns(
        torch, big, scale, dev, smi, "bigcap round", "bigcap", SEED + 31,
        lambda mesh: bigcap.make_bigcap_round(mesh, strategy=scale.method,
                                              batch_size=scale.batch_size,
                                              recall_ks=runner.RECALL_KS, **kw),
        lambda params: _refined_gaps(params, kw),
        layout=lambda st, mesh: bigcap.shard_state_bigcap(st, mesh, corpus_sharded=True),
        refit=bigcap.make_bigcap_fit, after=after)


def _temporaries_mib(torch, fn) -> float:
    """MiB of device memory ``fn()`` allocates at its peak beyond what was
    held before it, its result included."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - held) / 2**20


def _share(value: Optional[float]) -> str:
    return "not measured" if value is None else f"{value * 100:.1f} %"


def _bigcap_runner_turns(torch, big, scale, first: dict, first_rounds: list, smi: str) -> None:
    """The runner's large-cap session (``scale``, no checkpoints) in graphed,
    eager, eager, graphed turns, the first graphed turn ``first`` (the
    checkpointing run, whose rounds ``first_rounds`` recorded): picks equal
    (else MI ties on the eager state), the curves while they agree; then
    the device's busy share of one graphed and one eager run."""
    from ital_tpu_torch import runner
    from ital_tpu_torch.select.base import StrategyParams

    dev = first_rounds[0]["mu"].device
    params = StrategyParams.create(dev, label_prob=scale.user.label_prob,
                                   mistake_prob=scale.user.mistake_prob)
    turns = [{"mode": "graphed", "res": first, "rounds": first_rounds}]
    for mode in GRAPH_TURNS[1:]:
        rounds = []
        with _graphed_or_eager(mode), _record_rounds(rounds, keep_states=mode == "eager"):
            res = runner.run_experiment(scale, big, device=dev)
        turns.append({"mode": mode, "res": res, "rounds": rounds})
    held = [{"picks": [r["picks"] for r in t["rounds"]], "mu": [r["mu"] for r in t["rounds"]],
             "ap": [float(a) for a in t["res"]["ap"].ravel()],
             "before": [r["before"] for r in t["rounds"]]} for t in turns]
    _held_to_eager(held, _refined_gaps(params, scale.method_kwargs), "bigcap runner")
    shares = {}
    for mode in ("graphed", "eager"):
        with _graphed_or_eager(mode):
            shares[mode] = _busy_share(torch, lambda: runner.run_experiment(scale, big,
                                                                             device=dev), calls=1)
    for t in turns:
        r = t["res"]
        print(f"bigcap runner {t['mode']}: MAP {[round(float(m), 6) for m in r['map']]}; select "
              f"{r['select_ms']:.3f} ms mean, {r['select_ms_steady']:.3f} steady; update "
              f"{r['update_ms']:.3f} ms mean, {r['update_ms_steady']:.3f} steady; first round "
              f"{r['first_round_ms']:.1f} ms [{smi}]")
    print("bigcap runner busy share of a whole run (profiler): " + "; ".join(
        f"{mode} {_share(v)}" for mode, v in shares.items()) + f" [{smi}]")


def bigcap_phase(torch, big, dev, smi: str) -> dict:
    """Phase 11: the large-cap per-round mesh (the distributed refit, its
    programs graphed beside eager); returns its launches by route, the
    kernel's times at its shapes and the programs' launches per replay."""
    from ital_tpu_torch import runner
    from ital_tpu_torch.models import gp as gp_mod
    from ital_tpu_torch.ops import rbf_hopper
    from ital_tpu_torch.select.base import StrategyParams
    from ital_tpu_torch.utils import checkpoint
    from ital_tpu_torch.utils.config import load_config

    t_phase = time.perf_counter()
    scale = load_config(str(SCALE_CONFIG), BIGCAP_OVERRIDES)
    cap, n, d = scale.cap, big.n, big.x.shape[1]
    x = torch.from_numpy(big.x).to(dev)
    rows = x[torch.from_numpy(np.random.default_rng(SEED + 23).choice(n, size=cap,
                                                                       replace=False)).to(dev)]
    ls = torch.tensor(scale.gp.length_scale, device=dev)
    var = torch.tensor(scale.gp.var, device=dev)
    shapes = _kernel_shapes(torch, "bigcap", [
        (f"({cap}, {n}, {d}) b2", rows, x, {"b2": (x * x).sum(-1)}),
        (f"({cap}, {cap}, {d})", rows, rows, {})], ls, var, smi)
    del x, rows

    ck, resume_dir = WORK_DIR / "bigcap_ck", WORK_DIR / "bigcap_resume"
    for path in (ck, resume_dir):
        shutil.rmtree(path, ignore_errors=True)
    torch.cuda.synchronize()
    res, rounds = {}, {"bigcap": [], "replicated": []}
    _reset_counts()  # the large-cap path's count starts here
    for run in ("bigcap", "replicated"):
        cfg = (dataclasses.replace(scale, checkpoint_dir=str(ck)) if run == "bigcap" else
               dataclasses.replace(scale, gp=dataclasses.replace(scale.gp, chol2d_threshold=0)))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        before = rbf_hopper.LAUNCHES
        with (_uncounted() if run == "replicated" else contextlib.nullcontext()), \
                _record_rounds(rounds[run], keep_states=run == "replicated"), \
                _keep_snapshot(1, resume_dir):
            res[run] = runner.run_experiment(cfg, big, device=dev)
        torch.cuda.synchronize()
        res[run]["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
        res[run]["held_mib"] = held / 2**20
        res[run]["launches"] = rbf_hopper.LAUNCHES - before
    launches = dict(rbf_hopper.ROUTE_LAUNCHES)  # the path's count ends with its run
    big_res, rep = res["bigcap"], res["replicated"]
    check(big_res.get("chol2d") is True and big_res["mesh_devices"] == 1,
          "the bigcap run took the distributed refit on a mesh of one card")
    check("chol2d" not in rep, "chol2d_threshold = 0 keeps the replicated factor")
    # The refit is inside the round's absorb program: its two blocks are the
    # launches the capture recorded, counted at every replay.
    absorb = rounds["bigcap"][-1]["programs"].get("bigcap_absorb")
    check(absorb == (scale.n_rounds, 2) and big_res["launches"] > 0,
          f"one bigcap_absorb program, replayed every round, launching the kernel's two "
          f"blocks (replays, launches per replay): {absorb}")
    last = rounds["bigcap"][-1]["state"]
    check(tuple(last.l.shape) == (cap // big_res["mesh_devices"], cap),
          f"one rank's l is (cap / p, cap): {tuple(last.l.shape)}")

    params = StrategyParams.create(dev, label_prob=scale.user.label_prob,
                                   mistake_prob=scale.user.mistake_prob)
    r = next((i for i, (a, b) in enumerate(zip(rounds["bigcap"], rounds["replicated"]))
              if a["picks"] != b["picks"]), scale.n_rounds)
    mu_gaps = [float((a["mu"] - b["mu"]).abs().max())
               for a, b in zip(rounds["bigcap"][:r], rounds["replicated"][:r])]
    print(f"bigcap vs replicated: picks {[x['picks'] for x in rounds['bigcap']]} and "
          f"{[x['picks'] for x in rounds['replicated']]}; first round whose picks differ {r} of "
          f"{scale.n_rounds}; max |mu bigcap - mu replicated| per round while they agree "
          f"{mu_gaps} (atol {CPU_MU_ATOL})")
    check(all(g <= CPU_MU_ATOL for g in mu_gaps), "bigcap mu within CPU_MU_ATOL of replicated")
    if r < scale.n_rounds:
        import types

        with _uncounted():
            sess = types.SimpleNamespace(
                state=gp_mod.gp_session_copy(rounds["replicated"][r]["before"], dev),
                params=params)
            gaps = _tie_gaps(sess, rounds["bigcap"][r]["picks"], scale.method_kwargs)
        print(f"bigcap round {r}: refined-MI gaps of its picks on the replicated state {gaps} "
              f"(tie atol {MI_TIE_ATOL})")
        check(all(abs(g) <= MI_TIE_ATOL for g in gaps), "bigcap picks differ only by MI ties")
    check(np.abs(big_res["ap"][:, :r] - rep["ap"][:, :r]).max(initial=0.0) <= 1e-6,
          "bigcap AP curve agrees with the replicated one while the picks do")
    del rounds["replicated"]

    # The round-1 snapshot is single-device: it loads on the CPU.  A copy of
    # the session resumed from it (uncounted) gives the uninterrupted curve.
    snap = sorted(resume_dir.glob("*.npz"))[0]
    template = gp_mod.gp_init(torch.from_numpy(big.x), scale.gp.length_scale, scale.gp.var,
                              scale.gp.noise, cap)
    state, extras = checkpoint.load_session(str(snap), template)
    check(tuple(state.l.shape) == (cap, cap) and state.count == 1 + scale.batch_size
          and int(extras["next_round"]) == 1 and bool(torch.isfinite(state.mu).all()),
          "the round-1 snapshot loads on the CPU with a (cap, cap) l")
    print(f"bigcap snapshot {snap.name}: loads into load_session on the CPU, l "
          f"{tuple(state.l.shape)}, count {state.count}")
    del template, state
    with _uncounted():
        resumed = runner.run_experiment(dataclasses.replace(
            scale, checkpoint_dir=str(resume_dir), resume=True), big, device=dev)
    gap = float(np.abs(resumed["ap"] - big_res["ap"]).max())
    print(f"bigcap resume from the round-1 snapshot: MAP "
          f"{[round(float(m), 6) for m in resumed['map']]}, uninterrupted "
          f"{[round(float(m), 6) for m in big_res['map']]}; max |dAP| {gap:.3e}")
    check(resumed.get("chol2d") is True and gap <= 1e-6, "the resumed run gives the curve")

    for run in ("bigcap", "replicated"):
        out = res[run]
        print(f"bigcap {run} (cap {cap}, {n} x {d}): MAP "
              f"{[round(float(m), 6) for m in out['map']]}; select {out['select_ms']:.3f} ms mean, "
              f"{out['select_ms_steady']:.3f} ms steady; update {out['update_ms']:.3f} ms mean, "
              f"{out['update_ms_steady']:.3f} ms steady; first round {out['first_round_ms']:.1f} ms; "
              f"device memory peak {out['peak_mib']:.1f} MiB, {out['peak_mib'] - out['held_mib']:.1f}"
              f" MiB above the {out['held_mib']:.1f} MiB held before the run [{smi}]")
    split = _refit_split(torch, last, smi)
    del last
    _bigcap_runner_turns(torch, big, scale, big_res, rounds.pop("bigcap"), smi)
    per_replay = _bigcap_turns(torch, big, scale, dev, smi)
    print(f"bigcap phase: {time.perf_counter() - t_phase:.1f} s; launches {sum(launches.values())}")
    return {"launches": launches, "shapes": shapes, "split": split, "per_replay": per_replay}


def emoc_replay_phase(torch, ds, replay) -> None:
    """Restore the card's EMOC checkpoint on the CPU and pick from it on the plain path."""
    from ital_tpu_torch.models import gp as gp_mod
    from ital_tpu_torch.ops.kernels import blockwise_reduce_abs_kpost
    from ital_tpu_torch.select import baselines
    from ital_tpu_torch.select.base import StrategyParams, labeled_mask
    from ital_tpu_torch.utils import checkpoint

    cfg, card = replay["cfg"], replay["batch"]
    template = gp_mod.gp_init(torch.from_numpy(ds.x), cfg.gp.length_scale, cfg.gp.var,
                              cfg.gp.noise, cfg.cap)
    state, extras = checkpoint.load_session(str(replay["path"]), template)
    check(int(extras["next_round"]) == REPLAY_ROUND, f"checkpoint of round {REPLAY_ROUND}")
    params = StrategyParams.create("cpu", label_prob=cfg.user.label_prob,
                                   mistake_prob=cfg.user.mistake_prob)
    batch = baselines.select_emoc(state, cfg.batch_size, None, params).numpy()

    colabs = blockwise_reduce_abs_kpost(
        state.x, state.v, torch.arange(ds.n), state.hyper.length_scale, state.hyper.var,
        x2=state.x2)
    scores = baselines.emoc_scores_from_moments(state.mu, state.sig2, state.hyper.noise, colabs)
    excluded = labeled_mask(state)
    gaps = []
    for pick in card:
        best = float(torch.where(excluded, -torch.inf, scores).max())
        gaps.append((best - float(scores[int(pick)])) / abs(best))
        excluded[int(pick)] = True
    print(f"emoc replay: round {REPLAY_ROUND} batch on the CPU {batch.tolist()}, on the card "
          f"{card.tolist()}, equal: {bool(np.array_equal(batch, card))}; per-step score gap of "
          f"the card's pick below the CPU's best, relative: {gaps} (tie rtol {EMOC_TIE_RTOL})")
    check(len(set(card.tolist())) == cfg.batch_size, "the card's batch is distinct")
    check(all(0.0 <= g <= EMOC_TIE_RTOL for g in gaps),
          "the card's EMOC picks are the CPU's up to score ties")


def _graphed_or_eager(mode: str):
    """``graphs.eager()`` for an eager turn, uncounted: the eager runs are
    the comparison, the graphed runs the path."""
    from ital_tpu_torch import graphs

    if mode == "graphed":
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(_uncounted())
    stack.enter_context(graphs.eager())
    return stack


def _graph_session(torch, ds, x, cfg, q: int, cls: int, mode: str) -> dict:
    """One production session on corpus ``x``: ``update_query`` and
    ``cfg.n_rounds`` rounds of fetch and update, the user's answers drawn
    from a generator seeded ``SEED``.  Returns the batches, the state before
    each fetch, the mean after each update and the synchronized host ms."""
    from ital_tpu_torch.models import gp as gp_mod
    from ital_tpu_torch.models.session import ActiveRetrieval

    answer = _user(np.random.default_rng(SEED), ds, cfg.user.label_prob, cfg.user.mistake_prob)
    out = {"batches": [], "before": [], "mu": [], "fetch_ms": [], "update_ms": []}
    with _graphed_or_eager(mode):
        sess = ActiveRetrieval(
            x, length_scale=cfg.gp.length_scale, var=cfg.gp.var, noise=cfg.gp.noise, cap=CAP,
            strategy=cfg.method, label_prob=cfg.user.label_prob,
            mistake_prob=cfg.user.mistake_prob, seed=SEED, method_kwargs=cfg.method_kwargs)
        sess.update_query(q)
        for _ in range(cfg.n_rounds):
            out["before"].append(gp_mod.gp_session_copy(sess.state))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch = sess.fetch_unlabelled(cfg.batch_size)
            t1 = time.perf_counter()
            fb = {int(i): y for i, y in answer(batch.tolist(), cls).items()}
            t2 = time.perf_counter()
            sess.update(fb)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            out["batches"].append(batch.tolist())
            out["mu"].append(sess.state.mu.clone())
            out["fetch_ms"].append((t1 - t0) * 1e3)
            out["update_ms"].append((t3 - t2) * 1e3)
    out["session"] = sess
    return out


def _held_to(torch, graphed: dict, eager: dict, kw: dict, what: str) -> int:
    """Hold a graphed session to its eager twin: equal picks round by round
    (else MI ties on the eager state, and the histories part there) and the
    mean within ``GRAPH_MU_ATOL`` while they agree.  Returns the rounds that
    agree."""
    import types

    for r, (gb, eb) in enumerate(zip(graphed["batches"], eager["batches"])):
        if gb != eb:
            sess = types.SimpleNamespace(state=eager["before"][r],
                                         params=eager["session"].params)
            with _uncounted():
                gaps = _tie_gaps(sess, gb, kw)
            print(f"graphs {what}: round {r} graphed {gb} eager {eb}; refined-MI gaps on the "
                  f"eager state {gaps} (tie atol {MI_TIE_ATOL})")
            check(all(abs(g) <= MI_TIE_ATOL for g in gaps), f"{what}: picks differ only by ties")
            return r
        err = float((graphed["mu"][r] - eager["mu"][r]).abs().max())
        check(err <= GRAPH_MU_ATOL, f"{what}: round {r} mu graphed vs eager {err} > "
                                    f"{GRAPH_MU_ATOL}")
    return len(graphed["batches"])


def _device_profile(torch, fn, calls: int = 3) -> tuple[Optional[float], float]:
    """The device's busy share while ``fn`` runs ``calls`` times back to
    back, the kernels' and copies' device time (``torch.profiler``, CUDA
    activity) over the host's synchronized wall time, None where the
    profiler saw no device time; and the device operations a call."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(getattr(e, "self_device_time_total", 0.0) or e.device_time_total for e in events)
    return (busy / wall_us if busy > 0 else None), sum(e.count for e in events) / calls


def _busy_share(torch, fn, calls: int = 3) -> Optional[float]:
    """The device's busy share while ``fn`` runs ``calls`` times back to back
    (:func:`_device_profile`)."""
    return _device_profile(torch, fn, calls)[0]


def _busy_shares(torch, sess, fb: dict, mode: str) -> tuple:
    """Busy shares of three fetches from one state and three updates of
    three copies of it, graphed or eager."""
    from ital_tpu_torch.models import gp as gp_mod

    with _graphed_or_eager(mode):
        fetch = _busy_share(torch, lambda: sess.fetch_unlabelled(4))
        base = sess.state
        copies = [gp_mod.gp_session_copy(base) for _ in range(4)]

        def update():
            sess.state = copies.pop()
            sess.update(fb)

        update()  # the program exists: warm, as the fetch is
        upd = _busy_share(torch, update)
        sess.state = base
    return fetch, upd


def _pool_mib(torch) -> Optional[float]:
    """MiB the CUDA graphs' private memory pools reserve (the caching
    allocator's segments outside the default pool); None where the snapshot
    does not say."""
    segs = torch.cuda.memory_snapshot()
    if not segs or "segment_pool_id" not in segs[0]:
        return None
    return sum(s["total_size"] for s in segs
               if tuple(s["segment_pool_id"]) != (0, 0)) / 2**20


def _graph_round_steps(torch, dev, smi: str) -> None:
    """``round_step`` (select, user, update, AP as one program) at entry's
    example size, graphed and eager: equal picks and AP, each round."""
    from ital_tpu_torch.models import gp as gp_mod
    from ital_tpu_torch.round import round_step
    from ital_tpu_torch.select.base import StrategyParams

    e = ENTRY_SHAPE
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(e["n"], e["d"]))
                         .astype(np.float32)).to(dev)
    relevant = torch.from_numpy(np.random.default_rng(1).random(e["n"]) < 0.2).to(dev)
    exclude = torch.zeros(e["n"], dtype=torch.bool, device=dev)
    exclude[e["query"]] = True
    params = StrategyParams.create(dev, label_prob=0.9, mistake_prob=0.1)
    runs = {}
    for mode in ("graphed", "eager"):
        runs[mode] = {"batch": [], "ap": [], "ms": [], "before": []}
        with _graphed_or_eager(mode):
            st = gp_mod.gp_set_query(gp_mod.gp_init(x, e["ls"], 1.0, 0.1, e["cap"]), e["query"])
            gen = torch.Generator(device=dev).manual_seed(SEED)
            for _ in range(ROUND_STEPS):
                runs[mode]["before"].append(gp_mod.gp_session_copy(st))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st, batch, ap = round_step(st, gen, relevant, exclude, params)
                runs[mode]["batch"].append(batch.tolist())
                runs[mode]["ap"].append(float(ap))
                runs[mode]["ms"].append((time.perf_counter() - t0) * 1e3)
    g, ev = runs["graphed"], runs["eager"]
    for r in range(ROUND_STEPS):
        if g["batch"][r] != ev["batch"][r]:
            with _uncounted():
                gaps = _mi_gaps(torch, ev["before"][r], params, {"n_qmc": 64}, g["batch"][r])
            print(f"graphs round_step: round {r} graphed {g['batch'][r]} eager "
                  f"{ev['batch'][r]}; MI gaps on the eager state {gaps}")
            check(all(gap <= MI_TIE_ATOL for gap in gaps), "round_step picks differ only by ties")
            break
        check(g["ap"][r] == ev["ap"][r], f"round_step round {r}: AP graphed {g['ap'][r]} == "
                                         f"eager {ev['ap'][r]}")
    print(f"graphs round_step ({e['n']} x {e['d']}, full scan n_qmc 64): AP graphed "
          f"{[round(a, 6) for a in g['ap']]}, eager {[round(a, 6) for a in ev['ap']]}; ms per "
          f"round graphed {[round(t, 3) for t in g['ms']]}, eager "
          f"{[round(t, 3) for t in ev['ms']]} [{smi}]")


def _graph_harness(torch, ds, dev, smi: str) -> None:
    """The serial harness at the production options, 2 classes x 5 rounds,
    graphed and eager: picks round by round (else MI ties on the eager
    state) and the AP curves while they agree."""
    import types

    from ital_tpu_torch import runner
    from ital_tpu_torch.select.base import StrategyParams
    from ital_tpu_torch.utils.config import load_config

    cfg = load_config(str(CONFIG), GRAPH_HARNESS_OVERRIDES)
    res, rec = {}, {"graphed": [], "eager": []}
    for mode in ("graphed", "eager"):
        with _graphed_or_eager(mode), _record_serial(cfg.method, rec[mode]):
            res[mode] = runner.run_experiment(cfg, ds, device=dev)
    params = StrategyParams.create(dev, label_prob=cfg.user.label_prob,
                                   mistake_prob=cfg.user.mistake_prob)
    rounds, n_sessions = cfg.n_rounds, len(res["graphed"]["sessions"])
    check(len(rec["graphed"]) == len(rec["eager"]) == n_sessions * rounds, "harness selections")
    for k in range(n_sessions):
        rows = range(k * rounds, (k + 1) * rounds)
        r = next((r for r in range(rounds)
                  if rec["graphed"][rows[r]][1] != rec["eager"][rows[r]][1]), rounds)
        if r < rounds:
            state, picks = rec["eager"][rows[r]]
            with _uncounted():
                gaps = _tie_gaps(types.SimpleNamespace(state=state, params=params),
                                 rec["graphed"][rows[r]][1], cfg.method_kwargs)
            print(f"graphs harness session {k}: round {r} graphed {rec['graphed'][rows[r]][1]} "
                  f"eager {picks}; refined-MI gaps {gaps} (tie atol {MI_TIE_ATOL})")
            check(all(abs(g) <= MI_TIE_ATOL for g in gaps), "harness picks differ only by ties")
        check(np.abs(res["graphed"]["ap"][k, :r] - res["eager"]["ap"][k, :r]).max(initial=0.0)
              == 0.0, "harness AP graphed == eager while the picks agree")
    for mode in ("graphed", "eager"):
        m = res[mode]
        print(f"graphs harness {mode}: MAP {[round(float(v), 6) for v in m['map']]}; select "
              f"{m['select_ms']:.3f} ms mean, {m['select_ms_steady']:.3f} steady; update "
              f"{m['update_ms']:.3f} mean, {m['update_ms_steady']:.3f} steady; first round "
              f"{m['first_round_ms']:.1f} ms [{smi}]")


def graphs_phase(torch, ds, cfg, dev, smi: str) -> dict:
    """Phase 12: the captured programs (``ital_tpu_torch.graphs``) beside
    their eager runs; returns the graphed runs' launches by route."""
    from ital_tpu_torch import graphs
    from ital_tpu_torch.ops import rbf_hopper

    t_phase = time.perf_counter()
    x = torch.from_numpy(ds.x).to(dev)  # a corpus of its own: the phase's programs
    rng = np.random.default_rng(SEED)
    cls = int(rng.choice(ds.classes))
    q = int(ds.queries_for_class(cls, rng, 1)[0])
    torch.cuda.synchronize()
    # Programs replayed in the phase.  A corpus at the address of one freed
    # earlier replays that one's programs, which then count as the phase's.
    known = _known_programs()
    captured = []

    def collect():
        captured.extend(p for p in graphs.programs()
                        if _replayed_since(known, p) and all(p is not c for c in captured))

    alloc0, pool0 = torch.cuda.memory_allocated(), _pool_mib(torch)
    _reset_counts()  # the graphs path's count starts here
    runs = []
    for i, mode in enumerate(GRAPH_TURNS):
        before = graphs.captures()
        runs.append(_graph_session(torch, ds, x, cfg, q, cls, mode))
        if mode == "graphed" and i > 0:
            check(graphs.captures() == before,
                  "a second session at the same counts replays the first one's programs")
    collect()
    check(sorted(p.name for p in captured) == ["gp_update", "select_ital"],
          f"the session's fetch and update replayed programs: {[p.name for p in captured]}")
    agree = [_held_to(torch, runs[0], runs[1], cfg.method_kwargs, "session turns 1-2"),
             _held_to(torch, runs[3], runs[2], cfg.method_kwargs, "session turns 4-3")]
    launches = dict(rbf_hopper.ROUTE_LAUNCHES)
    check(sum(launches.values()) > 0, "the graphed session launched the kernel")
    for i, (mode, r) in enumerate(zip(GRAPH_TURNS, runs)):
        print(f"graphs session turn {i + 1} {mode}: fetch ms "
              f"{[round(t, 3) for t in r['fetch_ms']]}; update ms "
              f"{[round(t, 3) for t in r['update_ms']]} [{smi}]")
    steady = {mode: {k: float(np.median([t for m, r in zip(GRAPH_TURNS, runs) if m == mode
                                         for t in r[k][1:]]))
                     for k in ("fetch_ms", "update_ms")} for mode in ("graphed", "eager")}
    print(f"graphs session: rounds that agree {agree} of {cfg.n_rounds}; steady median fetch "
          f"graphed {steady['graphed']['fetch_ms']:.3f} ms, eager "
          f"{steady['eager']['fetch_ms']:.3f}; update graphed "
          f"{steady['graphed']['update_ms']:.3f} ms, eager {steady['eager']['update_ms']:.3f} "
          f"(the single update's A/B, rounds 2-{cfg.n_rounds} of two turns each) [{smi}]")
    sess = runs[3]["session"]
    fb = {int(i): 1 for i in runs[3]["batches"][-1]}
    with _uncounted():
        shares = {mode: _busy_shares(torch, sess, fb, mode) for mode in ("graphed", "eager")}
    fmt = lambda v: "not measured" if v is None else f"{v * 100:.1f} %"
    print("graphs device busy (profiler, 3 calls each): " + "; ".join(
        f"{mode} fetch {fmt(f)}, update {fmt(u)}" for mode, (f, u) in shares.items())
        + f" [{smi}]")
    _graph_round_steps(torch, dev, smi)
    collect()
    _graph_harness(torch, ds, dev, smi)
    collect()
    launches = dict(rbf_hopper.ROUTE_LAUNCHES)
    for p in captured:
        print(f"graphs program {p.name}{'' if id(p) not in known else ' (captured earlier)'}: "
              f"warm-up {p.warmup_ms:.1f} ms, capture "
              f"{p.capture_ms:.1f} ms, instantiate {p.instantiate_ms:.1f} ms, replays "
              f"{p.replays}, launches per replay {sum(p.launches.values())}, static buffers "
              f"{p.static_bytes / 2**20:.2f} MiB")
    torch.cuda.synchronize()
    pool1 = _pool_mib(torch)
    pool = ("not measured" if pool1 is None or pool0 is None
            else f"{pool1:.1f} MiB (phase start {pool0:.1f})")
    print(f"graphs: {len(captured)} programs replayed in the phase, "
          f"{sum(p.replays for p in captured)} replays, {len(graphs.programs())} live in the "
          f"process; static buffers {sum(p.static_bytes for p in captured) / 2**20:.1f} MiB, "
          f"graph pools {pool}; "
          f"memory allocated {torch.cuda.memory_allocated() / 2**20:.1f} MiB (phase start "
          f"{alloc0 / 2**20:.1f}); launches {launches}; phase {time.perf_counter() - t_phase:.1f} "
          f"s [{smi}]")
    return {"launches": launches}


def _learn_requests(torch, ds, cfg, dev, smi: str) -> dict:
    """``/learn`` (``RetrievalService.learn``) on production sessions, graphed
    and eager in ``GRAPH_TURNS``: two histories, each learned by a session
    and by its twin, the second history replaying the program captured with
    the first.  Learned values within ``LEARN_GRAPH_RTOL`` of eager and the
    refit ``mu`` bit-equal; the ascent's gradient at every step within
    ``LEARN_GRAPH_RTOL`` of eager (uncounted); the CPU's re-learn from the
    same state within ``LEARN_RTOL``.  Then ``LEARN_TIMED`` re-learns from
    one state per turn, timed.  Returns the relearn program."""
    from ital_tpu_torch import graphs, serve
    from ital_tpu_torch.models import gp as gp_mod
    from ital_tpu_torch.models import hyperopt

    # service_from_config's service, on the corpus already loaded.
    svc = serve.RetrievalService(
        ds.x, length_scale=cfg.gp.length_scale, var=cfg.gp.var, noise=cfg.gp.noise, cap=cfg.cap,
        strategy=cfg.method, label_prob=cfg.user.label_prob, mistake_prob=cfg.user.mistake_prob,
        corpus_name=ds.name, method_kwargs=dict(cfg.method_kwargs), device=dev)
    rng = np.random.default_rng(SEED + 17)
    pairs, start = {}, {}
    with _uncounted():  # the set-up: three rounds a history, not the path
        for name, c in zip("AB", rng.choice(ds.classes, 2, replace=False)):
            q = int(ds.queries_for_class(int(c), rng, 1)[0])
            user = _user(rng, ds, cfg.user.label_prob, cfg.user.mistake_prob)
            pairs[name] = [svc.create_session() for _ in range(2)]
            for sid in pairs[name]:
                svc.set_query(sid, q)
            for _ in range(SERVE_ROUNDS):
                answers = user(svc.next_batch(pairs[name][0], SERVE_K), int(c))
                for sid in pairs[name]:
                    svc.feedback(sid, answers)
            start[name] = gp_mod.gp_session_copy(svc._entry(pairs[name][0])[0].state)
    torch.cuda.synchronize()
    known, captured = _known_programs(), graphs.captures()
    learned = {}
    for (name, j), turn in zip((("A", 0), ("A", 1), ("B", 1), ("B", 0)), GRAPH_TURNS):
        sid = pairs[name][j]
        with _graphed_or_eager(turn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vals = svc.learn(sid, LEARN_STEPS)
            torch.cuda.synchronize()
        learned[(name, turn)] = (vals, svc._entry(sid)[0].state.mu.clone(),
                                 (time.perf_counter() - t0) * 1e3)
    progs = [p for p in _phase_programs(known)]
    # At most one capture: a corpus at a freed one's address replays its programs.
    check(graphs.captures() - captured <= 1 and [p.name for p in progs] == ["relearn"]
          and progs[0].replays - known.get(id(progs[0]), (None, 0))[1] == 2,
          f"/learn: one relearn program, replayed by both graphed turns: "
          f"{[(p.name, p.replays) for p in progs]}")
    for name in "AB":
        (g, g_mu, g_ms), (e, e_mu, e_ms) = learned[(name, "graphed")], learned[(name, "eager")]
        rel = {f: abs(g[f] - e[f]) / abs(e[f]) for f in g}
        print(f"learn {name} ({start[name].count} labeled slots, {LEARN_STEPS} steps): graphed "
              f"{g} in {g_ms:.3f} ms{' (with the capture)' if name == 'A' else ''}, eager {e} in "
              f"{e_ms:.3f} ms; relative gaps {rel}; mu bit-equal {bool(torch.equal(g_mu, e_mu))} "
              f"[{smi}]")
        check(all(r <= LEARN_GRAPH_RTOL for r in rel.values()),
              f"learn {name}: graphed values within {LEARN_GRAPH_RTOL} of eager")
        check(bool(torch.equal(g_mu, e_mu)), f"learn {name}: mu after the refit graphed == eager")
        check(g["length_scale"] != cfg.gp.length_scale, f"learn {name}: the length scale moved")
    with _uncounted():
        worst = 0.0
        for name in "AB":
            st = start[name]
            rows = st.x[st.idx]
            _, got = hyperopt.fit_with_gradients(rows, st.y, st.active, st.hyper,
                                                 steps=LEARN_STEPS)
            with graphs.eager():
                _, want = hyperopt.fit_with_gradients(rows, st.y, st.active, st.hyper,
                                                      steps=LEARN_STEPS)
            worst = max(worst, float(((got - want).abs() / want.abs().clamp(min=1e-12)).max()))
        cpu = gp_mod.state_from_arrays(gp_mod.state_to_arrays(start["A"]), "cpu")
        cpu_h = hyperopt.relearn(cpu, steps=LEARN_STEPS)
    cpu_vals = {f: float(getattr(cpu_h, f)) for f in ("length_scale", "var", "noise")}
    card = learned[("A", "graphed")][0]
    cpu_rel = {f: abs(card[f] - cpu_vals[f]) / abs(cpu_vals[f]) for f in card}
    print(f"learn: the ascent's gradient, graphed against eager at each of {LEARN_STEPS} steps "
          f"of both histories, max relative gap {worst:.3e} (rtol {LEARN_GRAPH_RTOL}); the CPU "
          f"from A's state {cpu_vals}, relative gaps to the card {cpu_rel} (rtol {LEARN_RTOL})")
    check(worst <= LEARN_GRAPH_RTOL, "the replayed ascent's gradients equal eager at every step")
    check(all(r <= LEARN_RTOL for r in cpu_rel.values()), "card and CPU re-learn agree")
    times = []
    for turn in GRAPH_TURNS:
        ms = []
        with _graphed_or_eager(turn):
            for _ in range(LEARN_TIMED):
                state = gp_mod.gp_session_copy(start["A"])
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                hyperopt.relearn(state, steps=LEARN_STEPS)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
        times.append((turn, ms))
    steady = {mode: float(np.median([t for m, ms in times if m == mode for t in ms]))
              for mode in ("graphed", "eager")}
    with _uncounted():
        busy = {}
        for mode in ("graphed", "eager"):
            with _graphed_or_eager(mode):
                busy[mode] = _device_profile(torch, lambda: hyperopt.relearn(
                    gp_mod.gp_session_copy(start["A"]), steps=LEARN_STEPS))
    fmt = lambda v: "not measured" if v is None else f"{v * 100:.1f} %"
    print("learn re-learn turns (host ms, synchronized): " + "; ".join(
        f"{turn} {[round(t, 3) for t in ms]}" for turn, ms in times)
        + f"; median graphed {steady['graphed']:.3f}, eager {steady['eager']:.3f}; device busy "
        + "; ".join(f"{mode} {fmt(b)}, {ops:.0f} device ops a call" for mode, (b, ops)
                    in busy.items()) + f" (profiler, 3 calls each) [{smi}]")
    _print_programs(progs, known, "learn", smi)
    return progs[0]


@contextlib.contextmanager
def _record_cohort_selections(record: list):
    """Append ``(each session's state, params)`` before every selection of
    the runner's cohort bodies (``runner.cohort_program``) to ``record``:
    where the body runs eagerly, the state each round's picks come from."""
    from ital_tpu_torch import runner
    from ital_tpu_torch.models import gp as gp_mod

    make = runner.cohort_program

    def recording(name, batch_size, options):
        prog = make(name, batch_size, options)

        def picks(st, params, **drawn):
            record.append(([gp_mod.gp_session_copy(gp_mod.session_state(st, k))
                            for k in range(st.k)], params))
            return prog.picks(st, params, **drawn)

        return dataclasses.replace(prog, picks=picks)

    runner.cohort_program = recording
    try:
        yield
    finally:
        runner.cohort_program = make


def _timed_cohorts(runner, plan, ds, dev) -> tuple:
    """A fused cohort run and each cohort's ms (its JSONL's ``cohort_ms``),
    in order."""
    log = Path(plan.log_jsonl)
    log.parent.mkdir(parents=True, exist_ok=True)
    log.unlink(missing_ok=True)  # the logger appends
    res = runner.run_experiment(plan, ds, device=dev)
    rows = [json.loads(line) for line in log.read_text().splitlines()]
    return res, [r["cohort_ms"] for r in rows[::plan.query_batch]]


def _learn_cohort(torch, ds, cfg, dev, smi: str):
    """Two fused cohorts of 4 x ``LEARN_COHORT_ROUNDS`` rounds at the
    production options with ``GP.learn_every = LEARN_EVERY``, graphed, then
    eager: the graphed run replays one program, its re-learns inside, for
    both cohorts (held by identity and replays; the second cohort's replay
    is the timed one); graphed picks equal to eager up to the first MI tie
    (on the eager state) and the curves while they agree.  Then the same
    cohorts with learning off, graphed.  Returns the learning program."""
    import types

    from ital_tpu_torch import graphs, runner

    plan = dataclasses.replace(
        cfg, max_classes=4, queries_per_class=2, n_rounds=LEARN_COHORT_ROUNDS, query_batch=4,
        fused_sessions=True, gp=dataclasses.replace(cfg.gp, cap=CAP, learn_every=LEARN_EVERY),
        log_jsonl=str(WORK_DIR / "learn_cohort.jsonl"))
    n_sess, rounds, kw = 8, plan.n_rounds, plan.method_kwargs
    runs = []
    for turn in ("graphed", "eager"):
        record = []
        known, captured = _known_programs(), graphs.captures()
        with _graphed_or_eager(turn), (_record_cohort_selections(record) if turn == "eager"
                                        else contextlib.nullcontext()):
            res, ms = _timed_cohorts(runner, plan, ds, dev)
        check(res["ap"].shape == (n_sess, rounds) and bool(np.isfinite(res["ap"]).all()),
              f"learning cohort {turn}: AP shape and values")
        runs.append((turn, res, record, ms))
        if turn == "graphed":
            # The run's corpus is its own: a run captures, unless its corpus
            # took a freed one's address and replays that one's program.
            mine = _phase_programs(known)
            check(graphs.captures() - captured <= 1 and [p.name for p in mine] == ["fused_session"]
                  and mine[0].replays - known.get(id(mine[0]), (None, 0))[1] == 2,
                  f"learning cohort: one program for both cohorts of the run: "
                  f"{[(p.name, p.replays) for p in mine]}")
            prog = mine[0]
    (_, g, _, _), (_, e, rec, _) = runs
    for k in range(n_sess):
        gp_, ep = g["picks"][k].tolist(), e["picks"][k].tolist()
        r = next((r for r in range(rounds) if gp_[r] != ep[r]), rounds)
        check(np.array_equal(g["ap"][k, :r], e["ap"][k, :r]),
              "learning cohort: graphed curves equal eager while the picks agree")
        if r < rounds:
            states, params = rec[(k // 4) * rounds + r]
            with _uncounted():
                gaps = _tie_gaps(types.SimpleNamespace(state=states[k % 4], params=params),
                                 gp_[r], kw)
            print(f"learning cohort session {k}: round {r} graphed {gp_[r]} eager {ep[r]}; "
                  f"refined-MI gaps on the eager state {gaps} (tie atol {MI_TIE_ATOL})")
            check(all(abs(x) <= MI_TIE_ATOL for x in gaps),
                  "learning cohort: graphed and eager picks differ only by ties")
    off = dataclasses.replace(plan, gp=dataclasses.replace(plan.gp, learn_every=0))
    res_off, off_ms = _timed_cohorts(runner, off, ds, dev)
    cells = "; ".join(f"{turn} {[round(t, 3) for t in ms]}" for turn, _, _, ms in runs)
    (first, replay), eager_ms = runs[0][3], float(np.mean(runs[1][3]))
    # A run captures once (each run's corpus is its own): n cohorts take
    # first + (n - 1) replays graphed against n eager ones.
    even = (first - replay) / (eager_ms - replay) if eager_ms > replay else float("inf")
    print(f"learning cohort (2 cohorts of 4 x {rounds} rounds, learn_every {LEARN_EVERY}, "
          f"{plan.gp.learn_steps} steps, cap {CAP}; ms a cohort, the first graphed with the "
          f"capture): {cells}; learning off, graphed {[round(t, 3) for t in off_ms]}; the run "
          f"graphed {sum(runs[0][3]):.3f} ms, eager {sum(runs[1][3]):.3f}; the capture pays "
          f"back at {even:.2f} cohorts a run; MAP learning "
          f"{[round(float(m), 6) for m in runs[0][1]['map']]}, off "
          f"{[round(float(m), 6) for m in res_off['map']]} [{smi}]")
    _print_programs([prog], {}, "learning cohort", smi)
    return prog


def learn_phase(torch, ds, cfg, dev, smi: str) -> dict:
    """Phase 13: the hyperparameter ascent as programs, ``/learn``'s and the
    fused learning cohort's; returns the graphed runs' launches by route and
    the relearn program's launches per replay."""
    from ital_tpu_torch.ops import rbf_hopper

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    _reset_counts()  # the learn path's count starts here
    relearn = _learn_requests(torch, ds, cfg, dev, smi)
    cohort = _learn_cohort(torch, ds, cfg, dev, smi)
    launches = dict(rbf_hopper.ROUTE_LAUNCHES)
    per_learn = sum(relearn.launches.values())
    check(per_learn >= LEARN_STEPS and sum(launches.values()) > 0,
          f"the kernel launched in every ascent step of /learn ({per_learn} a replay)")
    print(f"learn phase: {time.perf_counter() - t_phase:.1f} s; launches {launches}; per /learn "
          f"{per_learn}, per learning cohort {sum(cohort.launches.values())}")
    return {"launches": launches, "per_learn": per_learn}


STRATEGY_ROUNDS = 3  # the fused cohort's rounds
STRATEGY_QB = 4  # its sessions
STRATEGY_K = 8  # sessions of a /batch_select
# The user models of a /batch_select group, session by session:
# (label_prob, mistake_prob).
STRATEGY_USERS = ((0.8, 0.05), (0.9, 0.0), (0.7, 0.1), (1.0, 0.02))


def _strategy_names() -> list:
    """The strategies phase 14 covers: every registered one but ITAL."""
    from ital_tpu_torch.select import STRATEGIES

    return sorted(set(STRATEGIES) - {"ital"})


@contextlib.contextmanager
def _following(picks: list):
    """Make the strategies' greedy loops (``greedy_argmax_stacked`` of a
    stack of one) follow ``picks`` and yield each step's (N,) scores."""
    import torch

    from ital_tpu_torch.select import baselines, regression

    seen = []

    def follow(score_fn, st, batch_size):
        batch = torch.tensor([picks], dtype=torch.int64, device=st.idx.device)
        for t in range(batch_size):
            seen.append(score_fn(batch, t)[0])
        return batch

    saved = baselines.greedy_argmax_stacked, regression.greedy_argmax_stacked
    baselines.greedy_argmax_stacked = regression.greedy_argmax_stacked = follow
    try:
        yield seen
    finally:
        baselines.greedy_argmax_stacked, regression.greedy_argmax_stacked = saved


def _parting_gap(name: str, state, params, a: list, b: list) -> Optional[tuple]:
    """Where batches ``a`` and ``b`` of strategy ``name`` from ``state``
    first part, ``(step, relative score gap)`` of their picks there, scored
    eagerly on ``state`` after their common prefix (uncounted); None where
    they agree."""
    from ital_tpu_torch import graphs
    from ital_tpu_torch.select import STRATEGIES

    t = next((i for i in range(len(a)) if a[i] != b[i]), None)
    if t is None:
        return None
    with _uncounted(), graphs.eager(), _following(a) as seen:
        STRATEGIES[name](state, len(a), None, params)
    sa, sb = float(seen[t][a[t]]), float(seen[t][b[t]])
    return t, abs(sa - sb) / max(abs(sa), abs(sb), 1e-30)


def _held_up_to_ties(name: str, state, params, a: list, b: list, what: str) -> bool:
    """Hold batch ``a`` to ``b`` up to a score tie at their first parting
    (``EMOC_TIE_RTOL`` relative; ``random`` draws alike, no tie allowed).
    Returns whether they differ."""
    gap = _parting_gap(name, state, params, a, b) if name != "random" else None
    if a == b:
        return False
    print(f"{what}: {name} {a} against {b}; first parting (step, relative score gap) {gap} "
          f"(tie rtol {EMOC_TIE_RTOL})")
    check(gap is not None and gap[1] <= EMOC_TIE_RTOL, f"{what}: {name} picks part only at ties")
    return True


def _strategy_kernel_shapes(torch, ds, cfg, smi: str) -> list:
    """The kernel at the blocks the strategies' programs launch at 25 000 x
    512: the diversity penalties' similarity to a session's labeled rows
    (N, cap) and to its partial batch (N, t), each alone and for a stack of
    8 in one hyperparameter group, and EMOC's (N, 2048) and MCMI's
    (N, 512) column blocks (var 1 for the penalties, the GP's var for the
    columns)."""
    x = torch.from_numpy(ds.x).cuda()
    x2 = (x * x).sum(-1)
    ls = torch.tensor(cfg.gp.length_scale, device="cuda")
    b, k = cfg.batch_size, STRATEGY_K
    shapes = [
        ("25000x64x512 (N, cap): similarity to one session's labeled rows", x, x[:CAP],
         {"a2": x2}),
        (f"25000x{k * CAP}x512 (N, K cap): a stack of {k}, one group", x, x[:k * CAP],
         {"a2": x2}),
        (f"25000x{b - 1}x512 (N, t): similarity to a partial batch", x, x[:b - 1], {"a2": x2}),
        (f"25000x{k * (b - 1)}x512 (N, K t): a stack of {k}'s partial batches", x,
         x[:k * (b - 1)], {"a2": x2}),
    ]
    sim = _kernel_shapes(torch, "strategies", shapes, ls, 1.0, smi)
    var = torch.tensor(cfg.gp.var, device="cuda")
    cols = [("25000x2048x512 (N, 2048): an EMOC column block", x, x[:2048],
             {"a2": x2, "b2": x2[:2048]}),
            ("25000x512x512 (N, 512): an MCMI column block", x, x[:512], {"a2": x2})]
    return sim + _kernel_shapes(torch, "strategies", cols, ls, var, smi)


def _strategy_service(torch, svc, ds, name: str, rng) -> tuple:
    """``STRATEGY_K`` sessions of ``name`` on ``svc`` with mixed user
    models, each with a query and one round of answers, and a twin of each
    with the same history: (cohort ids, twin ids, each session's class)."""
    classes = [int(c) for c in rng.choice(ds.classes, STRATEGY_K // 2, replace=False)]
    queries = [(int(q), c) for c in classes for q in ds.queries_for_class(c, rng, 2)]
    cohort, twins = [], []
    for j, (q, c) in enumerate(queries):
        lp, mp = STRATEGY_USERS[j % len(STRATEGY_USERS)]
        shown = [int(i) for i in rng.choice(ds.n, 4, replace=False) if int(i) != q]
        labels = {str(i): (1 if ds.relevance[i, c] else -1) for i in shown}
        for out in (cohort, twins):
            sid = svc.create_session(strategy=name, cap=CAP, label_prob=lp, mistake_prob=mp)
            svc.set_query(sid, q)
            svc.feedback(sid, labels)
            out.append(sid)
    return cohort, twins, [c for _, c in queries]


def _timed_ms(torch, fn) -> tuple:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _strategy_requests(torch, svc, ds, name: str, rng, smi: str) -> dict:
    """Phase 14's service part for strategy ``name``: a ``/batch_select``
    of ``STRATEGY_K`` sessions with mixed user models (one program, its
    memory rise per session, its batches against twins fetched one at a
    time up to ties), graphed beside eager; then a twin's fetch in graphed,
    eager, eager, graphed turns (picks up to ties).  Returns the times,
    the memory and the programs' launches per replay."""
    from ital_tpu_torch import graphs, serve

    cohort, twins, _ = _strategy_service(torch, svc, ds, name, rng)
    calls = []
    run = graphs.run

    def spy(prog, *a, **kw):
        calls.append(prog)
        return run(prog, *a, **kw)

    rise = []
    known = _known_programs()

    def measured():
        with graphs._LOCK:  # release dead programs now, not inside the measured call
            graphs._release_dead()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        allocated = torch.cuda.memory_allocated()
        out = svc.next_batch_many(cohort, SERVE_K)
        torch.cuda.synchronize()
        rise.append((torch.cuda.max_memory_allocated() - allocated) / STRATEGY_K)
        return out

    graphs.run = spy
    try:
        (picks, first_ms), (_, replay_ms) = _timed_ms(torch, measured), _timed_ms(torch, measured)
    finally:
        graphs.run = run
    (prog,) = _phase_programs(known)
    check(calls == [f"select_{name}_stacked"] * 2 and prog.name == calls[0],
          f"{name}: a /batch_select of {STRATEGY_K} mixed user models is one program: {calls}")
    entries = {sid: svc._entry(sid)[0] for sid in cohort + twins}
    differ = 0
    with _uncounted():
        for a, b in zip(cohort, twins):
            twin = entries[b]
            differ += _held_up_to_ties(name, twin.state, twin.params, picks[a],
                                       svc.next_batch(b, SERVE_K), "batch_select vs twin")
        with graphs.eager():
            _, eager_ms = _timed_ms(torch, lambda: svc.next_batch_many(cohort, SERVE_K))
    sess = entries[twins[0]]
    fetch, turns = {}, {}
    known = _known_programs()
    for turn in GRAPH_TURNS:
        sess.generator.manual_seed(SEED)
        with _graphed_or_eager(turn):
            batch, ms = _timed_ms(torch, lambda: sess.fetch_unlabelled(SERVE_K).tolist())
        fetch.setdefault(turn, []).append(ms)
        turns.setdefault(turn, batch)
    _held_up_to_ties(name, sess.state, sess.params, turns["graphed"], turns["eager"],
                     "fetch graphed vs eager")
    (one,) = _phase_programs(known)
    check(one.name == f"select_{name}", f"{name}: the fetch is one program: {one.name}")
    copies, fixed = serve.SELECT_BUDGET[name]
    model = copies * CAP * ds.n * 4 + fixed
    per_session = max(rise)
    print(f"strategies {name}: /batch_select of {STRATEGY_K} (mixed user models) capture call "
          f"{first_ms:.3f} ms, replay {replay_ms:.3f} ms, eager {eager_ms:.3f} ms; "
          f"{differ} of {STRATEGY_K} differ from their twins at ties; memory per session "
          f"{per_session / 2**20:.2f} MiB ({per_session / (CAP * ds.n * 4):.3f} (cap, N) f32 "
          f"copies; the budget's {model / 2**20:.2f} MiB); fetch graphed "
          f"{[round(t, 3) for t in fetch['graphed']]} ms, eager "
          f"{[round(t, 3) for t in fetch['eager']]} ms [{smi}]")
    check(per_session <= model, f"{name}: a stacked selection stays within its budget entry")
    _print_programs([one, prog], {}, f"strategies {name}", smi)
    for sid in cohort + twins:
        svc.delete(sid)
    return {"fetch_ms": fetch, "batch_select_ms": {"capture_call": first_ms, "replay": replay_ms,
                                                   "eager": eager_ms},
            "mib_per_session": per_session / 2**20,
            "launches": {"fetch": sum(one.launches.values()),
                         "batch_select": sum(prog.launches.values())}}


def _strategy_cohort(torch, ds, base, name: str, dev, smi: str) -> dict:
    """Phase 14's runner part for strategy ``name``: two fused cohorts of
    ``STRATEGY_QB`` x ``STRATEGY_ROUNDS`` rounds graphed (one
    ``fused_session`` call each: a capture, then a replay), the first of
    them eager beside (uncounted): graphed picks equal eager up to ties
    (scored on the eager state), the curves while they agree."""
    from ital_tpu_torch import graphs, runner

    plan = dataclasses.replace(
        base, method=name, method_kwargs={}, max_classes=2 * STRATEGY_QB, queries_per_class=1,
        n_rounds=STRATEGY_ROUNDS, query_batch=STRATEGY_QB, fused_sessions=True,
        log_jsonl=str(WORK_DIR / f"strategies_{name}.jsonl"))
    calls = []
    run = graphs.run

    def spy(prog, *a, **kw):
        calls.append(prog)
        return run(prog, *a, **kw)

    known = _known_programs()
    graphs.run = spy
    try:
        res, ms = _timed_cohorts(runner, plan, ds, dev)
    finally:
        graphs.run = run
    mine = _phase_programs(known)
    check(calls == ["fused_session"] * 2 and [p.name for p in mine] == ["fused_session"]
          and mine[0].replays - known.get(id(mine[0]), (None, 0))[1] == 2,
          f"{name}: one program for both fused cohorts: {calls}, "
          f"{[(p.name, p.replays) for p in mine]}")
    prog = mine[0]
    record = []
    one = dataclasses.replace(plan, max_classes=STRATEGY_QB,
                              log_jsonl=str(WORK_DIR / f"strategies_{name}_eager.jsonl"))
    with _graphed_or_eager("eager"), _record_cohort_selections(record):
        eager, eager_ms = _timed_cohorts(runner, one, ds, dev)
    check(bool(np.isfinite(res["ap"]).all()) and res["ap"].shape == (2 * STRATEGY_QB,
                                                                      STRATEGY_ROUNDS),
          f"{name}: fused cohort AP shape and values")
    differ = 0
    for k in range(STRATEGY_QB):
        gp_, ep = res["picks"][k].tolist(), eager["picks"][k].tolist()
        r = next((r for r in range(STRATEGY_ROUNDS) if gp_[r] != ep[r]), STRATEGY_ROUNDS)
        check(np.array_equal(res["ap"][k, :r], eager["ap"][k, :r]),
              f"{name}: fused cohort graphed curves equal eager while the picks agree")
        if r < STRATEGY_ROUNDS:
            states, params = record[r]
            differ += _held_up_to_ties(name, states[k], params, gp_[r], ep[r],
                                       f"fused cohort session {k} round {r}")
    print(f"strategies {name}: fused cohort of {STRATEGY_QB} x {STRATEGY_ROUNDS} rounds: "
          f"graphed {[round(t, 3) for t in ms]} ms a cohort (capture, replay), eager "
          f"{[round(t, 3) for t in eager_ms]}; {differ} sessions part at ties; MAP "
          f"{[round(float(m), 6) for m in res['map']]} [{smi}]")
    _print_programs([prog], {}, f"strategies {name} fused cohort", smi)
    return {"graphed_ms": ms, "eager_ms": eager_ms, "launches": sum(prog.launches.values())}


def strategies_phase(torch, ds, dev, smi: str) -> dict:
    """Phase 14: every strategy but ITAL as programs.  Returns the graphed
    runs' launches by route, the kernel's timings at the strategies' block
    shapes and each strategy's times, memory and launches per replay."""
    from ital_tpu_torch import graphs, serve
    from ital_tpu_torch.ops import rbf_hopper
    from ital_tpu_torch.utils.config import load_config

    t_phase = time.perf_counter()
    base = load_config(str(HARNESS_CONFIG), HARNESS_OVERRIDES)
    shapes = _strategy_kernel_shapes(torch, ds, base, smi)
    torch.cuda.synchronize()
    _reset_counts()  # the strategies path's count starts here
    svc = serve.RetrievalService(
        ds.x, length_scale=base.gp.length_scale, var=base.gp.var, noise=base.gp.noise, cap=CAP,
        device=dev)
    rng = np.random.default_rng(SEED + 14)
    captured, out = graphs.captures(), {}
    for name in _strategy_names():
        t0 = time.perf_counter()
        before = rbf_hopper.LAUNCHES
        out[name] = _strategy_requests(torch, svc, ds, name, rng, smi)
        out[name]["fused"] = _strategy_cohort(torch, ds, base, name, dev, smi)
        print(f"strategies {name}: {time.perf_counter() - t0:.1f} s, "
              f"{rbf_hopper.LAUNCHES - before} kernel launches")
    launches = dict(rbf_hopper.ROUTE_LAUNCHES)
    check(sum(launches.values()) > 0, "the kernel launched on the strategies path")
    pool = _pool_mib(torch)
    held = [p for p in graphs.programs() if p.stacks]
    print(f"strategies phase: {time.perf_counter() - t_phase:.1f} s; "
          f"{graphs.captures() - captured} captures; launches {launches}; stacking programs "
          f"held {len(held)}, stages {sum(s.nbytes for s in graphs.stages()) / 2**20:.2f} MiB "
          f"of {graphs.STACK_BYTES / 2**20:.0f}; graph pools "
          f"{'not reported' if pool is None else f'{pool:.1f} MiB'} [{smi}]")
    return {"launches": launches, "shapes": shapes, "by_strategy": out}


def _scale_kernel_shapes(torch, big, cfg, dev, smi: str) -> list:
    """The kernel at the 1M-row path's blocks, on the bfloat16 corpus and on
    its float32 source: ``gp_fit``'s (cap, N) and the update's (b, N) with
    b2, the full scan's (N, t) with a2 and the pool's (4096, t) cross block;
    each against its plain version, the route the router did not pick, and
    its bound."""
    x = torch.from_numpy(big.x).to(dev)
    xb = x.to(torch.bfloat16)
    x2 = (x * x).sum(-1)
    xb2 = _f32_norms(torch, xb)
    rng = np.random.default_rng(SEED + 41)
    n, d = big.x.shape

    def rows(m):
        return torch.from_numpy(rng.choice(n, size=m, replace=False)).to(dev)

    fit, upd, part, pool = rows(CAP), rows(cfg.batch_size), rows(cfg.batch_size - 1), rows(4096)
    t = cfg.batch_size - 1
    shapes = [(f"gp_fit ({CAP}, {n}, {d}) b2", xb[fit], xb, {"b2": xb2}),
              (f"update ({cfg.batch_size}, {n}, {d}) b2", xb[upd], xb, {"b2": xb2}),
              (f"gp_fit ({CAP}, {n}, {d}) b2", x[fit], x, {"b2": x2}),
              (f"full scan ({n}, {t}, {d}) a2", xb, xb[part], {"a2": xb2}),
              (f"full scan ({n}, {t}, {d}) a2", x, x[part], {"a2": x2}),
              (f"pool cross (4096, {t}, {d})", xb[pool], xb[part], {})]
    ls = torch.tensor(cfg.gp.length_scale, device=dev)
    var = torch.tensor(cfg.gp.var, device=dev)
    return _kernel_shapes(torch, "1M", shapes, ls, var, smi, other_route=True)


def _f32_norms(torch, x):
    """A corpus' squared row norms as ``gp_init`` forms them: f32 sums of
    the stored values."""
    xf = x.to(torch.float32)
    return (xf * xf).sum(-1)


def _scale_session(torch, big, cfg, dev, smi: str) -> dict:
    """``ActiveRetrieval`` over the bfloat16 1M-row corpus at the production
    options: ``update_query`` and ``SCALE1M_ROUNDS`` graphed rounds of fetch,
    simulated user, update and AP (the path's count), then fetches timed on
    the last state (uncounted); its programs' static and pool MiB."""
    from ital_tpu_torch import graphs
    from ital_tpu_torch.data.user import simulate_feedback
    from ital_tpu_torch.models import gp as gp_mod
    from ital_tpu_torch.models.session import ActiveRetrieval
    from ital_tpu_torch.ops import rbf_hopper
    from ital_tpu_torch.utils.metrics import average_precision

    rng = np.random.default_rng(SEED + 43)
    cls = int(rng.choice(big.classes))
    q = int(big.queries_for_class(cls, rng, 1)[0])
    relevant = torch.from_numpy(big.relevance[:, cls]).to(dev)
    exclude = torch.zeros(big.n, dtype=torch.bool, device=dev)
    exclude[q] = True
    gen = torch.Generator(device=dev).manual_seed(SEED)
    k = cfg.batch_size
    known, pool0 = _known_programs(), _pool_mib(torch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()

    _reset_counts()  # the 1M session's count starts here
    t0 = time.perf_counter()
    sess = ActiveRetrieval(
        big.x, length_scale=cfg.gp.length_scale, var=cfg.gp.var, noise=cfg.gp.noise, cap=CAP,
        strategy=cfg.method, label_prob=cfg.user.label_prob, mistake_prob=cfg.user.mistake_prob,
        seed=SEED, method_kwargs=cfg.method_kwargs, corpus_dtype=SCALE1M_DTYPE, device=dev)
    sess.update_query(q)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    st = sess.state
    check(st.x.dtype == torch.bfloat16 and st.x2.dtype == torch.float32
          and st.v.dtype == torch.float32, f"bfloat16 corpus, f32 norms and posterior: "
          f"{st.x.dtype} {st.x2.dtype} {st.v.dtype}")
    check(torch.equal(st.x.cpu().view(torch.int16),
                      torch.from_numpy(big.x).to(torch.bfloat16).view(torch.int16)),
          "the card's bfloat16 rounding equals the host's bit for bit")
    check(torch.equal(st.x2, _f32_norms(torch, st.x)), "x2 summed in f32 from the stored values")
    check(rbf_hopper.LAUNCHES > 0, "kernel launched in update_query at 1M rows")
    print(f"scale session: query {q} (class {cls}); init + query {init_s:.3f} s (host to "
          f"device, bfloat16 rounding on the card, norms, gp_set_query); launches "
          f"{rbf_hopper.LAUNCHES}")
    rows, aps, mid = [], [], None
    labeled = {q}
    for r in range(SCALE1M_ROUNDS):
        before = rbf_hopper.LAUNCHES
        snapshot = gp_mod.state_to_arrays(sess.state) if r == SCALE1M_MID else None
        t0 = time.perf_counter()
        batch = sess.fetch_unlabelled(k)  # returns host indices: synchronizes
        t1 = time.perf_counter()
        check(len(set(batch.tolist())) == k and not set(batch.tolist()) & labeled
              and bool(((batch >= 0) & (batch < big.n)).all()),
              f"round {r}: {k} distinct unlabeled indices in range {batch}")
        y, valid = simulate_feedback(gen, torch.as_tensor(batch, device=dev), relevant,
                                     sess.params.label_prob, sess.params.mistake_prob)
        fb = {int(i): (int(yy) if vv else 0)
              for i, yy, vv in zip(batch.tolist(), y.tolist(), valid.tolist())}
        t2 = time.perf_counter()
        sess.update(fb)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        aps.append(float(average_precision(sess.state.mu, relevant, exclude)))
        t4 = time.perf_counter()
        check(rbf_hopper.LAUNCHES > before, f"round {r}: kernel launched at 1M rows")
        labeled |= {i for i, v in fb.items() if v}
        rows.append({"fetch": (t1 - t0) * 1e3, "update": (t3 - t2) * 1e3,
                     "round": (t4 - t0) * 1e3})
        print(f"scale round {r}: batch {batch.tolist()} feedback {list(fb.values())} fetch "
              f"{rows[-1]['fetch']:.3f} ms, update {rows[-1]['update']:.3f} ms, round "
              f"{rows[-1]['round']:.3f} ms, AP {aps[-1]:.6f}, launches "
              f"{rbf_hopper.LAUNCHES - before}")
        if snapshot is not None:
            mid = {"arrays": snapshot, "batch": batch, "feedback": fb, "mu": sess.scores()}
    launches = dict(rbf_hopper.ROUTE_LAUNCHES)
    peak = torch.cuda.max_memory_allocated() - held
    check(st.count == 1 + SCALE1M_ROUNDS * k and all(np.isfinite(aps))
          and bool(torch.isfinite(st.mu).all() and torch.isfinite(st.sig2).all()),
          "1M session: count, AP, mu and sig2")
    with _uncounted():
        fetches = []
        for _ in range(SCALE1M_FETCHES):
            t0 = time.perf_counter()
            sess.fetch_unlabelled(k)
            fetches.append((time.perf_counter() - t0) * 1e3)
    progs = _phase_programs(known)
    _print_programs(progs, known, "scale session", smi)
    regression = _regression_fetch(torch, sess, k, smi)
    pool1 = _pool_mib(torch)
    steady = {kind: float(np.median([row[kind] for row in rows[1:]])) for kind in rows[0]}
    print(f"scale session: AP curve {[round(a, 6) for a in aps]}; first round (captures) "
          f"fetch {rows[0]['fetch']:.1f} ms, update {rows[0]['update']:.1f} ms; steady "
          f"(rounds 2-{SCALE1M_ROUNDS}, medians) fetch {steady['fetch']:.3f} ms, update "
          f"{steady['update']:.3f} ms, round {steady['round']:.3f} ms; {SCALE1M_FETCHES} "
          f"fetches on the last state {_ms(fetches)}; device memory the session took "
          f"(max_memory_allocated above what was held) {peak / 2**20:.1f} MiB; graph pools "
          f"{pool0} -> {pool1} MiB; launches by route {launches} [{smi}]")
    return {"launches": launches, "mid": mid,
            "per_replay": {**{p.name: sum(p.launches.values()) for p in progs},
                           **regression}}


def _regression_fetch(torch, sess, k: int, smi: str) -> dict:
    """One ``ital_regression`` fetch on the 1M session's last state (its
    (K, t, N) conditional-variance solves go through ``tri_solve``),
    uncounted, in graphed / eager / eager / graphed turns of
    ``SCALE1M_REGRESSION_CALLS`` calls: the graphed picks equal the eager
    ones; returns its program's launches per replay."""
    from ital_tpu_torch.select.regression import select_ital_regression

    st, params = sess.state, sess.params
    known = _known_programs()
    times, picks, first = {}, {}, None
    with _uncounted():
        for mode in GRAPH_TURNS:
            with _graphed_or_eager(mode):
                for _ in range(SCALE1M_REGRESSION_CALLS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    batch = select_ital_regression(st, k, None, params)
                    torch.cuda.synchronize()
                    ms = (time.perf_counter() - t0) * 1e3
                    if mode == "graphed" and first is None:
                        first = ms  # the capture
                        continue
                    times.setdefault(mode, []).append(ms)
                    picks.setdefault(mode, batch.tolist())
    check(picks["graphed"] == picks["eager"] and len(set(picks["graphed"])) == k,
          f"1M ital_regression: graphed picks {picks['graphed']} equal eager {picks['eager']}")
    progs = [p for p in _phase_programs(known) if "regression" in p.name]
    check(len(progs) == 1, f"one ital_regression program: {[p.name for p in progs]}")
    per_replay = sum(progs[0].launches.values())
    print(f"scale ital_regression fetch at {st.x.shape[0]} rows: first {first:.3f} ms (its "
          f"capture), graphed {_ms(times['graphed'])} (median "
          f"{np.median(times['graphed']):.3f}), eager {_ms(times['eager'])} (median "
          f"{np.median(times['eager']):.3f}); launches per replay {per_replay}; picks "
          f"{picks['graphed']} [{smi}]")
    return {progs[0].name: per_replay}


def _scale_service(torch, big, cfg, dev, smi: str) -> dict:
    """The server over the bfloat16 1M-row corpus over HTTP: ``SCALE1M_K``
    sessions, ``SCALE1M_SERVE_ROUNDS`` rounds of ``/batch_select`` and
    ``/batch_feedback`` of all of them (the path's count); the second round
    captures nothing; the device memory each request adds per session, held
    to the select budget and its fit."""
    from ital_tpu_torch import graphs, serve
    from ital_tpu_torch.ops import rbf_hopper

    svc = serve.RetrievalService(
        big.x, length_scale=cfg.gp.length_scale, var=cfg.gp.var, noise=cfg.gp.noise, cap=CAP,
        strategy=cfg.method, label_prob=cfg.user.label_prob, mistake_prob=cfg.user.mistake_prob,
        corpus_name="corpus1m", method_kwargs=cfg.method_kwargs, corpus_dtype=SCALE1M_DTYPE,
        device=dev)
    check(svc.x.dtype == torch.bfloat16, f"the service's one corpus copy is {svc.x.dtype}")
    srv = serve.make_server(svc, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    times, launches = {}, {}
    rise = {"batch_select": 0.0, "batch_feedback": 0.0}

    def call(kind, path, body):
        """One POST; its host time runs until the device is idle again, and
        a cohort request's device memory above what was held is kept."""
        req = urllib.request.Request(base + path, data=json.dumps(body).encode(), method="POST",
                                     headers={"Content-Type": "application/json"})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held, before = torch.cuda.memory_allocated(), rbf_hopper.LAUNCHES
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=600) as resp:
                payload = json.loads(resp.read())
        except urllib.error.HTTPError as e:
            raise RuntimeError(f"POST {path}: HTTP {e.code} {e.read()!r}") from e
        torch.cuda.synchronize()
        times.setdefault(kind, []).append((time.perf_counter() - t0) * 1e3)
        launches.setdefault(kind, []).append(rbf_hopper.LAUNCHES - before)
        if kind in rise:
            rise[kind] = max(rise[kind],
                             (torch.cuda.max_memory_allocated() - held) / SCALE1M_K)
        return payload

    try:
        rng = np.random.default_rng(SEED + 47)
        classes = [int(c) for c in rng.choice(big.classes, SCALE1M_K // 2, replace=False)]
        queries = [(int(q), c) for c in classes for q in big.queries_for_class(c, rng, 2)]
        user = _user(rng, big, cfg.user.label_prob, cfg.user.mistake_prob)
        known = _known_programs()
        torch.cuda.synchronize()
        _reset_counts()  # the 1M server's count starts here
        sids = []
        for q, _ in queries:
            sids.append(call("create", "/sessions", {})["session_id"])
            call("query", f"/sessions/{sids[-1]}/query", {"index": q})
        labeled = {sid: {q} for sid, (q, _) in zip(sids, queries)}
        captured = []
        for r in range(SCALE1M_SERVE_ROUNDS):
            c0 = graphs.captures()
            picks = call("batch_select", "/batch_select",
                         {"session_ids": sids, "k": cfg.batch_size})["batches"]
            for sid in sids:
                batch = picks[sid]
                check(len(set(batch)) == cfg.batch_size and all(0 <= i < big.n for i in batch)
                      and not set(batch) & labeled[sid],
                      f"1M serve round {r}: distinct unlabeled indices in range {batch}")
            answers = {sid: user(picks[sid], c) for sid, (_, c) in zip(sids, queries)}
            got = call("batch_feedback", "/batch_feedback", {"feedback": answers})["sessions"]
            want = 1 + (r + 1) * cfg.batch_size
            check(all(got[sid] == {"labeled": want} for sid in sids), f"round {r}: {got}")
            for sid, ans in answers.items():
                labeled[sid] |= {int(i) for i, y in ans.items() if y}
            captured.append(graphs.captures() - c0)
        route_launches = dict(rbf_hopper.ROUTE_LAUNCHES)
        sess, _ = svc._entry(sids[0])
        check(bool(torch.isfinite(sess.state.mu).all()), "1M serve: mu finite")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    progs = _phase_programs(known)
    _print_programs(progs, known, "scale serve", smi)
    held = [p for p in graphs.programs() if p.stacks]
    print(f"scale serve: captures a round {captured}; programs with stacks held "
          f"{[(p.name, round(p.static_bytes / 2**20, 2)) for p in held]} MiB of their own, "
          f"stages {sum(s.nbytes for s in graphs.stages()) / 2**20:.2f} MiB of "
          f"graphs.STACK_BYTES {graphs.STACK_BYTES / 2**20:.0f} MiB; graph pools "
          f"{_pool_mib(torch)} MiB [{smi}]")
    check(captured[0] > 0 and captured[-1] == 0,
          f"1M serve: the second round captures nothing {captured}")
    for kind in ("query", "batch_select", "batch_feedback"):
        check(all(n > 0 for n in launches[kind]),
              f"1M serve {kind}: the kernel launched in every request {launches[kind]}")
    for kind, ms in times.items():
        print(f"scale serve {kind}: {len(ms)} requests, host ms {_ms(ms)} (median "
              f"{np.median(ms):.3f}); kernel launches per request "
              f"{min(launches[kind])}-{max(launches[kind])} [{smi}]")
    copies, fixed = SELECT_FIT
    fit = copies * CAP * big.n * 4 + fixed
    print(f"scale serve: ITAL's select fit at {big.n} rows, {copies} copies + "
          f"{fixed / 2**20:.1f} MiB: {fit / 2**20:.2f} MiB a session; measured "
          f"{rise['batch_select'] / 2**20:.2f} MiB ({(rise['batch_select'] - fixed) / (CAP * big.n * 4):.3f} "
          f"copies above the fixed term); update {rise['batch_feedback'] / (CAP * big.n * 4):.3f} "
          f"copies [{smi}]")
    _check_budget(rise, CAP, big.n)
    return {"launches": route_launches,
            "per_replay": {p.name: sum(p.launches.values()) for p in progs}}


def scale_phase(torch, dev, smi: str) -> dict:
    """Phase 15: the session and the cohort server over a 1M x 512 bfloat16
    corpus; returns the paths' launches, the kernel's 1M shapes and the
    programs' launches per replay."""
    from ital_tpu_torch.data.datasets import corpus100k
    from ital_tpu_torch.utils.config import load_config

    t_phase = time.perf_counter()
    cfg = load_config(str(CONFIG))
    t0 = time.perf_counter()
    big = corpus100k(n=SCALE1M_N, dim=512)
    print(f"scale: corpus100k(n={big.n}, dim={big.x.shape[1]}) built on the host in "
          f"{time.perf_counter() - t0:.1f} s")
    shapes = _scale_kernel_shapes(torch, big, cfg, dev, smi)
    session = _scale_session(torch, big, cfg, dev, smi)
    t0 = time.perf_counter()
    cpu_phase(torch, big, cfg, session.pop("mid"), corpus_dtype=SCALE1M_DTYPE, what="cpu 1M")
    print(f"scale: the CPU replay at {big.n} rows took {time.perf_counter() - t0:.1f} s")
    served = _scale_service(torch, big, cfg, dev, smi)
    print(f"scale phase: {time.perf_counter() - t_phase:.1f} s")
    return {"session": session, "serving": served, "shapes": shapes}


RECORDS_ITAL_KWARGS = "pool_size=4096,n_qmc=32,refine_top=64,refine_n_qmc=512"
# Each method's reference record: its per-seed final MAPs bound the port's.
RECORDS_REFERENCE = {"ital": "mirflickr_methods_italpool.json",
                     "random": "mirflickr_methods.json"}
RECORDS_SEED = 0
RECORDS_DRIFT = {"rounds": 60, "every": 20, "cap": 256, "noisy": True}
DRIFT_MU_ATOL = 1e-3  # ||mu_inc - mu_oracle||_inf at every checkpoint
DRIFT_MIN_OVERLAP = 0.95  # the oracle's top 100 kept by the appended posterior


def records_phase(torch, ds, dev, smi: str) -> dict:
    """Phase 16: the reference's records at reduced depth.  The method
    comparison's run function (``scripts/method_comparison_torch.py``) for
    ITAL at the production options and for ``random`` at seed 0 (14
    sessions in fused cohorts of 7, 10 rounds), each final MAP inside the
    per-seed finals of its reference record and ITAL's above random's; then
    the drift study (``scripts/drift_study_torch.py``) at cap 256 for 60
    rounds with the noisy user, within ``DRIFT_MU_ATOL`` of the f64 oracle
    and keeping ``DRIFT_MIN_OVERLAP`` of its top 100 at every checkpoint.
    Returns the path's launches (both runs)."""
    from ital_tpu_torch.ops import rbf_hopper

    sys.path.insert(0, str(ROOT / "scripts"))
    import drift_study_torch
    import method_comparison_torch as mct

    t_phase = time.perf_counter()
    _reset_counts()  # the records' count starts here
    finals = {}
    for method, kw in (("ital", RECORDS_ITAL_KWARGS), ("random", "")):
        args = mct.parser().parse_args(["--methods", method, "--seeds", str(RECORDS_SEED),
                                        "--ital-kwargs", kw])
        got = mct.compare(args, device=dev, data=ds, log=lambda line: None)[method]
        with open(ROOT / "results" / RECORDS_REFERENCE[method]) as fh:
            ref = json.load(fh)[method]
        finals[method] = got["map"][-1]
        lo, hi = min(ref["final_map_by_seed"]), max(ref["final_map_by_seed"])
        print(f"records {method} seed {RECORDS_SEED} ({got['sessions']} sessions, "
              f"{got['mode']}, {got['wall_s_per_seed'][0]} s, any captures included): MAP "
              f"{got['map']}; the reference's mean over seeds {ref['seeds'][0]}-"
              f"{ref['seeds'][-1]} ({RECORDS_REFERENCE[method]}) {ref['map']}; its per-seed "
              f"finals {lo}-{hi} [{smi}]")
        check(lo <= finals[method] <= hi, f"records {method}: final MAP {finals[method]} "
              f"inside the reference's per-seed finals [{lo}, {hi}]")
    check(finals["ital"] > finals["random"], f"records: ITAL above random {finals}")
    drift = drift_study_torch.run(device=dev, data=ds, seed=RECORDS_SEED, log=print,
                                  **RECORDS_DRIFT)
    launches = dict(rbf_hopper.ROUTE_LAUNCHES)
    rows = drift["rows"]
    check([r["round"] for r in rows] == list(range(RECORDS_DRIFT["every"],
                                                   RECORDS_DRIFT["rounds"] + 1,
                                                   RECORDS_DRIFT["every"])),
          f"drift checkpoints {[r['round'] for r in rows]}")
    for r in rows:
        check(r["mu_inf_inc"] <= DRIFT_MU_ATOL and r["top100_overlap_inc"] >= DRIFT_MIN_OVERLAP,
              f"drift round {r['round']}: ||mu_inc - mu_oracle||_inf {r['mu_inf_inc']:.3e} <= "
              f"{DRIFT_MU_ATOL}, top-100 overlap {r['top100_overlap_inc']} >= "
              f"{DRIFT_MIN_OVERLAP}")
    print(f"records drift (cap {RECORDS_DRIFT['cap']}, {RECORDS_DRIFT['rounds']} rounds, noisy "
          f"user, {drift['wall_s']} s): mu_inf_inc {[r['mu_inf_inc'] for r in rows]}, "
          f"sig2_inf_inc {[r['sig2_inf_inc'] for r in rows]}, mu_inf_refit "
          f"{[r['mu_inf_refit'] for r in rows]}, ap_inc {[r['ap_inc'] for r in rows]}; "
          f"launches {launches} [{smi}]")
    print(f"records phase: {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches}


STUDIES_DRAWS = ROOT / "results" / "jax_user_draws_mirflickr_s0-7_torch.npz"
STUDIES_ROUNDS = 3
STUDIES_MI_TIE = 1e-6  # the first pick's MI below the CPU's maximum at the query


def _study_rows(n: int) -> list:
    """One timing row of each selection-config study over ``n`` rows, the row
    each script names (its ``SMOKE_ROW``) looked up by tag in its own
    ``timing_rows``: ``(script: tag, select_ital options)``."""
    import batch_size_timing_torch as bst
    import block_sweep_torch as bsw
    import pool_refine_torch as prt
    import pool_sweep_torch as pst
    import randomize_qmc_study_torch as rqt
    import refine_study_torch as rst

    (m, bs_tag), (config, block) = bst.SMOKE_ROW, bsw.SMOKE_ROW
    return [
        (f"pool_refine: {prt.SMOKE_ROW}", dict(prt.timing_rows())[prt.SMOKE_ROW]),
        (f"refine_study: {rst.SMOKE_ROW}", dict(rst.timing_rows())[rst.SMOKE_ROW]),
        (f"pool_sweep: {pst.SMOKE_ROW}", dict(pst.timing_rows(n))[pst.SMOKE_ROW]),
        (f"randomize_qmc_study: {rqt.SMOKE_ROW}", dict(rqt.timing_rows())[rqt.SMOKE_ROW]),
        (f"batch_size_timing: m{m} {bs_tag}", dict(bst.timing_rows(m))[bs_tag]),
        (f"block_sweep: {config} {block}", dict(bsw.timing_rows(config))[block]),
    ]


def studies_phase(torch, ds, dev, smi: str) -> dict:
    """Phase 17: the selection-config studies at reduced depth.  One timing
    row of each ``scripts/*_torch.py`` study at 25 000 rows on the
    reference's mid-session state (``study_torch.time_selects``: graphed and
    eager, its launches a call), then seed 0 of ``pool_refine_torch``'s
    ``full 128`` (14 sessions in fused cohorts of 7) for ``STUDIES_ROUNDS``
    rounds on the reference's user draws (``STUDIES_DRAWS``).  The
    reference's record (``results/pool_refine_map_cpu.json``) keeps no
    per-seed rounds, and the two packages part at the first greedy step at
    MI ties (PERF.md), so each session's first pick is held to the CPU's
    step-0 MI maximum at the query within ``STUDIES_MI_TIE``.  Returns the
    run's launches: the count is reset just before it and read just after
    (the timing rows print their own launches a call)."""
    from ital_tpu_torch import runner
    from ital_tpu_torch.models import gp as gp_mod
    from ital_tpu_torch.ops import rbf_hopper
    from ital_tpu_torch.select.base import StrategyParams
    from ital_tpu_torch.select.ital import score_candidates_mi
    from ital_tpu_torch.utils.config import load_config

    sys.path.insert(0, str(ROOT / "scripts"))
    import pool_refine_torch as prt
    import study_torch as st

    t_phase = time.perf_counter()
    state = st.mid_session_state(ds, dev)
    for tag, kwargs in _study_rows(ds.n):
        r = st.time_selects(torch, dev, state, [(tag, kwargs)], log=lambda line: None,
                            target_s=0.1)[tag]
        print(f"studies {tag}: {r['ms_per_round']:.3f} ms graphed {r['ms_trials']}, "
              f"{r['eager_ms_per_round']:.3f} eager, first call {r['first_call_s']:.3f} s, "
              f"{r['launches_per_call']:g} launches a call [{smi}]")
        check(r["ms_per_round"] > 0 and r["eager_ms_per_round"] > 0,
              f"studies {tag}: timed in both modes")
    del state
    tag, *full = prt.MAP_CONFIGS[0]
    mirflickr = str(ROOT / "configs" / "mirflickr.ini")
    cfg = load_config(mirflickr, (
        "EXPERIMENT.seed=0", f"EXPERIMENT.n_rounds={STUDIES_ROUNDS}", "EXPERIMENT.query_batch=7",
        "EXPERIMENT.fused_sessions=true", *(f"METHOD.{kv}" for kv in prt.method_overrides(*full))))
    needed = st.sessions_needed(lambda s: cfg, [0], ds)
    t0 = time.perf_counter()
    with st.user_draws(str(STUDIES_DRAWS), needed):
        _reset_counts()  # the studies' count starts here
        res = runner.run_experiment(cfg, ds, device=dev)
        launches = dict(rbf_hopper.ROUTE_LAUNCHES)
    with open(ROOT / "results" / "pool_refine_map_cpu.json") as fh:
        ref = json.load(fh)["map"][tag]
    print(f"studies {tag} seed 0 on the reference's user draws, {STUDIES_ROUNDS} rounds "
          f"({len(res['sessions'])} sessions, {time.perf_counter() - t0:.1f} s, captures "
          f"included): MAP {[round(float(v), 4) for v in res['map']]}; the reference's "
          f"CPU record, mean over seeds {ref['seeds'][0]}-{ref['seeds'][-1]}: "
          f"{ref['map'][:STUDIES_ROUNDS]}; launches {launches} [{smi}]")
    check(np.asarray(res["ap"]).shape == (len(needed), STUDIES_ROUNDS)
          and np.isfinite(res["ap"]).all(), f"studies {tag}: finite APs")
    params = StrategyParams.create("cpu", label_prob=cfg.user.label_prob,
                                   mistake_prob=cfg.user.mistake_prob)
    x = torch.from_numpy(ds.x)
    first = np.asarray(res["picks"])[:, 0, 0]
    gaps = []
    for (*_, q), pick in zip(needed, first):
        cpu = gp_mod.gp_set_query(gp_mod.gp_init(x, cfg.gp.length_scale, cfg.gp.var,
                                                 cfg.gp.noise, cfg.cap), q)
        mi = score_candidates_mi(cpu, torch.zeros(cfg.batch_size, dtype=torch.long), 0, params)
        mi[q] = -torch.inf
        gaps.append(float(mi.max() - mi[int(pick)]))
    print(f"studies {tag}: first picks {first.tolist()}, their MI below the CPU's step-0 "
          f"maximum {max(gaps):.3e} at most")
    check(max(gaps) <= STUDIES_MI_TIE, f"studies {tag}: each first pick within "
          f"{STUDIES_MI_TIE} of the CPU's maximal MI ({max(gaps):.3e})")
    print(f"studies phase: {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches}


QMC_SMOKE = (8, 256, 2)  # the QMC study's m, n_qmc and problems held card against CPU
QMC_SMOKE_ATOL = 1e-5
AB_N = 25_000  # the router A/B's corpus rows


def _mib(value: Optional[float]) -> str:
    return "not measured" if value is None else f"{value:.1f} MiB"


def batch8_phase(torch, ds, dev, smi: str) -> dict:
    """Phase 18: the MI scan's block from its working set, at m = 8.  The
    full scans ``full 128`` and ``full 256`` (``scripts/mi_block_torch.py``)
    on the reference's mid-session state at 25 000 rows, eager then graphed
    (the path's count: reset just before, read just after), each at the
    blocks ``select.ital.mi_block`` chose, beside the earlier phases'
    programs: graphed picks equal eager, the device-memory peak, the graph
    pool's growth and the programs released for room printed; each eager
    step's pick held, uncounted and before the graphed runs, to the CPU's
    MI over the card's top 256 candidates and 2048 random rows up to
    ``MI_TIE_ATOL``; then two of
    the QMC study's problems at m = 8, n_qmc 256 on the card against the
    CPU within ``QMC_SMOKE_ATOL``; and one row of each router A/B case at
    ``AB_N`` rows through each route against plain
    (``scripts/pallas_ab_torch.py``).  Returns the path's launches."""
    from ital_tpu_torch import graphs
    from ital_tpu_torch.ops import rbf_hopper
    from ital_tpu_torch.select.base import StrategyParams

    sys.path.insert(0, str(ROOT / "scripts"))
    import mi_block_torch as mbt
    import pallas_ab_torch as pab
    import qmc_error_study_torch as qes
    import study_torch as st

    t_phase = time.perf_counter()
    held = len(graphs.programs())
    print(f"batch8: {held} programs held from the earlier phases, graph pools "
          f"{graphs._pool_bytes(torch.device('cuda', torch.cuda.current_device())) / 2**20:.1f}"
          f" MiB [{smi}]")
    state = st.mid_session_state(ds, dev)
    _reset_counts()  # the path's count starts here
    rows = mbt.selections_at(torch, dev, state, uncounted=_uncounted, log=lambda line: None)
    launches = dict(rbf_hopper.ROUTE_LAUNCHES)
    for tag, row in rows.items():
        for mode in ("eager", "graphed"):
            r = row[mode]
            pool = (f", graph pool growth {_mib(r['pool_growth_mib'])}, programs released "
                    f"for room {r['released_for_room']}" if mode == "graphed" else "")
            print(f"batch8 {tag} at {row['n']} rows, {mode}: picks {r['picks']}, first call "
                  f"{r['first_call_s']:.3f} s, a call {r['call_s']:.3f} s, peak "
                  f"{_mib(r['peak_mib'])}{pool}; blocks by step {row['blocks_by_step']} [{smi}]")
        check(row["graphed_equals_eager"], f"batch8 {tag}: graphed picks equal eager")
        steps = row["cpu_replay"]
        gap, diff = max(s["gap"] for s in steps), max(s["diff"] for s in steps)
        print(f"batch8 {tag}: CPU replay of {steps[0]['scored']}-{steps[-1]['scored']} rows a "
              f"step, each pick below the CPU's best by {gap:.3e} at most, |card - CPU| "
              f"{diff:.3e} at most (tie atol {MI_TIE_ATOL})")
        check(gap <= MI_TIE_ATOL and diff <= MI_TIE_ATOL,
              f"batch8 {tag}: every pick within {MI_TIE_ATOL} of the CPU's best")
    print(f"batch8: launches {launches} [{smi}]")
    del state
    m, n_qmc, count = QMC_SMOKE
    cpu = torch.device("cpu")
    on = {d: StrategyParams.create(d, label_prob=qes.LABEL_PROB, mistake_prob=qes.MISTAKE_PROB)
          for d in (dev, cpu)}
    worst = 0.0
    for mu, cov in qes.problems(qes.MS)[m][:count]:
        card, host = (qes.estimates(torch, d, mu, cov, n_qmc, on[d]) for d in (dev, cpu))
        worst = max(worst, *(float(np.max(np.abs(np.asarray(card[k]) - np.asarray(host[k]))))
                             for k in card))
    print(f"batch8 QMC study: {count} problems at m = {m}, n_qmc {n_qmc}: the four estimators "
          f"card vs CPU {worst:.3e} at most (atol {QMC_SMOKE_ATOL})")
    check(worst <= QMC_SMOKE_ATOL, f"batch8 QMC study: card within {QMC_SMOKE_ATOL} of the CPU")
    rng = np.random.default_rng(0)
    x_all = torch.as_tensor(rng.standard_normal((AB_N, pab.D), np.float32), device=dev)
    v_all = torch.as_tensor(rng.standard_normal((pab.CAP, AB_N), np.float32) * 0.05, device=dev)
    with _uncounted():
        ab = pab.run_scale(torch, dev, x_all, v_all, AB_N, "float32", pab.ROUTES,
                           log=lambda line: None, target_s=0.05)
    for case in pab.CASES:
        print(f"batch8 router A/B {case} at {AB_N} rows: " + ", ".join(
            f"{route} {ab[route][case]['ms_per_round']:.4f} ms graphed "
            f"({ab[route][case]['eager_ms_per_round']:.4f} eager)" for route in pab.ROUTES)
            + f"; the router picks {ab['fastest'][case]['router']}, fastest "
              f"{ab['fastest'][case]['route']} [{smi}]")
    for route, e in ab["check"].items():
        print(f"batch8 router A/B {route} against plain: block {e['block']:.3e}, emoc "
              f"{e['emoc_block']:.3e}, density {e['density_block']:.3e} (x var)")
        check(e["held"], f"batch8 router A/B: {route} within {pab.ATOL['float32']} x var of plain")
    print(f"batch8 phase: {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches}


DIGITS_CONFIG = ROOT / "configs" / "digits.ini"
DIGITS_ROUNDS = 2
DIGITS_QB = 5
LEARN_FLOOR_OVERRIDES = (
    "EXPERIMENT.max_classes=2", "EXPERIMENT.n_rounds=4", "EXPERIMENT.query_batch=2",
    "EXPERIMENT.fused_sessions=true", "USER.label_prob=0.6", "USER.mistake_prob=0.15",
    "GP.noise=1.0", "GP.learn_every=2", "GP.learn_prior_strength=1.0",
    "GP.learn_noise_floor=0.05")


@contextlib.contextmanager
def _record_blocks(seen: dict):
    """Record in ``seen`` each block the kernel wrapper is called on, eagerly
    or at a graph's capture: ``(M, N, D, dtype)`` -> (a2 given, b2 given, a
    and b one tensor)."""
    from ital_tpu_torch.ops import rbf_hopper

    orig = rbf_hopper.rbf_tile

    @functools.wraps(orig)
    def recording(a, b, *args, a2=None, b2=None, **kwargs):
        seen.setdefault((a.shape[0], b.shape[0], a.shape[1], a.dtype),
                        (a2 is not None, b2 is not None, a is b))
        return orig(a, b, *args, a2=a2, b2=b2, **kwargs)

    rbf_hopper.rbf_tile = recording
    try:
        yield
    finally:
        rbf_hopper.rbf_tile = orig


def _digits_kernel_cases(torch, ds, cfg, dev, seen: dict) -> dict:
    """Phase 3's check (:func:`_kernel_case`) at every block the digits path
    launched, on rows of the digits at the configuration's length scale and
    variance: each route within ``F32_ATOL`` x var of the plain version and
    timed against its bound.  Uncounted; returns the shapes' records."""
    x = torch.from_numpy(ds.x).to(dev)
    x2 = (x * x).sum(-1)
    ls = torch.tensor(cfg.gp.length_scale, device=dev)
    var = torch.tensor(cfg.gp.var, device=dev)
    rng = np.random.default_rng(SEED)
    rows = lambda k: (torch.arange(k, device=dev) if k == ds.n else  # noqa: E731
                      torch.from_numpy(rng.choice(ds.n, size=k, replace=False)).to(dev))
    shapes = {}
    with _uncounted():
        for (m, n, d, dtype), (has_a2, has_b2, same) in sorted(seen.items(), key=str):
            check(dtype == torch.float32 and d == ds.x.shape[1] and max(m, n) <= ds.n,
                  f"digits: the path's block ({m}, {n}, {d}) {dtype} is one of digit rows")
            ia = rows(m)
            ib = ia if same else rows(n)
            a = x[ia]
            b = a if same else x[ib]
            norms = {k: x2[i] for k, i, given in (("a2", ia, has_a2), ("b2", ib, has_b2))
                     if given}
            name = f"digits ({m}, {n}, {d})" + "".join(f" {k}" for k in norms)
            shapes[name] = _kernel_case(torch, name, a, b, norms, ls, var, F32_ATOL)
            shapes[name].pop("worst")
    return shapes


def _digits_cohort(torch, dev, smi: str) -> dict:
    """Phase 19 (a): the digits without scikit-learn, a fused cohort run on
    the card against the same run on the CPU, and phase 3's kernel check at
    every block the card run launched.  Returns the card run's launches and
    the blocks' records."""
    from ital_tpu_torch import runner
    from ital_tpu_torch.data.datasets import DIGITS_FILE, digits
    from ital_tpu_torch.ops import rbf_hopper
    from ital_tpu_torch.utils.config import load_config

    ds = digits()
    check(Path(DIGITS_FILE).resolve().is_relative_to(ROOT), f"digits: read from the checkout "
          f"({DIGITS_FILE})")
    check(not any(m == "sklearn" or m.startswith("sklearn.") for m in sys.modules),
          "digits: no sklearn module imported in the process")
    check(ds.x.shape == (1797, 64) and float(ds.x.max()) == 1.0 and ds.classes.size == 10,
          f"digits: {ds.x.shape} in [0, 1], 10 classes")
    cfg = load_config(str(DIGITS_CONFIG), (
        f"EXPERIMENT.n_rounds={DIGITS_ROUNDS}", f"EXPERIMENT.query_batch={DIGITS_QB}",
        "EXPERIMENT.fused_sessions=true"))
    t0 = time.perf_counter()
    seen = {}
    with _record_blocks(seen):
        _reset_counts()  # the digits path's count starts here
        card = runner.run_experiment(cfg, ds, device=dev)
        launches = dict(rbf_hopper.ROUTE_LAUNCHES)
    card_s = time.perf_counter() - t0
    record = []
    with _uncounted(), _record_cohort_selections(record):
        cpu = runner.run_experiment(cfg, ds, device="cpu")
    parted = 0
    for k in range(card["picks"].shape[0]):
        a, b = card["picks"][k].tolist(), cpu["picks"][k].tolist()
        r = next((r for r in range(DIGITS_ROUNDS) if a[r] != b[r]), None)
        if r is None:
            continue
        parted += 1
        states, params = record[(k // DIGITS_QB) * DIGITS_ROUNDS + r]
        gaps = _mi_gaps(torch, states[k % DIGITS_QB], params, cfg.method_kwargs, a[r])
        print(f"digits session {k}: round {r} card {a[r]} CPU {b[r]}; the CPU's MI maximum "
              f"minus the card's pick's, step by step, on the CPU's state {gaps}")
        check(max(gaps) <= MI_TIE_ATOL, f"digits session {k}: card and CPU part at an MI tie")
    print(f"digits ({Path(DIGITS_FILE).relative_to(ROOT)}, {ds.x.shape[0]} x {ds.x.shape[1]}, no "
          f"sklearn imported): {card['ap'].shape[0]} sessions in fused cohorts of {DIGITS_QB}, "
          f"{DIGITS_ROUNDS} rounds, {card_s:.1f} s on the card (captures included); MAP card "
          f"{[round(float(v), 4) for v in card['map']]}, CPU "
          f"{[round(float(v), 4) for v in cpu['map']]}; {parted} sessions part from the CPU's "
          f"picks, each at an MI tie; launches {launches} [{smi}]")
    check(bool(seen), "digits: the card run launched the kernel")
    shapes = _digits_kernel_cases(torch, ds, cfg, dev, seen)
    return {"launches": launches, "shapes": shapes}


def _round_terms(torch, ds, dev, smi: str) -> dict:
    """Phase 19 (b): ``round_term_split_torch``'s terms at 25 000 rows, timed
    (uncounted), then each run once graphed and once eager: the path, whose
    count does not depend on how many calls the timing took.  Returns that
    run's launches and each term's launches a graphed call."""
    from ital_tpu_torch import graphs
    from ital_tpu_torch.ops import rbf_hopper

    sys.path.insert(0, str(ROOT / "scripts"))
    import round_term_split_torch as rts

    w = rts.workload_25k(torch, dev, ds)
    with _uncounted():
        terms = rts.measure_terms(torch, w, log=lambda line: None, target_s=0.05, trials=1)
    _reset_counts()  # the terms' count starts here
    for name in rts.TERMS:
        rts.term(w, name, turn=0)
        with graphs.eager():
            rts.term(w, name, turn=0)
    torch.cuda.synchronize()
    launches = dict(rbf_hopper.ROUTE_LAUNCHES)
    for name, r in terms.items():
        print(f"round_terms {name}: {r['graphed_ms']:.4f} ms graphed, {r['eager_ms']:.4f} eager, "
              f"first call {r['first_call_s']:.3f} s, {r['rbf_launches_per_call']:g} launches a "
              f"call, graphed equal to eager {r['graphed_equals_eager']} [{smi}]")
        check(r["graphed_equals_eager"], f"round_terms {name}: graphed outputs equal eager's")
    with _uncounted():
        seq = rts.sequence(torch, w)
    print(f"round_terms: one graphed and one eager call of each term, launches {launches} "
          f"[{smi}]")
    print(f"round_terms round_full against its terms in sequence: {seq}")
    check(seq["batch_equal"] and seq["mu_equal"] and seq["ap_abs"] == 0.0,
          "round_terms: round_full equals select, the user, update and ap in sequence")
    return {"launches": launches,
            "per_call": {name: r["rbf_launches_per_call"] for name, r in terms.items()}}


def _learn_floor_run(torch, ds, cfg, dev, record=None) -> dict:
    """The learning cohorts of ``cfg`` on ``dev``: each session's picks (R,
    b), AP curve and learned (length scale, variance, noise)."""
    from ital_tpu_torch import runner
    from ital_tpu_torch.models import gp as gp_mod
    from ital_tpu_torch.select.base import StrategyParams

    state0 = gp_mod.gp_init(torch.from_numpy(ds.x).to(dev), cfg.gp.length_scale, cfg.gp.var,
                            cfg.gp.noise, cfg.cap)
    params = StrategyParams.create(dev, label_prob=cfg.user.label_prob,
                                   mistake_prob=cfg.user.mistake_prob)
    plan = runner._session_plan(cfg, ds)
    picks, aps, hyper = [], [], []
    for start in range(0, len(plan), cfg.query_batch):
        chunk = plan[start:start + cfg.query_batch]
        states = runner._query_states(state0, chunk)
        relevant = torch.from_numpy(np.stack([ds.relevance[:, c] for _, c, _ in chunk])).to(dev)
        exclude = torch.zeros((len(chunk), ds.n), dtype=torch.bool)
        exclude[torch.arange(len(chunk)), torch.tensor([q for *_, q in chunk])] = True
        with (_record_cohort_selections(record) if record is not None
              else contextlib.nullcontext()):
            a, b = runner._cohort_rounds(cfg, states, params, cfg.method_kwargs, chunk,
                                         range(cfg.n_rounds), relevant, exclude.to(dev))
        picks += b.transpose(0, 1).cpu().tolist()
        aps += a.cpu().tolist()
        hyper += [[float(s.hyper.length_scale), float(s.hyper.var), float(s.hyper.noise)]
                  for s in states]
    return {"picks": picks, "ap": aps, "hyper": hyper}


def _learn_floor(torch, ds, dev, smi: str) -> dict:
    """Phase 19 (c): a fused learning cohort with the MAP type-II prior and
    a noise floor, graphed against eager and against the CPU.  Returns the
    graphed run's launches."""
    import types

    from ital_tpu_torch import graphs
    from ital_tpu_torch.ops import rbf_hopper
    from ital_tpu_torch.utils.config import load_config

    cfg = load_config(str(CONFIG), LEARN_FLOOR_OVERRIDES)
    t0 = time.perf_counter()
    _reset_counts()  # the path's count starts here
    graphed = _learn_floor_run(torch, ds, cfg, dev)
    launches = dict(rbf_hopper.ROUTE_LAUNCHES)
    graphed_s = time.perf_counter() - t0
    with _uncounted(), graphs.eager():
        eager = _learn_floor_run(torch, ds, cfg, dev)
    check(graphed["picks"] == eager["picks"] and graphed["ap"] == eager["ap"],
          "learn_floor: graphed picks and curves equal eager's")
    rel = max(abs(a - b) / max(abs(a), abs(b)) for g, e in zip(graphed["hyper"], eager["hyper"])
              for a, b in zip(g, e))
    check(rel <= LEARN_GRAPH_RTOL, f"learn_floor: learned values graphed vs eager {rel:.2e}")
    record = []
    with _uncounted():
        cpu = _learn_floor_run(torch, ds, cfg, torch.device("cpu"), record)
    worst, parted = 0.0, 0
    for k, (a, b) in enumerate(zip(graphed["picks"], cpu["picks"])):
        r = next((r for r in range(cfg.n_rounds) if a[r] != b[r]), None)
        if r is None:
            worst = max(worst, *(abs(u - v) / max(abs(u), abs(v))
                                 for u, v in zip(graphed["hyper"][k], cpu["hyper"][k])))
            continue
        parted += 1
        states, params = record[(k // cfg.query_batch) * cfg.n_rounds + r]
        with _uncounted():
            gaps = _tie_gaps(types.SimpleNamespace(state=states[k % cfg.query_batch],
                                                   params=params), a[r], cfg.method_kwargs)
        print(f"learn_floor session {k}: round {r} card {a[r]} CPU {b[r]}; refined-MI gaps on "
              f"the CPU's state {gaps}")
        check(all(abs(g) <= MI_TIE_ATOL for g in gaps), "learn_floor: the card and the CPU "
              "part only at MI ties")
    print(f"learn_floor ({len(graphed['picks'])} sessions x {cfg.n_rounds} rounds, learn_every "
          f"{cfg.gp.learn_every}, prior strength {cfg.gp.learn_prior_strength}, noise floor "
          f"{cfg.gp.learn_noise_floor}; {graphed_s:.1f} s graphed, captures included): learned "
          f"(ls, var, noise) card {graphed['hyper']}, CPU {cpu['hyper']}; graphed vs eager "
          f"{rel:.2e}; card vs CPU {worst:.2e} relative where the picks agree ({parted} "
          f"sessions part at MI ties); launches {launches} [{smi}]")
    check(worst <= LEARN_RTOL, f"learn_floor: learned values within {LEARN_RTOL} of the CPU")
    check(all(h[2] >= cfg.gp.learn_noise_floor * (1 - 1e-6) for h in graphed["hyper"]),
          "learn_floor: the learned noise keeps its floor")
    return {"launches": launches}


def final_phase(torch, ds, dev, smi: str) -> dict:
    """Phase 19: the digits without scikit-learn, the round's term split and
    the learning records' floor, each with its own launch count."""
    t_phase = time.perf_counter()
    out = {"digits": _digits_cohort(torch, dev, smi),
           "round_terms": _round_terms(torch, ds, dev, smi),
           "learn_floor": _learn_floor(torch, ds, dev, smi)}
    print(f"final phase: {time.perf_counter() - t_phase:.1f} s")
    return out


def main() -> int:
    import torch

    t_start = time.perf_counter()
    clock = lambda name: print(f"clock: {name} done at {time.perf_counter() - t_start:.1f} s")
    kind, smi = device_phase(torch)
    sys.path.insert(0, str(ROOT))
    from ital_tpu_torch.data.datasets import load_dataset
    from ital_tpu_torch.utils.config import apply_matmul_precision, load_config

    cfg = load_config(str(CONFIG))
    apply_matmul_precision(cfg)
    build_phase()
    ds = load_dataset(cfg.dataset, **cfg.dataset_kwargs)
    print(f"data: {ds.name} {ds.x.shape[0]} x {ds.x.shape[1]}")
    clock("build and data")
    kern = kernel_phase(torch, ds)
    clock("kernel")
    sess = session_phase(torch, ds, cfg, torch.device("cuda"))
    cpu_phase(torch, ds, cfg, sess["mid"])
    clock("session and CPU replay")
    harness = harness_phase(torch, ds, torch.device("cuda"))
    emoc_replay_phase(torch, ds, harness["replay"])
    clock("harness")
    served = serve_phase(torch, ds, cfg, torch.device("cuda"), smi)
    clock("serving")
    cohort, rise25 = cohort_phase(torch, ds, cfg, torch.device("cuda"), smi)
    clock("cohort")
    shard = sharded_phase(torch, ds, cfg, torch.device("cuda"), smi, rise25)
    mesh = mesh_phase(torch, ds, shard["big"], cfg, torch.device("cuda"), smi)
    large = bigcap_phase(torch, shard["big"], torch.device("cuda"), smi)
    clock("sharded, mesh and large cap")
    graphed = graphs_phase(torch, ds, cfg, torch.device("cuda"), smi)
    clock("graphs")
    learn = learn_phase(torch, ds, cfg, torch.device("cuda"), smi)
    clock("learn")
    strategies = strategies_phase(torch, ds, torch.device("cuda"), smi)
    clock("strategies")
    scale = scale_phase(torch, torch.device("cuda"), smi)
    clock("1M rows")
    records = records_phase(torch, ds, torch.device("cuda"), smi)
    clock("records")
    studies = studies_phase(torch, ds, torch.device("cuda"), smi)
    clock("studies")
    batch8 = batch8_phase(torch, ds, torch.device("cuda"), smi)
    clock("batch 8")
    final = final_phase(torch, ds, torch.device("cuda"), smi)
    clock("final")
    # At 512 features every RBF call of the paths takes the tensor-core route
    # (the router's rule, PERF.md); the tile kernel serves narrower or
    # unaligned features and is held against the plain version in phase 3.
    paths = {"session": sess, "harness": harness, "serving": served, **cohort,
             "sharded": {"launches": shard["launches"]}, "mesh": {"launches": mesh["launches"]},
             "bigcap": {"launches": large["launches"]}, "graphs": graphed,
             "learn": {"launches": learn["launches"]},
             "strategies": {"launches": strategies["launches"]},
             "scale_session": scale["session"], "scale_serving": scale["serving"],
             "records": records, "studies": studies, "batch8": batch8,
             "digits": final["digits"], "round_terms": final["round_terms"],
             "learn_floor": final["learn_floor"]}
    by_route = {r: sum(p["launches"][r] for p in paths.values()) for r in sess["launches"]}
    check(by_route["wgmma"] > 0, f"the tensor-core route launched on the main path: {by_route}")
    check(all(sum(p["launches"].values()) > 0 for p in paths.values()),
          "the kernel launched on every path")
    print(json.dumps({"kernels": [{
        "name": "rbf_tile",
        "route": "cuda",
        "source": "ital_tpu_torch/csrc/rbf_wgmma.cu",
        "replaces": "ital_tpu/ops/pallas_rbf.py:90",
        "launches": sum(by_route.values()),
        "launches_by_route": by_route,
        "sources_by_route": {"wgmma": "ital_tpu_torch/csrc/rbf_wgmma.cu",
                             "tile": "ital_tpu_torch/csrc/rbf_tile.cu"},
        "launches_by_path": {name: sum(p["launches"].values()) for name, p in paths.items()},
        "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"],
        "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"],
        "bound_by": kern["bound_by"],
        # No one PyTorch call computes var * exp(-d2 / (2 ls^2)) (cdist
        # stops at the distances).
        "library_ms": None,
        "shape": "64x25000x512 f32",
        "shapes_100k": shard["shapes"],
        "shapes_mesh_cohort": mesh["shapes"],
        "shapes_bigcap": large["shapes"],
        # The ascent's block at every step of /learn (and gp_fit's k_ll).
        "shape_ascent": {"shape": "64x64x512 f32", "launches_per_learn": learn["per_learn"],
                         **kern["by_shape"][ASCENT_SHAPE]},
        # The blocks the strategies' programs launch, and each program's
        # launches per replay (fetch, /batch_select of 8, fused cohort).
        "shapes_strategies": strategies["shapes"],
        # Each mesh program's launches per replay at its shapes (phases 9-10),
        # and the large-cap programs' (phase 11: the refit's two blocks).
        "launches_per_replay_mesh": {**shard["per_replay"], **mesh["per_replay"]},
        "launches_per_replay_bigcap": large["per_replay"],
        "launches_per_replay_strategies": {
            name: {**r["launches"], "fused_cohort": r["fused"]["launches"]}
            for name, r in strategies["by_strategy"].items()},
        # Phase 15: the 1M-row bfloat16 path's blocks, and its programs'
        # launches per replay (the session's fetch and update, the server's
        # stacked selection and update of 8).
        "shapes_1m": scale["shapes"],
        "launches_per_replay_1m": {**scale["session"]["per_replay"],
                                   **scale["serving"]["per_replay"]},
        # Phase 19: each term of the round's split at 25 000 rows, launches a
        # graphed call.
        "launches_per_term_25k": final["round_terms"]["per_call"],
        # Phase 19: the blocks the digits path launched (1797 x 64 rows),
        # each held against the plain version and timed as in phase 3.
        "shapes_digits": final["digits"]["shapes"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
