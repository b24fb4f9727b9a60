#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout, holds each
kernel against its plain PyTorch version on the card, drives the port's
paths — single-device maximum-clique discovery one super-step a host read
and in macro-steps, the same over 2 and 8 shards, in macro-steps with
stale bounds too, labeled subgraph
isomorphism, top-k pattern mining, durable runs killed and resumed (on
one device and sharded), the discovery service and its JSONL serve loop
(sharded requests among them), and the co-workload path from
the data pipeline through the float kernels — at full width, and prints
where the time went.  Phases, one line
each (plus detail):

1. environment: the card's name and power limit, the kernels' build; for
   ``flash_attention``, the counts of ``HGMMA`` (wgmma) and ``UTMALDG``
   (TMA load) instructions in the SASS of each of its kernels and
   ``ptxas``' registers and spill bytes of each, the other libraries'
   registers and spill bytes on lines of their own (it fails where a bf16
   or fp32 attention kernel has no ``HGMMA`` or no ``UTMALDG``, or where
   the DP = 128 kernel of either dtype, the Llama shape's, spills); for
   ``masked_intersect``'s tensor-core kernel, the count of ``BGMMA``
   (1-bit wgmma) instructions in the SASS of each of its instances with
   their registers and spills (it fails where one has no ``BGMMA``, or
   where ``ptxas`` reports its wgmmas serialized);
2. each kernel against its plain version on the card at ragged shapes
   (``masked_intersect`` and ``embedding_bag`` exact, ``segment_matmul``
   within 1e-4 and bit for bit across two calls, ``flash_attention``
   within the reference tests' 2e-4 in fp32 and 3e-2 in bf16, and per
   head within a relative error of 1e-4 and 1e-2); ``masked_intersect``
   also at the main path's shape, with its time, the plain version's time
   and the least time the card could take (bound); ``segment_matmul``'s
   CSR build (``csr_by_node``) bit for bit against ``edges_by_node`` on
   random, sorted, one-node and all-dropped ``dst``, one
   ``segment_matmul`` call shown to be one C call with no sort, search or
   host read, and each call (16-byte and one-element rows, fp32 and
   bf16, sorted and random ``dst``) shown by ``torch.profiler`` to put at
   most two operations and no memset on the card; ``masked_intersect``'s
   three kernels (the tensor-core mma
   kernel, the 64 x 64 tile and the row-streaming kernel, each forced)
   and the call its plan picks, all exact, at every ragged shape; at the
   main shape the planned call (the mma kernel) and the tile on random
   and on all-ones words, masked and not, with the tile's time, the
   bytes bound beside the int8 operations' time and the popcount bound,
   and ``torch._int_mm`` on the operands expanded to 0/1 bytes (1 GiB; a
   yardstick the port never calls) exact and timed; the mma kernel at
   4,194,241 rows x 65 columns x 1 word (more row tiles than one CUDA
   grid dimension holds); it fails where the mma kernel is not faster
   than the tile there; all
   three kernels at the pattern probe's shapes (masked, one all-ones
   column: 8 and 1,024 rows of 1,024 words, 1,024
   of 256, 1,000 of 104), each also from operands one word past a
   16-byte boundary, and at 4,194,305 rows of one word (past the 65,535
   row tiles of one CUDA grid dimension; the row kernel's one grid); at
   1,024 rows of 1,024 and of 256 words, each kernel's time alone
   (``queued_ms``) beside the plain version's and the bound, and the
   call's from an idle card (the host's enqueue included); it fails
   where the planned kernel is slower than the plain version there.
   Then the cut-over sweep: the three kernels exact and timed at 1,024 x
   N x 1,024, masked, N = 1 to 64 (32 and 33 among them), beside the
   plan's cut-over.  ``clique_children`` and the maximum-weight clique's
   two kernels (its weighted child rows and its scoring over 8 weight bit
   planes) bit for bit against their plain versions, timed beside their
   bytes bounds;
3. the quickstart config, the spill probe (at ``steps_per_sync`` 1 and
   16) and a small iso run through the masked kernel (the reference's
   ``tests/test_kernels.py`` case, at ``steps_per_sync`` 1 and 16) on
   ``cuda`` and on ``cpu``: byte-identical answers, every counter equal,
   and the reference's counters; top-k pattern mining on
   ``tests/test_kernels.py``'s case (M = 3, k = 3) with ``use_pallas``
   True and False, on ``cuda`` and then on ``cpu`` in one process, each
   equal to the reference's patterns and counters (4 kernel launches on
   the kernel path); one weighted-clique run (``tests/
   test_weighted_clique.py``'s seed 0) byte-equal on both devices, with
   the reference's counters and the brute-force answer; and Nuri-NP's
   candidate count on the quickstart graph, the reference's;
4. the main path: ``planted_clique_graph(32768, 354000, 32, seed=0)`` with
   ``EngineConfig(k=3, batch=64, pool_capacity=16384)`` must find the
   planted 32-clique, and every kernel of the path must have launched;
   then the maximum-weight clique's path at the benchmark cell's width
   (``phase_weighted_main_path``): each weighted kernel launched once a
   pass launched, T 16 equal to T 1 under a step budget, a spill through the
   queue's page-locked rows, every result a clique of its key's weight;
5. the main path once more under ``torch.profiler``: the device's idle
   share of the wall time and the kernels that take the device time;
6. the co-workload path: four batches each of a GraphSAGE 2-hop sample
   (``NeighborSampler``) through ``segment_matmul``, Criteo-style sparse
   ids (``RecsysStream``) through ``embedding_bag`` and a Llama-3-8B
   attention layer's q/k/v over ``TokenStream`` tokens through
   ``flash_attention``, from ``repro_torch.data.pipeline`` through
   ``repro_torch.kernels.ops`` in fp32 and bf16; each result is held
   against the plain version as in phase 2, and every kernel must have
   launched once a batch in each dtype.  Then each kernel is timed on the
   last batch's inputs, beside its plain version, one PyTorch library
   call for the same function, and its bound (for fp32 attention, whose
   kernel splits each fp32 product into three tf32 tensor-core products,
   the bound of those three, with the fp32 FMA bound beside it);
   ``segment_matmul`` also with the batch's edges shuffled (messages and
   ``dst`` alike, seeded), which runs the radix passes; and a
   ``torch.profiler`` split of one ``segment_matmul`` call in each dtype,
   sorted and shuffled: each kernel's device time against the call's
   wall time;
7. the engine's ``merge_topk`` at k = 4,400, S = 2,050, B = 64 on rows
   equal except in their last 3 words, with duplicates: equal to chained
   stable sorts on the card, with its time and its peak device memory
   above its inputs (at most 2 GiB);
8. the main path of phase 4 in macro-steps (``steps_per_sync=16``), in
   the same process: one macro-step is first shown to enqueue its 16
   steps with no host read (CUDA sync debug mode "error"); the run's
   answer and every counter but ``host_syncs`` must equal phase 4's, with
   ``host_syncs`` below ``steps``; its wall, ms a step, spans, peak memory
   and ``host_syncs``; then a profiled rerun: the idle share beside phase
   5's, and ``masked_intersect`` launches counted in the trace by kernel
   name beside ``steps`` (the difference is the no-op steps a macro-step
   launches after its loop's exit; fewer launches than steps fails);
9. labeled isomorphism at full width: ``labeled_graph(32768, 354000, 29,
   seed=0)``, ``build_iso_index(max_hops=3)`` on the card (set-up), the
   4G query of ``benchmarks/bench_iso.py`` labelled from one induced 4G
   embedding that numpy finds in the graph, ``EngineConfig(k=3, batch=64,
   pool_capacity=16384, spill="host")``; four runs (the masked kernel's
   path and the ``batched`` path, each at ``steps_per_sync`` 1 and 16)
   must agree byte for byte with equal counters (``host_syncs`` between
   equal T), the best result must be an induced, label-preserving
   embedding (checked on the host with numpy), and the kernel's path must
   launch ``masked_intersect`` at least once a step; set-up, steps, ms a
   step, spans, and the masked kernel's time at this shape;
10. top-k pattern mining (M = 3, k = 3) at full width on the kernel path
   (``use_pallas=True``, the probes' rows gathered on the card): (a)
   phase 9's graph, which stops on the reference's default candidate
   budget (``completed=False``), and (b) ``labeled_graph(8192, 88500,
   29, seed=0)``, the same density cut to the largest size of those runs
   that completes; each must give the reference's codes, supports and
   counters and launch ``masked_intersect``'s row kernel exactly once an
   edge probe (856 and 2,218 times, the reference's probe counts), with
   one host read a probe; one run each under ``torch.profiler``: wall,
   probes and their summed host time (launch and read included), split
   into its parts (the cached bitsets, the upload of the pairs, the two
   gathers, the wrapper's launch, the blocking read, other torch calls,
   numpy and Python), the kernel's device time, the rest (the host's
   expansion) and peak device memory;
11. durable runs and the service at full width.  (a) Phase 4's path with
   the disk spill and ``checkpoint_every=64``, in this process: phase 4's
   answer and counters, the checkpoints' count, bytes, capture and commit
   time, and the wall beside phase 4's; then the same in subprocesses of
   this script (``--durable-child '<json>'``), SIGKILLed (exit -9) at the
   first host read past step 150 (T = 1) and inside the second commit
   (T = 16), each resumed in a second subprocess: equal to phase 4's and
   phase 8's results byte for byte with every counter, no ``.tmp``
   checkpoint dir and no spill file left, ``masked_intersect`` launched
   in the resumed run.  (b) One ``DiscoveryService(device="cuda")``: one
   batch of phase 4's clique request, phase 9's iso request
   (``use_pallas``), a repeat of the clique request (a cache hit with no
   engine step), phase 3's pattern request (``use_pallas``, 4 launches)
   and the clique request cut at 100 steps with checkpoints every 32,
   then that request resumed with the full budget in a second call; each
   answer equal to phases 4, 9 and 3, the resumed one with phase 4's
   steps, and ``masked_intersect``'s launches read around each task's
   steps; each request's latency, the service metrics, peak memory.
   (c) ``python -m repro_torch.launch.serve`` with ``--device cuda`` and
   ``--device cpu`` over one JSONL file of the demo graphs (clique and
   its cache hit, weighted clique, iso and pattern with ``use_pallas``,
   a label predicate, malformed lines, ``shards: 2``, a metrics
   command): equal response lines, the wall-clock fields aside, the
   ``shards: 2`` line answered with the one-shard clique answer;
12. the sharded engine (``repro_torch.distributed.ShardedEngine``, T = 1),
   run right after phase 8 on phase 4's computation: phase 4's cell at 2
   and 8 shards must give phase 4's ``result_keys`` and ``result_states``
   byte for byte, launch ``masked_intersect`` exactly ``steps x shards``
   times and count ``syncs == host_syncs == steps``; wall, ms a step, the
   counters (``rebalanced`` among them), the ``per_shard`` lists, the
   spans (``engine.rebalance`` among them) and peak device memory, beside
   the card's name and power limit; the 8-shard run once more under
   ``torch.profiler`` (idle share, the kernels that take the device time,
   ``masked_intersect`` launches in the trace, ``steps x shards``).  Then
   ``tests/test_distributed_engine.py``'s skewed case at 2 shards on
   ``cuda`` and on ``cpu``: byte-identical answers, and every counter and
   ``per_shard`` list equal to the reference's (spill, refill, rebalance
   and late pruning all at work);
13. the sharded engine in macro-steps (``steps_per_sync=16``) with stale
   bounds (``sync_every=K``), right after phase 12, its peak memory its
   own: one 2-shard macro-step at K = 4 is first shown to enqueue with no
   host read (sync debug mode "error"); (a) phase 4's cell at 2 shards, K
   = 1 and 4, and (b) at 8 shards, K = 4: phase 4's bytes, ``masked_intersect``
   launched ``shards x 16 x host_syncs`` times (the no-op inner steps
   after each exit vote included), ``syncs == ceil(steps / K)``, at K = 1
   phase 12's ``spilled`` and ``late_pruned`` with fewer ``host_syncs``;
   wall, ms a step, no-op inner steps, counters beside phase 12's,
   ``per_shard``, spans and peak memory; (b) once more under
   ``torch.profiler``; (c) ``benchmarks/bench_distributed.py``'s
   stale-bound sweep at its own size (``decoy_trap_graph(3400, 8000,
   ...)``, k = 4, C = 64, T = 16; 1, 2 and 8 shards x K = 1, 4, 16), each
   run byte for byte the port's single-device answer with every counter
   the reference's, and its wall; (d) the skewed case at 2 shards, T = 4,
   K = 2 with ``record_bound_trace`` on ``cuda`` and ``cpu``: equal
   bytes, the reference's counters and ``per_shard`` lists (the bound
   traces among them), the bound used never above the fresh one;
14. the sharded checkpoint and the service's sharded path, after phase
   11.  (a) Phase 4's cell at 8 shards, T = 1, the disk spill and
   ``checkpoint_every=64``, in this process: phase 12's 8-shard result
   byte for byte with every counter and ``per_shard`` list; the saves,
   bytes, ``checkpoint.save`` time on the engine's thread, commit time,
   and the wall beside phase 12's.  (b) After the cached blocks are
   released (the free memory printed), two ``--durable-child``
   subprocesses at once: 8 shards, T = 1, SIGKILLed at the first host
   read past step 150, and 2 shards, T = 16, K = 4, SIGKILLed inside the
   second commit; each resumed in a second subprocess must equal phase
   12's 8-shard or phase 13a's K = 4 result with every counter and
   ``per_shard`` list, leave no ``.tmp`` dir and no file in any
   ``shard{i}`` spill dir, and launch ``masked_intersect`` exactly
   ``shards x T x`` its host reads.  (c) One
   ``DiscoveryService(device="cuda")`` batch: phase 4's clique request at
   2 shards (phase 12's answer and stats), the same at T = 16, K = 4
   (phase 13a's), and the 2-shard request cut at 100 steps with
   checkpoints every 32, then resumed with the full budget in a second
   call (phase 12's answer and steps); each request's latency and
   ``masked_intersect`` launches, and peak memory.  Its wall is printed
   as ``[14] phase 14 wall=``.

Each profiled rerun prints the seconds the profiler takes after the run
(its stop and the read of the device intervals from its events).

``python3 chip_smoke.py --weighted`` runs phase 1 and the maximum-weight
clique's kernels and path alone, and prints their ``kernels`` entries.

``python3 chip_smoke.py --sharded-run '<json>'`` runs phase 4's cell
through ``ShardedEngine`` at the given fields alone and prints one JSON
line (wall, counters, launches, no-op inner steps, spans, peak memory).

The line before the last is the kernels' JSON record (each kernel's fp32
numbers, and its bf16 numbers under ``bf16`` where phase 6 runs both,
each with its own launch count; ``masked_intersect``'s mask-free numbers
from phases 2 and 4 (the planned kernel under ``kernel``, the tile's
time and the ``torch._int_mm`` yardstick beside),
its masked form's at the iso shape under ``masked``
with phase 9's launches, at the pattern probe's shapes under
``pattern_probes`` (the row kernel's times, the tile's beside them), the
cut-over sweep under ``cutover`` with the plan's ``rows_max_cols``, and
the launches of each discovery path under ``launches_by_path``, phase
11's durable and service paths, phases 12's and 13's runs and phase
14's durable and service paths among them),
after a line with the whole
run's wall; the last line is
``{"ok": true, "device": {...}}``.  Any failure exits non-zero with no
result line.  Without a CUDA device, or without the repository's
``src/repro_torch`` beside this file, it fails at once.
"""
from __future__ import annotations

import contextlib
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"

# the full-width configuration (PERF.md, "Cells")
FULL_GRAPH = dict(n=32768, m=354_000, clique_size=32, seed=0)
FULL_ENGINE = dict(k=3, batch=64, pool_capacity=16384, spill="host")
# counters of the reference package on the quickstart graph (CPU JAX)
QUICKSTART_GRAPH = dict(n=500, m=3000, clique_size=9, seed=42)
QUICKSTART_CASES = {
    "quickstart": (dict(k=3, batch=64, pool_capacity=16384),
                   dict(steps=24, candidates=1479, expanded=574, pruned=905,
                        spilled=0, refilled=0, late_pruned=0)),
    "spill_probe": (dict(k=3, batch=64, pool_capacity=96),
                    dict(steps=10, candidates=1479, expanded=574, pruned=32,
                         spilled=1049, refilled=176, late_pruned=873)),
}
COUNTERS = ("steps", "candidates", "expanded", "pruned", "spilled",
            "refilled", "late_pruned", "syncs", "host_syncs")
# super-steps a host read in the macro-step runs (phases 3, 8, 9)
MACRO_T = 16
# the maximum-weight clique on the engine at the benchmark cell
# wclique-densify.t16's width: its graph's sizes, DIMACS-W weights
# ((i mod 200) + 1), its request (k 16, batch 64, pool 16,384, host spill),
# cut by a step budget; at T 1 and at the cell's T 16
WEIGHTED_FULL_GRAPH = dict(n=46_336, m=1_000_000, seed=2718281801)
WEIGHTED_FULL_ENGINE = dict(k=16, batch=64, pool_capacity=16_384,
                            spill="host", max_steps=256)
# tests/test_kernels.py::_iso_run's case, with the reference package's
# answer and counters (CPU JAX)
ISO_SMALL_GRAPH = dict(n=90, m=300, n_labels=3, seed=4)
ISO_SMALL_QUERY = ([(0, 1), (1, 2), (2, 3)], [0, 1, 0, 2])
ISO_SMALL_CFG = dict(k=3, batch=32, pool_capacity=4096, max_steps=20000)
ISO_SMALL_WANT = dict(steps=8, candidates=245, expanded=100, pruned=145,
                      spilled=0, refilled=0, late_pruned=0)
ISO_SMALL_KEYS = [42, 37, 37]
# phase 9 (PERF.md, "Cells"): the clique cell's MiCo cut with MiCo's 29
# vertex labels, bench_iso.py's index depth and 4G query
ISO_GRAPH = dict(n=32768, m=354_000, n_labels=29, seed=0)
ISO_HOPS = 3
ISO_4G = [(0, 1), (1, 2), (2, 3), (1, 3)]
ISO_ENGINE = dict(k=3, batch=64, pool_capacity=16384, spill="host")
# phase 12: the sharded engine over phase 4's cell at these shard counts,
# and tests/test_distributed_engine.py's skewed case (a 12-clique on the
# even vertices 0-22 of densifying_graph(96, 500, seed=3)) at 2 shards, with
# the reference package's answer, counters and per-shard lists (CPU JAX, 8
# forced host devices)
SHARDED_FULL = (2, 8)
SKEWED_GRAPH = dict(n=96, m=500, seed=3)
SKEWED_CLIQUE = tuple(range(0, 24, 2))
SKEWED_CFG = dict(k=3, batch=8, pool_capacity=64, max_steps=50_000, shards=2)
SKEWED_WANT = dict(steps=19, candidates=676, expanded=138, pruned=128,
                   spilled=437, refilled=9, rebalanced=18, late_pruned=410,
                   syncs=19, host_syncs=19)
SKEWED_PER_SHARD = dict(spilled=[359, 78], late_pruned=[341, 69],
                        vpq_backlog=[0, 0], pool_occupancy=[0, 0])
SKEWED_KEYS = [12, 11, 11]
# phase 13: the sharded engine in macro-steps (T = MACRO_T) with stale
# bounds (sync_every = K).  (a) phase 4's cell at 2 shards, K = 1 and 4;
# (b) at 8 shards, K = 4, where SHARDED_MACRO_8 holds (PERF.md §5: its
# wall measured alone with --sharded-run); (c) benchmarks/
# bench_distributed.py's stale-bound sweep at its own size; (d) the skewed
# case at T = 4, K = 2 with bound traces.  The reference package's
# answers, counters and per-shard lists (CPU JAX, 8 forced host devices)
SHARDED_MACRO = ((2, 1), (2, 4))
SHARDED_MACRO_8 = (8, 4)
STALE_GRAPH = dict(n=3400, m=8000, skew=0.15, clusters=28, cluster_size=100,
                   cluster_p=0.141, clique_size=8, stride=8, seed=7)
STALE_CFG = dict(k=4, batch=8, pool_capacity=64, max_steps=500_000,
                 steps_per_sync=16)
STALE_SHARDS = (1, 2, 8)
STALE_KS = (1, 4, 16)
STALE_KEYS = [8, 7, 7, 7]
STALE_WANT = {      # BENCH_PR6.json's stale_sweep rows, each one equal
    (1, 1): dict(steps=830, candidates=8293, expanded=6558, pruned=77,
                 spilled=3905, refilled=2247, rebalanced=0, late_pruned=1658,
                 syncs=830, host_syncs=84),
    (1, 4): dict(steps=832, candidates=8293, expanded=6558, pruned=77,
                 spilled=3866, refilled=2208, rebalanced=0, late_pruned=1658,
                 syncs=208, host_syncs=72),
    (1, 16): dict(steps=928, candidates=8290, expanded=6557, pruned=81,
                  spilled=3757, refilled=2105, rebalanced=0, late_pruned=1652,
                  syncs=58, host_syncs=58),
    (2, 1): dict(steps=383, candidates=7951, expanded=5994, pruned=122,
                 spilled=4105, refilled=2091, rebalanced=179, late_pruned=1835,
                 syncs=383, host_syncs=78),
    (2, 4): dict(steps=388, candidates=7956, expanded=6001, pruned=120,
                 spilled=3974, refilled=1976, rebalanced=163, late_pruned=1835,
                 syncs=97, host_syncs=47),
    (2, 16): dict(steps=480, candidates=7934, expanded=5993, pruned=169,
                  spilled=4056, refilled=2188, rebalanced=96, late_pruned=1772,
                  syncs=30, host_syncs=30),
    (8, 1): dict(steps=46, candidates=5527, expanded=2304, pruned=468,
                 spilled=4634, refilled=1759, rebalanced=120, late_pruned=2755,
                 syncs=46, host_syncs=29),
    (8, 4): dict(steps=48, candidates=5535, expanded=2333, pruned=464,
                 spilled=4623, refilled=1781, rebalanced=104, late_pruned=2738,
                 syncs=12, host_syncs=9),
    (8, 16): dict(steps=96, candidates=5565, expanded=2525, pruned=790,
                  spilled=4623, refilled=2277, rebalanced=96, late_pruned=2250,
                  syncs=6, host_syncs=6),
}
SKEWED_MACRO = dict(steps_per_sync=4, sync_every=2, record_bound_trace=True)
SKEWED_MACRO_WANT = dict(steps=20, candidates=673, expanded=135, pruned=131,
                         spilled=437, refilled=11, rebalanced=19,
                         late_pruned=407, syncs=10, host_syncs=6)
SKEWED_MACRO_PER_SHARD = dict(
    spilled=[359, 78], late_pruned=[340, 67], vpq_backlog=[0, 0],
    pool_occupancy=[0, 0],
    bound_used=[[1, 2, 3, 4, 5, 6, 7, 8, 9, 10] + [11] * 10,
                [1, 2, 3, 4, 5, 5, 7, 7, 9, 9] + [11] * 10],
    bound_fresh=[[1, 2, 3, 4, 5, 6, 7, 8, 9, 10] + [11] * 10] * 2)

# masked_intersect (B, N, W): ragged edges in every dimension (the sweeps
# of tests/test_kernels.py among them), then the main path's call shape
RAGGED_SHAPES = ((1, 1, 1), (1, 16, 1), (5, 257, 1), (7, 1, 2), (13, 100, 7),
                 (32, 300, 4), (8, 128, 32), (67, 1000, 33))
MAIN_SHAPE = (64, 32768, 1024)
# the pattern probe's shape, masked: Ep padded rows x one all-ones column
# (the fewest rows, phase 10a's and 10b's widths, and a ragged one), then
# more rows than 65,535 row tiles of 64 (one CUDA grid dimension's limit)
PROBE_SHAPES = ((8, 1, 1024), (1024, 1, 1024), (1024, 1, 256),
                (1000, 1, 104))
PROBE_SHAPE = (1024, 1, 1024)
TIMED_PROBE_SHAPES = ((1024, 1, 1024), (1024, 1, 256))
TALL_SHAPE = ((1 << 22) + 1, 1, 1)
# the mma kernel past 65,535 row tiles of 64 (its grid is one-dimensional)
TALL_MMA_SHAPE = (65535 * 64 + 1, 65, 1)
# the row kernel's cut-over: the three kernels timed at Ep = 1,024 rows
# of 1,024 words, masked, on N random columns (the plan's cut-over, 32,
# and both sides of it)
CUTOVER_SWEEP = (1, 2, 4, 8, 16, 32, 33, 48, 64)
# cycles of the spin kernel queued ahead of a timed call (about 2.5 ms at
# 1.98 GHz, longer than a timed call takes the host to enqueue unless the
# host stalls), and how far it may grow on a rep whose enqueue outlasts it
SPIN_CYCLES = 5_000_000
SPIN_GROWTH_MAX = 64

# phase 3: tests/test_kernels.py's pattern case (M = 3, k = 3), with the
# reference package's answer and counters (CPU JAX, use_pallas False and
# True alike; 4 edge probes, so 4 kernel launches on the kernel path)
PATTERN_SMALL_GRAPH = dict(n=60, m=180, n_labels=3, seed=9)
PATTERN_SMALL = dict(m_edges=3, k=3)
PATTERN_SMALL_WANT = dict(
    patterns=[(18, ((0, 1, 0, 0), (1, 2, 0, 2), (0, 3, 0, 2))),
              (18, ((0, 1, 0, 0), (1, 2, 0, 2), (2, 3, 2, 2))),
              (18, ((0, 1, 0, 2), (1, 2, 2, 2), (2, 3, 2, 0)))],
    candidates=10789, groups_expanded=7, groups_pruned=17, completed=True)
PATTERN_SMALL_PROBES = 4
# phase 3: tests/test_weighted_clique.py's seed-0 case, with the reference
# package's engine answer and counters (CPU JAX)
WEIGHTED_GRAPH = dict(n=50, m=180, seed=0)
WEIGHTED_CFG = dict(k=1, batch=16, pool_capacity=4096)
WEIGHTED_WANT = dict(steps=8, candidates=108, expanded=25, pruned=83,
                     spilled=0, refilled=0, late_pruned=0)
WEIGHTED_KEYS, WEIGHTED_MEMBERS = [43], [11, 29, 35]
# phase 3: Nuri-NP on the quickstart graph (the reference's
# nuri_np_clique_candidates, CPU, max_candidates=2_000_000)
NURI_NP_WANT = dict(candidates=4283, max_clique_size=9, completed=True)

# phase 10 (PERF.md, "Cells"): top-k pattern mining, M = 3, k = 3, on the
# kernel path, with the reference package's answers (CPU JAX,
# repro.core.aggregate.topk_frequent_patterns, use_pallas False; its edge
# probes counted by wrapping repro.core.patterns._edge_probe): on phase
# 9's graph the run stops on the default candidate budget; the 8k cut at
# the same density completes
PATTERN_RESULT_FIELDS = ("patterns", "candidates", "groups_expanded",
                         "groups_pruned", "completed")
PATTERN_CELLS = {
    "pattern M=3": (ISO_GRAPH, dict(
        patterns=[(256, ((0, 1, 2, 16), (1, 2, 16, 13), (2, 3, 13, 27))),
                  (255, ((0, 1, 2, 10), (0, 2, 2, 16), (2, 3, 16, 5))),
                  (254, ((0, 1, 2, 3), (1, 2, 3, 13), (2, 3, 13, 27)))],
        candidates=50_028_358, groups_expanded=1250, groups_pruned=53_083,
        completed=False), 856),
    "pattern M=3 8k": (dict(n=8192, m=88_500, n_labels=29, seed=0), dict(
        patterns=[(86, ((0, 1, 1, 1), (1, 2, 1, 18), (0, 3, 1, 18))),
                  (86, ((0, 1, 3, 26), (0, 2, 3, 27), (2, 3, 27, 26))),
                  (84, ((0, 1, 1, 3), (0, 2, 1, 19), (2, 3, 19, 11)))],
        candidates=37_865_443, groups_expanded=3603, groups_pruned=135_815,
        completed=True), 2218),
}
PATTERN_M = dict(m_edges=3, k=3)

# the scoring kernel's name in a profiler trace (csrc/masked_intersect.cu):
# the stem of all three, and the tensor-core kernel's own
MI_KERNEL = "masked_intersect_kernel"
MI_MMA_KERNEL = "masked_intersect_kernel_mma"

# clique_children (B, M, N, W): ragged rows, widths odd and even (rows 16-
# and 8-byte aligned), grids with a partial last block; the shape of this
# script's own main path (phases 4, 8 and 12: FULL_GRAPH, M = N = 32,768,
# S 2,050); then the benchmark's main path (its cells: B 64, M = N =
# 46,336, S 2,898) and the rows a step it finds valid there (candidates /
# steps, PERF.md)
CHILDREN_RAGGED = ((1, 1, 1, 1), (2, 9, 32, 1), (3, 17, 64, 2),
                   (5, 100, 97, 4), (7, 333, 160, 5), (64, 1001, 1000, 32))
CHILDREN_SMOKE = (64, 32768, 32768, 1024)
CHILDREN_MAIN = (64, 46336, 46336, 1448)
CHILDREN_MAIN_VALID = 66
# the most device operations one clique_children call may put on the card
CHILDREN_MAX_OPS = 2

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
POPC_PER_CLOCK_PER_SM = 16       # CUDA C++ Programming Guide, CC 9.0
# H100 SXM dense peaks (NVIDIA data sheet): fp32 outside the tensor cores,
# bf16 and tf32 on the tensor cores
# and int8 on the tensor cores (operations a second)
PEAK_FLOPS = {"fp32": 67e12, "bf16": 989e12, "tf32": 495e12,
              "int8": 1979e12}

# the co-workload kernels: ragged sweeps (tests/test_kernels.py's among
# them) before the full-width shape; segment_matmul's also rows wider than
# one 256-column slab (D = 264, 512) and more scan tiles than the kernel
# keeps in shared memory (N + 1 > 1,024 x 4,096)
SEGMENT_RAGGED = ((64, 16, 8), (300, 50, 16), (1024, 128, 64), (1, 1, 1),
                  (999, 77, 13), (5000, 3000, 256), (1500, 400, 264),
                  (2000, 500, 512), (200_000, 4_500_000, 4))    # (E, N, D)
EMBEDDING_RAGGED = ((5, 37, 8, 9), (40, 1000, 32, 16), (1, 8, 128, 3),
                    (3, 11, 7, 5), (26, 1000, 128, 333))        # (F, V, D, B)
FLASH_RAGGED = ((2, 128, 32), (4, 256, 64), (1, 512, 16), (1, 1, 8),
                (3, 100, 128), (2, 320, 256), (1, 64, 40),
                (2, 96, 13))                                    # (H, S, D)
# full width (PERF.md, "Cells"): a GraphSAGE 2-hop sample of the main
# path's graph, Criteo (MLPerf DLRM-DCNv2) embedding tables, Llama-3-8B
# attention
SAGE = dict(batch_nodes=512, fanout=(25, 10), d_feat=256)
DLRM = dict(n_sparse=26, n_dense=13, vocab=1_000_000, batch=8192)
DLRM_DIM = 128
LLAMA = dict(heads=32, kv_heads=8, seq=8192, head_dim=128, width=4096,
             vocab=128_256)
COWORK_STEPS = 4
# segment_matmul's CSR alone: every edge on one node, every edge dropped,
# at the GraphSAGE cell's E and N
CSR_FULL = dict(e=140_800, n=141_313)
# merge_topk at a k the old [R, R, S] comparison could not hold (R = k + B)
MERGE = dict(k=4400, batch=64, width=2050)
MERGE_PEAK_BYTES = 2 * 2**30
# the dtypes that phase 6 drives each kernel in (the DLRM table is fp32)
COWORK_DTYPES = {"segment_matmul": ("fp32", "bf16"),
                 "embedding_bag": ("fp32",),
                 "flash_attention": ("fp32", "bf16")}
# max |kernel - plain| allowed: segment sums differ only in the order of
# their fp32 adds, the gather is a copy, attention as in
# tests/test_kernels.py::test_flash_attention_kernel (rtol = atol)
TOLERANCE = {"segment_matmul": {"fp32": 1e-4, "bf16": 1e-4},
             "embedding_bag": {"fp32": 0.0, "bf16": 0.0},
             "flash_attention": {"fp32": 2e-4, "bf16": 3e-2}}
# attention also per head: ||kernel - plain||_F / ||plain||_F.  In long
# causal rows the outputs are smaller than the 3e-2 above, so that limit
# alone would pass a kernel that drops a k/v tile or misses a rescale;
# rounding p to bf16 before the P·V product, as the kernel does, leaves
# about 1e-3 of it
FLASH_REL_TOLERANCE = {"fp32": 1e-4, "bf16": 1e-2}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median time of ``fn()`` on the card, CUDA events around each call."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def queued_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Median time of ``fn()``'s device work alone: a spin kernel queued
    ahead of the start event keeps the card busy while the host enqueues
    ``fn``, so the events read its kernels back to back and not the host's
    enqueue (which :func:`cuda_ms` reads too where the call is shorter
    than its enqueue).  A rep whose enqueue outlasted the spin (a host
    that stalled: its events may have read the enqueue) is dropped and
    timed again behind a spin twice as long; fails if an enqueue still
    outlasts a spin of ``SPIN_GROWTH_MAX`` times the first."""
    import torch
    for _ in range(warmup):
        fn()

    def spin_ms_of(cycles: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    cycles = SPIN_CYCLES
    spin_ms = spin_ms_of(cycles)
    times = []
    while len(times) < reps:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        host_ms = 1e3 * (time.perf_counter() - t0)
        end.synchronize()
        if host_ms <= 0.8 * spin_ms:
            times.append(start.elapsed_time(end))
            continue
        if cycles >= SPIN_CYCLES * SPIN_GROWTH_MAX:
            fail(f"queued_ms: the enqueue took {host_ms:.3f} ms, the spin "
                 f"ahead of it {spin_ms:.3f} ms")
        print(f"[timing] queued_ms: an enqueue took {host_ms:.3f} ms behind "
              f"a spin of {spin_ms:.3f} ms; that rep is timed again behind "
              f"a spin twice as long")
        cycles *= 2
        spin_ms = spin_ms_of(cycles)
    return statistics.median(times)


def ptxas_report(log: str) -> dict:
    """{kernel (mangled name): (registers, spill bytes)} from the
    ``ptxas -v`` lines of a build log."""
    out, name = {}, None
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '([^']+)'", line)
        if found:
            name = found.group(1)
            out[name] = [0, 0]
        elif name and "spill stores" in line:
            out[name][1] = sum(int(x) for x in re.findall(
                r"(\d+) bytes spill (?:stores|loads)", line))
        elif name and "Used" in line and "registers" in line:
            out[name][0] = int(re.search(r"Used (\d+) registers",
                                         line).group(1))
    return {k: tuple(v) for k, v in out.items()}


def sass_counts(lib: Path, opcodes) -> dict:
    """{kernel (mangled name): {opcode: count}}: how many instructions of
    each opcode the SASS of each of the library's kernels holds."""
    from repro_torch.kernels import build
    tool = shutil.which("cuobjdump") or str(
        Path(build.nvcc()).parent / "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    out, name = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            name = found.group(1)
            out[name] = dict.fromkeys(opcodes, 0)
        elif name:
            for op in opcodes:
                out[name][op] += len(re.findall(rf"\b{op}\b", line))
    return out


# the attention kernels by dtype, and the template argument (row width DP)
# that follows each one's name in its mangled form
FLASH_KERNELS = {"bf16": "flash_attention_wgmma_kernelILi",
                 "fp32": "flash_attention_tf32_kernelILi"}


def check_flash_build(log: str) -> None:
    """Both attention kernels run on wgmma fed by TMA, and the ones the
    Llama shape takes (DP = 128) keep their registers: fails otherwise."""
    from repro_torch.kernels import build
    sass = sass_counts(build.library_path("flash_attention"),
                       ("HGMMA", "UTMALDG"))
    kernels = ptxas_report(log)
    found = {}                          # (dtype, DP) -> (regs, spill, sass)
    for name, rep in kernels.items():
        for dt, stem in FLASH_KERNELS.items():
            if stem in name:
                dp = int(re.search(rf"{stem}(\d+)E", name).group(1))
                found[dt, dp] = (*rep, sass.get(name, {}))
    total = {op: sum(c[op] for c in sass.values())
             for op in ("HGMMA", "UTMALDG")}
    print(f"[1 env] flash_attention SASS: HGMMA={total['HGMMA']} "
          f"UTMALDG={total['UTMALDG']}; " + "; ".join(
              f"{dt} DP={dp}: {regs} registers, {spill} spill bytes, "
              f"HGMMA={ops.get('HGMMA')} UTMALDG={ops.get('UTMALDG')}"
              for (dt, dp), (regs, spill, ops) in sorted(found.items())))
    for dt in FLASH_KERNELS:
        if (dt, 128) not in found:
            fail(f"no ptxas report for the {dt} DP=128 attention kernel")
        if found[dt, 128][1]:
            fail(f"the {dt} DP=128 attention kernel spills "
                 f"{found[dt, 128][1]} bytes")
    for (dt, dp), (_, _, ops) in found.items():
        if not ops.get("HGMMA") or not ops.get("UTMALDG"):
            fail(f"the {dt} DP={dp} attention kernel's SASS has no wgmma or "
                 f"no TMA load: {ops}")


def check_mma_build(log: str) -> None:
    """Each instance of masked_intersect's tensor-core kernel runs on the
    1-bit wgmma (``BGMMA`` in its SASS) and ``ptxas`` did not serialize
    its wgmmas: fails otherwise."""
    from repro_torch.kernels import build
    sass = sass_counts(build.library_path("masked_intersect"), ("BGMMA",))
    regs = ptxas_report(log)
    found = {}                  # VEC -> (registers, spills, BGMMA)
    for name, ops in sass.items():
        if MI_MMA_KERNEL in name:
            vec = re.search(r"ILb(\d)E", name).group(1) == "1"
            found[vec] = (*regs.get(name, ("?", "?")), ops["BGMMA"])
    serialized = [line for line in log.splitlines()
                  if "serialized" in line and MI_MMA_KERNEL in line]
    print("[1 env] masked_intersect mma SASS: " + "; ".join(
        f"VEC={vec}: {r} registers, {sp} spill bytes, BGMMA={n}"
        for vec, (r, sp, n) in sorted(found.items())) +
        f"; ptxas serialization warnings: {len(serialized)}")
    if not found:
        fail("no masked_intersect_kernel_mma in the library's SASS")
    for key, (_, _, n) in found.items():
        if not n:
            fail(f"the mma kernel (VEC = {key}): no BGMMA (1-bit wgmma) "
                 f"in its SASS")
    if serialized:
        fail(f"ptxas serialized the mma kernel's wgmmas: {serialized[0]}")


def phase_environment():
    import torch
    from repro_torch.kernels import build
    smi = nvidia_smi("name,power.limit")
    print(smi)
    name = torch.cuda.get_device_name(0)
    props = torch.cuda.get_device_properties(0)
    max_clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    t0 = time.perf_counter()
    report = build.build_all()
    build_s = time.perf_counter() - t0
    print(f"[1 env] device={name!r} count={torch.cuda.device_count()} "
          f"sms={props.multi_processor_count} max_sm_clock={max_clock_mhz} MHz "
          f"torch={torch.__version__} cuda={torch.version.cuda} "
          f"build={build_s:.2f}s kernels={sorted(report)}")
    for kname, rep in report.items():
        if kname == "flash_attention":
            continue            # check_flash_build prints its own line
        for kernel, (regs, spill) in ptxas_report(rep["log"]).items():
            print(f"  ptxas {kname} {kernel}: {regs} registers, "
                  f"{spill} spill bytes")
    check_flash_build(report["flash_attention"]["log"])
    check_mma_build(report["masked_intersect"]["log"])
    return dict(name=name, smi=smi, sms=props.multi_processor_count,
                clock_hz=max_clock_mhz * 1e6)


def masked_intersect_bound_ms(b: int, n: int, w: int, masked: bool):
    """Least time for one call: its operands read once and its counts
    written once, over the HBM rate.  The operations set no larger
    figure: the mma kernel's 1-bit wgmma has no published rate and runs
    at about 8x the int8 one (``scripts/mi_ceilings.py``), so their time
    at a published peak (:func:`int8_ops_ms`) is no least time."""
    return 1e3 * 4 * (b * w * (2 if masked else 1) + n * w + b * n) \
        / HBM_BYTES_PER_S, "bytes"


def int8_ops_ms(b: int, n: int, w: int) -> float:
    """The 2 B N K operations of the 0/1 product over K = 32 W bits at the
    card's dense int8 tensor-core rate, the narrowest type the data sheet
    rates: printed beside the mma kernel's time, not its bound (the 1-bit
    wgmma it runs on beats it)."""
    return 1e3 * 2 * b * n * 32 * w / PEAK_FLOPS["int8"]


def popc_bound_ms(b: int, n: int, w: int, env: dict) -> float:
    """The B N W word popcounts over the CUDA cores' popcount rate: the
    bound of the tile, which counts on them."""
    return 1e3 * b * n * w / (POPC_PER_CLOCK_PER_SM * env["sms"]
                              * env["clock_hz"])


def zero_one_bytes(words):
    """[R, W] int32 words as [R, 32 W] int8 0/1 bytes (bit j of word w at
    32 w + j), in chunks of rows."""
    import torch
    shifts = torch.arange(32, device=words.device, dtype=torch.int32)
    out = torch.empty((words.shape[0], 32 * words.shape[1]),
                      dtype=torch.int8, device=words.device)
    for r in range(0, words.shape[0], 2048):
        bits = (words[r:r + 2048, :, None] >> shifts) & 1
        out[r:r + 2048] = bits.reshape(bits.shape[0], -1)
    return out


def check_mi(what: str, a, cols, mask, want=None):
    """The planned call and the three kernels forced (the mma kernel and
    the row kernel as :func:`mma_plan` and :func:`rows_plan` would run
    them, and the tile) exactly equal to the plain version; returns the
    plan."""
    import torch
    from repro_torch.kernels import masked_intersect as mi
    if want is None:
        want = mi.masked_intersect_plain(a, cols, mask)
    n, w = cols.shape
    operands = (a, cols) if mask is None else (a, cols, mask)
    aligned = mi._aligned(*operands)
    planned = mi._plan(n, w, aligned)
    for plan in (None, mi.mma_plan(w, aligned), mi.TILE,
                 mi.rows_plan(n, w, aligned)):
        got = mi.masked_intersect(a, cols, mask, plan=plan)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        if err:
            fail(f"masked_intersect {what} {plan or planned}: max abs err "
                 f"{err}")
    return planned


def main_shape_kernels(env: dict, words) -> dict:
    """masked_intersect at the main path's shape: the planned call (the
    mma kernel) and the tile exact on random and all-ones words, masked
    and not, timed beside the plain version, the bytes bound, the int8
    operations' time, the popcount bound and ``torch._int_mm`` on the
    words as 0/1 bytes; then the mma kernel past 65,535 row tiles.  Returns the mask-free record."""
    import torch
    from repro_torch.kernels import masked_intersect as mi
    b, n, w = MAIN_SHAPE
    record = None
    for masked in (False, True):
        for fill in ("random", "all-ones"):
            if fill == "random":
                a, cols = words(b, w), words(n, w)
                mask = words(b, w) if masked else None
            else:
                a = torch.full((b, w), -1, dtype=torch.int32, device="cuda")
                cols = torch.full((n, w), -1, dtype=torch.int32,
                                  device="cuda")
                mask = a.clone() if masked else None
            want = torch.full((b, n), 32 * w, dtype=torch.int32,
                              device="cuda") if fill == "all-ones" \
                else mi.masked_intersect_plain(a, cols, mask)
            planned = mi._plan(n, w, True)
            for plan in (None, mi.TILE):
                got = mi.masked_intersect(a, cols, mask, plan=plan)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    fail(f"masked_intersect B={b} N={n} W={w} mask={masked} "
                         f"{fill} {plan or planned}: differs from its plain "
                         f"version")
            line = (f"[2 kernel] masked_intersect B={b} N={n} W={w} "
                    f"mask={masked} {fill}: exact ({planned.variant} planned "
                    f"and the tile)")
            if fill == "random":
                ms = queued_ms(lambda: mi.masked_intersect(a, cols, mask))
                tile_ms = queued_ms(
                    lambda: mi.masked_intersect(a, cols, mask, plan=mi.TILE))
                # from an idle card, the host's enqueue in it (as earlier
                # records of this shape were timed)
                call_ms = cuda_ms(
                    lambda: mi.masked_intersect(a, cols, mask), 20)
                plain_ms = cuda_ms(
                    lambda: mi.masked_intersect_plain(a, cols, mask), 3, 1)
                bound_ms, bound_by = masked_intersect_bound_ms(b, n, w,
                                                               masked)
                popc_ms = popc_bound_ms(b, n, w, env)
                # the yardstick: one int8 product of the 0/1 bytes
                rows = zero_one_bytes(a if mask is None else a & mask)
                cols8 = zero_one_bytes(cols)
                int_mm = torch._int_mm(rows, cols8.t())
                if not torch.equal(int_mm, want):
                    fail("torch._int_mm of the 0/1 bytes differs from the "
                         "plain version")
                int8_mm_ms = queued_ms(
                    lambda: torch._int_mm(rows, cols8.t()))
                del rows, cols8, int_mm
                line += (f" ms={ms:.4f} tile_ms={tile_ms:.4f} "
                         f"call_ms={call_ms:.4f} "
                         f"plain_ms={plain_ms:.3f} bound_ms={bound_ms:.4f} "
                         f"({bound_by}) int8_ops_ms={int8_ops_ms(b, n, w):.4f}"
                         f" popc_bound_ms={popc_ms:.4f} "
                         f"int8_mm_ms={int8_mm_ms:.4f} library_ms=null "
                         f"({env['smi']})")
                if not masked:      # the main path calls the mask-free form
                    record = dict(kernel=MI_MMA_KERNEL, variant="mma",
                                  ms=ms, tile_ms=tile_ms, call_ms=call_ms,
                                  plain_ms=plain_ms,
                                  bound_ms=bound_ms, bound_by=bound_by,
                                  int8_mm_ms=int8_mm_ms)
                else:
                    record["masked_ms"] = ms
                    record["masked_tile_ms"] = tile_ms
                if ms >= tile_ms:
                    fail(f"masked_intersect B={b} N={n} W={w} mask={masked}:"
                         f" the planned {planned.variant} kernel "
                         f"({ms:.4f} ms) is not faster than the tile "
                         f"({tile_ms:.4f} ms)")
            print(line)
    # more row tiles of 64 than one grid dimension holds, on the mma kernel
    b, n, w = TALL_MMA_SHAPE
    a, cols = words(b, w), words(n, w)
    want = mi.masked_intersect_plain(a, cols)
    got = mi.masked_intersect(a, cols, plan=mi.mma_plan(w, True))
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"masked_intersect B={b} N={n} W={w} (mma): differs from its "
             f"plain version")
    print(f"[2 kernel] masked_intersect B={b} N={n} W={w}: exact (mma, "
          f"{-(-b // 64)} row tiles in one grid)")
    return record


def phase_kernels(env: dict) -> dict:
    import numpy as np
    import torch
    from repro_torch.kernels import masked_intersect as mi

    rng = np.random.default_rng(0)

    def words(*shape):
        x = rng.integers(0, 2 ** 32, shape, dtype=np.uint32)
        return torch.from_numpy(x.view(np.int32)).cuda()

    for (b, n, w) in RAGGED_SHAPES:
        for masked in (False, True):
            a, cols = words(b, w), words(n, w)
            mask = words(b, w) if masked else None
            planned = check_mi(f"B={b} N={n} W={w} mask={masked}", a, cols,
                               mask)
            print(f"[2 kernel] masked_intersect B={b} N={n} W={w} "
                  f"mask={masked}: exact ({planned.variant} planned, all "
                  f"three kernels)")
    record = main_shape_kernels(env, words)
    # the pattern probe's shapes: masked, one all-ones column; each also
    # from operands one word past a 16-byte boundary (one word a load)
    record["pattern_probes"] = []
    for (b, n, w) in PROBE_SHAPES + (TALL_SHAPE,):
        store = words(2 * b * w + 1)
        a, mask = store[:b * w].view(b, w), store[b * w:2 * b * w].view(b, w)
        cols = torch.full((n, w), -1, dtype=torch.int32, device="cuda")
        want = mi.masked_intersect_plain(a, cols, mask)
        planned = check_mi(f"B={b} N={n} W={w} (probe)", a, cols, mask, want)
        shifted = store[1:b * w + 1].view(b, w)
        shifted_want = mi.masked_intersect_plain(shifted, cols, mask)
        check_mi(f"B={b} N={n} W={w} (probe, misaligned)", shifted, cols,
                 mask, shifted_want)
        line = f"[2 kernel] masked_intersect B={b} N={n} W={w} mask=True " \
               f"(pattern probe): exact, all three kernels, aligned and " \
               f"one word off ({planned})"
        if (b, n, w) in TIMED_PROBE_SHAPES:
            ms = queued_ms(lambda: mi.masked_intersect(a, cols, mask))
            tile_ms = queued_ms(
                lambda: mi.masked_intersect(a, cols, mask, plan=mi.TILE))
            plain_ms = queued_ms(
                lambda: mi.masked_intersect_plain(a, cols, mask))
            call_ms = cuda_ms(lambda: mi.masked_intersect(a, cols, mask), 20)
            tile_call_ms = cuda_ms(
                lambda: mi.masked_intersect(a, cols, mask, plan=mi.TILE), 20)
            bound_ms, bound_by = masked_intersect_bound_ms(b, n, w, True)
            line += (f" ms={ms:.4f} tile_ms={tile_ms:.4f} "
                     f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} "
                     f"({bound_by}) library_ms=null; from an idle card "
                     f"(host enqueue included) call_ms={call_ms:.4f} "
                     f"tile_call_ms={tile_call_ms:.4f}")
            record["pattern_probes"].append(dict(
                shape=[b, n, w], kernel=planned.variant, max_abs_err=0,
                ms=ms, tile_ms=tile_ms, plain_ms=plain_ms, call_ms=call_ms,
                tile_call_ms=tile_call_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None))
            if ms > plain_ms:
                fail(f"masked_intersect B={b} N={n} W={w} (probe): "
                     f"{ms:.4f} ms, slower than its plain version "
                     f"({plain_ms:.4f} ms)")
        print(line)
    # the cut-over: both kernels at each N, exact and timed
    record["cutover"] = []
    b, w = PROBE_SHAPE[0], PROBE_SHAPE[2]
    a, mask = words(b, w), words(b, w)
    for n in CUTOVER_SWEEP:
        cols = words(n, w)
        planned = check_mi(f"B={b} N={n} W={w} mask=True (sweep)", a, cols,
                           mask)
        rows = mi.rows_plan(n, w, True)
        rows_ms = queued_ms(
            lambda: mi.masked_intersect(a, cols, mask, plan=rows))
        mma_ms = queued_ms(lambda: mi.masked_intersect(
            a, cols, mask, plan=mi.mma_plan(w, True)))
        tile_ms = queued_ms(
            lambda: mi.masked_intersect(a, cols, mask, plan=mi.TILE))
        record["cutover"].append(dict(n=n, rows_ms=rows_ms, mma_ms=mma_ms,
                                      tile_ms=tile_ms))
        print(f"[2 kernel] masked_intersect B={b} N={n} W={w} mask=True "
              f"(cut-over sweep): exact, all three kernels; "
              f"rows_ms={rows_ms:.4f} mma_ms={mma_ms:.4f} "
              f"tile_ms={tile_ms:.4f} ({planned.variant} planned)")
    won = [c["n"] for c in record["cutover"]
           if c["rows_ms"] < min(c["mma_ms"], c["tile_ms"])]
    print(f"[2 kernel] masked_intersect cut-over: the row kernel is faster "
          f"than both others at N in {won}; the plan takes it up to N = "
          f"{mi.ROWS_MAX_COLS}")
    record["rows_max_cols"] = mi.ROWS_MAX_COLS
    record["max_abs_err"] = 0
    return record


def children_inputs(rng, b: int, m: int, n: int, w: int, pattern: str):
    """clique_children's operands on the card: random words for the batch
    (sizes included, so that ``|V| + 1`` also wraps) and the ext rows,
    parents and vertices at random with the bit-31 vertices first, and
    ``valid`` by ``pattern``: a leading ``prefix`` (the main path's
    layout), ``all``, ``none`` or ``random`` rows."""
    import numpy as np
    import torch

    def words(*shape):
        x = rng.integers(0, 2 ** 32, shape, dtype=np.uint32)
        return torch.from_numpy(x.view(np.int32)).cuda()
    action = rng.integers(0, n, m)
    high = np.arange(31, n, 32)[:m]
    action[:len(high)] = high
    prefix = CHILDREN_MAIN_VALID if (b, m, n, w) == CHILDREN_MAIN \
        else max(1, m // 3)
    valid = {"prefix": np.arange(m) < prefix, "all": np.ones(m, bool),
             "none": np.zeros(m, bool),
             "random": rng.random(m) < 0.3}[pattern]
    parent = rng.integers(0, b, m)
    return (words(b, 2 * w + 2), torch.from_numpy(parent).cuda(),
            torch.from_numpy(action).cuda(), torch.from_numpy(valid).cuda(),
            words(n, w))


def children_bound_ms(states, parent, action, valid, ext) -> float:
    """Least time for one clique_children call: the ``[M, S]`` block
    written once, ``valid`` read once, and each valid row's parent and
    vertex, its parent's row (V, P, ``|V|``) and its ext row read once,
    over the HBM rate."""
    m, s = parent.shape[0], states.shape[1]
    w = ext.shape[1]
    rows = int(valid.sum())
    nbytes = 4 * m * s + m + rows * (16 + 4 * (2 * w + 1) + 4 * w)
    return 1e3 * nbytes / HBM_BYTES_PER_S


def check_clique_children(env: dict) -> dict:
    """clique_children against its plain version bit for bit, zero rows
    included: every pattern of valid rows at the ragged shapes, at this
    script's main path's and at the benchmark's; the calls of each shape, profiled together, put at most
    ``CHILDREN_MAX_OPS`` device operations a call and no memset on the
    card;
    then the kernel timed at the main path's shape beside its plain
    version and its bytes bound.  Returns the record."""
    import numpy as np
    import torch
    from repro_torch.kernels import clique_children as cc

    rng = np.random.default_rng(29)
    patterns = ("prefix", "all", "none", "random")
    counts = []
    for shape in CHILDREN_RAGGED + (CHILDREN_SMOKE, CHILDREN_MAIN):
        calls = []
        for pattern in patterns:
            args = children_inputs(rng, *shape, pattern)
            want = cc.clique_children_plain(*args)
            got = cc.clique_children(*args)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                rows = (got != want).any(dim=1).nonzero()[:5, 0].tolist()
                fail(f"clique_children (B, M, N, W)={shape} valid={pattern}: "
                     f"differs from its plain version (rows {rows} ...)")
            calls.append(args)
            del want, got

        def each_call():
            for args in calls:
                cc.clique_children(*args)
                torch.cuda.synchronize()
        # one profile over the four calls, each followed by a synchronize;
        # a profile that lost events (fewer than one a call, seen once on
        # the card) is taken again
        ops = device_ops(each_call)
        if len(ops) < len(calls):
            print(f"[2 kernel] clique_children {shape}: the profile showed "
                  f"{len(ops)} device operations for {len(calls)} calls; "
                  f"profiled again")
            ops = device_ops(each_call)
        called = sorted({name for _, name in ops})
        if not len(calls) <= len(ops) <= CHILDREN_MAX_OPS * len(calls) or \
                any(cat == "gpu_memset" for cat, _ in ops):
            fail(f"clique_children {shape}: {len(calls)} calls put "
                 f"{len(ops)} device operations on the card: {called}")
        counts.append(len(ops) / len(calls))
        print(f"[2 kernel] clique_children (B, M, N, W)={shape}: exact, "
              f"zero rows included, valid {'/'.join(patterns)}; "
              f"{len(ops)} device operations in {len(calls)} calls: "
              f"{called}")
    print(f"[2 kernel] clique_children: {sorted(set(counts))} device "
          f"operations a call, no memset (at most {CHILDREN_MAX_OPS} a "
          f"call)")
    record = dict(max_abs_err=0)
    for pattern in ("prefix", "all"):
        args = children_inputs(rng, *CHILDREN_MAIN, pattern)
        ms = queued_ms(lambda: cc.clique_children(*args))
        bound = children_bound_ms(*args)
        if pattern == "prefix":
            plain_ms = cuda_ms(lambda: cc.clique_children_plain(*args), 3, 1)
            record.update(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                          bound_by="bytes", call_ms=cuda_ms(
                              lambda: cc.clique_children(*args), 20))
        else:
            record.update(all_valid_ms=ms, all_valid_bound_ms=bound)
        print(f"[2 kernel] clique_children {CHILDREN_MAIN} valid={pattern}: "
              f"ms={ms:.4f} bound_ms={bound:.4f} (bytes, "
              f"{100 * bound / ms:.1f}%)"
              + (f" plain_ms={plain_ms:.3f} call_ms={record['call_ms']:.4f}"
                 if pattern == "prefix" else "") + f" ({env['smi']})")
    return record


def check_weighted_kernels(env: dict) -> dict:
    """The maximum-weight clique's two kernels against their plain
    versions, bit for bit: the weighted child rows (``clique_children``'s
    weighted form) at the ragged shapes and the benchmark's (B 64, M = N =
    46,336) with every pattern of valid rows, and the weighted scoring (one
    1-bit ``masked_intersect`` call over 8 weight planes x 64 rows) at the
    benchmark's shape, with DIMACS-W weights ((i mod 200) + 1) and random
    ones below 256; then each timed at the benchmark's shape beside its
    bytes bound (``nuribench/wroofline.py``'s formulas), and the scoring's
    1-bit kernel alone beside it.  Returns ``{"wchildren": record,
    "wscoring": record}``."""
    import numpy as np
    import torch
    from repro_torch.core import bitset
    from repro_torch.kernels import clique_children as cc
    from repro_torch.kernels import masked_intersect as mi
    from repro_torch.kernels import weighted_intersect as wi

    rng = np.random.default_rng(33)

    def weights_of(n, dimacs):
        w = (np.arange(n) % 200 + 1) if dimacs else rng.integers(1, 256, n)
        return torch.from_numpy(w.astype(np.int32)).cuda()
    for shape in CHILDREN_RAGGED + (CHILDREN_MAIN,):
        for pattern in ("prefix", "all", "none", "random"):
            states, parent, action, valid, ext = children_inputs(
                rng, *shape, pattern)
            wts = weights_of(shape[2], pattern != "random")
            args = (states, parent, action, valid, ext, wts)
            want = cc.weighted_clique_children_plain(*args)
            got = cc.weighted_clique_children(*args)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                rows = (got != want).any(dim=1).nonzero()[:5, 0].tolist()
                fail(f"weighted clique_children (B, M, N, W)={shape} "
                     f"valid={pattern}: differs from its plain version "
                     f"(rows {rows} ...)")
            del want, got
    print(f"[2 kernel] weighted clique_children: exact at "
          f"{CHILDREN_RAGGED + (CHILDREN_MAIN,)}, valid prefix/all/none/"
          f"random")
    b, m, n, w = CHILDREN_MAIN
    for dimacs in (False, True):       # the timings below take the last
        wts = weights_of(n, dimacs)
        planes = wi.weight_planes(wts.cpu().numpy(), "cuda")
        p_bits = bitset.to_tensor(bitset.from_bool(
            rng.random((b, n)) < 0.02), "cuda")
        ext = bitset.to_tensor(bitset.from_bool(
            rng.random((n, n)) < 0.001), "cuda")
        got = wi.weighted_intersect(p_bits, ext, planes)
        want = wi.weighted_intersect_plain(p_bits, ext, wts)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"weighted_intersect (B, N)={(b, n)} dimacs={dimacs}: "
                 f"differs from its plain version")
        k = int(planes.shape[0])
        print(f"[2 kernel] weighted_intersect (B, N, K)={(b, n, k)} "
              f"dimacs={dimacs}: exact (max {int(got.max())})")
    # timed at the benchmark's shape: DIMACS-W weights (8 planes)
    rows = (planes[:, None, :] & p_bits[None]).reshape(-1, w).contiguous()
    score_ms = queued_ms(lambda: wi.weighted_intersect(p_bits, ext, planes))
    kernel_ms = queued_ms(lambda: mi.masked_intersect(rows, ext))
    b64_ms = queued_ms(lambda: mi.masked_intersect(p_bits, ext))
    score_bound = 1e3 * (4 * (b * w + n * w + b * n) + 4 * n) / \
        HBM_BYTES_PER_S
    wscoring = dict(ms=score_ms, kernel_ms=kernel_ms, b64_kernel_ms=b64_ms,
                    bound_ms=score_bound, bound_by="bytes",
                    planes=int(planes.shape[0]), max_abs_err=0)
    print(f"[2 kernel] weighted_intersect (B, N, K)={(b, n, k)}: ms="
          f"{score_ms:.4f} (the 1-bit kernel over {rows.shape[0]} rows "
          f"{kernel_ms:.4f}; over the 64 rows alone {b64_ms:.4f}) bound_ms="
          f"{score_bound:.4f} (bytes, {100 * score_bound / kernel_ms:.1f}% "
          f"of the kernel) ({env['smi']})")
    wchildren = dict(max_abs_err=0)
    for pattern in ("prefix", "all"):
        states, parent, action, valid, ext = children_inputs(
            rng, *CHILDREN_MAIN, pattern)
        args = (states, parent, action, valid, ext, weights_of(n, True))
        ms = queued_ms(lambda: cc.weighted_clique_children(*args))
        bound = children_bound_ms(*args[:5])
        key = "" if pattern == "prefix" else "all_valid_"
        wchildren.update({f"{key}ms": ms, f"{key}bound_ms": bound})
        if pattern == "prefix":
            wchildren.update(
                bound_by="bytes", plain_ms=cuda_ms(
                    lambda: cc.weighted_clique_children_plain(*args), 3, 1),
                unweighted_ms=queued_ms(
                    lambda: cc.clique_children(*args[:5])))
        print(f"[2 kernel] weighted clique_children {CHILDREN_MAIN} valid="
              f"{pattern}: ms={ms:.4f} bound_ms={bound:.4f} (bytes, "
              f"{100 * bound / ms:.1f}%)" + (
                  f" plain_ms={wchildren['plain_ms']:.3f} unweighted_ms="
                  f"{wchildren['unweighted_ms']:.4f}"
                  if pattern == "prefix" else "") + f" ({env['smi']})")
    return dict(wchildren=wchildren, wscoring=wscoring)


def weighted_kernel_entries(weighted: dict, launches: dict) -> list:
    """The ``kernels`` line's entries of the weighted clique's kernels:
    ``check_weighted_kernels``' record, with the main path's launches."""
    return [dict(name="weighted_clique_children", route="cuda",
                 source="src/repro_torch/kernels/csrc/clique_children.cu",
                 replaces=None, library_ms=None, **weighted["wchildren"],
                 launches=launches["weighted_clique_children"]),
            dict(name="weighted_intersect", route="cuda",
                 source="src/repro_torch/kernels/csrc/masked_intersect.cu",
                 replaces=None, library_ms=None, **weighted["wscoring"],
                 launches=launches["weighted_intersect"])]


def phase_weighted_main_path() -> dict:
    """The maximum-weight clique's main path: the fused computation through
    ``Engine`` at the benchmark cell's width (``WEIGHTED_FULL_*``), the
    launch counters reset just before each run.  At T 1 each of the two
    weighted kernels must launch once a step; at T 16 once a pass launched
    (``min(T, steps left)`` a host read; the steps are the live passes),
    with T 1's answer and counters but ``host_syncs``.  The runs must spill, through the spill
    queue's page-locked rows (one set left idle in the process after
    them), and every result must be a clique whose weight is its key.
    Returns the T 1 run's launches of each kernel."""
    import numpy as np
    import torch
    from repro_torch.core import vpq
    from repro_torch.core.engine import Engine, EngineConfig
    from repro_torch.core.weighted_clique import \
        make_weighted_clique_computation
    from repro_torch.data.synthetic_graphs import densifying_graph
    from repro_torch.kernels import clique_children as cc
    from repro_torch.kernels import weighted_intersect as wi

    g = densifying_graph(**WEIGHTED_FULL_GRAPH)
    weights = np.arange(g.n) % 200 + 1
    comp = make_weighted_clique_computation(g, weights, device="cuda")
    budget = WEIGHTED_FULL_ENGINE["max_steps"]
    runs = {}
    for t in (1, MACRO_T):
        eng = Engine(comp, EngineConfig(**WEIGHTED_FULL_ENGINE,
                                        steps_per_sync=t))
        passes, step = [0], eng.step

        def counted(st, max_inner=None, t=t, step=step):
            passes[0] += min(t, max_inner or t)    # the passes it launches
            return step(st, max_inner)
        eng.step = counted
        torch.cuda.synchronize()
        cc.reset_launches()
        wi.reset_launches()
        t0 = time.perf_counter()
        res = eng.run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = dict(weighted_clique_children=cc.weighted_launches,
                        weighted_intersect=wi.launches,
                        clique_children=cc.launches)
        runs[t] = res, launches
        print(f"[4w weighted] N={g.n} T={t} steps={res.steps} "
              f"host_syncs={res.host_syncs} spilled={res.spilled} "
              f"refilled={res.refilled} late_pruned={res.late_pruned} "
              f"keys={[int(x) for x in res.result_keys[:4]]}... "
              f"wall={wall_s:.3f}s ms_per_step={1e3 * wall_s / res.steps:.3f}"
              f" launches={launches}")
        passes = passes[0]
        if res.steps != budget:
            fail(f"weighted T={t}: {res.steps} steps, the budget {budget}")
        if launches != dict(weighted_clique_children=passes,
                            weighted_intersect=passes, clique_children=0):
            fail(f"weighted T={t}: launches {launches} in {passes} passes "
                 f"({res.steps} steps)")
        if not res.spilled or len(vpq._IDLE) != 1:
            fail(f"weighted T={t}: spilled {res.spilled}, {len(vpq._IDLE)} "
                 f"idle sets of page-locked rows (one expected)")
    same_run(f"weighted T={MACRO_T} against T=1", runs[MACRO_T][0], runs[1][0],
             counters=[c for c in COUNTERS if c != "host_syncs"])
    res = runs[1][0]
    adj = np.asarray(g.adj_bits, np.uint32)
    for key, row in zip(res.result_keys, res.result_states):
        members = comp.describe(row)
        if int(weights[members].sum()) != int(key) or any(
                not adj[u, v >> 5] >> (v & 31) & 1
                for i, u in enumerate(members) for v in members[i + 1:]):
            fail(f"weighted result {members} (key {int(key)}) is not a "
                 f"clique of that weight")
    print(f"[4w weighted] {len(res.result_keys)} results, each a clique of "
          f"its key's weight; T={MACRO_T} equal to T=1")
    return runs[1][1]


def same_run(what: str, a, b, counters=COUNTERS) -> None:
    """Two engine results must agree byte for byte, and on ``counters``."""
    if a.result_keys.tobytes() != b.result_keys.tobytes() or \
            a.result_states.tobytes() != b.result_states.tobytes():
        fail(f"{what}: results differ")
    for name in counters:
        if getattr(a, name) != getattr(b, name):
            fail(f"{what}: {name} {getattr(a, name)} != {getattr(b, name)}")


def phase_quickstart_parity():
    import numpy as np
    from repro_torch.core.aggregate import topk_frequent_patterns
    from repro_torch.core.clique import make_clique_computation
    from repro_torch.core.engine import Engine, EngineConfig
    from repro_torch.core.exhaustive import nuri_np_clique_candidates
    from repro_torch.core.iso import build_iso_index, make_iso_computation
    from repro_torch.core.weighted_clique import (
        brute_force_max_weight_clique, make_weighted_clique_computation)
    from repro_torch.data.synthetic_graphs import (densifying_graph,
                                                   labeled_graph,
                                                   planted_clique_graph)
    from repro_torch.kernels import masked_intersect as mi

    g = planted_clique_graph(**QUICKSTART_GRAPH)
    cases = dict(QUICKSTART_CASES)
    cfg, want = QUICKSTART_CASES["spill_probe"]
    cases[f"spill_probe T={MACRO_T}"] = (dict(cfg, steps_per_sync=MACRO_T),
                                         want)
    for case, (cfg, want) in cases.items():
        res = {}
        for device in ("cuda", "cpu"):
            comp = make_clique_computation(g, device=device)
            res[device] = Engine(comp, EngineConfig(**cfg)).run()
        cu = res["cuda"]
        same_run(f"{case} cuda against cpu", cu, res["cpu"])
        got = {name: getattr(cu, name) for name in want}
        if got != want or list(cu.result_keys) != [9, 8, 8]:
            fail(f"{case}: counters {got} keys {list(cu.result_keys)}, "
                 f"reference {want} keys [9, 8, 8]")
        print(f"[3 parity] {case}: cuda == cpu byte for byte, keys "
              f"{[int(x) for x in cu.result_keys]}, counters {got}, "
              f"host_syncs {cu.host_syncs}")

    g = labeled_graph(**ISO_SMALL_GRAPH)
    index = {device: build_iso_index(g, 3, device=device)
             for device in ("cuda", "cpu")}
    if index["cuda"].tobytes() != index["cpu"].tobytes():
        fail("iso index: cuda and cpu differ")
    for t in (1, MACRO_T):
        res = {}
        for device in ("cuda", "cpu"):
            comp = make_iso_computation(g, *ISO_SMALL_QUERY, index[device],
                                        use_pallas=True, device=device)
            res[device] = Engine(comp, EngineConfig(
                **ISO_SMALL_CFG, steps_per_sync=t)).run()
        cu = res["cuda"]
        same_run(f"iso T={t} cuda against cpu", cu, res["cpu"])
        got = {name: getattr(cu, name) for name in ISO_SMALL_WANT}
        keys = [int(x) for x in cu.result_keys]
        if got != ISO_SMALL_WANT or keys != ISO_SMALL_KEYS:
            fail(f"iso T={t}: counters {got} keys {keys}, reference "
                 f"{ISO_SMALL_WANT} keys {ISO_SMALL_KEYS}")
        print(f"[3 parity] iso (masked kernel) T={t}: index and run cuda == "
              f"cpu byte for byte, keys {keys}, counters {got}, host_syncs "
              f"{cu.host_syncs}")

    # pattern mining on cuda, then on cpu in the same process (the device
    # bitsets are cached per device), on both probe paths
    g = labeled_graph(**PATTERN_SMALL_GRAPH)
    for use_pallas in (True, False):
        res = {}
        for device in ("cuda", "cpu"):
            mi.reset_launches()
            res[device] = topk_frequent_patterns(
                g, **PATTERN_SMALL, use_pallas=use_pallas, device=device)
            launches = mi.launches
            if device == "cuda" and launches != (
                    PATTERN_SMALL_PROBES if use_pallas else 0):
                fail(f"pattern use_pallas={use_pallas}: {launches} "
                     f"masked_intersect launches")
        for device, r in res.items():
            got = {f: getattr(r, f) for f in PATTERN_SMALL_WANT}
            if got != PATTERN_SMALL_WANT:
                fail(f"pattern use_pallas={use_pallas} on {device}: {got}, "
                     f"reference {PATTERN_SMALL_WANT}")
        print(f"[3 parity] pattern M=3 use_pallas={use_pallas}: cuda == cpu "
              f"== reference, supports "
              f"{[sup for sup, _ in res['cuda'].patterns]}, candidates "
              f"{res['cuda'].candidates}, masked_intersect launches on cuda "
              f"{PATTERN_SMALL_PROBES if use_pallas else 0}")

    g = densifying_graph(**WEIGHTED_GRAPH)
    weights = np.random.default_rng(WEIGHTED_GRAPH["seed"]).integers(
        1, 20, g.n)
    res, comps = {}, {}
    for device in ("cuda", "cpu"):
        comps[device] = make_weighted_clique_computation(g, weights,
                                                         device=device)
        res[device] = Engine(comps[device], EngineConfig(**WEIGHTED_CFG)).run()
    cu = res["cuda"]
    same_run("weighted clique cuda against cpu", cu, res["cpu"])
    got = {name: getattr(cu, name) for name in WEIGHTED_WANT}
    keys = [int(x) for x in cu.result_keys]
    members = comps["cuda"].describe(cu.result_states[0])
    oracle = brute_force_max_weight_clique(g, weights)
    if got != WEIGHTED_WANT or keys != WEIGHTED_KEYS or \
            members != WEIGHTED_MEMBERS or oracle != (keys[0], members):
        fail(f"weighted clique: counters {got} keys {keys} members "
             f"{members} (brute force {oracle}), reference {WEIGHTED_WANT} "
             f"keys {WEIGHTED_KEYS} members {WEIGHTED_MEMBERS}")
    print(f"[3 parity] weighted clique: cuda == cpu byte for byte == brute "
          f"force, keys {keys} members {members}, counters {got}")

    g = planted_clique_graph(**QUICKSTART_GRAPH)
    got = nuri_np_clique_candidates(g, max_candidates=2_000_000)
    if got != NURI_NP_WANT:
        fail(f"Nuri-NP on the quickstart graph: {got}, reference "
             f"{NURI_NP_WANT}")
    engine_candidates = QUICKSTART_CASES["quickstart"][1]["candidates"]
    print(f"[3 parity] Nuri-NP on the quickstart graph: {got} (reference "
          f"equal), {got['candidates'] / engine_candidates:.1f}x the "
          f"engine's candidates")


def phase_main_path() -> int:
    import numpy as np
    import torch
    from repro_torch.core.clique import make_clique_computation
    from repro_torch.core.engine import Engine, EngineConfig
    from repro_torch.data.synthetic_graphs import planted_clique_graph
    from repro_torch.kernels import clique_children as cc
    from repro_torch.kernels import masked_intersect as mi
    from repro_torch.obs import Observability, format_table

    t0 = time.perf_counter()
    g = planted_clique_graph(**FULL_GRAPH)
    comp = make_clique_computation(g, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    obs = Observability()
    eng = Engine(comp, EngineConfig(**FULL_ENGINE, observe=True,
                                    observability=obs))
    torch.cuda.reset_peak_memory_stats()

    mi.reset_launches()
    cc.reset_launches()
    t0 = time.perf_counter()
    res = eng.run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = mi.launches
    if mi.launches_by_variant != {"mma": launches, "tile": 0, "rows": 0}:
        fail(f"the main path's launches by kernel: {mi.launches_by_variant}; "
             f"its N = {g.n} columns take the mma kernel")

    members = np.random.default_rng(FULL_GRAPH["seed"]).choice(
        FULL_GRAPH["n"], FULL_GRAPH["clique_size"], replace=False)
    best = comp.describe(res.result_states[0])
    counters = {name: getattr(res, name) for name in COUNTERS}
    print(f"[4 main] N={g.n} edges={g.num_edges} setup={setup_s:.2f}s "
          f"keys={[int(x) for x in res.result_keys]} {counters} "
          f"wall={wall_s:.3f}s ms_per_step={1e3 * wall_s / res.steps:.3f} "
          f"masked_intersect_launches={launches} "
          f"clique_children_launches={cc.launches} "
          f"peak_mem={torch.cuda.max_memory_allocated() / 2**30:.2f}GiB")
    print(f"[4 main] ms per step by span: {span_ms(obs, res.steps)}")
    print(format_table(obs.tracer.spans(), wall_s=wall_s))
    if int(res.result_keys[0]) != FULL_GRAPH["clique_size"]:
        fail(f"best clique size {int(res.result_keys[0])}, planted "
             f"{FULL_GRAPH['clique_size']}")
    if best != sorted(int(v) for v in members):
        fail(f"best clique {best} is not the planted one")
    if launches != res.steps:
        fail(f"masked_intersect launched {launches} times in "
             f"{res.steps} steps")
    if cc.launches != res.steps:
        fail(f"clique_children launched {cc.launches} times in {res.steps} "
             f"steps")
    return launches, cc.launches, comp, res, wall_s


def device_activity(e):
    """The chrome trace's category of one profiler event on the device
    (``kernel``, ``gpu_memcpy``, ``gpu_memset``), or None for an event on
    the host or a user annotation.  Copies and sets are told by the names
    the profiler gives them ("Memcpy HtoD (Pageable -> Device)", "Memset
    (Device)"); the events carry no category in every torch release."""
    from torch.autograd import DeviceType
    if e.device_type() != DeviceType.CUDA or \
            getattr(e, "is_user_annotation", lambda: False)():
        return None
    name = e.name()
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    return "gpu_memset" if name.startswith("Memset") else "kernel"


def device_busy(prof):
    """Device time from a finished profiler's events: the union of kernel,
    copy and set intervals (s), the summed time of each kernel name (ms),
    and the number of launches of each kernel name (the full name).  Read
    from the profiler's own records, with no chrome-trace round trip
    (``scripts/trace_ab.py`` holds the two to each other)."""
    spans, by_name, counts = [], {}, {}
    for e in prof.profiler.kineto_results.events():
        cat = device_activity(e)
        if cat is None:
            continue
        start, dur = e.start_ns() / 1e3, e.duration_ns() / 1e3     # us
        spans.append((start, start + dur))
        if cat == "kernel":
            name = e.name()
            by_name[name[:60]] = by_name.get(name[:60], 0.0) + dur / 1e3
            counts[name] = counts.get(name, 0) + 1
        else:
            by_name[cat] = by_name.get(cat, 0.0) + dur / 1e3
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e6, by_name, counts


def profiled_run(eng, tag: str):
    """``eng.run()`` under torch.profiler: (result, wall s, device busy s,
    device ms by kernel name, launches by kernel name).  Prints the
    seconds the profiler takes after the run (its stop and the read of the
    device intervals), which no phase's timed run covers."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = eng.run()
        torch.cuda.synchronize()
        t_end = time.perf_counter()
    busy_s, by_name, counts = device_busy(prof)
    print(f"[{tag}] profiled rerun: the profiler's stop and the trace's "
          f"read took {time.perf_counter() - t_end:.2f}s after the run")
    return res, t_end - t0, busy_s, by_name, counts


def kernel_launches(counts: dict, stem: str) -> int:
    """Launches in a trace of the kernels whose name contains ``stem``."""
    return sum(n for name, n in counts.items() if stem in name)


def print_top(by_name: dict, steps: int) -> None:
    """The ten kernels (or copies) that took the most device time."""
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {ms:10.3f} ms  {ms / steps:8.4f} ms/step  {name}")


def phase_profile(comp, want) -> float:
    """The main path once more under torch.profiler: the device's busy and
    idle share of the run's wall time, and the kernels that take it.
    Returns the idle share."""
    from repro_torch.core.engine import Engine, EngineConfig

    res, wall_s, busy_s, by_name, counts = profiled_run(
        Engine(comp, EngineConfig(**FULL_ENGINE)), "5 profile")
    if res.result_states.tobytes() != want.result_states.tobytes() or \
            res.steps != want.steps:
        fail("the profiled run differs from the main-path run")
    idle = 1 - busy_s / wall_s
    print(f"[5 profile] wall={wall_s:.3f}s (profiler on) "
          f"device_busy={busy_s:.3f}s idle_share={idle:.3f} "
          f"steps={res.steps} masked_intersect launches in the trace="
          f"{kernel_launches(counts, MI_KERNEL)}")
    print_top(by_name, res.steps)
    return idle


def check_no_host_read(eng, tag: str) -> None:
    """One macro-step of ``eng`` (an ``Engine`` or a ``ShardedEngine`` at
    ``steps_per_sync`` = T > 1: every shard's inner steps, the exchanges
    and the votes) enqueued under CUDA sync debug mode "error": a host
    read between two of its inner steps (``.item()``, ``.tolist()``,
    ``.cpu()``, ``nonzero``, a mask index) raises there.  The run's own
    stats read comes after."""
    import torch
    st = eng.start()
    if hasattr(st, "vpqs"):          # a ShardedEngine's state
        queues = st.vpqs
        args = (st, eng.T, any(len(v) for v in queues))
        what = f" x {eng.shards} shards (K={eng.K})"
    else:
        queues, what = [st.vpq], ""
        args = (st.pool_states, st.pool_prio, st.pool_ub, st.result_states,
                st.result_keys, eng.T, len(st.vpq) > 0)
    torch.cuda.synchronize()
    try:
        torch.cuda.set_sync_debug_mode("error")
        eng._macro_impl(*args)
    except RuntimeError as err:
        fail(f"{tag}: a macro-step reads the device from the host: {err}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    for q in queues:
        q.close()
    print(f"[{tag}] one macro-step of {eng.T} inner steps{what} enqueued "
          f"with no host read (sync debug mode 'error')")


def span_ms(obs, steps: int) -> dict:
    """ms per step in each of the engine's spans."""
    from repro_torch.obs import aggregate
    agg = aggregate(obs.tracer.spans())
    return {name: round(1e3 * agg[name]["total_s"] / steps, 4)
            for name in ("engine.device_compute", "engine.host_sync",
                         "engine.spill", "engine.refill", "engine.rebalance")
            if name in agg}


def phase_macro_path(comp, want, idle_t1: float) -> dict:
    """Phase 4's path in macro-steps of ``MACRO_T``: the same answer and
    counters but ``host_syncs``; then a profiled rerun, the launches of
    the scoring kernel counted in its trace.  Returns the launch count and
    the run's result."""
    import torch
    from repro_torch.core.engine import Engine, EngineConfig
    from repro_torch.kernels import clique_children as cc
    from repro_torch.kernels import masked_intersect as mi
    from repro_torch.obs import Observability

    cfg = dict(FULL_ENGINE, steps_per_sync=MACRO_T)
    check_no_host_read(Engine(comp, EngineConfig(**cfg)), "8 macro")
    obs = Observability()
    eng = Engine(comp, EngineConfig(**cfg, observe=True, observability=obs))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mi.reset_launches()
    cc.reset_launches()
    t0 = time.perf_counter()
    res = eng.run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = mi.launches
    if cc.launches != launches:     # no-op steps too: one of each a pass
        fail(f"T={MACRO_T}: {cc.launches} clique_children launches, "
             f"{launches} masked_intersect launches")
    same_run(f"phase 8 (T={MACRO_T}) against phase 4 (T=1)", res, want,
             [c for c in COUNTERS if c != "host_syncs"])
    if not res.host_syncs < res.steps:
        fail(f"T={MACRO_T}: {res.host_syncs} host syncs in {res.steps} steps")
    print(f"[8 macro] T={MACRO_T}: keys={[int(x) for x in res.result_keys]} "
          f"equal to phase 4 with every counter but host_syncs; "
          f"steps={res.steps} host_syncs={res.host_syncs} (phase 4: "
          f"{want.host_syncs}) wall={wall_s:.3f}s "
          f"ms_per_step={1e3 * wall_s / res.steps:.3f} "
          f"masked_intersect_launches={launches} "
          f"no_op_steps={launches - res.steps} "
          f"peak_mem={torch.cuda.max_memory_allocated() / 2**30:.2f}GiB")
    print(f"[8 macro] ms per step by span: {span_ms(obs, res.steps)}")

    prof_res, wall_s, busy_s, by_name, counts = profiled_run(
        Engine(comp, EngineConfig(**cfg)), "8 macro")
    same_run("phase 8's profiled rerun", prof_res, res)
    traced = kernel_launches(counts, MI_KERNEL)
    print(f"[8 macro] profiled rerun: wall={wall_s:.3f}s (profiler on) "
          f"device_busy={busy_s:.3f}s idle_share={1 - busy_s / wall_s:.3f} "
          f"(phase 5, T=1: {idle_t1:.3f}) steps={res.steps} "
          f"{MI_KERNEL} launches in the trace={traced} "
          f"(no-op steps {traced - res.steps})")
    print_top(by_name, res.steps)
    if traced < res.steps:
        fail(f"the trace shows {traced} {MI_KERNEL} launches in "
             f"{res.steps} steps")
    return launches, res


def skewed_graph(gen_module, graph_store):
    """tests/test_distributed_engine.py's skewed graph: ``SKEWED_GRAPH``
    with a clique on ``SKEWED_CLIQUE`` (the hot subtree on shard 0)."""
    import numpy as np
    g = gen_module.densifying_graph(**SKEWED_GRAPH)
    extra = [(u, v) for i, u in enumerate(SKEWED_CLIQUE)
             for v in SKEWED_CLIQUE[i + 1:]]
    return graph_store.from_edges(
        g.n, np.concatenate([g.edge_array, np.array(extra, np.int64)]))


def phase_sharded(comp, want, env: dict) -> dict:
    """Phase 12: phase 4's path through ``ShardedEngine`` at each of
    ``SHARDED_FULL`` shards (T = 1), in this process: phase 4's answer
    byte for byte, ``masked_intersect`` launched once a shard a step,
    ``syncs == host_syncs == steps``; wall, ms a step, counters, per-shard
    lists, spans and peak memory; the last shard count once more under
    ``torch.profiler``.  Then the skewed case on ``cuda`` and
    ``cpu``: equal bytes, and the reference's counters and per-shard
    lists.  Returns the launches by path, and the results and walls by
    shard count."""
    from repro_torch.core import graph as graph_mod
    from repro_torch.core.clique import make_clique_computation
    from repro_torch.core.engine import EngineConfig
    from repro_torch.data import synthetic_graphs
    from repro_torch.distributed import ShardedEngine
    from repro_torch.obs import Observability

    card = env["smi"]
    launches, results, walls = {}, {}, {}
    for shards in SHARDED_FULL:
        obs = Observability()
        res, wall_s, n, peak = sharded_run(
            comp, dict(FULL_ENGINE, shards=shards), obs)
        tag = f"12 sharded x{shards}"
        same_run(f"phase 12 (x{shards}) against phase 4", res, want, ())
        if n != res.steps * shards:
            fail(f"{tag}: {n} masked_intersect launches in {res.steps} "
                 f"steps of {shards} shards")
        if not res.syncs == res.host_syncs == res.steps:
            fail(f"{tag}: syncs {res.syncs}, host_syncs {res.host_syncs}, "
                 f"steps {res.steps}")
        counters = {name: getattr(res, name) for name in COUNTERS}
        print(f"[{tag}] keys={[int(x) for x in res.result_keys]} equal to "
              f"phase 4 byte for byte; {counters} "
              f"rebalanced={res.rebalanced} wall={wall_s:.3f}s "
              f"ms_per_step={1e3 * wall_s / res.steps:.3f} "
              f"masked_intersect_launches={n} peak_mem={peak:.2f}GiB "
              f"({card})")
        print(f"[{tag}] per_shard={res.per_shard}")
        print(f"[{tag}] ms per step by span: {span_ms(obs, res.steps)}")
        launches[f"clique x{shards} T=1"] = n
        results[shards], walls[shards] = res, wall_s

    # the most shards once more under torch.profiler: idle share, the
    # kernels that take the device time, launches counted in the trace
    prof_res, wall_s, busy_s, by_name, counts = profiled_run(ShardedEngine(
        comp, EngineConfig(**FULL_ENGINE, shards=shards)), tag)
    same_run(f"phase 12's profiled rerun (x{shards})", prof_res, res,
             COUNTERS + ("rebalanced",))
    traced = kernel_launches(counts, MI_KERNEL)
    print(f"[{tag}] profiled rerun: wall={wall_s:.3f}s (profiler on) "
          f"device_busy={busy_s:.3f}s idle_share={1 - busy_s / wall_s:.3f} "
          f"steps={res.steps} {MI_KERNEL} launches in the trace={traced}")
    print_top(by_name, res.steps)
    if traced != res.steps * shards:
        fail(f"{tag}: the trace shows {traced} {MI_KERNEL} launches in "
             f"{res.steps} steps of {shards} shards")

    res = {}
    for device in ("cuda", "cpu"):
        g = skewed_graph(synthetic_graphs, graph_mod.GraphStore)
        res[device] = ShardedEngine(
            make_clique_computation(g, device=device),
            EngineConfig(**SKEWED_CFG)).run()
    cu = res["cuda"]
    same_run("skewed x2 cuda against cpu", cu, res["cpu"],
             COUNTERS + ("rebalanced",))
    got = {name: getattr(cu, name) for name in SKEWED_WANT}
    keys = [int(x) for x in cu.result_keys]
    if got != SKEWED_WANT or keys != SKEWED_KEYS or \
            cu.per_shard != SKEWED_PER_SHARD or \
            res["cpu"].per_shard != SKEWED_PER_SHARD:
        fail(f"skewed x2: counters {got} keys {keys} per_shard "
             f"{cu.per_shard}, reference {SKEWED_WANT} keys {SKEWED_KEYS} "
             f"per_shard {SKEWED_PER_SHARD}")
    print(f"[12 sharded] skewed x2: cuda == cpu byte for byte == "
          f"reference, keys {keys}, counters {got}, per_shard "
          f"{cu.per_shard}")
    return launches, results, walls


def sharded_run(comp, cfg: dict, obs=None):
    """One ``ShardedEngine(comp, EngineConfig(**cfg)).run()`` of a clique
    computation on the card, its peak memory its own: (result, wall s,
    ``masked_intersect`` launches, peak GiB).  Fails unless each shard's
    pass launched ``clique_children`` as often as ``masked_intersect``."""
    import torch
    from repro_torch.core.engine import EngineConfig
    from repro_torch.distributed import ShardedEngine
    from repro_torch.kernels import clique_children as cc
    from repro_torch.kernels import masked_intersect as mi
    eng = ShardedEngine(comp, EngineConfig(
        **cfg, observe=obs is not None, observability=obs))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mi.reset_launches()
    cc.reset_launches()
    t0 = time.perf_counter()
    res = eng.run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    if cc.launches != mi.launches:  # each shard's pass launches both
        fail(f"sharded {cfg}: {cc.launches} clique_children launches, "
             f"{mi.launches} masked_intersect launches")
    return res, wall_s, mi.launches, torch.cuda.max_memory_allocated() / 2**30


def check_macro_launches(tag: str, res, launches: int, shards: int,
                         T: int, K: int) -> int:
    """A macro-step enqueues ``t_cap`` = T inner steps (no budget cuts
    these runs), each one ``masked_intersect`` launch a shard, and runs
    one exchange a segment begun: launches must be ``shards x T x
    host_syncs`` and ``syncs`` ``ceil(steps / K)``.  Returns the no-op
    inner steps."""
    enqueued = T * res.host_syncs
    if launches != shards * enqueued:
        fail(f"{tag}: {launches} masked_intersect launches, {shards} shards "
             f"x {enqueued} enqueued inner steps")
    if res.syncs != -(-res.steps // K):
        fail(f"{tag}: syncs {res.syncs} in {res.steps} steps at K={K}")
    return enqueued - res.steps


def sharded_child(spec: dict) -> int:
    """``--sharded-run '<json>'``: phase 4's cell through ``ShardedEngine``
    at phase 4's config and the given fields (``shards``,
    ``steps_per_sync``, ``sync_every``), alone in this process: one JSON
    line of the wall, counters, launches, no-op inner steps, spans and
    peak memory beside the card.  It fails unless the planted clique is
    found."""
    from repro_torch.core.clique import make_clique_computation
    from repro_torch.data.synthetic_graphs import planted_clique_graph
    from repro_torch.obs import Observability

    comp = make_clique_computation(planted_clique_graph(**FULL_GRAPH),
                                   device="cuda")
    obs = Observability()
    res, wall_s, launches, peak = sharded_run(comp, dict(FULL_ENGINE, **spec),
                                              obs)
    if int(res.result_keys[0]) != FULL_GRAPH["clique_size"]:
        fail(f"--sharded-run {spec}: best clique size "
             f"{int(res.result_keys[0])}")
    T = max(1, spec.get("steps_per_sync", 1))
    print("SHARDED " + json.dumps(dict(
        spec=spec, card=nvidia_smi("name,power.limit"), wall_s=wall_s,
        ms_per_step=1e3 * wall_s / res.steps,
        counters={c: getattr(res, c) for c in COUNTERS + ("rebalanced",)},
        launches=launches, no_op_steps=T * res.host_syncs - res.steps,
        peak_gib=peak, spans=span_ms(obs, res.steps),
        per_shard=res.per_shard)), flush=True)
    return 0


def phase_sharded_macro(comp, want, want12: dict, env: dict) -> dict:
    """Phase 13: ``ShardedEngine`` in macro-steps with stale bounds.  (a)
    phase 4's cell at ``SHARDED_MACRO`` (2 shards, K = 1 and 4) and, where
    it is set, (b) ``SHARDED_MACRO_8``, T = ``MACRO_T``: phase 4's bytes,
    launches ``shards x T x host_syncs``, ``syncs == ceil(steps/K)``; at
    K = 1 phase 12's ``spilled`` and ``late_pruned`` and fewer host reads;
    wall, ms a step, no-op inner steps, counters, ``per_shard``, spans and
    peak memory; (b) once more under ``torch.profiler``.  (c) The
    reference's stale-bound sweep: each (shards, K) row byte for byte the
    port's single-device ``Engine``'s answer with the reference's
    counters.  (d) The skewed case with bound traces on ``cuda`` and
    ``cpu``: equal bytes, the reference's counters and per-shard lists,
    the bound used never above the fresh one.  Returns the launches by
    path and the results of (a) and (b) by ``(shards, K)``."""
    import gc
    import numpy as np
    import torch
    from repro_torch.core import graph as graph_mod
    from repro_torch.core.clique import make_clique_computation
    from repro_torch.core.engine import Engine, EngineConfig
    from repro_torch.data import synthetic_graphs
    from repro_torch.distributed import ShardedEngine
    from repro_torch.obs import Observability

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    card = env["smi"]
    check_no_host_read(ShardedEngine(comp, EngineConfig(
        **FULL_ENGINE, shards=2, steps_per_sync=MACRO_T, sync_every=4)),
        "13 stale")
    print(f"[13 stale] set-up (the cache's release, the no-host-read "
          f"check): {time.perf_counter() - t0:.2f}s")
    launches, results = {}, {}
    cells = SHARDED_MACRO + ((SHARDED_MACRO_8,) if SHARDED_MACRO_8 else ())
    for shards, K in cells:
        cfg = dict(FULL_ENGINE, shards=shards, steps_per_sync=MACRO_T,
                   sync_every=K)
        obs = Observability()
        res, wall_s, n, peak = sharded_run(comp, cfg, obs)
        tag = f"13 stale x{shards} K={K}"
        same_run(f"phase 13 (x{shards}, K={K}) against phase 4", res, want,
                 ())
        no_op = check_macro_launches(tag, res, n, shards, MACRO_T, K)
        counters = {name: getattr(res, name)
                    for name in COUNTERS + ("rebalanced",)}
        w12 = want12.get(shards)
        if K == 1 and w12 is not None:
            if not res.host_syncs < w12.host_syncs:
                fail(f"{tag}: host_syncs {res.host_syncs}, phase 12's "
                     f"{w12.host_syncs}")
            same_run(f"{tag} against phase 12", res, w12,
                     ("spilled", "late_pruned"))
        print(f"[{tag}] T={MACRO_T}: keys={[int(x) for x in res.result_keys]}"
              f" equal to phase 4 byte for byte; {counters} wall={wall_s:.3f}s"
              f" ms_per_step={1e3 * wall_s / res.steps:.3f} "
              f"masked_intersect_launches={n} no_op_inner_steps={no_op} "
              f"(launches - shards x steps = {n - shards * res.steps}) "
              f"peak_mem={peak:.2f}GiB ({card})")
        if w12 is not None:
            print(f"[{tag}] phase 12 (x{shards}, T=1): "
                  f"{ {c: getattr(w12, c) for c in counters} }")
        print(f"[{tag}] per_shard={res.per_shard}")
        print(f"[{tag}] ms per step by span: {span_ms(obs, res.steps)}")
        launches[f"clique x{shards} T={MACRO_T} K={K}"] = n
        results[shards, K] = res
    if SHARDED_MACRO_8:
        prof_res, wall_s, busy_s, by_name, counts = profiled_run(
            ShardedEngine(comp, EngineConfig(**cfg)), tag)
        same_run(f"phase 13's profiled rerun (x{shards}, K={K})", prof_res,
                 res, COUNTERS + ("rebalanced",))
        traced = kernel_launches(counts, MI_KERNEL)
        print(f"[{tag}] profiled rerun: wall={wall_s:.3f}s (profiler on) "
              f"device_busy={busy_s:.3f}s "
              f"idle_share={1 - busy_s / wall_s:.3f} steps={res.steps} "
              f"{MI_KERNEL} launches in the trace={traced}")
        print_top(by_name, res.steps)
        if traced != n:
            fail(f"{tag}: the trace shows {traced} {MI_KERNEL} launches, "
                 f"the run {n}")
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the reference's stale-bound sweep at its own size
    t0 = time.perf_counter()
    stale_comp = make_clique_computation(
        synthetic_graphs.decoy_trap_graph(**STALE_GRAPH), device="cuda")
    base = Engine(stale_comp, EngineConfig(**STALE_CFG)).run()
    if [int(x) for x in base.result_keys] != STALE_KEYS:
        fail(f"stale sweep: Engine's keys {list(base.result_keys)}, "
             f"reference {STALE_KEYS}")
    print(f"[13 stale sweep] decoy_trap_graph{tuple(STALE_GRAPH.values())} "
          f"Engine(T={STALE_CFG['steps_per_sync']}): keys {STALE_KEYS}, "
          f"{base.steps} steps (set-up and run "
          f"{time.perf_counter() - t0:.2f}s)")
    for shards in STALE_SHARDS:
        for K in STALE_KS:
            res, wall_s, n, peak = sharded_run(
                stale_comp, dict(STALE_CFG, shards=shards, sync_every=K))
            tag = f"13 stale sweep x{shards} K={K}"
            same_run(f"{tag} against the port's Engine", res, base, ())
            got = {c: getattr(res, c) for c in STALE_WANT[shards, K]}
            if got != STALE_WANT[shards, K]:
                fail(f"{tag}: {got}, reference {STALE_WANT[shards, K]}")
            no_op = check_macro_launches(tag, res, n, shards,
                                         STALE_CFG["steps_per_sync"], K)
            print(f"[{tag}] equal to Engine byte for byte, the reference's "
                  f"counters {got}; wall={wall_s:.3f}s "
                  f"ms_per_step={1e3 * wall_s / res.steps:.3f} "
                  f"masked_intersect_launches={n} no_op_inner_steps={no_op} "
                  f"peak_mem={peak:.3f}GiB")
            launches[f"stale sweep x{shards} K={K}"] = n
    del stale_comp

    # (d) the skewed case with bound traces, cuda against cpu
    res = {}
    for device in ("cuda", "cpu"):
        g = skewed_graph(synthetic_graphs, graph_mod.GraphStore)
        res[device] = ShardedEngine(
            make_clique_computation(g, device=device),
            EngineConfig(**SKEWED_CFG, **SKEWED_MACRO)).run()
    cu = res["cuda"]
    same_run("skewed x2 T=4 K=2 cuda against cpu", cu, res["cpu"],
             COUNTERS + ("rebalanced",))
    got = {name: getattr(cu, name) for name in SKEWED_MACRO_WANT}
    keys = [int(x) for x in cu.result_keys]
    if got != SKEWED_MACRO_WANT or keys != SKEWED_KEYS or \
            cu.per_shard != SKEWED_MACRO_PER_SHARD or \
            res["cpu"].per_shard != SKEWED_MACRO_PER_SHARD:
        fail(f"skewed x2 T=4 K=2: counters {got} keys {keys} per_shard "
             f"{cu.per_shard}, reference {SKEWED_MACRO_WANT} keys "
             f"{SKEWED_KEYS} per_shard {SKEWED_MACRO_PER_SHARD}")
    used = np.asarray(cu.per_shard["bound_used"])
    fresh = np.asarray(cu.per_shard["bound_fresh"])
    if used.shape != (2, cu.steps) or not (used <= fresh).all():
        fail(f"skewed x2 T=4 K=2: bound traces {used.tolist()} used, "
             f"{fresh.tolist()} fresh")
    print(f"[13 stale] skewed x2 T=4 K=2 with bound traces: cuda == cpu "
          f"byte for byte == reference, keys {keys}, counters {got}, "
          f"per_shard {cu.per_shard}; used <= fresh at every step")
    gc.collect()
    torch.cuda.empty_cache()
    return launches, results


def induced_4g(g, seed: int):
    """One induced embedding of the 4G query (``ISO_4G``: a triangle 1-2-3
    with 0 hanging on 1) in ``g``, found by numpy from ``seed``: the
    vertices in query order."""
    import numpy as np
    rng = np.random.default_rng(seed)
    for v1 in rng.permutation(g.n):
        nb1 = g.neighbors(v1)
        for v2 in nb1:
            for v3 in np.intersect1d(nb1, g.neighbors(v2)):
                for v0 in nb1:
                    if v0 not in (v2, v3) and not g.has_edge(v0, v2) and \
                            not g.has_edge(v0, v3):
                        return [int(v) for v in (v0, v1, v2, v3)]
    fail("the graph holds no induced 4G")


def check_embedding(g, q_edges, q_labels, mapping, key: int) -> None:
    """``mapping`` (data vertex per query vertex) is an induced,
    label-preserving embedding whose score (the sum of degrees) is
    ``key``; checked on the host with numpy."""
    import numpy as np
    nq = len(q_labels)
    if len(set(mapping)) != nq or min(mapping) < 0:
        fail(f"iso result {mapping} is not injective")
    if [int(g.labels[v]) for v in mapping] != list(q_labels):
        fail(f"iso result {mapping} has labels "
             f"{[int(g.labels[v]) for v in mapping]}, query {q_labels}")
    edges = {frozenset(e) for e in q_edges}
    for a in range(nq):
        for b in range(a + 1, nq):
            if g.has_edge(mapping[a], mapping[b]) != \
                    (frozenset((a, b)) in edges):
                fail(f"iso result {mapping} is not an induced 4G: edge "
                     f"({a}, {b})")
    if int(np.sum(g.degrees[mapping])) != key:
        fail(f"iso result {mapping}: degree sum "
             f"{int(np.sum(g.degrees[mapping]))}, key {key}")


def phase_iso(env: dict) -> dict:
    """Labeled isomorphism at full width: the masked kernel's path and the
    ``batched`` path, each at T = 1 and ``MACRO_T``, byte for byte alike;
    the best results checked on the host; the masked kernel timed at this
    path's call shape.  Returns the kernel path's launches and times, and
    (apart) its T = 1 result, the results as ``describe`` lists them and
    the query's labels."""
    import numpy as np
    import torch
    from repro_torch.core.bitset import eye_table, to_tensor
    from repro_torch.core.engine import Engine, EngineConfig
    from repro_torch.core.iso import build_iso_index, make_iso_computation
    from repro_torch.data.synthetic_graphs import labeled_graph
    from repro_torch.kernels import masked_intersect as mi
    from repro_torch.obs import Observability

    t0 = time.perf_counter()
    g = labeled_graph(**ISO_GRAPH)
    embedding = induced_4g(g, ISO_GRAPH["seed"])
    q_labels = [int(g.labels[v]) for v in embedding]
    graph_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    index = build_iso_index(g, ISO_HOPS, device="cuda")
    torch.cuda.synchronize()
    index_s = time.perf_counter() - t0
    print(f"[9 iso] N={g.n} edges={g.num_edges} labels={g.n_labels} "
          f"graph+query={graph_s:.2f}s index={index_s:.2f}s "
          f"index {index.shape}; 4G query labels {q_labels} from the "
          f"induced embedding {embedding}")

    runs, launches = {}, {}
    for path, kw in (("kernel", dict(use_pallas=True)), ("batched", {})):
        t0 = time.perf_counter()
        comp = make_iso_computation(g, ISO_4G, q_labels, index,
                                    device="cuda", **kw)
        torch.cuda.synchronize()
        comp_s = time.perf_counter() - t0
        for t in (1, MACRO_T):
            cfg = dict(ISO_ENGINE, steps_per_sync=t)
            if path == "kernel" and t > 1:
                check_no_host_read(Engine(comp, EngineConfig(**cfg)),
                                   "9 iso")
            obs = Observability()
            eng = Engine(comp, EngineConfig(**cfg, observe=True,
                                            observability=obs))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            mi.reset_launches()
            t0 = time.perf_counter()
            res = eng.run()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            runs[path, t] = res
            launches[path, t] = mi.launches
            print(f"[9 iso] {path} T={t}: keys="
                  f"{[int(x) for x in res.result_keys]} "
                  f"{ {c: getattr(res, c) for c in COUNTERS} } "
                  f"computation={comp_s:.2f}s wall={wall_s:.3f}s "
                  f"ms_per_step={1e3 * wall_s / max(1, res.steps):.3f} "
                  f"masked_intersect_launches={mi.launches} "
                  f"peak_mem={torch.cuda.max_memory_allocated() / 2**30:.2f}"
                  f"GiB; ms per step by span: {span_ms(obs, res.steps)}")
    first = runs["kernel", 1]
    for (path, t), res in runs.items():
        same_run(f"iso {path} T={t} against kernel T=1", res, first,
                 [c for c in COUNTERS if c != "host_syncs"])
        same_run(f"iso {path} T={t} against kernel T={t}", res,
                 runs["kernel", t])
        if path == "kernel" and launches[path, t] < res.steps:
            fail(f"iso kernel path T={t}: {launches[path, t]} "
                 f"masked_intersect launches in {res.steps} steps")
        if path == "batched" and launches[path, t]:
            fail(f"iso batched path T={t} launched masked_intersect")
    live = [(int(key), comp.describe(row)) for key, row in
            zip(first.result_keys, first.result_states) if key > -2 ** 31]
    if not live:
        fail("iso found no match, though the query was read off one")
    for key, mapping in live:
        check_embedding(g, ISO_4G, q_labels, mapping, key)
    print(f"[9 iso] four runs byte-equal (counters too; host_syncs between "
          f"equal T); results {live} are induced, label-preserving 4G "
          f"embeddings (numpy)")

    # the masked kernel at this path's call shape: B rows and row masks
    # against the eye_table columns
    rng = np.random.default_rng(2)
    b, n, w = ISO_ENGINE["batch"], g.n, (g.n + 31) // 32
    cols = to_tensor(eye_table(n), "cuda")
    rows, mask = (torch.from_numpy(rng.integers(0, 2 ** 32, (b, w),
                                                dtype=np.uint32)
                                   .view(np.int32)).cuda() for _ in range(2))
    if not torch.equal(mi.masked_intersect(rows, cols, mask),
                       mi.masked_intersect_plain(rows, cols, mask)):
        fail("masked_intersect at the iso shape differs from its plain "
             "version")
    ms = cuda_ms(lambda: mi.masked_intersect(rows, cols, mask), 20)
    tile_ms = cuda_ms(
        lambda: mi.masked_intersect(rows, cols, mask, plan=mi.TILE), 20)
    plain_ms = cuda_ms(lambda: mi.masked_intersect_plain(rows, cols, mask),
                       3, 1)
    bound, bound_by = masked_intersect_bound_ms(b, n, w, True)
    planned = mi._plan(n, w, True).variant
    print(f"[9 iso] masked_intersect (masked) B={b} N={n} W={w} against "
          f"eye_table columns: exact, ms={ms:.4f} ({planned}) "
          f"tile_ms={tile_ms:.4f} plain_ms={plain_ms:.3f} "
          f"bound_ms={bound:.4f} ({bound_by}) library_ms=null")
    return dict(launches=launches["kernel", 1], max_abs_err=0, ms=ms,
                tile_ms=tile_ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=bound_by, library_ms=None,
                launches_by_t={t: launches["kernel", t]
                               for t in (1, MACRO_T)}), \
        (first, [mapping for _, mapping in live], q_labels)


# a probe's host time, split by what it calls (probe_split)
PROBE_PARTS = ("bitsets", "upload", "gathers", "launch", "read", "other")
# the row kernel's name in a profiler trace (csrc/masked_intersect.cu)
MI_ROWS_KERNEL = "masked_intersect_kernel_rows"


@contextlib.contextmanager
def probe_split(patterns, probe_s: list, parts: dict):
    """Times every ``patterns._edge_probe`` call in the block on the host:
    appends its time to ``probe_s`` and adds its parts to ``parts``, by
    what it does: the cached device
    bitsets (``_device_bits``; the first probe of a graph builds them), the
    upload of the pairs (``from_numpy(...).to``), the two row gathers
    (``adj_d[up]``, ``eye_d[vp]``: indexing by a tensor), the kernel's
    wrapper (``ops.masked_intersect``: its checks, the output's allocation
    and the launch), the blocking read (``.cpu()``, ``.numpy()``: it waits
    for the gathers and the kernel) and every other torch call.  A torch
    function mode times the torch calls; what is left of a probe's time is
    numpy and Python.  Nothing of the port's module is edited: its two
    callees are swapped for timed ones while the block runs."""
    import torch
    from torch.overrides import TorchFunctionMode

    def part_of(func, args) -> str:
        if func in (torch.from_numpy, torch.Tensor.to):
            return "upload"
        if func is torch.Tensor.__getitem__ and \
                isinstance(args[1], torch.Tensor):
            return "gathers"
        if func in (torch.Tensor.cpu, torch.Tensor.numpy):
            return "read"
        return "other"

    class Split(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            t = time.perf_counter()
            out = func(*args, **(kwargs or {}))
            parts[part_of(func, args)] += time.perf_counter() - t
            return out

    def timed(part, fn):
        def call(*args, **kwargs):
            t = time.perf_counter()
            with torch._C.DisableTorchFunction():
                out = fn(*args, **kwargs)
            parts[part] += time.perf_counter() - t
            return out
        return call

    real_probe = patterns._edge_probe
    real_bits, real_mi = patterns._device_bits, patterns.kops.masked_intersect

    def probe(*args, **kwargs):
        t = time.perf_counter()
        with Split():
            out = real_probe(*args, **kwargs)
        probe_s.append(time.perf_counter() - t)
        return out

    patterns._edge_probe = probe
    patterns._device_bits = timed("bitsets", real_bits)
    patterns.kops.masked_intersect = timed("launch", real_mi)
    try:
        yield
    finally:
        patterns._edge_probe = real_probe
        patterns._device_bits = real_bits
        patterns.kops.masked_intersect = real_mi


def phase_patterns() -> dict:
    """Top-k pattern mining at full width on the kernel path: each cell of
    ``PATTERN_CELLS`` once, under torch.profiler, with every edge probe
    timed on the host (its kernel launch and its device->host read
    included) and split into its parts (:func:`probe_split`); the
    reference's answer and exactly its number of probes as
    ``masked_intersect`` launches, every one of them the row kernel.
    Returns the launches by cell."""
    import torch
    from repro_torch.core import patterns
    from repro_torch.core.aggregate import topk_frequent_patterns
    from repro_torch.data.synthetic_graphs import labeled_graph
    from repro_torch.kernels import masked_intersect as mi
    from torch.profiler import ProfilerActivity, profile

    launches = {}
    for cell, (graph, want, probes_want) in PATTERN_CELLS.items():
        t0 = time.perf_counter()
        g = labeled_graph(**graph)
        graph_s = time.perf_counter() - t0
        probe_s, parts = [], dict.fromkeys(PROBE_PARTS, 0.0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with probe_split(patterns, probe_s, parts), \
                profile(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA]) as prof:
            mi.reset_launches()
            patterns.reset_reads()
            t0 = time.perf_counter()
            res = topk_frequent_patterns(g, **PATTERN_M, use_pallas=True,
                                         device="cuda")
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            launches[cell], reads = mi.launches, patterns.reads
            by_variant = dict(mi.launches_by_variant)
        peak = torch.cuda.max_memory_allocated()
        busy_s, by_name, counts = device_busy(prof)
        kernel_ms = sum(ms for name, ms in by_name.items()
                        if MI_KERNEL in name)
        traced = kernel_launches(counts, MI_KERNEL)
        traced_rows = kernel_launches(counts, MI_ROWS_KERNEL)
        got = {f: getattr(res, f) for f in PATTERN_RESULT_FIELDS}
        n_probes = max(1, len(probe_s))
        print(f"[10 pattern] {cell}: N={g.n} edges={g.num_edges} "
              f"labels={g.n_labels} graph={graph_s:.2f}s "
              f"supports={[sup for sup, _ in res.patterns]} "
              f"candidates={res.candidates} "
              f"expanded={res.groups_expanded} pruned={res.groups_pruned} "
              f"completed={res.completed} wall={wall_s:.3f}s (profiler on) "
              f"probes={len(probe_s)} probe_host={sum(probe_s):.3f}s "
              f"(launch + read; max {1e3 * max(probe_s, default=0):.3f} ms) "
              f"kernel_device={kernel_ms:.3f} ms "
              f"({1e3 * kernel_ms / max(1, traced):.2f} us a launch, "
              f"{traced} in the trace, {traced_rows} of the row kernel) "
              f"device_busy={busy_s:.3f}s "
              f"idle_share={1 - busy_s / wall_s:.4f} "
              f"rest (host expansion)={wall_s - sum(probe_s):.3f}s "
              f"masked_intersect_launches={launches[cell]} {by_variant} "
              f"host_reads={reads} peak_mem={peak / 2**30:.2f}GiB")
        rest = sum(probe_s) - sum(parts.values())
        print(f"[10 pattern] {cell}: a probe's host time, summed s (ms a "
              f"probe): " + " ".join(
                  f"{k}={v:.4f} ({1e3 * v / n_probes:.4f})"
                  for k, v in parts.items()) +
              f" numpy+python={rest:.4f} ({1e3 * rest / n_probes:.4f})")
        if got != want:
            fail(f"{cell}: {got}, reference {want}")
        if not launches[cell] == reads == len(probe_s) == traced == \
                traced_rows == by_variant["rows"] == probes_want:
            fail(f"{cell}: {launches[cell]} masked_intersect launches "
                 f"({by_variant}; {traced} in the trace, {traced_rows} of "
                 f"the row kernel), {reads} host reads and {len(probe_s)} "
                 f"probes; the reference probes {probes_want} times")
        del g
    return launches


def torch_dtypes():
    import torch
    return {"fp32": torch.float32, "bf16": torch.bfloat16}


def bound_ms(nbytes: float, flops: float, peak: str):
    """Least time for one call: the bytes read once and written once over
    the HBM rate, or the operations over the card's peak for their type."""
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * flops / PEAK_FLOPS[peak]
    return max(bytes_ms, ops_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def errors(name: str, dt: str, got, want, what: str) -> dict:
    """Max |got - want|, and for attention the largest relative error of
    one head; fails beyond the kernel's tolerance (for attention
    |got - want| <= tol + tol * |want|, as assert_allclose reads it)."""
    import torch
    if got.shape != want.shape or got.dtype != torch.float32:
        fail(f"{name} {dt} {what}: got {got.dtype} {tuple(got.shape)}, "
             f"want float32 {tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        fail(f"{name} {dt} {what}: non-finite output")
    diff = (got - want).abs()
    tol = TOLERANCE[name][dt]
    limit = tol + tol * want.abs() if name == "flash_attention" else tol
    if bool((diff > limit).any()):
        fail(f"{name} {dt} {what}: max abs err {float(diff.max())} beyond "
             f"tolerance {tol}")
    out = {"max_abs_err": float(diff.max()) if diff.numel() else 0.0}
    if name == "flash_attention":
        rel = float(((got - want).flatten(1).norm(dim=1)
                     / want.flatten(1).norm(dim=1).clamp_min(1e-30)).max())
        if rel > FLASH_REL_TOLERANCE[dt]:
            fail(f"{name} {dt} {what}: relative err of a head {rel} beyond "
                 f"{FLASH_REL_TOLERANCE[dt]}")
        out["max_rel_err"] = rel
    return out


def fold(record: dict, errs: dict) -> None:
    """Keep the larger of each error in ``record``."""
    for key, err in errs.items():
        record[key] = max(record.get(key, 0.0), err)


def err_text(record: dict) -> str:
    text = f"max abs err {record['max_abs_err']:.3g}"
    if "max_rel_err" in record:
        text += f", of a head relative {record['max_rel_err']:.3g}"
    return text


def sage_batch(sampler, step: int):
    """One GraphSAGE sample on the card: node features, edge sources (for
    the message gather) and destinations."""
    import torch
    sub = sampler.sample(step)
    return (torch.from_numpy(sub.features).cuda(),
            torch.from_numpy(sub.edge_src).cuda().long(),
            torch.from_numpy(sub.edge_dst).cuda())


def same_bits(name: str, dt: str, a, b, what: str) -> None:
    """Two calls on the same inputs must agree bit for bit."""
    import torch
    if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
        fail(f"{name} {dt} {what}: two calls on the same inputs differ")


def check_csr(rng) -> None:
    """``segment_matmul``'s CSR build on the card (``csr_by_node``) equals
    ``edges_by_node`` bit for bit, ``order`` and ``ptr``, on random
    (some out of range) and sorted ``dst`` at every ragged shape, and on
    every edge on one node and every edge dropped at the GraphSAGE cell's
    size; then one ``segment_matmul`` call is one C call, with no sort or
    search and no host read (CUDA sync debug mode "error")."""
    import numpy as np
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import segment_matmul as sm

    cases = []
    for (e, n, _) in SEGMENT_RAGGED:
        dst = rng.integers(-1, n + 1, e, dtype=np.int32)
        cases += [(f"random E={e} N={n}", dst, n),
                  (f"sorted E={e} N={n}", np.sort(dst.clip(0, n - 1)), n)]
    e, n = CSR_FULL["e"], CSR_FULL["n"]
    cases += [(f"one node E={e} N={n}", np.full(e, n // 2, np.int32), n),
              (f"all dropped E={e} N={n}",
               rng.choice(np.array([-1, n, n + 5], np.int32), e), n)]
    for what, dst, n in cases:
        dst = torch.from_numpy(dst).cuda()
        order, ptr = sm.csr_by_node(dst, n)
        want_order, want_ptr = sm.edges_by_node(dst, n)
        if not (torch.equal(order, want_order) and torch.equal(ptr, want_ptr)):
            fail(f"csr_by_node {what}: differs from edges_by_node")
    print(f"[2 kernel] segment_matmul CSR (csr_by_node) == edges_by_node "
          f"bit for bit on {len(cases)} inputs: "
          f"{', '.join(what for what, _, _ in cases)}")

    msg = torch.ones((999, 13), device="cuda")
    dst = torch.from_numpy(rng.integers(-1, 78, 999, dtype=np.int32)).cuda()
    calls, real_launch = [], build.launch
    banned = ("sort", "argsort", "searchsorted", "where", "arange")
    saved = {name: getattr(torch, name) for name in banned}

    def refuse(name):
        def call(*args, **kwargs):
            raise AssertionError(f"torch.{name} on the CUDA path")
        return call

    def counting(*args):
        calls.append(args[0])
        return real_launch(*args)

    torch.cuda.synchronize()
    try:
        build.launch = counting
        for name in banned:
            setattr(torch, name, refuse(name))
        torch.cuda.set_sync_debug_mode("error")
        sm.segment_matmul(msg, dst, 77)
    except (AssertionError, RuntimeError) as err:
        fail(f"segment_matmul's CUDA path: {err}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
        for name, fn in saved.items():
            setattr(torch, name, fn)
        build.launch = real_launch
    if calls != ["segment_matmul"]:
        fail(f"one segment_matmul call made the C calls {calls}")
    print(f"[2 kernel] segment_matmul: one call = {len(calls)} C call, no "
          f"torch.{'/'.join(banned)}, no host read")
    check_segment_ops(rng)


# the most device operations one segment_matmul call may put on the card
SEGMENT_MAX_OPS = 2


def device_ops(call) -> list:
    """``call()`` alone under torch.profiler, followed by a synchronize:
    the device operations it put on the card, as (category, name)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    return [(device_activity(e), e.name()) for e in
            prof.profiler.kineto_results.events()
            if device_activity(e) is not None]


def check_segment_ops(rng) -> None:
    """``torch.profiler`` over each single ``segment_matmul`` call
    (one-element and 16-byte rows, fp32 and bf16, sorted and random
    ``dst``), one profile a call, followed by a synchronize: each puts at
    least one and at most ``SEGMENT_MAX_OPS`` device operations (kernels,
    copies, sets) on the card and no memset."""
    import numpy as np
    import torch
    from repro_torch.kernels import segment_matmul as sm

    calls = []
    for (e, n, d) in ((999, 77, 13), (5000, 3000, 256)):
        for dtype in torch_dtypes().values():
            dst = rng.integers(-1, n + 1, e, dtype=np.int32)
            for order in ("random", "sorted"):
                if order == "sorted":
                    dst = np.sort(dst.clip(0, n - 1))
                msg = torch.from_numpy(rng.standard_normal(
                    (e, d), np.float32)).cuda().to(dtype)
                calls.append((f"E={e} N={n} D={d} {dtype} {order}", msg,
                              torch.from_numpy(dst).cuda(), n))
    for _, msg, dst, n in calls:
        sm.segment_matmul(msg, dst, n)
    torch.cuda.synchronize()
    counts, names = [], set()
    for what, msg, dst, n in calls:
        ops = device_ops(lambda: sm.segment_matmul(msg, dst, n))
        sets = [name for cat, name in ops if cat == "gpu_memset"]
        called = sorted({name.split("<")[0].split("::")[-1]
                         for _, name in ops})
        if not ops:
            fail(f"segment_matmul {what}: the profiler showed no device "
                 f"operation")
        if sets or len(ops) > SEGMENT_MAX_OPS:
            fail(f"segment_matmul {what}: one call put {len(ops)} device "
                 f"operations ({len(sets)} memsets) on the card: {called}")
        counts.append(len(ops))
        names.update(called)
    print(f"[2 kernel] segment_matmul: {len(calls)} calls (one-element and "
          f"16-byte rows, fp32 and bf16, random and sorted dst), each "
          f"profiled alone, put {counts} device operations on the card, no "
          f"memset (at most {SEGMENT_MAX_OPS} a call): {sorted(names)}")


def phase_coworkload_kernels() -> dict:
    """Phase 2 for the co-workload kernels: ragged sweeps against the plain
    versions.  Returns {name: {dtype: errors}}."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops, ref

    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 matmul is on: the plain versions must run in full fp32")
    rng = np.random.default_rng(1)
    records = {name: {} for name in TOLERANCE}

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).cuda()

    check_csr(rng)
    for dt, dtype in torch_dtypes().items():
        # segment_matmul: random destinations, some outside [0, N)
        # (dropped), and the same sorted into range (the sorted-key path)
        rec = records["segment_matmul"][dt] = {}
        for (e, n, d) in SEGMENT_RAGGED:
            msg = normal(e, d).to(dtype)
            random = rng.integers(-1, n + 1, e, dtype=np.int32)
            for order, dst in (("random", random),
                               ("sorted", np.sort(random.clip(0, n - 1)))):
                what = f"E={e} N={n} D={d} {order}"
                dst = torch.from_numpy(dst).cuda()
                got = ops.segment_matmul(msg, dst, n)
                fold(rec, errors("segment_matmul", dt, got,
                                 ref.segment_matmul_ref(msg, dst, n), what))
                same_bits("segment_matmul", dt, got,
                          ops.segment_matmul(msg, dst, n), what)
        # embedding_bag: ids in range, as the contract has them
        rec = records["embedding_bag"][dt] = {}
        for (f, v, d, b) in EMBEDDING_RAGGED:
            table = normal(f, v, d).to(dtype)
            ids = torch.from_numpy(rng.integers(0, v, (b, f), dtype=np.int32)
                                   ).cuda()
            fold(rec, errors("embedding_bag", dt,
                             ops.embedding_bag(table, ids),
                             ref.embedding_bag_ref(table, ids),
                             f"F={f} V={v} D={d} B={b}"))
        # flash_attention: causal and full, ragged S and D
        rec = records["flash_attention"][dt] = {}
        for (h, s, d) in FLASH_RAGGED:
            q, k, v = (normal(h, s, d).to(dtype) for _ in range(3))
            for causal in (True, False):
                fold(rec, errors(
                    "flash_attention", dt,
                    ops.flash_attention(q, k, v, causal=causal),
                    ref.flash_attention_ref(q, k, v, causal=causal),
                    f"H={h} S={s} D={d} causal={causal}"))
    for name, by_dtype in records.items():
        for dt, rec in by_dtype.items():
            print(f"[2 kernel] {name} {dt}: ragged shapes, {err_text(rec)}")
    return records


SPLIT_CALLS = 10
# what one segment_matmul call puts on the card: its one cooperative
# kernel (the CSR build and the sum); a memset would show here too
SPLIT_KERNELS = ("Memset", "segment_matmul_kernel")


def segment_split(dt: str, call) -> None:
    """``torch.profiler`` over ``SPLIT_CALLS`` calls, each followed by a
    synchronize: each kernel's device time a call (the CSR build's and the
    sum's, by name) against the call's wall time (host clock, call to
    synchronize, median; the profiler's own cost included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    walls = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(SPLIT_CALLS):
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
    device_us = {}
    for ev in prof.key_averages():
        for stem in SPLIT_KERNELS:
            if ev.device_time_total > 0 and stem in ev.key:
                device_us[stem] = (device_us.get(stem, 0.0)
                                   + ev.device_time_total / SPLIT_CALLS)
    wall = statistics.median(walls)
    host = host_enqueue_ms(call)
    if not device_us:
        print(f"[6 coworkload] segment_matmul {dt} profiler split: the "
              f"profiler showed no device time (CUDA-event times above "
              f"stand); wall {wall:.4f} ms a call; {host}")
        return
    total = sum(device_us.values())
    parts = ", ".join(f"{k} {v:.2f}" for k, v in sorted(
        device_us.items(), key=lambda kv: -kv[1]))
    print(f"[6 coworkload] segment_matmul {dt} profiler split, us of device "
          f"time a call: {parts}; device {total / 1e3:.4f} ms of a "
          f"{wall:.4f} ms wall (median of {SPLIT_CALLS}, profiler on); "
          f"{host}")


def host_enqueue_ms(call) -> str:
    """The host's time to enqueue one call (no synchronize; mean of
    ``SPLIT_CALLS`` back to back), and of it the time inside the C call
    (the library's launches), timed around ``build.launch``."""
    import torch
    from repro_torch.kernels import build
    real_launch, inside = build.launch, []

    def timed(*args):
        t = time.perf_counter()
        real_launch(*args)
        inside.append(time.perf_counter() - t)

    torch.cuda.synchronize()
    build.launch = timed
    try:
        t0 = time.perf_counter()
        for _ in range(SPLIT_CALLS):
            call()
        enqueue = (time.perf_counter() - t0) / SPLIT_CALLS
    finally:
        build.launch = real_launch
    torch.cuda.synchronize()
    return (f"host enqueue {1e3 * enqueue:.4f} ms a call, of it the C call "
            f"{1e3 * sum(inside) / SPLIT_CALLS:.4f}")


def phase_coworkload(graph, ragged: dict) -> dict:
    """The co-workload path: batches from the ported pipeline through
    ``repro_torch.kernels.ops`` on the card, each held against the plain
    version; then each kernel timed on the last batch's inputs.  Returns
    {name: {dtype: record}}, phase 2's errors folded in."""
    import math
    import torch
    import torch.nn.functional as F
    from repro_torch.data.pipeline import (NeighborSampler, RecsysStream,
                                           TokenStream)
    from repro_torch.kernels import embedding_bag, flash_attention, ops, \
        ref, segment_matmul
    from repro_torch.kernels.segment_matmul import csr_by_node, edges_by_node

    dtypes = torch_dtypes()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    sampler = NeighborSampler(graph, **SAGE, seed=0)
    recsys = RecsysStream(**DLRM, seed=0)
    tokens = TokenStream(vocab=LLAMA["vocab"], batch=1, seq=LLAMA["seq"],
                         seed=0)
    f, rows, d_emb = DLRM["n_sparse"], DLRM["vocab"], DLRM_DIM
    table = torch.randn((f, rows, d_emb), generator=gen, device="cuda")
    # a Llama-3-8B attention layer's token embedding and q/k/v projections
    h, kvh, s, d, width = (LLAMA[x] for x in ("heads", "kv_heads", "seq",
                                               "head_dim", "width"))
    embed = torch.randn((LLAMA["vocab"], width), generator=gen, device="cuda")
    wq, wk, wv = (torch.randn((width, heads * d), generator=gen,
                              device="cuda") / math.sqrt(width)
                  for heads in (h, kvh, kvh))

    def heads_of(x, n_heads):           # [S, n*D] -> [H, S, D]
        return x.view(s, n_heads, d).transpose(0, 1).repeat_interleave(
            h // n_heads, dim=0)

    kernels = {"segment_matmul": segment_matmul,
               "embedding_bag": embedding_bag,
               "flash_attention": flash_attention}
    records = {name: {dt: dict(launches=0, batches=0, **ragged[name][dt])
                      for dt in dts} for name, dts in COWORK_DTYPES.items()}
    # host-clock split of the phase: batches made (numpy pipeline, copies
    # to the card, gathers and projections there), kernel calls (wrappers
    # included), plain-version checks
    spent = {"pipeline": 0.0, "kernels": 0.0, "checks": 0.0}

    @contextlib.contextmanager
    def timed(part):
        t = time.perf_counter()
        yield
        torch.cuda.synchronize()
        spent[part] += time.perf_counter() - t

    def run(name, dt, kernel, plain):
        rec, before = records[name][dt], kernels[name].launches
        with timed("kernels"):
            out = kernel()
        rec["launches"] += kernels[name].launches - before
        rec["batches"] += 1
        with timed("checks"):
            fold(rec, errors(name, dt, out, plain(), "co-workload batch"))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in kernels.values():
        mod.reset_launches()
    t0 = time.perf_counter()
    for step in range(COWORK_STEPS):
        with timed("pipeline"):
            feats, src, dst = sage_batch(sampler, step)
            msgs = {dt: feats.to(dtype)[src] for dt, dtype in dtypes.items()}
        for dt, msg in msgs.items():
            run("segment_matmul", dt,
                lambda: ops.segment_matmul(msg, dst, sampler.n_pad),
                lambda: ref.segment_matmul_ref(msg, dst, sampler.n_pad))
        with timed("pipeline"):
            ids = torch.from_numpy(recsys.batch_at(step)["sparse_ids"]
                                   ).cuda()
        run("embedding_bag", "fp32", lambda: ops.embedding_bag(table, ids),
            lambda: ref.embedding_bag_ref(table, ids))
        with timed("pipeline"):
            tok = torch.from_numpy(tokens.batch_at(step)["tokens"][0]).cuda()
            x = embed[tok.long()]
            qkv = [heads_of(x @ wq, h), heads_of(x @ wk, kvh),
                   heads_of(x @ wv, kvh)]
            by_dtype = {dt: [t.to(dtype).contiguous() for t in qkv]
                        for dt, dtype in dtypes.items()}
        for dt, (q, k, v) in by_dtype.items():
            run("flash_attention", dt, lambda: ops.flash_attention(q, k, v),
                lambda: ref.flash_attention_ref(q, k, v))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {name: mod.launches for name, mod in kernels.items()}
    print(f"[6 coworkload] {COWORK_STEPS} steps in {wall_s:.2f}s: launches "
          f"{launches} peak_mem="
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f}GiB")
    print(f"[6 coworkload] host seconds by part: "
          f"{ {k: round(t, 3) for k, t in spent.items()} }")
    for name, recs in records.items():
        if launches[name] != sum(r["launches"] for r in recs.values()):
            fail(f"{name} launched {launches[name]} times, "
                 f"{[r['launches'] for r in recs.values()]} in its calls")
        for dt, rec in recs.items():
            if rec["launches"] != rec.pop("batches"):
                fail(f"{name} {dt} launched {rec['launches']} times for "
                     f"{COWORK_STEPS} batches")
            print(f"[6 coworkload] {name} {dt}: {rec['launches']} launches, "
                  f"{err_text(rec)} (phase 2 and phase 6)")
    # the fp32 plain version is itself fp32: on the last batch's head where
    # it and the kernel differ most, hold both against float64
    q, k, v = by_dtype["fp32"]
    got, want = ops.flash_attention(q, k, v), ref.flash_attention_ref(q, k, v)
    i = int((got - want).abs().flatten(1).max(1).values.argmax())
    scores = (q[i].double() @ k[i].double().T) / math.sqrt(d)
    scores.masked_fill_(torch.ones((s, s), dtype=torch.bool,
                                   device="cuda").triu_(1), float("-inf"))
    exact = torch.softmax(scores, dim=-1) @ v[i].double()
    del scores
    for what, out in (("kernel", got[i]), ("plain version", want[i])):
        diff = (out.double() - exact).abs()
        row = int(diff.max(1).values.argmax())
        top = float(exact[row].abs().max())
        print(f"[6 coworkload] flash_attention fp32 head {i} against "
              f"float64: {what} max abs err {float(diff.max()):.3g} (row "
              f"{row}, where max |out| is {top:.3g})")
    del got, want, exact

    # times at full width, on the last batch's inputs; these launches come
    # after the counts were read and are not the path's
    def time_call(name, dt, what, kernel, plain, library, bound, flops=0,
                  note=""):
        rec = records[name][dt]
        rec.update(ms=cuda_ms(kernel, 20), plain_ms=cuda_ms(plain, 3, 1),
                   library_ms=cuda_ms(library, 20), bound_ms=bound[0],
                   bound_by=bound[1])
        rate = f" TFLOP/s={flops / rec['ms'] / 1e9:.1f}" if flops else ""
        print(f"[6 coworkload] {name} {dt} {what}: ms={rec['ms']:.4f} "
              f"plain_ms={rec['plain_ms']:.3f} "
              f"library_ms={rec['library_ms']:.4f} "
              f"bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']}){rate}"
              f"{note}")

    n, d_feat = sampler.n_pad, SAGE["d_feat"]
    for dt, msg in msgs.items():
        time_call(
            "segment_matmul", dt, f"E={msg.shape[0]} N={n} D={d_feat}",
            lambda: ops.segment_matmul(msg, dst, n),
            lambda: ref.segment_matmul_ref(msg, dst, n),
            lambda: torch.zeros(n, d_feat, device="cuda").index_add_(
                0, dst, msg.float()),
            bound_ms(msg.numel() * msg.element_size() + 4 * n * d_feat
                     + 4 * dst.numel(), msg.numel(), "fp32"))
    # the same batch with its edges shuffled: dst unsorted, so the launch
    # runs the radix passes; messages moved with their edges
    perm = torch.randperm(dst.numel(), generator=gen, device="cuda")
    dst_s = dst[perm]
    for dt, msg in msgs.items():
        msg_s = msg[perm]
        rec = records["segment_matmul"][dt]
        errs = errors("segment_matmul", dt,
                      ops.segment_matmul(msg_s, dst_s, n),
                      ref.segment_matmul_ref(msg_s, dst_s, n),
                      "shuffled co-workload batch")
        same_bits("segment_matmul", dt, ops.segment_matmul(msg_s, dst_s, n),
                  ops.segment_matmul(msg_s, dst_s, n),
                  "shuffled co-workload batch")
        rec["shuffled"] = dict(
            ms=cuda_ms(lambda: ops.segment_matmul(msg_s, dst_s, n), 20),
            library_ms=cuda_ms(lambda: torch.zeros(
                n, d_feat, device="cuda").index_add_(0, dst_s, msg_s.float()),
                20), **errs)
        print(f"[6 coworkload] segment_matmul {dt} E={msg.shape[0]} N={n} "
              f"D={d_feat}, dst shuffled: ms={rec['shuffled']['ms']:.4f} "
              f"library_ms={rec['shuffled']['library_ms']:.4f} "
              f"bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']}); "
              f"{err_text(rec['shuffled'])}")
    for dt, msg in msgs.items():
        same_bits("segment_matmul", dt, ops.segment_matmul(msg, dst, n),
                  ops.segment_matmul(msg, dst, n), "co-workload batch")
        segment_split(dt, lambda: ops.segment_matmul(msg, dst, n))
        msg_s = msg[perm]
        segment_split(f"{dt} shuffled",
                      lambda: ops.segment_matmul(msg_s, dst_s, n))
    print(f"[6 coworkload] segment_matmul CSR alone: the kernel's "
          f"(csr_by_node) {cuda_ms(lambda: csr_by_node(dst, n), 20):.4f} ms, "
          f"dst shuffled {cuda_ms(lambda: csr_by_node(dst_s, n), 20):.4f}; "
          f"the plain CSR build (edges_by_node: torch.sort, searchsorted) "
          f"{cuda_ms(lambda: edges_by_node(dst, n), 20):.4f} ms")
    flat = table.view(f * rows, d_emb)
    offsets = torch.arange(f, device="cuda") * rows
    time_call(
        "embedding_bag", "fp32", f"B={ids.shape[0]} F={f} V={rows} D={d_emb}",
        lambda: ops.embedding_bag(table, ids),
        lambda: ref.embedding_bag_ref(table, ids),
        lambda: F.embedding(ids + offsets, flat),
        bound_ms(ids.numel() * (4 * d_emb + 4 + 4 * d_emb), 0, "fp32"))
    flops = 4 * h * d * s * (s + 1) / 2
    for dt, (q, k, v) in by_dtype.items():
        nbytes = q.element_size() * 3 * q.numel() + 4 * q.numel()
        bound, note = bound_ms(nbytes, flops, dt), ""
        if dt == "fp32":
            # three tf32 tensor-core products for each fp32 product (the
            # 3xTF32 split); the fp32 FMA bound beside it
            ms, by = bound_ms(nbytes, 3 * flops, "tf32")
            bound = (ms, f"{by}, 3xTF32")
            note = f" fma_bound_ms={bound_ms(nbytes, flops, 'fp32')[0]:.4f}"
        time_call(
            "flash_attention", dt, f"H={h} S={s} D={d} causal",
            lambda: ops.flash_attention(q, k, v),
            lambda: ref.flash_attention_ref(q, k, v),
            lambda: F.scaled_dot_product_attention(q[None], k[None], v[None],
                                                   is_causal=True),
            bound, flops, note)
    return records


def merge_topk_plain(states, keys, k: int):
    """``repro.core.engine.merge_topk`` as chained stable sorts: by the key,
    then by state word S-1 down to word 0 (``jnp.lexsort``'s order), then
    the same dedup and top-k."""
    import torch
    from repro_torch.core.api import NEG
    lex = torch.sort(keys, stable=True).indices
    for j in reversed(range(states.shape[1])):
        lex = lex[torch.sort(states[lex, j], stable=True).indices]
    ss, kk = states[lex], keys[lex]
    dup = torch.cat([torch.zeros((1,), dtype=torch.bool, device=ss.device),
                     (ss[1:] == ss[:-1]).all(dim=1) & (kk[1:] == kk[:-1])])
    kk = torch.where(dup, NEG, kk)
    top = torch.sort(kk, descending=True, stable=True).indices[:k]
    top_keys = kk[top]
    return torch.where((top_keys > NEG)[:, None], ss[top], 0), top_keys


def phase_merge_topk() -> dict:
    """The engine's merge_topk at k = 4,400 (R = k + B = 4,464 rows of
    S = 2,050 words, equal except in their last 3 words, with duplicate
    (state, key) pairs and NEG keys) against chained stable sorts; its
    peak device memory above its inputs and its time."""
    import numpy as np
    import torch
    from repro_torch.core.api import NEG
    from repro_torch.core.engine import merge_topk

    k, r, s = MERGE["k"], MERGE["k"] + MERGE["batch"], MERGE["width"]
    rng = np.random.default_rng(7)
    states = np.tile(rng.integers(-2**31, 2**31, s, dtype=np.int64)
                     .astype(np.int32), (r, 1))
    states[:, -3:] = rng.integers(-2, 2, (r, 3))
    keys = rng.integers(0, 6, r).astype(np.int32)
    keys[rng.random(r) < 0.1] = NEG
    for dst, src in rng.integers(0, r, (r // 8, 2)):
        states[dst], keys[dst] = states[src], keys[src]
    states, keys = torch.from_numpy(states).cuda(), \
        torch.from_numpy(keys).cuda()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = merge_topk(states, keys, k)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    want = merge_topk_plain(states, keys, k)
    for a, b in zip(got, want):
        if not torch.equal(a, b):
            fail(f"merge_topk k={k} S={s}: differs from chained stable sorts")
    ms = cuda_ms(lambda: merge_topk(states, keys, k), 3, 1)
    plain_ms = cuda_ms(lambda: merge_topk_plain(states, keys, k), 3, 1)
    live = int((got[1] > NEG).sum())
    print(f"[7 merge_topk] k={k} R={r} S={s}: equal to chained stable sorts "
          f"({live} live keys), peak {peak / 2**20:.1f} MiB above its "
          f"inputs, ms={ms:.3f} (chained sorts {plain_ms:.3f})")
    if peak > MERGE_PEAK_BYTES:
        fail(f"merge_topk k={k}: peak {peak} bytes above its inputs, over "
             f"{MERGE_PEAK_BYTES}")
    return dict(peak_bytes=peak, ms=ms)


# phase 11: durable runs and the service at full width
DURABLE_EVERY = 64           # checkpoint_every of the kill-and-resume runs
DURABLE_KILL_STEP = 150      # T = 1: SIGKILL at the first host read past it
DURABLE_KILL_COMMIT = 2      # T = MACRO_T: SIGKILL inside the 2nd commit
CHILD_TIMEOUT_S = 300
# the service's clique request: phase 4's config; cut and checkpointed,
# then resumed
SERVICE_CLIQUE = dict(k=FULL_ENGINE["k"], batch=FULL_ENGINE["batch"],
                      pool_capacity=FULL_ENGINE["pool_capacity"])
SERVICE_TRUNCATED = dict(step_budget=100, checkpoint_every=32)
# phase 14: the sharded checkpoint on phase 4's cell, (a) in this process
# and (b) killed and resumed in children, at SHARDED_DURABLE shards (T = 1)
# and SHARDED_DURABLE_MACRO (shards, K) at T = MACRO_T (8 shards there
# would add ~40 GiB of accumulator beside the other child); (c) the
# service at the latter's shard count
SHARDED_DURABLE = 8
SHARDED_DURABLE_MACRO = (2, 4)
# the serve CLI's request file (the demo graphs of repro_torch.launch.serve)
CLI_REQUESTS = [
    {"graph": "demo-social", "workload": "clique", "k": 3,
     "request_id": "clique"},
    {"graph": "demo-social", "workload": "clique", "k": 3,
     "request_id": "clique again"},
    {"graph": "demo-social", "workload": "weighted-clique", "k": 2,
     "weights": [(v * 7) % 19 + 1 for v in range(200)],
     "request_id": "weighted"},
    {"graph": "demo-citeseer", "workload": "iso", "k": 3,
     "q_edges": [[0, 1], [1, 2]], "q_labels": [0, 1, 0], "use_pallas": True,
     "request_id": "iso"},
    {"graph": "demo-citeseer", "workload": "pattern", "k": 2, "m_edges": 3,
     "use_pallas": True, "request_id": "pattern"},
    {"graph": "demo-attributed", "workload": "iso", "k": 3,
     "q_edges": [[0, 1], [1, 2], [0, 2]], "q_labels": [1, 1, 1],
     "label_predicate": {"vertex_any_of": [1, 2],
                         "q_any_of": [[1, 2], [1, 2], [1, 2]],
                         "edge_any_of": [0]}, "request_id": "predicate"},
    "not json at all",
    {"graph": "demo-social", "workload": "clique", "k": "three"},
    {"graph": "demo-social", "workload": "clique", "k": 3, "shards": 2,
     "request_id": "sharded"},
    {"cmd": "metrics"},
]


def durable_engine(spec: dict, **cfg):
    """Phase 4's engine on the card with the disk spill and checkpoints
    every ``DURABLE_EVERY`` steps, at ``spec["T"]`` steps a host read: an
    ``Engine``, or a ``ShardedEngine`` at ``spec["shards"]`` > 1 with
    ``sync_every = spec["K"]`` (and any other ``EngineConfig`` field in
    ``cfg``)."""
    from repro_torch.core.clique import make_clique_computation
    from repro_torch.core.engine import Engine, EngineConfig
    from repro_torch.data.synthetic_graphs import planted_clique_graph
    from repro_torch.distributed import ShardedEngine
    comp = make_clique_computation(planted_clique_graph(**FULL_GRAPH),
                                   device="cuda")
    config = EngineConfig(
        **dict(FULL_ENGINE, spill="disk"), spill_dir=spec["spill_dir"],
        shards=spec.get("shards", 1), steps_per_sync=spec["T"],
        sync_every=spec.get("K", 1), checkpoint_every=DURABLE_EVERY,
        checkpoint_dir=spec["ckpt_dir"], **cfg)
    return (ShardedEngine if config.shards > 1 else Engine)(comp, config)


def durable_child(spec: dict) -> int:
    """``--durable-child '<json>'`` (the subprocess of phases 11a and
    14b): in mode ``crash`` it arms a SIGKILL (at the first host read at
    or past ``kill_at_step``, or inside commit number ``kill_in_commit``)
    and runs, and must die there; in mode ``resume`` it continues from the
    newest committed step, writes the result states to ``spec["result"]``
    and prints a ``DURABLE`` line with the keys, counters, ``per_shard``
    lists, the step and host reads resumed from, the resumed run's wall
    and its ``masked_intersect`` launches."""
    import os
    import signal
    import numpy as np
    import torch
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.kernels import masked_intersect as mi

    eng = durable_engine(spec)
    if spec["mode"] == "crash":
        if spec.get("kill_at_step"):
            inner_step = eng.step

            def step(st, max_inner=None):
                out = inner_step(st, max_inner=max_inner)
                if out.steps >= spec["kill_at_step"]:
                    os.kill(os.getpid(), signal.SIGKILL)
                return out
            eng.step = step
        else:
            commits = [0]
            inner_commit = CheckpointManager._commit

            def commit(self, tmp, final):
                commits[0] += 1
                if commits[0] >= spec["kill_in_commit"]:
                    os.kill(os.getpid(), signal.SIGKILL)
                return inner_commit(self, tmp, final)
            CheckpointManager._commit = commit
        eng.run()
        fail("the durable child ran to its end past its kill point")
    mgr = CheckpointManager(spec["ckpt_dir"])
    resumed_from = mgr.latest_step()
    resumed_syncs = (None if resumed_from is None else
                     mgr.read_manifest()["extra"]["scalars"]["host_syncs"])
    torch.cuda.synchronize()
    mi.reset_launches()
    t0 = time.perf_counter()
    res = eng.run(resume=True)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    np.save(spec["result"], res.result_states)
    print("DURABLE " + json.dumps(dict(
        keys=[int(x) for x in res.result_keys],
        counters={c: getattr(res, c) for c in COUNTERS + ("rebalanced",)},
        per_shard=res.per_shard, resumed_from=resumed_from,
        resumed_host_syncs=resumed_syncs, wall_s=wall_s,
        launches=mi.launches)), flush=True)
    return 0


def run_children(specs: list) -> list:
    """Run one ``--durable-child`` process a spec, all together; returns
    ``(returncode, stdout, stderr)`` each.  Every child is killed by the
    time this returns."""
    import subprocess as sp
    procs = [sp.Popen([sys.executable, str(Path(__file__).resolve()),
                       "--durable-child", json.dumps(spec)],
                      stdout=sp.PIPE, stderr=sp.PIPE, text=True)
             for spec in specs]
    try:
        outs = [p.communicate(timeout=CHILD_TIMEOUT_S) for p in procs]
        return [(p.returncode, *out) for p, out in zip(procs, outs)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def checkpointed_run(tag: str, spec: dict, want, what: str,
                     want_wall_s: float) -> None:
    """``durable_engine(spec)`` run once in this process, observed: it
    must equal ``want`` (phase ``what``'s result) byte for byte with every
    counter and ``per_shard`` list, and launch ``masked_intersect`` once a
    shard a step; prints the checkpoints' count, bytes, the
    ``checkpoint.save`` time on the engine's thread, the writer thread's
    commits, the wall beside ``want_wall_s`` and the peak memory.  Removes
    the checkpoint directory after."""
    import torch
    from repro_torch.kernels import masked_intersect as mi
    from repro_torch.obs import Observability

    obs = Observability()
    eng = durable_engine(spec, observe=True, observability=obs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mi.reset_launches()
    t0 = time.perf_counter()
    res = eng.run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    shards = spec.get("shards", 1)
    same_run(f"{tag}: the checkpointed run against phase {what}", res, want,
             COUNTERS + ("rebalanced",))
    if res.per_shard != want.per_shard:
        fail(f"{tag}: per_shard {res.per_shard}, phase {what}'s "
             f"{want.per_shard}")
    m = obs.metrics
    cap = m.get("checkpoint_capture_seconds").snapshot()
    com = m.get("checkpoint_commit_seconds").snapshot()
    saves = int(m.get("checkpoint_saves_total").value)
    save_s = sum(d for name, _, d, _ in obs.tracer.spans()
                 if name == "checkpoint.save")
    print(f"[{tag}] checkpointed run (x{shards}, T={spec['T']}, "
          f"checkpoint_every={DURABLE_EVERY}, disk spill): equal to phase "
          f"{what} byte for byte with every counter and per_shard list; "
          f"wall={wall_s:.3f}s (phase {what}: {want_wall_s:.3f}s, host "
          f"spill, no checkpoint) saves={saves} "
          f"bytes={int(m.get('checkpoint_bytes_written_total').value)} "
          f"save_ms={1e3 * save_s:.1f} (on the engine's thread: the host "
          f"copy and the capture, {1e3 * save_s / saves:.1f} a save) "
          f"capture_ms={1e3 * cap['sum']:.1f} "
          f"commit_ms={1e3 * com['sum']:.1f} ({com['count']} commits, on "
          f"the writer thread) masked_intersect_launches={mi.launches} "
          f"peak_mem={torch.cuda.max_memory_allocated() / 2**30:.2f}GiB")
    if mi.launches != res.steps * shards:
        fail(f"{tag}: the checkpointed run launched masked_intersect "
             f"{mi.launches} times in {res.steps} steps of {shards} shards")
    del eng
    shutil.rmtree(spec["ckpt_dir"])   # its steps and linked runs


def kill_and_resume(tag: str, cases: list, tmp: str) -> dict:
    """Each case (``label``, ``spec`` fields for :func:`durable_engine`,
    ``kill``, the result it must give, that result's phase) in a crash
    child, all at once, each SIGKILLed (exit -9) at its kill point; then
    each resumed in a second child, all at once: equal to its result byte
    for byte with every counter (``rebalanced`` among them) and
    ``per_shard`` list, no ``.tmp`` checkpoint dir and no spill file left
    (every ``shard{i}`` directory included), and ``masked_intersect``
    launched exactly once a shard an enqueued inner step of the resumed
    run: ``shards x T x`` its host reads.  Removes each checkpoint
    directory once checked.  Returns the resumed runs' launches."""
    import os
    import numpy as np

    specs = [dict(fields, ckpt_dir=f"{tmp}/ck-{label}",
                  spill_dir=f"{tmp}/spill-{label}",
                  result=f"{tmp}/states-{label}.npy")
             for label, fields, _, _, _ in cases]
    t0 = time.perf_counter()
    crashed = run_children([dict(spec, mode="crash", **kill)
                            for spec, (_, _, kill, _, _) in zip(specs, cases)])
    crash_s = time.perf_counter() - t0
    for (label, *_), (rc, _, err) in zip(cases, crashed):
        if rc != -9:
            fail(f"{tag} {label}: the crash child exited {rc}, not by "
                 f"SIGKILL: {err[-2000:]}")
    for spec in specs:           # the resume runs on fresh spill dirs
        spec["spill_dir"] += "-resume"
    t0 = time.perf_counter()
    resumed = run_children([dict(spec, mode="resume") for spec in specs])
    resume_s = time.perf_counter() - t0
    launches = {}
    for spec, (label, fields, kill, ref, what), (rc, out, err) in zip(
            specs, cases, resumed):
        if rc != 0:
            fail(f"{tag} {label}: the resume child exited {rc}: "
                 f"{err[-2000:]}")
        line = [x for x in out.splitlines() if x.startswith("DURABLE ")]
        if not line:
            fail(f"{tag} {label}: the resume child printed no result")
        got = json.loads(line[0][len("DURABLE "):])
        states = np.load(spec["result"])
        if got["keys"] != [int(x) for x in ref.result_keys] or \
                states.tobytes() != ref.result_states.tobytes() or \
                got["counters"] != {c: getattr(ref, c)
                                    for c in COUNTERS + ("rebalanced",)} or \
                got["per_shard"] != ref.per_shard:
            fail(f"{tag} {label}: the resumed run {got} differs from "
                 f"phase {what}'s")
        tmps = [d for d in os.listdir(spec["ckpt_dir"]) if d.endswith(".tmp")]
        spill = [f for _, _, fs in os.walk(spec["spill_dir"]) for f in fs]
        if tmps or spill:
            fail(f"{tag} {label}: left {tmps} {spill[:4]}")
        shards = fields.get("shards", 1)
        ran = ref.steps - (got["resumed_from"] or 0)
        enqueued = fields["T"] * (ref.host_syncs
                                  - (got["resumed_host_syncs"] or 0))
        if got["resumed_from"] is None or \
                got["launches"] != shards * enqueued:
            fail(f"{tag} {label}: resumed from {got['resumed_from']}, "
                 f"{got['launches']} masked_intersect launches for "
                 f"{shards} shards x {enqueued} enqueued inner steps")
        launches[label] = got["launches"]
        kill_at = (f"at step >= {kill['kill_at_step']}"
                   if "kill_at_step" in kill else
                   f"inside commit {kill['kill_in_commit']}")
        print(f"[{tag}] {label}: killed (-9) {kill_at}, resumed from step "
              f"{got['resumed_from']}: equal to phase {what} byte for byte "
              f"with every counter and per_shard list (host_syncs "
              f"{got['counters']['host_syncs']}, rebalanced "
              f"{got['counters']['rebalanced']}); resumed run "
              f"wall={got['wall_s']:.3f}s, masked_intersect_launches="
              f"{got['launches']} for {ran} steps ({shards} shards x "
              f"{enqueued} enqueued); no .tmp dir, spill dir empty")
        shutil.rmtree(spec["ckpt_dir"])
    print(f"[{tag}] children ({len(cases)} at a time, each its own CUDA "
          f"context and graph): crash {crash_s:.1f}s, resume "
          f"{resume_s:.1f}s")
    return launches


def phase_durable(want, want_wall_s: float, want8) -> dict:
    """Phase 11a: durable runs of phase 4's path.  First one checkpointed
    run in this process (``checkpoint_every=64``, the disk spill): phase
    4's answer and counters, and what the checkpoints cost (saves, bytes,
    capture and commit time, the wall beside phase 4's).  Then kill and
    resume in subprocesses of this script: at T = 1 SIGKILLed at the first
    host read past step 150, at T = ``MACRO_T`` inside its second commit;
    each resumed run must equal phase 4's (T = 1) or phase 8's result byte
    for byte with every counter, leave no ``.tmp`` checkpoint dir and no
    spill file, and launch ``masked_intersect`` once an enqueued step.
    Returns the resumed runs' launches."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        checkpointed_run("11 durable", dict(
            T=1, ckpt_dir=f"{tmp}/ck", spill_dir=f"{tmp}/spill"), want, "4",
            want_wall_s)
        launches = kill_and_resume("11 durable", [
            ("T=1", dict(T=1), dict(kill_at_step=DURABLE_KILL_STEP), want,
             "4"),
            (f"T={MACRO_T}", dict(T=MACRO_T),
             dict(kill_in_commit=DURABLE_KILL_COMMIT), want8, "8")], tmp)
    return {f"durable clique {label}": n for label, n in launches.items()}


@contextlib.contextmanager
def task_launches():
    """``masked_intersect`` launches read around each service task's
    steps, by request id: the scheduler's task classes' ``step`` wrapped,
    and put back on exit."""
    from repro_torch.kernels import masked_intersect as mi
    from repro_torch.service import scheduler
    by_request, inner = {}, {}

    def counted(cls):
        def step(task):
            before = mi.launches
            inner[cls](task)
            rid = task.request.request_id
            by_request[rid] = by_request.get(rid, 0) + mi.launches - before
        return step

    for cls in (scheduler.EngineQueryTask, scheduler.PatternQueryTask):
        inner[cls] = cls.step
        cls.step = counted(cls)
    try:
        yield by_request
    finally:
        for cls, step in inner.items():
            cls.step = step


def service_answer(r, ref, results, what: str) -> None:
    """A service response equal to the engine result ``ref``: its keys,
    ``results`` (the response's lists) and every counter, ``rebalanced``
    among them."""
    names = COUNTERS + ("rebalanced",)
    got = {c: r.stats[c] for c in names}
    if r.result_keys != [int(x) for x in ref.result_keys] or \
            r.results != results or \
            got != {c: getattr(ref, c) for c in names}:
        fail(f"service {r.request_id}: {r.result_keys} {got}, {what} "
             f"{[int(x) for x in ref.result_keys]} "
             f"{ {c: getattr(ref, c) for c in names} }")


def phase_service(want, described, iso_run) -> dict:
    """Phase 11b: one ``DiscoveryService(device="cuda")`` over phase 4's
    graph, phase 9's and phase 3's small pattern graph.  One batch: phase
    4's clique request, phase 9's iso request on the kernel path, a repeat
    of the clique request (a cache hit: no engine step), phase 3's pattern
    request (``use_pallas``) and the clique request cut to 100 steps with
    checkpoints every 32; then, in a second call, that request resumed
    with the full budget.  Each answer must equal phases 4, 9 and 3 (keys,
    results as the response lists them, every counter); the resumed one
    finishes with phase 4's steps.  ``masked_intersect`` launches are read
    around each task's steps.  Returns the launches by path."""
    import tempfile
    import torch
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data.synthetic_graphs import (labeled_graph,
                                                   planted_clique_graph)
    from repro_torch.obs import Observability
    from repro_torch.service import (DiscoveryRequest, DiscoveryService,
                                     GraphRegistry)

    want9, described9, q_labels = iso_run
    t0 = time.perf_counter()
    registry = GraphRegistry()
    registry.register("clique", planted_clique_graph(**FULL_GRAPH))
    registry.register("iso", labeled_graph(**ISO_GRAPH))
    registry.register("pattern", labeled_graph(**PATTERN_SMALL_GRAPH))
    graphs_s = time.perf_counter() - t0
    obs = Observability()
    svc = DiscoveryService(registry, observability=obs, device="cuda")
    clique = dict(graph="clique", workload="clique", **SERVICE_CLIQUE)

    with tempfile.TemporaryDirectory() as tmp, \
            task_launches() as by_request:
        truncated = dict(clique, **SERVICE_TRUNCATED, checkpoint_dir=tmp,
                         use_cache=False)
        batch = [
            DiscoveryRequest(**clique, request_id="clique"),
            DiscoveryRequest(
                graph="iso", workload="iso", k=ISO_ENGINE["k"],
                batch=ISO_ENGINE["batch"],
                pool_capacity=ISO_ENGINE["pool_capacity"],
                q_edges=tuple(ISO_4G), q_labels=tuple(q_labels),
                max_hops=ISO_HOPS, use_pallas=True, request_id="iso"),
            DiscoveryRequest(**clique, request_id="clique repeat"),
            DiscoveryRequest(graph="pattern", workload="pattern",
                             **PATTERN_SMALL, use_pallas=True,
                             request_id="pattern"),
            DiscoveryRequest(**truncated, request_id="truncated")]
        resume = DiscoveryRequest(**dict(truncated, step_budget=100_000),
                                  resume=True, request_id="resumed")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        first = svc.serve(batch)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        steps_first = svc.engine_steps_total
        committed = CheckpointManager(tmp).latest_step()
        t0 = time.perf_counter()
        second = svc.serve([resume])
        torch.cuda.synchronize()
        second_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()

    resp = {r.request_id: r for r in first + second}
    for rid, r in resp.items():
        if r.status != "ok":
            fail(f"service {rid}: {r.error}")
        print(f"[11 service] {rid}: cached={r.cached} "
              f"terminated={r.terminated} latency_s={r.latency_s:.3f} "
              f"keys={r.result_keys} steps={r.stats['steps']} "
              f"masked_intersect_launches={by_request.get(rid, 0)}")

    service_answer(resp["clique"], want, described, "phase 4")
    service_answer(resp["clique repeat"], want, described, "phase 4")
    service_answer(resp["iso"], want9, described9, "phase 9")
    service_answer(resp["resumed"], want, described, "phase 4")
    pat = resp["pattern"]
    if pat.result_keys != [sup for sup, _ in PATTERN_SMALL_WANT["patterns"]] \
            or pat.results != [[list(e) for e in code] for _, code in
                               PATTERN_SMALL_WANT["patterns"]] or \
            (pat.stats["candidates"], pat.stats["expanded"],
             pat.stats["pruned"]) != (
                PATTERN_SMALL_WANT["candidates"],
                PATTERN_SMALL_WANT["groups_expanded"],
                PATTERN_SMALL_WANT["groups_pruned"]):
        fail(f"service pattern: {pat.result_keys} {pat.stats}, reference "
             f"{PATTERN_SMALL_WANT}")
    cut = SERVICE_TRUNCATED["step_budget"]
    checks = [
        (not resp["clique"].cached and resp["clique repeat"].cached,
         "the repeat is not a cache hit"),
        (by_request.get("clique repeat", 0) == 0, "the repeat ran steps"),
        (steps_first == want.steps + want9.steps + cut,
         f"engine_steps_total {steps_first} after the batch"),
        (resp["truncated"].terminated == "step_budget"
         and resp["truncated"].stats["steps"] == cut == committed,
         f"truncated run: {resp['truncated'].stats['steps']} steps, "
         f"newest checkpoint {committed}"),
        (svc.engine_steps_total - steps_first == want.steps - cut,
         "the resumed request counted its steps before the cut again"),
        (resp["resumed"].terminated == "complete", "resumed: not complete"),
        (by_request["clique"] == want.steps
         and by_request["truncated"] == cut
         and by_request["resumed"] == want.steps - cut
         and by_request["iso"] >= want9.steps
         and by_request["pattern"] == PATTERN_SMALL_PROBES,
         f"masked_intersect launches by request {by_request}")]
    for ok, what in checks:
        if not ok:
            fail(f"service: {what}")
    metrics = obs.snapshot()["metrics"]
    print(f"[11 service] answers equal phases 4, 9 and 3 (keys, results, "
          f"every counter); the repeat a cache hit with no step; the cut "
          f"request resumed from step {committed} to {want.steps}; graphs="
          f"{graphs_s:.2f}s batch={first_s:.3f}s resume={second_s:.3f}s "
          f"engine_steps_total={svc.engine_steps_total} "
          f"peak_mem={peak / 2**30:.2f}GiB")
    print("[11 service] metrics: " + json.dumps(
        {name: (m["value"] if "value" in m else
                {"count": m["count"], "sum": round(m["sum"], 6)})
         for name, m in sorted(metrics.items())
         if name.startswith("service_")}))
    return {"service clique": by_request["clique"],
            "service iso": by_request["iso"],
            "service pattern": by_request["pattern"]}


def cli_response(line: str) -> dict:
    """A response line without the fields that read the wall clock."""
    d = json.loads(line)
    d.pop("latency_s", None)
    if isinstance(d.get("stats"), dict):
        d["stats"].pop("straggler_steps", None)
    return d


def phase_serve_cli() -> None:
    """Phase 11c: ``python -m repro_torch.launch.serve --device cuda`` and
    ``--device cpu`` over ``CLI_REQUESTS`` (the demo graphs: clique and its
    cache hit, weighted clique, iso and pattern with ``use_pallas``, a
    label predicate, malformed lines, ``shards: 2``, a metrics command),
    both processes at once; their response lines must be equal but for
    the wall-clock fields, and the ``shards: 2`` line an answer equal to
    the one-shard clique request's."""
    import os
    import subprocess as sp
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/requests.jsonl"
        with open(path, "w") as f:
            for req in CLI_REQUESTS:
                f.write((req if isinstance(req, str) else json.dumps(req))
                        + "\n")
        env = dict(os.environ, PYTHONPATH=str(SRC))
        t0 = time.perf_counter()
        procs = {dev: sp.Popen(
            [sys.executable, "-m", "repro_torch.launch.serve", "--device",
             dev, "--requests", path], stdout=sp.PIPE, stderr=sp.PIPE,
            text=True, env=env) for dev in ("cuda", "cpu")}
        try:
            outs = {dev: p.communicate(timeout=CHILD_TIMEOUT_S)
                    for dev, p in procs.items()}
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall_s = time.perf_counter() - t0
    for dev, p in procs.items():
        if p.returncode != 0:
            fail(f"serve --device {dev} exited {p.returncode}: "
                 f"{outs[dev][1][-2000:]}")
    lines = {dev: [cli_response(x) for x in out.splitlines()]
             for dev, (out, _) in outs.items()}
    if len(lines["cuda"]) != len(CLI_REQUESTS) or \
            lines["cuda"] != lines["cpu"]:
        fail(f"serve: the cuda lines differ from the cpu lines:\n"
             f"{lines['cuda']}\n{lines['cpu']}")
    by_id = {d.get("request_id"): d for d in lines["cuda"]}
    sharded, clique = by_id["sharded"], by_id["clique"]
    if sharded["status"] != "ok" or \
            (sharded["result_keys"], sharded["results"]) != \
            (clique["result_keys"], clique["results"]) or \
            sharded["stats"]["syncs"] != sharded["stats"]["steps"] or \
            not by_id["clique again"]["cached"] or \
            sum(d.get("status") == "error" for d in lines["cuda"]) != 2:
        fail(f"serve: {lines['cuda']}")
    summary = {dev: err.strip().splitlines()[-1] for dev, (_, err)
               in outs.items()}
    print(f"[11 serve] {len(CLI_REQUESTS)} request lines through "
          f"--device cuda and --device cpu (both at once, {wall_s:.1f}s): "
          f"equal response lines (latency and straggler count aside); "
          f"shards: 2 answered ok with the one-shard answer "
          f"{sharded['result_keys']} in {sharded['stats']['steps']} steps; "
          f"cuda {summary['cuda']}")


def phase_sharded_durable(want12: dict, walls12: dict, want13: dict,
                          described: list, env: dict) -> dict:
    """Phase 14: the sharded checkpoint and the service's sharded path on
    phase 4's cell.  (a) ``SHARDED_DURABLE`` shards, T = 1, the disk spill
    and ``checkpoint_every=64``, in this process: phase 12's result with
    every counter and ``per_shard`` list, and what the checkpoints cost.
    (b) Kill and resume in subprocesses (:func:`kill_and_resume`): the
    same at T = 1 SIGKILLed at the first host read past step 150, and
    ``SHARDED_DURABLE_MACRO`` (2 shards, K = 4) at T = ``MACRO_T``
    SIGKILLed inside its second commit: phase 12's and phase 13a's
    results.  (c) :func:`sharded_service`.  Returns the launches by
    path."""
    import gc
    import tempfile
    import torch

    s8, (s2, K) = SHARDED_DURABLE, SHARDED_DURABLE_MACRO
    tag = "14 sharded durable"
    with tempfile.TemporaryDirectory() as tmp:
        checkpointed_run(tag, dict(T=1, shards=s8, ckpt_dir=f"{tmp}/ck",
                                   spill_dir=f"{tmp}/spill"),
                         want12[s8], f"12 (x{s8})", walls12[s8])
        # the children's memory: ~4.1 GiB at 8 shards, T = 1, and ~10.9
        # at 2 shards, T = 16, beside this process's cached blocks
        gc.collect()
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        print(f"[{tag}] before the children: {free / 2**30:.2f} GiB free "
              f"of {total / 2**30:.2f} GiB, this process holding "
              f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB "
              f"({env['smi']})")
        launches = kill_and_resume(tag, [
            (f"x{s8} T=1", dict(T=1, shards=s8),
             dict(kill_at_step=DURABLE_KILL_STEP), want12[s8],
             f"12 (x{s8})"),
            (f"x{s2} T={MACRO_T} K={K}", dict(T=MACRO_T, shards=s2, K=K),
             dict(kill_in_commit=DURABLE_KILL_COMMIT), want13[s2, K],
             f"13a (x{s2}, K={K})")], tmp)
    launches = {f"durable clique {label}": n for label, n in launches.items()}
    launches.update(sharded_service(want12[s2], want13[s2, K], described,
                                    env))
    return launches


def sharded_service(want2, want2_k: dict, described: list, env: dict
                    ) -> dict:
    """Phase 14c: one ``DiscoveryService(device="cuda")`` batch of phase
    4's clique request at 2 shards (T = 1), the same at T = ``MACRO_T``
    with ``sync_every`` K, and the 2-shard request cut at 100 steps with
    checkpoints every 32; then, in a second call, that request resumed
    with the full budget.  They must give phase 12's 2-shard answer and
    counters, phase 13a's and, resumed, phase 12's again, each with phase
    4's results; ``masked_intersect`` launched once a shard an enqueued
    inner step of each task.  Returns the launches by path."""
    import tempfile
    import torch
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data.synthetic_graphs import planted_clique_graph
    from repro_torch.obs import Observability
    from repro_torch.service import (DiscoveryRequest, DiscoveryService,
                                     GraphRegistry)

    s2, K = SHARDED_DURABLE_MACRO
    t0 = time.perf_counter()
    registry = GraphRegistry()
    registry.register("clique", planted_clique_graph(**FULL_GRAPH))
    graphs_s = time.perf_counter() - t0
    svc = DiscoveryService(registry, observability=Observability(),
                           device="cuda")
    x2 = dict(graph="clique", workload="clique", **SERVICE_CLIQUE, shards=s2)
    macro = f"x{s2} T={MACRO_T} K={K}"
    with tempfile.TemporaryDirectory() as tmp, \
            task_launches() as by_request:
        truncated = dict(x2, **SERVICE_TRUNCATED, checkpoint_dir=tmp,
                         use_cache=False)
        # steps_per_sync and sync_every stay out of the result-cache key,
        # so the macro-step request skips the cache
        batch = [DiscoveryRequest(**x2, request_id=f"x{s2}"),
                 DiscoveryRequest(**x2, steps_per_sync=MACRO_T, sync_every=K,
                                  use_cache=False, request_id=macro),
                 DiscoveryRequest(**truncated,
                                  request_id=f"x{s2} truncated")]
        resume = DiscoveryRequest(**dict(truncated, step_budget=100_000),
                                  resume=True, request_id=f"x{s2} resumed")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        first = svc.serve(batch)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        committed = CheckpointManager(tmp).latest_step()
        t0 = time.perf_counter()
        second = svc.serve([resume])
        torch.cuda.synchronize()
        second_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()

    resp = {r.request_id: r for r in first + second}
    for rid, r in resp.items():
        if r.status != "ok":
            fail(f"service {rid}: {r.error}")
        print(f"[14 sharded service] {rid}: terminated={r.terminated} "
              f"latency_s={r.latency_s:.3f} keys={r.result_keys} "
              f"steps={r.stats['steps']} host_syncs={r.stats['host_syncs']} "
              f"syncs={r.stats['syncs']} rebalanced={r.stats['rebalanced']} "
              f"masked_intersect_launches={by_request.get(rid, 0)}")
    service_answer(resp[f"x{s2}"], want2, described, f"phase 12 (x{s2})")
    service_answer(resp[macro], want2_k, described, f"phase 13a ({macro})")
    service_answer(resp[f"x{s2} resumed"], want2, described,
                   f"phase 12 (x{s2})")
    cut = SERVICE_TRUNCATED["step_budget"]
    cut_resp = resp[f"x{s2} truncated"]
    checks = [
        (cut_resp.terminated == "step_budget"
         and cut_resp.stats["steps"] == cut == committed,
         f"truncated run: {cut_resp.stats['steps']} steps, newest "
         f"checkpoint {committed}"),
        (resp[f"x{s2} resumed"].terminated == "complete",
         "resumed: not complete"),
        (by_request[f"x{s2}"] == s2 * want2.steps
         and by_request[macro] == s2 * MACRO_T * want2_k.host_syncs
         and by_request[f"x{s2} truncated"] == s2 * cut
         and by_request[f"x{s2} resumed"] == s2 * (want2.steps - cut),
         f"masked_intersect launches by request {by_request}")]
    for ok, what in checks:
        if not ok:
            fail(f"sharded service: {what}")
    print(f"[14 sharded service] answers equal phases 12 and 13a (keys, "
          f"phase 4's results, every counter); the cut request resumed "
          f"from step {committed} to {want2.steps}; graph={graphs_s:.2f}s "
          f"batch={first_s:.3f}s resume={second_s:.3f}s "
          f"peak_mem={peak / 2**30:.2f}GiB ({env['smi']})")
    return {f"service clique x{s2}": by_request[f"x{s2}"],
            f"service clique {macro}": by_request[macro],
            f"service clique x{s2} resumed": by_request[f"x{s2} resumed"]}


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs an NVIDIA card")
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the "
             f"repository")
    sys.path.insert(0, str(SRC))

    from repro_torch.data.synthetic_graphs import planted_clique_graph

    if len(sys.argv) == 3 and sys.argv[1] == "--durable-child":
        return durable_child(json.loads(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--sharded-run":
        return sharded_child(json.loads(sys.argv[2]))
    env = phase_environment()
    if len(sys.argv) == 2 and sys.argv[1] == "--weighted":
        weighted = check_weighted_kernels(env)
        print(json.dumps({"kernels": weighted_kernel_entries(
            weighted, phase_weighted_main_path())}))
        return 0
    kernel = phase_kernels(env)
    children = check_clique_children(env)
    weighted = check_weighted_kernels(env)
    ragged = phase_coworkload_kernels()
    phase_quickstart_parity()
    launches, children_launches, comp, res, wall4_s = phase_main_path()
    weighted_launches = phase_weighted_main_path()
    idle_t1 = phase_profile(comp, res)
    cowork = phase_coworkload(planted_clique_graph(**FULL_GRAPH), ragged)
    phase_merge_topk()
    macro_launches, res8 = phase_macro_path(comp, res, idle_t1)
    sharded_launches, sharded12, walls12 = phase_sharded(comp, res, env)
    t13 = time.perf_counter()
    stale_launches, sharded13 = phase_sharded_macro(comp, res, sharded12,
                                                    env)
    print(f"[13] phase 13 wall={time.perf_counter() - t13:.1f}s")
    described = [comp.describe(row) for key, row in
                 zip(res.result_keys, res.result_states) if key > -2 ** 31]
    del comp
    iso, iso_run = phase_iso(env)
    pattern_launches = phase_patterns()
    t11 = time.perf_counter()
    durable_launches = phase_durable(res, wall4_s, res8)
    service_launches = phase_service(res, described, iso_run)
    phase_serve_cli()
    print(f"[11] phase 11 wall={time.perf_counter() - t11:.1f}s")
    t14 = time.perf_counter()
    sharded_durable_launches = phase_sharded_durable(
        sharded12, walls12, sharded13, described, env)
    print(f"[14] phase 14 wall={time.perf_counter() - t14:.1f}s")
    kernels = [dict(
        name="masked_intersect", route="cuda",
        source="src/repro_torch/kernels/csrc/masked_intersect.cu",
        replaces="src/repro/kernels/masked_intersect.py:96",
        launches=launches, max_abs_err=kernel["max_abs_err"],
        ms=kernel["ms"], plain_ms=kernel["plain_ms"],
        bound_ms=kernel["bound_ms"], bound_by=kernel["bound_by"],
        library_ms=None, variant=kernel["variant"], kernel=kernel["kernel"],
        tile_ms=kernel["tile_ms"], call_ms=kernel["call_ms"],
        masked_ms=kernel["masked_ms"], masked_tile_ms=kernel["masked_tile_ms"],
        int8_mm_ms=kernel["int8_mm_ms"],
        masked={k: v for k, v in iso.items() if k != "launches_by_t"},
        pattern_probes=kernel["pattern_probes"], cutover=kernel["cutover"],
        rows_max_cols=kernel["rows_max_cols"],
        launches_by_path={
            "clique T=1": launches, f"clique T={MACRO_T}": macro_launches,
            **{f"iso T={t}": n for t, n in iso["launches_by_t"].items()},
            **pattern_launches, **durable_launches, **service_launches,
            **sharded_launches, **stale_launches,
            **sharded_durable_launches})]
    kernels.append(dict(
        name="clique_children", route="cuda",
        source="src/repro_torch/kernels/csrc/clique_children.cu",
        replaces=None, launches=children_launches, library_ms=None,
        **children))
    kernels += weighted_kernel_entries(weighted, weighted_launches)
    for name, line in (("segment_matmul", 59), ("embedding_bag", 46),
                       ("flash_attention", 84)):
        # the fp32 record first; a bf16 one beside it where both run
        by_dtype = cowork[name]
        entry = dict(name=name, route="cuda",
                     source=f"src/repro_torch/kernels/csrc/{name}.cu",
                     replaces=f"src/repro/kernels/{name}.py:{line}",
                     **by_dtype["fp32"])
        if "bf16" in by_dtype:
            entry["bf16"] = by_dtype["bf16"]
        kernels.append(entry)
    print(f"[smoke] wall={time.perf_counter() - t_start:.1f}s (all phases, "
          f"the kernels' build included)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": env["name"],
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
