#!/usr/bin/env python3
"""Smoke test of exonerate_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, in the order they run, each of which raises on failure (the
script then exits non-zero and prints no result line); each prints the
second of the script at which it starts:

1. Device: a CUDA card must be visible; prints its name and power limit.
2. Build: compiles csrc/*.cu with nvcc into build/cuda/: the walk-back
   and T1, and one library per compiled plan of the wavefront (K1/K4 and
   K2's ring_kernel) and of the band scan that the phases launch (one nvcc per
   library, on the host's cores at once), and prints each build's
   seconds and each kernel's registers, stack frame and spill bytes.
3. K6/K7 vs plain: the band kernels against the plain PyTorch band scan,
   exactly (boundary bits, column best, live, xband, band_end per
   locus), on a ragged batch of synthetic est2genome pairs, a ner
   joint-span pair and, per split-codon model (protein2genome,
   coding2genome, cdna2genome), a ragged pair of jobs whose exons split
   codons of both phases (kernel K9 inside K7; tests/torch_sdp_cases.py),
   and the non-boundary models on K6/K7's TRACK_SID instantiation (their
   reverse pass hands K7 each seed's start score in place of boundary
   bits): a ragged affine:local batch with two seeds sharing a cell,
   ungapped, protein2dna and coding2coding; the plain passes, and
   run_kernel on the CPU (start scores included), in worker processes
   (read in phase 14).  Then the est2genome_genomic golden through the
   port's CLI on the forced device route, byte-equal to the golden
   (this first heuristic run also builds the host's native libraries,
   so that the scans are timed warm).
4. The est2genome scan at full width (the band kernels' first main
   path): 16 mutated calm cDNAs against a 1 Mb genome holding 8 spliced
   copies (benchmarks/genome_scan.py's recipe, rng 7), through the port's
   CLI with default routing, with 16 comparisons on cuda-sdp, K6/K7
   launched, no fallback, 16/16 queries spliced and no plain-scan pass;
   its output must equal the same CLI's with EXONERATE_TPU_SDP=native,
   byte for byte (run in a worker process, read in phase 14, as for the
   scans of phase 5).  K6/K7 are launched again on the scan's band batch,
   and worker processes start the plain passes over that batch on the
   CPU (over slices of the batch), to be held against the kernels'
   outputs in the last phase.
   b. K8, the cross-chip band scan (the CROSS instantiation of K6/K7),
   on a device list that repeats cuda:0 (the distinct cards where there
   are two or more): the scan's widest comparison cut into 2 and 4
   chunks through cuda_sdp.run_kernel_cross_chip, whose band_end, live
   and xband must equal its single K6/K7 launch; the 2-chunk chain's
   four launches made again, timed with CUDA events, and each held in a
   worker process to its plain version from the same halo (bits, live,
   column best, xband, edge planes, span registers).
   c. --cores 2: the same scan through the CLI with --cores 2 (the thread
   pool over comparisons, each worker on a CUDA stream of its own, the
   band scan's device tier once per comparison): its bytes must equal
   phase 4's, with the 16 comparisons on cuda-sdp, K6/K7 launched, no
   fallback and the launches on two streams; prints its wall time beside
   phase 4's and how long the workers' kernels ran beside each other
   (the host clock from each launch to its stream's end, on one
   timeline).
5. The split-codon paths (kernel K9), each through the port's CLI
   against the native route (the scans' in a worker process), byte for
   byte, with its kernels launched and
   no fallback but one: in the coding2genome scan the hybrid's locus
   cross-check disagrees on one comparison (the host's re-run of one
   locus alone scores 2008 where the band scan of the whole comparison
   scores 2007; the comparison goes to the host, as in the JAX package's
   device tier on the same input); a second one fails the script.
   After each scan K6/K7 run again on every launch the main path made of
   its band batch (the same comparisons, Qp and Wp), and the comparisons
   whose cross-check disagreed, else the widest, start their plain check
   in two more worker processes at the shape of their launch.
   a. coding2genome scan: the 16 cDNAs against the same recipe's genome
      cut at cDNA 251 and 402 (a phase-1 and a phase-2 intron of calm's
      CDS), default routing; its output holds split-codon (S) operations.
   b. protein2genome scan: 8 mutated calm proteins against that genome on
      the forced device route (EXONERATE_TPU_SDP=device; by default the
      149-residue queries stay under DEVICE_MIN_Q); no fallback.
   c. protein2genome -E yes: the calm protein against a 12 kb locus of
      the same three exons; the region scan and the path DP run on K1
      and K4 (optimal's native cut-over set to 100,000 cells for this
      run), against the native dense DP; S operations at both introns.
      The run's K1/K4 inputs are captured; each launch is made again and
      its plain version (with the walk-back's) starts in one more worker
      process.
   d. The non-boundary scans (K6/K7 built with TRACK_SID), on the forced
      device route: phase 4's 16 cDNAs under affine:local and phase 5b's
      8 proteins under protein2dna, against phase 4's genome.  Every
      comparison with seeds runs on the kernels (the pool plans a band
      only for those), the TRACK_SID launches are counted, no fallback
      but the hybrid's band-edge liveness (none expected), and the
      output equals the native route's (a worker process, read in phase
      14).  K6/K7 again on each launch of the scans' band batches (CUDA
      events; the ring route of each launch), then on the affine:local
      scan's widest comparison alone, held to the plain passes (start
      scores; column best, live, xband) in two worker processes.
   e. exonerate-server: the .esd / .esi of phase 4's genome built by the
      port's fasta2esd (--softmask FALSE) and esd2esi, through
      cli/fastautils.main as a user runs them; DeviceIndex over [cuda:0]
      and [cuda:0, cuda:0] (every card where there are two or more) on 4,096
      word-table words and two misses, equal to Index.lookup_word, timed
      by CUDA events; then two servers in threads of this process, the
      host index's and the device index's, and the port's CLI as their
      client on 4 of the cDNAs, est2genome and the default model: the
      two servers' outputs equal byte for byte, their vulgar lines the
      local run's on the genome FASTA.
   f. The row-scan tier (engine/sdp_rows.py, torch ops, no kernel): the
      first ROWS_PROTEINS of phase 5b's proteins, both strands, with
      EXONERATE_TPU_SDP=device and EXONERATE_TPU_SDP_ROWS=1 through the
      CLI; comparisons counted on sdp-rows, every row-pass output on the
      card; each row pass timed (host clock, synchronised), with its
      bucket's rows and sweeps.  In phase 14 the bytes must equal the
      same run's on the CPU, the engine counts and fallbacks the CPU
      run's, and the first bucket's row-pass outputs the CPU's field by
      field; against the native route no query may score higher (the
      JAX package's row tier reports a worse alignment for p1 on this
      input, ROADMAP Queue 3; the lines that differ are printed).  Both
      references run in worker processes.
   g. --multihost query: MH_RANKS processes on cuda:0 over gloo
      (127.0.0.1), phase 4's first MH_QUERIES cDNAs against its genome;
      rank 0's merged report equals one process's, the other ranks print
      their header and footer only.
   h. dryrun_multichip([cuda:0, cuda:0]) (parallel/dryrun.py): the
      sharded ungapped scan, K5, the sharded and target-tiled pair, the
      band batch over the devices and K8, each against one device, and
      sdp_hybrid.run_device taking K8; its launches counted.
   i. The host tools (cli/ipcress.py, no kernel): the port's ipcress on
      phase 4's genome with two experiments, each with primers cut
      around one planted gene copy (their exons match every copy, so
      several products come out), with the default flags and with
      --mismatch 1 --products TRUE; its stdout equals the C reference's
      build/ref/bin/ipcress on the same files (the phase fails where the
      binary is absent or not executable); both runs' host clock.
6. The SubOpt mask (kernel K3, the MASKED instantiation of K1/K4 and of
   the cluster kernel K2), each run through the port's CLI with no
   fallback:
   a. est2genome -E yes --bestn 2 --score 2000: calm (2175 bp) against a
      30 kb window holding two spliced copies of it, interleaved
      (tests/torch_split_cases.py two_copy_locus: exons at thirds, ~1%
      mutated, GT..AG gaps of 1200 bp, so each copy spans 8,425 bp and
      its box holds cells of the other's path).  The whole pair (65 M
      cells) and each copy's box (over 16 M) take the kernel route; every
      DP is B=1, whose cluster of two CTAs or more fits the card, so each
      runs on the cluster kernel with its ring in shared memory (region
      scans as K2, path DPs as K4 on a cluster), masked or not (K3 inside
      the masked ones), a DP of one CTA a pair on K1 / K4, each counted by
      its route; both copies spliced.
      The native dense DP route of the same CLI (cut-overs raised) runs
      in a worker process on a host core beside the card's phases, and
      its bytes are compared in phase 14.
      The widest masked region scan is timed on the cluster (kernel K3's
      row), mask-free there and once on K1 (the route it took until now,
      equal), and, with the first masked path DP on the cluster and its
      walk-back, held to the plain version in two more worker processes.
   b. The pooled locus heuristic (EXONERATE_TPU_HEURISTIC=locus) on
      phase 4's 16 cDNAs x 1 Mb genome with --bestn 10: at least one
      masked generation, K3 launched, K2 launched with its ring in shared
      memory (the batches whose clusters fit the card), 16/16
      queries spliced, its time beside phase 4's SDP route.  The first
      masked region batch, the first masked region batch of two or more
      pairs on the cluster kernel, and the first masked path batch are
      launched again, each on the route its launch took on the main path
      (the cluster kernel or K1/K4), whole and on a sub-batch of their two
      widest pairs, held to the full batch's results for those pairs and,
      in two more worker processes, to the plain versions.
   c. K5, the sharded locus prescan: 6b's first-generation region batch
      through cuda_wavefront.find_batched_sharded over [cuda:0, cuda:0]
      (the distinct cards where there are two or more), equal to that
      generation's results on K1 (find_batched(stream=False), which must
      equal the results of its route, K2 where its clusters fit); the
      widest shard of its chunk with the most cells launched again,
      timed, and held to the plain version in a 6b worker process.
7. K1 vs plain: est2genome, calm (tests/golden/data/all4.fa record 1)
   against itself, 2175x2175, B=64, score and region modes (the plain
   versions in worker processes, read in phase 14), plus a ragged
   batch and the model zoo (its plain versions in a worker process,
   read in phase 14); the split-codon plans: the calm protein
   against 8 windows of the 12 kb locus (score, region, path; plain in
   worker processes), the coding2genome and cdna2genome split pairs; the
   protein2genome -E run's first widest region scan on its own inputs
   (B=1, Qp 256 x Tp 12288), timed for kernel K9's row (its plain check
   runs in phase 5c's worker process).  Times with CUDA events.
8. K4 + walk-back vs plain and vs the native dense DP, calm 2175^2 path
   (K4's plain version in a worker process, the walk-back's on the card),
   and the shared-memory load-to-use latency by a pointer chase on the
   card: the walk-back's chain floor, a latency per step.
9. Chromosome-scale -E yes (kernel K2, the cluster kernel ring_kernel):
   a. K2 through find_batched(stream=True) on forced batches: a ragged
      est2genome B=3 at Qp 2304 (C = 9), a Qp 256 pair (C = 1), a Qp 768
      pair of 601 rows (a part-filled last CTA), the protein2genome split
      pair (FULL, K9) and a small masked pair (K3); each launch is held to
      the plain version in a worker process: the est2genome ones with the
      carry ring in shared memory, the protein2genome region pair with it
      in global memory (both ring routes must appear).  Then every
      cluster instantiation that steps b-e launch is launched once, so
      that none loads beside K1's side check.
   b. est2genome -E yes --bestn 2 --score 5000 --revcomp no through the
      CLI (the forward strands: the reverse strand's one scan finds
      nothing over 5000): calm against a 1.2 Mb random genome holding two
      spliced copies of it at 300 kb and 800 kb
      (tests/torch_split_cases.py chromosome_locus: exons at thirds, ~1%
      mutated, GT..AG introns of 3,125 bp, so each copy spans 8,425 bp
      and its box stays over 16 M cells).  Every
      whole-target region scan (Qp 2304 x Tp 1,356,288, B=1, 26 MB by the
      JAX package's streaming test) must run on K2 with C > 1, masked
      after the first of its strand (K3 inside K2); the copies' boxes on
      the cluster too (K2, K4 on a cluster), none on K1; two spliced
      vulgar lines; no fallback.  Per scan: K2 ms
      (CUDA events), C, the footprint, the host seconds of input and mask
      prep, and a host-clock breakdown.  The first scan's inputs go to K1
      on a side stream of their own (one CTA on one SM, beside the rest of
      the phase and phases 10-11; the script syncs streams, not the
      device, for this), held to K2's output in phase 14.
      --score 5000, not 2000, bounds the run's length: past both copies
      the loop would keep chains of random short exons across the target,
      each a whole-target scan plus a checkpointed traceback.
   c. K2 on a 6 kb window around the first copy under the mask of the
      run's first alignment, held to the plain version in a worker.
   d. The third forward iteration's path DP at --score 2000: the best
      alignment left under both copies' masks (a 2306-point chain across
      1.145 Mb) through optimal.find_path on its box.  Its cube is over
      the card's budget and its native traceback over the host's, so it
      runs the checkpointed traceback: forward segments on K2, the walk
      back re-running segments from saved carry rings on K4 on a cluster
      and walking each on the card (the walk-back kernel's segment entry
      point, its launches and summed ms by CUDA events).
      Its score and box must equal the third scan's and no match step may
      enter a masked cell; the first 1,200 diagonals of the walk's first
      segment are held to the plain version from the same rings in a
      worker; the segment walk is held to the plain version exactly over
      CK_WALK_DIAGS diagonals of a walked segment's planes from the
      path's cell at their top (ops, exit cell, state and status), and
      its ops to that stretch of the path.
   e. K2 (region, masked) at the main path's shape against the plain
      version: the first masked whole-target scan's inputs over 1,200
      diagonals through the first copy's cells, continuing the carry
      rings of a launch over the diagonals before them; the plain version
      runs the same span from the same rings in a worker.  The same span
      is timed with the ring in global memory (equal), and with an empty
      plan: the per-diagonal floor of the cluster barrier, the cells'
      state and ring writes and the halo copy.
   Each copy's vulgar line must equal the native route's (the same CLI
   with the cut-overs raised, in worker processes started in phase 6a)
   on a 20 kb window around it, target coordinates shifted.
10. CLI end to end: the port's CLI must reproduce the exhaustive_est2genome
    golden byte for byte and give vulgar score 10875 on calm x calm, with
    the kernels' launch counters above 0 and no engine fallback.
11. K6/K7 on the est2genome_genomic comparison of phase 3, timed with
    CUDA events; their plain passes in two worker processes, held to the
    kernels' outputs exactly in phase 14.
12. K8 at reduced shapes: the synthetic cases of tests/torch_sdp_cases.py
    that phase 4b's est2genome comparison does not cover, cut 2 and 3
    ways: ner_joint_span, span_cut (an intron span frozen in one chunk
    and thawed in the next) and c2g_split (kernel K9 inside a CROSS
    forward pass): every CROSS launch must equal its plain version on the
    card exactly (bits, live, column best, xband, edge planes, span
    registers) and each chain the single launch.
13. genome2genome -E yes on the generic wavefront (torch ops on the card,
    the model the kernels refuse): the first 300 bp of cdna_mut.fa against
    genome.fa 2990-3330 with the native traceback budget and --dpmemory at
    1 MB, so that every path DP is checkpointed, forward strands only
    (--revcomp no), through the CLI; only the generic engine counted; its
    bytes must equal the same run on the CPU (a worker process started in
    phase 4).
14. The plain checks of the worker processes: every slice's plain pass
    must equal the kernels' outputs exactly (bits, live; column best,
    live, xband), and every K1/K2/K4 launch handed to them its plain
    version (scores, ends, starts; traceback cube, walk-back), and every
    K8 launch handed to them its plain version; phase 3's run_kernel on
    the CPU; phase 5f's references; the native routes' bytes (phases
    4-6a and 9) and the
    genome2genome CPU run's (phase 13); K1 at the full shape against K2;
    the span launches of phases 9d-e; phase 7's model zoo.
15. T1, the elementwise-throughput probe (exonerate_tpu_torch/tools/
    vpu16.py, on no CLI path): each of its nine (dtype, op mix) cases
    held to the plain loop of torch ops on the card exactly at the full
    B x W and 64 steps, int32 mix also at the full 4352 steps (timed
    beside the kernel); then every case timed through the tool's own
    entry (best of 5, CUDA events) and its launches counted; a rate over
    the card's peak for the dtype fails (the compiler removed work), and
    so does a build that issues fewer instructions than the ops it counts
    (the SASS of each instantiation, from cuobjdump).

The device index of phase 5e, the row-scan tier of phase 5f and the
multi-device routes of phases 5g-h but K5 and K8 are torch ops (or
gloo), not kernels (the JAX package's are shard_map, jnp and XLA's
lax.scan), and have no row in the kernels line; nor have phase 5i's host
tools, host code in both packages.
K5 and K8 are the JAX package's multi-device routes; on one card they
check every shard, chunk and halo and time the kernels, but cannot show
the overlap of several cards.  Phases 3-13 run on the card while the
plain checks and the native routes run on the host's cores, so their
host-clock and plain times share the host with them.

The last three lines are nvidia-smi's name and power limit of the card,
a JSON object of the kernels (route, source, the TPU kernel each
replaces, main-path launches, max |kernel - plain|, kernel and plain
milliseconds (the plain version on the card for the walk-back, on one
host core in a worker process for the others; K5's over the widest
chunk's shards of phase 6c and K8's over the 2-chunk chain of phase 4b,
each plain launch on its own core and summed; K2's over phase 9e's span
of the chromosome's diagonals, as the plain loop would take hours over
all of them), the bound: the larger of the bytes moved over 3.35 TB/s
and the int32 operations over the int32 peak (for the walk-back's two
entry points the larger of the bytes and the chain floor, a shared-
memory load-to-use latency per step), and the library call:
none computes these DPs; T1's row, int32 mix, with 0 main-path launches
and its tool's launches beside them, its plain loop on the card), and
the result object.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "tests", "golden", "data")
CALM_LEN = 2175
CALM_SELF_SCORE = 10875
BATCH = 64
SCAN_QUERIES, SCAN_LEN = 16, 1_000_000
SCAN_REV_CHUNKS, SCAN_FWD_CHUNKS = 2, 3  # plain-check worker processes
DEADLINE_S = 1100                        # the plain checks' last moment
# the card's peaks for the bound (NVIDIA H100 SXM data sheet: 3.35 TB/s
# of HBM3; 132 SMs at 1.98 GHz boost): 32-bit integer adds issue on the
# integer pipe (IADD3) and on the multiply-add pipe (IMAD.IADD), 64 a
# clock per SM each in the CUDA C++ Programming Guide's table for compute
# capability 9.0, so 128 int32 operations a clock per SM (T1's int32 add
# chain, one instruction per add, ran at 91 a clock, over the 64 of
# either pipe alone): 33.5 T int32 operations/s
HBM_BYTES_S = 3.35e12
CLOCK_HZ = 1.98e9
INT32_OPS_S = 128 * 132 * CLOCK_HZ
# worker pools and temporary directories, closed when the script ends
_EXIT = contextlib.ExitStack()
SCAN_ARGV = ["-m", "est2genome", "--bestn", "1", "--maxintron", "20000",
             "--showvulgar", "yes", "--showalignment", "no"]
C2G_ARGV = ["-m", "coding2genome", "--bestn", "1", "--maxintron", "20000",
            "--showvulgar", "yes", "--showalignment", "no"]
P2G_ARGV = ["-m", "protein2genome", "--bestn", "1", "--maxintron", "20000",
            "--showvulgar", "yes", "--showalignment", "no"]
P2G_E_CUTOVER = 100_000      # optimal.NATIVE_TPU_CELLS for the p2g -E run
# phase 5d, the non-boundary models on the forced device route (K6/K7
# built with TRACK_SID): phase 4's cDNAs under affine:local and phase 5b's
# proteins under protein2dna, against phase 4's genome
NB_SCANS = (("affine:local", "q"), ("protein2dna", "p"))
NB_ARGV = ["--bestn", "1", "--showvulgar", "yes", "--showalignment", "no"]
# phase 5e, exonerate-server: word-table words looked up on the device
# index (plus two misses), and the cDNAs the client aligns
SRV_WORDS = 4096
SRV_QUERIES = 4
# phase 5i, ipcress: primers cut around the planted gene copies IPCRESS_GENES
# of phase 4's genome (A the copy's first IPCRESS_PRIMER bases, B the
# reverse complement of the IPCRESS_PRIMER bases that end IPCRESS_PRODUCT
# bases on), a product window of IPCRESS_WINDOW, and the flag sets run
IPCRESS_GENES = (1, 5)
IPCRESS_PRIMER, IPCRESS_PRODUCT, IPCRESS_WINDOW = 20, 1500, (1000, 2000)
IPCRESS_FLAGS = ([], ["--mismatch", "1", "--products", "TRUE"])
# phase 5f, the row-scan tier (engine/sdp_rows.py, torch ops): the first
# ROWS_PROTEINS of phase 5b's proteins, both strands, on the forced device
# route with the rows knob set
ROWS_PROTEINS = 2
ROWS_ENV = {"EXONERATE_TPU_SDP": "device", "EXONERATE_TPU_SDP_ROWS": "1"}
# phase 5g, --multihost query: MH_RANKS processes on cuda:0 over gloo, phase
# 4's first MH_QUERIES cDNAs against its genome, each rank given MH_TIMEOUT s
MH_RANKS, MH_QUERIES, MH_TIMEOUT = 2, 2, 240
# the -E yes Waterman-Eggert window: calm's two copies interleaved from
# WE_START, GT..AG gaps of WE_GAP (each copy spans 8,425 bp), WE_LEN bp in
# all; --score WE_SCORE ends the run after both copies (calm's internal
# repeats give local alignments of a few hundred, each one more masked
# iteration of the whole window)
WE_GAP, WE_LEN, WE_START, WE_SCORE = 1200, 30_000, 9000, 2000
# phase 9, chromosome-scale -E yes (kernel K2): calm against CH_LEN bp
# holding a spliced copy of it at each of CH_STARTS (introns of CH_INTRON
# bp, so each copy spans CH_SPAN bp and its box, 18.3 M cells, stays over
# the 16 M cells up to which a masked path DP runs on the host); each
# copy's alignment is held to the native route on a CH_WIN window of it.
# --score CH_SCORE bounds the run's length, not a fault: once both copies
# are masked, the best local alignment left is a chain of short exons
# joined by introns of up to 200 kb across the random sequence, 2306 over
# 1.145 Mb.  At --score CH_PATH_SCORE the loop would keep
# that chain and go on to the next ones (how many score over 2000 is not
# measured), each a whole-target scan plus a checkpointed traceback
# across the target (~110 s here), up to 16 per strand.  Step 9d runs
# that third iteration's path DP at CH_PATH_SCORE instead: the one that
# raised NotImplementedError before the checkpointed traceback was
# ported.  The copies score 10,664-10,685.
CH_LEN, CH_STARTS, CH_INTRON = 1_200_000, (300_000, 800_000), 3125
CH_WIN, CH_SCORE, CH_PATH_SCORE = 20_000, 5000, 2000
# step 9e: K2 (region, masked) over CH_SPAN_DIAGS diagonals from
# CH_SPAN_AT, continuing the rings of a launch over [0, CH_SPAN_AT): the
# first copy's cells under its own mask, held to the plain version
CH_SPAN_AT, CH_SPAN_DIAGS = 302_000, 1200
# step 9d: the segment walk-back held to its plain version over this many
# diagonals (at least CH_SPAN_DIAGS) of a walked segment's planes
CK_WALK_DIAGS = 2048
CH_SPAN = CALM_LEN + 2 * CH_INTRON
LOCUS_ARGV = ["-m", "est2genome", "--bestn", "10", "--maxintron", "20000",
              "--showvulgar", "yes", "--showalignment", "no"]
# phase 13, genome2genome -E yes on the generic wavefront: the first 300
# bp of cdna_mut.fa against genome.fa[2990:3330] (where they align), with
# the native traceback budget and --dpmemory at 1 MB, so that every path
# DP is past the host's budget and checkpointed (the CPU tests' cut);
# --score 1000 keeps the loop to the cut's best alignment, and --revcomp
# no to the forward strands (2 path DPs, not the CPU test's 6: each
# diagonal step of the generic wavefront is ~1,500 small launches, ~20 ms
# on the card)
G2G_CUT = (300, 2990, 3330)
G2G_ARGV = ["-m", "genome2genome", "-E", "yes", "--dpmemory", "1",
            "--score", "1000", "--revcomp", "no", "--showvulgar", "yes"]
G2G_BUDGET = 1 << 20
# phase 15, T1: the steps at which each case is held to the plain loop on
# the card (int32 mix also at tools/vpu16.py's full 4352)
T1_CHECK_STEPS = 64
# K8: the chunk counts of the widest scan comparison (phase 4b), and the
# synthetic cases (tests/torch_sdp_cases.py) whose every CROSS launch is
# held to its plain version on the card, with their chunk counts (phase 12)
K8_SPLITS = (2, 4)
K8_CASES = (("ner_joint_span", 3), ("span_cut", 2), ("c2g_split", 2))
CROSSCHECK = "sdp device->host: locus score mismatch"
LIVENESS = "sdp device->host: band edge liveness"
# the one comparison of the coding2genome scan whose locus cross-check
# disagrees (query 9, 2008 != 2007), as in the JAX package's device tier
C2G_MAX_CROSSED = 1


def _card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return proc.stdout.strip().splitlines()[0]


def _mark(t_start: float, phase: str):
    """Print when a phase starts, in seconds since the script started."""
    print(f"-- phase {phase}: at {time.perf_counter() - t_start:.1f} s",
          flush=True)


def _sync():
    """Wait for the current stream, not the device: phase 9 runs K1 on a
    side stream of its own beside the rest of the phase."""
    torch.cuda.current_stream().synchronize()


def _cuda_ms(fn, reps: int = 1) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    _sync()
    return start.elapsed_time(end) / reps


def _cuda_call(fn):
    """(fn(), its milliseconds by CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    _sync()
    return out, start.elapsed_time(end)


def _turns(plain, kernel, kernel_reps: int = 3):
    """Warm up the kernel, then time kernel, plain, kernel.  The plain
    loop runs once (its time is bound by the host's launch rate) and its
    output is returned for the caller's check: (kernel output, plain
    output, kernel ms, plain ms)."""
    got = kernel()
    _sync()
    k1 = _cuda_ms(kernel, kernel_reps)
    want, p = _cuda_call(plain)
    k2 = _cuda_ms(kernel, kernel_reps)
    return got, want, (k1 + k2) / 2, p


def _max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.long() - b.long()).abs().max().item()) if a.numel() else 0


def _bound(n_bytes: float, n_ops: float):
    """(least ms the card could take, what bounds it)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, n_ops / INT32_OPS_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _tb_valid(ki, tb: torch.Tensor, d0: int = 0) -> torch.Tensor:
    """The cells of K4's traceback cube (B, D, S, W), or of a segment's
    planes from diagonal ``d0``, that lie inside each pair's DP (cell
    (i, d - i) with i <= qlen and d - i <= tlen): the kernel leaves the
    others unwritten."""
    qlen = ki.dims[:, 2].long()[:, None, None]
    tlen = ki.dims[:, 3].long()[:, None, None]
    d = d0 + torch.arange(tb.shape[1], device=tb.device)[None, :, None]
    i = torch.arange(tb.shape[3], device=tb.device)[None, None, :]
    ok = (d - i >= 0) & (d - i <= tlen) & (i <= qlen)
    return ok[:, :, None, :].expand_as(tb)


def _smem_load_clocks(cw, n: int = 20_000) -> float:
    """Clocks per load of a chain of ``n`` dependent shared-memory loads
    (``smem_chase_launch`` in csrc/walkback.cu): the walk-back's floor
    per step."""
    import ctypes
    fn = cw._lib("walkback", "smem_chase_launch",
                 [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    out = torch.zeros(2, dtype=torch.int64, device="cuda")
    rc = fn(n, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"smem chase launch failed: CUDA error {rc}")
    _sync()
    return out[0].item() / n


def _chain_floor_ms(steps: int, clocks: float) -> float:
    """The least time of a walk of ``steps`` dependent steps, one
    shared-memory load-to-use latency each, at 1.98 GHz."""
    return steps * clocks / CLOCK_HZ * 1e3


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _wave_work(ki, out_bytes: int, span=None):
    """Bytes (inputs read once, outputs written once) and int32 operations
    (an add and a compare per plan row per valid cell) of one K1/K4
    launch on ``ki``; over the diagonals ``span`` = (d0, d1) only, the
    columns of the target vectors and mask rows they read and the carry
    rings read and written, when given."""
    dims = ki.dims.long()
    if span is None:
        cells = int(((dims[:, 2] + 1) * (dims[:, 3] + 1)).sum())
        n_in = _nbytes(ki.plan, ki.ring_row, ki.lane_row, ki.dims, ki.qvecs,
                       ki.tvecs, ki.tables, ki.scalars, ki.blocked)
        return n_in + out_bytes, 2 * cells * ki.plan.shape[0]
    d = torch.arange(*span, device=dims.device)[None, :]
    lo = (d - dims[:, 3:4]).clamp(min=0)
    hi = torch.minimum(d, dims[:, 2:3])
    cells = int((hi - lo + 1).clamp(min=0).sum())
    cols = span[1] - span[0] + ki.Qp + 1
    frac = min(1.0, cols / (ki.Tp + 1))
    n_in = (_nbytes(ki.plan, ki.ring_row, ki.lane_row, ki.dims, ki.qvecs,
                    ki.tables, ki.scalars)
            + frac * _nbytes(ki.tvecs, ki.blocked)
            + 2 * 4 * ki.batch * (ki.K + 1) * (max(ki.NR, 1)
                                               + max(ki.NL, 1)) * (ki.Qp + 1))
    return n_in + out_bytes, 2 * cells * ki.plan.shape[0]


def _band_work(bi, forward: bool):
    """Bytes and int32 operations (an add and a compare per candidate per
    valid band cell) of one K6 (reverse) or K7 (forward) launch; what K6
    hands K7 is the boundary bits, or a non-boundary model's per-seed
    start scores."""
    dims = bi.dims.long()
    cells = int(((dims[:, 0] + 1) * (dims[:, 1] + 1)).sum())
    bits = bi.batch * 4 * (bi.n_seed if bi.track_sid
                           else bi.Dp * bi.n_words)
    n_in = _nbytes(bi.fwd_plan if forward else bi.rev_plan, bi.spans,
                   bi.dims, bi.qvecs, bi.tvecs, bi.scalars)
    out = bi.batch * 4 * ((bi.Wp + 1) + 2 if forward else 1)
    plan = bi.fwd_plan if forward else bi.rev_plan
    return n_in + bits + out, 2 * cells * plan.shape[0]


def _synthetic_sdp_jobs():
    """A ragged est2genome batch (single exon, two exons with an intron,
    two seeds in one column, two distant loci), a ner joint-span pair
    and, per split-codon model, its split case with its wide-flanked
    twin, from the cases of tests/torch_sdp_cases.py; then the
    non-boundary models (the TRACK_SID instantiation): a ragged
    affine:local batch (two seeds sharing a cell among them), ungapped,
    protein2dna and coding2coding."""
    import torch_sdp_cases as tc
    e2g = tc.case("single_exon")[0]
    ragged = [tc.case(n, e2g)[1:] for n in (
        "single_exon", "two_exons_intron", "seed_layers_same_column",
        "distant_loci")]
    ner, pair, plan = tc.case("ner_joint_span")
    out = [(e2g, ragged), (ner, [(pair, plan)])]
    for name in tc.SPLIT_CASES:
        m = tc.case(name)[0]
        out.append((m, [tc.case(n, m)[1:] for n in (name, name + "_wide")]))
    local = tc.case("affine_local")[0]
    out.append((local, [tc.case(n, local)[1:] for n in (
        "affine_local", "affine_local_two_bands", "affine_local_wide",
        "sid_shared_cell")]))
    for name in ("ungapped", "protein2dna", "coding2coding"):
        m, pair, plan = tc.case(name)
        out.append((m, [(pair, plan)]))
    return out


def _band_vs_plain(bi, label):
    """K6 then K7 against the plain passes on the same inputs, exactly.
    Returns (max |kernel - plain| over bits and column best, plain
    reverse ms, plain forward ms) with the plain passes timed by CUDA
    events."""
    from exonerate_tpu_torch.engine import cuda_sdp as cs
    from exonerate_tpu_torch.engine import sdp_device as sd
    bits, live_r = cs.band_reverse(bi)
    colbest, live_f, xband = cs.band_forward(bi, bits)
    (p_bits, p_live_r), p_rev = _cuda_call(lambda: sd.plain_band_reverse(bi))
    (p_col, p_live_f, p_xb), p_fwd = _cuda_call(
        lambda: sd.plain_band_forward(bi, p_bits))
    err = max(_max_err(bits, p_bits), _max_err(colbest, p_col))
    if err or not (torch.equal(bits, p_bits) and torch.equal(colbest, p_col)
                   and torch.equal(live_r, p_live_r)
                   and torch.equal(live_f, p_live_f)
                   and torch.equal(xband, p_xb)):
        raise RuntimeError(f"K6/K7 {label}: kernel != plain (max err {err})")
    return err, p_rev, p_fwd


_BATCH_FIELDS = ("dims", "qvecs", "tvecs", "scalars")


def _plain_check(path: str, forward: bool, idx: list):
    """Worker process, CPU only: the plain pass over comparisons ``idx``
    of the band batch saved at ``path``, held against the kernels'
    outputs saved with it (the forward pass reads K6's bits, which the
    reverse workers hold to the plain reverse pass).  Returns (equal,
    max |kernel - plain|, seconds, diagonals walked)."""
    import dataclasses
    from exonerate_tpu_torch.engine import sdp_device as sd
    torch.set_num_threads(1)
    saved = torch.load(path, weights_only=True)
    ix = torch.tensor(idx)
    bi = sd.BandInputs(**saved["bi"])
    bi = dataclasses.replace(bi, **{f: getattr(bi, f)[ix]
                                    for f in _BATCH_FIELDS})
    t0 = time.perf_counter()
    if forward:
        got = sd.plain_band_forward(bi, saved["bits"][ix])
        want = [saved[k][ix] for k in ("colbest", "live_f", "xband")]
    else:
        got = sd.plain_band_reverse(bi)
        want = [saved[k][ix] for k in ("bits", "live_r")]
    secs = time.perf_counter() - t0
    return (all(torch.equal(g, w) for g, w in zip(got, want)),
            max(_max_err(g, w) for g, w in zip(got, want)), secs,
            int((bi.dims[:, 0] + bi.dims[:, 1]).max()) + 1)


def _start_plain_check(label, bi, outs: dict, tmp: str, tasks: list,
                       pool=None):
    """Save the batch and the kernels' outputs under ``tmp`` and start the
    plain passes in worker processes, one per (forward, comparisons)
    task (on ``pool`` when given).  Returns (pool, [(label and pass, idx,
    async result)])."""
    path = os.path.join(tmp, f"{label.replace(' ', '_')}_band.pt")
    torch.save({"bi": _cpu_fields(bi),
                **{k: v.cpu() for k, v in outs.items()}}, path)
    pool = pool or _pool(len(tasks))
    return pool, [(f"{label} {'K7' if fwd else 'K6'}", [int(b) for b in idx],
                   pool.apply_async(_plain_check,
                                    (path, fwd, [int(b) for b in idx])))
                  for fwd, idx in tasks]


def _cpu_fields(obj) -> dict:
    """A dataclass's fields, tensors moved to the CPU (to be saved)."""
    import dataclasses
    return {f.name: (lambda v: v.cpu() if torch.is_tensor(v) else v)(
        getattr(obj, f.name)) for f in dataclasses.fields(obj)}


def _pool(n: int):
    """n spawned worker processes, ended when the script ends.  They run
    at a lower priority (nice 10): the main process drives the card, and
    its plain versions on the card are bound by how fast it issues
    launches, so it must not wait for a host core behind the workers."""
    import multiprocessing
    pool = multiprocessing.get_context("spawn").Pool(
        n, initializer=os.nice, initargs=(10,))
    _EXIT.callback(pool.join)
    _EXIT.callback(pool.terminate)
    return pool


def _cpu_cli(argv: list, env: dict = None, tpu_cells: int = None,
             tb_budget: int = None):
    """Worker process, CPU only: the port's CLI over ``argv`` under the
    knobs ``env``, with optimal's native cut-over raised over
    ``tpu_cells`` cells and its native traceback budget at ``tb_budget``
    bytes when given (the references of phases 4-6, 9 and 13).  Returns
    (output, host seconds, engine counts, fallback counts)."""
    for knob in ("EXONERATE_TPU_SDP", "EXONERATE_TPU_HEURISTIC"):
        os.environ.pop(knob, None)
    os.environ.update(env or {})
    os.environ["EXONERATE_TPU_TORCH_DEVICE"] = "cpu"
    sys.path.insert(0, ROOT)
    from exonerate_tpu_torch import observe
    from exonerate_tpu_torch.cli.exonerate import main as cli_main
    from exonerate_tpu_torch.engine import optimal
    torch.set_num_threads(1)
    if tpu_cells is not None:
        optimal.NATIVE_TPU_CELLS = tpu_cells + 1
    if tb_budget is not None:
        optimal.NATIVE_TB_BUDGET = tb_budget
    observe.reset()
    buf = io.StringIO()
    t0 = time.perf_counter()
    if cli_main(argv, out=buf) != 0:
        raise RuntimeError(f"CLI exit status for {argv}")
    return (buf.getvalue(), time.perf_counter() - t0,
            dict(observe.engine_counts), dict(observe.fallback_counts))


def _rows_cpu(argv: list):
    """Worker process, CPU only: the port's CLI over ``argv`` on the
    forced row-scan route (phase 5f's reference).  Returns (output, host
    seconds, engine counts, fallback counts, the row pass's outputs per
    bucket as numpy dicts)."""
    os.environ.update(ROWS_ENV)
    os.environ["EXONERATE_TPU_TORCH_DEVICE"] = "cpu"
    sys.path.insert(0, ROOT)
    from exonerate_tpu_torch import observe
    from exonerate_tpu_torch.cli.exonerate import main as cli_main
    from exonerate_tpu_torch.engine import sdp_rows
    torch.set_num_threads(1)
    buckets = []
    real_get_fn = sdp_rows.get_fn

    def spy(*args, **kwargs):
        fn = real_get_fn(*args, **kwargs)

        def kept(inputs, device=None):
            out = fn(inputs, device=device)
            buckets.append({k: v.numpy() for k, v in out.items()})
            return out
        return kept
    sdp_rows.get_fn = spy
    observe.reset()
    buf = io.StringIO()
    t0 = time.perf_counter()
    if cli_main(argv, out=buf) != 0:
        raise RuntimeError(f"CLI exit status for {argv}")
    return (buf.getvalue(), time.perf_counter() - t0,
            dict(observe.engine_counts), dict(observe.fallback_counts),
            buckets)


def _best_scores(out: str) -> dict:
    """Each query's best vulgar score in a CLI output."""
    best: dict = {}
    for line in out.splitlines():
        if line.startswith("vulgar: "):
            f = line.split()
            best[f[1]] = max(best.get(f[1], int(f[9])), int(f[9]))
    return best


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _multihost(argv: list, axis: str) -> tuple:
    """``argv`` with ``--multihost axis`` in MH_RANKS processes on cuda:0
    over gloo (127.0.0.1).  Returns (each rank's stdout, host seconds)."""
    env = dict(os.environ, PYTHONPATH=ROOT, WORLD_SIZE=str(MH_RANKS),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
    env.pop("EXONERATE_TPU_TORCH_DEVICE", None)
    cmd = [sys.executable, "-m", "exonerate_tpu_torch.cli.exonerate"] + \
        argv + ["--multihost", axis]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd, env=dict(env, RANK=str(r),
                                            LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, cwd=ROOT)
             for r in range(MH_RANKS)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=MH_TIMEOUT))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    secs = time.perf_counter() - t0
    bad = [(r, proc.returncode, outs[r][1][-2000:])
           for r, proc in enumerate(procs) if proc.returncode != 0]
    if bad:
        raise RuntimeError(f"--multihost {axis}: ranks failed: {bad}")
    return [o for o, _e in outs], secs


def _synthetic_run_kernel(k: int):
    """Worker process, CPU only: ``cuda_sdp.run_kernel`` on the CPU (the
    plain passes) over batch ``k`` of ``_synthetic_sdp_jobs``, phase 3's
    reference for the card's.  Returns its per-job dicts."""
    from exonerate_tpu_torch.engine import cuda_sdp as cs
    torch.set_num_threads(1)
    bmodel, jobs = _synthetic_sdp_jobs()[k]
    return cs.run_kernel(bmodel, jobs, jobs[0][0].args.dropoff,
                         torch.device("cpu"))


def _k8_chain(cs, sd, chunks, plain: bool = False):
    """K8's passes over a comparison's chunks (``cs.cross_chunks``): the
    reverse pass right to left, then the forward pass left to right, each
    launch on the kernel or, with ``plain``, on its plain version, on its
    chunk's device (the halo moved there).  Returns [(launch, its halo
    in, its outputs)] in launch order."""
    rev = sd.plain_band_reverse if plain else cs.band_reverse_cross
    fwd = sd.plain_band_forward if plain else cs.band_forward_cross
    out = []
    bits = [None] * len(chunks)
    halo = sd.blank_halo(chunks[-1][2], False)
    for cx in range(len(chunks) - 1, -1, -1):
        halo = halo.to(chunks[cx][2].dims.device)
        res = rev(chunks[cx][2], halo)
        out.append((("rev", cx), halo, res))
        bits[cx], halo = res[0], res[-1]
    halo = sd.blank_halo(chunks[0][2], True)
    for cx in range(len(chunks)):
        halo = halo.to(chunks[cx][2].dims.device)
        res = fwd(chunks[cx][2], bits[cx], halo)
        out.append((("fwd", cx), halo, res))
        halo = res[-1]
    return out


def _halo_tensors(res) -> list:
    """The tensors of one K8 launch's outputs, its outgoing Halo's too."""
    *main, halo = res
    return list(main) + [t for t in (halo.sc, halo.pm, halo.ln, halo.span)
                         if t is not None]


def _save_cross(path: str, bi, halo, bits, res) -> str:
    """Save one K8 launch for ``_plain_cross_check``: its chunk, the halo
    it read, K6's bits of the chunk (forward) and its outputs."""
    torch.save({"bi": _cpu_fields(bi),
                "halo": [None if t is None else t.cpu()
                         for t in (halo.sc, halo.pm, halo.ln, halo.span)],
                "bits": None if bits is None else bits.cpu(),
                "out": [t.cpu() for t in _halo_tensors(res)]}, path)
    return path


def _plain_cross_check(path: str):
    """Worker process, CPU only: the plain pass of one K8 launch saved at
    ``path`` (``_save_cross``) from the same halo, held against the
    kernel's outputs: bits and live (reverse) or column best, live and
    xband (forward), and the outgoing edge planes and span registers.
    Returns (equal, max |kernel - plain|, seconds, diagonals walked)."""
    from exonerate_tpu_torch.engine import sdp_device as sd
    torch.set_num_threads(1)
    saved = torch.load(path, weights_only=True)
    bi = sd.BandInputs(**saved["bi"])
    halo = sd.Halo(*saved["halo"])
    t0 = time.perf_counter()
    if saved["bits"] is None:
        res = sd.plain_band_reverse(bi, halo)
    else:
        res = sd.plain_band_forward(bi, saved["bits"], halo)
    secs = time.perf_counter() - t0
    got, want = _halo_tensors(res), saved["out"]
    ok = len(got) == len(want) and all(torch.equal(a, b)
                                       for a, b in zip(got, want))
    err = max((_max_err(a, b) for a, b in zip(got, want)
               if a.shape == b.shape), default=0)
    return ok, err, secs, int((bi.dims[:, 0] + bi.dims[:, 1]).max()) + 1


def _k8_work(cs, chunks):
    """Bytes and int32 operations of K8's launches over ``chunks``: each
    chunk's reverse and forward pass as K6/K7's (``_band_work``), plus
    the halo read and written."""
    n_bytes = n_ops = 0
    for _v0, _v1, bi in chunks:
        for fwd in (False, True):
            b, o = _band_work(bi, fwd)
            nr = max(bi.NR_fwd if fwd else bi.NR_rev, 1)
            lanes = bi.n_sh * nr if fwd else 0
            span = 2 * bi.n_spans * (4 + bi.n_sh) if fwd else 0
            halo = 4 * (bi.Qp + 1) * ((2 * nr + lanes) * bi.maxat + span)
            n_bytes += b + 2 * halo + _nbytes(bi.tctx)
            n_ops += o
    return n_bytes, n_ops


def _plain_wave_check(path: str):
    """Worker process, CPU only: the plain wavefront over the K1/K4
    inputs saved at ``path``, held against the kernel's outputs saved
    with it; in path mode also the traceback cube's valid cells and the
    plain walk-back over the kernel's cube against the walk-back
    kernel's.  Returns (equal, max |kernel - plain|, seconds, diagonals
    walked)."""
    from exonerate_tpu_torch.engine import wavefront as wf
    torch.set_num_threads(1)
    saved = torch.load(path, weights_only=True)
    ki = wf.KernelInputs(**saved["ki"])
    t0 = time.perf_counter()
    stats, tb = wf.plain_wavefront(ki)
    secs = time.perf_counter() - t0
    err = _max_err(stats, saved["out"])
    ok = torch.equal(stats, saved["out"])
    if ki.mode == "path":
        valid = _tb_valid(ki, tb)
        err = max(err, _max_err(tb[valid], saved["tb"][valid]))
        ops, res = wf.plain_walkback(saved["tb"], saved["out"], ki.walk,
                                     ki.end_id, saved["cap"])
        ok = ok and not err and torch.equal(res, saved["res"]) and all(
            torch.equal(ops[b, :int(res[0, b])],
                        saved["ops"][b, :int(res[0, b])])
            for b in range(ki.batch))
    return ok, err, secs, int((ki.dims[:, 2] + ki.dims[:, 3]).max()) + 1


def _save_span(path: str, ki, ring: tuple, span: tuple, out, tb) -> str:
    """Save a span launch of the cluster kernel for ``_plain_span_check``:
    its inputs, the carry rings it started from, and its outputs."""
    torch.save({"ki": _cpu_fields(ki), "ring": [t.cpu() for t in ring],
                "span": list(span),
                "out": out.cpu() if out is not None else None,
                "tb": tb.cpu() if tb is not None else None}, path)
    return path


def _plain_span_check(path: str):
    """Worker process, CPU only: the plain wavefront over the saved span of
    diagonals from the saved carry rings, held against the cluster
    kernel's outputs: the span's best end cell (score, ends, starts),
    when saved, and in path mode its planes' valid cells.  Returns
    (equal, max |kernel - plain|, seconds, diagonals)."""
    from exonerate_tpu_torch.engine import wavefront as wf
    torch.set_num_threads(1)
    saved = torch.load(path, weights_only=True)
    ki = wf.KernelInputs(**saved["ki"])
    span = tuple(saved["span"])
    t0 = time.perf_counter()
    out, tb = wf.plain_wavefront(ki, span, tuple(saved["ring"]))
    secs = time.perf_counter() - t0
    ok, err = True, 0
    if saved["out"] is not None:
        err = _max_err(out, saved["out"])
        ok = torch.equal(out, saved["out"])
    if tb is not None:
        valid = _tb_valid(ki, tb, span[0])
        err = max(err, _max_err(tb[valid], saved["tb"][valid]))
    return ok and not err, err, secs, span[1] - span[0]


def _wave_outputs(cw, ki, cluster: bool = False) -> dict:
    """K1 on ``ki`` (K4 and the walk-back in path mode), or the cluster
    kernel when ``cluster``: the outputs that ``_plain_wave_check`` holds
    to the plain version."""
    if ki.mode != "path":
        return {"out": (cw.wavefront_stream_scan if cluster
                        else cw.wavefront_scan)(ki)}
    stats, tb = cw.wavefront_path(ki, cluster=cluster)
    cap = ki.Qp + ki.Tp + 1 + cw.WALK_SLACK
    ops, res = cw.walkback(tb, stats, ki.walk, ki.end_id, cap)
    return {"out": stats, "tb": tb, "ops": ops, "res": res, "cap": cap}


def _save_wave(path: str, ki, outs: dict) -> str:
    """Save K1/K4 inputs and the kernels' outputs for a worker process."""
    torch.save({"ki": _cpu_fields(ki),
                **{k: v.cpu() if torch.is_tensor(v) else v
                   for k, v in outs.items()}}, path)
    return path


def _sub_batch(ki, idx: list):
    """The pairs ``idx`` of a K1/K4 batch, at the batch's (Qp, Tp)."""
    import dataclasses
    ix = torch.tensor(idx, device=ki.dims.device)
    fields = {f: getattr(ki, f)[ix]
              for f in ("dims", "qvecs", "tvecs", "tables", "scalars")}
    if ki.masked:
        fields["blocked"] = ki.blocked[ix]
    return dataclasses.replace(ki, **fields)


def _widest(ki, n: int = 2) -> list:
    """The ``n`` pairs of a batch with the most cells, widest first."""
    cells = ((ki.dims[:, 2].long() + 1) * (ki.dims[:, 3].long() + 1)).tolist()
    return sorted(range(ki.batch), key=lambda b: -cells[b])[:n]


@contextlib.contextmanager
def _timed(mod, keys: dict, acc: dict):
    """While active, each function ``mod.<name>`` of ``keys`` adds its
    host seconds, ended by a device sync, to ``acc[keys[name](*args)]``."""
    real = {n: getattr(mod, n) for n in keys}

    def wrap(name, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            _sync()
            key = keys[name](*args, **kwargs)
            acc[key] = acc.get(key, 0.0) + time.perf_counter() - t0
            return out
        return timed

    for n, fn in real.items():
        setattr(mod, n, wrap(n, fn))
    try:
        yield acc
    finally:
        for n, fn in real.items():
            setattr(mod, n, fn)


# where the wavefront routes spend their host clock: host prep (the pairs'
# arrays and SubOpt mask planes; packing and copies), and K1, K2 and K4
# with and without the mask plane, timed around the uncounted launcher
# ``_launch`` (the counted wrappers keep their launch counters)
WAVE_CLOCKS = {
    "_buckets": lambda *a, **k: "prep: prepare_inputs (masks)",
    "to_kernel_inputs": lambda *a, **k: "prep: to_kernel_inputs (copies)",
    "_launch": lambda ki, cluster=None, span=None, ring=None: (
        "K4" if ki.mode == "path" else "K2" if cluster is not None
        else "K1") + (" masked" if ki.masked else "")}


def _empty_plan(ki):
    """``ki`` on an empty plan of the same storage (its own compiled
    header): the cluster kernel's cells then run no plan row, so a launch
    times the cluster barrier, the halo copy and the ring writes alone,
    the per-diagonal floor of the shared-ring body."""
    import dataclasses
    from exonerate_tpu_torch.engine import plan_cuda
    empty = ki.plan[:0].contiguous()
    header = plan_cuda.wave_header(
        "an empty plan", ki.mode, empty.cpu().numpy(),
        ki.ring_row.cpu().numpy(), ki.lane_row.cpu().numpy(), S=ki.S,
        L=ki.L, NR=ki.NR, NL=ki.NL, K=ki.K, n_shadow=ki.n_shadow,
        start_id=ki.start_id, end_id=ki.end_id)
    return dataclasses.replace(ki, plan=empty, header=header)


@contextlib.contextmanager
def _global_ring(cw):
    """While active, the cluster kernel keeps every ring in global memory
    (``cuda_wavefront.ring_in_smem`` answers no): ring_kernel's SMEM_RING
    flag false, for a comparison on the same card."""
    real = cw.ring_in_smem
    cw.ring_in_smem = lambda ki, cluster=0: False
    try:
        yield
    finally:
        cw.ring_in_smem = real


def _k2_mb(kis: list) -> list:
    """(B, Qp, Tp, MB) of each K1 batch by the JAX package's streaming test
    (``pallas_wavefront.py:1437-1443``; kernel K2 takes a batch over
    ``STREAM_VMEM_BYTES``, 24 MB): one reversed int32 vector of 2*QV + 128
    + Tp + 265 per target-indexed row (the port's ``tvecs`` rows) per
    pair, QV = Qp + 128 at the bucket ladder's sizes."""
    return [(k.batch, k.Qp, k.Tp, round(k.tvecs.shape[1] * k.batch * (
        2 * (k.Qp + 128) + 128 + k.Tp + 265) * 4 / 2**20, 2))
        for k in kis if k.mode != "path"]


def _breakdown(acc: dict, total: float) -> str:
    parts = [f"{k} {v:.2f} s" for k, v in sorted(acc.items())]
    return (", ".join(parts) + f", the rest (seeding, walk-backs, "
            f"alignments, masks' points, output) "
            f"{total - sum(acc.values()):.2f} s")


def _ipcress_phase(genome: str, genome_fa: str, tmp: str,
                   card: str) -> None:
    """Phase 5i: the port's ipcress against the C reference's on
    ``genome_fa`` (phase 4's genome, ``genome`` its text), with an
    experiment per gene copy of IPCRESS_GENES, under each of
    IPCRESS_FLAGS: the outputs must be equal, byte for byte, and hold a
    product of each experiment."""
    from exonerate_tpu_torch.cli import ipcress
    ref = os.path.join(ROOT, "build", "ref", "bin", "ipcress")
    if not os.access(ref, os.X_OK):
        raise RuntimeError(f"ipcress: {ref} is absent or not executable")
    comp = str.maketrans("ACGTacgt", "TGCATGCA")
    # scan_genome's eight gene copies, copy g from spacing * (g + 1) on
    spacing = len(genome) // 9
    exp = os.path.join(tmp, "genes.ipcress")
    with open(exp, "w") as fh:
        for g in IPCRESS_GENES:
            at = spacing * (g + 1)
            end = at + IPCRESS_PRODUCT
            a = genome[at:at + IPCRESS_PRIMER].upper()
            b = genome[end - IPCRESS_PRIMER:end].translate(comp)[::-1]
            fh.write(f"copy{g} {a} {b} {IPCRESS_WINDOW[0]} "
                     f"{IPCRESS_WINDOW[1]}\n")
    for flags in IPCRESS_FLAGS:
        argv = flags + [exp, genome_fa]
        buf = io.StringIO()
        t0 = time.perf_counter()
        if ipcress.main(list(argv), out=buf) != 0:
            raise RuntimeError(f"ipcress {flags}: the port's run failed")
        port_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        r = subprocess.run([ref] + argv, capture_output=True, text=True,
                           timeout=300)
        c_s = time.perf_counter() - t0
        if r.returncode != 0:
            raise RuntimeError(f"ipcress {flags}: the C reference's run "
                               f"failed: {r.stderr[-500:]}")
        if buf.getvalue() != r.stdout:
            raise RuntimeError(f"ipcress {flags}: the port's output differs "
                               f"from the C reference's")
        found = [ln.split()[2] for ln in r.stdout.splitlines()
                 if ln.startswith("ipcress:")]
        if {f"copy{g}" for g in IPCRESS_GENES} - set(found):
            raise RuntimeError(f"ipcress {flags}: an experiment found no "
                               f"product: {found}")
        print(f"ipcress {' '.join(flags) or '(default flags)'}, "
              f"{len(IPCRESS_GENES)} experiments x {len(genome) / 1e6:.0f} "
              f"Mb [{card}]: {len(found)} products, output == the C "
              f"reference's; the port {port_s:.3f} s, C {c_s:.3f} s (host "
              f"clock, the C binary's process start included)")


def _write_fasta(path: str, records) -> str:
    with open(path, "w") as fh:
        for name, seq in records:
            fh.write(f">{name}\n{seq}\n")
    return path


def _vulgar(out: str) -> list:
    """The vulgar lines of ``out``, in order."""
    return [ln for ln in out.splitlines() if ln.startswith("vulgar:")]


def _server_phase(dev, genome_fa: str, query_fa: str, tmp: str, cli,
                  card: str) -> dict:
    """Phase 5e: exonerate-server on the card.  Builds the .esd / .esi of
    ``genome_fa`` with the port's fasta2esd (unmasked) and esd2esi,
    holds DeviceIndex over [dev] and [dev, dev] to Index.lookup_word on
    SRV_WORDS word-table words and two misses (timed by CUDA events,
    host prep and the copy back included, beside the host loop's clock),
    then serves the index from two
    in-process servers, the host index's and the device index's (every
    card PyTorch sees), and runs the port's CLI as their client on
    ``query_fa``, est2genome and the default model: the two servers'
    outputs must be equal, byte for byte (the port in the echoed command
    line aside), and their vulgar lines, sorted, the local run's on
    ``genome_fa``.  ``cli(argv)`` runs the port's CLI and
    returns (output, host seconds)."""
    import socket
    from exonerate_tpu_torch.cli import fastautils
    from exonerate_tpu_torch.cli.server import ExonerateServer
    from exonerate_tpu_torch.db.device_index import DeviceIndex
    from exonerate_tpu_torch.db.index import Index
    t0 = time.perf_counter()
    esd = os.path.join(tmp, "genome.esd.npz")
    esi = os.path.join(tmp, "genome.esi.npz")
    # the whole genome indexed (its lowercase background unmasked), so
    # that every word of it has its postings, as the local run seeds
    said = io.StringIO()
    for argv in (["fasta2esd", genome_fa, esd, "--softmask", "FALSE"],
                 ["esd2esi", esd, esi]):
        if fastautils.main(argv, out=said) != 0:
            raise RuntimeError(f"server: {argv[0]} failed")
    index = Index(esi)
    build_s = time.perf_counter() - t0
    print(said.getvalue().replace(tmp, "<tmp>"), end="")
    rng = np.random.default_rng(11)
    words = np.concatenate([
        rng.choice(index.word_table, SRV_WORDS, replace=False),
        np.array([0, 10 ** 17])]).astype(index.word_table.dtype)
    t0 = time.perf_counter()
    want_w, want_s, want_p = [], [], []
    for k, w in enumerate(words):
        s_, p_ = index.lookup_word(int(w))
        want_w += [k] * len(s_)
        want_s += s_.tolist()
        want_p += p_.tolist()
    host_ms = (time.perf_counter() - t0) * 1e3
    lookup_ms = {}
    for devs in ([dev], [dev, dev]):
        dix = DeviceIndex(index, devs)
        dix.lookup_words(words)            # warm
        (got_w, got_s, got_p), ms = _cuda_call(
            lambda: dix.lookup_words(words))
        if (got_w.tolist(), got_s.tolist(), got_p.tolist()) != (
                want_w, want_s, want_p):
            raise RuntimeError(f"DeviceIndex over {devs} != "
                               f"Index.lookup_word")
        lookup_ms[len(devs)] = ms
    print(f"server index of the {os.path.basename(genome_fa)} genome: "
          f"{len(index.post_seq)} postings, {len(index.word_table)} words, "
          f"built by fasta2esd and esd2esi in {build_s:.2f} s (host "
          f"clock); {len(words)} words "
          f"({len(want_s)} postings) [{card}]: DeviceIndex over 1 / 2 "
          f"shards on {dev} {lookup_ms[1]:.3f} / {lookup_ms[2]:.3f} ms "
          f"(CUDA events, host prep and the copy back included) == "
          f"Index.lookup_word, {host_ms:.3f} ms (host clock)")

    def free_port():
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            return sk.getsockname()[1]

    servers = {}
    try:
        for name, kw in (("host", {}), ("device", {"use_device_index":
                                                   True})):
            srv = ExonerateServer(index.dataset, Index(esi), free_port(),
                                  **kw)
            srv.start_background()
            servers[name] = srv
        for srv in servers.values():
            for _ in range(300):
                try:
                    socket.create_connection(("127.0.0.1", srv.port),
                                             timeout=1).close()
                    break
                except OSError:
                    time.sleep(0.1)
        runs = {}
        for model in (["-m", "est2genome"], []):
            label = model[1] if model else "default model"
            argv = model + NB_ARGV
            outs = {}
            for name, srv in servers.items():
                out, secs = cli(argv + [query_fa, f"localhost:{srv.port}"])
                # the command line echoed names the server's port
                outs[name] = (out.replace(f"localhost:{srv.port}",
                                          "localhost:PORT"), secs)
            local = cli(argv + [query_fa, genome_fa])
            if outs["device"][0] != outs["host"][0]:
                raise RuntimeError(f"server {label}: the device index's "
                                   f"output differs from the host index's")
            # sorted, as tests/test_server_mode.py compares them: equal
            # scores of one query may come in another order through the
            # server, in the JAX package's client as in the port's
            if sorted(_vulgar(outs["device"][0])) != sorted(
                    _vulgar(local[0])) or not _vulgar(local[0]):
                raise RuntimeError(f"server {label}: the client's vulgar "
                                   f"lines differ from the local run's")
            runs[label] = (len(_vulgar(local[0])), outs["host"][1],
                           outs["device"][1], local[1])
        lookups = servers["device"].device_index.lookups
    finally:
        for srv in servers.values():
            srv.shutdown()
    if lookups < 1:
        raise RuntimeError("server: the device index served no lookup")
    for label, (n, h, d, loc) in runs.items():
        print(f"the port's CLI as a client of the port's server, {label} "
              f"[{card}]: {n} vulgar lines == the local run's; the device "
              f"index's output == the host index's; host index {h:.2f} s, "
              f"device index {d:.2f} s, local {loc:.2f} s (host clock)")
    print(f"  the device index served {lookups} lookups")
    return {"lookup_ms": lookup_ms, "host_ms": host_ms, "runs": runs}


def _vulgar_ops(out: str) -> list:
    """The operation letters of every vulgar line of ``out``."""
    return [ln.split()[10::3] for ln in out.splitlines()
            if ln.startswith("vulgar:")]


def _zoo_jobs() -> list:
    """Phase 7's model zoo: [(model, jobs)] of the models the wavefront
    kernels serve beyond est2genome: every start/end scope, the K=4/6
    carry rings of codon models, NER, and the split-codon pairs of
    coding2genome and cdna2genome."""
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_split_cases as sc
    from exonerate_tpu_torch.engine.region import Region
    from exonerate_tpu_torch.model import registry
    from exonerate_tpu_torch.model.data import AlignData
    from exonerate_tpu_torch.seqio import Annotation, Sequence, iter_fasta
    calm = next(iter(iter_fasta(os.path.join(DATA, "all4.fa"))))
    calm.strand = "+"
    dna_q, dna_t = calm.subseq(0, 300), calm.subseq(20, 330)
    pep = Sequence("p", None, "MADQLTEEQIAEFKEAFSLFDKDGDGTITTKELGTVMRSL")
    zoo = [("AFFINE_GLOBAL", dna_q, dna_t), ("AFFINE_BESTFIT", dna_q, dna_t),
           ("AFFINE_OVERLAP", dna_q, dna_t), ("NER", dna_q, dna_t),
           ("CODING2CODING", dna_q, dna_t), ("PROTEIN2DNA", pep, dna_t)]
    for mt, cuts in (("CODING2GENOME", sc.C2G_CUTS), ("CDNA2GENOME", sc.CUTS)):
        q, t = sc.small_pair("cdna", cuts=cuts)
        qs = Sequence("q", None, q)
        if mt == "CDNA2GENOME":
            qs.annotation = Annotation(0, len(q))
        zoo.append((mt, qs, Sequence("t", None, t)))
    out = []
    for mt, q, t in zoo:
        mtype = getattr(registry.ModelType, mt)
        m = registry.get_model(mtype, q.alphabet.type, t.alphabet.type)
        out.append((m, [(Region(0, 0, len(q), len(t)),
                         AlignData(q, t, registry.translate_both(mtype)))]))
    return out


def _plan_headers() -> list:
    """The compiled plans the phases launch, from small CPU inputs of each
    model and mode: K1/K4 on est2genome (calm), the zoo of phase 7 and
    protein2genome (its split pair) in score, region and path modes, the
    empty plan of est2genome region (phase 9e's floor), and the band scan
    on phase 3's synthetic cases.  [(stem, label, header)], each plan
    once; a plan first met later builds at its first launch."""
    import torch_split_cases as sc
    from exonerate_tpu_torch.engine import cuda_sdp as cs
    from exonerate_tpu_torch.engine import cuda_wavefront as cw
    from exonerate_tpu_torch.engine import wavefront as wf
    from exonerate_tpu_torch.engine.region import Region
    from exonerate_tpu_torch.model import registry
    from exonerate_tpu_torch.model.data import AlignData
    from exonerate_tpu_torch.model.est2genome import est2genome_create
    from exonerate_tpu_torch.seqio import Sequence, iter_fasta
    cpu = torch.device("cpu")
    calm = next(iter(iter_fasta(os.path.join(DATA, "all4.fa"))))
    q, t = sc.small_pair("protein", cuts=sc.CUTS)
    p2g = registry.get_model(registry.ModelType.PROTEIN2GENOME,
                             registry.AlphabetType.PROTEIN,
                             registry.AlphabetType.DNA)
    jobs = [(est2genome_create(), (Region(0, 0, 60, 80),
                                   AlignData(calm, calm))),
            (p2g, (Region(0, 0, len(q), len(t)),
                   AlignData(Sequence("q", None, q), Sequence("t", None, t),
                             False)))]
    jobs += [(m, js[0]) for m, js in _zoo_jobs()]
    out, seen = [], set()
    for m, (region, data) in jobs:
        pads = (wf._bucket(region.query_length),
                wf._bucket(region.target_length))
        inputs, kinds = wf.prepare_inputs(m, region, data, pad_to=pads,
                                          for_pallas=True)
        for mode in ("score", "region", "path"):
            ki = cw.to_kernel_inputs(m, inputs, kinds, cpu, mode)
            if ki.header not in seen:
                seen.add(ki.header)
                out.append(("wavefront", f"K1/K2/K4 {m.name} {mode}",
                            ki.header))
            if (m.name, mode) == ("est2genome", "region") \
                    and not any("empty" in lab for _, lab, _ in out):
                out.append(("wavefront", "K2 est2genome region, an empty "
                            "plan", _empty_plan(ki).header))
    for m, band_jobs in _synthetic_sdp_jobs():
        h = cs.band_inputs(m, band_jobs, band_jobs[0][0].args.dropoff,
                           cpu).header
        if h not in seen:
            seen.add(h)
            out.append(("sdp_band", f"K6/K7/K8 {m.name}", h))
    return out


def _zoo_results(device) -> dict:
    """K1 (score, region) and K4 with the walk-back on ``device`` over the
    zoo: {model name: [(score, ends, starts, path's transition ids)]}."""
    from exonerate_tpu_torch.engine import cuda_wavefront as cw

    def key(r):
        return (r.score, r.query_end, r.target_end, r.query_start,
                r.target_start,
                None if r.path is None else tuple(t.id for t in r.path))

    out = {}
    for m, jobs in _zoo_jobs():
        res = (cw.find_batched(m, jobs, "score", device=device)
               + cw.find_batched(m, jobs, "region", device=device)
               + cw.find_path_batched(m, jobs, device=device))
        out[m.name] = [key(r) for r in res]
    return out


def _zoo_plain():
    """Worker process, CPU only: ``_zoo_results`` on the plain versions.
    Returns (results, seconds)."""
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    return _zoo_results(torch.device("cpu")), time.perf_counter() - t0


def main() -> int:
    t_start = time.perf_counter()
    # -- 1. device -------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    dev = torch.device("cuda", 0)
    cpu = torch.device("cpu")
    name = torch.cuda.get_device_name(0)
    card = _card_line()
    print(f"device: {name}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    print(f"nvidia-smi: {card}")

    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_split_cases as sc
    from exonerate_tpu_torch import _cudabuild, observe
    from exonerate_tpu_torch.alphabet import AlphabetType
    from exonerate_tpu_torch.cli.exonerate import main as cli_main
    from exonerate_tpu_torch.engine import cuda_sdp as cs
    from exonerate_tpu_torch.engine import cuda_wavefront as cw
    from exonerate_tpu_torch.engine import generic_wavefront as gw
    from exonerate_tpu_torch.engine import optimal
    from exonerate_tpu_torch.engine import sdp_device as sd
    from exonerate_tpu_torch.engine import sdp_hybrid as hy
    from exonerate_tpu_torch.engine import sdp_native
    from exonerate_tpu_torch.engine import wavefront as wf
    from exonerate_tpu_torch.engine.region import Region
    from exonerate_tpu_torch.engine.subopt import SubOpt
    from exonerate_tpu_torch.model import registry
    from exonerate_tpu_torch.model.affine import (AffineModelType,
                                                  affine_create)
    from exonerate_tpu_torch.model.data import AlignData
    from exonerate_tpu_torch.model.est2genome import est2genome_create
    from exonerate_tpu_torch.seqio import Sequence, iter_fasta
    for mod in ("jax", "exonerate_tpu"):
        if sys.modules.get(mod) is not None:
            raise RuntimeError(f"the port imported {mod}")

    # -- 2. build (one nvcc per library, on the host's cores at once) ----
    # the sources without a plan (the walk-back, T1) and one library per
    # compiled plan of the wavefront (K1/K4 and K2) and the band scan,
    # each phase's plans built before its kernels start (a library loaded
    # later waits for a running kernel)
    _mark(t_start, "2, build")
    from concurrent.futures import ThreadPoolExecutor
    libs = [(stem, stem, None) for stem in ("walkback", "vpu16")]
    libs += _plan_headers()
    t_build = time.perf_counter()
    with ThreadPoolExecutor(os.cpu_count() or 8) as ex:
        list(ex.map(lambda lib: _cudabuild.load(lib[0], lib[2]), libs))
    print(f"build: {len(libs)} libraries in "
          f"{time.perf_counter() - t_build:.1f} s")
    for stem, label, header in libs:
        built = _cudabuild.builds[_cudabuild.name(stem, header)]
        print(f"build {label}: {built.seconds:.2f} s -> "
              f"{os.path.relpath(built.path, ROOT)}")
        for ln in _cudabuild.ptxas_report(built.log):
            print(f"  {ln}")

    calm = next(iter(iter_fasta(os.path.join(DATA, "all4.fa"))))
    calm.strand = "+"
    if len(calm) != CALM_LEN:
        raise RuntimeError(f"calm is {len(calm)} bp, want {CALM_LEN}")
    model = est2genome_create()
    data = AlignData(calm, calm)
    full = Region(0, 0, CALM_LEN, CALM_LEN)
    Qp, Tp = wf._bucket(CALM_LEN), wf._bucket(CALM_LEN)
    inputs, kinds = wf.prepare_inputs(model, full, data, pad_to=(Qp, Tp),
                                      for_pallas=True)
    cells = CALM_LEN * CALM_LEN
    report = {}

    sys.path.insert(0, os.path.join(ROOT, "tests", "golden"))
    import cases
    engines = {}

    def run_cli(argv, allow=()):
        """The CLI's output and host seconds; raises on any engine
        fallback but those whose reason starts with one of ``allow``
        (the hybrid's locus cross-check, see scan())."""
        buf = io.StringIO()
        t0 = time.perf_counter()
        if cli_main(argv, out=buf) != 0:
            raise RuntimeError(f"CLI exit status for {argv}")
        _sync()
        secs = time.perf_counter() - t0
        bad = {k: v for k, v in observe.fallback_counts.items()
               if not k.startswith(tuple(allow))}
        if bad:
            raise RuntimeError(f"engine fallbacks: {bad}")
        engines.update(observe.engine_counts)
        return buf.getvalue(), secs

    # launches of every kernel on the main paths: each path is driven with
    # the counters set to 0 just before it and read just after
    counters = {"K1": cw.wavefront_scan, "K4": cw.wavefront_path,
                "walkback": cw.walkback, "K6": cs.band_reverse,
                "K7": cs.band_forward, "K9": cw.K9, "K3": cw.K3,
                "K2": cw.K2, "K8": cs.K8, "K5": cw.K5,
                "ring smem": cw.RING_SMEM, "ring global": cw.RING_GLOBAL,
                "band smem": cs.BAND_SMEM, "band global": cs.BAND_GLOBAL,
                "K6 sid": cs.K6_SID, "K7 sid": cs.K7_SID}
    main_launches = dict.fromkeys(counters, 0)

    def zero_counts():
        for c in counters.values():
            c.launches = 0

    def read_counts(label, want):
        got = {k: c.launches for k, c in counters.items()}
        for k, v in got.items():
            main_launches[k] += v
        missing = [k for k in want if got[k] < 1]
        if missing:
            raise RuntimeError(f"{label}: kernels {missing} never ran on the "
                               f"main path ({got})")
        return {k: v for k, v in got.items() if v}

    # the band batches the hybrid sends to the card, captured on the way
    captured = []
    real_batch = hy.run_device_batch

    def spy(model_, jobs_, device_, devices_=None):
        t0 = time.perf_counter()
        res = real_batch(model_, jobs_, device_, devices_)
        captured.append((model_, list(jobs_), time.perf_counter() - t0))
        return res

    # -- 3. K6/K7 vs plain, synthetic pairs ------------------------------
    _mark(t_start, "3, K6/K7 on synthetic pairs")
    # the kernels on the card; their plain passes, and run_kernel on the
    # CPU, in worker processes on host cores (read in phase 14)
    tmp_dir = _EXIT.enter_context(tempfile.TemporaryDirectory())
    pools, pending = [], []
    syn_pool = _pool(2)
    pools.append(syn_pool)
    # phase 5f's references, the longest of them ~150 s on one core,
    # start now: phase 5b's first proteins against its genome on the CPU
    # (forced rows route; native route)
    rqf = _write_fasta(os.path.join(tmp_dir, "rows_q.fa"),
                       [(f"p{k}", p) for k, p in enumerate(
                           sc.mutated_proteins(8)[:ROWS_PROTEINS])])
    rtf = _write_fasta(os.path.join(tmp_dir, "rows_t.fa"),
                       [("split_genome", sc.scan_genome(sc.CUTS)[1])])
    rows_argv = P2G_ARGV + [rqf, rtf]
    rows_pool = _pool(2)
    pools.append(rows_pool)
    rows_ref = rows_pool.apply_async(_rows_cpu, (rows_argv,))
    rows_nat = rows_pool.apply_async(
        _cpu_cli, (rows_argv, {"EXONERATE_TPU_SDP": "native"}))
    syn_checks = []
    band_err = 0
    split_band = None
    for k, (bmodel, jobs) in enumerate(_synthetic_sdp_jobs()):
        drop = jobs[0][0].args.dropoff
        bi = cs.band_inputs(bmodel, jobs, drop, dev)
        bits, live_r = cs.band_reverse(bi)
        col, live_f, xb = cs.band_forward(bi, bits)
        label = f"synthetic {k} {bmodel.name} x{len(jobs)}"
        _, more = _start_plain_check(
            label, bi, {"bits": bits, "live_r": live_r, "colbest": col,
                        "live_f": live_f, "xband": xb}, tmp_dir,
            [(False, list(range(bi.batch))), (True, list(range(bi.batch)))],
            syn_pool)
        pending.extend(more)
        if bi.split and bmodel.name.startswith("protein2genome"):
            split_band = (bmodel.name, bi.Qp, bi.Wp, _cuda_ms(
                lambda: cs.band_forward(bi, bits), 3), more[1][2])
        syn_checks.append((label, cs.run_kernel(bmodel, jobs, drop, dev),
                           syn_pool.apply_async(_synthetic_run_kernel, (k,))))
        print(f"K6/K7 {bmodel.name} x{len(jobs)}"
              f"{' (split codons, K9)' if bi.split else ''}: launched; the "
              f"plain passes and run_kernel on the CPU started in worker "
              f"processes")
        del bi, bits, col

    # the est2genome_genomic golden through the CLI on the forced device
    # route (this first heuristic run also builds the host's native
    # libraries, so that the scans below are timed warm)
    name_g = "est2genome_genomic"
    argv_g = dict((n, a) for n, _prog, a in cases.CASES)[name_g]
    captured.clear()
    hy.run_device_batch = spy
    os.environ["EXONERATE_TPU_SDP"] = "device"
    try:
        out, secs = run_cli(argv_g)
    finally:
        os.environ.pop("EXONERATE_TPU_SDP")
        hy.run_device_batch = real_batch
    with open(os.path.join(cases.OUTDIR, name_g + ".txt")) as fh:
        if cases.normalize(out) != fh.read():
            raise RuntimeError(f"CLI {name_g} (forced device route) differs "
                               f"from its golden")
    if observe.engine_counts.get(cs.engine_name(dev), 0) < 1:
        raise RuntimeError(f"{name_g}: no comparison on the band kernels")
    print(f"CLI {name_g} (forced device route): byte-equal to the golden "
          f"({secs:.2f} s host clock)")
    gmodel, gjobs, _ = captured[0]

    # -- 4. the est2genome scan at full width (the band kernels' main path)
    _mark(t_start, "4, the est2genome scan")
    plain_passes = [0]
    real_pass = sd._run_pass

    def counted_pass(*args, **kwargs):
        plain_passes[0] += 1
        return real_pass(*args, **kwargs)

    real_resolve = hy.HybridSDPPair._resolve
    route_secs = {}     # scan label -> the route's host seconds
    # the scans' native routes (EXONERATE_TPU_SDP=native) run in a worker
    # process beside the card's phases; their bytes are compared in phase
    # 14: [(label, mode, the route's output, async result)]
    scan_pool = _pool(1)
    pools.append(scan_pool)
    scan_natives = []

    def scan(label, argv, mode, want_kernels, force=None, max_crossed=0,
             liveness=False):
        """The CLI over ``argv`` on the route ``force`` (None: default),
        and on the native route in a worker process; returns (output,
        engines, captured batches, [(batch, comparison) of each locus
        cross-check mismatch]).  With ``liveness``, comparisons whose
        band scan reached its band's edge may go to the host (the
        hybrid's own rule: the host then prints the same bytes), and are
        counted in the output line.

        The hybrid's locus cross-check may disagree on at most
        ``max_crossed`` comparisons: the host's re-run of one locus alone
        finds another score than the band scan of the whole comparison,
        and the comparison goes to the host.  The JAX package's device
        tier does the same on such inputs (ROADMAP.md, Queue 3); the
        caller holds the kernels to the plain passes on each such
        comparison.  Any other fallback, or one more, fails."""
        captured.clear()
        mismatched = []

        def resolve(self, lx):
            try:
                return real_resolve(self, lx)
            except hy.HybridFallback:
                if self.plan is not None:
                    mismatched.append(self.plan)
                raise

        sd._run_pass = counted_pass
        hy.run_device_batch = spy
        hy.HybridSDPPair._resolve = resolve
        if force:
            os.environ["EXONERATE_TPU_SDP"] = force
        observe.reset()
        zero_counts()
        allow = (((CROSSCHECK,) if max_crossed else ())
                 + ((LIVENESS,) if liveness else ()))
        try:
            out_dev, secs_dev = run_cli(argv, allow)
            launches = read_counts(label, want_kernels)
            eng = dict(observe.engine_counts)
            falls = dict(observe.fallback_counts)
            batches = list(captured)
        finally:
            os.environ.pop("EXONERATE_TPU_SDP", None)
            sd._run_pass = real_pass
            hy.run_device_batch = real_batch
            hy.HybridSDPPair._resolve = real_resolve
        scan_natives.append((label, mode, out_dev, scan_pool.apply_async(
            _cpu_cli, (argv, {"EXONERATE_TPU_SDP": "native"}))))
        route_secs[label] = secs_dev
        crossed = [(bx, jx) for bx, (_m, jobs_, _s) in enumerate(batches)
                   for jx, (_p, pl) in enumerate(jobs_)
                   if any(pl is q for q in mismatched)]
        print(f"{label} [{card}]: {mode} {secs_dev:.2f} s (host clock; the "
              f"native route runs in a worker process); engines {eng}; "
              f"launches {launches}; fallbacks {falls}")
        n_live = sum(v for k, v in falls.items() if k.startswith(LIVENESS))
        if sum(falls.values()) - n_live != len(crossed):
            raise RuntimeError(f"{label}: fallbacks {falls} are not the "
                               f"{len(crossed)} locus cross-checks found")
        if len(crossed) > max_crossed:
            raise RuntimeError(f"{label}: {len(crossed)} locus cross-check "
                               f"mismatches, at most {max_crossed} allowed")
        if eng.get(cs.engine_name(dev), 0) < 1:
            raise RuntimeError(f"{label}: no comparison on "
                               f"{cs.engine_name(dev)}: {eng}")
        if plain_passes[0]:
            raise RuntimeError(f"{label}: {plain_passes[0]} plain band-scan "
                               f"passes ran on the main path")
        return out_dev, eng, batches, crossed

    queries, genome = sc.scan_genome((400, 800))
    qf = _write_fasta(os.path.join(tmp_dir, "q.fa"),
                      [(f"q{k}", q) for k, q in enumerate(queries)])
    tf = _write_fasta(os.path.join(tmp_dir, "t.fa"), [("genome", genome)])
    # phase 13's reference: the genome2genome -E run on the CPU, in a
    # worker process beside the card's phases
    g2g_seqs = {f: "".join(open(os.path.join(DATA, f)).read().split(
        "\n", 1)[1].split()) for f in ("cdna_mut.fa", "genome.fa")}
    g2g_files = [
        _write_fasta(os.path.join(tmp_dir, "g2g_q.fa"),
                     [("qmut300", g2g_seqs["cdna_mut.fa"][:G2G_CUT[0]])]),
        _write_fasta(os.path.join(tmp_dir, "g2g_t.fa"),
                     [("genome_2990", g2g_seqs["genome.fa"][
                         G2G_CUT[1]:G2G_CUT[2]])])]
    g2g_pool = _pool(1)
    g2g_res = g2g_pool.apply_async(
        _cpu_cli, (G2G_ARGV + g2g_files, None, None, G2G_BUDGET))
    scan_label = f"scan {SCAN_QUERIES} x {SCAN_LEN / 1e6:.0f} Mb est2genome"
    out_dev, scan_eng, batches, _ = scan(
        scan_label,
        SCAN_ARGV + [qf, tf], "default routing", ("K6", "K7", "band smem"))
    spliced = {v[1] for v in (ln.split() for ln in out_dev.splitlines()
                              if ln.startswith("vulgar:"))
               if "I" in v[10::3]}
    print(f"  {len(spliced)}/{SCAN_QUERIES} queries spliced")
    if scan_eng.get(cs.engine_name(dev)) != SCAN_QUERIES:
        raise RuntimeError(f"scan: want {SCAN_QUERIES} comparisons on "
                           f"{cs.engine_name(dev)}, got {scan_eng}")
    if len(spliced) != SCAN_QUERIES:
        raise RuntimeError(f"scan: {len(spliced)}/{SCAN_QUERIES} queries "
                           f"with a spliced alignment")
    if len(batches) != 1:
        raise RuntimeError(f"scan: want one device batch, got "
                           f"{len(batches)}")
    smodel, sjobs, batch_secs = batches[0]
    bi = cs.band_inputs(smodel, sjobs, sjobs[0][0].args.dropoff, dev)
    (bits_s, live_r), s_rev = _cuda_call(lambda: cs.band_reverse(bi))
    (col_s, live_f, xb_s), s_fwd = _cuda_call(
        lambda: cs.band_forward(bi, bits_s))
    scan_work = (_band_work(bi, False), _band_work(bi, True))
    ws = [pl.W for _, pl in sjobs]
    print(f"scan band batch: B={len(sjobs)}, Qp {bi.Qp}, W {min(ws)}-"
          f"{max(ws)}, Wp {bi.Wp}, Dp {bi.Dp}, "
          f"{cs.pair_bytes(smodel, bi.Qp, bi.Wp, bi.tvecs.shape[1]) / 1e6:.1f}"
          f" MB per comparison [{card}]: K6 {s_rev:.3f} ms, K7 "
          f"{s_fwd:.3f} ms (CUDA events); in the default-route run the "
          f"batch took {batch_secs:.2f} s host clock (host prep, copies, "
          f"K6, K7); clusters (C, T, ring in shared memory): K6 "
          f"{cs.last_fit[False]}, K7 {cs.last_fit[True]}")
    length = (bi.dims[:, 0] + bi.dims[:, 1]).tolist()
    order = sorted(range(bi.batch), key=lambda b: -length[b])
    tasks = [(fwd, c) for fwd, n in ((False, SCAN_REV_CHUNKS),
                                     (True, SCAN_FWD_CHUNKS))
             for c in np.array_split(order, min(n, bi.batch))]
    pool, more = _start_plain_check(
        "scan", bi, {"bits": bits_s, "live_r": live_r, "colbest": col_s,
                     "live_f": live_f, "xband": xb_s}, tmp_dir, tasks)
    pools += [pool, g2g_pool]
    pending.extend(more)
    check_t0 = time.perf_counter()
    del bi, bits_s, col_s

    # b. K8, the cross-chip band scan, at the main path's shape: the
    # scan's widest comparison cut into 2 and 4 chunks on a device list
    # of cuda:0 (or the distinct cards), held to its single K6/K7 launch;
    # the launches of its 2-chunk chain made again, timed, and held to
    # their plain versions (from the same halos) in worker processes
    _mark(t_start, "4b, K8 on the scan's widest comparison")
    xdevs = ([torch.device("cuda", k)
              for k in range(torch.cuda.device_count())]
             if torch.cuda.device_count() >= 2 else [dev])
    pair_x, plan_x = max(sjobs, key=lambda j: j[1].W)
    drop_x = pair_x.args.dropoff
    want_x = cs.run_kernel(smodel, [(pair_x, plan_x)], drop_x, dev)[0]
    zero_counts()
    k8_ms = {}
    for n in K8_SPLITS:
        got_x, k8_ms[n] = _cuda_call(lambda: cs.run_kernel_cross_chip(
            smodel, pair_x, plan_x, drop_x, n, devices=xdevs))
        if (got_x["live"], got_x["xband"]) != (want_x["live"],
                                               want_x["xband"]) \
                or not np.array_equal(got_x["band_end"],
                                      want_x["band_end"]):
            raise RuntimeError(f"K8 ({n} chunks) != the single K6/K7 "
                               f"launch on the scan's widest comparison")
    k8_launches = read_counts("K8 on the scan's widest comparison",
                              ("K8", "band smem"))
    chunks_x = cs.cross_chunks(smodel, pair_x, plan_x, drop_x,
                               K8_SPLITS[0], xdevs)
    chain_x = _k8_chain(cs, sd, chunks_x)
    k8_chain_ms = _cuda_ms(lambda: _k8_chain(cs, sd, chunks_x))
    rev_bits = {cx: res[0] for (kind, cx), _h, res in chain_x
                if kind == "rev"}
    k8_pool = _pool(len(chain_x))
    pools.append(k8_pool)
    k8_pending = []
    for (kind, cx), halo, res in chain_x:
        bi_c = chunks_x[cx][2]
        path = _save_cross(os.path.join(tmp_dir, f"k8_{kind}_{cx}.pt"),
                           bi_c, halo,
                           rev_bits[cx] if kind == "fwd" else None, res)
        k8_pending.append(k8_pool.apply_async(_plain_cross_check, (path,)))
        pending.append((f"K8 {'K7' if kind == 'fwd' else 'K6'} pass on "
                        f"chunk {cx} of {len(chunks_x)} (Qp {bi_c.Qp} x Wpc "
                        f"{bi_c.Wp}) of the scan's widest comparison", [0],
                        k8_pending[-1]))
    k8_work = _k8_work(cs, chunks_x)
    k8_shape = (f"the est2genome scan's widest comparison, Q "
                f"{pair_x.region.query_length} x W {plan_x.W}, "
                f"{len(chunks_x)} chunks of Qp {chunks_x[0][2].Qp} x Wpc "
                f"{chunks_x[0][2].Wp}")
    del chain_x, chunks_x, rev_bits
    print(f"K8 on {k8_shape} over devices {[str(d) for d in xdevs]} "
          f"[{card}]: " + "; ".join(
              f"{n} chunks {k8_ms[n]:.3f} ms with host prep" for n in
              K8_SPLITS) + f" (CUDA events), band_end, live and xband == "
          f"the single K6/K7 launch; launches {k8_launches}; the "
          f"{K8_SPLITS[0]}-chunk chain's {2 * K8_SPLITS[0]} launches again "
          f"{k8_chain_ms:.3f} ms (CUDA events; clusters (C, T, ring in "
          f"shared memory): reverse {cs.last_fit[False]}, forward "
          f"{cs.last_fit[True]}), plain checks started")

    # c. --cores 2: phase 4's scan through the CLI's thread pool, each
    # comparison in a worker thread with a stream of its own, the device
    # tier once per comparison; its bytes must equal phase 4's.  Each band
    # launch is timed on the host clock from its enqueue to its stream's
    # end (CUDA timing events on the workers' streams run the kernels one
    # after another: PERF.md), so the kernels' overlap reads off one
    # timeline
    _mark(t_start, "4c, the est2genome scan with --cores 2")
    spans4c = []          # (stream, host start, host end) per launch
    real_band_launch = cs._launch

    def timed_band_launch(*args, **kwargs):
        t0 = time.perf_counter()
        res = real_band_launch(*args, **kwargs)
        stream = torch.cuda.current_stream()
        stream.synchronize()
        spans4c.append((stream.cuda_stream, t0, time.perf_counter()))
        return res

    observe.reset()
    zero_counts()
    cs._launch = timed_band_launch
    try:
        out_cores, secs_cores = run_cli(SCAN_ARGV + ["--cores", "2", qf, tf])
    finally:
        cs._launch = real_band_launch
    cores_launches = read_counts(f"{scan_label} --cores 2", ("K6", "K7"))
    cores_eng = dict(observe.engine_counts)
    if out_cores.replace(" --cores 2", "", 1) != out_dev:
        raise RuntimeError("--cores 2: the scan's output differs from phase "
                           "4's")
    if cores_eng.get(cs.engine_name(dev)) != SCAN_QUERIES:
        raise RuntimeError(f"--cores 2: want {SCAN_QUERIES} comparisons on "
                           f"{cs.engine_name(dev)}, got {cores_eng}")
    ivals = sorted((a, e) for _st, a, e in spans4c)
    busy, covered, reach = sum(e - a for a, e in ivals), 0.0, 0.0
    for a, e in ivals:
        covered += max(0.0, e - max(a, reach))
        reach = max(reach, e)
    n_streams = len({st for st, _a, _e in spans4c})
    print(f"{scan_label} with --cores 2 [{card}]: {secs_cores:.2f} s host "
          f"clock (phase 4's pooled route {route_secs[scan_label]:.2f} s); "
          f"byte-equal to phase 4's output; engines {cores_eng}; launches "
          f"{cores_launches}; no fallback; {len(ivals)} K6/K7 launches on "
          f"{n_streams} worker streams: {busy:.2f} s from enqueue to end, "
          f"summed, over {covered:.2f} s with one or more running (host "
          f"clock), so {busy - covered:.2f} s ran beside another")
    if n_streams < 2:
        raise RuntimeError(f"--cores 2: the band launches ran on {n_streams}"
                           f" stream(s), want one per worker thread")
    del spans4c

    def check_launches(label, model_, jobs_, check):
        """K6/K7 again on each launch that the main path made of the band
        batch ``jobs_`` (``cuda_sdp.launch_batches``), timed by CUDA
        events; the comparisons ``check`` start their plain check in
        worker processes at the shape of their launch.  Returns (K6 ms,
        K7 ms, each summed over the launches; (B, Qp, Wp, K6's and K7's
        cluster (C, T, ring in shared memory)) of each launch;
        the launches' summed (bytes, operations) for K6 and for K7)."""
        k6 = k7 = 0.0
        shapes, w6, w7 = [], [0, 0], [0, 0]
        for n, chunk in enumerate(cs.launch_batches(model_, jobs_)):
            bi = cs.band_inputs(model_, [jobs_[j] for j in chunk],
                                jobs_[0][0].args.dropoff, dev)
            (bits, live_r), t6 = _cuda_call(lambda: cs.band_reverse(bi))
            (col, live_f, xb), t7 = _cuda_call(
                lambda: cs.band_forward(bi, bits))
            k6, k7 = k6 + t6, k7 + t7
            shapes.append((len(chunk), bi.Qp, bi.Wp, cs.last_fit[False],
                           cs.last_fit[True]))
            for w, work in ((w6, _band_work(bi, False)),
                            (w7, _band_work(bi, True))):
                w[0], w[1] = w[0] + work[0], w[1] + work[1]
            mine = [chunk.index(j) for j in check if j in chunk]
            if mine:
                pool, more = _start_plain_check(
                    f"{label} launch {n}", bi,
                    {"bits": bits, "live_r": live_r, "colbest": col,
                     "live_f": live_f, "xband": xb}, tmp_dir,
                    [(False, mine), (True, mine)])
                pools.append(pool)
                pending.extend(more)
            del bi, bits, col
        return k6, k7, shapes, (tuple(w6), tuple(w7))

    def to_check(label, batches, crossed):
        """The band batch holding every cross-check mismatch (the largest
        batch when there is none) and the comparisons to hold to the
        plain passes: the mismatched ones, else the widest."""
        bx = max(range(len(batches)), key=lambda b: len(batches[b][1]))
        if any(b != bx for b, _ in crossed):
            raise RuntimeError(f"{label}: cross-check mismatches {crossed} "
                               f"outside the batch checked")
        widths = [pl.W for _, pl in batches[bx][1]]
        return (batches[bx], widths,
                [jx for _, jx in crossed] or [int(np.argmax(widths))])

    # -- 5. the split-codon paths (K9) -----------------------------------
    _mark(t_start, "5, the split-codon paths")
    # a. coding2genome scan, default routing
    squeries, sgenome = sc.scan_genome(sc.CUTS)
    sqf = _write_fasta(os.path.join(tmp_dir, "sq.fa"),
                       [(f"q{k}", q) for k, q in enumerate(squeries)])
    stf = _write_fasta(os.path.join(tmp_dir, "st.fa"),
                       [("split_genome", sgenome)])
    c2g_out, c2g_eng, c2g_batches, c2g_crossed = scan(
        f"coding2genome scan {SCAN_QUERIES} x {SCAN_LEN / 1e6:.0f} Mb",
        C2G_ARGV + [sqf, stf], "default routing", ("K6", "K7", "K9"),
        max_crossed=C2G_MAX_CROSSED)
    if not any("S" in ops for ops in _vulgar_ops(c2g_out)):
        raise RuntimeError("coding2genome scan: no split-codon operation")
    (cmodel, cjobs, c_secs), c_ws, c_check = to_check(
        "coding2genome scan", c2g_batches, c2g_crossed)
    c_rev, c_fwd, c_shapes, c2g_work = check_launches(
        "coding2genome", cmodel, cjobs, c_check)
    print(f"  coding2genome band batch: B={len(cjobs)}, W {min(c_ws)}-"
          f"{max(c_ws)}, launches (B, Qp, Wp, K6 / K7 (C, T, ring in "
          f"shared memory)) {c_shapes} [{card}]: K6 "
          f"{c_rev:.3f} ms, K7 {c_fwd:.3f} ms (CUDA events); batch "
          f"{c_secs:.2f} s host clock; plain check of comparisons "
          f"{c_check} started")

    # b. protein2genome scan, forced device route
    proteins = sc.mutated_proteins(8)
    pqf = _write_fasta(os.path.join(tmp_dir, "pq.fa"),
                       [(f"p{k}", p) for k, p in enumerate(proteins)])
    p2g_out, _, p2g_batches, p2g_crossed = scan(
        "protein2genome scan 8 x 1 Mb", P2G_ARGV + [pqf, stf],
        "EXONERATE_TPU_SDP=device", ("K6", "K7", "K9"), force="device")
    if not any("S" in ops for ops in _vulgar_ops(p2g_out)):
        raise RuntimeError("protein2genome scan: no split-codon operation")
    (pmodel, pjobs, p_secs), p_ws, p_check = to_check(
        "protein2genome scan", p2g_batches, p2g_crossed)
    pk_rev, pk_fwd, p_shapes, p2g_work = check_launches(
        "protein2genome", pmodel, pjobs, p_check)
    print(f"  protein2genome band batch: B={len(pjobs)}, W {min(p_ws)}-"
          f"{max(p_ws)}, launches (B, Qp, Wp, K6 / K7 (C, T, ring in "
          f"shared memory)) {p_shapes} [{card}]: K6 "
          f"{pk_rev:.3f} ms, K7 {pk_fwd:.3f} ms (CUDA events, summed); "
          f"batch {p_secs:.2f} s host clock; plain check of comparisons "
          f"{p_check} started")

    # c. protein2genome -E yes: the calm protein x the 12 kb split locus
    locus = sc.split_locus()
    prot = sc.calm_protein()
    eqf = _write_fasta(os.path.join(tmp_dir, "calm_p.fa"), [("calm", prot)])
    etf = _write_fasta(os.path.join(tmp_dir, "locus.fa"), [("locus", locus)])
    argv_e = ["-m", "protein2genome", "-E", "yes", "--bestn", "1", eqf, etf,
              "--showvulgar", "yes", "--showalignment", "no"]
    p2g_cells = (len(prot) + 1) * (len(locus) + 1)
    saved_cut = optimal.NATIVE_TPU_CELLS
    # the K1/K4 inputs of the run, captured on the way
    e_kis = []
    real_tki = cw.to_kernel_inputs

    def capture_ki(*args, **kwargs):
        e_kis.append(real_tki(*args, **kwargs))
        return e_kis[-1]

    observe.reset()
    zero_counts()
    try:
        optimal.NATIVE_TPU_CELLS = P2G_E_CUTOVER
        cw.to_kernel_inputs = capture_ki
        out_e, secs_e = run_cli(argv_e)
        cw.to_kernel_inputs = real_tki
        e_launches = read_counts("protein2genome -E yes",
                                 ("K1", "K4", "walkback", "K9"))
        e_eng = dict(observe.engine_counts)
        optimal.NATIVE_TPU_CELLS = p2g_cells + 1
        observe.reset()
        nat_e, nat_secs_e = run_cli(argv_e)
    finally:
        optimal.NATIVE_TPU_CELLS = saved_cut
        cw.to_kernel_inputs = real_tki
    ops_e = _vulgar_ops(out_e)
    print(f"protein2genome -E yes calm protein {len(prot)} aa x locus "
          f"{len(locus)} bp [{card}]: kernels {secs_e:.2f} s, native "
          f"{nat_secs_e:.2f} s (host clock); engines {e_eng}; launches "
          f"{e_launches}; vulgar ops {ops_e}; K1/K4 inputs (mode, B, Qp, "
          f"Tp) {[(k.mode, k.batch, k.Qp, k.Tp) for k in e_kis]}")
    if out_e != nat_e:
        raise RuntimeError("protein2genome -E yes: the kernels' output "
                           "differs from the native route's")
    if len(ops_e) != 1 or ops_e[0].count("I") != 2 \
            or ops_e[0].count("S") != 4:
        raise RuntimeError("protein2genome -E yes: want split codons (S) "
                           "at both introns")
    # every K1/K4 launch of the run is held to the plain version on its
    # own inputs, in a worker process; the first widest region scan is
    # kernel K9's row (timed in phase 7)
    e_main = max((k for k in e_kis if k.mode == "region"),
                 key=lambda k: k.batch * (k.Qp + 1) * (k.Tp + 1))
    e_pool = _pool(1)
    pools.append(e_pool)
    for n, ki in enumerate(e_kis):
        path = _save_wave(os.path.join(tmp_dir, f"p2g_e_{n}.pt"), ki,
                          _wave_outputs(cw, ki))
        res = e_pool.apply_async(_plain_wave_check, (path,))
        if ki is e_main:
            e_pending = res
        pending.append((f"protein2genome -E launch {n} ({ki.mode}, Qp "
                        f"{ki.Qp} x Tp {ki.Tp})", list(range(ki.batch)),
                        res))

    # -- 5d. the non-boundary models (K6/K7 built with TRACK_SID) --------
    # phase 4's cDNAs under affine:local and phase 5b's proteins under
    # protein2dna against phase 4's genome, on the forced device route:
    # every comparison with seeds on the kernels, the bytes the native
    # route's; then K6/K7 again on each launch of the scans' band batches
    # (timed), and the affine:local scan's widest comparison alone,
    # timed and held to the plain passes in worker processes
    _mark(t_start, "5d, the non-boundary scans")
    real_make_plan = hy.make_plan
    nb_rows = {}
    for mname, qkind in NB_SCANS:
        qfile, n_q = ((qf, SCAN_QUERIES) if qkind == "q"
                      else (pqf, len(proteins)))
        label = f"{mname} scan {n_q} x {SCAN_LEN / 1e6:.0f} Mb"
        seeded = [0]

        def count_plan(model_, pair_):
            # the pool plans a band only for a comparison with seeds
            seeded[0] += 1
            return real_make_plan(model_, pair_)

        hy.make_plan = count_plan
        try:
            out_nb, eng_nb, batches_nb, _ = scan(
                label, ["-m", mname] + NB_ARGV + [qfile, tf],
                "EXONERATE_TPU_SDP=device", ("K6", "K7", "K6 sid", "K7 sid"),
                force="device", liveness=True)
        finally:
            hy.make_plan = real_make_plan
        nb_jobs = [j for _m, js, _s in batches_nb for j in js]
        if eng_nb.get(cs.engine_name(dev)) != seeded[0] or \
                len(nb_jobs) != seeded[0] or not _vulgar(out_nb):
            raise RuntimeError(f"{label}: {seeded[0]} comparisons with "
                               f"seeds, {len(nb_jobs)} sent to the card, "
                               f"engines {eng_nb}")
        nb_model = batches_nb[0][0]
        k6_nb, k7_nb, nb_shapes, nb_work = check_launches(
            mname, nb_model, nb_jobs, [])
        ws = [pl.W for _, pl in nb_jobs]
        print(f"  {mname} band batch: {len(nb_jobs)} comparisons, Q "
              f"{nb_jobs[0][0].region.query_length}, W {min(ws)}-{max(ws)},"
              f" launches (B, Qp, Wp, K6 / K7 (C, T, ring in shared "
              f"memory)) {nb_shapes} [{card}]: K6 {k6_nb:.3f} ms, K7 "
              f"{k7_nb:.3f} ms (CUDA events, summed over the launches); "
              f"CLI {route_secs[label]:.2f} s host clock")
        nb_rows[mname] = (k6_nb, k7_nb, nb_work, len(nb_jobs), nb_shapes,
                          route_secs[label])
        if mname == "affine:local":
            wide = max(nb_jobs, key=lambda j: j[1].W)
            bi = cs.band_inputs(nb_model, [wide], wide[0].args.dropoff, dev)
            start_w, live_rw = cs.band_reverse(bi)
            col_w, live_fw, xb_w = cs.band_forward(bi, start_w)
            nb_k6_ms = (_cuda_ms(lambda: cs.band_reverse(bi), 3)
                        + _cuda_ms(lambda: cs.band_reverse(bi), 3)) / 2
            nb_k7_ms = (_cuda_ms(lambda: cs.band_forward(bi, start_w), 3)
                        + _cuda_ms(lambda: cs.band_forward(bi, start_w), 3)
                        ) / 2
            nb_pool, nb_pending = _start_plain_check(
                "affine:local widest", bi,
                {"bits": start_w, "live_r": live_rw, "colbest": col_w,
                 "live_f": live_fw, "xband": xb_w}, tmp_dir,
                [(False, [0]), (True, [0])])
            pools.append(nb_pool)
            pending.extend(nb_pending)
            nb_work_w = (_band_work(bi, False), _band_work(bi, True))
            nb_shape = (f"Q {wide[0].region.query_length} x W {wide[1].W}, "
                        f"{len(wide[0].seeds)} seeds, Qp {bi.Qp} x Wp "
                        f"{bi.Wp}")
            print(f"  affine:local's widest comparison alone ({nb_shape}) "
                  f"[{card}]: K6 {nb_k6_ms:.3f} ms, K7 {nb_k7_ms:.3f} ms "
                  f"(CUDA events; clusters (C, T, ring in shared memory): "
                  f"K6 {cs.last_fit[False]}, K7 {cs.last_fit[True]}); "
                  f"{int((start_w > sd.NEG).sum())} of its seeds with a "
                  f"start score; the plain passes started in worker "
                  f"processes")
            del bi, start_w, col_w

    # -- 5e. exonerate-server with its device index ---------------------
    _mark(t_start, "5e, exonerate-server and its device index")
    srv_qf = _write_fasta(os.path.join(tmp_dir, "srv_q.fa"),
                          [(f"q{k}", q) for k, q in
                           enumerate(queries[:SRV_QUERIES])])
    observe.reset()
    zero_counts()
    srv_res = _server_phase(dev, tf, srv_qf, tmp_dir, run_cli, card)
    srv_launches = read_counts("exonerate-server clients", ())
    print(f"  launches of the server phase's CLI runs: {srv_launches}")

    # -- 5f. the row-scan tier (engine/sdp_rows.py, torch ops) ----------
    # phase 5b's first proteins on the forced rows route: the bytes the
    # native route's, the fallbacks the same run's on the CPU, one
    # bucket's row-pass outputs the CPU's field by field (both references
    # in worker processes, read in phase 14)
    _mark(t_start, "5f, the row-scan tier")
    from exonerate_tpu_torch.engine import sdp_rows
    rows_calls = []
    real_rows_fn = sdp_rows.get_fn

    def spy_rows(*args, **kwargs):
        fn = real_rows_fn(*args, **kwargs)

        def timed(inputs, device=None):
            t0 = time.perf_counter()
            res = fn(inputs, device=device)
            _sync()
            rows_calls.append((time.perf_counter() - t0, res))
            return res
        return timed

    os.environ.update(ROWS_ENV)
    sdp_rows.get_fn = spy_rows
    observe.reset()
    zero_counts()
    try:
        rows_out, rows_secs = run_cli(rows_argv, ("sdp device->host",))
        rows_launches = read_counts("row-scan tier", ())
        rows_eng = dict(observe.engine_counts)
        rows_falls = dict(observe.fallback_counts)
    finally:
        sdp_rows.get_fn = real_rows_fn
        for knob in ROWS_ENV:
            os.environ.pop(knob, None)
    if rows_eng.get("sdp-rows", 0) < 1 or not rows_calls:
        raise RuntimeError(f"row-scan tier: no comparison on sdp-rows: "
                           f"{rows_eng}")
    off_card = [k for _s, res in rows_calls for k, v in res.items()
                if v.device.type != "cuda"]
    if off_card:
        raise RuntimeError(f"row-scan tier: outputs {off_card} not on the "
                           f"card")
    rows_dp = sum(int(res["live"].shape[0]) for _s, res in rows_calls)
    rows_kernel_s = sum(secs for secs, _r in rows_calls)
    rows_shape = [(int(res["live"].shape[0]),
                   int(res["row_sweeps_rev"].shape[1]),
                   int(res["row_sweeps_rev"].sum()),
                   int(res["row_sweeps_fwd"].sum()),
                   int(res["sweeps"].max()), round(secs, 3))
                  for secs, res in rows_calls]
    rows_first = {k: v.cpu().numpy() for k, v in rows_calls[0][1].items()}
    print(f"row-scan tier, protein2genome {ROWS_PROTEINS} x "
          f"{SCAN_LEN / 1e6:.0f} Mb both strands [{card}]: CLI "
          f"{rows_secs:.2f} s host clock; row passes {rows_kernel_s:.2f} s "
          f"over {rows_dp} DPs ({rows_kernel_s / rows_dp * 1e3:.1f} ms per "
          f"DP); per bucket (B, rows a pass, sweeps reverse, sweeps "
          f"forward (summed over rows and pairs), most sweeps a row, s) "
          f"{rows_shape}; engines {rows_eng}; fallbacks {rows_falls}; "
          f"launches {rows_launches}; the native route and the CPU run in "
          f"worker processes")
    del rows_calls

    # -- 5g. --multihost query: 2 ranks on cuda:0 over gloo -------------
    _mark(t_start, "5g, --multihost query over gloo")
    mh_qf = _write_fasta(os.path.join(tmp_dir, "mh_q.fa"),
                         [(f"q{k}", q) for k, q in
                          enumerate(queries[:MH_QUERIES])])
    mh_argv = SCAN_ARGV + [mh_qf, tf]
    observe.reset()
    mh_one, mh_one_secs = run_cli(mh_argv)
    mh_outs, mh_secs = _multihost(mh_argv, "query")
    merged = mh_outs[0].replace(" --multihost query", "")
    if merged != mh_one or "vulgar:" not in merged:
        raise RuntimeError("--multihost query: rank 0's merged report "
                           "differs from one process's")
    if any(len(o.splitlines()) != 3 for o in mh_outs[1:]):
        raise RuntimeError("--multihost query: a rank > 0 printed more "
                           "than its header and footer")
    print(f"--multihost query, {MH_RANKS} ranks on cuda:0 over gloo, "
          f"{MH_QUERIES} cDNAs x {SCAN_LEN / 1e6:.0f} Mb est2genome "
          f"[{card}]: {mh_secs:.2f} s host clock (processes started to "
          f"ended), one process {mh_one_secs:.2f} s; rank 0's merged "
          f"report == one process's ({len(_vulgar(merged))} vulgar lines)")

    # -- 5h. the multi-device dry run on [cuda:0, cuda:0] ---------------
    _mark(t_start, "5h, the multi-device dry run")
    from exonerate_tpu_torch.parallel.dryrun import dryrun_multichip
    zero_counts()
    t0 = time.perf_counter()
    dry = dryrun_multichip([dev, dev])
    _sync()
    dry_secs = time.perf_counter() - t0
    dry_launches = read_counts("dryrun_multichip",
                               ("K1", "K5", "K6", "K7", "K8"))
    print(f"dryrun_multichip([cuda:0, cuda:0]) [{card}]: every route "
          f"equal to one device in {dry_secs:.2f} s host clock; launches "
          f"{dry_launches}; {dry}")

    # -- 5i. the host tools: ipcress against the C reference's ----------
    _mark(t_start, "5i, the host tools")
    _ipcress_phase(genome, tf, tmp_dir, card)

    # -- 6. the SubOpt mask (kernel K3) ----------------------------------
    _mark(t_start, "6, the SubOpt mask")
    # a. est2genome -E yes Waterman-Eggert: calm against two interleaved
    # spliced copies of itself in a 30 kb window
    calm_s = sc.calm()
    we_locus = sc.two_copy_locus(calm_s, WE_GAP, WE_LEN, WE_START)
    wqf = _write_fasta(os.path.join(tmp_dir, "calm.fa"), [("calm", calm_s)])
    wtf = _write_fasta(os.path.join(tmp_dir, "we.fa"), [("two_copies",
                                                          we_locus)])
    argv_we = ["-m", "est2genome", "-E", "yes", "--bestn", "2", "--score",
               str(WE_SCORE), wqf, wtf, "--showvulgar", "yes",
               "--showalignment", "no"]
    we_cells = (len(calm_s) + 1) * (len(we_locus) + 1)
    # the native routes of this phase and of phase 9 run in worker
    # processes on host cores (the native dense DP needs no card), beside
    # the card's phases; their outputs are compared in phase 14
    nat_pool = _pool(1 + len(CH_STARTS))
    pools.append(nat_pool)
    nat_we_res = nat_pool.apply_async(
        _cpu_cli, (argv_we, None, we_cells,
                   we_cells * len(model.states) * 2))
    chrom = sc.chromosome_locus(calm_s, CH_LEN, CH_STARTS, CH_INTRON)
    ctf = _write_fasta(os.path.join(tmp_dir, "chrom.fa"),
                       [("chromosome", chrom)])
    cqf = _write_fasta(os.path.join(tmp_dir, "chrom_calm.fa"),
                       [("calm", calm_s)])

    def argv_ch(target):
        return ["-m", "est2genome", "-E", "yes", "--bestn", "2", "--score",
                str(CH_SCORE), "--revcomp", "no", cqf, target,
                "--showvulgar", "yes", "--showalignment", "no"]

    ch_windows = []
    for k, start in enumerate(CH_STARTS):
        # a CH_WIN window centred on the copy (its span is CH_SPAN), its
        # record named as the whole target's
        w0 = start + CH_SPAN // 2 - CH_WIN // 2
        wf_k = _write_fasta(os.path.join(tmp_dir, f"chrom_win{k}.fa"),
                            [("chromosome", chrom[w0:w0 + CH_WIN])])
        win_cells = (len(calm_s) + 1) * (CH_WIN + 1)
        ch_windows.append((w0, nat_pool.apply_async(_cpu_cli, (
            argv_ch(wf_k), None, win_cells,
            win_cells * len(model.states) * 2))))
    we_kis, iters = [], [0]
    real_fp = optimal.find_path

    def count_fp(model_, region, *args, **kwargs):
        # the Waterman-Eggert iterations: find_path on the whole pair
        if (region.query_length, region.target_length) == (
                len(calm_s), len(we_locus)):
            iters[0] += 1
        return real_fp(model_, region, *args, **kwargs)

    def capture_we(*args, **kwargs):
        we_kis.append(real_tki(*args, **kwargs))
        return we_kis[-1]

    we_time = {}
    observe.reset()
    zero_counts()
    try:
        cw.to_kernel_inputs = capture_we
        optimal.find_path = count_fp
        with _timed(cw, WAVE_CLOCKS, we_time):
            out_we, secs_we = run_cli(argv_we)
    finally:
        cw.to_kernel_inputs = real_tki
        optimal.find_path = real_fp
    we_launches = read_counts("est2genome -E yes Waterman-Eggert",
                              ("K2", "K4", "walkback", "K3", "ring smem"))
    we_eng = dict(observe.engine_counts)
    we_shapes = [(k.mode, k.batch, k.Qp, k.Tp, "masked" if k.masked
                  else "mask-free") for k in we_kis]
    print(f"est2genome -E yes Waterman-Eggert calm {len(calm_s)} x "
          f"{len(we_locus)} bp, two interleaved spliced copies [{card}]: "
          f"{iters[0]} iterations; kernels {secs_we:.2f} s (host clock; "
          f"the native route runs in a worker process, compared in phase "
          f"14); engines {we_eng}; launches {we_launches}; K1/K4 launches "
          f"{we_shapes}")
    print(f"  where the kernel route's {secs_we:.2f} s go (host clock): "
          f"{_breakdown(we_time, secs_we)}; K1 batches by the JAX package's "
          f"K2 test (B, Qp, Tp, MB of 24): {_k2_mb(we_kis)}")
    ops_we = _vulgar_ops(out_we)
    if len(ops_we) != 2 or any(o.count("I") != 2 for o in ops_we):
        raise RuntimeError(f"est2genome -E yes: want both copies with two "
                           f"introns each, got {ops_we}")
    # every DP of the run is B=1, whose cluster fits the card: those of
    # two CTAs a pair or more run on the cluster kernel with its ring in
    # shared memory, the region scans as K2 (K3 inside the masked ones)
    # and the path DPs as K4 on a cluster; any of one CTA a pair on K1/K4
    wide = [cw.cluster_capacity(k)[0] >= cw.MIN_ROUTED_CLUSTER
            for k in we_kis]
    n_masked = sum(k.masked for k in we_kis)
    n_masked_region = sum(k.masked and k.mode == "region" for k in we_kis)
    n_k2 = sum(w and k.mode == "region" for k, w in zip(we_kis, wide))
    if not n_masked_region \
            or not any(k.masked and k.mode == "path" for k in we_kis) \
            or we_launches["K3"] != n_masked \
            or we_launches.get("K2", 0) != n_k2 \
            or we_launches.get("K1", 0) != sum(
                k.mode == "region" for k in we_kis) - n_k2 \
            or we_launches.get("ring smem", 0) != sum(wide) \
            or we_launches.get("ring global", 0):
        raise RuntimeError(f"est2genome -E yes: every DP of two CTAs a pair "
                           f"or more must run on the cluster kernel with "
                           f"its ring in shared memory, the others on "
                           f"K1/K4 ({we_shapes}; launches {we_launches})")
    # the widest masked region scan (kernel K3's row, timed here on the
    # cluster, and once on K1, the route it took until now) and the first
    # masked path DP are held to their plain versions in worker processes
    we_main = max((k for k in we_kis if k.masked and k.mode == "region"),
                  key=lambda k: k.batch * (k.Qp + 1) * (k.Tp + 1))
    we_path = next(k for k in we_kis if k.masked and k.mode == "path")
    we_free = next(k for k in we_kis if not k.masked and k.mode == "region"
                   and (k.Qp, k.Tp) == (we_main.Qp, we_main.Tp))
    del we_kis
    we_pool = _pool(2)
    pools.append(we_pool)
    we_pending = {}
    for tag, ki in (("K3", we_main), ("K4", we_path)):
        outs = _wave_outputs(cw, ki, cluster=True)
        if tag == "K3":
            k3_ms = _cuda_ms(lambda: cw._launch(we_main, 0), 2)
            free_ms = _cuda_ms(lambda: cw._launch(we_free, 0), 1)
            k3_k1, k3_k1_ms = _cuda_call(lambda: cw._launch(we_main)[0])
            if not torch.equal(k3_k1, outs["out"]):
                raise RuntimeError(f"K3's row: K1 {k3_k1.tolist()} != the "
                                   f"cluster's {outs['out'].tolist()}")
        path = _save_wave(os.path.join(tmp_dir, f"we_{tag}.pt"), ki, outs)
        del outs
        we_pending[tag] = we_pool.apply_async(_plain_wave_check, (path,))
        pending.append((f"est2genome -E yes masked {tag} on the cluster "
                        f"({ki.mode}, Qp {ki.Qp} x Tp {ki.Tp} x{ki.batch})",
                        list(range(ki.batch)), we_pending[tag]))
    k3_shape = (f"Qp {we_main.Qp} x Tp {we_main.Tp} x{we_main.batch}, "
                f"{len(calm_s)} x {len(we_locus)}")
    print(f"K2 region with K3, the -E run's widest masked scan ({k3_shape}, "
          f"C={cw.cluster_capacity(we_main)[0]}, {cw.cluster_capacity(we_main)[1]} "
          f"clusters resident, the ring in shared memory "
          f"{cw.ring_in_smem(we_main)}) [{card}]: kernel {k3_ms:.3f} ms, the "
          f"same pair mask-free {free_ms:.3f} ms; on K1 (one CTA) "
          f"{k3_k1_ms:.3f} ms, equal (CUDA events); its plain check and the "
          f"first masked path DP's on the cluster (Qp {we_path.Qp} x Tp "
          f"{we_path.Tp}) started")
    k3_work = _wave_work(we_main, 5 * we_main.batch * 4)

    _mark(t_start, "6b, the locus pool")
    # b. the pooled locus heuristic at the flagship's shape: phase 4's
    # scan with EXONERATE_TPU_HEURISTIC=locus and --bestn 10, so that no
    # comparison is full after the first generation
    lo_kis, lo_gens, lo_gen0 = [], [], []
    real_fb = cw.find_batched
    lo_real_launch = cw._launch
    # each launch's route on the main path (by its KernelInputs): the
    # cluster kernel, or K1/K4
    lo_route = {}

    def capture_lo(*args, **kwargs):
        lo_kis.append(real_tki(*args, **kwargs))
        return lo_kis[-1]

    def route_lo(ki, cluster=None, span=None, ring=None):
        lo_route[id(ki)] = cluster is not None
        return lo_real_launch(ki, cluster, span, ring)

    def count_gen(model_, jobs_, mode="region", device=None, subopt=None,
                  **kwargs):
        lo_gens.append((len(jobs_), any(
            x is not None and x.points for x in subopt or [])))
        k2_before = cw.K2.launches
        res = real_fb(model_, jobs_, mode, device=device, subopt=subopt,
                      **kwargs)
        if not lo_gen0:
            lo_gen0.extend([model_, list(jobs_), res,
                            cw.K2.launches - k2_before])
        return res

    argv_lo = LOCUS_ARGV + [qf, tf]
    lo_time = {}
    observe.reset()
    zero_counts()
    os.environ["EXONERATE_TPU_HEURISTIC"] = "locus"
    try:
        cw.to_kernel_inputs = capture_lo
        cw.find_batched = count_gen
        cw._launch = route_lo
        with _timed(cw, WAVE_CLOCKS, lo_time):
            out_lo, secs_lo = run_cli(argv_lo)
    finally:
        os.environ.pop("EXONERATE_TPU_HEURISTIC")
        cw.to_kernel_inputs = real_tki
        cw.find_batched = real_fb
        cw._launch = lo_real_launch
    # the masked generations' batches whose clusters fit the card run on
    # the cluster kernel, their rings in shared memory
    lo_launches = read_counts("locus pool", ("K4", "walkback", "K3",
                                             "K2", "ring smem"))
    lo_eng = dict(observe.engine_counts)
    spliced_lo = {v[1] for v in (ln.split() for ln in out_lo.splitlines()
                                 if ln.startswith("vulgar:"))
                  if "I" in v[10::3]}
    print(f"locus pool {SCAN_QUERIES} x {SCAN_LEN / 1e6:.0f} Mb est2genome "
          f"(EXONERATE_TPU_HEURISTIC=locus, --bestn 10) [{card}]: "
          f"{secs_lo:.2f} s host clock (phase 4's default SDP route "
          f"{route_secs[scan_label]:.2f} s); {len(lo_gens)} generations "
          f"(jobs, masked) {lo_gens}; engines {lo_eng}; launches "
          f"{lo_launches}; {len(spliced_lo)}/{SCAN_QUERIES} queries spliced;"
          f" K1/K4 launches (mode, B, Qp, Tp, masked) "
          f"{[(k.mode, k.batch, k.Qp, k.Tp, k.masked) for k in lo_kis]}")
    print(f"  where the locus pool's {secs_lo:.2f} s go (host clock): "
          f"{_breakdown(lo_time, secs_lo)}; the largest K1 batches by the "
          f"JAX package's K2 test (B, Qp, Tp, MB of 24): "
          f"{sorted(_k2_mb(lo_kis), key=lambda x: -x[3])[:4]}")
    if not any(m for _, m in lo_gens) or not lo_launches.get("K3"):
        raise RuntimeError("locus pool: no masked generation ran on K3")
    if len(spliced_lo) != SCAN_QUERIES:
        raise RuntimeError(f"locus pool: {len(spliced_lo)}/{SCAN_QUERIES} "
                           f"queries with a spliced alignment")
    # the first masked region batch and the path batch after it, again on
    # a sub-batch of their two widest pairs, each on the route its launch
    # took on the main path: equal to the full batch's results for those
    # pairs, and to the plain versions (worker processes)
    lo_reg = next(n for n, k in enumerate(lo_kis)
                  if k.masked and k.mode == "region")
    lo_path = next((n for n, k in enumerate(lo_kis)
                    if n > lo_reg and k.masked and k.mode == "path"),
                   next(n for n, k in enumerate(lo_kis)
                        if n > lo_reg and k.mode == "path"))
    # and the first masked region batch of two or more pairs that ran on
    # the cluster kernel (each pair reads its own mask plane there)
    lo_cl = [n for n, k in enumerate(lo_kis) if k.masked
             and k.mode == "region" and lo_route[id(k)]]
    lo_cl = next((n for n in lo_cl if lo_kis[n].batch > 1), lo_cl[0])
    lo_pool = _pool(2)
    pools.append(lo_pool)
    lo_checked = []
    for n in sorted({lo_reg, lo_cl, lo_path}):
        ki = lo_kis[n]
        on_cl = lo_route[id(ki)]
        idx = _widest(ki)
        whole = _wave_outputs(cw, ki, on_cl)
        sub = _sub_batch(ki, idx)
        outs = _wave_outputs(cw, sub, on_cl)
        ix = torch.tensor(idx, device=dev)
        same = torch.equal(outs["out"], whole["out"][:, ix])
        if ki.mode == "path":
            same = same and torch.equal(outs["res"], whole["res"][:, ix])
            same = same and all(
                torch.equal(outs["ops"][k, :int(outs["res"][0, k])],
                            whole["ops"][b, :int(outs["res"][0, k])])
                for k, b in enumerate(idx))
        del whole
        if not same:
            raise RuntimeError(f"locus pool launch {n} ({ki.mode}): pairs "
                               f"{idx} differ from the full batch's")
        path = _save_wave(os.path.join(tmp_dir, f"locus_{n}.pt"), sub, outs)
        del outs
        route = "cluster" if on_cl else "K1/K4"
        pending.append((f"locus pool launch {n} ({ki.mode} on {route}, "
                        f"masked {ki.masked}, Qp {ki.Qp} x Tp {ki.Tp}, "
                        f"pairs {idx} of B={ki.batch})", idx,
                        lo_pool.apply_async(_plain_wave_check, (path,))))
        lo_checked.append((n, ki.mode, route, ki.batch, ki.Qp, ki.Tp, idx))
    del lo_kis, lo_route
    print(f"  locus pool: launches {lo_checked} (launch, mode, route, B, "
          f"Qp, Tp, pairs) equal the full batch's results on the route of "
          f"the main path; plain checks started")

    # c. K5, the sharded locus prescan: 6b's first generation through
    # find_batched_sharded over [cuda:0, cuda:0] (or the distinct cards),
    # equal to that generation's results on K1 on one device (forced:
    # the route gives its chunks whose clusters fit the card to K2, and
    # those results must equal K1's too); the shards of its chunk with
    # the most cells launched again, timed, and held to the plain version
    # in worker processes
    _mark(t_start, "6c, K5 on the locus pool's first generation")
    lo_model, lo_jobs, gen0_res, gen0_k2 = lo_gen0

    def _dp(r):
        return (r.score, r.query_start, r.target_start, r.query_end,
                r.target_end)

    want5 = cw.find_batched(lo_model, lo_jobs, "region", device=dev,
                            stream=False)
    if [_dp(r) for r in gen0_res] != [_dp(r) for r in want5]:
        raise RuntimeError(f"the locus pool's first generation ({gen0_k2} "
                           f"K2 launches) != find_batched(stream=False)")
    k5_devs = ([torch.device("cuda", k)
                for k in range(torch.cuda.device_count())]
               if torch.cuda.device_count() >= 2 else [dev, dev])
    k5_kis = []

    def capture5(*args, **kwargs):
        k5_kis.append(real_tki(*args, **kwargs))
        return k5_kis[-1]

    zero_counts()
    cw.to_kernel_inputs = capture5
    try:
        got5, ms5 = _cuda_call(lambda: cw.find_batched_sharded(
            lo_model, lo_jobs, k5_devs, "region"))
    finally:
        cw.to_kernel_inputs = real_tki
    k5_launches = read_counts("K5 on the locus pool's first generation",
                              ("K5", "K1"))

    if [_dp(r) for r in got5] != [_dp(r) for r in want5]:
        raise RuntimeError("K5 != find_batched(stream=False) on the locus "
                           "pool's first generation")
    if len(k5_kis) != k5_launches["K5"]:
        raise RuntimeError(f"K5: {len(k5_kis)} shards built, "
                           f"{k5_launches['K5']} launched")
    # find_batched builds a chunk's shards one after another
    k5_groups = [k5_kis[k:k + len(k5_devs)]
                 for k in range(0, len(k5_kis), len(k5_devs))]
    k5_sel = max(k5_groups, key=lambda g: sum(
        int(((ki.dims[:, 2].long() + 1) * (ki.dims[:, 3].long() + 1)).sum())
        for ki in g))
    del k5_kis, k5_groups
    # the shard with the most cells is timed and held to the plain version
    # (one host core; the others equal K1's results above)
    n_shards = len(k5_sel)
    k5_sel = max(k5_sel, key=lambda ki: int(
        ((ki.dims[:, 2].long() + 1) * (ki.dims[:, 3].long() + 1)).sum()))
    k5_out = cw.wavefront_scan(k5_sel)
    k5_ms = _cuda_ms(lambda: cw.wavefront_scan(k5_sel), 3)
    path = _save_wave(os.path.join(tmp_dir, "k5.pt"), k5_sel,
                      {"out": k5_out})
    k5_pending = [lo_pool.apply_async(_plain_wave_check, (path,))]
    pending.append((f"K5 shard on {k5_sel.dims.device} (region, Qp "
                    f"{k5_sel.Qp} x Tp {k5_sel.Tp} x{k5_sel.batch})",
                    list(range(k5_sel.batch)), k5_pending[-1]))
    k5_work = _wave_work(k5_sel, 5 * k5_sel.batch * 4)
    k5_shape = (f"the locus pool's first generation, {len(lo_jobs)} jobs; "
                f"the widest of the {n_shards} shards of its widest chunk, "
                f"Qp {k5_sel.Qp} x Tp {k5_sel.Tp} x{k5_sel.batch}")
    del k5_sel, k5_out
    print(f"K5 on {k5_shape}, over {[str(d) for d in k5_devs]} [{card}]: "
          f"the generation {ms5:.3f} ms with host prep (CUDA events), == "
          f"its K1 results in phase 6b; launches {k5_launches}; the widest "
          f"shard again {k5_ms:.3f} ms (CUDA events), its plain check "
          f"started")

    # -- 7. K1 vs plain --------------------------------------------------
    _mark(t_start, "7, K1 vs plain")
    # the plain versions run on host cores (worker processes) beside the
    # card's phases; region mode's time is K1's plain time
    k1_pool = _pool(2)
    pools.append(k1_pool)
    k1_res = {}
    for mode in ("score", "region"):
        ki = cw.to_kernel_inputs(model, [inputs] * BATCH, kinds, dev, mode)
        got = cw.wavefront_scan(ki)
        ms = _cuda_ms(lambda: cw.wavefront_scan(ki), 3)
        if set(got[0].tolist()) != {CALM_SELF_SCORE}:
            raise RuntimeError(f"K1 {mode}: scores {set(got[0].tolist())}")
        k1_name = f"K1 {mode} calm {CALM_LEN}^2 x{BATCH}"
        k1_path = _save_wave(os.path.join(tmp_dir, f"k1_{mode}.pt"), ki,
                             {"out": got})
        k1_res[mode] = k1_pool.apply_async(_plain_wave_check, (k1_path,))
        pending.append((k1_name, list(range(BATCH)), k1_res[mode]))
        print(f"{k1_name} [{card}]: kernel {ms:.3f} ms "
              f"({ms / BATCH:.4f} ms/pair, "
              f"{cells * BATCH / ms / 1e6:.3f} GCUPS, "
              f"{cw.plan_threads(ki)} threads a CTA); plain check started")
        report[f"K1_{mode}"] = (0, ms, 0.0, _wave_work(ki, 5 * BATCH * 4))
    ragged = [(Region(0, 0, 100, 160), data), (Region(40, 10, 80, 150), data),
              (Region(10, 30, 120, 90), data)]
    pa = Sequence("a", None, "MKVLAAGICAGWLLWKKMKVL")
    pb = Sequence("b", None, "MKVLGAGICAWWLLAKKMK")
    amodel = affine_create(AffineModelType.LOCAL, AlphabetType.PROTEIN,
                           AlphabetType.PROTEIN)
    for m, jobs in ((model, ragged),
                    (amodel, [(Region(0, 0, len(pa), len(pb)),
                               AlignData(pa, pb))])):
        for mode in ("score", "region"):
            g = cw.find_batched(m, jobs, mode, device=dev)
            c = cw.find_batched(m, jobs, mode, device=cpu)
            if g != c:
                raise RuntimeError(f"K1 {mode} ragged {m.name}: {g} != {c}")
    print("K1 ragged batches (est2genome x3, affine:local protein): equal")
    # the rest of the zoo the kernels serve: every start/end scope, the
    # K=4/6 carry rings of codon models, NER; region and path modes; the
    # split-codon pairs of coding2genome and cdna2genome.  The plain
    # versions run in a worker process (read in phase 14)
    zoo_pool = _pool(1)
    pools.append(zoo_pool)
    zoo_plain = zoo_pool.apply_async(_zoo_plain)
    zoo_card = _zoo_results(dev)
    print(f"K1/K4 model zoo ({', '.join(zoo_card)}) [{card}]: launched; "
          f"the plain versions started in a worker process")
    # the split-codon plans at width: the calm protein against 8 windows
    # of the 12 kb locus (each holds the whole gene)
    p2g = registry.get_model(registry.ModelType.PROTEIN2GENOME,
                             AlphabetType.PROTEIN, AlphabetType.DNA)
    pdata = AlignData(Sequence("calm", None, prot),
                      Sequence("locus", None, locus))
    windows = [Region(0, 2800 + 30 * k, len(prot), 2000) for k in range(8)]
    wQp, wTp = wf._bucket(len(prot)), wf._bucket(2000)
    per = [wf.prepare_inputs(p2g, r, pdata, pad_to=(wQp, wTp),
                             for_pallas=True) for r in windows]
    # each launch held to its plain version on a host core (worker)
    w_pool = _pool(2)
    pools.append(w_pool)
    for mode in ("score", "region", "path"):
        ki = cw.to_kernel_inputs(p2g, [p for p, _ in per], per[0][1], dev,
                                 mode)
        outs = _wave_outputs(cw, ki)
        wname = (f"K1/K4 {mode} protein2genome calm protein x 8 windows of "
                 f"2000 bp (split codons, K9)")
        w_path = _save_wave(os.path.join(tmp_dir, f"p2g_windows_{mode}.pt"),
                            ki, outs)
        del outs
        pending.append((wname, list(range(ki.batch)),
                        w_pool.apply_async(_plain_wave_check, (w_path,))))
        print(f"{wname} [{card}]: plain check started")
    # K1 on the p2g -E yes run's own inputs (its first widest region scan,
    # B=1), timed: kernel K9's row (its plain check runs in a worker
    # process since phase 5c)
    e_ms = _cuda_ms(lambda: cw.wavefront_scan(e_main), 3)
    e_shape = (f"Qp {e_main.Qp} x Tp {e_main.Tp} x{e_main.batch}, "
               f"{len(prot)} x {len(locus)}")
    print(f"K1 region protein2genome -E yes run's scan ({e_shape}; split "
          f"codons, K9) [{card}]: kernel {e_ms:.3f} ms")
    k9_work = _wave_work(e_main, 5 * e_main.batch * 4)

    # -- 8. K4 + walk-back vs plain and the native dense DP --------------
    # K4's plain version (with the walk-back's over the kernel's cube) on
    # a host core (worker process, read in phase 14); the walk-back's on
    # the card
    _mark(t_start, "8, K4 and the walk-back")
    ki = cw.to_kernel_inputs(model, [inputs], kinds, dev, "path")
    k4_outs = _wave_outputs(cw, ki)
    stats, tb = k4_outs["out"], k4_outs["tb"]
    path_ms = _cuda_ms(lambda: cw.wavefront_path(ki), 2)
    k4_res = w_pool.apply_async(_plain_wave_check, (_save_wave(
        os.path.join(tmp_dir, "k4_calm.pt"), ki, k4_outs),))
    del k4_outs
    pending.append((f"K4 path calm {CALM_LEN}^2 x1", [0], k4_res))
    D, W = Qp + Tp + 1, Qp + 1
    cap = D + cw.WALK_SLACK
    (ops, res), (p_ops, p_res), walk_ms, walk_plain_ms = _turns(
        lambda: wf.plain_walkback(tb, stats, ki.walk, ki.end_id, cap),
        lambda: cw.walkback(tb, stats, ki.walk, ki.end_id, cap), 10)
    k = int(res[0, 0])
    if not torch.equal(res, p_res) or not torch.equal(ops[:, :k],
                                                      p_ops[:, :k]):
        raise RuntimeError("walk-back: kernel != plain")
    walk_err = _max_err(res, p_res)
    del tb
    got = cw.find_path_batched(model, [(full, data)], device=dev)[0]
    t0 = time.perf_counter()
    nat = sdp_native.run_viterbi(model, full, data, "path")
    nat_s = time.perf_counter() - t0
    if nat is None:
        raise RuntimeError("native dense DP unavailable")
    for field in ("score", "query_start", "target_start", "query_end",
                  "target_end"):
        if getattr(got, field) != getattr(nat, field):
            raise RuntimeError(f"K4 vs native: {field} {getattr(got, field)}"
                               f" != {getattr(nat, field)}")
    if got.score != CALM_SELF_SCORE or len(got.path) != len(nat.path) \
            or any(a is not b for a, b in zip(got.path, nat.path)):
        raise RuntimeError("K4 vs native: paths differ")
    print(f"K4 path calm {CALM_LEN}^2 x1 [{card}]: kernel {path_ms:.3f} ms "
          f"(its plain check started); walk-back kernel {walk_ms:.4f} ms, "
          f"plain {walk_plain_ms:.3f} ms ({k} ops); native dense DP "
          f"{nat_s * 1e3:.1f} ms (host clock); path equals native")
    S, B1 = ki.S, 1
    k4_work = _wave_work(ki, 5 * 4 + B1 * D * S * W)
    # per step the walk reads one cube byte and one id-table column and
    # writes one op; its chain floor is a shared-memory load-to-use
    # latency per step (a pointer chase on the card, in clocks at 1.98 GHz)
    smem_clocks = _smem_load_clocks(cw)
    report["walkback"] = (walk_err, walk_ms, walk_plain_ms,
                          (k * (1 + 16 + 4) + _nbytes(stats) + 12, 6 * k), k)
    print(f"walk-back tiles {wf.walk_tile(ki.walk.cpu(), ki.S)} (TD, TC); "
          f"shared-memory load-to-use latency {smem_clocks:.2f} clocks "
          f"(pointer chase) [{card}]: chain floor "
          f"{_chain_floor_ms(k, smem_clocks):.4f} ms for {k} steps")

    # -- 9. chromosome-scale -E yes (kernel K2) ----------------------------
    _mark(t_start, "9, chromosome-scale -E yes")
    # a. K2 against the plain version on forced stream=True batches (the
    # plain checks run in worker processes on one host core each); these
    # launches also load every K2 instantiation the -E run uses before K1
    # starts beside it on a stream of its own
    cdata = AlignData(calm, calm)
    sp_q, sp_t = sc.small_pair("protein")
    k2_batches = [
        ("ragged est2genome x3, Qp 2304", model,
         [(Region(0, 0, 2175, 200), cdata),
          (Region(100, 40, 2000, 180), cdata),
          (Region(300, 10, 1800, 150), cdata)], None),
        ("est2genome Qp 256", model, [(Region(0, 0, 200, 300), cdata)], None),
        ("est2genome Qp 768, qlen 600", model,
         [(Region(50, 20, 600, 240), cdata)], None),
        ("protein2genome split pair (FULL)", p2g, [
            (Region(0, 0, len(sp_q), len(sp_t)),
             AlignData(Sequence("q", None, sp_q), Sequence("t", None, sp_t),
                       registry.translate_both(
                           registry.ModelType.PROTEIN2GENOME)))], None),
    ]
    small = Region(0, 0, 300, 400)
    small_sub = SubOpt()
    small_sub.add_alignment(optimal._to_alignment(
        model, small, cw.find_path_batched(model, [(small, cdata)],
                                           device=dev)[0]))
    k2_batches.append(("est2genome masked Qp 512", model,
                       [(small, cdata)], small_sub))
    k2_pool = _pool(2)
    pools.append(k2_pool)
    k2_err, k2_checks = 0, []
    # the CTAs per pair of the last launch (1 for K1/K4)
    last_c = {"C": 0}
    real_launch = cw._launch

    def launch_c(*args, **kwargs):
        out = real_launch(*args, **kwargs)
        last_c["C"] = out[2]
        return out

    cw._launch = launch_c
    _EXIT.callback(setattr, cw, "_launch", real_launch)

    def forced_k2(label, model_, jobs_, sub):
        """find_batched(stream=True) on the card; its K2 launch made again,
        timed, equal to find_batched's results and held, in a worker
        process, to the plain version on the same inputs."""
        kis = []

        def grab(*args, **kwargs):
            kis.append(real_tki(*args, **kwargs))
            return kis[-1]

        cw.to_kernel_inputs = grab
        try:
            got = cw.find_batched(model_, jobs_, "region", device=dev,
                                  subopt=sub, stream=True)
        finally:
            cw.to_kernel_inputs = real_tki
        [ki] = kis
        out, ms = _cuda_call(lambda: cw.wavefront_stream_scan(ki))
        if [[r.score, r.query_end, r.target_end, r.query_start,
             r.target_start] for r in got] != out.t().tolist():
            raise RuntimeError(f"K2 {label}: find_batched's results differ "
                               f"from the kernel's output")
        path = _save_wave(os.path.join(tmp_dir, f"k2_{len(k2_checks)}.pt"),
                          ki, {"out": out})
        res = k2_pool.apply_async(_plain_wave_check, (path,))
        ring = "shared" if cw.ring_in_smem(ki) else "global"
        name = (f"K2 forced {label} (C={last_c['C']}, ring in {ring} "
                f"memory, masked {ki.masked}, split {ki.split}, Qp {ki.Qp} x "
                f"Tp {ki.Tp} x{ki.batch})")
        k2_checks.append((name, ms, res))
        pending.append((name, list(range(ki.batch)), res))

    for label, m, jobs, sub in k2_batches:
        forced_k2(label, m, jobs, sub)
        print(f"{k2_checks[-1][0]} [{card}]: {k2_checks[-1][1]:.3f} ms; "
              f"plain check started")
    # both ring routes are held to the plain version: est2genome's ring in
    # shared memory, the protein2genome region pair's in global memory
    if not any("ring in shared" in n for n, _ms, _r in k2_checks) \
            or not any("ring in global" in n for n, _ms, _r in k2_checks):
        raise RuntimeError(f"K2 forced batches: want both ring routes, got "
                           f"{[n for n, _ms, _r in k2_checks]}")
    # the instantiations of steps b-e (masked, on a cluster: score mode
    # forward and path mode for the walk back and the copies' path DPs,
    # region mode with its ring in global memory for e's comparison, and
    # e's empty plan, a library of its own) and d's segment walk-back,
    # launched once on the masked pair so that CUDA loads them now: a
    # kernel loads at its first launch, and that load waits for the
    # kernels running then, K1's side check below among them (which d and
    # e overlap); d and e time no load
    (warm_key, warm_items), = cw._buckets(model, [(small, cdata)],
                                          small_sub).items()
    warm = cw.to_kernel_inputs(model, [warm_items[0][1]], warm_key[2], dev,
                               "path")
    for ki in (cw.with_mode(warm, "score"), warm):
        w_out, w_tb = cw.wavefront_segment(ki, cw.ring_buffers(ki),
                                           (0, ki.Qp + ki.Tp + 1))
    cw.walk_segment(w_tb, 0, torch.stack(
        [w_out[1], w_out[2], torch.full_like(w_out[1], warm.end_id)]),
        warm.walk, w_tb.shape[1] + cw.WALK_SLACK)
    warm_region = cw.to_kernel_inputs(model, [warm_items[0][1]], warm_key[2],
                                      dev, "region")
    with _global_ring(cw):
        real_launch(warm_region, 0)
    real_launch(_empty_plan(warm_region), 0)
    _sync()

    _mark(t_start, "9b, the chromosome-scale CLI run")
    # b. est2genome -E yes --bestn 2 --score 5000 through the CLI: calm
    # against CH_LEN bp with two spliced copies; every whole-target region
    # scan (Qp 2304 x Tp 1356288, B=1) runs on K2, the copies' boxes on K1
    # and K4.  The first scan's inputs go to K1 on a side stream (one CTA,
    # about as long as the rest of the phase), held to K2's output last.
    ch_scans, pend = [], {}
    side = torch.cuda.Stream()
    k1_full = {}
    k1_launch = cw._launch          # the uncounted launcher, untimed
    real_k2, real_bk, real_plane = (cw.wavefront_stream_scan, cw._buckets,
                                    wf.blocked_plane)

    def spy_buckets(model_, jobs_, subopt=None):
        pend.clear()
        pend["whole"] = jobs_[0][0].target_length == len(chrom)
        pend["points"] = (set() if not isinstance(subopt, SubOpt)
                          else set(subopt.points))
        t0 = time.perf_counter()
        out = real_bk(model_, jobs_, subopt)
        pend["prep"] = time.perf_counter() - t0
        return out

    def spy_plane(*args, **kwargs):
        t0 = time.perf_counter()
        out = real_plane(*args, **kwargs)
        pend["mask"] = pend.get("mask", 0.0) + time.perf_counter() - t0
        return out

    def spy_k2(ki):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = real_k2(ki)
        ev[1].record()
        ch_scans.append(dict(pend, ev=ev, C=last_c["C"], out=out, ki=ki,
                             shape=(ki.batch, ki.Qp, ki.Tp),
                             masked=ki.masked, mb=_k2_mb([ki])[0][3]))
        if len(ch_scans) == 1:
            # K1 on the same inputs, uncounted, beside the rest of the run
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                k1_ev = (torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True))
                k1_ev[0].record()
                k1_out, _, _ = k1_launch(ki)
                k1_ev[1].record()
            k1_full.update(ki=ki, out=k1_out, ev=k1_ev)
        return out

    ch_time, ch_kis = {}, []

    def capture_ch(*args, **kwargs):
        t0 = time.perf_counter()
        k = real_tki(*args, **kwargs)
        pend["copies"] = time.perf_counter() - t0
        ch_kis.append((k.mode, k.batch, k.Qp, k.Tp, k.masked))
        return k

    observe.reset()
    zero_counts()
    try:
        cw.wavefront_stream_scan = spy_k2
        cw._buckets = spy_buckets
        wf.blocked_plane = spy_plane
        cw.to_kernel_inputs = capture_ch
        with _timed(cw, WAVE_CLOCKS, ch_time):
            out_ch, secs_ch = run_cli(argv_ch(ctf))
    finally:
        cw.wavefront_stream_scan = real_k2
        cw._buckets = real_bk
        wf.blocked_plane = real_plane
        cw.to_kernel_inputs = real_tki
    ch_launches = read_counts("chromosome-scale -E yes",
                              ("K2", "K4", "walkback", "K3"))
    ch_eng = dict(observe.engine_counts)
    whole = [s for s in ch_scans if s["whole"]]
    print(f"chromosome-scale est2genome -E yes calm {len(calm_s)} x "
          f"{len(chrom)} bp, two spliced copies at {CH_STARTS} [{card}]: "
          f"{secs_ch:.2f} s host clock; engines {ch_eng}; launches "
          f"{ch_launches}; K1/K4 launches (mode, B, Qp, Tp, masked) "
          f"{[k for k in ch_kis if k[3] < len(chrom)]}")
    for n, s in enumerate(ch_scans):
        s["ms"] = s["ev"][0].elapsed_time(s["ev"][1])
        print(f"  K2 scan {n} ({'the whole target' if s['whole'] else 'a box'}"
              f"; B, Qp, Tp) {s['shape']}, masked {s['masked']}"
              f": {s['ms']:.3f} ms (CUDA events), C={s['C']}, footprint "
              f"{s['mb']} MB by the JAX package's K2 test (24 MB); host "
              f"prep {s['prep']:.3f} s (of it the mask plane "
              f"{s.get('mask', 0.0):.3f} s), copies {s['copies']:.3f} s")
    print(f"  where the run's {secs_ch:.2f} s go (host clock): "
          f"{_breakdown(ch_time, secs_ch)}")
    ops_ch = _vulgar_ops(out_ch)
    if len(ops_ch) != 2 or any(o.count("I") != 2 for o in ops_ch):
        raise RuntimeError(f"chromosome-scale -E yes: want both copies with "
                           f"two introns each, got {ops_ch}")
    scans = [(s["whole"], s["masked"], s["C"]) for s in ch_scans]
    if ch_launches["K2"] != len(ch_scans) \
            or len(whole) < 3 or any(s["masked"] != bool(s["points"])
                                     for s in whole) \
            or sum(s["masked"] for s in whole) < 2 \
            or any(s["C"] < 2 for s in ch_scans) \
            or ch_launches.get("K1", 0):
        raise RuntimeError(f"chromosome-scale -E yes: want every whole-"
                           f"target scan on K2, C > 1, masked after the "
                           f"first of its strand, and the copies' boxes "
                           f"there besides, none on K1: (whole, masked, C)"
                           f" {scans}; launches {ch_launches}")
    if any(k[3] >= len(chrom) for k in ch_kis if k[0] == "path") \
            or not any(k[0] == "path" for k in ch_kis):
        raise RuntimeError(f"chromosome-scale -E yes: the copies' boxes must "
                           f"run their path DPs on K4 ({ch_kis})")

    # c. the masked forced batch: a ~6 kb window around the first copy under
    # the mask of the run's first alignment (the points the second scan saw)
    first_pts = next(s["points"] for s in whole if s["masked"])
    w_sub = SubOpt()
    w_sub.points = set(first_pts)
    wdata = AlignData(Sequence("calm", None, calm_s),
                      Sequence("chromosome", None, chrom))
    w_region = Region(0, min(t for _q, t in first_pts) - 500, len(calm_s),
                      6000)
    forced_k2("est2genome masked by the run's first alignment, 6 kb window",
              model, [(w_region, wdata)], w_sub)
    if "masked True" not in k2_checks[-1][0]:
        raise RuntimeError("K2 forced window: the mask blocks no cell")
    print(f"{k2_checks[-1][0]} [{card}]: {k2_checks[-1][1]:.3f} ms; plain "
          f"check started")
    k2_ms = whole[0]["ms"]
    k2_shape = (f"Qp {whole[0]['shape'][1]} x Tp {whole[0]['shape'][2]} "
                f"x{whole[0]['shape'][0]}, {len(calm_s)} x {len(chrom)}")

    _mark(t_start, "9d, the checkpointed traceback")
    # d. the third forward iteration's path DP at --score 2000
    # (CH_PATH_SCORE): under both copies' masks the third scan's box is a
    # chain across most of the target, its traceback cube (D x S x Qp+1,
    # tens of GB) over the card's budget and its native traceback over the
    # host's, so optimal.find_path runs it on the checkpointed traceback:
    # forward segments on K2, the walk back re-running segments on K4 on
    # a cluster and walking each on the card (walk_segment).  Driven on
    # the box, as the -E loop's recursion calls it (its region scan on K2
    # first); the first diagonals of the walk's first segment are held to
    # the plain version in a worker process.
    third = whole[2]
    t_score, t_qe, t_te, t_qs, t_ts = third["out"][:, 0].tolist()
    if not (CH_PATH_SCORE <= t_score < CH_SCORE) \
            or len(third["points"]) <= len(whole[1]["points"]):
        raise RuntimeError(f"chromosome-scale -E yes: the third forward scan"
                           f" (both copies masked) scored {t_score}, want "
                           f"{CH_PATH_SCORE} to {CH_SCORE}")
    box = Region(t_qs, t_ts, t_qe - t_qs, t_te - t_ts)
    ck_sub = SubOpt()
    for q, t in third["points"]:
        ck_sub.points.add((q, t))
        ck_sub.by_row.setdefault(t, set()).add(q)
    ck = {"fwd": [], "path": [], "walk": [], "check": None, "window": None}
    real_seg = cw.wavefront_segment
    real_walk = cw.walk_segment

    def spy_seg(ki, ring, span):
        before = (tuple(t.clone() for t in ring)
                  if ki.mode == "path" and ck["check"] is None else None)
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out, tb = real_seg(ki, ring, span)
        ev[1].record()
        ck["path" if ki.mode == "path" else "fwd"].append(ev)
        if before is not None:
            # its first CH_SPAN_DIAGS diagonals, from the same rings
            n = min(CH_SPAN_DIAGS, span[1] - span[0])
            ck["check"] = _save_span(os.path.join(tmp_dir, "ck_seg.pt"), ki,
                                     before, (span[0], span[0] + n), None,
                                     tb[:, :n])
            ck["check_span"] = (span[0], span[0] + n)
        return out, tb

    def spy_walk(planes, d0, cell, walk, cap):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        ops, res = real_walk(planes, d0, cell, walk, cap)
        ev[1].record()
        ck["walk"].append(ev)
        top = int(cell[0, 0]) + int(cell[1, 0])
        if ck["window"] is None and top - d0 >= CK_WALK_DIAGS:
            # CK_WALK_DIAGS diagonals of the first segment walked from the
            # path's cell at their top, for the check against the plain
            # walk (after the run: its launches are not the main path's)
            lo = top - CK_WALK_DIAGS + 1
            ck["window"] = (planes[:, lo - d0:top - d0 + 1].clone(), lo,
                            cell.clone(), walk, ops.clone(), d0)
        return ops, res

    ck_time = {}
    observe.reset()
    zero_counts()
    cw.wavefront_segment = spy_seg
    cw.walk_segment = spy_walk
    try:
        with _timed(cw, dict(WAVE_CLOCKS, walk_segment=lambda *a, **k:
                             "walk-back (segments)"), ck_time):
            t0 = time.perf_counter()
            ck_al = optimal.find_path(model, box, wdata, subopt=ck_sub,
                                      threshold=CH_PATH_SCORE, device=dev)
            ck_secs = time.perf_counter() - t0
    finally:
        cw.wavefront_segment = real_seg
        cw.walk_segment = real_walk
    ck_launches = read_counts("the checkpointed traceback",
                              ("K2", "K4", "K3", "walkback"))
    if observe.fallback_counts:
        raise RuntimeError(f"checkpointed traceback: fallbacks "
                           f"{dict(observe.fallback_counts)}")
    ck_seg_ms = [sum(a.elapsed_time(b) for a, b in ck[k])
                 for k in ("fwd", "path", "walk")]
    if ck_al is None or ck_al.score != t_score or (
            ck_al.region.query_start, ck_al.region.target_start,
            ck_al.region.query_length, ck_al.region.target_length) != (
            box.query_start, box.target_start, box.query_length,
            box.target_length) or ck["check"] is None \
            or ck_launches["K2"] != 1 + len(ck["fwd"]) \
            or ck_launches["walkback"] != len(ck["walk"]) \
            or len(ck["walk"]) < len(ck["path"]):
        raise RuntimeError(f"checkpointed traceback of the third scan's box "
                           f"{box}: want score {t_score} over the whole box "
                           f"(launches {ck_launches}), got "
                           f"{ck_al and (ck_al.score, ck_al.region)}")
    # the path takes no match step into a cell of the copies' paths
    # (the mask bars a match row at its destination cell)
    qi, tj, blocked_steps = box.query_start, box.target_start, 0
    for op in ck_al.ops:
        for _ in range(op.length):
            qi += op.transition.advance_query
            tj += op.transition.advance_target
            blocked_steps += (op.transition.is_match
                              and (qi, tj) in ck_sub.points)
    if (qi, tj) != (t_qe, t_te) or blocked_steps:
        raise RuntimeError(f"checkpointed traceback: the path ends at "
                           f"{(qi, tj)}, want {(t_qe, t_te)}; {blocked_steps}"
                           f" match steps into masked cells")
    ck_res = k2_pool.apply_async(_plain_span_check, (ck["check"],))
    # the segment walk-back kernel against its plain version, exactly, on
    # the window of the first segment's planes from the path's end cell:
    # the same ops, exit cell, state and status, and those ops the
    # stretch of the path the main run walked there
    if ck["window"] is None:
        raise RuntimeError("checkpointed traceback: no segment walk of "
                           f"{CK_WALK_DIAGS} diagonals to check")
    win, w_lo, w_cell, w_walk, w_ops, w_d0 = ck["window"]
    w_cap = win.shape[1] + cw.WALK_SLACK
    (g_ops, g_res), walk_win_ms = _cuda_call(
        lambda: cw.walk_segment(win, w_lo, w_cell, w_walk, w_cap))
    walk_win_ms = _cuda_ms(lambda: cw.walk_segment(
        win, w_lo, w_cell, w_walk, w_cap), 5)
    t0 = time.perf_counter()
    p_ops, p_res = wf.plain_walk_segment(win, w_lo, w_cell,
                                         w_walk, w_cap)
    walk_win_plain_ms = (time.perf_counter() - t0) * 1e3
    g_res, p_res = g_res.cpu(), p_res.cpu()
    n_w = int(p_res[0, 0])
    walk_seg_err = _max_err(g_res, p_res)
    if not torch.equal(g_res, p_res) \
            or not torch.equal(g_ops[0, :n_w].cpu(), p_ops[0, :n_w].cpu()) \
            or int(p_res[4, 0]) != wf.WALK_LEFT \
            or not torch.equal(g_ops[0, :n_w], w_ops[0, :n_w]):
        raise RuntimeError(f"segment walk-back over diagonals {w_lo}-"
                           f"{w_lo + win.shape[1] - 1} from {w_cell.tolist()}"
                           f": kernel {g_res.tolist()} != plain "
                           f"{p_res.tolist()}, or not the path's stretch")
    walk_seg_work = (n_w * (1 + 16 + 4) + 5 * 4 + 3 * 4, 6 * n_w)
    print(f"segment walk-back (walkback.cu's segment entry point) over "
          f"{win.shape[1]} diagonals {w_lo}-{w_lo + win.shape[1] - 1} of "
          f"the first walked segment's planes (from {w_d0}), from the "
          f"path's end cell {w_cell[:, 0].tolist()} [{card}]: kernel "
          f"{walk_win_ms:.4f} ms, plain {walk_win_plain_ms:.3f} ms (host "
          f"clock); {n_w} ops, exit {p_res[1:4, 0].tolist()} left the "
          f"window; == plain and == the path's stretch")
    report["walk_segment"] = (walk_seg_err, walk_win_ms, walk_win_plain_ms,
                              walk_seg_work, n_w)
    del win, ck["window"]
    print(f"checkpointed traceback, the third forward iteration at --score "
          f"{CH_PATH_SCORE}: box {box.query_length} x {box.target_length} "
          f"at ({box.query_start}, {box.target_start}), score {t_score} "
          f"[{card}]: {ck_secs:.2f} s host clock; forward {len(ck['fwd'])} "
          f"segments on K2 {ck_seg_ms[0]:.3f} ms, walk back "
          f"{len(ck['path'])} segments on K4 (cluster) {ck_seg_ms[1]:.3f} ms"
          f", {len(ck['walk'])} segment walks on the card "
          f"{ck_seg_ms[2]:.3f} ms (CUDA events); launches {ck_launches}; "
          f"{sum(op.length for op in ck_al.ops)} path steps, none a match "
          f"into a masked cell; the path's score and box equal the scan's; "
          f"plain check of the walk's first segment over diagonals "
          f"{ck['check_span']} started")
    print(f"  where its {ck_secs:.2f} s go (host clock): "
          f"{_breakdown(ck_time, ck_secs)}")

    # e. K2 at the main path's shape against the plain version: the first
    # masked whole-target scan's inputs (the first copy masked) run on K2
    # over [0, CH_SPAN_AT), then, timed, over CH_SPAN_DIAGS diagonals
    # through the first copy's cells, continuing the rings; that span is
    # held to the plain version from the same rings in a worker process
    ki_m = whole[1]["ki"]
    span = (CH_SPAN_AT, CH_SPAN_AT + CH_SPAN_DIAGS)
    ring = cw.ring_buffers(ki_m)
    real_launch(ki_m, 0, (0, span[0]), ring)
    before = tuple(t.clone() for t in ring)
    (sp_out, _, sp_c), sp_ms = _cuda_call(
        lambda: real_launch(ki_m, 0, span, ring))
    sp_res = k2_pool.apply_async(_plain_span_check, (_save_span(
        os.path.join(tmp_dir, "k2_span.pt"), ki_m, before, span, sp_out,
        None),))
    k2_work = _wave_work(ki_m, 5 * 4, span)
    k2_span_shape = (f"the first masked whole-target scan, Qp {ki_m.Qp} x Tp"
                     f" {ki_m.Tp} x1, diagonals {span[0]}-{span[1]}, C="
                     f"{sp_c}, the ring in shared memory "
                     f"{cw.ring_in_smem(ki_m)}")
    # the same span from the same rings with the ring in global memory
    # (ring_kernel's SMEM_RING flag false), and with an empty plan (its
    # own compiled header): the cluster barrier, the ring writes and the
    # halo copy alone, the per-diagonal floor of the shared-ring body
    with _global_ring(cw):
        (g_out, _, _), g_ms = _cuda_call(lambda: real_launch(
            ki_m, 0, span, tuple(t.clone() for t in before)))
    if not torch.equal(g_out, sp_out):
        raise RuntimeError(f"K2 over the span: the global ring's "
                           f"{g_out.tolist()} != the shared ring's "
                           f"{sp_out.tolist()}")
    empty = _empty_plan(ki_m)
    barrier_ms = _cuda_ms(lambda: real_launch(
        empty, 0, span, tuple(t.clone() for t in before)), 3)
    print(f"K2 region, masked, over {k2_span_shape} [{card}]: {sp_ms:.3f} ms"
          f"; with the ring in global memory {g_ms:.3f} ms, equal; an empty "
          f"plan (the floor: barrier, ring writes, halo) {barrier_ms:.3f} ms, "
          f"{barrier_ms / CH_SPAN_DIAGS * 1e3:.3f} us per diagonal (CUDA "
          f"events); plain check started")
    for s_ in whole:
        del s_["ki"]
    del ki_m, ring, before

    # -- 10. the port's CLI, end to end (the exhaustive main path) ------
    _mark(t_start, "10, the exhaustive CLI")
    golden = dict((n, argv) for n, _prog, argv in cases.CASES)[
        "exhaustive_est2genome"]
    engines.clear()
    observe.reset()
    zero_counts()
    out, secs = run_cli(golden)
    with open(os.path.join(cases.OUTDIR, "exhaustive_est2genome.txt")) as fh:
        if cases.normalize(out) != fh.read():
            raise RuntimeError("CLI: exhaustive_est2genome differs from "
                               "its golden output")
    print(f"CLI exhaustive_est2genome: byte-equal to the golden "
          f"({secs:.2f} s host clock)")
    with open(os.path.join(DATA, "all4.fa")) as fh:
        calm_fa = ">" + fh.read()[1:].split("\n>")[0] + "\n"
    path = os.path.join(tmp_dir, "calm.fa")
    with open(path, "w") as fh:
        fh.write(calm_fa)
    out, secs = run_cli(["-m", "est2genome", "-E", "yes", "-S", "no",
                         "--bestn", "1", path, path, "--showvulgar",
                         "yes", "--showalignment", "no"])
    vulgar = [ln.split() for ln in out.splitlines()
              if ln.startswith("vulgar:")]
    if not vulgar or int(vulgar[0][9]) != CALM_SELF_SCORE:
        raise RuntimeError(f"CLI calm x calm: vulgar {vulgar[:1]}")
    print(f"CLI est2genome -E calm x calm: vulgar score {vulgar[0][9]} "
          f"({secs:.2f} s host clock)")
    launches = read_counts("exhaustive est2genome CLI",
                           ("K2", "K4", "walkback"))
    print(f"exhaustive main-path launches {launches}; engines {engines}")
    if cw.engine_name(dev) not in engines:
        raise RuntimeError(f"the CLI did not use {cw.engine_name(dev)}")

    # -- 11. K6/K7 vs plain on est2genome_genomic's comparison, timed ---
    _mark(t_start, "11, K6/K7 on est2genome_genomic")
    pair_g, plan_g = max(gjobs, key=lambda j: (j[0].region.query_length + 1)
                         * (j[1].W + 1))
    q_g, w_g = pair_g.region.query_length, plan_g.W
    bi = cs.band_inputs(gmodel, [(pair_g, plan_g)], pair_g.args.dropoff, dev)
    bits_g, live_r_g = cs.band_reverse(bi)
    col_g, live_f_g, xb_g = cs.band_forward(bi, bits_g)
    # the plain passes on host cores (worker processes), read in phase 14
    g_pool, g_pending = _start_plain_check(
        name_g, bi, {"bits": bits_g, "live_r": live_r_g, "colbest": col_g,
                     "live_f": live_f_g, "xband": xb_g}, tmp_dir,
        [(False, [0]), (True, [0])])
    pools.append(g_pool)
    pending.extend(g_pending)
    k_rev = (_cuda_ms(lambda: cs.band_reverse(bi), 3)
             + _cuda_ms(lambda: cs.band_reverse(bi), 3)) / 2
    k_fwd = (_cuda_ms(lambda: cs.band_forward(bi, bits_g), 3)
             + _cuda_ms(lambda: cs.band_forward(bi, bits_g), 3)) / 2
    n_diag_g = q_g + w_g + 1
    print(f"{name_g}'s comparison Q {q_g} x W {w_g} "
          f"({n_diag_g} diagonals) [{card}]: K6 kernel {k_rev:.3f} ms, "
          f"K7 kernel {k_fwd:.3f} ms; plain checks started")
    genomic_work = (_band_work(bi, False), _band_work(bi, True))
    print(f"K6/K7 at the scans' batches [{card}]: est2genome {s_rev:.3f} / "
          f"{s_fwd:.3f} ms; coding2genome {c_rev:.3f} / {c_fwd:.3f} ms; "
          f"protein2genome {pk_rev:.3f} / {pk_fwd:.3f} ms (summed over "
          f"{len(p_shapes)} launches)")

    # -- 12. K8, the cross-chip band scan, on synthetic cases -----------
    # every CROSS launch of the synthetic cases held to its plain version
    # on the same chunk and halo, on the card; each chain to the single
    # launch (the span-cut case among them)
    _mark(t_start, "12, K8 on synthetic cases")
    import torch_sdp_cases as tcases
    k8_err = 0
    k8_cases = []
    for cname, n in K8_CASES:
        cmodel, cpair, cplan = tcases.case(cname)
        chunks_c = cs.cross_chunks(cmodel, cpair, cplan, cpair.args.dropoff,
                                   n, [dev])
        kern = _k8_chain(cs, sd, chunks_c)
        plain = _k8_chain(cs, sd, chunks_c, True)
        for (lab, _h, kres), (_l, _h2, pres) in zip(kern, plain):
            for a, b in zip(_halo_tensors(kres), _halo_tensors(pres)):
                k8_err = max(k8_err, _max_err(a, b))
                if not torch.equal(a, b):
                    raise RuntimeError(f"K8 {cname} ({n} chunks) launch "
                                       f"{lab}: kernel != plain")
        got_c = cs.run_kernel_cross_chip(cmodel, cpair, cplan,
                                         cpair.args.dropoff, n, [dev])
        want_c = cs.run_kernel(cmodel, [(cpair, cplan)], cpair.args.dropoff,
                               dev)[0]
        if not np.array_equal(got_c["band_end"], want_c["band_end"]) \
                or (got_c["live"], got_c["xband"]) != (want_c["live"],
                                                       want_c["xband"]):
            raise RuntimeError(f"K8 {cname}: != the single launch")
        k8_cases.append((cname, n, len(kern)))
    print(f"K8 vs plain (case, chunks, launches) {k8_cases} [{card}]: every "
          f"CROSS launch == its plain version (bits, live, column best, "
          f"xband, edge planes, span registers), each chain == the single "
          f"launch")

    # -- 13. genome2genome -E yes on the generic wavefront --------------
    _mark(t_start, "13, genome2genome -E yes on the generic wavefront")
    steps = [0]
    real_step = gw.Engine.step

    def count_step(self, *args, **kwargs):
        steps[0] += 1
        return real_step(self, *args, **kwargs)

    observe.reset()
    zero_counts()
    saved = optimal.NATIVE_TB_BUDGET, optimal.DP_MEMORY_LIMIT
    optimal.NATIVE_TB_BUDGET = G2G_BUDGET
    gw.Engine.step = count_step
    try:
        out_g2g, secs_g2g = run_cli(G2G_ARGV + g2g_files)
    finally:
        gw.Engine.step = real_step
        optimal.NATIVE_TB_BUDGET, optimal.DP_MEMORY_LIMIT = saved
    g2g_eng = dict(observe.engine_counts)
    if set(g2g_eng) != {gw.engine_name(dev)}:
        raise RuntimeError(f"genome2genome -E yes: engines {g2g_eng}, want "
                           f"only {gw.engine_name(dev)}")
    if "1455 M 300 300" not in out_g2g:
        raise RuntimeError("genome2genome -E yes: the 1455 alignment is "
                           "missing")
    print(f"genome2genome -E yes (cdna_mut 300 bp x genome {G2G_CUT[1]}-"
          f"{G2G_CUT[2]}, native budget and --dpmemory 1 MB) on the generic "
          f"wavefront [{card}]: {secs_g2g:.2f} s host clock, engines "
          f"{g2g_eng}, {steps[0]} diagonal steps "
          f"({secs_g2g / max(steps[0], 1) * 1e3:.3f} ms each); its bytes are "
          f"compared with the CPU run's in phase 14")

    # -- 14. the plain checks and native routes (started in phases 3-13)
    _mark(t_start, "14, the plain checks and native routes")
    wait_t0 = time.perf_counter()
    for pname, idx, res in pending:
        left = DEADLINE_S - (time.perf_counter() - t_start)
        equal, err, secs, n_diag = res.get(timeout=max(left, 1.0))
        print(f"plain check {pname} over comparisons {idx} (B={len(idx)}, "
              f"{n_diag} diagonals): {secs:.1f} s on one host core "
              f"({secs / n_diag * 1e3:.3f} ms per diagonal); max "
              f"|kernel - plain| {err}")
        if not equal:
            raise RuntimeError(f"{pname}: kernel != plain on comparisons "
                               f"{idx} (max err {err})")
        band_err = max(band_err, err)
    print(f"plain checks: kernel == plain on all {len(sjobs)} comparisons "
          f"of the est2genome scan, comparisons {c_check} of the "
          f"coding2genome scan and {p_check} of the protein2genome scan "
          f"(bits, live; column best, live, xband) and on the protein2genome"
          f" -E run's other K1/K4 launches, K1 at calm x64, the "
          f"est2genome_genomic comparison, the est2genome -E run's widest "
          f"masked scan and first masked path DP (on the cluster), the "
          f"locus pool's sampled pairs"
          f" and K2's forced batches (scores, ends, starts; cube, "
          f"walk-back), {time.perf_counter() - check_t0:.1f} s after they "
          f"started, {time.perf_counter() - wait_t0:.1f} s of it waited for; "
          f"the last read at {time.perf_counter() - t_start:.1f} s into the "
          f"script (deadline {DEADLINE_S} s)")
    # phase 7's model zoo on the plain versions (worker process)
    zoo_want, zoo_secs = zoo_plain.get(timeout=max(
        DEADLINE_S - (time.perf_counter() - t_start), 1.0))
    bad = [n for n in zoo_card if zoo_card[n] != zoo_want.get(n)]
    if bad or set(zoo_want) != set(zoo_card):
        raise RuntimeError(f"K1/K4 + walk-back != plain on the zoo models "
                           f"{bad}")
    print(f"K1/K4 model zoo (phase 7): kernel == plain on every model "
          f"(score, region, path; {zoo_secs:.1f} s on one host core)")
    # phase 3's run_kernel on the CPU (worker process)
    for label, got, res in syn_checks:
        want = res.get(timeout=max(
            DEADLINE_S - (time.perf_counter() - t_start), 1.0))
        for g, w in zip(got, want):
            if (g["live"], g["xband"]) != (w["live"], w["xband"]) \
                    or not np.array_equal(g["band_end"], w["band_end"]) \
                    or ("start_scores" in g) != ("start_scores" in w) \
                    or not np.array_equal(g.get("start_scores", 0),
                                          w.get("start_scores", 0)):
                raise RuntimeError(f"K6/K7 {label}: run_kernel on the card "
                                   f"!= on the CPU")
    print(f"K6/K7 on the synthetic pairs (phase 3): kernel == plain (bits, "
          f"or a non-boundary model's start scores; column best, live, "
          f"xband) and run_kernel on the card == on the CPU (band_end per "
          f"locus, start scores, live, xband) on all {len(syn_checks)} "
          f"batches")
    if split_band is not None:
        print(f"K7 on the split-codon synthetic batch {split_band[0]} (Qp "
              f"{split_band[1]}, Wp {split_band[2]}) [{card}]: kernel "
              f"{split_band[3]:.3f} ms, plain "
              f"{split_band[4].get()[2] * 1e3:.3f} ms on one host core")
    # the scans' native routes (phases 4-5, a worker process)
    for label, mode, out_dev, res in scan_natives:
        out_nat, secs_nat, eng_nat, falls_nat = res.get(timeout=max(
            DEADLINE_S - (time.perf_counter() - t_start), 1.0))
        if falls_nat or any(not e.startswith("native") for e in eng_nat):
            raise RuntimeError(f"{label} native route: engines {eng_nat}, "
                               f"fallbacks {falls_nat}")
        if out_dev != out_nat:
            raise RuntimeError(f"{label}: the {mode} output differs from "
                               f"the native route's")
        print(f"{label}: the {mode} output == EXONERATE_TPU_SDP=native's "
              f"({secs_nat:.2f} s host clock in a worker process; engines "
              f"{eng_nat})")
    # phase 5f's references: the native route and the same run on the CPU
    left = DEADLINE_S - (time.perf_counter() - t_start)
    out_nat, secs_nat, eng_nat, falls_nat = rows_nat.get(
        timeout=max(left, 1.0))
    left = DEADLINE_S - (time.perf_counter() - t_start)
    out_rc, secs_rc, eng_rc, falls_rc, buckets_rc = rows_ref.get(
        timeout=max(left, 1.0))
    if rows_out != out_rc:
        raise RuntimeError("row-scan tier: the card's output differs from "
                           "the CPU run's")
    # the JAX package's row tier reports a worse alignment for p1 on this
    # input than the native route (ROADMAP Queue 3): the tier may lose an
    # alignment, never report a better one than the host's
    rows_best, nat_best = _best_scores(rows_out), _best_scores(out_nat)
    worse = {q: (rows_best.get(q), s_) for q, s_ in nat_best.items()
             if rows_best.get(q) != s_}
    if set(rows_best) - set(nat_best) or any(
            r is not None and r > s_ for r, s_ in worse.values()):
        raise RuntimeError(f"row-scan tier: scores over the native route's: "
                           f"{worse}")
    if rows_falls != falls_rc or rows_eng != eng_rc:
        raise RuntimeError(f"row-scan tier: engines {rows_eng} / fallbacks "
                           f"{rows_falls} on the card, {eng_rc} / "
                           f"{falls_rc} on the CPU")
    bad = [k for k in buckets_rc[0]
           if not np.array_equal(rows_first.get(k), buckets_rc[0][k])]
    if bad or set(rows_first) != set(buckets_rc[0]):
        raise RuntimeError(f"row-scan tier: the first bucket's fields {bad} "
                           f"differ between the card and the CPU")
    print(f"row-scan tier (phase 5f): output == the CPU run's "
          f"({secs_rc:.2f} s, one core); against EXONERATE_TPU_SDP=native's "
          f"({secs_nat:.2f} s host clock in a worker process): "
          f"{'equal' if rows_out == out_nat else 'differs'}, queries whose "
          f"best score differs (rows, native) {worse}; engines and "
          f"fallbacks as on the CPU; the first bucket's {len(rows_first)} "
          f"fields equal the CPU's")
    # phase 13's reference: the genome2genome -E run on the CPU
    left = DEADLINE_S - (time.perf_counter() - t_start)
    cpu_g2g, cpu_g2g_s, cpu_g2g_eng, cpu_g2g_falls = g2g_res.get(
        timeout=max(left, 1.0))
    if out_g2g != cpu_g2g or cpu_g2g_falls \
            or set(cpu_g2g_eng) != {"torch-generic"}:
        raise RuntimeError(f"genome2genome -E yes: the card's output differs"
                           f" from the CPU run's (engines {cpu_g2g_eng}, "
                           f"fallbacks {cpu_g2g_falls})")
    print(f"genome2genome -E yes (phase 13): byte-equal to the CPU run "
          f"(engines {cpu_g2g_eng}; {cpu_g2g_s:.2f} s host clock in a worker "
          f"process, against the card's {secs_g2g:.2f} s)")
    # the native routes of phases 6a and 9 (worker processes)
    left = DEADLINE_S - (time.perf_counter() - t_start)
    nat_we, nat_secs_we, nat_eng, nat_falls = nat_we_res.get(
        timeout=max(left, 1.0))
    if nat_falls or any("wavefront" in e for e in nat_eng):
        raise RuntimeError(f"est2genome -E yes native route: engines "
                           f"{nat_eng}, fallbacks {nat_falls}")
    if out_we != nat_we:
        raise RuntimeError("est2genome -E yes: the kernels' output differs "
                           "from the native route's")
    print(f"est2genome -E yes Waterman-Eggert (phase 6a): byte-equal to the "
          f"native route (engines {nat_eng}; {nat_secs_we:.2f} s host clock "
          f"in a worker process, against the kernels' {secs_we:.2f} s)")
    ch_lines = [ln.split() for ln in out_ch.splitlines()
                if ln.startswith("vulgar:")]
    for k, (w0, res) in enumerate(ch_windows):
        out_w, secs_w, eng_w, falls_w = res.get(
            timeout=max(DEADLINE_S - (time.perf_counter() - t_start), 1.0))
        if falls_w or any("wavefront" in e for e in eng_w):
            raise RuntimeError(f"window {k} native route: engines {eng_w}, "
                               f"fallbacks {falls_w}")
        lines = [ln.split() for ln in out_w.splitlines()
                 if ln.startswith("vulgar:")]
        if len(lines) != 1:
            raise RuntimeError(f"window {k} at {w0}: want one vulgar line, "
                               f"got {lines}")
        v = list(lines[0])
        v[6], v[7] = str(int(v[6]) + w0), str(int(v[7]) + w0)
        if v not in ch_lines:
            raise RuntimeError(f"chromosome-scale -E yes: no line equals the "
                               f"native route's on the window at {w0}: {v} "
                               f"not in {ch_lines}")
        print(f"chromosome-scale -E yes copy {k}: its vulgar line equals the "
              f"native route's on the {CH_WIN} bp window at {w0}, shifted "
              f"({secs_w:.2f} s host clock in a worker process; engines "
              f"{eng_w})")
    # K1 at the full shape, on its side stream since phase 9b
    wait_k1 = time.perf_counter()
    side.synchronize()
    k1_full_ms = k1_full["ev"][0].elapsed_time(k1_full["ev"][1])
    k1_err = _max_err(k1_full["out"], whole[0]["out"])
    if k1_err or not torch.equal(k1_full["out"], whole[0]["out"]):
        raise RuntimeError(f"K2 != K1 at the full shape ({k2_shape}): "
                           f"{whole[0]['out'].tolist()} vs "
                           f"{k1_full['out'].tolist()}")
    print(f"K2 == K1 at the full shape ({k2_shape}; score, ends, starts) "
          f"[{card}]: K2 {k2_ms:.3f} ms (C={whole[0]['C']}), K1 "
          f"{k1_full_ms:.3f} ms (one CTA, on a side stream beside the rest "
          f"of the phase; {time.perf_counter() - wait_k1:.1f} s waited for)")
    del k1_full
    for pool in pools:
        pool.close()
    k2_res = [res.get() for _n, _ms, res in k2_checks]
    k2_err = max(max(err for _ok, err, _s, _d in k2_res), k1_err)
    # the span launches of phase 9d-e against the plain version
    span_err, span_s = {}, {}
    for key, label, res in (
            ("K2", "K2 region, masked, over " + k2_span_shape, sp_res),
            ("K4", f"K4 on a cluster, the checkpointed traceback's first "
                   f"segment walked, diagonals {ck['check_span']}", ck_res)):
        ok, span_err[key], span_s[key], n_diag = res.get(
            timeout=max(DEADLINE_S - (time.perf_counter() - t_start), 1.0))
        print(f"plain check {label}: {span_s[key]:.1f} s on one host core "
              f"({n_diag} diagonals); max |kernel - plain| {span_err[key]}")
        if not ok:
            raise RuntimeError(f"{label}: kernel != plain (max err "
                               f"{span_err[key]})")
    k2_err = max(k2_err, *span_err.values())
    _, k4_err, k4_plain_s, _ = k4_res.get()
    report["K4"] = (max(k4_err, span_err["K4"]), path_ms, k4_plain_s * 1e3,
                    k4_work)
    # K6/K7's and K1's plain times: the plain versions on one host core
    # (worker processes, checked above with the rest)
    p_rev, p_fwd = (res.get()[2] * 1e3 for _n, _ix, res in g_pending)
    report["K6"] = (band_err, k_rev, p_rev, genomic_work[0])
    report["K7"] = (band_err, k_fwd, p_fwd, genomic_work[1])
    # the TRACK_SID instantiation's: the affine:local scan's widest
    # comparison, its plain passes on one host core (worker processes)
    (_, e6, s6, _), (_, e7, s7, _) = (res.get() for _n, _ix, res
                                      in nb_pending)
    report["K6 sid"] = (e6, nb_k6_ms, s6 * 1e3, nb_work_w[0])
    report["K7 sid"] = (e7, nb_k7_ms, s7 * 1e3, nb_work_w[1])
    _, k1r_err, k1r_s, _ = k1_res["region"].get()
    report["K1_region"] = (k1r_err,) + report["K1_region"][1:2] + (
        k1r_s * 1e3,) + report["K1_region"][3:]
    # K9's and K3's plain times: the plain version on one host core (worker
    # processes)
    _, k9_err, k9_plain_s, _ = e_pending.get()
    report["K9"] = (k9_err, e_ms, k9_plain_s * 1e3, k9_work)
    _, k3_err, k3_plain_s, _ = we_pending["K3"].get()
    report["K3"] = (k3_err, k3_ms, k3_plain_s * 1e3, k3_work)
    # K2's plain time: the ragged forced batch on one host core
    report["K2"] = (k2_err, sp_ms, span_s["K2"] * 1e3, k2_work)
    # K5's and K8's at the main path's shapes: the plain versions of the
    # launches checked (worker processes, one host core each), summed
    k5_res = [r.get() for r in k5_pending]
    report["K5"] = (max(r[1] for r in k5_res), k5_ms,
                    sum(r[2] for r in k5_res) * 1e3, k5_work)
    k8_res = [r.get() for r in k8_pending]
    report["K8"] = (max(k8_err, *(r[1] for r in k8_res)), k8_chain_ms,
                    sum(r[2] for r in k8_res) * 1e3, k8_work)

    # -- 15. T1, the elementwise-throughput probe ------------------------
    # off every CLI path: held to the plain version on the card at the full
    # B x W, then timed through the tool's own entry (tools/vpu16.py's
    # cases and best-of-5 timing), each rate against its dtype's peak
    _mark(t_start, "15, T1 (the elementwise-throughput probe)")
    from exonerate_tpu_torch.tools import vpu16 as t1

    def t1_err_of(a, b):
        return float((a.double() - b.double()).abs().max())

    t1_err = 0.0
    for dtype, mix in t1.CASES:
        x = t1.inputs(dtype, 0, dev)
        got = t1.vpu16(x, mix, T1_CHECK_STEPS)
        want = t1.plain(x, mix, T1_CHECK_STEPS)
        t1_err = max(t1_err, t1_err_of(got, want))
        if not torch.equal(got, want):
            raise RuntimeError(f"T1 {t1.case_name(dtype, mix)} at "
                               f"{T1_CHECK_STEPS} steps: kernel != plain")
    x32 = t1.inputs(torch.int32, 0, dev)
    got, t1_kernel_full = _cuda_call(lambda: t1.vpu16(x32, "mix"))
    want, t1_plain_ms = _cuda_call(lambda: t1.plain(x32, "mix"))
    t1_err = max(t1_err, t1_err_of(got, want))
    if not torch.equal(got, want):
        raise RuntimeError("T1 int32 mix at the full steps: kernel != plain")
    print(f"T1 [{card}]: the nine cases == the plain version at B {t1.B} x "
          f"W {t1.W}, {T1_CHECK_STEPS} steps of {t1.ITERS} rounds; int32 mix"
          f" at {t1.STEPS} steps too: kernel {t1_kernel_full:.3f} ms, plain "
          f"{t1_plain_ms:.3f} ms on the card (CUDA events)")
    del x, x32, got, want
    t1.vpu16.launches = 0
    t1_rows = t1.run()
    t1_launches = t1.vpu16.launches
    if t1_launches != len(t1.CASES) * (1 + t1.REPS):
        raise RuntimeError(f"T1: {t1_launches} launches, want "
                           f"{len(t1.CASES) * (1 + t1.REPS)}")
    over = [r["name"] for r in t1_rows if r["rate"] > r["peak"]]
    if over:
        raise RuntimeError(f"T1: {over} over the card's peak for the dtype:"
                           f" the compiler removed work")
    # the build must issue an instruction per counted op and element slot
    # at least (instructions x the lanes each computes): fewer means the
    # compiler folded or merged rounds, as a rate over the peak
    sass = t1.sass()
    for dtype, mix in t1.CASES:
        n_slots = t1.issued(sass, dtype, mix)
        want = t1.counted(dtype, mix)
        print(f"  SASS {t1.case_name(dtype, mix)}: {n_slots} element slots "
              f"({t1.LANES[dtype]} a instruction) for {want} counted ops "
              f"of {t1.UNROLL} rounds of {t1.LANES[dtype]} elements; peak "
              f"{t1.PEAK_PER_SM_CLOCK[dtype]} a clock per SM")
        if n_slots < want:
            raise RuntimeError(f"T1 {t1.case_name(dtype, mix)}: the build "
                               f"issues {n_slots} element slots for {want} "
                               f"ops")
    for fn_name, ops in sass.items():
        print(f"  SASS {fn_name}: " + ", ".join(
            f"{k} {v}" for k, v in ops.most_common()))
    t1_main = next(r for r in t1_rows
                   if (r["dtype"], r["mix"]) == (torch.int32, "mix"))
    report["T1"] = (t1_err, t1_main["ms"], t1_plain_ms,
                    (2 * t1.B * t1.W * 4, t1_main["ops"]))
    t1_ms = {(r["dtype"], r["mix"]): r["ms"] for r in t1_rows}
    del t1_rows

    src = "exonerate_tpu_torch/csrc/"
    pw = "exonerate_tpu/engine/pallas_wavefront.py"
    sp = "exonerate_tpu/engine/sdp_pallas.py"
    kernels = [
        ("K1 wavefront_scan (region, calm 2175^2 x64; plain ms on one host "
         "core)", "K1", "K1_region",
         src + "wavefront.cu", pw + ":427"),
        ("K4 wavefront_path (calm 2175^2 x1; plain ms on one host core)",
         "K4", "K4",
         src + "wavefront.cu", pw + ":1147"),
        ("walkback: one warp a walk over tiles of the cube in shared "
         "memory (calm 2175^2 x1; plain ms on the card; bound: the larger "
         "of the bytes and the chain floor, a shared-memory load-to-use "
         "latency per step)", "walkback", "walkback",
         src + "walkback.cu", pw + ":1550"),
        (f"K6 band_reverse ({name_g}, Q {q_g} x W {w_g}; plain ms on one "
         f"host core)", "K6", "K6",
         src + "sdp_band.cu", sp + ":974"),
        (f"K7 band_forward ({name_g}, Q {q_g} x W {w_g}; plain ms on one "
         f"host core)", "K7", "K7",
         src + "sdp_band.cu", sp + ":996"),
        (f"K9 split codon: C_SPLIT inside K1 (region, the protein2genome "
         f"-E yes run's scan, {e_shape}; plain ms on one host core)", "K9",
         "K9",
         src + "wavefront.cu", "exonerate_tpu/model/phase.py:305"),
        (f"K3 SubOpt mask: the MASKED instantiation of the cluster kernel "
         f"(K2, region, the ring in shared memory; the est2genome -E yes "
         f"run's widest masked scan, {k3_shape}; plain ms on one host core;"
         f" on K1, its route until now, {k3_k1_ms:.3f} ms)", "K3", "K3",
         src + "wavefront.cu", pw + ":1129"),
        (f"K2 wavefront_stream_scan: the cluster kernel, K1's cells on a "
         f"thread-block cluster (region, masked, {k2_span_shape}, continuing the rings of "
         f"diagonals 0-{CH_SPAN_AT}; plain ms on one host core; max err "
         f"also over the forced batches, K1 at the whole scan's shape and "
         f"the checkpointed traceback's end segment; a whole-target scan: "
         f"{k2_ms:.3f} ms; the span with the ring in global memory "
         f"{g_ms:.3f} ms; with an empty plan, the cluster barrier's floor, "
         f"{barrier_ms:.3f} ms)", "K2", "K2", src + "wavefront.cu",
         pw + ":438"),
        (f"K5 find_batched_sharded: K1 per device shard (region, "
         f"{k5_shape}; plain ms on one host core; the whole generation "
         f"{ms5:.3f} ms with host prep)",
         "K5", "K5", src + "wavefront.cu", pw + ":1470"),
        (f"K6 band_reverse, non-boundary: the TRACK_SID instantiation (a "
         f"seed id per state; the affine:local scan's widest comparison, "
         f"{nb_shape}; plain ms on one host core; at the scan's band batch"
         f" {nb_rows['affine:local'][0]:.3f} ms over "
         f"{len(nb_rows['affine:local'][4])} launches, the protein2dna "
         f"scan's {nb_rows['protein2dna'][0]:.3f} ms)", "K6 sid", "K6 sid",
         src + "sdp_band.cu", sp + ":974"),
        (f"K7 band_forward, non-boundary: the TRACK_SID instantiation "
         f"(the START state from the seeds' start scores; {nb_shape}; "
         f"plain ms on one host core; at the scan's band batch "
         f"{nb_rows['affine:local'][1]:.3f} ms, the protein2dna scan's "
         f"{nb_rows['protein2dna'][1]:.3f} ms)", "K7 sid", "K7 sid",
         src + "sdp_band.cu", sp + ":996"),
        (f"K8 band_reverse_cross / band_forward_cross: the CROSS "
         f"instantiation of K6/K7 (the chain of {k8_shape}, reverse then "
         f"forward; plain ms on one host core per launch, summed; with "
         f"host prep: " + ", ".join(
             f"{n} chunks {k8_ms[n]:.3f} ms" for n in K8_SPLITS) + ")",
         "K8", "K8", src + "sdp_band.cu", sp + ":904"),
    ]
    rows = []
    for kname, lkey, rkey, source, replaces in kernels:
        err, ms, plain_ms, (n_bytes, n_ops) = report[rkey][:4]
        bound_ms, bound_by = _bound(n_bytes, n_ops)
        launches = main_launches[lkey]
        if lkey in ("K6", "K7"):
            # the boundary instantiation's: the TRACK_SID launches apart
            launches -= main_launches[lkey + " sid"]
        rows.append({"name": kname, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": None})
        if rkey == "walkback":
            # a chain of dependent steps: its floor beside the bytes
            floor = _chain_floor_ms(report[rkey][4], smem_clocks)
            rows[-1].update(bytes_bound_ms=bound_ms, chain_floor_ms=floor,
                            smem_load_clocks=smem_clocks)
            if floor > bound_ms:
                rows[-1].update(bound_ms=floor, bound_by="operations")
    # the segment entry point of the same source (the checkpointed
    # traceback's walk, phase 9d): its launches are 9d's segment walks
    err, ms, plain_ms, (n_bytes, n_ops), n_w = report["walk_segment"]
    bytes_ms = _bound(n_bytes, n_ops)[0]
    floor = _chain_floor_ms(n_w, smem_clocks)
    rows.append({"name": f"walk_segment: the walk-back's segment entry "
                         f"point, in place of the JAX package's host walk "
                         f"(exonerate_tpu/engine/wavefront.py:762; the "
                         f"checkpointed traceback, phase 9d; "
                         f"timed over a window of {CK_WALK_DIAGS} diagonals"
                         f" of a walked segment's planes, {n_w} steps; plain"
                         f" ms on the host; the 9d run's {len(ck['walk'])} "
                         f"segment walks took {ck_seg_ms[2]:.3f} ms; bound: "
                         f"as the walk-back's)",
                 "route": "cuda", "source": src + "walkback.cu",
                 "replaces": pw + ":1550",
                 "launches": len(ck["walk"]), "max_abs_err": err, "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": max(bytes_ms, floor),
                 "bound_by": "operations" if floor > bytes_ms else "bytes",
                 "library_ms": None, "bytes_bound_ms": bytes_ms,
                 "chain_floor_ms": floor})
    err, ms, plain_ms, (n_bytes, n_ops) = report["T1"]
    bound_ms, bound_by = _bound(n_bytes, n_ops)
    rows.append({"name": f"T1 vpu16: the elementwise-throughput probe "
                         f"(int32 mix, B {t1.B} x W {t1.W}, {t1.STEPS} steps "
                         f"of {t1.ITERS} rounds, best of {t1.REPS}; plain ms: "
                         f"the same loop of torch ops on the card; on no "
                         f"CLI path: its own entry launched it "
                         f"{t1_launches} times)",
                 "route": "cuda", "source": src + "vpu16.cu",
                 "replaces": "tools/vpu16.py:60", "launches": 0,
                 "tool_launches": t1_launches, "max_abs_err": err, "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": bound_by, "library_ms": None})
    for label, (rev, fwd), k6, k7 in (("est2genome scan", scan_work, s_rev,
                                       s_fwd),
                                      ("coding2genome scan", c2g_work, c_rev,
                                       c_fwd),
                                      ("protein2genome scan", p2g_work,
                                       pk_rev, pk_fwd)) + tuple(
            (f"{m} scan (TRACK_SID)", r[2], r[0], r[1])
            for m, r in nb_rows.items()):
        print(f"bound at the {label}'s batch: K6 {_bound(*rev)[0]:.3f} ms "
              f"({_bound(*rev)[1]}; kernel {k6:.3f} ms), K7 "
              f"{_bound(*fwd)[0]:.3f} ms ({_bound(*fwd)[1]}; kernel "
              f"{k7:.3f} ms)")
    # the rows whose kernels run the compiled plan, beside their times
    # with the plan interpreted, and the walk-back's and T1's beside their
    # times before their redesign (PERF.md section 6, in brackets: other
    # runs on an NVIDIA H100 80GB HBM3 at 700 W)
    for row, now, interp_ms in (
            ("K1 region calm 2175^2 x64", report["K1_region"][1], 573.624),
            ("K1 score calm 2175^2 x64", report["K1_score"][1], None),
            ("K4 path calm 2175^2 x1", path_ms, 379.171),
            ("K5 the widest shard", k5_ms, 808.831),
            ("K9 inside K1, the p2g -E run's scan", e_ms, 459.396),
            ("K6 / K7 est2genome scan B=16", (s_rev, s_fwd),
             (1161.611, 2336.955)),
            ("K6 / K7 coding2genome scan", (c_rev, c_fwd),
             (1126.465, 3348.963)),
            ("K6 / K7 protein2genome scan, forced", (pk_rev, pk_fwd),
             (689.791, 1831.065)),
            ("K8 the 2-chunk chain, 4 launches", k8_chain_ms, 3559.789),
            ("walk-back calm 2175^2 x1 (before: one thread a pair)",
             walk_ms, 0.501),
            ("T1 bfloat16 add / mix, int8 add, packed (before: one element "
             "a thread)", tuple(t1_ms[k] for k in (
                 (torch.bfloat16, "add"), (torch.bfloat16, "mix"),
                 (torch.int8, "add"))), (0.826, 6.649, 1.287))):
        fmt = (" / ".join(f"{x:.3f}" for x in now)
               if isinstance(now, tuple) else f"{now:.3f}")
        old = ("not recorded" if interp_ms is None else
               (" / ".join(map(str, interp_ms)) if isinstance(interp_ms, tuple)
                else str(interp_ms)) + " ms")
        print(f"redesigned row {row} [{card}]: {fmt} ms (before: {old})")
    print(f"main-path launches {main_launches}; script "
          f"{time.perf_counter() - t_start:.1f} s")
    print(_card_line())
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    with _EXIT:
        sys.exit(main())
