#!/usr/bin/env python3
"""Whether the `--cores` worker threads' kernels run side by side on one
card, and what timing them costs.

    python3 tools/torch_cores_overlap.py

On chip_smoke's 16 x 1 Mb est2genome scan (16 mutated calm cDNAs against
a 1 Mb genome holding 8 spliced copies, ``tests/torch_split_cases.py``
``scan_genome``; the argv of chip_smoke's phase 4):

1. the CLI's default (pooled) route, timed on the host clock, capturing
   the band batch it sends to the card;
2. ``cuda_sdp.run_kernel`` on the two widest comparisons of that batch,
   each alone, then both at once from two threads, each thread on a CUDA
   stream of its own (host clock);
3. the CLI with ``--cores 2`` three times: as it is; with each band
   launch timed on the host clock from its enqueue to its stream's end
   (chip_smoke phase 4c's method); with CUDA timing events recorded
   around each launch.  For the last two it prints the launches' summed
   time and the time with one or more running, so the seconds side by
   side.

Prints one line per measurement, then the card's name and power limit.
Needs one CUDA card.
"""
from __future__ import annotations

import io
import os
import subprocess
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
ARGV = ["-m", "est2genome", "--bestn", "1", "--maxintron", "20000",
        "--showvulgar", "yes", "--showalignment", "no"]


def _covered(ivals: list) -> tuple:
    """(summed length, length of the union) of [(start, end)]."""
    busy, covered, reach = 0.0, 0.0, float("-inf")
    for a, e in sorted(ivals):
        busy += e - a
        covered += max(0.0, e - max(a, reach))
        reach = max(reach, e)
    return busy, covered


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_cores_overlap: no CUDA card")
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_split_cases as sc
    from exonerate_tpu_torch.cli.exonerate import main as cli
    from exonerate_tpu_torch.engine import cuda_sdp as cs
    from exonerate_tpu_torch.engine import sdp_hybrid as hy
    dev = torch.device("cuda", 0)
    tmp = tempfile.mkdtemp()
    queries, genome = sc.scan_genome((400, 800))
    qf = sc.write_fasta(os.path.join(tmp, "q.fa"),
                        [(f"q{k}", q) for k, q in enumerate(queries)])
    tf = sc.write_fasta(os.path.join(tmp, "t.fa"), [("genome", genome)])

    def run(argv) -> tuple:
        buf = io.StringIO()
        t0 = time.perf_counter()
        if cli(argv, out=buf) != 0:
            raise RuntimeError(f"CLI exit status for {argv}")
        torch.cuda.current_stream().synchronize()
        return buf.getvalue(), time.perf_counter() - t0

    # 1. the pooled route, its band batch captured
    captured = []
    real_batch = hy.run_device_batch

    def spy(model, jobs, device):
        captured.append((model, list(jobs)))
        return real_batch(model, jobs, device)

    hy.run_device_batch = spy
    try:
        pooled, secs = run(ARGV + [qf, tf])
    finally:
        hy.run_device_batch = real_batch
    print(f"pooled route: {secs:.2f} s host clock")
    model, jobs = captured[0]
    widest = sorted(jobs, key=lambda j: -j[1].W)[:2]
    drop = widest[0][0].args.dropoff

    # 2. two comparisons' band scans, alone and from two threads
    cs.run_kernel(model, [widest[0]], drop, dev)          # warm-up
    alone = []
    for job in widest:
        t0 = time.perf_counter()
        cs.run_kernel(model, [job], drop, dev)
        alone.append(time.perf_counter() - t0)
    start = threading.Barrier(2)

    def worker(job):
        torch.cuda.set_stream(torch.cuda.Stream(device=dev))
        start.wait()
        cs.run_kernel(model, [job], drop, dev)

    threads = [threading.Thread(target=worker, args=(j,)) for j in widest]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    both = time.perf_counter() - t0
    print(f"run_kernel on the two widest comparisons (W {widest[0][1].W}, "
          f"{widest[1][1].W}): alone {alone[0]:.2f} s and {alone[1]:.2f} s;"
          f" both from two threads on their own streams {both:.2f} s (host "
          f"clock)")

    # 3. --cores 2: untimed, host clock per launch, CUDA events per launch
    argv2 = ARGV + ["--cores", "2", qf, tf]
    out, secs = run(argv2)
    if out.replace(" --cores 2", "", 1) != pooled:
        raise RuntimeError("--cores 2 differs from the pooled route")
    print(f"--cores 2, untimed: {secs:.2f} s host clock")
    real_launch = cs._launch
    for how in ("host clock", "CUDA events"):
        spans = []

        def timed(*args, **kwargs):
            if how == "host clock":
                t0 = time.perf_counter()
                res = real_launch(*args, **kwargs)
                torch.cuda.current_stream().synchronize()
                spans.append((t0, time.perf_counter()))
                return res
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            res = real_launch(*args, **kwargs)
            ev[1].record()
            spans.append(ev)
            return res

        origin = torch.cuda.Event(enable_timing=True)
        origin.record()
        cs._launch = timed
        try:
            _, secs = run(argv2)
        finally:
            cs._launch = real_launch
        if how == "CUDA events":
            for _a, e in spans:
                e.synchronize()
            spans = [(origin.elapsed_time(a) / 1e3,
                      origin.elapsed_time(e) / 1e3) for a, e in spans]
        busy, covered = _covered(spans)
        print(f"--cores 2, each of its {len(spans)} band launches timed by "
              f"{how}: {secs:.2f} s host clock; the launches {busy:.2f} s "
              f"summed over {covered:.2f} s with one or more running, so "
              f"{busy - covered:.2f} s side by side")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
