#!/usr/bin/env python3
"""Times the row-scan tier, ``--multihost`` and the dry run on one card.

    python3 tools/torch_rows_time.py [--proteins N] [--cdnas N]

With the host to itself (``chip_smoke.py`` runs the same phases, 5f-5h,
beside ~30 worker processes):

- the protein2genome scan's first N proteins (default 2) against its
  1 Mb split-codon genome, both strands, through the port's CLI on the
  native route, on the forced band kernels (``EXONERATE_TPU_SDP=device``)
  and twice on the forced row-scan tier (``EXONERATE_TPU_SDP_ROWS=1``):
  host seconds, engines, fallbacks, whether the bytes equal the native
  route's, and per row pass (bucket) its B, rows a pass, reverse and
  forward sweeps (summed over rows and pairs), most sweeps a row, the
  device of its outputs and its seconds (synchronised);
- ``--multihost query`` with 2 ranks on cuda:0 over gloo against one
  process, on the est2genome scan's first N cDNAs (default 4);
- ``dryrun_multichip([cuda:0, cuda:0])`` twice.

Prints the card's name and power limit first and one JSON line of the
numbers last.
"""
from __future__ import annotations

import argparse
import io
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--proteins", type=int, default=2)
    ap.add_argument("--cdnas", type=int, default=4)
    a = ap.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch
    import chip_smoke as smoke
    import torch_split_cases as sc
    from exonerate_tpu_torch import observe
    from exonerate_tpu_torch.cli.exonerate import main as cli_main
    from exonerate_tpu_torch.engine import sdp_rows
    from exonerate_tpu_torch.parallel.dryrun import dryrun_multichip
    if not torch.cuda.is_available():
        raise SystemExit("torch_rows_time: no CUDA card")
    print(smoke._card_line(), flush=True)
    tmp = tempfile.mkdtemp()

    def cli(argv):
        observe.reset()
        buf = io.StringIO()
        t0 = time.perf_counter()
        cli_main(list(argv), out=buf)
        torch.cuda.synchronize()
        return (buf.getvalue(), time.perf_counter() - t0,
                dict(observe.engine_counts), dict(observe.fallback_counts))

    res = {}
    proteins = sc.mutated_proteins(8)[:a.proteins]
    qf = smoke._write_fasta(os.path.join(tmp, "pq.fa"),
                            [(f"p{k}", p) for k, p in enumerate(proteins)])
    tf = smoke._write_fasta(os.path.join(tmp, "st.fa"),
                            [("split_genome", sc.scan_genome(sc.CUTS)[1])])
    argv = smoke.P2G_ARGV + [qf, tf]
    os.environ["EXONERATE_TPU_SDP"] = "native"
    nat = cli(argv)
    print(f"native {nat[1]:.2f} s {nat[2]} {nat[3]}", flush=True)
    os.environ["EXONERATE_TPU_SDP"] = "device"
    band = cli(argv)
    print(f"K6/K7 forced {band[1]:.2f} s {band[2]} {band[3]}; bytes == "
          f"native: {band[0] == nat[0]}", flush=True)
    res.update(native_s=nat[1], band_s=band[1])
    calls = []
    real = sdp_rows.get_fn

    def spy(*args, **kwargs):
        fn = real(*args, **kwargs)

        def timed(inputs, device=None):
            t0 = time.perf_counter()
            out = fn(inputs, device=device)
            torch.cuda.synchronize()
            calls.append((time.perf_counter() - t0, out))
            return out
        return timed

    sdp_rows.get_fn = spy
    os.environ["EXONERATE_TPU_SDP_ROWS"] = "1"
    try:
        for rep in range(2):
            calls.clear()
            rows = cli(argv)
            shape = [(int(o["live"].shape[0]),
                      int(o["row_sweeps_rev"].shape[1]),
                      int(o["row_sweeps_rev"].sum()),
                      int(o["row_sweeps_fwd"].sum()),
                      int(o["sweeps"].max()), str(o["live"].device),
                      round(secs, 3)) for secs, o in calls]
            passes = sum(secs for secs, _o in calls)
            n_dp = sum(int(o["live"].shape[0]) for _s, o in calls)
            print(f"rows forced (run {rep}) {rows[1]:.2f} s {rows[2]} "
                  f"{rows[3]}; bytes == native: {rows[0] == nat[0]}; row "
                  f"passes {passes:.2f} s over {n_dp} DPs; buckets (B, rows "
                  f"a pass, sweeps reverse, forward, most a row, device, s) "
                  f"{shape}", flush=True)
            res[f"rows_s_{rep}"] = rows[1]
            res[f"row_passes_s_{rep}"] = passes
            res["rows_dp"] = n_dp
    finally:
        sdp_rows.get_fn = real
        os.environ.pop("EXONERATE_TPU_SDP_ROWS", None)
        os.environ.pop("EXONERATE_TPU_SDP", None)

    queries, genome = sc.scan_genome((400, 800))
    gf = smoke._write_fasta(os.path.join(tmp, "t.fa"), [("genome", genome)])
    mqf = smoke._write_fasta(os.path.join(tmp, "mq.fa"),
                             [(f"q{k}", q) for k, q in
                              enumerate(queries[:a.cdnas])])
    mh_argv = smoke.SCAN_ARGV + [mqf, gf]
    one = cli(mh_argv)
    outs, mh_secs = smoke._multihost(mh_argv, "query")
    same = outs[0].replace(" --multihost query", "") == one[0]
    print(f"--multihost query, {smoke.MH_RANKS} ranks on cuda:0, "
          f"{a.cdnas} cDNAs: {mh_secs:.2f} s; one process {one[1]:.2f} s; "
          f"merged == one process: {same}", flush=True)
    if not same:
        raise SystemExit("torch_rows_time: --multihost output differs")
    res.update(multihost_s=mh_secs, one_process_s=one[1])
    dev = torch.device("cuda", 0)
    for rep in range(2):
        t0 = time.perf_counter()
        dryrun_multichip([dev, dev])
        torch.cuda.synchronize()
        res[f"dryrun_s_{rep}"] = time.perf_counter() - t0
        print(f"dryrun_multichip([cuda:0, cuda:0]) run {rep}: "
              f"{res[f'dryrun_s_{rep}']:.2f} s", flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
