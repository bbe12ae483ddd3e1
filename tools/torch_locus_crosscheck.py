#!/usr/bin/env python3
"""Why the SDP hybrid's locus cross-check disagrees on the coding2genome
split scan: the host SDP of one locus alone against the same seeds in
the whole comparison.

    python3 tools/torch_locus_crosscheck.py [--query 9] [--oracle]

Builds the scan of ``chip_smoke.py`` phase 5a (``tests/torch_split_cases.py``:
16 mutated calm cDNAs, a 1 Mb genome with 8 copies of the gene cut at cDNA
251 and 402), runs the port's CLI on one query with
``EXONERATE_TPU_SDP=device`` on the CPU, and, instead of the band scan,
takes each comparison's seeds and band plan (``sdp_hybrid.make_plan``) and
runs the host SDP (the C++ scheduler) three ways per locus:

- the whole comparison, all seeds (what the native route and the band
  scan of the whole comparison compute);
- the locus's target window with the locus's seeds only (the hybrid's
  lone re-run, ``HybridSDPPair._resolve``);
- the whole target with the locus's seeds plus those of the locus
  before it.

For a locus whose lone score differs it prints every seed's best end
score both ways.  With ``--oracle`` it reruns that locus with its
predecessor's seeds on the Python SDP and counts the intron-span
submits inside the locus that a stale span-cache entry (stored by the
earlier locus, past ``max_target``) turned away.  Host only: no card.
"""
from __future__ import annotations

import argparse
import io
import os
import sys
import tempfile
import threading

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--query", type=int, default=9)
    ap.add_argument("--oracle", action="store_true")
    args = ap.parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    os.environ["EXONERATE_TPU_SDP"] = "device"
    os.environ["EXONERATE_TPU_TORCH_DEVICE"] = "cpu"
    import torch_split_cases as sc
    from exonerate_tpu_torch.cli.exonerate import main as cli_main
    from exonerate_tpu_torch.engine import sdp as sdpmod
    from exonerate_tpu_torch.engine import sdp_hybrid as hy
    from exonerate_tpu_torch.engine.region import Region

    def run(pair, region=None, seeds=None):
        p = sdpmod.SDPPair(pair.model, pair.comparison, pair.data,
                           pair.subopt, pair.args, region=region,
                           seeds_override=None if seeds is None else [
                               (s.q_cobs, s.t_cobs, s.hsp_score, s.hsp)
                               for s in seeds])
        p._find_starts()
        p._find_ends()
        return p

    # the GAM pool may run both strands at once: one probe at a time
    lock = threading.Lock()

    def probe(self):
        with lock:
            report(self)
        raise hy.HybridFallback()

    def report(self):
        g = self.gpair
        qlen = g.region.query_length
        whole = run(g)
        loci = hy.make_plan(self.model, g).loci
        out = [f"comparison ({len(g.seeds)} seeds): whole-comparison best "
               f"{max(s.max_end.score for s in whole.seeds)}"]
        for lx, lc in enumerate(loci):
            lo, hi = lc.seed_lo, lc.seed_hi
            lone = run(g, Region(0, lc.t0, qlen, lc.t1 - lc.t0),
                       g.seeds[lo:hi])
            l_best = max(s.max_end.score for s in lone.seeds)
            w_best = max(whole.seeds[k].max_end.score for k in range(lo, hi))
            line = (f"  locus {lx} t {lc.t0}-{lc.t1} seeds {lo}-{hi}: "
                    f"whole comparison {w_best}, alone {l_best}")
            if lx and l_best != w_best:
                plo = loci[lx - 1].seed_lo
                two = run(g, None, g.seeds[plo:hi])
                line += (", with locus {} seeds {}".format(
                    lx - 1, max(two.seeds[k - plo].max_end.score
                                for k in range(lo, hi))))
            out.append(line)
            if l_best == w_best:
                continue
            for k in range(lo, hi):
                a, b = whole.seeds[k].max_end, lone.seeds[k - lo].max_end
                out.append(f"    seed {k} (q {g.seeds[k].q_cobs}, t "
                           f"{g.seeds[k].t_cobs}): whole {a.score} at "
                           f"({a.qpos}, {a.tpos}), alone {b.score} at "
                           f"({b.qpos}, {b.tpos + lc.t0})")
            if args.oracle and lx:
                out.append(oracle(g, loci, lx))
        print("\n".join(out), flush=True)

    def oracle(g, loci, lx):
        lc, plo = loci[lx], loci[lx - 1].seed_lo
        real = sdpmod._Pass._span_submit
        turned = []

        def submit(self_, span, cell, ip, src_q, src_t):
            stored = self_.span_cache.get((span.id, src_q))
            if (stored is not None and span.max_target
                    and lc.t0 <= src_t < lc.t1
                    and stored.score > cell.score[ip]
                    and stored.t_entry + span.max_target < src_t):
                turned.append((src_t - stored.t_entry))
            return real(self_, span, cell, ip, src_q, src_t)

        sdpmod._Pass._span_submit = submit
        os.environ["EXONERATE_TPU_SDP"] = "python"
        try:
            p = run(g, None, g.seeds[plo:lc.seed_hi])
        finally:
            sdpmod._Pass._span_submit = real
            os.environ["EXONERATE_TPU_SDP"] = "device"
        best = max(p.seeds[k - plo].max_end.score
                   for k in range(lc.seed_lo, lc.seed_hi))
        return (f"    Python SDP, loci {lx - 1}-{lx}: locus {lx} best {best}"
                f"; {len(turned)} span submits inside locus {lx} turned "
                f"away by stale entries stored {min(turned, default=0)}-"
                f"{max(turned, default=0)} bp earlier")

    hy.HybridSDPPair._run_device = probe
    hy.DEVICE_MIN_W = 0
    queries, genome = sc.scan_genome(sc.CUTS)
    with tempfile.TemporaryDirectory() as tmp:
        qf = sc.write_fasta(os.path.join(tmp, "q.fa"),
                            [(f"q{args.query}", queries[args.query])])
        tf = sc.write_fasta(os.path.join(tmp, "t.fa"),
                            [("split_genome", genome)])
        cli_main(["-m", "coding2genome", "--bestn", "1", "--maxintron",
                  "20000", "--showvulgar", "yes", "--showalignment", "no",
                  qf, tf], out=io.StringIO())
    return 0


if __name__ == "__main__":
    sys.exit(main())
