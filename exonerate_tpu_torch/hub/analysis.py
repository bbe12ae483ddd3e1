"""Analysis: the top-level comparison driver.

Counterpart of ``exonerate_tpu/hub/analysis.py`` (ref:
src/hub/analysis.c): guesses/forces alphabet types, builds the model +
GAM, expands FOSN lists, runs the seeded pipeline (default) or the
exhaustive pair loop, handles strand expansion (revcomp query/target
passes, ref: fastapipe.c:41-51) and normalizes comparisons before handing
them to the GAM (ref: analysis.c:102-138).

The Analysis takes the port's device and hands it to the port's GAM.
Under ``EXONERATE_TPU_HEURISTIC=locus`` it defers every gapped
comparison to the GAM's pooled locus heuristic and flushes them at the
end of the scan, on the card and on the CPU alike.  With ``--cores N``
(N > 1) it runs each comparison in a pool of N worker threads instead,
as the JAX package does: no deferral, the GAM's ``devices`` set to the
visible cards (up to N; ``[cpu]`` for a caller on the CPU), each worker
launching on CUDA streams of its own, and the results submitted strictly
in comparison order, so the bytes are those of ``--cores 1``.  The
cross-chip band scan
(``EXONERATE_TPU_CROSS_CHIP``) runs where that many cards are visible
and is ignored elsewhere, as in the JAX package.
"""
from __future__ import annotations

import os
import sys

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Optional

import torch

from .. import device as default_device
from ..alphabet import Alphabet, AlphabetType
from ..seqio import FastaDB, Sequence, read_annotation_file
from ..model.data import (AffineArgs, AlignData, FrameshiftArgs, IntronArgs,
                          MatchArgs, NerArgs)
from ..model import registry
from ..model.registry import ModelType
from ..model.match import Match, MatchType, match_type_find
from ..seeds.hsp import HspArgs, HspParam
from ..seeds.seeder import Seeder, SeederArgs
from ..seeds.wordhood import WordHood
from .gam import GAM, GamArgs


@dataclass
class AnalysisArgs:
    """(ref: Analysis_ArgumentSet, analysis.c:31-66)."""
    use_exhaustive: bool = False
    use_bigseq: bool = False
    use_revcomp: bool = True
    force_scan: str = "none"
    saturate_threshold: int = 0
    cores: int = 1
    custom_server: str | None = None


class Analysis:
    def __init__(self, query_paths, target_paths,
                 query_chunk=(0, 0), target_chunk=(0, 0),
                 gas: Optional[GamArgs] = None,
                 aas: Optional[AnalysisArgs] = None,
                 match_args: Optional[MatchArgs] = None,
                 affine_args: Optional[AffineArgs] = None,
                 intron_args: Optional[IntronArgs] = None,
                 frameshift_args: Optional[FrameshiftArgs] = None,
                 ner_args: Optional[NerArgs] = None,
                 hsp_args: Optional[HspArgs] = None,
                 seeder_args: Optional[SeederArgs] = None,
                 query_type: Optional[AlphabetType] = None,
                 target_type: Optional[AlphabetType] = None,
                 annotation_path: Optional[str] = None,
                 fasta_suffix: str = ".fa",
                 out=None, verbosity: int = 0,
                 device: Optional[torch.device] = None):
        self.device = device if device is not None else default_device()
        self.gas = gas or GamArgs()
        self.aas = aas or AnalysisArgs()
        self.match_args = match_args or MatchArgs()
        self.affine_args = affine_args or AffineArgs()
        self.intron_args = intron_args or IntronArgs()
        self.frameshift_args = frameshift_args or FrameshiftArgs()
        self.ner_args = ner_args or NerArgs()
        self.hsp_args = hsp_args or HspArgs()
        self.seeder_args = seeder_args or SeederArgs()
        self.verbosity = verbosity
        self.annotations = (read_annotation_file(annotation_path)
                            if annotation_path else {})
        # Reference-fork parity: the fork's tsearch migration broke the
        # annotation id lookup (sequence.c:176-178 compares a gchar* key
        # against Sequence_Annotation* nodes with strcmp), so in the
        # reference binary --annotation is parsed but NEVER attaches to
        # any sequence.  We replicate that by default; set
        # EXONERATE_TPU_FIX_ANNOTATION=1 for the documented (pre-fork)
        # semantics.  The correct behaviour stays covered by the
        # cdna2genome model crib (score 1281) via the library API.
        if self.annotations and \
                not os.environ.get("EXONERATE_TPU_FIX_ANNOTATION"):
            self.annotations = {}

        from .client import is_server_path
        self.server_targets = [p for p in (target_paths or [])
                               if is_server_path(p)]
        self.query_db = FastaDB(query_paths, suffix=fasta_suffix,
                                chunk_id=query_chunk[0],
                                chunk_total=query_chunk[1])
        if self.server_targets:
            self.target_db = None
        else:
            self.target_db = FastaDB(target_paths, suffix=fasta_suffix,
                                     chunk_id=target_chunk[0],
                                     chunk_total=target_chunk[1])
        self.query_type = query_type or self.query_db.guess_type()
        if self.server_targets:
            self.target_type = target_type or AlphabetType.DNA
        else:
            self.target_type = target_type or self.target_db.guess_type()
        registry.check_input(self.gas.model_type, self.query_type,
                             self.target_type)
        self.model = registry.get_model(self.gas.model_type,
                                        self.query_type, self.target_type,
                                        self.intron_args)
        self.translate_both = registry.translate_both(self.gas.model_type)
        self.gam = GAM(self.model, self.gas, self._make_data, out=out,
                       device=self.device)
        self.gam.geneseed_threshold = self.hsp_args.geneseed_threshold
        self._sdp_pending: list = []
        self._locus_pending: list = []
        self._pool = None
        self._pending = None
        self._streams: list = []
        if self.aas.cores > 1:
            # a thread pool over comparisons (exonerate_tpu/hub/
            # analysis.py:114-124): the native engines and the kernels'
            # ctypes launches release the GIL, so -c N runs per-pair work
            # in parallel; results are submitted strictly in comparison
            # order (_drain)
            self.gam.devices = self._pool_devices()
            self._pool = ThreadPoolExecutor(
                max_workers=self.aas.cores, initializer=self._worker_streams)
            self._pending = deque()

    def _pool_devices(self) -> list:
        """The devices of --cores: the visible cards, up to --cores of
        them, for a caller on a card (one on a one-card host, as the JAX
        package gets its one TPU chip); the CPU for a caller there."""
        if self.device.type != "cuda":
            return [self.device]
        n = min(self.aas.cores, torch.cuda.device_count())
        return [torch.device("cuda", k) for k in range(n)]

    def _worker_streams(self):
        """Pool initializer: the worker thread launches on a stream of its
        own on each card of ``gam.devices``, for the life of the pool, so
        that the threads' kernels can run at once (on the device's default
        stream they would run one after another).  The tensors a worker
        allocates are then its stream's, and the caching allocator hands
        a block it frees to that stream only."""
        for dev in self.gam.devices:
            if dev.type == "cuda":
                stream = torch.cuda.Stream(device=dev)
                self._streams.append(stream)
                torch.cuda.set_stream(stream)

    # -- data -------------------------------------------------------------

    def _make_data(self, query: Sequence, target: Sequence) -> AlignData:
        data = AlignData(query, target, self.translate_both,
                         self.match_args, self.affine_args,
                         self.intron_args, self.frameshift_args,
                         self.ner_args)
        return data

    def _load_seq(self, seq: Sequence, atype: AlphabetType) -> Sequence:
        seq.alphabet = Alphabet(atype)
        ann = self.annotations.get(seq.id)
        if ann is not None:
            seq.annotation = ann
            seq.strand = "+"
            if ann.strand == "-":
                seq = seq.revcomp()
        elif atype == AlphabetType.DNA:
            seq.strand = "+"
        return seq

    def _expand_strands(self, seq: Sequence, revcomp: bool):
        yield seq
        if revcomp:
            yield seq.revcomp()

    # -- hsp params --------------------------------------------------------

    def comparison_params(self) -> dict[str, HspParam]:
        """Which HSP classes apply (ref: Comparison_Param +
        Analysis_create wiring)."""
        mt = self.gas.model_type
        q, t = self.query_type, self.target_type
        params: dict[str, HspParam] = {}
        if registry.has_dual_match(mt):
            params["dna"] = HspParam(
                Match(MatchType.DNA2DNA, self.match_args), self.hsp_args)
            params["codon"] = HspParam(
                Match(MatchType.CODON2CODON, self.match_args),
                self.hsp_args)
        else:
            match_type = match_type_find(q, t, self.translate_both)
            kind = {MatchType.DNA2DNA: "dna",
                    MatchType.CODON2CODON: "codon"}.get(match_type,
                                                        "protein")
            params[kind] = HspParam(Match(match_type, self.match_args),
                                    self.hsp_args)
        return params

    def _wordhoods(self, params):
        out = {}
        for kind, p in params.items():
            wh = WordHood.for_param(p)
            if wh is not None:
                out[kind] = wh
        return out

    # -- the drive ---------------------------------------------------------

    def process(self):
        if not self.aas.use_exhaustive and not self.gam.model.is_local:
            # (ref: GAM_create, gam.c:417-418: heuristics need local
            # models; g_error aborts with a FATAL ERROR)
            sys.stderr.write("** FATAL ERROR **: Cannot perform "
                             "heuristic alignments using non-local "
                             "models: use -E\nexiting ...\n")
            raise SystemExit(1)
        if self.server_targets:
            from .client import run_client_analysis
            for hostport in self.server_targets:
                run_client_analysis(self, hostport)
        elif self.aas.use_exhaustive:
            self._process_exhaustive()
        elif self.aas.use_bigseq:
            self._process_bigseq()
        else:
            self._process_seeded()
        if self._pool is not None:
            try:
                while self._pending:
                    self.gam.submit(self._pending.popleft().result())
            finally:
                self._pool.shutdown(cancel_futures=True)
        self._flush_locus_pool()
        self._flush_sdp_pool()
        self.gam.report()

    def _process_bigseq(self):
        """Big-sequence mode (ref: BSAM, src/hub/bsam.c): pairwise
        exact-seed scanning in linear memory.  The reference concatenates
        the pair and runs the DejaVu repeat finder; the packed-word join
        is already linear in the sequence lengths, so bigseq mode is the
        seeded pipeline run one pair at a time with exact words only."""
        params = self.comparison_params()
        revcomp_query = (self.aas.use_revcomp
                         and self.query_type == AlphabetType.DNA)
        revcomp_target = (self.aas.use_revcomp
                          and ((self.query_type == AlphabetType.PROTEIN
                                and self.target_type == AlphabetType.DNA)
                               or self.translate_both))
        # the streamed exact-word join keeps memory bounded by
        # --fsmmemory at chromosome scale (ref: BSAM/DejaVu linear
        # memory, bsam.c:142-239); eligible for plain dna-exact
        # seeding, byte-identical to the in-memory path
        streamable = (set(params) == {"dna"}
                      and self.seeder_args.word_ambiguity <= 1)
        for query in self.query_db:
            query = self._load_seq(query, self.query_type)
            for qv in self._expand_strands(query, revcomp_query):
                for target in self.target_db:
                    target = self._load_seq(target, self.target_type)
                    for tv in self._expand_strands(target,
                                                   revcomp_target):
                        if self.verbosity > 0:
                            kind, param = next(iter(params.items()))
                            self._bigseq_progress(
                                qv, tv, param.wordlen)
                        if streamable:
                            self._bigseq_pair_streamed(params["dna"],
                                                       qv, tv)
                            continue
                        seeder = Seeder(params,
                                        self._report_comparison,
                                        self.seeder_args, {})
                        seeder.add_query(qv)
                        seeder.add_target(tv)

    def _bigseq_pair_streamed(self, param, qv, tv):
        from ..seeds.seeder import bigseq_stream_join
        from ..seeds.hsp import Comparison, HspSet
        budget = max(1, self.seeder_args.fsm_memory_limit) << 20
        seeds = bigseq_stream_join(param, qv, tv, self.seeder_args,
                                   budget)
        if not len(seeds):
            return
        hs = HspSet(qv, tv, param)
        hs.seed_batch(seeds)
        comp = Comparison(qv, tv, dna=hs)
        if comp.has_hsps:
            comp.finalise()
            self._report_comparison(comp)

    def _bigseq_progress(self, qv, tv, wordlen: int):
        """The DejaVu level-progress line (ref: DejaVu_traverse,
        dejavu.c:160-191 prints one dot per word-length level while
        repeats remain, up to the seeding word length)."""
        import numpy as np
        from ..alphabet import TO_UPPER
        concat = np.concatenate([TO_UPPER[qv.data],
                                 np.frombuffer(b"-", dtype=np.uint8),
                                 TO_UPPER[tv.data]])

        def has_repeat(L):
            n = len(concat)
            if n < L:
                return False
            win = np.lib.stride_tricks.sliding_window_view(concat, L)
            u = np.unique(win, axis=0)
            return len(u) < len(win)

        if has_repeat(wordlen):
            dots = wordlen
        else:
            dots = 0
            for L in range(1, wordlen):
                if not has_repeat(L):
                    break
                dots = L
        self.gam.out.write("Message: Processing ["
                           + "." * dots + "]\n")

    def _process_exhaustive(self):
        """(ref: analysis.c pair-loop path, Analysis_Pair_compare)."""
        revcomp_query = (self.aas.use_revcomp
                         and self.query_type == AlphabetType.DNA)
        revcomp_target = (self.aas.use_revcomp
                          and ((self.query_type == AlphabetType.PROTEIN
                                and self.target_type == AlphabetType.DNA)
                               or self.translate_both))
        for query in self.query_db:
            query = self._load_seq(query, self.query_type)
            for qv in self._expand_strands(query, revcomp_query):
                for target in self.target_db:
                    target = self._load_seq(target, self.target_type)
                    for tv in self._expand_strands(target, revcomp_target):
                        self._compare_exhaustive(qv, tv)

    def _compare_exhaustive(self, query: Sequence, target: Sequence):
        # NO strand normalization here: only the seeded path's report
        # callback flips (q-, t+) comparisons (analysis.c:102-138); the
        # exhaustive pair loop aligns the revcomp'd QUERY as-is
        # (Analysis_Pair_compare), and the pass structure shows in the
        # output strands
        results = self.gam.result_exhaustive(query, target)
        self.gam.submit(results)

    def _normalize_pair(self, query: Sequence, target: Sequence):
        """Strand normalization before reporting
        (ref: Analysis_report_func, analysis.c:102-138)."""
        if (query.alphabet.type == AlphabetType.DNA
                and target.alphabet.type == AlphabetType.DNA
                and query.strand == "-" and target.strand != "-"
                and not self.translate_both):
            return query.revcomp(), target.revcomp()
        return query, target

    def _decide_scan_query(self) -> bool:
        """Pick the FSM scan side (ref: Analysis_decide_scan_query,
        analysis.c:329-350): scan the target db unless the query db is
        more than 16x its size, or --forcescan overrides."""
        fs = (self.aas.force_scan or "none").lower()
        if fs in ("query", "q"):
            return True
        if fs in ("target", "t"):
            return False
        if fs != "none":
            raise ValueError(f"Unknown force_scan command [{fs}]")
        qsize = sum(os.path.getsize(p) for p in self.query_db.paths)
        tsize = sum(os.path.getsize(p) for p in self.target_db.paths)
        return (qsize >> 4) >= tsize

    def _process_seeded(self):
        """(ref: seeded FastaPipe path, analysis.c:1360-1420)."""
        params = self.comparison_params()
        revcomp_query = (self.aas.use_revcomp
                         and self.query_type == AlphabetType.DNA)
        revcomp_target = (self.aas.use_revcomp
                          and ((self.query_type == AlphabetType.PROTEIN
                                and self.target_type == AlphabetType.DNA)
                               or self.translate_both))
        self._scan_query = self._decide_scan_query()

        def report(comparison):
            self._report_comparison(comparison)

        if self._scan_query:
            # load targets into the FSM and stream queries past it,
            # swapping roles back in the report callback
            # (ref: analysis.c:1352-1359 seeder db swap)
            params = {k: p.swap() for k, p in params.items()}

            def batch_views():
                for target in self.target_db:
                    target = self._load_seq(target, self.target_type)
                    yield from self._expand_strands(target,
                                                    revcomp_target)

            def stream_views():
                for query in self.query_db:
                    query = self._load_seq(query, self.query_type)
                    yield from self._expand_strands(query,
                                                    revcomp_query)
        else:
            def batch_views():
                for query in self.query_db:
                    query = self._load_seq(query, self.query_type)
                    yield from self._expand_strands(query,
                                                    revcomp_query)

            def stream_views():
                for target in self.target_db:
                    target = self._load_seq(target, self.target_type)
                    yield from self._expand_strands(target,
                                                    revcomp_target)

        # --fsmmemory bounds each word-table batch; when a batch fills,
        # the stream side re-runs against the next batch (ref: the
        # FastaPipe query-batch protocol, fastapipe.h:31-72 — batches
        # load until the Seeder reports the FSM memory limit reached)
        limit = max(1, self.seeder_args.fsm_memory_limit) << 20
        seeder = None
        for view in batch_views():
            if seeder is not None and seeder.memory_estimate() > limit:
                for sv in stream_views():
                    seeder.add_target(sv)
                seeder = None
            if seeder is None:
                seeder = Seeder(params, report, self.seeder_args,
                                self._wordhoods(params),
                                self.aas.saturate_threshold)
            seeder.add_query(view)
        if seeder is not None and seeder.queries:
            for sv in stream_views():
                seeder.add_target(sv)

    def _report_comparison(self, comparison):
        if getattr(self, "_scan_query", False):
            # swap back query and target after a query scan
            # (ref: Analysis_report_func, analysis.c:108-111)
            comparison.swap()
        # normalize dna2dna revcomp-query comparisons (analysis.c:113-118)
        elif (comparison.query.alphabet.type == AlphabetType.DNA
                and comparison.target.alphabet.type == AlphabetType.DNA
                and comparison.query.strand == "-"
                and comparison.target.strand != "-"
                and not self.translate_both):
            self._comparison_revcomp(comparison)
        gapped = registry.is_gapped(self.gas.model_type)
        if gapped and self._pool is None \
                and self.gas.use_gapped_extension \
                and os.environ.get("EXONERATE_TPU_HEURISTIC") == "locus":
            # pooled locus mode: defer so every comparison's loci share
            # each generation's kernel batches; flushed by
            # _flush_locus_pool at the end of the scan (same comparison
            # completion order -> same output bytes)
            self._locus_pending.append(comparison)
            return
        if gapped and self._pool is None \
                and self.gas.use_gapped_extension \
                and not self.aas.use_bigseq \
                and self.gam.sdp_device_active():
            # device SDP mode: defer so every comparison's passes share
            # a few batched band-kernel launches; flushed by
            # _flush_sdp_pool (same completion order -> same bytes).
            # bigseq pairs stay un-deferred: their per-pair progress
            # lines interleave with results in the reference's order
            self._sdp_pending.append(comparison)
            return
        fn = (self.gam.result_heuristic if gapped
              else self.gam.result_ungapped)
        if self._pool is not None:
            self._pending.append(self._pool.submit(fn, comparison))
            self._drain(block=len(self._pending) >= self.aas.cores * 4)
        else:
            self.gam.submit(fn(comparison))

    def _flush_locus_pool(self):
        if not self._locus_pending:
            return
        pending, self._locus_pending = self._locus_pending, []
        for results in self.gam.result_heuristic_pooled(pending):
            self.gam.submit(results)

    def _flush_sdp_pool(self):
        if not self._sdp_pending:
            return
        pending, self._sdp_pending = self._sdp_pending, []
        self.gam.run_sdp_pool(pending)

    def _drain(self, block: bool = False):
        """Submit finished comparison results in order."""
        while self._pending:
            f = self._pending[0]
            if not block and not f.done():
                break
            self._pending.popleft()
            self.gam.submit(f.result())
            block = False

    @staticmethod
    def _comparison_revcomp(comparison):
        """(ref: Comparison_revcomp, comparison.c:238-251)."""
        rc_q = comparison.query.revcomp()
        rc_t = comparison.target.revcomp()
        comparison.query = rc_q
        comparison.target = rc_t
        for hs in comparison.hspsets():
            hs.query = rc_q
            hs.target = rc_t
            for h in hs.hsps:
                h.query_start = len(rc_q) - h.query_end(hs.qadv)
                h.target_start = len(rc_t) - h.target_end(hs.tadv)
            # rebuild score caches on the revcomped sequences
            m = hs.param.match
            hs._qi = m._row_indices(rc_q, m.advance_query)
            hs._ti = m._row_indices(rc_t, m.advance_target)
