"""Word seeding: multiplexed query word tables + target scans.

TPU-native equivalent of the reference Seeder (ref: src/comparison/
seeder.{h,c}).  Where the reference streams target symbols through an
FSM/VFSM trie, we use the VFSM arithmetic directly (a word is a base-N
positional number, ref: src/struct/vfsm.h:73-86) over vectorized NumPy
rolling windows: pack all query words into a hash table once, then pack all
target windows in one vectorized pass and join.  Seed emission order
(ascending target end position; per word, reverse insertion order of query
words) matches the reference FSM traversal so horizon dedup behaves
identically.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from ..alphabet import IS_SOFTMASKED
from ..seqio import Sequence
from ..model.match import Match, MatchType
from .hsp import Comparison, HspParam, HspSet

DNA_MEMBERS = "ACGT"
PROTEIN_MEMBERS = "ARNDCQEGHILKMFPSTWYUV*"

# (target content, word params, query word-set content) -> per-frame
# (hit indices, packed words): the target side of a scan re-derives the
# identical join for every warm run / serving query (see scan_target)
_SCAN_MEMO: dict = {}

# loader content signature -> CSR emission table (see _emission_table)
_CSR_MEMO: dict = {}


@dataclass
class SeederArgs:
    """(ref: Seeder_ArgumentSet, seeder.c:38-52)."""
    fsm_memory_limit: int = 256
    force_fsm: str = "none"
    word_jump: int = 1
    word_ambiguity: int = 1


def member_codes(alphabet_is_protein: bool) -> np.ndarray:
    members = PROTEIN_MEMBERS if alphabet_is_protein else DNA_MEMBERS
    codes = np.full(256, -1, dtype=np.int64)
    for i, ch in enumerate(members):
        codes[ord(ch)] = i
        codes[ord(ch.lower())] = i
    return codes


class _Loader:
    """Per-match-class word table (ref: Seeder_Loader)."""

    def __init__(self, hsp_param: HspParam, kind: str,
                 args: SeederArgs):
        self.hsp_param = hsp_param
        self.kind = kind  # 'dna' | 'protein' | 'codon'
        self.args = args
        match = hsp_param.match
        # per-strand translation flags (ref: Match_Strand_create calls,
        # match.c:746-813): only the DNA side of the MIXED protein/DNA
        # matches is translated for seeding; CODON2CODON seeds on RAW
        # DNA words (12 nt) packed into the protein-member alphabet
        self.query_is_translated = match.type == MatchType.DNA2PROTEIN
        self.target_is_translated = match.type == MatchType.PROTEIN2DNA
        # comparison alphabet: protein for everything except dna2dna
        # (ref: match.c comparison_alphabet assignments)
        self.is_protein_words = match.type != MatchType.DNA2DNA
        self.codes = member_codes(self.is_protein_words)
        self.nsym = len(PROTEIN_MEMBERS if self.is_protein_words
                        else DNA_MEMBERS)
        # words are wordlen SYMBOLS long in comparison space — even for
        # translated comparisons, where a 12-symbol codon word covers 36
        # nt (ref: Seeder_insert_query, seeder.c:478-559 uses
        # hsp_param->wordlen over the translated string; seedlen is only
        # the nascent HSP length, hspset.c:975)
        self.wordlen = hsp_param.wordlen
        if self.target_is_translated:
            self.tpos_modifier = self.wordlen * 3 - 3
        else:
            self.tpos_modifier = self.wordlen - 1
        # packed word -> list of (query_index, orig_qpos) in insertion order
        self.words: dict[int, list[tuple[int, int]]] = {}
        # packed word -> list of neighbour packed words (wordhood)
        self.neighbours: dict[int, list[int]] = {}
        self._wj_ctr = 0
        self._rev = 0               # bumped per add_query (CSR validity)
        self._csr = None            # (rev, known, off, qidx, qpos)
        # content signature of everything that shapes words/neighbours:
        # folds in each add_query's (qidx, residue content, softmask,
        # annotation, wordhood content); lets warm runs reuse the CSR
        # emission table across processes' identical query sets.  The
        # match type matters beyond (kind, nsym): it selects query
        # translation and the _word_is_valid veto mode
        self._sig = hash((kind, match.type, self.wordlen, self.nsym,
                          self.query_is_translated,
                          self.target_is_translated,
                          args.word_jump, args.word_ambiguity))

    # -- word packing -----------------------------------------------------

    def _pack_valid(self, seq: Sequence, softmask: bool
                    ) -> tuple[np.ndarray, np.ndarray]:
        """Return (packed, valid) arrays over window END positions."""
        data = seq.data
        W = self.wordlen
        n = len(data)
        if n < W:
            return (np.zeros(0, dtype=np.int64),
                    np.zeros(0, dtype=bool))
        code = self.codes[data]
        if softmask:
            code = np.where(IS_SOFTMASKED[data], -1, code)
        valid_sym = code >= 0
        csum = np.concatenate([[0], np.cumsum(~valid_sym)])
        # window [i-W+1 .. i] valid iff no invalid symbols inside
        win_valid = (csum[W:] - csum[:-W]) == 0
        packed = np.zeros(n - W + 1, dtype=np.int64)
        safe = np.where(valid_sym, code, 0)
        for k in range(W):
            packed = packed * self.nsym + safe[k:n - W + 1 + k]
        return packed, win_valid

    def add_query(self, qidx: int, query: Sequence, match: Match,
                  wordhood=None):
        """(ref: Seeder_insert_query, seeder.c:478-559)."""
        self._rev += 1
        softmask = (match.mas.softmask_query
                    and not self.query_is_translated)
        from ..seqio import seq_ckey
        ann = query.annotation
        self._sig = hash((
            self._sig, qidx, seq_ckey(query), softmask,
            (ann.cds_start, ann.cds_length, ann.strand)
            if ann is not None else None,
            None if wordhood is None else (
                wordhood.members, wordhood.limit, wordhood.use_dropoff,
                wordhood.wordlen, hash(wordhood.m.tobytes()))))
        frames = [0]
        seqs = [query]
        if self.query_is_translated:
            frames = [1, 2, 3]
            seqs = [query.translate_view(f) for f in frames]
        for frame, seq in zip(frames, seqs):
            packed, valid = self._pack_valid(seq, softmask)
            W = self.wordlen
            for i in np.nonzero(valid)[0]:
                # word_jump counts valid words (ref: seeder.c:520-523)
                if self._wj_ctr:
                    self._wj_ctr -= 1
                    continue
                self._wj_ctr = self.args.word_jump - 1
                pos = int(i)
                orig = pos * 3 + frame - 1 if frame else pos
                if not _word_is_valid(match, seq, pos, W):
                    continue
                w = int(packed[pos])
                entry = self.words.get(w)
                first = entry is None or not entry
                if entry is None:
                    entry = []
                    self.words[w] = entry
                entry.append((qidx, orig))
                if first and wordhood is not None:
                    for nb in wordhood.neighbours(w):
                        if nb != w:
                            self.neighbours.setdefault(nb, []).append(w)

    def _emission_table(self):
        """CSR over the sorted known-word array: for word k, rows
        off[k]..off[k+1] are the (qidx, qpos) pairs emit_word would
        produce for one target hit, in exact emission order (own
        entries LIFO, then each neighbour source's entries LIFO) —
        the vectorized form of the per-seed Python loop."""
        if self._csr is not None and self._csr[0] == self._rev:
            return self._csr[1:]
        # structural fields alongside the chained hash: a 64-bit hash
        # collision alone must not alias two different emission tables
        # (counts pin the table's shape; cheap vs. the table build)
        memo_key = (self._sig, self.wordlen, len(self.words),
                    len(self.neighbours),
                    sum(len(v) for v in self.words.values()))
        hit = _CSR_MEMO.get(memo_key)
        if hit is not None:
            self._csr = (self._rev,) + hit
            return hit
        if not (self.words or self.neighbours):
            self._csr = (self._rev, np.zeros(0, np.int64),
                         np.zeros(1, np.int64),
                         np.zeros(0, np.int64), np.zeros(0, np.int64))
            return self._csr[1:]
        known = np.fromiter(set(self.words) | set(self.neighbours),
                            dtype=np.int64)
        known.sort()
        off = np.zeros(len(known) + 1, dtype=np.int64)
        qidxs: list[int] = []
        qposs: list[int] = []
        for k, w in enumerate(known):
            w = int(w)
            entry = self.words.get(w)
            if entry:
                for qi, qp in reversed(entry):
                    qidxs.append(qi)
                    qposs.append(qp)
            for src in self.neighbours.get(w, ()):
                for qi, qp in reversed(self.words.get(src, ())):
                    qidxs.append(qi)
                    qposs.append(qp)
            off[k + 1] = len(qidxs)
        self._csr = (self._rev, known, off,
                     np.asarray(qidxs, dtype=np.int64),
                     np.asarray(qposs, dtype=np.int64))
        if len(_CSR_MEMO) > 32:
            _CSR_MEMO.clear()
        _CSR_MEMO[memo_key] = self._csr[1:]
        return self._csr[1:]

    def scan_target(self, target: Sequence, match: Match, emit: Callable,
                    emit_batch: Optional[Callable] = None):
        """(ref: Seeder_add_target + VFSM traverse, seeder.c:696-716,
        852-915).  emit(loader, qidx, qpos, tpos) per seed, or —
        when emit_batch is given and no ambiguity expansion applies —
        emit_batch(loader, qidx_arr, qpos_arr, tpos_arr) per frame in
        the same order."""
        softmask = (match.mas.softmask_target
                    and not self.target_is_translated)
        frames = [0]
        if self.target_is_translated:
            frames = [1, 2, 3]

        def _frame_seq(f):
            # translation deferred: a memo hit skips it entirely
            return target.translate_view(f) if f else target
        # vectorized membership: only windows whose packed word is a
        # known query word (or neighbour) reach the Python emit loop —
        # the equivalent of the VFSM rejecting non-query words in-state
        # (ref: seeder.c:696-716)
        known, csr_off, csr_qidx, csr_qpos = self._emission_table()
        if not len(known):
            known = None
        ambig = (self.args.word_ambiguity > 1
                 and not self.is_protein_words)
        # the per-frame hit list depends only on (target content, word
        # parameters, query word-set content) — identical across warm
        # runs and across serving queries with the same word set, so
        # the translate + pack + join pipeline memoizes (disabled for
        # ambiguity expansion, which needs the raw window arrays)
        from ..seqio import seq_ckey
        memo_base = None
        if known is not None and not ambig:
            # len + end words pin the word-set structurally; the hash
            # alone could collide across different sets
            memo_base = (seq_ckey(target), self.wordlen, softmask,
                         self.nsym, self.target_is_translated,
                         hash(known.tobytes()), len(known),
                         int(known[0]), int(known[-1]))
        for frame in frames:
            hit_pw = None
            if memo_base is not None:
                hit_pw = _SCAN_MEMO.get(memo_base + (frame,))
            if hit_pw is None:
                seq = _frame_seq(frame)
                packed, valid = self._pack_valid(seq, softmask)
                hits = np.nonzero(valid)[0]
                if known is None or not len(known):
                    hits = hits[:0]
                elif len(hits):
                    pw = packed[hits]
                    pos = np.searchsorted(known, pw)
                    pos[pos >= len(known)] = len(known) - 1
                    hits = hits[known[pos] == pw]
                hit_pw = (hits, packed[hits] if len(hits)
                          else np.zeros(0, np.int64))
                if memo_base is not None:
                    if len(_SCAN_MEMO) > 64:
                        _SCAN_MEMO.clear()
                    _SCAN_MEMO[memo_base + (frame,)] = hit_pw

            def emit_word(w: int, i: int):
                end = i + self.wordlen - 1
                tpos = end * 3 + frame - 1 if frame else end
                target_pos = tpos - self.tpos_modifier
                entry = self.words.get(w)
                if entry:
                    # seed list is LIFO in the reference (prepend)
                    for qidx, qpos in reversed(entry):
                        emit(self, qidx, qpos, target_pos)
                for src in self.neighbours.get(w, ()):  # wordhood
                    for qidx, qpos in reversed(self.words.get(src, ())):
                        emit(self, qidx, qpos, target_pos)

            if emit_batch is not None and not ambig:
                # CSR gather replacing the ~100k-call Python emit loop,
                # preserving emission order exactly (hits ascending;
                # per hit, the word's CSR payload)
                hits, pw = hit_pw
                if len(hits):
                    pos = np.searchsorted(known, pw)
                    starts = csr_off[pos]
                    cnt = csr_off[pos + 1] - starts
                    total = int(cnt.sum())
                    if total:
                        reset = starts - np.concatenate(
                            ([0], np.cumsum(cnt)[:-1]))
                        flat = np.repeat(reset, cnt) + np.arange(total)
                        end = hits + self.wordlen - 1
                        tpos = end * 3 + frame - 1 if frame else end
                        emit_batch(self, csr_qidx[flat], csr_qpos[flat],
                                   np.repeat(tpos - self.tpos_modifier,
                                             cnt))
                continue
            for i, w in zip(hit_pw[0], hit_pw[1]):
                emit_word(int(w), int(i))
            if ambig:
                for i, w in self._ambiguous_words(seq, valid):
                    emit_word(w, i)

    def _ambiguous_words(self, seq: Sequence, valid: np.ndarray):
        """Expand target windows containing IUPAC ambiguity codes into up
        to --wordambiguity concrete words (ref: Seeder_VFSM_traverse_ambig,
        seeder.c:718-790)."""
        from ..alphabet import IS_DNA, TO_UPPER
        from ..translate import NT4
        W = self.hsp_param.wordlen
        data = TO_UPPER[seq.data]
        n = len(data)
        if n < W:
            return
        acgt_ok = self.codes[data] >= 0
        iupac_ok = IS_DNA[data] & (data != ord("-"))
        ambig = iupac_ok & ~acgt_ok
        cap = self.args.word_ambiguity
        # windows that are IUPAC-valid but not pure ACGT
        csum_bad = np.concatenate([[0], np.cumsum(~iupac_ok)])
        csum_amb = np.concatenate([[0], np.cumsum(ambig)])
        win_iupac = (csum_bad[W:] - csum_bad[:-W]) == 0
        win_amb = (csum_amb[W:] - csum_amb[:-W]) > 0
        base_sets = {0: "G", 1: "A", 2: "T", 3: "C"}
        code_of = {ch: k for k, ch in enumerate("ACGT")}
        for start in np.nonzero(win_iupac & win_amb)[0]:
            window = data[start:start + W]
            cands = []
            count = 1
            for b in window:
                mask = int(NT4[b])
                opts = [base_sets[k] for k in range(4)
                        if mask & (1 << k)]
                count *= len(opts)
                cands.append(opts)
                if count > cap:
                    break
            if count > cap or count <= 1:
                continue
            words = [0]
            for opts in cands:
                words = [w * self.nsym + code_of[o]
                         for w in words for o in opts]
            for w in words:
                yield int(start), int(w)


def _word_is_valid(match: Match, seq: Sequence, pos: int, length: int
                   ) -> bool:
    """CDS-annotation word veto (ref: Seeder_word_is_valid,
    seeder.c:214-236)."""
    ann = seq.annotation
    if ann is None:
        return True
    if match.type == MatchType.DNA2DNA:
        if (pos + length > ann.cds_start
                and pos < ann.cds_start + ann.cds_length):
            return False
    elif match.type == MatchType.CODON2CODON:
        if (pos < ann.cds_start
                or pos + length >= ann.cds_start + ann.cds_length
                or pos % 3 != ann.cds_start % 3):
            return False
    return True


class Seeder:
    """Multi-query seeding driver (ref: Seeder, seeder.h:158-192)."""

    def __init__(self, comparison_params: dict[str, HspParam],
                 report_func: Callable[[Comparison], None],
                 args: Optional[SeederArgs] = None,
                 wordhoods: Optional[dict] = None,
                 saturate_threshold: int = 0):
        self.args = args or SeederArgs()
        self.report_func = report_func
        # the reference builds ONE FSM over the comparison alphabet for
        # all hsp params; a word of one length that prefixes a word of
        # another length hits the FSM combine func which g_errors
        # (ref: seeder.c:159-163 Seeder_FSM_combine_func).  With real
        # word sets any length mismatch produces such a prefix pair, so
        # mixed word lengths (e.g. genome2genome --dnawordlen 10 with
        # codonwordlen 12) abort up front with the reference's FATAL.
        if len({p.wordlen for p in comparison_params.values()}) > 1:
            import sys as _sys
            _sys.stderr.write("** FATAL ERROR **: Seeder implementation"
                              " assumes words of same length\n"
                              "exiting ...\n")
            raise SystemExit(1)
        self.loaders = {kind: _Loader(p, kind, self.args)
                        for kind, p in comparison_params.items()}
        self.wordhoods = wordhoods or {}
        self.queries: list[Sequence] = []
        self.saturate_threshold = saturate_threshold
        self.total_query_length = 0
        # saturation numbing reshapes the word table deterministically
        # from the add_query stream, so it belongs in the CSR signature
        for loader in self.loaders.values():
            loader._sig = hash((loader._sig, saturate_threshold))

    def _expect(self, loader, length: int) -> int:
        """(ref: Seeder_get_expect, seeder.c:454-459)."""
        w = loader.hsp_param.wordlen
        return int((length - w + 1) / (loader.nsym ** w)
                   + self.saturate_threshold)

    def memory_estimate(self) -> int:
        """Approximate word-table footprint in bytes, the role of the
        reference's FSM/VFSM memory accounting behind --fsmmemory
        (ref: Seeder_memory_info, seeder.h:189-190; the dict-of-lists
        table replaces both FSM layouts, so normal-vs-compact
        --forcefsm is a no-op here beyond this budget)."""
        total = 0
        for loader in self.loaders.values():
            n_words = len(loader.words) + len(loader.neighbours)
            n_refs = sum(len(v) for v in loader.words.values())
            total += n_words * 120 + n_refs * 64
        return total

    def add_query(self, query: Sequence):
        qidx = len(self.queries)
        self.queries.append(query)
        self.total_query_length += len(query)
        for kind, loader in self.loaders.items():
            loader.add_query(qidx, query, loader.hsp_param.match,
                             self.wordhoods.get(kind))
            if self.saturate_threshold:
                # numb saturated query words (ref: seeder.c:93-100)
                expect = self._expect(loader,
                                      self.total_query_length)
                for w, entry in list(loader.words.items()):
                    if len(entry) > expect:
                        loader.words[w] = []

    def add_target(self, target: Sequence):
        # collect seeds per (query, match-class) in emission order, then
        # run each batch through the (native) seeding machine
        batches: dict[tuple[int, str], list] = {}
        active: list[int] = []
        seen: set[int] = set()

        def emit(loader: _Loader, qidx: int, qpos: int, tpos: int):
            # scalar path (ambiguity expansion etc.): plain tuples,
            # converted to arrays once per batch at assembly time
            key = (qidx, loader.kind)
            if key not in batches:
                batches[key] = []
                if qidx not in seen:
                    seen.add(qidx)
                    active.append(qidx)
            batches[key].append((qpos, tpos))

        def emit_batch(loader: _Loader, qidx_arr, qpos_arr, tpos_arr):
            # split one frame's vectorized seed stream by query,
            # preserving per-query emission order and first-encounter
            # query order
            if not len(qidx_arr):
                return
            uniq, first = np.unique(qidx_arr, return_index=True)
            for qidx in uniq[np.argsort(first)]:
                qidx = int(qidx)
                mask = qidx_arr == qidx
                key = (qidx, loader.kind)
                if key not in batches:
                    batches[key] = []
                    if qidx not in seen:
                        seen.add(qidx)
                        active.append(qidx)
                batches[key].append(
                    np.stack([qpos_arr[mask], tpos_arr[mask]], axis=1))

        # scan with each loader (dna first, then protein, then codon —
        # construction order, matching the reference loader order)
        for kind in ("dna", "protein", "codon"):
            loader = self.loaders.get(kind)
            if loader is not None:
                loader.scan_target(target, loader.hsp_param.match, emit,
                                   emit_batch)
        for qidx in active:
            comp = self._make_comparison(self.queries[qidx], target)
            for kind in ("dna", "protein", "codon"):
                seeds = batches.get((qidx, kind))
                if seeds:
                    # chunks are (N,2) arrays from emit_batch and/or
                    # tuples from emit, in emission order
                    parts: list[np.ndarray] = []
                    buf: list[tuple[int, int]] = []
                    for c in seeds:
                        if isinstance(c, tuple):
                            buf.append(c)
                        else:
                            if buf:
                                parts.append(np.asarray(buf, np.int64))
                                buf = []
                            parts.append(c)
                    if buf:
                        parts.append(np.asarray(buf, np.int64))
                    arr = (parts[0] if len(parts) == 1
                           else np.concatenate(parts))
                    getattr(comp, f"{kind}_hspset").seed_batch(arr)
            if comp.has_hsps:
                comp.finalise()
                self.report_func(comp)

    def _make_comparison(self, query: Sequence, target: Sequence
                         ) -> Comparison:
        sets = {}
        for kind, loader in self.loaders.items():
            sets[kind] = HspSet(query, target, loader.hsp_param)
        return Comparison(query, target,
                          dna=sets.get("dna"),
                          protein=sets.get("protein"),
                          codon=sets.get("codon"))


def bigseq_stream_join(hsp_param, query: Sequence, target: Sequence,
                       args: SeederArgs, budget_bytes: int
                       ) -> np.ndarray:
    """Memory-bounded exact-word join for bigseq mode (ref: BSAM +
    DejaVu linear-memory chromosome scanning, src/hub/bsam.c:142-239,
    src/struct/dejavu.c).

    The query's surviving words (word-jump applied) become sorted
    arrays; the target streams through windows sized by the --fsmmemory
    budget, each window's packed words joining by binary search.  Seed
    emission order matches _Loader.scan_target exactly (window/target
    positions ascending, query occurrences LIFO per word), so results
    are byte-identical to the in-memory path at any budget.

    Returns an [N, 2] int64 array of (query_pos, target_pos) seeds.
    """
    match = hsp_param.match
    loader = _Loader(hsp_param, "dna", args)
    W = loader.wordlen
    softmask_q = match.mas.softmask_query
    softmask_t = match.mas.softmask_target
    qpacked, qvalid = loader._pack_valid(query, softmask_q)
    vq = np.nonzero(qvalid)[0]
    if args.word_jump > 1:
        vq = vq[::args.word_jump]
    if query.annotation is not None:
        keep = [p for p in vq
                if _word_is_valid(match, query, int(p), W)]
        vq = np.asarray(keep, dtype=vq.dtype)
    qwords = qpacked[vq]
    order = np.argsort(qwords, kind="stable")
    sw = qwords[order]
    spos = vq[order].astype(np.int64)
    uniq, ustart, ucount = np.unique(sw, return_index=True,
                                     return_counts=True)

    # window length from the budget: ~32 bytes of transient arrays per
    # target symbol in a window
    win = max(W * 4, int(budget_bytes // 32))
    out_q: list[np.ndarray] = []
    out_t: list[np.ndarray] = []
    tlen = len(target)
    start = 0
    while start < tlen:
        stop = min(tlen, start + win)
        sub = target.subseq(start, stop - start)
        tpacked, tvalid = loader._pack_valid(sub, softmask_t)
        # windows advance by win-(W-1) bytes, so packable start
        # positions are contiguous across windows with no duplicates
        hits = np.nonzero(tvalid)[0]
        if len(hits):
            pw = tpacked[hits]
            ix = np.searchsorted(uniq, pw)
            ix[ix >= len(uniq)] = len(uniq) - 1
            m = uniq[ix] == pw
            hits, ix = hits[m], ix[m]
        if len(hits):
            cnt = ucount[ix]
            total = int(cnt.sum())
            # per-hit reversed occurrence indices (LIFO emission,
            # matching the reference's prepend-built seed lists)
            reps = np.repeat(np.arange(len(hits)), cnt)
            offs = np.arange(total) - np.repeat(
                np.concatenate([[0], np.cumsum(cnt)[:-1]]), cnt)
            occ = ustart[ix][reps] + (cnt[reps] - 1 - offs)
            out_q.append(spos[occ])
            out_t.append(np.repeat(
                hits.astype(np.int64) + start, cnt))
        start = stop - (W - 1) if stop < tlen else stop
    if not out_q:
        return np.zeros((0, 2), dtype=np.int64)
    return np.stack([np.concatenate(out_q),
                     np.concatenate(out_t)], axis=1)
