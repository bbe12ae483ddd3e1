"""On-disk word indexes (.esi equivalent).

TPU-native redesign of the reference Index (ref: src/database/
index.{h,c}): per-strand word tables (packed word -> postings offset/count)
and postings (sequence id, position) as flat sorted numpy arrays.  Lookup
is a vectorized searchsorted join — the structure doubles as the on-device
index for sharded genome serving (SURVEY.md §2.13: the client/server
"get hsps" redesigned as device arrays + collectives).
Built by esd2esi; queried by Index.get_hsps (the server's seed RPC).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..seqio import Sequence
from ..seeds.seeder import member_codes, DNA_MEMBERS, PROTEIN_MEMBERS
from .dataset import Dataset

MAGIC = "exonerate-tpu-esi-v1"


def _pack_words(data: np.ndarray, codes: np.ndarray, W: int, nsym: int):
    n = len(data)
    if n < W:
        return (np.zeros(0, dtype=np.int64), np.zeros(0, dtype=bool))
    code = codes[data]
    valid_sym = code >= 0
    csum = np.concatenate([[0], np.cumsum(~valid_sym)])
    win_valid = (csum[W:] - csum[:-W]) == 0
    packed = np.zeros(n - W + 1, dtype=np.int64)
    safe = np.where(valid_sym, code, 0)
    for k in range(W):
        packed = packed * nsym + safe[k:n - W + 1 + k]
    return packed, win_valid


def index_build(esd_path: str, out_path: str, wordlen: int = 12,
                translated: bool = False, saturate_threshold: int = 10,
                word_jump: int = 1):
    """Build the word index over a Dataset.  With translated=True the
    six-frame translations are indexed (protein-vs-DNA serving,
    ref: index.h:55-147).

    saturate_threshold: words occurring >= (observed/alphabet^wordlen)
    + threshold times ON A STRAND are removed entirely — the esd2esi
    default is 10 (ref: Index_desaturate, index.c:352-381;
    esd2esi.c:55-57).  Our single table serves both strands (revcomp'd
    queries look up their complement words), which removes exactly the
    same postings per strand as the reference's per-strand tables.
    word_jump: index every Nth word position (ref: esd2esi --wordjump)."""
    ds = Dataset(esd_path)
    codes = member_codes(translated)
    nsym = len(PROTEIN_MEMBERS if translated else DNA_MEMBERS)
    words_all = []
    seq_ids = []
    positions = []
    from ..alphabet import IS_SOFTMASKED
    for i in range(len(ds)):
        seq = ds.get_sequence(i)
        # the reference indexes the MASKED view of every dataset
        # sequence (Sequence_mask, ref: index.c:309): softmasked
        # (lowercase) symbols become non-members so no word containing
        # them is ever posted
        sm = IS_SOFTMASKED[seq.data]
        if sm.any():
            seq = Sequence(seq.id, seq.definition,
                           np.where(sm, np.uint8(ord("N")), seq.data),
                           seq.alphabet, seq.strand)
        if translated:
            from ..translate import default_code
            for frame in (1, 2, 3, -1, -2, -3):
                pep = default_code().translate(seq.data, frame)
                packed, valid = _pack_words(pep, codes, wordlen, nsym)
                pos = np.nonzero(valid)[0]
                if len(pos):
                    words_all.append(packed[pos])
                    seq_ids.append(np.full(len(pos), i, dtype=np.int32))
                    # store frame-encoded positions: pos*8 + (frame+3)
                    positions.append((pos * 8 + (frame + 3)).astype(
                        np.int64))
        else:
            packed, valid = _pack_words(seq.data, codes, wordlen, nsym)
            pos = np.nonzero(valid)[0]
            if len(pos):
                words_all.append(packed[pos])
                seq_ids.append(np.full(len(pos), i, dtype=np.int32))
                positions.append(pos.astype(np.int64))
    if words_all:
        words = np.concatenate(words_all)
        sids = np.concatenate(seq_ids)
        poss = np.concatenate(positions)
    else:
        words = np.zeros(0, dtype=np.int64)
        sids = np.zeros(0, dtype=np.int32)
        poss = np.zeros(0, dtype=np.int64)
    if word_jump > 1 and len(poss):
        keep = ((poss >> 3) if translated else poss) % word_jump == 0
        words, sids, poss = words[keep], sids[keep], poss[keep]
    if saturate_threshold and len(words):
        # desaturate per strand (ref: Index_desaturate, index.c:364-381;
        # expect formula index.c:352-360).  Untranslated postings are
        # forward-strand only and the revcomp lookup goes through the
        # complement word, so per-table counts ARE the per-strand counts;
        # translated postings carry the strand in the frame sign.
        if translated:
            # frame encoded as frame+3: {4,5,6} forward, {0,1,2} revcomp
            strand = np.where((poss & 7) >= 4, 1, 0).astype(np.int8)
        else:
            strand = np.zeros(len(words), dtype=np.int8)
        keep = np.ones(len(words), dtype=bool)
        for s in np.unique(strand):
            sel = strand == s
            observed = int(sel.sum())
            expect = int(observed / float(nsym ** wordlen)
                         + saturate_threshold)
            uw, inv, cnt = np.unique(words[sel], return_inverse=True,
                                     return_counts=True)
            bad = cnt >= expect
            ksel = ~bad[inv]
            keep[np.nonzero(sel)[0][~ksel]] = False
        words, sids, poss = words[keep], sids[keep], poss[keep]
    order = np.lexsort((poss, sids, words))
    words, sids, poss = words[order], sids[order], poss[order]
    uniq, starts, counts = np.unique(words, return_index=True,
                                     return_counts=True)
    np.savez_compressed(
        out_path,
        magic=np.array(MAGIC),
        esd_path=np.array(esd_path),
        wordlen=np.int64(wordlen),
        translated=np.array(translated),
        word_table=uniq,
        word_starts=starts.astype(np.int64),
        word_counts=counts.astype(np.int64),
        post_seq=sids,
        post_pos=poss)


class Index:
    """(ref: Index, index.h:37-147)."""

    def __init__(self, path: str, dataset: Optional[Dataset] = None):
        try:
            self._z = np.load(path, allow_pickle=False)
        except Exception:
            self._z = np.load(path + ".npz", allow_pickle=False)
        assert str(self._z["magic"]) == MAGIC, "bad esi file"
        self.wordlen = int(self._z["wordlen"])
        self.translated = bool(self._z["translated"])
        self.word_table = self._z["word_table"]
        self.word_starts = self._z["word_starts"]
        self.word_counts = self._z["word_counts"]
        self.post_seq = self._z["post_seq"]
        self.post_pos = self._z["post_pos"]
        self.dataset = dataset or Dataset(str(self._z["esd_path"]))
        self.codes = member_codes(self.translated)
        self.nsym = len(PROTEIN_MEMBERS if self.translated
                        else DNA_MEMBERS)

    def lookup_word(self, packed: int) -> tuple[np.ndarray, np.ndarray]:
        ix = np.searchsorted(self.word_table, packed)
        if ix >= len(self.word_table) or self.word_table[ix] != packed:
            return (np.zeros(0, dtype=np.int32),
                    np.zeros(0, dtype=np.int64))
        s = int(self.word_starts[ix])
        c = int(self.word_counts[ix])
        return self.post_seq[s:s + c], self.post_pos[s:s + c]

    def _decode_translated(self, sids: np.ndarray, poss: np.ndarray,
                           revcomp_target: bool):
        """Frame-encoded postings (pep_pos*8 + frame+3) -> DNA positions
        on the requested strand (ref: index.c:215-216: per-strand
        postings store pep_pos*3 + frame-1 in strand-local DNA coords;
        our single table encodes the strand in the frame sign)."""
        frame = (poss & 7).astype(np.int64) - 3
        pep = poss >> 3
        if revcomp_target:
            sel = frame < 0
            dna = pep * 3 + (-frame) - 1
        else:
            sel = frame > 0
            dna = pep * 3 + frame - 1
        return sids[sel], dna[sel]

    def get_hsp_seeds(self, query: Sequence, wordhood=None,
                      revcomp_target: bool = False,
                      intervals=None, device_index=None
                      ) -> dict[int, list[tuple[int, int]]]:
        """All (query_pos, target_pos) seed pairs per target sequence —
        the server's `get hsps` payload (ref: Index_get_HSPsets,
        index.h:140-147; protocol exonerate-server.c:315-378).

        Translated indexes serve protein queries against the six-frame
        postings: target positions decode to DNA coordinates on the
        requested strand (revcomp positions are strand-local, matching
        the seeding against the revcomp'd target sequence).
        `intervals`: optional {target_id: [(start, len)]} restriction
        (the two-tier geneseed subseed lookup, ref: index.c:1006-1100
        Index_Address_list_refine).

        `device_index`: optional db.device_index.DeviceIndex — the
        whole query's word lookups batch into ONE sharded collective
        gather on the mesh instead of per-word host scans; iteration
        order (and therefore every output byte) is identical."""
        packed, valid = _pack_words(query.data, self.codes, self.wordlen,
                                    self.nsym)
        qw: list[tuple[int, int]] = []
        for qpos in np.nonzero(valid)[0]:
            wlist = [int(packed[qpos])]
            if wordhood is not None:
                wlist = wordhood.neighbours(wlist[0])
            for w in wlist:
                qw.append((int(qpos), int(w)))
        out: dict[int, list[tuple[int, int]]] = {}
        if device_index is not None and qw:
            words = np.asarray([w for _, w in qw],
                               dtype=self.word_table.dtype)
            word_of, sids_all, poss_all = \
                device_index.lookup_words(words)
            bounds = np.searchsorted(word_of, np.arange(len(qw) + 1))
            for k, (qpos, _w) in enumerate(qw):
                self._bin_seeds(out, qpos,
                                sids_all[bounds[k]:bounds[k + 1]],
                                poss_all[bounds[k]:bounds[k + 1]],
                                revcomp_target, intervals)
        elif qw:
            # one vectorized searchsorted join for the whole query
            # (a 1.2 kb query probes ~2.4k words; per-word lookups were
            # ~1.5 s of a 16-query serving stream)
            words = np.asarray([w for _, w in qw],
                               dtype=self.word_table.dtype)
            nt = len(self.word_table)
            if nt:
                ix = np.searchsorted(self.word_table, words)
                ixc = np.minimum(ix, nt - 1)
                found = self.word_table[ixc] == words
                starts = self.word_starts[ixc]
                counts = self.word_counts[ixc]
                for k, (qpos, _w) in enumerate(qw):
                    if not found[k]:
                        continue
                    s = int(starts[k])
                    c = int(counts[k])
                    self._bin_seeds(out, qpos, self.post_seq[s:s + c],
                                    self.post_pos[s:s + c],
                                    revcomp_target, intervals)
        # order = (query word, posting) append order, matching the C
        # server's per-target bins (ref: index.c:1358-1366); the page
        # binning in the qy_sorted seeding then fixes emission order
        return out

    def _bin_seeds(self, out, qpos, sids, poss, revcomp_target,
                   intervals):
        if self.translated:
            sids, poss = self._decode_translated(sids, poss,
                                                 revcomp_target)
        for sid, tpos in zip(sids, poss):
            if intervals is not None:
                spans = intervals.get(int(sid))
                if not spans or not any(
                        s <= tpos < s + ln for s, ln in spans):
                    continue
            out.setdefault(int(sid), []).append((int(qpos), int(tpos)))


def qy_page_order(seed_pairs: list, qadv: int, tadv: int,
                  tlen: int) -> list:
    """Reorder (qpos, tpos) seeds exactly as HSPset_seed_all_qy_sorted
    visits them (ref: hspset.c:1263-1310): the C server prepends seeds
    into per-target bins (reversing append order), then bins by
    1024-wide diagonal-section pages with another prepend; pages emit in
    first-touch order of the reversed list, seeds within a page in
    original append order."""
    PAGE_BITS = 10  # HSPset_SList_PAGE_BIT_WIDTH, hspset.c:1240
    pages: dict[int, list[int]] = {}
    page_order: list[int] = []
    for i in range(len(seed_pairs) - 1, -1, -1):
        q, t = seed_pairs[i]
        diag = t * qadv - q * tadv
        sect = (diag + tlen) % tlen
        p = sect >> PAGE_BITS
        if p not in pages:
            pages[p] = []
            page_order.append(p)
        pages[p].append(i)
    out: list = []
    for p in page_order:
        out.extend(seed_pairs[i] for i in reversed(pages[p]))
    return out
