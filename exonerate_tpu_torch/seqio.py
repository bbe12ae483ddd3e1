"""Sequence objects and FASTA IO.

TPU-native equivalent of the reference Sequence/FastaDB layer
(ref: src/sequence/sequence.{h,c}, src/database/fastadb.{h,c}).  A Sequence
holds its residues as a NumPy uint8 array (host-side; engines copy slices to
device as needed) and supports the reference's lazy views — subseq, revcomp,
filter, translate — as cheap array transforms.  FastaDB streams multi-file
FASTA inputs with the reference's chunking semantics
(--querychunkid/--querychunktotal, ref: src/database/fastadb.h:72-73).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from .alphabet import (Alphabet, AlphabetType, COMPLEMENT, from_str,
                       guess_type, TO_UPPER)


@dataclass
class Annotation:
    """CDS annotation from an --annotation file
    (ref: src/sequence/sequence.h:49-59)."""
    cds_start: int
    cds_length: int
    strand: str = "+"


class Sequence:
    """A biological sequence (ref: src/sequence/sequence.h:79-145).

    May be EXTMEM-lazy (ref: Sequence_create_extmem, sequence.h:111-114):
    residues then come from a ``loader(start, length)`` callback and the
    full array is materialized only when ``.data`` is first touched;
    ``subseq`` windows read just their range (see extmem.py).
    """

    __slots__ = ("id", "definition", "_data", "_loader", "_length",
                 "alphabet", "strand", "annotation", "head_id",
                 "_revcomp_of", "_ckey")

    def __init__(self, sid: str, definition: Optional[str],
                 data: np.ndarray | str | bytes,
                 alphabet: Optional[Alphabet] = None,
                 strand: str = ".",
                 annotation: Optional[Annotation] = None):
        self.id = sid
        self.definition = definition
        if isinstance(data, (str, bytes)):
            data = from_str(data)
        self._data = np.ascontiguousarray(data, dtype=np.uint8)
        self._loader = None
        self._length = len(self._data)
        if alphabet is None:
            alphabet = Alphabet(guess_type(self._data))
        self.alphabet = alphabet
        self.strand = strand  # '+', '-', '.'
        self.annotation = annotation
        self.head_id = sid  # original id before view transforms
        self._revcomp_of = None
        self._ckey = None

    @classmethod
    def create_lazy(cls, sid: str, definition: Optional[str], length: int,
                    loader, alphabet: Optional[Alphabet] = None,
                    strand: str = ".") -> "Sequence":
        """EXTMEM sequence (ref: sequence.h:111-114)."""
        self = cls.__new__(cls)
        self.id = sid
        self.definition = definition
        self._data = None
        self._loader = loader
        self._length = length
        if alphabet is None:
            probe = loader(0, min(length, 4096))
            alphabet = Alphabet(guess_type(np.asarray(probe,
                                                      dtype=np.uint8)))
        self.alphabet = alphabet
        self.strand = strand
        self.annotation = None
        self.head_id = sid
        self._revcomp_of = None
        self._ckey = None
        return self

    @property
    def data(self) -> np.ndarray:
        if self._data is None:
            self._data = np.ascontiguousarray(
                self._loader(0, self._length), dtype=np.uint8)
        return self._data

    @property
    def is_lazy(self) -> bool:
        return self._data is None

    def __len__(self):
        return self._length

    @property
    def len(self):
        return self._length

    def symbol(self, pos: int) -> int:
        return int(self.data[pos])

    def substr(self, start: int, length: int) -> bytes:
        return self.data[start:start + length].tobytes()

    def __str__(self):
        return self.data.tobytes().decode()

    # -- lazy-equivalent views (ref: sequence.h:34-41) --------------------

    def subseq(self, start: int, length: int) -> "Sequence":
        if self._data is None:
            window = self._loader(start, length)
        else:
            window = self._data[start:start + length]
        s = Sequence(self.id, self.definition, window,
                     self.alphabet, self.strand, self.annotation)
        s.head_id = self.head_id
        return s

    def _revcomp_definition(self) -> str:
        """Reference appends ':[revcomp]' to the definition (or creates a
        bare '[revcomp]' when there is none)
        (ref: src/sequence/sequence.c:397-409 Sequence_revcomp)."""
        if self.definition:
            return f"{self.definition}:[revcomp]"
        return "[revcomp]"

    def revcomp_lazy(self) -> "Sequence":
        """Reverse-complement view of an EXTMEM sequence: windows are
        complemented on read, nothing is materialized (the reference
        layers Sequence_revcomp over extmem the same way)."""
        if self._data is not None:
            return self.revcomp()
        if self._revcomp_of is not None:
            # revcomp(revcomp(s)) unwraps (ref: sequence.c:399-401)
            return self._revcomp_of
        n = self._length
        loader = self._loader

        def rc_loader(start, length):
            raw = loader(n - start - length, length)
            return COMPLEMENT[np.asarray(raw, dtype=np.uint8)[::-1]]

        strand = {"+": "-", "-": "+"}.get(self.strand, "-")
        s = Sequence.create_lazy(self.id, self._revcomp_definition(), n,
                                 rc_loader, self.alphabet, strand)
        s.head_id = self.head_id
        s._revcomp_of = self
        return s

    def revcomp(self) -> "Sequence":
        assert self.alphabet.type != AlphabetType.PROTEIN
        if self._revcomp_of is not None:
            # revcomp(revcomp(s)) returns the shared original
            # (ref: sequence.c:399-401)
            return self._revcomp_of
        strand = {"+": "-", "-": "+"}.get(self.strand, "-")
        ann = self.annotation
        if ann is not None:
            ann = Annotation(len(self.data) - ann.cds_start - ann.cds_length,
                             ann.cds_length, "-" if ann.strand == "+" else "+")
        s = Sequence(self.id, self._revcomp_definition(),
                     COMPLEMENT[self.data[::-1]],
                     self.alphabet, strand, ann)
        s.head_id = self.head_id
        s._revcomp_of = self
        return s

    def upper(self) -> "Sequence":
        s = Sequence(self.id, self.definition, TO_UPPER[self.data],
                     self.alphabet, self.strand, self.annotation)
        s.head_id = self.head_id
        return s

    def translate_view(self, frame: int) -> "Sequence":
        from .translate import default_code
        pep = default_code().translate(self.data, frame)
        s = Sequence(f"{self.id}:[translate({frame})]", self.definition, pep,
                     Alphabet(AlphabetType.PROTEIN), self.strand)
        s.head_id = self.head_id
        return s

    def gcg_checksum(self) -> int:
        """GCG checksum (ref: src/sequence/sequence.c Sequence_checksum)."""
        up = TO_UPPER[self.data].astype(np.int64)
        idx = np.arange(len(up), dtype=np.int64)
        return int(np.sum(((idx % 57) + 1) * up) % 10000)

    def __repr__(self):
        return f"Sequence({self.id!r}, len={len(self.data)})"


def seq_ckey(seq: Sequence) -> tuple:
    """Content identity for cross-run memo keys: (length, head bytes,
    tail bytes, 64-bit content hash).  Every CLI run and every serving
    query re-parses its FASTA into fresh Sequence objects, so
    id()-keyed memos can never hit across runs; keying on the residue
    bytes makes warm processes (bench warm runs, the resident server)
    reuse all derived target-side vectors.  Computed once per object;
    call sites already touch .data, so this adds no lazy
    materialization.  Not cryptographically exact — a 64-bit hash
    collision between same-length sequences sharing 32 boundary bytes
    would alias, which is why the literal head/tail bytes are included
    to rule out the realistic near-miss cases (same file re-read,
    windows of one genome, point mutants near either end are all
    distinguished structurally)."""
    k = seq._ckey
    if k is None:
        d = seq.data
        b = d.tobytes()
        k = (d.shape[0], b[:16], b[-16:], hash(b))
        seq._ckey = k
    return k


# -- FASTA reading ---------------------------------------------------------

# (abspath, mtime_ns, size, alphabet-type) -> [template Sequence]:
# re-parsing the same file every warm run / serving query costs ~40 ms
# per 1 Mb; clones share the immutable residue array (nothing in the
# package writes into Sequence.data) and the cached content key, while
# per-clone attributes (strand, annotation) stay independent
_FASTA_MEMO: dict = {}


def _clone_seq(t: Sequence) -> Sequence:
    s = Sequence.__new__(Sequence)
    s.id = t.id
    s.definition = t.definition
    s._data = t._data
    s._loader = None
    s._length = t._length
    s.alphabet = t.alphabet
    s.strand = t.strand
    s.annotation = t.annotation
    s.head_id = t.head_id
    s._revcomp_of = None
    s._ckey = t._ckey
    return s


# files above this size stream without caching: the memo's value is
# warm re-runs of scan-sized inputs, not pinning whole chromosomes in
# RAM for the process lifetime (FastaDB routes very large files through
# EXTMEM anyway)
_FASTA_MEMO_MAX_BYTES = 64 << 20
# total residue bytes the memo may pin across entries
_FASTA_MEMO_BUDGET = 256 << 20


def _probe_file(path: str) -> tuple:
    """First/last 64 raw bytes — the cheap staleness probe."""
    try:
        with open(path, "rb") as fh:
            head = fh.read(64)
            fh.seek(0, os.SEEK_END)
            size = fh.tell()
            fh.seek(max(0, size - 64))
            tail = fh.read(64)
        return head, tail
    except OSError:
        return None, None


def iter_fasta(path: str, alphabet: Optional[Alphabet] = None
               ) -> Iterator[Sequence]:
    """Stream sequences from one FASTA file."""
    key = None
    try:
        st = os.stat(path)
        if st.st_size <= _FASTA_MEMO_MAX_BYTES:
            key = (os.path.abspath(path), st.st_mtime_ns, st.st_size,
                   alphabet.type if alphabet is not None else None)
    except OSError:
        pass
    if key is not None:
        hit = _FASTA_MEMO.get(key)
        if hit is not None:
            # cheap content probe on hit: a rewrite with identical size
            # inside the filesystem's mtime granularity must not serve
            # stale sequences to a warm process (resident server)
            probe_head, probe_tail, templates = hit
            if (probe_head, probe_tail) == _probe_file(path):
                for t in templates:
                    yield _clone_seq(t)
                return
            del _FASTA_MEMO[key]
    out = [] if key is not None else None
    sid = None
    definition = None
    chunks: list[bytes] = []
    with open(path, "rb") as fh:
        for raw in fh:
            line = raw.rstrip(b"\r\n")
            if line.startswith(b">"):
                if sid is not None:
                    seq = _make_seq(sid, definition, chunks, alphabet)
                    if out is not None:
                        out.append(seq)
                        yield _clone_seq(seq)
                    else:
                        yield seq      # large file: plain streaming
                header = line[1:].split(None, 1)
                sid = header[0].decode() if header else ""
                definition = header[1].decode() if len(header) > 1 else None
                chunks = []
            elif line and sid is not None:
                chunks.append(line)
    if sid is not None:
        seq = _make_seq(sid, definition, chunks, alphabet)
        if out is not None:
            out.append(seq)
            yield _clone_seq(seq)
        else:
            yield seq
    if out is not None:
        for t in out:
            seq_ckey(t)        # hash once; every clone inherits it
        head, tail = _probe_file(path)
        _FASTA_MEMO[key] = (head, tail, out)
        # byte-budget eviction, oldest first (dict preserves insertion
        # order): bounds resident pinning instead of a count clear
        total = sum(len(s.data) for _, _, seqs in _FASTA_MEMO.values()
                    for s in seqs)
        while total > _FASTA_MEMO_BUDGET and len(_FASTA_MEMO) > 1:
            old_key = next(iter(_FASTA_MEMO))
            if old_key == key:
                break
            _, _, seqs = _FASTA_MEMO.pop(old_key)
            total -= sum(len(s.data) for s in seqs)


def _make_seq(sid, definition, chunks, alphabet) -> Sequence:
    data = np.frombuffer(b"".join(chunks), dtype=np.uint8).copy()
    return Sequence(sid, definition, data, alphabet)


def _expand_paths(paths: list[str], suffix: str = ".fa") -> list[str]:
    """Recurse directories collecting files with the --fastasuffix
    (ref: src/database/fastadb.c directory recursion)."""
    out: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, files in sorted(os.walk(p)):
                for f in sorted(files):
                    if f.endswith(suffix):
                        out.append(os.path.join(root, f))
        else:
            out.append(p)
    return out


class FastaDB:
    """A (multi-file) FASTA database with rewind and chunked iteration
    (ref: src/database/fastadb.h:45-128)."""

    # files larger than this iterate as EXTMEM (mmap-backed) sequences
    # (ref: fastadb.h:111 SparseCache paging; here the OS page cache)
    EXTMEM_FILE_BYTES = 256 << 20

    def __init__(self, paths: list[str] | str,
                 alphabet: Optional[Alphabet] = None,
                 suffix: str = ".fa",
                 chunk_id: int = 0, chunk_total: int = 0,
                 extmem: Optional[bool] = None):
        if isinstance(paths, str):
            paths = [paths]
        self.paths = _expand_paths(paths, suffix)
        if not self.paths:
            raise FileNotFoundError(f"no FASTA inputs found in {paths}")
        self.alphabet = alphabet
        self.chunk_id = chunk_id        # 1-based, 0 = no chunking
        self.chunk_total = chunk_total
        self.extmem = extmem            # None = auto by file size

    def _header_offsets(self) -> list[int]:
        """Byte offset of every record header in the concatenated file
        stream (the reference CompoundFile position space)."""
        offs = []
        base = 0
        for path in self.paths:
            with open(path, "rb") as fh:
                pos = 0
                for line in fh:
                    if line.startswith(b">"):
                        offs.append(base + pos)
                    pos += len(line)
            base += os.path.getsize(path)
        return offs

    def _chunk_range(self) -> tuple[int, int]:
        """Byte-granular chunk window snapped to record starts
        (ref: FastaDB_open_list_with_limit, fastadb.c:146-174: chunk
        boundaries are total_bytes/chunk_total, advanced to the next
        "\n>" record start; the final chunk runs to EOF)."""
        total = sum(os.path.getsize(p) for p in self.paths)
        chunk_size = total // self.chunk_total
        offs = self._header_offsets()

        def next_start(pos):
            for o in offs:
                if o >= pos:
                    return o
            return total  # no further record start

        start = next_start((self.chunk_id - 1) * chunk_size)
        if self.chunk_id == self.chunk_total:
            stop = total
        else:
            stop = next_start(self.chunk_id * chunk_size)
        return start, stop

    def __iter__(self) -> Iterator[Sequence]:
        """Iterate sequences, honoring the reference's byte-granular
        chunk limits (ref: exonerate.1:177-204)."""
        if self.chunk_total:
            start, stop = self._chunk_range()
            offs = self._header_offsets()
            k = 0
            for path in self.paths:
                for seq in self._iter_file(path):
                    pos = offs[k]
                    k += 1
                    if start <= pos < stop:
                        yield seq
            return
        for path in self.paths:
            yield from self._iter_file(path)

    def _iter_file(self, path: str) -> Iterator[Sequence]:
        use_extmem = self.extmem
        if use_extmem is None:
            use_extmem = (os.path.getsize(path) > self.EXTMEM_FILE_BYTES)
        if not use_extmem:
            yield from iter_fasta(path, self.alphabet)
            return
        from .extmem import index_fasta, MmapFastaLoader, lazy_sequence
        loader = MmapFastaLoader(path)
        for rec in index_fasta(path):
            yield lazy_sequence(rec, loader, self.alphabet)

    def count(self) -> int:
        c = 0
        for path in self.paths:
            with open(path, "rb") as fh:
                for line in fh:
                    if line.startswith(b">"):
                        c += 1
        return c

    def guess_type(self) -> AlphabetType:
        for seq in self:
            return guess_type(seq.data)
        return AlphabetType.UNKNOWN

    def fetch(self, sid: str) -> Optional[Sequence]:
        for seq in self:
            if seq.id == sid:
                return seq
        return None


def read_fosn(path: str) -> list[str]:
    """Read a file of sequence names / paths (FOSN, ref: analysis.c FOSN
    expansion)."""
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(line)
    return out


def read_annotation_file(path: str) -> dict[str, Annotation]:
    """Parse an --annotation file: lines of `id strand cds_start cds_length`
    or `id cds_start cds_length` (ref: sequence.c annotation registry;
    coordinates are 1-based start in the reference input format)."""
    out: dict[str, Annotation] = {}
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            if len(parts) >= 4 and parts[1] in "+-":
                sid, strand, start, length = (parts[0], parts[1],
                                              int(parts[2]), int(parts[3]))
            elif len(parts) >= 3:
                sid, strand, start, length = (parts[0], "+",
                                              int(parts[1]), int(parts[2]))
            else:
                continue
            out[sid] = Annotation(start - 1, length, strand)
    return out
