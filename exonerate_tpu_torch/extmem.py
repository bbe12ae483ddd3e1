"""External-memory sequences: page-cached lazy residue access.

TPU-native equivalent of the reference's EXTMEM sequence storage
(ref: src/sequence/sequence.h:36,111-114 Sequence_create_extmem and the
SparseCache page store, src/general/sparsecache.{h,c}): a Sequence whose
residues are materialized on demand through a loader callback, with an
LRU page cache bounding resident memory.  Two loaders are provided:

- mmap-backed FASTA records (the local chromosome-scale path; the
  reference pages these through FastaDB's SparseCache with 4-bit
  compression, fastadb.h:111 — here the OS page cache does the
  compression's job and the line-aware index does the random access,
  fastadb.h FastaDB_Key offset+len math);
- server-backed windows (client mode fetches "get subseq" windows,
  ref: src/hub/analysis.c:801 Sequence_create_extmem over an
  Analysis_Client SparseCache).

The DP engines receive plain NumPy windows (``subseq`` materializes just
the aligned region before device transfer), so chromosome-scale targets
never need to be host-resident in full.
"""
from __future__ import annotations

import collections
import os
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

PAGE_BITS = 16                    # 64 KiB pages
PAGE = 1 << PAGE_BITS
DEFAULT_CACHE_PAGES = 1024        # 64 MiB resident bound per sequence


class PageCache:
    """LRU page cache over a ``loader(start, length) -> np.uint8[length]``
    (ref: SparseCache, src/general/sparsecache.h:35-75)."""

    def __init__(self, length: int, loader: Callable[[int, int], np.ndarray],
                 max_pages: int = DEFAULT_CACHE_PAGES):
        self.length = length
        self.loader = loader
        self.max_pages = max_pages
        self.pages: "collections.OrderedDict[int, np.ndarray]" = \
            collections.OrderedDict()

    def _page(self, pno: int) -> np.ndarray:
        page = self.pages.get(pno)
        if page is None:
            start = pno << PAGE_BITS
            page = np.asarray(
                self.loader(start, min(PAGE, self.length - start)),
                dtype=np.uint8)
            self.pages[pno] = page
            if len(self.pages) > self.max_pages:
                self.pages.popitem(last=False)
        else:
            self.pages.move_to_end(pno)
        return page

    def read(self, start: int, length: int) -> np.ndarray:
        if length <= 0:
            return np.zeros(0, dtype=np.uint8)
        end = start + length
        first, last = start >> PAGE_BITS, (end - 1) >> PAGE_BITS
        if first == last:
            page = self._page(first)
            off = start - (first << PAGE_BITS)
            return page[off:off + length]
        parts = []
        for pno in range(first, last + 1):
            page = self._page(pno)
            lo = max(start, pno << PAGE_BITS) - (pno << PAGE_BITS)
            hi = min(end, (pno + 1) << PAGE_BITS) - (pno << PAGE_BITS)
            parts.append(page[lo:hi])
        return np.concatenate(parts)


# -- mmap-backed FASTA records ---------------------------------------------

@dataclass
class FastaRecord:
    """Line-aware random-access coordinates of one FASTA record
    (ref: FastaDB_Key, src/database/fastadb.h:130-152)."""
    path: str
    sid: str
    definition: Optional[str]
    data_offset: int          # file offset of the first residue byte
    length: int               # residues
    line_bases: int           # residues per full line (0 = irregular)
    line_bytes: int           # bytes per full line incl. newline


def index_fasta(path: str) -> list[FastaRecord]:
    """One streaming pass building record coordinates without retaining
    residues (ref: FastaDB_traverse building FastaDB_Key entries)."""
    out: list[FastaRecord] = []
    sid = definition = None
    data_offset = 0
    nbases = 0
    line_bases = line_bytes = -1   # -1 = unset, 0 = irregular
    pos = 0

    def flush():
        if sid is not None:
            out.append(FastaRecord(path, sid, definition, data_offset,
                                   nbases, max(line_bases, 0),
                                   max(line_bytes, 0)))

    with open(path, "rb") as fh:
        for raw in fh:
            if raw.startswith(b">"):
                flush()
                header = raw[1:].rstrip(b"\r\n").split(None, 1)
                sid = header[0].decode() if header else ""
                definition = (header[1].decode() if len(header) > 1
                              else None)
                pos += len(raw)
                data_offset = pos
                nbases = 0
                line_bases = line_bytes = -1
                continue
            stripped = raw.rstrip(b"\r\n")
            if sid is not None and stripped:
                if line_bases == -1:
                    line_bases, line_bytes = len(stripped), len(raw)
                elif line_bases and (len(raw) != line_bytes
                                     or len(stripped) > line_bases):
                    # shorter final lines are fine; anything else makes
                    # the record irregular (no random access math)
                    if len(stripped) != len(raw.rstrip(b"\r\n")) \
                            or len(stripped) < line_bases:
                        pass  # candidate final short line; confirmed below
                    else:
                        line_bases = line_bytes = 0
                nbases += len(stripped)
            elif sid is not None and not stripped and nbases:
                # blank line inside a record breaks the line math
                line_bases = line_bytes = 0
            pos += len(raw)
    flush()
    return out


class MmapFastaLoader:
    """Loader over one FASTA file via mmap: strips newlines with the
    line-length math instead of copying the file into memory."""

    def __init__(self, path: str):
        self.mm = np.memmap(path, dtype=np.uint8, mode="r")

    def window(self, rec: FastaRecord, start: int,
               length: int) -> np.ndarray:
        if rec.line_bases <= 0:
            # irregular record: slow path, full scan of the record bytes
            raw = bytes(self.mm[rec.data_offset:])
            data = b"".join(raw.split(b"\n"))[:rec.length]
            return np.frombuffer(data, dtype=np.uint8)[
                start:start + length].copy()
        r0 = start // rec.line_bases
        r1 = (start + length - 1) // rec.line_bases
        lo = rec.data_offset + r0 * rec.line_bytes
        hi = min(rec.data_offset + r1 * rec.line_bytes + rec.line_bytes,
                 len(self.mm))
        block = np.asarray(self.mm[lo:hi])
        nl = rec.line_bytes - rec.line_bases   # newline bytes per line
        nrows = (len(block) + rec.line_bytes - 1) // rec.line_bytes
        pad = nrows * rec.line_bytes - len(block)
        if pad:
            block = np.concatenate(
                [block, np.zeros(pad, dtype=np.uint8)])
        rows = block.reshape(nrows, rec.line_bytes)[:, :rec.line_bases]
        flat = rows.reshape(-1)
        off = start - r0 * rec.line_bases
        out = flat[off:off + length]
        if nl == 0:
            out = out.copy()
        return out


def lazy_sequence(rec: FastaRecord, loader: MmapFastaLoader,
                  alphabet=None, cache_pages: int = DEFAULT_CACHE_PAGES):
    """Build an EXTMEM Sequence over a FASTA record: residues come from
    the page cache; only accessed windows are host-resident."""
    from .seqio import Sequence
    cache = PageCache(rec.length,
                      lambda s, n: loader.window(rec, s, n),
                      max_pages=cache_pages)
    return Sequence.create_lazy(rec.sid, rec.definition, rec.length,
                                cache.read, alphabet)
