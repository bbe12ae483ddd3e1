"""The fasta* utility suite (ref: src/util/, doc/man/man1/fastautils.1).

All 24 reference utilities as subcommands of one dispatcher:
`python -m exonerate_tpu_torch.cli.fastautils <tool> [options] [files]`
(each is also callable as exonerate_tpu_torch.cli.fastautils.<tool>_main).
"""
from __future__ import annotations

import os
import sys

import numpy as np

from ..alphabet import (Alphabet, AlphabetType, COMPLEMENT, IS_SOFTMASKED,
                        TO_LOWER, TO_UPPER)
from ..seqio import FastaDB, Sequence, iter_fasta
from ..translate import default_code
from . import args as A


def write_fasta(seq: Sequence, out, width: int = 70):
    """(ref: Sequence_print_fasta + _print_fasta_block,
    sequence.c:287-343)."""
    header = ">" + seq.id
    if seq.definition:
        header += " " + seq.definition
    out.write(header + "\n")
    s = seq.data.tobytes().decode()
    for i in range(0, max(len(s), 1), width):
        out.write(s[i:i + width] + "\n")


def _simple_parser(prog, desc, extra=()):
    p = A.ArgumentParser(prog, desc)
    aset = A.ArgumentSet("Sequence Input Options")
    aset.add("f", "fasta", "path", "Fasta input file", None,
             A.parse_string, "fasta")
    for opt in extra:
        aset.add(*opt)
    p.add_set(aset)
    return p


def _input_paths(v):
    paths = []
    if v.get("fasta"):
        paths.append(v["fasta"])
    paths.extend(v.get("_positional", []))
    if not paths:
        raise SystemExit("no fasta input specified")
    return paths


# -- the utilities ---------------------------------------------------------

def fastalength_main(argv, out):
    v = _simple_parser("fastalength",
                       "A utility to report fasta sequence lengths"
                       ).parse(argv)
    for seq in FastaDB(_input_paths(v)):
        out.write(f"{len(seq)} {seq.id}\n")


def fastachecksum_main(argv, out):
    v = _simple_parser("fastachecksum",
                       "A utility to report GCG checksums").parse(argv)
    for seq in FastaDB(_input_paths(v)):
        out.write(f"{seq.gcg_checksum()} {len(seq)} {seq.id}\n")


def fastarevcomp_main(argv, out):
    v = _simple_parser("fastarevcomp",
                       "A utility to reverse complement fasta files"
                       ).parse(argv)
    for seq in FastaDB(_input_paths(v)):
        rc = seq.revcomp()
        rc.id = seq.id
        # def suffix convention (ref: sequence.c:407-409)
        rc.definition = ((seq.definition + ":[revcomp]")
                         if seq.definition else "[revcomp]")
        write_fasta(rc, out)


def fastareformat_main(argv, out):
    v = _simple_parser("fastareformat",
                       "A utility to reformat fasta files").parse(argv)
    for seq in FastaDB(_input_paths(v)):
        write_fasta(seq, out)


def fastalength_counts(path):
    return [(len(s), s.id) for s in iter_fasta(path)]


def fastacomposition_main(argv, out):
    v = _simple_parser(
        "fastacomposition", "A utility to report sequence composition",
        extra=[("i", "ignorecase", None, "Ignore sequence case", "FALSE",
                A.parse_boolean, "ignorecase"),
               ("s", "separate", None,
                "Report composition for each sequence separately",
                "FALSE", A.parse_boolean, "separate")]).parse(argv)
    paths = _input_paths(v)

    def report(name, count):
        out.write(name)
        if v["ignorecase"]:
            merged = count.copy()
            for c in range(ord("A"), ord("Z") + 1):
                merged[c + 32] += merged[c]
            for i in range(256):
                if count[i] and not (ord("A") <= i <= ord("Z")):
                    out.write(f" {chr(i)} {merged[i]}")
        else:
            for i in range(256):
                if count[i]:
                    out.write(f" {chr(i)} {count[i]}")
        out.write("\n")

    total = np.zeros(256, dtype=np.int64)
    for seq in FastaDB(paths):
        c = np.bincount(seq.data, minlength=256).astype(np.int64)
        if v["separate"]:
            report(seq.id, c)
        else:
            total += c
    if not v["separate"]:
        report(paths[0], total)


def fastaclean_main(argv, out):
    """Replace non-alphabet symbols (ref: src/util/fastaclean.c): DNA
    non-ACGTN -> N (with --acgtn, amb codes too); protein invalid -> X."""
    v = _simple_parser(
        "fastaclean", "A utility to clean fasta format file symbols",
        extra=[("p", "protein", None, "Clean protein database", "FALSE",
                A.parse_boolean, "protein"),
               ("a", "acgtn", None, "Only allow [ACGTN] symbols", "FALSE",
                A.parse_boolean, "acgtn")]).parse(argv)
    from ..alphabet import IS_PROTEIN, IS_DNA, IS_DNA_CORE
    # id rename convention (ref: sequence.c:453-460 Sequence_filter,
    # filter names from alphabet.c Alphabet_Filter_Type_get_name)
    fname = "clean_acgtn" if v["acgtn"] else "clean"
    for seq in FastaDB(_input_paths(v)):
        data = seq.data.copy()
        lower = IS_SOFTMASKED[data]
        if v["protein"]:
            bad = ~IS_PROTEIN[data]
            data[bad & ~lower] = ord("X")
            data[bad & lower] = ord("x")
        else:
            bad = ~(IS_DNA_CORE if v["acgtn"] else IS_DNA)[data]
            data[bad & ~lower] = ord("N")
            data[bad & lower] = ord("n")
        write_fasta(Sequence(f"{seq.id}:filter({fname})", seq.definition,
                             data, seq.alphabet), out)


def fastahardmask_main(argv, out):
    """Apply the alphabet's MASKED filter (ref: src/util/fastahardmask.c).

    Reference quirk preserved for byte parity: fastahardmask opens its
    FastaDB with a non-softmasked alphabet, whose MASKED filter is plain
    TO_UPPER (alphabet.c Alphabet_create: masked=TO_UPPER unless
    is_soft_masked) — so the output is simply uppercased, never
    N-masked.  The id gains the :filter(masked) rename
    (sequence.c:453-460)."""
    v = _simple_parser("fastahardmask",
                       "A utility to convert soft masked sequence to hard"
                       " masked").parse(argv)
    for seq in FastaDB(_input_paths(v)):
        data = TO_UPPER[seq.data]
        write_fasta(Sequence(f"{seq.id}:filter(masked)", seq.definition,
                             data, seq.alphabet), out)


def fastasoftmask_main(argv, out):
    """Transfer masking from a hardmasked copy onto the unmasked file
    (ref: src/util/fastasoftmask.c)."""
    p = A.ArgumentParser("fastasoftmask",
                         "A utility to add softmasking")
    aset = A.ArgumentSet("Sequence Input Options")
    aset.add("u", "unmasked", "path", "Unmasked sequence input file",
             None, A.parse_string, "unmasked")
    aset.add("m", "masked", "path", "Hardmasked sequence input file",
             None, A.parse_string, "masked")
    p.add_set(aset)
    v = p.parse(argv)
    pos = v.get("_positional", [])
    unmasked_path = v["unmasked"] or (pos[0] if pos else None)
    masked_path = v["masked"] or (pos[1] if len(pos) > 1 else None)
    masked = {s.id: s for s in iter_fasta(masked_path)}
    for seq in iter_fasta(unmasked_path):
        m = masked.get(seq.id)
        if m is None or len(m) != len(seq):
            raise SystemExit(
                f"fastasoftmask: no matching masked sequence for "
                f"[{seq.id}]")
        # bug-for-bug with the reference (fastasoftmask.c:28-43):
        # fasta_softmask_merge binds ms=get_str(UNMASKED) and
        # us=get_str(MASKED) — names swapped — so the emitted sequence
        # is the MASKED string, lowercased only where the UNMASKED one
        # has N/n/X/x.  (Its own test can't tell: hardmasking either
        # semantics reproduces the masked file.)
        um = seq.data
        data = m.data.copy()
        swap = ((um == ord("N")) | (um == ord("n"))
                | (um == ord("X")) | (um == ord("x")))
        data[swap] = TO_LOWER[data[swap]]
        write_fasta(Sequence(seq.id, seq.definition, data, seq.alphabet),
                    out)


def fastaclip_main(argv, out):
    """Clip terminal Ns (ref: src/util/fastaclip.c)."""
    v = _simple_parser("fastaclip", "A utility to clip fasta sequences",
                       ).parse(argv)
    for seq in FastaDB(_input_paths(v)):
        is_protein = seq.alphabet.type == AlphabetType.PROTEIN
        mc = ord("X") if is_protein else ord("N")
        data = seq.data
        up = TO_UPPER[data]
        keep = up != mc
        if keep.any():
            lo = int(np.argmax(keep))
            hi = len(data) - int(np.argmax(keep[::-1]))
            clipped = data[lo:hi]
        else:
            clipped = data[:0]
        write_fasta(Sequence(seq.id, seq.definition, clipped,
                             seq.alphabet), out)


def fastasubseq_main(argv, out):
    v = _simple_parser(
        "fastasubseq", "A utility to extract subsequences",
        extra=[("s", "start", "start", "Subsequence start", None,
                A.parse_int, "start"),
               ("l", "length", "length", "Subsequence length", None,
                A.parse_int, "length")]).parse(argv)
    # mandatory options fill from positionals in registration order
    # (ref: argument.c positional shorthand; fastasubseq.c f/s/l)
    pos = list(v.get("_positional", []))
    path = v.get("fasta") or (pos.pop(0) if pos else None)
    start = v.get("start") if v.get("start") is not None else (
        int(pos.pop(0)) if pos else 0)
    length = v.get("length") if v.get("length") is not None else (
        int(pos.pop(0)) if pos else -1)
    if path is None:
        raise SystemExit("no fasta input specified")
    for seq in FastaDB([path]):
        n = length if length >= 0 else len(seq) - start
        if start + n > len(seq):
            raise SystemExit("fastasubseq: subseq outside sequence")
        sub = seq.subseq(start, n)
        sub.id = f"{seq.id}:subseq({start},{n})"
        write_fasta(sub, out)


def fastatranslate_main(argv, out):
    """(ref: src/util/fastatranslate.c): translate in all 6 frames, or
    one with --frame."""
    v = _simple_parser(
        "fastatranslate", "A utility to translate fasta files",
        extra=[("F", "frame", "frame", "Reading frame [1|2|3|-1|-2|-3|0]",
                "0", A.parse_int, "frame"),
               ("g", "geneticcode", None, "Genetic code id", "1",
                A.parse_string, "geneticcode")]).parse(argv)
    from ..translate import GeneticCode
    code = GeneticCode(v["geneticcode"])
    # all-frames order is -3,-2,-1,1,2,3 (ref: fastatranslate.c:24-30);
    # id stays, def gains :[revcomp] / :[translate(n)] suffixes
    # (ref: sequence.c:407-409,527-529)
    frames = ([v["frame"]] if v["frame"]
              else [-3, -2, -1, 1, 2, 3])
    for seq in FastaDB(_input_paths(v)):
        for frame in frames:
            pep = code.translate(seq.data, frame)
            d = seq.definition
            if frame < 0:
                d = (d + ":[revcomp]") if d else "[revcomp]"
            n = abs(frame)
            d = (d + f":[translate({n})]") if d else f"[translate({n})]"
            tr = Sequence(seq.id, d, pep, Alphabet(AlphabetType.PROTEIN))
            write_fasta(tr, out)


def fastasort_main(argv, out):
    v = _simple_parser(
        "fastasort", "A utility to sort fasta files",
        extra=[("k", "key", "id | len | seq", "Sort key", "id",
                A.parse_string, "key"),
               ("r", "reverse", None, "Reverse sort order", "FALSE",
                A.parse_boolean, "reverse"),
               ("c", "check", None, "Just check order", "FALSE",
                A.parse_boolean, "check")]).parse(argv)
    seqs = list(FastaDB(_input_paths(v)))
    keyfn = {"id": lambda s: s.id,
             "len": lambda s: len(s),
             "seq": lambda s: s.data.tobytes()}[v["key"]]
    if v["check"]:
        for a, b in zip(seqs, seqs[1:]):
            ka, kb = keyfn(a), keyfn(b)
            bad = ka > kb if not v["reverse"] else ka < kb
            if bad:
                out.write("File is not sorted: "
                          f"{v['key']} [{ka}] followed by [{kb}]\n")
                raise SystemExit(1)
        out.write("File is sorted\n")
        return
    seqs.sort(key=keyfn, reverse=v["reverse"])
    for seq in seqs:
        write_fasta(seq, out)


def fastasplit_main(argv, out):
    """(ref: src/util/fastasplit.c): split into c chunk files."""
    v = _simple_parser(
        "fastasplit", "A utility to split fasta files",
        extra=[("o", "output", "dirpath", "Output directory", ".",
                A.parse_string, "output"),
               ("c", "chunk", None, "Number of chunks", "2",
                A.parse_int, "chunk")]).parse(argv)
    paths = _input_paths(v)
    nchunk = v["chunk"]
    stem = os.path.join(v["output"], os.path.basename(paths[0]))
    # RAW byte-range chunking (ref: fasta_split, fastasplit.c:44-66):
    # boundaries at the next sequence start at/after i*(size/chunks),
    # chunk files copy the original bytes verbatim (no reformatting);
    # empty chunks are not written
    with open(paths[0], "rb") as fh:
        data = fh.read()
    total = len(data)
    chunk_size = total // nchunk

    def next_start(p):
        # the next line-initial '>' at/after p (FastaDB_find_next_start,
        # fastadb.c:241-252)
        prev = b"\n"
        while p < total:
            ch = data[p:p + 1]
            if ch == b">" and prev == b"\n":
                return p
            prev = ch
            p += 1
        return total

    bounds = [0]
    for i in range(1, nchunk):
        bounds.append(next_start(i * chunk_size))
    bounds.append(total)
    for i in range(nchunk):
        if bounds[i] == bounds[i + 1]:
            continue
        with open(f"{stem}_chunk_{i:07d}", "wb") as fh:
            fh.write(data[bounds[i]:bounds[i + 1]])


def fastaexplode_main(argv, out):
    v = _simple_parser(
        "fastaexplode", "A utility to explode fasta files",
        extra=[("d", "directory", "path", "Output directory", ".",
                A.parse_string, "directory")]).parse(argv)
    for seq in FastaDB(_input_paths(v)):
        # raw id as filename (ref: fastaexplode.c:23-25 — the C tool
        # concatenates the id verbatim and g_errors if it exists)
        path = os.path.join(v["directory"], seq.id + ".fa")
        if os.path.exists(path):
            raise SystemExit(f"File [{path}] already exists")
        with open(path, "w") as fh:
            write_fasta(seq, fh)


def fastaremove_main(argv, out):
    v = _simple_parser(
        "fastaremove", "A utility to remove fasta sequences",
        extra=[("r", "remove", "path | id", "ids to remove", None,
                A.parse_string, "remove")]).parse(argv)
    remove = set()
    spec = v["remove"]
    pos = list(v.get("_positional", []))
    if spec is None and pos:
        # positional shorthand: <fasta> <removal-list>
        spec = pos.pop()
        v = dict(v)
        v["_positional"] = pos
    if spec:
        if os.path.exists(spec):
            with open(spec) as fh:
                remove = {ln.strip() for ln in fh if ln.strip()}
        else:
            remove = {spec}
    for seq in FastaDB(_input_paths(v)):
        if seq.id not in remove:
            write_fasta(seq, out)


def fastafetch_main(argv, out):
    v = _simple_parser(
        "fastafetch", "A utility to fetch fasta sequences",
        extra=[("i", "index", "path", "Index file", None,
                A.parse_string, "index"),
               ("F", "fosn", None, "Query is a file of sequence names",
                "FALSE", A.parse_boolean, "fosn"),
               ("q", "query", "name", "Identifier to fetch", None,
                A.parse_string, "queryname")]).parse(argv)
    pos = v.get("_positional", [])
    fasta = v["fasta"] or (pos[0] if pos else None)
    query = v["queryname"] or (pos[2] if len(pos) > 2 else
                               (pos[1] if len(pos) > 1 else None))
    wanted = []
    if v["fosn"] and query and os.path.exists(query):
        with open(query) as fh:
            wanted = [ln.strip() for ln in fh if ln.strip()]
    elif query:
        wanted = [query]
    found = set()
    for seq in FastaDB([fasta]):
        if seq.id in wanted:
            write_fasta(seq, out)
            found.add(seq.id)
    missing = [w for w in wanted if w not in found]
    if missing:
        raise SystemExit(
            f"Could not find identifier [{missing[0]}] (missing -F ?)")


def fastaindex_main(argv, out):
    """(ref: src/util/fastaindex.c): id -> file offset index."""
    v = _simple_parser(
        "fastaindex", "A utility to index fasta files",
        extra=[("i", "index", "path", "Index output file", None,
                A.parse_string, "index")]).parse(argv)
    pos = v.get("_positional", [])
    fasta = v["fasta"] or (pos[0] if pos else None)
    index_path = v["index"] or (pos[1] if len(pos) > 1 else None)
    with open(index_path, "w") as fh, open(fasta, "rb") as src:
        offset = 0
        for raw in src:
            if raw.startswith(b">"):
                sid = raw[1:].split()[0].decode()
                fh.write(f"{sid} {offset}\n")
            offset += len(raw)


def fastanrdb_main(argv, out):
    """Non-redundant database: merge identical sequences, ids joined on
    the defline (ref: src/util/fastanrdb.c)."""
    v = _simple_parser(
        "fastanrdb", "A utility to create non-redundant fasta databases",
        extra=[("i", "ignorecase", None, "Ignore sequence case", "FALSE",
                A.parse_boolean, "ignorecase"),
               ("r", "revcomp", None, "Also compare revcomp sequences",
                "FALSE", A.parse_boolean, "revcomp")]).parse(argv)
    def norm(data):
        return (TO_UPPER[data] if v["ignorecase"] else data).tobytes()

    # entry = (seq, is_revcomp); with -r a revcomp twin is added unless
    # palindromic (ref: fastanrdb.c:69-90)
    entries: list[tuple[Sequence, bool]] = []
    for seq in FastaDB(_input_paths(v)):
        entries.append((seq, False))
        if v["revcomp"]:
            rc = seq.revcomp()
            rc.id = seq.id
            if norm(rc.data) != norm(seq.data):
                entries.append((rc, True))

    # stable sort by GCG checksum, group adjacent equal sequences
    # (ref: NRDB_Data_sort_checksum_function + merge scan)
    entries.sort(key=lambda e: e[0].gcg_checksum())
    used = [False] * len(entries)
    for i, (sa, _) in enumerate(entries):
        if used[i]:
            continue
        group = [entries[i]]
        used[i] = True
        for j in range(i + 1, len(entries)):
            sb = entries[j][0]
            if sb.gcg_checksum() != sa.gcg_checksum():
                break
            if used[j] or len(sb) != len(sa):
                continue
            if norm(sb.data) == norm(sa.data):
                group.append(entries[j])
                used[j] = True
        # report (ref: NRDB_Data_report_redundant_set): first forward
        # member leads; suppressed when revcomp copies dominate
        forward = [s for s, isrc in group if not isrc]
        reverse = [s for s, isrc in group if isrc]
        if not forward or len(forward) < len(reverse):
            continue
        leader, rest = forward[0], forward[1:]
        merged = "".join(" " + s.id for s in rest)
        merged += "".join(" " + s.id + ".revcomp" for s in reverse)
        out.write(">" + leader.id + " " + merged + "\n")
        s = leader.data.tobytes().decode()
        for k in range(0, max(len(s), 1), 70):
            out.write(s[k:k + 70] + "\n")


def fastadiff_main(argv, out):
    v = _simple_parser(
        "fastadiff", "A utility to compare fasta files",
        extra=[("1", "first", "path", "First input file", None,
                A.parse_string, "first"),
               ("2", "second", "path", "Second input file", None,
                A.parse_string, "second"),
               ("i", "ignorecase", None, "Ignore sequence case", "FALSE",
                A.parse_boolean, "ignorecase"),
               ("c", "checkids", None, "Check sequence ids match",
                "TRUE", A.parse_boolean, "checkids")]).parse(argv)
    pos = v.get("_positional", [])
    p1 = v["first"] or (pos[0] if pos else None)
    p2 = v["second"] or (pos[1] if len(pos) > 1 else None)
    a = list(iter_fasta(p1))
    b = list(iter_fasta(p2))
    ok = True
    if len(a) != len(b):
        out.write(f"fastadiff: different sequence counts: "
                  f"{len(a)} {len(b)}\n")
        ok = False
    for sa, sb in zip(a, b):
        if v["checkids"] and sa.id != sb.id:
            out.write(f"fastadiff: id mismatch: {sa.id} {sb.id}\n")
            ok = False
            break
        if len(sa) != len(sb):
            out.write(f"fastadiff: length mismatch: {sa.id}({len(sa)}) "
                      f"{sb.id}({len(sb)})\n")
            ok = False
            break
        da, db = sa.data, sb.data
        if v["ignorecase"]:
            da, db = TO_UPPER[da], TO_UPPER[db]
        if not np.array_equal(da, db):
            out.write(f"fastadiff: sequence mismatch: {sa.id} {sb.id}\n")
            ok = False
            break
    if not ok:
        raise SystemExit(1)


def fastaoverlap_main(argv, out):
    """Overlapping chunks (ref: src/util/fastaoverlap.c)."""
    v = _simple_parser(
        "fastaoverlap", "A utility to generate overlapping chunks",
        extra=[("c", "chunk", None, "Chunk size", "100000",
                A.parse_int, "chunk"),
               ("j", "jump", None, "Jump between chunks", "50000",
                A.parse_int, "jump")]).parse(argv)
    for seq in FastaDB(_input_paths(v)):
        pos = 0
        while pos < len(seq):
            ln = min(v["chunk"], len(seq) - pos)
            sub = seq.subseq(pos, ln)
            write_fasta(sub, out)
            if pos + ln >= len(seq):
                break
            pos += v["jump"]


def fastavalidcds_main(argv, out):
    """Filter sequences with a valid CDS (start codon, no internal stop,
    terminal stop, length %3 == 0; ref: src/util/fastavalidcds.c)."""
    v = _simple_parser(
        "fastavalidcds", "A utility to check for valid CDSs",
        extra=[("e", "explain", None, "Explain invalid CDSs", "FALSE",
                A.parse_boolean, "explain")]).parse(argv)
    code = default_code()
    for seq in FastaDB(_input_paths(v)):
        reason = None
        if len(seq) % 3:
            reason = "length not a multiple of 3"
        else:
            pep = code.translate(seq.data, 1)
            s = pep.tobytes().decode()
            if not s:
                reason = "empty"
            elif s[0] != "M":
                reason = "no initial methionine"
            elif "*" in s[:-1]:
                reason = "internal stop codon"
            elif not s.endswith("*"):
                reason = "no terminal stop codon"
        if reason is None:
            write_fasta(seq, out)
        elif v["explain"]:
            out.write(f"# invalid CDS [{seq.id}]: {reason}\n")


def fastaannotatecdna_main(argv, out):
    """Locate each protein's CDS in its cDNA and print annotation lines
    (ref: src/util/fastaannotatecdna.c)."""
    p = A.ArgumentParser("fastaannotatecdna",
                         "A utility to annotate cdna with CDS info")
    aset = A.ArgumentSet("Sequence Input Options")
    aset.add("c", "cdna", "path", "cDNA fasta file", None,
             A.parse_string, "cdna")
    aset.add("p", "protein", "path", "Protein fasta file", None,
             A.parse_string, "protein")
    p.add_set(aset)
    v = p.parse(argv)
    pos = v.get("_positional", [])
    cdna_path = v["cdna"] or (pos[0] if pos else None)
    protein_path = v["protein"] or (pos[1] if len(pos) > 1 else None)
    code = default_code()
    cdnas = list(iter_fasta(cdna_path))
    proteins = list(iter_fasta(protein_path))
    # sequences pair positionally (ref: fastaannotatecdna.c:58-62)
    for n, cdna in enumerate(cdnas):
        if n >= len(proteins):
            out.write(f"ERROR: fastaannotatecdna: {protein_path}: "
                      f"protein: {cdna.id} is absent\n")
            return
        prot = proteins[n]
        pep = str(prot)
        if len(prot) * 3 > len(cdna):
            out.write(f"ERROR: fastaannoatecdna: protein [{prot.id}]"
                      f"({len(prot)}) too long for cdna [{cdna.id}]"
                      f"({len(cdna)})\n")
        total = 0

        def find(seq, strand_char):
            nonlocal total
            for frame in (1, 2, 3):
                tr = code.translate(seq.data, frame).tobytes().decode()
                start = tr.find(pep)
                while start != -1:
                    out.write(f"annotation: {seq.id} {strand_char} "
                              f"{start * 3 + frame} {len(pep) * 3}\n")
                    total += 1
                    start = tr.find(pep, start + 1)

        # FastaDB sequences are forward-strand in the reference
        # (Sequence_get_strand_as_char prints '+'/'-')
        find(cdna, "+")
        rc = cdna.revcomp()
        find(rc, "-")
        if total != 1:
            out.write(f"ERROR: fastaannoatecdna: Found {total} "
                      f"locations for protein [{prot.id}] in "
                      f"[{cdna.id}]\n")
            return
    if len(proteins) > len(cdnas):
        out.write(f"ERROR: fastaannoatecdna: {cdna_path}: cdna: "
                  f"{proteins[len(cdnas)].id} absent\n")


def fasta2esd_main(argv, out):
    from ..db.dataset import dataset_build
    v = _simple_parser(
        "fasta2esd", "A utility to build an exonerate sequence database",
        extra=[("o", "output", "path", "Output esd file", None,
                A.parse_string, "output"),
               ("s", "softmask", None, "Store sequences with softmasking",
                "TRUE", A.parse_boolean, "softmask")]).parse(argv)
    pos = v.get("_positional", [])
    fasta = v["fasta"] or (pos[0] if pos else None)
    output = v["output"] or (pos[1] if len(pos) > 1 else None)
    dataset_build([fasta], output, softmask=v["softmask"])
    out.write(f"fasta2esd: wrote [{output}]\n")


def esd2esi_main(argv, out):
    from ..db.index import index_build
    v = _simple_parser(
        "esd2esi", "A utility to build an exonerate sequence index",
        extra=[("o", "output", "path", "Output esi file", None,
                A.parse_string, "output"),
               (None, "wordlen", "length", "Word length", "12",
                A.parse_int, "wordlen"),
               (None, "translate", None, "Translate the database (6 frame)",
                "FALSE", A.parse_boolean, "translate"),
               (None, "saturatethreshold", "n",
                "Word saturation threshold", "10",
                A.parse_int, "saturatethreshold"),
               (None, "wordjump", "n", "Jump between database words",
                "1", A.parse_int, "wordjump"),
               (None, "memorylimit", "Mb", "Memory limit", "1024",
                A.parse_int, "memorylimit")]).parse(argv)
    pos = v.get("_positional", [])
    esd = (v["fasta"] or (pos[0] if pos else None))
    output = v["output"] or (pos[1] if len(pos) > 1 else None)
    index_build(esd, output, wordlen=v["wordlen"],
                translated=v["translate"],
                saturate_threshold=v["saturatethreshold"],
                word_jump=v["wordjump"])
    out.write(f"esd2esi: wrote [{output}]\n")


TOOLS = {
    "fastalength": fastalength_main,
    "fastachecksum": fastachecksum_main,
    "fastarevcomp": fastarevcomp_main,
    "fastareformat": fastareformat_main,
    "fastacomposition": fastacomposition_main,
    "fastaclean": fastaclean_main,
    "fastahardmask": fastahardmask_main,
    "fastasoftmask": fastasoftmask_main,
    "fastaclip": fastaclip_main,
    "fastasubseq": fastasubseq_main,
    "fastatranslate": fastatranslate_main,
    "fastasort": fastasort_main,
    "fastasplit": fastasplit_main,
    "fastaexplode": fastaexplode_main,
    "fastaremove": fastaremove_main,
    "fastafetch": fastafetch_main,
    "fastaindex": fastaindex_main,
    "fastanrdb": fastanrdb_main,
    "fastadiff": fastadiff_main,
    "fastaoverlap": fastaoverlap_main,
    "fastavalidcds": fastavalidcds_main,
    "fastaannotatecdna": fastaannotatecdna_main,
    "fasta2esd": fasta2esd_main,
    "esd2esi": esd2esi_main,
}


def main(argv=None, out=None):
    argv = argv if argv is not None else sys.argv[1:]
    out = out or sys.stdout
    if not argv or argv[0] not in TOOLS:
        avail = ", ".join(sorted(TOOLS))
        sys.stderr.write(f"usage: fastautils <tool> [options]\n"
                         f"tools: {avail}\n")
        return 1
    TOOLS[argv[0]](argv[1:], out)
    return 0


def entry():
    """Console-script entry: the installed script's own name selects the
    tool (the reference installs each fasta* utility as its own binary,
    ref: src/util/Makefile.am)."""
    import os
    tool = os.path.basename(sys.argv[0])
    if tool not in TOOLS:
        return main()
    return main([tool] + sys.argv[1:])


if __name__ == "__main__":
    sys.exit(main())
