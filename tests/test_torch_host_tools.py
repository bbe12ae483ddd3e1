"""The port's host tools, held to the JAX package and to the C binaries.

``exonerate_tpu_torch`` has its own copies of the JAX package's
``cli/ipcress.py`` (in-silico PCR), ``cli/fastautils.py`` (the 24 fasta
utilities, ``fasta2esd`` and ``esd2esi`` among them), ``codonsubmat.py``
and ``model/edit_distance.py``.  On inputs that live in the repo or are
made here from a numpy seed:

- the goldens of ``tests/golden/cases.py`` whose inputs are all in the
  repo (eight utility cases; the ipcress cases read the reference's
  test data) equal ``tests/golden/out/`` through the port;
- ipcress on a seeded 200 kb genome (primer sites on both strands, one
  with a mismatch, two experiments with overlapping length windows)
  under five flag sets: the port, the JAX package and the C
  ``build/ref/bin/ipcress`` print the same bytes;
- each of the 24 utilities on a seeded multi-record DNA file (soft-masked
  runs, Ns, a duplicate record), a protein file and a CDS file: the port
  equals the JAX package (stdout, exit code, written files) and the C
  binary, but where ``CAVEATS`` records that the JAX package differs from
  C (each such case asserts the difference);
- ``fasta2esd`` / ``esd2esi``: the two index formats differ, so what the
  port's server serves from the port's index is held to what the C
  server serves from the C index;
- the edit-distance crib (-23) on the port's reference engine, the codon
  matrix against the JAX package's, and every ``[project.scripts]``
  target of the port.

The C binaries need only libc; a case that needs one fails where it is
absent or not executable.
"""
import glob
import importlib
import io
import os
import re
import subprocess
import sys
import tomllib

import numpy as np
import pytest

from exonerate_tpu_torch.cli import fastautils as port_utils
from exonerate_tpu_torch.cli import ipcress as port_ipcress

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "golden"))
import cases  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_BIN = os.path.join(ROOT, "build", "ref", "bin")
TIMEOUT = 120


def _ref(tool):
    path = os.path.join(REF_BIN, tool)
    assert os.access(path, os.X_OK), f"{path} is absent or not executable"
    return path


def _in_process(main):
    """run_step for a package's fastautils.main: stdout, then the exit
    code where it is not 0 (a SystemExit with a message is 1)."""
    def run_step(tool, argv):
        buf = io.StringIO()
        try:
            rc = main([tool] + list(argv), out=buf)
        except SystemExit as e:
            rc = e.code if isinstance(e.code, int) else 1
        return buf.getvalue() + (f"[exit {rc}]\n" if rc else "")
    return run_step


def _c_step(tool, argv):
    r = subprocess.run([_ref(tool)] + list(argv), capture_output=True,
                       text=True, timeout=TIMEOUT)
    return r.stdout + (f"[exit {r.returncode}]\n" if r.returncode else "")


def _run(steps, run_step, tmpdir):
    os.makedirs(tmpdir, exist_ok=True)
    out = cases.run_script(steps, run_step, tmpdir)
    return cases.normalize(out.replace(tmpdir, "{TMP}"))


# -- the in-repo goldens ------------------------------------------------------

def _in_repo_goldens():
    """The utility goldens whose inputs all lie in the repo (the others
    read the reference's test data, which the repo does not hold)."""
    out = []
    for name, prog, argv in cases.CASES:
        if prog != "script" and prog not in port_utils.TOOLS:
            continue
        paths = [a for step in (argv if prog == "script" else [argv])
                 for a in step if a.startswith("/")]
        if all(os.path.commonpath([ROOT, p]) == ROOT for p in paths):
            out.append(pytest.param(name, prog, argv, id=name))
    return out


GOLDENS = _in_repo_goldens()


def test_eight_goldens_have_their_inputs_in_the_repo():
    assert sorted(p.id for p in GOLDENS) == sorted([
        "util_fastaclean", "util_fastahardmask", "util_fastareformat",
        "util_fastaclip", "util_fastasoftmask", "util_fastasplit3",
        "util_fastaexplode", "util_fastaindex_fetch"])
    for p in GOLDENS:
        name, prog, argv = p.values
        for step in (argv if prog == "script" else [argv]):
            assert all(os.path.exists(a) for a in step
                       if a.startswith("/")), name


@pytest.mark.parametrize("name,prog,argv", GOLDENS)
def test_golden_through_the_port(name, prog, argv, tmp_path):
    if prog == "script":
        got = cases.run_script(argv, _in_process(port_utils.main),
                               str(tmp_path))
    else:
        buf = io.StringIO()
        assert port_utils.main([prog] + list(argv), out=buf) == 0
        got = buf.getvalue()
    with open(os.path.join(cases.OUTDIR, name + ".txt")) as fh:
        assert cases.normalize(got) == fh.read(), name


# -- seeded inputs ------------------------------------------------------------

_BASES = np.frombuffer(b"ACGT", np.uint8)
_AA = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)
_CODONS = [a + b + c for a in "TCAG" for b in "TCAG" for c in "TCAG"]
_CODE = dict(zip(_CODONS, "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRR"
                          "IIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"))
_SENSE = [c for c in _CODONS if _CODE[c] != "*"]


def _write_fasta(path, records, width=60):
    with open(path, "w") as fh:
        for name, seq in records:
            fh.write(f">{name}\n")
            for i in range(0, max(len(seq), 1), width):
                fh.write(seq[i:i + width] + "\n")


def _dna(rng, n):
    return rng.choice(_BASES, n).tobytes().decode()


def _revcomp(s):
    return s[::-1].translate(str.maketrans("ACGTacgtNn", "TGCAtgcaNn"))


def _orf(rng, n):
    return "ATG" + "".join(rng.choice(_SENSE, n)) + "TAA"


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Seeded inputs: d.fa (six DNA records: soft-masked runs, N runs,
    terminal Ns, definitions, r6 a duplicate of r4), hard.fa (d.fa with
    its soft-masked runs as Ns), diff.fa (d.fa with one base changed),
    p.fa (proteins, terminal Xs), cds.fa (two valid CDSs and one of each
    fault), cdna.fa and cdnaprot.fa (CDSs in UTRs and their
    translations), ids (ids to remove)."""
    d = tmp_path_factory.mktemp("inputs")
    rng = np.random.default_rng(13)
    recs = []
    for n in (420, 1333, 77, 900, 2050):
        s = list(_dna(rng, n))
        for _ in range(3):
            a = int(rng.integers(0, n - 30))
            b = a + int(rng.integers(5, 30))
            s[a:b] = [c.lower() for c in s[a:b]]
        a, k = int(rng.integers(0, n - 20)), int(rng.integers(1, 12))
        s[a:a + k] = ["N"] * k
        recs.append("".join(s))
    recs[1] = "NNNnn" + recs[1] + "nnNN"
    recs.append(recs[3])
    names = ["r1 first record", "r2", "r3 short one", "r4", "r5 long",
             "r6 duplicate of r4"]
    _write_fasta(d / "d.fa", zip(names, recs))
    hard = ["".join("N" if c.islower() else c for c in s) for s in recs]
    _write_fasta(d / "hard.fa", zip(names, hard))
    diff = list(recs)
    diff[4] = diff[4][:100] + ("A" if diff[4][100] != "A" else "C") \
        + diff[4][101:]
    _write_fasta(d / "diff.fa", zip(names, diff))
    prots = []
    for k, n in enumerate((150, 333, 64)):
        s = rng.choice(_AA, n).tobytes().decode()
        prots.append((f"prot{k} protein {k}", "XX" + s + "X" if k == 1
                      else s))
    _write_fasta(d / "p.fa", prots)
    good1, good2 = _orf(rng, 80), _orf(rng, 120)
    cds = [("good1", good1), ("good2", good2),
           ("instop", _orf(rng, 14) + "TAG" + _orf(rng, 20)[3:]),
           ("frame", _orf(rng, 40) + "A"),
           ("nostart", "CCC" + _orf(rng, 30)[3:]),
           ("nostop", _orf(rng, 30)[:-3])]
    _write_fasta(d / "cds.fa", cds, width=70)
    _write_fasta(d / "cdna.fa", [
        ("good1", _dna(rng, 50) + good1 + _dna(rng, 70)),
        ("good2", _revcomp(_dna(rng, 31) + good2 + _dna(rng, 40)))])
    _write_fasta(d / "cdnaprot.fa", [
        (f"{k}_p", "".join(_CODE[s[i:i + 3]]
                           for i in range(0, len(s) - 3, 3)))
        for k, s in (("good1", good1), ("good2", good2))])
    (d / "ids").write_text("r2\nr5\n")
    return {p.name: str(p) for p in d.iterdir()}


# (name, steps): the steps of cases.run_script, '{name}' an input of
# the `inputs` fixture, '{TMP}' the case's own directory
UTIL_CASES = [
    ("fastalength", [["fastalength", "{d.fa}"]]),
    ("fastalength_protein", [["fastalength", "{p.fa}"]]),
    ("fastachecksum", [["fastachecksum", "{d.fa}"]]),
    ("fastarevcomp", [["fastarevcomp", "{d.fa}"]]),
    ("fastareformat", [["fastareformat", "{d.fa}"]]),
    ("fastacomposition", [["fastacomposition", "{d.fa}"]]),
    ("fastacomposition_separate", [["fastacomposition", "--separate",
                                    "TRUE", "{p.fa}"]]),
    ("fastaclean", [["fastaclean", "{d.fa}"]]),
    ("fastaclean_protein", [["fastaclean", "--protein", "TRUE",
                             "{p.fa}"]]),
    ("fastahardmask", [["fastahardmask", "{d.fa}"]]),
    ("fastasoftmask", [["fastasoftmask", "{d.fa}", "{hard.fa}"]]),
    ("fastaclip", [["fastaclip", "{d.fa}"]]),
    ("fastaclip_protein", [["fastaclip", "{p.fa}"]]),
    ("fastasubseq", [["fastasubseq", "{d.fa}", "100", "240"]]),
    ("fastatranslate", [["fastatranslate", "{d.fa}"]]),
    ("fastatranslate_frame", [["fastatranslate", "--frame", "2",
                               "{cds.fa}"]]),
    ("fastatranslate_negative_frame", [["fastatranslate", "--frame", "-2",
                                        "{cds.fa}"]]),
    ("fastasort", [["fastasort", "{d.fa}"]]),
    ("fastasort_len", [["fastasort", "--key", "len", "{d.fa}"]]),
    ("fastasplit", [["fastasplit", "-f", "{d.fa}", "-o", "{TMP}",
                     "--chunk", "3"], ["@cat", "{TMP}/*_chunk_*"]]),
    ("fastaexplode", [["fastaexplode", "-f", "{cds.fa}", "-d", "{TMP}"],
                      ["@cat", "{TMP}/*.fa"]]),
    ("fastaremove", [["fastaremove", "{d.fa}", "{ids}"]]),
    ("fastaindex_fetch", [["fastaindex", "{d.fa}", "{TMP}/idx"],
                          ["fastafetch", "{d.fa}", "{TMP}/idx", "r4"],
                          ["fastafetch", "{d.fa}", "{TMP}/idx", "r9"]]),
    ("fastanrdb", [["fastanrdb", "{d.fa}"]]),
    ("fastadiff_same", [["fastadiff", "-c", "FALSE", "{d.fa}",
                         "{d.fa}"]]),
    ("fastadiff_changed", [["fastadiff", "{d.fa}", "{diff.fa}"]]),
    ("fastaoverlap", [["fastaoverlap", "--chunk", "500", "--jump", "300",
                       "{d.fa}"]]),
    ("fastavalidcds", [["fastavalidcds", "{cds.fa}"]]),
    ("fastaannotatecdna", [["fastaannotatecdna", "{cdna.fa}",
                            "{cdnaprot.fa}"]]),
    ("fasta2esd_esd2esi", [["fasta2esd", "{d.fa}", "{TMP}/d.esd"],
                           ["esd2esi", "{TMP}/d.esd", "{TMP}/d.esi"]]),
]


def _clip_caveat(port, c):
    # C clips upper-case Ns only and renames a clipped record
    # <id>:subseq(<start>,<length>)
    assert ">r2:subseq(3,1337)\nnnACTC" in c
    assert ">r2\nACTC" in port
    c_r2, port_r2 = (s.split(">r2")[1].split(">r3")[0] for s in (c, port))
    assert c_r2.endswith("TCGACnn\n") and port_r2.endswith("\nGAC\n")


def _clip_protein_caveat(port, c):
    # C leaves a protein's terminal Xs
    assert ">prot1 protein 1\nXXGLS" in c
    assert ">prot1 protein 1\nGLS" in port and "FWX\n" not in port


def _subseq_caveat(port, c):
    # C prints the first record's subsequence only; the JAX package
    # prints every record's and stops at r3, shorter than 340
    assert c.count(">") == 1 and c.startswith(">r1:subseq(100,240)")
    assert port.startswith(c)
    assert port.count(">") == 2 and port.endswith("[exit 1]\n")


def _negative_frame_caveat(port, c):
    # C's argument parser reads "-2" as a flag and exits 1
    assert c == "[exit 1]\n"
    assert port.count(">") == 6
    assert ">good1 [revcomp]:[translate(2)]" in port


def _overlap_caveat(port, c):
    # C names a chunk of a record longer than the chunk
    # <id>:subseq(<pos>,<length>); the JAX package keeps the id
    assert ">r2:subseq(0,500)" in c and ">r2:subseq(600,500)" in c
    assert ">r2:" not in port
    rename = re.compile(r"^>(\S+):subseq\(\d+,\d+\)", re.M)
    assert rename.sub(r">\1", c) == port


def _esd_caveat(port, c):
    # C writes its messages to stderr, none to stdout
    assert c == ""
    assert port == ("fasta2esd: wrote [{TMP}/d.esd]\n"
                    "esd2esi: wrote [{TMP}/d.esi]\n")


# where the JAX package (and so the port) differs from the C binary:
# each check shows the difference (ROADMAP Queue 3, reference caveats)
CAVEATS = {"fastaclip": _clip_caveat,
           "fastaclip_protein": _clip_protein_caveat,
           "fastasubseq": _subseq_caveat,
           "fastatranslate_negative_frame": _negative_frame_caveat,
           "fastaoverlap": _overlap_caveat,
           "fasta2esd_esd2esi": _esd_caveat}
# the C tools' own index formats differ from the JAX package's
OWN_FORMAT = {"fastaindex_fetch", "fasta2esd_esd2esi"}


def _steps(steps, inputs):
    out = []
    for step in steps:
        argv = []
        for a in step:
            for k, v in inputs.items():
                a = a.replace("{" + k + "}", v)
            argv.append(a)
        out.append(argv)
    return out


def _written(tmpdir):
    """The files a case wrote: names, and contents (npz archives by
    array, since a zip member carries its write time; the directory
    written as {TMP})."""
    out = {}
    for path in sorted(glob.glob(os.path.join(tmpdir, "*"))):
        name = os.path.basename(path)
        if name.endswith(".npz"):
            with np.load(path, allow_pickle=False) as z:
                arrays = {k: z[k].tolist() for k in z.files}
            out[name] = {k: v.replace(tmpdir, "{TMP}")
                         if isinstance(v, str) else v
                         for k, v in arrays.items()}
        else:
            with open(path, "rb") as fh:
                out[name] = fh.read()
    return out


def test_every_utility_has_a_case():
    assert {s[0] for _n, steps in UTIL_CASES for s in steps
            if s[0] != "@cat"} == set(port_utils.TOOLS)
    assert len(port_utils.TOOLS) == 24


@pytest.mark.parametrize("name,steps", UTIL_CASES,
                         ids=[c[0] for c in UTIL_CASES])
def test_utility_equals_jax_and_c(name, steps, inputs, tmp_path):
    from exonerate_tpu.cli import fastautils as jax_utils
    steps = _steps(steps, inputs)
    port_dir, jax_dir, c_dir = (str(tmp_path / s)
                                for s in ("port", "jax", "c"))
    port = _run(steps, _in_process(port_utils.main), port_dir)
    jax = _run(steps, _in_process(jax_utils.main), jax_dir)
    assert port == jax
    assert _written(port_dir) == _written(jax_dir)
    c = _run(steps, _c_step, c_dir)
    if name in CAVEATS:
        assert port != c, f"{name}: the recorded caveat no longer shows"
        CAVEATS[name](port, c)
    else:
        assert port == c
    if name not in OWN_FORMAT:
        assert _written(port_dir) == _written(c_dir)


# -- ipcress on a seeded genome ----------------------------------------------

IPCRESS_FLAGS = [[], ["--mismatch", "1"],
                 ["--products", "TRUE", "--pretty", "FALSE"],
                 ["--seed", "0", "--mismatch", "2"], ["--seed", "6"]]


def _mutate(s, k):
    return s[:k] + {"A": "C", "C": "G", "G": "T", "T": "A"}[s[k]] + s[k + 1:]


@pytest.fixture(scope="module")
def pcr(tmp_path_factory):
    """genome.fa: chr1 (150 kb) and chr2 (50 kb) of seeded DNA with
    products planted for two experiments whose length windows overlap
    (E1 900-1500, E2 1200-2000): forward and revcomp products, a
    single-primer product, a product soft-masked in the file, and two
    products with one mismatch, one inside the 12-base seed and one
    after it."""
    d = tmp_path_factory.mktemp("pcr")
    rng = np.random.default_rng(29)
    a1, b1, a2, b2 = (_dna(rng, n) for n in (20, 22, 18, 20))
    chroms = {"chr1": list(_dna(rng, 150_000)),
              "chr2": list(_dna(rng, 50_000))}

    def plant(chrom, pos, left, right, length, rc=False, soft=False):
        seg = left + _dna(rng, length - len(left) - len(right)) \
            + _revcomp(right)
        seg = _revcomp(seg) if rc else seg
        chroms[chrom][pos:pos + length] = seg.lower() if soft else seg

    plant("chr1", 10_000, a1, b1, 1000)
    plant("chr1", 40_000, a1, b1, 1300, rc=True)
    plant("chr1", 70_000, a1, _mutate(b1, 2), 1100)
    plant("chr1", 100_000, a2, b2, 1400)
    plant("chr1", 120_000, a2, a2, 1700)
    plant("chr1", 130_000, a1, b1, 1450, soft=True)
    plant("chr2", 5_000, a2, b2, 1900, rc=True)
    plant("chr2", 20_000, _mutate(a1, 15), b1, 1200)
    _write_fasta(d / "genome.fa", [("chr1", "".join(chroms["chr1"])),
                                   ("chr2 second chromosome",
                                    "".join(chroms["chr2"]))])
    (d / "exp.ipcress").write_text(f"E1 {a1} {b1} 900 1500\n"
                                   f"E2 {a2} {b2} 1200 2000\n")
    return str(d / "exp.ipcress"), str(d / "genome.fa")


@pytest.mark.parametrize("flags", IPCRESS_FLAGS,
                         ids=[" ".join(f) or "default" for f in IPCRESS_FLAGS])
def test_ipcress_equals_jax_and_c(flags, pcr):
    from exonerate_tpu.cli.ipcress import main as jax_main
    argv = flags + list(pcr)
    outs = []
    for main in (port_ipcress.main, jax_main):
        buf = io.StringIO()
        assert main(list(argv), out=buf) == 0
        outs.append(buf.getvalue())
    r = subprocess.run([_ref("ipcress")] + argv, capture_output=True,
                       text=True, timeout=TIMEOUT)
    assert r.returncode == 0, r.stderr[-500:]
    assert outs[0] == outs[1]
    assert outs[0] == r.stdout
    kinds = [ln.split()[-1] for ln in outs[0].splitlines()
             if ln.startswith("ipcress:")]
    assert len(kinds) == (8 if "--mismatch" in flags else 6)
    assert {"forward", "revcomp", "single_A"} <= set(kinds), kinds


def test_port_index_serves_what_the_c_index_serves(inputs, tmp_path):
    """The port's fasta2esd / esd2esi build d.fa's index, and the port's
    server serves it; C's build theirs, and C's exonerate-server serves
    it.  The replies about the database, its sequences and a query's
    HSPs agree."""
    from test_torch_server import _free_port, _serve, _session, _wait_port
    from exonerate_tpu_torch.cli.server import ExonerateServer
    from exonerate_tpu_torch.db.index import Index
    from exonerate_tpu_torch.seqio import iter_fasta
    fa = inputs["d.fa"]
    c_esd, c_esi = str(tmp_path / "c.esd"), str(tmp_path / "c.esi")
    for tool, argv in (("fasta2esd", [fa, c_esd]),
                       ("esd2esi", [c_esd, c_esi])):
        subprocess.run([_ref(tool)] + argv, check=True, capture_output=True,
                       timeout=TIMEOUT)
    esd, esi = str(tmp_path / "p.esd"), str(tmp_path / "p.esi")
    for argv in (["fasta2esd", fa, esd], ["esd2esi", esd, esi]):
        assert port_utils.main(argv, out=io.StringIO()) == 0
    seqs = [s.data.tobytes().decode().upper()
            for s in iter_fasta(fa)]
    cmds = (["dbinfo"] + [f"get info {k}" for k in range(6)]
            + [f"lookup r{k}" for k in range(1, 7)]
            + ["get seq 2", "get subseq 1 10 20", "get subseq 4 0 30",
               "set query " + seqs[4][100:600], "get hsps",
               "set query " + seqs[3][200:500], "get hsps"])
    port = _free_port()
    proc = subprocess.Popen([_ref("exonerate-server"), c_esi, "--port",
                             str(port)], stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    try:
        _wait_port(port)
        want = _session(port, cmds)
    finally:
        proc.kill()
        proc.wait()
    index = Index(esi)
    srv = ExonerateServer(index.dataset, index, 0)
    try:
        got = _session(_serve(srv), cmds)
    finally:
        srv.shutdown()
    assert got == want
    hsps = [r for c, r in zip(cmds, got) if c == "get hsps"]
    # r5's stretch, and r4's found in r4 and its duplicate r6
    assert hsps == ["hspset: 4 0 100 500\n",
                    "linecount: 3\nhspset: 3 0 200 300\n"
                    "hspset: 5 0 200 300\n"]


# -- the edit-distance model, the codon matrix, the console scripts -----------

def test_edit_distance_crib():
    # ref: src/model/edit_distance.test.c:21-52 (score == -23)
    from exonerate_tpu_torch.alphabet import Alphabet, AlphabetType
    from exonerate_tpu_torch.engine import reference
    from exonerate_tpu_torch.engine.region import Region
    from exonerate_tpu_torch.model.data import AlignData
    from exonerate_tpu_torch.model.edit_distance import edit_distance_create
    from exonerate_tpu_torch.seqio import Sequence
    alpha = Alphabet(AlphabetType.DNA)
    q = Sequence("qy", None,
                 "gtgcactacgtacgtnatcgtgcttnaacgcg"
                 "tacgtgatngtgcttgaacgtacgtacgtgatcg"
                 "tgcttga", alpha)
    t = Sequence("tg", None,
                 "actacgtacgtgatcgtgcaacgcactacg"
                 "tacgtgancttgaacgcactacgtacgtgatcg"
                 "tgcntgaacgn", alpha)
    model = edit_distance_create()
    data = AlignData(q, t)
    region = Region(0, 0, len(q), len(t))
    assert reference.find_score(model, region, data) == -23
    res = reference.find_path(model, region, data)
    assert res.score == -23
    assert (res.query_start, res.target_start) == (0, 0)
    assert (res.query_end, res.target_end) == (len(q), len(t))


def test_codon_matrix_equals_the_jax_package():
    from exonerate_tpu.codonsubmat import CodonSubmat as JaxCodonSubmat
    from exonerate_tpu_torch.codonsubmat import CODON_DIM, CodonSubmat
    port, jax = CodonSubmat(), JaxCodonSubmat()
    assert port.matrix.shape == (CODON_DIM, CODON_DIM) == (125, 125)
    np.testing.assert_array_equal(port.matrix, jax.matrix)
    np.testing.assert_array_equal(port.codon_aa, jax.codon_aa)
    assert port.lookup_base(*b"ATGTGG") == jax.lookup_base(*b"ATGTGG")
    assert port.max_score() == jax.max_score()


def _scripts():
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as fh:
        return tomllib.load(fh)["project"]["scripts"]


PORT_SCRIPTS = {"exonerate-torch": "exonerate_tpu_torch.cli.exonerate:main",
                "exonerate-server-torch":
                    "exonerate_tpu_torch.cli.server:main",
                "ipcress-torch": "exonerate_tpu_torch.cli.ipcress:main",
                "fastautils-torch": "exonerate_tpu_torch.cli.fastautils:main"}


def test_the_port_has_its_console_scripts():
    scripts = _scripts()
    port = {k: v for k, v in scripts.items()
            if v.startswith("exonerate_tpu_torch.")}
    assert port == PORT_SCRIPTS
    # the JAX package keeps its 28 names
    assert len(scripts) == 28 + len(PORT_SCRIPTS)
    assert all(v.startswith("exonerate_tpu.") for k, v in scripts.items()
               if k not in PORT_SCRIPTS)


@pytest.mark.parametrize("name", sorted(PORT_SCRIPTS))
def test_console_script_resolves_to_a_callable(name):
    module, attr = _scripts()[name].split(":")
    assert callable(getattr(importlib.import_module(module), attr))
