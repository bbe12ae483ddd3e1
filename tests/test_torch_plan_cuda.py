"""The compiled plans of K1/K4 and of the band scan (CPU).

``engine/plan_cuda.py`` writes the tables the launchers build into C++
headers that the kernels compile in; ``csrc/sdp_band.cu`` splits each
comparison's lanes over a thread-block cluster with its carry ring in
shared memory where its fit rule says it fits.  These tests run on the
CPU, without nvcc:

- each generated header, compiled by the host's C++ compiler, holds the
  numbers of the tables ``to_kernel_inputs`` / ``to_band_inputs`` build,
  for every registry model the kernels take (genome2genome is refused);
- the build key changes with the plan;
- the band cluster's shared-memory bytes and cluster shape, from the
  .cu's own ``band_fit`` compiled on the host, are held to a count of
  the ring and span registers;
- a torch-ops emulation of the lane split (C parts, each with its own
  R-slot ring and the H halo lanes copied from its neighbour at the
  start of each diagonal, and the joint spans' curr register crossing a
  part's edge through a halo lane) equals the whole-diagonal plain
  passes, in both passes, on a boundary model, a joint-span model and a
  split-codon model, and over a CROSS chunk pair (K8).

Integers throughout: the tolerance is 0.
"""
import os
import re
import subprocess

import numpy as np
import pytest
import torch

from exonerate_tpu_torch import _cudabuild
from exonerate_tpu_torch.engine import cuda_sdp
from exonerate_tpu_torch.engine import cuda_wavefront as cw
from exonerate_tpu_torch.engine import sdp_device as tsd
from exonerate_tpu_torch.engine import wavefront as twf
from torch_sdp_cases import case as band_case
from torch_twins import PORT

CPU = torch.device("cpu")
CSRC = os.path.join(os.path.dirname(cw.__file__), os.pardir, "csrc")
ALL4 = os.path.join(os.path.dirname(__file__), "golden", "data", "all4.fa")
MODES = ("score", "region", "path")
BAND_CASES = ("single_exon", "two_exons_intron", "ner_joint_span",
              "p2g_split", "c2g_split", "cd2g_split")
# non-boundary plans (TRACK_SID): the reverse pass carries seed ids
NB_BAND_CASES = ("ungapped", "affine_local", "protein2dna", "coding2coding")


def _wave_jobs():
    """(name, model, region, data) of every registry model K1/K4 take,
    on a small pair (the split models on their split pairs)."""
    import torch_split_cases as sc
    calm = next(iter(PORT.iter_fasta(ALL4)))
    dna_q, dna_t = calm.subseq(0, 60), calm.subseq(20, 110)
    pep = PORT.Sequence("p", None, "MADQLTEEQIAEFKEAFSLF")
    jobs = []
    for mt in PORT.ModelType:
        if mt.name == "GENOME2GENOME":
            continue
        if mt.name in ("CODING2GENOME", "CDNA2GENOME"):
            q, t = sc.small_pair("cdna", cuts=sc.C2G_CUTS if mt.name
                                 == "CODING2GENOME" else sc.CUTS)
            qs, ts = PORT.Sequence("q", None, q), PORT.Sequence("t", None, t)
            if mt.name == "CDNA2GENOME":
                qs.annotation = PORT.Annotation(0, len(q))
        elif mt.name.startswith("PROTEIN2"):
            qs, ts = pep, dna_t
        else:
            qs, ts = dna_q, dna_t
        model = PORT.get_model(mt, qs.alphabet.type, ts.alphabet.type)
        jobs.append((mt.name, model, PORT.Region(0, 0, len(qs), len(ts)),
                     PORT.AlignData(qs, ts, PORT.translate_both(mt))))
    return jobs


def _wave_inputs():
    out = []
    for name, model, region, data in _wave_jobs():
        assert cw.unsupported_reason(model) is None, name
        pads = (twf._bucket(region.query_length),
                twf._bucket(region.target_length))
        inputs, kinds = twf.prepare_inputs(model, region, data, pad_to=pads,
                                           for_pallas=True)
        for mode in MODES:
            out.append((f"{name} {mode}",
                        cw.to_kernel_inputs(model, inputs, kinds, CPU, mode)))
    return out


def _band_inputs(name):
    model, pair, plan = band_case(name)
    return cuda_sdp.band_inputs(model, [(pair, plan)], pair.args.dropoff,
                                CPU)


def _dump(tmp_path, headers, body):
    """Compile ``headers`` (each in a namespace h<k>) with ``body``, a C++
    main that prints each one's numbers on a line, and run it."""
    inc = []
    for k, text in enumerate(headers):
        # two plans may be equal, and the compiler then reads a second
        # copy under #pragma once as the first
        (tmp_path / f"h{k}.h").write_text(text.replace("#pragma once\n",
                                                       ""))
        inc.append(f"namespace h{k} {{\n#include \"h{k}.h\"\n}}\n")
    prog = tmp_path / "dump.cpp"
    prog.write_text("#define __host__\n#define __device__\n#include <cstdio>\n"
                    + "".join(inc) + body(len(headers)))
    exe = tmp_path / "dump"
    subprocess.run(["c++", "-std=c++17", "-O0", "-I", str(tmp_path), "-o",
                    str(exe), str(prog)], check=True, capture_output=True,
                   timeout=300)
    out = subprocess.run([str(exe)], capture_output=True, text=True,
                         check=True, timeout=60).stdout.splitlines()
    assert len(out) == len(headers)
    return [list(map(int, ln.split())) for ln in out]


_WAVE_INTS = ("MODE", "S", "L", "NR", "NL", "R", "N_PLAN", "N_SHADOW",
              "START_ID", "END_ID")


def test_wave_headers_hold_the_launchers_tables(tmp_path):
    """Every K1/K4 plan (each registry model the kernels take, in score,
    region and path modes): the header's numbers are the plan table, the
    ring and lane maps and the model numbers that ``to_kernel_inputs``
    passes the launcher."""
    kis = _wave_inputs()
    assert len(kis) == 3 * (len(PORT.ModelType) - 1)

    def body(n):
        ints = " ".join("%d" for _ in _WAVE_INTS)
        fields = ", ".join(f"P::{k}" for k in _WAVE_INTS)
        return ("template <class P> void dump() {\n"
                f"  printf(\"{ints}\", {fields});\n"
                "  for (int r = 0; r < P::N_PLAN; ++r)\n"
                "    for (int c = 0; c < 28; ++c) printf(\" %d\", P::plan(r, c));\n"
                "  for (int s = 0; s < P::S; ++s) printf(\" %d\", P::ring_row(s));\n"
                "  for (int s = 0; s < P::S; ++s)\n"
                "    for (int l = 0; l < (P::L > 0 ? P::L : 1); ++l)\n"
                "      printf(\" %d\", P::lane_row(s, l));\n"
                "  printf(\"\\n\");\n}\nint main() {\n"
                + "".join(f"  dump<h{k}::WavePlan>();\n" for k in range(n))
                + "}\n")

    got = _dump(tmp_path, [ki.header for _, ki in kis], body)
    for (name, ki), line in zip(kis, got):
        want = [{"score": 0, "region": 1, "path": 2}[ki.mode], ki.S, ki.L,
                max(ki.NR, 1), max(ki.NL, 1), ki.K + 1, ki.plan.shape[0],
                ki.n_shadow, ki.start_id, ki.end_id]
        want += ki.plan.flatten().tolist() + ki.ring_row.tolist()
        want += ki.lane_row.flatten().tolist()
        assert line == want, name


_BAND_INTS = ("S", "N_SH", "K", "N_REV", "N_ADV_REV", "N_FWD", "N_ADV_FWD",
              "N_SPANS", "NR_REV", "NR_FWD", "START_ID", "END_ID",
              "ROW_ABS_T", "ROW_EDGE", "ROW_SEG", "TRACK_SID")


def test_band_headers_hold_the_launchers_tables(tmp_path):
    """Every band plan (est2genome, ner, protein2genome, coding2genome,
    cdna2genome: the registry's boundary models; and the non-boundary
    ungapped, affine:local, protein2dna and coding2coding, TRACK_SID
    set and their reverse tables marking the START events): the
    header's numbers are both passes' candidate tables, the span table,
    the ring maps and the numbers ``to_band_inputs`` passes the
    launcher."""
    bis = [(n, _band_inputs(n)) for n in BAND_CASES + NB_BAND_CASES]

    def body(n):
        ints = " ".join("%d" for _ in _BAND_INTS)
        fields = ", ".join(f"P::{k}" for k in _BAND_INTS)
        return ("template <class P> void dump() {\n"
                f"  printf(\"{ints}\", {fields});\n"
                "  for (int r = 0; r < P::N_REV; ++r)\n"
                "    for (int c = 0; c < 27; ++c) printf(\" %d\", P::rev(r, c));\n"
                "  for (int r = 0; r < P::N_FWD; ++r)\n"
                "    for (int c = 0; c < 27; ++c) printf(\" %d\", P::fwd(r, c));\n"
                "  for (int r = 0; r < (P::N_SPANS > 0 ? P::N_SPANS : 1); ++r)\n"
                "    for (int c = 0; c < 4; ++c) printf(\" %d\", P::spans(r, c));\n"
                "  for (int s = 0; s < P::S; ++s) printf(\" %d\", P::rev_ring(s));\n"
                "  for (int s = 0; s < P::S; ++s) printf(\" %d\", P::fwd_ring(s));\n"
                "  printf(\"\\n\");\n}\nint main() {\n"
                + "".join(f"  dump<h{k}::BandPlan>();\n" for k in range(n))
                + "}\n")

    got = _dump(tmp_path, [bi.header for _, bi in bis], body)
    for (name, bi), line in zip(bis, got):
        want = [bi.S, bi.n_sh, bi.K, bi.rev_plan.shape[0], bi.n_adv_rev,
                bi.fwd_plan.shape[0], bi.n_adv_fwd, bi.n_spans,
                max(bi.NR_rev, 1), max(bi.NR_fwd, 1), bi.start_id,
                bi.end_id, bi.row_abs_t, bi.row_edge, bi.row_seg,
                int(bi.track_sid)]
        assert bi.track_sid == (name in NB_BAND_CASES)
        rev_events = bool((bi.rev_plan[:, tsd.BP_FLAGS]
                           & tsd.BF_EVENT).any())
        assert rev_events == bi.track_sid, name
        spans = bi.spans.clone()
        for col in (tsd.SP_MAX_T, tsd.SP_MAX_Q):
            spans[:, col] = spans[:, col] > 0      # the window's length is
        for t in (bi.rev_plan, bi.fwd_plan, spans, bi.rev_ring,   # run-time
                  bi.fwd_ring):
            want += t.flatten().tolist()
        assert line == want, name


def test_band_plan_does_not_depend_on_the_batch():
    """The seed layers' rows come last, a factored calc always ships its
    override row and the spans' windows (--maxintron) are run-time data,
    so the batches of one model share one compiled plan, whatever their
    seed-layer count, pairs and intron window."""
    model, pair, plan = band_case("two_exons_intron")
    other = band_case("single_exon", model=model)[1:]
    drop = pair.args.dropoff
    bis = []
    for jobs, n_layers in (([(pair, plan)], 1), ([(pair, plan)], 3),
                           ([(pair, plan), other], 2)):
        preps = [cuda_sdp.prepare_kernel_inputs(model, p, pl, 256, 1024,
                                                n_layers) for p, pl in jobs]
        bis.append(cuda_sdp.to_band_inputs(
            model, [f for f, _, _ in preps], preps[0][1],
            [m for _, _, m in preps], 256, 1024, drop, CPU))
    assert [bi.n_layers for bi in bis] == [1, 3, 2]
    wide = [sp.max_target for sp in model.spans]
    try:
        for sp in model.spans:                 # a tenth of the window
            sp.max_target //= 10
        bis.append(cuda_sdp.band_inputs(model, [(pair, plan)], drop, CPU))
    finally:
        for sp, w in zip(model.spans, wide):
            sp.max_target = w
    assert not torch.equal(bis[-1].spans, bis[0].spans)
    assert len({bi.header for bi in bis}) == 1
    for bi in bis:
        assert bi.row_seedq == bi.tvecs.shape[1] - 2 * bi.n_layers
        assert bi.row_seedv == bi.row_seedq + bi.n_layers


def test_build_key_changes_with_the_plan():
    """One library per plan: the key covers the header's text, so two
    plans (two modes of one model, two models) get two libraries, and
    the same plan the same one."""
    kis = dict(_wave_inputs())
    a = kis["EST2GENOME score"].header
    b = kis["EST2GENOME region"].header
    c = kis["PROTEIN2GENOME score"].header
    keys = {_cudabuild.key("wavefront", h) for h in (a, b, c)}
    assert len(keys) == 3
    assert _cudabuild.key("wavefront", a) == _cudabuild.key(
        "wavefront", str(a))
    assert _cudabuild.key("wavefront", None) not in keys
    assert _cudabuild.name("wavefront", a) == \
        "wavefront-" + _cudabuild.key("wavefront", a)
    assert _cudabuild.name("wavefront") == "wavefront"
    band = _band_inputs("single_exon").header
    assert _cudabuild.key("sdp_band", band) != _cudabuild.key(
        "sdp_band", _band_inputs("p2g_split").header)


# -- the band cluster's fit rule -----------------------------------------

def _extract(src: str, head: str, tail: str = "\n}") -> str:
    start = src.index(head)
    return src[start:src.index(tail, start) + len(tail)]


def _compiled_fit(tmp_path, sid: bool = False):
    """sdp_band.cu's constants, band_smem_bytes, band_tmax, BandFit and
    band_fit, compiled by the host's C++ compiler into a program that
    reads ``fwd rows B sms cmax S R NR n_sh n_spans H`` lines (with
    ``sid``, one more number: a non-boundary reverse pass) and prints
    ``tmax C T k smem_ring smem``."""
    with open(os.path.join(CSRC, "sdp_band.cu")) as fh:
        src = fh.read()
    consts = "\n".join(re.findall(
        r"^constexpr (?:int|size_t|int32_t) \w+ = [^;]+;", src, re.M))
    parts = [_extract(src, "size_t band_smem_bytes("),
             _extract(src, "constexpr int band_tmax("),
             _extract(src, "struct BandFit {", "\n};"),
             _extract(src, "BandFit band_fit(")]
    n = 12 if sid else 11
    extra = ", sid" if sid else ""
    prog = tmp_path / "fit.cpp"
    prog.write_text(
        "#include <cstdint>\n#include <cstddef>\n#include <cstdio>\n"
        f"{consts}\n" + "\n".join(parts) + "\n"
        "int main() {\n"
        "  int fwd, rows, B, sms, cmax, S, R, NR, n_sh, n_spans, H, sid;\n"
        f"  while (scanf(\"{' '.join(['%d'] * n)}\", &fwd, &rows,"
        " &B, &sms, &cmax, &S, &R, &NR, &n_sh, &n_spans, &H"
        f"{', &sid' if sid else ''}) == {n}) {{\n"
        f"    const int tmax = band_tmax(fwd, S, n_sh{extra});\n"
        "    BandFit f = band_fit(fwd, rows, B, sms, cmax, tmax, R, NR,"
        f" n_sh, n_spans, H{extra});\n"
        "    printf(\"%d %d %d %d %d %zu\\n\", tmax, f.C, f.T, f.k,"
        " f.smem_ring, f.smem);\n"
        "  }\n}\n")
    exe = tmp_path / "fit"
    subprocess.run(["c++", "-std=c++17", "-O1", "-o", str(exe), str(prog)],
                   check=True, capture_output=True, timeout=120)
    return exe


def _pass_numbers(bi, fwd: bool) -> tuple:
    """(S, R, NR, n_sh, n_spans, H) of a pass of ``bi``'s plan, H its
    largest query advance over the advancing candidates."""
    plan = bi.fwd_plan if fwd else bi.rev_plan
    n_adv = bi.n_adv_fwd if fwd else bi.n_adv_rev
    H = int(plan[:n_adv, tsd.BP_AQ].max()) if n_adv else 0
    return (bi.S, bi.K + 1, max(bi.NR_fwd if fwd else bi.NR_rev, 1),
            bi.n_sh, bi.n_spans, H)


def test_band_fit_bytes_and_cluster(tmp_path):
    """The launcher's fit rule (``band_fit``, compiled from the .cu): its
    shared-memory bytes are the ring's R slots of sc, pm and forward lane
    rows over a CTA's lanes and halo, and forward the span registers
    (stored, and curr in two parity buffers with a halo lane), plus the
    block's live/xband words; C and T cover the lanes one lane a thread,
    T a multiple of 32 within the pass's register bound.  At the scans'
    shapes: est2genome's B=16 batch of 1281 lanes takes clusters of 8
    CTAs of 192 threads, its ring in shared memory in both passes, and
    K8's B=1 chunks 16 of 96; coding2genome's forward ring at B=32 is
    over a CTA's shared memory and stays in global memory, its reverse
    ring at B=16 fits."""
    exe = _compiled_fit(tmp_path)
    cases = []
    for name in BAND_CASES:
        bi = _band_inputs(name)
        for fwd in (0, 1):
            for rows, B in ((1281, 16), (1281, 1), (1281, 32), (257, 3),
                            (40000, 1)):
                for cmax in (16, 8):
                    cases.append((name, fwd, rows, B, 132, cmax)
                                 + _pass_numbers(bi, bool(fwd)))
    lines = "".join(" ".join(map(str, c[1:])) + "\n" for c in cases)
    got = subprocess.run([str(exe)], input=lines, capture_output=True,
                         text=True, check=True, timeout=60).stdout.split("\n")
    fit = {}
    for case, line in zip(cases, got):
        name, fwd, rows, B, sms, cmax, S, R, NR, n_sh, n_spans, H = case
        tmax, C, T, k, smem_ring, smem = map(int, line.split())
        assert tmax == (1024 if 2 * S + (fwd and (S + 2) * n_sh) + 48 <= 64
                        else 512 if 2 * S + (fwd and (S + 2) * n_sh) + 48
                        <= 128 else 256)
        assert T % 32 == 0 and 32 <= T <= tmax and 1 <= C <= cmax, case
        assert C * T * k >= rows and (k == 1 or C == cmax), case
        lanes = k * T
        ring = 4 * (R * NR * (2 + (n_sh if fwd else 0)) * (lanes + H)
                    + (n_spans * (4 + n_sh) * (lanes + 2 * (lanes + 1))
                       if fwd else 0))
        assert bool(smem_ring) == (ring + 16 <= 232448), case
        assert smem == (ring if smem_ring else 0) + 16, case
        fit[(name, fwd, rows, B, cmax)] = (C, T, k, smem_ring)
    for fwd in (0, 1):
        assert fit[("two_exons_intron", fwd, 1281, 16, 16)] == (8, 192, 1, 1)
        assert fit[("two_exons_intron", fwd, 1281, 1, 16)] == (16, 96, 1, 1)
        assert fit[("two_exons_intron", fwd, 1281, 1, 8)][:3] == (8, 192, 1)
    assert fit[("c2g_split", 1, 1281, 32, 16)][3] == 0
    assert fit[("c2g_split", 0, 1281, 16, 16)][3] == 1


def test_band_fit_counts_the_seed_id_plane(tmp_path):
    """A non-boundary model's reverse pass (``band_fit``'s ``sid``) keeps
    a seed-id row per ring state beside sc and pm, in shared memory and
    in the halo lanes: its ring holds 3 rows a ring state where the
    boundary plan's reverse ring holds 2, and its register bound counts
    S more ids; its forward pass is the boundary rule's."""
    exe = _compiled_fit(tmp_path, sid=True)
    cases = []
    for name in NB_BAND_CASES:
        bi = _band_inputs(name)
        for fwd in (0, 1):
            for rows, B in ((1281, 16), (257, 3), (40000, 1)):
                cases.append((name, fwd, rows, B, 132, 16)
                             + _pass_numbers(bi, bool(fwd)) + (1 - fwd,))
    lines = "".join(" ".join(map(str, c[1:])) + "\n" for c in cases)
    got = subprocess.run([str(exe)], input=lines, capture_output=True,
                         text=True, check=True, timeout=60).stdout.split("\n")
    for case, line in zip(cases, got):
        name, fwd, rows, B, sms, cmax, S, R, NR, n_sh, n_spans, H, sid = case
        tmax, C, T, k, smem_ring, smem = map(int, line.split())
        regs = 2 * S + sid * (S + 2) + 48
        assert n_sh == 0 and n_spans == 0, case
        assert tmax == (1024 if regs <= 64 else 512 if regs <= 128
                        else 256), case
        assert C * T * k >= rows and T % 32 == 0, case
        ring = 4 * R * NR * (2 + sid) * (k * T + H)
        assert bool(smem_ring) == (ring + 16 <= 232448), case
        assert smem == (ring if smem_ring else 0) + 16, case


# -- the lane split, emulated --------------------------------------------

class LaneSplit:
    """The band kernels' lane split in torch ops: lanes [0, W) cut into
    parts of ``lb`` lanes (part r owns [r*lb, (r+1)*lb)); each part keeps
    an R-slot ring of full-width planes of which only its own lanes and
    its ``halo`` halo lanes (below its first lane forward, above its last
    in reverse) are ever written: its own lanes after each diagonal, the
    halo at the start of the next from the neighbour's own lanes of the
    slot just written.  A ring source at lane i reads part(i)'s ring at
    lane i -/+ aq; a joint span's curr register moves one lane within a
    part, and across a part's first lane from a halo lane copied from the
    neighbour's last lane."""

    def __init__(self, bi, forward: bool, lb: int, halo: int = None):
        plan = bi.fwd_plan if forward else bi.rev_plan
        n_adv = bi.n_adv_fwd if forward else bi.n_adv_rev
        self.H = (int(plan[:n_adv, tsd.BP_AQ].max()) if halo is None
                  else halo)
        self.fwd, self.R, self.S = forward, bi.K + 1, bi.S
        self.n_sh = bi.n_sh if forward else 0
        self.W, B = bi.Qp + 1, bi.batch
        i = torch.arange(self.W)
        self.parts = []
        for r0 in range(0, self.W, lb):
            own = (i >= r0) & (i < r0 + lb)
            halo_m = ((i >= r0 - self.H) & (i < r0) if forward
                      else (i >= r0 + lb) & (i < r0 + lb + self.H))
            self.parts.append((own, halo_m))
        neg = torch.full((B, self.W), tsd.NEG, dtype=torch.int32)
        zero = torch.zeros((B, self.W), dtype=torch.int32)
        blank = ([neg] * self.S, [neg] * self.S,
                 [[zero] * self.n_sh for _ in range(self.S)])
        self.ring = [[blank] * self.R for _ in self.parts]
        self.copies = 0

    def start(self, d: int) -> None:
        e = d - 1 if self.fwd else d + 1
        sl = e % self.R
        for p, (_, halo_m) in enumerate(self.parts):
            q = p - 1 if self.fwd else p + 1
            if not 0 <= q < len(self.parts) or not self.H:
                continue
            mine, theirs = self.ring[p][sl], self.ring[q][sl]
            self.ring[p][sl] = tuple(
                [self._take(halo_m, a, b) for a, b in zip(t, m)]
                for t, m in zip(theirs[:2], mine[:2])) + (
                [[self._take(halo_m, a, b) for a, b in zip(tl, ml)]
                 for tl, ml in zip(theirs[2], mine[2])],)
            self.copies += 1

    @staticmethod
    def _take(mask, new, old):
        return torch.where(mask, new, old)

    def store(self, d: int, sc, pm, ln) -> None:
        sl = d % self.R
        for p, (own, _) in enumerate(self.parts):
            old = self.ring[p][sl]
            self.ring[p][sl] = (
                [self._take(own, a, b) for a, b in zip(sc, old[0])],
                [self._take(own, a, b) for a, b in zip(pm, old[1])],
                [[self._take(own, a, b) for a, b in zip(la, lb)]
                 for la, lb in zip(ln, old[2])] if self.n_sh else old[2])

    def source(self, d: int, adv: int, r: int, k: int):
        sl = (d - adv if self.fwd else d + adv) % self.R
        sc = pm = None
        ln = [None] * self.n_sh
        for p, (own, _) in enumerate(self.parts):
            p_sc, p_pm, p_ln = self.ring[p][sl]
            a = tsd._shift(p_sc[r], k, tsd.NEG)
            b = tsd._shift(p_pm[r], k, tsd.NEG)
            sc = a if sc is None else torch.where(own, a, sc)
            pm = b if pm is None else torch.where(own, b, pm)
            for x in range(self.n_sh):
                v = tsd._shift(p_ln[r][x], k, 0)
                ln[x] = v if ln[x] is None else torch.where(own, v, ln[x])
        return sc, pm, ln

    def shift_curr(self, x, fill):
        out = None
        for own, _ in self.parts:
            first = int(own.nonzero()[0])
            view = torch.where(own, x, fill)
            if first:
                view[..., first - 1] = x[..., first - 1]      # the halo lane
            v = tsd._shift(view, 1, fill)
            out = v if out is None else torch.where(own, v, out)
        return out


def _split_scan(bi, lb, halo=None):
    """Both plain passes with the lane split emulated (LaneSplit of ``lb``
    lanes a part), and the number of halo copies made."""
    rev = LaneSplit(bi, False, lb, halo)
    bits, live_r = tsd.plain_band_reverse(bi, lane_split=rev)
    fwd = LaneSplit(bi, True, lb, halo)
    colbest, live_f, xband = tsd.plain_band_forward(bi, bits, lane_split=fwd)
    return (bits, live_r, colbest, live_f, xband), rev.copies + fwd.copies


@pytest.mark.parametrize("name,lb", [("two_exons_intron", 32),
                                     ("two_exons_intron", 96),
                                     ("ner_joint_span", 32),
                                     ("p2g_split", 64)])
def test_lane_split_equals_the_whole_diagonal(name, lb):
    """C parts of ``lb`` lanes, each reading only its own ring and the
    halo lanes and curr register it copied from its neighbour at the
    start of the diagonal, give the whole-diagonal pass's bits, live,
    column best and xband exactly, in both passes; with a halo one lane
    short the result changes (the copy is what carries the values)."""
    model, pair, plan = band_case(name)
    bi = _band_inputs(name)
    assert bi.Qp + 1 > lb                      # at least two parts
    got, copies = _split_scan(bi, lb)
    assert copies > 0
    bits, live_r = tsd.plain_band_reverse(bi)
    colbest, live_f, xband = tsd.plain_band_forward(bi, bits)
    for a, b in zip(got, (bits, live_r, colbest, live_f, xband)):
        assert torch.equal(a, b)
    if name == "two_exons_intron" and lb == 32:
        short, _ = _split_scan(bi, lb, halo=0)
        assert not all(torch.equal(a, b) for a, b in
                       zip(short, (bits, live_r, colbest, live_f, xband)))


def test_lane_split_over_a_cross_chunk_pair():
    """K8: a comparison cut into two chunks, each chunk's passes run with
    its lanes split in three parts, chained through the halos, equals the
    single whole-diagonal launch."""
    model, pair, plan = band_case("two_exons_intron")
    chunks = cuda_sdp.cross_chunks(model, pair, plan, pair.args.dropoff, 2,
                                   [CPU])
    assert len(chunks) == 2
    lb = 96
    bits = [None, None]
    halo = tsd.blank_halo(chunks[-1][2], False)
    lives = []
    for cx in (1, 0):
        bi = chunks[cx][2]
        bits[cx], live, halo = tsd.plain_band_reverse(
            bi, halo, lane_split=LaneSplit(bi, False, lb))
        lives.append(live)
    halo = tsd.blank_halo(chunks[0][2], True)
    cols, xbs = [], []
    for cx, (v0, v1, bi) in enumerate(chunks):
        col, live, xb, halo = tsd.plain_band_forward(
            bi, bits[cx], halo, lane_split=LaneSplit(bi, True, lb))
        cols.append(col[0, :v1 - v0 + 1])
        lives.append(live)
        xbs.append(xb)
    got = {"band_end": cuda_sdp.locus_best(
        np.concatenate([c.numpy() for c in cols]), plan),
        "live": any(bool(v.any()) for v in lives),
        "xband": any(bool(v.any()) for v in xbs)}
    want = cuda_sdp.run_kernel(model, [(pair, plan)], pair.args.dropoff,
                               CPU)[0]
    np.testing.assert_array_equal(got["band_end"], want["band_end"])
    assert (got["live"], got["xband"]) == (want["live"], want["xband"])
