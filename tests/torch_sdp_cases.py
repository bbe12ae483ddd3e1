"""Synthetic seeded comparisons for the band scan, shared by
``tests/test_torch_sdp.py`` and ``chip_smoke.py``.

Each case is a small query/target pair with hand-placed HSPs, built into
an ``SDPPair`` and its band plan as the SDP tests of the JAX package
build them (``tests/test_sdp_pallas.py``).  ``case(name)`` returns
``(model, pair, plan)``, built from the port's own host layer;
``case(name, pkg="exonerate_tpu")`` builds the same case from the JAX
package (the two packages share no objects).  Every case has its own
seed.  The split-codon cases (``SPLIT_CASES``) cut their exons like
``torch_split_cases``, so that their best paths cross a phase-1 and a
phase-2 split codon.  ``NB_CASES`` are the non-boundary models (the
reverse pass attributes start scores to seeds), after the JAX package's
own cases (``tests/test_sdp_device.py``), with one pair whose two seeds
share a cell.
"""
import importlib
from types import SimpleNamespace

import numpy as np

import torch_split_cases as sc

PORT = "exonerate_tpu_torch"
_AAS = list("ACDEFGHIKLMNPQRSTVWY")


def _ns(pkg: str) -> SimpleNamespace:
    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")
    return SimpleNamespace(
        AlphabetType=mod("alphabet").AlphabetType,
        sdp_bands=mod("engine.sdp_bands"), SDPPair=mod("engine.sdp").SDPPair,
        SdpArgs=mod("engine.sdp").SdpArgs, AlignData=mod("model.data").AlignData,
        ModelType=mod("model.registry").ModelType,
        get_model=mod("model.registry").get_model,
        translate_both=mod("model.registry").translate_both,
        Sequence=mod("seqio").Sequence, Annotation=mod("seqio").Annotation)


def dna(rng, n):
    return "".join("ACGT"[k] for k in rng.integers(0, 4, n))


def mutate(rng, s, n):
    s = list(s)
    for _ in range(n):
        s[rng.integers(0, len(s))] = "ACGT"[rng.integers(0, 4)]
    return "".join(s)


def pair_and_plan(mtname, q, t, hsp_list, margin=64, qt="DD", model=None,
                  qadv=1, tadv=1, cds=None, share=False, pkg=PORT):
    """(model, pair, plan) of q against t with the given HSPs
    (query_start, target_start, length, score; lengths in advances of
    ``qadv`` / ``tadv``).  ``qt`` names the alphabets (D = DNA, P =
    protein); ``cds`` (start, length) annotates the query's CDS.  With
    ``share``, a last seed joins the first at its cell with half its
    score (the HSP seeds of a comparison never share a cell: the device
    scan must still take the cell's largest half score and its largest
    seed index)."""
    X = _ns(pkg)
    alpha = {"D": X.AlphabetType.DNA, "P": X.AlphabetType.PROTEIN}
    mt = X.ModelType[mtname]
    model = model or X.get_model(mt, alpha[qt[0]], alpha[qt[1]])
    qs, ts = X.Sequence("q", None, q), X.Sequence("t", None, t)
    if cds is not None:
        qs.annotation = X.Annotation(*cds)
    data = X.AlignData(qs, ts, X.translate_both(mt))
    hl = [SimpleNamespace(query_start=a, target_start=b, length=c,
                          score=d, cobs=c // 2)
          for (a, b, c, d) in hsp_list]
    hs = SimpleNamespace(qadv=qadv, tadv=tadv, hsps=hl)
    comp = SimpleNamespace(query=qs, target=ts, hspsets=lambda: [hs])
    pair = X.SDPPair(model, comp, data, None, X.SdpArgs())
    if share:
        seeds = [(s.q_cobs, s.t_cobs, s.hsp_score, s.hsp) for s in pair.seeds]
        q0, t0, score, hsp = seeds[0]
        pair = X.SDPPair(model, comp, data, None, X.SdpArgs(),
                         seeds_override=seeds + [(q0, t0, score // 2, hsp)])
    pair._find_starts()
    pair._find_ends()
    extents = [(s.hsp.target_start, s.hsp.target_start + s.hsp.length * tadv)
               for s in pair.seeds]
    sw = max((sp.max_target for sp in model.spans), default=0)
    plan = X.sdp_bands.plan_bands(extents, len(q), len(t), margin=margin,
                                  span_window=sw + 2 * margin)
    return model, pair, plan


def _single_exon(rng):
    cdna = dna(rng, 120)
    t = dna(rng, 200) + cdna + dna(rng, 200)
    return "EST2GENOME", mutate(rng, cdna, 6), t, [(30, 230, 40, 60)], {}


def _two_exons(rng):
    ex1, ex2 = dna(rng, 90), dna(rng, 90)
    intron = "GT" + dna(rng, 96) + "AG"
    t = dna(rng, 100) + ex1 + intron + ex2 + dna(rng, 100)
    return ("EST2GENOME", mutate(rng, ex1 + ex2, 4), t,
            [(10, 110, 50, 70), (100, 300, 50, 70)], {})


def _seed_layers(rng):
    cdna = dna(rng, 140)
    t = dna(rng, 100) + cdna + dna(rng, 100)
    return ("EST2GENOME", mutate(rng, cdna, 4), t,
            [(10, 110, 40, 50), (60, 90, 40, 50)], {})


def _distant_loci(rng):
    cdna = dna(rng, 100)
    t = (dna(rng, 150) + cdna + dna(rng, 5000) + mutate(rng, cdna, 3)
         + dna(rng, 150))
    return ("EST2GENOME", mutate(rng, cdna, 5), t,
            [(20, 170, 40, 55), (20, 5270, 40, 55)], {})


def _span_cut(rng):
    """A 1 kb intron, so that cutting the band in two (K8) freezes its span
    in the first chunk and thaws it in the second
    (``test_cross_chip_span_crosses_cut``' recipe)."""
    ex1, ex2 = dna(rng, 80), dna(rng, 80)
    t = (dna(rng, 60) + ex1 + "GT" + dna(rng, 1000) + "AG" + ex2
         + dna(rng, 60))
    return ("EST2GENOME", mutate(rng, ex1 + ex2, 4), t,
            [(10, 70, 40, 60), (90, 1220, 40, 60)], {})


def _ner_joint(rng):
    blk_a = "".join(rng.choice(_AAS, 60))
    blk_b = "".join(rng.choice(_AAS, 60))
    q = blk_a + "".join(rng.choice(_AAS, 25)) + blk_b
    t = blk_a + "".join(rng.choice(_AAS, 40)) + blk_b
    return ("NER", q, t, [(5, 5, 40, 220), (95, 110, 40, 220)],
            {"qt": "PP"})


def _affine_local(rng):
    base = dna(rng, 400)
    return ("AFFINE_LOCAL", base[:200], mutate(rng, base[50:350], 20),
            [(60, 10, 80, 300)], {})


def _affine(mtname, share=False):
    """The JAX package's affine pair (``test_affine_local_single_band``)
    under ``mtname``, its band over the whole target."""
    def make(rng):
        base = dna(rng, 400)
        return (mtname, base[:200], mutate(rng, base[50:350], 20),
                [(60, 10, 80, 300)], {"share": share, "margin": 300})
    return make


def _affine_two_bands(rng):
    base = dna(rng, 400)
    q = base[:200]
    t = (dna(rng, 500) + q[:120] + dna(rng, 800) + mutate(rng, q[60:200], 10)
         + dna(rng, 400))
    return ("AFFINE_LOCAL", q, t, [(5, 505, 100, 350), (70, 1430, 110, 320)],
            {"margin": 100})


def _ungapped(rng):
    base = dna(rng, 500)
    return ("UNGAPPED", base[:300], mutate(rng, base[40:460], 12),
            [(80, 40, 60, 240)], {"margin": 200})


def _ungapped_trans(rng):
    base = dna(rng, 500)
    return ("UNGAPPED_TRANS", base[:300], mutate(rng, base[40:460], 12),
            [(60, 20, 40, 200)], {"qadv": 3, "tadv": 3, "margin": 200})


def _protein2dna(mtname, margin=90):
    """The JAX package's protein2dna pair (``test_sdp_device.py:175``)."""
    def make(rng):
        from exonerate_tpu_torch.translate import default_code
        t = dna(rng, 600)
        pep = default_code().translate(
            np.frombuffer(t[90:390].encode(), np.uint8), 1)
        pep = pep.tobytes().decode().replace("*", "S")
        return (mtname, pep, t, [(5, 105, 30, 180)],
                {"qt": "PD", "qadv": 1, "tadv": 3, "margin": margin})
    return make


def _coding2coding(rng):
    base = dna(rng, 500)
    return ("CODING2CODING", base[:300], mutate(rng, base[40:460], 20),
            [(30, 5, 45, 220)], {"qadv": 3, "tadv": 3, "margin": 120})


def _split(mtname, kind, cuts=sc.CUTS, flank=40):
    """A small split pair of ``torch_split_cases`` with one HSP inside
    each of its three exons."""
    def make(rng):
        q, t = sc.small_pair(kind, seed=int(rng.integers(1 << 30)),
                             cuts=cuts, flank=flank)
        ex = sc.small_exons(kind, cuts, flank)
        adv = 1 if kind == "protein" else 3
        hsps = []
        for q0, t0, n in ex:
            lo = n // 4
            hsps.append((q0 + lo * adv, t0 + lo * 3, n // 2, 10 * (n // 2)))
        kw = {"qt": "PD" if kind == "protein" else "DD", "qadv": adv,
              "tadv": 3, "margin": 256}
        if mtname == "CDNA2GENOME":
            kw["cds"] = (0, len(q))
        return mtname, q, t, hsps, kw
    return make


# the cases every tier-1 run checks; ALL_CASES adds the longer ones
CASES = {"single_exon": (_single_exon, 11),
         "two_exons_intron": (_two_exons, 12),
         "seed_layers_same_column": (_seed_layers, 13),
         "ner_joint_span": (_ner_joint, 41)}
# split-codon band jobs (kernel K9 inside K7); coding2genome picks the
# reading frame itself, and its pair is cut one base earlier so that the
# frame it picks splits codons of both phases
SPLIT_CASES = {
    "p2g_split": (_split("PROTEIN2GENOME", "protein"), 21),
    "c2g_split": (_split("CODING2GENOME", "cdna", sc.C2G_CUTS), 22),
    "cd2g_split": (_split("CDNA2GENOME", "cdna"), 23)}
# wider-flanked twins of the split cases: a ragged batch per model
WIDE_SPLIT_CASES = {
    "p2g_split_wide": (_split("PROTEIN2GENOME", "protein", flank=300), 31),
    "c2g_split_wide": (_split("CODING2GENOME", "cdna", sc.C2G_CUTS, 300),
                       32),
    "cd2g_split_wide": (_split("CDNA2GENOME", "cdna", flank=300), 33)}
# the non-boundary models (ungapped, affine, protein2dna, coding2coding)
NB_CASES = {
    "affine_local": (_affine_local, 7),
    "affine_local_two_bands": (_affine_two_bands, 8),
    "affine_global": (_affine("AFFINE_GLOBAL"), 9),
    "affine_bestfit": (_affine("AFFINE_BESTFIT"), 10),
    "affine_overlap": (_affine("AFFINE_OVERLAP"), 15),
    "ungapped": (_ungapped, 16),
    "ungapped_trans": (_ungapped_trans, 17),
    "protein2dna": (_protein2dna("PROTEIN2DNA"), 21),
    "protein2dna_bestfit": (_protein2dna("PROTEIN2DNA_BESTFIT", 400), 24),
    "coding2coding": (_coding2coding, 22),
    "affine_local_wide": (_affine("AFFINE_LOCAL"), 25),
    "sid_shared_cell": (_affine("AFFINE_LOCAL", share=True), 25)}
ALL_CASES = dict(CASES, distant_loci=(_distant_loci, 14),
                 span_cut=(_span_cut, 5), **NB_CASES,
                 **SPLIT_CASES, **WIDE_SPLIT_CASES)


def case(name, model=None, pkg=PORT):
    """(model, pair, plan) of the named case from package ``pkg``;
    ``model`` overrides the case's own (it must be of the same type)."""
    make, seed = ALL_CASES[name]
    mt, q, t, hsps, kw = make(np.random.default_rng(seed))
    return pair_and_plan(mt, q, t, hsps, model=model, pkg=pkg, **kw)
