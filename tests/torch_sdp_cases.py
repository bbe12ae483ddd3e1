"""Synthetic seeded comparisons for the band scan, shared by
``tests/test_torch_sdp.py`` and ``chip_smoke.py``.

Each case is a small query/target pair with hand-placed HSPs, built into
an ``SDPPair`` and its band plan as the SDP tests of the JAX package
build them (``tests/test_sdp_pallas.py``).  ``case(name)`` returns
``(model, pair, plan)``; every case has its own seed.
"""
from types import SimpleNamespace

import numpy as np

from exonerate_tpu.alphabet import AlphabetType
from exonerate_tpu.engine import sdp_bands
from exonerate_tpu.engine.sdp import SDPPair, SdpArgs
from exonerate_tpu.model.data import AlignData
from exonerate_tpu.model.registry import ModelType, get_model
from exonerate_tpu.seqio import Sequence

DD = (AlphabetType.DNA, AlphabetType.DNA)
PP = (AlphabetType.PROTEIN, AlphabetType.PROTEIN)
_AAS = list("ACDEFGHIKLMNPQRSTVWY")


def dna(rng, n):
    return "".join("ACGT"[k] for k in rng.integers(0, 4, n))


def mutate(rng, s, n):
    s = list(s)
    for _ in range(n):
        s[rng.integers(0, len(s))] = "ACGT"[rng.integers(0, 4)]
    return "".join(s)


def pair_and_plan(mtname, q, t, hsp_list, margin=64, qt=DD, model=None):
    """(model, pair, plan) of q against t with the given HSPs
    (query_start, target_start, length, score)."""
    model = model or get_model(ModelType[mtname], *qt)
    qs, ts = Sequence("q", None, q), Sequence("t", None, t)
    data = AlignData(qs, ts)
    hl = [SimpleNamespace(query_start=a, target_start=b, length=c,
                          score=d, cobs=c // 2)
          for (a, b, c, d) in hsp_list]
    hs = SimpleNamespace(qadv=1, tadv=1, hsps=hl)
    comp = SimpleNamespace(query=qs, target=ts, hspsets=lambda: [hs])
    pair = SDPPair(model, comp, data, None, SdpArgs())
    pair._find_starts()
    pair._find_ends()
    extents = [(s.hsp.target_start, s.hsp.target_start + s.hsp.length)
               for s in pair.seeds]
    sw = max((sp.max_target for sp in model.spans), default=0)
    plan = sdp_bands.plan_bands(extents, len(q), len(t), margin=margin,
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


def _ner_joint(rng):
    blk_a = "".join(rng.choice(_AAS, 60))
    blk_b = "".join(rng.choice(_AAS, 60))
    q = blk_a + "".join(rng.choice(_AAS, 25)) + blk_b
    t = blk_a + "".join(rng.choice(_AAS, 40)) + blk_b
    return ("NER", q, t, [(5, 5, 40, 220), (95, 110, 40, 220)],
            {"qt": PP})


def _affine_local(rng):
    base = dna(rng, 400)
    return ("AFFINE_LOCAL", base[:200], mutate(rng, base[50:350], 20),
            [(60, 10, 80, 300)], {})


# the cases every tier-1 run checks; ALL_CASES adds the longer ones
CASES = {"single_exon": (_single_exon, 11),
         "two_exons_intron": (_two_exons, 12),
         "seed_layers_same_column": (_seed_layers, 13),
         "ner_joint_span": (_ner_joint, 41)}
ALL_CASES = dict(CASES, distant_loci=(_distant_loci, 14),
                 affine_local=(_affine_local, 7))


def case(name, model=None):
    """(model, pair, plan) of the named case; ``model`` overrides the
    case's own (it must be of the same type)."""
    make, seed = ALL_CASES[name]
    mt, q, t, hsps, kw = make(np.random.default_rng(seed))
    return pair_and_plan(mt, q, t, hsps, model=model, **kw)
