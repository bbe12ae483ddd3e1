"""The same constructors from the JAX package and from the port.

The port imports nothing of ``exonerate_tpu``: it has its own copy of the
host layer, so a model, region, sequence or AlignData of one package is
not an object of the other (their enums differ).  A test that holds the
port to the JAX package builds its inputs twice, once from each
namespace, with the same arguments: ``JAX.est2genome_create()`` and
``PORT.est2genome_create()`` give the same model.
"""
import importlib
from types import SimpleNamespace

import torch_split_cases as sc

_NAMES = {
    "alphabet": ("AlphabetType",),
    "seqio": ("Sequence", "iter_fasta", "Annotation"),
    "engine.region": ("Region",),
    "engine.sdp": ("SDPPair", "SdpArgs"),
    "model.data": ("AlignData", "IntronArgs"),
    "model.match": ("MatchType",),
    "model.affine": ("AffineModelType", "affine_create"),
    "model.est2genome": ("est2genome_create",),
    "model.ner": ("ner_create",),
    "model.protein2dna": ("protein2dna_create",),
    "model.coding2coding": ("coding2coding_create",),
    "model.ungapped": ("ungapped_create",),
    "model.registry": ("ModelType", "get_model", "translate_both"),
}


def namespace(pkg: str) -> SimpleNamespace:
    out = {"pkg": pkg}
    for mod in ("observe", "engine.reference", "engine.sdp_bands",
                "model.registry"):
        out[mod.rsplit(".", 1)[-1]] = importlib.import_module(f"{pkg}.{mod}")
    for mod, names in _NAMES.items():
        m = importlib.import_module(f"{pkg}.{mod}")
        for n in names:
            out[n] = getattr(m, n)
    return SimpleNamespace(**out)


JAX = namespace("exonerate_tpu")
PORT = namespace("exonerate_tpu_torch")


def dp_key(r):
    """The fields of a DPResult (either package's), path as names."""
    if r is None:
        return None
    path = getattr(r, "path", None)
    return (r.score, r.query_start, r.target_start, r.query_end,
            r.target_end,
            None if path is None else [t.name for t in path])


# the split-codon models and the small pairs they run on: coding2genome
# picks its own reading frame, so its pair is cut at C2G_CUTS
SPLIT_MODELS = {"PROTEIN2GENOME": ("protein", sc.CUTS),
                "CODING2GENOME": ("cdna", sc.C2G_CUTS),
                "CDNA2GENOME": ("cdna", sc.CUTS)}


def split_job(X, mtname: str):
    """(model, region, data) of ``mtname`` on its small split pair, built
    from namespace ``X``; cdna2genome's query is annotated as coding."""
    kind, cuts = SPLIT_MODELS[mtname]
    q, t = sc.small_pair(kind, cuts=cuts)
    qs, ts = X.Sequence("q", None, q), X.Sequence("t", None, t)
    if mtname == "CDNA2GENOME":
        qs.annotation = X.Annotation(0, len(q))
    mt = X.ModelType[mtname]
    qa = X.AlphabetType.PROTEIN if kind == "protein" else X.AlphabetType.DNA
    model = X.get_model(mt, qa, X.AlphabetType.DNA)
    return (model, X.Region(0, 0, len(q), len(t)),
            X.AlignData(qs, ts, X.translate_both(mt)))


def split_phases(path) -> set:
    """The split-codon phases a path crosses (its "phaseNpost ... to
    (END)" transitions)."""
    return {int(t.name[5]) for t in path
            if t.name.startswith("phase") and "post" in t.name.split()[0]}
