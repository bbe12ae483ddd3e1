"""The exonerate CLI of the port (ref: src/program/exonerate.c).

Counterpart of ``exonerate_tpu/cli/exonerate.py``: the same flags (its
``build_parser``), the same output, with the port's Analysis, GAM and
optimal, which run the exhaustive DP on the CUDA wavefront kernels.  Run
it as ``python -m exonerate_tpu_torch.cli.exonerate <query> <target>
[flags]``; ``EXONERATE_TPU_TORCH_DEVICE`` picks the device (``cuda`` by
default, ``cpu`` for the plain PyTorch engines).
"""
from __future__ import annotations

import socket
import sys

from exonerate_tpu import observe
from exonerate_tpu.align.alignment import AlignmentArgs
from exonerate_tpu.alphabet import AlphabetType
from exonerate_tpu.cli.exonerate import build_parser
from exonerate_tpu.hub.analysis import AnalysisArgs
from exonerate_tpu.hub.gam import GamArgs, Refinement
from exonerate_tpu.model.data import (AffineArgs, FrameshiftArgs,
                                      IntronArgs, MatchArgs, NerArgs)
from exonerate_tpu.model.registry import model_type_from_string
from exonerate_tpu.seeds.hsp import HspArgs
from exonerate_tpu.seeds.seeder import SeederArgs
from exonerate_tpu.seqio import read_fosn
from exonerate_tpu.splice import SplicePredictorSet
from exonerate_tpu.submat import Submat
from exonerate_tpu.translate import GeneticCode

from ..engine import optimal
from ..hub.analysis import Analysis


def _alphabet_type(s: str):
    low = (s or "unknown").lower()
    if low.startswith("d"):
        return AlphabetType.DNA
    if low.startswith("p"):
        return AlphabetType.PROTEIN
    return None


def make_analysis(v: dict, out=None) -> Analysis:
    model_type = model_type_from_string(v["model"])
    gas = GamArgs(
        model_type=model_type,
        threshold=v["score"],
        percent_threshold=v["percent"],
        show_alignment=v["showalignment"],
        show_sugar=v["showsugar"],
        show_cigar=v["showcigar"],
        show_vulgar=v["showvulgar"],
        show_query_gff=v["showquerygff"],
        show_target_gff=v["showtargetgff"],
        ryo=v["ryo"],
        best_n=v["bestn"],
        use_subopt=v["subopt"],
        use_gapped_extension=v["gappedextension"],
        refinement=Refinement(v["refine"]),
        refinement_boundary=v["refineboundary"],
        extension_threshold=v["extensionthreshold"],
        single_pass=v["singlepass"],
        terminal_range_internal=v["terminalrangeint"],
        terminal_range_external=v["terminalrangeext"],
        join_range_internal=v["joinrangeint"],
        join_range_external=v["joinrangeext"],
        span_range_internal=v["spanrangeint"],
        span_range_external=v["spanrangeext"],
        join_filter=v["joinfilter"],
        hsp_quality=float(v["quality"]),
    )
    aas = AnalysisArgs(
        use_exhaustive=v["exhaustive"],
        use_bigseq=v["bigseq"],
        use_revcomp=v["revcomp"],
        force_scan=v["forcescan"],
        saturate_threshold=v["saturatethreshold"],
        cores=v["cores"],
        custom_server=v["customserver"],
    )
    match_args = MatchArgs(
        dna_submat=Submat.create(v["dnasubmat"]),
        protein_submat=Submat.create(v["proteinsubmat"]),
        translate=GeneticCode(v["geneticcode"]),
        softmask_query=v["softmaskquery"],
        softmask_target=v["softmasktarget"],
    )
    affine_args = AffineArgs(v["gapopen"], v["gapextend"],
                             v["codongapopen"], v["codongapextend"])
    intron_args = IntronArgs(
        v["minintron"], v["maxintron"], v["intronpenalty"],
        SplicePredictorSet(v["splice5"], v["splice3"], v["forcegtag"]))
    frameshift_args = FrameshiftArgs(v["frameshift"])
    ner_args = NerArgs(v["neropen"], v["minner"], v["maxner"])
    hsp_args = HspArgs(
        seed_repeat=v["seedrepeat"],
        dna_wordlen=v["dnawordlen"],
        protein_wordlen=v["proteinwordlen"],
        codon_wordlen=v["codonwordlen"],
        dna_hsp_dropoff=v["dnahspdropoff"],
        protein_hsp_dropoff=v["proteinhspdropoff"],
        codon_hsp_dropoff=v["codonhspdropoff"],
        dna_hsp_threshold=v["dnahspthreshold"],
        protein_hsp_threshold=v["proteinhspthreshold"],
        codon_hsp_threshold=v["codonhspthreshold"],
        dna_word_limit=v["dnawordlimit"],
        protein_word_limit=v["proteinwordlimit"],
        codon_word_limit=v["codonwordlimit"],
        geneseed_threshold=v["geneseed"],
        geneseed_repeat=v["geneseedrepeat"],
        filter_threshold=v["hspfilter"],
        use_word_dropoff=v["useworddropoff"],
    )
    seeder_args = SeederArgs(
        fsm_memory_limit=v["fsmmemory"],
        force_fsm=v["forcefsm"],
        word_jump=v["wordjump"],
        word_ambiguity=v["wordambiguity"],
    )
    positional = v.get("_positional", [])
    query = v["query"] or (positional[0] if len(positional) > 0 else None)
    target = v["target"] or (positional[1] if len(positional) > 1 else None)
    if not query or not target:
        raise SystemExit("exonerate: query and target must be specified")
    query_paths = (read_fosn(query) if query.endswith(".fosn") else [query])
    target_paths = (read_fosn(target) if target.endswith(".fosn")
                    else [target])
    analysis = Analysis(
        query_paths, target_paths,
        query_chunk=(v["querychunkid"], v["querychunktotal"]),
        target_chunk=(v["targetchunkid"], v["targetchunktotal"]),
        gas=gas, aas=aas,
        match_args=match_args, affine_args=affine_args,
        intron_args=intron_args, frameshift_args=frameshift_args,
        ner_args=ner_args, hsp_args=hsp_args, seeder_args=seeder_args,
        query_type=_alphabet_type(v["querytype"]),
        target_type=_alphabet_type(v["targettype"]),
        annotation_path=v["annotation"],
        fasta_suffix=v["fastasuffix"],
        out=out, verbosity=v["verbose"],
    )
    optimal.DP_MEMORY_LIMIT = v["dpmemory"] << 20
    analysis.gam.align_args = AlignmentArgs(
        alignment_width=v["alignmentwidth"],
        forward_strand_coords=v["forwardcoordinates"],
        use_aa_tla=v["useaatla"])
    return analysis


def main(argv=None, out=None):
    argv = argv if argv is not None else sys.argv[1:]
    parser = build_parser()
    v = parser.parse(argv)
    observe.set_verbosity(v["verbose"])
    observe.reset()
    out = out or sys.stdout
    if v["multihost"] not in ("none", "false", "no"):
        raise SystemExit("exonerate: --multihost is not ported to "
                         "exonerate_tpu_torch yet")
    out.write("Command line: [exonerate " + " ".join(argv) + "]\n")
    out.write("Hostname: [%s]\n" % socket.gethostname())
    analysis = make_analysis(v, out=out)
    analysis.process()
    out.write("-- completed exonerate analysis\n")
    observe.report()
    return 0


if __name__ == "__main__":
    sys.exit(main())
