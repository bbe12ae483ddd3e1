"""The exonerate CLI of the port (ref: src/program/exonerate.c).

Counterpart of ``exonerate_tpu/cli/exonerate.py``: the same flags
(defaults table: SURVEY.md §8.4) and the same output, with the port's
Analysis, GAM and optimal, which run the exhaustive DP on the CUDA
wavefront kernels (its ``-E yes`` Waterman-Eggert re-runs with the
SubOpt mask, kernel K3), the default heuristic's SDP band scan on the
band kernels and, under ``EXONERATE_TPU_HEURISTIC=locus``, the pooled
locus heuristic on the wavefront kernels.  Run it as ``python -m
exonerate_tpu_torch.cli.exonerate <query> <target> [flags]``;
``EXONERATE_TPU_TORCH_DEVICE`` picks the device (``cuda`` by default,
``cpu`` for the plain PyTorch engines).
``--multihost query|target`` runs one chunk per ``torch.distributed``
rank (``parallel/multihost.py``; launch it with ``torchrun``), rank 0
printing the merged report.
"""
from __future__ import annotations

import socket
import sys

from ..alphabet import AlphabetType
from ..model.data import (AffineArgs, FrameshiftArgs, IntronArgs, MatchArgs,
                          NerArgs)
from ..model.registry import ModelType, model_type_from_string
from ..seeds.hsp import HspArgs
from ..seeds.seeder import SeederArgs
from ..splice import SplicePredictorSet
from ..submat import Submat
from ..translate import GeneticCode
from ..align.alignment import AlignmentArgs
from ..hub.analysis import Analysis, AnalysisArgs
from ..hub.gam import GamArgs, Refinement
from ..seqio import read_fosn
from .. import observe
from ..engine import optimal
from . import args as A


def build_parser() -> A.ArgumentParser:
    p = A.ArgumentParser(
        "exonerate", "a generic sequence comparison tool (TPU-native)")

    seq = A.ArgumentSet("Sequence Input Options")
    seq.add("q", "query", "path", "Specify query sequences", None,
            A.parse_string, "query", mandatory=True)
    seq.add("t", "target", "path", "Specify target sequences", None,
            A.parse_string, "target", mandatory=True)
    seq.add("Q", "querytype", "alphabet", "Specify query type", "unknown",
            A.parse_string)
    seq.add("T", "targettype", "alphabet", "Specify target type",
            "unknown", A.parse_string)
    seq.add(None, "querychunkid", "id", "Query chunk id", "0", A.parse_int)
    seq.add(None, "targetchunkid", "id", "Target chunk id", "0",
            A.parse_int)
    seq.add(None, "querychunktotal", "total", "Total query chunks", "0",
            A.parse_int)
    seq.add(None, "targetchunktotal", "total", "Total target chunks", "0",
            A.parse_int)
    seq.add(None, "multihost", "axis",
            "Multi-process sharding axis (none|query|target): each JAX "
            "process takes one chunk on this axis and results merge "
            "over DCN (the reference's external chunk concat, "
            "first-class)", "none", A.parse_string)
    seq.add("V", "verbose", "level", "Show search progress", "1",
            A.parse_int, "verbose")
    seq.add(None, "fastasuffix", "suffix",
            "Fasta file suffix filter (in subdirectories)", ".fa",
            A.parse_string)
    seq.add(None, "annotation", "path", "Annotation file (CDS coords)",
            "NULL", A.parse_string)
    p.add_set(seq)

    an = A.ArgumentSet("Analysis Options")
    an.add("E", "exhaustive", None, "Perform exhaustive alignment (slow)",
           "FALSE", A.parse_boolean)
    an.add("B", "bigseq", None,
           "Allow rapid comparison between big sequences", "FALSE",
           A.parse_boolean)
    an.add("r", "revcomp", None,
           "Also search reverse complement of query and target", "TRUE",
           A.parse_boolean)
    an.add(None, "forcescan", "[q|t]",
           "Force FSM scan on query or target sequences", "none",
           A.parse_string)
    an.add(None, "saturatethreshold", "int", "Word saturation threshold",
           "0", A.parse_int)
    an.add(None, "customserver", "command",
           "Custom command to send to server", "NULL", A.parse_string)
    an.add("c", "cores", "number", "Number of compute cores/devices", "1",
           A.parse_int)
    p.add_set(an)

    gam = A.ArgumentSet("Gapped Alignment Options")
    gam.add("m", "model", "alignment model", "Specify alignment model type",
            "ungapped", A.parse_string)
    gam.add("s", "score", "threshold",
            "Score threshold for gapped alignment", "100", A.parse_int)
    gam.add(None, "percent", "threshold", "Percent self-score threshold",
            "0.0", A.parse_float)
    gam.add(None, "showalignment", None,
            "Include (human readable) alignment in results", "TRUE",
            A.parse_boolean)
    gam.add(None, "showsugar", None,
            "Include 'sugar' format output in results", "FALSE",
            A.parse_boolean)
    gam.add(None, "showcigar", None,
            "Include 'cigar' format output in results", "FALSE",
            A.parse_boolean)
    gam.add(None, "showvulgar", None,
            "Include 'vulgar' format output in results", "TRUE",
            A.parse_boolean)
    gam.add(None, "showquerygff", None,
            "Include GFF output on query in results", "FALSE",
            A.parse_boolean)
    gam.add(None, "showtargetgff", None,
            "Include GFF output on target in results", "FALSE",
            A.parse_boolean)
    gam.add(None, "ryo", "format",
            "Roll-your-own printf-esque output format", "NULL",
            A.parse_string)
    gam.add("n", "bestn", "number", "Report best N results per query",
            "0", A.parse_int)
    gam.add("S", "subopt", None, "Search for suboptimal alignments",
            "TRUE", A.parse_boolean)
    gam.add("g", "gappedextension", None,
            "Use gapped extension (default is SDP)", "TRUE",
            A.parse_boolean)
    gam.add(None, "refine", None,
            "Alignment refinement strategy [none|full|region]", "none",
            A.parse_string)
    gam.add(None, "refineboundary", None, "Refinement region boundary",
            "32", A.parse_int)
    p.add_set(gam)

    heu = A.ArgumentSet("Heuristic Options")
    heu.add(None, "terminalrangeint", None, "Internal terminal range",
            "12", A.parse_int)
    heu.add(None, "terminalrangeext", None, "External terminal range",
            "12", A.parse_int)
    heu.add(None, "joinrangeint", None, "Internal join range", "12",
            A.parse_int)
    heu.add(None, "joinrangeext", None, "External join range", "12",
            A.parse_int)
    heu.add(None, "spanrangeint", None, "Internal span range", "12",
            A.parse_int)
    heu.add(None, "spanrangeext", None, "External span range", "12",
            A.parse_int)
    p.add_set(heu)

    bsd = A.ArgumentSet("BSDP algorithm options")
    bsd.add(None, "joinfilter", None, "BSDP join filter threshold", "0",
            A.parse_int)
    p.add_set(bsd)

    vit = A.ArgumentSet("Viterbi algorithm options")
    vit.add("D", "dpmemory", "Mb", "Maximum DP memory (Mb)", "32",
            A.parse_int)
    vit.add("C", "compiled", None, "Use compiled (jitted) DP engines",
            "TRUE", A.parse_boolean)
    p.add_set(vit)

    hsp = A.ArgumentSet("HSP creation options")
    hsp.add(None, "hspfilter", "threshold", "Aggressive HSP filtering level",
            "0", A.parse_int)
    hsp.add(None, "useworddropoff", None,
            "Use word neighbourhood dropoff", "TRUE", A.parse_boolean)
    hsp.add(None, "seedrepeat", "count",
            "Seeds per diagonal required for HSP seeding", "1", A.parse_int)
    hsp.add(None, "dnawordlen", "bases", "Wordlength for DNA words", "12",
            A.parse_int)
    hsp.add(None, "proteinwordlen", "aas", "Wordlength for protein words",
            "6", A.parse_int)
    hsp.add(None, "codonwordlen", "bases", "Wordlength for codon words",
            "12", A.parse_int)
    hsp.add(None, "dnahspdropoff", "score", "DNA HSP dropoff score", "30",
            A.parse_int)
    hsp.add(None, "proteinhspdropoff", "score",
            "Protein HSP dropoff score", "20", A.parse_int)
    hsp.add(None, "codonhspdropoff", "score", "Codon HSP dropoff score",
            "40", A.parse_int)
    hsp.add(None, "dnahspthreshold", "score", "DNA HSP threshold score",
            "75", A.parse_int)
    hsp.add(None, "proteinhspthreshold", "score",
            "Protein HSP threshold score", "30", A.parse_int)
    hsp.add(None, "codonhspthreshold", "score",
            "Codon HSP threshold score", "50", A.parse_int)
    hsp.add(None, "dnawordlimit", "score",
            "Score limit for dna word neighbourhood", "0", A.parse_int)
    hsp.add(None, "proteinwordlimit", "score",
            "Score limit for protein word neighbourhood", "4", A.parse_int)
    hsp.add(None, "codonwordlimit", "score",
            "Score limit for codon word neighbourhood", "4", A.parse_int)
    hsp.add(None, "geneseed", "threshold",
            "Geneseed threshold", "0", A.parse_int)
    hsp.add(None, "geneseedrepeat", "number",
            "Seeds per diagonal required for geneseed HSP seeding", "3",
            A.parse_int)
    p.add_set(hsp)

    aln = A.ArgumentSet("Alignment options")
    aln.add(None, "alignmentwidth", None, "Alignment display width", "80",
            A.parse_int)
    aln.add(None, "forwardcoordinates", None,
            "Report all coordinates on the forward strand", "TRUE",
            A.parse_boolean)
    aln.add(None, "quality", "percent",
            "HSP quality threshold", "0", A.parse_float)
    aln.add(None, "splice3", "path",
            "Supply frequency matrix for 3' splice sites", "primate",
            A.parse_string)
    aln.add(None, "splice5", "path",
            "Supply frequency matrix for 5' splice sites", "primate",
            A.parse_string)
    aln.add(None, "forcegtag", None, "Force use of gt...ag splice sites",
            "FALSE", A.parse_boolean)
    aln.add(None, "useaatla", None,
            "Use three-letter abbreviation for AA names", "TRUE",
            A.parse_boolean)
    p.add_set(aln)

    mdl = A.ArgumentSet("Model Options")
    mdl.add(None, "softmaskquery", None, "Allow softmasking on the query",
            "FALSE", A.parse_boolean)
    mdl.add(None, "softmasktarget", None,
            "Allow softmasking on the target", "FALSE", A.parse_boolean)
    mdl.add("d", "dnasubmat", "name",
            "DNA substitution matrix", "nucleic", A.parse_string)
    mdl.add("p", "proteinsubmat", "name",
            "Protein substitution matrix", "blosum62", A.parse_string)
    mdl.add("M", "fsmmemory", "Mb", "Memory limit for FSM scanning", "256",
            A.parse_int)
    mdl.add(None, "forcefsm", "type", "Force FSM type [none|normal|compact]",
            "none", A.parse_string)
    mdl.add(None, "wordjump", "step", "Jump between query words", "1",
            A.parse_int)
    mdl.add(None, "wordambiguity", "number",
            "Number of ambiguous words to expand", "1", A.parse_int)
    p.add_set(mdl)

    aff = A.ArgumentSet("Affine Model Options")
    aff.add("o", "gapopen", "penalty", "Affine gap open penalty", "-12",
            A.parse_int)
    aff.add("e", "gapextend", "penalty", "Affine gap extend penalty", "-4",
            A.parse_int)
    aff.add(None, "codongapopen", "penalty",
            "Codon affine gap open penalty", "-18", A.parse_int)
    aff.add(None, "codongapextend", "penalty",
            "Codon affine gap extend penalty", "-8", A.parse_int)
    p.add_set(aff)

    intron = A.ArgumentSet("Intron Modelling Options")
    intron.add(None, "minintron", "length", "Minimum intron length", "30",
               A.parse_int)
    intron.add(None, "maxintron", "length", "Maximum intron length",
               "200000", A.parse_int)
    intron.add("i", "intronpenalty", "score", "Intron Opening penalty",
               "-30", A.parse_int)
    p.add_set(intron)

    fs = A.ArgumentSet("Frameshift Options")
    fs.add("f", "frameshift", "penalty", "Frameshift creation penalty",
           "-28", A.parse_int)
    p.add_set(fs)

    ner = A.ArgumentSet("NER Model Options")
    ner.add(None, "neropen", "penalty", "NER open penalty", "-20",
            A.parse_int)
    ner.add(None, "minner", "length", "Minimum NER length", "10",
            A.parse_int)
    ner.add(None, "maxner", "length", "Maximum NER length", "50000",
            A.parse_int)
    p.add_set(ner)

    sdp = A.ArgumentSet("Seeded Dynamic Programming options")
    sdp.add("x", "extensionthreshold", None,
            "Gapped extension threshold (subsumed by dense locus DP)",
            "50", A.parse_int)
    sdp.add(None, "singlepass", None,
            "Generate suboptimal alignments in a single pass "
            "(subsumed by dense locus DP)", "TRUE", A.parse_boolean)
    p.add_set(sdp)

    tr = A.ArgumentSet("Translation Options")
    tr.add(None, "geneticcode", None,
           "Use built-in or custom genetic code", "1", A.parse_string)
    p.add_set(tr)

    return p


def _alphabet_type(s: str):
    low = (s or "unknown").lower()
    if low.startswith("d"):
        return AlphabetType.DNA
    if low.startswith("p"):
        return AlphabetType.PROTEIN
    return None


def make_analysis(v: dict, out=None, device=None) -> Analysis:
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
        out=out, verbosity=v["verbose"], device=device,
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
    with observe.span("run"):
        out.write("Command line: [exonerate " + " ".join(argv) + "]\n")
        out.write("Hostname: [%s]\n" % socket.gethostname())
        if v["multihost"] not in ("none", "false", "no"):
            from ..parallel.multihost import run_multihost
            run_multihost(v, v["multihost"], out)
        else:
            with observe.span("setup"):
                analysis = make_analysis(v, out=out)
            analysis.process()
        out.write("-- completed exonerate analysis\n")
    observe.report()
    return 0


if __name__ == "__main__":
    sys.exit(main())
