"""Command-line interface mirroring the reference pagan2 binary's flag
surface (src/utils/settings.cpp:40-302), driving the JAX engine.

Usage:  python -m pagan2_tpu -s seqs.fas -t tree.nh -o out
        python -m pagan2_tpu --pileup --homopolymer -q 454_reads.fas -o out
"""
from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pagan2-tpu",
        description="Phylogeny-aware multiple sequence alignment "
                    "(JAX PAGAN2)")
    g = p.add_argument_group("input/output")
    g.add_argument("config_file", nargs="?", default=None,
                   help="ini-style config file with 'option = value' "
                        "lines (command-line arguments win)")
    g.add_argument("--config-file", dest="config_file_opt", default=None)
    g.add_argument("--config-log-file", default=None,
                   help="write the effective options to a replayable "
                        "config file")
    g.add_argument("-s", "--seqfile", help="sequence infile (FASTA/FASTQ)")
    g.add_argument("-t", "--treefile", help="guide tree (Newick)")
    g.add_argument("-q", "--queryfile", help="reads/query file")
    g.add_argument("--ref-seqfile", help="reference alignment file")
    g.add_argument("--ref-treefile", help="reference tree file")
    g.add_argument("-o", "--outfile", default="outfile",
                   help="output prefix")
    g.add_argument("--outformat", default="fasta",
                   choices=["fasta", "phylip", "phylipi", "nexus", "paml",
                            "raxml"])
    g.add_argument("--xml", action="store_true", help="also write HSAML xml")
    g.add_argument("--xml-nhx", action="store_true",
                   help="output XML alignment with NHX tree")
    g.add_argument("--output-ancestors", "--ancestors", action="store_true",
                   dest="output_ancestors",
                   help="include ancestors in outfile")
    g.add_argument("--events", action="store_true",
                   help="output inferred evolutionary events")
    g.add_argument("--output-graph", action="store_true",
                   help="write root graph (.grp)")
    g.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                   help="persist each finished subtree graph to DIR "
                        "and resume from it on restart (framework "
                        "extension; use one directory per run)")
    g.add_argument("--output-consensus", action="store_true",
                   help="write consensus rows of read subtrees to "
                        "<outfile>_consensus.fas")
    g.add_argument("--show-contig-ancestor", action="store_true",
                   help="show ancestral states at read-free contig sites")
    g.add_argument("--inlude-parent-in-contig", action="store_true",
                   dest="include_parent_in_contig",
                   help="add reference parent row to contig output "
                        "(reference's spelling)")
    g.add_argument("--mpost-graph-file", default=None,
                   help="write sequence graphs as MetaPost figures")
    g.add_argument("--output-leaf-graphs", action="store_true",
                   help="include leaf graphs in the MetaPost output")
    g.add_argument("--output-alignment-graphs", action="store_true",
                   help="include alignment graphs in the MetaPost output")
    g.add_argument("--mpost-posterior-plot-file", default=None,
                   help="write DP posterior heatmaps as MetaPost "
                        "(implies --full-probability)")
    g.add_argument("--plot-slope-up", action="store_true",
                   help="posterior plot y axis increasing upward")
    g.add_argument("--plot-anchors-for-R", dest="plot_anchors_for_r",
                   default=None,
                   help="dump anchor hits + tunnel bounds as R scripts")
    g.add_argument("--output-nhx-tree", "--guidetree", action="store_true",
                   dest="output_nhx_tree",
                   help="output alignment guidetree (with NHX tags)")
    g.add_argument("--prune-extended-alignment", action="store_true",
                   help="remove closely related sequences")
    g.add_argument("--prune-keep-number", type=int, default=0,
                   help="prune output, keep N most distant sequences")
    g.add_argument("--prune-keep-threshold", type=float,
                   help="prune output, drop references closer than this "
                        "tree distance (keeps the longer sequence)")
    g.add_argument("--prune-keep-closest", action="store_true",
                   help="prune output, keep only closest references")
    g.add_argument("--trim-extended-alignment", action="store_true",
                   help="remove terminal reference sequences")
    g.add_argument("--trim-keep-sites", type=int, default=15,
                   help="trim distance around queries")

    m = p.add_argument_group("model")
    m.add_argument("--codons", action="store_true")
    m.add_argument("--protein", action="store_true")
    m.add_argument("--translate", action="store_true",
                   help="translate DNA input to protein; align as protein "
                        "and also write back-translated .codon output")
    m.add_argument("--mt-translate", action="store_true",
                   help="like --translate with the vertebrate "
                        "mitochondrial code")
    m.add_argument("--dna-kappa", "--char-kappa", dest="char_kappa",
                   type=float, default=2.0)
    m.add_argument("--dna-rho", "--char-rho", dest="char_rho",
                   type=float, default=1.0)
    m.add_argument("--use-aa-groups", action="store_true",
                   help="reconstruct amino-acid parsimony with 51 groups")
    m.add_argument("--score-as-dna", action="store_true",
                   help="score protein/ORFs as DNA (translated placement)")
    m.add_argument("--ins-rate", type=float)
    m.add_argument("--del-rate", type=float)
    m.add_argument("--indel-rate", type=float)
    m.add_argument("--gap-extension", type=float)
    m.add_argument("--end-gap-extension", type=float)
    m.add_argument("--pair-read-gap-extension", type=float)
    m.add_argument("--pair-end", action="store_true",
                   help="treat '0'-joined FASTQ reads as pair-end pairs "
                        "(activates the reference's latent pair-end "
                        "machinery, basic_alignment.h:584-586 — the "
                        "reference declares but never wires this flag)")
    m.add_argument("--mostcommon", action="store_true")
    m.add_argument("--ambiguity-factor", type=float, default=1.0)
    m.add_argument("--no-log-odds", action="store_true")
    m.add_argument("--no-score-scaling", action="store_true")
    m.add_argument("--pacbio", action="store_true")

    t = p.add_argument_group("tree")
    t.add_argument("--scale-branches", type=float)
    t.add_argument("--truncate-branches", type=float, default=0.2)
    t.add_argument("--real-branches", action="store_true")
    t.add_argument("--fixed-branches", type=float)
    t.add_argument("--min-branch-length", type=float, default=0.001)

    a = p.add_argument_group("alignment")
    a.add_argument("--full-probability", action="store_true",
                   help="compute full probability (fwd/bwd posterior)")
    a.add_argument("--sample-path", action="store_true",
                   help="sample the alignment path from posteriors")
    a.add_argument("--sample-additional-paths", type=int, default=0)
    a.add_argument("--weight-sampled-edges", action="store_true")
    a.add_argument("--seed", type=int, help="RNG seed for path sampling")
    a.add_argument("--no-terminal-edges", action="store_true")
    a.add_argument("--no-reduced-terminal-penalties", action="store_true")
    a.add_argument("--keep-all-edges", action="store_true")
    a.add_argument("--branch-length-confirm-insertion", type=float)
    a.add_argument("--any-skips-confirm-insertion", type=int)
    a.add_argument("--match-skips-confirm-insertion", type=int)
    a.add_argument("--branch-skip-weight-per-distance", type=float)
    a.add_argument("--branch-skip-penalty-per-branch", type=float)
    a.add_argument("--no-weight-transform", action="store_true",
                   help="no weight transform for sampled edges")
    a.add_argument("--cuberoot-weight-transform", action="store_true",
                   help="cuberoot weight transform for sampled edges")
    a.add_argument("--memory-for-single-alignment", type=int, default=4000,
                   help="MB of memory allowed for a single alignment")
    a.add_argument("--force-gap", action="store_true",
                   help="force gaps in poorly prealigned areas when "
                        "exceeding memory limits")
    a.add_argument("--force-gap-threshold", type=int, default=40000,
                   help="min size (height*length) of empty tunnel blocks "
                        "removed when over the memory limit")
    a.add_argument("--force-gap-wide-tunnel", action="store_true",
                   help="use wide tunnel when removing blocks")

    r = p.add_argument_group("reads/pileup")
    r.add_argument("--pileup", "--pileup-alignment", action="store_true",
                   dest="pileup")
    r.add_argument("--454", action="store_true", dest="mode454")
    r.add_argument("--homopolymer", action="store_true")
    r.add_argument("--both-strands", action="store_true")
    r.add_argument("--use-consensus", action="store_true")
    r.add_argument("--build-contigs", action="store_true")
    r.add_argument("--consensus-minimum", type=int, default=5)
    r.add_argument("--consensus-minimum-proportion", type=float, default=0.5)
    r.add_argument("--min-query-overlap", type=float, default=0.5)
    r.add_argument("--min-query-identity", type=float, default=0.5)
    r.add_argument("--query-distance", type=float, default=0.1)
    r.add_argument("--query-cluster-attempts", type=int, default=1)
    r.add_argument("--overlap-with-any", action="store_true")
    r.add_argument("--terminal-nodes", "--test-every-terminal-node",
                   action="store_true", dest="terminal_nodes")
    r.add_argument("--internal-nodes", "--test-every-internal-node",
                   action="store_true", dest="internal_nodes")
    r.add_argument("--all-nodes", "--test-every-node",
                   action="store_true", dest="all_nodes")
    r.add_argument("--one-placement-only", action="store_true")
    r.add_argument("--exhaustive-placement", action="store_true",
                   help="no multiple placement on score ties")
    r.add_argument("--guided", action="store_true",
                   help="guided placement with TID tags")
    r.add_argument("--no-preselection", action="store_true",
                   help="no candidate preselection; use TID tags")
    r.add_argument("--assembly", action="store_true",
                   help="placement at subroot only (for assembly)")
    r.add_argument("--align-reads-at-root", action="store_true",
                   help="ignore tags and align reads at root (pileup)")
    r.add_argument("--score-only-ungapped", action="store_true",
                   help="score query placement only on ungapped sites")
    r.add_argument("--score-ungapped-limit", type=float, default=0.1,
                   help="max gap proportion for a scored site")
    r.add_argument("--anchoring-threshold", type=float, default=1.0,
                   help="anchoring coverage threshold for skipping "
                        "(placement only)")
    r.add_argument("--use-duplicate-weights", action="store_true",
                   help="use NumDuplicates=# to weight consensus counts")
    r.add_argument("--rank-reads-for-nodes", action="store_true",
                   help="rank reads within nodes for alignment (score "
                        "queries even when their TID matches one node)")
    r.add_argument("--tid-for-subroot", action="store_true",
                   help="spliced parent inherits the target's NHX TID")
    r.add_argument("--quick", action="store_true",
                   help="quick reference-alignment reconstruction "
                        "(single model at distance 0.5)")
    r.add_argument("--perfect-reference", action="store_true",
                   help="assume perfect reference alignment")
    r.add_argument("--recompute-reference-alignment-model",
                   action="store_true",
                   help="accepted for compatibility (dead flag in the "
                        "reference too: no consumer outside "
                        "settings.cpp:273)")
    r.add_argument("--no-read-ordering", action="store_true",
                   help="accepted for compatibility (dead flag in the "
                        "reference too)")
    r.add_argument("--fragments", action="store_true",
                   help="short queries: place together")
    r.add_argument("--align-bad-reads-at-root", action="store_true")
    r.add_argument("--use-identity-score", action="store_true")
    r.add_argument("--use-target-normalised-score", action="store_true")
    r.add_argument("--output-discarded-queries", action="store_true")
    r.add_argument("--no-fastq", action="store_true",
                   help="do not use Q-scores")
    r.add_argument("--qscore-minimum", type=int, default=10,
                   help="threshold to mask low Q-score sites")
    # --454-skip-low-qscore is an alias: the reference checks
    # "allow-skip-low-qscore" (sequence.cpp:502) though settings.cpp
    # never registers it; both spellings enable the low-qscore skip
    # edges here
    r.add_argument("--allow-skip-low-qscore", "--454-skip-low-qscore",
                   action="store_true", dest="allow_skip_low_qscore")
    r.add_argument("--find-orfs", action="store_true",
                   help="find ORFs, align translations (DNA)")
    r.add_argument("--min-orf-length", type=int, default=50,
                   help="minimum ORF length to be considered (DNA)")
    r.add_argument("--min-orf-coverage", type=float, default=None,
                   help="minimum ORF coverage to be considered (DNA)")

    x = p.add_argument_group("execution")
    x.add_argument("--engine", default="auto",
                   choices=["auto", "jax", "oracle"])
    x.add_argument("--threads", type=int, default=1,
                   help="shard each generation's batched alignments over "
                        "up to this many accelerator devices (the "
                        "reference's OpenMP thread count)")
    x.add_argument("--boost", action="store_true",
                   help="accepted for compatibility; generation batching "
                        "replaces the boost work queue")
    x.add_argument("--devices", type=int, default=None,
                   help="alias of --threads: size of the jobs mesh axis")
    # multi-host execution (our extension; the reference is
    # single-process): every host runs the same command with its RANK
    x.add_argument("--jax-coordinator", default=None, metavar="HOST:PORT",
                   help="jax.distributed coordinator address for "
                        "multi-host runs")
    x.add_argument("--jax-num-processes", type=int, default=1,
                   help="number of processes in the multi-host run")
    x.add_argument("--jax-process-id", type=int, default=0,
                   help="this process's rank in the multi-host run")
    x.add_argument("--jax-local-device", type=int, default=None,
                   help="local device this process drives when several "
                        "processes share a host (one process per card)")
    x.add_argument("--silent", action="store_true")
    x.add_argument("--noise", type=int, default=0)
    x.add_argument("--version", "-v", action="store_true",
                   help="show program version")
    x.add_argument("--time", action="store_true", dest="track_time",
                   help="track time per pipeline phase (+ DP GCUPS)")
    x.add_argument("--jax-profile", default=None, metavar="DIR",
                   help="write a jax/xplane profiler trace of the run "
                        "to DIR (view with tensorboard or xprof)")
    x.add_argument("--log-output-file", default=None,
                   help="log to file instead of stderr")
    x.add_argument("--temp-folder", default=None,
                   help="accepted for compatibility (no temp files used)")
    x.add_argument("--keep-temp-files", action="store_true",
                   help="accepted for compatibility")
    x.add_argument("--check-valid-graphs", action="store_true",
                   help="check sequence-graph invariants after alignment")
    x.add_argument("--anchors", action="store_true", default=True)
    x.add_argument("--no-anchors", action="store_true")
    x.add_argument("--use-prefix-anchors", action="store_true")
    x.add_argument("--prefix-hit-length", type=int, default=30)
    x.add_argument("--anchors-offset", type=int, default=15)
    x.add_argument("--hmmer-anchors", action="store_true",
                   help="two-pin anchoring at the best local-similarity "
                        "region's ends (native stand-in for the "
                        "reference's hmmsearch subprocess)")
    x.add_argument("--ncbi-threshold-overlap-total", type=int, default=50,
                   help="distance for fully overlapping hits to be "
                        "accepted as anchors")
    x.add_argument("--ncbi-threshold-overlap-partly", type=int,
                   default=400,
                   help="distance for partially overlapping hits to be "
                        "accepted as anchors")
    x.add_argument("--no-bppancestors", action="store_true",
                   help="parsimony ancestors instead of ML")
    x.add_argument("--raxml-tree", action="store_true",
                   help="guide-tree method selector; the native k-mer "
                        "NJ inference is used (documented deviation)")
    x.add_argument("--bppdist-tree", action="store_true",
                   help="guide-tree method selector; the native k-mer "
                        "NJ inference is used (documented deviation)")
    x.add_argument("--docker", action="store_true",
                   help="accepted for compatibility")
    x.add_argument("--full-help", action="help",
                   help="show this help message (alias of --help)")

    # placement speed modes: the reference's exonerate-subprocess
    # preselection (settings.cpp:355-380) maps to the native k-mer
    # candidate preselection (_preselect_candidates)
    s = p.add_argument_group("placement speed")
    s.add_argument("--fast-placement", action="store_true",
                   help="k-mer-preselect the 5 best candidate nodes "
                        "before full scoring")
    s.add_argument("--very-fast-placement", action="store_true",
                   help="k-mer-preselect the single best candidate node")
    s.add_argument("--own-placement", action="store_true",
                   help="disable candidate preselection")
    s.add_argument("--use-exonerate-local", action="store_true",
                   help="enable candidate preselection (native k-mer "
                        "stand-in for exonerate)")

    # external-tool tuning accepted for CLI compatibility: the NCBI
    # BLAST / Exonerate subprocesses of the reference are replaced by
    # the native k-mer/prefix anchoring and candidate scoring
    # (settings.cpp:154-186)
    c = p.add_argument_group("external-tool compatibility (no-ops)")
    for flag, kw in [
            ("--no-ncbi", dict(action="store_true")),
            ("--old-placement", dict(action="store_true")),
            ("--use-exonerate-gapped", dict(action="store_true")),
            ("--keep-despite-exonerate-fails", dict(action="store_true")),
            ("--exonerate-local-keep-best", dict(type=int, default=6)),
            ("--exonerate-local-keep-above", dict(type=float)),
            ("--exonerate-gapped-keep-best", dict(type=int, default=3)),
            ("--exonerate-gapped-keep-above", dict(type=float)),
            ("--exonerate-hit-length", dict(type=int, default=30)),
            ("--exonerate-hit-score", dict(type=int)),
            ("--exonerate-hit-trim", dict(type=int, default=5)),
            ("--blast-wordsize", dict(type=int, default=-1)),
            ("--blast-word-threshold", dict(type=int, default=-1)),
            ("--blast-match-reward", dict(type=int, default=-1)),
            ("--blast-mismatch-penalty", dict(type=int, default=999)),
            ("--blast-scoring-matrix", dict(default="BLOSUM62")),
    ]:
        c.add_argument(flag, help="accepted for compatibility", **kw)
    return p


def resolve_data_type(args, entries) -> str:
    from .models import alphabets as alph
    from .io.fasta import guess_data_type
    if args.codons:
        return alph.CODON
    if args.protein:
        return alph.PROTEIN
    return guess_data_type(entries)


def maybe_translate(args, entries, data_type):
    """--translate / --mt-translate: convert DNA input to protein on read
    (fasta_reader.cpp:239-263). Returns (data_type, dna_map or None)."""
    from .models import alphabets as alph
    if not (args.translate or args.mt_translate):
        return data_type, None
    if data_type != alph.DNA:
        print("Option '--translate' cannot be used for proteins. Exiting.",
              file=sys.stderr)
        raise SystemExit(0)
    from .io.translate import translate_entries
    dna_map = translate_entries(entries, mt=args.mt_translate)
    return alph.PROTEIN, dna_map


def write_codon_outputs(args, tree, alignment, dna_map):
    """Back-translated `.codon` flatfile (+xml) next to the protein
    output (input_output_parser.cpp:646-806)."""
    from .io.translate import backtranslate_entries
    codon = backtranslate_entries(
        alignment, dna_map,
        include_mock_ancestors=args.output_ancestors,
        mt=args.mt_translate)
    if not codon:
        return
    import copy
    cargs = copy.copy(args)
    cargs.outfile = args.outfile + ".codon"
    cargs.output_graph = False
    cargs.output_nhx_tree = False
    # the posterior-plot sink was flushed by the first write_outputs;
    # rewriting here would truncate the user's plots to an empty file
    cargs.mpost_posterior_plot_file = None
    write_outputs(cargs, tree, codon, "dna")


def make_model_factory(args, data_type, entries):
    from .models import ModelFactory, IndelParams, alphabets as alph
    from .io.fasta import empirical_dna_frequencies

    indel = IndelParams.for_data_type(data_type, pacbio=args.pacbio)
    if args.indel_rate is not None:
        indel.ins_rate = indel.del_rate = args.indel_rate
    if args.ins_rate is not None:
        indel.ins_rate = args.ins_rate
    if args.del_rate is not None:
        indel.del_rate = args.del_rate
    if args.gap_extension is not None:
        indel.gap_ext = args.gap_extension
    if args.end_gap_extension is not None:
        indel.end_gap_ext = args.end_gap_extension
    if args.pair_read_gap_extension is not None:
        indel.break_gap_ext = args.pair_read_gap_extension

    scaling = "log-odds"
    if args.no_score_scaling:
        scaling = "none"
    elif args.no_log_odds:
        scaling = "raw"

    kw = dict(indel=indel, score_scaling=scaling,
              ambiguity_factor=args.ambiguity_factor,
              mostcommon=args.mostcommon,
              pileup_454=(args.mode454 or args.homopolymer) and args.pileup)
    if data_type == alph.DNA:
        kw.update(dna_pi=empirical_dna_frequencies(entries),
                  kappa=args.char_kappa, rho=args.char_rho)
    return ModelFactory(data_type, **kw)


def make_settings(args):
    from .align import AlignSettings
    from dataclasses import replace
    weight_transform = "sqrt"
    if args.no_weight_transform:
        weight_transform = "plain"
    if args.cuberoot_weight_transform:
        weight_transform = "cuberoot"
    s = AlignSettings(
        no_terminal_edges=args.no_terminal_edges,
        reduced_terminal_gap_penalties=not args.no_reduced_terminal_penalties,
        use_anchors=not args.no_anchors,
        use_prefix_anchors=args.use_prefix_anchors,
        use_hmmer_anchors=args.hmmer_anchors,
        prefix_hit_length=args.prefix_hit_length,
        anchors_offset=args.anchors_offset,
        anchor_threshold_total=args.ncbi_threshold_overlap_total,
        anchor_threshold_partly=args.ncbi_threshold_overlap_partly,
        compute_full_score=(args.full_probability or
                            args.mpost_posterior_plot_file is not None),
        sample_path=args.sample_path,
        sample_additional_paths=args.sample_additional_paths,
        pair_end_reads=args.pair_end,
        # set_additional_settings (basic_alignment.h:618-619)
        weight_edges=(args.weight_sampled_edges and
                      args.sample_additional_paths > 0),
        weight_transform=weight_transform,
        use_duplicate_weights=args.use_duplicate_weights,
        memory_limit_mb=args.memory_for_single_alignment,
        force_gap=args.force_gap,
        force_gap_threshold=args.force_gap_threshold,
        force_gap_wide_tunnel=args.force_gap_wide_tunnel,
        # the skip heuristic only works for placement
        # (settings.cpp:392-397)
        anchoring_threshold=(args.anchoring_threshold if args.queryfile
                             else 1.0),
        keep_all_edges=args.keep_all_edges,
    )
    if args.seed is not None:
        from .align import set_sampling_seed
        set_sampling_seed(args.seed)
    if args.branch_length_confirm_insertion is not None:
        s = replace(s, max_allowed_skip_distance=args.branch_length_confirm_insertion)
    if args.any_skips_confirm_insertion is not None:
        s = replace(s, max_allowed_skip_branches=args.any_skips_confirm_insertion)
    if args.match_skips_confirm_insertion is not None:
        s = replace(s, max_allowed_match_skip_branches=args.match_skips_confirm_insertion)
    if args.branch_skip_weight_per_distance is not None:
        s = replace(s, branch_skip_weight=args.branch_skip_weight_per_distance,
                    weighted_branch_skip_penalty=True)
    if args.branch_skip_penalty_per_branch is not None:
        s = replace(s, branch_skip_probability=args.branch_skip_penalty_per_branch,
                    weighted_branch_skip_penalty=False)
    return s


def write_entries(entries, out, fmt, data_type):
    from .io.fasta import (write_fasta, write_phylip, write_nexus,
                           write_paml)
    if fmt == "fasta":
        write_fasta(entries, out + ".fas")
    elif fmt in ("phylip", "raxml"):
        write_phylip(entries, out + ".phy")
    elif fmt == "phylipi":
        write_phylip(entries, out + ".phy", interleaved=True)
    elif fmt == "nexus":
        write_nexus(entries, out + ".nex", data_type=data_type)
    elif fmt == "paml":
        write_paml(entries, out + ".phy")


def configure_compile_cache():
    """Persistent XLA compilation cache: JAX_COMPILATION_CACHE_DIR when
    set (JAX reads it itself), else <checkout>/.jax_cache.  Shapes are
    bucketed, so a second process on the same workload compiles
    (almost) nothing."""
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        import jax
        jax.config.update("jax_compilation_cache_dir", str(
            Path(__file__).resolve().parents[1] / ".jax_cache"))


def _make_mesh(args):
    """Jobs mesh from --devices/--threads (None on a single device);
    with --jax-coordinator the mesh spans every connected process's
    devices (parallel/multihost.py)."""
    if args.jax_coordinator:
        from .parallel.multihost import global_jobs_mesh
        return global_jobs_mesh()
    n_dev = args.devices or args.threads
    if n_dev and n_dev > 1 and args.engine != "oracle":
        try:
            import jax
            if len(jax.devices()) > 1:
                from .parallel.executor import make_jobs_mesh
                return make_jobs_mesh(n_dev)
        except ImportError:
            pass
    return None


def write_outputs(args, tree, alignment, data_type):
    from .io.writers import write_xml, write_graph_file

    out = args.outfile
    write_entries(alignment, out, args.outformat, data_type)
    if (args.xml or args.xml_nhx) and tree is not None:
        write_xml(tree, alignment, out + ".xml",
                  nhx=args.xml_nhx)
    if args.output_graph and tree is not None and tree.graph is not None:
        write_graph_file(tree.graph, out + ".grp")
    if tree is not None and args.output_ancestors:
        with open(out + ".anctree", "w") as f:
            f.write(tree.to_newick(with_names_for_internal=True) + "\n")
    if tree is not None and args.output_nhx_tree:
        from .pipeline.postprocess import write_nhx_tree
        write_nhx_tree(tree, out, "nhx_tree")
    if tree is not None and args.mpost_graph_file:
        from .io.plots import write_mpost_sequence_graphs
        write_mpost_sequence_graphs(
            tree, args.mpost_graph_file,
            include_leaves=args.output_leaf_graphs,
            include_alignment_graphs=args.output_alignment_graphs)
    if args.mpost_posterior_plot_file:
        from .io.plots import write_mpost_posterior_plots
        write_mpost_posterior_plots(args.mpost_posterior_plot_file,
                                    slope_up=args.plot_slope_up)
    if tree is not None and (args.output_consensus or
                             args.build_contigs):
        from .pipeline.pileup import reconstruct_contigs, PileupConfig
        ccfg = PileupConfig(
            consensus_minimum=args.consensus_minimum,
            consensus_minimum_proportion=args.consensus_minimum_proportion)
        if args.output_consensus:
            rows = reconstruct_contigs(
                tree, ccfg, consensus_only=True,
                include_parent=args.include_parent_in_contig,
                show_ancestor=args.show_contig_ancestor)
            if rows:
                from .io.fasta import write_fasta
                write_fasta(rows, out + "_consensus.fas")
        if args.build_contigs:
            # --build-contigs: consensus plus the reads of each contig
            # (input_output_parser.cpp:877-891,
            # reconstruct_contigs(contigs, false))
            rows = reconstruct_contigs(
                tree, ccfg, consensus_only=False,
                include_parent=args.include_parent_in_contig,
                show_ancestor=args.show_contig_ancestor)
            if rows:
                from .io.fasta import write_fasta
                write_fasta(rows, out + "_contigs.fas")


def post_outputs(args, tree, alignment, data_type):
    """Post-output steps shared by all run modes: --events,
    --prune-extended-alignment, --trim-extended-alignment,
    --check-valid-graphs (input_output_parser.cpp:586-930)."""
    from .utils import log_out
    if tree is None:
        return
    if args.events:
        from .pipeline.postprocess import count_events
        count_events(tree, alignment, args.outfile, data_type,
                     is_codon=args.codons, mt=args.mt_translate)
        log_out("Inferred evolutionary events: %s.events\n"
                % args.outfile, 0)

    from .pipeline.postprocess import (prune_extended_alignment,
                                       trim_alignment, read_node_names,
                                       write_nhx_tree)
    if args.prune_extended_alignment:
        outs = prune_extended_alignment(
            tree, alignment, keep_number=args.prune_keep_number,
            keep_closest=args.prune_keep_closest,
            keep_threshold=args.prune_keep_threshold,
            trim=args.trim_extended_alignment,
            trim_keep_sites=args.trim_keep_sites)
        for suffix, entries, ptree in outs:
            write_entries(entries, args.outfile + suffix, args.outformat,
                          data_type)
            if ptree is not None:
                write_nhx_tree(ptree, args.outfile + suffix, "tre")
            log_out("Pruned alignment file: %s%s\n"
                    % (args.outfile, suffix), 0)
    elif args.trim_extended_alignment:
        readnames = read_node_names(tree)
        trimmed = trim_alignment(alignment, readnames,
                                 args.trim_keep_sites)
        write_entries(trimmed, args.outfile + ".trimmed", args.outformat,
                      data_type)
        log_out("Trimmed alignment file: %s.trimmed\n" % args.outfile, 0)

    if args.check_valid_graphs:
        bad = [n.name for n in tree.nodes_postorder()
               if n.graph is not None and not n.graph.check_valid_graph()]
        if bad:
            print("invalid sequence graphs at nodes: %s" % ", ".join(bad),
                  file=sys.stderr)
            raise SystemExit(1)


def config_file_args(path, parser) -> list[str]:
    """Convert an ini-style config file ('option = value', '#' comments;
    settings.cpp:304-331) into an argv fragment. Switches appear as
    'option = 1'."""
    args = []
    actions = parser._option_string_actions
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            key, _, val = line.partition("=")
            opt = "--" + key.strip()
            val = val.strip()
            action = actions.get(opt)
            if action is None:
                raise SystemExit("unknown option '%s' in config file %s"
                                 % (key.strip(), path))
            if isinstance(action, argparse._StoreTrueAction):
                if val.lower() in ("1", "true", "yes", "on", ""):
                    args.append(opt)
            else:
                args.extend([opt, val])
    return args


def write_config_log(path, argv, cfg_args):
    """Replayable 'option = value' dump of the effective arguments
    (settings.cpp:446-510). Short options are written under their LONG
    name (the config reader looks options up by long name), and
    whether the next token is a value comes from the parser's own
    option table, not a '-' prefix guess (negative numbers are
    values)."""
    import time as _time
    parser = build_parser()
    by_opt = {}
    for action in parser._actions:
        longs = [o for o in action.option_strings
                 if o.startswith("--")]
        canon = (max(longs, key=len) if longs
                 else (action.option_strings[0]
                       if action.option_strings else None))
        for o in action.option_strings:
            by_opt[o] = (canon.lstrip("-") if canon else None,
                         action.nargs != 0)
    lines = ["# pagan2-tpu",
             "#", "# Analysis started: " + _time.asctime(), ""]

    def emit(tokens):
        i = 0
        while i < len(tokens):
            tok = tokens[i]
            if not tok.startswith("-"):
                i += 1
                continue
            opt, val = tok, None
            if "=" in tok:
                opt, val = tok.split("=", 1)
            key, takes_value = by_opt.get(opt, (tok.lstrip("-"), None))
            if val is None:
                if takes_value is None:
                    # unknown option: fall back to the prefix guess
                    takes_value = (i + 1 < len(tokens) and
                                   not tokens[i + 1].startswith("-"))
                if takes_value and i + 1 < len(tokens):
                    val = tokens[i + 1]
                    i += 1
                else:
                    val = "1"
            if key not in ("config-file", "config-log-file"):
                lines.append("%s = %s" % (key, val))
            i += 1

    emit(list(argv))
    if cfg_args:
        lines.append("")
        lines.append("# Additional arguments from config file:")
        emit(cfg_args)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def handle_queries(args, res, data_type, mf, settings, dna_map,
                   mesh=None):
    """Align -q queries onto the finished alignment's root — the
    reference runs Reads_aligner after ANY alignment, progressive
    or reference-read (main.cpp:206-218); both CLI branches call
    this."""
    from .io.fasta import read_sequences
    if args.queryfile and args.align_reads_at_root:
        # reads_aligner.cpp:92: --align-reads-at-root uses the
        # pileup path with the reference root as the start graph
        from .pipeline.pileup import pileup_align, PileupConfig
        queries = read_sequences(args.queryfile)
        pcfg = PileupConfig(
            both_strands=args.both_strands,
            min_query_overlap=args.min_query_overlap,
            min_query_identity=args.min_query_identity,
            query_cluster_attempts=args.query_cluster_attempts,
            query_distance=args.query_distance,
            overlap_with_any=args.overlap_with_any,
            use_consensus=(args.use_consensus or args.build_contigs
                           or args.output_consensus),
            consensus_minimum=args.consensus_minimum,
            consensus_minimum_proportion=(
                args.consensus_minimum_proportion),
            engine=args.engine)
        pres = pileup_align(queries, data_type, pcfg,
                            model_factory=mf, settings=settings,
                            root_node=res.tree)
        from .pipeline.progressive import ProgressiveResult
        res = ProgressiveResult(tree=pres.root,
                                alignment=pres.alignment)
        if not args.silent:
            print(f"placed {len(queries) - len(pres.discarded)} "
                  f"queries at root, {len(pres.discarded)} discarded")
    elif args.queryfile:
        from .pipeline.placement import place_queries, PlacementConfig
        queries = read_sequences(args.queryfile)
        if dna_map is not None:
            from .io.translate import translate_entries
            dna_map.update(
                translate_entries(queries, mt=args.mt_translate))
        cfg = PlacementConfig(
            min_query_overlap=args.min_query_overlap,
            min_query_identity=args.min_query_identity,
            both_strands=args.both_strands,
            terminal_nodes=args.terminal_nodes,
            internal_nodes=args.internal_nodes,
            all_nodes=args.all_nodes,
            query_distance=args.query_distance,
            overlap_with_any=args.overlap_with_any,
            one_placement_only=args.one_placement_only,
            align_bad_reads_at_root=args.align_bad_reads_at_root,
            use_identity_score=args.use_identity_score,
            use_target_normalised_score=args.use_target_normalised_score,
            find_orfs=args.find_orfs,
            min_orf_length=args.min_orf_length,
            min_orf_coverage=args.min_orf_coverage,
            mt=args.mt_translate,
            exhaustive_placement=args.exhaustive_placement,
            guided=args.guided or args.no_preselection,
            score_only_ungapped=args.score_only_ungapped,
            score_ungapped_limit=args.score_ungapped_limit,
            assembly=args.assembly,
            fragments=args.fragments,
            rank_reads_for_nodes=args.rank_reads_for_nodes,
            tid_for_subroot=args.tid_for_subroot,
            score_as_dna=args.score_as_dna,
            compute_consensus=(args.use_consensus or
                               args.build_contigs or
                               args.output_consensus),
            # exonerate preselection equivalents
            # (settings.cpp:355-380, :415-417)
            preselect_keep_best=(
                0 if args.own_placement else
                1 if args.very_fast_placement else
                5 if args.fast_placement else
                (max(args.exonerate_local_keep_best, 0)
                 if args.use_exonerate_local else 0)))
        if cfg.score_as_dna and args.translate \
                and not args.terminal_nodes:
            # reads_aligner.cpp:2940: '--score-as-dna' with
            # '--translate' requires '--terminal-nodes'
            from .utils import log_out
            log_out("combination '--translate' and '--score-as-dna' "
                    "can only be used with option "
                    "'--terminal-nodes'!\n", 0)
            from dataclasses import replace as _replace
            cfg = _replace(cfg, terminal_nodes=True,
                           internal_nodes=False, all_nodes=False)
        outcome = place_queries(res, queries, data_type, cfg,
                                model_factory=mf, settings=settings,
                                mesh=mesh,
                                dna_map=dna_map)
        res = outcome.result
        if args.output_discarded_queries and outcome.discarded:
            from .io.fasta import write_fasta
            write_fasta(outcome.discarded,
                        f"{args.outfile}.discarded")
        if not args.silent:
            print(f"placed {len(outcome.placed)} queries, "
                  f"{len(outcome.discarded)} discarded")
    return res

def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    parser = build_parser()
    args = parser.parse_args(argv)
    cfg_path = args.config_file_opt or args.config_file
    cfg_args = []
    if cfg_path:
        if not os.path.exists(cfg_path):
            print("Config file '%s' not found. Exiting." % cfg_path,
                  file=sys.stderr)
            return 1
        # config args go first so explicit command-line arguments win.
        # Strip only the config-file tokens themselves — an unrelated
        # option VALUE that happens to equal the path (e.g.
        # `-o conf.ini`) must survive.
        cfg_args = config_file_args(cfg_path, parser)
        clean = []
        removed = False
        i = 0
        while i < len(argv):
            a = argv[i]
            if a == "--config-file":
                i += 2
                removed = True
                continue
            if a.startswith("--config-file="):
                i += 1
                removed = True
                continue
            if a == cfg_path and not removed and \
                    (i == 0 or not argv[i - 1].startswith("-")):
                i += 1
                removed = True
                continue
            clean.append(a)
            i += 1
        args = parser.parse_args(cfg_args + clean)
    if args.config_log_file:
        write_config_log(args.config_log_file, argv, cfg_args)
    # --use-aa-groups flips the protein alphabet globally before any
    # model or graph is built (define_protein_alphabet_groups,
    # model_factory.cpp:670-838)
    from .models import alphabets as _alph
    _alph.set_protein_groups(args.use_aa_groups)
    if args.jax_coordinator:
        # multi-host: join the distributed runtime before any jax call
        # initializes the local-only backend
        from .parallel.multihost import init_multihost
        init_multihost(args.jax_coordinator, args.jax_num_processes,
                       args.jax_process_id, args.jax_local_device)
    if args.version:
        from . import __version__
        print("pagan2-tpu v%s (JAX PAGAN2)" % __version__)
        # the reference's --version also checks upstream for updates
        # (check_version.cpp:35-90); degrades gracefully offline
        from .utils.check_version import check_version
        try:
            base = float(__version__.split(".")[0] + "." +
                         __version__.split(".")[1])
        except (IndexError, ValueError):
            base = 0.0
        check_version(base)
        return 0
    from .io.fasta import read_sequences
    from .utils import set_noise
    set_noise(-1 if args.silent else args.noise,
              log_file=args.log_output_file)

    import time as _time
    _t0 = _time.perf_counter()
    _phases = []

    def _tick(phase):
        if args.track_time:
            _phases.append((phase, _time.perf_counter()))

    def _report_time():
        if args.jax_profile:
            import jax
            jax.profiler.stop_trace()
            print("jax profiler trace -> %s" % args.jax_profile,
                  file=sys.stderr)
        if not args.track_time:
            return
        prev = _t0
        for phase, t in _phases:
            print("TIME %-24s %8.3f s" % (phase, t - prev),
                  file=sys.stderr)
            prev = t
        print("TIME %-24s %8.3f s" % ("total",
                                      _time.perf_counter() - _t0),
              file=sys.stderr)
        # real-run DP throughput from the executor's launch counters
        from .parallel.executor import EXEC_STATS
        cells = EXEC_STATS["batched_cells"]
        fs = EXEC_STATS["fill_seconds"]
        if cells and fs > 0:
            print("TIME %-24s %8.3g GCUPS (%d cells, %d launches, "
                  "%d batched + %d single fills)"
                  % ("dp-fill-rate", cells / fs / 1e9, cells,
                     EXEC_STATS["launches"], EXEC_STATS["batched_jobs"],
                     EXEC_STATS.get("single_fills", 0)),
                  file=sys.stderr)

    configure_compile_cache()

    if args.jax_profile:
        import jax
        jax.profiler.start_trace(args.jax_profile)

    if args.mpost_posterior_plot_file:
        from .io.plots import open_posterior_sink
        open_posterior_sink()
    if args.plot_anchors_for_r:
        from .align.anchors import set_r_plot_prefix
        set_r_plot_prefix(args.plot_anchors_for_r)
    if args.raxml_tree or args.bppdist_tree:
        print("note: --raxml-tree/--bppdist-tree map to the native "
              "k-mer NJ guide-tree inference", file=sys.stderr)

    if args.pileup:
        if not args.queryfile:
            print("--pileup requires -q/--queryfile", file=sys.stderr)
            return 1
        reads = read_sequences(args.queryfile)
        data_type = resolve_data_type(args, reads)
        _tick("read input")
        from .pipeline.pileup import pileup_align, PileupConfig
        cfg = PileupConfig(
            mode454=args.mode454, homopolymer=args.homopolymer,
            both_strands=args.both_strands,
            min_query_overlap=args.min_query_overlap,
            min_query_identity=args.min_query_identity,
            query_cluster_attempts=args.query_cluster_attempts,
            query_distance=args.query_distance,
            use_consensus=(args.use_consensus or args.build_contigs or
                           args.output_consensus),
            consensus_minimum=args.consensus_minimum,
            consensus_minimum_proportion=args.consensus_minimum_proportion,
            overlap_with_any=args.overlap_with_any,
            engine=args.engine,
            use_fastq=not args.no_fastq,
            qscore_minimum=args.qscore_minimum,
            allow_skip_low_qscore=args.allow_skip_low_qscore)
        psettings = make_settings(args)
        if args.find_orfs and data_type == "dna":
            from .pipeline.pileup import translated_pileup_align
            from .models import alphabets as _alph
            data_type = _alph.PROTEIN
            mf = make_model_factory(args, data_type, reads)
            res = translated_pileup_align(
                reads, cfg, model_factory=mf,
                min_orf_length=args.min_orf_length,
                min_orf_coverage=args.min_orf_coverage,
                mt=args.mt_translate, settings=psettings)
        else:
            mf = make_model_factory(args, data_type, reads)
            res = pileup_align(reads, data_type, cfg, model_factory=mf,
                               settings=psettings)
        _tick("pileup alignment")
        write_outputs(args, res.root, res.alignment, data_type)
        post_outputs(args, res.root, res.alignment, data_type)
        _tick("write output")
        if not args.silent:
            print(f"pileup: {len(res.alignment)} rows, "
                  f"{len(res.discarded)} reads discarded -> {args.outfile}")
        _report_time()
        return 0

    if args.ref_seqfile:
        # read an existing alignment as aligned (Reference_alignment;
        # main.cpp:181, node.h:909)
        entries = read_sequences(args.ref_seqfile)
        data_type = resolve_data_type(args, entries)
        data_type, dna_map = maybe_translate(args, entries, data_type)
        mf = make_model_factory(args, data_type, entries)
        settings = make_settings(args)
        if not args.ref_treefile:
            print("--ref-seqfile requires --ref-treefile", file=sys.stderr)
            return 1
        tree_text = open(args.ref_treefile).read()
        from .tree.newick import parse_newick as _parse_newick
        ref_tree = _parse_newick(tree_text)
        ref_tree.apply_branch_length_rules(
            min_len=args.min_branch_length,
            truncate=(None if args.real_branches
                      else args.truncate_branches),
            scale=args.scale_branches, fixed=args.fixed_branches,
            real_branches=args.real_branches)
        from .pipeline.refread import read_reference_alignment
        res = read_reference_alignment(
            entries, ref_tree, data_type=data_type, settings=settings,
            model_factory=mf, quick=args.quick,
            perfect_reference=args.perfect_reference)
        res = handle_queries(args, res, data_type, mf, settings,
                             dna_map, mesh=_make_mesh(args))
        full = res.alignment
        if args.output_ancestors or args.events:
            from .pipeline.progressive import extract_alignment
            full = extract_alignment(res.tree, True, data_type=data_type)
            if args.output_ancestors:
                res.alignment[:] = full
        write_outputs(args, res.tree, res.alignment, data_type)
        post_outputs(args, res.tree, full, data_type)
        _tick("write output")
        if dna_map is not None:
            write_codon_outputs(args, res.tree, res.alignment, dna_map)
        if not args.silent:
            n = len(res.alignment)
            l = len(res.alignment[0].sequence) if n else 0
            print(f"alignment: {n} rows x {l} cols -> {args.outfile}")
        _report_time()
        return 0

    if not args.seqfile:
        print("need -s/--seqfile (or --pileup -q reads)", file=sys.stderr)
        return 1

    entries = read_sequences(args.seqfile)
    data_type = resolve_data_type(args, entries)
    data_type, dna_map = maybe_translate(args, entries, data_type)
    mf = make_model_factory(args, data_type, entries)
    settings = make_settings(args)

    if args.treefile:
        tree_text = open(args.treefile).read()
    else:
        from .tree.inference import infer_guide_tree
        tree_text = infer_guide_tree(entries, data_type)

    from .tree.newick import parse_newick
    tree = parse_newick(tree_text)
    tree.apply_branch_length_rules(
        min_len=args.min_branch_length,
        truncate=None if args.real_branches else args.truncate_branches,
        scale=args.scale_branches, fixed=args.fixed_branches,
        real_branches=args.real_branches)

    mesh = _make_mesh(args)

    from .pipeline import align_progressive
    res = align_progressive(
        entries, tree, data_type=data_type, settings=settings,
        model_factory=mf, engine=args.engine,
        include_internal_nodes=args.output_ancestors,
        mode454=args.mode454, homopolymer=args.homopolymer, mesh=mesh,
        checkpoint_dir=args.checkpoint_dir)
    _tick("alignment")

    if args.queryfile:
        # the reference aligns -q queries after ANY alignment
        # (main.cpp:206-218), not only after --ref-seqfile
        res = handle_queries(args, res, data_type, mf, settings,
                             dna_map, mesh=mesh)
        _tick("query placement")

    full = res.alignment
    if args.output_ancestors or args.events:
        from .pipeline.ancestors import (reconstruct_parsimony_ancestors,
                                         reconstruct_ml_ancestors)
        # the parsimony pass is STRUCTURAL (pushes parent states into
        # unmatched sites, marks never-matched sites NON_REAL so the
        # extraction gaps them) and always runs; ML then refines the
        # states on top for <500 sequences (the in-framework
        # BppAncestors equivalent, input_output_parser.cpp:586-612 —
        # the reference also runs its own reconstruction before
        # feeding Bpp)
        reconstruct_parsimony_ancestors(res.tree, mf.alphabet)
        if not (args.no_bppancestors or len(entries) >= 500):
            try:
                reconstruct_ml_ancestors(res.tree, mf)
            except Exception:
                pass    # parsimony states already in place
        from .pipeline.progressive import extract_alignment
        full = extract_alignment(res.tree, True, data_type=data_type)
        if args.output_ancestors:
            res.alignment[:] = full
    _tick("ancestors")

    write_outputs(args, res.tree, res.alignment, data_type)
    post_outputs(args, res.tree, full, data_type)
    _tick("write output")
    if dna_map is not None:
        write_codon_outputs(args, res.tree, res.alignment, dna_map)
    if not args.silent:
        n = len(res.alignment)
        l = len(res.alignment[0].sequence) if n else 0
        print(f"alignment: {n} rows x {l} cols -> {args.outfile}")
    _report_time()
    return 0


if __name__ == "__main__":
    sys.exit(main())
