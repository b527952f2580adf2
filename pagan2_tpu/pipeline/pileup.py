"""Reference-free pileup alignment (--pileup), with 454/homopolymer error
modelling, overlap/identity acceptance, and consensus calling.

Equivalent of Reads_aligner::pileup_alignment
(src/main/reads_aligner.cpp:151-264) + read_alignment_scores
(:3323-3466) + Node::add_root_consensus (node.cpp:716-775).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..graph.builders import build_leaf_graph
from ..io.fasta import FastaEntry, clean_sequence
from ..models import ModelFactory, alphabets as alph
from ..align import align_pair, AlignSettings
from ..tree.newick import TreeNode

# DNA state -> display char for contig read rows (contigs are a
# DNA-only feature, input_output_parser.cpp:484-486)
_STATE_CHARS = alph.DNA_FULL_CHARS


@dataclass
class PileupConfig:
    mode454: bool = False
    homopolymer: bool = False
    both_strands: bool = False
    min_query_overlap: float = 0.5    # --min-query-overlap
    min_query_identity: float = 0.5   # --min-query-identity
    query_cluster_attempts: int = 1   # --query-cluster-attempts
    query_distance: float = 0.1       # --query-distance
    use_consensus: bool = False
    consensus_minimum: int = 5
    consensus_minimum_proportion: float = 0.5
    overlap_with_any: bool = False
    engine: str = "auto"
    use_fastq: bool = True            # not --no-fastq
    qscore_minimum: int = 10          # --qscore-minimum
    allow_skip_low_qscore: bool = False
    # the reference anchors EVERY pair (node.cpp:87-152); the engine's
    # global size gate (anchor_min_sites=3000) assumes cheap linear
    # cells, but deep-fan-in cells cost many times more, so read-vs-
    # root alignments anchor from 200 sites (identical output)
    anchor_reads_min_sites: int = 200


@dataclass
class PileupResult:
    root: TreeNode
    alignment: list[FastaEntry]
    consensus: str | None = None
    discarded: list[str] = field(default_factory=list)


def _has_site_and_state(node: TreeNode, j: int, name: str):
    """has_site_at_alignment_column / get_state_at_alignment_column
    (node.h:1107-1138): descend child indices from the root column to
    the named node — which may be internal (query placement targets).
    Iterative DFS (left first): the pileup ladder tree is one level
    deep per accepted read, so recursion would blow the stack on
    thousand-read piles."""
    stack = [(node, j)]
    while stack:
        n, jj = stack.pop()
        if n.name == name:
            return True, n.graph.states[jj]
        if n.is_leaf:
            continue
        g = n.graph
        lj = g.child_l[jj]
        rj = g.child_r[jj]
        if rj >= 0:
            stack.append((n.right, rj))
        if lj >= 0:
            stack.append((n.left, lj))
    return False, -2


def _any_other_has_site(node: TreeNode, j: int, name: str) -> bool:
    stack = [(node, j)]
    while stack:
        n, jj = stack.pop()
        if n.is_leaf:
            if n.name != name:
                return True
            continue
        g = n.graph
        lj = g.child_l[jj]
        rj = g.child_r[jj]
        if rj >= 0:
            stack.append((n.right, rj))
        if lj >= 0:
            stack.append((n.left, lj))
    return False


def read_alignment_scores(node: TreeNode, read_name: str,
                          ref_node_name: str, overlap_with_any=False):
    """(reads_aligner.cpp:3323-3466, DNA-as-protein path omitted)."""
    g = node.graph
    aligned = 0
    read_length = 0
    matched = 0
    # NB the loop includes the stop column (j = sites_length()-1),
    # exactly like the reference (reads_aligner.cpp:3356,3403: j <
    # sites_length()); both stop sites resolve as present with state
    # -1, inflating aligned/read_length by one but never matched —
    # replicated verbatim for threshold parity
    for j in range(1, g.num_sites()):
        read_has, state_read = _has_site_and_state(node, j, read_name)
        if overlap_with_any:
            other_has = _any_other_has_site(node, j, read_name)
            ref_has, state_ref = _has_site_and_state(node, j, ref_node_name)
            pair = read_has and other_has
        else:
            ref_has, state_ref = _has_site_and_state(node, j, ref_node_name)
            pair = read_has and ref_has
        if pair:
            if state_read >= 0 and state_read == state_ref:
                matched += 1
            aligned += 1
        if read_has:
            read_length += 1
    overlap = aligned / read_length if read_length else 0.0
    identity = matched / aligned if aligned else 0.0
    return overlap, identity


def pileup_align(reads: list[FastaEntry], data_type: str | None = None,
                 config: PileupConfig | None = None,
                 model_factory: ModelFactory | None = None,
                 settings: AlignSettings | None = None,
                 root_node: TreeNode | None = None) -> PileupResult:
    config = config or PileupConfig()
    # the pileup ladder grows one tree level per accepted read; raise
    # the recursion limit up front for the tree walkers
    from ..utils import ensure_recursion_for_depth
    ensure_recursion_for_depth(len(reads) + 10)
    if data_type is None:
        from ..io.fasta import guess_data_type
        data_type = guess_data_type(reads)

    if model_factory is None:
        pileup_454 = config.mode454 or config.homopolymer
        if data_type == alph.DNA:
            from ..io.fasta import empirical_dna_frequencies
            model_factory = ModelFactory(
                alph.DNA, dna_pi=empirical_dna_frequencies(reads),
                pileup_454=pileup_454)
        else:
            model_factory = ModelFactory(data_type)

    settings = (settings or AlignSettings()).for_reads() \
        .with_reads_anchor_gate(config.anchor_reads_min_sites)
    gkw = dict(mode454=config.mode454, homopolymer=config.homopolymer)

    def leaf(read: FastaEntry, turn_rc=False) -> TreeNode:
        seq = clean_sequence(read.sequence, data_type)
        n = TreeNode(name=read.name, dist=config.query_distance)
        q = read.quality if (config.use_fastq
                             and len(read.quality) == len(seq)) else ""
        n.graph = build_leaf_graph(
            seq, data_type, turn_revcomp=turn_rc, quality=q,
            qscore_minimum=config.qscore_minimum,
            allow_skip_low_qscore=config.allow_skip_low_qscore, **gkw)
        n.graph.is_read_sequence = True
        n.graph.num_duplicates = read.num_duplicates
        return n

    # --align-reads-at-root: stack every read onto an existing root
    # (reads_aligner.cpp:92,156-158: start_i = 0 with a ref alignment)
    if root_node is not None:
        ref_root_name = root_node.name
        global_root = root_node
        read_list = reads
    else:
        ref_root_name = reads[0].name
        global_root = leaf(reads[0])
        global_root.dist = 0.001
        read_list = reads[1:]

    # ladder node numbering starts past any #N# names already in the
    # root tree (--align-reads-at-root hands us a named reference tree;
    # a colliding name would make read_alignment_scores resolve the
    # wrong node)
    count = 2
    if root_node is not None:
        import re as _re
        for n in root_node.nodes_postorder():
            m = _re.fullmatch(r"#(\d+)#", n.name or "")
            if m:
                count = max(count, int(m.group(1)) + 1)
    # per-ENTRY bookkeeping, like the reference's cluster_attempts
    # field on Fasta_entry — duplicate read NAMES must not collapse
    attempts = {id(r): 0 for r in reads}
    accepted_ids: set[int] = set()
    model = model_factory.alignment_model(0.001 + config.query_distance)

    from ..utils import log_progress, finish_progress
    for _round in range(config.query_cluster_attempts):
        for ri, read in enumerate(read_list):
            if attempts[id(read)] >= config.query_cluster_attempts:
                continue
            attempts[id(read)] += 1
            # "aligning read X (k/n)" progress (reads_aligner.cpp:176)
            log_progress("aligning read %s (%d/%d)"
                         % (read.name, ri + 1, len(read_list)), 0)

            def finish_strand(rnode, anc):
                if anc is None:   # anchoring-threshold skip
                    return None, -1.0, -1.0
                temp = TreeNode(name=f"#{count}#",
                                children=[global_root, rnode])
                temp.left.dist = 0.001
                anc.is_read_sequence = True
                anc.has_read_descendants = True
                temp.graph = anc
                ov, ident = read_alignment_scores(
                    temp, read.name, ref_root_name,
                    overlap_with_any=config.overlap_with_any)
                return temp, ov, ident

            ov_rc, ident_rc = -1.0, -1.0
            node_rc = None
            if config.both_strands and data_type == alph.DNA:
                # the forward and reverse-complement alignments are
                # independent: one batched launch for both strands
                # (task-parallel intent of reads_aligner.cpp:190-217)
                from ..parallel.executor import (PairJob,
                                                 execute_pair_jobs)
                rfwd = leaf(read)
                rrc = leaf(read, turn_rc=True)
                jobs = [PairJob(left=global_root.graph, right=rn.graph,
                                model=model, settings=settings,
                                left_branch_length=0.001,
                                right_branch_length=config.query_distance,
                                is_reads_sequence=True,
                                compute_consensus=config.use_consensus)
                        for rn in (rfwd, rrc)]
                res = execute_pair_jobs(jobs, engine=config.engine)
                node, ov, ident = finish_strand(rfwd, res[0][0])
                node_rc, ov_rc, ident_rc = finish_strand(rrc, res[1][0])
            else:
                rnode = leaf(read)
                anc, _ = align_pair(global_root.graph, rnode.graph,
                                    model, settings,
                                    left_branch_length=0.001,
                                    right_branch_length=config.query_distance,
                                    is_reads_sequence=True,
                                    engine=config.engine,
                                    compute_consensus=config.use_consensus)
                node, ov, ident = finish_strand(rnode, anc)

            if ov > ov_rc and ov > config.min_query_overlap and \
                    ident > config.min_query_identity:
                global_root = node
                count += 1
                accepted_ids.add(id(read))
                attempts[id(read)] = config.query_cluster_attempts
            elif ov_rc > config.min_query_overlap and \
                    ident_rc > config.min_query_identity:
                global_root = node_rc
                count += 1
                accepted_ids.add(id(read))
                attempts[id(read)] = config.query_cluster_attempts
            else:
                # rejection costs an extra attempt (reads_aligner.cpp:251)
                attempts[id(read)] += 1
    finish_progress()

    discarded = [r.name for r in read_list
                 if id(r) not in accepted_ids]
    alignment = _extract(global_root)
    consensus = None
    if config.use_consensus:
        consensus = call_consensus(global_root, config)
        alignment.append(FastaEntry(name="consensus", sequence=consensus))
    return PileupResult(root=global_root, alignment=alignment,
                        consensus=consensus, discarded=discarded)


def translated_pileup_align(reads: list[FastaEntry],
                            config: PileupConfig | None = None,
                            model_factory: ModelFactory | None = None,
                            min_orf_length: int = 50,
                            min_orf_coverage: float | None = None,
                            mt: bool = False,
                            settings: AlignSettings | None = None
                            ) -> PileupResult:
    """Pileup with ORF search (--pileup --find-orfs on DNA reads):
    each read's six-frame ORFs are aligned as protein against the growing
    root; the best ORF by overlap wins and is accepted under the usual
    overlap/identity thresholds
    (Reads_aligner::translated_pileup_alignment,
    reads_aligner.cpp:266-370). Deviation from the reference: the root is
    the first read's longest ORF (the reference relies on the input
    parser having translated the root read)."""
    from .orfs import find_orfs
    from ..utils import ensure_recursion_for_depth
    ensure_recursion_for_depth(len(reads) + 10)
    config = config or PileupConfig()
    if model_factory is None:
        model_factory = ModelFactory(alph.PROTEIN)
    settings = (settings or AlignSettings()).for_reads() \
        .with_reads_anchor_gate(config.anchor_reads_min_sites)

    def orf_leaf(name: str, orf) -> TreeNode:
        n = TreeNode(name=name, dist=config.query_distance)
        n.graph = build_leaf_graph(orf.translation, alph.PROTEIN)
        n.graph.is_read_sequence = True
        return n

    root_orfs = find_orfs(reads[0].sequence, reads[0].name,
                          min_orf_length, min_orf_coverage, mt=mt)
    if not root_orfs:
        raise ValueError("no ORFs in the first (root) read '%s'"
                         % reads[0].name)
    root_orf = max(root_orfs, key=lambda o: len(o.translation))
    ref_root_name = reads[0].name
    global_root = orf_leaf(ref_root_name, root_orf)
    global_root.dist = 0.001

    count = 2
    attempts = {id(r): 0 for r in reads}
    accepted_ids: set[int] = set()
    model = model_factory.alignment_model(0.001 + config.query_distance)

    for _round in range(config.query_cluster_attempts):
        for read in reads[1:]:
            if attempts[id(read)] >= config.query_cluster_attempts:
                continue
            attempts[id(read)] += 1
            orfs = find_orfs(read.sequence, read.name, min_orf_length,
                             min_orf_coverage, mt=mt)
            if not orfs:
                continue
            best = None           # (node, orf, overlap, identity)
            for orf in orfs:
                rnode = orf_leaf(read.name, orf)
                temp = TreeNode(name=f"#{count}#",
                                children=[global_root, rnode])
                temp.left.dist = 0.001
                anc, _ = align_pair(
                    global_root.graph, rnode.graph, model, settings,
                    left_branch_length=0.001,
                    right_branch_length=config.query_distance,
                    is_reads_sequence=True, engine=config.engine)
                if anc is None:   # anchoring-threshold skip
                    continue
                anc.is_read_sequence = True
                temp.graph = anc
                ov, ident = read_alignment_scores(
                    temp, read.name, ref_root_name,
                    overlap_with_any=config.overlap_with_any)
                # best-ORF rule of reads_aligner.cpp:318-320 — NB the
                # reference's tie-break really compares the candidate's
                # own overlap to its own identity (not to the
                # incumbent's); replicated verbatim
                if best is None or ov > best[2] or \
                        (ov == best[2] and ov > ident):
                    best = (temp, orf, ov, ident)
            if best is None:
                # every ORF alignment was skipped by the
                # anchoring-threshold heuristic
                continue
            node, orf, ov, ident = best
            if ov > config.min_query_overlap and \
                    ident > config.min_query_identity:
                node.right.name = read.name + "_orf1"
                node.right.comment = "[%d.%d.%d]" % (orf.frame,
                                                     orf.start + 1,
                                                     orf.end + 1)
                global_root = node
                count += 1
                accepted_ids.add(id(read))
                attempts[id(read)] = config.query_cluster_attempts

    discarded = [r.name for r in reads[1:]
                 if id(r) not in accepted_ids]
    alignment = _extract(global_root)
    return PileupResult(root=global_root, alignment=alignment,
                        discarded=discarded)


def _extract(root: TreeNode) -> list[FastaEntry]:
    from .progressive import extract_alignment
    if root.is_leaf:
        g = root.graph
        return [FastaEntry(name=root.name,
                           sequence="".join(g.symbols[1:g.num_sites() - 1]))]
    return extract_alignment(root, include_internal_nodes=False,
                             data_type=root.graph.data_type)


def call_consensus(root: TreeNode, config: PileupConfig) -> str:
    """add_root_consensus (node.cpp:716-775): IUPAC majority calling from
    pileup counts with a minimum-count threshold."""
    g = root.graph
    n_leaves = root.num_leaves()
    min_num = int(n_leaves * config.consensus_minimum_proportion)
    if min_num < config.consensus_minimum:
        min_num = config.consensus_minimum

    out = []
    for j in range(1, g.num_sites() - 1):
        sA, sC = g.sumA[j], g.sumC[j]
        sG, sT = g.sumG[j], g.sumT[j]
        if sA + sC + sG + sT < min_num:
            out.append("-")
            continue
        c = _iupac_majority(sA, sC, sG, sT)
        out.append(c)
    return "".join(out)


def reconstruct_contigs(root: TreeNode, config: PileupConfig,
                        consensus_only: bool = False,
                        include_parent: bool = False,
                        show_ancestor: bool = False) -> list[FastaEntry]:
    """Node::reconstruct_contigs (node.h:1894-2081): one consensus row
    per maximal read-descendant subtree; --inlude-parent-in-contig [sic]
    adds the reference parent row, --show-contig-ancestor shows the
    ancestral state (lowercase) at read-free reference sites."""
    out: list[FastaEntry] = []

    def parent_name_of(node: TreeNode) -> str:
        # find_first_nonread_left_parent: descend leftmost until a
        # non-read node
        n = node
        while not n.is_leaf and n.graph is not None and \
                getattr(n.left.graph, "is_read_sequence", False):
            n = n.left
        return n.left.name if not n.is_leaf else n.name

    def walk(node: TreeNode, parent_is_read: bool):
        g = node.graph
        is_read = bool(g is not None and
                       (g.is_read_sequence or
                        getattr(g, "has_read_descendants", False)))
        if not parent_is_read and is_read and g is not None:
            pname = parent_name_of(node)
            show_ref_insertions = False
            if include_parent and not node.is_leaf:
                ref_row = []
                for j in range(1, g.num_sites() - 1):
                    lj = g.child_l[j]
                    st = node.left.graph.states[lj] if lj >= 0 else -1
                    sym = (node.left.graph.symbols[lj]
                           if lj >= 0 and st >= 0 else "-")
                    ref_row.append(sym if sym not in ("", "0") else "-")
                out.append(FastaEntry(name=pname,
                                      sequence="".join(ref_row)))
                show_ref_insertions = True
            n_leaves = node.num_leaves()
            min_num = int(n_leaves * config.consensus_minimum_proportion)
            if min_num < config.consensus_minimum:
                min_num = config.consensus_minimum
            from ..graph.sequence_graph import XSKIPPED, YSKIPPED
            read_names = [l.name for l in node.leaves()
                          if getattr(l.graph, "is_read_sequence",
                                     False)] \
                if not consensus_only else []
            read_rows = {nm: [] for nm in read_names}
            seq = []
            for j in range(1, g.num_sites() - 1):
                sA, sC = g.sumA[j], g.sumC[j]
                sG, sT = g.sumG[j], g.sumT[j]
                in_ref = g.child_l[j] >= 0 and not node.is_leaf and \
                    not getattr(node.left.graph, "is_read_sequence", False)
                if in_ref and sA + sC + sG + sT == 0:
                    if g.path_state[j] not in (XSKIPPED, YSKIPPED):
                        sym = g.symbols[j]
                        if show_ancestor and sym not in ("", "0"):
                            seq.append(sym.lower())
                        else:
                            seq.append("n")
                    elif show_ref_insertions:
                        seq.append("-")
                    else:
                        continue      # column not emitted
                elif not in_ref and sA + sC + sG + sT < min_num:
                    seq.append("-")
                else:
                    seq.append(_iupac_majority(sA, sC, sG, sT))
                for nm in read_names:
                    has, st = _has_site_and_state(node, j, nm)
                    read_rows[nm].append(
                        _STATE_CHARS[st] if has and 0 <= st <
                        len(_STATE_CHARS) else "-")
            out.append(FastaEntry(name="consensus_" + pname,
                                  sequence="".join(seq), comment=pname))
            # without --consensus-only the reference appends each
            # read's aligned row after its subtree's consensus
            # (node.h:2066-2073, get_alignment_for_reads)
            for nm in read_names:
                out.append(FastaEntry(name=nm,
                                      sequence="".join(read_rows[nm])))
            return
        if not node.is_leaf:
            walk(node.left, is_read)
            walk(node.right, is_read)

    walk(root, False)
    return out


def _iupac_majority(sA, sC, sG, sT):
    """The exact comparison ladder of node.cpp:742-772."""
    if sA > sC and sA > sG and sA > sT:
        return "A"
    if sC > sA and sC > sG and sC > sT:
        return "C"
    if sG > sA and sG > sC and sG > sT:
        return "G"
    if sT > sA and sT > sC and sT > sG:
        return "T"
    if sA > sC and sA == sG and sA > sT:
        return "R"
    if sC > sA and sC > sG and sC == sT:
        return "Y"
    if sA == sC and sA > sG and sA > sT:
        return "M"
    if sG > sA and sG > sC and sG == sT:
        return "K"
    if sA > sC and sA > sG and sA == sT:
        return "W"
    if sC > sA and sC == sG and sC > sT:
        return "S"
    if sC > sA and sC == sG and sC == sT:
        return "B"
    if sA > sC and sA == sG and sA == sT:
        return "D"
    if sA == sC and sA > sG and sA == sT:
        return "H"
    if sA == sC and sA == sG and sA > sT:
        return "V"
    if sA == sC and sA == sG and sA == sT:
        return "N"
    return "N"
