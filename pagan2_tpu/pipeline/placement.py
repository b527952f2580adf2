"""Query placement: add reads/queries onto an existing reference
alignment + tree.

Equivalent of Reads_aligner::query_placement_one
(src/main/reads_aligner.cpp:623-911): per query, score candidate target
nodes (read_match_score, :3467-3551 — a quick pairwise alignment and a
substitution-score ratio), align the query against the best node's
graph, accept by overlap/identity (read_alignment_scores, :3323-3466),
splice a new parent into the tree and patch the old parent's child
site indices (correct_sites_index, :3552-3675), re-estimate the local
branch lengths (fix_branch_lengths, :1225-1336) and push parsimony
states down one level (Node::reconstruct_one_parsimony_ancestor,
node.h:1075-1105).

The exonerate/NCBI-BLAST preselection subprocesses of the reference are
replaced by scoring every candidate node with the same quick pairwise
kernel (the reference's own fallback when exonerate is absent); the
candidate set is controlled like the reference's --terminal-nodes /
--internal-nodes / --all-nodes flags.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

from ..graph.builders import build_leaf_graph, revcomp
from ..io.fasta import FastaEntry, clean_sequence
from ..models import ModelFactory, alphabets as alph
from ..align import align_pair, AlignSettings
from ..tree.newick import TreeNode
from .pileup import read_alignment_scores
from .progressive import ProgressiveResult, extract_alignment


@dataclass
class PlacementConfig:
    min_query_overlap: float = 0.5    # --min-query-overlap
    min_query_identity: float = 0.5   # --min-query-identity
    query_distance: float = 0.1       # --query-distance
    both_strands: bool = False
    terminal_nodes: bool = False
    internal_nodes: bool = False
    all_nodes: bool = False
    one_placement_only: bool = False
    align_bad_reads_at_root: bool = False
    overlap_with_any: bool = False
    use_identity_score: bool = False          # --use-identity-score
    use_target_normalised_score: bool = False  # --use-target-normalised-score
    engine: str = "auto"
    find_orfs: bool = False           # --find-orfs (DNA queries vs
    min_orf_length: int = 50          #   protein reference)
    min_orf_coverage: float | None = None
    mt: bool = False
    # --exhaustive-placement: no multiple placement on score ties
    # (reads_aligner.cpp:1936,2084: also retries exonerate-discarded
    # reads against every node — our native scoring never discards, so
    # only the tie rule applies)
    exhaustive_placement: bool = False
    # the reference anchors EVERY pair (node.cpp:87-152); like the
    # pileup's anchor_reads_min_sites, query-vs-node alignments anchor
    # from 200 sites (deep-fan-in cells cost many times more than the
    # linear cells the global 3000 gate assumes)
    anchor_reads_min_sites: int = 200
    # --guided / --no-preselection: restrict candidates to nodes whose
    # NHX TID tag matches the query's TID= comment (settings.cpp:421-425)
    guided: bool = False
    # --score-only-ungapped / --score-ungapped-limit: drop alignment
    # columns whose gap fraction >= limit from node scoring
    # (reads_aligner.cpp:3933-3954)
    score_only_ungapped: bool = False
    score_ungapped_limit: float = 0.1
    # --assembly: placement at the subroot only (settings.cpp:279)
    assembly: bool = False
    # --fragments: group queries by target node and insert them
    # best-score-first per node (query_placement_all,
    # reads_aligner.cpp:372-621; sort_reads_vector :468)
    fragments: bool = False
    # --rank-reads-for-nodes: score a query even when its TID matches a
    # single node, so within-node ordering reflects real match scores
    # (reads_aligner.cpp:2748)
    rank_reads_for_nodes: bool = False
    # --tid-for-subroot: a spliced parent inherits the target's NHX TID
    # tag (reads_aligner.cpp:858-862)
    tid_for_subroot: bool = False
    # --score-as-dna (+ --translate --terminal-nodes): score placement
    # candidates against the original DNA instead of the translated
    # protein (reads_aligner.cpp:2930-2942)
    score_as_dna: bool = False
    # --fast-placement (5) / --very-fast-placement (1) /
    # --exonerate-local-keep-best N: cheap k-mer preselection keeps only
    # the N most-similar candidate nodes before full pairwise scoring —
    # the native replacement for the reference's exonerate subprocess
    # preselection (settings.cpp:355-380, reads_aligner.cpp:1841-1994).
    # 0 disables preselection (--own-placement).
    preselect_keep_best: int = 0
    # accumulate pileup consensus counts in spliced graphs (needed by
    # --output-consensus/--build-contigs on placement runs)
    compute_consensus: bool = False


@dataclass
class PlacementOutcome:
    result: ProgressiveResult
    discarded: list[FastaEntry] = field(default_factory=list)
    placed: list[str] = field(default_factory=list)


def _node_sort_key(name: str):
    """Reads_aligner::node_is_smaller: numeric-aware #N# ordering."""
    m = re.fullmatch(r"#(\d+)#", name)
    if m:
        return (0, int(m.group(1)), name)
    return (1, 0, name)


def _candidate_names(tree: TreeNode, cfg: PlacementConfig,
                     query_tid: str = "") -> list[str]:
    """get_target_node_names (reads_aligner.h): terminal / internal /
    all candidate nodes; with --guided/--no-preselection, only nodes
    whose NHX TID tag matches the query's TID= comment (falling back
    to all nodes when the tree carries no tags)."""
    if cfg.assembly:
        return [tree.name]
    if cfg.guided:
        tagged = [n for n in tree.nodes_postorder()
                  if getattr(n, "nhx_tid", "")]
        if tagged:
            return [n.name for n in tagged
                    if not query_tid or n.nhx_tid == query_tid]
    if cfg.internal_nodes:
        nodes = [n for n in tree.nodes_postorder() if not n.is_leaf]
    elif cfg.terminal_nodes:
        nodes = list(tree.leaves())
    else:
        nodes = list(tree.nodes_postorder())
    return [n.name for n in nodes]


def _nodes_by_name(tree: TreeNode) -> dict[str, TreeNode]:
    return {n.name: n for n in tree.nodes_postorder()}


def _parent_of(tree: TreeNode, name: str) -> TreeNode | None:
    for n in tree.nodes_postorder():
        if not n.is_leaf and (n.left.name == name or n.right.name == name):
            return n
    return None


def _read_match_score(target: TreeNode, read_graph, model, settings,
                      cfg: PlacementConfig) -> float:
    """read_match_score (reads_aligner.cpp:3467-3551): quick pairwise
    alignment target-vs-read, then score_r = subst / max_subst_read
    (or identity / target-normalised variants)."""
    anc, _ = align_pair(target.graph, read_graph, model, settings,
                        left_branch_length=0.001,
                        right_branch_length=cfg.query_distance,
                        is_reads_sequence=True, engine=cfg.engine)
    return _match_score_from_anc(anc, target.graph, read_graph, model,
                                 cfg)


def _preselect_candidates(entry, cand, nodes_map, keep_best: int,
                          data_type: str = alph.DNA, cache=None,
                          k: int = 11) -> list[str]:
    """--fast-placement / --very-fast-placement: native stand-in for
    the exonerate preselection subprocess (settings.cpp:355-380,
    reads_aligner.cpp:1841-1994) — keep the `keep_best` candidate
    nodes sharing the most k-mers with the query (DNA counts both
    strands) before the full quick-pairwise scoring. `cache` (one dict
    per placement run) holds each node's k-mer set so Q queries cost
    O(nodes + Q*qlen), not O(Q*nodes*len)."""
    if keep_best <= 0 or len(cand) <= keep_best:
        return cand
    if data_type == alph.PROTEIN:
        k = 5
    q = entry.sequence.upper().replace("-", "")
    k = min(k, max(len(q) // 2, 3))
    qk = {q[i:i + k] for i in range(len(q) - k + 1)}
    if data_type == alph.DNA:
        qrc = revcomp(q)
        qk |= {qrc[i:i + k] for i in range(len(qrc) - k + 1)}
    if cache is None:
        cache = {}

    def node_kmers(nm):
        key = (nm, k)
        got = cache.get(key)
        if got is None:
            s = "".join(nodes_map[nm].graph.unaligned_symbols()).upper()
            # a SET so a k-mer repeated in the node counts once: list
            # counting biased preselection toward repetitive /
            # homopolymer-rich nodes relative to a shared-k-mer count
            # (ADVICE r4)
            got = {s[i:i + k] for i in range(len(s) - k + 1)}
            cache[key] = got
        return got

    def kmer_score(nm):
        return len(node_kmers(nm) & qk)

    scored = sorted(cand, key=kmer_score, reverse=True)
    return [nm for nm in cand if nm in set(scored[:keep_best])]


def _build_score_jobs(entry, cand, nodes_map, fwd_graph, rc_graph, model,
                      settings, cfg: PlacementConfig, dna_model=None,
                      dna_map=None):
    """Candidate-scoring jobs for one query: every (node x strand)
    alignment as an independent PairJob for a batched launch
    (task-parallel form of find_nodes_for_query,
    reads_aligner.cpp:1996-2278). Graph copies keep scoring
    side-effect-free on the live tree. With --score-as-dna and a
    --translate'd run, candidates score against the original DNA
    (reads_aligner.cpp:2930-2942). Returns (jobs, scoring_model,
    strands_per_candidate)."""
    import copy as _copy
    from ..parallel.executor import PairJob
    qdna = (dna_map or {}).get(entry.name) or entry.dna_sequence
    use_dna = (dna_model is not None and qdna
               and all(nm in (dna_map or {}) for nm in cand))
    if use_dna:
        fwd = build_leaf_graph(clean_sequence(qdna, alph.DNA), alph.DNA)
        fwd.is_read_sequence = True
        strand_copies = [fwd]
        if rc_graph is not None:
            rc = build_leaf_graph(clean_sequence(qdna, alph.DNA),
                                  alph.DNA, turn_revcomp=True)
            rc.is_read_sequence = True
            strand_copies.append(rc)
        tgt = {nm: build_leaf_graph(
            clean_sequence(dna_map[nm], alph.DNA), alph.DNA)
            for nm in cand}
        smodel = dna_model
    else:
        # one target copy per candidate and one read copy per strand,
        # shared across that query's jobs (the sequential path shared
        # the live graphs the same way)
        strand_copies = [_copy.deepcopy(fwd_graph)]
        if rc_graph is not None:
            strand_copies.append(_copy.deepcopy(rc_graph))
        tgt = {nm: _copy.deepcopy(nodes_map[nm].graph) for nm in cand}
        smodel = model
    jobs = []
    for name in cand:
        for g in strand_copies:
            jobs.append(PairJob(
                left=tgt[name], right=g, model=smodel,
                settings=settings, left_branch_length=0.001,
                right_branch_length=cfg.query_distance,
                is_reads_sequence=True, key=name))
    return jobs, smodel, len(strand_copies)


def _pick_best_nodes(cand, scores, per_strand, cfg: PlacementConfig):
    """Tie-aware target choice from per-(node x strand) scores
    (find_nodes_for_query score comparison, reads_aligner.cpp:2170-2260
    — ties append AND update query_strand to the tying strand; '>='
    replaces, so under --one-placement-only the LAST tied candidate
    wins, both exactly like the reference).
    Returns (best_score, best_nodes, best_strand_rev)."""
    best_score = -float("inf")
    best_nodes: list[str] = []
    best_strand_rev = False
    for ci, name in enumerate(cand):
        sc = scores[ci * per_strand]
        if sc == best_score and not cfg.one_placement_only \
                and not cfg.exhaustive_placement:
            best_nodes.append(name)
            best_strand_rev = False
        elif sc >= best_score:
            best_score = sc
            best_nodes = [name]
            best_strand_rev = False
        if per_strand == 2:
            sc = scores[ci * per_strand + 1]
            if sc == best_score and not cfg.one_placement_only \
                    and not cfg.exhaustive_placement:
                best_nodes.append(name)
                best_strand_rev = True
            elif sc >= best_score:
                best_score = sc
                best_nodes = [name]
                best_strand_rev = True
    return best_score, best_nodes, best_strand_rev


def _match_score_from_anc(anc, lg, rg, model,
                          cfg: PlacementConfig) -> float:
    """Scoring half of read_match_score over a finished alignment."""
    if anc is None:   # anchoring-threshold skip (node.cpp:155-186)
        return -float("inf")
    matching = 0
    subst = 0.0
    max_l = 0.0
    max_r = 0.0
    for k in range(1, anc.num_sites() - 1):
        lj = anc.child_l[k]
        rj = anc.child_r[k]
        if cfg.score_only_ungapped and (lj < 0 or rj < 0):
            # --score-only-ungapped: columns whose gap fraction >=
            # score-ungapped-limit are not scored
            # (reads_aligner.cpp:3933-3954; for a 2-row temp node any
            # gapped column is over the default 0.1 limit)
            if 0.5 >= cfg.score_ungapped_limit:
                continue
        if lj >= 0 and rj >= 0:
            s_read = rg.states[rj]
            s_tgt = lg.states[lj]
            if s_read == s_tgt:
                matching += 1
            subst += model.score[s_tgt, s_read]
            max_l += model.score[s_tgt, s_tgt]
        if rj >= 0:
            s_read = rg.states[rj]
            max_r += model.score[s_read, s_read]
    if cfg.use_identity_score:
        return matching / max(rg.num_sites(), 1)
    if cfg.use_target_normalised_score:
        return subst / max_l if max_l else 0.0
    return subst / max_r if max_r else 0.0


def _correct_sites_index(new_node: TreeNode, ref_node_name: str,
                         tree: TreeNode) -> bool:
    """correct_sites_index (reads_aligner.cpp:3552-3675): splice
    new_node in place of the node named ref_node_name and shift the
    parent's child site indices by the number of read-insertion sites
    preceding each referenced site."""
    g = new_node.graph
    # sites_index[k] = inserted sites immediately before the k-th
    # target-matching site of the new graph (target is the left child)
    sites_index = []
    delta = 0
    for j in range(g.num_sites()):
        if g.child_l[j] >= 0:
            sites_index.append(delta)
            delta = 0
        else:
            delta += 1

    parent = _parent_of(tree, ref_node_name)
    if parent is None:
        return False
    is_left = parent.left.name == ref_node_name
    if is_left:
        parent.children[0] = new_node
    else:
        parent.children[1] = new_node

    pg = parent.graph
    child = pg.child_l if is_left else pg.child_r
    first = 0
    for j in range(1, pg.num_sites()):
        ci = child[j]
        if ci > 0:
            first = ci
            break
    delta = sum(sites_index[:first])
    for j in range(1, pg.num_sites()):
        ci = child[j]
        if ci >= 0:
            delta += sites_index[ci]
            child[j] = ci + delta
    if delta > 0:
        tree.site_index_corrected = True
    return True


def _fix_branch_lengths(tree: TreeNode, new_node: TreeNode,
                        data_type: str):
    """fix_branch_lengths (reads_aligner.cpp:1225-1336): re-estimate
    the three local branch lengths from identity fractions in the
    parent's subtree alignment."""
    parent = _parent_of(tree, new_node.name)

    def rows(sub: TreeNode) -> dict[str, str]:
        entries = extract_alignment(sub, include_internal_nodes=True,
                                    data_type=data_type)
        return {e.name: e.sequence for e in entries}

    if parent is not None:
        r = rows(parent)
        pnode = r.get(parent.name, "")
        lnode = r.get(new_node.left.name, "")
        rnode = r.get(new_node.right.name, "")
        share12 = share13 = share23 = 0
        ident12 = ident13 = ident23 = 0
        for p, l, rr in zip(pnode, lnode, rnode):
            if p not in "-.":
                if l not in "-.":
                    share12 += 1
                    if p == l:
                        ident12 += 1
                if rr not in "-.":
                    share13 += 1
                    if p == rr:
                        ident13 += 1
            if l not in "-." and rr not in "-.":
                share23 += 1
                if l == rr:
                    ident23 += 1
        if not (share12 and share13 and share23):
            return
        d12 = 1 - ident12 / share12
        d13 = 1 - ident13 / share13
        d23 = 1 - ident23 / share23
        l2 = 0.5 * d23 + 0.5 * (d12 - d13)
        l3 = 0.5 * d23 + 0.5 * (d13 - d12)
        l1 = 0.5 * (d12 + d13 - d23)
        mult = 1.0
        if (l1 + l2) > 0:
            mult = (new_node.dist + new_node.left.dist) / (l1 + l2)
        new_node.dist = l1 * mult
        new_node.left.dist = l2 * mult
        new_node.right.dist = l3 * mult
    else:
        r = rows(new_node)
        lnode = r.get(new_node.left.name, "")
        rnode = r.get(new_node.right.name, "")
        share = ident = 0
        for l, rr in zip(lnode, rnode):
            if l not in "-." and rr not in "-.":
                share += 1
                if l == rr:
                    ident += 1
        if share:
            d = (1 - ident / share) / 2
            new_node.left.dist = d
            new_node.right.dist = d


def _reconstruct_one_parsimony(tree: TreeNode, new_node: TreeNode,
                               mf: ModelFactory):
    """Node::reconstruct_one_parsimony_ancestor (node.h:1075-1105):
    after a splice, refine the new child's states one level down."""
    parent = _parent_of(tree, new_node.name)
    if parent is None or new_node.is_leaf:
        return
    alphabet = mf.alphabet
    pg = parent.graph
    cg = new_node.graph
    is_left = parent.left.name == new_node.name
    child = pg.child_l if is_left else pg.child_r
    for i in range(1, pg.num_sites() - 1):
        ci = child[i]
        if ci >= 0:
            cg.states[ci] = alphabet.child_parsimony[pg.states[i],
                                                     cg.states[ci]]


def _select_best_orf(entry, cand, nodes_map, model, settings,
                     cfg: PlacementConfig, data_type: str):
    """Translated placement (translated_query_placement_one/_all,
    reads_aligner.cpp:~2450+, :1353-1436): enumerate six-frame ORFs of
    the DNA query, choose the ORF scoring best against any candidate
    node, and return a protein entry for its translation (None when the
    query has no long-enough ORF)."""
    from .orfs import find_orfs as _find_orfs
    orfs = _find_orfs(entry.sequence, entry.name,
                      cfg.min_orf_length, cfg.min_orf_coverage,
                      mt=cfg.mt)
    if not orfs:
        return None

    def orf_score(o):
        g = build_leaf_graph(o.translation, data_type)
        g.is_read_sequence = True
        if len(cand) == 1:
            return len(o.translation)
        return max(_read_match_score(nodes_map[nm], g, model,
                                     settings, cfg)
                   for nm in cand)

    best_orf = max(orfs, key=orf_score)
    return FastaEntry(
        name=entry.name + "_orf1",
        sequence=best_orf.translation,
        comment="[%d.%d.%d]" % (best_orf.frame,
                                best_orf.start + 1,
                                best_orf.end + 1),
        dna_sequence=entry.sequence)


def _read_leaf(entry: FastaEntry, rc: bool, data_type: str,
               cfg: PlacementConfig) -> TreeNode:
    seq = clean_sequence(entry.sequence, data_type)
    n = TreeNode(name=entry.name, dist=cfg.query_distance)
    n.graph = build_leaf_graph(seq, data_type, turn_revcomp=rc)
    n.graph.is_read_sequence = True
    return n


def _align_accept_splice(tree, target, ref_node_name, entry, rev_hint,
                         single_cand, count, orig_dist, cfg, model,
                         settings, data_type, model_factory,
                         compare_reverse, min_ov, min_id, name_counts,
                         placed, single_ref):
    """The shared insertion tail of query_placement_one/_all
    (reads_aligner.cpp:727-911 / :483-620): align the query against
    `target` (strand chosen during scoring skips the other alignment,
    query_strand :727-750), accept by overlap/identity, splice the new
    parent into the tree (correct_sites_index), inherit TID when
    --tid-for-subroot, fix local branch lengths, push parsimony one
    level. `orig_dist` is the caller-carried distance budget (read per
    query in the per-query mode, per group in --fragments, as the
    reference does). Returns (accepted, tree, single_ref, count,
    orig_dist, new_node)."""

    # unique read name decided UP FRONT: with multiple placements the
    # target subtree may already contain an earlier placement of this
    # query, and read_alignment_scores resolves the read by NAME — the
    # old leaf must not shadow the new one
    n_seen = name_counts.get(entry.name, 0)
    read_name = entry.name if n_seen == 0 else \
        f"{entry.name}.{n_seen}"

    def try_strand(rc: bool):
        rnode = _read_leaf(entry, rc, data_type, cfg)
        rnode.name = read_name
        node = TreeNode(name=f"#{count}#", children=[target, rnode])
        node.left.dist = 0.001
        anc, _ = align_pair(target.graph, rnode.graph, model,
                            settings, left_branch_length=0.001,
                            right_branch_length=cfg.query_distance,
                            is_reads_sequence=True, engine=cfg.engine,
                            compute_consensus=cfg.compute_consensus)
        if anc is None:
            # anchoring-threshold skip (node.cpp:155-186)
            return None, -1.0, -1.0
        anc.is_read_sequence = True
        anc.has_read_descendants = True
        node.graph = anc
        ov, ident = read_alignment_scores(
            node, read_name, ref_node_name,
            overlap_with_any=cfg.overlap_with_any)
        return node, ov, ident

    node, ov, ident = (None, -1.0, -1.0)
    if not (compare_reverse and rev_hint):
        node, ov, ident = try_strand(False)
    node_rc, ov_rc, ident_rc = (None, -1.0, -1.0)
    if compare_reverse and (rev_hint or single_cand):
        node_rc, ov_rc, ident_rc = try_strand(True)

    if ov > ov_rc and ov > min_ov and ident > min_id:
        new_node = node
    elif ov_rc > min_ov and ident_rc > min_id:
        new_node = node_rc
    else:
        # restore and reject (the carried orig_dist, matching the
        # reference's unconditional set_distance_to_parent(orig_dist))
        target.dist = orig_dist
        return False, tree, single_ref, count, orig_dist, None

    count += 1
    if orig_dist > new_node.dist:
        orig_dist -= new_node.dist
    name_counts[entry.name] = n_seen + 1
    new_node.dist = orig_dist

    if single_ref or ref_node_name == tree.name:
        new_node.site_index_corrected = getattr(
            tree, "site_index_corrected", False)
        tree = new_node
        single_ref = False
    else:
        if not _correct_sites_index(new_node, ref_node_name, tree):
            new_node.site_index_corrected = getattr(
                tree, "site_index_corrected", False)
            tree = new_node
    if cfg.tid_for_subroot:
        # spliced parent inherits the target's NHX TID tag
        # (reads_aligner.cpp:858-862)
        new_node.nhx_tid = new_node.left.nhx_tid
        new_node.left.nhx_tid = ""
        new_node.right.nhx_tid = ""
    _fix_branch_lengths(tree, new_node, data_type)
    if _parent_of(tree, new_node.name) is not None:
        _reconstruct_one_parsimony(tree, new_node, model_factory)
    placed.append(new_node.right.name)
    return True, tree, single_ref, count, orig_dist, new_node


def _dna_score_context(cfg: PlacementConfig, data_type: str, dna_map):
    """--score-as-dna: DNA-level model for candidate scoring when the
    run is --translate'd (reads_aligner.cpp:2930-2942). Returns the DNA
    scoring model or None when inapplicable."""
    if not (cfg.score_as_dna and dna_map) or data_type == alph.DNA:
        return None
    return ModelFactory(alph.DNA).alignment_model(0.001 +
                                                  cfg.query_distance)


def place_queries(res: ProgressiveResult, queries: list[FastaEntry],
                  data_type: str, cfg: PlacementConfig | None = None,
                  model_factory: ModelFactory | None = None,
                  settings: AlignSettings | None = None,
                  mesh=None, dna_map=None) -> PlacementOutcome:
    """query_placement_one (reads_aligner.cpp:623-911)."""
    cfg = cfg or PlacementConfig()
    if cfg.fragments:
        # --fragments: group queries per target node, insert
        # best-score-first (query_placement_all, reads_aligner.cpp:372-621)
        return place_queries_grouped(res, queries, data_type, cfg,
                                     model_factory=model_factory,
                                     settings=settings, mesh=mesh,
                                     dna_map=dna_map)
    tree = res.tree
    if model_factory is None:
        model_factory = ModelFactory(data_type)
    settings = (settings or AlignSettings()).for_reads() \
        .with_reads_anchor_gate(cfg.anchor_reads_min_sites)

    compare_reverse = cfg.both_strands and data_type == alph.DNA
    min_ov = max(cfg.min_query_overlap, 0.0)
    min_id = max(cfg.min_query_identity, 0.0)
    model = model_factory.alignment_model(0.001 + cfg.query_distance)
    dna_model = _dna_score_context(cfg, data_type, dna_map)

    count = sum(1 for _ in tree.nodes_postorder()) + 1
    single_ref = tree.is_leaf or tree.num_leaves() == 1
    discarded: list[FastaEntry] = []
    placed: list[str] = []
    name_counts: dict[str, int] = {}
    _kmer_cache: dict = {}   # per-run node k-mer sets (preselection)

    for entry in queries:
        nodes_map = _nodes_by_name(tree)
        # ---- target selection (find_nodes_for_query, :1996-2278) ----
        qtid = ""
        if "TID=" in (entry.comment or ""):
            qtid = entry.comment.split("TID=")[1].split()[0].strip("[]")
        cand = _candidate_names(tree, cfg, qtid)
        # the single-match shortcut below is the TID rule
        # (reads_aligner.cpp:2748): it applies when the ORIGINAL
        # candidate set has one node, NOT when preselection narrowed
        # it to one — preselected candidates must still be scored
        # (5% discard check, strand choice)
        tid_single = len(cand) == 1
        if not cfg.find_orfs:
            # ORF queries are DNA against protein targets — k-mer
            # preselection is meaningless there, ORF scoring picks
            cand = _preselect_candidates(entry, cand, nodes_map,
                                         cfg.preselect_keep_best,
                                         data_type, _kmer_cache)
        if not cand:
            discarded.append(entry)
            continue

        orig_entry = entry
        if cfg.find_orfs:
            orf_entry = _select_best_orf(entry, cand, nodes_map, model,
                                         settings, cfg, data_type)
            if orf_entry is None:
                discarded.append(entry)
                continue
            entry = orf_entry
        best_strand_rev = False
        fwd_graph = _read_leaf(entry, False, data_type, cfg).graph
        rc_graph = (_read_leaf(entry, True, data_type, cfg).graph
                    if compare_reverse else None)
        if tid_single and not cfg.rank_reads_for_nodes:
            # single matching node: assigned without scoring unless
            # --rank-reads-for-nodes asks for a real node_score
            # (reads_aligner.cpp:2748)
            best_nodes = [cand[0]]
            best_score = 1.0
        else:
            from ..parallel.executor import execute_pair_jobs
            jobs, smodel, per_strand = _build_score_jobs(
                entry, cand, nodes_map, fwd_graph, rc_graph, model,
                settings, cfg, dna_model=dna_model, dna_map=dna_map)
            results = execute_pair_jobs(jobs, engine=cfg.engine,
                                        mesh=mesh)
            scores = [_match_score_from_anc(anc, j.left, j.right,
                                            smodel, cfg)
                      for j, (anc, _e) in zip(jobs, results)]
            best_score, best_nodes, best_strand_rev = _pick_best_nodes(
                cand, scores, per_strand, cfg)
            if best_score < 0.05:
                # "aligns with less than 5% of identical sites"
                if cfg.align_bad_reads_at_root:
                    best_nodes = [tree.name]
                else:
                    # report the ORIGINAL query (--find-orfs replaced
                    # `entry` with its protein translation)
                    discarded.append(orig_entry)
                    continue

        # ---- per target node: align, accept, splice ----
        accepted_any = False
        for ref_node_name in sorted(set(best_nodes), key=_node_sort_key):
            target = _nodes_by_name(tree).get(ref_node_name)
            if target is None:
                continue
            # per-query distance budget (query_placement_one re-reads
            # it for every read, reads_aligner.cpp:714)
            orig_dist = target.dist
            ok, tree, single_ref, count, orig_dist, _nn = \
                _align_accept_splice(
                    tree, target, ref_node_name, entry,
                    best_strand_rev, len(cand) == 1, count, orig_dist,
                    cfg, model, settings, data_type, model_factory,
                    compare_reverse, min_ov, min_id, name_counts,
                    placed, single_ref)
            accepted_any = accepted_any or ok

        if not accepted_any:
            discarded.append(orig_entry)

    alignment = extract_alignment(tree, False, data_type=data_type)
    out = ProgressiveResult(tree=tree, alignment=alignment)
    return PlacementOutcome(result=out, discarded=discarded, placed=placed)


def place_queries_grouped(res: ProgressiveResult,
                          queries: list[FastaEntry], data_type: str,
                          cfg: PlacementConfig | None = None,
                          model_factory: ModelFactory | None = None,
                          settings: AlignSettings | None = None,
                          mesh=None, dna_map=None) -> PlacementOutcome:
    """--fragments: query_placement_all (reads_aligner.cpp:372-621).

    All queries find their target nodes up-front — here as ONE batched
    executor launch over every (query x candidate x strand) scoring
    alignment, instead of the reference's serial sweep — then queries
    are grouped by target node (nodes in node_is_smaller order,
    :443-445) and inserted per node in stable best-node_score-first
    order (sort_reads_vector, :468). Each accepted query's merged node
    becomes the alignment target for the next query of that group
    (current_root chaining, :483-620), so insertion order changes the
    output — which is exactly why the ordering subsystem exists.
    """
    cfg = cfg or PlacementConfig()
    tree = res.tree
    if model_factory is None:
        model_factory = ModelFactory(data_type)
    settings = (settings or AlignSettings()).for_reads() \
        .with_reads_anchor_gate(cfg.anchor_reads_min_sites)

    compare_reverse = cfg.both_strands and data_type == alph.DNA
    min_ov = max(cfg.min_query_overlap, 0.0)
    min_id = max(cfg.min_query_identity, 0.0)
    model = model_factory.alignment_model(0.001 + cfg.query_distance)
    dna_model = _dna_score_context(cfg, data_type, dna_map)

    count = sum(1 for _ in tree.nodes_postorder()) + 1
    single_ref = tree.is_leaf or tree.num_leaves() == 1
    discarded: list[FastaEntry] = []
    placed: list[str] = []
    name_counts: dict[str, int] = {}
    _kmer_cache: dict = {}   # per-run node k-mer sets (preselection)

    # ---- phase 1: find nodes for ALL queries (find_nodes_for_queries /
    # find_targets_for_queries, :2458-2601) — one batched launch ----
    nodes_map = _nodes_by_name(tree)
    per_query: list[dict] = []
    all_jobs = []
    spans = []  # (start, cand, per_strand, smodel) per scored query
    for entry in queries:
        qtid = ""
        if "TID=" in (entry.comment or ""):
            qtid = entry.comment.split("TID=")[1].split()[0].strip("[]")
        cand = _candidate_names(tree, cfg, qtid)
        tid_single = len(cand) == 1
        if not cfg.find_orfs:
            cand = _preselect_candidates(entry, cand, nodes_map,
                                         cfg.preselect_keep_best,
                                         data_type, _kmer_cache)
        info = {"entry": entry, "cand": cand, "nodes": [],
                "score": -float("inf"), "rev": False,
                "tid_single": tid_single}
        per_query.append(info)
        if not cand:
            continue
        info["orig"] = entry
        if cfg.find_orfs:
            # translated_query_placement_all (reads_aligner.cpp:1353-1436)
            orf_entry = _select_best_orf(entry, cand, nodes_map, model,
                                         settings, cfg, data_type)
            if orf_entry is None:
                info["cand"] = []
                continue
            entry = orf_entry
            info["entry"] = entry
        if tid_single and not cfg.rank_reads_for_nodes:
            info["nodes"] = [cand[0]]
            info["score"] = 1.0
            continue
        fwd_graph = _read_leaf(entry, False, data_type, cfg).graph
        rc_graph = (_read_leaf(entry, True, data_type, cfg).graph
                    if compare_reverse else None)
        jobs, smodel, per_strand = _build_score_jobs(
            entry, cand, nodes_map, fwd_graph, rc_graph, model,
            settings, cfg, dna_model=dna_model, dna_map=dna_map)
        spans.append((len(all_jobs), info, per_strand, smodel))
        all_jobs.extend(jobs)
    if all_jobs:
        from ..parallel.executor import execute_pair_jobs
        results = execute_pair_jobs(all_jobs, engine=cfg.engine,
                                    mesh=mesh)
        for start, info, per_strand, smodel in spans:
            cand = info["cand"]
            n = len(cand) * per_strand
            scores = [_match_score_from_anc(anc, j.left, j.right,
                                            smodel, cfg)
                      for j, (anc, _e) in zip(all_jobs[start:start + n],
                                              results[start:start + n])]
            sc, nodes, rev = _pick_best_nodes(cand, scores, per_strand,
                                              cfg)
            if sc < 0.05:
                # "aligns with less than 5% of identical sites"
                if cfg.align_bad_reads_at_root:
                    nodes, sc = [tree.name], sc
                else:
                    nodes = []
            info["nodes"], info["score"], info["rev"] = nodes, sc, rev

    for info in per_query:
        if not info["nodes"]:
            discarded.append(info.get("orig", info["entry"]))

    # ---- phase 2: one tagged node at a time (:443-620) ----
    unique_nodes = sorted({nm for info in per_query
                           for nm in info["nodes"]}, key=_node_sort_key)
    accepted: set[int] = set()
    for node_name in unique_nodes:
        group = [info for info in per_query if node_name in info["nodes"]]
        # sort_reads_vector (:468): stable, best node_score first
        group.sort(key=lambda info: -info["score"])
        ref_node_name = node_name
        target = _nodes_by_name(tree).get(node_name)
        if target is None:
            continue
        orig_dist = target.dist
        for info in group:
            entry = info["entry"]
            # orig_dist is carried across the group's insertions
            # (query_placement_all reads it once per node group and
            # decrements per accept, reads_aligner.cpp:476,534-537)
            ok, tree, single_ref, count, orig_dist, new_node = \
                _align_accept_splice(
                    tree, target, ref_node_name, entry, info["rev"],
                    info["tid_single"], count, orig_dist, cfg,
                    model, settings, data_type, model_factory,
                    compare_reverse, min_ov, min_id, name_counts,
                    placed, single_ref)
            if not ok:
                continue
            accepted.add(id(entry))
            # current_root chaining: the merged node is the target for
            # the group's next query (:483-487)
            target = new_node
            ref_node_name = new_node.name

    already = {id(e) for e in discarded}
    for info in per_query:
        orig = info.get("orig", info["entry"])
        if info["nodes"] and id(info["entry"]) not in accepted \
                and id(orig) not in already:
            discarded.append(orig)
            already.add(id(orig))

    alignment = extract_alignment(tree, False, data_type=data_type)
    out = ProgressiveResult(tree=tree, alignment=alignment)
    return PlacementOutcome(result=out, discarded=discarded,
                            placed=placed)
