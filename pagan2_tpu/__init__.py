"""pagan2_tpu — a phylogeny-aware multiple sequence alignment framework
(JAX/XLA, with CUDA kernels for the GPU) with the capabilities of PAGAN2.

Layers:
  models/    alphabets, substitution models, per-branch score tables
  graph/     partial-order sequence graphs as fixed-width arrays
  align/     pairwise graph-vs-graph Viterbi DP (oracle + JAX + CUDA)
  tree/      Newick parsing, guide-tree scheduling
  pipeline/  progressive alignment, pileup, query placement
  io/        FASTA/FASTQ/phylip/nexus/xml/graph readers and writers
  parallel/  device-mesh sharding of independent alignment jobs
"""

__version__ = "0.1.0"
