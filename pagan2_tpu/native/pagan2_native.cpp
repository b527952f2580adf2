// pagan2-tpu native runtime: host-side hot paths of the alignment
// pipeline, the equivalent of the reference's C++ utility
// layer (anchor discovery src/utils/find_anchors.cpp, FASTA ingest
// src/utils/fasta_reader.cpp). The DP itself runs on the device via
// XLA and CUDA; these are the CPU components feeding it.
//
// Exposed as a plain C ABI consumed through ctypes
// (pagan2_tpu/native/__init__.py). Semantics intentionally match the
// Python fallbacks in align/anchors.py bit-for-bit so either path can
// serve any run.
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>
#include <unordered_map>
#include <unordered_set>
#include <vector>
#include <thread>

namespace {

struct Hit {
    int64_t p1, p2, len;
    // no discovery-order field: std::stable_sort on the
    // insertion-ordered vector already provides the tie-break
};

// Shared-prefix anchors via joint suffix sorting
// (Find_anchors::define_tunnel suffix-sort, find_anchors.cpp:35-127).
// Reproduces the Python fallback exactly: suffixes of both strings
// sorted as (suffix, src, idx) tuples, adjacent entries from different
// strings with a shared prefix >= min_len become hits, then a greedy
// longest-first non-overlap filter.
std::vector<Hit> prefix_anchors(const char* s1, int64_t n1,
                                const char* s2, int64_t n2,
                                int64_t min_len) {
    struct Suf { const char* p; int64_t len; int32_t src; int64_t idx; };
    std::vector<Suf> sufs;
    sufs.reserve(n1 + n2);
    for (int64_t i = 0; i < n1; ++i)
        sufs.push_back({s1 + i, n1 - i, 0, i});
    for (int64_t j = 0; j < n2; ++j)
        sufs.push_back({s2 + j, n2 - j, 1, j});

    std::sort(sufs.begin(), sufs.end(), [](const Suf& a, const Suf& b) {
        int64_t m = std::min(a.len, b.len);
        int c = std::memcmp(a.p, b.p, (size_t)m);
        if (c != 0) return c < 0;
        if (a.len != b.len) return a.len < b.len;   // prefix sorts first
        if (a.src != b.src) return a.src < b.src;
        return a.idx < b.idx;
    });

    std::vector<Hit> hits;
    for (size_t t = 0; t + 1 < sufs.size(); ++t) {
        const Suf& a = sufs[t];
        const Suf& b = sufs[t + 1];
        if (a.src == b.src) continue;
        int64_t m = std::min(a.len, b.len);
        int64_t k = 0;
        while (k < m && a.p[k] == b.p[k]) ++k;
        if (k >= min_len) {
            int64_t p1 = (a.src == 0) ? a.idx : b.idx;
            int64_t p2 = (a.src == 0) ? b.idx : a.idx;
            hits.push_back({p1, p2, k});
        }
    }

    // stable longest-first (Python list.sort(key=-length) is stable)
    std::stable_sort(hits.begin(), hits.end(),
                     [](const Hit& x, const Hit& y) {
                         return x.len > y.len;
                     });

    std::vector<uint8_t> used1((size_t)n1, 0), used2((size_t)n2, 0);
    std::vector<Hit> kept;
    for (const Hit& h : hits) {
        bool clash = false;
        for (int64_t i = h.p1; i < h.p1 + h.len && !clash; ++i)
            clash = used1[(size_t)i];
        for (int64_t j = h.p2; j < h.p2 + h.len && !clash; ++j)
            clash = used2[(size_t)j];
        if (clash) continue;
        std::fill(used1.begin() + h.p1, used1.begin() + h.p1 + h.len, 1);
        std::fill(used2.begin() + h.p2, used2.begin() + h.p2 + h.len, 1);
        kept.push_back(h);
    }
    return kept;
}

// k-mer anchors (the native BLAST stand-in of align/anchors.py):
// k-mers unique within each sequence, matched across sequences, then
// co-diagonal consecutive seeds merged into maximal runs.
std::vector<Hit> kmer_anchors(const char* s1, int64_t n1,
                              const char* s2, int64_t n2,
                              int64_t k, int64_t min_run) {
    auto unique_kmers = [k](const char* s, int64_t n) {
        std::unordered_map<std::string_view, int64_t> pos;
        std::unordered_set<std::string_view> dup;
        if (n >= k) {
            pos.reserve((size_t)(n - k + 1));
            for (int64_t i = 0; i + k <= n; ++i) {
                std::string_view w(s + i, (size_t)k);
                if (dup.count(w)) continue;
                auto it = pos.find(w);
                if (it != pos.end()) {
                    pos.erase(it);
                    dup.insert(w);
                } else {
                    pos.emplace(w, i);
                }
            }
        }
        return pos;
    };

    auto p1 = unique_kmers(s1, n1);
    auto p2 = unique_kmers(s2, n2);

    std::vector<std::pair<int64_t, int64_t>> seeds;
    const auto& small = (p1.size() < p2.size()) ? p1 : p2;
    const auto& large = (p1.size() < p2.size()) ? p2 : p1;
    bool small_is_1 = p1.size() < p2.size();
    for (const auto& kv : small) {
        auto it = large.find(kv.first);
        if (it == large.end()) continue;
        int64_t i = small_is_1 ? kv.second : it->second;
        int64_t j = small_is_1 ? it->second : kv.second;
        seeds.emplace_back(i, j);
    }
    std::sort(seeds.begin(), seeds.end());

    std::vector<Hit> hits;
    int64_t ci = -1, cj = -1, cl = 0;
    for (const auto& [i, j] : seeds) {
        if (cl > 0 && i - ci == j - cj && i <= ci + cl) {
            cl = i + k - ci;
        } else {
            if (cl > 0 && cl >= min_run * k)
                hits.push_back({ci, cj, cl});
            ci = i; cj = j; cl = k;
        }
    }
    if (cl > 0 && cl >= min_run * k)
        hits.push_back({ci, cj, cl});
    return hits;
}

}  // namespace

extern "C" {

// Fill out_{p1,p2,len} (capacity cap) and return the hit count
// (truncated to cap). A negative return is an error.
int64_t p2n_prefix_anchors(const char* s1, int64_t n1,
                           const char* s2, int64_t n2, int64_t min_len,
                           int64_t* out_p1, int64_t* out_p2,
                           int64_t* out_len, int64_t cap) {
    if (!s1 || !s2 || min_len < 1) return -1;
    auto hits = prefix_anchors(s1, n1, s2, n2, min_len);
    int64_t n = std::min<int64_t>((int64_t)hits.size(), cap);
    for (int64_t t = 0; t < n; ++t) {
        out_p1[t] = hits[(size_t)t].p1;
        out_p2[t] = hits[(size_t)t].p2;
        out_len[t] = hits[(size_t)t].len;
    }
    return (int64_t)hits.size();
}

int64_t p2n_kmer_anchors(const char* s1, int64_t n1,
                         const char* s2, int64_t n2,
                         int64_t k, int64_t min_run,
                         int64_t* out_p1, int64_t* out_p2,
                         int64_t* out_len, int64_t cap) {
    if (!s1 || !s2 || k < 1) return -1;
    auto hits = kmer_anchors(s1, n1, s2, n2, k, min_run);
    int64_t n = std::min<int64_t>((int64_t)hits.size(), cap);
    for (int64_t t = 0; t < n; ++t) {
        out_p1[t] = hits[(size_t)t].p1;
        out_p2[t] = hits[(size_t)t].p2;
        out_len[t] = hits[(size_t)t].len;
    }
    return (int64_t)hits.size();
}


// Greedy max-min taxon subsampling over a flattened distance matrix
// (the native BppPhySamp equivalent used by --prune-extended-alignment;
// input_output_parser.cpp:808-1122). keep[] gets 1 for selected taxa.
void p2n_maxmin_subsample(const double* dist, int64_t n, int64_t keep_n,
                          int64_t first, uint8_t* keep) {
    // validate BEFORE any allocation or write: a negative n would
    // construct a ~1.8e19-element vector (bad_alloc escaping the
    // extern "C" boundary kills the process) and an out-of-range
    // `first` is a heap OOB write with no way to signal failure
    if (n <= 0 || keep_n <= 0) return;
    if (first < 0 || first >= n) first = 0;
    std::vector<double> best((size_t)n, 1e300);
    std::fill(keep, keep + n, 0);
    int64_t cur = first;
    keep[cur] = 1;
    for (int64_t t = 1; t < keep_n && t < n; ++t) {
        double far_d = -1.0;
        int64_t far_i = -1;
        for (int64_t i = 0; i < n; ++i) {
            if (keep[i]) continue;
            double d = dist[cur * n + i];
            if (d < best[(size_t)i]) best[(size_t)i] = d;
            if (best[(size_t)i] > far_d) {
                far_d = best[(size_t)i];
                far_i = i;
            }
        }
        if (far_i < 0) break;
        keep[far_i] = 1;
        cur = far_i;
    }
}

}  // extern "C"
