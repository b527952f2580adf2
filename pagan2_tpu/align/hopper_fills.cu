// Hopper (sm_90a) Viterbi fills for the pairwise graph-alignment DP,
// called from JAX through the XLA foreign function interface.
//
// Both kernels walk the anti-diagonals of one DP plane inside the
// kernel: a thread block owns its job's whole chain of diagonals and
// keeps the newest diagonals of M/X/Y in shared memory (or, past the
// shared-memory budget, in a global scratch buffer that stays in L2),
// with one barrier per diagonal.  Match scores are looked up in-kernel
// from the per-job state vectors and the model's log-score table, so
// only O(L + R) vectors stream in and one backpointer code per cell
// streams out.
//
// Candidate order, the strict-greater first-wins rule and the f32
// addition order are those of the plain-JAX scan cores
// (viterbi_sheared.batched_sheared_core, viterbi_banded._build_core,
// viterbi_fanin._build_core_onehot), so backpointers and scores are
// bit-identical to them.  Build and loading: pagan2_tpu/align/hopper.py.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <string>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr float kNeg = -INFINITY;
constexpr uint8_t kLinNone = 0x3F;             // 2-bit NONE x 3 matrices
constexpr uint32_t kBmNone = 65535, kBxNone = 255, kByNone = 255;
constexpr uint32_t kFanNone = kBmNone + (kBxNone << 16) + (kByNone << 24);
constexpr int kMaxThreads = 1024;
constexpr int kMaxK = 8;                       // fan-in edge slots per side

// ---------------------------------------------------------------------
// Linear-chain fill over a window of W rows per diagonal.
//
// Window position p on diagonal d is row i = ilo[d] + p.  A job is
// split over nblk blocks of T positions when its window is fixed
// (ilo == 0); block k then waits for block k-1 to publish diagonal
// d-1, whose last row it reads as a one-cell halo.  A moving window
// (anchored band) always runs in one block.
//
// Blocks take their (job, k) tile from an atomic ticket in the order
// they start, not from blockIdx: CUDA neither orders the dispatch of
// blocks nor keeps them resident together, but a block that holds
// ticket t started after the holder of t - 1, its predecessor, which is
// therefore resident or finished, so the wait always ends.
struct LinArgs {
  const float* rowf;     // (B, 3, Lr): lw, gext_i, open_l of row i-1
  const int32_t* rowi;   // (B, 3, Lr): left state, band lo, band hi
  const float* colf;     // (B, 3, Rc): rw, gext_j, open_r of col j-1
  const int32_t* coli;   // (B, Rc): right state
  const float* tab;      // (B, nf * nf) log-score table
  const float* fsc;      // (B, 2): log non-gap, log gap-open
  const int32_t* isc;    // (B, 2): L, R
  const int32_t* ilo;    // (B, D) window start per diagonal
  uint8_t* bp;           // (B, D, W) codes bm | bx << 2 | by << 4
  float* fin;            // (B, 3) corner-cell M, X, Y
  float* bnd;            // (B, nblk, D, 3) last-row values per block
  int32_t* prog;         // (B, nblk) last diagonal each block published
  float* gst;            // (B, nblk, 9, T + 2) state when not in smem
  int32_t* ticket;       // (1,) next tile, zeroed before the launch
  int Lr, Rc, nf, D, W, T, nblk;
};

template <bool kSmem>
__global__ void __launch_bounds__(kMaxThreads)
linear_fill_kernel(LinArgs a) {
  extern __shared__ float smem[];
  __shared__ int tile;
  if (threadIdx.x == 0) tile = atomicAdd(a.ticket, 1);
  __syncthreads();
  const int k = tile % a.nblk, b = tile / a.nblk;
  const int T = a.T, S = T + 2, W = a.W, D = a.D;
  // 3 generations (d, d-1, d-2) x 3 matrices, each S = T + 2 cells:
  // index 0 is the halo (position p0 - 1), index T + 1 a sentinel
  float* st = kSmem ? smem : a.gst + ((size_t)b * a.nblk + k) * 9 * S;
  const float* lw = a.rowf + (size_t)b * 3 * a.Lr;
  const float* gexti = lw + a.Lr;
  const float* olp = gexti + a.Lr;
  const int32_t* ls = a.rowi + (size_t)b * 3 * a.Lr;
  const int32_t* blo = ls + a.Lr;
  const int32_t* bhi = blo + a.Lr;
  const float* rw = a.colf + (size_t)b * 3 * a.Rc;
  const float* gextj = rw + a.Rc;
  const float* orp = gextj + a.Rc;
  const int32_t* rs = a.coli + (size_t)b * a.Rc;
  const float* tab = a.tab + (size_t)b * a.nf * a.nf;
  const int nf = a.nf;
  const float lng = a.fsc[2 * b], lgo = a.fsc[2 * b + 1];
  const int L = a.isc[2 * b], R = a.isc[2 * b + 1];
  const int32_t* ilo = a.ilo + (size_t)b * D;
  uint8_t* bp = a.bp + (size_t)b * D * W;
  float* bnd = a.bnd + (size_t)b * a.nblk * D * 3;
  int32_t* prog = a.prog + (size_t)b * a.nblk;
  const int p0 = k * T;
  const int tn = min(T, W - p0);
  const int cornerd = L + R - 2;
  const int dend = min(cornerd, D - 1);

  for (int q = threadIdx.x; q < 9 * S; q += blockDim.x) st[q] = kNeg;
  for (int t = threadIdx.x; t < tn; t += blockDim.x) bp[p0 + t] = kLinNone;
  if (k + 1 < a.nblk && threadIdx.x == 0) {
    // diagonal 0 holds only M(0, 0), never a block's last row
    float* dst = bnd + (size_t)k * D * 3;
    dst[0] = dst[1] = dst[2] = kNeg;
    __threadfence();
  }
  __syncthreads();
  if (k == 0 && threadIdx.x == 0 && ilo[0] == 0) st[1] = 0.f;  // M(0, 0)

  for (int d = 1; d <= dend; ++d) {
    const int g0 = d % 3, g1 = (d + 2) % 3, g2 = (d + 1) % 3;
    if (k > 0 && threadIdx.x == 0) {
      volatile int32_t* pv = prog + k - 1;
      while (*pv < d - 1) {
      }
      __threadfence();
      const float* src = bnd + ((size_t)(k - 1) * D + (d - 1)) * 3;
      for (int m = 0; m < 3; ++m) st[(g1 * 3 + m) * S] = __ldcg(src + m);
    }
    __syncthreads();
    if (k + 1 < a.nblk && threadIdx.x == 0) {
      // every thread finished diagonal d-1 (its last row is in bnd)
      __threadfence();
      atomicExch(prog + k, d - 1);
    }
    const int il = ilo[d];
    const int dl1 = il - ilo[d - 1];
    const int dl2 = d >= 2 ? il - ilo[d - 2] : 0;
    const float* M1 = st + (g1 * 3 + 0) * S;
    const float* X1 = st + (g1 * 3 + 1) * S;
    const float* Y1 = st + (g1 * 3 + 2) * S;
    const float* M2 = st + (g2 * 3 + 0) * S;
    const float* X2 = st + (g2 * 3 + 1) * S;
    const float* Y2 = st + (g2 * 3 + 2) * S;
    float* M0 = st + (g0 * 3 + 0) * S;
    float* X0 = st + (g0 * 3 + 1) * S;
    float* Y0 = st + (g0 * 3 + 2) * S;
    uint8_t* bpd = bp + (size_t)d * W + p0;
    for (int t = threadIdx.x; t < tn; t += blockDim.x) {
      const int i = il + p0 + t, j = d - i;
      bool valid = i < L && j >= 0 && j < R;
      if (valid) valid = j >= blo[i] && j <= bhi[i];
      float X = kNeg, Y = kNeg, M = kNeg;
      uint32_t cx = 3, cy = 3, cm = 3;
      if (valid && i > 0) {            // X: ext, double, open
        const int q = t + dl1;         // row i-1 of diagonal d-1
        float v = X1[q] + gextj[j];
        uint32_t c = 0;
        const float c1 = Y1[q] + lgo;
        const float c2 = (M1[q] + lng) + olp[i];
        if (c1 > v) { v = c1; c = 1; }
        if (c2 > v) { v = c2; c = 2; }
        if (isfinite(v)) { X = v; cx = c; }
      }
      if (valid && j > 0) {            // Y: ext, double, open
        const int q = t + dl1 + 1;     // row i of diagonal d-1
        float v = Y1[q] + gexti[i];
        uint32_t c = 0;
        const float c1 = X1[q] + lgo;
        const float c2 = (M1[q] + lng) + orp[j];
        if (c1 > v) { v = c1; c = 1; }
        if (c2 > v) { v = c2; c = 2; }
        if (isfinite(v)) { Y = v; cy = c; }
      }
      if (valid && i > 0 && j > 0) {   // M: m, x, y
        const int q = t + dl2;         // row i-1 of diagonal d-2
        const float ms = tab[ls[i] * nf + rs[j]];
        const float wadd = ((lng + ms) + lw[i]) + rw[j];
        float v = (M2[q] + lng) + wadd;
        uint32_t c = 0;
        const float c1 = X2[q] + wadd;
        const float c2 = Y2[q] + wadd;
        if (c1 > v) { v = c1; c = 1; }
        if (c2 > v) { v = c2; c = 2; }
        if (isfinite(v)) { M = v; cm = c; }
      }
      M0[t + 1] = M;
      X0[t + 1] = X;
      Y0[t + 1] = Y;
      bpd[t] = (uint8_t)(cm | (cx << 2) | (cy << 4));
      if (k + 1 < a.nblk && t == T - 1) {
        float* dst = bnd + ((size_t)k * D + d) * 3;
        dst[0] = M;
        dst[1] = X;
        dst[2] = Y;
        __threadfence();
      }
      if (d == cornerd && i == L - 1) {
        a.fin[3 * b] = M;
        a.fin[3 * b + 1] = X;
        a.fin[3 * b + 2] = Y;
      }
    }
    if (d == cornerd && k == 0 && threadIdx.x == 0) {
      const int pc = (L - 1) - il;     // corner row outside the window
      if (pc < 0 || pc >= W) {
        a.fin[3 * b] = kNeg;
        a.fin[3 * b + 1] = kNeg;
        a.fin[3 * b + 2] = kNeg;
      }
    }
  }
  __syncthreads();
  if (k + 1 < a.nblk && threadIdx.x == 0) {
    __threadfence();
    atomicExch(prog + k, dend);
  }
  for (int d = dend + 1; d < D; ++d)
    for (int t = threadIdx.x; t < tn; t += blockDim.x)
      bp[(size_t)d * W + p0 + t] = kLinNone;
}

// ---------------------------------------------------------------------
// Fan-in fill over a window of W rows per diagonal: position t on
// diagonal d is row ilo[d] + t (the full plane is ilo == 0, W = Lr).
// A ring of the last Gr diagonals of M/X/Y holds each diagonal in its
// own window; window starts never decrease, so a source row lies at
// most PAD (>= the largest left edge offset) positions left of the
// ring's row 0, and a source outside its diagonal's window is -inf.
struct FanArgs {
  const float* rowf;     // (B, 1 + 2 KL, Lr): gext_i, llw[KL], lopen[KL]
  const int32_t* rowi;   // (B, 3 + KL, Lr): left state, band lo, hi, loff[KL]
  const float* colf;     // (B, 1 + 2 KR, Rc): gext_j, rlw[KR], ropen[KR]
  const int32_t* coli;   // (B, 1 + KR, Rc): right state, roff[KR]
  const float* tab;      // (B, nf * nf)
  const float* fsc;      // (B, 2): log non-gap, log gap-open
  const int32_t* isc;    // (B, 2): L, R
  const int32_t* ilo;    // (B, D) window start per diagonal
  uint32_t* bp;          // (B, D, W) codes bm | bx << 16 | by << 24
  float* snap;           // (B, 3, Gs, W) ring at the corner diagonal
  float* gring;          // (B, 3 * Gr * (PAD + W)) ring when not in smem
  int Lr, Rc, nf, D, W, KL, KR, Gr, Gs, PAD;
};

template <bool kSmem>
__global__ void __launch_bounds__(kMaxThreads)
fanin_fill_kernel(FanArgs a) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int W = a.W, D = a.D, Gr = a.Gr, PAD = a.PAD, S = PAD + W;
  const int KL = a.KL, KR = a.KR, Lr = a.Lr, Rc = a.Rc;
  float* ring = kSmem ? smem : a.gring + (size_t)b * 3 * Gr * S;
  const float* gexti = a.rowf + (size_t)b * (1 + 2 * KL) * Lr;
  const float* llw = gexti + Lr;
  const float* lopen = llw + (size_t)KL * Lr;
  const int32_t* ls = a.rowi + (size_t)b * (3 + KL) * Lr;
  const int32_t* blo = ls + Lr;
  const int32_t* bhi = blo + Lr;
  const int32_t* loff = bhi + Lr;
  const float* gextj = a.colf + (size_t)b * (1 + 2 * KR) * Rc;
  const float* rlw = gextj + Rc;
  const float* ropen = rlw + (size_t)KR * Rc;
  const int32_t* rs = a.coli + (size_t)b * (1 + KR) * Rc;
  const int32_t* roff = rs + Rc;
  const float* tab = a.tab + (size_t)b * a.nf * a.nf;
  const int nf = a.nf;
  const float lng = a.fsc[2 * b], lgo = a.fsc[2 * b + 1];
  const int L = a.isc[2 * b], R = a.isc[2 * b + 1];
  const int32_t* ilo = a.ilo + (size_t)b * D;
  uint32_t* bp = a.bp + (size_t)b * D * W;
  const int cornerd = L + R - 2;
  const int dend = min(cornerd, D - 1);
  // plane of ring slot sl for matrix m (0 M, 1 X, 2 Y), at position 0
  auto plane = [&](int sl, int m) { return ring + (sl * 3 + m) * S + PAD; };

  for (int q = threadIdx.x; q < 3 * Gr * S; q += blockDim.x) ring[q] = kNeg;
  for (int t = threadIdx.x; t < W; t += blockDim.x) bp[t] = kFanNone;
  __syncthreads();
  if (threadIdx.x == 0 && ilo[0] == 0) plane(0, 0)[0] = 0.f;  // M(0, 0)

  for (int d = 1; d <= dend; ++d) {
    __syncthreads();
    const int dm = d % Gr;
    // ring slot of diagonal d - back, for 0 <= back < Gr
    auto slot = [&](int back) { return dm >= back ? dm - back : dm - back + Gr; };
    // matrix m of diagonal d - back at row `row`
    auto at = [&](int back, int m, int row) {
      const int q = row - ilo[d - back];
      return q < W ? plane(slot(back), m)[q] : kNeg;
    };
    const int il = ilo[d];
    float* M0 = plane(dm, 0);
    float* X0 = plane(dm, 1);
    float* Y0 = plane(dm, 2);
    for (int t = threadIdx.x; t < W; t += blockDim.x) {
      const int i = il + t, j = d - i;
      bool valid = i < L && j >= 0 && j < R;
      if (valid) valid = j >= blo[i] && j <= bhi[i];
      float X = kNeg, Y = kNeg, M = kNeg;
      uint32_t cx = kBxNone, cy = kByNone, cm = kBmNone;
      if (valid) {
        // this cell's edge slots (offset 0: no edge, or none usable yet)
        int lo[kMaxK], ro[kMaxK];
#pragma unroll
        for (int e = 0; e < kMaxK; ++e) {
          lo[e] = e < KL && i > 0 ? loff[e * Lr + i] : 0;
          ro[e] = e < KR && j > 0 ? roff[e * Rc + j] : 0;
          if (lo[e] > d) lo[e] = 0;
          if (ro[e] > d) ro[e] = 0;
        }
        if (i > 0) {                   // X: per left edge ext, double, open
          float best = kNeg;
          uint32_t code = kBxNone;
          const float gj = gextj[j];
#pragma unroll
          for (int e = 0; e < kMaxK; ++e) {
            const int o = lo[e];
            if (o <= 0) continue;
            const float c0 = at(o, 1, i - o) + gj;
            const float c1 = at(o, 2, i - o) + lgo;
            const float c2 = (at(o, 0, i - o) + lng) + lopen[e * Lr + i];
            if (c0 > best) { best = c0; code = 3 * e; }
            if (c1 > best) { best = c1; code = 3 * e + 1; }
            if (c2 > best) { best = c2; code = 3 * e + 2; }
          }
          if (isfinite(best)) { X = best; cx = code; }
        }
        if (j > 0) {                   // Y: per right edge ext, double, open
          float best = kNeg;
          uint32_t code = kByNone;
          const float ge = gexti[i];
#pragma unroll
          for (int e = 0; e < kMaxK; ++e) {
            const int r = ro[e];
            if (r <= 0) continue;
            const float c0 = at(r, 2, i) + ge;
            const float c1 = at(r, 1, i) + lgo;
            const float c2 = (at(r, 0, i) + lng) + ropen[e * Rc + j];
            if (c0 > best) { best = c0; code = 3 * e; }
            if (c1 > best) { best = c1; code = 3 * e + 1; }
            if (c2 > best) { best = c2; code = 3 * e + 2; }
          }
          if (isfinite(best)) { Y = best; cy = code; }
        }
        if (i > 0 && j > 0) {          // M: left edge outer, right inner
          float best = kNeg;
          uint32_t code = kBmNone;
          int cs = rs[j];
          cs = cs < 0 ? 0 : (cs > nf - 1 ? nf - 1 : cs);
          const float mbase = lng + tab[ls[i] * nf + cs];
          float rw[kMaxK];
#pragma unroll
          for (int er = 0; er < kMaxK; ++er)
            rw[er] = ro[er] > 0 ? rlw[er * Rc + j] : 0.f;
#pragma unroll
          for (int el = 0; el < kMaxK; ++el) {
            const int s = lo[el];
            if (s <= 0) continue;
            const float lwb = mbase + llw[el * Lr + i];
#pragma unroll
            for (int er = 0; er < kMaxK; ++er) {
              const int r = ro[er];
              if (r <= 0 || s + r > d) continue;
              const float base = lwb + rw[er];
              const uint32_t c0 = 3 * (el * KR + er);
              const float v0 = (at(s + r, 0, i - s) + lng) + base;
              const float v1 = at(s + r, 1, i - s) + base;
              const float v2 = at(s + r, 2, i - s) + base;
              if (v0 > best) { best = v0; code = c0; }
              if (v1 > best) { best = v1; code = c0 + 1; }
              if (v2 > best) { best = v2; code = c0 + 2; }
            }
          }
          if (isfinite(best)) { M = best; cm = code; }
        }
      }
      M0[t] = M;
      X0[t] = X;
      Y0[t] = Y;
      bp[(size_t)d * W + t] = cm + (cx << 16) + (cy << 24);
    }
    if (d == cornerd) {
      __syncthreads();
      const int Gs = a.Gs;
      float* snap = a.snap + (size_t)b * 3 * Gs * W;
      for (int q = threadIdx.x; q < 3 * Gs * W; q += blockDim.x) {
        const int t = q % W, g = (q / W) % Gs, m = q / (W * Gs);
        snap[q] = (d - g >= 0 && g < Gr) ? plane(slot(g), m)[t] : kNeg;
      }
    }
  }
  for (int d = dend + 1; d < D; ++d)
    for (int t = threadIdx.x; t < W; t += blockDim.x)
      bp[(size_t)d * W + t] = kFanNone;
}

ffi::Error check(cudaError_t e) {
  if (e != cudaSuccess)
    return ffi::Error::Internal(std::string("CUDA: ") + cudaGetErrorString(e));
  return ffi::Error::Success();
}

// dynamic shared memory above 48 KB must be allowed per kernel
template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

int block_threads(int n) {
  int t = n < kMaxThreads ? n : kMaxThreads;
  return ((t + 31) / 32) * 32;
}

ffi::Error LinearFillImpl(
    cudaStream_t stream, ffi::Buffer<ffi::F32> rowf,
    ffi::Buffer<ffi::S32> rowi, ffi::Buffer<ffi::F32> colf,
    ffi::Buffer<ffi::S32> coli, ffi::Buffer<ffi::F32> tab,
    ffi::Buffer<ffi::F32> fsc, ffi::Buffer<ffi::S32> isc,
    ffi::Buffer<ffi::S32> ilo, ffi::ResultBuffer<ffi::U8> bp,
    ffi::ResultBuffer<ffi::F32> fin, ffi::ResultBuffer<ffi::F32> bnd,
    ffi::ResultBuffer<ffi::S32> prog, ffi::ResultBuffer<ffi::F32> gst,
    ffi::ResultBuffer<ffi::S32> ticket, int64_t T, int64_t nblk,
    int64_t smem_state) {
  auto bd = bp->dimensions();            // (B, D, W)
  LinArgs a;
  a.rowf = rowf.typed_data();
  a.rowi = rowi.typed_data();
  a.colf = colf.typed_data();
  a.coli = coli.typed_data();
  a.tab = tab.typed_data();
  a.fsc = fsc.typed_data();
  a.isc = isc.typed_data();
  a.ilo = ilo.typed_data();
  a.bp = bp->typed_data();
  a.fin = fin->typed_data();
  a.bnd = bnd->typed_data();
  a.prog = prog->typed_data();
  a.gst = gst->typed_data();
  a.ticket = ticket->typed_data();
  a.Lr = (int)rowf.dimensions()[2];
  a.Rc = (int)colf.dimensions()[2];
  const int64_t nf2 = tab.dimensions()[1];
  a.nf = 1;
  while ((int64_t)a.nf * a.nf < nf2) ++a.nf;
  a.D = (int)bd[1];
  a.W = (int)bd[2];
  a.T = (int)T;
  a.nblk = (int)nblk;
  const int B = (int)bd[0];
  if (a.nf * a.nf != nf2 || (int64_t)a.T * a.nblk < a.W)
    return ffi::Error::InvalidArgument("linear fill: bad table or tiling");
  ffi::Error err = check(cudaMemsetAsync(prog->typed_data(), 0xFF,
                                         prog->size_bytes(), stream));
  if (err.failure()) return err;
  err = check(cudaMemsetAsync(ticket->typed_data(), 0,
                              ticket->size_bytes(), stream));
  if (err.failure()) return err;
  const int grid = a.nblk * B;
  const int threads = block_threads(a.T);
  if (smem_state) {
    const size_t smem = (size_t)9 * (a.T + 2) * sizeof(float);
    err = check(allow_smem(linear_fill_kernel<true>, smem));
    if (err.failure()) return err;
    linear_fill_kernel<true><<<grid, threads, smem, stream>>>(a);
  } else {
    linear_fill_kernel<false><<<grid, threads, 0, stream>>>(a);
  }
  return check(cudaGetLastError());
}

ffi::Error FaninFillImpl(
    cudaStream_t stream, ffi::Buffer<ffi::F32> rowf,
    ffi::Buffer<ffi::S32> rowi, ffi::Buffer<ffi::F32> colf,
    ffi::Buffer<ffi::S32> coli, ffi::Buffer<ffi::F32> tab,
    ffi::Buffer<ffi::F32> fsc, ffi::Buffer<ffi::S32> isc,
    ffi::Buffer<ffi::S32> ilo, ffi::ResultBuffer<ffi::U32> bp,
    ffi::ResultBuffer<ffi::F32> snap,
    ffi::ResultBuffer<ffi::F32> gring, int64_t Gr, int64_t PAD,
    int64_t smem_state) {
  auto bd = bp->dimensions();            // (B, D, W)
  FanArgs a;
  a.rowf = rowf.typed_data();
  a.rowi = rowi.typed_data();
  a.colf = colf.typed_data();
  a.coli = coli.typed_data();
  a.tab = tab.typed_data();
  a.fsc = fsc.typed_data();
  a.isc = isc.typed_data();
  a.ilo = ilo.typed_data();
  a.bp = bp->typed_data();
  a.snap = snap->typed_data();
  a.gring = gring->typed_data();
  a.Lr = (int)rowf.dimensions()[2];
  a.Rc = (int)colf.dimensions()[2];
  a.KL = (int)rowi.dimensions()[1] - 3;
  a.KR = (int)coli.dimensions()[1] - 1;
  const int64_t nf2 = tab.dimensions()[1];
  a.nf = 1;
  while ((int64_t)a.nf * a.nf < nf2) ++a.nf;
  a.D = (int)bd[1];
  a.W = (int)bd[2];
  a.Gr = (int)Gr;
  a.Gs = (int)snap->dimensions()[2];
  a.PAD = (int)PAD;
  const int B = (int)bd[0];
  if (a.nf * a.nf != nf2 || a.W > a.Lr || a.KL > kMaxK || a.KR > kMaxK ||
      ilo.dimensions()[0] != B || ilo.dimensions()[1] != a.D)
    return ffi::Error::InvalidArgument(
        "fan-in fill: bad table, width, edge slots or window starts");
  const int threads = block_threads(a.W);
  if (smem_state) {
    const size_t smem = (size_t)3 * a.Gr * (a.PAD + a.W) * sizeof(float);
    ffi::Error err = check(allow_smem(fanin_fill_kernel<true>, smem));
    if (err.failure()) return err;
    fanin_fill_kernel<true><<<B, threads, smem, stream>>>(a);
  } else {
    fanin_fill_kernel<false><<<B, threads, 0, stream>>>(a);
  }
  return check(cudaGetLastError());
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    Pagan2LinearFill, LinearFillImpl,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::F32>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Arg<ffi::Buffer<ffi::F32>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Arg<ffi::Buffer<ffi::F32>>()
        .Arg<ffi::Buffer<ffi::F32>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Ret<ffi::Buffer<ffi::U8>>()
        .Ret<ffi::Buffer<ffi::F32>>()
        .Ret<ffi::Buffer<ffi::F32>>()
        .Ret<ffi::Buffer<ffi::S32>>()
        .Ret<ffi::Buffer<ffi::F32>>()
        .Ret<ffi::Buffer<ffi::S32>>()
        .Attr<int64_t>("T")
        .Attr<int64_t>("nblk")
        .Attr<int64_t>("smem_state"));

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    Pagan2FaninFill, FaninFillImpl,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::F32>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Arg<ffi::Buffer<ffi::F32>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Arg<ffi::Buffer<ffi::F32>>()
        .Arg<ffi::Buffer<ffi::F32>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Ret<ffi::Buffer<ffi::U32>>()
        .Ret<ffi::Buffer<ffi::F32>>()
        .Ret<ffi::Buffer<ffi::F32>>()
        .Attr<int64_t>("Gr")
        .Attr<int64_t>("PAD")
        .Attr<int64_t>("smem_state"));
