// Radix-2 decimation-in-time NTT over BabyBear, batched, in passes of up to
// MAX_STAGES butterfly stages that each run in shared memory.
//
// Replaces the TPU kernel repro/kernels/ntt/ntt.py:_stage_kernel (launched
// by ntt.py:ntt_stage) and the transform around it,
// repro/kernels/ntt/ops.py:ntt, whose bit-reversal permutation and n^-1
// scale are folded into the first and last pass here.
//
// What bounds it on an H100: memory.  The transform must read the (batch,
// n) int64 matrix once and write it once; a stage is n / 2 modular
// multiplies, far below the card's multiply rate.  One launch per stage, as
// the TPU kernel does, reads and writes the matrix log2 n times.
//
// Design.  Stage s of the DIT transform (half-size m = 2^s) pairs the
// indices that differ in bit s of the bit-reversed array.  Stages [s0, s0 +
// ks) therefore act on independent tiles: the 2^ks indices lo + mid * 2^s0
// + hi * 2^(s0 + ks) for one (lo, hi), mid < 2^ks.  A pass loads C such
// tiles into shared memory, runs its ks stages there in radix-4 rounds (two
// stages a round trip through shared memory and a __syncthreads) and
// writes them back: one read and one write of the matrix a pass.
// ntt/ops.py:_passes plans the passes: the first takes up to MAX_STAGES =
// 11 stages, the rest split the remainder evenly, so a length up to 2^22
// takes two launches and 2^27 three.  A transform of more than one pass
// keeps its intermediate as uint32 in a scratch matrix (4 bytes an element
// instead of 8).
//
// Coalescing.  A later pass takes C consecutive lo for one hi: each of a
// warp's rows is C consecutive words (C = 16 or 32 on the prover's
// lengths).  The first pass reads through the bit-reversal permutation:
// element mid of tile t is x[bitrev(mid) * 2^(L - ks) + bitrev(t)], so the
// tiles of C consecutive columns c = bitrev(t) read C consecutive words of
// each row (C = 2 for an 11-stage pass: half of a 32-byte sector, whose
// other half the next block reads), and write their outputs, each tile a
// contiguous run of 2^ks words.  This keeps the DIT order of the plain
// version (poly.ntt_ref) rather than a self-sorting Stockham formulation,
// so the twiddle tables are the plain version's, stage for stage.
// Shared-memory columns are padded so that a warp's C columns fall in
// distinct banks.
//
// Twiddles.  Stage s0 + s needs w^(lo + j * 2^s0) for the root w of order
// 2^(s0 + s + 1), which is w^lo times the j-th twiddle of stage s; so a
// pass reads, besides its tiles, only the first 2^ks - 1 entries of the
// table (stages 0 .. ks - 1) and one factor w^lo per stage and tile, all
// into shared memory with its tiles, and multiplies the two in a later
// pass.  No round of butterflies waits on device memory.
//
// Arithmetic: Montgomery multiplication (montgomery.cuh) with the twiddles
// kept in Montgomery form by the host (ntt/ops.py:_twiddles), so mont(x,
// w * 2^32) = x * w and the data never leaves standard form.  Inputs are
// reduced from any int64 as the plain version does (floored mod P).  Tensor
// cores have no 31-bit modular product, so none are used.
#include <cstdint>
#include <cuda_runtime.h>

#include "montgomery.cuh"

namespace {

constexpr int MAX_STAGES = 11;        // stages of one pass
constexpr int LOG_TILE = 12;          // at most 4,096 elements a block
constexpr int LOG_MAX_COLS = 5;       // at most 32 tiles a block
constexpr int MAX_THREADS = 512;
constexpr int ELEMS = (1 << LOG_TILE) / MAX_THREADS;   // a thread's elements

__host__ __device__ inline int col_stride(int ks, int log_c) {
  const int s = 1 << ks;
  if (log_c == 0) return s;
  return s >= 32 ? s + (32 >> log_c) : s + 1;
}

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

// log2 of the tiles a block of this pass takes
__host__ __device__ inline int cols_log(int log_n, int s0, int ks) {
  return imin(imin(LOG_MAX_COLS, LOG_TILE - ks), s0 == 0 ? log_n - ks : s0);
}

__device__ __forceinline__ uint32_t load_elem(const int64_t* p, unsigned i) {
  return zk::reduce_i64<false>(p[i]);
}
__device__ __forceinline__ uint32_t load_elem(const uint32_t* p, unsigned i) {
  return p[i];                          // a previous pass's canonical value
}
template <class Out>
__device__ __forceinline__ void store_elem(Out* p, unsigned i, uint32_t v) {
  p[i] = v;                             // int64 out, or uint32 scratch
}

// Stages [s0, s0 + ks) of every row.  The grid is flat: block b takes row
// b / blocks_per_row.  src and dst may be the same scratch matrix (a middle
// pass): a block reads all of its tiles before it writes any.  tw: the
// Montgomery twiddles of every stage, the table of half-size m at offset
// m - 1.  scale != 0 multiplies the outputs by it (n^-1 * 2^32, the last
// pass of an inverse).  Offsets inside a row are 32-bit (n <= 2^27).
// Shared memory: the tiles, then the 2^ks - 1 twiddles of stages 0 .. ks-1,
// then (later passes) w^lo for each of the ks stages and C tiles.
template <class In, class Out>
__global__ void __launch_bounds__(MAX_THREADS)
ntt_pass_kernel(const In* src, Out* dst, const uint32_t* __restrict__ tw,
                int log_n, int s0, int ks, int log_c, uint32_t scale) {
  extern __shared__ uint32_t tile[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int C = 1 << log_c, S = 1 << ks, total = C << ks;
  const int stride = col_stride(ks, log_c);
  uint32_t* const local_tw = tile + C * stride;
  uint32_t* const col_tw = local_tw + S;
  const bool first = s0 == 0;
  const unsigned per_row = (1u << (log_n - ks)) >> log_c;
  const int64_t row = blockIdx.x / per_row;
  const unsigned g = blockIdx.x - static_cast<unsigned>(row) * per_row;
  const In* in = src + (row << log_n);
  Out* out = dst + (row << log_n);
  // first pass: tiles of the columns c0 .. c0 + C - 1, column c read at
  // stride 2^(L - ks); later passes: lo0 .. lo0 + C - 1 of one hi
  const unsigned c0 = g << log_c;
  const unsigned lo0 = first ? 0u : (g & ((1u << (s0 - log_c)) - 1)) << log_c;
  const unsigned hi_base = first ? 0u : (g >> (s0 - log_c)) << (s0 + ks);
  const int rev = 32 - ks;

  // every thread's loads are in flight before the first one is used
  uint32_t v[ELEMS];
#pragma unroll
  for (int k = 0; k < ELEMS; ++k) {
    const int e = tid + k * nt;
    if (e < total) {
      const unsigned col = e & (C - 1), mid = e >> log_c;
      const unsigned at =
          first ? ((__brev(mid) >> rev) << (log_n - ks)) + c0 + col
                : hi_base + lo0 + col + (mid << s0);
      v[k] = load_elem(in, at);
    }
  }
  // the twiddles too: S - 1 and ks * C entries, both at most ELEMS * nt
  uint32_t t[ELEMS], f[ELEMS];
#pragma unroll
  for (int k = 0; k < ELEMS; ++k) {
    const int i = tid + k * nt;
    if (i < S - 1) t[k] = __ldg(tw + i);
    if (!first && i < (ks << log_c))
      f[k] = __ldg(tw + (1u << (s0 + (i >> log_c))) - 1 + lo0 + (i & (C - 1)));
  }
#pragma unroll
  for (int k = 0; k < ELEMS; ++k) {
    const int i = tid + k * nt;
    if (i < total) tile[(i & (C - 1)) * stride + (i >> log_c)] = v[k];
    if (i < S - 1) local_tw[i] = t[k];
    if (!first && i < (ks << log_c)) col_tw[i] = f[k];
  }
  __syncthreads();

  // radix-4 rounds: stages s and s + 1 on the four indices i, i + h,
  // i + 2h, i + 3h (bits s and s + 1 of i clear), one shared-memory round
  // trip and one __syncthreads for two stages
  int s = 0;
  for (; s + 1 < ks; s += 2) {
    const int h = 1 << s;
#pragma unroll
    for (int k = 0; k < ELEMS / 4; ++k) {
      const int q4 = tid + k * nt;
      if (q4 < (total >> 2)) {
        const int col = q4 & (C - 1), q = q4 >> log_c;
        const int j = q & (h - 1);
        uint32_t* x = tile + col * stride + ((q >> s) << (s + 2)) + j;
        uint32_t w1 = local_tw[h - 1 + j], w2 = local_tw[2 * h - 1 + j],
                 w3 = local_tw[3 * h - 1 + j];
        if (!first) {
          const uint32_t f2 = col_tw[((s + 1) << log_c) + col];
          w1 = zk::mont(w1, col_tw[(s << log_c) + col]);
          w2 = zk::mont(w2, f2);
          w3 = zk::mont(w3, f2);
        }
        const uint32_t x0 = x[0], x1 = x[h], x2 = x[2 * h], x3 = x[3 * h];
        const uint32_t t1 = zk::mont(x1, w1), t3 = zk::mont(x3, w1);
        const uint32_t y0 = zk::add(x0, t1), y1 = zk::sub(x0, t1);
        const uint32_t y2 = zk::add(x2, t3), y3 = zk::sub(x2, t3);
        const uint32_t u2 = zk::mont(y2, w2), u3 = zk::mont(y3, w3);
        x[0] = zk::add(y0, u2);
        x[2 * h] = zk::sub(y0, u2);
        x[h] = zk::add(y1, u3);
        x[3 * h] = zk::sub(y1, u3);
      }
    }
    __syncthreads();
  }
  if (s < ks) {                        // an odd stage count: one radix-2
    const int h = 1 << s;
#pragma unroll
    for (int k = 0; k < ELEMS / 2; ++k) {
      const int b = tid + k * nt;
      if (b < (total >> 1)) {
        const int col = b & (C - 1), q = b >> log_c;
        const int j = q & (h - 1);
        uint32_t* x = tile + col * stride + ((q >> s) << (s + 1)) + j;
        const uint32_t a = x[0];
        uint32_t w = local_tw[h - 1 + j];
        if (!first) w = zk::mont(w, col_tw[(s << log_c) + col]);
        const uint32_t odd = zk::mont(x[h], w);
        x[0] = zk::add(a, odd);
        x[h] = zk::sub(a, odd);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int k = 0; k < ELEMS; ++k) {
    const int e = tid + k * nt;
    if (e < total) {
      // first pass: tile t = bitrev(c) holds outputs t * 2^ks + mid, a
      // contiguous run, so consecutive threads take consecutive mid
      const unsigned col = first ? e >> ks : e & (C - 1);
      const unsigned mid = first ? e & (S - 1) : e >> log_c;
      uint32_t r = tile[col * stride + mid];
      if (scale) r = zk::mont(r, scale);
      const unsigned t = log_n == ks ? 0u
                                     : __brev(c0 + col) >> (32 - log_n + ks);
      store_elem(out, first ? (t << ks) + mid
                            : hi_base + lo0 + col + (mid << s0), r);
    }
  }
}

template <class In, class Out>
cudaError_t launch(const void* src, void* dst, const uint32_t* tw,
                   long long batch, int log_n, int s0, int ks,
                   uint32_t scale, cudaStream_t stream) {
  const int log_c = cols_log(log_n, s0, ks);
  const long long blocks = batch * ((1LL << (log_n - ks)) >> log_c);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  // ELEMS elements a thread, at most MAX_THREADS, at least a warp
  int nt = imin(MAX_THREADS, (1 << (ks + log_c)) / ELEMS);
  if (nt < 32) nt = 32;
  const size_t smem =
      sizeof(uint32_t) * ((size_t(1) << log_c) * col_stride(ks, log_c) +
                          (size_t(1) << ks) + (s0 == 0 ? 0 : ks << log_c));
  ntt_pass_kernel<In, Out>
      <<<static_cast<unsigned>(blocks), nt, smem, stream>>>(
          static_cast<const In*>(src), static_cast<Out*>(dst), tw, log_n, s0,
          ks, log_c, scale);
  return cudaGetLastError();
}

}  // namespace

// Stages [s0, s0 + ks) of the DIT NTT of a (batch, 2^log_n) matrix, one
// launch on `stream`.  src is int64 (src64 != 0, any values, reduced as the
// plain version does) or the uint32 scratch of a previous pass; dst is int64
// (dst64 != 0) or uint32 scratch, and may equal src only when both are
// scratch.  The pass with s0 == 0 reads src through the bit-reversal
// permutation.  tw: uint32 Montgomery twiddles of every stage (the table of
// half-size m at offset m - 1).  scale != 0: multiply the outputs by
// scale * 2^-32 mod P.
extern "C" int zk_ntt_pass(const void* src, void* dst, const void* tw,
                           long long batch, int log_n, int s0, int ks,
                           int src64, int dst64, unsigned int scale,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ks < 1 || ks > MAX_STAGES || s0 < 0 || s0 + ks > log_n || batch < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const uint32_t* t = static_cast<const uint32_t*>(tw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (src64 && dst64)
    err = launch<int64_t, int64_t>(src, dst, t, batch, log_n, s0, ks, scale,
                                   s);
  else if (src64)
    err = launch<int64_t, uint32_t>(src, dst, t, batch, log_n, s0, ks, scale,
                                    s);
  else if (dst64)
    err = launch<uint32_t, int64_t>(src, dst, t, batch, log_n, s0, ks, scale,
                                    s);
  else
    err = launch<uint32_t, uint32_t>(src, dst, t, batch, log_n, s0, ks, scale,
                                     s);
  return static_cast<int>(err);
}
