// Exclusive running products over BabyBear (Fp) and its quartic extension
// Fp4 = Fp[x]/(x^4 - 11): Z[0] = 1, Z[i] = x[0] * ... * x[i-1], the
// accumulator of the paper's Eq. (2) grand-product argument, for L lanes
// of n elements in one launch.
//
// Replaces the TPU kernels repro/kernels/grand_product/grand_product.py:
// _block_scan_ext_kernel and _apply_offset_ext_kernel (launched by
// grand_product_ext, wrapper grand_product/ops.py:grand_product_ext), and
// _block_scan_kernel and _apply_offset_kernel (grand_product, wrapper
// ops.py:grand_product), with the host-side jax.lax.associative_scan over
// the block totals between them.
//
// What bounds it on an H100: memory.  An Fp4 product is 16 modular
// multiplies and 3 multiplies by W = 11, against 64 bytes moved per element
// (a (n, 4) int64 row read once and written once), so the byte side of the
// roofline is the larger one by about four times; for the base field, one
// multiply against 16 bytes, more so.
//
// Design: a single-pass chained scan with decoupled look-back (Merrill and
// Garland, "Single-pass Parallel Prefix Scan with Decoupled Look-back",
// NVIDIA 2016), one launch for every lane, lanes on gridDim.y.
//   - A block takes its (lane, chunk) from a global ticket counter, not from
//     blockIdx, so every chunk it waits on belongs to a block that has
//     started.  Chunks are CHUNK = THREADS * ITEMS elements: 256 threads
//     of 4 for Fp; 128 threads of 4 for Fp4: of five shapes timed on the
//     card, the fastest at the batch path's (4, 65,536, 4) and level with
//     256 threads of 2 at the gp path's (65,536, 4) (PERF.md section 6).
//   - Loads are striped: consecutive threads take consecutive elements (an
//     Fp4 row as two 16-byte loads), reduce them from any int64 as the plain
//     version does (floored mod P), convert them to Montgomery form and
//     store them in shared memory; each thread then takes ITEMS consecutive
//     elements from there.
//   - Each warp scans its threads' products with __shfl_up_sync on the 32-bit
//     components; warp 0 scans the warp totals the same way.
//   - Warp 0 publishes the chunk's product as its aggregate, and later its
//     inclusive prefix, in per-(lane, chunk) status words, and looks back
//     over LOOK_BACK * 32 predecessors at a time: it multiplies their
//     aggregates up to the nearest one that has published its inclusive
//     prefix.  Values are below 2^31, so each 32-bit status word carries
//     its own "published" bit: a reader needs one load per word, and no
//     fence orders a flag after the value.
//   - Results go back through shared memory and leave as striped stores.
// The status words and the ticket are cleared on the stream before every
// launch (cudaMemsetAsync), never left from an earlier call.  Multiplication
// in Fp and Fp4 is commutative and associative and exact, so this grouping
// gives the plain version's values.  Products use Montgomery multiplication
// (montgomery.cuh); an Fp4 product sums four 64-bit products per
// coefficient before one reduction.
#include <cstdint>
#include <cuda_runtime.h>

#include "montgomery.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr uint32_t W_MONT =                  // 11 * 2^32 mod P
    static_cast<uint32_t>(uint64_t(11) * zk::R1 % zk::P);
constexpr uint32_t ONE_MONT = zk::R1;        // 1 in Montgomery form
constexpr uint32_t PUBLISHED = 0x80000000u;   // set in every status word
constexpr int LOOK_BACK = 4;                   // predecessors a lane reads

struct Fp {
  static constexpr int K = 1;                // 32-bit words an element
  static constexpr int THREADS = 256;        // a block
  static constexpr int ITEMS = 4;            // elements a thread
  uint32_t c[1];
  __device__ static Fp one() { return Fp{{ONE_MONT}}; }
  __device__ static Fp load(const int64_t* p, int64_t i) {
    return Fp{{zk::reduce_i64<true>(p[i])}};
  }
  __device__ void store(int64_t* p, int64_t i) const {
    p[i] = zk::from_mont(c[0]);
  }
  __device__ Fp operator*(const Fp& b) const {
    return Fp{{zk::mont(c[0], b.c[0])}};
  }
};

struct alignas(16) Fp4 {            // 16-byte shared-memory accesses
  static constexpr int K = 4;
  static constexpr int THREADS = 128;
  static constexpr int ITEMS = 4;
  uint32_t c[4];
  __device__ static Fp4 one() { return Fp4{{ONE_MONT, 0, 0, 0}}; }
  __device__ static Fp4 load(const int64_t* p, int64_t i) {
    const longlong2* q = reinterpret_cast<const longlong2*>(p + 4 * i);
    const longlong2 lo = q[0], hi = q[1];
    return Fp4{{zk::reduce_i64<true>(lo.x), zk::reduce_i64<true>(lo.y),
                zk::reduce_i64<true>(hi.x), zk::reduce_i64<true>(hi.y)}};
  }
  __device__ void store(int64_t* p, int64_t i) const {
    longlong2* q = reinterpret_cast<longlong2*>(p + 4 * i);
    q[0] = make_longlong2(zk::from_mont(c[0]), zk::from_mont(c[1]));
    q[1] = make_longlong2(zk::from_mont(c[2]), zk::from_mont(c[3]));
  }
  // x^4 = 11: coefficient k sums a_i b_j over i + j = k and 11 a_i b_j over
  // i + j = k + 4; each sum is four products < P^2, so it fits in 64 bits
  __device__ Fp4 operator*(const Fp4& b) const {
    const uint32_t w1 = zk::mont(b.c[1], W_MONT), w2 = zk::mont(b.c[2], W_MONT),
                   w3 = zk::mont(b.c[3], W_MONT);
    const uint64_t a0 = c[0], a1 = c[1], a2 = c[2], a3 = c[3];
    Fp4 r;
    r.c[0] = zk::redc(a0 * b.c[0] + a1 * w3 + a2 * w2 + a3 * w1);
    r.c[1] = zk::redc(a0 * b.c[1] + a1 * b.c[0] + a2 * w3 + a3 * w2);
    r.c[2] = zk::redc(a0 * b.c[2] + a1 * b.c[1] + a2 * b.c[0] + a3 * w3);
    r.c[3] = zk::redc(a0 * b.c[3] + a1 * b.c[2] + a2 * b.c[1] + a3 * b.c[0]);
    return r;
  }
};

template <class T>
__device__ __forceinline__ T shfl_up(const T& v, int d) {
  T r;
#pragma unroll
  for (int k = 0; k < T::K; ++k) r.c[k] = __shfl_up_sync(FULL, v.c[k], d);
  return r;
}

template <class T>
__device__ __forceinline__ T shfl_xor(const T& v, int d) {
  T r;
#pragma unroll
  for (int k = 0; k < T::K; ++k) r.c[k] = __shfl_xor_sync(FULL, v.c[k], d);
  return r;
}

// inclusive scan across the 32 lanes of a warp
template <class T>
__device__ __forceinline__ T warp_scan(T v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T up = shfl_up(v, d);
    if (lane >= d) v = up * v;
  }
  return v;
}

template <class T>
__device__ __forceinline__ T warp_product(T v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = v * shfl_xor(v, d);
  return v;
}

// a chunk's K status words (16-byte aligned for Fp4): the value with
// PUBLISHED set, written by one store per word
template <class T>
__device__ __forceinline__ void publish(uint32_t* words, const T& v) {
  if constexpr (T::K == 4) {
    __stcg(reinterpret_cast<uint4*>(words),
           make_uint4(v.c[0] | PUBLISHED, v.c[1] | PUBLISHED,
                      v.c[2] | PUBLISHED, v.c[3] | PUBLISHED));
  } else {
    __stcg(words, v.c[0] | PUBLISHED);
  }
}

// reads a chunk's status words past the L1 cache; true and the value if
// every word has been published
template <class T>
__device__ __forceinline__ bool peek(const uint32_t* words, T& v) {
  if constexpr (T::K == 4) {
    const uint4 w = __ldcv(reinterpret_cast<const uint4*>(words));
    v.c[0] = w.x & ~PUBLISHED;
    v.c[1] = w.y & ~PUBLISHED;
    v.c[2] = w.z & ~PUBLISHED;
    v.c[3] = w.w & ~PUBLISHED;
    return (w.x & w.y & w.z & w.w) >> 31;
  } else {
    const uint32_t w = __ldcv(words);
    v.c[0] = w & ~PUBLISHED;
    return w >> 31;
  }
}

// Warp 0: the product of every chunk before `chunk` of this lane.  agg and
// prefix: this lane's status words, T::K a chunk.  Lane l reads chunk
// chunk - 1 - l - 32 k for k < LOOK_BACK, all at once, and spins until each
// has published its aggregate or its inclusive prefix; then the warp takes
// the products of all of them up to the nearest inclusive prefix.
template <class T>
__device__ T look_back(const uint32_t* agg, const uint32_t* prefix,
                       int64_t chunk, int lane) {
  T excl = T::one();
  for (int64_t top = chunk - 1;; top -= 32 * LOOK_BACK) {
    T v[LOOK_BACK];
    bool is_prefix[LOOK_BACK], known[LOOK_BACK];
#pragma unroll
    for (int k = 0; k < LOOK_BACK; ++k) {
      v[k] = T::one();
      is_prefix[k] = known[k] = top - lane - 32 * k < 0;   // before chunk 0
    }
    for (bool waiting = true; waiting;) {
      T pv[LOOK_BACK], av[LOOK_BACK];
      bool has_p[LOOK_BACK], has_a[LOOK_BACK];
#pragma unroll
      for (int k = 0; k < LOOK_BACK; ++k) {       // every load in flight
        const int64_t p = known[k] ? 0 : top - lane - 32 * k;
        has_p[k] = !known[k] && peek(prefix + p * T::K, pv[k]);
        has_a[k] = !known[k] && peek(agg + p * T::K, av[k]);
      }
      waiting = false;
#pragma unroll
      for (int k = 0; k < LOOK_BACK; ++k) {
        if (known[k]) continue;
        if (has_p[k] || has_a[k]) {
          v[k] = has_p[k] ? pv[k] : av[k];
          is_prefix[k] = has_p[k];
          known[k] = true;
        } else {
          waiting = true;
        }
      }
    }
    // the nearest inclusive prefix: the first k whose ballot has a lane,
    // its lowest lane
    int stop_k = LOOK_BACK, stop_lane = 31;
#pragma unroll
    for (int k = LOOK_BACK - 1; k >= 0; --k) {
      const unsigned found = __ballot_sync(FULL, is_prefix[k]);
      if (found) {
        stop_k = k;
        stop_lane = __ffs(found) - 1;
      }
    }
    T mine = T::one();
#pragma unroll
    for (int k = 0; k < LOOK_BACK; ++k)
      if (k < stop_k || (k == stop_k && lane <= stop_lane)) mine = mine * v[k];
    excl = excl * warp_product(mine);
    if (stop_k < LOOK_BACK) return excl;
  }
}

// scratch: L * chunks aggregates and L * chunks inclusive prefixes of T::K
// status words each, then the ticket.
template <class T>
__global__ void __launch_bounds__(T::THREADS)
running_product_kernel(const int64_t* __restrict__ in,
                       int64_t* __restrict__ out, uint32_t* scratch,
                       int64_t n) {
  constexpr int THREADS = T::THREADS, WARPS = THREADS / 32;
  constexpr int ITEMS = T::ITEMS, CHUNK = THREADS * ITEMS;
  __shared__ T items[CHUNK];
  __shared__ T warp_prefix[WARPS];
  __shared__ uint32_t ticket;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t chunks = gridDim.x;
  const int64_t slots = chunks * gridDim.y;
  if (tid == 0) ticket = atomicAdd(scratch + 2 * slots * T::K, 1u);
  __syncthreads();
  const int64_t lane_id = ticket / chunks, chunk = ticket - lane_id * chunks;
  uint32_t* agg = scratch + lane_id * chunks * T::K;
  uint32_t* prefix = scratch + (slots + lane_id * chunks) * T::K;
  const int64_t base = lane_id * n + chunk * CHUNK;
  const int len = static_cast<int>(n - chunk * CHUNK < CHUNK ? n - chunk * CHUNK
                                                             : CHUNK);

#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int e = k * THREADS + tid;
    items[e] = e < len ? T::load(in, base + e) : T::one();
  }
  __syncthreads();

  T mine[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) mine[k] = items[tid * ITEMS + k];
  T run = mine[0];
#pragma unroll
  for (int k = 1; k < ITEMS; ++k) run = run * mine[k];
  const T incl = warp_scan(run, lane);
  T excl = shfl_up(incl, 1);
  if (lane == 0) excl = T::one();
  if (lane == 31) warp_prefix[warp] = incl;       // the warp's total, for now
  __syncthreads();

  if (warp == 0) {
    T warps_incl = lane < WARPS ? warp_prefix[lane] : T::one();
#pragma unroll
    for (int d = 1; d < WARPS; d <<= 1) {       // scan the WARPS totals
      const T up = shfl_up(warps_incl, d);
      if (lane >= d) warps_incl = up * warps_incl;
    }
    T warps_excl = shfl_up(warps_incl, 1);
    if (lane == 0) warps_excl = T::one();
    T block_total;
#pragma unroll
    for (int k = 0; k < T::K; ++k)
      block_total.c[k] = __shfl_sync(FULL, warps_incl.c[k], WARPS - 1);
    T before = T::one();
    if (chunk == 0) {
      if (lane == 0) publish(prefix, block_total);
    } else {
      if (lane == 0) publish(agg + chunk * T::K, block_total);
      before = look_back<T>(agg, prefix, chunk, lane);
      if (lane == 0) publish(prefix + chunk * T::K, before * block_total);
    }
    if (lane < WARPS) warp_prefix[lane] = before * warps_excl;
  }
  __syncthreads();

  T acc = warp_prefix[warp] * excl;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    items[tid * ITEMS + k] = acc;
    acc = acc * mine[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int e = k * THREADS + tid;
    if (e < len) items[e].store(out, base + e);
  }
}

template <class T>
long long chunks_of(long long n) {
  return (n + T::THREADS * T::ITEMS - 1) / (T::THREADS * T::ITEMS);
}

template <class T>
long long scratch_words(long long n, long long lanes) {
  return 2 * lanes * chunks_of<T>(n) * T::K + 1;
}

template <class T>
int launch(const void* in, void* out, void* scratch, long long n,
           long long lanes, cudaStream_t stream) {
  const long long chunks = chunks_of<T>(n);
  if (chunks > 0x7fffffffLL || lanes > 65535 ||
      lanes * chunks > 0xffffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, sizeof(uint32_t) * scratch_words<T>(n, lanes), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(chunks), static_cast<unsigned>(lanes));
  running_product_kernel<T><<<grid, T::THREADS, 0, stream>>>(
      static_cast<const int64_t*>(in), static_cast<int64_t*>(out),
      static_cast<uint32_t*>(scratch), static_cast<int64_t>(n));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// 32-bit words of scratch a call on `lanes` lanes of n elements needs.
extern "C" long long zk_grand_product_scratch(long long n, long long lanes,
                                              int ext) {
  return ext ? scratch_words<Fp4>(n, lanes) : scratch_words<Fp>(n, lanes);
}

// in, out: (lanes, n) (ext == 0) or (lanes, n, 4) (ext != 0) int64 field
// elements on `device`, any int64 values in; scratch: the words
// zk_grand_product_scratch asks for.  One memset and one launch on `stream`.
extern "C" int zk_grand_product(const void* in, void* out, void* scratch,
                                long long n, long long lanes, int ext,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || lanes <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return ext ? launch<Fp4>(in, out, scratch, n, lanes, s)
             : launch<Fp>(in, out, scratch, n, lanes, s);
}
