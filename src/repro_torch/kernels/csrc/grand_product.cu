// Exclusive running products over BabyBear (Fp) and its quartic extension
// Fp4 = Fp[x]/(x^4 - 11): Z[0] = 1, Z[i] = x[0] * ... * x[i-1], the
// accumulator of the paper's Eq. (2) grand-product argument.
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
// Design: the TPU schedule (block scan, scan of the block totals, block
// offsets) in three launches, all on the device:
//   1. one block of 256 threads per chunk of 1,024 elements: each thread
//      runs the product of 4 consecutive elements, the block scans the 256
//      thread products in shared memory (Hillis-Steele, double-buffered),
//      and each thread writes its run's exclusive prefixes;
//   2. one block scans the chunk totals the same way, each thread running
//      over ceil(chunks / 256) of them, so any length works;
//   3. one thread per element multiplies it by its chunk's offset.
// The TPU's log-step doubling over a whole 256-element block (8 rounds of
// full-width products) becomes a sequential run per thread plus 8 rounds
// over 256 values.  The field is commutative and associative and its
// values are canonical, so any grouping of the products gives the
// reference's values exactly.  The ragged last chunk is masked, not padded
// with ones.  The TPU's 16-bit-limb multiply becomes the native 32x32->64
// product and an exact reduction mod P.  Loads are per-thread runs of 4
// consecutive elements, not coalesced across a warp: left as is.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint64_t P = 2013265921ULL;
constexpr uint32_t W_EXT = 11;
constexpr int THREADS = 256;
constexpr int ITEMS = 4;
constexpr int CHUNK = THREADS * ITEMS;

__device__ __forceinline__ uint32_t mulmod(uint32_t a, uint32_t b) {
  return static_cast<uint32_t>((static_cast<uint64_t>(a) * b) % P);
}

__device__ __forceinline__ uint32_t addmod(uint32_t a, uint32_t b) {
  uint32_t s = a + b;  // a, b < 2^31: no overflow
  return s >= P ? s - static_cast<uint32_t>(P) : s;
}

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ uint32_t reduce(int64_t v) {
  return static_cast<uint32_t>(static_cast<uint64_t>(v) % P);
}

struct Fp {
  static constexpr int K = 1;   // int64 words per element
  uint32_t v;
  __device__ static Fp one() { return Fp{1}; }
  __device__ static Fp load(const int64_t* p, int64_t i) {
    return Fp{reduce(p[i])};
  }
  __device__ void store(int64_t* p, int64_t i) const { p[i] = v; }
  __device__ Fp operator*(const Fp& b) const { return Fp{mulmod(v, b.v)}; }
};

struct Fp4 {
  static constexpr int K = 4;
  uint32_t c[4];
  __device__ static Fp4 one() { return Fp4{{1, 0, 0, 0}}; }
  __device__ static Fp4 load(const int64_t* p, int64_t i) {
    const int64_t* q = p + 4 * i;
    return Fp4{{reduce(q[0]), reduce(q[1]), reduce(q[2]), reduce(q[3])}};
  }
  __device__ void store(int64_t* p, int64_t i) const {
    int64_t* q = p + 4 * i;
    q[0] = c[0];
    q[1] = c[1];
    q[2] = c[2];
    q[3] = c[3];
  }
  // schoolbook product with x^4 = W_EXT, term for term as field.emul
  __device__ Fp4 operator*(const Fp4& b) const {
    const uint32_t *a_ = c, *b_ = b.c;
    uint32_t hi0 = addmod(addmod(mulmod(a_[1], b_[3]), mulmod(a_[2], b_[2])),
                          mulmod(a_[3], b_[1]));
    uint32_t hi1 = addmod(mulmod(a_[2], b_[3]), mulmod(a_[3], b_[2]));
    uint32_t hi2 = mulmod(a_[3], b_[3]);
    Fp4 r;
    r.c[0] = addmod(mulmod(a_[0], b_[0]), mulmod(W_EXT, hi0));
    r.c[1] = addmod(addmod(mulmod(a_[0], b_[1]), mulmod(a_[1], b_[0])),
                    mulmod(W_EXT, hi1));
    r.c[2] = addmod(addmod(mulmod(a_[0], b_[2]), mulmod(a_[1], b_[1])),
                    addmod(mulmod(a_[2], b_[0]), mulmod(W_EXT, hi2)));
    r.c[3] = addmod(addmod(mulmod(a_[0], b_[3]), mulmod(a_[1], b_[2])),
                    addmod(mulmod(a_[2], b_[1]), mulmod(a_[3], b_[0])));
    return r;
  }
};

// Exclusive prefix products of in[0..len) into out[0..len), by one block of
// THREADS threads; thread t runs over ceil(len / THREADS) consecutive
// elements.  If `total` is not null, the product of all len elements is
// written to total[0].  `in` is read twice and never written.
template <class T>
__device__ void block_scan(const int64_t* __restrict__ in,
                           int64_t* __restrict__ out, int64_t len,
                           int64_t* total) {
  __shared__ T buf[2][THREADS];
  const int t = threadIdx.x;
  const int64_t per = (len + THREADS - 1) / THREADS;
  const int64_t lo = imin(len, t * per);
  const int64_t hi = imin(len, lo + per);
  T run = T::one();
  for (int64_t i = lo; i < hi; ++i) run = run * T::load(in, i);
  // inclusive scan of the thread products across the block
  buf[0][t] = run;
  __syncthreads();
  int src = 0;
  for (int off = 1; off < THREADS; off <<= 1) {
    T v = buf[src][t];
    if (t >= off) v = buf[src][t - off] * v;
    buf[src ^ 1][t] = v;
    src ^= 1;
    __syncthreads();
  }
  if (total != nullptr && t == THREADS - 1) buf[src][t].store(total, 0);
  T acc = t == 0 ? T::one() : buf[src][t - 1];
  for (int64_t i = lo; i < hi; ++i) {
    const T x = T::load(in, i);
    acc.store(out, i);
    acc = acc * x;
  }
}

template <class T>
__global__ void __launch_bounds__(THREADS)
scan_chunks_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out,
                   int64_t* __restrict__ totals, int64_t n) {
  const int64_t start = static_cast<int64_t>(blockIdx.x) * CHUNK;
  const int64_t len = imin(CHUNK, n - start);
  block_scan<T>(in + start * T::K, out + start * T::K, len,
                totals + static_cast<int64_t>(blockIdx.x) * T::K);
}

template <class T>
__global__ void __launch_bounds__(THREADS)
scan_totals_kernel(const int64_t* __restrict__ totals,
                   int64_t* __restrict__ offsets, int64_t chunks) {
  block_scan<T>(totals, offsets, chunks, nullptr);
}

template <class T>
__global__ void __launch_bounds__(THREADS)
apply_offsets_kernel(int64_t* __restrict__ out,
                     const int64_t* __restrict__ offsets, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t chunk = i / CHUNK;
  if (chunk == 0) return;                 // offset of the first chunk is 1
  (T::load(out, i) * T::load(offsets, chunk)).store(out, i);
}

template <class T>
int launch(const void* in, void* out, void* totals, void* offsets,
           long long n, cudaStream_t stream) {
  const long long chunks = (n + CHUNK - 1) / CHUNK;
  scan_chunks_kernel<T><<<static_cast<unsigned>(chunks), THREADS, 0, stream>>>(
      static_cast<const int64_t*>(in), static_cast<int64_t*>(out),
      static_cast<int64_t*>(totals), static_cast<int64_t>(n));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_totals_kernel<T><<<1, THREADS, 0, stream>>>(
      static_cast<const int64_t*>(totals), static_cast<int64_t*>(offsets),
      static_cast<int64_t>(chunks));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n + THREADS - 1) / THREADS;
  apply_offsets_kernel<T><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      static_cast<int64_t*>(out), static_cast<const int64_t*>(offsets),
      static_cast<int64_t>(n));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Elements per chunk of step 1: the wrapper sizes the scratch buffers
// (chunks = ceil(n / CHUNK) elements each) from it.
extern "C" int zk_grand_product_chunk() { return CHUNK; }

// in, out: (n,) (ext == 0) or (n, 4) (ext != 0) int64 field elements on
// `device`; totals, offsets: scratch of ceil(n / CHUNK) elements each.
// Three launches on `stream`.
extern "C" int zk_grand_product(const void* in, void* out, void* totals,
                                void* offsets, long long n, int ext,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return ext ? launch<Fp4>(in, out, totals, offsets, n, s)
             : launch<Fp>(in, out, totals, offsets, n, s);
}
