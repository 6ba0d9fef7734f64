// One radix-2 decimation-in-time NTT stage over BabyBear, batched.
//
// Replaces the TPU kernel repro/kernels/ntt/ntt.py:_stage_kernel (launched
// by ntt.py:ntt_stage) and the transform around it,
// repro/kernels/ntt/ops.py:ntt, whose bit-reversal permutation and n^-1
// scale are folded into the first and last stage here.
//
// What bounds it on an H100: memory.  Each unfused stage reads and writes
// the whole (batch, n) int64 matrix and does one modular multiply per pair,
// so a stage moves 16 bytes per element against ~1 multiply.
//
// Design: one thread per butterfly, across the rows AND along them (the
// TPU kernel tiles the batch by 8; the prover's batches are 1-4 rows of up
// to 2^19 elements, so mapping blocks to rows would occupy only a few of
// the 132 SMs).  Consecutive threads handle consecutive butterflies of a
// group, so loads and stores of a warp are contiguous once m >= 32.  The
// first stage gathers its inputs through the bit-reversal permutation
// (out of place); later stages run in place; the last stage of an inverse
// transform multiplies by n^-1.  Fusing stages in shared memory is left to
// later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint64_t P = 2013265921ULL;
constexpr int THREADS = 256;

__device__ __forceinline__ uint32_t mulmod(uint32_t a, uint32_t b) {
  return static_cast<uint32_t>((static_cast<uint64_t>(a) * b) % P);
}

__global__ void __launch_bounds__(THREADS)
stage_kernel(const int64_t* src, int64_t* dst,   // may alias: no restrict
             const int64_t* __restrict__ tw, int64_t total, int log_n,
             int log_m, int bitrev, uint32_t scale) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;                       // total = batch * n / 2
  const int64_t m = int64_t(1) << log_m;
  const int64_t row = t >> (log_n - 1);
  const int64_t k = t & ((int64_t(1) << (log_n - 1)) - 1);
  const int64_t j = k & (m - 1);
  const int64_t i0 = ((k >> log_m) << (log_m + 1)) + j;
  const int64_t i1 = i0 + m;
  const int64_t base = row << log_n;
  int64_t r0 = i0, r1 = i1;
  if (bitrev) {
    r0 = static_cast<int64_t>(__brevll(static_cast<unsigned long long>(i0)) >>
                              (64 - log_n));
    r1 = static_cast<int64_t>(__brevll(static_cast<unsigned long long>(i1)) >>
                              (64 - log_n));
  }
  const uint32_t a = static_cast<uint32_t>(static_cast<uint64_t>(src[base + r0]) % P);
  const uint32_t b = static_cast<uint32_t>(static_cast<uint64_t>(src[base + r1]) % P);
  const uint32_t odd = mulmod(b, static_cast<uint32_t>(tw[j]));
  uint32_t e = a + odd;                          // < 2^32
  if (e >= P) e -= static_cast<uint32_t>(P);
  uint32_t o = a >= odd ? a - odd : a + static_cast<uint32_t>(P) - odd;
  if (scale) {
    e = mulmod(e, scale);
    o = mulmod(o, scale);
  }
  dst[base + i0] = e;
  dst[base + i1] = o;
}

}  // namespace

// One stage with half-size m = 2^log_m over a (batch, 2^log_n) int64 matrix.
// tw: the stage's m twiddles.  bitrev != 0 reads src through the
// bit-reversal permutation (first stage, src != dst); otherwise src may
// equal dst.  scale != 0 multiplies both outputs by it (last inverse stage).
extern "C" int zk_ntt_stage(const void* src, void* dst, const void* tw,
                            long long batch, int log_n, int log_m, int bitrev,
                            unsigned int scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || log_n <= 0) return 0;
  const long long total = batch << (log_n - 1);
  const long long blocks = (total + THREADS - 1) / THREADS;
  stage_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(src), static_cast<int64_t*>(dst),
      static_cast<const int64_t*>(tw), static_cast<int64_t>(total), log_n,
      log_m, bitrev, scale);
  return static_cast<int>(cudaGetLastError());
}
