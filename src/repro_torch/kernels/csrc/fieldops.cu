// Elementwise BabyBear arithmetic: a * b mod P and (a * b + c) mod P over
// flattened tensors of any size.
//
// Replaces the TPU kernels repro/kernels/fieldops/fieldops.py:
// _mulmod_kernel and _fma_kernel (launched by fieldops/ops.py:mulmod and
// fused_mul_add) and their blocked launcher fieldops.py:_blocked_call: the
// one launcher below serves both.
//
// What bounds it on an H100: memory.  One modular multiply (and one add)
// per element against 24 bytes (mulmod: two int64 reads, one write) or 32
// bytes (fma) moved.
//
// Design: a grid-stride loop, one element per thread per step, so
// neighbouring threads touch neighbouring words and any length runs
// without padding (the TPU wrapper pads to a multiple of 256 and slices
// back).  The TPU's 16-bit-limb multiply (fieldops.mulmod_limb) becomes the
// native 32x32->64 product and an exact reduction mod P.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint64_t P = 2013265921ULL;
constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS = 132 * 16;   // 16 blocks per SM, then stride

__device__ __forceinline__ uint32_t reduce(int64_t v) {
  return static_cast<uint32_t>(static_cast<uint64_t>(v) % P);
}

template <bool FMA>
__global__ void __launch_bounds__(THREADS)
fieldops_kernel(const int64_t* __restrict__ a, const int64_t* __restrict__ b,
                const int64_t* __restrict__ c, int64_t* __restrict__ out,
                int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    uint32_t r = static_cast<uint32_t>(
        static_cast<uint64_t>(reduce(a[i])) * reduce(b[i]) % P);
    if (FMA) {
      r += reduce(c[i]);                   // both < 2^31: no overflow
      if (r >= P) r -= static_cast<uint32_t>(P);
    }
    out[i] = r;
  }
}

}  // namespace

// a, b, out: n int64 field elements on `device`; c: n more for
// (a * b + c) mod P, or null for a * b mod P.  One launch on `stream`.
extern "C" int zk_fieldops(const void* a, const void* b, const void* c,
                           void* out, long long n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* pa = static_cast<const int64_t*>(a);
  const int64_t* pb = static_cast<const int64_t*>(b);
  const int64_t* pc = static_cast<const int64_t*>(c);
  int64_t* po = static_cast<int64_t*>(out);
  if (c != nullptr)
    fieldops_kernel<true><<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
        pa, pb, pc, po, static_cast<int64_t>(n));
  else
    fieldops_kernel<false><<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
        pa, pb, pc, po, static_cast<int64_t>(n));
  return static_cast<int>(cudaGetLastError());
}
