// Poseidon2-shaped width-16 permutation over BabyBear, one thread per state.
//
// Replaces the TPU kernel repro/kernels/poseidon/poseidon.py:_permute_kernel
// (launched by poseidon.py:permute through poseidon/ops.py:permute).
//
// What bounds it on an H100: integer multiplies.  This kernel spends 8 full
// rounds x (16 S-boxes x 4 + 256 MDS products) + 14 partial rounds x
// (4 + 256) ~= 6,200 modular multiplies on a state.  The function needs 942:
// the MDS w^(i*j) is a 16-point DFT, 17 twiddle multiplies as a radix-2 FFT.
// Either way that is far more than the 16 x 8 = 128 bytes read and 128
// written, so it sits on the compute side of the roofline.
//
// Design: the 16 lanes of a state live in registers of one thread, so the
// only memory traffic is one load and one store of the state.  The MDS
// matrix and round constants (608 words) are staged once per block into
// shared memory; every thread of a warp reads the same word at the same
// time, which shared memory broadcasts.  The round loop is not unrolled
// and the MDS is read through a volatile pointer: with all 22 rounds
// unrolled, ptxas kept the 256 MDS words in registers across rounds and
// spilled (255 registers, 384 bytes of spill stores); this way each round
// reloads them from shared memory and the kernel needs no spills.  The
// TPU's 16-bit-limb multiply (fieldops.mulmod_limb) is replaced by the
// native 32x32->64 product and an exact reduction mod P; the MDS row sum
// reduces only every fourth product (4 * P^2 + P < 2^64), which gives the
// same canonical value as the reference's reduce-then-sum.  The ragged
// edge is masked, not padded.  Small launches (the transcript's single
// states, the top Merkle levels) are launch-bound; that is left as is.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint64_t P = 2013265921ULL;
constexpr int WIDTH = 16;
constexpr int HALF_FULL = 4;
constexpr int PARTIAL = 14;
constexpr int ROUNDS = 2 * HALF_FULL + PARTIAL;
constexpr int N_PARAMS = WIDTH * WIDTH + ROUNDS * WIDTH;
constexpr int THREADS = 128;

__device__ __forceinline__ uint32_t mulmod(uint32_t a, uint32_t b) {
  return static_cast<uint32_t>((static_cast<uint64_t>(a) * b) % P);
}

__device__ __forceinline__ uint32_t addmod(uint32_t a, uint32_t b) {
  uint32_t s = a + b;  // a, b < 2^31: no overflow
  return s >= P ? s - static_cast<uint32_t>(P) : s;
}

__device__ __forceinline__ uint32_t sbox(uint32_t x) {
  uint32_t x2 = mulmod(x, x);
  uint32_t x4 = mulmod(x2, x2);
  uint32_t x6 = mulmod(x4, x2);
  return mulmod(x6, x);
}

__device__ __forceinline__ void mds_mul(uint32_t (&x)[WIDTH],
                                        const volatile uint32_t* mds) {
  uint32_t y[WIDTH];
#pragma unroll
  for (int j = 0; j < WIDTH; ++j) {
    uint64_t acc = 0;
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) {
      acc += static_cast<uint64_t>(x[i]) * mds[i * WIDTH + j];
      if ((i & 3) == 3) acc %= P;
    }
    y[j] = static_cast<uint32_t>(acc);
  }
#pragma unroll
  for (int j = 0; j < WIDTH; ++j) x[j] = y[j];
}

__global__ void __launch_bounds__(THREADS)
permute_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out,
               const int64_t* __restrict__ params, int64_t n) {
  __shared__ uint32_t sp[N_PARAMS];
  for (int i = threadIdx.x; i < N_PARAMS; i += blockDim.x)
    sp[i] = static_cast<uint32_t>(params[i]);
  __syncthreads();
  const volatile uint32_t* mds = sp;   // volatile: see the note above
  const uint32_t* rc = sp + WIDTH * WIDTH;

  const int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= n) return;
  const int64_t* src = in + s * WIDTH;
  uint32_t x[WIDTH];
#pragma unroll
  for (int i = 0; i < WIDTH; ++i)
    x[i] = static_cast<uint32_t>(static_cast<uint64_t>(src[i]) % P);

#pragma unroll 1
  for (int r = 0; r < ROUNDS; ++r) {
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) x[i] = addmod(x[i], rc[r * WIDTH + i]);
    if (r < HALF_FULL || r >= HALF_FULL + PARTIAL) {
#pragma unroll
      for (int i = 0; i < WIDTH; ++i) x[i] = sbox(x[i]);
    } else {
      x[0] = sbox(x[0]);
    }
    mds_mul(x, mds);
  }

  int64_t* dst = out + s * WIDTH;
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) dst[i] = x[i];
}

}  // namespace

// in, out: (n, 16) int64 canonical field elements on `device`;
// params: (16*16 + 22*16,) int64 = MDS row-major then round constants.
extern "C" int zk_poseidon_permute(const void* in, void* out,
                                   const void* params, long long n,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  const long long blocks = (n + THREADS - 1) / THREADS;
  permute_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(in), static_cast<int64_t*>(out),
      static_cast<const int64_t*>(params), static_cast<int64_t>(n));
  return static_cast<int>(cudaGetLastError());
}
