// BabyBear (P = 15 * 2^27 + 1) arithmetic for the NTT and running-product
// kernels: Montgomery multiplication with R = 2^32, and the reduction of any
// int64 to [0, P) that the plain PyTorch versions use (floored, as Python's
// and torch's %).
//
// A Montgomery product of a, b < P costs four 32-bit multiplies: the low
// and high words of a * b, m = lo * P^-1 mod 2^32, and the high word of
// m * P.  The low words of a * b and m * P are equal, so (a * b - m * P) /
// 2^32 is the difference of the high words, in (-P, P), and one conditional
// add of P makes it canonical.  It replaces a 64-bit `% P`, which nvcc
// compiles, P being a constant, into a 64-bit multiply-high by a reciprocal
// of P and a multiply back, on 32-bit multipliers.
//
// The functions are __host__ __device__ so that a host compiler can check
// them against plain integer arithmetic.
#pragma once

#include <cstdint>

#if defined(__CUDACC__)
#define ZK_HD __host__ __device__ __forceinline__
#else
#define ZK_HD inline
#endif

namespace zk {

constexpr uint32_t P = 2013265921u;

constexpr uint32_t inverse_mod_2_32(uint32_t p) {
  uint32_t x = p;                      // right to 3 bits for odd p
  for (int i = 0; i < 5; ++i) x *= 2u - p * x;   // Newton: doubles the bits
  return x;
}

constexpr uint32_t P_INV = inverse_mod_2_32(P);             // P * P_INV = 1
constexpr uint32_t R1 = static_cast<uint32_t>((uint64_t(1) << 32) % P);
constexpr uint32_t R2 = static_cast<uint32_t>(uint64_t(R1) * R1 % P);
constexpr uint32_t R3 = static_cast<uint32_t>(uint64_t(R2) * R1 % P);
static_assert(P * P_INV == 1u, "P_INV is not the inverse of P mod 2^32");

ZK_HD uint32_t mulhi(uint32_t a, uint32_t b) {
#if defined(__CUDA_ARCH__)
  return __umulhi(a, b);
#else
  return static_cast<uint32_t>((uint64_t(a) * b) >> 32);
#endif
}

// t * 2^-32 mod P, canonical, for any 64-bit t.
ZK_HD uint32_t redc(uint64_t t) {
  const uint32_t m = static_cast<uint32_t>(t) * P_INV;
  uint32_t hi = static_cast<uint32_t>(t >> 32);      // < 2^32 < 3 * P
  if (hi >= P) hi -= P;
  if (hi >= P) hi -= P;
  const uint32_t mp = mulhi(m, P);                    // < P
  return hi >= mp ? hi - mp : hi - mp + P;
}

// a * b * 2^-32 mod P for a, b < P: the product of two Montgomery forms, or
// x * w for x in standard form and w * 2^32 mod P.
ZK_HD uint32_t mont(uint32_t a, uint32_t b) {
  const uint64_t t = uint64_t(a) * b;                 // < P^2 < 2^32 * P
  const uint32_t m = static_cast<uint32_t>(t) * P_INV;
  const uint32_t hi = static_cast<uint32_t>(t >> 32);  // < P
  const uint32_t mp = mulhi(m, P);
  return hi >= mp ? hi - mp : hi - mp + P;
}

ZK_HD uint32_t add(uint32_t a, uint32_t b) {
  const uint32_t s = a + b;                           // < 2^32
  return s >= P ? s - P : s;
}

ZK_HD uint32_t sub(uint32_t a, uint32_t b) {
  return a >= b ? a - b : a + P - b;
}

// v mod P in [0, P) for any int64 v, floored; times 2^32 (Montgomery form)
// when TO_MONT.  |v| = hi * 2^32 + lo with hi, lo < 2^32 < 3P, so |v| is
// hi * R + lo mod P, and two independent Montgomery products by R^2 and R
// (R^3 and R^2) give it.
template <bool TO_MONT>
ZK_HD uint32_t reduce_i64(int64_t v) {
  const uint64_t u = v < 0 ? 0ull - static_cast<uint64_t>(v)
                           : static_cast<uint64_t>(v);     // <= 2^63
  uint32_t hi = static_cast<uint32_t>(u >> 32), lo = static_cast<uint32_t>(u);
  if (hi >= P) hi -= P;
  if (hi >= P) hi -= P;
  if (lo >= P) lo -= P;
  if (lo >= P) lo -= P;
  const uint32_t r =
      add(mont(hi, TO_MONT ? R3 : R2), mont(lo, TO_MONT ? R2 : R1));
  return (v < 0 && r != 0) ? P - r : r;
}

ZK_HD uint32_t to_mont(uint32_t a) { return mont(a, R2); }    // a < P
ZK_HD uint32_t from_mont(uint32_t a) { return redc(a); }

}  // namespace zk
