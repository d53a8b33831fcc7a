// The division of a carry row by its maximum, shared by the dense kernels
// (fused_dp.cu: K1, K2, K4) and the E-step kernel (estep.cu).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

// The quotients x / d of one row by its maximum d > 0, rounded to nearest
// as the compiled IEEE division rounds them, without its per-element range
// check and call to a slow path (which took two thirds of the rescale's
// cycles, PERF.md).  Per row, d = dn 2^kd with dn in [1, 2) and y = RN(1/dn).  Per element, x = xs 2^-sx with
// xs = x 2^64 for x < 2^-36 (subnormals included), else xs = x, so xs and
// xs / dn lie in 2^-86..2^66, where nothing under- or overflows: q0 = RN(xs
// y) is corrected to within an ulp by q1 = q0 + r0 y, r1 = xs - dn q1 is
// exact, and by Markstein's theorem q = RN(q1 + r1 y) is the correctly
// rounded xs / dn.  x / d = (xs / dn) 2^n, n = -kd - sx: for a normal
// quotient q 2^n is exact; for a subnormal one the subnormal grid (2^-149)
// is at least as coarse as q's, so q 2^n rounds onto it as x / d does,
// except at a tie, which the sign of the exact remainder xs - dn q breaks.
// tests/test_torch_row_division.py runs the same steps in exact arithmetic.
struct RowDiv {
  float dn, y;
  int kd;
};

static __device__ __forceinline__ RowDiv row_div(float d) {
  const bool sub = d < 0x1p-126f;
  const int bits = __float_as_int(sub ? d * 0x1p64f : d);
  const float dn = __int_as_float((bits & 0x007fffff) | 0x3f800000);
  return RowDiv{dn, __frcp_rn(dn), ((bits >> 23) & 255) - 127 - (sub ? 64 : 0)};
}

// 2^n for n in -126..127
static __device__ __forceinline__ float pow2(int n) { return __int_as_float((n + 127) << 23); }

// x / d for x >= 0 (row_div(d))
static __device__ __forceinline__ float quot(float x, const RowDiv& v) {
  if (x == 0.f) return x;
  const bool small = x < 0x1p-36f;
  const float xs = small ? x * 0x1p64f : x;
  const float q0 = __fmul_rn(xs, v.y);
  const float r0 = fmaf(-v.dn, q0, xs);
  const float q1 = fmaf(v.y, r0, q0);
  const float r1 = fmaf(-v.dn, q1, xs);
  const float q = fmaf(v.y, r1, q1);
  const int n = -v.kd - (small ? 64 : 0);
  const int e = ((__float_as_int(q) >> 23) & 255) - 127 + n;  // the quotient's exponent
  if (e >= -126) {
    const int a = min(max(n, -126), 127);
    return q * pow2(a) * pow2(n - a);
  }
  if (e < -151) return 0.f;
  const float t = q * pow2(n + 149);  // the quotient in units of 2^-149, < 2^23
  const float fl = floorf(t);
  const float fr = t - fl;
  int m = (int)fl;
  if (fr > 0.5f) {
    ++m;
  } else if (fr == 0.5f) {
    const float r = fmaf(-v.dn, q, xs);
    if (r > 0.f || (r == 0.f && (m & 1))) ++m;
  }
  return __int_as_float(m);
}
