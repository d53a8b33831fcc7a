// Hand-written Hopper (sm_90a) kernel of the artifact filter's edit distance.
//
//   td_myers -> tagdust_tpu/engine/myers_tpu.py:_scan_text (a lax.scan the
//               JAX package leaves to XLA): Myers' bit-parallel best substring
//               edit distance of every read (the pattern, at most 63 symbols)
//               in each contaminant text, forward and reverse-complement
//               (filters._bpm_batch, misc.c:718-765).
//
// Design.  The recurrence is strictly serial in the text and the whole state
// of a read (VP, VN, its four pattern masks, diff, k) is ten 64-bit values,
// so one thread owns one (read, text, orientation) and keeps that state in
// registers from the first text symbol to the last; native 64-bit integers
// replace the uint32 lane pairs of the TPU version.  A block is 256 reads of
// one (text, orientation) job: its threads read the same symbol at every step,
// so the block stages the text in shared memory, 2,048 symbols at a time, and
// each step is one broadcast load.  Jobs differ in length by the texts'
// lengths; the grid holds B / 256 blocks for each, so the card stays filled
// while the long texts finish.
//
// What bounds it on the H100.  Integer operations: each (read, text symbol)
// compiles to about 34 32-bit instructions (a 64-bit add, shift or logical
// operation is two, three-input LOP3s fuse the logic; 31 of them run on the
// integer pipe, 64 lanes an SM and clock) and there is no memory traffic
// beyond the 36 bytes a read brings in and the 4 bytes it writes per job.
//
// The kernel allocates nothing, launches on the caller's stream and the
// entry point returns cudaGetLastError(), or cudaErrorInvalidValue for a
// launch geometry it does not take.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;     // reads per block
constexpr int TILE = 2048;  // text symbols staged at a time

typedef unsigned long long u64;

// text [sum T] uint8, offs [C + 1] first symbol of each text, B4 [n_orient,
// B, 4] pattern masks, m [B] pattern lengths (a lane with m < 1 runs as m = 1:
// its result is defined and the caller masks it), k_out [C, n_orient, B].
__global__ void __launch_bounds__(NT)
myers_kernel(const uint8_t* __restrict__ text, const int* __restrict__ offs,
             const ulonglong2* __restrict__ B4, const int* __restrict__ m,
             int* __restrict__ k_out, int B, int n_orient) {
  __shared__ uint8_t tile[TILE];
  const int job = blockIdx.y;
  const int c = job / n_orient;
  const int o = job - c * n_orient;
  const int t0 = offs[c];
  const int T = offs[c + 1] - t0;
  const int b = blockIdx.x * NT + threadIdx.x;
  const bool live = b < B;

  u64 b0 = 0, b1 = 0, b2 = 0, b3 = 0;
  int mm = 1;
  if (live) {
    const ulonglong2* p = B4 + ((size_t)o * B + b) * 2;
    const ulonglong2 lo = p[0], hi = p[1];
    b0 = lo.x; b1 = lo.y; b2 = hi.x; b3 = hi.y;
    mm = min(max(m[b], 1), 63);
  }
  const int sh = mm - 1;
  u64 VP = ~(~0ull << mm);
  u64 VN = 0;
  int diff = mm, k = mm;

  for (int base = 0; base < T; base += TILE) {
    const int n = min(TILE, T - base);
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += NT) tile[i] = text[t0 + base + i] & 3;
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      const int s = tile[i];
      const u64 eq = (s & 2) ? ((s & 1) ? b3 : b2) : ((s & 1) ? b1 : b0);
      u64 X = eq | VN;
      const u64 D0 = ((VP + (X & VP)) ^ VP) | X;
      const u64 HN = VP & D0;
      const u64 HP = VN | ~(VP | D0);
      X = HP << 1;
      VN = X & D0;
      VP = (HN << 1) | ~(X | D0);
      diff += (int)((HP >> sh) & 1ull) - (int)((HN >> sh) & 1ull);
      k = min(k, diff);
    }
  }
  if (live) k_out[(size_t)job * B + b] = k;
}

}  // namespace

extern "C" {

// Best distance of every pattern in every text and orientation.  Returns the
// launch's cudaError.
int td_myers(const void* text, const void* offs, int C, const void* B4,
             int n_orient, const void* m, void* k_out, int B, void* stream) {
  if (B <= 0 || C <= 0 || n_orient < 1 || (long long)C * n_orient > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((B + NT - 1) / NT, C * n_orient);
  myers_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)text, (const int*)offs, (const ulonglong2*)B4,
      (const int*)m, (int*)k_out, B, n_orient);
  return (int)cudaGetLastError();
}

}  // extern "C"
