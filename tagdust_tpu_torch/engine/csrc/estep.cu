// td_estep: the Baum-Welch E-step's forward recurrence and posterior mass,
// a hand-written Hopper (sm_90a) kernel.
//
// Replaces the XLA scan of tagdust_tpu/parallel/mesh.py:_expected_lattice_counts
// (fwd_step, :293-311), which the JAX package leaves to XLA, and the chain of
// torch ops that is its plain version (engine/estep.py:forward_counts_plain).
// Per read and position k < len, with c the read's base at k and K1's stack
// in the port's convention (slot k + 1 = the carry after positions k+1..):
//
//   w          = exp(min(ls + blstack[k+1] - logpb, 60))
//   flow(s, t) = v[s] * A[c][s, t]
//   vn[t]      = sum_s flow(s, t)
//   mass(c, s, t) += w * flow(s, t) * bstack[k+1][t]
//   v, ls      = vn / m, ls + log(m), m the row maximum (1 when it is 0)
//
// a code above 4 is a zero step (vn = 0, no mass); v and ls stay as they are
// at k >= len; the carry starts as v = e_begin, ls = 0.
//
// What bounds it on the H100: the stack, (Lp+1) * B * S * 4 bytes read once
// (6.6 GB for 16,384 reads at Lp 64 on the 96 x 8nt plate), against a few
// FMAs per non-zero entry and read.  The torch ops wrote [reads, entries]
// temporaries per position and base (about 3,800 launches a batch); here
// only the stack, the entry table and the per-block partials touch device
// memory.  What bounds this design instead (step_profile.py --estep,
// PERF.md): the step, where each tile-position walks the whole entry table
// and reads and writes every entry's f64 partial in L2 for a few reads of
// each base.
//
// Design: K2's shape (csrc/fused_dp.cu) without its label DP.  A persistent
// grid of one block per SM; block b takes the read tiles b, b + G, ... of RT
// reads (as many as the two carries leave shared memory for, at most 32,
// whole rounds of the rescale's warps), and walks the positions of each tile
// up to its longest read.  The forward carry v and the next carry vn live in
// shared memory; each position's stack row is read from device memory once.
// Per position:
//   A. warp 0 groups the tile's reads by base with ballots (the read order
//      within a base is the tile's order) and computes each read's w;
//   B. every thread takes destination items (c, t) of the entry table
//      (tables.estep_tables) statically, tid, tid + NT, ...: for the reads
//      of base c, RC at a time in registers, vn[t] over the entries into t
//      (ascending source) and each entry's mass over those reads, added to
//      its block's f64 partial of the entry.  The thread that owns an item
//      owns its entries for the whole run, so no other thread touches them:
//      no atomics, and the order of the sums is fixed;
//   C. a warp per read rescales: the row maximum, and vn / m by quot
//      (rowdiv.cuh: IEEE's quotient without the compiled division's slow
//      path, which the carry's tiny values took), vn cleared.
// The partials are f64, one row of nnz per block (132 x 32,015 x 8 bytes =
// 34 MB at the plate, inside the 50 MB L2).  estep_reduce then sums them in
// block order into each entry's mass and estep_emission sums a destination's
// entries into E[c, t].  So a launch is bit for bit repeatable, and the sums
// do not depend on which block ran first.  Tensor cores do not apply: 99.7%
// of the plate's S^2 entries are zeros.
//
// Everything else is f32.  The kernels allocate nothing: the caller passes
// the partials (zeroed), the mass and E (zeroed).  The entry point launches
// on the caller's stream and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape the kernel does not take.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "rowdiv.cuh"

namespace {

constexpr int NT = 512;     // threads of the step kernel's block
constexpr int MAX_RT = 32;  // reads per tile: warp 0's ballots group them
constexpr int RC = 8;       // reads of one base in registers at a time
constexpr int IDLE = 6;     // group of a read past its length (or the batch)

struct Table {
  const int* dst_ptr;  // [6] items of base c: dst_ptr[c] .. dst_ptr[c+1]
  const int* dst;      // [items] destination t of each item
  const int* ent_ptr;  // [items + 1] entries of each item
  const int* src;      // [nnz] source s of each entry
  const float* val;    // [nnz] A[c][s, t]
  const int* flat;     // [nnz] the entry's index in the flat mass
};

__global__ void __launch_bounds__(NT, 1)
estep_kernel(const uint8_t* __restrict__ seqs, const int* __restrict__ lens,
             const float* __restrict__ bstack, const float* __restrict__ blstack,
             const float* __restrict__ logpb, Table tab, int B, int Lp, int S,
             int begin, int nnz, int RT, double* __restrict__ part) {
  extern __shared__ float smem[];
  float* v = smem;            // [RT][S] the carry
  float* vn = smem + RT * S;  // [RT][S] the next carry, 0 outside a step
  __shared__ float ls[MAX_RT], w[MAX_RT];
  __shared__ int grp[MAX_RT];  // base 0-4, 5 a zero step, IDLE
  __shared__ int ord[5][MAX_RT];
  __shared__ int cnt[5];
  __shared__ int dptr[6];  // items of each base
  __shared__ int kmax;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarp = blockDim.x >> 5;
  if (tid < 6) dptr[tid] = tab.dst_ptr[tid];
  const int items = tab.dst_ptr[5];
  double* mine = part + (size_t)blockIdx.x * nnz;
  const int ntiles = (B + RT - 1) / RT;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int r0 = tile * RT;
    for (int i = tid; i < RT * S; i += blockDim.x) {
      v[i] = (i % S == begin) ? 1.f : 0.f;
      vn[i] = 0.f;
    }
    // warp 0's lane i keeps read i's length for the tile
    const int len = (warp == 0 && lane < RT && r0 + lane < B) ? lens[r0 + lane] : 0;
    if (warp == 0) {
      int m = len;
      for (int d = 16; d; d >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, d));
      if (lane < RT) ls[lane] = 0.f;
      if (lane == 0) kmax = min(m, Lp);
    }
    __syncthreads();
    const int K = kmax;
    for (int k = 0; k < K; ++k) {
      // A: the reads by base, and their posterior weights
      if (warp == 0) {
        const int r = r0 + lane;
        int g = IDLE;
        float wi = 0.f;
        if (k < len) {
          const int code = seqs[(size_t)r * Lp + k];
          g = code < 5 ? code : 5;
          wi = expf(fminf(ls[lane] + blstack[(size_t)(k + 1) * B + r] - logpb[r],
                          60.f));
        }
        if (lane < RT) {
          grp[lane] = g;
          w[lane] = wi;
        }
        for (int c = 0; c < 5; ++c) {
          const unsigned m = __ballot_sync(0xffffffffu, g == c);
          if (g == c) ord[c][__popc(m & ((1u << lane) - 1u))] = lane;
          if (lane == 0) cnt[c] = __popc(m);
        }
      }
      __syncthreads();

      // B: the step and the mass, an item (c, t) a thread: for the reads of
      // base c, RC at a time in registers, vn[t] over the entries into t
      // (ascending source) and each entry's mass over those reads, added to
      // the block's f64 partial of the entry
      const float* brow = bstack + ((size_t)(k + 1) * B + r0) * S;
      for (int it = tid; it < items; it += blockDim.x) {
        int c = 0;
        while (it >= dptr[c + 1]) ++c;
        const int n = cnt[c];
        if (n == 0) continue;
        const int t = tab.dst[it];
        const int e0 = tab.ent_ptr[it], e1 = tab.ent_ptr[it + 1];
        for (int i0 = 0; i0 < n; i0 += RC) {
          int row[RC];
          float q[RC], x[RC];
#pragma unroll
          for (int i = 0; i < RC; ++i) {
            // past the base's reads: row 0 with q = 0, which adds exactly 0;
            // the stack, read once, streams (evict first), so that it does
            // not push the partials out of L2
            const int r = i0 + i < n ? ord[c][i0 + i] : -1;
            row[i] = r < 0 ? 0 : r * S;
            q[i] = r < 0 ? 0.f : w[r] * __ldcs(brow + (size_t)r * S + t);
            x[i] = 0.f;
          }
          for (int e = e0; e < e1; ++e) {
            const double p = mine[e];  // issued ahead of the products
            const int s = __ldg(tab.src + e);
            const float a = __ldg(tab.val + e);
            float acc = 0.f;
#pragma unroll
            for (int i = 0; i < RC; ++i) {
              const float f = v[row[i] + s] * a;
              x[i] += f;
              acc = fmaf(q[i], f, acc);
            }
            mine[e] = p + (double)acc;
          }
#pragma unroll
          for (int i = 0; i < RC; ++i)
            if (i0 + i < n) vn[row[i] + t] = x[i];
        }
      }
      __syncthreads();

      // C: rescale each read that stepped, a warp a read (RT <= NT / 32
      // or a multiple of it): the row maximum, then x / m by quot (the
      // compiled division's slow path ran on the carry's tiny values)
      for (int i = warp; i < RT; i += nwarp) {
        if (grp[i] == IDLE) continue;
        float* vi = v + i * S;
        float* vni = vn + i * S;
        float mu[4] = {0.f, 0.f, 0.f, 0.f};
        for (int t0 = lane; t0 < S; t0 += 128) {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (t0 + 32 * u < S) mu[u] = fmaxf(mu[u], vni[t0 + 32 * u]);
        }
        float m = fmaxf(fmaxf(mu[0], mu[1]), fmaxf(mu[2], mu[3]));
        for (int d = 16; d; d >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, d));
        if (!(m > 0.f)) m = 1.f;
        const RowDiv dv = row_div(m);
#pragma unroll 4
        for (int t = lane; t < S; t += 32) {
          vi[t] = quot(vni[t], dv);
          vni[t] = 0.f;
        }
        if (lane == 0) ls[i] += logf(m);
      }
      __syncthreads();
    }
    __syncthreads();  // every thread has read kmax before the next tile's
  }
}

// each entry's mass: its G partials summed in block order (f64), written to
// its flat index as f32, and kept in f64 in block 0's row for estep_emission
__global__ void estep_reduce(double* __restrict__ part, const int* __restrict__ flat,
                             int G, int nnz, float* __restrict__ mass) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= nnz) return;
  double s = 0.0;
  for (int g = 0; g < G; ++g) s += part[(size_t)g * nnz + e];
  part[e] = s;
  mass[flat[e]] = (float)s;
}

// E[c, t]: the mass of the entries into t under base c, ascending source
__global__ void estep_emission(const double* __restrict__ total, Table tab, int S,
                               float* __restrict__ E) {
  const int it = blockIdx.x * blockDim.x + threadIdx.x;
  if (it >= tab.dst_ptr[5]) return;
  int c = 0;
  while (it >= tab.dst_ptr[c + 1]) ++c;
  double s = 0.0;
  for (int e = tab.ent_ptr[it]; e < tab.ent_ptr[it + 1]; ++e) s += total[e];
  E[c * S + tab.dst[it]] = (float)s;
}

}  // namespace

extern "C" {

// Reads per tile at S states on the current device: as many as the two
// carries leave the block's shared memory for (at most 32), 0 if one read's
// do not fit.
int td_estep_reads_per_tile(int S) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  // the kernel's static shared memory, rounded up
  const long long fixed = 2048;
  long long rt = (optin - fixed) / (2LL * S * (long long)sizeof(float));
  rt = rt < 0 ? 0 : (rt > MAX_RT ? MAX_RT : rt);
  // past a warp a read, whole rounds of the rescale's warps
  constexpr int nwarp = NT / 32;
  return (int)(rt > nwarp ? rt / nwarp * nwarp : rt);
}

// seqs [B, Lp] u8, lens [B] i32, bstack [Lp+1, B, S], blstack [Lp+1, B],
// logpb [B] f32: K1's output; the entry table (tables.estep_tables); part
// [G, nnz] f64 zeroed; mass [nnz] f32 (in count_tables' flat order); E [5, S]
// f32 zeroed.  G blocks, one per SM.
int td_estep(const uint8_t* seqs, const int* lens, const float* bstack,
             const float* blstack, const float* logpb, const int* dst_ptr,
             const int* dst, const int* ent_ptr, const int* src, const float* val,
             const int* flat, double* part, float* mass, float* E, int B, int Lp,
             int S, int begin, int nnz, int items, int G, cudaStream_t stream) {
  const int RT = td_estep_reads_per_tile(S);
  if (B < 1 || Lp < 1 || S < 1 || begin < 0 || begin >= S || nnz < 1 || items < 1 ||
      G < 1 || RT < 1)
    return (int)cudaErrorInvalidValue;
  const Table tab{dst_ptr, dst, ent_ptr, src, val, flat};
  const size_t smem = 2 * (size_t)RT * S * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      estep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  estep_kernel<<<G, NT, smem, stream>>>(seqs, lens, bstack, blstack, logpb, tab, B,
                                        Lp, S, begin, nnz, RT, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  estep_reduce<<<(nnz + 255) / 256, 256, 0, stream>>>(part, flat, G, nnz, mass);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  estep_emission<<<(items + 255) / 256, 256, 0, stream>>>(part, tab, S, E);
  return (int)cudaGetLastError();
}

}  // extern "C"
