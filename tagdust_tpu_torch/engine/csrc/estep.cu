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
// What bounds it on the H100: the stack, (Lp+1) * B * S * 4 bytes of which
// each step reads its row once (5.3 GB for 16,384 reads at Lp 64 on the
// 96 x 8nt plate), against a few FMAs per non-zero entry and read.  The
// first version walked an entry table in device memory and kept each
// entry's f64 partial in L2, a read-modify-write per entry and
// tile-position that bounded it on L2 round trips (PERF.md).  Here a
// tile-position touches no device memory but the stack rows, blstack, seqs
// and lens: the entry table and each entry's f64 sum live in shared memory
// for the whole launch.  What bounds this design instead (step_profile.py
// --estep, PERF.md): the latency of the dependent shared-memory loads of
// the step and the per-read phases, four barriers a position.
//
// Design: a persistent grid of thread block clusters of C blocks (C = 1, 2,
// 4 or 8, chosen per lattice by engine/estep.py:geometry, the smallest at
// which 32 reads fit; one block per SM).  Block j of a cluster owns the
// states t0[j]..t0[j+1] (engine/tables.py:estep_slices, balanced by the
// shared bytes they need): their carries v and vn for the cluster's R
// reads, state-major with a row of P = R | 1 floats (odd, and a padding
// word after each 32 rows: a warp's 32 states, or 32 reads, in 32 banks),
// every item (c, t) with t in its range, and the f64 sum of each of those
// items' entries.  A block's carry also has a halo row for each state of
// another block that its entries read; the owner pushes the state's new
// value there through distributed shared memory (st.shared::cluster at the
// address mapa gives) after each rescale, so the step reads only its own
// shared memory.  Cluster q takes the read tiles q, q + Q, ... of R reads,
// the batch's reads longest first (order), and walks the positions of each
// up to its longest read.  Per position:
//   A. warp 0 groups the tile's reads by base with ballots (the read order
//      within a base is the tile's order), with the weights w the rescale
//      computed;
//   B. the step: the items of the bases that have reads, taken from
//      shared-memory counters.  An item of more than HEAVY_ENTRIES entries is a group of
//      a warp's lanes, a lane a read: vn[t] over its entries in ascending
//      source; then a lane an entry for the mass over the reads in order.
//      Any other item is a thread's, for RC reads at a time in registers
//      (RC = 4-16, the base's reads rounded up to 4): q = w * b[t] (the
//      stack row staged in vn), then over the entries, two at a time,
//      ascending source, vn[t] += v[s] a and the entry's mass a * sum q v[s],
//      added to its f64 sum.  The item writes vn[t], every (read, t) once,
//      so the next carry needs no clearing;
//   M. a half-warp a read (reads r and r + 16 side by side, in disjoint
//      banks): the maximum of vn over the block's states, pushed to every
//      block of the cluster; cluster barrier;
//   C. a half-warp a read: the row maximum m over the blocks' maxima (the
//      same m in every block, so ls stays equal everywhere), v = vn / m by
//      quot (rowdiv.cuh: IEEE's quotient without the compiled division's
//      slow path), the next stack row into vn as its values are read
//      (loaded a batch ahead), ls += log m, the next base and w; the pushes
//      into other blocks' halo rows; cluster barrier, before the next step
//      reads the carries.
// Each entry's f64 sum has one owner in a cluster, the items and reads a
// fixed order, and the tiles a static assignment; at the end each block
// writes its sums once into its cluster's row of the partials [Q, nnz],
// estep_reduce sums the rows in cluster order into each entry's mass and
// estep_emission sums a destination's entries into E[c, t].  So a launch
// is bit for bit repeatable.  Tensor cores do not apply: 99.7% of the
// plate's S^2 entries are zeros.
//
// Everything else is f32.  The kernels allocate nothing: the caller passes
// the partials, the mass and E (zeroed).  The entry point launches on the
// caller's stream (cudaLaunchKernelEx, the cluster dimension an attribute)
// and returns cudaGetLastError(), or cudaErrorInvalidValue for a shape or
// geometry the kernel does not take (its static shared memory over the
// bound the geometry counts included).  TD_PROBE comments mark where
// step_profile.py --estep reads the clock.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "rowdiv.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 512;  // threads of the step kernel's block
constexpr int NWARP = NT / 32;
constexpr int MAX_R = 32;  // reads per tile: warp 0's ballots group them
constexpr int MAX_C = 8;   // blocks of a cluster
constexpr int RCMAX = 16;  // reads of one base in a thread's registers
// the per-read phases take a half-warp a read, reads r and r + NWARP
static_assert(2 * NWARP >= MAX_R, "a half-warp for every read of a tile");
constexpr int IDLE = 6;    // group of a read past its length (or the batch)
// the most static shared memory the step kernel may have (engine/estep.py
// counts it in a block's bytes)
constexpr int STATIC_SMEM = 3584;
constexpr unsigned FULL = 0xffffffffu;

// the entry table of engine/tables.py:estep_tables, for the reduction and E
struct Table {
  const int* dst_ptr;  // [6] items of base c: dst_ptr[c] .. dst_ptr[c+1]
  const int* dst;      // [items] destination t of each item
  const int* ent_ptr;  // [items + 1] entries of each item
  const int* flat;     // [nnz] the entry's index in the flat mass
};

// the same entries split over a cluster's blocks (engine/tables.py:estep_slices)
struct Slices {
  const int* t0;        // [C+1] block j owns the states t0[j] .. t0[j+1]
  const int* ent_off;   // [C+1] block j's entries
  const int* item_off;  // [C+1] block j's items
  const int* ibase;     // [C, 6] base c's items of block j, from item_off[j]
  const int* nheavy;    // [C, 5] the heavy items among them, first
  const int* ient;      // [items + C] block j's entry offsets from item_off[j] + j
  const int* idst;      // [items] each item's state, from t0[j]
  const int* ekey;      // [nnz] each entry's source row (word offset in its block)
  const float* eval;    // [nnz] A[c][s, t]
  const int* eidx;      // [nnz] the entry's index in Table's order
  const int* halo_off;  // [C+1] block j's halo rows
  const int* halo;      // [rows] the state of each
  const int* push_off;  // [C+1] block j's pushes
  const int2* push;     // [pushes] (its row, (rank << 24) | the halo row there)
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the shared::cluster address of shared address a in block `rank`
__device__ __forceinline__ uint32_t mapa(uint32_t a, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

// a store to another block's shared memory (distributed shared memory),
// seen there after the next cluster barrier
__device__ __forceinline__ void st_cluster(uint32_t a, float x) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(a), "f"(x) : "memory");
}

// a barrier of every thread of the cluster (release / acquire), or of the
// block
template <bool DSMEM>
__device__ __forceinline__ void cluster_barrier() {
  if (DSMEM)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// the word offset of carry row t: rows of P floats (a read each), one word
// of padding after each 32 rows, so that rows a barcode apart (a multiple
// of 8 or 16) fall in distinct banks (tables.carry_offset)
__device__ __forceinline__ int cofs(int t, int P) { return t * P + (t >> 5); }

// a 4-byte copy from device to shared memory that completes at
// cp_async_wait (cp.async, no register in between)
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
}

// read q's stack row bstack[k][q, t0..t0+wd) into column r of vn, a warp's
// cp.async copies (a tile's first position)
__device__ __forceinline__ void stage_row(const float* vn, const float* bstack, int k, int B,
                                          int S, int q, int r, int t0, int wd, int P,
                                          int lane) {
  const float* b = bstack + ((size_t)k * B + q) * S + t0 + lane;
  for (int t = lane; t < wd; t += 32, b += 32) cp_async4(smem_addr(vn + cofs(t, P) + r), b);
}

// a light item (c, t), a thread's: RC of the base's n reads at a time.  For
// read r of weight w, q = w b[t] (b staged in vn), then over the entries,
// ascending source: vn[t] += v[s] a and the mass a * sum q v[s].  Two
// entries at a time, every load of the two issued before any is used (a
// shared load takes on the order of a hundred cycles under this load).
// Every load is from a valid address and the value selected after: a load
// under a condition compiles to a branch
template <int RC>
__device__ __forceinline__ void light_item(int n, const float2* rw, float* vn,
                                           const float* v, double* sums,
                                           const uint16_t* ekey, const float* val, int P,
                                           int t, int e0, int e1) {
  const int tp = cofs(t, P);
  for (int i0 = 0; i0 < n; i0 += RC) {
    int ro[RC];
    float q[RC], x[RC];
#pragma unroll
    for (int i = 0; i < RC; ++i) {
      // past the base's reads: the last read's carry with q = 0, which adds
      // exactly 0 to the mass and is not written (every load from a valid
      // address, the value selected: a load under a condition compiles to
      // a branch)
      const float2 p = rw[min(i0 + i, n - 1)];
      ro[i] = __float_as_int(p.x);
      const float qi = __fmul_rn(p.y, vn[tp + ro[i]]);
      q[i] = i0 + i < n ? qi : 0.f;
      x[i] = 0.f;
    }
    for (int e = e0; e < e1; e += 2) {
      // a missing second entry repeats the first with a = 0
      const bool two = e + 1 < e1;
      const int e2 = two ? e + 1 : e;
      const float* v0 = v + ekey[e];
      const float* v1 = v + ekey[e2];
      const float a0 = val[e], a1r = val[e2], a1 = two ? a1r : 0.f;
      float f0[RC], f1[RC];
#pragma unroll
      for (int i = 0; i < RC; ++i) {
        f0[i] = v0[ro[i]];
        f1[i] = v1[ro[i]];
      }
      float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
      for (int i = 0; i < RC; ++i) {
        x[i] = fmaf(f0[i], a0, x[i]);
        acc0 = fmaf(q[i], f0[i], acc0);
      }
#pragma unroll
      for (int i = 0; i < RC; ++i) {
        x[i] = fmaf(f1[i], a1, x[i]);
        acc1 = fmaf(q[i], f1[i], acc1);
      }
      sums[e] += (double)__fmul_rn(acc0, a0);
      if (two) sums[e + 1] += (double)__fmul_rn(acc1, a1);
    }
#pragma unroll
    for (int i = 0; i < RC; ++i)
      if (i0 + i < n) vn[tp + ro[i]] = x[i];
  }
}

// the light items of base c (n reads), 32 a warp from the base's counter
template <int RC>
__device__ __forceinline__ void light_items(int n, int it0, int nl, int* ctr,
                                            const float2* rw, float* vn, const float* v,
                                            double* sums, const uint16_t* ekey,
                                            const float* val, const uint16_t* idst,
                                            const uint16_t* ient, int P, int lane) {
  for (;;) {
    int j0 = 0;
    if (lane == 0) j0 = atomicAdd(ctr, 32);
    j0 = __shfl_sync(FULL, j0, 0);
    if (j0 >= nl) return;
    const int it = it0 + j0 + lane;
    if (j0 + lane < nl)
      light_item<RC>(n, rw, vn, v, sums, ekey, val, P, idst[it], ient[it], ient[it + 1]);
  }
}

// up to 32 / wdt heavy items (c, t) of base c, a warp's: a group of wdt
// lanes an item (wdt the base's n reads rounded up to a power of two),
// lane i of a group read i, walks its item's entries for its read (vn[t]
// in ascending source), 16 at a time.  Then the warp takes each item's
// entries 32 at a time, a lane an entry, for their mass over the n reads
// in order (the light order), 8 reads at a time.  A batch's loads are all
// issued before any is used; vn[t] is written last, after the mass has
// read b[t] there
__device__ __forceinline__ void heavy_items(int n, int wdt, int it0, int nit,
                                            const float2* rw, float* vn, const float* v,
                                            double* sums, const uint16_t* ekey,
                                            const float* val, const uint16_t* idst,
                                            const uint16_t* ient, int P, int lane) {
  const int g = lane / wdt, i = lane - g * wdt;
  const bool live = g < nit;
  const int it = it0 + (live ? g : 0);
  const int e0 = ient[it], ne = live ? ient[it + 1] - e0 : 0;
  const bool on = live && i < n;
  const int ri = __float_as_int(rw[i].x);  // rw[i] is valid for every i < 32
  const int ro = on ? ri : 0;
  const int vo = cofs(idst[it], P) + ro;
  float x = 0.f;
  if (on) {
    for (int j0 = 0; j0 < ne; j0 += 16) {
      float f[16], a[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        // past the item's entries its last with a = 0, which leaves x exactly
        const int j = e0 + min(j0 + u, ne - 1);
        f[u] = v[ekey[j] + ro];
        const float aj = val[j];
        a[u] = j0 + u < ne ? aj : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 16; ++u) x = fmaf(f[u], a[u], x);
    }
  }
  for (int gi = 0; gi < nit; ++gi) {
    const int itg = it0 + gi, e0g = ient[itg], neg = ient[itg + 1] - e0g;
    const int tpg = cofs(idst[itg], P);
    for (int jb = 0; jb < neg; jb += 32) {
      const bool has = jb + lane < neg;
      const int j = e0g + min(jb + lane, neg - 1);
      const float* vs = v + ekey[j];
      float acc = 0.f;
      for (int i0 = 0; i0 < n; i0 += 8) {
        float f[8], qs[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const float2 pr = rw[min(i0 + u, n - 1)];
          const int roi = __float_as_int(pr.x);
          qs[u] = __fmul_rn(pr.y, vn[tpg + roi]);
          f[u] = vs[roi];
        }
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (i0 + u < n) acc = fmaf(qs[u], f[u], acc);
      }
      if (has) sums[j] += (double)__fmul_rn(acc, val[j]);
    }
  }
  __syncwarp();
  if (on) vn[vo] = x;
}

template <bool DSMEM>
__global__ void __launch_bounds__(NT, 1)
estep_kernel(const uint8_t* __restrict__ seqs, const int* __restrict__ lens,
             const int* __restrict__ order, const float* __restrict__ bstack,
             const float* __restrict__ blstack, const float* __restrict__ logpb, Slices sl,
             int B, int Lp, int S, int begin, int nnz, int C, int R, int P,
             double* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ float ls[MAX_R], lp[MAX_R], wn[MAX_R];  // wn: the next position's w
  __shared__ float pmx[MAX_C][MAX_R];  // each block's row maximum of each read
  // groups: base 0-4, 5 a zero step, IDLE; gn the next position's
  __shared__ int grp[MAX_R], gn[MAX_R], slen[MAX_R], rid[MAX_R];
  __shared__ float2 rw[5][MAX_R];  // per base its reads in order: (read, w)
  __shared__ int cnt[5], ibs[6], nhv[5];  // reads of each base; this block's items
  __shared__ uint32_t vq[MAX_C], pq[MAX_C];  // each block's v and pmx
  __shared__ int hctr[5], lctr[5], kmax;  // heavy / light items taken, per base

  /* TD_PROBE(begin) */
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = DSMEM ? (int)cg::this_cluster().block_rank() : 0;
  const int cid = blockIdx.x / C, ncl = gridDim.x / C;
  const int t0 = sl.t0[rank], wd = sl.t0[rank + 1] - t0;
  const int eo = sl.ent_off[rank], ne = sl.ent_off[rank + 1] - eo;
  const int io = sl.item_off[rank], ni = sl.item_off[rank + 1] - io;
  const int ho = sl.halo_off[rank], nh = sl.halo_off[rank + 1] - ho;
  const int po = sl.push_off[rank], np = sl.push_off[rank + 1] - po;
  // the carry (its rows, then its halo rows) at the same offset in every
  // block, the next carry, then this block's table
  float* v = reinterpret_cast<float*>(dyn);
  float* vn = v + cofs(wd + nh - 1, P) + P;
  const int cw = cofs(wd + nh - 1, P) + cofs(wd - 1, P) + 2 * P;  // both carries' words
  double* sums = reinterpret_cast<double*>(v + (cw + 1) / 2 * 2);
  int2* push = reinterpret_cast<int2*>(sums + ne);
  float* val = reinterpret_cast<float*>(push + np);
  uint16_t* ient = reinterpret_cast<uint16_t*>(val + ne);
  uint16_t* ekey = ient + ni + 1;
  uint16_t* idst = ekey + ne;

  for (int e = tid; e < ne; e += NT) {
    sums[e] = 0.0;
    val[e] = sl.eval[eo + e];
    ekey[e] = (uint16_t)sl.ekey[eo + e];
  }
  for (int i = tid; i <= ni; i += NT) ient[i] = (uint16_t)sl.ient[io + rank + i];
  for (int i = tid; i < ni; i += NT) idst[i] = (uint16_t)sl.idst[io + i];
  for (int i = tid; i < np; i += NT) push[i] = sl.push[po + i];
  if (tid < 6) ibs[tid] = sl.ibase[rank * 6 + tid];
  if (tid < 5) nhv[tid] = sl.nheavy[rank * 5 + tid];
  if (tid < C) {
    vq[tid] = DSMEM ? mapa(smem_addr(v), tid) : smem_addr(v);
    pq[tid] = DSMEM ? mapa(smem_addr(&pmx[0][0]), tid) : smem_addr(&pmx[0][0]);
  }

  const int ntiles = (B + R - 1) / R;
  for (int tile = cid; tile < ntiles; tile += ncl) {
    const int r0 = tile * R;
    // the carry starts at e_begin, its halo rows too
    for (int t = warp; t < wd + nh; t += NWARP) {
      const int st = t < wd ? t0 + t : sl.halo[ho + t - wd];
      for (int r = lane; r < P; r += 32) v[cofs(t, P) + r] = st == begin ? 1.f : 0.f;
    }
    // the tile's reads, the batch's reads in order of length (order); each
    // read's length, log P and first base and weight (ls = 0)
    if (warp == 0) {
      const int q = lane < R && r0 + lane < B ? order[r0 + lane] : -1;
      const int len = q >= 0 ? min(lens[q], Lp) : 0;
      int m = len;
      for (int d = 16; d; d >>= 1) m = max(m, __shfl_xor_sync(FULL, m, d));
      if (lane < R) {
        rid[lane] = q < 0 ? 0 : q;
        ls[lane] = 0.f;
        slen[lane] = len;
        lp[lane] = len > 0 ? logpb[q] : 0.f;
        gn[lane] = IDLE;
        if (len > 0) {
          const int code = seqs[(size_t)q * Lp];
          gn[lane] = code < 5 ? code : 5;
          wn[lane] = expf(fminf(blstack[(size_t)B + q] - lp[lane], 60.f));
        }
      }
      if (lane == 0) kmax = m;
    }
    __syncthreads();
    // the first position's stack rows
    for (int r = warp; r < R; r += NWARP)
      if (slen[r] > 0) stage_row(vn, bstack, 1, B, S, rid[r], r, t0, wd, P, lane);
    // every block's carry starts before any step reads it
    cluster_barrier<DSMEM>();
    const int K = kmax;
    for (int k = 0; k < K; ++k) {
      // A: the reads by base, with the weights the rescale computed
      if (warp == 0) {
        const int g = lane < R ? gn[lane] : IDLE;
        const float wi = g < 5 ? wn[lane] : 0.f;
        if (lane < R) grp[lane] = g;
        for (int c = 0; c < 5; ++c) {
          const unsigned m = __ballot_sync(FULL, g == c);
          if (g == c) rw[c][__popc(m & ((1u << lane) - 1u))] = make_float2(__int_as_float(lane), wi);
          if (lane == 0) {
            cnt[c] = __popc(m);
            hctr[c] = 0;
            lctr[c] = 0;
          }
        }
      }
      cp_async_wait();  // this thread's copies of the tile's first stack rows
      __syncthreads();
      /* TD_PROBE(group) */

      // B: the step and the mass of the bases that have reads: the heavy
      // items, groups of a warp's lanes each, then the light ones
      for (int c = 0; c < 5; ++c) {
        const int n = cnt[c], nh_c = nhv[c];
        if (n == 0 || nh_c == 0) continue;
        const int wdt = n > 16 ? 32 : n > 8 ? 16 : n > 4 ? 8 : n > 2 ? 4 : n;
        for (;;) {
          int j = 0;
          if (lane == 0) j = atomicAdd(&hctr[c], 32 / wdt);
          j = __shfl_sync(FULL, j, 0);
          if (j >= nh_c) break;
          heavy_items(n, wdt, ibs[c] + j, min(32 / wdt, nh_c - j), rw[c], vn, v, sums, ekey,
                      val, idst, ient, P, lane);
        }
      }
      for (int c = 0; c < 5; ++c) {
        const int n = cnt[c];
        if (n == 0) continue;
        const int it0 = ibs[c] + nhv[c], nl = ibs[c + 1] - it0;
#define TD_LIGHT(RC) \
  light_items<RC>(n, it0, nl, &lctr[c], rw[c], vn, v, sums, ekey, val, idst, ient, P, lane)
        switch ((min(n, RCMAX) + 3) >> 2) {
          case 1: TD_LIGHT(4); break;
          case 2: TD_LIGHT(8); break;
          case 3: TD_LIGHT(12); break;
          default: TD_LIGHT(16);
        }
#undef TD_LIGHT
      }
      __syncthreads();
      /* TD_PROBE(step) */

      // M: each read's maximum over this block's states, to every block of
      // the cluster, by a half-warp a read (reads r and r + 16 side by side,
      // in disjoint banks), 4 states a lane at a time; the read's next base
      // and log scale into registers
      const int hl = lane & 15;
      const int r = warp + (lane >> 4) * NWARP;
      const bool rd = r < R && grp[r] != IDLE;
      const bool next = rd && k + 1 < slen[r];
      int cn = 0;
      float bn = 0.f, m = 0.f;
      if (rd) {
        const int q = rid[r];
        if (hl == 0 && next) {
          cn = seqs[(size_t)q * Lp + k + 1];
          bn = blstack[(size_t)(k + 2) * B + q];
        }
        if (grp[r] < 5) {  // a zero step does not read vn
          for (int t = hl; t < wd; t += 64) {
            float xs[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) xs[u] = vn[cofs(min(t + 16 * u, wd - 1), P) + r];
#pragma unroll
            for (int u = 0; u < 4; ++u) m = fmaxf(m, xs[u]);
          }
        }
      }
      for (int d = 8; d; d >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, d));
      if (rd && grp[r] < 5 && hl < C) {
        if (DSMEM && hl != rank)
          st_cluster(pq[hl] + 4u * (rank * MAX_R + r), m);
        else
          pmx[rank][r] = m;
      }
      cluster_barrier<DSMEM>();
      /* TD_PROBE(max) */

      // C: the row maximum over the blocks, then x / m by quot (the compiled
      // division's slow path ran on the carry's tiny values); a zero step
      // leaves v = 0 and ls as it is.  Then the read's rows that other blocks
      // read, into their halo rows, its next stack row into vn, and its next
      // base and weight
      {
        const int g = rd ? grp[r] : IDLE;
        const float pm = pmx[min(hl, C - 1)][r];
        m = g < 5 && hl < C ? pm : 0.f;
        for (int d = 8; d; d >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, d));
        if (!(m > 0.f)) m = 1.f;
        if (rd) {
          const RowDiv dv = row_div(m);
          // 4 states a lane at a time, the next stack row's values for them
          // loaded a batch ahead and stored into vn once the batch's values
          // are read
          const float* b = bstack + ((size_t)min(k + 2, Lp) * B + rid[r]) * S + t0;
          float pf[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) pf[u] = __ldcs(b + min(hl + 16 * u, wd - 1));
          for (int t = hl; t < wd; t += 64) {
            float xs[4], pn[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) xs[u] = vn[cofs(min(t + 16 * u, wd - 1), P) + r];
#pragma unroll
            for (int u = 0; u < 4; ++u) pn[u] = __ldcs(b + min(t + 64 + 16 * u, wd - 1));
#pragma unroll
            for (int u = 0; u < 4; ++u)
              if (t + 16 * u < wd) {
                v[cofs(t + 16 * u, P) + r] = g < 5 ? quot(xs[u], dv) : 0.f;
                if (next) vn[cofs(t + 16 * u, P) + r] = pf[u];
              }
#pragma unroll
            for (int u = 0; u < 4; ++u) pf[u] = pn[u];
          }
          if (hl == 0) {
            ls[r] += logf(m);
            gn[r] = next ? (cn < 5 ? cn : 5) : IDLE;
            if (next) wn[r] = expf(fminf(ls[r] + bn - lp[r], 60.f));
          }
        }
        if (DSMEM) {
          __syncwarp();
          if (rd) {
            for (int i = hl; i < np; i += 16) {
              const int2 ps = push[i];
              st_cluster(vq[ps.y >> 24] + 4u * ((ps.y & 0xffffff) + r), v[ps.x + r]);
            }
          }
        }
      }
      // before the next step reads the carries and the halo rows
      cluster_barrier<DSMEM>();
      /* TD_PROBE(rescale) */
    }
    __syncthreads();  // every thread has read kmax before the next tile's
  }

  // each entry's sum to its index in the cluster's row of the partials
  __syncthreads();
  double* row = part + (size_t)cid * nnz;
  for (int e = tid; e < ne; e += NT) row[sl.eidx[eo + e]] = sums[e];
  __syncthreads();
  /* TD_PROBE(flush) */
}

// each entry's mass: its Q partials summed in cluster order (f64), written
// to its flat index as f32, and kept in f64 in cluster 0's row for
// estep_emission
__global__ void estep_reduce(double* __restrict__ part, const int* __restrict__ flat,
                             int Q, int nnz, float* __restrict__ mass) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= nnz) return;
  double s = 0.0;
  for (int g = 0; g < Q; ++g) s += part[(size_t)g * nnz + e];
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

// the step kernel of a cluster of C blocks, set up for smem bytes of
// dynamic shared memory; 0 on success
cudaError_t prepare(int C, int smem, void** fn) {
  *fn = C > 1 ? (void*)estep_kernel<true> : (void*)estep_kernel<false>;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, *fn);
  if (err != cudaSuccess) return err;
  if (fa.sharedSizeBytes > (size_t)STATIC_SMEM) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace

extern "C" {

// A block's shared memory on the current device
// (cudaDevAttrMaxSharedMemoryPerBlockOptin), static and dynamic together.
int td_estep_optin() {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return optin;
}

// The clusters of C blocks with smem bytes of dynamic shared memory that the
// current device holds at once (cudaOccupancyMaxActiveClusters; blocks per
// SM times SMs for C = 1): the persistent grid.  -cudaError on a failure.
int td_estep_clusters(int C, int smem) {
  if (C < 1 || C > MAX_C || smem < 0) return -(int)cudaErrorInvalidValue;
  void* fn = nullptr;
  cudaError_t err = prepare(C, smem, &fn);
  if (err != cudaSuccess) return -(int)err;
  int n = 0;
  if (C == 1) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, NT, smem);
    n *= sms;
  } else {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute at[1];
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = C;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(C);
    cfg.blockDim = dim3(NT);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = at;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&n, fn, &cfg);
  }
  if (err != cudaSuccess) return -(int)err;
  return n;
}

// seqs [B, Lp] u8, lens [B] i32, order [B] i32 (the reads by length, which
// the tiles take in turn), bstack [Lp+1, B, S], blstack [Lp+1, B], logpb [B]
// f32: K1's output; the entry table (tables.estep_tables) and its
// slices (tables.estep_slices) for clusters of C blocks of R reads (rows of
// P = R | 1 floats, smem bytes of dynamic shared memory a block:
// engine/estep.py:geometry); part [Q, nnz] f64; mass [nnz] f32 (in
// count_tables' flat order); E [5, S] f32 zeroed.  Q clusters
// (td_estep_clusters).
int td_estep(const uint8_t* seqs, const int* lens, const int* order, const float* bstack,
             const float* blstack, const float* logpb, const int* dst_ptr,
             const int* dst, const int* ent_ptr, const int* flat, const int* t0,
             const int* ent_off, const int* item_off, const int* ibase,
             const int* nheavy, const int* ient, const int* idst, const int* ekey,
             const float* eval, const int* eidx, const int* halo_off, const int* halo,
             const int* push_off, const int* push, double* part, float* mass, float* E,
             int B, int Lp, int S, int begin, int nnz, int items, int C, int R, int P,
             int smem, int Q, cudaStream_t stream) {
  if (B < 1 || Lp < 1 || S < 1 || begin < 0 || begin >= S || nnz < 1 || items < 1 ||
      C < 1 || C > MAX_C || R < 1 || R > MAX_R || P != (R | 1) || smem < 0 || Q < 1)
    return (int)cudaErrorInvalidValue;
  void* fn = nullptr;
  cudaError_t err = prepare(C, smem, &fn);
  if (err != cudaSuccess) return (int)err;
  const Slices sl{t0,   ent_off, item_off, ibase,    nheavy, ient, idst,
                  ekey, eval,    eidx,     halo_off, halo,   push_off,
                  reinterpret_cast<const int2*>(push)};
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = C;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(Q * C);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = at;
  cfg.numAttrs = C > 1 ? 1 : 0;
  void* args[] = {&seqs, &lens,  &order, &bstack, &blstack, &logpb, (void*)&sl, &B, &Lp,
                  &S,    &begin, &nnz,   &C,      &R,       &P,     &part};
  err = cudaLaunchKernelExC(&cfg, fn, args);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  estep_reduce<<<(nnz + 255) / 256, 256, 0, stream>>>(part, flat, Q, nnz, mass);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const Table tab{dst_ptr, dst, ent_ptr, flat};
  estep_emission<<<(items + 255) / 256, 256, 0, stream>>>(part, tab, S, E);
  return (int)cudaGetLastError();
}

}  // extern "C"
