// H5: the exact deblend tree's level labels in cell space.
//
// Replaces zuds_tpu/ops/detect.py:482-517 (_round and its capped
// while_loop inside _deblend_exact). Input: the compact cross-cell edge
// list (int64 e_src, e_dst, e_w; an edge joins its two cells at every
// level lev < e_w; the slots from nedge on are padding with e_w = 0),
// ccap cells and L levels. Output: bl (L, ccap) int32, each level's label
// of every cell, equal to the reference bit for bit.
//
// A round, per level, on labels `lab` (start: lab[c] = c):
//   hook:  lab'[c] = min(lab[c], min over edges c->d live at this level of
//          lab[d]) -- the reference's sorted segmented min-scan;
//   jumps: three synchronous pointer jumps lab = min(lab, lab[lab]).
// At most max_rounds rounds, counting the first. A level stops once a round
// leaves it unchanged: a round is a function of the level's labels alone,
// so this equals the reference's global any(changed) test. The labels are
// capped, not converged (ROADMAP section 3), so the schedule must be this
// one: an asynchronous jump or a union-find would give other labels at
// the cap. Edges stay directed: e_src is hooked, e_dst is not.
//
// Design: one block per level, its labels in shared memory. Before the
// rounds the block reads the level's slots once, [0, min(nedge, ecap)),
// in chunks of 32 slots dealt to the warps in turn: a ballot of the live
// edges (lev < e_w); an edge dropped that repeats the previous live edge
// of its warp or the last edge kept from its source (the list comes from
// pixel pairs, so one cell boundary gives many copies of one (src, dst):
// 2206 edges and 112 pairs at level 0 of the 256^2 busy field); the rest
// packed as two 16-bit cells into one word and appended to shared memory
// through one counter. A race can only keep a copy, which the hook, a
// minimum, takes twice. Where the level's edges outgrow that space, a warp
// keeps those before its stop point there and re-reads its slots from
// that point on from global memory in every round (the chunks dealt in
// turn spread that remainder over the warps); the split changes nothing.
// Only a source of a live edge is ever hooked, and a label that was never
// hooked is its own cell, which a jump leaves alone: the copies and the
// jumps run over the level's sources alone (a list in shared memory). The
// hook target b (int32, for the shared atomicMin) starts each round as a
// copy of the labels a (uint16), so every edge reads the labels of the
// round's start; the jumps ping-pong between b and a, so each is
// synchronous. Labels only fall, so "changed" is "some step lowered some
// label", OR-ed over the block by __syncthreads_or.
//
// Bound: latency. The bytes that must move once are the live slots (24 B
// each) and the labels (4 B a cell and level), ~1.7 MB on a slice frame
// (~0.5 us at 3.35 TB/s); the level-0 block's chain of rounds (5 barriers
// each, a shared-memory pass over its edges and its sources between them)
// is the time. The dynamic shared memory attribute is set once per
// process.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
// chunks of 32 slots a warp loads and reserves at once
constexpr int kUnroll = 4;
// cells or stored edges a thread takes at once in a round's passes
constexpr int kStep = 4;
// the dynamic shared memory a block may take (227 KB, less the statics)
constexpr int kMaxDynSmem = 232448 - 64;
// a cell fits 16 bits of a packed edge; the reference's cap is 8192
constexpr int kMaxCells = 8192;
constexpr unsigned kFull = 0xffffffffu;

// the low word of an int64 cell id (cells lie in [0, ccap))
__device__ __forceinline__ int cell_at(const long long* v, int e) {
  return reinterpret_cast<const int*>(v)[2 * e];
}

// dst[c] = min(src[c], src[src[c]]) over the listed cells, kStep cells a
// thread at once (their loads issued together); returns whether any label
// fell
template <typename S, typename D>
__device__ __forceinline__ int jump(const S* __restrict__ src,
                                   D* __restrict__ dst,
                                   const uint16_t* __restrict__ list,
                                   int nlist) {
  int changed = 0;
  for (int k0 = threadIdx.x; k0 < nlist; k0 += kThreads * kStep) {
    int c[kStep], x[kStep];
#pragma unroll
    for (int j = 0; j < kStep; ++j) {
      const int k = k0 + j * kThreads;
      c[j] = k < nlist ? list[k] : -1;
    }
#pragma unroll
    for (int j = 0; j < kStep; ++j) x[j] = c[j] >= 0 ? src[c[j]] : 0;
#pragma unroll
    for (int j = 0; j < kStep; ++j) {
      if (c[j] < 0) continue;
      const int y = src[x[j]];
      dst[c[j]] = (D)min(x[j], y);
      changed |= y < x[j];
    }
  }
  return changed;
}

// the hooks of the stored edges, kStep edges a thread at once:
// b[s] = min(b[s], a[d]); a is not written meanwhile and b only falls, so
// every load may come before any atomic. Returns whether a label fell.
__device__ __forceinline__ int hook_stored(const uint16_t* __restrict__ a,
                                           int* b,
                                           const uint32_t* __restrict__ edges,
                                           int nsh) {
  int changed = 0;
  for (int k0 = threadIdx.x; k0 < nsh; k0 += kThreads * kStep) {
    int s[kStep], v[kStep], cur[kStep];
#pragma unroll
    for (int j = 0; j < kStep; ++j) {
      const int k = k0 + j * kThreads;
      const uint32_t p = k < nsh ? edges[k] : 0u;
      s[j] = (int)(p >> 16);
      v[j] = k < nsh ? a[p & 0xffffu] : 0x7fffffff;
      cur[j] = b[s[j]];
    }
#pragma unroll
    for (int j = 0; j < kStep; ++j)
      if (v[j] < cur[j]) changed |= v[j] < atomicMin(&b[s[j]], v[j]);
  }
  return changed;
}

// the hook of edge s -> d from global memory: b[s] = min(b[s], a[d])
__device__ __forceinline__ int hook(const uint16_t* __restrict__ a, int* b,
                                    int s, int d) {
  const int v = a[d];
  return v < b[s] && v < atomicMin(&b[s], v);
}

__global__ void __launch_bounds__(kThreads)
    deblend_labels_kernel(const long long* __restrict__ e_src,
                          const long long* __restrict__ e_dst,
                          const long long* __restrict__ e_w,
                          const long long* __restrict__ nedge, int ecap,
                          int ccap, int rounds, int cap_e,
                          int* __restrict__ bl) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* b = reinterpret_cast<int*>(smem);                 // ccap int32
  uint16_t* a = reinterpret_cast<uint16_t*>(b + ccap);   // ccap uint16
  uint16_t* list = a + ccap;                             // ccap uint16
  uint32_t* flags = reinterpret_cast<uint32_t*>(list + ccap);
  const int flag_words = (ccap + 3) / 4;   // a byte a cell: is a source
  uint32_t* edges = flags + flag_words;    // cap_e packed (src, dst)
  __shared__ int nfill, nlist;

  const int lev = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  for (int c = threadIdx.x; c < ccap; c += kThreads) {
    a[c] = (uint16_t)c;
    b[c] = c;
    list[c] = 0xffffu;              // no edge kept from c yet
  }
  for (int k = threadIdx.x; k < flag_words; k += kThreads) flags[k] = 0u;
  if (threadIdx.x == 0) nfill = nlist = 0;
  __syncthreads();

  // the slots [0, n), chunk k (slots 32k..32k+31) read by warp k % kWarps;
  // stop: the first of this warp's slots left in global memory (n: none)
  const long long nl = *nedge;
  const int n = (int)(nl < 0 ? 0 : (nl > ecap ? ecap : nl));
  const int nchunks = (n + 31) / 32;
  int stop = n;
#ifndef ZUDS_DEBLEND_PROBE_NO_EDGES
  unsigned last = kFull;            // this warp's previous live edge
  for (int k0 = warp; k0 < nchunks; k0 += kWarps * kUnroll) {
    long long w[kUnroll];
    int s[kUnroll], d[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = (k0 + u * kWarps) * 32 + lane;
      w[u] = e < n ? e_w[e] : 0;
      s[u] = e < n ? cell_at(e_src, e) : 0;
      d[u] = e < n ? cell_at(e_dst, e) : 0;
    }
    // the kept edges of the group's chunks, then one reservation for all
    unsigned packed[kUnroll];
    bool keep[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool live = lev < w[u];
      const unsigned lm = __ballot_sync(kFull, live);
      packed[u] = (unsigned)s[u] << 16 | (unsigned)d[u];
      const unsigned prior = lm & below;
      unsigned prev = __shfl_sync(kFull, packed[u],
                                  prior ? 31 - __clz(prior) : lane);
      if (!prior) prev = last;
      if (lm) last = __shfl_sync(kFull, packed[u], 31 - __clz(lm));
      keep[u] = live && packed[u] != prev;
    }
    // nor the last edge kept from its source before this group (list
    // holds it until the sources are listed)
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (keep[u]) keep[u] = list[s[u]] != d[u];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (keep[u]) list[s[u]] = (uint16_t)d[u];
    unsigned km[kUnroll];
    int total = 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (keep[u]) reinterpret_cast<uint8_t*>(flags)[s[u]] = 1;
      km[u] = __ballot_sync(kFull, keep[u]);
      total += __popc(km[u]);
    }
    if (total == 0 || stop < n) continue;
    int base = 0;
    if (lane == 0) base = atomicAdd(&nfill, total);
    base = __shfl_sync(kFull, base, 0);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int rank = base + __popc(km[u] & below);
      if (keep[u] && rank < cap_e) edges[rank] = packed[u];
      if (stop == n && km[u] != 0u && base + __popc(km[u]) > cap_e) {
        // the first kept edge that did not fit: it and this warp's slots
        // after it are read from global memory in every round
        const unsigned miss = __ballot_sync(kFull, keep[u] && rank == max(
            cap_e, base));
        stop = (k0 + u * kWarps) * 32 + __ffs(miss) - 1;
      }
      base += __popc(km[u]);
    }
  }
#endif
  __syncthreads();
  // the list of this level's sources, a warp's 32 flag words at a time
  for (int k0 = warp * 32; k0 < flag_words; k0 += kThreads) {
    const int k = k0 + lane;
    const uint32_t f = k < flag_words ? flags[k] : 0u;
    const int cnt = __popc(f & 0x01010101u);
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += t;
    }
    int base = 0;
    if (lane == 31) base = atomicAdd(&nlist, incl);
    base = __shfl_sync(kFull, base, 31) + incl - cnt;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if ((f >> (8 * j)) & 1u) list[base++] = (uint16_t)(4 * k + j);
  }
  __syncthreads();
  const int nsh = min(nfill, cap_e), ns = nlist;

  for (int r = 0; r < rounds; ++r) {
    int changed = 0;
#ifdef ZUDS_DEBLEND_PROBE_FIRST_HOOKS
    const bool hooks = r == 0;      // price the later rounds' hooks
#else
    const bool hooks = true;
#endif
#ifdef ZUDS_DEBLEND_PROBE_FIRST_JUMPS
    const bool jumps = r == 0;      // price the later rounds' jumps
#else
    const bool jumps = true;
#endif
    if (r > 0) {                    // b = a (both start as the identity)
#pragma unroll 4
      for (int k = threadIdx.x; k < ns; k += kThreads) {
        const int c = list[k];
        b[c] = a[c];
      }
      __syncthreads();
    }
    if (hooks) changed |= hook_stored(a, b, edges, nsh);
    for (int k0 = stop >> 5; hooks && stop < n && k0 < nchunks;
         k0 += kWarps * kUnroll) {
      long long w[kUnroll];
      int s[kUnroll], d[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int e = (k0 + u * kWarps) * 32 + lane;
        const bool in = e >= stop && e < n;
        w[u] = in ? e_w[e] : 0;
        s[u] = in ? cell_at(e_src, e) : 0;
        d[u] = in ? cell_at(e_dst, e) : 0;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (lev < w[u]) changed |= hook(a, b, s[u], d[u]);
    }
    __syncthreads();
    if (jumps) changed |= jump(b, a, list, ns);
    __syncthreads();
    if (jumps) changed |= jump(a, b, list, ns);
    __syncthreads();
    if (jumps) changed |= jump(b, a, list, ns);
#if defined(ZUDS_DEBLEND_PROBE_NO_EDGES) || defined(ZUDS_DEBLEND_PROBE_NO_EXIT)
    __syncthreads_or(changed);      // every round's barriers, no exit
#else
    if (!__syncthreads_or(changed)) break;
#endif
  }
  int* out = bl + (size_t)lev * ccap;
  for (int c = threadIdx.x; c < ccap; c += kThreads) out[c] = a[c];
}

// the shared bytes besides the edges: b, a, the list, the source flags
int fixed_smem(int ccap) {
  return 4 * ccap + 2 * ccap + 2 * ccap + 4 * ((ccap + 3) / 4);
}

// the edge slots of a block's shared memory at ccap cells and ecap slots
int edge_capacity(int ccap, int ecap) {
  const int room = (kMaxDynSmem - fixed_smem(ccap)) / 4;
  return ecap < room ? ecap : room;
}

}  // namespace

extern "C" int zuds_deblend_labels(const long long* e_src,
                                   const long long* e_dst,
                                   const long long* e_w,
                                   const long long* nedge, int ecap,
                                   int ccap, int nlev, int max_rounds,
                                   int* bl, cudaStream_t stream) {
  if (ccap < 1 || ccap > kMaxCells || nlev < 1 || ecap < 0)
    return (int)cudaErrorInvalidValue;
  static bool attribute_set = false;
  if (!attribute_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        deblend_labels_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxDynSmem);
    if (err != cudaSuccess) return (int)err;
    attribute_set = true;
  }
  const int cap_e = edge_capacity(ccap, ecap);
  // the reference always runs its first round
  const int rounds = max_rounds > 1 ? max_rounds : 1;
  deblend_labels_kernel<<<nlev, kThreads, fixed_smem(ccap) + 4 * cap_e,
                          stream>>>(
      e_src, e_dst, e_w, nedge, ecap, ccap, rounds, cap_e, bl);
  return (int)cudaGetLastError();
}
