// Paged decode attention for Hopper (sm_90a), bound to Python with ctypes.
//
// One kernel body, `paged_kernel`, replaces the three TPU (Pallas) kernels
// of src/repro/kernels/paged_attention.py:
//   paged_attention_launch         <- paged_attention / _kernel (def :462,
//                                     pallas_call :491)
//   fused_decode_attention_launch  <- fused_decode_attention / _fused_kernel
//                                     (def :147, pallas_call :205)
//   fused_verify_attention_launch  <- fused_verify_attention (def :290,
//                                     pallas_call :398; what its one-pass
//                                     _verify_multirow / _verify_kernel
//                                     intend; its chained _verify_unrolled
//                                     is the parity target)
//
// Layout, as in the reference: k/v pools (P,page,KV,D); block tables
// (B,n_max) int32; query head h*G+g belongs to kv-head h (G = H/KV).  The
// body takes W window rows per lane: q (B,W,H,D), new K/V (B,W,KV,D), row
// 0's position and the live width (B,).  Row s of lane b is the decode step
// at position p0+s and attends ctx = p0+s+1 tokens (never past the table).
// The entry points are the body with:
//   fused_verify_attention  W rows, p0 = pos0, widths given;
//   fused_decode_attention  W = 1, p0 = positions, width 1;
//   paged_attention         W = 1, p0 = ctx_lens - 1, width 1, and every
//                           token from the pool: nothing is written.
// So a live verify row is bitwise the decode step at its position (spec-on
// token streams equal spec-off), and paged_attention is bitwise
// fused_decode_attention on the pools that one wrote (fused and unfused
// streams agree): one body, one sequence of arithmetic per (row, head).
//
// What bounds it: memory.  A lane reads ctx*KV*D K and V elements for
// about 4*ctx*H*D flops, near one flop per byte in bf16, far below the
// roughly 295 flops per byte where the H100's arithmetic becomes the limit:
// at B=8, ctx 512, H=32, KV=4, D=64, bf16 the bytes take 1.28 us at 3.35
// TB/s.  A block walks only the live tokens of its lane (the Pallas grid
// visits all n_max pages and masks the dead ones) and stages each K/V row
// once for all the (row, head) tasks of its kv-head, so each element is
// read from device memory once per block that needs it.
//
// What the design does about it: fill the card, and overlap copies.
// - Tasks.  A task is one query head g of one window row s (task s*G+g); a
//   block takes `per` consecutive tasks of one (lane, kv-head), one warp per
//   task (a warp runs its tasks in turn).  The host picks `per`
//   (kernels/paged_attention.py, blocking): enough for the block's 8 warps,
//   fewer where shared memory runs out.
// - Chunks.  A block covers one chunk of kChunk consecutive tokens, [c*C,
//   (c+1)*C).  The grid is (B, KV, task groups x chunks), with chunks =
//   ceil(n_max*page / C), the table's capacity: shapes alone, no length read
//   back to the host.  A block whose chunk starts at or past its live rows'
//   contexts exits at once.  The split points are fixed token offsets,
//   independent of B, W, `per` or the call's shape, so a row's arithmetic
//   depends on its position alone: that keeps the bitwise contract above
//   and results independent of batch grouping.
// - Merge.  A row whose context fits in one chunk is finished by that
//   block, which writes its output.  Otherwise each block writes the row's
//   f32 partial (m, l, acc[D]) for its chunk; the block that takes the last
//   ticket of its (lane, kv-head, task group) (an atomic counter, after
//   __threadfence; it resets the counter to 0) merges each such row over
//   exactly the chunks its context reaches, in chunk order, as the online
//   softmax merges tiles: m' = max(m, m_c), l' = l*exp(m-m') +
//   l_c*exp(m_c-m'), acc' the same, out = acc/max(l, 1e-30).  Blocks finish
//   in any order; the merge's order does not depend on it.  No float
//   atomics.
// - Copies.  Inside its chunk a block walks 64-token tiles through a
//   two-stage ring in shared memory (cp.async, 16 bytes a thread), two tiles
//   in flight ahead of the one scored, as stored (bf16 or f32).  Tokens of
//   the window itself (p0 .. p0+width-1) are staged from k_new / v_new, the
//   bits the pool will hold, so no block reads a slot that is being
//   written; the block of task group 0 and chunk 0 alone writes the live
//   rows into the pool.  Rows at or past the width write nothing, not even
//   their output rows, which are unspecified.  Retired and padded lanes
//   carry all-scrap tables, so several blocks may write the scrap page at
//   once; no live table names that page, so the race is benign.
// - Per tile, a warp scores its task against the tile's keys (a lane scores
//   keys lane and lane+32, each one fmaf chain over d, then the scale), takes
//   the online-softmax step (tile max and sum lane-strided, then
//   butterflies; l = l*corr + sum), and adds p.v (a lane owns pairs of value
//   columns, each one fmaf chain over the tile's keys; acc = acc*corr + pv).
//   bf16 is widened to f32 two at a time by shifts and masks, which is
//   exact.  The tensor cores would sum q.k in another order; they are not
//   used (the per-tile arithmetic is not what bounds the split kernel).
//
// Each C entry point returns cudaGetLastError() as an int (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#ifndef REPRO_CHUNK
#define REPRO_CHUNK 128
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;            // tokens staged in shared memory per step
constexpr int kChunk = REPRO_CHUNK;  // tokens a block covers
constexpr float kNegInf = -1e30f;    // the reference's NEG_INF
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory of a block
constexpr int kStages = 2;           // the copy ring
static_assert(kChunk % kTile == 0 && kChunk > 0, "whole tiles per chunk");

struct Geometry {
  int H, KV, D, page, n_max;
  float scale;
};

// A launch's tensors and blocking.  fused: window rows come from k_new /
// v_new and are written into the pools; lens holds each lane's row-0
// position (fused) or context length (attend only); widths may be null
// (every row live).
template <typename T>
struct Params {
  const T* q;
  const T* k_new;
  const T* v_new;
  T* kpool;
  T* vpool;
  const int* tables;
  const int* lens;
  const int* widths;
  T* out;
  float* part;   // f32 (m, l, acc[D]) per (lane, kv-head, task, chunk)
  int* tickets;  // zeroed counters per (lane, kv-head, task group)
  int W, per, groups;
};

__host__ __device__ inline int num_chunks(int tokens) {
  return (tokens + kChunk - 1) / kChunk;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Widen 16 bytes of elements to f32: bf16 pairs by a shift and a mask (the
// bf16 bits are the high half of the f32), exactly as __bfloat162float.
__device__ __forceinline__ void widen(const uint4& raw, float (&f)[4]) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void widen(const uint4& raw, float (&f)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
// two consecutive elements (a value-column pair)
__device__ __forceinline__ float2 widen2(const float* v) {
  return *reinterpret_cast<const float2*>(v);
}
__device__ __forceinline__ float2 widen2(const __nv_bfloat16* v) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(v);
  return make_float2(__uint_as_float(w << 16),
                     __uint_as_float(w & 0xffff0000u));
}

// butterfly reductions: every lane ends with the same, order-fixed value
__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---------------------------------------------------------------------------
// The per-tile steps of one (row, head)
// ---------------------------------------------------------------------------

// Scores of query q (D f32) against key rows k and k + kstep: each one fmaf
// chain over d = 0..D-1, then the scale (an unfused multiply, so that the
// compiler does not fold it into the next subtraction).  With kVec the key
// rows are 16-byte aligned and read 16 bytes at a time, and q as float4.
template <bool kVec, typename T>
__device__ __forceinline__ void score_pair(const float* q, const T* k,
                                           int kstep, int D, float scale,
                                           float (&s)[2]) {
  float dot[2] = {0.f, 0.f};
  if constexpr (kVec) {
    constexpr int kE = 16 / sizeof(T);  // elements per 16 bytes
    for (int d0 = 0; d0 < D; d0 += kE) {
      float qv[kE];
#pragma unroll
      for (int i = 0; i < kE; i += 4) {
        const float4 q4 = *reinterpret_cast<const float4*>(q + d0 + i);
        qv[i] = q4.x;
        qv[i + 1] = q4.y;
        qv[i + 2] = q4.z;
        qv[i + 3] = q4.w;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float kv[kE];
        widen(*reinterpret_cast<const uint4*>(k + (size_t)r * kstep + d0),
              kv);
#pragma unroll
        for (int i = 0; i < kE; ++i) dot[r] = fmaf(qv[i], kv[i], dot[r]);
      }
    }
  } else {
    for (int d = 0; d < D; ++d) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        dot[r] = fmaf(q[d], to_f32(k[(size_t)r * kstep + d]), dot[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) s[r] = __fmul_rn(dot[r], scale);
}

// The online-softmax step of one (row, head) over a tile's n <= 64 scores,
// held by the 32 lanes of a warp: s[0] is key `lane`, s[1] key lane+32.
// The tile max and the sum of exp(s - max) lane-strided, then butterflies;
// every lane returns the same corr and ends with the same m and l.  Turns
// the live s into probabilities.
__device__ __forceinline__ float softmax_step(float (&s)[2], int n, int lane,
                                              float& m, float& l) {
  static_assert(kTile == 64, "two keys per lane");
  float mx = m;
  if (lane < n) mx = fmaxf(mx, s[0]);
  if (lane + 32 < n) mx = fmaxf(mx, s[1]);
  mx = warp_max(mx);
  float sum = 0.f;
  if (lane < n) {
    s[0] = expf(s[0] - mx);
    sum += s[0];
  }
  if (lane + 32 < n) {
    s[1] = expf(s[1] - mx);
    sum += s[1];
  }
  sum = warp_sum(sum);
  const float corr = expf(m - mx);
  l = l * corr + sum;
  m = mx;
  return corr;
}

// acc = acc*corr + p.v over a tile's n keys, for the value columns a lane
// owns: with kVec the pairs (2j, 2j+1) for j = lane, lane+32, ...; else the
// columns lane, lane+32, ...  Each column is one fmaf chain over the keys
// in order; the probabilities are read four at a time.
template <bool kVec, typename T>
__device__ __forceinline__ void pv_step(const float* p, const T* v,
                                        int vstride, int n, int D, int lane,
                                        float corr, float* acc) {
  if constexpr (kVec) {
    for (int c = 2 * lane; c < D; c += 64) {
      float a0 = 0.f, a1 = 0.f;
      int j = 0;
      for (; j + 4 <= n; j += 4) {
        const float4 p4 = *reinterpret_cast<const float4*>(p + j);
        const float pj[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 vv = widen2(v + (size_t)(j + u) * vstride + c);
          a0 = fmaf(pj[u], vv.x, a0);
          a1 = fmaf(pj[u], vv.y, a1);
        }
      }
      for (; j < n; ++j) {
        const float2 vv = widen2(v + (size_t)j * vstride + c);
        a0 = fmaf(p[j], vv.x, a0);
        a1 = fmaf(p[j], vv.y, a1);
      }
      acc[c] = acc[c] * corr + a0;
      acc[c + 1] = acc[c + 1] * corr + a1;
    }
  } else {
    for (int c = lane; c < D; c += 32) {
      float a = 0.f;
      for (int j = 0; j < n; ++j)
        a = fmaf(p[j], to_f32(v[(size_t)j * vstride + c]), a);
      acc[c] = acc[c] * corr + a;
    }
  }
}

__device__ __forceinline__ float normalized(float acc, float l) {
  return acc / fmaxf(l, 1e-30f);
}

// ---------------------------------------------------------------------------
// Staging and pool writes
// ---------------------------------------------------------------------------

// Bytes of one staged K row and V row: D elements rounded up to 16 bytes;
// a K row is padded by 16 more where that makes its length an odd number
// of 16-byte units, so that the 8 lanes of a quarter-warp, which read the
// rows of 8 consecutive keys 16 bytes at a time, hit distinct banks.
__host__ __device__ inline int v_row_bytes(int D, int elem) {
  return (D * elem + 15) / 16 * 16;
}
__host__ __device__ inline int k_row_bytes(int D, int elem) {
  const int r = v_row_bytes(D, elem);
  return (r / 16) % 2 ? r : r + 16;
}

// Shared memory of a block (kernels/paged_attention.py computes the same
// in verify_smem_bytes): kStages ring stages of kTile K and V rows |
// p[kWarps*kTile] | q[per*D] | acc[per*D] | m,l[per], the last four f32.
inline size_t smem_bytes(int per, int D, int elem) {
  return (size_t)kStages * kTile *
             (k_row_bytes(D, elem) + v_row_bytes(D, elem)) +
         sizeof(float) * ((size_t)kWarps * kTile + 2 * per * D + 2 * per);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most kStages-1 of this thread's newest copy groups are
// still in flight
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
}

// Start copying tokens t0 .. t0+n-1 of kv-head h into one ring stage, as
// stored: tokens at or past `from` out of the new rows (lane-major (W, KV,
// D) at `fresh`), the rest from the lane's pages.  With kVec by cp.async,
// 16 bytes a thread; without, by plain loads and stores.
template <bool kVec, typename T>
__device__ void stage(const T* kpool, const T* vpool, const T* k_new,
                      const T* v_new, size_t fresh, const int* table, int t0,
                      int n, int from, int h, const Geometry& geo,
                      char* k_dst, char* v_dst, int kr, int vr) {
  const int D = geo.D;
  constexpr int kE = kVec ? 16 / sizeof(T) : 1;
  const int per_row = D / kE;
  for (int e = threadIdx.x; e < n * per_row; e += blockDim.x) {
    const int j = e / per_row, c = (e - j * per_row) * kE, t = t0 + j;
    const T *ks, *vs;
    if (t >= from) {
      const size_t at = fresh + ((size_t)(t - from) * geo.KV + h) * D + c;
      ks = k_new + at;
      vs = v_new + at;
    } else {
      const size_t at =
          (((size_t)table[t / geo.page] * geo.page + t % geo.page) * geo.KV +
           h) * D + c;
      ks = kpool + at;
      vs = vpool + at;
    }
    T* kd = reinterpret_cast<T*>(k_dst + (size_t)j * kr) + c;
    T* vd = reinterpret_cast<T*>(v_dst + (size_t)j * vr) + c;
    if constexpr (kVec) {
      cp_async16(kd, ks);
      cp_async16(vd, vs);
    } else {
      *kd = *ks;
      *vd = *vs;
    }
  }
}

// Write kv-head h's slice of one new K/V row (D elements at src) into token
// slot pos of the lane's table; a slot past the table is not written.
template <typename T>
__device__ void put_row(const T* k_new, const T* v_new, size_t src, T* kpool,
                        T* vpool, const int* table, int pos, int h,
                        const Geometry& geo) {
  const int slot = pos / geo.page;
  if (slot >= geo.n_max) return;
  const size_t row =
      ((size_t)table[slot] * geo.page + pos % geo.page) * geo.KV + h;
  for (int d = threadIdx.x; d < geo.D; d += blockDim.x) {
    kpool[row * geo.D + d] = k_new[src + d];
    vpool[row * geo.D + d] = v_new[src + d];
  }
}

// ---------------------------------------------------------------------------
// The body: a block per (lane, kv-head, task group, chunk)
// ---------------------------------------------------------------------------

// The launch bounds ask for one resident block per SM only, so that the
// compiler is free to take more than 64 registers a thread (ptxas takes
// 80-96; held to 64 it spilled).
template <typename T, bool kVec, bool kFused>
__global__ void __launch_bounds__(kThreads, 1)
    paged_kernel(Params<T> a, Geometry geo) {
  extern __shared__ __align__(16) char smem[];
  __shared__ int is_last;
  const int G = geo.H / geo.KV, D = geo.D, tasks = a.W * G;
  const int cap = geo.n_max * geo.page;  // never read past the table
  const int chunks = num_chunks(cap);
  const int b = blockIdx.x, h = blockIdx.y;
  const int grp = blockIdx.z / chunks, c = blockIdx.z - grp * chunks;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* table = a.tables + (size_t)b * geo.n_max;
  const int p0 = kFused ? a.lens[b] : a.lens[b] - 1;  // row 0's position
  const int width = a.widths ? max(0, min(a.widths[b], a.W)) : a.W;
  const size_t fresh = (size_t)b * a.W * geo.KV * D;  // lane b's new rows
  if (kFused && blockIdx.z == 0)  // the one writer of this (lane, kv-head)
    for (int s = 0; s < width; ++s)
      put_row<T>(a.k_new, a.v_new, fresh + ((size_t)s * geo.KV + h) * D,
                 a.kpool, a.vpool, table, p0 + s, h, geo);
  const int first = grp * a.per;                   // first task of the block
  const int count = min(a.per, tasks - first);
  const int last_row = min((first + count - 1) / G, width - 1);
  if (first / G > last_row) return;                // no live row here
  const int ctx_hi = min(p0 + last_row + 1, cap);  // the group's widest row
  const int live_chunks = max(1, num_chunks(ctx_hi));
  if (c >= live_chunks) return;                    // the chunk is past it
  const int t_lo = c * kChunk, t_hi = min(t_lo + kChunk, ctx_hi);
  const int n_tiles = max(0, (t_hi - t_lo + kTile - 1) / kTile);

  const int kr = k_row_bytes(D, sizeof(T)), vr = v_row_bytes(D, sizeof(T));
  const int stage_bytes = kTile * (kr + vr);
  float* p_s = reinterpret_cast<float*>(smem + kStages * stage_bytes);
  float* q_s = p_s + kWarps * kTile;
  float* acc_s = q_s + a.per * D;
  float* m_s = acc_s + a.per * D;
  float* l_s = m_s + a.per;
  p_s += warp * kTile;                             // this warp's probabilities

  // tile t goes to stage t % kStages, issued kStages tiles ahead of the
  // one scored; one copy group per tile, empty past the block's last tile
  const int from = kFused ? p0 : INT_MAX;
  auto issue = [&](int t) {
    if (t < n_tiles) {
      const int t0 = t_lo + t * kTile;
      char* dst = smem + (t % kStages) * stage_bytes;
      stage<kVec, T>(a.kpool, a.vpool, a.k_new, a.v_new, fresh, table, t0,
                     min(kTile, t_hi - t0), from, h, geo, dst,
                     dst + kTile * kr, kr, vr);
    }
    cp_async_commit();
  };
  for (int t = 0; t < kStages; ++t) issue(t);
  const T* qb = a.q + (size_t)b * a.W * geo.H * D + (size_t)h * G * D;
  for (int e = tid; e < count * D; e += blockDim.x) {
    const int i = e / D, d = e - i * D, gt = first + i;
    q_s[e] = to_f32(qb[((size_t)(gt / G) * geo.H + gt % G) * D + d]);
    acc_s[e] = 0.f;
  }
  for (int i = tid; i < count; i += blockDim.x) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }

  const int kstride = kr / (int)sizeof(T), vstride = vr / (int)sizeof(T);
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait();
    // tile t is in, q and the softmax state are set
    __syncthreads();
    const int t0 = t_lo + t * kTile;
    const char* tile = smem + (t % kStages) * stage_bytes;
    const T* k_t = reinterpret_cast<const T*>(tile);
    const T* v_t = reinterpret_cast<const T*>(tile + kTile * kr);
    for (int i = warp; i < count; i += kWarps) {
      const int s_row = (first + i) / G;
      const int n = min(kTile, min(p0 + s_row + 1, cap) - t0);
      if (s_row >= width || n <= 0) continue;  // dead row, or its ctx ended
      float s[2];
      score_pair<kVec>(q_s + i * D, k_t + (size_t)lane * kstride,
                       32 * kstride, D, geo.scale, s);
      float m = m_s[i], l = l_s[i];
      const float corr = softmax_step(s, n, lane, m, l);
      if (lane < n) p_s[lane] = s[0];
      if (lane + 32 < n) p_s[lane + 32] = s[1];
      __syncwarp();
      pv_step<kVec>(p_s, v_t, vstride, n, D, lane, corr, acc_s + i * D);
      if (lane == 0) {
        m_s[i] = m;
        l_s[i] = l;
      }
      __syncwarp();  // p_s, m_s and l_s are read again by this warp
    }
    if (t + kStages < n_tiles)
      __syncthreads();  // every warp is done with this tile's stage
    issue(t + kStages);
  }
  if (n_tiles == 0) __syncthreads();  // q, acc, m, l set by other threads

  // finish the rows that fit in one chunk; leave partials of the others
  const size_t rec = (size_t)D + 2;  // floats of one partial: m, l, acc
  const size_t bh = (size_t)b * geo.KV + h;
  auto out_row = [&](int gt) {  // task gt's output row
    return a.out + (((size_t)b * a.W + gt / G) * geo.H + (size_t)h * G +
                    gt % G) * D;
  };
  for (int i = warp; i < count; i += kWarps) {
    const int gt = first + i, s_row = gt / G;
    if (s_row >= width) continue;
    const int row_chunks = max(1, num_chunks(min(p0 + s_row + 1, cap)));
    if (c >= row_chunks) continue;
    const float* acc = acc_s + i * D;
    if (row_chunks == 1) {
      const float l = l_s[i];
      T* ob = out_row(gt);
      for (int d = lane; d < D; d += 32)
        ob[d] = from_f32<T>(normalized(acc[d], l));
    } else {
      float* pt = a.part + ((bh * tasks + gt) * chunks + c) * rec;
      if (lane == 0) {
        pt[0] = m_s[i];
        pt[1] = l_s[i];
      }
      for (int d = lane; d < D; d += 32) pt[2 + d] = acc[d];
    }
  }
  if (live_chunks == 1) return;  // no row of the group was split

  // the last block of the (lane, kv-head, task group) to finish merges
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* counter = a.tickets + bh * a.groups + grp;
    is_last = atomicAdd(counter, 1) == live_chunks - 1;
    if (is_last) atomicExch(counter, 0);
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int i = warp; i < count; i += kWarps) {
    const int gt = first + i, s_row = gt / G;
    if (s_row >= width) continue;
    const int row_chunks = num_chunks(min(p0 + s_row + 1, cap));
    if (row_chunks < 2) continue;
    const float* pt = a.part + (bh * tasks + gt) * chunks * rec;
    T* ob = out_row(gt);
    // an online merge in chunk order; each step's loads do not depend on
    // the step before, so they are in flight together
#pragma unroll 2
    for (int d = lane; d < D; d += 32) {
      float m = kNegInf, l = 0.f, acc = 0.f;
#pragma unroll 2
      for (int k = 0; k < row_chunks; ++k) {
        const float* pk = pt + k * rec;
        const float mk = __ldcg(pk), lk = __ldcg(pk + 1);
        const float ak = __ldcg(pk + 2 + d);
        const float mx = fmaxf(m, mk), corr = expf(m - mx);
        const float w = expf(mk - mx);
        l = fmaf(lk, w, l * corr);
        acc = fmaf(ak, w, acc * corr);
        m = mx;
      }
      ob[d] = from_f32<T>(normalized(acc, l));
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, bool kVec, bool kFused>
int launch(Params<T> a, int B, const Geometry& geo, cudaStream_t stream) {
  const int tasks = a.W * (geo.H / geo.KV);
  const size_t smem = smem_bytes(a.per, geo.D, sizeof(T));
  const int chunks = num_chunks(geo.n_max * geo.page);
  if (a.per < 1 || a.per > tasks || smem > kMaxSmem || chunks < 1)
    return (int)cudaErrorInvalidValue;
  a.groups = (tasks + a.per - 1) / a.per;
  if ((long long)a.groups * chunks > 65535 ||
      (chunks > 1 && (a.part == nullptr || a.tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(paged_kernel<T, kVec, kFused>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B, geo.KV, a.groups * chunks);
  paged_kernel<T, kVec, kFused><<<grid, kThreads, smem, stream>>>(a, geo);
  return (int)cudaGetLastError();
}

// 16-byte copies need 16-byte aligned tensors and rows of whole 16 bytes
bool vec_ok(const void* x, const void* y, int D, int elem_bytes) {
  return (D * elem_bytes) % 16 == 0 && (uintptr_t)x % 16 == 0 &&
         (uintptr_t)y % 16 == 0;
}

template <typename T, bool kFused>
int dispatch(const void* q, const void* k_new, const void* v_new, void* kp,
             void* vp, const void* tables, const void* lens,
             const void* widths, void* out, void* part, void* tickets, int B,
             int W, const Geometry& geo, int per, void* stream) {
  const Params<T> a{(const T*)q,      (const T*)k_new, (const T*)v_new,
                    (T*)kp,           (T*)vp,          (const int*)tables,
                    (const int*)lens, (const int*)widths, (T*)out,
                    (float*)part,     (int*)tickets,   W,
                    per,              0};
  const int e = sizeof(T);
  const bool vec = vec_ok(kp, vp, geo.D, e) &&
                   (!kFused || vec_ok(k_new, v_new, geo.D, e));
  const cudaStream_t st = (cudaStream_t)stream;
  return vec ? launch<T, true, kFused>(a, B, geo, st)
             : launch<T, false, kFused>(a, B, geo, st);
}

}  // namespace

// bf16 != 0 selects __nv_bfloat16 storage, else float.  `per` is the number
// of (row, head) tasks per block, `part` the f32 partials and `tickets` the
// zeroed counters of kernels/paged_attention.py's blocking (both may be
// null where the table's capacity fits in one chunk).
extern "C" int paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* ctx_lens, void* out, int B, int H,
    int KV, int D, int page, int n_max, int bf16, float scale, int per,
    void* part, void* tickets, void* stream) {
  const Geometry geo{H, KV, D, page, n_max, scale};
  auto run =
      bf16 ? &dispatch<__nv_bfloat16, false> : &dispatch<float, false>;
  return run(q, nullptr, nullptr, const_cast<void*>(k_pages),
             const_cast<void*>(v_pages), block_tables, ctx_lens, nullptr, out,
             part, tickets, B, 1, geo, per, stream);
}

extern "C" int fused_decode_attention_launch(
    const void* q, const void* k_new, const void* v_new, void* k_pages,
    void* v_pages, const void* block_tables, const void* positions, void* out,
    int B, int H, int KV, int D, int page, int n_max, int bf16, float scale,
    int per, void* part, void* tickets, void* stream) {
  const Geometry geo{H, KV, D, page, n_max, scale};
  auto run =
      bf16 ? &dispatch<__nv_bfloat16, true> : &dispatch<float, true>;
  return run(q, k_new, v_new, k_pages, v_pages, block_tables, positions,
             nullptr, out, part, tickets, B, 1, geo, per, stream);
}

extern "C" int fused_verify_attention_launch(
    const void* q, const void* k_new, const void* v_new, void* k_pages,
    void* v_pages, const void* block_tables, const void* pos0,
    const void* widths, void* out, int B, int W, int H, int KV, int D,
    int page, int n_max, int bf16, float scale, int per, void* part,
    void* tickets, void* stream) {
  const Geometry geo{H, KV, D, page, n_max, scale};
  auto run =
      bf16 ? &dispatch<__nv_bfloat16, true> : &dispatch<float, true>;
  return run(q, k_new, v_new, k_pages, v_pages, block_tables, pos0, widths,
             out, part, tickets, B, W, geo, per, stream);
}

// Dynamic shared memory of a block of `per` tasks (the wrapper's
// verify_smem_bytes must agree).
extern "C" int fused_verify_smem_bytes(int per, int D, int bf16) {
  return (int)smem_bytes(per, D, bf16 ? 2 : 4);
}

// Tokens a block covers (the wrapper's CHUNK must agree).
extern "C" int paged_chunk_tokens() { return kChunk; }
