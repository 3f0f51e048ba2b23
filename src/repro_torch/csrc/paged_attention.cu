// Paged decode attention for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU (Pallas) kernels of src/repro/kernels/paged_attention.py:
//   paged_attention_launch         <- paged_attention        (body _kernel)
//   fused_decode_attention_launch  <- fused_decode_attention (body _fused_kernel)
//   fused_verify_attention_launch  <- fused_verify_attention (what its
//                                     one-pass _verify_multirow /
//                                     _verify_kernel intend; its chained
//                                     _verify_unrolled is the parity target)
//
// What bounds it: decode attention is bound by memory on this card.  Each
// lane reads ctx*KV*D*2 elements of K and V for about 4*ctx*H*D flops, near
// one flop per byte in bf16, far below the roughly 295 flops per byte at
// which the H100's arithmetic rather than its memory becomes the limit.
// What the design does about it: a block walks only the live pages of its
// lane, up to the context length (the Pallas grid visits all n_max pages
// and masks the dead ones), and it stages each K/V row once in shared memory
// for all G = H/KV query heads of its group, so every K/V element is read
// from device memory once.
//
// Layout, as in the reference: q (B,H,D); k/v pools (P,page,KV,D); block
// tables (B,n_max) int32; context lengths / positions (B,) int32; out
// (B,H,D).  Query head h*G+g belongs to kv-head h.  The decode kernels run
// one block per (lane b, kv-head h); the online-softmax state (m, l, acc)
// of its G heads lives in f32 shared memory and the output is
// acc / max(l, 1e-30).
//
// Both decode entry points run the same __device__ routine `attend`, so
// for equal pools their outputs are bitwise equal.  The fused entry point
// first writes its kv-head's slice of the lane's new K/V row into the one
// target slot, then synchronises the block and attends; it writes nothing
// else.  Retired
// and padded lanes carry all-scrap tables, so several blocks may write the
// scrap page at once; no live table names that page, so the race is benign.
//
// The verify entry point (speculative decoding) takes W window rows per
// lane: q (B,W,H,D), new K/V (B,W,KV,D), pos0 and widths (B,).  Row s of
// lane b is the fused decode step at position pos0+s: it attends ctx =
// pos0+s+1 tokens.  Its unit of work is a task, one query head g of one
// window row s (task s*G+g); a block takes `per` consecutive tasks of one
// (lane, kv-head), one warp per task (a warp runs its tasks in turn), and
// the grid is (B, KV, ceil(W*G/per)).  The host picks `per`
// (kernels/paged_attention.py, verify_blocking): enough tasks for the
// block's 8 warps, fewer where shared memory runs out, so at G = 8 each
// row of a lane runs in a block of its own and a B=8, W=5 call has 160
// blocks.  The block walks the 64-token tiles of its lane once, up to its
// last live row's context: each tile is copied into a two-stage ring in
// shared memory (cp.async, 16 bytes a thread, tile t+1 in flight while
// tile t is scored, one barrier a tile), as stored (bf16 or f32), and
// every live task whose context reaches the tile scores it with its own n
// = min(64, ctx - t0).  Tokens of the window itself (pos0 ..
// pos0+width-1) are staged from k_new / v_new, the same bits the pool will
// hold, so no block reads a slot that is being written; block 0 of each
// (lane, kv-head) alone writes the live rows into the pool.  Rows at or
// past the width write nothing, not even their output rows, which are
// unspecified.
//
// Bitwise contract: each live row equals the fused decode kernel at that
// position, which keeps speculative token streams equal to plain
// decoding.  Both bodies run the per-tile steps through the same inlined
// helpers (score_chains, softmax_step, pv_chains, rescale, normalized):
// the score as one fmaf chain over d and then the scale, the tile max and
// sum lane-strided and then butterflies, l = l*corr + sum, p.v as one fmaf
// chain over the tile's keys, acc = acc*corr + pv, acc / max(l, 1e-30).
// The verify body only spreads these chains over more threads (a lane
// scores keys lane and lane+32, and owns value columns lane, lane+32, ..)
// and reads bf16 K/V and converts on read, which is exact.  The tensor
// cores would sum q.k and p.v in another order, so they wait for the
// redesign of the decode kernels, which will change the shared helpers
// once and carry this kernel along.
//
// What bounds it: its bytes are 1.37 us at W=5, ctx 512 (3.35 TB/s), its
// operations about as much.  What holds it back is instruction issue: a
// warp spends about 1000 instructions on one (row, head) and tile (the
// f32 FMAs of q.k and p.v, the bf16 conversions and shared-memory loads
// around them), and each tile adds about 4 us at B=8, W=5 (PERF.md).  The
// split over blocks and warps runs the W*G chains of a (lane, kv-head) at
// once instead of one block's W passes in turn; each tile's copy overlaps
// the previous tile's arithmetic (a deeper ring measured the same).
//
// Each C entry point returns cudaGetLastError() as an int (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;          // tokens staged in shared memory per step
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory of a block
constexpr int kStages = 2;           // the verify kernel's copy ring

struct Geometry {
  int H, KV, D, page, n_max;
  float scale;
  int vec;  // 1: pools 16-byte aligned and D*sizeof(T) a multiple of 16
};

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
// The per-tile steps of one (query row, head), shared by every body so that
// their arithmetic, and so their bits, are one source.
// ---------------------------------------------------------------------------

// Scores of query q (D f32) against NR key rows k, k + kstep, ...: each one
// fmaf chain over d = 0..D-1, then the scale (an unfused multiply, so that
// no caller's compiler folds it into the next subtraction).  With kVec the
// key rows (type T) are 16-byte aligned and read 16 bytes at a time, and q
// is read as float4; the chain is the same.
template <int NR, bool kVec, typename T>
__device__ __forceinline__ void score_chains(const float* q, const T* k,
                                             int kstep, int D, float scale,
                                             float (&s)[NR]) {
  float dot[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) dot[r] = 0.f;
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
      for (int r = 0; r < NR; ++r) {
        const uint4 raw =
            *reinterpret_cast<const uint4*>(k + (size_t)r * kstep + d0);
        const T* kk = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int i = 0; i < kE; ++i)
          dot[r] = fmaf(qv[i], to_f32(kk[i]), dot[r]);
      }
    }
  } else {
    for (int d = 0; d < D; ++d) {
#pragma unroll
      for (int r = 0; r < NR; ++r)
        dot[r] = fmaf(q[d], to_f32(k[(size_t)r * kstep + d]), dot[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < NR; ++r) s[r] = __fmul_rn(dot[r], scale);
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

// p . v over a tile's n keys for NC value columns v, v + cstep, ... (rows
// vstride elements apart): each one fmaf chain over the keys in order.
template <int NC, typename T>
__device__ __forceinline__ void pv_chains(const float* p, const T* v,
                                          int vstride, int cstep, int n,
                                          float (&pv)[NC]) {
#pragma unroll
  for (int c = 0; c < NC; ++c) pv[c] = 0.f;
  for (int j = 0; j < n; ++j) {
    const float pj = p[j];
#pragma unroll
    for (int c = 0; c < NC; ++c)
      pv[c] = fmaf(pj, to_f32(v[(size_t)j * vstride + c * cstep]), pv[c]);
  }
}

__device__ __forceinline__ float rescale(float acc, float corr, float pv) {
  return acc * corr + pv;
}

__device__ __forceinline__ float normalized(float acc, float l) {
  return acc / fmaxf(l, 1e-30f);
}

// ---------------------------------------------------------------------------
// The decode kernels: one block per (lane, kv-head)
// ---------------------------------------------------------------------------

// Shared memory of a block, in floats:
//   q[G*D] | acc[G*D] | k[kTile*(D+1)] | v[kTile*D] | s[G*kTile] | m,l,corr[G]
// K rows are padded to D+1 floats so that the threads of a warp, which
// score one head against consecutive tokens, read distinct banks.
inline size_t smem_bytes(int G, int D) {
  return sizeof(float) * (size_t)(2 * G * D + kTile * (D + 1) + kTile * D +
                                  G * kTile + 3 * G);
}

// Copy tokens t0 .. t0+n-1 of kv-head h (rows of D contiguous elements,
// scattered over the lane's pages) into k_s / v_s as f32, 16 bytes per
// load where the layout allows it.
template <typename T>
__device__ void stage(const T* kpool, const T* vpool, const int* table, int t0,
                      int n, int h, const Geometry& geo, float* k_s,
                      float* v_s) {
  constexpr int kVec = 16 / sizeof(T);
  const int D = geo.D, Dk = D + 1;
  const int w = geo.vec ? kVec : 1;  // elements per load
  const int per_row = D / w;
  for (int e = threadIdx.x; e < n * per_row; e += blockDim.x) {
    const int j = e / per_row, c = (e - j * per_row) * w, t = t0 + j;
    const size_t at =
        (((size_t)table[t / geo.page] * geo.page + t % geo.page) * geo.KV +
         h) * D + c;
    if (geo.vec) {
      const uint4 kr = *reinterpret_cast<const uint4*>(kpool + at);
      const uint4 vr = *reinterpret_cast<const uint4*>(vpool + at);
      const T* kk = reinterpret_cast<const T*>(&kr);
      const T* vv = reinterpret_cast<const T*>(&vr);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        k_s[j * Dk + c + i] = to_f32(kk[i]);
        v_s[j * D + c + i] = to_f32(vv[i]);
      }
    } else {
      k_s[j * Dk + c] = to_f32(kpool[at]);
      v_s[j * D + c] = to_f32(vpool[at]);
    }
  }
}

// GQA attention of query row `row` (its heads h*G .. h*G+G-1) over the
// first ctx tokens named by `table`; q and out are (rows, H, D).  The pools
// are read with plain loads (no read-only cache path): in the fused kernel
// this block has just written one of their rows.
template <typename T>
__device__ void attend(const T* q, const T* kpool, const T* vpool,
                       const int* table, int ctx, T* out, int row, int h,
                       const Geometry& geo, float* smem) {
  const int G = geo.H / geo.KV, D = geo.D, Dk = D + 1, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  float* q_s = smem;
  float* acc = q_s + G * D;
  float* k_s = acc + G * D;
  float* v_s = k_s + kTile * Dk;
  float* s_s = v_s + kTile * D;
  float* m_s = s_s + G * kTile;
  float* l_s = m_s + G;
  float* c_s = l_s + G;

  const T* qb = q + ((size_t)row * geo.H + (size_t)h * G) * D;
  for (int e = tid; e < G * D; e += blockDim.x) {
    q_s[e] = to_f32(qb[e]);
    acc[e] = 0.f;
  }
  for (int g = tid; g < G; g += blockDim.x) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  ctx = min(ctx, geo.n_max * geo.page);  // never read past the table
  __syncthreads();

  for (int t0 = 0; t0 < ctx; t0 += kTile) {
    const int n = min(kTile, ctx - t0);
    stage<T>(kpool, vpool, table, t0, n, h, geo, k_s, v_s);
    __syncthreads();
    // scores s[g][j], one thread per (g, j)
    for (int e = tid; e < G * n; e += blockDim.x) {
      const int g = e / n, j = e - g * n;
      float s[1];
      score_chains<1, false>(q_s + g * D, k_s + j * Dk, 0, D, geo.scale, s);
      s_s[g * kTile + j] = s[0];
    }
    __syncthreads();
    // online-softmax update, one warp per query head
    for (int g = warp; g < G; g += kWarps) {
      float* sg = s_s + g * kTile;
      float s[2] = {lane < n ? sg[lane] : 0.f,
                    lane + 32 < n ? sg[lane + 32] : 0.f};
      float m = m_s[g], l = l_s[g];
      const float corr = softmax_step(s, n, lane, m, l);
      if (lane < n) sg[lane] = s[0];
      if (lane + 32 < n) sg[lane + 32] = s[1];
      if (lane == 0) {
        l_s[g] = l;
        m_s[g] = m;
        c_s[g] = corr;
      }
    }
    __syncthreads();
    // acc = acc * corr + p @ v, one thread per (g, d)
    for (int e = tid; e < G * D; e += blockDim.x) {
      const int g = e / D, d = e - g * D;
      float pv[1];
      pv_chains<1>(s_s + g * kTile, v_s + d, D, 0, n, pv);
      acc[e] = rescale(acc[e], c_s[g], pv[0]);
    }
    __syncthreads();
  }

  T* ob = out + ((size_t)row * geo.H + (size_t)h * G) * D;
  for (int e = tid; e < G * D; e += blockDim.x)
    ob[e] = from_f32<T>(normalized(acc[e], l_s[e / D]));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(const T* q, const T* kpool, const T* vpool,
                           const int* tables, const int* ctx_lens, T* out,
                           Geometry geo) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  attend<T>(q, kpool, vpool, tables + (size_t)b * geo.n_max, ctx_lens[b], out,
            b, h, geo, smem);
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_decode_kernel(const T* q, const T* k_new, const T* v_new, T* kpool,
                        T* vpool, const int* tables, const int* positions,
                        T* out, Geometry geo) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  const int* table = tables + (size_t)b * geo.n_max;
  const int pos = positions[b];
  put_row<T>(k_new, v_new, ((size_t)b * geo.KV + h) * geo.D, kpool, vpool,
             table, pos, h, geo);
  // the block's global writes are visible to all its threads after this
  __syncthreads();
  attend<T>(q, kpool, vpool, table, pos + 1, out, b, h, geo, smem);
}

// ---------------------------------------------------------------------------
// The verify kernel: a block per (lane, kv-head, group of `per` tasks)
// ---------------------------------------------------------------------------

// Bytes of one staged K row and V row: D elements rounded up to 16 bytes;
// a K row is padded by 16 more where that makes its length an odd number
// of 16-byte units, so that the 8 lanes of a quarter-warp, which read the
// rows of 8 consecutive keys 16 bytes at a time, hit distinct banks.
__host__ __device__ inline int verify_v_row(int D, int elem) {
  return (D * elem + 15) / 16 * 16;
}
__host__ __device__ inline int verify_k_row(int D, int elem) {
  const int r = verify_v_row(D, elem);
  return (r / 16) % 2 ? r : r + 16;
}

// Shared memory of a verify block (kernels/paged_attention.py computes the
// same in verify_smem_bytes): kStages ring stages of kTile K and V rows |
// q[per*D] | acc[per*D] | m,l[per] | p[kWarps*kTile], the last four f32.
inline size_t verify_smem_bytes(int per, int D, int elem) {
  return (size_t)kStages * kTile *
             (verify_k_row(D, elem) + verify_v_row(D, elem)) +
         sizeof(float) * ((size_t)2 * per * D + 2 * per + kWarps * kTile);
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
// wait until at most kStages-2 of this thread's newest copy groups are
// still in flight
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
}

// Start copying tokens t0 .. t0+n-1 of kv-head h into one ring stage, as
// stored: window tokens (t >= p0) from the new rows (lane-major (W, KV, D)
// at `fresh`), the rest from the lane's pages.  With kVec by cp.async, 16
// bytes a thread; without, by plain loads and stores.
template <bool kVec, typename T>
__device__ void stage_async(const T* kpool, const T* vpool, const T* k_new,
                            const T* v_new, size_t fresh, const int* table,
                            int t0, int n, int p0, int h, const Geometry& geo,
                            char* k_dst, char* v_dst, int kr, int vr) {
  const int D = geo.D;
  constexpr int kE = kVec ? 16 / sizeof(T) : 1;
  const int per_row = D / kE;
  for (int e = threadIdx.x; e < n * per_row; e += blockDim.x) {
    const int j = e / per_row, c = (e - j * per_row) * kE, t = t0 + j;
    const T *ks, *vs;
    if (t >= p0) {
      const size_t at = fresh + ((size_t)(t - p0) * geo.KV + h) * D + c;
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

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    fused_verify_kernel(const T* q, const T* k_new, const T* v_new, T* kpool,
                        T* vpool, const int* tables, const int* pos0,
                        const int* widths, T* out, int W, int per,
                        Geometry geo) {
  extern __shared__ __align__(16) char vsmem[];
  const int b = blockIdx.x, h = blockIdx.y, z = blockIdx.z;
  const int G = geo.H / geo.KV, D = geo.D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* table = tables + (size_t)b * geo.n_max;
  const int p0 = pos0[b];
  const int width = max(0, min(widths[b], W));
  const size_t fresh = (size_t)b * W * geo.KV * D;  // lane b's new rows
  if (z == 0)  // the one writer of this (lane, kv-head)'s live rows
    for (int s = 0; s < width; ++s)
      put_row<T>(k_new, v_new, fresh + ((size_t)s * geo.KV + h) * D, kpool,
                 vpool, table, p0 + s, h, geo);
  const int first = z * per;                       // first task of the block
  const int count = min(per, W * G - first);
  const int last_row = min((first + count - 1) / G, width - 1);
  if (first / G > last_row) return;                // no live row here
  const int cap = geo.n_max * geo.page;            // never read past the table
  const int ctx_max = min(p0 + last_row + 1, cap);

  const int kr = verify_k_row(D, sizeof(T)), vr = verify_v_row(D, sizeof(T));
  const int stage_bytes = kTile * (kr + vr);
  float* q_s = reinterpret_cast<float*>(vsmem + kStages * stage_bytes);
  float* acc_s = q_s + per * D;
  float* m_s = acc_s + per * D;
  float* l_s = m_s + per;
  float* p_s = l_s + per + warp * kTile;           // this warp's probabilities

  // tile t goes to stage t % kStages, kStages-1 tiles ahead of the one
  // scored; one copy group per tile, empty past the last tile
  auto issue = [&](int t) {
    const int t0 = t * kTile;
    if (t0 < ctx_max) {
      char* dst = vsmem + (t % kStages) * stage_bytes;
      stage_async<kVec, T>(kpool, vpool, k_new, v_new, fresh, table, t0,
                           min(kTile, ctx_max - t0), p0, h, geo, dst,
                           dst + kTile * kr, kr, vr);
    }
    cp_async_commit();
  };
  for (int t = 0; t < kStages - 1; ++t) issue(t);
  const T* qb = q + (size_t)b * W * geo.H * D + (size_t)h * G * D;
  for (int e = tid; e < count * D; e += blockDim.x) {
    const int i = e / D, d = e - i * D, gt = first + i;
    q_s[e] = to_f32(qb[((size_t)(gt / G) * geo.H + gt % G) * D + d]);
    acc_s[e] = 0.f;
  }
  for (int i = tid; i < count; i += blockDim.x) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }

  for (int t = 0, t0 = 0; t0 < ctx_max; ++t, t0 += kTile) {
    cp_async_wait();
    // tile t is in; every warp is done with tile t-1's stage
    __syncthreads();
    issue(t + kStages - 1);
    const char* tile = vsmem + (t % kStages) * stage_bytes;
    const T* k_t = reinterpret_cast<const T*>(tile);
    const T* v_t = reinterpret_cast<const T*>(tile + kTile * kr);
    const int kstride = kr / (int)sizeof(T), vstride = vr / (int)sizeof(T);
    for (int i = warp; i < count; i += kWarps) {
      const int s_row = (first + i) / G;
      const int n = min(kTile, min(p0 + s_row + 1, cap) - t0);
      if (s_row >= width || n <= 0) continue;  // dead row, or its ctx ended
      float s[2];
      score_chains<2, kVec>(q_s + i * D, k_t + (size_t)lane * kstride,
                            32 * kstride, D, geo.scale, s);
      float m = m_s[i], l = l_s[i];
      const float corr = softmax_step(s, n, lane, m, l);
      if (lane < n) p_s[lane] = s[0];
      if (lane + 32 < n) p_s[lane + 32] = s[1];
      __syncwarp();
      float* acc = acc_s + i * D;
      int d = lane;
      for (; d + 32 < D; d += 64) {
        float pv[2];
        pv_chains<2>(p_s, v_t + d, vstride, 32, n, pv);
        acc[d] = rescale(acc[d], corr, pv[0]);
        acc[d + 32] = rescale(acc[d + 32], corr, pv[1]);
      }
      if (d < D) {
        float pv[1];
        pv_chains<1>(p_s, v_t + d, vstride, 0, n, pv);
        acc[d] = rescale(acc[d], corr, pv[0]);
      }
      if (lane == 0) {
        m_s[i] = m;
        l_s[i] = l;
      }
      __syncwarp();  // p_s, m_s and l_s are read again by this warp
    }
  }

  for (int i = warp; i < count; i += kWarps) {
    const int gt = first + i, s_row = gt / G;
    if (s_row >= width) continue;
    const float l = l_s[i];
    T* ob = out + (((size_t)b * W + s_row) * geo.H + (size_t)h * G + gt % G) *
                      D;
    for (int d = lane; d < D; d += 32)
      ob[d] = from_f32<T>(normalized(acc_s[i * D + d], l));
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T>
int launch_paged(const void* q, const void* kp, const void* vp,
                 const void* tables, const void* ctx, void* out, int B,
                 const Geometry& geo, cudaStream_t stream) {
  const size_t smem = smem_bytes(geo.H / geo.KV, geo.D);
  cudaError_t err = allow_smem(paged_attention_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  paged_attention_kernel<T><<<dim3(B, geo.KV), kThreads, smem, stream>>>(
      (const T*)q, (const T*)kp, (const T*)vp, (const int*)tables,
      (const int*)ctx, (T*)out, geo);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fused(const void* q, const void* k_new, const void* v_new,
                 void* kp, void* vp, const void* tables, const void* pos,
                 void* out, int B, const Geometry& geo, cudaStream_t stream) {
  const size_t smem = smem_bytes(geo.H / geo.KV, geo.D);
  cudaError_t err = allow_smem(fused_decode_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  fused_decode_kernel<T><<<dim3(B, geo.KV), kThreads, smem, stream>>>(
      (const T*)q, (const T*)k_new, (const T*)v_new, (T*)kp, (T*)vp,
      (const int*)tables, (const int*)pos, (T*)out, geo);
  return (int)cudaGetLastError();
}

template <typename T, bool kVec>
int launch_verify(const void* q, const void* k_new, const void* v_new,
                  void* kp, void* vp, const void* tables, const void* pos0,
                  const void* widths, void* out, int B, int W, int per,
                  const Geometry& geo, cudaStream_t stream) {
  const int tasks = W * (geo.H / geo.KV);
  const size_t smem = verify_smem_bytes(per, geo.D, sizeof(T));
  if (per < 1 || per > tasks || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(fused_verify_kernel<T, kVec>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B, geo.KV, (tasks + per - 1) / per);
  fused_verify_kernel<T, kVec><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k_new, (const T*)v_new, (T*)kp, (T*)vp,
      (const int*)tables, (const int*)pos0, (const int*)widths, (T*)out, W,
      per, geo);
  return (int)cudaGetLastError();
}

// 16-byte loads need 16-byte aligned pools and rows of whole 16 bytes
int vec_ok(const void* k_pages, const void* v_pages, int D, int elem_bytes) {
  return (D * elem_bytes) % 16 == 0 && (uintptr_t)k_pages % 16 == 0 &&
         (uintptr_t)v_pages % 16 == 0;
}

}  // namespace

// bf16 != 0 selects __nv_bfloat16 storage, else float.
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const void* block_tables,
                                      const void* ctx_lens, void* out, int B,
                                      int H, int KV, int D, int page,
                                      int n_max, int bf16, float scale,
                                      void* stream) {
  const Geometry geo{H, KV, D, page, n_max, scale,
                     vec_ok(k_pages, v_pages, D, bf16 ? 2 : 4)};
  if (bf16)
    return launch_paged<__nv_bfloat16>(q, k_pages, v_pages, block_tables,
                                       ctx_lens, out, B, geo,
                                       (cudaStream_t)stream);
  return launch_paged<float>(q, k_pages, v_pages, block_tables, ctx_lens, out,
                             B, geo, (cudaStream_t)stream);
}

extern "C" int fused_decode_attention_launch(
    const void* q, const void* k_new, const void* v_new, void* k_pages,
    void* v_pages, const void* block_tables, const void* positions, void* out,
    int B, int H, int KV, int D, int page, int n_max, int bf16, float scale,
    void* stream) {
  const Geometry geo{H, KV, D, page, n_max, scale,
                     vec_ok(k_pages, v_pages, D, bf16 ? 2 : 4)};
  if (bf16)
    return launch_fused<__nv_bfloat16>(q, k_new, v_new, k_pages, v_pages,
                                       block_tables, positions, out, B, geo,
                                       (cudaStream_t)stream);
  return launch_fused<float>(q, k_new, v_new, k_pages, v_pages, block_tables,
                             positions, out, B, geo, (cudaStream_t)stream);
}

extern "C" int fused_verify_attention_launch(
    const void* q, const void* k_new, const void* v_new, void* k_pages,
    void* v_pages, const void* block_tables, const void* pos0,
    const void* widths, void* out, int B, int W, int H, int KV, int D,
    int page, int n_max, int bf16, float scale, int per, void* stream) {
  const int elem = bf16 ? 2 : 4;
  const Geometry geo{H, KV, D, page, n_max, scale,
                     vec_ok(k_pages, v_pages, D, elem) &&
                         vec_ok(k_new, v_new, D, elem)};
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return geo.vec ? launch_verify<__nv_bfloat16, true>(
                         q, k_new, v_new, k_pages, v_pages, block_tables,
                         pos0, widths, out, B, W, per, geo, st)
                   : launch_verify<__nv_bfloat16, false>(
                         q, k_new, v_new, k_pages, v_pages, block_tables,
                         pos0, widths, out, B, W, per, geo, st);
  return geo.vec ? launch_verify<float, true>(q, k_new, v_new, k_pages,
                                              v_pages, block_tables, pos0,
                                              widths, out, B, W, per, geo,
                                              st)
                 : launch_verify<float, false>(q, k_new, v_new, k_pages,
                                               v_pages, block_tables, pos0,
                                               widths, out, B, W, per, geo,
                                               st);
}

// Dynamic shared memory of a verify block of `per` tasks (the wrapper's
// verify_smem_bytes must agree).
extern "C" int fused_verify_smem_bytes(int per, int D, int bf16) {
  return (int)verify_smem_bytes(per, D, bf16 ? 2 : 4);
}
