// Paged decode attention for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU (Pallas) kernels of src/repro/kernels/paged_attention.py:
//   paged_attention_launch         <- paged_attention        (body _kernel)
//   fused_decode_attention_launch  <- fused_decode_attention (body _fused_kernel)
//   fused_verify_attention_launch  <- fused_verify_attention (its chained
//                                     lowering _verify_unrolled; the one-pass
//                                     _verify_multirow / _verify_kernel)
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
// (B,H,D).  Query head h*G+g belongs to kv-head h.  One block per (lane b,
// kv-head h); the online-softmax state (m, l, acc) of its G heads lives in
// f32 shared memory and the output is acc / max(l, 1e-30).
//
// All entry points run the same __device__ routine `attend`, so for equal
// pools their outputs are bitwise equal.  The fused entry point first writes
// its kv-head's slice of the lane's new K/V row into the one target slot,
// then synchronises the block and attends; it writes nothing else.  Retired
// and padded lanes carry all-scrap tables, so several blocks may write the
// scrap page at once; no live table names that page, so the race is benign.
//
// The verify entry point (speculative decoding) takes W window rows per
// lane: q (B,W,H,D), new K/V (B,W,KV,D), pos0 and widths (B,).  Its block
// writes its kv-head's slice of every live row s < widths[b] into slot
// pos0+s, synchronises, then runs `attend` once per live row on query row
// (b, s) with ctx = pos0+s+1.  Each live row is thus bitwise the fused
// decode step at that position, which is what keeps speculative token
// streams equal to plain decoding.  Rows at or past the width write nothing,
// not even their output rows, which are unspecified.  What bounds it: its
// bytes, at W=5, ctx 512 1.37 us at 3.35 TB/s, against 1.33 us of
// operations (the f32 p.v products at 67 TFLOP/s; the bf16 q.k products
// are exact in f32 and count at the tensor cores' 989 TFLOP/s).  This
// first design re-reads the lane's pages once per row (W passes over
// them); one page pass for all W rows that keeps each row's reduction
// order is later work.
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
// first ctx tokens named by `table`; q and out are (rows, H, D).  The decode
// kernels pass the lane as the row, the verify kernel lane*W + s.  The pools
// are read with plain loads (no read-only cache path): in the fused kernels
// this block has just written some of their rows.  Ends without a barrier:
// a caller that runs it again must synchronise the block first.
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
    // scores s[g][j] = (q_g . k_j) * scale, f32, one thread per (g, j)
    for (int e = tid; e < G * n; e += blockDim.x) {
      const int g = e / n, j = e - g * n;
      const float* qg = q_s + g * D;
      const float* kj = k_s + j * Dk;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot = fmaf(qg[d], kj[d], dot);
      s_s[g * kTile + j] = dot * geo.scale;
    }
    __syncthreads();
    // online-softmax update, one warp per query head
    for (int g = warp; g < G; g += kWarps) {
      float* sg = s_s + g * kTile;
      const float m_old = m_s[g];
      float mx = m_old;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, sg[j]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float p = expf(sg[j] - mx);
        sg[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - mx);
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = mx;
        c_s[g] = corr;
      }
    }
    __syncthreads();
    // acc = acc * corr + p @ v, one thread per (g, d)
    for (int e = tid; e < G * D; e += blockDim.x) {
      const int g = e / D, d = e - g * D;
      const float* pg = s_s + g * kTile;
      float pv = 0.f;
      for (int j = 0; j < n; ++j) pv = fmaf(pg[j], v_s[j * D + d], pv);
      acc[e] = acc[e] * c_s[g] + pv;
    }
    __syncthreads();
  }

  T* ob = out + ((size_t)row * geo.H + (size_t)h * G) * D;
  for (int e = tid; e < G * D; e += blockDim.x)
    ob[e] = from_f32<T>(acc[e] / fmaxf(l_s[e / D], 1e-30f));
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

// The register cap (6 blocks of kThreads per SM: at most 40 registers, as
// the decode kernels take) is for speed alone: left free, the compiler
// gives the W-row loop 48 registers and the kernel runs about 15% slower on
// the H100 (PERF.md, PR 12).
template <typename T>
__global__ void __launch_bounds__(kThreads, 6)
    fused_verify_kernel(const T* q, const T* k_new, const T* v_new, T* kpool,
                        T* vpool, const int* tables, const int* pos0,
                        const int* widths, T* out, int W, Geometry geo) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  const int* table = tables + (size_t)b * geo.n_max;
  const int p0 = pos0[b];
  const int width = max(0, min(widths[b], W));
  for (int s = 0; s < width; ++s)
    put_row<T>(k_new, v_new, (((size_t)b * W + s) * geo.KV + h) * geo.D,
               kpool, vpool, table, p0 + s, h, geo);
  __syncthreads();
  for (int s = 0; s < width; ++s) {
    if (s > 0) __syncthreads();  // the previous row's reads of smem
    attend<T>(q, kpool, vpool, table, p0 + s + 1, out, b * W + s, h, geo,
              smem);
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

template <typename T>
int launch_verify(const void* q, const void* k_new, const void* v_new,
                  void* kp, void* vp, const void* tables, const void* pos0,
                  const void* widths, void* out, int B, int W,
                  const Geometry& geo, cudaStream_t stream) {
  const size_t smem = smem_bytes(geo.H / geo.KV, geo.D);
  cudaError_t err = allow_smem(fused_verify_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  fused_verify_kernel<T><<<dim3(B, geo.KV), kThreads, smem, stream>>>(
      (const T*)q, (const T*)k_new, (const T*)v_new, (T*)kp, (T*)vp,
      (const int*)tables, (const int*)pos0, (const int*)widths, (T*)out, W,
      geo);
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
    int page, int n_max, int bf16, float scale, void* stream) {
  const Geometry geo{H, KV, D, page, n_max, scale,
                     vec_ok(k_pages, v_pages, D, bf16 ? 2 : 4)};
  if (bf16)
    return launch_verify<__nv_bfloat16>(q, k_new, v_new, k_pages, v_pages,
                                        block_tables, pos0, widths, out, B, W,
                                        geo, (cudaStream_t)stream);
  return launch_verify<float>(q, k_new, v_new, k_pages, v_pages, block_tables,
                              pos0, widths, out, B, W, geo,
                              (cudaStream_t)stream);
}
