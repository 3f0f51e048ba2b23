// Causal (or full) flash attention over whole sequences for Hopper (sm_90a),
// bound to Python with ctypes.
//
// Replaces the TPU (Pallas) kernel of src/repro/kernels/flash_attention.py:
//   flash_attention_launch  <- flash_attention (body _kernel)
// and computes the function of the reference's causal_attention /
// online_attention (src/repro/models/attention.py) with query positions
// arange(S) and keys from position 0, the attention of every layer of the
// full-sequence forward (Model.logits / Model.prefill).
//
// Layout, as in the reference: q (B,S,H,Dk), k (B,S,KV,Dk), v (B,S,KV,Dv),
// out (B,S,H,Dv), all contiguous; query head h reads kv-head h / (H/KV).
// Dv may differ from Dk (MLA prefill: Dk 96, Dv 64).  Scores, softmax and
// the p.v sums run in f32; masked scores are the reference's -1e30 and the
// output is acc / max(l, 1e-30), rounded once to the storage type.
//
// What bounds it: at the prefill shapes (S 1024, Dh 64-96) a query tile
// reuses each staged K/V tile for 64 rows, so the function is bound by
// operations, not bytes: q.k on bf16 operands (exact in f32) could run at
// the tensor cores' 989 TFLOP/s, but p.v multiplies f32 probabilities and
// then counts at the 67 TFLOP/s of the f32 CUDA cores.  What the design does
// about it: this first version does both products as f32 FMAs on the CUDA
// cores in register tiles (4x4 scores and 4x(Dv/16) outputs per thread,
// operands read from shared memory as float4), and does no work above the
// causal diagonal: the key loop of a query tile stops at the diagonal tile
// (the Pallas grid visits every (i, j) tile and masks it).  Tensor-core
// products (mma.sync / wgmma) are later work.
//
// One block of 256 threads per (query tile of 64 rows, query head, batch).
// The block stages its Q tile once, then walks 64-key tiles: K (transposed)
// and V staged in f32 shared memory with 16-byte loads, scores S = Q K^T
// * scale into shared memory, an online-softmax update per row (one warp per
// 8 rows: max, exp, sum, and the correction of the running sums), then
// acc = acc * corr + P V in registers.  Rows and keys at or past S are
// masked (staged as zeros, scored -1e30); rows past S are not written.
// Causal query tiles run heaviest first (the last tile has the most keys).
//
// The C entry point returns cudaGetLastError() as an int (0 = success), or
// cudaErrorInvalidValue for head dims it has no instance for.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;           // query rows and keys per tile
constexpr int kLdS = kTile + 4;     // score row stride (float4 aligned)
constexpr float kNegInf = -1e30f;   // the reference's NEG_INF

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

// Rows row0 .. row0+63 of D elements (row r at src + r * stride) into
// dst[d * kTile + r] as f32, transposed; rows at or past n are zeros.
// Consecutive threads take consecutive rows, so the transposed stores of a
// warp hit 32 consecutive words.
template <typename T, int D>
__device__ void stage_transposed(const T* src, size_t stride, int row0, int n,
                                 float* dst) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int e = threadIdx.x; e < kTile * kPerRow; e += kThreads) {
    const int r = e % kTile, c = (e / kTile) * kVec;
    float x[kVec];
    if (r < n) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(src + (row0 + r) * stride + c);
      const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < kVec; ++i) x[i] = to_f32(t[i]);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) x[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) dst[(c + i) * kTile + r] = x[i];
  }
}

// The same rows into dst[r * D + d] as f32, in row order (V tiles).
template <typename T, int D>
__device__ void stage_rows(const T* src, size_t stride, int row0, int n,
                           float* dst) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int e = threadIdx.x; e < kTile * kPerRow; e += kThreads) {
    const int r = e / kPerRow, c = (e - r * kPerRow) * kVec;
    float x[kVec];
    if (r < n) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(src + (row0 + r) * stride + c);
      const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < kVec; ++i) x[i] = to_f32(t[i]);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) x[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kVec; i += 4)
      *reinterpret_cast<float4*>(dst + r * D + c + i) =
          make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
  }
}

template <int DK, int DV>
constexpr size_t smem_floats() {
  return 2 * DK * kTile + kTile * DV + kTile * kLdS + 3 * kTile;
}

// Thread (ty, tx) of the 16 x 16 grid owns query rows ty*4 .. ty*4+3; in
// the score tile keys tx*4 .. tx*4+3, in the output the kCols columns
// jj*16*kW + tx*kW + j (jj < kCols / kW, j < kW).
template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int S, int H,
                 int KV, float scale, int causal) {
  static_assert(DK % 8 == 0, "Dk must be a multiple of 8");
  static_assert(DV == 16 || DV % 64 == 0, "Dv must be 16 or a multiple of 64");
  constexpr int kCols = DV / 16;              // output columns per thread
  constexpr int kW = kCols < 4 ? kCols : 4;   // contiguous run of them
  constexpr int kGroups = kCols / kW;

  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [DK][kTile]
  float* k_s = q_s + DK * kTile;                 // [DK][kTile]
  float* v_s = k_s + DK * kTile;                 // [kTile][DV]
  float* s_s = v_s + kTile * DV;                 // [kTile][kLdS]
  float* m_s = s_s + kTile * kLdS;
  float* l_s = m_s + kTile;
  float* c_s = l_s + kTile;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int n_tiles = (S + kTile - 1) / kTile;
  const int qt = causal ? n_tiles - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / KV);
  const int q0 = qt * kTile;

  stage_transposed<T, DK>(q + ((size_t)b * S * H + h) * DK, (size_t)H * DK,
                          q0, min(kTile, S - q0), q_s);
  if (tid < kTile) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  const T* kb = k + ((size_t)b * S * KV + kvh) * DK;
  const T* vb = v + ((size_t)b * S * KV + kvh) * DV;
  const int last = causal ? qt : n_tiles - 1;
  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * kTile, nk = min(kTile, S - k0);
    __syncthreads();  // the previous tile's reads of k_s, v_s, s_s
    stage_transposed<T, DK>(kb, (size_t)KV * DK, k0, nk, k_s);
    stage_rows<T, DV>(vb, (size_t)KV * DV, k0, nk, v_s);
    __syncthreads();

    // scores: rows ty*4+i against keys tx*4+j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DK; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(q_s + d * kTile +
                                                        ty * 4);
      const float4 c = *reinterpret_cast<const float4*>(k_s + d * kTile +
                                                        tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx * 4 + j;
        const bool live = key < S && (!causal || key <= row);
        o[j] = live ? s[i][j] * scale : kNegInf;
      }
      *reinterpret_cast<float4*>(s_s + (ty * 4 + i) * kLdS + tx * 4) =
          make_float4(o[0], o[1], o[2], o[3]);
    }
    __syncthreads();

    // online softmax, one warp per 8 rows
    for (int rr = 0; rr < kTile / (kThreads / 32); ++rr) {
      const int r = warp * (kTile / (kThreads / 32)) + rr;
      float* sr = s_s + r * kLdS;
      const float x0 = sr[lane], x1 = sr[lane + 32];
      const float m_old = m_s[r];
      const float mx = fmaxf(m_old, warp_max(fmaxf(x0, x1)));
      const float p0 = expf(x0 - mx), p1 = expf(x1 - mx);
      sr[lane] = p0;
      sr[lane + 32] = p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float corr = expf(m_old - mx);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = mx;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= corr;
    }
    for (int key = 0; key < nk; ++key) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = s_s[(ty * 4 + i) * kLdS + key];
      const float* vr = v_s + key * DV + tx * kW;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        float vv[kW];
        if constexpr (kW == 4) {
          const float4 t = *reinterpret_cast<const float4*>(vr + g * 16 * kW);
          vv[0] = t.x;
          vv[1] = t.y;
          vv[2] = t.z;
          vv[3] = t.w;
        } else {
#pragma unroll
          for (int j = 0; j < kW; ++j) vv[j] = vr[g * 16 * kW + j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < kW; ++j)
            acc[i][g * kW + j] = fmaf(p[i], vv[j], acc[i][g * kW + j]);
      }
    }
  }

  // rows past S are not written; l_s was last written before the barrier
  // that precedes the P V loop
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float l = fmaxf(l_s[ty * 4 + i], 1e-30f);
    T* o = out + (((size_t)b * S + row) * H + h) * DV + tx * kW;
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
#pragma unroll
      for (int j = 0; j < kW; ++j)
        o[g * 16 * kW + j] = from_f32<T>(acc[i][g * kW + j] / l);
  }
}

template <typename T, int DK, int DV>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int KV, int causal, float scale,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<DK, DV>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  flash_kernel<T, DK, DV><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, S, H, KV, scale,
      causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int S, int H, int KV, int Dk, int Dv, int causal, float scale,
             cudaStream_t st) {
  // the head dims of the served models (tinyllama 64/64, minicpm3's MLA
  // prefill 96/64, 128-wide heads) and of their reduced test configs
#define FLASH_CASE(DK, DV)                                                  \
  if (Dk == DK && Dv == DV)                                                 \
    return launch<T, DK, DV>(q, k, v, out, B, S, H, KV, causal, scale, st);
  FLASH_CASE(64, 64)
  FLASH_CASE(96, 64)
  FLASH_CASE(128, 128)
  FLASH_CASE(64, 128)
  FLASH_CASE(96, 128)
  FLASH_CASE(128, 64)
  FLASH_CASE(16, 16)
  FLASH_CASE(24, 16)
#undef FLASH_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// bf16 != 0 selects __nv_bfloat16 storage, else float.  Every pointer must
// be 16-byte aligned (the wrapper checks).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int H, int KV, int Dk, int Dv,
                                      int causal, int bf16, float scale,
                                      void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, out, B, S, H, KV, Dk, Dv, causal,
                                   scale, (cudaStream_t)stream);
  return dispatch<float>(q, k, v, out, B, S, H, KV, Dk, Dv, causal, scale,
                         (cudaStream_t)stream);
}
