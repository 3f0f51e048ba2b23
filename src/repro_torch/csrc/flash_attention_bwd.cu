// The backward of flash attention over whole sequences for Hopper (sm_90a),
// bound to Python with ctypes.
//
// Replaces: the gradient that XLA takes of the reference's training
// attention, online_attention (src/repro/models/attention.py), whose chunk
// body runs under jax.checkpoint(policy=nothing_saveable): the backward
// recomputes each chunk's scores instead of saving them.  The reference's
// Pallas flash_attention (src/repro/kernels/flash_attention.py) has no
// backward; the port's forward is a hand-written kernel
// (csrc/flash_attention.cu), so its gradient is this kernel, behind
// FlashAttentionFn (kernels/flash_attention.py).
//
// Inputs, as the forward's: q (B,S,H,Dk), k (B,S,KV,Dk), v (B,S,KV,Dv), the
// forward's output o (B,S,H,Dv) and dout of its shape, all contiguous, f32 or
// bf16; lse (B,H,S) f32, each row's log-sum-exp of its scaled scores, stored
// by the forward.  Outputs dq, dk, dv in the inputs' dtype; scratch delta
// (B,H,S) f32.  Query head h reads kv-head h / (H/KV).  With P recomputed as
// exp(S * scale - lse) (masked scores the reference's -1e30, so P = 0):
//   delta = rowsum(dout o), dS = P (dout V^T - delta) scale,
//   dV = P^T dout, dK = dS^T Q, dQ = dS K,
// dK and dV summed over the G query heads of each kv-head.  Any S >= 1;
// causal (query i sees keys 0..i) or not; Dv may differ from Dk.
//
// What bounds it: at tinyllama's training shape (B 8, S 2048, H 32, KV 4,
// 64/64, causal) the five products the gradient needs (the q.k recompute,
// dout.v, and the three gradient products) are 344 GFLOP against 0.3 GB of
// inputs and outputs, so it is bound by operations: 0.35 ms on the bf16
// tensor cores (989 TFLOP/s), 5.1 ms on f32 FMAs (67 TFLOP/s).  This kernel
// computes in f32 FMAs (every product exact f32 arithmetic) and recomputes
// the scores and dout.v once in each of its two passes, seven products in
// all: its bound is 7.2 ms at the f32 rate.  The tensor cores (wgmma), TMA
// and warp specialisation are later work.
//
// What the design does: three launches, no float atomics, so the gradients
// are bitwise repeatable from run to run and the GQA sum over a kv-head's G
// query heads happens inside one block.
//   delta_kernel: one thread per (b, s, h) row, delta in f32.
//   dkdv_kernel: a block of 256 threads per (64-key tile, kv-head, batch)
//     keeps its K and V tiles in shared memory, then walks the G query
//     heads of its group and, for each, the query tiles from the diagonal
//     onward (all of them when not causal).  Per query tile it stages Q and
//     dout (and the tile's lse and delta), forms S^T and (dout V^T)^T as
//     64 x 64 register tiles (4 x 4 a thread), P and dS in registers, stores
//     them to shared memory, and adds P^T dout and dS^T Q into f32
//     accumulators held in registers; dK and dV are written once.
//   dq_kernel: a block per (64-row query tile, head, batch) keeps Q and dout
//     and walks the key tiles up to the diagonal, adding dS K; dQ is written
//     once.
// Tiles live in shared memory as f32 rows padded by 4 floats (16-byte loads,
// no bank conflicts between the rows a quarter-warp reads); head dims are
// padded to multiples of 16 with zeros.  Causal tiles run heaviest first
// (the tile index is the slowest grid dimension).
//
// The C entry point returns cudaGetLastError() as an int (0 = success), or
// cudaErrorInvalidValue for head dims it has no instance for or a grid it
// cannot launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;            // query rows and keys per tile
constexpr int kLdP = kTile + 4;      // row stride of the P and dS tiles
constexpr float kNegInf = -1e30f;    // the reference's NEG_INF

__host__ __device__ constexpr int round16(int d) { return (d + 15) / 16 * 16; }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// elements of T in one 16-byte load
template <typename T>
__host__ __device__ constexpr int vec_of() {
  return 16 / (int)sizeof(T);
}

// Rows row0 .. row0+63 of D elements (row r at src + r * stride) into
// dst[r * (DP + 4) + c] as f32; rows at or past n and columns D .. DP-1 are
// zeros.  16-byte loads, consecutive threads on consecutive chunks.
template <typename T, int D, int DP>
__device__ void stage(const T* __restrict__ src, size_t stride, int row0,
                      int n, float* __restrict__ dst) {
  constexpr int kV = vec_of<T>();
  static_assert(D % kV == 0, "a row must be whole 16-byte chunks");
  constexpr int kChunks = D / kV;
  constexpr int LD = DP + 4;
  for (int e = threadIdx.x; e < kTile * kChunks; e += kThreads) {
    const int r = e / kChunks, c = (e - r * kChunks) * kV;
    float x[kV];
    if (r < n) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          src + (size_t)(row0 + r) * stride + c);
      if constexpr (kV == 4) {
        const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
        for (int i = 0; i < 4; ++i) x[i] = f[i];
      } else {
        const __nv_bfloat162* h =
            reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int i = 0; i < kV / 2; ++i) {
          const float2 f = __bfloat1622float2(h[i]);
          x[2 * i] = f.x;
          x[2 * i + 1] = f.y;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < kV; ++i) x[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kV; i += 4)
      *reinterpret_cast<float4*>(dst + r * LD + c + i) =
          make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
  }
  if constexpr (DP > D) {
    for (int e = threadIdx.x; e < kTile * (DP - D); e += kThreads) {
      const int r = e / (DP - D), c = D + (e - r * (DP - D));
      dst[r * LD + c] = 0.f;
    }
  }
}

// acc[i][j] += sum over d < DP of a[(ty*4 + i) * LD + d] * b[(tx + 16 j) *
// LD + d]: rows ty*4 .. ty*4+3 of a against rows tx, tx+16, tx+32, tx+48 of
// b, d in order.
template <int DP>
__device__ __forceinline__ void score_tile(const float* __restrict__ a,
                                           const float* __restrict__ b,
                                           float (&acc)[4][4], int ty,
                                           int tx) {
  constexpr int LD = DP + 4;
#pragma unroll 2
  for (int d = 0; d < DP; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (ty * 4 + i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = acc[i][j];
        s = fmaf(av[i].x, bv[j].x, s);
        s = fmaf(av[i].y, bv[j].y, s);
        s = fmaf(av[i].z, bv[j].z, s);
        s = fmaf(av[i].w, bv[j].w, s);
        acc[i][j] = s;
      }
  }
}

// Columns a thread owns of a 64 x DP output: kCols = DP / 16 of them, in
// kG groups of kW adjacent columns; column g*16*kW + tx*kW + jj is
// acc[.][g*kW + jj].
template <int DP>
struct Cols {
  static constexpr int kCols = DP / 16;
  static constexpr int kW = kCols % 4 == 0 ? 4 : (kCols % 2 == 0 ? 2 : 1);
  static constexpr int kG = kCols / kW;
};

// acc[i][.] += sum over k < 64 of pt[k * kLdP + ty*4 + i] * z[k * (DP+4) +
// col]: output rows ty*4 .. ty*4+3 of (pt^T z), k in order.
template <int DP>
__device__ __forceinline__ void out_tile(const float* __restrict__ pt,
                                         const float* __restrict__ z,
                                         float (&acc)[4][DP / 16], int tx,
                                         int ty) {
  using C = Cols<DP>;
  constexpr int LD = DP + 4;
#pragma unroll 4
  for (int k = 0; k < kTile; ++k) {
    const float4 p4 = *reinterpret_cast<const float4*>(pt + k * kLdP + ty * 4);
    const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
    for (int g = 0; g < C::kG; ++g) {
      const float* zr = z + k * LD + g * 16 * C::kW + tx * C::kW;
      float zv[C::kW];
      if constexpr (C::kW == 4) {
        const float4 t = *reinterpret_cast<const float4*>(zr);
        zv[0] = t.x;
        zv[1] = t.y;
        zv[2] = t.z;
        zv[3] = t.w;
      } else if constexpr (C::kW == 2) {
        const float2 t = *reinterpret_cast<const float2*>(zr);
        zv[0] = t.x;
        zv[1] = t.y;
      } else {
        zv[0] = zr[0];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < C::kW; ++jj)
          acc[i][g * C::kW + jj] = fmaf(p[i], zv[jj], acc[i][g * C::kW + jj]);
    }
  }
}

// Rows row0 + ty*4 + i (below S) of a 64 x DP accumulator into dst (row r
// at dst + r * stride), the columns below D, in T.
template <typename T, int D, int DP>
__device__ __forceinline__ void write_rows(const float (&acc)[4][DP / 16],
                                           T* __restrict__ dst, size_t stride,
                                           int row0, int S, int tx, int ty) {
  using C = Cols<DP>;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= S) continue;
    T* o = dst + (size_t)row * stride;
#pragma unroll
    for (int g = 0; g < C::kG; ++g)
#pragma unroll
      for (int jj = 0; jj < C::kW; ++jj) {
        const int col = g * 16 * C::kW + tx * C::kW + jj;
        if (col < D) store(o + col, acc[i][g * C::kW + jj]);
      }
  }
}

// delta[b, h, s] = sum over d of o[b, s, h, d] * dout[b, s, h, d], in f32;
// one thread per (b, s, h) row, rows = B * S * H.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                 float* __restrict__ delta, int S, int H, int Dv, int rows) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= rows) return;
  const T* a = o + (size_t)row * Dv;
  const T* c = dout + (size_t)row * Dv;
  float acc = 0.f;
  for (int d = 0; d < Dv; ++d) acc = fmaf(to_f32(a[d]), to_f32(c[d]), acc);
  const int h = row % H, s = (row / H) % S, b = row / (H * S);
  delta[((size_t)b * H + h) * S + s] = acc;
}

template <int DK, int DV>
constexpr size_t dkdv_smem_floats() {
  return kTile * (2 * (round16(DK) + 4) + 2 * (round16(DV) + 4)) +
         2 * kTile * kLdP + 2 * kTile;
}

template <int DK, int DV>
constexpr size_t dq_smem_floats() {
  return kTile * (2 * (round16(DK) + 4) + 2 * (round16(DV) + 4)) +
         kTile * kLdP;
}

// Thread (ty, tx) of the 16 x 16 grid: in the score tiles keys ty*4+i
// against queries tx+16j; in the dK and dV accumulators key rows ty*4+i.
template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kThreads)
    dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk,
                T* __restrict__ dv, int S, int H, int KV, float scale,
                int causal) {
  constexpr int KP = round16(DK), VP = round16(DV);
  constexpr int LDK = KP + 4, LDV = VP + 4;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);  // [64 keys][LDK]
  float* v_s = k_s + kTile * LDK;                // [64 keys][LDV]
  float* q_s = v_s + kTile * LDV;                // [64 queries][LDK]
  float* do_s = q_s + kTile * LDK;               // [64 queries][LDV]
  float* p_s = do_s + kTile * LDV;               // [query][kLdP]: P[q][key]
  float* ds_s = p_s + kTile * kLdP;              // [query][kLdP]: dS[q][key]
  float* lse_s = ds_s + kTile * kLdP;            // [64]
  float* dl_s = lse_s + kTile;                   // [64]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n_tiles = (S + kTile - 1) / kTile;
  const int kt = blockIdx.z;  // low key tiles have the most query tiles
  const int kvh = blockIdx.x, b = blockIdx.y, G = H / KV;
  const int k0 = kt * kTile;

  stage<T, DK, KP>(k + ((size_t)b * S * KV + kvh) * DK, (size_t)KV * DK, k0,
                   min(kTile, S - k0), k_s);
  stage<T, DV, VP>(v + ((size_t)b * S * KV + kvh) * DV, (size_t)KV * DV, k0,
                   min(kTile, S - k0), v_s);

  float dk_acc[4][KP / 16], dv_acc[4][VP / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < KP / 16; ++j) dk_acc[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < VP / 16; ++j) dv_acc[i][j] = 0.f;
  }

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const T* qh = q + ((size_t)b * S * H + h) * DK;
    const T* doh = dout + ((size_t)b * S * H + h) * DV;
    const float* lseh = lse + ((size_t)b * H + h) * S;
    const float* dlh = delta + ((size_t)b * H + h) * S;
    for (int qt = causal ? kt : 0; qt < n_tiles; ++qt) {
      const int q0 = qt * kTile, nq = min(kTile, S - q0);
      __syncthreads();  // the previous tile's reads of q_s .. dl_s
      stage<T, DK, KP>(qh, (size_t)H * DK, q0, nq, q_s);
      stage<T, DV, VP>(doh, (size_t)H * DV, q0, nq, do_s);
      if (tid < kTile) {
        lse_s[tid] = tid < nq ? lseh[q0 + tid] : 0.f;
        dl_s[tid] = tid < nq ? dlh[q0 + tid] : 0.f;
      }
      __syncthreads();

      // S^T and (dout V^T)^T: keys ty*4+i against queries tx+16j
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
      score_tile<KP>(k_s, q_s, s, ty, tx);
      score_tile<VP>(v_s, do_s, dp, ty, tx);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ql = tx + 16 * j, qrow = q0 + ql;
        const float L = lse_s[ql], D = dl_s[ql];
        float p[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = k0 + ty * 4 + i;
          const bool live = qrow < S && key < S && (!causal || key <= qrow);
          const float x = live ? s[i][j] * scale : kNegInf;
          p[i] = expf(x - L);
          ds[i] = p[i] * (dp[i][j] - D) * scale;
        }
        *reinterpret_cast<float4*>(p_s + ql * kLdP + ty * 4) =
            make_float4(p[0], p[1], p[2], p[3]);
        *reinterpret_cast<float4*>(ds_s + ql * kLdP + ty * 4) =
            make_float4(ds[0], ds[1], ds[2], ds[3]);
      }
      __syncthreads();

      out_tile<VP>(p_s, do_s, dv_acc, tx, ty);   // dV += P^T dout
      out_tile<KP>(ds_s, q_s, dk_acc, tx, ty);   // dK += dS^T Q
    }
  }
  write_rows<T, DK, KP>(dk_acc, dk + ((size_t)b * S * KV + kvh) * DK,
                        (size_t)KV * DK, k0, S, tx, ty);
  write_rows<T, DV, VP>(dv_acc, dv + ((size_t)b * S * KV + kvh) * DV,
                        (size_t)KV * DV, k0, S, tx, ty);
}

// Thread (ty, tx): in the score tiles queries ty*4+i against keys tx+16j;
// in the dQ accumulator query rows ty*4+i.
template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int S, int H, int KV, float scale,
              int causal) {
  constexpr int KP = round16(DK), VP = round16(DV);
  constexpr int LDK = KP + 4, LDV = VP + 4;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [64 queries][LDK]
  float* do_s = q_s + kTile * LDK;               // [64 queries][LDV]
  float* k_s = do_s + kTile * LDV;               // [64 keys][LDK]
  float* v_s = k_s + kTile * LDK;                // [64 keys][LDV]
  float* ds_s = v_s + kTile * LDV;               // [key][kLdP]: dS[q][key]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n_tiles = (S + kTile - 1) / kTile;
  const int qt = causal ? n_tiles - 1 - (int)blockIdx.z : (int)blockIdx.z;
  const int h = blockIdx.x, b = blockIdx.y, kvh = h / (H / KV);
  const int q0 = qt * kTile, nq = min(kTile, S - q0);

  stage<T, DK, KP>(q + ((size_t)b * S * H + h) * DK, (size_t)H * DK, q0, nq,
                   q_s);
  stage<T, DV, VP>(dout + ((size_t)b * S * H + h) * DV, (size_t)H * DV, q0,
                   nq, do_s);
  float L[4], D[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    L[i] = row < S ? lse[((size_t)b * H + h) * S + row] : 0.f;
    D[i] = row < S ? delta[((size_t)b * H + h) * S + row] : 0.f;
  }
  float dq_acc[4][KP / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < KP / 16; ++j) dq_acc[i][j] = 0.f;

  const T* kb = k + ((size_t)b * S * KV + kvh) * DK;
  const T* vb = v + ((size_t)b * S * KV + kvh) * DV;
  const int last = causal ? qt : n_tiles - 1;
  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * kTile, nk = min(kTile, S - k0);
    __syncthreads();  // the previous tile's reads of k_s, v_s, ds_s
    stage<T, DK, KP>(kb, (size_t)KV * DK, k0, nk, k_s);
    stage<T, DV, VP>(vb, (size_t)KV * DV, k0, nk, v_s);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    score_tile<KP>(q_s, k_s, s, ty, tx);
    score_tile<VP>(do_s, v_s, dp, ty, tx);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kl = tx + 16 * j, key = k0 + kl;
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qrow = q0 + ty * 4 + i;
        const bool live = qrow < S && key < S && (!causal || key <= qrow);
        const float x = live ? s[i][j] * scale : kNegInf;
        const float p = expf(x - L[i]);
        ds[i] = p * (dp[i][j] - D[i]) * scale;
      }
      *reinterpret_cast<float4*>(ds_s + kl * kLdP + ty * 4) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();
    out_tile<KP>(ds_s, k_s, dq_acc, tx, ty);     // dQ += dS K
  }
  write_rows<T, DK, KP>(dq_acc, dq + ((size_t)b * S * H + h) * DK,
                        (size_t)H * DK, q0, S, tx, ty);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int DK, int DV>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int B, int S, int H, int KV, int causal,
           float scale, cudaStream_t stream) {
  const size_t smem_kv = sizeof(float) * dkdv_smem_floats<DK, DV>();
  const size_t smem_q = sizeof(float) * dq_smem_floats<DK, DV>();
  cudaError_t err = allow_smem(dkdv_kernel<T, DK, DV>, smem_kv);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(dq_kernel<T, DK, DV>, smem_q);
  if (err != cudaSuccess) return (int)err;
  const int rows = B * S * H;
  delta_kernel<T><<<(rows + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      (const T*)o, (const T*)dout, delta, S, H, DV, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (S + kTile - 1) / kTile;
  dkdv_kernel<T, DK, DV><<<dim3(KV, B, n_tiles), kThreads, smem_kv, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dk, (T*)dv, S, H, KV, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dq_kernel<T, DK, DV><<<dim3(H, B, n_tiles), kThreads, smem_q, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dq, S, H, KV, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 != 0: the tensors (all but lse and delta) are bf16, else f32.  Every
// pointer must be 16-byte aligned (the wrapper checks).  The head dims are
// those of the models the port trains: tinyllama 64/64, minicpm3's MLA
// 96/64, and the reduced test configs' 16/16 (GQA) and 24/16 (MLA).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int B, int S, int H, int KV, int Dk, int Dv, int causal,
    int bf16, float scale, void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV || H > 65535 || B > 65535 ||
      (S + kTile - 1) / kTile > 65535 || (long long)B * S * H >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define BWD_CASE(DK, DV)                                                    \
  if (Dk == DK && Dv == DV)                                                 \
    return bf16 ? launch<__nv_bfloat16, DK, DV>(q, k, v, o, dout, lse,      \
                                                delta, dq, dk, dv, B, S, H, \
                                                KV, causal, scale, st)      \
                : launch<float, DK, DV>(q, k, v, o, dout, lse, delta, dq,   \
                                        dk, dv, B, S, H, KV, causal, scale, \
                                        st);
  BWD_CASE(64, 64)
  BWD_CASE(96, 64)
  BWD_CASE(16, 16)
  BWD_CASE(24, 16)
#undef BWD_CASE
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of the dK/dV and dQ kernels at (Dk, Dv), in bytes,
// or 0 for head dims without an instance.
extern "C" int flash_attention_bwd_smem_bytes(int Dk, int Dv, int dq) {
#define SMEM_CASE(DK, DV)                                               \
  if (Dk == DK && Dv == DV)                                             \
    return (int)(sizeof(float) * (dq ? dq_smem_floats<DK, DV>()         \
                                     : dkdv_smem_floats<DK, DV>()));
  SMEM_CASE(64, 64)
  SMEM_CASE(96, 64)
  SMEM_CASE(16, 16)
  SMEM_CASE(24, 16)
#undef SMEM_CASE
  return 0;
}
