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
// tensor cores (989 TFLOP/s).  Both bodies run seven products (the q.k
// recompute and dout.v once in each of the two passes below): 481 GFLOP,
// 0.49 ms at the bf16 rate, 7.2 ms on f32 FMAs (67 TFLOP/s).
//
// No float atomics anywhere: dK/dV and dQ are two passes, each output
// written once by the block that owns it, so the gradients are bitwise
// repeatable from run to run and the GQA sum over a kv-head's G query heads
// happens inside one block.  One pass with dQ merged from per-key-tile f32
// partials would need about 4 GB of scratch at the training shape; dQ
// summed in a fixed order through ordered semaphores is later work.  Causal
// tiles run heaviest first (the tile index is the slowest grid dimension).
// Three launches: delta, then dK/dV, then dQ.
//
// delta_kernel: rowsum(dout o) in f32, each row's Dv elements read as
//   16-byte chunks by Dv*elem/16 adjacent lanes and summed by shuffles.
//
// bf16: dkdv_wgmma_kernel and dq_wgmma_kernel, every product on the tensor
//   cores (wgmma, bf16 operands, f32 accumulators), all tiles copied by TMA
//   into 128-byte-swizzled 64-column panels (csrc/hopper.cuh), one
//   warpgroup (128 threads) per block, thread 0 issuing the copies.  Head
//   dims are padded to whole panels by TMA's zero fill (16 and 24 -> 64, 96
//   -> 128, 192 is three panels); the ragged edge of S is zero-filled the
//   same way and masked.
//   dkdv_wgmma_kernel: a block per (64-key tile, kv-head, batch).  K and V
//     arrive once; the block walks the G query heads of its kv-head and,
//     for each, the query tiles of BQ rows from the diagonal on (all of
//     them when not causal).  Q and dout of a tile arrive through a TMA
//     ring of two stages handed over by full/empty mbarriers, so the next
//     tile's copy is in flight while the current tile's products run; the
//     tile's lse (times log2 e) and delta are loaded a tile ahead by the
//     threads into a double buffer in shared memory, since in the S^T
//     layout queries are the accumulator's columns and each thread needs
//     them for its 2 * BQ / 8 columns.  Per tile: S^T = K Q^T and dP^T =
//     V dout^T as wgmma m64nBQk16 with both operands in shared memory,
//     K-major; P^T = exp2(S^T scale log2 e - lse log2 e) and dS^T = P^T
//     (dP^T - delta) scale in f32 registers; both rounded to bf16 pairwise,
//     which makes them the register A fragments of dV += P^T dout and dK +=
//     dS^T Q (wgmma m64n64k16 per 64-column panel, B = the dout or Q tile
//     read MN-major).  dK and dV stay in f32 registers over all G heads and
//     are written once.
//   dq_wgmma_kernel: a block per (64-row query tile, head, batch).  Q and
//     dout arrive once and stay; each thread keeps the lse and delta of its
//     two rows in registers; 64-key K/V tiles up to the diagonal arrive
//     through the two-stage ring.  S = Q K^T and dP = dout V^T (wgmma, both
//     operands in shared memory), dS in registers rounded to bf16 as the A
//     fragment, dQ += dS K with K read MN-major; dQ is written once.
//   Rounding: P and dS are rounded to bf16 as operands (as the forward and
//   SDPA round P), at most 2^-8 of each term of the three gradient sums;
//   every sum is f32.
//   Registers, the known pressure: dK/dV's kernel holds dK (32 a thread per
//   64 Dk columns), dV (32 per 64 Dv columns), S^T and dP^T (BQ / 2 each)
//   and their bf16 fragments.  At (192, 128) that is 96 + 64 + 32 + 32 with
//   64-query tiles, beyond 255 with addressing, so there the query tile is
//   BQ = 32 (S^T and dP^T 16 registers each; wgmma m64n32k16); elsewhere
//   BQ = 64.  The build prints each instance's registers and spills
//   (-Xptxas -v).  A wrong wgmma descriptor gives finite wrong numbers, so
//   a first call checks small shapes first (scripts/flash_first_call.py).
//   Not yet: warp specialisation with setmaxnreg, products overlapped with
//   the softmax of the next tile, dQ in the same pass.
//
// f32: dkdv_fma_kernel and dq_fma_kernel, the same two passes on f32 FMAs
//   (every product exact f32 arithmetic), 256 threads a block.
//   dkdv_fma_kernel keeps its K and V tiles in shared memory, then walks
//   the G query heads of its group and, for each, the query tiles from the
//   diagonal onward.  Per query tile it stages Q and dout (and the tile's
//   lse and delta), forms S^T and (dout V^T)^T as 64 x 64 register tiles
//   (4 x 4 a thread), P and dS in registers, stores them to shared memory,
//   and adds P^T dout and dS^T Q into f32 accumulators held in registers.
//   dq_fma_kernel keeps Q and dout and walks the key tiles up to the
//   diagonal, adding dS K.  Tiles live in shared memory as f32 rows padded
//   by 4 floats (16-byte loads, no bank conflicts between the rows a
//   quarter-warp reads); head dims are padded to multiples of 16 with zeros.
//
// The C entry point returns cudaGetLastError() as an int (0 = success), or
// cudaErrorInvalidValue for head dims it has no instance for, a grid it
// cannot launch or tensor maps that cuTensorMapEncodeTiled refuses.

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;    // the reference's NEG_INF
constexpr int kTile = 64;            // query rows and keys per tile

// ---------------------------------------------------------------------------
// delta
// ---------------------------------------------------------------------------

constexpr int kDeltaThreads = 256;

// delta[b, h, s] = sum over d of o[b, s, h, d] * dout[b, s, h, d], in f32;
// kL = DV / (elements in 16 bytes) adjacent lanes per (b, s, h) row, rows =
// B * S * H.
template <typename T, int DV>
__global__ void __launch_bounds__(kDeltaThreads)
    delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                 float* __restrict__ delta, int S, int H, int rows) {
  constexpr int kV = 16 / (int)sizeof(T);
  constexpr int kL = DV / kV;
  static_assert(DV % kV == 0 && kL <= 32 && (kL & (kL - 1)) == 0,
                "a row must be a power-of-two number of 16-byte chunks");
  const int tid = threadIdx.x;
  const int row = blockIdx.x * (kDeltaThreads / kL) + tid / kL;
  const int c = (tid % kL) * kV;
  float acc = 0.f;
  if (row < rows) {
    const uint4 a =
        *reinterpret_cast<const uint4*>(o + (size_t)row * DV + c);
    const uint4 g =
        *reinterpret_cast<const uint4*>(dout + (size_t)row * DV + c);
    if constexpr (sizeof(T) == 4) {
      const float* x = reinterpret_cast<const float*>(&a);
      const float* y = reinterpret_cast<const float*>(&g);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc = fmaf(x[i], y[i], acc);
    } else {
      const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 u = __bfloat1622float2(x[i]);
        const float2 w = __bfloat1622float2(y[i]);
        acc = fmaf(u.x, w.x, acc);
        acc = fmaf(u.y, w.y, acc);
      }
    }
  }
#pragma unroll
  for (int off = kL / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && tid % kL == 0) {
    const int h = row % H, s = (row / H) % S, b = row / (H * S);
    delta[((size_t)b * H + h) * S + s] = acc;
  }
}

template <typename T, int DV>
cudaError_t launch_delta(const void* o, const void* dout, float* delta, int B,
                         int S, int H, cudaStream_t stream) {
  constexpr int kRows = kDeltaThreads / (DV * (int)sizeof(T) / 16);
  const int rows = B * S * H;
  delta_kernel<T, DV><<<(rows + kRows - 1) / kRows, kDeltaThreads, 0,
                        stream>>>((const T*)o, (const T*)dout, delta, S, H,
                                  rows);
  return cudaGetLastError();
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// ---------------------------------------------------------------------------
// f32 body: FMAs
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kLdP = kTile + 4;      // row stride of the P and dS tiles

__host__ __device__ constexpr int round16(int d) { return (d + 15) / 16 * 16; }

// Rows row0 .. row0+63 of D floats (row r at src + r * stride) into
// dst[r * (DP + 4) + c]; rows at or past n and columns D .. DP-1 are zeros.
// 16-byte loads, consecutive threads on consecutive chunks.
template <int D, int DP>
__device__ void stage(const float* __restrict__ src, size_t stride, int row0,
                      int n, float* __restrict__ dst) {
  static_assert(D % 4 == 0, "a row must be whole 16-byte chunks");
  constexpr int kChunks = D / 4;
  constexpr int LD = DP + 4;
  for (int e = threadIdx.x; e < kTile * kChunks; e += kThreads) {
    const int r = e / kChunks, c = (e - r * kChunks) * 4;
    const float4 x =
        r < n ? *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) *
                                                           stride + c)
              : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + r * LD + c) = x;
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
// at dst + r * stride), the columns below D.
template <int D, int DP>
__device__ __forceinline__ void write_rows(const float (&acc)[4][DP / 16],
                                           float* __restrict__ dst,
                                           size_t stride, int row0, int S,
                                           int tx, int ty) {
  using C = Cols<DP>;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= S) continue;
    float* o = dst + (size_t)row * stride;
#pragma unroll
    for (int g = 0; g < C::kG; ++g)
#pragma unroll
      for (int jj = 0; jj < C::kW; ++jj) {
        const int col = g * 16 * C::kW + tx * C::kW + jj;
        if (col < D) o[col] = acc[i][g * C::kW + jj];
      }
  }
}

template <int DK, int DV>
constexpr size_t dkdv_fma_smem_floats() {
  return kTile * (2 * (round16(DK) + 4) + 2 * (round16(DV) + 4)) +
         2 * kTile * kLdP + 2 * kTile;
}

template <int DK, int DV>
constexpr size_t dq_fma_smem_floats() {
  return kTile * (2 * (round16(DK) + 4) + 2 * (round16(DV) + 4)) +
         kTile * kLdP;
}

// Thread (ty, tx) of the 16 x 16 grid: in the score tiles keys ty*4+i
// against queries tx+16j; in the dK and dV accumulators key rows ty*4+i.
template <int DK, int DV>
__global__ void __launch_bounds__(kThreads)
    dkdv_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dk,
                    float* __restrict__ dv, int S, int H, int KV,
                    float scale, int causal) {
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

  stage<DK, KP>(k + ((size_t)b * S * KV + kvh) * DK, (size_t)KV * DK, k0,
                min(kTile, S - k0), k_s);
  stage<DV, VP>(v + ((size_t)b * S * KV + kvh) * DV, (size_t)KV * DV, k0,
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
    const float* qh = q + ((size_t)b * S * H + h) * DK;
    const float* doh = dout + ((size_t)b * S * H + h) * DV;
    const float* lseh = lse + ((size_t)b * H + h) * S;
    const float* dlh = delta + ((size_t)b * H + h) * S;
    for (int qt = causal ? kt : 0; qt < n_tiles; ++qt) {
      const int q0 = qt * kTile, nq = min(kTile, S - q0);
      __syncthreads();  // the previous tile's reads of q_s .. dl_s
      stage<DK, KP>(qh, (size_t)H * DK, q0, nq, q_s);
      stage<DV, VP>(doh, (size_t)H * DV, q0, nq, do_s);
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
  write_rows<DK, KP>(dk_acc, dk + ((size_t)b * S * KV + kvh) * DK,
                     (size_t)KV * DK, k0, S, tx, ty);
  write_rows<DV, VP>(dv_acc, dv + ((size_t)b * S * KV + kvh) * DV,
                     (size_t)KV * DV, k0, S, tx, ty);
}

// Thread (ty, tx): in the score tiles queries ty*4+i against keys tx+16j;
// in the dQ accumulator query rows ty*4+i.
template <int DK, int DV>
__global__ void __launch_bounds__(kThreads)
    dq_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dq,
                  int S, int H, int KV, float scale, int causal) {
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

  stage<DK, KP>(q + ((size_t)b * S * H + h) * DK, (size_t)H * DK, q0, nq,
                q_s);
  stage<DV, VP>(dout + ((size_t)b * S * H + h) * DV, (size_t)H * DV, q0, nq,
                do_s);
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

  const float* kb = k + ((size_t)b * S * KV + kvh) * DK;
  const float* vb = v + ((size_t)b * S * KV + kvh) * DV;
  const int last = causal ? qt : n_tiles - 1;
  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * kTile, nk = min(kTile, S - k0);
    __syncthreads();  // the previous tile's reads of k_s, v_s, ds_s
    stage<DK, KP>(kb, (size_t)KV * DK, k0, nk, k_s);
    stage<DV, VP>(vb, (size_t)KV * DV, k0, nk, v_s);
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
  write_rows<DK, KP>(dq_acc, dq + ((size_t)b * S * H + h) * DK,
                     (size_t)H * DK, q0, S, tx, ty);
}

template <int DK, int DV>
int launch_fma(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv, int B, int S, int H, int KV, int causal,
               float scale, cudaStream_t stream) {
  const size_t smem_kv = sizeof(float) * dkdv_fma_smem_floats<DK, DV>();
  const size_t smem_q = sizeof(float) * dq_fma_smem_floats<DK, DV>();
  cudaError_t err = allow_smem(dkdv_fma_kernel<DK, DV>, smem_kv);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(dq_fma_kernel<DK, DV>, smem_q);
  if (err != cudaSuccess) return (int)err;
  err = launch_delta<float, DV>(o, dout, delta, B, S, H, stream);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (S + kTile - 1) / kTile;
  dkdv_fma_kernel<DK, DV><<<dim3(KV, B, n_tiles), kThreads, smem_kv,
                            stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      lse, delta, (float*)dk, (float*)dv, S, H, KV, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dq_fma_kernel<DK, DV><<<dim3(H, B, n_tiles), kThreads, smem_q, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      lse, delta, (float*)dq, S, H, KV, scale, causal);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 body: wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 128;      // one warpgroup
constexpr int kStages = 2;           // the Q/dout (dK/dV) or K/V (dQ) ring

// d (64 x N) (+)= A B^T over one k16 step, both operands K-major in shared
// memory, N = 32 or 64
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (N == 32)
    wgmma_ss_n32(d, da, db, scale_d);
  else
    wgmma_ss_n64(d, da, db, scale_d);
}

template <int NP>
__device__ __forceinline__ void fence_panels(float (&acc)[NP][32]) {
#pragma unroll
  for (int p = 0; p < NP; ++p) fence_regs(acc[p]);
}

// acc (64 x 64 NP, NP panels of 32 registers a thread) += A (64 x 16,
// bf16 registers) * B (16 x 64 NP): B's NP panels, each of 64 columns and
// `panel` bytes, read MN-major from addr on (the rows of a k16 step).
template <int NP>
__device__ __forceinline__ void mma_panels(float (&acc)[NP][32],
                                           const uint32_t (&a)[4],
                                           uint32_t addr, uint32_t panel) {
#pragma unroll
  for (int p = 0; p < NP; ++p)
    wgmma_rs_n64(acc[p], a, smem_desc(addr + p * panel, panel, 1024), 1);
}

// Rows row0 + r0 and row0 + r0 + 8 (those below S) of a 64 x 64 NP f32
// accumulator into dst (row r at dst + r * stride) as bf16 pairs, the
// columns below D.
template <int NP>
__device__ __forceinline__ void store_rows(const float (&acc)[NP][32],
                                           __nv_bfloat16* __restrict__ dst,
                                           size_t stride, int row0, int S,
                                           int D, int r0, int c0) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + r0 + 8 * i;
    if (row >= S) continue;
    __nv_bfloat16* o = dst + (size_t)row * stride;
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = 64 * p + 8 * n + c0;
        if (col < D)
          *reinterpret_cast<uint32_t*>(o + col) =
              pack_bf16(acc[p][4 * n + 2 * i], acc[p][4 * n + 2 * i + 1]);
      }
  }
}

// Shared memory of dkdv_wgmma_kernel<QP, VP, BQ> (from a 1024-byte-aligned
// base): K (QP panels of 64 keys), V (VP panels), kStages Q stages of QP
// panels of BQ queries, kStages dout stages of VP panels, two lse/delta
// buffers of 2 BQ floats, the mbarriers.
constexpr size_t dkdv_wgmma_smem_bytes(int QP, int VP, int BQ) {
  return 1024 + (QP + VP) * kPanelBytes + kStages * (QP + VP) * BQ * 128 +
         2 * 2 * BQ * sizeof(float) + 8 * (2 * kStages + 1);
}

// ... of dq_wgmma_kernel<QP, VP>: Q and dout (QP + VP panels of 64
// queries), kStages K stages of QP panels and V stages of VP panels, the
// mbarriers.
constexpr size_t dq_wgmma_smem_bytes(int QP, int VP) {
  return 1024 + (1 + kStages) * (QP + VP) * kPanelBytes +
         8 * (2 * kStages + 1);
}

// In the S^T and dP^T accumulators (64 keys x BQ queries) thread (warp w,
// lane l) holds keys k0 + r0 + 8i against queries q0 + 8n + c0 + j; in dK
// and dV key rows r0 and r0 + 8.  Tile t of the block's T = G * per walks
// head kvh * G + t / per, query tile first + t % per.
template <int QP, int VP, int BQ>
__global__ void __launch_bounds__(kWgThreads)
    dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int S, int H, int KV,
                      int Dk, int Dv, float scale, int causal) {
  static_assert(BQ == 32 || BQ == 64, "query tiles of 32 or 64 rows");
  constexpr int kN = BQ / 2;                   // S^T registers a thread
  constexpr int kSteps = BQ / 16;              // k16 steps over a tile
  constexpr uint32_t kStagePanel = BQ * 128;   // bytes of a Q or dout panel
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sk = base;
  const uint32_t sv = sk + QP * kPanelBytes;
  const uint32_t sq = sv + VP * kPanelBytes;
  const uint32_t sdo = sq + kStages * QP * kStagePanel;
  const uint32_t sld = sdo + kStages * VP * kStagePanel;
  const uint32_t bars = sld + 2 * 2 * BQ * sizeof(float);
  const uint32_t kvbar = bars + 16 * kStages;
  // full[s] at bars + 8 s, empty[s] at bars + 8 (kStages + s)
  float* const ld_s = reinterpret_cast<float*>(smem_raw + (sld - raw));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kt = blockIdx.z;  // low key tiles have the most query tiles
  const int kvh = blockIdx.x, b = blockIdx.y, G = H / KV;
  const int k0 = kt * 64;
  const int first = causal ? k0 / BQ : 0;
  const int per = (S + BQ - 1) / BQ - first;   // query tiles of one head
  const int T = G * per;

  auto load_q = [&](int t, int st) {
    const int h = kvh * G + t / per, q0 = (first + t % per) * BQ;
    const uint32_t full = bars + 8 * st;
    mbar_expect_tx(full, (QP + VP) * kStagePanel);
#pragma unroll
    for (int p = 0; p < QP; ++p)
      tma_load(sq + (st * QP + p) * kStagePanel, &tq, full, p * 64, h, q0, b);
#pragma unroll
    for (int p = 0; p < VP; ++p)
      tma_load(sdo + (st * VP + p) * kStagePanel, &tdo, full, p * 64, h, q0,
               b);
  };
  // this thread's share of tile t's lse (times log2 e, tid < BQ) and delta
  // (BQ <= tid < 2 BQ); zero past S
  auto load_ld = [&](int t) -> float {
    const int h = kvh * G + t / per, q0 = (first + t % per) * BQ;
    const int q = q0 + (tid < BQ ? tid : tid - BQ);
    if (tid >= 2 * BQ || q >= S) return 0.f;
    const size_t at = ((size_t)b * H + h) * S + q;
    return tid < BQ ? lse[at] * kLog2e : delta[at];
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kStages + s), kWgThreads);
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(kvbar, (QP + VP) * kPanelBytes);
#pragma unroll
    for (int p = 0; p < QP; ++p)
      tma_load(sk + p * kPanelBytes, &tk, kvbar, p * 64, kvh, k0, b);
#pragma unroll
    for (int p = 0; p < VP; ++p)
      tma_load(sv + p * kPanelBytes, &tv, kvbar, p * 64, kvh, k0, b);
    for (int t = 0; t < kStages && t < T; ++t) load_q(t, t);
  }
  __syncwarp();

  const int r0 = warp * 16 + (lane >> 2);  // and r0 + 8
  const int c0 = (lane & 3) * 2;
  const float scale_log2 = scale * kLog2e;
  float dk_acc[QP][32], dv_acc[VP][32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
#pragma unroll
    for (int p = 0; p < QP; ++p) dk_acc[p][i] = 0.f;
#pragma unroll
    for (int p = 0; p < VP; ++p) dv_acc[p][i] = 0.f;
  }
  float ld_next = load_ld(0);
  mbar_wait(kvbar, 0);

  for (int t = 0; t < T; ++t) {
    const int st = t % kStages;
    const uint32_t phase = (t / kStages) & 1;
    const uint32_t full = bars + 8 * st, empty = bars + 8 * (kStages + st);
    const uint32_t sq_t = sq + st * QP * kStagePanel;
    const uint32_t sdo_t = sdo + st * VP * kStagePanel;
    const int q0 = (first + t % per) * BQ;
    // tile t's lse and delta into buffer t % 2 (its last readers, tile
    // t - 2, passed the barrier of tile t - 1); tile t + 1's loaded ahead
    float* const ld = ld_s + (t & 1) * 2 * BQ;
    if (tid < 2 * BQ) ld[tid] = ld_next;
    if (t + 1 < T) ld_next = load_ld(t + 1);
    __syncthreads();
    mbar_wait(full, phase);

    // S^T = K Q^T and dP^T = V dout^T, 64 keys x BQ queries
    float s[kN], dp[kN];
#pragma unroll
    for (int i = 0; i < kN; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4 * QP; ++ks)
      wgmma_ss<BQ>(
          s, smem_desc(sk + (ks >> 2) * kPanelBytes + (ks & 3) * 32, 16, 1024),
          smem_desc(sq_t + (ks >> 2) * kStagePanel + (ks & 3) * 32, 16, 1024),
          ks > 0);
#pragma unroll
    for (int ks = 0; ks < 4 * VP; ++ks)
      wgmma_ss<BQ>(
          dp,
          smem_desc(sv + (ks >> 2) * kPanelBytes + (ks & 3) * 32, 16, 1024),
          smem_desc(sdo_t + (ks >> 2) * kStagePanel + (ks & 3) * 32, 16, 1024),
          ks > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // P^T and dS^T in f32 (P^T into s, dS^T into dp); masked: keys or
    // queries at or past S and, causal, keys past the query
    const bool edge = (causal && q0 < k0 + 64) || q0 + BQ > S || k0 + 64 > S;
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int ql = 8 * n + c0 + j, key = k0 + r0 + 8 * i, q = q0 + ql;
          const int e = 4 * n + 2 * i + j;
          const bool live =
              !edge || (key < S && q < S && (!causal || key <= q));
          const float p = live ? exp2f(s[e] * scale_log2 - ld[ql]) : 0.f;
          dp[e] = p * (dp[e] - ld[BQ + ql]) * scale;
          s[e] = p;
        }
    uint32_t pa[kSteps][4], da[kSteps][4];
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
        da[kk][i] = pack_bf16(dp[8 * kk + 2 * i], dp[8 * kk + 2 * i + 1]);
      }

    // dV += P^T dout and dK += dS^T Q, dout and Q read MN-major: a k16
    // step is 16 queries, 2048 bytes of a panel
    fence_panels(dv_acc);
    fence_panels(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      mma_panels(dv_acc, pa[kk], sdo_t + kk * 2048, kStagePanel);
      mma_panels(dk_acc, da[kk], sq_t + kk * 2048, kStagePanel);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_panels(dv_acc);
    fence_panels(dk_acc);

    // hand the stage back; thread 0 refills it with tile t + kStages
    mbar_arrive(empty);
    if (tid == 0 && t + kStages < T) {
      mbar_wait(empty, phase);
      load_q(t + kStages, st);
    }
    __syncwarp();
  }

  store_rows(dk_acc, dk + ((size_t)b * S * KV + kvh) * Dk, (size_t)KV * Dk,
             k0, S, Dk, r0, c0);
  store_rows(dv_acc, dv + ((size_t)b * S * KV + kvh) * Dv, (size_t)KV * Dv,
             k0, S, Dv, r0, c0);
}

// In the S and dP accumulators (64 queries x 64 keys) thread (warp w, lane
// l) holds query rows q0 + r0 + 8i against keys k0 + 8n + c0 + j; in dQ
// rows r0 and r0 + 8.
template <int QP, int VP>
__global__ void __launch_bounds__(kWgThreads)
    dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int S, int H, int KV,
                    int Dk, float scale, int causal) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sq = base;
  const uint32_t sdo = sq + QP * kPanelBytes;
  const uint32_t sk = sdo + VP * kPanelBytes;
  const uint32_t sv = sk + kStages * QP * kPanelBytes;
  const uint32_t bars = sv + kStages * VP * kPanelBytes;
  const uint32_t qbar = bars + 16 * kStages;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_tiles = (S + 63) / 64;
  const int qt = causal ? n_tiles - 1 - (int)blockIdx.z : (int)blockIdx.z;
  const int h = blockIdx.x, b = blockIdx.y, kvh = h / (H / KV);
  const int q0 = qt * 64;
  const int last = causal ? qt : n_tiles - 1;

  auto load_kv = [&](int tile, int st) {
    const uint32_t full = bars + 8 * st;
    mbar_expect_tx(full, (QP + VP) * kPanelBytes);
#pragma unroll
    for (int p = 0; p < QP; ++p)
      tma_load(sk + (st * QP + p) * kPanelBytes, &tk, full, p * 64, kvh,
               tile * 64, b);
#pragma unroll
    for (int p = 0; p < VP; ++p)
      tma_load(sv + (st * VP + p) * kPanelBytes, &tv, full, p * 64, kvh,
               tile * 64, b);
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kStages + s), kWgThreads);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(qbar, (QP + VP) * kPanelBytes);
#pragma unroll
    for (int p = 0; p < QP; ++p)
      tma_load(sq + p * kPanelBytes, &tq, qbar, p * 64, h, q0, b);
#pragma unroll
    for (int p = 0; p < VP; ++p)
      tma_load(sdo + p * kPanelBytes, &tdo, qbar, p * 64, h, q0, b);
    for (int t = 0; t < kStages && t <= last; ++t) load_kv(t, t);
  }
  __syncwarp();

  const int r0 = warp * 16 + (lane >> 2);  // and r0 + 8
  const int c0 = (lane & 3) * 2;
  const float scale_log2 = scale * kLog2e;
  float L[2], Dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + 8 * i;
    const size_t at = ((size_t)b * H + h) * S + row;
    L[i] = row < S ? lse[at] * kLog2e : 0.f;
    Dl[i] = row < S ? delta[at] : 0.f;
  }
  float dq_acc[QP][32];
#pragma unroll
  for (int p = 0; p < QP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq_acc[p][i] = 0.f;
  mbar_wait(qbar, 0);

  for (int kt = 0; kt <= last; ++kt) {
    const int st = kt % kStages;
    const uint32_t phase = (kt / kStages) & 1;
    const uint32_t full = bars + 8 * st, empty = bars + 8 * (kStages + st);
    const uint32_t sk_t = sk + st * QP * kPanelBytes;
    const uint32_t sv_t = sv + st * VP * kPanelBytes;
    mbar_wait(full, phase);

    // S = Q K^T and dP = dout V^T, 64 queries x 64 keys
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4 * QP; ++ks) {
      const uint32_t off = (ks >> 2) * kPanelBytes + (ks & 3) * 32;
      wgmma_ss_n64(s, smem_desc(sq + off, 16, 1024),
                   smem_desc(sk_t + off, 16, 1024), ks > 0);
    }
#pragma unroll
    for (int ks = 0; ks < 4 * VP; ++ks) {
      const uint32_t off = (ks >> 2) * kPanelBytes + (ks & 3) * 32;
      wgmma_ss_n64(dp, smem_desc(sdo + off, 16, 1024),
                   smem_desc(sv_t + off, 16, 1024), ks > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // dS in f32 (into dp); masked: keys or rows at or past S and, on the
    // diagonal tile, keys past the row
    const int k0 = kt * 64;
    const bool edge = (causal && kt == qt) || k0 + 64 > S || q0 + 64 > S;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int key = k0 + 8 * n + c0 + j, row = q0 + r0 + 8 * i;
          const int e = 4 * n + 2 * i + j;
          const bool live =
              !edge || (key < S && row < S && (!causal || key <= row));
          const float p = live ? exp2f(s[e] * scale_log2 - L[i]) : 0.f;
          dp[e] = p * (dp[e] - Dl[i]) * scale;
        }
    uint32_t da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        da[kk][i] = pack_bf16(dp[8 * kk + 2 * i], dp[8 * kk + 2 * i + 1]);

    // dQ += dS K, K read MN-major: a k16 step is 16 keys, 2048 bytes
    fence_panels(dq_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_panels(dq_acc, da[kk], sk_t + kk * 2048, kPanelBytes);
    wgmma_commit();
    wgmma_wait_all();
    fence_panels(dq_acc);

    // hand the stage back; thread 0 refills it with tile kt + kStages
    mbar_arrive(empty);
    if (tid == 0 && kt + kStages <= last) {
      mbar_wait(empty, phase);
      load_kv(kt + kStages, st);
    }
    __syncwarp();
  }

  store_rows(dq_acc, dq + ((size_t)b * S * H + h) * Dk, (size_t)H * Dk, q0,
             S, Dk, r0, c0);
}

// Query tile of the dK/dV kernel: 32 rows at three Q/K panels (registers),
// else 64.
constexpr int bq_of(int QP) { return QP == 3 ? 32 : 64; }

template <int DK, int DV>
int launch_wgmma(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const float* lse, float* delta, void* dq,
                 void* dk, void* dv, int B, int S, int H, int KV, int causal,
                 float scale, cudaStream_t stream) {
  constexpr int QP = (DK + 63) / 64, VP = (DV + 63) / 64, BQ = bq_of(QP);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv, tdo, tq_t, tdo_t;  // *_t: boxes of BQ rows
  if (!tensor_map(encode, &tq, q, DK, H, S, B) ||
      !tensor_map(encode, &tk, k, DK, KV, S, B) ||
      !tensor_map(encode, &tv, v, DV, KV, S, B) ||
      !tensor_map(encode, &tdo, dout, DV, H, S, B) ||
      !tensor_map(encode, &tq_t, q, DK, H, S, B, BQ) ||
      !tensor_map(encode, &tdo_t, dout, DV, H, S, B, BQ))
    return (int)cudaErrorInvalidValue;
  const size_t smem_kv = dkdv_wgmma_smem_bytes(QP, VP, BQ);
  const size_t smem_q = dq_wgmma_smem_bytes(QP, VP);
  cudaError_t err = allow_smem(dkdv_wgmma_kernel<QP, VP, BQ>, smem_kv);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(dq_wgmma_kernel<QP, VP>, smem_q);
  if (err != cudaSuccess) return (int)err;
  err = launch_delta<__nv_bfloat16, DV>(o, dout, delta, B, S, H, stream);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (S + 63) / 64;
  dkdv_wgmma_kernel<QP, VP, BQ><<<dim3(KV, B, n_tiles), kWgThreads, smem_kv,
                                  stream>>>(
      tq_t, tk, tv, tdo_t, lse, delta, (__nv_bfloat16*)dk,
      (__nv_bfloat16*)dv, S, H, KV, DK, DV, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dq_wgmma_kernel<QP, VP><<<dim3(H, B, n_tiles), kWgThreads, smem_q,
                            stream>>>(tq, tk, tv, tdo, lse, delta,
                                      (__nv_bfloat16*)dq, S, H, KV, DK,
                                      scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 != 0: the tensors (all but lse and delta) are bf16, else f32.  Every
// pointer must be 16-byte aligned (the wrapper checks).  The head dims are
// those of the models the port trains: tinyllama 64/64, minicpm3's MLA
// 96/64, 128-wide heads (yi, minitron, kimi, jamba, pixtral),
// deepseek-v2-lite's MLA 192/128, and the reduced test configs' 16/16
// (GQA) and 24/16 (MLA).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int B, int S, int H, int KV, int Dk, int Dv, int causal,
    int bf16, float scale, void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV || H > 65535 || B > 65535 ||
      (S + kTile - 1) / kTile > 65535 || (long long)B * S * H >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define BWD_CASE(DK, DV)                                                   \
  if (Dk == DK && Dv == DV)                                                \
    return bf16 ? launch_wgmma<DK, DV>(q, k, v, o, dout, lse, delta, dq,   \
                                       dk, dv, B, S, H, KV, causal, scale, \
                                       st)                                 \
                : launch_fma<DK, DV>(q, k, v, o, dout, lse, delta, dq, dk, \
                                     dv, B, S, H, KV, causal, scale, st);
  BWD_CASE(64, 64)
  BWD_CASE(96, 64)
  BWD_CASE(128, 128)
  BWD_CASE(192, 128)
  BWD_CASE(16, 16)
  BWD_CASE(24, 16)
#undef BWD_CASE
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of the dK/dV (dq == 0) or dQ kernel of the bf16
// (bf16 != 0) or f32 body at (Dk, Dv), in bytes, or 0 for head dims without
// an instance.
extern "C" int flash_attention_bwd_smem_bytes(int Dk, int Dv, int dq,
                                              int bf16) {
#define SMEM_CASE(DK, DV)                                                   \
  if (Dk == DK && Dv == DV) {                                               \
    constexpr int QP = (DK + 63) / 64, VP = (DV + 63) / 64;                 \
    if (bf16)                                                               \
      return (int)(dq ? dq_wgmma_smem_bytes(QP, VP)                         \
                      : dkdv_wgmma_smem_bytes(QP, VP, bq_of(QP)));          \
    return (int)(sizeof(float) * (dq ? dq_fma_smem_floats<DK, DV>()         \
                                     : dkdv_fma_smem_floats<DK, DV>()));    \
  }
  SMEM_CASE(64, 64)
  SMEM_CASE(96, 64)
  SMEM_CASE(128, 128)
  SMEM_CASE(192, 128)
  SMEM_CASE(16, 16)
  SMEM_CASE(24, 16)
#undef SMEM_CASE
  return 0;
}
