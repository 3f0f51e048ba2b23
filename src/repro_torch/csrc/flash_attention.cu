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
// Dv may differ from Dk (MLA prefill: Dk 96, Dv 64; Dk 192, Dv 128).  Masked scores are the
// reference's -1e30 and the output is acc / max(l, 1e-30), rounded once to
// the storage type.  Any S >= 1.  Two bodies, chosen by dtype, with no
// fallback from one to the other:
//
// bf16: flash_wgmma_kernel, both products on the tensor cores.
//   What bounds it: with both products in bf16 at 989 TFLOP/s the prefill
//   shapes sit near the ridge: tinyllama (B 4, S 1024, H 32, KV 4, 64/64)
//   is bound by operations (17.2 GFLOP, 0.0174 ms; its 37.7 MB take
//   0.0113 ms at 3.35 TB/s), minicpm3 (B 2, S 1024, H 40, Dk 96, Dv 64) by
//   bytes (52.4 MB, 0.0157 ms; 13.4 GFLOP take 0.0136 ms).  What the design
//   does about it: one warpgroup (128 threads) per block owns 64 query rows
//   of one (head, batch); S = Q K^T is wgmma m64n64k16 with both operands
//   in shared memory, K-major; the softmax runs in registers on the f32
//   accumulators (row max and sum over the 4 threads of a row, exp2 with
//   log2(e) folded into the scale); the probabilities, rounded to bf16
//   pairwise, are already the register A fragments of O += P V, a wgmma
//   m64nNk16 whose B operand is the V tile read MN-major (transposed) from
//   shared memory.  Q, K and V arrive as bf16 through TMA (one tensor map
//   each, dims (D, heads, S, B), built per call on the host) into
//   128-byte-swizzled 64-column panels; thread 0 issues the copies into a
//   ring of two K/V stages handed over by full/empty mbarriers, so the next
//   tile's copy is in flight while the current tile's products run.  Head
//   dims are padded to whole panels by TMA's zero fill (Dk 96 -> 128, which
//   adds a third to q.k at minicpm3's shape; 16 and 24 -> 64); Dk 192 is
//   three panels, q.k then chains 12 k16 steps over them; the ragged
//   edge of S is zero-filled the same way, keys at or past S are scored
//   -1e30 and rows at or past S are not written.  Key tiles are 64 keys:
//   with 64-row query tiles the causal key loop stops exactly at the
//   diagonal tile, the only one masked, and the S accumulators stay at 32
//   registers a thread.  Causal query tiles run heaviest first across the
//   whole grid (the tile index is the slowest grid dimension).  p.v
//   multiplies probabilities rounded to bf16 (at most 2^-9 relative per
//   weight, as SDPA rounds them); l sums the f32 probabilities.  Not yet:
//   warp specialisation with setmaxnreg, softmax overlapped with the next
//   product, exact 96-wide panels, GQA heads packed into one block.
//
// f32: flash_kernel, f32 FMAs on the CUDA cores, so every product is exact
//   f32 arithmetic (the tensor cores' TF32 would round the operands); it is
//   bound by operations at the 67 TFLOP/s of f32 FMAs.  One block of
//   256 threads per (query tile of 64 rows, query head, batch) stages its Q
//   tile once, then walks 64-key tiles: K (transposed) and V staged in
//   shared memory with 16-byte loads, scores S = Q K^T * scale into shared
//   memory (4x4 per thread), an online-softmax update per row (one warp per
//   8 rows, expf), then acc = acc * corr + P V in registers (4 x (Dv/16)
//   per thread).  The key loop of a query tile stops at the diagonal tile;
//   causal query tiles run heaviest first.
//
// lse: with a non-null lse pointer (training: the saved input of the
//   backward, csrc/flash_attention_bwd.cu) both bodies also store each row's
//   f32 log-sum-exp of its scaled scores, m + log(max(l, 1e-30)), into lse
//   (B, H, S): the f32 body from shared memory after its key loop, the bf16
//   body from the one thread of a row's four that has lane % 4 == 0, in its
//   epilogue (its m is in the log2 domain, so it stores m ln 2 + log l).  A
//   template flag selects the storing instance, so with a null pointer the
//   kernels are the instances without it, instruction for instruction.  Only
//   the head dims the backward takes have the storing instance.
//
// The C entry point returns cudaGetLastError() as an int (0 = success), or
// cudaErrorInvalidValue for head dims it has no instance for (with lse, for
// head dims the backward does not take) and for tensor maps that
// cuTensorMapEncodeTiled refuses.

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32 body
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kTile = 64;           // query rows and keys per tile
constexpr int kLdS = kTile + 4;     // score row stride (float4 aligned)
constexpr float kNegInf = -1e30f;   // the reference's NEG_INF

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
template <int D>
__device__ void stage_transposed(const float* src, size_t stride, int row0,
                                 int n, float* dst) {
  constexpr int kVec = 4;
  constexpr int kPerRow = D / kVec;
  for (int e = threadIdx.x; e < kTile * kPerRow; e += kThreads) {
    const int r = e % kTile, c = (e / kTile) * kVec;
    float x[kVec];
    if (r < n) {
      const float4 t =
          *reinterpret_cast<const float4*>(src + (row0 + r) * stride + c);
      x[0] = t.x;
      x[1] = t.y;
      x[2] = t.z;
      x[3] = t.w;
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) x[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) dst[(c + i) * kTile + r] = x[i];
  }
}

// The same rows into dst[r * D + d] as f32, in row order (V tiles).
template <int D>
__device__ void stage_rows(const float* src, size_t stride, int row0, int n,
                           float* dst) {
  constexpr int kVec = 4;
  constexpr int kPerRow = D / kVec;
  for (int e = threadIdx.x; e < kTile * kPerRow; e += kThreads) {
    const int r = e / kPerRow, c = (e - r * kPerRow) * kVec;
    float x[kVec];
    if (r < n) {
      const float4 t =
          *reinterpret_cast<const float4*>(src + (row0 + r) * stride + c);
      x[0] = t.x;
      x[1] = t.y;
      x[2] = t.z;
      x[3] = t.w;
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
template <int DK, int DV, bool kLse>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int S, int H, int KV, float scale,
                 int causal) {
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

  stage_transposed<DK>(q + ((size_t)b * S * H + h) * DK, (size_t)H * DK,
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

  const float* kb = k + ((size_t)b * S * KV + kvh) * DK;
  const float* vb = v + ((size_t)b * S * KV + kvh) * DV;
  const int last = causal ? qt : n_tiles - 1;
  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * kTile, nk = min(kTile, S - k0);
    __syncthreads();  // the previous tile's reads of k_s, v_s, s_s
    stage_transposed<DK>(kb, (size_t)KV * DK, k0, nk, k_s);
    stage_rows<DV>(vb, (size_t)KV * DV, k0, nk, v_s);
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
    float* o = out + (((size_t)b * S + row) * H + h) * DV + tx * kW;
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
#pragma unroll
      for (int j = 0; j < kW; ++j)
        o[g * 16 * kW + j] = acc[i][g * kW + j] / l;
  }
  if constexpr (kLse) {
    if (tid < kTile && q0 + tid < S)
      lse[((size_t)b * H + h) * S + q0 + tid] =
          m_s[tid] + logf(fmaxf(l_s[tid], 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// bf16 body: wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 128;            // one consumer warpgroup
constexpr int kStages = 2;                 // K/V ring

// The accumulators' layout, and the score tile as the register A fragment
// of p.v, are described in csrc/hopper.cuh.
//
// Shared memory (from a 1024-byte-aligned base): Q panels, then kStages K
// stages of QP panels, kStages V stages of VP panels, then the mbarriers.
// A panel holds 64 rows (queries or keys) of 64 bf16 head-dim columns,
// 128 bytes a row, 128-byte swizzled by TMA.
template <int QP, int VP, bool kLse>
__global__ void __launch_bounds__(kWgThreads)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse, int S, int H, int KV, int Dv,
                       float scale_log2, int causal) {
  constexpr int kN = 32 * VP;  // O accumulator registers a thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t sq = base;
  const uint32_t sk = sq + QP * kPanelBytes;
  const uint32_t sv = sk + kStages * QP * kPanelBytes;
  const uint32_t bars = sv + kStages * VP * kPanelBytes;
  const uint32_t qbar = bars + 16 * kStages;
  // full[s] at bars + 8 s, empty[s] at bars + 8 (kStages + s)

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
    mbar_expect_tx(qbar, QP * kPanelBytes);
#pragma unroll
    for (int p = 0; p < QP; ++p)
      tma_load(sq + p * kPanelBytes, &tq, qbar, p * 64, h, q0, b);
    for (int t = 0; t < kStages && t <= last; ++t) load_kv(t, t);
  }
  __syncwarp();

  const int r0 = warp * 16 + (lane >> 2);  // and r0 + 8
  const int c0 = (lane & 3) * 2;
  float o[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  mbar_wait(qbar, 0);

  for (int kt = 0; kt <= last; ++kt) {
    const int st = kt % kStages;
    const uint32_t phase = (kt / kStages) & 1;
    const uint32_t full = bars + 8 * st, empty = bars + 8 * (kStages + st);
    mbar_wait(full, phase);

    // S = Q K^T over QP panels of 4 k16 steps each (32 bytes a step)
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4 * QP; ++ks) {
      const uint32_t off = (ks >> 2) * kPanelBytes + (ks & 3) * 32;
      wgmma_ss_n64(s, smem_desc(sq + off, 16, 1024),
                   smem_desc(sk + st * QP * kPanelBytes + off, 16, 1024),
                   ks > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // scale into the log2 domain; mask keys at or past S and, on the
    // diagonal tile, keys past the row
    const int k0 = kt * 64;
    const bool edge = (causal && kt == qt) || k0 + 64 > S;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int key = k0 + 8 * n + c0 + j, row = q0 + r0 + 8 * i;
          float& x = s[4 * n + 2 * i + j];
          x *= scale_log2;
          if (edge && (key >= S || (causal && key > row))) x = kNegInf;
        }

    // online softmax: each row's max over its 4 threads
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m[i];
#pragma unroll
      for (int n = 0; n < 8; ++n)
        mx = fmaxf(mx, fmaxf(s[4 * n + 2 * i], s[4 * n + 2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      corr[i] = exp2f(m[i] - mx);
      m[i] = mx;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float& x = s[4 * n + 2 * i + j];
          x = exp2f(x - mx);
          sum += x;
        }
      l[i] = l[i] * corr[i] + sum;  // this thread's share; reduced at the end
    }
#pragma unroll
    for (int n = 0; n < kN / 4; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        o[4 * n + 2 * i] *= corr[i];
        o[4 * n + 2 * i + 1] *= corr[i];
      }
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);

    // O += P V: 4 k16 steps of 16 keys (2048 bytes of a V panel each);
    // panels of 64 Dv columns 8192 bytes apart, 8-key groups 1024 apart
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv =
          smem_desc(sv + st * VP * kPanelBytes + kk * 2048, kPanelBytes, 1024);
      if constexpr (VP == 1)
        wgmma_rs_n64(o, pa[kk], dv, 1);
      else
        wgmma_rs_n128(o, pa[kk], dv, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);

    // hand the stage back; thread 0 refills it with tile kt + kStages
    mbar_arrive(empty);
    if (tid == 0 && kt + kStages <= last) {
      mbar_wait(empty, phase);
      load_kv(kt + kStages, st);
    }
    __syncwarp();
  }

  // epilogue: O / max(l, 1e-30) to bf16, staged through the (now idle) K
  // stages with the 16-byte chunks of a row XOR-swizzled by row, then
  // 16-byte stores of the rows below S and the columns below Dv
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
  }
  if constexpr (kLse) {
    // m is the row's max in the log2 domain, the same on its 4 threads
    if ((lane & 3) == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = q0 + r0 + 8 * i;
        if (row < S)
          lse[((size_t)b * H + h) * S + row] = m[i] * kLn2 + logf(l[i]);
      }
    }
  }
  __syncthreads();  // every wgmma read of the K stages is done
  uint8_t* const so = gbase + (sk - sq);
  constexpr int kRowBytes = VP * 128;
#pragma unroll
  for (int n = 0; n < kN / 4; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      *reinterpret_cast<uint32_t*>(so + r * kRowBytes +
                                   ((n ^ (r & 7)) << 4) + c0 * 2) =
          pack_bf16(o[4 * n + 2 * i] / l[i], o[4 * n + 2 * i + 1] / l[i]);
    }
  __syncthreads();
  const int chunks = Dv / 8;  // 16-byte chunks of an output row
  for (int e = tid; e < 64 * chunks; e += kWgThreads) {
    const int r = e / chunks, ch = e - r * chunks;
    if (q0 + r >= S) break;  // rows are in order: all further rows too
    const uint4 val = *reinterpret_cast<const uint4*>(
        so + r * kRowBytes + ((ch ^ (r & 7)) << 4));
    *reinterpret_cast<uint4*>(out + (((size_t)b * S + q0 + r) * H + h) * Dv +
                              ch * 8) = val;
  }
}

// dynamic shared memory of flash_wgmma_kernel<QP, VP>: slack to align the
// base to 1024 bytes, the Q panels, the K/V ring, the mbarriers
constexpr size_t wgmma_smem_bytes(int QP, int VP) {
  return 1024 + (QP + kStages * (QP + VP)) * kPanelBytes +
         8 * (2 * kStages + 1);
}

template <int QP, int VP, bool kLse>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 float* lse, int B, int S, int H, int KV, int Dk, int Dv,
                 int causal, float scale, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(encode, &tq, q, Dk, H, S, B) ||
      !tensor_map(encode, &tk, k, Dk, KV, S, B) ||
      !tensor_map(encode, &tv, v, Dv, KV, S, B))
    return (int)cudaErrorInvalidValue;
  const size_t smem = wgmma_smem_bytes(QP, VP);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<QP, VP, kLse>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, B, (S + 63) / 64);
  flash_wgmma_kernel<QP, VP, kLse><<<grid, kWgThreads, smem, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)out, lse, S, H, KV, Dv, scale * kLog2e,
      causal);
  return (int)cudaGetLastError();
}

template <int DK, int DV, bool kLse>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int S, int H, int KV, int causal, float scale,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<DK, DV>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<DK, DV, kLse>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  flash_kernel<DK, DV, kLse><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, lse, S,
      H, KV, scale, causal);
  return (int)cudaGetLastError();
}

// One head-dim pair: the body of the dtype, with the lse store when lse is
// non-null and the pair has that instance (kHasLse), else refused.
template <int DK, int DV, bool kHasLse>
int dispatch(const void* q, const void* k, const void* v, void* out,
             float* lse, int B, int S, int H, int KV, int causal, int bf16,
             float scale, cudaStream_t st) {
  constexpr int QP = (DK + 63) / 64, VP = (DV + 63) / 64;
  if (lse == nullptr)
    return bf16 ? launch_wgmma<QP, VP, false>(q, k, v, out, lse, B, S, H, KV,
                                              DK, DV, causal, scale, st)
                : launch<DK, DV, false>(q, k, v, out, lse, B, S, H, KV,
                                        causal, scale, st);
  if constexpr (kHasLse)
    return bf16 ? launch_wgmma<QP, VP, true>(q, k, v, out, lse, B, S, H, KV,
                                             DK, DV, causal, scale, st)
                : launch<DK, DV, true>(q, k, v, out, lse, B, S, H, KV,
                                       causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// bf16 != 0 selects the bf16 (tensor-core) body, else the f32 one.  Every
// pointer must be 16-byte aligned (the wrapper checks).  The head dims are
// the served models' (tinyllama 64/64, minicpm3's MLA prefill 96/64,
// deepseek-v2-lite's 192/128), 128-wide heads, and the reduced test
// configs' (16/16 GQA, 24/16 MLA).  lse (B, H, S) f32 or null; non-null
// only at the backward's head dims (16/16, 24/16, 64/64, 96/64, 128/128,
// 192/128).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, float* lse,
                                      int B, int S, int H, int KV, int Dk,
                                      int Dv, int causal, int bf16,
                                      float scale, void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV || H > 65535 || B > 65535 ||
      (S + 63) / 64 > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define FLASH_CASE(DK, DV, LSE)                                            \
  if (Dk == DK && Dv == DV)                                                \
    return dispatch<DK, DV, LSE>(q, k, v, out, lse, B, S, H, KV, causal,   \
                                 bf16, scale, st);
  FLASH_CASE(64, 64, true)
  FLASH_CASE(96, 64, true)
  FLASH_CASE(128, 128, true)
  FLASH_CASE(64, 128, false)
  FLASH_CASE(96, 128, false)
  FLASH_CASE(128, 64, false)
  FLASH_CASE(16, 16, true)
  FLASH_CASE(24, 16, true)
  FLASH_CASE(192, 128, true)
#undef FLASH_CASE
  return (int)cudaErrorInvalidValue;
}

// The bf16 kernel's dynamic shared memory for head dims (Dk, Dv), in bytes.
extern "C" int flash_attention_smem_bytes(int Dk, int Dv) {
  return (int)wgmma_smem_bytes((Dk + 63) / 64, (Dv + 63) / 64);
}
