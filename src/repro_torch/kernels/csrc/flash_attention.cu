// Flash attention forward on Hopper: o = softmax(q k^T / sqrt(d)) v.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (Pallas _fa_kernel, pallas_call in flash_attention()).  The TPU version
// walks the kv blocks as the innermost, sequential grid axis and carries
// the online-softmax state (m, l, acc) in VMEM scratch across grid steps.
// Blocks run in no order here, so each block owns one (batch*head, q-block)
// and walks its kv blocks in a loop, with m, l and the f32 accumulator in
// registers; the S x S score matrix never reaches device memory.
//
// Function (the Pallas kernel's):
//   * f32 scores q.k (products of f32 or bf16 operands summed in f32),
//     times scale = 1/sqrt(d);
//   * causal keeps col <= row (rows and cols counted from 0); kv blocks
//     wholly above the diagonal are skipped, the diagonal block is masked
//     elementwise; masked scores are -1e30;
//   * p = exp(s - m_new), l = l * alpha + sum(p) in f32, and p is rounded
//     to v's type before the product with v (f32 accumulation);
//   * o = acc / max(l, 1e-30), stored in q's type.
// Grouped-query attention is read in place: query head h reads kv head
// h / (H / KV), so K/V are never repeated in memory.  Ragged lengths are
// masked (rows >= S are not stored, cols >= Sk score -1e30), where the
// Pallas wrapper raises.
//
// What bounds it on the H100: at the qwen3-8b prefill shape (B 4, H 32,
// KV 8, S 512, D 128, bf16, causal) the causal triangle is 8.6 GFLOP over
// 41.9 MB of q/k/v/o, about 205 FLOPs per byte: under the bf16 ridge of
// about 295 (989 TFLOP/s over 3.35 TB/s), so the bytes bound it
// (12.5 us), not the tensor-core rate (8.7 us).  With GQA, q and o are
// most of those bytes.
//
// Two kernels, chosen by kernels/attention.py::choose_variant:
//
// * fa_mma_kernel (bf16 operands, D a multiple of 8, rows on 16-byte
//   boundaries): the products on the tensor cores, mma.sync.m16n8k16 with
//   bf16 operands and f32 accumulation.  Four warps, each owning 16 of the
//   block's 64 q rows; K/V tiles of 64 rows staged in shared memory as
//   bf16 in a two-stage ring filled by 16-byte cp.async copies, so the
//   next tile's copy overlaps the current tile's products.  Rows are
//   padded by 16 bytes so ldmatrix reads them without bank conflicts; D is
//   padded to a multiple of 16 with zeros (the mma depth).  Q's fragments
//   stay in registers for the whole walk; S = Q K^T lands in registers in
//   the mma's accumulator layout, which is also the A-operand layout of
//   P V, so P is rounded to bf16 in registers (the Pallas kernel's
//   p.astype(v.dtype)) and never touches shared memory.  Masks run only
//   on the diagonal tile and the ragged last tile, and the q blocks with
//   the longest causal walks are launched first.  mma.sync and not wgmma:
//   the kernel is bytes-bound and a warp-level product with cp.async
//   staging keeps the code small; wgmma with TMA is the next step.
// * fa_fwd_kernel (f32 operands, and bf16 layouts the 16-byte copies
//   cannot read): FMA units only, f32 tiles in shared memory, 4x4 register
//   blocks.  The tensor cores would round f32 operands to TF32, which the
//   f32 tier forbids.
//
// No atomics; every sum has a fixed order, so the result is deterministic.
//
// Plain C interface, loaded with ctypes by kernels/attention.py.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // kv columns per step
constexpr int NT = 256;       // threads per block of the FMA kernel (16 x 16)
constexpr int NT_MMA = 128;   // threads per block of the mma kernel (4 warps)
constexpr int MAX_D = 128;    // largest head dimension compiled
constexpr float NEG_INF = -1e30f;

enum { DT_F32 = 0, DT_BF16 = 2 };
enum { VAR_FMA = 0, VAR_MMA = 1 };

}  // namespace

struct FaParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long sq[4], sk[4], sv[4], so[4];   // element strides (b, h, s, d)
  int B, H, KV, S, SK, D;
  int causal, dtype;                      // dtype of q, k, v and o
  float scale;
  int variant;                            // VAR_FMA or VAR_MMA
};

// -- the FMA kernel (f32) ----------------------------------------------------

namespace {

__device__ __forceinline__ float ldf(const void* p, long long off, int dt) {
  if (dt == DT_BF16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[off]);
  }
  return static_cast<const float*>(p)[off];
}

__device__ __forceinline__ void stf(void* p, long long off, int dt, float x) {
  if (dt == DT_BF16) {
    static_cast<__nv_bfloat16*>(p)[off] = __float2bfloat16_rn(x);
  } else {
    static_cast<float*>(p)[off] = x;
  }
}

// x rounded to the storage type (the Pallas kernel's p.astype(v.dtype))
__device__ __forceinline__ float round_to(float x, int dt) {
  return dt == DT_BF16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// reduce over the 16 lanes that share one query row (lanes tx = 0..15)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off, 16));
  }
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off, 16);
  }
  return x;
}

template <int DP>
constexpr int smem_floats() {
  return BQ * (DP + 1) + BK * (DP + 1) + BK * DP + BQ * (BK + 1);
}

// Grid (batch*head, q-block).  Thread (ty, tx) = (tid / 16, tid % 16) owns
// query rows ty + 16 i (i < 4): score cols tx + 16 j (j < 4) of each kv
// step and output cols tx + 16 j (j < DP / 16).  DP is the head dimension
// padded to 32, 64 or 128 (pad lanes hold zeros).
template <int DP>
__global__ void __launch_bounds__(NT) fa_fwd_kernel(const FaParams p) {
  constexpr int QLD = DP + 1, KLD = DP + 1, PLD = BK + 1, JD = DP / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                 // [BQ][QLD]
  float* Ks = Qs + BQ * QLD;        // [BK][KLD]
  float* Vs = Ks + BK * KLD;        // [BK][DP]
  float* Ps = Vs + BK * DP;         // [BQ][PLD]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.KV);
  const int row0 = blockIdx.y * BQ;
  const long long qbase = (long long)b * p.sq[0] + (long long)h * p.sq[1];
  const long long kbase = (long long)b * p.sk[0] + (long long)kvh * p.sk[1];
  const long long vbase = (long long)b * p.sv[0] + (long long)kvh * p.sv[1];

  for (int e = tid; e < BQ * DP; e += NT) {
    const int r = e / DP, d = e % DP, s = row0 + r;
    Qs[r * QLD + d] = (s < p.S && d < p.D)
        ? ldf(p.q, qbase + (long long)s * p.sq[2] + (long long)d * p.sq[3],
              p.dtype)
        : 0.f;
  }

  float m[4], l[4], acc[4][JD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < JD; ++j) acc[i][j] = 0.f;
  }

  // causal: kv blocks starting past this q block's last row are skipped
  const int kv_end = p.causal ? min(p.SK, row0 + BQ) : p.SK;
  for (int col0 = 0; col0 < kv_end; col0 += BK) {
    __syncthreads();   // the previous step's readers of Ks/Vs/Ps are done
    for (int e = tid; e < BK * DP; e += NT) {
      const int c = e / DP, d = e % DP, s = col0 + c;
      const bool ok = s < p.SK && d < p.D;
      Ks[c * KLD + d] = ok ? ldf(p.k, kbase + (long long)s * p.sk[2]
                                 + (long long)d * p.sk[3], p.dtype) : 0.f;
      Vs[c * DP + d] = ok ? ldf(p.v, vbase + (long long)s * p.sv[2]
                                + (long long)d * p.sv[3], p.dtype) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    }
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float a[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * QLD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = Ks[(tx + 16 * j) * KLD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], kb[j], sc[i][j]);
      }
    }

    // online softmax, one row at a time (16 lanes share a row)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = col0 + tx + 16 * j;
        float x = sc[i][j] * p.scale;
        if (col >= p.SK || (p.causal && col > row)) x = NEG_INF;
        sc[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pv = expf(sc[i][j] - m_new);
        ps += pv;
        Ps[(ty + 16 * i) * PLD + tx + 16 * j] = round_to(pv, p.dtype);
      }
      l[i] = l[i] * alpha + row_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < JD; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * PLD + c];
#pragma unroll
      for (int j = 0; j < JD; ++j) {
        const float vv = Vs[c * DP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

  const long long obase = (long long)b * p.so[0] + (long long)h * p.so[1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= p.S) continue;
    const float inv_l = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < JD; ++j) {
      const int d = tx + 16 * j;
      if (d < p.D) {
        stf(p.o, obase + (long long)row * p.so[2] + (long long)d * p.so[3],
            p.dtype, acc[i][j] * inv_l);
      }
    }
  }
}

template <int DP>
cudaError_t launch_fma(const FaParams& p, cudaStream_t s) {
  const int smem = smem_floats<DP>() * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      fa_fwd_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(p.B * p.H, (p.S + BQ - 1) / BQ);
  fa_fwd_kernel<DP><<<grid, NT, smem, s>>>(p);
  return cudaGetLastError();
}


// -- the tensor-core kernel --------------------------------------------------

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; `bytes` < 16 fills the rest with zeros
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned& r0,
                                        unsigned& r1, unsigned& r2,
                                        unsigned& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned addr, unsigned& r0,
                                          unsigned& r1, unsigned& r2,
                                          unsigned& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col): bf16 operands, f32 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Stage rows s0 .. s0+63 of one head (row stride `ss` elements, unit column
// stride) into a [64][DP + 8] bf16 shared tile, 16 bytes a copy; rows past
// `slen` and columns past D are zeros.
template <int DP>
__device__ __forceinline__ void stage_rows(bf16* tile, const bf16* base,
                                           long long ss, int s0, int slen,
                                           int D, int tid) {
  constexpr int CH = DP / 8, LD = DP + 8;
#pragma unroll
  for (int i = 0; i < BK * CH / NT_MMA; ++i) {
    const int e = tid + i * NT_MMA, r = e / CH, c = e % CH, s = s0 + r;
    const bool ok = s < slen && c * 8 < D;
    cp_async16(smem_addr(tile + r * LD + c * 8),
               ok ? base + (long long)s * ss + c * 8 : base, ok ? 16 : 0);
  }
}

template <int DP>
constexpr int mma_smem_bytes() {
  return (BQ + 4 * BK) * (DP + 8) * (int)sizeof(bf16);   // Q, 2 x (K, V)
}

// Grid (batch*head, q-block).  Warp w owns q rows 16 w .. 16 w + 15 of the
// block; in the mma layouts lane l holds rows l / 4 and l / 4 + 8 of them
// and columns 2 (l % 4), +1 of every 8-column slice.  DP is the head
// dimension padded to a multiple of 16.
template <int DP>
__global__ void __launch_bounds__(NT_MMA) fa_mma_kernel(const FaParams p) {
  constexpr int LD = DP + 8;     // shared row stride, elements
  constexpr int KS = DP / 16;    // k steps of Q K^T
  constexpr int ND = DP / 8;     // 8-wide output column tiles
  constexpr int NS = BK / 8;     // 8-wide score column tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // [BQ][LD]
  bf16* Ks = Qs + BQ * LD;                        // [2][BK][LD]
  bf16* Vs = Ks + 2 * BK * LD;                    // [2][BK][LD]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int kvh = h / (p.H / p.KV);
  // the last q blocks have the longest causal walks: launch them first
  const int row0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const bf16* qp = static_cast<const bf16*>(p.q) + b * p.sq[0] + h * p.sq[1];
  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.sk[0] + kvh * p.sk[1];
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.sv[0] + kvh * p.sv[1];

  const int kv_end = p.causal ? min(p.SK, row0 + BQ) : p.SK;
  const int ntiles = (kv_end + BK - 1) / BK;

  stage_rows<DP>(Qs, qp, p.sq[2], row0, p.S, p.D, tid);
  stage_rows<DP>(Ks, kp, p.sk[2], 0, p.SK, p.D, tid);
  stage_rows<DP>(Vs, vp, p.sv[2], 0, p.SK, p.D, tid);
  cp_async_commit();

  unsigned qf[KS][4];
  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;   // rows g, g + 8
  const float scale2 = p.scale * 1.4426950408889634f;   // e^x = 2^(x log2 e)
  const int r_lo = row0 + warp * 16 + lane / 4, r_hi = r_lo + 8;

  for (int t = 0; t < ntiles; ++t) {
    const int st = t & 1;
    if (t + 1 < ntiles) {   // the next tile's copy overlaps this tile's math
      stage_rows<DP>(Ks + (st ^ 1) * BK * LD, kp, p.sk[2], (t + 1) * BK,
                     p.SK, p.D, tid);
      stage_rows<DP>(Vs + (st ^ 1) * BK * LD, vp, p.sv[2], (t + 1) * BK,
                     p.SK, p.D, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();      // all but the copy just issued have landed
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int r = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldsm_x4(smem_addr(Qs + r * LD + kk * 16 + (lane >> 4) * 8),
                qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3]);
      }
    }

    // S = Q K^T for this warp's 16 rows and the tile's 64 columns
    const bf16* Kt = Ks + st * BK * LD;
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        unsigned b0, b1, b2, b3;
        const int r = np * 16 + (lane & 7) + (lane >> 4) * 8;
        ldsm_x4(smem_addr(Kt + r * LD + kk * 16 + ((lane >> 3) & 1) * 8),
                b0, b1, b2, b3);
        mma_bf16(s[2 * np], qf[kk], b0, b1);
        mma_bf16(s[2 * np + 1], qf[kk], b2, b3);
      }
    }

    // online softmax in the log2 domain; masks only where a column can be
    // past Sk (the ragged last tile) or past a row (the diagonal tile)
    const int col0 = t * BK;
    const bool masked = col0 + BK > p.SK || (p.causal && col0 + BK - 1 > row0);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale2;
        if (masked) {
          const int col = col0 + j * 8 + (lane & 3) * 2 + (e & 1);
          const int row = e < 2 ? r_lo : r_hi;
          if (col >= p.SK || (p.causal && col > row)) x = NEG_INF;
        }
        s[j][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {   // the 4 lanes of a row
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float a0 = exp2f(m0 - mx0), a1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    // P, rounded to bf16 in registers: score tiles 2 kk and 2 kk + 1 are
    // the A fragment of k step kk of P V
    unsigned pf[NS / 2][4];
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float p0 = exp2f(s[j][0] - mx0), p1 = exp2f(s[j][1] - mx0);
      const float p2 = exp2f(s[j][2] - mx1), p3 = exp2f(s[j][3] - mx1);
      rs0 += p0 + p1;
      rs1 += p2 + p3;
      pf[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
      pf[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
    // l sums the unrounded p; each lane keeps its part until the end
    l0 = l0 * a0 + rs0;
    l1 = l1 * a1 + rs1;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      o[j][0] *= a0;
      o[j][1] *= a0;
      o[j][2] *= a1;
      o[j][3] *= a1;
    }

    // O += P V
    const bf16* Vt = Vs + st * BK * LD;
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) {
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        unsigned b0, b1, b2, b3;
        const int r = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldsm_x4_t(smem_addr(Vt + r * LD + dp * 16 + (lane >> 4) * 8),
                  b0, b1, b2, b3);
        mma_bf16(o[2 * dp], pf[kk], b0, b1);
        mma_bf16(o[2 * dp + 1], pf[kk], b2, b3);
      }
    }
    __syncthreads();   // this stage is refilled two tiles on
  }
  cp_async_wait<0>();

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  bf16* op = static_cast<bf16*>(p.o) + b * p.so[0] + h * p.so[1];
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    const int d = j * 8 + (lane & 3) * 2;
    if (d >= p.D) continue;
    if (r_lo < p.S) {
      *reinterpret_cast<__nv_bfloat162*>(op + (long long)r_lo * p.so[2] + d) =
          __floats2bfloat162_rn(o[j][0] * inv0, o[j][1] * inv0);
    }
    if (r_hi < p.S) {
      *reinterpret_cast<__nv_bfloat162*>(op + (long long)r_hi * p.so[2] + d) =
          __floats2bfloat162_rn(o[j][2] * inv1, o[j][3] * inv1);
    }
  }
}

template <int DP>
cudaError_t launch_mma(const FaParams& p, cudaStream_t s) {
  const int smem = mma_smem_bytes<DP>();
  cudaError_t e = cudaFuncSetAttribute(
      fa_mma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(p.B * p.H, (p.S + BQ - 1) / BQ);
  fa_mma_kernel<DP><<<grid, NT_MMA, smem, s>>>(p);
  return cudaGetLastError();
}

// the mma kernel's layout rule: unit column stride, every other stride a
// multiple of 8 elements and every base 16-byte aligned (16-byte copies
// and 4-byte stores), D a multiple of 8
bool mma_layout_ok(const FaParams& p) {
  const void* ptrs[4] = {p.q, p.k, p.v, p.o};
  const long long* strides[4] = {p.sq, p.sk, p.sv, p.so};
  if (p.dtype != DT_BF16 || p.D % 8 != 0) return false;
  for (int i = 0; i < 4; ++i) {
    if (reinterpret_cast<unsigned long long>(ptrs[i]) % 16 != 0 ||
        strides[i][3] != 1) {
      return false;
    }
    for (int a = 0; a < 3; ++a) {
      if (strides[i][a] % 8 != 0) return false;
    }
  }
  return true;
}

cudaError_t dispatch_mma(const FaParams& p, cudaStream_t s) {
  switch ((p.D + 15) / 16) {
    case 1: return launch_mma<16>(p, s);
    case 2: return launch_mma<32>(p, s);
    case 3: return launch_mma<48>(p, s);
    case 4: return launch_mma<64>(p, s);
    case 5: return launch_mma<80>(p, s);
    case 6: return launch_mma<96>(p, s);
    case 7: return launch_mma<112>(p, s);
    default: return launch_mma<128>(p, s);
  }
}

}  // namespace

extern "C" {

// Enqueue one launch of the chosen variant on `stream`; returns
// cudaGetLastError() as an int, 0 on success.  Launches nothing when the
// output is empty.
int repro_flash_attention(const FaParams* hp, void* stream) {
  const FaParams& p = *hp;
  if (p.D < 1 || p.D > MAX_D || p.KV < 1 || p.H % p.KV != 0 ||
      (p.dtype != DT_F32 && p.dtype != DT_BF16) ||
      (long long)p.S > 65535LL * BQ ||
      (p.variant != VAR_FMA && p.variant != VAR_MMA) ||
      (p.variant == VAR_MMA && !mma_layout_ok(p))) {
    return (int)cudaErrorInvalidValue;
  }
  if (p.B <= 0 || p.H <= 0 || p.S <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (p.variant == VAR_MMA) {
    e = dispatch_mma(p, s);
  } else if (p.D <= 32) {
    e = launch_fma<32>(p, s);
  } else if (p.D <= 64) {
    e = launch_fma<64>(p, s);
  } else {
    e = launch_fma<128>(p, s);
  }
  return (int)e;
}

const char* repro_fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Layout and limits, checked against the ctypes mirror at load time.
int repro_fa_params_size(void) { return (int)sizeof(FaParams); }

void repro_fa_config(int* out) {
  out[0] = BQ;
  out[1] = BK;
  out[2] = MAX_D;
}

}  // extern "C"
