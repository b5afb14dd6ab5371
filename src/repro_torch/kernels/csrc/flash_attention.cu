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
// What bounds it on the H100: at the serving shapes (S = 512, d = 128) the
// work is ~64 FLOPs per byte of q/k/v/o, far above the bf16 ridge point,
// so the tensor-core rate bounds it (989 TFLOP/s bf16).  This first kernel
// uses the FMA units (f32, 4x4 register blocks over shared-memory tiles,
// one 64-row q block and one 64-col kv block at a time); mma/wgmma
// operands and TMA staging are later work.
//
// Plain C interface, loaded with ctypes by kernels/attention.py.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // kv columns per step
constexpr int NT = 256;       // threads per block (16 x 16)
constexpr int MAX_D = 128;    // largest head dimension compiled
constexpr float NEG_INF = -1e30f;

enum { DT_F32 = 0, DT_BF16 = 2 };

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
  int pad;
};

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
cudaError_t launch(const FaParams& p, cudaStream_t s) {
  const int smem = smem_floats<DP>() * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      fa_fwd_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(p.B * p.H, (p.S + BQ - 1) / BQ);
  fa_fwd_kernel<DP><<<grid, NT, smem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Enqueue one launch on `stream`; returns cudaGetLastError() as an int,
// 0 on success.  Launches nothing when the output is empty.
int repro_flash_attention(const FaParams* hp, void* stream) {
  const FaParams& p = *hp;
  if (p.D < 1 || p.D > MAX_D || p.KV < 1 || p.H % p.KV != 0 ||
      (p.dtype != DT_F32 && p.dtype != DT_BF16) || (long long)p.S > 65535LL * BQ) {
    return (int)cudaErrorInvalidValue;
  }
  if (p.B <= 0 || p.H <= 0 || p.S <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (p.D <= 32) {
    e = launch<32>(p, s);
  } else if (p.D <= 64) {
    e = launch<64>(p, s);
  } else {
    e = launch<128>(p, s);
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
