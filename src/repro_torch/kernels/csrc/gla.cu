// Chunkwise gated linear attention (mLSTM) forward on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/gla.py (Pallas _gla_kernel,
// pallas_call in gla()).  For each (batch, head) the sequence is walked in
// chunks of C steps; with F_i the in-chunk cumulative log decay and
// T = F_{C-1}:
//   y_i   = (q_i e^{F_i}) S + sum_{j<=i} (q_i . k_j) e^{F_i - F_j} v_j
//   n_i   = (q_i e^{F_i}) . n + sum_{j<=i} (q_i . k_j) e^{F_i - F_j}
//   S    <- e^T S + sum_j (k_j e^{T - F_j})^T v_j,   n <- e^T n + sum_j k_j e^{T - F_j}
// and, with normalize, y_i / max(|n_i|, 1).  All state math is f32; the
// exponent above the diagonal is masked to -1e30 before exp (as the
// reference's _tril_decay), so nothing overflows there.
//
// The TPU kernel keeps the whole f32 state (dk x dv) in VMEM across the
// sequential chunk axis.  At xlstm-1.3b's width (dk = dv = 1024) that is
// 4 MiB per (b, h), more than any SM's shared memory (227 KB), so the
// state is split along dv: each block of gla_state_kernel owns one
// (b, h, 32-column dv tile), walks the chunks in order, and holds its
// S[:, tile] (dk x 32 f32, 128 KB at dk = 1024) in shared memory for the
// whole walk, looping over dk in 32-wide slices.  What does not depend on
// dv is computed once per chunk, not per tile: gla_scores_kernel stages
// the masked, decayed C x C scores (and F and their row sums) in a scratch
// buffer, fully parallel over chunks, before the walk.  The normaliser n
// (dk floats) is recomputed by every tile of a (b, h): it costs 2 C dk
// FLOPs a chunk against the tile's 4 C dk 32.  No atomics and no split
// reductions: every sum has one fixed order, so results are deterministic.
//
// What bounds it on the H100: the two C x dk x dv products per chunk
// (~512 MFLOP per chunk of one (b, h) at xlstm-1.3b's width) on f32
// operands, so the FP32 rate; this first kernel runs them on the FMA units
// with 4x4 register blocks over shared-memory slices.
//
// One C call (repro_gla) enqueues both kernels.  Plain C interface, loaded
// with ctypes by kernels/gla.py.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int CMAX = 128;     // largest chunk
constexpr int KS = 32;        // dk (and, for the scores, j) slice width
constexpr int TV = 32;        // dv columns per block of the walk
constexpr int RB = 32;        // score rows per block of gla_scores_kernel
constexpr int NT = 256;       // threads per block
constexpr int SMEM_LIMIT = 232448;
constexpr float NEG_INF = -1e30f;

enum { DT_F32 = 0, DT_BF16 = 2 };

}  // namespace

struct GlaParams {
  const void* q;
  const void* k;
  const void* v;
  const float* la;              // log decay, f32
  void* y;
  float* state;                 // (B, H, DK, DV) contiguous
  float* norm;                  // (B, H, DK) contiguous
  float* P;                     // scratch (B*H, nc, C, C): decayed scores
  float* F;                     // scratch (B*H, nc, C): cumulative log decay
  float* nin;                   // scratch (B*H, nc, C): row sums of P
  long long sq[4], sk[4], sv[4], sy[4];   // element strides (b, s, h, d)
  long long sla[3];                       // (b, s, h)
  int B, S, H, DK, DV, C;
  int normalize, dtype;         // dtype of q, k, v and y
};

namespace {

__device__ __forceinline__ float ldf(const void* p, long long off, int dt) {
  if (dt == DT_BF16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[off]);
  }
  return static_cast<const float*>(p)[off];
}

__device__ __forceinline__ long long at(const long long* st, int b,
                                        long long s, int h, int d) {
  return (long long)b * st[0] + s * st[1] + (long long)h * st[2] +
         (long long)d * st[3];
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

int state_smem_bytes(int dk) {
  const int floats = dk * TV + dk + 3 * CMAX * (KS + 1) + CMAX * TV + 2 * CMAX;
  return floats * (int)sizeof(float);
}

// Grid (b*h, chunk, row block).  P[i][j] = (q_i . k_j) e^{F_i - F_j} for
// j <= i, else 0; nin[i] = sum_j P[i][j].  Thread (ty, tx) = (tid / 32,
// tid % 32) owns rows ty + 8 r (r < 4) of the row block, cols tx + 32 c.
__global__ void __launch_bounds__(NT) gla_scores_kernel(const GlaParams p) {
  __shared__ float Fs[CMAX];
  __shared__ float qs[RB][KS + 1];
  __shared__ float ks[CMAX][KS + 1];
  const int bh = blockIdx.x, ci = blockIdx.y, i0 = blockIdx.z * RB;
  const int b = bh / p.H, h = bh % p.H;
  const int C = p.C, nc = p.S / C;
  const long long s0 = (long long)ci * C;
  const long long base = ((long long)bh * nc + ci) * C;
  const int tid = threadIdx.x, tx = tid % 32, ty = tid / 32;

  if (tid == 0) {             // in-chunk cumulative sum, in sequence order
    float f = 0.f;
    for (int i = 0; i < C; ++i) {
      f += p.la[(long long)b * p.sla[0] + (s0 + i) * p.sla[1] +
                (long long)h * p.sla[2]];
      Fs[i] = f;
    }
  }
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  }
  for (int k0 = 0; k0 < p.DK; k0 += KS) {
    __syncthreads();
    for (int e = tid; e < RB * KS; e += NT) {
      const int r = e / KS, kk = e % KS, i = i0 + r;
      qs[r][kk] = (i < C && k0 + kk < p.DK)
          ? ldf(p.q, at(p.sq, b, s0 + i, h, k0 + kk), p.dtype) : 0.f;
    }
    for (int e = tid; e < CMAX * KS; e += NT) {
      const int j = e / KS, kk = e % KS;
      ks[j][kk] = (j < C && k0 + kk < p.DK)
          ? ldf(p.k, at(p.sk, b, s0 + j, h, k0 + kk), p.dtype) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < KS; ++kk) {
      float a[4], kb[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = qs[ty + 8 * r][kk];
#pragma unroll
      for (int c = 0; c < 4; ++c) kb[c] = ks[tx + 32 * c][kk];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], kb[c], acc[r][c]);
      }
    }
  }
  __syncthreads();            // Fs is visible even when DK == 0

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 8 * r;          // one row per warp: no divergence
    if (i >= C) continue;
    float rs = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = tx + 32 * c;
      if (j < C) {
        const float d = j <= i ? Fs[i] - Fs[j] : NEG_INF;
        const float pv = acc[r][c] * expf(d);
        p.P[(base + i) * C + j] = pv;
        rs += pv;
      }
    }
    rs = warp_sum(rs);
    if (tx == 0) p.nin[base + i] = rs;
  }
  if (blockIdx.z == 0) {
    for (int i = tid; i < C; i += NT) p.F[base + i] = Fs[i];
  }
}

// Grid (b*h, dv tile).  The chunk walk of one (b, h) over dv columns
// c0 .. c0 + TV.  Thread (ty, tx) = (tid / 8, tid % 8) owns output rows
// ty + 32 r (r < 4) and tile cols tx + 8 c (c < 4).
__global__ void __launch_bounds__(NT) gla_state_kernel(const GlaParams p) {
  constexpr int LD = KS + 1;
  extern __shared__ float sm[];
  const int DK = p.DK, C = p.C, nc = p.S / C;
  float* St = sm;                   // [DK][TV]  this tile of the state
  float* ns = St + DK * TV;         // [DK]      the normaliser
  float* qs = ns + DK;              // [CMAX][LD] q e^{F_i}, one dk slice
  float* ks = qs + CMAX * LD;       // [CMAX][LD] k e^{T - F_j}, one dk slice
  float* ps = ks + CMAX * LD;       // [CMAX][LD] P, one j slice
  float* vs = ps + CMAX * LD;       // [CMAX][TV] v, this tile
  float* Fs = vs + CMAX * TV;       // [CMAX]
  float* nrow = Fs + CMAX;          // [CMAX]    n_i . q_i of the chunk

  const int bh = blockIdx.x, c0 = blockIdx.y * TV;
  const int b = bh / p.H, h = bh % p.H;
  const int tid = threadIdx.x, tx = tid % 8, ty = tid / 8;

  for (int e = tid; e < DK * TV; e += NT) St[e] = 0.f;
  for (int e = tid; e < DK; e += NT) ns[e] = 0.f;

  for (int ci = 0; ci < nc; ++ci) {
    const long long s0 = (long long)ci * C;
    const long long base = ((long long)bh * nc + ci) * C;
    __syncthreads();            // the previous chunk is done with vs, nrow
    for (int i = tid; i < CMAX; i += NT) Fs[i] = i < C ? p.F[base + i] : 0.f;
    for (int e = tid; e < CMAX * TV; e += NT) {
      const int j = e / TV, c = e % TV;
      vs[e] = (j < C && c0 + c < p.DV)
          ? ldf(p.v, at(p.sv, b, s0 + j, h, c0 + c), p.dtype) : 0.f;
    }
    __syncthreads();
    const float total = Fs[C - 1];
    const float et = expf(total);

    float yi[4][4], ya[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) yi[r][c] = ya[r][c] = 0.f;
    }
    float nq = 0.f;             // thread i < C: (q_i e^{F_i}) . n_prev

    for (int k0 = 0; k0 < DK; k0 += KS) {
      const int kn = min(KS, DK - k0);
      for (int e = tid; e < CMAX * KS; e += NT) {
        const int i = e / KS, kk = e % KS;
        const bool ok = i < C && kk < kn;
        qs[i * LD + kk] = ok ? ldf(p.q, at(p.sq, b, s0 + i, h, k0 + kk),
                                   p.dtype) * expf(Fs[i]) : 0.f;
        ks[i * LD + kk] = ok ? ldf(p.k, at(p.sk, b, s0 + i, h, k0 + kk),
                                   p.dtype) * expf(total - Fs[i]) : 0.f;
      }
      __syncthreads();
      // inter-chunk: y += (q e^F) S_prev over this dk slice
      for (int kk = 0; kk < kn; ++kk) {
        float a[4], st[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = qs[(ty + 32 * r) * LD + kk];
#pragma unroll
        for (int c = 0; c < 4; ++c) st[c] = St[(k0 + kk) * TV + tx + 8 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int c = 0; c < 4; ++c) yi[r][c] = fmaf(a[r], st[c], yi[r][c]);
        }
      }
      if (tid < C) {
        for (int kk = 0; kk < kn; ++kk) nq = fmaf(qs[tid * LD + kk], ns[k0 + kk], nq);
      }
      __syncthreads();          // S_prev and n_prev of this slice are read
      // state update of this slice: row kk = tid / 8, cols tx + 8 c
      {
        const int kk = tid / 8;
        if (kk < kn) {
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
          for (int j = 0; j < C; ++j) {
            const float kt = ks[j * LD + kk];
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[c] = fmaf(kt, vs[j * TV + tx + 8 * c], acc[c]);
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float* s = &St[(k0 + kk) * TV + tx + 8 * c];
            *s = et * *s + acc[c];
          }
        }
      }
      if (tid < kn) {
        float acc = 0.f;
        for (int j = 0; j < C; ++j) acc += ks[j * LD + tid];
        ns[k0 + tid] = et * ns[k0 + tid] + acc;
      }
      __syncthreads();          // before the next slice overwrites qs, ks
    }

    // intra-chunk: y += P v, P staged by gla_scores_kernel
    for (int j0 = 0; j0 < C; j0 += KS) {
      const int jn = min(KS, C - j0);
      for (int e = tid; e < CMAX * KS; e += NT) {
        const int i = e / KS, jj = e % KS;
        ps[i * LD + jj] = (i < C && jj < jn) ? p.P[(base + i) * C + j0 + jj] : 0.f;
      }
      __syncthreads();
      for (int jj = 0; jj < jn; ++jj) {
        float a[4], vv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = ps[(ty + 32 * r) * LD + jj];
#pragma unroll
        for (int c = 0; c < 4; ++c) vv[c] = vs[(j0 + jj) * TV + tx + 8 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int c = 0; c < 4; ++c) ya[r][c] = fmaf(a[r], vv[c], ya[r][c]);
        }
      }
      __syncthreads();
    }
    if (tid < C) nrow[tid] = nq + p.nin[base + tid];
    __syncthreads();

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ty + 32 * r;
      if (i >= C) continue;
      const float inv = p.normalize ? 1.f / fmaxf(fabsf(nrow[i]), 1.f) : 1.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = c0 + tx + 8 * c;
        if (col >= p.DV) continue;
        const float y = p.normalize ? (yi[r][c] + ya[r][c]) * inv
                                    : yi[r][c] + ya[r][c];
        const long long off = at(p.sy, b, s0 + i, h, col);
        if (p.dtype == DT_BF16) {
          static_cast<__nv_bfloat16*>(p.y)[off] = __float2bfloat16_rn(y);
        } else {
          static_cast<float*>(p.y)[off] = y;
        }
      }
    }
  }

  __syncthreads();
  for (int e = tid; e < DK * TV; e += NT) {
    const int kk = e / TV, c = e % TV;
    if (c0 + c < p.DV) {
      p.state[((long long)bh * DK + kk) * p.DV + c0 + c] = St[e];
    }
  }
  if (blockIdx.y == 0) {
    for (int e = tid; e < DK; e += NT) p.norm[(long long)bh * DK + e] = ns[e];
  }
}

}  // namespace

extern "C" {

// Enqueue the score pass and the chunk walk on `stream`; returns
// cudaGetLastError() as an int, 0 on success.  Launches nothing when the
// output is empty.
int repro_gla(const GlaParams* hp, void* stream) {
  const GlaParams& p = *hp;
  if (p.C < 1 || p.C > CMAX || p.S % p.C != 0 || p.DK < 1 || p.DV < 1 ||
      (p.dtype != DT_F32 && p.dtype != DT_BF16) ||
      state_smem_bytes(p.DK) > SMEM_LIMIT || p.S / p.C > 65535 ||
      (p.DV + TV - 1) / TV > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (p.B <= 0 || p.H <= 0 || p.S <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nc = p.S / p.C;
  gla_scores_kernel<<<dim3(p.B * p.H, nc, (p.C + RB - 1) / RB), NT, 0, s>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int smem = state_smem_bytes(p.DK);
  e = cudaFuncSetAttribute(gla_state_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  gla_state_kernel<<<dim3(p.B * p.H, (p.DV + TV - 1) / TV), NT, smem, s>>>(p);
  return (int)cudaGetLastError();
}

const char* repro_gla_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Layout and limits, checked against the ctypes mirror at load time.
int repro_gla_params_size(void) { return (int)sizeof(GlaParams); }

// CMAX, TV, and the largest dk whose state tile fits in shared memory
void repro_gla_config(int* out) {
  out[0] = CMAX;
  out[1] = TV;
  int dk = 1;
  while (state_smem_bytes(dk + 1) <= SMEM_LIMIT) ++dk;
  out[2] = dk;
}

}  // extern "C"
