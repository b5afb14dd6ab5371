// CMM's ADDMUL task on Hopper: out = epilogue(C + A @ B, extras...).
//
// One templated kernel serves the four TPU kernels of the JAX reference
// (src/repro/kernels/matmul.py and ops.py):
//   * addmul           (Pallas _addmul_kernel)      C present, no epilogue
//   * addmul_epilogue  (Pallas _addmul_epi_kernel)  C present, epilogue program
//   * addmul_batched   (jax.vmap over both)         the same kernel, G > 1
//   * matmul           (Pallas _mm_kernel)          no C: accumulator starts at 0
//
// Grid (output tile cols, output tile rows, group).  The TPU kernel's
// sequential k grid axis becomes a loop inside the block over shared-memory
// tiles of A and B.  The accumulator is seeded from C, each thread keeps a
// 4x4 register block of it, and every output element is stored once, after
// the fused elementwise epilogue has run on it in registers.
//
// Types: f32 and bf16 operands accumulate in f32 with plain FMA (no TF32,
// no tensor-core rounding of f32 operands); any f64 operand makes the whole
// product accumulate in f64.  The epilogue runs in f64 when the accumulator
// or any extra operand is f64, else in f32.  Integer products (int32 and
// int64 operands, no float among them) accumulate exactly in int64 and wrap
// around as NumPy's int64 does; they take no epilogue program, because
// NumPy types each instruction of one (an integer add stays an integer, a
// sin is f64), and the executors run it in the FUSED pass instead.
// Ragged edges are masked in the kernel; operands come with explicit
// (group, row, col) element strides, so transposed operands need no copy.
// No atomics and no split-k: the summation order depends on K alone, so a
// group member of a G > 1 launch is bitwise equal to the same tile
// launched alone.
//
// The epilogue is the FUSED tile program of core/fusion.py, passed as an
// instruction array (opcode, operand slots, scalar) that each thread
// interprets; one build serves every program.
//
// Plain C interface, loaded with ctypes by kernels/matmul.py.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <type_traits>

#define CMM_MAX_EXTRAS 16
#define CMM_MAX_PROG 64

namespace {

constexpr int BM = 64;        // output rows per block
constexpr int BN = 64;        // output cols per block
constexpr int BK = 16;        // k depth of one shared-memory stage
constexpr int NT = 256;       // threads per block (16 x 16)
constexpr int TM = BM / 16;   // output rows per thread
constexpr int TN = BN / 16;   // output cols per thread

enum { DT_F32 = 0, DT_F64 = 1, DT_BF16 = 2, DT_I32 = 3, DT_I64 = 4 };

enum {
  OP_IN = 0,
  OP_SIN, OP_COS, OP_EXP, OP_TANH, OP_ABS, OP_RELU, OP_SQRT, OP_SIGN,
  OP_S_ADD, OP_S_SUB, OP_S_RSUB, OP_S_MUL, OP_S_DIV, OP_S_RDIV,
  OP_ADD, OP_SUB, OP_EWMUL,
  OP_COUNT
};

}  // namespace

struct CmmOperand {
  const void* ptr;
  long long sg, sr, sc;       // element strides: group, row, col
  int dtype;
  int pad;
};

struct CmmInstr {
  int op, a, b, pad;          // opcode, operand slots
  double s;                   // scalar of the scale ops
};

struct CmmParams {
  int G, M, N, K;
  int has_c, n_extras, n_prog, acc_f64;
  int epi_f64, acc_int, pad1, pad2;
  CmmOperand A, B, C, O;
  CmmOperand E[CMM_MAX_EXTRAS];
  CmmInstr prog[CMM_MAX_PROG];
};

namespace {

template <typename T>
__device__ __forceinline__ T ld(const CmmOperand o, long long g, int r, int c) {
  const long long off = g * o.sg + (long long)r * o.sr + (long long)c * o.sc;
  if (o.dtype == DT_F64) return (T)static_cast<const double*>(o.ptr)[off];
  if (o.dtype == DT_F32) return (T)static_cast<const float*>(o.ptr)[off];
  if (o.dtype == DT_I64) return (T)static_cast<const long long*>(o.ptr)[off];
  if (o.dtype == DT_I32) return (T)static_cast<const int*>(o.ptr)[off];
  return (T)__bfloat162float(static_cast<const __nv_bfloat16*>(o.ptr)[off]);
}

template <typename T>
__device__ __forceinline__ void st(const CmmOperand o, long long g, int r, int c,
                                   T v) {
  const long long off = g * o.sg + (long long)r * o.sr + (long long)c * o.sc;
  void* p = const_cast<void*>(o.ptr);
  if (o.dtype == DT_F64) {
    static_cast<double*>(p)[off] = (double)v;
  } else if (o.dtype == DT_F32) {
    static_cast<float*>(p)[off] = (float)v;
  } else if (o.dtype == DT_I64) {
    static_cast<long long*>(p)[off] = (long long)v;
  } else if (o.dtype == DT_I32) {
    static_cast<int*>(p)[off] = (int)v;   // the low 32 bits, as NumPy wraps
  } else {
    static_cast<__nv_bfloat16*>(p)[off] = __float2bfloat16_rn((float)v);
  }
}

__device__ __forceinline__ float m_fma(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double m_fma(double a, double b, double c) { return fma(a, b, c); }
// int64 multiply-add modulo 2^64 (NumPy's wrap-around; unsigned: no UB)
__device__ __forceinline__ long long m_fma(long long a, long long b,
                                           long long c) {
  return (long long)((unsigned long long)a * (unsigned long long)b +
                     (unsigned long long)c);
}
__device__ __forceinline__ float m_sin(float x) { return sinf(x); }
__device__ __forceinline__ double m_sin(double x) { return sin(x); }
__device__ __forceinline__ float m_cos(float x) { return cosf(x); }
__device__ __forceinline__ double m_cos(double x) { return cos(x); }
__device__ __forceinline__ float m_exp(float x) { return expf(x); }
__device__ __forceinline__ double m_exp(double x) { return exp(x); }
__device__ __forceinline__ float m_tanh(float x) { return tanhf(x); }
__device__ __forceinline__ double m_tanh(double x) { return tanh(x); }
__device__ __forceinline__ float m_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double m_abs(double x) { return fabs(x); }
__device__ __forceinline__ float m_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double m_sqrt(double x) { return sqrt(x); }

// np.maximum(x, 0): NaN propagates (fmax would drop it)
template <typename T>
__device__ __forceinline__ T m_relu(T x) {
  return (x != x) ? x : (x > T(0) ? x : T(0));
}

// np.sign: sign(+-0) == 0, sign(NaN) is NaN
template <typename T>
__device__ __forceinline__ T m_sign(T x) {
  return x > T(0) ? T(1) : (x < T(0) ? T(-1) : (x == T(0) ? T(0) : x));
}

// The epilogue program at one output element; x0 is the accumulator.
// Integer products carry no program (cmm_addmul refuses one).
template <typename Epi>
__device__ __forceinline__ Epi run_epilogue(const CmmParams& p, long long g,
                                            int r, int c, Epi x0) {
  if constexpr (std::is_integral<Epi>::value) {
    return x0;
  } else {
    if (p.n_prog == 0) return x0;
    Epi vals[CMM_MAX_PROG];
    for (int t = 0; t < p.n_prog; ++t) {
      const int op = p.prog[t].op, sa = p.prog[t].a, sb = p.prog[t].b;
      const Epi s = (Epi)p.prog[t].s;
      Epi y;
      if (op == OP_IN) {
        y = sa == 0 ? x0 : ld<Epi>(p.E[sa - 1], g, r, c);
      } else {
        const Epi x = vals[sa];
        switch (op) {
          case OP_SIN: y = m_sin(x); break;
          case OP_COS: y = m_cos(x); break;
          case OP_EXP: y = m_exp(x); break;
          case OP_TANH: y = m_tanh(x); break;
          case OP_ABS: y = m_abs(x); break;
          case OP_RELU: y = m_relu(x); break;
          case OP_SQRT: y = m_sqrt(x); break;
          case OP_SIGN: y = m_sign(x); break;
          case OP_S_ADD: y = x + s; break;
          case OP_S_SUB: y = x - s; break;
          case OP_S_RSUB: y = s - x; break;
          case OP_S_MUL: y = x * s; break;
          case OP_S_DIV: y = x / s; break;
          case OP_S_RDIV: y = s / x; break;
          case OP_ADD: y = x + vals[sb]; break;
          case OP_SUB: y = x - vals[sb]; break;
          default: y = x * vals[sb]; break;   // OP_EWMUL
        }
      }
      vals[t] = y;
    }
    return vals[p.n_prog - 1];
  }
}

template <typename Acc, typename Epi>
__global__ void __launch_bounds__(NT)
cmm_addmul_kernel(const CmmParams p, int g0) {
  __shared__ Acc As[BK][BM + 1];   // A stage, k-major (+1: no bank conflicts)
  __shared__ Acc Bs[BK][BN + 1];   // B stage

  const int tid = threadIdx.x;
  const int tx = tid % 16;         // this thread's cols: col0 + tx + 16 j
  const int ty = tid / 16;         // this thread's rows: row0 + ty + 16 i
  const long long g = (long long)g0 + blockIdx.z;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int M = p.M, N = p.N, K = p.K;

  Acc acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int r = row0 + ty + 16 * i;
      const int c = col0 + tx + 16 * j;
      acc[i][j] = (p.has_c && r < M && c < N) ? ld<Acc>(p.C, g, r, c) : Acc(0);
    }
  }

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int q = 0; q < (BM * BK) / NT; ++q) {
      const int e = tid + NT * q;
      const int m = e / BK, kk = e % BK;
      const int r = row0 + m, k = k0 + kk;
      As[kk][m] = (r < M && k < K) ? ld<Acc>(p.A, g, r, k) : Acc(0);
    }
#pragma unroll
    for (int q = 0; q < (BK * BN) / NT; ++q) {
      const int e = tid + NT * q;
      const int kk = e / BN, n = e % BN;
      const int k = k0 + kk, c = col0 + n;
      Bs[kk][n] = (k < K && c < N) ? ld<Acc>(p.B, g, k, c) : Acc(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      Acc a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = m_fma(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int r = row0 + ty + 16 * i;
      const int c = col0 + tx + 16 * j;
      if (r >= M || c >= N) continue;
      st<Epi>(p.O, g, r, c, run_epilogue<Epi>(p, g, r, c, (Epi)acc[i][j]));
    }
  }
}

}  // namespace

extern "C" {

// Enqueue one launch (chunked over grid.z) on `stream`; returns
// cudaGetLastError() as an int, 0 on success.  Launches nothing when the
// output is empty.
int cmm_addmul(const CmmParams* hp, void* stream) {
  const CmmParams& p = *hp;
  if (p.n_prog < 0 || p.n_prog > CMM_MAX_PROG || p.n_extras < 0 ||
      p.n_extras > CMM_MAX_EXTRAS || (p.acc_int && p.n_prog > 0)) {
    return (int)cudaErrorInvalidValue;
  }
  for (int t = 0; t < p.n_prog; ++t) {
    const CmmInstr& in = p.prog[t];
    const bool slot_ok = in.op == OP_IN ? (in.a >= 0 && in.a <= p.n_extras)
                                        : (in.a >= 0 && in.a < t);
    const bool binary = in.op == OP_ADD || in.op == OP_SUB || in.op == OP_EWMUL;
    if (in.op < 0 || in.op >= OP_COUNT || !slot_ok ||
        (binary && (in.b < 0 || in.b >= t))) {
      return (int)cudaErrorInvalidValue;
    }
  }
  if (p.G <= 0 || p.M <= 0 || p.N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(NT);
  for (long long g0 = 0; g0 < p.G; g0 += 65535) {
    const long long left = p.G - g0;
    const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM,
                    (unsigned)(left < 65535 ? left : 65535));
    if (p.acc_int) {
      cmm_addmul_kernel<long long, long long>
          <<<grid, block, 0, s>>>(p, (int)g0);
    } else if (p.acc_f64) {
      cmm_addmul_kernel<double, double><<<grid, block, 0, s>>>(p, (int)g0);
    } else if (p.epi_f64) {
      cmm_addmul_kernel<float, double><<<grid, block, 0, s>>>(p, (int)g0);
    } else {
      cmm_addmul_kernel<float, float><<<grid, block, 0, s>>>(p, (int)g0);
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

const char* cmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Layout and limits, checked against the ctypes mirror at load time.
int cmm_params_size(void) { return (int)sizeof(CmmParams); }

void cmm_config(int* out) {
  out[0] = CMM_MAX_EXTRAS;
  out[1] = CMM_MAX_PROG;
  out[2] = BM;
  out[3] = BN;
  out[4] = BK;
}

}  // extern "C"
