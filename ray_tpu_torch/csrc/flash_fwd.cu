// Flash attention forward for Hopper (sm_90a), with a per-sequence query
// offset so that one kernel serves both plain causal attention and the
// KV-cache attention of prefill and decode.
//
// Replaces ray_tpu/ops/attention.py:_flash_fwd_kernel (driven by
// _flash_fwd). At q_offset = 0 it computes that kernel's function: tiled
// online-softmax attention, causal with a top-left mask or not, GQA, a
// ragged last key tile masked with its V rows zeroed, and the per-row
// logsumexp. With q_offset[b] = start position it computes
// ray_tpu/models/llama.py:_cached_attention as well: row i of sequence b
// sees key j iff j <= q_offset[b] + i (causal), or j < Sk (non-causal).
//
// Arithmetic follows the TPU kernel: sm_scale is folded into q in the
// storage dtype, scores and the running (m, l, acc) state are f32, p is
// rounded to the storage dtype before the PV product, and
// o = acc / max(l, 1e-30), lse = m + log(l).
//
// What bounds it on the H100: at the serving shapes, memory bytes
// (decode reads the whole visible KV cache for one query row per head)
// and, for long prefills, arithmetic. This version runs its products as
// f32 FMAs out of shared memory, not on the tensor cores, so a long
// prefill is bound by shared-memory loads and a decode by latency. Its
// design: one block of 256 threads per (batch, q head, q tile), with a
// 64-row tile (4 threads per row) for prefill and an 8-row tile (one
// warp per row) when Sq <= 8, so a decode row's work is spread over a
// warp instead of 4 threads; 64-key K/V tiles read with 16-byte loads,
// the next tile's loads issued into registers before the current tile's
// arithmetic so device-memory latency overlaps compute; shared-memory
// rows padded by one float so column reads are free of bank conflicts;
// row max and sum reduced by warp shuffles; the key loop ends at the last
// tile any row of the block can see, read from q_offset on the device
// (no host sync); rows past Sq, and rows that see no key of a tile, skip
// its arithmetic. Tensor-core products (mma/wgmma), TMA loads and warp
// specialisation are later work.
//
// Plain C interface, bound with ctypes (ray_tpu_torch/ops/attention.py).
// The launch goes on the caller's stream and allocates nothing; the
// function returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// Round an f32 value to the storage dtype and back.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

struct Params {
  const void* q;  // [B, Sq, H, D]
  const void* k;  // [B, Sk, Hkv, D]
  const void* v;  // [B, Sk, Hkv, D]
  void* o;        // [B, Sq, H, D]
  float* lse;     // [B, H, Sq], contiguous
  const int* q_offset;  // [B] or null (all zero)
  int64_t sq, sk, h, h_kv;
  // Element strides; the last dim is contiguous and every row start is
  // 16-byte aligned (the Python wrapper checks).
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  float sm_scale;
  int causal;
};

template <int D, int BQ>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1));
}

template <typename T, int D, int BQ>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(Params p) {
  constexpr int TPR = THREADS / BQ;  // threads per q row
  constexpr int NC = BK / TPR;       // score columns per thread
  constexpr int ND = D / TPR;        // output columns per thread
  constexpr int DP = D + 1;
  constexpr int VEC = 16 / sizeof(T);          // elements per 16 bytes
  constexpr int NV = BK * D / VEC;             // 16-byte vectors per tile
  constexpr int NPER = (NV + THREADS - 1) / THREADS;
  static_assert(NC >= 1 && ND >= 1 && TPR <= 32, "tile shape");
  static_assert(D % VEC == 0, "head_dim must fill 16-byte vectors");

  extern __shared__ float smem[];
  float* qs = smem;            // [BQ][DP] scaled q tile
  float* ks = qs + BQ * DP;    // [BK][DP]
  float* vs = ks + BK * DP;    // [BK][DP]
  float* ps = vs + BK * DP;    // [BQ][BK + 1] p in the storage dtype

  const int tid = threadIdx.x;
  const int r = tid / TPR;   // the q-tile row this thread works on
  const int c0 = tid % TPR;  // its column phase: columns c0 + TPR * j
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * BQ;
  const int64_t head = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t kvh = head / (p.h / p.h_kv);
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + head * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  const int64_t off = p.q_offset ? p.q_offset[b] : 0;

  // q tile, scaled in the storage dtype as the TPU kernel does.
  const float scale = to_f32(from_f32<T>(p.sm_scale));
  for (int i = tid; i < BQ * D; i += THREADS) {
    const int rr = i / D, dd = i % D;
    const int64_t qi = q0 + rr;
    qs[rr * DP + dd] =
        qi < p.sq ? round_to<T>(to_f32(q[qi * p.q_ss + dd]) * scale) : 0.f;
  }

  const int64_t q_last = (q0 + BQ < p.sq ? q0 + BQ : p.sq) - 1;
  int64_t kv_end = p.sk;
  if (p.causal && off + q_last + 1 < kv_end) kv_end = off + q_last + 1;

  const int64_t qi = q0 + r;
  const bool row_real = qi < p.sq;
  // Last key this row may see (inclusive).
  const int64_t row_limit = p.causal ? off + qi : p.sk - 1;

  // Next tile's K/V, in flight in registers while the current one is
  // used. Rows at or past Sk are zero: no 0 * NaN in the PV product.
  uint4 kreg[NPER], vreg[NPER];
  auto load_tile = [&](int64_t k0) {
#pragma unroll
    for (int n = 0; n < NPER; ++n) {
      const int vi = tid + n * THREADS;
      const int kk = vi * VEC / D, dd = vi * VEC % D;
      const int64_t kj = k0 + kk;
      uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
      if (vi < NV && kj < p.sk) {
        kv4 = *reinterpret_cast<const uint4*>(k + kj * p.k_ss + dd);
        vv4 = *reinterpret_cast<const uint4*>(v + kj * p.v_ss + dd);
      }
      kreg[n] = kv4;
      vreg[n] = vv4;
    }
  };
  auto store_tile = [&]() {
#pragma unroll
    for (int n = 0; n < NPER; ++n) {
      const int vi = tid + n * THREADS;
      if (vi < NV) {
        const int kk = vi * VEC / D, dd = vi * VEC % D;
        const T* ke = reinterpret_cast<const T*>(&kreg[n]);
        const T* ve = reinterpret_cast<const T*>(&vreg[n]);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          ks[kk * DP + dd + e] = to_f32(ke[e]);
          vs[kk * DP + dd + e] = to_f32(ve[e]);
        }
      }
    }
  };

  float m = NEG_INF, l = 0.f;
  float acc[ND];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j] = 0.f;

  if (kv_end > 0) load_tile(0);
  for (int64_t k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile's K/V/p reads are done
    store_tile();
    __syncthreads();
    if (k0 + BK < kv_end) load_tile(k0 + BK);

    const bool row_active = row_real && k0 <= row_limit;
    float s[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) s[j] = 0.f;
    if (row_active) {
#pragma unroll 16
      for (int dd = 0; dd < D; ++dd) {
        const float qv = qs[r * DP + dd];
#pragma unroll
        for (int j = 0; j < NC; ++j) s[j] += qv * ks[(c0 + TPR * j) * DP + dd];
      }
    }
    float m_tile = NEG_INF;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int64_t kj = k0 + c0 + TPR * j;
      if (!(row_active && kj < p.sk && kj <= row_limit)) s[j] = NEG_INF;
      m_tile = fmaxf(m_tile, s[j]);
    }
#pragma unroll
    for (int o = 1; o < TPR; o <<= 1)
      m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, o));
    const float m_new = fmaxf(m, m_tile);
    const float corr = expf(m - m_new);
    float lsum = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      // A masked entry is exactly 0 (also when the whole row is masked
      // so far, where s - m_new would be 0).
      const float pj = s[j] <= NEG_INF ? 0.f : expf(s[j] - m_new);
      lsum += pj;
      ps[r * (BK + 1) + c0 + TPR * j] = round_to<T>(pj);
    }
#pragma unroll
    for (int o = 1; o < TPR; o <<= 1)
      lsum += __shfl_xor_sync(0xffffffffu, lsum, o);
    l = l * corr + lsum;
    m = m_new;
    __syncwarp();  // row r's p is written by lanes of this warp only

#pragma unroll
    for (int j = 0; j < ND; ++j) acc[j] *= corr;
    if (row_active) {
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        const float pk = ps[r * (BK + 1) + kk];
#pragma unroll
        for (int j = 0; j < ND; ++j) acc[j] += pk * vs[kk * DP + c0 + TPR * j];
      }
    }
  }

  if (row_real) {
    const float lc = fmaxf(l, 1e-30f);
    T* o = static_cast<T*>(p.o) + b * p.o_sb + qi * p.o_ss + head * p.o_sh;
#pragma unroll
    for (int j = 0; j < ND; ++j) o[c0 + TPR * j] = from_f32<T>(acc[j] / lc);
    if (c0 == 0) p.lse[(b * p.h + head) * p.sq + qi] = m + logf(lc);
  }
}

template <typename T, int D, int BQ>
int launch(const Params& p, int64_t batch, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, BQ>();
  static bool configured = false;  // per instantiation
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D, BQ>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid(static_cast<unsigned>((p.sq + BQ - 1) / BQ),
                  static_cast<unsigned>(p.h), static_cast<unsigned>(batch));
  flash_fwd_kernel<T, D, BQ><<<grid, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Short query blocks (decode, small prefill buckets) take the 8-row tile.
template <typename T, int D>
int launch_tile(const Params& p, int64_t batch, cudaStream_t s) {
  if (p.sq <= 8) return launch<T, D, 8>(p, batch, s);
  return launch<T, D, 64>(p, batch, s);
}

template <typename T>
int dispatch_d(const Params& p, int64_t batch, int64_t d, cudaStream_t s) {
  switch (d) {
    case 64: return launch_tile<T, 64>(p, batch, s);
    case 128: return launch_tile<T, 128>(p, batch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the last dim
// of q, k, v and o is contiguous (the Python wrapper checks).
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* o, float* lse, const int* q_offset,
                         int64_t batch, int64_t sq, int64_t sk, int64_t h,
                         int64_t h_kv, int64_t d,
                         int64_t q_sb, int64_t q_ss, int64_t q_sh,
                         int64_t k_sb, int64_t k_ss, int64_t k_sh,
                         int64_t v_sb, int64_t v_ss, int64_t v_sh,
                         int64_t o_sb, int64_t o_ss, int64_t o_sh,
                         float sm_scale, int causal, int dtype,
                         void* stream) {
  if (batch == 0 || sq == 0 || h == 0) return 0;
  Params p{q, k, v, o, lse, q_offset, sq, sk, h, h_kv,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
           o_sb, o_ss, o_sh, sm_scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_d<float>(p, batch, d, s);
    case 1: return dispatch_d<__nv_bfloat16>(p, batch, d, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
