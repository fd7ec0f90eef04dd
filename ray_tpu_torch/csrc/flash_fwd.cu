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
// o = acc / max(l, 1e-30), lse = m + log(l). A masked entry of p is
// exactly 0, also in a row that has seen no key yet.
//
// What bounds it on the H100: at the training shape (batch 4, 2048
// tokens, 32 query / 8 KV heads, head_dim 64, causal, bf16) ~6.9e10
// operations against ~0.07 GB of inputs and outputs, so operations on the
// tensor cores (~0.07 ms at 989 TFLOP/s); a long prefill likewise; a
// decode step reads the whole visible KV cache for one query row per
// head, so memory bytes. Three kernels, chosen by flash_fwd:
//
// - bf16 with Sq > 8: the tensor-core kernel (flash_fwd_tc_kernel). One
//   block of 4 warps per (q head, batch, 64-row q tile), 16 q rows per
//   warp, launched heaviest tile first. q is copied once by cp.async,
//   scaled and rounded in shared memory, and held as ldmatrix A fragments
//   for the whole key loop. 64-key K/V tiles stream through a two-stage
//   cp.async ring (rows past Sk zero-filled, so no 0 * NaN reaches P V).
//   S = (scale q) K^T is an mma.m16n8k16 per 16 x 8 tile with K's B
//   fragments from ldmatrix; the online softmax runs on the C fragments,
//   the row max reduced over the 4 lanes of a quad by shuffles and the
//   row sum kept per lane until the end; P is rounded to bf16 and packed
//   from C into A fragments in registers (tc::c_to_a) for O += P V, with
//   V's B fragments from ldmatrix.trans. Only tiles that cross a row's
//   diagonal or Sk evaluate the mask, and the key loop ends at the last
//   tile the block's last row sees, read from q_offset on the device (no
//   host sync). Shared helpers are in tensor_core.cuh.
// - Sq <= 8 (decode, small prefill buckets), both dtypes: an 8-row tile,
//   one warp per row, f32 FMAs (flash_fwd_kernel<T, D, 8>).
// - float32 with Sq > 8: the same FMA kernel with a 64-row tile, which
//   keeps the f32 tolerance (TF32 tensor cores would not).
//
// The FMA kernel: one block of 256 threads per (batch, q head, q tile);
// 64-key K/V tiles read with 16-byte loads, the next tile's loads issued
// into registers before the current tile's arithmetic so device-memory
// latency overlaps compute; shared-memory rows padded by one float so
// column reads are free of bank conflicts; row max and sum reduced by warp
// shuffles; rows past Sq, and rows that see no key of a tile, skip its
// arithmetic. wgmma, TMA loads and warp specialisation are later work.
//
// Plain C interface, bound with ctypes (ray_tpu_torch/ops/attention.py).
// The launch goes on the caller's stream and allocates nothing; the
// function returns cudaGetLastError(). The tensor-core kernel needs
// 16-byte aligned q, k, v and o rows and returns cudaErrorMisalignedAddress
// otherwise (the wrapper checks first and raises a ValueError).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tensor_core.cuh"

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

// Launch `kernel` on `stream` with `smem` bytes of dynamic shared memory.
// The attribute that a kernel needs to take more than 48 KiB is set on its
// first launch only: `configured` is the caller's flag for this kernel.
int start(void (*kernel)(Params), bool& configured, dim3 grid, int threads,
          size_t smem, const Params& p, cudaStream_t stream) {
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  kernel<<<grid, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, int BQ>
int launch(const Params& p, int64_t batch, cudaStream_t stream) {
  static bool configured = false;
  const dim3 grid(static_cast<unsigned>((p.sq + BQ - 1) / BQ),
                  static_cast<unsigned>(p.h), static_cast<unsigned>(batch));
  return start(flash_fwd_kernel<T, D, BQ>, configured, grid, THREADS,
               smem_bytes<D, BQ>(), p, stream);
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

using tc::bf16;
using tc::BLOCK_ROWS;
using tc::LOG2E;
using tc::PAD;
using tc::TC_THREADS;

constexpr int BKV = 64;  // keys per streamed K/V tile

template <int D>
constexpr size_t tc_smem_bytes() {
  return sizeof(bf16) * (D + PAD) * (BLOCK_ROWS + 4 * BKV);
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS) flash_fwd_tc_kernel(Params p) {
  constexpr int LD = D + PAD;  // shared-memory row, in elements
  constexpr int KD = D / 16;   // k steps of S = Q K^T over head_dim
  constexpr int NK = BKV / 8;  // 8-key column tiles of s
  constexpr int ND = D / 8;    // 8-wide column tiles of o

  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);  // [64][LD] scaled q
  bf16* ks = qs + BLOCK_ROWS * LD;              // [2][BKV][LD] K ring
  bf16* vs = ks + 2 * BKV * LD;                 // [2][BKV][LD] V ring

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // Under a causal mask the last q tiles see the most keys: run them first.
  const int64_t q0 =
      static_cast<int64_t>(gridDim.z - 1 - blockIdx.z) * BLOCK_ROWS;
  const int64_t head = blockIdx.x, b = blockIdx.y;
  const int64_t kvh = head / (p.h / p.h_kv);
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + head * p.q_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  const int64_t off = p.q_offset ? p.q_offset[b] : 0;

  const int64_t q_last = (q0 + BLOCK_ROWS < p.sq ? q0 + BLOCK_ROWS : p.sq) - 1;
  int64_t kv_end = p.sk;
  if (p.causal && off + q_last + 1 < kv_end) kv_end = off + q_last + 1;
  const int64_t n_tiles = (kv_end + BKV - 1) / BKV;

  tc::load_rows_async<D, BLOCK_ROWS>(qs, q, p.q_ss, q0, p.sq);
  tc::cp_async_commit();
  if (n_tiles > 0) {
    tc::load_rows_async<D, BKV>(ks, k, p.k_ss, 0, p.sk);
    tc::load_rows_async<D, BKV>(vs, v, p.v_ss, 0, p.sk);
  }
  tc::cp_async_commit();

  tc::cp_async_wait<1>();  // q has landed
  tc::scale_rows<D, BLOCK_ROWS>(qs, tc::round_bf16(p.sm_scale));
  __syncthreads();
  const int a_off = tc::a_offset(lane, LD), b_off = tc::b_offset(lane, LD);
  uint32_t qf[KD][4];
  {
    const uint32_t qa = tc::smem_addr(qs + warp * 16 * LD + a_off);
#pragma unroll
    for (int kc = 0; kc < KD; ++kc) tc::ldmatrix_x4(qf[kc], qa + 2 * kc * 16);
  }

  // This thread's rows of the warp's 16: fragment rows g and g + 8. m
  // starts finite, so a masked score (-inf) gives p = 0 exactly and the
  // correction exp(m - m_new) is never exp(-inf + inf). l is this lane's
  // share of the row sum; the quad's shares are added at the end.
  const int64_t row0 = q0 + warp * 16 + g;
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int64_t it = 0; it < n_tiles; ++it) {
    const int st = static_cast<int>(it & 1);
    if (it + 1 < n_tiles) {
      tc::load_rows_async<D, BKV>(ks + (st ^ 1) * BKV * LD, k, p.k_ss,
                                  (it + 1) * BKV, p.sk);
      tc::load_rows_async<D, BKV>(vs + (st ^ 1) * BKV * LD, v, p.v_ss,
                                  (it + 1) * BKV, p.sk);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // tile `it` has landed (this thread's copies)
    __syncthreads();         // ... and every thread's
    const uint32_t kt = tc::smem_addr(ks + st * BKV * LD);
    const uint32_t vt = tc::smem_addr(vs + st * BKV * LD);
    const int64_t k0 = it * BKV;

    // s = (scale q) K^T: 16 rows x BKV keys per warp.
    float s[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KD; ++kc)
#pragma unroll
      for (int nb = 0; nb < NK / 2; ++nb) {
        uint32_t kb[4];
        tc::ldmatrix_x4(kb, kt + 2 * (nb * 16 * LD + b_off + kc * 16));
        tc::mma_bf16(s[2 * nb], qf[kc], kb[0], kb[1]);
        tc::mma_bf16(s[2 * nb + 1], qf[kc], kb[2], kb[3]);
      }

    // Only a tile past Sk, or past the block's first row's diagonal,
    // evaluates the mask.
    if (k0 + BKV > p.sk || (p.causal && k0 + BKV - 1 > off + q0)) {
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int64_t key = k0 + j * 8 + 2 * t + (e & 1);
          const int64_t row = row0 + 8 * (e >> 1);
          if (key >= p.sk || (p.causal && key > off + row))
            s[j][e] = -INFINITY;
        }
    }

    // Online softmax on the C fragments: the row max over the quad, p in
    // place of s, the running state rescaled.
    float m_new[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        m_new[e >> 1] = fmaxf(m_new[e >> 1], s[j][e]);
    float corr[2], m2[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m_new[i] = fmaxf(m_new[i], __shfl_xor_sync(0xffffffffu, m_new[i], 1));
      m_new[i] = fmaxf(m_new[i], __shfl_xor_sync(0xffffffffu, m_new[i], 2));
      corr[i] = exp2f((m[i] - m_new[i]) * LOG2E);
      m[i] = m_new[i];
      m2[i] = m_new[i] * LOG2E;
      l[i] *= corr[i];
    }
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pj = exp2f(fmaf(s[j][e], LOG2E, -m2[e >> 1]));
        l[e >> 1] += pj;
        s[j][e] = pj;
      }
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= corr[e >> 1];

    // acc += P V: p in bf16 as the A operand, V through ldmatrix.trans.
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t pf[4];
      tc::c_to_a(pf, s, kk);
#pragma unroll
      for (int db = 0; db < D / 16; ++db) {
        uint32_t vb[4];
        tc::ldmatrix_x4_trans(vb, vt + 2 * (kk * 16 * LD + a_off + db * 16));
        tc::mma_bf16(acc[2 * db], pf, vb[0], vb[1]);
        tc::mma_bf16(acc[2 * db + 1], pf, vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with stage st before its refill
  }
  tc::cp_async_wait<0>();  // nothing in flight at exit (no key tile at all)

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int64_t row = row0 + 8 * i;
    if (row >= p.sq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    bf16* o = static_cast<bf16*>(p.o) + b * p.o_sb + row * p.o_ss +
              head * p.o_sh;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<uint32_t*>(o + j * 8 + 2 * t) =
          tc::pack_bf16(acc[j][2 * i] / lc, acc[j][2 * i + 1] / lc);
    if (t == 0) p.lse[(b * p.h + head) * p.sq + row] = m[i] + logf(lc);
  }
}

template <int D>
int launch_tc(const Params& p, int64_t batch, cudaStream_t stream) {
  static bool configured = false;
  // Rows are copied as 16-byte pieces; o is written as 4-byte pairs.
  const void* ptrs[] = {p.q, p.k, p.v, p.o};
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16)
      return static_cast<int>(cudaErrorMisalignedAddress);
  const int64_t strides[] = {p.q_sb, p.q_ss, p.q_sh, p.k_sb, p.k_ss, p.k_sh,
                             p.v_sb, p.v_ss, p.v_sh};
  for (int64_t st : strides)
    if (st % 8) return static_cast<int>(cudaErrorMisalignedAddress);
  const int64_t tiles = (p.sq + BLOCK_ROWS - 1) / BLOCK_ROWS;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(p.h), static_cast<unsigned>(batch),
                  static_cast<unsigned>(tiles));
  return start(flash_fwd_tc_kernel<D>, configured, grid, TC_THREADS,
               tc_smem_bytes<D>(), p, stream);
}

// Short query blocks (decode, small prefill buckets) take the 8-row tile;
// longer bf16 blocks the tensor cores; longer f32 blocks the 64-row FMA
// tile.
template <typename T, int D>
int launch_tile(const Params& p, int64_t batch, cudaStream_t s) {
  if (p.sq <= 8) return launch<T, D, 8>(p, batch, s);
  if constexpr (std::is_same_v<T, bf16>) {
    return launch_tc<D>(p, batch, s);
  } else {
    return launch<T, D, 64>(p, batch, s);
  }
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
