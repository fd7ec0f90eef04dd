// Flash attention backward for Hopper (sm_90a): a dq kernel and a dk/dv
// kernel, one C entry point each.
//
// Replaces ray_tpu/ops/attention.py:_flash_bwd_dq_kernel (pallas_call at
// :447) and _flash_bwd_dkv_kernel (pallas_call at :488), both driven by
// _flash_bwd. With lse saved by the forward and delta = rowsum(do * o)
// computed by the caller (as JAX does outside its kernels), for a query
// row i and a key j that row sees:
//
//   s  = (scale * q_i) . k_j        p  = exp(s - lse_i)
//   dp = do_i . v_j                 ds = p * (dp - delta_i)
//   dq_i = scale * sum_j ds * k_j
//   dv_j = sum_i p * do_i           dk_j = sum_i ds * (scale * q_i)
//
// Arithmetic follows the TPU kernels: sm_scale is folded into q in the
// storage dtype, every product accumulates in f32, p and ds are rounded to
// the storage dtype before they multiply a stored tensor, and each output
// is rounded once, at the end. Row i sees key j iff j < Sk and, when
// causal, j <= i (the forward's top-left mask); K/V rows past Sk and q/do
// rows past Sq load as zero, so no 0 * NaN from memory outside the tensors
// reaches a sum (what attention.py:357-364 and :266-272 zero).
//
// Design. The TPU kernels walk a sequential grid axis and carry their sums
// in VMEM scratch between steps; here each block owns its output tile and
// walks the other axis in a loop, so every output element is written once
// by one block, with no atomics:
//
// - dq: one block per (batch, q head, 64-row q tile), looping over the
//   K/V tiles; under a causal mask the loop ends at the tile that holds
//   the block's last row's diagonal. Per tile it recomputes s and dp,
//   forms ds and adds ds @ K to an f32 accumulator.
// - dk/dv: one block per (batch, KV head, 64-key tile), looping over the
//   query heads of its GQA group and over their q tiles; under a causal
//   mask the q loop starts at the first tile with a row at or below the
//   key tile's first key (the clamp at attention.py:470-478). Per tile it
//   recomputes s^T and dp^T, forms p^T and ds^T, and adds p^T @ do and
//   ds^T @ (scale q) to f32 accumulators. Summing the group's heads inside
//   the block replaces the TPU's per-query-head f32 outputs and their sum
//   outside the kernel (attention.py:517-520): dk and dv are written once,
//   in k's dtype, with no [B, Sk, H, D] f32 buffer.
//
// What bounds it on the H100. At the training shape (batch 4, 2048
// tokens, 32 query / 8 KV heads, head_dim 64, causal, bf16) the work is
// ~1.0e11 operations for dq (three products) and ~1.4e11 for dk/dv (four)
// against ~0.1 GB of inputs and outputs: both are bound by operations on
// the tensor cores, ~0.10 and ~0.14 ms at 989 TFLOP/s.
//
// bf16: the tensor-core kernels (flash_bwd_dq_tc_kernel,
// flash_bwd_dkv_tc_kernel). 128 threads, 4 warps of 16 output rows each.
// Every product is an mma.m16n8k16 bf16 -> f32 (tensor_core.cuh) fed by
// ldmatrix from bf16 tiles in shared memory, whose rows are padded by 16
// bytes so that ldmatrix's eight row addresses hit eight different bank
// groups. Tiles arrive by 16-byte cp.async copies (rows past Sq / Sk
// zero-filled) into a two-stage ring: the streamed tiles (K/V in dq; q,
// do, lse and delta in dk/dv) load one tile ahead of the products. q is
// scaled in shared memory once per tile, bf16(bf16(q) * bf16(scale)).
// - dq: the warp's q and do fragments stay in registers for the whole K/V
//   loop; s = q K^T and dp = do V^T come out as C fragments, ds is formed
//   in them and packed to bf16 as the A fragment of ds @ K, with K read
//   through ldmatrix.trans. The key tile is 64 at head_dim 64 and 32 at
//   head_dim 128, where q, do and dq fragments take twice the registers.
// - dk/dv: keys are the M dimension: s^T = K (scale q)^T and
//   dp^T = V do^T, so p^T and ds^T are C fragments in the row layout of
//   the A operand of p^T @ do and ds^T @ (scale q); q and do are the B
//   operands of all four products, the last two through ldmatrix.trans.
//   lse and delta are per q column here and sit in shared memory. The q
//   tile is 64 rows at head_dim 64 and 32 at head_dim 128.
// Only tiles that cross the causal diagonal (or, in dq, the end of K)
// evaluate the mask. Blocks are launched heaviest first: under a causal
// mask the last q tiles (dq) and the first key tiles (dk/dv) do the most
// work, and the tile index is the grid's slowest axis.
// What bounds these kernels now: at the training shape they run at about
// a quarter of the 989 TFLOP/s dense bf16 peak (PERF.md). Per streamed
// tile each warp reads every B fragment from shared memory through
// ldmatrix (4 warps read the same tile), mma.sync issues at most two
// thirds of wgmma's rate, and 222-244 registers a thread leave room for
// two blocks (8 warps) per SM to hide latency. wgmma on operands in
// swizzled shared memory, fed by TMA, with 64-row warpgroup tiles, is the
// next step. Registers with -Xptxas -v (sm_90a), no spills in any:
// dq<64> 238, dk/dv<64> 222, dq<128> 242, dk/dv<128> 244; the f32 kernels
// 80-128.
//
// float32: the FMA kernels (flash_bwd_dq_kernel, flash_bwd_dkv_kernel),
// which keep the f32 tolerance: 256 threads work a 64-row tile, 4 threads
// to a row, each thread on every 4th column, as f32 FMAs out of
// shared-memory rows padded by one float. No main path runs them on the
// card; TF32 tensor cores would not hold the f32 check.
//
// Plain C interface, bound with ctypes (ray_tpu_torch/ops/attention.py).
// Both entry points take the same arguments; each launch goes on the
// caller's stream, allocates nothing, and returns cudaGetLastError(). The
// bf16 kernels need 16-byte aligned q, k, v, do and outputs and return
// cudaErrorMisalignedAddress otherwise (the wrapper checks first and
// raises a ValueError that names the tensor).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

// All tensors are contiguous (the Python wrapper makes them so):
// q, do, dq [B, Sq, H, D]; k, v, dk, dv [B, Sk, Hkv, D]; lse, delta
// [B, H, Sq] f32.
struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  int64_t sq, sk, h, h_kv;
  float sm_scale;
  int causal;
};

// ---------------------------------------------------------------------------
// float32 on FMAs
// ---------------------------------------------------------------------------

constexpr int TILE = 64;              // rows of a q tile and of a K/V tile
constexpr int THREADS = 256;
constexpr int TPR = THREADS / TILE;   // threads per tile row
constexpr int TP = TILE + 1;          // padded row of a p / ds tile

// Rows [r0, r0 + TILE) of one head of a [.., S, heads, D] f32 tensor into a
// [TILE][D + 1] tile, each value multiplied by `scale` (q is scaled in its
// storage dtype, as on the TPU; 1 for the others); rows at or past `n` are
// zero.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* head_base,
                                          int64_t row_stride, int64_t r0,
                                          int64_t n, float scale) {
  for (int i = threadIdx.x; i < TILE * D; i += THREADS) {
    const int rr = i / D, dd = i % D;
    const int64_t r = r0 + rr;
    dst[rr * (D + 1) + dd] = r < n ? head_base[r * row_stride + dd] * scale
                                   : 0.f;
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * TILE * (D + 1) + TILE * TP);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (4 * TILE * (D + 1) + 2 * TILE * TP + 2 * TILE);
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(Params p) {
  constexpr int DP = D + 1;
  constexpr int NC = TILE / TPR;  // key columns per thread
  constexpr int ND = D / TPR;     // dq columns per thread

  extern __shared__ float smem[];
  float* qs = smem;             // [TILE][DP] scaled q
  float* dos = qs + TILE * DP;  // [TILE][DP] do
  float* ks = dos + TILE * DP;  // [TILE][DP]
  float* vs = ks + TILE * DP;   // [TILE][DP]
  float* dss = vs + TILE * DP;  // [TILE][TP] ds

  const int tid = threadIdx.x;
  const int r = tid / TPR;   // the q-tile row this thread works on
  const int c0 = tid % TPR;  // its column phase: columns c0 + TPR * j
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * TILE;
  const int64_t head = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t kvh = head / (p.h / p.h_kv);
  const int64_t q_stride = p.h * D, kv_stride = p.h_kv * D;
  const float* q =
      static_cast<const float*>(p.q) + b * p.sq * q_stride + head * D;
  const float* dout =
      static_cast<const float*>(p.dout) + b * p.sq * q_stride + head * D;
  const float* k =
      static_cast<const float*>(p.k) + b * p.sk * kv_stride + kvh * D;
  const float* v =
      static_cast<const float*>(p.v) + b * p.sk * kv_stride + kvh * D;

  load_tile<D>(qs, q, q_stride, q0, p.sq, p.sm_scale);
  load_tile<D>(dos, dout, q_stride, q0, p.sq, 1.f);

  const int64_t qi = q0 + r;
  const bool row_real = qi < p.sq;
  const int64_t lane_row = (b * p.h + head) * p.sq + qi;
  const float lse = row_real ? p.lse[lane_row] : 0.f;
  const float delta = row_real ? p.delta[lane_row] : 0.f;
  // Last key this row sees (inclusive).
  const int64_t row_limit = p.causal ? qi : p.sk - 1;

  const int64_t q_last = (q0 + TILE < p.sq ? q0 + TILE : p.sq) - 1;
  int64_t kv_end = p.sk;
  if (p.causal && q_last + 1 < kv_end) kv_end = q_last + 1;

  float acc[ND];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j] = 0.f;

  for (int64_t k0 = 0; k0 < kv_end; k0 += TILE) {
    __syncthreads();  // the previous tile's K/ds reads are done
    load_tile<D>(ks, k, kv_stride, k0, p.sk, 1.f);
    load_tile<D>(vs, v, kv_stride, k0, p.sk, 1.f);
    __syncthreads();

    const bool row_active = row_real && k0 <= row_limit;
    float s[NC], dp[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) s[j] = dp[j] = 0.f;
    if (row_active) {
#pragma unroll 8
      for (int dd = 0; dd < D; ++dd) {
        const float qv = qs[r * DP + dd];
        const float dov = dos[r * DP + dd];
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const int kk = c0 + TPR * j;
          s[j] += qv * ks[kk * DP + dd];
          dp[j] += dov * vs[kk * DP + dd];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int64_t kj = k0 + c0 + TPR * j;
      const bool seen = row_active && kj < p.sk && kj <= row_limit;
      const float pj = seen ? expf(s[j] - lse) : 0.f;
      dss[r * TP + c0 + TPR * j] = pj * (dp[j] - delta);
    }
    __syncwarp();  // row r's ds is written by lanes of this warp only

    if (row_active) {
#pragma unroll 8
      for (int kk = 0; kk < TILE; ++kk) {
        const float dsv = dss[r * TP + kk];
#pragma unroll
        for (int j = 0; j < ND; ++j) acc[j] += dsv * ks[kk * DP + c0 + TPR * j];
      }
    }
  }

  if (row_real) {
    float* dq = static_cast<float*>(p.dq) + b * p.sq * q_stride +
                qi * q_stride + head * D;
#pragma unroll
    for (int j = 0; j < ND; ++j) dq[c0 + TPR * j] = acc[j] * p.sm_scale;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_kernel(Params p) {
  constexpr int DP = D + 1;
  constexpr int NR = TILE / TPR;  // q rows per thread
  constexpr int ND = D / TPR;     // dk/dv columns per thread

  extern __shared__ float smem[];
  float* ks = smem;               // [TILE][DP]
  float* vs = ks + TILE * DP;     // [TILE][DP]
  float* qs = vs + TILE * DP;     // [TILE][DP] scaled q
  float* dos = qs + TILE * DP;    // [TILE][DP] do
  float* pt = dos + TILE * DP;    // [TILE keys][TP] p^T
  float* dst = pt + TILE * TP;    // [TILE keys][TP] ds^T
  float* lses = dst + TILE * TP;  // [TILE]
  float* deltas = lses + TILE;    // [TILE]

  const int tid = threadIdx.x;
  const int c = tid / TPR;   // the key-tile row this thread works on
  const int c0 = tid % TPR;  // its phase: q rows / columns c0 + TPR * j
  const int64_t k0 = static_cast<int64_t>(blockIdx.x) * TILE;
  const int64_t kvh = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t rep = p.h / p.h_kv;
  const int64_t q_stride = p.h * D, kv_stride = p.h_kv * D;
  const float* k =
      static_cast<const float*>(p.k) + b * p.sk * kv_stride + kvh * D;
  const float* v =
      static_cast<const float*>(p.v) + b * p.sk * kv_stride + kvh * D;
  load_tile<D>(ks, k, kv_stride, k0, p.sk, 1.f);
  load_tile<D>(vs, v, kv_stride, k0, p.sk, 1.f);

  const int64_t kj = k0 + c;
  // Causal: row i sees key j iff i >= j, so the first q tile with a row
  // that sees this key tile is the one holding row k0.
  const int64_t q_begin = p.causal ? (k0 / TILE) * TILE : 0;

  float dk_acc[ND], dv_acc[ND];
#pragma unroll
  for (int j = 0; j < ND; ++j) dk_acc[j] = dv_acc[j] = 0.f;

  for (int64_t hh = 0; hh < rep; ++hh) {
    const int64_t head = kvh * rep + hh;
    const float* q =
        static_cast<const float*>(p.q) + b * p.sq * q_stride + head * D;
    const float* dout =
        static_cast<const float*>(p.dout) + b * p.sq * q_stride + head * D;
    const int64_t lane0 = (b * p.h + head) * p.sq;
    for (int64_t q0 = q_begin; q0 < p.sq; q0 += TILE) {
      __syncthreads();  // the previous tile's q/do/p/ds reads are done
      load_tile<D>(qs, q, q_stride, q0, p.sq, p.sm_scale);
      load_tile<D>(dos, dout, q_stride, q0, p.sq, 1.f);
      if (tid < TILE) {
        const int64_t qi = q0 + tid;
        lses[tid] = qi < p.sq ? p.lse[lane0 + qi] : 0.f;
        deltas[tid] = qi < p.sq ? p.delta[lane0 + qi] : 0.f;
      }
      __syncthreads();

      float s[NR], dp[NR];
#pragma unroll
      for (int j = 0; j < NR; ++j) s[j] = dp[j] = 0.f;
#pragma unroll 8
      for (int dd = 0; dd < D; ++dd) {
        const float kv = ks[c * DP + dd];
        const float vv = vs[c * DP + dd];
#pragma unroll
        for (int j = 0; j < NR; ++j) {
          const int rr = c0 + TPR * j;
          s[j] += kv * qs[rr * DP + dd];
          dp[j] += vv * dos[rr * DP + dd];
        }
      }
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        const int rr = c0 + TPR * j;
        const int64_t qi = q0 + rr;
        const bool seen = qi < p.sq && (!p.causal || qi >= kj);
        const float pj = seen ? expf(s[j] - lses[rr]) : 0.f;
        pt[c * TP + rr] = pj;
        dst[c * TP + rr] = pj * (dp[j] - deltas[rr]);
      }
      __syncwarp();  // key row c's p/ds are written by lanes of this warp

#pragma unroll 8
      for (int rr = 0; rr < TILE; ++rr) {
        const float pv = pt[c * TP + rr];
        const float dsv = dst[c * TP + rr];
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          const int col = c0 + TPR * j;
          dv_acc[j] += pv * dos[rr * DP + col];
          dk_acc[j] += dsv * qs[rr * DP + col];
        }
      }
    }
  }

  if (kj < p.sk) {
    const int64_t off = b * p.sk * kv_stride + kj * kv_stride + kvh * D;
    float* dk = static_cast<float*>(p.dk) + off;
    float* dv = static_cast<float*>(p.dv) + off;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      dk[c0 + TPR * j] = dk_acc[j];
      dv[c0 + TPR * j] = dv_acc[j];
    }
  }
}

// Launch `kernel` on `stream` with `smem` bytes of dynamic shared memory,
// setting the attribute that a kernel needs to take more than 48 KiB.
int start(void (*kernel)(Params), dim3 grid, int threads, size_t smem,
          const Params& p, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool DKV>
int launch(const Params& p, int64_t batch, cudaStream_t stream) {
  const int64_t rows = DKV ? p.sk : p.sq;
  const dim3 grid(static_cast<unsigned>((rows + TILE - 1) / TILE),
                  static_cast<unsigned>(DKV ? p.h_kv : p.h),
                  static_cast<unsigned>(batch));
  return start(DKV ? flash_bwd_dkv_kernel<D> : flash_bwd_dq_kernel<D>, grid,
               THREADS, DKV ? dkv_smem_bytes<D>() : dq_smem_bytes<D>(), p,
               stream);
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
using tc::BLOCK_ROWS;
using tc::LOG2E;
using tc::PAD;
using tc::TC_THREADS;
using tc::load_rows_async;
using tc::round_bf16;
using tc::scale_rows;

// The streamed tile: keys per K/V tile (dq) and q rows per q tile (dk/dv).
template <int D>
__host__ __device__ constexpr int stream_rows() {
  return D == 64 ? 64 : 32;
}

template <int D>
constexpr size_t dq_tc_smem_bytes() {
  return sizeof(bf16) * (D + PAD) * (2 * BLOCK_ROWS + 4 * stream_rows<D>());
}

// The same tiles, plus the lse and delta ring.
template <int D>
constexpr size_t dkv_tc_smem_bytes() {
  return dq_tc_smem_bytes<D>() + sizeof(float) * 4 * stream_rows<D>();
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS) flash_bwd_dq_tc_kernel(Params p) {
  constexpr int BKV = stream_rows<D>();
  constexpr int LD = D + PAD;    // shared-memory row, in elements
  constexpr int KD = D / 16;     // k steps over head_dim
  constexpr int NK = BKV / 8;    // 8-key column tiles of s and dp
  constexpr int ND = D / 8;      // 8-wide column tiles of dq

  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);  // [64][LD] scaled q
  bf16* dos = qs + BLOCK_ROWS * LD;             // [64][LD] do
  bf16* ks = dos + BLOCK_ROWS * LD;             // [2][BKV][LD] K ring
  bf16* vs = ks + 2 * BKV * LD;                 // [2][BKV][LD] V ring

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // Under a causal mask the last q tiles see the most keys: run them first.
  const int64_t q0 =
      static_cast<int64_t>(gridDim.z - 1 - blockIdx.z) * BLOCK_ROWS;
  const int64_t head = blockIdx.x, b = blockIdx.y;
  const int64_t kvh = head / (p.h / p.h_kv);
  const int64_t q_stride = p.h * D, kv_stride = p.h_kv * D;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.sq * q_stride + head * D;
  const bf16* dout =
      static_cast<const bf16*>(p.dout) + b * p.sq * q_stride + head * D;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.sk * kv_stride + kvh * D;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.sk * kv_stride + kvh * D;

  const int64_t q_last = (q0 + BLOCK_ROWS < p.sq ? q0 + BLOCK_ROWS : p.sq) - 1;
  int64_t kv_end = p.sk;
  if (p.causal && q_last + 1 < kv_end) kv_end = q_last + 1;
  const int64_t n_tiles = (kv_end + BKV - 1) / BKV;

  load_rows_async<D, BLOCK_ROWS>(qs, q, q_stride, q0, p.sq);
  load_rows_async<D, BLOCK_ROWS>(dos, dout, q_stride, q0, p.sq);
  tc::cp_async_commit();
  if (n_tiles > 0) {
    load_rows_async<D, BKV>(ks, k, kv_stride, 0, p.sk);
    load_rows_async<D, BKV>(vs, v, kv_stride, 0, p.sk);
  }
  tc::cp_async_commit();

  // This thread's rows of the warp's 16: fragment rows g and g + 8.
  const int64_t row0 = q0 + warp * 16 + g;
  const int64_t lane0 = (b * p.h + head) * p.sq;
  float lse2[2], delta[2];  // lse2 = lse * log2(e)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t row = row0 + 8 * i;
    lse2[i] = row < p.sq ? p.lse[lane0 + row] * LOG2E : 0.f;
    delta[i] = row < p.sq ? p.delta[lane0 + row] : 0.f;
  }

  tc::cp_async_wait<1>();  // q and do have landed
  scale_rows<D, BLOCK_ROWS>(qs, round_bf16(p.sm_scale));
  __syncthreads();
  const int a_off = tc::a_offset(lane, LD), b_off = tc::b_offset(lane, LD);
  uint32_t qf[KD][4], dof[KD][4];
  {
    const uint32_t qa = tc::smem_addr(qs + warp * 16 * LD + a_off);
    const uint32_t da = tc::smem_addr(dos + warp * 16 * LD + a_off);
#pragma unroll
    for (int kc = 0; kc < KD; ++kc) {
      tc::ldmatrix_x4(qf[kc], qa + 2 * kc * 16);
      tc::ldmatrix_x4(dof[kc], da + 2 * kc * 16);
    }
  }

  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int64_t it = 0; it < n_tiles; ++it) {
    const int st = static_cast<int>(it & 1);
    if (it + 1 < n_tiles) {
      load_rows_async<D, BKV>(ks + (st ^ 1) * BKV * LD, k, kv_stride,
                              (it + 1) * BKV, p.sk);
      load_rows_async<D, BKV>(vs + (st ^ 1) * BKV * LD, v, kv_stride,
                              (it + 1) * BKV, p.sk);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // tile `it` has landed (this thread's copies)
    __syncthreads();         // ... and every thread's
    const uint32_t kt = tc::smem_addr(ks + st * BKV * LD);
    const uint32_t vt = tc::smem_addr(vs + st * BKV * LD);
    const int64_t k0 = it * BKV;

    // s = (scale q) K^T, dp = do V^T: 16 rows x BKV keys per warp.
    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KD; ++kc)
#pragma unroll
      for (int nb = 0; nb < NK / 2; ++nb) {
        const uint32_t off = 2 * (nb * 16 * LD + b_off + kc * 16);
        uint32_t kb[4], vb[4];
        tc::ldmatrix_x4(kb, kt + off);
        tc::ldmatrix_x4(vb, vt + off);
        tc::mma_bf16(s[2 * nb], qf[kc], kb[0], kb[1]);
        tc::mma_bf16(s[2 * nb + 1], qf[kc], kb[2], kb[3]);
        tc::mma_bf16(dp[2 * nb], dof[kc], vb[0], vb[1]);
        tc::mma_bf16(dp[2 * nb + 1], dof[kc], vb[2], vb[3]);
      }

    // Only a tile past the block's first row's diagonal, or past Sk,
    // evaluates the mask; a masked score is -inf, so p = 0 and ds = 0.
    if (k0 + BKV > p.sk || (p.causal && k0 + BKV - 1 > q0)) {
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int64_t key = k0 + j * 8 + 2 * t + (e & 1);
          const int64_t row = row0 + 8 * (e >> 1);
          if (key >= p.sk || (p.causal && key > row)) s[j][e] = -INFINITY;
        }
    }
    // ds = p (dp - delta), p = exp(s - lse), in place of s.
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pj = exp2f(fmaf(s[j][e], LOG2E, -lse2[e >> 1]));
        s[j][e] = pj * (dp[j][e] - delta[e >> 1]);
      }

    // acc += ds K: ds in bf16 as the A operand, K through ldmatrix.trans.
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t dsf[4];
      tc::c_to_a(dsf, s, kk);
#pragma unroll
      for (int db = 0; db < D / 16; ++db) {
        uint32_t kb[4];
        tc::ldmatrix_x4_trans(kb, kt + 2 * (kk * 16 * LD + a_off + db * 16));
        tc::mma_bf16(acc[2 * db], dsf, kb[0], kb[1]);
        tc::mma_bf16(acc[2 * db + 1], dsf, kb[2], kb[3]);
      }
    }
    __syncthreads();  // every warp is done with stage st before its refill
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t row = row0 + 8 * i;
    if (row >= p.sq) continue;
    bf16* dq = static_cast<bf16*>(p.dq) + b * p.sq * q_stride +
               row * q_stride + head * D;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<uint32_t*>(dq + j * 8 + 2 * t) =
          tc::pack_bf16(acc[j][2 * i] * p.sm_scale,
                        acc[j][2 * i + 1] * p.sm_scale);
  }
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS)
    flash_bwd_dkv_tc_kernel(Params p) {
  constexpr int BQ = stream_rows<D>();
  constexpr int LD = D + PAD;
  constexpr int KD = D / 16;   // k steps over head_dim
  constexpr int NQ = BQ / 8;   // 8-row column tiles of s^T and dp^T
  constexpr int ND = D / 8;    // 8-wide column tiles of dk and dv

  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* ks = reinterpret_cast<bf16*>(tc_smem);  // [64][LD]
  bf16* vs = ks + BLOCK_ROWS * LD;              // [64][LD]
  bf16* qs = vs + BLOCK_ROWS * LD;              // [2][BQ][LD] scaled q ring
  bf16* dos = qs + 2 * BQ * LD;                 // [2][BQ][LD] do ring
  float* lses = reinterpret_cast<float*>(dos + 2 * BQ * LD);  // [2][BQ]
  float* deltas = lses + 2 * BQ;                               // [2][BQ]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // The key tile is the grid's slowest axis, so the first key tiles, which
  // see the most q tiles under a causal mask, are launched first.
  const int64_t k0 = static_cast<int64_t>(blockIdx.z) * BLOCK_ROWS;
  const int64_t kvh = blockIdx.x, b = blockIdx.y;
  const int64_t rep = p.h / p.h_kv;
  const int64_t q_stride = p.h * D, kv_stride = p.h_kv * D;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.sk * kv_stride + kvh * D;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.sk * kv_stride + kvh * D;

  // Causal: row i sees key j iff i >= j, so the first q tile with a row
  // that sees this key tile is the one holding row k0.
  const int64_t qt_begin = p.causal ? k0 / BQ : 0;
  const int64_t qt_end = (p.sq + BQ - 1) / BQ;
  const int64_t per_head = qt_end > qt_begin ? qt_end - qt_begin : 0;
  const int64_t n_iters = rep * per_head;

  // Tile `it` of the walk over (query head of the group, q tile) into
  // stage st: q, do, and their rows' lse and delta (4-byte copies: a
  // [B, H, Sq] row need not start 16-byte aligned).
  auto load_q_tile = [&](int64_t it, int st) {
    const int64_t head = kvh * rep + it / per_head;
    const int64_t q0 = (qt_begin + it % per_head) * BQ;
    const int64_t off = b * p.sq * q_stride + head * D;
    load_rows_async<D, BQ>(qs + st * BQ * LD,
                           static_cast<const bf16*>(p.q) + off, q_stride, q0,
                           p.sq);
    load_rows_async<D, BQ>(dos + st * BQ * LD,
                           static_cast<const bf16*>(p.dout) + off, q_stride,
                           q0, p.sq);
    const int i = threadIdx.x;
    if (i < 2 * BQ) {
      const bool is_lse = i < BQ;
      const int r = is_lse ? i : i - BQ;
      const bool valid = q0 + r < p.sq;
      const float* src = (is_lse ? p.lse : p.delta) +
                         (valid ? (b * p.h + head) * p.sq + q0 + r : 0);
      tc::cp_async_4(tc::smem_addr((is_lse ? lses : deltas) + st * BQ + r),
                     src, valid);
    }
  };

  load_rows_async<D, BLOCK_ROWS>(ks, k, kv_stride, k0, p.sk);
  load_rows_async<D, BLOCK_ROWS>(vs, v, kv_stride, k0, p.sk);
  tc::cp_async_commit();
  if (n_iters > 0) load_q_tile(0, 0);
  tc::cp_async_commit();

  const int a_off = tc::a_offset(lane, LD), b_off = tc::b_offset(lane, LD);
  const uint32_t ka = tc::smem_addr(ks + warp * 16 * LD + a_off);
  const uint32_t va = tc::smem_addr(vs + warp * 16 * LD + a_off);
  const float scale = round_bf16(p.sm_scale);
  // This thread's keys of the warp's 16: fragment rows g and g + 8.
  const int64_t key0 = k0 + warp * 16 + g;

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int64_t it = 0; it < n_iters; ++it) {
    const int st = static_cast<int>(it & 1);
    if (it + 1 < n_iters) load_q_tile(it + 1, st ^ 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // K/V and tile `it` have landed (own copies)
    scale_rows<D, BQ>(qs + st * BQ * LD, scale);
    __syncthreads();
    const uint32_t qt = tc::smem_addr(qs + st * BQ * LD);
    const uint32_t dt = tc::smem_addr(dos + st * BQ * LD);
    const float* lse_t = lses + st * BQ;
    const float* delta_t = deltas + st * BQ;
    const int64_t q0 = (qt_begin + it % per_head) * BQ;

    // s^T = K (scale q)^T, dp^T = V do^T: 16 keys x BQ rows per warp.
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KD; ++kc) {
      uint32_t kf[4], vf[4];
      tc::ldmatrix_x4(kf, ka + 2 * kc * 16);
      tc::ldmatrix_x4(vf, va + 2 * kc * 16);
#pragma unroll
      for (int nb = 0; nb < NQ / 2; ++nb) {
        const uint32_t off = 2 * (nb * 16 * LD + b_off + kc * 16);
        uint32_t qb[4], db[4];
        tc::ldmatrix_x4(qb, qt + off);
        tc::ldmatrix_x4(db, dt + off);
        tc::mma_bf16(s[2 * nb], kf, qb[0], qb[1]);
        tc::mma_bf16(s[2 * nb + 1], kf, qb[2], qb[3]);
        tc::mma_bf16(dp[2 * nb], vf, db[0], db[1]);
        tc::mma_bf16(dp[2 * nb + 1], vf, db[2], db[3]);
      }
    }

    // p^T = exp(s^T - lse), ds^T = p^T (dp^T - delta), per q column. Only
    // a tile that crosses the diagonal evaluates the causal mask. Rows
    // past Sq (zero q, do, lse, delta) add exactly 0; keys past Sk only
    // reach rows of dk/dv that are not written.
    const bool masked = p.causal && q0 < k0 + BLOCK_ROWS - 1;
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(lse_t + j * 8 + 2 * t);
      const float2 dl =
          *reinterpret_cast<const float2*>(delta_t + j * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lse = (e & 1) ? l.y : l.x;
        const float del = (e & 1) ? dl.y : dl.x;
        const int64_t row = q0 + j * 8 + 2 * t + (e & 1);
        const int64_t key = key0 + 8 * (e >> 1);
        const float pj = masked && row < key
                             ? 0.f
                             : exp2f(fmaf(s[j][e], LOG2E, -lse * LOG2E));
        s[j][e] = pj;
        dp[j][e] = pj * (dp[j][e] - del);
      }
    }

    // dv += p^T do, dk += ds^T (scale q): p^T and ds^T in bf16 as A
    // operands, do and q through ldmatrix.trans.
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t pf[4], dsf[4];
      tc::c_to_a(pf, s, kk);
      tc::c_to_a(dsf, dp, kk);
#pragma unroll
      for (int db = 0; db < D / 16; ++db) {
        const uint32_t off = 2 * (kk * 16 * LD + a_off + db * 16);
        uint32_t ob[4], qb[4];
        tc::ldmatrix_x4_trans(ob, dt + off);
        tc::ldmatrix_x4_trans(qb, qt + off);
        tc::mma_bf16(dv[2 * db], pf, ob[0], ob[1]);
        tc::mma_bf16(dv[2 * db + 1], pf, ob[2], ob[3]);
        tc::mma_bf16(dk[2 * db], dsf, qb[0], qb[1]);
        tc::mma_bf16(dk[2 * db + 1], dsf, qb[2], qb[3]);
      }
    }
    __syncthreads();  // every warp is done with stage st before its refill
  }
  tc::cp_async_wait<0>();  // nothing in flight at exit (no q tile at all)

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t key = key0 + 8 * i;
    if (key >= p.sk) continue;
    const int64_t off = b * p.sk * kv_stride + key * kv_stride + kvh * D;
    bf16* dkp = static_cast<bf16*>(p.dk) + off;
    bf16* dvp = static_cast<bf16*>(p.dv) + off;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      *reinterpret_cast<uint32_t*>(dkp + j * 8 + 2 * t) =
          tc::pack_bf16(dk[j][2 * i], dk[j][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dvp + j * 8 + 2 * t) =
          tc::pack_bf16(dv[j][2 * i], dv[j][2 * i + 1]);
    }
  }
}

template <int D, bool DKV>
int launch_tc(const Params& p, int64_t batch, cudaStream_t stream) {
  // Rows are copied and written as 16-byte pieces.
  const void* ptrs[] = {p.q, p.k, p.v, p.dout, DKV ? p.dk : p.dq,
                        DKV ? p.dv : p.dq};
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16)
      return static_cast<int>(cudaErrorMisalignedAddress);
  const int64_t tiles = ((DKV ? p.sk : p.sq) + BLOCK_ROWS - 1) / BLOCK_ROWS;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(DKV ? p.h_kv : p.h),
                  static_cast<unsigned>(batch), static_cast<unsigned>(tiles));
  return start(DKV ? flash_bwd_dkv_tc_kernel<D> : flash_bwd_dq_tc_kernel<D>,
               grid, TC_THREADS,
               DKV ? dkv_tc_smem_bytes<D>() : dq_tc_smem_bytes<D>(), p,
               stream);
}

template <bool DKV>
int dispatch(const Params& p, int64_t batch, int64_t d, int dtype,
             cudaStream_t s) {
  if (dtype == 0 && d == 64) return launch<64, DKV>(p, batch, s);
  if (dtype == 0 && d == 128) return launch<128, DKV>(p, batch, s);
  if (dtype == 1 && d == 64) return launch_tc<64, DKV>(p, batch, s);
  if (dtype == 1 && d == 128) return launch_tc<128, DKV>(p, batch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; d: 64 or 128. flash_bwd_dq writes dq;
// flash_bwd_dkv writes dk and dv. The other output pointers are not read.
#define FLASH_BWD_ARGS                                                       \
  const void *q, const void *k, const void *v, const void *dout,            \
      const float *lse, const float *delta, void *dq, void *dk, void *dv,   \
      int64_t batch, int64_t sq, int64_t sk, int64_t h, int64_t h_kv,       \
      int64_t d, float sm_scale, int causal, int dtype, void *stream

extern "C" int flash_bwd_dq(FLASH_BWD_ARGS) {
  if (batch == 0 || sq == 0 || h == 0) return 0;
  const Params p{q, k, v, dout, lse, delta, dq, dk, dv,
                 sq, sk, h, h_kv, sm_scale, causal};
  return dispatch<false>(p, batch, d, dtype,
                         static_cast<cudaStream_t>(stream));
}

extern "C" int flash_bwd_dkv(FLASH_BWD_ARGS) {
  if (batch == 0 || sk == 0 || h_kv == 0) return 0;
  const Params p{q, k, v, dout, lse, delta, dq, dk, dv,
                 sq, sk, h, h_kv, sm_scale, causal};
  return dispatch<true>(p, batch, d, dtype,
                        static_cast<cudaStream_t>(stream));
}
