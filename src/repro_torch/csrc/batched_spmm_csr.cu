// Batched CSR SpMM — the paper's batched SWA-SpMM for CSR (row split, no
// atomics) on flat CSR arrays:
//   C[s, r, :] = sum_{k < rlen[r]}
//                val[s, rpt[r] + k] * B[s, cid[s, rpt[r] + k], :].
//
// Replaces the TPU kernel src/repro/kernels/batched_spmm_csr.py
// (batched_spmm_csr / _kernel, the pallas_csr registry entry), which ran a
// masked loop of max(rlen) steps per matrix over every row at once.
//
// What bounds it on an H100: bytes. Each slot is two 4-byte loads and one
// FMA per column, far below the ridge. The call must move
// batch * ((m_pad + 1) * 4 + nnz * 8 + 2 * m_pad * n_b * 4) bytes: the row
// pointers, each real slot's id and value, B read once and C written once.
// At the main-path shapes (200-512 matrices of 56 rows) that is 1.7-4.4 us
// of HBM time, about the cost of a launch, so what bounds it in practice is
// latency: the chain of loads a row waits on (row pointers, then ids and
// values, then B) and how many gathers each warp has in flight.
//
// Design: the row split of the ELL, hybrid and COO kernels, with B read
// where it lies (through the read-only cache; B is L2-resident at every
// size the port runs). The grid is (batch, row blocks, column panels of at
// most 128 columns). A block of 256 threads owns rows [r0, r1) of one
// matrix, whose slots are the one contiguous range rpt[r0]..rpt[r1]: it
// reads the rows' pointers once, then copies the range's column ids and
// values into shared memory once (cp.async for 4-byte ids and f32 values;
// int16 ids, bf16 values and int8 codes by coalesced loads widened to int
// and f32), in runs of at most kRunMax slots. A sub-warp of sub <= 32
// lanes covers the panel, four neighbouring columns a lane (one 16-byte
// f32 or 8-byte bf16 gather where n_b is a multiple of 4: two rows a warp
// at n_b 64). With more rows than sub-warps, each sub-warp owns the rows
// whose slots start in its equal share of the block's slots, as in the COO
// kernel (a hub row alone, short rows many to a sub-warp), else one row.
// It walks its slots in order, kSlots at a time with every B gather of the
// chunk (and, for vector edges, its edges' values) issued before its FMAs
// (a chunk may span several short rows), and stores each row once when
// the walk passes its end, a row of no slot as 0.0. No row is split across
// sub-warps. The kernel keeps to 64 registers (four blocks an SM): chunks
// of 8 spilled there and took 2-10% longer at every Tox21 row on one H100
// 80GB HBM3 at 700 W (scripts/fused_compare.py rows, both in one call).
// A matrix takes one row block where the batch alone has a block for
// every SM (a Tox21 wave's 512 matrices, a training batch's 200), else as
// many as one wave of the card holds (the 2 x 9,000 of case 3: about 260
// each). Against the design it replaced, in turns on one H100 80GB HBM3
// at 700.00 W (scripts/fused_compare.py): Tox21 training 0.0047 -> 0.0043
// ms, serving 0.0084 -> 0.0063 (ELL's 0.0071), R-GCN Reaction100 0.0670
// -> 0.0331, powerlaw 0.0970 -> 0.0393, 2 x 9,000 0.0277 -> 0.0159.
//
// Reduced-precision entries, the reference kernel's other operand branches
// (_kernel :58: int16 col_ids widened on load (:67), bf16 values and B,
// int8 codes with a per-matrix f32 scale applied once to the accumulator,
// :101-105): one template over the value type V, the dense type D, the
// column-id type I and kScale (rpt stays int32, as in the reference).
// batched_spmm_csr_bf16 gathers a bf16 B, sums the widened products in an
// f32 register and rounds each output once (round to nearest even);
// batched_spmm_csr_i8 reads int8 codes against an f32 B and multiplies the
// f32 sum by scale[s] before the store. Both take int16 column ids, or
// int32 ones (ids32) for m_pad past int16's range.
//
// g-SpMM entry (batched_gspmm_csr_f32), the reference kernel's (op, reduce)
// branches: C[s, r] = reduce_{rpt[r] <= k < rpt[r+1]} op(B[s, cid[k]], e_k),
// op in {mul, add, copy_lhs}, reduce in {sum, max, mean}, scalar edges
// (batch, nnz_pad) (staged beside the ids) or vector edges (batch,
// nnz_pad, n_b) in the CSR sort order (read per slot, four columns a lane,
// beside B). One template instance per reduce. The message and the add are
// rounded apart (__fmul_rn, __fadd_rn), as PyTorch rounds them (the design
// this one replaced let nvcc fuse them into an FMA in some unrolled slots
// and not in others, so its (mul, sum | mean) bits are not reproduced);
// the sum starts at 0.0, max at the finite -3e38 (fmaxf, exact in any
// order); the store writes 0.0 into an empty row for max and divides by
// max(rpt[r+1] - rpt[r], 1) for mean (div_count: the IEEE quotient without
// the division's slow path, which made the mean corner 4x slower).
//
// The same entries run paper case 3, where the reference takes its plain
// per-sample path (src/repro/kernels/ops.py _csr_forward): the wrappers
// batched_spmm_csr_large* launch them and count the launch apart. They
// also run the pallas_hybrid and pallas_hybrid_bf16 impls at case 3 (the
// reference's plain COO sum there) and the CSR-class backward of both.
#include "common.cuh"
#include "gemm_tile.cuh"

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = 4;        // slots whose gathers issue together
constexpr int kRunMax = 4096;    // slots staged at a time: 32 KB
constexpr int kRowsMax = 256;    // a block's rows
constexpr int kSpmm = -1;        // kR of the (mul, sum) entries
constexpr int kMinBlocks = 4;    // blocks an SM: at most 64 registers

using repro::kW;

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<std::uintptr_t>(p) % bytes == 0;
}

// The shapes one launch shares with its blocks.
struct Shape {
  int m_pad, nnz_pad, n_b, panel, sub, vec;
  int block_rows;   // rows a block owns
  int run;          // slots staged at a time
  int vals;         // whether the values are staged (not: copy_lhs, vector
                    // edges)
  int op, vec_edges;  // g-SpMM only
};

// Shared memory: the rows' pointers, then a run's column ids and values.
size_t smem_bytes(int rows, int run, bool vals) {
  return (static_cast<size_t>(rows) + 1 + run * (vals ? 2 : 1)) * 4;
}
static_assert((kRowsMax + 1 + 2 * kRunMax) * 4 <= 48 * 1024,
              "a block's rows and run outgrow the default shared memory");

// n elements of src (widened) into dst: cp.async for 4-byte elements, else
// loads and stores; the caller commits, waits and passes a barrier.
__device__ __forceinline__ void stage(int* dst, const int* src, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads)
    repro::gemm::cp4(dst + i, src + i, 4);
}
__device__ __forceinline__ void stage(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads)
    repro::gemm::cp4(dst + i, src + i, 4);
}
template <typename T, typename S>
__device__ __forceinline__ void stage(T* dst, const S* src, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    if constexpr (std::is_same_v<T, int>)
      dst[i] = repro::ldi(src + i);
    else
      dst[i] = repro::ldv(src + i);
  }
}

// The identity of reduce kR (the sums: 0.0; max: the finite -3e38).
template <int kR>
__host__ __device__ constexpr float identity() {
  return kR == repro::kMax ? repro::kNegInf : 0.f;
}

// kR: the g-SpMM entry's reduce (V, D float, I int), or kSpmm: (mul, sum).
template <int kR, typename V, typename D, typename I, bool kScale>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
csr_kernel(const int* __restrict__ rpt, const I* __restrict__ cid,
           const V* __restrict__ val, const float* __restrict__ scale,
           const D* __restrict__ b, D* __restrict__ c, Shape sh) {
  extern __shared__ __align__(16) int csr_smem[];
  constexpr bool kG = kR != kSpmm;
  const int s = blockIdx.x;
  const int row0 = blockIdx.y * sh.block_rows;
  const int rows = min(sh.block_rows, sh.m_pad - row0);
  const int col0 = blockIdx.z * sh.panel;
  const int nbw = min(sh.panel, sh.n_b - col0);
  const int lane = threadIdx.x % sh.sub, g = threadIdx.x / sh.sub;
  const int groups = kThreads / sh.sub;
  const int cc = kW * lane;   // this lane's columns of the panel
  const bool mine = cc < nbw;
  const size_t mat = static_cast<size_t>(s) * sh.m_pad;
  const size_t off = static_cast<size_t>(s) * sh.nnz_pad;
  int* rp = csr_smem;                       // rows + 1 pointers, as given
  int* sc = rp + sh.block_rows + 1;         // a run's column ids
  float* sv = reinterpret_cast<float*>(sc + sh.run);  // and values

  // a matrix's first row block copies its first run of slots beside its
  // row pointers, not after them, where the copy is asynchronous (4-byte
  // ids and values; a load-and-store copy would hold the pointers back):
  // its slots start at slot 0 wherever rpt[0] is 0, as a CSR's is (else
  // that copy is drained and redone)
  const bool early = sizeof(I) == 4 && sizeof(V) == 4 && row0 == 0;
  if (early) {
    stage(sc, cid + off, min(sh.run, sh.nnz_pad));
    if (sh.vals) stage(sv, val + off, min(sh.run, sh.nnz_pad));
    repro::gemm::cp_commit();
  }
  const int* rps = rpt + static_cast<size_t>(s) * (sh.m_pad + 1) + row0;
  for (int t = threadIdx.x; t <= rows; t += kThreads) rp[t] = __ldg(rps + t);
  __syncthreads();
  // the block's slots [base, end); row t's [start(t), start(t + 1)), the
  // pointers clamped into it (a row's pointers as given where they are
  // ordered, as a CSR's are)
  const int base = min(max(rp[0], 0), sh.nnz_pad);
  const int end = max(min(max(rp[rows], 0), sh.nnz_pad), base);
  const auto start = [&](int t) { return min(max(rp[t], base), end); };
  // sub-warp g's rows [lo, hi): row g, or, with more rows than sub-warps,
  // the rows whose slots start in its equal share of the block's slots
  int lo = min(g, rows), hi = min(g + 1, rows);
  if (rows > groups) {
    const int total = end - base;
    const auto first_row = [&](int t) {   // first row starting at or past t
      int a = 0, z = rows;
      while (a < z) {
        const int mid = (a + z) / 2;
        if (start(mid) - base >= t)
          z = mid;
        else
          a = mid + 1;
      }
      return a;
    };
    lo = first_row((g * total + groups - 1) / groups);
    hi = g + 1 < groups
             ? first_row(((g + 1) * total + groups - 1) / groups)
             : rows;
  }
  const int k_lo = start(lo), k_hi = start(hi);
  const D* bsrc = b + mat * sh.n_b + col0;
  D* dst = c + (mat + row0) * sh.n_b + col0;
  const float sc_s = kScale ? __ldg(scale + s) : 1.f;

  float acc[kW];
#pragma unroll
  for (int i = 0; i < kW; ++i) acc[i] = identity<kR>();
  int r = lo;
  // row r's sum to C (finished for the reduce, scaled for i8), acc back to
  // the identity
  const auto store_row = [&]() {
    if constexpr (kR == repro::kMax || kR == repro::kMean) {
      const int deg = rp[r + 1] - rp[r];
#pragma unroll
      for (int i = 0; i < kW; ++i)
        acc[i] = kR == repro::kMax ? (deg > 0 ? acc[i] : 0.f)
                                   : repro::div_count(acc[i], max(deg, 1));
    }
    if constexpr (kScale) {
#pragma unroll
      for (int i = 0; i < kW; ++i) acc[i] *= sc_s;
    }
    repro::store_cols(dst + static_cast<size_t>(r) * sh.n_b + cc, acc,
                      sh.vec, nbw - cc);
#pragma unroll
    for (int i = 0; i < kW; ++i) acc[i] = identity<kR>();
    ++r;
  };

  for (int k0 = base; k0 < end; k0 += sh.run) {
    const int len = min(sh.run, end - k0);
    if (!early || k0 != 0) {
      if (early || k0 > base) {   // the early copy landed, the last run read
        repro::gemm::cp_wait<0>();
        __syncthreads();
      }
      stage(sc, cid + off + k0, len);
      if (sh.vals) stage(sv, val + off + k0, len);
      repro::gemm::cp_commit();
    }
    repro::gemm::cp_wait<0>();
    __syncthreads();
    if (!mine) continue;
    const int w1 = min(k_hi, k0 + len);
    for (int kb = max(k_lo, k0); kb < w1; kb += kSlots) {
      int j[kSlots];
      float v[kSlots];
#pragma unroll
      for (int q = 0; q < kSlots; ++q) {
        const bool in = kb + q < w1;
        j[q] = in ? sc[kb + q - k0] : -1;
        v[q] = in && sh.vals ? sv[kb + q - k0] : 0.f;
      }
      // every gather of the chunk (and, for vector edges, its edges'
      // values) before its FMAs
      float x[kSlots][kW];
      float e[kG ? kSlots : 1][kW];
#pragma unroll
      for (int q = 0; q < kSlots; ++q) {
        if (static_cast<unsigned>(j[q]) >= static_cast<unsigned>(sh.m_pad))
          continue;
        repro::load_cols(bsrc + static_cast<size_t>(j[q]) * sh.n_b + cc,
                         sh.vec, nbw - cc, x[q]);
        if constexpr (kG) {
          if (sh.vec_edges && sh.op != repro::kOpCopyLhs)
            repro::load_cols(
                val + (off + kb + q) * sh.n_b + col0 + cc, sh.vec, nbw - cc,
                e[q]);
          else
#pragma unroll
            for (int i = 0; i < kW; ++i) e[q][i] = v[q];
        }
      }
#pragma unroll
      for (int q = 0; q < kSlots; ++q) {
        if (kb + q >= w1) break;
        while (r < hi - 1 && kb + q >= start(r + 1)) store_row();
        if (static_cast<unsigned>(j[q]) >= static_cast<unsigned>(sh.m_pad))
          continue;
#pragma unroll
        for (int i = 0; i < kW; ++i) {
          if constexpr (kG) {
            const float u = x[q][i], ev = e[q][i];
            const float m = sh.op == repro::kOpMul   ? __fmul_rn(u, ev)
                            : sh.op == repro::kOpAdd ? __fadd_rn(u, ev)
                                                     : u;
            acc[i] = kR == repro::kMax ? fmaxf(acc[i], m)
                                       : __fadd_rn(acc[i], m);
          } else {
            acc[i] = fmaf(v[q], x[q][i], acc[i]);
          }
        }
      }
    }
  }
  if (mine)
    while (r < hi) store_row();
  repro::gemm::cp_wait<0>();   // an early copy of a block with no slot
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  return sms;
}

// The launch: panels of at most kPanelMax columns, sub = lanes for the
// panel's columns kW at a time; row blocks of equal size, at most kRowsMax
// rows: one a matrix and panel where those alone are at least one a SM,
// else as many as fit one wave of the card.
template <int kR, typename V, typename D, typename I, bool kScale>
int launch(const int* rpt, const void* cid, const void* val,
           const float* scale, const void* b, void* c, int batch, int m_pad,
           int nnz_pad, int n_b, int n_block, int op, int vec_edges,
           void* stream) {
  if (n_block < 1 || nnz_pad < 0 || m_pad < 1) return cudaErrorInvalidValue;
  const int panel = min(n_block, repro::kPanelMax);
  const int panels = (n_b + panel - 1) / panel;
  const int sub = repro::sub_warp((panel + kW - 1) / kW);
  const size_t cols = kW * sizeof(D);
  const int vec = n_b % kW == 0 && panel % kW == 0 && aligned(b, cols) &&
                  aligned(c, cols) && (!vec_edges || aligned(val, cols));
  const bool vals = kR == kSpmm || (!vec_edges && op != repro::kOpCopyLhs);
  const int run = max(1, min(nnz_pad, kRunMax));
  auto kernel = csr_kernel<kR, V, D, I, kScale>;
  // as many row blocks a matrix as the card holds at once by the kernel's
  // registers (one wave), at least ceil(m_pad / kRowsMax)
  static int resident = 0;
  if (resident == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident, kernel, kThreads, 0);
    if (e != cudaSuccess) return e;
    resident = max(resident, 1);
  }
  const long long wave = static_cast<long long>(sm_count()) * resident;
  const long long mats = static_cast<long long>(batch) * panels;
  const long long fit = mats >= sm_count() ? 1 : wave / mats;
  const int blocks = static_cast<int>(
      min(static_cast<long long>(m_pad),
          max(fit, static_cast<long long>((m_pad + kRowsMax - 1) /
                                          kRowsMax))));
  if (blocks > 65535) return cudaErrorInvalidValue;
  const int rows = (m_pad + blocks - 1) / blocks;   // equal row blocks
  const Shape sh{m_pad, nnz_pad, n_b, panel, sub, vec, rows, run,
                 static_cast<int>(vals), op, vec_edges};
  kernel<<<dim3(batch, (m_pad + rows - 1) / rows, panels), kThreads,
           smem_bytes(rows, run, vals), static_cast<cudaStream_t>(stream)>>>(
      rpt, static_cast<const I*>(cid), static_cast<const V*>(val), scale,
      static_cast<const D*>(b), static_cast<D*>(c), sh);
  return cudaGetLastError();
}

}  // namespace

// n_block is capped at 128 columns a block.
extern "C" int batched_gspmm_csr_f32(const int* rpt, const int* cid,
                                     const float* val, const float* b,
                                     float* c, int batch, int m_pad,
                                     int nnz_pad, int n_b, int n_block,
                                     int op, int reduce, int vec,
                                     void* stream) {
  const auto go = [&](auto red) {
    return launch<decltype(red)::value, float, float, int, false>(
        rpt, cid, val, nullptr, b, c, batch, m_pad, nnz_pad, n_b, n_block, op,
        vec, stream);
  };
  if (reduce == repro::kSum)
    return go(std::integral_constant<int, repro::kSum>{});
  if (reduce == repro::kMax)
    return go(std::integral_constant<int, repro::kMax>{});
  if (reduce == repro::kMean)
    return go(std::integral_constant<int, repro::kMean>{});
  return cudaErrorInvalidValue;
}

extern "C" int batched_spmm_csr_f32(const int* rpt, const int* cid,
                                    const float* val, const float* b,
                                    float* c, int batch, int m_pad,
                                    int nnz_pad, int n_b, int n_block,
                                    void* stream) {
  return launch<kSpmm, float, float, int, false>(
      rpt, cid, val, nullptr, b, c, batch, m_pad, nnz_pad, n_b, n_block, 0, 0,
      stream);
}

// cid (batch, nnz_pad) int16 (int32 with ids32 = 1), val bf16, b and c
// (batch, m_pad, n_b) bf16
extern "C" int batched_spmm_csr_bf16(const int* rpt, const void* cid,
                                     const void* val, const void* b, void* c,
                                     int batch, int m_pad, int nnz_pad,
                                     int n_b, int n_block, int ids32,
                                     void* stream) {
  using B = __nv_bfloat16;
  return ids32 ? launch<kSpmm, B, B, int, false>(rpt, cid, val, nullptr, b, c,
                                                 batch, m_pad, nnz_pad, n_b,
                                                 n_block, 0, 0, stream)
               : launch<kSpmm, B, B, short, false>(
                     rpt, cid, val, nullptr, b, c, batch, m_pad, nnz_pad, n_b,
                     n_block, 0, 0, stream);
}

// cid int16 (int32 with ids32 = 1), val int8 codes, scale (batch,) f32, b
// and c f32
extern "C" int batched_spmm_csr_i8(const int* rpt, const void* cid,
                                   const void* val, const float* scale,
                                   const float* b, float* c, int batch,
                                   int m_pad, int nnz_pad, int n_b,
                                   int n_block, int ids32, void* stream) {
  using S = signed char;
  return ids32 ? launch<kSpmm, S, float, int, true>(
                     rpt, cid, val, scale, b, c, batch, m_pad, nnz_pad, n_b,
                     n_block, 0, 0, stream)
               : launch<kSpmm, S, float, short, true>(
                     rpt, cid, val, scale, b, c, batch, m_pad, nnz_pad, n_b,
                     n_block, 0, 0, stream);
}
