// Batched COO SpMM — the paper's batched SWA-SpMM for SparseTensor (the
// slots of a matrix in any order), C[s, rid] += val * B[s, cid, :].
//
// Replaces the TPU kernel src/repro/kernels/batched_spmm_coo.py
// (batched_spmm_coo / _kernel, the pallas_coo registry entry), whose
// one-hot MXU contraction stood in for the atomics a TPU lacks.
//
// What bounds it on an H100: bytes, as for the ELL kernel (~1 FMA per 8
// bytes of ids and values). At the main-path shape (512 matrices of 56
// rows, nnz_pad 256, n_b 64) the call moves ~16 MB, ~5 us of HBM time:
// about the cost of one launch, so what bounds it in practice is latency,
// how many independent loads each warp has in flight.
//
// Design: bucket the slots by row in shared memory, then own rows, as the
// CSR, hybrid and ELL kernels do, with B read where it lies (through the
// read-only cache; L2-resident at every size the port runs). A block of
// 256 threads owns some rows of one matrix; sub lanes (a sub-warp) cover a
// panel of at most 128 columns, four neighbouring columns a lane (16-byte
// f32 or 8-byte bf16 loads where n_b allows). It reads its matrix's slot
// stream in runs of up to kRunMax slots (all of it in one run at every
// main-path shape) and buckets the live slots of its rows:
// - each warp takes a contiguous share of the run and counts its slots per
//   (row, warp): in one step of 32 slots by __match_any_sync, the lanes
//   keeping their slots in registers (streams up to 256 slots), else with
//   integer shared atomics (a count is the same in any order);
// - one exclusive scan over the (row, warp) counts gives where each
//   (row, warp) share starts, so a row's slots lie in warp order;
// - each warp places its slots in order, 32 a step, each at its (row,
//   warp) cursor plus its rank among the step's slots of its row
//   (__match_any_sync), then the step's last such lane moves the cursor:
//   every row's slots land in increasing slot index, whatever the order of
//   the stream (the dB / dU calls swap the ids, so their rows come in
//   column order).
// The one-step count, which reads each slot once and places it from
// registers, pays: with every share through the atomic count instead
// (scripts/fused_compare.py, the two in turns on one H100 80GB HBM3 at
// 700 W) Tox21 serving took 0.0070-0.0071 ms against 0.0065, bf16
// 0.0075-0.0076 against 0.0068-0.0069, and dU at Tox21 training 0.0053
// against 0.0049.
// Then each sub-warp walks its rows' bucketed slots in order, kSlots at a
// time with all their B gathers issued before their FMAs, and stores each
// row once when the walk passes its end (a row with no live slot stores
// 0.0). The sum stays in f32 registers from 0.0 in increasing slot index,
// one fmaf chain per output. No float atomics: the result is the same
// bits from run to run and whatever the block split.
//
// The split. Where the stream fits one run (its own template instance:
// with the bucket's operands dead during the walk it fits the 64
// registers of four blocks an SM without spilling), a block buckets it
// once, owns as many rows as leave about kBlocksPerSm blocks an SM (the
// whole matrix at Tox21: 512 and 200 blocks; ~43 rows of the powerlaw
// batch's 256) and walks every column panel itself; a sub-warp owns one
// row, or, with more rows than sub-warps, the rows whose slots start in
// its equal share of the block's slots (a hub row alone, short rows many
// to a sub-warp). A longer stream takes one row a sub-warp, one column
// panel a block, and buckets each run again, the sums carried in
// registers from run to run. On one H100 80GB HBM3 at 700 W
// (scripts/fused_compare.py) the first version of this design (one row a
// sub-warp, four row blocks a matrix, 111 registers: two blocks an SM)
// took 0.0186 ms at Tox21; this one 0.0065, against the atomic kernel's
// 0.0130 and torch.bmm's 0.0095.
//
// A slot whose value is 0.0 (padding) adds nothing, as in the ELL and
// fused kernels: it would add fmaf(0, b, acc) == acc for a finite b. Row
// ids outside [0, m_pad) (the m_pad sentinel the reference's scatter
// drops) and column ids outside it add nothing either.
//
// bf16 entry (batched_spmm_coo_bf16), the reference kernel's other operand
// branches (_kernel :51: int16 row and column ids widened on load (:61),
// bf16 values and B): one template over the value type V, the dense type D
// and the id type I. Values are widened as they are bucketed, B rows are
// read as bf16, the sums stay f32 and each output is rounded to bf16 once
// (__float2bfloat16_rn). It runs the pallas_coo_bf16 forward and dB / dU
// of the pallas_ell_bf16 and fused_bf16 backwards. The m_pad row-id
// sentinel fits int16 because the wrapper's narrowing refuses
// m_pad > 32767.
//
// g-SpMM entry (batched_gspmm_coo_f32), the reference kernel's (op, reduce)
// branches: C[s, r] = reduce_{i < nnz[s], rid[i] = r} op(B[s, cid[i]], e_i)
// with op in {mul, add, copy_lhs}, reduce in {sum, max, mean}, and scalar
// edges e (batch, nnz_pad) or vector edges (batch, nnz_pad, n_b), read per
// slot per column (the bucket holds the slot index). Padding is not inert
// by value outside (mul, sum), so slots at or past nnz[s] are masked
// instead of skipping 0.0 values. One template instance per reduce: sum
// and mean add each message in slot order (the message and the add
// rounded apart, as the plain version rounds them), max takes fmaxf from
// the finite -3e38 (exact in any order, so max corners equal the plain
// version bit for bit). For max and mean the block also counts each of
// its rows' degree: every slot below nnz[s] whose row id, clipped into
// [0, m_pad) as the reference's wrapper does, is that row, the slots with
// out-of-range ids among them; mean divides by max(deg, 1) and max writes
// 0.0 into rows of degree 0.
//
// Large-matrix entries (batched_spmm_coo_large_{f32,bf16},
// batched_gspmm_coo_large_f32), for paper case 3, where the reference takes
// its plain per-sample path (src/repro/kernels/ops.py _forward_base): a
// matrix's stream (~600 KB at 9,000 rows) is far larger than a run, and a
// row block bucketing all of it would read it once per row block. They
// keep the global-atomic design: the output accumulates in global memory,
// in an f32 buffer the wrapper fills (torch.zeros; -3e38 for max), with
// global atomicAdd (sum, mean) or a compare-and-swap float max, over a grid
// of (batch, slot blocks, column panels of at most 128 columns). The
// degrees of the g-SpMM entry count into a zeroed global (batch, m_pad)
// int32 buffer, once per slot (panel 0 only). A second pass then finishes
// each element: the mean / empty-max fix-up, and the one rounding to bf16
// for the bf16 entry (whose ids may also be int32, ids32, past int16's
// range). The float atomics make the last bits of their sums vary from run
// to run; they are held to the f32 tolerance.
#include "common.cuh"

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / repro::kWarp;
constexpr int kMinBlocks = 4;    // blocks an SM: at most 64 registers
constexpr int kSlots = 4;        // slots whose gathers issue together
constexpr int kRunMax = 4096;    // slots bucketed at a time: 32 KB
constexpr int kRowsMax = 256;    // a block's rows when bucketed at once
constexpr int kBlocksPerSm = 2;  // the row blocks' target when bucketed once
constexpr int kSpmm = -1;        // kR of the (mul, sum) entries

using repro::kW;

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<std::uintptr_t>(p) % bytes == 0;
}

// The shapes one launch shares with its blocks.
struct Shape {
  int nnz_pad, m_pad, n_b, panel, sub, run, vec;
  int op, vec_edges;           // g-SpMM only
  int block_rows;              // rows a block owns
};

// Shared memory: (block_rows x kWarps) counts, then the scan's per-warp
// totals, the rows' degrees (g-SpMM), and a run's bucketed column ids and
// values (or, for vector edges, slot indices).
__host__ __device__ constexpr size_t smem_bytes(int rows, int run) {
  return (static_cast<size_t>(rows) * kWarps + kWarps + rows +
          2 * static_cast<size_t>(run)) * sizeof(int);
}
// every launch fits the 48 KB a block takes without opting in to more
static_assert(smem_bytes(kRowsMax, kRunMax) <= 48 * 1024,
              "a block's rows and run outgrow the default shared memory");

// Slot i of matrix s as the block's bucket sees it: lr, its row in the
// block (-1 where the slot adds nothing to the block's rows), the column id
// and the value (g-SpMM vector edges: the slot index, as float bits), and
// for g-SpMM cr, the block row its degree counts it in (-1: none): every
// slot below n (the matrix's nnz) by its row id clipped into [0, m_pad),
// while slots at or past n are masked.
template <int kR, typename V, typename I>
__device__ __forceinline__ int read_slot(const I* rid, const I* cid,
                                         const V* val, size_t off, int i,
                                         bool in, int n, int row0, int rows,
                                         const Shape& sh, int* j, float* v,
                                         int* cr) {
  *j = 0, *v = 0.f, *cr = -1;
  if (!in) return -1;
  const int r = repro::ldi(rid + off + i);
  *j = repro::ldi(cid + off + i);
  bool live = static_cast<unsigned>(*j) < static_cast<unsigned>(sh.m_pad);
  if constexpr (kR != kSpmm) {
    if (i >= n) return -1;
    const int c = min(max(r, 0), sh.m_pad - 1) - row0;
    *cr = static_cast<unsigned>(c) < static_cast<unsigned>(rows) ? c : -1;
    *v = sh.vec_edges ? __int_as_float(i)
         : (sh.op == repro::kOpCopyLhs ? 0.f : repro::ldv(val + off + i));
  } else {
    *v = repro::ldv(val + off + i);
    live = live && *v != 0.f;   // padding
  }
  const int lr = r - row0;
  return live && static_cast<unsigned>(lr) < static_cast<unsigned>(rows)
             ? lr : -1;
}

// Bucket the slots [b0, b0 + len) of matrix s (below n for g-SpMM) that
// land in the block's rows [row0, row0 + rows): afterwards
// ends[lr * kWarps + kWarps - 1] is where row lr's slots end in bcol / bval
// (they start where row lr - 1's end), in increasing slot index. Counts
// the degrees into deg when it is not null (zeroed first at b0 0).
// Barriers at both ends (at the start only where an earlier bucket of the
// block, not `fresh`, may still be read).
template <int kR, typename V, typename I>
__device__ __forceinline__ void bucket(const I* rid, const I* cid,
                                       const V* val, size_t off, int b0,
                                       int len, int n, int row0, int rows,
                                       bool fresh, const Shape& sh,
                                       int* ends, int* ws, int* deg,
                                       int* bcol, float* bval) {
  const int warp = threadIdx.x / repro::kWarp;
  const int wl = threadIdx.x % repro::kWarp;
  const unsigned below = (1u << wl) - 1u;
  // each warp's contiguous share, whole steps of 32 slots
  const int share = ((len + kWarps - 1) / kWarps + repro::kWarp - 1) /
                    repro::kWarp * repro::kWarp;
  const int lo = b0 + warp * share, hi = min(lo + share, b0 + len);
  // a share of one step (a run of at most 256 slots, every main-path
  // matrix but the powerlaw one): each lane reads its slot once, before
  // the barrier, and places it from registers
  const bool one = share <= repro::kWarp;
  int j1, c1;
  float v1;
  const int l1 = one ? read_slot<kR>(rid, cid, val, off, lo + wl,
                                     lo + wl < hi, n, row0, rows, sh, &j1,
                                     &v1, &c1)
                     : -1;
  if (!fresh) __syncthreads();   // the last run's buckets are read
  for (int i = threadIdx.x; i < rows * kWarps; i += kThreads) ends[i] = 0;
  if (deg != nullptr && b0 == 0)
    for (int i = threadIdx.x; i < rows; i += kThreads) deg[i] = 0;
  __syncthreads();
  unsigned p1 = 0;
  if (one) {
    if (deg != nullptr && c1 >= 0) atomicAdd(deg + c1, 1);
    p1 = __match_any_sync(0xffffffffu, l1);
    if (l1 >= 0 && wl == 31 - __clz(p1))
      ends[l1 * kWarps + warp] = __popc(p1);
  } else {
    for (int base = lo; base < hi; base += repro::kWarp) {
      const int i = base + wl;
      int j, c;
      float v;
      const int lr = read_slot<kR>(rid, cid, val, off, i, i < hi, n, row0,
                                   rows, sh, &j, &v, &c);
      if (deg != nullptr && c >= 0) atomicAdd(deg + c, 1);
      if (lr >= 0) atomicAdd(ends + lr * kWarps + warp, 1);
    }
  }
  __syncthreads();
  repro::exclusive_scan<kThreads>(ends, rows * kWarps, ws);
  __syncthreads();
  // each step of 32: a slot goes to its (row, warp) cursor plus its rank
  // among the step's slots of its row, then the cursor moves on
  const auto place = [&](int lr, int j, float v, unsigned peers) {
    if (lr >= 0) {
      const int pos = ends[lr * kWarps + warp] + __popc(peers & below);
      bcol[pos] = j;
      bval[pos] = v;
    }
    __syncwarp();
    if (lr >= 0 && wl == 31 - __clz(peers))
      ends[lr * kWarps + warp] += __popc(peers);
    __syncwarp();
  };
  if (one) {
    place(l1, j1, v1, p1);
  } else {
    for (int base = lo; base < hi; base += repro::kWarp) {
      const int i = base + wl;
      int j, c;
      float v;
      const int lr = read_slot<kR>(rid, cid, val, off, i, i < hi, n, row0,
                                   rows, sh, &j, &v, &c);
      place(lr, j, v, __match_any_sync(0xffffffffu, lr));
    }
  }
  __syncthreads();
}

// Where row r's bucketed slots start and end (r == rows: the end of all).
__device__ __forceinline__ int row_start(const int* ends, int r) {
  return r ? ends[r * kWarps - 1] : 0;
}
__device__ __forceinline__ int row_end(const int* ends, int r) {
  return ends[r * kWarps + kWarps - 1];
}

// The first of the block's rows whose slots start at or past slot t.
__device__ __forceinline__ int first_row(const int* ends, int rows, int t) {
  int lo = 0, hi = rows;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (row_start(ends, mid) >= t)
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo;
}

// What a sub-warp's walk over its rows needs besides the bucket.
template <typename V, typename D>
struct Walk {
  const D* bsrc;   // B's panel of this matrix
  D* dst;          // C's panel at the block's first row
  const V* val;    // vector edges (g-SpMM)
  const int* deg;  // the block's rows' degrees (g-SpMM)
  size_t off;      // the matrix's first slot
  int col0, cc, nbw;
};

// op(u, e) of a g-SpMM message, rounded once as PyTorch rounds it. The
// message and the sum's add are intrinsics, which the compiler never fuses
// into an FMA: where it fused them in some unrolled slots of the walk and
// not in others, a row's sum took other bits under another block split.
__device__ __forceinline__ float message(float u, float e, int op) {
  if (op == repro::kOpMul) return __fmul_rn(u, e);
  if (op == repro::kOpAdd) return __fadd_rn(u, e);
  return u;
}

// The identity of reduce kR (the sums: 0.0; max: the finite -3e38).
template <int kR>
__host__ __device__ constexpr float identity() {
  return kR == repro::kMax ? repro::kNegInf : 0.f;
}

// Row r's sum (kW columns of this lane) to C, finished for the g-SpMM
// reduce (max: 0.0 where the degree is 0; mean: over max(deg, 1)), then
// acc back to the reduce's identity.
template <int kR, typename V, typename D>
__device__ __forceinline__ void store_row(float (&acc)[kW], int r,
                                          const Walk<V, D>& w,
                                          const Shape& sh) {
  if constexpr (kR == repro::kMax || kR == repro::kMean) {
    const int d = w.deg[r];
#pragma unroll
    for (int i = 0; i < kW; ++i)
      acc[i] = kR == repro::kMax ? (d > 0 ? acc[i] : 0.f)
                                 : repro::div_count(acc[i], d > 1 ? d : 1);
  }
  repro::store_cols(w.dst + static_cast<size_t>(r) * sh.n_b + w.cc, acc,
                    sh.vec, w.nbw - w.cc);
#pragma unroll
  for (int i = 0; i < kW; ++i) acc[i] = identity<kR>();
}

// The bucketed slots [k0, k1), in order, into acc, the sum of row r:
// kSlots at a time (g-SpMM: half as many, with their edges' values beside
// B's rows: at kSlots they spilled registers), every load before the FMAs;
// a slot past row r's end first stores row r (and each row after it that
// has no slot here) and moves r on.
template <int kR, typename V, typename D>
__device__ __forceinline__ void walk(float (&acc)[kW], int& r, int k0,
                                     int k1, const int* ends,
                                     const int* bcol, const float* bval,
                                     const Walk<V, D>& w, const Shape& sh) {
  constexpr int kS = kR == kSpmm ? kSlots : kSlots / 2;
  for (int kb = k0; kb < k1; kb += kS) {
    bool ok[kS];
    int j[kS];
    float v[kS];
#pragma unroll
    for (int q = 0; q < kS; ++q) {
      ok[q] = kb + q < k1;
      j[q] = ok[q] ? bcol[kb + q] : 0;
      v[q] = ok[q] ? bval[kb + q] : 0.f;
    }
    // B's rows and (g-SpMM) the edges' values, all loads before the FMAs
    float x[kS][kW];
    float ev[kR != kSpmm ? kS : 1][kW];
#pragma unroll
    for (int q = 0; q < kS; ++q) {
      if (!ok[q]) continue;
      repro::load_cols(w.bsrc + static_cast<size_t>(j[q]) * sh.n_b + w.cc,
                       sh.vec, w.nbw - w.cc, x[q]);
      if constexpr (kR != kSpmm) {
        if (sh.vec_edges && sh.op != repro::kOpCopyLhs) {
          const size_t slot = w.off + __float_as_int(v[q]);
          repro::load_cols(w.val + slot * sh.n_b + w.col0 + w.cc, sh.vec,
                           w.nbw - w.cc, ev[q]);
        } else {
#pragma unroll
          for (int c = 0; c < kW; ++c) ev[q][c] = v[q];
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kS; ++q) {
      if (!ok[q]) break;
      while (kb + q >= row_end(ends, r)) store_row<kR>(acc, r++, w, sh);
      if constexpr (kR != kSpmm) {
#pragma unroll
        for (int c = 0; c < kW; ++c) {
          const float m = message(x[q][c], ev[q][c], sh.op);
          acc[c] = kR == repro::kMax ? fmaxf(acc[c], m)
                                     : __fadd_rn(acc[c], m);
        }
      } else {
#pragma unroll
        for (int c = 0; c < kW; ++c) acc[c] = fmaf(v[q], x[q][c], acc[c]);
      }
    }
  }
}

// kR: the g-SpMM entry's reduce (V, D float, I int; with nnz), or kSpmm:
// (mul, sum). kOnce: the stream is one run, bucketed before the panels
// (its own instance, so that the walk does not keep the bucket's operands
// live).
template <int kR, bool kOnce, typename V, typename D, typename I>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
coo_kernel(const I* __restrict__ rid, const I* __restrict__ cid,
           const V* __restrict__ val, const int* __restrict__ nnz,
           const D* __restrict__ b, D* __restrict__ c, Shape sh) {
  extern __shared__ __align__(16) int coo_smem[];
  const int s = blockIdx.x;
  const int lane = threadIdx.x % sh.sub, g = threadIdx.x / sh.sub;
  const int groups = kThreads / sh.sub;
  int* ends = coo_smem;
  int* ws = ends + sh.block_rows * kWarps;
  int* deg = ws + kWarps;
  int* bcol = deg + sh.block_rows;
  float* bval = reinterpret_cast<float*>(bcol + sh.run);
  const size_t off = static_cast<size_t>(s) * sh.nnz_pad;
  const size_t mat = static_cast<size_t>(s) * sh.m_pad;
  constexpr bool kG = kR != kSpmm;
  constexpr bool kDeg = kR == repro::kMax || kR == repro::kMean;
  // the stream's length bounds the runs; nnz (g-SpMM) only masks, so that
  // the slots' loads need not wait for it
  const int n = kG ? __ldg(nnz + s) : sh.nnz_pad;
  const int panels = (sh.n_b + sh.panel - 1) / sh.panel;
  const int cc = kW * lane;
  const int row0 = blockIdx.y * sh.block_rows;
  const int rows = min(sh.block_rows, sh.m_pad - row0);
  // sub-warp g owns row g, or, with more rows than sub-warps (one run
  // only), the rows whose slots start in its share of the block's slots
  int lo = min(g, rows), hi = min(g + 1, rows);
  if constexpr (kOnce) {
    bucket<kR>(rid, cid, val, off, 0, sh.nnz_pad, n, row0, rows, true, sh,
               ends, ws, kDeg ? deg : nullptr, bcol, bval);
    if (rows > groups) {
      const int total = row_start(ends, rows);
      lo = first_row(ends, rows, (g * total + groups - 1) / groups);
      hi = g + 1 < groups
               ? first_row(ends, rows, ((g + 1) * total + groups - 1) /
                                           groups)
               : rows;
    }
  }
  for (int p = blockIdx.z; p < panels; p += gridDim.z) {
    const int col0 = p * sh.panel;
    const Walk<V, D> w{b + mat * sh.n_b + col0,
                       c + (mat + row0) * sh.n_b + col0, val, deg, off,
                       col0, cc, min(sh.panel, sh.n_b - col0)};
    const bool mine = cc < w.nbw;
    int r = lo;
    float acc[kW];
#pragma unroll
    for (int i = 0; i < kW; ++i) acc[i] = identity<kR>();
    if constexpr (kOnce) {
      if (mine)
        walk<kR>(acc, r, row_start(ends, lo), row_start(ends, hi), ends,
                 bcol, bval, w, sh);
    } else {
      const bool first = p == static_cast<int>(blockIdx.z);
      for (int b0 = 0; b0 < sh.nnz_pad; b0 += sh.run) {
        // the degrees in the block's first panel only
        bucket<kR>(rid, cid, val, off, b0, min(sh.run, sh.nnz_pad - b0), n,
                   row0, rows, first && b0 == 0, sh, ends, ws,
                   kDeg && first ? deg : nullptr, bcol, bval);
        if (mine)
          walk<kR>(acc, r, row_start(ends, lo), row_start(ends, hi), ends,
                   bcol, bval, w, sh);
      }
    }
    if (mine)
      while (r < hi) store_row<kR>(acc, r++, w, sh);
  }
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

// The launch: panels of at most kPanelMax columns; where the stream fits
// one run, row blocks of up to kRowsMax rows, as few as still give about
// kBlocksPerSm blocks an SM, each walking every panel; else row blocks of
// one row a sub-warp, one panel a block.
template <int kR, typename V, typename D, typename I>
int launch(const void* rid, const void* cid, const void* val, const int* nnz,
           const void* b, void* c, int batch, int nnz_pad, int m_pad,
           int n_b, int n_block, int op, int vec_edges, void* stream) {
  if (n_block < 1 || nnz_pad < 0) return cudaErrorInvalidValue;
  const int panel = min(n_block, repro::kPanelMax);
  const int sub = repro::sub_warp((panel + kW - 1) / kW);
  const int run = max(1, min(nnz_pad, kRunMax));
  const int once = nnz_pad <= run;
  const size_t cols = kW * sizeof(D);
  const int vec = n_b % kW == 0 && panel % kW == 0 && aligned(b, cols) &&
                  aligned(c, cols) && (!vec_edges || aligned(val, cols));
  int rows = kThreads / sub;
  if (once) {
    const long long want = static_cast<long long>(sm_count()) * kBlocksPerSm;
    const long long per = (static_cast<long long>(batch) * m_pad + want - 1) /
                          want;
    rows = static_cast<int>(min(per, static_cast<long long>(kRowsMax)));
    // equal row blocks, none past kRowsMax rows
    const int blocks = max(max(1, m_pad / max(rows, 1)),
                           (m_pad + kRowsMax - 1) / kRowsMax);
    rows = (m_pad + blocks - 1) / blocks;
  }
  rows = max(1, min(rows, m_pad));
  const int blocks = (m_pad + rows - 1) / rows;
  if (blocks > 65535) return cudaErrorInvalidValue;
  const Shape sh{nnz_pad, m_pad, n_b, panel, sub, run, vec, op, vec_edges,
                 rows};
  const dim3 grid(batch, blocks, once ? 1 : (n_b + panel - 1) / panel);
  const auto go = [&](auto kernel) {
    kernel<<<grid, kThreads, smem_bytes(rows, run),
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const I*>(rid), static_cast<const I*>(cid),
        static_cast<const V*>(val), nnz, static_cast<const D*>(b),
        static_cast<D*>(c), sh);
    return cudaGetLastError();
  };
  return once ? go(coo_kernel<kR, true, V, D, I>)
              : go(coo_kernel<kR, false, V, D, I>);
}

}  // namespace

extern "C" int batched_gspmm_coo_f32(const int* rid, const int* cid,
                                     const float* val, const int* nnz,
                                     const float* b, float* c, int batch,
                                     int nnz_pad, int m_pad, int n_b,
                                     int n_block, int op, int reduce,
                                     int vec, void* stream) {
  const auto go = [&](auto r) {
    return launch<decltype(r)::value, float, float, int>(
        rid, cid, val, nnz, b, c, batch, nnz_pad, m_pad, n_b, n_block, op,
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

extern "C" int batched_spmm_coo_f32(const int* rid, const int* cid,
                                    const float* val, const float* b,
                                    float* c, int batch, int nnz_pad,
                                    int m_pad, int n_b, int n_block,
                                    void* stream) {
  return launch<kSpmm, float, float, int>(rid, cid, val, nullptr, b, c,
                                          batch, nnz_pad, m_pad, n_b,
                                          n_block, 0, 0, stream);
}

// rid and cid (batch, nnz_pad) int16, val bf16, b and c (batch, m_pad, n_b)
// bf16
extern "C" int batched_spmm_coo_bf16(const void* rid, const void* cid,
                                     const void* val, const void* b, void* c,
                                     int batch, int nnz_pad, int m_pad,
                                     int n_b, int n_block, void* stream) {
  return launch<kSpmm, __nv_bfloat16, __nv_bfloat16, short>(
      rid, cid, val, nullptr, b, c, batch, nnz_pad, m_pad, n_b, n_block, 0,
      0, stream);
}

namespace {

// The large-matrix branch. Slots per sub-warp and block: a block takes
// the slots [y chunk, (y + 1) chunk) of its matrix, chunk = 256 / sub * 8,
// and strides by the grid past 65535 blocks.
constexpr int kSlotsPerGroup = 8;

template <typename V, typename D, typename I>
__global__ void __launch_bounds__(kThreads)
coo_large_kernel(const I* __restrict__ rid, const I* __restrict__ cid,
                 const V* __restrict__ val, const D* __restrict__ b,
                 float* __restrict__ acc, int nnz_pad, int m_pad, int n_b,
                 int n_block, int sub) {
  const int s = blockIdx.x;
  const int col0 = blockIdx.z * n_block;
  const int nbw = min(n_block, n_b - col0);
  const size_t off = static_cast<size_t>(s) * nnz_pad;
  const size_t mat = static_cast<size_t>(s) * m_pad;
  const D* bsrc = b + mat * n_b + col0;
  float* asrc = acc + mat * n_b + col0;
  const int lane = threadIdx.x % sub, groups = kThreads / sub;
  const int chunk = groups * kSlotsPerGroup;
  for (int i0 = blockIdx.y * chunk; i0 < nnz_pad; i0 += gridDim.y * chunk) {
    const int i1 = min(i0 + chunk, nnz_pad);
    for (int i = i0 + threadIdx.x / sub; i < i1; i += groups) {
      const float v = repro::ldf(val + off + i);
      const int r = repro::ldi(rid + off + i), j = repro::ldi(cid + off + i);
      if (v == 0.f ||
          static_cast<unsigned>(r) >= static_cast<unsigned>(m_pad) ||
          static_cast<unsigned>(j) >= static_cast<unsigned>(m_pad))
        continue;
      const D* brow = bsrc + static_cast<size_t>(j) * n_b;
      float* arow = asrc + static_cast<size_t>(r) * n_b;
      for (int cc = lane; cc < nbw; cc += sub)
        atomicAdd(arow + cc, v * repro::ldf(brow + cc));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
coo_gspmm_large_kernel(const int* __restrict__ rid,
                       const int* __restrict__ cid,
                       const float* __restrict__ val,
                       const int* __restrict__ nnz,
                       const float* __restrict__ b, float* __restrict__ acc,
                       int* __restrict__ deg, int nnz_pad, int m_pad, int n_b,
                       int n_block, int sub, int op, int reduce, int vec) {
  const int s = blockIdx.x;
  const int col0 = blockIdx.z * n_block;
  const int nbw = min(n_block, n_b - col0);
  const int n = min(__ldg(nnz + s), nnz_pad);
  const size_t off = static_cast<size_t>(s) * nnz_pad;
  const size_t mat = static_cast<size_t>(s) * m_pad;
  const float* bsrc = b + mat * n_b + col0;
  float* asrc = acc + mat * n_b + col0;
  int* dsrc = deg + mat;
  const int lane = threadIdx.x % sub, groups = kThreads / sub;
  const int chunk = groups * kSlotsPerGroup;
  for (int i0 = blockIdx.y * chunk; i0 < n; i0 += gridDim.y * chunk) {
    const int i1 = min(i0 + chunk, n);
    for (int i = i0 + threadIdx.x / sub; i < i1; i += groups) {
      const int r = __ldg(rid + off + i), j = __ldg(cid + off + i);
      if (lane == 0 && blockIdx.z == 0)
        atomicAdd(dsrc + min(max(r, 0), m_pad - 1), 1);
      if (static_cast<unsigned>(r) >= static_cast<unsigned>(m_pad) ||
          static_cast<unsigned>(j) >= static_cast<unsigned>(m_pad))
        continue;
      const float* brow = bsrc + static_cast<size_t>(j) * n_b;
      const float* erow =
          val + (off + i) * (vec ? n_b : 1) + (vec ? col0 : 0);
      const float es =
          (op == repro::kOpCopyLhs || vec) ? 0.f : __ldg(erow);
      float* arow = asrc + static_cast<size_t>(r) * n_b;
      for (int cc = lane; cc < nbw; cc += sub) {
        const float e =
            (vec && op != repro::kOpCopyLhs) ? __ldg(erow + cc) : es;
        const float m = repro::combine(__ldg(brow + cc), e, op);
        if (reduce == repro::kMax)
          repro::atomic_max_f32(arow + cc, m);
        else
          atomicAdd(arow + cc, m);
      }
    }
  }
}

// The write-out of the large branch, one element per thread: out =
// finish(acc, deg) (deg null: the plain sum), rounded to D once; out may
// be acc itself.
template <typename D>
__global__ void __launch_bounds__(kThreads)
coo_finish_kernel(const float* acc, const int* __restrict__ deg, D* out,
                  size_t rows, int n_b, int reduce) {
  const size_t total = rows * n_b;
  for (size_t i = blockIdx.x * static_cast<size_t>(kThreads) + threadIdx.x;
       i < total; i += static_cast<size_t>(gridDim.x) * kThreads) {
    const float x = acc[i];
    out[i] = repro::from_f32<D>(
        deg == nullptr ? x : repro::finish(x, deg[i / n_b], reduce));
  }
}

template <typename D>
cudaError_t finish_launch(const float* acc, const int* deg, D* out,
                          size_t rows, int n_b, int reduce,
                          cudaStream_t stream) {
  const size_t blocks = (rows * n_b + kThreads - 1) / kThreads;
  coo_finish_kernel<D><<<static_cast<unsigned>(blocks < 65535 ? blocks
                                                              : 65535),
                         kThreads, 0, stream>>>(acc, deg, out, rows, n_b,
                                                reduce);
  return cudaGetLastError();
}

// grid of the large scatter: (batch, slot blocks, panels)
dim3 large_grid(int batch, int slots, int n_b, int panel) {
  return dim3(batch,
              repro::large_blocks(slots, kThreads / repro::sub_warp(panel) *
                                             kSlotsPerGroup),
              (n_b + panel - 1) / panel);
}

// acc is the zeroed f32 output for f32, a zeroed f32 buffer beside the
// bf16 output c otherwise.
template <typename V, typename D, typename I>
int large_launch(const void* rid, const void* cid, const void* val,
                 const void* b, float* acc, void* c, int batch, int nnz_pad,
                 int m_pad, int n_b, int n_block, void* stream_ptr) {
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  const int panel = min(n_block, repro::kPanelMax);
  coo_large_kernel<V, D, I>
      <<<large_grid(batch, nnz_pad, n_b, panel), kThreads, 0, stream>>>(
          static_cast<const I*>(rid), static_cast<const I*>(cid),
          static_cast<const V*>(val), static_cast<const D*>(b), acc, nnz_pad,
          m_pad, n_b, panel, repro::sub_warp(panel));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || static_cast<void*>(acc) == c) return e;
  return finish_launch(acc, nullptr, static_cast<D*>(c),
                       static_cast<size_t>(batch) * m_pad, n_b, repro::kSum,
                       stream);
}

}  // namespace

// The large-matrix entries. acc (batch, m_pad, n_b) f32 zeroed by the
// caller: for f32 it is c itself; for bf16 the kernel rounds it into c.
extern "C" int batched_spmm_coo_large_f32(const int* rid, const int* cid,
                                          const float* val, const float* b,
                                          float* c, int batch, int nnz_pad,
                                          int m_pad, int n_b, int n_block,
                                          void* stream) {
  return large_launch<float, float, int>(rid, cid, val, b, c, c, batch,
                                         nnz_pad, m_pad, n_b, n_block,
                                         stream);
}

extern "C" int batched_spmm_coo_large_bf16(const void* rid, const void* cid,
                                           const void* val, const void* b,
                                           float* acc, void* c, int batch,
                                           int nnz_pad, int m_pad, int n_b,
                                           int n_block, int ids32,
                                           void* stream) {
  using B = __nv_bfloat16;
  return ids32 ? large_launch<B, B, int>(rid, cid, val, b, acc, c, batch,
                                         nnz_pad, m_pad, n_b, n_block,
                                         stream)
               : large_launch<B, B, short>(rid, cid, val, b, acc, c, batch,
                                           nnz_pad, m_pad, n_b, n_block,
                                           stream);
}

// c (batch, m_pad, n_b) f32 filled by the caller with 0.0 (-3e38 for max),
// deg (batch, m_pad) int32 zeroed by the caller; c is finished in place.
extern "C" int batched_gspmm_coo_large_f32(
    const int* rid, const int* cid, const float* val, const int* nnz,
    const float* b, float* c, int* deg, int batch, int nnz_pad, int m_pad,
    int n_b, int n_block, int op, int reduce, int vec, void* stream_ptr) {
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  const int panel = min(n_block, repro::kPanelMax);
  coo_gspmm_large_kernel<<<large_grid(batch, nnz_pad, n_b, panel), kThreads,
                           0, stream>>>(
      rid, cid, val, nnz, b, c, deg, nnz_pad, m_pad, n_b, panel,
      repro::sub_warp(panel), op, reduce, vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return finish_launch(c, deg, c, static_cast<size_t>(batch) * m_pad, n_b,
                       reduce, stream);
}
